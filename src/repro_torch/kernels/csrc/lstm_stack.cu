// The fused multi-layer BLSTM stack (inference), hand-written for sm_90a:
// all L layers in one persistent cooperative launch.
//
// Replaces the TPU kernel K4: src/repro/kernels/lstm_cell.py,
// `_make_stack_kernel` / `_stack_primal` (pallas_call at lstm_cell.py:1238).
// On the TPU a (B/bB, L, T) grid walks layers and steps in order with the
// inter-layer activations in two VMEM ping-pong tiles; layer 0 reads x
// zero-extended to Dm = max(D0, 2H), the others the previous layer's
// (bB, T, 2H) output, and only the last layer writes y.  The reference
// promises that it is bit-identical to the per-layer K1 loop
// (lstm_cell.py:1318-1320), and at the paper's width it never runs it: its
// VMEM estimate exceeds the 12 MiB budget, so `_stack_primal` runs that
// loop instead.  That fallback describes the TPU's scratch memory; here the
// stack runs at every shape, and bit identity follows the loop, not the
// TPU kernel: the x-projection contracts over K = D0 at layer 0 (no zero
// extension) and 2H after, as K1's `lstm_xproj` does.
//
// One launch, blocks of 512 threads (one per hidden unit, MAX_H), a grid
// of as many blocks as stay resident on the card (the occupancy query
// times the SM count, capped at the work of the widest phase), launched
// with cudaLaunchCooperativeKernel so that every block is resident and a
// grid barrier cannot deadlock.  For each layer:
//
//   (a) the x-projection gx = x_l · Wx_dir for both directions and every
//       learner: each 256-thread half of each block takes 128 x 128 output
//       tiles in turn through `gemm_tile` (gemm.cuh), the very routine of
//       K1's `lstm_xproj`, behind its own named barrier (bar.sync 1 + half,
//       256); no block-wide barrier is ever passed by half a block;
//   (b) a grid barrier;
//   (c) the recurrence: blocks take (batch tile, direction, learner) work
//       items through `blstm_recur_item` (lstm_recur.cuh), one thread per
//       hidden unit summing over every input k in the order of K1's
//       cluster recurrence, with K1's cell update (`cell_step`), so each
//       value is K1's bit for bit whatever the tile; the
//       masked carry is frozen and y zeroed at t >= len, so every element
//       of the layer's output is written; layer l writes ping-pong buffer
//       l % 2, the last layer y;
//   (d) a grid barrier.
//
// The grid barrier is written here, not taken from cooperative_groups'
// grid.sync(), so that the library needs no relocatable device code and no
// barrier state of the runtime's: one 32-bit word from the wrapper (zeroed
// per call), the arrival count in its low bits and a phase in its top bit,
// flipped by the arrivals of one barrier summing to 2^31 (block 0 adds
// 2^31 - (n - 1), the others 1).  Fences before the arrival and after the
// wait make every block's writes of one phase visible to every block in the
// next; the data written inside the launch (gx, the ping-pong buffers) is
// read with plain loads, never through the read-only cache.
//
// What bounds it on the H100.  At the paper's width and the serving shape
// (B = 1), bytes: the 69.3 MB of weights of the six layers (Wx 260 or
// 1024 x 2048 and Wh 512 x 2048 bf16, the f32 bias, per direction) read
// once, 20.7 us; at evaluate's B = 8 the products of the valid frames (chip_smoke.py
// computes both bounds from its inputs).  Its real limit is the serial
// chain of L x T recurrence steps, each streaming one direction's 2 MiB Wh
// from L2 into one SM (2 x ceil(B / 8) SMs busy per learner); K1's cluster
// split (lstm_recur.cuh), which spreads a step over several SMs, is not
// applied to these items yet.  It removes the L - 1 other launches of the
// per-layer loop and the host work between them, and keeps the inter-layer
// activations (B x T x 2H bf16, 512 KB per utterance) in L2-sized buffers.
// The barrier is what the next design needs: split each direction's 4H gate
// columns over many blocks, keep every slice of Wh resident in shared
// memory, and exchange h_t through a grid barrier every step (ROADMAP.md).

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <algorithm>

#include "gemm.cuh"
#include "lstm_recur.cuh"

using bf16 = __nv_bfloat16;

namespace {

constexpr int THREADS = lstm_recur::MAX_H;      // two 256-thread GEMM halves
constexpr int MAX_LAYERS = 16;
static_assert(THREADS == 2 * lstm_gemm::THREADS, "two tiles per block");

struct StackArgs {
  const bf16* x;                    // (L, B, T, D0)
  const bf16* wxf[MAX_LAYERS];      // (L, D_l, 4H) per layer and direction
  const bf16* wxb[MAX_LAYERS];
  const bf16* whf[MAX_LAYERS];      // (L, H, H, 4) gate-interleaved
  const bf16* whb[MAX_LAYERS];
  const float* bf[MAX_LAYERS];      // (L, 4H)
  const float* bb[MAX_LAYERS];
  const int* lengths;               // (L, B), each <= T
  float* gx;                        // (L, 2, B * T, 4H) scratch
  bf16* buf[2];                     // (L, B, T, 2H) ping-pong scratch
  bf16* y;                          // (L, B, T, 2H)
  unsigned int* barrier;            // one word, 0 at launch
  int n_layers, L, B, T, D0, H;
};

__device__ __forceinline__ void grid_sync(unsigned int* bar) {
  __syncthreads();
  if (threadIdx.x == 0) {
    const unsigned int n = gridDim.x;
    const unsigned int add = blockIdx.x == 0 ? 0x80000000u - (n - 1) : 1u;
    __threadfence();
    const unsigned int old = atomicAdd(bar, add);
    while (((old ^ *(volatile unsigned int*)bar) & 0x80000000u) == 0) {
    }
    __threadfence();
  }
  __syncthreads();
}

using XMat = lstm_gemm::Mat<bf16, false>;
// K4's tiles are 16 deep: at 32 the 128-register halves spilled more; the
// bits are those of K1's `lstm_xproj` at any depth (gemm.cuh).
constexpr int XBK = 16;
using XTile = lstm_gemm::Tile<XMat, XMat, XBK>;

// The x-projection tile and, for 8-row batch tiles, the recurrence are
// separate (not inlined) functions: each is register-allocated for its
// own body, as in the per-layer kernels, with none of the layer loop's
// state live across its inner loops.  Inlined, the 8-row recurrence
// spilled and ran 22 % slower than the K1 loop at B = 8; the 1- and 4-row
// recurrences, inlined, run 3 % and 5 % faster than the K1 loop at B = 1
// and 3, and 3 % and 8 % faster than when not inlined (H100,
// tools/ab_recurrence.py, PERF.md §6).  Each addresses the kernel's
// dynamic shared memory itself: the GEMM halves' tiles, then the
// recurrence's h at its start.
__device__ __noinline__ void xproj_tile(XMat xa, XMat wf, XMat wb, float* gx,
                                        int M, int N, int D, int bx, int by,
                                        int bz) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int half = threadIdx.x / lstm_gemm::THREADS;
  lstm_gemm::gemm_tile<XMat, XMat, lstm_gemm::EPI_F32, lstm_gemm::DenseRows,
                       XBK>(
      xa, xa, wf, wb, gx, gx + (size_t)M * N, (size_t)M * D, (size_t)D * N,
      (size_t)2 * M * N, N, M, N, D, 2, lstm_gemm::DenseRows{}, bx, by, bz,
      threadIdx.x % lstm_gemm::THREADS, 1 + half,
      reinterpret_cast<bf16*>(smem + half * XTile::SMEM));
}

template <int BB>
__device__ __noinline__ void recur_item(const float* gx, const bf16* whf,
                                        const bf16* whb, const float* bf,
                                        const float* bb, const int* lengths,
                                        bf16* out, int L, int B, int T, int H,
                                        int tile, int d, int l) {
  lstm_recur::blstm_recur_item<BB>(gx, whf, whb, bf, bb, lengths, out, L,
                                   B, T, H, lstm_recur::LoopItem{tile, d, l});
}

template <int BB>
__global__ void __launch_bounds__(THREADS, 1) lstm_stack_kernel(
    const StackArgs a) {
  const int half = threadIdx.x / lstm_gemm::THREADS;
  const int M = a.B * a.T, N = 4 * a.H;
  const int col_tiles = (N + lstm_gemm::BN - 1) / lstm_gemm::BN;
  const int row_tiles = (M + lstm_gemm::BM - 1) / lstm_gemm::BM;
  const int n_tiles = col_tiles * row_tiles * a.L * 2;
  const int b_tiles = (a.B + BB - 1) / BB;
  const int n_items = b_tiles * 2 * a.L;
  for (int layer = 0; layer < a.n_layers; ++layer) {
    const bf16* in = layer == 0 ? a.x : a.buf[(layer - 1) % 2];
    bf16* out = layer == a.n_layers - 1 ? a.y : a.buf[layer % 2];
    const int D = layer == 0 ? a.D0 : 2 * a.H;
    // (a) gx (L, 2, M, N) = in (L, M, D) · wx_dir (L, D, N), lstm_xproj's
    // operands, one tile per half-block at a time
    for (int t = blockIdx.x * 2 + half; t < n_tiles; t += gridDim.x * 2)
      xproj_tile(XMat{in, D}, XMat{a.wxf[layer], N}, XMat{a.wxb[layer], N},
                 a.gx, M, N, D, t % col_tiles, t / col_tiles % row_tiles,
                 t / (col_tiles * row_tiles));
    grid_sync(a.barrier);                                     // (b)
    // (c) the recurrence, K1's inference variant
    for (int w = blockIdx.x; w < n_items; w += gridDim.x) {
      const int tile = w % b_tiles, d = w / b_tiles % 2;
      const int l = w / (b_tiles * 2);
      if constexpr (BB <= 4)                                // inlined
        lstm_recur::blstm_recur_item<BB>(
            a.gx, a.whf[layer], a.whb[layer], a.bf[layer], a.bb[layer],
            a.lengths, out, a.L, a.B, a.T, a.H,
            lstm_recur::LoopItem{tile, d, l});
      else
        recur_item<BB>(a.gx, a.whf[layer], a.whb[layer], a.bf[layer],
                       a.bb[layer], a.lengths, out, a.L, a.B, a.T, a.H, tile,
                       d, l);
    }
    grid_sync(a.barrier);                                     // (d)
  }
}

template <int BB>
int launch(StackArgs& a, cudaStream_t st) {
  auto kernel = lstm_stack_kernel<BB>;
  const size_t smem = std::max(2 * XTile::SMEM,
                               (size_t)BB * a.H * sizeof(float));
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  int dev = 0, n_sm = 0, per_sm = 0;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess) return (int)err;
  if ((err = cudaDeviceGetAttribute(&n_sm, cudaDevAttrMultiProcessorCount,
                                    dev)) != cudaSuccess)
    return (int)err;
  if ((err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
           &per_sm, kernel, THREADS, smem)) != cudaSuccess)
    return (int)err;
  if (per_sm < 1) return (int)cudaErrorCooperativeLaunchTooLarge;
  // no more blocks than the widest phase has work for: fewer arrive at
  // each barrier
  const long M = (long)a.B * a.T, N = 4L * a.H;
  const long tiles = (N + lstm_gemm::BN - 1) / lstm_gemm::BN *
                     ((M + lstm_gemm::BM - 1) / lstm_gemm::BM) * a.L * 2;
  const long items = (a.B + BB - 1) / BB * 2L * a.L;
  const long work = std::max((tiles + 1) / 2, items);
  const int grid = (int)std::min<long>((long)per_sm * n_sm, work);
  void* params[] = {&a};
  err = cudaLaunchCooperativeKernel((const void*)kernel, dim3(grid),
                                    dim3(THREADS), params, smem, st);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

}  // namespace

// x (L, B, T, D0) bf16; per layer k of n_layers: wxf[k], wxb[k] (L, D_k,
// 4H) bf16 (D_0 = D0, D_k = 2H after), whf4[k], whb4[k] (L, H, H, 4) bf16
// gate-interleaved, bf[k], bb[k] (L, 4H) f32 (host arrays of device
// pointers); lengths (L, B) int32; scratch gx (L, 2, B*T, 4H) f32 and buf0,
// buf1 (L, B, T, 2H) bf16; barrier one uint32 set to 0; y (L, B, T, 2H)
// bf16.  block_b: the recurrence's batch tile (1, 2, 4 or 8).
extern "C" int lstm_stack(const void* x, const void* const* wxf,
                          const void* const* wxb, const void* const* whf4,
                          const void* const* whb4, const void* const* bf,
                          const void* const* bb, const void* lengths,
                          void* gx, void* buf0, void* buf1, void* barrier,
                          void* y, int n_layers, int L, int B, int T, int D0,
                          int H, int block_b, void* stream) {
  if (n_layers < 1 || n_layers > MAX_LAYERS || L < 1 || B < 1 || T < 1 ||
      D0 < 1 || H < 1 || H > lstm_recur::MAX_H)
    return (int)cudaErrorInvalidValue;
  StackArgs a{};
  a.x = static_cast<const bf16*>(x);
  for (int k = 0; k < n_layers; ++k) {
    a.wxf[k] = static_cast<const bf16*>(wxf[k]);
    a.wxb[k] = static_cast<const bf16*>(wxb[k]);
    a.whf[k] = static_cast<const bf16*>(whf4[k]);
    a.whb[k] = static_cast<const bf16*>(whb4[k]);
    a.bf[k] = static_cast<const float*>(bf[k]);
    a.bb[k] = static_cast<const float*>(bb[k]);
  }
  a.lengths = static_cast<const int*>(lengths);
  a.gx = static_cast<float*>(gx);
  a.buf[0] = static_cast<bf16*>(buf0);
  a.buf[1] = static_cast<bf16*>(buf1);
  a.y = static_cast<bf16*>(y);
  a.barrier = static_cast<unsigned int*>(barrier);
  a.n_layers = n_layers;
  a.L = L;
  a.B = B;
  a.T = T;
  a.D0 = D0;
  a.H = H;
  const cudaStream_t st = (cudaStream_t)stream;
  switch (block_b) {
    case 1: return launch<1>(a, st);
    case 2: return launch<2>(a, st);
    case 4: return launch<4>(a, st);
    case 8: return launch<8>(a, st);
    default: return (int)cudaErrorInvalidValue;
  }
}
