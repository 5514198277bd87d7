// The fused multi-layer BLSTM stack (inference), hand-written for sm_90a:
// all L layers in one persistent launch, its phases separated by grid
// barriers.
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
// Blocks of 512 threads, all resident at once so that a grid barrier
// cannot deadlock.  For each layer:
//
//   (a) the x-projection gx = x_l · Wx_dir for both directions and every
//       learner: each 256-thread half of each block takes 128 x 128 output
//       tiles in turn through `gemm_tile` (gemm.cuh), the very routine of
//       K1's `lstm_xproj`, behind its own named barrier (bar.sync 1 + half,
//       256); no block-wide barrier is ever passed by half a block;
//   (b) a grid barrier;
//   (c) the recurrence of every (batch tile, direction, learner) item,
//       each value K1's bit for bit whatever the tile: the masked carry is
//       frozen and y zeroed at t >= len, so every element of the layer's
//       output is written; layer l writes ping-pong buffer l % 2, the last
//       layer y;
//   (d) a grid barrier.
//
// Two paths for (c), chosen by shape (`lstm_cell.stack_plan`), never by a
// failed launch:
//
// * Resident, where H splits into 16 slices of whole float4s (the paper's
//   H = 512).  The grid is a whole number of clusters of 16 CTAs
//   (non-portable), at most as many as the card holds at once
//   (cudaOccupancyMaxActiveClusters, 7 on the H100), launched with
//   cudaLaunchKernelEx, the cluster dimension and the cooperative
//   attribute, so the runtime refuses a grid that is not all resident.
//   An item is a cluster: CTA c owns units [c·U, (c+1)·U), U = H / 16,
//   keeps its 128 KB slice of the item's Wh in shared memory, and runs the
//   steps of the training forwards' resident recurrence (`resident_item`,
//   lstm_recur.cuh): products from shared memory, the unit's gate sums
//   gathered by shuffles, `cell_step`, and h sent, rounded to bf16, into
//   every peer's double-buffered h by st.async, which completes the peer's
//   mbarrier.  A cluster walks items c, c + n_clusters, ... (several where
//   the items outnumber the clusters; the mbarrier parities carry over
//   from item to item and layer to layer), a cluster barrier starting
//   each, the slice reloaded where the direction or learner changes.  Each
//   layer's first slice is copied (cp.async) before the layer's
//   x-projection tiles and waited for after them, so the copy hides behind
//   the products.  Shared memory per CTA: the slice, h, the barriers and
//   lengths, then the two x-projection tiles (189.5 KB at H = 512 and
//   4-row tiles): nothing aliases the slice while a layer runs.  The tile
//   rows are the fewest whose clusters fit one wave (1 row at B = 1, 4 at
//   B = 8).
// * Items, where H does not split (H = 16, 48, 100): blocks of one thread
//   per hidden unit, as many as stay resident (the occupancy query times
//   the SM count, capped at the work of the widest phase), launched with
//   cudaLaunchCooperativeKernel; each takes whole items
//   (`blstm_recur_item`, lstm_recur.cuh), streaming the item's Wh from
//   L2 every step.
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
// once, 20.7 us; at evaluate's B = 8 the products of the valid frames
// (chip_smoke.py computes both bounds from its inputs).  Its real limit is
// the serial chain of L x T recurrence steps.  On the item path a step
// streams one direction's 2 MiB Wh from L2 into one SM (~67 us at B = 8);
// resident, a step is one pass over each CTA's 128 KB slice in shared
// memory and an exchange of h (~2 us at 1-row tiles, ~3.8 at 4-row ones
// for the training forwards, PERF.md §6).

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <algorithm>

#include "gemm.cuh"
#include "lstm_recur.cuh"

using bf16 = __nv_bfloat16;

namespace {

constexpr int THREADS = lstm_recur::MAX_H;      // two 256-thread GEMM halves
constexpr int MAX_LAYERS = 16;
constexpr int C = lstm_recur::RES_CLUSTER;
static_assert(THREADS == 2 * lstm_gemm::THREADS, "two tiles per block");
static_assert(THREADS == lstm_recur::MAX_RES_THREADS, "a resident CTA");

struct StackArgs {
  const bf16* x;                    // (L, B, T, D0)
  const bf16* wxf[MAX_LAYERS];      // (L, D_l, 4H) per layer and direction
  const bf16* wxb[MAX_LAYERS];
  const bf16* whf[MAX_LAYERS];      // items: (L, H, H, 4) gate-interleaved;
  const bf16* whb[MAX_LAYERS];      // resident: (L, 16, H/2, H/16, 4, 2)
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

// The resident path's dynamic shared memory: a resident CTA's regions
// (slice of Wh, h, barriers, lengths; `lstm_recur::res_smem`), then the
// x-projection's two tiles.
__host__ __device__ __forceinline__ size_t res_stack_smem(int H, int BB) {
  return lstm_recur::res_smem(H, BB) + 2 * XTile::SMEM;
}

// The x-projection tile and the recurrence items are separate (not
// inlined) functions: each is register-allocated for its own body, as in
// the per-layer kernels, with none of the layer loop's state live across
// its inner loops.  On the item path, inlined, the 8-row recurrence
// spilled and ran 22 % slower than the K1 loop at B = 8; the 1- and 4-row
// items, inlined, ran 3 % and 5 % faster than the K1 loop at B = 1 and 3,
// and 3 % and 8 % faster than when not inlined (H100,
// tools/ab_recurrence.py, PERF.md §6).  Each addresses the kernel's
// dynamic shared memory itself: the GEMM halves' tiles at byte `off`,
// the recurrence's regions at its start.
__device__ __noinline__ void xproj_tile(XMat xa, XMat wf, XMat wb, float* gx,
                                        int M, int N, int D, int bx, int by,
                                        int bz, size_t off) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int half = threadIdx.x / lstm_gemm::THREADS;
  lstm_gemm::gemm_tile<XMat, XMat, lstm_gemm::EPI_F32, lstm_gemm::DenseRows,
                       XBK>(
      xa, xa, wf, wb, gx, gx + (size_t)M * N, (size_t)M * D, (size_t)D * N,
      (size_t)2 * M * N, N, M, N, D, 2, lstm_gemm::DenseRows{}, bx, by, bz,
      threadIdx.x % lstm_gemm::THREADS, 1 + half,
      reinterpret_cast<bf16*>(smem + off + half * XTile::SMEM));
}

// Every layer's x-projection tiles, spread over every block of the grid.
__device__ __forceinline__ void xproj_layer(const StackArgs& a, int layer,
                                            size_t off) {
  const int half = threadIdx.x / lstm_gemm::THREADS;
  const int M = a.B * a.T, N = 4 * a.H;
  const int D = layer == 0 ? a.D0 : 2 * a.H;
  const bf16* in = layer == 0 ? a.x : a.buf[(layer - 1) % 2];
  const int col_tiles = (N + lstm_gemm::BN - 1) / lstm_gemm::BN;
  const int row_tiles = (M + lstm_gemm::BM - 1) / lstm_gemm::BM;
  const int n_tiles = col_tiles * row_tiles * a.L * 2;
  // gx (L, 2, M, N) = in (L, M, D) · wx_dir (L, D, N), lstm_xproj's
  // operands, one tile per half-block at a time
  for (int t = blockIdx.x * 2 + half; t < n_tiles; t += gridDim.x * 2)
    xproj_tile(XMat{in, D}, XMat{a.wxf[layer], N}, XMat{a.wxb[layer], N},
               a.gx, M, N, D, t % col_tiles, t / col_tiles % row_tiles,
               t / (col_tiles * row_tiles), off);
}

__device__ __forceinline__ bf16* layer_out(const StackArgs& a, int layer) {
  return layer == a.n_layers - 1 ? a.y : a.buf[layer % 2];
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

// The item path: blocks take whole (batch tile, direction, learner)
// items, one thread per hidden unit, K1's inference recurrence.
template <int BB>
__global__ void __launch_bounds__(THREADS, 1) lstm_stack_kernel(
    const StackArgs a) {
  const int b_tiles = (a.B + BB - 1) / BB;
  const int n_items = b_tiles * 2 * a.L;
  for (int layer = 0; layer < a.n_layers; ++layer) {
    bf16* out = layer_out(a, layer);
    xproj_layer(a, layer, 0);                                 // (a)
    grid_sync(a.barrier);                                     // (b)
    for (int w = blockIdx.x; w < n_items; w += gridDim.x) {   // (c)
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

// One resident item of a layer (K1's inference recurrence, FWD): the
// shared-memory regions at the start of the dynamic shared memory.
template <int BB>
__device__ __noinline__ uint32_t res_item(const float* gx, const float* bf,
                                          const float* bb,
                                          const int* lengths, bf16* out,
                                          int L, int B, int T, int H,
                                          int tile, int d, int l, int rank,
                                          uint32_t par) {
  extern __shared__ __align__(16) float res[];
  return lstm_recur::resident_item<BB, lstm_recur::FWD, 0>(
      gx, bf, bb, lengths, out, nullptr, nullptr, nullptr, nullptr, L, B, T,
      H, 0, 0, 0, tile, d, l, rank, res, par);
}

// The resident path: clusters of C CTAs walk the items of each layer,
// item w (tile w % b_tiles, direction and learner key = w / b_tiles) on
// cluster w % n_clusters.
template <int BB>
__global__ void __launch_bounds__(THREADS, 1) lstm_stack_resident(
    const StackArgs a) {
  extern __shared__ __align__(16) float res[];
  const int b_tiles = (a.B + BB - 1) / BB;
  const int n_items = b_tiles * 2 * a.L;
  const int rank = (int)(blockIdx.x % C);
  const int cid = (int)(blockIdx.x / C), n_cl = (int)(gridDim.x / C);
  const size_t xoff = lstm_recur::res_smem(a.H, BB);
  // item key d + 2l: direction d's Wh slice of learner l
  auto load_slice = [&](int layer, int key) {
    lstm_recur::res_load_slice(
        res,
        reinterpret_cast<const uint32_t*>(key % 2 ? a.whb[layer]
                                                  : a.whf[layer]),
        key / 2, rank, a.H);
  };
  lstm_recur::ResSmem<BB>(res, a.H).init_barriers();
  uint32_t par = 0;                      // the barriers' next parities
  for (int layer = 0; layer < a.n_layers; ++layer) {
    bf16* out = layer_out(a, layer);
    // this cluster's first slice of the layer, copied behind (a)
    int loaded = -1;                     // the key of the slice held
    if (cid < n_items) {
      loaded = cid / b_tiles;
      load_slice(layer, loaded);
    }
    xproj_layer(a, layer, xoff);                              // (a)
    grid_sync(a.barrier);                                     // (b)
    for (int w = cid; w < n_items; w += n_cl) {               // (c)
      const int key = w / b_tiles;
      if (key != loaded) {               // another direction or learner
        __syncthreads();                 // the last item's reads are done
        load_slice(layer, key);
        loaded = key;
      }
      par = res_item<BB>(a.gx, a.bf[layer], a.bb[layer], a.lengths, out,
                         a.L, a.B, a.T, a.H, w % b_tiles, key % 2, key / 2,
                         rank, par);
    }
    grid_sync(a.barrier);                                     // (d)
  }
}

// The items and the x-projection tiles of one layer.
long stack_items(const StackArgs& a, int BB) {
  return (a.B + BB - 1) / BB * 2L * a.L;
}
long stack_tiles(const StackArgs& a) {
  const long M = (long)a.B * a.T, N = 4L * a.H;
  return (N + lstm_gemm::BN - 1) / lstm_gemm::BN *
         ((M + lstm_gemm::BM - 1) / lstm_gemm::BM) * a.L * 2;
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
  const long work = std::max((stack_tiles(a) + 1) / 2, stack_items(a, BB));
  const int grid = (int)std::min<long>((long)per_sm * n_sm, work);
  void* params[] = {&a};
  err = cudaLaunchCooperativeKernel((const void*)kernel, dim3(grid),
                                    dim3(THREADS), params, smem, st);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

// `active`: the clusters of this kernel the card holds at once
// (lstm_stack_active_clusters).  Every item gets a cluster where the card
// holds them all, else they run in waves of `active`; more clusters, up
// to `active`, only where the x-projection has tiles for them.
template <int BB>
int launch_resident(StackArgs& a, int active, cudaStream_t st) {
  const size_t smem = res_stack_smem(a.H, BB);
  if (!lstm_recur::res_units(a.H, BB) || smem > lstm_recur::SMEM_LIMIT)
    return (int)cudaErrorInvalidValue;
  if (active < 1) return (int)cudaErrorCooperativeLaunchTooLarge;
  const long clusters = std::min<long>(
      active, std::max(stack_items(a, BB), (stack_tiles(a) + 2 * C - 1) /
                                               (2 * C)));
  lstm_recur::ClusterLaunch cl;
  const int rc = cl.init(lstm_stack_resident<BB>, dim3((unsigned)(clusters * C)),
                         THREADS, smem, C, st, /*cooperative=*/true);
  if (rc) return rc;
  const cudaError_t err =
      cudaLaunchKernelEx(&cl.cfg, lstm_stack_resident<BB>, a);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

}  // namespace

// How many clusters of the resident stack kernel (tiles of block_b rows,
// width H) the card holds at once (cudaOccupancyMaxActiveClusters), or
// -cudaError: 0 means a cluster of 16 CTAs cannot be scheduled.
extern "C" int lstm_stack_active_clusters(int block_b, int H) {
  if (!lstm_recur::res_units(H, block_b)) return -(int)cudaErrorInvalidValue;
  auto query = [&](auto kernel) {
    return lstm_recur::active_clusters(kernel, dim3(C), THREADS,
                                       res_stack_smem(H, block_b), C);
  };
  switch (block_b) {
    case 1: return query(lstm_stack_resident<1>);
    case 2: return query(lstm_stack_resident<2>);
    case 4: return query(lstm_stack_resident<4>);
    default: return -(int)cudaErrorInvalidValue;
  }
}

// x (L, B, T, D0) bf16; per layer k of n_layers: wxf[k], wxb[k] (L, D_k,
// 4H) bf16 (D_0 = D0, D_k = 2H after), whf[k], whb[k] bf16: (L, H, H, 4)
// gate-interleaved on the item path, (L, 16, H/2, H/16, 4, 2) resident
// (`lstm_cell._res_fwd_layout`), bf[k], bb[k] (L, 4H) f32 (host arrays of
// device pointers); lengths (L, B) int32; scratch gx (L, 2, B*T, 4H) f32
// and buf0, buf1 (L, B, T, 2H) bf16; barrier one uint32 set to 0; y (L, B,
// T, 2H) bf16.  block_b: the recurrence's batch tile (1, 2 or 4 resident;
// 1, 2, 4 or 8 on the item path); resident: 1 for the resident path, with
// `active` its clusters the card holds at once.
extern "C" int lstm_stack(const void* x, const void* const* wxf,
                          const void* const* wxb, const void* const* whf,
                          const void* const* whb, const void* const* bf,
                          const void* const* bb, const void* lengths,
                          void* gx, void* buf0, void* buf1, void* barrier,
                          void* y, int n_layers, int L, int B, int T, int D0,
                          int H, int block_b, int resident, int active,
                          void* stream) {
  if (n_layers < 1 || n_layers > MAX_LAYERS || L < 1 || B < 1 || T < 1 ||
      D0 < 1 || H < 1 || H > lstm_recur::MAX_H)
    return (int)cudaErrorInvalidValue;
  StackArgs a{};
  a.x = static_cast<const bf16*>(x);
  for (int k = 0; k < n_layers; ++k) {
    a.wxf[k] = static_cast<const bf16*>(wxf[k]);
    a.wxb[k] = static_cast<const bf16*>(wxb[k]);
    a.whf[k] = static_cast<const bf16*>(whf[k]);
    a.whb[k] = static_cast<const bf16*>(whb[k]);
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
  if (resident) {
    switch (block_b) {
      case 1: return launch_resident<1>(a, active, st);
      case 2: return launch_resident<2>(a, active, st);
      case 4: return launch_resident<4>(a, active, st);
      default: return (int)cudaErrorInvalidValue;
    }
  }
  switch (block_b) {
    case 1: return launch<1>(a, st);
    case 2: return launch<2>(a, st);
    case 4: return launch<4>(a, st);
    case 8: return launch<8>(a, st);
    default: return (int)cudaErrorInvalidValue;
  }
}
