// The serial halves of the BLSTM kernels, hand-written for sm_90a: the
// forward recurrence (K1 and its variants, K3's replay of one chunk, and
// the per-layer items of the fused stack K4) and the reverse recurrence
// (K2, and K3's reverse steps over one chunk).
//
// One header so that K3 (lstm_bwd_chunked.cu) replays a chunk with the very
// instructions K1 ran (lstm_fwd.cu) and undoes it with the very
// instructions of K2 (lstm_bwd.cu): the recomputed gates and cell states
// are bit-identical to the stash of K1's training variant, and K3's
// dgates to K2's.  K4 (lstm_stack.cu) walks its layers' items with the
// resident routine of the training forwards (`resident_item`), or, where H
// does not split into 16 slices, with its own 512-thread items
// (`blstm_recur_item`); both keep K1's per-unit sums and cell update
// (`cell_step`), so K4 is bit-identical to the K1 loop.  The file notes of
// lstm_fwd.cu, lstm_bwd.cu and lstm_stack.cu say what bounds each kernel
// on the H100.
//
// Time indexing shared by both kernels.  A launch walks `Tg` rows per
// batch row of its per-step arrays (gx, the stash, dgates): all T frames
// (Tg = T, local row k = frame t) or one K-frame chunk (Tg = K, local row
// k = frame t0 + k).  The forward direction's recurrence walks k upwards,
// the reverse direction downwards.  With seq_chunk = K the time axis is
// padded to T_pad = n·K frames (n = ceil(T / K)); recurrence chunk r of
// the forward direction covers frames [rK, (r+1)K), of the reverse
// direction [T_pad-(r+1)K, T_pad-rK) (`cmap`, lstm_cell.py:818-823).
// Frames t >= T are never stored: they are masked steps (lengths <= T),
// which change no carry, so a chunked launch reads them as zero.
//
// The cluster split (K1 and K2 and K3's recurrences).  Each (batch tile
// of BB rows, direction, learner) is a thread-block cluster of C CTAs; CTA
// c owns hidden units [c·U, (c+1)·U), U = H / C, with their four gate
// columns, one thread per unit, and reads only its units' columns (the
// forward) or rows (the reverse) of Wh: 1/C of the 2 MiB a step at H =
// 512.  Each step's state is exchanged through distributed shared memory:
// a CTA writes its slice into its own shared memory, copies it into every
// peer's, and one cluster barrier (release/acquire) makes it visible.  The
// forward double-buffers h (step s reads buffer s % 2 and fills the other,
// so a step's copies never race the previous step's reads); the reverse
// gathers the whole dgates block of a step into one buffer behind a split
// arrive/wait, the arrive after its reads, the wait before the next
// step's copies.  Each thread's sum over k (forward) and over n (reverse)
// runs in the same order as in `blstm_recur_item` and the kernels before
// the split, whatever C and BB: the bits do not depend on them.
//
// Wh resident (`resident_item`: the long forward launches of K1-stash,
// K1-chunk and K3's replay, `lstm_cell.recur_plan`, and every layer of K4
// where H splits, `lstm_cell.stack_plan`).  The streaming kernels read
// their share of Wh from device memory every step: 64 MiB a step over 16
// learners and both directions at H = 512, more than the L2 holds.  The
// resident forward runs clusters of 16 CTAs (non-portable), each CTA
// copying its 128 KB slice of Wh into shared memory once an item (K4: once
// a layer where a cluster's items share a direction and learner); the
// items run in as many waves as the card holds clusters at once (7 on the
// H100).  The exchange of each step's h goes through st.async stores that
// complete the peers' mbarriers, double-buffered, with no cluster barrier
// inside the step loop.  Every (unit, gate, row) sum keeps its order, so
// the bits are the streaming kernel's.  A resident reverse of the same
// design was no faster than the streaming one (PERF.md §6), so the
// reverse streams.
//
// One direction or two.  A launch of K1, K2 or K3 runs `nd` directions:
// both (nd = 2, the bidirectional layer) or one (nd = 1, the
// unidirectional `lstm_sequence`), whose recurrence walks forward (d0 =
// 0) or reversed (d0 = 1).  Its buffers hold nd slots: gx (L, nd, B, Tg,
// 4H), y and dy (L, B, T, nd·H), the stash, carries and dgates (nd, L,
// ...).  Grid axis y is the slot s, the direction d = d0 + s; the
// weights, the bias and the time order follow d, the buffers s.  At nd =
// 2 slot and direction coincide; at nd = 1 the one direction runs the
// very instructions it runs beside the other, so a unidirectional launch
// is bit-identical to its direction of the bidirectional one.
#pragma once

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "sm90.cuh"

namespace lstm_recur {

namespace cg = cooperative_groups;
using bf16 = __nv_bfloat16;

constexpr int MAX_H = 512;     // K4's block: one thread per hidden unit
constexpr int MAX_CTA = 256;   // threads of a cluster CTA (U rounded to 32)
constexpr int MAX_CLUSTER = 8;
constexpr int RES_CLUSTER = 16;        // CTAs of a resident cluster
constexpr int MAX_RES_THREADS = 512;   // threads of a resident CTA
constexpr int SMEM_LIMIT = 232448;     // dynamic shared memory of one CTA

// K4's blocks (512 threads: its item path's one thread per hidden unit,
// and two x-projection tiles at once) and the resident CTAs are declared
// __launch_bounds__(512, 1): one block per SM is all a step needs.
// Without the minimum, ptxas held the registers to what two 512-thread
// blocks allow and spilled; with it the per-layer kernels of that design
// ran 1.6-5.5x faster on the H100 (PERF.md, kernel table).

__device__ __forceinline__ float sigmoidf_(float v) {
  return 1.f / (1.f + expf(-v));
}

__device__ __forceinline__ float round_bf16(float v) {
  return __bfloat162float(__float2bfloat16(v));
}

// Stash element store and load: SD 1 = f32, 2 = bf16.
template <int SD>
__device__ __forceinline__ void store_stash(void* p, size_t i, float v) {
  if constexpr (SD == 1) static_cast<float*>(p)[i] = v;
  else static_cast<bf16*>(p)[i] = __float2bfloat16(v);
}
template <int SD>
__device__ __forceinline__ float load_stash(const void* p, size_t i) {
  if constexpr (SD == 1) return static_cast<const float*>(p)[i];
  else return __bfloat162float(static_cast<const bf16*>(p)[i]);
}

// First real frame of recurrence chunk `chunk` in direction d.
__device__ __forceinline__ int chunk_t0(int d, int chunk, int K, int n) {
  return d ? (n - 1 - chunk) * K : chunk * K;
}

__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.aligned;\n" ::: "memory");
}

// Copy floats [off, off + count) of this CTA's shared buffer `buf` into
// the same place of every peer's (count a multiple of 4, off of 4).
__device__ __forceinline__ void push_to_peers(float* buf, size_t off,
                                              int count, int rank, int C) {
  cg::cluster_group cluster = cg::this_cluster();
  const float4* src = reinterpret_cast<const float4*>(buf + off);
  for (int q = 1; q < C; ++q) {
    float4* dst = reinterpret_cast<float4*>(
        cluster.map_shared_rank(buf + off, (rank + q) % C));
    for (int i = threadIdx.x; i < count / 4; i += blockDim.x) dst[i] = src[i];
  }
}

// The resident forward's exchange: a thread stores its values straight
// into each peer's shared memory with st.async, which also counts the
// bytes on the peer's mbarrier, and a CTA waits only for the phase of its
// own barrier that the step's bytes complete (no cluster barrier).
// `cluster_base` is CTA `rank`'s shared-memory window (mapa of this CTA's
// address `local`).
__device__ __forceinline__ uint32_t cluster_base(uint32_t local, int rank) {
  uint32_t r;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n"
               : "=r"(r)
               : "r"(local), "r"(rank));
  return r;
}
__device__ __forceinline__ void st_async(uint32_t addr, float v,
                                         uint32_t bar) {
  asm volatile(
      "st.async.shared::cluster.mbarrier::complete_tx::bytes.b32 [%0], %1, "
      "[%2];\n" ::"r"(addr),
      "r"(__float_as_uint(v)), "r"(bar)
      : "memory");
}
// spin until the phase of parity `parity` of this CTA's barrier has
// completed, acquiring at cluster scope what the peers' st.async wrote
__device__ __forceinline__ void mbar_wait_cluster(const uint64_t* bar,
                                                  uint32_t parity) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "WAIT:\n"
      "mbarrier.try_wait.parity.acquire.cluster.shared::cta.b64 p, [%0], "
      "%1;\n"
      "@!p bra WAIT;\n}\n" ::"r"(sm90::smem_u32(bar)),
      "r"(parity)
      : "memory");
}

// Copy `bytes` (a multiple of 16) from device memory into shared memory
// with cp.async, every thread of the block issuing its share; the caller
// waits (cp_async_wait) before the first read.
__device__ __forceinline__ void cp_async_block(void* dst, const void* src,
                                               size_t bytes) {
  const uint32_t base = (uint32_t)__cvta_generic_to_shared(dst);
  const char* g = static_cast<const char*>(src);
  for (size_t i = threadIdx.x; i < bytes / 16; i += blockDim.x)
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                     base + (uint32_t)(i * 16)),
                 "l"(g + i * 16)
                 : "memory");
}
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// The launch configuration of a cluster kernel; clusters above the
// portable 8 CTAs are allowed.  `cooperative`: the runtime also refuses a
// grid whose blocks are not all resident at once (K4's grid barrier).
struct ClusterLaunch {
  cudaLaunchConfig_t cfg = {};
  cudaLaunchAttribute attr[2];
  template <class Kernel>
  int init(Kernel kernel, dim3 grid, int threads, size_t smem, int C,
           cudaStream_t st, bool cooperative = false) {
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err == cudaSuccess && C > MAX_CLUSTER)
      err = cudaFuncSetAttribute(
          kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    if (err != cudaSuccess) return (int)err;
    cfg.gridDim = grid;
    cfg.blockDim = dim3(threads);
    cfg.dynamicSmemBytes = smem;
    cfg.stream = st;
    attr[0].id = cudaLaunchAttributeClusterDimension;
    attr[0].val.clusterDim.x = C;
    attr[0].val.clusterDim.y = 1;
    attr[0].val.clusterDim.z = 1;
    attr[1].id = cudaLaunchAttributeCooperative;
    attr[1].val.cooperative = 1;
    cfg.attrs = attr;
    cfg.numAttrs = cooperative ? 2 : 1;
    return 0;
  }
};

template <class Kernel, class... Args>
int launch_cluster(Kernel kernel, dim3 grid, int threads, size_t smem,
                   int C, cudaStream_t st, Args... args) {
  ClusterLaunch cl;
  int rc = cl.init(kernel, grid, threads, smem, C, st);
  if (rc) return rc;
  cudaError_t err = cudaLaunchKernelEx(&cl.cfg, kernel, args...);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

// How many clusters of `kernel` the card holds at once
// (cudaOccupancyMaxActiveClusters), or -cudaError.
template <class Kernel>
int active_clusters(Kernel kernel, dim3 grid, int threads, size_t smem,
                    int C) {
  ClusterLaunch cl;
  int rc = cl.init(kernel, grid, threads, smem, C, 0);
  if (rc) return -rc;
  int n = 0;
  cudaError_t err = cudaOccupancyMaxActiveClusters(&n, kernel, &cl.cfg);
  return err != cudaSuccess ? -(int)err : n;
}

// Units per CTA of a cluster of C, or 0 where C does not split H: a slice
// must be whole float4s of every exchanged buffer, and fit one CTA.
__host__ __forceinline__ int cluster_units(int H, int C) {
  if (C < 1 || C > MAX_CLUSTER || (C > 1 && H % (4 * C))) return 0;
  return H / C <= MAX_CTA ? H / C : 0;
}

// How a launch runs its forward recurrence (`lstm_cell.recur_plan`):
// tiles of block_b rows; resident = 0, clusters of `cluster` CTAs
// streaming Wh from device memory; resident = 1, clusters of RES_CLUSTER
// CTAs holding their slice of Wh in shared memory for the whole launch
// (Wh then in the resident layout), in as many waves of clusters as the
// card runs at once.  The reverse recurrence always streams, on clusters
// of `cluster`.
struct Plan {
  int block_b, cluster, resident;
};

// Shared memory of a resident forward CTA: its slice of Wh, h
// double-buffered in f32, two barriers and the lengths.
__host__ __device__ __forceinline__ size_t res_smem(int H, int BB) {
  const size_t U = H / RES_CLUSTER;
  return (size_t)H * U * 8 + 2 * (size_t)H * BB * 4 + 64;
}
// Units per CTA of a resident cluster, or 0 where H does not split: a
// slice must be whole float4s of the exchanged h (U a multiple of 4), and
// the CTA's slice of Wh and its buffers must fit shared memory.
__host__ __forceinline__ int res_units(int H, int BB) {
  if (H % (4 * RES_CLUSTER)) return 0;
  const int U = H / RES_CLUSTER;
  if (4 * U > MAX_RES_THREADS || res_smem(H, BB) > SMEM_LIMIT) return 0;
  return U;
}

// Whether a plan can run at width H (block_b is checked by the launch):
// the streaming cluster always (the reverse takes it), the resident one
// where the forward runs resident.
__host__ __forceinline__ bool plan_ok(int H, const Plan& p) {
  return cluster_units(H, p.cluster) > 0 &&
         (!p.resident || res_units(H, p.block_b) > 0);
}

// The weights of a step stream from device memory straight into
// registers: each thread keeps WEIGHT_LOADS 8-byte loads of its unit's
// weights in flight, each slot refilled as it is used (a rolling
// prefetch), so a CTA of 256 threads holds 64 KB of loads in flight.  A
// ring of cp.async stages in shared memory, refilled behind a barrier per
// stage, ran slower at the training shape on the H100.
constexpr int WEIGHT_LOADS = 32;

// ---------------------------------------------------------------- forward

// What a forward launch writes besides y.
enum FwdMode {
  FWD = 0,        // y only (inference)
  FWD_STASH = 1,  // y, and the gates i|f|g|o and c of every step (dtype SD)
  FWD_ENTRY = 2,  // y, and the (h, c) carry entering each K-step chunk
  REPLAY = 3,     // no y: one chunk from its entry carry (dtype SD), its
                  // gates and c in f32 into chunk-sized buffers
};

struct FwdArgs {
  const float* gx;        // (L, nd, B, Tg, 4H) f32 x-projections
  const bf16* whf;        // (L, H, H, 4) bf16 gate-interleaved, per direction
  const bf16* whb;
  const float* bias_f;    // (L, 4H) f32
  const float* bias_b;
  const int* lengths;     // (L, B), each <= T
  bf16* y;                // (L, B, T, nd*H): slot s in columns s*H..
  void* acts;             // FWD_STASH, REPLAY: (nd, L, B, Tg, 4H)
  void* cseq;             // FWD_STASH, REPLAY: (nd, L, B, Tg, H)
  void* hb;               // FWD_ENTRY writes, REPLAY reads: (nd, L, B, n, H)
  void* cb;
  int L, B, T, H;
  int K, n;               // chunk length and count (FWD_ENTRY, REPLAY)
  int chunk;              // REPLAY: the recurrence chunk replayed
  int nd, d0;             // directions in the launch, direction of slot 0
};

// One cell update (`_cell_math`): gate pre-activations (x-projection +
// h·Wh) + bias, the activations (forget bias +1), c' = f·c + i·g and
// h' = o·tanh(c'), each product rounded once by an explicit intrinsic, so
// that every kernel that calls this computes the same bits.
struct Cell {
  float i, f, g, o, c, h;
};
__device__ __forceinline__ Cell cell_step(const float (&xg)[4],
                                          const float (&acc)[4],
                                          const float (&bias)[4], float c) {
  Cell s;
  s.i = sigmoidf_((xg[0] + acc[0]) + bias[0]);
  s.f = sigmoidf_(((xg[1] + acc[1]) + bias[1]) + 1.f);
  s.g = tanhf((xg[2] + acc[2]) + bias[2]);
  s.o = sigmoidf_((xg[3] + acc[3]) + bias[3]);
  s.c = __fmaf_rn(s.f, c, __fmul_rn(s.i, s.g));
  s.h = __fmul_rn(s.o, tanhf(s.c));
  return s;
}

// acc[r][g] += h[r][k] * Wh[k, g*H + j] for the 4 gates packed in `u`:
// `hk` points at h[0][k] and row r's value is hk[r * rs] (K4: rs = H;
// the cluster kernel: rs = 1, four rows per float4 load).
template <int BB, int RS>
__device__ __forceinline__ void fma_gates(float (&acc)[BB][4], uint2 u,
                                          const float* hk, int rs) {
  const __nv_bfloat162 w01 = *reinterpret_cast<const __nv_bfloat162*>(&u.x);
  const __nv_bfloat162 w23 = *reinterpret_cast<const __nv_bfloat162*>(&u.y);
  const float w0 = __low2float(w01), w1 = __high2float(w01);
  const float w2 = __low2float(w23), w3 = __high2float(w23);
  float hv[BB];
  if constexpr (RS == 1 && BB % 4 == 0) {
#pragma unroll
    for (int r = 0; r < BB; r += 4) {
      const float4 v = *reinterpret_cast<const float4*>(hk + r);
      hv[r] = v.x;
      hv[r + 1] = v.y;
      hv[r + 2] = v.z;
      hv[r + 3] = v.w;
    }
  } else {
#pragma unroll
    for (int r = 0; r < BB; ++r) hv[r] = hk[r * (RS ? RS : rs)];
  }
#pragma unroll
  for (int r = 0; r < BB; ++r) {
    acc[r][0] += hv[r] * w0;
    acc[r][1] += hv[r] * w1;
    acc[r][2] += hv[r] * w2;
    acc[r][3] += hv[r] * w3;
  }
}

// The work item of a persistent block of K4.
struct LoopItem {
  int t, d, l;
  __device__ __forceinline__ int tile() const { return t; }
  __device__ __forceinline__ int dir() const { return d; }
  __device__ __forceinline__ int learner() const { return l; }
};

// K4's forward recurrence of one work item (inference): batch tile
// `item.tile()` (rows tile*BB ..), direction d, learner l, walked by every
// thread of the 512-thread block (thread j owns hidden unit j < H; the
// others join the barriers), with the first BB * H floats of the block's
// dynamic shared memory as `hs`, the bf16-rounded h of the step.  KU weight
// loads are in flight per thread.  The pointers carry no `__restrict__`:
// K4 writes gx and the layer input inside the same launch, so their loads
// must not become read-only-cache loads; the weights are read with __ldg.
template <int BB, class Item, int KU = (BB <= 2 ? 16 : 8)>
__device__ __forceinline__ void blstm_recur_item(
    const float* gx, const bf16* whf, const bf16* whb, const float* bias_f,
    const float* bias_b, const int* lengths, bf16* y, int L, int B, int T,
    int H, Item item) {
  extern __shared__ float hs[];                  // [BB][H] bf16-rounded h
  const int d = item.dir();
  const int l = item.learner();
  const int b0 = item.tile() * BB;
  const size_t G = 4 * (size_t)H;
  const bf16* __restrict__ wh = (d ? whb : whf) + (size_t)l * H * G;
  const float* __restrict__ bias = (d ? bias_b : bias_f) + (size_t)l * G;
  lengths += (size_t)l * B;
  gx += (size_t)(2 * l + d) * B * T * G;
  y += (size_t)l * B * T * 2 * H;
  const int j = threadIdx.x;
  const bool own = j < H;

  float h[BB], c[BB];
  int len[BB];
#pragma unroll
  for (int r = 0; r < BB; ++r) {
    h[r] = 0.f;
    c[r] = 0.f;
    len[r] = (b0 + r < B) ? lengths[b0 + r] : 0;
    if (own) hs[r * H + j] = 0.f;
  }
  float bz[4] = {0.f, 0.f, 0.f, 0.f};
  if (own) {
#pragma unroll
    for (int g = 0; g < 4; ++g) bz[g] = bias[g * H + j];
  }
  __syncthreads();

  for (int s = 0; s < T; ++s) {
    const int t = d ? T - 1 - s : s;             // frame
    float acc[BB][4], xg[BB][4];
#pragma unroll
    for (int r = 0; r < BB; ++r) {
      acc[r][0] = acc[r][1] = acc[r][2] = acc[r][3] = 0.f;
      // this step's x-projection, loaded before the product hides it
      const size_t row = min(b0 + r, B - 1);
      const float* gr = gx + (row * T + t) * G;
#pragma unroll
      for (int g = 0; g < 4; ++g) xg[r][g] = own ? gr[g * H + j] : 0.f;
    }
    if (own) {
      // wh4[k * H + j] holds the 4 gate weights of unit j for input k
      const uint2* __restrict__ wh4 =
          reinterpret_cast<const uint2*>(wh) + j;
      int q0 = 0;
      for (; q0 + KU <= H; q0 += KU) {
        uint2 u[KU];                     // KU loads in flight per thread
#pragma unroll
        for (int q = 0; q < KU; ++q) u[q] = __ldg(wh4 + (size_t)(q0 + q) * H);
#pragma unroll
        for (int q = 0; q < KU; ++q)
          fma_gates<BB, 0>(acc, u[q], hs + q0 + q, H);
      }
      for (; q0 < H; ++q0)
        fma_gates<BB, 0>(acc, __ldg(wh4 + (size_t)q0 * H), hs + q0, H);
    }
    __syncthreads();                    // every read of hs precedes the write
    if (own) {
#pragma unroll
      for (int r = 0; r < BB; ++r) {
        const int b = b0 + r;
        if (b >= B) continue;
        const Cell cs = cell_step(xg[r], acc[r], bz, c[r]);
        const bool valid = t < len[r];
        if (valid) {                    // frozen carry on padded steps
          c[r] = cs.c;
          h[r] = cs.h;
        }
        y[((size_t)b * T + t) * 2 * H + (size_t)d * H + j] =
            __float2bfloat16(valid ? cs.h : 0.f);
        hs[r * H + j] = round_bf16(h[r]);
      }
    }
    __syncthreads();
  }
}

// The forward recurrence of K1 (every mode) and K3's replay: one cluster
// of C CTAs per (batch tile, direction, learner), grid (C·ceil(B / BB), 2,
// L), U = H / C threads per CTA (rounded up to 32); thread j of CTA c owns
// unit c·U + j for every row of the tile.  Dynamic shared memory: h of
// the step, bf16-rounded, for every unit, double-buffered ([2][H][BB]
// floats) and the tile's lengths.  y, the stash and the
// replayed gates come from the same instructions in every mode.
template <int BB, int MODE, int SD>
__global__ void __launch_bounds__(MAX_CTA) blstm_recur_cluster(
    const float* __restrict__ gx, const bf16* __restrict__ whf,
    const bf16* __restrict__ whb, const float* __restrict__ bias_f,
    const float* __restrict__ bias_b, const int* __restrict__ lengths,
    bf16* __restrict__ y, void* __restrict__ acts, void* __restrict__ cseq,
    void* __restrict__ hb, void* __restrict__ cb, int L, int B, int T, int H,
    int K, int n, int chunk, int C, int nd, int d0) {
  constexpr int KU = WEIGHT_LOADS;
  extern __shared__ __align__(16) float smem[];
  const int U = H / C;
  float* hs = smem;                              // [2][H][BB]
  int* lens = reinterpret_cast<int*>(hs + 2 * H * BB);
  const int rank = (int)(blockIdx.x % C);
  const int b0 = (int)(blockIdx.x / C) * BB;
  const int sl = blockIdx.y;                     // slot in the buffers
  const int d = d0 + sl;                         // direction
  const int l = blockIdx.z;
  const size_t G = 4 * (size_t)H;
  const bf16* __restrict__ wh = (d ? whb : whf) + (size_t)l * H * G;
  const float* __restrict__ bias = (d ? bias_b : bias_f) + (size_t)l * G;
  lengths += (size_t)l * B;
  const int Tg = MODE == REPLAY ? K : T;
  const int t0 = MODE == REPLAY ? chunk_t0(d, chunk, K, n) : 0;
  gx += (size_t)(nd * l + sl) * B * Tg * G;
  if constexpr (MODE != REPLAY) y += (size_t)l * B * T * nd * H;
  const size_t srow = (size_t)(sl * L + l) * B;  // stash row of b = 0
  const int jj = threadIdx.x;
  const int j = rank * U + jj;
  const bool own = jj < U;

  for (int r = threadIdx.x; r < BB; r += blockDim.x)
    lens[r] = b0 + r < B ? lengths[b0 + r] : 0;
  // h entering the first step, every unit: zero, or REPLAY's entry carry
  for (int e = threadIdx.x; e < 2 * H * BB; e += blockDim.x) {
    const int k = e / BB % H, r = e % BB, b = b0 + r;
    float v = 0.f;
    if constexpr (MODE == REPLAY) {
      if (e < H * BB && b < B)
        v = load_stash<SD>(hb, ((srow + b) * n + chunk) * H + k);
    }
    hs[e] = round_bf16(v);
  }
  float h[BB], c[BB];
#pragma unroll
  for (int r = 0; r < BB; ++r) {
    const int b = b0 + r;
    h[r] = 0.f;
    c[r] = 0.f;
    if constexpr (MODE == REPLAY) {
      if (own && b < B) {
        const size_t e = ((srow + b) * n + chunk) * H + j;
        h[r] = load_stash<SD>(hb, e);
        c[r] = load_stash<SD>(cb, e);
      }
    }
    if constexpr (MODE == FWD_ENTRY) {   // chunk 0 enters with zeros
      if (own && b < B) {
        store_stash<SD>(hb, (srow + b) * n * H + j, 0.f);
        store_stash<SD>(cb, (srow + b) * n * H + j, 0.f);
      }
    }
  }
  float bz[4] = {0.f, 0.f, 0.f, 0.f};
  if (own) {
#pragma unroll
    for (int g = 0; g < 4; ++g) bz[g] = bias[g * H + j];
  }
  // FWD_ENTRY: real step s is padded recurrence step s + off (the reverse
  // direction starts with T_pad - T masked steps, which change nothing)
  const int off = (MODE == FWD_ENTRY && d) ? n * K - T : 0;
  __syncthreads();
  if (C > 1) {                          // every peer has started
    cluster_arrive();
    cluster_wait();
  }

  for (int s = 0; s < Tg; ++s) {
    const int k = d ? Tg - 1 - s : s;            // local row
    const int t = t0 + k;                        // frame
    const float* hc = hs + (s & 1) * H * BB;     // h of the previous step
    float* hn = hs + ((s & 1) ^ 1) * H * BB;     // h of this step
    if constexpr (MODE == FWD_ENTRY) {
      const int sp = s + off;
      if (own && sp > 0 && sp % K == 0) {
#pragma unroll
        for (int r = 0; r < BB; ++r) {
          if (b0 + r >= B) continue;
          const size_t e = ((srow + b0 + r) * n + sp / K) * H + j;
          store_stash<SD>(hb, e, h[r]);
          store_stash<SD>(cb, e, c[r]);
        }
      }
    }
    float acc[BB][4], xg[BB][4];
#pragma unroll
    for (int r = 0; r < BB; ++r)
      acc[r][0] = acc[r][1] = acc[r][2] = acc[r][3] = 0.f;
    if (own) {
      // this step's x-projections, loaded before the product hides them
#pragma unroll
      for (int r = 0; r < BB; ++r) {
        const size_t row = min(b0 + r, B - 1);
        const float* gr = gx + (row * Tg + k) * G + j;
#pragma unroll
        for (int q = 0; q < 4; ++q) xg[r][q] = gr[q * H];
      }
      // wp[k * H] holds the 4 gate weights of unit j for input k
      const uint2* __restrict__ wp = reinterpret_cast<const uint2*>(wh) + j;
      uint2 u[KU];
#pragma unroll
      for (int q = 0; q < KU; ++q)
        if (q < H) u[q] = __ldg(wp + (size_t)q * H);
      const int Hm = H - H % KU;
      int k0 = 0;
      for (; k0 < Hm; k0 += KU) {
#pragma unroll
        for (int q = 0; q < KU; ++q) {
          const uint2 cur = u[q];
          if (k0 + KU + q < H) u[q] = __ldg(wp + (size_t)(k0 + KU + q) * H);
          fma_gates<BB, 1>(acc, cur, hc + (size_t)(k0 + q) * BB, 1);
        }
      }
#pragma unroll
      for (int q = 0; q < KU; ++q)
        if (k0 + q < H)
          fma_gates<BB, 1>(acc, u[q], hc + (size_t)(k0 + q) * BB, 1);
    }
    if (own) {
#pragma unroll
      for (int r = 0; r < BB; ++r) {
        const int b = b0 + r;
        if (b >= B) continue;
        const Cell cs = cell_step(xg[r], acc[r], bz, c[r]);
        const bool valid = t < lens[r];
        if (valid) {                    // frozen carry on padded steps
          c[r] = cs.c;
          h[r] = cs.h;
        }
        if constexpr (MODE != REPLAY)
          y[((size_t)b * T + t) * nd * H + (size_t)sl * H + j] =
              __float2bfloat16(valid ? cs.h : 0.f);
        hn[j * BB + r] = round_bf16(h[r]);
        if constexpr (MODE == FWD_STASH || MODE == REPLAY) {
          constexpr int OUT = MODE == REPLAY ? 1 : SD;
          const size_t st = (srow + b) * Tg + k;
          store_stash<OUT>(acts, st * G + j, cs.i);
          store_stash<OUT>(acts, st * G + H + j, cs.f);
          store_stash<OUT>(acts, st * G + 2 * H + j, cs.g);
          store_stash<OUT>(acts, st * G + 3 * H + j, cs.o);
          store_stash<OUT>(cseq, st * H + j, c[r]);
        }
      }
    }
    __syncthreads();                     // this CTA's slice of h is whole
    if (C > 1) {
      push_to_peers(hn, (size_t)rank * U * BB, U * BB, rank, C);
      cluster_arrive();
      cluster_wait();
    }
  }
}

// One batch of the resident forward's product: KB words of Wh (the
// weights of inputs 2k and 2k + 1 of the thread's (unit, gate)) and h of
// those inputs for every row, loaded together; `fma` adds them to the
// row sums in input order, one FMA a term as every kernel here does.
template <int BB>
struct FwdBatch {
  static constexpr int KB = 16 / BB;
  uint32_t w[KB];
  float h[KB][2 * BB];     // h[2k][0..BB), then h[2k + 1][0..BB)
  __device__ __forceinline__ void load(const uint32_t* wp, const float* hc,
                                       int k2, int NT) {
#pragma unroll
    for (int e = 0; e < KB; ++e) w[e] = wp[(size_t)(k2 + e) * NT];
#pragma unroll
    for (int e = 0; e < KB; ++e) {
      const float* hk = hc + (size_t)(2 * (k2 + e)) * BB;
      if constexpr (BB == 1) {
        const float2 v = *reinterpret_cast<const float2*>(hk);
        h[e][0] = v.x;
        h[e][1] = v.y;
      } else {
#pragma unroll
        for (int i = 0; i < 2 * BB; i += 4) {
          const float4 v = *reinterpret_cast<const float4*>(hk + i);
          h[e][i] = v.x;
          h[e][i + 1] = v.y;
          h[e][i + 2] = v.z;
          h[e][i + 3] = v.w;
        }
      }
    }
  }
  __device__ __forceinline__ void fma(float (&acc)[BB]) const {
#pragma unroll
    for (int e = 0; e < KB; ++e) {
      const float w0 = __uint_as_float(w[e] << 16);
      const float w1 = __uint_as_float(w[e] & 0xffff0000u);
#pragma unroll
      for (int r = 0; r < BB; ++r) acc[r] += h[e][r] * w0;
#pragma unroll
      for (int r = 0; r < BB; ++r) acc[r] += h[e][BB + r] * w1;
    }
  }
};

// The forward recurrence with Wh resident, one (batch tile, direction,
// learner) at a time on a cluster of RES_CLUSTER CTAs.  CTA c owns units
// [c·U, (c+1)·U), U = H / 16, and reads its slice of Wh (U units × 4 gates
// × H inputs, 128 KB at H = 512) from its shared memory every step.
// Thread 4·jj + q forms gate q of unit c·U + jj for every row of the tile:
// the sum over k of h[r][k]·Wh[k, qH + j] runs in the order of every other
// kernel here (k upwards, one FMA a term), so the bits are those of
// `blstm_recur_cluster` and `blstm_recur_item`.  Shuffles gather the
// unit's four gate sums and thread 4·jj + q updates the cell of rows q,
// q + 4, ..., and stores the new h of those rows, rounded to bf16 as every
// kernel here rounds it, into buffer (s + 1) % 2 of every CTA of the
// cluster (itself included) with st.async; step s + 1 starts when the
// step's H·BB·4 bytes have completed this CTA's barrier for that buffer.
// A peer can only write a buffer again two steps later, after it has
// received this CTA's next h, which no thread sends before its own product
// has read the buffer: no other barrier is needed.  The product loads its
// operands in batches, the next batch's in flight during this one's FMAs.
//
// Two kernels walk items with it: `blstm_recur_resident` (one item a
// cluster, the training forwards) and the fused stack K4 (lstm_stack.cu:
// every layer's items in one launch, each cluster walking several).

// A resident CTA's dynamic shared memory (`res_smem` bytes from `base`):
// its slice of Wh as words [k/2][4U] (the bf16 weights of inputs k and
// k + 1, k even, of one (unit, gate)), h double-buffered ([2][H][BB]
// floats), a barrier per buffer and the tile's lengths.
template <int BB>
struct ResSmem {
  uint32_t* ws;
  float* hs;
  uint64_t* bar;
  int* lens;
  __device__ __forceinline__ ResSmem(float* base, int H) {
    ws = reinterpret_cast<uint32_t*>(base);
    hs = base + (size_t)(H / 2) * 4 * (H / RES_CLUSTER);
    bar = reinterpret_cast<uint64_t*>(hs + 2 * H * BB);
    lens = reinterpret_cast<int*>(bar + 2);
  }
  // once a launch, before the first item's cluster barrier publishes them
  __device__ __forceinline__ void init_barriers() const {
    if (threadIdx.x == 0) {
      sm90::mbar_init(bar, 1);
      sm90::mbar_init(bar + 1, 1);
      sm90::mbar_fence_init();
    }
  }
};

// Start copying CTA `rank`'s slice of learner l's Wh (the resident layout
// (L, 16, H/2, U, 4, 2), `lstm_cell._res_fwd_layout`) into the start of
// its shared memory with cp.async, every thread of the block issuing its
// share; `resident_item` waits for it.
__device__ __forceinline__ void res_load_slice(float* base,
                                               const uint32_t* wr, int l,
                                               int rank, int H) {
  const size_t words = (size_t)(H / 2) * 4 * (H / RES_CLUSTER);
  cp_async_block(base, wr + ((size_t)l * RES_CLUSTER + rank) * words,
                 words * 4);
}

// One item (batch tile `tile`, direction d, learner l) on CTA `rank` of
// its cluster, every CTA of the cluster calling it together, with its
// slice of Wh in shared memory at `smem` or on its way there (cp.async)
// and its barriers set up.  `par` holds the parity of each barrier's next
// phase; the parities after the item are returned, so a CTA may walk
// items and layers one after another in a launch.  Every thread of the
// CTA calls it (any block size from 4U up); the warps that own no (unit,
// gate) leave after the cluster barrier that starts the item.  No barrier
// follows the last step: the caller keeps a CTA from exiting, or from its
// next item, while a peer still works.
template <int BB, int MODE, int SD>
__device__ __forceinline__ uint32_t resident_item(
    const float* gx, const float* bias_f, const float* bias_b,
    const int* lengths, bf16* y, void* acts, void* cseq, void* hb, void* cb,
    int L, int B, int T, int H, int K, int n, int chunk, int tile, int d,
    int l, int rank, float* smem, uint32_t par, int nd = 2) {
  constexpr int C = RES_CLUSTER;
  const int sl = nd == 2 ? d : 0;                // slot in the buffers
  constexpr int RPT = (BB + 3) / 4;              // rows a thread updates
  const int U = H / C, NT = 4 * U, H2 = H / 2;
  const ResSmem<BB> sm(smem, H);
  const int b0 = tile * BB;
  const size_t G = 4 * (size_t)H;
  const float* bias = (d ? bias_b : bias_f) + (size_t)l * G;
  lengths += (size_t)l * B;
  const int Tg = MODE == REPLAY ? K : T;
  const int t0 = MODE == REPLAY ? chunk_t0(d, chunk, K, n) : 0;
  gx += (size_t)(nd * l + sl) * B * Tg * G;
  if constexpr (MODE != REPLAY) y += (size_t)l * B * T * nd * H;
  const size_t srow = (size_t)(sl * L + l) * B;  // stash row of b = 0
  const int tid = threadIdx.x;
  const bool own = tid < NT;
  const int jj = tid >> 2, q = tid & 3;          // unit, gate
  const int j = rank * U + jj;
  const int lane0 = (tid & 31) & ~3;             // the unit's first lane
  // every CTA's shared-memory window, and this CTA's offsets in it
  const uint32_t base = sm90::smem_u32(smem);
  uint32_t peer[C];
#pragma unroll
  for (int p = 0; p < C; ++p) peer[p] = cluster_base(base, p);
  const uint32_t hs_off = sm90::smem_u32(sm.hs) - base;
  const uint32_t bar_off = sm90::smem_u32(sm.bar) - base;

  __syncthreads();                 // no thread still reads the last item's h
  for (int r = tid; r < BB; r += blockDim.x)
    sm.lens[r] = b0 + r < B ? lengths[b0 + r] : 0;
  for (int e = tid; e < 2 * H * BB; e += blockDim.x) {
    const int k = e / BB % H, r = e % BB, b = b0 + r;
    float v = 0.f;
    if constexpr (MODE == REPLAY) {
      if (e < H * BB && b < B)
        v = load_stash<SD>(hb, ((srow + b) * n + chunk) * H + k);
    }
    sm.hs[e] = round_bf16(v);
  }
  // thread (jj, q) carries rows q, q + 4, ... of unit j
  float h[RPT], c[RPT];
#pragma unroll
  for (int i = 0; i < RPT; ++i) {
    const int r = q + 4 * i, b = b0 + r;
    h[i] = 0.f;
    c[i] = 0.f;
    const bool mine = own && r < BB && b < B;
    if constexpr (MODE == REPLAY) {
      if (mine) {
        const size_t e = ((srow + b) * n + chunk) * H + j;
        h[i] = load_stash<SD>(hb, e);
        c[i] = load_stash<SD>(cb, e);
      }
    }
    if constexpr (MODE == FWD_ENTRY) {   // chunk 0 enters with zeros
      if (mine) {
        store_stash<SD>(hb, (srow + b) * n * H + j, 0.f);
        store_stash<SD>(cb, (srow + b) * n * H + j, 0.f);
      }
    }
  }
  float bz[4] = {0.f, 0.f, 0.f, 0.f};
  if (own) {
#pragma unroll
    for (int g = 0; g < 4; ++g) bz[g] = bias[g * H + j];
  }
  const int off = (MODE == FWD_ENTRY && d) ? n * K - T : 0;
  cp_async_wait();                       // this thread's share of the slice
  __syncthreads();
  cluster_arrive();                      // every peer's item has begun: its
  cluster_wait();                        // barriers and h are set up
  if (tid >= (NT + 31) / 32 * 32) return par;    // warps owning no gate

  for (int s = 0; s < Tg; ++s) {
    const int k = d ? Tg - 1 - s : s;            // local row
    const int t = t0 + k;                        // frame
    const int nb = (s & 1) ^ 1;                  // the buffer this step fills
    const float* hc = sm.hs + (s & 1) * H * BB;  // h of the previous step
    const bool send = s + 1 < Tg;                // the last h is not read
    if (tid == 0 && send)
      sm90::mbar_arrive_expect_tx(sm.bar + nb, (uint32_t)(H * BB * 4));
    if constexpr (MODE == FWD_ENTRY) {
      const int sp = s + off;
      if (own && sp > 0 && sp % K == 0) {
#pragma unroll
        for (int i = 0; i < RPT; ++i) {
          const int r = q + 4 * i;
          if (r >= BB || b0 + r >= B) continue;
          const size_t e = ((srow + b0 + r) * n + sp / K) * H + j;
          store_stash<SD>(hb, e, h[i]);
          store_stash<SD>(cb, e, c[i]);
        }
      }
    }
    // this step's x-projections of the rows this thread updates, loaded
    // before the product hides them
    float xg[RPT][4];
#pragma unroll
    for (int i = 0; i < RPT; ++i) {
      const int r = q + 4 * i;
      const size_t row = min(b0 + min(r, BB - 1), B - 1);
      const float* gr = gx + (row * Tg + k) * G + j;
#pragma unroll
      for (int g = 0; g < 4; ++g) xg[i][g] = own ? gr[g * H] : 0.f;
    }
    // h of the previous step has arrived from every CTA
    if (s > 0) {
      const int b = s & 1;
      mbar_wait_cluster(sm.bar + b, (par >> b) & 1u);
      par ^= 1u << b;
    }
    float acc[BB];
#pragma unroll
    for (int r = 0; r < BB; ++r) acc[r] = 0.f;
    if (own) {
      // batches of KB word rows (2·KB inputs), the next batch's loads in
      // flight while this one's FMAs run (H/2 is a multiple of 2·KB)
      const uint32_t* wp = sm.ws + tid;
      FwdBatch<BB> a, b;
      a.load(wp, hc, 0, NT);
      for (int k2 = 0; k2 < H2; k2 += 2 * FwdBatch<BB>::KB) {
        b.load(wp, hc, k2 + FwdBatch<BB>::KB, NT);
        a.fma(acc);
        if (k2 + 2 * FwdBatch<BB>::KB < H2)
          a.load(wp, hc, k2 + 2 * FwdBatch<BB>::KB, NT);
        b.fma(acc);
      }
    }
    // the unit's four gate sums of the rows this thread updates
    float a4[RPT][4];
#pragma unroll
    for (int r = 0; r < BB; ++r) {
#pragma unroll
      for (int g = 0; g < 4; ++g) {
        const float v = __shfl_sync(0xffffffffu, acc[r], lane0 | g);
        if (r % 4 == q) a4[r / 4][g] = v;
      }
    }
    if (own) {
#pragma unroll
      for (int i = 0; i < RPT; ++i) {
        const int r = q + 4 * i, b = b0 + r;
        if (r >= BB || b >= B) continue;
        const Cell cs = cell_step(xg[i], a4[i], bz, c[i]);
        const bool valid = t < sm.lens[r];
        if (valid) {                    // frozen carry on padded steps
          c[i] = cs.c;
          h[i] = cs.h;
        }
        if constexpr (MODE != REPLAY)
          y[((size_t)b * T + t) * nd * H + (size_t)sl * H + j] =
              __float2bfloat16(valid ? cs.h : 0.f);
        if constexpr (MODE == FWD_STASH || MODE == REPLAY) {
          constexpr int OUT = MODE == REPLAY ? 1 : SD;
          const size_t st = (srow + b) * Tg + k;
          store_stash<OUT>(acts, st * G + j, cs.i);
          store_stash<OUT>(acts, st * G + H + j, cs.f);
          store_stash<OUT>(acts, st * G + 2 * H + j, cs.g);
          store_stash<OUT>(acts, st * G + 3 * H + j, cs.o);
          store_stash<OUT>(cseq, st * H + j, c[i]);
        }
      }
      // h of every row of the tile (0 past B) into every CTA's buffer nb
      const uint32_t dst = hs_off + (uint32_t)((nb * H + j) * BB) * 4;
      const uint32_t nbar = bar_off + nb * 8;
#pragma unroll
      for (int i = 0; i < RPT; ++i) {
        const int r = q + 4 * i;
        if (!send || r >= BB) continue;
        const float v = round_bf16(h[i]);
#pragma unroll
        for (int p = 0; p < C; ++p)
          st_async(peer[p] + dst + r * 4, v, peer[p] + nbar);
      }
    }
  }
  return par;
}

// The training forwards' resident recurrence (K1-stash, K1-chunk, K3's
// replay): one item a cluster, grid (16·ceil(B / BB), 2, L) in as many
// waves of clusters as the card holds (7 clusters of 16 on the H100).
// Each CTA copies its slice of Wh into shared memory once, at the start.
template <int BB, int MODE, int SD>
__global__ void __launch_bounds__(MAX_RES_THREADS, 1) blstm_recur_resident(
    const float* __restrict__ gx, const uint32_t* __restrict__ wrf,
    const uint32_t* __restrict__ wrb, const float* __restrict__ bias_f,
    const float* __restrict__ bias_b, const int* __restrict__ lengths,
    bf16* __restrict__ y, void* __restrict__ acts, void* __restrict__ cseq,
    void* __restrict__ hb, void* __restrict__ cb, int L, int B, int T, int H,
    int K, int n, int chunk, int nd, int d0) {
  extern __shared__ __align__(16) float smem[];
  const int rank = (int)(blockIdx.x % RES_CLUSTER);
  const int d = d0 + (int)blockIdx.y, l = blockIdx.z;
  res_load_slice(smem, d ? wrb : wrf, l, rank, H);
  ResSmem<BB>(smem, H).init_barriers();
  resident_item<BB, MODE, SD>(gx, bias_f, bias_b, lengths, y, acts, cseq, hb,
                              cb, L, B, T, H, K, n, chunk,
                              (int)(blockIdx.x / RES_CLUSTER), d, l, rank,
                              smem, 0u, nd);
  cluster_arrive();                      // no CTA leaves while a peer works
  cluster_wait();
}

template <int BB, int MODE, int SD>
int launch_fwd(const FwdArgs& a, const Plan& p, cudaStream_t st) {
  const int tiles = (a.B + BB - 1) / BB;
  if (p.resident) {
    if constexpr (MODE == FWD) {
      // K1's inference launch streams Wh: it is the ≡ oracle of K4, whose
      // own launch (lstm_stack.cu) runs the resident items
      return (int)cudaErrorInvalidValue;
    } else {
      const int U = res_units(a.H, BB);
      if (!U) return (int)cudaErrorInvalidValue;
      return launch_cluster(
          blstm_recur_resident<BB, MODE, SD>,
          dim3(RES_CLUSTER * tiles, a.nd, a.L), (4 * U + 31) / 32 * 32,
          res_smem(a.H, BB), RES_CLUSTER, st, a.gx,
          reinterpret_cast<const uint32_t*>(a.whf),
          reinterpret_cast<const uint32_t*>(a.whb), a.bias_f, a.bias_b,
          a.lengths, a.y, a.acts, a.cseq, a.hb, a.cb, a.L, a.B, a.T, a.H,
          a.K, a.n, a.chunk, a.nd, a.d0);
    }
  }
  const int C = p.cluster;
  const int U = cluster_units(a.H, C);
  if (!U) return (int)cudaErrorInvalidValue;
  const size_t smem = (size_t)2 * a.H * BB * sizeof(float) + BB * sizeof(int);
  return launch_cluster(blstm_recur_cluster<BB, MODE, SD>,
                        dim3(C * tiles, a.nd, a.L), (U + 31) / 32 * 32, smem,
                        C, st, a.gx, a.whf, a.whb, a.bias_f, a.bias_b,
                        a.lengths, a.y, a.acts, a.cseq, a.hb, a.cb, a.L, a.B,
                        a.T, a.H, a.K, a.n, a.chunk, C, a.nd, a.d0);
}

template <int MODE, int SD>
int launch_fwd_rows(const Plan& p, const FwdArgs& a, cudaStream_t st) {
  switch (p.block_b) {
    case 1: return launch_fwd<1, MODE, SD>(a, p, st);
    case 2: return launch_fwd<2, MODE, SD>(a, p, st);
    case 4: return launch_fwd<4, MODE, SD>(a, p, st);
    case 8: return launch_fwd<8, MODE, SD>(a, p, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

// ---------------------------------------------------------------- reverse

struct BwdArgs {
  const bf16* dy;         // (L, B, T, nd*H): slot s in columns s*H..
  const void* acts;       // (nd, L, B, Tg, 4H) in dtype SD
  const void* cseq;       // (nd, L, B, Tg, H)
  const bf16* whf;        // (L, H, H, 4): W4[c, j, q] = Wh[j, 4c + q]
  const bf16* whb;
  const int* lengths;     // (L, B)
  float* dg;              // (nd, L, B, Tg, 4H) f32 out
  const void* cb;         // chunked: entry c carries (nd, L, B, n, H), dtype CK
  float* dh;              // chunked: (dh, dc) carries (nd, L, B, H) f32, in
  float* dc;              //   from the later chunk and out to the earlier one
  int L, B, T, H;
  int K, n, chunk;        // chunked: chunk length, count, and this chunk
  int nd, d0;             // directions in the launch, direction of slot 0
};

// acc[r] += Σ_q dg[r][4c + q] * Wh[j, 4c + q] for the 4 weights in `u`;
// `dgc` points at the 4 dgates of group c of row 0, row r's 4 at dgc + 4r.
template <int BB>
__device__ __forceinline__ void fma_row(float (&acc)[BB], uint2 u,
                                        const float* dgc) {
  const __nv_bfloat162 w01 = *reinterpret_cast<const __nv_bfloat162*>(&u.x);
  const __nv_bfloat162 w23 = *reinterpret_cast<const __nv_bfloat162*>(&u.y);
  const float w0 = __low2float(w01), w1 = __high2float(w01);
  const float w2 = __low2float(w23), w3 = __high2float(w23);
#pragma unroll
  for (int r = 0; r < BB; ++r) {
    const float4 g = *reinterpret_cast<const float4*>(dgc + 4 * r);
    acc[r] += g.x * w0 + g.y * w1 + g.z * w2 + g.w * w3;
  }
}

// The reverse recurrence of K2 and K3: one cluster of C CTAs per (batch
// tile, direction, learner), laid out as the forward's.  Each step thread
// j of CTA c forms the four gate cotangents of unit c·U + j for every row
// of the tile from the stash, writes them to dgates and to its CTA's
// gather buffer, the CTA copies its slice into every peer's buffer, and
// behind the cluster barrier every CTA holds the step's whole dgates
// block, from which thread j computes dh_{t-1}[j] = Σ_n dgates[n]·Wh[j, n]
// for its own unit.  Dynamic shared memory: the gather buffer, dgates n =
// 4c + q of row r at [(c·BB + r)·4 + q] (H·BB·4 floats), and the
// lengths.  (Two units a thread, each dgates read feeding both, ran
// slower at the training and the long shapes on the H100.)
// CK = 0: all T steps, (dh, dc) start at zero, c_{t-1} is zero at the
// sequence's first step.  CK = 1 or 2: one chunk (Tg = K) whose first
// step's c_{t-1} is its entry carry, with the (dh, dc) carries read at the
// start and written at the end.
template <int BB, int SD, int CK>
__global__ void __launch_bounds__(MAX_CTA) lstm_bwd_recur_cluster(
    const bf16* __restrict__ dy, const void* __restrict__ acts,
    const void* __restrict__ cseq, const bf16* __restrict__ whf,
    const bf16* __restrict__ whb, const int* __restrict__ lengths,
    float* __restrict__ dg, const void* __restrict__ cb,
    float* __restrict__ dhp, float* __restrict__ dcp, int L, int B, int T,
    int H, int K, int n, int chunk, int C, int nd, int d0) {
  constexpr int KU = WEIGHT_LOADS;
  extern __shared__ __align__(16) float smem[];
  const int U = H / C;
  float* dgs = smem;                             // [H][BB][4]
  int* lens = reinterpret_cast<int*>(dgs + 4 * H * BB);
  const int rank = (int)(blockIdx.x % C);
  const int b0 = (int)(blockIdx.x / C) * BB;
  const int sl = blockIdx.y;                     // slot in the buffers
  const int d = d0 + sl;                         // direction
  const int l = blockIdx.z;
  const size_t G = 4 * (size_t)H;
  const bf16* __restrict__ wh = (d ? whb : whf) + (size_t)l * H * G;
  lengths += (size_t)l * B;
  dy += (size_t)l * B * T * nd * H + (size_t)sl * H;
  const int Tg = CK ? K : T;
  const int t0 = CK ? chunk_t0(d, chunk, K, n) : 0;
  const size_t srow = (size_t)(sl * L + l) * B;  // stash/dgates row of b = 0
  const int jj = threadIdx.x;
  const int j = rank * U + jj;
  const bool own = jj < U;

  for (int r = threadIdx.x; r < BB; r += blockDim.x)
    lens[r] = b0 + r < B ? lengths[b0 + r] : 0;
  float dh_c[BB], dc_c[BB], c_in[BB];
#pragma unroll
  for (int r = 0; r < BB; ++r) {
    const int b = b0 + r;
    dh_c[r] = 0.f;
    dc_c[r] = 0.f;
    c_in[r] = 0.f;
    if constexpr (CK != 0) {
      if (own && b < B) {
        const size_t e = (srow + b) * H + j;
        dh_c[r] = dhp[e];
        dc_c[r] = dcp[e];
        c_in[r] = load_stash<CK>(cb, ((srow + b) * n + chunk) * H + j);
      }
    }
  }
  __syncthreads();
  if (C > 1) cluster_arrive();          // (its wait: every peer has started)

  for (int v = 0; v < Tg; ++v) {
    // the recurrence step undone now, and the one before it
    const int k = d ? v : Tg - 1 - v;
    const int kp = d ? k + 1 : k - 1;
    const bool boundary = v == Tg - 1;
    const int t = t0 + k;
    if (own) {
#pragma unroll
      for (int r = 0; r < BB; ++r) {
        const int b = b0 + r;
        const bool vm = t < lens[r];
        float gates[4] = {0.f, 0.f, 0.f, 0.f};
        if (b < B) {
          const size_t st = (srow + b) * Tg + k;
          const float i_ = load_stash<SD>(acts, st * G + j);
          const float f_ = load_stash<SD>(acts, st * G + H + j);
          const float g_ = load_stash<SD>(acts, st * G + 2 * H + j);
          const float o_ = load_stash<SD>(acts, st * G + 3 * H + j);
          const float c = load_stash<SD>(cseq, st * H + j);
          const float cp = boundary
              ? c_in[r] : load_stash<SD>(cseq, ((srow + b) * Tg + kp) * H + j);
          const float dyv =
              t < T ? __bfloat162float(dy[((size_t)b * T + t) * nd * H + j])
                    : 0.f;
          float dh = dyv + dh_c[r];
          const float tc = tanhf(c);
          float dc = dh * o_ * (1.f - tc * tc) + dc_c[r];
          if (!vm) {
            dh = 0.f;
            dc = 0.f;
          }
          gates[0] = dc * g_ * i_ * (1.f - i_);
          gates[1] = dc * cp * f_ * (1.f - f_);
          gates[2] = dc * i_ * (1.f - g_ * g_);
          gates[3] = dh * tc * o_ * (1.f - o_);
          float* out = dg + st * G + j;
#pragma unroll
          for (int g = 0; g < 4; ++g) out[g * H] = gates[g];
          if (vm) dc_c[r] = dc * f_;     // padded step: the carry passes
        }
#pragma unroll
        for (int g = 0; g < 4; ++g) {
          const int nn = g * H + j;
          dgs[((nn >> 2) * BB + r) * 4 + (nn & 3)] = gates[g];
        }
      }
    }
    __syncthreads();                     // this CTA's slice of dgates is whole
    if (C > 1) {
      cluster_wait();                    // every peer has read the last step's
#pragma unroll
      for (int g = 0; g < 4; ++g)
        push_to_peers(dgs, (size_t)(g * H + rank * U) * BB, U * BB, rank, C);
      cluster_arrive();
      cluster_wait();                    // the whole block is everywhere
    }
    if (own) {
      float acc[BB];
#pragma unroll
      for (int r = 0; r < BB; ++r) acc[r] = 0.f;
      // wp[c * H] holds Wh[j, 4c .. 4c + 3]
      const uint2* __restrict__ wp = reinterpret_cast<const uint2*>(wh) + j;
      uint2 u[KU];
#pragma unroll
      for (int q = 0; q < KU; ++q)
        if (q < H) u[q] = __ldg(wp + (size_t)q * H);
      const int Hm = H - H % KU;
      int c0 = 0;
      for (; c0 < Hm; c0 += KU) {
#pragma unroll
        for (int q = 0; q < KU; ++q) {
          const uint2 cur = u[q];
          if (c0 + KU + q < H) u[q] = __ldg(wp + (size_t)(c0 + KU + q) * H);
          fma_row<BB>(acc, cur, dgs + (size_t)(c0 + q) * BB * 4);
        }
      }
#pragma unroll
      for (int q = 0; q < KU; ++q)
        if (c0 + q < H) fma_row<BB>(acc, u[q], dgs + (size_t)(c0 + q) * BB * 4);
#pragma unroll
      for (int r = 0; r < BB; ++r)
        if (t < lens[r]) dh_c[r] = acc[r];
    }
    if (C > 1) cluster_arrive();         // this CTA has read its buffer
    __syncthreads();                     // every read precedes the next write
  }
  if (C > 1) cluster_wait();
  if constexpr (CK != 0) {
#pragma unroll
    for (int r = 0; r < BB; ++r) {
      if (!own || b0 + r >= B) continue;
      const size_t e = (srow + b0 + r) * H + j;
      dhp[e] = dh_c[r];
      dcp[e] = dc_c[r];
    }
  }
}

template <int BB, int SD, int CK>
int launch_bwd(const BwdArgs& a, int C, cudaStream_t st) {
  const int U = cluster_units(a.H, C);
  if (!U) return (int)cudaErrorInvalidValue;
  const dim3 grid(C * ((a.B + BB - 1) / BB), a.nd, a.L);
  const size_t smem = (size_t)4 * a.H * BB * sizeof(float) + BB * sizeof(int);
  return launch_cluster(lstm_bwd_recur_cluster<BB, SD, CK>, grid,
                        (U + 31) / 32 * 32, smem, C, st, a.dy, a.acts, a.cseq,
                        a.whf, a.whb, a.lengths, a.dg, a.cb, a.dh, a.dc, a.L,
                        a.B, a.T, a.H, a.K, a.n, a.chunk, C, a.nd, a.d0);
}

template <int SD, int CK>
int launch_bwd_rows(int block_b, int C, const BwdArgs& a, cudaStream_t st) {
  switch (block_b) {
    case 1: return launch_bwd<1, SD, CK>(a, C, st);
    case 2: return launch_bwd<2, SD, CK>(a, C, st);
    case 4: return launch_bwd<4, SD, CK>(a, C, st);
    case 8: return launch_bwd<8, SD, CK>(a, C, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace lstm_recur
