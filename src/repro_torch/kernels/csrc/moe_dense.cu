// Fused dense mixture of experts (the dense router's FFN of the moe
// family), hand-written for sm_90a.
//
// Replaces the TPU kernel K10: src/repro/kernels/moe_dense.py,
// `_moe_kernel` (pallas_call at moe_dense.py:72).  Same function:
// x (T, d) bf16, router weights w (T, E) f32 (0 for experts not selected),
// wi and wg (E, d, f), wo (E, f, d) bf16 -> y (T, d) bf16 with
//   y = sum_e w[:, e] * (act(x wi_e, x wg_e) wo_e)
// where h = x wi_e and g = x wg_e are f32 sums of bf16 products,
// act = silu(g) * h (swiglu) or the tanh-approximated gelu(h), taken in
// f32 and rounded once to bf16; that hidden times wo_e is an f32 sum,
// scaled by w[:, e] and added into an f32 accumulator; y is rounded once.
// One thing differs from the TPU kernel: any T >= 1 is accepted (it
// asserts T % tile_t == 0; here rows past T are zero-filled on load and
// never written).
//
// Design.  On the TPU one program owns a token tile and walks the 40
// experts on a sequential grid axis, the (tile, d_ff) hidden in VMEM.
// Here that would give one CTA per token tile: at decode (T <= 8) one CTA
// for 188.7 MB of weights.  So the work is spread three ways:
//   * over clusters of CL = f / 64 CTAs (8 at granite's f = 512): CTA r of
//     a cluster computes hidden columns [64 r, 64 r + 64) of every expert
//     (reading only that slice of wi and wg), keeps them in its shared
//     memory, and after a cluster barrier every CTA gathers the whole
//     (tile, f) hidden from its peers' shared memory (distributed shared
//     memory) and computes output columns [r d / CL, (r + 1) d / CL) of
//     h wo_e (reading only that slice of wo).  No weight is read twice
//     per token tile and the hidden never leaves the chip;
//   * over expert groups of EPG = 2 consecutive experts (20 groups at
//     E = 40): each CTA accumulates its group's experts in order in
//     registers and writes one f32 partial of y per group;
//   * over token tiles of TT rows: 16 when T <= 16 (decode), else 64.
// A second short pass sums the G group partials of each element in the
// order g = 0 .. G-1 and rounds to bf16.  At decode that is 8 x 20 = 160
// CTAs (two fit on an SM), every one streaming 1.18 MB of weights.
//
// Determinism and row independence.  A token's result does not depend on
// T or on the rows that share its tile: every output element is the same
// sequence of mma.sync k16 steps over the same k order in both tile
// heights, the expert order inside a group and the group order of the
// second pass are fixed, and CL, EPG and the column split depend on
// (d, E, f) only.
//
// Products: mma.sync.m16n8k16 bf16 with f32 sums; A fragments by
// ldmatrix, B fragments (row-major weights) by ldmatrix.trans.  Weight
// and x tiles of 64 k-rows stream through a ring of STAGES buffers with
// 16-byte cp.async, one chunk stream per CTA across both phases and all
// its experts, so the wo tiles of an expert are in flight while its
// hidden is finished.
//
// What bounds it on the H100: at decode bytes (every expert's weights
// once: 188.7 MB per granite layer, 56.3 us at 3.35 TB/s); at prefill
// operations (188.7 MFLOP a token, 133.6 us at T = 700 at the bf16 peak).
// This simple kernel issues mma.sync (not wgmma), re-reads each weight
// tile from L2 for every 64-token tile and the x tile in every CTA of a
// cluster, and writes (G, T, d) f32 partials: wgmma with TMA multicast of
// x, 128-row tiles and fewer partials are later work.

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr int WARPS = 8;
constexpr int THREADS = 32 * WARPS;
constexpr int BK = 64;          // k rows per streamed chunk
constexpr int FS = 64;          // hidden columns per CTA of a cluster
constexpr int PAD = 8;          // bf16 padding of a shared-memory row
constexpr int LD1 = BK + PAD;   // row stride of the x, wi, wg chunks
constexpr int LDH = FS + PAD;   // row stride of a CTA's hidden slice
constexpr int MAX_CLUSTER = 8;

struct Args {
  const __nv_bfloat16* x;       // (T, d)
  const float* w;               // (T, E)
  const __nv_bfloat16* wi;      // (E, d, f)
  const __nv_bfloat16* wg;      // (E, d, f)
  const __nv_bfloat16* wo;      // (E, f, d)
  float* partial;               // (G, T, d)
  int T, d, E, f, gelu, epg;
};

__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           int src_bytes) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
               "l"(src), "r"(src_bytes));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const void* p) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(p);
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(s));
}

__device__ __forceinline__ void ldsm_x4_t(uint32_t (&r)[4], const void* p) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(p);
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(s));
}

__device__ __forceinline__ void ldsm_x2_t(uint32_t& r0, uint32_t& r1,
                                          const void* p) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(p);
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x2.trans.shared.b16 {%0,%1}, [%2];\n"
      : "=r"(r0), "=r"(r1)
      : "r"(s));
}

// d += a (16 x 16, row-major) * b (16 x 8, column-major), bf16 in, f32 out
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// A fragment of rows [r0, r0 + 16), k columns [k0, k0 + 16) of a row-major
// bf16 tile with row stride ld
__device__ __forceinline__ void load_a(uint32_t (&a)[4],
                                       const __nv_bfloat16* base, int ld,
                                       int r0, int k0) {
  const int t = threadIdx.x & 31;
  ldsm_x4(a, base + (r0 + (t & 7) + ((t >> 3) & 1) * 8) * ld + k0 +
                 (t >> 4) * 8);
}

// acc[nt] += a * B[k0 .. k0 + 16, n0 + 8 nt .. + 8] for NT n8 tiles of a
// row-major bf16 (k, n) tile with row stride ld
template <int NT>
__device__ __forceinline__ void mma_row(float (&acc)[NT][4],
                                        const uint32_t (&a)[4],
                                        const __nv_bfloat16* base, int ld,
                                        int k0, int n0) {
  const int t = threadIdx.x & 31;
  const __nv_bfloat16* p = base + (k0 + (t & 7) + ((t >> 3) & 1) * 8) * ld +
                           n0 + (t >> 4) * 8;
#pragma unroll
  for (int nt = 0; nt + 1 < NT; nt += 2) {
    uint32_t b[4];
    ldsm_x4_t(b, p + nt * 8);
    mma_bf16(acc[nt], a, b[0], b[1]);
    mma_bf16(acc[nt + 1], a, b[2], b[3]);
  }
  if (NT & 1) {
    uint32_t b0, b1;
    ldsm_x2_t(b0, b1, base + (k0 + (t & 7) + ((t >> 3) & 1) * 8) * ld + n0 +
                          (NT - 1) * 8);
    mma_bf16(acc[NT - 1], a, b0, b1);
  }
}

__device__ __forceinline__ float gelu_tanh(float h) {
  const float c = 0.7978845608028654f;   // sqrt(2 / pi)
  return 0.5f * h * (1.f + tanhf(c * (h + 0.044715f * h * h * h)));
}

// TT token rows per CTA; DSB: output columns per CTA / 64
template <int TT, int DSB>
struct Tile {
  static constexpr int WM = TT / 16;           // warps along rows
  static constexpr int WN = WARPS / WM;        // warps along columns
  static constexpr int DS = DSB * 64;          // output columns per CTA
  static constexpr int LD2 = DS + PAD;         // row stride of a wo chunk
  static constexpr int NT1 = FS / WN / 8;      // n8 tiles per warp, phase 1
  static constexpr int NT2 = DS / WN / 8;      // n8 tiles per warp, phase 2
  static constexpr int STAGES = TT == 16 ? 3 : 4;
  static constexpr int P1 = TT * LD1 + 2 * BK * LD1;   // x, wi, wg chunks
  static constexpr int P2 = BK * LD2;                  // a wo chunk
  static constexpr int STAGE = P1 > P2 ? P1 : P2;      // bf16 elements
  static constexpr int MIN_BLOCKS = TT == 16 ? 2 : 1;
  static size_t smem_bytes(int f) {
    return (size_t)(STAGES * STAGE + 2 * TT * LDH + TT * (f + PAD)) * 2;
  }
};

// Issue streamed chunk c of this CTA into ring buffer `buf`: expert
// c / (KC1 + KC2) of the group; phase 1 (x, wi, wg k-rows) for the first
// KC1 chunks of an expert, phase 2 (wo k-rows) for the next KC2.  Past the
// stream's end an empty group keeps the wait counts uniform.
template <int TT, int DSB>
__device__ __forceinline__ void issue_chunk(const Args& a, int c, int total,
                                            int e0, int t0, int rank,
                                            __nv_bfloat16* buf) {
  using L = Tile<TT, DSB>;
  if (c < total) {
    const int KC1 = a.d / BK, KC2 = a.f / BK;
    const int e = e0 + c / (KC1 + KC2);
    const int j = c % (KC1 + KC2);
    if (j < KC1) {
      const int k0 = j * BK;
      for (int i = threadIdx.x; i < TT * 8; i += THREADS) {
        const int r = i >> 3, q = i & 7;
        const bool in = t0 + r < a.T;
        const __nv_bfloat16* src =
            a.x + (size_t)(in ? t0 + r : 0) * a.d + k0 + q * 8;
        cp_async16(buf + r * LD1 + q * 8, src, in ? 16 : 0);
      }
      const size_t base = ((size_t)e * a.d + k0) * a.f + rank * FS;
      __nv_bfloat16* wis = buf + TT * LD1;
      __nv_bfloat16* wgs = wis + BK * LD1;
      for (int i = threadIdx.x; i < BK * 8; i += THREADS) {
        const int r = i >> 3, q = i & 7;
        const size_t off = base + (size_t)r * a.f + q * 8;
        cp_async16(wis + r * LD1 + q * 8, a.wi + off, 16);
        if (!a.gelu) cp_async16(wgs + r * LD1 + q * 8, a.wg + off, 16);
      }
    } else {
      const int k0 = (j - KC1) * BK;
      constexpr int CPR = L::DS / 8;
      const size_t base = ((size_t)e * a.f + k0) * a.d + rank * L::DS;
      for (int i = threadIdx.x; i < BK * CPR; i += THREADS) {
        const int r = i / CPR, q = i - r * CPR;
        cp_async16(buf + r * L::LD2 + q * 8,
                   a.wo + base + (size_t)r * a.d + q * 8, 16);
      }
    }
  }
  cp_async_commit();
}

template <int TT, int DSB>
__global__ void __launch_bounds__(THREADS, Tile<TT, DSB>::MIN_BLOCKS)
    moe_dense_kernel(const Args a) {
  using L = Tile<TT, DSB>;
  constexpr int STAGES = L::STAGES;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* ring = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* hid = ring + STAGES * L::STAGE;     // 2 x (TT, LDH)
  __nv_bfloat16* full = hid + 2 * TT * LDH;          // (TT, f + PAD)
  const int ldf = a.f + PAD;

  cg::cluster_group cluster = cg::this_cluster();
  const int rank = (int)cluster.block_rank();
  const int CL = a.f / FS;
  const int grp = blockIdx.y, t0 = blockIdx.z * TT;
  const int e0 = grp * a.epg;
  const int ne = min(a.epg, a.E - e0);
  const int KC1 = a.d / BK, KC2 = a.f / BK;
  const int total = ne * (KC1 + KC2);

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int gid = lane >> 2, tig = lane & 3;
  const int wm = warp / L::WN, wn = warp % L::WN;
  const int r0 = wm * 16;                    // this warp's first row
  const int n1 = wn * (FS / L::WN);          // its first hidden column
  const int n2 = wn * (L::DS / L::WN);       // its first output column

  for (int s = 0; s < STAGES - 1; ++s)
    issue_chunk<TT, DSB>(a, s, total, e0, t0, rank, ring + s * L::STAGE);
  int c = 0;

  float acc[L::NT2][4];
#pragma unroll
  for (int nt = 0; nt < L::NT2; ++nt)
    acc[nt][0] = acc[nt][1] = acc[nt][2] = acc[nt][3] = 0.f;

  for (int ei = 0; ei < ne; ++ei) {
    const int e = e0 + ei;
    // ---- phase 1: this CTA's 64 hidden columns of expert e
    float hacc[L::NT1][4], gacc[L::NT1][4];
#pragma unroll
    for (int nt = 0; nt < L::NT1; ++nt) {
      hacc[nt][0] = hacc[nt][1] = hacc[nt][2] = hacc[nt][3] = 0.f;
      gacc[nt][0] = gacc[nt][1] = gacc[nt][2] = gacc[nt][3] = 0.f;
    }
    for (int j = 0; j < KC1; ++j, ++c) {
      cp_async_wait<STAGES - 2>();
      __syncthreads();                       // chunk c has landed
      issue_chunk<TT, DSB>(a, c + STAGES - 1, total, e0, t0, rank,
                           ring + ((c + STAGES - 1) % STAGES) * L::STAGE);
      const __nv_bfloat16* xs = ring + (c % STAGES) * L::STAGE;
      const __nv_bfloat16* wis = xs + TT * LD1;
      const __nv_bfloat16* wgs = wis + BK * LD1;
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk) {
        uint32_t af[4];
        load_a(af, xs, LD1, r0, kk * 16);
        mma_row<L::NT1>(hacc, af, wis, LD1, kk * 16, n1);
        if (!a.gelu) mma_row<L::NT1>(gacc, af, wgs, LD1, kk * 16, n1);
      }
    }
    __nv_bfloat16* mine = hid + (ei & 1) * TT * LDH;
#pragma unroll
    for (int nt = 0; nt < L::NT1; ++nt) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        float v[2];
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          const float hv = hacc[nt][2 * h + i];
          if (a.gelu) {
            v[i] = gelu_tanh(hv);
          } else {
            const float g = gacc[nt][2 * h + i];
            v[i] = g / (1.f + expf(-g)) * hv;
          }
        }
        *reinterpret_cast<__nv_bfloat162*>(
            mine + (r0 + gid + 8 * h) * LDH + n1 + nt * 8 + tig * 2) =
            __floats2bfloat162_rn(v[0], v[1]);
      }
    }
    // every CTA of the cluster has its slice of expert e's hidden; the
    // barrier also means each finished reading slice ei - 1's buffer pair
    cluster.sync();
    for (int i = threadIdx.x; i < CL * TT * (FS / 8); i += THREADS) {
      const int q = i / (TT * (FS / 8));
      const int rem = i - q * TT * (FS / 8);
      const int r = rem / (FS / 8), k = rem - r * (FS / 8);
      const __nv_bfloat16* peer = cluster.map_shared_rank(mine, q);
      *reinterpret_cast<uint4*>(full + r * ldf + q * FS + k * 8) =
          *reinterpret_cast<const uint4*>(peer + r * LDH + k * 8);
    }
    __syncthreads();
    // ---- phase 2: this CTA's output columns of hidden x wo_e
    float ye[L::NT2][4];
#pragma unroll
    for (int nt = 0; nt < L::NT2; ++nt)
      ye[nt][0] = ye[nt][1] = ye[nt][2] = ye[nt][3] = 0.f;
    for (int j = 0; j < KC2; ++j, ++c) {
      cp_async_wait<STAGES - 2>();
      __syncthreads();
      issue_chunk<TT, DSB>(a, c + STAGES - 1, total, e0, t0, rank,
                           ring + ((c + STAGES - 1) % STAGES) * L::STAGE);
      const __nv_bfloat16* wos = ring + (c % STAGES) * L::STAGE;
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk) {
        uint32_t af[4];
        load_a(af, full, ldf, r0, j * BK + kk * 16);
        mma_row<L::NT2>(ye, af, wos, L::LD2, kk * 16, n2);
      }
    }
    float wr[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int t = t0 + r0 + gid + 8 * h;
      wr[h] = t < a.T ? a.w[(size_t)t * a.E + e] : 0.f;
    }
#pragma unroll
    for (int nt = 0; nt < L::NT2; ++nt)
#pragma unroll
      for (int i = 0; i < 4; ++i)
        acc[nt][i] = fmaf(ye[nt][i], wr[i >> 1], acc[nt][i]);
  }
  cp_async_wait<0>();
  // no CTA leaves while a peer may still read its hidden slices
  cluster.sync();

#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int t = t0 + r0 + gid + 8 * h;
    if (t >= a.T) continue;
    float* out = a.partial + ((size_t)grp * a.T + t) * a.d + rank * L::DS;
#pragma unroll
    for (int nt = 0; nt < L::NT2; ++nt)
      *reinterpret_cast<float2*>(out + n2 + nt * 8 + tig * 2) =
          make_float2(acc[nt][2 * h], acc[nt][2 * h + 1]);
  }
}

// y[i] = bf16(sum over g = 0 .. G-1, in order, of partial[g][i])
__global__ void __launch_bounds__(256)
    moe_reduce_kernel(const float* __restrict__ partial,
                      __nv_bfloat16* __restrict__ y, int G, size_t n) {
  const size_t i = ((size_t)blockIdx.x * 256 + threadIdx.x) * 4;
  if (i >= n) return;
  float4 s = *reinterpret_cast<const float4*>(partial + i);
  for (int g = 1; g < G; ++g) {
    const float4 p = *reinterpret_cast<const float4*>(partial + g * n + i);
    s.x += p.x;
    s.y += p.y;
    s.z += p.z;
    s.w += p.w;
  }
  __nv_bfloat162* out = reinterpret_cast<__nv_bfloat162*>(y + i);
  out[0] = __floats2bfloat162_rn(s.x, s.y);
  out[1] = __floats2bfloat162_rn(s.z, s.w);
}

template <int TT, int DSB>
int launch(const Args& a, int G, cudaStream_t st) {
  using L = Tile<TT, DSB>;
  const size_t smem = L::smem_bytes(a.f);
  cudaError_t err = cudaFuncSetAttribute(
      moe_dense_kernel<TT, DSB>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  const int CL = a.f / FS;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(CL, G, (a.T + TT - 1) / TT);
  cfg.blockDim = dim3(THREADS);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = st;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = CL;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, moe_dense_kernel<TT, DSB>, a);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

template <int TT>
int launch_tt(const Args& a, int G, int dsb, cudaStream_t st) {
  switch (dsb) {
    case 1: return launch<TT, 1>(a, G, st);
    case 2: return launch<TT, 2>(a, G, st);
    case 3: return launch<TT, 3>(a, G, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// x (T, d) bf16, w (T, E) f32, wi/wg (E, d, f) bf16, wo (E, f, d) bf16,
// y (T, d) bf16, partial (ceil(E / epg), T, d) f32 scratch; all
// contiguous and 16-byte aligned.  f a multiple of 64 up to 512;
// d / (f / 64) a multiple of 64 up to 192.  act_gelu 0: swiglu, 1: gelu.
extern "C" int moe_dense(const void* x, const void* w, const void* wi,
                         const void* wg, const void* wo, void* y,
                         void* partial, int T, int d, int E, int f,
                         int act_gelu, int epg, void* stream) {
  if (T < 1 || E < 1 || epg < 1 || f < FS || f % FS ||
      f / FS > MAX_CLUSTER)
    return (int)cudaErrorInvalidValue;
  const int CL = f / FS;
  if (d % (CL * 64)) return (int)cudaErrorInvalidValue;
  const int dsb = d / (CL * 64);
  const int G = (E + epg - 1) / epg;
  const int tt = T <= 16 ? 16 : 64;
  if (G > 65535 || (T + tt - 1) / tt > 65535)
    return (int)cudaErrorInvalidValue;
  const Args a{(const __nv_bfloat16*)x, (const float*)w,
               (const __nv_bfloat16*)wi, (const __nv_bfloat16*)wg,
               (const __nv_bfloat16*)wo, (float*)partial,
               T, d, E, f, act_gelu != 0, epg};
  const cudaStream_t st = (cudaStream_t)stream;
  const int rc = tt == 16 ? launch_tt<16>(a, G, dsb, st)
                          : launch_tt<64>(a, G, dsb, st);
  if (rc) return rc;
  const size_t n = (size_t)T * d;
  const size_t blocks = (n / 4 + 255) / 256;
  moe_reduce_kernel<<<(unsigned)blocks, 256, 0, st>>>(
      (const float*)partial, (__nv_bfloat16*)y, G, n);
  return (int)cudaGetLastError();
}
