// Mamba-2 chunked SSD (state-space duality) scan, hand-written for sm_90a:
// the sequence path of the ssm family's prefill.
//
// Replaces the TPU kernel K9: src/repro/kernels/ssd_scan.py, `_ssd_kernel`
// (pallas_call at ssd_scan.py:103).  Same function: x (B,S,H,P), dt (B,S,H)
// f32, A (H,) f32, B/C -> y (B,S,H,P) in x's dtype and the final state
// (B,H,N,P) f32, the state starting at zero.  Within a chunk of Q =
// min(chunk, S) steps, with dA = dt * A and every exponent below a sum of
// the dA terms between its two steps:
//
//   y[q]  = sum_{k <= q} (C[q] . B[k]) exp(dA over k+1..q) dt[k] x[k]
//         + exp(dA over 0..q) C[q] . h_c
//   S_c   = sum_k exp(dA after k) dt[k] B[k] x[k]^T,   T_c = sum of dA
//   h_c+1 = exp(T_c) h_c + S_c
//
// y is rounded once; everything else is f32.  Three things differ from the
// TPU kernel:
//   * the decay exponent is never the difference of two running sums: at
//     mamba2-370m's init dt*A reaches -85 a step and a 16-step sum some
//     -1360, where one f32 ulp is 1e-4, so such a difference carries that
//     absolute error into exponents that may be near 0.  Every exponent is
//     a sum of exactly the dA terms between k and q, as in the segment-sum
//     form of arXiv:2405.21060: the chunk is cut into 16-step segments;
//     within one segment the exponent is a direct sum (a table of them, the
//     lower triangle of each segment, built once a chunk); across segments
//     it is the prefix of q's segment up to q, the sums of whole segments
//     between (a 16x16 table) and the suffix of k's segment after k.  A
//     pair k > q is masked, never exponentiated;
//   * a ragged last chunk (S not a multiple of Q) is masked: rows past the
//     end read as zero dt and zero x, which is exactly the zero-dt padding
//     of the reference's jnp path, so any S is accepted (the Pallas kernel
//     asserts S % Q == 0);
//   * B and C are taken as (B,S,G,N), head h reading group h / (H/G), so the
//     group broadcast is never materialised.  G = H is the reference's
//     signature.
//
// Design.  On the TPU the chunk axis is a sequential grid dimension and the
// (H,N,P) state rides in VMEM scratch.  Here the chunks run in parallel, in
// two launches on the caller's stream (no host sync between them):
//
// 1. the state launch, one CTA per (row, chunk, head, 64 channels of P):
//    the chunk's state contribution S_c and its total T_c, into a scratch
//    buffer the wrapper allocates (B * chunks * H * (P N + 1) f32);
// 2. the output launch, one CTA per (row, chunk, head, PS channels of P;
//    PS = 32 or 64, `ssd_scan.ssd_plan`): the entering state h_c by the
//    recurrence above over the scratch of the earlier chunks, then y for
//    each 64-row query block; the last chunk's CTAs also write the final
//    state.  A tile's scores and weights are computed once and shared by
//    every channel of the CTA.
//
// bf16 inputs (the served path): every product is wgmma (sm90.cuh); a
// state CTA is two warpgroups (64 columns of N each), an output CTA four
// (one 64-row query block each).
//   * C B^T: bf16 operands, products exact;
//   * W x, (wk . x)^T B, C h: one operand is f32 (W = scores x decay x dt,
//     wk . x, h).  It is split into three bf16 parts (hi = bf16(v), then
//     bf16 of what each leaves), which hold v to ~2^-24, and each product
//     is issued once per part.  W and wk . x are built in registers as A
//     fragments (the score accumulator's own layout), h as three tiles.
//   * The tensor core's f32 accumulation truncates toward zero at every
//     k16 step: one accumulator over a product's whole k sits ~1 ulp below
//     the f64 result on average, 2-4x cuBLAS's error, and the 8-layer
//     logits check of the served stack (2e-2 against the plain path)
//     failed with it.  So every k16 step goes into a fresh accumulator
//     that the CUDA cores add to an f32 total, rounding to nearest, and
//     its three parts go in lo first, so that the small ones are summed
//     before the large one sets the truncation point (hi first keeps the
//     bias): each stage then sums about as close to its f64 value as
//     cuBLAS's f32 does (`tools/ssd_stage_precision.py`, PERF.md §6).
// f32 inputs (the tests' second type) run a second kernel: the CUDA-core
// body of the same two launches, every sum an f32 FMA chain; its own
// instantiation, never a fallback of the bf16 path.
//
// What bounds it on the H100: operations.  One chunk of one head needs
// 2Q^2 N + 2Q^2 P + 4QNP flops (the causal half of the first two), ~45
// MFLOP at Q = 256, N = 128, P = 64, against ~110 KB of bf16 inputs.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "sm90.cuh"

namespace {

using sm90::Wgmma;

constexpr int THREADS = 256;   // a state CTA, an f32 output CTA
constexpr int OUT_THREADS = 512;   // a bf16 output CTA: a warpgroup a block
constexpr int NWARPS = THREADS / 32;
constexpr int TB = 64;         // rows of a query or key block
constexpr int MAX_Q = 256;     // the in-block scan covers one chunk
constexpr int SEG = 16;        // steps of a decay segment
constexpr int NSEG = MAX_Q / SEG;
constexpr int TRI = SEG * (SEG - 1) / 2;   // lower triangle of a segment
constexpr int MAX_N = 128;
constexpr int PX = 64;         // channels of a state CTA (and of f32 output)

struct Args {
  const void *x, *Bm, *Cm;
  const float *dt, *A;
  void* y;
  float *hout, *st, *tot;   // final state; scratch: chunk states, totals
  int S, H, P, G, N, Q, nc;
  bool vec_bc, vec_x;       // 16-byte loads allowed
};

// The decay tables of one chunk (dA = dt * A, zero past its end).
struct Decay {
  float cl[MAX_Q];       // sum of dA up to k in k's segment
  float rem[MAX_Q];      // sum of dA after k in k's segment
  float dtv[MAX_Q];      // dt of the chunk
  float wk[MAX_Q];       // exp(dA after k in the chunk) dt[k]
  float between[NSEG * NSEG];   // sums of the segments strictly between
  float before[NSEG];    // sum of the segments before
  float after[NSEG];     // sum of the segments after
  float tot[NSEG];       // sum of a segment
};

// Threads 0 .. MAX_Q-1 one step each (blockDim.x >= MAX_Q).  With
// `within`, also the direct sums inside each segment: within[s TRI + i (i
// - 1) / 2 + j] = dA over steps j+1 .. i of segment s (j < i), summed in
// step order.  Ends in a block barrier.
__device__ void chunk_decay(Decay& d, float* within, const float* dtb, int H,
                            int L, float a) {
  const int tid = threadIdx.x;
  const bool mine = tid < MAX_Q;
  if (mine) {
    const float v = tid < L ? dtb[(size_t)tid * H] : 0.f;
    d.dtv[tid] = v;
    d.cl[tid] = v * a;
  }
  __syncthreads();
  if (mine) d.rem[tid] = tid % SEG < SEG - 1 ? d.cl[tid + 1] : 0.f;
  // per segment: an inclusive prefix scan of cl and a suffix scan of rem
  for (int off = 1; off < SEG; off <<= 1) {
    __syncthreads();
    float t = 0.f, u = 0.f;
    if (mine) {
      t = (tid % SEG) >= off ? d.cl[tid - off] : 0.f;
      u = (tid % SEG) + off < SEG ? d.rem[tid + off] : 0.f;
    }
    __syncthreads();
    if (mine) {
      d.cl[tid] += t;
      d.rem[tid] += u;
    }
  }
  __syncthreads();
  if (tid < NSEG) d.tot[tid] = d.cl[tid * SEG + SEG - 1];
  __syncthreads();      // every segment's sum before any is read
  if (mine) {
    const int s1 = tid / NSEG, s2 = tid % NSEG;
    float acc = 0.f;
    for (int s = s1 + 1; s < s2; ++s) acc += d.tot[s];
    d.between[s1 * NSEG + s2] = acc;
    if (tid < NSEG) {
      float bs = 0.f, as = 0.f;
      for (int s = 0; s < tid; ++s) bs += d.tot[s];
      for (int s = tid + 1; s < NSEG; ++s) as += d.tot[s];
      d.before[tid] = bs;
      d.after[tid] = as;
    }
  }
  if (within) {
    for (int e = tid; e < NSEG * SEG * SEG; e += blockDim.x) {
      const int s = e / (SEG * SEG), i = (e / SEG) % SEG, j = e % SEG;
      if (j >= i) continue;
      float acc = 0.f;
      for (int m = j + 1; m <= i; ++m) acc += d.dtv[s * SEG + m] * a;
      within[s * TRI + i * (i - 1) / 2 + j] = acc;
    }
  }
  __syncthreads();
  if (mine)
    d.wk[tid] = tid < L ? expf(d.rem[tid] + d.after[tid / SEG]) * d.dtv[tid]
                        : 0.f;
  __syncthreads();
}

// the chunk's sum of dA (after chunk_decay)
__device__ __forceinline__ float chunk_total(const Decay& d) {
  return d.before[NSEG - 1] + d.tot[NSEG - 1];
}

// dA over steps k+1 .. q of the chunk, k <= q: a sum of exactly those terms
__device__ __forceinline__ float decay_exponent(const Decay& d,
                                                const float* within, int q,
                                                int k) {
  const int sq = q / SEG, sk = k / SEG;
  if (sq == sk) {
    const int i = q % SEG, j = k % SEG;
    return i == j ? 0.f : within[sq * TRI + i * (i - 1) / 2 + j];
  }
  return d.cl[q] + d.between[sk * NSEG + sq] + d.rem[k];
}

// the (row, chunk, head) of a CTA and its bases
struct Item {
  int b, c, h, c0, L, p0, g;
  size_t item;          // (b * nc + c) * H + h: the scratch's index
};

__device__ __forceinline__ Item item_of(const Args& a, int ps) {
  Item it;
  it.h = blockIdx.y;
  it.b = blockIdx.z / a.nc;
  it.c = blockIdx.z % a.nc;
  it.c0 = it.c * a.Q;
  it.L = min(a.Q, a.S - it.c0);
  it.p0 = blockIdx.x * ps;
  it.g = it.h / (a.H / a.G);
  it.item = ((size_t)it.b * a.nc + it.c) * a.H + it.h;
  return it;
}

// h_c of this CTA's channels, (n, p) for n < N, p < PS, by the recurrence
// h = fmaf(exp(T_j), h, S_j) over the earlier chunks j from h = 0, handed
// to `put(n, p, h)` (0 past P); the last chunk also writes the final state
// fmaf(exp(T_c), h_c, S_c)
template <typename Put>
__device__ void entering_state(const Args& a, const Item& it, int ps,
                               Put put) {
  const size_t first = (size_t)it.b * a.nc * a.H + it.h;   // item (b, 0, h)
  const size_t step = (size_t)a.H * a.P * a.N;
  const float* stp = a.st + first * a.P * a.N;
  const bool last_chunk = it.c == a.nc - 1;
  for (int e = threadIdx.x; e < a.N * ps; e += blockDim.x) {
    const int n = e / ps, pe = e % ps, pp = it.p0 + pe;
    float hv = 0.f;
    if (pp < a.P) {
      const size_t off = (size_t)pp * a.N + n;
      for (int j = 0; j < it.c; ++j)
        hv = fmaf(expf(a.tot[first + (size_t)j * a.H]), hv,
                  stp[(size_t)j * step + off]);
      if (last_chunk)
        a.hout[(((size_t)it.b * a.H + it.h) * a.N + n) * a.P + pp] =
            fmaf(expf(a.tot[first + (size_t)it.c * a.H]), hv,
                 stp[(size_t)it.c * step + off]);
    }
    put(n, pe, hv);
  }
}

// =================================================== bf16: wgmma products

__device__ __forceinline__ uint8_t* align1024(unsigned char* p) {
  return reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(p) + 1023) & ~uintptr_t(1023));
}

__device__ __forceinline__ __nv_bfloat16 bf(const uint8_t* tile,
                                            uint32_t off) {
  return *reinterpret_cast<const __nv_bfloat16*>(tile + off);
}

// the bf16 pair of (v0, v1), leaving in them what it does not hold (exact
// in f32); three calls give hi = bf16(v), mid = bf16(v - hi) and lo =
// bf16(v - hi - mid)
__device__ __forceinline__ uint32_t bf16_pair(float& v0, float& v1) {
  const __nv_bfloat162 p = __floats2bfloat162_rn(v0, v1);
  const float2 pf = __bfloat1622float2(p);
  v0 -= pf.x;
  v1 -= pf.y;
  return *reinterpret_cast<const uint32_t*>(&p);
}

__device__ __forceinline__ void split3(float v0, float v1, uint32_t& hi,
                                       uint32_t& mid, uint32_t& lo) {
  hi = bf16_pair(v0, v1);
  mid = bf16_pair(v0, v1);
  lo = bf16_pair(v0, v1);
}

// rows [0, rows) x columns [0, cols) of a bf16 tile of R rows (sm90.cuh's
// layout, SPAN), element (r, c) = src[r * stride + c] for r < L and c <
// ncols, else 0.  cols is a multiple of 8; with `vec` (16-byte aligned
// rows) whole 8-column groups load as one 16-byte vector, UNROLL of them
// in flight before their stores.
template <int SPAN>
__device__ void load_tile(uint8_t* tile, int R, const __nv_bfloat16* src,
                          size_t stride, int L, int ncols, int rows, int cols,
                          bool vec) {
  constexpr int UNROLL = 4;
  const int groups = cols / 8, total = rows * groups;
  for (int e0 = threadIdx.x; e0 < total; e0 += UNROLL * blockDim.x) {
    uint4 v[UNROLL];
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      const int e = e0 + u * blockDim.x;
      const int r = e / groups, c = (e % groups) * 8;
      v[u] = make_uint4(0u, 0u, 0u, 0u);
      if (e < total && r < L) {
        const __nv_bfloat16* p = src + (size_t)r * stride + c;
        if (vec && c + 8 <= ncols) {
          v[u] = *reinterpret_cast<const uint4*>(p);
        } else {
          __nv_bfloat16* t = reinterpret_cast<__nv_bfloat16*>(&v[u]);
          for (int i = 0; i < 8 && c + i < ncols; ++i) t[i] = p[i];
        }
      }
    }
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      const int e = e0 + u * blockDim.x;
      if (e < total)
        *reinterpret_cast<uint4*>(
            tile + sm90::tile_offset<SPAN>(R, e / groups, (e % groups) * 8)) =
            v[u];
    }
  }
}

template <int R>
__device__ __forceinline__ void zero(float (&d)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) d[i] = 0.f;
}

template <int R>
__device__ __forceinline__ void add(float (&to)[R], const float (&d)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) to[i] += d[i];
}

template <int NT>
struct StateLayout {
  static constexpr int SPAN_N = NT == 32 ? 64 : 128;
  static constexpr int B_BYTES = MAX_Q * NT * 2;
  static constexpr int X_BYTES = MAX_Q * PX * 2;
  static constexpr int SMEM = B_BYTES + X_BYTES + sizeof(Decay) + 1024;
};

// Launch 1: S_c^T = (wk . x)^T B for 64 channels of P (rows) and N
// (columns: NT, N padded to 32, 64 or 128; a warpgroup owns 64 of them).
template <int NT>
__global__ void __launch_bounds__(THREADS) ssd_state_wgmma(const Args a) {
  using L = StateLayout<NT>;
  constexpr int NW = NT > 64 ? 64 : NT;      // columns a warpgroup owns
  extern __shared__ unsigned char smem_raw[];
  uint8_t* btile = align1024(smem_raw);       // (MAX_Q, NT) B of the chunk
  uint8_t* xtile = btile + L::B_BYTES;        // (MAX_Q, PX) x of the chunk
  Decay& d = *reinterpret_cast<Decay*>(xtile + L::X_BYTES);

  const Item it = item_of(a, PX);
  const int tid = threadIdx.x;
  const int rows = (it.L + TB - 1) / TB * TB;
  const size_t br = (size_t)a.G * a.N, xr = (size_t)a.H * a.P;
  load_tile<L::SPAN_N>(
      btile, MAX_Q,
      static_cast<const __nv_bfloat16*>(a.Bm) +
          ((size_t)it.b * a.S + it.c0) * br + (size_t)it.g * a.N,
      br, it.L, a.N, rows, NT, a.vec_bc);
  load_tile<128>(xtile, MAX_Q,
                 static_cast<const __nv_bfloat16*>(a.x) +
                     ((size_t)it.b * a.S + it.c0) * xr +
                     (size_t)it.h * a.P + it.p0,
                 xr, it.L, min(PX, a.P - it.p0), rows, PX, a.vec_x);
  chunk_decay(d, nullptr, a.dt + ((size_t)it.b * a.S + it.c0) * a.H + it.h,
              a.H, it.L, a.A[it.h]);
  sm90::fence_proxy_async();
  __syncthreads();
  if (tid == 0 && blockIdx.x == 0) a.tot[it.item] = chunk_total(d);

  const int wg = sm90::warp_uniform(tid / 128);
  if (wg * NW >= NT) return;
  const int w = (tid / 32) % 4, lane = tid % 32;
  const uint32_t bt = sm90::smem_u32(btile) + wg * MAX_Q * L::SPAN_N;
  float acc[NW / 2], part[NW / 2];
  zero(acc);
  for (int s = 0; s < (it.L + 15) / 16; ++s) {
    // the A fragment of (wk . x)^T for k16 step s: register r is row 16 w
    // + lane / 4 + 8 (r & 1), columns 16 s + 8 (r >> 1) + 2 (lane % 4) +
    // {0, 1}
    uint32_t f[3][4];
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int p = 16 * w + lane / 4 + 8 * (r & 1);
      const int k = 16 * s + 8 * (r >> 1) + 2 * (lane % 4);
      float v[2];
#pragma unroll
      for (int e = 0; e < 2; ++e)
        v[e] = d.wk[k + e] *
               __bfloat162float(
                   bf(xtile, sm90::tile_offset<128>(MAX_Q, k + e, p)));
      split3(v[0], v[1], f[0][r], f[1][r], f[2][r]);
    }
    const uint64_t db = sm90::desc_nmajor<L::SPAN_N>(bt, MAX_Q, s);
    sm90::fence_operand(part);
    sm90::wgmma_fence();
#pragma unroll
    for (int k = 2; k >= 0; --k)          // lo, mid, then hi
      Wgmma<NW>::template rs<1>(part, f[k], db, k < 2);
    sm90::wgmma_commit();
    sm90::wgmma_wait<0>();
    sm90::fence_operand(part);
    add(acc, part);
  }
  // acc[4j + 2hh + cc]: row 16 w + lane / 4 + 8 hh, column 8 j + 2 (lane %
  // 4) + cc of this warpgroup's columns
  float* out = a.st + it.item * a.P * a.N;
#pragma unroll
  for (int i = 0; i < NW / 2; ++i) {
    const int p = it.p0 + 16 * w + lane / 4 + 8 * ((i >> 1) & 1);
    const int n = wg * NW + 8 * (i >> 2) + 2 * (lane % 4) + (i & 1);
    if (p < a.P && n < a.N) out[(size_t)p * a.N + n] = acc[i];
  }
}

template <int PS, int NT>
struct OutLayout {
  static constexpr int SPAN_N = NT == 32 ? 64 : 128;
  static constexpr int SPAN_X = PS == 32 ? 64 : 128;
  static constexpr int BC_BYTES = MAX_Q * NT * 2;   // the C tile, the B tile
  static constexpr int X_BYTES = MAX_Q * PS * 2;
  static constexpr int H_BYTES = PS * NT * 2;       // h^T hi, mid, lo
  static constexpr int F_OFF = 2 * BC_BYTES + X_BYTES + 3 * H_BYTES;
  static constexpr int SMEM = F_OFF + NSEG * TRI * 4 + sizeof(Decay) + 1024;
};

// Launch 2: the entering state, then y for PS channels of P; warpgroup i
// the query block i (i + 1 tiles of scores).
template <int PS, int NT>
__global__ void __launch_bounds__(OUT_THREADS, 1)
    ssd_out_wgmma(const Args a) {
  using L = OutLayout<PS, NT>;
  extern __shared__ unsigned char smem_raw[];
  uint8_t* ctile = align1024(smem_raw);       // (MAX_Q, NT) C of the chunk
  uint8_t* btile = ctile + L::BC_BYTES;       // (MAX_Q, NT) B of the chunk
  uint8_t* xtile = btile + L::BC_BYTES;       // (MAX_Q, PS) x of the chunk
  uint8_t* htile = xtile + L::X_BYTES;        // 3 x (PS, NT) parts of h_c^T
  float* within = reinterpret_cast<float*>(ctile + L::F_OFF);
  Decay& d = *reinterpret_cast<Decay*>(within + NSEG * TRI);

  const Item it = item_of(a, PS);
  const int tid = threadIdx.x, len = it.L;
  const int rows = (len + TB - 1) / TB * TB;
  const size_t br = (size_t)a.G * a.N, xr = (size_t)a.H * a.P;
  const size_t bc = ((size_t)it.b * a.S + it.c0) * br + (size_t)it.g * a.N;
  load_tile<L::SPAN_N>(ctile, MAX_Q,
                       static_cast<const __nv_bfloat16*>(a.Cm) + bc, br, len,
                       a.N, rows, NT, a.vec_bc);
  load_tile<L::SPAN_N>(btile, MAX_Q,
                       static_cast<const __nv_bfloat16*>(a.Bm) + bc, br, len,
                       a.N, rows, NT, a.vec_bc);
  const size_t xbase = ((size_t)it.b * a.S + it.c0) * xr +
                       (size_t)it.h * a.P + it.p0;
  load_tile<L::SPAN_X>(xtile, MAX_Q,
                       static_cast<const __nv_bfloat16*>(a.x) + xbase, xr,
                       len, min(PS, a.P - it.p0), rows, PS, a.vec_x);
  const bool has_h = it.c > 0;
  if (has_h || it.c == a.nc - 1) {
    entering_state(a, it, PS, [&](int n, int p, float hv) {
      if (!has_h) return;
      uint32_t hi, mid, lo;
      split3(hv, 0.f, hi, mid, lo);
      const uint32_t off = sm90::tile_offset<L::SPAN_N>(PS, p, n);
      *reinterpret_cast<uint16_t*>(htile + off) = (uint16_t)hi;
      *reinterpret_cast<uint16_t*>(htile + L::H_BYTES + off) = (uint16_t)mid;
      *reinterpret_cast<uint16_t*>(htile + 2 * L::H_BYTES + off) =
          (uint16_t)lo;
    });
    if (has_h)      // h's padding columns N .. NT read as zero
      for (int e = tid; e < (NT - a.N) * PS; e += OUT_THREADS) {
        const uint32_t off = sm90::tile_offset<L::SPAN_N>(
            PS, e % PS, a.N + e / PS);
        for (int k = 0; k < 3; ++k)
          *reinterpret_cast<uint16_t*>(htile + k * L::H_BYTES + off) = 0;
      }
  }
  chunk_decay(d, within, a.dt + ((size_t)it.b * a.S + it.c0) * a.H + it.h,
              a.H, len, a.A[it.h]);
  sm90::fence_proxy_async();
  __syncthreads();

  const int wg = sm90::warp_uniform(tid / 128);
  const int w = (tid / 32) % 4, lane = tid % 32;
  const int nk = (a.N + 15) / 16;
  const uint32_t ct = sm90::smem_u32(ctile), bt = sm90::smem_u32(btile);
  const uint32_t xt = sm90::smem_u32(xtile), ht = sm90::smem_u32(htile);
  __nv_bfloat16* yb = static_cast<__nv_bfloat16*>(a.y) + xbase;
  const int qb = wg;                  // this warpgroup's query block
  if (qb * TB < len) {
    // this thread's two query rows: 64 qb + 16 w + lane / 4 + 8 hh
    int qrow[2];
#pragma unroll
    for (int hh = 0; hh < 2; ++hh)
      qrow[hh] = qb * TB + 16 * w + lane / 4 + 8 * hh;
    const uint32_t cq = ct + qb * TB * L::SPAN_N;
    // y; a tile's scores (later C h_c); one step's partial products (the
    // scores' or, as `part`, W x's and C h's): one register array each
    float y[PS / 2], sc[TB / 2], sp[TB / 2];
    float(&part)[PS / 2] = *reinterpret_cast<float(*)[PS / 2]>(&sp);
    zero(y);
    for (int kb = 0; kb <= qb; ++kb) {
      // scores C B^T of the tile, each k16 step summed apart
      zero(sc);
      for (int kk = 0; kk < nk; ++kk) {
        sm90::fence_operand(sp);
        sm90::wgmma_fence();
        Wgmma<TB>::ss(sp, sm90::desc_kmajor<L::SPAN_N>(cq, MAX_Q, kk),
                      sm90::desc_kmajor<L::SPAN_N>(bt + kb * TB * L::SPAN_N,
                                                   MAX_Q, kk),
                      0);
        sm90::wgmma_commit();
        sm90::wgmma_wait<0>();
        sm90::fence_operand(sp);
        add(sc, sp);
      }
      // W = scores x decay x dt[k], masked to k <= q < len; keys 16 s ..
      // 16 s + 15 are the score columns whose registers form k16 step s's
      // A fragment (register r: sc[8 s + 2 (r & 1) + 4 (r >> 1)], +1)
      const uint32_t xk = xt + kb * TB * L::SPAN_X;
#pragma unroll
      for (int s = 0; s < TB / 16; ++s) {
        uint32_t f[3][4];
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          const int src = 8 * s + 2 * (r & 1) + 4 * (r >> 1);
          const int q = qrow[r & 1];
          float v[2];
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int k = kb * TB + 16 * s + 8 * (r >> 1) + 2 * (lane % 4) + e;
            v[e] = (k <= q && q < len)
                       ? sc[src + e] * expf(decay_exponent(d, within, q, k)) *
                             d.dtv[k]
                       : 0.f;
          }
          split3(v[0], v[1], f[0][r], f[1][r], f[2][r]);
        }
        const uint64_t db = sm90::desc_nmajor<L::SPAN_X>(xk, MAX_Q, s);
        sm90::fence_operand(part);
        sm90::wgmma_fence();
#pragma unroll
        for (int k = 2; k >= 0; --k)      // lo, mid, then hi
          Wgmma<PS>::template rs<1>(part, f[k], db, k < 2);
        sm90::wgmma_commit();
        sm90::wgmma_wait<0>();
        sm90::fence_operand(part);
        add(y, part);
      }
    }
    // the carried state's contribution C h_c, each k16 step summed apart,
    // then y = fmaf(exp(dA over 0..q), C h_c, W x), rounded once
    float(&ch)[PS / 2] = *reinterpret_cast<float(*)[PS / 2]>(&sc);
    zero(ch);
    if (has_h) {
      for (int kk = 0; kk < nk; ++kk) {
        const uint64_t da = sm90::desc_kmajor<L::SPAN_N>(cq, MAX_Q, kk);
        sm90::fence_operand(part);
        sm90::wgmma_fence();
#pragma unroll
        for (int k = 2; k >= 0; --k)      // lo, mid, then hi
          Wgmma<PS>::ss(part, da,
                        sm90::desc_kmajor<L::SPAN_N>(ht + k * L::H_BYTES, PS,
                                                     kk),
                        k < 2);
        sm90::wgmma_commit();
        sm90::wgmma_wait<0>();
        sm90::fence_operand(part);
        add(ch, part);
      }
    }
    float e[2];
#pragma unroll
    for (int hh = 0; hh < 2; ++hh)
      e[hh] = expf(d.before[qrow[hh] / SEG] + d.cl[qrow[hh]]);
    // y[4j + 2hh + cc]: row qrow[hh], channel 8 j + 2 (lane % 4) + cc
#pragma unroll
    for (int i = 0; i < PS / 2; ++i) {
      const int q = qrow[(i >> 1) & 1];
      const int p = 8 * (i >> 2) + 2 * (lane % 4) + (i & 1);
      if (q < len && it.p0 + p < a.P)
        yb[(size_t)q * xr + p] =
            __float2bfloat16_rn(fmaf(e[(i >> 1) & 1], ch[i], y[i]));
    }
  }
}

// ============================================= f32: FMA chains, CUDA cores

constexpr int LD = TB + 4;     // padded row of the [n][row] tiles (16-B aligned)

// a 64-row block of B or C, rows [r0, r0 + 64) of the chunk, into dst as
// [n][row]; rows at or past L read as zero.  With `vec` (N a multiple of
// 4, 16-byte aligned rows) each thread first issues all of its 16-byte
// loads, then stores them: a warp covers one vector of 32 consecutive
// rows, so its stores hit 32 distinct banks.  Otherwise one element per
// thread and pass, each warp pass covering 8 n x 4 rows.
__device__ void load_rows(float* dst, const float* src, size_t row_stride,
                          int r0, int L, int N, bool vec) {
  if (vec) {
    constexpr int MAXIT = TB * MAX_N / 4 / THREADS;
    const int total = TB * (N / 4);
    float4 v[MAXIT];
#pragma unroll
    for (int j = 0; j < MAXIT; ++j) {
      const int idx = threadIdx.x + j * THREADS;
      const int ri = idx % TB, c = idx / TB;
      v[j] = (idx < total && r0 + ri < L)
                 ? *reinterpret_cast<const float4*>(
                       src + (size_t)(r0 + ri) * row_stride + c * 4)
                 : make_float4(0.f, 0.f, 0.f, 0.f);
    }
#pragma unroll
    for (int j = 0; j < MAXIT; ++j) {
      const int idx = threadIdx.x + j * THREADS;
      if (idx < total) {
        const int ri = idx % TB, c = idx / TB;
        dst[(c * 4 + 0) * LD + ri] = v[j].x;
        dst[(c * 4 + 1) * LD + ri] = v[j].y;
        dst[(c * 4 + 2) * LD + ri] = v[j].z;
        dst[(c * 4 + 3) * LD + ri] = v[j].w;
      }
    }
    return;
  }
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int tiles = ((N + 7) / 8) * (TB / 4);
  for (int t = warp; t < tiles; t += NWARPS) {
    const int n = (t / (TB / 4)) * 8 + (lane & 7);
    const int ri = (t % (TB / 4)) * 4 + (lane >> 3);
    if (n < N) {
      const int r = r0 + ri;
      dst[n * LD + ri] = r < L ? src[(size_t)r * row_stride + n] : 0.f;
    }
  }
}

// the 64 x PX block of x, rows [r0, r0 + 64) of the chunk and this CTA's
// channels (pmax of them real, the rest zero), into xs transposed as
// [p][row] (row stride LD), so that a thread reads four rows of a channel
// as one float4; 16-byte global loads with `vec` (P a multiple of 16,
// aligned rows)
__device__ void load_x(float* xs, const float* xb, size_t row_stride, int r0,
                       int L, int pmax, bool vec) {
  if (vec) {
    constexpr int CPR = PX / 4;
    for (int e = threadIdx.x; e < TB * CPR; e += THREADS) {
      const int ki = e % TB, c = e / TB, k = r0 + ki;
      const float4 v = k < L && c * 4 < pmax
                           ? *reinterpret_cast<const float4*>(
                                 xb + (size_t)k * row_stride + c * 4)
                           : make_float4(0.f, 0.f, 0.f, 0.f);
      xs[(c * 4 + 0) * LD + ki] = v.x;
      xs[(c * 4 + 1) * LD + ki] = v.y;
      xs[(c * 4 + 2) * LD + ki] = v.z;
      xs[(c * 4 + 3) * LD + ki] = v.w;
    }
    return;
  }
  for (int e = threadIdx.x; e < TB * PX; e += THREADS) {
    const int ki = e % TB, pe = e / TB, k = r0 + ki;
    xs[pe * LD + ki] =
        (k < L && pe < pmax) ? xb[(size_t)k * row_stride + pe] : 0.f;
  }
}

size_t state_fma_smem(int N) {
  return sizeof(Decay) + ((size_t)N * LD + PX * LD) * 4;
}

// Launch 1: S_c for PX channels and all N state rows.  Thread (r, p) owns
// rows r + 16 j and channels p + 16 s; each sum runs over k ascending, B
// times x * wk.
__global__ void __launch_bounds__(THREADS) ssd_state_fma(const Args a) {
  extern __shared__ __align__(16) float sm[];
  Decay& d = *reinterpret_cast<Decay*>(sm);
  float* Bs = reinterpret_cast<float*>(&d + 1);   // (N, LD) key block of B
  float* xs = Bs + a.N * LD;                      // (PX, LD) key block of x

  const Item it = item_of(a, PX);
  const int tid = threadIdx.x, r = tid / 16, p = tid % 16;
  const size_t xr = (size_t)a.H * a.P, br = (size_t)a.G * a.N;
  const float* xb = static_cast<const float*>(a.x) +
                    ((size_t)it.b * a.S + it.c0) * xr + (size_t)it.h * a.P +
                    it.p0;
  const float* Bb = static_cast<const float*>(a.Bm) +
                    ((size_t)it.b * a.S + it.c0) * br + (size_t)it.g * a.N;
  chunk_decay(d, nullptr, a.dt + ((size_t)it.b * a.S + it.c0) * a.H + it.h,
              a.H, it.L, a.A[it.h]);
  if (tid == 0 && blockIdx.x == 0) a.tot[it.item] = chunk_total(d);

  float hacc[MAX_N / 16][PX / 16];
#pragma unroll
  for (int j = 0; j < MAX_N / 16; ++j)
#pragma unroll
    for (int s = 0; s < PX / 16; ++s) hacc[j][s] = 0.f;
  const int nb = (it.L + TB - 1) / TB;
  for (int kb = 0; kb < nb; ++kb) {
    load_rows(Bs, Bb, br, kb * TB, it.L, a.N, a.vec_bc);
    load_x(xs, xb, xr, kb * TB, it.L, a.P - it.p0, a.vec_x);
    __syncthreads();
    // four k at a time, each sum still in k order
    for (int k4 = 0; k4 < TB; k4 += 4) {
      const float4 w4 = *reinterpret_cast<const float4*>(d.wk + kb * TB + k4);
      float4 b4[MAX_N / 16];
#pragma unroll
      for (int j = 0; j < MAX_N / 16; ++j)
        if (r + 16 * j < a.N)
          b4[j] = *reinterpret_cast<const float4*>(Bs + (r + 16 * j) * LD +
                                                   k4);
#pragma unroll
      for (int s = 0; s < PX / 16; ++s) {
        const float4 x4 =
            *reinterpret_cast<const float4*>(xs + (16 * s + p) * LD + k4);
        const float xw[4] = {x4.x * w4.x, x4.y * w4.y, x4.z * w4.z,
                             x4.w * w4.w};
#pragma unroll
        for (int j = 0; j < MAX_N / 16; ++j) {
          if (r + 16 * j >= a.N) continue;
          hacc[j][s] = fmaf(b4[j].x, xw[0], hacc[j][s]);
          hacc[j][s] = fmaf(b4[j].y, xw[1], hacc[j][s]);
          hacc[j][s] = fmaf(b4[j].z, xw[2], hacc[j][s]);
          hacc[j][s] = fmaf(b4[j].w, xw[3], hacc[j][s]);
        }
      }
    }
    __syncthreads();
  }
  float* out = a.st + it.item * a.P * a.N;
#pragma unroll
  for (int s = 0; s < PX / 16; ++s) {
    const int pp = it.p0 + 16 * s + p;
#pragma unroll
    for (int j = 0; j < MAX_N / 16; ++j) {
      const int n = r + 16 * j;
      if (n < a.N && pp < a.P) out[(size_t)pp * a.N + n] = hacc[j][s];
    }
  }
}

size_t out_fma_smem(int N) {
  return sizeof(Decay) + NSEG * TRI * 4 +
         (2 * (size_t)N * LD + PX * LD + TB * LD + (size_t)N * PX) * 4;
}

// Launch 2: the entering state, then y for PX channels.  The weights of a
// (query block, key block) tile are computed once and shared by the
// channels; thread (r, p) accumulates rows r + 16 j of channels p + 16 s,
// each over k ascending.
__global__ void __launch_bounds__(THREADS) ssd_out_fma(const Args a) {
  constexpr int NS = PX / 16;            // channels a thread owns
  extern __shared__ __align__(16) float sm[];
  Decay& d = *reinterpret_cast<Decay*>(sm);
  float* within = reinterpret_cast<float*>(&d + 1);   // (NSEG * TRI)
  float* Cs = within + NSEG * TRI;                // (N, LD) query block of C
  float* Bs = Cs + a.N * LD;                      // (N, LD) key block of B
  float* xs = Bs + a.N * LD;                      // (PX, LD) key block of x
  float* Ws = xs + PX * LD;                       // (TB, LD) weights of the pair
  float* hs = Ws + TB * LD;                       // (N, PX) entering state

  const Item it = item_of(a, PX);
  const int tid = threadIdx.x;
  const int ty = tid / 16, tx = tid % 16;         // a 4x4 tile of scores
  const int r = tid / 16, p = tid % 16;           // rows r + 16 j, channel p
  const size_t xr = (size_t)a.H * a.P, br = (size_t)a.G * a.N;
  const size_t base = ((size_t)it.b * a.S + it.c0) * xr + (size_t)it.h * a.P +
                      it.p0;
  const float* xb = static_cast<const float*>(a.x) + base;
  float* yb = static_cast<float*>(a.y) + base;
  const size_t bc = ((size_t)it.b * a.S + it.c0) * br + (size_t)it.g * a.N;
  const float* Bb = static_cast<const float*>(a.Bm) + bc;
  const float* Cb = static_cast<const float*>(a.Cm) + bc;

  entering_state(a, it, PX, [&](int n, int pe, float hv) {
    hs[n * PX + pe] = hv;
  });
  chunk_decay(d, within, a.dt + ((size_t)it.b * a.S + it.c0) * a.H + it.h,
              a.H, it.L, a.A[it.h]);

  const int L = it.L, nb = (L + TB - 1) / TB;
  for (int qb = 0; qb < nb; ++qb) {
    load_rows(Cs, Cb, br, qb * TB, L, a.N, a.vec_bc);
    float yacc[NS][4];
#pragma unroll
    for (int s = 0; s < NS; ++s)
#pragma unroll
      for (int j = 0; j < 4; ++j) yacc[s][j] = 0.f;

    for (int kb = 0; kb <= qb; ++kb) {
      load_rows(Bs, Bb, br, kb * TB, L, a.N, a.vec_bc);
      load_x(xs, xb, xr, kb * TB, L, a.P - it.p0, a.vec_x);
      __syncthreads();

      // scores C[q] . B[k] for the 4x4 tile, then the masked weights
      float s4[4][4] = {};
#pragma unroll 4
      for (int n = 0; n < a.N; ++n) {
        const float4 cv =
            *reinterpret_cast<const float4*>(Cs + n * LD + ty * 4);
        const float4 bv =
            *reinterpret_cast<const float4*>(Bs + n * LD + tx * 4);
        const float c4[4] = {cv.x, cv.y, cv.z, cv.w};
        const float b4[4] = {bv.x, bv.y, bv.z, bv.w};
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) s4[i][j] = fmaf(c4[i], b4[j], s4[i][j]);
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int q = qb * TB + ty * 4 + i;
        float w[4];
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int k = kb * TB + tx * 4 + j;
          w[j] = q < L && k <= q
                     ? s4[i][j] * expf(decay_exponent(d, within, q, k)) *
                           d.dtv[k]
                     : 0.f;
        }
        *reinterpret_cast<float4*>(Ws + (ty * 4 + i) * LD + tx * 4) =
            make_float4(w[0], w[1], w[2], w[3]);
      }
      __syncthreads();

      // y strip += W x, each channel's chain over k ascending, four k at
      // a time
      for (int k4 = 0; k4 < TB; k4 += 4) {
        float4 w4[4];
#pragma unroll
        for (int j = 0; j < 4; ++j)
          w4[j] = *reinterpret_cast<const float4*>(Ws + (r + 16 * j) * LD +
                                                   k4);
#pragma unroll
        for (int s = 0; s < NS; ++s) {
          const float4 x4 =
              *reinterpret_cast<const float4*>(xs + (16 * s + p) * LD + k4);
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            yacc[s][j] = fmaf(w4[j].x, x4.x, yacc[s][j]);
            yacc[s][j] = fmaf(w4[j].y, x4.y, yacc[s][j]);
            yacc[s][j] = fmaf(w4[j].z, x4.z, yacc[s][j]);
            yacc[s][j] = fmaf(w4[j].w, x4.w, yacc[s][j]);
          }
        }
      }
      __syncthreads();
    }

    // the carried state's contribution, then y
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int qi = r + 16 * j, q = qb * TB + qi;
      if (q >= L) continue;
      const float e = expf(d.before[q / SEG] + d.cl[q]);
#pragma unroll
      for (int s = 0; s < NS; ++s) {
        const int pe = 16 * s + p;
        float acc = 0.f;
        for (int n = 0; n < a.N; ++n)
          acc = fmaf(Cs[n * LD + qi], hs[n * PX + pe], acc);
        if (it.p0 + pe < a.P) yb[(size_t)q * xr + pe] = fmaf(e, acc, yacc[s][j]);
      }
    }
    __syncthreads();
  }
}

// ================================================================ launch

template <typename K>
cudaError_t allow_smem(K kernel, int bytes, int& set) {
  if (bytes <= set) return cudaSuccess;
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err == cudaSuccess) set = bytes;
  return err;
}

template <typename K1, typename K2>
int launch2(K1 state, int sm1, K2 out, int sm2, int& set1, int& set2,
            const Args& a, int Bsz, int ps, int out_threads,
            cudaStream_t st) {
  cudaError_t err = allow_smem(state, sm1, set1);
  if (err == cudaSuccess) err = allow_smem(out, sm2, set2);
  if (err != cudaSuccess) return (int)err;
  const unsigned items = (unsigned)(Bsz * a.nc);
  state<<<dim3((a.P + PX - 1) / PX, a.H, items), THREADS, sm1, st>>>(a);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  out<<<dim3((a.P + ps - 1) / ps, a.H, items), out_threads, sm2, st>>>(a);
  return (int)cudaGetLastError();
}

template <int PS, int NT>
int launch_wgmma(const Args& a, int Bsz, cudaStream_t st) {
  static int set1 = 0, set2 = 0;
  return launch2(ssd_state_wgmma<NT>, StateLayout<NT>::SMEM,
                 ssd_out_wgmma<PS, NT>, OutLayout<PS, NT>::SMEM, set1, set2,
                 a, Bsz, PS, OUT_THREADS, st);
}

}  // namespace

// x (B,S,H,P), B/C (B,S,G,N) and y (B,S,H,P): contiguous, bf16 (is_f32 = 0)
// or f32 (is_f32 = 1); dt (B,S,H) and A (H,) f32; hout (B,H,N,P) f32;
// scratch B * chunks * H * (P N + 1) f32.  Q = min(chunk, S) <= 256, N <=
// 128, G divides H.  bf16: the wgmma kernels, p_tile (32 or 64,
// `ssd_scan.ssd_plan`) channels of P an output CTA owns; f32: the
// CUDA-core kernels, 64 channels (p_tile unused).
extern "C" int ssd_scan(const void* x, const void* dt, const void* A,
                        const void* Bm, const void* Cm, void* y, void* hout,
                        void* scratch, int Bsz, int S, int H, int P, int G,
                        int N, int Q, int p_tile, int is_f32, void* stream) {
  if (Bsz < 1 || S < 1 || H < 1 || P < 1 || G < 1 || H % G || N < 1 ||
      N > MAX_N || Q < 1 || Q > MAX_Q || H > 65535 ||
      !(is_f32 || p_tile == 32 || p_tile == 64))
    return (int)cudaErrorInvalidValue;
  const int nc = (S + Q - 1) / Q;
  if ((long long)Bsz * nc > 65535) return (int)cudaErrorInvalidValue;
  const auto aligned = [](const void* p) {
    return reinterpret_cast<uintptr_t>(p) % 16 == 0;
  };
  const int vec = is_f32 ? 4 : 8;        // elements of a 16-byte load
  float* stp = (float*)scratch;
  const Args a{x, Bm, Cm, (const float*)dt, (const float*)A, y,
               (float*)hout, stp, stp + (size_t)Bsz * nc * H * P * N,
               S, H, P, G, N, Q, nc,
               N % vec == 0 && aligned(Bm) && aligned(Cm),
               P % vec == 0 && aligned(x)};
  const cudaStream_t st = (cudaStream_t)stream;
  if (is_f32) {
    static int set1 = 0, set2 = 0;
    return launch2(ssd_state_fma, (int)state_fma_smem(N), ssd_out_fma,
                   (int)out_fma_smem(N), set1, set2, a, Bsz, PX, THREADS,
                   st);
  }
  const int nt = N <= 32 ? 32 : N <= 64 ? 64 : 128;
  switch (p_tile * 1000 + nt) {
    case 32032: return launch_wgmma<32, 32>(a, Bsz, st);
    case 32064: return launch_wgmma<32, 64>(a, Bsz, st);
    case 32128: return launch_wgmma<32, 128>(a, Bsz, st);
    case 64032: return launch_wgmma<64, 32>(a, Bsz, st);
    case 64064: return launch_wgmma<64, 64>(a, Bsz, st);
    default: return launch_wgmma<64, 128>(a, Bsz, st);
  }
}
