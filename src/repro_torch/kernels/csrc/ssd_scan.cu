// Mamba-2 chunked SSD (state-space duality) scan, hand-written for sm_90a:
// the sequence path of the ssm family's prefill.
//
// Replaces the TPU kernel K9: src/repro/kernels/ssd_scan.py, `_ssd_kernel`
// (pallas_call at ssd_scan.py:103).  Same function: x (B,S,H,P), dt (B,S,H)
// f32, A (H,) f32, B/C -> y (B,S,H,P) in x's dtype and the final state
// (B,H,N,P) f32, the state starting at zero.  Within a chunk of Q =
// min(chunk, S) steps, with cum = cumsum(dt * A) (exponents of sums of
// dt * A over the steps between):
//
//   y[q]  = sum_{k <= q} (C[q] . B[k]) exp(cum[q] - cum[k]) dt[k] x[k]
//         + exp(cum[q]) C[q] . h
//   h'    = exp(cum[Q-1]) h + sum_k exp(cum[Q-1] - cum[k]) dt[k] B[k] x[k]^T
//
// All arithmetic is f32, as in the Pallas kernel: the inputs are widened on
// load and y is rounded once.  The decay stays on the overflow-safe side:
// a pair k > q is skipped, never exponentiated.  Three things differ from
// the TPU kernel:
//   * the decay exponent cum[q] - cum[k] is not taken as a difference of
//     two running sums: at mamba2-370m's init dt*A reaches -85 a step and
//     a 16-step sum some -1360, where one f32 ulp is 1e-4, so a difference
//     of two such sums carries that absolute error into exponents that may
//     be near 0.  Every exponent is instead a sum of exactly the dA terms
//     between k and q, so its error is relative to the exponent itself, as
//     in the segment-sum form of arXiv:2405.21060.  The chunk is cut into
//     16-step segments: within one segment the exponent is summed directly
//     (at most 15 terms); across segments it is the prefix of q's segment
//     up to q, the sums of whole segments between (a 16x16 table) and the
//     suffix of k's segment after k, the prefix and the suffix each from a
//     scan within the segment;
//   * a ragged last chunk (S not a multiple of Q) is masked: rows past the
//     end read as zero dt, which is exactly the zero-dt padding of the
//     reference's jnp path, so any S is accepted (the Pallas kernel asserts
//     S % Q == 0);
//   * B and C are taken as (B,S,G,N), head h reading group h / (H/G), so the
//     32x group broadcast is never materialised.  G = H is the reference's
//     signature.
//
// Design.  On the TPU the chunk axis is a sequential grid dimension and the
// (H,N,P) state rides in VMEM scratch.  Here one CTA of 256 threads owns one
// (batch row, head, 16-channel slice of P) and walks the chunks in order
// itself, its (N, 16) slice of the state in shared memory.  Splitting P
// gives B*H*P/16 CTAs (128 at a B = 1 prefill of mamba2-370m, for 132 SMs);
// each slice recomputes the chunk's C.B^T scores.  A chunk is cut into
// 64-row blocks: for each query block the C tile sits in shared memory as
// [n][row] while the key blocks at or below it stream through (B tile,
// 64x16 x tile), each thread computing a 4x4 tile of scores over N, masking
// and weighting them into a 64x64 W tile, then a 4-row strip of W x.  The
// last query block sees every key block, so the state update's
// B^T (w x) product is accumulated in registers during that pass.
//
// What bounds it on the H100: operations.  One chunk of one head needs
// 2Q^2 N + 2Q^2 P + 4QNP flops, about 67 MFLOP at Q = 256, N = 128, P = 64,
// against ~110 KB of bf16 inputs: f32 arithmetic outside the tensor cores
// (67 TFLOP/s) is the limit, ~2.1 GFLOP and ~32 us per layer at a
// 512-token prompt.  This simple kernel runs the products on CUDA cores
// from shared memory; tensor cores (the scores and W x in tf32 or bf16 via
// wgmma) are later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;   // one chunk step per thread in the scans
constexpr int NWARPS = THREADS / 32;
constexpr int PS = 16;         // channels of P per CTA
constexpr int TB = 64;         // rows of a query or key block
constexpr int LD = TB + 4;     // padded row of the [n][row] tiles (16-B aligned)
constexpr int MAX_Q = 256;     // the in-block scan covers one chunk
constexpr int SEG = 16;        // steps of a decay segment
constexpr int NSEG = MAX_Q / SEG;
constexpr int MAX_N = 128;     // state rows per thread: MAX_N / 16

__device__ __forceinline__ float widen(float v) { return v; }
__device__ __forceinline__ float widen(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16(v);
}

size_t smem_floats(int N) {
  return 3 * MAX_Q + NSEG * NSEG + 4 * NSEG + TB + 2 * (size_t)N * LD +
         TB * PS + TB * LD + (size_t)N * PS;
}

// a 64-row block of B or C, rows [r0, r0 + 64) of the chunk, into dst as
// [n][row]; rows at or past L read as zero.  With `vec` (N a multiple of
// the 16-byte vector, 16-byte aligned rows) each thread first issues all of
// its 16-byte loads, then widens them into shared memory: a warp covers one
// vector of 32 consecutive rows, so its stores hit 32 distinct banks
// (bank = 4 n + row mod 32).  Otherwise one element per thread and pass,
// each warp pass covering 8 n x 4 rows, conflict-free as well.
template <typename T>
__device__ void load_rows(float* dst, const T* src, size_t row_stride,
                          int r0, int L, int N, bool vec) {
  if (vec) {
    constexpr int VEC = 16 / sizeof(T);
    constexpr int MAXIT = TB * MAX_N / VEC / THREADS;
    const int total = TB * (N / VEC);
    uint4 v[MAXIT];
#pragma unroll
    for (int j = 0; j < MAXIT; ++j) {
      const int idx = threadIdx.x + j * THREADS;
      const int ri = idx % TB, c = idx / TB;
      v[j] = (idx < total && r0 + ri < L)
                 ? *reinterpret_cast<const uint4*>(
                       src + (size_t)(r0 + ri) * row_stride + c * VEC)
                 : make_uint4(0u, 0u, 0u, 0u);
    }
#pragma unroll
    for (int j = 0; j < MAXIT; ++j) {
      const int idx = threadIdx.x + j * THREADS;
      if (idx < total) {
        const int ri = idx % TB, c = idx / TB;
        const T* e = reinterpret_cast<const T*>(&v[j]);
#pragma unroll
        for (int k = 0; k < VEC; ++k) dst[(c * VEC + k) * LD + ri] = widen(e[k]);
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
      dst[n * LD + ri] = r < L ? widen(src[(size_t)r * row_stride + n]) : 0.f;
    }
  }
}

// the 64 x 16 block of x, rows [r0, r0 + 64) of the chunk and this CTA's
// channels, into xs as [row][p]; 16-byte loads with `vec` (P a multiple of
// 16, aligned rows)
template <typename T>
__device__ void load_x(float* xs, const T* xb, size_t row_stride, int r0,
                       int L, int pmax, bool vec) {
  const int tid = threadIdx.x;
  if (vec) {
    constexpr int VEC = 16 / sizeof(T), CPR = PS / VEC;
    if (tid < TB * CPR) {
      const int ki = tid / CPR, c = tid % CPR, k = r0 + ki;
      const uint4 v = k < L ? *reinterpret_cast<const uint4*>(
                                  xb + (size_t)k * row_stride + c * VEC)
                            : make_uint4(0u, 0u, 0u, 0u);
      const T* e = reinterpret_cast<const T*>(&v);
#pragma unroll
      for (int i = 0; i < VEC; ++i) xs[ki * PS + c * VEC + i] = widen(e[i]);
    }
    return;
  }
  for (int e = tid; e < TB * PS; e += THREADS) {
    const int ki = e / PS, pe = e % PS, k = r0 + ki;
    xs[e] = (k < L && pe < pmax) ? widen(xb[(size_t)k * row_stride + pe])
                                 : 0.f;
  }
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
    ssd_kernel(const T* __restrict__ x, const float* __restrict__ dt,
               const float* __restrict__ A, const T* __restrict__ Bm,
               const T* __restrict__ Cm, T* __restrict__ y,
               float* __restrict__ hout, int S, int H, int P, int G, int N,
               int Q, bool vec_bc, bool vec_x) {
  extern __shared__ __align__(16) float sm[];
  // decay exponents of the chunk, dA = dt * A (zero past its end):
  float* cl = sm;                        // (MAX_Q) sum of dA up to k in k's segment
  float* rem = cl + MAX_Q;               // (MAX_Q) sum of dA after k in k's segment
  float* dtv = rem + MAX_Q;              // (MAX_Q) dt of the chunk
  float* between = dtv + MAX_Q;          // (NSEG, NSEG) sums of the segments
                                         //   strictly between two segments
  float* before = between + NSEG * NSEG; // (NSEG) sum of the segments before
  float* after = before + NSEG;          // (NSEG) sum of the segments after
  float* tot = after + NSEG;             // (NSEG) sum of a segment
  float* wk = tot + 2 * NSEG;            // (TB) exp(sum of dA after k) dt_k
  float* Cs = wk + TB;                   // (N, LD) query block of C
  float* Bs = Cs + N * LD;               // (N, LD) key block of B
  float* xs = Bs + N * LD;               // (TB, PS) key block of x
  float* Ws = xs + TB * PS;              // (TB, LD) weights of the pair
  float* hs = Ws + TB * LD;              // (N, PS) state slice

  const int tid = threadIdx.x;
  const int p0 = blockIdx.x * PS, h = blockIdx.y, b = blockIdx.z;
  const int g = h / (H / G);
  const float a = A[h];
  // row strides (elements) and the (b, s = 0, head) bases
  const size_t xr = (size_t)H * P, br = (size_t)G * N;
  const T* xb = x + (size_t)b * S * xr + (size_t)h * P + p0;
  T* yb = y + (size_t)b * S * xr + (size_t)h * P + p0;
  const float* dtb = dt + (size_t)b * S * H + h;
  const T* Bb = Bm + (size_t)b * S * br + (size_t)g * N;
  const T* Cb = Cm + (size_t)b * S * br + (size_t)g * N;

  // thread roles: (ty, tx) own a 4x4 tile of a 64x64 score block;
  // (r, p) own rows r + 16 j of a y strip or of the state, channel p
  const int ty = tid / 16, tx = tid % 16;
  const int r = tid / 16, p = tid % 16;
  const bool p_ok = p0 + p < P;

  for (int i = tid; i < N * PS; i += THREADS) hs[i] = 0.f;

  for (int c0 = 0; c0 < S; c0 += Q) {
    const int L = min(Q, S - c0);
    __syncthreads();
    // THREADS == MAX_Q: one step per thread; steps past L have dA = 0
    {
      const float v = tid < L ? dtb[(size_t)(c0 + tid) * H] : 0.f;
      dtv[tid] = v;
      cl[tid] = v * a;
    }
    __syncthreads();
    rem[tid] = tid % SEG < SEG - 1 ? cl[tid + 1] : 0.f;   // dA of the next step
    // per segment: an inclusive prefix scan of cl and a suffix scan of rem
    for (int off = 1; off < SEG; off <<= 1) {
      __syncthreads();
      const float t = (tid % SEG) >= off ? cl[tid - off] : 0.f;
      const float u = (tid % SEG) + off < SEG ? rem[tid + off] : 0.f;
      __syncthreads();
      cl[tid] += t;
      rem[tid] += u;
    }
    __syncthreads();
    if (tid < NSEG) tot[tid] = cl[tid * SEG + SEG - 1];
    {
      const int s1 = tid / NSEG, s2 = tid % NSEG;
      float acc = 0.f;
      for (int s = s1 + 1; s < s2; ++s) acc += tot[s];
      between[s1 * NSEG + s2] = acc;
      if (tid < NSEG) {
        float bs = 0.f, as = 0.f;
        for (int s = 0; s < tid; ++s) bs += tot[s];
        for (int s = tid + 1; s < NSEG; ++s) as += tot[s];
        before[tid] = bs;
        after[tid] = as;
      }
    }
    __syncthreads();
    const float last = before[NSEG - 1] + tot[NSEG - 1];   // sum of all dA
    const int nb = (L + TB - 1) / TB;

    float hacc[MAX_N / 16];
#pragma unroll
    for (int j = 0; j < MAX_N / 16; ++j) hacc[j] = 0.f;

    for (int qb = 0; qb < nb; ++qb) {
      const bool last_q = qb == nb - 1;
      load_rows(Cs, Cb + (size_t)c0 * br, br, qb * TB, L, N, vec_bc);
      float yacc[4] = {0.f, 0.f, 0.f, 0.f};

      for (int kb = 0; kb <= qb; ++kb) {
        load_rows(Bs, Bb + (size_t)c0 * br, br, kb * TB, L, N, vec_bc);
        load_x(xs, xb + (size_t)c0 * xr, xr, kb * TB, L, P - p0, vec_x);
        if (tid < TB) {
          const int k = kb * TB + tid;
          wk[tid] = k < L ? expf(rem[k] + after[k / SEG]) * dtv[k] : 0.f;
        }
        __syncthreads();

        // scores C[q] . B[k] for the 4x4 tile, then the masked weights
        float s[4][4] = {};
#pragma unroll 4
        for (int n = 0; n < N; ++n) {
          const float4 cv = *reinterpret_cast<const float4*>(Cs + n * LD + ty * 4);
          const float4 bv = *reinterpret_cast<const float4*>(Bs + n * LD + tx * 4);
          const float c4[4] = {cv.x, cv.y, cv.z, cv.w};
          const float b4[4] = {bv.x, bv.y, bv.z, bv.w};
#pragma unroll
          for (int i = 0; i < 4; ++i)
#pragma unroll
            for (int j = 0; j < 4; ++j) s[i][j] = fmaf(c4[i], b4[j], s[i][j]);
        }
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int q = qb * TB + ty * 4 + i;
          float w[4];
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            const int k = kb * TB + tx * 4 + j;
            // k > q is skipped, never exponentiated (overflow-safe side)
            if (q < L && k <= q) {
              const int sq = q / SEG, sk = k / SEG;
              float d;
              if (sq == sk) {
                d = 0.f;
                for (int m = k + 1; m <= q; ++m) d += dtv[m] * a;
              } else {
                d = cl[q] + between[sk * NSEG + sq] + rem[k];
              }
              w[j] = s[i][j] * expf(d) * dtv[k];
            } else {
              w[j] = 0.f;
            }
          }
          *reinterpret_cast<float4*>(Ws + (ty * 4 + i) * LD + tx * 4) =
              make_float4(w[0], w[1], w[2], w[3]);
        }
        __syncthreads();

        // y strip += W x; on the last query block also h += B^T (wk x)
        for (int ki = 0; ki < TB; ++ki) {
          const float xv = xs[ki * PS + p];
#pragma unroll
          for (int j = 0; j < 4; ++j)
            yacc[j] = fmaf(Ws[(r + 16 * j) * LD + ki], xv, yacc[j]);
          if (last_q) {
            const float xw = xv * wk[ki];
#pragma unroll
            for (int j = 0; j < MAX_N / 16; ++j)
              if (r + 16 * j < N)
                hacc[j] = fmaf(Bs[(r + 16 * j) * LD + ki], xw, hacc[j]);
          }
        }
        __syncthreads();
      }

      // the carried state's contribution, then one rounding of y
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int qi = r + 16 * j, q = qb * TB + qi;
        if (q < L) {
          float acc = 0.f;
          for (int n = 0; n < N; ++n)
            acc = fmaf(Cs[n * LD + qi], hs[n * PS + p], acc);
          const float out =
              fmaf(expf(before[q / SEG] + cl[q]), acc, yacc[j]);
          if (p_ok) store(yb + (size_t)(c0 + q) * xr + p, out);
        }
      }
      __syncthreads();
    }

    const float decay = expf(last);
#pragma unroll
    for (int j = 0; j < MAX_N / 16; ++j) {
      const int n = r + 16 * j;
      if (n < N) hs[n * PS + p] = fmaf(decay, hs[n * PS + p], hacc[j]);
    }
  }
  __syncthreads();
  if (p_ok) {
    float* hb = hout + ((size_t)b * H + h) * N * P + p0 + p;
    for (int n = r; n < N; n += 16) hb[(size_t)n * P] = hs[n * PS + p];
  }
}

template <typename T>
int launch(const void* x, const float* dt, const float* A, const void* Bm,
           const void* Cm, void* y, float* hout, int Bsz, int S, int H, int P,
           int G, int N, int Q, cudaStream_t st) {
  const size_t smem = smem_floats(N) * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      ssd_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  constexpr int VEC = 16 / sizeof(T);
  const auto aligned = [](const void* p) {
    return reinterpret_cast<uintptr_t>(p) % 16 == 0;
  };
  const bool vec_bc = N % VEC == 0 && aligned(Bm) && aligned(Cm);
  const bool vec_x = P % PS == 0 && aligned(x);
  const dim3 grid((P + PS - 1) / PS, H, Bsz);
  ssd_kernel<T><<<grid, THREADS, smem, st>>>(
      (const T*)x, dt, A, (const T*)Bm, (const T*)Cm, (T*)y, hout, S, H, P,
      G, N, Q, vec_bc, vec_x);
  return (int)cudaGetLastError();
}

}  // namespace

// x (B,S,H,P), B/C (B,S,G,N) and y (B,S,H,P): contiguous, bf16 (is_f32 = 0)
// or f32 (is_f32 = 1); dt (B,S,H) and A (H,) f32; hout (B,H,N,P) f32.
// Q = min(chunk, S) <= 256, N <= 128, G divides H.
extern "C" int ssd_scan(const void* x, const void* dt, const void* A,
                        const void* Bm, const void* Cm, void* y, void* hout,
                        int Bsz, int S, int H, int P, int G, int N, int Q,
                        int is_f32, void* stream) {
  if (Bsz < 1 || S < 1 || H < 1 || P < 1 || G < 1 || H % G || N < 1 ||
      N > MAX_N || Q < 1 || Q > MAX_Q || Bsz > 65535 || H > 65535)
    return (int)cudaErrorInvalidValue;
  const cudaStream_t st = (cudaStream_t)stream;
  return is_f32
             ? launch<float>(x, (const float*)dt, (const float*)A, Bm, Cm, y,
                             (float*)hout, Bsz, S, H, P, G, N, Q, st)
             : launch<__nv_bfloat16>(x, (const float*)dt, (const float*)A, Bm,
                                     Cm, y, (float*)hout, Bsz, S, H, P, G, N,
                                     Q, st);
}
