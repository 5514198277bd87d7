// One frame of the CTC prefix beam search, hand-written for sm_90a.
//
// Replaces the TPU kernel K5: src/repro/decode/kernel.py,
// `beam_frame_step` (pallas_call at kernel.py:123), whose body is
// `frame_step_scores` (src/repro/decode/beam.py:166) or, with top-C
// pruning, `frame_step_scores_topc` (beam.py:261).  On the TPU a block of
// rows keeps every intermediate — the (K, V) extend grid, the (K, K)
// duplicate-merge match and the (K*V) candidate grid that K argmax passes
// sweep — resident in VMEM.
//
// One CTA per batch row, templated on the semiring (max / sum) and on
// TOPC > 0.  What bounds it on the H100: the unpruned candidate grid is
// K x V = 8 x 32000 f32 = 1 MB per row, which does not fit one SM's 227 KB
// of shared memory, and the work per frame is O(K·V) compares while the
// bytes are only the (V,) log-prob row.  So the grid is never
// materialised: the row's log-probs sit in shared memory (V*4 = 128 KB at
// V=32000) and candidate (k, c) is recomputed on the fly from logp[c] and
// the per-parent scalars p_b, tot, last, plen (beam.py:185-216).  The
// (K x K) merge match is a per-parent bit mask, and its killed
// (k, last[j]) extends a (K, V) bitmap, both in shared memory.  With B rows only B SMs work, so
// at serving batch sizes the kernel is latency-bound, far above its
// bytes bound.
//
// Top-K, unpruned.  The reference runs K argmax passes over the K*V grid
// (first index wins ties) and stamps each selected index to NEG.  Here a
// first sweep finds each thread's best candidate and, by K block-wide
// argmax reductions, a threshold tau that the top K all reach; a second
// sweep keeps each thread's best K candidates at or above tau (ordered by
// value, then index), and K block-wide argmax reductions over the
// threads' heads merge them: the first selections are the top of that
// order.  Without the threshold, keeping K candidates per thread in one
// sweep spent most of the kernel's time inserting: nearly every iteration
// of a warp had some lane inserting, so the whole warp ran the insertion.  A taken index is not removed in the reference, it only turns to
// NEG: once the best untaken value is not above NEG (fewer than K live
// candidates), the pass returns the smallest index among those worth
// exactly NEG — the taken ones and, if it equals NEG, the next in order —
// and every later pass returns that same index again.  The epilogue
// reproduces exactly that, so `sel` matches the reference bit for bit.
//
// Top-K, pruned (TOPC).  C block-wide argmax passes over a stamped
// shared-memory copy of logp pick the frame's top C tokens (beam.py:
// 240-258); the (K, C+1) candidate grid then fits shared memory and the K
// passes stamp it exactly as the reference does; the selection is mapped
// back to the k*V + c convention (beam.py:334-347).
//
// The rolling prefix hash phash*1_000_003 + c wraps in int32 in the
// reference; it is computed in uint32_t here, since signed overflow is
// undefined behaviour in C++.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr float NEG = -1e30f;
constexpr int THREADS = 512;
constexpr int NWARPS = THREADS / 32;
constexpr int MAXK = 16;
constexpr uint32_t HASH_P = 1000003u;
constexpr int IMAX = 0x7fffffff;

__device__ __forceinline__ bool better(float av, int ai, float bv, int bi) {
  return av > bv || (av == bv && ai < bi);
}

template <bool SUM>
__device__ __forceinline__ float merge(float a, float b) {
  if (!SUM) return fmaxf(a, b);
  const float amax = fmaxf(a, b);           // jnp.logaddexp
  const float delta = a - b;
  if (isnan(delta)) return a + b;
  return amax + log1pf(expf(-fabsf(delta)));
}

struct Shared {
  float pb[MAXK], pnb[MAXK], tot[MAXK], spb[MAXK], spnb[MAXK], stot[MAXK];
  float lplast[MAXK];
  int last[MAXK], plen[MAXK], phash[MAXK];
  uint32_t kill[MAXK];    // bit j: extend (k, last[j]) merged into stay j
  bool cap[MAXK];
  float red_v[NWARPS + 1];
  int red_i[NWARPS + 1];
  float selv[MAXK];
  int seli[MAXK];
};

// Block-wide argmax of (v, i) under `better`; every thread gets the winner.
__device__ __forceinline__ void block_argmax(float& v, int& i, Shared& s) {
  const unsigned full = 0xffffffffu;
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    const float ov = __shfl_down_sync(full, v, off);
    const int oi = __shfl_down_sync(full, i, off);
    if (better(ov, oi, v, i)) { v = ov; i = oi; }
  }
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (lane == 0) { s.red_v[warp] = v; s.red_i[warp] = i; }
  __syncthreads();
  if (warp == 0) {
    v = lane < NWARPS ? s.red_v[lane] : -INFINITY;
    i = lane < NWARPS ? s.red_i[lane] : IMAX;
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      const float ov = __shfl_down_sync(full, v, off);
      const int oi = __shfl_down_sync(full, i, off);
      if (better(ov, oi, v, i)) { v = ov; i = oi; }
    }
    if (lane == 0) { s.red_v[NWARPS] = v; s.red_i[NWARPS] = i; }
  }
  __syncthreads();
  v = s.red_v[NWARPS];
  i = s.red_i[NWARPS];
  __syncthreads();                          // red_* free for the next call
}

__device__ __forceinline__ int hash_step(int h, int c) {
  return (int)((uint32_t)h * HASH_P + (uint32_t)c);
}

// Per-parent scalars, the (K x K) merge and the killed extends
// (beam.py:185-212 unpruned, 289-317 pruned).  `lp` is the original
// log-prob row.  Unpruned, the merged mass e[k, j] is gathered from the
// extend grid, whose blank column is NEG; pruned, it is rebuilt from the
// scalars without that mask, exactly as each reference body does.
template <bool SUM, bool TOPC>
__device__ __forceinline__ void beam_scalars(Shared& s, const float* lp, const float* pb,
                             const float* pnb, const int* last,
                             const int* phash, const int* plen, int K,
                             int blank, int max_len) {
  const int k = threadIdx.x;
  if (k < K) {
    s.pb[k] = pb[k];
    s.pnb[k] = pnb[k];
    s.last[k] = last[k];
    s.phash[k] = phash[k];
    s.plen[k] = plen[k];
    s.tot[k] = merge<SUM>(pb[k], pnb[k]);
    s.spb[k] = s.tot[k] + lp[blank];
    s.lplast[k] = lp[max(last[k], 0)];
    s.spnb[k] = last[k] >= 0 ? pnb[k] + s.lplast[k] : NEG;
    s.cap[k] = plen[k] >= max_len;
  }
  __syncthreads();
  float contrib = NEG;
  uint32_t kill = 0;
  if (k < K) {
    // thread j = k: merged mass into stay j, reduced over parents kk
    const int j = k;
    float vals[MAXK];
    float amax = -INFINITY;
    for (int kk = 0; kk < K; ++kk) {
      const bool match = s.plen[j] == s.plen[kk] + 1 &&
                         s.phash[j] == hash_step(s.phash[kk], s.last[j]) &&
                         s.last[j] >= 0;
      const int c = max(s.last[j], 0);
      float e = ((s.last[j] == s.last[kk]) ? s.pb[kk] : s.tot[kk]) +
                s.lplast[j];
      if (!TOPC && c == blank) e = NEG;
      if (s.cap[kk]) e = NEG;
      vals[kk] = match ? e : NEG;
      amax = fmaxf(amax, vals[kk]);
    }
    if (SUM) {                              // jax.nn.logsumexp
      const float m = isfinite(amax) ? amax : 0.f;
      float acc = 0.f;
      for (int kk = 0; kk < K; ++kk) acc += expf(vals[kk] - m);
      contrib = logf(acc) + m;
    } else {
      contrib = amax;
    }
    // thread k as a parent: which of its extends were merged away
    for (int jj = 0; jj < K; ++jj) {
      const bool match = s.plen[jj] == s.plen[k] + 1 &&
                         s.phash[jj] == hash_step(s.phash[k], s.last[jj]) &&
                         s.last[jj] >= 0;
      if (match) kill |= 1u << jj;
    }
  }
  __syncthreads();
  if (k < K) {
    s.spnb[k] = merge<SUM>(s.spnb[k], contrib);
    s.kill[k] = kill;
    s.stot[k] = merge<SUM>(s.spb[k], s.spnb[k]);
  }
  __syncthreads();
}

// Extend score of (parent k, token c) after the merge kills; `lc` = logp[c].
__device__ __forceinline__ float ext_score(const Shared& s, int k, int c,
                                           float lc, int K, int blank,
                                           bool unpruned_kill) {
  float v = ((c == s.last[k]) ? s.pb[k] : s.tot[k]) + lc;
  if (c == blank || s.cap[k]) return NEG;
  const uint32_t km = s.kill[k];
  if (km) {
    for (int j = 0; j < K; ++j) {
      const int cj = unpruned_kill ? max(s.last[j], 0) : s.last[j];
      if (((km >> j) & 1u) && c == cj) return NEG;
    }
  }
  return v;
}

// One parent's scalars in registers, for the sweep over its V candidates.
struct Parent {
  float stot, pb, tot;
  int last;
  bool cap;
  const uint32_t* killed;   // its row of the kill bitmap, or null if none
};

__device__ __forceinline__ Parent parent_of(const Shared& s,
                                            const uint32_t* killed, int W,
                                            int k) {
  return {s.stot[k], s.pb[k], s.tot[k], s.last[k], s.cap[k],
          s.kill[k] ? killed + k * W : nullptr};
}

// Unpruned candidate (k, c): the stay total in the blank column, else
// ext_score(s, k, c, lp[c], ...) with the kills read from the bitmap.
__device__ __forceinline__ float cand_value(const Parent& p, const float* lp,
                                            int c, int blank) {
  if (c == blank) return p.stot;
  if (p.cap || (p.killed && ((p.killed[c >> 5] >> (c & 31)) & 1u)))
    return NEG;
  return ((c == p.last) ? p.pb : p.tot) + lp[c];
}

template <bool SUM, int LK>
__global__ void __launch_bounds__(THREADS)
beam_step_kernel(const float* __restrict__ logp, const float* __restrict__ p_b,
                 const float* __restrict__ p_nb, const int* __restrict__ last,
                 const int* __restrict__ phash, const int* __restrict__ plen,
                 int* __restrict__ sel, float* __restrict__ new_pb,
                 float* __restrict__ new_pnb, int K, int V, int blank,
                 int max_len) {
  // dynamic shared memory: lp[V] | killed[K][W], bit c of row k set when
  // extend (k, c) was merged into an in-beam prefix
  extern __shared__ float lp[];
  const int W = (V + 31) / 32;
  uint32_t* killed = reinterpret_cast<uint32_t*>(lp + V);
  __shared__ Shared s;
  const int b = blockIdx.x;
  const float* lpg = logp + (size_t)b * V;
  for (int c = threadIdx.x; c < V; c += THREADS) lp[c] = lpg[c];
  for (int w = threadIdx.x; w < K * W; w += THREADS) killed[w] = 0u;
  __syncthreads();
  const size_t ro = (size_t)b * K;
  beam_scalars<SUM, false>(s, lp, p_b + ro, p_nb + ro, last + ro,
                           phash + ro, plen + ro, K, blank, max_len);
  if (threadIdx.x < K) {                  // thread k owns row k of `killed`
    const int k = threadIdx.x;
    for (int j = 0; j < K; ++j) {
      if ((s.kill[k] >> j) & 1u) {
        const int c = max(s.last[j], 0);
        killed[k * W + (c >> 5)] |= 1u << (c & 31);
      }
    }
  }
  __syncthreads();

  // Sweep 1: each thread's best candidate.  The K-th best of these 512
  // maxima, tau, is a value that at least K candidates reach, so the top
  // K all lie at or above it.
  float bv = -INFINITY;
  int bi = IMAX;
  for (int k = 0; k < K; ++k) {
    const Parent pr = parent_of(s, killed, W, k);
    for (int c = threadIdx.x; c < V; c += THREADS) {
      const float v = cand_value(pr, lp, c, blank);
      if (better(v, k * V + c, bv, bi)) { bv = v; bi = k * V + c; }
    }
  }
  float tau = -INFINITY;
  for (int p = 0; p < K; ++p) {
    float v = bv;
    int i = bi;
    block_argmax(v, i, s);
    tau = v;
    if (bi == i) { bv = -INFINITY; bi = IMAX; }       // the owner drops out
  }
  // Sweep 2: each thread's best K candidates at or above tau, by (value
  // desc, index asc).  Few candidates pass tau, so the insertion below
  // rarely runs and the warp rarely diverges.
  float lv[LK];
  int li[LK];
#pragma unroll
  for (int q = 0; q < LK; ++q) { lv[q] = -INFINITY; li[q] = IMAX; }
  float wv = -INFINITY;
  int wi = IMAX;
  for (int k = 0; k < K; ++k) {
    const Parent pr = parent_of(s, killed, W, k);
    for (int c = threadIdx.x; c < V; c += THREADS) {
      const float v = cand_value(pr, lp, c, blank);
      const int i = k * V + c;
      if (v < tau || !better(v, i, wv, wi)) continue;
      float cv = v;
      int ci = i;
#pragma unroll
      for (int q = 0; q < LK; ++q) {
        if (q < K && better(cv, ci, lv[q], li[q])) {
          const float tv = lv[q]; lv[q] = cv; cv = tv;
          const int ti = li[q]; li[q] = ci; ci = ti;
        }
      }
#pragma unroll
      for (int q = 0; q < LK; ++q)
        if (q == K - 1) { wv = lv[q]; wi = li[q]; }
    }
  }
  // K block-wide argmax passes over the threads' list heads
  for (int p = 0; p < K; ++p) {
    float v = lv[0];
    int i = li[0];
    block_argmax(v, i, s);
    if (threadIdx.x == 0) { s.selv[p] = v; s.seli[p] = i; }
    if (li[0] == i) {                                 // the owner pops
#pragma unroll
      for (int q = 0; q < LK - 1; ++q) { lv[q] = lv[q + 1]; li[q] = li[q + 1]; }
      lv[LK - 1] = -INFINITY;
      li[LK - 1] = IMAX;
    }
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    // the reference's stamp-to-NEG passes once no live candidate is left
    int m = K;
    for (int p = 0; p < K; ++p)
      if (!(s.selv[p] > NEG)) { m = p; break; }
    if (m < K) {
      int w = s.seli[0];
      if (m > 0) {
        int mn = s.seli[0];
        for (int p = 1; p < m; ++p) mn = min(mn, s.seli[p]);
        w = (s.selv[m] == NEG) ? min(mn, s.seli[m]) : mn;
      }
      for (int p = m; p < K; ++p) s.seli[p] = w;
    }
  }
  __syncthreads();
  const int p = threadIdx.x;
  if (p < K) {
    const int i = s.seli[p];
    const int k = i / V, c = i % V;
    const bool stay = c == blank;
    sel[ro + p] = i;
    new_pb[ro + p] = stay ? s.spb[k] : NEG;
    new_pnb[ro + p] = stay ? s.spnb[k]
                           : ext_score(s, k, c, lp[c], K, blank, true);
  }
}

// Pruned body: dynamic shared memory = work[V] | idx[C] | vals[C] |
// cand[K*(C+1)] | extf[K*C].
template <bool SUM>
__global__ void __launch_bounds__(THREADS)
beam_step_topc_kernel(const float* __restrict__ logp,
                      const float* __restrict__ p_b,
                      const float* __restrict__ p_nb,
                      const int* __restrict__ last,
                      const int* __restrict__ phash,
                      const int* __restrict__ plen, int* __restrict__ sel,
                      float* __restrict__ new_pb, float* __restrict__ new_pnb,
                      int K, int V, int C, int blank, int max_len) {
  extern __shared__ float dyn[];
  float* work = dyn;
  int* idx = reinterpret_cast<int*>(work + V);
  float* vals = reinterpret_cast<float*>(idx + C);
  float* cand = vals + C;
  float* extf = cand + K * (C + 1);
  __shared__ Shared s;
  const int b = blockIdx.x;
  const float* lpg = logp + (size_t)b * V;
  for (int c = threadIdx.x; c < V; c += THREADS) work[c] = lpg[c];
  __syncthreads();

  // top-C tokens: C argmax passes over the stamped copy (beam.py:240-258)
  for (int q = 0; q < C; ++q) {
    float v = -INFINITY;
    int i = IMAX;
    for (int c = threadIdx.x; c < V; c += THREADS)
      if (better(work[c], c, v, i)) { v = work[c]; i = c; }
    block_argmax(v, i, s);
    if (threadIdx.x == 0) {
      idx[q] = i;
      vals[q] = lpg[i];                    // gathered from the original row
      work[i] = NEG;
    }
    __syncthreads();
  }
  const size_t ro = (size_t)b * K;
  beam_scalars<SUM, true>(s, lpg, p_b + ro, p_nb + ro, last + ro,
                          phash + ro, plen + ro, K, blank, max_len);

  // the (K, C+1) candidate grid, column 0 of each parent its stay
  for (int e = threadIdx.x; e < K * C; e += THREADS) {
    const int k = e / C, q = e % C;
    const float v = ext_score(s, k, idx[q], vals[q], K, blank, false);
    extf[e] = v;
    cand[k * (C + 1) + 1 + q] = v;
  }
  if (threadIdx.x < K) cand[threadIdx.x * (C + 1)] = s.stot[threadIdx.x];
  __syncthreads();
  const int n = K * (C + 1);
  for (int p = 0; p < K; ++p) {
    float v = -INFINITY;
    int i = IMAX;
    for (int e = threadIdx.x; e < n; e += THREADS)
      if (better(cand[e], e, v, i)) { v = cand[e]; i = e; }
    block_argmax(v, i, s);
    if (threadIdx.x == 0) {
      s.seli[p] = i;
      cand[i] = NEG;
    }
    __syncthreads();
  }
  const int p = threadIdx.x;
  if (p < K) {
    const int sc = s.seli[p];
    const int k = sc / (C + 1), within = sc % (C + 1);
    const bool stay = within == 0;
    const int qq = min(max(within - 1, 0), C - 1);
    const int c = stay ? blank : idx[qq];
    sel[ro + p] = k * V + c;
    new_pb[ro + p] = stay ? s.spb[k] : NEG;
    new_pnb[ro + p] = stay ? s.spnb[k] : extf[k * C + qq];
  }
}

template <typename F>
cudaError_t allow_smem(F kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)bytes);
}

template <bool SUM, int LK>
cudaError_t launch_full(int B, cudaStream_t st, const float* logp,
                        const float* pb, const float* pnb, const int* last,
                        const int* phash, const int* plen, int* sel,
                        float* npb, float* npnb, int K, int V, int blank,
                        int max_len) {
  const size_t smem = ((size_t)V + (size_t)K * ((V + 31) / 32)) * 4;
  cudaError_t err = allow_smem(beam_step_kernel<SUM, LK>, smem);
  if (err != cudaSuccess) return err;
  beam_step_kernel<SUM, LK><<<B, THREADS, smem, st>>>(
      logp, pb, pnb, last, phash, plen, sel, npb, npnb, K, V, blank, max_len);
  return cudaGetLastError();
}

template <bool SUM>
cudaError_t launch_topc(int B, cudaStream_t st, const float* logp,
                        const float* pb, const float* pnb, const int* last,
                        const int* phash, const int* plen, int* sel,
                        float* npb, float* npnb, int K, int V, int C,
                        int blank, int max_len) {
  const size_t smem =
      ((size_t)V + 2 * (size_t)C + (size_t)K * (C + 1) + (size_t)K * C) * 4;
  cudaError_t err = allow_smem(beam_step_topc_kernel<SUM>, smem);
  if (err != cudaSuccess) return err;
  beam_step_topc_kernel<SUM><<<B, THREADS, smem, st>>>(
      logp, pb, pnb, last, phash, plen, sel, npb, npnb, K, V, C, blank,
      max_len);
  return cudaGetLastError();
}

}  // namespace

// logp (B, V) f32; p_b/p_nb (B, K) f32; last/phash/plen (B, K) i32 ->
// sel (B, K) i32 indexing the K*V grid, new_pb/new_pnb (B, K) f32.
extern "C" int beam_step(const void* logp, const void* p_b, const void* p_nb,
                         const void* last, const void* phash,
                         const void* plen, void* sel, void* new_pb,
                         void* new_pnb, int B, int K, int V, int blank,
                         int max_len, int semiring_sum, int topc,
                         void* stream) {
  if (B < 1 || K < 1 || K > MAXK || V < K || blank < 0 || blank >= V ||
      topc < 0 || topc >= V)
    return (int)cudaErrorInvalidValue;
  const cudaStream_t st = (cudaStream_t)stream;
  const float* lp = (const float*)logp;
  const float* pb = (const float*)p_b;
  const float* pnb = (const float*)p_nb;
  const int* la = (const int*)last;
  const int* ph = (const int*)phash;
  const int* pl = (const int*)plen;
  int* se = (int*)sel;
  float* npb = (float*)new_pb;
  float* npnb = (float*)new_pnb;
  cudaError_t err;
  if (topc > 0) {
    err = semiring_sum
              ? launch_topc<true>(B, st, lp, pb, pnb, la, ph, pl, se, npb,
                                  npnb, K, V, topc, blank, max_len)
              : launch_topc<false>(B, st, lp, pb, pnb, la, ph, pl, se, npb,
                                   npnb, K, V, topc, blank, max_len);
  } else if (K <= 8) {
    err = semiring_sum
              ? launch_full<true, 8>(B, st, lp, pb, pnb, la, ph, pl, se, npb,
                                     npnb, K, V, blank, max_len)
              : launch_full<false, 8>(B, st, lp, pb, pnb, la, ph, pl, se,
                                      npb, npnb, K, V, blank, max_len);
  } else {
    err = semiring_sum
              ? launch_full<true, 16>(B, st, lp, pb, pnb, la, ph, pl, se,
                                      npb, npnb, K, V, blank, max_len)
              : launch_full<false, 16>(B, st, lp, pb, pnb, la, ph, pl, se,
                                       npb, npnb, K, V, blank, max_len);
  }
  return (int)err;
}
