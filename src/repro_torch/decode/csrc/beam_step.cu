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
// What bounds it on the H100: the bytes are only the (V,) log-prob row
// (128 KB at V = 32000) and the work per frame O(K·V) compares, so at
// serving batch sizes (B = 4 to 8 rows) a call is bound by how long the
// SMs that hold a row take over its K x V candidates and by the chain of
// selections after, not by the card.  So each row is a thread-block
// cluster of S CTAs (S = 1..8, `decode.kernel.beam_slices`: as many as
// B·S <= the SM count allows, at least 512 tokens a CTA), CTA s holding
// tokens [V s / S, V (s + 1) / S) of the row in shared memory.  Every CTA
// computes the per-parent scalars p_b, tot, last, plen and the (K x K)
// merge match itself (K <= 16, one thread a pair; lp[blank] and lp[last]
// are read from device memory), then its slice's best K candidates
// (unpruned) or C tokens (top-C) in the order (value desc, index asc), and
// pushes them into CTA 0's shared memory; behind one cluster barrier CTA
// 0 ranks the S lists.  The union of the slices' best K holds the row's
// best K, and every selection uses the same total order, so neither the
// slicing nor the merge order changes `sel`.
//
// The grid is never materialised.  A candidate (k, c) is recomputed from
// logp[c] and parent k's scalars (beam.py:185-216), and for every token
// but the special ones — blank (the stay column) and the prefixes' last
// tokens (where p_b replaces tot, and where the merge kills extends) — it
// is NEG for a capped parent and tot[k] + logp[c] otherwise.  The special
// tokens are marked NaN in the slice and take the full rule; the others'
// best candidate is the largest tot's, so a sweep reads one value and
// adds once per token.
//
// Selection.  A first sweep finds each warp's best candidate; the K-th
// best of the 16 warp maxima, tau, is a value at least K candidates
// reach, so the slice's best K all lie at or above it (the plan's slices
// hold at least 512 tokens, so every warp holds some; a warp holding none
// makes tau -inf, and every candidate passes).  A second sweep skips
// every token whose best candidate is below tau and appends the
// candidates at or above it to a shared buffer; each buffered candidate's
// rank is the number of buffered ones before it in the order, one pass
// of broadcast reads, and the K of rank < K are the slice's list.  CTA 0
// ranks the S lists the same way.  No block-wide reduction and no barrier
// per selection.  Where more than CAP (512) candidates reach tau — ties at
// tau, as when every parent is capped and the candidates are all NEG —
// each thread keeps its best K in a list, each warp merges its lanes'
// lists by K shuffle reductions and warp 0 the warps'.
//
// The reference's K argmax passes stamp each selected index to NEG
// instead of removing it.  Once the best untaken value is not above NEG
// (fewer than K live candidates), a pass returns the smallest index among
// those worth exactly NEG — the taken ones and, if it equals NEG, the next
// in order — and every later pass the same index again.  CTA 0 applies
// exactly that to the merged order (`stamp_epilogue`); the next in order
// after the live ones is the row's smallest NEG-valued index whenever one
// exists, since each slice's list carries its own below its live
// candidates.  So `sel` matches the reference bit for bit.
//
// Top-K, pruned (TOPC).  The row's top C tokens are selected the same
// way, a token's value its logp (tau the C-th best warp maximum for C <=
// 16; past CAP, or for C > 16, each warp takes its best C by C shuffle
// reductions, the owner marking its token taken and rescanning its own,
// and warp 0 merges the warps' lists).  CTA 0 applies the stamp rule to
// them (the reference takes them by C stamped argmax passes over the row,
// beam.py:240-258), builds the (K, C+1) candidate grid in shared memory
// and takes K stamped argmax passes over it exactly as the reference
// does; the selection is mapped back to the k*V + c convention
// (beam.py:334-347).
//
// The rolling prefix hash phash*1_000_003 + c wraps in int32 in the
// reference; it is computed in uint32_t here, since signed overflow is
// undefined behaviour in C++.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

namespace cg = cooperative_groups;

constexpr float NEG = -1e30f;
constexpr int THREADS = 512;
constexpr int NWARPS = THREADS / 32;
constexpr int MAXK = 16;
constexpr int MAX_SLICES = 8;
constexpr int CAP = THREADS;      // candidates a CTA ranks at once
constexpr uint32_t HASH_P = 1000003u;
constexpr int IMAX = 0x7fffffff;

__device__ __forceinline__ bool better(float av, int ai, float bv, int bi) {
  return av > bv || (av == bv && ai < bi);
}

// the best (v, i) of the warp, in every lane
__device__ __forceinline__ void warp_best(float& v, int& i) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    const float ov = __shfl_xor_sync(0xffffffffu, v, off);
    const int oi = __shfl_xor_sync(0xffffffffu, i, off);
    if (better(ov, oi, v, i)) {
      v = ov;
      i = oi;
    }
  }
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
  float mval[MAXK * MAXK];   // [j K + kk]: parent kk's mass merged into j
  uint8_t mbit[MAXK * MAXK];  // [j K + kk]: parent kk's extend is prefix j
  float red_v[NWARPS];    // the warps' best of the first sweep
  int red_i[NWARPS];
  int count;              // candidates at or above tau (unpruned)
  float cb_v[CAP];        // and the first CAP of them
  int cb_i[CAP];
  float wl_v[NWARPS * MAXK];   // the warps' lists, past CAP (unpruned)
  int wl_i[NWARPS * MAXK];
  float cl_v[MAXK];       // this CTA's best K, pushed to CTA 0
  int cl_i[MAXK];
  float m_v[MAX_SLICES * MAXK];   // CTA 0: every CTA's list
  int m_i[MAX_SLICES * MAXK];
  float selv[MAXK];
  int seli[MAXK];
};

__device__ __forceinline__ int hash_step(int h, int c) {
  return (int)((uint32_t)h * HASH_P + (uint32_t)c);
}

// A parent's inputs (thread k < K loads parent k's): read before the
// slice of logp, so that the two loads overlap.
struct ParentIn {
  float pb, pnb, lpb, lplast;     // lpb = lp[blank], lplast = lp[last]
  int last, phash, plen;
};

__device__ __forceinline__ ParentIn load_parent(const float* lp,
                                                const float* pb,
                                                const float* pnb,
                                                const int* last,
                                                const int* phash,
                                                const int* plen, int k,
                                                int blank) {
  ParentIn in;
  in.pb = pb[k];
  in.pnb = pnb[k];
  in.last = last[k];
  in.phash = phash[k];
  in.plen = plen[k];
  in.lpb = lp[blank];
  in.lplast = lp[max(in.last, 0)];
  return in;
}

// Per-parent scalars, the (K x K) merge and the killed extends
// (beam.py:185-212 unpruned, 289-317 pruned), from the parents' inputs.
// Unpruned, the merged mass e[k, j] is gathered from the extend grid,
// whose blank column is NEG; pruned, it is rebuilt from the scalars
// without that mask, exactly as each reference body does.
template <bool SUM, bool TOPC>
__device__ __forceinline__ void beam_scalars(Shared& s, const ParentIn& in,
                                             int K, int blank, int max_len) {
  const int t = threadIdx.x;
  if (t < K) {
    const int k = t;
    s.pb[k] = in.pb;
    s.pnb[k] = in.pnb;
    s.last[k] = in.last;
    s.phash[k] = in.phash;
    s.plen[k] = in.plen;
    s.tot[k] = merge<SUM>(in.pb, in.pnb);
    s.spb[k] = s.tot[k] + in.lpb;
    s.lplast[k] = in.lplast;
    s.spnb[k] = in.last >= 0 ? in.pnb + in.lplast : NEG;
    s.cap[k] = in.plen >= max_len;
  }
  __syncthreads();
  if (t < K * K) {
    // thread (j, kk): does parent kk's extend by last[j] give prefix j,
    // and with what mass
    const int j = t / K, kk = t % K;
    const bool match = s.plen[j] == s.plen[kk] + 1 &&
                       s.phash[j] == hash_step(s.phash[kk], s.last[j]) &&
                       s.last[j] >= 0;
    const int c = max(s.last[j], 0);
    float e = ((s.last[j] == s.last[kk]) ? s.pb[kk] : s.tot[kk]) +
              s.lplast[j];
    if (!TOPC && c == blank) e = NEG;
    if (s.cap[kk]) e = NEG;
    s.mval[t] = match ? e : NEG;
    s.mbit[t] = match;
  }
  __syncthreads();
  if (t < K) {
    // thread j: the mass merged into stay j, reduced over parents kk in
    // order; thread k as a parent: which of its extends were merged away
    const float* vals = s.mval + t * K;
    float contrib, amax = -INFINITY;
    for (int kk = 0; kk < K; ++kk) amax = fmaxf(amax, vals[kk]);
    if (SUM) {                              // jax.nn.logsumexp
      const float m = isfinite(amax) ? amax : 0.f;
      float acc = 0.f;
      for (int kk = 0; kk < K; ++kk) acc += expf(vals[kk] - m);
      contrib = logf(acc) + m;
    } else {
      contrib = amax;
    }
    uint32_t kill = 0;
    for (int jj = 0; jj < K; ++jj)
      if (s.mbit[jj * K + t]) kill |= 1u << jj;
    s.spnb[t] = merge<SUM>(s.spnb[t], contrib);
    s.kill[t] = kill;
    s.stot[t] = merge<SUM>(s.spb[t], s.spnb[t]);
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

// Candidate (k, c) of a special token c (blank, or some prefix's last
// token, where the kills sit), lc = logp[c]: the stay total in the blank
// column, else ext_score.  Every other token's candidate is NEG for a
// capped parent and tot[k] + logp[c] otherwise (beam.py:185-216).
__device__ __forceinline__ float special_value(const Shared& s, int k, int c,
                                               float lc, int K, int blank) {
  return c == blank ? s.stot[k] : ext_score(s, k, c, lc, K, blank, true);
}

// What the sweeps need of the K parents for the other tokens: the capped
// ones as bits, and the best candidate of a token (value top + logp[c]
// at the largest tot's parent ktop, or NEG at the first capped parent
// kneg).
struct Parents {
  uint32_t cap = 0;
  float top = -INFINITY;
  int ktop = -1, kneg = -1;
  __device__ Parents(const Shared& s, int K) {
    for (int k = 0; k < K; ++k) {
      if (s.cap[k]) {
        cap |= 1u << k;
        if (kneg < 0) kneg = k;
      } else if (ktop < 0 || s.tot[k] > top) {
        top = s.tot[k];
        ktop = k;
      }
    }
  }
  // the best candidate of token c (lc = logp[c]); V is the grid's stride
  __device__ __forceinline__ void best(float lc, int c, int V, float& v,
                                       int& i) const {
    v = -INFINITY;
    i = IMAX;
    if (ktop >= 0) {
      v = top + lc;
      i = ktop * V + c;
    }
    if (kneg >= 0 && better(NEG, kneg * V + c, v, i)) {
      v = NEG;
      i = kneg * V + c;
    }
  }
};

// Warp-wide: the best n of `lists` sorted lists of length len (lists <=
// 32, lane l owning list l), in order, into out_v / out_i (lane 0
// writes).  Indices are distinct across the lists, except the (-inf,
// IMAX) padding.
__device__ void merge_lists(const float* lv, const int* li, int lists,
                            int len, int n, float* out_v, int* out_i) {
  const int lane = threadIdx.x & 31;
  int at = 0;
  const bool mine = lane < lists && len > 0;
  float hv = mine ? lv[lane * len] : -INFINITY;
  int hi = mine ? li[lane * len] : IMAX;
  for (int p = 0; p < n; ++p) {
    float v = hv;
    int i = hi;
    warp_best(v, i);
    if (lane == 0) {
      out_v[p] = v;
      out_i[p] = i;
    }
    if (hi == i && ++at < len && lane < lists) {    // the owner advances
      hv = lv[lane * len + at];
      hi = li[lane * len + at];
    } else if (hi == i) {
      hv = -INFINITY;
      hi = IMAX;
    }
  }
  __syncwarp();
}

// Block-wide: the best K of n distinct entries, in order, into out_v /
// out_i: each entry's rank is the number of entries before it in the
// order (value desc, index asc), one pass over the n (all threads read
// the same entry at once: broadcast reads).
__device__ void rank_select(const float* v, const int* i, int n, int K,
                            float* out_v, int* out_i) {
  for (int t = threadIdx.x; t < n; t += THREADS) {
    const float mv = v[t];
    const int mi = i[t];
    int rank = 0;
    for (int m = 0; m < n; ++m) rank += better(v[m], i[m], mv, mi) ? 1 : 0;
    if (rank < K) {
      out_v[rank] = mv;
      out_i[rank] = mi;
    }
  }
}

// The reference's stamp-to-NEG passes once no live candidate is left
// (see the header), applied to a merged order of n entries.
__device__ void stamp_epilogue(const float* sv, int* si, int n) {
  int m = n;
  for (int p = 0; p < n; ++p)
    if (!(sv[p] > NEG)) {
      m = p;
      break;
    }
  if (m < n) {
    int w = si[0];
    if (m > 0) {
      int mn = si[0];
      for (int p = 1; p < m; ++p) mn = min(mn, si[p]);
      w = (sv[m] == NEG) ? min(mn, si[m]) : mn;
    }
    for (int p = m; p < n; ++p) si[p] = w;
  }
}

// The slice of CTA `s` of `S`: tokens [v0, v1).
__device__ __forceinline__ void slice_of(int V, int s, int S, int& v0,
                                         int& v1) {
  v0 = (int)((long long)V * s / S);
  v1 = (int)((long long)V * (s + 1) / S);
}

// The slice of the row into lp[0, v1 - v0), UNROLL loads in flight a
// thread before their stores.
__device__ __forceinline__ void load_slice(float* lp, const float* row,
                                           int wd) {
  constexpr int UNROLL = 8;
  for (int j0 = threadIdx.x; j0 < wd; j0 += UNROLL * THREADS) {
    float r[UNROLL];
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      const int j = j0 + u * THREADS;
      r[u] = j < wd ? row[j] : 0.f;
    }
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      const int j = j0 + u * THREADS;
      if (j < wd) lp[j] = r[u];
    }
  }
}

// This CTA's list of n into CTA 0's m_v / m_i at rank r's place, through
// distributed shared memory; the caller's cluster barrier publishes it.
__device__ void push_list(cg::cluster_group& cluster, const float* lv,
                          const int* li, int n, float* m_v, int* m_i) {
  const int r = (int)cluster.block_rank();
  for (int p = threadIdx.x; p < n; p += THREADS) {
    *cluster.map_shared_rank(m_v + r * n + p, 0) = lv[p];
    *cluster.map_shared_rank(m_i + r * n + p, 0) = li[p];
  }
}

// Inserts (v, i) into a thread's list of its best K (LK registers, sorted
// by (value desc, index asc)), keeping (wv, wi) = its K-th entry.
template <int LK>
__device__ __forceinline__ void insert(float (&lv)[LK], int (&li)[LK],
                                       float& wv, int& wi, float v, int i,
                                       int K) {
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

template <bool SUM, int LK>
__global__ void __launch_bounds__(THREADS)
beam_step_kernel(const float* __restrict__ logp, const float* __restrict__ p_b,
                 const float* __restrict__ p_nb, const int* __restrict__ last,
                 const int* __restrict__ phash, const int* __restrict__ plen,
                 int* __restrict__ sel, float* __restrict__ new_pb,
                 float* __restrict__ new_pnb, int K, int V, int blank,
                 int max_len, int Wmax) {
  // dynamic shared memory: the slice of logp, the special tokens (blank
  // and the prefixes' last tokens) marked NaN
  extern __shared__ float lp[];
  __shared__ Shared s;
  cg::cluster_group cluster = cg::this_cluster();
  const int S = (int)cluster.num_blocks();
  const int rank = (int)cluster.block_rank();
  const int b = blockIdx.x / S;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  int v0, v1;
  slice_of(V, rank, S, v0, v1);
  const int wd = v1 - v0;
  const float* lpg = logp + (size_t)b * V;
  const size_t ro = (size_t)b * K;
  if (tid == 0) s.count = 0;
  if (tid < MAXK) {
    s.cl_v[tid] = -INFINITY;
    s.cl_i[tid] = IMAX;
  }
  ParentIn in{};
  if (tid < K)
    in = load_parent(lpg, p_b + ro, p_nb + ro, last + ro, phash + ro,
                     plen + ro, tid, blank);
  load_slice(lp, lpg + v0, wd);
  beam_scalars<SUM, false>(s, in, K, blank, max_len);
  if (tid <= K) {
    const int c = tid < K ? max(s.last[tid], 0) : blank;
    if (c >= v0 && c < v1) lp[c - v0] = NAN;
  }
  __syncthreads();
  const Parents pr(s, K);
  // candidate (k, c) of token j of the slice, lc its slice value (NaN:
  // special)
  const auto value = [&](int k, int c, float lc, bool special) {
    return special ? special_value(s, k, c, lc, K, blank)
                   : ((pr.cap >> k) & 1u) ? NEG : s.tot[k] + lc;
  };

  // Sweep 1: each warp's best candidate; tau, the K-th best of the 16, is
  // a value at least K candidates of the slice reach.
  float bv = -INFINITY;
  int bi = IMAX;
#pragma unroll 4
  for (int j = tid; j < wd; j += THREADS) {
    const float lc = lp[j];
    const int c = v0 + j;
    if (isnan(lc)) {
      const float lg = lpg[c];
      for (int k = 0; k < K; ++k) {
        const float v = special_value(s, k, c, lg, K, blank);
        if (better(v, k * V + c, bv, bi)) {
          bv = v;
          bi = k * V + c;
        }
      }
    } else {
      float v;
      int i;
      pr.best(lc, c, V, v, i);
      if (better(v, i, bv, bi)) {
        bv = v;
        bi = i;
      }
    }
  }
  warp_best(bv, bi);
  if (lane == 0) {
    s.red_v[warp] = bv;
    s.red_i[warp] = bi;
  }
  __syncthreads();
  float tau;
  {
    // lane l ranks warp l's best; tau is the lowest of the K best ranks
    float v = -INFINITY;
    int rk = NWARPS;
    if (lane < NWARPS) {
      v = s.red_v[lane];
      const int i = s.red_i[lane];
      rk = 0;
      for (int w = 0; w < NWARPS; ++w)
        rk += better(s.red_v[w], s.red_i[w], v, i) ? 1 : 0;
    }
    tau = rk < K ? v : INFINITY;
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      tau = fminf(tau, __shfl_xor_sync(0xffffffffu, tau, off));
  }

  // Sweep 2: every candidate at or above tau into the buffer (few: a
  // token whose best candidate is below tau is done at once)
  for (int j = tid; j < wd; j += THREADS) {
    float lc = lp[j];
    const int c = v0 + j;
    const bool special = isnan(lc);
    if (special) {
      lc = lpg[c];
    } else {
      float top;
      int ti;
      pr.best(lc, c, V, top, ti);
      if (top < tau) continue;
    }
    for (int k = 0; k < K; ++k) {
      const float v = value(k, c, lc, special);
      if (v < tau) continue;
      const int at = atomicAdd(&s.count, 1);
      if (at < CAP) {
        s.cb_v[at] = v;
        s.cb_i[at] = k * V + c;
      }
    }
  }
  __syncthreads();
  const int n = s.count;
  if (n <= CAP) {
    rank_select(s.cb_v, s.cb_i, n, K, s.cl_v, s.cl_i);
  } else {
    // more than CAP at or above tau (ties at tau: few live candidates):
    // each thread's best K in a list, each warp's by K shuffle
    // reductions, warp 0's merge of the 16
    float lv[LK];
    int li[LK];
#pragma unroll
    for (int q = 0; q < LK; ++q) {
      lv[q] = -INFINITY;
      li[q] = IMAX;
    }
    float wv = -INFINITY;
    int wi = IMAX;
    for (int j = tid; j < wd; j += THREADS) {
      float lc = lp[j];
      const int c = v0 + j;
      const bool special = isnan(lc);
      if (special) lc = lpg[c];
      for (int k = 0; k < K; ++k) {
        const float v = value(k, c, lc, special);
        const int i = k * V + c;
        if (v >= tau && better(v, i, wv, wi)) insert(lv, li, wv, wi, v, i, K);
      }
    }
    for (int p = 0; p < K; ++p) {
      float v = lv[0];
      int i = li[0];
      warp_best(v, i);
      if (lane == 0) {
        s.wl_v[warp * K + p] = v;
        s.wl_i[warp * K + p] = i;
      }
      if (li[0] == i) {                               // the owner pops
#pragma unroll
        for (int q = 0; q < LK - 1; ++q) {
          lv[q] = lv[q + 1];
          li[q] = li[q + 1];
        }
        lv[LK - 1] = -INFINITY;
        li[LK - 1] = IMAX;
      }
    }
    __syncthreads();
    if (warp == 0) merge_lists(s.wl_v, s.wl_i, NWARPS, K, K, s.cl_v, s.cl_i);
  }
  __syncthreads();
  push_list(cluster, s.cl_v, s.cl_i, K, s.m_v, s.m_i);
  cluster.sync();                         // every CTA's list is in CTA 0
  if (rank != 0) return;
  rank_select(s.m_v, s.m_i, S * K, K, s.selv, s.seli);
  __syncthreads();
  if (tid == 0) stamp_epilogue(s.selv, s.seli, K);
  __syncthreads();
  if (tid < K) {
    const int i = s.seli[tid];
    const int k = i / V, c = i % V;
    const bool stay = c == blank;
    sel[ro + tid] = i;
    new_pb[ro + tid] = stay ? s.spb[k] : NEG;
    new_pnb[ro + tid] = stay ? s.spnb[k]
                             : ext_score(s, k, c, lpg[c], K, blank, true);
  }
}

// Pruned body: dynamic shared memory = work[Wmax * 32] | cb_v, cb_i [CAP]
// | cl_v, cl_i [C] | m_v, m_i [S * C] | wl_v, wl_i [NWARPS * C] | idx,
// vals [C] | cand[K*(C+1)] | extf[K*C].
template <bool SUM>
__global__ void __launch_bounds__(THREADS)
beam_step_topc_kernel(const float* __restrict__ logp,
                      const float* __restrict__ p_b,
                      const float* __restrict__ p_nb,
                      const int* __restrict__ last,
                      const int* __restrict__ phash,
                      const int* __restrict__ plen, int* __restrict__ sel,
                      float* __restrict__ new_pb, float* __restrict__ new_pnb,
                      int K, int V, int C, int blank, int max_len, int Wmax) {
  extern __shared__ float dyn[];
  __shared__ Shared s;
  cg::cluster_group cluster = cg::this_cluster();
  const int S = (int)cluster.num_blocks();
  const int rank = (int)cluster.block_rank();
  const int b = blockIdx.x / S;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  float* work = dyn;
  float* cb_v = work + Wmax * 32;
  int* cb_i = reinterpret_cast<int*>(cb_v + CAP);
  float* cl_v = reinterpret_cast<float*>(cb_i + CAP);
  int* cl_i = reinterpret_cast<int*>(cl_v + C);
  float* m_v = reinterpret_cast<float*>(cl_i + C);
  int* m_i = reinterpret_cast<int*>(m_v + S * C);
  float* wl_v = reinterpret_cast<float*>(m_i + S * C);
  int* wl_i = reinterpret_cast<int*>(wl_v + NWARPS * C);
  int* idx = wl_i + NWARPS * C;
  float* vals = reinterpret_cast<float*>(idx + C);
  float* cand = vals + C;
  float* extf = cand + K * (C + 1);
  int v0, v1;
  slice_of(V, rank, S, v0, v1);
  const int wd = v1 - v0;
  const float* lpg = logp + (size_t)b * V;
  const size_t ro = (size_t)b * K;
  if (tid == 0) s.count = 0;
  for (int q = tid; q < C; q += THREADS) {
    cl_v[q] = -INFINITY;
    cl_i[q] = IMAX;
  }
  ParentIn in{};
  if (tid < K)
    in = load_parent(lpg, p_b + ro, p_nb + ro, last + ro, phash + ro,
                     plen + ro, tid, blank);
  load_slice(work, lpg + v0, wd);
  __syncthreads();

  // the slice's top C tokens: tau, the C-th best of the 16 warps' best
  // (C <= 16), bounds them; the tokens at or above it are ranked
  float bv = -INFINITY;
  int bi = IMAX;
#pragma unroll 4
  for (int j = tid; j < wd; j += THREADS)
    if (better(work[j], v0 + j, bv, bi)) {
      bv = work[j];
      bi = v0 + j;
    }
  warp_best(bv, bi);
  if (lane == 0) {
    s.red_v[warp] = bv;
    s.red_i[warp] = bi;
  }
  __syncthreads();
  float tau = -INFINITY;
  if (C <= NWARPS) {
    float v = -INFINITY;
    int rk = NWARPS;
    if (lane < NWARPS) {
      v = s.red_v[lane];
      const int i = s.red_i[lane];
      rk = 0;
      for (int w = 0; w < NWARPS; ++w)
        rk += better(s.red_v[w], s.red_i[w], v, i) ? 1 : 0;
    }
    tau = rk < C ? v : INFINITY;
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      tau = fminf(tau, __shfl_xor_sync(0xffffffffu, tau, off));
  }
  for (int j = tid; j < wd; j += THREADS) {
    if (!(work[j] >= tau)) continue;
    const int at = atomicAdd(&s.count, 1);
    if (at < CAP) {
      cb_v[at] = work[j];
      cb_i[at] = v0 + j;
    }
  }
  __syncthreads();
  const int n = s.count;
  if (n <= CAP) {
    rank_select(cb_v, cb_i, n, C, cl_v, cl_i);
  } else {
    // past CAP (C > 16, or ties at tau): per warp C rounds over its
    // lanes' best, the owner marking its token taken (NaN never wins) and
    // rescanning its own; warp 0 merges the 16 lists
    const auto scan = [&]() {
      bv = -INFINITY;
      bi = IMAX;
      for (int j = tid; j < wd; j += THREADS)
        if (better(work[j], v0 + j, bv, bi)) {
          bv = work[j];
          bi = v0 + j;
        }
    };
    scan();
    for (int q = 0; q < C; ++q) {
      float v = bv;
      int i = bi;
      warp_best(v, i);
      if (lane == 0) {
        wl_v[warp * C + q] = v;
        wl_i[warp * C + q] = i;
      }
      if (bi == i && i != IMAX) {
        work[i - v0] = NAN;
        scan();
      }
    }
    __syncthreads();
    if (warp == 0) merge_lists(wl_v, wl_i, NWARPS, C, C, cl_v, cl_i);
  }
  beam_scalars<SUM, true>(s, in, K, blank, max_len);   // ends in a barrier
  push_list(cluster, cl_v, cl_i, C, m_v, m_i);
  cluster.sync();                         // every CTA's list is in CTA 0
  if (rank != 0) return;
  rank_select(m_v, m_i, S * C, C, vals, idx);
  __syncthreads();
  if (tid == 0) stamp_epilogue(vals, idx, C);
  __syncthreads();
  for (int q = tid; q < C; q += THREADS)
    vals[q] = lpg[idx[q]];                  // gathered from the original row
  __syncthreads();

  // the (K, C+1) candidate grid, column 0 of each parent its stay
  for (int e = tid; e < K * C; e += THREADS) {
    const int k = e / C, q = e % C;
    const float v = ext_score(s, k, idx[q], vals[q], K, blank, false);
    extf[e] = v;
    cand[k * (C + 1) + 1 + q] = v;
  }
  if (tid < K) cand[tid * (C + 1)] = s.stot[tid];
  __syncthreads();
  // K argmax passes, each selected entry stamped to NEG (beam.py's
  // _top_k_passes), in warp 0
  if (warp == 0) {
    const int nc = K * (C + 1);
    for (int p = 0; p < K; ++p) {
      float v = -INFINITY;
      int i = IMAX;
      for (int e = lane; e < nc; e += 32)
        if (better(cand[e], e, v, i)) {
          v = cand[e];
          i = e;
        }
      warp_best(v, i);
      if (lane == 0) {
        s.seli[p] = i;
        cand[i] = NEG;
      }
      __syncwarp();
    }
  }
  __syncthreads();
  if (tid < K) {
    const int sc = s.seli[tid];
    const int k = sc / (C + 1), within = sc % (C + 1);
    const bool stay = within == 0;
    const int qq = min(max(within - 1, 0), C - 1);
    const int c = stay ? blank : idx[qq];
    sel[ro + tid] = k * V + c;
    new_pb[ro + tid] = stay ? s.spb[k] : NEG;
    new_pnb[ro + tid] = stay ? s.spnb[k] : extf[k * C + qq];
  }
}

// dynamic shared memory of one CTA of S, Wmax 32-token words of the
// widest slice (decode/kernel.smem_bytes mirrors it)
size_t smem_bytes(int K, int C, int S, int Wmax) {
  if (C)
    return 4 * ((size_t)Wmax * 32 + 2 * (size_t)CAP + 2 * (size_t)C +
                2 * (size_t)S * C + 2 * (size_t)NWARPS * C + 2 * (size_t)C +
                (size_t)K * (C + 1) + (size_t)K * C);
  return 4 * (size_t)Wmax * 32;
}

// `allowed`: the dynamic shared memory the kernel is opted in to so far
// (its static Shared and the dynamic part share the 48 KB default)
template <typename F, typename... Args>
cudaError_t launch(F kernel, int& allowed, int B, int S, size_t smem,
                   cudaStream_t st, Args... args) {
  if ((int)smem > allowed) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
    allowed = (int)smem;
  }
  cudaLaunchConfig_t cfg = {};
  cudaLaunchAttribute attr[1];
  cfg.gridDim = dim3((unsigned)(B * S));
  cfg.blockDim = dim3(THREADS);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = st;
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = S;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const cudaError_t err = cudaLaunchKernelEx(&cfg, kernel, args...);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

}  // namespace

// logp (B, V) f32; p_b/p_nb (B, K) f32; last/phash/plen (B, K) i32 ->
// sel (B, K) i32 indexing the K*V grid, new_pb/new_pnb (B, K) f32; each
// row a cluster of `slices` CTAs (1..8, decode.kernel.beam_slices).
extern "C" int beam_step(const void* logp, const void* p_b, const void* p_nb,
                         const void* last, const void* phash,
                         const void* plen, void* sel, void* new_pb,
                         void* new_pnb, int B, int K, int V, int blank,
                         int max_len, int semiring_sum, int topc, int slices,
                         void* stream) {
  if (B < 1 || K < 1 || K > MAXK || V < K || blank < 0 || blank >= V ||
      topc < 0 || topc >= V || slices < 1 || slices > MAX_SLICES ||
      slices > V || (long long)K * V > 0x7fffffffLL)
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
  const int Wmax = ((V + slices - 1) / slices + 31) / 32;
  const size_t smem = smem_bytes(K, topc, slices, Wmax);
  const int S = slices;
  const int sum = semiring_sum ? 1 : 0;
  static int allowed[3][2] = {};        // per kernel: see `launch`
  cudaError_t err;
  if (topc > 0) {
    err = sum ? launch(beam_step_topc_kernel<true>, allowed[0][1], B, S, smem,
                       st, lp, pb, pnb, la, ph, pl, se, npb, npnb, K, V,
                       topc, blank, max_len, Wmax)
              : launch(beam_step_topc_kernel<false>, allowed[0][0], B, S,
                       smem, st, lp, pb, pnb, la, ph, pl, se, npb, npnb, K,
                       V, topc, blank, max_len, Wmax);
  } else if (K <= 8) {
    err = sum ? launch(beam_step_kernel<true, 8>, allowed[1][1], B, S, smem,
                       st, lp, pb, pnb, la, ph, pl, se, npb, npnb, K, V,
                       blank, max_len, Wmax)
              : launch(beam_step_kernel<false, 8>, allowed[1][0], B, S, smem,
                       st, lp, pb, pnb, la, ph, pl, se, npb, npnb, K, V,
                       blank, max_len, Wmax);
  } else {
    err = sum ? launch(beam_step_kernel<true, 16>, allowed[2][1], B, S, smem,
                       st, lp, pb, pnb, la, ph, pl, se, npb, npnb, K, V,
                       blank, max_len, Wmax)
              : launch(beam_step_kernel<false, 16>, allowed[2][0], B, S, smem,
                       st, lp, pb, pnb, la, ph, pl, se, npb, npnb, K, V,
                       blank, max_len, Wmax);
  }
  return (int)err;
}
