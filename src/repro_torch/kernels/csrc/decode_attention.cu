// Single-query GQA decode attention over a bf16 KV cache, dense (K7) or
// paged (K8), hand-written for sm_90a.
//
// Replaces the TPU kernels K7 and K8 of src/repro/kernels/
// decode_attention.py: `decode_attention` (pallas_call at :216) and
// `paged_decode_attention` (pallas_call at :294), whose shared tile body
// is `_attend_tile` (:101).  On the TPU the grid is (B, KV, S / block_s)
// with the S axis sequential: the (M, E) query block and the f32
// online-softmax carry (acc (M, E), m and l (M, 1)) stay in VMEM while
// the cache streams through one tile per grid step.
//
// What bounds it on the H100: the bytes.  A call reads q, the admitted
// rows of K and V (E bf16 = 128 B per row at E = 64) and writes the
// (H, E) output: 0.1-1.5 MB at serving shapes, under a microsecond at
// 3.35 TB/s, while the work is 4·M·E f32 operations per row.  One CTA per
// (batch row, KV head) gives 5-64 CTAs for the card's 132 SMs (5 at one
// request of smollm-360m), each walking its whole stripe of the cache in
// series: a call is then bound by one CTA's walk, not by the card.  So:
//
// * The admitted rows [lo, hi) — lo = max(0, pos - window + 1), hi =
//   pos + 1 (canonical) or pos (delta), both clipped to S — are cut into
//   n_split contiguous splits of whole block_s-row tiles (the wrapper's
//   `decode_plan`: as many as the card runs B·KV clusters of at once —
//   `decode_attention_clusters` below — none shorter than 32 rows, at
//   most 16).  Split k takes tiles [n_tiles·k / n, n_tiles·(k + 1) / n)
//   of the range's tiles, clipped to [lo, hi), so every split holds
//   admitted rows only and none is empty; rows before the window are
//   never read.  The n_split CTAs of one (row, KV head) form one
//   thread-block cluster.
// * A CTA copies its rows into shared memory with 16-byte cp.async
//   (rounds of up to 16 KB of K rows, 128 at E = 64, and as much of V;
//   two buffers when a split needs more than one round), all of a
//   round's rows in flight at once: one copy -> wait per round, not per
//   tile.  The dense rows are issued before q is loaded; the paged kernel
//   first stages the round's page-table entries in shared memory, then
//   gathers every row of the round from its page; an id outside
//   [0, n_pages) reads zeros.
// * Rows, not query heads, are spread over the 4 warps: a row is read by
//   a group of G lanes (the next power of two >= E / 8), each lane
//   holding one 16-byte chunk (8 columns) of the row's K and V, so a
//   warp takes 32 / G rows a step and no lane idles at any M.  Each group
//   scores two rows at a time against all M queries (q's chunks in
//   registers up to M = 5; the dots of all heads first, then their group
//   sums by shuffles, then the carries, so that the heads' chains
//   interleave) and keeps its own online-softmax carry (m, l, and acc for
//   its 8 columns) in f32 registers.  Scores are in log2 units (scale ·
//   log2 e) for exp2; a carry keeps its max until a score passes it by 8
//   (p < 2^8), so most rows need no rescale and one warp vote skips it.
//   p stays f32, as the reference keeps it.
// * The merge, in a fixed order, in one launch: a warp's groups by a
//   butterfly in which every pair combines (lower group, upper group);
//   the CTA's warps in warp order through shared memory, the delta
//   variant's new column (score q·k_new, p = 1 at its own max) first in
//   split 0.  The CTA's partial (acc (M, E), m, l) goes straight into
//   its slot in rank 0's shared memory (distributed shared memory; rank
//   0 lends its round buffers once its own walk is done, which the
//   cluster barrier's first phase waits for); each CTA then arrives on
//   the barrier with release and leaves, and rank 0 waits, weighs the
//   slots in rank order and writes acc / max(l, 1e-30) in bf16.  No
//   workspace, no atomics: two calls give the same bits.
//
// The sums are not the old kernel's (one chain per output column over
// tile after tile): each split and lane group sums its own rows against
// its own reference max, and the partials meet as above, so the
// f32 rounding differs within the reference's tolerance.  Dense and
// paged still differ only in where a row's bytes come from: both take
// one plan (block_s = the page size P, split edges on page edges, the
// split bound of the two kernels' smaller cluster capacity), one round
// structure and one walk, so the paged kernel over contiguous pages
// equals the dense one at block_s = P bit for bit (the reference's
// contract, :104-107).
//
// No tensor cores: the call is byte-bound (a wgmma would save
// instructions on a few hundred rows, not bytes), and the products p·V
// would need p rounded to bf16, which leaves the reference's f32
// numerics.

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

namespace cg = cooperative_groups;

constexpr int THREADS = 128;
constexpr int NWARPS = THREADS / 32;
constexpr int MAX_M = 16;                 // query heads per KV head
constexpr int MAX_E = 256;
constexpr int MAX_SPLIT = 16;             // CTAs of one cluster
constexpr int UNR = 2;                    // rows a lane group takes a pass
constexpr size_t MAX_SMEM = 232448;       // opt-in shared memory of a CTA
constexpr float NEG_INF = -1e30f;
constexpr float LOG2E = 1.4426950408889634f;
// a group's carry keeps its max until a score passes it by this much
// (log2 units): p then stays below 2^8, and most rows need no rescale
constexpr float RESCALE = 8.f;

struct Args {
  const __nv_bfloat16* q;      // (B, H, E)
  const __nv_bfloat16* k;      // dense (B, S, KV, E); paged (pages, P, KV, E)
  const __nv_bfloat16* v;
  const __nv_bfloat16* k_new;  // (B, KV, E), delta variant only
  const __nv_bfloat16* v_new;
  const int* table;            // (B, W), paged only
  __nv_bfloat16* out;          // (B, H, E)
  int S;                       // logical cache length (paged: W * P)
  int KV, M, E;
  int block_s;                 // split alignment (paged: the page size P)
  int W, n_pages;
  int lo, hi;                  // admitted old rows [lo, hi)
  int rows;                    // rows of one shared-memory round (run())
  int n_buf;                   // 1, or 2 when a split takes several rounds
  float scale;
};

__host__ __device__ constexpr size_t align16(size_t x) {
  return (x + 15) & ~(size_t)15;
}

// Byte offsets of the dynamic shared memory.
struct Layout {
  size_t recv, q, misc, tb, total;
};

// one partial: acc (M, E), then m (M) and l (M), f32
__host__ __device__ inline int part_floats(int M, int E) {
  return M * E + 2 * M;
}

// lane groups of a CTA: a group of G lanes (the next power of two >=
// E / 8) reads a row
__host__ __device__ inline int group_lanes(int E) {
  int G = 1;
  while (G < E / 8) G <<= 1;
  return G;
}

__host__ __device__ inline Layout layout(int rows, int n_buf, int M, int E,
                                         bool paged, int n_split) {
  Layout L;
  // the round buffers; once the walk is done, the warps' partials and
  // then the cluster's partials, one slot a rank (rank 0's are read)
  const size_t buf = (size_t)n_buf * rows * 2 * E * 2;
  const size_t part = (size_t)NWARPS * part_floats(M, E) * 4;
  L.recv = part;
  const size_t recv = part + (size_t)n_split * part_floats(M, E) * 4;
  size_t o = align16(buf > recv ? buf : recv);
  L.q = o;    o += align16((size_t)M * E * 4);     // q (M, E) f32
  L.misc = o; o += align16((size_t)(M + 2 * E) * 4);  // s_new, k/v_new
  L.tb = o;   if (paged) o += align16((size_t)2 * (rows + 1) * 4);
  L.total = o;
  return L;
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           int src_bytes) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d),
               "l"(src), "r"(src_bytes));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// the cluster barrier in two halves: arrive (release, or relaxed) and
// wait (acquire), every thread of every CTA
__device__ __forceinline__ void cluster_arrive_relaxed() {
  asm volatile("barrier.cluster.arrive.relaxed.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

// head m's chunk c of q (zeros past M or past the row)
__device__ __forceinline__ void load_q(const float* qs, int m, int M, int E,
                                       int c, bool c_ok, float* qf) {
  if (m < M && c_ok) {
    const float* qm = qs + m * E + c * 8;
    const float4 q0 = *reinterpret_cast<const float4*>(qm);
    const float4 q1 = *reinterpret_cast<const float4*>(qm + 4);
    qf[0] = q0.x; qf[1] = q0.y; qf[2] = q0.z; qf[3] = q0.w;
    qf[4] = q1.x; qf[5] = q1.y; qf[6] = q1.z; qf[7] = q1.w;
  } else {
#pragma unroll
    for (int j = 0; j < 8; ++j) qf[j] = 0.f;
  }
}

__device__ __forceinline__ void bf16x8_to_f32(const uint4& raw, float* f) {
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 x = __bfloat1622float2(h[i]);
    f[2 * i] = x.x;
    f[2 * i + 1] = x.y;
  }
}

// MG: query heads the registers hold (M <= MG), taken HC at a time so
// that the heads' chains interleave; heads M .. MG - 1 score zeros and
// are never written.
template <bool PAGED, bool DELTA, int MG>
__global__ void __launch_bounds__(THREADS)
    decode_attn_kernel(const Args a) {
  constexpr int HC = MG <= 5 ? MG : (MG <= 8 ? 4 : 2);
  constexpr int QPT = (MG * MAX_E + THREADS - 1) / THREADS;  // q per thread
  constexpr int NPT = (2 * MAX_E + THREADS - 1) / THREADS;   // k/v_new
  constexpr bool QREG = MG <= 5;             // q's chunks held in registers
  static_assert(MG % HC == 0, "head chunks");
  extern __shared__ __align__(16) unsigned char smem[];
  cg::cluster_group cluster = cg::this_cluster();
  const int n_split = (int)cluster.num_blocks();
  const int rank = (int)cluster.block_rank();
  // the cluster barrier's first phase: every CTA runs, and rank 0 is
  // done with its round buffers (it arrives after its walk); the first
  // store into rank 0 waits for it
  if (rank != 0) cluster_arrive_relaxed();
  const int g = blockIdx.y, b = blockIdx.z;
  const int E = a.E, M = a.M, H = a.KV * M, R = a.rows;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const float scale2 = a.scale * LOG2E;      // scores in log2 units
  const Layout L = layout(R, a.n_buf, M, E, PAGED, n_split);
  __nv_bfloat16* buf = reinterpret_cast<__nv_bfloat16*>(smem);
  float* qs = reinterpret_cast<float*>(smem + L.q);
  float* recv = reinterpret_cast<float*>(smem + L.recv);
  const int PS = part_floats(M, E);
  float* snew = reinterpret_cast<float*>(smem + L.misc);
  float* kvn = snew + M;                     // k_new, v_new (f32)
  int* tbs = reinterpret_cast<int*>(smem + L.tb);

  // this split's rows [t_begin, t_end): whole tiles, clipped to [lo, hi)
  const int bs = a.block_s;
  const int s0 = a.lo / bs;
  const int n_tiles = a.hi > a.lo ? (a.hi + bs - 1) / bs - s0 : 0;
  int t_begin = a.lo, t_end = a.lo;
  if (n_tiles > 0) {
    const int k0 = (int)((long long)n_tiles * rank / n_split);
    const int k1 = (int)((long long)n_tiles * (rank + 1) / n_split);
    t_begin = max(a.lo, (s0 + k0) * bs);
    t_end = min(a.hi, (s0 + k1) * bs);
  }
  const int n_rows = max(0, t_end - t_begin);
  const int n_rounds = (n_rows + R - 1) / R;
  const int cpr = E / 8;                     // 16-byte chunks of a row
  const int P = bs;
  // the copies: thread (my_r, my_c) takes chunk my_c of rows my_r,
  // my_r + rpp, ...
  const int rpp = THREADS / cpr, my_r = tid / cpr, my_c = tid - my_r * cpr;

  // paged: the page ids of round k's rows into tbs[k & 1]
  auto stage = [&](int k) {
    const int t0 = t_begin + k * R, n = min(R, t_end - t0);
    const int w0 = t0 / P, nw = (t0 + n - 1) / P - w0 + 1;
    int* tb = tbs + (k & 1) * (R + 1);
    for (int j = tid; j < nw; j += THREADS)
      tb[j] = a.table[(size_t)b * a.W + w0 + j];
  };
  // round k's rows of K and V into buffer k & (n_buf - 1), zero-filled
  // behind a page id outside the pool
  auto issue = [&](int k) {
    const int t0 = t_begin + k * R, n = min(R, t_end - t0);
    __nv_bfloat16* kb = buf + (size_t)(k & (a.n_buf - 1)) * 2 * R * E;
    __nv_bfloat16* vb = kb + (size_t)R * E;
    const int w0 = t0 / P;
    const int* tb = tbs + (k & 1) * (R + 1);
    for (int r = my_r; r < n && my_r < rpp; r += rpp) {
      const int t = t0 + r;
      size_t row = 0;
      bool ok = true;
      if (PAGED) {
        const int w = t / P;
        const int page = tb[w - w0];
        ok = page >= 0 && page < a.n_pages;
        if (ok) row = ((size_t)page * P + (t - w * P)) * a.KV + g;
      } else {
        row = ((size_t)b * a.S + t) * a.KV + g;
      }
      const size_t off = row * E + (size_t)my_c * 8;
      const size_t dst = (size_t)r * E + my_c * 8;
      cp_async16(kb + dst, a.k + off, ok ? 16 : 0);
      cp_async16(vb + dst, a.v + off, ok ? 16 : 0);
    }
    cp_async_commit();
  };

  // q and the new column are loaded while the dense rows' copies are
  // issued; the paged rows wait for their page ids, loaded beside them
  const bool fold = DELTA && rank == 0;      // split 0 folds the new column
  const __nv_bfloat16* qg = a.q + ((size_t)b * H + (size_t)g * M) * E;
  const size_t nrow = ((size_t)b * a.KV + g) * E;
  __nv_bfloat16 qv[QPT], nv[NPT];
#pragma unroll
  for (int u = 0; u < QPT; ++u)
    if (tid + u * THREADS < M * E) qv[u] = qg[tid + u * THREADS];
#pragma unroll
  for (int u = 0; u < NPT; ++u) {
    const int i = tid + u * THREADS;
    if (fold && i < 2 * E) nv[u] = i < E ? a.k_new[nrow + i]
                                         : a.v_new[nrow + i - E];
  }
  if (!PAGED && n_rounds > 0) issue(0);
  if (PAGED && n_rounds > 0) stage(0);
#pragma unroll
  for (int u = 0; u < QPT; ++u)
    if (tid + u * THREADS < M * E)
      qs[tid + u * THREADS] = __bfloat162float(qv[u]);
#pragma unroll
  for (int u = 0; u < NPT; ++u)
    if (fold && tid + u * THREADS < 2 * E)
      kvn[tid + u * THREADS] = __bfloat162float(nv[u]);
  __syncthreads();                  // qs, k/v_new and round 0's page ids
  if (PAGED && n_rounds > 0) issue(0);
  if (fold) {
    // the new token's score, while round 0 is in flight
    for (int m = warp; m < M; m += NWARPS) {
      float dot = 0.f;
      for (int e = lane; e < E; e += 32)
        dot = fmaf(qs[m * E + e], kvn[e], dot);
      dot = warp_sum(dot);
      if (lane == 0) snew[m] = dot * scale2;
    }
  }

  // the lane group of a row: G lanes, lane c of it holding columns
  // 8c .. 8c + 7
  const int G = group_lanes(E);
  const int rpw = 32 / G, grp = lane / G, c = lane % G;
  const bool c_ok = c < cpr;
  const int step = NWARPS * rpw;             // rows of one CTA step
  float m_i[MG], l_i[MG], acc[MG][8];
  float qr[QREG ? MG : 1][8];
#pragma unroll
  for (int m = 0; m < MG; ++m) {
    m_i[m] = NEG_INF;
    l_i[m] = 0.f;
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[m][j] = 0.f;
    if (QREG) load_q(qs, m, M, E, c, c_ok, qr[QREG ? m : 0]);
  }

  for (int k = 0; k < n_rounds; ++k) {
    if (k + 1 < n_rounds) {
      if (PAGED) {
        stage(k + 1);
        __syncthreads();
      }
      issue(k + 1);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();                         // round k has landed
    const __nv_bfloat16* kb =
        buf + (size_t)(k & (a.n_buf - 1)) * 2 * R * E;
    const __nv_bfloat16* vb = kb + (size_t)R * E;
    const int n = min(R, t_end - (t_begin + k * R));
    // r0 is warp-uniform, so every lane reaches every shuffle
    for (int r0 = warp * rpw; r0 < n; r0 += UNR * step) {
      bool ok[UNR];
      float kf[UNR][8], vf[UNR][8];
#pragma unroll
      for (int u = 0; u < UNR; ++u) {
        const int r = r0 + grp + u * step;
        ok[u] = r < n;
        uint4 kr = make_uint4(0, 0, 0, 0), vr = kr;
        if (ok[u] && c_ok) {
          kr = *reinterpret_cast<const uint4*>(kb + (size_t)r * E + c * 8);
          vr = *reinterpret_cast<const uint4*>(vb + (size_t)r * E + c * 8);
        }
        bf16x8_to_f32(kr, kf[u]);
        bf16x8_to_f32(vr, vf[u]);
      }
#pragma unroll
      for (int m0 = 0; m0 < MG; m0 += HC) {
        if (m0 >= M) break;
        // the chunk's dot products, then their group sums, then the
        // carries: independent across heads and rows
        float d[HC][UNR];
#pragma unroll
        for (int h = 0; h < HC; ++h) {
          float qs_f[8];
          if (!QREG) load_q(qs, m0 + h, M, E, c, c_ok, qs_f);
          const float* qf = QREG ? qr[QREG ? m0 + h : 0] : qs_f;
#pragma unroll
          for (int u = 0; u < UNR; ++u) {
            float dot = 0.f;
#pragma unroll
            for (int j = 0; j < 8; ++j) dot = fmaf(qf[j], kf[u][j], dot);
            d[h][u] = dot;
          }
        }
        for (int o = G >> 1; o > 0; o >>= 1) {
#pragma unroll
          for (int h = 0; h < HC; ++h)
#pragma unroll
            for (int u = 0; u < UNR; ++u)
              d[h][u] += __shfl_xor_sync(0xffffffffu, d[h][u], o);
        }
        // a carry whose max a score passes by RESCALE moves to it; one
        // vote skips the rescale for the whole warp when none does
        float smax[HC];
        bool any = false;
#pragma unroll
        for (int h = 0; h < HC; ++h) {
          smax[h] = NEG_INF;
#pragma unroll
          for (int u = 0; u < UNR; ++u) {
            d[h][u] *= scale2;
            if (ok[u]) smax[h] = fmaxf(smax[h], d[h][u]);
          }
          any |= smax[h] > m_i[m0 + h] + RESCALE;
        }
        if (__any_sync(0xffffffffu, any)) {
#pragma unroll
          for (int h = 0; h < HC; ++h) {
            const int m = m0 + h;
            if (!(smax[h] > m_i[m] + RESCALE)) continue;
            const float alpha = exp2f(m_i[m] - smax[h]);
            l_i[m] *= alpha;
#pragma unroll
            for (int j = 0; j < 8; ++j) acc[m][j] *= alpha;
            m_i[m] = smax[h];
          }
        }
#pragma unroll
        for (int h = 0; h < HC; ++h) {
          const int m = m0 + h;
          float p[UNR], psum = 0.f;
#pragma unroll
          for (int u = 0; u < UNR; ++u) {
            p[u] = ok[u] ? exp2f(d[h][u] - m_i[m]) : 0.f;
            psum += p[u];
          }
          l_i[m] += psum;
#pragma unroll
          for (int j = 0; j < 8; ++j) {
            float x = acc[m][j];
#pragma unroll
            for (int u = 0; u < UNR; ++u) x = fmaf(p[u], vf[u][j], x);
            acc[m][j] = x;
          }
        }
      }
    }
    __syncthreads();                // every warp is done with the buffer
  }

  if (rank == 0) cluster_arrive();          // release: the buffers are free
  // a warp's groups: butterfly, each pair combined as (lower, upper)
  for (int off = G; off < 32; off <<= 1) {
    const bool upper = (lane & off) != 0;
#pragma unroll
    for (int m = 0; m < MG; ++m) {           // all MG: the heads interleave
      const float mo = __shfl_xor_sync(0xffffffffu, m_i[m], off);
      const float lo = __shfl_xor_sync(0xffffffffu, l_i[m], off);
      const float ma = upper ? mo : m_i[m], mb = upper ? m_i[m] : mo;
      const float la = upper ? lo : l_i[m], lb = upper ? l_i[m] : lo;
      const float mx = fmaxf(ma, mb);
      const float wa = exp2f(ma - mx), wb = exp2f(mb - mx);
      l_i[m] = fmaf(la, wa, lb * wb);
      m_i[m] = mx;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const float xo = __shfl_xor_sync(0xffffffffu, acc[m][j], off);
        const float xa = upper ? xo : acc[m][j], xb = upper ? acc[m][j] : xo;
        acc[m][j] = fmaf(xa, wa, xb * wb);
      }
    }
  }
  // the warps' partials, over the round buffers (free since the last
  // round's barrier): acc (NWARPS, M, E), then m and l (NWARPS, M)
  float* part = reinterpret_cast<float*>(smem);
  float* wm = part + (size_t)NWARPS * M * E;
  float* wl = wm + NWARPS * M;
  if (lane < G && c_ok) {
#pragma unroll
    for (int m = 0; m < MG; ++m) {
      if (m >= M) break;
      float* dst = part + ((size_t)warp * M + m) * E + c * 8;
      *reinterpret_cast<float4*>(dst) =
          make_float4(acc[m][0], acc[m][1], acc[m][2], acc[m][3]);
      *reinterpret_cast<float4*>(dst + 4) =
          make_float4(acc[m][4], acc[m][5], acc[m][6], acc[m][7]);
    }
  }
  if (lane == 0) {
#pragma unroll
    for (int m = 0; m < MG; ++m) {
      if (m >= M) break;
      wm[warp * M + m] = m_i[m];
      wl[warp * M + m] = l_i[m];
    }
  }
  __syncthreads();
  // the CTA's partial, into its slot of rank 0's shared memory: the new
  // column first (split 0, delta), then the warps in order; each
  // element's thread weighs its head's partials
  cluster_wait();
  float* slot = cluster.map_shared_rank(recv, 0) + (size_t)rank * PS;
  for (int j = tid; j < M * E; j += THREADS) {
    const int m = j / E, e = j - m * E;
    float mw[NWARPS];
    float mx = fold ? snew[m] : NEG_INF;
#pragma unroll
    for (int w = 0; w < NWARPS; ++w) {
      mw[w] = wm[w * M + m];
      mx = fmaxf(mx, mw[w]);
    }
    float x = 0.f, l = 0.f;
    if (fold) {
      l = exp2f(snew[m] - mx);
      x = l * kvn[E + e];
    }
#pragma unroll
    for (int w = 0; w < NWARPS; ++w) {
      const float f = exp2f(mw[w] - mx);
      x = fmaf(part[(size_t)w * M * E + j], f, x);
      l = fmaf(wl[w * M + m], f, l);
    }
    slot[j] = x;
    if (e == 0) {
      slot[M * E + m] = mx;
      slot[M * E + M + m] = l;
    }
  }
  cluster_arrive();               // release: this CTA's slot is written
  if (rank != 0) return;          // no CTA reads the others' memory
  cluster_wait();

  // rank 0: the cluster's partials in rank order
  __nv_bfloat16* o = a.out + ((size_t)b * H + (size_t)g * M) * E;
  for (int j = tid; j < M * E; j += THREADS) {
    const int m = j / E;
    float mx = NEG_INF;
    for (int r = 0; r < n_split; ++r)
      mx = fmaxf(mx, recv[(size_t)r * PS + M * E + m]);
    float x = 0.f, l = 0.f;
    for (int r = 0; r < n_split; ++r) {
      const float* pr = recv + (size_t)r * PS;
      const float f = exp2f(pr[M * E + m] - mx);
      x = fmaf(pr[j], f, x);
      l = fmaf(pr[M * E + M + m], f, l);
    }
    o[j] = __float2bfloat16(x / fmaxf(l, 1e-30f));
  }
}

int round_max(int E) { return min(256, 8192 / E); }  // 16 KB of K a round

// the most shared memory a launch of n_split at (M, E) takes: two full
// rounds
size_t smem_max(int M, int E, bool paged, int n_split) {
  return layout(round_max(E), 2, M, E, paged, n_split).total;
}

// the kernel, its attributes set (once per instantiation) for launches
// of up to smem bytes and clusters of up to 16
template <bool PAGED, bool DELTA, int MG>
cudaError_t prepare(size_t smem) {
  auto kern = decode_attn_kernel<PAGED, DELTA, MG>;
  static size_t smem_set = 0;
  static bool nonportable = false;
  cudaError_t err = cudaSuccess;
  if (smem > smem_set) {
    err = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
    smem_set = smem;
  }
  if (!nonportable) {
    err = cudaFuncSetAttribute(
        kern, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    nonportable = err == cudaSuccess;
  }
  return err;
}

cudaLaunchConfig_t config(cudaLaunchAttribute* attr, int n_split, int KV,
                          int B, size_t smem, cudaStream_t st) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)n_split, (unsigned)KV, (unsigned)B);
  cfg.blockDim = dim3(THREADS);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = st;
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = n_split;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cfg;
}

template <bool PAGED, bool DELTA, int MG>
int launch(const Args& a, int B, int n_split, size_t smem, cudaStream_t st) {
  cudaError_t err =
      prepare<PAGED, DELTA, MG>(smem_max(a.M, a.E, PAGED, n_split));
  if (err != cudaSuccess) return (int)err;
  cudaLaunchAttribute attr[1];
  const cudaLaunchConfig_t cfg = config(attr, n_split, a.KV, B, smem, st);
  err = cudaLaunchKernelEx(&cfg, decode_attn_kernel<PAGED, DELTA, MG>, a);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

template <bool PAGED, bool DELTA, int MG>
int clusters(int M, int E, int n_split) {
  const size_t smem = smem_max(M, E, PAGED, n_split);
  if (smem > MAX_SMEM) return 0;
  cudaError_t err = prepare<PAGED, DELTA, MG>(smem);
  if (err != cudaSuccess) return -(int)err;
  cudaLaunchAttribute attr[1];
  const cudaLaunchConfig_t cfg = config(attr, n_split, 1, 1, smem, 0);
  int n = 0;
  err = cudaOccupancyMaxActiveClusters(
      &n, decode_attn_kernel<PAGED, DELTA, MG>, &cfg);
  return err == cudaSuccess ? n : -(int)err;
}

template <bool PAGED, bool DELTA>
int launch_m(const Args& a, int B, int n_split, size_t smem,
             cudaStream_t st) {
  if (a.M <= 3) return launch<PAGED, DELTA, 3>(a, B, n_split, smem, st);
  if (a.M <= 5) return launch<PAGED, DELTA, 5>(a, B, n_split, smem, st);
  if (a.M <= 8) return launch<PAGED, DELTA, 8>(a, B, n_split, smem, st);
  return launch<PAGED, DELTA, 16>(a, B, n_split, smem, st);
}

template <bool PAGED, bool DELTA>
int clusters_m(int M, int E, int n_split) {
  if (M <= 3) return clusters<PAGED, DELTA, 3>(M, E, n_split);
  if (M <= 5) return clusters<PAGED, DELTA, 5>(M, E, n_split);
  if (M <= 8) return clusters<PAGED, DELTA, 8>(M, E, n_split);
  return clusters<PAGED, DELTA, 16>(M, E, n_split);
}

// The launch of n_split splits a (row, KV head) over [lo, hi): the round
// size and the buffers follow from the longest split (whole tiles).
int run(Args& a, int B, int n_split, void* stream) {
  if (B < 1 || a.KV < 1 || a.M < 1 || a.M > MAX_M || a.E < 8 ||
      a.E > MAX_E || a.E % 8 || a.block_s < 1 || a.S < 1 || a.lo < 0 ||
      a.hi < a.lo || a.hi > a.S || n_split < 1 || n_split > MAX_SPLIT)
    return (int)cudaErrorInvalidValue;
  if (((uintptr_t)a.k | (uintptr_t)a.v) & 15)
    return (int)cudaErrorMisalignedAddress;
  const int n_tiles =
      a.hi > a.lo ? (a.hi + a.block_s - 1) / a.block_s - a.lo / a.block_s
                  : 0;
  if (n_split > (n_tiles > 0 ? n_tiles : 1)) return (int)cudaErrorInvalidValue;
  // the longest split, in rows: one round takes it, or two buffers take
  // its rounds of round_max(E) rows in turn
  const long long most = (long long)((n_tiles + n_split - 1) / n_split) *
                         a.block_s;
  a.rows = (int)(most < round_max(a.E) ? (most > 0 ? most : 1)
                                       : round_max(a.E));
  a.n_buf = most > a.rows ? 2 : 1;
  const bool paged = a.table != nullptr;
  const size_t smem =
      layout(a.rows, a.n_buf, a.M, a.E, paged, n_split).total;
  if (smem > MAX_SMEM) return (int)cudaErrorInvalidValue;
  const cudaStream_t st = (cudaStream_t)stream;
  const bool delta = a.k_new != nullptr;
  if (paged)
    return delta ? launch_m<true, true>(a, B, n_split, smem, st)
                 : launch_m<true, false>(a, B, n_split, smem, st);
  return delta ? launch_m<false, true>(a, B, n_split, smem, st)
               : launch_m<false, false>(a, B, n_split, smem, st);
}

}  // namespace

// q (B, 1, H, E), caches (B, S, KV, E), k_new/v_new (B, 1, KV, E) or null
// (canonical variant), out (B, 1, H, E); all bf16, contiguous.  [lo, hi)
// are the admitted cache rows, cut into n_split splits of whole block_s
// tiles (`decode_plan`).
extern "C" int decode_attention(const void* q, const void* k, const void* v,
                                const void* k_new, const void* v_new,
                                void* out, int B, int S, int KV, int M, int E,
                                int block_s, int lo, int hi, int n_split,
                                float scale, void* stream) {
  Args a{(const __nv_bfloat16*)q, (const __nv_bfloat16*)k,
         (const __nv_bfloat16*)v, (const __nv_bfloat16*)k_new,
         (const __nv_bfloat16*)v_new, nullptr, (__nv_bfloat16*)out,
         S, KV, M, E, block_s, 0, 0, lo, hi, 1, 1, scale};
  if ((k_new == nullptr) != (v_new == nullptr))
    return (int)cudaErrorInvalidValue;
  return run(a, B, n_split, stream);
}

// The paged variant: pools (n_pages, P, KV, E), table (B, W) int32; the
// logical cache is W * P positions, position t at pool[table[b, t / P],
// t % P]; the splits are cut on page edges (block_s = P).
extern "C" int paged_decode_attention(const void* q, const void* k_pages,
                                      const void* v_pages, const void* table,
                                      const void* k_new, const void* v_new,
                                      void* out, int B, int n_pages, int P,
                                      int W, int KV, int M, int E, int lo,
                                      int hi, int n_split, float scale,
                                      void* stream) {
  Args a{(const __nv_bfloat16*)q, (const __nv_bfloat16*)k_pages,
         (const __nv_bfloat16*)v_pages, (const __nv_bfloat16*)k_new,
         (const __nv_bfloat16*)v_new, (const int*)table, (__nv_bfloat16*)out,
         W * P, KV, M, E, P, W, n_pages, lo, hi, 1, 1, scale};
  if ((k_new == nullptr) != (v_new == nullptr) || table == nullptr ||
      n_pages < 1 || W < 1)
    return (int)cudaErrorInvalidValue;
  return run(a, B, n_split, stream);
}

// How many clusters of n_split CTAs of the kernel for (paged, delta, M,
// E) the card runs at once, at the most shared memory such a launch
// takes (`decode_plan` keeps the grid within it: one wave); a negative
// value is a CUDA error.
extern "C" int decode_attention_clusters(int paged, int delta, int M, int E,
                                         int n_split) {
  if (M < 1 || M > MAX_M || E < 8 || E > MAX_E || E % 8 || n_split < 1 ||
      n_split > MAX_SPLIT)
    return -(int)cudaErrorInvalidValue;
  if (paged)
    return delta ? clusters_m<true, true>(M, E, n_split)
                 : clusters_m<true, false>(M, E, n_split);
  return delta ? clusters_m<false, true>(M, E, n_split)
               : clusters_m<false, false>(M, E, n_split);
}
