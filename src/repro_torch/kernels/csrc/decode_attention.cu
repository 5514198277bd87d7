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
// Here one CTA serves one (batch row b, KV head g): its M = H / KV query
// heads against that head's cache stripe, so every cache row is read once
// for all M queries of its group.  The TPU's sequential S axis becomes a
// loop inside the CTA.  The loop stops at the last tile that can hold
// t <= pos: tiles above it are never read (in the paged kernel that also
// means table entries past a request's pages are never followed).
//
// What bounds it on the H100: the bytes.  A call reads q, the (pos + 1)
// admitted rows of K and V (E bf16 = 128 B per row at E = 64) and writes
// the (H, E) output: about 0.1-1.5 MB at serving shapes, well under a
// microsecond at 3.35 TB/s, while the work is 4·M·E operations per row.
// With B·KV CTAs (5 per batch row at smollm-360m's 5 KV heads; 40 at 8
// slots) only a few of the 132 SMs work, so a call is bound by the
// latency of its serial tile walk, not by the card's bandwidth.  The
// design keeps that walk short: tiles of block_s rows are copied with
// 16-byte cp.async (zero-filled past the cache, so the ragged tail needs
// no separate masking of v) into a double buffer, the next tile's copy in
// flight while the current one is consumed.  Splitting S across CTAs
// with a merge pass is later work.
//
// Inside a tile, warp w owns query rows m = w, w + 4, ...: lane r scores
// rows r, r + 32, ... of the tile (an E-long dot product from shared
// memory, in f32), the warp reduces the tile max and the sum of p with
// butterfly shuffles, and then lane e accumulates acc[m][e] over the
// tile's rows.  Scores, the carry and the accumulator are f32; the output
// is acc / max(l, 1e-30) rounded to bf16 — the reference's numerics.
// Masking is the reference's: t <= pos (canonical) or t < pos (delta),
// pos - t < window, t < S.  In the delta variant the new token's column
// is folded into the carry's init (m = q·k_new·scale, l = 1, acc = v_new),
// so the old cache is read once and never written here.
//
// Dense and paged differ only in where a tile's rows come from: the dense
// kernel reads rows s·block_s + r of batch row b, the paged kernel reads
// row r of page table[b, s] (one page per tile, each CTA loading its own
// table entry: the TPU's scalar prefetch).  The tile walk is one device
// function, so the paged kernel equals the dense one bit for bit when the
// dense tile is one page and the pages are contiguous.  M need not be a
// power of two (smollm-360m has M = 3).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 128;
constexpr int NWARPS = THREADS / 32;
constexpr int MAX_M = 16;                 // query heads per KV head
constexpr int MAX_E = 256;
constexpr int MAX_BS = 256;               // rows per tile
constexpr int MPW = MAX_M / NWARPS;       // query rows per warp
constexpr int EPL = MAX_E / 32;           // accumulator columns per lane
constexpr int RPL = MAX_BS / 32;          // tile rows scored per lane
constexpr int PAD = 8;                    // bf16 padding of a smem row
constexpr size_t MAX_SMEM = 232448;       // opt-in shared memory of a CTA
constexpr float NEG_INF = -1e30f;

struct Args {
  const __nv_bfloat16* q;      // (B, H, E)
  const __nv_bfloat16* k;      // dense (B, S, KV, E); paged (n_pages, P, KV, E)
  const __nv_bfloat16* v;
  const __nv_bfloat16* k_new;  // (B, KV, E), delta variant only
  const __nv_bfloat16* v_new;
  const int* table;            // (B, W), paged only
  __nv_bfloat16* out;          // (B, H, E)
  int S;                       // logical cache length (paged: W * P)
  int KV, M, E;
  int block_s;                 // tile rows (paged: the page size P)
  int W, n_pages;
  int pos, win;
  float scale;
};

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

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

// Copy tile s (block_s rows of E bf16, for KV head g) into smem buffers
// ks/vs, one 16-byte cp.async per chunk; rows past the cache (or behind a
// page id outside the pool) are zero-filled.
template <bool PAGED>
__device__ __forceinline__ void issue_tile(const Args& a, int b, int g, int s,
                                           __nv_bfloat16* ks,
                                           __nv_bfloat16* vs) {
  const int E = a.E, bs = a.block_s, ld = E + PAD, cpr = E / 8;
  int page = 0;
  bool page_ok = true;
  if (PAGED) {
    page = a.table[(size_t)b * a.W + s];
    page_ok = page >= 0 && page < a.n_pages;
  }
  for (int i = threadIdx.x; i < bs * cpr; i += THREADS) {
    const int r = i / cpr, c = i - r * cpr;
    const int t = s * bs + r;
    const bool in = page_ok && t < a.S;
    size_t row = 0;
    if (in)
      row = PAGED ? ((size_t)page * bs + r) * a.KV + g
                  : ((size_t)b * a.S + t) * a.KV + g;
    const size_t off = row * E + (size_t)c * 8;
    cp_async16(ks + r * ld + c * 8, a.k + off, in ? 16 : 0);
    cp_async16(vs + r * ld + c * 8, a.v + off, in ? 16 : 0);
  }
  cp_async_commit();
}

// The online-softmax update of one tile — shared verbatim by the dense
// and paged kernels.  Warp w updates its query rows' carry (m_i, l_i,
// acc) with the tile's rows t0 .. t0 + block_s - 1.
__device__ __forceinline__ void attend_tile(
    const Args& a, int t0, int lim, const __nv_bfloat16* ks,
    const __nv_bfloat16* vs, const float* qs, float* ps, float* m_i,
    float* l_i, float (*acc)[EPL]) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int E = a.E, bs = a.block_s, ld = E + PAD, cpr = E / 8;
  float* pw = ps + warp * bs;
#pragma unroll
  for (int j = 0; j < MPW; ++j) {
    const int m = warp + NWARPS * j;
    if (m >= a.M) break;
    const float* qm = qs + m * E;
    float sv[RPL];
    float tmax = NEG_INF;
#pragma unroll
    for (int u = 0; u < RPL; ++u) {
      const int r = lane + 32 * u;
      sv[u] = NEG_INF;
      if (r >= bs) continue;
      const __nv_bfloat16* kr = ks + r * ld;
      float dot = 0.f;
      for (int c = 0; c < cpr; ++c) {
        const uint4 raw = *reinterpret_cast<const uint4*>(kr + c * 8);
        const __nv_bfloat162* k2 =
            reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
        for (int h = 0; h < 4; ++h) {
          const float2 kf = __bfloat1622float2(k2[h]);
          dot = fmaf(qm[c * 8 + 2 * h], kf.x, dot);
          dot = fmaf(qm[c * 8 + 2 * h + 1], kf.y, dot);
        }
      }
      const int t = t0 + r;
      const bool ok = t < lim && a.pos - t < a.win && t < a.S;
      sv[u] = ok ? dot * a.scale : NEG_INF;
      tmax = fmaxf(tmax, sv[u]);
    }
    const float m_new = fmaxf(m_i[j], warp_max(tmax));
    float psum = 0.f;
#pragma unroll
    for (int u = 0; u < RPL; ++u) {
      const int r = lane + 32 * u;
      if (r >= bs) continue;
      const float p = expf(sv[u] - m_new);
      pw[r] = p;
      psum += p;
    }
    const float alpha = expf(m_i[j] - m_new);
    l_i[j] = alpha * l_i[j] + warp_sum(psum);
    m_i[j] = m_new;
    __syncwarp();
#pragma unroll
    for (int i = 0; i < EPL; ++i) {
      const int e = lane + 32 * i;
      if (e >= E) break;
      float pv = 0.f;
      for (int r = 0; r < bs; ++r)
        pv = fmaf(pw[r], __bfloat162float(vs[r * ld + e]), pv);
      acc[j][i] = acc[j][i] * alpha + pv;
    }
    __syncwarp();      // pw is rewritten by this warp's next query row
  }
}

template <bool PAGED, bool DELTA>
__global__ void __launch_bounds__(THREADS)
    decode_attn_kernel(const Args a) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int g = blockIdx.x, b = blockIdx.y;
  const int E = a.E, M = a.M, bs = a.block_s, ld = E + PAD;
  const int H = a.KV * M;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  __nv_bfloat16* buf = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  // [k0 | v0 | k1 | v1], each bs x ld bf16, then q (M, E) f32, then p
  float* qs = reinterpret_cast<float*>(buf + 4 * bs * ld);
  float* ps = qs + M * E;

  const __nv_bfloat16* qg = a.q + ((size_t)b * H + (size_t)g * M) * E;
  for (int i = threadIdx.x; i < M * E; i += THREADS)
    qs[i] = __bfloat162float(qg[i]);

  const int n_tiles = (a.S + bs - 1) / bs;
  const int n_walk = min(n_tiles, a.pos / bs + 1);   // tiles with s·bs <= pos
  if (n_walk > 0) issue_tile<PAGED>(a, b, g, 0, buf, buf + bs * ld);
  __syncthreads();                                    // qs is written

  float m_i[MPW], l_i[MPW], acc[MPW][EPL];
#pragma unroll
  for (int j = 0; j < MPW; ++j) {
    const int m = warp + NWARPS * j;
    m_i[j] = NEG_INF;
    l_i[j] = 0.f;
#pragma unroll
    for (int i = 0; i < EPL; ++i) acc[j][i] = 0.f;
    if (!DELTA || m >= M) continue;
    // the new token's column: p_new = 1 at init
    const size_t nrow = ((size_t)b * a.KV + g) * E;
    float dot = 0.f;
    for (int e = lane; e < E; e += 32)
      dot = fmaf(qs[m * E + e], __bfloat162float(a.k_new[nrow + e]), dot);
    m_i[j] = warp_sum(dot) * a.scale;
    l_i[j] = 1.f;
#pragma unroll
    for (int i = 0; i < EPL; ++i) {
      const int e = lane + 32 * i;
      if (e < E) acc[j][i] = __bfloat162float(a.v_new[nrow + e]);
    }
  }

  const int lim = DELTA ? a.pos : a.pos + 1;          // admit t < lim
  for (int s = 0; s < n_walk; ++s) {
    __nv_bfloat16* cur = buf + (s & 1) * 2 * bs * ld;
    if (s + 1 < n_walk) {
      __nv_bfloat16* nxt = buf + ((s + 1) & 1) * 2 * bs * ld;
      issue_tile<PAGED>(a, b, g, s + 1, nxt, nxt + bs * ld);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();                                  // tile s has landed
    attend_tile(a, s * bs, lim, cur, cur + bs * ld, qs, ps, m_i, l_i, acc);
    __syncthreads();                // every warp is done with buffer s & 1
  }

#pragma unroll
  for (int j = 0; j < MPW; ++j) {
    const int m = warp + NWARPS * j;
    if (m >= M) break;
    const float inv_l = 1.f / fmaxf(l_i[j], 1e-30f);
    __nv_bfloat16* o = a.out + ((size_t)b * H + (size_t)g * M + m) * E;
#pragma unroll
    for (int i = 0; i < EPL; ++i) {
      const int e = lane + 32 * i;
      if (e < E) o[e] = __float2bfloat16(acc[j][i] * inv_l);
    }
  }
}

size_t smem_bytes(int block_s, int M, int E) {
  return (size_t)4 * block_s * (E + PAD) * 2 + (size_t)M * E * 4 +
         (size_t)NWARPS * block_s * 4;
}

template <bool PAGED, bool DELTA>
int launch(const Args& a, int B, cudaStream_t st) {
  const size_t smem = smem_bytes(a.block_s, a.M, a.E);
  cudaError_t err = cudaFuncSetAttribute(
      decode_attn_kernel<PAGED, DELTA>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  decode_attn_kernel<PAGED, DELTA>
      <<<dim3(a.KV, B), THREADS, smem, st>>>(a);
  return (int)cudaGetLastError();
}

int run(Args& a, int B, void* stream) {
  if (B < 1 || a.KV < 1 || a.M < 1 || a.M > MAX_M || a.E < 8 ||
      a.E > MAX_E || a.E % 8 || a.block_s < 1 || a.block_s > MAX_BS ||
      a.S < 1 || a.pos < 0 || a.win < 1 ||
      smem_bytes(a.block_s, a.M, a.E) > MAX_SMEM)
    return (int)cudaErrorInvalidValue;
  const cudaStream_t st = (cudaStream_t)stream;
  const bool delta = a.k_new != nullptr;
  if (a.table != nullptr)
    return delta ? launch<true, true>(a, B, st) : launch<true, false>(a, B, st);
  return delta ? launch<false, true>(a, B, st) : launch<false, false>(a, B, st);
}

}  // namespace

// q (B, 1, H, E), caches (B, S, KV, E), k_new/v_new (B, 1, KV, E) or null
// (canonical variant), out (B, 1, H, E); all bf16, contiguous.
extern "C" int decode_attention(const void* q, const void* k, const void* v,
                                const void* k_new, const void* v_new,
                                void* out, int B, int S, int KV, int M, int E,
                                int block_s, int pos, int win, float scale,
                                void* stream) {
  Args a{(const __nv_bfloat16*)q, (const __nv_bfloat16*)k,
         (const __nv_bfloat16*)v, (const __nv_bfloat16*)k_new,
         (const __nv_bfloat16*)v_new, nullptr, (__nv_bfloat16*)out,
         S, KV, M, E, block_s, 0, 0, pos, win, scale};
  if ((k_new == nullptr) != (v_new == nullptr))
    return (int)cudaErrorInvalidValue;
  return run(a, B, stream);
}

// The paged variant: pools (n_pages, P, KV, E), table (B, W) int32; the
// logical cache is W * P positions, position t at pool[table[b, t / P],
// t % P].
extern "C" int paged_decode_attention(const void* q, const void* k_pages,
                                      const void* v_pages, const void* table,
                                      const void* k_new, const void* v_new,
                                      void* out, int B, int n_pages, int P,
                                      int W, int KV, int M, int E, int pos,
                                      int win, float scale, void* stream) {
  Args a{(const __nv_bfloat16*)q, (const __nv_bfloat16*)k_pages,
         (const __nv_bfloat16*)v_pages, (const __nv_bfloat16*)k_new,
         (const __nv_bfloat16*)v_new, (const int*)table, (__nv_bfloat16*)out,
         W * P, KV, M, E, P, W, n_pages, pos, win, scale};
  if ((k_new == nullptr) != (v_new == nullptr) || table == nullptr ||
      n_pages < 1 || W < 1)
    return (int)cudaErrorInvalidValue;
  return run(a, B, stream);
}
