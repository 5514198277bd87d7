// Causal / sliding-window GQA flash attention (the prefill attention of
// the dense and hybrid families), hand-written for sm_90a.
//
// Replaces the TPU kernel K11: src/repro/kernels/flash_attention.py,
// `_attn_kernel` (pallas_call at flash_attention.py:119).  Same function:
// q (B, Sq, H, E), k and v (B, Sk, KV, E), all bf16, -> (B, Sq, H, E)
// bf16, GQA groups of M = H / KV query heads per KV head; query row s sits
// at position q_offset + s; with `causal` it admits key t <= position and,
// with a window > 0, position - t < window.  Scores, the online-softmax
// carry (m, l) and the accumulator are f32, masked scores -1e30 (the TPU
// kernel's and the oracle's constant), the output acc / max(l, 1e-30)
// rounded to bf16 once.  Two things differ from the TPU kernel: any Sq is
// accepted (it asserts Sq % block_q == 0; here rows past Sq are neither
// computed into nor written) and any Sk (keys past Sk are masked, their
// rows zero-filled in shared memory, never read from memory).
//
// Design.  On the TPU a program owns one (batch, KV head, q block): the
// block's M query heads ride together as (position, head) rows, so each
// K/V row is read once for all M heads, and the kv blocks stream through
// VMEM in a fori_loop over [lo, hi): blocks above the diagonal and below
// the window are never visited.  Here one CTA of 4 warps owns 64 such
// (position, head) rows of one (batch, KV head): the flattened rows
// r = s * M + m of that head's group, so a tile covers 64 / M positions
// for any M (no padding of the group to a power of two) and a B = 1
// prefill at S = 1500, KV = 5, M = 5 runs 118 x 5 = 590 CTAs on the 132
// SMs (145 at smollm-360m's S = 600, M = 3).  The CTA walks only the key
// tiles of 64 rows in [lo, hi) of its positions, the TPU kernel's skip,
// which is where a windowed layer's sub-quadratic cost comes from; a warp
// whose 16 rows see none of a visited tile (above its diagonal or below
// its window) skips that tile's arithmetic.  K/V tiles are copied with
// 16-byte cp.async into a double buffer in shared memory, the next tile in
// flight while the current one is consumed.
//
// Products.  Each warp computes its 16 x 64 score tile with
// mma.sync.m16n8k16 on the bf16 q and k (products exact, f32 sums), then
// the online softmax in registers: the row max across the 4 lanes of a
// quad, m' = max(m, rowmax), alpha = exp(m - m'), p = exp(s - m').  A
// row's first visited tile may be wholly masked (lo is taken for the
// CTA's first row): then m stays -1e30 and p = exp(0) = 1 on masked keys,
// finite, until the row's first admitted key, where alpha = exp(-1e30 -
// s) = 0 resets l and acc, exactly as in the TPU kernel; no -inf enters,
// so no NaN.  For p·v, p stays f32 as in the TPU kernel, to 2^-16: it is
// split into two bf16 terms, p = hi + lo with lo = bf16(p - hi), and both
// go through the tensor cores against the bf16 v with f32 accumulation.
// The kernel therefore matches the all-f32 plain version
// (`ref.flash_attention_plain`) up to f32 summation order and that 2^-16:
// the held tolerance is the bf16 output's, 2e-2 normalised.
//
// What bounds it on the H100: operations.  Per admitted (query head, key)
// pair it does 4E flops (q.k and p.v) and moves nothing but q, k, v and
// o: at hymba-1.5b's S = 1500 a windowed layer has 1.01 M pairs per head,
// 6.5 GFLOP against 11.5 MB, ~6.6 us at the bf16 peak.  This simple kernel
// issues mma.sync (not wgmma), keeps the exponentials on the CUDA cores,
// loads v fragments with scalar shared-memory reads and re-reads each K/V
// tile from L2 for every 64 rows; wgmma with TMA-fed tiles and larger row
// tiles are later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int WARPS = 4;
constexpr int THREADS = 32 * WARPS;
constexpr int ROWS = 16 * WARPS;          // (position, head) rows per CTA
constexpr int BK = 64;                    // keys per K/V tile
constexpr int PAD = 8;                    // bf16 padding of a smem row
constexpr float NEG_INF = -1e30f;

struct Args {
  const __nv_bfloat16* q;      // (B, Sq, KV * M, E)
  const __nv_bfloat16* k;      // (B, Sk, KV, E)
  const __nv_bfloat16* v;
  __nv_bfloat16* out;          // (B, Sq, KV * M, E)
  int Sq, Sk, KV, M;
  int causal, window, q_offset;   // window 0: no window
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

__device__ __forceinline__ uint32_t ld32(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

__device__ __forceinline__ uint32_t pack(__nv_bfloat162 v) {
  return *reinterpret_cast<uint32_t*>(&v);
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

// Copy key tile kt (BK rows of E bf16, KV head g of batch row b) into ks
// and the value tile into vs; rows past Sk are zero-filled.
template <int E>
__device__ __forceinline__ void issue_kv(const Args& a, int b, int g, int kt,
                                         __nv_bfloat16* ks,
                                         __nv_bfloat16* vs) {
  constexpr int LD = E + PAD, CPR = E / 8;
  for (int i = threadIdx.x; i < BK * CPR; i += THREADS) {
    const int r = i / CPR, c = i - r * CPR;
    const int t = kt * BK + r;
    const bool in = t < a.Sk;
    const size_t off =
        (((size_t)b * a.Sk + (in ? t : 0)) * a.KV + g) * E + (size_t)c * 8;
    cp_async16(ks + r * LD + c * 8, a.k + off, in ? 16 : 0);
    cp_async16(vs + r * LD + c * 8, a.v + off, in ? 16 : 0);
  }
  cp_async_commit();
}

template <int E>
__global__ void __launch_bounds__(THREADS) flash_attn_kernel(const Args a) {
  constexpr int LD = E + PAD, CPR = E / 8;
  constexpr int KSTEPS = E / 16;          // k16 steps of q.k^T
  constexpr int ETILES = E / 8;           // n8 tiles of the output row
  constexpr int NT = BK / 8;              // n8 tiles of a score row
  extern __shared__ __align__(16) unsigned char smem_raw[];
  // q tile (ROWS x LD), then [k0 | v0 | k1 | v1], each BK x LD
  __nv_bfloat16* qs = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* kvs = qs + ROWS * LD;

  const int g = blockIdx.y, b = blockIdx.z;
  const int M = a.M, H = a.KV * M;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int gid = lane >> 2, tig = lane & 3;
  const int n_rows = a.Sq * M;            // (position, head) rows of (b, g)
  const int r0 = blockIdx.x * ROWS;
  const int r_end = min(r0 + ROWS, n_rows);

  // the keys this CTA visits: [lo, hi) of its first and last positions
  const int p_first = r0 / M + a.q_offset;
  const int p_last = (r_end - 1) / M + a.q_offset;
  const int hi = a.causal ? min(a.Sk, p_last + 1) : a.Sk;
  const int lo =
      (a.causal && a.window > 0) ? max(p_first - a.window + 1, 0) : 0;
  const int kt0 = lo / BK, kt1 = (hi + BK - 1) / BK;

  for (int i = threadIdx.x; i < ROWS * CPR; i += THREADS) {
    const int r = i / CPR, c = i - r * CPR;
    const int row = r0 + r;
    const bool in = row < n_rows;
    const int t = in ? row / M : 0, m = in ? row - t * M : 0;
    const size_t off =
        (((size_t)b * a.Sq + t) * H + (size_t)g * M + m) * E + (size_t)c * 8;
    cp_async16(qs + r * LD + c * 8, a.q + off, in ? 16 : 0);
  }
  cp_async_commit();
  issue_kv<E>(a, b, g, kt0, kvs, kvs + BK * LD);
  cp_async_wait<1>();                     // the q tile has landed
  __syncthreads();

  // this warp's rows: wr + gid (fragment half 0) and wr + gid + 8 (half 1)
  const int wr = warp * 16;
  uint32_t qf[KSTEPS][4];
#pragma unroll
  for (int kk = 0; kk < KSTEPS; ++kk) {
    const __nv_bfloat16* p = qs + (wr + gid) * LD + kk * 16 + tig * 2;
    qf[kk][0] = ld32(p);
    qf[kk][1] = ld32(p + 8 * LD);
    qf[kk][2] = ld32(p + 8);
    qf[kk][3] = ld32(p + 8 * LD + 8);
  }
  int pos[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) pos[h] = (r0 + wr + gid + 8 * h) / M + a.q_offset;
  const bool warp_rows = r0 + wr < n_rows;
  const int w_first = (r0 + wr) / M + a.q_offset;
  const int w_last = (min(r0 + wr + 16, n_rows) - 1) / M + a.q_offset;

  float acc[ETILES][4];
#pragma unroll
  for (int et = 0; et < ETILES; ++et)
    acc[et][0] = acc[et][1] = acc[et][2] = acc[et][3] = 0.f;
  float m_r[2] = {NEG_INF, NEG_INF}, l_r[2] = {0.f, 0.f};

  for (int kt = kt0; kt < kt1; ++kt) {
    __nv_bfloat16* ks = kvs + ((kt - kt0) & 1) * 2 * BK * LD;
    __nv_bfloat16* vs = ks + BK * LD;
    if (kt + 1 < kt1) {
      __nv_bfloat16* nxt = kvs + ((kt + 1 - kt0) & 1) * 2 * BK * LD;
      issue_kv<E>(a, b, g, kt + 1, nxt, nxt + BK * LD);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();                      // tile kt has landed
    const int k0 = kt * BK;
    bool skip = !warp_rows;
    if (a.causal) {
      skip = skip || k0 > w_last;                         // above the diagonal
      if (a.window > 0)
        skip = skip || k0 + BK - 1 <= w_first - a.window;  // below the window
    }
    if (!skip) {
      float s[NT][4];
#pragma unroll
      for (int nt = 0; nt < NT; ++nt)
        s[nt][0] = s[nt][1] = s[nt][2] = s[nt][3] = 0.f;
#pragma unroll
      for (int kk = 0; kk < KSTEPS; ++kk) {
#pragma unroll
        for (int nt = 0; nt < NT; ++nt) {
          const __nv_bfloat16* p = ks + (nt * 8 + gid) * LD + kk * 16 + tig * 2;
          mma_bf16(s[nt], qf[kk], ld32(p), ld32(p + 8));
        }
      }
      // scale and mask; s[nt][c] is row half c / 2, key k0 + nt*8 + tig*2 + c%2
      float mx[2] = {NEG_INF, NEG_INF};
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          const int key = k0 + nt * 8 + tig * 2 + (c & 1);
          const int qp = pos[c >> 1];
          bool ok = key < a.Sk;
          if (a.causal) {
            ok = ok && key <= qp;
            if (a.window > 0) ok = ok && qp - key < a.window;
          }
          s[nt][c] = ok ? s[nt][c] * a.scale : NEG_INF;
          mx[c >> 1] = fmaxf(mx[c >> 1], s[nt][c]);
        }
      }
      float alpha[2];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 1));
        mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 2));
        const float m_new = fmaxf(m_r[h], mx[h]);
        alpha[h] = expf(m_r[h] - m_new);
        m_r[h] = m_new;
        l_r[h] *= alpha[h];               // this lane's part of the row sum
      }
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          s[nt][c] = expf(s[nt][c] - m_r[c >> 1]);
          l_r[c >> 1] += s[nt][c];
        }
      }
#pragma unroll
      for (int et = 0; et < ETILES; ++et) {
        acc[et][0] *= alpha[0];
        acc[et][1] *= alpha[0];
        acc[et][2] *= alpha[1];
        acc[et][3] *= alpha[1];
      }
      // p.v: keys 16j .. 16j + 15 are the score tiles 2j and 2j + 1, whose
      // accumulator layout is the A fragment of the next product
#pragma unroll
      for (int j = 0; j < BK / 16; ++j) {
        const float pf[8] = {s[2 * j][0],     s[2 * j][1],     s[2 * j][2],
                             s[2 * j][3],     s[2 * j + 1][0], s[2 * j + 1][1],
                             s[2 * j + 1][2], s[2 * j + 1][3]};
        uint32_t phi[4], plo[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const __nv_bfloat162 h2 =
              __floats2bfloat162_rn(pf[2 * i], pf[2 * i + 1]);
          phi[i] = pack(h2);
          plo[i] = pack(__floats2bfloat162_rn(
              pf[2 * i] - __low2float(h2), pf[2 * i + 1] - __high2float(h2)));
        }
#pragma unroll
        for (int et = 0; et < ETILES; ++et) {
          const __nv_bfloat16* p = vs + (j * 16 + tig * 2) * LD + et * 8 + gid;
          const uint32_t b0 = pack(__halves2bfloat162(p[0], p[LD]));
          const uint32_t b1 = pack(__halves2bfloat162(p[8 * LD], p[9 * LD]));
          mma_bf16(acc[et], phi, b0, b1);
          mma_bf16(acc[et], plo, b0, b1);
        }
      }
    }
    __syncthreads();                // every warp is done with this buffer
  }

#pragma unroll
  for (int h = 0; h < 2; ++h) {
    l_r[h] += __shfl_xor_sync(0xffffffffu, l_r[h], 1);
    l_r[h] += __shfl_xor_sync(0xffffffffu, l_r[h], 2);
    const int row = r0 + wr + gid + 8 * h;
    if (row >= n_rows) continue;
    const int t = row / M, m = row - t * M;
    const float l = fmaxf(l_r[h], 1e-30f);
    __nv_bfloat16* o =
        a.out + (((size_t)b * a.Sq + t) * H + (size_t)g * M + m) * E;
#pragma unroll
    for (int et = 0; et < ETILES; ++et)
      *reinterpret_cast<__nv_bfloat162*>(o + et * 8 + tig * 2) =
          __floats2bfloat162_rn(acc[et][2 * h] / l, acc[et][2 * h + 1] / l);
  }
}

constexpr size_t smem_bytes(int E) {
  return (size_t)(ROWS + 4 * BK) * (E + PAD) * 2;
}

template <int E>
int launch(const Args& a, int B, cudaStream_t st) {
  constexpr size_t smem = smem_bytes(E);
  cudaError_t err = cudaFuncSetAttribute(
      flash_attn_kernel<E>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  const int tiles = (a.Sq * a.M + ROWS - 1) / ROWS;
  flash_attn_kernel<E><<<dim3(tiles, a.KV, B), THREADS, smem, st>>>(a);
  return (int)cudaGetLastError();
}

}  // namespace

// q (B, Sq, KV * M, E), k and v (B, Sk, KV, E), out like q; all bf16,
// contiguous.  E in {32, 64, 128}; window 0 means no window.
extern "C" int flash_attention(const void* q, const void* k, const void* v,
                               void* out, int B, int Sq, int Sk, int KV,
                               int M, int E, int causal, int window,
                               int q_offset, float scale, void* stream) {
  if (B < 1 || Sq < 1 || Sk < 1 || KV < 1 || M < 1 || B > 65535 ||
      KV > 65535 || (long long)Sq * M > (1LL << 30) || window < 0 ||
      q_offset < 0)
    return (int)cudaErrorInvalidValue;
  const Args a{(const __nv_bfloat16*)q, (const __nv_bfloat16*)k,
               (const __nv_bfloat16*)v, (__nv_bfloat16*)out,
               Sq, Sk, KV, M, causal != 0, window, q_offset, scale};
  const cudaStream_t st = (cudaStream_t)stream;
  switch (E) {
    case 32: return launch<32>(a, B, st);
    case 64: return launch<64>(a, B, st);
    case 128: return launch<128>(a, B, st);
    default: return (int)cudaErrorInvalidValue;
  }
}
