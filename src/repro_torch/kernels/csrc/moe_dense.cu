// Fused mixture of experts under the dense router (the moe family's FFN),
// hand-written for sm_90a.
//
// Replaces the TPU kernel K10: src/repro/kernels/moe_dense.py,
// `_moe_kernel` (pallas_call at moe_dense.py:72).  Same function:
// x (T, d) bf16, router weights w (T, E) f32 (0 for experts not selected),
// wi and wg (E, d, f), wo (E, f, d) bf16 -> y (T, d) bf16 with
//   y = sum_e w[:, e] * (act(x wi_e, x wg_e) wo_e)
// where h = x wi_e and g = x wg_e are f32 sums of bf16 products,
// act = silu(g) * h (swiglu) or the tanh-approximated gelu(h), taken in
// f32 and rounded once to bf16; that hidden times wo_e is an f32 sum,
// scaled by w[:, e]; the experts' terms are summed in f32 and y is
// rounded once.  Two things differ from the TPU kernel: any T >= 1 is
// accepted (it asserts T % tile_t == 0), and only the (token, expert)
// pairs with a non-zero weight are computed.  A zero weight adds an exact
// 0 wherever the expert's FFN is finite, so y is the same; an unselected
// expert whose FFN is not finite no longer turns its token's row into NaN.
//
// What bounds it on the H100: bytes.  The weights of every expert that
// some token weights must leave device memory once: at decode, T = 1 with
// granite's top-8 of 40 experts reads 8 x 4.72 MB = 37.7 MB (11.3 us at
// 3.35 TB/s), T = 8 about 32 experts (45 us); at prefill all 40 (188.7
// MB, 56 us), ahead of the weighted pairs' products (26.4 GFLOP at T =
// 700, 27 us at the bf16 peak).  So only the weighted pairs are
// computed, each expert's weights are streamed once per tile of its
// tokens, and only the weighted pairs' rows reach device memory (the
// slots the combine sums), not a (T, E, d) tensor.  Three
// launches on the caller's stream, none waiting on the host (the second
// and third start early, by programmatic dependent launch, and wait for
// the one before on the device):
//
// 1. moe_plan_kernel (one CTA) builds the work list from w: for each
//    expert the ascending list of its tokens (the pairs, expert-major),
//    for each pair its slot in token-major order (tok_off[t] plus the
//    rank of e among t's non-zero experts), and the items (an expert and
//    a tile of up to R of its tokens), expert-major.
// 2. moe_ffn_kernel: persistent clusters, as many as the card runs at
//    once (cudaOccupancyMaxActiveClusters), walk the items; item i is
//    cluster i mod C's, fixed, so an expert's tiles run side by side on
//    neighbouring clusters and the tiles after the first find its weights
//    in L2.  CTA r of a cluster of CL computes hidden columns [FS r, FS r
//    + FS) of the item's rows (reading only that slice of wi and wg) and
//    keeps them in its shared memory; after a cluster barrier every CTA
//    gathers the whole hidden from its peers (distributed shared memory,
//    a 64-column chunk at a time, behind the previous chunk's products)
//    and computes output columns [DS r, DS r + DS) of hidden x wo_e (only
//    that slice of wo).  Each used pair's row w[t, e] * ye goes, in f32,
//    to its slot, staged through shared memory so that rows leave whole.
// 3. moe_combine_kernel: each token's slots summed in ascending expert
//    order in f32 and rounded once; a token with no non-zero weight gets
//    an exact 0 row.  No atomics anywhere.
//
// Two regimes, one arithmetic.  T > 16 (prefill): items of 64 rows,
// clusters of f / 64 CTAs (8 at granite's f = 512), FS 64, DS d / 8 =
// 192, one CTA an SM.  T <= 16 (decode): an item holds all of one
// expert's (<= 16) tokens, clusters of f / 32 CTAs (16, non-portable),
// FS 32, DS 96, three CTAs an SM, so that 21 clusters run at once: the 8
// experts of one token are streamed by 128 CTAs and not by 64, and T =
// 8's ~32 experts take two rounds, not three.  In both every product is
// wgmma m64n32k16 with A (the x chunk, the hidden) from registers and B
// (a 64-row block of the weights) from shared memory, each output element
// summed over k in the same 16-step order: a token's bits do not depend
// on T or on the rows that share its tile (at decode the warps past the
// 16 held rows repeat those rows; their results are dropped).
//
// Feeding: a producer warp keeps a ring of STAGES chunks of 64 k-rows in
// flight, one mbarrier per stage: the weight blocks by TMA (64 k-rows of
// 64 columns, 128-byte swizzle, at prefill; of 32 columns, 64-byte
// swizzle, at decode: the layouts wgmma's transposed B reads), the item's
// x rows gathered by cp.async (sm_90's TMA cannot gather rows), whose
// completion arrives on the same barrier.  No two CTAs of a cluster read
// the same weight block, so nothing is multicast.
//
// Measured (PERF.md): the launch is bound by that feed, not by the
// products (with the products removed it takes as long): at decode each
// round of items streams at about the card's practical rate; at prefill
// each 64-row item re-reads its expert's weights (from L2 after the
// first) and each CTA of a cluster gathers the same x rows.  Left for
// later: items of more rows sharing each weight block (two or three
// consumer warpgroups; the hidden of 128 rows does not fit beside the
// ring), x shared across the cluster, and an exchange of the hidden that
// does not stall the ring (a push by the bulk-copy engine, guarded by
// mbarriers, was measured and was no faster).

#include <cooperative_groups.h>
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "sm90.cuh"

namespace cg = cooperative_groups;

namespace {

using sm90::Wgmma;

constexpr int BK = 64;            // k rows of a streamed chunk
constexpr int NB = 32;            // columns of a wgmma
constexpr int PAD = 8;            // bf16 padding of a row-major smem row
constexpr int LDX = BK + PAD;     // row stride of an x chunk
constexpr int CONSUMERS = 128;    // one warpgroup
constexpr int THREADS = CONSUMERS + 32;  // and the producer warp
constexpr int PLAN_THREADS = 1024;
constexpr int DECODE_T = 16;      // T up to which an item is one expert
constexpr int MAX_F = 512;
constexpr int MAX_E = 1024;
constexpr int PLAN_BITS = 65536;  // bits of a plan chunk's w != 0 mask

// The work list in the workspace (moe_plan_kernel writes it).
struct Work {
  int* tok_nnz;     // (T): non-zero weights of token t
  int* tok_off;     // (T): its first slot
  int* pair_tok;    // (<= T E) the pairs, expert-major: token
  int* pair_slot;   //   its slot, token-major
  int4* items;      // (<= E + T E / R): expert, first pair, rows
  int* n_items;     // (1)
};

// the workspace's parts, byte offsets (moe_dense_layout)
enum { L_SLOTS, L_NNZ, L_OFF, L_TOK, L_SLOT, L_ITEMS, L_NITEMS, L_TOTAL,
       L_N };

int item_rows(int T) { return T <= DECODE_T ? 16 : 64; }

void layout(int T, int d, int E, size_t (&o)[L_N]) {
  const size_t P = (size_t)T * E;
  const size_t R = item_rows(T);
  const size_t I = E + (P + R - 1) / R;
  const size_t sizes[L_TOTAL] = {P * d * 4,     (size_t)T * 4, (size_t)T * 4,
                                 P * 4,         P * 4,         I * 16,
                                 4};
  size_t at = 0;
  for (int i = 0; i < L_TOTAL; ++i) {
    o[i] = at;
    at += (sizes[i] + 255) / 256 * 256;
  }
  o[L_TOTAL] = at;
}

Work work_at(void* ws, int T, int d, int E) {
  size_t o[L_N];
  layout(T, d, E, o);
  unsigned char* b = static_cast<unsigned char*>(ws);
  return Work{reinterpret_cast<int*>(b + o[L_NNZ]),
              reinterpret_cast<int*>(b + o[L_OFF]),
              reinterpret_cast<int*>(b + o[L_TOK]),
              reinterpret_cast<int*>(b + o[L_SLOT]),
              reinterpret_cast<int4*>(b + o[L_ITEMS]),
              reinterpret_cast<int*>(b + o[L_NITEMS])};
}

// ------------------------------------------------------------- the plan

// Programmatic dependent launch: the next launch on the stream may start
// (its prologue overlapping this grid's tail) once every CTA of this one
// has called launch_dependents; wait_prerequisites returns once the grid
// before has finished and its writes are visible.
__device__ __forceinline__ void launch_dependents() {
  asm volatile("griddepcontrol.launch_dependents;\n" ::: "memory");
}

__device__ __forceinline__ void wait_prerequisites() {
  asm volatile("griddepcontrol.wait;\n" ::: "memory");
}

// the set bits of bits[s, s + len)
__device__ __forceinline__ int popc_range(const uint32_t* bits, int s,
                                          int len) {
  int n = 0;
  while (len > 0) {
    const int b = s & 31, take = min(32 - b, len);
    const uint32_t word = bits[s >> 5] >> b;
    n += __popc(take == 32 ? word : word & ((1u << take) - 1u));
    s += take;
    len -= take;
  }
  return n;
}

// One CTA, over chunks of TC tokens (TC E <= PLAN_BITS).  A chunk's w != 0
// mask, token-major (bit (t - t0) E + e), comes from coalesced loads and
// ballots; then a warp an expert ballots its column, 32 tokens at a
// time.  Pass 1 counts each expert's
// tokens; then the experts' first pairs and the items; pass 2 takes the
// chunks again: each token's slots (a block scan of its count) and, a
// warp an expert, each pair's place (the expert's first pair plus its
// tokens before this one) with its token and slot (the token's first slot
// plus its experts before this one).  No atomics: every word has one
// writer.
__global__ void __launch_bounds__(PLAN_THREADS)
    moe_plan_kernel(const float* __restrict__ w, Work wk, int T, int E,
                    int R) {
  __shared__ uint32_t flat[PLAN_BITS / 32];
  __shared__ uint32_t colbits[PLAN_BITS / 32];   // (E, TC / 32)
  __shared__ int cnt[MAX_E];       // pass 1: tokens; pass 2: pairs placed
  __shared__ int eoff[MAX_E + 1];
  __shared__ int ioff[MAX_E + 1];
  __shared__ int slot0[PLAN_THREADS];            // a chunk token's first slot
  __shared__ int wsum[32];
  __shared__ int carry;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int TC = min(PLAN_THREADS, PLAN_BITS / E / 32 * 32);
  const int NCH = (T + TC - 1) / TC, G = TC / 32;
  launch_dependents();   // the FFN launch's prologue (it waits for us)

  // chunk ch's mask and its column ballots; each expert's count into cnt
  // (pass 1) or nowhere (pass 2)
  auto load_chunk = [&](int ch, bool count) {
    const int t0 = ch * TC, n = min(TC, T - t0), total = n * E;
    const float* src = w + (size_t)t0 * E;
    for (int base = warp * 32; base < total; base += 8 * PLAN_THREADS) {
      float v[8];                      // eight loads in flight a thread
#pragma unroll
      for (int u = 0; u < 8; ++u) {
        const int i = base + u * PLAN_THREADS + lane;
        v[u] = i < total ? src[i] : 0.f;
      }
#pragma unroll
      for (int u = 0; u < 8; ++u) {
        const int i0 = base + u * PLAN_THREADS;
        const uint32_t m = __ballot_sync(0xffffffffu, v[u] != 0.f);
        if (lane == 0 && i0 < total) flat[i0 / 32] = m;
      }
    }
    __syncthreads();
    for (int e = warp; e < E; e += PLAN_THREADS / 32) {
      int run = 0;
      for (int g = 0; g * 32 < n; ++g) {
        const int tl = g * 32 + lane, bi = tl * E + e;
        const bool b = tl < n && ((flat[bi >> 5] >> (bi & 31)) & 1u);
        const uint32_t m = __ballot_sync(0xffffffffu, b);
        if (lane == 0) colbits[e * G + g] = m;
        run += __popc(m);
      }
      if (count && lane == 0) cnt[e] += run;
    }
    __syncthreads();
  };

  for (int e = threadIdx.x; e < E; e += PLAN_THREADS) cnt[e] = 0;
  __syncthreads();
  for (int ch = 0; ch < NCH; ++ch) load_chunk(ch, true);
  if (warp == 0) {                   // the experts' first pairs and items
    int p = 0, it = 0;
    for (int e0 = 0; e0 < E; e0 += 32) {
      const int e = e0 + lane;
      const int c = e < E ? cnt[e] : 0, n = (c + R - 1) / R;
      int pc = c, pn = n;
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) {
        const int vc = __shfl_up_sync(0xffffffffu, pc, o);
        const int vn = __shfl_up_sync(0xffffffffu, pn, o);
        if (lane >= o) {
          pc += vc;
          pn += vn;
        }
      }
      if (e < E) {
        eoff[e] = p + pc - c;
        ioff[e] = it + pn - n;
      }
      p += __shfl_sync(0xffffffffu, pc, 31);
      it += __shfl_sync(0xffffffffu, pn, 31);
    }
    if (lane == 0) {
      eoff[E] = p;
      ioff[E] = it;
      *wk.n_items = it;
      carry = 0;
    }
  }
  __syncthreads();
  for (int e = threadIdx.x; e < E; e += PLAN_THREADS) {
    for (int j = 0; j < ioff[e + 1] - ioff[e]; ++j)
      wk.items[ioff[e] + j] =
          make_int4(e, eoff[e] + j * R, min(R, cnt[e] - j * R), 0);
    cnt[e] = 0;
  }

  for (int ch = 0; ch < NCH; ++ch) {
    if (NCH > 1) load_chunk(ch, false);     // else pass 1's is in place
    const int t0 = ch * TC, n = min(TC, T - t0);
    const int tl = threadIdx.x;
    const int nnz = tl < n ? popc_range(flat, tl * E, E) : 0;
    int incl = nnz;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int v = __shfl_up_sync(0xffffffffu, incl, o);
      if (lane >= o) incl += v;
    }
    if (lane == 31) wsum[warp] = incl;
    __syncthreads();
    if (warp == 0) {
      const int s = wsum[lane];
      int x = s;
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) {
        const int v = __shfl_up_sync(0xffffffffu, x, o);
        if (lane >= o) x += v;
      }
      wsum[lane] = x - s;
    }
    __syncthreads();
    const int off = carry + wsum[warp] + incl - nnz;
    slot0[tl] = off;
    if (tl < n) {
      wk.tok_nnz[t0 + tl] = nnz;
      wk.tok_off[t0 + tl] = off;
    }
    __syncthreads();
    if (tl == PLAN_THREADS - 1) carry = off + nnz;
    for (int e = warp; e < E; e += PLAN_THREADS / 32) {
      int placed = cnt[e];
      for (int g = 0; g * 32 < n; ++g) {
        const uint32_t m = colbits[e * G + g];
        if ((m >> lane) & 1u) {
          const int t = g * 32 + lane;
          const int p = eoff[e] + placed + __popc(m & ((1u << lane) - 1u));
          wk.pair_tok[p] = t0 + t;
          wk.pair_slot[p] = slot0[t] + popc_range(flat, t * E, e);
        }
        placed += __popc(m);
      }
      if (lane == 0) cnt[e] = placed;
    }
    __syncthreads();                 // before the next chunk's mask
  }
}

// ------------------------------------------------------------ the FFN

// RT rows held per item, FS hidden columns and NB2 output blocks (DS =
// 32 NB2 columns) per CTA.  A stage holds a phase-1 chunk (wi's and wg's
// NB1 blocks, then the x chunk, row-major with padding) or a phase-2 chunk
// (wo's NB2 blocks).
template <int RT, int FS, int NB2>
struct Cfg {
  static constexpr int NB1 = FS / NB;          // products of h (and g)
  static constexpr int DS = NB2 * NB;
  // Weight blocks of BK k-rows x BCOLS columns as TMA writes them: rows
  // of 128 bytes (128-byte swizzle) where a CTA's slices are multiples of
  // 64 columns, else of 64 (64-byte swizzle).  A TMA request moves one
  // block row, so the wider rows feed the SM twice the bytes per request.
  static constexpr int SPANW = FS == 64 ? 128 : 64;
  static constexpr int BCOLS = SPANW / 2;
  static constexpr int WBLOCK = BK * SPANW;
  static constexpr int LDM = FS + PAD;        // row stride of a hidden slice
  static constexpr int W1 = FS * BK * 2;      // wi's (or wg's) blocks
  static constexpr int P1 = 2 * W1 + RT * LDX * 2;
  static constexpr int P2 = DS * BK * 2;
  static constexpr int STAGE = ((P1 > P2 ? P1 : P2) + 1023) / 1024 * 1024;
  static constexpr int STAGES = RT == 64 ? 5 : 4;
  static constexpr int MINE = RT * LDM;                // bf16 elements
  static constexpr int FULL = RT * (MAX_F + PAD);      // bf16 elements
  static constexpr int SST = DS + 8;          // row stride of staged rows
  static_assert(RT * SST * 4 <= FULL * 2, "staged rows fit in `full`");
  static constexpr int BAR_OFF = STAGES * STAGE + (2 * MINE + FULL) * 2;
  static constexpr int SLOT_OFF = BAR_OFF + 2 * STAGES * 8;
  static constexpr int SMEM = SLOT_OFF + RT * 4 + 1024;  // + align
  // decode: three CTAs an SM, so 21 clusters of 16 run at once (14 at
  // two, 7 at one)
  static constexpr int MIN_BLOCKS = RT == 16 ? 3 : 1;
  // the B operand of 32-column product i of a region of blocks: its
  // block, and inside a 128-byte row its half (the swizzle is a function
  // of the address, so the descriptor starts 64 bytes on)
  static __device__ __forceinline__ uint32_t b_addr(uint32_t region, int i) {
    return region + (i * NB / BCOLS) * WBLOCK + (i * NB % BCOLS) * 2;
  }
};

struct Args {
  const __nv_bfloat16* x;   // (T, d)
  const float* w;           // (T, E)
  float* slots;             // (<= T E, d) f32: a used pair's w[t, e] ye
  Work wk;
  int E, d, f, gelu, clusters;
};

__device__ __forceinline__ void cluster_sync_all() {
  asm volatile(
      "barrier.cluster.arrive.release.aligned;\n"
      "barrier.cluster.wait.acquire.aligned;\n" ::
          : "memory");
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                   sm90::smem_u32(dst)),
               "l"(src)
               : "memory");
}

// arrives on `bar` once this thread's earlier cp.async copies have landed
// (counted among the barrier's expected arrivals)
__device__ __forceinline__ void cp_async_arrive(uint64_t* bar) {
  asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];\n" ::
                   "r"(sm90::smem_u32(bar))
               : "memory");
}

// wgmma's register A fragment (mma.sync's m16n8k16 A) of rows [r0, r0 +
// 16), k [k0, k0 + 16) of a row-major bf16 tile with row stride ld
__device__ __forceinline__ void load_a(uint32_t (&a)[4],
                                       const __nv_bfloat16* base, int ld,
                                       int r0, int k0) {
  const int t = threadIdx.x & 31;
  const __nv_bfloat16* p =
      base + (r0 + (t & 7) + ((t >> 3) & 1) * 8) * ld + k0 + (t >> 4) * 8;
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(a[0]), "=r"(a[1]), "=r"(a[2]), "=r"(a[3])
      : "r"(sm90::smem_u32(p)));
}

__device__ __forceinline__ float act(float h, float g, int gelu) {
  if (gelu) {
    const float c = 0.7978845608028654f;   // sqrt(2 / pi)
    return 0.5f * h * (1.f + tanhf(c * (h + 0.044715f * h * h * h)));
  }
  return g / (1.f + expf(-g)) * h;
}

template <int R>
__device__ __forceinline__ void zero(float (&d)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) d[i] = 0.f;
}

template <int RT, int FS, int NB2>
__global__ void __launch_bounds__(THREADS, Cfg<RT, FS, NB2>::MIN_BLOCKS)
    moe_ffn_kernel(const Args a, const __grid_constant__ CUtensorMap twi,
                   const __grid_constant__ CUtensorMap twg,
                   const __grid_constant__ CUtensorMap two) {
  using C = Cfg<RT, FS, NB2>;
  constexpr int STAGES = C::STAGES, NB1 = C::NB1, DS = C::DS;
  extern __shared__ unsigned char smem_raw[];
  // 1024-byte aligned: the swizzle pattern is a function of the address
  unsigned char* ring = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  __nv_bfloat16* mine =
      reinterpret_cast<__nv_bfloat16*>(ring + STAGES * C::STAGE);
  __nv_bfloat16* full = mine + 2 * C::MINE;
  uint64_t* full_bar = reinterpret_cast<uint64_t*>(ring + C::BAR_OFF);
  uint64_t* empty_bar = full_bar + STAGES;
  int* rowslot = reinterpret_cast<int*>(ring + C::SLOT_OFF);   // (RT)

  cg::cluster_group cluster = cg::this_cluster();
  const int CL = a.f / FS;
  const int rank = (int)cluster.block_rank();
  const int cid = blockIdx.x / CL;
  const int KC1 = a.d / BK, KC2 = a.f / BK, KC = KC1 + KC2;
  const int ldf = a.f + PAD;

  if (threadIdx.x == 0) {
    sm90::tma_prefetch_map(&twi);
    sm90::tma_prefetch_map(&twg);
    sm90::tma_prefetch_map(&two);
    for (int s = 0; s < STAGES; ++s) {
      // the producer lane 0's expect-tx and all 32 lanes' copy arrivals
      sm90::mbar_init(&full_bar[s], 33);
      sm90::mbar_init(&empty_bar[s], CONSUMERS / 32);
    }
    sm90::mbar_fence_init();
  }
  __syncthreads();
  wait_prerequisites();                  // the work list is written
  const int n_items = *a.wk.n_items;
  const int n_local =
      cid < n_items ? (n_items - 1 - cid) / a.clusters + 1 : 0;
  const int total = n_local * KC;

  const int warp = sm90::warp_uniform(threadIdx.x / 32), lane = threadIdx.x % 32;
  const int gelu = sm90::warp_uniform(a.gelu);
  if (warp == CONSUMERS / 32) {
    // ---------------------------------------------------------- producer
    // It takes part in the consumers' cluster barrier of item i once it
    // has issued chunk bar_point(i): the consumers reach it with the
    // chunks up to i's last phase-1 chunk, and the stages it fills up to
    // then were released by chunks at or before that one, so the ring
    // stays full across the barrier and no one waits on the other.
    auto bar_point = [&](int i) {
      return min(i * KC + KC1 - 1 + STAGES, total - 1);
    };
    int c = 0, taken = 0;
    for (int li = 0; li < n_local; ++li) {
      const int4 it = a.wk.items[cid + li * a.clusters];
      // this lane's x pieces: rows lane / 8 + 4 m, bytes 16 (lane % 8)
      const __nv_bfloat16* src[RT / 4];
#pragma unroll
      for (int m = 0; m < RT / 4; ++m) {
        const int r = lane / 8 + 4 * m;
        src[m] = r < it.z ? a.x + (size_t)a.wk.pair_tok[it.y + r] * a.d +
                                (lane % 8) * 8
                          : nullptr;
      }
      for (int j = 0; j < KC; ++j, ++c) {
        const int s = c % STAGES;
        if (c >= STAGES) sm90::mbar_wait(&empty_bar[s], ((c / STAGES) - 1) & 1);
        unsigned char* st = ring + s * C::STAGE;
        // the stage's last x copies (generic proxy) before TMA writes it
        sm90::fence_proxy_async();
        __syncwarp();
        if (j < KC1) {
          const int k0 = j * BK;
          if (lane == 0) {
            sm90::mbar_arrive_expect_tx(&full_bar[s], (gelu ? 1 : 2) * C::W1);
#pragma unroll
            for (int b = 0; b < FS / C::BCOLS; ++b)
              sm90::tma_load_4d(st + b * C::WBLOCK, &twi, &full_bar[s],
                                rank * FS + b * C::BCOLS, k0, it.x, 0);
            if (!gelu) {
#pragma unroll
              for (int b = 0; b < FS / C::BCOLS; ++b)
                sm90::tma_load_4d(st + C::W1 + b * C::WBLOCK, &twg,
                                  &full_bar[s], rank * FS + b * C::BCOLS, k0,
                                  it.x, 0);
            }
          }
          __nv_bfloat16* xs = reinterpret_cast<__nv_bfloat16*>(st + 2 * C::W1);
#pragma unroll
          for (int m = 0; m < RT / 4; ++m)
            if (src[m] != nullptr)
              cp_async16(xs + (lane / 8 + 4 * m) * LDX + (lane % 8) * 8,
                         src[m] + k0);
          cp_async_arrive(&full_bar[s]);
        } else {
          const int k0 = (j - KC1) * BK;
          if (lane == 0) {
            sm90::mbar_arrive_expect_tx(&full_bar[s], C::P2);
#pragma unroll
            for (int b = 0; b < DS / C::BCOLS; ++b)
              sm90::tma_load_4d(st + b * C::WBLOCK, &two, &full_bar[s],
                                rank * DS + b * C::BCOLS, k0, it.x, 0);
          }
          sm90::mbar_arrive(&full_bar[s]);
        }
        while (taken < n_local && c == bar_point(taken)) {
          cluster_sync_all();
          ++taken;
        }
      }
    }
    cluster_sync_all();          // the consumers' last barrier
    return;
  }

  // ------------------------------------------------------------ consumers
  // This warp's A rows: 16 warp (at decode every warp repeats rows 0-15);
  // the accumulators' rows are 16 warp + lane / 4 (+ 8), columns
  // 8 j + 2 (lane % 4) (+ 1) of each 32-column block.  Each chunk's
  // products stay in flight while the next chunk's A is loaded and its
  // products issued (wgmma_wait<1>), so the A fragments alternate
  // between two register sets and a stage is released one chunk late.
  const int r_a = (16 * warp) % RT;
  const bool writer = warp < RT / 16;
  auto release = [&](int cc) {
    __syncwarp();
    if (lane == 0) sm90::mbar_arrive(&empty_bar[cc % STAGES]);
  };
  float hacc[NB1][16], gacc[NB1][16], yacc[NB2][16];
  auto fence_p1 = [&]() {
#pragma unroll
    for (int nb = 0; nb < NB1; ++nb) {
      sm90::fence_operand(hacc[nb]);
      sm90::fence_operand(gacc[nb]);
    }
  };
  auto fence_p2 = [&]() {
#pragma unroll
    for (int nb = 0; nb < NB2; ++nb) sm90::fence_operand(yacc[nb]);
  };
  // phase-1 chunk cc: x . wi (and x . wg) of its 64 k-rows
  auto p1_step = [&](uint32_t (&af)[BK / 16][4], int cc, bool prev) {
    const int s = cc % STAGES;
    sm90::mbar_wait(&full_bar[s], (cc / STAGES) & 1);
    const unsigned char* st = ring + s * C::STAGE;
    const __nv_bfloat16* xs =
        reinterpret_cast<const __nv_bfloat16*>(st + 2 * C::W1);
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) load_a(af[kk], xs, LDX, r_a, kk * 16);
    const uint32_t wi_s = sm90::smem_u32(st), wg_s = wi_s + C::W1;
    fence_p1();
    sm90::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
#pragma unroll
      for (int nb = 0; nb < NB1; ++nb)
        Wgmma<NB>::rs<1>(
            hacc[nb], af[kk],
            sm90::desc_nmajor<C::SPANW>(C::b_addr(wi_s, nb), BK, kk), 1);
      if (!gelu) {
#pragma unroll
        for (int nb = 0; nb < NB1; ++nb)
          Wgmma<NB>::rs<1>(
              gacc[nb], af[kk],
              sm90::desc_nmajor<C::SPANW>(C::b_addr(wg_s, nb), BK, kk), 1);
      }
    }
    sm90::wgmma_commit();
    sm90::wgmma_wait<1>();                 // chunk cc - 1's products are in
    fence_p1();
    if (prev) release(cc - 1);
  };
  // the peers' hidden slices of phase-2 chunk j (columns [64 j, 64 j +
  // 64)) into `full`, from the item's buffer mb (every load issued before
  // the first store: through generic pointers the compiler would
  // otherwise wait for each remote load in turn)
  constexpr int PIECES = RT * FS / 8;        // 16-byte pieces of a slice
  constexpr int SLICES = BK / FS;            // slices a chunk spans
  constexpr int GATHER = SLICES * PIECES / CONSUMERS;   // pieces a thread
  static_assert(SLICES * PIECES % CONSUMERS == 0, "whole pieces a thread");
  auto gather = [&](const __nv_bfloat16* mb, int j) {
    uint4 v[GATHER];
#pragma unroll
    for (int u = 0; u < GATHER; ++u) {
      const int i = threadIdx.x + u * CONSUMERS;
      const int q = j * SLICES + i / PIECES, rem = i % PIECES;
      const int r = rem / (FS / 8), k8 = rem % (FS / 8);
      v[u] = *reinterpret_cast<const uint4*>(
          cluster.map_shared_rank(mb, q) + r * C::LDM + k8 * 8);
    }
#pragma unroll
    for (int u = 0; u < GATHER; ++u) {
      const int i = threadIdx.x + u * CONSUMERS;
      const int q = j * SLICES + i / PIECES, rem = i % PIECES;
      const int r = rem / (FS / 8), k8 = rem % (FS / 8);
      *reinterpret_cast<uint4*>(full + r * ldf + q * FS + k8 * 8) = v[u];
    }
  };
  // phase-2 chunk cc (the j-th): hidden . wo; chunk j + 1's slices are
  // gathered while chunk j - 1's products run
  auto p2_step = [&](uint32_t (&af)[BK / 16][4], const __nv_bfloat16* mb,
                     int cc, int j, bool prev) {
    if (j + 1 < KC2) gather(mb, j + 1);
    const int s = cc % STAGES;
    sm90::mbar_wait(&full_bar[s], (cc / STAGES) & 1);
    const uint32_t wo_s = sm90::smem_u32(ring + s * C::STAGE);
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk)
      load_a(af[kk], full, ldf, r_a, j * BK + kk * 16);
    fence_p2();
    sm90::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk)
#pragma unroll
      for (int nb = 0; nb < NB2; ++nb)
        Wgmma<NB>::rs<1>(
            yacc[nb], af[kk],
            sm90::desc_nmajor<C::SPANW>(C::b_addr(wo_s, nb), BK, kk), 1);
    sm90::wgmma_commit();
    sm90::wgmma_wait<1>();
    fence_p2();
    if (prev) release(cc - 1);
    sm90::bar_sync(1, CONSUMERS);          // chunk j + 1's slices are in
  };

  uint32_t afa[BK / 16][4], afb[BK / 16][4];
  int c = 0;
  for (int li = 0; li < n_local; ++li) {
    const int4 it = a.wk.items[cid + li * a.clusters];
    // this thread's rows: their slots and tokens now, their weights after
    // phase 1, all in registers long before the epilogue reads them
    int slot[2], tok[2];
    float wt[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = 16 * warp + lane / 4 + 8 * h;
      const bool in = writer && r < it.z;
      slot[h] = in ? a.wk.pair_slot[it.y + r] : -1;
      tok[h] = in ? a.wk.pair_tok[it.y + r] : 0;
    }

    // ---- phase 1: this CTA's FS hidden columns of expert it.x
#pragma unroll
    for (int nb = 0; nb < NB1; ++nb) {
      zero(hacc[nb]);
      zero(gacc[nb]);
    }
    int j = 0;
    for (; j + 1 < KC1; j += 2, c += 2) {
      p1_step(afa, c, j > 0);
      p1_step(afb, c + 1, true);
    }
    if (j < KC1) p1_step(afa, c++, j > 0);
    sm90::wgmma_wait<0>();
    fence_p1();
    release(c - 1);
    __nv_bfloat16* mb = mine + (li & 1) * C::MINE;
    if (writer) {
#pragma unroll
      for (int nb = 0; nb < NB1; ++nb)
#pragma unroll
        for (int jj = 0; jj < 4; ++jj)
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int i0 = 4 * jj + 2 * h;
            const int row = 16 * warp + lane / 4 + 8 * h;
            const int col = nb * NB + 8 * jj + 2 * (lane % 4);
            *reinterpret_cast<__nv_bfloat162*>(mb + row * C::LDM + col) =
                __floats2bfloat162_rn(act(hacc[nb][i0], gacc[nb][i0], gelu),
                                      act(hacc[nb][i0 + 1], gacc[nb][i0 + 1],
                                          gelu));
          }
    }
#pragma unroll
    for (int h = 0; h < 2; ++h)
      wt[h] = slot[h] >= 0 ? a.w[(size_t)tok[h] * a.E + it.x] : 0.f;
    // every CTA of the cluster has its slice; the slices of the item
    // before last (the other buffer) were read by all before they arrived
    cluster_sync_all();
    gather(mb, 0);
    sm90::bar_sync(1, CONSUMERS);

    // ---- phase 2: this CTA's DS output columns of hidden x wo
#pragma unroll
    for (int nb = 0; nb < NB2; ++nb) zero(yacc[nb]);
    j = 0;
    for (; j + 1 < KC2; j += 2, c += 2) {
      p2_step(afa, mb, c, j, j > 0);
      p2_step(afb, mb, c + 1, j + 1, true);
    }
    if (j < KC2) p2_step(afa, mb, c++, j, j > 0);
    sm90::wgmma_wait<0>();
    fence_p2();
    release(c - 1);
    // the weighted rows leave through shared memory (`full`, read by no
    // one now) so that each goes out as whole rows of 16-byte stores
    float* stage = reinterpret_cast<float*>(full);
    if (writer) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int row = 16 * warp + lane / 4 + 8 * h;
        if (lane % 4 == 0) rowslot[row] = slot[h];
#pragma unroll
        for (int nb = 0; nb < NB2; ++nb)
#pragma unroll
          for (int jj = 0; jj < 4; ++jj)
            *reinterpret_cast<float2*>(stage + row * C::SST + nb * NB +
                                       8 * jj + 2 * (lane % 4)) =
                make_float2(wt[h] * yacc[nb][4 * jj + 2 * h],
                            wt[h] * yacc[nb][4 * jj + 2 * h + 1]);
      }
    }
    sm90::bar_sync(1, CONSUMERS);
    for (int i = threadIdx.x; i < RT * (DS / 4); i += CONSUMERS) {
      const int r = i / (DS / 4), c4 = i % (DS / 4);
      const int sl = rowslot[r];
      if (sl >= 0)
        *reinterpret_cast<float4*>(a.slots + (size_t)sl * a.d + rank * DS +
                                   4 * c4) =
            *reinterpret_cast<const float4*>(stage + r * C::SST + 4 * c4);
    }
  }
  // the combine may start launching; it waits for this grid to finish
  launch_dependents();
  // no CTA leaves while a peer may still read its hidden slices
  cluster_sync_all();
}

// ------------------------------------------------------------ combine

// y[t] = bf16(sum of token t's slots in ascending expert order), 0 if none
constexpr int COMBINE_THREADS = 128;

__global__ void __launch_bounds__(COMBINE_THREADS)
    moe_combine_kernel(const float* __restrict__ slots,
                       const int* __restrict__ tok_nnz,
                       const int* __restrict__ tok_off,
                       __nv_bfloat16* __restrict__ y, int d) {
  wait_prerequisites();                  // the slots are written
  const int t = blockIdx.x;
  const int col = (blockIdx.y * COMBINE_THREADS + threadIdx.x) * 4;
  if (col >= d) return;
  const int n = tok_nnz[t];
  const float* p = slots + (size_t)tok_off[t] * d + col;
  float4 s = make_float4(0.f, 0.f, 0.f, 0.f);
  for (int j = 0; j < n; ++j, p += d) {
    const float4 v = *reinterpret_cast<const float4*>(p);
    s.x += v.x;
    s.y += v.y;
    s.z += v.z;
    s.w += v.w;
  }
  __nv_bfloat162* out =
      reinterpret_cast<__nv_bfloat162*>(y + (size_t)t * d + col);
  out[0] = __floats2bfloat162_rn(s.x, s.y);
  out[1] = __floats2bfloat162_rn(s.z, s.w);
}

// ---------------------------------------------------------------- host

// Tensor maps of the weights, (E, rows, inner) bf16 as 4-D (inner, rows,
// E, 1) with boxes of `cols` columns (32: 64-byte swizzle, 64: 128-byte)
// x 64 rows, cached by (base, shape, box): the map is a function of those
// alone, so a hit is never stale.
struct MapEntry {
  const void* base;
  int inner, rows, E, cols;
  CUtensorMap map;
};
MapEntry g_maps[256];
int g_n_maps = 0, g_next_map = 0;

int weight_map(CUtensorMap* out, const void* base, int inner, int rows,
               int E, int cols) {
  for (int i = 0; i < g_n_maps; ++i) {
    const MapEntry& m = g_maps[i];
    if (m.base == base && m.inner == inner && m.rows == rows && m.E == E &&
        m.cols == cols) {
      *out = m.map;
      return 0;
    }
  }
  sm90::EncodeTiledFn encode = sm90::encode_tiled();
  if (encode == nullptr) return (int)cudaErrorNotSupported;
  MapEntry& m = g_maps[g_next_map];
  g_next_map = (g_next_map + 1) % 256;
  if (g_n_maps < 256) ++g_n_maps;
  const cuuint64_t dims[4] = {(cuuint64_t)inner, (cuuint64_t)rows,
                              (cuuint64_t)E, 1};
  const cuuint64_t strides[3] = {(cuuint64_t)inner * 2,
                                 (cuuint64_t)inner * rows * 2,
                                 (cuuint64_t)inner * rows * E * 2};
  const cuuint32_t box[4] = {(cuuint32_t)cols, BK, 1, 1};
  const cuuint32_t elem[4] = {1, 1, 1, 1};
  const CUresult r = encode(
      &m.map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(base),
      dims, strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
      cols == 64 ? CU_TENSOR_MAP_SWIZZLE_128B : CU_TENSOR_MAP_SWIZZLE_64B,
      CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
      CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  if (r != CUDA_SUCCESS) {
    m.base = nullptr;
    return 10000 + (int)r;     // a driver error, apart from the runtime's
  }
  m.base = base;
  m.inner = inner;
  m.rows = rows;
  m.E = E;
  m.cols = cols;
  *out = m.map;
  return 0;
}

template <int RT, int FS, int NB2>
cudaError_t prepare() {
  static bool done = false;
  static cudaError_t err = cudaSuccess;
  if (!done) {
    auto kern = moe_ffn_kernel<RT, FS, NB2>;
    err = cudaFuncSetAttribute(kern,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               Cfg<RT, FS, NB2>::SMEM);
    if (err == cudaSuccess)
      err = cudaFuncSetAttribute(
          kern, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    done = true;
  }
  return err;
}

// the FFN launch: clusters of CL, and (the second attribute) allowed to
// start while the plan launch before it runs
cudaLaunchConfig_t config(cudaLaunchAttribute* attr, int clusters, int CL,
                          int smem, cudaStream_t st) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)(clusters * CL));
  cfg.blockDim = dim3(THREADS);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = st;
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = CL;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  attr[1].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[1].val.programmaticStreamSerializationAllowed = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 2;
  return cfg;
}

// clusters of CL the card runs at once (cached per cluster size)
template <int RT, int FS, int NB2>
int active_clusters(int CL) {
  static int cache[17] = {0};
  if (CL < 1 || CL > 16) return -(int)cudaErrorInvalidValue;
  if (cache[CL] == 0) {
    cudaError_t err = prepare<RT, FS, NB2>();
    if (err != cudaSuccess) return -(int)err;
    cudaLaunchAttribute attr[2];
    const cudaLaunchConfig_t cfg =
        config(attr, 1, CL, Cfg<RT, FS, NB2>::SMEM, 0);
    int n = 0;
    err = cudaOccupancyMaxActiveClusters(&n, moe_ffn_kernel<RT, FS, NB2>,
                                         &cfg);
    if (err != cudaSuccess) return -(int)err;
    if (n < 1) return -(int)cudaErrorInvalidConfiguration;
    cache[CL] = n;
  }
  return cache[CL];
}

template <int RT, int FS, int NB2>
int launch_ffn(Args a, const CUtensorMap& twi, const CUtensorMap& twg,
               const CUtensorMap& two, int CL, int max_items,
               cudaStream_t st) {
  const int n = active_clusters<RT, FS, NB2>(CL);
  if (n < 0) return -n;
  a.clusters = min(n, max_items);
  cudaLaunchAttribute attr[2];
  const cudaLaunchConfig_t cfg =
      config(attr, a.clusters, CL, Cfg<RT, FS, NB2>::SMEM, st);
  cudaError_t err =
      cudaLaunchKernelEx(&cfg, moe_ffn_kernel<RT, FS, NB2>, a, twi, twg, two);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

// The regime of T (decode: T <= 16), its cluster size and the output
// blocks a CTA; false on a shape the kernel does not take
struct Shape {
  int decode, CL, NB2;
};

bool shape_of(int T, int d, int f, Shape* s) {
  if (T < 1 || f < 64 || f > MAX_F || f % 64) return false;
  const int clp = f / 64;                       // the prefill cluster
  if (d % (clp * 64) || d / clp > 192) return false;
  s->decode = T <= DECODE_T;
  s->CL = s->decode ? 2 * clp : clp;
  s->NB2 = d / s->CL / NB;
  return true;
}

int max_items(int T, int E) {
  const long long R = item_rows(T);
  const long long n = E + ((long long)T * E + R - 1) / R;
  return (int)(n < 0x7fffffffLL ? n : 0x7fffffffLL);
}

int plan(const float* w, void* ws, int T, int d, int E, cudaStream_t st) {
  moe_plan_kernel<<<1, PLAN_THREADS, 0, st>>>(w, work_at(ws, T, d, E), T, E,
                                               item_rows(T));
  return (int)cudaGetLastError();
}

}  // namespace

// The workspace's byte offsets (slots, tok_nnz, tok_off, pair_tok,
// pair_slot, items, n_items) and, last, its size.
extern "C" int moe_dense_layout(int T, int d, int E, size_t* out) {
  if (T < 1 || d < 1 || E < 1 || E > MAX_E) return (int)cudaErrorInvalidValue;
  size_t o[L_N];
  layout(T, d, E, o);
  for (int i = 0; i < L_N; ++i) out[i] = o[i];
  return 0;
}

// The persistent clusters of a call at (T, d, E, f), or -cudaError.
extern "C" int moe_dense_clusters(int T, int d, int E, int f) {
  Shape s;
  if (E < 1 || !shape_of(T, d, f, &s)) return -(int)cudaErrorInvalidValue;
  int n;
  switch (s.decode * 8 + s.NB2) {
    case 2: n = active_clusters<64, 64, 2>(s.CL); break;
    case 4: n = active_clusters<64, 64, 4>(s.CL); break;
    case 6: n = active_clusters<64, 64, 6>(s.CL); break;
    case 9: n = active_clusters<16, 32, 1>(s.CL); break;
    case 10: n = active_clusters<16, 32, 2>(s.CL); break;
    case 11: n = active_clusters<16, 32, 3>(s.CL); break;
    default: return -(int)cudaErrorInvalidValue;
  }
  return n < 0 ? n : min(n, max_items(T, E));
}

// The work list alone (the first launch), into ws (moe_dense_layout).
extern "C" int moe_dense_plan(const void* w, void* ws, int T, int d, int E,
                              void* stream) {
  if (T < 1 || d < 1 || E < 1 || E > MAX_E) return (int)cudaErrorInvalidValue;
  return plan((const float*)w, ws, T, d, E, (cudaStream_t)stream);
}

// x (T, d) bf16, w (T, E) f32, wi/wg (E, d, f) bf16, wo (E, f, d) bf16,
// y (T, d) bf16, ws the workspace of moe_dense_layout; all contiguous and
// 16-byte aligned.  f a multiple of 64 up to 512; d / (f / 64) a multiple
// of 64 up to 192; E <= 1024.  act_gelu 0: swiglu, 1: gelu (wg unread).
extern "C" int moe_dense(const void* x, const void* w, const void* wi,
                         const void* wg, const void* wo, void* y, void* ws,
                         int T, int d, int E, int f, int act_gelu,
                         void* stream) {
  Shape s;
  if (E < 1 || E > MAX_E || !shape_of(T, d, f, &s))
    return (int)cudaErrorInvalidValue;
  const cudaStream_t st = (cudaStream_t)stream;
  CUtensorMap twi, twg, two;
  const int cols = s.decode ? 32 : 64;          // Cfg::BCOLS of the regime
  int rc = weight_map(&twi, wi, f, d, E, cols);
  if (rc == 0)
    rc = act_gelu ? (twg = twi, 0) : weight_map(&twg, wg, f, d, E, cols);
  if (rc == 0) rc = weight_map(&two, wo, d, f, E, cols);
  if (rc) return rc;
  if ((rc = plan((const float*)w, ws, T, d, E, st))) return rc;
  size_t o[L_N];
  layout(T, d, E, o);
  const Args a{(const __nv_bfloat16*)x, (const float*)w,
               reinterpret_cast<float*>((unsigned char*)ws + o[L_SLOTS]),
               work_at(ws, T, d, E), E, d, f, act_gelu != 0, 0};
  const int mi = max_items(T, E);
  switch (s.decode * 8 + s.NB2) {
    case 2: rc = launch_ffn<64, 64, 2>(a, twi, twg, two, s.CL, mi, st); break;
    case 4: rc = launch_ffn<64, 64, 4>(a, twi, twg, two, s.CL, mi, st); break;
    case 6: rc = launch_ffn<64, 64, 6>(a, twi, twg, two, s.CL, mi, st); break;
    case 9: rc = launch_ffn<16, 32, 1>(a, twi, twg, two, s.CL, mi, st); break;
    case 10: rc = launch_ffn<16, 32, 2>(a, twi, twg, two, s.CL, mi, st); break;
    case 11: rc = launch_ffn<16, 32, 3>(a, twi, twg, two, s.CL, mi, st); break;
    default: return (int)cudaErrorInvalidValue;
  }
  if (rc) return rc;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)T, (unsigned)((d / 4 + COMBINE_THREADS - 1) /
                                             COMBINE_THREADS));
  cfg.blockDim = dim3(COMBINE_THREADS);
  cfg.stream = st;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[0].val.programmaticStreamSerializationAllowed = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const cudaError_t err =
      cudaLaunchKernelEx(&cfg, moe_combine_kernel, (const float*)a.slots,
                         (const int*)a.wk.tok_nnz, (const int*)a.wk.tok_off,
                         (__nv_bfloat16*)y, d);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}
