// Causal / sliding-window GQA flash attention (the prefill attention of
// the dense, hybrid and MoE families), hand-written for sm_90a.
//
// Replaces the TPU kernel K11: src/repro/kernels/flash_attention.py,
// `_attn_kernel` (pallas_call at flash_attention.py:119).  Same function:
// q (B, Sq, H, E), k and v (B, Sk, KV, E), all bf16, -> (B, Sq, H, E)
// bf16, GQA groups of M = H / KV query heads per KV head; query row s sits
// at position q_offset + s; with `causal` it admits key t <= position and,
// with a window > 0, position - t < window.  Scores, the online-softmax
// carry (m, l) and the accumulator are f32, masked scores -1e30 (the TPU
// kernel's and the oracle's constant), the output acc / max(l, 1e-30)
// rounded to bf16 once.  Any Sq and Sk are accepted (the TPU kernel
// asserts Sq % block_q == 0): rows past Sq are neither computed into nor
// written, keys past Sk arrive as zero rows and are masked.
//
// The work.  As on the TPU, the M query heads of a KV head ride together
// as flattened (position, head) rows r = s * M + m, so each K/V row is
// read once for all M heads, for any M.  A work item is 64, 128 or 192
// such rows of one (batch, KV head) and the key tiles of 64 keys inside
// [lo, hi) of its positions (the TPU kernel's skip of blocks above the
// diagonal and below the window).  The wrapper's rule
// (`flash_attention.plan`, a function of the shape and the SM count)
// takes the largest item whose count still reaches the SM count: 192
// rows at hymba-1.5b's S = 1500 (200 items), 128 at granite's S = 700
// (136), else 64 (smollm-360m's S = 600: 145 items where 128 rows would
// give 75).  A 64-row item splits its key walk between its two consumers
// (alternate tiles, the partials merged through shared memory by the
// log-sum-exp rule at the end), which halves the chains.  (A split across
// items, its partials merged by a second kernel through f32 scratch, was
// measured slower at every serving shape: the scratch traffic costs more
// than it saves.)  Items are launched heaviest first (the last causal row
// tiles first), so the light ones fill the tail of the last wave.
//
// What bounds it on the H100: operations.  Per admitted (query head, key)
// pair it does 4E flops (q·k and p·v) and moves only q, k, v and o: at
// hymba-1.5b's S = 1500 a global layer is 7.2 GFLOP against 11.5 MB,
// ~7.3 us at the bf16 peak.  Beside the products, one exp2 per pair on
// the 16 multi-function units of an SM takes as many cycles as the
// tensor cores' products at E = 64, so the exponentials and the other
// softmax instructions have to overlap the products.  The parent kernel
// (mma.sync, 64 rows a CTA of 4 warps) ran at ~60 TFLOP/s; what this
// design does about each of its limits:
//
// * Products on wgmma.  A CTA is a producer warpgroup and two or three
//   consumer warpgroups of 64 rows.  S = Q·K^T is a wgmma of 64 rows by
//   64 keys with Q and K both in shared memory (K's rows are keys with E
//   contiguous: the K-major B operand as it lies); O += P·V takes P from
//   registers (the S accumulator re-packed as bf16 A fragments) and V
//   from shared memory through wgmma's transposed-B mode, so no thread
//   loads an operand by hand.  128-byte swizzle at E = 64, 128 and 160 (a
//   64-column block is one 128-byte row), 64-byte at E = 32 (sm90.cuh).
// * E = 160 (stablelm-12b): a 320-byte row is 2.5 column blocks of the
//   128-byte swizzle, which no box or wgmma operand covers.  The tiles
//   are kept EP = 192 columns wide: the TMA boxes read the third block
//   past the tensor's 160 columns, which arrive as zeros; q·k walks only
//   E / 16 = 10 k16 steps (the q columns past E are never read); p·v is
//   one m64n192 product whose 32 columns past E sum zeros and are never
//   stored.  The wider tiles leave room for a ring of 3 stages beside the
//   128-row q tile (4 at E <= 128), and E = 160 takes 128-row items only
//   (a 64-row item's merge area would not fit beside them).
// * Overlap.  Each consumer is software-pipelined: step i issues tile i's
//   q·k and tile i - 1's p·v, waits for the first only, and takes tile
//   i's softmax while the tensor cores run the second; the other
//   consumers' steps fill the gaps.  Branches around wgmma are on
//   warp-uniform values (`sm90::warp_uniform`): otherwise ptxas
//   serialises every product (warning C7520), which cost the overlap.
// * One p·v product.  p is rounded once to bf16, as the reference
//   model's own prefill does (`p = softmax(s).astype(v.dtype)`,
//   src/repro/models/attention.py); the row sum l stays the f32 sum of
//   the unrounded p.  (Keeping p to 2^-16 as bf16 hi + lo takes two
//   products and was 8-14 % slower; PERF.md sets both beside f64.)
// * Masks only at the edges.  Each consumer sorts the item's key tiles
//   for its 64 rows: a run [a0, a1) that admits some pair (the tiles
//   before and after it are waited for and released only) and, inside
//   it, interior tiles (every pair admitted, every key < Sk: the scale
//   folds into the exponent's FMA) and edge tiles (the diagonal ones,
//   the window's first, the last one past Sk: per-element index test).
//   A row's first visited tile may admit none of its keys: m stays -1e30
//   and p = exp2(0) = 1 on masked keys, finite, until its first admitted
//   key, where alpha = exp2(-1e30 - m) = 0 resets l and acc, as in the
//   TPU kernel; no -inf enters, so no NaN.
// * A TMA-fed K/V ring shared by every row of the item.  One producer
//   thread keeps a ring of 4 stages of K and V tiles in flight with
//   cp.async.bulk.tensor loads through 4-D tensor maps (E, KV, Sk, B),
//   so rows past Sk arrive zero-filled and batch b + 1's keys never enter
//   batch b's last tile; a full barrier per stage and operand counts the
//   bytes in, an empty barrier collects one arrival from each consumer
//   warp before the stage is refilled.  Each K/V tile feeds 128 or 192
//   rows (the parent re-read it from L2 for every 64; a 64-row item's
//   tile feeds its 64, the price of its halved chain).  Q is read once
//   per item with cp.async (a tile of flattened rows starts mid-position
//   when the item's rows are no multiple of M, which no TMA box
//   describes) into the same swizzled layout.
// * A grid that fills the card (above): one CTA an SM (384 or 512
//   threads, registers rebalanced to the consumers with setmaxnreg),
//   items sized by the plan, heaviest first.
//
// Left for later: no ping-pong schedule orders the consumers' softmax
// against each other's products; q·k of tile i + 1 is not issued before
// tile i's softmax (two score accumulators); the output leaves through
// registers, not a TMA store.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "sm90.cuh"

namespace {

using sm90::Wgmma;

constexpr int BK = 64;                    // keys per K/V tile
constexpr int WG_ROWS = 64;               // rows of one consumer warpgroup
constexpr float NEG_INF = -1e30f;

struct Args {
  const __nv_bfloat16* q;      // (B, Sq, KV * M, E)
  __nv_bfloat16* out;          // (B, Sq, KV * M, E)
  int B, Sq, Sk, KV, M;
  int causal, window, q_offset;   // window 0: no window
  int tiles;                      // row tiles of an item's rows
  float scale_log2;               // 1/sqrt(E) * log2(e): scores in log2
};

// A CTA of the producer and CONSUMERS warpgroups of 64 rows: an item of
// 128 or 192 rows (2 or 3 consumers, each its own rows), or of 64 rows
// whose key walk the two consumers share, taking alternate tiles, their
// partials merged through shared memory (SHARED).  Registers a thread
// after setmaxnreg: the producer gives its own up to the consumers (64 K a
// CTA, one block an SM).
template <int E, int ITEM_ROWS>
struct Layout {
  static constexpr bool SHARED = ITEM_ROWS == WG_ROWS;
  static constexpr int CONSUMERS = SHARED ? 2 : ITEM_ROWS / WG_ROWS;
  static constexpr int ROWS = WG_ROWS * CONSUMERS;  // rows of the q tile
  static constexpr int THREADS = 128 * (1 + CONSUMERS);
  static constexpr int PRODUCER_REGS = CONSUMERS == 2 ? 40 : 24;
  static constexpr int CONSUMER_REGS = CONSUMERS == 2 ? 232 : 160;
  static constexpr int SPAN = E == 32 ? 64 : 128;   // bytes of a tile row
  static constexpr int COLS = SPAN / 2;             // columns of a block
  // the tiles' width: E rounded up to whole column blocks (192 at E = 160)
  static constexpr int EP = (E + COLS - 1) / COLS * COLS;
  static constexpr int STAGES = EP > 128 ? 3 : 4;   // K/V ring depth
  static constexpr int Q_BYTES = ROWS * EP * 2;
  static constexpr int KV_BYTES = BK * EP * 2;      // one K or V tile
  static constexpr int BAR_OFF = Q_BYTES + 2 * STAGES * KV_BYTES;
  // SHARED: the second consumer's acc, m and l, one slot per thread
  static constexpr int MERGE_FLOATS = E / 2 + 4;
  static constexpr int MERGE_OFF = BAR_OFF + 3 * STAGES * 8;
  static constexpr int SMEM =
      MERGE_OFF + (SHARED ? 128 * MERGE_FLOATS * 4 : 0) + 1024;  // + align
};

__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src,
                                           int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(src), "r"(src_bytes)
               : "memory");
}

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// The work item of block `item`: its batch row, KV head and row tile.
// Row tiles run from the last to the first (heaviest first under a causal
// mask; tests/test_torch_flash_attention.py mirrors the order).
struct Item {
  int b, g, tile;
};

__device__ __forceinline__ Item decode_item(const Args& a, int item) {
  Item it;
  it.g = item % a.KV;
  item /= a.KV;
  it.b = item % a.B;
  it.tile = a.tiles - 1 - item / a.B;
  return it;
}

template <int E, int ITEM_ROWS>
__global__ void __launch_bounds__(Layout<E, ITEM_ROWS>::THREADS, 1)
    flash_attn_kernel(const Args a, const __grid_constant__ CUtensorMap tmk,
                      const __grid_constant__ CUtensorMap tmv) {
  using L = Layout<E, ITEM_ROWS>;
  constexpr int SPAN = L::SPAN, COLS = L::COLS, EP = L::EP, NCB = EP / COLS;
  constexpr int ROWS = L::ROWS, STAGES = L::STAGES;
  constexpr bool SHARED = L::SHARED;
  extern __shared__ unsigned char smem_raw[];
  // 1024-byte aligned: the swizzle pattern is a function of the address
  unsigned char* smem = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  unsigned char* qs = smem;
  unsigned char* ks = smem + L::Q_BYTES;
  unsigned char* vs = ks + STAGES * L::KV_BYTES;
  uint64_t* full_k = reinterpret_cast<uint64_t*>(smem + L::BAR_OFF);
  uint64_t* full_v = full_k + STAGES;
  uint64_t* empty = full_v + STAGES;

  const Item it = decode_item(a, blockIdx.x);
  const int M = a.M, n_rows = a.Sq * M;
  const int r0 = it.tile * ITEM_ROWS;
  const int r_end = min(r0 + ITEM_ROWS, n_rows);
  // the keys this item visits: the tiles of [lo, hi) of its positions
  const int p_first = r0 / M + a.q_offset;
  const int p_last = (r_end - 1) / M + a.q_offset;
  const int hi = a.causal ? min(a.Sk, p_last + 1) : a.Sk;
  const int lo =
      (a.causal && a.window > 0) ? max(p_first - a.window + 1, 0) : 0;
  const int kt_begin = lo / BK, n_tiles = (hi + BK - 1) / BK - kt_begin;

  if (threadIdx.x == 0) {
    for (int s = 0; s < STAGES; ++s) {
      sm90::mbar_init(&full_k[s], 1);
      sm90::mbar_init(&full_v[s], 1);
      // one arrival per warp of the consumers that read the stage
      sm90::mbar_init(&empty[s], SHARED ? 4 : 4 * L::CONSUMERS);
    }
    sm90::mbar_fence_init();
  }
  __syncthreads();

  const int wg = sm90::warp_uniform(threadIdx.x / 128);
  if (wg == 0) {
    // ------------------------------------------------------- producer
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(
        L::PRODUCER_REGS));
    if (threadIdx.x == 0) {
      sm90::tma_prefetch_map(&tmk);
      sm90::tma_prefetch_map(&tmv);
      for (int i = 0; i < n_tiles; ++i) {
        const int s = i % STAGES;
        if (i >= STAGES) sm90::mbar_wait(&empty[s], ((i / STAGES) - 1) & 1);
        const int k0 = (kt_begin + i) * BK;
        sm90::mbar_arrive_expect_tx(&full_k[s], L::KV_BYTES);
#pragma unroll
        for (int cb = 0; cb < NCB; ++cb)
          sm90::tma_load_4d(ks + s * L::KV_BYTES + cb * BK * SPAN, &tmk,
                            &full_k[s], cb * COLS, it.g, k0, it.b);
        sm90::mbar_arrive_expect_tx(&full_v[s], L::KV_BYTES);
#pragma unroll
        for (int cb = 0; cb < NCB; ++cb)
          sm90::tma_load_4d(vs + s * L::KV_BYTES + cb * BK * SPAN, &tmv,
                            &full_v[s], cb * COLS, it.g, k0, it.b);
      }
    }
    return;
  }

  // --------------------------------------------------------- consumers
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(
      L::CONSUMER_REGS));
  const int c = wg - 1;                        // this consumer
  const int tid = threadIdx.x - 128 * wg;
  const int warp = sm90::warp_uniform(tid / 32), lane = tid % 32;
  const int H = a.KV * M;
  const int rw0 = SHARED ? r0 : r0 + c * WG_ROWS;  // first row of the group

  // q: this group's 64 rows into the swizzled tile (rows past Sq zero)
#pragma unroll
  for (int j = 0; j < WG_ROWS * (E / 8) / 128; ++j) {
    const int i = tid + 128 * j;
    const int r = i / (E / 8), c8 = (i % (E / 8)) * 8;
    const int row = rw0 + r;
    const bool in = row < n_rows;
    const int t = in ? row / M : 0, m = in ? row - t * M : 0;
    const __nv_bfloat16* src =
        a.q + (((size_t)it.b * a.Sq + t) * H + (size_t)it.g * M + m) * E + c8;
    cp_async16(sm90::smem_u32(qs) +
                   sm90::tile_offset<SPAN>(ROWS, c * WG_ROWS + r, c8),
               src, in ? 16 : 0);
  }
  asm volatile("cp.async.commit_group;\ncp.async.wait_group 0;\n" ::
                   : "memory");
  sm90::fence_proxy_async();
  sm90::bar_sync(1 + c, 128);

  // this thread's rows: rw0 + 16 warp + lane / 4 (+ 8)
  int pos[2];
#pragma unroll
  for (int h = 0; h < 2; ++h)
    pos[h] = (rw0 + warp * 16 + lane / 4 + 8 * h) / M + a.q_offset;
  const bool any_row = rw0 < n_rows;
  const int w_first = rw0 / M + a.q_offset;
  const int w_last = (min(rw0 + WG_ROWS, n_rows) - 1) / M + a.q_offset;
  const uint32_t q_tile = sm90::smem_u32(qs) + c * WG_ROWS * SPAN;

  // the accumulator of p·v over EP columns: o[e] for e >= E / 2 holds the
  // columns past E, zeros, never rescaled or stored
  float o[EP / 2];
#pragma unroll
  for (int i = 0; i < EP / 2; ++i) o[i] = 0.f;
  float m_r[2] = {NEG_INF, NEG_INF}, l_r[2] = {0.f, 0.f};

  // This group's tiles: the item's (SHARED: every other one, from tile
  // c), j-th at item tile tile_of(j).  Those its rows see form one run
  // [a0, a1) of j (tiles above every row's diagonal end it, tiles below
  // every row's window start it); the others are waited for and released
  // only.
  const int n_mine = SHARED ? (n_tiles - c + 1) / 2 : n_tiles;
  auto tile_of = [&](int j) { return SHARED ? c + 2 * j : j; };
  auto kind_of = [&](int i) {   // 0: no pair admitted, 1: edge, 2: interior
    const int k0 = (kt_begin + i) * BK;
    if (!any_row) return 0;
    if (a.causal && (k0 > w_last || (a.window > 0 &&
                                     k0 + BK - 1 <= w_first - a.window)))
      return 0;
    const bool inner = k0 + BK <= a.Sk &&
                       (!a.causal || (k0 + BK - 1 <= w_first &&
                                      (a.window == 0 ||
                                       w_last - k0 < a.window)));
    return inner ? 2 : 1;
  };
  int a0 = -1, a1 = -1;
  for (int j = 0; j < n_mine; ++j)
    if (kind_of(tile_of(j))) {
      if (a0 < 0) a0 = j;
      a1 = j + 1;
    }
  if (a0 < 0) a0 = a1 = n_mine;

  auto stage = [&](int i) { return i % STAGES; };
  auto parity = [&](int i) { return (uint32_t)((i / STAGES) & 1); };
  auto release = [&](int i) {
    __syncwarp();
    if (lane == 0) sm90::mbar_arrive(&empty[stage(i)]);
  };
  auto pass = [&](int i) {
    sm90::mbar_wait(&full_k[stage(i)], parity(i));
    sm90::mbar_wait(&full_v[stage(i)], parity(i));
    release(i);
  };
  auto issue_qk = [&](float (&sc)[BK / 2], int i) {
    const uint32_t k_tile = sm90::smem_u32(ks + stage(i) * L::KV_BYTES);
#pragma unroll
    for (int kk = 0; kk < E / 16; ++kk)
      Wgmma<BK>::ss(sc, sm90::desc_kmajor<SPAN>(q_tile, ROWS, kk),
                    sm90::desc_kmajor<SPAN>(k_tile, BK, kk), kk > 0);
    sm90::wgmma_commit();
  };
  uint32_t p[BK / 16][4];
  auto issue_pv = [&](int i) {
    const uint32_t v_tile = sm90::smem_u32(vs + stage(i) * L::KV_BYTES);
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk)
      Wgmma<EP>::template rs<1>(o, p[kk],
                                sm90::desc_nmajor<SPAN>(v_tile, BK, kk), 1);
    sm90::wgmma_commit();
  };
  // the online softmax of tile i's scores, left in sc as p; alpha rescales
  // the rows' earlier acc
  auto softmax = [&](float (&sc)[BK / 2], int i, float (&alpha)[2]) {
    const int k0 = (kt_begin + i) * BK;
    // an interior tile keeps raw scores and folds the scale into the
    // exponent's FMA; an edge tile scales (log2 domain) and masks first.
    // sc[4j + 2h + cc] is row half h, key k0 + 8j + 2 (lane % 4) + cc
    const bool interior = kind_of(i) == 2;
    const float cs = interior ? a.scale_log2 : 1.f;
    float mx[2] = {NEG_INF, NEG_INF};
    if (interior) {
#pragma unroll
      for (int j = 0; j < BK / 2; ++j)
        mx[(j >> 1) & 1] = fmaxf(mx[(j >> 1) & 1], sc[j]);
    } else {
#pragma unroll
      for (int j = 0; j < BK / 2; ++j) {
        const int key = k0 + 8 * (j >> 2) + 2 * (lane & 3) + (j & 1);
        const int qp = pos[(j >> 1) & 1];
        bool ok = key < a.Sk;
        if (a.causal) {
          ok = ok && key <= qp;
          if (a.window > 0) ok = ok && qp - key < a.window;
        }
        sc[j] = ok ? sc[j] * a.scale_log2 : NEG_INF;
        mx[(j >> 1) & 1] = fmaxf(mx[(j >> 1) & 1], sc[j]);
      }
    }
    float neg_m[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 1));
      mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 2));
      const float m_new = fmaxf(m_r[h], mx[h] * cs);
      alpha[h] = ex2(m_r[h] - m_new);
      m_r[h] = m_new;
      neg_m[h] = -m_new;
      l_r[h] *= alpha[h];                 // this lane's part of the row sum
    }
#pragma unroll
    for (int j = 0; j < BK / 2; ++j) {
      sc[j] = ex2(fmaf(sc[j], cs, neg_m[(j >> 1) & 1]));
      l_r[(j >> 1) & 1] += sc[j];
    }
  };
  // keys 16kk .. 16kk + 15 are score columns 8 (2kk) .. 8 (2kk + 1) + 7,
  // whose accumulator registers are the A fragment of p·v
  auto pack = [&](const float (&sc)[BK / 2]) {
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int src = 8 * kk + (r & 1) * 2 + (r >> 1) * 4;
        p[kk][r] = pack_bf16(sc[src], sc[src + 1]);
      }
    }
  };

  for (int j = 0; j < a0; ++j) pass(tile_of(j));
  if (a0 < a1) {
    // Software-pipelined: in step j the tensor cores run tile j's q·k and
    // then tile j - 1's p·v while the warps wait for the first and take
    // the softmax of tile j during the second.
    float sc[BK / 2], alpha[2];
    const int i0 = tile_of(a0);
    sm90::mbar_wait(&full_k[stage(i0)], parity(i0));
    sm90::fence_operand(sc);
    sm90::wgmma_fence();
    issue_qk(sc, i0);
    sm90::wgmma_wait<0>();
    sm90::fence_operand(sc);
    softmax(sc, i0, alpha);               // acc is 0: alpha has no use
    pack(sc);
    for (int j = a0 + 1; j < a1; ++j) {
      const int i = tile_of(j), ip = tile_of(j - 1);
      sm90::mbar_wait(&full_k[stage(i)], parity(i));
      sm90::fence_operand(sc);
      sm90::fence_operand(o);
      sm90::wgmma_fence();
      issue_qk(sc, i);
      sm90::mbar_wait(&full_v[stage(ip)], parity(ip));
      issue_pv(ip);
      sm90::wgmma_wait<1>();              // tile i's scores are in
      sm90::fence_operand(sc);
      softmax(sc, i, alpha);
      sm90::wgmma_wait<0>();              // tile ip's p·v is in
      sm90::fence_operand(o);
      release(ip);
#pragma unroll
      for (int e = 0; e < E / 2; ++e) o[e] *= alpha[(e >> 1) & 1];
      pack(sc);
    }
    const int il = tile_of(a1 - 1);
    sm90::mbar_wait(&full_v[stage(il)], parity(il));
    sm90::fence_operand(o);
    sm90::wgmma_fence();
    issue_pv(il);
    sm90::wgmma_wait<0>();
    sm90::fence_operand(o);
    release(il);
  }
  for (int j = a1; j < n_mine; ++j) pass(tile_of(j));

#pragma unroll
  for (int h = 0; h < 2; ++h) {           // the whole row sum
    l_r[h] += __shfl_xor_sync(0xffffffffu, l_r[h], 1);
    l_r[h] += __shfl_xor_sync(0xffffffffu, l_r[h], 2);
  }
  if constexpr (SHARED) {
    // the second consumer's partial joins the first's by the log-sum-exp
    // rule; thread t of both holds the same rows and columns
    float* slot = reinterpret_cast<float*>(smem + L::MERGE_OFF) +
                  tid * L::MERGE_FLOATS;
    if (c == 1) {
#pragma unroll
      for (int e = 0; e < E / 2; ++e) slot[e] = o[e];
      slot[E / 2] = m_r[0];
      slot[E / 2 + 1] = m_r[1];
      slot[E / 2 + 2] = l_r[0];
      slot[E / 2 + 3] = l_r[1];
    }
    sm90::bar_sync(1 + L::CONSUMERS, 256);
    if (c == 1) return;
    float w0[2], w1[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const float m1 = slot[E / 2 + h];
      const float m_new = fmaxf(m_r[h], m1);
      w0[h] = ex2(m_r[h] - m_new);
      w1[h] = ex2(m1 - m_new);
      m_r[h] = m_new;
      l_r[h] = l_r[h] * w0[h] + slot[E / 2 + 2 + h] * w1[h];
    }
#pragma unroll
    for (int e = 0; e < E / 2; ++e)
      o[e] = o[e] * w0[(e >> 1) & 1] + slot[e] * w1[(e >> 1) & 1];
  }

  // epilogue: o / l to bf16
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = rw0 + warp * 16 + lane / 4 + 8 * h;
    if (row >= n_rows) continue;
    const int t = row / M, m = row - t * M;
    const float inv = 1.f / fmaxf(l_r[h], 1e-30f);
    __nv_bfloat16* dst =
        a.out + (((size_t)it.b * a.Sq + t) * H + (size_t)it.g * M + m) * E +
        2 * (lane & 3);
#pragma unroll
    for (int j = 0; j < E / 8; ++j)
      *reinterpret_cast<__nv_bfloat162*>(dst + 8 * j) = __floats2bfloat162_rn(
          o[4 * j + 2 * h] * inv, o[4 * j + 2 * h + 1] * inv);
  }
}

// K or V (B, Sk, KV, E) as a 4-D map (E, KV, Sk, B), innermost first, with
// boxes of (COLS, 1, BK, 1): keys past Sk arrive as zero rows
template <int E>
int encode_kv_map(CUtensorMap* map, const void* base, int B, int Sk,
                  int KV) {
  using L = Layout<E, 128>;
  sm90::EncodeTiledFn encode = sm90::encode_tiled();
  if (encode == nullptr) return (int)cudaErrorNotSupported;
  const cuuint64_t dims[4] = {(cuuint64_t)E, (cuuint64_t)KV, (cuuint64_t)Sk,
                              (cuuint64_t)B};
  const cuuint64_t strides[3] = {(cuuint64_t)E * 2, (cuuint64_t)KV * E * 2,
                                 (cuuint64_t)Sk * KV * E * 2};
  const cuuint32_t box[4] = {(cuuint32_t)L::COLS, 1, (cuuint32_t)BK, 1};
  const cuuint32_t elem[4] = {1, 1, 1, 1};
  const CUresult r = encode(
      map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(base), dims,
      strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
      L::SPAN == 128 ? CU_TENSOR_MAP_SWIZZLE_128B : CU_TENSOR_MAP_SWIZZLE_64B,
      CU_TENSOR_MAP_L2_PROMOTION_L2_128B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  // a driver error, kept apart from the runtime's codes
  return r == CUDA_SUCCESS ? 0 : 10000 + (int)r;
}

template <int E, int ITEM_ROWS>
int launch(const Args& a, const void* k, const void* v, cudaStream_t st) {
  using L = Layout<E, ITEM_ROWS>;
  static bool attr_set = false;
  if (!attr_set) {
    const cudaError_t err = cudaFuncSetAttribute(
        flash_attn_kernel<E, ITEM_ROWS>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, L::SMEM);
    if (err != cudaSuccess) return (int)err;
    attr_set = true;
  }
  CUtensorMap tmk, tmv;
  int rc = encode_kv_map<E>(&tmk, k, a.B, a.Sk, a.KV);
  if (rc == 0) rc = encode_kv_map<E>(&tmv, v, a.B, a.Sk, a.KV);
  if (rc) return rc;
  const long long items = (long long)a.tiles * a.B * a.KV;
  flash_attn_kernel<E, ITEM_ROWS>
      <<<(unsigned)items, L::THREADS, L::SMEM, st>>>(a, tmk, tmv);
  return (int)cudaGetLastError();
}

}  // namespace

// q (B, Sq, KV * M, E), k and v (B, Sk, KV, E), out like q; all bf16,
// contiguous, 16-byte aligned.  E in {32, 64, 128, 160}; window 0 means no
// window.  Items of `rows` flattened rows (`flash_attention.plan`): 64
// (two consumers share the rows and split the key walk) at E <= 128, 128,
// or 192 at E <= 64.
extern "C" int flash_attention(const void* q, const void* k, const void* v,
                               void* out, int B, int Sq, int Sk, int KV,
                               int M, int E, int causal, int window,
                               int q_offset, float scale, int rows,
                               void* stream) {
  if (B < 1 || Sq < 1 || Sk < 1 || KV < 1 || M < 1 || window < 0 ||
      q_offset < 0 || (long long)Sq * M > (1LL << 30) ||
      !(rows == 128 || (rows == 64 && E <= 128) || (rows == 192 && E <= 64)))
    return (int)cudaErrorInvalidValue;
  const int tiles = (int)(((long long)Sq * M + rows - 1) / rows);
  if ((long long)tiles * B * KV > 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  const Args a{(const __nv_bfloat16*)q,
               (__nv_bfloat16*)out,
               B, Sq, Sk, KV, M,
               causal != 0, window, q_offset,
               tiles,
               scale * 1.4426950408889634f};
  const cudaStream_t st = (cudaStream_t)stream;
  switch (E * 4 + rows / WG_ROWS) {
#define FA_CASE(E_, R_)                 \
  case (E_) * 4 + (R_) / WG_ROWS:       \
    return launch<E_, R_>(a, k, v, st);
    FA_CASE(32, 64) FA_CASE(64, 64) FA_CASE(128, 64)
    FA_CASE(32, 128) FA_CASE(64, 128) FA_CASE(128, 128)
    FA_CASE(32, 192) FA_CASE(64, 192)
    FA_CASE(160, 128)
#undef FA_CASE
    default: return (int)cudaErrorInvalidValue;
  }
}
