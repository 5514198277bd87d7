// Chunked-recompute BLSTM backward, hand-written for sm_90a.
//
// Replaces the TPU kernel K3: src/repro/kernels/lstm_cell.py,
// `_make_bwd_chunked_kernel` / `_run_bwd_chunked` (pallas_call at
// lstm_cell.py:823), run once per direction by `_run_bwd_train` when
// seq_chunk != 0.  The training forward (K1's chunk-entry variant,
// lstm_fwd.cu) kept only the (h, c) carry entering every K-step chunk, so
// nothing of size T·H is stashed.  On the TPU one grid step of a
// (B/bB, T/K) grid takes one chunk in reverse recurrence order: phase 1
// re-runs the chunk's forward from its entry carry into VMEM scratch,
// phase 2 runs K2's reverse steps against it, carrying (dh, dc) across
// chunks in scratch and accumulating dWx, dWh and db in resident f32
// blocks.  CTAs have no order, so here the chunk loop runs on the host
// (inside `lstm_bwd_chunked`, one call from Python) and every chunk is
// seven launches, each over all learners (and, but for dx, both
// directions):
//
//  (a) gx = x·Wx of the chunk's frames: the batched GEMM of gemm.cuh with
//      a chunk-row view of x.  Each element sums over D in the order
//      lstm_xproj sums it (the tile loop over D does not depend on M), so
//      it equals the forward's x-projection bit for bit.
//  (b) the replay: lstm_recur.cuh's forward recurrence in REPLAY mode —
//      the same per-unit sums and cell update K1 ran, on the launch the
//      plan picks (resident at the train-long shape) — from the entry
//      carry, writing the
//      chunk's gates and c in f32 into (2, L, B, K, ·) buffers.  With an
//      f32 stash the replayed gates and c are the unchunked stash bit for
//      bit; with a bf16 stash the entry c is rounded, as the reference's.
//  (c) the reverse steps: K2's cluster recurrence (lstm_recur.cuh) over
//      the chunk,
//      (dh, dc) read from and written back to (2, L, B, H) f32 carries,
//      c_{t-1} of the chunk's first step taken from the entry carry.
//  (d) dx of the chunk's frames (two GEMM launches, one per direction,
//      adding bf16(dgates·Wxᵀ) into the zeroed bf16 dx as lstm_bwd_dx
//      rounds it: each direction's part rounded, summed in f32, rounded),
//      then dWx += xᵀ·dgates and [dWh; db] += [h_prev; 1]ᵀ·dgates with
//      h_prev read from y (the layer output, which the next layer holds
//      anyway), both directions in one launch each, accumulated in f32
//      across chunks.
//
// Chunk r of the forward direction covers frames [rK, (r+1)K), of the
// reverse direction [T_pad-(r+1)K, T_pad-rK) (lstm_recur.cuh): in one
// iteration the two directions work on different frames, so dx is summed
// into place and never formed per chunk for both directions at once.
// Every buffer but x, y, dy, dx and the weight gradients is chunk-sized:
// gx, gates and dgates 4H f32 per (row, frame of the chunk), c H, the
// carries 2H per row.
//
// What bounds it on the H100: the two serial recurrences, T_pad steps each
// per layer.  At K = 256 the replay runs resident (Wh read into shared
// memory once per chunk launch, 5 waves of 7 clusters of 16 CTAs), bound
// by its product's issue rate (~3 us a step); the reverse steps stream
// each step's Wh from device memory as K2's do (~36 us a step at the
// train-long shape); then the tensor-core GEMMs (x·Wx again, dx, dWx,
// dWh), ~1.3x K2's products.  The extra forward recurrence is the price
// of the O(T/K) stash.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "gemm.cuh"
#include "lstm_recur.cuh"

using bf16 = __nv_bfloat16;

// x (L, B, T, D) bf16, y and dy (L, B, T, 2H) bf16; hb, cb (2, L, B, n, H)
// entry carries (carry_kind 1 = f32, 2 = bf16), n = ceil(T / K); wx_dir
// (L, D, 4H) bf16; whX4 (L, H, H, 4) in the forward kernel's layout
// (replay) and whX4b in the backward kernel's; b_dir (L, 4H) f32; lengths
// (L, B) <= T.  Scratch: gx (L, 2, B*K, 4H), acts and dg (2, L, B, K, 4H),
// cseq (2, L, B, K, H), all f32.  In/out: dh, dc (2, L, B, H) f32 carries
// (zero on entry), dx (L, B, T, D) bf16 (zero on entry, or null), dwx
// (2, L, D, 4H) and dwhb (2, L, H + 1, 4H) f32 (zero on entry; row H: db).
// The plan as blstm_recur's (lstm_fwd.cu): with resident = 1, whX4 in the
// resident layout; the reverse streams whX4b on clusters of `cluster`.
// nd = 1: direction d0 alone (the unidirectional `lstm_sequence`'s
// backward), every 2 above a 1, its weights in the X = f and X = b
// arguments alike, and dx = bf16(dgates·Wxᵀ) of that direction only.
extern "C" int lstm_bwd_chunked(
    const void* x, const void* y, const void* dy, const void* hb,
    const void* cb, const void* wxf, const void* wxb, const void* whf4,
    const void* whb4, const void* whf4b, const void* whb4b, const void* bf,
    const void* bb, const void* lengths, void* gx, void* acts, void* cseq,
    void* dg, void* dh, void* dc, void* dx, void* dwx, void* dwhb,
    int carry_kind, int L, int B, int T, int D, int H, int K, int block_b,
    int cluster, int resident, int nd, int d0, void* stream) {
  using lstm_recur::BwdArgs;
  using lstm_recur::FwdArgs;
  using lstm_recur::launch_bwd_rows;
  using lstm_recur::launch_fwd_rows;
  using lstm_recur::REPLAY;
  using lstm_gemm::ChunkOut;
  using lstm_gemm::ChunkRows;
  using lstm_gemm::Mat;
  using lstm_gemm::ShiftedChunkRows;
  const lstm_recur::Plan p{block_b, cluster, resident};
  if (L < 1 || B < 1 || T < 1 || D < 1 || H < 1 || K < 1 ||
      !lstm_recur::plan_ok(H, p) || (carry_kind != 1 && carry_kind != 2) ||
      !(nd == 2 ? d0 == 0 : nd == 1 && (d0 == 0 || d0 == 1)))
    return (int)cudaErrorInvalidValue;
  const cudaStream_t st = (cudaStream_t)stream;
  const int n = (T + K - 1) / K;
  const int N = 4 * H, M = B * K;
  const bf16* xs = static_cast<const bf16*>(x);
  const bf16* ys = static_cast<const bf16*>(y);
  float* gxs = static_cast<float*>(gx);
  const float* dgs = static_cast<const float*>(dg);
  float* wx = static_cast<float*>(dwx);
  float* wh = static_cast<float*>(dwhb);
  const Mat<bf16, false> wf{static_cast<const bf16*>(wxf), N};
  const Mat<bf16, false> wb{static_cast<const bf16*>(wxb), N};
  const Mat<bf16, true> wfT{static_cast<const bf16*>(wxf), N};
  const Mat<bf16, true> wbT{static_cast<const bf16*>(wxb), N};
  const Mat<float, false> gf{dgs, N},
      gb{dgs + (size_t)(nd - 1) * L * M * N, N};

  FwdArgs fa{};
  fa.gx = gxs;
  fa.whf = static_cast<const bf16*>(whf4);
  fa.whb = static_cast<const bf16*>(whb4);
  fa.bias_f = static_cast<const float*>(bf);
  fa.bias_b = static_cast<const float*>(bb);
  fa.lengths = static_cast<const int*>(lengths);
  fa.acts = acts;
  fa.cseq = cseq;
  fa.hb = const_cast<void*>(hb);
  fa.cb = const_cast<void*>(cb);
  fa.L = L;
  fa.B = B;
  fa.T = T;
  fa.H = H;
  fa.K = K;
  fa.n = n;
  fa.nd = nd;
  fa.d0 = d0;
  BwdArgs ba{};
  ba.dy = static_cast<const bf16*>(dy);
  ba.acts = acts;
  ba.cseq = cseq;
  ba.whf = static_cast<const bf16*>(whf4b);
  ba.whb = static_cast<const bf16*>(whb4b);
  ba.lengths = fa.lengths;
  ba.dg = static_cast<float*>(dg);
  ba.cb = cb;
  ba.dh = static_cast<float*>(dh);
  ba.dc = static_cast<float*>(dc);
  ba.L = L;
  ba.B = B;
  ba.T = T;
  ba.H = H;
  ba.K = K;
  ba.n = n;
  ba.nd = nd;
  ba.d0 = d0;

  for (int chunk = n - 1; chunk >= 0; --chunk) {
    // the chunk's first frame in slot 0 and slot 1 (nd = 1: slot 0 is
    // direction d0)
    const int t0f = (d0 ? n - 1 - chunk : chunk) * K, t0b = (n - 1 - chunk) * K;
    const ChunkRows<false> xf{xs, D, T, K, t0f}, xb{xs, D, T, K, t0b};
    // (a) the chunk's x-projection, every direction of the launch
    int rc = lstm_gemm::gemm<lstm_gemm::EPI_F32>(
        xf, xb, wf, wb, gxs, gxs + (size_t)M * N, (size_t)B * T * D,
        (size_t)D * N, (size_t)nd * M * N, N, M, N, D, L, nd, st);
    if (rc) return rc;
    // (b) replay the chunk from its entry carry
    fa.chunk = chunk;
    rc = carry_kind == 1
        ? launch_fwd_rows<REPLAY, 1>(p, fa, st)
        : launch_fwd_rows<REPLAY, 2>(p, fa, st);
    if (rc) return rc;
    // (c) its reverse steps
    ba.chunk = chunk;
    rc = carry_kind == 1
        ? launch_bwd_rows<1, 1>(block_b, cluster, ba, st)
        : launch_bwd_rows<1, 2>(block_b, cluster, ba, st);
    if (rc) return rc;
    // (d) dx, then dWx and [dWh; db]
    if (dx) {
      rc = lstm_gemm::gemm<lstm_gemm::EPI_ADD_BF16>(
          gf, gf, wfT, wfT, dx, dx, (size_t)M * N, (size_t)D * N,
          (size_t)B * T * D, D, M, D, N, L, 1, st, ChunkOut{T, K, t0f});
      if (rc) return rc;
      if (nd == 2) rc = lstm_gemm::gemm<lstm_gemm::EPI_ADD_BF16>(
          gb, gb, wbT, wbT, dx, dx, (size_t)M * N, (size_t)D * N,
          (size_t)B * T * D, D, M, D, N, L, 1, st, ChunkOut{T, K, t0b});
      if (rc) return rc;
    }
    const ChunkRows<true> xfT{xs, D, T, K, t0f}, xbT{xs, D, T, K, t0b};
    rc = lstm_gemm::gemm<lstm_gemm::EPI_ACC_F32>(
        xfT, xbT, gf, gb, wx, wx + (size_t)L * D * N, (size_t)B * T * D,
        (size_t)M * N, (size_t)D * N, N, D, N, M, L, nd, st);
    if (rc) return rc;
    // h_{t-1}: the forward direction's previous step is t-1, the reverse
    // direction's t+1
    const ShiftedChunkRows hf{ys, nd * H, T, K, t0f, d0 ? 1 : -1, H};
    const ShiftedChunkRows hr{ys + (nd - 1) * H, nd * H, T, K, t0b, 1, H};
    rc = lstm_gemm::gemm<lstm_gemm::EPI_ACC_F32>(
        hf, hr, gf, gb, wh, wh + (size_t)L * (H + 1) * N,
        (size_t)B * T * nd * H, (size_t)M * N, (size_t)(H + 1) * N, N, H + 1,
        N, M, L, nd, st);
    if (rc) return rc;
  }
  return 0;
}
