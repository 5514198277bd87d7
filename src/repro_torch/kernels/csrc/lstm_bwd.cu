// Bidirectional LSTM backward against the forward's stash, hand-written for
// sm_90a.
//
// Replaces the TPU kernel K2: src/repro/kernels/lstm_cell.py,
// `_make_bwd_kernel` / `_run_bwd` (pallas_call at lstm_cell.py:656), run
// once per direction by `_run_bwd_train`.  On the TPU one grid step of a
// (B/bB, T) grid undoes one recurrence step: it carries (dh, dc) in VMEM
// scratch, emits dx_t = dgates·Wxᵀ, and accumulates dWx += x_tᵀ·dgates,
// dWh += h_{t-1}ᵀ·dgates and db += Σ dgates into f32 output blocks that
// stay resident for the whole grid.  Here the work splits by dependency:
//
//  * lstm_bwd_recur — the serial part, split over a thread-block cluster
//    as the forward is (lstm_recur.cuh): one cluster of C CTAs per (batch
//    tile of up to 8 rows, direction, learner) walks the T steps in
//    reverse recurrence order (the forward direction t = T-1..0, the
//    reverse direction t = 0..T-1; `_bwd_tmap`).  Thread j of CTA c owns
//    hidden unit c·H/C + j and carries dh, dc in f32 registers.  Each step
//    it reads the stashed gates i|f|g|o, c_t and c_{t-1} (zero at the
//    boundary, `_bwd_pmap`), forms the four gate cotangents, writes them to
//    global memory (dgates, (2, L, B, T, 4H) f32) and to its CTA's shared
//    memory; the CTA copies its slice into every peer's (distributed
//    shared memory), and behind one cluster barrier every CTA holds the
//    step's whole dgates block and computes dh_{t-1}[j] = Σ_n dgates[n]·
//    Wh[j, n] for its own units, reading only their rows of Wh.  Wh
//    arrives as (H, H, 4) with W4[c, j, q] = Wh[j, 4c + q]: thread j reads
//    4 adjacent gate columns of its row in one 8-byte load, and
//    neighbouring threads read neighbouring words.  With `lengths`, dh and
//    dc are zeroed on padded steps (so their dgates are zero) and the
//    carries pass through (lstm_cell.py:570-575, :592-596).  The chunked
//    backward K3 runs the same kernel.
//  * lstm_bwd_dx — dx = dgates_f·Wx_fᵀ rounded to bf16, plus
//    dgates_b·Wx_bᵀ rounded to bf16, summed in f32 and rounded again
//    (lstm_cell.py:949, :1050): two launches of the batched tensor-core
//    GEMM of gemm.cuh, the second adding into the first's bf16 output.
//  * lstm_bwd_dw — dWx = xᵀ·dgates, and dWh = h_prevᵀ·dgates with one
//    more row of ones, whose product is db = Σ dgates; h_prev is the
//    stashed y shifted by one recurrence step, zero at the boundary,
//    read in place by the GEMM's operand view.  These sums do not feed
//    the recurrence, so taking them over all steps after the loop
//    computes what the TPU kernel accumulates step by step.
//
// What bounds it on the H100.  The recurrence reads one direction's Wh
// (2 MiB at H=512) every step, 1/C of it in each CTA of a cluster, and
// issues as many f32 FMAs as the forward's; each thread also reads the
// step's whole dgates block from shared memory (8 rows x 4H floats at the
// training shape's 8-row tiles).  A step takes ~65 us (PERF.md).
// The three products are ~113 GFLOP per layer at the paper's training
// shape (16 learners x 16 rows x 21 frames, D=1024, H=512), on the tensor
// cores with the f32 dgates split into three bf16 parts (gemm.cuh); one
// TF32 pass of the same work, the least time for f32-accurate products on
// the tensor cores, would take 0.23 ms at 495 TFLOP/s.  The stash is read
// once and dgates written once and read three times (171 MB per layer in
// f32).
//
// One direction.  Each function also takes nd = 1, the backward of the
// unidirectional `lstm_sequence` (`_lstm_vjp`, lstm_cell.py:954-988):
// the one direction d0's reverse recurrence, its dx (its product rounded
// to bf16 once: the sum with the other direction is the caller's, as
// autograd adds the two passes' dx in bf16) and its dWx, dWh, db, over
// (1, L, ...) buffers, from the same instructions as that direction's
// half of the bidirectional launch.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "gemm.cuh"
#include "lstm_recur.cuh"

using bf16 = __nv_bfloat16;

// stash_kind: 1 = f32 stash, 2 = bf16 stash.  dy (L, B, T, 2H) bf16; acts
// (2, L, B, T, 4H) and cseq (2, L, B, T, H) in the stash dtype; wh4
// (L, H, H, 4) bf16 per direction with W4[c, j, q] = Wh[j, 4c + q];
// lengths (L, B); dg (2, L, B, T, 4H) f32 out.  block_b and cluster as
// blstm_recur's (lstm_fwd.cu); nd = 1: direction d0 alone, every 2 above
// a 1 and its Wh in whf and whb alike.
extern "C" int lstm_bwd_recur(const void* dy, const void* acts,
                              const void* cseq, const void* whf,
                              const void* whb, const void* lengths, void* dg,
                              int stash_kind, int L, int B, int T, int H,
                              int block_b, int cluster, int nd, int d0,
                              void* stream) {
  using lstm_recur::BwdArgs;
  using lstm_recur::launch_bwd_rows;
  if (L < 1 || B < 1 || T < 1 || H < 1 ||
      !lstm_recur::cluster_units(H, cluster) ||
      !(nd == 2 ? d0 == 0 : nd == 1 && (d0 == 0 || d0 == 1)))
    return (int)cudaErrorInvalidValue;
  BwdArgs a{};
  a.dy = static_cast<const bf16*>(dy);
  a.acts = acts;
  a.cseq = cseq;
  a.whf = static_cast<const bf16*>(whf);
  a.whb = static_cast<const bf16*>(whb);
  a.lengths = static_cast<const int*>(lengths);
  a.dg = static_cast<float*>(dg);
  a.L = L;
  a.B = B;
  a.T = T;
  a.H = H;
  a.K = T;
  a.n = 1;
  a.nd = nd;
  a.d0 = d0;
  const cudaStream_t st = (cudaStream_t)stream;
  switch (stash_kind) {
    case 1: return launch_bwd_rows<1, 0>(block_b, cluster, a, st);
    case 2: return launch_bwd_rows<2, 0>(block_b, cluster, a, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

// dx (L, M, D) bf16 from dg (2, L, M, N) f32 and wx_dir (L, D, N) bf16;
// with f32_out, dx (L, M, D) f32 = the two directions' products summed in
// f32 and never rounded (the same tiles with the f32 epilogues: the
// precision check's view of this product).  nd = 1: dg (1, L, M, N) and
// wxf only, dx = bf16(dg·wxfᵀ) (f32_out: unrounded).
extern "C" int lstm_bwd_dx(const void* dg, const void* wxf, const void* wxb,
                           void* dx, int L, int M, int D, int N, int f32_out,
                           int nd, void* stream) {
  using lstm_gemm::Mat;
  const float* g = static_cast<const float*>(dg);
  const Mat<float, false> gf{g, N}, gb{g + (size_t)L * M * N, N};
  const Mat<bf16, true> wf{static_cast<const bf16*>(wxf), N};
  const Mat<bf16, true> wb{static_cast<const bf16*>(wxb), N};
  const cudaStream_t st = (cudaStream_t)stream;
  const size_t sa = (size_t)M * N, sb = (size_t)D * N, sc = (size_t)M * D;
  if (nd != 1 && nd != 2) return (int)cudaErrorInvalidValue;
  if (f32_out) {
    const int rc = lstm_gemm::gemm<lstm_gemm::EPI_F32>(
        gf, gf, wf, wf, dx, dx, sa, sb, sc, D, M, D, N, L, 1, st);
    if (rc || nd == 1) return rc;
    return lstm_gemm::gemm<lstm_gemm::EPI_ACC_F32>(
        gb, gb, wb, wb, dx, dx, sa, sb, sc, D, M, D, N, L, 1, st);
  }
  int rc = lstm_gemm::gemm<lstm_gemm::EPI_BF16>(
      gf, gf, wf, wf, dx, dx, sa, sb, sc, D, M, D, N, L, 1, st);
  if (rc || nd == 1) return rc;
  return lstm_gemm::gemm<lstm_gemm::EPI_ADD_BF16>(
      gb, gb, wb, wb, dx, dx, sa, sb, sc, D, M, D, N, L, 1, st);
}

// x (L, B*T, D) bf16, y (L, B*T, 2H) bf16, dg (2, L, B*T, N) f32 ->
// dwx (2, L, D, N) f32 and dwhb (2, L, H + 1, N) f32 (row H: db).
extern "C" int lstm_bwd_dw(const void* x, const void* y, const void* dg,
                           void* dwx, void* dwhb, int L, int B, int T, int D,
                           int H, int N, int nd, int d0, void* stream) {
  using lstm_gemm::Mat;
  using lstm_gemm::ShiftedRows;
  if (!(nd == 2 ? d0 == 0 : nd == 1 && (d0 == 0 || d0 == 1)))
    return (int)cudaErrorInvalidValue;
  const int M = B * T;
  const float* g = static_cast<const float*>(dg);
  const Mat<float, false> gf{g, N}, gb{g + (size_t)(nd - 1) * L * M * N, N};
  const Mat<bf16, true> xa{static_cast<const bf16*>(x), D};
  const cudaStream_t st = (cudaStream_t)stream;
  float* wx = static_cast<float*>(dwx);
  int rc = lstm_gemm::gemm<lstm_gemm::EPI_F32>(
      xa, xa, gf, gb, wx, wx + (size_t)L * D * N, (size_t)M * D,
      (size_t)M * N, (size_t)D * N, N, D, N, M, L, nd, st);
  if (rc) return rc;
  // h_{t-1}: the forward direction's previous step is t-1, the reverse
  // direction's t+1; slot 1 (nd = 2) is the reverse direction, slot 0 is
  // direction d0
  const bf16* yb = static_cast<const bf16*>(y);
  const ShiftedRows hf{yb, nd * H, T, d0 ? 1 : -1, H},
      hb{yb + (nd - 1) * H, nd * H, T, 1, H};
  float* wh = static_cast<float*>(dwhb);
  return lstm_gemm::gemm<lstm_gemm::EPI_F32>(
      hf, hb, gf, gb, wh, wh + (size_t)L * (H + 1) * N, (size_t)M * nd * H,
      (size_t)M * N, (size_t)(H + 1) * N, N, H + 1, N, M, L, nd, st);
}
