// Fused bidirectional LSTM forward, hand-written for sm_90a.
//
// Replaces the TPU kernel K1: src/repro/kernels/lstm_cell.py,
// `_make_fwd_kernel` / `_run_fwd` (pallas_call at lstm_cell.py:498), with
// n_dir=2 and masking by `lengths`, in its inference variant
// (stash=False), its training variant (stash=True, which also writes
// the post-activation gates and the cell state of every step for the
// backward, K2) and its chunk-entry variant (stash=True, chunk=K,
// lstm_cell.py:394-404: only the (h, c) carry entering every K-step chunk
// of the padded time axis, for the chunked-recompute backward K3 in
// lstm_bwd_chunked.cu; no per-step stash is allocated or written).  On the TPU one grid step is one time step of a
// (B/bB, T) grid with the (h, c) carry resident in VMEM; the whole gate
// product x_t·Wx + h·Wh sits inside the step.  Under `jax.vmap` over the
// learners of a distributed step the learner axis becomes one more grid
// axis; here it is one more axis of both kernels' grids.
//
// Two kernels here:
//
//  * lstm_xproj  — x·Wx for both directions over all B·T rows of every
//    learner at once: the batched tensor-core GEMM of gemm.cuh (bf16
//    operands, exact in bf16, f32 sums).  This half of the gate product
//    has no recurrent dependency, so it leaves the serial loop; it is part
//    of the TPU kernel's body, so it stays hand-written.
//  * blstm_recur — the serial loop of T steps inside the kernel, in place
//    of the TPU's sequential grid axis, split over a thread-block cluster
//    (lstm_recur.cuh): one cluster of C CTAs per (batch tile of up to 8
//    rows, direction, learner), CTA c owning hidden units [c·H/C,
//    (c+1)·H/C).  Thread j of a CTA owns one unit: it accumulates the four
//    gate columns j, H+j, 2H+j, 3H+j of h_bf16·Wh over every input k in
//    order, adds the x-projection (loaded before the product, which hides
//    the loads) and the bias, applies the activations (forget bias +1) and the
//    mask (carry frozen, output zeroed at t >= len), and writes h, rounded
//    to bf16, into its CTA's shared memory; the CTA copies its slice into
//    every peer's (distributed shared memory) and one cluster barrier ends
//    the step.  In the training variant it also writes the gates i|f|g|o
//    and the frozen c to the stash (f32 or bf16, a template parameter), in
//    the chunk-entry variant the f32 (h, c) carry, rounded to the stash
//    dtype, before each chunk's first step; y is computed by the same
//    instructions in every variant, so it is bit-identical, and by the
//    same sums and cell update as the fused stack K4's items.  Wh arrives
//    gate-interleaved, (H, H, 4): the four weights of unit j for input k
//    are one 8-byte load, and neighbouring threads read neighbouring
//    8-byte words.  That is the streaming launch; the long launches of
//    the training variants take the resident one instead
//    (`lstm_cell.recur_plan`; `blstm_recur_resident`: clusters of 16 CTAs
//    holding Wh in shared memory, one thread per (unit, gate)), which
//    computes the same bits.
//
// What bounds it on the H100.  At the paper's width (H=512) one
// direction's Wh is 512 x 2048 bf16 = 2 MiB.  At the training shape (16
// learners x 16 rows) the recurrence runs tiles of 8 rows on clusters of
// 2 CTAs of 256 threads (`lstm_cell.cluster_size`), 128 CTAs: each reads its
// 1 MiB half of Wh every step (64 MiB of distinct Wh over the learners,
// more than the 50 MB L2) and issues 537 M f32 FMAs a step over the card,
// ~20 us at the HBM rate and ~16 us at the f32 peak; a step takes ~48 us
// (PERF.md): the f32 product loop issues at about a third of the
// f32 peak, and a step's weight stream does not overlap it fully.  That
// product stays on the CUDA cores in the order of the sums before the split, so
// that K4 stays bit-identical to the K1 loop; a tensor-core step product
// is later work.  x·Wx is operation-bound on the tensor cores.  At the
// train-long shape (16 learners x 2 rows, T = 2000) the streaming launch
// is 64 CTAs re-reading 64 MiB of Wh from device memory every step, ~27
// us a step; the resident launch reads Wh once and runs 5 waves of 7
// clusters at ~3.1 us a step, its product issuing at about half an
// instruction a cycle per warp (PERF.md §6).
//
// One direction.  Both kernels also take nd = 1 (the unidirectional
// `lstm_sequence`, lstm_cell.py:991-1005): x·Wx of the one direction, and
// the recurrence of that direction alone, forward (d0 = 0) or reversed
// (d0 = 1), into (L, 1, ...) buffers (lstm_recur.cuh, "One direction or
// two"): the same instructions, so the bits of the direction's half of
// the bidirectional launch.
//
// Numerics mirror `_cell_math`: gates = (x·Wx + h·Wh) + b accumulated in
// f32, h rounded to bf16 before the product, h and c carried in f32, the
// output written in bf16.  The reverse direction's time index is T-1-s
// over the padded T.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "gemm.cuh"
#include "lstm_recur.cuh"

using bf16 = __nv_bfloat16;

extern "C" int lstm_xproj(const void* x, const void* wxf, const void* wxb,
                          void* gx, int L, int M, int D, int N, int nd,
                          void* stream) {
  // gx (L, nd, M, N) f32 = x (L, M, D) · wx_dir (L, D, N); nd = 1 reads
  // wxf only
  using lstm_gemm::Mat;
  if (nd != 1 && nd != 2) return (int)cudaErrorInvalidValue;
  const Mat<bf16, false> xa{static_cast<const bf16*>(x), D};
  const Mat<bf16, false> wf{static_cast<const bf16*>(wxf), N};
  const Mat<bf16, false> wb{static_cast<const bf16*>(nd == 2 ? wxb : wxf), N};
  float* g = static_cast<float*>(gx);
  return lstm_gemm::gemm<lstm_gemm::EPI_F32, 32>(
      xa, xa, wf, wb, g, g + (size_t)M * N, (size_t)M * D, (size_t)D * N,
      (size_t)nd * M * N, N, M, N, D, L, nd, (cudaStream_t)stream);
}

// stash_kind: 0 = inference (acts, cseq unused), 1 = f32 stash, 2 = bf16
// stash, 3 = f32 chunk-entry carries, 4 = bf16 ones (acts and cseq are then
// the (nd, L, B, ceil(T / K), H) h and c carries).  gx (L, nd, B, T, 4H)
// f32; wh (L, H, H, 4) bf16 gate-interleaved; b (L, 4H) f32; lengths
// (L, B); y (L, B, T, nd·H) bf16.  nd = 2: both directions (whf, bf the
// forward's, whb, bb the reverse's); nd = 1: direction d0 alone (0
// forward, 1 reversed), its weights in whf and whb alike.  The plan (lstm_recur.cuh's Plan,
// `lstm_cell.recur_plan`): block_b rows per tile (1, 2, 4 or 8); cluster
// (1, 2, 4 or 8; H even, a multiple of 4·cluster when above 1, H /
// cluster <= 256); with resident = 0, clusters of `cluster` CTAs, wh
// (L, H, H, 4) as above; with resident = 1 (not for inference), clusters
// of 16 CTAs, wh in the resident layout (L, 16, H/2, H/16, 4, 2)
// (`lstm_cell._res_fwd_layout`).
extern "C" int blstm_recur(const void* gx, const void* whf, const void* whb,
                           const void* bf, const void* bb,
                           const void* lengths, void* y, void* acts,
                           void* cseq, int stash_kind, int L, int B, int T,
                           int H, int K, int block_b, int cluster,
                           int resident, int nd, int d0, void* stream) {
  using lstm_recur::FWD;
  using lstm_recur::FWD_ENTRY;
  using lstm_recur::FWD_STASH;
  using lstm_recur::FwdArgs;
  using lstm_recur::launch_fwd_rows;
  const lstm_recur::Plan p{block_b, cluster, resident};
  if (L < 1 || B < 1 || T < 1 || H < 1 || !lstm_recur::plan_ok(H, p) ||
      !(nd == 2 ? d0 == 0 : nd == 1 && (d0 == 0 || d0 == 1)))
    return (int)cudaErrorInvalidValue;
  const bool entry = stash_kind == 3 || stash_kind == 4;
  if (entry && K < 1) return (int)cudaErrorInvalidValue;
  FwdArgs a{};
  a.gx = static_cast<const float*>(gx);
  a.whf = static_cast<const bf16*>(whf);
  a.whb = static_cast<const bf16*>(whb);
  a.bias_f = static_cast<const float*>(bf);
  a.bias_b = static_cast<const float*>(bb);
  a.lengths = static_cast<const int*>(lengths);
  a.y = static_cast<bf16*>(y);
  a.acts = entry ? nullptr : acts;
  a.cseq = entry ? nullptr : cseq;
  a.hb = entry ? acts : nullptr;
  a.cb = entry ? cseq : nullptr;
  a.L = L;
  a.B = B;
  a.T = T;
  a.H = H;
  a.K = entry ? K : T;
  a.n = (T + a.K - 1) / a.K;
  a.nd = nd;
  a.d0 = d0;
  const cudaStream_t st = (cudaStream_t)stream;
  switch (stash_kind) {
    case 0: return launch_fwd_rows<FWD, 0>(p, a, st);
    case 1: return launch_fwd_rows<FWD_STASH, 1>(p, a, st);
    case 2: return launch_fwd_rows<FWD_STASH, 2>(p, a, st);
    case 3: return launch_fwd_rows<FWD_ENTRY, 1>(p, a, st);
    case 4: return launch_fwd_rows<FWD_ENTRY, 2>(p, a, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

// How many clusters of the resident forward (tiles of block_b rows, width
// H) the card runs at once (cudaOccupancyMaxActiveClusters), or
// -cudaError: 0 means a cluster of 16 CTAs cannot be scheduled.
extern "C" int blstm_recur_active_clusters(int block_b, int H) {
  namespace R = lstm_recur;
  const int U = R::res_units(H, block_b);
  if (!U) return -(int)cudaErrorInvalidValue;
  auto query = [&](auto kernel) {
    return R::active_clusters(kernel, dim3(R::RES_CLUSTER, 2, 1),
                              (4 * U + 31) / 32 * 32,
                              R::res_smem(H, block_b), R::RES_CLUSTER);
  };
  switch (block_b) {
    case 1: return query(R::blstm_recur_resident<1, R::REPLAY, 1>);
    case 2: return query(R::blstm_recur_resident<2, R::REPLAY, 1>);
    case 4: return query(R::blstm_recur_resident<4, R::REPLAY, 1>);
    case 8: return query(R::blstm_recur_resident<8, R::REPLAY, 1>);
    default: return -(int)cudaErrorInvalidValue;
  }
}

