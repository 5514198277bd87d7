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
//  * lstm_bwd_recur — the serial part.  One CTA per (batch tile,
//    direction, learner) walks the T steps in reverse recurrence order
//    (the forward direction t = T-1..0, the reverse direction t = 0..T-1;
//    `_bwd_tmap`).  Thread j owns hidden unit j and carries dh, dc in f32
//    registers.  Each step it reads the stashed gates i|f|g|o, c_t and
//    c_{t-1} (zero at the boundary, `_bwd_pmap`), forms the four gate
//    cotangents, writes them to global memory (dgates, (2, L, B, T, 4H)
//    f32) and to shared memory, and then computes
//    dh_{t-1}[j] = Σ_n dgates[n]·Wh[j, n].  Wh arrives as (H, H, 4) with
//    W4[c, j, q] = Wh[j, 4c + q]: thread j reads 4 adjacent gate columns
//    of its row in one 8-byte load, and neighbouring threads read
//    neighbouring words.  With `lengths`, dh and dc are zeroed on padded
//    steps (so their dgates are zero) and the carries pass through
//    (lstm_cell.py:570-575, :592-596).
//  * lstm_bwd_dx — dx = dgates_f·Wx_fᵀ rounded to bf16, plus
//    dgates_b·Wx_bᵀ rounded to bf16, summed in f32 and rounded again
//    (lstm_cell.py:949, :1050): two launches of the batched GEMM of
//    gemm.cuh, the second adding into the first's bf16 output.
//  * lstm_bwd_dw — dWx = xᵀ·dgates, and dWh = h_prevᵀ·dgates with one
//    more row of ones, whose product is db = Σ dgates; h_prev is the
//    stashed y shifted by one recurrence step, zero at the boundary,
//    read in place by the GEMM's operand view.  These sums do not feed
//    the recurrence, so taking them over all steps after the loop
//    computes what the TPU kernel accumulates step by step.
//
// What bounds it on the H100.  The recurrence streams one direction's Wh
// (2 MiB at H=512) from L2 every step, as the forward does: T serial steps
// bound by one SM's L2 bandwidth.  The three products are ~113 GFLOP per
// layer at the paper's training shape (16 learners x 16 rows x 21 frames,
// D=1024, H=512), in f32 on the CUDA cores: they, not the recurrence, set
// the backward's time.  The stash is read once and dgates written once and
// read three times (171 MB per layer in f32).

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "gemm.cuh"

using bf16 = __nv_bfloat16;

namespace {

constexpr int MAX_H = 512;   // one thread per hidden unit, one CTA

// Stash element load: SK 1 = f32, 2 = bf16.
template <int SK>
__device__ __forceinline__ float load_stash(const void* p, size_t i) {
  if constexpr (SK == 1) return static_cast<const float*>(p)[i];
  else return __bfloat162float(static_cast<const bf16*>(p)[i]);
}

// acc[r] += Σ_q dg[r][4c + q] * Wh[j, 4c + q] for the 4 weights in `u`;
// `dgc` points at dg[0][4c] in shared memory (row stride G).
template <int BB>
__device__ __forceinline__ void fma_row(float (&acc)[BB], uint2 u,
                                        const float* dgc, size_t G) {
  const __nv_bfloat162 w01 = *reinterpret_cast<const __nv_bfloat162*>(&u.x);
  const __nv_bfloat162 w23 = *reinterpret_cast<const __nv_bfloat162*>(&u.y);
  const float w0 = __low2float(w01), w1 = __high2float(w01);
  const float w2 = __low2float(w23), w3 = __high2float(w23);
#pragma unroll
  for (int r = 0; r < BB; ++r) {
    const float4 g = *reinterpret_cast<const float4*>(dgc + r * G);
    acc[r] += g.x * w0 + g.y * w1 + g.z * w2 + g.w * w3;
  }
}

// dy (L, B, T, 2H) bf16 (direction d in columns [d*H, (d+1)*H)); acts
// (2, L, B, T, 4H) and cseq (2, L, B, T, H) in the stash dtype; wh4
// (L, H, H, 4) bf16 per direction, laid out as above; lengths (L, B);
// dg (2, L, B, T, 4H) f32 out.  grid (ceil(B / BB), 2, L), block H
// rounded up to 32, dynamic shared memory BB * 4H floats.
template <int BB, int SK, int KU = 8>
__global__ void __launch_bounds__(MAX_H) lstm_bwd_recur_kernel(
    const bf16* __restrict__ dy, const void* __restrict__ acts,
    const void* __restrict__ cseq, const bf16* __restrict__ whf,
    const bf16* __restrict__ whb, const int* __restrict__ lengths,
    float* __restrict__ dg, int L, int B, int T, int H) {
  extern __shared__ __align__(16) float dgs[];   // [BB][4H] this step's dgates
  const int d = blockIdx.y;
  const int l = blockIdx.z;
  const int b0 = blockIdx.x * BB;
  const size_t G = 4 * (size_t)H;
  const bf16* __restrict__ wh = (d ? whb : whf) + (size_t)l * H * G;
  lengths += (size_t)l * B;
  dy += (size_t)l * B * T * 2 * H + (size_t)d * H;
  const size_t srow = (size_t)(d * L + l) * B;   // stash/dgates row of b = 0
  const int j = threadIdx.x;
  const bool own = j < H;

  float dh_c[BB], dc_c[BB];
  int len[BB];
#pragma unroll
  for (int r = 0; r < BB; ++r) {
    dh_c[r] = 0.f;
    dc_c[r] = 0.f;
    len[r] = (b0 + r < B) ? lengths[b0 + r] : 0;
  }

  for (int s = 0; s < T; ++s) {
    // the recurrence step undone now, and the one before it
    const int t = d ? s : T - 1 - s;
    const int tp = d ? t + 1 : t - 1;
    const bool boundary = s == T - 1;
    bool vm[BB];
#pragma unroll
    for (int r = 0; r < BB; ++r) {
      const int b = b0 + r;
      vm[r] = t < len[r];
      if (!own) continue;
      float* sg = dgs + r * G + j;
      if (b >= B) {
        sg[0] = sg[H] = sg[2 * H] = sg[3 * H] = 0.f;
        continue;
      }
      const size_t st = (srow + b) * T + t;
      const float i_ = load_stash<SK>(acts, st * G + j);
      const float f_ = load_stash<SK>(acts, st * G + H + j);
      const float g_ = load_stash<SK>(acts, st * G + 2 * H + j);
      const float o_ = load_stash<SK>(acts, st * G + 3 * H + j);
      const float c = load_stash<SK>(cseq, st * H + j);
      const float cp =
          boundary ? 0.f : load_stash<SK>(cseq, ((srow + b) * T + tp) * H + j);
      float dh = __bfloat162float(dy[((size_t)b * T + t) * 2 * H + j]) + dh_c[r];
      const float tc = tanhf(c);
      float dc = dh * o_ * (1.f - tc * tc) + dc_c[r];
      if (!vm[r]) {
        dh = 0.f;
        dc = 0.f;
      }
      const float di = dc * g_ * i_ * (1.f - i_);
      const float df = dc * cp * f_ * (1.f - f_);
      const float dgg = dc * i_ * (1.f - g_ * g_);
      const float dob = dh * tc * o_ * (1.f - o_);
      float* out = dg + st * G + j;
      out[0] = di;
      out[H] = df;
      out[2 * H] = dgg;
      out[3 * H] = dob;
      sg[0] = di;
      sg[H] = df;
      sg[2 * H] = dgg;
      sg[3 * H] = dob;
      if (vm[r]) dc_c[r] = dc * f_;      // padded step: the carry passes
    }
    __syncthreads();                     // every dgates write precedes the read
    if (own) {
      float acc[BB];
#pragma unroll
      for (int r = 0; r < BB; ++r) acc[r] = 0.f;
      const uint2* __restrict__ w4 = reinterpret_cast<const uint2*>(wh) + j;
      int c4 = 0;
      for (; c4 + KU <= H; c4 += KU) {
        uint2 u[KU];                     // KU loads in flight per thread
#pragma unroll
        for (int q = 0; q < KU; ++q) u[q] = __ldg(w4 + (size_t)(c4 + q) * H);
#pragma unroll
        for (int q = 0; q < KU; ++q) fma_row<BB>(acc, u[q], dgs + 4 * (c4 + q), G);
      }
      for (; c4 < H; ++c4)
        fma_row<BB>(acc, __ldg(w4 + (size_t)c4 * H), dgs + 4 * c4, G);
#pragma unroll
      for (int r = 0; r < BB; ++r)
        if (vm[r]) dh_c[r] = acc[r];
    }
    __syncthreads();                     // every read precedes the next write
  }
}

template <int BB, int SK>
int launch_recur(dim3 grid, int threads, cudaStream_t st, const void* dy,
                 const void* acts, const void* cseq, const void* whf,
                 const void* whb, const void* lengths, void* dg, int L, int B,
                 int T, int H) {
  const size_t smem = (size_t)BB * 4 * H * sizeof(float);
  auto kernel = lstm_bwd_recur_kernel<BB, SK>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  kernel<<<grid, threads, smem, st>>>(
      (const bf16*)dy, acts, cseq, (const bf16*)whf, (const bf16*)whb,
      (const int*)lengths, (float*)dg, L, B, T, H);
  return (int)cudaGetLastError();
}

template <int SK>
int launch_rows(int block_b, dim3 grid, int threads, cudaStream_t st,
                const void* dy, const void* acts, const void* cseq,
                const void* whf, const void* whb, const void* lengths,
                void* dg, int L, int B, int T, int H) {
  switch (block_b) {
    case 1: return launch_recur<1, SK>(grid, threads, st, dy, acts, cseq, whf, whb, lengths, dg, L, B, T, H);
    case 2: return launch_recur<2, SK>(grid, threads, st, dy, acts, cseq, whf, whb, lengths, dg, L, B, T, H);
    case 4: return launch_recur<4, SK>(grid, threads, st, dy, acts, cseq, whf, whb, lengths, dg, L, B, T, H);
    case 8: return launch_recur<8, SK>(grid, threads, st, dy, acts, cseq, whf, whb, lengths, dg, L, B, T, H);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// stash_kind: 1 = f32 stash, 2 = bf16 stash.
extern "C" int lstm_bwd_recur(const void* dy, const void* acts,
                              const void* cseq, const void* whf,
                              const void* whb, const void* lengths, void* dg,
                              int stash_kind, int L, int B, int T, int H,
                              int block_b, void* stream) {
  if (L < 1 || B < 1 || T < 1 || H < 1 || H > MAX_H)
    return (int)cudaErrorInvalidValue;
  const dim3 grid((B + block_b - 1) / block_b, 2, L);
  const int threads = (H + 31) / 32 * 32;
  const cudaStream_t st = (cudaStream_t)stream;
  switch (stash_kind) {
    case 1: return launch_rows<1>(block_b, grid, threads, st, dy, acts, cseq, whf, whb, lengths, dg, L, B, T, H);
    case 2: return launch_rows<2>(block_b, grid, threads, st, dy, acts, cseq, whf, whb, lengths, dg, L, B, T, H);
    default: return (int)cudaErrorInvalidValue;
  }
}

// dx (L, M, D) bf16 from dg (2, L, M, N) f32 and wx_dir (L, D, N) bf16.
extern "C" int lstm_bwd_dx(const void* dg, const void* wxf, const void* wxb,
                           void* dx, int L, int M, int D, int N,
                           void* stream) {
  using lstm_gemm::Mat;
  const float* g = static_cast<const float*>(dg);
  const Mat<float, false> gf{g, N}, gb{g + (size_t)L * M * N, N};
  const Mat<bf16, true> wf{static_cast<const bf16*>(wxf), N};
  const Mat<bf16, true> wb{static_cast<const bf16*>(wxb), N};
  const cudaStream_t st = (cudaStream_t)stream;
  const size_t sa = (size_t)M * N, sb = (size_t)D * N, sc = (size_t)M * D;
  int rc = lstm_gemm::gemm<lstm_gemm::EPI_BF16>(
      gf, gf, wf, wf, dx, dx, sa, sb, sc, D, M, D, N, L, 1, st);
  if (rc) return rc;
  return lstm_gemm::gemm<lstm_gemm::EPI_ADD_BF16>(
      gb, gb, wb, wb, dx, dx, sa, sb, sc, D, M, D, N, L, 1, st);
}

// x (L, B*T, D) bf16, y (L, B*T, 2H) bf16, dg (2, L, B*T, N) f32 ->
// dwx (2, L, D, N) f32 and dwhb (2, L, H + 1, N) f32 (row H: db).
extern "C" int lstm_bwd_dw(const void* x, const void* y, const void* dg,
                           void* dwx, void* dwhb, int L, int B, int T, int D,
                           int H, int N, void* stream) {
  using lstm_gemm::Mat;
  using lstm_gemm::ShiftedRows;
  const int M = B * T;
  const float* g = static_cast<const float*>(dg);
  const Mat<float, false> gf{g, N}, gb{g + (size_t)L * M * N, N};
  const Mat<bf16, true> xa{static_cast<const bf16*>(x), D};
  const cudaStream_t st = (cudaStream_t)stream;
  float* wx = static_cast<float*>(dwx);
  int rc = lstm_gemm::gemm<lstm_gemm::EPI_F32>(
      xa, xa, gf, gb, wx, wx + (size_t)L * D * N, (size_t)M * D,
      (size_t)M * N, (size_t)D * N, N, D, N, M, L, 2, st);
  if (rc) return rc;
  // h_{t-1}: the forward direction's previous step is t-1, the reverse
  // direction's t+1
  const bf16* yb = static_cast<const bf16*>(y);
  const ShiftedRows hf{yb, 2 * H, T, -1, H}, hb{yb + H, 2 * H, T, 1, H};
  float* wh = static_cast<float*>(dwhb);
  return lstm_gemm::gemm<lstm_gemm::EPI_F32>(
      hf, hb, gf, gb, wh, wh + (size_t)L * (H + 1) * N, (size_t)M * 2 * H,
      (size_t)M * N, (size_t)(H + 1) * N, N, H + 1, N, M, L, 2, st);
}
