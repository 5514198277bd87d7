// Fused bidirectional LSTM forward, hand-written for sm_90a.
//
// Replaces the TPU kernel K1: src/repro/kernels/lstm_cell.py,
// `_make_fwd_kernel` / `_run_fwd` (pallas_call at lstm_cell.py:498), with
// n_dir=2 and masking by `lengths`, in its inference variant
// (stash=False) and its training variant (stash=True, which also writes
// the post-activation gates and the cell state of every step for the
// backward, K2).  On the TPU one grid step is one time step of a
// (B/bB, T) grid with the (h, c) carry resident in VMEM; the whole gate
// product x_t·Wx + h·Wh sits inside the step.  Under `jax.vmap` over the
// learners of a distributed step the learner axis becomes one more grid
// axis; here it is one more axis of both kernels' grids.
//
// Two kernels here:
//
//  * lstm_xproj  — x·Wx for both directions over all B·T rows of every
//    learner at once: the batched GEMM of gemm.cuh (bf16 operands, f32
//    accumulation).  This half of the gate product has no recurrent
//    dependency, so it leaves the serial loop; it is part of the TPU
//    kernel's body, so it stays hand-written.
//  * blstm_recur — one CTA per (batch tile, direction, learner) walks all
//    T steps inside the kernel, in place of the TPU's sequential grid
//    axis.  Thread j owns hidden unit j: it accumulates the four gate
//    columns j, H+j, 2H+j, 3H+j of h_bf16·Wh, adds the x-projection and
//    the bias, applies the activations (forget bias +1) and the mask
//    (carry frozen, output zeroed at t >= len), writes h, rounded to
//    bf16, to shared memory for the next step and, in the training
//    variant, the gates i|f|g|o and the frozen c to the stash (f32 or
//    bf16, a template parameter; y is computed by the same instructions
//    in both variants, so it is bit-identical).  Wh arrives
//    gate-interleaved, (H, H, 4): the four weights of unit j for input k
//    are one 8-byte load, and neighbouring threads read neighbouring
//    8-byte words.
//
// What bounds it on the H100.  At the paper's width (H=512) one
// direction's Wh is 512 x 2048 bf16 = 2 MiB, more than one SM's 227 KB of
// shared memory, so in this simple design every step streams Wh from L2:
// 2 MiB per step per CTA, T·L steps in a serial chain.  A step is bound
// by how fast one SM can pull 2 MiB out of L2 — its share of the L2
// bandwidth, and the loads it keeps in flight to cover L2 latency (KU
// 8-byte loads per thread) — not by the card's HBM rate or its tensor
// cores; the kernel is far above the bytes/operations bound of the whole
// layer.  The batch tile (up to 8 rows per CTA) reuses each Wh element
// for every row of the tile, so a tile of rows costs about what one row
// does.  With 16 learners the 64 MiB of distinct Wh no longer fit the
// 50 MB L2.  The later design splits the gate columns across CTAs so that
// each CTA keeps its slice of Wh resident in shared memory and exchanges
// h_t through a grid barrier every step (ROADMAP.md).
//
// Numerics mirror `_cell_math`: gates = (x·Wx + h·Wh) + b accumulated in
// f32, h rounded to bf16 before the product, h and c carried in f32, the
// output written in bf16.  The reverse direction's time index is T-1-s
// over the padded T.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "gemm.cuh"

using bf16 = __nv_bfloat16;

namespace {

__device__ __forceinline__ float sigmoidf_(float v) {
  return 1.f / (1.f + expf(-v));
}

constexpr int MAX_H = 512;   // one thread per hidden unit, one CTA

// acc[r][g] += h[r][k] * Wh[k, g*H + j] for the 4 gates packed in `u`;
// `hk` points at h[0][k] in shared memory (row stride H).
template <int BB>
__device__ __forceinline__ void fma_gates(float (&acc)[BB][4], uint2 u,
                                          const float* hk, int H) {
  const __nv_bfloat162 w01 = *reinterpret_cast<const __nv_bfloat162*>(&u.x);
  const __nv_bfloat162 w23 = *reinterpret_cast<const __nv_bfloat162*>(&u.y);
  const float w0 = __low2float(w01), w1 = __high2float(w01);
  const float w2 = __low2float(w23), w3 = __high2float(w23);
#pragma unroll
  for (int r = 0; r < BB; ++r) {
    const float hv = hk[r * H];
    acc[r][0] += hv * w0;
    acc[r][1] += hv * w1;
    acc[r][2] += hv * w2;
    acc[r][3] += hv * w3;
  }
}

// Stash element store: SK 1 = f32, 2 = bf16.
template <int SK>
__device__ __forceinline__ void store_stash(void* p, size_t i, float v) {
  if constexpr (SK == 1) static_cast<float*>(p)[i] = v;
  else static_cast<bf16*>(p)[i] = __float2bfloat16(v);
}

// gx (L, 2, B, T, 4H) f32 x-projections; wh (L, H, H, 4) bf16
// gate-interleaved; b (L, 4H) f32; lengths (L, B); y (L, B, T, 2H) bf16,
// direction d in columns [d*H, (d+1)*H).  SK > 0 also writes the stash:
// acts (2, L, B, T, 4H) and cseq (2, L, B, T, H), direction first.
// grid (ceil(B / BB), 2, L), block H rounded up to 32.  KU weight loads are
// in flight per thread; fewer rows leave registers for more of them.
template <int BB, int SK, int KU = (BB <= 2 ? 16 : 8)>
__global__ void __launch_bounds__(MAX_H) blstm_recur_kernel(const float* __restrict__ gx,
                                   const bf16* __restrict__ whf,
                                   const bf16* __restrict__ whb,
                                   const float* __restrict__ bias_f,
                                   const float* __restrict__ bias_b,
                                   const int* __restrict__ lengths,
                                   bf16* __restrict__ y, void* __restrict__ acts,
                                   void* __restrict__ cseq, int L, int B,
                                   int T, int H) {
  extern __shared__ float hs[];                  // [BB][H] bf16-rounded h
  const int d = blockIdx.y;
  const int l = blockIdx.z;
  const int b0 = blockIdx.x * BB;
  const size_t G = 4 * (size_t)H;
  const bf16* __restrict__ wh = (d ? whb : whf) + (size_t)l * H * G;
  const float* __restrict__ bias = (d ? bias_b : bias_f) + (size_t)l * G;
  lengths += (size_t)l * B;
  gx += (size_t)(2 * l + d) * B * T * G;
  y += (size_t)l * B * T * 2 * H;
  const size_t srow = (size_t)(d * L + l) * B;   // stash row of b = 0
  const int j = threadIdx.x;
  const bool own = j < H;

  float h[BB], c[BB];
  int len[BB];
#pragma unroll
  for (int r = 0; r < BB; ++r) {
    h[r] = 0.f;
    c[r] = 0.f;
    len[r] = (b0 + r < B) ? lengths[b0 + r] : 0;
    if (own) hs[r * H + j] = 0.f;
  }
  float bi = 0.f, bfg = 0.f, bg = 0.f, bo = 0.f;
  if (own) {
    bi = bias[j];
    bfg = bias[H + j];
    bg = bias[2 * H + j];
    bo = bias[3 * H + j];
  }
  __syncthreads();

  for (int s = 0; s < T; ++s) {
    const int t = d ? T - 1 - s : s;
    float acc[BB][4], xg[BB][4];
#pragma unroll
    for (int r = 0; r < BB; ++r) {
      acc[r][0] = acc[r][1] = acc[r][2] = acc[r][3] = 0.f;
      // this step's x-projection, loaded before the product hides it
      const size_t row = min(b0 + r, B - 1);
      const float* gr = gx + (row * T + t) * G;
#pragma unroll
      for (int g = 0; g < 4; ++g) xg[r][g] = own ? gr[g * H + j] : 0.f;
    }
    if (own) {
      // wh4[k * H + j] holds the 4 gate weights of unit j for input k
      const uint2* __restrict__ wh4 =
          reinterpret_cast<const uint2*>(wh) + j;
      int k = 0;
      for (; k + KU <= H; k += KU) {
        uint2 u[KU];                     // KU loads in flight per thread
#pragma unroll
        for (int q = 0; q < KU; ++q) u[q] = __ldg(wh4 + (size_t)(k + q) * H);
#pragma unroll
        for (int q = 0; q < KU; ++q) fma_gates<BB>(acc, u[q], hs + k + q, H);
      }
      for (; k < H; ++k) fma_gates<BB>(acc, __ldg(wh4 + (size_t)k * H),
                                       hs + k, H);
    }
    __syncthreads();                    // every read of hs precedes the write
    if (own) {
#pragma unroll
      for (int r = 0; r < BB; ++r) {
        const int b = b0 + r;
        if (b >= B) continue;
        const float i_ = sigmoidf_((xg[r][0] + acc[r][0]) + bi);
        const float f_ = sigmoidf_(((xg[r][1] + acc[r][1]) + bfg) + 1.f);
        const float g_ = tanhf((xg[r][2] + acc[r][2]) + bg);
        const float o_ = sigmoidf_((xg[r][3] + acc[r][3]) + bo);
        const float cn = f_ * c[r] + i_ * g_;
        const float hn = o_ * tanhf(cn);
        const bool valid = t < len[r];
        if (valid) {                    // frozen carry on padded steps
          c[r] = cn;
          h[r] = hn;
        }
        y[((size_t)b * T + t) * 2 * H + (size_t)d * H + j] =
            __float2bfloat16(valid ? hn : 0.f);
        hs[r * H + j] = __bfloat162float(__float2bfloat16(h[r]));
        if constexpr (SK != 0) {
          const size_t st = (srow + b) * T + t;
          store_stash<SK>(acts, st * G + j, i_);
          store_stash<SK>(acts, st * G + H + j, f_);
          store_stash<SK>(acts, st * G + 2 * H + j, g_);
          store_stash<SK>(acts, st * G + 3 * H + j, o_);
          store_stash<SK>(cseq, st * H + j, c[r]);
        }
      }
    }
    __syncthreads();
  }
}

}  // namespace

extern "C" int lstm_xproj(const void* x, const void* wxf, const void* wxb,
                          void* gx, int L, int M, int D, int N, void* stream) {
  // gx (L, 2, M, N) f32 = x (L, M, D) · wx_dir (L, D, N)
  using lstm_gemm::Mat;
  const Mat<bf16, false> xa{static_cast<const bf16*>(x), D};
  const Mat<bf16, false> wf{static_cast<const bf16*>(wxf), N};
  const Mat<bf16, false> wb{static_cast<const bf16*>(wxb), N};
  float* g = static_cast<float*>(gx);
  return lstm_gemm::gemm<lstm_gemm::EPI_F32>(
      xa, xa, wf, wb, g, g + (size_t)M * N, (size_t)M * D, (size_t)D * N,
      (size_t)2 * M * N, N, M, N, D, L, 2, (cudaStream_t)stream);
}

template <int BB, int SK>
static void launch_recur(dim3 grid, int threads, cudaStream_t st,
                         const void* gx, const void* whf, const void* whb,
                         const void* bf, const void* bb, const void* lengths,
                         void* y, void* acts, void* cseq, int L, int B,
                         int T, int H) {
  const size_t smem = (size_t)BB * H * sizeof(float);
  blstm_recur_kernel<BB, SK><<<grid, threads, smem, st>>>(
      (const float*)gx, (const bf16*)whf, (const bf16*)whb,
      (const float*)bf, (const float*)bb, (const int*)lengths, (bf16*)y,
      acts, cseq, L, B, T, H);
}

template <int SK>
static int launch_rows(int block_b, dim3 grid, int threads, cudaStream_t st,
                       const void* gx, const void* whf, const void* whb,
                       const void* bf, const void* bb, const void* lengths,
                       void* y, void* acts, void* cseq, int L, int B, int T,
                       int H) {
  switch (block_b) {
    case 1: launch_recur<1, SK>(grid, threads, st, gx, whf, whb, bf, bb, lengths, y, acts, cseq, L, B, T, H); break;
    case 2: launch_recur<2, SK>(grid, threads, st, gx, whf, whb, bf, bb, lengths, y, acts, cseq, L, B, T, H); break;
    case 4: launch_recur<4, SK>(grid, threads, st, gx, whf, whb, bf, bb, lengths, y, acts, cseq, L, B, T, H); break;
    case 8: launch_recur<8, SK>(grid, threads, st, gx, whf, whb, bf, bb, lengths, y, acts, cseq, L, B, T, H); break;
    default: return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

// stash_kind: 0 = inference (acts, cseq unused), 1 = f32 stash, 2 = bf16.
extern "C" int blstm_recur(const void* gx, const void* whf, const void* whb,
                           const void* bf, const void* bb,
                           const void* lengths, void* y, void* acts,
                           void* cseq, int stash_kind, int L, int B, int T,
                           int H, int block_b, void* stream) {
  if (L < 1 || B < 1 || T < 1 || H < 1 || H > MAX_H)
    return (int)cudaErrorInvalidValue;
  const dim3 grid((B + block_b - 1) / block_b, 2, L);
  const int threads = (H + 31) / 32 * 32;
  const cudaStream_t st = (cudaStream_t)stream;
  switch (stash_kind) {
    case 0: return launch_rows<0>(block_b, grid, threads, st, gx, whf, whb, bf, bb, lengths, y, acts, cseq, L, B, T, H);
    case 1: return launch_rows<1>(block_b, grid, threads, st, gx, whf, whb, bf, bb, lengths, y, acts, cseq, L, B, T, H);
    case 2: return launch_rows<2>(block_b, grid, threads, st, gx, whf, whb, bf, bb, lengths, y, acts, cseq, L, B, T, H);
    default: return (int)cudaErrorInvalidValue;
  }
}
