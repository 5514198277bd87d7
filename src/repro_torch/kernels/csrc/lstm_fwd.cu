// Fused bidirectional LSTM forward (inference), hand-written for sm_90a.
//
// Replaces the TPU kernel K1: src/repro/kernels/lstm_cell.py,
// `_make_fwd_kernel` / `_run_fwd` (pallas_call at lstm_cell.py:498), in
// its inference variant (n_dir=2, stash=False, masked by `lengths`).  On
// the TPU one grid step is one time step of a (B/bB, T) grid with the
// (h, c) carry resident in VMEM; the whole gate product x_t·Wx + h·Wh sits
// inside the step.
//
// Two kernels here:
//
//  * lstm_xproj  — x·Wx for both directions over all B·T rows at once, a
//    tiled bf16 x bf16 -> f32 GEMM with shared-memory tiles.  This half of
//    the gate product has no recurrent dependency, so it leaves the serial
//    loop; it is part of the TPU kernel's body, so it stays hand-written.
//  * blstm_recur — one CTA per (batch tile, direction) walks all T steps
//    inside the kernel, in place of the TPU's sequential grid axis.
//    Thread j owns hidden unit j: it accumulates the four gate columns
//    j, H+j, 2H+j, 3H+j of h_bf16·Wh, adds the x-projection and the bias,
//    applies the activations (forget bias +1) and the mask (carry frozen,
//    output zeroed at t >= len), and writes h, rounded to bf16, to shared
//    memory for the next step.  Wh arrives gate-interleaved, (H, H, 4):
//    the four weights of unit j for input k are one 8-byte load, and
//    neighbouring threads read neighbouring 8-byte words.
//
// What bounds it on the H100.  At the paper's width (H=512) one
// direction's Wh is 512 x 2048 bf16 = 2 MiB, more than one SM's 227 KB of
// shared memory, so in this simple design every step streams Wh from L2:
// 2 MiB per step per CTA, T·L steps in a serial chain (256 x 6 per
// admission).  A step is bound by how fast one SM can pull 2 MiB out of
// L2 — its share of the L2 bandwidth, and the loads it keeps in flight to
// cover L2 latency (KU 8-byte loads per thread) — not by the card's HBM
// rate or its tensor cores; the kernel is far above the bytes/operations
// bound of the whole layer.  The batch tile
// (up to 8 rows per CTA) reuses each Wh element for every row of the tile,
// so a tile of rows costs about what one row does.  The later design
// splits the gate columns across CTAs so that each CTA keeps its slice of
// Wh resident in shared memory and exchanges h_t through a grid barrier
// every step (ROADMAP.md).
//
// Numerics mirror `_cell_math`: gates = (x·Wx + h·Wh) + b accumulated in
// f32, h rounded to bf16 before the product, h and c carried in f32, the
// output written in bf16.  The reverse direction's time index is T-1-s
// over the padded T.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

using bf16 = __nv_bfloat16;

namespace {

constexpr int BM = 64;   // GEMM tile rows
constexpr int BN = 64;   // GEMM tile columns
constexpr int BK = 16;   // GEMM tile depth

// G[dir] (M, N) f32 = X (M, D) bf16 @ W[dir] (D, N) bf16; blockIdx.z = dir.
__global__ void __launch_bounds__(256)
lstm_xproj_kernel(const bf16* __restrict__ x, const bf16* __restrict__ wxf,
                  const bf16* __restrict__ wxb, float* __restrict__ g,
                  int M, int D, int N) {
  __shared__ __align__(16) float As[BK][BM];   // transposed x tile
  __shared__ __align__(16) float Bs[BK][BN];
  const bf16* w = blockIdx.z ? wxb : wxf;
  float* out = g + (size_t)blockIdx.z * M * N;
  const int tid = threadIdx.x;
  const int tx = tid % 16, ty = tid / 16;
  const int row0 = blockIdx.y * BM, col0 = blockIdx.x * BN;
  float acc[4][4] = {};

  for (int k0 = 0; k0 < D; k0 += BK) {
    // 1024 elements per tile, 4 per thread, zero-filled past the edges
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int e = tid + q * 256;
      const int ar = e / BK, ak = e % BK;            // x tile: row, depth
      const int gr = row0 + ar, gk = k0 + ak;
      As[ak][ar] = (gr < M && gk < D)
                       ? __bfloat162float(x[(size_t)gr * D + gk]) : 0.f;
      const int bk = e / BN, bc = e % BN;            // w tile: depth, col
      const int wk = k0 + bk, wc = col0 + bc;
      Bs[bk][bc] = (wk < D && wc < N)
                       ? __bfloat162float(w[(size_t)wk * N + wc]) : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < BK; ++kk) {
      const float4 a = *reinterpret_cast<const float4*>(&As[kk][ty * 4]);
      const float4 b = *reinterpret_cast<const float4*>(&Bs[kk][tx * 4]);
      const float av[4] = {a.x, a.y, a.z, a.w};
      const float bv[4] = {b.x, b.y, b.z, b.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] += av[i] * bv[j];
    }
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = row0 + ty * 4 + i;
    if (r >= M) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int c = col0 + tx * 4 + j;
      if (c < N) out[(size_t)r * N + c] = acc[i][j];
    }
  }
}

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

// gx (2, B, T, 4H) f32 x-projections; wh (H, H, 4) bf16 gate-interleaved;
// y (B, T, 2H) bf16, direction d in columns [d*H, (d+1)*H).
// grid (ceil(B / BB), 2), block H rounded up to 32.  KU weight loads are in
// flight per thread; fewer rows leave registers for more of them.
template <int BB, int KU = (BB <= 2 ? 16 : 8)>
__global__ void __launch_bounds__(MAX_H) blstm_recur_kernel(const float* __restrict__ gx,
                                   const bf16* __restrict__ whf,
                                   const bf16* __restrict__ whb,
                                   const float* __restrict__ bias_f,
                                   const float* __restrict__ bias_b,
                                   const int* __restrict__ lengths,
                                   bf16* __restrict__ y, int B, int T, int H) {
  extern __shared__ float hs[];                  // [BB][H] bf16-rounded h
  const int d = blockIdx.y;
  const int b0 = blockIdx.x * BB;
  const bf16* __restrict__ wh = d ? whb : whf;
  const float* __restrict__ bias = d ? bias_b : bias_f;
  const int j = threadIdx.x;
  const bool own = j < H;
  const size_t G = 4 * (size_t)H;

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
      const size_t row = (size_t)d * B + min(b0 + r, B - 1);
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
      }
    }
    __syncthreads();
  }
}

}  // namespace

extern "C" int lstm_xproj(const void* x, const void* wxf, const void* wxb,
                          void* gx, int M, int D, int N, void* stream) {
  if (M < 1 || D < 1 || N < 1) return (int)cudaErrorInvalidValue;
  dim3 grid((N + BN - 1) / BN, (M + BM - 1) / BM, 2);
  lstm_xproj_kernel<<<grid, 256, 0, (cudaStream_t)stream>>>(
      (const bf16*)x, (const bf16*)wxf, (const bf16*)wxb, (float*)gx, M, D,
      N);
  return (int)cudaGetLastError();
}

template <int BB>
static void launch_recur(dim3 grid, int threads, cudaStream_t st,
                         const void* gx, const void* whf, const void* whb,
                         const void* bf, const void* bb, const void* lengths,
                         void* y, int B, int T, int H) {
  const size_t smem = (size_t)BB * H * sizeof(float);
  blstm_recur_kernel<BB><<<grid, threads, smem, st>>>(
      (const float*)gx, (const bf16*)whf, (const bf16*)whb,
      (const float*)bf, (const float*)bb, (const int*)lengths, (bf16*)y, B,
      T, H);
}

extern "C" int blstm_recur(const void* gx, const void* whf, const void* whb,
                           const void* bf, const void* bb,
                           const void* lengths, void* y, int B, int T, int H,
                           int block_b, void* stream) {
  if (B < 1 || T < 1 || H < 1 || H > MAX_H) return (int)cudaErrorInvalidValue;
  const dim3 grid((B + block_b - 1) / block_b, 2);
  const int threads = (H + 31) / 32 * 32;
  const cudaStream_t st = (cudaStream_t)stream;
  switch (block_b) {
    case 1: launch_recur<1>(grid, threads, st, gx, whf, whb, bf, bb, lengths, y, B, T, H); break;
    case 2: launch_recur<2>(grid, threads, st, gx, whf, whb, bf, bb, lengths, y, B, T, H); break;
    case 4: launch_recur<4>(grid, threads, st, gx, whf, whb, bf, bb, lengths, y, B, T, H); break;
    case 8: launch_recur<8>(grid, threads, st, gx, whf, whb, bf, bb, lengths, y, B, T, H); break;
    default: return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
