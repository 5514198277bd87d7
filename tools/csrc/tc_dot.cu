// One product D = A . B^T on the tensor cores or the CUDA cores, for
// measuring how precisely each sums: A (M x K) and B (N x K) bf16, row-major with k contiguous, D (M x
// N) f32.  M and N are multiples of 64, K a multiple of 64 (pad with
// zeros).  One CTA of one warpgroup per 64 x 64 tile of D; k runs in
// blocks of 64 through shared memory (sm90.cuh's 128-byte swizzled
// layout).
//
//   group 0:  no tensor cores: one fmaf chain per element over k ascending
//   group g:  wgmma m64n64k16, a fresh accumulator for every g k16 steps,
//             each added to an f32 total by the CUDA cores (round to
//             nearest); a g past K / 16 is one accumulator over all of k
//
// Built and called by tools/ssd_stage_precision.py; not part of the port.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "sm90.cuh"

namespace {

constexpr int T = 64;          // rows and k of a tile
constexpr int THREADS = 128;   // one warpgroup

__device__ void load(uint8_t* tile, const __nv_bfloat16* src, int K, int r0,
                     int k0) {
  for (int e = threadIdx.x; e < T * (T / 8); e += THREADS) {
    const int r = e / (T / 8), c = (e % (T / 8)) * 8;
    *reinterpret_cast<uint4*>(tile + sm90::tile_offset<128>(T, r, c)) =
        *reinterpret_cast<const uint4*>(src + (size_t)(r0 + r) * K + k0 + c);
  }
}

__global__ void __launch_bounds__(THREADS)
    tc_dot_kernel(const __nv_bfloat16* A, const __nv_bfloat16* B, float* D,
                  int N, int K, int group) {
  __shared__ __align__(1024) uint8_t at[T * T * 2];
  __shared__ __align__(1024) uint8_t bt[T * T * 2];
  const int m0 = blockIdx.y * T, n0 = blockIdx.x * T;
  const int tid = threadIdx.x, w = tid / 32, lane = tid % 32;
  float acc[32], part[32];
#pragma unroll
  for (int i = 0; i < 32; ++i) acc[i] = part[i] = 0.f;
  int step = 0;                // k16 steps issued so far
  for (int k0 = 0; k0 < K; k0 += T) {
    load(at, A, K, m0, k0);
    load(bt, B, K, n0, k0);
    sm90::fence_proxy_async();
    __syncthreads();
    if (group == 0) {
      // acc[4j + 2h + c]: row 16 w + lane / 4 + 8 h, column 8 j + 2 (lane
      // % 4) + c, as the wgmma accumulator holds it
#pragma unroll
      for (int i = 0; i < 32; ++i) {
        const int r = 16 * w + lane / 4 + 8 * ((i >> 1) & 1);
        const int c = 8 * (i >> 2) + 2 * (lane % 4) + (i & 1);
        for (int k = 0; k < T; ++k)
          acc[i] = fmaf(__bfloat162float(*reinterpret_cast<__nv_bfloat16*>(
                            at + sm90::tile_offset<128>(T, r, k))),
                        __bfloat162float(*reinterpret_cast<__nv_bfloat16*>(
                            bt + sm90::tile_offset<128>(T, c, k))),
                        acc[i]);
      }
    } else {
      const uint32_t a = sm90::smem_u32(at), b = sm90::smem_u32(bt);
#pragma unroll 1
      for (int kk = 0; kk < T / 16; ++kk, ++step) {
        sm90::fence_operand(part);
        sm90::wgmma_fence();
        sm90::Wgmma<64>::ss(part, sm90::desc_kmajor<128>(a, T, kk),
                            sm90::desc_kmajor<128>(b, T, kk),
                            step % group != 0);
        sm90::wgmma_commit();
        sm90::wgmma_wait<0>();
        sm90::fence_operand(part);
        if ((step + 1) % group == 0 || step + 1 == K / 16) {
#pragma unroll
          for (int i = 0; i < 32; ++i) acc[i] += part[i];
        }
      }
    }
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < 32; ++i) {
    const int r = m0 + 16 * w + lane / 4 + 8 * ((i >> 1) & 1);
    const int c = n0 + 8 * (i >> 2) + 2 * (lane % 4) + (i & 1);
    D[(size_t)r * N + c] = acc[i];
  }
}

}  // namespace

extern "C" int tc_dot(const void* A, const void* B, void* D, int M, int N,
                      int K, int group, void* stream) {
  if (M < 1 || N < 1 || K < 1 || M % T || N % T || K % T || group < 0)
    return (int)cudaErrorInvalidValue;
  tc_dot_kernel<<<dim3(N / T, M / T), THREADS, 0, (cudaStream_t)stream>>>(
      (const __nv_bfloat16*)A, (const __nv_bfloat16*)B, (float*)D, N, K,
      group);
  return (int)cudaGetLastError();
}
