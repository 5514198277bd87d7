// Row-wise argmax of a (B, V) logits matrix, hand-written for sm_90a: the
// token selector of LM serving.
//
// Replaces the TPU kernel K6: src/repro/decode/kernel.py, `argmax_tokens`
// (pallas_call at kernel.py:158), whose body is jnp.argmax of the
// f32-cast (bB, V) block resident in VMEM.  The result must match
// jnp.argmax bit for bit: the first index among equal maxima, and NaN
// counted as the maximum (the first NaN wins).
//
// One CTA per row.  What bounds it on the H100: the bytes — one pass over
// the row (V = 49,152 bf16 = 96 KB at smollm-360m's vocabulary) and one
// int32 out; the compares are one per element.  Each thread walks the row
// with 16-byte loads (8 bf16 or 4 f32), neighbouring threads on
// neighbouring addresses, keeping its best (value, index); a warp then a
// block reduction merge the pairs under the same order (NaN first, then
// larger value, then smaller index), so the merge order does not change
// the answer.  With B rows only B SMs work: at serving batch sizes a call
// is bound by the latency of one row's pass, not by the card's bandwidth.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 512;
constexpr int NWARPS = THREADS / 32;
constexpr int IMAX = 0x7fffffff;

// (av, ai) comes before (bv, bi) in jnp.argmax's order
__device__ __forceinline__ bool better(float av, int ai, float bv, int bi) {
  const bool an = isnan(av), bn = isnan(bv);
  if (an || bn) return an && (!bn || ai < bi);
  return av > bv || (av == bv && ai < bi);
}

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
    argmax_kernel(const T* __restrict__ x, int V, bool vec, int* out) {
  __shared__ float sv[NWARPS];
  __shared__ int si[NWARPS];
  const T* row = x + (size_t)blockIdx.x * V;
  float bv = -INFINITY;
  int bi = IMAX;
  constexpr int PER = 16 / sizeof(T);          // elements per 16-byte load
  int done = 0;
  if (vec) {
    const int n_chunks = V / PER;
    const uint4* rv = reinterpret_cast<const uint4*>(row);
    for (int c = threadIdx.x; c < n_chunks; c += THREADS) {
      const uint4 raw = rv[c];
      const T* e = reinterpret_cast<const T*>(&raw);
#pragma unroll
      for (int k = 0; k < PER; ++k) {
        const float v = to_f32(e[k]);
        if (better(v, c * PER + k, bv, bi)) {
          bv = v;
          bi = c * PER + k;
        }
      }
    }
    done = n_chunks * PER;
  }
  for (int i = done + threadIdx.x; i < V; i += THREADS) {
    const float v = to_f32(row[i]);
    if (better(v, i, bv, bi)) {
      bv = v;
      bi = i;
    }
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    const float ov = __shfl_xor_sync(0xffffffffu, bv, o);
    const int oi = __shfl_xor_sync(0xffffffffu, bi, o);
    if (better(ov, oi, bv, bi)) {
      bv = ov;
      bi = oi;
    }
  }
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  if (lane == 0) {
    sv[warp] = bv;
    si[warp] = bi;
  }
  __syncthreads();
  if (warp == 0) {
    bv = lane < NWARPS ? sv[lane] : -INFINITY;
    bi = lane < NWARPS ? si[lane] : IMAX;
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) {
      const float ov = __shfl_xor_sync(0xffffffffu, bv, o);
      const int oi = __shfl_xor_sync(0xffffffffu, bi, o);
      if (better(ov, oi, bv, bi)) {
        bv = ov;
        bi = oi;
      }
    }
    if (lane == 0) out[blockIdx.x] = bi;
  }
}

template <typename T>
int launch(const void* x, int B, int V, int* out, cudaStream_t st) {
  const bool vec = (reinterpret_cast<uintptr_t>(x) % 16 == 0) &&
                   ((size_t)V * sizeof(T)) % 16 == 0;
  argmax_kernel<T><<<B, THREADS, 0, st>>>((const T*)x, V, vec, out);
  return (int)cudaGetLastError();
}

}  // namespace

// logits (B, V) contiguous, bf16 (is_f32 = 0) or f32 (is_f32 = 1);
// out (B,) int32.
extern "C" int argmax_rows(const void* logits, void* out, int B, int V,
                           int is_f32, void* stream) {
  if (B < 1 || V < 1) return (int)cudaErrorInvalidValue;
  const cudaStream_t st = (cudaStream_t)stream;
  return is_f32 ? launch<float>(logits, B, V, (int*)out, st)
                : launch<__nv_bfloat16>(logits, B, V, (int*)out, st);
}
