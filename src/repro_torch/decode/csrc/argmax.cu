// Row-wise argmax of a (B, V) logits matrix, hand-written for sm_90a: the
// token selector of LM serving.
//
// Replaces the TPU kernel K6: src/repro/decode/kernel.py, `argmax_tokens`
// (pallas_call at kernel.py:158), whose body is jnp.argmax of the
// f32-cast (bB, V) block resident in VMEM.  The result must match
// jnp.argmax bit for bit: the first index among equal maxima, and NaN
// counted as the maximum (the first NaN wins).
//
// What bounds it on the H100: the bytes, one pass over the row (V =
// 49,152 bf16 = 96 KB at smollm-360m's vocabulary) and one int32 out; the
// compares are one per element.  At serving batch sizes (B = 1..8) a call
// is bound by how long one SM takes over its share of a row, not by the
// card's bandwidth: with one CTA a row, 8 SMs each read 96 KB.  So each row
// is a cluster of S CTAs (S = 1..8, `decode.kernel.argmax_slices`: as many
// as B·S ≤ the SM count allows, and no more than give every thread of a
// CTA one 16-byte vector), each CTA reducing one contiguous slice.
//
// The slices are whole 16-byte vectors counted from the row's first
// 16-byte boundary (`argmax_bounds`): the elements before it go to slice
// 0, those after the last whole vector to slice S - 1, so a misaligned row
// (a view at an odd offset, a V whose rows are not 16-byte multiples) and
// a V that no S divides need no other case, and no slice boundary falls
// inside a vector.  Each thread walks its CTA's vectors with 16-byte loads
// (8 bf16 or 4 f32), neighbouring threads on neighbouring addresses, UNROLL
// loads in flight, keeping its best (value, index); a warp then a block
// reduction merge the pairs, and CTA 0 of the cluster merges the S CTAs'
// pairs, read through distributed shared memory behind one cluster
// barrier.  Every merge uses the same total order (NaN first, then the
// larger value, then the smaller index), so neither the slicing nor the
// merge order changes the answer.

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

namespace cg = cooperative_groups;

constexpr int THREADS = 256;
constexpr int NWARPS = THREADS / 32;
constexpr int MAX_SLICES = 8;
constexpr int UNROLL = 4;
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

struct Best {
  float v = -INFINITY;
  int i = IMAX;
  __device__ __forceinline__ void take(float ov, int oi) {
    if (better(ov, oi, v, i)) {
      v = ov;
      i = oi;
    }
  }
  __device__ __forceinline__ void warp_merge() {
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) {
      const float ov = __shfl_xor_sync(0xffffffffu, v, o);
      const int oi = __shfl_xor_sync(0xffffffffu, i, o);
      take(ov, oi);
    }
  }
};

template <typename T>
__global__ void __launch_bounds__(THREADS)
    argmax_kernel(const T* __restrict__ x, int V, int* __restrict__ out) {
  __shared__ float sv[NWARPS];
  __shared__ int si[NWARPS];
  __shared__ float cv;                  // this CTA's pair, read by CTA 0
  __shared__ int ci;
  cg::cluster_group cluster = cg::this_cluster();
  const int S = (int)cluster.num_blocks();
  const int s = (int)cluster.block_rank();
  const int tid = threadIdx.x;
  const T* row = x + (size_t)(blockIdx.x / S) * V;
  constexpr int PER = 16 / sizeof(T);          // elements per 16-byte load
  const int head = min(
      V, (int)(((16 - (reinterpret_cast<uintptr_t>(row) & 15)) & 15) /
               sizeof(T)));
  const int n_vec = (V - head) / PER;
  const int v0 = (int)((long long)n_vec * s / S);
  const int v1 = (int)((long long)n_vec * (s + 1) / S);
  Best best;
  // the elements before the first boundary (slice 0) and after the last
  // whole vector (slice S - 1)
  if (s == 0)
    for (int i = tid; i < head; i += THREADS) best.take(to_f32(row[i]), i);
  if (s == S - 1)
    for (int i = head + n_vec * PER + tid; i < V; i += THREADS)
      best.take(to_f32(row[i]), i);
  const uint4* rv = reinterpret_cast<const uint4*>(row + head);
  for (int c = v0 + tid; c < v1; c += UNROLL * THREADS) {
    uint4 raw[UNROLL];
#pragma unroll
    for (int u = 0; u < UNROLL; ++u)
      if (c + u * THREADS < v1) raw[u] = rv[c + u * THREADS];
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      if (c + u * THREADS >= v1) continue;
      const T* e = reinterpret_cast<const T*>(&raw[u]);
      const int i0 = head + (c + u * THREADS) * PER;
#pragma unroll
      for (int k = 0; k < PER; ++k) best.take(to_f32(e[k]), i0 + k);
    }
  }
  best.warp_merge();
  const int warp = tid / 32, lane = tid % 32;
  if (lane == 0) {
    sv[warp] = best.v;
    si[warp] = best.i;
  }
  __syncthreads();
  if (warp == 0) {
    Best b;
    if (lane < NWARPS) b.take(sv[lane], si[lane]);
    b.warp_merge();
    if (lane == 0) {
      cv = b.v;
      ci = b.i;
    }
  }
  cluster.sync();                       // every CTA's pair is written
  if (s == 0 && warp == 0) {
    Best b;
    if (lane < S)
      b.take(*cluster.map_shared_rank(&cv, lane),
             *cluster.map_shared_rank(&ci, lane));
    b.warp_merge();
    if (lane == 0) out[blockIdx.x / S] = b.i;
  }
  cluster.sync();                       // no CTA leaves while CTA 0 reads
}

template <typename T>
int launch(const void* x, int B, int V, int S, int* out, cudaStream_t st) {
  cudaLaunchConfig_t cfg = {};
  cudaLaunchAttribute attr[1];
  cfg.gridDim = dim3((unsigned)B * S);
  cfg.blockDim = dim3(THREADS);
  cfg.stream = st;
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = S;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const cudaError_t err = cudaLaunchKernelEx(&cfg, argmax_kernel<T>,
                                             (const T*)x, V, out);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

}  // namespace

// logits (B, V) contiguous, bf16 (is_f32 = 0) or f32 (is_f32 = 1), any
// element-aligned address; out (B,) int32; slices: CTAs per row (1..8).
extern "C" int argmax_rows(const void* logits, void* out, int B, int V,
                           int is_f32, int slices, void* stream) {
  if (B < 1 || V < 1 || slices < 1 || slices > MAX_SLICES)
    return (int)cudaErrorInvalidValue;
  const cudaStream_t st = (cudaStream_t)stream;
  return is_f32 ? launch<float>(logits, B, V, slices, (int*)out, st)
                : launch<__nv_bfloat16>(logits, B, V, slices, (int*)out, st);
}
