// Batched f32-accumulating GEMM shared by the BLSTM kernels, hand-written
// for sm_90a.
//
// The TPU kernels K1 and K2 (src/repro/kernels/lstm_cell.py) compute their
// products inside the kernel body: x_t·Wx and h·Wh per step in the forward
// (`_cell_math`), dgates·Wxᵀ, xᵀ·dgates, h_prevᵀ·dgates and Σ dgates in the
// backward (`_make_bwd_kernel`).  The parts without a recurrent dependency
// leave the serial loop here and run as one batched product over every
// step, learner and direction:
//
//   C[z] (M x N) = A[z] (M x K) · B[z] (K x N),   z = learner * ndir + dir
//
// with f32 accumulation on the CUDA cores (the reference accumulates in
// f32, and the backward's operands are f32 dgates, so no bf16 tensor-core
// path reproduces it).  A and B are *views*: a functor returns logical
// element (r, c) as f32, so one kernel serves row-major, transposed and
// time-shifted operands, or the rows of one K-frame chunk of every
// sequence (the chunked backward K3), whose output rows map back to the
// frames they came from.  Tiles are 128 x 128 x 8, 256 threads, 8 x 8
// outputs a thread, shared-memory tiles double-buffered with the next
// tile's global loads held in registers across the compute.  Elements
// outside M, N or K read as zero.  One tile is the `__device__` routine
// `gemm_tile`: `gemm_kernel` runs it once per block, and the fused stack
// K4 (lstm_stack.cu) in each 256-thread half of its blocks, so K4's
// x-projections are the very bits of K1's `lstm_xproj`.
//
// What bounds it: at the training shapes (M, N, K in the hundreds to
// thousands) the products are compute-bound on the f32 CUDA cores
// (67 TFLOP/s peak); a SIMT tile like this reaches a fraction of that.
// `wgmma` needs bf16/tf32 operands and is left to a later change.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace lstm_gemm {

using bf16 = __nv_bfloat16;

constexpr int BM = 128;
constexpr int BN = 128;
constexpr int BK = 8;
constexpr int THREADS = 256;
constexpr int PAD = 4;            // shared-tile row padding: no bank conflicts

enum Epilogue {
  EPI_F32 = 0,       // C f32 = acc
  EPI_BF16 = 1,      // C bf16 = bf16(acc)
  EPI_ADD_BF16 = 2,  // C bf16 = bf16(f32(C) + f32(bf16(acc)))
  EPI_ACC_F32 = 3,   // C f32 += acc (a sum over several launches)
};

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(bf16 v) { return __bfloat162float(v); }

// Logical (r, c) of a matrix in memory: p[r * ld + c], or p[c * ld + r]
// when TRANS.  kRowContig: neighbouring r are neighbouring addresses.
template <typename T, bool TRANS>
struct Mat {
  const T* p;
  long ld;
  static constexpr bool kRowContig = TRANS;
  __device__ __forceinline__ float at(int r, int c) const {
    return TRANS ? to_f(p[(size_t)c * ld + r]) : to_f(p[(size_t)r * ld + c]);
  }
  __device__ __forceinline__ Mat offset(size_t n) const {
    return {p + n, ld};
  }
};

// A(m, k) = h_prev of the LSTM backward, read from the layer output y:
// k indexes the B*T rows of one learner (k = b*T + t) and m the hidden
// unit.  For m < H: y[k + shift][m] when t + shift stays inside the
// sequence, else 0 (the zero initial state at the recurrence boundary);
// m == H is a row of ones, so the same product also yields Σ_k B(k, n).
struct ShiftedRows {
  const bf16* p;
  long ld;
  int T, shift, H;
  static constexpr bool kRowContig = true;
  __device__ __forceinline__ float at(int m, int k) const {
    if (m == H) return 1.f;
    const int t = k % T + shift;
    if (t < 0 || t >= T) return 0.f;
    return __bfloat162float(p[(size_t)(k + shift) * ld + m]);
  }
  __device__ __forceinline__ ShiftedRows offset(size_t n) const {
    return {p + n, ld, T, shift, H};
  }
};

// One K-frame chunk of the B sequences of one learner, (B*T, ld) in
// memory: chunk row i = b*K + k is frame t0 + k of sequence b, zero at
// frames >= T.  TRANS = false: logical (i, m); TRANS = true: (m, i).
template <bool TRANS>
struct ChunkRows {
  const bf16* p;
  long ld;
  int T, K, t0;
  static constexpr bool kRowContig = TRANS;
  __device__ __forceinline__ float at(int r, int c) const {
    const int i = TRANS ? c : r, m = TRANS ? r : c;
    const int t = t0 + i % K;
    if (t >= T) return 0.f;
    return to_f(p[((size_t)(i / K) * T + t) * ld + m]);
  }
  __device__ __forceinline__ ChunkRows offset(size_t n) const {
    return {p + n, ld, T, K, t0};
  }
};

// ShiftedRows over one chunk: A(m, i) = y at frame t0 + i % K + shift of
// sequence i / K (zero outside [0, T)), and a row of ones at m == H.
struct ShiftedChunkRows {
  const bf16* p;
  long ld;
  int T, K, t0, shift, H;
  static constexpr bool kRowContig = true;
  __device__ __forceinline__ float at(int m, int i) const {
    if (m == H) return 1.f;
    const int t = t0 + i % K + shift;
    if (t < 0 || t >= T) return 0.f;
    return __bfloat162float(p[((size_t)(i / K) * T + t) * ld + m]);
  }
  __device__ __forceinline__ ShiftedChunkRows offset(size_t n) const {
    return {p + n, ld, T, K, t0, shift, H};
  }
};

// Where output row r of C lies (-1: not stored).  DenseRows: row r.
// ChunkOut: chunk row r = b*K + k is frame t0 + k of sequence b of a
// (B*T, ldc) output; frames >= T are dropped.
struct DenseRows {
  __device__ __forceinline__ long operator()(int r) const { return r; }
};
struct ChunkOut {
  int T, K, t0;
  __device__ __forceinline__ long operator()(int r) const {
    const int t = t0 + r % K;
    return t < T ? (long)(r / K) * T + t : -1;
  }
};

template <int EPI>
struct OutT { using type = bf16; };
template <>
struct OutT<EPI_F32> { using type = float; };
template <>
struct OutT<EPI_ACC_F32> { using type = float; };

// Tile coordinates of the q-th element a thread loads: along the
// contiguous index for neighbouring threads.
template <class V>
__device__ __forceinline__ void a_coords(int e, int& m, int& k) {
  if (V::kRowContig) { m = e % BM; k = e / BM; }
  else               { m = e / BK; k = e % BK; }
}
template <class V>
__device__ __forceinline__ void b_coords(int e, int& k, int& n) {
  if (V::kRowContig) { k = e % BK; n = e / BK; }
  else               { k = e / BN; n = e % BN; }
}

template <class A, class B>
__device__ __forceinline__ void load_tiles(const A& a, const B& b, int row0,
                                           int col0, int k0, int M, int N,
                                           int K, int tid, float (&ra)[4],
                                           float (&rb)[4]) {
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    const int e = tid + q * THREADS;
    int m, k, n;
    a_coords<A>(e, m, k);
    ra[q] = (row0 + m < M && k0 + k < K) ? a.at(row0 + m, k0 + k) : 0.f;
    b_coords<B>(e, k, n);
    rb[q] = (k0 + k < K && col0 + n < N) ? b.at(k0 + k, col0 + n) : 0.f;
  }
}

template <class A, class B>
__device__ __forceinline__ void store_tiles(float (*as)[BM + PAD],
                                            float (*bs)[BN + PAD], int tid,
                                            const float (&ra)[4],
                                            const float (&rb)[4]) {
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    const int e = tid + q * THREADS;
    int m, k, n;
    a_coords<A>(e, m, k);
    as[k][m] = ra[q];
    b_coords<B>(e, k, n);
    bs[k][n] = rb[q];
  }
}

// The barrier of one 256-thread tile: bar 0 is the whole block
// (__syncthreads, gemm_kernel's 256 threads); bar > 0 is named barrier
// `bar` over 256 threads, so that a larger block (the fused stack K4,
// lstm_stack.cu) runs one tile in each 256-thread half without ever
// passing a block-wide barrier from half of its threads.
__device__ __forceinline__ void tile_sync(int bar) {
  if (bar == 0)
    __syncthreads();
  else
    asm volatile("bar.sync %0, %1;" ::"r"(bar), "n"(THREADS) : "memory");
}

// Shared memory of one tile, double-buffered.
struct TileSmem {
  float as[2][BK][BM + PAD];
  float bs[2][BK][BN + PAD];
};

// One BM x BN output tile of the batched product, computed by the 256
// threads tid = 0..255 that share barrier `bar` and the shared tiles `sm`.
// (bx, by, bz) are the tile's column, row and operand-pair index: operand
// z of direction d and learner l is (d ? a1 : a0).offset(l * sa), likewise
// b, and C at (d ? c1 : c0) + l * sc with row stride ldc, row r stored at
// rows(r).  The k-loop order and the FMA sequence of every output element
// depend on nothing else, so any caller computes the same bits.
template <class A, class B, int EPI, class O>
__device__ __forceinline__ void gemm_tile(
    A a0, A a1, B b0, B b1, void* c0, void* c1, size_t sa, size_t sb,
    size_t sc, int ldc, int M, int N, int K, int ndir, O rows, int bx,
    int by, int bz, int tid, int bar, TileSmem& sm) {
  using CT = typename OutT<EPI>::type;
  const int d = bz % ndir;
  const int l = bz / ndir;
  const A a = (d ? a1 : a0).offset((size_t)l * sa);
  const B b = (d ? b1 : b0).offset((size_t)l * sb);
  CT* c = static_cast<CT*>(d ? c1 : c0) + (size_t)l * sc;
  const int tx = tid % 16, ty = tid / 16;
  const int row0 = by * BM, col0 = bx * BN;

  float acc[8][8] = {};
  float ra[4], rb[4];
  load_tiles(a, b, row0, col0, 0, M, N, K, tid, ra, rb);
  store_tiles<A, B>(sm.as[0], sm.bs[0], tid, ra, rb);
  tile_sync(bar);
  for (int k0 = 0, cur = 0; k0 < K; k0 += BK, cur ^= 1) {
    const bool more = k0 + BK < K;
    if (more) load_tiles(a, b, row0, col0, k0 + BK, M, N, K, tid, ra, rb);
#pragma unroll
    for (int kk = 0; kk < BK; ++kk) {
      // rows ty*4 + {0..3} and 64 + ty*4 + {0..3}; columns likewise
      const float4 a0v = *reinterpret_cast<const float4*>(&sm.as[cur][kk][ty * 4]);
      const float4 a1v = *reinterpret_cast<const float4*>(&sm.as[cur][kk][64 + ty * 4]);
      const float4 b0v = *reinterpret_cast<const float4*>(&sm.bs[cur][kk][tx * 4]);
      const float4 b1v = *reinterpret_cast<const float4*>(&sm.bs[cur][kk][64 + tx * 4]);
      const float av[8] = {a0v.x, a0v.y, a0v.z, a0v.w, a1v.x, a1v.y, a1v.z, a1v.w};
      const float bv[8] = {b0v.x, b0v.y, b0v.z, b0v.w, b1v.x, b1v.y, b1v.z, b1v.w};
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] += av[i] * bv[j];
    }
    if (more) store_tiles<A, B>(sm.as[cur ^ 1], sm.bs[cur ^ 1], tid, ra, rb);
    tile_sync(bar);
  }
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int r = row0 + (i < 4 ? ty * 4 + i : 64 + ty * 4 + i - 4);
    if (r >= M) continue;
    const long orow = rows(r);
    if (orow < 0) continue;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int cc = col0 + (j < 4 ? tx * 4 + j : 64 + tx * 4 + j - 4);
      if (cc >= N) continue;
      CT* out = c + (size_t)orow * ldc + cc;
      if constexpr (EPI == EPI_F32) {
        *out = acc[i][j];
      } else if constexpr (EPI == EPI_ACC_F32) {
        *out += acc[i][j];
      } else if constexpr (EPI == EPI_BF16) {
        *out = __float2bfloat16(acc[i][j]);
      } else {
        const float mine = __bfloat162float(__float2bfloat16(acc[i][j]));
        *out = __float2bfloat16(__bfloat162float(*out) + mine);
      }
    }
  }
}

// grid (ceil(N / BN), ceil(M / BM), L * ndir): one tile per block.
template <class A, class B, int EPI, class O>
__global__ void __launch_bounds__(THREADS)
gemm_kernel(A a0, A a1, B b0, B b1, void* c0, void* c1, size_t sa,
            size_t sb, size_t sc, int ldc, int M, int N, int K, int ndir,
            O rows) {
  __shared__ __align__(16) TileSmem sm;
  gemm_tile<A, B, EPI, O>(a0, a1, b0, b1, c0, c1, sa, sb, sc, ldc, M, N, K,
                          ndir, rows, blockIdx.x, blockIdx.y, blockIdx.z,
                          threadIdx.x, 0, sm);
}

template <int EPI, class A, class B, class O = DenseRows>
int gemm(A a0, A a1, B b0, B b1, void* c0, void* c1, size_t sa, size_t sb,
         size_t sc, int ldc, int M, int N, int K, int L, int ndir,
         cudaStream_t st, O rows = O{}) {
  if (M < 1 || N < 1 || K < 1 || L < 1) return (int)cudaErrorInvalidValue;
  const dim3 grid((N + BN - 1) / BN, (M + BM - 1) / BM, L * ndir);
  gemm_kernel<A, B, EPI, O><<<grid, THREADS, 0, st>>>(
      a0, a1, b0, b1, c0, c1, sa, sb, sc, ldc, M, N, K, ndir, rows);
  return (int)cudaGetLastError();
}

}  // namespace lstm_gemm
