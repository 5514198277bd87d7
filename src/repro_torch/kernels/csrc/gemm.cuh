// Batched f32-accumulating GEMM shared by the BLSTM kernels, hand-written
// for sm_90a on the tensor cores.
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
// A and B are *views*: a functor returns logical element (r, c), or the
// address of 8 elements along its contiguous index, so one routine serves
// row-major, transposed and time-shifted operands, or the rows of one
// K-frame chunk of every sequence (the chunked backward K3), whose output
// rows map back to the frames they came from.  Elements outside M, N or K
// read as zero.
//
// Products on the tensor cores: mma.sync.m16n8k16 bf16 with f32 sums.  A
// bf16 operand (x, the weights, h_prev) is exact in bf16.  An f32 operand
// (the backward's dgates, which the reference multiplies in f32,
// lstm_cell.py:583-606) is split as it is staged into shared memory into
// three bf16 parts, v = p0 + p1 + p2 + r with |r| <= 2^-24 |v| (each part
// the bf16 rounding of what the parts before it left), and every k-step
// issues one mma per part: the three products sum to the f32 product to
// f32 accuracy (tests/test_torch_gpu.py and chip_smoke.py hold them within
// 1e-5 of a float64 product).  Tiles are 128 x 128 x BK on 256 threads (8
// warps of 64 x 32 outputs), staged global -> registers -> shared memory
// (8-element runs, 16-byte loads where the view allows) and double-
// buffered, fragments by ldmatrix (.trans where a tile is stored k-major).
// One tile is the `__device__` routine `gemm_tile`: `gemm_kernel` runs it
// once per block, and the fused stack K4 (lstm_stack.cu) in each 256-thread
// half of its blocks, so K4's x-projections are the very bits of K1's
// `lstm_xproj`.  Every output element is the same sequence of mma steps
// over k (parts in the order p0, p1, p2) whatever M, its row's place in
// the tile or the caller: K3's chunked dx is K2's bit for bit.
//
// What bounds it: at the training shapes (M, N, K in the hundreds to
// thousands) operations, at the bf16 tensor-core peak (989 TFLOP/s) for
// x·Wx and at a third of it for the split products.  mma.sync reaches a
// fraction of that peak; `wgmma` with TMA-fed tiles is left to a later
// change.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace lstm_gemm {

using bf16 = __nv_bfloat16;

constexpr int BM = 128;
constexpr int BN = 128;
constexpr int THREADS = 256;      // 8 warps: 2 (rows) x 4 (columns)
constexpr int LDT = BM + 8;       // row stride of a tile stored k-major
static_assert(BM == BN, "one k-major row stride for both operands");

enum Epilogue {
  EPI_F32 = 0,       // C f32 = acc
  EPI_BF16 = 1,      // C bf16 = bf16(acc)
  EPI_ADD_BF16 = 2,  // C bf16 = bf16(f32(C) + f32(bf16(acc)))
  EPI_ACC_F32 = 3,   // C f32 += acc (a sum over several launches)
};

template <typename T>
__device__ __forceinline__ T from_f(float v);
template <>
__device__ __forceinline__ float from_f<float>(float v) { return v; }
template <>
__device__ __forceinline__ bf16 from_f<bf16>(float v) {
  return __float2bfloat16(v);
}

// Logical (r, c) of a matrix in memory: p[r * ld + c], or p[c * ld + r]
// when TRANS.  kRowContig: neighbouring r are neighbouring addresses.
// Every view has `at` (one element) and `run` (the address of 8 elements
// along its contiguous index from (r, c), or null where they are not
// plain memory).
template <typename T_, bool TRANS>
struct Mat {
  using T = T_;
  const T* p;
  long ld;
  static constexpr bool kRowContig = TRANS;
  __device__ __forceinline__ const T* run(int r, int c) const {
    return TRANS ? p + (size_t)c * ld + r : p + (size_t)r * ld + c;
  }
  __device__ __forceinline__ T at(int r, int c) const { return *run(r, c); }
  __device__ __forceinline__ Mat offset(size_t n) const { return {p + n, ld}; }
};

// A(m, k) = h_prev of the LSTM backward, read from the layer output y:
// k indexes the B*T rows of one learner (k = b*T + t) and m the hidden
// unit.  For m < H: y[k + shift][m] when t + shift stays inside the
// sequence, else 0 (the zero initial state at the recurrence boundary);
// m == H is a row of ones, so the same product also yields Σ_k B(k, n).
struct ShiftedRows {
  using T = bf16;
  const bf16* p;
  long ld;
  int T_, shift, H;
  static constexpr bool kRowContig = true;
  __device__ __forceinline__ const bf16* run(int m, int k) const {
    const int t = k % T_ + shift;
    if (t < 0 || t >= T_ || m + 8 > H) return nullptr;
    return p + (size_t)(k + shift) * ld + m;
  }
  __device__ __forceinline__ bf16 at(int m, int k) const {
    if (m == H) return from_f<bf16>(1.f);
    const int t = k % T_ + shift;
    if (t < 0 || t >= T_) return from_f<bf16>(0.f);
    return p[(size_t)(k + shift) * ld + m];
  }
  __device__ __forceinline__ ShiftedRows offset(size_t n) const {
    return {p + n, ld, T_, shift, H};
  }
};

// One K-frame chunk of the B sequences of one learner, (B*T, ld) in
// memory: chunk row i = b*K + k is frame t0 + k of sequence b, zero at
// frames >= T.  TRANS = false: logical (i, m); TRANS = true: (m, i).
template <bool TRANS>
struct ChunkRows {
  using T = bf16;
  const bf16* p;
  long ld;
  int T_, K, t0;
  static constexpr bool kRowContig = TRANS;
  __device__ __forceinline__ const bf16* run(int r, int c) const {
    const int i = TRANS ? c : r, m = TRANS ? r : c;
    const int t = t0 + i % K;
    if (t >= T_) return nullptr;
    return p + ((size_t)(i / K) * T_ + t) * ld + m;
  }
  __device__ __forceinline__ bf16 at(int r, int c) const {
    const bf16* q = run(r, c);
    return q ? *q : from_f<bf16>(0.f);
  }
  __device__ __forceinline__ ChunkRows offset(size_t n) const {
    return {p + n, ld, T_, K, t0};
  }
};

// ShiftedRows over one chunk: A(m, i) = y at frame t0 + i % K + shift of
// sequence i / K (zero outside [0, T)), and a row of ones at m == H.
struct ShiftedChunkRows {
  using T = bf16;
  const bf16* p;
  long ld;
  int T_, K, t0, shift, H;
  static constexpr bool kRowContig = true;
  __device__ __forceinline__ const bf16* frame(int m, int i) const {
    const int t = t0 + i % K + shift;
    if (t < 0 || t >= T_) return nullptr;
    return p + ((size_t)(i / K) * T_ + t) * ld + m;
  }
  __device__ __forceinline__ const bf16* run(int m, int i) const {
    return m + 8 > H ? nullptr : frame(m, i);
  }
  __device__ __forceinline__ bf16 at(int m, int i) const {
    if (m == H) return from_f<bf16>(1.f);
    const bf16* q = frame(m, i);
    return q ? *q : from_f<bf16>(0.f);
  }
  __device__ __forceinline__ ShiftedChunkRows offset(size_t n) const {
    return {p + n, ld, T_, K, t0, shift, H};
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

// The shared-memory layout of one (A, B) operand pair.  An f32 operand is
// held as three bf16 planes (its split parts), a bf16 operand as one.  A
// tile is stored k-contiguous ([x][k], row stride LDK) where its view is
// contiguous along k, else k-major ([k][x], row stride LDT), so that each
// thread's 8-element run is one 16-byte shared store; ldmatrix reads the
// fragments (.trans for a k-major A and a k-major B).  BK, the k-depth of
// a stage (16 or 32), changes how many mma k-steps one barrier covers,
// not their sequence: every BK gives the same bits.  16 by default; 32 for
// K1's x-projection (`lstm_xproj`), whose plain views keep two runs a
// thread within 128 registers, and ran faster so on the H100; the split
// products and the chunk views took more registers at 32 and ran slower.
template <class A, class B, int BK_ = 16>
struct Tile {
  static constexpr int BK = BK_;
  static constexpr int LDK = BK + 8;   // row stride of a k-contiguous tile
  static constexpr int RUNS = BM * BK / (8 * THREADS);   // runs a thread
                                                         // stages an operand
  static constexpr bool SA = std::is_same<typename A::T, float>::value;
  static constexpr bool SB = std::is_same<typename B::T, float>::value;
  static_assert(!(SA && SB), "one f32 operand at most");
  static constexpr int PA = SA ? 3 : 1;       // bf16 planes per operand
  static constexpr int PB = SB ? 3 : 1;
  static constexpr bool KCA = !A::kRowContig;  // A(m, k) contiguous in k
  static constexpr bool KCB = B::kRowContig;   // B(k, n) contiguous in k
  static constexpr int PLANE_A = KCA ? BM * LDK : BK * LDT;
  static constexpr int PLANE_B = KCB ? BN * LDK : BK * LDT;
  static constexpr int STAGE = PA * PLANE_A + PB * PLANE_B;   // bf16 elements
  static constexpr size_t SMEM = 2 * STAGE * sizeof(bf16);    // two stages
};

// Where 8-element run e of an operand tile of depth BK starts (x: the M
// or N index, k) for a tile stored k-contiguous or not.
template <bool KC, int BK>
__device__ __forceinline__ void run_coords(int e, int& x, int& k) {
  if (KC) { x = e / (BK / 8); k = e % (BK / 8) * 8; }
  else    { k = e / (BM / 8); x = e % (BM / 8) * 8; }
}

// One thread's staged run of 8 elements: bf16 as one 16-byte word, f32
// as two.
template <typename T>
struct Run;
template <>
struct Run<bf16> {
  uint4 w;
  static __device__ __forceinline__ uint32_t pack(bf16 lo, bf16 hi) {
    return (uint32_t)__bfloat16_as_ushort(lo) |
           ((uint32_t)__bfloat16_as_ushort(hi) << 16);
  }
  __device__ __forceinline__ void set(const bf16 (&e)[8]) {
    w = make_uint4(pack(e[0], e[1]), pack(e[2], e[3]), pack(e[4], e[5]),
                   pack(e[6], e[7]));
  }
};
template <>
struct Run<float> {
  float4 w[2];
  __device__ __forceinline__ void set(const float (&e)[8]) {
    w[0] = make_float4(e[0], e[1], e[2], e[3]);
    w[1] = make_float4(e[4], e[5], e[6], e[7]);
  }
};

// The 8 elements of view v from logical (r, c) along its contiguous
// index; rows >= R and columns >= C read as zero.
template <class V>
__device__ __forceinline__ void load_run(const V& v, int r, int c, int R,
                                         int C, Run<typename V::T>& out) {
  using T = typename V::T;
  constexpr bool along_r = V::kRowContig;
  const int n = along_r ? R - r : C - c;
  const bool inside = along_r ? c < C : r < R;
  if (inside && n >= 8) {
    const T* q = v.run(r, c);
    if (q && ((uintptr_t)q & 15) == 0) {
      out = *reinterpret_cast<const Run<T>*>(q);
      return;
    }
  }
  T e[8];
#pragma unroll
  for (int i = 0; i < 8; ++i)
    e[i] = (inside && i < n) ? v.at(along_r ? r + i : r, along_r ? c : c + i)
                             : from_f<T>(0.f);
  out.set(e);
}

// Store one run into the planes of a stage: bf16 as it is, f32 as its
// three bf16 parts (p0 = bf16(v), p1 = bf16(v - p0), p2 = bf16(v - p0 -
// p1); each difference is exact in f32).
__device__ __forceinline__ void store_run(bf16* s, int /*plane*/,
                                          const Run<bf16>& e) {
  *reinterpret_cast<uint4*>(s) = e.w;
}
__device__ __forceinline__ void store_run(bf16* s, int plane,
                                          const Run<float>& e) {
  const float v[8] = {e.w[0].x, e.w[0].y, e.w[0].z, e.w[0].w,
                      e.w[1].x, e.w[1].y, e.w[1].z, e.w[1].w};
  float rest[8];
#pragma unroll
  for (int i = 0; i < 8; ++i) rest[i] = v[i];
#pragma unroll
  for (int q = 0; q < 3; ++q) {
    bf16 p[8];
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      p[i] = __float2bfloat16(rest[i]);
      rest[i] -= __bfloat162float(p[i]);
    }
    Run<bf16> part;
    part.set(p);
    *reinterpret_cast<uint4*>(s + q * plane) = part.w;
  }
}

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const bf16* p) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(p);
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(s));
}

__device__ __forceinline__ void ldsm_x4_t(uint32_t (&r)[4], const bf16* p) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(p);
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(s));
}

// d += a (16 x 16, row-major) * b (16 x 8, column-major), bf16 in, f32 out
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// The A fragment (16 rows from m0, k kk..kk+15) of one plane; lane l
// names the row of matrix l / 8 (a0: rows 0-7, k 0-7; a1: rows 8-15; a2,
// a3: k 8-15).
template <bool KC, int LDK>
__device__ __forceinline__ void load_a(uint32_t (&a)[4], const bf16* plane,
                                       int m0, int kk, int lane) {
  const int q = lane >> 3, i = lane & 7;
  if (KC)
    ldsm_x4(a, plane + (m0 + (q & 1) * 8 + i) * LDK + kk + (q >> 1) * 8);
  else
    ldsm_x4_t(a, plane + (kk + (q >> 1) * 8 + i) * LDT + m0 + (q & 1) * 8);
}

// The B fragments of two n8 tiles (columns n0 .. n0 + 15, k kk..kk+15):
// b[0], b[1] of the first, b[2], b[3] of the second.
template <bool KC, int LDK>
__device__ __forceinline__ void load_b(uint32_t (&b)[4], const bf16* plane,
                                       int n0, int kk, int lane) {
  const int q = lane >> 3, i = lane & 7;
  if (KC)
    ldsm_x4(b, plane + (n0 + (q >> 1) * 8 + i) * LDK + kk + (q & 1) * 8);
  else
    ldsm_x4_t(b, plane + (kk + (q & 1) * 8 + i) * LDT + n0 + (q >> 1) * 8);
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

// One BM x BN output tile of the batched product, computed by the 256
// threads tid = 0..255 that share barrier `bar` and `Tile<A, B, BK>::SMEM`
// bytes of shared memory at `sm` (16-byte aligned).  (bx, by, bz) are the
// tile's column, row and operand-pair index: operand z of direction d and
// learner l is (d ? a1 : a0).offset(l * sa), likewise b, and C at
// (d ? c1 : c0) + l * sc with row stride ldc, row r stored at rows(r).
// The k-loop and the mma sequence of every output element depend on
// nothing else, so any caller computes the same bits.
template <class A, class B, int EPI, class O, int BK>
__device__ __forceinline__ void gemm_tile(
    A a0, A a1, B b0, B b1, void* c0, void* c1, size_t sa, size_t sb,
    size_t sc, int ldc, int M, int N, int K, int ndir, O rows, int bx,
    int by, int bz, int tid, int bar, bf16* sm) {
  using CT = typename OutT<EPI>::type;
  using L = Tile<A, B, BK>;
  constexpr int RUNS = L::RUNS, LDK = L::LDK;
  const int d = bz % ndir;
  const int l = bz / ndir;
  const A a = (d ? a1 : a0).offset((size_t)l * sa);
  const B b = (d ? b1 : b0).offset((size_t)l * sb);
  CT* c = static_cast<CT*>(d ? c1 : c0) + (size_t)l * sc;
  const int row0 = by * BM, col0 = bx * BN;
  const int lane = tid & 31, warp = tid >> 5;
  const int wm = (warp >> 2) * 64, wn = (warp & 3) * 32;

  // this thread's runs of each operand tile
  int xa[RUNS], ka[RUNS], xb[RUNS], kb[RUNS];
#pragma unroll
  for (int i = 0; i < RUNS; ++i) {
    run_coords<L::KCA, BK>(tid + i * THREADS, xa[i], ka[i]);
    run_coords<L::KCB, BK>(tid + i * THREADS, xb[i], kb[i]);
  }
  Run<typename A::T> ea[RUNS];
  Run<typename B::T> eb[RUNS];
  auto load = [&](int k0) {
#pragma unroll
    for (int i = 0; i < RUNS; ++i) {
      load_run(a, row0 + xa[i], k0 + ka[i], M, K, ea[i]);
      load_run(b, k0 + kb[i], col0 + xb[i], K, N, eb[i]);
    }
  };
  auto store = [&](int stage) {
    bf16* s = sm + stage * L::STAGE;
#pragma unroll
    for (int i = 0; i < RUNS; ++i) {
      store_run(s + (L::KCA ? xa[i] * LDK + ka[i] : ka[i] * LDT + xa[i]),
                L::PLANE_A, ea[i]);
      store_run(s + L::PA * L::PLANE_A +
                    (L::KCB ? xb[i] * LDK + kb[i] : kb[i] * LDT + xb[i]),
                L::PLANE_B, eb[i]);
    }
  };

  float acc[4][4][4] = {};
  load(0);
  store(0);
  tile_sync(bar);
  for (int k0 = 0, cur = 0; k0 < K; k0 += BK, cur ^= 1) {
    const bool more = k0 + BK < K;
    if (more) load(k0 + BK);
    const bf16* s = sm + cur * L::STAGE;
    const bf16* sbp = s + L::PA * L::PLANE_A;
#pragma unroll
    for (int kk = 0; kk < BK; kk += 16) {
      uint32_t bf[L::PB][2][4];
#pragma unroll
      for (int pb = 0; pb < L::PB; ++pb)
#pragma unroll
        for (int np = 0; np < 2; ++np)
          load_b<L::KCB, LDK>(bf[pb][np], sbp + pb * L::PLANE_B, wn + np * 16,
                              kk, lane);
#pragma unroll
      for (int mt = 0; mt < 4; ++mt) {
#pragma unroll
        for (int pa = 0; pa < L::PA; ++pa) {
          uint32_t af[4];
          load_a<L::KCA, LDK>(af, s + pa * L::PLANE_A, wm + mt * 16, kk,
                              lane);
#pragma unroll
          for (int pb = 0; pb < L::PB; ++pb)
#pragma unroll
            for (int nt = 0; nt < 4; ++nt)
              mma_bf16(acc[mt][nt], af, bf[pb][nt >> 1][(nt & 1) * 2],
                       bf[pb][nt >> 1][(nt & 1) * 2 + 1]);
        }
      }
    }
    if (more) store(cur ^ 1);
    tile_sync(bar);
  }

  const int gid = lane >> 2, tig = lane & 3;
#pragma unroll
  for (int mt = 0; mt < 4; ++mt) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = row0 + wm + mt * 16 + gid + h * 8;
      if (r >= M) continue;
      const long orow = rows(r);
      if (orow < 0) continue;
#pragma unroll
      for (int nt = 0; nt < 4; ++nt) {
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          const int cc = col0 + wn + nt * 8 + tig * 2 + i;
          if (cc >= N) continue;
          const float v = acc[mt][nt][h * 2 + i];
          CT* out = c + (size_t)orow * ldc + cc;
          if constexpr (EPI == EPI_F32) {
            *out = v;
          } else if constexpr (EPI == EPI_ACC_F32) {
            *out += v;
          } else if constexpr (EPI == EPI_BF16) {
            *out = __float2bfloat16(v);
          } else {
            const float mine = __bfloat162float(__float2bfloat16(v));
            *out = __float2bfloat16(__bfloat162float(*out) + mine);
          }
        }
      }
    }
  }
}

// grid (ceil(N / BN), ceil(M / BM), L * ndir): one tile per block, two
// blocks per SM (128 registers: K3's chunk views, at up to 180 registers
// and one block per SM, ran slower than they do now, spills and all).
template <class A, class B, int EPI, class O, int BK>
__global__ void __launch_bounds__(THREADS, 2)
gemm_kernel(A a0, A a1, B b0, B b1, void* c0, void* c1, size_t sa,
            size_t sb, size_t sc, int ldc, int M, int N, int K, int ndir,
            O rows) {
  extern __shared__ __align__(16) unsigned char gemm_smem[];
  gemm_tile<A, B, EPI, O, BK>(
      a0, a1, b0, b1, c0, c1, sa, sb, sc, ldc, M, N, K, ndir, rows,
      blockIdx.x, blockIdx.y, blockIdx.z, threadIdx.x, 0,
      reinterpret_cast<bf16*>(gemm_smem));
}

template <int EPI, int BK = 16, class A, class B, class O = DenseRows>
int gemm(A a0, A a1, B b0, B b1, void* c0, void* c1, size_t sa, size_t sb,
         size_t sc, int ldc, int M, int N, int K, int L, int ndir,
         cudaStream_t st, O rows = O{}) {
  if (M < 1 || N < 1 || K < 1 || L < 1) return (int)cudaErrorInvalidValue;
  const dim3 grid((N + BN - 1) / BN, (M + BM - 1) / BM, L * ndir);
  constexpr size_t smem = Tile<A, B, BK>::SMEM;
  auto kernel = gemm_kernel<A, B, EPI, O, BK>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  kernel<<<grid, THREADS, smem, st>>>(a0, a1, b0, b1, c0, c1, sa, sb, sc,
                                      ldc, M, N, K, ndir, rows);
  return (int)cudaGetLastError();
}

}  // namespace lstm_gemm
