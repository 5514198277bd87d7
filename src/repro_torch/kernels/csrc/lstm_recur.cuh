// The serial halves of the BLSTM kernels, hand-written for sm_90a: the
// forward recurrence (K1 and its variants, and K3's replay of one chunk)
// and the reverse recurrence (K2, and K3's reverse steps over one chunk).
//
// One header so that K3 (lstm_bwd_chunked.cu) replays a chunk with the very
// instructions K1 ran (lstm_fwd.cu) and undoes it with the very
// instructions of K2 (lstm_bwd.cu): the recomputed gates and cell states
// are bit-identical to the stash of K1's training variant, and K3's
// dgates to K2's.  The file notes of lstm_fwd.cu and lstm_bwd.cu say what
// bounds each kernel on the H100.
//
// Time indexing shared by both kernels.  A launch walks `Tg` rows per
// batch row of its per-step arrays (gx, the stash, dgates): all T frames
// (Tg = T, local row k = frame t) or one K-frame chunk (Tg = K, local row
// k = frame t0 + k).  The forward direction's recurrence walks k upwards,
// the reverse direction downwards.  With seq_chunk = K the time axis is
// padded to T_pad = n·K frames (n = ceil(T / K)); recurrence chunk r of
// the forward direction covers frames [rK, (r+1)K), of the reverse
// direction [T_pad-(r+1)K, T_pad-rK) (`cmap`, lstm_cell.py:818-823).
// Frames t >= T are never stored: they are masked steps (lengths <= T),
// which change no carry, so a chunked launch reads them as zero.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace lstm_recur {

using bf16 = __nv_bfloat16;

constexpr int MAX_H = 512;   // one thread per hidden unit, one CTA

// Both recurrence kernels are declared __launch_bounds__(MAX_H, 1): one
// block per SM is all a step needs.  Without the minimum, ptxas held their
// registers to what two 512-thread blocks allow and spilled at two rows per
// CTA; with it they ran 1.6-5.5x faster on the H100 (PERF.md, kernel table).

__device__ __forceinline__ float sigmoidf_(float v) {
  return 1.f / (1.f + expf(-v));
}

// Stash element store and load: SD 1 = f32, 2 = bf16.
template <int SD>
__device__ __forceinline__ void store_stash(void* p, size_t i, float v) {
  if constexpr (SD == 1) static_cast<float*>(p)[i] = v;
  else static_cast<bf16*>(p)[i] = __float2bfloat16(v);
}
template <int SD>
__device__ __forceinline__ float load_stash(const void* p, size_t i) {
  if constexpr (SD == 1) return static_cast<const float*>(p)[i];
  else return __bfloat162float(static_cast<const bf16*>(p)[i]);
}

// First real frame of recurrence chunk `chunk` in direction d.
__device__ __forceinline__ int chunk_t0(int d, int chunk, int K, int n) {
  return d ? (n - 1 - chunk) * K : chunk * K;
}

// ---------------------------------------------------------------- forward

// What a forward launch writes besides y.
enum FwdMode {
  FWD = 0,        // y only (inference)
  FWD_STASH = 1,  // y, and the gates i|f|g|o and c of every step (dtype SD)
  FWD_ENTRY = 2,  // y, and the (h, c) carry entering each K-step chunk
  REPLAY = 3,     // no y: one chunk from its entry carry (dtype SD), its
                  // gates and c in f32 into chunk-sized buffers
};

struct FwdArgs {
  const float* gx;        // (L, 2, B, Tg, 4H) f32 x-projections
  const bf16* whf;        // (L, H, H, 4) bf16 gate-interleaved, per direction
  const bf16* whb;
  const float* bias_f;    // (L, 4H) f32
  const float* bias_b;
  const int* lengths;     // (L, B), each <= T
  bf16* y;                // (L, B, T, 2H): direction d in columns d*H..
  void* acts;             // FWD_STASH, REPLAY: (2, L, B, Tg, 4H)
  void* cseq;             // FWD_STASH, REPLAY: (2, L, B, Tg, H)
  void* hb;               // FWD_ENTRY writes, REPLAY reads: (2, L, B, n, H)
  void* cb;
  int L, B, T, H;
  int K, n;               // chunk length and count (FWD_ENTRY, REPLAY)
  int chunk;              // REPLAY: the recurrence chunk replayed
};

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

// Which work item a block walks: the block's own grid coordinates
// (GridItem: one item per block, read from blockIdx where it is used, so
// that ptxas keeps them in uniform registers as a kernel of its own does),
// or coordinates a persistent block computed (LoopItem).
struct GridItem {
  __device__ __forceinline__ int tile() const { return blockIdx.x; }
  __device__ __forceinline__ int dir() const { return blockIdx.y; }
  __device__ __forceinline__ int learner() const { return blockIdx.z; }
};
struct LoopItem {
  int t, d, l;
  __device__ __forceinline__ int tile() const { return t; }
  __device__ __forceinline__ int dir() const { return d; }
  __device__ __forceinline__ int learner() const { return l; }
};

// The forward recurrence of one work item: batch tile `item.tile()` (rows
// tile*BB ..), direction d, learner l, walked by every thread of the block
// (thread j owns hidden unit j < H; the others join the barriers), with
// the first BB * H floats of the block's dynamic shared memory as `hs`,
// the bf16-rounded h of the step (declared here, so that its loads and
// stores address shared memory directly).  KU weight loads are in flight per
// thread; fewer rows leave registers for more of them.  y, the stash and
// the replayed gates come from the same instructions in every mode, and
// in every kernel that calls this: K1 and K3's replay (blstm_recur_kernel,
// one item per block) and the fused stack K4 (lstm_stack.cu, items looped
// over a persistent grid).  The pointers carry no `__restrict__` here: K4
// writes gx and the layer input inside the same launch, so their loads
// must not become read-only-cache loads; the weights are read with __ldg.
template <int BB, int MODE, int SD, class Item,
          int KU = (BB <= 2 ? 16 : 8)>
__device__ __forceinline__ void blstm_recur_item(
    const float* gx, const bf16* whf, const bf16* whb, const float* bias_f,
    const float* bias_b, const int* lengths, bf16* y, void* acts,
    void* cseq, void* hb, void* cb, int L, int B, int T, int H, int K,
    int n, int chunk, Item item) {
  extern __shared__ float hs[];                  // [BB][H] bf16-rounded h
  const int d = item.dir();
  const int l = item.learner();
  const int b0 = item.tile() * BB;
  const size_t G = 4 * (size_t)H;
  const bf16* __restrict__ wh = (d ? whb : whf) + (size_t)l * H * G;
  const float* __restrict__ bias = (d ? bias_b : bias_f) + (size_t)l * G;
  lengths += (size_t)l * B;
  const int Tg = MODE == REPLAY ? K : T;
  const int t0 = MODE == REPLAY ? chunk_t0(d, chunk, K, n) : 0;
  gx += (size_t)(2 * l + d) * B * Tg * G;
  if constexpr (MODE != REPLAY) y += (size_t)l * B * T * 2 * H;
  const size_t srow = (size_t)(d * L + l) * B;   // stash row of b = 0
  const int j = threadIdx.x;
  const bool own = j < H;

  float h[BB], c[BB];
  int len[BB];
#pragma unroll
  for (int r = 0; r < BB; ++r) {
    const int b = b0 + r;
    h[r] = 0.f;
    c[r] = 0.f;
    len[r] = (b < B) ? lengths[b] : 0;
    if constexpr (MODE == REPLAY) {
      if (own && b < B) {
        const size_t e = ((srow + b) * n + chunk) * H + j;
        h[r] = load_stash<SD>(hb, e);
        c[r] = load_stash<SD>(cb, e);
      }
    }
    if constexpr (MODE == FWD_ENTRY) {   // chunk 0 enters with zeros
      if (own && b < B) {
        store_stash<SD>(hb, (srow + b) * n * H + j, 0.f);
        store_stash<SD>(cb, (srow + b) * n * H + j, 0.f);
      }
    }
    if (own) hs[r * H + j] = __bfloat162float(__float2bfloat16(h[r]));
  }
  float bi = 0.f, bfg = 0.f, bg = 0.f, bo = 0.f;
  if (own) {
    bi = bias[j];
    bfg = bias[H + j];
    bg = bias[2 * H + j];
    bo = bias[3 * H + j];
  }
  // FWD_ENTRY: real step s is padded recurrence step s + off (the reverse
  // direction starts with T_pad - T masked steps, which change nothing)
  const int off = (MODE == FWD_ENTRY && d) ? n * K - T : 0;
  __syncthreads();

  for (int s = 0; s < Tg; ++s) {
    const int k = d ? Tg - 1 - s : s;            // local row
    const int t = t0 + k;                        // frame
    if constexpr (MODE == FWD_ENTRY) {
      const int sp = s + off;
      if (own && sp > 0 && sp % K == 0) {
#pragma unroll
        for (int r = 0; r < BB; ++r) {
          if (b0 + r >= B) continue;
          const size_t e = ((srow + b0 + r) * n + sp / K) * H + j;
          store_stash<SD>(hb, e, h[r]);
          store_stash<SD>(cb, e, c[r]);
        }
      }
    }
    float acc[BB][4], xg[BB][4];
#pragma unroll
    for (int r = 0; r < BB; ++r) {
      acc[r][0] = acc[r][1] = acc[r][2] = acc[r][3] = 0.f;
      // this step's x-projection, loaded before the product hides it
      const size_t row = min(b0 + r, B - 1);
      const float* gr = gx + (row * Tg + k) * G;
#pragma unroll
      for (int g = 0; g < 4; ++g) xg[r][g] = own ? gr[g * H + j] : 0.f;
    }
    if (own) {
      // wh4[k * H + j] holds the 4 gate weights of unit j for input k
      const uint2* __restrict__ wh4 =
          reinterpret_cast<const uint2*>(wh) + j;
      int q0 = 0;
      for (; q0 + KU <= H; q0 += KU) {
        uint2 u[KU];                     // KU loads in flight per thread
#pragma unroll
        for (int q = 0; q < KU; ++q) u[q] = __ldg(wh4 + (size_t)(q0 + q) * H);
#pragma unroll
        for (int q = 0; q < KU; ++q) fma_gates<BB>(acc, u[q], hs + q0 + q, H);
      }
      for (; q0 < H; ++q0) fma_gates<BB>(acc, __ldg(wh4 + (size_t)q0 * H),
                                         hs + q0, H);
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
        if constexpr (MODE != REPLAY)
          y[((size_t)b * T + t) * 2 * H + (size_t)d * H + j] =
              __float2bfloat16(valid ? hn : 0.f);
        hs[r * H + j] = __bfloat162float(__float2bfloat16(h[r]));
        if constexpr (MODE == FWD_STASH || MODE == REPLAY) {
          constexpr int OUT = MODE == REPLAY ? 1 : SD;
          const size_t st = (srow + b) * Tg + k;
          store_stash<OUT>(acts, st * G + j, i_);
          store_stash<OUT>(acts, st * G + H + j, f_);
          store_stash<OUT>(acts, st * G + 2 * H + j, g_);
          store_stash<OUT>(acts, st * G + 3 * H + j, o_);
          store_stash<OUT>(cseq, st * H + j, c[r]);
        }
      }
    }
    __syncthreads();
  }
}

// grid (ceil(B / BB), 2, L), block H rounded up to 32, dynamic shared
// memory BB * H floats: one work item per block.  The arguments are
// FwdArgs' fields, passed one by one as `__restrict__` kernel parameters
// (likewise BwdArgs' for the reverse kernel).
template <int BB, int MODE, int SD>
__global__ void __launch_bounds__(MAX_H, 1) blstm_recur_kernel(
    const float* __restrict__ gx, const bf16* __restrict__ whf,
    const bf16* __restrict__ whb, const float* __restrict__ bias_f,
    const float* __restrict__ bias_b, const int* __restrict__ lengths,
    bf16* __restrict__ y, void* __restrict__ acts, void* __restrict__ cseq,
    void* __restrict__ hb, void* __restrict__ cb, int L, int B, int T, int H,
    int K, int n, int chunk) {
  blstm_recur_item<BB, MODE, SD>(gx, whf, whb, bias_f, bias_b, lengths, y,
                                 acts, cseq, hb, cb, L, B, T, H, K, n, chunk,
                                 GridItem{});
}

template <int BB, int MODE, int SD>
int launch_fwd(const FwdArgs& a, cudaStream_t st) {
  const dim3 grid((a.B + BB - 1) / BB, 2, a.L);
  const int threads = (a.H + 31) / 32 * 32;
  const size_t smem = (size_t)BB * a.H * sizeof(float);
  blstm_recur_kernel<BB, MODE, SD><<<grid, threads, smem, st>>>(
      a.gx, a.whf, a.whb, a.bias_f, a.bias_b, a.lengths, a.y, a.acts, a.cseq,
      a.hb, a.cb, a.L, a.B, a.T, a.H, a.K, a.n, a.chunk);
  return (int)cudaGetLastError();
}

template <int MODE, int SD>
int launch_fwd_rows(int block_b, const FwdArgs& a, cudaStream_t st) {
  switch (block_b) {
    case 1: return launch_fwd<1, MODE, SD>(a, st);
    case 2: return launch_fwd<2, MODE, SD>(a, st);
    case 4: return launch_fwd<4, MODE, SD>(a, st);
    case 8: return launch_fwd<8, MODE, SD>(a, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

// ---------------------------------------------------------------- reverse

struct BwdArgs {
  const bf16* dy;         // (L, B, T, 2H): direction d in columns d*H..
  const void* acts;       // (2, L, B, Tg, 4H) in dtype SD
  const void* cseq;       // (2, L, B, Tg, H)
  const bf16* whf;        // (L, H, H, 4): W4[c, j, q] = Wh[j, 4c + q]
  const bf16* whb;
  const int* lengths;     // (L, B)
  float* dg;              // (2, L, B, Tg, 4H) f32 out
  const void* cb;         // chunked: entry c carries (2, L, B, n, H), dtype CK
  float* dh;              // chunked: (dh, dc) carries (2, L, B, H) f32, in
  float* dc;              //   from the later chunk and out to the earlier one
  int L, B, T, H;
  int K, n, chunk;        // chunked: chunk length, count, and this chunk
};

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

// CK = 0: all T steps, (dh, dc) start at zero, c_{t-1} is zero at the
// sequence's first step.  CK = 1 or 2: one chunk (Tg = K) whose first
// step's c_{t-1} is its entry carry, with the (dh, dc) carries read at the
// start and written at the end.  grid (ceil(B / BB), 2, L), block H
// rounded up to 32, dynamic shared memory BB * 4H floats.
template <int BB, int SD, int CK, int KU = 8>
__global__ void __launch_bounds__(MAX_H, 1) lstm_bwd_recur_kernel(
    const bf16* __restrict__ dy, const void* __restrict__ acts,
    const void* __restrict__ cseq, const bf16* __restrict__ whf,
    const bf16* __restrict__ whb, const int* __restrict__ lengths,
    float* __restrict__ dg, const void* __restrict__ cb,
    float* __restrict__ dhp, float* __restrict__ dcp, int L, int B, int T,
    int H, int K, int n, int chunk) {
  extern __shared__ __align__(16) float dgs[];   // [BB][4H] this step's dgates
  const int d = blockIdx.y;
  const int l = blockIdx.z;
  const int b0 = blockIdx.x * BB;
  const size_t G = 4 * (size_t)H;
  const bf16* __restrict__ wh = (d ? whb : whf) + (size_t)l * H * G;
  lengths += (size_t)l * B;
  dy += (size_t)l * B * T * 2 * H + (size_t)d * H;
  const int Tg = CK ? K : T;
  const int t0 = CK ? chunk_t0(d, chunk, K, n) : 0;
  const size_t srow = (size_t)(d * L + l) * B;   // stash/dgates row of b = 0
  const int j = threadIdx.x;
  const bool own = j < H;

  float dh_c[BB], dc_c[BB], c_in[BB];
  int len[BB];
#pragma unroll
  for (int r = 0; r < BB; ++r) {
    const int b = b0 + r;
    dh_c[r] = 0.f;
    dc_c[r] = 0.f;
    c_in[r] = 0.f;
    len[r] = (b < B) ? lengths[b] : 0;
    if constexpr (CK != 0) {
      if (own && b < B) {
        const size_t e = (srow + b) * H + j;
        dh_c[r] = dhp[e];
        dc_c[r] = dcp[e];
        c_in[r] = load_stash<CK>(cb, ((srow + b) * n + chunk) * H + j);
      }
    }
  }

  for (int v = 0; v < Tg; ++v) {
    // the recurrence step undone now, and the one before it
    const int k = d ? v : Tg - 1 - v;
    const int kp = d ? k + 1 : k - 1;
    const bool boundary = v == Tg - 1;
    const int t = t0 + k;
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
      const size_t st = (srow + b) * Tg + k;
      const float i_ = load_stash<SD>(acts, st * G + j);
      const float f_ = load_stash<SD>(acts, st * G + H + j);
      const float g_ = load_stash<SD>(acts, st * G + 2 * H + j);
      const float o_ = load_stash<SD>(acts, st * G + 3 * H + j);
      const float c = load_stash<SD>(cseq, st * H + j);
      const float cp = boundary
          ? c_in[r] : load_stash<SD>(cseq, ((srow + b) * Tg + kp) * H + j);
      const float dyv =
          t < T ? __bfloat162float(dy[((size_t)b * T + t) * 2 * H + j]) : 0.f;
      float dh = dyv + dh_c[r];
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
  if constexpr (CK != 0) {
#pragma unroll
    for (int r = 0; r < BB; ++r) {
      if (!own || b0 + r >= B) continue;
      const size_t e = (srow + b0 + r) * H + j;
      dhp[e] = dh_c[r];
      dcp[e] = dc_c[r];
    }
  }
}

template <int BB, int SD, int CK>
int launch_bwd(const BwdArgs& a, cudaStream_t st) {
  const dim3 grid((a.B + BB - 1) / BB, 2, a.L);
  const int threads = (a.H + 31) / 32 * 32;
  const size_t smem = (size_t)BB * 4 * a.H * sizeof(float);
  auto kernel = lstm_bwd_recur_kernel<BB, SD, CK>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  kernel<<<grid, threads, smem, st>>>(a.dy, a.acts, a.cseq, a.whf, a.whb,
                                       a.lengths, a.dg, a.cb, a.dh, a.dc, a.L,
                                       a.B, a.T, a.H, a.K, a.n, a.chunk);
  return (int)cudaGetLastError();
}

template <int SD, int CK>
int launch_bwd_rows(int block_b, const BwdArgs& a, cudaStream_t st) {
  switch (block_b) {
    case 1: return launch_bwd<1, SD, CK>(a, st);
    case 2: return launch_bwd<2, SD, CK>(a, st);
    case 4: return launch_bwd<4, SD, CK>(a, st);
    case 8: return launch_bwd<8, SD, CK>(a, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace lstm_recur
