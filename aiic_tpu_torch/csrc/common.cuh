// Shared building blocks of the Hopper half-block kernels (sm_90a).
//
// - load_row / rowquant_kernel / ln_rows_kernel: one block per row;
//   optional LayerNorm with fp32 statistics, then either symmetric per-row
//   int8 quantization (amax/127 with a 1e-6 floor, true division, round
//   half to even, clamp to +-127; the LN result stays fp32 into the
//   quantizer, as in the JAX int8 kernels) or one rounding to bf16 (the
//   unquantized kernels cast LN x to the compute dtype before the product).
// - gemm_kernel: a tiled tensor-core product C = A @ B for A (M, K) and
//   B (K, N), both row-major, through WMMA 16x16x16 fragments (int8 -> int32
//   or bf16 -> fp32). B is the weight in the port's (in, out) layout, read
//   directly as a row-major matrix_b, so no transposed copy is kept. The
//   fp32/int32 tile goes through shared memory to a per-element epilogue
//   functor that does the dequant, bias, activation or residual. A transposed
//   B (kTransB, for dy @ W^T) and a split depth (blockIdx.z) are options.
// - attn_core_kernel<T, D, L>: the scalar streaming no-max attention core,
//   for bf16 and fp32, on a (B, S, 3W) projection whose columns are packed
//   [Q | K | V], or on three separate (B, S, H, D) arrays. Row 6 at D = 8
//   and the WMMA forms of rows 1, 4 (int8_halves.cuh) and 5 of the TPU
//   kernel table run it (rows 1 and 5, bf16 rows 7 and 8, and bf16 row 6
//   at D = 64, run the tensor-core core of attn_core_mma.cuh;
//   fp32 rows 7 and 6 at D = 64 the register-tiled core of
//   attn_core_f32.cuh, which keeps this one's fp32 form only to be timed
//   beside it); T is the rounding policy (q*c, p and the output round to T,
//   which is a no-op for fp32).
// - block_core_bwd_kernel<T, TO>: the attention-core backward with the
//   S x S probabilities in shared memory, one block per (head, image), for
//   S <= 128 (the fp32 text block, the first design (form 1) of rows 12
//   and 14, and fp32 row 9's one-tile form; bf16 row 9 and form 0 of rows
//   12 and 14 run the tensor-core backward of attn_core_bwd_mma.cuh).
//
// Built with -fmad=false so the epilogues' a*b+c round twice, as the plain
// PyTorch versions do; the products themselves use the tensor cores or
// explicit fmaf.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

#include <type_traits>

#define AIIC_CHECK(expr)                       \
  do {                                         \
    const cudaError_t aiic_err_ = (expr);      \
    if (aiic_err_ != cudaSuccess) return aiic_err_; \
  } while (0)

namespace aiic {
namespace {

using bf16 = __nv_bfloat16;
constexpr float kLog2e = 1.4426950408889634f;

// ---------------------------------------------------------------------------
// Row passes: [LayerNorm] + per-row int8 quantization, or LayerNorm -> bf16
// ---------------------------------------------------------------------------

constexpr int kRowThreads = 256;

__device__ __forceinline__ float warp_reduce(float v, bool take_max) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    const float other = __shfl_xor_sync(0xffffffffu, v, o);
    v = take_max ? fmaxf(v, other) : v + other;
  }
  return v;
}

// Sum or max over the block (blockDim.x == kRowThreads). 0 is the identity
// for both uses: sums, and maxima of absolute values.
__device__ float block_reduce(float v, bool take_max, float* red) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  v = warp_reduce(v, take_max);
  if (lane == 0) red[warp] = v;
  __syncthreads();
  if (warp == 0) {
    v = lane < kRowThreads / 32 ? red[lane] : 0.f;
    v = warp_reduce(v, take_max);
    if (lane == 0) red[kRowThreads / 32] = v;
  }
  __syncthreads();
  return red[kRowThreads / 32];
}

__device__ __forceinline__ float to_f32(bf16 v) { return __bfloat162float(v); }
__device__ __forceinline__ float to_f32(float v) { return v; }

// One row of x into h[] (fp32), LayerNorm'd when kLN. Each thread touches
// only its own strided elements of the row, so the block reductions are the
// only syncs and callers may read their own h[i] right after.
template <bool kLN, typename TIn>
__device__ __forceinline__ void load_row(const TIn* __restrict__ xr, const float* __restrict__ ln_s,
                                         const float* __restrict__ ln_b, float* h, float* red,
                                         int W, float eps) {
  float part = 0.f;
  for (int i = threadIdx.x; i < W; i += kRowThreads) {
    const float v = to_f32(xr[i]);
    h[i] = v;
    part += v;
  }
  if (kLN) {
    const float mean = block_reduce(part, false, red) / static_cast<float>(W);
    __syncthreads();  // red is reused below
    float sq = 0.f;
    for (int i = threadIdx.x; i < W; i += kRowThreads) {
      const float d = h[i] - mean;
      sq += d * d;
    }
    const float var = block_reduce(sq, false, red) / static_cast<float>(W);
    __syncthreads();
    const float rstd = 1.0f / sqrtf(var + eps);
    for (int i = threadIdx.x; i < W; i += kRowThreads)
      h[i] = (h[i] - mean) * rstd * ln_s[i] + ln_b[i];
  }
}

// Symmetric int8 quantization of the row h[0, W) into qr and its scale into
// *qscale; each thread reads only its own strided elements of h.
__device__ __forceinline__ void quantize_row(const float* h, int8_t* __restrict__ qr,
                                             float* __restrict__ qscale, int W, float* red) {
  float amax = 0.f;
  for (int i = threadIdx.x; i < W; i += kRowThreads) amax = fmaxf(amax, fabsf(h[i]));
  amax = block_reduce(amax, true, red);
  const float scale = fmaxf(amax, 1e-6f) / 127.0f;
  for (int i = threadIdx.x; i < W; i += kRowThreads) {
    const float v = fminf(fmaxf(rintf(h[i] / scale), -127.f), 127.f);
    qr[i] = static_cast<int8_t>(v);
  }
  if (threadIdx.x == 0) *qscale = scale;
}

// x (rows, W), row stride ld -> q (rows, W) int8 and qscale (rows,).
// Dynamic shared memory: W floats (the row, normalized in place).
template <bool kLN, typename TIn>
__global__ void __launch_bounds__(kRowThreads)
rowquant_kernel(const TIn* __restrict__ x, const float* __restrict__ ln_s,
                const float* __restrict__ ln_b, int8_t* __restrict__ q,
                float* __restrict__ qscale, int W, float eps, int ld) {
  extern __shared__ float h[];
  __shared__ float red[kRowThreads / 32 + 1];
  const size_t row = blockIdx.x;
  load_row<kLN>(x + row * ld, ln_s, ln_b, h, red, W, eps);
  quantize_row(h, q + row * W, qscale + row, W, red);
}

// x (rows, W) bf16 -> bf16(LN x) (rows, W). Dynamic shared memory: W floats.
__global__ void __launch_bounds__(kRowThreads)
ln_rows_kernel(const bf16* __restrict__ x, const float* __restrict__ ln_s,
               const float* __restrict__ ln_b, bf16* __restrict__ out, int W, float eps) {
  extern __shared__ float h[];
  __shared__ float red[kRowThreads / 32 + 1];
  const size_t row = blockIdx.x;
  load_row<true>(x + row * W, ln_s, ln_b, h, red, W, eps);
  bf16* o = out + row * W;
  for (int i = threadIdx.x; i < W; i += kRowThreads) o[i] = __float2bfloat16_rn(h[i]);
}

// ---------------------------------------------------------------------------
// Tensor-core GEMM with a per-element epilogue
// ---------------------------------------------------------------------------

constexpr int kBM = 128, kBN = 128, kBK = 32, kGemmThreads = 256;

template <typename T> struct GemmTypes;
template <> struct GemmTypes<int8_t> { using frag = signed char; using acc = int; };
template <> struct GemmTypes<bf16> { using frag = __nv_bfloat16; using acc = float; };

template <typename T>
using GemmAcc = nvcuda::wmma::fragment<nvcuda::wmma::accumulator, 16, 16, 16,
                                       typename GemmTypes<T>::acc>;

// The B tile of k-step k0 (rows k0..k0+kBK of a row-major (K, N) B, columns
// n0..n0+kBN) into Bs[n/16][k][16], one 16-byte vector per load.
template <typename T>
__device__ __forceinline__ void load_b_tile(T (*Bs)[kBK][16], const T* __restrict__ B, int N,
                                            int n0, int k0, int tid) {
  constexpr int kVec = 16 / sizeof(T);
  for (int c = tid; c < kBK * kBN / kVec; c += kGemmThreads) {
    const int kr = c / (kBN / kVec), nc = (c % (kBN / kVec)) * kVec;
    *reinterpret_cast<uint4*>(&Bs[nc / 16][kr][nc % 16]) =
        *reinterpret_cast<const uint4*>(B + static_cast<size_t>(k0 + kr) * N + n0 + nc);
  }
}

// One k-step of the block tile: warp (wm, wn)'s 4x2 fragments += As . Bs
// (Bs read as the transposed view [k/16][n][16] when kTransB).
template <typename T, bool kTransB>
__device__ __forceinline__ void mma_ktile(T (*As)[kBM][16], T (*Bs)[kBK][16],
                                          GemmAcc<T> (&acc)[4][2], int wm, int wn) {
  using namespace nvcuda;
  using FragT = typename GemmTypes<T>::frag;
  using BLayout = typename std::conditional<kTransB, wmma::col_major, wmma::row_major>::type;
  T (*const Bt)[kBN][16] = reinterpret_cast<T (*)[kBN][16]>(&Bs[0][0][0]);
#pragma unroll
  for (int kk = 0; kk < kBK / 16; ++kk) {
    wmma::fragment<wmma::matrix_a, 16, 16, 16, FragT, wmma::row_major> a[4];
    wmma::fragment<wmma::matrix_b, 16, 16, 16, FragT, BLayout> b[2];
#pragma unroll
    for (int i = 0; i < 4; ++i)
      wmma::load_matrix_sync(a[i], reinterpret_cast<const FragT*>(&As[kk][wm * 64 + i * 16][0]), 16);
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const T* bj = kTransB ? &Bt[kk][(wn * 2 + j) * 16][0] : &Bs[wn * 2 + j][kk * 16][0];
      wmma::load_matrix_sync(b[j], reinterpret_cast<const FragT*>(bj), 16);
    }
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 2; ++j) wmma::mma_sync(acc[i][j], a[i], b[j], acc[i][j]);
  }
}

// Block tile 128x128, k-step 32; 8 warps as 2 (rows) x 4 (cols), each warp
// 64x32 = 4x2 fragments. Shared tiles are stored as 16-wide planes
// (As[k/16][m][16], Bs[n/16][k][16]) so every fragment pointer is 256-bit
// aligned and every global load is one 16-byte vector. Requires N % 128 == 0
// and K % 32 == 0; rows past M are zero-filled and never stored.
// kTransB: B is stored (N, K) row-major and the product is A @ B^T (the
// backward's dy @ W^T against a weight kept (in, out)); its tile is kept as
// A's is, [k/16][n][16], and read through col_major fragments (ldm 16), so no
// transposed copy of the weight is made and every fragment pointer stays
// 256-bit aligned for int8 too.
// blockIdx.z takes the depth range [z*ksplit, (z+1)*ksplit) (split depth: the
// epilogue sees one range's partial product and may read blockIdx.z).
template <typename T, typename Epi, bool kTransB = false>
__global__ void __launch_bounds__(kGemmThreads)
gemm_kernel(const T* __restrict__ A, const T* __restrict__ B, int M, int N, int K, int ksplit,
            Epi epi) {
  using namespace nvcuda;
  using Acc = typename GemmTypes<T>::acc;
  constexpr int kVec = 16 / sizeof(T);
  __shared__ __align__(128) T As[kBK / 16][kBM][16];
  __shared__ __align__(128) T Bs[kBN / 16][kBK][16];
  __shared__ __align__(128) Acc Cs[kGemmThreads / 32][16 * 16];

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int wm = warp >> 2, wn = warp & 3;
  const int m0 = blockIdx.y * kBM, n0 = blockIdx.x * kBN;
  const int kb = blockIdx.z * ksplit, ke = min(K, kb + ksplit);
  T (*const Bt)[kBN][16] = reinterpret_cast<T (*)[kBN][16]>(&Bs[0][0][0]);  // kTransB view

  GemmAcc<T> acc[4][2];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j) wmma::fill_fragment(acc[i][j], static_cast<Acc>(0));

  for (int k0 = kb; k0 < ke; k0 += kBK) {
    for (int c = tid; c < kBM * kBK / kVec; c += kGemmThreads) {
      const int r = c / (kBK / kVec), kc = (c % (kBK / kVec)) * kVec;
      uint4 v = make_uint4(0u, 0u, 0u, 0u);
      if (m0 + r < M)
        v = *reinterpret_cast<const uint4*>(A + static_cast<size_t>(m0 + r) * K + k0 + kc);
      *reinterpret_cast<uint4*>(&As[kc / 16][r][kc % 16]) = v;
    }
    if constexpr (kTransB) {
      for (int c = tid; c < kBN * kBK / kVec; c += kGemmThreads) {
        const int nr = c / (kBK / kVec), kc = (c % (kBK / kVec)) * kVec;
        *reinterpret_cast<uint4*>(&Bt[kc / 16][nr][kc % 16]) =
            *reinterpret_cast<const uint4*>(B + static_cast<size_t>(n0 + nr) * K + k0 + kc);
      }
    } else {
      load_b_tile(Bs, B, N, n0, k0, tid);
    }
    __syncthreads();
    mma_ktile<T, kTransB>(As, Bs, acc, wm, wn);
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      wmma::store_matrix_sync(Cs[warp], acc[i][j], 16, wmma::mem_row_major);
      __syncwarp();
      for (int e = lane; e < 256; e += 32) {
        const int r = m0 + wm * 64 + i * 16 + (e >> 4);
        const int n = n0 + wn * 32 + j * 16 + (e & 15);
        if (r < M) epi(r, n, Cs[warp][e]);
      }
      __syncwarp();
    }
  }
}

// ksplit: the depth of one split (a multiple of kBK), 0 for the whole K.
template <bool kTransB = false, typename T, typename Epi>
cudaError_t launch_gemm(const T* A, const T* B, int M, int N, int K, Epi epi, cudaStream_t st,
                        int ksplit = 0) {
  if (ksplit <= 0) ksplit = K;
  const dim3 grid(N / kBN, (M + kBM - 1) / kBM, (K + ksplit - 1) / ksplit);
  gemm_kernel<T, Epi, kTransB><<<grid, kGemmThreads, 0, st>>>(A, B, M, N, K, ksplit, epi);
  return cudaGetLastError();
}

// ld: x's row stride, 0 for W.
template <bool kLN, typename TIn>
cudaError_t launch_rowquant(const TIn* x, const float* ln_s, const float* ln_b, int8_t* q,
                            float* qscale, int rows, int W, float eps, cudaStream_t st,
                            int ld = 0) {
  rowquant_kernel<kLN, TIn><<<rows, kRowThreads, W * sizeof(float), st>>>(
      x, ln_s, ln_b, q, qscale, W, eps, ld > 0 ? ld : W);
  return cudaGetLastError();
}

inline cudaError_t launch_ln_rows(const bf16* x, const float* ln_s, const float* ln_b, bf16* out,
                                  int rows, int W, float eps, cudaStream_t st) {
  ln_rows_kernel<<<rows, kRowThreads, W * sizeof(float), st>>>(x, ln_s, ln_b, out, W, eps);
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// Epilogues shared by several kernels
// ---------------------------------------------------------------------------

constexpr float kGeluC = static_cast<float>(-1.702 * 1.4426950408889634);

// quick_gelu via exp2: y * 1/(1 + 2^(-1.702 log2(e) y)), in fp32.
__device__ __forceinline__ float gelu_exp2(float y) {
  return y * (1.0f / (1.0f + exp2f(kGeluC * y)));
}

struct EpiOutProj {  // out = bf16(x + (acc + b)): bias, then the fp32 residual
  const float* b;
  const bf16* x;
  bf16* out;
  int n_cols;
  __device__ void operator()(int r, int n, float acc) const {
    const size_t i = static_cast<size_t>(r) * n_cols + n;
    const float v = acc + b[n];
    out[i] = __float2bfloat16_rn(__bfloat162float(x[i]) + v);
  }
};

// The same epilogue for the MLP's second product; a type of its own so that
// a profile tells the two GEMMs apart by name.
struct EpiMlpOut : EpiOutProj {};

struct EpiBiasQKV {  // row 5's QKV product: qkv = bf16(acc + bqkv)
  const float* b;
  bf16* out;
  int n_cols;
  __device__ void operator()(int r, int n, float acc) const {
    out[static_cast<size_t>(r) * n_cols + n] = __float2bfloat16_rn(acc + b[n]);
  }
};

struct EpiBiasGelu {  // row 10's c_fc: y = bf16(gelu_exp2(acc + b1)), fp32 through the gelu
  const float* b;
  bf16* y;
  int n_cols;
  __device__ void operator()(int r, int n, float acc) const {
    y[static_cast<size_t>(r) * n_cols + n] = __float2bfloat16_rn(gelu_exp2(acc + b[n]));
  }
};

// ---------------------------------------------------------------------------
// Attention core on the packed (B, S, 3W) projection
// ---------------------------------------------------------------------------

constexpr int kHeadDim = 64;
constexpr int kCoreThreads = 128;
constexpr float kExp2Clamp = static_cast<float>(70.0 * 1.4426950408889634);
constexpr int kMaxDynamicSmem = 232448;  // 227 KB a block may opt into on sm_90

template <typename T> __device__ __forceinline__ float round_as(float v);
template <> __device__ __forceinline__ float round_as<bf16>(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}
template <> __device__ __forceinline__ float round_as<float>(float v) { return v; }

template <typename T> __device__ __forceinline__ float2 load2(const T* p);
template <> __device__ __forceinline__ float2 load2<bf16>(const bf16* p) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
}
template <> __device__ __forceinline__ float2 load2<float>(const float* p) {
  return *reinterpret_cast<const float2*>(p);
}

template <typename T> __device__ __forceinline__ void store2(T* p, float a, float b);
template <> __device__ __forceinline__ void store2<bf16>(bf16* p, float a, float b) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
}
template <> __device__ __forceinline__ void store2<float>(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}

// Where a core finds q, k and v: one (B, S, 3W) projection with columns
// [Q | K | V] (kPacked) or [q_h | k_h | v_h] per head (kHeadMajor, the
// tensor-core core's only), or three separate (B, S, W) arrays, W = H*D, head
// h at columns h*D (kSeparate, both cores).
enum class QKVLayout { kPacked, kHeadMajor, kSeparate };

// Grid (query tiles, H, B), one thread per query row; head h = y of image z.
// Columns of head h: q, k, v at h*D, W + h*D, 2W + h*D of one row of 3W
// (kPacked; the projection is passed as q, k and v), or at h*D of a row of W
// in q, k and v (kSeparate). The output is the head concat, h*D of a row of
// W. Scores s = (T(q*c) . k) in fp32 with c = T(scale*log2 e) (the caller rounds c);
// s += mask*log2 e; p = exp2(min(s, 70 log2 e)); l += p; o += T(p) * v;
// out = T(o * (1 / max(l, 1e-38))). A -inf mask entry gives p = 0. The
// no-max softmax needs no running-max rescale, so one streaming pass over the
// keys is exact. The layout only moves the columns: every head runs the
// same arithmetic. Dynamic shared memory: K and V of the head, 2*S*D of T.
template <typename T, int D, QKVLayout L>
__global__ void __launch_bounds__(kCoreThreads)
attn_core_kernel(const T* __restrict__ qsrc, const T* __restrict__ ksrc,
                 const T* __restrict__ vsrc, const float* __restrict__ mask,
                 T* __restrict__ out, int S, int W, float qconst) {
  static_assert(L != QKVLayout::kHeadMajor, "the head-major layout runs on attn_core_mma.cuh");
  extern __shared__ __align__(16) unsigned char smem_raw[];
  constexpr int kVec = 16 / sizeof(T);
  T* ks = reinterpret_cast<T*>(smem_raw);
  T* vs = ks + static_cast<size_t>(S) * D;
  const int h = blockIdx.y;
  const size_t row0 = static_cast<size_t>(blockIdx.z) * S;
  const size_t ld = L == QKVLayout::kSeparate ? static_cast<size_t>(W) : 3 * static_cast<size_t>(W);
  const int qo = h * D;
  const int ko = L == QKVLayout::kPacked ? qo + W : qo;
  const int vo = L == QKVLayout::kPacked ? qo + 2 * W : qo;

  for (int idx = threadIdx.x; idx < S * (D / kVec); idx += kCoreThreads) {
    const int s = idx / (D / kVec), d = (idx % (D / kVec)) * kVec;
    const size_t at = (row0 + s) * ld + d;
    *reinterpret_cast<uint4*>(ks + s * D + d) = *reinterpret_cast<const uint4*>(ksrc + at + ko);
    *reinterpret_cast<uint4*>(vs + s * D + d) = *reinterpret_cast<const uint4*>(vsrc + at + vo);
  }
  __syncthreads();

  const int qi = blockIdx.x * kCoreThreads + threadIdx.x;
  if (qi >= S) return;

  float q[D], o[D];
  const T* qrow = qsrc + (row0 + qi) * ld + qo;
#pragma unroll
  for (int d = 0; d < D; d += 2) {
    const float2 v = load2<T>(qrow + d);
    q[d] = round_as<T>(v.x * qconst);
    q[d + 1] = round_as<T>(v.y * qconst);
    o[d] = 0.f;
    o[d + 1] = 0.f;
  }
  float l = 0.f;
  const float* mrow = mask ? mask + static_cast<size_t>(qi) * S : nullptr;

  for (int k = 0; k < S; ++k) {
    const T* kr = ks + k * D;
    float s = 0.f;
#pragma unroll
    for (int d = 0; d < D; d += 2) {
      const float2 kv = load2<T>(kr + d);
      s = fmaf(q[d], kv.x, s);
      s = fmaf(q[d + 1], kv.y, s);
    }
    if (mrow) s = s + mrow[k] * kLog2e;
    const float p = exp2f(fminf(s, kExp2Clamp));
    l += p;
    const float pb = round_as<T>(p);
    const T* vr = vs + k * D;
#pragma unroll
    for (int d = 0; d < D; d += 2) {
      const float2 vv = load2<T>(vr + d);
      o[d] = fmaf(pb, vv.x, o[d]);
      o[d + 1] = fmaf(pb, vv.y, o[d + 1]);
    }
  }

  const float inv = 1.0f / fmaxf(l, 1e-38f);
  T* dst = out + (row0 + qi) * W + h * D;
#pragma unroll
  for (int d = 0; d < D; d += 2) store2<T>(dst + d, o[d] * inv, o[d + 1] * inv);
}

// qkv (B*S, 3W) packed [Q | K | V] -> out (B*S, W); mask (S, S) fp32 or null.
// Needs W == H*64 and K/V of one head within the shared memory a block may use.
template <typename T>
cudaError_t launch_attn_core(const T* qkv, const float* mask, T* out, int B, int S, int W,
                             int H, float qconst, cudaStream_t st) {
  constexpr QKVLayout L = QKVLayout::kPacked;
  const int smem = 2 * S * kHeadDim * static_cast<int>(sizeof(T));
  if (W != H * kHeadDim || smem > kMaxDynamicSmem) return cudaErrorInvalidValue;
  AIIC_CHECK(cudaFuncSetAttribute(attn_core_kernel<T, kHeadDim, L>,
                                  cudaFuncAttributeMaxDynamicSharedMemorySize, smem));
  const dim3 grid((S + kCoreThreads - 1) / kCoreThreads, H, B);
  attn_core_kernel<T, kHeadDim, L><<<grid, kCoreThreads, smem, st>>>(qkv, qkv, qkv, mask, out, S,
                                                                     W, qconst);
  return cudaGetLastError();
}

// q, k, v, out (B*S, H*D) each, mask (S, S) fp32 or null. Needs K/V of one
// head within the shared memory a block may use.
template <typename T, int D>
cudaError_t launch_attn_core_bshd(const T* q, const T* k, const T* v, const float* mask, T* out,
                                  int B, int S, int H, float qconst, cudaStream_t st) {
  const int smem = 2 * S * D * static_cast<int>(sizeof(T));
  if (B <= 0 || S <= 0 || H <= 0 || smem > kMaxDynamicSmem) return cudaErrorInvalidValue;
  AIIC_CHECK(cudaFuncSetAttribute(attn_core_kernel<T, D, QKVLayout::kSeparate>,
                                  cudaFuncAttributeMaxDynamicSharedMemorySize, smem));
  const dim3 grid((S + kCoreThreads - 1) / kCoreThreads, H, B);
  attn_core_kernel<T, D, QKVLayout::kSeparate><<<grid, kCoreThreads, smem, st>>>(
      q, k, v, mask, out, S, H * D, qconst);
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// Attention-core backward, one block per (head, image), one thread per row
// ---------------------------------------------------------------------------

constexpr int kBlockCoreThreads = 128;  // one thread per query row: S <= 128

template <typename T> __device__ __forceinline__ void store_as(T* p, float v);
template <> __device__ __forceinline__ void store_as<float>(float* p, float v) { *p = v; }
template <> __device__ __forceinline__ void store_as<bf16>(bf16* p, float v) {
  *p = __float2bfloat16_rn(v);
}

// Row i of the normalized probabilities into prow: s_j = q . k_j (q already
// scaled and rounded), + mask*log2 e, p = exp2(min(s, 70 log2 e)),
// p *= 1 / max(sum p, 1e-38).
__device__ __forceinline__ void probs_row(const float* q, const float* Ks, const float* mrow,
                                          float* prow, int S) {
  float l = 0.f;
  for (int j = 0; j < S; ++j) {
    const float* kr = Ks + j * kHeadDim;
    float s = 0.f;
#pragma unroll
    for (int d = 0; d < kHeadDim; ++d) s = fmaf(q[d], kr[d], s);
    s = s + mrow[j] * kLog2e;
    const float p = exp2f(fminf(s, kExp2Clamp));
    prow[j] = p;
    l += p;
  }
  const float inv = 1.0f / fmaxf(l, 1e-38f);
  for (int j = 0; j < S; ++j) prow[j] = prow[j] * inv;
}

// dqkv = TO([dq | dk | dv]) of one head from qkv and g = da, the
// probabilities recomputed as in the forward:
//   dv = T(p)^T g;  dp = g v^T;  ds = T((p (dp - rowsum(dp p))) scale);
//   dq = ds k;  dk = ds^T q.
// TO is T where dqkv only feeds a product that rounds it to T, fp32 where it
// feeds a row quantizer (the int8 block).
// Dynamic shared memory: Q, K, V, G (S x 64) and P (S x S, then ds), fp32.
template <typename T, typename TO>
__global__ void __launch_bounds__(kBlockCoreThreads)
block_core_bwd_kernel(const T* __restrict__ qkv, const T* __restrict__ da,
                      const float* __restrict__ mask, TO* __restrict__ dqkv, int S, int W,
                      float qconst, float scale) {
  extern __shared__ float sm[];
  float* Qs = sm;
  float* Ks = Qs + S * kHeadDim;
  float* Vs = Ks + S * kHeadDim;
  float* Gs = Vs + S * kHeadDim;
  float* P = Gs + S * kHeadDim;
  const int h = blockIdx.x;
  const size_t row0 = static_cast<size_t>(blockIdx.y) * S, ld = 3 * static_cast<size_t>(W);
  for (int idx = threadIdx.x; idx < S * kHeadDim; idx += kBlockCoreThreads) {
    const size_t r = row0 + idx / kHeadDim;
    const int c = h * kHeadDim + idx % kHeadDim;
    const T* src = qkv + r * ld + c;
    Qs[idx] = to_f32(src[0]);
    Ks[idx] = to_f32(src[W]);
    Vs[idx] = to_f32(src[2 * W]);
    Gs[idx] = to_f32(da[r * W + c]);
  }
  __syncthreads();
  const int i = threadIdx.x;
  const bool live = i < S;
  float acc[kHeadDim];
  if (live) {
#pragma unroll
    for (int d = 0; d < kHeadDim; ++d) acc[d] = round_as<T>(Qs[i * kHeadDim + d] * qconst);
    probs_row(acc, Ks, mask + static_cast<size_t>(i) * S, P + i * S, S);
  }
  __syncthreads();
  TO* out = dqkv + (row0 + i) * ld + h * kHeadDim;
  if (live) {  // dv for key row i
#pragma unroll
    for (int d = 0; d < kHeadDim; ++d) acc[d] = 0.f;
    for (int r = 0; r < S; ++r) {
      const float pr = round_as<T>(P[r * S + i]);
      const float* gr = Gs + r * kHeadDim;
#pragma unroll
      for (int d = 0; d < kHeadDim; ++d) acc[d] = fmaf(pr, gr[d], acc[d]);
    }
#pragma unroll
    for (int d = 0; d < kHeadDim; ++d) store_as<TO>(out + 2 * W + d, acc[d]);
  }
  __syncthreads();  // every column of P is read; row i may now become ds
  if (live) {
    // g row i into registers: read from shared memory in the loops below,
    // the 64-float row stride would put all 32 lanes on one bank.
#pragma unroll
    for (int d = 0; d < kHeadDim; ++d) acc[d] = Gs[i * kHeadDim + d];
    float* prow = P + i * S;
    float rs = 0.f;
    for (int j = 0; j < S; ++j) {
      const float* vr = Vs + j * kHeadDim;
      float dp = 0.f;
#pragma unroll
      for (int d = 0; d < kHeadDim; ++d) dp = fmaf(acc[d], vr[d], dp);
      rs += dp * prow[j];
    }
    for (int j = 0; j < S; ++j) {  // dp again, in the same order
      const float* vr = Vs + j * kHeadDim;
      float dp = 0.f;
#pragma unroll
      for (int d = 0; d < kHeadDim; ++d) dp = fmaf(acc[d], vr[d], dp);
      prow[j] = round_as<T>((prow[j] * (dp - rs)) * scale);
    }
  }
  __syncthreads();
  if (!live) return;
#pragma unroll
  for (int d = 0; d < kHeadDim; ++d) acc[d] = 0.f;
  for (int j = 0; j < S; ++j) {  // dq = ds k
    const float ds = P[i * S + j];
    const float* kr = Ks + j * kHeadDim;
#pragma unroll
    for (int d = 0; d < kHeadDim; ++d) acc[d] = fmaf(ds, kr[d], acc[d]);
  }
#pragma unroll
  for (int d = 0; d < kHeadDim; ++d) store_as<TO>(out + d, acc[d]);
#pragma unroll
  for (int d = 0; d < kHeadDim; ++d) acc[d] = 0.f;
  for (int r = 0; r < S; ++r) {  // dk = ds^T q
    const float ds = P[r * S + i];
    const float* qr = Qs + r * kHeadDim;
#pragma unroll
    for (int d = 0; d < kHeadDim; ++d) acc[d] = fmaf(ds, qr[d], acc[d]);
  }
#pragma unroll
  for (int d = 0; d < kHeadDim; ++d) store_as<TO>(out + W + d, acc[d]);
}

// Needs 0 < S <= kBlockCoreThreads, W == H*64 and the (4 S 64 + S^2) fp32
// of shared memory within what a block may use (S <= 128 always is: 196,608
// B at S=128).
template <typename T, typename TO>
cudaError_t launch_core_bwd(const T* qkv, const T* da, const float* mask, TO* dqkv, int B, int S,
                            int W, int H, float qconst, cudaStream_t st) {
  const int smem = (4 * S * kHeadDim + S * S) * static_cast<int>(sizeof(float));
  if (S <= 0 || S > kBlockCoreThreads || W != H * kHeadDim || smem > kMaxDynamicSmem)
    return cudaErrorInvalidValue;
  AIIC_CHECK(cudaFuncSetAttribute(block_core_bwd_kernel<T, TO>,
                                  cudaFuncAttributeMaxDynamicSharedMemorySize, smem));
  const float scale = 1.0f / sqrtf(static_cast<float>(kHeadDim));  // dim ** -0.5, exact for 64
  block_core_bwd_kernel<T, TO><<<dim3(H, B), kBlockCoreThreads, smem, st>>>(
      qkv, da, mask, dqkv, S, W, qconst, scale);
  return cudaGetLastError();
}

}  // namespace
}  // namespace aiic
