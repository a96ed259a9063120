// Shared building blocks of the int8 half-block kernels (sm_90a).
//
// - rowquant_kernel: one block per row; optional LayerNorm with fp32
//   statistics, then symmetric per-row int8 quantization (amax/127 with a
//   1e-6 floor, true division, round half to even, clamp to +-127). The LN
//   result stays fp32 into the quantizer, as in the JAX kernels.
// - gemm_kernel: a tiled tensor-core product C = A @ B for A (M, K) and
//   B (K, N), both row-major, through WMMA 16x16x16 fragments (int8 -> int32
//   or bf16 -> fp32). B is the weight in the port's (in, out) layout, read
//   directly as a row-major matrix_b, so no transposed copy is kept. The
//   fp32/int32 tile goes through shared memory to a per-element epilogue
//   functor that does the dequant, bias, activation or residual.
//
// Built with -fmad=false so the epilogues' a*b+c round twice, as the plain
// PyTorch versions do; the products themselves use the tensor cores or
// explicit fmaf.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

namespace aiic {
namespace {

using bf16 = __nv_bfloat16;
constexpr float kLog2e = 1.4426950408889634f;

// ---------------------------------------------------------------------------
// Row pass: [LayerNorm] + per-row int8 quantization
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

// x (rows, W) -> q (rows, W) int8 and qscale (rows,). Dynamic shared memory:
// W floats (the row, normalized in place). Each thread touches only its own
// strided elements of the row, so the block reductions are the only syncs.
template <bool kLN, typename TIn>
__global__ void __launch_bounds__(kRowThreads)
rowquant_kernel(const TIn* __restrict__ x, const float* __restrict__ ln_s,
                const float* __restrict__ ln_b, int8_t* __restrict__ q,
                float* __restrict__ qscale, int W, float eps) {
  extern __shared__ float h[];
  __shared__ float red[kRowThreads / 32 + 1];
  const size_t row = blockIdx.x;
  const TIn* xr = x + row * W;

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
  float amax = 0.f;
  for (int i = threadIdx.x; i < W; i += kRowThreads) amax = fmaxf(amax, fabsf(h[i]));
  amax = block_reduce(amax, true, red);
  const float scale = fmaxf(amax, 1e-6f) / 127.0f;
  int8_t* qr = q + row * W;
  for (int i = threadIdx.x; i < W; i += kRowThreads) {
    const float v = fminf(fmaxf(rintf(h[i] / scale), -127.f), 127.f);
    qr[i] = static_cast<int8_t>(v);
  }
  if (threadIdx.x == 0) qscale[row] = scale;
}

// ---------------------------------------------------------------------------
// Tensor-core GEMM with a per-element epilogue
// ---------------------------------------------------------------------------

constexpr int kBM = 128, kBN = 128, kBK = 32, kGemmThreads = 256;

template <typename T> struct GemmTypes;
template <> struct GemmTypes<int8_t> { using frag = signed char; using acc = int; };
template <> struct GemmTypes<bf16> { using frag = __nv_bfloat16; using acc = float; };

// Block tile 128x128, k-step 32; 8 warps as 2 (rows) x 4 (cols), each warp
// 64x32 = 4x2 fragments. Shared tiles are stored as 16-wide planes
// (As[k/16][m][16], Bs[n/16][k][16]) so every fragment pointer is 256-bit
// aligned and every global load is one 16-byte vector. Requires N % 128 == 0
// and K % 32 == 0; rows past M are zero-filled and never stored.
template <typename T, typename Epi>
__global__ void __launch_bounds__(kGemmThreads)
gemm_kernel(const T* __restrict__ A, const T* __restrict__ B, int M, int N, int K, Epi epi) {
  using namespace nvcuda;
  using FragT = typename GemmTypes<T>::frag;
  using Acc = typename GemmTypes<T>::acc;
  constexpr int kVec = 16 / sizeof(T);
  __shared__ __align__(128) T As[kBK / 16][kBM][16];
  __shared__ __align__(128) T Bs[kBN / 16][kBK][16];
  __shared__ __align__(128) Acc Cs[kGemmThreads / 32][16 * 16];

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int wm = warp >> 2, wn = warp & 3;
  const int m0 = blockIdx.y * kBM, n0 = blockIdx.x * kBN;

  wmma::fragment<wmma::accumulator, 16, 16, 16, Acc> acc[4][2];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j) wmma::fill_fragment(acc[i][j], static_cast<Acc>(0));

  for (int k0 = 0; k0 < K; k0 += kBK) {
    for (int c = tid; c < kBM * kBK / kVec; c += kGemmThreads) {
      const int r = c / (kBK / kVec), kc = (c % (kBK / kVec)) * kVec;
      uint4 v = make_uint4(0u, 0u, 0u, 0u);
      if (m0 + r < M)
        v = *reinterpret_cast<const uint4*>(A + static_cast<size_t>(m0 + r) * K + k0 + kc);
      *reinterpret_cast<uint4*>(&As[kc / 16][r][kc % 16]) = v;
    }
    for (int c = tid; c < kBK * kBN / kVec; c += kGemmThreads) {
      const int kr = c / (kBN / kVec), nc = (c % (kBN / kVec)) * kVec;
      *reinterpret_cast<uint4*>(&Bs[nc / 16][kr][nc % 16]) =
          *reinterpret_cast<const uint4*>(B + static_cast<size_t>(k0 + kr) * N + n0 + nc);
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < kBK / 16; ++kk) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, FragT, wmma::row_major> a[4];
      wmma::fragment<wmma::matrix_b, 16, 16, 16, FragT, wmma::row_major> b[2];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        wmma::load_matrix_sync(a[i], reinterpret_cast<const FragT*>(&As[kk][wm * 64 + i * 16][0]), 16);
#pragma unroll
      for (int j = 0; j < 2; ++j)
        wmma::load_matrix_sync(b[j], reinterpret_cast<const FragT*>(&Bs[wn * 2 + j][kk * 16][0]), 16);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 2; ++j) wmma::mma_sync(acc[i][j], a[i], b[j], acc[i][j]);
    }
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

template <typename T, typename Epi>
cudaError_t launch_gemm(const T* A, const T* B, int M, int N, int K, Epi epi, cudaStream_t st) {
  const dim3 grid(N / kBN, (M + kBM - 1) / kBM);
  gemm_kernel<T, Epi><<<grid, kGemmThreads, 0, st>>>(A, B, M, N, K, epi);
  return cudaGetLastError();
}

template <bool kLN, typename TIn>
cudaError_t launch_rowquant(const TIn* x, const float* ln_s, const float* ln_b, int8_t* q,
                            float* qscale, int rows, int W, float eps, cudaStream_t st) {
  rowquant_kernel<kLN, TIn><<<rows, kRowThreads, W * sizeof(float), st>>>(
      x, ln_s, ln_b, q, qscale, W, eps);
  return cudaGetLastError();
}

}  // namespace
}  // namespace aiic

#define AIIC_CHECK(expr)                       \
  do {                                         \
    const cudaError_t aiic_err_ = (expr);      \
    if (aiic_err_ != cudaSuccess) return static_cast<int>(aiic_err_); \
  } while (0)
