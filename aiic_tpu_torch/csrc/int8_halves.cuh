// The int8 half-block sequences (sm_90a), shared by the kernels of rows 1-4
// of the TPU kernel table:
//
//   int8_qkv_stage   LN1 -> per-row int8 quantization -> int8 QKV product,
//                    qkv = bf16(acc*hscale*sqkv + bqkv). Alone it is the
//                    projection of the large-S int8 attention path (the JAX
//                    package runs it in XLA around the row 7 / row 8 core);
//   int8_attn_half   the stage, the streaming core, the bf16 out-projection
//                    with bias and residual (row 1, int8_attention.cu);
//   int8_mlp_half    LN2 -> int8 c_fc with gelu -> int8 c_proj, the gelu
//                    output quantized per row (C = 1: row 2) or per (row,
//                    chunk) over C chunks of the hidden axis (row 3), both
//                    in int8_mlp.cu; row 4 (int8_block.cu) runs the two
//                    halves back to back.
//
// The chunked MLP half follows _int8_mlp_rows(n_chunks=C) of the JAX
// package: the gelu output y (rows, M) is quantized as the (rows*C, M/C)
// matrix it is in memory, so each (row, chunk) gets its own amax; c_proj
// splits its depth by chunk across blockIdx.z, each split dequantizing its
// partial with its own row scale, and a second pass sums the partials in
// chunk order onto the fp32 residual and adds b2 last. No atomics: a run
// repeats bit for bit.

#pragma once

#include "common.cuh"

namespace aiic {
namespace {

struct EpiQKV {  // qkv = bf16(acc * hscale * sqkv + bqkv)
  const float* hs;
  const float* s;
  const float* b;
  bf16* out;
  int n_cols;
  __device__ void operator()(int r, int n, int acc) const {
    const float v = static_cast<float>(acc) * hs[r] * s[n] + b[n];
    out[static_cast<size_t>(r) * n_cols + n] = __float2bfloat16_rn(v);
  }
};

struct EpiGelu {  // y = gelu_exp2(acc * hscale * s1 + b1), fp32
  const float* hs;
  const float* s;
  const float* b;
  float* y;
  int n_cols;
  __device__ void operator()(int r, int n, int acc) const {
    const float v = static_cast<float>(acc) * hs[r] * s[n] + b[n];
    y[static_cast<size_t>(r) * n_cols + n] = gelu_exp2(v);
  }
};

struct EpiResidual {  // out = bf16(x + (acc * yscale * s2 + b2))
  const float* ys;
  const float* s;
  const float* b;
  const bf16* x;
  bf16* out;
  int n_cols;
  __device__ void operator()(int r, int n, int acc) const {
    const size_t i = static_cast<size_t>(r) * n_cols + n;
    const float v = static_cast<float>(acc) * ys[r] * s[n] + b[n];
    out[i] = __float2bfloat16_rn(__bfloat162float(x[i]) + v);
  }
};

struct EpiMlpChunk {  // part[c] = acc * yscale[r, c] * s2, chunk c = blockIdx.z
  const float* ys;  // (rows, n_chunks)
  const float* s;
  float* part;      // (n_chunks, rows, n_cols)
  int n_chunks, rows, n_cols;
  __device__ void operator()(int r, int n, int acc) const {
    const int c = blockIdx.z;
    part[(static_cast<size_t>(c) * rows + r) * n_cols + n] =
        static_cast<float>(acc) * ys[static_cast<size_t>(r) * n_chunks + c] * s[n];
  }
};

// out = bf16((((x + part[0]) + part[1]) + ... + part[C-1]) + b2).
__global__ void mlp_chunk_sum_kernel(const bf16* __restrict__ x, const float* __restrict__ part,
                                     const float* __restrict__ b2, bf16* __restrict__ out,
                                     int n_chunks, size_t n, int W) {
  const size_t i = static_cast<size_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= n) return;
  float v = __bfloat162float(x[i]);
  for (int c = 0; c < n_chunks; ++c) v = v + part[static_cast<size_t>(c) * n + i];
  out[i] = __float2bfloat16_rn(v + b2[i % W]);
}

struct Int8Attn {  // one layer's attention-half weights
  const float* ln_s;
  const float* ln_b;
  const int8_t* wqkv;  // (W, 3W)
  const float* sqkv;   // (3W)
  const float* bqkv;   // (3W)
  const bf16* wo;      // (W, W)
  const float* bo;     // (W)
  const float* mask;   // (S, S) or null
};

struct Int8Mlp {  // one layer's MLP-half weights
  const float* ln_s;
  const float* ln_b;
  const int8_t* w1;  // (W, M)
  const float* s1;
  const float* b1;
  const int8_t* w2;  // (M, W)
  const float* s2;
  const float* b2;
};

struct MlpScratch {
  int8_t* hq;   // (rows, W)
  float* hs;    // (rows)
  float* y;     // (rows, M)
  int8_t* yq;   // (rows, M)
  float* ys;    // (rows, C)
  float* part;  // (C, rows, W); unused when C == 1
};

inline cudaError_t int8_qkv_stage(const bf16* x, const Int8Attn& a, bf16* qkv, int8_t* hq,
                                  float* hs, int rows, int W, float eps, cudaStream_t st) {
  if (W % kBN != 0) return cudaErrorInvalidValue;
  AIIC_CHECK((launch_rowquant<true, bf16>(x, a.ln_s, a.ln_b, hq, hs, rows, W, eps, st)));
  return launch_gemm(hq, a.wqkv, rows, 3 * W, W, EpiQKV{hs, a.sqkv, a.bqkv, qkv, 3 * W}, st);
}

inline cudaError_t int8_attn_half(const bf16* x, const Int8Attn& a, bf16* out, int8_t* hq,
                                  float* hs, bf16* qkv, bf16* attn, int B, int S, int W, int H,
                                  float eps, float qconst, cudaStream_t st) {
  if (W % kBN != 0 || W % H != 0 || W / H != kHeadDim) return cudaErrorInvalidValue;
  const int rows = B * S;
  AIIC_CHECK(int8_qkv_stage(x, a, qkv, hq, hs, rows, W, eps, st));
  AIIC_CHECK(launch_attn_core(static_cast<const bf16*>(qkv), a.mask, attn, B, S, W, H, qconst,
                              st));
  return launch_gemm(static_cast<const bf16*>(attn), a.wo, rows, W, W,
                     EpiOutProj{a.bo, x, out, W}, st);
}

inline cudaError_t int8_mlp_half(const bf16* x, const Int8Mlp& m, bf16* out,
                                 const MlpScratch& s, int rows, int W, int M, int C, float eps,
                                 cudaStream_t st) {
  if (W % kBN != 0 || M % kBN != 0 || C < 1 || M % C != 0 || (M / C) % kBK != 0)
    return cudaErrorInvalidValue;
  AIIC_CHECK((launch_rowquant<true, bf16>(x, m.ln_s, m.ln_b, s.hq, s.hs, rows, W, eps, st)));
  AIIC_CHECK(launch_gemm(static_cast<const int8_t*>(s.hq), m.w1, rows, M, W,
                         EpiGelu{s.hs, m.s1, m.b1, s.y, M}, st));
  AIIC_CHECK((launch_rowquant<false, float>(static_cast<const float*>(s.y), nullptr, nullptr,
                                            s.yq, s.ys, rows * C, M / C, 0.f, st)));
  if (C == 1)
    return launch_gemm(static_cast<const int8_t*>(s.yq), m.w2, rows, W, M,
                       EpiResidual{s.ys, m.s2, m.b2, x, out, W}, st);
  AIIC_CHECK(launch_gemm(static_cast<const int8_t*>(s.yq), m.w2, rows, W, M,
                         EpiMlpChunk{s.ys, m.s2, s.part, C, rows, W}, st, M / C));
  const size_t n = static_cast<size_t>(rows) * W;
  mlp_chunk_sum_kernel<<<static_cast<unsigned>((n + 255) / 256), 256, 0, st>>>(
      x, s.part, m.b2, out, C, n, W);
  return cudaGetLastError();
}

}  // namespace
}  // namespace aiic
