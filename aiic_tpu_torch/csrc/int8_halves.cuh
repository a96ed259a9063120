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

// The gelu of the MLP half: the exp2 gelu of rows 2-4 (kExp2); the
// kernel-experiment variants' y * sigmoid(1.702 y), the same rounded to bf16
// op by op, or none.
enum class Gelu { kNone, kSigmoid, kExp2, kBf16 };

template <Gelu G>
__device__ __forceinline__ float gelu_var(float y) {
  if constexpr (G == Gelu::kSigmoid) {  // y * sigmoid(1.702 y), sigmoid = 1/(1 + exp(-z))
    const float z = 1.702f * y;
    return y * (1.0f / (1.0f + expf(-z)));
  } else if constexpr (G == Gelu::kExp2) {
    return gelu_exp2(y);
  } else if constexpr (G == Gelu::kBf16) {
    // Every op rounded to bf16; jnp.exp2 of a bf16 t is exp(bf16(t * bf16(ln 2))).
    const float yb = round_as<bf16>(y);
    const float t = round_as<bf16>(round_as<bf16>(kGeluC) * yb);
    const float p = round_as<bf16>(expf(round_as<bf16>(t * round_as<bf16>(0.6931471805599453f))));
    const float r = round_as<bf16>(1.0f / round_as<bf16>(1.0f + p));
    return round_as<bf16>(yb * r);
  } else {
    return y;
  }
}

template <Gelu G = Gelu::kExp2>
struct EpiGelu {  // y = gelu(acc * hscale * s1 + b1), fp32
  const float* hs;
  const float* s;
  const float* b;
  float* y;
  int n_cols;
  __device__ void operator()(int r, int n, int acc) const {
    const float v = static_cast<float>(acc) * hs[r] * s[n] + b[n];
    y[static_cast<size_t>(r) * n_cols + n] = gelu_var<G>(v);
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

// kLN false: no LN1 (the noln ablation of the kernel experiments).
template <bool kLN = true>
cudaError_t int8_qkv_stage(const bf16* x, const Int8Attn& a, bf16* qkv, int8_t* hq, float* hs,
                           int rows, int W, float eps, cudaStream_t st) {
  if (W % kBN != 0) return cudaErrorInvalidValue;
  AIIC_CHECK((launch_rowquant<kLN, bf16>(x, a.ln_s, a.ln_b, hq, hs, rows, W, eps, st)));
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

// kLN and G: rows 2-4 run LN2 and the exp2 gelu; the kernel-experiment
// variants drop LN2 (noln) or change the gelu (nogelu, sigmoid, bf16).
template <bool kLN = true, Gelu G = Gelu::kExp2>
cudaError_t int8_mlp_half(const bf16* x, const Int8Mlp& m, bf16* out, const MlpScratch& s,
                          int rows, int W, int M, int C, float eps, cudaStream_t st) {
  if (W % kBN != 0 || M % kBN != 0 || C < 1 || M % C != 0 || (M / C) % kBK != 0)
    return cudaErrorInvalidValue;
  AIIC_CHECK((launch_rowquant<kLN, bf16>(x, m.ln_s, m.ln_b, s.hq, s.hs, rows, W, eps, st)));
  AIIC_CHECK(launch_gemm(static_cast<const int8_t*>(s.hq), m.w1, rows, M, W,
                         EpiGelu<G>{s.hs, m.s1, m.b1, s.y, M}, st));
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


// ---------------------------------------------------------------------------
// Stages of the kernel-experiment variants (attn_variants.cu, mlp_variants.cu:
// the twins of tools/kernel_experiments{,2,3,4,5,7}.py). The variants also
// run the sequences above with other template arguments (no LN, another
// gelu); rows 1-4 run them with the defaults and keep their arithmetic.
// ---------------------------------------------------------------------------

// The variants' row quantizers with a scale that is not the row's own (the
// per-row one is rowquant_kernel): a fixed scale c, the row multiplied by
// the fp32 reciprocal 1/c (kStatic); or one scale per tile of tile_rows rows
// (v4's image pair): kTileAmax writes each row's amax, kTileQuant recomputes
// the row, takes its tile's largest amax, scale = max(amax, 1e-6)/127, and
// multiplies by 1/scale.
enum class RowQuant { kStatic, kTileAmax, kTileQuant };

// LN(x) (rows, W) -> q (rows, W) int8 and qscale (rows) (kTileAmax: the
// row's amax into qscale). Dynamic shared memory: W floats.
template <RowQuant Q>
__global__ void __launch_bounds__(kRowThreads)
rowquant_var_kernel(const bf16* __restrict__ x, const float* __restrict__ ln_s,
                    const float* __restrict__ ln_b, int8_t* __restrict__ q,
                    float* __restrict__ qscale, const float* __restrict__ rowamax, int W,
                    float eps, float c, int tile_rows) {
  extern __shared__ float h[];
  __shared__ float red[kRowThreads / 32 + 1];
  const size_t row = blockIdx.x;
  load_row<true>(x + row * W, ln_s, ln_b, h, red, W, eps);
  int8_t* qr = q + row * W;
  if constexpr (Q == RowQuant::kTileAmax) {
    float amax = 0.f;
    for (int i = threadIdx.x; i < W; i += kRowThreads) amax = fmaxf(amax, fabsf(h[i]));
    amax = block_reduce(amax, true, red);
    if (threadIdx.x == 0) qscale[row] = amax;
  } else {
    float scale = c;
    if constexpr (Q == RowQuant::kTileQuant) {
      const size_t t0 = row / tile_rows * tile_rows;
      float amax = 0.f;
      for (int i = threadIdx.x; i < tile_rows; i += kRowThreads) amax = fmaxf(amax, rowamax[t0 + i]);
      scale = fmaxf(block_reduce(amax, true, red), 1e-6f) / 127.0f;
      if (threadIdx.x == 0) qscale[row] = scale;
    }
    const float recip = 1.0f / scale;
    for (int i = threadIdx.x; i < W; i += kRowThreads)
      qr[i] = static_cast<int8_t>(fminf(fmaxf(rintf(h[i] * recip), -127.f), 127.f));
  }
}

template <RowQuant Q>
cudaError_t launch_rowquant_var(const bf16* x, const float* ln_s, const float* ln_b, int8_t* q,
                                float* qscale, const float* rowamax, int rows, int W, float eps,
                                cudaStream_t st, float c = 0.f, int tile_rows = 0) {
  rowquant_var_kernel<Q><<<rows, kRowThreads, W * sizeof(float), st>>>(
      x, ln_s, ln_b, q, qscale, rowamax, W, eps, c, tile_rows);
  return cudaGetLastError();
}

// The maconly ablations' constant int8 operand.
__global__ void fill_int8_kernel(int8_t* __restrict__ p, size_t n, int8_t v) {
  const size_t i = static_cast<size_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i < n) p[i] = v;
}

inline cudaError_t fill_int8(int8_t* p, size_t n, int8_t v, cudaStream_t st) {
  fill_int8_kernel<<<static_cast<unsigned>((n + 255) / 256), 256, 0, st>>>(p, n, v);
  return cudaGetLastError();
}

struct EpiQKVTile {  // v4: qkv = bf16(acc * (hscale * sqkv) + bqkv), hscale per tile
  const float* hs;
  const float* s;
  const float* b;
  bf16* out;
  int n_cols;
  __device__ void operator()(int r, int n, int acc) const {
    const float v = static_cast<float>(acc) * (hs[r] * s[n]) + b[n];
    out[static_cast<size_t>(r) * n_cols + n] = __float2bfloat16_rn(v);
  }
};

struct EpiClip8 {  // maconly: out = int8(clip(acc, +-127)) for the first n_keep columns
  int8_t* out;
  int n_keep;
  __device__ void operator()(int r, int n, int acc) const {
    if (n < n_keep) out[static_cast<size_t>(r) * n_keep + n] = static_cast<int8_t>(min(max(acc, -127), 127));
  }
};

struct EpiAddRaw {  // out = bf16(x + f32(acc)): maconly, macbf16
  const bf16* x;
  bf16* out;
  int n_cols;
  template <typename A>
  __device__ void operator()(int r, int n, A acc) const {
    const size_t i = static_cast<size_t>(r) * n_cols + n;
    out[i] = __float2bfloat16_rn(__bfloat162float(x[i]) + static_cast<float>(acc));
  }
};

struct EpiResidualStatic {  // out = bf16(x + (acc * ys * s2 + b2)), ys one fp32 scale
  float ys;
  const float* s;
  const float* b;
  const bf16* x;
  bf16* out;
  int n_cols;
  __device__ void operator()(int r, int n, int acc) const {
    const size_t i = static_cast<size_t>(r) * n_cols + n;
    const float v = static_cast<float>(acc) * ys * s[n] + b[n];
    out[i] = __float2bfloat16_rn(__bfloat162float(x[i]) + v);
  }
};

enum class YOut { kBf16, kInt8Static };

// The first epilogue of the MLP variants that do not quantize y per row:
// y = acc * hscale * s1 + b1 (int8; hscale per row from hs, or the fixed
// hs_c where hs is null) or acc [+ b1] (bf16; no bias where b is null), then
// the gelu, then y stored in bf16, or quantized with the fixed reciprocal:
// clip(round(y * recip), +-127).
template <Gelu G, YOut O>
struct EpiMlp1 {
  const float* hs;
  float hs_c;
  const float* s;
  const float* b;
  void* y;
  float recip;
  int n_cols;
  __device__ void operator()(int r, int n, int acc) const {
    store(r, n, static_cast<float>(acc) * (hs ? hs[r] : hs_c) * s[n] + b[n]);
  }
  __device__ void operator()(int r, int n, float acc) const { store(r, n, b ? acc + b[n] : acc); }
  __device__ void store(int r, int n, float v) const {
    v = gelu_var<G>(v);
    const size_t i = static_cast<size_t>(r) * n_cols + n;
    if constexpr (O == YOut::kBf16)
      static_cast<bf16*>(y)[i] = __float2bfloat16_rn(v);
    else
      static_cast<int8_t*>(y)[i] = static_cast<int8_t>(fminf(fmaxf(rintf(v * recip), -127.f), 127.f));
  }
};

}  // namespace
}  // namespace aiic
