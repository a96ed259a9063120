// int8 MLP half-block for Hopper:
//   out = x + deq(int8 c_proj(rowquant(gelu_exp2(deq(int8 c_fc(rowquant(LN2 x)))))))
//
// Replaces the TPU kernel aiic_tpu/ops/quant.py::_int8_mlp_kernel_3d (the
// full, unchunked mode of int8_ln_mlp; its math is _int8_mlp_rows with
// n_chunks=1). The plain PyTorch version is
// aiic_tpu_torch/ops/quant.py::int8_ln_mlp_ref.
//
// Four launches on the caller's stream:
//   (a) rowquant_kernel<LN>: LN2 in fp32 + per-row int8 quantization;
//   (b) gemm_kernel<int8_t>: hq @ w1_q, epilogue y = acc*hscale*s1 + b1,
//       then y * 1/(1 + exp2(-1.702 log2(e) y)), stored fp32 (rows, 4W);
//   (c) rowquant_kernel<no LN>: per-row quantization of y over the full
//       hidden width;
//   (d) gemm_kernel<int8_t>: yq @ w2_q, epilogue acc*yscale*s2, then + b2,
//       then + x, then bf16 (the order of _int8_mlp_rows).
//
// What bounds it on the H100: at B=256 the two int8 products are
// 2 * 50k rows x 768 x 3072 MACs, compute-bound on the int8 tensor cores;
// the two row passes are bandwidth-bound.
//
// What the simple design gives up: the fp32 hidden activation (rows x 4W,
// 620 MB at B=256) makes a round trip through device memory because the
// row quantization of y needs the whole row's amax before the second
// product can start; the GEMM has no TMA/wgmma pipeline.

#include "common.cuh"

namespace aiic {
namespace {

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

}  // namespace
}  // namespace aiic

// x (rows,W) bf16; ln_s, ln_b (W) f32; w1_q (W,M) int8; s1, b1 (M) f32;
// w2_q (M,W) int8; s2, b2 (W) f32; out (rows,W) bf16. Scratch: hq (rows,W)
// int8, hs (rows) f32, y (rows,M) f32, yq (rows,M) int8, ys (rows) f32.
// Needs W and M multiples of 128. Returns a cudaError_t.
extern "C" int aiic_int8_ln_mlp(
    const void* x, const void* ln_s, const void* ln_b, const void* w1_q,
    const void* s1, const void* b1, const void* w2_q, const void* s2,
    const void* b2, void* out, void* hq, void* hs, void* y, void* yq, void* ys,
    int rows, int W, int M, float eps, void* stream) {
  using namespace aiic;
  if (W % kBN != 0 || M % kBN != 0) return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const bf16* xb = static_cast<const bf16*>(x);
  auto f = [](const void* p) { return static_cast<const float*>(p); };

  AIIC_CHECK((launch_rowquant<true, bf16>(xb, f(ln_s), f(ln_b), static_cast<int8_t*>(hq),
                                          static_cast<float*>(hs), rows, W, eps, st)));
  AIIC_CHECK(launch_gemm(static_cast<const int8_t*>(hq), static_cast<const int8_t*>(w1_q),
                         rows, M, W,
                         EpiGelu{f(hs), f(s1), f(b1), static_cast<float*>(y), M}, st));
  AIIC_CHECK((launch_rowquant<false, float>(static_cast<const float*>(y), nullptr, nullptr,
                                            static_cast<int8_t*>(yq), static_cast<float*>(ys),
                                            rows, M, 0.f, st)));
  AIIC_CHECK(launch_gemm(static_cast<const int8_t*>(yq), static_cast<const int8_t*>(w2_q),
                         rows, W, M,
                         EpiResidual{f(ys), f(s2), f(b2), xb, static_cast<bf16*>(out), W}, st));
  return 0;
}
