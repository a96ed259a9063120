// bf16 LN + MLP half-block for Hopper:
//   out = x + W2 . bf16(quick_gelu(W1 . bf16(LN2 x) + b1)) + b2
//
// Replaces the TPU kernel aiic_tpu/ops/mlp.py::_mlp_kernel (called from
// fused_ln_mlp, attn_impl="pallas_mlp"). The plain PyTorch version is
// aiic_tpu_torch/ops/mlp.py::fused_ln_mlp_ref.
//
// Three launches on the caller's stream:
//   (a) ln_rows_kernel: LN2 in fp32, rounded to bf16;
//   (b) gemm_kernel<bf16>: h @ w1, epilogue y = acc + b1, then the exp2
//       quick_gelu in fp32, stored bf16 (rows, M);
//   (c) gemm_kernel<bf16>: y @ w2, epilogue bf16(x + (acc + b2)).
//
// What bounds it on the H100: the two products, 4*rows*W*M = 476 GFLOP at
// B=256 (0.48 ms at 989 TFLOP/s bf16); everything else is elementwise.
//
// What the simple design gives up: the bf16 hidden activation (rows x 4W,
// 310 MB at B=256) makes a round trip through device memory between the two
// products, and the GEMM has no TMA/wgmma pipeline.

#include "common.cuh"

namespace aiic {
namespace {

struct EpiBiasGelu {  // y = bf16(gelu_exp2(acc + b1))
  const float* b;
  bf16* y;
  int n_cols;
  __device__ void operator()(int r, int n, float acc) const {
    y[static_cast<size_t>(r) * n_cols + n] = __float2bfloat16_rn(gelu_exp2(acc + b[n]));
  }
};

}  // namespace
}  // namespace aiic

// x (rows,W) bf16; ln_s, ln_b (W) f32; w1 (W,M) bf16; b1 (M) f32; w2 (M,W)
// bf16; b2 (W) f32; out (rows,W) bf16. Scratch: h (rows,W), y (rows,M), both
// bf16. Needs W and M multiples of 128. Returns a cudaError_t.
extern "C" int aiic_ln_mlp(const void* x, const void* ln_s, const void* ln_b, const void* w1,
                           const void* b1, const void* w2, const void* b2, void* out, void* h,
                           void* y, int rows, int W, int M, float eps, void* stream) {
  using namespace aiic;
  if (W % kBN != 0 || M % kBN != 0) return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const bf16* xb = static_cast<const bf16*>(x);
  auto f = [](const void* p) { return static_cast<const float*>(p); };

  AIIC_CHECK(launch_ln_rows(xb, f(ln_s), f(ln_b), static_cast<bf16*>(h), rows, W, eps, st));
  AIIC_CHECK(launch_gemm(static_cast<const bf16*>(h), static_cast<const bf16*>(w1), rows, M, W,
                         EpiBiasGelu{f(b1), static_cast<bf16*>(y), M}, st));
  AIIC_CHECK(launch_gemm(static_cast<const bf16*>(y), static_cast<const bf16*>(w2), rows, W, M,
                         EpiMlpOut{{f(b2), xb, static_cast<bf16*>(out), W}}, st));
  return 0;
}
