// bf16 LN + MLP half-block for Hopper:
//   out = x + W2 . bf16(quick_gelu(W1 . bf16(LN2 x) + b1)) + b2
//
// Replaces the TPU kernel aiic_tpu/ops/mlp.py::_mlp_kernel (called from
// fused_ln_mlp, attn_impl="pallas_mlp"). The plain PyTorch version is
// aiic_tpu_torch/ops/mlp.py::fused_ln_mlp_ref.
//
// Three launches on the caller's stream. Form 0, the route (row 2's design
// in bf16, on wgmma_serving_gemm.cuh):
//   (a) ln_rows_kernel: LN2 in fp32, rounded to bf16;
//   (b) wgmma_stage_kernel<bf16, EpiBiasGelu>: h @ w1 on the bf16 tensor
//       cores through TMA and wgmma (w1 read MN-major as it lies), epilogue
//       y = acc + b1, the exp2 quick_gelu in fp32, one rounding to bf16,
//       staged through shared memory, stored (rows, M);
//   (c) wgmma_stage_kernel<bf16, EpiMlpOut>: y @ w2, K = M (48 64-deep
//       slices at ViT-B/16), epilogue bf16(x + (acc + b2)) on the fragments.
// Form 1, the first design, runs (b) and (c) on common.cuh's WMMA
// gemm_kernel; it stays for the side-by-side time. The two forms sum the
// fp32 products in different orders, so they agree at the bf16 bar, not bit
// for bit.
//
// What bounds it on the H100: the two products, 4*rows*W*M = 476 GFLOP at
// B=256 (0.48 ms at 989 TFLOP/s bf16); everything else is elementwise.
//
// What the design gives up: the bf16 hidden activation (rows x 4W, 310 MB
// at B=256) makes a round trip through device memory between the two
// products; c_proj could take each block's y tile from c_fc on chip only if
// one block owned whole rows of the 4W-wide hidden layer.

#include "wgmma_serving_gemm.cuh"

namespace aiic {
namespace {

cudaError_t bf16_mlp_half(const bf16* x, const float* ln_s, const float* ln_b, const bf16* w1,
                          const float* b1, const bf16* w2, const float* b2, bf16* out, bf16* h,
                          bf16* y, int rows, int W, int M, float eps, int form, cudaStream_t st) {
  if (W % kSBN != 0 || M % kSBN != 0 || (form != 0 && form != 1)) return cudaErrorInvalidValue;
  AIIC_CHECK(launch_ln_rows(x, ln_s, ln_b, h, rows, W, eps, st));
  const EpiBiasGelu epi_fc{b1, y, M};
  const EpiMlpOut epi_proj{{b2, x, out, W}};
  const bf16* hc = h;
  const bf16* yc = y;
  if (form == 0) {
    AIIC_CHECK(launch_wgmma_stage(hc, w1, rows, M, W, epi_fc, st));
    return launch_wgmma_stage(yc, w2, rows, W, M, epi_proj, st);
  }
  AIIC_CHECK(launch_gemm(hc, w1, rows, M, W, epi_fc, st));
  return launch_gemm(yc, w2, rows, W, M, epi_proj, st);
}

}  // namespace
}  // namespace aiic

// x (rows,W) bf16; ln_s, ln_b (W) f32; w1 (W,M) bf16; b1 (M) f32; w2 (M,W)
// bf16; b2 (W) f32; out (rows,W) bf16. Scratch: h (rows,W), y (rows,M), both
// bf16. form 0: the wgmma stage; 1: the WMMA form. Needs W and M multiples
// of 128; rows and weights 16-B aligned. Returns a cudaError_t.
extern "C" int aiic_ln_mlp(const void* x, const void* ln_s, const void* ln_b, const void* w1,
                           const void* b1, const void* w2, const void* b2, void* out, void* h,
                           void* y, int rows, int W, int M, float eps, int form, void* stream) {
  using namespace aiic;
  auto f = [](const void* p) { return static_cast<const float*>(p); };
  auto b = [](const void* p) { return static_cast<const bf16*>(p); };
  return static_cast<int>(bf16_mlp_half(b(x), f(ln_s), f(ln_b), b(w1), f(b1), b(w2), f(b2),
                                        static_cast<bf16*>(out), static_cast<bf16*>(h),
                                        static_cast<bf16*>(y), rows, W, M, eps, form,
                                        static_cast<cudaStream_t>(stream)));
}
