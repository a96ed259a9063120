// bf16 attention half-block for Hopper:
//   out = x + OutProj(Attn(QKV(bf16(LN1 x))))
//
// Replaces the TPU kernel aiic_tpu/ops/attention.py::_ln_qkv_attention_kernel
// (called from fused_ln_qkv_attention: the worker's default, bf16 without
// int8 weights). The plain PyTorch version is
// aiic_tpu_torch/ops/attention.py::fused_ln_qkv_attention_ref.
//
// Four launches on the caller's stream. Form 0, the route (row 1's design in
// bf16, on wgmma_serving_gemm.cuh):
//   (a) ln_rows_kernel: LN1 in fp32, rounded to bf16;
//   (b) wgmma_stage_kernel<bf16, EpiBiasQKV>: h @ wqkv on the bf16 tensor
//       cores through TMA and wgmma (m64n128k16, w read MN-major as it lies),
//       epilogue bf16(acc + bqkv) staged through shared memory, stored
//       (B*S, 3W);
//   (c) attn_core_mma_kernel<kPacked> (attn_core_mma.cuh): 64 query rows of
//       one (image, head) a block, K and V streamed in 64-key tiles, both
//       products on wgmma;
//   (d) wgmma_stage_kernel<bf16, EpiOutProj>: attn @ wo, epilogue
//       bf16(x + (acc + bo)) on the fragments (row 1's instantiation).
// Form 1, the first design, runs (b) and (d) on common.cuh's WMMA
// gemm_kernel and (c) on the scalar attn_core_kernel<bf16>; it stays for
// the side-by-side time. The two forms sum the fp32 products in different
// orders, so they agree at the bf16 bar, not bit for bit.
//
// What bounds it on the H100: at B=256 ViT-B/16 (50,432 rows, W = 768) the
// two projections are 2*rows*W*4W = 238 GFLOP of bf16 tensor-core work and
// the core 30.5 GFLOP: 0.271 ms at 989 TFLOP/s. The row pass is bound by its
// bytes.
//
// What the design gives up: h (77 MB), qkv (232 MB) and attn (77 MB)
// round-trip through device memory between the four launches at B=256;
// a block that ran LN, the QKV product and the core on its own rows would
// keep them on chip.

#include "wgmma_serving_gemm.cuh"

namespace aiic {
namespace {

cudaError_t bf16_attn_half(const bf16* x, const float* ln_s, const float* ln_b,
                           const bf16* wqkv, const float* bqkv, const bf16* wo, const float* bo,
                           const float* mask, bf16* out, bf16* h, bf16* qkv, bf16* attn, int B,
                           int S, int W, int H, float eps, float qconst, int form,
                           cudaStream_t st) {
  if (W % kSBN != 0 || W % H != 0 || W / H != kHeadDim || (form != 0 && form != 1))
    return cudaErrorInvalidValue;
  const int rows = B * S;
  AIIC_CHECK(launch_ln_rows(x, ln_s, ln_b, h, rows, W, eps, st));
  const EpiBiasQKV epi_qkv{bqkv, qkv, 3 * W};
  const EpiOutProj epi_out{bo, x, out, W};
  const bf16* hc = h;
  const bf16* q = qkv;
  const bf16* a = attn;
  if (form == 0) {
    AIIC_CHECK(launch_wgmma_stage(hc, wqkv, rows, 3 * W, W, epi_qkv, st));
    AIIC_CHECK(launch_attn_core_mma<QKVLayout::kPacked>(q, q, q, mask, attn, B, S, W, H, qconst,
                                                        st));
    return launch_wgmma_stage(a, wo, rows, W, W, epi_out, st);
  }
  AIIC_CHECK(launch_gemm(hc, wqkv, rows, 3 * W, W, epi_qkv, st));
  AIIC_CHECK(launch_attn_core(q, mask, attn, B, S, W, H, qconst, st));
  return launch_gemm(a, wo, rows, W, W, epi_out, st);
}

}  // namespace
}  // namespace aiic

// x (B,S,W) bf16; ln_s, ln_b (W) f32; wqkv (W,3W) bf16; bqkv (3W) f32;
// wo (W,W) bf16; bo (W) f32; mask (S,S) f32 or null; out (B,S,W) bf16.
// Scratch: h (B*S,W), qkv (B*S,3W), attn (B*S,W), all bf16. form 0: the
// wgmma stage and the tensor-core core; 1: the WMMA form (K and V of one
// head within a block's shared memory). Needs W % 128 == 0 and W / H == 64;
// rows and weights 16-B aligned. Returns a cudaError_t.
extern "C" int aiic_ln_qkv_attention(
    const void* x, const void* ln_s, const void* ln_b, const void* wqkv, const void* bqkv,
    const void* wo, const void* bo, const void* mask, void* out, void* h, void* qkv,
    void* attn, int B, int S, int W, int H, float eps, float qconst, int form, void* stream) {
  using namespace aiic;
  auto f = [](const void* p) { return static_cast<const float*>(p); };
  auto b = [](const void* p) { return static_cast<const bf16*>(p); };
  return static_cast<int>(bf16_attn_half(
      b(x), f(ln_s), f(ln_b), b(wqkv), f(bqkv), b(wo), f(bo), f(mask), static_cast<bf16*>(out),
      static_cast<bf16*>(h), static_cast<bf16*>(qkv), static_cast<bf16*>(attn), B, S, W, H, eps,
      qconst, form, static_cast<cudaStream_t>(stream)));
}
