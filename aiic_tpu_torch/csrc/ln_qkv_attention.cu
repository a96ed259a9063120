// bf16 attention half-block for Hopper:
//   out = x + OutProj(Attn(QKV(bf16(LN1 x))))
//
// Replaces the TPU kernel aiic_tpu/ops/attention.py::_ln_qkv_attention_kernel
// (called from fused_ln_qkv_attention: the worker's default, bf16 without
// int8 weights). The plain PyTorch version is
// aiic_tpu_torch/ops/attention.py::fused_ln_qkv_attention_ref.
//
// Four launches on the caller's stream:
//   (a) ln_rows_kernel: LN1 in fp32, rounded to bf16;
//   (b) gemm_kernel<bf16>: h @ wqkv on the bf16 tensor cores, epilogue
//       bf16(acc + bqkv), stored (B*S, 3W);
//   (c) attn_core_kernel<bf16> (common.cuh): the streaming no-max core;
//   (d) gemm_kernel<bf16>: attn @ wo, epilogue bf16(x + (acc + bo)).
//
// What bounds it on the H100: at B=256 the two projections are
// 2*rows*W*4W = 238 GFLOP of bf16 tensor-core work (0.24 ms at 989 TFLOP/s)
// and dominate; the core adds 30.5 GFLOP and the row pass is bandwidth-bound.
//
// What the simple design gives up: the int8 half-block's (int8_attention.cu)
// GEMM and core, with the same gaps: WMMA tiles staged by plain loads with no
// TMA/wgmma pipeline, h, qkv and attn round-trip through device memory
// between launches, and the core runs scalar FMAs.

#include "common.cuh"

namespace aiic {
namespace {

struct EpiBiasQKV {  // qkv = bf16(acc + bqkv)
  const float* b;
  bf16* out;
  int n_cols;
  __device__ void operator()(int r, int n, float acc) const {
    out[static_cast<size_t>(r) * n_cols + n] = __float2bfloat16_rn(acc + b[n]);
  }
};

}  // namespace
}  // namespace aiic

// x (B,S,W) bf16; ln_s, ln_b (W) f32; wqkv (W,3W) bf16; bqkv (3W) f32;
// wo (W,W) bf16; bo (W) f32; mask (S,S) f32 or null; out (B,S,W) bf16.
// Scratch: h (B*S,W), qkv (B*S,3W), attn (B*S,W), all bf16. Needs
// W % 128 == 0 and W / H == 64. Returns a cudaError_t.
extern "C" int aiic_ln_qkv_attention(
    const void* x, const void* ln_s, const void* ln_b, const void* wqkv, const void* bqkv,
    const void* wo, const void* bo, const void* mask, void* out, void* h, void* qkv,
    void* attn, int B, int S, int W, int H, float eps, float qconst, void* stream) {
  using namespace aiic;
  if (W % kBN != 0 || W % H != 0 || W / H != kHeadDim) return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int rows = B * S;
  const bf16* xb = static_cast<const bf16*>(x);
  auto f = [](const void* p) { return static_cast<const float*>(p); };

  AIIC_CHECK(launch_ln_rows(xb, f(ln_s), f(ln_b), static_cast<bf16*>(h), rows, W, eps, st));
  AIIC_CHECK(launch_gemm(static_cast<const bf16*>(h), static_cast<const bf16*>(wqkv), rows,
                         3 * W, W, EpiBiasQKV{f(bqkv), static_cast<bf16*>(qkv), 3 * W}, st));
  AIIC_CHECK(launch_attn_core(static_cast<const bf16*>(qkv), f(mask), static_cast<bf16*>(attn),
                              B, S, W, H, qconst, st));
  AIIC_CHECK(launch_gemm(static_cast<const bf16*>(attn), static_cast<const bf16*>(wo), rows, W,
                         W, EpiOutProj{f(bo), xb, static_cast<bf16*>(out), W}, st));
  return 0;
}
