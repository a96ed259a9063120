// int8 attention half-block for Hopper:
//   out = x + OutProj_bf16(Attn(QKV_int8(LN1 x)))
//
// Replaces the TPU kernel aiic_tpu/ops/quant.py::_int8_attn_kernel (called
// from int8_ln_qkv_attention; its math is _int8_attn_group). The plain
// PyTorch version is aiic_tpu_torch/ops/quant.py::int8_ln_qkv_attention_ref.
//
// Four launches on the caller's stream (form 0, the route:
// int8_attn_half_wgmma, wgmma_serving_gemm.cuh):
//   (a) rowquant_kernel<LN>: LN1 in fp32 + per-row int8 quantization;
//   (b) wgmma_stage_kernel<int8_t, EpiQKV>: hq @ wqkv_q on the int8 tensor
//       cores through TMA and wgmma (w^T, K-major), epilogue
//       acc*hscale*sqkv + bqkv in fp32, stored bf16 (B*S, 3W);
//   (c) attn_core_mma_kernel<kPacked> (attn_core_mma.cuh, rows 6-8's
//       tensor-core core): 64 query rows of one (image, head) a block, K and
//       V streamed in 64-key tiles, both products on wgmma;
//   (d) wgmma_stage_kernel<bf16, EpiOutProj>: attn @ wo (w as it lies,
//       MN-major), epilogue + bo + x (fp32), stored bf16.
// Form 1 runs the first design (int8_attn_half, int8_halves.cuh): the same
// row pass, common.cuh's WMMA gemm_kernel for (b) and (d) and the scalar
// attn_core_kernel for (c). It stays for the side-by-side time and the
// bit-for-bit check of (b); rows 15-16 run it.
//
// What bounds it on the H100: at B=256 the image half-block is ~50k rows of
// width 768. The two projections (2*rows*W*4W operations, 0.181 ms at the
// int8 and bf16 peaks with the core) are compute-bound tensor-core GEMMs;
// qkv and the attention output round-trip through device memory between
// launches (0.5 GB). The no-max softmax (exp2 clamped at 70*log2 e) needs
// no running-max rescale, so one streaming pass over the keys is exact:
// that is the one simplification the TPU design gives for free.

#include "wgmma_serving_gemm.cuh"

// x (B,S,W) bf16; ln_s, ln_b (W) f32; wqkv_q (W,3W) int8 and its K-major
// copy wqkv_t (3W,W) (read by form 0 only); sqkv, bqkv (3W) f32; wo (W,W)
// bf16; bo (W) f32; mask (S,S) f32 or null; out (B,S,W) bf16. Scratch: hq
// (B*S,W) int8, hs (B*S) f32, qkv (B*S,3W) bf16, attn (B*S,W) bf16. form 0:
// the wgmma stage and the tensor-core core; 1: the WMMA form. Needs W % 128
// == 0 and W / H == 64. Returns a cudaError_t.
extern "C" int aiic_int8_ln_qkv_attention(
    const void* x, const void* ln_s, const void* ln_b, const void* wqkv_q, const void* wqkv_t,
    const void* sqkv, const void* bqkv, const void* wo, const void* bo, const void* mask,
    void* out, void* hq, void* hs, void* qkv, void* attn, int B, int S, int W, int H, float eps,
    float qconst, int form, void* stream) {
  using namespace aiic;
  auto f = [](const void* p) { return static_cast<const float*>(p); };
  const Int8Attn a{f(ln_s), f(ln_b), static_cast<const int8_t*>(wqkv_q), f(sqkv), f(bqkv),
                   static_cast<const bf16*>(wo), f(bo), f(mask)};
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const bf16* xb = static_cast<const bf16*>(x);
  bf16* ob = static_cast<bf16*>(out);
  int8_t* hq8 = static_cast<int8_t*>(hq);
  float* hsf = static_cast<float*>(hs);
  bf16* qkvb = static_cast<bf16*>(qkv);
  bf16* attnb = static_cast<bf16*>(attn);
  if (form == 0) {
    if (!wqkv_t) return static_cast<int>(cudaErrorInvalidValue);
    return int8_attn_half_wgmma(xb, a, static_cast<const int8_t*>(wqkv_t), ob, hq8, hsf, qkvb,
                                attnb, B, S, W, H, eps, qconst, st);
  }
  if (form != 1) return static_cast<int>(cudaErrorInvalidValue);
  return int8_attn_half(xb, a, ob, hq8, hsf, qkvb, attnb, B, S, W, H, eps, qconst, st);
}

// The projection stage alone, launches (a) and (b): qkv (rows,3W) bf16 from
// x (rows,W) bf16, for the large-S int8 attention path (its weight columns
// may be permuted head-major: the stage does not care). Scratch: hq (rows,W)
// int8, hs (rows) f32. form as above (wqkv_t read by form 0 only). Needs W %
// 128 == 0. Returns a cudaError_t.
extern "C" int aiic_int8_ln_qkv(const void* x, const void* ln_s, const void* ln_b,
                                const void* wqkv_q, const void* wqkv_t, const void* sqkv,
                                const void* bqkv, void* qkv, void* hq, void* hs, int rows, int W,
                                float eps, int form, void* stream) {
  using namespace aiic;
  auto f = [](const void* p) { return static_cast<const float*>(p); };
  const Int8Attn a{f(ln_s), f(ln_b), static_cast<const int8_t*>(wqkv_q), f(sqkv), f(bqkv),
                   nullptr, nullptr, nullptr};
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (form == 0) {
    if (!wqkv_t) return static_cast<int>(cudaErrorInvalidValue);
    return int8_qkv_stage_wgmma(static_cast<const bf16*>(x), a, static_cast<const int8_t*>(wqkv_t),
                                static_cast<bf16*>(qkv), static_cast<int8_t*>(hq),
                                static_cast<float*>(hs), rows, W, eps, st);
  }
  if (form != 1) return static_cast<int>(cudaErrorInvalidValue);
  return int8_qkv_stage(static_cast<const bf16*>(x), a, static_cast<bf16*>(qkv),
                        static_cast<int8_t*>(hq), static_cast<float*>(hs), rows, W, eps, st);
}
