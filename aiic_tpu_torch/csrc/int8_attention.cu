// int8 attention half-block for Hopper:
//   out = x + OutProj_bf16(Attn(QKV_int8(LN1 x)))
//
// Replaces the TPU kernel aiic_tpu/ops/quant.py::_int8_attn_kernel (called
// from int8_ln_qkv_attention; its math is _int8_attn_group). The plain
// PyTorch version is aiic_tpu_torch/ops/quant.py::int8_ln_qkv_attention_ref.
//
// Four launches on the caller's stream (int8_attn_half, int8_halves.cuh):
//   (a) rowquant_kernel<LN>: LN1 in fp32 + per-row int8 quantization;
//   (b) gemm_kernel<int8_t>: hq @ wqkv_q on the int8 tensor cores, epilogue
//       acc*hscale*sqkv + bqkv in fp32, stored bf16 (B*S, 3W);
//   (c) attn_core_kernel<bf16> (common.cuh, shared with the unquantized
//       kernels): one thread per query row of one (image, head), K and V of
//       that head staged in shared memory;
//   (d) gemm_kernel<bf16>: attn @ wo on the bf16 tensor cores, epilogue
//       + bo + x (fp32), stored bf16.
//
// What bounds it on the H100: at B=256 the image half-block is ~50k rows of
// width 768. The two projections (2*rows*W*4W MACs) are compute-bound
// tensor-core GEMMs; the core (4*B*H*S^2*D flops at S=197) and the row pass
// move little data per flop but run on the CUDA cores here.
//
// What the simple design gives up: the GEMM stages its tiles with plain
// loads and no pipelining (no TMA, no wgmma, no cp.async ring), qkv and the
// attention output round-trip through device memory between launches, and
// the core runs scalar fp32 FMAs instead of tensor-core products. The
// no-max softmax (exp2 clamped at 70*log2 e) needs no running-max rescale,
// so one streaming pass over the keys is exact: that is the one
// simplification the TPU design gives for free.

#include "int8_halves.cuh"

// x (B,S,W) bf16; ln_s, ln_b (W) f32; wqkv_q (W,3W) int8; sqkv, bqkv (3W)
// f32; wo (W,W) bf16; bo (W) f32; mask (S,S) f32 or null; out (B,S,W) bf16.
// Scratch: hq (B*S,W) int8, hs (B*S) f32, qkv (B*S,3W) bf16, attn (B*S,W)
// bf16. Needs W % 128 == 0 and W / H == 64. Returns a cudaError_t.
extern "C" int aiic_int8_ln_qkv_attention(
    const void* x, const void* ln_s, const void* ln_b, const void* wqkv_q,
    const void* sqkv, const void* bqkv, const void* wo, const void* bo,
    const void* mask, void* out, void* hq, void* hs, void* qkv, void* attn,
    int B, int S, int W, int H, float eps, float qconst, void* stream) {
  using namespace aiic;
  auto f = [](const void* p) { return static_cast<const float*>(p); };
  const Int8Attn a{f(ln_s), f(ln_b), static_cast<const int8_t*>(wqkv_q), f(sqkv), f(bqkv),
                   static_cast<const bf16*>(wo), f(bo), f(mask)};
  return int8_attn_half(static_cast<const bf16*>(x), a, static_cast<bf16*>(out),
                        static_cast<int8_t*>(hq), static_cast<float*>(hs),
                        static_cast<bf16*>(qkv), static_cast<bf16*>(attn), B, S, W, H, eps,
                        qconst, static_cast<cudaStream_t>(stream));
}

// The projection stage alone, launches (a) and (b): qkv (rows,3W) bf16 from
// x (rows,W) bf16, for the large-S int8 attention path (its weight columns
// may be permuted head-major: the stage does not care). Scratch: hq (rows,W)
// int8, hs (rows) f32. Needs W % 128 == 0. Returns a cudaError_t.
extern "C" int aiic_int8_ln_qkv(const void* x, const void* ln_s, const void* ln_b,
                                const void* wqkv_q, const void* sqkv, const void* bqkv,
                                void* qkv, void* hq, void* hs, int rows, int W, float eps,
                                void* stream) {
  using namespace aiic;
  auto f = [](const void* p) { return static_cast<const float*>(p); };
  const Int8Attn a{f(ln_s), f(ln_b), static_cast<const int8_t*>(wqkv_q), f(sqkv), f(bqkv),
                   nullptr, nullptr, nullptr};
  return int8_qkv_stage(static_cast<const bf16*>(x), a, static_cast<bf16*>(qkv),
                        static_cast<int8_t*>(hq), static_cast<float*>(hs), rows, W, eps,
                        static_cast<cudaStream_t>(stream));
}
