// int8 attention half-block for Hopper:
//   out = x + OutProj_bf16(Attn(QKV_int8(LN1 x)))
//
// Replaces the TPU kernel aiic_tpu/ops/quant.py::_int8_attn_kernel (called
// from int8_ln_qkv_attention; its math is _int8_attn_group). The plain
// PyTorch version is aiic_tpu_torch/ops/quant.py::int8_ln_qkv_attention_ref.
//
// Four launches on the caller's stream:
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

}  // namespace
}  // namespace aiic

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
  if (W % kBN != 0 || W / H != kHeadDim || W % H != 0) return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int rows = B * S;
  const bf16* xb = static_cast<const bf16*>(x);

  AIIC_CHECK((launch_rowquant<true, bf16>(xb, static_cast<const float*>(ln_s),
                                          static_cast<const float*>(ln_b),
                                          static_cast<int8_t*>(hq), static_cast<float*>(hs),
                                          rows, W, eps, st)));
  AIIC_CHECK(launch_gemm(static_cast<const int8_t*>(hq), static_cast<const int8_t*>(wqkv_q),
                         rows, 3 * W, W,
                         EpiQKV{static_cast<const float*>(hs), static_cast<const float*>(sqkv),
                                static_cast<const float*>(bqkv), static_cast<bf16*>(qkv), 3 * W},
                         st));
  AIIC_CHECK(launch_attn_core(static_cast<const bf16*>(qkv), static_cast<const float*>(mask),
                              static_cast<bf16*>(attn), B, S, W, H, qconst, st));
  AIIC_CHECK(launch_gemm(static_cast<const bf16*>(attn), static_cast<const bf16*>(wo),
                         rows, W, W,
                         EpiOutProj{static_cast<const float*>(bo), xb, static_cast<bf16*>(out), W},
                         st));
  return 0;
}
