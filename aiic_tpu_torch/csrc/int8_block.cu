// Whole int8 transformer block for Hopper, both bodies:
//   y1  = x + OutProj_bf16(Attn(QKV_int8(LN1 x)))        (bf16)
//   out = y1 + int8-MLP(LN2 y1), full or hidden-axis chunked
//
// Replaces the TPU kernels aiic_tpu/ops/quant.py::_int8_block_kernel (the
// "full" plan of int8_block: the pair, row 1 then row 2, in one program) and
// _int8_block_chunk_kernel (the "chunked" plan: the attention half, y1 cast
// to bf16, LN2 and its quantization once, the fp32 accumulator seeded with
// y1f, each chunk's c_proj partial added in order, b2 last). The plain
// PyTorch version is aiic_tpu_torch/ops/quant.py::int8_block_ref.
//
// One host entry, one kernel sequence on the caller's stream. Form 0, the
// route (wgmma_serving_gemm.cuh): row 1's form 0 (int8_attn_half_wgmma: the
// row pass, the int8 QKV product and the bf16 out-projection on the wgmma
// + TMA stage, the tensor-core core) into y1, then on y1 the MLP half on the
// stage (int8_mlp_half_wgmma): row 2's form 0 with n_chunks = 1 (full), row
// 3's with C (chunked: the chunk sums folded into c_proj's mainloop). Four
// launches of the stage in all. Form 1 runs the first design, the WMMA
// sequences of int8_halves.cuh (int8_attn_half, int8_mlp_half), kept for the
// side-by-side time and the bit-for-bit check. The TPU kernel's image group G
// is VMEM tiling: it does not change the numerics and is not a parameter
// here.
//
// What bounds it on the H100: the four products (int8 QKV, bf16 out-proj,
// int8 c_fc and c_proj) on the tensor cores; at B/32 B=256 (12,800 rows of
// width 768) about 0.10 ms of int8 and bf16 operations at the card's peaks.
//
// What the design gives up: the TPU kernel keeps y1, qkv, the attention
// output and the gelu slab in VMEM; here each round-trips through device
// memory between the half-blocks' launches (at B/32 B=256: qkv 59 MB, y 157
// MB of fp32), so the fusion saves the wrapper's calls, not bytes, and pays
// rows 1-3's eight launches. A block that ran both halves on its own rows
// would keep y1 on chip; that is work for a later change.

#include "wgmma_serving_gemm.cuh"

// x (B,S,W) bf16; the attention half's weights as aiic_int8_ln_qkv_attention
// (wqkv_q and its K-major copy wqkv_t; mask (S,S) f32 or null); the MLP
// half's as aiic_int8_ln_mlp (w1_q, w1_t, w2_q, w2_t); out (B,S,W) bf16.
// Scratch: y1 (B*S,W) bf16, hq (B*S,W) int8, hs (B*S) f32, qkv (B*S,3W)
// bf16, attn (B*S,W) bf16, y (B*S,M) f32, yq (B*S,M) int8, ys (B*S,
// n_chunks) f32, part (n_chunks, B*S, W) f32 (read by form 1 with n_chunks
// > 1 only). form 0: the wgmma stage (reads the K-major copies); 1: the WMMA
// form (reads wqkv_q, w1_q, w2_q). Needs W % 128 == 0, W / H == 64, M %
// 128 == 0 and M / n_chunks a multiple of 128 (form 0) or 32 (form 1).
// Returns a cudaError_t.
extern "C" int aiic_int8_block(
    const void* x, const void* ln1_s, const void* ln1_b, const void* wqkv_q, const void* wqkv_t,
    const void* sqkv, const void* bqkv, const void* wo, const void* bo, const void* mask,
    const void* ln2_s, const void* ln2_b, const void* w1_q, const void* w1_t, const void* s1,
    const void* b1, const void* w2_q, const void* w2_t, const void* s2, const void* b2, void* out,
    void* y1, void* hq, void* hs, void* qkv, void* attn, void* y, void* yq, void* ys, void* part,
    int B, int S, int W, int H, int M, int n_chunks, float eps, float qconst, int form,
    void* stream) {
  using namespace aiic;
  if (n_chunks < 1) return static_cast<int>(cudaErrorInvalidValue);
  auto f = [](const void* p) { return static_cast<const float*>(p); };
  auto q = [](const void* p) { return static_cast<const int8_t*>(p); };
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const Int8Attn a{f(ln1_s), f(ln1_b), q(wqkv_q), f(sqkv), f(bqkv),
                   static_cast<const bf16*>(wo), f(bo), f(mask)};
  const Int8Mlp m{f(ln2_s), f(ln2_b), q(w1_q), f(s1), f(b1), q(w2_q), f(s2), f(b2)};
  const MlpScratch s{static_cast<int8_t*>(hq), static_cast<float*>(hs), static_cast<float*>(y),
                     static_cast<int8_t*>(yq), static_cast<float*>(ys), static_cast<float*>(part)};
  const bf16* xb = static_cast<const bf16*>(x);
  bf16* y1b = static_cast<bf16*>(y1);
  bf16* ob = static_cast<bf16*>(out);
  bf16* qkvb = static_cast<bf16*>(qkv);
  bf16* attnb = static_cast<bf16*>(attn);
  if (form == 0) {
    if (!wqkv_t || !w1_t || !w2_t) return static_cast<int>(cudaErrorInvalidValue);
    AIIC_CHECK(int8_attn_half_wgmma(xb, a, q(wqkv_t), y1b, s.hq, s.hs, qkvb, attnb, B, S, W, H,
                                    eps, qconst, st));
    return int8_mlp_half_wgmma(y1b, m, q(w1_t), q(w2_t), ob, s, B * S, W, M, n_chunks, eps, st);
  }
  if (form != 1 || (n_chunks > 1 && part == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  AIIC_CHECK(int8_attn_half(xb, a, y1b, s.hq, s.hs, qkvb, attnb, B, S, W, H, eps, qconst, st));
  return int8_mlp_half(static_cast<const bf16*>(y1), m, ob, s, B * S, W, M, n_chunks, eps, st);
}
