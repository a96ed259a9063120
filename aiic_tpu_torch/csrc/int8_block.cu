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
// One host entry, one kernel sequence on the caller's stream: the attention
// half of int8_attention.cu (int8_attn_half) into y1, then the MLP half of
// int8_mlp.cu (int8_mlp_half) on y1 with n_chunks = 1 (full) or C (chunked).
// The TPU kernel's image group G is VMEM tiling: it does not change the
// numerics and is not a parameter here.
//
// What bounds it on the H100: the four products (int8 QKV, bf16 out-proj,
// int8 c_fc and c_proj) on the tensor cores; at B/32 B=256 (12,800 rows of
// width 768) about 0.10 ms of int8 and bf16 operations at the card's peaks.
//
// What the simple design gives up: this is the pair's kernels called back to
// back. The TPU kernel keeps y1 in VMEM; here y1 (and qkv, the attention
// output and the fp32 gelu slab) round-trip through device memory, so the
// fusion saves launches of the wrapper, not bytes. Keeping y1 on chip is
// work for a later change.

#include "int8_halves.cuh"

// x (B,S,W) bf16; the attention half's weights as aiic_int8_ln_qkv_attention
// (mask (S,S) f32 or null); the MLP half's as aiic_int8_ln_mlp; out (B,S,W)
// bf16. Scratch: y1 (B*S,W) bf16, hq (B*S,W) int8, hs (B*S) f32, qkv
// (B*S,3W) bf16, attn (B*S,W) bf16, y (B*S,M) f32, yq (B*S,M) int8, ys
// (B*S, n_chunks) f32, part (n_chunks, B*S, W) f32 (null when n_chunks ==
// 1). Needs W % 128 == 0, W / H == 64, M % 128 == 0, M / n_chunks % 32 == 0.
// Returns a cudaError_t.
extern "C" int aiic_int8_block(
    const void* x, const void* ln1_s, const void* ln1_b, const void* wqkv_q, const void* sqkv,
    const void* bqkv, const void* wo, const void* bo, const void* mask, const void* ln2_s,
    const void* ln2_b, const void* w1_q, const void* s1, const void* b1, const void* w2_q,
    const void* s2, const void* b2, void* out, void* y1, void* hq, void* hs, void* qkv,
    void* attn, void* y, void* yq, void* ys, void* part, int B, int S, int W, int H, int M,
    int n_chunks, float eps, float qconst, void* stream) {
  using namespace aiic;
  if (n_chunks < 1 || (n_chunks > 1 && part == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  auto f = [](const void* p) { return static_cast<const float*>(p); };
  auto q = [](const void* p) { return static_cast<const int8_t*>(p); };
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const Int8Attn a{f(ln1_s), f(ln1_b), q(wqkv_q), f(sqkv), f(bqkv),
                   static_cast<const bf16*>(wo), f(bo), f(mask)};
  const Int8Mlp m{f(ln2_s), f(ln2_b), q(w1_q), f(s1), f(b1), q(w2_q), f(s2), f(b2)};
  const MlpScratch s{static_cast<int8_t*>(hq), static_cast<float*>(hs), static_cast<float*>(y),
                     static_cast<int8_t*>(yq), static_cast<float*>(ys), static_cast<float*>(part)};
  AIIC_CHECK(int8_attn_half(static_cast<const bf16*>(x), a, static_cast<bf16*>(y1), s.hq, s.hs,
                            static_cast<bf16*>(qkv), static_cast<bf16*>(attn), B, S, W, H, eps,
                            qconst, st));
  return int8_mlp_half(static_cast<const bf16*>(y1), m, static_cast<bf16*>(out), s, B * S, W, M,
                       n_chunks, eps, st);
}
