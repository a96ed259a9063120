// Attention core on three separate (B, S, H, D) arrays, bf16 or fp32:
//   out (B, S, H, D) = Attn(q, k, v), mask (S, S) additive or none
//
// Replaces the TPU kernel aiic_tpu/ops/attention.py::_attention_kernel (:313,
// called from fused_attention :342 at :377, which the dispatch
// flash_attention :400 calls: row 6). The plain PyTorch version is
// aiic_tpu_torch/ops/attention.py::fused_attention_ref.
//
// bf16 at D = 64 (every CLIP preset): one launch of attn_core_mma_kernel<
// QKVLayout::kSeparate> (attn_core_mma.cuh), the tensor-core core of rows 7
// (bf16) and 8 reading q, k and v through three base pointers, head h at
// h*64 of a row of W = H*64; the output in the packed core's layout, which
// is (B, S, H, 64). K and V stream in 64-key tiles, so it takes any S.
// fp32, and bf16 at D = 8 (the JAX tests' small geometry): one launch of
// common.cuh's scalar attn_core_kernel<T, D, QKVLayout::kSeparate>, the
// streaming no-max core of rows 1, 5 and fp32 row 7 (tensor cores would
// compute fp32 in TF32 and miss its 1e-5 bar; the mma core is built for
// D = 64). The TPU kernel pads S and D to 128 and masks the padded keys
// with -inf; padded D columns are zero and padded keys get p = 0, so the
// unpadded computation here is the same function. Its grouping of (batch,
// head) pairs per grid step is TPU tiling; here every (query tile, head,
// image) is one block. T is the rounding policy: in bf16, q*c with
// c = bf16(scale*log2 e), p before p.V and the output round to bf16; in
// fp32 nothing rounds.
//
// What bounds it on the H100: at B=256, S=197, H=12, D=64 the core does
// 4*B*H*S^2*D = 30.5 GFLOP and moves 4*B*S*H*D elements (q, k, v in, out).
// In fp32 the bound is the 66.9 TFLOP/s of the CUDA cores (0.46 ms); in bf16
// the memory (0.09 ms).
//
// What the scalar core gives up (fp32, D = 8): the products run as scalar
// fp32 FMAs, one thread per query row, with K and V of one head in shared
// memory (100,864 B at S=197 in fp32: two blocks per SM); fp32 at S=577
// (295 KB) does not fit and is refused.

#include "attn_core_mma.cuh"  // and common.cuh

// q, k, v, out (B,S,H,D), all bf16 (fp32 == 0) or fp32 (fp32 == 1); mask
// (S,S) f32 or null; qconst = scale*log2 e rounded to the element type.
// D must be 8 or 64. Returns a cudaError_t.
extern "C" int aiic_attention_bshd(const void* q, const void* k, const void* v, const void* mask,
                                   void* out, int B, int S, int H, int D, float qconst, int fp32,
                                   void* stream) {
  using namespace aiic;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* m = static_cast<const float*>(mask);
  auto f = [](const void* p) { return static_cast<const float*>(p); };
  auto b = [](const void* p) { return static_cast<const bf16*>(p); };
  if (fp32 && D == 64)
    return launch_attn_core_bshd<float, 64>(f(q), f(k), f(v), m, static_cast<float*>(out), B, S,
                                            H, qconst, st);
  if (fp32 && D == 8)
    return launch_attn_core_bshd<float, 8>(f(q), f(k), f(v), m, static_cast<float*>(out), B, S,
                                           H, qconst, st);
  if (D == 64)
    return launch_attn_core_mma<QKVLayout::kSeparate>(b(q), b(k), b(v), m, static_cast<bf16*>(out),
                                                      B, S, H * kHeadDim, H, qconst, st);
  if (D == 8)
    return launch_attn_core_bshd<bf16, 8>(b(q), b(k), b(v), m, static_cast<bf16*>(out), B, S, H,
                                          qconst, st);
  return static_cast<int>(cudaErrorInvalidValue);
}
