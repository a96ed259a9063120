// The fp32 instantiation of the whole training text block
// (text_block.cuh), in a file of its own so that nvcc builds it beside the
// other type's, and the fp32 block's attention core: the forward on the
// register-tiled core of rows 6-7 (attn_core_f32.cuh), the backward on row
// 9's two register-tiled passes (attn_core_bwd_f32.cuh), the same function
// as the TPU kernel's core step.

#include "text_block.cuh"

#include "attn_core_bwd_f32.cuh"
#include "attn_core_f32.cuh"

namespace aiic {

cudaError_t text_core_fwd_f32(const float* qkv, const float* mask, float* a, int B, int S, int W,
                              int H, float qconst, cudaStream_t st) {
  return launch_attn_core_f32<QKVLayout::kPacked>(qkv, qkv, qkv, mask, a, B, S, W, H, qconst, st);
}

cudaError_t text_core_bwd_f32(const float* qkv, const float* da, const float* mask, float* dqkv,
                              float* ws, int B, int S, int W, int H, float qconst,
                              cudaStream_t st) {
  return launch_core_bwd_tiled(qkv, da, mask, dqkv, ws, B, S, W, H, qconst, st);
}

cudaError_t text_block_fwd_f32(const BlockArgs& p, const Workspace& w, void* y, cudaStream_t st) {
  return run_fwd<float>(p, w, y, st);
}

cudaError_t text_block_bwd_f32(const BlockArgs& p, const Workspace& w, const void* dy, void* dx,
                               float* const* g, cudaStream_t st) {
  return run_bwd<float>(p, w, dy, dx, g, st);
}

}  // namespace aiic
