// The fp32 instantiation of the whole training text block
// (text_block.cuh), in a file of its own so that nvcc builds it beside the
// other type's.

#include "text_block.cuh"

namespace aiic {

cudaError_t text_block_fwd_f32(const BlockArgs& p, const Workspace& w, void* y, cudaStream_t st) {
  return run_fwd<float>(p, w, y, st);
}

cudaError_t text_block_bwd_f32(const BlockArgs& p, const Workspace& w, const void* dy, void* dx,
                               float* const* g, cudaStream_t st) {
  return run_bwd<float>(p, w, dy, dx, g, st);
}

}  // namespace aiic
