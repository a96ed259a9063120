// The bf16 instantiation of the whole training text block
// (text_block.cuh), in a file of its own so that nvcc builds it beside the
// other type's.

#include "text_block.cuh"

namespace aiic {

cudaError_t text_block_fwd_bf16(const BlockArgs& p, const Workspace& w, void* y, cudaStream_t st) {
  return run_fwd<bf16>(p, w, y, st);
}

cudaError_t text_block_bwd_bf16(const BlockArgs& p, const Workspace& w, const void* dy, void* dx,
                               float* const* g, cudaStream_t st) {
  return run_bwd<bf16>(p, w, dy, dx, g, st);
}

cudaError_t text_block_occupancy_bf16(int* blocks) {
  const void* kernels[] = {
      reinterpret_cast<const void*>(wgmma_stage_kernel<bf16, EpiQkv<bf16>>),
      reinterpret_cast<const void*>(wgmma_stage_kernel<bf16, EpiY1<bf16>>),
      reinterpret_cast<const void*>(wgmma_stage_kernel<bf16, EpiFc<bf16>>),
      reinterpret_cast<const void*>(wgmma_stage_kernel<bf16, EpiDfq<bf16>, true>),
      reinterpret_cast<const void*>(wgmma_stage_kernel<bf16, EpiLoRAOut<bf16, float>, true>)};
  return stage_kernel_occupancy(kernels, 5, blocks);
}

}  // namespace aiic
