// The C entry points of the whole training text block (text_block.cuh):
// aiic_text_block_fwd and aiic_text_block_bwd for fp32 or bf16 (bf16 in form
// 0 or 1), the size of the workspace each needs, and the blocks per SM of
// the bf16 form 0's stage kernels.

#include "text_block.cuh"

// Bytes of workspace the forward (backward == 0) or backward needs.
extern "C" long long aiic_text_block_workspace(int B, int S, int W, int M, int ro, int rf, int rp,
                                               int fp32, int backward) {
  aiic::Workspace w;
  return static_cast<long long>(
      aiic::layout(nullptr, B, S, W, M, ro, rf, rp, fp32 ? 4 : 2, backward != 0, &w));
}

#define AIIC_BLOCK_PARAMS                                                                      \
  const void *mask, const void *ln1s, const void *ln1b, const void *ln2s, const void *ln2b,    \
      const void *wqkv, const void *bqkv, const void *wo, const void *bo, const void *w1,      \
      const void *b1, const void *w2, const void *b2, const void *aoA, const void *aoB,        \
      const void *afA, const void *afB, const void *apA, const void *apB

#define AIIC_BLOCK_ARGS(x)                                                                     \
  aiic::BlockArgs {                                                                            \
    x, static_cast<const float*>(mask), static_cast<const float*>(ln1s),                      \
        static_cast<const float*>(ln1b), static_cast<const float*>(ln2s),                     \
        static_cast<const float*>(ln2b), wqkv, static_cast<const float*>(bqkv), wo,           \
        static_cast<const float*>(bo), w1, static_cast<const float*>(b1), w2,                 \
        static_cast<const float*>(b2), aoA, aoB, afA, afB, apA, apB, B, S, W, H, M, ro, rf,   \
        rp, scaling, eps, qconst, form                                                         \
  }

// x, y (B,S,W) in T (fp32 == 1: float, else bf16); mask (S,S) f32; ln*/b*
// f32 vectors holding T-rounded values; wqkv (W,3W), wo (W,W), w1 (W,M),
// w2 (M,W) and the LoRA factors A (in,r), B (r,out) in T. form (bf16): 0 the
// products on the wgmma + TMA stage, 1 on the WMMA tile; fp32 takes form 0
// alone, its SIMT route. Needs W, M multiples of 128, W == 64 H, S <= 128.
// Returns a cudaError_t.
extern "C" int aiic_text_block_fwd(const void* x, AIIC_BLOCK_PARAMS, void* y, void* ws, int B,
                                   int S, int W, int H, int M, int ro, int rf, int rp,
                                   float scaling, float eps, float qconst, int fp32, int form,
                                   void* stream) {
  using namespace aiic;
  if (!valid(S, W, H, M) || !valid_form(form, fp32 != 0))
    return static_cast<int>(cudaErrorInvalidValue);
  const BlockArgs p = AIIC_BLOCK_ARGS(x);
  Workspace w;
  layout(static_cast<char*>(ws), B, S, W, M, ro, rf, rp, fp32 ? 4 : 2, false, &w);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  return static_cast<int>(fp32 ? text_block_fwd_f32(p, w, y, st)
                               : text_block_fwd_bf16(p, w, y, st));
}

// As aiic_text_block_fwd, with dy in, dx (B,S,W) in T and the six fp32
// LoRA cotangents out: daoA (W,ro), daoB (ro,W), dafA (W,rf), dafB (rf,M),
// dapA (M,rp), dapB (rp,W). bf16 form 0 runs the core backward on row 9's
// two tensor-core passes, form 1 on block_core_bwd_kernel.
extern "C" int aiic_text_block_bwd(const void* x, const void* dy, AIIC_BLOCK_PARAMS, void* dx,
                                   void* daoA, void* daoB, void* dafA, void* dafB, void* dapA,
                                   void* dapB, void* ws, int B, int S, int W, int H, int M,
                                   int ro, int rf, int rp, float scaling, float eps, float qconst,
                                   int fp32, int form, void* stream) {
  using namespace aiic;
  if (!valid(S, W, H, M) || !valid_form(form, fp32 != 0))
    return static_cast<int>(cudaErrorInvalidValue);
  const BlockArgs p = AIIC_BLOCK_ARGS(x);
  Workspace w;
  layout(static_cast<char*>(ws), B, S, W, M, ro, rf, rp, fp32 ? 4 : 2, true, &w);
  float* g[6] = {static_cast<float*>(daoA), static_cast<float*>(daoB), static_cast<float*>(dafA),
                 static_cast<float*>(dafB), static_cast<float*>(dapA), static_cast<float*>(dapB)};
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  return static_cast<int>(fp32 ? text_block_bwd_f32(p, w, dy, dx, g, st)
                               : text_block_bwd_bf16(p, w, dy, dx, g, st));
}

// Blocks per SM of the bf16 block's stage kernels, into blocks[0..4]:
// EpiQkv, EpiY1, EpiFc (forward), EpiDfq, EpiLoRAOut (backward, K-major B).
// Returns a cudaError_t.
extern "C" int aiic_text_block_occupancy(int* blocks) {
  return static_cast<int>(aiic::text_block_occupancy_bf16(blocks));
}
