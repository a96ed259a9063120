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
  if (!valid(S, W, H, M) || !valid_form(form, fp32 != 0, S))
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
  if (!valid(S, W, H, M) || !valid_form(form, fp32 != 0, S))
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

namespace aiic {
namespace {

template <typename T, typename TA>
cudaError_t rank_product(const TA* A, const T* B, void* out, float* part, int rows, int K, int R,
                         int kind, int trans, float s, int form, cudaStream_t st) {
  if (kind == 0)
    return down_proj<T>(A, K, B, trans ? 1 : R, trans ? K : 1, rows, R, part,
                        static_cast<T*>(out), form, st);
  return rows_reduce<T>(A, K, B, R, rows, s, part, static_cast<float*>(out), trans != 0, form,
                        st);
}

template <bool kTransB>
cudaError_t text_sgemm(const float* A, const float* B, float* C, int M, int N, int K,
                       cudaStream_t st) {
  const LoRATerm<float> none{nullptr, nullptr, 0, 0, 0, 0.f};
  const dim3 grid(N / kSgBN, (M + kSgBM - 1) / kSgBM);
  sgemm_kernel<kTransB, EpiStore<float>><<<grid, 256, 0, st>>>(A, B, M, N, K, none,
                                                              EpiStore<float>{C, N});
  return cudaGetLastError();
}

cudaError_t rank_occupancy(int* blocks) {
  AIIC_CHECK(block_core_fwd_mma_occupancy(blocks));
  const auto down = rank_down_kernel<bf16, bf16, bf16, EpiStore<bf16>>;
  AIIC_CHECK(cudaFuncSetAttribute(down, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                  rank_down_smem(8, 8)));
  AIIC_CHECK(cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks + 1, down, 64,
                                                           rank_down_smem(2, 2)));
  AIIC_CHECK(cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks + 2, down, 256,
                                                           rank_down_smem(8, 8)));
  AIIC_CHECK(cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      blocks + 3, rank_cot_kernel<bf16, bf16, bf16>, 32 * kRankWarps, 0));
  return cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      blocks + 4, rank_cot_kernel<float, float, float>, 32 * kRankWarps, 0);
}

}  // namespace
}  // namespace aiic

// The text block's rank-r products alone, for the card's tests and timing.
// kind 0, a down-projection: out (rows, R) in T = A (rows, K) . B, B (K, R),
// or (R, K) read transposed (trans). kind 1, a LoRA cotangent: out (K, R)
// fp32, or (R, K) when trans, = s * A^T B for A (rows, K) and B (rows, R).
// T is fp32 (fp32 == 1) or bf16; A is T or, in bf16, fp32 (a_fp32: rounded
// to bf16 on load); B is T. part: ceil(depth / 256) * (rows or K) * R floats
// of partial slices. form 0: the rank-r kernels (rank_down_kernel,
// rank_cot_kernel); 1: narrow_gemm, the first design. Returns a cudaError_t.
extern "C" int aiic_rank_product(const void* A, const void* B, void* out, void* part, int rows,
                                 int K, int R, int kind, int trans, int fp32, int a_fp32, float s,
                                 int form, void* stream) {
  using namespace aiic;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  float* pt = static_cast<float*>(part);
  if ((kind != 0 && kind != 1) || (form != 0 && form != 1))
    return static_cast<int>(cudaErrorInvalidValue);
  if (fp32)
    return static_cast<int>(rank_product<float>(static_cast<const float*>(A),
                                                static_cast<const float*>(B), out, pt, rows, K,
                                                R, kind, trans, s, form, st));
  if (a_fp32)
    return static_cast<int>(rank_product<bf16>(static_cast<const float*>(A),
                                               static_cast<const bf16*>(B), out, pt, rows, K, R,
                                               kind, trans, s, form, st));
  return static_cast<int>(rank_product<bf16>(static_cast<const bf16*>(A),
                                             static_cast<const bf16*>(B), out, pt, rows, K, R,
                                             kind, trans, s, form, st));
}

// The bf16 text block's core forward alone, for the card's tests and
// timing: a (B*S, W) = the core of qkv (B*S, 3W), mask (S, S) fp32. form 0:
// block_core_fwd_mma_kernel (S <= 80), 1: block_core_fwd_kernel (S <= 128).
// Returns a cudaError_t.
extern "C" int aiic_block_core_fwd(const void* qkv, const void* mask, void* out, int B, int S,
                                   int W, int H, float qconst, int form, void* stream) {
  using namespace aiic;
  const bf16* q = static_cast<const bf16*>(qkv);
  const float* m = static_cast<const float*>(mask);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (form == 0)
    return static_cast<int>(
        launch_block_core_fwd_mma(q, m, static_cast<bf16*>(out), B, S, W, H, qconst, st));
  if (form != 1 || !valid(S, W, H, 128)) return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(launch_core_fwd(q, m, static_cast<bf16*>(out), B, S, W, H, qconst, st));
}

// Blocks per SM of the text block's tensor-core core forward and rank-r
// kernels, into blocks[0..4]: the core forward; the bf16 down-projection at
// depth 512 (2 warps) and 2048 (8 warps); the bf16 and fp32 cotangent
// products. Returns a cudaError_t.
extern "C" int aiic_text_block_rank_occupancy(int* blocks) {
  return static_cast<int>(aiic::rank_occupancy(blocks));
}

// The fp32 text block's backbone product alone, for the card's tests and
// timing beside cuBLAS: C (M, N) fp32 = A (M, K) . B on sgemm_kernel for B
// (K, N), or (N, K) read transposed (trans). Needs M > 0, N % 128 == 0, K %
// 8 == 0 and 16-byte aligned rows. Returns a cudaError_t.
extern "C" int aiic_text_sgemm(const void* A, const void* B, void* C, int M, int N, int K,
                               int trans, void* stream) {
  using namespace aiic;
  if (M <= 0 || N <= 0 || K <= 0 || N % kSgBN || K % kSgBK)
    return static_cast<int>(cudaErrorInvalidValue);
  const float* a = static_cast<const float*>(A);
  const float* b = static_cast<const float*>(B);
  float* c = static_cast<float*>(C);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  return static_cast<int>(trans ? text_sgemm<true>(a, b, c, M, N, K, st)
                                : text_sgemm<false>(a, b, c, M, N, K, st));
}
