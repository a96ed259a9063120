// The GEMM stage of rows 1-5 and 10-14 alone (wgmma_serving_gemm.cuh, or
// the WMMA gemm_kernel of common.cuh it replaced), with one of the seven
// epilogues rows 1-5 and 10 run, or one of the two forms that only the text
// block's backward (rows 12 and 14) adds: the bf16 product through a weight
// read transposed (a K-major B) and the int8 chunked cotangent product with
// its chunk sums folded in. A test and chip_smoke.py hold each product
// against its plain version and time it beside torch._int_mm and
// torch.matmul. Replaces no TPU kernel of its own: it is the product stage
// of aiic_tpu/ops/quant.py::_int8_attn_kernel, _int8_mlp_kernel_3d and
// _int8_mlp_chunk_kernel (and so of the int8_block kernels), of
// aiic_tpu/ops/attention.py::_ln_qkv_attention_kernel and
// aiic_tpu/ops/mlp.py::_mlp_kernel, and of the products of
// aiic_tpu/ops/block_grad.py's text-block kernels. The plain PyTorch version
// is aiic_tpu_torch/ops/quant.py::gemm_stage_ref.

#include "wgmma_serving_gemm.cuh"

namespace {

struct EpiF32 {  // out = acc, fp32
  float* out;
  int n_cols;
  __device__ void operator()(int r, int n, float acc) const {
    out[static_cast<size_t>(r) * n_cols + n] = acc;
  }
};

template <typename T, typename Epi>
cudaError_t run(int form, const void* a, const void* w, int rows, int N, int K, Epi epi,
                cudaStream_t st) {
  using namespace aiic;
  const T* A = static_cast<const T*>(a);
  const T* B = static_cast<const T*>(w);
  if (form == 0) return launch_wgmma_stage(A, B, rows, N, K, epi, st);
  if (form != 1 || N % kBN || K % kBK) return cudaErrorInvalidValue;
  return launch_gemm(A, B, rows, N, K, epi, st);
}

}  // namespace

// C (rows, N) = a (rows, K) . w through epilogue epi:
//   0 qkv:      int8 a, out bf16 = bf16(acc * rs[r] * cs[n] + b[n])      (EpiQKV)
//   1 gelu:     int8 a, out fp32 = gelu_exp2(acc * rs[r] * cs[n] + b[n]) (EpiGelu)
//   2 residual: int8 a, out bf16 = bf16(x + (acc * rs[r] * cs[n] + b[n])) (EpiResidual)
//   3 out_proj: bf16 a, out bf16 = bf16(x + (acc + b[n]))               (EpiOutProj)
//   4 chunk_residual: int8 a, K in n_chunks chunks, rs (rows, n_chunks),
//               out bf16 = bf16((x + sum over c in order of acc_c * rs[r, c]
//               * cs[n]) + b[n]), the sums folded in the mainloop
//               (EpiChunkResidual; form 0 only)
//   5 bias:     bf16 a, out bf16 = bf16(acc + b[n])                     (EpiBiasQKV)
//   6 bias_gelu: bf16 a, out bf16 = bf16(gelu_exp2(acc + b[n]))         (EpiBiasGelu)
//   7 chunk_rowscale: int8 a, K in n_chunks chunks, rs (rows, n_chunks),
//               out fp32 = sum over c in order of acc_c * rs[r, c], from 0
//               (EpiChunkRowScale: row 14's dh2 fold without its LoRA term;
//               form 0 only)
//   8 dot_t:    bf16 a and w (N, K), out fp32 = a . w^T, w read as the
//               K-major B it is (the text block's cotangent products)
// form 0 (the wgmma stage): an int8 w is w^T (N, K), a bf16 one (K, N) (dot_t:
// (N, K)); form 1 (the WMMA gemm_kernel): w is (K, N) (dot_t: (N, K), read
// transposed). rs, cs, b, x unused where the epilogue reads none. Needs N %
// 128 == 0 and K % 128 (int8) or 64 (bf16) == 0, for the folds K / n_chunks
// % 128 == 0. Returns a cudaError_t.
extern "C" int aiic_gemm_stage(const void* a, const void* w, const void* rs, const void* cs,
                               const void* b, const void* x, void* out, int rows, int N, int K,
                               int n_chunks, int epi, int form, void* stream) {
  using namespace aiic;
  auto f = [](const void* p) { return static_cast<const float*>(p); };
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const bf16* xb = static_cast<const bf16*>(x);
  switch (epi) {
    case 0:
      return static_cast<int>(run<int8_t>(form, a, w, rows, N, K,
                                          EpiQKV{f(rs), f(cs), f(b), static_cast<bf16*>(out), N}, st));
    case 1:
      return static_cast<int>(run<int8_t>(
          form, a, w, rows, N, K, EpiGelu<Gelu::kExp2>{f(rs), f(cs), f(b), static_cast<float*>(out), N},
          st));
    case 2:
      return static_cast<int>(run<int8_t>(
          form, a, w, rows, N, K, EpiResidual{f(rs), f(cs), f(b), xb, static_cast<bf16*>(out), N},
          st));
    case 3:
      return static_cast<int>(
          run<bf16>(form, a, w, rows, N, K, EpiOutProj{f(b), xb, static_cast<bf16*>(out), N}, st));
    case 4:
      if (form != 0) return static_cast<int>(cudaErrorInvalidValue);
      return static_cast<int>(launch_wgmma_stage(
          static_cast<const int8_t*>(a), static_cast<const int8_t*>(w), rows, N, K,
          EpiChunkResidual{f(rs), f(cs), f(b), xb, static_cast<bf16*>(out), N, n_chunks}, st));
    case 5:
      return static_cast<int>(
          run<bf16>(form, a, w, rows, N, K, EpiBiasQKV{f(b), static_cast<bf16*>(out), N}, st));
    case 6:
      return static_cast<int>(
          run<bf16>(form, a, w, rows, N, K, EpiBiasGelu{f(b), static_cast<bf16*>(out), N}, st));
    case 7:
      if (form != 0) return static_cast<int>(cudaErrorInvalidValue);
      return static_cast<int>(launch_wgmma_stage(
          static_cast<const int8_t*>(a), static_cast<const int8_t*>(w), rows, N, K,
          EpiChunkRowScale<NoTail>{f(rs), NoTail{}, static_cast<float*>(out), N, n_chunks}, st));
    case 8: {
      const bf16* A = static_cast<const bf16*>(a);
      const bf16* B = static_cast<const bf16*>(w);
      const EpiF32 e{static_cast<float*>(out), N};
      if (form == 0)
        return static_cast<int>(launch_wgmma_stage<bf16, EpiF32, true>(A, B, rows, N, K, e, st));
      if (form != 1 || N % kBN || K % kBK) return static_cast<int>(cudaErrorInvalidValue);
      return static_cast<int>(launch_gemm<true>(A, B, rows, N, K, e, st));
    }
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

// Blocks of the int8 (gelu), bf16 (out_proj), folded (chunk_residual),
// bias and bias_gelu wgmma stage kernels resident on one SM into
// blocks[0..4]. Returns a cudaError_t.
extern "C" int aiic_gemm_stage_occupancy(int* blocks) {
  return static_cast<int>(aiic::wgmma_stage_occupancy(blocks));
}
