// The GEMM stage of rows 1-5 and 10 alone (wgmma_serving_gemm.cuh, or the
// WMMA gemm_kernel of common.cuh it replaced), with one of the seven
// epilogues those rows run, so that a test and chip_smoke.py can hold each
// product against its plain version and time it beside torch._int_mm and
// torch.matmul. Replaces no TPU kernel of its own: it is the product stage
// of aiic_tpu/ops/quant.py::_int8_attn_kernel, _int8_mlp_kernel_3d and
// _int8_mlp_chunk_kernel (and so of the int8_block kernels), and of
// aiic_tpu/ops/attention.py::_ln_qkv_attention_kernel and
// aiic_tpu/ops/mlp.py::_mlp_kernel. The plain PyTorch version is
// aiic_tpu_torch/ops/quant.py::gemm_stage_ref.

#include "wgmma_serving_gemm.cuh"

namespace {

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
// form 0 (the wgmma stage): an int8 w is w^T (N, K), a bf16 one (K, N);
// form 1 (the WMMA gemm_kernel): w is (K, N). rs, cs, x unused where the
// epilogue reads none. Needs N % 128 == 0 and K % 128 (int8) or 64 (bf16)
// == 0, for chunk_residual K / n_chunks % 128 == 0. Returns a cudaError_t.
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
