// int8 MLP half-block for Hopper, full (row 2) and hidden-axis chunked (row 3):
//   out = x + deq(int8 c_proj(rowquant(gelu_exp2(deq(int8 c_fc(rowquant(LN2 x)))))))
//
// Replaces the TPU kernels aiic_tpu/ops/quant.py::_int8_mlp_kernel_3d (the
// full mode of int8_ln_mlp, math _int8_mlp_rows with n_chunks=1) and
// _int8_mlp_chunk_kernel (its chunked mode, _int8_mlp_rows with n_chunks=C:
// the gelu output quantized per (row, chunk), the c_proj partials summed in
// chunk order onto the fp32 residual, b2 last). The plain PyTorch version is
// aiic_tpu_torch/ops/quant.py::int8_ln_mlp_ref(n_chunks=C).
//
// Launches on the caller's stream (int8_mlp_half, int8_halves.cuh):
//   (a) rowquant_kernel<LN>: LN2 in fp32 + per-row int8 quantization;
//   (b) gemm_kernel<int8_t>: hq @ w1_q, epilogue y = acc*hscale*s1 + b1,
//       then y * 1/(1 + exp2(-1.702 log2(e) y)), stored fp32 (rows, 4W);
//   (c) rowquant_kernel<no LN>: y quantized per row (C = 1) or per (row,
//       chunk), as the (rows*C, 4W/C) matrix it is in memory;
//   (d) C = 1: gemm_kernel<int8_t>: yq @ w2_q, epilogue acc*yscale*s2, then
//       + b2, then + x, then bf16 (the order of _int8_mlp_rows);
//       C > 1: the same product with its depth split by chunk across
//       blockIdx.z, each split's acc*yscale[r, c]*s2 into its own fp32
//       slice, and (e) a pass summing x + slice 0 + ... + slice C-1 + b2 in
//       that order, then bf16. No atomics.
//
// What bounds it on the H100: at B=256 the two int8 products are
// 2 * rows x W x 4W MACs (50k rows x 768 at B/16, 66k x 1024 at L/14),
// compute-bound on the int8 tensor cores; the row passes and the chunk sum
// are bandwidth-bound.
//
// What the simple design gives up: the fp32 hidden activation (rows x 4W,
// 1.1 GB at L/14 B=256) makes a round trip through device memory because the
// row quantization of y needs each row's (or chunk's) amax before the second
// product can start, and the chunked plan adds C fp32 partial slices; the
// GEMM has no TMA/wgmma pipeline.

#include "int8_halves.cuh"

namespace {

aiic::Int8Mlp mlp_args(const void* ln_s, const void* ln_b, const void* w1_q, const void* s1,
                       const void* b1, const void* w2_q, const void* s2, const void* b2) {
  auto f = [](const void* p) { return static_cast<const float*>(p); };
  auto q = [](const void* p) { return static_cast<const int8_t*>(p); };
  return {f(ln_s), f(ln_b), q(w1_q), f(s1), f(b1), q(w2_q), f(s2), f(b2)};
}

}  // namespace

// x (rows,W) bf16; ln_s, ln_b (W) f32; w1_q (W,M) int8; s1, b1 (M) f32;
// w2_q (M,W) int8; s2, b2 (W) f32; out (rows,W) bf16. Scratch: hq (rows,W)
// int8, hs (rows) f32, y (rows,M) f32, yq (rows,M) int8, ys (rows) f32.
// Needs W and M multiples of 128. Returns a cudaError_t.
extern "C" int aiic_int8_ln_mlp(
    const void* x, const void* ln_s, const void* ln_b, const void* w1_q,
    const void* s1, const void* b1, const void* w2_q, const void* s2,
    const void* b2, void* out, void* hq, void* hs, void* y, void* yq, void* ys,
    int rows, int W, int M, float eps, void* stream) {
  using namespace aiic;
  const MlpScratch s{static_cast<int8_t*>(hq), static_cast<float*>(hs), static_cast<float*>(y),
                     static_cast<int8_t*>(yq), static_cast<float*>(ys), nullptr};
  return int8_mlp_half(static_cast<const bf16*>(x), mlp_args(ln_s, ln_b, w1_q, s1, b1, w2_q, s2, b2),
                       static_cast<bf16*>(out), s, rows, W, M, 1, eps,
                       static_cast<cudaStream_t>(stream));
}

// As aiic_int8_ln_mlp with the hidden axis in n_chunks >= 2 chunks: ys is
// (rows, n_chunks) f32, part (n_chunks, rows, W) f32. Needs M / n_chunks a
// multiple of 32. Returns a cudaError_t.
extern "C" int aiic_int8_ln_mlp_chunked(
    const void* x, const void* ln_s, const void* ln_b, const void* w1_q,
    const void* s1, const void* b1, const void* w2_q, const void* s2,
    const void* b2, void* out, void* hq, void* hs, void* y, void* yq, void* ys, void* part,
    int rows, int W, int M, int n_chunks, float eps, void* stream) {
  using namespace aiic;
  if (n_chunks < 2) return static_cast<int>(cudaErrorInvalidValue);
  const MlpScratch s{static_cast<int8_t*>(hq), static_cast<float*>(hs), static_cast<float*>(y),
                     static_cast<int8_t*>(yq), static_cast<float*>(ys), static_cast<float*>(part)};
  return int8_mlp_half(static_cast<const bf16*>(x), mlp_args(ln_s, ln_b, w1_q, s1, b1, w2_q, s2, b2),
                       static_cast<bf16*>(out), s, rows, W, M, n_chunks, eps,
                       static_cast<cudaStream_t>(stream));
}
