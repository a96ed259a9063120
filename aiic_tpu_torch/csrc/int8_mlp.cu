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
// Launches on the caller's stream. Form 0, the route (int8_mlp_half_wgmma,
// wgmma_serving_gemm.cuh):
//   (a) rowquant_kernel<LN>: LN2 in fp32 + per-row int8 quantization;
//   (b) wgmma_stage_kernel<int8_t, EpiGelu>: hq @ w1_q on the int8 tensor
//       cores through TMA and wgmma (w1^T, K-major), epilogue y =
//       acc*hscale*s1 + b1, then y * 1/(1 + exp2(-1.702 log2(e) y)), stored
//       fp32 (rows, 4W);
//   (c) rowquant_kernel<no LN>: y quantized per row (full mode) or per
//       (row, chunk) over the (rows*C, 4W/C) matrix it is in memory
//       (chunked);
//   (d) full mode: wgmma_stage_kernel<int8_t, EpiResidual>: yq @ w2_q
//       (w2^T), epilogue acc*yscale*s2, then + b2, then + x, then bf16 (the
//       order of _int8_mlp_rows); chunked: wgmma_stage_kernel<int8_t,
//       EpiChunkResidual>, the TPU kernel's fold: each thread's fp32 running
//       total of its fragment, seeded with x, takes acc_c*yscale[r, c]*s2 at
//       the end of each chunk's 4W/C-deep slice of the depth (a whole
//       number of 128-B K-slices), b2 last, then bf16.
// The int8 products are exact in int32 and the epilogues are the WMMA
// form's expressions in its order, so form 0 gives form 1's bits.
// Form 1 (int8_mlp_half, int8_halves.cuh), the first design, runs (b) and
// (d) on common.cuh's WMMA gemm_kernel; chunked, its (d) splits the depth
// by chunk across blockIdx.z, each split's acc*yscale[r, c]*s2 into its own
// fp32 slice, and (e) sums x + slice 0 + ... + slice C-1 + b2 in that
// order, then bf16. It stays for the side-by-side time and the bit-for-bit
// check.
//
// What bounds it on the H100: at B=256 the two int8 products are
// 2 * rows x W x 4W MACs (50k rows x 768 at B/16, 66k x 1024 at L/14),
// compute-bound on the int8 tensor cores; the row passes are
// bandwidth-bound.
//
// What the design gives up: the fp32 hidden activation (rows x 4W, 620 MB
// at B/16 B=256, 1.1 GB at L/14) makes a round trip through device memory
// because the row quantization of y needs each row's (or chunk's) amax
// before the second product can start. The fold keeps the chunked plan's
// partial sums in registers, at one block an SM for c_proj.

#include "wgmma_serving_gemm.cuh"

namespace {

aiic::Int8Mlp mlp_args(const void* ln_s, const void* ln_b, const void* w1_q, const void* s1,
                       const void* b1, const void* w2_q, const void* s2, const void* b2) {
  auto f = [](const void* p) { return static_cast<const float*>(p); };
  auto q = [](const void* p) { return static_cast<const int8_t*>(p); };
  return {f(ln_s), f(ln_b), q(w1_q), f(s1), f(b1), q(w2_q), f(s2), f(b2)};
}

}  // namespace

// x (rows,W) bf16; ln_s, ln_b (W) f32; w1_q (W,M) int8 and its K-major copy
// w1_t (M,W); s1, b1 (M) f32; w2_q (M,W) int8 and w2_t (W,M); s2, b2 (W)
// f32; out (rows,W) bf16. Scratch: hq (rows,W) int8, hs (rows) f32, y
// (rows,M) f32, yq (rows,M) int8, ys (rows) f32. form 0: the wgmma stage
// (reads w1_t, w2_t); 1: the WMMA form (reads w1_q, w2_q). Needs W and M
// multiples of 128. Returns a cudaError_t.
extern "C" int aiic_int8_ln_mlp(
    const void* x, const void* ln_s, const void* ln_b, const void* w1_q, const void* w1_t,
    const void* s1, const void* b1, const void* w2_q, const void* w2_t, const void* s2,
    const void* b2, void* out, void* hq, void* hs, void* y, void* yq, void* ys, int rows, int W,
    int M, float eps, int form, void* stream) {
  using namespace aiic;
  const MlpScratch s{static_cast<int8_t*>(hq), static_cast<float*>(hs), static_cast<float*>(y),
                     static_cast<int8_t*>(yq), static_cast<float*>(ys), nullptr};
  const Int8Mlp m = mlp_args(ln_s, ln_b, w1_q, s1, b1, w2_q, s2, b2);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (form == 0) {
    if (!w1_t || !w2_t) return static_cast<int>(cudaErrorInvalidValue);
    return int8_mlp_half_wgmma(static_cast<const bf16*>(x), m, static_cast<const int8_t*>(w1_t),
                               static_cast<const int8_t*>(w2_t), static_cast<bf16*>(out), s, rows,
                               W, M, 1, eps, st);
  }
  if (form != 1) return static_cast<int>(cudaErrorInvalidValue);
  return int8_mlp_half(static_cast<const bf16*>(x), m, static_cast<bf16*>(out), s, rows, W, M, 1,
                       eps, st);
}

// As aiic_int8_ln_mlp with the hidden axis in n_chunks >= 2 chunks: ys is
// (rows, n_chunks) f32; part (n_chunks, rows, W) f32, read by form 1 only.
// form 0 needs M / n_chunks a multiple of 128 (a whole number of c_proj's
// 128-B K-slices), form 1 of 32. Returns a cudaError_t.
extern "C" int aiic_int8_ln_mlp_chunked(
    const void* x, const void* ln_s, const void* ln_b, const void* w1_q, const void* w1_t,
    const void* s1, const void* b1, const void* w2_q, const void* w2_t, const void* s2,
    const void* b2, void* out, void* hq, void* hs, void* y, void* yq, void* ys, void* part,
    int rows, int W, int M, int n_chunks, float eps, int form, void* stream) {
  using namespace aiic;
  if (n_chunks < 2) return static_cast<int>(cudaErrorInvalidValue);
  const MlpScratch s{static_cast<int8_t*>(hq), static_cast<float*>(hs), static_cast<float*>(y),
                     static_cast<int8_t*>(yq), static_cast<float*>(ys), static_cast<float*>(part)};
  const Int8Mlp m = mlp_args(ln_s, ln_b, w1_q, s1, b1, w2_q, s2, b2);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (form == 0) {
    if (!w1_t || !w2_t) return static_cast<int>(cudaErrorInvalidValue);
    return int8_mlp_half_wgmma(static_cast<const bf16*>(x), m, static_cast<const int8_t*>(w1_t),
                               static_cast<const int8_t*>(w2_t), static_cast<bf16*>(out), s, rows,
                               W, M, n_chunks, eps, st);
  }
  if (form != 1 || !part) return static_cast<int>(cudaErrorInvalidValue);
  return int8_mlp_half(static_cast<const bf16*>(x), m, static_cast<bf16*>(out), s, rows, W, M,
                       n_chunks, eps, st);
}
