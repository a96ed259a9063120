// The MLP-half variants of tools/kernel_experiments{,3}.py for Hopper: the
// TPU functions mlp_var of kernel_experiments.py (_mlp_kernel_var, run with
// static_scale=True) and mlp_var of kernel_experiments3.py (make_kernel:
// nogelu, noln, noq, maconly, macbf16, q2bf16, gelu2, gelubf16). Plain
// PyTorch versions: aiic_tpu_torch/probes/variants.py (mlp_var_ref,
// mlp_var3_ref).
//
// One C entry takes the variant's id and its form. Form 0, the route, is
// mlp_variants_wgmma.cu: every product on the wgmma + TMA GEMM stage, as row
// 2 runs today. Form 1, kept here for the side-by-side time, is the first
// design: row 2's sequence on common.cuh's WMMA gemm_kernel with the
// variant's pieces in place (int8_halves.cuh):
//   (a) row pass: LN2 (or none: noln) and the per-row int8 quantizer; the
//       fixed scale 6/127 multiplied by its reciprocal (static); LN2 rounded
//       to bf16 (noq); a constant 3 (maconly); none (macbf16 takes x);
//   (b) the first product, int8 or bf16 on the tensor cores, its epilogue
//       y = acc*hscale*s1 + b1 (int8) or acc [+ b1] (bf16), the variant's
//       gelu (y*sigmoid(1.702y) as 1/(1 + exp(-z)), the exp2 gelu, the gelu
//       rounded to bf16 op by op, or none), stored fp32 for the per-row
//       quantizer, bf16 for a bf16 second product, or int8 quantized with
//       the fixed reciprocal of 30/127 (static); maconly: clip(acc) in int8;
//   (c) the per-row quantizer of y where the variant has one;
//   (d) the second product with its residual epilogue: acc*yscale*s2 + b2
//       (int8, the scale per row or fixed), acc + b2 (bf16), or
//       bf16(x + f32(acc)) (maconly, macbf16).
//
// What bounds it on the H100: as row 2 (int8_mlp.cu), the two products on
// the tensor cores, compute-bound at B=256; the row passes move the fp32
// hidden activation (rows x 4W) through device memory. The static variant
// keeps that round trip out in both forms: with a fixed scale the gelu
// epilogue writes int8 directly, which is the pass the TPU experiment
// priced.

#include "int8_halves.cuh"
#include "variants.cuh"

// x (rows,W) bf16; ln_s, ln_b (W) f32; w1_q (W,M) int8 and its K-major copy
// w1_t (M,W); s1, b1 (M) f32; w2_q (M,W) int8 and w2_t (W,M); s2, b2 (W)
// f32; w1 (W,M), w2 (M,W) bf16; out (rows,W) bf16. Scratch: hq (rows,W)
// int8, hb (rows,W) bf16, hs (rows) f32, y (rows,M) f32, yb (rows,M) bf16,
// yq (rows,M) int8, ys (rows) f32. form 0 (mlp_variants_wgmma.cu: reads
// w1_t and w2_t) or 1 (here: reads w1_q and w2_q). Needs W and M multiples
// of 128. Returns a cudaError_t.
extern "C" int aiic_mlp_variant(
    int variant, const void* x, const void* ln_s, const void* ln_b, const void* w1_q,
    const void* w1_t, const void* s1, const void* b1, const void* w2_q, const void* w2_t,
    const void* s2, const void* b2, const void* w1, const void* w2, void* out, void* hq, void* hb,
    void* hs, void* y, void* yb, void* yq, void* ys, int rows, int W, int M, float eps, int form,
    void* stream) {
  using namespace aiic;
  if (form == 0)
    return aiic_mlp_variant_wgmma(variant, x, ln_s, ln_b, w1_t, s1, b1, w2_t, s2, b2, w1, w2, out,
                                  hq, hb, hs, y, yb, yq, ys, rows, W, M, eps, stream);
  if (form != 1) return cudaErrorInvalidValue;
  auto f = [](const void* p) { return static_cast<const float*>(p); };
  const auto st = static_cast<cudaStream_t>(stream);
  const auto xb = static_cast<const bf16*>(x);
  const auto w1q = static_cast<const int8_t*>(w1_q);
  const auto w2q = static_cast<const int8_t*>(w2_q);
  const auto w1b = static_cast<const bf16*>(w1);
  const auto w2b = static_cast<const bf16*>(w2);
  auto o = static_cast<bf16*>(out);
  auto hq8 = static_cast<int8_t*>(hq);
  auto hsf = static_cast<float*>(hs);
  auto yq8 = static_cast<int8_t*>(yq);
  auto ybb = static_cast<bf16*>(yb);
  if (variant < 0 || variant >= kNumMlpVariants || W % kBN || M % kBN) return cudaErrorInvalidValue;
  // The variants whose both products are int8 with per-row scales: row 2's
  // sequence (int8_mlp_half, C = 1) with LN2 or not and the variant's gelu.
  const auto rr = [&](auto ln, auto gelu) {
    return int8_mlp_half<decltype(ln)::value, decltype(gelu)::value>(
        xb, Int8Mlp{f(ln_s), f(ln_b), w1q, f(s1), f(b1), w2q, f(s2), f(b2)}, o,
        MlpScratch{hq8, hsf, static_cast<float*>(y), yq8, static_cast<float*>(ys), nullptr},
        rows, W, M, 1, eps, st);
  };
  using LN = std::true_type;
  using NoLN = std::false_type;
  switch (variant) {
    case kMlpNoGelu: return rr(LN{}, std::integral_constant<Gelu, Gelu::kNone>{});
    case kMlpNoLn: return rr(NoLN{}, std::integral_constant<Gelu, Gelu::kSigmoid>{});
    case kGelu2: return rr(LN{}, std::integral_constant<Gelu, Gelu::kExp2>{});  // row 2's gelu
    case kGeluBf16: return rr(LN{}, std::integral_constant<Gelu, Gelu::kBf16>{});
    case kStatic:
      AIIC_CHECK(launch_rowquant_var<RowQuant::kStatic>(xb, f(ln_s), f(ln_b), hq8, nullptr,
                                                        nullptr, rows, W, eps, st, kStaticH));
      AIIC_CHECK(launch_gemm(static_cast<const int8_t*>(hq8), w1q, rows, M, W,
                             EpiMlp1<Gelu::kSigmoid, YOut::kInt8Static>{
                                 nullptr, kStaticH, f(s1), f(b1), yq8, 1.0f / kStaticY, M},
                             st));
      return launch_gemm(static_cast<const int8_t*>(yq8), w2q, rows, W, M,
                         EpiResidualStatic{kStaticY, f(s2), f(b2), xb, o, W}, st);
    case kQ2Bf16:
      AIIC_CHECK((launch_rowquant<true, bf16>(xb, f(ln_s), f(ln_b), hq8, hsf, rows, W, eps, st)));
      AIIC_CHECK(launch_gemm(static_cast<const int8_t*>(hq8), w1q, rows, M, W,
                             EpiMlp1<Gelu::kSigmoid, YOut::kBf16>{hsf, 0.f, f(s1), f(b1), ybb,
                                                                  0.f, M},
                             st));
      return launch_gemm(static_cast<const bf16*>(ybb), w2b, rows, W, M,
                         EpiOutProj{f(b2), xb, o, W}, st);
    case kNoQ: {
      auto hbb = static_cast<bf16*>(hb);
      AIIC_CHECK(launch_ln_rows(xb, f(ln_s), f(ln_b), hbb, rows, W, eps, st));
      AIIC_CHECK(launch_gemm(static_cast<const bf16*>(hbb), w1b, rows, M, W,
                             EpiMlp1<Gelu::kSigmoid, YOut::kBf16>{nullptr, 0.f, nullptr, f(b1),
                                                                  ybb, 0.f, M},
                             st));
      return launch_gemm(static_cast<const bf16*>(ybb), w2b, rows, W, M,
                         EpiOutProj{f(b2), xb, o, W}, st);
    }
    case kMlpMacOnly:
      AIIC_CHECK(fill_int8(hq8, static_cast<size_t>(rows) * W, 3, st));
      AIIC_CHECK(launch_gemm(static_cast<const int8_t*>(hq8), w1q, rows, M, W, EpiClip8{yq8, M},
                             st));
      return launch_gemm(static_cast<const int8_t*>(yq8), w2q, rows, W, M, EpiAddRaw{xb, o, W}, st);
    case kMacBf16:
      AIIC_CHECK(launch_gemm(xb, w1b, rows, M, W,
                             EpiMlp1<Gelu::kNone, YOut::kBf16>{nullptr, 0.f, nullptr, nullptr,
                                                               ybb, 0.f, M},
                             st));
      return launch_gemm(static_cast<const bf16*>(ybb), w2b, rows, W, M, EpiAddRaw{xb, o, W}, st);
    default: return cudaErrorInvalidValue;
  }
}
