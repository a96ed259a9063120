// Form 0 of the MLP-half variants (rows 15b and 16b of the TPU kernel
// table: mlp_var of tools/kernel_experiments.py run with static_scale=True,
// mlp_var of kernel_experiments3.py), the route of aiic_mlp_variant
// (mlp_variants.cu): row 2's current design, every product on the wgmma +
// TMA GEMM stage of wgmma_serving_gemm.cuh, with the variant's pieces.
// Plain PyTorch versions: aiic_tpu_torch/probes/variants.py (mlp_var_ref,
// mlp_var3_ref).
//
// - The variants whose two products are int8 with per-row scales (nogelu,
//   noln, gelu2, gelubf16) are row 2's sequence (int8_mlp_half_wgmma, C = 1)
//   with LN2 or not and the variant's gelu; gelu2's is row 2's own, so it
//   gives row 2's form 0 bits.
// - static: LN2 quantized with the fixed reciprocal of 6/127, then c_fc
//   whose gelu epilogue writes int8 with the fixed reciprocal of 30/127
//   (EpiMlp1<kSigmoid, kInt8Static>): the fp32 y never reaches device
//   memory, which is the round trip the TPU experiment priced; c_proj with
//   the fixed scale (EpiResidualStatic).
// - The bf16 products (noq, macbf16, q2bf16) read w1 and w2 as they lie
//   (MN-major B); the int8 ones read the K-major copies w^T, since 8-bit
//   wgmma takes a K-major B only.
// - The gelu epilogues (EpiGelu<G>, EpiMlp1) and maconly's int8 store
//   (EpiClip8) walk rows through the staged tile (StagedEpilogue); the
//   residual ones stay on the fragments, as row 2's.
//
// What bounds it on the H100 at B=256 (50,432 rows, W=768, M=3072): the two
// products, 0.160 ms of int8 operations at 1,979 TOP/s (0.320 ms for bf16
// products at 989 TFLOP/s); the stage runs them at 446-635 TOP/s
// (chip_smoke.py, NVIDIA H100 80GB HBM3 at 700 W). The int8 products sum
// exactly in int32, so a variant's bits depend only on its epilogues, which
// are form 1's.

#include "variants.cuh"
#include "wgmma_serving_gemm.cuh"

extern "C" int aiic_mlp_variant_wgmma(
    int variant, const void* x, const void* ln_s, const void* ln_b, const void* w1_t,
    const void* s1, const void* b1, const void* w2_t, const void* s2, const void* b2,
    const void* w1, const void* w2, void* out, void* hq, void* hb, void* hs, void* y, void* yb,
    void* yq, void* ys, int rows, int W, int M, float eps, void* stream) {
  using namespace aiic;
  auto f = [](const void* p) { return static_cast<const float*>(p); };
  const auto st = static_cast<cudaStream_t>(stream);
  const auto xb = static_cast<const bf16*>(x);
  const auto w1q = static_cast<const int8_t*>(w1_t);
  const auto w2q = static_cast<const int8_t*>(w2_t);
  const auto w1b = static_cast<const bf16*>(w1);
  const auto w2b = static_cast<const bf16*>(w2);
  auto o = static_cast<bf16*>(out);
  auto hq8 = static_cast<int8_t*>(hq);
  auto hsf = static_cast<float*>(hs);
  auto yq8 = static_cast<int8_t*>(yq);
  auto ybb = static_cast<bf16*>(yb);
  if (variant < 0 || variant >= kNumMlpVariants || rows <= 0 || W % kSBN || M % kSBN)
    return cudaErrorInvalidValue;
  const int8_t* hqc = hq8;
  const int8_t* yqc = yq8;
  const bf16* ybc = ybb;
  // Row 2's sequence with LN2 or not and the variant's gelu.
  const auto rr = [&](auto ln, auto gelu) {
    return int8_mlp_half_wgmma<decltype(ln)::value, decltype(gelu)::value>(
        xb, Int8Mlp{f(ln_s), f(ln_b), nullptr, f(s1), f(b1), nullptr, f(s2), f(b2)}, w1q, w2q, o,
        MlpScratch{hq8, hsf, static_cast<float*>(y), yq8, static_cast<float*>(ys), nullptr}, rows,
        W, M, 1, eps, st);
  };
  using LN = std::true_type;
  using NoLN = std::false_type;
  switch (variant) {
    case kMlpNoGelu: return rr(LN{}, std::integral_constant<Gelu, Gelu::kNone>{});
    case kMlpNoLn: return rr(NoLN{}, std::integral_constant<Gelu, Gelu::kSigmoid>{});
    case kGelu2: return rr(LN{}, std::integral_constant<Gelu, Gelu::kExp2>{});  // row 2 itself
    case kGeluBf16: return rr(LN{}, std::integral_constant<Gelu, Gelu::kBf16>{});
    case kStatic:
      AIIC_CHECK(launch_rowquant_var<RowQuant::kStatic>(xb, f(ln_s), f(ln_b), hq8, nullptr,
                                                        nullptr, rows, W, eps, st, kStaticH));
      AIIC_CHECK(launch_wgmma_stage(hqc, w1q, rows, M, W,
                                    EpiMlp1<Gelu::kSigmoid, YOut::kInt8Static>{
                                        nullptr, kStaticH, f(s1), f(b1), yq8, 1.0f / kStaticY, M},
                                    st));
      return launch_wgmma_stage(yqc, w2q, rows, W, M,
                                EpiResidualStatic{kStaticY, f(s2), f(b2), xb, o, W}, st);
    case kQ2Bf16:
      AIIC_CHECK((launch_rowquant<true, bf16>(xb, f(ln_s), f(ln_b), hq8, hsf, rows, W, eps, st)));
      AIIC_CHECK(launch_wgmma_stage(
          hqc, w1q, rows, M, W,
          EpiMlp1<Gelu::kSigmoid, YOut::kBf16>{hsf, 0.f, f(s1), f(b1), ybb, 0.f, M}, st));
      return launch_wgmma_stage(ybc, w2b, rows, W, M, EpiOutProj{f(b2), xb, o, W}, st);
    case kNoQ: {
      auto hbb = static_cast<bf16*>(hb);
      AIIC_CHECK(launch_ln_rows(xb, f(ln_s), f(ln_b), hbb, rows, W, eps, st));
      AIIC_CHECK(launch_wgmma_stage(
          static_cast<const bf16*>(hbb), w1b, rows, M, W,
          EpiMlp1<Gelu::kSigmoid, YOut::kBf16>{nullptr, 0.f, nullptr, f(b1), ybb, 0.f, M}, st));
      return launch_wgmma_stage(ybc, w2b, rows, W, M, EpiOutProj{f(b2), xb, o, W}, st);
    }
    case kMlpMacOnly:
      AIIC_CHECK(fill_int8(hq8, static_cast<size_t>(rows) * W, 3, st));
      AIIC_CHECK(launch_wgmma_stage(hqc, w1q, rows, M, W, EpiClip8{yq8, M}, st));
      return launch_wgmma_stage(yqc, w2q, rows, W, M, EpiAddRaw{xb, o, W}, st);
    case kMacBf16:
      AIIC_CHECK(launch_wgmma_stage(
          xb, w1b, rows, M, W,
          EpiMlp1<Gelu::kNone, YOut::kBf16>{nullptr, 0.f, nullptr, nullptr, ybb, 0.f, M}, st));
      return launch_wgmma_stage(ybc, w2b, rows, W, M, EpiAddRaw{xb, o, W}, st);
    default: return cudaErrorInvalidValue;
  }
}
