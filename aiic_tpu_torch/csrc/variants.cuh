// What the two forms of the kernel-experiment variants (rows 15-16 of the
// TPU kernel table) share: the variant ids of aiic_tpu_torch/probes/
// variants.py, the attention core's flags and block schedules, the MLP's
// fixed scales, and the form 0 entries (attn_variants_wgmma.cu,
// mlp_variants_wgmma.cu) that the C entries (attn_variants.cu,
// mlp_variants.cu) call for form 0. Form 1, the first design, stays in the
// C entries' files.

#pragma once

#include "common.cuh"

namespace aiic {
namespace {

// The core of a variant: exp2 with q rounded to bf16 after q*bf16(scale log2
// e), or exp with the scores scaled after the dot; the clamp; the
// denominator folded after p@v, or p divided by its sum before p@v; p = s
// (no softmax); int8 Q.K^T and/or p@v.
template <bool kExp2_, bool kClamp_, bool kFold_, bool kSoftmax_, bool kQK8_, bool kPV8_>
struct CoreFlags {
  static constexpr bool kExp2 = kExp2_, kClamp = kClamp_, kFold = kFold_, kSoftmax = kSoftmax_,
                        kQK8 = kQK8_, kPV8 = kPV8_;
};
//                     exp2   clamp  fold   softmax qk8    pv8
using CoreNomax = CoreFlags<false, false, false, true, false, false>;
using CoreExpFold = CoreFlags<false, true, true, true, false, false>;    // v1
using CoreExp2Div = CoreFlags<true, true, false, true, false, false>;    // v2
using CoreExp2Fold = CoreFlags<true, true, true, true, false, false>;   // v3, row 1
using CoreExpDiv = CoreFlags<false, true, false, true, false, false>;   // v4
using CoreNoSm = CoreFlags<true, false, true, false, false, false>;
using CoreQK8 = CoreFlags<true, false, true, true, true, false>;
using CorePV8 = CoreFlags<true, false, true, true, false, true>;
using CoreBoth8 = CoreFlags<true, false, true, true, true, true>;

// The block schedules of kernel_experiments5.py: per (image, head, query
// tile) (row 1's), per (head, image pair), all heads of one image, all heads
// of an image pair.
enum class Sched { kHead, kGBatch, kHStack, kHG };

struct CoreArgs {
  const bf16* qkv;  // (B*S, 3W), columns [Q | K | V]
  void* out;        // (B*S, W), fp32 or bf16
  int S, W, H;
  float qconst;  // bf16(scale * log2 e): q * qconst for exp2
  float sconst;  // fp32(scale * log2 e): int8 Q.K^T's dequant
  float scale;   // scale = 1/sqrt(64), after the dot for exp
  float clamp;
  // Form 0's int8 cores: K and V quantized once per (image, head) by a
  // pre-pass, each (image, head) padded to s_pad = 64 ceil(S/64) keys with
  // zeros: k8 (B*H, s_pad, 64) with ks (B*H, s_pad) the key rows' scales;
  // vt (B*H, 64, s_pad), V transposed, with vs (B*H, 64) the channels'.
  int8_t* k8;
  float* ks;
  int8_t* vt;
  float* vs;
  int s_pad;
};

constexpr float kClamp70e2 = kExp2Clamp;
constexpr float kClamp80e2 = static_cast<float>(80.0 * 1.4426950408889634);

// The variant ids of aiic_tpu_torch/probes/variants.py ATTN_VARIANTS.
enum AttnVariantId {
  kNomax, kV1, kV2, kV3, kV4, kNoLn, kNoSm, kNoCore, kMacOnly, kQoBf16, kGBatch, kHStack, kHG,
  kCoreQK, kCorePV, kCoreBoth, kNumAttnVariants
};

// The variant ids of aiic_tpu_torch/probes/variants.py MLP_VARIANTS.
enum MlpVariantId {
  kStatic, kMlpNoGelu, kMlpNoLn, kNoQ, kMlpMacOnly, kMacBf16, kQ2Bf16, kGelu2, kGeluBf16,
  kNumMlpVariants
};

constexpr float kStaticH = static_cast<float>(6.0 / 127.0);
constexpr float kStaticY = static_cast<float>(30.0 / 127.0);

}  // namespace
}  // namespace aiic

// Form 0 of the two C entries (their arguments, with the K-major int8
// weights w^T in place of the int8 weights). Return a cudaError_t.
extern "C" int aiic_attn_variant_wgmma(
    int variant, const void* x, const void* ln_s, const void* ln_b, const void* wqkv_t,
    const void* sqkv, const void* bqkv, const void* wo_t, const void* so, const void* wo,
    const void* bo, void* out, void* hq, void* hs, void* amax, void* qkv, void* attn, void* aq,
    void* as, void* kv8, void* kvs, int B, int S, int W, int H, float eps, float qconst,
    void* stream);
extern "C" int aiic_mlp_variant_wgmma(
    int variant, const void* x, const void* ln_s, const void* ln_b, const void* w1_t,
    const void* s1, const void* b1, const void* w2_t, const void* s2, const void* b2,
    const void* w1, const void* w2, void* out, void* hq, void* hb, void* hs, void* y, void* yb,
    void* yq, void* ys, int rows, int W, int M, float eps, void* stream);
