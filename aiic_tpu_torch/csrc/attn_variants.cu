// The attention-half variants of tools/kernel_experiments{,2,4,5,7}.py for
// Hopper: the TPU functions int8_attn_nomax (kernel_experiments.py,
// _nomax_kernel) and attn_var of kernel_experiments2.py (v1-v4), 4.py (noln,
// nosm, nocore, maconly, qobf16), 5.py (gbatch, hstack, hg) and 7.py
// (coreqk, corepv, coreboth). Plain PyTorch versions:
// aiic_tpu_torch/probes/variants.py (int8_attn_nomax_ref, attn_var{2,4,5,7}_ref).
//
// One C entry takes the variant's id and its form. Form 0, the route, is
// attn_variants_wgmma.cu: row 1's current design (the wgmma + TMA GEMM stage
// and a tensor-core core) with the variant's pieces. Form 1, kept here for
// the side-by-side time, is the first design: row 1's four stages on
// common.cuh's WMMA gemm_kernel with a scalar core, the variant's pieces in
// place:
//   (a) row pass: LN1 (or none: noln) and the per-row int8 quantizer, or the
//       two passes of v4's scale per image pair, or a constant 3 (maconly);
//   (b) int8 QKV product, qkv = bf16(acc*hscale*sqkv + bqkv) (v4:
//       acc*(hscale*sqkv) + bqkv; maconly: clip(acc[:, :W]) in int8);
//   (c) var_core_kernel: the core with the variant's flags, one thread per
//       query row as row 1's first core (common.cuh attn_core_kernel),
//       written fp32 where the int8 out-projection quantizes it, bf16
//       otherwise (none: nocore, maconly);
//   (d) the out-projection: int8 (the attention rows quantized per row, then
//       acc*ascale*so + bo + x), bf16 (attn @ wo + bo + x) or, for maconly,
//       bf16(x + f32(acc)).
//
// The core's flags (variants.cuh CoreFlags): exp2 with q rounded to bf16
// after q*bf16(scale log2 e), or exp with the scores scaled after the dot;
// the clamp (70, 80, 70 log2 e, 80 log2 e, or none); the denominator folded
// after p@v, or p divided by its sum before p@v; p = s (nosm); int8 Q.K^T (q
// and k rows quantized along D, s = acc * (qs * scale log2 e) * ks) and/or
// int8 p@v (p quantized along the keys, v per channel over S, o = acc * ps
// * vs). Dividing p before p@v and quantizing p need the row's sum or amax
// first, so those variants walk the keys twice, recomputing each score and
// p in the same order (the same values). The int8 products run as exact
// integer sums.
//
// The schedules of kernel_experiments5.py (the TPU batched its head dots
// three ways) are block schedules of the same per-row arithmetic: gbatch one
// block per (head, image pair), hstack one block walking all heads of one
// image, hg one block walking all heads of an image pair. K and V of one
// head (50 KB in bf16 at S=197) fill the block's shared memory, and all 12
// heads of an image (~605 KB) do not fit, so a block stages its heads in
// turn.
//
// What bounds form 1 on the H100: its products on the WMMA tile and the
// scalar core (4.3-8.4 ms at B=256 against bounds of 0.12-0.18 ms).

#include "int8_halves.cuh"
#include "variants.cuh"

namespace aiic {
namespace {

// Shared memory of one head: K, V in bf16; with int8 Q.K^T each key row's
// scale and the int8 K; with int8 p@v each channel's scale and the int8 V.
template <class C>
__host__ __device__ constexpr int core_smem_bytes(int S) {
  return 4 * S * kHeadDim + (C::kQK8 ? 4 * S + S * kHeadDim : 0) +
         (C::kPV8 ? 4 * kHeadDim + S * kHeadDim : 0);
}

template <class C>
struct HeadSmem {
  bf16* k;
  bf16* v;
  float* kscale;
  float* vscale;
  int8_t* kq;
  int8_t* vq;
  __device__ HeadSmem(unsigned char* base, int S) {
    k = reinterpret_cast<bf16*>(base);
    v = k + S * kHeadDim;
    unsigned char* p = reinterpret_cast<unsigned char*>(v + S * kHeadDim);
    kscale = reinterpret_cast<float*>(p);
    if (C::kQK8) p += 4 * S;
    vscale = reinterpret_cast<float*>(p);
    if (C::kPV8) p += 4 * kHeadDim;
    kq = reinterpret_cast<int8_t*>(p);
    if (C::kQK8) p += S * kHeadDim;
    vq = reinterpret_cast<int8_t*>(p);
  }
};

// K and V of head h of the image at row0 into shared memory, quantized where
// the variant asks: each key row as _row_quant (scale max(amax, 1e-6)/127,
// clip), each channel of v as max|v|/127 + 1e-12 with no clip.
template <class C>
__device__ void stage_head(const bf16* __restrict__ qkv, size_t row0, int h, int S, int W,
                           const HeadSmem<C>& sm) {
  constexpr int kVec = 8;  // bf16 per 16-byte load
  const size_t ld = 3 * static_cast<size_t>(W);
  for (int idx = threadIdx.x; idx < S * (kHeadDim / kVec); idx += kCoreThreads) {
    const int s = idx / (kHeadDim / kVec), d = (idx % (kHeadDim / kVec)) * kVec;
    const size_t at = (row0 + s) * ld + h * kHeadDim + d;
    *reinterpret_cast<uint4*>(sm.k + s * kHeadDim + d) = *reinterpret_cast<const uint4*>(qkv + at + W);
    *reinterpret_cast<uint4*>(sm.v + s * kHeadDim + d) =
        *reinterpret_cast<const uint4*>(qkv + at + 2 * W);
  }
  if constexpr (C::kQK8 || C::kPV8) {
    __syncthreads();
    if constexpr (C::kQK8) {
      for (int j = threadIdx.x; j < S; j += kCoreThreads) {
        const bf16* kr = sm.k + j * kHeadDim;
        float amax = 0.f;
        for (int d = 0; d < kHeadDim; ++d) amax = fmaxf(amax, fabsf(__bfloat162float(kr[d])));
        const float sc = fmaxf(amax, 1e-6f) / 127.0f;
        sm.kscale[j] = sc;
        for (int d = 0; d < kHeadDim; ++d)
          sm.kq[j * kHeadDim + d] = static_cast<int8_t>(
              fminf(fmaxf(rintf(__bfloat162float(kr[d]) / sc), -127.f), 127.f));
      }
    }
    if constexpr (C::kPV8) {
      for (int d = threadIdx.x; d < kHeadDim; d += kCoreThreads) {
        float amax = 0.f;
        for (int j = 0; j < S; ++j) amax = fmaxf(amax, fabsf(__bfloat162float(sm.v[j * kHeadDim + d])));
        sm.vscale[d] = amax / 127.0f + 1e-12f;
      }
      __syncthreads();
      for (int idx = threadIdx.x; idx < S * kHeadDim; idx += kCoreThreads)
        sm.vq[idx] = static_cast<int8_t>(rintf(__bfloat162float(sm.v[idx]) / sm.vscale[idx % kHeadDim]));
    }
  }
}

// One query row qi of head h: the variant's scores, p, and the head's slice
// of the output row.
template <class C, typename TO>
__device__ void core_row(const CoreArgs& a, size_t row0, int qi, int h, const HeadSmem<C>& sm) {
  const int S = a.S;
  const bf16* qrow = a.qkv + (row0 + qi) * 3 * static_cast<size_t>(a.W) + h * kHeadDim;
  float q[kHeadDim];
#pragma unroll
  for (int d = 0; d < kHeadDim; d += 2) {
    const float2 v = load2<bf16>(qrow + d);
    q[d] = v.x;
    q[d + 1] = v.y;
  }
  float qsc = 0.f;
  if constexpr (C::kQK8) {
    float amax = 0.f;
#pragma unroll
    for (int d = 0; d < kHeadDim; ++d) amax = fmaxf(amax, fabsf(q[d]));
    const float qs = fmaxf(amax, 1e-6f) / 127.0f;
#pragma unroll
    for (int d = 0; d < kHeadDim; ++d) q[d] = fminf(fmaxf(rintf(q[d] / qs), -127.f), 127.f);
    qsc = qs * a.sconst;
  } else if constexpr (C::kExp2) {
#pragma unroll
    for (int d = 0; d < kHeadDim; ++d) q[d] = round_as<bf16>(q[d] * a.qconst);
  }

  auto score = [&](int j) -> float {
    float s = 0.f;
    if constexpr (C::kQK8) {  // integer products, exact in fp32 (|s| <= 64 * 127^2 < 2^24)
      const int8_t* kr = sm.kq + j * kHeadDim;
#pragma unroll
      for (int d = 0; d < kHeadDim; ++d) s = fmaf(q[d], static_cast<float>(kr[d]), s);
      return s * qsc * sm.kscale[j];
    } else {
      const bf16* kr = sm.k + j * kHeadDim;
#pragma unroll
      for (int d = 0; d < kHeadDim; d += 2) {
        const float2 kv = load2<bf16>(kr + d);
        s = fmaf(q[d], kv.x, s);
        s = fmaf(q[d + 1], kv.y, s);
      }
      if constexpr (!C::kExp2) s = s * a.scale;
      return s;
    }
  };
  auto prob = [&](float s) -> float {
    if constexpr (!C::kSoftmax) return s;
    if constexpr (C::kClamp) s = fminf(s, a.clamp);
    if constexpr (C::kExp2) return exp2f(s);
    return expf(s);
  };

  TO* dst = static_cast<TO*>(a.out) + (row0 + qi) * a.W + h * kHeadDim;
  if constexpr (C::kPV8) {
    float l = 0.f, amax = 0.f;
    for (int j = 0; j < S; ++j) {
      const float p = prob(score(j));
      l += p;
      amax = fmaxf(amax, fabsf(p));
    }
    const float ps = fmaxf(amax, 1e-6f) / 127.0f;
    int acc[kHeadDim];
#pragma unroll
    for (int d = 0; d < kHeadDim; ++d) acc[d] = 0;
    for (int j = 0; j < S; ++j) {
      const int pq = static_cast<int>(fminf(fmaxf(rintf(prob(score(j)) / ps), -127.f), 127.f));
      const int8_t* vr = sm.vq + j * kHeadDim;
#pragma unroll
      for (int d = 0; d < kHeadDim; ++d) acc[d] += pq * static_cast<int>(vr[d]);
    }
    const float inv = 1.0f / l;
#pragma unroll
    for (int d = 0; d < kHeadDim; d += 2)
      store2<TO>(dst + d, static_cast<float>(acc[d]) * ps * sm.vscale[d] * inv,
                 static_cast<float>(acc[d + 1]) * ps * sm.vscale[d + 1] * inv);
  } else {
    float o[kHeadDim];
#pragma unroll
    for (int d = 0; d < kHeadDim; ++d) o[d] = 0.f;
    float l = 0.f;
    if constexpr (!C::kFold)
      for (int j = 0; j < S; ++j) l += prob(score(j));
    for (int j = 0; j < S; ++j) {
      float p = prob(score(j));
      if constexpr (C::kFold) {
        l += p;
      } else {
        p = p / l;
      }
      const float pb = round_as<bf16>(p);
      const bf16* vr = sm.v + j * kHeadDim;
#pragma unroll
      for (int d = 0; d < kHeadDim; d += 2) {
        const float2 vv = load2<bf16>(vr + d);
        o[d] = fmaf(pb, vv.x, o[d]);
        o[d + 1] = fmaf(pb, vv.y, o[d + 1]);
      }
    }
    if constexpr (C::kFold) {
      const float inv = C::kSoftmax ? 1.0f / l : 1.0f;
#pragma unroll
      for (int d = 0; d < kHeadDim; d += 2) store2<TO>(dst + d, o[d] * inv, o[d + 1] * inv);
    } else {
#pragma unroll
      for (int d = 0; d < kHeadDim; d += 2) store2<TO>(dst + d, o[d], o[d + 1]);
    }
  }
}

// Units of work per block, by schedule: (image, head) pairs, each staged in
// turn; the per-head schedule takes one query tile, the others all of them.
// A kernel of its own rather than more flags on common.cuh's
// attn_core_kernel: the probes' flags (exp, clamp, divide, int8 products,
// schedules) would make the production core that rows 1, 5-8 launch branch
// for them.
template <class C, typename TO, Sched kS>
__global__ void __launch_bounds__(kCoreThreads) var_core_kernel(CoreArgs a) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const HeadSmem<C> sm(smem_raw, a.S);
  const int n_tiles = (a.S + kCoreThreads - 1) / kCoreThreads;
  const int n_units = kS == Sched::kHead ? 1 : kS == Sched::kGBatch ? 2
                      : kS == Sched::kHStack ? a.H : 2 * a.H;
  const int t0 = kS == Sched::kHead ? blockIdx.x : 0;
  const int t1 = kS == Sched::kHead ? t0 + 1 : n_tiles;
  for (int u = 0; u < n_units; ++u) {
    int img, h;
    if constexpr (kS == Sched::kHead) {
      img = blockIdx.z, h = blockIdx.y;
    } else if constexpr (kS == Sched::kGBatch) {
      img = 2 * blockIdx.y + u, h = blockIdx.x;
    } else if constexpr (kS == Sched::kHStack) {
      img = blockIdx.x, h = u;
    } else {
      img = 2 * blockIdx.x + u % 2, h = u / 2;
    }
    const size_t row0 = static_cast<size_t>(img) * a.S;
    __syncthreads();  // the previous unit's rows are done with shared memory
    stage_head<C>(a.qkv, row0, h, a.S, a.W, sm);
    __syncthreads();
    for (int t = t0; t < t1; ++t) {
      const int qi = t * kCoreThreads + threadIdx.x;
      if (qi < a.S) core_row<C, TO>(a, row0, qi, h, sm);
    }
  }
}

template <class C, typename TO, Sched kS = Sched::kHead>
cudaError_t launch_var_core(const CoreArgs& a, int B, cudaStream_t st) {
  const int smem = core_smem_bytes<C>(a.S);
  if (smem > kMaxDynamicSmem || ((kS == Sched::kGBatch || kS == Sched::kHG) && B % 2))
    return cudaErrorInvalidValue;
  AIIC_CHECK(cudaFuncSetAttribute(var_core_kernel<C, TO, kS>,
                                  cudaFuncAttributeMaxDynamicSharedMemorySize, smem));
  const dim3 grid = kS == Sched::kHead ? dim3((a.S + kCoreThreads - 1) / kCoreThreads, a.H, B)
                    : kS == Sched::kGBatch ? dim3(a.H, B / 2)
                    : kS == Sched::kHStack ? dim3(B) : dim3(B / 2);
  var_core_kernel<C, TO, kS><<<grid, kCoreThreads, smem, st>>>(a);
  return cudaGetLastError();
}

cudaError_t run_core(int variant, CoreArgs a, int B, cudaStream_t st) {
  switch (variant) {
    case kNomax: return launch_var_core<CoreNomax, float>(a, B, st);
    case kV1: a.clamp = 70.0f; return launch_var_core<CoreExpFold, float>(a, B, st);
    case kV2: a.clamp = kClamp80e2; return launch_var_core<CoreExp2Div, float>(a, B, st);
    case kV3:
    case kNoLn: a.clamp = kClamp70e2; return launch_var_core<CoreExp2Fold, float>(a, B, st);
    case kV4: a.clamp = 80.0f; return launch_var_core<CoreExpDiv, float>(a, B, st);
    case kNoSm: return launch_var_core<CoreNoSm, float>(a, B, st);
    case kQoBf16: a.clamp = kClamp70e2; return launch_var_core<CoreExp2Fold, bf16>(a, B, st);
    case kGBatch:
      a.clamp = kClamp70e2;
      return launch_var_core<CoreExp2Fold, bf16, Sched::kGBatch>(a, B, st);
    case kHStack:
      a.clamp = kClamp70e2;
      return launch_var_core<CoreExp2Fold, bf16, Sched::kHStack>(a, B, st);
    case kHG: a.clamp = kClamp70e2; return launch_var_core<CoreExp2Fold, bf16, Sched::kHG>(a, B, st);
    case kCoreQK: return launch_var_core<CoreQK8, bf16>(a, B, st);
    case kCorePV: return launch_var_core<CorePV8, bf16>(a, B, st);
    case kCoreBoth: return launch_var_core<CoreBoth8, bf16>(a, B, st);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace
}  // namespace aiic

// x (B,S,W) bf16; ln_s, ln_b (W) f32; wqkv_q (W,3W) int8 and its K-major
// copy wqkv_t (3W,W); sqkv, bqkv (3W) f32; wo_q (W,W) int8 and wo_t = wo_q^T
// with so (W) f32; wo (W,W) bf16; bo (W) f32; out (B,S,W) bf16. Scratch: hq
// (B*S,W) int8, hs and amax (B*S) f32, qkv (B*S,3W) bf16, attn (B*S,W) f32
// (bf16 for the bf16 out-projection), aq (B*S,W) int8, as (B*S) f32. qconst
// = bf16(scale * log2 e). form 0 (attn_variants_wgmma.cu: reads wqkv_t and
// wo_t; its int8 cores, coreqk, corepv and coreboth, also take the scratch
// kv8 (2 B*H*s_pad*64) int8 and kvs (B*H*(s_pad + 64)) f32, s_pad =
// 64 ceil(S/64), null for the others) or 1 (here: reads wqkv_q and wo_q).
// Needs W == 64 H, W % 128 == 0 and an even B for v4 and the pair
// schedules. Returns a cudaError_t.
extern "C" int aiic_attn_variant(
    int variant, const void* x, const void* ln_s, const void* ln_b, const void* wqkv_q,
    const void* wqkv_t, const void* sqkv, const void* bqkv, const void* wo_q, const void* wo_t,
    const void* so, const void* wo, const void* bo, void* out, void* hq, void* hs, void* amax,
    void* qkv, void* attn, void* aq, void* as, void* kv8, void* kvs, int B, int S, int W, int H,
    float eps, float qconst, int form, void* stream) {
  using namespace aiic;
  if (form == 0)
    return aiic_attn_variant_wgmma(variant, x, ln_s, ln_b, wqkv_t, sqkv, bqkv, wo_t, so, wo, bo,
                                   out, hq, hs, amax, qkv, attn, aq, as, kv8, kvs, B, S, W, H,
                                   eps, qconst, stream);
  if (form != 1) return cudaErrorInvalidValue;
  auto f = [](const void* p) { return static_cast<const float*>(p); };
  const auto st = static_cast<cudaStream_t>(stream);
  const auto xb = static_cast<const bf16*>(x);
  const auto wq = static_cast<const int8_t*>(wqkv_q);
  const auto woq = static_cast<const int8_t*>(wo_q);
  auto hq8 = static_cast<int8_t*>(hq);
  auto aq8 = static_cast<int8_t*>(aq);
  auto o = static_cast<bf16*>(out);
  if (variant < 0 || variant >= kNumAttnVariants || W % kBN || W != H * kHeadDim || S <= 0 ||
      (variant == kV4 && B % 2))
    return cudaErrorInvalidValue;
  const int rows = B * S;
  if (variant == kMacOnly) {
    AIIC_CHECK(fill_int8(hq8, static_cast<size_t>(rows) * W, 3, st));
    AIIC_CHECK(launch_gemm(static_cast<const int8_t*>(hq8), wq, rows, 3 * W, W, EpiClip8{aq8, W}, st));
    return launch_gemm(static_cast<const int8_t*>(aq8), woq, rows, W, W, EpiAddRaw{xb, o, W}, st);
  }
  auto hsf = static_cast<float*>(hs);
  auto qkvb = static_cast<bf16*>(qkv);
  if (variant == kV4) {  // one scale per image pair
    AIIC_CHECK(launch_rowquant_var<RowQuant::kTileAmax>(xb, f(ln_s), f(ln_b), hq8,
                                                        static_cast<float*>(amax), nullptr, rows,
                                                        W, eps, st));
    AIIC_CHECK(launch_rowquant_var<RowQuant::kTileQuant>(xb, f(ln_s), f(ln_b), hq8, hsf, f(amax),
                                                         rows, W, eps, st, 0.f, 2 * S));
    AIIC_CHECK(launch_gemm(static_cast<const int8_t*>(hq8), wq, rows, 3 * W, W,
                           EpiQKVTile{hsf, f(sqkv), f(bqkv), qkvb, 3 * W}, st));
  } else {  // row 1's stage, with LN1 or not (noln)
    const Int8Attn a{f(ln_s), f(ln_b), wq, f(sqkv), f(bqkv), nullptr, nullptr, nullptr};
    AIIC_CHECK(variant == kNoLn ? int8_qkv_stage<false>(xb, a, qkvb, hq8, hsf, rows, W, eps, st)
                                : int8_qkv_stage<true>(xb, a, qkvb, hq8, hsf, rows, W, eps, st));
  }
  if (variant != kNoCore) {
    const float scale = 1.0f / sqrtf(static_cast<float>(kHeadDim));  // dim ** -0.5, exact for 64
    const float sconst = static_cast<float>(0.125 * 1.4426950408889634);
    AIIC_CHECK(run_core(variant, CoreArgs{qkvb, attn, S, W, H, qconst, sconst, scale, 0.f}, B, st));
  }
  if (variant >= kQoBf16)  // bf16 out-projection
    return launch_gemm(static_cast<const bf16*>(attn), static_cast<const bf16*>(wo), rows, W, W,
                       EpiOutProj{f(bo), xb, o, W}, st);
  auto asf = static_cast<float*>(as);
  if (variant == kNoCore)  // attn = f32(qkv[:, :W])
    AIIC_CHECK((launch_rowquant<false, bf16>(static_cast<const bf16*>(qkvb), nullptr, nullptr, aq8,
                                             asf, rows, W, eps, st, 3 * W)));
  else
    AIIC_CHECK((launch_rowquant<false, float>(static_cast<const float*>(attn), nullptr, nullptr,
                                              aq8, asf, rows, W, eps, st)));
  return launch_gemm(static_cast<const int8_t*>(aq8), woq, rows, W, W,
                     EpiResidual{asf, f(so), f(bo), xb, o, W}, st);
}
