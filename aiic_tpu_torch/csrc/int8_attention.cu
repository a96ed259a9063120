// int8 attention half-block for Hopper:
//   out = x + OutProj_bf16(Attn(QKV_int8(LN1 x)))
//
// Replaces the TPU kernel aiic_tpu/ops/quant.py::_int8_attn_kernel (called
// from int8_ln_qkv_attention; its math is _int8_attn_group). The plain
// PyTorch version is aiic_tpu_torch/ops/quant.py::int8_ln_qkv_attention_ref.
//
// Four launches on the caller's stream:
//   (a) rowquant_kernel<LN>: LN1 in fp32 + per-row int8 quantization;
//   (b) gemm_kernel<int8_t>: hq @ wqkv_q on the int8 tensor cores, epilogue
//       acc*hscale*sqkv + bqkv in fp32, stored bf16 (B*S, 3W);
//   (c) attn_core_kernel: one thread per query row of one (image, head),
//       K and V of that head staged in shared memory;
//   (d) gemm_kernel<bf16>: attn @ wo on the bf16 tensor cores, epilogue
//       + bo + x (fp32), stored bf16.
//
// What bounds it on the H100: at B=256 the image half-block is ~50k rows of
// width 768. The two projections (2*rows*W*4W MACs) are compute-bound
// tensor-core GEMMs; the core (4*B*H*S^2*D flops at S=197) and the row pass
// move little data per flop but run on the CUDA cores here.
//
// What the simple design gives up: the GEMM stages its tiles with plain
// loads and no pipelining (no TMA, no wgmma, no cp.async ring), qkv and the
// attention output round-trip through device memory between launches, and
// the core runs scalar fp32 FMAs instead of tensor-core products. The
// no-max softmax (exp2 clamped at 70*log2 e) needs no running-max rescale,
// so one streaming pass over the keys is exact: that is the one
// simplification the TPU design gives for free.

#include "common.cuh"

namespace aiic {
namespace {

constexpr int kHeadDim = 64;
constexpr int kCoreThreads = 128;
constexpr float kExp2Clamp = static_cast<float>(70.0 * 1.4426950408889634);

struct EpiQKV {  // qkv = bf16(acc * hscale * sqkv + bqkv)
  const float* hs;
  const float* s;
  const float* b;
  bf16* out;
  int n_cols;
  __device__ void operator()(int r, int n, int acc) const {
    const float v = static_cast<float>(acc) * hs[r] * s[n] + b[n];
    out[static_cast<size_t>(r) * n_cols + n] = __float2bfloat16_rn(v);
  }
};

struct EpiOutProj {  // out = bf16(x + (acc + bo))
  const float* bo;
  const bf16* x;
  bf16* out;
  int n_cols;
  __device__ void operator()(int r, int n, float acc) const {
    const size_t i = static_cast<size_t>(r) * n_cols + n;
    const float v = acc + bo[n];
    out[i] = __float2bfloat16_rn(__bfloat162float(x[i]) + v);
  }
};

// Grid (query tiles, H, B). Scores s = (bf16(q*c) . k) in fp32 with
// c = bf16(scale*log2 e); s += mask*log2 e; p = exp2(min(s, 70 log2 e));
// l += p; o += bf16(p) * v; out = bf16(o / max(l, 1e-38)). A -inf mask entry
// gives p = 0. Dynamic shared memory: K and V of the head, 2*S*64 bf16.
template <int D>
__global__ void __launch_bounds__(kCoreThreads)
attn_core_kernel(const bf16* __restrict__ qkv, const float* __restrict__ mask,
                 bf16* __restrict__ out, int S, int W, float qconst) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* ks = reinterpret_cast<bf16*>(smem_raw);
  bf16* vs = ks + static_cast<size_t>(S) * D;
  const int h = blockIdx.y;
  const size_t row0 = static_cast<size_t>(blockIdx.z) * S;
  const size_t ld = 3 * static_cast<size_t>(W);

  for (int idx = threadIdx.x; idx < S * (D / 8); idx += kCoreThreads) {
    const int s = idx / (D / 8), d = (idx % (D / 8)) * 8;
    const bf16* src = qkv + (row0 + s) * ld + h * D + d;
    *reinterpret_cast<uint4*>(ks + s * D + d) = *reinterpret_cast<const uint4*>(src + W);
    *reinterpret_cast<uint4*>(vs + s * D + d) = *reinterpret_cast<const uint4*>(src + 2 * W);
  }
  __syncthreads();

  const int qi = blockIdx.x * kCoreThreads + threadIdx.x;
  if (qi >= S) return;

  float q[D], o[D];
  const __nv_bfloat162* qsrc =
      reinterpret_cast<const __nv_bfloat162*>(qkv + (row0 + qi) * ld + h * D);
#pragma unroll
  for (int d2 = 0; d2 < D / 2; ++d2) {
    const float2 v = __bfloat1622float2(qsrc[d2]);
    q[2 * d2] = __bfloat162float(__float2bfloat16_rn(v.x * qconst));
    q[2 * d2 + 1] = __bfloat162float(__float2bfloat16_rn(v.y * qconst));
    o[2 * d2] = 0.f;
    o[2 * d2 + 1] = 0.f;
  }
  float l = 0.f;
  const float* mrow = mask ? mask + static_cast<size_t>(qi) * S : nullptr;

  for (int k = 0; k < S; ++k) {
    const __nv_bfloat162* kr = reinterpret_cast<const __nv_bfloat162*>(ks + k * D);
    float s = 0.f;
#pragma unroll
    for (int d2 = 0; d2 < D / 2; ++d2) {
      const float2 kv = __bfloat1622float2(kr[d2]);
      s = fmaf(q[2 * d2], kv.x, s);
      s = fmaf(q[2 * d2 + 1], kv.y, s);
    }
    if (mrow) s = s + mrow[k] * kLog2e;
    const float p = exp2f(fminf(s, kExp2Clamp));
    l += p;
    const float pb = __bfloat162float(__float2bfloat16_rn(p));
    const __nv_bfloat162* vr = reinterpret_cast<const __nv_bfloat162*>(vs + k * D);
#pragma unroll
    for (int d2 = 0; d2 < D / 2; ++d2) {
      const float2 vv = __bfloat1622float2(vr[d2]);
      o[2 * d2] = fmaf(pb, vv.x, o[2 * d2]);
      o[2 * d2 + 1] = fmaf(pb, vv.y, o[2 * d2 + 1]);
    }
  }

  const float inv = 1.0f / fmaxf(l, 1e-38f);
  __nv_bfloat162* dst = reinterpret_cast<__nv_bfloat162*>(out + (row0 + qi) * W + h * D);
#pragma unroll
  for (int d2 = 0; d2 < D / 2; ++d2)
    dst[d2] = __floats2bfloat162_rn(o[2 * d2] * inv, o[2 * d2 + 1] * inv);
}

}  // namespace
}  // namespace aiic

// x (B,S,W) bf16; ln_s, ln_b (W) f32; wqkv_q (W,3W) int8; sqkv, bqkv (3W)
// f32; wo (W,W) bf16; bo (W) f32; mask (S,S) f32 or null; out (B,S,W) bf16.
// Scratch: hq (B*S,W) int8, hs (B*S) f32, qkv (B*S,3W) bf16, attn (B*S,W)
// bf16. Needs W % 128 == 0 and W / H == 64. Returns a cudaError_t.
extern "C" int aiic_int8_ln_qkv_attention(
    const void* x, const void* ln_s, const void* ln_b, const void* wqkv_q,
    const void* sqkv, const void* bqkv, const void* wo, const void* bo,
    const void* mask, void* out, void* hq, void* hs, void* qkv, void* attn,
    int B, int S, int W, int H, float eps, float qconst, void* stream) {
  using namespace aiic;
  if (W % kBN != 0 || W / H != kHeadDim || W % H != 0) return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int rows = B * S;
  const bf16* xb = static_cast<const bf16*>(x);

  AIIC_CHECK((launch_rowquant<true, bf16>(xb, static_cast<const float*>(ln_s),
                                          static_cast<const float*>(ln_b),
                                          static_cast<int8_t*>(hq), static_cast<float*>(hs),
                                          rows, W, eps, st)));
  AIIC_CHECK(launch_gemm(static_cast<const int8_t*>(hq), static_cast<const int8_t*>(wqkv_q),
                         rows, 3 * W, W,
                         EpiQKV{static_cast<const float*>(hs), static_cast<const float*>(sqkv),
                                static_cast<const float*>(bqkv), static_cast<bf16*>(qkv), 3 * W},
                         st));
  const int smem = 2 * S * kHeadDim * static_cast<int>(sizeof(bf16));
  AIIC_CHECK(cudaFuncSetAttribute(attn_core_kernel<kHeadDim>,
                                  cudaFuncAttributeMaxDynamicSharedMemorySize, smem));
  const dim3 grid((S + kCoreThreads - 1) / kCoreThreads, H, B);
  attn_core_kernel<kHeadDim><<<grid, kCoreThreads, smem, st>>>(
      static_cast<const bf16*>(qkv), static_cast<const float*>(mask),
      static_cast<bf16*>(attn), S, W, qconst);
  AIIC_CHECK(cudaGetLastError());
  AIIC_CHECK(launch_gemm(static_cast<const bf16*>(attn), static_cast<const bf16*>(wo),
                         rows, W, W,
                         EpiOutProj{static_cast<const float*>(bo), xb, static_cast<bf16*>(out), W},
                         st));
  return 0;
}
