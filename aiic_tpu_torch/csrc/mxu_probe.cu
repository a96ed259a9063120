// Tensor-core rate probe, WMMA form: what rate the port's own WMMA product
// reaches on this card, for the three bodies of the TPU probe
// tools/mxu_probe.py (`build` :77, pallas_call :78; row 17), at its
// geometry: rows of R=128 per grid step, W=768, M=3072, STEPS=64 steps,
// INNER=64 products per step. The public wrappers run the wgmma form
// (mxu_probe_wgmma.cu); this one, the form it replaced, stays reachable
// (mxu_probe.py's _probe_cuda(..., form="wmma")) and is timed beside it.
//
//   bf16:     acc += bf16(x + i) . w, bf16 operands into fp32 (each product
//             summed on its own, then added to acc), out = bf16(acc)
//   i8:       acc += (x ^ i) . w, s8 operands into s32, out = acc (s32)
//   i8_quant: xf = f32(x) + i; per-row scale max(amax|xf|, 1e-6) / 127;
//             q = clip(rint(xf / scale), +-127) (the port's quantize_row);
//             acc += f32(q . w) * scale (s8 product into s32, dequantized
//             into fp32), out = bf16(acc)
//
// for i in [0, INNER). The i-dependent operand keeps the compiler from
// hoisting the product out of the loop, as in the TPU probe. The plain
// PyTorch versions are aiic_tpu_torch/probes/mxu_probe.py::mxu_*_ref.
//
// Built on the WMMA tile of the serving GEMMs (common.cuh: 128x128 block
// tile, k-step 32, 8 warps of 4x2 16x16x16 fragments, load_b_tile and
// mma_ktile), so the number answers "what does our hand-written product
// reach". The TPU kernel holds the whole (768, 3072) weight in VMEM across a
// grid step; a block's 227 KB of shared memory cannot, so each block streams
// its 128-column slice of the weight from device memory (the L2 holds all
// of it: 2.4 MB in int8, 4.7 MB in bf16) in k-steps of 32, INNER times.
//
// What bounds it on the H100: 2*rows*W*M*INNER operations, 2.47 T at the
// probe's geometry: 2.50 ms at the 989 TFLOP/s of bf16, 1.25 ms at the 1,979
// TOP/s of int8 (dense peaks, 700 W). The bytes (x, w, out: 62 MB in bf16)
// are 0.02 ms.
//
// What the simple design gives up: WMMA (mma.sync) instead of wgmma, no TMA
// or multi-stage pipeline (each k-step loads, syncs, multiplies, syncs), and
// in i8_quant the row scales recomputed by every column block and each
// product's s32 tile spilled through shared memory to be dequantized.

#include "common.cuh"

namespace aiic {
namespace {

enum class ProbeBody : int { kBf16 = 0, kI8 = 1, kI8Quant = 2 };

// Grid (M / 128, rows / 128). x (rows, W): bf16 (kBf16, kI8Quant) or int8
// (kI8); w (W, M): bf16 (kBf16) or int8; out (rows, M): bf16, or int32 (kI8).
template <ProbeBody P>
__global__ void __launch_bounds__(kGemmThreads)
mxu_probe_kernel(const void* __restrict__ xv, const void* __restrict__ wv, void* __restrict__ outv,
                 int W, int M, int inner) {
  using namespace nvcuda;
  using T = typename std::conditional<P == ProbeBody::kBf16, bf16, int8_t>::type;
  using Acc = typename GemmTypes<T>::acc;
  __shared__ __align__(128) T As[kBK / 16][kBM][16];
  __shared__ __align__(128) T Bs[kBN / 16][kBK][16];
  __shared__ __align__(128) Acc Cs[kGemmThreads / 32][16 * 16];
  __shared__ float scl[kBM];  // kI8Quant: the block's row scales at this i

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int wm = warp >> 2, wn = warp & 3;
  const int m0 = blockIdx.y * kBM, n0 = blockIdx.x * kBN;
  const T* w = static_cast<const T*>(wv);

  GemmAcc<T> acc[4][2];  // one product (kBf16, kI8Quant) or the running s32 sum (kI8)
  GemmAcc<T> tot[4][2];  // kBf16: the running fp32 sum
  float facc[4][2][8];   // kI8Quant: the running fp32 sum, element lane + 32 t of a fragment
#pragma unroll
  for (int a = 0; a < 4; ++a)
#pragma unroll
    for (int b = 0; b < 2; ++b) {
      wmma::fill_fragment(acc[a][b], static_cast<Acc>(0));
      wmma::fill_fragment(tot[a][b], static_cast<Acc>(0));
#pragma unroll
      for (int t = 0; t < 8; ++t) facc[a][b][t] = 0.f;
    }

  for (int i = 0; i < inner; ++i) {
    const float fi = static_cast<float>(i);
    if constexpr (P == ProbeBody::kI8Quant) {
      const bf16* x = static_cast<const bf16*>(xv);
      __syncthreads();  // the previous i's dequantization has read scl
      for (int rr = 0; rr < kBM / (kGemmThreads / 32); ++rr) {
        const int r = warp * (kBM / (kGemmThreads / 32)) + rr;
        const bf16* xr = x + static_cast<size_t>(m0 + r) * W;
        float amax = 0.f;
        for (int c = lane; c < W; c += 32) amax = fmaxf(amax, fabsf(__bfloat162float(xr[c]) + fi));
        amax = warp_reduce(amax, true);
        if (lane == 0) scl[r] = fmaxf(amax, 1e-6f) / 127.0f;
      }
      __syncthreads();
    }
    if constexpr (P != ProbeBody::kI8) {
#pragma unroll
      for (int a = 0; a < 4; ++a)
#pragma unroll
        for (int b = 0; b < 2; ++b) wmma::fill_fragment(acc[a][b], static_cast<Acc>(0));
    }
    for (int k0 = 0; k0 < W; k0 += kBK) {
      if constexpr (P == ProbeBody::kBf16) {  // 8 bf16 per vector, two per thread
        const bf16* x = static_cast<const bf16*>(xv);
        for (int c = tid; c < kBM * kBK / 8; c += kGemmThreads) {
          const int r = c / (kBK / 8), kc = (c % (kBK / 8)) * 8;
          uint4 v = *reinterpret_cast<const uint4*>(x + static_cast<size_t>(m0 + r) * W + k0 + kc);
          bf16* e = reinterpret_cast<bf16*>(&v);
#pragma unroll
          for (int u = 0; u < 8; ++u) e[u] = __float2bfloat16_rn(__bfloat162float(e[u]) + fi);
          *reinterpret_cast<uint4*>(&As[kc / 16][r][kc % 16]) = v;
        }
      } else if constexpr (P == ProbeBody::kI8) {  // 16 int8 per vector, one per thread
        const int8_t* x = static_cast<const int8_t*>(xv);
        const unsigned pat = (static_cast<unsigned>(i) & 0xffu) * 0x01010101u;
        const int r = tid / (kBK / 16), kc = (tid % (kBK / 16)) * 16;
        uint4 v = *reinterpret_cast<const uint4*>(x + static_cast<size_t>(m0 + r) * W + k0 + kc);
        v.x ^= pat;
        v.y ^= pat;
        v.z ^= pat;
        v.w ^= pat;
        *reinterpret_cast<uint4*>(&As[kc / 16][r][kc % 16]) = v;
      } else {  // 16 bf16 in, 16 int8 out, one group per thread
        const bf16* x = static_cast<const bf16*>(xv);
        const int r = tid / (kBK / 16), kc = (tid % (kBK / 16)) * 16;
        const bf16* src = x + static_cast<size_t>(m0 + r) * W + k0 + kc;
        const float s = scl[r];
        uint4 v;
        int8_t* q = reinterpret_cast<int8_t*>(&v);
#pragma unroll
        for (int u = 0; u < 16; ++u) {
          const float h = __bfloat162float(src[u]) + fi;
          q[u] = static_cast<int8_t>(fminf(fmaxf(rintf(h / s), -127.f), 127.f));
        }
        *reinterpret_cast<uint4*>(&As[kc / 16][r][kc % 16]) = v;
      }
      load_b_tile(Bs, w, M, n0, k0, tid);
      __syncthreads();
      mma_ktile<T, false>(As, Bs, acc, wm, wn);
      __syncthreads();
    }
    if constexpr (P == ProbeBody::kBf16) {  // acc + dot, as the TPU body adds each product
#pragma unroll
      for (int a = 0; a < 4; ++a)
#pragma unroll
        for (int b = 0; b < 2; ++b)
#pragma unroll
          for (int e = 0; e < tot[a][b].num_elements; ++e) tot[a][b].x[e] = tot[a][b].x[e] + acc[a][b].x[e];
    } else if constexpr (P == ProbeBody::kI8Quant) {
#pragma unroll
      for (int a = 0; a < 4; ++a)
#pragma unroll
        for (int b = 0; b < 2; ++b) {
          wmma::store_matrix_sync(Cs[warp], acc[a][b], 16, wmma::mem_row_major);
          __syncwarp();
#pragma unroll
          for (int t = 0; t < 8; ++t) {
            const int e = lane + 32 * t;
            const float deq = static_cast<float>(Cs[warp][e]) * scl[wm * 64 + a * 16 + (e >> 4)];
            facc[a][b][t] = facc[a][b][t] + deq;
          }
          __syncwarp();
        }
    }
  }

#pragma unroll
  for (int a = 0; a < 4; ++a) {
#pragma unroll
    for (int b = 0; b < 2; ++b) {
      if constexpr (P == ProbeBody::kBf16) wmma::store_matrix_sync(Cs[warp], tot[a][b], 16, wmma::mem_row_major);
      if constexpr (P == ProbeBody::kI8) wmma::store_matrix_sync(Cs[warp], acc[a][b], 16, wmma::mem_row_major);
      __syncwarp();
#pragma unroll
      for (int t = 0; t < 8; ++t) {
        const int e = lane + 32 * t;
        const size_t at = static_cast<size_t>(m0 + wm * 64 + a * 16 + (e >> 4)) * M + n0 + wn * 32 +
                          b * 16 + (e & 15);
        if constexpr (P == ProbeBody::kBf16)
          static_cast<bf16*>(outv)[at] = __float2bfloat16_rn(Cs[warp][e]);
        else if constexpr (P == ProbeBody::kI8)
          static_cast<int*>(outv)[at] = Cs[warp][e];
        else
          static_cast<bf16*>(outv)[at] = __float2bfloat16_rn(facc[a][b][t]);
      }
      __syncwarp();
    }
  }
}

template <ProbeBody P>
cudaError_t launch_probe(const void* x, const void* w, void* out, int rows, int W, int M, int inner,
                         cudaStream_t st) {
  mxu_probe_kernel<P><<<dim3(M / kBN, rows / kBM), kGemmThreads, 0, st>>>(x, w, out, W, M, inner);
  return cudaGetLastError();
}

}  // namespace
}  // namespace aiic

// body 0: bf16 x, w -> bf16 out; 1: int8 x, w -> int32 out; 2: bf16 x, int8
// w -> bf16 out. Needs rows % 128 == 0, M % 128 == 0, W % 32 == 0 and
// inner >= 1. Returns a cudaError_t.
extern "C" int aiic_mxu_probe(const void* x, const void* w, void* out, int rows, int W, int M,
                              int inner, int body, void* stream) {
  using namespace aiic;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (rows <= 0 || rows % kBM || M <= 0 || M % kBN || W <= 0 || W % kBK || inner < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  switch (body) {
    case 0: return launch_probe<ProbeBody::kBf16>(x, w, out, rows, W, M, inner, st);
    case 1: return launch_probe<ProbeBody::kI8>(x, w, out, rows, W, M, inner, st);
    case 2: return launch_probe<ProbeBody::kI8Quant>(x, w, out, rows, W, M, inner, st);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
