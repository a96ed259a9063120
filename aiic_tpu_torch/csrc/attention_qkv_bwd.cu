// Attention-core backward on the packed (B, S, 3W) projection, bf16 or fp32:
//   dqkv (B, S, 3W) = d Attn(qkv) / d qkv applied to g (B, S, W)
//
// Replaces the TPU kernel aiic_tpu/ops/attention.py::_attention_qkv_bwd_kernel
// (:728, called from fused_attention_qkv_bwd :802 at :818: row 9). The plain
// PyTorch version is aiic_tpu_torch/ops/attention.py::
// fused_attention_qkv_bwd_ref. Per head, as the TPU kernel computes it: p is
// recomputed with the forward's clamped no-max exp2 and normalized in fp32;
//   dv = T(p)^T g;  dp = g v^T;  ds = T((p (dp - rowsum(dp p))) scale);
//   dq = ds k;  dk = ds^T q;
// T is the rounding policy (the element type; a no-op in fp32).
//
// Four forms; the wrapper takes the tensor-core one for bf16 and the
// register-tiled one for fp32, at every S:
// - bf16, tensor cores (attn_core_bwd_mma.cuh): two wgmma passes, 64 query
//   rows a block for dq, then 64 key rows a block for dk and dv.
// - fp32, register-tiled (attn_core_bwd_f32.cuh): two SIMT passes of the
//   same shape, a 4x4 micro-tile of every product a thread, nine products
//   a tile pair, delta summed beside l.
// - S <= 128, one tile: block_core_bwd_kernel (common.cuh), the whole-text-
//   block backward's core in fp32 and in the first design (form 1) of rows
//   12 and 14 (their form 0 runs the tensor-core form), one block per (head,
//   image) with Q, K, V, G and the S x S tile in fp32 shared memory (102,564
//   B at S=77).
// - any S, streaming (below): two scalar passes with no atomics, one thread
//   per row. Pass 1, over (query tile, head, image): the keys streamed
//   through shared memory three times, for l = sum p, for
//   delta = sum p dp, and for dq; l and delta go to a small fp32 workspace.
//   Pass 2, over (key tile, head, image): the queries streamed twice, p
//   recomputed from the saved l, for dv and then dk. Every sum runs over the
//   same operands in the same order as in the one-tile form (s over d, l and
//   delta over keys, dv and dk over queries, each p from the same fp32 s and
//   l), so the two scalar forms agree bit for bit wherever both apply; a run
//   repeats bit for bit.
// The one-tile and streaming forms stay reachable (the wrapper's private
// form argument) so that they can be timed beside the forms that replaced
// them.
//
// What bounds it on the H100: 10*B*H*S^2*D operations (recomputed scores, dv,
// dp, dq, dk) against 7*B*S*W elements moved (qkv and dqkv, g). At 256 text
// rows (S=77, W=512, H=8) 7.77 GFLOP, 0.116 ms in fp32 (operations), 141 MB,
// 0.042 ms in bf16 (bytes); at 256 ViT-B/16 images (S=197, W=768, H=12)
// 76.3 GFLOP, 1.14 ms fp32, and 542 MB, 0.162 ms bf16.
//
// What the scalar forms give up: scalar fp32 FMAs (no tensor cores); the
// streaming form recomputes each score five times (three sweeps in pass 1,
// two in pass 2), feeds every FMA from shared memory, runs at the 255
// registers a thread may hold (pass 1 spills a little) and re-reads K/V
// (pass 1) or Q/G (pass 2) from L2 per row tile; one thread per row leaves
// S=197 at two tiles of 128 with 59 idle threads. On an H100 it is slower
// than the plain PyTorch version at 256 ViT-B/16 images, and at 256 text
// rows (S=77) it takes 1.8x the one-tile kernel's time.

#include "attn_core_bwd_f32.cuh"
#include "attn_core_bwd_mma.cuh"  // and common.cuh

namespace aiic {
namespace {

constexpr int kStreamThreads = 128;  // rows per block, one per thread
constexpr int kStreamTile = 32;      // rows of the streamed operand per shared-memory tile

// dst[r][d] = fp32 of src row (row0 + r0 + r), columns col0 + d, for r < n.
template <typename T>
__device__ __forceinline__ void load_tile(float* dst, const T* __restrict__ src, size_t row0,
                                          int r0, int n, size_t ld, int col0, float mul,
                                          bool scale_round) {
  for (int idx = threadIdx.x; idx < n * kHeadDim; idx += kStreamThreads) {
    const int r = idx / kHeadDim, d = idx % kHeadDim;
    const float v = to_f32(src[(row0 + r0 + r) * ld + col0 + d]);
    dst[idx] = scale_round ? round_as<T>(v * mul) : v;
  }
}

__device__ __forceinline__ float dot64(const float* a, const float* b) {
  float s = 0.f;
#pragma unroll
  for (int d = 0; d < kHeadDim; ++d) s = fmaf(a[d], b[d], s);
  return s;
}

// Pass 1, grid (query tiles, H, B): thread = query row i. Writes dq, and
// l_i = sum_j exp2(min(s_ij, clamp)), delta_i = sum_j p_ij dp_ij to the
// workspace at (b*H + h)*S + i. Dynamic shared memory: g of the block's rows
// transposed [64][kStreamThreads] (a lane reads its own column, no bank
// conflict), then a K tile and a V tile [kStreamTile][64], fp32.
template <typename T>
__global__ void __launch_bounds__(kStreamThreads)
core_bwd_query_kernel(const T* __restrict__ qkv, const T* __restrict__ g,
                      const float* __restrict__ mask, T* __restrict__ dqkv,
                      float* __restrict__ lsum, float* __restrict__ delta, int S, int W, int H,
                      float qconst, float scale) {
  extern __shared__ float sm[];
  float* Gt = sm;
  float* Ks = Gt + kHeadDim * kStreamThreads;
  float* Vs = Ks + kStreamTile * kHeadDim;
  const int h = blockIdx.y, t = threadIdx.x;
  const size_t row0 = static_cast<size_t>(blockIdx.z) * S, ld = 3 * static_cast<size_t>(W);
  const int i = blockIdx.x * kStreamThreads + t;
  const bool live = i < S;
  float q[kHeadDim], acc[kHeadDim];
  if (live) {
    const T* qr = qkv + (row0 + i) * ld + h * kHeadDim;
    const T* gr = g + (row0 + i) * W + h * kHeadDim;
#pragma unroll
    for (int d = 0; d < kHeadDim; ++d) {
      q[d] = round_as<T>(to_f32(qr[d]) * qconst);
      Gt[d * kStreamThreads + t] = to_f32(gr[d]);
    }
  }
  const float* mrow = mask + static_cast<size_t>(live ? i : 0) * S;
  const int kcol = W + h * kHeadDim, vcol = 2 * W + h * kHeadDim;

  float l = 0.f;
  for (int j0 = 0; j0 < S; j0 += kStreamTile) {
    const int n = min(kStreamTile, S - j0);
    __syncthreads();  // the previous tile is read
    load_tile(Ks, qkv, row0, j0, n, ld, kcol, 0.f, false);
    __syncthreads();
    if (live)
      for (int j = 0; j < n; ++j) {
        float s = dot64(q, Ks + j * kHeadDim);
        s = s + mrow[j0 + j] * kLog2e;
        l += exp2f(fminf(s, kExp2Clamp));
      }
  }
  const float inv = 1.0f / fmaxf(l, 1e-38f);

  float rs = 0.f;
  for (int j0 = 0; j0 < S; j0 += kStreamTile) {
    const int n = min(kStreamTile, S - j0);
    __syncthreads();
    load_tile(Ks, qkv, row0, j0, n, ld, kcol, 0.f, false);
    load_tile(Vs, qkv, row0, j0, n, ld, vcol, 0.f, false);
    __syncthreads();
    if (live)
      for (int j = 0; j < n; ++j) {
        float s = dot64(q, Ks + j * kHeadDim);
        s = s + mrow[j0 + j] * kLog2e;
        const float p = exp2f(fminf(s, kExp2Clamp)) * inv;
        const float* vr = Vs + j * kHeadDim;
        float dp = 0.f;
#pragma unroll
        for (int d = 0; d < kHeadDim; ++d) dp = fmaf(Gt[d * kStreamThreads + t], vr[d], dp);
        rs += dp * p;
      }
  }

#pragma unroll
  for (int d = 0; d < kHeadDim; ++d) acc[d] = 0.f;
  for (int j0 = 0; j0 < S; j0 += kStreamTile) {
    const int n = min(kStreamTile, S - j0);
    __syncthreads();
    load_tile(Ks, qkv, row0, j0, n, ld, kcol, 0.f, false);
    load_tile(Vs, qkv, row0, j0, n, ld, vcol, 0.f, false);
    __syncthreads();
    if (live)
      for (int j = 0; j < n; ++j) {
        const float* kr = Ks + j * kHeadDim;
        float s = dot64(q, kr);
        s = s + mrow[j0 + j] * kLog2e;
        const float p = exp2f(fminf(s, kExp2Clamp)) * inv;
        const float* vr = Vs + j * kHeadDim;
        float dp = 0.f;
#pragma unroll
        for (int d = 0; d < kHeadDim; ++d) dp = fmaf(Gt[d * kStreamThreads + t], vr[d], dp);
        const float ds = round_as<T>((p * (dp - rs)) * scale);
#pragma unroll
        for (int d = 0; d < kHeadDim; ++d) acc[d] = fmaf(ds, kr[d], acc[d]);
      }
  }
  if (!live) return;
  T* out = dqkv + (row0 + i) * ld + h * kHeadDim;
#pragma unroll
  for (int d = 0; d < kHeadDim; ++d) store_as<T>(out + d, acc[d]);
  const size_t at = (static_cast<size_t>(blockIdx.z) * H + h) * S + i;
  lsum[at] = l;
  delta[at] = rs;
}

// Pass 2, grid (key tiles, H, B): thread = key row i; dv_i = sum_r T(p_ri)
// g_r, then dk_i = sum_r ds_ri q_r, with p_ri = exp2(min(s_ri, clamp)) / l_r
// and ds_ri = T((p_ri (dp_ri - delta_r)) scale). Dynamic shared memory: v of
// the block's rows transposed [64][kStreamThreads], then tiles of T(q*c), q
// and g [kStreamTile][64] and of 1/max(l, 1e-38) and delta [kStreamTile].
template <typename T>
__global__ void __launch_bounds__(kStreamThreads)
core_bwd_key_kernel(const T* __restrict__ qkv, const T* __restrict__ g,
                    const float* __restrict__ mask, const float* __restrict__ lsum,
                    const float* __restrict__ delta, T* __restrict__ dqkv, int S, int W, int H,
                    float qconst, float scale) {
  extern __shared__ float sm[];
  float* Vt = sm;
  float* Qc = Vt + kHeadDim * kStreamThreads;
  float* Qr = Qc + kStreamTile * kHeadDim;
  float* Gs = Qr + kStreamTile * kHeadDim;
  float* Inv = Gs + kStreamTile * kHeadDim;
  float* Dl = Inv + kStreamTile;
  const int h = blockIdx.y, t = threadIdx.x;
  const size_t row0 = static_cast<size_t>(blockIdx.z) * S, ld = 3 * static_cast<size_t>(W);
  const size_t stats = (static_cast<size_t>(blockIdx.z) * H + h) * S;
  const int i = blockIdx.x * kStreamThreads + t;
  const bool live = i < S;
  const int qcol = h * kHeadDim;
  float k[kHeadDim], acc[kHeadDim];
  if (live) {
    const T* kr = qkv + (row0 + i) * ld + W + qcol;
#pragma unroll
    for (int d = 0; d < kHeadDim; ++d) {
      k[d] = to_f32(kr[d]);
      Vt[d * kStreamThreads + t] = to_f32(kr[W + d]);
    }
  }

#pragma unroll
  for (int d = 0; d < kHeadDim; ++d) acc[d] = 0.f;
  for (int r0 = 0; r0 < S; r0 += kStreamTile) {  // dv
    const int n = min(kStreamTile, S - r0);
    __syncthreads();
    load_tile(Qc, qkv, row0, r0, n, ld, qcol, qconst, true);
    load_tile(Gs, g, row0, r0, n, static_cast<size_t>(W), qcol, 0.f, false);
    for (int r = t; r < n; r += kStreamThreads) Inv[r] = 1.0f / fmaxf(lsum[stats + r0 + r], 1e-38f);
    __syncthreads();
    if (live)
      for (int r = 0; r < n; ++r) {
        float s = dot64(Qc + r * kHeadDim, k);
        s = s + mask[static_cast<size_t>(r0 + r) * S + i] * kLog2e;
        const float pr = round_as<T>(exp2f(fminf(s, kExp2Clamp)) * Inv[r]);
        const float* gr = Gs + r * kHeadDim;
#pragma unroll
        for (int d = 0; d < kHeadDim; ++d) acc[d] = fmaf(pr, gr[d], acc[d]);
      }
  }
  T* out = dqkv + (row0 + (live ? i : 0)) * ld + qcol;
  if (live) {
#pragma unroll
    for (int d = 0; d < kHeadDim; ++d) store_as<T>(out + 2 * W + d, acc[d]);
  }

#pragma unroll
  for (int d = 0; d < kHeadDim; ++d) acc[d] = 0.f;
  for (int r0 = 0; r0 < S; r0 += kStreamTile) {  // dk
    const int n = min(kStreamTile, S - r0);
    __syncthreads();
    load_tile(Qc, qkv, row0, r0, n, ld, qcol, qconst, true);
    load_tile(Qr, qkv, row0, r0, n, ld, qcol, 0.f, false);
    load_tile(Gs, g, row0, r0, n, static_cast<size_t>(W), qcol, 0.f, false);
    for (int r = t; r < n; r += kStreamThreads) {
      Inv[r] = 1.0f / fmaxf(lsum[stats + r0 + r], 1e-38f);
      Dl[r] = delta[stats + r0 + r];
    }
    __syncthreads();
    if (live)
      for (int r = 0; r < n; ++r) {
        float s = dot64(Qc + r * kHeadDim, k);
        s = s + mask[static_cast<size_t>(r0 + r) * S + i] * kLog2e;
        const float p = exp2f(fminf(s, kExp2Clamp)) * Inv[r];
        const float* gr = Gs + r * kHeadDim;
        float dp = 0.f;
#pragma unroll
        for (int d = 0; d < kHeadDim; ++d) dp = fmaf(gr[d], Vt[d * kStreamThreads + t], dp);
        const float ds = round_as<T>((p * (dp - Dl[r])) * scale);
        const float* qr = Qr + r * kHeadDim;
#pragma unroll
        for (int d = 0; d < kHeadDim; ++d) acc[d] = fmaf(ds, qr[d], acc[d]);
      }
  }
  if (live) {
#pragma unroll
    for (int d = 0; d < kHeadDim; ++d) store_as<T>(out + W + d, acc[d]);
  }
}

// ws: 2*B*H*S floats (l, then delta). Needs W == H*64 and a mask.
template <typename T>
cudaError_t launch_core_bwd_streaming(const T* qkv, const T* g, const float* mask, T* dqkv,
                                      float* ws, int B, int S, int W, int H, float qconst,
                                      cudaStream_t st) {
  if (S <= 0 || W != H * kHeadDim || !mask || !ws) return cudaErrorInvalidValue;
  const int smem1 = (kHeadDim * kStreamThreads + 2 * kStreamTile * kHeadDim) * sizeof(float);
  const int smem2 =
      (kHeadDim * kStreamThreads + 3 * kStreamTile * kHeadDim + 2 * kStreamTile) * sizeof(float);
  AIIC_CHECK(cudaFuncSetAttribute(core_bwd_query_kernel<T>,
                                  cudaFuncAttributeMaxDynamicSharedMemorySize, smem1));
  AIIC_CHECK(cudaFuncSetAttribute(core_bwd_key_kernel<T>,
                                  cudaFuncAttributeMaxDynamicSharedMemorySize, smem2));
  const float scale = 1.0f / sqrtf(static_cast<float>(kHeadDim));  // as launch_core_bwd
  const dim3 grid((S + kStreamThreads - 1) / kStreamThreads, H, B);
  float* lsum = ws;
  float* delta = ws + static_cast<size_t>(B) * H * S;
  core_bwd_query_kernel<T><<<grid, kStreamThreads, smem1, st>>>(qkv, g, mask, dqkv, lsum, delta,
                                                                S, W, H, qconst, scale);
  AIIC_CHECK(cudaGetLastError());
  core_bwd_key_kernel<T><<<grid, kStreamThreads, smem2, st>>>(qkv, g, mask, lsum, delta, dqkv, S,
                                                              W, H, qconst, scale);
  return cudaGetLastError();
}

enum BwdForm { kOneTile = 0, kStreaming = 1, kTensorCores = 2, kTiled = 3 };

template <typename T>
cudaError_t attention_qkv_bwd(const void* qkv, const void* mask, const void* g, void* dqkv,
                              void* ws, int B, int S, int W, int H, float qconst, int form,
                              cudaStream_t st) {
  const T* x = static_cast<const T*>(qkv);
  const T* gt = static_cast<const T*>(g);
  const float* m = static_cast<const float*>(mask);
  if (form == kTensorCores) {
    if constexpr (std::is_same<T, bf16>::value)
      return launch_core_bwd_mma(x, gt, m, static_cast<bf16*>(dqkv), static_cast<float*>(ws), B,
                                 S, W, H, qconst, st);
    else
      return cudaErrorInvalidValue;  // tensor cores would compute fp32 in TF32
  }
  if (form == kTiled) {
    if constexpr (std::is_same<T, float>::value)
      return launch_core_bwd_tiled(x, gt, m, static_cast<float*>(dqkv), static_cast<float*>(ws), B,
                                   S, W, H, qconst, st);
    else
      return cudaErrorInvalidValue;  // the register-tiled form is fp32's
  }
  if (!m) return cudaErrorInvalidValue;
  if (form == kStreaming)
    return launch_core_bwd_streaming(x, gt, m, static_cast<T*>(dqkv), static_cast<float*>(ws), B,
                                     S, W, H, qconst, st);
  if (form != kOneTile) return cudaErrorInvalidValue;
  return launch_core_bwd(x, gt, m, static_cast<T*>(dqkv), B, S, W, H, qconst, st);
}

}  // namespace
}  // namespace aiic

// qkv (B,S,3W), g (B,S,W), dqkv (B,S,3W), all bf16 (fp32 == 0) or fp32
// (fp32 == 1); mask (S,S) f32 (the scalar forms: zeros for none; the
// tensor-core and register-tiled forms: null for none); qconst =
// scale*log2 e rounded to the element type; form 0 takes the one-tile kernel
// (S <= 128), 1 the scalar two-pass form, 2 the tensor-core form (bf16
// only), 3 the register-tiled form (fp32 only); forms 1-3 need ws of
// 2*B*H*S floats. Needs W == 64*H. Returns a cudaError_t.
extern "C" int aiic_attention_qkv_bwd(const void* qkv, const void* mask, const void* g,
                                      void* dqkv, void* ws, int B, int S, int W, int H,
                                      float qconst, int fp32, int form, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (fp32)
    return aiic::attention_qkv_bwd<float>(qkv, mask, g, dqkv, ws, B, S, W, H, qconst, form, st);
  return aiic::attention_qkv_bwd<aiic::bf16>(qkv, mask, g, dqkv, ws, B, S, W, H, qconst, form,
                                             st);
}

// Blocks of the tensor-core form's two passes resident on one SM
// (cudaOccupancyMaxActiveBlocksPerMultiprocessor) into blocks[0] (pass 1,
// query rows) and blocks[1] (pass 2, key rows). Returns a cudaError_t.
extern "C" int aiic_attention_qkv_bwd_mma_occupancy(int* blocks) {
  return static_cast<int>(aiic::core_bwd_mma_occupancy<aiic::bf16>(blocks));
}

// Blocks of the fp32 register-tiled form's two passes resident on one SM
// into blocks[0] (pass 1) and blocks[1] (pass 2). Returns a cudaError_t.
extern "C" int aiic_attention_qkv_bwd_tiled_occupancy(int* blocks) {
  return static_cast<int>(aiic::core_bwd_tiled_occupancy(blocks));
}
