// Register-tiled SIMT attention core for Hopper (sm_90a), fp32, at any S:
// the fp32 form of rows 7 (packed (B, S, 3W) projection, QKVLayout::kPacked)
// and 6 at D = 64 (separate (B, S, H, 64) q, k, v, QKVLayout::kSeparate) of
// the TPU kernel table.
//
// Replaces, as the fp32 route of attention_qkv.cu and attention.cu, the TPU
// kernels aiic_tpu/ops/attention.py::_attention_qkv_kernel (:426, called
// from fused_attention_qkv :464 at :513) and _attention_kernel (:313, called
// from fused_attention :342 at :377). The plain PyTorch versions are
// aiic_tpu_torch/ops/attention.py::fused_attention_qkv_ref and
// fused_attention_ref. Per (image, head), all in fp32 (no TF32: it would
// miss the 1e-5 bar):
//   e = exp2(min(q'.k^T + mask*log2 e, 70 log2 e)), q' = q*c,
//   c = fp32(scale*log2 e);  l = rowsum(e);  o = e.v;
//   out = o * (1 / max(l, 1e-38)).
// No max is subtracted (the 70 log2 e clamp bounds e), so one streaming
// pass over the keys is exact. Keys past S get e = 0 explicitly (their
// rows are zero-filled and would score 0, exp2(0) = 1), and a row the mask
// removes whole has l = 0 and o = 0, so it comes out zero. -fmad=false (the
// build's) keeps s + mask*log2 e a separately rounded step.
//
// What bounds it on the H100: the operations. 4 B*H*S^2*64 flops of the
// function (q'.k^T and e.v) in fp32 on the SIMT cores: at 256 ViT-B/16
// images (S=197, H=12) 30.5 GFLOP, 0.456 ms at 66.9 TFLOP/s; at 256 text
// rows (S=77, H=8, causal) 3.1 GFLOP, 0.046 ms. The bytes (qkv in, the
// output out) take 0.12 ms at 3.35 TB/s at the ViT shape.
//
// The design (f32_tiles.cuh's pieces, shared with row 9's fp32 backward):
// grid (ceil(S/64), H, B), 256 threads over 64 query rows of one (image,
// head), a 4x4 register micro-tile of each product a thread. q' (q scaled
// in place by the threads that loaded it) stays in shared memory; K and V
// stream in 64-key tiles through a 2-stage cp.async ring, so shared memory
// (97 KB) does not depend on S and every S gets two blocks per SM. Per tile
// pair: s = q'.k^T (tile_nt, q' and K swizzled), e written transposed by the
// threads that made it (write_t), o += e.v (tile_tn, e^T and V in plain
// rows: its reads sit at offsets fixed at compile time, with no swizzle
// arithmetic per key). Each product is cut to the pair's live 16-row groups
// (with_groups: at S=197 the last tile's 5 rows are one group; 33.9 GFLOP
// run against 51 with S padded to 256), and a pair whose mask entries are
// all -inf is skipped exactly (a quarter of them at the causal text shape).
// A thread reads its mask entries of a pair twice, for that vote and for
// the scores (the mask is one (S, S) array for every image and head); a
// form that read them once timed the same (PERF.md, section 6). Each row's
// l is summed per thread over its key columns and reduced across the 16 tx
// threads of the row at the end, in order: no atomics, so a run repeats bit
// for bit.

#pragma once

#include "f32_tiles.cuh"  // and common.cuh: QKVLayout, kExp2Clamp, kLog2e

namespace aiic {
namespace {

constexpr int kF32CoreBlocks = 2;  // blocks per SM the forward is built for (128 registers)
// q' and K are tile_nt's operands (swizzled); V and e^T only tile_tn's:
// plain rows, e^T's padded to 68 floats so that write_t's stores of eight
// key rows at one chunk fall in distinct banks.
using VRows = Rows<kHeadDim>;
using ETRows = Rows<kHeadDim + 4>;
// Dynamic shared memory: q', two K and two V stages, e^T (its space also
// takes the l partial sums at the end), the rows' 1/l.
constexpr int kF32CoreSmem =
    (5 * kTTile + kTRows * (kHeadDim + 4) + kTRows) * static_cast<int>(sizeof(float));

// Grid (ceil(S/64), H, B): out rows [64x, 64x + 64) of head y of image z.
// Columns of head h: q, k, v at h*64, W + h*64, 2W + h*64 of one row of 3W
// (kPacked; the projection is passed as q, k and v), or at h*64 of a row of
// W in q, k and v (kSeparate). The output is the head concat, h*64 of a row
// of W.
template <QKVLayout L>
__global__ void __launch_bounds__(kTThreads, kF32CoreBlocks)
attn_core_f32_kernel(const float* __restrict__ qsrc, const float* __restrict__ ksrc,
                     const float* __restrict__ vsrc, const float* __restrict__ mask,
                     float* __restrict__ out, int S, int W, float qconst) {
  static_assert(L != QKVLayout::kHeadMajor, "the head-major layout is bf16's (row 8)");
  extern __shared__ __align__(16) float smf[];
  float* Qs = smf;
  float* Ks = Qs + kTTile;      // 2 stages
  float* Vs = Ks + 2 * kTTile;  // 2 stages
  float* ET = Vs + 2 * kTTile;
  float* inv_l = ET + kTRows * (kHeadDim + 4);  // [64]
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int ty = (lane >> 3) + 4 * (warp >> 1), tx = (lane & 7) + 8 * (warp & 1);
  const int h = blockIdx.y, i0 = blockIdx.x * kTRows;
  const size_t row0 = static_cast<size_t>(blockIdx.z) * S;
  const size_t ld = L == QKVLayout::kSeparate ? static_cast<size_t>(W) : 3 * static_cast<size_t>(W);
  const int qo = h * kHeadDim;
  const float* qb = qsrc + row0 * ld + qo;
  const float* kb = ksrc + row0 * ld + (L == QKVLayout::kPacked ? qo + W : qo);
  const float* vb = vsrc + row0 * ld + (L == QKVLayout::kPacked ? qo + 2 * W : qo);
  const int ntiles = (S + kTRows - 1) / kTRows;

  load_f32_tile(Qs, qb + i0 * ld, ld, S - i0, tid);
  load_f32_tile(Ks, kb, ld, S, tid);
  load_f32_tile<VRows>(Vs, vb, ld, S, tid);
  cp_async_commit();
  cp_async_wait_all();
  scale_f32_tile(Qs, qconst, tid);  // q' = q*c

  const int nr = live_groups(S, i0);
  float lp[4] = {0.f, 0.f, 0.f, 0.f}, o[4][4] = {};
  for (int t = 0; t < ntiles; ++t) {
    // At this barrier stage t % 2 is complete and visible, and every thread
    // is done with step t - 1, so stage (t + 1) % 2 and e^T may be
    // overwritten; a step whose tile pair has no live score is skipped.
    cp_async_wait_all();
    const int j0 = t * kTRows;
    const bool live = __syncthreads_or(any_live(mask, S, i0, j0, ty, tx, true));
    if (t + 1 < ntiles) {
      const int j1 = j0 + kTRows;
      load_f32_tile(Ks + ((t + 1) & 1) * kTTile, kb + j1 * ld, ld, S - j1, tid);
      load_f32_tile<VRows>(Vs + ((t + 1) & 1) * kTTile, vb + j1 * ld, ld, S - j1, tid);
    }
    cp_async_commit();
    if (!live) continue;
    with_groups(nr, live_groups(S, j0), [&](auto R, auto C) {
      constexpr int NR = decltype(R)::value, NC = decltype(C)::value;
      float e[4][4] = {};
      tile_nt<NR, NC, false>(e, Qs, Ks + (t & 1) * kTTile, ty, tx, 0.f);
#pragma unroll
      for (int r = 0; r < NR; ++r)
#pragma unroll
        for (int c = 0; c < NC; ++c) {
          const int i = i0 + ty + 16 * r, j = j0 + tx + 16 * c;
          float sv = e[r][c];
          if (mask && i < S && j < S) sv = sv + mask[static_cast<size_t>(i) * S + j] * kLog2e;
          e[r][c] = j < S ? exp2f(fminf(sv, kExp2Clamp)) : 0.f;
          lp[r] += e[r][c];
        }
      write_t<NC, ETRows>(ET, e, ty, tx);
      __syncthreads();
      tile_tn<NR, 8, ETRows, VRows>(o, ET, Vs + (t & 1) * kTTile, ty, tx, min(kTRows, S - j0));
    });
  }
  // l of each row over its 16 threads, in order; e^T's space is free once
  // every thread is past its last product.
  __syncthreads();
#pragma unroll
  for (int r = 0; r < 4; ++r) ET[(ty + 16 * r) * 16 + tx] = lp[r];
  __syncthreads();
  if (tid < kTRows) {
    float l = 0.f;
    for (int x = 0; x < 16; ++x) l += ET[tid * 16 + x];
    inv_l[tid] = 1.0f / fmaxf(l, 1e-38f);
  }
  __syncthreads();
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int i = i0 + ty + 16 * r;
    if (i >= S) continue;
    const float iv = inv_l[ty + 16 * r];
    *reinterpret_cast<float4*>(out + (row0 + i) * W + h * kHeadDim + 4 * tx) =
        make_float4(o[r][0] * iv, o[r][1] * iv, o[r][2] * iv, o[r][3] * iv);
  }
}

// q, k, v as the layout places them (kPacked: one (B*S, 3W) projection
// passed three times), out (B*S, W); mask (S, S) fp32 or null; qconst =
// fp32(scale*log2 e). Needs W == H*64 and 16-byte aligned rows.
template <QKVLayout L>
cudaError_t launch_attn_core_f32(const float* q, const float* k, const float* v,
                                 const float* mask, float* out, int B, int S, int W, int H,
                                 float qconst, cudaStream_t st) {
  if (B <= 0 || S <= 0 || H <= 0 || W != H * kHeadDim || B > 65535) return cudaErrorInvalidValue;
  AIIC_CHECK(cudaFuncSetAttribute(attn_core_f32_kernel<L>,
                                  cudaFuncAttributeMaxDynamicSharedMemorySize, kF32CoreSmem));
  const dim3 grid((S + kTRows - 1) / kTRows, H, B);
  attn_core_f32_kernel<L><<<grid, kTThreads, kF32CoreSmem, st>>>(q, k, v, mask, out, S, W, qconst);
  return cudaGetLastError();
}

// Blocks of the fp32 core resident on one SM into *blocks (the two layouts
// are one kernel body).
cudaError_t attn_core_f32_occupancy(int* blocks) {
  AIIC_CHECK(cudaFuncSetAttribute(attn_core_f32_kernel<QKVLayout::kPacked>,
                                  cudaFuncAttributeMaxDynamicSharedMemorySize, kF32CoreSmem));
  return cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      blocks, attn_core_f32_kernel<QKVLayout::kPacked>, kTThreads, kF32CoreSmem);
}

}  // namespace
}  // namespace aiic
