// Tensor-core attention core forward of the training text block for Hopper
// (sm_90a), bf16, on the packed (B, S, 3W) projection with S <= 80: the core
// stage of rows 11 and 13 (bf16 and int8 text-block forwards) in form 0, and
// of the forward that rows 12 and 14 recompute.
//
// Replaces, as the text block's form-0 core forward, the core step of the
// TPU kernels aiic_tpu/ops/block_grad.py::_text_block_fwd_kernel (:322) and
// _text_block_fwd_int8_kernel (:1084); block_core_fwd_kernel
// (text_block.cuh) stays as form 1. The plain PyTorch version is
// aiic_tpu_torch/ops/block_grad.py::block_core_fwd_ref.
//
// The rounding sites of the TPU kernel are the contract, and unlike
// attn_core_mma.cuh (which folds 1/l in after p.V) the probabilities are
// normalized before p.V:
//   q' = T(q * qconst);  s = q'.k^T, fp32;  s + mask * log2 e (a separate
//   rounding under the build's -fmad=false);  e = exp2(min(s, 70 log2 e)),
//   0 for keys past S;  l = rowsum(e);  p = T(e * (1 / max(l, 1e-38)));
//   a = T(p.v), fp32.
// l is summed by each thread over its 20 keys of the row in key order, then
// across the row's four threads (xor 1, then xor 2). Only the order of the
// fp32 sums of q'.k^T, l and p.v differs from block_core_fwd_kernel.
//
// The design: the text tower has S = 77 in every preset, so one key tile of
// kCoreKeys = 80 rows holds a row's whole score vector and the softmax needs
// no second sweep. A block is one warpgroup and 64 query rows of one
// (image, head), grid (ceil(S/64), H, B). Q (64 rows), K and V (80 rows each)
// are loaded once by cp.async into 128-B swizzled tiles (28 KB); q' is
// scaled in registers as A fragments; s = q'.k^T is one wgmma m64n80k16
// chain (K as the K-major B), whose C fragments become, after the softmax
// and one rounding to bf16, the A fragments of o = p.v (wgmma m64n64k16, V
// as the N-major B, five 16-key steps). Keys past S are zero-filled and get
// p = 0 explicitly; query rows past S are computed on zeros and never
// stored. The output goes through the Q tile so that rows store as 16-B
// vectors.
//
// What bounds it on the H100: the bytes. At 256 text rows (B=256, S=77,
// W=512, H=8) it reads qkv (60.6 MB) and writes a (20.2 MB): 0.024 ms at
// 3.35 TB/s, against 3.1 GFLOP of products (0.003 ms at 989 TFLOP/s bf16).

#pragma once

#include "mma_tiles.cuh"

namespace aiic {
namespace {

constexpr int kCoreKeys = 80;  // keys of the one tile: S <= 80
constexpr int kCoreKeyElems = kCoreKeys * kHeadDim;

// d += a . b on the warpgroup, m64n80k16 bf16 -> fp32: a from registers (each
// warp's 16 rows as the m16n8k16 A fragment), b 16x80 K-major in shared
// memory by descriptor (desc + 2 per 16-deep step), d ten m16n8 C fragments
// a warp.
__device__ __forceinline__ void wgmma_64x80x16(float (&d)[10][4], const uint32_t (&a)[4],
                                               uint64_t desc_b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %45, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n80k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39}, "
      "{%40, %41, %42, %43}, %44, p, 1, 1, 0;\n}\n"
      : "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]),
        "+f"(d[1][0]), "+f"(d[1][1]), "+f"(d[1][2]), "+f"(d[1][3]),
        "+f"(d[2][0]), "+f"(d[2][1]), "+f"(d[2][2]), "+f"(d[2][3]),
        "+f"(d[3][0]), "+f"(d[3][1]), "+f"(d[3][2]), "+f"(d[3][3]),
        "+f"(d[4][0]), "+f"(d[4][1]), "+f"(d[4][2]), "+f"(d[4][3]),
        "+f"(d[5][0]), "+f"(d[5][1]), "+f"(d[5][2]), "+f"(d[5][3]),
        "+f"(d[6][0]), "+f"(d[6][1]), "+f"(d[6][2]), "+f"(d[6][3]),
        "+f"(d[7][0]), "+f"(d[7][1]), "+f"(d[7][2]), "+f"(d[7][3]),
        "+f"(d[8][0]), "+f"(d[8][1]), "+f"(d[8][2]), "+f"(d[8][3]),
        "+f"(d[9][0]), "+f"(d[9][1]), "+f"(d[9][2]), "+f"(d[9][3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(1));
}

// kRows rows x 64 columns of bf16 from src (row r at src + r*ld) into a
// swizzled tile, rows at index >= n_live zero-filled (nothing read).
template <int kRows>
__device__ __forceinline__ void load_rows_async(bf16* dst, const bf16* src, size_t ld, int n_live,
                                                int tid) {
  static_assert(kRows * 8 % kMmaThreads == 0, "whole 16-B chunks a thread");
#pragma unroll
  for (int i = 0; i < kRows * 8 / kMmaThreads; ++i) {
    const int c = tid + i * kMmaThreads, r = c >> 3, ch = c & 7;
    const bool live = r < n_live;
    cp_async16(smem_addr(dst + swz(r, ch)), src + (live ? r : 0) * ld + ch * 8, live ? 16 : 0);
  }
}

// Grid (ceil(S/64), H, B): a rows [64x, 64x + 64) of head y of image z.
__global__ void __launch_bounds__(kMmaThreads, 4)
block_core_fwd_mma_kernel(const bf16* __restrict__ qkv, const float* __restrict__ mask,
                          bf16* __restrict__ out, int S, int W, float qconst) {
  __shared__ __align__(1024) bf16 sq[kTileElems];  // Q, later the output rows
  __shared__ __align__(1024) bf16 sk[kCoreKeyElems];
  __shared__ __align__(1024) bf16 sv[kCoreKeyElems];

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, tig = lane & 3;  // the fragments' row group and column pair
  const int h = blockIdx.y, q0 = blockIdx.x * kMmaRows, wrow = warp * 16;
  const size_t row0 = static_cast<size_t>(blockIdx.z) * S, ld = 3 * static_cast<size_t>(W);
  const bf16* qb = qkv + row0 * ld + h * kHeadDim;

  load_rows_async<kMmaRows>(sq, qb + static_cast<size_t>(q0) * ld, ld, S - q0, tid);
  load_rows_async<kCoreKeys>(sk, qb + W, ld, S, tid);
  load_rows_async<kCoreKeys>(sv, qb + 2 * W, ld, S, tid);
  cp_async_commit();
  cp_async_wait_all();
  fence_proxy_async();
  __syncthreads();

  uint32_t qa[4][4];  // q' as A fragments, one per 16-wide depth step
  load_a_frags(qa, sq, wrow, lane);
  scale_a_frags(qa, qconst);

  // s = q' . k^T: 64 rows x 80 keys, depth 64 in four steps of 16.
  float s[10][4];
#pragma unroll
  for (int n = 0; n < 10; ++n) s[n][0] = s[n][1] = s[n][2] = s[n][3] = 0.f;
  const uint64_t kd = sw128_desc(smem_addr(sk));
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) wgmma_64x80x16(s, qa[kk], kd + 2 * kk);
  wgmma_commit_wait();
#pragma unroll
  for (int n = 0; n < 10; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) asm volatile("" : "+f"(s[n][e])::"memory");

  // e = exp2(min(s + mask*log2 e, 70 log2 e)), 0 past S; l per row in key
  // order, then over the row's four threads.
  float l[2] = {0.f, 0.f};
#pragma unroll
  for (int n = 0; n < 10; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int key = 8 * n + 2 * tig + (e & 1), qrow = q0 + wrow + g + (e >> 1) * 8;
      float v = s[n][e];
      // Scalar loads: with S odd a row of the mask starts at an odd element.
      if (mask != nullptr && key < S && qrow < S)
        v = v + __ldg(mask + static_cast<size_t>(qrow) * S + key) * kLog2e;
      s[n][e] = key < S ? exp2f(fminf(v, kExp2Clamp)) : 0.f;
      l[e >> 1] += s[n][e];
    }
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 1);
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 2);
  }
  const float inv[2] = {1.0f / fmaxf(l[0], 1e-38f), 1.0f / fmaxf(l[1], 1e-38f)};
  // p = bf16(e * inv), re-packed as the A fragments of p.v (16 keys a step).
  uint32_t pa[5][4];
#pragma unroll
  for (int n = 0; n < 10; ++n) {
    pa[n >> 1][(n & 1) * 2] = pack_bf16(s[n][0] * inv[0], s[n][1] * inv[0]);
    pa[n >> 1][(n & 1) * 2 + 1] = pack_bf16(s[n][2] * inv[1], s[n][3] * inv[1]);
  }

  // o = p . v: 64 rows x 64 columns, 80 keys in five steps of 16.
  float o[8][4];
  zero_acc(o);
  const uint64_t vd = sw128_desc(smem_addr(sv));
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < 5; ++kk) wgmma_64x64x16<1>(o, pa[kk], vd + 128 * kk);
  wgmma_commit_wait();
  fence_regs(o);

  if (q0 + wrow >= S) return;  // the warp's rows all lie past S
  const float one[2] = {1.f, 1.f};  // p is normalized: a = T(o)
  // Each warp stages its own 16 rows in the Q tile (only it read them).
  store_rows(sq, o, one, out + (row0 + q0) * W + h * kHeadDim, W, S - q0, wrow, lane);
}

// a (B*S, W) bf16 = the text block's core of qkv (B*S, 3W) bf16, mask (S, S)
// fp32 or null. Needs 0 < S <= kCoreKeys and W == H*64.
cudaError_t launch_block_core_fwd_mma(const bf16* qkv, const float* mask, bf16* a, int B, int S,
                                      int W, int H, float qconst, cudaStream_t st) {
  if (B <= 0 || S <= 0 || S > kCoreKeys || H <= 0 || W != H * kHeadDim || B > 65535)
    return cudaErrorInvalidValue;
  const dim3 grid((S + kMmaRows - 1) / kMmaRows, H, B);
  block_core_fwd_mma_kernel<<<grid, kMmaThreads, 0, st>>>(qkv, mask, a, S, W, qconst);
  return cudaGetLastError();
}

// Blocks of the kernel resident on one SM into *blocks.
cudaError_t block_core_fwd_mma_occupancy(int* blocks) {
  return cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks, block_core_fwd_mma_kernel,
                                                       kMmaThreads, 0);
}

}  // namespace
}  // namespace aiic
