// Tensor-core attention core for Hopper (sm_90a), bf16, on the packed or the
// head-major (B, S, 3W) projection, or on three separate (B, S, H, 64) q, k,
// v: rows 7 (bf16), 8 and 6 (bf16, D = 64) of the TPU kernel table, and the
// core stage of rows 1 (wgmma_serving_gemm.cuh) and 5 (ln_qkv_attention.cu),
// packed layout.
//
// Replaces, with attention_qkv.cu's two bf16 entries and attention.cu's bf16
// D = 64 one, the TPU kernels aiic_tpu/ops/attention.py::
// _attention_qkv_kernel (row 7, bf16), _attention_qkv_hg_kernel (row 8) and
// _attention_kernel (row 6, bf16). The fp32 rows 6 and 7 run the
// register-tiled core of attn_core_f32.cuh; row 6 at D = 8 and the WMMA
// forms of rows 1, 4 and 5 keep common.cuh's scalar attn_core_kernel. The tiles, wgmma
// and cp.async pieces are mma_tiles.cuh's, shared with the backward
// (attn_core_bwd_mma.cuh).
//
// What bounds it on the H100: the bytes. At B=256, S=577, W=1024, hg=8 (row 8,
// ViT-L/14@336) it reads qkv and writes the output, 1.21 GB: 0.361 ms at 3.35
// TB/s, against 349 GFLOP of products (0.353 ms at 989 TFLOP/s bf16). At
// B=256, S=197, W=768 (row 7 bf16) 0.092 ms of bytes; the products alone are
// 0.031 ms. The 1.36 G exp2 of row 8 take ~0.35 ms on the SFUs (16 a clock
// per SM), so the softmax's exp2 is as large a term as the bytes.
//
// The design, against the scalar core's limits (one thread per query row,
// scalar fp32 FMAs fed two elements at a time from shared memory; K and V
// of the whole head in shared memory, 147,712 B at S=577, so one block per
// SM; ragged 128-row query tiles):
// - A block is one warpgroup (4 warps) and 64 query rows of one (image,
//   head); each warp owns 16 rows. Grid (ceil(S/64), hg, B*H/hg) with the
//   scalar core's head mapping.
// - Both products are warpgroup tensor-core products, wgmma m64n64k16 bf16 ->
//   fp32, with A from registers and B read by the tensor cores from shared
//   memory through a descriptor: K as stored ([key][d], K-major) for Q.K^T,
//   V as stored ([key][d], N-major, the transposed-B form) for P.V. Q is
//   loaded once with ldmatrix and scaled in registers: q' = bf16(q * c).
// - P stays in registers: each warp's 16 rows of the fp32 score tile (the
//   m16n8 C-fragment layout) become, after the exp2 and one rounding to bf16,
//   its A fragments of P.V.
// - K and V stream in 64-key tiles (8 KB each) through a 2-stage cp.async
//   ring with one barrier a tile (the next tile's load is issued after it,
//   into the stage every warp has finished), so shared memory is 40 KB a
//   block at every S (Q, 2 K, 2 V tiles): four blocks per SM where the scalar
//   core fitted one. Each tile is in the tensor cores' 128-B swizzled layout
//   (rows of 128 B, 16-B chunk c of row r at c ^ r % 8, 1024-B aligned), which
//   also keeps ldmatrix and the cp.async stores free of bank conflicts.
// - One pass, no rescale: the no-max softmax (exp2 clamped at 70 log2 e, the
//   denominator folded in after P.V) needs no running maximum, so the keys
//   stream once, as in the scalar core. A full tile without a mask takes a
//   branch-free softmax.
// - Keys past S in the last tile are zero-filled by cp.async's src-size-0
//   form (never read from the next image's rows) and get p = 0 explicitly;
//   query rows past S are computed on zeros and never stored. The output
//   goes through the Q tile's shared memory so that each row is stored as
//   16-B vectors.
//
// The arithmetic is the scalar core's, so every rounding site is the plain
// versions': s = q'.k in fp32 (+ mask * log2 e, two roundings under
// -fmad=false), p = exp2f(min(s, 70 log2 e)), l += p in fp32 on the
// unrounded p, o += bf16(p) . v in fp32, out = bf16(o * (1 / max(l, 1e-38))).
// Only the order of the fp32 sums differs. The layout only moves addresses,
// so head-major at hg = H equals packed bit for bit, and separate q, k, v
// equal the packed projection that holds them.

#pragma once

#include "mma_tiles.cuh"

namespace aiic {
namespace {

// Grid (ceil(S/64), hg, B * H/hg); head h = (z % (H/hg)) * hg + y of image
// z / (H/hg). Columns of head h in a row: q, k, v at h*64, W + h*64,
// 2W + h*64 of one row of 3W (kPacked; q, k and v are the same projection),
// at 3h*64, 3h*64 + 64, 3h*64 + 128 of it (kHeadMajor), or at h*64 of a row
// of W in three separate arrays (kSeparate, row 6's (B, S, H, 64) q, k, v).
// The output is the head concat, h*64 of a row of W, in every layout.
template <QKVLayout L>
__global__ void __launch_bounds__(kMmaThreads, 4)
attn_core_mma_kernel(const bf16* __restrict__ qsrc, const bf16* __restrict__ ksrc,
                     const bf16* __restrict__ vsrc, const float* __restrict__ mask,
                     bf16* __restrict__ out, int S, int W, int groups, float qconst) {
  __shared__ __align__(1024) bf16 sq[kTileElems];  // Q, later the output rows
  __shared__ __align__(1024) bf16 sk[2][kTileElems];
  __shared__ __align__(1024) bf16 sv[2][kTileElems];

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, tig = lane & 3;  // the fragments' row group and column pair
  const int h = static_cast<int>(blockIdx.z % groups) * gridDim.y + blockIdx.y;
  const size_t row0 = static_cast<size_t>(blockIdx.z / groups) * S;
  const size_t ld = L == QKVLayout::kSeparate ? static_cast<size_t>(W) : 3 * static_cast<size_t>(W);
  const int qo = L == QKVLayout::kHeadMajor ? 3 * h * kHeadDim : h * kHeadDim;
  const int ko = L == QKVLayout::kPacked ? qo + W : L == QKVLayout::kHeadMajor ? qo + kHeadDim : qo;
  const int vo = L == QKVLayout::kPacked      ? qo + 2 * W
                 : L == QKVLayout::kHeadMajor ? qo + 2 * kHeadDim
                                              : qo;
  const int q0 = blockIdx.x * kMmaRows;
  const int wrow = warp * 16;  // the warp's first row in the tile
  const int n_tiles = (S + kMmaKeys - 1) / kMmaKeys;
  const bf16* qb = qsrc + row0 * ld + qo;
  const bf16* kb = ksrc + row0 * ld + ko;
  const bf16* vb = vsrc + row0 * ld + vo;

  load_tile_async(sq, qb + static_cast<size_t>(q0) * ld, ld, S - q0, tid);
  load_tile_async(sk[0], kb, ld, S, tid);
  load_tile_async(sv[0], vb, ld, S, tid);
  cp_async_commit();

  uint32_t qa[4][4];  // q' as A fragments, one per 16-wide depth step
  float o[8][4];      // the warp's 16 rows x 64 columns of the output, fp32
  float l[2] = {0.f, 0.f};  // the row sums of p for rows g and g + 8 (this thread's columns)
  zero_acc(o);
  const uint32_t k_addr = smem_addr(sk[0]), v_addr = smem_addr(sv[0]);

  for (int t = 0; t < n_tiles; ++t) {
    const int st = t & 1;
    // Tile t has landed, and every warp is done with tile t-1, so its stage
    // takes the load of tile t+1 while tile t is computed: one barrier a tile.
    cp_async_wait_all();
    fence_proxy_async();
    __syncthreads();
    if (t + 1 < n_tiles) {
      const size_t k1 = static_cast<size_t>(t + 1) * kMmaKeys;
      load_tile_async(sk[st ^ 1], kb + k1 * ld, ld, S - static_cast<int>(k1), tid);
      load_tile_async(sv[st ^ 1], vb + k1 * ld, ld, S - static_cast<int>(k1), tid);
    }
    cp_async_commit();

    if (t == 0) {
      load_a_frags(qa, sq, wrow, lane);
      scale_a_frags(qa, qconst);
    }

    // s = q' . k^T: 64 rows x 64 keys, depth 64 in four steps of 16.
    float s[8][4];
    zero_acc(s);
    const uint64_t kd = sw128_desc(k_addr + st * kTileElems * 2);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) wgmma_64x64x16<0>(s, qa[kk], kd + 2 * kk);
    wgmma_commit_wait();
    fence_regs(s);

    // p = exp2(min(s + mask*log2 e, 70 log2 e)), 0 past S; l += p;
    // bf16(p) re-packed as the A fragments of P.V.
    const int k0 = t * kMmaKeys;
    uint32_t pa[4][4];
    if (mask == nullptr && k0 + kMmaKeys <= S) {
#pragma unroll
      for (int n = 0; n < 8; ++n) {
        float p[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          p[e] = exp2f(fminf(s[n][e], kExp2Clamp));
          l[e >> 1] += p[e];
        }
        pa[n >> 1][(n & 1) * 2] = pack_bf16(p[0], p[1]);
        pa[n >> 1][(n & 1) * 2 + 1] = pack_bf16(p[2], p[3]);
      }
    } else {
#pragma unroll
      for (int n = 0; n < 8; ++n) {
        float p[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int key = k0 + 8 * n + 2 * tig + (e & 1);
          const int qrow = q0 + wrow + g + (e >> 1) * 8;
          float v = s[n][e];
          // Scalar loads: with S odd a row of the mask starts at an odd
          // element, so a float2 there would be misaligned.
          if (mask != nullptr && key < S && qrow < S)
            v = v + __ldg(mask + static_cast<size_t>(qrow) * S + key) * kLog2e;
          p[e] = key < S ? exp2f(fminf(v, kExp2Clamp)) : 0.f;
          l[e >> 1] += p[e];
        }
        pa[n >> 1][(n & 1) * 2] = pack_bf16(p[0], p[1]);
        pa[n >> 1][(n & 1) * 2 + 1] = pack_bf16(p[2], p[3]);
      }
    }

    // o += bf16(p) . v: 64 rows x 64 columns, 64 keys in four steps of 16.
    const uint64_t vd = sw128_desc(v_addr + st * kTileElems * 2);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) wgmma_64x64x16<1>(o, pa[kk], vd + 128 * kk);
    wgmma_commit_wait();
    fence_regs(o);
  }

  if (q0 + wrow >= S) return;  // the warp's rows all lie past S
  // The four threads of a row group hold disjoint columns: the row sums.
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 1);
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 2);
  }
  const float inv[2] = {1.0f / fmaxf(l[0], 1e-38f), 1.0f / fmaxf(l[1], 1e-38f)};
  // Each warp stages its own 16 rows in the Q tile (only it read them).
  store_rows(sq, o, inv, out + (row0 + q0) * W + h * kHeadDim, W, S - q0, wrow, lane);
}

// out (B*S, W) bf16 = Attn of q, k, v bf16 in the layout L (kPacked and
// kHeadMajor: q = k = v = the (B*S, 3W) projection; kSeparate: three
// (B*S, W) arrays); mask (S, S) fp32 or null. Needs W == H*64 and
// H % head_group == 0 (head_group 0: all heads). Shared memory does not
// depend on S.
template <QKVLayout L>
cudaError_t launch_attn_core_mma(const bf16* q, const bf16* k, const bf16* v, const float* mask,
                                 bf16* out, int B, int S, int W, int H, float qconst,
                                 cudaStream_t st, int head_group = 0) {
  if (head_group <= 0) head_group = H;
  if (B <= 0 || S <= 0 || H <= 0 || W != H * kHeadDim || H % head_group)
    return cudaErrorInvalidValue;
  const dim3 grid((S + kMmaRows - 1) / kMmaRows, head_group, B * (H / head_group));
  if (grid.z > 65535u) return cudaErrorInvalidValue;
  attn_core_mma_kernel<L><<<grid, kMmaThreads, 0, st>>>(q, k, v, mask, out, S, W,
                                                        H / head_group, qconst);
  return cudaGetLastError();
}

}  // namespace
}  // namespace aiic
