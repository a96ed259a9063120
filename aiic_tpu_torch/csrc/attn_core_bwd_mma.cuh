// Tensor-core attention-core backward for Hopper (sm_90a), bf16, on the
// packed (B, S, 3W) projection and a (B, S, W) cotangent, at any S: row 9 of
// the TPU kernel table in bf16, and the core backward of rows 12 (bf16) and
// 14 (the whole text block's backward, form 0).
//
// Replaces, as attention_qkv_bwd.cu's bf16 route, the TPU kernel
// aiic_tpu/ops/attention.py::_attention_qkv_bwd_kernel (:728, called from
// fused_attention_qkv_bwd :802 at :818), and inside text_block.cuh and
// text_block_int8.cu the core step of aiic_tpu/ops/block_grad.py::
// _text_block_bwd_kernel (:295-316) and its int8 twin, which compute the same
// function. The plain PyTorch version is aiic_tpu_torch/ops/attention.py::
// fused_attention_qkv_bwd_ref. Per head:
//   p = exp2(min(q'.k^T + mask*log2 e, 70 log2 e)) / max(l, 1e-38), q' = bf16(q*c);
//   dv = bf16(p)^T g;  dp = g v^T;  ds = bf16((p (dp - delta)) scale),
//   delta = rowsum(p dp);  dq = ds k;  dk = ds^T q.
// dqkv is stored as TO: bf16 (row 9, row 12) or fp32 (row 14, whose dqkv
// feeds the row quantizer of rowquant(dqkv * sqkv) and must not be rounded
// to bf16 first; fused_attention_qkv_bwd_ref(..., out_dtype=torch.float32)).
// The fp32 routes (common.cuh's one-tile block_core_bwd_kernel, which the
// text block's form 1 and fp32 route keep, and attention_qkv_bwd.cu's two
// scalar streaming passes) stay as they were.
//
// What bounds it on the H100: the bytes. At 256 ViT-B/16 images (S=197,
// W=768, H=12) it reads qkv and g and writes dqkv, 7*B*S*W bf16 = 542 MB:
// 0.162 ms at 3.35 TB/s, against 76.3 GFLOP of the five products (0.077 ms
// at 989 TFLOP/s); at 256 text rows (S=77, W=512, H=8, causal) 141 MB,
// 0.042 ms. The kernel does ten 64x64x64 products per (query tile, key
// tile) pair (below), 258 GFLOP at the ViT shape with S padded to 256, and
// 0.81 G exp2 on the SFUs.
//
// The design: two passes, no atomics, so a run repeats bit for bit. Both
// are one warpgroup (4 warps x 16 rows) a block over 64 rows of one (image,
// head), with every product a wgmma m64n64k16 bf16 -> fp32 whose operands the
// tensor cores read from 128-B swizzled tiles by descriptor, except an A
// made in the step itself, which comes from registers (mma_tiles.cuh, the
// forward's pieces):
// - Pass 1, grid (ceil(S/64), H, B), 64 query rows: the q tile, scaled in
//   place to q' = bf16(q * c) by the threads that loaded it, and the g tile
//   stay in shared memory as the K-major A of every step; K and V tiles
//   stream through a 2-stage cp.async ring, three times (K alone in the
//   first). The first sweep takes s = q'.K^T (K the K-major B) and sums
//   l = sum e over e = exp2(min(s, clamp)), then inv = 1/max(l, 1e-38); the
//   second takes s and dp = g.V^T (V the K-major B) and sums
//   delta = sum p dp, p = e * inv;
//   the third takes s and dp again, ds, and repacks ds from the C fragments
//   as the A fragments of dq += ds.K (K the N-major B, as V in the forward's
//   P.V). It writes dq and, to an fp32 workspace, inv and delta of its rows.
// - Pass 2, grid (ceil(S/64), H, B), 64 key rows: the k and v tiles stay in
//   shared memory as the K-major A of every step; query tiles stream through
//   the ring: q (raw), g, and the rows' inv and delta. Each thread rescales
//   the chunks of q it loaded itself to q' = bf16(q * c) into a second tile
//   before the fence (no bf16 workspace, no extra barrier). s^T = k.q'^T (q'
//   K-major) and dp^T = v.g^T (g K-major); p^T = e * inv, ds^T;
//   dv += bf16(p^T).g (g N-major) and dk += ds^T.q (raw q N-major: dk uses q,
//   not q').
// The operands every step reads stay in shared memory: held as register A
// fragments across the loop (as the forward holds q'), they gave wrong
// products from the second step on, on the card. That also keeps 32
// registers a thread free.
//
// Pass 1 takes 1 + 2 + 3 products per tile pair and pass 2 four: ten.
// Summing u = sum e dp beside l in the first sweep and taking
// delta = u * inv would save the second sweep (nine), but rounds otherwise
// than the plain version's sum of (e * inv) dp: at S = 1 the plain ds is
// exactly 0 (p = 1, dp - delta = 0) and that delta's was not, which missed
// the bf16 bar on the card.
//
// Rounding sites: the plain version's, and nothing else rounds. bf16: q',
// p before dv, g (an input) and ds; fp32: every sum (s, dp and the products'
// accumulators on the tensor cores, l, delta) and every elementwise step
// (s + mask * log2 e as two roundings under -fmad=false, e * inv, dp - delta,
// the product with p, then with scale). The order of the fp32 sums differs
// from the plain version's, and s^T in pass 2 is the transposed product of
// s in pass 1, so where an fp32 score sits on a bf16 boundary ds may round
// the other way for dk than for dq; each is within the bf16 bar.
//
// Edges: keys past S are zero-filled tiles (exp2 of a zero score is 1), so
// pass 1 gives them e = 0 explicitly; queries past S get p^T = 0 and
// ds^T = 0 in pass 2 (their inv and delta are zero-filled too); rows past S
// are computed on zeros and never stored. The mask is read as scalars: with
// S odd a mask row starts at an odd element. A row the mask removes whole
// has l = 0, inv = 1e38, e = 0, so p = 0 and its cotangents are zero. A row
// whose scores pass the clamp has e = exp2(clamp) and follows the plain
// version. A full tile without a mask takes the branch-free path.

#pragma once

#include "mma_tiles.cuh"

namespace aiic {
namespace {

// Dynamic shared memory of the passes, with 1 KB to align the tiles. The fp32
// store writes the fragments straight to device memory (below), so it needs
// no more.
constexpr int kBwdQuerySmem = 6 * kTileElems * 2 + 1024;  // q', G, 2 K, 2 V tiles
constexpr int kBwdKeySmem =
    8 * kTileElems * 2 + 2 * 2 * kMmaRows * 4 + 1024;  // K, V, 2 (Q, q', G), 2 (inv, delta)

// mma_tiles.cuh's store_rows for an fp32 dst (the stage tile and the row
// factors, all 1 here, unused): a warp's 16 rows of an fp32 accumulator
// (rows g and g + 8, columns 8n + 2 tig + {0, 1}) stored unrounded to dst
// (row r at dst + r*ld) for the rows below n_rows. Each quad writes 32
// consecutive bytes of a row, a whole sector, so nothing is staged.
__device__ __forceinline__ void store_rows(bf16*, const float (&d)[8][4], const float*,
                                           float* dst, size_t ld, int n_rows, int wrow,
                                           int lane) {
  const int g = lane >> 2, tig = lane & 3, r0 = wrow + g, r1 = r0 + 8;
#pragma unroll
  for (int n = 0; n < 8; ++n) {
    if (r0 < n_rows)
      *reinterpret_cast<float2*>(dst + static_cast<size_t>(r0) * ld + 8 * n + 2 * tig) =
          make_float2(d[n][0], d[n][1]);
    if (r1 < n_rows)
      *reinterpret_cast<float2*>(dst + static_cast<size_t>(r1) * ld + 8 * n + 2 * tig) =
          make_float2(d[n][2], d[n][3]);
  }
}

// The sum over the four threads of a row group (disjoint columns of a row).
__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  v += __shfl_xor_sync(0xffffffffu, v, 2);
  return v;
}

// Pass 1. Writes dq of the block's query rows to columns h*64 of dqkv, and
// inv = 1/max(l, 1e-38), delta = rowsum(p dp) to the workspace at
// (b*H + h)*S + row.
template <typename TO>
__global__ void __launch_bounds__(kMmaThreads, 3)
core_bwd_mma_query_kernel(const bf16* __restrict__ qkv, const bf16* __restrict__ g,
                          const float* __restrict__ mask, TO* __restrict__ dqkv,
                          float* __restrict__ inv_ws, float* __restrict__ delta_ws, int S, int W,
                          int H, float qconst, float scale) {
  extern __shared__ unsigned char smem_raw[];
  bf16* sq = reinterpret_cast<bf16*>(align1024(smem_raw));  // q' = bf16(q * c)
  bf16* sg = sq + kTileElems;
  bf16* sk = sg + kTileElems;      // 2 stages
  bf16* sv = sk + 2 * kTileElems;  // 2 stages

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int gr = lane >> 2, tig = lane & 3;  // the fragments' row group and column pair
  const int h = blockIdx.y;
  const size_t row0 = static_cast<size_t>(blockIdx.z) * S, ld = 3 * static_cast<size_t>(W);
  const int q0 = blockIdx.x * kMmaRows;
  const int wrow = warp * 16;
  const int n_tiles = (S + kMmaKeys - 1) / kMmaKeys;
  const bf16* kb = qkv + row0 * ld + W + h * kHeadDim;
  const bf16* vb = kb + W;

  load_tile_async(sq, qkv + (row0 + q0) * ld + h * kHeadDim, ld, S - q0, tid);
  load_tile_async(sg, g + (row0 + q0) * W + h * kHeadDim, W, S - q0, tid);
  load_tile_async(sk, kb, ld, S, tid);  // the first sweep reads no V
  cp_async_commit();

  float dq[8][4];
  zero_acc(dq);
  // Rows gr and gr + 8, this thread's columns: l, then 1/max(l, 1e-38); the
  // partial sums of p dp, then delta.
  float inv[2] = {0.f, 0.f}, delta[2] = {0.f, 0.f};
  const uint64_t qd = sw128_desc(smem_addr(sq)), gd = sw128_desc(smem_addr(sg));
  const uint32_t k_addr = smem_addr(sk), v_addr = smem_addr(sv);

  // Three sweeps over the key tiles (sweep = it / n_tiles): l, delta, dq.
  // The ring runs on from one sweep into the next.
  for (int it = 0; it < 3 * n_tiles; ++it) {
    const int st = it & 1, sweep = it / n_tiles;
    const int k0 = (it - sweep * n_tiles) * kMmaKeys;
    cp_async_wait_all();
    if (it == 0) scale_own_chunks(sq, sq, qconst, tid);
    fence_proxy_async();
    __syncthreads();
    if (it + 1 < 3 * n_tiles) {  // the first sweep reads no V
      const int k1 = ((it + 1) % n_tiles) * kMmaKeys;
      load_tile_async(sk + (st ^ 1) * kTileElems, kb + static_cast<size_t>(k1) * ld, ld, S - k1,
                      tid);
      if (it + 1 >= n_tiles)
        load_tile_async(sv + (st ^ 1) * kTileElems, vb + static_cast<size_t>(k1) * ld, ld,
                        S - k1, tid);
    }
    cp_async_commit();
    if (it == n_tiles) {
#pragma unroll
      for (int i = 0; i < 2; ++i) inv[i] = 1.0f / fmaxf(quad_sum(inv[i]), 1e-38f);
    }
    if (it == 2 * n_tiles) {
#pragma unroll
      for (int i = 0; i < 2; ++i) delta[i] = quad_sum(delta[i]);
    }

    // s = q' . K^T and (after the first sweep) dp = g . V^T: 64 queries x
    // 64 keys.
    float s[8][4], dp[8][4];
    zero_acc(s);
    zero_acc(dp);
    const uint64_t kd = sw128_desc(k_addr + st * kTileElems * 2);
    const uint64_t vd = sw128_desc(v_addr + st * kTileElems * 2);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) wgmma_64x64x16_ss<0>(s, qd + 2 * kk, kd + 2 * kk);
    if (sweep > 0) {
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) wgmma_64x64x16_ss<0>(dp, gd + 2 * kk, vd + 2 * kk);
    }
    wgmma_commit_wait();
    fence_regs(s);
    fence_regs(dp);

    // e = exp2(min(s + mask*log2 e, clamp)), 0 for keys past S, in place in s.
    if (mask == nullptr && k0 + kMmaKeys <= S) {
#pragma unroll
      for (int n = 0; n < 8; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[n][e] = exp2f(fminf(s[n][e], kExp2Clamp));
    } else {
#pragma unroll
      for (int n = 0; n < 8; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int key = k0 + 8 * n + 2 * tig + (e & 1);
          const int qrow = q0 + wrow + gr + (e >> 1) * 8;
          float v = s[n][e];
          if (mask != nullptr && key < S && qrow < S)
            v = v + __ldg(mask + static_cast<size_t>(qrow) * S + key) * kLog2e;
          s[n][e] = key < S ? exp2f(fminf(v, kExp2Clamp)) : 0.f;
        }
    }

    if (sweep == 0) {  // l += e
#pragma unroll
      for (int n = 0; n < 8; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) inv[e >> 1] += s[n][e];
      continue;
    }
    if (sweep == 1) {  // delta += p dp, p = e * inv
#pragma unroll
      for (int n = 0; n < 8; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) delta[e >> 1] += (s[n][e] * inv[e >> 1]) * dp[n][e];
      continue;
    }
    // ds = bf16((p (dp - delta)) scale), p = e * inv, as the A fragments of
    // dq += ds . K.
    uint32_t da[4][4];
#pragma unroll
    for (int n = 0; n < 8; ++n) {
      float ds[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float p = s[n][e] * inv[e >> 1];
        ds[e] = (p * (dp[n][e] - delta[e >> 1])) * scale;
      }
      da[n >> 1][(n & 1) * 2] = pack_bf16(ds[0], ds[1]);
      da[n >> 1][(n & 1) * 2 + 1] = pack_bf16(ds[2], ds[3]);
    }
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) wgmma_64x64x16<1>(dq, da[kk], kd + 128 * kk);
    wgmma_commit_wait();
    fence_regs(dq);
  }

  if (q0 + wrow >= S) return;  // the warp's rows all lie past S
  if (tig == 0) {
    const size_t at = (static_cast<size_t>(blockIdx.z) * H + h) * S;
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int r = q0 + wrow + gr + 8 * i;
      if (r < S) {
        inv_ws[at + r] = inv[i];
        delta_ws[at + r] = delta[i];
      }
    }
  }
  // Each warp stages its own 16 rows in the K stage the last step did not
  // read (every warp passed the barrier after the step that last read it).
  const float one[2] = {1.f, 1.f};
  store_rows(sk + (((3 * n_tiles - 1) & 1) ^ 1) * kTileElems, dq, one,
             dqkv + (row0 + q0) * ld + h * kHeadDim, ld, S - q0, wrow, lane);
}

// Pass 2. Writes dk and dv of the block's key rows to columns W + h*64 and
// 2W + h*64 of dqkv, from pass 1's inv and delta.
template <typename TO>
__global__ void __launch_bounds__(kMmaThreads, 3)
core_bwd_mma_key_kernel(const bf16* __restrict__ qkv, const bf16* __restrict__ g,
                        const float* __restrict__ mask, const float* __restrict__ inv_ws,
                        const float* __restrict__ delta_ws, TO* __restrict__ dqkv, int S, int W,
                        int H, float qconst, float scale) {
  extern __shared__ unsigned char smem_raw[];
  bf16* sk = reinterpret_cast<bf16*>(align1024(smem_raw));
  bf16* sv = sk + kTileElems;
  bf16* sq = sv + kTileElems;       // 2 stages each
  bf16* sqs = sq + 2 * kTileElems;  // q' = bf16(q * c)
  bf16* sg = sqs + 2 * kTileElems;
  float* stats = reinterpret_cast<float*>(sg + 2 * kTileElems);  // [2][inv 64 | delta 64]

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int gr = lane >> 2, tig = lane & 3;
  const int h = blockIdx.y;
  const size_t row0 = static_cast<size_t>(blockIdx.z) * S, ld = 3 * static_cast<size_t>(W);
  const size_t at = (static_cast<size_t>(blockIdx.z) * H + h) * S;
  const int k0 = blockIdx.x * kMmaRows;  // the block's first key row
  const int wrow = warp * 16;
  const int n_tiles = (S + kMmaKeys - 1) / kMmaKeys;
  const bf16* qb = qkv + row0 * ld + h * kHeadDim;
  const bf16* gb = g + row0 * W + h * kHeadDim;
  // The rows' inv (threads 0-63) or delta (64-127), zero past S.
  const float* stat_src = (tid < kMmaRows ? inv_ws : delta_ws) + at;
  const int stat_row = tid & (kMmaRows - 1);

  load_tile_async(sk, qb + static_cast<size_t>(k0) * ld + W, ld, S - k0, tid);
  load_tile_async(sv, qb + static_cast<size_t>(k0) * ld + 2 * W, ld, S - k0, tid);
  load_tile_async(sq, qb, ld, S, tid);
  load_tile_async(sg, gb, W, S, tid);
  {
    const bool live = stat_row < S;
    cp_async4(smem_addr(stats + tid), stat_src + (live ? stat_row : 0), live ? 4 : 0);
  }
  cp_async_commit();

  float dk[8][4], dv[8][4];
  zero_acc(dk);
  zero_acc(dv);
  const uint64_t kd = sw128_desc(smem_addr(sk)), vd = sw128_desc(smem_addr(sv));
  const uint32_t q_addr = smem_addr(sq), qs_addr = smem_addr(sqs), g_addr = smem_addr(sg);

  for (int t = 0; t < n_tiles; ++t) {
    const int st = t & 1;
    const int r0 = t * kMmaRows;  // the tile's first query row
    cp_async_wait_all();
    scale_own_chunks(sqs + st * kTileElems, sq + st * kTileElems, qconst, tid);
    fence_proxy_async();
    __syncthreads();
    if (t + 1 < n_tiles) {
      const int r1 = r0 + kMmaRows, o = (st ^ 1) * kTileElems;
      load_tile_async(sq + o, qb + static_cast<size_t>(r1) * ld, ld, S - r1, tid);
      load_tile_async(sg + o, gb + static_cast<size_t>(r1) * W, W, S - r1, tid);
      const bool live = r1 + stat_row < S;
      cp_async4(smem_addr(stats + (st ^ 1) * 2 * kMmaRows + tid),
                stat_src + (live ? r1 + stat_row : 0), live ? 4 : 0);
    }
    cp_async_commit();

    // s^T = k . q'^T and dp^T = v . g^T: 64 keys x 64 queries.
    float s[8][4], dp[8][4];
    zero_acc(s);
    zero_acc(dp);
    const uint64_t qsd = sw128_desc(qs_addr + st * kTileElems * 2);
    const uint64_t gd = sw128_desc(g_addr + st * kTileElems * 2);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) wgmma_64x64x16_ss<0>(s, kd + 2 * kk, qsd + 2 * kk);
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) wgmma_64x64x16_ss<0>(dp, vd + 2 * kk, gd + 2 * kk);
    wgmma_commit_wait();
    fence_regs(s);
    fence_regs(dp);

    // Column 8n + 2 tig + (e & 1) of the tile is query r0 + that; row
    // wrow + gr + 8 (e >> 1) is key k0 + that. p^T = e * inv and
    // ds^T = bf16((p^T (dp^T - delta)) scale), both 0 for queries past S,
    // as the A fragments of dv and dk.
    const float* sinv = stats + st * 2 * kMmaRows;
    const float* sdelta = sinv + kMmaRows;
    const bool full = mask == nullptr && r0 + kMmaRows <= S;
    uint32_t pa[4][4], da[4][4];
#pragma unroll
    for (int n = 0; n < 8; ++n) {
      const int c = 8 * n + 2 * tig;
      const float2 iv = *reinterpret_cast<const float2*>(sinv + c);
      const float2 dl = *reinterpret_cast<const float2*>(sdelta + c);
      float p[4], ds[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float inv = (e & 1) ? iv.y : iv.x, delta = (e & 1) ? dl.y : dl.x;
        float v = s[n][e];
        if (full) {
          p[e] = exp2f(fminf(v, kExp2Clamp)) * inv;
          ds[e] = (p[e] * (dp[n][e] - delta)) * scale;
        } else {
          const int qrow = r0 + c + (e & 1);
          const int key = k0 + wrow + gr + (e >> 1) * 8;
          if (mask != nullptr && key < S && qrow < S)
            v = v + __ldg(mask + static_cast<size_t>(qrow) * S + key) * kLog2e;
          p[e] = qrow < S ? exp2f(fminf(v, kExp2Clamp)) * inv : 0.f;
          ds[e] = qrow < S ? (p[e] * (dp[n][e] - delta)) * scale : 0.f;
        }
      }
      pa[n >> 1][(n & 1) * 2] = pack_bf16(p[0], p[1]);
      pa[n >> 1][(n & 1) * 2 + 1] = pack_bf16(p[2], p[3]);
      da[n >> 1][(n & 1) * 2] = pack_bf16(ds[0], ds[1]);
      da[n >> 1][(n & 1) * 2 + 1] = pack_bf16(ds[2], ds[3]);
    }

    // dv += bf16(p^T) . g and dk += ds^T . q: 64 queries in four steps of 16.
    const uint64_t qd = sw128_desc(q_addr + st * kTileElems * 2);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) wgmma_64x64x16<1>(dv, pa[kk], gd + 128 * kk);
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) wgmma_64x64x16<1>(dk, da[kk], qd + 128 * kk);
    wgmma_commit_wait();
    fence_regs(dv);
    fence_regs(dk);
  }

  if (k0 + wrow >= S) return;  // the warp's rows all lie past S
  // The other stage's q' and g tiles are free: the last step used stage
  // (n_tiles - 1) & 1, and every warp passed the barrier after the one before.
  const int free_stage = ((n_tiles - 1) & 1) ^ 1;
  const float one[2] = {1.f, 1.f};
  TO* dst = dqkv + (row0 + k0) * ld + h * kHeadDim;
  store_rows(sqs + free_stage * kTileElems, dk, one, dst + W, ld, S - k0, wrow, lane);
  store_rows(sg + free_stage * kTileElems, dv, one, dst + 2 * W, ld, S - k0, wrow, lane);
}

// qkv (B*S, 3W), g (B*S, W) bf16 -> dqkv (B*S, 3W) in TO (bf16 or fp32);
// mask (S, S) fp32 or null; ws 2*B*H*S floats (inv, then delta). Needs
// W == H*64.
template <typename TO>
cudaError_t launch_core_bwd_mma(const bf16* qkv, const bf16* g, const float* mask, TO* dqkv,
                                float* ws, int B, int S, int W, int H, float qconst,
                                cudaStream_t st) {
  static_assert(std::is_same<TO, bf16>::value || std::is_same<TO, float>::value,
                "dqkv is stored as bf16 or fp32");
  if (B <= 0 || S <= 0 || H <= 0 || W != H * kHeadDim || !ws || B > 65535)
    return cudaErrorInvalidValue;
  AIIC_CHECK(cudaFuncSetAttribute(core_bwd_mma_query_kernel<TO>,
                                  cudaFuncAttributeMaxDynamicSharedMemorySize, kBwdQuerySmem));
  AIIC_CHECK(cudaFuncSetAttribute(core_bwd_mma_key_kernel<TO>,
                                  cudaFuncAttributeMaxDynamicSharedMemorySize, kBwdKeySmem));
  const float scale = 1.0f / sqrtf(static_cast<float>(kHeadDim));  // as launch_core_bwd
  const dim3 grid((S + kMmaRows - 1) / kMmaRows, H, B);
  float* inv = ws;
  float* delta = ws + static_cast<size_t>(B) * H * S;
  core_bwd_mma_query_kernel<TO><<<grid, kMmaThreads, kBwdQuerySmem, st>>>(
      qkv, g, mask, dqkv, inv, delta, S, W, H, qconst, scale);
  AIIC_CHECK(cudaGetLastError());
  core_bwd_mma_key_kernel<TO><<<grid, kMmaThreads, kBwdKeySmem, st>>>(qkv, g, mask, inv, delta,
                                                                       dqkv, S, W, H, qconst,
                                                                       scale);
  return cudaGetLastError();
}

// Blocks of each pass storing TO resident on one SM, into blocks[0] (pass
// 1) and blocks[1] (pass 2).
template <typename TO>
cudaError_t core_bwd_mma_occupancy(int* blocks) {
  AIIC_CHECK(cudaFuncSetAttribute(core_bwd_mma_query_kernel<TO>,
                                  cudaFuncAttributeMaxDynamicSharedMemorySize, kBwdQuerySmem));
  AIIC_CHECK(cudaFuncSetAttribute(core_bwd_mma_key_kernel<TO>,
                                  cudaFuncAttributeMaxDynamicSharedMemorySize, kBwdKeySmem));
  AIIC_CHECK(cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks, core_bwd_mma_query_kernel<TO>,
                                                           kMmaThreads, kBwdQuerySmem));
  return cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks + 1, core_bwd_mma_key_kernel<TO>,
                                                       kMmaThreads, kBwdKeySmem);
}

}  // namespace
}  // namespace aiic
