// Register-tiled SIMT attention-core backward for Hopper (sm_90a), fp32, on
// the packed (B, S, 3W) projection and a (B, S, W) cotangent, at any S: the
// fp32 form of row 9 of the TPU kernel table.
//
// Replaces, as attention_qkv_bwd.cu's fp32 route, the TPU kernel
// aiic_tpu/ops/attention.py::_attention_qkv_bwd_kernel (:728, called from
// fused_attention_qkv_bwd :802 at :818). The plain PyTorch version is
// aiic_tpu_torch/ops/attention.py::fused_attention_qkv_bwd_ref; the way this
// form takes delta is rendered in plain PyTorch as
// fused_attention_qkv_bwd_ul_ref. Per head, all in fp32 (no TF32: it would
// miss the 1e-5 bar):
//   e = exp2(min(q'.k^T + mask*log2 e, 70 log2 e)), q' = q*c;  l = rowsum(e);
//   inv = 1/max(l, 1e-38);  p = e*inv;  dv = p^T g;  dp = g v^T;
//   u = rowsum(e dp);  delta = u*inv;  ds = (p (dp - delta)) scale;
//   dq = ds k;  dk = ds^T q.
// delta = u*inv, summed beside l in the first sweep over the keys, takes the
// place of the plain version's rowsum(p dp), which needs l first: the two
// differ by fp32 rounding only (~1e-7 of the row's sum), well inside the
// fp32 bar, and the third sweep of the scalar forms goes.
//
// What bounds it on the H100: the operations. 10 B*H*S^2*64 fused
// multiply-adds of the function (scores, dv, dp, dq, dk) in fp32 on the
// SIMT cores: at 256 ViT-B/16 images (S=197, W=768, H=12) 76.3 GFLOP,
// 1.14 ms at 66.9 TFLOP/s; at 256 text rows (S=77, H=8, causal) 7.77
// GFLOP, 0.116 ms. The kernel runs nine products per (query tile, key
// tile) pair, each cut to the pair's live 16-row groups (with_groups: at
// S=197 the last tile's 5 rows are one group; 150 GFLOP in all, against 232
// with S padded to 256), and skips a tile pair whose mask entries are all
// -inf (exactly: every term it would add is zero), a quarter of them at the
// causal text shape.
//
// The design: two passes, no atomics, so a run repeats bit for bit; 256
// threads a block over 64 rows of one (image, head), each thread a 4x4
// register micro-tile of every product, fed by float4 reads of shared
// memory (16 fused multiply-adds per two 16-B reads):
// - products over d (scores s = a.b^T, dp): the thread's rows
//   ty + 16r of A and tx + 16c of B, both stored row-major, four 16-B
//   chunks of d at a time;
// - products over rows (dq = ds.k, dv = p^T.g, dk = ds^T.q): the thread's
//   output rows ty + 16r and columns 4tx .. 4tx+3 of d; the row operand
//   (ds, p) is written by the threads that computed it into a transposed
//   tile whose row holds the thread's four rows side by side, so that both
//   operands are one float4 a step.
// Tiles are 64 rows of 64 fp32 in 16-B chunks XOR-swizzled by row
// (chunk ^ row % 8): the four rows (A) and eight rows (B) a warp reads at
// one chunk lie in distinct banks, as do the chunks of one row.
// - Pass 1, grid (ceil(S/64), H, B), 64 query rows: q' (q scaled in place
//   by the threads that loaded it) and g stay in shared memory; K and V
//   tiles stream twice through a 2-stage cp.async ring. Sweep 1: s, dp,
//   l and u; then inv and delta of each row (written to the fp32 workspace
//   for pass 2). Sweep 2: s, dp, ds, dq += ds.k.
// - Pass 2, grid (ceil(S/64), H, B), 64 key rows: k and v stay; q and g
//   tiles stream through the ring, with the rows' inv and delta from the
//   workspace. s^T = k.q'^T (q scaled as it is read), dp^T = v.g^T, p, ds;
//   dv += p^T.g, dk += ds^T.q.
// Pass 1 runs 2 + 3 products per tile pair and pass 2 four: nine. Pass 1
// (115 KB of shared memory) is built for 2 blocks per SM, at 128 registers;
// pass 2 (128 KB) for 1, with its two products over the query rows in one
// loop (tile_tn2). Keys past
// S get e = 0 (their rows are zero-filled and would score 0, exp2(0) = 1),
// queries past S in pass 2 p = ds = 0, a row the mask removes whole has
// l = 0, p = 0 and zero cotangents; -fmad=false (the build's) keeps
// s + mask*log2 e and the softmax arithmetic as separate roundings, and the
// products are explicit fmaf.

#pragma once

#include "mma_tiles.cuh"  // and common.cuh: cp.async, smem_addr

namespace aiic {
namespace {

constexpr int kTRows = 64;                   // rows of a block and of a streamed tile
constexpr int kTThreads = 256;               // 16 x 16 threads, a 4x4 micro-tile each
constexpr int kTTile = kTRows * kHeadDim;    // floats of one tile, 16 KB
constexpr int kTBlocks1 = 2, kTBlocks2 = 1;  // blocks per SM the passes are built for
// Dynamic shared memory: pass 1 q', g, two K and two V stages, ds^T (its
// space also takes the l/u partial sums), and the rows' inv and delta;
// pass 2 k, v, two q and two g stages, p^T and ds^T.
constexpr int kTSmem1 = (7 * kTTile + 2 * kTRows) * static_cast<int>(sizeof(float));
constexpr int kTSmem2 = 8 * kTTile * static_cast<int>(sizeof(float));

// Float offset of chunk ch (4 floats) of row r in a swizzled tile.
__device__ __forceinline__ int tsw(int r, int ch) { return r * kHeadDim + ((ch ^ (r & 7)) << 2); }

// Rows [0, n) of a 64-row tile from src (row r at src + r*ld) into dst by
// cp.async, rows at or past n zero-filled; 4 chunks a thread.
__device__ __forceinline__ void load_f32_tile(float* dst, const float* src, size_t ld, int n,
                                              int tid) {
#pragma unroll
  for (int i = 0; i < kTTile / 4 / kTThreads; ++i) {
    const int c = tid + i * kTThreads, r = c >> 4, ch = c & 15;
    const bool live = r < n;
    cp_async16(smem_addr(dst + tsw(r, ch)), src + (live ? r : 0) * ld + ch * 4, live ? 16 : 0);
  }
}

// acc[r][c] += sum_d A[ty + 16r][d] * B[tx + 16c][d] for r < NR, c < NC,
// d ascending (the order of the scalar forms' dot products); B's values
// times bmul first where kScaleB (q' = q*c as pass 2 reads q).
template <int NR, int NC, bool kScaleB>
__device__ __forceinline__ void tile_nt(float (&acc)[4][4], const float* A, const float* B,
                                        int ty, int tx, float bmul) {
#pragma unroll 4
  for (int ch = 0; ch < kHeadDim / 4; ++ch) {
    float4 a[NR], b[NC];
#pragma unroll
    for (int r = 0; r < NR; ++r) a[r] = *reinterpret_cast<const float4*>(A + tsw(ty + 16 * r, ch));
#pragma unroll
    for (int c = 0; c < NC; ++c) {
      b[c] = *reinterpret_cast<const float4*>(B + tsw(tx + 16 * c, ch));
      if (kScaleB) {
        b[c].x = b[c].x * bmul;
        b[c].y = b[c].y * bmul;
        b[c].z = b[c].z * bmul;
        b[c].w = b[c].w * bmul;
      }
    }
#pragma unroll
    for (int r = 0; r < NR; ++r)
#pragma unroll
      for (int c = 0; c < NC; ++c) {
        acc[r][c] = fmaf(a[r].x, b[c].x, acc[r][c]);
        acc[r][c] = fmaf(a[r].y, b[c].y, acc[r][c]);
        acc[r][c] = fmaf(a[r].z, b[c].z, acc[r][c]);
        acc[r][c] = fmaf(a[r].w, b[c].w, acc[r][c]);
      }
  }
}

// acc[r][c] += sum_{j < n} AT[j][4ty + r] * B[j][4tx + c] for r < NR, j
// ascending: AT holds a row operand transposed (write_t), B is row-major.
// kUnroll: steps of j unrolled (pass 1 at its 128-register cap takes 4; 8
// spills there).
template <int NR, int kUnroll>
__device__ __forceinline__ void tile_tn(float (&acc)[4][4], const float* AT, const float* B,
                                        int ty, int tx, int n) {
#pragma unroll(kUnroll)
  for (int j = 0; j < n; ++j) {
    const float4 a = *reinterpret_cast<const float4*>(AT + tsw(j, ty));
    const float4 b = *reinterpret_cast<const float4*>(B + tsw(j, tx));
    const float av[4] = {a.x, a.y, a.z, a.w}, bv[4] = {b.x, b.y, b.z, b.w};
#pragma unroll
    for (int r = 0; r < NR; ++r)
#pragma unroll
      for (int c = 0; c < 4; ++c) acc[r][c] = fmaf(av[r], bv[c], acc[r][c]);
  }
}

// tile_tn of two products over the same rows in one loop: acc1 += AT1^T.B1,
// acc2 += AT2^T.B2 (pass 2's dv and dk).
template <int NR, int kUnroll>
__device__ __forceinline__ void tile_tn2(float (&acc1)[4][4], const float* AT1, const float* B1,
                                         float (&acc2)[4][4], const float* AT2, const float* B2,
                                         int ty, int tx, int n) {
#pragma unroll(kUnroll)
  for (int j = 0; j < n; ++j) {
    const float4 a1 = *reinterpret_cast<const float4*>(AT1 + tsw(j, ty));
    const float4 b1 = *reinterpret_cast<const float4*>(B1 + tsw(j, tx));
    const float4 a2 = *reinterpret_cast<const float4*>(AT2 + tsw(j, ty));
    const float4 b2 = *reinterpret_cast<const float4*>(B2 + tsw(j, tx));
    const float av1[4] = {a1.x, a1.y, a1.z, a1.w}, bv1[4] = {b1.x, b1.y, b1.z, b1.w};
    const float av2[4] = {a2.x, a2.y, a2.z, a2.w}, bv2[4] = {b2.x, b2.y, b2.z, b2.w};
#pragma unroll
    for (int r = 0; r < NR; ++r)
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        acc1[r][c] = fmaf(av1[r], bv1[c], acc1[r][c]);
        acc2[r][c] = fmaf(av2[r], bv2[c], acc2[r][c]);
      }
  }
}

// v[r][c] (row ty + 16r, column tx + 16c of a micro-tile) into AT[tx + 16c]
// at the chunk ty for c < NC: the four rows side by side, one float4 per c.
template <int NC>
__device__ __forceinline__ void write_t(float* AT, const float (&v)[4][4], int ty, int tx) {
#pragma unroll
  for (int c = 0; c < NC; ++c)
    *reinterpret_cast<float4*>(AT + tsw(tx + 16 * c, ty)) =
        make_float4(v[0][c], v[1][c], v[2][c], v[3][c]);
}

// Live 16-row groups of a 64-row tile that starts at row r0 of S: 4 but at
// the tile past the last whole one.
__device__ __forceinline__ int live_groups(int S, int r0) { return min(4, (S - r0 + 15) >> 4); }

// f(NR, NC) with NR and NC as compile-time constants (std::integral_constant)
// for nr, nc in 1..4: a micro-tile's work shrinks with the tile's live rows
// and columns (at S=197 the last tile has 5 rows: one group of four).
template <typename F>
__device__ __forceinline__ void with_groups(int nr, int nc, F&& f) {
#define AIIC_GROUPS(R, C)                                              \
  case 4 * (R) + (C):                                                \
    f(std::integral_constant<int, R>(), std::integral_constant<int, C>()); \
    break;
  switch (4 * nr + nc) {
    AIIC_GROUPS(1, 1) AIIC_GROUPS(1, 2) AIIC_GROUPS(1, 3) AIIC_GROUPS(1, 4)
    AIIC_GROUPS(2, 1) AIIC_GROUPS(2, 2) AIIC_GROUPS(2, 3) AIIC_GROUPS(2, 4)
    AIIC_GROUPS(3, 1) AIIC_GROUPS(3, 2) AIIC_GROUPS(3, 3) AIIC_GROUPS(3, 4)
    AIIC_GROUPS(4, 1) AIIC_GROUPS(4, 2) AIIC_GROUPS(4, 3) AIIC_GROUPS(4, 4)
  }
#undef AIIC_GROUPS
}

// Whether any entry (i, j) of this thread's micro-tile is a live score: i
// and j below S and mask[i][j] > -inf (no mask: every entry below S). The
// micro-tile's rows are query rows (pass 1) or key rows (pass 2).
__device__ __forceinline__ bool any_live(const float* mask, int S, int i0, int j0, int ty, int tx,
                                         bool rows_are_queries) {
  bool live = false;
#pragma unroll
  for (int r = 0; r < 4; ++r)
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const int a = (rows_are_queries ? i0 : j0) + ty + 16 * r;
      const int b = (rows_are_queries ? j0 : i0) + tx + 16 * c;
      const int i = rows_are_queries ? a : b, j = rows_are_queries ? b : a;
      if (i < S && j < S) live |= !mask || mask[static_cast<size_t>(i) * S + j] != -INFINITY;
    }
  return live;
}

// Pass 1, grid (ceil(S/64), H, B): dq of 64 query rows, and inv and delta of
// each row into the workspace at (b*H + h)*S + i.
__global__ void __launch_bounds__(kTThreads, kTBlocks1)
core_bwd_tiled_query_kernel(const float* __restrict__ qkv, const float* __restrict__ g,
                            const float* __restrict__ mask, float* __restrict__ dqkv,
                            float* __restrict__ inv_ws, float* __restrict__ delta_ws, int S, int W,
                            int H, float qconst, float scale) {
  extern __shared__ __align__(16) float smf[];
  float* Qs = smf;
  float* Gs = Qs + kTTile;
  float* Ks = Gs + kTTile;      // 2 stages
  float* Vs = Ks + 2 * kTTile;  // 2 stages
  float* DT = Vs + 2 * kTTile;
  float* rowstat = DT + kTTile;  // inv[64], delta[64]
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int ty = (lane >> 3) + 4 * (warp >> 1), tx = (lane & 7) + 8 * (warp & 1);
  const int h = blockIdx.y, i0 = blockIdx.x * kTRows;
  const size_t row0 = static_cast<size_t>(blockIdx.z) * S, ld = 3 * static_cast<size_t>(W);
  const float* qb = qkv + row0 * ld + h * kHeadDim;
  const float* kb = qb + W;
  const float* vb = qb + 2 * W;
  const float* gb = g + row0 * W + h * kHeadDim;
  const int ntiles = (S + kTRows - 1) / kTRows;

  load_f32_tile(Qs, qb + i0 * ld, ld, S - i0, tid);
  load_f32_tile(Gs, gb + static_cast<size_t>(i0) * W, W, S - i0, tid);
  load_f32_tile(Ks, kb, ld, S, tid);
  load_f32_tile(Vs, vb, ld, S, tid);
  cp_async_commit();
  cp_async_wait_all();
#pragma unroll
  for (int i = 0; i < kTTile / 4 / kTThreads; ++i) {  // q' = q*c on the chunks this thread loaded
    const int c = tid + i * kTThreads;
    float4* p = reinterpret_cast<float4*>(Qs + tsw(c >> 4, c & 15));
    float4 v = *p;
    v.x = v.x * qconst;
    v.y = v.y * qconst;
    v.z = v.z * qconst;
    v.w = v.w * qconst;
    *p = v;
  }

  // Step t runs key tile t % ntiles from stage t % 2: sweep 1 for t <
  // ntiles, sweep 2 after. At its start stage t % 2 is complete and visible,
  // and every thread is done with step t - 1, so stage (t + 1) % 2 and ds^T
  // may be overwritten; a step whose tile pair has no live score is skipped.
  const auto begin_step = [&](int t) {
    cp_async_wait_all();
    const int j0 = (t % ntiles) * kTRows;
    const bool live = __syncthreads_or(any_live(mask, S, i0, j0, ty, tx, true));
    if (t + 1 < 2 * ntiles) {
      const int j1 = ((t + 1) % ntiles) * kTRows;
      load_f32_tile(Ks + ((t + 1) & 1) * kTTile, kb + j1 * ld, ld, S - j1, tid);
      load_f32_tile(Vs + ((t + 1) & 1) * kTTile, vb + j1 * ld, ld, S - j1, tid);
    }
    cp_async_commit();
    return live;
  };
  // s and dp of the pair's live groups into s, dp; s becomes e (0 for keys
  // past S).
  const auto scores = [&](auto R, auto C, int j0, const float* K, const float* V,
                          float (&s)[4][4], float (&dp)[4][4]) {
    constexpr int NR = decltype(R)::value, NC = decltype(C)::value;
    tile_nt<NR, NC, false>(s, Qs, K, ty, tx, 0.f);
    tile_nt<NR, NC, false>(dp, Gs, V, ty, tx, 0.f);
#pragma unroll
    for (int r = 0; r < NR; ++r)
#pragma unroll
      for (int c = 0; c < NC; ++c) {
        const int i = i0 + ty + 16 * r, j = j0 + tx + 16 * c;
        float sv = s[r][c];
        if (mask && i < S && j < S) sv = sv + mask[static_cast<size_t>(i) * S + j] * kLog2e;
        s[r][c] = j < S ? exp2f(fminf(sv, kExp2Clamp)) : 0.f;
      }
  };
  const int nr = live_groups(S, i0);

  float lp[4] = {0.f, 0.f, 0.f, 0.f}, up[4] = {0.f, 0.f, 0.f, 0.f};
  for (int t = 0; t < ntiles; ++t) {  // sweep 1: l and u
    if (!begin_step(t)) continue;
    const int j0 = t * kTRows;
    with_groups(nr, live_groups(S, j0), [&](auto R, auto C) {
      constexpr int NR = decltype(R)::value, NC = decltype(C)::value;
      float e[4][4] = {}, dp[4][4] = {};
      scores(R, C, j0, Ks + (t & 1) * kTTile, Vs + (t & 1) * kTTile, e, dp);
#pragma unroll
      for (int r = 0; r < NR; ++r)
#pragma unroll
        for (int c = 0; c < NC; ++c) {
          lp[r] += e[r][c];
          up[r] += e[r][c] * dp[r][c];
        }
    });
  }
  // l and u of each row over its 16 threads, in order; ds^T's space is free.
  float* red = DT;  // [64 rows][16 tx] l, then u
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    red[(ty + 16 * r) * 16 + tx] = lp[r];
    red[kTRows * 16 + (ty + 16 * r) * 16 + tx] = up[r];
  }
  __syncthreads();
  if (tid < kTRows) {
    float l = 0.f, u = 0.f;
    for (int x = 0; x < 16; ++x) {
      l += red[tid * 16 + x];
      u += red[kTRows * 16 + tid * 16 + x];
    }
    const float iv = 1.0f / fmaxf(l, 1e-38f);
    rowstat[tid] = iv;
    rowstat[kTRows + tid] = u * iv;
    if (i0 + tid < S) {
      const size_t at = (static_cast<size_t>(blockIdx.z) * H + h) * S + i0 + tid;
      inv_ws[at] = iv;
      delta_ws[at] = u * iv;
    }
  }
  __syncthreads();
  float inv[4], delta[4];
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    inv[r] = rowstat[ty + 16 * r];
    delta[r] = rowstat[kTRows + ty + 16 * r];
  }

  float dq[4][4] = {};
  for (int t = ntiles; t < 2 * ntiles; ++t) {  // sweep 2: ds, dq
    if (!begin_step(t)) continue;
    const int j0 = (t - ntiles) * kTRows;
    const float* K = Ks + (t & 1) * kTTile;
    with_groups(nr, live_groups(S, j0), [&](auto R, auto C) {
      constexpr int NR = decltype(R)::value, NC = decltype(C)::value;
      float ds[4][4] = {}, dp[4][4] = {};
      scores(R, C, j0, K, Vs + (t & 1) * kTTile, ds, dp);
#pragma unroll
      for (int r = 0; r < NR; ++r)
#pragma unroll
        for (int c = 0; c < NC; ++c) {
          const float p = ds[r][c] * inv[r];
          ds[r][c] = (p * (dp[r][c] - delta[r])) * scale;
        }
      write_t<NC>(DT, ds, ty, tx);
      __syncthreads();
      tile_tn<NR, 4>(dq, DT, K, ty, tx, min(kTRows, S - j0));
    });
  }
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int i = i0 + ty + 16 * r;
    if (i < S)
      *reinterpret_cast<float4*>(dqkv + (row0 + i) * ld + h * kHeadDim + 4 * tx) =
          make_float4(dq[r][0], dq[r][1], dq[r][2], dq[r][3]);
  }
}

// Pass 2, grid (ceil(S/64), H, B): dk and dv of 64 key rows, from pass 1's
// inv and delta.
__global__ void __launch_bounds__(kTThreads, kTBlocks2)
core_bwd_tiled_key_kernel(const float* __restrict__ qkv, const float* __restrict__ g,
                          const float* __restrict__ mask, const float* __restrict__ inv_ws,
                          const float* __restrict__ delta_ws, float* __restrict__ dqkv, int S,
                          int W, int H, float qconst, float scale) {
  extern __shared__ __align__(16) float smf[];
  float* Ks = smf;
  float* Vs = Ks + kTTile;
  float* Qs = Vs + kTTile;      // 2 stages
  float* Gs = Qs + 2 * kTTile;  // 2 stages
  float* PT = Gs + 2 * kTTile;
  float* DT = PT + kTTile;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int ty = (lane >> 3) + 4 * (warp >> 1), tx = (lane & 7) + 8 * (warp & 1);
  const int h = blockIdx.y, j0 = blockIdx.x * kTRows;
  const size_t row0 = static_cast<size_t>(blockIdx.z) * S, ld = 3 * static_cast<size_t>(W);
  const size_t stats = (static_cast<size_t>(blockIdx.z) * H + h) * S;
  const float* qb = qkv + row0 * ld + h * kHeadDim;
  const float* gb = g + row0 * W + h * kHeadDim;
  const int ntiles = (S + kTRows - 1) / kTRows;

  load_f32_tile(Ks, qb + W + j0 * ld, ld, S - j0, tid);
  load_f32_tile(Vs, qb + 2 * W + j0 * ld, ld, S - j0, tid);
  load_f32_tile(Qs, qb, ld, S, tid);
  load_f32_tile(Gs, gb, W, S, tid);
  cp_async_commit();

  const int nr = live_groups(S, j0);
  float dk[4][4] = {}, dv[4][4] = {};
  for (int t = 0; t < ntiles; ++t) {
    const int i0 = t * kTRows, st = t & 1;
    float inv[4], delta[4];  // of the query rows i0 + tx + 16c; 0 past S
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const int i = i0 + tx + 16 * c;
      inv[c] = i < S ? inv_ws[stats + i] : 0.f;
      delta[c] = i < S ? delta_ws[stats + i] : 0.f;
    }
    cp_async_wait_all();
    const bool live = __syncthreads_or(any_live(mask, S, i0, j0, ty, tx, false));
    if (t + 1 < ntiles) {
      const int i1 = i0 + kTRows;
      load_f32_tile(Qs + (st ^ 1) * kTTile, qb + i1 * ld, ld, S - i1, tid);
      load_f32_tile(Gs + (st ^ 1) * kTTile, gb + static_cast<size_t>(i1) * W, W, S - i1, tid);
    }
    cp_async_commit();
    if (!live) continue;
    const float* Q = Qs + st * kTTile;
    const float* G = Gs + st * kTTile;
    with_groups(nr, live_groups(S, i0), [&](auto R, auto C) {
      constexpr int NR = decltype(R)::value, NC = decltype(C)::value;
      float s[4][4] = {}, dp[4][4] = {};
      tile_nt<NR, NC, true>(s, Ks, Q, ty, tx, qconst);  // s^T[j][i] = k_j . q'_i
      tile_nt<NR, NC, false>(dp, Vs, G, ty, tx, 0.f);   // dp^T[j][i] = v_j . g_i
#pragma unroll
      for (int r = 0; r < NR; ++r)
#pragma unroll
        for (int c = 0; c < NC; ++c) {  // s becomes p, dp becomes ds
          const int j = j0 + ty + 16 * r, i = i0 + tx + 16 * c;
          float sv = s[r][c];
          if (mask && i < S && j < S) sv = sv + mask[static_cast<size_t>(i) * S + j] * kLog2e;
          const float e = i < S ? exp2f(fminf(sv, kExp2Clamp)) : 0.f;
          s[r][c] = e * inv[c];
          dp[r][c] = (s[r][c] * (dp[r][c] - delta[c])) * scale;
        }
      write_t<NC>(PT, s, ty, tx);
      write_t<NC>(DT, dp, ty, tx);
      __syncthreads();
      tile_tn2<NR, 8>(dv, PT, G, dk, DT, Q, ty, tx, min(kTRows, S - i0));
    });
  }
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int j = j0 + ty + 16 * r;
    if (j >= S) continue;
    float* out = dqkv + (row0 + j) * ld + h * kHeadDim + 4 * tx;
    *reinterpret_cast<float4*>(out + W) = make_float4(dk[r][0], dk[r][1], dk[r][2], dk[r][3]);
    *reinterpret_cast<float4*>(out + 2 * W) = make_float4(dv[r][0], dv[r][1], dv[r][2], dv[r][3]);
  }
}

// ws: 2*B*H*S floats (inv, then delta). mask may be null. Needs W == H*64.
cudaError_t launch_core_bwd_tiled(const float* qkv, const float* g, const float* mask, float* dqkv,
                                  float* ws, int B, int S, int W, int H, float qconst,
                                  cudaStream_t st) {
  if (S <= 0 || W != H * kHeadDim || !ws) return cudaErrorInvalidValue;
  AIIC_CHECK(cudaFuncSetAttribute(core_bwd_tiled_query_kernel,
                                  cudaFuncAttributeMaxDynamicSharedMemorySize, kTSmem1));
  AIIC_CHECK(cudaFuncSetAttribute(core_bwd_tiled_key_kernel,
                                  cudaFuncAttributeMaxDynamicSharedMemorySize, kTSmem2));
  const float scale = 1.0f / sqrtf(static_cast<float>(kHeadDim));  // as launch_core_bwd
  const dim3 grid((S + kTRows - 1) / kTRows, H, B);
  float* inv = ws;
  float* delta = ws + static_cast<size_t>(B) * H * S;
  core_bwd_tiled_query_kernel<<<grid, kTThreads, kTSmem1, st>>>(qkv, g, mask, dqkv, inv, delta, S,
                                                               W, H, qconst, scale);
  AIIC_CHECK(cudaGetLastError());
  core_bwd_tiled_key_kernel<<<grid, kTThreads, kTSmem2, st>>>(qkv, g, mask, inv, delta, dqkv, S, W,
                                                             H, qconst, scale);
  return cudaGetLastError();
}

// Blocks of the two passes resident on one SM into blocks[0] (pass 1) and
// blocks[1] (pass 2).
cudaError_t core_bwd_tiled_occupancy(int* blocks) {
  AIIC_CHECK(cudaFuncSetAttribute(core_bwd_tiled_query_kernel,
                                  cudaFuncAttributeMaxDynamicSharedMemorySize, kTSmem1));
  AIIC_CHECK(cudaFuncSetAttribute(core_bwd_tiled_key_kernel,
                                  cudaFuncAttributeMaxDynamicSharedMemorySize, kTSmem2));
  AIIC_CHECK(cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks, core_bwd_tiled_query_kernel,
                                                           kTThreads, kTSmem1));
  return cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks + 1, core_bwd_tiled_key_kernel,
                                                       kTThreads, kTSmem2);
}

}  // namespace
}  // namespace aiic
