// The register-tiled SIMT building blocks of the fp32 attention cores
// (sm_90a): attn_core_f32.cuh (the forward of rows 6 and 7) and
// attn_core_bwd_f32.cuh (the backward of row 9).
//
// - 64 x 64 fp32 tiles (64 rows of a 64-wide head) in shared memory, in one
//   of two layouts of 16-B chunks: Swizzled (chunk c of row r at c ^ r % 8,
//   no padding) for the operands of tile_nt, where a warp reads one chunk of
//   four (A) or eight (B) rows, which then lie in distinct banks; Rows<ld>
//   (plain rows of ld floats) for operands that tile_tn alone reads, a warp
//   reading distinct chunks of one row, conflict-free in any layout, at
//   offsets fixed at compile time.
// - cp.async loads of such a tile, rows past the end zero-filled.
// - 256 threads a block as 16 x 16 (ty, tx): a warp holds 4 ty by 8 tx
//   (ty = lane / 8 + 4 (warp / 2), tx = lane % 8 + 8 (warp % 2)), each
//   thread a 4 x 4 register micro-tile of a product, fed by float4 reads of
//   shared memory (16 fused multiply-adds per two 16-B reads):
//   - products over d (tile_nt: s = a.b^T): the thread's rows ty + 16r of
//     A and tx + 16c of B, both stored row-major;
//   - products over rows (tile_tn: o = p.v): the thread's output rows
//     ty + 16r and columns 4tx .. 4tx+3 of d; the row operand (p) is written
//     by the threads that made it into a transposed tile (write_t) whose row
//     holds the thread's four rows side by side, so that both operands are
//     one float4 a step.
// - with_groups cuts each product to a tile pair's live 16-row groups (at
//   S=197 the last 64-row tile has 5 rows: one group), and any_live finds a
//   tile pair whose mask entries are all -inf (skipped exactly: every term
//   it would add is zero).
// The products are explicit fmaf in d or row order ascending; the build's
// -fmad=false keeps every other a*b + c two roundings.

#pragma once

#include "mma_tiles.cuh"  // and common.cuh: cp.async, smem_addr, kHeadDim

namespace aiic {
namespace {

constexpr int kTRows = 64;                 // rows of a block and of a streamed tile
constexpr int kTThreads = 256;             // 16 x 16 threads, a 4x4 micro-tile each
constexpr int kTTile = kTRows * kHeadDim;  // floats of one tile, 16 KB

// Float offset of chunk ch (4 floats) of row r in a swizzled tile.
__device__ __forceinline__ int tsw(int r, int ch) { return r * kHeadDim + ((ch ^ (r & 7)) << 2); }

// The two tile layouts: where chunk ch of row r lies.
struct Swizzled {
  static __device__ __forceinline__ int at(int r, int ch) { return tsw(r, ch); }
};
template <int kLd>
struct Rows {
  static __device__ __forceinline__ int at(int r, int ch) { return r * kLd + (ch << 2); }
};

// Rows [0, n) of a 64-row tile from src (row r at src + r*ld) into dst in
// layout L by cp.async, rows at or past n zero-filled; 4 chunks a thread.
template <typename L = Swizzled>
__device__ __forceinline__ void load_f32_tile(float* dst, const float* src, size_t ld, int n,
                                              int tid) {
#pragma unroll
  for (int i = 0; i < kTTile / 4 / kTThreads; ++i) {
    const int c = tid + i * kTThreads, r = c >> 4, ch = c & 15;
    const bool live = r < n;
    cp_async16(smem_addr(dst + L::at(r, ch)), src + (live ? r : 0) * ld + ch * 4, live ? 16 : 0);
  }
}

// The chunks of a tile that this thread loaded (load_f32_tile's), times mul
// in place, once its own copies have landed (q' = q*c).
__device__ __forceinline__ void scale_f32_tile(float* tile, float mul, int tid) {
#pragma unroll
  for (int i = 0; i < kTTile / 4 / kTThreads; ++i) {
    const int c = tid + i * kTThreads;
    float4* p = reinterpret_cast<float4*>(tile + tsw(c >> 4, c & 15));
    float4 v = *p;
    v.x = v.x * mul;
    v.y = v.y * mul;
    v.z = v.z * mul;
    v.w = v.w * mul;
    *p = v;
  }
}

// acc[r][c] += sum_d A[ty + 16r][d] * B[tx + 16c][d] for r < NR, c < NC,
// d ascending (the order of the scalar forms' dot products); B's values
// times bmul first where kScaleB (q' = q*c as row 9's pass 2 reads q).
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
// ascending: AT holds a row operand transposed (write_t), B is row-major,
// in layouts LA and LB. kUnroll: steps of j unrolled (8 spilled in row 9's
// pass 1 at its 128-register cap, which takes 4).
template <int NR, int kUnroll, typename LA = Swizzled, typename LB = Swizzled>
__device__ __forceinline__ void tile_tn(float (&acc)[4][4], const float* AT, const float* B,
                                        int ty, int tx, int n) {
#pragma unroll(kUnroll)
  for (int j = 0; j < n; ++j) {
    const float4 a = *reinterpret_cast<const float4*>(AT + LA::at(j, ty));
    const float4 b = *reinterpret_cast<const float4*>(B + LB::at(j, tx));
    const float av[4] = {a.x, a.y, a.z, a.w}, bv[4] = {b.x, b.y, b.z, b.w};
#pragma unroll
    for (int r = 0; r < NR; ++r)
#pragma unroll
      for (int c = 0; c < 4; ++c) acc[r][c] = fmaf(av[r], bv[c], acc[r][c]);
  }
}

// v[r][c] (row ty + 16r, column tx + 16c of a micro-tile) into AT[tx + 16c]
// at the chunk ty for c < NC, in layout L: the four rows side by side, one
// float4 per c.
template <int NC, typename L = Swizzled>
__device__ __forceinline__ void write_t(float* AT, const float (&v)[4][4], int ty, int tx) {
#pragma unroll
  for (int c = 0; c < NC; ++c)
    *reinterpret_cast<float4*>(AT + L::at(tx + 16 * c, ty)) =
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
// micro-tile's rows are query rows (the forward, row 9's pass 1) or key rows
// (row 9's pass 2).
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

}  // namespace
}  // namespace aiic
