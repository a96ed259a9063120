// The warpgroup tensor-core building blocks of the bf16 attention cores
// (sm_90a): attn_core_mma.cuh (the forward of rows 6, 7 and 8) and
// attn_core_bwd_mma.cuh (the backward of row 9).
//
// - 64 x 64 bf16 tiles (64 rows of a 64-wide head) in shared memory, in the
//   tensor cores' 128-B swizzled layout: rows of 128 B, 16-B chunk c of row r
//   at c ^ r % 8, 1024-B aligned. The swizzle also keeps ldmatrix and the
//   cp.async stores free of bank conflicts.
// - cp.async loads of such a tile, rows past the end zero-filled (src-size 0:
//   nothing is read), committed and waited as groups for a ring of stages.
// - wgmma m64n64k16 bf16 -> fp32 through inline PTX, A from registers (each
//   warp's 16 rows as the m16n8k16 A fragment) or from a K-major tile, B
//   from a tile by descriptor:
//   K-major (the tile's rows are B's columns, as K for Q.K^T) or N-major
//   (the tile's rows are B's rows, as V for P.V). Each warp's 16 rows of the
//   fp32 accumulator are eight m16n8 C fragments, which pack_bf16 turns into
//   the A fragments of the next product without leaving registers.

#pragma once

#include "common.cuh"

namespace aiic {
namespace {

constexpr int kMmaRows = 64;      // rows of a block's tile: 4 warps x 16
constexpr int kMmaKeys = 64;      // rows of a streamed tile
constexpr int kMmaThreads = 128;  // one warpgroup
constexpr int kTileElems = kMmaKeys * kHeadDim;  // one 64 x 64 bf16 tile, 8 KB

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// Element offset of (row, 16-B chunk) in a 128-B swizzled 64 x 64 bf16 tile.
__device__ __forceinline__ int swz(int row, int chunk) {
  return row * kHeadDim + ((chunk ^ (row & 7)) << 3);
}

// 16 bytes global -> shared; src_bytes 0 writes zeros and reads nothing.
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src, int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(src),
               "r"(src_bytes)
               : "memory");
}
// 4 bytes global -> shared, as cp_async16.
__device__ __forceinline__ void cp_async4(uint32_t dst, const void* src, int src_bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(dst), "l"(src),
               "r"(src_bytes)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}
// Orders this thread's shared-memory writes before the tensor cores' reads.
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr)
               : "memory");
}

// Descriptor of a 128-B swizzled tile at addr (rows of 128 B, 8-row groups
// 1024 B apart; the leading offset is unused by this layout).
__device__ __forceinline__ uint64_t sw128_desc(uint32_t addr) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) | (static_cast<uint64_t>(1) << 16) |
         (static_cast<uint64_t>(1024 >> 4) << 32) | (static_cast<uint64_t>(1) << 62);
}

// d += a . b on the warpgroup: a 64x16 bf16 from registers (each warp's 16
// rows as the m16n8k16 A fragment), b 16x64 bf16 in shared memory (kTransB:
// stored N-major), d 64x64 fp32 (each warp's 16 rows as eight m16n8 C
// fragments). A K-major b's next 16-deep step is 32 B further into each
// row (desc + 2); an N-major b's is 16 rows, 2048 B, further (desc + 128).
template <int kTransB>
__device__ __forceinline__ void wgmma_64x64x16(float (&d)[8][4], const uint32_t (&a)[4],
                                               uint64_t desc_b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, %38;\n}\n"
      : "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]),
        "+f"(d[1][0]), "+f"(d[1][1]), "+f"(d[1][2]), "+f"(d[1][3]),
        "+f"(d[2][0]), "+f"(d[2][1]), "+f"(d[2][2]), "+f"(d[2][3]),
        "+f"(d[3][0]), "+f"(d[3][1]), "+f"(d[3][2]), "+f"(d[3][3]),
        "+f"(d[4][0]), "+f"(d[4][1]), "+f"(d[4][2]), "+f"(d[4][3]),
        "+f"(d[5][0]), "+f"(d[5][1]), "+f"(d[5][2]), "+f"(d[5][3]),
        "+f"(d[6][0]), "+f"(d[6][1]), "+f"(d[6][2]), "+f"(d[6][3]),
        "+f"(d[7][0]), "+f"(d[7][1]), "+f"(d[7][2]), "+f"(d[7][3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(1), "n"(kTransB));
}
// d += a . b on the warpgroup with both operands in shared memory: a 64x16
// bf16 K-major (a tile's 64 rows, desc_a + 2 per 16-deep step), b as above.
// For an operand that every step of a loop reads: held as register A
// fragments across the loop, it gave wrong products from the loop's second
// step on, on the card, in the backward's two passes.
template <int kTransB>
__device__ __forceinline__ void wgmma_64x64x16_ss(float (&d)[8][4], uint64_t desc_a,
                                                  uint64_t desc_b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, 0, %35;\n}\n"
      : "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]),
        "+f"(d[1][0]), "+f"(d[1][1]), "+f"(d[1][2]), "+f"(d[1][3]),
        "+f"(d[2][0]), "+f"(d[2][1]), "+f"(d[2][2]), "+f"(d[2][3]),
        "+f"(d[3][0]), "+f"(d[3][1]), "+f"(d[3][2]), "+f"(d[3][3]),
        "+f"(d[4][0]), "+f"(d[4][1]), "+f"(d[4][2]), "+f"(d[4][3]),
        "+f"(d[5][0]), "+f"(d[5][1]), "+f"(d[5][2]), "+f"(d[5][3]),
        "+f"(d[6][0]), "+f"(d[6][1]), "+f"(d[6][2]), "+f"(d[6][3]),
        "+f"(d[7][0]), "+f"(d[7][1]), "+f"(d[7][2]), "+f"(d[7][3])
      : "l"(desc_a), "l"(desc_b), "r"(1), "n"(kTransB));
}
__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit_wait() {
  asm volatile("wgmma.commit_group.sync.aligned;\nwgmma.wait_group.sync.aligned 0;\n" :::
                   "memory");
}
// The accumulators are written by the tensor cores until the wait: keeps the
// compiler from reading them before it.
__device__ __forceinline__ void fence_regs(float (&d)[8][4]) {
#pragma unroll
  for (int n = 0; n < 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) asm volatile("" : "+f"(d[n][e])::"memory");
}

__device__ __forceinline__ void zero_acc(float (&d)[8][4]) {
#pragma unroll
  for (int n = 0; n < 8; ++n) d[n][0] = d[n][1] = d[n][2] = d[n][3] = 0.f;
}

__device__ __forceinline__ float2 unpack_bf16(uint32_t u) {  // exact: bf16 is fp32's top half
  return make_float2(__uint_as_float(u << 16), __uint_as_float(u & 0xffff0000u));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// 64 rows x 64 columns of bf16 from src (row r at src + r*ld) into a
// swizzled tile; rows at index >= n_rows are zero-filled. 4 chunks a thread:
// chunk c = tid + 128 i is row c / 8, 16-B chunk c % 8.
__device__ __forceinline__ void load_tile_async(bf16* dst, const bf16* src, size_t ld,
                                                int n_rows, int tid) {
#pragma unroll
  for (int i = 0; i < kTileElems / 8 / kMmaThreads; ++i) {
    const int c = tid + i * kMmaThreads, r = c >> 3, ch = c & 7;
    const bool live = r < n_rows;
    cp_async16(smem_addr(dst + swz(r, ch)), src + (live ? r : 0) * ld + ch * 8, live ? 16 : 0);
  }
}

// The A fragments of a warp's 16 rows (from row wrow) of a swizzled tile, one
// per 16-deep step, by ldmatrix.
__device__ __forceinline__ void load_a_frags(uint32_t (&a)[4][4], const bf16* tile, int wrow,
                                             int lane) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
    ldsm_x4(a[kk], smem_addr(tile + swz(wrow + (lane & 15), 2 * kk + (lane >> 4))));
}

// a = bf16(a * c), element by element: q' = bf16(q * c) in registers.
__device__ __forceinline__ void scale_a_frags(uint32_t (&a)[4][4], float c) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 v = unpack_bf16(a[kk][i]);
      a[kk][i] = pack_bf16(v.x * c, v.y * c);
    }
}

// dst = bf16(src * c) over the 16-B chunks of a swizzled tile that this
// thread loaded itself (load_tile_async's chunk c = tid + 128 i), so that
// right after its cp.async wait and before the fence that hands the tile to
// the tensor cores, no barrier between: q' = bf16(q * c). dst may be src.
__device__ __forceinline__ void scale_own_chunks(bf16* dst, const bf16* src, float c, int tid) {
#pragma unroll
  for (int i = 0; i < kTileElems / 8 / kMmaThreads; ++i) {
    const int k = tid + i * kMmaThreads, at = swz(k >> 3, k & 7);
    uint4 v = *reinterpret_cast<const uint4*>(src + at);
    uint32_t* w = reinterpret_cast<uint32_t*>(&v);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const float2 f = unpack_bf16(w[j]);
      w[j] = pack_bf16(f.x * c, f.y * c);
    }
    *reinterpret_cast<uint4*>(dst + at) = v;
  }
}

// A warp's 16 rows of an fp32 accumulator (the m16n8 C fragments: rows g and
// g + 8, columns 8n + 2 tig + {0, 1}), times the row factors inv[0] and
// inv[1], rounded to bf16 and written to rows [wrow, wrow + 16) of the
// swizzled tile stage (which only this warp may touch), then stored as 16-B
// vectors to dst (row r at dst + r*ld) for the rows below n_rows.
__device__ __forceinline__ void store_rows(bf16* stage, const float (&d)[8][4], const float* inv,
                                           bf16* dst, size_t ld, int n_rows, int wrow, int lane) {
  const int g = lane >> 2, tig = lane & 3, r0 = wrow + g, r1 = r0 + 8;
#pragma unroll
  for (int n = 0; n < 8; ++n) {
    *reinterpret_cast<__nv_bfloat162*>(stage + swz(r0, n) + 2 * tig) =
        __floats2bfloat162_rn(d[n][0] * inv[0], d[n][1] * inv[0]);
    *reinterpret_cast<__nv_bfloat162*>(stage + swz(r1, n) + 2 * tig) =
        __floats2bfloat162_rn(d[n][2] * inv[1], d[n][3] * inv[1]);
  }
  __syncwarp();
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int c = lane + 32 * i, r = wrow + (c >> 3), ch = c & 7;
    if (r < n_rows)
      *reinterpret_cast<uint4*>(dst + static_cast<size_t>(r) * ld + ch * 8) =
          *reinterpret_cast<const uint4*>(stage + swz(r, ch));
  }
}

// The first 1024-B aligned address at or after p (a swizzled tile's
// alignment; dynamic shared memory is asked for with 1 KB to spare).
__device__ __forceinline__ unsigned char* align1024(unsigned char* p) {
  const uint32_t a = smem_addr(p);
  return p + (((a + 1023u) & ~1023u) - a);
}

}  // namespace
}  // namespace aiic
