// Tensor-core attention core for Hopper (sm_90a), bf16, on the packed or the
// head-major (B, S, 3W) projection: rows 7 (bf16) and 8 of the TPU kernel
// table.
//
// Replaces, with attention_qkv.cu's two bf16 entries, the TPU kernels
// aiic_tpu/ops/attention.py::_attention_qkv_kernel (row 7, bf16) and
// _attention_qkv_hg_kernel (row 8). The fp32 row 7 and rows 1, 5 and 6 keep
// common.cuh's scalar attn_core_kernel.
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
// Only the order of the fp32 sums differs. The layout only moves columns,
// so head-major at hg = H equals packed bit for bit.

#pragma once

#include "common.cuh"

namespace aiic {
namespace {

constexpr int kMmaRows = 64;      // query rows of a block: 4 warps x 16
constexpr int kMmaKeys = 64;      // keys per K/V tile
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
// fragments).
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

__device__ __forceinline__ float2 unpack_bf16(uint32_t u) {  // exact: bf16 is fp32's top half
  return make_float2(__uint_as_float(u << 16), __uint_as_float(u & 0xffff0000u));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// 64 rows x 64 columns of bf16 from src (row r at src + r*ld) into a
// swizzled tile; rows at index >= n_rows are zero-filled. 4 chunks a thread.
__device__ __forceinline__ void load_tile_async(bf16* dst, const bf16* src, size_t ld,
                                                int n_rows, int tid) {
#pragma unroll
  for (int i = 0; i < kTileElems / 8 / kMmaThreads; ++i) {
    const int c = tid + i * kMmaThreads, r = c >> 3, ch = c & 7;
    const bool live = r < n_rows;
    cp_async16(smem_addr(dst + swz(r, ch)), src + (live ? r : 0) * ld + ch * 8, live ? 16 : 0);
  }
}

// Grid (ceil(S/64), hg, B * H/hg); head h = (z % (H/hg)) * hg + y of image
// z / (H/hg), columns as attn_core_kernel's (common.cuh) for the layout L.
template <QKVLayout L>
__global__ void __launch_bounds__(kMmaThreads, 4)
attn_core_mma_kernel(const bf16* __restrict__ qkv, const float* __restrict__ mask,
                     bf16* __restrict__ out, int S, int W, int groups, float qconst) {
  static_assert(L != QKVLayout::kSeparate, "the mma core reads one (B, S, 3W) projection");
  __shared__ __align__(1024) bf16 sq[kTileElems];  // Q, later the output rows
  __shared__ __align__(1024) bf16 sk[2][kTileElems];
  __shared__ __align__(1024) bf16 sv[2][kTileElems];

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, tig = lane & 3;  // the fragments' row group and column pair
  const int h = static_cast<int>(blockIdx.z % groups) * gridDim.y + blockIdx.y;
  const size_t row0 = static_cast<size_t>(blockIdx.z / groups) * S;
  const size_t ld = 3 * static_cast<size_t>(W);
  const int qo = L == QKVLayout::kHeadMajor ? 3 * h * kHeadDim : h * kHeadDim;
  const int ko = L == QKVLayout::kPacked ? qo + W : qo + kHeadDim;
  const int vo = L == QKVLayout::kPacked ? qo + 2 * W : qo + 2 * kHeadDim;
  const int q0 = blockIdx.x * kMmaRows;
  const int wrow = warp * 16;  // the warp's first row in the tile
  const int n_tiles = (S + kMmaKeys - 1) / kMmaKeys;
  const bf16* base = qkv + row0 * ld;

  load_tile_async(sq, base + static_cast<size_t>(q0) * ld + qo, ld, S - q0, tid);
  load_tile_async(sk[0], base + ko, ld, S, tid);
  load_tile_async(sv[0], base + vo, ld, S, tid);
  cp_async_commit();

  uint32_t qa[4][4];  // q' as A fragments, one per 16-wide depth step
  float o[8][4];      // the warp's 16 rows x 64 columns of the output, fp32
  float l[2] = {0.f, 0.f};  // the row sums of p for rows g and g + 8 (this thread's columns)
#pragma unroll
  for (int n = 0; n < 8; ++n) o[n][0] = o[n][1] = o[n][2] = o[n][3] = 0.f;
  const uint32_t k_addr = smem_addr(sk[0]), v_addr = smem_addr(sv[0]);

  for (int t = 0; t < n_tiles; ++t) {
    const int st = t & 1;
    // Tile t has landed, and every warp is done with tile t-1, so its stage
    // takes the load of tile t+1 while tile t is computed: one barrier a tile.
    cp_async_wait_all();
    fence_proxy_async();
    __syncthreads();
    if (t + 1 < n_tiles) {
      const int k1 = (t + 1) * kMmaKeys;
      load_tile_async(sk[st ^ 1], base + static_cast<size_t>(k1) * ld + ko, ld, S - k1, tid);
      load_tile_async(sv[st ^ 1], base + static_cast<size_t>(k1) * ld + vo, ld, S - k1, tid);
    }
    cp_async_commit();

    if (t == 0) {
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        const int r = wrow + (lane & 15);
        ldsm_x4(qa[kk], smem_addr(sq + swz(r, 2 * kk + (lane >> 4))));
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const float2 v = unpack_bf16(qa[kk][i]);
          qa[kk][i] = pack_bf16(v.x * qconst, v.y * qconst);
        }
      }
    }

    // s = q' . k^T: 64 rows x 64 keys, depth 64 in four steps of 16 (32 B
    // further into each swizzled row).
    float s[8][4];
#pragma unroll
    for (int n = 0; n < 8; ++n) s[n][0] = s[n][1] = s[n][2] = s[n][3] = 0.f;
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

    // o += bf16(p) . v: 64 rows x 64 columns, 64 keys in four steps of 16
    // (16 rows, 2048 B, further into the tile).
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
  const float inv0 = 1.0f / fmaxf(l[0], 1e-38f), inv1 = 1.0f / fmaxf(l[1], 1e-38f);
  // Each warp stages its own 16 rows in the Q tile (only it read them).
  const int r0 = wrow + g, r1 = r0 + 8;
#pragma unroll
  for (int n = 0; n < 8; ++n) {
    *reinterpret_cast<__nv_bfloat162*>(sq + swz(r0, n) + 2 * tig) =
        __floats2bfloat162_rn(o[n][0] * inv0, o[n][1] * inv0);
    *reinterpret_cast<__nv_bfloat162*>(sq + swz(r1, n) + 2 * tig) =
        __floats2bfloat162_rn(o[n][2] * inv1, o[n][3] * inv1);
  }
  __syncwarp();
  bf16* dst = out + (row0 + q0) * W + h * kHeadDim;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int c = lane + 32 * i, r = wrow + (c >> 3), ch = c & 7;
    if (q0 + r < S)
      *reinterpret_cast<uint4*>(dst + static_cast<size_t>(r) * W + ch * 8) =
          *reinterpret_cast<const uint4*>(sq + swz(r, ch));
  }
}

// qkv (B*S, 3W) bf16 -> out (B*S, W) bf16; mask (S, S) fp32 or null. Packed
// [Q | K | V] columns, or head-major [q_h | k_h | v_h] with kHeadMajor.
// Needs W == H*64 and H % head_group == 0 (head_group 0: all heads). Shared
// memory does not depend on S.
template <bool kHeadMajor>
cudaError_t launch_attn_core_mma(const bf16* qkv, const float* mask, bf16* out, int B, int S,
                                 int W, int H, float qconst, cudaStream_t st,
                                 int head_group = 0) {
  constexpr QKVLayout L = kHeadMajor ? QKVLayout::kHeadMajor : QKVLayout::kPacked;
  if (head_group <= 0) head_group = H;
  if (B <= 0 || S <= 0 || H <= 0 || W != H * kHeadDim || H % head_group)
    return cudaErrorInvalidValue;
  const dim3 grid((S + kMmaRows - 1) / kMmaRows, head_group, B * (H / head_group));
  if (grid.z > 65535u) return cudaErrorInvalidValue;
  attn_core_mma_kernel<L><<<grid, kMmaThreads, 0, st>>>(qkv, mask, out, S, W, H / head_group,
                                                        qconst);
  return cudaGetLastError();
}

}  // namespace
}  // namespace aiic
