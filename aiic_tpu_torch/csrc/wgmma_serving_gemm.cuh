// The Hopper GEMM stage of the int8 serving half-blocks (sm_90a), and the
// sequences of rows 1-4 of the TPU kernel table that run on it:
//
//   int8_qkv_stage_wgmma  LN1 -> per-row int8 quantization -> the int8 QKV
//                         product on this stage (EpiQKV): row 1's first two
//                         launches, and alone the projection of the large-S
//                         int8 attention path;
//   int8_attn_half_wgmma  the stage above, the tensor-core core of rows 6-8
//                         (attn_core_mma.cuh, packed layout), the bf16
//                         out-projection on this stage (EpiOutProj): row 1;
//   int8_mlp_half_wgmma   LN2 -> int8 c_fc on this stage (EpiGelu) -> the
//                         row quantizer of y -> int8 c_proj on this stage:
//                         with C = 1 (EpiResidual) row 2; with the hidden
//                         axis in C chunks, y quantized per (row, chunk) and
//                         the chunk sums folded into c_proj's mainloop
//                         (EpiChunkResidual), row 3.
//
// They replace, with int8_attention.cu, int8_mlp.cu and int8_block.cu, the
// TPU kernels aiic_tpu/ops/quant.py::_int8_attn_kernel
// (int8_ln_qkv_attention), _int8_mlp_kernel_3d and _int8_mlp_chunk_kernel
// (int8_ln_mlp, full and chunked) and _int8_block_kernel /
// _int8_block_chunk_kernel (int8_block: row 1, then row 2 or row 3). The
// WMMA forms of int8_halves.cuh (int8_attn_half, int8_mlp_half: common.cuh's
// gemm_kernel and scalar attn_core_kernel) stay, reachable through the same
// C entries with form 1; rows 15-16 run them. The bf16 half-blocks of rows
// 5 and 10 (ln_qkv_attention.cu, ln_mlp.cu) run their products on the bf16
// form of the stage too (EpiBiasQKV, EpiOutProj; EpiBiasGelu, EpiMlpOut),
// and so do the training text block's forward and backward (rows 11-14,
// text_block.cuh and text_block_int8.cu, with their own epilogues): their
// backward reads each weight transposed (dy.W2^T, dfq.W1^T, dy1.Wo^T,
// dqkv.Wqkv^T), which the bf16 form takes as a K-major B (kKMajorB, the
// weight (N, K) as it lies, no transposed copy), and row 14's chunked dh2
// product folds its chunk sums as row 3's c_proj does (EpiChunkRowScale).
//
// What bounds the stage on the H100: at B=256 ViT-B/16 (50,432 rows, K = W =
// 768) the int8 products are 2*rows*K*N operations, 0.060 ms (QKV), 0.080
// (c_fc) and 0.080 (c_proj) at 1,979 TOP/s; the bf16 out-projection 0.060
// ms at 989 TFLOP/s. Its largest store is c_fc's fp32 y, 620 MB: 0.185 ms
// at 3.35 TB/s, so c_fc is bound by its bytes and the others by their
// operations or close to it.
//
// The design:
// - A block owns a 128 x 128 output tile: two consumer warpgroups of 64 rows
//   each and one producer warp (288 threads). The producer thread keeps a
//   3-stage ring of 128-B K-slices full by TMA (tma_load_2d on 128-B
//   swizzled tensor maps, an mbarrier pair per stage, wgmma_gemm.cuh's
//   Ring): a slice is 128 rows of A and 128 columns of B, 32 KB, so a block
//   takes 97 KB of shared memory and two blocks share an SM, one's epilogue
//   overlapping the other's products. TMA zero-fills rows of A past M.
// - The consumers read both operands by descriptor: int8 s8 m64n128k32
//   with A K-major and B = w^T (N, K), K-major, since 8-bit wgmma takes
//   K-major B only (the caller keeps that copy, made once per weight); bf16
//   m64n128k16 with A K-major and B = w (K, N) as it lies, MN-major (two
//   64-column atoms a slice, as row 17's bf16 body reads w), or, for a . w^T
//   with w stored (N, K), K-major as A is (one 128-row box a slice, the
//   wgmma without the B transpose). Each slice is
//   released to the producer once the next slice's products are issued and
//   its own are done (wgmma_wait<1>).
// - The epilogue applies an existing per-element functor to each
//   accumulator (EpiQKV, EpiGelu<kExp2>, EpiResidual, EpiOutProj; rows 5 and
//   10's EpiBiasQKV, EpiBiasGelu, EpiMlpOut) at (row, column), rows past M
//   skipped. For QKV and c_fc (int8 and bf16) the accumulators are
//   first staged through shared memory (the ring's space) so that each warp
//   walks 32 consecutive columns of a row: the functors' loads of the
//   column vectors and their stores coalesce, where the fragment layout (8
//   rows x 4 column pairs a warp) writes 2-8 B pieces to 8 rows. The two
//   residual epilogues run on the fragments, which measured faster for
//   them (StagedEpilogue). The int8 products accumulate in int32,
//   exact in any order, so with the WMMA form's functors the int8 stages
//   give the WMMA form's bits; the bf16 out-projection sums fp32 in another
//   order.
// - The short K streams (K = W: six 128-B slices in int8, twelve in bf16;
//   c_proj K = 4W) are the open question: each slice feeds one 64x128
//   product a warpgroup, not the probe's 64.
// - Row 3's c_proj folds the chunk sums the way the TPU kernel does
//   (_int8_mlp_chunk_kernel's fp32 accumulator seeded with x): each
//   consumer thread keeps its int32 fragment of the current chunk (M/C deep,
//   a whole number of 128-B slices) and an fp32 running total of the same
//   64 elements, seeded with x. At a chunk's last slice it waits for its
//   products (wgmma_wait<0>), adds float(acc) * ys[r, c] * s2[n] to the
//   total (EpiMlpChunk's expression, added in mlp_chunk_sum_kernel's order)
//   and restarts the fragment; b2 is added last and the sum rounded to bf16
//   once. The WMMA form's C fp32 partial slices (C x rows x W, 1.08 GB at
//   L/14 B=256 C=4) and its sum pass are gone. The 64 extra fp32 registers
//   do not fit the 112 a thread that two 288-thread blocks an SM leave, so
//   the folded kernel is bounded to one block an SM (__launch_bounds__(288,
//   1)): its epilogue no longer overlaps a second block's products.

#pragma once

#include "attn_core_mma.cuh"
#include "int8_halves.cuh"
#include "wgmma_gemm.cuh"

namespace aiic {
namespace {

constexpr int kSBM = 128, kSBN = 128;                       // block tile
constexpr int kSConsumerWarps = 8;                          // two consumer warpgroups
constexpr int kSThreads = 32 * kSConsumerWarps + 32;        // and one producer warp
constexpr int kSStages = 3;
constexpr int kSSliceBytes = kSBM * 128;                    // a 128-B K-slice of 128 rows
constexpr int kSStageBytes = 2 * kSSliceBytes;              // A and B
constexpr int kSSmem = 1024 + kSStages * kSStageBytes + 2 * kSStages * 8;
// The epilogue's staged tile: 128 rows of 128 accumulators, rows 136 words
// apart (a half-warp's 8-B stores of 4 rows x 4 column pairs fall in
// distinct banks), in the ring's space.
constexpr int kSTileLd = 136;
static_assert(2 * 64 * kSTileLd * 4 <= kSStages * kSStageBytes, "the staged tile fits the ring");

// Which epilogues walk rows through the staged tile: those whose stores
// dominate, the 2304-column bf16 qkv and c_fc's fp32 y (0.57 -> 0.28 and
// 0.74 -> 0.53 ms at 256 ViT-B/16 images), and their bf16 twins of rows 5
// and 10 (EpiBiasQKV, EpiBiasGelu: the same wide stores). The residual
// epilogues read x and write 768 columns; staged they ran 0.42 -> 0.45
// (c_proj) and 0.30 -> 0.35 ms (out-projection), so they stay on the
// fragments (one card call, NVIDIA H100 80GB HBM3, 700 W).
template <typename Epi> struct StagedEpilogue { static constexpr bool value = false; };
template <> struct StagedEpilogue<EpiQKV> { static constexpr bool value = true; };
template <> struct StagedEpilogue<EpiGelu<Gelu::kExp2>> { static constexpr bool value = true; };
template <> struct StagedEpilogue<EpiBiasQKV> { static constexpr bool value = true; };
template <> struct StagedEpilogue<EpiBiasGelu> { static constexpr bool value = true; };

// Epilogues with a per-column cache (the text block's with a rank-r term:
// Column, column_fits(), column(n), at(r, n, acc, column); text_block.cuh's
// AIIC_LORA_COLUMN) walk rows through the staged tile too, each thread
// loading its column's cache once for the 64 rows, where column_fits().
template <typename E, typename = void> struct ColumnCached : std::false_type {};
template <typename E>
struct ColumnCached<E, std::void_t<typename E::Column>> : std::true_type {};

// Row 3's c_proj with the chunk sums folded in: out = bf16((((x + p_0) +
// p_1) + ... + p_{C-1}) + b2), p_c = float(acc_c) * ys[r, c] * s2[n] with
// acc_c the product over chunk c's M/C-deep slice of the depth. Not a
// per-element functor like the others: the kernel keeps the running total
// (ChunkFold) and calls seed, fold and store on a consumer thread's
// fragment: rows r0 and r0 + 8, column pairs col + 8j (j < 16), laid out as
// the m64n128 accumulator is (acc[4j + {0, 1}] at r0, acc[4j + {2, 3}] at
// r0 + 8). Rows past M read nothing and store nothing.
struct EpiChunkResidual {
  const float* ys;  // (rows, n_chunks): y's scale per (row, chunk)
  const float* s;
  const float* b;
  const bf16* x;
  bf16* out;
  int n_cols, n_chunks;

  __device__ __forceinline__ void seed(float (&t)[64], int r0, int col, int M) const {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = r0 + 8 * h;
      const bf16* xr = x + static_cast<size_t>(r) * n_cols + col;
#pragma unroll
      for (int j = 0; j < 16; ++j) {
        t[4 * j + 2 * h] = r < M ? __bfloat162float(xr[8 * j]) : 0.f;
        t[4 * j + 2 * h + 1] = r < M ? __bfloat162float(xr[8 * j + 1]) : 0.f;
      }
    }
  }
  __device__ __forceinline__ void fold(float (&t)[64], const int (&acc)[64], int c, int r0,
                                       int col, int M) const {
    const float y0 = r0 < M ? ys[static_cast<size_t>(r0) * n_chunks + c] : 0.f;
    const float y1 = r0 + 8 < M ? ys[static_cast<size_t>(r0 + 8) * n_chunks + c] : 0.f;
#pragma unroll
    for (int j = 0; j < 16; ++j) {
      const float s0 = s[col + 8 * j], s1 = s[col + 8 * j + 1];
      t[4 * j] = t[4 * j] + static_cast<float>(acc[4 * j]) * y0 * s0;
      t[4 * j + 1] = t[4 * j + 1] + static_cast<float>(acc[4 * j + 1]) * y0 * s1;
      t[4 * j + 2] = t[4 * j + 2] + static_cast<float>(acc[4 * j + 2]) * y1 * s0;
      t[4 * j + 3] = t[4 * j + 3] + static_cast<float>(acc[4 * j + 3]) * y1 * s1;
    }
  }
  __device__ __forceinline__ void store(const float (&t)[64], int r0, int col, int M) const {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = r0 + 8 * h;
      if (r >= M) continue;
      bf16* o = out + static_cast<size_t>(r) * n_cols + col;
#pragma unroll
      for (int j = 0; j < 16; ++j) {
        o[8 * j] = __float2bfloat16_rn(t[4 * j + 2 * h] + b[col + 8 * j]);
        o[8 * j + 1] = __float2bfloat16_rn(t[4 * j + 2 * h + 1] + b[col + 8 * j + 1]);
      }
    }
  }
};

// The chunked cotangent product through an int8 weight of the text block's
// backward (row 14's dh2 at n_chunks > 1), with the chunk sums folded in as
// EpiChunkResidual folds them: out = ((0 + p_0) + p_1 + ... + p_{C-1}) +
// tail(r, n), fp32, p_c = float(acc_c) * qs[r, c] (dfq * s1 quantized per
// (row, chunk), qs its scales), the tail (the LoRA term, or nothing) added
// last. That is the order of the WMMA form's split product (EpiChunkPart)
// and sum_partials_kernel, so the two give the same bits.
struct NoTail {
  __device__ __forceinline__ float operator()(int, int) const { return 0.f; }
};
template <typename Tail> struct EpiChunkRowScale {
  const float* qs;  // (rows, n_chunks)
  Tail tail;
  float* out;
  int n_cols, n_chunks;

  __device__ __forceinline__ void seed(float (&t)[64], int, int, int) const {
#pragma unroll
    for (int e = 0; e < 64; ++e) t[e] = 0.f;
  }
  __device__ __forceinline__ void fold(float (&t)[64], const int (&acc)[64], int c, int r0,
                                       int, int M) const {
    const float y0 = r0 < M ? qs[static_cast<size_t>(r0) * n_chunks + c] : 0.f;
    const float y1 = r0 + 8 < M ? qs[static_cast<size_t>(r0 + 8) * n_chunks + c] : 0.f;
#pragma unroll
    for (int j = 0; j < 16; ++j) {
      t[4 * j] = t[4 * j] + static_cast<float>(acc[4 * j]) * y0;
      t[4 * j + 1] = t[4 * j + 1] + static_cast<float>(acc[4 * j + 1]) * y0;
      t[4 * j + 2] = t[4 * j + 2] + static_cast<float>(acc[4 * j + 2]) * y1;
      t[4 * j + 3] = t[4 * j + 3] + static_cast<float>(acc[4 * j + 3]) * y1;
    }
  }
  __device__ __forceinline__ void store(const float (&t)[64], int r0, int col, int M) const {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = r0 + 8 * h;
      if (r >= M) continue;
      float* o = out + static_cast<size_t>(r) * n_cols + col;
#pragma unroll
      for (int j = 0; j < 16; ++j) {
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          const float v = t[4 * j + 2 * h + i];
          if constexpr (std::is_same<Tail, NoTail>::value)
            o[8 * j + i] = v;
          else
            o[8 * j + i] = v + tail(r, col + 8 * j + i);
        }
      }
    }
  }
};

template <typename Epi> struct ChunkFold { static constexpr bool value = false; };
template <> struct ChunkFold<EpiChunkResidual> { static constexpr bool value = true; };
template <typename Tail> struct ChunkFold<EpiChunkRowScale<Tail>> {
  static constexpr bool value = true;
};

// Waits until `count` threads (whole warps) have arrived at barrier `id`
// (1-15: 0 is __syncthreads', which the exited producer warp never reaches).
__device__ __forceinline__ void named_barrier_sync(int id, int count) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(count) : "memory");
}

// C (M, N) = A (M, K) . B through epi(r, n, acc) for r < M (or, for
// EpiChunkResidual and EpiChunkRowScale, the chunk sums folded as they say).
// int8: A (M, K) and B = w^T (N, K), both K-major; bf16: A (M, K) K-major
// and B = w (K, N), MN-major, or with kKMajorB B = w (N, K) as it lies,
// K-major (the backward's products through a weight read transposed, a .
// w^T, with no transposed copy). Grid (N / 128, ceil(M / 128)). Two blocks
// an SM, the folds one.
template <typename T, typename Epi, bool kKMajorB = false>
__global__ void __launch_bounds__(kSThreads, ChunkFold<Epi>::value ? 1 : 2)
wgmma_stage_kernel(__grid_constant__ const CUtensorMap tma, __grid_constant__ const CUtensorMap tmb,
                   int M, int K, Epi epi) {
  constexpr bool kInt8 = std::is_same<T, int8_t>::value;
  constexpr int kSliceK = kInt8 ? 128 : 64;  // K elements in a 128-B slice
  extern __shared__ unsigned char smem_raw[];
  unsigned char* sm = align1024(smem_raw);
  uint64_t* full = reinterpret_cast<uint64_t*>(sm + kSStages * kSStageBytes);
  uint64_t* empty = full + kSStages;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int m0 = blockIdx.y * kSBM, n0 = blockIdx.x * kSBN;
  const int kslices = K / kSliceK;
  if (tid == 0) {
    for (int s = 0; s < kSStages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], kSConsumerWarps);
    }
    fence_barrier_init();
  }
  __syncthreads();

  if (warp == kSConsumerWarps) {  // producer
    if (lane == 0) {
      Ring<kSStages> ring;
      for (int kt = 0; kt < kslices; ++kt, ring.advance()) {
        mbar_wait(&empty[ring.stage], ring.phase ^ 1u);
        unsigned char* as = sm + ring.stage * kSStageBytes;
        unsigned char* bs = as + kSSliceBytes;
        mbar_expect_tx(&full[ring.stage], kSStageBytes);
        tma_load_2d(as, &tma, &full[ring.stage], kt * kSliceK, m0);
        if constexpr (kInt8 || kKMajorB) {  // 128 rows of B, one 128-B K-slice
          tma_load_2d(bs, &tmb, &full[ring.stage], kt * kSliceK, n0);
        } else {
#pragma unroll
          for (int a = 0; a < 2; ++a)  // two 64-column atoms of 64 K rows
            tma_load_2d(bs + a * 8192, &tmb, &full[ring.stage], n0 + 64 * a, kt * 64);
        }
      }
    }
    return;
  }

  using Acc = typename std::conditional<kInt8, int, float>::type;
  constexpr bool kFold = ChunkFold<Epi>::value;
  const int wg = warp >> 2;
  Acc acc[64];
#pragma unroll
  for (int e = 0; e < 64; ++e) acc[e] = 0;
  // The fold's fp32 running total of the fragment (rows fr, fr + 8, column
  // pairs fc + 8j), seeded with x; its chunk and the slices left in it.
  float total[kFold ? 64 : 1];
  int chunk = 0, left = 0;
  const int fr = m0 + 64 * wg + 16 * (warp & 3) + (lane >> 2), fc = n0 + 2 * (lane & 3);
  if constexpr (kFold) {
    epi.seed(total, fr, fc, M);
    left = kslices / epi.n_chunks;
  }
  Ring<kSStages> ring;
  int prev = -1;
  for (int kt = 0; kt < kslices; ++kt, ring.advance()) {
    mbar_wait(&full[ring.stage], ring.phase);
    const uint32_t as = smem_addr(sm + ring.stage * kSStageBytes);
    const uint64_t da = sw128_desc(as + wg * 64 * 128);  // the warpgroup's 64 rows
    wgmma_fence();
#pragma unroll
    for (int k = 0; k < 4; ++k) {  // four 32-B K steps of the slice
      if constexpr (kInt8)
        wgmma_s8_m64n128k32_ss(acc, da + 2 * k, sw128_desc(as + kSSliceBytes) + 2 * k, 1);
      else if constexpr (kKMajorB)  // K-major w: a 16-deep step is 32 B along each row
        wgmma_bf16_m64n128k16_ss<0>(acc, da + 2 * k, sw128_desc(as + kSSliceBytes) + 2 * k);
      else  // MN-major w: a 16-deep step is 16 K rows, 2048 B
        wgmma_bf16_m64n128k16_ss(acc, da + 2 * k,
                                 sw128_desc_mn(as + kSSliceBytes + 2048 * k, 8192));
    }
    wgmma_commit();
    if (prev >= 0) {  // the previous slice's products are done: release it
      wgmma_wait<1>();
      __syncwarp();
      if (lane == 0) mbar_arrive(&empty[prev]);
    }
    prev = ring.stage;
    if constexpr (kFold) {
      if (--left == 0) {  // the chunk's products are all issued: fold them in
        wgmma_wait<0>();
        fence_acc(acc);
        epi.fold(total, acc, chunk, fr, fc, M);
#pragma unroll
        for (int e = 0; e < 64; ++e) acc[e] = 0;
        ++chunk;
        left = kslices / epi.n_chunks;
      }
    }
  }
  wgmma_wait<0>();
  fence_acc(acc);

  // The m64n128 accumulator holds acc[4j + {0, 1}] at row g, columns
  // 8j + 2 t4 + {0, 1} of the warp's 16 rows, acc[4j + {2, 3}] at row g + 8.
  const int g = lane >> 2, t4 = lane & 3, wr = 16 * (warp & 3) + g;
  if constexpr (kFold) {
    epi.store(total, fr, fc, M);
  } else if constexpr (StagedEpilogue<Epi>::value || ColumnCached<Epi>::value) {
    // Through shared memory (the ring, idle once both warpgroups' products
    // are done), so that a warp calls epi on 32 consecutive columns of one
    // row and its loads of the column vectors and its stores coalesce.
    named_barrier_sync(1, 32 * kSConsumerWarps);  // no warpgroup reads the ring any more
    Acc* tile = reinterpret_cast<Acc*>(sm) + wg * 64 * kSTileLd;
#pragma unroll
    for (int j = 0; j < 16; ++j) {
      Acc* p0 = tile + wr * kSTileLd + 8 * j + 2 * t4;
      Acc* p1 = p0 + 8 * kSTileLd;
      p0[0] = acc[4 * j];
      p0[1] = acc[4 * j + 1];
      p1[0] = acc[4 * j + 2];
      p1[1] = acc[4 * j + 3];
    }
    named_barrier_sync(2 + wg, 128);  // the warpgroup's 64 rows are staged
    const int t = tid & 127, r0 = m0 + 64 * wg, rows = min(64, M - r0);
    if constexpr (ColumnCached<Epi>::value) {
      if (epi.column_fits()) {
        const auto c = epi.column(n0 + t);
        if (rows == 64) {
#pragma unroll 4
          for (int i = 0; i < 64; ++i) epi.at(r0 + i, n0 + t, tile[i * kSTileLd + t], c);
        } else {
          for (int i = 0; i < rows; ++i) epi.at(r0 + i, n0 + t, tile[i * kSTileLd + t], c);
        }
        return;
      }
    }
    if (rows == 64) {
#pragma unroll 8
      for (int i = 0; i < 64; ++i) epi(r0 + i, n0 + t, tile[i * kSTileLd + t]);
    } else {
      for (int i = 0; i < rows; ++i) epi(r0 + i, n0 + t, tile[i * kSTileLd + t]);
    }
  } else {  // on the fragments in registers
    const int r0 = m0 + 64 * wg + wr, r1 = r0 + 8;
#pragma unroll
    for (int j = 0; j < 16; ++j) {
      const int col = n0 + 8 * j + 2 * t4;
      if (r0 < M) {
        epi(r0, col, acc[4 * j]);
        epi(r0, col + 1, acc[4 * j + 1]);
      }
      if (r1 < M) {
        epi(r1, col, acc[4 * j + 2]);
        epi(r1, col + 1, acc[4 * j + 3]);
      }
    }
  }
}

// The stage on the caller's stream: int8 A (M, K) with B = w^T (N, K), or
// bf16 A (M, K) with B = w (K, N) (kKMajorB: B = w (N, K), the product a .
// w^T). Needs N % 128 == 0 and K a multiple of the 128-B slice (128 int8, 64
// bf16), for the folds each chunk's K / C too; rows and weights 16-B
// aligned.
template <typename T, typename Epi, bool kKMajorB = false>
cudaError_t launch_wgmma_stage(const T* A, const T* B, int M, int N, int K, Epi epi,
                               cudaStream_t st) {
  constexpr bool kInt8 = std::is_same<T, int8_t>::value;
  if (M <= 0 || N <= 0 || N % kSBN || K <= 0 || K % (kInt8 ? 128 : 64))
    return cudaErrorInvalidValue;
  if constexpr (ChunkFold<Epi>::value) {
    if (epi.n_chunks < 1 || K % (128 * epi.n_chunks)) return cudaErrorInvalidValue;
  }
  const unsigned grid_y = static_cast<unsigned>((M + kSBM - 1) / kSBM);
  if (grid_y > 65535u) return cudaErrorInvalidValue;
  CUtensorMap tma, tmb;
  if constexpr (kInt8) {
    AIIC_CHECK(tensor_map_2d(&tma, A, CU_TENSOR_MAP_DATA_TYPE_UINT8, K, M, K, 128, kSBM));
    AIIC_CHECK(tensor_map_2d(&tmb, B, CU_TENSOR_MAP_DATA_TYPE_UINT8, K, N, K, 128, kSBN));
  } else {
    AIIC_CHECK(tensor_map_2d(&tma, A, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, K, M, 2ull * K, 64, kSBM));
    if constexpr (kKMajorB)  // (N, K) as A is (M, K): boxes of 128 rows x 64 K elements
      AIIC_CHECK(
          tensor_map_2d(&tmb, B, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, K, N, 2ull * K, 64, kSBN));
    else
      AIIC_CHECK(
          tensor_map_2d(&tmb, B, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, N, K, 2ull * N, 64, 64));
  }
  AIIC_CHECK(cudaFuncSetAttribute(wgmma_stage_kernel<T, Epi, kKMajorB>,
                                  cudaFuncAttributeMaxDynamicSharedMemorySize, kSSmem));
  wgmma_stage_kernel<T, Epi, kKMajorB>
      <<<dim3(N / kSBN, grid_y), kSThreads, kSSmem, st>>>(tma, tmb, M, K, epi);
  return cudaGetLastError();
}

// Blocks resident on one SM of each stage kernel of `kernels` (n of them),
// into blocks[0..n).
inline cudaError_t stage_kernel_occupancy(const void* const* kernels, int n, int* blocks) {
  for (int i = 0; i < n; ++i) {
    AIIC_CHECK(cudaFuncSetAttribute(kernels[i], cudaFuncAttributeMaxDynamicSharedMemorySize,
                                    kSSmem));
    AIIC_CHECK(cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks + i, kernels[i], kSThreads,
                                                             kSSmem));
  }
  return cudaSuccess;
}

// Blocks resident on one SM of the stage kernels, into blocks[0..4]: int8
// (EpiGelu, c_fc's), bf16 (EpiOutProj), folded (EpiChunkResidual, row 3's
// c_proj), and rows 5 and 10's staged bf16 products (EpiBiasQKV,
// EpiBiasGelu).
inline cudaError_t wgmma_stage_occupancy(int* blocks) {
  const void* kernels[] = {
      reinterpret_cast<const void*>(wgmma_stage_kernel<int8_t, EpiGelu<Gelu::kExp2>>),
      reinterpret_cast<const void*>(wgmma_stage_kernel<bf16, EpiOutProj>),
      reinterpret_cast<const void*>(wgmma_stage_kernel<int8_t, EpiChunkResidual>),
      reinterpret_cast<const void*>(wgmma_stage_kernel<bf16, EpiBiasQKV>),
      reinterpret_cast<const void*>(wgmma_stage_kernel<bf16, EpiBiasGelu>)};
  return stage_kernel_occupancy(kernels, 5, blocks);
}

// ---------------------------------------------------------------------------
// Rows 1-3 on the stage (row 4 runs row 1, then row 2 or 3). wqkv_t, w1_t,
// w2_t: the K-major int8 copies (w^T) of the Int8Attn / Int8Mlp weights.
// ---------------------------------------------------------------------------

inline cudaError_t int8_qkv_stage_wgmma(const bf16* x, const Int8Attn& a, const int8_t* wqkv_t,
                                        bf16* qkv, int8_t* hq, float* hs, int rows, int W,
                                        float eps, cudaStream_t st) {
  if (W % kSBN != 0) return cudaErrorInvalidValue;
  AIIC_CHECK((launch_rowquant<true, bf16>(x, a.ln_s, a.ln_b, hq, hs, rows, W, eps, st)));
  return launch_wgmma_stage(static_cast<const int8_t*>(hq), wqkv_t, rows, 3 * W, W,
                            EpiQKV{hs, a.sqkv, a.bqkv, qkv, 3 * W}, st);
}

inline cudaError_t int8_attn_half_wgmma(const bf16* x, const Int8Attn& a, const int8_t* wqkv_t,
                                        bf16* out, int8_t* hq, float* hs, bf16* qkv, bf16* attn,
                                        int B, int S, int W, int H, float eps, float qconst,
                                        cudaStream_t st) {
  if (W % kSBN != 0 || W % H != 0 || W / H != kHeadDim) return cudaErrorInvalidValue;
  const int rows = B * S;
  AIIC_CHECK(int8_qkv_stage_wgmma(x, a, wqkv_t, qkv, hq, hs, rows, W, eps, st));
  const bf16* q = qkv;
  AIIC_CHECK(launch_attn_core_mma<QKVLayout::kPacked>(q, q, q, a.mask, attn, B, S, W, H, qconst,
                                                      st));
  return launch_wgmma_stage(static_cast<const bf16*>(attn), a.wo, rows, W, W,
                            EpiOutProj{a.bo, x, out, W}, st);
}

// Row 2 (C = 1) or row 3 (the hidden axis in C chunks: y quantized as the
// (rows*C, M/C) matrix it is in memory, so each (row, chunk) gets its own
// scale, and c_proj folding the chunks in order). Needs W % 128 == 0 and
// M / C a multiple of 128 (a whole number of c_proj's 128-B K-slices); the
// scratch's part is not read.
inline cudaError_t int8_mlp_half_wgmma(const bf16* x, const Int8Mlp& m, const int8_t* w1_t,
                                       const int8_t* w2_t, bf16* out, const MlpScratch& s,
                                       int rows, int W, int M, int C, float eps, cudaStream_t st) {
  if (W % kSBN != 0 || C < 1 || M % (C * 128) != 0) return cudaErrorInvalidValue;
  AIIC_CHECK((launch_rowquant<true, bf16>(x, m.ln_s, m.ln_b, s.hq, s.hs, rows, W, eps, st)));
  AIIC_CHECK(launch_wgmma_stage(static_cast<const int8_t*>(s.hq), w1_t, rows, M, W,
                                EpiGelu<Gelu::kExp2>{s.hs, m.s1, m.b1, s.y, M}, st));
  AIIC_CHECK((launch_rowquant<false, float>(static_cast<const float*>(s.y), nullptr, nullptr,
                                            s.yq, s.ys, rows * C, M / C, 0.f, st)));
  const int8_t* yq = s.yq;
  if (C == 1)
    return launch_wgmma_stage(yq, w2_t, rows, W, M, EpiResidual{s.ys, m.s2, m.b2, x, out, W}, st);
  return launch_wgmma_stage(yq, w2_t, rows, W, M,
                            EpiChunkResidual{s.ys, m.s2, m.b2, x, out, W, C}, st);
}

}  // namespace
}  // namespace aiic
