// Tensor-core rate probe on Hopper's own GEMM machinery: TMA loads into
// 128-B swizzled shared memory on an mbarrier ring, one producer warp, two
// consumer warpgroups running wgmma (wgmma_gemm.cuh). The three bodies of
// the TPU probe tools/mxu_probe.py (`build` :77, pallas_call :78; row 17),
// at its geometry: x of STEPS*R = 8192 rows by W=768 against w (768, 3072),
// INNER=64 products with an i-dependent operand:
//
//   bf16:     out = bf16(sum_i fp32(bf16(x + i) . w))
//   i8:       out = int32(sum_i (x ^ i) . w), exact
//   i8_quant: xf = f32(x) + i; s_i = max(amax|xf|, 1e-6) / 127 per row;
//             q = clip(rint(xf / s_i), +-127);
//             out = bf16(sum_i f32(q . w) * s_i)
//
// The plain PyTorch versions are aiic_tpu_torch/probes/mxu_probe.py::
// mxu_*_ref; the WMMA form (mxu_probe.cu, the serving GEMMs' tile) stays
// beside this one.
//
// What bounds it on the H100: 2*rows*W*M*INNER = 2.47 T operations: 2.50 ms
// at the 989 TFLOP/s of bf16, 1.25 ms at the 1,979 TOP/s of int8 (dense
// peaks, 700 W). The bytes (x, w, out) are 0.02-0.03 ms.
//
// The design:
// - bf16 and i8: each block owns a 128x256 output tile and keeps ONE
//   accumulator (fp32 or s32, 128 registers a consumer thread) across all of
//   i and K, as the TPU kernel keeps its x block and all of w in VMEM for
//   the 64 products of a grid step: each 128-B K-slice of x (128 rows) and
//   of w (256 columns) is loaded once, by TMA, and the consumer warpgroups
//   run the INNER products on it, re-making A in registers for each i
//   (ldmatrix once, then bf16(x + i) or x ^ i per i, ~5 instructions a
//   register against 4 wgmma of 128 cycles each) and issuing wgmma with A
//   from registers, two register sets in turn so that one i's products
//   overlap the next i's A. bf16 reads w (W, M) as it lies, an MN-major B
//   (four 64-column atoms a K-slice); 8-bit wgmma takes K-major operands
//   only, so i8 reads w^T (M, W), which the wrapper makes. The fp32 sum
//   runs over k-slices then i (the plain version sums each product, then
//   adds): the summation order differs, the bf16 bar holds. The s32 sum is
//   exact in any order (|sum| <= 127*128*768*64 < 2^31).
// - i8_quant cannot share one accumulator across i: its scale changes
//   with i. A row pass quantizes each (row, i) once (403 M elements at the
//   probe's geometry, against 4.8 G if each of 12 column blocks re-made
//   them): the row's scale for every i from its max and min alone (fl(x+i)
//   is monotone in x, so amax|x + i| = max(|fl(max+i)|, |fl(min+i)|)),
//   IEEE division and round-half-even as the plain version, into an int8
//   workspace [i][row][k] and an fp32 one [i][row]. Then each block owns a
//   64x256 output tile, keeps w^T's 256 columns (192 KB) resident in shared
//   memory, streams q_i's 64-row K-slices through a 4-stage ring, and for
//   each i runs the K products into an s32 accumulator (both operands from
//   shared memory; each consumer warpgroup 128 columns), then dequantizes
//   once, fp32 += f32(s32) * s_i (a multiply, then an add: -fmad=false), in
//   the plain version's order: the result is the plain version's bit for
//   bit. The workspace costs 403 MB written and read once from device
//   memory (0.24 ms at 3.35 TB/s); each block re-reads q from L2 (12 column
//   blocks share a row's).
//
// What each body gives up: bf16 and i8 end one K-slice by waiting for every
// product on it (one drain per 64 i), and their output tiles (768 blocks)
// fill 5.8 waves of 132 SMs; i8_quant pays the row pass, the q traffic and
// one block per SM (its shared memory).

#include "wgmma_gemm.cuh"

namespace aiic {
namespace {

constexpr int kPBM = 128, kPBN = 256;         // bf16 / i8 block tile
constexpr int kPConsumerWarps = 8;            // two consumer warpgroups
constexpr int kPThreads = 32 * kPConsumerWarps + 32;  // and one producer warp
constexpr int kPStages = 2;
constexpr int kPXBytes = kPBM * 128;          // a 128-B K-slice of x
constexpr int kPWBytes = kPBN * 128;          // a 128-B K-slice of w (bf16: 64 K rows x 256)
constexpr int kPStageBytes = kPXBytes + kPWBytes;
constexpr int kPSmem = 1024 + kPStages * kPStageBytes + 2 * kPStages * 8;

constexpr int kQBM = 64, kQBN = 256, kQStages = 4;  // i8_quant block tile and ring
constexpr int kQMaxW = 768;                         // w^T's K-slices resident: 256 * W bytes
constexpr int kQABytes = kQBM * 128;
constexpr int kQSmem = 1024 + kQBN * kQMaxW + kQStages * kQABytes + (1 + 2 * kQStages) * 8;

constexpr int kQRowWarps = 8;  // row pass: one warp a row
constexpr int kQRowChunks = kQMaxW / 8 / 32;  // 8-element chunks a lane holds

// bf16 (kInt8 false): x (rows, W) bf16, w (W, M) bf16, out (rows, M) bf16.
// i8: x (rows, W) int8, w^T (M, W) int8, out (rows, M) int32.
// Grid (M / 256, rows / 128).
template <bool kInt8>
__global__ void __launch_bounds__(kPThreads, 1)
mxu_wgmma_kernel(__grid_constant__ const CUtensorMap tmx, __grid_constant__ const CUtensorMap tmw,
                 void* __restrict__ outv, int W, int M, int inner) {
  extern __shared__ unsigned char smem_raw[];
  unsigned char* sm = align1024(smem_raw);
  uint64_t* full = reinterpret_cast<uint64_t*>(sm + kPStages * kPStageBytes);
  uint64_t* empty = full + kPStages;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int m0 = blockIdx.y * kPBM, n0 = blockIdx.x * kPBN;
  const int kslices = W / (kInt8 ? 128 : 64);
  if (tid == 0) {
    for (int s = 0; s < kPStages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], kPConsumerWarps);
    }
    fence_barrier_init();
  }
  __syncthreads();

  if (warp == kPConsumerWarps) {  // producer
    if (lane == 0) {
      Ring<kPStages> ring;
      for (int kt = 0; kt < kslices; ++kt, ring.advance()) {
        mbar_wait(&empty[ring.stage], ring.phase ^ 1u);
        unsigned char* xs = sm + ring.stage * kPStageBytes;
        unsigned char* ws = xs + kPXBytes;
        mbar_expect_tx(&full[ring.stage], kPStageBytes);
        if (kInt8) {
          tma_load_2d(xs, &tmx, &full[ring.stage], kt * 128, m0);
          tma_load_2d(ws, &tmw, &full[ring.stage], kt * 128, n0);
        } else {
          tma_load_2d(xs, &tmx, &full[ring.stage], kt * 64, m0);
#pragma unroll
          for (int a = 0; a < 4; ++a)  // four 64-column atoms of 64 K rows
            tma_load_2d(ws + a * 8192, &tmw, &full[ring.stage], n0 + 64 * a, kt * 64);
        }
      }
    }
    return;
  }

  using Acc = typename std::conditional<kInt8, int, float>::type;
  const int wrow = 64 * (warp >> 2) + 16 * (warp & 3);  // the warp's 16 rows of the tile
  Acc acc[128];
#pragma unroll
  for (int e = 0; e < 128; ++e) acc[e] = 0;
  Ring<kPStages> ring;
  for (int kt = 0; kt < kslices; ++kt, ring.advance()) {
    mbar_wait(&full[ring.stage], ring.phase);
    const unsigned char* xs = sm + ring.stage * kPStageBytes;
    const uint32_t ws = smem_addr(xs + kPXBytes);
    uint32_t xa[4][4], a0[4][4], a1[4][4];
    // 128-B rows of 16-B chunks: the bf16 tile's layout in either type.
    load_a_frags(xa, reinterpret_cast<const bf16*>(xs), wrow, lane);
    // A for product i from the x fragments: bf16(x + i) or x ^ i.
    const auto make_a = [&](uint32_t (&a)[4][4], int i) {
      const float fi = static_cast<float>(i);
      const uint32_t pat = (static_cast<uint32_t>(i) & 0xffu) * 0x01010101u;
#pragma unroll
      for (int k = 0; k < 4; ++k)
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          if (kInt8) {
            a[k][r] = xa[k][r] ^ pat;
          } else {
            const float2 v = unpack_bf16(xa[k][r]);
            a[k][r] = pack_bf16(v.x + fi, v.y + fi);
          }
        }
    };
    // The four 32-B K steps of the slice against w's.
    const auto products = [&](const uint32_t (&a)[4][4]) {
      wgmma_fence();
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        if constexpr (kInt8)
          wgmma_s8_m64n256k32_rs(acc, a[k], sw128_desc(ws) + 2 * k, 1);
        else  // MN-major w: a 16-deep step is 16 K rows, 2048 B
          wgmma_bf16_m64n256k16_rs<1>(acc, a[k], sw128_desc_mn(ws + 2048 * k, 8192), 1);
      }
      wgmma_commit();
    };
    for (int i = 0; i < inner; i += 2) {
      make_a(a0, i);
      products(a0);
      wgmma_wait<1>();  // i - 1's products, which read a1, are done
      if (i + 1 < inner) {
        make_a(a1, i + 1);
        products(a1);
        wgmma_wait<1>();  // i's, which read a0, are done
      }
    }
    wgmma_wait<0>();
    __syncwarp();
    if (lane == 0) mbar_arrive(&empty[ring.stage]);
  }
  fence_acc(acc);

  const int g = lane >> 2, t4 = lane & 3;
  const size_t r0 = static_cast<size_t>(m0 + wrow + g) * M, r1 = r0 + 8 * static_cast<size_t>(M);
#pragma unroll
  for (int j = 0; j < 32; ++j) {
    const int col = n0 + 8 * j + 2 * t4;
    if constexpr (kInt8) {
      int* out = static_cast<int*>(outv);
      *reinterpret_cast<int2*>(out + r0 + col) = make_int2(acc[4 * j], acc[4 * j + 1]);
      *reinterpret_cast<int2*>(out + r1 + col) = make_int2(acc[4 * j + 2], acc[4 * j + 3]);
    } else {
      bf16* out = static_cast<bf16*>(outv);
      *reinterpret_cast<__nv_bfloat162*>(out + r0 + col) =
          __floats2bfloat162_rn(acc[4 * j], acc[4 * j + 1]);
      *reinterpret_cast<__nv_bfloat162*>(out + r1 + col) =
          __floats2bfloat162_rn(acc[4 * j + 2], acc[4 * j + 3]);
    }
  }
}

// The i8_quant row pass, one warp a row (W <= 768, W % 8 == 0): the row's
// max and min, then for each i its scale into scales[i*rows + row] and its
// int8 row into xq[(i*rows + row)*W ...].
__global__ void __launch_bounds__(32 * kQRowWarps)
mxu_quant_rows_kernel(const bf16* __restrict__ x, int8_t* __restrict__ xq,
                      float* __restrict__ scales, int rows, int W, int inner) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int row = blockIdx.x * kQRowWarps + warp;
  if (row >= rows) return;
  const int nch = W / 8;
  float v[kQRowChunks][8];
  float mx = -INFINITY, mn = INFINITY;
#pragma unroll
  for (int j = 0; j < kQRowChunks; ++j) {
    const int c = lane + 32 * j;
    if (c >= nch) continue;
    const uint4 u = *reinterpret_cast<const uint4*>(x + static_cast<size_t>(row) * W + 8 * c);
    const uint32_t w4[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float2 f = unpack_bf16(w4[e]);
      v[j][2 * e] = f.x;
      v[j][2 * e + 1] = f.y;
      mx = fmaxf(mx, fmaxf(f.x, f.y));
      mn = fminf(mn, fminf(f.x, f.y));
    }
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
    mn = fminf(mn, __shfl_xor_sync(0xffffffffu, mn, o));
  }
  for (int i = 0; i < inner; ++i) {
    const float fi = static_cast<float>(i);
    const float amax = fmaxf(fabsf(mx + fi), fabsf(mn + fi));
    const float scale = fmaxf(amax, 1e-6f) / 127.0f;
    const size_t at = static_cast<size_t>(i) * rows + row;
    if (lane == 0) scales[at] = scale;
    int8_t* dst = xq + at * W;
#pragma unroll
    for (int j = 0; j < kQRowChunks; ++j) {
      const int c = lane + 32 * j;
      if (c >= nch) continue;
      uint32_t packed[2] = {0u, 0u};
#pragma unroll
      for (int e = 0; e < 8; ++e) {
        const float q = fminf(fmaxf(rintf((v[j][e] + fi) / scale), -127.f), 127.f);
        packed[e >> 2] |= (static_cast<uint32_t>(static_cast<int>(q)) & 0xffu) << (8 * (e & 3));
      }
      *reinterpret_cast<uint2*>(dst + 8 * c) = make_uint2(packed[0], packed[1]);
    }
  }
}

// i8_quant's products: q (inner*rows, W) int8 with scales (inner*rows) fp32
// from the row pass, w^T (M, W) int8, out (rows, M) bf16. Grid (M / 256,
// rows / 64); consumer warpgroup c takes columns 128c .. 128c + 127.
__global__ void __launch_bounds__(kPThreads, 1)
mxu_wgmma_quant_kernel(__grid_constant__ const CUtensorMap tmq,
                       __grid_constant__ const CUtensorMap tmw, const float* __restrict__ scales,
                       bf16* __restrict__ out, int rows, int W, int M, int inner) {
  extern __shared__ unsigned char smem_raw[];
  unsigned char* sm = align1024(smem_raw);
  unsigned char* wsm = sm;                   // w^T: K-slice kt at kt * 32 KB (256 rows x 128 B)
  unsigned char* asm_ = sm + kQBN * kQMaxW;  // the ring of q K-slices, 8 KB each
  uint64_t* wfull = reinterpret_cast<uint64_t*>(asm_ + kQStages * kQABytes);
  uint64_t* full = wfull + 1;
  uint64_t* empty = full + kQStages;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int m0 = blockIdx.y * kQBM, n0 = blockIdx.x * kQBN;
  const int kslices = W / 128;
  if (tid == 0) {
    mbar_init(wfull, 1);
    for (int s = 0; s < kQStages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], kPConsumerWarps);
    }
    fence_barrier_init();
  }
  __syncthreads();

  if (warp == kPConsumerWarps) {  // producer
    if (lane == 0) {
      mbar_expect_tx(wfull, kQBN * W);
      for (int kt = 0; kt < kslices; ++kt) tma_load_2d(wsm + kt * kPWBytes, &tmw, wfull, kt * 128, n0);
      Ring<kQStages> ring;
      for (int i = 0; i < inner; ++i)
        for (int kt = 0; kt < kslices; ++kt, ring.advance()) {
          mbar_wait(&empty[ring.stage], ring.phase ^ 1u);
          mbar_expect_tx(&full[ring.stage], kQABytes);
          tma_load_2d(asm_ + ring.stage * kQABytes, &tmq, &full[ring.stage], kt * 128,
                      i * rows + m0);
        }
    }
    return;
  }

  const int c = warp >> 2, wrow = 16 * (warp & 3);
  const int g = lane >> 2, t4 = lane & 3;
  float facc[64];
  int sacc[64];
#pragma unroll
  for (int e = 0; e < 64; ++e) {
    facc[e] = 0.f;
    sacc[e] = 0;
  }
  mbar_wait(wfull, 0);
  const uint32_t wbase = smem_addr(wsm) + c * (kQBN / 2) * 128;
  Ring<kQStages> ring;
  for (int i = 0; i < inner; ++i) {
    int prev = -1;
    for (int kt = 0; kt < kslices; ++kt, ring.advance()) {
      mbar_wait(&full[ring.stage], ring.phase);
      const uint64_t da = sw128_desc(smem_addr(asm_ + ring.stage * kQABytes));
      const uint64_t db = sw128_desc(wbase + kt * kPWBytes);
      wgmma_fence();
#pragma unroll
      for (int k = 0; k < 4; ++k) wgmma_s8_m64n128k32_ss(sacc, da + 2 * k, db + 2 * k, kt | k);
      wgmma_commit();
      if (prev >= 0) {  // the previous slice's products are done: release it
        wgmma_wait<1>();
        __syncwarp();
        if (lane == 0) mbar_arrive(&empty[prev]);
      }
      prev = ring.stage;
    }
    wgmma_wait<0>();
    __syncwarp();
    if (lane == 0) mbar_arrive(&empty[prev]);
    fence_acc(sacc);
    const size_t at = static_cast<size_t>(i) * rows + m0 + wrow + g;
    const float s0 = scales[at], s1 = scales[at + 8];
#pragma unroll
    for (int j = 0; j < 16; ++j) {
      facc[4 * j] = facc[4 * j] + static_cast<float>(sacc[4 * j]) * s0;
      facc[4 * j + 1] = facc[4 * j + 1] + static_cast<float>(sacc[4 * j + 1]) * s0;
      facc[4 * j + 2] = facc[4 * j + 2] + static_cast<float>(sacc[4 * j + 2]) * s1;
      facc[4 * j + 3] = facc[4 * j + 3] + static_cast<float>(sacc[4 * j + 3]) * s1;
    }
  }

  const size_t r0 = static_cast<size_t>(m0 + wrow + g) * M, r1 = r0 + 8 * static_cast<size_t>(M);
#pragma unroll
  for (int j = 0; j < 16; ++j) {
    const int col = n0 + (kQBN / 2) * c + 8 * j + 2 * t4;
    *reinterpret_cast<__nv_bfloat162*>(out + r0 + col) =
        __floats2bfloat162_rn(facc[4 * j], facc[4 * j + 1]);
    *reinterpret_cast<__nv_bfloat162*>(out + r1 + col) =
        __floats2bfloat162_rn(facc[4 * j + 2], facc[4 * j + 3]);
  }
}

template <bool kInt8>
cudaError_t launch_wgmma_probe(const void* x, const void* w, void* out, int rows, int W, int M,
                               int inner, cudaStream_t st) {
  CUtensorMap tmx, tmw;
  if (kInt8) {
    AIIC_CHECK(tensor_map_2d(&tmx, x, CU_TENSOR_MAP_DATA_TYPE_UINT8, W, rows, W, 128, kPBM));
    AIIC_CHECK(tensor_map_2d(&tmw, w, CU_TENSOR_MAP_DATA_TYPE_UINT8, W, M, W, 128, kPBN));
  } else {
    AIIC_CHECK(tensor_map_2d(&tmx, x, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, W, rows, 2 * W, 64, kPBM));
    AIIC_CHECK(tensor_map_2d(&tmw, w, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, M, W, 2 * M, 64, 64));
  }
  AIIC_CHECK(cudaFuncSetAttribute(mxu_wgmma_kernel<kInt8>,
                                  cudaFuncAttributeMaxDynamicSharedMemorySize, kPSmem));
  mxu_wgmma_kernel<kInt8><<<dim3(M / kPBN, rows / kPBM), kPThreads, kPSmem, st>>>(tmx, tmw, out, W,
                                                                                M, inner);
  return cudaGetLastError();
}

cudaError_t launch_wgmma_quant(const void* x, const void* wt, void* out, void* xq, void* scales,
                               int rows, int W, int M, int inner, cudaStream_t st) {
  mxu_quant_rows_kernel<<<(rows + kQRowWarps - 1) / kQRowWarps, 32 * kQRowWarps, 0, st>>>(
      static_cast<const bf16*>(x), static_cast<int8_t*>(xq), static_cast<float*>(scales), rows, W,
      inner);
  AIIC_CHECK(cudaGetLastError());
  CUtensorMap tmq, tmw;
  AIIC_CHECK(tensor_map_2d(&tmq, xq, CU_TENSOR_MAP_DATA_TYPE_UINT8, W,
                           static_cast<uint64_t>(inner) * rows, W, 128, kQBM));
  AIIC_CHECK(tensor_map_2d(&tmw, wt, CU_TENSOR_MAP_DATA_TYPE_UINT8, W, M, W, 128, kQBN));
  AIIC_CHECK(cudaFuncSetAttribute(mxu_wgmma_quant_kernel,
                                  cudaFuncAttributeMaxDynamicSharedMemorySize, kQSmem));
  mxu_wgmma_quant_kernel<<<dim3(M / kQBN, rows / kQBM), kPThreads, kQSmem, st>>>(
      tmq, tmw, static_cast<const float*>(scales), static_cast<bf16*>(out), rows, W, M, inner);
  return cudaGetLastError();
}

}  // namespace
}  // namespace aiic

// body 0: bf16 x (rows, W), bf16 w (W, M) -> bf16 out; 1: int8 x, int8 w^T
// (M, W) -> int32 out; 2: bf16 x, int8 w^T (M, W) -> bf16 out, with xq
// (inner*rows*W int8) and scales (inner*rows fp32) as workspace. Needs
// M % 256 == 0, inner >= 1, and rows % 128 == 0 with W % 64 == 0 (body 0)
// or W % 128 == 0 (body 1), or rows % 64 == 0 with W % 128 == 0 and
// W <= 768 (body 2); pointers 16-byte aligned. Returns a cudaError_t.
extern "C" int aiic_mxu_probe_wgmma(const void* x, const void* w, void* out, void* xq,
                                    void* scales, int rows, int W, int M, int inner, int body,
                                    void* stream) {
  using namespace aiic;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (rows <= 0 || W <= 0 || M <= 0 || M % kPBN || inner < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  switch (body) {
    case 0:
      if (rows % kPBM || W % 64) return static_cast<int>(cudaErrorInvalidValue);
      return static_cast<int>(launch_wgmma_probe<false>(x, w, out, rows, W, M, inner, st));
    case 1:
      if (rows % kPBM || W % 128) return static_cast<int>(cudaErrorInvalidValue);
      return static_cast<int>(launch_wgmma_probe<true>(x, w, out, rows, W, M, inner, st));
    case 2:
      if (rows % kQBM || W % 128 || W > kQMaxW || !xq || !scales)
        return static_cast<int>(cudaErrorInvalidValue);
      return static_cast<int>(launch_wgmma_quant(x, w, out, xq, scales, rows, W, M, inner, st));
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

// Blocks resident on one SM of the bf16, i8 and i8_quant product kernels
// into blocks[0..2]. Returns a cudaError_t.
extern "C" int aiic_mxu_probe_wgmma_occupancy(int* blocks) {
  using namespace aiic;
  AIIC_CHECK(cudaFuncSetAttribute(mxu_wgmma_kernel<false>,
                                  cudaFuncAttributeMaxDynamicSharedMemorySize, kPSmem));
  AIIC_CHECK(cudaFuncSetAttribute(mxu_wgmma_kernel<true>,
                                  cudaFuncAttributeMaxDynamicSharedMemorySize, kPSmem));
  AIIC_CHECK(cudaFuncSetAttribute(mxu_wgmma_quant_kernel,
                                  cudaFuncAttributeMaxDynamicSharedMemorySize, kQSmem));
  AIIC_CHECK(cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks, mxu_wgmma_kernel<false>,
                                                           kPThreads, kPSmem));
  AIIC_CHECK(cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks + 1, mxu_wgmma_kernel<true>,
                                                           kPThreads, kPSmem));
  return static_cast<int>(cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      blocks + 2, mxu_wgmma_quant_kernel, kPThreads, kQSmem));
}
