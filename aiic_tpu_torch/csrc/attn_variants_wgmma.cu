// Form 0 of the attention-half variants (rows 15a, 16a, 16c, 16d and 16e of
// the TPU kernel table: int8_attn_nomax of tools/kernel_experiments.py,
// attn_var of kernel_experiments2.py, 4.py, 5.py and 7.py), the route of
// aiic_attn_variant (attn_variants.cu): row 1's current design with the
// variant's pieces. Plain PyTorch versions: aiic_tpu_torch/probes/variants.py.
//
//   (a) row pass: LN1 (or none: noln) and the per-row int8 quantizer, v4's
//       two passes per image pair, or the constant 3 (maconly), as form 1;
//   (b) the int8 QKV product on the wgmma + TMA GEMM stage of
//       wgmma_serving_gemm.cuh, B = wqkv^T (K-major, made once per weight),
//       with the variant's epilogue (EpiQKV; v4's EpiQKVTile; maconly's
//       EpiClip8);
//   (c) var_core_mma_kernel below, the tensor-core variant core (none:
//       nocore, maconly);
//   (d) the out-projection on the stage: int8 (the attention rows quantized
//       per row, then acc*ascale*so + bo + x against wo_q^T), bf16 (EpiOutProj,
//       wo as it lies) or maconly's exact bf16(x + f32(acc)).
//
// The variant core is built from the pieces of row 1's core
// (attn_core_mma.cuh, on mma_tiles.cuh): a block is one warpgroup and 64
// query rows of one (image, head); K and V stream in 64-key tiles through a
// 2-stage cp.async ring of 128-B swizzled tiles, keys past S zero-filled by
// cp.async's src-size-0 form and given p = 0 explicitly; query rows past S
// are never stored. Its flags (variants.cuh CoreFlags) and schedule are
// compile-time parameters, so that row 1's production core does not branch
// on a probe's flag:
// - exp2 and the fold after p.V (v3, noln, qobf16, the 16d schedules): row
//   1's arithmetic without its 1e-38 guard, so where a row's sum passes
//   1e-38 the bf16-output instantiations give row 1's form 0 bits;
// - natural exp (nomax, v1, v4): q as it is (not q'), s = (q.k) * scale
//   after the dot, then expf (no fast math), clamped at 70, 80 or not;
// - the divide before p.V (nomax, v2, v4): the keys are walked twice, the
//   first pass summing p (the same p, recomputed in the same order, in the
//   second), the second rounding bf16(p / l) into p.V's A fragments. A
//   two-pass core loads q's A fragments afresh at each step: held in
//   registers across both passes' wgmma waits (row 1 holds them across its
//   one pass) they gave wrong scores in the second pass on the card;
// - nosm: p = bf16(s), no denominator;
// - the int8 cores (coreqk, corepv, coreboth) start with a pre-pass, one
//   block per (head, image) (kv8_prepass_kernel), that quantizes K and V
//   once, where each of the head's query-tile blocks would repeat it:
//   each key row along D as _row_quant (scale max(amax, 1e-6)/127, a true
//   division rounded half to even, clip at 127), and V per channel over the
//   head's S keys (vs = max|v|/127 + 1e-12, round(v / vs), no clip),
//   transposed to [d][key], since 8-bit wgmma takes a K-major B only and
//   p.V's K axis is the keys. The core streams those int8 tiles through its
//   ring (the same swizzled layout, 64 B of each 128-B row);
// - int8 Q.K^T (coreqk, coreboth): the block's query rows quantized as the
//   key rows, s8 wgmma m64n64k32 with both operands by descriptor (K as
//   stored is K-major), s = acc * (qs * fp32(scale log2 e)) * ks;
// - int8 p.V (corepv, coreboth): two passes over the keys, the first
//   summing p and taking its amax, the second quantizing p per query row
//   (ps = max(amax, 1e-6)/127) into an int8 tile, then s8 wgmma against
//   V^T; o = acc * ps * vs * (1 / l). The int8 products are exact
//   integer sums, as the plain version's;
// - the schedules of kernel_experiments5.py are block-to-work mappings of
//   the same units (image, head, 64-row query tile), each run with row 1's
//   tile order and warp-row mapping: gbatch one block per (head, image
//   pair), hstack one block walking all heads of one image, hg one block all
//   heads of an image pair. At B=256 hstack and hg launch 256 and 128 blocks
//   of one warpgroup for 132 SMs: they price fewer, longer blocks.
//
// What bounds it on the H100 at B=256 (50,432 rows, W=768): the int8 QKV
// product (0.060 ms of int8 operations), the out-projection (0.030 ms int8,
// 0.060 bf16) and the core's two products (0.030 ms of bf16 operations);
// 0.12-0.18 ms in all. Row 1's form 0 runs the same stage and core
// arithmetic in 1.017 ms (chip_smoke.py, NVIDIA H100 80GB HBM3 at 700 W).

#include "attn_core_mma.cuh"
#include "variants.cuh"
#include "wgmma_serving_gemm.cuh"

namespace aiic {
namespace {

// d (64 x 64 s32) = scale_d ? d : 0, += a . b: a 64x32 s8 and b 32x64 s8, both
// K-major by descriptor; d as eight m16n8 C fragments a warp, as the bf16
// m64n64 accumulator.
__device__ __forceinline__ void wgmma_s8_m64n64k32_ss(int (&d)[8][4], uint64_t desc_a,
                                                      uint64_t desc_b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k32.s32.s8.s8 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p;\n}\n"
      : "+r"(d[0][0]), "+r"(d[0][1]), "+r"(d[0][2]), "+r"(d[0][3]),
        "+r"(d[1][0]), "+r"(d[1][1]), "+r"(d[1][2]), "+r"(d[1][3]),
        "+r"(d[2][0]), "+r"(d[2][1]), "+r"(d[2][2]), "+r"(d[2][3]),
        "+r"(d[3][0]), "+r"(d[3][1]), "+r"(d[3][2]), "+r"(d[3][3]),
        "+r"(d[4][0]), "+r"(d[4][1]), "+r"(d[4][2]), "+r"(d[4][3]),
        "+r"(d[5][0]), "+r"(d[5][1]), "+r"(d[5][2]), "+r"(d[5][3]),
        "+r"(d[6][0]), "+r"(d[6][1]), "+r"(d[6][2]), "+r"(d[6][3]),
        "+r"(d[7][0]), "+r"(d[7][1]), "+r"(d[7][2]), "+r"(d[7][3])
      : "l"(desc_a), "l"(desc_b), "r"(scale_d));
}

__device__ __forceinline__ void fence_regs(int (&d)[8][4]) {
#pragma unroll
  for (int n = 0; n < 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) asm volatile("" : "+r"(d[n][e])::"memory");
}

// Byte offset of (row, byte) in a 64 x 64 int8 tile kept in the 128-B
// swizzled layout of the bf16 tiles (64 rows of 128 B, the first 64 B of
// each used): 16-B chunk c of row r at c ^ r % 8, so that the descriptor of
// sw128_desc reads it as a K-major operand, a 32-B K step at desc + 2.
__device__ __forceinline__ int swz8(int row, int byte) {
  return row * 128 + ((((byte >> 4) ^ (row & 7)) << 4) | (byte & 15));
}

// Four bf16 (16 bytes) into v[0..8).
__device__ __forceinline__ void unpack8(uint4 c, float* v) {
  const uint32_t* w = reinterpret_cast<const uint32_t*>(&c);
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const float2 f = unpack_bf16(w[j]);
    v[2 * j] = f.x;
    v[2 * j + 1] = f.y;
  }
}

// _row_quant of the plain version on a row of 64 values held as two halves
// of 32 by a lane and its partner (the next lane): scale = max(amax, 1e-6)
// / 127, q = clip(round(v / scale), +-127), a true division rounded half to
// even; the half's 32 int8 into w, four to a word. Returns the scale.
__device__ __forceinline__ float quant_half_row(const float (&v)[32], uint32_t (&w)[8]) {
  float amax = 0.f;
#pragma unroll
  for (int i = 0; i < 32; ++i) amax = fmaxf(amax, fabsf(v[i]));
  amax = fmaxf(amax, __shfl_xor_sync(0xffffffffu, amax, 1));
  const float scale = fmaxf(amax, 1e-6f) / 127.0f;
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    uint32_t packed = 0;
#pragma unroll
    for (int b = 0; b < 4; ++b) {
      const int q = static_cast<int>(fminf(fmaxf(rintf(v[4 * j + b] / scale), -127.f), 127.f));
      packed |= (static_cast<uint32_t>(q) & 0xffu) << (8 * b);
    }
    w[j] = packed;
  }
  return scale;
}

// The 64 query rows of a bf16 swizzled tile quantized per row into the int8
// tile dst (swz8) and their scales: thread t takes row t / 2, half t % 2.
__device__ __forceinline__ void quant_rows(const bf16* src, unsigned char* dst, float* scales,
                                           int tid) {
  const int r = tid >> 1, half = tid & 1;
  float v[32];
#pragma unroll
  for (int i = 0; i < 4; ++i)
    unpack8(*reinterpret_cast<const uint4*>(src + swz(r, 4 * half + i)), v + 8 * i);
  uint32_t w[8];
  const float scale = quant_half_row(v, w);
#pragma unroll
  for (int c = 0; c < 2; ++c)
    *reinterpret_cast<uint4*>(dst + swz8(r, 32 * half + 16 * c)) =
        make_uint4(w[4 * c], w[4 * c + 1], w[4 * c + 2], w[4 * c + 3]);
  if (half == 0) scales[r] = scale;
}

// The int8 cores' pre-pass, one block of 128 threads per (head, image):
// kK, each key row of the head quantized along D as _row_quant (scale
// max(amax, 1e-6)/127, a true division rounded half to even, clip at 127)
// into k8 with its scale in ks; kV, each channel's scale over the S keys
// (vs = max|v|/127 + 1e-12) into vs, then V quantized per channel (round(v
// / vs), no clip) and transposed into vt, [d][key], the K-major B of p.V.
// The s_pad - S padding keys are zeros.
template <bool kK, bool kV>
__global__ void __launch_bounds__(kMmaThreads) kv8_prepass_kernel(CoreArgs a) {
  __shared__ float red[kMmaThreads];
  __shared__ float vsh[kHeadDim];
  const int tid = threadIdx.x, h = blockIdx.x, img = blockIdx.y, S = a.S;
  const size_t bh = static_cast<size_t>(img) * a.H + h, ld = 3 * static_cast<size_t>(a.W);
  const bf16* kb = a.qkv + static_cast<size_t>(img) * S * ld + a.W + h * kHeadDim;
  const bf16* vb = kb + a.W;
  if constexpr (kK) {
    for (int r = tid >> 1; r < a.s_pad; r += kMmaThreads / 2) {
      const int half = tid & 1;
      float v[32];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        unpack8(r < S ? *reinterpret_cast<const uint4*>(kb + r * ld + 32 * half + 8 * i)
                      : make_uint4(0, 0, 0, 0),
                v + 8 * i);
      uint32_t w[8];
      const float scale = quant_half_row(v, w);
      uint4* dst = reinterpret_cast<uint4*>(a.k8 + (bh * a.s_pad + r) * kHeadDim + 32 * half);
      dst[0] = make_uint4(w[0], w[1], w[2], w[3]);
      dst[1] = make_uint4(w[4], w[5], w[6], w[7]);
      if (half == 0) a.ks[bh * a.s_pad + r] = scale;
    }
  }
  if constexpr (kV) {
    const int d = tid & 63, half = tid >> 6;
    float m = 0.f;
    for (int j = half; j < S; j += 2) m = fmaxf(m, fabsf(__bfloat162float(vb[j * ld + d])));
    red[tid] = m;
    __syncthreads();
    if (tid < kHeadDim) {
      vsh[tid] = fmaxf(red[tid], red[tid + kHeadDim]) / 127.0f + 1e-12f;
      a.vs[bh * kHeadDim + tid] = vsh[tid];
    }
    __syncthreads();
    const float scale = vsh[d];
    for (int k0 = 32 * half; k0 < a.s_pad; k0 += 64) {
      uint32_t w[8];
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        uint32_t packed = 0;
#pragma unroll
        for (int b = 0; b < 4; ++b) {
          const int key = k0 + 4 * j + b;
          const float v = key < S ? __bfloat162float(vb[key * ld + d]) : 0.f;
          packed |= (static_cast<uint32_t>(static_cast<int>(rintf(v / scale))) & 0xffu) << (8 * b);
        }
        w[j] = packed;
      }
      uint4* dst = reinterpret_cast<uint4*>(a.vt + (bh * kHeadDim + d) * a.s_pad + k0);
      dst[0] = make_uint4(w[0], w[1], w[2], w[3]);
      dst[1] = make_uint4(w[4], w[5], w[6], w[7]);
    }
  }
}

// A 64 x 64 int8 tile (rows ld bytes apart) into the swizzled int8 layout
// (swz8) by cp.async, two 16-B chunks a thread.
__device__ __forceinline__ void load_tile8_async(unsigned char* dst, const int8_t* src, size_t ld,
                                                 int tid) {
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int c = tid + i * kMmaThreads, r = c >> 2, ch = c & 3;
    cp_async16(smem_addr(dst + swz8(r, 16 * ch)), src + r * ld + 16 * ch, 16);
  }
}

// A warp's 16 rows of an fp32 accumulator times the row factors inv[0] and
// inv[1], stored fp32 (the int8 out-projection's input) for the rows below
// n_rows: rows g and g + 8, columns 8n + 2 tig + {0, 1}.
__device__ __forceinline__ void store_rows_f32(const float (&d)[8][4], const float* inv,
                                               float* dst, size_t ld, int n_rows, int wrow,
                                               int lane) {
  const int g = lane >> 2, tig = lane & 3, r0 = wrow + g, r1 = r0 + 8;
#pragma unroll
  for (int n = 0; n < 8; ++n) {
    if (r0 < n_rows)
      *reinterpret_cast<float2*>(dst + static_cast<size_t>(r0) * ld + 8 * n + 2 * tig) =
          make_float2(d[n][0] * inv[0], d[n][1] * inv[0]);
    if (r1 < n_rows)
      *reinterpret_cast<float2*>(dst + static_cast<size_t>(r1) * ld + 8 * n + 2 * tig) =
          make_float2(d[n][2] * inv[1], d[n][3] * inv[1]);
  }
}

// The block's shared memory, 1024-B aligned tiles of 8 KB: Q (later the
// output rows) and the K and V ring, bf16 or, for the int8 products, the
// pre-pass's int8 K and V^T tiles (swz8, 64 B of each 128-B row); with int8
// Q.K^T the int8 Q tile, Q's row scales and each K tile's; with int8 p.V the
// int8 P tile.
template <class C>
struct VarSmem {
  static constexpr int kTile = kTileElems * 2;
  static constexpr int kQ8 = 5 * kTile, kP8 = (C::kQK8 ? 6 : 5) * kTile;
  static constexpr int kFloats = kP8 + (C::kPV8 ? kTile : 0);
  static constexpr int kBytes = 1024 + kFloats + 4 * (64 + 2 * 64);

  bf16* q;
  unsigned char *q8, *p8;
  float *qs, *ks;
  // Stage st of the K and V ring (computed, not an array of pointers, which
  // a run-time st would put on the stack).
  __device__ bf16* k(int st) const { return q + (1 + st) * kTileElems; }
  __device__ bf16* v(int st) const { return q + (3 + st) * kTileElems; }
  __device__ unsigned char* k8(int st) const { return reinterpret_cast<unsigned char*>(k(st)); }
  __device__ unsigned char* v8(int st) const { return reinterpret_cast<unsigned char*>(v(st)); }
  __device__ explicit VarSmem(unsigned char* raw) {
    unsigned char* b = align1024(raw);
    q = reinterpret_cast<bf16*>(b);
    q8 = b + kQ8;
    p8 = b + kP8;
    qs = reinterpret_cast<float*>(b + kFloats);
    ks = qs + 64;
  }
};

// One unit: the 64 query rows from q0 of head h of the image at row0.
template <class C, typename TO>
__device__ __forceinline__ void var_core_unit(const CoreArgs& a, const VarSmem<C>& sm,
                                              size_t row0, int h, int q0) {
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, tig = lane & 3;
  const int S = a.S;
  const size_t ld = 3 * static_cast<size_t>(a.W);
  const bf16* qb = a.qkv + row0 * ld + h * kHeadDim;
  const bf16* kb = qb + a.W;
  const bf16* vb = qb + 2 * a.W;
  const size_t bh = row0 / S * a.H + h;  // the pre-pass's (image, head)
  const int wrow = warp * 16;
  const int n_tiles = (S + kMmaKeys - 1) / kMmaKeys;
  // Dividing p before p.V, or quantizing it, needs the row's sum (and amax)
  // first: a first pass over the keys takes them, the second runs p.V.
  constexpr bool kTwoPass = !C::kFold || C::kPV8;
  const int n_steps = (kTwoPass ? 2 : 1) * n_tiles;
  const int first_pv = n_steps - n_tiles;  // the steps from here on run p.V
  // Key tile t into stage st of the K and V rings (bf16 from qkv, or the
  // pre-pass's int8 tiles, whose padding keys are zeros).
  const auto load_k = [&](int st, int t) {
    if constexpr (C::kQK8) {
      const size_t at = bh * a.s_pad + static_cast<size_t>(t) * kMmaKeys;
      load_tile8_async(sm.k8(st), a.k8 + at * kHeadDim, kHeadDim, tid);
      if (tid < kMmaKeys / 4) cp_async16(smem_addr(sm.ks + st * 64 + 4 * tid), a.ks + at + 4 * tid, 16);
    } else {
      const int k0 = t * kMmaKeys;
      load_tile_async(sm.k(st), kb + static_cast<size_t>(k0) * ld, ld, S - k0, tid);
    }
  };
  const auto load_v = [&](int st, int t) {
    if constexpr (C::kPV8) {
      load_tile8_async(sm.v8(st), a.vt + bh * kHeadDim * a.s_pad + t * kMmaKeys, a.s_pad, tid);
    } else {
      const int k0 = t * kMmaKeys;
      load_tile_async(sm.v(st), vb + static_cast<size_t>(k0) * ld, ld, S - k0, tid);
    }
  };

  __syncthreads();  // the previous unit is done with shared memory
  load_tile_async(sm.q, qb + static_cast<size_t>(q0) * ld, ld, S - q0, tid);
  load_k(0, 0);
  if (first_pv == 0) load_v(0, 0);
  cp_async_commit();

  using OAcc = typename std::conditional<C::kPV8, int, float>::type;
  OAcc o[8][4];
#pragma unroll
  for (int n = 0; n < 8; ++n) o[n][0] = o[n][1] = o[n][2] = o[n][3] = 0;
  uint32_t qa[4][4];
  float l[2] = {0.f, 0.f}, amax[2] = {0.f, 0.f}, qsc[2] = {0.f, 0.f}, ps[2] = {0.f, 0.f};
  const uint32_t k_addr = smem_addr(sm.k(0)), v_addr = smem_addr(sm.v(0));

  for (int step = 0; step < n_steps; ++step) {
    const int t = step % n_tiles, st = step & 1;
    const bool pv = step >= first_pv;
    cp_async_wait_all();
    fence_proxy_async();
    __syncthreads();
    if (step + 1 < n_steps) {
      load_k(st ^ 1, (step + 1) % n_tiles);
      if (step + 1 >= first_pv) load_v(st ^ 1, (step + 1) % n_tiles);
    }
    cp_async_commit();
    if (kTwoPass && step == first_pv) {  // the first pass is done: its row sums
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        l[i] += __shfl_xor_sync(0xffffffffu, l[i], 1);
        l[i] += __shfl_xor_sync(0xffffffffu, l[i], 2);
        if constexpr (C::kPV8) {
          amax[i] = fmaxf(amax[i], __shfl_xor_sync(0xffffffffu, amax[i], 1));
          amax[i] = fmaxf(amax[i], __shfl_xor_sync(0xffffffffu, amax[i], 2));
          ps[i] = fmaxf(amax[i], 1e-6f) / 127.0f;
        }
      }
    }

    if constexpr (C::kQK8) {
      if (step == 0) {  // q quantized per row into the int8 Q tile
        quant_rows(sm.q, sm.q8, sm.qs, tid);
        fence_proxy_async();
        __syncthreads();
      }
    }
    if constexpr (C::kQK8) {
      if (step == 0) {
        qsc[0] = sm.qs[wrow + g] * a.sconst;
        qsc[1] = sm.qs[wrow + g + 8] * a.sconst;
      }
    } else if (step == 0 || kTwoPass) {
      // q (q' for exp2) as A fragments: once, as row 1, for one pass over the
      // keys; afresh at each step of two, where fragments held across both
      // passes' waits gave wrong products on the card.
      load_a_frags(qa, sm.q, wrow, lane);
      if constexpr (C::kExp2) scale_a_frags(qa, a.qconst);
    }

    // s = q . k^T over the tile's 64 keys.
    float s[8][4];
    const int k0 = t * kMmaKeys;
    if constexpr (C::kQK8) {
      int si[8][4];
#pragma unroll
      for (int n = 0; n < 8; ++n) si[n][0] = si[n][1] = si[n][2] = si[n][3] = 0;
      const uint64_t qd = sw128_desc(smem_addr(sm.q8)), kd = sw128_desc(smem_addr(sm.k8(st)));
      wgmma_fence();
      wgmma_s8_m64n64k32_ss(si, qd, kd, 1);  // depth 64: two 32-B steps
      wgmma_s8_m64n64k32_ss(si, qd + 2, kd + 2, 1);
      wgmma_commit_wait();
      fence_regs(si);
#pragma unroll
      for (int n = 0; n < 8; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          s[n][e] = static_cast<float>(si[n][e]) * qsc[e >> 1] *
                    sm.ks[st * 64 + 8 * n + 2 * tig + (e & 1)];
    } else {
      zero_acc(s);
      const uint64_t kd = sw128_desc(k_addr + st * kTileElems * 2);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) wgmma_64x64x16<0>(s, qa[kk], kd + 2 * kk);
      wgmma_commit_wait();
      fence_regs(s);
      if constexpr (!C::kExp2) {
#pragma unroll
        for (int n = 0; n < 8; ++n)
#pragma unroll
          for (int e = 0; e < 4; ++e) s[n][e] = s[n][e] * a.scale;
      }
    }

    // p: the variant's softmax numerator (or s itself), 0 past S.
#pragma unroll
    for (int n = 0; n < 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int key = k0 + 8 * n + 2 * tig + (e & 1);
        float v = s[n][e];
        if constexpr (C::kSoftmax) {
          if constexpr (C::kClamp) v = fminf(v, a.clamp);
          v = C::kExp2 ? exp2f(v) : expf(v);
        }
        s[n][e] = key < S ? v : 0.f;
      }
    if (!pv) {  // the first pass: the row sums (and amax) only
#pragma unroll
      for (int n = 0; n < 8; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          l[e >> 1] += s[n][e];
          if constexpr (C::kPV8) amax[e >> 1] = fmaxf(amax[e >> 1], fabsf(s[n][e]));
        }
      continue;
    }

    if constexpr (C::kPV8) {
      // pq = clip(round(p / ps), +-127) into the int8 P tile, then o += pq . vq.
#pragma unroll
      for (int n = 0; n < 8; ++n)
#pragma unroll
        for (int h2 = 0; h2 < 2; ++h2) {
          const int r = wrow + g + 8 * h2;
          int q[2];
#pragma unroll
          for (int i = 0; i < 2; ++i)
            q[i] = static_cast<int>(fminf(fmaxf(rintf(s[n][2 * h2 + i] / ps[h2]), -127.f), 127.f));
          *reinterpret_cast<uint16_t*>(sm.p8 + swz8(r, 8 * n + 2 * tig)) =
              static_cast<uint16_t>((q[0] & 0xff) | ((q[1] & 0xff) << 8));
        }
      fence_proxy_async();
      __syncthreads();
      const uint64_t pd = sw128_desc(smem_addr(sm.p8)), vd = sw128_desc(smem_addr(sm.v8(st)));
      wgmma_fence();
      wgmma_s8_m64n64k32_ss(o, pd, vd, 1);
      wgmma_s8_m64n64k32_ss(o, pd + 2, vd + 2, 1);
      wgmma_commit_wait();
      fence_regs(o);
    } else {
      uint32_t pa[4][4];
#pragma unroll
      for (int n = 0; n < 8; ++n) {
        float p[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          p[e] = s[n][e];
          if constexpr (C::kFold) {
            l[e >> 1] += p[e];  // on the unrounded p, as row 1
          } else {
            p[e] = p[e] / l[e >> 1];  // bf16(p / l), the plain version's rounding site
          }
        }
        pa[n >> 1][(n & 1) * 2] = pack_bf16(p[0], p[1]);
        pa[n >> 1][(n & 1) * 2 + 1] = pack_bf16(p[2], p[3]);
      }
      const uint64_t vd = sw128_desc(v_addr + st * kTileElems * 2);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) wgmma_64x64x16<1>(o, pa[kk], vd + 128 * kk);
      wgmma_commit_wait();
      fence_regs(o);
    }
  }

  if (q0 + wrow >= S) return;  // the warp's rows all lie past S (warp-uniform)
  float inv[2] = {1.f, 1.f};
  if constexpr (C::kFold && C::kSoftmax) {
    if constexpr (!kTwoPass) {
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        l[i] += __shfl_xor_sync(0xffffffffu, l[i], 1);
        l[i] += __shfl_xor_sync(0xffffffffu, l[i], 2);
      }
    }
    inv[0] = 1.0f / l[0];
    inv[1] = 1.0f / l[1];
  }
  float of[8][4];
#pragma unroll
  for (int n = 0; n < 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      if constexpr (C::kPV8)  // o = acc * ps * vs (then * 1/l)
        of[n][e] = static_cast<float>(o[n][e]) * ps[e >> 1] *
                   a.vs[bh * kHeadDim + 8 * n + 2 * tig + (e & 1)];
      else
        of[n][e] = o[n][e];
    }
  const size_t at = (row0 + q0) * a.W + h * kHeadDim;
  if constexpr (std::is_same<TO, bf16>::value)
    store_rows(sm.q, of, inv, static_cast<bf16*>(a.out) + at, a.W, S - q0, wrow, lane);
  else
    store_rows_f32(of, inv, static_cast<float*>(a.out) + at, a.W, S - q0, wrow, lane);
}

// Grid by schedule (nq = ceil(S/64) query tiles): kHead (nq, H, B), a unit
// a block; kGBatch (H, B/2), the 2 nq units of a head of an image pair;
// kHStack (B), the H nq units of an image; kHG (B/2), the 2 H nq units of an
// image pair.
template <class C, typename TO, Sched kS>
__global__ void __launch_bounds__(kMmaThreads, (C::kQK8 || C::kPV8) ? 2 : 4)
var_core_mma_kernel(CoreArgs a) {
  extern __shared__ unsigned char smem_raw[];
  const VarSmem<C> sm(smem_raw);
  const int nq = (a.S + kMmaRows - 1) / kMmaRows;
  if constexpr (kS == Sched::kHead) {
    var_core_unit<C, TO>(a, sm, static_cast<size_t>(blockIdx.z) * a.S, blockIdx.y,
                         blockIdx.x * kMmaRows);
  } else {
    const int n_units = kS == Sched::kGBatch ? 2 * nq : kS == Sched::kHStack ? a.H * nq
                                                                                : 2 * a.H * nq;
    for (int u = 0; u < n_units; ++u) {
      int img, h, qt;
      if constexpr (kS == Sched::kGBatch) {
        img = 2 * blockIdx.y + u / nq, h = blockIdx.x, qt = u % nq;
      } else if constexpr (kS == Sched::kHStack) {
        img = blockIdx.x, h = u / nq, qt = u % nq;
      } else {
        img = 2 * blockIdx.x + (u % (2 * nq)) / nq, h = u / (2 * nq), qt = u % nq;
      }
      var_core_unit<C, TO>(a, sm, static_cast<size_t>(img) * a.S, h, qt * kMmaRows);
    }
  }
}

template <class C, typename TO, Sched kS = Sched::kHead>
cudaError_t launch_var_core_mma(const CoreArgs& a, int B, cudaStream_t st) {
  constexpr int smem = VarSmem<C>::kBytes;
  if ((kS == Sched::kGBatch || kS == Sched::kHG) && B % 2) return cudaErrorInvalidValue;
  AIIC_CHECK(cudaFuncSetAttribute(var_core_mma_kernel<C, TO, kS>,
                                  cudaFuncAttributeMaxDynamicSharedMemorySize, smem));
  const dim3 grid = kS == Sched::kHead ? dim3((a.S + kMmaRows - 1) / kMmaRows, a.H, B)
                    : kS == Sched::kGBatch ? dim3(a.H, B / 2)
                    : kS == Sched::kHStack ? dim3(B) : dim3(B / 2);
  if (grid.z > 65535u || grid.y > 65535u) return cudaErrorInvalidValue;
  var_core_mma_kernel<C, TO, kS><<<grid, kMmaThreads, smem, st>>>(a);
  return cudaGetLastError();
}

// The int8 cores: the pre-pass over (head, image), then the core.
template <class C>
cudaError_t launch_int8_core(const CoreArgs& a, int B, cudaStream_t st) {
  if (a.k8 == nullptr || a.ks == nullptr || a.vt == nullptr || a.vs == nullptr)
    return cudaErrorInvalidValue;
  kv8_prepass_kernel<C::kQK8, C::kPV8><<<dim3(a.H, B), kMmaThreads, 0, st>>>(a);
  AIIC_CHECK(cudaGetLastError());
  return launch_var_core_mma<C, bf16>(a, B, st);
}

cudaError_t run_core_mma(int variant, CoreArgs a, int B, cudaStream_t st) {
  switch (variant) {
    case kNomax: return launch_var_core_mma<CoreNomax, float>(a, B, st);
    case kV1: a.clamp = 70.0f; return launch_var_core_mma<CoreExpFold, float>(a, B, st);
    case kV2: a.clamp = kClamp80e2; return launch_var_core_mma<CoreExp2Div, float>(a, B, st);
    case kV3:
    case kNoLn: a.clamp = kClamp70e2; return launch_var_core_mma<CoreExp2Fold, float>(a, B, st);
    case kV4: a.clamp = 80.0f; return launch_var_core_mma<CoreExpDiv, float>(a, B, st);
    case kNoSm: return launch_var_core_mma<CoreNoSm, float>(a, B, st);
    case kQoBf16: a.clamp = kClamp70e2; return launch_var_core_mma<CoreExp2Fold, bf16>(a, B, st);
    case kGBatch:
      a.clamp = kClamp70e2;
      return launch_var_core_mma<CoreExp2Fold, bf16, Sched::kGBatch>(a, B, st);
    case kHStack:
      a.clamp = kClamp70e2;
      return launch_var_core_mma<CoreExp2Fold, bf16, Sched::kHStack>(a, B, st);
    case kHG:
      a.clamp = kClamp70e2;
      return launch_var_core_mma<CoreExp2Fold, bf16, Sched::kHG>(a, B, st);
    case kCoreQK: return launch_int8_core<CoreQK8>(a, B, st);
    case kCorePV: return launch_int8_core<CorePV8>(a, B, st);
    case kCoreBoth: return launch_int8_core<CoreBoth8>(a, B, st);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace
}  // namespace aiic

extern "C" int aiic_attn_variant_wgmma(
    int variant, const void* x, const void* ln_s, const void* ln_b, const void* wqkv_t,
    const void* sqkv, const void* bqkv, const void* wo_t, const void* so, const void* wo,
    const void* bo, void* out, void* hq, void* hs, void* amax, void* qkv, void* attn, void* aq,
    void* as, void* kv8, void* kvs, int B, int S, int W, int H, float eps, float qconst,
    void* stream) {
  using namespace aiic;
  auto f = [](const void* p) { return static_cast<const float*>(p); };
  const auto st = static_cast<cudaStream_t>(stream);
  const auto xb = static_cast<const bf16*>(x);
  const auto wq = static_cast<const int8_t*>(wqkv_t);
  const auto woq = static_cast<const int8_t*>(wo_t);
  auto hq8 = static_cast<int8_t*>(hq);
  auto aq8 = static_cast<int8_t*>(aq);
  auto o = static_cast<bf16*>(out);
  if (variant < 0 || variant >= kNumAttnVariants || B <= 0 || W % kSBN || W != H * kHeadDim ||
      S <= 0 || ((variant == kV4 || variant == kGBatch || variant == kHG) && B % 2))
    return cudaErrorInvalidValue;
  const int rows = B * S;
  const int8_t* hqc = hq8;
  const int8_t* aqc = aq8;
  if (variant == kMacOnly) {
    AIIC_CHECK(fill_int8(hq8, static_cast<size_t>(rows) * W, 3, st));
    AIIC_CHECK(launch_wgmma_stage(hqc, wq, rows, 3 * W, W, EpiClip8{aq8, W}, st));
    return launch_wgmma_stage(aqc, woq, rows, W, W, EpiAddRaw{xb, o, W}, st);
  }
  auto hsf = static_cast<float*>(hs);
  auto qkvb = static_cast<bf16*>(qkv);
  if (variant == kV4) {  // one scale per image pair
    AIIC_CHECK(launch_rowquant_var<RowQuant::kTileAmax>(xb, f(ln_s), f(ln_b), hq8,
                                                        static_cast<float*>(amax), nullptr, rows,
                                                        W, eps, st));
    AIIC_CHECK(launch_rowquant_var<RowQuant::kTileQuant>(xb, f(ln_s), f(ln_b), hq8, hsf, f(amax),
                                                         rows, W, eps, st, 0.f, 2 * S));
    AIIC_CHECK(launch_wgmma_stage(hqc, wq, rows, 3 * W, W,
                                  EpiQKVTile{hsf, f(sqkv), f(bqkv), qkvb, 3 * W}, st));
  } else {  // row 1's stage, with LN1 or not (noln)
    const Int8Attn a{f(ln_s), f(ln_b), nullptr, f(sqkv), f(bqkv), nullptr, nullptr, nullptr};
    AIIC_CHECK(variant == kNoLn
                   ? int8_qkv_stage_wgmma<false>(xb, a, wq, qkvb, hq8, hsf, rows, W, eps, st)
                   : int8_qkv_stage_wgmma<true>(xb, a, wq, qkvb, hq8, hsf, rows, W, eps, st));
  }
  if (variant != kNoCore) {
    const float scale = 1.0f / sqrtf(static_cast<float>(kHeadDim));  // dim ** -0.5, exact for 64
    const float sconst = static_cast<float>(0.125 * 1.4426950408889634);
    // The int8 cores' pre-pass scratch: K (B*H, s_pad, 64) then V^T (B*H, 64,
    // s_pad) int8; the key rows' scales (B*H, s_pad) then the channels' (B*H,
    // 64) f32.
    const int s_pad = (S + kMmaKeys - 1) / kMmaKeys * kMmaKeys;
    const size_t bhs = static_cast<size_t>(B) * H * s_pad;
    auto k8 = static_cast<int8_t*>(kv8);
    auto ks = static_cast<float*>(kvs);
    AIIC_CHECK(run_core_mma(variant,
                            CoreArgs{qkvb, attn, S, W, H, qconst, sconst, scale, 0.f, k8, ks,
                                     k8 ? k8 + bhs * kHeadDim : nullptr, ks ? ks + bhs : nullptr,
                                     s_pad},
                            B, st));
  }
  if (variant >= kQoBf16)  // bf16 out-projection, wo as it lies
    return launch_wgmma_stage(static_cast<const bf16*>(attn), static_cast<const bf16*>(wo), rows,
                              W, W, EpiOutProj{f(bo), xb, o, W}, st);
  auto asf = static_cast<float*>(as);
  if (variant == kNoCore)  // attn = f32(qkv[:, :W])
    AIIC_CHECK((launch_rowquant<false, bf16>(static_cast<const bf16*>(qkvb), nullptr, nullptr, aq8,
                                             asf, rows, W, eps, st, 3 * W)));
  else
    AIIC_CHECK((launch_rowquant<false, float>(static_cast<const float*>(attn), nullptr, nullptr,
                                              aq8, asf, rows, W, eps, st)));
  return launch_wgmma_stage(aqc, woq, rows, W, W, EpiResidual{asf, f(so), f(bo), xb, o, W}, st);
}
