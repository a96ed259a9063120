// The whole training text block with LoRA in the int8 serving numerics,
// forward and backward, for Hopper (sm_90a):
//
//   h1 = LN1(x); qkv = bf16(deq(rowquant(h1) . Wqkv_q) + bqkv); a = attention(qkv)
//   y1 = x + a Wo + bo + s (a Ao) Bo                      (bf16 products)
//   h2 = LN2(y1); f = deq(rowquant(h2) . W1_q) + b1 + s (h2 Af) Bf
//   u  = f sigmoid(1.702 f)
//   y  = y1 + deq(rowquant(u) . W2_q) + b2 + s (u Ap) Bp
//
// with deq(acc) = (acc * rowscale) * colscale, every activation row-quantized
// from fp32 (never rounded to bf16 first), int8 x int8 -> int32 products; the
// backward is the straight-through estimator, each cotangent product through
// an int8 weight int8 itself: rowquant(g * colscale) . Wq^T * rowscale for
// g = dy (over W), dfq (over M, per (row, chunk) when n_chunks > 1) and dqkv
// (over 3W).
//
// Replaces the TPU kernels of aiic_tpu/ops/block_grad.py:
//   aiic_text_block_int8_fwd <- _text_block_fwd_int8_kernel (:1084) and
//                               _text_block_fwd_int8_chunk_kernel (:1433),
//                               via text_block_fwd_int8 (:1703);
//   aiic_text_block_int8_bwd <- _text_block_bwd_int8_kernel (:1104) and
//                               _text_block_bwd_int8_chunk_kernel (:1542),
//                               via text_block_bwd_int8 (:1867).
// The chunked forward quantizes u over the full hidden axis and sums c_proj
// in int32, so its math is the unchunked one; the chunked backward differs
// only in quantizing dfq * s1 per (row, chunk) and summing the chunks'
// dequantized products in order. One forward serves both plans; the
// backward takes n_chunks. The plain PyTorch versions are
// aiic_tpu_torch/ops/block_grad.py::text_block_{fwd,bwd}_int8_ref.
//
// Built from text_block.cuh's pieces (bf16 only): the LN passes, the core
// forward, the rank-r products and the row-axis LoRA reductions (no
// atomics: a run repeats bit for bit). Values
// that feed a row quantizer stay fp32: u, dfq, dqkv (and dy1); a product
// that rounds them to bf16 does so on load. Two forms:
// - form 0, the route: the core forward on the tensor-core kernel of
//   block_core_fwd_mma.cuh (p normalized before p.V, one 80-key tile), the
//   rank-r products on rank_down_kernel and rank_cot_kernel, and every
//   backbone product on the wgmma + TMA stage of
//   wgmma_serving_gemm.cuh. The forward's int8 QKV, c_fc and c_proj read
//   the K-major copies w^T that quant.kmajor keeps once per weight (the
//   weights are frozen in LoRA training); the backward's int8 cotangent
//   products g.Wq^T read the int8 weights as they lie, which is already the
//   K-major B; wo and dy1.wo^T run the stage's bf16 form (MN-major B, and
//   K-major for the transposed read). The chunked dh2 product (n_chunks >
//   1) folds its chunk sums into the stage's mainloop (EpiChunkRowScale: 0,
//   then each chunk's acc * dfs[r, c] in order, the LoRA term last, the
//   order of form 1's split product and sum pass, so the same bits), which
//   needs M / n_chunks whole 128-B K-slices. The core backward runs row 9's
//   two tensor-core passes, storing dqkv in fp32 for its row quantizer.
// - form 1, the first design: common.cuh's WMMA int8 GEMM (kTransB for the
//   cotangent products, a split depth for the per-chunk dfq product, then
//   sum_partials_kernel), the WMMA bf16 GEMM for wo, the scalar
//   block_core_fwd_kernel and block_core_bwd_kernel, the 64x16 SIMT rank-r
//   tile; kept reachable, uncounted, for the side-by-side check and time.
// The int8 products are exact in int32 in any order, the epilogues are
// shared and the rank-r products keep their order, so those agree bit for
// bit; the bf16 wo products and the core forward and backward sum fp32 in
// another order.
//
// What bounds it on the H100: at B=256 text rows (S=77, W=512, M=2048, H=8,
// rank 16) the forward does 113.7 GOP of int8 products and 17.3 GFLOP of
// bf16 ones (wo, the core, the rank-r products): 0.075 ms at 1,979 TOP/s int8
// and 989 TFLOP/s bf16; the backward 186.0 GOP int8 and 41.3 GFLOP bf16:
// 0.136 ms. Both are bound by operations.
//
// What the design gives up: the row quantizers need a whole row's amax, so
// u, dfq and dqkv make an fp32 round trip through device memory; the
// rank-r products run on the CUDA cores (their fmaf order is the contract);
// every intermediate goes through device memory between launches.

#include "text_block.cuh"

namespace aiic {
namespace {

struct Int8Args {
  BlockArgs p;  // wqkv, w1, w2 are the int8 weights (in, out); p.form the form
  const float *sqkv, *s1, *s2;  // their per-output-channel scales
  int C;  // hidden-axis chunks of the backward's dfq quantization
  // Form 0: the K-major copies w^T (out, in) that the stage reads for the
  // forward's products (wqkv_t, w1_t; w2_t in the forward alone). The
  // backward's cotangent products read the weights as they lie, which is
  // already the K-major B of g . w^T.
  const int8_t *wqkv_t, *w1_t, *w2_t;
};

struct Workspace8 {
  int8_t *h1q, *h2q, *uq;
  float *h1s, *h2s, *us;
  bf16 *qkv, *a, *a_ao, *h2, *h2_af, *u_ap;
  float *y1, *u, *f, *part;
  // backward
  bf16 *t_p, *t_f, *dy1c, *t_o, *da;
  int8_t *dyq, *dfqq, *dqkvq;
  float *dys, *dfs, *dqs;
  float *dfq, *dh2, *dy1, *dqkv, *dh1;
  float* core_ws;  // the tensor-core core backward's inv and delta, 2 B H S
};

size_t layout8(char* base, int B, int S, int W, int M, int ro, int rf, int rp, int C,
               bool backward, Workspace8* w) {
  const size_t rows = static_cast<size_t>(B) * S;
  size_t off = 0;
  auto take = [&](size_t bytes) -> void* {
    void* p = base ? base + off : nullptr;
    off += (bytes + 255) / 256 * 256;
    return p;
  };
  auto i8 = [&](size_t n) { return static_cast<int8_t*>(take(n)); };
  auto f32 = [&](size_t n) { return static_cast<float*>(take(n * 4)); };
  auto b16 = [&](size_t n) { return static_cast<bf16*>(take(n * 2)); };
  *w = Workspace8{};
  w->h1q = i8(rows * W);
  w->h1s = f32(rows);
  w->qkv = b16(rows * 3 * W);
  w->a = b16(rows * W);
  w->a_ao = b16(rows * ro);
  w->y1 = f32(rows * W);
  w->h2 = b16(rows * W);
  w->h2q = i8(rows * W);
  w->h2s = f32(rows);
  w->h2_af = b16(rows * rf);
  w->u = f32(rows * M);
  w->u_ap = b16(rows * rp);
  // partial sums: the split rank-r down-projections (depth W or M in
  // kDepthChunk slices), in the backward also the LoRA cotangents (depth
  // rows in kRowChunk slices) and the C > 1 chunk products of dfq . W1^T
  const size_t rmax = ro > rf ? (ro > rp ? ro : rp) : (rf > rp ? rf : rp);
  const size_t wide = M > W ? M : W;
  size_t part = (wide + kDepthChunk - 1) / kDepthChunk * rows * rmax;
  if (backward) {
    const size_t cot = (rows + kRowChunk - 1) / kRowChunk * wide * rmax;
    const size_t dh2 = C > 1 ? static_cast<size_t>(C) * rows * W : 0;
    part = part > cot ? part : cot;
    part = part > dh2 ? part : dh2;
  }
  w->part = f32(part);
  if (!backward) {
    w->uq = i8(rows * M);
    w->us = f32(rows);
    return off;
  }
  w->f = f32(rows * M);
  w->t_p = b16(rows * rp);
  w->dyq = i8(rows * W);
  w->dys = f32(rows);
  w->dfq = f32(rows * M);
  w->dfqq = i8(rows * M);
  w->dfs = f32(rows * C);
  w->t_f = b16(rows * rf);
  w->dh2 = f32(rows * W);
  w->dy1 = f32(rows * W);
  w->dy1c = b16(rows * W);
  w->t_o = b16(rows * ro);
  w->da = b16(rows * W);
  w->dqkv = f32(rows * 3 * W);
  w->dqkvq = i8(rows * 3 * W);
  w->dqs = f32(rows);
  w->dh1 = f32(rows * W);
  w->core_ws = f32(2 * rows * (W / kHeadDim));
  return off;
}

// ---------------------------------------------------------------------------
// Row passes
// ---------------------------------------------------------------------------

// y1 (rows, W) fp32 -> h2 = bf16(LN2 y1) and the int8 row quantization of
// the fp32 LN2 y1 (h2q, h2s). Dynamic shared memory: W floats.
__global__ void __launch_bounds__(kRowThreads)
ln_rowquant_kernel(const float* __restrict__ y1, const float* __restrict__ ln_s,
                   const float* __restrict__ ln_b, bf16* __restrict__ h2, int8_t* __restrict__ q,
                   float* __restrict__ qs, int W, float eps) {
  extern __shared__ float h[];
  __shared__ float red[kRowThreads / 32 + 1];
  const size_t row = blockIdx.x;
  load_row<true>(y1 + row * W, ln_s, ln_b, h, red, W, eps);
  for (int i = threadIdx.x; i < W; i += kRowThreads) h2[row * W + i] = __float2bfloat16_rn(h[i]);
  quantize_row(h, q + row * W, qs + row, W, red);
}

// The int8 quantization of v * colscale per segment of seg values: block b
// takes v[b*seg, (b+1)*seg) (rows of n_seg segments, contiguous) against
// colscale[(b % n_seg)*seg ...], its scale going to qs[b] ((rows, n_seg)).
// Dynamic shared memory: seg floats.
template <typename TIn>
__global__ void __launch_bounds__(kRowThreads)
rowquant_scaled_kernel(const TIn* __restrict__ v, const float* __restrict__ colscale,
                       int8_t* __restrict__ q, float* __restrict__ qs, int seg, int n_seg) {
  extern __shared__ float h[];
  __shared__ float red[kRowThreads / 32 + 1];
  const size_t base = static_cast<size_t>(blockIdx.x) * seg;
  const float* cs = colscale + static_cast<size_t>(blockIdx.x % n_seg) * seg;
  for (int i = threadIdx.x; i < seg; i += kRowThreads) h[i] = to_f32(v[base + i]) * cs[i];
  quantize_row(h, q + base, qs + blockIdx.x, seg, red);
}

template <typename TIn>
cudaError_t launch_rowquant_scaled(const TIn* v, const float* colscale, int8_t* q, float* qs,
                                   int rows, int width, int n_seg, cudaStream_t st) {
  const int seg = width / n_seg;
  rowquant_scaled_kernel<TIn><<<rows * n_seg, kRowThreads, seg * sizeof(float), st>>>(
      v, colscale, q, qs, seg, n_seg);
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// Epilogues of the int8 products (acc is the int32 sum)
// ---------------------------------------------------------------------------

struct EpiQkv8 {  // qkv = bf16((acc * hs) * sqkv + bqkv)
  const float *hs, *s, *b;
  bf16* out;
  int n_cols;
  __device__ void operator()(int r, int n, int acc) const {
    const float v = static_cast<float>(acc) * hs[r] * s[n] + b[n];
    out[static_cast<size_t>(r) * n_cols + n] = __float2bfloat16_rn(v);
  }
};

struct EpiFc8 {  // f = ((acc * h2s) * s1 + b1) + s (h2 Af) Bf; u = f sigmoid(1.702 f), fp32
  const float *hs, *s, *b;
  LoRATerm<bf16> lora;
  float* f_out;  // kept for the backward, or null
  float* u;
  int n_cols;
  __device__ void operator()(int r, int n, int acc) const { apply(r, n, acc, lora(r, n)); }
  __device__ __forceinline__ void apply(int r, int n, int acc, float term) const {
    const size_t i = static_cast<size_t>(r) * n_cols + n;
    float f = static_cast<float>(acc) * hs[r] * s[n] + b[n];
    f = f + term;
    if (f_out) f_out[i] = f;
    u[i] = f * sigmoid_gelu(f);
  }
  AIIC_LORA_COLUMN(bf16)
};

struct EpiY8 {  // y = bf16(y1 + (((acc * us) * s2 + b2) + s (u Ap) Bp))
  const float *us, *s, *b;
  LoRATerm<bf16> lora;
  const float* y1;
  bf16* y;
  int n_cols;
  __device__ void operator()(int r, int n, int acc) const { apply(r, n, acc, lora(r, n)); }
  __device__ __forceinline__ void apply(int r, int n, int acc, float term) const {
    const size_t i = static_cast<size_t>(r) * n_cols + n;
    float mo = static_cast<float>(acc) * us[r] * s[n] + b[n];
    mo = mo + term;
    y[i] = __float2bfloat16_rn(y1[i] + mo);
  }
  AIIC_LORA_COLUMN(bf16)
};

struct EpiDfq8 {  // du = acc * dys + s t_p Ap^T; dfq = du (sig + 1.702 f sig (1 - sig)), fp32
  const float* qs;
  LoRATerm<bf16> lora;
  const float* f;
  float* dfq;
  int n_cols;
  __device__ void operator()(int r, int n, int acc) const { apply(r, n, acc, lora(r, n)); }
  __device__ __forceinline__ void apply(int r, int n, int acc, float term) const {
    const size_t i = static_cast<size_t>(r) * n_cols + n;
    const float du = static_cast<float>(acc) * qs[r] + term;
    const float fv = f[i];
    const float sg = sigmoid_gelu(fv);
    const float d = sg + kGeluK * fv * sg * (1.0f - sg);
    dfq[i] = du * d;
  }
  AIIC_LORA_COLUMN(bf16)
};

struct EpiChunkPart {  // one depth chunk's acc * its row scale, into slice blockIdx.z
  const float* qs;  // (rows, n_chunks)
  int n_chunks;
  float* part;
  int Mo, No;
  __device__ void operator()(int r, int n, int acc) const {
    const int z = blockIdx.z;
    part[(static_cast<size_t>(z) * Mo + r) * No + n] =
        static_cast<float>(acc) * qs[static_cast<size_t>(r) * n_chunks + z];
  }
};

struct EpiSplitStore {  // one depth split's int32 sum, into slice blockIdx.z
  int* out;
  int Mo, No;
  __device__ void operator()(int r, int n, int acc) const {
    out[(static_cast<size_t>(blockIdx.z) * Mo + r) * No + n] = acc;
  }
};

struct EpiDh2 {  // dh2 = acc * dfs + s t_f Af^T, fp32 (one chunk)
  const float* qs;
  LoRATerm<bf16> lora;
  float* out;
  int n_cols;
  __device__ void operator()(int r, int n, int acc) const { apply(r, n, acc, lora(r, n)); }
  __device__ __forceinline__ void apply(int r, int n, int acc, float term) const {
    out[static_cast<size_t>(r) * n_cols + n] = static_cast<float>(acc) * qs[r] + term;
  }
  AIIC_LORA_COLUMN(bf16)
};

struct EpiRowScale {  // out = acc * qs, fp32
  const float* qs;
  float* out;
  int n_cols;
  __device__ void operator()(int r, int n, int acc) const {
    out[static_cast<size_t>(r) * n_cols + n] = static_cast<float>(acc) * qs[r];
  }
};

// On the wgmma stage the epilogues with a rank-r term walk rows through
// shared memory with F's column in registers (ColumnCached), and so does
// qkv's (3W columns); the row-scale-only ones stay on the fragments.
template <> struct StagedEpilogue<EpiQkv8> { static constexpr bool value = true; };

// The chunked dh2 product folded on the stage: sum over chunks of
// acc_c * dfs[r, c], then the LoRA term s t_f Af^T.
using EpiDh2Fold = EpiChunkRowScale<LoRATerm<bf16>>;

// An int8 product on the stage (form 0: B = w^T (N, K), K-major) or on the
// WMMA tile (form 1: B = w (K, N), or with kTransB w (N, K) read
// transposed). kt: the K-major copy the stage reads in place of w, or null
// where w is already (N, K).
template <bool kTransB, typename Epi>
cudaError_t int8_gemm(const int8_t* A, const int8_t* w, const int8_t* kt, int rows, int N, int K,
                      Epi epi, int form, cudaStream_t st) {
  if (form == 0) return launch_wgmma_stage(A, kTransB ? w : kt, rows, N, K, epi, st);
  return launch_gemm<kTransB>(A, w, rows, N, K, epi, st);
}

// ---------------------------------------------------------------------------
// The block
// ---------------------------------------------------------------------------

// LN1 -> int8 QKV -> core -> out-projection (+LoRA, residual) -> LN2 ->
// int8 c_fc (+LoRA, gelu) and the rank-r down-projections; f is kept in the
// backward.
cudaError_t forward8(const Int8Args& q, const Workspace8& w, bool backward, cudaStream_t st) {
  const BlockArgs& p = q.p;
  const int rows = p.B * p.S, W = p.W, M = p.M;
  auto c = [](const void* v) { return static_cast<const bf16*>(v); };
  auto i8 = [](const void* v) { return static_cast<const int8_t*>(v); };
  const bf16* x = c(p.x);
  AIIC_CHECK((launch_rowquant<true, bf16>(x, p.ln1s, p.ln1b, w.h1q, w.h1s, rows, W, p.eps, st)));
  AIIC_CHECK(int8_gemm<false>(w.h1q, i8(p.wqkv), q.wqkv_t, rows, 3 * W, W,
                              EpiQkv8{w.h1s, q.sqkv, p.bqkv, w.qkv, 3 * W}, p.form, st));
  AIIC_CHECK(core_fwd<bf16>(p, w.qkv, w.a, st));
  AIIC_CHECK(
      down_proj<bf16>(w.a, W, c(p.aoA), p.ro, 1, rows, p.ro, w.part, w.a_ao, p.form, st));
  AIIC_CHECK(big_gemm<false>(static_cast<const bf16*>(w.a), c(p.wo), rows, W, W,
                             EpiY1<bf16>{p.bo, LoRATerm<bf16>{w.a_ao, c(p.aoB), p.ro, W, 1, p.s},
                                         x, w.y1, W}, p.form, st));
  ln_rowquant_kernel<<<rows, kRowThreads, W * sizeof(float), st>>>(w.y1, p.ln2s, p.ln2b, w.h2,
                                                                   w.h2q, w.h2s, W, p.eps);
  AIIC_CHECK(cudaGetLastError());
  AIIC_CHECK(
      down_proj<bf16>(w.h2, W, c(p.afA), p.rf, 1, rows, p.rf, w.part, w.h2_af, p.form, st));
  AIIC_CHECK(int8_gemm<false>(w.h2q, i8(p.w1), q.w1_t, rows, M, W,
                              EpiFc8{w.h2s, q.s1, p.b1,
                                     LoRATerm<bf16>{w.h2_af, c(p.afB), p.rf, M, 1, p.s},
                                     backward ? w.f : nullptr, w.u, M}, p.form, st));
  return down_proj<bf16>(w.u, M, c(p.apA), p.rp, 1, rows, p.rp, w.part, w.u_ap, p.form, st);
}

cudaError_t run_fwd8(const Int8Args& q, const Workspace8& w, bf16* y, cudaStream_t st) {
  const BlockArgs& p = q.p;
  const int rows = p.B * p.S;
  AIIC_CHECK(forward8(q, w, false, st));
  AIIC_CHECK((launch_rowquant<false, float>(w.u, nullptr, nullptr, w.uq, w.us, rows, p.M, 0.f,
                                            st)));
  return int8_gemm<false>(w.uq, static_cast<const int8_t*>(p.w2), q.w2_t, rows, p.W, p.M,
                          EpiY8{w.us, q.s2, p.b2,
                                LoRATerm<bf16>{w.u_ap, static_cast<const bf16*>(p.apB), p.rp,
                                               p.W, 1, p.s},
                                w.y1, y, p.W}, p.form, st);
}

// g: d(out_proj A, B), d(c_fc A, B), d(c_proj A, B), fp32.
cudaError_t run_bwd8(const Int8Args& q, const Workspace8& w, const bf16* dy, bf16* dx,
                     float* const* g, cudaStream_t st) {
  const BlockArgs& p = q.p;
  const int rows = p.B * p.S, W = p.W, M = p.M;
  auto c = [](const void* v) { return static_cast<const bf16*>(v); };
  auto i8 = [](const void* v) { return static_cast<const int8_t*>(v); };
  AIIC_CHECK(forward8(q, w, true, st));

  // MLP half: y = y1 + deq(rowquant(u) W2_q) + b2 + s (u Ap) Bp
  AIIC_CHECK(down_proj<bf16>(dy, W, c(p.apB), 1, W, rows, p.rp, w.part, w.t_p, p.form, st));
  AIIC_CHECK(launch_rowquant_scaled(dy, q.s2, w.dyq, w.dys, rows, W, 1, st));
  AIIC_CHECK(int8_gemm<true>(w.dyq, i8(p.w2), nullptr, rows, M, W,
                             EpiDfq8{w.dys, LoRATerm<bf16>{w.t_p, c(p.apA), p.rp, 1, p.rp, p.s},
                                     w.f, w.dfq, M}, p.form, st));
  AIIC_CHECK(
      rows_reduce<bf16>(w.u, M, w.t_p, p.rp, rows, p.s, w.part, g[4], false, p.form, st));
  AIIC_CHECK(rows_reduce<bf16>(dy, W, w.u_ap, p.rp, rows, p.s, w.part, g[5], true, p.form, st));
  AIIC_CHECK(down_proj<bf16>(w.dfq, M, c(p.afB), 1, M, rows, p.rf, w.part, w.t_f, p.form, st));
  AIIC_CHECK(launch_rowquant_scaled(w.dfq, q.s1, w.dfqq, w.dfs, rows, M, q.C, st));
  const LoRATerm<bf16> t_f_afA{w.t_f, c(p.afA), p.rf, 1, p.rf, p.s};
  if (q.C == 1) {
    AIIC_CHECK(int8_gemm<true>(w.dfqq, i8(p.w1), nullptr, rows, W, M,
                               EpiDh2{w.dfs, t_f_afA, w.dh2, W}, p.form, st));
  } else if (p.form == 0) {  // the chunk sums folded into the stage's mainloop
    AIIC_CHECK(launch_wgmma_stage(static_cast<const int8_t*>(w.dfqq), i8(p.w1), rows, W, M,
                                  EpiDh2Fold{w.dfs, t_f_afA, w.dh2, W, q.C}, st));
  } else {  // each chunk's dequantized product, then their sum in chunk order
    AIIC_CHECK(launch_gemm<true>(w.dfqq, i8(p.w1), rows, W, M,
                                 EpiChunkPart{w.dfs, q.C, w.part, rows, W}, st, M / q.C));
    sum_partials_kernel<<<(rows * W + 255) / 256, 256, 0, st>>>(
        w.part, q.C, rows, W, EpiLoRAOut<bf16, float>{t_f_afA, w.dh2, W});
    AIIC_CHECK(cudaGetLastError());
  }
  AIIC_CHECK(
      rows_reduce<bf16>(w.h2, W, w.t_f, p.rf, rows, p.s, w.part, g[2], false, p.form, st));
  AIIC_CHECK(
      rows_reduce<bf16>(w.dfq, M, w.h2_af, p.rf, rows, p.s, w.part, g[3], true, p.form, st));
  AIIC_CHECK(launch_ln_bwd(static_cast<const float*>(w.y1), w.dh2, p.ln2s, dy, w.dy1, w.dy1c,
                           rows, W, p.eps, st));

  // attention half: y1 = x + a Wo + bo + s (a Ao) Bo (wo in bf16, as in serving)
  AIIC_CHECK(down_proj<bf16>(static_cast<const float*>(w.dy1), W, c(p.aoB), 1, W, rows, p.ro,
                             w.part, w.t_o, p.form, st));
  AIIC_CHECK(big_gemm<true>(static_cast<const bf16*>(w.dy1c), c(p.wo), rows, W, W,
                            EpiLoRAOut<bf16, bf16>{
                                LoRATerm<bf16>{w.t_o, c(p.aoA), p.ro, 1, p.ro, p.s}, w.da, W},
                            p.form, st));
  AIIC_CHECK(
      rows_reduce<bf16>(w.a, W, w.t_o, p.ro, rows, p.s, w.part, g[0], false, p.form, st));
  AIIC_CHECK(rows_reduce<bf16>(static_cast<const float*>(w.dy1), W, w.a_ao, p.ro, rows, p.s,
                               w.part, g[1], true, p.form, st));
  if (p.form == 0)  // row 9's two tensor-core passes, dqkv stored in fp32
    AIIC_CHECK(launch_core_bwd_mma(static_cast<const bf16*>(w.qkv),
                                   static_cast<const bf16*>(w.da), p.mask, w.dqkv, w.core_ws, p.B,
                                   p.S, W, p.H, p.qconst, st));
  else
    AIIC_CHECK(launch_core_bwd(static_cast<const bf16*>(w.qkv), static_cast<const bf16*>(w.da),
                               p.mask, w.dqkv, p.B, p.S, W, p.H, p.qconst, st));
  AIIC_CHECK(launch_rowquant_scaled(static_cast<const float*>(w.dqkv), q.sqkv, w.dqkvq, w.dqs,
                                    rows, 3 * W, 1, st));
  AIIC_CHECK(int8_gemm<true>(w.dqkvq, i8(p.wqkv), nullptr, rows, W, 3 * W,
                             EpiRowScale{w.dqs, w.dh1, W}, p.form, st));
  return launch_ln_bwd(static_cast<const bf16*>(p.x), w.dh1, p.ln1s,
                       static_cast<const float*>(w.dy1), dx, static_cast<bf16*>(nullptr), rows, W,
                       p.eps, st);
}

// Form 0's fold needs each chunk of the hidden axis to be whole 128-B int8
// K-slices of the stage, form 1's split product whole 32-deep WMMA steps.
bool valid8(int S, int W, int H, int M, int C, int form) {
  return valid(S, W, H, M) && valid_form(form, false, S) && C > 0 && M % C == 0 &&
         (M / C) % (form == 0 ? 128 : kBK) == 0;
}

// Form 0 reads the K-major copies of the forward's weights: wqkv_t and w1_t,
// and w2_t where c_proj runs (the forward).
bool copies8(const Int8Args& q, bool forward) {
  return q.p.form != 0 || (q.wqkv_t && q.w1_t && (q.w2_t || !forward));
}

}  // namespace
}  // namespace aiic

// Bytes of workspace the forward (backward == 0) or backward needs.
extern "C" long long aiic_text_block_int8_workspace(int B, int S, int W, int M, int ro, int rf,
                                                    int rp, int n_chunks, int backward) {
  aiic::Workspace8 w;
  return static_cast<long long>(
      aiic::layout8(nullptr, B, S, W, M, ro, rf, rp, n_chunks, backward != 0, &w));
}

#define AIIC_INT8_PARAMS                                                                       \
  const void *mask, const void *ln1s, const void *ln1b, const void *ln2s, const void *ln2b,    \
      const void *wqkv_q, const void *sqkv, const void *bqkv, const void *wo, const void *bo,  \
      const void *w1_q, const void *s1, const void *b1, const void *w2_q, const void *s2,      \
      const void *b2, const void *aoA, const void *aoB, const void *afA, const void *afB,      \
      const void *apA, const void *apB, const void *wqkv_t, const void *w1_t, const void *w2_t

#define AIIC_INT8_ARGS(x, C)                                                                   \
  aiic::Int8Args {                                                                             \
    aiic::BlockArgs{x, static_cast<const float*>(mask), static_cast<const float*>(ln1s),      \
                    static_cast<const float*>(ln1b), static_cast<const float*>(ln2s),         \
                    static_cast<const float*>(ln2b), wqkv_q, static_cast<const float*>(bqkv), \
                    wo, static_cast<const float*>(bo), w1_q, static_cast<const float*>(b1),   \
                    w2_q, static_cast<const float*>(b2), aoA, aoB, afA, afB, apA, apB, B, S,  \
                    W, H, M, ro, rf, rp, scaling, eps, qconst, form},                         \
        static_cast<const float*>(sqkv), static_cast<const float*>(s1),                       \
        static_cast<const float*>(s2), C, static_cast<const int8_t*>(wqkv_t),                 \
        static_cast<const int8_t*>(w1_t), static_cast<const int8_t*>(w2_t)                    \
  }

// x, y (B,S,W) bf16; mask (S,S) f32; ln*, b* f32 vectors holding bf16-rounded
// values; wqkv_q (W,3W), w1_q (W,M), w2_q (M,W) int8 with f32 scales sqkv
// (3W), s1 (M), s2 (W); wo (W,W) and the LoRA factors A (in,r), B (r,out)
// bf16; wqkv_t, w1_t, w2_t the int8 weights' K-major copies w^T (form 0
// reads them; form 1 takes null). form 0: the products on the wgmma + TMA
// stage; 1: on the WMMA tile. Needs W, M multiples of 128, W == 64 H, S <=
// 128. Returns a cudaError_t.
extern "C" int aiic_text_block_int8_fwd(const void* x, AIIC_INT8_PARAMS, void* y, void* ws,
                                        int B, int S, int W, int H, int M, int ro, int rf,
                                        int rp, float scaling, float eps, float qconst, int form,
                                        void* stream) {
  using namespace aiic;
  const Int8Args q = AIIC_INT8_ARGS(x, 1);
  if (!valid8(S, W, H, M, 1, form) || !copies8(q, true))
    return static_cast<int>(cudaErrorInvalidValue);
  Workspace8 w;
  layout8(static_cast<char*>(ws), B, S, W, M, ro, rf, rp, 1, false, &w);
  return static_cast<int>(run_fwd8(q, w, static_cast<bf16*>(y),
                                   static_cast<cudaStream_t>(stream)));
}

// As aiic_text_block_int8_fwd, with dy in, dx (B,S,W) bf16 and the six fp32
// LoRA cotangents out: daoA (W,ro), daoB (ro,W), dafA (W,rf), dafB (rf,M),
// dapA (M,rp), dapB (rp,W); w2_t is not read. n_chunks: the hidden-axis
// chunks of the dfq quantization, M / n_chunks a multiple of 128 in form 0
// (whole K-slices of the stage's fold), of 32 in form 1. Form 0 runs the
// core backward on row 9's two tensor-core passes (dqkv in fp32), form 1 on
// block_core_bwd_kernel.
extern "C" int aiic_text_block_int8_bwd(const void* x, const void* dy, AIIC_INT8_PARAMS,
                                        void* dx, void* daoA, void* daoB, void* dafA, void* dafB,
                                        void* dapA, void* dapB, void* ws, int B, int S, int W,
                                        int H, int M, int ro, int rf, int rp, int n_chunks,
                                        float scaling, float eps, float qconst, int form,
                                        void* stream) {
  using namespace aiic;
  const Int8Args q = AIIC_INT8_ARGS(x, n_chunks);
  if (!valid8(S, W, H, M, n_chunks, form) || !copies8(q, false))
    return static_cast<int>(cudaErrorInvalidValue);
  Workspace8 w;
  layout8(static_cast<char*>(ws), B, S, W, M, ro, rf, rp, n_chunks, true, &w);
  float* g[6] = {static_cast<float*>(daoA), static_cast<float*>(daoB), static_cast<float*>(dafA),
                 static_cast<float*>(dafB), static_cast<float*>(dapA), static_cast<float*>(dapB)};
  return static_cast<int>(run_bwd8(q, w, static_cast<const bf16*>(dy), static_cast<bf16*>(dx), g,
                                   static_cast<cudaStream_t>(stream)));
}

// The int8 product the backward's cotangents run, alone, for the card's
// tests: out (K/ksplit, M, N) int32, slice z = A[:, z ks:(z+1) ks] .
// B[:, z ks:(z+1) ks]^T for A (M,K) and B (N,K) int8. form 0: the wgmma
// stage over the whole depth (ksplit == K, a multiple of 128); form 1: the
// WMMA tile (ksplit a multiple of 32 dividing K). Needs N % 128 == 0.
extern "C" int aiic_int8_matmul_t(const void* A, const void* B, void* out, int M, int N, int K,
                                  int ksplit, int form, void* stream) {
  using namespace aiic;
  const int8_t* a = static_cast<const int8_t*>(A);
  const int8_t* b = static_cast<const int8_t*>(B);
  const EpiSplitStore epi{static_cast<int*>(out), M, N};  // blockIdx.z is 0 on the stage
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (form == 0) {
    if (ksplit != K) return static_cast<int>(cudaErrorInvalidValue);
    return static_cast<int>(launch_wgmma_stage(a, b, M, N, K, epi, st));
  }
  if (form != 1 || N % kBN || ksplit <= 0 || ksplit % kBK || K % ksplit)
    return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(launch_gemm<true>(a, b, M, N, K, epi, st, ksplit));
}

// Blocks per SM of the int8 block's form-0 kernels, into blocks[0..6]: the
// stage with EpiQkv8, EpiFc8 (forward), EpiDfq8, EpiDh2 and the chunked
// dh2 fold (backward); the two tensor-core core-backward passes storing
// fp32. Returns a cudaError_t.
extern "C" int aiic_text_block_int8_occupancy(int* blocks) {
  using namespace aiic;
  const void* kernels[] = {
      reinterpret_cast<const void*>(wgmma_stage_kernel<int8_t, EpiQkv8>),
      reinterpret_cast<const void*>(wgmma_stage_kernel<int8_t, EpiFc8>),
      reinterpret_cast<const void*>(wgmma_stage_kernel<int8_t, EpiDfq8>),
      reinterpret_cast<const void*>(wgmma_stage_kernel<int8_t, EpiDh2>),
      reinterpret_cast<const void*>(wgmma_stage_kernel<int8_t, EpiDh2Fold>)};
  const cudaError_t err = stage_kernel_occupancy(kernels, 5, blocks);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(core_bwd_mma_occupancy<float>(blocks + 5));
}
