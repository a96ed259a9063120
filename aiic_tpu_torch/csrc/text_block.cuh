// The whole training text block with LoRA, forward and backward, for Hopper
// (sm_90a), in fp32 or bf16:
//
//   h1 = LN1(x); qkv = h1 Wqkv + bqkv; a = attention(qkv)
//   y1 = x + a Wo + bo + s (a Ao) Bo
//   h2 = LN2(y1); f = h2 W1 + b1 + s (h2 Af) Bf; u = f sigmoid(1.702 f)
//   y  = y1 + u W2 + b2 + s (u Ap) Bp
//
// Replaces the TPU kernels of aiic_tpu/ops/block_grad.py:
//   aiic_text_block_fwd <- _text_block_fwd_kernel (:322) and
//                          _text_block_fwd_chunk_kernel (:388), via text_block_fwd;
//   aiic_text_block_bwd <- _text_block_bwd_kernel (:198) and
//                          _text_block_bwd_chunk_kernel (:472), via text_block_bwd.
// The chunked bodies split only the MLP hidden axis to fit the TPU's VMEM;
// their math is the unchunked one, so one Hopper kernel pair covers both.
// The plain PyTorch versions are aiic_tpu_torch/ops/block_grad.py::
// text_block_fwd_ref and text_block_bwd_ref.
//
// Each entry point is a sequence of launches on the caller's stream, the
// intermediates kept in one workspace the wrapper allocates (nothing is kept
// between forward and backward: the backward recomputes the forward from x,
// as the TPU kernel does). Rounding contract of the TPU kernels: every
// product casts both operands to the compute dtype T and sums in fp32; LN
// statistics are fp32; the probabilities are normalized before p.V; the
// quick-gelu is fp32 f*sigmoid(1.702 f); the LoRA cotangents are fp32.
//
// Products and where they run:
// - the backbone products (rows x W or M, depth W, 3W or M): in bf16 the WMMA
//   tensor-core GEMM of common.cuh (kTransB for dy.W^T); in fp32 a SIMT GEMM
//   of 128x128 tiles (sgemm_kernel), because TF32 keeps 10 bits of mantissa
//   and the fp32 bar is 1e-5;
// - the rank-r down-projections (a.Ao, dy.Bp^T, ...): a SIMT GEMM at 64x16
//   tiles with the depth split in chunks of kDepthChunk, each chunk's partial
//   in its own slice, then one pass that sums the slices in order and stores;
//   the rank-r up-projections (.Bo, .Ap^T, ...) run inside the epilogues;
// - the six LoRA cotangents, sums over all B*S rows: the same split product
//   with the row axis as its depth, in chunks of kRowChunk rows. No atomics,
//   so a run repeats bit for bit;
// - the attention core: one block per (image, head), one thread per query
//   row, q/k/v (and g in the backward) and the S x S probabilities in shared
//   memory (the backward's opt-in is 102,564 B at S=77 in fp32).
//
// What bounds it on the H100: at B=256 text rows (S=77, W=512, M=2048, H=8,
// rank 16) the forward does 131.0 GFLOP and the backward 227.3 (it recomputes
// the forward less its last product, then four input-gradient products, the
// core backward and the rank-r cotangents): 1.96 / 3.40 ms at the 66.9
// TFLOP/s of fp32 without tensor cores, 0.132 / 0.230 ms at the 989 TFLOP/s of
// bf16. Both are bound by operations.
//
// What the simple design gives up: the fp32 GEMM is a shared-memory tile with
// 8x8 register blocking and one stage of register prefetch, the WMMA GEMM has
// no TMA/wgmma pipeline, the core runs scalar FMAs, and every intermediate
// makes a round trip through device memory between launches.
//
// The code is this header; text_block_f32.cu and text_block_bf16.cu
// instantiate it for one compute type each, so that nvcc builds the two
// beside each other, and text_block.cu holds the C entry points.

#pragma once

#include <stdint.h>

#include <type_traits>
#include <utility>

#include "common.cuh"

namespace aiic {

// One call's operands: the entry points fill it in, the per-type files take it.
struct BlockArgs {
  const void* x;
  const float* mask;
  const float *ln1s, *ln1b, *ln2s, *ln2b;
  const void* wqkv;
  const float* bqkv;
  const void* wo;
  const float* bo;
  const void* w1;
  const float* b1;
  const void* w2;
  const float* b2;
  const void *aoA, *aoB, *afA, *afB, *apA, *apB;
  int B, S, W, H, M, ro, rf, rp;
  float s, eps, qconst;
};

// The workspace, carved from one buffer at 256-byte offsets (layout()).
struct Workspace {
  void *h1, *qkv, *a, *a_ao, *h2, *h2_af, *u, *u_ap;  // T
  float *y1, *f;
  void *t_p, *dfq, *t_f, *dy1c, *t_o, *da, *dqkv;  // T
  float *dh2, *dy1, *dh1, *part;
};

namespace {

constexpr float kGeluK = 1.702f;
constexpr int kRowChunk = 256;        // rows per partial of a LoRA cotangent
constexpr int kDepthChunk = 256;      // depth per partial of a rank-r down-projection
constexpr int kBlockCoreThreads = 128;  // one thread per query row: S <= 128

template <typename T> __device__ __forceinline__ void store_as(T* p, float v);
template <> __device__ __forceinline__ void store_as<float>(float* p, float v) { *p = v; }
template <> __device__ __forceinline__ void store_as<bf16>(bf16* p, float v) {
  *p = __float2bfloat16_rn(v);
}

// sigmoid(1.702 f) in fp32, as 1 / (1 + exp(-y)).
__device__ __forceinline__ float sigmoid_gelu(float f) {
  return 1.0f / (1.0f + expf(-(kGeluK * f)));
}

// ---------------------------------------------------------------------------
// SIMT GEMM with operands rounded to the compute dtype
// ---------------------------------------------------------------------------

// C (Mo x No) = A' (Mo x K) . B' (K x No) in fp32 on the CUDA cores, with
// A'(m, k) = A[m*sam + k*sak] and B'(k, n) = B[k*sbk + n*sbn], so either
// operand may be read transposed. Both are rounded to TR on load. Tile
// BM x BN x BK, 256 threads as 16 x 16, each BM/16 x BN/16 outputs.
// blockIdx.z takes the K range [z*kc, (z+1)*kc).
template <int BM, int BN, int BK, typename TR, typename TA, typename TB, typename Epi>
__global__ void __launch_bounds__(256)
simt_gemm_kernel(const TA* __restrict__ A, long long sam, long long sak,
                 const TB* __restrict__ B, long long sbk, long long sbn, int Mo, int No, int K,
                 int kc, Epi epi) {
  constexpr int TM = BM / 16, TN = BN / 16;
  __shared__ float As[BK][BM];
  __shared__ float Bs[BK][BN];
  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;
  const int kb = blockIdx.z * kc, ke = min(K, kb + kc);
  const bool a_kfast = sak == 1, b_nfast = sbn == 1;  // which index runs along memory
  float acc[TM][TN];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = 0.f;

  for (int k0 = kb; k0 < ke; k0 += BK) {
    for (int i = tid; i < BM * BK; i += 256) {
      const int m = a_kfast ? i / BK : i % BM, k = a_kfast ? i % BK : i / BM;
      const int gm = m0 + m, gk = k0 + k;
      float v = 0.f;
      if (gm < Mo && gk < ke)
        v = round_as<TR>(to_f32(A[static_cast<long long>(gm) * sam + static_cast<long long>(gk) * sak]));
      As[k][m] = v;
    }
    for (int i = tid; i < BK * BN; i += 256) {
      const int n = b_nfast ? i % BN : i / BK, k = b_nfast ? i / BN : i % BK;
      const int gn = n0 + n, gk = k0 + k;
      float v = 0.f;
      if (gn < No && gk < ke)
        v = round_as<TR>(to_f32(B[static_cast<long long>(gk) * sbk + static_cast<long long>(gn) * sbn]));
      Bs[k][n] = v;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < BK; ++kk) {
      float a[TM], b[TN];
#pragma unroll
      for (int i = 0; i < TM; ++i) a[i] = As[kk][ty * TM + i];
#pragma unroll
      for (int j = 0; j < TN; ++j) b[j] = Bs[kk][tx * TN + j];
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < TN; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      const int m = m0 + ty * TM + i, n = n0 + tx * TN + j;
      if (m < Mo && n < No) epi(m, n, acc[i][j]);
    }
}

template <int BM, int BN, int BK, typename TR, typename TA, typename TB, typename Epi>
cudaError_t launch_simt(const TA* A, long long sam, long long sak, const TB* B, long long sbk,
                        long long sbn, int Mo, int No, int K, int kc, Epi epi, cudaStream_t st) {
  const dim3 grid((No + BN - 1) / BN, (Mo + BM - 1) / BM, (K + kc - 1) / kc);
  simt_gemm_kernel<BM, BN, BK, TR, TA, TB, Epi>
      <<<grid, 256, 0, st>>>(A, sam, sak, B, sbk, sbn, Mo, No, K, kc, epi);
  return cudaGetLastError();
}

// The rank-r term s * sum_j lo[r, j] F(j, n), F(j, n) = F[j*fj + n*fn], both
// in T: the up-projection of a LoRA delta (forward) or of its cotangent
// (backward, F transposed). rank 0 gives 0.
template <typename T> struct LoRATerm {
  const T* lo;
  const T* F;
  int rank;
  int fj, fn;
  float s;
  __device__ __forceinline__ float operator()(int r, int n) const {
    float acc = 0.f;
    const T* l = lo + static_cast<size_t>(r) * rank;
    for (int j = 0; j < rank; ++j)
      acc = fmaf(to_f32(l[j]), to_f32(F[static_cast<size_t>(j) * fj + static_cast<size_t>(n) * fn]), acc);
    return s * acc;
  }
};

// The fp32 backbone product C (M x N) = A (M x K) . B on the CUDA cores, B
// stored (K, N), or (N, K) and read transposed (kTransB). Block tile 128x128,
// depth 8 per stage, 256 threads each owning an 8x8 patch as four 4x4
// quadrants (rows ty*4 and 64 + ty*4, columns tx*4 and 64 + tx*4), so every
// shared-memory read is a float4 that the warp's two row groups share. A (and
// a transposed B) is kept k-major in shared memory, rows padded by 4 floats so
// that the transposing stores do not collide on a bank; the next stage's
// tiles are read into registers while the current one is multiplied. A rank-r
// term s (lo . F) joins the same sums after the last stage, each thread
// reading its 8 rows of lo and 8 columns of F once per rank (in an epilogue it
// would be read again for every output): in fp32 only the order of the sums
// changes. Needs N % 128 == 0, K % 8 == 0 and 16-byte aligned rows; rows past
// M read as 0 and are never stored.
constexpr int kSgBM = 128, kSgBN = 128, kSgBK = 8, kSgPad = 4;

template <bool kTransB, typename Epi>
__global__ void __launch_bounds__(256)
sgemm_kernel(const float* __restrict__ A, const float* __restrict__ B, int M, int N, int K,
             LoRATerm<float> lora, Epi epi) {
  __shared__ __align__(16) float As[kSgBK][kSgBM + kSgPad];
  __shared__ __align__(16) float Bs[kSgBK][kSgBN + kSgPad];
  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const int m0 = blockIdx.y * kSgBM, n0 = blockIdx.x * kSgBN;
  // loaders: a row (tid / 2) and 4 depths ((tid % 2) * 4) of A, the same of a
  // transposed B; else a depth (tid / 32) and 4 columns ((tid % 32) * 4) of B
  const int lr = tid >> 1, lk = (tid & 1) * 4, bk = tid >> 5, bn = (tid & 31) * 4;
  const bool a_live = m0 + lr < M;
  const float* a_src = A + static_cast<size_t>(a_live ? m0 + lr : 0) * K + lk;
  const float* b_src = kTransB ? B + static_cast<size_t>(n0 + lr) * K + lk
                               : B + static_cast<size_t>(bk) * N + n0 + bn;
  const float4 zero = make_float4(0.f, 0.f, 0.f, 0.f);
  float4 ra = a_live ? *reinterpret_cast<const float4*>(a_src) : zero;
  float4 rb = *reinterpret_cast<const float4*>(b_src);
  float acc[8][8];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;

  for (int k0 = 0; k0 < K; k0 += kSgBK) {
    As[lk + 0][lr] = ra.x;
    As[lk + 1][lr] = ra.y;
    As[lk + 2][lr] = ra.z;
    As[lk + 3][lr] = ra.w;
    if constexpr (kTransB) {
      Bs[lk + 0][lr] = rb.x;
      Bs[lk + 1][lr] = rb.y;
      Bs[lk + 2][lr] = rb.z;
      Bs[lk + 3][lr] = rb.w;
    } else {
      *reinterpret_cast<float4*>(&Bs[bk][bn]) = rb;
    }
    __syncthreads();
    if (k0 + kSgBK < K) {  // the next stage into registers
      ra = a_live ? *reinterpret_cast<const float4*>(a_src + k0 + kSgBK) : zero;
      rb = *reinterpret_cast<const float4*>(
          kTransB ? b_src + k0 + kSgBK : b_src + static_cast<size_t>(k0 + kSgBK) * N);
    }
#pragma unroll
    for (int kk = 0; kk < kSgBK; ++kk) {
      const float4 a0 = *reinterpret_cast<const float4*>(&As[kk][ty * 4]);
      const float4 a1 = *reinterpret_cast<const float4*>(&As[kk][64 + ty * 4]);
      const float4 b0 = *reinterpret_cast<const float4*>(&Bs[kk][tx * 4]);
      const float4 b1 = *reinterpret_cast<const float4*>(&Bs[kk][64 + tx * 4]);
      const float a[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
      const float b[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
    __syncthreads();
  }
  int rows[8], cols[8];
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    rows[i] = m0 + (i < 4 ? ty * 4 + i : 64 + ty * 4 + i - 4);
    cols[i] = n0 + (i < 4 ? tx * 4 + i : 64 + tx * 4 + i - 4);
  }
  for (int j = 0; j < lora.rank; ++j) {
    float la[8], fb[8];
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      la[i] = rows[i] < M ? lora.s * lora.lo[static_cast<size_t>(rows[i]) * lora.rank + j] : 0.f;
      fb[i] = lora.F[static_cast<size_t>(j) * lora.fj + static_cast<size_t>(cols[i]) * lora.fn];
    }
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int jj = 0; jj < 8; ++jj) acc[i][jj] = fmaf(la[i], fb[jj], acc[i][jj]);
  }
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    if (rows[i] >= M) continue;
#pragma unroll
    for (int j = 0; j < 8; ++j) epi(rows[i], cols[j], acc[i][j]);
  }
}

// Whether an epilogue carries a rank-r term (a member ``lora``).
template <typename E, typename = void> struct HasLoRA : std::false_type {};
template <typename E>
struct HasLoRA<E, std::void_t<decltype(std::declval<E&>().lora)>> : std::true_type {};

// A backbone product C (rows x N) = A (rows x K) . W, or . W^T for a weight
// stored (N, K) (kTransW): WMMA in bf16 (the epilogue adds the rank-r term),
// the SIMT tile above in fp32 (the sums take it).
template <bool kTransW, typename T, typename Epi>
cudaError_t big_gemm(const T* A, const T* W, int rows, int N, int K, Epi epi, cudaStream_t st) {
  if constexpr (std::is_same<T, bf16>::value) {
    return launch_gemm<kTransW>(A, W, rows, N, K, epi, st);
  } else {
    LoRATerm<float> lora{nullptr, nullptr, 0, 0, 0, 0.f};
    if constexpr (HasLoRA<Epi>::value) {  // the term moves from the epilogue into the sums
      lora = epi.lora;
      epi.lora.rank = 0;
    }
    const dim3 grid(N / kSgBN, (rows + kSgBM - 1) / kSgBM);
    sgemm_kernel<kTransW, Epi><<<grid, 256, 0, st>>>(A, W, rows, N, K, lora, epi);
    return cudaGetLastError();
  }
}

struct EpiPartial {  // one K-chunk's partial sum, in slice blockIdx.z
  float* part;
  int Mo, No;
  __device__ void operator()(int r, int n, float acc) const {
    part[(static_cast<size_t>(blockIdx.z) * Mo + r) * No + n] = acc;
  }
};

// epi(p, j, sum of the partial slices in order) for each (p, j) of P x R.
template <typename Epi>
__global__ void sum_partials_kernel(const float* __restrict__ part, int splits, int P, int R,
                                    Epi epi) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= P * R) return;
  float v = 0.f;
  for (int z = 0; z < splits; ++z) v += part[static_cast<size_t>(z) * P * R + i];
  epi(i / R, i % R, v);
}

// A product with a rank-r side, (Mo x No) = A' (Mo x K) . B' (K x No): the SIMT
// tile at 64x16. Its depth (W or M for a down-projection, B*S rows for a LoRA
// cotangent) is split in chunks of kc, one block per chunk and tile writing
// its partial into its own slice of part, and a second pass adds the slices in
// order and applies epi: enough blocks to keep the loads in flight, and no
// atomics, so a run repeats bit for bit.
template <typename T, typename TA, typename TB, typename Epi>
cudaError_t narrow_gemm(const TA* A, long long sam, long long sak, const TB* B, long long sbk,
                        long long sbn, int Mo, int No, int K, int kc, float* part, Epi epi,
                        cudaStream_t st) {
  AIIC_CHECK((launch_simt<64, 16, 16, T>(A, sam, sak, B, sbk, sbn, Mo, No, K, kc,
                                          EpiPartial{part, Mo, No}, st)));
  sum_partials_kernel<<<(Mo * No + 255) / 256, 256, 0, st>>>(part, (K + kc - 1) / kc, Mo, No,
                                                              epi);
  return cudaGetLastError();
}

struct EpiScaled {  // out = s * v, (P x R) or stored (R x P)
  float* out;
  int P, R;
  float s;
  bool transposed;
  __device__ void operator()(int p, int j, float v) const {
    out[transposed ? static_cast<size_t>(j) * P + p : static_cast<size_t>(p) * R + j] = s * v;
  }
};

// out = s * X^T Y for X (rows, P) and Y (rows, R), a sum over the row axis:
// (P, R), or (R, P) when transposed. Both operands rounded to T.
template <typename T, typename TX, typename TY>
cudaError_t rows_reduce(const TX* X, int P, const TY* Y, int R, int rows, float s, float* part,
                        float* out, bool transposed, cudaStream_t st) {
  return narrow_gemm<T>(X, 1, P, Y, R, 1, P, R, rows, kRowChunk, part,
                        EpiScaled{out, P, R, s, transposed}, st);
}

// ---------------------------------------------------------------------------
// Epilogues
// ---------------------------------------------------------------------------

template <typename T> struct EpiStore {  // out = T(acc)
  T* out;
  int n_cols;
  __device__ void operator()(int r, int n, float acc) const {
    store_as<T>(out + static_cast<size_t>(r) * n_cols + n, acc);
  }
};

template <typename T> struct EpiQkv {  // qkv = T(acc + bqkv)
  const float* b;
  T* out;
  int n_cols;
  __device__ void operator()(int r, int n, float acc) const {
    store_as<T>(out + static_cast<size_t>(r) * n_cols + n, acc + b[n]);
  }
};

template <typename T> struct EpiY1 {  // y1 = x + ((acc + bo) + s (a Ao) Bo), fp32
  const float* b;
  LoRATerm<T> lora;
  const T* x;
  float* y1;
  int n_cols;
  __device__ void operator()(int r, int n, float acc) const {
    const size_t i = static_cast<size_t>(r) * n_cols + n;
    float v = acc + b[n];
    v = v + lora(r, n);
    y1[i] = to_f32(x[i]) + v;
  }
};

template <typename T> struct EpiFc {  // f = (acc + b1) + s (h2 Af) Bf; u = T(f sigmoid(1.702 f))
  const float* b;
  LoRATerm<T> lora;
  float* f_out;  // kept for the backward, or null
  T* u;
  int n_cols;
  __device__ void operator()(int r, int n, float acc) const {
    const size_t i = static_cast<size_t>(r) * n_cols + n;
    float f = acc + b[n];
    f = f + lora(r, n);
    if (f_out) f_out[i] = f;
    store_as<T>(u + i, f * sigmoid_gelu(f));
  }
};

template <typename T> struct EpiY {  // y = T(y1 + ((acc + b2) + s (u Ap) Bp))
  const float* b;
  LoRATerm<T> lora;
  const float* y1;
  T* y;
  int n_cols;
  __device__ void operator()(int r, int n, float acc) const {
    const size_t i = static_cast<size_t>(r) * n_cols + n;
    float mo = acc + b[n];
    mo = mo + lora(r, n);
    store_as<T>(y + i, y1[i] + mo);
  }
};

template <typename T> struct EpiDfq {  // du = acc + s t_p Ap^T; dfq = T(du gelu'(f))
  LoRATerm<T> lora;
  const float* f;
  T* dfq;
  int n_cols;
  __device__ void operator()(int r, int n, float acc) const {
    const size_t i = static_cast<size_t>(r) * n_cols + n;
    const float du = acc + lora(r, n);
    const float fv = f[i];
    const float sg = sigmoid_gelu(fv);
    const float d = sg + kGeluK * fv * sg * (1.0f - sg);
    store_as<T>(dfq + i, du * d);
  }
};

template <typename T, typename TO> struct EpiLoRAOut {  // out = TO(acc + s lo F^T)
  LoRATerm<T> lora;
  TO* out;
  int n_cols;
  __device__ void operator()(int r, int n, float acc) const {
    store_as<TO>(out + static_cast<size_t>(r) * n_cols + n, acc + lora(r, n));
  }
};

// ---------------------------------------------------------------------------
// Row passes: LN forward, LN backward
// ---------------------------------------------------------------------------

// out = T(LN(x)) per row, fp32 statistics (x is the block input or fp32 y1).
template <typename TIn, typename T>
__global__ void __launch_bounds__(kRowThreads)
ln_fwd_rows_kernel(const TIn* __restrict__ x, const float* __restrict__ ln_s,
                   const float* __restrict__ ln_b, T* __restrict__ out, int W, float eps) {
  extern __shared__ float h[];
  __shared__ float red[kRowThreads / 32 + 1];
  const size_t row = blockIdx.x;
  load_row<true>(x + row * W, ln_s, ln_b, h, red, W, eps);
  for (int i = threadIdx.x; i < W; i += kRowThreads) store_as<T>(out + row * W + i, h[i]);
}

// out = dres + inv ((g - mean g) - xhat mean(g xhat)), g = dh * ln_s, with
// xhat and inv recomputed from the LN input xin; out2 (if given) gets the
// same value rounded to T2.
template <typename TIn, typename TRes, typename TOut, typename T2>
__global__ void __launch_bounds__(kRowThreads)
ln_bwd_rows_kernel(const TIn* __restrict__ xin, const float* __restrict__ dh,
                   const float* __restrict__ ln_s, const TRes* __restrict__ dres,
                   TOut* __restrict__ out, T2* __restrict__ out2, int W, float eps) {
  extern __shared__ float xh[];
  __shared__ float red[kRowThreads / 32 + 1];
  const size_t row = blockIdx.x;
  const TIn* xr = xin + row * W;
  const float* dr = dh + row * W;
  float part = 0.f;
  for (int i = threadIdx.x; i < W; i += kRowThreads) {
    xh[i] = to_f32(xr[i]);
    part += xh[i];
  }
  const float mean = block_reduce(part, false, red) / static_cast<float>(W);
  __syncthreads();
  float sq = 0.f;
  for (int i = threadIdx.x; i < W; i += kRowThreads) {
    const float d = xh[i] - mean;
    sq += d * d;
  }
  const float var = block_reduce(sq, false, red) / static_cast<float>(W);
  __syncthreads();
  const float inv = 1.0f / sqrtf(var + eps);
  float gs = 0.f, gxs = 0.f;
  for (int i = threadIdx.x; i < W; i += kRowThreads) {
    xh[i] = (xh[i] - mean) * inv;
    const float g = dr[i] * ln_s[i];
    gs += g;
    gxs += g * xh[i];
  }
  const float gm = block_reduce(gs, false, red) / static_cast<float>(W);
  __syncthreads();
  const float gx = block_reduce(gxs, false, red) / static_cast<float>(W);
  __syncthreads();
  for (int i = threadIdx.x; i < W; i += kRowThreads) {
    const float g = dr[i] * ln_s[i];
    const float v = to_f32(dres[row * W + i]) + inv * ((g - gm) - xh[i] * gx);
    store_as<TOut>(out + row * W + i, v);
    if (out2) store_as<T2>(out2 + row * W + i, v);
  }
}

template <typename TIn, typename T>
cudaError_t launch_ln_fwd(const TIn* x, const float* s, const float* b, T* out, int rows, int W,
                          float eps, cudaStream_t st) {
  ln_fwd_rows_kernel<TIn, T><<<rows, kRowThreads, W * sizeof(float), st>>>(x, s, b, out, W, eps);
  return cudaGetLastError();
}

template <typename TIn, typename TRes, typename TOut, typename T2>
cudaError_t launch_ln_bwd(const TIn* xin, const float* dh, const float* s, const TRes* dres,
                          TOut* out, T2* out2, int rows, int W, float eps, cudaStream_t st) {
  ln_bwd_rows_kernel<TIn, TRes, TOut, T2>
      <<<rows, kRowThreads, W * sizeof(float), st>>>(xin, dh, s, dres, out, out2, W, eps);
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// Attention core: one block per (head, image), one thread per query row
// ---------------------------------------------------------------------------

// Row i of the normalized probabilities into prow: s_j = q . k_j (q already
// scaled and rounded), + mask*log2 e, p = exp2(min(s, 70 log2 e)),
// p *= 1 / max(sum p, 1e-38).
__device__ __forceinline__ void probs_row(const float* q, const float* Ks, const float* mrow,
                                          float* prow, int S) {
  float l = 0.f;
  for (int j = 0; j < S; ++j) {
    const float* kr = Ks + j * kHeadDim;
    float s = 0.f;
#pragma unroll
    for (int d = 0; d < kHeadDim; ++d) s = fmaf(q[d], kr[d], s);
    s = s + mrow[j] * kLog2e;
    const float p = exp2f(fminf(s, kExp2Clamp));
    prow[j] = p;
    l += p;
  }
  const float inv = 1.0f / fmaxf(l, 1e-38f);
  for (int j = 0; j < S; ++j) prow[j] = prow[j] * inv;
}

// a = T(T(p) . v) per row. Dynamic shared memory: K, V (S x 64) and P (S x S), fp32.
template <typename T>
__global__ void __launch_bounds__(kBlockCoreThreads)
block_core_fwd_kernel(const T* __restrict__ qkv, const float* __restrict__ mask,
                      T* __restrict__ a, int S, int W, float qconst) {
  extern __shared__ float sm[];
  float* Ks = sm;
  float* Vs = Ks + S * kHeadDim;
  float* P = Vs + S * kHeadDim;
  const int h = blockIdx.x;
  const size_t row0 = static_cast<size_t>(blockIdx.y) * S, ld = 3 * static_cast<size_t>(W);
  for (int idx = threadIdx.x; idx < S * kHeadDim; idx += kBlockCoreThreads) {
    const T* src = qkv + (row0 + idx / kHeadDim) * ld + h * kHeadDim + idx % kHeadDim;
    Ks[idx] = to_f32(src[W]);
    Vs[idx] = to_f32(src[2 * W]);
  }
  __syncthreads();
  const int i = threadIdx.x;
  if (i >= S) return;
  float q[kHeadDim], o[kHeadDim];
  const T* qr = qkv + (row0 + i) * ld + h * kHeadDim;
#pragma unroll
  for (int d = 0; d < kHeadDim; ++d) {
    q[d] = round_as<T>(to_f32(qr[d]) * qconst);
    o[d] = 0.f;
  }
  float* prow = P + i * S;
  probs_row(q, Ks, mask + static_cast<size_t>(i) * S, prow, S);
  for (int j = 0; j < S; ++j) {
    const float pj = round_as<T>(prow[j]);
    const float* vr = Vs + j * kHeadDim;
#pragma unroll
    for (int d = 0; d < kHeadDim; ++d) o[d] = fmaf(pj, vr[d], o[d]);
  }
  T* dst = a + (row0 + i) * W + h * kHeadDim;
#pragma unroll
  for (int d = 0; d < kHeadDim; ++d) store_as<T>(dst + d, o[d]);
}

// dqkv = TO([dq | dk | dv]) of one head from qkv and g = da, the
// probabilities recomputed as in the forward:
//   dv = T(p)^T g;  dp = g v^T;  ds = T((p (dp - rowsum(dp p))) scale);
//   dq = ds k;  dk = ds^T q.
// TO is T where dqkv only feeds a product that rounds it to T, fp32 where it
// feeds a row quantizer (the int8 block).
// Dynamic shared memory: Q, K, V, G (S x 64) and P (S x S, then ds), fp32.
template <typename T, typename TO>
__global__ void __launch_bounds__(kBlockCoreThreads)
block_core_bwd_kernel(const T* __restrict__ qkv, const T* __restrict__ da,
                      const float* __restrict__ mask, TO* __restrict__ dqkv, int S, int W,
                      float qconst, float scale) {
  extern __shared__ float sm[];
  float* Qs = sm;
  float* Ks = Qs + S * kHeadDim;
  float* Vs = Ks + S * kHeadDim;
  float* Gs = Vs + S * kHeadDim;
  float* P = Gs + S * kHeadDim;
  const int h = blockIdx.x;
  const size_t row0 = static_cast<size_t>(blockIdx.y) * S, ld = 3 * static_cast<size_t>(W);
  for (int idx = threadIdx.x; idx < S * kHeadDim; idx += kBlockCoreThreads) {
    const size_t r = row0 + idx / kHeadDim;
    const int c = h * kHeadDim + idx % kHeadDim;
    const T* src = qkv + r * ld + c;
    Qs[idx] = to_f32(src[0]);
    Ks[idx] = to_f32(src[W]);
    Vs[idx] = to_f32(src[2 * W]);
    Gs[idx] = to_f32(da[r * W + c]);
  }
  __syncthreads();
  const int i = threadIdx.x;
  const bool live = i < S;
  float acc[kHeadDim];
  if (live) {
#pragma unroll
    for (int d = 0; d < kHeadDim; ++d) acc[d] = round_as<T>(Qs[i * kHeadDim + d] * qconst);
    probs_row(acc, Ks, mask + static_cast<size_t>(i) * S, P + i * S, S);
  }
  __syncthreads();
  TO* out = dqkv + (row0 + i) * ld + h * kHeadDim;
  if (live) {  // dv for key row i
#pragma unroll
    for (int d = 0; d < kHeadDim; ++d) acc[d] = 0.f;
    for (int r = 0; r < S; ++r) {
      const float pr = round_as<T>(P[r * S + i]);
      const float* gr = Gs + r * kHeadDim;
#pragma unroll
      for (int d = 0; d < kHeadDim; ++d) acc[d] = fmaf(pr, gr[d], acc[d]);
    }
#pragma unroll
    for (int d = 0; d < kHeadDim; ++d) store_as<TO>(out + 2 * W + d, acc[d]);
  }
  __syncthreads();  // every column of P is read; row i may now become ds
  if (live) {
    // g row i into registers: read from shared memory in the loops below,
    // the 64-float row stride would put all 32 lanes on one bank.
#pragma unroll
    for (int d = 0; d < kHeadDim; ++d) acc[d] = Gs[i * kHeadDim + d];
    float* prow = P + i * S;
    float rs = 0.f;
    for (int j = 0; j < S; ++j) {
      const float* vr = Vs + j * kHeadDim;
      float dp = 0.f;
#pragma unroll
      for (int d = 0; d < kHeadDim; ++d) dp = fmaf(acc[d], vr[d], dp);
      rs += dp * prow[j];
    }
    for (int j = 0; j < S; ++j) {  // dp again, in the same order
      const float* vr = Vs + j * kHeadDim;
      float dp = 0.f;
#pragma unroll
      for (int d = 0; d < kHeadDim; ++d) dp = fmaf(acc[d], vr[d], dp);
      prow[j] = round_as<T>((prow[j] * (dp - rs)) * scale);
    }
  }
  __syncthreads();
  if (!live) return;
#pragma unroll
  for (int d = 0; d < kHeadDim; ++d) acc[d] = 0.f;
  for (int j = 0; j < S; ++j) {  // dq = ds k
    const float ds = P[i * S + j];
    const float* kr = Ks + j * kHeadDim;
#pragma unroll
    for (int d = 0; d < kHeadDim; ++d) acc[d] = fmaf(ds, kr[d], acc[d]);
  }
#pragma unroll
  for (int d = 0; d < kHeadDim; ++d) store_as<TO>(out + d, acc[d]);
#pragma unroll
  for (int d = 0; d < kHeadDim; ++d) acc[d] = 0.f;
  for (int r = 0; r < S; ++r) {  // dk = ds^T q
    const float ds = P[r * S + i];
    const float* qr = Qs + r * kHeadDim;
#pragma unroll
    for (int d = 0; d < kHeadDim; ++d) acc[d] = fmaf(ds, qr[d], acc[d]);
  }
#pragma unroll
  for (int d = 0; d < kHeadDim; ++d) store_as<TO>(out + W + d, acc[d]);
}

template <typename T>
cudaError_t launch_core_fwd(const T* qkv, const float* mask, T* a, int B, int S, int W, int H,
                            float qconst, cudaStream_t st) {
  const int smem = (2 * S * kHeadDim + S * S) * static_cast<int>(sizeof(float));
  AIIC_CHECK(cudaFuncSetAttribute(block_core_fwd_kernel<T>,
                                  cudaFuncAttributeMaxDynamicSharedMemorySize, smem));
  block_core_fwd_kernel<T><<<dim3(H, B), kBlockCoreThreads, smem, st>>>(qkv, mask, a, S, W, qconst);
  return cudaGetLastError();
}

template <typename T, typename TO>
cudaError_t launch_core_bwd(const T* qkv, const T* da, const float* mask, TO* dqkv, int B, int S,
                            int W, int H, float qconst, cudaStream_t st) {
  const int smem = (4 * S * kHeadDim + S * S) * static_cast<int>(sizeof(float));
  AIIC_CHECK(cudaFuncSetAttribute(block_core_bwd_kernel<T, TO>,
                                  cudaFuncAttributeMaxDynamicSharedMemorySize, smem));
  const float scale = 1.0f / sqrtf(static_cast<float>(kHeadDim));  // dim ** -0.5, exact for 64
  block_core_bwd_kernel<T, TO><<<dim3(H, B), kBlockCoreThreads, smem, st>>>(
      qkv, da, mask, dqkv, S, W, qconst, scale);
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// The block
// ---------------------------------------------------------------------------


size_t layout(char* base, int B, int S, int W, int M, int ro, int rf, int rp, int itemsize,
              bool backward, Workspace* w) {
  const size_t rows = static_cast<size_t>(B) * S;
  size_t off = 0;
  auto take = [&](size_t bytes) -> void* {
    void* p = base ? base + off : nullptr;
    off += (bytes + 255) / 256 * 256;
    return p;
  };
  const size_t t = itemsize;
  *w = Workspace{};
  w->h1 = take(rows * W * t);
  w->qkv = take(rows * 3 * W * t);
  w->a = take(rows * W * t);
  w->a_ao = take(rows * ro * t);
  w->h2 = take(rows * W * t);
  w->h2_af = take(rows * rf * t);
  w->u = take(rows * M * t);
  w->u_ap = take(rows * rp * t);
  w->y1 = static_cast<float*>(take(rows * W * 4));
  // partial sums of the split rank-r products: the down-projections
  // (depth W or M in kDepthChunk slices) and, in the backward, the LoRA
  // cotangents (depth rows in kRowChunk slices)
  const size_t rmax = ro > rf ? (ro > rp ? ro : rp) : (rf > rp ? rf : rp);
  const size_t wide = M > W ? M : W;
  const size_t down = (wide + kDepthChunk - 1) / kDepthChunk * rows * rmax;
  const size_t cot = (rows + kRowChunk - 1) / kRowChunk * wide * rmax;
  w->part = static_cast<float*>(take((backward && cot > down ? cot : down) * 4));
  if (backward) {
    w->f = static_cast<float*>(take(rows * M * 4));
    w->t_p = take(rows * rp * t);
    w->dfq = take(rows * M * t);
    w->t_f = take(rows * rf * t);
    w->dy1c = take(rows * W * t);
    w->t_o = take(rows * ro * t);
    w->da = take(rows * W * t);
    w->dqkv = take(rows * 3 * W * t);
    w->dh2 = static_cast<float*>(take(rows * W * 4));
    w->dy1 = static_cast<float*>(take(rows * W * 4));
    w->dh1 = static_cast<float*>(take(rows * W * 4));
  }
  return off;
}

// LN1 -> QKV -> core -> out-projection (+LoRA, residual) -> LN2 -> c_fc
// (+LoRA, gelu) and the rank-r down-projections; f is kept when f_keep.
template <typename T>
cudaError_t forward_stages(const BlockArgs& p, const Workspace& w, float* f_keep, cudaStream_t st) {
  const int rows = p.B * p.S, W = p.W, M = p.M;
  auto c = [](const void* q) { return static_cast<const T*>(q); };
  auto m = [](void* q) { return static_cast<T*>(q); };
  const T* x = c(p.x);
  AIIC_CHECK(launch_ln_fwd(x, p.ln1s, p.ln1b, m(w.h1), rows, W, p.eps, st));
  AIIC_CHECK(big_gemm<false>(c(w.h1), c(p.wqkv), rows, 3 * W, W,
                             EpiQkv<T>{p.bqkv, m(w.qkv), 3 * W}, st));
  AIIC_CHECK(launch_core_fwd(c(w.qkv), p.mask, m(w.a), p.B, p.S, W, p.H, p.qconst, st));
  AIIC_CHECK(narrow_gemm<T>(c(w.a), W, 1, c(p.aoA), p.ro, 1, rows, p.ro, W, kDepthChunk,
                            w.part, EpiStore<T>{m(w.a_ao), p.ro}, st));
  AIIC_CHECK(big_gemm<false>(c(w.a), c(p.wo), rows, W, W,
                             EpiY1<T>{p.bo, LoRATerm<T>{c(w.a_ao), c(p.aoB), p.ro, W, 1, p.s},
                                      x, w.y1, W}, st));
  AIIC_CHECK(launch_ln_fwd(static_cast<const float*>(w.y1), p.ln2s, p.ln2b, m(w.h2), rows, W,
                           p.eps, st));
  AIIC_CHECK(narrow_gemm<T>(c(w.h2), W, 1, c(p.afA), p.rf, 1, rows, p.rf, W, kDepthChunk,
                            w.part, EpiStore<T>{m(w.h2_af), p.rf}, st));
  AIIC_CHECK(big_gemm<false>(c(w.h2), c(p.w1), rows, M, W,
                             EpiFc<T>{p.b1, LoRATerm<T>{c(w.h2_af), c(p.afB), p.rf, M, 1, p.s},
                                      f_keep, m(w.u), M}, st));
  AIIC_CHECK(narrow_gemm<T>(c(w.u), M, 1, c(p.apA), p.rp, 1, rows, p.rp, M, kDepthChunk,
                            w.part, EpiStore<T>{m(w.u_ap), p.rp}, st));
  return cudaSuccess;
}

template <typename T>
cudaError_t run_fwd(const BlockArgs& p, const Workspace& w, void* y, cudaStream_t st) {
  AIIC_CHECK(forward_stages<T>(p, w, nullptr, st));
  const int rows = p.B * p.S;
  return big_gemm<false>(
      static_cast<const T*>(w.u), static_cast<const T*>(p.w2), rows, p.W, p.M,
      EpiY<T>{p.b2, LoRATerm<T>{static_cast<const T*>(w.u_ap), static_cast<const T*>(p.apB), p.rp,
                                p.W, 1, p.s},
              w.y1, static_cast<T*>(y), p.W},
      st);
}

// grads: d(out_proj A, B), d(c_fc A, B), d(c_proj A, B), fp32.
template <typename T>
cudaError_t run_bwd(const BlockArgs& p, const Workspace& w, const void* dy_, void* dx,
                    float* const* g, cudaStream_t st) {
  const int rows = p.B * p.S, W = p.W, M = p.M;
  auto c = [](const void* q) { return static_cast<const T*>(q); };
  auto m = [](void* q) { return static_cast<T*>(q); };
  const T* dy = c(dy_);
  AIIC_CHECK(forward_stages<T>(p, w, w.f, st));

  // MLP half: y = y1 + u W2 + b2 + s (u Ap) Bp
  AIIC_CHECK(narrow_gemm<T>(dy, W, 1, c(p.apB), 1, W, rows, p.rp, W, kDepthChunk, w.part,
                            EpiStore<T>{m(w.t_p), p.rp}, st));
  AIIC_CHECK(big_gemm<true>(dy, c(p.w2), rows, M, W,
                            EpiDfq<T>{LoRATerm<T>{c(w.t_p), c(p.apA), p.rp, 1, p.rp, p.s}, w.f,
                                      m(w.dfq), M}, st));
  AIIC_CHECK(rows_reduce<T>(c(w.u), M, c(w.t_p), p.rp, rows, p.s, w.part, g[4], false, st));
  AIIC_CHECK(rows_reduce<T>(dy, W, c(w.u_ap), p.rp, rows, p.s, w.part, g[5], true, st));
  AIIC_CHECK(narrow_gemm<T>(c(w.dfq), M, 1, c(p.afB), 1, M, rows, p.rf, M, kDepthChunk,
                            w.part, EpiStore<T>{m(w.t_f), p.rf}, st));
  AIIC_CHECK(big_gemm<true>(c(w.dfq), c(p.w1), rows, W, M,
                            EpiLoRAOut<T, float>{
                                LoRATerm<T>{c(w.t_f), c(p.afA), p.rf, 1, p.rf, p.s}, w.dh2, W},
                            st));
  AIIC_CHECK(rows_reduce<T>(c(w.h2), W, c(w.t_f), p.rf, rows, p.s, w.part, g[2], false, st));
  AIIC_CHECK(rows_reduce<T>(c(w.dfq), M, c(w.h2_af), p.rf, rows, p.s, w.part, g[3], true, st));
  AIIC_CHECK(launch_ln_bwd(static_cast<const float*>(w.y1), w.dh2, p.ln2s, dy, w.dy1, m(w.dy1c),
                           rows, W, p.eps, st));

  // attention half: y1 = x + a Wo + bo + s (a Ao) Bo
  AIIC_CHECK(narrow_gemm<T>(static_cast<const float*>(w.dy1), W, 1, c(p.aoB), 1, W, rows, p.ro,
                            W, kDepthChunk, w.part, EpiStore<T>{m(w.t_o), p.ro}, st));
  AIIC_CHECK(big_gemm<true>(c(w.dy1c), c(p.wo), rows, W, W,
                            EpiLoRAOut<T, T>{LoRATerm<T>{c(w.t_o), c(p.aoA), p.ro, 1, p.ro, p.s},
                                             m(w.da), W}, st));
  AIIC_CHECK(rows_reduce<T>(c(w.a), W, c(w.t_o), p.ro, rows, p.s, w.part, g[0], false, st));
  AIIC_CHECK(rows_reduce<T>(static_cast<const float*>(w.dy1), W, c(w.a_ao), p.ro, rows, p.s,
                            w.part, g[1], true, st));
  AIIC_CHECK(launch_core_bwd(c(w.qkv), c(w.da), p.mask, m(w.dqkv), p.B, p.S, W, p.H, p.qconst,
                             st));
  AIIC_CHECK(big_gemm<true>(c(w.dqkv), c(p.wqkv), rows, W, 3 * W,
                            EpiLoRAOut<T, float>{LoRATerm<T>{nullptr, nullptr, 0, 0, 0, 0.f},
                                                 w.dh1, W}, st));
  return launch_ln_bwd(c(p.x), w.dh1, p.ln1s, static_cast<const float*>(w.dy1),
                       static_cast<T*>(dx), static_cast<T*>(nullptr), rows, W, p.eps, st);
}

bool valid(int S, int W, int H, int M) {
  return W % kBN == 0 && M % kBN == 0 && W == H * kHeadDim && S > 0 && S <= kBlockCoreThreads;
}

}  // namespace

// The per-type instantiations (text_block_f32.cu, text_block_bf16.cu).
cudaError_t text_block_fwd_f32(const BlockArgs& p, const Workspace& w, void* y, cudaStream_t st);
cudaError_t text_block_fwd_bf16(const BlockArgs& p, const Workspace& w, void* y, cudaStream_t st);
cudaError_t text_block_bwd_f32(const BlockArgs& p, const Workspace& w, const void* dy, void* dx,
                               float* const* g, cudaStream_t st);
cudaError_t text_block_bwd_bf16(const BlockArgs& p, const Workspace& w, const void* dy, void* dx,
                                float* const* g, cudaStream_t st);

}  // namespace aiic
