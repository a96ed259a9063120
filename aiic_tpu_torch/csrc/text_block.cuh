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
// Products and where they run (bf16 takes a form: 0, the route, and 1, the
// first design, kept reachable for the side-by-side check and time; fp32
// has one route):
// - the backbone products (rows x W or M, depth W, 3W or M): in bf16 form 0
//   the wgmma + TMA stage of wgmma_serving_gemm.cuh (128 x 128 tiles, a
//   3-stage TMA ring, two consumer warpgroups), B = W (K, N) as it lies for
//   the forward and W (N, K) read as the K-major B it is for the
//   backward's dy.W^T (no transposed copy), with this file's per-element
//   epilogues (the rank-r up-projection LoRATerm inside them; every one
//   with that term, and qkv's, walks rows through the staged tile with F's
//   column in registers, AIIC_LORA_COLUMN); in bf16 form 1
//   the WMMA tensor-core GEMM of common.cuh (kTransB for dy.W^T); in fp32 a
//   SIMT GEMM of 128x128 tiles (sgemm_kernel), because TF32 keeps 10 bits
//   of mantissa and the fp32 bar is 1e-5;
// - the rank-r down-projections (a.Ao, dy.Bp^T, ...) and the six LoRA
//   cotangents (sums over all B*S rows): in form 0 and fp32 rank_down_kernel
//   and rank_cot_kernel (one warp a chunk of the depth, a lane 8 x 4 outputs,
//   X streamed through a per-warp cp.async ring; below), in form 1 a SIMT
//   GEMM at 64x16 tiles (narrow_gemm); either way each output is an fmaf
//   chain over chunks of kDepthChunk (kRowChunk) in order, the chunk
//   partials added in chunk order, so the two give the same bits and no
//   atomics make a run repeat bit for bit; the rank-r up-projections (.Bo,
//   .Ap^T, ...) run inside the epilogues;
// - the attention core forward: in bf16 form 0 the tensor-core kernel of
//   block_core_fwd_mma.cuh (one 80-key tile, p normalized before p.V, as
//   the TPU kernel rounds), in bf16 form 1 block_core_fwd_kernel (one block
//   per (image, head), one thread per query row, K, V and the S x S
//   probabilities in fp32 shared memory), in fp32 the register-tiled core
//   of rows 6-7 (attn_core_f32.cuh; it folds 1/l in after p.V, an fp32
//   rounding apart);
// - the core backward: in bf16 form 0 row 9's two tensor-core passes
//   (attn_core_bwd_mma.cuh: the same function, the TPU text-block kernel's
//   core step being _attention_qkv_bwd_kernel's; 2 B H S floats of
//   workspace for inv and delta), in fp32 row 9's two register-tiled passes
//   (attn_core_bwd_f32.cuh, the same workspace), in bf16 form 1 common.cuh's
//   block_core_bwd_kernel, one thread per query row with Q, K, V, G and the
//   S x S tile in shared memory.
//
// What bounds it on the H100: at B=256 text rows (S=77, W=512, M=2048, H=8,
// rank 16) the forward does 131.0 GFLOP and the backward 227.3 (it recomputes
// the forward less its last product, then four input-gradient products, the
// core backward and the rank-r cotangents): 1.96 / 3.40 ms at the 66.9
// TFLOP/s of fp32 without tensor cores, 0.132 / 0.230 ms at the 989 TFLOP/s of
// bf16. Both are bound by operations. The rank-r products alone are bound by
// their bytes: each reads its activation once (a forward's three 121 MB in
// bf16, a backward's three and six cotangents about 420 MB), 0.036 / 0.13 ms
// at 3.35 TB/s.
//
// What the design gives up: the rank-r products run on the CUDA cores
// (their fmaf order is the contract, so no tensor core takes them), the
// fp32 GEMM is a shared-memory tile with 8x8 register blocking and one stage
// of register prefetch, and every intermediate makes a round trip through
// device memory between launches.
//
// The code is this header; text_block_f32.cu and text_block_bf16.cu
// instantiate it for one compute type each, so that nvcc builds the two
// beside each other, and text_block.cu holds the C entry points.

#pragma once

#include <stdint.h>

#include <type_traits>
#include <utility>

#include "attn_core_bwd_mma.cuh"
#include "block_core_fwd_mma.cuh"
#include "wgmma_serving_gemm.cuh"  // and common.cuh

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
  int form;  // 0: the wgmma stage and the tensor-core core backward; 1: the WMMA tile and
             // block_core_bwd_kernel (bf16; fp32 has one route, form 0)
};

// The workspace, carved from one buffer at 256-byte offsets (layout()).
struct Workspace {
  void *h1, *qkv, *a, *a_ao, *h2, *h2_af, *u, *u_ap;  // T
  float *y1, *f;
  void *t_p, *dfq, *t_f, *dy1c, *t_o, *da, *dqkv;  // T
  float *dh2, *dy1, *dh1, *part;
  float* core_ws;  // the tensor-core core backward's inv and delta, 2 B H S
};

// The fp32 attention core (text_block_f32.cu): the forward on the
// register-tiled core of attn_core_f32.cuh, the backward on row 9's
// register-tiled passes of attn_core_bwd_f32.cuh (ws: 2 B H S floats).
cudaError_t text_core_fwd_f32(const float* qkv, const float* mask, float* a, int B, int S, int W,
                              int H, float qconst, cudaStream_t st);
cudaError_t text_core_bwd_f32(const float* qkv, const float* da, const float* mask, float* dqkv,
                              float* ws, int B, int S, int W, int H, float qconst,
                              cudaStream_t st);

namespace {

constexpr float kGeluK = 1.702f;
constexpr int kRowChunk = 256;        // rows per partial of a LoRA cotangent
constexpr int kDepthChunk = 256;      // depth per partial of a rank-r down-projection

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
//
// On the wgmma stage an epilogue with this term walks the 64 rows of one
// column n (the staged path), so F's column n is loaded once into registers
// (column, up to kColumnRanks ranks) and each row's term is taken from it
// (at), in place of 2 * rank loads per element: the same fmaf chain over j
// in order, so the same bits as operator().
template <typename T> struct LoRATerm {
  static constexpr int kColumnRanks = 16;
  struct Column {
    float f[kColumnRanks];
  };

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
  __device__ __forceinline__ bool column_fits() const { return rank <= kColumnRanks; }
  __device__ __forceinline__ Column column(int n) const {
    Column c;
#pragma unroll
    for (int j = 0; j < kColumnRanks; ++j)
      c.f[j] = j < rank
                   ? to_f32(F[static_cast<size_t>(j) * fj + static_cast<size_t>(n) * fn])
                   : 0.f;
    return c;
  }
  // operator()(r, n) with F's column n from column(n); needs column_fits().
  __device__ __forceinline__ float at(int r, const Column& c) const {
    float acc = 0.f;
    const T* l = lo + static_cast<size_t>(r) * rank;
    if constexpr (std::is_same<T, bf16>::value) {
      if (rank == kColumnRanks && (reinterpret_cast<uintptr_t>(l) & 15) == 0) {
        // the row of lo as two 16-B loads; bf16 -> fp32 is exact
        const uint4 v[2] = {*reinterpret_cast<const uint4*>(l),
                            *reinterpret_cast<const uint4*>(l + 8)};
        const uint32_t* w = reinterpret_cast<const uint32_t*>(v);
#pragma unroll
        for (int j = 0; j < kColumnRanks / 2; ++j) {
          acc = fmaf(__uint_as_float(w[j] << 16), c.f[2 * j], acc);
          acc = fmaf(__uint_as_float(w[j] & 0xffff0000u), c.f[2 * j + 1], acc);
        }
        return s * acc;
      }
    }
#pragma unroll
    for (int j = 0; j < kColumnRanks; ++j)
      if (j < rank) acc = fmaf(to_f32(l[j]), c.f[j], acc);
    return s * acc;
  }
};

// The column-cached form of an epilogue with a rank-r term (a member
// ``lora``), for the stage's staged path: Column, column_fits(), column(n)
// and at(r, n, acc, column), which applies the epilogue (its apply(r, n,
// acc, term), acc the int32 or fp32 accumulator as it is) with the term
// from LoRATerm::at.
#define AIIC_LORA_COLUMN(T)                                                                    \
  using Column = typename LoRATerm<T>::Column;                                                 \
  __device__ __forceinline__ bool column_fits() const { return lora.column_fits(); }           \
  __device__ __forceinline__ Column column(int n) const { return lora.column(n); }             \
  template <typename Acc>                                                                      \
  __device__ __forceinline__ void at(int r, int n, Acc acc, const Column& c) const {           \
    apply(r, n, acc, lora.at(r, c));                                                           \
  }

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
// stored (N, K) (kTransW). bf16: form 0 the wgmma + TMA stage of
// wgmma_serving_gemm.cuh (W^T read as the K-major B it is, no copy), form 1
// the WMMA tile of common.cuh; either way the epilogue adds the rank-r term.
// fp32: the SIMT tile above (the sums take the rank-r term).
template <bool kTransW, typename T, typename Epi>
cudaError_t big_gemm(const T* A, const T* W, int rows, int N, int K, Epi epi, int form,
                     cudaStream_t st) {
  if constexpr (std::is_same<T, bf16>::value) {
    if (form == 0) return launch_wgmma_stage<bf16, Epi, kTransW>(A, W, rows, N, K, epi, st);
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
// tile at 64x16 (form 1, the first design). Its depth (W or M for a
// down-projection, B*S rows for a LoRA cotangent) is split in chunks of kc,
// one block per chunk and tile writing its partial into its own slice of
// part, and a second pass adds the slices in order and applies epi: enough
// blocks to keep the loads in flight, and no atomics, so a run repeats bit
// for bit.
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

// ---------------------------------------------------------------------------
// Rank-r products (form 0; fp32's one route)
// ---------------------------------------------------------------------------
//
// The same function as narrow_gemm, (P x R) = X' (P x D) . Y' (D x R) with
// both operands rounded to T on load, in the same order, so the same bits:
// each output is the fmaf chain over the depth d in increasing order from 0.f
// within each chunk of kc depths, and the chunk partials are added in chunk
// order from 0.f. The narrow side R (the LoRA rank) is taken 16 columns at a
// time (a column group); within that order the kernels are shaped for a
// product that streams X once and does 16 fmaf per element of it:
// - a warp owns 64 indices p of the wide side (rows of a down-projection,
//   columns of a cotangent's X) and the group's 16 columns for one chunk: a
//   lane 8 p x 4 columns (p group lane / 4, columns 4 (lane % 4)), so a
//   depth costs a lane 32 fmaf, its 8 X' values and one float4 of Y' from
//   shared memory, where the old tile spent five shared-memory reads on 4;
// - X streams through a warp's own kRankStages-deep cp.async ring in shared
//   memory, one 16-B vector of each of the warp's 64 p a step, each lane
//   copying two, so that several KB a warp are in flight with no block
//   barrier; each value is converted where it is read. Y' (the rank-r side,
//   tiny) is staged in shared memory as fp32, converted once;
// - a down-projection (X a row-major activation, depth W or M: 2-16
//   chunks) runs every chunk of a 64-row tile in one block, a warp a chunk
//   (or more), and adds the partials in chunk order through shared memory
//   before its epilogue: one launch, no partial slices;
// - a LoRA cotangent (X an activation read transposed, depth B*S rows: 77
//   chunks at 256 text rows) writes each chunk's partial into its slice of
//   part, which sum_partials_kernel then adds in chunk order.
// No atomics: a run repeats bit for bit.

constexpr int kRankCols = 16;       // columns of a column group
constexpr int kRankStages = 6;      // steps of a warp's X ring (1 KB each)
constexpr int kRankStage = 32;      // depths of a down-projection's staged slice of B'
constexpr int kRankWarps = 4;       // warps of a cotangent block
constexpr int kDownWarps = 8;       // warps of a down-projection block (a chunk each, or more)
constexpr int kRankMaxChunks = 16;  // chunks of a down-projection: K <= 4096
constexpr int kRingVecs = 64;       // 16-B vectors of a warp's ring step

// Bytes of dynamic shared memory of a down-projection block: the warps'
// rings and B' slices, and every chunk's partials of the 64 rows.
constexpr int rank_down_smem(int warps, int n_chunks) {
  return (warps * (kRankStages * kRingVecs * 4 + kRankStage * kRankCols) +
          n_chunks * 64 * kRankCols) * static_cast<int>(sizeof(float));
}

template <int kPending>
__device__ __forceinline__ void cp_async_wait_pending() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(kPending) : "memory");
}

// Element e of a 16-B vector of TX (8 bf16 or 4 fp32) as fp32, rounded to T.
template <typename T, typename TX>
__device__ __forceinline__ float vec_at(const uint4& v, int e) {
  const uint32_t w[4] = {v.x, v.y, v.z, v.w};
  float f;
  if constexpr (std::is_same<TX, bf16>::value)
    f = __uint_as_float((e & 1) ? (w[e >> 1] & 0xffff0000u) : (w[e >> 1] << 16));
  else
    f = __uint_as_float(w[e]);
  if constexpr (!std::is_same<TX, T>::value) f = round_as<T>(f);
  return f;
}

// Row d of Y' (Y'(d, j) = Y[d*syd + j*syj], columns j0 .. j0 + 15; zeros
// past R or where !live) into y, each converted once.
template <typename T, typename TY>
__device__ __forceinline__ void load_y_row(const TY* __restrict__ Y, long long syd, long long syj,
                                           int R, int j0, long long d, bool live,
                                           float (&y)[kRankCols]) {
#pragma unroll
  for (int j = 0; j < kRankCols; ++j)
    y[j] = live && j0 + j < R
               ? round_as<T>(to_f32(Y[d * syd + static_cast<long long>(j0 + j) * syj]))
               : 0.f;
}

__device__ __forceinline__ void store_y_row(float* dst, const float (&y)[kRankCols]) {
#pragma unroll
  for (int q = 0; q < kRankCols / 4; ++q)
    reinterpret_cast<float4*>(dst)[q] = make_float4(y[4 * q], y[4 * q + 1], y[4 * q + 2],
                                                    y[4 * q + 3]);
}

// acc[i][c] = fmaf(x_i, Y'(d, 4 jg + c), acc[i][c]) for one depth: x the
// lane's 8 X' values at d, yrow Y' row d in shared memory.
__device__ __forceinline__ void fma_depth(const float (&x)[8], const float* yrow, int jg,
                                          float (&acc)[8][4]) {
  const float4 b = *reinterpret_cast<const float4*>(yrow + 4 * jg);
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    acc[i][0] = fmaf(x[i], b.x, acc[i][0]);
    acc[i][1] = fmaf(x[i], b.y, acc[i][1]);
    acc[i][2] = fmaf(x[i], b.z, acc[i][2]);
    acc[i][3] = fmaf(x[i], b.w, acc[i][3]);
  }
}

// The down-projection out = epi(A' (rows x K) . B'), B'(k, j) = B[k*sbk +
// j*sbn]. Grid (ceil(rows / 64), ceil(R / 16)); warp w takes chunks w, w +
// warps, ... of the block's 64 rows: lane rows 8 (lane / 4) + i, columns
// 4 (lane % 4) + c of the group. A step is one 16-B vector (E depths) of
// each row, which the warp's ring holds as [i][g] (vector of row 8g + i at
// 8i + g: a lane's reads fall in distinct banks); the warp stages B' in
// kRankStage-deep slices (lane = depth, the next slice's row loaded a slice
// ahead); then the chunk partials are added in chunk order and epi(row, j,
// sum) applied.
template <typename T, typename TA, typename TB, typename Epi>
__global__ void __launch_bounds__(32 * kDownWarps, 2)
rank_down_kernel(const TA* __restrict__ A, int K, const TB* __restrict__ B, long long sbk,
                 long long sbn, int rows, int R, int kc, Epi epi) {
  constexpr int E = 16 / static_cast<int>(sizeof(TA)), kSlice = kRankStage / E;
  extern __shared__ __align__(16) float rs[];
  const int warps = blockDim.x >> 5, warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, jg = lane & 3, n_chunks = (K + kc - 1) / kc;
  const int r0 = blockIdx.x * 64, j0 = blockIdx.y * kRankCols;
  uint4* ring = reinterpret_cast<uint4*>(rs) + warp * kRankStages * kRingVecs;
  float* ys = rs + warps * kRankStages * kRingVecs * 4 + warp * kRankStage * kRankCols;
  float* part = rs + warps * (kRankStages * kRingVecs * 4 + kRankStage * kRankCols);
  // The rows this lane copies: lane and lane + 32 (past the last, the last;
  // never stored), into ring slots 8 (r % 8) + r / 8.
  const TA* src[2];
  int slot[2];
#pragma unroll
  for (int c = 0; c < 2; ++c) {
    const int r = lane + 32 * c;
    src[c] = A + static_cast<long long>(min(r0 + r, rows - 1)) * K;
    slot[c] = 8 * (r & 7) + (r >> 3);
  }
  for (int z = warp; z < n_chunks; z += warps) {
    const int d0 = z * kc, n_steps = (min(K, d0 + kc) - d0) / E;
    auto issue = [&](int t) {
      if (t < n_steps) {
        uint4* st = ring + (t % kRankStages) * kRingVecs;
#pragma unroll
        for (int c = 0; c < 2; ++c)
          cp_async16(smem_addr(st + slot[c]), src[c] + d0 + t * E, 16);
      }
      cp_async_commit();
    };
#pragma unroll
    for (int t = 0; t < kRankStages - 1; ++t) issue(t);
    float acc[8][4];
#pragma unroll
    for (int i = 0; i < 8; ++i) acc[i][0] = acc[i][1] = acc[i][2] = acc[i][3] = 0.f;
    float y[kRankCols];
    load_y_row<T>(B, sbk, sbn, R, j0, d0 + lane, lane < n_steps * E, y);
    for (int t = 0; t < n_steps; ++t) {
      cp_async_wait_pending<kRankStages - 2>();
      __syncwarp();  // step t is whole; every lane is done with step t - 1
      if (t % kSlice == 0) {
        store_y_row(ys + lane * kRankCols, y);
        const int nd = (t + kSlice) * E + lane;
        load_y_row<T>(B, sbk, sbn, R, j0, d0 + nd, nd < n_steps * E, y);
        __syncwarp();
      }
      issue(t + kRankStages - 1);
      const uint4* st = ring + (t % kRankStages) * kRingVecs;
      uint4 v[8];
#pragma unroll
      for (int i = 0; i < 8; ++i) v[i] = st[8 * i + g];
      const float* yr = ys + (t % kSlice) * E * kRankCols;
#pragma unroll
      for (int e = 0; e < E; ++e) {
        float x[8];
#pragma unroll
        for (int i = 0; i < 8; ++i) x[i] = vec_at<T, TA>(v[i], e);
        fma_depth(x, yr + e * kRankCols, jg, acc);
      }
    }
    __syncwarp();  // the ring and the slice are free for the warp's next chunk
    float* pz = part + static_cast<size_t>(z) * 64 * kRankCols;
#pragma unroll
    for (int i = 0; i < 8; ++i)
      *reinterpret_cast<float4*>(pz + (8 * g + i) * kRankCols + 4 * jg) =
          make_float4(acc[i][0], acc[i][1], acc[i][2], acc[i][3]);
  }
  __syncthreads();
  for (int e = threadIdx.x; e < 64 * kRankCols; e += blockDim.x) {
    const int r = e / kRankCols, j = e % kRankCols;
    float v = 0.f;
    for (int c = 0; c < n_chunks; ++c) v += part[static_cast<size_t>(c) * 64 * kRankCols + e];
    if (r0 + r < rows && j0 + j < R) epi(r0 + r, j0 + j, v);
  }
}

// Chunk z = blockIdx.y (kc <= kRowChunk rows) of a LoRA cotangent: X (D,
// P) read transposed, Y (D, R). The block stages the chunk's rows of Y'
// once; each warp takes 64 columns p (a lane the 8 adjacent ones from 8
// (lane / 4), and columns 4 (lane % 4) of the group), DS = 8 / NV rows a
// step (NV = 16-B vectors of a lane's 8 p), through its own ring (a row's
// 8 NV vectors in column order, so a lane's reads fall in distinct banks);
// the partials go to part[z][p][j] (P x R slices). Grid (ceil(P / 256),
// ceil(D / kc), ceil(R / 16)).
template <typename T, typename TX, typename TY>
__global__ void __launch_bounds__(32 * kRankWarps)
rank_cot_kernel(const TX* __restrict__ X, int P, const TY* __restrict__ Y, int R, int D, int kc,
                float* __restrict__ part) {
  constexpr int NV = 8 * static_cast<int>(sizeof(TX)) / 16, DS = 8 / NV;
  __shared__ __align__(16) float ys[kRowChunk * kRankCols];
  __shared__ __align__(16) uint4 rings[kRankWarps][kRankStages * kRingVecs];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, g = lane >> 2, jg = lane & 3;
  const int z = blockIdx.y, j0 = blockIdx.z * kRankCols, d0 = z * kc, d1 = min(D, d0 + kc);
  const int pw = (blockIdx.x * kRankWarps + warp) * 64;  // the warp's first column
  const int n_steps = (d1 - d0 + DS - 1) / DS;
  uint4* ring = rings[warp];
  // The vectors this lane copies: v = lane + 32 c, row v / (8 NV), vector v %
  // (8 NV) of the warp's 64 columns (past P: the last 64, never stored).
  const TX* xw = X + min(pw, P - 64);
  auto issue = [&](int t) {
    if (t < n_steps) {
      uint4* st = ring + (t % kRankStages) * kRingVecs;
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        const int v = lane + 32 * c, dd = v / (8 * NV), q = v % (8 * NV);
        const int d = d0 + t * DS + dd;
        const bool live = d < d1;
        cp_async16(smem_addr(st + v),
                   xw + static_cast<long long>(live ? d : d0) * P + q * (16 / sizeof(TX)),
                   live ? 16 : 0);
      }
    }
    cp_async_commit();
  };
#pragma unroll
  for (int t = 0; t < kRankStages - 1; ++t) issue(t);
  for (int d = threadIdx.x; d < d1 - d0; d += blockDim.x) {
    float y[kRankCols];
    load_y_row<T>(Y, R, 1, R, j0, d0 + d, true, y);
    store_y_row(ys + d * kRankCols, y);
  }
  __syncthreads();
  float acc[8][4];
#pragma unroll
  for (int i = 0; i < 8; ++i) acc[i][0] = acc[i][1] = acc[i][2] = acc[i][3] = 0.f;
  for (int t = 0; t < n_steps; ++t) {
    cp_async_wait_pending<kRankStages - 2>();
    __syncwarp();  // step t is whole; every lane is done with step t - 1
    issue(t + kRankStages - 1);
    const uint4* st = ring + (t % kRankStages) * kRingVecs;
#pragma unroll
    for (int dd = 0; dd < DS; ++dd) {
      const int d = d0 + t * DS + dd;
      if (d < d1) {
        uint4 v[NV];
#pragma unroll
        for (int q = 0; q < NV; ++q) v[q] = st[dd * 8 * NV + g * NV + q];
        float x[8];
#pragma unroll
        for (int i = 0; i < 8; ++i) x[i] = vec_at<T, TX>(v[i / (8 / NV)], i % (8 / NV));
        fma_depth(x, ys + (d - d0) * kRankCols, jg, acc);
      }
    }
  }
  const int p0 = pw + 8 * g;
  if (p0 >= P) return;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    float* dst = part + (static_cast<size_t>(z) * P + p0 + i) * R + j0 + 4 * jg;
#pragma unroll
    for (int c = 0; c < 4; ++c)
      if (j0 + 4 * jg + c < R) dst[c] = acc[i][c];
  }
}

// A down-projection out (rows x R) = epi(A' . B') for A (rows, K) and B'
// (K x R), on rank_down_kernel. Needs K % kRankStage == 0, K within
// kRankMaxChunks chunks of kDepthChunk, 16-byte aligned rows of A.
template <typename T, typename TA, typename TB, typename Epi>
cudaError_t launch_rank_down(const TA* A, int K, const TB* B, long long sbk, long long sbn,
                             int rows, int R, Epi epi, cudaStream_t st) {
  const int n_chunks = (K + kDepthChunk - 1) / kDepthChunk;
  if (rows <= 0 || R <= 0 || K <= 0 || K % kRankStage || n_chunks > kRankMaxChunks)
    return cudaErrorInvalidValue;
  const int warps = min(n_chunks, kDownWarps);
  const int smem = rank_down_smem(warps, n_chunks);
  AIIC_CHECK(cudaFuncSetAttribute(rank_down_kernel<T, TA, TB, Epi>,
                                  cudaFuncAttributeMaxDynamicSharedMemorySize, smem));
  const dim3 grid((rows + 63) / 64, (R + kRankCols - 1) / kRankCols);
  rank_down_kernel<T, TA, TB, Epi><<<grid, 32 * warps, smem, st>>>(A, K, B, sbk, sbn, rows, R,
                                                                   kDepthChunk, epi);
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
// (P, R), or (R, P) when transposed. Both operands rounded to T. Form 0
// rank_cot_kernel, form 1 narrow_gemm, each at kRowChunk with its partial
// slices in part, then sum_partials_kernel.
template <typename T, typename TX, typename TY>
cudaError_t rows_reduce(const TX* X, int P, const TY* Y, int R, int rows, float s, float* part,
                        float* out, bool transposed, int form, cudaStream_t st) {
  const EpiScaled epi{out, P, R, s, transposed};
  if (form != 0)
    return narrow_gemm<T>(X, 1, P, Y, R, 1, P, R, rows, kRowChunk, part, epi, st);
  const int n_chunks = (rows + kRowChunk - 1) / kRowChunk;
  if (P < 64 || R <= 0 || rows <= 0 || P % 8 || n_chunks > 65535) return cudaErrorInvalidValue;
  const dim3 grid((P + 64 * kRankWarps - 1) / (64 * kRankWarps), n_chunks,
                  (R + kRankCols - 1) / kRankCols);
  rank_cot_kernel<T><<<grid, 32 * kRankWarps, 0, st>>>(X, P, Y, R, rows, kRowChunk, part);
  AIIC_CHECK(cudaGetLastError());
  sum_partials_kernel<<<(P * R + 255) / 256, 256, 0, st>>>(part, n_chunks, P, R, epi);
  return cudaGetLastError();
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
  __device__ void operator()(int r, int n, float acc) const { apply(r, n, acc, lora(r, n)); }
  __device__ __forceinline__ void apply(int r, int n, float acc, float term) const {
    const size_t i = static_cast<size_t>(r) * n_cols + n;
    float v = acc + b[n];
    v = v + term;
    y1[i] = to_f32(x[i]) + v;
  }
  AIIC_LORA_COLUMN(T)
};

template <typename T> struct EpiFc {  // f = (acc + b1) + s (h2 Af) Bf; u = T(f sigmoid(1.702 f))
  const float* b;
  LoRATerm<T> lora;
  float* f_out;  // kept for the backward, or null
  T* u;
  int n_cols;
  __device__ void operator()(int r, int n, float acc) const { apply(r, n, acc, lora(r, n)); }
  __device__ __forceinline__ void apply(int r, int n, float acc, float term) const {
    const size_t i = static_cast<size_t>(r) * n_cols + n;
    float f = acc + b[n];
    f = f + term;
    if (f_out) f_out[i] = f;
    store_as<T>(u + i, f * sigmoid_gelu(f));
  }
  AIIC_LORA_COLUMN(T)
};

template <typename T> struct EpiY {  // y = T(y1 + ((acc + b2) + s (u Ap) Bp))
  const float* b;
  LoRATerm<T> lora;
  const float* y1;
  T* y;
  int n_cols;
  __device__ void operator()(int r, int n, float acc) const { apply(r, n, acc, lora(r, n)); }
  __device__ __forceinline__ void apply(int r, int n, float acc, float term) const {
    const size_t i = static_cast<size_t>(r) * n_cols + n;
    float mo = acc + b[n];
    mo = mo + term;
    store_as<T>(y + i, y1[i] + mo);
  }
  AIIC_LORA_COLUMN(T)
};

template <typename T> struct EpiDfq {  // du = acc + s t_p Ap^T; dfq = T(du gelu'(f))
  LoRATerm<T> lora;
  const float* f;
  T* dfq;
  int n_cols;
  __device__ void operator()(int r, int n, float acc) const { apply(r, n, acc, lora(r, n)); }
  __device__ __forceinline__ void apply(int r, int n, float acc, float term) const {
    const size_t i = static_cast<size_t>(r) * n_cols + n;
    const float du = acc + term;
    const float fv = f[i];
    const float sg = sigmoid_gelu(fv);
    const float d = sg + kGeluK * fv * sg * (1.0f - sg);
    store_as<T>(dfq + i, du * d);
  }
  AIIC_LORA_COLUMN(T)
};

template <typename T, typename TO> struct EpiLoRAOut {  // out = TO(acc + s lo F^T)
  LoRATerm<T> lora;
  TO* out;
  int n_cols;
  __device__ void operator()(int r, int n, float acc) const { apply(r, n, acc, lora(r, n)); }
  __device__ __forceinline__ void apply(int r, int n, float acc, float term) const {
    store_as<TO>(out + static_cast<size_t>(r) * n_cols + n, acc + term);
  }
  AIIC_LORA_COLUMN(T)
};

// The down-projection out (rows x R) = T(A' (rows x K) . B') of a LoRA delta
// or its cotangent, B'(k, j) = B[k*sbk + j*sbn]: form 0 rank_down_kernel,
// form 1 narrow_gemm at kDepthChunk (part its slices).
template <typename T, typename TA, typename TB>
cudaError_t down_proj(const TA* A, int K, const TB* B, long long sbk, long long sbn, int rows,
                      int R, float* part, T* out, int form, cudaStream_t st) {
  if (form == 0) return launch_rank_down<T>(A, K, B, sbk, sbn, rows, R, EpiStore<T>{out, R}, st);
  return narrow_gemm<T>(A, K, 1, B, sbk, sbn, rows, R, K, kDepthChunk, part,
                        EpiStore<T>{out, R}, st);
}

// On the wgmma stage every epilogue with a rank-r term walks rows through
// shared memory with F's column in registers (ColumnCached); so does qkv's
// (3W columns), so that its stores coalesce.
template <> struct StagedEpilogue<EpiQkv<bf16>> { static constexpr bool value = true; };

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
// (the backward, block_core_bwd_kernel, and probs_row are in common.cuh)
// ---------------------------------------------------------------------------

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

template <typename T>
cudaError_t launch_core_fwd(const T* qkv, const float* mask, T* a, int B, int S, int W, int H,
                            float qconst, cudaStream_t st) {
  const int smem = (2 * S * kHeadDim + S * S) * static_cast<int>(sizeof(float));
  AIIC_CHECK(cudaFuncSetAttribute(block_core_fwd_kernel<T>,
                                  cudaFuncAttributeMaxDynamicSharedMemorySize, smem));
  block_core_fwd_kernel<T><<<dim3(H, B), kBlockCoreThreads, smem, st>>>(qkv, mask, a, S, W, qconst);
  return cudaGetLastError();
}

// The text block's core forward: in bf16 form 0 the tensor-core kernel of
// block_core_fwd_mma.cuh (S <= kCoreKeys), in bf16 form 1
// block_core_fwd_kernel, in fp32 the register-tiled core of
// attn_core_f32.cuh (text_core_fwd_f32), which folds 1/l in after p.V: in
// fp32 that moves only an fp32 rounding, inside the fp32 bar.
template <typename T>
cudaError_t core_fwd(const BlockArgs& p, const T* qkv, T* a, cudaStream_t st) {
  if constexpr (std::is_same<T, bf16>::value) {
    if (p.form == 0)
      return launch_block_core_fwd_mma(qkv, p.mask, a, p.B, p.S, p.W, p.H, p.qconst, st);
    return launch_core_fwd(qkv, p.mask, a, p.B, p.S, p.W, p.H, p.qconst, st);
  } else {
    return text_core_fwd_f32(qkv, p.mask, a, p.B, p.S, p.W, p.H, p.qconst, st);
  }
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
    w->core_ws = static_cast<float*>(take(2 * rows * (W / kHeadDim) * 4));
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
                             EpiQkv<T>{p.bqkv, m(w.qkv), 3 * W}, p.form, st));
  AIIC_CHECK(core_fwd<T>(p, c(w.qkv), m(w.a), st));
  AIIC_CHECK(down_proj<T>(c(w.a), W, c(p.aoA), p.ro, 1, rows, p.ro, w.part, m(w.a_ao), p.form,
                          st));
  AIIC_CHECK(big_gemm<false>(c(w.a), c(p.wo), rows, W, W,
                             EpiY1<T>{p.bo, LoRATerm<T>{c(w.a_ao), c(p.aoB), p.ro, W, 1, p.s},
                                      x, w.y1, W}, p.form, st));
  AIIC_CHECK(launch_ln_fwd(static_cast<const float*>(w.y1), p.ln2s, p.ln2b, m(w.h2), rows, W,
                           p.eps, st));
  AIIC_CHECK(down_proj<T>(c(w.h2), W, c(p.afA), p.rf, 1, rows, p.rf, w.part, m(w.h2_af), p.form,
                          st));
  AIIC_CHECK(big_gemm<false>(c(w.h2), c(p.w1), rows, M, W,
                             EpiFc<T>{p.b1, LoRATerm<T>{c(w.h2_af), c(p.afB), p.rf, M, 1, p.s},
                                      f_keep, m(w.u), M}, p.form, st));
  AIIC_CHECK(down_proj<T>(c(w.u), M, c(p.apA), p.rp, 1, rows, p.rp, w.part, m(w.u_ap), p.form,
                          st));
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
      p.form, st);
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
  AIIC_CHECK(down_proj<T>(dy, W, c(p.apB), 1, W, rows, p.rp, w.part, m(w.t_p), p.form, st));
  AIIC_CHECK(big_gemm<true>(dy, c(p.w2), rows, M, W,
                            EpiDfq<T>{LoRATerm<T>{c(w.t_p), c(p.apA), p.rp, 1, p.rp, p.s}, w.f,
                                      m(w.dfq), M}, p.form, st));
  AIIC_CHECK(rows_reduce<T>(c(w.u), M, c(w.t_p), p.rp, rows, p.s, w.part, g[4], false, p.form,
                            st));
  AIIC_CHECK(rows_reduce<T>(dy, W, c(w.u_ap), p.rp, rows, p.s, w.part, g[5], true, p.form, st));
  AIIC_CHECK(down_proj<T>(c(w.dfq), M, c(p.afB), 1, M, rows, p.rf, w.part, m(w.t_f), p.form,
                          st));
  AIIC_CHECK(big_gemm<true>(c(w.dfq), c(p.w1), rows, W, M,
                            EpiLoRAOut<T, float>{
                                LoRATerm<T>{c(w.t_f), c(p.afA), p.rf, 1, p.rf, p.s}, w.dh2, W},
                            p.form, st));
  AIIC_CHECK(rows_reduce<T>(c(w.h2), W, c(w.t_f), p.rf, rows, p.s, w.part, g[2], false, p.form,
                            st));
  AIIC_CHECK(rows_reduce<T>(c(w.dfq), M, c(w.h2_af), p.rf, rows, p.s, w.part, g[3], true, p.form,
                            st));
  AIIC_CHECK(launch_ln_bwd(static_cast<const float*>(w.y1), w.dh2, p.ln2s, dy, w.dy1, m(w.dy1c),
                           rows, W, p.eps, st));

  // attention half: y1 = x + a Wo + bo + s (a Ao) Bo
  AIIC_CHECK(down_proj<T>(static_cast<const float*>(w.dy1), W, c(p.aoB), 1, W, rows, p.ro, w.part,
                          m(w.t_o), p.form, st));
  AIIC_CHECK(big_gemm<true>(c(w.dy1c), c(p.wo), rows, W, W,
                            EpiLoRAOut<T, T>{LoRATerm<T>{c(w.t_o), c(p.aoA), p.ro, 1, p.ro, p.s},
                                             m(w.da), W}, p.form, st));
  AIIC_CHECK(rows_reduce<T>(c(w.a), W, c(w.t_o), p.ro, rows, p.s, w.part, g[0], false, p.form,
                            st));
  AIIC_CHECK(rows_reduce<T>(static_cast<const float*>(w.dy1), W, c(w.a_ao), p.ro, rows, p.s,
                            w.part, g[1], true, p.form, st));
  if constexpr (std::is_same<T, bf16>::value) {
    if (p.form == 0)  // row 9's two tensor-core passes
      AIIC_CHECK(launch_core_bwd_mma(c(w.qkv), c(w.da), p.mask, m(w.dqkv), w.core_ws, p.B, p.S, W,
                                     p.H, p.qconst, st));
    else
      AIIC_CHECK(launch_core_bwd(c(w.qkv), c(w.da), p.mask, m(w.dqkv), p.B, p.S, W, p.H,
                                 p.qconst, st));
  } else {  // row 9's two register-tiled fp32 passes
    AIIC_CHECK(text_core_bwd_f32(c(w.qkv), c(w.da), p.mask, m(w.dqkv), w.core_ws, p.B, p.S, W,
                                 p.H, p.qconst, st));
  }
  AIIC_CHECK(big_gemm<true>(c(w.dqkv), c(p.wqkv), rows, W, 3 * W,
                            EpiLoRAOut<T, float>{LoRATerm<T>{nullptr, nullptr, 0, 0, 0, 0.f},
                                                 w.dh1, W}, p.form, st));
  return launch_ln_bwd(c(p.x), w.dh1, p.ln1s, static_cast<const float*>(w.dy1),
                       static_cast<T*>(dx), static_cast<T*>(nullptr), rows, W, p.eps, st);
}

bool valid(int S, int W, int H, int M) {
  return W % kBN == 0 && M % kBN == 0 && W == H * kHeadDim && S > 0 && S <= kBlockCoreThreads;
}

// form 0 or 1 in bf16 (and int8), form 0 alone in fp32; bf16 form 0's core
// forward holds S keys in one tile.
bool valid_form(int form, bool fp32, int S) {
  return (form == 0 && (fp32 || S <= kCoreKeys)) || (form == 1 && !fp32);
}

}  // namespace

// The per-type instantiations (text_block_f32.cu, text_block_bf16.cu).
cudaError_t text_block_fwd_f32(const BlockArgs& p, const Workspace& w, void* y, cudaStream_t st);
cudaError_t text_block_fwd_bf16(const BlockArgs& p, const Workspace& w, void* y, cudaStream_t st);
cudaError_t text_block_bwd_f32(const BlockArgs& p, const Workspace& w, const void* dy, void* dx,
                               float* const* g, cudaStream_t st);
cudaError_t text_block_bwd_bf16(const BlockArgs& p, const Workspace& w, const void* dy, void* dx,
                                float* const* g, cudaStream_t st);
// Blocks per SM of the bf16 block's stage and core instantiations, into
// blocks[0..4]: EpiQkv, EpiY1, EpiFc (forward), EpiDfq, EpiLoRAOut (backward,
// K-major B).
cudaError_t text_block_occupancy_bf16(int* blocks);

}  // namespace aiic
