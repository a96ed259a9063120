// Packed-QKV attention core for Hopper, bf16 or fp32, and its head-grouped
// form on the head-major layout, bf16:
//   out (B, S, W) = Attn(qkv (B, S, 3W)), columns of qkv ordered [Q | K | V]
//   out (B, S, W) = Attn(qkv_hm (B, S, 3W)), columns [q_h | k_h | v_h] per head
//
// Replaces the TPU kernels aiic_tpu/ops/attention.py::_attention_qkv_kernel
// (called from fused_attention_qkv, row 7) and _attention_qkv_hg_kernel
// (fused_attention_qkv_headgroups, row 8: ViT-L/14@336's S=577). The plain
// PyTorch versions are aiic_tpu_torch/ops/attention.py::
// fused_attention_qkv_ref and fused_attention_qkv_headgroups_ref.
//
// bf16 (rows 7 and 8): one launch of attn_core_mma_kernel (attn_core_mma.cuh),
// the tensor-core core: 64 query rows a block, both products on wgmma
// m64n64k16 with P kept in registers between them, K and V streamed in
// 64-key tiles, so shared memory (40 KB a block) does not depend on S.
// The head group is the TPU's VMEM tiling; here it only shapes the grid (hg
// heads of one image per grid row), and every head runs row 7's arithmetic,
// so at hg = H the head-major core equals row 7 on the packed layout bit for
// bit.
// fp32 (row 7): one launch of attn_core_f32_kernel<kPacked>
// (attn_core_f32.cuh), the register-tiled SIMT core of fp32 rows 6 and 7:
// 64 query rows a block, a 4x4 micro-tile of each product a thread, K and V
// streamed in 64-key tiles, so it too takes any S; fp32 has no tensor-core
// path that holds its 1e-5 bar. The scalar core it replaced (common.cuh's
// attn_core_kernel<float, 64, kPacked>: one thread per query row, K and V
// of a head in shared memory) stays reachable through the scalar flag, to
// be timed beside it.
// The rounding policy is the TPU kernel's: in bf16, q*c with
// c = bf16(scale*log2 e), p before p.V and the output round to bf16; in
// fp32, c = fp32(scale*log2 e) and nothing rounds.
//
// What bounds it on the H100: at B=256, S=197, H=12, D=64 the core does
// 4*B*H*S^2*D = 30.5 GFLOP and moves 4*B*S*W elements (qkv in, out). In
// fp32 the bound is the 66.9 TFLOP/s of the CUDA cores (0.46 ms); in bf16
// it is the memory (0.092 ms; the products alone take 0.031 ms on the
// tensor cores).
//
// At L/14@336 B=256 the head-grouped core does 349 GFLOP and moves 1.21 GB
// (qkv in, out): 0.361 ms of bytes at 3.35 TB/s.

#include "attn_core_f32.cuh"
#include "attn_core_mma.cuh"  // and common.cuh

// qkv (B,S,3W), out (B,S,W), both bf16 (fp32 == 0) or fp32 (fp32 == 1);
// mask (S,S) f32 or null; qconst = scale*log2 e rounded to the element type.
// scalar == 1 runs fp32 on the scalar core (K and V of a head within shared
// memory) in place of the register-tiled one. Needs W == 64*H. Returns a
// cudaError_t.
extern "C" int aiic_attention_qkv(const void* qkv, const void* mask, void* out, int B, int S,
                                  int W, int H, float qconst, int fp32, int scalar,
                                  void* stream) {
  using namespace aiic;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* m = static_cast<const float*>(mask);
  if (scalar && !fp32) return static_cast<int>(cudaErrorInvalidValue);
  if (fp32) {
    const float* x = static_cast<const float*>(qkv);
    if (scalar) return launch_attn_core(x, m, static_cast<float*>(out), B, S, W, H, qconst, st);
    return launch_attn_core_f32<QKVLayout::kPacked>(x, x, x, m, static_cast<float*>(out), B, S, W,
                                                    H, qconst, st);
  }
  const bf16* x = static_cast<const bf16*>(qkv);
  return launch_attn_core_mma<QKVLayout::kPacked>(x, x, x, m, static_cast<bf16*>(out), B, S, W,
                                                  H, qconst, st);
}

// qkv_hm (B,S,3W) head-major, out (B,S,W), both bf16; mask (S,S) f32 or null;
// qconst = bf16(scale*log2 e). Needs W == 64*H and H % head_group == 0.
// Returns a cudaError_t.
extern "C" int aiic_attention_qkv_hg(const void* qkv_hm, const void* mask, void* out, int B,
                                     int S, int W, int H, int head_group, float qconst,
                                     void* stream) {
  using namespace aiic;
  if (head_group <= 0) return static_cast<int>(cudaErrorInvalidValue);
  const bf16* x = static_cast<const bf16*>(qkv_hm);
  return launch_attn_core_mma<QKVLayout::kHeadMajor>(x, x, x, static_cast<const float*>(mask),
                                                     static_cast<bf16*>(out), B, S, W, H, qconst,
                                                     static_cast<cudaStream_t>(stream),
                                                     head_group);
}

// Blocks of the bf16 core resident on one SM (cudaOccupancyMaxActiveBlocks-
// PerMultiprocessor) into *blocks; the three layouts are one kernel body.
// Returns a cudaError_t.
extern "C" int aiic_attention_qkv_mma_occupancy(int* blocks) {
  using namespace aiic;
  return static_cast<int>(cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      blocks, attn_core_mma_kernel<QKVLayout::kHeadMajor>, kMmaThreads, 0));
}

// Blocks of the fp32 register-tiled core (rows 6 and 7) resident on one SM
// into *blocks. Returns a cudaError_t.
extern "C" int aiic_attention_f32_occupancy(int* blocks) {
  return static_cast<int>(aiic::attn_core_f32_occupancy(blocks));
}
