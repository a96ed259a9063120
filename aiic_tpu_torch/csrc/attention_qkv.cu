// Packed-QKV attention core for Hopper, bf16 or fp32:
//   out (B, S, W) = Attn(qkv (B, S, 3W)), columns of qkv ordered [Q | K | V]
//
// Replaces the TPU kernel aiic_tpu/ops/attention.py::_attention_qkv_kernel
// (called from fused_attention_qkv). The plain PyTorch version is
// aiic_tpu_torch/ops/attention.py::fused_attention_qkv_ref.
//
// One launch of attn_core_kernel<T> (common.cuh), the core that the int8 and
// bf16 attention half-blocks run too. T is the rounding policy of the TPU
// kernel: in bf16, q*c with c = bf16(scale*log2 e), p before p.V and the
// output round to bf16; in fp32, c = fp32(scale*log2 e) and nothing rounds.
//
// What bounds it on the H100: at B=256, S=197, H=12, D=64 the core does
// 4*B*H*S^2*D = 30.5 GFLOP and moves 4*B*S*W elements (qkv in, out). In
// fp32 the bound is the 66.9 TFLOP/s of the CUDA cores (0.46 ms: fp32 has
// no exact tensor-core path); in bf16 it is the memory (0.09 ms).
//
// What the simple design gives up: the products run as scalar fp32 FMAs
// (no tensor cores), one thread per query row, with K and V of one head in
// shared memory. In fp32 those take 2*S*64*4 = 100,864 B at S=197, so only
// two blocks fit on an SM (four in bf16).

#include "common.cuh"

// qkv (B,S,3W), out (B,S,W), both bf16 (fp32 == 0) or fp32 (fp32 == 1);
// mask (S,S) f32 or null; qconst = scale*log2 e rounded to the element type.
// Needs W == 64*H. Returns a cudaError_t.
extern "C" int aiic_attention_qkv(const void* qkv, const void* mask, void* out, int B, int S,
                                  int W, int H, float qconst, int fp32, void* stream) {
  using namespace aiic;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* m = static_cast<const float*>(mask);
  if (fp32)
    return launch_attn_core(static_cast<const float*>(qkv), m, static_cast<float*>(out), B, S,
                            W, H, qconst, st);
  return launch_attn_core(static_cast<const bf16*>(qkv), m, static_cast<bf16*>(out), B, S, W,
                          H, qconst, st);
}
