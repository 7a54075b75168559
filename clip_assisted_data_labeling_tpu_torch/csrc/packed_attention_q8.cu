// Int8-wire attention with per-token scales for Hopper (sm_90a), plain C
// interface.
//
// Replaces the TPU kernel _packed_q8_kernel / fused_attention_packed_q8
// (clip_assisted_data_labeling_tpu/ops/attention.py, pallas_call at :713).
//
// Input: int8 qkv [B, S, 3w] and ts [B, S] float32, one scale per token (of
// every channel of the token's row, as a dynamic per-row quantize writes
// them). Per head h (head slices h*d, w + h*d, 2w + h*d):
//   q  = bf16(f32(int8) * (ts * scale))   ts * scale formed first, float32
//   k  = bf16(f32(int8) * ts),  v = bf16(f32(int8) * ts)
//   s  = q k^T                            float32 accumulation; keys >= s_real
//                                         get -inf
//   p  = exp(s - max_row(s))              float32; sum over the unrounded p
//   o  = (bf16(p) v) * (1/sum)            float32 accumulation, normalized
//                                         after the product
// then o rounded to the output type (bf16 or float32), or, for quant_out,
// o written in float32 and each token's whole [w] row (all heads, which no
// block of this grid owns) quantized by the wrapper with the row pass of
// rowquant.cu: amax over the row floored at 1e-8, rint(o * (127 / amax)),
// scale amax * f32(1/127) — the TPU kernel's epilogue, as K1's quant_out.
// An exact two-pass softmax, as the TPU kernel computes it.
//
// What bounds it: at ViT-L-336's shape ([32, 577, 3072] int8, 16 heads,
// d=64) the work is ~4·B·H·S²·d = 43.6 GFLOP (0.044 ms at 989 TFLOP/s bf16)
// against B·S·(3w + 4) bytes in and B·S·w·2 out = 94.6 MB (0.028 ms at
// 3.35 TB/s): bound by the tensor-core rate; quant_out's float32 round trip
// (B·S·w·8 more bytes) brings the two close.
//
// Design: exact_wgmma_kernel<DP, false, WIRE_Q8_TOKEN, TO> of
// attention_common.cuh, K3's int8 staging with one scale a token in place
// of K3's channel scales, and K1's ending (the reciprocal of the sum). K
// and V chunks of 64 keys come in by 8-byte cp.async into a two-stage int8
// ring, and their 64 token scales by 4-byte cp.async four steps ahead into
// a ring of four slots in shared memory (with the q tile's 128), so shared
// memory does not grow with S. Each thread converts the bytes it copied,
// with its token's scale, into the bf16 core matrices that wgmma reads, the
// next chunk while this one's Q·K^T is in flight. The products stay bf16 wgmma on the dequantized
// values (P in registers, V MN-major through the transpose bit): int8 wgmma
// cannot keep bf16(k·ts)'s rounding of each value before the dot.

#include "attention_common.cuh"

namespace {

constexpr int DMAX = 128;  // largest head dim

}  // namespace

extern "C" {

// int8 qkv [B, S, 3w] (8-byte aligned), float32 ts [B, S] → out [B, S, w]
// of out_dtype (0 = float32, 1 = bfloat16). Returns cudaGetLastError() of
// the launch.
int packed_attention_q8(const void* qkv, const void* ts, void* out, int out_dtype, int B, int S,
                        int s_real, int w, int heads, float scale, void* stream) {
  if (heads <= 0 || w % heads != 0 || s_real < 1 || s_real > S) return (int)cudaErrorInvalidValue;
  const int d = w / heads;
  if (d % 8 != 0 || d > DMAX) return (int)cudaErrorInvalidValue;  // 8-byte row copies
  const float* t = static_cast<const float*>(ts);
  const Scales sc{t, t, t};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (out_dtype == 0)
    return launch_q8_wgmma<WIRE_Q8_TOKEN, float>(qkv, out, sc, B, S, s_real, w, heads, scale, st);
  if (out_dtype == 1)
    return launch_q8_wgmma<WIRE_Q8_TOKEN, __nv_bfloat16>(qkv, out, sc, B, S, s_real, w, heads,
                                                         scale, st);
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
