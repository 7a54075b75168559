// Static-scale int8 attention wire for Hopper (sm_90a), plain C interface.
//
// Replaces the TPU kernel _packed_q8s_kernel / fused_attention_packed_q8s
// (clip_assisted_data_labeling_tpu/ops/attention.py, pallas_call at :834).
//
// Input: int8 qkv [B, S, 3w] quantized per channel by the int8_static qkv
// projection, and cs [3w] float32 with every scale folded in by the caller:
// cs[:w] = q channel scales × the attention scale, cs[w:2w] = k channel
// scales, cs[2w:] = v channel scales × 127/attn_out_amax. Per head h:
//   q, k, v = bf16(f32(int8) * cs)   per channel (head slices h*d, w+h*d, 2w+h*d)
//   s  = q k^T                       float32 accumulation; keys >= s_real get -inf
//   p  = exp(s - max_row(s))         float32; sum over the unrounded p
//   o  = (bf16(p) v) / sum           float32 accumulation, DIVIDED by the sum
//   out = clip(rint(o), -127, 127)   int8, round half to even
// an exact two-pass softmax, as the TPU kernel computes it.
//
// What bounds it: at SO400M-384 shapes ([32, 729, 3456] int8, 16 heads,
// d=72) the work is ~4·B·H·S²·d = 78.4 GFLOP (0.079 ms at 989 TFLOP/s bf16)
// against B·S·4w = 107.5 MB of device memory (0.032 ms at 3.35 TB/s): bound
// by the tensor-core rate.
//
// Design: exact_wgmma_kernel<DP, false, WIRE_Q8_CHANNEL, int8_t> of
// attention_common.cuh, the bf16 two-pass kernel of K1, K4, K5, K7 and K10
// with the int8 wire in its staging. The products cannot run on int8 wgmma
// (s8·s8→s32): the channel scales lie along the contraction dimension of
// Q·K^T, so they do not factor out of an integer product, and the contract
// rounds each dequantized value to bf16 first. So q, k and v are
// dequantized to bf16 in shared memory: the head's 3·d channel scales are
// staged once a block; K and V chunks of 64 keys come in by 8-byte cp.async
// (a head slice starts at h·72 bytes, only 8-byte aligned) into a two-stage
// int8 ring, and each thread converts the bytes it copied into the bf16
// core matrices that wgmma reads, the next chunk while this one's Q·K^T is
// in flight. Q·K^T and P·V are bf16 wgmma (P in registers, V MN-major
// through the transpose bit); the epilogue divides by the sum and rounds to
// int8. The head dim is zero-padded to a multiple of 16 (72 → 80).

#include "attention_common.cuh"

namespace {

constexpr int DMAX = 128;  // largest head dim

}  // namespace

extern "C" {

// int8 qkv [B, S, 3w] (8-byte aligned), float32 cs [3w] → int8 out [B, S,
// w]. Returns cudaGetLastError() of the launch.
int packed_attention_q8s(const void* qkv, const void* cs, void* out, int B, int S, int s_real,
                         int w, int heads, void* stream) {
  if (heads <= 0 || w % heads != 0 || s_real < 1 || s_real > S) return (int)cudaErrorInvalidValue;
  const int d = w / heads;
  if (d % 8 != 0 || d > DMAX) return (int)cudaErrorInvalidValue;  // 8-byte row copies
  const float* c = static_cast<const float*>(cs);
  return launch_q8_wgmma<WIRE_Q8_CHANNEL, int8_t>(qkv, out, Scales{c, c + w, c + 2 * w}, B, S,
                                                  s_real, w, heads, 1.0f,
                                                  static_cast<cudaStream_t>(stream));
}

}  // extern "C"
