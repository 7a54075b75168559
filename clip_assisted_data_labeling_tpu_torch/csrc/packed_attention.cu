// Multi-head softmax attention for Hopper (sm_90a), plain C interface: K1 on
// the packed qkv, K10 on unpacked [B, h, S, d] q, k, v.
//
// Replaces the TPU kernels _packed_kernel / fused_attention_packed (K1) and
// _attn_kernel / fused_attention (K10)
// (clip_assisted_data_labeling_tpu/ops/attention.py, pallas_call at :1124
// and :107). Both compute the same function in two layouts, and both entries
// below run the same kernels, which read q, k and v in place through strides
// (batch, head, token; the Heads struct), so neither layout is copied:
//   K1: qkv packed [B, S, 3w] exactly as the qkv projection wrote it (head
//       h's q, k, v are the column slices h*d, w + h*d, 2w + h*d), out
//       [B, S, w];
//   K10: q, k, v and out each [B, h, S, d] (no RoPE, no quant_out).
// Per head:
//   q' = q * scale            rounded to the input type (as the TPU kernel)
//   q' = rot(q'), k' = rot(k) only with RoPE tables (PE towers): the
//                             half-split pairs (i, i + d/2),
//                             [x1·cos − x2·sin, x1·sin + x2·cos], each
//                             product and then the sum rounded to T
//                             (attention_common.cuh rot_pair); k unscaled
//   s  = q' k^T               float32 accumulation; keys >= s_real get -inf
//   p  = exp(s - max_row(s))  float32; sum over the unrounded p
//   o  = (T(p) v) * (1/sum)   P rounded to v's type, float32 accumulation,
//                             normalized after the product, rounded to T
// an exact two-pass softmax: every P is exp(s - final row max), rounded at
// the same point as on the TPU (an online softmax would round a rescaled P).
//
// What bounds it (either layout): at ViT-L-336 shapes (S=577, d=64) the
// work is ~4·B·H·S²·d FLOPs against ~B·S·4w·sizeof(T) bytes — ~290 FLOP/byte
// in bf16, right at the H100's ridge (~295), so both the tensor-core rate and device memory
// bound it about equally. In float32 the products run on the TF32 tensor
// cores as 3xTF32 splits (three TF32 mmas per product, attention_common.cuh),
// so the bound is the TF32 rate over three: ~165 of the 495 TFLOP/s, still
// 2.5x the 67 TFLOP/s of float32 FMAs.
//
// bfloat16 (the main path): exact_wgmma_kernel<DP, false, WIRE_BF16, TO> of
// attention_common.cuh, the template K3, K4, K5 and K7 instantiate too. One block
// of two warpgroups per (128 query rows, head, batch item); K, then K and V,
// stream in 64-key chunks by 16-byte cp.async into a three-stage ring of 8x8
// core matrices read in place with head strides, so two steps' copies are in
// flight while the warpgroups multiply. Q·K^T is wgmma m64n64k16 with q and
// K from shared memory, P·V wgmma m64nDk16 with P in registers and V
// MN-major through the transpose bit, so V is never transposed. The exact
// two-pass softmax recomputes the scores instead of storing them: pass 1
// takes the row max, pass 2 recomputes the identical scores (the same
// products on the same data), exponentiates against the final max, sums the
// float32 p, and rounds P to bf16 in the registers of wgmma's A operand.
// That costs one extra Q·K^T (1.5x the minimum FLOPs) and keeps shared
// memory at 64 KB a block (d = 64), two blocks an SM. With RoPE (PE towers)
// a pre-pass in the same C entry (rope_prepass_kernel) writes q·T(scale)
// rotated and k rotated once into a [B, S, 2w] scratch the wrapper
// allocates, with the bf16x2 round-to-nearest vector code (scale8, rot8)
// that rounds as rot_pair, and the kernel reads q and k there: each key
// rotated once, not once per query tile and pass.
//
// quant_out (packed_attention_f32out): the bfloat16 kernel (TO = float) stores
// the float32 head outputs o * (1/sum) instead of rounding them to bf16 (the
// TPU kernel keeps them in an f32 VMEM scratch), and the wrapper quantizes each token's
// whole [w] row — all heads, which no block of this grid owns — with the row
// kernel of rowquant.cu: amax over the row floored at 1e-8, rint(o * (127 /
// amax)), scale amax * f32(1/127), the TPU kernel's epilogue. The float32
// round trip costs ~2 x 75 MB at [32, 577, 1024] (~45 us at 3.35 TB/s).
//
// float32: exact_3xtf32_kernel<DP, 4, false> of attention_common.cuh, K4's
// float32 kernel with 64 query rows a block: warps of 16 rows with their
// fragments and accumulators in registers, keys streamed in 32-key chunks in
// both passes (so no S is refused), both products as 3xTF32 m16n8k8 mmas,
// and P kept in float32. Each K and V chunk
// comes in by 16-byte cp.async (the next one's copy in flight while the
// warps multiply) and is split into (hi, lo) pairs once for the block. A
// split keeps ~21 of a product's 24 bits: emulated on K1's arithmetic
// (tests/test_torch_split_f32.py), the outputs stay within ~1e-6 of float32
// (as close as float32 torch and XLA come to each other), where one TF32
// pass misses by ~2e-4. The same kernel serves K10 in float32 and
// quant_out's float32 input.

#include "attention_common.cuh"

namespace {

constexpr int DMAX = 128; // largest head dim

template <typename T>
Heads<T> unpacked_heads(const void* q, const void* k, const void* v, void* out, int H, int S,
                        int d) {
  const size_t hs = (size_t)S * d;
  return Heads<T>{static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
                  out, (size_t)H * hs, hs, (size_t)d, (size_t)H * hs, hs, (size_t)d};
}

bool bad_args(int w, int heads, int S, int s_real, const void* cos, const void* sin) {
  return heads <= 0 || w % heads != 0 || w / heads > DMAX || s_real < 1 || s_real > S ||
         (cos == nullptr) != (sin == nullptr) || (cos != nullptr && (w / heads) % 2 != 0);
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16. cos, sin: RoPE tables [S, d/2] of the
// same dtype (half-split pairs), or both null for no rotation. scratch: with
// bf16 RoPE tables, [B, S, 2w] bf16 for the rotated q and k (else unread).
// Returns cudaGetLastError() of the launch.
int packed_attention(const void* qkv, void* out, int dtype, int B, int S, int s_real,
                     int w, int heads, float scale, const void* cos, const void* sin,
                     void* scratch, void* stream) {
  if (bad_args(w, heads, S, s_real, cos, sin)) return (int)cudaErrorInvalidValue;
  const int d = w / heads;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch_f32_3xtf32<4>(packed_heads<float>(qkv, out, S, w, d), B, S, s_real, heads, d,
                                scale, cos, sin, st);
  if (dtype == 1)
    return launch_bf16_wgmma<false>(packed_heads<__nv_bfloat16>(qkv, out, S, w, d), B, S,
                                    s_real, heads, d, scale, cos, sin, scratch, st);
  return (int)cudaErrorInvalidValue;
}

// The same with a float32 output whatever the input type: the head outputs
// acc * (1/sum) before any rounding to the input type, for quant_out (the
// wrapper quantizes each [w] token row with rowquant.cu). For float32 input
// that is packed_attention itself.
int packed_attention_f32out(const void* qkv, void* out, int dtype, int B, int S, int s_real,
                            int w, int heads, float scale, const void* cos, const void* sin,
                            void* scratch, void* stream) {
  if (dtype != 1)
    return packed_attention(qkv, out, dtype, B, S, s_real, w, heads, scale, cos, sin, scratch,
                            stream);
  if (bad_args(w, heads, S, s_real, cos, sin)) return (int)cudaErrorInvalidValue;
  const int d = w / heads;
  return launch_bf16_wgmma<false, float>(packed_heads<__nv_bfloat16>(qkv, out, S, w, d), B, S,
                                        s_real, heads, d, scale, cos, sin, scratch,
                                        static_cast<cudaStream_t>(stream));
}

// K1 with per-sequence key lengths: kv_len [B] int32 on the device (the
// naflex towers' native-aspect rows, padded to S); batch row b attends to
// its keys [0, min(kv_len[b], s_real)), and only its query rows below its
// length are written: out must hold zeros. bfloat16 only (dtype 1), the
// other arguments as packed_attention's. Returns cudaGetLastError() of the
// launch.
int packed_attention_varlen(const void* qkv, void* out, int dtype, int B, int S, int s_real,
                            int w, int heads, float scale, const void* cos, const void* sin,
                            void* scratch, const int* kv_len, void* stream) {
  if (dtype != 1 || kv_len == nullptr || bad_args(w, heads, S, s_real, cos, sin))
    return (int)cudaErrorInvalidValue;
  const int d = w / heads;
  return launch_bf16_wgmma<false, __nv_bfloat16, true>(
      packed_heads<__nv_bfloat16>(qkv, out, S, w, d), B, S, s_real, heads, d, scale, cos, sin,
      scratch, static_cast<cudaStream_t>(stream), 0, kv_len);
}

// K10: q, k, v, out each [B, H, S, d] contiguous of dtype (0 = float32,
// 1 = bfloat16); every key is real (s_real = S), no RoPE. Returns
// cudaGetLastError() of the launch.
int attention_unpacked(const void* q, const void* k, const void* v, void* out, int dtype, int B,
                       int H, int S, int d, float scale, void* stream) {
  if (H <= 0 || d <= 0 || bad_args(H * d, H, S, S, nullptr, nullptr))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch_f32_3xtf32<4>(unpacked_heads<float>(q, k, v, out, H, S, d), B, S, S, H, d,
                                scale, nullptr, nullptr, st);
  if (dtype == 1)
    return launch_bf16_wgmma<false>(unpacked_heads<__nv_bfloat16>(q, k, v, out, H, S, d), B, S,
                                    S, H, d, scale, nullptr, nullptr, nullptr, st);
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
