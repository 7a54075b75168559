// Online-softmax (flash) packed multi-head attention for Hopper (sm_90a),
// plain C interface.
//
// Replaces the TPU kernel _flash_kernel / flash_attention_packed
// (clip_assisted_data_labeling_tpu/ops/attention.py, pallas_call at :599).
//
// Computes, for qkv packed [B, S, 3w] exactly as the qkv projection wrote it
// (head h's q, k, v are the column slices h*d, w + h*d, 2w + h*d):
//   q' = q * T(scale)                rounded to the input type T
//   q' = rot(q'), k' = rot(k)        only with RoPE tables (cos, sin [S, d/2]
//                                    of T): K1's half-split rotation, each
//                                    product and then the sum rounded to T
//                                    (attention_common.cuh rot_pair, rot8);
//                                    k unscaled, each key with its own row
//   per k panel of `kp` keys, in order (keys >= s_real get -inf):
//     s     = q' k^T                 float32 accumulation
//     m'    = max(m, rowmax(s))
//     alpha = exp(m - m')
//     p     = exp(s - m')            float32
//     l     = l * alpha + sum(p)     over the unrounded p
//     acc   = acc * alpha + T(p) v   P rounded to T, float32 accumulation
//     m     = m'
//   o = T(acc / l)                   divided, as the TPU kernel does
// P is rounded against the running max, so the result depends on where the
// panels break; the wrapper passes the TPU kernel's own panel width
// (_flash_tiles: 368 keys at S=729), so the two round at the same points.
//
// What bounds it: at SO400M-384 shapes ([32, 729, 3456] bf16, 16 heads, d=72)
// the work is ~4·B·H·S²·d = 78.4 GFLOP (0.079 ms at 989 TFLOP/s) against
// B·S·4w·2 = 215 MB of device memory (0.064 ms at 3.35 TB/s): bound by the
// tensor-core rate. With RoPE at PE-Core-G14-448's shape ([32, 1024, 4608]
// bf16, d=96) it is 206 GFLOP (0.208 ms) against 403 MB (0.120 ms): the
// tensor-core rate again, the tables (192 KB) adding nothing that counts.
// In float32 the products run on the TF32 tensor cores as 3xTF32 splits
// (three TF32 mmas per product, attention_common.cuh): at SO400M-384's
// float32 path ([16, 729, 3456]) 39.2 GFLOP over a third of the TF32 rate
// (~165 TFLOP/s), 0.24 ms.
//
// bfloat16: exact_wgmma_kernel<DP, true, WIRE_BF16, bf16> of
// attention_common.cuh, the template of K1, K3, K4, K7 and K10 with its panel
// parameter. One block of two
// warpgroups per (128 query rows, head, batch item); Q·K^T and P·V on wgmma
// (P in registers, V MN-major through the transpose bit); K, then K and V,
// in 64-key chunks by cp.async into a three-stage ring of 8x8 core matrices.
// Within each panel an exact two-pass over its chunks: pass 1 takes the
// panel's row max, the running sum and accumulator are rescaled once by
// alpha, and pass 2 recomputes the identical scores and exponentiates
// against the new max. A chunk that crosses a panel's end loads the keys
// past it as zeros and masks them; the next panel loads them again. The
// ring runs one sequence of steps over every panel, so the copies of the
// next panel's first chunk are in flight during this panel's last chunk.
// The head dim is zero-padded to a multiple of 16 (72 → 80) for the Q·K^T
// k-steps.
//
// RoPE: a pre-pass in the same C entry (rope_prepass_kernel) writes
// q·T(scale) rotated and k rotated once into a [B, S, 2w] scratch the
// wrapper allocates (a 16-byte vector of a row's first half with its partner
// in the second half, with bf16x2 round-to-nearest products and sums, as K1
// and K4 rotate; d % 16 == 0); the kernel reads q and k there, each key with
// its own table row.
//
// float32: exact_3xtf32_kernel<DP, 8, true> of attention_common.cuh, the
// float32 kernel of K1, K4 and K10 with its panel parameter: eight warps of
// 16 query rows a block, each warp with its q fragments, scores and output
// accumulators in registers, both products as 3xTF32 m16n8k8 mmas with P
// kept in float32 (T(p) = p), K and V streamed by 16-byte cp.async in
// 32-key chunks and split into (hi, lo) pairs once for the block. Within
// each panel the same exact two-pass as the bf16 kernel, the chunk that
// crosses the panel's end masked past it; the state is rescaled once per
// panel. Shared memory does not grow with the panel (52-101 KB by head dim,
// 8-16 KB more with RoPE tables), so no panel width is refused. At
// SO400M's d = 72 the head dim pads to 80, where the kernel takes 255
// registers and one block of eight warps an SM (PERF.md §6): eight warps
// share each split chunk among 128 query rows, twice what four would.

#include "attention_common.cuh"

namespace {

constexpr int DMAX = 128;  // largest head dim
constexpr int F32_WARPS = 8;  // warps per float32 block

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16; kp: keys per panel. cos, sin: RoPE
// tables [S, d/2] of the same dtype (half-split pairs), or both null for no
// rotation. scratch: with bf16 RoPE tables, [B, S, 2w] bf16 for the rotated
// q and k (else unread). Returns cudaGetLastError() of the launch.
int flash_attention(const void* qkv, void* out, int dtype, int B, int S, int s_real, int w,
                    int heads, float scale, int kp, const void* cos, const void* sin,
                    void* scratch, void* stream) {
  if (heads <= 0 || w % heads != 0 || w / heads > DMAX || s_real < 1 || s_real > S || kp < 1 ||
      (cos == nullptr) != (sin == nullptr) || (cos != nullptr && (w / heads) % 2 != 0))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch_f32_3xtf32<F32_WARPS, true>(packed_heads<float>(qkv, out, S, w, w / heads), B,
                                              S, s_real, heads, w / heads, scale, cos, sin, st,
                                              kp);
  if (dtype == 1)
    return launch_bf16_wgmma<true>(packed_heads<__nv_bfloat16>(qkv, out, S, w, w / heads), B, S,
                                   s_real, heads, w / heads, scale, cos, sin, scratch, st, kp);
  return (int)cudaErrorInvalidValue;
}

// K5 with per-sequence key lengths: kv_len [B] int32 on the device (the
// naflex towers' native-aspect rows, padded to S); batch row b attends to
// its keys [0, min(kv_len[b], s_real)), the panels wholly past that length
// are skipped, and only its query rows below its length are written: out
// must hold zeros. bfloat16 only (dtype 1), the other arguments as
// flash_attention's. Returns cudaGetLastError() of the launch.
int flash_attention_varlen(const void* qkv, void* out, int dtype, int B, int S, int s_real,
                           int w, int heads, float scale, int kp, const void* cos,
                           const void* sin, void* scratch, const int* kv_len, void* stream) {
  if (dtype != 1 || kv_len == nullptr || heads <= 0 || w % heads != 0 || w / heads > DMAX ||
      s_real < 1 || s_real > S || kp < 1 || (cos == nullptr) != (sin == nullptr) ||
      (cos != nullptr && (w / heads) % 2 != 0))
    return (int)cudaErrorInvalidValue;
  return launch_bf16_wgmma<true, __nv_bfloat16, true>(
      packed_heads<__nv_bfloat16>(qkv, out, S, w, w / heads), B, S, s_real, heads, w / heads,
      scale, cos, sin, scratch, static_cast<cudaStream_t>(stream), kp, kv_len);
}

}  // extern "C"
