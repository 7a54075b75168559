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
// bfloat16 (the main path): packed_attention_mma_kernel. One block of four
// warps per (64 query rows, head, batch item); each warp owns 16 rows and
// keeps its q fragments, scores and output accumulators in registers, with
// mma.sync m16n8k16 (bf16 in, f32 accumulate) for both products. K, and V
// transposed, are streamed through shared memory in 64-key chunks read in
// place with head strides (16-byte loads, no layout copies). The exact
// two-pass softmax recomputes the scores instead of storing them: pass 1
// takes the row max, pass 2 recomputes the identical scores (same mma
// sequence on the same data), exponentiates against the final max, sums the
// float32 p, rounds P to bf16 in the registers that feed the P·V mma. That
// costs one extra Q·K^T (1.5x the minimum FLOPs) and keeps shared memory at
// ~28 KB a block, so many blocks fit an SM. With RoPE each 16-byte vector of
// a head row's first half is loaded with its partner in the second half and
// the pair rotated in registers on the way into shared memory (q once, k in
// both passes), so the rotation costs no extra pass or synchronisation.
//
// quant_out (packed_attention_f32out): the bfloat16 kernel stores the float32
// head outputs o * (1/sum) instead of rounding them to bf16 (the TPU kernel
// keeps them in an f32 VMEM scratch), and the wrapper quantizes each token's
// whole [w] row — all heads, which no block of this grid owns — with the row
// kernel of rowquant.cu: amax over the row floored at 1e-8, rint(o * (127 /
// amax)), scale amax * f32(1/127), the TPU kernel's epilogue. The float32
// round trip costs ~2 x 75 MB at [32, 577, 1024] (~45 us at 3.35 TB/s).
//
// float32: exact_3xtf32_kernel<DP, 4, false> of attention_common.cuh, K4's
// float32 kernel with 64 query rows a block: the bfloat16 kernel's structure (warps
// of 16 rows with their fragments and accumulators in registers, keys
// streamed in 32-key chunks in both passes, so no S is refused) with both
// products as 3xTF32 m16n8k8 mmas, and P kept in float32. Each K and V chunk
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

// ---- bfloat16: tensor-core kernel ------------------------------------------

constexpr int MQ = 64;    // query rows per block (4 warps x 16)
constexpr int MK = 64;    // keys per streamed chunk
constexpr int MNT = 128;  // threads per block

template <int DP>  // head dim padded to a multiple of 16
constexpr size_t mma_smem_bytes() {
  return sizeof(__nv_bfloat16) * ((size_t)(MQ + MK) * (DP + PAD) + (size_t)DP * (MK + PAD));
}

template <int DP, bool F32OUT>
__global__ void __launch_bounds__(MNT) packed_attention_mma_kernel(
    Heads<__nv_bfloat16> io, int S, int s_real, int d, float scale,
    const __nv_bfloat16* __restrict__ cos, const __nv_bfloat16* __restrict__ sin) {
  constexpr int LDQ = DP + PAD;  // row stride of Qs and Ks
  constexpr int LDV = MK + PAD;  // row stride of Vt
  extern __shared__ __align__(16) unsigned char mma_smem[];
  __nv_bfloat16* Qs = reinterpret_cast<__nv_bfloat16*>(mma_smem);  // [MQ][LDQ]
  __nv_bfloat16* Ks = Qs + MQ * LDQ;                                // [MK][LDQ]
  __nv_bfloat16* Vt = Ks + MK * LDQ;                                // [DP][LDV], V^T

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, t = lane % 4;  // mma fragment coordinates
  const int q0 = blockIdx.x * MQ, h = blockIdx.y;
  const size_t head = blockIdx.z * io.in_b + h * io.in_h, rs = io.in_r;
  const __nv_bfloat16* __restrict__ kb = io.k + head;
  const __nv_bfloat16* __restrict__ vb = io.v + head;

  // q tile scaled in bf16 (the scale itself rounded to bf16 first), then
  // rotated; zero-padded past d and past S
  const float scale_t = __bfloat162float(__float2bfloat16_rn(scale));
  stage_rows_bf16<MNT, MQ, DP, LDQ>(Qs, io.q + head, q0, S, rs, 0, d, true, scale_t, cos, sin);
  __syncthreads();
  const int r0 = warp * 16;
  uint32_t qa[DP / 16][4];
#pragma unroll
  for (int ks = 0; ks < DP / 16; ++ks) {
    qa[ks][0] = ld32(Qs + (r0 + g) * LDQ + ks * 16 + 2 * t);
    qa[ks][1] = ld32(Qs + (r0 + g + 8) * LDQ + ks * 16 + 2 * t);
    qa[ks][2] = ld32(Qs + (r0 + g) * LDQ + ks * 16 + 8 + 2 * t);
    qa[ks][3] = ld32(Qs + (r0 + g + 8) * LDQ + ks * 16 + 8 + 2 * t);
  }

  // k rotated (not scaled) as each chunk is staged
  auto load_k = [&](int k0) {
    stage_rows_bf16<MNT, MK, DP, LDQ>(Ks, kb, k0, S, rs, 0, d, false, 0.f, cos, sin);
  };
  // this warp's 16 x MK score block of one chunk: s[j] is keys 8j..8j+7,
  // c0/c1 row g keys 2t/2t+1, c2/c3 row g+8 (the mma accumulator layout)
  auto scores = [&](float (&s)[MK / 8][4], int k0) {
#pragma unroll
    for (int j = 0; j < MK / 8; ++j) {
      s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
      const __nv_bfloat16* kr = Ks + (j * 8 + g) * LDQ + 2 * t;
#pragma unroll
      for (int ks = 0; ks < DP / 16; ++ks)
        mma_bf16(s[j], qa[ks], ld32(kr + ks * 16), ld32(kr + ks * 16 + 8));
      const int key = k0 + j * 8 + 2 * t;
      if (key >= s_real) s[j][0] = s[j][2] = -INFINITY;
      if (key + 1 >= s_real) s[j][1] = s[j][3] = -INFINITY;
    }
  };

  // --- pass 1: row max over all keys -----------------------------------
  float m0 = -INFINITY, m1 = -INFINITY;  // rows g and g+8
  for (int k0 = 0; k0 < S; k0 += MK) {
    __syncthreads();
    load_k(k0);
    __syncthreads();
    float s[MK / 8][4];
    scores(s, k0);
#pragma unroll
    for (int j = 0; j < MK / 8; ++j) {
      m0 = fmaxf(m0, fmaxf(s[j][0], s[j][1]));
      m1 = fmaxf(m1, fmaxf(s[j][2], s[j][3]));
    }
  }
  m0 = fmaxf(m0, __shfl_xor_sync(0xffffffffu, m0, 1));
  m0 = fmaxf(m0, __shfl_xor_sync(0xffffffffu, m0, 2));
  m1 = fmaxf(m1, __shfl_xor_sync(0xffffffffu, m1, 1));
  m1 = fmaxf(m1, __shfl_xor_sync(0xffffffffu, m1, 2));

  // --- pass 2: recompute scores, P = bf16(exp(s - max)), O += P V ---------
  float l0 = 0.f, l1 = 0.f;
  float o[DP / 8][4];
#pragma unroll
  for (int n = 0; n < DP / 8; ++n) o[n][0] = o[n][1] = o[n][2] = o[n][3] = 0.f;
  for (int k0 = 0; k0 < S; k0 += MK) {
    __syncthreads();
    load_k(k0);
    stage_vt_bf16<MNT, MK, DP, LDV>(Vt, vb, k0, S, rs, 0, d);
    __syncthreads();
    float s[MK / 8][4];
    scores(s, k0);
    uint32_t pa[MK / 16][4];
#pragma unroll
    for (int j = 0; j < MK / 8; ++j) {
      const float p0 = expf(s[j][0] - m0), p1 = expf(s[j][1] - m0);
      const float p2 = expf(s[j][2] - m1), p3 = expf(s[j][3] - m1);
      l0 += p0;
      l0 += p1;
      l1 += p2;
      l1 += p3;
      pa[j / 2][(j % 2) * 2] = pack_bf16(p0, p1);
      pa[j / 2][(j % 2) * 2 + 1] = pack_bf16(p2, p3);
    }
#pragma unroll
    for (int n = 0; n < DP / 8; ++n) {
      const __nv_bfloat16* vr = Vt + (n * 8 + g) * LDV + 2 * t;
#pragma unroll
      for (int kk = 0; kk < MK / 16; ++kk)
        mma_bf16(o[n], pa[kk], ld32(vr + kk * 16), ld32(vr + kk * 16 + 8));
    }
  }
  l0 += __shfl_xor_sync(0xffffffffu, l0, 1);
  l0 += __shfl_xor_sync(0xffffffffu, l0, 2);
  l1 += __shfl_xor_sync(0xffffffffu, l1, 1);
  l1 += __shfl_xor_sync(0xffffffffu, l1, 2);
  const float inv0 = 1.0f / l0, inv1 = 1.0f / l1;
  const int row0 = q0 + r0 + g, row1 = row0 + 8;
  const size_t ohead = blockIdx.z * io.out_b + h * io.out_h;
#pragma unroll
  for (int n = 0; n < DP / 8; ++n) {
    const int col = n * 8 + 2 * t;
    if (col >= d) continue;
    const size_t i0 = ohead + (size_t)row0 * io.out_r + col;
    const size_t i1 = i0 + 8 * io.out_r;
    const float y0 = o[n][0] * inv0, y1 = o[n][1] * inv0;
    const float y2 = o[n][2] * inv1, y3 = o[n][3] * inv1;
    if (F32OUT) {  // quant_out: the float32 head outputs, for the row quantize
      float* of = static_cast<float*>(io.out);
      if (row0 < S) *reinterpret_cast<float2*>(of + i0) = make_float2(y0, y1);
      if (row1 < S) *reinterpret_cast<float2*>(of + i1) = make_float2(y2, y3);
    } else {
      __nv_bfloat16* ob = static_cast<__nv_bfloat16*>(io.out);
      if (row0 < S) *reinterpret_cast<__nv_bfloat162*>(ob + i0) = __floats2bfloat162_rn(y0, y1);
      if (row1 < S) *reinterpret_cast<__nv_bfloat162*>(ob + i1) = __floats2bfloat162_rn(y2, y3);
    }
  }
}

template <int DP, bool F32OUT>
int launch_mma(Heads<__nv_bfloat16> io, int B, int S, int s_real, int heads, int d,
               float scale, const void* cos, const void* sin, cudaStream_t stream) {
  const size_t smem = mma_smem_bytes<DP>();
  cudaError_t err = cudaFuncSetAttribute(packed_attention_mma_kernel<DP, F32OUT>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((S + MQ - 1) / MQ, heads, B);
  packed_attention_mma_kernel<DP, F32OUT><<<grid, MNT, smem, stream>>>(
      io, S, s_real, d, scale, static_cast<const __nv_bfloat16*>(cos),
      static_cast<const __nv_bfloat16*>(sin));
  return (int)cudaGetLastError();
}

template <bool F32OUT>
int launch_bf16(Heads<__nv_bfloat16> io, int B, int S, int s_real, int heads, int d,
                float scale, const void* cos, const void* sin, cudaStream_t stream) {
  if (d % 8 != 0) return (int)cudaErrorInvalidValue;  // 16-byte row loads
  if (cos != nullptr && d % 16 != 0) return (int)cudaErrorInvalidValue;  // paired half vectors
  if (d <= 64)
    return launch_mma<64, F32OUT>(io, B, S, s_real, heads, d, scale, cos, sin, stream);
  if (d <= 80)
    return launch_mma<80, F32OUT>(io, B, S, s_real, heads, d, scale, cos, sin, stream);
  if (d <= 96)
    return launch_mma<96, F32OUT>(io, B, S, s_real, heads, d, scale, cos, sin, stream);
  if (d <= 112)
    return launch_mma<112, F32OUT>(io, B, S, s_real, heads, d, scale, cos, sin, stream);
  return launch_mma<128, F32OUT>(io, B, S, s_real, heads, d, scale, cos, sin, stream);
}

bool bad_args(int w, int heads, int S, int s_real, const void* cos, const void* sin) {
  return heads <= 0 || w % heads != 0 || w / heads > DMAX || s_real < 1 || s_real > S ||
         (cos == nullptr) != (sin == nullptr) || (cos != nullptr && (w / heads) % 2 != 0);
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16. cos, sin: RoPE tables [S, d/2] of the
// same dtype (half-split pairs), or both null for no rotation. Returns
// cudaGetLastError() of the launch.
int packed_attention(const void* qkv, void* out, int dtype, int B, int S, int s_real,
                     int w, int heads, float scale, const void* cos, const void* sin,
                     void* stream) {
  if (bad_args(w, heads, S, s_real, cos, sin)) return (int)cudaErrorInvalidValue;
  const int d = w / heads;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch_f32_3xtf32<4>(packed_heads<float>(qkv, out, S, w, d), B, S, s_real, heads, d,
                                scale, cos, sin, st);
  if (dtype == 1)
    return launch_bf16<false>(packed_heads<__nv_bfloat16>(qkv, out, S, w, d), B, S, s_real,
                              heads, d, scale, cos, sin, st);
  return (int)cudaErrorInvalidValue;
}

// The same with a float32 output whatever the input type: the head outputs
// acc * (1/sum) before any rounding to the input type, for quant_out (the
// wrapper quantizes each [w] token row with rowquant.cu). For float32 input
// that is packed_attention itself.
int packed_attention_f32out(const void* qkv, void* out, int dtype, int B, int S, int s_real,
                            int w, int heads, float scale, const void* cos, const void* sin,
                            void* stream) {
  if (dtype != 1)
    return packed_attention(qkv, out, dtype, B, S, s_real, w, heads, scale, cos, sin, stream);
  if (bad_args(w, heads, S, s_real, cos, sin)) return (int)cudaErrorInvalidValue;
  const int d = w / heads;
  return launch_bf16<true>(packed_heads<__nv_bfloat16>(qkv, out, S, w, d), B, S, s_real, heads,
                           d, scale, cos, sin, static_cast<cudaStream_t>(stream));
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
    return launch_bf16<false>(unpacked_heads<__nv_bfloat16>(q, k, v, out, H, S, d), B, S, S, H,
                              d, scale, nullptr, nullptr, st);
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
