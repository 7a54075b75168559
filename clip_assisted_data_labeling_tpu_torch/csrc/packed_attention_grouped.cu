// Head-grouped packed multi-head attention (K4) for Hopper (sm_90a), plain C
// interface.
//
// Replaces the TPU kernel _packed_grouped_kernel /
// fused_attention_packed_grouped (clip_assisted_data_labeling_tpu/ops/
// attention.py, pallas_call at :342), which the JAX package runs wherever the
// whole [S, 3w] block of one batch item overflows its VMEM budget but a
// 128-lane group of heads fits: PE-Core-G14-448 (S=1024, w=1536, d=96) in
// bf16, and the float32 runs of the 336/384-pixel towers (ViT-L-14-336,
// PE-Core-L14-336, ...). It computes the same arithmetic as K1, for qkv
// packed [B, S, 3w] read in place (the TPU wrapper's [B, 3, S, w] transpose
// is a TPU tiling device and has no counterpart here):
//   q' = rot(T(q * T(scale)))   q scaled in the input type T, then rotated
//   k' = rot(k)                 (rotation only with RoPE tables: the
//                               half-split pairs (i, i + d/2), each product
//                               and then the sum rounded to T, as
//                               attention_common.cuh rot_pair)
//   s  = q' k'^T                float32 accumulation; keys >= s_real get -inf
//   p  = exp(s - max_row(s))    float32, the exact two-pass softmax; the sum
//                               over the unrounded p
//   o  = T((T(p) v) * (1/sum))  P rounded to v's type, float32 accumulation
//
// What bounds it on the H100: at PE-G14-448's shape ([32, 1024, 4608] bf16,
// 16 heads, d=96) the work is 4·B·H·S²·d = 206 GFLOP (0.21 ms at
// 989 TFLOP/s) against B·S·4w·2 = 403 MB (0.12 ms at 3.35 TB/s): the
// tensor-core rate. In float32 the products are 3xTF32 splits (three TF32
// mmas each, attention_common.cuh), bound by the TF32 rate over three (~165
// TFLOP/s). What Hopper has to add to the TPU kernel is any sequence length
// at any head dim up to 128 in both types: a whole score row does not fit
// shared memory beside its operands for long sequences.
//
// The design answers that by streaming the keys through shared memory in
// 64-key chunks (32 in float32) in both passes of the exact softmax, so
// nothing grows with S: pass 1 takes each row's max over all chunks; pass 2
// recomputes the same scores chunk by chunk (the same operations on the same
// data, so the same values), exponentiates against the final max, sums the
// float32 p, and accumulates T(p)·V; the epilogue multiplies by 1/sum. k is
// rotated as each
// chunk is staged (twice per key in all): the TPU kernel rotates it once per
// head in VMEM, but a rotated bf16 K of 1024 x 96 beside V would not leave
// room in one block's shared memory for the many blocks an SM needs.
//
// bfloat16: grouped_mma_kernel. One block of eight warps per (128 query
// rows, head, batch item); each warp owns 16 rows and keeps its q fragments,
// scores and output accumulators in registers, with mma.sync m16n8k16 (bf16
// in, f32 accumulate) for both products. Every K and V chunk staged in
// shared memory serves 128 query rows (K1 stages it for 64). d = 96 runs
// 6 k-steps of 16 for Q·K^T and 12 n8 tiles for P·V.
//
// float32: exact_3xtf32_kernel<DP, 8> of attention_common.cuh, K1's float32
// kernel with 128 query rows a block: both products as 3xTF32 m16n8k8 mmas
// (a float32 operand split into a rounded TF32 high part and a TF32
// remainder, three mmas per product pair, ~21 of the 24 bits kept), P kept
// in float32. Each K and V chunk comes in by 16-byte cp.async (the next
// one's copy in flight while the warps multiply) and is split once for the
// block, k rotated first. Shared memory stays at 52 KB (d=64) to 101 KB
// (d=128), 8 to 16 KB more with RoPE tables, for any S.

#include "attention_common.cuh"

namespace {

constexpr int DMAX = 128;  // largest head dim

// ---- bfloat16: tensor-core kernel, 128 query rows a block ------------------

constexpr int GQ = 128;   // query rows per block (8 warps x 16)
constexpr int GK = 64;    // keys per streamed chunk
constexpr int GNT = 256;  // threads per block

template <int DP>  // head dim padded to a multiple of 16
constexpr size_t mma_smem_bytes() {
  return sizeof(__nv_bfloat16) * ((size_t)(GQ + GK) * (DP + PAD) + (size_t)DP * (GK + PAD));
}

template <int DP>
__global__ void __launch_bounds__(GNT) grouped_mma_kernel(
    const __nv_bfloat16* __restrict__ qkv, __nv_bfloat16* __restrict__ out, int S,
    int s_real, int w, int d, float scale, const __nv_bfloat16* __restrict__ cos,
    const __nv_bfloat16* __restrict__ sin) {
  constexpr int LDQ = DP + PAD;  // row stride of Qs and Ks
  constexpr int LDV = GK + PAD;  // row stride of Vt
  extern __shared__ __align__(16) unsigned char mma_smem[];
  __nv_bfloat16* Qs = reinterpret_cast<__nv_bfloat16*>(mma_smem);  // [GQ][LDQ]
  __nv_bfloat16* Ks = Qs + GQ * LDQ;                                // [GK][LDQ]
  __nv_bfloat16* Vt = Ks + GK * LDQ;                                // [DP][LDV], V^T

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, t = lane % 4;  // mma fragment coordinates
  const int q0 = blockIdx.x * GQ, h = blockIdx.y;
  const size_t rs = 3 * (size_t)w;
  const __nv_bfloat16* base = qkv + (size_t)blockIdx.z * S * rs;

  // q tile scaled in bf16 (the scale rounded to bf16 first), then rotated
  const float scale_t = __bfloat162float(__float2bfloat16_rn(scale));
  stage_rows_bf16<GNT, GQ, DP, LDQ>(Qs, base, q0, S, rs, h * d, d, true, scale_t, cos, sin);
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
  // a warp whose 16 rows all lie past the sequence still stages and syncs,
  // but skips the products
  const bool live = q0 + r0 < S;

  auto stage_k = [&](int k0) {
    stage_rows_bf16<GNT, GK, DP, LDQ>(Ks, base, k0, S, rs, w + h * d, d, false, 0.f, cos, sin);
  };
  // this warp's 16 x GK score block of one chunk: s[j] is keys 8j..8j+7,
  // c0/c1 row g keys 2t/2t+1, c2/c3 row g+8 (the mma accumulator layout)
  auto scores = [&](float (&s)[GK / 8][4], int k0) {
#pragma unroll
    for (int j = 0; j < GK / 8; ++j) {
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
  for (int k0 = 0; k0 < S; k0 += GK) {
    __syncthreads();
    stage_k(k0);
    __syncthreads();
    if (!live) continue;
    float s[GK / 8][4];
    scores(s, k0);
#pragma unroll
    for (int j = 0; j < GK / 8; ++j) {
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
  for (int k0 = 0; k0 < S; k0 += GK) {
    __syncthreads();
    stage_k(k0);
    stage_vt_bf16<GNT, GK, DP, LDV>(Vt, base, k0, S, rs, 2 * w + h * d, d);
    __syncthreads();
    if (!live) continue;
    float s[GK / 8][4];
    scores(s, k0);
    uint32_t pa[GK / 16][4];
#pragma unroll
    for (int j = 0; j < GK / 8; ++j) {
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
      for (int kk = 0; kk < GK / 16; ++kk)
        mma_bf16(o[n], pa[kk], ld32(vr + kk * 16), ld32(vr + kk * 16 + 8));
    }
  }
  if (!live) return;
  l0 += __shfl_xor_sync(0xffffffffu, l0, 1);
  l0 += __shfl_xor_sync(0xffffffffu, l0, 2);
  l1 += __shfl_xor_sync(0xffffffffu, l1, 1);
  l1 += __shfl_xor_sync(0xffffffffu, l1, 2);
  const float inv0 = 1.0f / l0, inv1 = 1.0f / l1;
  const int row0 = q0 + r0 + g, row1 = row0 + 8;
#pragma unroll
  for (int n = 0; n < DP / 8; ++n) {
    const int col = n * 8 + 2 * t;
    if (col >= d) continue;
    if (row0 < S)
      *reinterpret_cast<__nv_bfloat162*>(out + ((size_t)blockIdx.z * S + row0) * w + h * d + col) =
          __floats2bfloat162_rn(o[n][0] * inv0, o[n][1] * inv0);
    if (row1 < S)
      *reinterpret_cast<__nv_bfloat162*>(out + ((size_t)blockIdx.z * S + row1) * w + h * d + col) =
          __floats2bfloat162_rn(o[n][2] * inv1, o[n][3] * inv1);
  }
}

template <int DP>
int launch_mma(const void* qkv, void* out, int B, int S, int s_real, int w, int heads,
               float scale, const void* cos, const void* sin, cudaStream_t stream) {
  const size_t smem = mma_smem_bytes<DP>();
  cudaError_t err = cudaFuncSetAttribute(grouped_mma_kernel<DP>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((S + GQ - 1) / GQ, heads, B);
  grouped_mma_kernel<DP><<<grid, GNT, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(qkv), static_cast<__nv_bfloat16*>(out), S, s_real,
      w, w / heads, scale, static_cast<const __nv_bfloat16*>(cos),
      static_cast<const __nv_bfloat16*>(sin));
  return (int)cudaGetLastError();
}

int launch_bf16(const void* qkv, void* out, int B, int S, int s_real, int w, int heads,
                float scale, const void* cos, const void* sin, cudaStream_t stream) {
  const int d = w / heads;
  if (d % 8 != 0) return (int)cudaErrorInvalidValue;  // 16-byte row loads
  if (cos != nullptr && d % 16 != 0) return (int)cudaErrorInvalidValue;  // paired half vectors
  if (d <= 64) return launch_mma<64>(qkv, out, B, S, s_real, w, heads, scale, cos, sin, stream);
  if (d <= 80) return launch_mma<80>(qkv, out, B, S, s_real, w, heads, scale, cos, sin, stream);
  if (d <= 96) return launch_mma<96>(qkv, out, B, S, s_real, w, heads, scale, cos, sin, stream);
  if (d <= 112)
    return launch_mma<112>(qkv, out, B, S, s_real, w, heads, scale, cos, sin, stream);
  return launch_mma<128>(qkv, out, B, S, s_real, w, heads, scale, cos, sin, stream);
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16. cos, sin: RoPE tables [S, d/2] of the
// same dtype (half-split pairs), or both null for no rotation. Returns
// cudaGetLastError() of the launch.
int packed_attention_grouped(const void* qkv, void* out, int dtype, int B, int S, int s_real,
                             int w, int heads, float scale, const void* cos, const void* sin,
                             void* stream) {
  if (heads <= 0 || w % heads != 0 || w / heads > DMAX || s_real < 1 || s_real > S ||
      (cos == nullptr) != (sin == nullptr) || (cos != nullptr && (w / heads) % 2 != 0))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch_f32_3xtf32<8>(packed_heads<float>(qkv, out, S, w, w / heads), B, S, s_real,
                                heads, w / heads, scale, cos, sin, st);
  if (dtype == 1) return launch_bf16(qkv, out, B, S, s_real, w, heads, scale, cos, sin, st);
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
