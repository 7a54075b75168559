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
// Design: K3's kernel (packed_attention_q8s.cu) with one scale per token in
// place of K3's per-channel scales, and K1's ending (packed_attention.cu):
// one block of four warps per (64 query rows, head, batch item); each warp
// owns 16 rows and keeps its q fragments, scores and output accumulators in
// registers, with mma.sync m16n8k16 (bf16 in, f32 accumulate) for both
// products. K, and V transposed, stream through shared memory in 64-key
// chunks; each row is read as 8-byte int8 vectors (a head slice starts at
// h·d bytes, only 8-byte aligned for d = 72) and dequantized to bf16 with its
// token's scale on the way into shared memory. The two-pass softmax
// recomputes the scores instead of storing them: pass 1 takes the row max,
// pass 2 recomputes the identical scores and exponentiates against the final
// max. The head dim is zero-padded to a multiple of 16 for the Q·K^T
// k-steps.

#include "attention_common.cuh"

namespace {

constexpr int MQ = 64;    // query rows per block (4 warps x 16)
constexpr int MK = 64;    // keys per streamed chunk
constexpr int MNT = 128;  // threads per block
constexpr int DMAX = 128; // largest head dim

// eight int8 channels of one token → eight bf16(f32(q) * sc) values
__device__ __forceinline__ uint4 dequant8(uint2 raw, float sc) {
  const int8_t* e = reinterpret_cast<const int8_t*>(&raw);
  uint4 v;
  __nv_bfloat16* o = reinterpret_cast<__nv_bfloat16*>(&v);
#pragma unroll
  for (int j = 0; j < 8; ++j) o[j] = __float2bfloat16_rn(__fmul_rn((float)e[j], sc));
  return v;
}

template <typename TO> __device__ __forceinline__ void store2(TO* p, float a, float b);
template <> __device__ __forceinline__ void store2<float>(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}
template <> __device__ __forceinline__ void store2<__nv_bfloat16>(__nv_bfloat16* p, float a,
                                                                 float b) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
}

template <int DP>  // head dim padded to a multiple of 16
constexpr size_t smem_bytes() {
  return sizeof(__nv_bfloat16) * ((size_t)(MQ + MK) * (DP + PAD) + (size_t)DP * (MK + PAD));
}

template <int DP, typename TO>
__global__ void __launch_bounds__(MNT) q8_kernel(
    const int8_t* __restrict__ qkv, const float* __restrict__ tok_scale, TO* __restrict__ out,
    int S, int s_real, int w, int d, float scale) {
  constexpr int LDQ = DP + PAD;  // row stride of Qs and Ks
  constexpr int LDV = MK + PAD;  // row stride of Vt
  constexpr int NV = DP / 8;     // 8-channel vectors per padded head row
  extern __shared__ __align__(16) unsigned char q8_smem[];
  __nv_bfloat16* Qs = reinterpret_cast<__nv_bfloat16*>(q8_smem);  // [MQ][LDQ]
  __nv_bfloat16* Ks = Qs + MQ * LDQ;                               // [MK][LDQ]
  __nv_bfloat16* Vt = Ks + MK * LDQ;                               // [DP][LDV], V^T

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, t = lane % 4;  // mma fragment coordinates
  const int q0 = blockIdx.x * MQ, h = blockIdx.y;
  const size_t rs = 3 * (size_t)w;
  const int8_t* base = qkv + (size_t)blockIdx.z * S * rs;
  const float* ts = tok_scale + (size_t)blockIdx.z * S;
  const int dv = d / 8;
  const uint4 zero = make_uint4(0, 0, 0, 0);

  // q tile dequantized with ts * scale (formed first, in float32, as the TPU
  // kernel's rs * scale), zero-padded past d and past S
  for (int idx = tid; idx < MQ * NV; idx += MNT) {
    const int r = idx / NV, c8 = idx % NV;
    uint4 v = zero;
    if (q0 + r < S && c8 < dv)
      v = dequant8(*reinterpret_cast<const uint2*>(base + (size_t)(q0 + r) * rs + h * d + c8 * 8),
                   __fmul_rn(ts[q0 + r], scale));
    *reinterpret_cast<uint4*>(Qs + r * LDQ + c8 * 8) = v;
  }
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

  auto load_k = [&](int k0) {
    for (int idx = tid; idx < MK * NV; idx += MNT) {
      const int r = idx / NV, c8 = idx % NV;
      uint4 v = zero;
      if (k0 + r < S && c8 < dv)
        v = dequant8(
            *reinterpret_cast<const uint2*>(base + (size_t)(k0 + r) * rs + w + h * d + c8 * 8),
            ts[k0 + r]);
      *reinterpret_cast<uint4*>(Ks + r * LDQ + c8 * 8) = v;
    }
  };
  auto load_vt = [&](int k0) {
    for (int idx = tid; idx < MK * NV; idx += MNT) {
      const int r = idx % MK, c8 = idx / MK;  // key fastest: spread the transposed stores
      uint4 v = zero;
      if (k0 + r < S && c8 < dv)
        v = dequant8(
            *reinterpret_cast<const uint2*>(base + (size_t)(k0 + r) * rs + 2 * w + h * d + c8 * 8),
            ts[k0 + r]);
      const __nv_bfloat16* e = reinterpret_cast<const __nv_bfloat16*>(&v);
#pragma unroll
      for (int j = 0; j < 8; ++j) Vt[(c8 * 8 + j) * LDV + r] = e[j];
    }
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
    load_vt(k0);
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
#pragma unroll
  for (int n = 0; n < DP / 8; ++n) {
    const int col = n * 8 + 2 * t;
    if (col >= d) continue;
    const size_t i0 = ((size_t)blockIdx.z * S + row0) * w + h * d + col;
    if (row0 < S) store2<TO>(out + i0, o[n][0] * inv0, o[n][1] * inv0);
    if (row1 < S) store2<TO>(out + i0 + 8 * (size_t)w, o[n][2] * inv1, o[n][3] * inv1);
  }
}

template <int DP, typename TO>
int launch(const void* qkv, const void* ts, void* out, int B, int S, int s_real, int w,
           int heads, float scale, cudaStream_t stream) {
  const size_t smem = smem_bytes<DP>();
  cudaError_t err = cudaFuncSetAttribute(q8_kernel<DP, TO>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((S + MQ - 1) / MQ, heads, B);
  q8_kernel<DP, TO><<<grid, MNT, smem, stream>>>(
      static_cast<const int8_t*>(qkv), static_cast<const float*>(ts), static_cast<TO*>(out), S,
      s_real, w, w / heads, scale);
  return (int)cudaGetLastError();
}

template <typename TO>
int launch_d(const void* qkv, const void* ts, void* out, int B, int S, int s_real, int w,
             int heads, float scale, cudaStream_t st) {
  const int d = w / heads;
  if (d <= 64) return launch<64, TO>(qkv, ts, out, B, S, s_real, w, heads, scale, st);
  if (d <= 80) return launch<80, TO>(qkv, ts, out, B, S, s_real, w, heads, scale, st);
  if (d <= 96) return launch<96, TO>(qkv, ts, out, B, S, s_real, w, heads, scale, st);
  if (d <= 112) return launch<112, TO>(qkv, ts, out, B, S, s_real, w, heads, scale, st);
  return launch<128, TO>(qkv, ts, out, B, S, s_real, w, heads, scale, st);
}

}  // namespace

extern "C" {

// int8 qkv [B, S, 3w], float32 ts [B, S] → out [B, S, w] of out_dtype
// (0 = float32, 1 = bfloat16). Returns cudaGetLastError() of the launch.
int packed_attention_q8(const void* qkv, const void* ts, void* out, int out_dtype, int B, int S,
                        int s_real, int w, int heads, float scale, void* stream) {
  if (heads <= 0 || w % heads != 0 || s_real < 1 || s_real > S) return (int)cudaErrorInvalidValue;
  const int d = w / heads;
  if (d % 8 != 0 || d > DMAX) return (int)cudaErrorInvalidValue;  // 8-byte row loads
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (out_dtype == 0) return launch_d<float>(qkv, ts, out, B, S, s_real, w, heads, scale, st);
  if (out_dtype == 1)
    return launch_d<__nv_bfloat16>(qkv, ts, out, B, S, s_real, w, heads, scale, st);
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
