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
// Design: K1's bfloat16 kernel (csrc/packed_attention.cu) with int8 loads.
// One block of four warps per (64 query rows, head, batch item); each warp
// owns 16 rows and keeps its q fragments, scores and output accumulators in
// registers, with mma.sync m16n8k16 (bf16 in, f32 accumulate) for both
// products. K, and V transposed, stream through shared memory in 64-key
// chunks; the dequantize to bf16 happens on the way into shared memory, with
// the head's 3·d channel scales held in shared memory. An int8 head slice
// starts at h·72 bytes, only 8-byte aligned, so rows are read as 8-byte
// vectors. The two-pass softmax recomputes the scores instead of storing
// them: pass 1 takes the row max, pass 2 recomputes the identical scores
// (same mma sequence on the same data) and exponentiates against the final
// max. The head dim is zero-padded to a multiple of 16 (72 → 80) in both q
// and k for the Q·K^T k-steps; P·V runs 9 n8 tiles for d=72 (10 computed).

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int MQ = 64;    // query rows per block (4 warps x 16)
constexpr int MK = 64;    // keys per streamed chunk
constexpr int MNT = 128;  // threads per block
constexpr int PAD = 8;    // bf16 elements of padding per shared-memory row
constexpr int DMAX = 128; // largest head dim

__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t ld32(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// eight int8 channels → eight bf16(f32(q) * scale) values
__device__ __forceinline__ uint4 dequant8(uint2 raw, const float* scale) {
  const int8_t* e = reinterpret_cast<const int8_t*>(&raw);
  uint4 v;
  __nv_bfloat16* o = reinterpret_cast<__nv_bfloat16*>(&v);
#pragma unroll
  for (int j = 0; j < 8; ++j) o[j] = __float2bfloat16_rn(__fmul_rn((float)e[j], scale[j]));
  return v;
}

__device__ __forceinline__ int8_t requant(float x) {
  return (int8_t)fminf(fmaxf(rintf(x), -127.f), 127.f);
}

template <int DP>  // head dim padded to a multiple of 16
constexpr size_t smem_bytes() {
  return sizeof(__nv_bfloat16) * ((size_t)(MQ + MK) * (DP + PAD) + (size_t)DP * (MK + PAD)) +
         sizeof(float) * 3 * DP;
}

template <int DP>
__global__ void __launch_bounds__(MNT) q8s_kernel(
    const int8_t* __restrict__ qkv, const float* __restrict__ cs, int8_t* __restrict__ out,
    int S, int s_real, int w, int d) {
  constexpr int LDQ = DP + PAD;  // row stride of Qs and Ks
  constexpr int LDV = MK + PAD;  // row stride of Vt
  constexpr int NV = DP / 8;     // 8-channel vectors per padded head row
  extern __shared__ __align__(16) unsigned char q8s_smem[];
  __nv_bfloat16* Qs = reinterpret_cast<__nv_bfloat16*>(q8s_smem);  // [MQ][LDQ]
  __nv_bfloat16* Ks = Qs + MQ * LDQ;                                // [MK][LDQ]
  __nv_bfloat16* Vt = Ks + MK * LDQ;                                // [DP][LDV], V^T
  float* scs = reinterpret_cast<float*>(Vt + DP * LDV);             // [3][DP] head scales

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, t = lane % 4;  // mma fragment coordinates
  const int q0 = blockIdx.x * MQ, h = blockIdx.y;
  const size_t rs = 3 * (size_t)w;
  const int8_t* base = qkv + (size_t)blockIdx.z * S * rs;
  const int dv = d / 8;
  const uint4 zero = make_uint4(0, 0, 0, 0);

  for (int i = tid; i < 3 * DP; i += MNT) {
    const int sec = i / DP, c = i - sec * DP;
    scs[i] = c < d ? cs[sec * w + h * d + c] : 0.f;
  }
  __syncthreads();

  // q tile, dequantized (the attention scale is folded into its channel
  // scales), zero-padded past d and past S
  for (int idx = tid; idx < MQ * NV; idx += MNT) {
    const int r = idx / NV, c8 = idx % NV;
    uint4 v = zero;
    if (q0 + r < S && c8 < dv)
      v = dequant8(*reinterpret_cast<const uint2*>(base + (size_t)(q0 + r) * rs + h * d + c8 * 8),
                   scs + c8 * 8);
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
            scs + DP + c8 * 8);
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
            scs + 2 * DP + c8 * 8);
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
  const int row0 = q0 + r0 + g, row1 = row0 + 8;
#pragma unroll
  for (int n = 0; n < DP / 8; ++n) {
    const int col = n * 8 + 2 * t;
    if (col >= d) continue;
    if (row0 < S) {
      char2 c;
      c.x = requant(o[n][0] / l0);
      c.y = requant(o[n][1] / l0);
      *reinterpret_cast<char2*>(out + ((size_t)blockIdx.z * S + row0) * w + h * d + col) = c;
    }
    if (row1 < S) {
      char2 c;
      c.x = requant(o[n][2] / l1);
      c.y = requant(o[n][3] / l1);
      *reinterpret_cast<char2*>(out + ((size_t)blockIdx.z * S + row1) * w + h * d + col) = c;
    }
  }
}

template <int DP>
int launch(const void* qkv, const void* cs, void* out, int B, int S, int s_real, int w,
           int heads, cudaStream_t stream) {
  const size_t smem = smem_bytes<DP>();
  cudaError_t err = cudaFuncSetAttribute(q8s_kernel<DP>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((S + MQ - 1) / MQ, heads, B);
  q8s_kernel<DP><<<grid, MNT, smem, stream>>>(
      static_cast<const int8_t*>(qkv), static_cast<const float*>(cs),
      static_cast<int8_t*>(out), S, s_real, w, w / heads);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// int8 qkv [B, S, 3w], float32 cs [3w] → int8 out [B, S, w]. Returns
// cudaGetLastError() of the launch.
int packed_attention_q8s(const void* qkv, const void* cs, void* out, int B, int S, int s_real,
                         int w, int heads, void* stream) {
  if (heads <= 0 || w % heads != 0 || s_real < 1 || s_real > S) return (int)cudaErrorInvalidValue;
  const int d = w / heads;
  if (d % 8 != 0 || d > DMAX) return (int)cudaErrorInvalidValue;  // 8-byte row loads
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (d <= 64) return launch<64>(qkv, cs, out, B, S, s_real, w, heads, st);
  if (d <= 80) return launch<80>(qkv, cs, out, B, S, s_real, w, heads, st);
  if (d <= 96) return launch<96>(qkv, cs, out, B, S, s_real, w, heads, st);
  if (d <= 112) return launch<112>(qkv, cs, out, B, S, s_real, w, heads, st);
  return launch<128>(qkv, cs, out, B, S, s_real, w, heads, st);
}

}  // extern "C"
