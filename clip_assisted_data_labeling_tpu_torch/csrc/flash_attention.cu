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
// bfloat16: flash_mma_kernel. One block of four warps per (64 query rows,
// head, batch item); each warp owns 16 rows and keeps its q fragments, scores
// and output accumulators in registers, with mma.sync m16n8k16 (bf16 in, f32
// accumulate) for both products; K, and V transposed, stream through shared
// memory in 64-key chunks read in place with head strides (16-byte loads).
// Within each panel an exact two-pass over its chunks: pass 1 takes the
// panel's row max, pass 2 recomputes the identical scores, rescales the
// running sum and accumulators once by alpha, and exponentiates against the
// new max. A chunk that crosses a panel end masks the keys past it. The head
// dim is zero-padded to a multiple of 16 (72 → 80) for the Q·K^T k-steps.
//
// RoPE: the q tile is rotated once as it is staged, and each K chunk as it
// is staged, in both passes of its panel — in bf16 a 16-byte vector of a
// row's first half with its partner in the second half, with bf16x2
// round-to-nearest products and sums, as in K1 and K4 (d % 16 == 0). The
// rotation adds no pass and no synchronisation; its cost is the table loads
// and the two extra staging rotations of each K chunk.
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

// ---- bfloat16: tensor-core kernel ------------------------------------------

constexpr int MQ = 64;    // query rows per block (4 warps x 16)
constexpr int MK = 64;    // keys per streamed chunk
constexpr int MNT = 128;  // threads per block

__device__ __forceinline__ float quad_max(float v) {
  v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 1));
  return fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 2));
}

__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
}

template <int DP>  // head dim padded to a multiple of 16
constexpr size_t mma_smem_bytes() {
  return sizeof(__nv_bfloat16) * ((size_t)(MQ + MK) * (DP + PAD) + (size_t)DP * (MK + PAD));
}

template <int DP>
__global__ void __launch_bounds__(MNT) flash_mma_kernel(
    const __nv_bfloat16* __restrict__ qkv, __nv_bfloat16* __restrict__ out, int S,
    int s_real, int w, int d, float scale, int kp, const __nv_bfloat16* __restrict__ cos,
    const __nv_bfloat16* __restrict__ sin) {
  constexpr int LDQ = DP + PAD;  // row stride of Qs and Ks
  constexpr int LDV = MK + PAD;  // row stride of Vt
  extern __shared__ __align__(16) unsigned char mma_smem[];
  __nv_bfloat16* Qs = reinterpret_cast<__nv_bfloat16*>(mma_smem);  // [MQ][LDQ]
  __nv_bfloat16* Ks = Qs + MQ * LDQ;                                // [MK][LDQ]
  __nv_bfloat16* Vt = Ks + MK * LDQ;                                // [DP][LDV], V^T

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, t = lane % 4;  // mma fragment coordinates
  const int q0 = blockIdx.x * MQ, h = blockIdx.y;
  const size_t rs = 3 * (size_t)w;
  const __nv_bfloat16* base = qkv + (size_t)blockIdx.z * S * rs;

  // q tile scaled in bf16 (the scale itself rounded to bf16 first), then
  // rotated; zero-padded past d and past S
  const float scale_t = __bfloat162float(__float2bfloat16_rn(scale));
  stage_rows_bf16<MNT, MQ, DP, LDQ>(Qs, base, q0, S, rs, h * d, d, true, scale_t, cos, sin);
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

  // keys at or past `pend` (the panel's end) load as zeros; k is rotated
  // (not scaled) as it is staged
  auto load_k = [&](int k0, int pend) {
    stage_rows_bf16<MNT, MK, DP, LDQ>(Ks, base, k0, pend, rs, w + h * d, d, false, 0.f, cos,
                                      sin);
  };
  auto load_vt = [&](int k0, int pend) {
    stage_vt_bf16<MNT, MK, DP, LDV>(Vt, base, k0, pend, rs, 2 * w + h * d, d);
  };
  // this warp's 16 x MK score block of one chunk: s[j] is keys 8j..8j+7,
  // c0/c1 row g keys 2t/2t+1, c2/c3 row g+8 (the mma accumulator layout);
  // keys at or past `kend` get -inf
  auto scores = [&](float (&s)[MK / 8][4], int k0, int kend) {
#pragma unroll
    for (int j = 0; j < MK / 8; ++j) {
      s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
      const __nv_bfloat16* kr = Ks + (j * 8 + g) * LDQ + 2 * t;
#pragma unroll
      for (int ks = 0; ks < DP / 16; ++ks)
        mma_bf16(s[j], qa[ks], ld32(kr + ks * 16), ld32(kr + ks * 16 + 8));
      const int key = k0 + j * 8 + 2 * t;
      if (key >= kend) s[j][0] = s[j][2] = -INFINITY;
      if (key + 1 >= kend) s[j][1] = s[j][3] = -INFINITY;
    }
  };

  float m0 = -INFINITY, m1 = -INFINITY;  // running max, rows g and g+8
  float l0 = 0.f, l1 = 0.f;              // this thread's share of the running sums
  float o[DP / 8][4];
#pragma unroll
  for (int n = 0; n < DP / 8; ++n) o[n][0] = o[n][1] = o[n][2] = o[n][3] = 0.f;

  for (int p0 = 0; p0 < S; p0 += kp) {
    const int pend = min(p0 + kp, S), kend = min(pend, s_real);
    // --- pass 1: the panel's row max ----------------------------------------
    float pm0 = -INFINITY, pm1 = -INFINITY;
    for (int k0 = p0; k0 < pend; k0 += MK) {
      __syncthreads();
      load_k(k0, pend);
      __syncthreads();
      float s[MK / 8][4];
      scores(s, k0, kend);
#pragma unroll
      for (int j = 0; j < MK / 8; ++j) {
        pm0 = fmaxf(pm0, fmaxf(s[j][0], s[j][1]));
        pm1 = fmaxf(pm1, fmaxf(s[j][2], s[j][3]));
      }
    }
    const float mn0 = fmaxf(m0, quad_max(pm0)), mn1 = fmaxf(m1, quad_max(pm1));
    const float a0 = expf(m0 - mn0), a1 = expf(m1 - mn1);
    l0 *= a0;
    l1 *= a1;
#pragma unroll
    for (int n = 0; n < DP / 8; ++n) {
      o[n][0] *= a0;
      o[n][1] *= a0;
      o[n][2] *= a1;
      o[n][3] *= a1;
    }
    // --- pass 2: recompute scores, P = bf16(exp(s - m')), O += P V -----------
    for (int k0 = p0; k0 < pend; k0 += MK) {
      __syncthreads();
      load_k(k0, pend);
      load_vt(k0, pend);
      __syncthreads();
      float s[MK / 8][4];
      scores(s, k0, kend);
      uint32_t pa[MK / 16][4];
#pragma unroll
      for (int j = 0; j < MK / 8; ++j) {
        const float p0v = expf(s[j][0] - mn0), p1v = expf(s[j][1] - mn0);
        const float p2v = expf(s[j][2] - mn1), p3v = expf(s[j][3] - mn1);
        l0 += p0v;
        l0 += p1v;
        l1 += p2v;
        l1 += p3v;
        pa[j / 2][(j % 2) * 2] = pack_bf16(p0v, p1v);
        pa[j / 2][(j % 2) * 2 + 1] = pack_bf16(p2v, p3v);
      }
#pragma unroll
      for (int n = 0; n < DP / 8; ++n) {
        const __nv_bfloat16* vr = Vt + (n * 8 + g) * LDV + 2 * t;
#pragma unroll
        for (int kk = 0; kk < MK / 16; ++kk)
          mma_bf16(o[n], pa[kk], ld32(vr + kk * 16), ld32(vr + kk * 16 + 8));
      }
    }
    m0 = mn0;
    m1 = mn1;
  }
  l0 = quad_sum(l0);
  l1 = quad_sum(l1);
  const int row0 = q0 + r0 + g, row1 = row0 + 8;
#pragma unroll
  for (int n = 0; n < DP / 8; ++n) {
    const int col = n * 8 + 2 * t;
    if (col >= d) continue;
    if (row0 < S)
      *reinterpret_cast<__nv_bfloat162*>(out + ((size_t)blockIdx.z * S + row0) * w + h * d + col) =
          __floats2bfloat162_rn(o[n][0] / l0, o[n][1] / l0);
    if (row1 < S)
      *reinterpret_cast<__nv_bfloat162*>(out + ((size_t)blockIdx.z * S + row1) * w + h * d + col) =
          __floats2bfloat162_rn(o[n][2] / l1, o[n][3] / l1);
  }
}

template <int DP>
int launch_mma(const void* qkv, void* out, int B, int S, int s_real, int w, int heads,
               float scale, int kp, const void* cos, const void* sin, cudaStream_t stream) {
  const size_t smem = mma_smem_bytes<DP>();
  cudaError_t err = cudaFuncSetAttribute(flash_mma_kernel<DP>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((S + MQ - 1) / MQ, heads, B);
  flash_mma_kernel<DP><<<grid, MNT, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(qkv), static_cast<__nv_bfloat16*>(out), S, s_real,
      w, w / heads, scale, kp, static_cast<const __nv_bfloat16*>(cos),
      static_cast<const __nv_bfloat16*>(sin));
  return (int)cudaGetLastError();
}

int launch_bf16(const void* qkv, void* out, int B, int S, int s_real, int w, int heads,
                float scale, int kp, const void* cos, const void* sin, cudaStream_t stream) {
  const int d = w / heads;
  if (d % 8 != 0) return (int)cudaErrorInvalidValue;  // 16-byte row loads
  if (cos != nullptr && d % 16 != 0) return (int)cudaErrorInvalidValue;  // paired half vectors
  if (d <= 64)
    return launch_mma<64>(qkv, out, B, S, s_real, w, heads, scale, kp, cos, sin, stream);
  if (d <= 80)
    return launch_mma<80>(qkv, out, B, S, s_real, w, heads, scale, kp, cos, sin, stream);
  if (d <= 96)
    return launch_mma<96>(qkv, out, B, S, s_real, w, heads, scale, kp, cos, sin, stream);
  if (d <= 112)
    return launch_mma<112>(qkv, out, B, S, s_real, w, heads, scale, kp, cos, sin, stream);
  return launch_mma<128>(qkv, out, B, S, s_real, w, heads, scale, kp, cos, sin, stream);
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16; kp: keys per panel. cos, sin: RoPE
// tables [S, d/2] of the same dtype (half-split pairs), or both null for no
// rotation. Returns cudaGetLastError() of the launch.
int flash_attention(const void* qkv, void* out, int dtype, int B, int S, int s_real, int w,
                    int heads, float scale, int kp, const void* cos, const void* sin,
                    void* stream) {
  if (heads <= 0 || w % heads != 0 || w / heads > DMAX || s_real < 1 || s_real > S || kp < 1 ||
      (cos == nullptr) != (sin == nullptr) || (cos != nullptr && (w / heads) % 2 != 0))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch_f32_3xtf32<F32_WARPS, true>(packed_heads<float>(qkv, out, S, w, w / heads), B,
                                              S, s_real, heads, w / heads, scale, cos, sin, st,
                                              kp);
  if (dtype == 1) return launch_bf16(qkv, out, B, S, s_real, w, heads, scale, kp, cos, sin, st);
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
