// Packed multi-head softmax attention for Hopper (sm_90a), plain C interface.
//
// Replaces the TPU kernel _packed_kernel / fused_attention_packed
// (clip_assisted_data_labeling_tpu/ops/attention.py, pallas_call at :1124).
//
// Computes, for qkv packed [B, S, 3w] exactly as the qkv projection wrote it
// (head h's q, k, v are the column slices h*d, w + h*d, 2w + h*d):
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
// What bounds it: at ViT-L-336 shapes (S=577, d=64) the work is ~4·B·H·S²·d
// FLOPs against ~B·S·4w·sizeof(T) bytes — ~290 FLOP/byte in bf16, right at
// the H100's ridge (~295), so both the tensor-core rate and device memory
// bound it about equally; float32 has no tensor-core path that keeps float32
// products (TF32 would round them), so it is bound by the CUDA-core FMA rate.
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
// float32: packed_attention_kernel. One block per (16 query rows, head,
// batch item) keeps the tile's whole score block [16, S] in shared memory
// (40 KB at S=577) and runs both products as float32 FMAs over K^T and V
// chunks streamed through shared memory. Sequences whose score tile
// overflows the 227 KB a block may use are refused (the wrapper checks);
// K4 (packed_attention_grouped.cu) streams the keys instead.

#include "attention_common.cuh"

namespace {

constexpr int QT = 16;    // query rows per block
constexpr int KT = 64;    // keys per streamed chunk
constexpr int NT = 256;   // threads per block
constexpr int DMAX = 128; // largest head dim
constexpr int EPT = QT * DMAX / NT;      // output elements per thread (max)
constexpr int RPT = QT / (NT / KT);      // score rows per thread

template <typename T>
__global__ void __launch_bounds__(NT) packed_attention_kernel(
    const T* __restrict__ qkv, T* __restrict__ out, int S, int s_real, int w,
    int d, float scale, int s_chunks, const T* __restrict__ cos, const T* __restrict__ sin) {
  extern __shared__ float smem[];
  const int s_pad = s_chunks * KT;
  float* q_s = smem;                  // [QT][d]  scaled (and rotated) q
  float* kv_s = q_s + QT * d;         // K^T chunk [d][KT+1], then V chunk [KT][d]
  float* sc = kv_s + d * (KT + 1);    // [QT][s_pad] scores, then P
  float* inv_s = sc + QT * s_pad;     // [QT] 1/sum

  const int tid = threadIdx.x;
  const int q0 = blockIdx.x * QT;
  const int h = blockIdx.y;
  const size_t row_stride = 3 * (size_t)w;
  const T* base = qkv + (size_t)blockIdx.z * S * row_stride;

  // q * scale in the input type (the scale itself rounded to T first), then
  // rotated; k is rotated as each chunk is staged
  const float scale_t = to_f(from_f<T>(scale));
  stage_rows_f<T, NT, QT>(q_s, d, 1, base, q0, S, row_stride, h * d, d, true, scale_t, cos,
                          sin);

  // --- pass 1: scores = q' k^T over streamed key chunks -------------------
  const int kk = tid % KT;    // this thread's key within the chunk
  const int rg = tid / KT;    // this thread's group of RPT rows
  for (int c = 0; c < s_chunks; ++c) {
    const int k0 = c * KT;
    __syncthreads();  // kv_s free (and q_s written, on the first chunk)
    stage_rows_f<T, NT, KT>(kv_s, 1, KT + 1, base, k0, S, row_stride, w + h * d, d, false,
                            0.f, cos, sin);
    __syncthreads();
    float acc[RPT];
#pragma unroll
    for (int j = 0; j < RPT; ++j) acc[j] = 0.f;
    for (int i = 0; i < d; ++i) {
      const float kv = kv_s[i * (KT + 1) + kk];
#pragma unroll
      for (int j = 0; j < RPT; ++j) acc[j] = fmaf(q_s[(rg * RPT + j) * d + i], kv, acc[j]);
    }
    const int key = k0 + kk;
#pragma unroll
    for (int j = 0; j < RPT; ++j)
      sc[(rg * RPT + j) * s_pad + key] = key < s_real ? acc[j] : -INFINITY;
  }
  __syncthreads();

  // --- softmax rows: max, exp, sum in float32; P rounded to T -------------
  const int warp = tid / 32, lane = tid % 32;
  for (int r = warp; r < QT; r += NT / 32) {
    float* row = sc + r * s_pad;
    float m = -INFINITY;
    for (int k = lane; k < S; k += 32) m = fmaxf(m, row[k]);
    m = warp_max(m);
    float sum = 0.f;
    for (int k = lane; k < S; k += 32) {
      const float p = expf(row[k] - m);
      sum += p;
      row[k] = to_f(from_f<T>(p));
    }
    sum = warp_sum(sum);
    if (lane == 0) inv_s[r] = 1.0f / sum;
  }

  // --- pass 2: out = P v over streamed value chunks -----------------------
  int er[EPT], ei[EPT];
  float acc[EPT];
#pragma unroll
  for (int j = 0; j < EPT; ++j) {
    const int e = tid + j * NT;
    er[j] = e / d;
    ei[j] = e - er[j] * d;
    acc[j] = 0.f;
  }
  const int n_out = QT * d;
  for (int c = 0; c < s_chunks; ++c) {
    const int k0 = c * KT;
    __syncthreads();  // kv_s free, P complete
    for (int idx = tid; idx < KT * d; idx += NT) {
      const int kr = idx / d, i = idx - (idx / d) * d;
      const int key = k0 + kr;
      kv_s[idx] = key < S ? to_f(base[(size_t)key * row_stride + 2 * w + h * d + i]) : 0.f;
    }
    __syncthreads();
    const int kmax = min(KT, S - k0);
    for (int k = 0; k < kmax; ++k) {
#pragma unroll
      for (int j = 0; j < EPT; ++j) {
        if (tid + j * NT < n_out)
          acc[j] = fmaf(sc[er[j] * s_pad + k0 + k], kv_s[k * d + ei[j]], acc[j]);
      }
    }
  }
#pragma unroll
  for (int j = 0; j < EPT; ++j) {
    const int qi = q0 + er[j];
    if (tid + j * NT < n_out && qi < S)
      out[((size_t)blockIdx.z * S + qi) * w + h * d + ei[j]] = from_f<T>(acc[j] * inv_s[er[j]]);
  }
}

template <typename T>
int launch(const void* qkv, void* out, int B, int S, int s_real, int w, int heads,
           float scale, const void* cos, const void* sin, cudaStream_t stream) {
  const int d = w / heads;
  const int s_chunks = (S + KT - 1) / KT;
  const size_t smem = sizeof(float) *
      ((size_t)QT * d + (size_t)d * (KT + 1) + (size_t)QT * s_chunks * KT + QT);
  cudaError_t err = cudaFuncSetAttribute(packed_attention_kernel<T>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((S + QT - 1) / QT, heads, B);
  packed_attention_kernel<T><<<grid, NT, smem, stream>>>(
      static_cast<const T*>(qkv), static_cast<T*>(out), S, s_real, w, d, scale, s_chunks,
      static_cast<const T*>(cos), static_cast<const T*>(sin));
  return (int)cudaGetLastError();
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
    const __nv_bfloat16* __restrict__ qkv, void* __restrict__ out, int S,
    int s_real, int w, int d, float scale, const __nv_bfloat16* __restrict__ cos,
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

  // k rotated (not scaled) as each chunk is staged
  auto load_k = [&](int k0) {
    stage_rows_bf16<MNT, MK, DP, LDQ>(Ks, base, k0, S, rs, w + h * d, d, false, 0.f, cos, sin);
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
    stage_vt_bf16<MNT, MK, DP, LDV>(Vt, base, k0, S, rs, 2 * w + h * d, d);
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
    const size_t i1 = i0 + 8 * (size_t)w;
    const float y0 = o[n][0] * inv0, y1 = o[n][1] * inv0;
    const float y2 = o[n][2] * inv1, y3 = o[n][3] * inv1;
    if (F32OUT) {  // quant_out: the float32 head outputs, for the row quantize
      float* of = static_cast<float*>(out);
      if (row0 < S) *reinterpret_cast<float2*>(of + i0) = make_float2(y0, y1);
      if (row1 < S) *reinterpret_cast<float2*>(of + i1) = make_float2(y2, y3);
    } else {
      __nv_bfloat16* ob = static_cast<__nv_bfloat16*>(out);
      if (row0 < S) *reinterpret_cast<__nv_bfloat162*>(ob + i0) = __floats2bfloat162_rn(y0, y1);
      if (row1 < S) *reinterpret_cast<__nv_bfloat162*>(ob + i1) = __floats2bfloat162_rn(y2, y3);
    }
  }
}

template <int DP, bool F32OUT>
int launch_mma(const void* qkv, void* out, int B, int S, int s_real, int w, int heads,
               float scale, const void* cos, const void* sin, cudaStream_t stream) {
  const size_t smem = mma_smem_bytes<DP>();
  cudaError_t err = cudaFuncSetAttribute(packed_attention_mma_kernel<DP, F32OUT>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((S + MQ - 1) / MQ, heads, B);
  packed_attention_mma_kernel<DP, F32OUT><<<grid, MNT, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(qkv), out, S, s_real, w, w / heads, scale,
      static_cast<const __nv_bfloat16*>(cos), static_cast<const __nv_bfloat16*>(sin));
  return (int)cudaGetLastError();
}

template <bool F32OUT>
int launch_bf16(const void* qkv, void* out, int B, int S, int s_real, int w, int heads,
                float scale, const void* cos, const void* sin, cudaStream_t stream) {
  const int d = w / heads;
  if (d % 8 != 0) return (int)cudaErrorInvalidValue;  // 16-byte row loads
  if (cos != nullptr && d % 16 != 0) return (int)cudaErrorInvalidValue;  // paired half vectors
  if (d <= 64)
    return launch_mma<64, F32OUT>(qkv, out, B, S, s_real, w, heads, scale, cos, sin, stream);
  if (d <= 80)
    return launch_mma<80, F32OUT>(qkv, out, B, S, s_real, w, heads, scale, cos, sin, stream);
  if (d <= 96)
    return launch_mma<96, F32OUT>(qkv, out, B, S, s_real, w, heads, scale, cos, sin, stream);
  if (d <= 112)
    return launch_mma<112, F32OUT>(qkv, out, B, S, s_real, w, heads, scale, cos, sin, stream);
  return launch_mma<128, F32OUT>(qkv, out, B, S, s_real, w, heads, scale, cos, sin, stream);
}

}  // namespace

extern "C" {

// Shared memory the float32 kernel needs for sequence length S and head dim
// d; the wrapper refuses shapes above the 227 KB a block may use. (The
// bfloat16 kernel's ~28-53 KB does not depend on S.)
size_t packed_attention_smem_bytes(int S, int d) {
  const int s_chunks = (S + KT - 1) / KT;
  return sizeof(float) *
      ((size_t)QT * d + (size_t)d * (KT + 1) + (size_t)QT * s_chunks * KT + QT);
}

// dtype: 0 = float32, 1 = bfloat16. cos, sin: RoPE tables [S, d/2] of the
// same dtype (half-split pairs), or both null for no rotation. Returns
// cudaGetLastError() of the launch.
int packed_attention(const void* qkv, void* out, int dtype, int B, int S, int s_real,
                     int w, int heads, float scale, const void* cos, const void* sin,
                     void* stream) {
  if (heads <= 0 || w % heads != 0 || w / heads > DMAX || s_real < 1 || s_real > S ||
      (cos == nullptr) != (sin == nullptr) || (cos != nullptr && (w / heads) % 2 != 0))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return launch<float>(qkv, out, B, S, s_real, w, heads, scale, cos, sin, st);
  if (dtype == 1)
    return launch_bf16<false>(qkv, out, B, S, s_real, w, heads, scale, cos, sin, st);
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
  if (heads <= 0 || w % heads != 0 || w / heads > DMAX || s_real < 1 || s_real > S ||
      (cos == nullptr) != (sin == nullptr) || (cos != nullptr && (w / heads) % 2 != 0))
    return (int)cudaErrorInvalidValue;
  return launch_bf16<true>(qkv, out, B, S, s_real, w, heads, scale, cos, sin,
                           static_cast<cudaStream_t>(stream));
}

}  // extern "C"
