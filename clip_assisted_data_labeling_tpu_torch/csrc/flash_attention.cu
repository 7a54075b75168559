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
// float32 has no tensor-core path that keeps float32 products (TF32 would
// round them), so it is bound by the CUDA-core FMA rate.
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
// float32: flash_fma_kernel. One block per (16 query rows, head, batch item)
// keeps one panel's [16, kp] score tile in shared memory and runs both
// products as float32 FMAs over K^T and V chunks streamed through shared
// memory, with the running m, l and per-panel alpha in shared memory and the
// output accumulators in registers.

#include "attention_common.cuh"

namespace {

constexpr int QT = 16;    // query rows per float32 block
constexpr int KT = 64;    // keys per streamed chunk
constexpr int NT = 256;   // threads per float32 block
constexpr int DMAX = 128; // largest head dim
constexpr int EPT = QT * DMAX / NT;  // output elements per thread (max)
constexpr int RPT = QT / (NT / KT);  // score rows per thread

size_t fma_smem_bytes(int kp, int d) {
  const int kp_pad = (kp + KT - 1) / KT * KT;
  return sizeof(float) *
      ((size_t)QT * d + (size_t)d * (KT + 1) + (size_t)QT * kp_pad + 3 * QT);
}

template <typename T>
__global__ void __launch_bounds__(NT) flash_fma_kernel(
    const T* __restrict__ qkv, T* __restrict__ out, int S, int s_real, int w, int d,
    float scale, int kp, const T* __restrict__ cos, const T* __restrict__ sin) {
  extern __shared__ float smem[];
  const int kp_pad = (kp + KT - 1) / KT * KT;
  float* q_s = smem;                  // [QT][d]  scaled q
  float* kv_s = q_s + QT * d;         // K^T chunk [d][KT+1], then V chunk [KT][d]
  float* sc = kv_s + d * (KT + 1);    // [QT][kp_pad] panel scores, then P
  float* m_s = sc + QT * kp_pad;      // [QT] running max
  float* l_s = m_s + QT;              // [QT] running sum
  float* a_s = l_s + QT;              // [QT] this panel's alpha

  const int tid = threadIdx.x;
  const int q0 = blockIdx.x * QT;
  const int h = blockIdx.y;
  const size_t row_stride = 3 * (size_t)w;
  const T* base = qkv + (size_t)blockIdx.z * S * row_stride;

  const float scale_t = to_f(from_f<T>(scale));
  stage_rows_f<T, NT, QT>(q_s, d, 1, base, q0, S, row_stride, h * d, d, true, scale_t, cos,
                          sin);
  if (tid < QT) {
    m_s[tid] = -INFINITY;
    l_s[tid] = 0.f;
  }

  int er[EPT], ei[EPT];
  float acc[EPT];
  const int n_out = QT * d;
#pragma unroll
  for (int j = 0; j < EPT; ++j) {
    const int e = tid + j * NT;
    er[j] = e / d;
    ei[j] = e - er[j] * d;
    acc[j] = 0.f;
  }
  const int kk = tid % KT;  // this thread's key within a chunk
  const int rg = tid / KT;  // this thread's group of RPT rows
  const int warp = tid / 32, lane = tid % 32;

  for (int p0 = 0; p0 < S; p0 += kp) {
    const int pend = min(p0 + kp, S), kend = min(pend, s_real);
    // --- the panel's scores --------------------------------------------------
    for (int c0 = p0; c0 < pend; c0 += KT) {
      __syncthreads();  // kv_s free (q_s, m_s, l_s written on the first chunk)
      // K^T of keys [c0, c0 + KT), zero at or past the panel's end
      stage_rows_f<T, NT, KT>(kv_s, 1, KT + 1, base, c0, pend, row_stride, w + h * d, d, false,
                              0.f, cos, sin);
      __syncthreads();
      float s[RPT];
#pragma unroll
      for (int j = 0; j < RPT; ++j) s[j] = 0.f;
      for (int i = 0; i < d; ++i) {
        const float kv = kv_s[i * (KT + 1) + kk];
#pragma unroll
        for (int j = 0; j < RPT; ++j) s[j] = fmaf(q_s[(rg * RPT + j) * d + i], kv, s[j]);
      }
      const int key = c0 + kk;
      if (key < pend) {
#pragma unroll
        for (int j = 0; j < RPT; ++j)
          sc[(rg * RPT + j) * kp_pad + key - p0] = key < kend ? s[j] : -INFINITY;
      }
    }
    __syncthreads();

    // --- online softmax rows: new max, alpha, P = T(exp(s - m')), l -----------
    const int n = pend - p0;
    for (int r = warp; r < QT; r += NT / 32) {
      float* row = sc + r * kp_pad;
      float pm = -INFINITY;
      for (int k = lane; k < n; k += 32) pm = fmaxf(pm, row[k]);
      pm = warp_max(pm);
      const float m_old = m_s[r];
      const float m_new = fmaxf(m_old, pm);
      float sum = 0.f;
      for (int k = lane; k < n; k += 32) {
        const float p = expf(row[k] - m_new);
        sum += p;
        row[k] = to_f(from_f<T>(p));
      }
      sum = warp_sum(sum);
      if (lane == 0) {
        const float alpha = expf(m_old - m_new);
        l_s[r] = l_s[r] * alpha + sum;
        m_s[r] = m_new;
        a_s[r] = alpha;
      }
    }
    __syncthreads();
#pragma unroll
    for (int j = 0; j < EPT; ++j)
      if (tid + j * NT < n_out) acc[j] *= a_s[er[j]];

    // --- acc += P v over the panel's value chunks -----------------------------
    for (int c0 = p0; c0 < pend; c0 += KT) {
      __syncthreads();  // kv_s free
      for (int idx = tid; idx < KT * d; idx += NT) {
        const int kr = idx / d, i = idx - (idx / d) * d;
        const int key = c0 + kr;
        kv_s[idx] = key < pend ? to_f(base[(size_t)key * row_stride + 2 * w + h * d + i]) : 0.f;
      }
      __syncthreads();
      const int kmax = min(KT, pend - c0);
      for (int k = 0; k < kmax; ++k) {
#pragma unroll
        for (int j = 0; j < EPT; ++j) {
          if (tid + j * NT < n_out)
            acc[j] = fmaf(sc[er[j] * kp_pad + c0 - p0 + k], kv_s[k * d + ei[j]], acc[j]);
        }
      }
    }
  }
#pragma unroll
  for (int j = 0; j < EPT; ++j) {
    const int qi = q0 + er[j];
    if (tid + j * NT < n_out && qi < S)
      out[((size_t)blockIdx.z * S + qi) * w + h * d + ei[j]] = from_f<T>(acc[j] / l_s[er[j]]);
  }
}

template <typename T>
int launch_fma(const void* qkv, void* out, int B, int S, int s_real, int w, int heads,
               float scale, int kp, const void* cos, const void* sin, cudaStream_t stream) {
  const int d = w / heads;
  const size_t smem = fma_smem_bytes(kp, d);
  cudaError_t err = cudaFuncSetAttribute(flash_fma_kernel<T>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((S + QT - 1) / QT, heads, B);
  flash_fma_kernel<T><<<grid, NT, smem, stream>>>(
      static_cast<const T*>(qkv), static_cast<T*>(out), S, s_real, w, d, scale, kp,
      static_cast<const T*>(cos), static_cast<const T*>(sin));
  return (int)cudaGetLastError();
}

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

// Shared memory the float32 kernel needs for a kp-key panel at head dim d;
// the wrapper refuses shapes above the 227 KB a block may use. (The
// bfloat16 kernel's ~28-53 KB depends on neither.)
size_t flash_attention_smem_bytes(int kp, int d) { return fma_smem_bytes(kp, d); }

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
    return launch_fma<float>(qkv, out, B, S, s_real, w, heads, scale, kp, cos, sin, st);
  if (dtype == 1) return launch_bf16(qkv, out, B, S, s_real, w, heads, scale, kp, cos, sin, st);
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
