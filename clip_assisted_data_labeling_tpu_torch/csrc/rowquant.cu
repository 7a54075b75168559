// (LayerNorm | activation) + dynamic per-row int8 quantize for Hopper
// (sm_90a), plain C interface.
//
// Replaces the TPU kernel _rowquant_kernel / rowquant
// (clip_assisted_data_labeling_tpu/ops/quant_kernel.py, pallas_call at :390).
//
// Per row of x [M, K] (bf16 or f32), in float32:
//   y     = layernorm(x) with gamma, beta     only when gamma is given
//                                             (rowquant_common.cuh)
//   y     = act(y)                            0 none, 1 quick_gelu
//                                             y * (1 / (1 + exp(-1.702 y))),
//                                             2 gelu_tanh (each step rounded),
//                                             3 gelu: y * 0.5 * (1 + erf(y / √2))
//   amax  = max(max|y|, 1e-8)
//   q     = clip(rint(y * (127 / amax)), -127, 127)   round half to even
//   scale = amax * f32(1/127)
// Writes q [M, K] int8 and scale [M] f32. The activation's transcendental
// functions are CUDA's accurate expf/tanhf/erff (no fast-math), within an
// ulp or two of PyTorch's, so the int8 grid matches the plain version to
// ±1 on rare entries.
//
// With no layernorm and no activation this is also the quantize pass of K9
// (q_linear_fused.cu) and of K1's quant_out option: both wrappers call the
// same C entry, so the three round identically.
//
// What bounds it: ~10-20 FLOPs per element against sizeof(T) + 1 bytes:
// memory bound (the H100's ridge is ~295 FLOP/byte, ~20 for float32 CUDA-core
// work), so the design reads each row once and writes the int8 row once,
// with as many bytes in flight as the registers allow.
//
// Design: a group of WPR warps owns one row and holds it in registers, L
// 16-byte vector loads a lane; lane l of the group reads the row's vectors
// l, l + 32 * WPR, ..., so neighbouring lanes read neighbouring vectors. The
// layernorm's mean, its variance (a second pass over the registers) and the
// amax are warp shuffles; with WPR > 1 the group's warps add their totals
// through shared memory, in warp order, between two barriers. The int8 row
// goes out in 8-byte (bf16) or 4-byte (f32) stores. A 256-thread block holds
// 8 / WPR rows. The first schedule (WPR, L) of RQ_VEC_SCHEDULES whose
// 32 * WPR * L vectors hold the row runs it: one warp a row, and no block
// barrier, up to 128 vectors (ViT-L's 1024 in bf16), two warps up to 256
// (SO400M-384's 1152; 1024 in f32), eight warps of 2 or 4 loads up to 1024
// (4096 and 4304 in bf16). Rows that cannot take 16-byte loads (K * sizeof(T)
// % 16 != 0, or a pointer off 16 bytes; no path's shape) and longer rows
// (bf16 past 8192, f32 past 4096) take the staged schedule: one block a row,
// the row in shared memory as floats.
// The per-element arithmetic (ln_apply, act_f32, quant_i8, kInv127) is that
// of rowquant_common.cuh; only the order of the layernorm's sums differs from
// torch's (and from the staged schedule's).

#include <type_traits>

#include "rowquant_common.cuh"

namespace {

constexpr int RQ_THREADS = 256;  // 8 warps a block

// E = 16 / sizeof(T) consecutive values of T as floats, from one 16-byte load
template <typename T, int E>
__device__ __forceinline__ void load_vals(const T* __restrict__ p, float (&v)[E]) {
  static_assert(E * sizeof(T) == 16, "a vector is 16 bytes");
  const uint4 u = __ldg(reinterpret_cast<const uint4*>(p));
  if constexpr (std::is_same<T, float>::value) {
    v[0] = __uint_as_float(u.x);
    v[1] = __uint_as_float(u.y);
    v[2] = __uint_as_float(u.z);
    v[3] = __uint_as_float(u.w);
  } else {
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const float2 f = __bfloat1622float2(h[j]);
      v[2 * j] = f.x;
      v[2 * j + 1] = f.y;
    }
  }
}

// E float32 values (gamma, beta) from E / 4 16-byte loads
template <int E>
__device__ __forceinline__ void load_f32(const float* __restrict__ p, float (&v)[E]) {
#pragma unroll
  for (int j = 0; j < E / 4; ++j) {
    const float4 f = __ldg(reinterpret_cast<const float4*>(p) + j);
    v[4 * j] = f.x;
    v[4 * j + 1] = f.y;
    v[4 * j + 2] = f.z;
    v[4 * j + 3] = f.w;
  }
}

// E (4 or 8) int8 values in one store of E bytes
template <int E>
__device__ __forceinline__ void store_i8(int8_t* p, const int8_t (&q)[E]) {
  uint32_t w[E / 4];
#pragma unroll
  for (int j = 0; j < E / 4; ++j)
    w[j] = (uint32_t)(uint8_t)q[4 * j] | (uint32_t)(uint8_t)q[4 * j + 1] << 8 |
           (uint32_t)(uint8_t)q[4 * j + 2] << 16 | (uint32_t)(uint8_t)q[4 * j + 3] << 24;
  if constexpr (E == 4) *reinterpret_cast<uint32_t*>(p) = w[0];
  else *reinterpret_cast<uint2*>(p) = make_uint2(w[0], w[1]);
}

// Sum or max over the WPR warps of a row's group; every lane gets the
// result. The warps' totals are combined in warp order through red (one
// slot a warp of the block), between two barriers of the whole block.
template <int WPR, bool MAX>
__device__ __forceinline__ float group_reduce(float v, float* red) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    const float u = __shfl_xor_sync(0xffffffffu, v, o);
    v = MAX ? fmaxf(v, u) : v + u;
  }
  if constexpr (WPR == 1) {
    return v;
  } else {
    const int warp = threadIdx.x / 32;
    __syncthreads();  // red may still be read by the group's last reduction
    if (threadIdx.x % 32 == 0) red[warp] = v;
    __syncthreads();
    const int w0 = warp / WPR * WPR;
    float t = red[w0];
#pragma unroll
    for (int i = 1; i < WPR; ++i) t = MAX ? fmaxf(t, red[w0 + i]) : t + red[w0 + i];
    return t;
  }
}

template <typename T, int ACT, int WPR, int L, int E>
__global__ void __launch_bounds__(RQ_THREADS) rowquant_rows_kernel(
    const T* __restrict__ x, const float* __restrict__ gamma,
    const float* __restrict__ beta, int8_t* __restrict__ out, float* __restrict__ scale,
    int M, int K, float eps) {
  constexpr int G = 32 * WPR;       // lanes of a row's group
  __shared__ float red[RQ_THREADS / 32];
  const int gl = threadIdx.x % G;   // lane within the group
  const size_t row = (size_t)blockIdx.x * (RQ_THREADS / G) + threadIdx.x / G;
  const bool live = row < (size_t)M;
  if (WPR == 1 && !live) return;  // groups of one warp take no block barrier
  const int nv = K / E;           // vectors in the row (E divides K)
  const T* xr = x + row * K;

  // vector c = gl + i * G of the row is lane gl's i-th
  float v[L][E];
  float s = 0.f;
#pragma unroll
  for (int i = 0; i < L; ++i) {
    const int c = gl + i * G;
    if (live && c < nv) {
      load_vals<T, E>(xr + (size_t)c * E, v[i]);
#pragma unroll
      for (int e = 0; e < E; ++e) s += v[i][e];
    }
  }
  float mu = 0.f, rs = 0.f;
  if (gamma != nullptr) {
    mu = group_reduce<WPR, false>(s, red) / (float)K;
    float s2 = 0.f;
#pragma unroll
    for (int i = 0; i < L; ++i) {
      if (live && gl + i * G < nv) {
#pragma unroll
        for (int e = 0; e < E; ++e) {
          const float dv = v[i][e] - mu;
          s2 = fmaf(dv, dv, s2);
        }
      }
    }
    const float var = group_reduce<WPR, false>(s2, red) / (float)K;
    rs = 1.0f / sqrtf(var + eps);
  }
  float m = 0.f;
#pragma unroll
  for (int i = 0; i < L; ++i) {
    const int c = gl + i * G;
    if (live && c < nv) {
      float g[E], b[E];
      if (gamma != nullptr) {
        load_f32<E>(gamma + (size_t)c * E, g);
        load_f32<E>(beta + (size_t)c * E, b);
      }
#pragma unroll
      for (int e = 0; e < E; ++e) {
        float y = v[i][e];
        if (gamma != nullptr) y = ln_apply(y, mu, rs, g[e], b[e]);
        y = act_f32<ACT>(y);
        v[i][e] = y;
        m = fmaxf(m, fabsf(y));
      }
    }
  }
  const float amax = fmaxf(group_reduce<WPR, true>(m, red), 1e-8f);
  if (!live) return;
  const float inv = 127.0f / amax;
  int8_t* orow = out + row * K;
#pragma unroll
  for (int i = 0; i < L; ++i) {
    const int c = gl + i * G;
    if (c < nv) {
      int8_t q[E];
#pragma unroll
      for (int e = 0; e < E; ++e) q[e] = quant_i8(v[i][e], inv);
      store_i8<E>(orow + (size_t)c * E, q);
    }
  }
  if (gl == 0) scale[row] = __fmul_rn(amax, kInv127);
}

// Rows longer than 8 warps' registers hold, or that cannot take 16-byte
// loads: one block a row, the row staged in shared memory as floats (K * 4
// bytes, within SMEM_LIMIT).
template <typename T, int ACT>
__global__ void __launch_bounds__(NT) rowquant_staged_kernel(
    const T* __restrict__ x, const float* __restrict__ gamma,
    const float* __restrict__ beta, int8_t* __restrict__ out, float* __restrict__ scale,
    int K, float eps) {
  extern __shared__ float xs[];  // [K]
  __shared__ float red[NT / 32];
  const size_t row = blockIdx.x;
  const float s = stage_row(x + row * K, xs, K);
  float mu = 0.f, rs = 0.f;
  if (gamma != nullptr) ln_stats(xs, K, s, eps, red, mu, rs);
  // each thread rewrites only the entries it staged: no barrier needed
  float m = 0.f;
  for (int k = threadIdx.x; k < K; k += NT) {
    float y = xs[k];
    if (gamma != nullptr) y = ln_apply(y, mu, rs, gamma[k], beta[k]);
    y = act_f32<ACT>(y);
    xs[k] = y;
    m = fmaxf(m, fabsf(y));
  }
  const float amax = fmaxf(block_max(m, red), 1e-8f);
  const float inv = 127.0f / amax;
  int8_t* orow = out + row * K;
  for (int k = threadIdx.x; k < K; k += NT) orow[k] = quant_i8(xs[k], inv);
  if (threadIdx.x == 0) scale[row] = __fmul_rn(amax, kInv127);
}

template <typename T, int ACT, int WPR, int L, int E>
int launch_rows(const void* x, const float* gamma, const float* beta, int8_t* out,
                float* scale, int M, int K, float eps, cudaStream_t stream) {
  constexpr int rows_per_block = RQ_THREADS / (32 * WPR);
  const int grid = (M + rows_per_block - 1) / rows_per_block;
  rowquant_rows_kernel<T, ACT, WPR, L, E><<<grid, RQ_THREADS, 0, stream>>>(
      static_cast<const T*>(x), gamma, beta, out, scale, M, K, eps);
  return (int)cudaGetLastError();
}

// The schedules (WPR, L) in the order they are tried: the first whose
// 32 * WPR * L loads hold the row's 16-byte vectors runs it.
#define RQ_VEC_SCHEDULES(X) X(1, 4) X(2, 4) X(8, 2) X(8, 4)

bool aligned16(const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; }

template <typename T, int ACT>
int launch(const void* x, const float* gamma, const float* beta, int8_t* out, float* scale,
           int M, int K, float eps, cudaStream_t stream) {
  // 16-byte loads need every row, and gamma and beta, to start on 16 bytes
  constexpr int E = 16 / sizeof(T);
  const bool vec = ((size_t)K * sizeof(T)) % 16 == 0 && aligned16(x) && aligned16(out) &&
                   (gamma == nullptr || (aligned16(gamma) && aligned16(beta)));
  const int nv = K / E;
#define RQ_TRY(W, L)                  \
  if (vec && nv <= 32 * (W) * (L))    \
    return launch_rows<T, ACT, W, L, E>(x, gamma, beta, out, scale, M, K, eps, stream);
  RQ_VEC_SCHEDULES(RQ_TRY)
#undef RQ_TRY
  // longer rows, or no 16-byte loads: staged in shared memory (K * 4 <=
  // SMEM_LIMIT, checked)
  const size_t smem = sizeof(float) * (size_t)K;
  cudaError_t err = cudaFuncSetAttribute(rowquant_staged_kernel<T, ACT>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem);
  if (err != cudaSuccess) return (int)err;
  rowquant_staged_kernel<T, ACT><<<M, NT, smem, stream>>>(static_cast<const T*>(x), gamma,
                                                           beta, out, scale, K, eps);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_act(int act, const void* x, const float* gamma, const float* beta, int8_t* out,
               float* scale, int M, int K, float eps, cudaStream_t stream) {
  switch (act) {
    case 0: return launch<T, 0>(x, gamma, beta, out, scale, M, K, eps, stream);
    case 1: return launch<T, 1>(x, gamma, beta, out, scale, M, K, eps, stream);
    case 2: return launch<T, 2>(x, gamma, beta, out, scale, M, K, eps, stream);
    case 3: return launch<T, 3>(x, gamma, beta, out, scale, M, K, eps, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16. gamma, beta: float32 [K] each, or both
// null for no layernorm. act: 0 none, 1 quick_gelu, 2 gelu_tanh, 3 gelu.
// out: int8 [M, K]; scale: float32 [M]. Returns cudaGetLastError() of the
// launch.
int rowquant(const void* x, const void* gamma, const void* beta, void* out, void* scale,
             int dtype, int act, int M, int K, float eps, void* stream) {
  if (M < 1 || K < 1 || (size_t)K * sizeof(float) > 232448 ||
      (gamma == nullptr) != (beta == nullptr))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* g = static_cast<const float*>(gamma);
  const float* b = static_cast<const float*>(beta);
  int8_t* o = static_cast<int8_t*>(out);
  float* sc = static_cast<float*>(scale);
  if (dtype == 0) return launch_act<float>(act, x, g, b, o, sc, M, K, eps, st);
  if (dtype == 1) return launch_act<__nv_bfloat16>(act, x, g, b, o, sc, M, K, eps, st);
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
