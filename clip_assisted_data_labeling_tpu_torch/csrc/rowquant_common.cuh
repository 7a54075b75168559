// Device code shared by the row kernels K2 (rowquant_static.cu) and K6
// (rowquant.cu), whose activations K8's GEMM epilogue (q_linear_fused.cu)
// also runs: their row pass with the row in a warp group's registers
// (rowquant_rows_kernel, below; K2 takes it in its static-scale mode), the
// staged schedules' helpers (one block of NT threads per row of x [M, K],
// the row staged in shared memory as floats, block-wide sum and max), the
// float32 activations, and the layernorm with the TPU kernels' order of
// operations:
//   mu  = sum(x) / K
//   var = sum((x - mu)^2) / K                 two-pass, population variance
//   y   = (x - mu) * (1 / sqrt(var + eps))
//   y   = y * gamma + beta
// Multiplies and adds of the per-element steps are rounded one at a time
// (__fmul_rn/__fadd_rn) so no FMA contraction moves a value across a
// rounding boundary that the plain PyTorch versions (one op per pass) keep.
#pragma once

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int NT = 256;

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }

// Sum over the block; every thread gets the result.
__device__ __forceinline__ float block_sum(float v, float* red) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  __syncthreads();  // red may still be read by an earlier reduction
  if (lane == 0) red[warp] = v;
  __syncthreads();
  float t = lane < NT / 32 ? red[lane] : 0.f;
  for (int o = 16; o > 0; o >>= 1) t += __shfl_xor_sync(0xffffffffu, t, o);
  return t;
}

// Max over the block; every thread gets the result.
__device__ __forceinline__ float block_max(float v, float* red) {
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  __syncthreads();
  if (lane == 0) red[warp] = v;
  __syncthreads();
  float t = lane < NT / 32 ? red[lane] : -INFINITY;
  for (int o = 16; o > 0; o >>= 1) t = fmaxf(t, __shfl_xor_sync(0xffffffffu, t, o));
  return t;
}

// Stage one row into xs as floats; returns this thread's part of its sum.
// Thread t owns the entries k = t, t + NT, ... in every loop over the row.
template <typename T>
__device__ __forceinline__ float stage_row(const T* __restrict__ xr, float* xs, int K) {
  float s = 0.f;
  for (int k = threadIdx.x; k < K; k += NT) {
    const float v = to_f(xr[k]);
    xs[k] = v;
    s += v;
  }
  return s;
}

// The staged row's layernorm statistics: mu and rs = 1 / sqrt(var + eps).
__device__ __forceinline__ void ln_stats(const float* xs, int K, float partial_sum, float eps,
                                         float* red, float& mu, float& rs) {
  mu = block_sum(partial_sum, red) / (float)K;
  float s2 = 0.f;
  for (int k = threadIdx.x; k < K; k += NT) {
    const float dv = xs[k] - mu;
    s2 = fmaf(dv, dv, s2);
  }
  const float var = block_sum(s2, red) / (float)K;
  rs = 1.0f / sqrtf(var + eps);
}

__device__ __forceinline__ float ln_apply(float x, float mu, float rs, float g, float b) {
  const float y = __fmul_rn(__fsub_rn(x, mu), rs);
  return __fadd_rn(__fmul_rn(y, g), b);
}

// round half to even, clip to ±127
__device__ __forceinline__ int8_t quant_i8(float y, float inv) {
  const float q = rintf(__fmul_rn(y, inv));
  return (int8_t)fminf(fmaxf(q, -127.f), 127.f);
}

constexpr float kInv127 = (float)(1.0 / 127.0);  // f32 of the double, as JAX's weak constant

// The row kernels' float32 activations (K6; K8's GEMM epilogue): 0 none,
// 1 quick_gelu y * (1 / (1 + exp(-1.702 y))), 2 gelu_tanh
// (jax.nn.gelu(approximate=True)) each step rounded, 3 gelu
// y * 0.5 * (1 + erf(y / √2)).
template <int ACT>
__device__ __forceinline__ float act_f32(float y) {
  if (ACT == 1) {  // quick_gelu
    const float z = __fmul_rn(1.702f, y);
    return __fmul_rn(y, 1.0f / __fadd_rn(1.0f, expf(-z)));
  }
  if (ACT == 2) {  // jax.nn.gelu(approximate=True), each step rounded
    const float y3 = __fmul_rn(__fmul_rn(y, y), y);
    const float inner = __fmul_rn(0.7978845834732056f, __fadd_rn(y, __fmul_rn(0.044715f, y3)));
    return __fmul_rn(y, __fmul_rn(0.5f, __fadd_rn(1.0f, tanhf(inner))));
  }
  if (ACT == 3) {  // erf gelu
    const float e = erff(__fmul_rn(y, 0.70710678118654752f));
    return __fmul_rn(__fmul_rn(y, 0.5f), __fadd_rn(1.0f, e));
  }
  return y;
}

// ---- the row pass of K2 and K6: a row in a warp group's registers -----------
//
// A group of WPR warps owns one row and holds it in registers, L 16-byte
// vector loads a lane; lane l of the group reads the row's vectors l,
// l + 32 * WPR, ..., so neighbouring lanes read neighbouring vectors. The
// layernorm's mean, its variance (a second pass over the registers) and, for
// K6, the amax are warp shuffles; with WPR > 1 the group's warps add their
// totals through shared memory, in warp order, between two barriers. The
// int8 row goes out in 8-byte (bf16) or 4-byte (f32) stores. A 256-thread
// block holds 8 / WPR rows. The first schedule (WPR, L) of RQ_VEC_SCHEDULES
// whose 32 * WPR * L vectors hold the row runs it: one warp a row, and no
// block barrier, up to 128 vectors (ViT-L's 1024 in bf16), two warps up to
// 256 (SO400M-384's 1152; 1024 in f32), eight warps of 2 or 4 loads up to
// 1024 (4096 and 4304 in bf16). Other rows take each kernel's staged
// schedule (launch_rows_vec returns kNoSchedule). The per-element arithmetic
// is ln_apply, act_f32 and quant_i8 above; only the order of the layernorm's
// sums differs from torch's (and from the staged schedules').

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

// STATIC (K2): amax is read from device memory (amax_in[0], no floor) and
// no scale is written; otherwise (K6) amax is the row's, and scale[row] is
// written.
template <typename T, int ACT, int WPR, int L, int E, bool STATIC>
__global__ void __launch_bounds__(RQ_THREADS) rowquant_rows_kernel(
    const T* __restrict__ x, const float* __restrict__ gamma,
    const float* __restrict__ beta, const float* __restrict__ amax_in,
    int8_t* __restrict__ out, float* __restrict__ scale, int M, int K, float eps) {
  constexpr int G = 32 * WPR;       // lanes of a row's group
  __shared__ float red[RQ_THREADS / 32];
  const int gl = threadIdx.x % G;   // lane within the group
  const size_t row = (size_t)blockIdx.x * (RQ_THREADS / G) + threadIdx.x / G;
  const bool live = row < (size_t)M;
  if (WPR == 1 && !live) return;  // groups of one warp take no block barrier
  const int nv = K / E;           // vectors in the row (E divides K)
  const T* xr = x + row * K;
  const float amax_s = STATIC ? __ldg(amax_in) : 0.f;  // read once, beside the row

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
  // the last barrier of a group of several warps is behind: dead rows may go
  if (STATIC && !live) return;
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
        if (!STATIC) m = fmaxf(m, fabsf(y));
      }
    }
  }
  const float amax = STATIC ? amax_s : fmaxf(group_reduce<WPR, true>(m, red), 1e-8f);
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
  if (!STATIC && gl == 0) scale[row] = __fmul_rn(amax, kInv127);
}

template <typename T, int ACT, int WPR, int L, int E, bool STATIC>
int launch_rows(const void* x, const float* gamma, const float* beta, const float* amax,
                int8_t* out, float* scale, int M, int K, float eps, cudaStream_t stream) {
  constexpr int rows_per_block = RQ_THREADS / (32 * WPR);
  const int grid = (M + rows_per_block - 1) / rows_per_block;
  rowquant_rows_kernel<T, ACT, WPR, L, E, STATIC><<<grid, RQ_THREADS, 0, stream>>>(
      static_cast<const T*>(x), gamma, beta, amax, out, scale, M, K, eps);
  return (int)cudaGetLastError();
}

// The schedules (WPR, L) in the order they are tried: the first whose
// 32 * WPR * L loads hold the row's 16-byte vectors runs it.
#define RQ_VEC_SCHEDULES(X) X(1, 4) X(2, 4) X(8, 2) X(8, 4)

inline bool aligned16(const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; }

constexpr int kNoSchedule = -1;  // not a cudaError_t: the caller stages the row

// Launches the row pass on the first vector schedule that holds the row;
// returns the launch's cudaError_t, or kNoSchedule (nothing launched) for a
// row that cannot take 16-byte loads (K * sizeof(T) % 16 != 0, or a pointer
// off 16 bytes) or that is longer than every schedule holds.
template <typename T, int ACT, bool STATIC>
int launch_rows_vec(const void* x, const float* gamma, const float* beta, const float* amax,
                    int8_t* out, float* scale, int M, int K, float eps,
                    cudaStream_t stream) {
  // 16-byte loads need every row, and gamma and beta, to start on 16 bytes
  constexpr int E = 16 / sizeof(T);
  const bool vec = ((size_t)K * sizeof(T)) % 16 == 0 && aligned16(x) && aligned16(out) &&
                   (gamma == nullptr || (aligned16(gamma) && aligned16(beta)));
  if (!vec) return kNoSchedule;
  const int nv = K / E;
#define RQ_TRY(W, L)      \
  if (nv <= 32 * (W) * (L)) \
    return launch_rows<T, ACT, W, L, E, STATIC>(x, gamma, beta, amax, out, scale, M, K, eps, stream);
  RQ_VEC_SCHEDULES(RQ_TRY)
#undef RQ_TRY
  return kNoSchedule;
}

}  // namespace
