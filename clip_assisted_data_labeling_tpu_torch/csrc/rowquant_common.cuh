// Device helpers shared by the row kernels K2 (rowquant_static.cu) and K6
// (rowquant.cu), whose activations K8's GEMM epilogue (q_linear_fused.cu)
// also runs: one block of NT threads per row of x [M, K], the row staged in
// shared memory as floats, block-wide sum and max, the float32 activations,
// and the layernorm with the TPU kernels' order of operations:
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

}  // namespace
