// LayerNorm + static-scale int8 quantize for Hopper (sm_90a), plain C interface.
//
// Replaces the TPU kernel _rowquant_static_kernel / rowquant_static
// (clip_assisted_data_labeling_tpu/ops/quant_kernel.py, pallas_call at :457).
//
// Per row of x [M, K] (bf16 or f32), in float32:
//   mu  = sum(x) / K
//   var = sum((x - mu)^2) / K                 two-pass, population variance
//   y   = (x - mu) * (1 / sqrt(var + eps))
//   y   = y * gamma + beta
//   q   = clip(rint(y * (127 / amax)), -127, 127)    round half to even
// amax is read from device memory (the calibrated per-layer site scale), so
// the caller never synchronizes to pass it; like the TPU kernel there is no
// 1e-8 floor here. Multiplies and adds are rounded one at a time
// (__fmul_rn/__fadd_rn) so no FMA contraction moves a value across a
// rounding boundary that the plain PyTorch version (one op per pass) keeps.
//
// What bounds it: ~10 FLOPs per element against sizeof(T) + 1 bytes: memory
// bound (the H100's ridge is ~295 FLOP/byte). The design reads each row from
// device memory once into shared memory, takes both reductions from there,
// and writes the int8 row once — one pass over device memory, as on the TPU.

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

template <typename T>
__global__ void __launch_bounds__(NT) rowquant_static_kernel(
    const T* __restrict__ x, const float* __restrict__ gamma,
    const float* __restrict__ beta, const float* __restrict__ amax,
    int8_t* __restrict__ out, int K, float eps) {
  extern __shared__ float xs[];  // [K]
  __shared__ float red[NT / 32];
  const size_t row = blockIdx.x;
  const T* xr = x + row * K;

  float s = 0.f;
  for (int k = threadIdx.x; k < K; k += NT) {
    const float v = to_f(xr[k]);
    xs[k] = v;
    s += v;
  }
  const float mu = block_sum(s, red) / (float)K;
  float s2 = 0.f;
  for (int k = threadIdx.x; k < K; k += NT) {
    const float dv = xs[k] - mu;
    s2 = fmaf(dv, dv, s2);
  }
  const float var = block_sum(s2, red) / (float)K;
  const float rs = 1.0f / sqrtf(var + eps);
  const float inv = 127.0f / amax[0];
  int8_t* orow = out + row * K;
  for (int k = threadIdx.x; k < K; k += NT) {
    float y = __fmul_rn(__fsub_rn(xs[k], mu), rs);
    y = __fadd_rn(__fmul_rn(y, gamma[k]), beta[k]);
    float q = rintf(__fmul_rn(y, inv));
    q = fminf(fmaxf(q, -127.f), 127.f);
    orow[k] = (int8_t)q;
  }
}

template <typename T>
int launch(const void* x, const float* gamma, const float* beta, const float* amax,
           int8_t* out, int M, int K, float eps, cudaStream_t stream) {
  const size_t smem = sizeof(float) * (size_t)K;
  cudaError_t err = cudaFuncSetAttribute(rowquant_static_kernel<T>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem);
  if (err != cudaSuccess) return (int)err;
  rowquant_static_kernel<T><<<M, NT, smem, stream>>>(
      static_cast<const T*>(x), gamma, beta, amax, out, K, eps);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16. Returns cudaGetLastError() of the launch.
int rowquant_static(const void* x, const void* gamma, const void* beta, const void* amax,
                    void* out, int dtype, int M, int K, float eps, void* stream) {
  if (M < 1 || K < 1 || (size_t)K * sizeof(float) > 232448) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* g = static_cast<const float*>(gamma);
  const float* b = static_cast<const float*>(beta);
  const float* a = static_cast<const float*>(amax);
  int8_t* o = static_cast<int8_t*>(out);
  if (dtype == 0) return launch<float>(x, g, b, a, o, M, K, eps, st);
  if (dtype == 1) return launch<__nv_bfloat16>(x, g, b, a, o, M, K, eps, st);
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
