// LayerNorm + static-scale int8 quantize for Hopper (sm_90a), plain C interface.
//
// Replaces the TPU kernel _rowquant_static_kernel / rowquant_static
// (clip_assisted_data_labeling_tpu/ops/quant_kernel.py, pallas_call at :457).
//
// Per row of x [M, K] (bf16 or f32), in float32: the layernorm of
// rowquant_common.cuh, then
//   q   = clip(rint(y * (127 / amax)), -127, 127)    round half to even
// amax is read from device memory (the calibrated per-layer site scale), so
// the caller never synchronizes to pass it; like the TPU kernel there is no
// 1e-8 floor here.
//
// What bounds it: ~10 FLOPs per element against sizeof(T) + 1 bytes: memory
// bound (the H100's ridge is ~295 FLOP/byte). The design reads each row from
// device memory once into shared memory, takes both reductions from there,
// and writes the int8 row once — one pass over device memory, as on the TPU.

#include "rowquant_common.cuh"

namespace {

template <typename T>
__global__ void __launch_bounds__(NT) rowquant_static_kernel(
    const T* __restrict__ x, const float* __restrict__ gamma,
    const float* __restrict__ beta, const float* __restrict__ amax,
    int8_t* __restrict__ out, int K, float eps) {
  extern __shared__ float xs[];  // [K]
  __shared__ float red[NT / 32];
  const size_t row = blockIdx.x;
  const float s = stage_row(x + row * K, xs, K);
  float mu, rs;
  ln_stats(xs, K, s, eps, red, mu, rs);
  const float inv = 127.0f / amax[0];
  int8_t* orow = out + row * K;
  for (int k = threadIdx.x; k < K; k += NT)
    orow[k] = quant_i8(ln_apply(xs[k], mu, rs, gamma[k], beta[k]), inv);
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
