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
// 1e-8 floor here, no amax reduction and no scale output.
//
// What bounds it: ~10 FLOPs per element against sizeof(T) + 1 bytes: memory
// bound (the H100's ridge is ~295 FLOP/byte), so the design reads each row
// once and writes the int8 row once, with as many bytes in flight as the
// registers allow.
//
// Design: K6's row pass (rowquant_common.cuh, rowquant_rows_kernel) in its
// static mode: a group of WPR warps holds a row in registers, L 16-byte
// loads a lane, the mean and the variance are warp shuffles, the int8 row
// goes out in 8-byte (bf16) or 4-byte (f32) stores, amax is read once a row.
// ViT-L's and PE-L14's 1024-wide bf16 rows take one warp a row and no block
// barrier; SO400M-384's 1152 two warps. Rows that cannot take 16-byte loads
// (K * sizeof(T) % 16 != 0, or a pointer off 16 bytes; no path's shape) and
// rows past the registers (bf16 past 8192, f32 past 4096) take the staged
// kernel below: one block a row, the row in shared memory as floats.

#include "rowquant_common.cuh"

namespace {

template <typename T>
__global__ void __launch_bounds__(NT) rowquant_static_staged_kernel(
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
  const int err = launch_rows_vec<T, 0, true>(x, gamma, beta, amax, out, nullptr, M, K, eps,
                                              stream);
  if (err != kNoSchedule) return err;
  const size_t smem = sizeof(float) * (size_t)K;
  cudaError_t e = cudaFuncSetAttribute(rowquant_static_staged_kernel<T>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  rowquant_static_staged_kernel<T><<<M, NT, smem, stream>>>(
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
