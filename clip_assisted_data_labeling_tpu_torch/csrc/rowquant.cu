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
// Design: the row pass of rowquant_common.cuh (rowquant_rows_kernel, shared
// with K2): a group of WPR warps owns a row and holds it in registers, the
// mean, the variance and the amax are warp shuffles, the int8 row goes out
// in 8-byte (bf16) or 4-byte (f32) stores; the schedule (WPR, L) is the
// first of RQ_VEC_SCHEDULES that holds the row. Rows that cannot take
// 16-byte loads (K * sizeof(T) % 16 != 0, or a pointer off 16 bytes; no
// path's shape) and longer rows (bf16 past 8192, f32 past 4096) take the
// staged schedule here: one block a row, the row in shared memory as floats.

#include "rowquant_common.cuh"

namespace {

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

template <typename T, int ACT>
int launch(const void* x, const float* gamma, const float* beta, int8_t* out, float* scale,
           int M, int K, float eps, cudaStream_t stream) {
  const int err = launch_rows_vec<T, ACT, false>(x, gamma, beta, nullptr, out, scale, M, K,
                                                 eps, stream);
  if (err != kNoSchedule) return err;
  // longer rows, or no 16-byte loads: staged in shared memory (K * 4 <=
  // SMEM_LIMIT, checked)
  const size_t smem = sizeof(float) * (size_t)K;
  cudaError_t e = cudaFuncSetAttribute(rowquant_staged_kernel<T, ACT>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
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
