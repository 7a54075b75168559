// Int8 tensor-core GEMM for Hopper (sm_90a) with a float32 epilogue, plain
// C interface: the GEMM of the fused W8A8 linear K9 and of the fused block
// linear K8.
//
// Replaces the TPU kernels _kernel / q_linear_fused (K9) and _block_kernel /
// q_block_linear (K8) (clip_assisted_data_labeling_tpu/ops/quant_kernel.py,
// pallas_call at :102 and :299). Each wrapper (ops/quant_kernel) runs one
// launch of K6's row pass (rowquant.cu) around this GEMM:
//   K9: 1. rowquant.cu with no layernorm and no activation, per row of x:
//          amax = max(max|x|, 1e-8), xq = clip(rint(x * (127 / amax))),
//          xs = amax * f32(1/127)
//       2. q_block_linear_gemm with act 0 and no residual, the weight
//          stored [N, K] int8 (the "col" operand):
//          acc = sum_k xq[m, k] * wq[n, k]                  int32, exact
//          y   = ((f32(acc) * xs[m]) * ws[n]) + bias[n]     each step rounded
//          cast to the output type (bf16 or f32).
//   K8: 1. the same row pass, with K8's layernorm over the full K when it
//          has one; or x already int8 with its [M, 1] row scales,
//       2. q_block_linear_gemm: K9's epilogue, then act(y) in float32 (K6's
//          activations, rowquant_common.cuh act_f32), then + f32(residual),
//          then the cast; or, with quant_out, the float32 y written for
//       3. rowquant.cu with no layernorm and no activation over each [N]
//          output row: int8 and amax * f32(1/127) row scales. No 128 x 128
//          tile owns a whole output row, as K1's quant_out (same pass).
// That is the TPU kernels' arithmetic in their order.
//
// What bounds it: 2·M·N·K int8 operations against M·K·2 + N·K + M·N·2 bytes;
// at ViT-L's shapes (M = 18464, K, N in {1024, 3072, 4096}) that is ~750-800
// operations per byte, above the H100's int8 ridge (~590), so the tensor
// cores bound it, except the 1024 x 1024 product (~500: memory bound). K8's
// residual (M·N·2 more bytes) and quant_out (an f32 round trip, 8·M·N bytes)
// move its 1024→1024 and 1024→4096 cases toward the memory bound.
//
// Design (simple first version): 128 x 128 output tiles, 8 warps as 2 x 4,
// each warp 64 x 32 of the tile with int32 accumulators in registers and
// mma.sync m16n8k32 (s8 x s8 → s32). A and B advance through shared memory
// in 64-byte k slices; the next slice's 16-byte global loads are issued into
// registers before the current slice's products (no cp.async or TMA yet).
// Shared rows are padded to 80 bytes, so the fragment loads hit 32 distinct
// banks. The epilogue reads the row and column scales, the bias and the
// residual, runs the activation (both compiled in only where asked for) and
// writes two neighbouring columns per store. K must be a multiple of 16.

#include "rowquant_common.cuh"

namespace {

constexpr int BM = 128, BN = 128, BK = 64;
constexpr int NTH = 256;       // 8 warps
constexpr int LDS = BK + 16;   // shared row stride in bytes

__device__ __forceinline__ uint32_t ld32(const int8_t* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

__device__ __forceinline__ void mma_s8(int (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                       uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

template <typename TO> __device__ __forceinline__ void store2(TO* p, float a, float b);
template <> __device__ __forceinline__ void store2<float>(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}
template <> __device__ __forceinline__ void store2<__nv_bfloat16>(__nv_bfloat16* p, float a,
                                                                 float b) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
}
template <typename TO> __device__ __forceinline__ TO cast_out(float v);
template <> __device__ __forceinline__ float cast_out<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 cast_out<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

// The residual [M, N] of K8's epilogue, float32 (res_dtype 0) or bfloat16 (1).
__device__ __forceinline__ float residual_at(const void* res, int res_dtype, size_t i) {
  return res_dtype == 0 ? static_cast<const float*>(res)[i]
                        : __bfloat162float(static_cast<const __nv_bfloat16*>(res)[i]);
}

// ACT (0 none, 1 quick_gelu, 2 gelu_tanh, 3 gelu) and RES (a residual is
// added) are template parameters: K9 is the <TO, 0, false> instantiation,
// with no code for either. (A run-time switch on the activation in the
// unrolled epilogue measured 0.638 ms against 0.398 for K9 at M = 18464,
// 1024→3072, on an H100 80GB HBM3 at 700 W.)
template <typename TO, int ACT, bool RES>
__global__ void __launch_bounds__(NTH) q_gemm_kernel(
    const int8_t* __restrict__ xq, const int8_t* __restrict__ wq,
    const float* __restrict__ xs, const float* __restrict__ ws,
    const float* __restrict__ bias, TO* __restrict__ out, int M, int N, int K,
    const void* __restrict__ res, int res_dtype) {
  __shared__ __align__(16) int8_t As[BM * LDS];
  __shared__ __align__(16) int8_t Bs[BN * LDS];
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, t = lane % 4;  // mma fragment coordinates
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;
  const int wm = (warp / 4) * 64, wn = (warp % 4) * 32;

  // each thread moves two 16-byte chunks of A and two of B per k slice:
  // chunk c is row c / 4, bytes 16 * (c % 4) of the slice; zero past M, N, K
  int4 ra[2], rb[2];
  auto load = [&](int k0) {
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int c = tid + i * NTH, r = c >> 2, kc = k0 + (c & 3) * 16;
      const int4 zero = make_int4(0, 0, 0, 0);
      ra[i] = (m0 + r < M && kc < K)
                  ? *reinterpret_cast<const int4*>(xq + (size_t)(m0 + r) * K + kc) : zero;
      rb[i] = (n0 + r < N && kc < K)
                  ? *reinterpret_cast<const int4*>(wq + (size_t)(n0 + r) * K + kc) : zero;
    }
  };
  auto store = [&]() {
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int c = tid + i * NTH, r = c >> 2, off = r * LDS + (c & 3) * 16;
      *reinterpret_cast<int4*>(As + off) = ra[i];
      *reinterpret_cast<int4*>(Bs + off) = rb[i];
    }
  };

  int acc[4][4][4];
#pragma unroll
  for (int mi = 0; mi < 4; ++mi)
#pragma unroll
    for (int ni = 0; ni < 4; ++ni) acc[mi][ni][0] = acc[mi][ni][1] = acc[mi][ni][2] =
                                       acc[mi][ni][3] = 0;

  const int nk = (K + BK - 1) / BK;
  load(0);
  store();
  __syncthreads();
  for (int kt = 0; kt < nk; ++kt) {
    if (kt + 1 < nk) load((kt + 1) * BK);
#pragma unroll
    for (int ks = 0; ks < BK; ks += 32) {
      uint32_t a[4][4], b[4][2];
#pragma unroll
      for (int mi = 0; mi < 4; ++mi) {
        const int8_t* ap = As + (wm + mi * 16 + g) * LDS + ks + 4 * t;
        a[mi][0] = ld32(ap);
        a[mi][1] = ld32(ap + 8 * LDS);
        a[mi][2] = ld32(ap + 16);
        a[mi][3] = ld32(ap + 8 * LDS + 16);
      }
#pragma unroll
      for (int ni = 0; ni < 4; ++ni) {
        const int8_t* bp = Bs + (wn + ni * 8 + g) * LDS + ks + 4 * t;
        b[ni][0] = ld32(bp);
        b[ni][1] = ld32(bp + 16);
      }
#pragma unroll
      for (int mi = 0; mi < 4; ++mi)
#pragma unroll
        for (int ni = 0; ni < 4; ++ni) mma_s8(acc[mi][ni], a[mi], b[ni][0], b[ni][1]);
    }
    __syncthreads();  // every warp is done with this slice
    if (kt + 1 < nk) {
      store();
      __syncthreads();
    }
  }

  // epilogue: c0, c1 are row g, columns 2t and 2t + 1; c2, c3 row g + 8
  const bool pairs = (N % 2) == 0;
#pragma unroll
  for (int mi = 0; mi < 4; ++mi) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = m0 + wm + mi * 16 + g + 8 * h;
      if (row >= M) continue;
      const float sx = xs[row];
#pragma unroll
      for (int ni = 0; ni < 4; ++ni) {
        const int col = n0 + wn + ni * 8 + 2 * t;
        float y[2];
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int c = min(col + e, N - 1);
          float v = __fmul_rn(__fmul_rn((float)acc[mi][ni][2 * h + e], sx), ws[c]);
          if (bias != nullptr) v = __fadd_rn(v, bias[c]);
          v = act_f32<ACT>(v);
          if (RES) v = __fadd_rn(v, residual_at(res, res_dtype, (size_t)row * N + c));
          y[e] = v;
        }
        TO* o = out + (size_t)row * N + col;
        if (pairs && col + 1 < N) {
          store2<TO>(o, y[0], y[1]);
        } else {
          if (col < N) o[0] = cast_out<TO>(y[0]);
          if (col + 1 < N) o[1] = cast_out<TO>(y[1]);
        }
      }
    }
  }
}

template <typename TO, int ACT, bool RES>
int launch(const void* xq, const void* wq, const void* xs, const void* ws, const void* bias,
           void* out, int M, int N, int K, const void* res, int res_dtype,
           cudaStream_t stream) {
  dim3 grid((N + BN - 1) / BN, (M + BM - 1) / BM);
  q_gemm_kernel<TO, ACT, RES><<<grid, NTH, 0, stream>>>(
      static_cast<const int8_t*>(xq), static_cast<const int8_t*>(wq),
      static_cast<const float*>(xs), static_cast<const float*>(ws),
      static_cast<const float*>(bias), static_cast<TO*>(out), M, N, K, res, res_dtype);
  return (int)cudaGetLastError();
}

template <typename TO, bool RES>
int launch_act(int act, const void* xq, const void* wq, const void* xs, const void* ws,
               const void* bias, void* out, int M, int N, int K, const void* res,
               int res_dtype, cudaStream_t st) {
  switch (act) {
    case 0: return launch<TO, 0, RES>(xq, wq, xs, ws, bias, out, M, N, K, res, res_dtype, st);
    case 1: return launch<TO, 1, RES>(xq, wq, xs, ws, bias, out, M, N, K, res, res_dtype, st);
    case 2: return launch<TO, 2, RES>(xq, wq, xs, ws, bias, out, M, N, K, res, res_dtype, st);
    case 3: return launch<TO, 3, RES>(xq, wq, xs, ws, bias, out, M, N, K, res, res_dtype, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

template <typename TO>
int launch_res(int act, const void* xq, const void* wq, const void* xs, const void* ws,
               const void* bias, void* out, int M, int N, int K, const void* res,
               int res_dtype, cudaStream_t st) {
  if (res != nullptr)
    return launch_act<TO, true>(act, xq, wq, xs, ws, bias, out, M, N, K, res, res_dtype, st);
  return launch_act<TO, false>(act, xq, wq, xs, ws, bias, out, M, N, K, nullptr, 0, st);
}

int launch_out(int out_dtype, int act, const void* xq, const void* wq, const void* xs,
               const void* ws, const void* bias, void* out, int M, int N, int K,
               const void* res, int res_dtype, void* stream) {
  if (M < 1 || N < 1 || K < 1 || K % 16 != 0 || (M + BM - 1) / BM > 65535 || res_dtype < 0 ||
      res_dtype > 1)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (out_dtype == 0)
    return launch_res<float>(act, xq, wq, xs, ws, bias, out, M, N, K, res, res_dtype, st);
  if (out_dtype == 1)
    return launch_res<__nv_bfloat16>(act, xq, wq, xs, ws, bias, out, M, N, K, res, res_dtype,
                                     st);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

extern "C" {

// The GEMM of K9 (act 0, res null) and K8. xq: int8 [M, K]; wq: int8 [N, K];
// xs: float32 [M]; ws: float32 [N]; bias: float32 [N] or null; act (0 none,
// 1 quick_gelu, 2 gelu_tanh, 3 gelu) on the float32 y, then + res [M, N]
// (null, or of res_dtype 0 = float32, 1 = bfloat16), then the cast to
// out: [M, N] of out_dtype (0 = float32, 1 = bfloat16). K % 16 == 0 and
// 16-byte aligned xq, wq. Returns cudaGetLastError() of the launch.
int q_block_linear_gemm(const void* xq, const void* wq, const void* xs, const void* ws,
                        const void* bias, const void* res, int res_dtype, void* out,
                        int out_dtype, int act, int M, int N, int K, void* stream) {
  return launch_out(out_dtype, act, xq, wq, xs, ws, bias, out, M, N, K, res, res_dtype, stream);
}

}  // extern "C"
