// Device helpers shared by the exact two-pass attention kernels K1
// (packed_attention.cu) and K4 (packed_attention_grouped.cu): type
// conversion, warp reductions, the bf16 mma.sync tile product, the half-split
// RoPE rotation with the TPU kernel's roundings, and the loads that stage one
// head's rows of the packed [B, S, 3w] qkv into shared memory.
#pragma once

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>
#include <stdint.h>

namespace {

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

__device__ __forceinline__ float warp_max(float v) {
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ float warp_sum(float v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// RoPE on one feature pair (x1, x2) = (x[i], x[i + d/2]) of one token, with
// the tables' (c, s) for that token and lane, all values of type T held in
// floats: [x1·c − x2·s, x1·s + x2·c] with each product rounded to T and then
// the difference and the sum rounded to T. That is how the TPU kernel's
// _rot_half rounds (its interpret-mode run equals this bit for bit in bf16).
// The _rn intrinsics keep nvcc from contracting a product and a sum into an
// FMA, which would skip the product's rounding.
template <typename T>
__device__ __forceinline__ void rot_pair(float& x1, float& x2, float c, float s) {
  const float a = to_f(from_f<T>(__fmul_rn(x1, c)));
  const float b = to_f(from_f<T>(__fmul_rn(x2, s)));
  const float e = to_f(from_f<T>(__fmul_rn(x1, s)));
  const float f = to_f(from_f<T>(__fmul_rn(x2, c)));
  x1 = to_f(from_f<T>(__fsub_rn(a, b)));
  x2 = to_f(from_f<T>(__fadd_rn(e, f)));
}

// Stage tokens [r0, r0 + ROWS) of one head's d columns, which start at column
// `col` of the packed rows (row stride rs), into dst as floats: token r's
// lane i goes to dst[r * ld_row + i * ld_col] (row-major q, or K^T with
// ld_row = 1), zero past the sequence. With `scale`, each value is first
// multiplied by scale_t and rounded to T. With RoPE tables (cos, sin:
// [S, d/2] of T), each pair (i, i + d/2) is rotated by rot_pair.
template <typename T, int NTHREADS, int ROWS>
__device__ __forceinline__ void stage_rows_f(
    float* dst, int ld_row, int ld_col, const T* base, int r0, int S, size_t rs, int col,
    int d, bool scale, float scale_t, const T* cos, const T* sin) {
  if (cos == nullptr) {
    for (int idx = threadIdx.x; idx < ROWS * d; idx += NTHREADS) {
      const int r = idx / d, i = idx - r * d, row = r0 + r;
      float v = 0.f;
      if (row < S) {
        v = to_f(base[(size_t)row * rs + col + i]);
        if (scale) v = to_f(from_f<T>(v * scale_t));
      }
      dst[r * ld_row + i * ld_col] = v;
    }
    return;
  }
  const int half = d / 2;
  for (int idx = threadIdx.x; idx < ROWS * half; idx += NTHREADS) {
    const int r = idx / half, i = idx - r * half, row = r0 + r;
    float x1 = 0.f, x2 = 0.f;
    if (row < S) {
      const T* src = base + (size_t)row * rs + col;
      x1 = to_f(src[i]);
      x2 = to_f(src[half + i]);
      if (scale) {
        x1 = to_f(from_f<T>(x1 * scale_t));
        x2 = to_f(from_f<T>(x2 * scale_t));
      }
      rot_pair<T>(x1, x2, to_f(cos[(size_t)row * half + i]), to_f(sin[(size_t)row * half + i]));
    }
    dst[r * ld_row + i * ld_col] = x1;
    dst[r * ld_row + (half + i) * ld_col] = x2;
  }
}

// ---- bfloat16 tensor-core pieces ------------------------------------------

constexpr int PAD = 8;  // bf16 elements of padding per shared-memory row

__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t ld32(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// The bf16 vector forms below use the packed bf16x2 round-to-nearest
// instructions (the _rn intrinsics are never contracted into an FMA). They
// round exactly as the float forms above: the product of two bf16 values is
// exact in float32, so rounding it once to bf16 is rot_pair's rounding; and
// the sum of two bf16 values is exact in float32 unless their exponents
// differ by 16 or more, where both roundings return the larger operand.

// eight bf16 values × scale (a bf16 value), each product rounded to bf16
// (q · scale in the input type, as the TPU kernel scales q)
__device__ __forceinline__ void scale8(uint4& v, __nv_bfloat162 scale2) {
  __nv_bfloat162* e = reinterpret_cast<__nv_bfloat162*>(&v);
#pragma unroll
  for (int j = 0; j < 4; ++j) e[j] = __hmul2_rn(e[j], scale2);
}

// rotate eight pairs: lo holds x[i..i+7], hi holds x[i+d/2..i+d/2+7]
__device__ __forceinline__ void rot8(uint4& lo, uint4& hi, uint4 cv, uint4 sv) {
  __nv_bfloat162* a = reinterpret_cast<__nv_bfloat162*>(&lo);
  __nv_bfloat162* b = reinterpret_cast<__nv_bfloat162*>(&hi);
  const __nv_bfloat162* c = reinterpret_cast<const __nv_bfloat162*>(&cv);
  const __nv_bfloat162* s = reinterpret_cast<const __nv_bfloat162*>(&sv);
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const __nv_bfloat162 x1 = a[j], x2 = b[j];
    a[j] = __hsub2_rn(__hmul2_rn(x1, c[j]), __hmul2_rn(x2, s[j]));
    b[j] = __hadd2_rn(__hmul2_rn(x1, s[j]), __hmul2_rn(x2, c[j]));
  }
}

// Stage tokens [r0, r0 + ROWS) of one head's d columns, which start at column
// `col` of the packed rows (row stride rs), into dst [ROWS][LD] bf16 with
// 16-byte loads: zero past the sequence and in the padding lanes d..DP. With
// `scale`, each value is first multiplied by scale_t (a bf16 value) and
// rounded. With RoPE tables (cos, sin: [S, d/2] bf16, d % 16 == 0), each
// vector of the first half is rotated with its partner in the second half
// against the token's table row.
template <int NTHREADS, int ROWS, int DP, int LD>
__device__ __forceinline__ void stage_rows_bf16(
    __nv_bfloat16* dst, const __nv_bfloat16* base, int r0, int S, size_t rs, int col, int d,
    bool scale, float scale_t, const __nv_bfloat16* cos, const __nv_bfloat16* sin) {
  constexpr int NV = DP / 8;  // 16-byte vectors per padded row
  const int dv = d / 8;
  const uint4 zero = make_uint4(0, 0, 0, 0);
  const __nv_bfloat162 scale2 = __float2bfloat162_rn(scale_t);
  if (cos == nullptr) {
    for (int idx = threadIdx.x; idx < ROWS * NV; idx += NTHREADS) {
      const int r = idx / NV, c8 = idx % NV;
      uint4 v = zero;
      if (r0 + r < S && c8 < dv) {
        v = *reinterpret_cast<const uint4*>(base + (size_t)(r0 + r) * rs + col + c8 * 8);
        if (scale) scale8(v, scale2);
      }
      *reinterpret_cast<uint4*>(dst + r * LD + c8 * 8) = v;
    }
    return;
  }
  const int half = d / 2, hv = d / 16;
  for (int idx = threadIdx.x; idx < ROWS * hv; idx += NTHREADS) {
    const int r = idx / hv, j = idx % hv, row = r0 + r;
    uint4 lo = zero, hi = zero;
    if (row < S) {
      const __nv_bfloat16* src = base + (size_t)row * rs + col;
      lo = *reinterpret_cast<const uint4*>(src + j * 8);
      hi = *reinterpret_cast<const uint4*>(src + half + j * 8);
      if (scale) {
        scale8(lo, scale2);
        scale8(hi, scale2);
      }
      rot8(lo, hi, *reinterpret_cast<const uint4*>(cos + (size_t)row * half + j * 8),
           *reinterpret_cast<const uint4*>(sin + (size_t)row * half + j * 8));
    }
    *reinterpret_cast<uint4*>(dst + r * LD + j * 8) = lo;
    *reinterpret_cast<uint4*>(dst + r * LD + half + j * 8) = hi;
  }
  const int np = NV - dv;  // padding vectors per row
  for (int idx = threadIdx.x; idx < ROWS * np; idx += NTHREADS)
    *reinterpret_cast<uint4*>(dst + (idx / np) * LD + (dv + idx % np) * 8) = zero;
}

// Stage keys [k0, k0 + KEYS) of one head's v columns transposed, into
// vt [DP][LDV] (key fastest, so the scattered 2-byte stores spread over banks).
template <int NTHREADS, int KEYS, int DP, int LDV>
__device__ __forceinline__ void stage_vt_bf16(
    __nv_bfloat16* vt, const __nv_bfloat16* base, int k0, int S, size_t rs, int col, int d) {
  constexpr int NV = DP / 8;
  const int dv = d / 8;
  for (int idx = threadIdx.x; idx < KEYS * NV; idx += NTHREADS) {
    const int r = idx % KEYS, c8 = idx / KEYS;
    uint4 v = make_uint4(0, 0, 0, 0);
    if (k0 + r < S && c8 < dv)
      v = *reinterpret_cast<const uint4*>(base + (size_t)(k0 + r) * rs + col + c8 * 8);
    const __nv_bfloat16* e = reinterpret_cast<const __nv_bfloat16*>(&v);
#pragma unroll
    for (int j = 0; j < 8; ++j) vt[(c8 * 8 + j) * LDV + r] = e[j];
  }
}

}  // namespace
