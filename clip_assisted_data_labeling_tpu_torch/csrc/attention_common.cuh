// Device helpers shared by the attention kernels K1 (packed_attention.cu),
// K3 (packed_attention_q8s.cu), K4 (packed_attention_grouped.cu), K5
// (flash_attention.cu) and K7 (packed_attention_q8.cu): type conversion,
// the half-split RoPE rotation with the TPU kernel's roundings; cp.async;
// the wgmma products, descriptors and core-matrix copies (bf16, and int8
// with its dequantize); then the two kernels that they instantiate: the
// float32 one, on the tensor cores with 3xTF32 split products (K1, K4, K5,
// K10), and the bfloat16 one, on wgmma, which also takes the int8 wires of
// K3 and K7 (the last two sections).
#pragma once

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

namespace {

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
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

// ---- bfloat16 vector pieces ------------------------------------------------

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

// ---- asynchronous copies (cp.async) ----------------------------------------

__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool valid) {
  const uint32_t a = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(a), "l"(src),
               "r"(valid ? 16 : 0) : "memory");
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src, bool valid) {
  const uint32_t a = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(a), "l"(src),
               "r"(valid ? 4 : 0) : "memory");
}

__device__ __forceinline__ void cp_async8(void* dst, const void* src, bool valid) {
  const uint32_t a = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8, %2;\n" ::"r"(a), "l"(src),
               "r"(valid ? 8 : 0) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// wait until at most N committed groups are still in flight
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// ---- bfloat16 on Hopper's warpgroup tensor cores (wgmma) -------------------
//
// A warpgroup (four consecutive warps, 128 threads) issues one asynchronous
// m64nNk16 product: A (64 x 16) from registers, in the m16n8k16 A fragment
// layout of each warp's 16 rows (warp w of the group owns rows 16w..16w+15),
// B (16 x N) from shared memory through a descriptor; the float32
// accumulator of 64 x N sits in the same layout as N/8 m16n8 accumulators of
// each warp: d[j] holds columns 8j..8j+7 (d[j][0..1] row g cols 2t, 2t+1,
// d[j][2..3] row g+8). Operands in shared memory use the layout without
// swizzle: 8 x 8 "core matrices" of 128 contiguous bytes (8 rows of 16
// bytes). The descriptor gives the start address, LBO (the byte stride
// between core matrices along K) and SBO (along M or N). A K-major operand
// has K contiguous in a core-matrix row, an MN-major one M or N; the
// wgmma_n* products take A from registers and B MN-major (the transpose
// bit set), wgmma_ss_n64 both from shared memory, K-major.

#define WG_D4(j) "+f"(d[j][0]), "+f"(d[j][1]), "+f"(d[j][2]), "+f"(d[j][3])

__device__ __forceinline__ void wgmma_n64(float (&d)[8][4], const uint32_t (&a)[4],
                                          uint64_t b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : WG_D4(0), WG_D4(1), WG_D4(2), WG_D4(3),
        WG_D4(4), WG_D4(5), WG_D4(6), WG_D4(7)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(scale_d));
}

__device__ __forceinline__ void wgmma_n80(float (&d)[10][4], const uint32_t (&a)[4],
                                          uint64_t b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %45, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n80k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39"
      "}, {%40, %41, %42, %43}, %44, p, 1, 1, 1;\n}\n"
      : WG_D4(0), WG_D4(1), WG_D4(2), WG_D4(3),
        WG_D4(4), WG_D4(5), WG_D4(6), WG_D4(7),
        WG_D4(8), WG_D4(9)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(scale_d));
}

__device__ __forceinline__ void wgmma_n96(float (&d)[12][4], const uint32_t (&a)[4],
                                          uint64_t b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %53, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n96k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47"
      "}, {%48, %49, %50, %51}, %52, p, 1, 1, 1;\n}\n"
      : WG_D4(0), WG_D4(1), WG_D4(2), WG_D4(3),
        WG_D4(4), WG_D4(5), WG_D4(6), WG_D4(7),
        WG_D4(8), WG_D4(9), WG_D4(10), WG_D4(11)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(scale_d));
}

__device__ __forceinline__ void wgmma_n112(float (&d)[14][4], const uint32_t (&a)[4],
                                          uint64_t b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %61, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n112k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55"
      "}, {%56, %57, %58, %59}, %60, p, 1, 1, 1;\n}\n"
      : WG_D4(0), WG_D4(1), WG_D4(2), WG_D4(3),
        WG_D4(4), WG_D4(5), WG_D4(6), WG_D4(7),
        WG_D4(8), WG_D4(9), WG_D4(10), WG_D4(11),
        WG_D4(12), WG_D4(13)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(scale_d));
}

__device__ __forceinline__ void wgmma_n128(float (&d)[16][4], const uint32_t (&a)[4],
                                          uint64_t b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
      "}, {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : WG_D4(0), WG_D4(1), WG_D4(2), WG_D4(3),
        WG_D4(4), WG_D4(5), WG_D4(6), WG_D4(7),
        WG_D4(8), WG_D4(9), WG_D4(10), WG_D4(11),
        WG_D4(12), WG_D4(13), WG_D4(14), WG_D4(15)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(scale_d));
}

// d (64 x 64) = A·B + (scale_d ? d : 0), A (64 x 16) and B both K-major in
// shared memory
__device__ __forceinline__ void wgmma_ss_n64(float (&d)[8][4], uint64_t a, uint64_t b,
                                             int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      : WG_D4(0), WG_D4(1), WG_D4(2), WG_D4(3),
        WG_D4(4), WG_D4(5), WG_D4(6), WG_D4(7)
      : "l"(a), "l"(b), "r"(scale_d));
}

#undef WG_D4

// d (64 x N) = a·B + (scale_d ? d : 0) for one k16 step, B MN-major
template <int N>
__device__ __forceinline__ void wgmma_rs(float (&d)[N / 8][4], const uint32_t (&a)[4], uint64_t b,
                                         int scale_d) {
  if constexpr (N == 64) wgmma_n64(d, a, b, scale_d);
  else if constexpr (N == 80) wgmma_n80(d, a, b, scale_d);
  else if constexpr (N == 96) wgmma_n96(d, a, b, scale_d);
  else if constexpr (N == 112) wgmma_n112(d, a, b, scale_d);
  else wgmma_n128(d, a, b, scale_d);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_wait0() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}

// after wgmma_wait0: the accumulator's registers hold the product from here
// on (keeps the compiler from reading them before the wait)
template <int NJ>
__device__ __forceinline__ void wgmma_settle(float (&d)[NJ][4]) {
#pragma unroll
  for (int j = 0; j < NJ; ++j)
#pragma unroll
    for (int i = 0; i < 4; ++i) asm volatile("" : "+f"(d[j][i])::"memory");
}

// copies made by cp.async (the generic proxy) visible to wgmma's reads of
// shared memory (the async proxy), before the barrier that publishes them
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// descriptor of an operand without swizzle at p, strides in bytes
__device__ __forceinline__ uint64_t gmma_desc(const void* p, uint32_t lbo, uint32_t sbo) {
  const uint32_t a = static_cast<uint32_t>(__cvta_generic_to_shared(p));
  return (uint64_t)((a & 0x3FFFF) >> 4) | (uint64_t)(lbo >> 4) << 16 |
         (uint64_t)(sbo >> 4) << 32;
}

// Copy tokens [r0, r0 + ROWS) of one head's d bf16 lanes, which start at
// column `col` of rows of stride rs, into dst by 16-byte cp.async, in core
// matrices: row r's lanes 8c..8c+7 at dst + ((r / 8)·(DP / 8) + c)·64 +
// (r % 8)·8, so eight consecutive threads fill one 128-byte core matrix
// (no bank conflicts, no padding). Rows past S and the lanes d..DP are
// zero-filled (d % 8 == 0).
template <int NTHREADS, int ROWS, int DP>
__device__ __forceinline__ void cp_async_core_bf16(__nv_bfloat16* dst, const __nv_bfloat16* base,
                                                   int r0, int S, size_t rs, int col, int d) {
  constexpr int NV = DP / 8;
  for (int idx = threadIdx.x; idx < ROWS * NV; idx += NTHREADS) {
    const int r = idx / (8 * NV) * 8 + idx % 8, c8 = idx / 8 % NV;
    const bool ok = r0 + r < S && c8 * 8 < d;
    cp_async16(dst + idx * 8, ok ? base + (size_t)(r0 + r) * rs + col + c8 * 8 : base, ok);
  }
}

// The int8 form of cp_async_core_bf16, in its order: row r's lanes 8c..8c+7
// (8 bytes, one 8-byte cp.async: an int8 head slice starts at h·d bytes,
// only 8-byte aligned at d = 72) at dst + idx·8, idx being the index that
// cp_async_core_bf16 gives those lanes, so that dequant_core turns them into
// exactly their 16-byte row of a bf16 core matrix. Rows past S and the
// lanes d..DP are zero-filled (d % 8 == 0).
template <int NTHREADS, int ROWS, int DP>
__device__ __forceinline__ void cp_async_core_i8(int8_t* dst, const int8_t* base, int r0, int S,
                                                 size_t rs, int d) {
  constexpr int NV = DP / 8;
  for (int idx = threadIdx.x; idx < ROWS * NV; idx += NTHREADS) {
    const int r = idx / (8 * NV) * 8 + idx % 8, c8 = idx / 8 % NV;
    const bool ok = r0 + r < S && c8 * 8 < d;
    cp_async8(dst + idx * 8, ok ? base + (size_t)(r0 + r) * rs + c8 * 8 : base, ok);
  }
}

// eight int8 lanes → eight bf16(f32(x)·s[j]), one 16-byte core-matrix row:
// x to float exactly by a byte permute (the bits of 2^23 + 128 + x, less
// 2^23 + 128), the product rounded to float32 (never contracted), then to
// bf16, as the TPU kernels dequantize a head slice. s: eight scales in
// registers, or a pointer to them in shared memory, read as they are used
// (loading all eight first spilled registers at d = 64)
template <typename SC>
__device__ __forceinline__ uint4 dequant8(uint2 raw, const SC& s) {
  const uint32_t u[2] = {raw.x ^ 0x80808080u, raw.y ^ 0x80808080u};  // x + 128 in each byte
  uint4 v;
  uint32_t* o = &v.x;
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const uint32_t w = u[j / 2], b = (j % 2) * 2;
    const float x0 = __uint_as_float(__byte_perm(w, 0x4B000000u, 0x7650u + b)) - 8388736.f;
    const float x1 = __uint_as_float(__byte_perm(w, 0x4B000000u, 0x7651u + b)) - 8388736.f;
    o[j] = pack_bf16(__fmul_rn(x0, s[2 * j]), __fmul_rn(x1, s[2 * j + 1]));
  }
  return v;
}

// Dequantize the vectors that cp_async_core_i8 copied for this thread
// into the same vectors of the bf16 core matrices at dst. PER_TOKEN: row
// r's lanes scale by s[r]·mul (s: the ROWS token scales of the tile, 0 past
// S); else lane i by s[i] (s: the head's DP lane scales, 0 past d).
template <int NTHREADS, int ROWS, int DP, bool PER_TOKEN>
__device__ __forceinline__ void dequant_core(__nv_bfloat16* dst, const int8_t* src, const float* s,
                                             float mul) {
  constexpr int NV = DP / 8;
#pragma unroll 1
  for (int idx = threadIdx.x; idx < ROWS * NV; idx += NTHREADS) {
    if constexpr (PER_TOKEN) {
      float f[8];
      const float t = __fmul_rn(s[idx / (8 * NV) * 8 + idx % 8], mul);
#pragma unroll
      for (int j = 0; j < 8; ++j) f[j] = t;
      reinterpret_cast<uint4*>(dst)[idx] = dequant8(reinterpret_cast<const uint2*>(src)[idx], f);
    } else {
      reinterpret_cast<uint4*>(dst)[idx] =
          dequant8(reinterpret_cast<const uint2*>(src)[idx], s + idx / 8 % NV * 8);
    }
  }
}

// ---- float32 on the tensor cores: 3xTF32 split products ---------------------
//
// One TF32 mma keeps 10 of a float32 operand's 23 mantissa bits. The split
// scheme keeps ~21: x = hi + lo with hi = tf32(x) (cvt.rna, round to nearest
// with ties away; the tensor core truncates the low 13 bits it ignores, so an
// unrounded hi would leave a biased remainder) and lo = tf32(x - hi), and
//   a·b ≈ a_lo·b_hi + a_hi·b_lo + a_hi·b_hi
// (a_lo·b_lo, ~2^-22 of a·b, dropped): three m16n8k8 TF32 mmas with float32
// accumulation. Every product of a split is exact in float32 (11 x 11
// significant bits), and the small terms go first so they add up before the
// large one. The tensor core's float32 sums truncate, so a long chain of
// mmas into one accumulator drifts: P·V sums each chunk's keys apart and adds
// them to o in float32 (on the card that took K4's largest error against the
// plain version from 9.7e-6 to ~2e-6). A split costs several instructions
// (cvt.rna is no single instruction on sm_90a), so the B operands (K, V) are
// split once per staged chunk for the whole block and stored as (hi, lo)
// float2 pairs; the A operands (q, P) are split in registers by each warp.

__device__ __forceinline__ uint32_t tf32_rna(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(r) : "f"(x));
  return r;
}

// (hi, lo) as the bits of two floats
__device__ __forceinline__ float2 split_tf32(float x) {
  const uint32_t hi = tf32_rna(x);
  return make_float2(__uint_as_float(hi),
                     __uint_as_float(tf32_rna(__fsub_rn(x, __uint_as_float(hi)))));
}

__device__ __forceinline__ void mma_tf32(float (&c)[4], const uint32_t (&a)[4], float b0,
                                         float b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(__float_as_uint(b0)),
        "r"(__float_as_uint(b1)));
}

// the four values of an A fragment, split
__device__ __forceinline__ void split_frag(const float (&x)[4], uint32_t (&hi)[4],
                                           uint32_t (&lo)[4]) {
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 s = split_tf32(x[i]);
    hi[i] = __float_as_uint(s.x);
    lo[i] = __float_as_uint(s.y);
  }
}

// c += a·b for a split A fragment and a split B fragment (b0, b1: (hi, lo)),
// the small terms first
__device__ __forceinline__ void mma_3xtf32(float (&c)[4], const uint32_t (&ah)[4],
                                           const uint32_t (&al)[4], float2 b0, float2 b1) {
  mma_tf32(c, al, b0.x, b1.x);
  mma_tf32(c, ah, b0.y, b1.y);
  mma_tf32(c, ah, b0.x, b1.x);
}

// The m16n8k8 fragments, with g = lane / 4 and t = lane % 4: A (16 x 8, row)
// holds [0] row g col t, [1] row g+8 col t, [2] row g col t+4, [3] row g+8
// col t+4; B (8 x 8, col) holds b0 row t and b1 row t+4 of col g; the
// accumulator c0/c1 row g cols 2t/2t+1, c2/c3 row g+8.

// One warp's q A fragments from its 16 rows of a row-major [16][LD] tile:
// qf[kk] covers head lanes 8kk..8kk+7.
template <int DP, int LD>
__device__ __forceinline__ void load_frag_f32(float (&qf)[DP / 8][4], const float* rows) {
  const int lane = threadIdx.x % 32, g = lane / 4, t = lane % 4;
#pragma unroll
  for (int kk = 0; kk < DP / 8; ++kk) {
    qf[kk][0] = rows[g * LD + kk * 8 + t];
    qf[kk][1] = rows[(g + 8) * LD + kk * 8 + t];
    qf[kk][2] = rows[g * LD + kk * 8 + t + 4];
    qf[kk][3] = rows[(g + 8) * LD + kk * 8 + t + 4];
  }
}

// One warp's q A fragments for Q·K^T: split once where the registers allow
// it (PRE; a head dim up to 64), else kept as floats and split per chunk.
template <int DP, bool PRE>
struct QFrags;

template <int DP>
struct QFrags<DP, true> {
  uint32_t hi[DP / 8][4], lo[DP / 8][4];
  __device__ __forceinline__ void set(const float (&x)[DP / 8][4]) {
#pragma unroll
    for (int kk = 0; kk < DP / 8; ++kk) split_frag(x[kk], hi[kk], lo[kk]);
  }
  __device__ __forceinline__ void get(int kk, uint32_t (&ah)[4], uint32_t (&al)[4]) const {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      ah[i] = hi[kk][i];
      al[i] = lo[kk][i];
    }
  }
};

template <int DP>
struct QFrags<DP, false> {
  float x[DP / 8][4];
  __device__ __forceinline__ void set(const float (&v)[DP / 8][4]) {
#pragma unroll
    for (int kk = 0; kk < DP / 8; ++kk)
#pragma unroll
      for (int i = 0; i < 4; ++i) x[kk][i] = v[kk][i];
  }
  __device__ __forceinline__ void get(int kk, uint32_t (&ah)[4], uint32_t (&al)[4]) const {
    split_frag(x[kk], ah, al);
  }
};

// One warp's 16 x NK scores s = q' k'^T against NK keys split row-major in
// ks [NK][LD] (key r's lane i at ks[r * LD + i]); s[j] holds keys 8j..8j+7 in
// the accumulator layout. LD ≡ 4 (mod 16) spreads each half-warp's 8-byte
// loads over all 32 banks.
template <int DP, int NK, int LD, bool PRE>
__device__ __forceinline__ void warp_qk_3xtf32(float (&s)[NK / 8][4], const QFrags<DP, PRE>& q,
                                               const float2* ks) {
  const int lane = threadIdx.x % 32, g = lane / 4, t = lane % 4;
#pragma unroll
  for (int j = 0; j < NK / 8; ++j) s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
#pragma unroll
  for (int kk = 0; kk < DP / 8; ++kk) {
    uint32_t ah[4], al[4];
    q.get(kk, ah, al);
#pragma unroll
    for (int j = 0; j < NK / 8; ++j) {
      const float2* kr = ks + (j * 8 + g) * LD + kk * 8 + t;
      mma_3xtf32(s[j], ah, al, kr[0], kr[4]);
    }
  }
}

// o += P·V for one warp's 16 x NK block P (in warp_qk_3xtf32's accumulator
// layout) and NK value rows split row-major in vs [NK][LD]: summed over the
// chunk's keys in accumulators of their own, then added to o in float32, so
// no accumulator chain runs over the whole sequence (the tensor core's
// float32 sums truncate; a chain of S/8 steps would bias o). The k8 step j
// feeds the keys a thread already holds, row g's 8j+2t and 8j+2t+1, as its A
// lanes t and t+4, and reads the same two keys' value rows as B's rows t and
// t+4: the sum over keys taken in another order, with no shuffle of P.
// LD ≡ 2 (mod 16) spreads each half-warp's loads over all banks.
template <int DP, int NK, int LD>
__device__ __forceinline__ void warp_pv_3xtf32(float (&o)[DP / 8][4],
                                               const float (&p)[NK / 8][4], const float2* vs) {
  const int lane = threadIdx.x % 32, g = lane / 4, t = lane % 4;
  float oc[DP / 8][4];
#pragma unroll
  for (int n = 0; n < DP / 8; ++n) oc[n][0] = oc[n][1] = oc[n][2] = oc[n][3] = 0.f;
#pragma unroll
  for (int j = 0; j < NK / 8; ++j) {
    const float a[4] = {p[j][0], p[j][2], p[j][1], p[j][3]};
    uint32_t ah[4], al[4];
    split_frag(a, ah, al);
    const float2* vr = vs + (j * 8 + 2 * t) * LD + g;
#pragma unroll
    for (int n = 0; n < DP / 8; ++n) mma_3xtf32(oc[n], ah, al, vr[n * 8], vr[LD + n * 8]);
  }
#pragma unroll
  for (int n = 0; n < DP / 8; ++n)
#pragma unroll
    for (int i = 0; i < 4; ++i) o[n][i] += oc[n][i];
}

// Copy tokens [r0, r0 + ROWS) of d float32 lanes (row stride rs) into dst
// [ROWS][ld] asynchronously: 16-byte copies where `vec` (d % 4 == 0 and every
// row 16-byte aligned), else 4-byte ones; rows past S are zero-filled, lanes
// d..ld left as they are.
template <int NTHREADS, int ROWS>
__device__ __forceinline__ void cp_async_rows_f32(float* dst, int ld, const float* base, int r0,
                                                  int S, size_t rs, int d, bool vec) {
  const int nv = vec ? d / 4 : d, step = vec ? 4 : 1;  // copies per row, lanes per copy
  for (int idx = threadIdx.x; idx < ROWS * nv; idx += NTHREADS) {
    const int r = idx / nv, c = (idx - r * nv) * step;
    const bool ok = r0 + r < S;
    const float* src = ok ? base + (size_t)(r0 + r) * rs + c : base;
    if (vec)
      cp_async16(dst + r * ld + c, src, ok);
    else
      cp_async4(dst + r * ld + c, src, ok);
  }
}

// Split a staged chunk src [ROWS][LDIN] (tokens r0.., DP lanes, zero-padded)
// into (hi, lo) pairs dst [ROWS][LD]. With RoPE, tab holds the chunk's
// staged table rows (cos [ROWS][d/2], then sin [ROWS][d/2]) and each pair
// (i, i + d/2) is rotated first (rot_pair's roundings, those of
// stage_rows_f).
template <int NTHREADS, int ROWS, int DP, int LDIN, int LD>
__device__ __forceinline__ void split_rows(float2* dst, const float* src, int d,
                                           const float* tab) {
  if (tab == nullptr) {
    for (int idx = threadIdx.x; idx < ROWS * DP / 4; idx += NTHREADS) {
      const int r = idx / (DP / 4), c = idx % (DP / 4) * 4;
      const float4 x = *reinterpret_cast<const float4*>(src + r * LDIN + c);
      const float2 a = split_tf32(x.x), b = split_tf32(x.y), e = split_tf32(x.z),
                   f = split_tf32(x.w);
      *reinterpret_cast<float4*>(dst + r * LD + c) = make_float4(a.x, a.y, b.x, b.y);
      *reinterpret_cast<float4*>(dst + r * LD + c + 2) = make_float4(e.x, e.y, f.x, f.y);
    }
    return;
  }
  const int half = d / 2;
  for (int idx = threadIdx.x; idx < ROWS * half; idx += NTHREADS) {
    const int r = idx / half, i = idx - r * half;
    float x1 = src[r * LDIN + i], x2 = src[r * LDIN + half + i];
    rot_pair<float>(x1, x2, tab[idx], tab[ROWS * half + idx]);
    dst[r * LD + i] = split_tf32(x1);
    dst[r * LD + half + i] = split_tf32(x2);
  }
  for (int idx = threadIdx.x; idx < ROWS * (DP - d); idx += NTHREADS)  // the padding lanes
    dst[idx / (DP - d) * LD + d + idx % (DP - d)] = make_float2(0.f, 0.f);
}

// Where head h of batch item b lives: q, k, v start at q + b*in_b + h*in_h
// (likewise k, v), token r at + r*in_r; the output at out + b*out_b +
// h*out_h + r*out_r. Element strides, shared by q, k and v.
template <typename T>
struct Heads {
  const T* q;
  const T* k;
  const T* v;
  void* out;
  size_t in_b, in_h, in_r, out_b, out_h, out_r;
};

// qkv packed [B, S, 3w] (head h's q, k, v the column slices h*d, w + h*d,
// 2w + h*d), out [B, S, w]
template <typename T>
Heads<T> packed_heads(const void* qkv, void* out, int S, int w, int d) {
  const T* p = static_cast<const T*>(qkv);
  const size_t rs = 3 * (size_t)w;
  return Heads<T>{p, p + w, p + 2 * w, out, (size_t)S * rs, (size_t)d, rs,
                  (size_t)S * w, (size_t)d, (size_t)w};
}

constexpr int TF32_KEYS = 32;  // keys per streamed chunk of the float32 kernel

// shared memory of the float32 kernel for head dim padded to DP (a multiple
// of 16): the staged K and V chunk [2][NK][DP + 4] floats, the split K
// [NK][DP + 4] and split V [NK][DP + 2] as (hi, lo) pairs, and with RoPE the
// chunk's cos and sin rows [2][NK][d/2]; the q tile is staged over them first
template <int DP>
constexpr size_t tf32_smem_bytes(bool rope) {
  return sizeof(float) * TF32_KEYS * (6 * DP + 20 + (rope ? DP : 0));
}

// blocks an SM should hold, which caps the registers a thread: at a head
// dim up to 64, 3 blocks of 4 warps (168 registers) or 2 of 8 (128, a few
// spilled), whose shared memory fits beside each other; above, one block,
// which takes what it needs (q then stays in floats, see QFrags)
constexpr int tf32_min_blocks(int DP, int WARPS) { return DP > 64 ? 1 : WARPS == 4 ? 3 : 2; }

// The float32 exact two-pass attention on the tensor cores, for K1 (WARPS =
// 4, 64 query rows a block), K4 (WARPS = 8, 128 rows) and, with PANELS, K5
// (WARPS = 8): one block per (query rows, head, batch item), each warp
// owning 16 rows with its q fragments, scores and output accumulators in
// registers; both products 3xTF32 (warp_qk_3xtf32, warp_pv_3xtf32). K, then
// K and V, stream through shared memory in 32-key chunks in both passes, so
// nothing grows with S: each chunk lands by cp.async, is split (k rotated
// first, with RoPE tables staged beside it) once for all warps, and the next
// chunk's copy is in flight while the warps multiply. Pass 1 takes the row
// max; pass 2 recomputes the identical scores (the same code on the same
// data), exponentiates against the max in float32, sums the unrounded p and
// accumulates P·V; the epilogue multiplies by 1/sum. q is scaled and rotated
// as it is staged. The head dim is zero-padded to DP in shared memory.
//
// Without PANELS the two passes run once over all S keys. With PANELS (K5's
// online softmax) they run over each k panel of kp keys in turn, keys at or
// past the panel's end loading as zeros and masked: after a panel's pass 1
// the running max m becomes m' = max(m, the panel's row max), and the sum l
// and every output accumulator are rescaled once by exp(m - m'); pass 2
// exponentiates against m'. The epilogue then divides by l, as K5 does. The
// copy of the next panel's first chunk is in flight during the last chunk of
// this one, so the ring never drains at a panel's end.
template <int DP, int WARPS, bool PANELS>
__global__ void __launch_bounds__(WARPS * 32, tf32_min_blocks(DP, WARPS)) exact_3xtf32_kernel(
    Heads<float> io, int S, int s_real, int d, float scale, int kp, bool vec,
    const float* __restrict__ cos, const float* __restrict__ sin) {
  constexpr int NT = WARPS * 32, MQ = WARPS * 16, NK = TF32_KEYS;
  constexpr int LDR = DP + 4;  // staged rows (floats); also the q tile's
  constexpr int LDK = DP + 4, LDV = DP + 2;  // split K and V rows (pairs)
  static_assert(DP % 16 == 0 && MQ * LDR <= NK * (2 * LDR + 2 * LDK + 2 * LDV),
                "the q tile is staged over the chunk buffers");
  extern __shared__ __align__(16) float tf32_smem[];
  float* Kr = tf32_smem;                                   // [NK][LDR] staged K chunk
  float* Vr = Kr + NK * LDR;                               // [NK][LDR] staged V chunk
  float2* Kp = reinterpret_cast<float2*>(Vr + NK * LDR);  // [NK][LDK] split K
  float2* Vp = Kp + NK * LDK;                              // [NK][LDV] split V
  float* Tb = reinterpret_cast<float*>(Vp + NK * LDV);     // [2][NK][d/2] cos, sin rows

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, t = lane % 4;
  const int q0 = blockIdx.x * MQ, h = blockIdx.y;
  const size_t head = blockIdx.z * io.in_b + h * io.in_h, rs = io.in_r;
  const float* kb = io.k + head;
  const float* vb = io.v + head;
  const int half = d / 2, panel = PANELS ? kp : S;
  const bool tvec = half % 4 == 0 && reinterpret_cast<uintptr_t>(cos) % 16 == 0 &&
                    reinterpret_cast<uintptr_t>(sin) % 16 == 0;

  // q scaled (and rotated) into shared memory [MQ][LDR], zero-padded, then
  // into registers
  stage_rows_f<float, NT, MQ>(tf32_smem, LDR, 1, io.q + head, q0, S, rs, 0, d, true, scale,
                              cos, sin);
  for (int idx = tid; idx < MQ * (DP - d); idx += NT)
    tf32_smem[idx / (DP - d) * LDR + d + idx % (DP - d)] = 0.f;
  __syncthreads();
  const int r0 = warp * 16;
  QFrags<DP, DP <= 64> qf;
  {
    float x[DP / 8][4];
    load_frag_f32<DP, LDR>(x, tf32_smem + r0 * LDR);
    qf.set(x);
  }
  __syncthreads();
  // zeros in the staging buffers: their padding lanes d..DP are never
  // written again
  for (int i = tid; i < NK * LDR / 2; i += NT)
    reinterpret_cast<float4*>(tf32_smem)[i] = make_float4(0.f, 0.f, 0.f, 0.f);
  __syncthreads();

  // staged chunk i of the 2·nc of the panel [p0, pend): K chunk i (and its
  // table rows) in pass 1, K and V chunk i - nc in pass 2; keys at or past
  // pend load as zeros
  auto issue = [&](int p0, int pend, int i) {
    const int nc = (pend - p0 + NK - 1) / NK;
    const int k0 = p0 + (i < nc ? i : i - nc) * NK;
    cp_async_rows_f32<NT, NK>(Kr, LDR, kb, k0, pend, rs, d, vec);
    if (i >= nc) cp_async_rows_f32<NT, NK>(Vr, LDR, vb, k0, pend, rs, d, vec);
    if (cos != nullptr) {
      cp_async_rows_f32<NT, NK>(Tb, half, cos, k0, pend, half, half, tvec);
      cp_async_rows_f32<NT, NK>(Tb + NK * half, half, sin, k0, pend, half, half, tvec);
    }
    cp_async_commit();
  };
  issue(0, min(panel, S), 0);
  // a warp whose 16 rows all lie past the sequence still stages and syncs,
  // but skips the products
  const bool live = q0 + r0 < S;

  float m0 = -INFINITY, m1 = -INFINITY, l0 = 0.f, l1 = 0.f;  // rows g and g+8
  float o[DP / 8][4];
#pragma unroll
  for (int n = 0; n < DP / 8; ++n) o[n][0] = o[n][1] = o[n][2] = o[n][3] = 0.f;
  for (int p0 = 0; p0 < S; p0 += panel) {
    const int pend = min(p0 + panel, S), kend = min(pend, s_real);
    const int nc = (pend - p0 + NK - 1) / NK;
    float pm0 = -INFINITY, pm1 = -INFINITY;  // the panel's row max
    for (int i = 0; i < 2 * nc; ++i) {
      const int k0 = p0 + (i < nc ? i : i - nc) * NK;
      cp_async_wait_all();  // chunk i has landed
      __syncthreads();      // for every thread, and the split buffers are free
      split_rows<NT, NK, DP, LDR, LDK>(Kp, Kr, d, cos != nullptr ? Tb : nullptr);
      if (i >= nc) split_rows<NT, NK, DP, LDR, LDV>(Vp, Vr, d, nullptr);
      __syncthreads();
      // in flight while the warps multiply
      if (i + 1 < 2 * nc)
        issue(p0, pend, i + 1);
      else if (PANELS && pend < S)
        issue(pend, min(pend + panel, S), 0);
      if (live) {
        float s[NK / 8][4];
        warp_qk_3xtf32<DP, NK, LDK>(s, qf, Kp);
#pragma unroll
        for (int j = 0; j < NK / 8; ++j) {
          const int key = k0 + j * 8 + 2 * t;
          if (key >= kend) s[j][0] = s[j][2] = -INFINITY;
          if (key + 1 >= kend) s[j][1] = s[j][3] = -INFINITY;
        }
        if (i < nc) {  // pass 1: the row max
#pragma unroll
          for (int j = 0; j < NK / 8; ++j) {
            pm0 = fmaxf(pm0, fmaxf(s[j][0], s[j][1]));
            pm1 = fmaxf(pm1, fmaxf(s[j][2], s[j][3]));
          }
        } else {  // pass 2: p = exp(s - max), its sum, O += P·V
#pragma unroll
          for (int j = 0; j < NK / 8; ++j) {
            s[j][0] = expf(s[j][0] - m0);
            s[j][1] = expf(s[j][1] - m0);
            s[j][2] = expf(s[j][2] - m1);
            s[j][3] = expf(s[j][3] - m1);
            l0 += s[j][0];
            l0 += s[j][1];
            l1 += s[j][2];
            l1 += s[j][3];
          }
          warp_pv_3xtf32<DP, NK, LDV>(o, s, Vp);
        }
      }
      if (i == nc - 1) {  // the four threads of a row hold its max in parts
        pm0 = fmaxf(pm0, __shfl_xor_sync(0xffffffffu, pm0, 1));
        pm0 = fmaxf(pm0, __shfl_xor_sync(0xffffffffu, pm0, 2));
        pm1 = fmaxf(pm1, __shfl_xor_sync(0xffffffffu, pm1, 1));
        pm1 = fmaxf(pm1, __shfl_xor_sync(0xffffffffu, pm1, 2));
        if constexpr (PANELS) {  // m' and the rescale by exp(m - m')
          if (live) {
            const float mn0 = fmaxf(m0, pm0), mn1 = fmaxf(m1, pm1);
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
            m0 = mn0;
            m1 = mn1;
          }
        } else {
          m0 = pm0;
          m1 = pm1;
        }
      }
    }
  }
  if (!live) return;
  l0 += __shfl_xor_sync(0xffffffffu, l0, 1);
  l0 += __shfl_xor_sync(0xffffffffu, l0, 2);
  l1 += __shfl_xor_sync(0xffffffffu, l1, 1);
  l1 += __shfl_xor_sync(0xffffffffu, l1, 2);
  // K5 divides by the sum; K1 and K4 multiply by its reciprocal
  const float inv0 = 1.0f / l0, inv1 = 1.0f / l1;
  auto norm = [&](float x, float l, float inv) { return PANELS ? x / l : x * inv; };
  const int row0 = q0 + r0 + g, row1 = row0 + 8;
  float* out = static_cast<float*>(io.out) + blockIdx.z * io.out_b + h * io.out_h;
#pragma unroll
  for (int n = 0; n < DP / 8; ++n) {
    const int col = n * 8 + 2 * t;
    if (row0 < S) {
      if (col < d) out[(size_t)row0 * io.out_r + col] = norm(o[n][0], l0, inv0);
      if (col + 1 < d) out[(size_t)row0 * io.out_r + col + 1] = norm(o[n][1], l0, inv0);
    }
    if (row1 < S) {
      if (col < d) out[(size_t)row1 * io.out_r + col] = norm(o[n][2], l1, inv1);
      if (col + 1 < d) out[(size_t)row1 * io.out_r + col + 1] = norm(o[n][3], l1, inv1);
    }
  }
}

template <int DP, int WARPS, bool PANELS>
int launch_3xtf32(Heads<float> io, int B, int S, int s_real, int heads, int d, float scale,
                  int kp, const void* cos, const void* sin, cudaStream_t stream) {
  const size_t smem = tf32_smem_bytes<DP>(cos != nullptr);
  cudaError_t err = cudaFuncSetAttribute(exact_3xtf32_kernel<DP, WARPS, PANELS>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  // 16-byte copies need every row of q, k and v 16-byte aligned
  const bool vec = d % 4 == 0 && io.in_b % 4 == 0 && io.in_h % 4 == 0 && io.in_r % 4 == 0 &&
                   reinterpret_cast<uintptr_t>(io.q) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(io.k) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(io.v) % 16 == 0;
  dim3 grid((S + WARPS * 16 - 1) / (WARPS * 16), heads, B);
  exact_3xtf32_kernel<DP, WARPS, PANELS><<<grid, WARPS * 32, smem, stream>>>(
      io, S, s_real, d, scale, kp, vec, static_cast<const float*>(cos),
      static_cast<const float*>(sin));
  return (int)cudaGetLastError();
}

// The float32 kernel for head dim d <= 128, padded to a multiple of 16 (to 32
// at least: 32, 64, 80, 96, 112 or 128 lanes). With PANELS, the softmax is
// rescaled at the ends of kp-key panels (K5); without, kp is not read.
template <int WARPS, bool PANELS = false>
int launch_f32_3xtf32(Heads<float> io, int B, int S, int s_real, int heads, int d, float scale,
                      const void* cos, const void* sin, cudaStream_t stream, int kp = 0) {
  if (d <= 32)
    return launch_3xtf32<32, WARPS, PANELS>(io, B, S, s_real, heads, d, scale, kp, cos, sin,
                                            stream);
  if (d <= 64)
    return launch_3xtf32<64, WARPS, PANELS>(io, B, S, s_real, heads, d, scale, kp, cos, sin,
                                            stream);
  if (d <= 80)
    return launch_3xtf32<80, WARPS, PANELS>(io, B, S, s_real, heads, d, scale, kp, cos, sin,
                                            stream);
  if (d <= 96)
    return launch_3xtf32<96, WARPS, PANELS>(io, B, S, s_real, heads, d, scale, kp, cos, sin,
                                            stream);
  if (d <= 112)
    return launch_3xtf32<112, WARPS, PANELS>(io, B, S, s_real, heads, d, scale, kp, cos, sin,
                                             stream);
  return launch_3xtf32<128, WARPS, PANELS>(io, B, S, s_real, heads, d, scale, kp, cos, sin,
                                           stream);
}

// ---- bfloat16 on Hopper's warpgroup tensor cores: the exact two-pass kernel --
//
// K1, K4, K5 and K10 in bfloat16, and the int8 wires of K3 and K7, one
// template (exact_wgmma_kernel<DP, PANELS, WIRE, TO>): one block of two
// warpgroups per (128 query rows, head, batch item), each warpgroup owning
// 64 rows, q, k and v read in place through the strides of Heads (the packed
// [B, S, 3w] qkv or K10's [B, h, S, d]; with RoPE, q and k from the
// pre-pass's scratch).
//   - K and V chunks of 64 keys come in by 16-byte cp.async into a ring of
//     three stages in shared memory, in 8 x 8 core matrices
//     (cp_async_core_bf16: eight threads fill 128 contiguous bytes, so no
//     store conflicts on banks and no padding). Two steps' copies are in
//     flight while the warpgroups multiply, with one barrier a step.
//   - Q·K^T is wgmma m64n64k16 with q and K both K-major in shared memory
//     (q from registers was slower at d = 64 on the H100: PERF.md §6).
//   - P·V is wgmma m64nDk16 (D = the head dim padded to 16) with P, rounded
//     to bf16, in the registers of the A operand (the accumulator layout of
//     Q·K^T is that operand's fragment layout), and V row-major in shared
//     memory: the MN-major B operand through wgmma's transpose bit, so V is
//     never transposed. The float32 accumulator of P·V stays in registers.
//   - Each product is waited for before its result is read (no ping-pong
//     between the warpgroups, no producer warp).
// The exact two-pass softmax: pass 1 takes each row's max over the K
// chunks; pass 2 recomputes the same scores (the same products on the same
// data), exponentiates against that max in float32, sums the unrounded p
// and accumulates bf16(p)·V. Keys at or past s_real get -inf.
//
// Without PANELS the two passes run once over all S keys. With PANELS (K5's
// online softmax) they run over each k panel of kp keys in turn: a chunk
// that crosses the panel's end loads the keys past it as zeros and masks
// them (the next panel loads them again); after a panel's pass 1 the running
// max m becomes m' = max(m, the panel's row max), the sum and the
// accumulator are rescaled once by exp(m - m'), and pass 2 exponentiates
// against m'. The ring runs one sequence of steps over all panels (for each
// panel its K chunks, then its K and V chunks), so the copies of the next
// panel's first chunk are in flight during this panel's last one.
//
// The int8 wires (WIRE, without panels) read int8 q, k and v and dequantize
// each to bf16(f32(x)·scale) in shared memory, as the TPU kernels do, with
// per-channel scales (K3: the head's 3·d lane scales, staged in shared
// memory once a block) or per-token ones (K7: one float a token, q's times
// the attention scale first; the q tile's 128 come in with it, each chunk's
// 64 by cp.async four steps ahead, after a step's barrier, into a ring of
// four slots, so shared memory does not grow with S). Their K and V chunks come in by 8-byte cp.async
// (cp_async_core_i8) into a two-stage int8 ring, two steps ahead; each thread
// waits for its own copies and converts exactly the bytes it copied
// (dequant_core) into the bf16 stage the descriptors read, so no barrier
// guards the int8 ring. The conversion of step i + 1 runs while step i's
// Q·K^T is in flight, and the step's one barrier publishes it (after
// fence.proxy.async); two bf16 stages then suffice, since a stage is
// rewritten only after every warpgroup has passed the barrier that ends the
// step reading it. The q tile is converted the same way before the first
// barrier.
//
// The output (TO): bf16; float32 (K1's and K7's quant_out, K7's float32);
// or int8 (K3), clip(rint(o / sum), -127, 127). The epilogue divides by the
// sum with PANELS (K5) or an int8 output (K3), as their TPU kernels do, and
// multiplies by its reciprocal otherwise (K1, K4, K7, K10).
//
// Per-sequence key lengths (VL, the bf16 wire of K1 and K5: the naflex
// towers' native-aspect rows, padded to one length): batch row b reads
// n = min(kv_len[b], S) from device memory once a block and runs as if its
// sequence were n tokens long (S = n, s_real = min(s_real, n)), so the key
// chunks and K5's panels at or past n are never loaded or multiplied (a
// panel past n would only have left m, l and the accumulator as they were),
// a query tile wholly past n returns at once, and the rows past n are never
// written: the wrapper allocates the output as zeros. The lengths' pointer
// travels as the scales' first (the bf16 wire reads no scales), so the
// kernel's parameters stay those of every fixed-length path, whose
// instantiations (without VL) compile as before: no prologue, nothing read.

constexpr int WG_Q = 128;   // query rows per block (2 warpgroups x 64)
constexpr int WG_K = 64;    // keys per streamed chunk
constexpr int WG_NT = 256;  // threads per block
constexpr int WG_ST = 3;    // stages of the bf16 wire's K/V ring

// what the kernel reads: bf16 q, k, v (K1, K4, K5, K10), or int8 with
// per-channel scales (K3) or per-token scales (K7)
constexpr int WIRE_BF16 = 0, WIRE_Q8_CHANNEL = 1, WIRE_Q8_TOKEN = 2;

template <int WIRE>
using WireT = std::conditional_t<WIRE == WIRE_BF16, __nv_bfloat16, int8_t>;

// the int8 wires' float32 scales: per channel (K3: the q, k and v sections
// of cs [3w], head h's lanes from + h·in_h), or per token (K7: q = k = v =
// ts [B, S])
struct Scales {
  const float* q;
  const float* k;
  const float* v;
};

// stages of the bf16 ring that the descriptors read
__host__ __device__ constexpr int wgmma_stages(int wire) {
  return wire == WIRE_BF16 ? WG_ST : 2;
}

constexpr int WG_TS = 4;  // K7's ring of chunk token scales

template <int DP, int WIRE>  // head dim padded to a multiple of 16
constexpr size_t wgmma_smem_bytes() {
  // the bf16 ring and q tile; an int8 wire adds its int8 ring [2][2][WG_K][DP]
  // and q tile [WG_Q][DP], and its scales: K3's lane scales of the head [3][DP]
  // or K7's token scales of the q tile [WG_Q] and of four chunks [WG_TS][WG_K]
  return sizeof(__nv_bfloat16) * (wgmma_stages(WIRE) * 2 * WG_K + WG_Q) * DP +
         (WIRE == WIRE_BF16 ? 0 : (2 * 2 * WG_K + WG_Q) * DP) +
         sizeof(float) * (WIRE == WIRE_Q8_CHANNEL   ? 3 * DP
                          : WIRE == WIRE_Q8_TOKEN ? WG_Q + WG_TS * WG_K
                                                  : 0);
}

// blocks an SM should hold, which caps the registers a thread: two (128
// registers) up to d = 96, where two blocks' shared memory fits an SM
constexpr int wgmma_min_blocks(int DP) { return DP <= 96 ? 2 : 1; }

// The RoPE pre-pass: q·T(scale) rotated and k rotated, each 16-byte vector
// of a head row's first half with its partner in the second half, with
// scale8 and rot8 (the roundings of rot_pair), into qk [B, S, 2w] (q' in
// columns [0, w), k' in [w, 2w)), from the packed qkv [B, S, 3w]. One
// thread per (token, q or k, head, pair of vectors).
__global__ void rope_prepass_kernel(const __nv_bfloat16* __restrict__ qkv,
                                    __nv_bfloat16* __restrict__ qk, int S, int w, int d,
                                    float scale, const __nv_bfloat16* __restrict__ cos,
                                    const __nv_bfloat16* __restrict__ sin, size_t n) {
  const size_t idx = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= n) return;
  const int per_row = w / 8;  // (q, k) x heads x d/16 pairs of vectors
  const size_t row = idx / per_row;
  const int e = (int)(idx % per_row), which = e / (w / 16), r = e % (w / 16);
  const int hv = d / 16, half = d / 2, h = r / hv, j = r % hv;
  const int col = which * w + h * d + j * 8, token = (int)(row % S);
  const __nv_bfloat16* src = qkv + row * 3 * (size_t)w + col;
  uint4 lo = *reinterpret_cast<const uint4*>(src);
  uint4 hi = *reinterpret_cast<const uint4*>(src + half);
  if (which == 0) {
    const __nv_bfloat162 scale2 = __float2bfloat162_rn(scale);
    scale8(lo, scale2);
    scale8(hi, scale2);
  }
  rot8(lo, hi, *reinterpret_cast<const uint4*>(cos + (size_t)token * half + j * 8),
       *reinterpret_cast<const uint4*>(sin + (size_t)token * half + j * 8));
  __nv_bfloat16* dst = qk + row * 2 * (size_t)w + col;
  *reinterpret_cast<uint4*>(dst) = lo;
  *reinterpret_cast<uint4*>(dst + half) = hi;
}

// q and k from `qk`'s pointers and strides (io's, or the pre-pass's scratch,
// there already scaled and rotated: `prescaled`), v and the output from io's.
// An int8 wire reads its scales from sc (K7 scales q by ts·scale). VL: sc.q
// is the per-sequence key lengths kv_len [B] (int32 on the device).
template <int DP, bool PANELS, int WIRE, typename TO, bool VL = false>
__global__ void __launch_bounds__(WG_NT, wgmma_min_blocks(DP)) exact_wgmma_kernel(
    Heads<WireT<WIRE>> qk, Heads<WireT<WIRE>> io, int S, int s_real, int d, float scale,
    int kp, bool prescaled, Scales sc) {
  using TI = WireT<WIRE>;
  constexpr bool Q8 = WIRE != WIRE_BF16;
  static_assert(!(Q8 && PANELS), "the int8 wires run without panels");
  static_assert(!(VL && Q8), "per-sequence lengths run on the bf16 wire");
  constexpr int NV = DP / 8;                 // core matrices along a row
  constexpr int ST = wgmma_stages(WIRE);     // stages of the bf16 ring
  constexpr int STAGE = 2 * WG_K * DP;       // one stage: K rows, then V rows
  constexpr uint32_t CORE = 128;             // bytes of a core matrix
  extern __shared__ __align__(128) unsigned char wgmma_smem[];
  __nv_bfloat16* ring = reinterpret_cast<__nv_bfloat16*>(wgmma_smem);  // [ST][2][WG_K][DP]
  __nv_bfloat16* qs = ring + ST * STAGE;                                 // [WG_Q][DP]
  // an int8 wire's cp.async ring [2][2][WG_K][DP] and q tile [WG_Q][DP],
  // and its scales: K3's lane scales of the head's q, k and v [3][DP] (0
  // past d), or K7's token scales of the q tile [WG_Q] and the ring of the
  // chunks' [WG_TS][WG_K] (0 past S)
  int8_t* ring8 = reinterpret_cast<int8_t*>(qs + WG_Q * DP);
  int8_t* q8 = ring8 + 2 * STAGE;
  float* wire_sc = reinterpret_cast<float*>(q8 + WG_Q * DP);

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, t = lane % 4;  // accumulator coordinates
  const int q0 = blockIdx.x * WG_Q, h = blockIdx.y;
  if constexpr (VL) {  // this batch row as a sequence of its own length
    S = min(max(reinterpret_cast<const int*>(sc.q)[blockIdx.z], 0), S);
    s_real = min(s_real, S);
    if (q0 >= S) return;
  }
  const size_t src = blockIdx.z * qk.in_b + h * qk.in_h, qrs = qk.in_r, vrs = io.in_r;
  const TI* kb = qk.k + src;
  const TI* vb = io.v + blockIdx.z * io.in_b + h * io.in_h;
  const int ncp = ((PANELS ? kp : S) + WG_K - 1) / WG_K;  // chunks of a whole panel
  constexpr bool TOK = WIRE == WIRE_Q8_TOKEN;
  static_assert(WG_TS * WG_K == WG_NT, "the first WG_TS steps' scales: one a thread");
  // K7: token j of step i's 64 token scales (the keys of its K or V chunk)
  // into slot i % WG_TS of the scale ring
  auto copy_scales = [&](int i, int j) {
    if constexpr (TOK) {
      const int nc = (S + WG_K - 1) / WG_K;
      if (i < 2 * nc) {
        const unsigned z = blockIdx.z;
        const int r = (i < nc ? i : i - nc) * WG_K + j;
        cp_async4(wire_sc + WG_Q + (i % WG_TS) * WG_K + j, sc.q + (size_t)z * S + (r < S ? r : 0),
                  r < S);
      }
    }
  };

  // step i: in the panel [p0, pend) of nc chunks, K chunk c in pass 1 (c <
  // nc) or K and V chunk c - nc in pass 2, into stage i % WG_ST (an int8
  // wire: its int8 ring's stage i % 2); keys at or past the panel's end load
  // as zeros. Without PANELS one panel holds all S keys. Every step commits
  // one group (empty past the last), so a thread's groups count steps.
  auto copy_step = [&](int i) {
    int p0 = 0, pend = S, c = i;
    if constexpr (PANELS) {
      const int pi = i / (2 * ncp);
      p0 = pi * kp;
      pend = min(p0 + kp, S);
      c = i - pi * 2 * ncp;
    }
    const int nc = (pend - p0 + WG_K - 1) / WG_K;
    if (p0 < S && c < 2 * nc) {
      const int k0 = p0 + (c < nc ? c : c - nc) * WG_K;
      if constexpr (Q8) {
        int8_t* st = ring8 + (i % 2) * STAGE;
        cp_async_core_i8<WG_NT, WG_K, DP>(st, kb, k0, pend, qrs, d);
        if (c >= nc) cp_async_core_i8<WG_NT, WG_K, DP>(st + WG_K * DP, vb, k0, pend, vrs, d);
      } else {
        __nv_bfloat16* st = ring + (i % WG_ST) * STAGE;
        cp_async_core_bf16<WG_NT, WG_K, DP>(st, kb, k0, pend, qrs, 0, d);
        if (c >= nc) cp_async_core_bf16<WG_NT, WG_K, DP>(st + WG_K * DP, vb, k0, pend, vrs, 0, d);
      }
    }
    cp_async_commit();
  };
  // an int8 wire: step i's chunk from this thread's own bytes of the int8
  // ring into bf16 stage i % ST (the group of step i has landed once at most
  // the next step's is in flight), then step i + 2's copy into the int8
  // stage just read (K7's token scales of step i, copied by other threads,
  // were published by an earlier barrier: see next)
  auto convert_step = [&](int i) {
    if constexpr (Q8) {
      cp_async_wait<1>();
      const int nc = (S + WG_K - 1) / WG_K;
      if (i < 2 * nc) {
        const int8_t* s8 = ring8 + (i % 2) * STAGE;
        __nv_bfloat16* st = ring + (i % ST) * STAGE;
        const float* ks = TOK ? wire_sc + WG_Q + (i % WG_TS) * WG_K : wire_sc + DP;
        dequant_core<WG_NT, WG_K, DP, TOK>(st, s8, ks, 1.0f);
        if (i >= nc)
          dequant_core<WG_NT, WG_K, DP, TOK>(st + WG_K * DP, s8 + WG_K * DP,
                                             TOK ? ks : wire_sc + 2 * DP, 1.0f);
      }
      copy_step(i + 2);
    }
  };
  // the q tile first (the oldest group; K7's with its token scales and the
  // first WG_TS steps'), then the first WG_ST - 1 steps
  if constexpr (Q8) {
    if constexpr (TOK) {
      const float* ts = sc.q + blockIdx.z * (size_t)S;
      if (tid < WG_Q) cp_async4(wire_sc + tid, ts + (q0 + tid < S ? q0 + tid : 0), q0 + tid < S);
      copy_scales(tid / WG_K, tid % WG_K);
    } else {
      for (int i = tid; i < 3 * DP; i += WG_NT) {
        const int sec = i / DP, c = i - sec * DP;
        const float* p = sec == 0 ? sc.q : sec == 1 ? sc.k : sc.v;
        wire_sc[i] = c < d ? p[h * io.in_h + c] : 0.f;
      }
    }
    cp_async_core_i8<WG_NT, WG_Q, DP>(q8, qk.q + src, q0, S, qrs, d);
  } else {
    cp_async_core_bf16<WG_NT, WG_Q, DP>(qs, qk.q + src, q0, S, qrs, 0, d);
  }
  cp_async_commit();
#pragma unroll
  for (int i = 0; i < WG_ST - 1; ++i) copy_step(i);
  cp_async_wait<WG_ST - 1>();  // this thread's copies of the q tile have landed
  if constexpr (Q8) {
    __syncthreads();  // the scales
    // q dequantized (K3's q lane scales carry the attention scale; K7's q
    // scale is ts·scale), then step 0's chunk
    dequant_core<WG_NT, WG_Q, DP, TOK>(qs, q8, wire_sc, scale);
    convert_step(0);
  } else if (!prescaled) {  // q·T(scale) where it lies (the scale rounded to bf16 first):
    // each thread scales the vectors it copied (cp_async_core_bf16's order)
    const __nv_bfloat162 scale2 = __float2bfloat162_rn(scale);
    for (int i = tid; i < WG_Q * DP / 8; i += WG_NT) {
      uint4 v = reinterpret_cast<uint4*>(qs)[i];
      scale8(v, scale2);
      reinterpret_cast<uint4*>(qs)[i] = v;
    }
  }
  fence_proxy_async();
  __syncthreads();
  // this warpgroup's 64 rows of q: A K-major (core matrices along the head
  // dim 128 bytes apart, along the rows NV·128)
  const uint64_t qdesc = gmma_desc(qs + (warp / 4) * 8 * NV * 64, CORE, NV * CORE);
  // a warpgroup whose 64 rows all lie past the sequence still stages (and
  // converts) and syncs, but skips the products (wgmma runs per warpgroup)
  const bool live = q0 + (warp / 4) * 64 < S;
  int i = 0;  // step

  // this warpgroup's 64 x WG_K scores against the staged K chunk (B
  // K-major, laid out as q): each warp's s[j] holds keys 8j.. in the
  // accumulator layout; keys at or past kend get -inf. An int8 wire converts
  // the next step's chunk while the product runs.
  auto scores = [&](float (&s)[WG_K / 8][4], const __nv_bfloat16* ks_, int k0, int kend) {
    const uint64_t kdesc = gmma_desc(ks_, CORE, NV * CORE);
    wgmma_fence();
#pragma unroll
    for (int ks = 0; ks < DP / 16; ++ks)  // k16 steps: two core matrices along the head dim
      wgmma_ss_n64(s, qdesc + ks * (2 * CORE >> 4), kdesc + ks * (2 * CORE >> 4), ks > 0);
    wgmma_commit();
    convert_step(i + 1);
    wgmma_wait0();
    wgmma_settle(s);
#pragma unroll
    for (int j = 0; j < WG_K / 8; ++j) {
      const int key = k0 + j * 8 + 2 * t;
      if (key >= kend) s[j][0] = s[j][2] = -INFINITY;
      if (key + 1 >= kend) s[j][1] = s[j][3] = -INFINITY;
    }
  };
  // wait for step i's chunk, then one barrier: every thread's copies (or
  // conversions) have landed (and are visible to wgmma) and every warpgroup
  // is done with step i - 1, whose stage step i + WG_ST - 1 then refills
  // while the warpgroups multiply (an int8 wire refills it as it converts).
  // K7 then copies step i + WG_TS's token scales, which join the group of
  // step i + 3; each thread waits for that group before the barrier of step
  // i + 3, after which step i + 4 converts. Their slot's last reader,
  // step i's conversion, ran before this barrier. (Issued in the conversion,
  // inside Q·K^T's window, these copies made K7 spill at d = 64 and 80.)
  auto next = [&](int i) {
    if constexpr (!Q8) cp_async_wait<WG_ST - 2>();
    fence_proxy_async();
    __syncthreads();
    if constexpr (!Q8) copy_step(i + WG_ST - 1);
    if (TOK && tid < WG_K) copy_scales(i + WG_TS, tid);
    return ring + (i % ST) * STAGE;
  };

  float m0 = -INFINITY, m1 = -INFINITY, l0 = 0.f, l1 = 0.f;  // rows g and g+8 of this warp
  float o[DP / 8][4];
#pragma unroll
  for (int n = 0; n < DP / 8; ++n) o[n][0] = o[n][1] = o[n][2] = o[n][3] = 0.f;
  // the two passes over the keys [p0, pend)
  auto run_panel = [&](int p0, int pend) {
    const int kend = min(pend, s_real), nc = (pend - p0 + WG_K - 1) / WG_K;
    // --- pass 1: the row max over the panel's keys ---------------------
    float pm0 = -INFINITY, pm1 = -INFINITY;
    for (int c = 0; c < nc; ++c, ++i) {
      const __nv_bfloat16* st = next(i);
      if (!live) {
        convert_step(i + 1);
        continue;
      }
      float s[WG_K / 8][4];
      scores(s, st, p0 + c * WG_K, kend);
#pragma unroll
      for (int j = 0; j < WG_K / 8; ++j) {
        pm0 = fmaxf(pm0, fmaxf(s[j][0], s[j][1]));
        pm1 = fmaxf(pm1, fmaxf(s[j][2], s[j][3]));
      }
    }
    // the four threads of a row hold its max in parts
    pm0 = fmaxf(pm0, __shfl_xor_sync(0xffffffffu, pm0, 1));
    pm0 = fmaxf(pm0, __shfl_xor_sync(0xffffffffu, pm0, 2));
    pm1 = fmaxf(pm1, __shfl_xor_sync(0xffffffffu, pm1, 1));
    pm1 = fmaxf(pm1, __shfl_xor_sync(0xffffffffu, pm1, 2));
    if constexpr (PANELS) {  // m' and the rescale by exp(m - m')
      const float mn0 = fmaxf(m0, pm0), mn1 = fmaxf(m1, pm1);
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
      m0 = mn0;
      m1 = mn1;
    } else {
      m0 = pm0;
      m1 = pm1;
    }
    // --- pass 2: the same scores, P = bf16(exp(s - m)) in the registers
    // of wgmma's A operand, O += P V ------------------------------------
    for (int c = 0; c < nc; ++c, ++i) {
      const __nv_bfloat16* st = next(i);
      if (!live) {
        convert_step(i + 1);
        continue;
      }
      float s[WG_K / 8][4];
      scores(s, st, p0 + c * WG_K, kend);
      uint32_t pa[WG_K / 16][4];
#pragma unroll
      for (int j = 0; j < WG_K / 8; ++j) {
        const float e0 = expf(s[j][0] - m0), e1 = expf(s[j][1] - m0);
        const float e2 = expf(s[j][2] - m1), e3 = expf(s[j][3] - m1);
        l0 += e0;
        l0 += e1;
        l1 += e2;
        l1 += e3;
        pa[j / 2][(j % 2) * 2] = pack_bf16(e0, e1);
        pa[j / 2][(j % 2) * 2 + 1] = pack_bf16(e2, e3);
      }
      // V stays row-major: B MN-major, its core matrices along the head
      // dim (N) 128 bytes apart, along the keys (K) NV·128
      const uint64_t vdesc = gmma_desc(st + WG_K * DP, NV * CORE, CORE);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < WG_K / 16; ++kk)  // k16 steps: two core matrices of keys
        wgmma_rs<DP>(o, pa[kk], vdesc + kk * (2 * NV * CORE >> 4), 1);
      wgmma_commit();
      wgmma_wait0();
      wgmma_settle(o);
    }
  };
  if constexpr (PANELS) {
    for (int p0 = 0; p0 < S; p0 += kp) run_panel(p0, min(p0 + kp, S));
  } else {
    run_panel(0, S);
  }
  cp_async_wait<0>();  // no copy outlives the block
  if (!live) return;
  l0 += __shfl_xor_sync(0xffffffffu, l0, 1);
  l0 += __shfl_xor_sync(0xffffffffu, l0, 2);
  l1 += __shfl_xor_sync(0xffffffffu, l1, 1);
  l1 += __shfl_xor_sync(0xffffffffu, l1, 2);
  // K5 and K3 divide by the sum; K1, K4, K7 and K10 multiply by its reciprocal
  constexpr bool DIV = PANELS || std::is_same_v<TO, int8_t>;
  const float inv0 = 1.0f / l0, inv1 = 1.0f / l1;
  auto norm = [&](float x, float l, float inv) { return DIV ? x / l : x * inv; };
  const int row0 = q0 + warp * 16 + g, row1 = row0 + 8;
  const size_t ohead = blockIdx.z * io.out_b + h * io.out_h;
#pragma unroll
  for (int n = 0; n < DP / 8; ++n) {
    const int col = n * 8 + 2 * t;
    if (col >= d) continue;
    const size_t i0 = ohead + (size_t)row0 * io.out_r + col, i1 = i0 + 8 * io.out_r;
    const float y0 = norm(o[n][0], l0, inv0), y1 = norm(o[n][1], l0, inv0);
    const float y2 = norm(o[n][2], l1, inv1), y3 = norm(o[n][3], l1, inv1);
    if constexpr (std::is_same_v<TO, float>) {  // e.g. quant_out: for the row quantize
      float* of = static_cast<float*>(io.out);
      if (row0 < S) *reinterpret_cast<float2*>(of + i0) = make_float2(y0, y1);
      if (row1 < S) *reinterpret_cast<float2*>(of + i1) = make_float2(y2, y3);
    } else if constexpr (std::is_same_v<TO, int8_t>) {  // round half to even, clip to ±127
      auto q = [](float x) { return (signed char)fminf(fmaxf(rintf(x), -127.f), 127.f); };
      int8_t* o8 = static_cast<int8_t*>(io.out);
      if (row0 < S) *reinterpret_cast<char2*>(o8 + i0) = make_char2(q(y0), q(y1));
      if (row1 < S) *reinterpret_cast<char2*>(o8 + i1) = make_char2(q(y2), q(y3));
    } else {
      __nv_bfloat16* ob = static_cast<__nv_bfloat16*>(io.out);
      if (row0 < S) *reinterpret_cast<__nv_bfloat162*>(ob + i0) = __floats2bfloat162_rn(y0, y1);
      if (row1 < S) *reinterpret_cast<__nv_bfloat162*>(ob + i1) = __floats2bfloat162_rn(y2, y3);
    }
  }
}

template <int DP, bool PANELS, int WIRE, typename TO, bool VL = false>
int launch_wgmma(Heads<WireT<WIRE>> qk, Heads<WireT<WIRE>> io, int B, int S, int s_real,
                 int heads, int d, float scale, int kp, bool prescaled, Scales sc,
                 cudaStream_t stream) {
  const size_t smem = wgmma_smem_bytes<DP, WIRE>();
  cudaError_t err = cudaFuncSetAttribute(exact_wgmma_kernel<DP, PANELS, WIRE, TO, VL>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((S + WG_Q - 1) / WG_Q, heads, B);
  exact_wgmma_kernel<DP, PANELS, WIRE, TO, VL><<<grid, WG_NT, smem, stream>>>(
      qk, io, S, s_real, d, scale, kp, prescaled, sc);
  return (int)cudaGetLastError();
}

// The bfloat16 kernel for head dim d <= 128, d % 8 == 0 (16-byte copies),
// padded to a multiple of 16 (64 at least). With RoPE tables (cos, sin [S,
// d/2] bf16, d % 16 == 0; io then the packed layout of packed_heads), the
// pre-pass first writes q·T(scale) and k rotated into scratch, a [B, S, 2w]
// bf16 buffer the caller allocates, and the kernel reads q and k there.
// With PANELS, the softmax is rescaled at the ends of kp-key panels (K5);
// without, kp is not read. TO: the output type (bf16 or float32). VL: the
// per-sequence key lengths kv_len [B] (int32 on the device), the output
// zeroed by the caller.
template <bool PANELS, typename TO = __nv_bfloat16, bool VL = false>
int launch_bf16_wgmma(Heads<__nv_bfloat16> io, int B, int S, int s_real, int heads, int d,
                      float scale, const void* cos, const void* sin, void* scratch,
                      cudaStream_t stream, int kp = 0, const int* kv_len = nullptr) {
  if (VL && kv_len == nullptr) return (int)cudaErrorInvalidValue;
  if (d % 8 != 0) return (int)cudaErrorInvalidValue;
  if (cos != nullptr && (d % 16 != 0 || scratch == nullptr)) return (int)cudaErrorInvalidValue;
  Heads<__nv_bfloat16> qk = io;
  if (cos != nullptr) {  // rotate (and scale q) once, into the scratch
    const int w = heads * d;
    const size_t n = (size_t)B * S * (w / 8);
    __nv_bfloat16* x = static_cast<__nv_bfloat16*>(scratch);
    rope_prepass_kernel<<<(unsigned)((n + 255) / 256), 256, 0, stream>>>(
        io.q, x, S, w, d, scale, static_cast<const __nv_bfloat16*>(cos),
        static_cast<const __nv_bfloat16*>(sin), n);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    qk.q = x;
    qk.k = x + w;
    qk.in_b = (size_t)S * 2 * w;
    qk.in_r = 2 * (size_t)w;
  }
  const bool pre = cos != nullptr;
  const Scales sc{reinterpret_cast<const float*>(kv_len), nullptr, nullptr};  // VL: the lengths
  if (d <= 64)
    return launch_wgmma<64, PANELS, WIRE_BF16, TO, VL>(qk, io, B, S, s_real, heads, d,
                                                       scale, kp, pre, sc, stream);
  if (d <= 80)
    return launch_wgmma<80, PANELS, WIRE_BF16, TO, VL>(qk, io, B, S, s_real, heads, d,
                                                       scale, kp, pre, sc, stream);
  if (d <= 96)
    return launch_wgmma<96, PANELS, WIRE_BF16, TO, VL>(qk, io, B, S, s_real, heads, d,
                                                       scale, kp, pre, sc, stream);
  if (d <= 112)
    return launch_wgmma<112, PANELS, WIRE_BF16, TO, VL>(qk, io, B, S, s_real, heads, d,
                                                        scale, kp, pre, sc, stream);
  return launch_wgmma<128, PANELS, WIRE_BF16, TO, VL>(qk, io, B, S, s_real, heads, d,
                                                      scale, kp, pre, sc, stream);
}

// An int8 wire (K3: WIRE_Q8_CHANNEL, K7: WIRE_Q8_TOKEN) on the packed int8
// qkv [B, S, 3w] (8-byte aligned), out [B, S, w] of TO; head dim d = w /
// heads <= 128, d % 8 == 0 (8-byte copies; the C entries check both),
// padded to a multiple of 16 (64 at least). scale: K7's attention scale
// (K3's is in its q lane scales).
template <int WIRE, typename TO>
int launch_q8_wgmma(const void* qkv, void* out, Scales sc, int B, int S, int s_real, int w,
                    int heads, float scale, cudaStream_t stream) {
  const int d = w / heads;
  const Heads<int8_t> io = packed_heads<int8_t>(qkv, out, S, w, d);
  if (d <= 64)
    return launch_wgmma<64, false, WIRE, TO>(io, io, B, S, s_real, heads, d, scale, 0, false, sc,
                                             stream);
  if (d <= 80)
    return launch_wgmma<80, false, WIRE, TO>(io, io, B, S, s_real, heads, d, scale, 0, false, sc,
                                             stream);
  if (d <= 96)
    return launch_wgmma<96, false, WIRE, TO>(io, io, B, S, s_real, heads, d, scale, 0, false, sc,
                                             stream);
  if (d <= 112)
    return launch_wgmma<112, false, WIRE, TO>(io, io, B, S, s_real, heads, d, scale, 0, false,
                                              sc, stream);
  return launch_wgmma<128, false, WIRE, TO>(io, io, B, S, s_real, heads, d, scale, 0, false, sc,
                                            stream);
}

}  // namespace
