// Int8 GEMM for Hopper (sm_90a) on the warpgroup tensor cores (wgmma) with a
// TMA ring, and a float32 epilogue, plain C interface: the GEMM of the fused
// W8A8 linear K9 and of the fused block linear K8.
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
//          output row: int8 and amax * f32(1/127) row scales. No output
//          tile owns a whole output row, as K1's quant_out (same pass).
//   q_matmul_pre (int8_static's block products, and the int8 routes whose
//       rows come quantized): q_block_linear_gemm alone, act 0, over int8
//       rows quantized before it, with K9's epilogue and the residual; xs
//       one per-tensor scale (xs_stride 0: xs[0] serves every row) or [M]
//       row scales (xs_stride 1), ops/quant._dequant_epilogue's order.
//   q_matmul_pre_act_q8 (int8_static's fc1, whose output only fc2 reads):
//       q_gemm_hidden_q8, the same GEMM and epilogue to the bf16 value fc1
//       wrote before; then what the chain ran on that bf16 value on its way
//       into fc2 (the bf16 activation, quant_static under fc2's calibrated
//       amax) is read from a table of all 65,536 bf16 values' results, built
//       by those torch operations on the card, and written as int8 [M, N]
//       (hidden_q8).
// That is the TPU kernels' arithmetic in their order. The int32 sums are
// exact in any order, so the outputs do not depend on the schedule below.
//
// What bounds it: 2·M·N·K int8 operations against M·K·2 + N·K + M·N·2 bytes;
// at ViT-L's shapes (M = 9232 or 18464, K, N in {1024, 3072, 4096}) that is
// ~750-800 operations per byte, above the H100's int8 ridge (~590), so the
// tensor cores bound it, except the 1024 x 1024 product (~500: memory
// bound). K8's residual (M·N·2 more bytes) and quant_out (an f32 round trip,
// 8·M·N bytes) move its 1024→1024 and 1024→4096 cases toward the memory
// bound.
//
// Design: a persistent kernel, one block of three warpgroups on each SM,
// walking 128 x BN output tiles (BN = 256, or 128 where that leaves at
// least 10% less work on the busiest SM, as at N = 1024) in row-major order,
// tile t = blockIdx.x + i * gridDim.x. Both operands are K-major in device memory (xq [M, K], the
// weight [N, K]), as int8 wgmma wants them, so they go to shared memory as
// they are: 128-byte k slices by TMA (cp.async.bulk.tensor, one 2-D tensor
// map each, built on the host through cudaGetDriverEntryPoint) in the
// 128-byte swizzle, into a ring of ST stages (4 at BN = 256, 6 at 128: 192
// KB) guarded by mbarriers: "full" (the TMA bytes arrived) and "empty" (the
// eight consumer warps are done with the stage). Warpgroup 0 is the
// producer: one thread issues the copies and runs ahead through the ring,
// across tile boundaries, so the next tile's slices arrive during this
// one's epilogue; it gives up its registers (setmaxnreg 40). Warpgroups 1
// and 2 are the consumers (setmaxnreg 232): each owns 64 rows of the tile
// and issues wgmma.m64nBNk32.s32.s8.s8 four times a slice, keeping one
// slice's products in flight (it frees a stage when the next slice's
// products are issued), with the int32 sums in registers (BN / 2 a thread).
// TMA fills the box past K, M and N with zeros, so the K tail adds nothing
// to a sum; the epilogue masks rows past M and columns past N. TMA needs
// 16-byte aligned rows, which K % 16 == 0 and 16-byte aligned operands (the
// wrapper's conditions) give. The epilogue runs while the tensor cores of
// the SM wait, so its memory traffic is what it is built around: each
// thread holds rows 16·warp + lane / 4 and + 8 of the consumer's 64, columns
// 8j + 2·(lane % 4) and the next, of the accumulator fragment; where N % 8
// == 0 and the vectors are 16-byte aligned, the four lanes of a quad first
// swap their sums by shuffles so that each holds 8 contiguous columns, read
// those columns' scales and biases (and the residual) by 16-byte loads,
// once for both rows, and write 8 outputs a store; otherwise they go a
// column pair at a time. The activation and the residual are compiled in
// only where asked for. The wgmma and mbarrier helpers are this file's own:
// attention_common.cuh's define to_f as rowquant_common.cuh does.

#include <cuda.h>  // CUtensorMap and its enums (types only: no libcuda link)

#include "rowquant_common.cuh"

namespace {

constexpr int BM = 128;       // output rows of a tile: two consumer warpgroups of 64
constexpr int BK = 128;       // k slice: 128 int8 = one 128-byte swizzle row
constexpr int NTH = 384;      // producer warpgroup + two consumer warpgroups
constexpr int A_BYTES = BM * BK;

__host__ __device__ constexpr int ring_stages(int bn) { return bn == 256 ? 4 : 6; }
__host__ __device__ constexpr int stage_bytes(int bn) { return A_BYTES + bn * BK; }
// the ring, and 1024 bytes to align it (the 128-byte swizzle repeats every 1024)
__host__ __device__ constexpr int ring_smem(int bn) {
  return ring_stages(bn) * stage_bytes(bn) + 1024;
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// ---- mbarriers and TMA -------------------------------------------------------

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(bar)), "r"(count)
               : "memory");
}

// wait until the barrier's phase of this parity has completed
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t a = smem_u32(bar);
  uint32_t done = 0;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(a), "r"(parity)
        : "memory");
  } while (!done);
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_u32(bar)) : "memory");
}

// one arrival, and `bytes` of TMA data to wait for
__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_u32(bar)),
               "r"(bytes)
               : "memory");
}

// the box of `map` at (c0 along K, c1 along the rows) into dst; its bytes
// complete on bar
__device__ __forceinline__ void tma_load_2d(void* dst, const CUtensorMap* map, uint64_t* bar,
                                            int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4}], [%2];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0), "r"(c1)
      : "memory");
}

// ---- int8 wgmma ----------------------------------------------------------------
//
// A K-major operand in the 128-byte swizzle, as TMA writes it: row r of the
// tile at r * 128 bytes, its 16-byte chunks permuted by r % 8; 8-row groups
// 1024 bytes apart (SBO), LBO unused; layout type 1 (128B) in bits 62-63.
// The tile must start on 1024 bytes; the k32 step within a row moves the
// start address by 32 bytes.
__device__ __forceinline__ uint64_t desc_sw128(const void* p) {
  return (uint64_t)((smem_u32(p) & 0x3FFFF) >> 4) | (uint64_t)1 << 16 |
         (uint64_t)(1024 >> 4) << 32 | (uint64_t)1 << 62;
}

#define WG_R4(j) "+r"(d[j][0]), "+r"(d[j][1]), "+r"(d[j][2]), "+r"(d[j][3])

// d (64 x 128, int32) = A·B + (scale_d ? d : 0): A (64 x 32) and B (128 x 32)
// int8, both K-major in shared memory
__device__ __forceinline__ void wgmma_s8_n128(int (&d)[16][4], uint64_t a, uint64_t b,
                                              int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k32.s32.s8.s8 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p;\n}\n"
      : WG_R4(0), WG_R4(1), WG_R4(2), WG_R4(3),
        WG_R4(4), WG_R4(5), WG_R4(6), WG_R4(7),
        WG_R4(8), WG_R4(9), WG_R4(10), WG_R4(11),
        WG_R4(12), WG_R4(13), WG_R4(14), WG_R4(15)
      : "l"(a), "l"(b), "r"(scale_d));
}

// d (64 x 256, int32) = A·B + (scale_d ? d : 0): A (64 x 32) and B (256 x 32)
// int8, both K-major in shared memory
__device__ __forceinline__ void wgmma_s8_n256(int (&d)[32][4], uint64_t a, uint64_t b,
                                              int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %130, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k32.s32.s8.s8 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, "
      "%96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, "
      "%110, %111, %112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, "
      "%123, %124, %125, %126, %127"
      "}, %128, %129, p;\n}\n"
      : WG_R4(0), WG_R4(1), WG_R4(2), WG_R4(3),
        WG_R4(4), WG_R4(5), WG_R4(6), WG_R4(7),
        WG_R4(8), WG_R4(9), WG_R4(10), WG_R4(11),
        WG_R4(12), WG_R4(13), WG_R4(14), WG_R4(15),
        WG_R4(16), WG_R4(17), WG_R4(18), WG_R4(19),
        WG_R4(20), WG_R4(21), WG_R4(22), WG_R4(23),
        WG_R4(24), WG_R4(25), WG_R4(26), WG_R4(27),
        WG_R4(28), WG_R4(29), WG_R4(30), WG_R4(31)
      : "l"(a), "l"(b), "r"(scale_d));
}

#undef WG_R4

template <int BN>
__device__ __forceinline__ void wgmma_s8(int (&d)[BN / 8][4], uint64_t a, uint64_t b,
                                         int scale_d) {
  if constexpr (BN == 256) wgmma_s8_n256(d, a, b, scale_d);
  else wgmma_s8_n128(d, a, b, scale_d);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

// wait until at most N committed groups of products are in flight
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// after wgmma_wait<0>: the sums' registers hold the products from here on
// (keeps the compiler from reading them before the wait)
template <int NJ>
__device__ __forceinline__ void wgmma_settle(int (&d)[NJ][4]) {
#pragma unroll
  for (int j = 0; j < NJ; ++j)
#pragma unroll
    for (int i = 0; i < 4; ++i) asm volatile("" : "+r"(d[j][i])::"memory");
}

// ---- the epilogue's stores ---------------------------------------------------

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

template <> __device__ __forceinline__ void store2<int8_t>(int8_t* p, float a, float b) {
  *reinterpret_cast<char2*>(p) = make_char2((signed char)a, (signed char)b);
}
template <> __device__ __forceinline__ int8_t cast_out<int8_t>(float v) { return (int8_t)v; }

// ---- the int8 hidden of int8_static's MLP (TO int8_t) ------------------------
//
// The epilogue's float32 y rounded to bf16 is the value fc1 wrote before; its
// 16 bits index the table in res's slot: 65,536 int8, for each bf16 value v
// what fc2 read for it, quant_static(act(v)) (ops/quant_kernel._hidden_table).
// The activation's steps, each rounded to bf16 with the precise expf and
// tanhf, run once a call over the table in torch's own kernels; computed here
// in registers they cost 2.3 ms (quick_gelu) and 3.9 ms (gelu_tanh) a
// 147,712- or 186,624-row fc1 more than the gather, on an H100 80GB HBM3.
__device__ __forceinline__ float hidden_q8(float y, const void* table) {
  const unsigned short bits = __bfloat16_as_ushort(__float2bfloat16_rn(y));
  return (float)__ldg(static_cast<const signed char*>(table) + bits);
}

template <typename TO> constexpr bool kQ8 = std::is_same<TO, int8_t>::value;

// The residual [M, N] of K8's epilogue, float32 (res_dtype 0) or bfloat16 (1).
__device__ __forceinline__ float residual_at(const void* res, int res_dtype, size_t i) {
  return res_dtype == 0 ? static_cast<const float*>(res)[i]
                        : __bfloat162float(static_cast<const __nv_bfloat16*>(res)[i]);
}

// The epilogue of one consumer's 64 x BN sums: acc[j][0..1] are row r0,
// columns c0 + 8j and c0 + 8j + 1 (r0 = the tile's row + 16·warp + lane / 4,
// c0 = its column + 2·(lane % 4)); acc[j][2..3] row r0 + 8. With TO int8_t,
// res is hidden_q8's table (ACT 0, RES false).
template <typename TO, int ACT, bool RES, int BN>
__device__ __forceinline__ void epilogue(const int (&acc)[BN / 8][4], int r0, int c0,
                                         const float* __restrict__ xs, int xs_stride,
                                         const float* __restrict__ ws,
                                         const float* __restrict__ bias, TO* __restrict__ out,
                                         int M, int N, const void* __restrict__ res,
                                         int res_dtype) {
  const bool pairs = (N % 2) == 0;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = r0 + 8 * h;
    if (row >= M) continue;
    const float sx = xs[row * xs_stride];
#pragma unroll
    for (int j = 0; j < BN / 8; ++j) {
      const int col = c0 + 8 * j;
      if (col >= N) continue;
      float y[2];
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int c = min(col + e, N - 1);
        float v = __fmul_rn(__fmul_rn((float)acc[j][2 * h + e], sx), __ldg(ws + c));
        if (bias != nullptr) v = __fadd_rn(v, __ldg(bias + c));
        if constexpr (kQ8<TO>) {
          v = hidden_q8(v, res);
        } else {
          v = act_f32<ACT>(v);
          if (RES) v = __fadd_rn(v, residual_at(res, res_dtype, (size_t)row * N + c));
        }
        y[e] = v;
      }
      TO* o = out + (size_t)row * N + col;
      if (pairs && col + 1 < N) {
        store2<TO>(o, y[0], y[1]);
      } else {
        o[0] = cast_out<TO>(y[0]);
        if (col + 1 < N) o[1] = cast_out<TO>(y[1]);
      }
    }
  }
}

// The four lanes of a quad (lane = 4g + t) swap their sums so that each
// holds 8 contiguous columns: before, lane t holds a[jj][e] = column 8·jj +
// 2t + e (jj, t < 4) of its row; after, a[u][e] = column 8t + 2u + e. In
// round r lane t reads, from lane (t + r) % 4, that lane's a[t].
__device__ __forceinline__ void quad_transpose(int (&a)[4][2], int lane) {
  const int t = lane & 3;
  int b[4][2];
#pragma unroll
  for (int u = 0; u < 4; ++u) b[u][0] = a[u][0], b[u][1] = a[u][1];
#pragma unroll
  for (int r = 1; r < 4; ++r) {
    const int src = (t + r) & 3, k = (t - r) & 3;
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int send = k == 0 ? a[0][e] : k == 1 ? a[1][e] : k == 2 ? a[2][e] : a[3][e];
      const int got = __shfl_sync(0xffffffffu, send, (lane & ~3) | src);
#pragma unroll
      for (int u = 0; u < 4; ++u)
        if (u == src) b[u][e] = got;
    }
  }
#pragma unroll
  for (int u = 0; u < 4; ++u) a[u][0] = b[u][0], a[u][1] = b[u][1];
}

// 8 contiguous float32 values by two 16-byte loads
__device__ __forceinline__ void load8(const float* __restrict__ p, float (&v)[8]) {
  const float4 a = __ldg(reinterpret_cast<const float4*>(p));
  const float4 b = __ldg(reinterpret_cast<const float4*>(p) + 1);
  v[0] = a.x, v[1] = a.y, v[2] = a.z, v[3] = a.w, v[4] = b.x, v[5] = b.y, v[6] = b.z, v[7] = b.w;
}

// the residual's 8 contiguous values at element i, float32 or bfloat16
__device__ __forceinline__ void residual8(const void* res, int res_dtype, size_t i,
                                          float (&v)[8]) {
  if (res_dtype == 0) {
    load8(static_cast<const float*>(res) + i, v);
  } else {
    const uint4 u = *reinterpret_cast<const uint4*>(static_cast<const __nv_bfloat16*>(res) + i);
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const float2 f = __bfloat1622float2(h[j]);
      v[2 * j] = f.x, v[2 * j + 1] = f.y;
    }
  }
}

template <typename TO> __device__ __forceinline__ void store8(TO* p, const float (&y)[8]);
template <> __device__ __forceinline__ void store8<float>(float* p, const float (&y)[8]) {
  reinterpret_cast<float4*>(p)[0] = make_float4(y[0], y[1], y[2], y[3]);
  reinterpret_cast<float4*>(p)[1] = make_float4(y[4], y[5], y[6], y[7]);
}
template <> __device__ __forceinline__ void store8<__nv_bfloat16>(__nv_bfloat16* p,
                                                                 const float (&y)[8]) {
  uint4 u;
  uint32_t* w = reinterpret_cast<uint32_t*>(&u);
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    __nv_bfloat162 h = __floats2bfloat162_rn(y[2 * j], y[2 * j + 1]);
    w[j] = *reinterpret_cast<uint32_t*>(&h);
  }
  *reinterpret_cast<uint4*>(p) = u;
}

template <> __device__ __forceinline__ void store8<int8_t>(int8_t* p, const float (&y)[8]) {
  uint32_t w[2];
#pragma unroll
  for (int j = 0; j < 2; ++j) {
    w[j] = 0;
#pragma unroll
    for (int i = 0; i < 4; ++i) w[j] |= (uint32_t)(uint8_t)(int8_t)y[4 * j + i] << (8 * i);
  }
  *reinterpret_cast<uint2*>(p) = make_uint2(w[0], w[1]);
}

// The epilogue with 16-byte accesses, where N % 8 == 0 and the vectors are
// 16-byte aligned: for each group of four j, the quad's transpose gives lane
// t columns n0 + 32q + 8t .. + 7 of rows r0 and r0 + 8; it reads their 8
// column scales and biases once for both rows and writes 8 outputs a store
// (8 bytes with TO int8_t). The arithmetic of each element is epilogue()'s.
template <typename TO, int ACT, bool RES, int BN>
__device__ __forceinline__ void epilogue_vec(const int (&acc)[BN / 8][4], int r0, int n0,
                                             int lane,
                                             const float* __restrict__ xs, int xs_stride,
                                             const float* __restrict__ ws,
                                             const float* __restrict__ bias,
                                             TO* __restrict__ out, int M, int N,
                                             const void* __restrict__ res, int res_dtype) {
  const float sx[2] = {r0 < M ? xs[r0 * xs_stride] : 0.f,
                       r0 + 8 < M ? xs[(r0 + 8) * xs_stride] : 0.f};
#pragma unroll
  for (int q = 0; q < BN / 32; ++q) {
    int a[2][4][2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) a[h][jj][0] = acc[4 * q + jj][2 * h],
                                     a[h][jj][1] = acc[4 * q + jj][2 * h + 1];
      quad_transpose(a[h], lane);  // every lane, masked or not
    }
    const int col = n0 + 32 * q + 8 * (lane & 3);
    if (col >= N) continue;  // N % 8 == 0: all 8 columns in, or none
    float w[8], b[8];
    load8(ws + col, w);
    if (bias != nullptr) load8(bias + col, b);
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = r0 + 8 * h;
      if (row >= M) continue;
      float y[8], r[8];
      if (RES) residual8(res, res_dtype, (size_t)row * N + col, r);
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        float v = __fmul_rn(__fmul_rn((float)a[h][i / 2][i % 2], sx[h]), w[i]);
        if (bias != nullptr) v = __fadd_rn(v, b[i]);
        if constexpr (kQ8<TO>) {
          v = hidden_q8(v, res);
        } else {
          v = act_f32<ACT>(v);
          if (RES) v = __fadd_rn(v, r[i]);
        }
        y[i] = v;
      }
      store8<TO>(out + (size_t)row * N + col, y);
    }
  }
}

// ACT (0 none, 1 quick_gelu, 2 gelu_tanh, 3 gelu) and RES (a residual is
// added) are template parameters: K9 is the <TO, 0, false, BN>
// instantiation, with no code for either; the int8 hidden is <int8_t, 0,
// false, BN>, its table in res's slot (no parameter more: one had moved
// other instantiations' spills). (A run-time switch on the
// activation in the unrolled epilogue of the first, mma.sync design measured
// 0.638 ms against 0.398 for K9 at M = 18464, 1024→3072, on an H100 80GB
// HBM3 at 700 W.)
template <typename TO, int ACT, bool RES, int BN>
__global__ void __launch_bounds__(NTH, 1) q_gemm_wgmma_kernel(
    const __grid_constant__ CUtensorMap tmx, const __grid_constant__ CUtensorMap tmw,
    const float* __restrict__ xs, int xs_stride, const float* __restrict__ ws,
    const float* __restrict__ bias, TO* __restrict__ out, int M, int N, int K,
    const void* __restrict__ res, int res_dtype, bool vec) {
  constexpr int ST = ring_stages(BN), STAGE = stage_bytes(BN);
  extern __shared__ uint8_t smem_raw[];
  __shared__ __align__(8) uint64_t full[ST], empty[ST];
  uint8_t* ring = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  const int n_tiles = (N + BN - 1) / BN;
  const int tiles = (M + BM - 1) / BM * n_tiles, nk = (K + BK - 1) / BK;

  if (threadIdx.x == 0) {
#pragma unroll
    for (int s = 0; s < ST; ++s) {
      mbar_init(&full[s], 1);   // the producer's arrival with the bytes
      mbar_init(&empty[s], 8);  // one arrival of each consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x < 128) {  // the producer warpgroup
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n");
    if (threadIdx.x == 0) {
      int s = 0;
      uint32_t phase = 0;
      for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
        const int m0 = tile / n_tiles * BM, n0 = tile % n_tiles * BN;
        for (int kt = 0; kt < nk; ++kt) {
          mbar_wait(&empty[s], phase ^ 1);  // a fresh barrier passes at once
          uint8_t* st = ring + s * STAGE;
          mbar_expect_tx(&full[s], STAGE);  // the whole boxes, zero fill included
          tma_load_2d(st, &tmx, &full[s], kt * BK, m0);
          tma_load_2d(st + A_BYTES, &tmw, &full[s], kt * BK, n0);
          if (++s == ST) {
            s = 0;
            phase ^= 1;
          }
        }
      }
    }
    return;
  }

  asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n");
  const int cw = threadIdx.x / 128 - 1;  // the consumer's 64 rows of the tile
  const int warp4 = threadIdx.x / 32 % 4, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;  // accumulator fragment coordinates
  int s = 0;
  uint32_t phase = 0;
  int acc[BN / 8][4];
  for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
    const int m0 = tile / n_tiles * BM, n0 = tile % n_tiles * BN;
    int prev = 0;
    for (int kt = 0; kt < nk; ++kt) {
      mbar_wait(&full[s], phase);
      const uint8_t* st = ring + s * STAGE;
      const uint64_t da = desc_sw128(st + cw * 64 * BK), db = desc_sw128(st + A_BYTES);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < BK / 32; ++kk)
        wgmma_s8<BN>(acc, da + 2 * kk, db + 2 * kk, (kt | kk) != 0);
      wgmma_commit();
      wgmma_wait<1>();  // the previous slice's products are done: free its stage
      if (kt > 0 && lane == 0) mbar_arrive(&empty[prev]);
      prev = s;
      if (++s == ST) {
        s = 0;
        phase ^= 1;
      }
    }
    wgmma_wait<0>();
    if (lane == 0) mbar_arrive(&empty[prev]);
    wgmma_settle(acc);

    if (vec)
      epilogue_vec<TO, ACT, RES, BN>(acc, m0 + cw * 64 + warp4 * 16 + g, n0, lane, xs,
                                     xs_stride, ws, bias, out, M, N, res, res_dtype);
    else
      epilogue<TO, ACT, RES, BN>(acc, m0 + cw * 64 + warp4 * 16 + g, n0 + 2 * t, xs, xs_stride,
                                 ws, bias, out, M, N, res, res_dtype);
  }
}

// ---- host side -----------------------------------------------------------------

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled from the driver, through the runtime (the library
// does not link libcuda)
EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000,
                                                             cudaEnableDefault, &found);
#else
    const cudaError_t err =
        cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    if (err == cudaSuccess && found == cudaDriverEntryPointSuccess) fn = (EncodeTiled)p;
  }
  return fn;
}

// the tensor map of an int8 [rows, K] row-major operand, read in boxes of
// box_rows x BK bytes in the 128-byte swizzle, zero past its ends
int encode_operand(CUtensorMap* map, const void* p, int rows, int K, int box_rows) {
  EncodeTiled fn = encode_tiled();
  if (fn == nullptr) return (int)cudaErrorInitializationError;
  const cuuint64_t dims[2] = {(cuuint64_t)K, (cuuint64_t)rows};
  const cuuint64_t strides[1] = {(cuuint64_t)K};  // bytes between rows
  const cuuint32_t box[2] = {(cuuint32_t)BK, (cuuint32_t)box_rows};
  const cuuint32_t elem[2] = {1, 1};
  const CUresult r = fn(map, CU_TENSOR_MAP_DATA_TYPE_UINT8, 2, const_cast<void*>(p), dims,
                        strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
                        CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                        CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : (int)cudaErrorInvalidValue;
}

int sm_count() {
  static int n = 0;
  if (n == 0) {
    int dev = 0;
    if (cudaGetDevice(&dev) != cudaSuccess ||
        cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess)
      n = 0;
  }
  return n;
}

// BN = 128 where it leaves at least 10% less work on the busiest SM
// (rounds of tiles x BN) than 256, as at N = 1024; a 128 x 256 tile reads
// fewer operand bytes an output, so near a tie 256 runs faster
int pick_bn(int M, int N, int sms) {
  const long mt = (M + BM - 1) / BM;
  auto cost = [&](long bn) { return (mt * ((N + bn - 1) / bn) + sms - 1) / sms * bn; };
  return 10 * cost(128) <= 9 * cost(256) ? 128 : 256;
}

template <typename TO, int ACT, bool RES, int BN>
int launch(const void* xq, const void* wq, const void* xs, int xs_stride, const void* ws,
           const void* bias, void* out, int M, int N, int K, const void* res, int res_dtype,
           int sms, cudaStream_t stream) {
  CUtensorMap tmx, tmw;
  int err = encode_operand(&tmx, xq, M, K, BM);
  if (err == 0) err = encode_operand(&tmw, wq, N, K, BN);
  if (err != 0) return err;
  constexpr int smem = ring_smem(BN);
  auto kernel = q_gemm_wgmma_kernel<TO, ACT, RES, BN>;
  const cudaError_t e =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return (int)e;
  const long tiles = (long)((M + BM - 1) / BM) * ((N + BN - 1) / BN);
  const int grid = (int)(tiles < sms ? tiles : sms);
  // 16-byte epilogue accesses: 8 columns a lane, each vector aligned
  auto al16 = [](const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; };
  const bool vec = N % 8 == 0 && al16(ws) && al16(out) && (bias == nullptr || al16(bias)) &&
                   (!RES || al16(res));
  kernel<<<grid, NTH, smem, stream>>>(tmx, tmw, static_cast<const float*>(xs), xs_stride,
                                      static_cast<const float*>(ws),
                                      static_cast<const float*>(bias), static_cast<TO*>(out), M,
                                      N, K, res, res_dtype, vec);
  return (int)cudaGetLastError();
}

template <typename TO, int ACT, bool RES>
int launch_bn(const void* xq, const void* wq, const void* xs, int xs_stride, const void* ws,
              const void* bias, void* out, int M, int N, int K, const void* res, int res_dtype,
              cudaStream_t st) {
  const int sms = sm_count();
  if (sms < 1) return (int)cudaErrorInvalidDevice;
  if (pick_bn(M, N, sms) == 128)
    return launch<TO, ACT, RES, 128>(xq, wq, xs, xs_stride, ws, bias, out, M, N, K, res,
                                     res_dtype, sms, st);
  return launch<TO, ACT, RES, 256>(xq, wq, xs, xs_stride, ws, bias, out, M, N, K, res, res_dtype,
                                   sms, st);
}

template <typename TO, bool RES>
int launch_act(int act, const void* xq, const void* wq, const void* xs, int xs_stride,
               const void* ws, const void* bias, void* out, int M, int N, int K, const void* res,
               int res_dtype, cudaStream_t st) {
  switch (act) {
    case 0:
      return launch_bn<TO, 0, RES>(xq, wq, xs, xs_stride, ws, bias, out, M, N, K, res, res_dtype,
                                   st);
    case 1:
      return launch_bn<TO, 1, RES>(xq, wq, xs, xs_stride, ws, bias, out, M, N, K, res, res_dtype,
                                   st);
    case 2:
      return launch_bn<TO, 2, RES>(xq, wq, xs, xs_stride, ws, bias, out, M, N, K, res, res_dtype,
                                   st);
    case 3:
      return launch_bn<TO, 3, RES>(xq, wq, xs, xs_stride, ws, bias, out, M, N, K, res, res_dtype,
                                   st);
    default: return (int)cudaErrorInvalidValue;
  }
}

template <typename TO>
int launch_res(int act, const void* xq, const void* wq, const void* xs, int xs_stride,
               const void* ws, const void* bias, void* out, int M, int N, int K, const void* res,
               int res_dtype, cudaStream_t st) {
  if (res != nullptr)
    return launch_act<TO, true>(act, xq, wq, xs, xs_stride, ws, bias, out, M, N, K, res,
                                res_dtype, st);
  return launch_act<TO, false>(act, xq, wq, xs, xs_stride, ws, bias, out, M, N, K, nullptr, 0,
                               st);
}

// TMA reads rows of K bytes: K % 16 == 0 and 16-byte aligned operands; a
// row's scale at xs[row * xs_stride], one a row (1) or one for all (0)
bool gemm_refuses(const void* xq, const void* wq, int xs_stride, int M, int N, int K) {
  return M < 1 || N < 1 || K < 1 || K % 16 != 0 || xs_stride < 0 || xs_stride > 1 ||
         reinterpret_cast<uintptr_t>(xq) % 16 != 0 || reinterpret_cast<uintptr_t>(wq) % 16 != 0;
}

int launch_out(int out_dtype, int act, const void* xq, const void* wq, const void* xs,
               int xs_stride, const void* ws, const void* bias, void* out, int M, int N, int K,
               const void* res, int res_dtype, void* stream) {
  if (gemm_refuses(xq, wq, xs_stride, M, N, K) || res_dtype < 0 || res_dtype > 1)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (out_dtype == 0)
    return launch_res<float>(act, xq, wq, xs, xs_stride, ws, bias, out, M, N, K, res, res_dtype,
                             st);
  if (out_dtype == 1)
    return launch_res<__nv_bfloat16>(act, xq, wq, xs, xs_stride, ws, bias, out, M, N, K, res,
                                     res_dtype, st);
  return (int)cudaErrorInvalidValue;
}

// int8 out: the table in the residual's slot
int launch_hidden_q8(const void* xq, const void* wq, const void* xs, int xs_stride,
                     const void* ws, const void* bias, const void* table, void* out, int M,
                     int N, int K, void* stream) {
  if (gemm_refuses(xq, wq, xs_stride, M, N, K) || table == nullptr)
    return (int)cudaErrorInvalidValue;
  return launch_bn<int8_t, 0, false>(xq, wq, xs, xs_stride, ws, bias, out, M, N, K, table, 0,
                                     static_cast<cudaStream_t>(stream));
}

}  // namespace

extern "C" {

// The GEMM of K9 (act 0, res null), of K8, and of q_matmul_pre on the card
// (act 0). xq: int8 [M, K]; wq: int8 [N, K]; xs: float32 row scales, row m's
// at xs[m * xs_stride] (1: an [M] vector; 0: one per-tensor scale, read on
// the card); ws: float32 [N]; bias: float32 [N] or null; act (0 none,
// 1 quick_gelu, 2 gelu_tanh, 3 gelu) on the float32 y, then + res [M, N]
// (null, or of res_dtype 0 = float32, 1 = bfloat16), then the cast to
// out: [M, N] of out_dtype (0 = float32, 1 = bfloat16). K % 16 == 0 and
// 16-byte aligned xq, wq. Returns cudaGetLastError() of the launch (or the
// error of building a tensor map).
int q_block_linear_gemm(const void* xq, const void* wq, const void* xs, int xs_stride,
                        const void* ws, const void* bias, const void* res, int res_dtype,
                        void* out, int out_dtype, int act, int M, int N, int K, void* stream) {
  return launch_out(out_dtype, act, xq, wq, xs, xs_stride, ws, bias, out, M, N, K, res,
                    res_dtype, stream);
}

// int8_static's fc1 with its int8 hidden (ops/quant_kernel.q_matmul_pre_act_q8):
// q_block_linear_gemm's GEMM and epilogue (act 0, no residual) to the bf16
// value, whose 16 bits index table (int8 [65536] on the card) for the int8
// written to out [M, N]. The other operands as q_block_linear_gemm's.
int q_gemm_hidden_q8(const void* xq, const void* wq, const void* xs, int xs_stride, const void* ws,
                     const void* bias, const void* table, void* out, int M, int N, int K,
                     void* stream) {
  return launch_hidden_q8(xq, wq, xs, xs_stride, ws, bias, table, out, M, N, K, stream);
}

}  // extern "C"
