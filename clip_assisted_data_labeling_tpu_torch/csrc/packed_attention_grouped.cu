// Head-grouped packed multi-head attention (K4) for Hopper (sm_90a), plain C
// interface.
//
// Replaces the TPU kernel _packed_grouped_kernel /
// fused_attention_packed_grouped (clip_assisted_data_labeling_tpu/ops/
// attention.py, pallas_call at :342), which the JAX package runs wherever the
// whole [S, 3w] block of one batch item overflows its VMEM budget but a
// 128-lane group of heads fits: PE-Core-G14-448 (S=1024, w=1536, d=96) in
// bf16, and the float32 runs of the 336/384-pixel towers (ViT-L-14-336,
// PE-Core-L14-336, ...). It computes the same arithmetic as K1, for qkv
// packed [B, S, 3w] read in place (the TPU wrapper's [B, 3, S, w] transpose
// is a TPU tiling device and has no counterpart here):
//   q' = rot(T(q * T(scale)))   q scaled in the input type T, then rotated
//   k' = rot(k)                 (rotation only with RoPE tables: the
//                               half-split pairs (i, i + d/2), each product
//                               and then the sum rounded to T, as
//                               attention_common.cuh rot_pair)
//   s  = q' k'^T                float32 accumulation; keys >= s_real get -inf
//   p  = exp(s - max_row(s))    float32, the exact two-pass softmax; the sum
//                               over the unrounded p
//   o  = T((T(p) v) * (1/sum))  P rounded to v's type, float32 accumulation
//
// What bounds it on the H100: at PE-G14-448's shape ([16, 1024, 4608] bf16,
// 16 heads, d=96) the work is 4·B·H·S²·d = 103 GFLOP (0.104 ms at
// 989 TFLOP/s) against B·S·4w·2 = 201 MB (0.060 ms at 3.35 TB/s): the
// tensor-core rate. In float32 the products are 3xTF32 splits (three TF32
// mmas each, attention_common.cuh), bound by the TF32 rate over three (~165
// TFLOP/s). What Hopper has to add to the TPU kernel is any sequence length
// at any head dim up to 128 in both types: a whole score row does not fit
// shared memory beside its operands for long sequences.
//
// The design answers that by streaming the keys through shared memory in
// 64-key chunks (32 in float32) in both passes of the exact softmax, so
// nothing grows with S: pass 1 takes each row's max over all chunks; pass 2
// recomputes the same scores chunk by chunk (the same operations on the same
// data, so the same values), exponentiates against the final max, sums the
// float32 p, and accumulates T(p)·V; the epilogue multiplies by 1/sum.
//
// bfloat16: grouped_wgmma_kernel, on Hopper's warpgroup products (wgmma).
// One block of two warpgroups per (128 query rows, head, batch item), each
// warpgroup owning 64 rows:
//   - K and V chunks come in by 16-byte cp.async into a ring of three stages
//     in shared memory, in 8 x 8 core matrices (attention_common.cuh
//     cp_async_core_bf16: eight threads fill 128 contiguous bytes, so no
//     store conflicts on banks and no padding). Two chunks' copies are in
//     flight while the warpgroups multiply, with one barrier a chunk.
//   - Q·K^T is wgmma m64n64k16 with both operands read from shared memory
//     through descriptors (q tile and K chunk K-major, no swizzle).
//   - P·V is wgmma m64nDk16 (D = the head dim padded to 16) with P, rounded
//     to bf16, in the registers of the A operand (the accumulator layout of
//     Q·K^T is that operand's fragment layout), and V row-major in shared
//     memory: the MN-major B operand through wgmma's transpose bit, so V is
//     never transposed. The float32 accumulator of P·V stays in registers
//     across all chunks.
//   - Each product is waited for before its result is read (no ping-pong
//     between the warpgroups, no producer warp): the simple schedule first.
//   - With RoPE, a pre-pass (rope_prepass_kernel, in the same launch of the
//     C entry) writes q·T(scale) rotated and k rotated once into a [B, S, 2w]
//     scratch that the wrapper allocates, with K1's staging code (scale8,
//     rot8), so the values are those K1 rotates; the kernel then reads q
//     and k from there. Rotated as it is staged, each key would be rotated
//     2·S/128 times (16 at S=1024) between two barriers. The pre-pass moves
//     ~100 MB each way at [16, 1024, 4608] (its cost: PERF.md §6).
// Why wgmma and not mma.sync: an mma.sync version with ldmatrix (.trans for
// V) and the same ring ran about as fast on the H100 (PERF.md §6), but only
// wgmma reaches the full tensor-core rate, so the schedule that pipelines
// the warpgroups builds on this one.
//
// float32: exact_3xtf32_kernel<DP, 8, false> of attention_common.cuh, K1's
// float32 kernel with 128 query rows a block: both products as 3xTF32 m16n8k8 mmas
// (a float32 operand split into a rounded TF32 high part and a TF32
// remainder, three mmas per product pair, ~21 of the 24 bits kept), P kept
// in float32. Each K and V chunk comes in by 16-byte cp.async (the next
// one's copy in flight while the warps multiply) and is split once for the
// block, k rotated first. Shared memory stays at 52 KB (d=64) to 101 KB
// (d=128), 8 to 16 KB more with RoPE tables, for any S.

#include "attention_common.cuh"

namespace {

constexpr int DMAX = 128;  // largest head dim

// ---- bfloat16: wgmma kernel, 128 query rows a block -------------------------

constexpr int GQ = 128;   // query rows per block (2 warpgroups x 64)
constexpr int GK = 64;    // keys per streamed chunk
constexpr int GNT = 256;  // threads per block
constexpr int NST = 3;    // stages of the K/V ring

template <int DP>  // head dim padded to a multiple of 16
constexpr size_t wgmma_smem_bytes() {
  return sizeof(__nv_bfloat16) * (NST * 2 * GK + GQ) * DP;
}

// blocks an SM should hold, which caps the registers a thread: two (128
// registers) up to d = 96, where two blocks' shared memory fits an SM
constexpr int wgmma_min_blocks(int DP) { return DP <= 96 ? 2 : 1; }

// The RoPE pre-pass: q·T(scale) rotated and k rotated, each 16-byte vector
// of a head row's first half with its partner in the second half, by the
// code K1 runs as it stages them (scale8, rot8: the same roundings, so the
// same values), into qk [B, S, 2w] (q' in columns [0, w), k' in [w, 2w)).
// One thread per (token, q or k, head, pair of vectors).
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

// One block of two warpgroups per (128 query rows, head, batch item), each
// warpgroup owning 64 rows. q and k are read from rows of stride qk_rs (the
// packed qkv, or the pre-pass's [B, S, 2w] with q already scaled and both
// rotated: `prescaled`), v from the packed qkv; head h's q, k and v start at
// columns h*d, w + h*d and 2w + h*d.
template <int DP>
__global__ void __launch_bounds__(GNT, wgmma_min_blocks(DP)) grouped_wgmma_kernel(
    const __nv_bfloat16* __restrict__ qk, size_t qk_rs, const __nv_bfloat16* __restrict__ qkv,
    __nv_bfloat16* __restrict__ out, int S, int s_real, int w, int d, float scale,
    bool prescaled) {
  constexpr int NV = DP / 8;          // core matrices along a row
  constexpr int STAGE = 2 * GK * DP;  // one stage: K rows, then V rows (bf16)
  constexpr uint32_t CORE = 128;      // bytes of a core matrix
  extern __shared__ __align__(128) unsigned char mma_smem[];
  __nv_bfloat16* ring = reinterpret_cast<__nv_bfloat16*>(mma_smem);  // [NST][2][GK][DP]
  __nv_bfloat16* qs = ring + NST * STAGE;                              // [GQ][DP]

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, t = lane % 4;  // accumulator coordinates
  const int q0 = blockIdx.x * GQ, h = blockIdx.y;
  const __nv_bfloat16* qkb = qk + (size_t)blockIdx.z * S * qk_rs;
  const __nv_bfloat16* vb = qkv + (size_t)blockIdx.z * S * 3 * w;
  const int nc = (S + GK - 1) / GK;

  // step i of 2·nc: K chunk i in pass 1, K and V chunk i - nc in pass 2,
  // into stage i % NST; every step commits one group (empty past the end),
  // so a thread's groups count steps
  auto issue = [&](int i) {
    if (i < 2 * nc) {
      const int k0 = (i < nc ? i : i - nc) * GK;
      __nv_bfloat16* st = ring + (i % NST) * STAGE;
      cp_async_core_bf16<GNT, GK, DP>(st, qkb, k0, S, qk_rs, w + h * d, d);
      if (i >= nc)
        cp_async_core_bf16<GNT, GK, DP>(st + GK * DP, vb, k0, S, 3 * (size_t)w, 2 * w + h * d, d);
    }
    cp_async_commit();
  };
  // the q tile first (the oldest group), then the first NST - 1 steps; q is
  // scaled in bf16 where it lies (the scale rounded to bf16 first) unless
  // the pre-pass did it
  cp_async_core_bf16<GNT, GQ, DP>(qs, qkb, q0, S, qk_rs, h * d, d);
  cp_async_commit();
#pragma unroll
  for (int i = 0; i < NST - 1; ++i) issue(i);
  if (!prescaled) {
    cp_async_wait<NST - 1>();
    __syncthreads();
    const __nv_bfloat162 scale2 = __float2bfloat162_rn(scale);
    for (int i = tid; i < GQ * DP / 8; i += GNT) {
      uint4 v = reinterpret_cast<uint4*>(qs)[i];
      scale8(v, scale2);
      reinterpret_cast<uint4*>(qs)[i] = v;
    }
  }
  // this warpgroup's 64 rows of q: A K-major (core matrices along the head
  // dim 128 bytes apart, along the rows NV·128)
  const uint64_t qdesc = gmma_desc(qs + (warp / 4) * 8 * NV * 64, CORE, NV * CORE);
  // a warpgroup whose 64 rows all lie past the sequence still stages and
  // syncs, but skips the products (wgmma runs per warpgroup)
  const bool live = q0 + (warp / 4) * 64 < S;

  // this warpgroup's 64 x GK scores against the staged K chunk (B K-major,
  // laid out as q): each warp's s[j] holds keys 8j.. in the accumulator
  // layout; keys >= s_real get -inf
  auto scores = [&](float (&s)[GK / 8][4], const __nv_bfloat16* ks_, int k0) {
    const uint64_t kdesc = gmma_desc(ks_, CORE, NV * CORE);
    wgmma_fence();
#pragma unroll
    for (int ks = 0; ks < DP / 16; ++ks)  // k16 steps: two core matrices along the head dim
      wgmma_ss_n64(s, qdesc + ks * (2 * CORE >> 4), kdesc + ks * (2 * CORE >> 4), ks > 0);
    wgmma_commit();
    wgmma_wait0();
    wgmma_settle(s);
#pragma unroll
    for (int j = 0; j < GK / 8; ++j) {
      const int key = k0 + j * 8 + 2 * t;
      if (key >= s_real) s[j][0] = s[j][2] = -INFINITY;
      if (key + 1 >= s_real) s[j][1] = s[j][3] = -INFINITY;
    }
  };
  // wait for step i's chunk, then one barrier: every thread's copies have
  // landed (and are visible to wgmma) and every warpgroup is done with step
  // i - 1, whose stage step i + NST - 1 then refills while the warpgroups
  // multiply
  auto next = [&](int i) {
    cp_async_wait<NST - 2>();
    fence_proxy_async();
    __syncthreads();
    issue(i + NST - 1);
    return ring + (i % NST) * STAGE;
  };

  // --- pass 1: row max over all keys -----------------------------------
  float m0 = -INFINITY, m1 = -INFINITY;  // rows g and g+8 of this warp
  for (int i = 0; i < nc; ++i) {
    const __nv_bfloat16* st = next(i);
    if (!live) continue;
    float s[GK / 8][4];
    scores(s, st, i * GK);
#pragma unroll
    for (int j = 0; j < GK / 8; ++j) {
      m0 = fmaxf(m0, fmaxf(s[j][0], s[j][1]));
      m1 = fmaxf(m1, fmaxf(s[j][2], s[j][3]));
    }
  }
  m0 = fmaxf(m0, __shfl_xor_sync(0xffffffffu, m0, 1));
  m0 = fmaxf(m0, __shfl_xor_sync(0xffffffffu, m0, 2));
  m1 = fmaxf(m1, __shfl_xor_sync(0xffffffffu, m1, 1));
  m1 = fmaxf(m1, __shfl_xor_sync(0xffffffffu, m1, 2));

  // --- pass 2: recompute scores, P = bf16(exp(s - max)) in the registers
  // of wgmma's A operand, O += P V -----------------------------------------
  float l0 = 0.f, l1 = 0.f;
  float o[DP / 8][4];
#pragma unroll
  for (int n = 0; n < DP / 8; ++n) o[n][0] = o[n][1] = o[n][2] = o[n][3] = 0.f;
  for (int i = nc; i < 2 * nc; ++i) {
    const __nv_bfloat16* st = next(i);
    if (!live) continue;
    float s[GK / 8][4];
    scores(s, st, (i - nc) * GK);
    uint32_t pa[GK / 16][4];
#pragma unroll
    for (int j = 0; j < GK / 8; ++j) {
      const float p0 = expf(s[j][0] - m0), p1 = expf(s[j][1] - m0);
      const float p2 = expf(s[j][2] - m1), p3 = expf(s[j][3] - m1);
      l0 += p0;
      l0 += p1;
      l1 += p2;
      l1 += p3;
      pa[j / 2][(j % 2) * 2] = pack_bf16(p0, p1);
      pa[j / 2][(j % 2) * 2 + 1] = pack_bf16(p2, p3);
    }
    // V stays row-major: B MN-major, its core matrices along the head dim
    // (N) 128 bytes apart, along the keys (K) NV·128
    const uint64_t vdesc = gmma_desc(st + GK * DP, NV * CORE, CORE);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < GK / 16; ++kk)  // k16 steps: two core matrices of keys
      wgmma_rs<DP>(o, pa[kk], vdesc + kk * (2 * NV * CORE >> 4), 1);
    wgmma_commit();
    wgmma_wait0();
    wgmma_settle(o);
  }
  cp_async_wait<0>();  // no copy outlives the block
  if (!live) return;
  l0 += __shfl_xor_sync(0xffffffffu, l0, 1);
  l0 += __shfl_xor_sync(0xffffffffu, l0, 2);
  l1 += __shfl_xor_sync(0xffffffffu, l1, 1);
  l1 += __shfl_xor_sync(0xffffffffu, l1, 2);
  const float inv0 = 1.0f / l0, inv1 = 1.0f / l1;
  const int row0 = q0 + warp * 16 + g, row1 = row0 + 8;
#pragma unroll
  for (int n = 0; n < DP / 8; ++n) {
    const int col = n * 8 + 2 * t;
    if (col >= d) continue;
    if (row0 < S)
      *reinterpret_cast<__nv_bfloat162*>(out + ((size_t)blockIdx.z * S + row0) * w + h * d + col) =
          __floats2bfloat162_rn(o[n][0] * inv0, o[n][1] * inv0);
    if (row1 < S)
      *reinterpret_cast<__nv_bfloat162*>(out + ((size_t)blockIdx.z * S + row1) * w + h * d + col) =
          __floats2bfloat162_rn(o[n][2] * inv1, o[n][3] * inv1);
  }
}

template <int DP>
int launch_wgmma(const void* qkv, void* out, int B, int S, int s_real, int w, int heads,
                 float scale, const void* cos, const void* sin, void* scratch,
                 cudaStream_t stream) {
  const int d = w / heads;
  const __nv_bfloat16* x = static_cast<const __nv_bfloat16*>(qkv);
  const __nv_bfloat16* qk = x;
  size_t qk_rs = 3 * (size_t)w;
  if (cos != nullptr) {  // rotate (and scale q) once, into the scratch
    const size_t n = (size_t)B * S * (w / 8);
    rope_prepass_kernel<<<(unsigned)((n + 255) / 256), 256, 0, stream>>>(
        x, static_cast<__nv_bfloat16*>(scratch), S, w, d, scale,
        static_cast<const __nv_bfloat16*>(cos), static_cast<const __nv_bfloat16*>(sin), n);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    qk = static_cast<const __nv_bfloat16*>(scratch);
    qk_rs = 2 * (size_t)w;
  }
  const size_t smem = wgmma_smem_bytes<DP>();
  cudaError_t err = cudaFuncSetAttribute(grouped_wgmma_kernel<DP>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((S + GQ - 1) / GQ, heads, B);
  grouped_wgmma_kernel<DP><<<grid, GNT, smem, stream>>>(
      qk, qk_rs, x, static_cast<__nv_bfloat16*>(out), S, s_real, w, d, scale, cos != nullptr);
  return (int)cudaGetLastError();
}

int launch_bf16(const void* qkv, void* out, int B, int S, int s_real, int w, int heads,
                float scale, const void* cos, const void* sin, void* scratch,
                cudaStream_t stream) {
  const int d = w / heads;
  if (d % 8 != 0) return (int)cudaErrorInvalidValue;  // 16-byte row loads
  if (cos != nullptr && (d % 16 != 0 || scratch == nullptr))  // paired half vectors
    return (int)cudaErrorInvalidValue;
  if (d <= 64)
    return launch_wgmma<64>(qkv, out, B, S, s_real, w, heads, scale, cos, sin, scratch, stream);
  if (d <= 80)
    return launch_wgmma<80>(qkv, out, B, S, s_real, w, heads, scale, cos, sin, scratch, stream);
  if (d <= 96)
    return launch_wgmma<96>(qkv, out, B, S, s_real, w, heads, scale, cos, sin, scratch, stream);
  if (d <= 112)
    return launch_wgmma<112>(qkv, out, B, S, s_real, w, heads, scale, cos, sin, scratch, stream);
  return launch_wgmma<128>(qkv, out, B, S, s_real, w, heads, scale, cos, sin, scratch, stream);
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16. cos, sin: RoPE tables [S, d/2] of the
// same dtype (half-split pairs), or both null for no rotation. scratch: with
// bf16 RoPE tables, [B, S, 2w] bf16 for the rotated q and k (else unread).
// Returns cudaGetLastError() of the launch.
int packed_attention_grouped(const void* qkv, void* out, int dtype, int B, int S, int s_real,
                             int w, int heads, float scale, const void* cos, const void* sin,
                             void* scratch, void* stream) {
  if (heads <= 0 || w % heads != 0 || w / heads > DMAX || s_real < 1 || s_real > S ||
      (cos == nullptr) != (sin == nullptr) || (cos != nullptr && (w / heads) % 2 != 0))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch_f32_3xtf32<8>(packed_heads<float>(qkv, out, S, w, w / heads), B, S, s_real,
                                heads, w / heads, scale, cos, sin, st);
  if (dtype == 1)
    return launch_bf16(qkv, out, B, S, s_real, w, heads, scale, cos, sin, scratch, st);
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
