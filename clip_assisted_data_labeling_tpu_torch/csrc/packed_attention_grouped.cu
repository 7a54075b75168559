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
// What bounds it on the H100: at PE-G14-448's shape ([32, 1024, 4608] bf16,
// 16 heads, d=96) the work is 4·B·H·S²·d = 206 GFLOP (0.21 ms at
// 989 TFLOP/s) against B·S·4w·2 = 403 MB (0.12 ms at 3.35 TB/s): the
// tensor-core rate. float32 has no tensor-core path that keeps float32
// products (TF32 would round them), so there the CUDA-core FMA rate bounds it.
// What Hopper has to add to the TPU kernel is any sequence length at any
// head dim up to 128 in both types: a whole score row does not fit shared
// memory beside its operands for long sequences (K1's float32 path keeps a
// [16, S] score tile and refuses S beyond ~3.4k keys).
//
// The design answers that by streaming the keys through shared memory in
// 64-key chunks in both passes of the exact softmax, so nothing grows with S:
// pass 1 takes each row's max over all chunks; pass 2 recomputes the same
// scores chunk by chunk (the same operations on the same data, so the same
// values), exponentiates against the final max, sums the float32 p, and
// accumulates T(p)·V; the epilogue multiplies by 1/sum. k is rotated as each
// chunk is staged (twice per key in all): the TPU kernel rotates it once per
// head in VMEM, but a rotated bf16 K of 1024 x 96 beside V would not leave
// room in one block's shared memory for the many blocks an SM needs.
//
// bfloat16: grouped_mma_kernel. One block of eight warps per (128 query
// rows, head, batch item); each warp owns 16 rows and keeps its q fragments,
// scores and output accumulators in registers, with mma.sync m16n8k16 (bf16
// in, f32 accumulate) for both products. Every K and V chunk staged in
// shared memory serves 128 query rows (K1 stages it for 64). d = 96 runs
// 6 k-steps of 16 for Q·K^T and 12 n8 tiles for P·V.
//
// float32: grouped_fma_kernel. One block of 256 threads per (32 query rows,
// head, batch item): each thread scores 8 rows against one key of the chunk
// with float32 FMAs over K^T in shared memory, writes its P into a [32, 64]
// chunk tile, and then accumulates its share of the [32, d] output over the
// chunk's V. Shared memory stays at ~46 KB (d=64) to ~92 KB (d=128) for any S.

#include "attention_common.cuh"

namespace {

constexpr int DMAX = 128;  // largest head dim

// ---- float32: CUDA-core FMA kernel, keys streamed in both passes -----------

constexpr int FQ = 32;              // query rows per block
constexpr int FK = 64;              // keys per streamed chunk
constexpr int FNT = 256;            // threads per block
constexpr int FR = FQ / (FNT / FK);  // score rows per thread (8)
constexpr int FE = FQ * DMAX / FNT;  // output elements per thread (max 16)

size_t fma_smem_bytes(int d) {
  return sizeof(float) * ((size_t)FQ * d + (size_t)d * (FK + 1) + (size_t)FK * d +
                          (size_t)FQ * (FK + 1) + 3 * FQ);
}

__global__ void __launch_bounds__(FNT) grouped_fma_kernel(
    const float* __restrict__ qkv, float* __restrict__ out, int S, int s_real, int w, int d,
    float scale, const float* __restrict__ cos, const float* __restrict__ sin) {
  extern __shared__ float smem[];
  float* q_s = smem;                 // [FQ][d] scaled, rotated q
  float* kt = q_s + FQ * d;          // [d][FK+1] rotated K^T chunk
  float* v_s = kt + d * (FK + 1);    // [FK][d] V chunk
  float* p_s = v_s + FK * d;         // [FQ][FK+1] P of the chunk
  float* red = p_s + FQ * (FK + 1);  // [2][FQ] per-warp row max, then row sum
  float* row_s = red + 2 * FQ;       // [FQ] row max, then 1/sum

  const int tid = threadIdx.x, lane = tid % 32;
  const int q0 = blockIdx.x * FQ, h = blockIdx.y;
  const size_t rs = 3 * (size_t)w;
  const float* base = qkv + (size_t)blockIdx.z * S * rs;
  const int kk = tid % FK;        // this thread's key within the chunk
  const int rg = tid / FK;        // this thread's group of FR rows
  const int wh = kk / 32;         // which of the group's two warps
  const int n_out = FQ * d;

  stage_rows_f<float, FNT, FQ>(q_s, d, 1, base, q0, S, rs, h * d, d, true, scale, cos, sin);

  float sc[FR];
  // the scores of this thread's FR rows against key k0 + kk; masked past s_real
  auto scores = [&](int k0) {
#pragma unroll
    for (int j = 0; j < FR; ++j) sc[j] = 0.f;
    for (int i = 0; i < d; ++i) {
      const float kv = kt[i * (FK + 1) + kk];
#pragma unroll
      for (int j = 0; j < FR; ++j) sc[j] = fmaf(q_s[(rg * FR + j) * d + i], kv, sc[j]);
    }
    if (k0 + kk >= s_real) {
#pragma unroll
      for (int j = 0; j < FR; ++j) sc[j] = -INFINITY;
    }
  };
  auto stage_k = [&](int k0) {
    stage_rows_f<float, FNT, FK>(kt, 1, FK + 1, base, k0, S, rs, w + h * d, d, false, 0.f,
                                 cos, sin);
  };

  // --- pass 1: row max over all keys -------------------------------------
  float mx[FR];
#pragma unroll
  for (int j = 0; j < FR; ++j) mx[j] = -INFINITY;
  for (int k0 = 0; k0 < S; k0 += FK) {
    __syncthreads();  // kt free (and q_s written, on the first chunk)
    stage_k(k0);
    __syncthreads();
    scores(k0);
#pragma unroll
    for (int j = 0; j < FR; ++j) mx[j] = fmaxf(mx[j], sc[j]);
  }
#pragma unroll
  for (int j = 0; j < FR; ++j) {
    const float v = warp_max(mx[j]);
    if (lane == 0) red[wh * FQ + rg * FR + j] = v;
  }
  __syncthreads();
  if (tid < FQ) row_s[tid] = fmaxf(red[tid], red[FQ + tid]);
  __syncthreads();
#pragma unroll
  for (int j = 0; j < FR; ++j) mx[j] = row_s[rg * FR + j];

  // --- pass 2: recompute scores, p = exp(s - max), O += P V -----------------
  float ls[FR];
#pragma unroll
  for (int j = 0; j < FR; ++j) ls[j] = 0.f;
  // this thread's output elements e = tid + j·FNT of the [FQ, d] tile: the
  // offset of its P row (-1 past the tile) and its column
  float acc[FE];
  int prow[FE], col[FE];
#pragma unroll
  for (int j = 0; j < FE; ++j) {
    const int e = tid + j * FNT, r = e / d;
    acc[j] = 0.f;
    prow[j] = e < n_out ? r * (FK + 1) : -1;
    col[j] = e - r * d;
  }
  for (int k0 = 0; k0 < S; k0 += FK) {
    __syncthreads();  // kt, v_s and p_s free
    stage_k(k0);
    stage_rows_f<float, FNT, FK>(v_s, d, 1, base, k0, S, rs, 2 * w + h * d, d, false, 0.f,
                                 nullptr, nullptr);
    __syncthreads();
    scores(k0);
#pragma unroll
    for (int j = 0; j < FR; ++j) {
      const float p = expf(sc[j] - mx[j]);
      ls[j] += p;
      p_s[(rg * FR + j) * (FK + 1) + kk] = p;
    }
    __syncthreads();
    const int kmax = min(FK, S - k0);
    for (int k = 0; k < kmax; ++k) {
#pragma unroll
      for (int j = 0; j < FE; ++j)
        if (prow[j] >= 0) acc[j] = fmaf(p_s[prow[j] + k], v_s[k * d + col[j]], acc[j]);
    }
  }
#pragma unroll
  for (int j = 0; j < FR; ++j) {
    const float v = warp_sum(ls[j]);
    if (lane == 0) red[wh * FQ + rg * FR + j] = v;
  }
  __syncthreads();
  if (tid < FQ) row_s[tid] = 1.0f / (red[tid] + red[FQ + tid]);
  __syncthreads();
#pragma unroll
  for (int j = 0; j < FE; ++j) {
    const int r = prow[j] / (FK + 1), qi = q0 + r;
    if (prow[j] >= 0 && qi < S)
      out[((size_t)blockIdx.z * S + qi) * w + h * d + col[j]] = acc[j] * row_s[r];
  }
}

int launch_f32(const void* qkv, void* out, int B, int S, int s_real, int w, int heads,
               float scale, const void* cos, const void* sin, cudaStream_t stream) {
  const int d = w / heads;
  const size_t smem = fma_smem_bytes(d);
  cudaError_t err = cudaFuncSetAttribute(grouped_fma_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((S + FQ - 1) / FQ, heads, B);
  grouped_fma_kernel<<<grid, FNT, smem, stream>>>(
      static_cast<const float*>(qkv), static_cast<float*>(out), S, s_real, w, d, scale,
      static_cast<const float*>(cos), static_cast<const float*>(sin));
  return (int)cudaGetLastError();
}

// ---- bfloat16: tensor-core kernel, 128 query rows a block ------------------

constexpr int GQ = 128;   // query rows per block (8 warps x 16)
constexpr int GK = 64;    // keys per streamed chunk
constexpr int GNT = 256;  // threads per block

template <int DP>  // head dim padded to a multiple of 16
constexpr size_t mma_smem_bytes() {
  return sizeof(__nv_bfloat16) * ((size_t)(GQ + GK) * (DP + PAD) + (size_t)DP * (GK + PAD));
}

template <int DP>
__global__ void __launch_bounds__(GNT) grouped_mma_kernel(
    const __nv_bfloat16* __restrict__ qkv, __nv_bfloat16* __restrict__ out, int S,
    int s_real, int w, int d, float scale, const __nv_bfloat16* __restrict__ cos,
    const __nv_bfloat16* __restrict__ sin) {
  constexpr int LDQ = DP + PAD;  // row stride of Qs and Ks
  constexpr int LDV = GK + PAD;  // row stride of Vt
  extern __shared__ __align__(16) unsigned char mma_smem[];
  __nv_bfloat16* Qs = reinterpret_cast<__nv_bfloat16*>(mma_smem);  // [GQ][LDQ]
  __nv_bfloat16* Ks = Qs + GQ * LDQ;                                // [GK][LDQ]
  __nv_bfloat16* Vt = Ks + GK * LDQ;                                // [DP][LDV], V^T

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, t = lane % 4;  // mma fragment coordinates
  const int q0 = blockIdx.x * GQ, h = blockIdx.y;
  const size_t rs = 3 * (size_t)w;
  const __nv_bfloat16* base = qkv + (size_t)blockIdx.z * S * rs;

  // q tile scaled in bf16 (the scale rounded to bf16 first), then rotated
  const float scale_t = __bfloat162float(__float2bfloat16_rn(scale));
  stage_rows_bf16<GNT, GQ, DP, LDQ>(Qs, base, q0, S, rs, h * d, d, true, scale_t, cos, sin);
  __syncthreads();
  const int r0 = warp * 16;
  uint32_t qa[DP / 16][4];
#pragma unroll
  for (int ks = 0; ks < DP / 16; ++ks) {
    qa[ks][0] = ld32(Qs + (r0 + g) * LDQ + ks * 16 + 2 * t);
    qa[ks][1] = ld32(Qs + (r0 + g + 8) * LDQ + ks * 16 + 2 * t);
    qa[ks][2] = ld32(Qs + (r0 + g) * LDQ + ks * 16 + 8 + 2 * t);
    qa[ks][3] = ld32(Qs + (r0 + g + 8) * LDQ + ks * 16 + 8 + 2 * t);
  }
  // a warp whose 16 rows all lie past the sequence still stages and syncs,
  // but skips the products
  const bool live = q0 + r0 < S;

  auto stage_k = [&](int k0) {
    stage_rows_bf16<GNT, GK, DP, LDQ>(Ks, base, k0, S, rs, w + h * d, d, false, 0.f, cos, sin);
  };
  // this warp's 16 x GK score block of one chunk: s[j] is keys 8j..8j+7,
  // c0/c1 row g keys 2t/2t+1, c2/c3 row g+8 (the mma accumulator layout)
  auto scores = [&](float (&s)[GK / 8][4], int k0) {
#pragma unroll
    for (int j = 0; j < GK / 8; ++j) {
      s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
      const __nv_bfloat16* kr = Ks + (j * 8 + g) * LDQ + 2 * t;
#pragma unroll
      for (int ks = 0; ks < DP / 16; ++ks)
        mma_bf16(s[j], qa[ks], ld32(kr + ks * 16), ld32(kr + ks * 16 + 8));
      const int key = k0 + j * 8 + 2 * t;
      if (key >= s_real) s[j][0] = s[j][2] = -INFINITY;
      if (key + 1 >= s_real) s[j][1] = s[j][3] = -INFINITY;
    }
  };

  // --- pass 1: row max over all keys -----------------------------------
  float m0 = -INFINITY, m1 = -INFINITY;  // rows g and g+8
  for (int k0 = 0; k0 < S; k0 += GK) {
    __syncthreads();
    stage_k(k0);
    __syncthreads();
    if (!live) continue;
    float s[GK / 8][4];
    scores(s, k0);
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

  // --- pass 2: recompute scores, P = bf16(exp(s - max)), O += P V ---------
  float l0 = 0.f, l1 = 0.f;
  float o[DP / 8][4];
#pragma unroll
  for (int n = 0; n < DP / 8; ++n) o[n][0] = o[n][1] = o[n][2] = o[n][3] = 0.f;
  for (int k0 = 0; k0 < S; k0 += GK) {
    __syncthreads();
    stage_k(k0);
    stage_vt_bf16<GNT, GK, DP, LDV>(Vt, base, k0, S, rs, 2 * w + h * d, d);
    __syncthreads();
    if (!live) continue;
    float s[GK / 8][4];
    scores(s, k0);
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
#pragma unroll
    for (int n = 0; n < DP / 8; ++n) {
      const __nv_bfloat16* vr = Vt + (n * 8 + g) * LDV + 2 * t;
#pragma unroll
      for (int kk = 0; kk < GK / 16; ++kk)
        mma_bf16(o[n], pa[kk], ld32(vr + kk * 16), ld32(vr + kk * 16 + 8));
    }
  }
  if (!live) return;
  l0 += __shfl_xor_sync(0xffffffffu, l0, 1);
  l0 += __shfl_xor_sync(0xffffffffu, l0, 2);
  l1 += __shfl_xor_sync(0xffffffffu, l1, 1);
  l1 += __shfl_xor_sync(0xffffffffu, l1, 2);
  const float inv0 = 1.0f / l0, inv1 = 1.0f / l1;
  const int row0 = q0 + r0 + g, row1 = row0 + 8;
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
int launch_mma(const void* qkv, void* out, int B, int S, int s_real, int w, int heads,
               float scale, const void* cos, const void* sin, cudaStream_t stream) {
  const size_t smem = mma_smem_bytes<DP>();
  cudaError_t err = cudaFuncSetAttribute(grouped_mma_kernel<DP>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((S + GQ - 1) / GQ, heads, B);
  grouped_mma_kernel<DP><<<grid, GNT, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(qkv), static_cast<__nv_bfloat16*>(out), S, s_real,
      w, w / heads, scale, static_cast<const __nv_bfloat16*>(cos),
      static_cast<const __nv_bfloat16*>(sin));
  return (int)cudaGetLastError();
}

int launch_bf16(const void* qkv, void* out, int B, int S, int s_real, int w, int heads,
                float scale, const void* cos, const void* sin, cudaStream_t stream) {
  const int d = w / heads;
  if (d % 8 != 0) return (int)cudaErrorInvalidValue;  // 16-byte row loads
  if (cos != nullptr && d % 16 != 0) return (int)cudaErrorInvalidValue;  // paired half vectors
  if (d <= 64) return launch_mma<64>(qkv, out, B, S, s_real, w, heads, scale, cos, sin, stream);
  if (d <= 80) return launch_mma<80>(qkv, out, B, S, s_real, w, heads, scale, cos, sin, stream);
  if (d <= 96) return launch_mma<96>(qkv, out, B, S, s_real, w, heads, scale, cos, sin, stream);
  if (d <= 112)
    return launch_mma<112>(qkv, out, B, S, s_real, w, heads, scale, cos, sin, stream);
  return launch_mma<128>(qkv, out, B, S, s_real, w, heads, scale, cos, sin, stream);
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16. cos, sin: RoPE tables [S, d/2] of the
// same dtype (half-split pairs), or both null for no rotation. Returns
// cudaGetLastError() of the launch.
int packed_attention_grouped(const void* qkv, void* out, int dtype, int B, int S, int s_real,
                             int w, int heads, float scale, const void* cos, const void* sin,
                             void* stream) {
  if (heads <= 0 || w % heads != 0 || w / heads > DMAX || s_real < 1 || s_real > S ||
      (cos == nullptr) != (sin == nullptr) || (cos != nullptr && (w / heads) % 2 != 0))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return launch_f32(qkv, out, B, S, s_real, w, heads, scale, cos, sin, st);
  if (dtype == 1) return launch_bf16(qkv, out, B, S, s_real, w, heads, scale, cos, sin, st);
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
