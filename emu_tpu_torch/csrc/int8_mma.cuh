// Shared pieces of the quantized kernels (E: fused_mlp_w8a8.cu and
// w8a8_gemm.cuh; F, G: q4_matmul.cu):
//
// - quant_rows_kernel: per-row symmetric int8 quantization of bf16 rows,
//   optionally after an fp32 LayerNorm or an RMSNorm (HF rounding);
// - rows_epilogue_kernel: one block per row: sum fp32 split slices in a
//   fixed order, + bias, optional fp32 LayerNorm, optional residual, bf16
//   (E's post form);
// - i8_gelu and i8_quant: the A&S erf GELU and the int8 rounding of the
//   TPU kernels;
// - mma_s8: mma.sync m16n8k32 s8 -> s32 (G's decode plan);
// - GemmArgs, gemm_store and split_epilogue_kernel, which the W4A8 GEMM of
//   kernel F (w4a8_gemm.cuh) uses.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__device__ inline float i8_warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ inline float i8_warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

// Sum (or max) over the block, the same order on every run; red holds 32.
template <bool MAX>
__device__ float i8_block_reduce(float v, float* red) {
  v = MAX ? i8_warp_max(v) : i8_warp_sum(v);
  const int w = threadIdx.x / 32;
  __syncthreads();  // red may still be read by a previous call
  if (threadIdx.x % 32 == 0) red[w] = v;
  __syncthreads();
  float r = red[0];
  for (int i = 1; i < static_cast<int>(blockDim.x / 32); ++i)
    r = MAX ? fmaxf(r, red[i]) : r + red[i];
  return r;
}

// Scales are max|v| times the fp32 reciprocal of 127, as XLA compiles the
// JAX package's max|v| / 127 in every jitted program.
__device__ inline int8_t i8_quant(float v, float s) {
  return static_cast<int8_t>(fminf(fmaxf(rintf(v / s), -127.f), 127.f));
}

// erf by Abramowitz & Stegun 7.1.26 (max abs error ~4e-7), the form the TPU
// kernels use; gelu(x) = 0.5 x (1 + erf(x / sqrt 2)).
__device__ inline float i8_gelu(float x) {
  const float z = x * 0.70710678118654752f;
  const float a = fabsf(z);
  const float t = 1.f / (1.f + 0.3275911f * a);
  const float poly = t * (0.254829592f + t * (-0.284496736f + t * (1.421413741f +
                     t * (-1.453152027f + t * 1.061405429f))));
  const float e = 1.f - poly * expf(-a * a);
  return 0.5f * x * (1.f + copysignf(e, z));
}

enum RowMode { ROW_PLAIN = 0, ROW_LAYERNORM = 1, ROW_RMSNORM = 2 };

// One block per row of x [M, K] bf16 -> q [M, K] int8, s [M] fp32 with
// s = max(max|v| * (1/127), 1e-8), q = clip(rint(v / s), -127, 127), where v is
// x (ROW_PLAIN), LayerNorm(x) in fp32 (w, b: scale, bias), or
// bf16(x * rsqrt(mean(x^2) + eps)) * w in fp32 (ROW_RMSNORM).
__global__ void quant_rows_kernel(const __nv_bfloat16* __restrict__ x, int K, int mode,
                                  const __nv_bfloat16* __restrict__ w,
                                  const __nv_bfloat16* __restrict__ b, float eps,
                                  int8_t* __restrict__ q, float* __restrict__ s) {
  __shared__ float red[32];
  const long long r = blockIdx.x;
  const __nv_bfloat16* xr = x + r * K;
  float mean = 0.f, rstd = 1.f;
  if (mode == ROW_LAYERNORM) {
    float a = 0.f;
    for (int c = threadIdx.x; c < K; c += blockDim.x) a += __bfloat162float(xr[c]);
    mean = i8_block_reduce<false>(a, red) / K;
    float v = 0.f;
    for (int c = threadIdx.x; c < K; c += blockDim.x) {
      const float d = __bfloat162float(xr[c]) - mean;
      v += d * d;
    }
    rstd = rsqrtf(i8_block_reduce<false>(v, red) / K + eps);
  } else if (mode == ROW_RMSNORM) {
    float a = 0.f;
    for (int c = threadIdx.x; c < K; c += blockDim.x) {
      const float xv = __bfloat162float(xr[c]);
      a += xv * xv;
    }
    rstd = rsqrtf(i8_block_reduce<false>(a, red) / K + eps);
  }
  auto val = [&](int c) {
    const float xv = __bfloat162float(xr[c]);
    if (mode == ROW_LAYERNORM)
      return (xv - mean) * rstd * __bfloat162float(w[c]) + __bfloat162float(b[c]);
    if (mode == ROW_RMSNORM)
      return __bfloat162float(__float2bfloat16(xv * rstd)) * __bfloat162float(w[c]);
    return xv;
  };
  float m = 0.f;
  for (int c = threadIdx.x; c < K; c += blockDim.x) m = fmaxf(m, fabsf(val(c)));
  const float sc = fmaxf(i8_block_reduce<true>(m, red) * (1.f / 127.f), 1e-8f);
  for (int c = threadIdx.x; c < K; c += blockDim.x) q[r * K + c] = i8_quant(val(c), sc);
  if (threadIdx.x == 0) s[r] = sc;
}

constexpr int ROWS_MAX_PER_THREAD = 8;  // N <= 8 * blockDim.x

// One block per row: y = sum over splits of ws[sp, r, :] (fixed order)
// [+ bias] [-> LayerNorm fp32] [+ x] -> bf16.
__global__ void rows_epilogue_kernel(const float* __restrict__ ws, int splits, long long M,
                                     int N, const __nv_bfloat16* __restrict__ bias,
                                     const __nv_bfloat16* __restrict__ ln_s,
                                     const __nv_bfloat16* __restrict__ ln_b, float eps,
                                     const __nv_bfloat16* __restrict__ x,
                                     __nv_bfloat16* __restrict__ out) {
  __shared__ float red[32];
  const long long r = blockIdx.x;
  float v[ROWS_MAX_PER_THREAD];
  float sum = 0.f;
#pragma unroll
  for (int i = 0; i < ROWS_MAX_PER_THREAD; ++i) {
    const int c = threadIdx.x + i * blockDim.x;
    v[i] = 0.f;
    if (c < N) {
      float y = ws[r * N + c];
      for (int sp = 1; sp < splits; ++sp) y += ws[sp * M * N + r * N + c];
      if (bias != nullptr) y += __bfloat162float(bias[c]);
      v[i] = y;
      sum += y;
    }
  }
  if (ln_s != nullptr) {
    const float mean = i8_block_reduce<false>(sum, red) / N;
    float var = 0.f;
#pragma unroll
    for (int i = 0; i < ROWS_MAX_PER_THREAD; ++i) {
      const int c = threadIdx.x + i * blockDim.x;
      if (c < N) var += (v[i] - mean) * (v[i] - mean);
    }
    const float rstd = rsqrtf(i8_block_reduce<false>(var, red) / N + eps);
#pragma unroll
    for (int i = 0; i < ROWS_MAX_PER_THREAD; ++i) {
      const int c = threadIdx.x + i * blockDim.x;
      if (c < N)
        v[i] = (v[i] - mean) * rstd * __bfloat162float(ln_s[c]) + __bfloat162float(ln_b[c]);
    }
  }
#pragma unroll
  for (int i = 0; i < ROWS_MAX_PER_THREAD; ++i) {
    const int c = threadIdx.x + i * blockDim.x;
    if (c < N) {
      float y = v[i];
      if (x != nullptr) y += __bfloat162float(x[r * N + c]);
      out[r * N + c] = __float2bfloat16(y);
    }
  }
}

constexpr int KT = 128;       // K rows per W4A8 tile

struct GemmArgs {
  const int8_t* a;             // activations [M, K] int8
  const int8_t* w;             // W8A8: [K, N] int8; W4A8: fold-packed [K/2, N]
  const float* w_scale;        // W8A8: [N]; W4A8: [K / gs, N]
  const float* row_scale;      // W4A8: [M], applied after the sum, or null
  const float* blk_scale;      // per-(row, block) activation scales or null:
                               //   W8A8 [M, nblk]; W4A8 [M, 2, nblk] (per plane)
  const __nv_bfloat16* bias;   // [N] or null
  const __nv_bfloat16* residual;  // [M, N] or null
  float* out_f32;              // [M, N]: one of out_f32 / out_bf16
  __nv_bfloat16* out_bf16;
  int M, N, K;
  int gs;                      // W4A8 rows per scale group (a multiple of KT)
  int blk, nblk;               // K rows (W4A8: per plane) per activation block
  int gelu;
  int splits, tiles_per_split; // K splits (blockIdx.z) and K tiles in each
  float* ws;                   // [splits, M, N] fp32 when splits > 1
};

// The epilogue of one output element from its fp32 sum.
template <bool INT4>
__device__ inline void gemm_store(const GemmArgs& p, int row, int col, float y) {
  if (INT4) {
    if (p.row_scale != nullptr) y *= p.row_scale[row];
  } else {
    y *= p.w_scale[col];
  }
  if (p.bias != nullptr) y += __bfloat162float(p.bias[col]);
  if (p.gelu) y = i8_gelu(y);
  const long long o = static_cast<long long>(row) * p.N + col;
  if (p.residual != nullptr) y += __bfloat162float(p.residual[o]);
  if (p.out_f32 != nullptr) p.out_f32[o] = y;
  else p.out_bf16[o] = __float2bfloat16(y);
}

template <bool INT4>
__global__ void split_epilogue_kernel(const GemmArgs p) {
  const long long total = static_cast<long long>(p.M) * p.N;
  for (long long i = blockIdx.x * static_cast<long long>(blockDim.x) + threadIdx.x;
       i < total; i += static_cast<long long>(gridDim.x) * blockDim.x) {
    float y = p.ws[i];
    for (int z = 1; z < p.splits; ++z) y += p.ws[z * total + i];
    gemm_store<INT4>(p, static_cast<int>(i / p.N), static_cast<int>(i % p.N), y);
  }
}

__device__ inline void mma_s8(int* d, const unsigned* a, const unsigned* b) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 {%0,%1,%2,%3}, "
      "{%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

inline GemmArgs gemm_args() {
  GemmArgs a = {};
  a.gs = KT;
  a.blk = 1 << 30;  // one activation block over all of K
  a.nblk = 1;
  a.splits = 1;
  return a;
}

}  // namespace
