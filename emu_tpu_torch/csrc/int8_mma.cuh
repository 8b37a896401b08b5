// Shared pieces of the quantized kernels (E: fused_mlp_w8a8.cu; F, G:
// q4_matmul.cu) and of kernel B's post-LN epilogue (fused_mlp.cu):
//
// - quant_rows_kernel: per-row symmetric int8 quantization of bf16 rows,
//   optionally after an fp32 LayerNorm or an RMSNorm (HF rounding);
// - block_requant_kernel: per-(row, block) int8 requantization of an fp32
//   activation, optionally forming silu(g) * u first;
// - rows_epilogue_kernel: one block per row: sum fp32 split slices in a
//   fixed order, + bias, optional fp32 LayerNorm, optional residual, bf16;
// - int8_gemm_kernel: an int8 tensor-core GEMM (mma.sync m16n8k32 s8 -> s32)
//   over int8 activations [M, K] and int8 weights [K, N] (W8A8, kernel E),
//   the integer sums of each activation block folded into an fp32
//   accumulator with their scales, and a small epilogue (scales, bias,
//   GELU, residual);
// - GemmArgs, gemm_store and split_epilogue_kernel, which the W4A8 GEMM of
//   kernel F (w4a8_gemm.cuh) shares.
//
// The W8A8 GEMM is a plain first version: one 128-deep K tile at a time in
// shared memory (no pipelining), weights gathered one byte per thread
// (neighbouring threads on neighbouring columns, so loads coalesce and any
// N works) and written K-contiguous, the layout mma's B operand wants.

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

// Grid (M, F / bf): row r, block j of columns [j*bf, (j+1)*bf) of an fp32
// activation -> q [M, F] int8 and s [M, F / bf]. The value is src[r, c], or
// with swiglu silu(g) * u = g / (1 + exp(-g)) * u for g = src[r, c],
// u = src[r, F + c] (src row stride lds).
__global__ void block_requant_kernel(const float* __restrict__ src, long long lds, int F,
                                     int bf, int swiglu, int8_t* __restrict__ q,
                                     float* __restrict__ s) {
  __shared__ float red[32];
  const long long r = blockIdx.x;
  const int c0 = blockIdx.y * bf;
  const float* row = src + r * lds;
  auto val = [&](int c) {
    if (!swiglu) return row[c];
    const float g = row[c];
    return g / (1.f + expf(-g)) * row[F + c];
  };
  float m = 0.f;
  for (int c = c0 + threadIdx.x; c < c0 + bf; c += blockDim.x) m = fmaxf(m, fabsf(val(c)));
  const float sc = fmaxf(i8_block_reduce<true>(m, red) * (1.f / 127.f), 1e-8f);
  for (int c = c0 + threadIdx.x; c < c0 + bf; c += blockDim.x)
    q[r * F + c] = i8_quant(val(c), sc);
  if (threadIdx.x == 0) s[r * (F / bf) + blockIdx.y] = sc;
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

constexpr int KT = 128;       // K rows per shared-memory tile
constexpr int LDS = KT + 16;  // tile row stride in bytes: conflict-free fragment loads

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

// The W8A8 GEMM. Block tile BM x BN = (WM * MI * 16) x (WN * NI * 8),
// WM * WN warps, each warp MI x NI mma tiles.
template <int WM, int WN, int MI, int NI>
__global__ void __launch_bounds__(WM * WN * 32) int8_gemm_kernel(const GemmArgs p) {
  constexpr int BM = WM * MI * 16, BN = WN * NI * 8, THREADS = WM * WN * 32;
  extern __shared__ __align__(16) unsigned char smem[];
  int8_t* As = reinterpret_cast<int8_t*>(smem);  // [BM][LDS], K-contiguous
  int8_t* Bs = As + BM * LDS;                    // [BN][LDS], K-contiguous
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;
  const int wm = warp / WN, wn = warp % WN;
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;
  const int n_tiles = p.K / KT;
  const long long ldw = p.N;

  int acc[MI][NI][4];
  float accf[MI][NI][4];
#pragma unroll
  for (int i = 0; i < MI; ++i)
#pragma unroll
    for (int j = 0; j < NI; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        accf[i][j][e] = 0.f;
        acc[i][j][e] = 0;
      }

  for (int it = 0; it < n_tiles; ++it) {
    const int k0 = it * KT;
    for (int v = threadIdx.x; v < BM * (KT / 16); v += THREADS) {
      const int row = v / (KT / 16), ch = v % (KT / 16);
      uint4 val = make_uint4(0u, 0u, 0u, 0u);
      if (m0 + row < p.M)
        val = *reinterpret_cast<const uint4*>(
            p.a + static_cast<long long>(m0 + row) * p.K + k0 + ch * 16);
      *reinterpret_cast<uint4*>(As + row * LDS + ch * 16) = val;
    }
    for (int v = threadIdx.x; v < BN * (KT / 4); v += THREADS) {
      const int n = v % BN, r4 = v / BN;
      unsigned lo = 0u;
      if (n0 + n < p.N) {
        const int8_t* src = p.w + static_cast<long long>(k0 + r4 * 4) * ldw + n0 + n;
#pragma unroll
        for (int i = 0; i < 4; ++i)
          lo |= static_cast<unsigned>(src[i * ldw] & 0xFF) << (8 * i);
      }
      *reinterpret_cast<unsigned*>(Bs + n * LDS + r4 * 4) = lo;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < KT / 32; ++kk) {
      unsigned af[MI][4], bfr[NI][2];
#pragma unroll
      for (int i = 0; i < MI; ++i) {
        const int8_t* base = As + (wm * MI * 16 + i * 16 + g) * LDS + kk * 32 + t * 4;
        af[i][0] = *reinterpret_cast<const unsigned*>(base);
        af[i][1] = *reinterpret_cast<const unsigned*>(base + 8 * LDS);
        af[i][2] = *reinterpret_cast<const unsigned*>(base + 16);
        af[i][3] = *reinterpret_cast<const unsigned*>(base + 8 * LDS + 16);
      }
#pragma unroll
      for (int j = 0; j < NI; ++j) {
        const int8_t* base = Bs + (wn * NI * 8 + j * 8 + g) * LDS + kk * 32 + t * 4;
        bfr[j][0] = *reinterpret_cast<const unsigned*>(base);
        bfr[j][1] = *reinterpret_cast<const unsigned*>(base + 16);
      }
#pragma unroll
      for (int i = 0; i < MI; ++i)
#pragma unroll
        for (int j = 0; j < NI; ++j) mma_s8(acc[i][j], af[i], bfr[j]);
    }
    __syncthreads();

    // fold finished integer sums into the fp32 accumulator
    const int kend = k0 + KT;
    if (kend % p.blk != 0 && it != n_tiles - 1) continue;
#pragma unroll
    for (int i = 0; i < MI; ++i)
#pragma unroll
      for (int j = 0; j < NI; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int row = min(m0 + wm * MI * 16 + i * 16 + g + (e >= 2 ? 8 : 0), p.M - 1);
          const int col = n0 + wn * NI * 8 + j * 8 + t * 2 + (e & 1);
          if (col < p.N) {
            const float sa = p.blk_scale == nullptr ? 1.f
                : p.blk_scale[static_cast<long long>(row) * p.nblk + k0 / p.blk];
            accf[i][j][e] += static_cast<float>(acc[i][j][e]) * sa;
          }
          acc[i][j][e] = 0;
        }
  }

#pragma unroll
  for (int i = 0; i < MI; ++i)
#pragma unroll
    for (int j = 0; j < NI; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int row = m0 + wm * MI * 16 + i * 16 + g + (e >= 2 ? 8 : 0);
        const int col = n0 + wn * NI * 8 + j * 8 + t * 2 + (e & 1);
        if (row >= p.M || col >= p.N) continue;
        gemm_store<false>(p, row, col, accf[i][j][e]);
      }
}

template <int WM, int WN, int MI, int NI>
cudaError_t launch_gemm_tiles(const GemmArgs& a, cudaStream_t s) {
  constexpr int BM = WM * MI * 16, BN = WN * NI * 8;
  const int smem = (BM + BN) * LDS;
  auto kern = int8_gemm_kernel<WM, WN, MI, NI>;
  cudaError_t err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((a.N + BN - 1) / BN, (a.M + BM - 1) / BM);
  kern<<<grid, WM * WN * 32, smem, s>>>(a);
  return cudaGetLastError();
}

// The W8A8 GEMM (kernel E's two products): few rows (<= 16) in 16 x 64
// tiles, so more blocks stream the weights; otherwise 64 x 128 tiles.
inline cudaError_t launch_w8a8_gemm(const GemmArgs& a, cudaStream_t s) {
  if (a.M <= 16) return launch_gemm_tiles<1, 8, 1, 1>(a, s);
  return launch_gemm_tiles<2, 4, 2, 4>(a, s);
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
