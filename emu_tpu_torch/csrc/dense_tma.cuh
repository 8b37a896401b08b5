// The TMA + wgmma bf16 GEMM of kernel H (fused_dense.cu) and kernel B
// (fused_mlp.cu), with the row pass both use for a LayerNorm:
//
// - dense_tma_kernel<EPI>: 128 x 128 output tiles, two consumer
//   warpgroups of 64 rows each and one producer warp that keeps a 3-stage
//   ring of x tiles (128 x 64, K-major) and W tiles (64 x 128, read
//   N-major: the transposed-B form of wgmma) in flight through TMA behind
//   mbarriers, the 128-byte swizzle, zero-filled past M, N and K; the
//   products are SS wgmma m64n128k16 with the accumulator in registers,
//   one group in flight while the next stage lands. At 96 KB of shared
//   memory two blocks share an SM, so one block's epilogue overlaps the
//   other's products. Each block walks all of K. The epilogue is a
//   template parameter:
//     EPI_DENSE  (H, and B's second product): + bias, then the post form's
//                fp32 workspace, or + residual and one rounding;
//     EPI_GELU   (B's first product): + b1, exact erf GELU in fp32, one
//                rounding to the bf16 hidden activation;
//     EPI_SWIGLU (B's first product, SwiGLU): the W tile's two 64-column
//                boxes come from the gate and the up weights at the same
//                hidden columns, so a block owns 64 hidden columns and
//                holds both sums: silu(g + b1) * (u + b2) in fp32, one
//                rounding.
// - ln_rows_kernel: one block a row, out = bf16(LN(row) [+ res]) in fp32
//   (two passes), the pre form's first pass and the post form's last.

#pragma once

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

#include "hopper.cuh"
#include "wgmma.cuh"

namespace {

typedef __nv_bfloat16 bf16;

enum Mode { PLAIN = 0, PRE = 1, POST = 2 };
enum TmaEpi { EPI_DENSE = 0, EPI_GELU = 1, EPI_SWIGLU = 2 };

struct DenseArgs {
  const bf16* x;         // [M, K]
  const bf16* w;         // [Kw, N]: the rows past Kw read as zeros
  const void* bias;      // [N] or null
  const void* bias_up;   // EPI_SWIGLU: the up projection's bias [N] or null
  const void* ln_s;      // [K] (pre) or [N] (post)
  const void* ln_b;
  bool vec_bf16;         // bias, bias_up, ln_s, ln_b: bf16 (else fp32)
  const bf16* res;       // [M, N] or null
  float* ws;             // post: [M, N] fp32
  bf16* out;             // [M, N]
  int M, K, Kw, N, mode;
};

// Element i of a bias or LayerNorm vector, in fp32.
__device__ inline float vec_at(const void* p, int i, bool bf) {
  return bf ? __bfloat162float(static_cast<const bf16*>(p)[i])
            : static_cast<const float*>(p)[i];
}

__device__ inline float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// One output pair (row, col), (row, col + 1) from the fp32 sums.
__device__ inline void store_pair(const DenseArgs& a, int row, int col, float v0, float v1) {
  if (row >= a.M || col >= a.N) return;
  const long long base = static_cast<long long>(row) * a.N + col;
  const bool two = col + 1 < a.N;
  if (a.bias != nullptr) {
    v0 += vec_at(a.bias, col, a.vec_bf16);
    if (two) v1 += vec_at(a.bias, col + 1, a.vec_bf16);
  }
  if (a.mode == POST) {
    a.ws[base] = v0;
    if (two) a.ws[base + 1] = v1;
    return;
  }
  if (a.res != nullptr) {
    v0 += __bfloat162float(a.res[base]);
    if (two) v1 += __bfloat162float(a.res[base + 1]);
  }
  if (two && (a.N % 2 == 0)) {
    *reinterpret_cast<__nv_bfloat162*>(a.out + base) = __floats2bfloat162_rn(v0, v1);
  } else {
    a.out[base] = __float2bfloat16(v0);
    if (two) a.out[base + 1] = __float2bfloat16(v1);
  }
}

__device__ inline float gelu_erf(float v) {
  return 0.5f * v * (1.f + erff(v * 0.70710678118654752f));
}

// Sum over the block (blockDim.x a multiple of 32, at most 1024); red
// holds 32 floats.
__device__ float block_sum(float v, float* red) {
  v = warp_sum(v);
  __syncthreads();   // red may still be read by a previous call
  if (threadIdx.x % 32 == 0) red[threadIdx.x / 32] = v;
  __syncthreads();
  float r = 0.f;
  for (int i = 0; i < static_cast<int>(blockDim.x / 32); ++i) r += red[i];
  return r;
}

__device__ inline float to_f32(float v) { return v; }
__device__ inline float to_f32(bf16 v) { return __bfloat162float(v); }

// One block a row of `in` [rows, N]: out = bf16(LN(row) [+ res]), the
// statistics and the normalisation in fp32 (two passes). The pre form's
// first pass (in = x, bf16) and the post form's second (in = the fp32 ws).
template <typename T>
__global__ void ln_rows_kernel(const T* __restrict__ in, const void* __restrict__ ln_s,
                               const void* __restrict__ ln_b, bool vec_bf16,
                               const bf16* __restrict__ res, bf16* __restrict__ out, int N,
                               float eps) {
  __shared__ float red[32];
  const long long base = static_cast<long long>(blockIdx.x) * N;
  float s = 0.f;
  for (int c = threadIdx.x; c < N; c += blockDim.x) s += to_f32(in[base + c]);
  const float mean = block_sum(s, red) / N;
  float v = 0.f;
  for (int c = threadIdx.x; c < N; c += blockDim.x) {
    const float d = to_f32(in[base + c]) - mean;
    v += d * d;
  }
  const float rstd = rsqrtf(block_sum(v, red) / N + eps);
  for (int c = threadIdx.x; c < N; c += blockDim.x) {
    float y = (to_f32(in[base + c]) - mean) * rstd * vec_at(ln_s, c, vec_bf16)
              + vec_at(ln_b, c, vec_bf16);
    if (res != nullptr) y += __bfloat162float(res[base + c]);
    out[base + c] = __float2bfloat16(y);
  }
}

// Output tiles of 128 x 128, K 64 a stage, a 3-stage ring: 96 KB, so two
// blocks share an SM. (Tiles of 128 x 256 with a 4-stage ring, one block an
// SM, measured slower for H at every UNet shape but one, and no faster for
// B's products at 257-8224 rows.)
struct TmaPlan {
  static constexpr int BM = 128, BN = 128, BK = 64;
  static constexpr int STAGES = 3;
  static constexpr int A_BYTES = BM * BK * 2;  // an x tile [128][64]
  static constexpr int B_BYTES = BK * BN * 2;  // a W tile: two [64 k][64 n] boxes
  static constexpr int STAGE_BYTES = A_BYTES + B_BYTES;
  static constexpr int BAR_OFF = STAGES * STAGE_BYTES;
  static constexpr int SMEM = BAR_OFF + 8 * 2 * STAGES + 1024;
};
constexpr int T_THREADS = 2 * 128 + 32;  // two consumer warpgroups, a producer warp

// Output columns a block owns: the SwiGLU form's W tile holds 64 gate and
// 64 up columns of the same hidden units.
template <int EPI>
__host__ __device__ constexpr int tma_cols() { return EPI == EPI_SWIGLU ? 64 : 128; }

// One 128-row output tile over all of K, 64 a step, then the epilogue.
// umap: the up weights (EPI_SWIGLU; unread otherwise).
template <int EPI>
__global__ void __launch_bounds__(T_THREADS, 2)
    dense_tma_kernel(const __grid_constant__ CUtensorMap xmap,
                     const __grid_constant__ CUtensorMap wmap,
                     const __grid_constant__ CUtensorMap umap, const DenseArgs a) {
  using Plan = TmaPlan;
  constexpr int STAGES = Plan::STAGES, BN = Plan::BN;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~static_cast<uintptr_t>(1023));
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + Plan::BAR_OFF);
  uint64_t* empty = full + STAGES;
  const int n0 = blockIdx.x * tma_cols<EPI>(), m0 = blockIdx.y * Plan::BM;
  const int steps = (a.K + Plan::BK - 1) / Plan::BK;

  if (threadIdx.x == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 256);
    }
    mbar_fence_init();
  }
  __syncthreads();

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  if (warp == 8) {
    // ---- producer: one thread issues every copy ----
    if (lane == 0) {
      for (int i = 0; i < steps; ++i) {
        const int s = i % STAGES;
        if (i >= STAGES) mbar_wait(&empty[s], ((i / STAGES) + 1) & 1);
        unsigned char* st = smem + s * Plan::STAGE_BYTES;
        const int k0 = i * Plan::BK;
        mbar_arrive_tx(&full[s], Plan::STAGE_BYTES);
        tma_load_2d(st, &xmap, &full[s], k0, m0);
        for (int c = 0; c < BN / 64; ++c) {
          unsigned char* dst = st + Plan::A_BYTES + c * 64 * 128;
          if (EPI == EPI_SWIGLU)  // the gate box, then the up box
            tma_load_2d(dst, c == 0 ? &wmap : &umap, &full[s], n0, k0);
          else
            tma_load_2d(dst, &wmap, &full[s], n0 + c * 64, k0);
        }
      }
    }
    return;
  }

  // ---- consumer warpgroups: 64 rows of the tile each ----
  const int wg = warp / 4, g = lane / 4, t = lane % 4;
  float acc[BN / 2];
#pragma unroll
  for (int i = 0; i < BN / 2; ++i) acc[i] = 0.f;
  for (int i = 0; i < steps; ++i) {
    const int s = i % STAGES;
    const unsigned char* st = smem + s * Plan::STAGE_BYTES;
    mbar_wait(&full[s], (i / STAGES) & 1);
    fence_acc(acc);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < Plan::BK / 16; ++kk)
      wgmma_bf16_ss_tb_n128(acc, smem_desc(st + wg * 64 * 128 + kk * 32, 16, 1024),
                            smem_desc(st + Plan::A_BYTES + kk * 16 * 128, 64 * 128, 1024), 1);
    wgmma_commit();
    wgmma_wait<1>();  // the previous stage's products have landed
    fence_acc(acc);
    if (i > 0) mbar_arrive(&empty[(i - 1) % STAGES]);
  }
  wgmma_wait<0>();
  fence_acc(acc);

  // accumulator j: rows g and g + 8 of the warp's 16, columns j * 8 + 2t, + 1
  const int row = m0 + wg * 64 + (warp % 4) * 16 + g;
  if constexpr (EPI == EPI_DENSE) {
#pragma unroll
    for (int j = 0; j < BN / 8; ++j) {
      const int col = n0 + j * 8 + 2 * t;
#pragma unroll
      for (int r = 0; r < 2; ++r)
        store_pair(a, row + 8 * r, col, acc[j * 4 + 2 * r], acc[j * 4 + 2 * r + 1]);
    }
  } else {
    // EPI_GELU and EPI_SWIGLU: the hidden activation, N a multiple of 8, one
    // bf16 pair a store
    constexpr int JN = EPI == EPI_SWIGLU ? BN / 16 : BN / 8;
#pragma unroll
    for (int j = 0; j < JN; ++j) {
      const int col = n0 + j * 8 + 2 * t;
      if (col >= a.N) continue;
      float b0 = 0.f, b1 = 0.f, u0 = 0.f, u1 = 0.f;
      if (a.bias != nullptr) {
        b0 = vec_at(a.bias, col, a.vec_bf16);
        b1 = vec_at(a.bias, col + 1, a.vec_bf16);
      }
      if (EPI == EPI_SWIGLU && a.bias_up != nullptr) {
        u0 = vec_at(a.bias_up, col, a.vec_bf16);
        u1 = vec_at(a.bias_up, col + 1, a.vec_bf16);
      }
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int rr = row + 8 * r;
        if (rr >= a.M) continue;
        float v0 = acc[j * 4 + 2 * r] + b0, v1 = acc[j * 4 + 2 * r + 1] + b1;
        if constexpr (EPI == EPI_SWIGLU) {
          const float g0 = v0, g1 = v1;
          const float up0 = acc[(j + JN) * 4 + 2 * r] + u0;
          const float up1 = acc[(j + JN) * 4 + 2 * r + 1] + u1;
          v0 = g0 / (1.f + expf(-g0)) * up0;
          v1 = g1 / (1.f + expf(-g1)) * up1;
        } else {
          v0 = gelu_erf(v0);
          v1 = gelu_erf(v1);
        }
        *reinterpret_cast<__nv_bfloat162*>(a.out + static_cast<long long>(rr) * a.N + col) =
            __floats2bfloat162_rn(v0, v1);
      }
    }
  }
}

// The shared-memory attribute is set first: that runtime call binds the
// card's context to the calling thread, which the tensor-map encoder needs.
// w_up: the up weights [Kw, N] of EPI_SWIGLU (null otherwise).
template <int EPI>
cudaError_t launch_tma(const DenseArgs& a, const bf16* w_up, cudaStream_t s) {
  using Plan = TmaPlan;
  cudaError_t err = cudaFuncSetAttribute(dense_tma_kernel<EPI>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, Plan::SMEM);
  if (err != cudaSuccess) return err;
  CUtensorMap xmap, wmap, umap;
  const uint64_t xdims[2] = {static_cast<uint64_t>(a.K), static_cast<uint64_t>(a.M)};
  const uint64_t xstr[1] = {static_cast<uint64_t>(a.K) * 2};
  const uint32_t xbox[2] = {Plan::BK, Plan::BM};
  const uint64_t wdims[2] = {static_cast<uint64_t>(a.N), static_cast<uint64_t>(a.Kw)};
  const uint64_t wstr[1] = {static_cast<uint64_t>(a.N) * 2};
  const uint32_t wbox[2] = {64, Plan::BK};
  if (!make_map(&xmap, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, a.x, xdims, xstr, xbox) ||
      !make_map(&wmap, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, a.w, wdims, wstr, wbox))
    return cudaErrorInvalidValue;
  umap = wmap;
  if (EPI == EPI_SWIGLU &&
      !make_map(&umap, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, w_up, wdims, wstr, wbox))
    return cudaErrorInvalidValue;
  constexpr int COLS = tma_cols<EPI>();
  const dim3 grid((a.N + COLS - 1) / COLS, (a.M + Plan::BM - 1) / Plan::BM);
  dense_tma_kernel<EPI><<<grid, T_THREADS, Plan::SMEM, s>>>(xmap, wmap, umap, a);
  return cudaGetLastError();
}

}  // namespace
