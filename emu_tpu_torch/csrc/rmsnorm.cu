// Kernel C: residual add + RMSNorm forward over bf16 rows,
//   y = x + r  (bf16),  rsigma = rsqrt(mean(y^2) + eps),
//   h = bf16(y * rsigma * w)   (reduction and scale multiply in fp32),
// with a no-add form (r == null: y is x and is not written).
//
// Replaces the TPU kernel emu_tpu/ops/fused_norm.py:_norm_call (the
// add_rmsnorm / rms_norm_fused forward that every LLaMA layer runs twice).
//
// What bounds it on an H100: bytes. Per row of W = 5120 it reads 2 (or 1)
// bf16 rows and writes 2 (or 1); there is no matrix product. One block of
// 256 threads owns one row: the row's sum of squares is one block
// reduction, and the second pass recomputes y = x + r instead of reading
// it back. At decode (8 rows) the kernel is launch-bound whatever it does;
// it is run at every row count all the same, so the norms take one launch
// per layer instead of a chain of elementwise passes.
//
// The backward (emu_add_rmsnorm_bwd) replaces the TPU kernel
// emu_tpu/ops/fused_norm.py:_norm_bwd_call (_bwd_kernel). With g = dh * w,
// all in fp32 over the bf16 rows:
//   dx_i = g_i * rsigma - y_i * rsigma^3 * mean_j(g_j y_j) + dy_ext_i
//   dw_i = sum over rows of dh_i * y_i * rsigma
// (dy_ext, the cotangent of the residual stream y, only in the add form).
// Bytes bound it too: it reads y, dh and dy_ext and writes dx. One block of
// 256 threads owns a run of consecutive rows; each thread keeps the dw sums
// of its own columns in shared memory over the block's rows and stores them
// as that block's fp32 partial row. A second kernel adds the partial rows
// in block order, so dw is the same bits on every run (no atomics).

#include <cuda_runtime.h>
#include <cuda_bf16.h>

namespace {

constexpr int THREADS = 256;

__global__ void __launch_bounds__(THREADS) add_rmsnorm_kernel(
    const __nv_bfloat16* __restrict__ x, const __nv_bfloat16* __restrict__ r,
    const __nv_bfloat16* __restrict__ w, __nv_bfloat16* __restrict__ y,
    __nv_bfloat16* __restrict__ h, float* __restrict__ rsigma, int W, float eps) {
  __shared__ float partial[THREADS / 32];
  const long long base = static_cast<long long>(blockIdx.x) * W;
  float ss = 0.f;
  for (int i = threadIdx.x; i < W; i += THREADS) {
    __nv_bfloat16 v = x[base + i];
    if (r != nullptr) {
      v = __float2bfloat16(__bfloat162float(v) + __bfloat162float(r[base + i]));
      y[base + i] = v;
    }
    const float f = __bfloat162float(v);
    ss += f * f;
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) ss += __shfl_xor_sync(0xffffffffu, ss, o);
  if (threadIdx.x % 32 == 0) partial[threadIdx.x / 32] = ss;
  __syncthreads();
  float total = 0.f;
#pragma unroll
  for (int i = 0; i < THREADS / 32; ++i) total += partial[i];
  const float rs = rsqrtf(total / W + eps);
  for (int i = threadIdx.x; i < W; i += THREADS) {
    float f = __bfloat162float(x[base + i]);
    if (r != nullptr) f = __bfloat162float(__float2bfloat16(f + __bfloat162float(r[base + i])));
    h[base + i] = __float2bfloat16(f * rs * __bfloat162float(w[i]));
  }
  if (threadIdx.x == 0) rsigma[blockIdx.x] = rs;
}

__device__ inline float block_sum(float v, float* partial) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  __syncthreads();  // the previous call's partials are consumed
  if (threadIdx.x % 32 == 0) partial[threadIdx.x / 32] = v;
  __syncthreads();
  float total = 0.f;
#pragma unroll
  for (int i = 0; i < THREADS / 32; ++i) total += partial[i];
  return total;
}

__global__ void __launch_bounds__(THREADS) add_rmsnorm_bwd_kernel(
    const __nv_bfloat16* __restrict__ y, const __nv_bfloat16* __restrict__ w,
    const float* __restrict__ rsigma, const __nv_bfloat16* __restrict__ dh,
    const __nv_bfloat16* __restrict__ dy_ext, __nv_bfloat16* __restrict__ dx,
    float* __restrict__ dw_part, int M, int W, int rows_per_block) {
  extern __shared__ float dw_acc[];  // [W]: this thread's columns only
  __shared__ float partial[THREADS / 32];
  for (int i = threadIdx.x; i < W; i += THREADS) dw_acc[i] = 0.f;
  const int r0 = blockIdx.x * rows_per_block;
  const int r1 = min(M, r0 + rows_per_block);
  for (int row = r0; row < r1; ++row) {
    const long long base = static_cast<long long>(row) * W;
    const float rs = rsigma[row];
    float dot = 0.f;
    for (int i = threadIdx.x; i < W; i += THREADS)
      dot += __bfloat162float(dh[base + i]) * __bfloat162float(w[i]) *
             __bfloat162float(y[base + i]);
    const float mean = block_sum(dot, partial) / W;
    const float rs3 = rs * rs * rs;
    for (int i = threadIdx.x; i < W; i += THREADS) {
      const float yf = __bfloat162float(y[base + i]);
      const float d = __bfloat162float(dh[base + i]);
      float v = d * __bfloat162float(w[i]) * rs - yf * rs3 * mean;
      if (dy_ext != nullptr) v += __bfloat162float(dy_ext[base + i]);
      dx[base + i] = __float2bfloat16(v);
      dw_acc[i] += d * yf * rs;
    }
  }
  for (int i = threadIdx.x; i < W; i += THREADS)
    dw_part[static_cast<long long>(blockIdx.x) * W + i] = dw_acc[i];
}

__global__ void dw_reduce_kernel(const float* __restrict__ dw_part,
                                 float* __restrict__ dw, int n_part, int W) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= W) return;
  float s = 0.f;
  for (int p = 0; p < n_part; ++p) s += dw_part[static_cast<long long>(p) * W + i];
  dw[i] = s;
}

}  // namespace

extern "C" int emu_add_rmsnorm_bwd(const void* y, const void* w,
                                   const void* rsigma, const void* dh,
                                   const void* dy_ext, void* dx, void* dw_part,
                                   void* dw, int M, int W, int rows_per_block,
                                   void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int n_part = (M + rows_per_block - 1) / rows_per_block;
  const int smem = W * static_cast<int>(sizeof(float));
  cudaError_t err = cudaFuncSetAttribute(
      add_rmsnorm_bwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  add_rmsnorm_bwd_kernel<<<n_part, THREADS, smem, st>>>(
      static_cast<const __nv_bfloat16*>(y), static_cast<const __nv_bfloat16*>(w),
      static_cast<const float*>(rsigma), static_cast<const __nv_bfloat16*>(dh),
      static_cast<const __nv_bfloat16*>(dy_ext), static_cast<__nv_bfloat16*>(dx),
      static_cast<float*>(dw_part), M, W, rows_per_block);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  dw_reduce_kernel<<<(W + 255) / 256, 256, 0, st>>>(
      static_cast<const float*>(dw_part), static_cast<float*>(dw), n_part, W);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int emu_add_rmsnorm_fwd(const void* x, const void* r, const void* w,
                                   void* y, void* h, void* rsigma, int M, int W,
                                   float eps, void* stream) {
  add_rmsnorm_kernel<<<M, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(x), static_cast<const __nv_bfloat16*>(r),
      static_cast<const __nv_bfloat16*>(w), static_cast<__nv_bfloat16*>(y),
      static_cast<__nv_bfloat16*>(h), static_cast<float*>(rsigma), W, eps);
  return static_cast<int>(cudaGetLastError());
}
