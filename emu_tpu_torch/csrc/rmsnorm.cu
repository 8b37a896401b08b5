// Kernel C: residual add + RMSNorm forward over bf16 rows,
//   y = x + r  (bf16),  rsigma = rsqrt(mean(y^2) + eps),
//   h = bf16(y * rsigma * w)   (reduction and scale multiply in fp32),
// with a no-add form (r == null: y is x and is not written).
//
// Replaces the TPU kernel emu_tpu/ops/fused_norm.py:_norm_call (the
// add_rmsnorm / rms_norm_fused forward that every LLaMA layer runs twice,
// in prefill, decode and training).
//
// What bounds it on an H100: bytes. A row of W = 5120 reads 2 (or 1) bf16
// rows and writes 2 (or 1); there is no matrix product. The forward moves
// exactly those bytes: a thread holds its share of the row in registers,
// loaded as 16-byte vectors (up to VMAX of them), the threads of a row
// (a power of two from 32 to 256, the fewest that hold the row) reduce
// the sum of squares through shuffles and one shared-memory step, and y
// and h leave as 16-byte stores (w is read after the reduction). A
// 256-thread block holds several rows where the rows are short (W = 4096:
// 64 threads and 4 rows a block; 5120 and 6656: 128 threads and 2 rows),
// so a 640-row prefill slab runs as 320 blocks across the card. w is read
// in its stored dtype (bf16 or fp32) and used in fp32, as the TPU kernel
// reads it. A width that is not a multiple of 8, a base that is not
// 16-byte aligned or a row longer than 8 * VMAX * 256 takes a scalar
// kernel (one block a row, two passes over x and r). At decode (5-8 rows)
// the kernel is a launch and two round trips; its event time there is the
// wrapper's host work (ops/fused_norm.py keeps that to the launch's needs).
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
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int VMAX = 8;  // 16-byte vectors a thread holds in the row kernel

__device__ __forceinline__ float load_w(const __nv_bfloat16* w, int i) {
  return __bfloat162float(w[i]);
}
__device__ __forceinline__ float load_w(const float* w, int i) { return w[i]; }

// Eight consecutive weights from w + i (i a multiple of 8), as fp32.
__device__ __forceinline__ void load_w8(const __nv_bfloat16* w, int i, float (&f)[8]) {
  const uint4 v = __ldg(reinterpret_cast<const uint4*>(w + i));
  const __nv_bfloat162* p = reinterpret_cast<const __nv_bfloat162*>(&v);
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const float2 e = __bfloat1622float2(p[k]);
    f[2 * k] = e.x;
    f[2 * k + 1] = e.y;
  }
}
__device__ __forceinline__ void load_w8(const float* w, int i, float (&f)[8]) {
  const float4 a = __ldg(reinterpret_cast<const float4*>(w + i));
  const float4 b = __ldg(reinterpret_cast<const float4*>(w + i + 4));
  f[0] = a.x; f[1] = a.y; f[2] = a.z; f[3] = a.w;
  f[4] = b.x; f[5] = b.y; f[6] = b.z; f[7] = b.w;
}

// The row kernel: THREADS / tpr rows a block, tpr threads a row, each
// thread holding the row's vectors tid, tid + tpr, ... in registers. w is
// read after the reduction: holding it beside the row too (one round trip
// instead of two) cost registers and occupancy, and measured slower at
// 640 rows (PERF.md §6, row 11).
template <typename WT>
__global__ void __launch_bounds__(THREADS) add_rmsnorm_rows_kernel(
    const __nv_bfloat16* __restrict__ x, const __nv_bfloat16* __restrict__ r,
    const WT* __restrict__ w, __nv_bfloat16* __restrict__ y,
    __nv_bfloat16* __restrict__ h, float* __restrict__ rsigma, int M, int W,
    int tpr, float eps) {
  __shared__ float partial[THREADS / 32];
  const int nv = W / 8;
  const int rib = threadIdx.x / tpr, tid = threadIdx.x % tpr;
  const int row = blockIdx.x * (THREADS / tpr) + rib;
  const bool live = row < M;
  const long long base = static_cast<long long>(row) * W;
  uint4 yv[VMAX];
  float ss = 0.f;
#pragma unroll
  for (int v = 0; v < VMAX; ++v) {
    const int c = v * tpr + tid;
    if (live && c < nv) {
      uint4 a = *reinterpret_cast<const uint4*>(x + base + c * 8);
      __nv_bfloat162* ap = reinterpret_cast<__nv_bfloat162*>(&a);
      if (r != nullptr) {
        // fp32 sum rounded once to bf16, as the plain add on the card
        const uint4 b = *reinterpret_cast<const uint4*>(r + base + c * 8);
        const __nv_bfloat162* bp = reinterpret_cast<const __nv_bfloat162*>(&b);
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          const float2 fa = __bfloat1622float2(ap[k]), fb = __bfloat1622float2(bp[k]);
          ap[k] = __floats2bfloat162_rn(fa.x + fb.x, fa.y + fb.y);
        }
        *reinterpret_cast<uint4*>(y + base + c * 8) = a;
      }
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const float2 f = __bfloat1622float2(ap[k]);
        ss += f.x * f.x + f.y * f.y;
      }
      yv[v] = a;
    }
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) ss += __shfl_xor_sync(0xffffffffu, ss, o);
  const int wpr = tpr / 32;  // warps a row
  if (wpr > 1) {
    if (threadIdx.x % 32 == 0) partial[threadIdx.x / 32] = ss;
    __syncthreads();
    ss = 0.f;
    for (int i = 0; i < wpr; ++i) ss += partial[rib * wpr + i];
  }
  if (!live) return;
  const float rs = rsqrtf(ss / W + eps);
#pragma unroll
  for (int v = 0; v < VMAX; ++v) {
    const int c = v * tpr + tid;
    if (c < nv) {
      float wf[8];
      load_w8(w, c * 8, wf);
      const __nv_bfloat162* ap = reinterpret_cast<const __nv_bfloat162*>(&yv[v]);
      uint4 out;
      __nv_bfloat162* op = reinterpret_cast<__nv_bfloat162*>(&out);
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const float2 f = __bfloat1622float2(ap[k]);
        op[k] = __floats2bfloat162_rn(f.x * rs * wf[2 * k], f.y * rs * wf[2 * k + 1]);
      }
      *reinterpret_cast<uint4*>(h + base + c * 8) = out;
    }
  }
  if (tid == 0) rsigma[row] = rs;
}

// The scalar kernel: one block a row, any W and alignment.
template <typename WT>
__global__ void __launch_bounds__(THREADS) add_rmsnorm_any_kernel(
    const __nv_bfloat16* __restrict__ x, const __nv_bfloat16* __restrict__ r,
    const WT* __restrict__ w, __nv_bfloat16* __restrict__ y,
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
    h[base + i] = __float2bfloat16(f * rs * load_w(w, i));
  }
  if (threadIdx.x == 0) rsigma[blockIdx.x] = rs;
}

template <typename WT>
cudaError_t launch_fwd(const void* x, const void* r, const void* w, void* y, void* h,
                       void* rsigma, int M, int W, float eps, cudaStream_t st) {
  const auto* xp = static_cast<const __nv_bfloat16*>(x);
  const auto* rp = static_cast<const __nv_bfloat16*>(r);
  const auto* wp = static_cast<const WT*>(w);
  auto* yp = static_cast<__nv_bfloat16*>(y);
  auto* hp = static_cast<__nv_bfloat16*>(h);
  auto* sp = static_cast<float*>(rsigma);
  const auto a16 = [](const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; };
  if (W % 8 == 0 && W <= 8 * VMAX * THREADS && a16(x) && a16(r) && a16(w) && a16(y) &&
      a16(h)) {
    int tpr = 32;
    while (tpr * VMAX * 8 < W) tpr *= 2;
    const int rows = THREADS / tpr;
    add_rmsnorm_rows_kernel<WT><<<(M + rows - 1) / rows, THREADS, 0, st>>>(
        xp, rp, wp, yp, hp, sp, M, W, tpr, eps);
  } else {
    add_rmsnorm_any_kernel<WT><<<M, THREADS, 0, st>>>(xp, rp, wp, yp, hp, sp, W, eps);
  }
  return cudaGetLastError();
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

// x, r (or null), y (null without r), h: [M, W] bf16 rows; w: [W], fp32
// when w_fp32 else bf16; rsigma: [M] fp32. Launches on `stream`; returns
// cudaGetLastError().
extern "C" int emu_add_rmsnorm_fwd(const void* x, const void* r, const void* w,
                                   void* y, void* h, void* rsigma, int M, int W,
                                   int w_fp32, float eps, void* stream) {
  if (M == 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return static_cast<int>(w_fp32 ? launch_fwd<float>(x, r, w, y, h, rsigma, M, W, eps, st)
                                 : launch_fwd<__nv_bfloat16>(x, r, w, y, h, rsigma, M, W, eps, st));
}
