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
// kernel (one block a row, two passes over x and r). The host chooses
// (ops/fused_norm.py:row_tpr, for the forward and the backward alike) and
// passes the threads a row (0: the scalar kernel); a row plan the kernel
// cannot hold is refused, never rerouted. At decode (5-8 rows)
// the kernel is a launch and two round trips; its event time there is the
// wrapper's host work (ops/fused_norm.py keeps that to the launch's needs).
//
// The backward (emu_add_rmsnorm_bwd) replaces the TPU kernel
// emu_tpu/ops/fused_norm.py:_norm_bwd_call (_bwd_kernel). With g = dh * w,
// all in fp32 over the bf16 rows:
//   dx_i = g_i * rsigma - y_i * rsigma^3 * mean_j(g_j y_j) + dy_ext_i
//   dw_i = sum over rows of dh_i * y_i * rsigma
// (dy_ext, the cotangent of the residual stream y, only in the add form).
// Bytes bound it too: it reads y, dh and dy_ext and writes dx. Its row
// kernel is a persistent grid of at most one 256-thread block an SM, each
// walking a contiguous run of rows a step (256 / tpr rows) at a time, with
// the forward's threads a row. Thread 0 streams each step's rows of y, dh
// and dy_ext (one contiguous run of each) into a 2-step ring by
// cp.async.bulk, so the next step is in flight while this one reduces; a
// thread holds its vectors of the step's row in registers from one 16-byte
// shared load each, reduces mean(g.y) through shuffles and one shared step,
// and writes dx as 16-byte stores: one pass over each row. Its columns are
// the same on every row, so its w (read once, as stored) and its dw sums
// stay in registers for the whole run; the block's rows' sums meet in
// shared memory as its one fp32 partial row. A second kernel adds the
// partial rows in block order, so dw is the same bits on every run (no
// atomics), and rounds them once to w's dtype. The plan is the host's
// (ops/fused_norm.py:norm_bwd_plan); where the forward takes its scalar
// kernel, so does the backward (one row at a time, two passes, the dw
// sums in shared memory).

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

#include "hopper.cuh"

namespace {

constexpr int THREADS = 256;
constexpr int VMAX = 8;  // 16-byte vectors a thread holds in the row kernel

__device__ __forceinline__ float load_w(const __nv_bfloat16* w, int i) {
  return __bfloat162float(w[i]);
}
__device__ __forceinline__ float load_w(const float* w, int i) { return w[i]; }

// Whether tpr threads a row hold a row of W in at most VMAX 16-byte
// vectors each: the row kernels' plan (the host's row_tpr gives it).
bool row_plan_ok(int W, int tpr) {
  return W % 8 == 0 && tpr >= 32 && tpr <= THREADS && !(tpr & (tpr - 1)) &&
         (W / 8 + tpr - 1) / tpr <= VMAX;
}

bool aligned16(const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; }

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
                       void* rsigma, int M, int W, int tpr, float eps, cudaStream_t st) {
  const auto* xp = static_cast<const __nv_bfloat16*>(x);
  const auto* rp = static_cast<const __nv_bfloat16*>(r);
  const auto* wp = static_cast<const WT*>(w);
  auto* yp = static_cast<__nv_bfloat16*>(y);
  auto* hp = static_cast<__nv_bfloat16*>(h);
  auto* sp = static_cast<float*>(rsigma);
  if (tpr == 0) {
    add_rmsnorm_any_kernel<WT><<<M, THREADS, 0, st>>>(xp, rp, wp, yp, hp, sp, W, eps);
    return cudaGetLastError();
  }
  if (!row_plan_ok(W, tpr) || !aligned16(x) || !aligned16(r) || !aligned16(w) ||
      !aligned16(y) || !aligned16(h))
    return cudaErrorInvalidValue;
  const int rows = THREADS / tpr;
  add_rmsnorm_rows_kernel<WT><<<(M + rows - 1) / rows, THREADS, 0, st>>>(
      xp, rp, wp, yp, hp, sp, M, W, tpr, eps);
  return cudaGetLastError();
}

// ---- the backward --------------------------------------------------------

// The backward row kernel's ring depth in steps: 3 measured 4% slower at
// 2048 x 5120 and 4 do not fit one block at W = 5120 (PERF.md, PR 12).
constexpr int BWD_STAGES = 2;

// The eight bf16 of a 16-byte unit as floats.
__device__ __forceinline__ void unpack8(const uint4& u, float (&f)[8]) {
  const __nv_bfloat162* p = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const float2 e = __bfloat1622float2(p[k]);
    f[2 * k] = e.x;
    f[2 * k + 1] = e.y;
  }
}

// The row kernel: a persistent grid, each block walking a contiguous run of
// rows in steps of THREADS / tpr rows, tpr threads a row, each thread
// holding the row's vectors tid, tid + tpr, ... (NV of them at most). A
// thread's columns are the same on every row, so its w (fp32, read once)
// and its dw sums stay in registers for the whole run. Thread 0 streams
// each step's rows of y, dh and dy_ext (one contiguous run each) into a
// BWD_STAGES-deep ring by cp.async.bulk, so the next step is in flight
// while this one reduces. (Loading the next step into registers instead
// measured as fast at W = 5120 and spilled at 6656: PERF.md, PR 12.)
template <typename WT, int NV>
__global__ void __launch_bounds__(THREADS, 1) add_rmsnorm_bwd_rows_kernel(
    const __nv_bfloat16* __restrict__ y, const WT* __restrict__ w,
    const float* __restrict__ rsigma, const __nv_bfloat16* __restrict__ dh,
    const __nv_bfloat16* __restrict__ dy_ext, __nv_bfloat16* __restrict__ dx,
    float* __restrict__ dw_part, int M, int W, int tpr, int rows_per_block) {
  // [BWD_STAGES][y, dh, dy][step rows][W] from the first 128-byte line of
  // the dynamic shared memory: a ring that started 16 bytes into a line
  // (after 48 bytes of static shared memory) measured 10% slower (PERF.md,
  // PR 12)
  extern __shared__ __align__(16) unsigned char ring_raw[];
  unsigned char* ring = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(ring_raw) + 127) & ~static_cast<uintptr_t>(127));
  __shared__ uint64_t full[BWD_STAGES];
  __shared__ float partial[THREADS / 32];
  const int nv = W / 8, step = THREADS / tpr, wpr = tpr / 32;
  const int rib = threadIdx.x / tpr, tid = threadIdx.x % tpr;
  const int r0 = blockIdx.x * rows_per_block;
  const int r1 = min(M, r0 + rows_per_block);
  const int steps = (r1 - r0 + step - 1) / step;
  const bool add = dy_ext != nullptr;
  const uint32_t run = static_cast<uint32_t>(step) * W * 2;   // a slot's bytes

  auto issue = [&](int k) {   // thread 0: step k's rows into stage k % BWD_STAGES
    const int s = k % BWD_STAGES, row = r0 + k * step;
    const uint32_t bytes = static_cast<uint32_t>(min(step, r1 - row)) * W * 2;
    unsigned char* st = ring + static_cast<size_t>(s) * 3 * run;
    const long long off = static_cast<long long>(row) * W;
    mbar_arrive_tx(&full[s], (add ? 3 : 2) * bytes);
    bulk_load(st, y + off, bytes, &full[s]);
    bulk_load(st + run, dh + off, bytes, &full[s]);
    if (add) bulk_load(st + 2 * run, dy_ext + off, bytes, &full[s]);
  };
  if (threadIdx.x == 0) {
    for (int s = 0; s < BWD_STAGES; ++s) mbar_init(&full[s], 1);
    mbar_fence_init();
    for (int k = 0; k < min(steps, BWD_STAGES); ++k) issue(k);
  }
  __syncthreads();

  float wf[NV][8], dw[NV][8];
#pragma unroll
  for (int v = 0; v < NV; ++v) {
    const int c = v * tpr + tid;
    if (c < nv) load_w8(w, c * 8, wf[v]);
#pragma unroll
    for (int e = 0; e < 8; ++e) dw[v][e] = 0.f;
  }

  for (int k = 0; k < steps; ++k) {
    const int row = r0 + k * step + rib;
    const bool live = row < r1;
    const float rs = live ? rsigma[row] : 0.f;
    const int s = k % BWD_STAGES;
    mbar_wait(&full[s], (k / BWD_STAGES) & 1);
    const unsigned char* st = ring + static_cast<size_t>(s) * 3 * run + rib * W * 2;
    uint4 yv[NV], dv[NV], ev[NV];
#pragma unroll
    for (int v = 0; v < NV; ++v) {
      const int c = v * tpr + tid;
      if (live && c < nv) {
        yv[v] = *reinterpret_cast<const uint4*>(st + c * 16);
        dv[v] = *reinterpret_cast<const uint4*>(st + run + c * 16);
        if (add) ev[v] = *reinterpret_cast<const uint4*>(st + 2 * run + c * 16);
      }
    }
    float dot = 0.f;
#pragma unroll
    for (int v = 0; v < NV; ++v) {
      const int c = v * tpr + tid;
      if (live && c < nv) {
        float yf[8], df[8];
        unpack8(yv[v], yf);
        unpack8(dv[v], df);
#pragma unroll
        for (int e = 0; e < 8; ++e) dot += df[e] * wf[v][e] * yf[e];
      }
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) dot += __shfl_xor_sync(0xffffffffu, dot, o);
    if (wpr > 1) {
      if (threadIdx.x % 32 == 0) partial[threadIdx.x / 32] = dot;
      __syncthreads();
      dot = 0.f;
      for (int i = 0; i < wpr; ++i) dot += partial[rib * wpr + i];
    }
    const float mean = dot / W, rs3 = rs * rs * rs;
    const long long base = static_cast<long long>(row) * W;
#pragma unroll
    for (int v = 0; v < NV; ++v) {
      const int c = v * tpr + tid;
      if (live && c < nv) {
        float yf[8], df[8], ef[8];
        unpack8(yv[v], yf);
        unpack8(dv[v], df);
        if (add) unpack8(ev[v], ef);
        uint4 out;
        __nv_bfloat162* op = reinterpret_cast<__nv_bfloat162*>(&out);
#pragma unroll
        for (int e = 0; e < 8; e += 2) {
          float a = df[e] * wf[v][e] * rs - yf[e] * rs3 * mean;
          float b = df[e + 1] * wf[v][e + 1] * rs - yf[e + 1] * rs3 * mean;
          if (add) {
            a += ef[e];
            b += ef[e + 1];
          }
          op[e / 2] = __floats2bfloat162_rn(a, b);
          dw[v][e] += df[e] * yf[e] * rs;
          dw[v][e + 1] += df[e + 1] * yf[e + 1] * rs;
        }
        *reinterpret_cast<uint4*>(dx + base + c * 8) = out;
      }
    }
    __syncthreads();   // stage s and `partial` are read out
    if (threadIdx.x == 0 && k + BWD_STAGES < steps) issue(k + BWD_STAGES);
  }

  // the block's partial row: the step's rows' sums added in row order
  // through shared memory (the ring is idle: every copy has landed)
  float* acc = reinterpret_cast<float*>(ring);   // [step][W]
#pragma unroll
  for (int v = 0; v < NV; ++v) {
    const int c = v * tpr + tid;
    if (c < nv) {
      float4* dst = reinterpret_cast<float4*>(acc + rib * W + c * 8);
      dst[0] = make_float4(dw[v][0], dw[v][1], dw[v][2], dw[v][3]);
      dst[1] = make_float4(dw[v][4], dw[v][5], dw[v][6], dw[v][7]);
    }
  }
  __syncthreads();
  for (int i = threadIdx.x; i < W; i += THREADS) {
    float s = 0.f;
    for (int r = 0; r < step; ++r) s += acc[r * W + i];
    dw_part[static_cast<long long>(blockIdx.x) * W + i] = s;
  }
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

// The scalar kernel: any W and alignment; one block a run of rows, one row
// at a time, two passes over it; each thread keeps the dw sums of its own
// columns in shared memory.
template <typename WT>
__global__ void __launch_bounds__(THREADS) add_rmsnorm_bwd_any_kernel(
    const __nv_bfloat16* __restrict__ y, const WT* __restrict__ w,
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
      dot += __bfloat162float(dh[base + i]) * load_w(w, i) * __bfloat162float(y[base + i]);
    const float mean = block_sum(dot, partial) / W;
    const float rs3 = rs * rs * rs;
    for (int i = threadIdx.x; i < W; i += THREADS) {
      const float yf = __bfloat162float(y[base + i]);
      const float d = __bfloat162float(dh[base + i]);
      float v = d * load_w(w, i) * rs - yf * rs3 * mean;
      if (dy_ext != nullptr) v += __bfloat162float(dy_ext[base + i]);
      dx[base + i] = __float2bfloat16(v);
      dw_acc[i] += d * yf * rs;
    }
  }
  for (int i = threadIdx.x; i < W; i += THREADS)
    dw_part[static_cast<long long>(blockIdx.x) * W + i] = dw_acc[i];
}

__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) { *p = __float2bfloat16(v); }

// dw = the partial rows summed in block order (the same bits on every run),
// in w's dtype; the loads of 16 partial rows in flight at a time.
template <typename WT>
__global__ void dw_reduce_kernel(const float* __restrict__ dw_part,
                                 WT* __restrict__ dw, int n_part, int W) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= W) return;
  float s = 0.f;
#pragma unroll 16
  for (int p = 0; p < n_part; ++p) s += dw_part[static_cast<long long>(p) * W + i];
  store(dw + i, s);
}

// Sets a kernel's dynamic shared-memory limit once it needs more than it
// had (per instantiation, once per process in practice).
template <typename K>
cudaError_t allow_smem(K kern, size_t bytes, size_t& configured) {
  if (bytes <= configured) return cudaSuccess;
  const cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(bytes));
  if (err == cudaSuccess) configured = bytes;
  return err;
}

template <typename WT, int NV>
cudaError_t launch_bwd_rows(const __nv_bfloat16* y, const WT* w, const float* rs,
                            const __nv_bfloat16* dh, const __nv_bfloat16* dy,
                            __nv_bfloat16* dx, float* part, int M, int W, int tpr,
                            int rows_per_block, int grid, cudaStream_t st) {
  static size_t configured = 0;
  const size_t bytes = static_cast<size_t>(BWD_STAGES) * 3 * (THREADS / tpr) * W * 2 + 128;
  const cudaError_t err = allow_smem(add_rmsnorm_bwd_rows_kernel<WT, NV>, bytes, configured);
  if (err != cudaSuccess) return err;
  add_rmsnorm_bwd_rows_kernel<WT, NV><<<grid, THREADS, bytes, st>>>(
      y, w, rs, dh, dy, dx, part, M, W, tpr, rows_per_block);
  return cudaGetLastError();
}

template <typename WT>
cudaError_t launch_bwd(const void* y, const void* w, const void* rsigma, const void* dh,
                       const void* dy, void* dx, void* part, int M, int W, int tpr,
                       int rows_per_block, int grid, cudaStream_t st) {
  const auto* yp = static_cast<const __nv_bfloat16*>(y);
  const auto* wp = static_cast<const WT*>(w);
  const auto* rp = static_cast<const float*>(rsigma);
  const auto* dp = static_cast<const __nv_bfloat16*>(dh);
  const auto* ep = static_cast<const __nv_bfloat16*>(dy);
  auto* xp = static_cast<__nv_bfloat16*>(dx);
  auto* pp = static_cast<float*>(part);
  if (tpr == 0) {
    static size_t configured = 0;
    const size_t bytes = static_cast<size_t>(W) * 4;
    const cudaError_t err = allow_smem(add_rmsnorm_bwd_any_kernel<WT>, bytes, configured);
    if (err != cudaSuccess) return err;
    add_rmsnorm_bwd_any_kernel<WT><<<grid, THREADS, bytes, st>>>(yp, wp, rp, dp, ep, xp, pp,
                                                                 M, W, rows_per_block);
    return cudaGetLastError();
  }
  if (!row_plan_ok(W, tpr) || !aligned16(y) || !aligned16(w) || !aligned16(dh) ||
      !aligned16(dy) || !aligned16(dx))
    return cudaErrorInvalidValue;   // the plan sends such calls to the scalar kernel
  const int nv = (W / 8 + tpr - 1) / tpr;
  switch (nv) {
    case 1: return launch_bwd_rows<WT, 1>(yp, wp, rp, dp, ep, xp, pp, M, W, tpr, rows_per_block, grid, st);
    case 2: return launch_bwd_rows<WT, 2>(yp, wp, rp, dp, ep, xp, pp, M, W, tpr, rows_per_block, grid, st);
    case 3: return launch_bwd_rows<WT, 3>(yp, wp, rp, dp, ep, xp, pp, M, W, tpr, rows_per_block, grid, st);
    case 4: return launch_bwd_rows<WT, 4>(yp, wp, rp, dp, ep, xp, pp, M, W, tpr, rows_per_block, grid, st);
    case 5: return launch_bwd_rows<WT, 5>(yp, wp, rp, dp, ep, xp, pp, M, W, tpr, rows_per_block, grid, st);
    case 6: return launch_bwd_rows<WT, 6>(yp, wp, rp, dp, ep, xp, pp, M, W, tpr, rows_per_block, grid, st);
    case 7: return launch_bwd_rows<WT, 7>(yp, wp, rp, dp, ep, xp, pp, M, W, tpr, rows_per_block, grid, st);
    default: return launch_bwd_rows<WT, 8>(yp, wp, rp, dp, ep, xp, pp, M, W, tpr, rows_per_block, grid, st);
  }
}

}  // namespace

// The backward over M rows of width W: y, dh, dy_ext (or null) [M, W] bf16;
// w and dw [W], fp32 when w_fp32 else bf16; rsigma [M] fp32; dx [M, W]
// bf16; dw_part [grid, W] fp32 (one partial row a block). The plan
// (ops/fused_norm.py:norm_bwd_plan): tpr threads a row (0: the scalar
// kernel), rows_per_block rows a block (whole steps of 256 / tpr rows),
// `grid` blocks. Launches on `stream`; returns
// cudaGetLastError().
extern "C" int emu_add_rmsnorm_bwd(const void* y, const void* w,
                                   const void* rsigma, const void* dh,
                                   const void* dy_ext, void* dx, void* dw_part,
                                   void* dw, int M, int W, int w_fp32, int tpr,
                                   int rows_per_block, int grid, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (M > 0) {
    const cudaError_t err =
        w_fp32 ? launch_bwd<float>(y, w, rsigma, dh, dy_ext, dx, dw_part, M, W, tpr,
                                   rows_per_block, grid, st)
               : launch_bwd<__nv_bfloat16>(y, w, rsigma, dh, dy_ext, dx, dw_part, M, W, tpr,
                                           rows_per_block, grid, st);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const auto* part = static_cast<const float*>(dw_part);
  const int n_part = M > 0 ? grid : 0, blocks = (W + 127) / 128;
  if (w_fp32)
    dw_reduce_kernel<<<blocks, 128, 0, st>>>(part, static_cast<float*>(dw), n_part, W);
  else
    dw_reduce_kernel<<<blocks, 128, 0, st>>>(part, static_cast<__nv_bfloat16*>(dw), n_part, W);
  return static_cast<int>(cudaGetLastError());
}

// x, r (or null), y (null without r), h: [M, W] bf16 rows; w: [W], fp32
// when w_fp32 else bf16; rsigma: [M] fp32; tpr the threads a row of the
// row kernel, 0 for the scalar kernel (ops/fused_norm.py:row_tpr).
// Launches on `stream`; returns cudaGetLastError().
extern "C" int emu_add_rmsnorm_fwd(const void* x, const void* r, const void* w,
                                   void* y, void* h, void* rsigma, int M, int W,
                                   int w_fp32, int tpr, float eps, void* stream) {
  if (M == 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return static_cast<int>(
      w_fp32 ? launch_fwd<float>(x, r, w, y, h, rsigma, M, W, tpr, eps, st)
             : launch_fwd<__nv_bfloat16>(x, r, w, y, h, rsigma, M, W, tpr, eps, st));
}
