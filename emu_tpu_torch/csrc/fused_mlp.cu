// Kernel B: the ViT MLP residual branch with its hidden activation kept on
// chip, out = x + fc2(gelu(fc1(LN(x))))  (pre-LN optional, residual optional)
// bf16 in and out, fp32 LayerNorm, fp32 accumulation, exact erf GELU.
//
// Replaces the TPU kernel emu_tpu/ops/fused_mlp.py:fused_mlp in its GELU
// forms: pre-LN + residual (every Emu1 ViT-g block) and post-LN + residual
// (every bf16 Emu2 EVA-4B block: x + LN(fc2(gelu(fc1(x))))). SwiGLU is not
// built here yet. Post-LN needs the whole output row: the main kernel runs
// without a norm, and a row epilogue (rows_epilogue_kernel, int8_mma.cuh)
// sums the splits in split order, adds b2, normalises in fp32 over N and
// adds the residual.
//
// What bounds it on an H100: at ViT-g (M = B*257 rows, K = N = 1408,
// F = 6144) the two products are 2*M*K*F*2 FLOPs. The point of fusing is
// that the [M, F] hidden activation (4.4x the width of x) never reaches
// device memory. The TPU kept a [bm, N] fp32 accumulator in 16 MB of VMEM;
// a Hopper block has 227 KB of shared memory and 64K registers, so this
// design keeps a SMALL ROW TILE: 16 rows per block, the whole [16, N] fp32
// accumulator held in registers as WMMA fragments (8 warps, each owning
// N/128 column tiles), the normalised [16, K] input in shared memory, and
// the hidden dim walked 128 columns at a time (fc1 tile -> bias + GELU in
// fp32 -> bf16 tile in shared memory -> accumulated into fc2).
//
// With 16 rows a block does little arithmetic per weight byte, so the
// kernel is bound by how fast weights reach the SM: they stream through a
// 3-slot shared-memory ring filled with coalesced 16-byte cp.async copies,
// two chunks in flight while the tensor cores work on the third (2 slots,
// one in flight, where three [16, N] w2 chunks do not fit beside the
// [16, K] row tile: EVA-4B's K = N = 1792). The
// chunk sequence per 128-wide hidden step is ceil(K/128) chunks of w1
// ([128 k-rows, 128 hidden cols]) then 8 chunks of w2 ([16 hidden rows,
// N cols]).
//
// Few rows (one image: M = 257, 17 row tiles) would leave most SMs idle
// with each block walking the whole hidden dim, so the hidden dim is also
// split across blocks (grid = row tiles x F-splits, about two blocks per
// SM): each split stores its fp32 partial [16, N] into its own slice of a
// [splits, M, N] workspace with plain stores, and a second small kernel
// sums the splits in a fixed order, adds b2 and the residual and casts.
// No atomics, so the output is the same bits on every run. Every row tile
// still reads both weight matrices from L2; sharing weight tiles across
// row tiles (clusters/TMA multicast) and wgmma are the next steps.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <mma.h>
#include <math.h>

#include "int8_mma.cuh"

using namespace nvcuda;

namespace {

constexpr int BM = 16;       // rows per block
constexpr int BF = 128;      // hidden columns per step: one 16-wide tile per warp
constexpr int WARPS = 8;
constexpr int THREADS = WARPS * 32;
constexpr int MAX_NT = 14;   // output tiles per warp: N <= 8 * 14 * 16 = 1792
constexpr int LDSCR = 20;    // fp32 scratch row stride
constexpr int R1 = 128;      // w1 rows (of K) per chunk
constexpr int R2 = 16;       // w2 rows (of F) per chunk
constexpr int NK2 = BF / R2; // w2 chunks per hidden step
constexpr int MAX_SMEM = 232448;  // bytes of shared memory a block may use

struct MlpLayout {
  int ldx, ldh, ld1, ld2;
  size_t x_off, h_off, scr_off, ring_off, slot_bytes, total;
};

__host__ __device__ inline size_t round128(size_t v) { return (v + 127) / 128 * 128; }

// slots: weight-ring depth, 3 (two chunks in flight) or, where three
// [16, N] w2 chunks do not fit (EVA-4B's N = 1792), 2.
__host__ __device__ inline MlpLayout mlp_layout(int K, int N, int slots) {
  MlpLayout L;
  L.ldx = K + 8;
  L.ldh = BF + 8;
  L.ld1 = BF + 8;
  L.ld2 = N + 8;
  size_t off = 0;
  L.x_off = off; off += round128(sizeof(__nv_bfloat16) * BM * L.ldx);
  L.h_off = off; off += round128(sizeof(__nv_bfloat16) * BM * L.ldh);
  L.scr_off = off; off += round128(sizeof(float) * WARPS * 16 * LDSCR);
  const size_t s1 = sizeof(__nv_bfloat16) * R1 * L.ld1;
  const size_t s2 = sizeof(__nv_bfloat16) * R2 * L.ld2;
  L.slot_bytes = round128(s1 > s2 ? s1 : s2);
  L.ring_off = off; off += slots * L.slot_bytes;
  L.total = off;
  return L;
}

__device__ inline float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// 16-byte async copy global -> shared; src_bytes == 0 zero-fills.
__device__ inline void cp_async16(void* dst, const void* src, int src_bytes) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d),
               "l"(src), "r"(src_bytes));
}
__device__ inline void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
template <int N>
__device__ inline void cp_async_wait() { asm volatile("cp.async.wait_group %0;\n" ::"n"(N)); }

template <int SLOTS>
__global__ void __launch_bounds__(THREADS) fused_mlp_kernel(
    const __nv_bfloat16* __restrict__ x, const __nv_bfloat16* __restrict__ ln_s,
    const __nv_bfloat16* __restrict__ ln_b, const __nv_bfloat16* __restrict__ w1,
    const __nv_bfloat16* __restrict__ b1, const __nv_bfloat16* __restrict__ w2,
    float* __restrict__ ws, int M, int K, int F, int N, float eps,
    int steps_per_split) {
  extern __shared__ __align__(128) unsigned char smem[];
  const MlpLayout L = mlp_layout(K, N, SLOTS);
  __nv_bfloat16* xs = reinterpret_cast<__nv_bfloat16*>(smem + L.x_off);
  __nv_bfloat16* hs = reinterpret_cast<__nv_bfloat16*>(smem + L.h_off);
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  float* scr = reinterpret_cast<float*>(smem + L.scr_off) + warp * 16 * LDSCR;
  const int m0 = blockIdx.x * BM;

  const int nk1 = (K + R1 - 1) / R1;
  const int per_step = nk1 + NK2;
  // this block's hidden steps: [step0, step0 + n_steps) of 128 columns
  const int step0 = blockIdx.y * steps_per_split;
  const int n_steps = min(steps_per_split, (F + BF - 1) / BF - step0);
  const int n_chunks = n_steps * per_step;

  // Chunk q of the weight stream into ring slot q % SLOTS.
  auto issue = [&](int q) {
    if (q < n_chunks) {
      __nv_bfloat16* slot =
          reinterpret_cast<__nv_bfloat16*>(smem + L.ring_off + (q % SLOTS) * L.slot_bytes);
      const int f0 = (step0 + q / per_step) * BF;
      const int r = q % per_step;
      if (r < nk1) {          // w1[k0:k0+R1, f0:f0+BF]
        const int k0 = r * R1;
        for (int v = threadIdx.x; v < R1 * (BF / 8); v += THREADS) {
          const int row = v / (BF / 8);
          const int col = (v % (BF / 8)) * 8;
          const bool ok = k0 + row < K && f0 + col < F;
          cp_async16(slot + row * L.ld1 + col,
                     ok ? w1 + static_cast<long long>(k0 + row) * F + f0 + col : w1,
                     ok ? 16 : 0);
        }
      } else {                // w2[fr:fr+R2, 0:N]
        const int fr = f0 + (r - nk1) * R2;
        for (int v = threadIdx.x; v < R2 * (N / 8); v += THREADS) {
          const int row = v / (N / 8);
          const int col = (v % (N / 8)) * 8;
          const bool ok = fr + row < F;
          cp_async16(slot + row * L.ld2 + col,
                     ok ? w2 + static_cast<long long>(fr + row) * N + col : w2,
                     ok ? 16 : 0);
        }
      }
    }
    cp_async_commit();        // an empty group past the end keeps the count
  };

  for (int q = 0; q < SLOTS - 1; ++q) issue(q);

  // the row tile, LayerNorm'd in fp32 (two-pass mean/variance), as bf16
  for (int r = warp; r < BM; r += WARPS) {
    const int gr = m0 + r;
    __nv_bfloat16* dst = xs + r * L.ldx;
    if (gr >= M) {
      for (int c = lane; c < K; c += 32) dst[c] = __float2bfloat16(0.f);
      continue;
    }
    const __nv_bfloat16* src = x + static_cast<long long>(gr) * K;
    if (ln_s == nullptr) {
      for (int c = lane; c < K; c += 32) dst[c] = src[c];
      continue;
    }
    float s = 0.f;
    for (int c = lane; c < K; c += 32) s += __bfloat162float(src[c]);
    const float mean = warp_sum(s) / K;
    float v = 0.f;
    for (int c = lane; c < K; c += 32) {
      const float d = __bfloat162float(src[c]) - mean;
      v += d * d;
    }
    const float rstd = rsqrtf(warp_sum(v) / K + eps);
    for (int c = lane; c < K; c += 32) {
      const float y = (__bfloat162float(src[c]) - mean) * rstd;
      dst[c] = __float2bfloat16(y * __bfloat162float(ln_s[c]) + __bfloat162float(ln_b[c]));
    }
  }

  // this warp's output column tiles: warp, warp + 8, warp + 16, ...
  const int n_tiles = N / 16;
  const int nt = (n_tiles - warp + WARPS - 1) / WARPS;
  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[MAX_NT];
#pragma unroll
  for (int t = 0; t < MAX_NT; ++t) wmma::fill_fragment(acc[t], 0.f);
  wmma::fragment<wmma::accumulator, 16, 16, 16, float> hf;

  for (int q = 0; q < n_chunks; ++q) {
    cp_async_wait<SLOTS - 2>();   // chunk q has landed (this thread's part)
    __syncthreads();              // ... everyone's; slot (q-1) % 3 is free
    issue(q + SLOTS - 1);
    const __nv_bfloat16* slot =
        reinterpret_cast<const __nv_bfloat16*>(smem + L.ring_off + (q % SLOTS) * L.slot_bytes);
    const int f0 = (step0 + q / per_step) * BF;
    const int r = q % per_step;
    if (r < nk1) {
      // fc1: this warp's [16, 16] hidden tile over rows k0.. of K
      if (r == 0) wmma::fill_fragment(hf, 0.f);
      const int k0 = r * R1;
      const int ksteps = min(R1, K - k0) / 16;
      for (int kk = 0; kk < ksteps; ++kk) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::row_major> fa;
        wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::row_major> fb;
        wmma::load_matrix_sync(fa, xs + k0 + kk * 16, L.ldx);
        wmma::load_matrix_sync(fb, slot + kk * 16 * L.ld1 + warp * 16, L.ld1);
        wmma::mma_sync(hf, fa, fb, hf);
      }
      if (r == nk1 - 1) {
        // + b1 -> GELU -> bf16 hidden tile (read by every warp after the
        // next __syncthreads)
        const int fc = f0 + warp * 16;
        wmma::store_matrix_sync(scr, hf, LDSCR, wmma::mem_row_major);
        __syncwarp();
        for (int e = lane; e < 256; e += 32) {
          const int rr = e / 16;
          const int c = e % 16;
          float hv = 0.f;
          if (fc < F) {
            hv = scr[rr * LDSCR + c];
            if (b1 != nullptr) hv += __bfloat162float(b1[fc + c]);
            hv = 0.5f * hv * (1.f + erff(hv * 0.70710678118654752f));
          }
          hs[rr * L.ldh + warp * 16 + c] = __float2bfloat16(hv);
        }
      }
    } else {
      // fc2: acc[16, N] += hidden[:, j*16:(j+1)*16] @ w2 chunk [16, N]
      const int j = r - nk1;
      wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::row_major> fa;
      wmma::load_matrix_sync(fa, hs + j * 16, L.ldh);
#pragma unroll
      for (int t = 0; t < MAX_NT; ++t) {
        if (t < nt) {
          wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::row_major> fb;
          wmma::load_matrix_sync(fb, slot + (warp + t * WARPS) * 16, L.ld2);
          wmma::mma_sync(acc[t], fa, fb, acc[t]);
        }
      }
    }
  }
  cp_async_wait<0>();

  // this split's fc2 partial sums into its own [M, N] slice of the workspace
  float* part = ws + static_cast<long long>(blockIdx.y) * M * N;
#pragma unroll
  for (int t = 0; t < MAX_NT; ++t) {
    if (t < nt) {
      const int n0 = (warp + t * WARPS) * 16;
      wmma::store_matrix_sync(scr, acc[t], LDSCR, wmma::mem_row_major);
      __syncwarp();
      for (int e = lane; e < 256; e += 32) {
        const int rr = e / 16;
        const int c = e % 16;
        const int gr = m0 + rr;
        if (gr < M) part[static_cast<long long>(gr) * N + n0 + c] = scr[rr * LDSCR + c];
      }
      __syncwarp();
    }
  }
}

// out = bf16(sum of the split slices of ws, in split order, + b2 [+ x])
// over [M, N] (residual needs N == K).
__global__ void mlp_epilogue_kernel(const float* __restrict__ ws,
                                    const __nv_bfloat16* __restrict__ b2,
                                    const __nv_bfloat16* __restrict__ x,
                                    __nv_bfloat16* __restrict__ out,
                                    long long total, int N, int splits,
                                    int residual) {
  for (long long i = blockIdx.x * static_cast<long long>(blockDim.x) + threadIdx.x;
       i < total; i += static_cast<long long>(gridDim.x) * blockDim.x) {
    float y = ws[i];
    for (int sp = 1; sp < splits; ++sp) y += ws[sp * total + i];
    if (b2 != nullptr) y += __bfloat162float(b2[i % N]);
    if (residual) y += __bfloat162float(x[i]);
    out[i] = __float2bfloat16(y);
  }
}

}  // namespace

// The number of hidden-dim splits for M rows and hidden width F: about two
// blocks per SM, every split at least one 128-wide hidden step. The caller
// sizes the workspace of emu_fused_mlp_fwd with it.
extern "C" int emu_fused_mlp_splits(int M, int F) {
  int device = 0, sms = 0;
  cudaGetDevice(&device);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  const int row_tiles = (M + BM - 1) / BM;
  const int n_steps = (F + BF - 1) / BF;
  int splits = (2 * sms + row_tiles - 1) / row_tiles;
  splits = splits < 1 ? 1 : (splits > n_steps ? n_steps : splits);
  const int steps_per_split = (n_steps + splits - 1) / splits;
  return (n_steps + steps_per_split - 1) / steps_per_split;
}

// ws: an fp32 [splits, M, N] workspace that the caller allocates (no
// zeroing needed: every element is stored once); splits as
// emu_fused_mlp_splits(M, F) returns it.
// ln_post: ln_s/ln_b normalise the output (post-LN) instead of the input.
extern "C" int emu_fused_mlp_fwd(const void* x, const void* ln_s, const void* ln_b,
                                 const void* w1, const void* b1, const void* w2,
                                 const void* b2, void* ws, void* out, int M, int K,
                                 int F, int N, int splits, float eps, int residual,
                                 int ln_post, void* stream) {
  const bool deep = mlp_layout(K, N, 3).total <= MAX_SMEM;
  const MlpLayout L = mlp_layout(K, N, deep ? 3 : 2);
  auto kern = deep ? fused_mlp_kernel<3> : fused_mlp_kernel<2>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(L.total));
  if (err != cudaSuccess) return static_cast<int>(err);
  const int row_tiles = (M + BM - 1) / BM;
  const int n_steps = (F + BF - 1) / BF;
  const int steps_per_split = (n_steps + splits - 1) / splits;
  // every split must own at least one step, or its slice stays unwritten
  if (splits < 1 || (splits - 1) * steps_per_split >= n_steps)
    return static_cast<int>(cudaErrorInvalidValue);
  int device = 0, sms = 0;
  cudaGetDevice(&device);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const __nv_bfloat16* lns = static_cast<const __nv_bfloat16*>(ln_s);
  const __nv_bfloat16* lnb = static_cast<const __nv_bfloat16*>(ln_b);
  kern<<<dim3(row_tiles, splits), THREADS, L.total, s>>>(
      static_cast<const __nv_bfloat16*>(x), ln_post ? nullptr : lns,
      lnb, static_cast<const __nv_bfloat16*>(w1),
      static_cast<const __nv_bfloat16*>(b1), static_cast<const __nv_bfloat16*>(w2),
      static_cast<float*>(ws), M, K, F, N, eps, steps_per_split);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  if (ln_post) {
    rows_epilogue_kernel<<<M, 256, 0, s>>>(
        static_cast<const float*>(ws), splits, M, N, static_cast<const __nv_bfloat16*>(b2),
        lns, lnb, eps, residual ? static_cast<const __nv_bfloat16*>(x) : nullptr,
        static_cast<__nv_bfloat16*>(out));
    return static_cast<int>(cudaGetLastError());
  }
  const long long total = static_cast<long long>(M) * N;
  const int blocks = static_cast<int>((total + 255) / 256 < 4 * sms ? (total + 255) / 256 : 4 * sms);
  mlp_epilogue_kernel<<<blocks, 256, 0, s>>>(
      static_cast<const float*>(ws), static_cast<const __nv_bfloat16*>(b2),
      static_cast<const __nv_bfloat16*>(x), static_cast<__nv_bfloat16*>(out),
      total, N, splits, residual);
  return static_cast<int>(cudaGetLastError());
}
