// Kernel H: one dense layer with its epilogue,
//   out = bf16([LN(x) ->] x @ W + b [-> LN over the row] [+ residual])
// bf16 x [M, K] and W [K, N], products on the tensor cores with an fp32
// accumulator, bias, LayerNorm and residual in fp32, one rounding at the end.
//
// Replaces the TPU kernel emu_tpu/ops/fused_mlp.py:fused_dense
// (_make_dense_kernel). Its plain form carries every biased bf16 dense of
// the port (`ops/layers.dense`): the diffusion UNets' attention outputs,
// GEGLU and Transformer2D projections and time embeddings, the ViTs' proj and
// patch embedding, the Causal Former's projection. The JAX rule for such a
// dense is a bf16 product summed in fp32, the bias added to that sum, one
// rounding; the fp32 CUDA-core GEMM the port used for it ran at a fraction
// of the tensor cores' rate.
//
// What bounds it on an H100: at the UNets' shapes (M = 2048..8192 rows, K
// and N 640..10240) a GEMM does 2 M K N operations against 2 (M K + K N +
// M N) bytes, far above the ~295 operations per byte where the tensor
// cores, not the memory, are the limit; at decode-sized M (the time
// embedding's 2 rows) it reads W once and is bound by bytes.
//
// Two GEMM plans, chosen by shape on the host (`ops/fused_mlp.py:
// fused_dense_plan`, which the wrapper passes down; neither is a fallback
// for the other):
//
// - TMA (K and N multiples of 8, x and W 16-byte aligned, more than
//   DENSE_MMA_ROWS rows): dense_tma.cuh's GEMM with its plain epilogue
//   (kernel B's products are the same GEMM with activation epilogues):
//   128 x 128 output tiles, two consumer warpgroups of 64 rows each and a
//   producer warp keeping a 3-stage TMA ring, SS wgmma m64n128k16, one group in flight
//   while the next stage lands. At 96 KB of shared memory two blocks share
//   an SM, so one block's epilogue overlaps the other's products. Each
//   block walks all of K: on grids too short to fill the card (M of 32-578
//   rows) a split of K into fp32 partial sums took less card time but cost
//   the host a second launch and a workspace, and those calls wait on the
//   host (PERF.md section 6, kernel H).
// - mma.sync (the rest: the ViTs' patch embedding, K = 14 * 14 * 3 = 588;
//   ragged N; unaligned views): the first GEMM, block tiles of 128 x 128
//   output elements, 8 warps each owning 64 x 32 of it as 4 x 4 mma.sync
//   m16n8k16 tiles, K walked 32 at a time through a 3-stage cp.async ring,
//   operands fetched with ldmatrix (B transposed on the way). Rows of 40 and
//   136 bf16 keep the 8 addresses of each ldmatrix phase on distinct banks.
//   Ragged M, N and K edges are zero-filled on load and masked on store;
//   where K or N is not a multiple of 8 or a pointer is not 16-byte
//   aligned, the tiles are loaded element by element.
//
// Pre form (LN -> dense): a row pass first writes xn = bf16(LN(x)) in fp32
// arithmetic to a [M, K] workspace, the TPU kernel's `xn` scratch
// (fused_mlp.py:276-280), and the plain GEMM reads xn. Normalising each
// landed A tile inside the GEMM instead would redo it once per column block
// (40 times at the UNet's N = 5120) and stall the cp.async ring on it: that
// first version ran 3x slower than the plain form at the same operations.
// The workspace costs 4 bytes per element of x, about 6 us at 8192 x 640.
//
// Post form (dense -> LN): the LayerNorm needs the whole output row (N up
// to 1792 at EVA-4B). Holding [BM, N] fp32 in one block would shrink the
// row tile to ~16 rows (the accumulator of 16 x 1792 fills the register
// file) and every row tile would re-read all of W: 8200 rows of EVA-4B would
// read its 6.4 MB weight 513 times. Instead the GEMM keeps its 128 x 128
// tiles and writes y = x @ W + b in fp32 to an [M, N] workspace, and a
// second row pass (one block per row) normalises it, adds the residual and
// rounds: 8 bytes more per output element, about 35 us at EVA-4B's
// 8200 x 1792, against a GEMM of 53 us at the tensor cores' peak.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

#include "dense_tma.cuh"

namespace {

constexpr int BM = 128;            // output rows per block
constexpr int BN = 128;            // output columns per block
constexpr int BK = 32;             // K per stage
constexpr int STAGES = 3;
constexpr int WARPS = 8;           // 2 along M x 4 along N, 64 x 32 each
constexpr int THREADS = WARPS * 32;
constexpr int LDA = BK + 8;        // bf16 row stride of an A stage
constexpr int LDB = BN + 8;        // bf16 row stride of a B stage
constexpr int A_STAGE = BM * LDA;  // elements
constexpr int B_STAGE = BK * LDB;
constexpr int SMEM = static_cast<int>(sizeof(bf16)) * STAGES * (A_STAGE + B_STAGE);

// The mma.sync plan's copy as it was first written and measured: unlike
// hopper.cuh's cp_async16 it has no "memory" clobber (the ring's
// wait_group and __syncthreads order it).
__device__ inline void cp_async16_ring(void* dst, const void* src, int src_bytes) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d),
               "l"(src), "r"(src_bytes));
}
__device__ inline void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
template <int N>
__device__ inline void cp_async_wait() { asm volatile("cp.async.wait_group %0;\n" ::"n"(N)); }

__device__ inline void ldsm_x4(uint32_t (&r)[4], const bf16* p) {
  const unsigned a = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(a));
}
__device__ inline void ldsm_x4_trans(uint32_t (&r)[4], const bf16* p) {
  const unsigned a = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(a));
}
__device__ inline void mma_bf16(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// The A tile [BM, BK] at (m0, k0) and the B tile [BK, BN] at (k0, n0) into
// one stage. VEC: 16-byte cp.async copies (K and N multiples of 8, aligned
// pointers), the ragged edge zero-filled; else element by element.
template <bool VEC>
__device__ inline void load_stage(const DenseArgs& a, bf16* as, bf16* bs, int m0,
                                  int n0, int k0) {
  if (VEC) {
    for (int c = threadIdx.x; c < BM * BK / 8; c += THREADS) {
      const int r = c / (BK / 8), col = (c % (BK / 8)) * 8;
      const bool ok = m0 + r < a.M && k0 + col < a.K;
      cp_async16_ring(as + r * LDA + col,
                 ok ? a.x + static_cast<long long>(m0 + r) * a.K + k0 + col : a.x,
                 ok ? 16 : 0);
    }
    for (int c = threadIdx.x; c < BK * BN / 8; c += THREADS) {
      const int r = c / (BN / 8), col = (c % (BN / 8)) * 8;
      const bool ok = k0 + r < a.K && n0 + col < a.N;
      cp_async16_ring(bs + r * LDB + col,
                 ok ? a.w + static_cast<long long>(k0 + r) * a.N + n0 + col : a.w,
                 ok ? 16 : 0);
    }
  } else {
    const bf16 zero = __float2bfloat16(0.f);
    for (int e = threadIdx.x; e < BM * BK; e += THREADS) {
      const int r = e / BK, col = e % BK;
      const bool ok = m0 + r < a.M && k0 + col < a.K;
      as[r * LDA + col] = ok ? a.x[static_cast<long long>(m0 + r) * a.K + k0 + col] : zero;
    }
    for (int e = threadIdx.x; e < BK * BN; e += THREADS) {
      const int r = e / BN, col = e % BN;
      const bool ok = k0 + r < a.K && n0 + col < a.N;
      bs[r * LDB + col] = ok ? a.w[static_cast<long long>(k0 + r) * a.N + n0 + col] : zero;
    }
  }
}

template <bool VEC>
__global__ void __launch_bounds__(THREADS) dense_kernel(DenseArgs a) {
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* As = reinterpret_cast<bf16*>(smem);
  bf16* Bs = As + STAGES * A_STAGE;
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int wm = warp / 4, wn = warp % 4;   // this warp's 64 x 32 sub-tile
  const int nk = (a.K + BK - 1) / BK;

  auto fetch = [&](int kt) {
    if (kt < nk) {
      const int s = kt % STAGES;
      load_stage<VEC>(a, As + s * A_STAGE, Bs + s * B_STAGE, m0, n0, kt * BK);
    }
    cp_async_commit();      // an empty group past the end keeps the count
  };
  for (int kt = 0; kt < STAGES - 1; ++kt) fetch(kt);

  float acc[4][4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int u = 0; u < 4; ++u) acc[i][j][u] = 0.f;

  for (int kt = 0; kt < nk; ++kt) {
    cp_async_wait<STAGES - 2>();   // stage kt has landed (this thread's part)
    __syncthreads();               // ... everyone's; stage kt - 1 is free
    fetch(kt + STAGES - 1);
    const bf16* as = As + (kt % STAGES) * A_STAGE;
    const bf16* bs = Bs + (kt % STAGES) * B_STAGE;
#pragma unroll
    for (int kk = 0; kk < BK; kk += 16) {
      uint32_t af[4][4], bfr[4][2];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        ldsm_x4(af[i], as + (wm * 64 + i * 16 + lane % 16) * LDA + kk + (lane / 16) * 8);
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        uint32_t r[4];
        ldsm_x4_trans(r, bs + (kk + lane % 16) * LDB + wn * 32 + j * 16 + (lane / 16) * 8);
        bfr[2 * j][0] = r[0];
        bfr[2 * j][1] = r[1];
        bfr[2 * j + 1][0] = r[2];
        bfr[2 * j + 1][1] = r[3];
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) mma_bf16(acc[i][j], af[i], bfr[j][0], bfr[j][1]);
    }
  }
  cp_async_wait<0>();

  // accumulator (i, j): rows g and g + 8 of m16 tile i, columns 2t, 2t + 1
  // of n8 tile j (g = lane / 4, t = lane % 4)
  const int g = lane / 4, t = lane % 4;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = m0 + wm * 64 + i * 16 + g;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int col = n0 + wn * 32 + j * 8 + 2 * t;
      store_pair(a, row, col, acc[i][j][0], acc[i][j][1]);
      store_pair(a, row + 8, col, acc[i][j][2], acc[i][j][3]);
    }
  }
}

template <bool VEC>
cudaError_t launch_gemm(const DenseArgs& a, cudaStream_t s) {
  cudaError_t err = cudaFuncSetAttribute(dense_kernel<VEC>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM);
  if (err != cudaSuccess) return err;
  const dim3 grid((a.N + BN - 1) / BN, (a.M + BM - 1) / BM);
  dense_kernel<VEC><<<grid, THREADS, SMEM, s>>>(a);
  return cudaGetLastError();
}

}  // namespace

// x [M, K], w [K, N], res and out [M, N]: bf16, contiguous. bias [N] and
// the LayerNorm's ln_s, ln_b ([K] for mode 1, [N] for mode 2): bf16 when
// vec_bf16 is set, else fp32, read as they are and widened to fp32 in the
// kernel; bias and res may be null. mode 0: plain; 1: LayerNorm of x first
// (xn: a bf16 [M, K] workspace); 2: LayerNorm over each output row (ws: an
// fp32 [M, N] workspace). plan 0: the mma.sync GEMM; 1: the TMA GEMM (K, N
// multiples of 8, 16-byte aligned x or xn and w; refused otherwise).
// Launches on `stream`; returns cudaGetLastError().
extern "C" int emu_fused_dense_fwd(const void* x, const void* w, const void* bias,
                                   const void* ln_s, const void* ln_b, const void* res,
                                   void* xn, void* ws, void* out, int M, int K, int N,
                                   int mode, int vec_bf16, int plan, float eps, void* stream) {
  if (M <= 0 || K <= 0 || N <= 0 || mode < PLAIN || mode > POST
      || (mode != PLAIN && (ln_s == nullptr || ln_b == nullptr))
      || (mode == PRE && xn == nullptr) || (mode == POST && ws == nullptr)
      || plan < 0 || plan > 1)
    return static_cast<int>(cudaErrorInvalidValue);
  DenseArgs a;
  a.x = static_cast<const bf16*>(mode == PRE ? xn : x);
  a.w = static_cast<const bf16*>(w);
  a.bias = bias;
  a.bias_up = nullptr;
  a.ln_s = ln_s;
  a.ln_b = ln_b;
  a.vec_bf16 = vec_bf16 != 0;
  a.res = static_cast<const bf16*>(res);
  a.ws = static_cast<float*>(ws);
  a.out = static_cast<bf16*>(out);
  a.M = M; a.K = K; a.Kw = K; a.N = N; a.mode = mode;
  const bool vec = K % 8 == 0 && N % 8 == 0 && reinterpret_cast<uintptr_t>(a.x) % 16 == 0
                   && reinterpret_cast<uintptr_t>(w) % 16 == 0;
  if (plan == 1 && !vec) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (mode == PRE) {
    ln_rows_kernel<bf16><<<M, 256, 0, s>>>(static_cast<const bf16*>(x), a.ln_s, a.ln_b,
                                           a.vec_bf16, nullptr, static_cast<bf16*>(xn), K, eps);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  cudaError_t err = plan == 1 ? launch_tma<EPI_DENSE>(a, nullptr, s)
                    : vec     ? launch_gemm<true>(a, s)
                              : launch_gemm<false>(a, s);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (mode == POST) {
    ln_rows_kernel<float><<<M, 256, 0, s>>>(a.ws, a.ln_s, a.ln_b, a.vec_bf16, a.res, a.out,
                                            N, eps);
    return static_cast<int>(cudaGetLastError());
  }
  return static_cast<int>(cudaSuccess);
}

// Dynamic shared memory of a TMA-plan block (chip_smoke prints it).
extern "C" int emu_fused_dense_smem() { return TmaPlan::SMEM; }
