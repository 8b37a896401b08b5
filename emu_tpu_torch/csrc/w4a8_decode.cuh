// The decode plan of kernel G (fused_swiglu_q4 at <= 32 rows, q4_matmul.cu),
// built for Hopper: the two W4A8 products of the int4 decode MLP stream
// their weights once, at the card's memory rate, with the activation rows
// on the narrow side of the tensor-core product.
//
// What bounds it on an H100: the weight bytes. LLaMA-33B's gate|up and
// down products hold 179 MB of packed nibbles (plus 11 MB of scales) and
// do 3.6 G integer operations at 5 rows: 0.057 ms of bytes at 3.35 TB/s,
// far above the operations' time on the int8 tensor cores, and out of
// reach of CUDA-core IMADs (~31 TOP/s).
//
// - Swap AB: the weight columns are the rows of mma.sync m16n8k32 (s8 x s8
//   -> s32) and the <= 32 activation rows its n8 tiles. Each warp owns 64
//   weight columns and streams them 32 packed rows a step: one TMA box of
//   32 x 64 bytes into a 4-deep ring of its own, behind one mbarrier a
//   slot (no block barrier; the bytes never pass through registers or the
//   L1's request queue). A thread reads 8 rows x 8 columns of a slot,
//   transposes 4 x 4 blocks of bytes with __byte_perm and unpacks each
//   packed byte's two nibbles as 16 x value (the low nibble's value + 8
//   through a xor), so both planes feed the tensor cores as signed bytes
//   and every 128-row group dot stays an exact integer (|16 x 8 x 127 x
//   128| < 2^22); the fold scales it by the group's scale / 16 in fp32.
//   The k order inside each 16-row half step is a 4 x 4 transpose of the
//   rows (mma k 4t + i is row 4i + t), so the four rows of a shared load
//   lie next to each other (conflict-free); the activations of the block's
//   K range sit in shared memory in that order, one n8 tile per 8 rows.
// - The K axis is split over a thread-block cluster in whole scale-group
//   pairs (decode_plan in ops/q4_matmul.py sizes the grid to one wave of
//   co-resident blocks); each block's fp32 partial sums stay in its shared
//   memory and are added in rank order through distributed shared memory
//   (the same bits on every run).
// - gate|up (SWIGLU): a cluster owns one hidden block of bf units (both
//   its gate and its up columns); after the cluster's reduction each rank
//   takes some rows, forms silu(g) * u from the row-scaled sums and
//   re-quantizes the row's block to int8 with its own scale: no fp32 gate|
//   up activation and no separate requantization pass.
// - down: a cluster owns 256 output columns; the reduction adds the
//   residual and rounds to bf16 once.
// With the row quantization before them (rms_quant_kernel, each row read
// once into registers), G is three launches.

#pragma once

#include <cooperative_groups.h>

#include "hopper.cuh"
#include "int8_mma.cuh"
#include "w4a8_gemm.cuh"

namespace {

constexpr int WD_STAGES = 4;   // 32-row weight steps each thread keeps in flight
constexpr int WD_STEP = 32;    // packed rows per step: one k32 product per plane
constexpr int WD_FOLD = 128;   // packed rows per integer fold

struct DecodeArgs {
  const int8_t* a;                // int8 activations [M, K]: plane 0 columns [0, K/2)
  const int8_t* w;                // fold-packed weights [K/2, N]
  const float* w_scale;           // [K / gs, N]
  const float* row_scale;         // gate|up: [M]
  const float* blk_scale;         // down: [M, 2 * nblk] (plane, block) scales
  const __nv_bfloat16* residual;  // down: [M, N] or null
  __nv_bfloat16* out;             // down: [M, N]
  int8_t* hq;                     // gate|up: [M, F] re-quantized silu(g) * u
  float* hs;                      // gate|up: [M, F / bf]
  int M, N, K, gs;
  int F, bf, nblk;
  int ks;                         // K splits: the cluster's size
  int kmax;                       // packed rows of the longest split
};

// Dynamic shared memory of a block: the activations [2][8 NT][kmax + 16],
// the weight ring [STAGES][warps][32][64] bytes, the partial sums [8 NT]
// [cols] fp32, and 128 bytes to align the ring for TMA.
__host__ __device__ inline int wd_smem(int nt, int threads, int kmax, int cols) {
  return 2 * 8 * nt * (kmax + 16) + WD_STAGES * (threads / 32) * 2048 + 8 * nt * cols * 4 +
         128;
}

// 16 x the low nibbles' values (stored + 8) and 16 x the high nibbles' (two's
// complement) of four packed bytes, as four signed bytes each.
__device__ __forceinline__ uint32_t lo16(uint32_t p) {
  return ((p << 4) & 0xF0F0F0F0u) ^ 0x80808080u;
}
__device__ __forceinline__ uint32_t hi16(uint32_t p) { return p & 0xF0F0F0F0u; }

constexpr int RQ_THREADS = 256;
constexpr int RQ_VEC = 8;      // 16-byte units a thread holds: D <= 16384

// One block per row of x [M, D] bf16 (D % 8 == 0, 16-byte aligned rows):
// the row and w held in registers from 16-byte loads, then q [M, D] int8
// and s [M] as quant_rows_kernel's ROW_RMSNORM gives them: v = bf16(x *
// rsqrt(mean(x^2) + eps)) * w in fp32, s = max(max|v| * (1/127), 1e-8),
// q = clip(rint(v / s), -127, 127). One read of the row instead of three.
__global__ void __launch_bounds__(RQ_THREADS) rms_quant_kernel(
    const __nv_bfloat16* __restrict__ x, const __nv_bfloat16* __restrict__ w, int D, float eps,
    int8_t* __restrict__ q, float* __restrict__ s) {
  __shared__ float red[32];
  const long long row = blockIdx.x;
  const int n = D / 8;
  uint4 xv[RQ_VEC], wv[RQ_VEC];
  float ss = 0.f;
#pragma unroll
  for (int i = 0; i < RQ_VEC; ++i) {
    const int u = threadIdx.x + i * RQ_THREADS;
    xv[i] = wv[i] = make_uint4(0u, 0u, 0u, 0u);
    if (u < n) {
      xv[i] = reinterpret_cast<const uint4*>(x + row * D)[u];
      wv[i] = reinterpret_cast<const uint4*>(w)[u];
    }
  }
#pragma unroll
  for (int i = 0; i < RQ_VEC; ++i) {
    const __nv_bfloat16* e = reinterpret_cast<const __nv_bfloat16*>(&xv[i]);
#pragma unroll
    for (int k = 0; k < 8; ++k) ss += __bfloat162float(e[k]) * __bfloat162float(e[k]);
  }
  const float rstd = rsqrtf(i8_block_reduce<false>(ss, red) / D + eps);
  auto val = [&](int i, int k) {
    const float xe = __bfloat162float(reinterpret_cast<const __nv_bfloat16*>(&xv[i])[k]);
    const float we = __bfloat162float(reinterpret_cast<const __nv_bfloat16*>(&wv[i])[k]);
    return __bfloat162float(__float2bfloat16(xe * rstd)) * we;
  };
  float mx = 0.f;
#pragma unroll
  for (int i = 0; i < RQ_VEC; ++i)
#pragma unroll
    for (int k = 0; k < 8; ++k) mx = fmaxf(mx, fabsf(val(i, k)));
  const float sc = fmaxf(i8_block_reduce<true>(mx, red) * (1.f / 127.f), 1e-8f);
#pragma unroll
  for (int i = 0; i < RQ_VEC; ++i) {
    const int u = threadIdx.x + i * RQ_THREADS;
    if (u >= n) continue;
    int8_t b[8];
#pragma unroll
    for (int k = 0; k < 8; ++k) b[k] = i8_quant(val(i, k), sc);
    uint2 packed;
    memcpy(&packed, b, 8);
    reinterpret_cast<uint2*>(q + row * D)[u] = packed;
  }
  if (threadIdx.x == 0) s[row] = sc;
}

template <int NT, int WARPS, bool SWIGLU>
__global__ void __launch_bounds__(WARPS * 32, NT == 1 ? (WARPS == 4 ? 3 : 2) : 1)
    w4a8_decode_kernel(const __grid_constant__ CUtensorMap wmap, const DecodeArgs p) {
  namespace cg = cooperative_groups;
  constexpr int THREADS = WARPS * 32, MP = 8 * NT;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 127) & ~static_cast<uintptr_t>(127));
  __shared__ float red[32];
  __shared__ uint64_t wfull[WARPS][WD_STAGES];
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = static_cast<int>(cluster.block_rank());
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32, g = lane / 4, t = lane % 4;
  const int kp = p.K / 2;
  const int npairs = kp / p.gs;
  const int r0 = rank * npairs / p.ks * p.gs;
  const int r1 = (rank + 1) * npairs / p.ks * p.gs;
  const int krange = r1 - r0;
  const int pitch = p.kmax + 16;
  const int cols = SWIGLU ? 2 * p.bf : WARPS * 64;
  int8_t* xs = reinterpret_cast<int8_t*>(smem);
  unsigned char* ring = smem + 2 * MP * pitch;   // [STAGES][WARPS][32][64]
  float* part = reinterpret_cast<float*>(ring + WD_STAGES * WARPS * 2048);
  if (lane == 0) {
    for (int st = 0; st < WD_STAGES; ++st) mbar_init(&wfull[warp][st], 1);
    mbar_fence_init();
  }

  // this split's activations, both planes, zeros past M; each 16-byte unit
  // (a 16-row half step) in the kernel's k order: position 4t + i holds row
  // 4i + t
  const int units = krange / 16;
  for (int e = threadIdx.x; e < 2 * MP * units; e += THREADS) {
    const int row = e / units, c = e % units;
    const int pl = row / MP, m = row % MP;
    uint4 v = make_uint4(0u, 0u, 0u, 0u);
    if (m < p.M)
      v = *reinterpret_cast<const uint4*>(p.a + static_cast<long long>(m) * p.K + pl * kp + r0 +
                                          c * 16);
    uint32_t o[4];
    transpose4x4(v.x, v.y, v.z, v.w, o);
    *reinterpret_cast<uint4*>(xs + row * pitch + c * 16) = make_uint4(o[0], o[1], o[2], o[3]);
  }
  __syncthreads();

  const int ntiles = cols / 64;
  const int nsteps = krange / WD_STEP;
  const int groups = p.K / p.gs;
  unsigned char* wslot = ring + warp * 2048;   // + slot * WARPS * 2048
  int q0 = 0;   // steps this warp has taken through its ring
  for (int ct = warp; ct < ntiles; ct += WARPS) {
    int col0;   // the tile's first weight column
    if (SWIGLU) {
      const int half = ntiles / 2;
      col0 = (ct < half ? 0 : p.F) + blockIdx.y * p.bf + (ct % half) * 64;
    } else {
      col0 = blockIdx.y * cols + ct * 64;
    }
    // step s: packed rows r0 + 32 s .. + 31, columns col0 .. col0 + 63
    auto issue = [&](int s) {
      const int q = q0 + s, slot = q % WD_STAGES;
      mbar_arrive_tx(&wfull[warp][slot], 2048);
      tma_load_2d(wslot + slot * WARPS * 2048, &wmap, &wfull[warp][slot], col0,
                  r0 + s * WD_STEP);
    };
    if (lane == 0)
      for (int s = 0; s < min(WD_STAGES - 1, nsteps); ++s) issue(s);
    int ilo[4][NT][4], ihi[4][NT][4];
    float acc[4][NT][4];
#pragma unroll
    for (int mt = 0; mt < 4; ++mt)
#pragma unroll
      for (int nt = 0; nt < NT; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          ilo[mt][nt][e] = ihi[mt][nt][e] = 0;
          acc[mt][nt][e] = 0.f;
        }
    float slo[8], shi[8], hlo[NT][2], hhi[NT][2];
    for (int s = 0; s < nsteps; ++s) {
      // the slot step s - 1 read: every lane left it at the last __syncwarp
      if (lane == 0 && s + WD_STAGES - 1 < nsteps) issue(s + WD_STAGES - 1);
      if (s % (WD_FOLD / WD_STEP) == 0) {
        // the coming fold's scales: the weight group of each plane, and the
        // activation block of each of this thread's rows (down)
        const int k = r0 + s * WD_STEP;
        const float* sl = p.w_scale + static_cast<long long>(k / p.gs) * p.N + col0 + 8 * g;
        const float* sh = sl + static_cast<long long>(groups / 2) * p.N;
        const float4 a0 = __ldg(reinterpret_cast<const float4*>(sl));
        const float4 a1 = __ldg(reinterpret_cast<const float4*>(sl) + 1);
        const float4 b0 = __ldg(reinterpret_cast<const float4*>(sh));
        const float4 b1 = __ldg(reinterpret_cast<const float4*>(sh) + 1);
        const float lo[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
        const float hi[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          slo[j] = lo[j];
          shi[j] = hi[j];
        }
        if (!SWIGLU) {
          const int blk = k / p.bf;
#pragma unroll
          for (int nt = 0; nt < NT; ++nt)
#pragma unroll
            for (int e = 0; e < 2; ++e) {
              const int m = 8 * nt + 2 * t + e;
              const float* bs = p.blk_scale + static_cast<long long>(m) * 2 * p.nblk + blk;
              hlo[nt][e] = m < p.M ? bs[0] : 0.f;
              hhi[nt][e] = m < p.M ? bs[p.nblk] : 0.f;
            }
        }
      }
      const int q = q0 + s;
      mbar_wait(&wfull[warp][q % WD_STAGES], (q / WD_STAGES) & 1);
      // rows 16 half + 4 i + t, 8 bytes at column 8g
      const unsigned char* src = wslot + (q % WD_STAGES) * WARPS * 2048 + t * 64 + 8 * g;
      uint2 wv[8];
#pragma unroll
      for (int i = 0; i < 8; ++i)
        wv[i] = *reinterpret_cast<const uint2*>(src + ((i / 4) * 16 + (i % 4) * 4) * 64);
      __syncwarp();
      // tc[half][word][c]: column 4 word + c at mma k 16 half + 4t + 0..3
      uint32_t tc[2][2][4];
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        transpose4x4(wv[half * 4].x, wv[half * 4 + 1].x, wv[half * 4 + 2].x, wv[half * 4 + 3].x,
                     tc[half][0]);
        transpose4x4(wv[half * 4].y, wv[half * 4 + 1].y, wv[half * 4 + 2].y, wv[half * 4 + 3].y,
                     tc[half][1]);
      }
      const int kk = s * WD_STEP;
      uint32_t blo[NT][2], bhi[NT][2];
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
        const int8_t* xr = xs + (8 * nt + g) * pitch + kk + 4 * t;
        blo[nt][0] = *reinterpret_cast<const uint32_t*>(xr);
        blo[nt][1] = *reinterpret_cast<const uint32_t*>(xr + 16);
        bhi[nt][0] = *reinterpret_cast<const uint32_t*>(xr + MP * pitch);
        bhi[nt][1] = *reinterpret_cast<const uint32_t*>(xr + MP * pitch + 16);
      }
      // m-tile mt: mma row g is column 8g + 2mt, row g + 8 column 8g + 2mt + 1
#pragma unroll
      for (int mt = 0; mt < 4; ++mt) {
        const int h = mt / 2, c = 2 * (mt % 2);
        const unsigned alo[4] = {lo16(tc[0][h][c]), lo16(tc[0][h][c + 1]), lo16(tc[1][h][c]),
                                 lo16(tc[1][h][c + 1])};
        const unsigned ahi[4] = {hi16(tc[0][h][c]), hi16(tc[0][h][c + 1]), hi16(tc[1][h][c]),
                                 hi16(tc[1][h][c + 1])};
#pragma unroll
        for (int nt = 0; nt < NT; ++nt) {
          mma_s8(ilo[mt][nt], alo, blo[nt]);
          mma_s8(ihi[mt][nt], ahi, bhi[nt]);
        }
      }
      if (s % (WD_FOLD / WD_STEP) == WD_FOLD / WD_STEP - 1) {
#pragma unroll
        for (int mt = 0; mt < 4; ++mt)
#pragma unroll
          for (int nt = 0; nt < NT; ++nt)
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              const int j = 2 * mt + (e >> 1);
              float sl = slo[j], sh = shi[j];
              if (!SWIGLU) {
                sl = hlo[nt][e & 1] * sl;
                sh = hhi[nt][e & 1] * sh;
              }
              acc[mt][nt][e] += small_int_to_float(ilo[mt][nt][e]) * (sl * 0.0625f) +
                                small_int_to_float(ihi[mt][nt][e]) * (sh * 0.0625f);
              ilo[mt][nt][e] = ihi[mt][nt][e] = 0;
            }
      }
    }
#pragma unroll
    for (int mt = 0; mt < 4; ++mt)
#pragma unroll
      for (int nt = 0; nt < NT; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          part[(8 * nt + 2 * t + (e & 1)) * cols + ct * 64 + 8 * g + 2 * mt + (e >> 1)] =
              acc[mt][nt][e];
    q0 += nsteps;
  }

  __syncthreads();
  cluster.sync();   // every rank's partial sums are written
  if (SWIGLU) {
    constexpr int MAXU = 4;   // hidden units per thread: bf <= 4 * THREADS
    const int bf = p.bf;
    for (int m = rank; m < p.M; m += p.ks) {
      const float sx = p.row_scale[m];
      float hv[MAXU];
      float mx = 0.f;
#pragma unroll
      for (int i = 0; i < MAXU; ++i) {
        const int u = threadIdx.x + i * THREADS;
        hv[i] = 0.f;
        if (u < bf) {
          float gsum = 0.f, usum = 0.f;
          for (int r = 0; r < p.ks; ++r) {
            const float* pr = cluster.map_shared_rank(part, r) + m * cols;
            gsum += pr[u];
            usum += pr[bf + u];
          }
          const float gg = gsum * sx, uu = usum * sx;
          hv[i] = gg / (1.f + expf(-gg)) * uu;
          mx = fmaxf(mx, fabsf(hv[i]));
        }
      }
      const float sc = fmaxf(i8_block_reduce<true>(mx, red) * (1.f / 127.f), 1e-8f);
      const long long j0 = static_cast<long long>(blockIdx.y) * bf;
#pragma unroll
      for (int i = 0; i < MAXU; ++i) {
        const int u = threadIdx.x + i * THREADS;
        if (u < bf) p.hq[static_cast<long long>(m) * p.F + j0 + u] = i8_quant(hv[i], sc);
      }
      if (threadIdx.x == 0) p.hs[static_cast<long long>(m) * (p.F / bf) + blockIdx.y] = sc;
    }
  } else {
    const int total = p.M * cols;
    const int e0 = rank * total / p.ks, e1 = (rank + 1) * total / p.ks;
    for (int e = e0 + threadIdx.x; e < e1; e += THREADS) {
      const int m = e / cols, c = e % cols;
      float y = 0.f;
      for (int r = 0; r < p.ks; ++r) y += cluster.map_shared_rank(part, r)[m * cols + c];
      const long long o = static_cast<long long>(m) * p.N + static_cast<long long>(blockIdx.y) * cols + c;
      if (p.residual != nullptr) y += __bfloat162float(p.residual[o]);
      p.out[o] = __float2bfloat16(y);
    }
  }
  cluster.sync();   // no rank leaves while another reads its partial sums
}

template <int NT, int WARPS, bool SWIGLU>
cudaError_t launch_wd(const DecodeArgs& p, int tiles, cudaStream_t s) {
  constexpr int THREADS = WARPS * 32;
  const int cols = SWIGLU ? 2 * p.bf : WARPS * 64;
  const int smem = wd_smem(NT, THREADS, p.kmax, cols);
  auto kern = w4a8_decode_kernel<NT, WARPS, SWIGLU>;
  // set before the tensor map: it makes the card's context current on this
  // thread, which the encoder needs
  cudaError_t err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  // the packed weights [K/2, N] as 32 x 64-byte boxes
  CUtensorMap wmap;
  const uint64_t dims[2] = {static_cast<uint64_t>(p.N), static_cast<uint64_t>(p.K / 2)};
  const uint64_t strides[1] = {static_cast<uint64_t>(p.N)};
  const uint32_t box[2] = {64, WD_STEP};
  if (!make_map(&wmap, CU_TENSOR_MAP_DATA_TYPE_UINT8, 2, p.w, dims, strides, box, false))
    return cudaErrorInvalidValue;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(p.ks, tiles, 1);
  cfg.blockDim = dim3(THREADS, 1, 1);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = s;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = p.ks;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, kern, wmap, p);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

template <int WARPS, bool SWIGLU>
cudaError_t launch_wd_rows(const DecodeArgs& p, int tiles, cudaStream_t s) {
  if (p.M <= 8) return launch_wd<1, WARPS, SWIGLU>(p, tiles, s);
  if (p.M <= 16) return launch_wd<2, WARPS, SWIGLU>(p, tiles, s);
  return launch_wd<4, WARPS, SWIGLU>(p, tiles, s);
}

}  // namespace
