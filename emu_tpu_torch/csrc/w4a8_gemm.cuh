// The W4A8 GEMM of kernel F (q4_matmul.cu), built for Hopper:
// int8 activations [M, K] times fold-packed int4 weights [K/2, N] on the
// tensor cores through wgmma (s8 x s8 -> s32), fed by an asynchronous ring.
//
// One block computes a BM x 128 tile of the output (BM = 64 rows with one
// consumer warpgroup, the decode plan; 128 with two, the prefill plan) over
// a range of 128-row K tiles (of each nibble plane), in two roles that
// wait on one another only through mbarriers:
//
// - two transform warpgroups keep the packed weight tiles WSTAGES ahead in a
//   ring: one TMA copy of the tile's 128 packed rows when N is a multiple
//   of 16, else cp.async 16 bytes at a time from the 16-byte aligned
//   address at or before each row's start (neighbouring threads on
//   neighbouring bytes: the lm_head's N = 32274); cp.async the tile's
//   scales. They unpack
//   each tile into the two K-major int8 tiles wgmma needs for 8-bit
//   operands (B must be K-major: the packed bytes are N-major): each thread
//   reads 4 rows x 16 columns with 16-byte loads, transposes 4 x 4 blocks
//   of bytes with __byte_perm, splits the nibbles into sign-extended bytes
//   and writes 4-byte runs of K, in the 128-byte swizzle, into a second
//   ring of USTAGES slots;
// - consumer warpgroups each keep their own 64 rows of the two activation
//   tiles (x columns k0.. and K/2 + k0.., one per nibble plane) XSTAGES
//   ahead through TMA and issue wgmma m64n64k32 over four units a tile
//   (plane x 64-column half) into two int32 accumulators in turn, folding
//   each unit's exact 128-row integer dot into the fp32 accumulator, with
//   its per-(group, column) scale (and a per-(row, block) activation scale
//   when blk_scale is set: G's down product used it before G took its own
//   plan, w4a8_decode.cuh; the branch stays because F's code without it
//   rounds differently), while the next unit runs.
//
// The transform writes output column c*16 + m of the tile to wgmma row
// (c*16) + (m ^ c): the 8 threads that store at once then hit 8 distinct
// 16-byte units (no bank conflicts), and an accumulator's column n maps
// back to tile column n ^ ((n >> 4) & 7).
//
// A group of gs > 128 rows is summed as its 128-row tiles' integer dots,
// each scaled into fp32: the same value as scaling the group's dot, up to
// fp32 rounding (every real model here has groups of 128).
//
// On short grids a block's tile count is split over blockIdx.z in whole
// scale-group pairs (about two waves of blocks): each split stores its
// fp32 sums into its own slice of a workspace, and split_epilogue_kernel
// adds the slices in split order, so every run gives the same bits.

#pragma once

#include "hopper.cuh"
#include "int8_mma.cuh"
#include "wgmma.cuh"

namespace {

constexpr int W4_BN = 128;         // weight columns per block
constexpr int W4_KT = 128;         // K rows of each plane (= packed rows) per tile
constexpr int W4_WP = 144;         // smem pitch of a packed row: 128 bytes + misalignment
constexpr int W4_USTAGES = 2;      // unpacked-tile slots
constexpr int W4_DECODE_ROWS = 64; // up to this many rows: one consumer warpgroup
                                   // (measured on an H100: it wins to 64 rows)
constexpr int W4_WAVE_BLOCKS = 264;  // split K until about this many blocks

template <int CW>
struct W4Plan {
  static constexpr int BM = 64 * CW;
  static constexpr int XSTAGES = 2;                     // activations: from L2, short
  static constexpr int WSTAGES = CW == 2 ? 4 : 6;       // weights: from HBM at decode
  static constexpr int X_BYTES = 64 * W4_KT;           // one warpgroup's rows, one plane
  static constexpr int XS_BYTES = 2 * X_BYTES;          // both planes
  static constexpr int W_BYTES = W4_KT * W4_WP;         // packed weight rows
  static constexpr int SC_BYTES = 2 * W4_BN * 4;        // the tile's scales, both planes
  static constexpr int WS_BYTES = W_BYTES + SC_BYTES;   // one weight slot (19 KB)
  static constexpr int U_BYTES = 2 * W4_BN * W4_KT + SC_BYTES;  // unpacked planes + scales
  static constexpr int X_OFF = 0;                       // [XSTAGES][CW] activation slots
  static constexpr int W_OFF = X_OFF + XSTAGES * CW * XS_BYTES;
  static constexpr int U_OFF = W_OFF + WSTAGES * WS_BYTES;
  static constexpr int BAR_OFF = U_OFF + W4_USTAGES * U_BYTES;
  static constexpr int SMEM = BAR_OFF + 8 * (CW * XSTAGES + WSTAGES + 2 * W4_USTAGES) + 1024;
  static constexpr int TT = 256;                        // transform threads (two warpgroups)
  static constexpr int THREADS = CW * 128 + TT;
};

__device__ __forceinline__ void transpose4x4(uint32_t a0, uint32_t a1, uint32_t a2, uint32_t a3,
                                             uint32_t (&o)[4]) {
  const uint32_t x0 = __byte_perm(a0, a1, 0x5140), x1 = __byte_perm(a0, a1, 0x7362);
  const uint32_t y0 = __byte_perm(a2, a3, 0x5140), y1 = __byte_perm(a2, a3, 0x7362);
  o[0] = __byte_perm(x0, y0, 0x5410);
  o[1] = __byte_perm(x0, y0, 0x7632);
  o[2] = __byte_perm(x1, y1, 0x5410);
  o[3] = __byte_perm(x1, y1, 0x7632);
}

// Four 4-bit two's-complement values (one per byte) -> four signed bytes.
__device__ __forceinline__ uint32_t sext4(uint32_t z) {
  return z | ((z & 0x08080808u) * 0x1Eu);
}

// Low nibbles hold value + 8; high nibbles hold the value.
__device__ __forceinline__ uint32_t nib_lo(uint32_t p) {
  return sext4((p & 0x0F0F0F0Fu) ^ 0x08080808u);
}
__device__ __forceinline__ uint32_t nib_hi(uint32_t p) { return sext4((p >> 4) & 0x0F0F0F0Fu); }

// An int32 of magnitude below 2^22 as an exact fp32, at the full ALU rate
// (a tile's integer dot is at most 127 * 8 * 128 = 130048 in magnitude).
__device__ __forceinline__ float small_int_to_float(int v) {
  return __int_as_float(v + 0x4B400000) - 12582912.f;
}

template <int CW>
__global__ void __launch_bounds__(W4Plan<CW>::THREADS, 1)
    w4a8_gemm_kernel(const __grid_constant__ CUtensorMap xmap,
                     const __grid_constant__ CUtensorMap wmap, const GemmArgs p) {
  using Plan = W4Plan<CW>;
  constexpr int XSTAGES = Plan::XSTAGES, WSTAGES = Plan::WSTAGES;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~static_cast<uintptr_t>(1023));
  uint64_t* xfull = reinterpret_cast<uint64_t*>(smem + Plan::BAR_OFF);  // [CW][XSTAGES]
  uint64_t* wfull = xfull + CW * XSTAGES;
  uint64_t* ufull = wfull + WSTAGES;
  uint64_t* uempty = ufull + W4_USTAGES;

  const int m0 = blockIdx.x * Plan::BM, n0 = blockIdx.y * W4_BN;
  const int half = p.K / 2;
  const int it0 = blockIdx.z * p.tiles_per_split;
  const int it1 = min(half / W4_KT, it0 + p.tiles_per_split);
  const int ntiles = it1 - it0;

  if (threadIdx.x == 0) {
    for (int s = 0; s < CW * XSTAGES; ++s) mbar_init(&xfull[s], 1);
    for (int s = 0; s < WSTAGES; ++s) mbar_init(&wfull[s], Plan::TT);  // a cp.async arrival a thread
    for (int u = 0; u < W4_USTAGES; ++u) {
      mbar_init(&ufull[u], Plan::TT);
      mbar_init(&uempty[u], CW * 128);
    }
    mbar_fence_init();
  }
  __syncthreads();

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  if (warp >= 4 * CW) {
    // ---- transform warpgroups: load the packed weight tiles (cp.async,
    // WSTAGES ahead) and unpack each into two K-major int8 tiles ----
    regs_dealloc<80>();  // the consumers take the rest
    constexpr int TT = Plan::TT;
    const int tid = threadIdx.x - CW * 128;
    const long long N = p.N;
    const long long total = static_cast<long long>(half) * N;
    const int groups = p.K / p.gs;
    // tile i -> weight slot i % WSTAGES: 128 rows of 144 bytes from the
    // 16-byte aligned address at or before each row's start, then scales
    const bool aligned = p.N % 16 == 0;
    const int pitch = aligned ? W4_BN : W4_WP;  // smem bytes a packed row
    auto load_w = [&](int i) {
      const int k0 = (it0 + i) * W4_KT;
      unsigned char* slot = smem + Plan::W_OFF + (i % WSTAGES) * Plan::WS_BYTES;
      uint64_t* bar = &wfull[i % WSTAGES];
      if (aligned) {
        // rows 16-byte aligned: one TMA copy of the 128 x 128-byte box
        if (tid == 0) {
          mbar_expect_tx(bar, W4_KT * W4_BN);
          tma_load_2d(slot, &wmap, bar, n0, k0);
        }
      } else {
        constexpr int CHUNKS = W4_KT * (W4_WP / 16);
#pragma unroll
        for (int j = 0; j < (CHUNKS + TT - 1) / TT; ++j) {
          const int v = tid + TT * j;
          if (v < CHUNKS) {
            const int r = v / (W4_WP / 16), c = v % (W4_WP / 16);
            const long long src = ((static_cast<long long>(k0 + r) * N + n0) & ~15LL) + 16 * c;
            const long long left = total - src;
            const int bytes = left >= 16 ? 16 : (left > 0 ? static_cast<int>(left) : 0);
            cp_async16(slot + r * W4_WP + 16 * c, p.w + (bytes > 0 ? src : 0), bytes);
          }
        }
      }
      // scale of plane tid / 128 at tile column tid % 128
      const int pl = tid / W4_BN, col = n0 + tid % W4_BN;
      const float* src =
          p.w_scale + static_cast<long long>(pl * groups / 2 + k0 / p.gs) * N + col;
      cp_async4(slot + Plan::W_BYTES + 4 * tid, col < N ? src : p.w_scale, col < N ? 4 : 0);
      cp_async_arrive(bar);
    };
    for (int i = 0; i < WSTAGES && i < ntiles; ++i) load_w(i);

    const int c = tid & 7, rb = tid >> 3;  // 16-column chunk, 4-row block
    for (int i = 0; i < ntiles; ++i) {
      const int s = i % WSTAGES, u = i % W4_USTAGES;
      mbar_wait(&wfull[s], (i / WSTAGES) & 1);
      const unsigned char* wr = smem + Plan::W_OFF + s * Plan::WS_BYTES;
      const int k0 = (it0 + i) * W4_KT;
      uint32_t w[4][4];
#pragma unroll
      for (int rr = 0; rr < 4; ++rr) {
        const int r = rb * 4 + rr;
        const unsigned char* rowp = wr + r * pitch + c * 16;
        if (aligned) {
          const uint4 v = *reinterpret_cast<const uint4*>(rowp);
          w[rr][0] = v.x;
          w[rr][1] = v.y;
          w[rr][2] = v.z;
          w[rr][3] = v.w;
        } else {
          const int off = static_cast<int>((static_cast<long long>(k0 + r) * N + n0) & 15);
          const unsigned char* q = rowp + off;
          const uint32_t* base = reinterpret_cast<const uint32_t*>(
              reinterpret_cast<uintptr_t>(q) & ~static_cast<uintptr_t>(3));
          const uint32_t sh = (reinterpret_cast<uintptr_t>(q) & 3) * 8;
          uint32_t x[5];
#pragma unroll
          for (int j = 0; j < 5; ++j) x[j] = base[j];
#pragma unroll
          for (int j = 0; j < 4; ++j) w[rr][j] = __funnelshift_r(x[j], x[j + 1], sh);
        }
      }
      const float scv = reinterpret_cast<const float*>(wr + Plan::W_BYTES)[tid];
      named_barrier(1, TT);  // the slot is read: refill it
      if (i + WSTAGES < ntiles) load_w(i + WSTAGES);

      if (i >= W4_USTAGES) mbar_wait(&uempty[u], ((i / W4_USTAGES) + 1) & 1);
      unsigned char* ulo = smem + Plan::U_OFF + u * Plan::U_BYTES;
      unsigned char* uhi = ulo + W4_BN * W4_KT;
      reinterpret_cast<float*>(uhi + W4_BN * W4_KT)[tid] = scv;
      const int kb = rb * 4;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        uint32_t t0[4];
        transpose4x4(w[0][j], w[1][j], w[2][j], w[3][j], t0);
#pragma unroll
        for (int b = 0; b < 4; ++b) {
          const int n = c * 16 + ((4 * j + b) ^ c);
          const int o = n * W4_KT + (((kb >> 4) ^ (n & 7)) << 4) + (kb & 15);
          *reinterpret_cast<uint32_t*>(ulo + o) = nib_lo(t0[b]);
          *reinterpret_cast<uint32_t*>(uhi + o) = nib_hi(t0[b]);
        }
      }
      fence_async_smem();
      mbar_arrive(&ufull[u]);
    }
  } else {
    // ---- consumer warpgroups: each loads its own 64 activation rows
    // (TMA, XSTAGES ahead) and runs wgmma over each tile in four units
    // (plane, 64-column half), folding one unit while the next runs ----
    regs_alloc<CW == 2 ? 176 : 232>();
    const int wg = warp / 4, g = lane / 4, t = lane % 4;
    const int ct = threadIdx.x % 128;
    const int row0 = m0 + wg * 64 + (warp % 4) * 16 + g;  // and row0 + 8
    uint64_t* xf = xfull + wg * XSTAGES;
    auto load_x = [&](int i) {
      const int k0 = (it0 + i) * W4_KT;
      unsigned char* xs = smem + Plan::X_OFF + ((i % XSTAGES) * CW + wg) * Plan::XS_BYTES;
      mbar_arrive_tx(&xf[i % XSTAGES], Plan::XS_BYTES);
      tma_load_2d(xs, &xmap, &xf[i % XSTAGES], k0, m0 + wg * 64);
      tma_load_2d(xs + Plan::X_BYTES, &xmap, &xf[i % XSTAGES], half + k0, m0 + wg * 64);
    };
    if (ct == 0)
      for (int i = 0; i < XSTAGES && i < ntiles; ++i) load_x(i);

    int acc[2][32];
    float accf[64];
#pragma unroll
    for (int e = 0; e < 32; ++e) acc[0][e] = acc[1][e] = 0;
#pragma unroll
    for (int e = 0; e < 64; ++e) accf[e] = 0.f;
    for (int i = 0; i < ntiles; ++i) {
      const int s = i % XSTAGES, u = i % W4_USTAGES;
      const int k0 = (it0 + i) * W4_KT;
      const unsigned char* xs = smem + Plan::X_OFF + (s * CW + wg) * Plan::XS_BYTES;
      const unsigned char* us = smem + Plan::U_OFF + u * Plan::U_BYTES;
      const float* scs = reinterpret_cast<const float*>(us + 2 * W4_BN * W4_KT);
      mbar_wait(&xf[s], (i / XSTAGES) & 1);
      mbar_wait(&ufull[u], (i / W4_USTAGES) & 1);
      // per-(row, block) activation scales (blk_scale), both planes
      float rs[2][2] = {{1.f, 1.f}, {1.f, 1.f}};
      if (p.blk_scale != nullptr) {
        const int b = k0 / p.blk;
        const long long r0 = min(row0, p.M - 1), r1 = min(row0 + 8, p.M - 1);
#pragma unroll
        for (int pl = 0; pl < 2; ++pl) {
          rs[pl][0] = p.blk_scale[r0 * 2 * p.nblk + pl * p.nblk + b];
          rs[pl][1] = p.blk_scale[r1 * 2 * p.nblk + pl * p.nblk + b];
        }
      }
      // unit q: plane q / 2, columns (q % 2) * 64 .. + 64, into acc[q % 2]
      auto issue = [&](int q, int (&d)[32]) {
        const unsigned char* xa = xs + (q / 2) * Plan::X_BYTES;
        const unsigned char* ub = us + (q / 2) * W4_BN * W4_KT + (q % 2) * 64 * W4_KT;
        fence_regs(d);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < W4_KT / 32; ++kk)
          wgmma_s8_ss_n64(d, smem_desc(xa + kk * 32, 16, 1024),
                          smem_desc(ub + kk * 32, 16, 1024), kk > 0);
        wgmma_commit();
      };
      issue(0, acc[0]);
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        if (q < 3) {
          issue(q + 1, acc[(q + 1) % 2]);
          wgmma_wait<1>();
        } else {
          wgmma_wait<0>();
        }
        int (&d)[32] = acc[q % 2];
        fence_regs(d);
        const int pl = q / 2, h = q % 2;
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const int jj = h * 8 + j;      // the 8-column block within the tile
          const int x = (jj >> 1) & 7;   // its column swizzle
          const float2 sv = *reinterpret_cast<const float2*>(
              scs + pl * W4_BN + ((jj * 8 + 2 * t) ^ (x & 6)));
          const float s0 = (x & 1) ? sv.y : sv.x, s1 = (x & 1) ? sv.x : sv.y;
          if (p.blk_scale == nullptr) {
#pragma unroll
            for (int e = 0; e < 4; ++e)
              accf[jj * 4 + e] += small_int_to_float(d[j * 4 + e]) * ((e & 1) ? s1 : s0);
          } else {
#pragma unroll
            for (int e = 0; e < 4; ++e)
              accf[jj * 4 + e] += small_int_to_float(d[j * 4 + e]) *
                                  (((e & 1) ? s1 : s0) * rs[pl][e >> 1]);
          }
        }
      }
      mbar_arrive(&uempty[u]);
      named_barrier(2 + wg, 128);  // the warpgroup's products have read slot s
      if (ct == 0 && i + XSTAGES < ntiles) load_x(i + XSTAGES);
    }
#pragma unroll
    for (int j = 0; j < 16; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int row = row0 + (e >= 2 ? 8 : 0);
        const int nn = j * 8 + 2 * t + (e & 1);
        const int col = n0 + (nn ^ ((nn >> 4) & 7));
        if (row >= p.M || col >= p.N) continue;
        if (p.splits > 1)
          p.ws[(static_cast<long long>(blockIdx.z) * p.M + row) * p.N + col] = accf[j * 4 + e];
        else
          gemm_store<true>(p, row, col, accf[j * 4 + e]);
      }
  }
}

// K splits of a W4A8 product at M rows: whole scale-group pairs, enough
// blocks for about two waves (a block holds an SM). The caller sizes the
// workspace by it.
inline int w4a8_split_count(int M, int N, int K, int gs) {
  const int bm = M <= W4_DECODE_ROWS ? 64 : 128;
  const int blocks = ((M + bm - 1) / bm) * ((N + W4_BN - 1) / W4_BN);
  const int units = (K / 2) / gs;  // group pairs
  if (blocks >= W4_WAVE_BLOCKS) return 1;
  int splits = (W4_WAVE_BLOCKS + blocks - 1) / blocks;
  splits = splits > units ? units : splits;
  const int per = (units + splits - 1) / splits;
  return (units + per - 1) / per;
}

template <int CW>
cudaError_t launch_w4a8_plan(GemmArgs a, cudaStream_t s) {
  using Plan = W4Plan<CW>;
  CUtensorMap xmap;
  const uint64_t dims[2] = {static_cast<uint64_t>(a.K), static_cast<uint64_t>(a.M)};
  const uint64_t strides[1] = {static_cast<uint64_t>(a.K)};
  const uint32_t box[2] = {W4_KT, 64};  // one warpgroup's rows
  if (!make_map(&xmap, CU_TENSOR_MAP_DATA_TYPE_UINT8, 2, a.a, dims, strides, box))
    return cudaErrorInvalidValue;
  // the packed weights [K/2, N] (only read through TMA when N % 16 == 0)
  CUtensorMap wmap = xmap;
  if (a.N % 16 == 0) {
    const uint64_t wdims[2] = {static_cast<uint64_t>(a.N), static_cast<uint64_t>(a.K / 2)};
    const uint64_t wstrides[1] = {static_cast<uint64_t>(a.N)};
    const uint32_t wbox[2] = {W4_BN, W4_KT};
    if (!make_map(&wmap, CU_TENSOR_MAP_DATA_TYPE_UINT8, 2, a.w, wdims, wstrides, wbox, false))
      return cudaErrorInvalidValue;
  }
  auto kern = w4a8_gemm_kernel<CW>;
  cudaError_t err =
      cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, Plan::SMEM);
  if (err != cudaSuccess) return err;
  const dim3 grid((a.M + Plan::BM - 1) / Plan::BM, (a.N + W4_BN - 1) / W4_BN, a.splits);
  kern<<<grid, Plan::THREADS, Plan::SMEM, s>>>(xmap, wmap, a);
  err = cudaGetLastError();
  if (err != cudaSuccess || a.splits == 1) return err;
  const long long total = static_cast<long long>(a.M) * a.N;
  const int blocks = static_cast<int>(total / 256 + 1 < 1024 ? total / 256 + 1 : 1024);
  split_epilogue_kernel<true><<<blocks, 256, 0, s>>>(a);
  return cudaGetLastError();
}

// One consumer warpgroup (64-row tiles) up to W4_DECODE_ROWS rows, two
// above. The caller has checked K % 256 == 0, gs % 128 == 0 and (K / 2) % gs == 0.
inline cudaError_t launch_w4a8(GemmArgs a, cudaStream_t s) {
  a.splits = w4a8_split_count(a.M, a.N, a.K, a.gs);
  if (a.splits > 1 && a.ws == nullptr) return cudaErrorInvalidValue;
  const int unit = a.gs / W4_KT;
  const int units = (a.K / 2) / a.gs;
  a.tiles_per_split = (units + a.splits - 1) / a.splits * unit;
  return a.M <= W4_DECODE_ROWS ? launch_w4a8_plan<1>(a, s) : launch_w4a8_plan<2>(a, s);
}

}  // namespace
