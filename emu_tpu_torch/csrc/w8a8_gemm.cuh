// The two int8 products of kernel E (fused_mlp_w8a8.cu), built for Hopper:
// int8 activations [M, K] times int8 weights [K, N] (stored N-major, as the
// param tree keeps them) on the tensor cores through wgmma (s8 x s8 ->
// s32), with the epilogues of the W8A8 MLP.
//
// A block computes 128 x 128 output tiles over all of K, 128 bytes of K a
// tile, in two roles that wait on one another only through mbarriers:
//
// - two transform warpgroups keep the raw weight tiles W8_WSTAGES ahead in
//   a ring (one TMA box of 128 rows x 128 bytes each) and turn each into the
//   K-major tile that 8-bit wgmma needs for B (both operands of an 8-bit
//   wgmma must be K-major; the weights are N-major; one transform
//   warpgroup measured slower on an H100): each thread reads 4
//   rows x 16 columns with 16-byte loads, transposes 4 x 4 blocks of bytes
//   (transpose4x4, w4a8_gemm.cuh) and writes 4-byte runs of K, in the
//   128-byte swizzle, into a second ring of W8_USTAGES slots. As in kernel F,
//   tile column c*16 + m lands on wgmma row c*16 + (m ^ c), so the 8
//   threads that store at once hit 8 distinct 16-byte units, and an
//   accumulator's column n is tile column n ^ ((n >> 4) & 7);
// - two consumer warpgroups each load their own 64 activation rows (TMA,
//   128-byte swizzle, W8_XSTAGES ahead) and issue wgmma m64n128k32, four a
//   tile, one tile in flight while the next lands. (FC1 with the two
//   taking turns on whole tiles, one's products beside the other's
//   epilogue, measured slower on an H100: each epilogue doubled.)
//
// FC1 (fc1 + GELU + requantization): the int32 sums over all of K (exact:
// K * 127^2 < 2^31 at every width here) become v = gelu_as((s * sx) * s1 +
// b1) in fp32; the per-row scale of each bf-wide hidden block needs the
// maximum over the whole block before any value is quantized, so the
// blocks of one hidden block form a thread-block cluster (the largest C <=
// 8 that divides bf / 128) whose ranks send their row maxima to one
// another through distributed shared memory, each arrival on the
// receiver's mbarrier releasing the sender's stores; then each rank
// quantizes its own tiles to int8 hq [M, F] and rank 0 writes hs [M, F /
// bf]. Where bf / 128 = C * T with T > 1, each rank owns T tiles: it
// computes them once for the maxima and once more to quantize (the same
// bits). FC1 is persistent: one wave of clusters (as many as the card
// holds at once) walks the (row tile, hidden block) units, so the rings
// run ahead across units while the consumers work through an epilogue,
// and a unit costs no launch, barrier set-up or pipeline fill.
// FC2 (fc2): the int32 sums of each bf-block's k-tiles (scale_d = 0 at the
// block's first; 768 * 127^2 < 2^24, exact in fp32) fold into an fp32 sum
// with the block's hs, in block order, as the TPU kernel's acc += pv * sh;
// then * s2 + b2 and the residual, or the fp32 workspace of the post form.
// Ragged K, F and N (multiples of 16) read zeros past their edges through
// TMA; a last hidden block narrower than bf is the TPU wrapper's zero
// padding. No sum crosses blocks except through the cluster's fixed-order
// maximum: two runs give the same bits.

#pragma once

#include "hopper.cuh"
#include "int8_mma.cuh"
#include "w4a8_gemm.cuh"
#include "wgmma.cuh"

namespace {

constexpr int W8_BM = 128;      // rows per tile
constexpr int W8_BN = 128;      // columns per tile
constexpr int W8_KT = 128;      // K bytes per tile
constexpr int W8_XSTAGES = 3;
constexpr int W8_WSTAGES = 4;
constexpr int W8_USTAGES = 3;
constexpr int W8_MAX_CLUSTER = 8;  // the portable cluster size
constexpr int W8_LEADERS = 64;     // threads of a block that send its row maxima
constexpr int W8_TT = 256;         // transform threads (two warpgroups)

struct W8Plan {
  static constexpr int X_BYTES = 64 * W8_KT;     // one warpgroup's rows of a K tile
  static constexpr int T_BYTES = W8_BN * W8_KT;  // a weight tile, raw or K-major
  static constexpr int X_OFF = 0;                // [W8_XSTAGES][2] activation slots
  static constexpr int W_OFF = X_OFF + W8_XSTAGES * 2 * X_BYTES;
  static constexpr int U_OFF = W_OFF + W8_WSTAGES * T_BYTES;
  // FC1: the row maxima the cluster's ranks send, [2][W8_MAX_CLUSTER][128]
  static constexpr int RED_OFF = U_OFF + W8_USTAGES * T_BYTES;
  // each consumer warpgroup's item: column scales and bias [2][2][128] fp32
  static constexpr int COL_OFF = RED_OFF + 2 * W8_MAX_CLUSTER * W8_BM * 4;
  static constexpr int BAR_OFF = COL_OFF + 2 * 2 * W8_BN * 4;
  static constexpr int SMEM =
      BAR_OFF + 8 * (2 * W8_XSTAGES + W8_WSTAGES + 2 * W8_USTAGES + 2) + 1024;
  static constexpr int THREADS = 2 * 128 + W8_TT;  // two consumer warpgroups, the transform
};

struct W8Args {
  const float* w_scale;           // [N]
  const __nv_bfloat16* bias;      // [N] or null
  int M, N, K;
  int row_tiles;                  // ceil(M / 128)
  // FC1
  const float* row_scale;         // sx [M]
  int8_t* hq;                     // [M, N]
  float* hs;                      // [M, ceil(N / bf)]
  int bf, cluster;                // the hidden block and the cluster's size
  int clusters;                   // the persistent grid's clusters
  // FC2
  const float* blk_scale;         // hs [M, ceil(K / bf)]
  const __nv_bfloat16* residual;  // [M, N] or null
  float* ws;                      // post form: fp32 [M, N], else null
  __nv_bfloat16* out;             // [M, N]
};

// gelu with the A&S 7.1.26 erf of the TPU kernels (i8_gelu), its
// exponential and reciprocal on the special-function unit: the epilogue of
// a 128 x 128 tile evaluates it 16384 times between two products.
__device__ __forceinline__ float gelu_as_mufu(float x) {
  const float z = x * 0.70710678118654752f;
  const float a = fabsf(z);
  const float t = __frcp_rn(1.f + 0.3275911f * a);
  const float poly = t * (0.254829592f + t * (-0.284496736f + t * (1.421413741f +
                     t * (-1.453152027f + t * 1.061405429f))));
  const float e = 1.f - poly * __expf(-a * a);
  return 0.5f * x * (1.f + copysignf(e, z));
}

__device__ __forceinline__ void cluster_sync_all() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

// The address of this block's shared `p` in the shared memory of cluster
// rank `rank`.
__device__ __forceinline__ uint32_t peer_addr(const void* p, int rank) {
  uint32_t r;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n" : "=r"(r) : "r"(smem_addr(p)), "r"(rank));
  return r;
}

__device__ __forceinline__ void peer_store(uint32_t addr, float v) {
  asm volatile("st.shared::cluster.f32 [%0], %1;\n" ::"r"(addr), "f"(v) : "memory");
}

// One arrival on a peer's mbarrier, releasing this thread's earlier stores
// to the cluster.
__device__ __forceinline__ void peer_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.release.cluster.shared::cluster.b64 _, [%0];\n" ::"r"(bar)
               : "memory");
}

// mbar_wait with the cluster's acquire: the peers' stores released by
// their arrivals are visible after it.
__device__ __forceinline__ void mbar_wait_cluster(uint64_t* bar, uint32_t parity) {
  asm volatile(
      "{\n"
      ".reg .pred done;\n"
      "WAITC_%=:\n"
      "mbarrier.try_wait.parity.acquire.cluster.shared::cta.b64 done, [%0], %1;\n"
      "@!done bra WAITC_%=;\n"
      "}\n" ::"r"(smem_addr(bar)),
      "r"(parity)
      : "memory");
}

// FC1 is persistent: p.clusters clusters of p.cluster blocks walk the work
// units (row tile, hidden block) u = cluster id + k * p.clusters, row tile
// major, each rank `rank` owning T of the hidden block's 128-column tiles
// (items q = 0..T-1 find the row maxima; with T > 1, items T..2T-1 compute
// them again and quantize). FC2: one unit a block, the column tile
// blockIdx.x of row tile blockIdx.y.
template <bool FC1>
__global__ void __launch_bounds__(W8Plan::THREADS, 1)
    w8a8_gemm_kernel(const __grid_constant__ CUtensorMap xmap,
                     const __grid_constant__ CUtensorMap wmap, const W8Args p) {
  using Plan = W8Plan;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~static_cast<uintptr_t>(1023));
  uint64_t* xfull = reinterpret_cast<uint64_t*>(smem + Plan::BAR_OFF);  // [2][XSTAGES]
  uint64_t* wfull = xfull + 2 * W8_XSTAGES;
  uint64_t* ufull = wfull + W8_WSTAGES;
  uint64_t* uempty = ufull + W8_USTAGES;
  uint64_t* xbar = uempty + W8_USTAGES;  // FC1: [2] the row maxima have arrived
  float* xred = reinterpret_cast<float*>(smem + Plan::RED_OFF);
  float* colv = reinterpret_cast<float*>(smem + Plan::COL_OFF);

  const int ktiles = (p.K + W8_KT - 1) / W8_KT;  // the ragged edge reads zeros
  const int C = FC1 ? p.cluster : 1;
  const int cid = FC1 ? static_cast<int>(blockIdx.x) / C : 0;
  const int rank = FC1 ? static_cast<int>(blockIdx.x) % C : 0;
  const int T = FC1 ? p.bf / W8_BN / C : 1;
  const int sub = T == 1 ? 1 : 2 * T;           // items a unit
  const int span = sub * ktiles;                // tiles a unit
  const int nblk = (p.N + p.bf - 1) / p.bf;     // FC1: hidden blocks
  const int units = FC1 ? nblk * p.row_tiles : 1;
  const int nunits = FC1 ? (cid < units ? (units - cid + p.clusters - 1) / p.clusters : 0) : 1;
  auto unit_row = [&](int k) {
    return FC1 ? (cid + k * p.clusters) / nblk : static_cast<int>(blockIdx.y);
  };
  auto unit_jb = [&](int k) { return FC1 ? (cid + k * p.clusters) % nblk : 0; };
  auto item_col = [&](int it) {
    return FC1 ? (unit_jb(it / sub) * (p.bf / W8_BN) + rank * T + (it % sub) % T) * W8_BN
               : static_cast<int>(blockIdx.x) * W8_BN;
  };
  const int total = nunits * span;

  if (threadIdx.x == 0) {
    for (int s = 0; s < 2 * W8_XSTAGES; ++s) mbar_init(&xfull[s], 1);
    for (int s = 0; s < W8_WSTAGES; ++s) mbar_init(&wfull[s], 1);
    for (int u = 0; u < W8_USTAGES; ++u) {
      mbar_init(&ufull[u], W8_TT);
      mbar_init(&uempty[u], 256);
    }
    for (int b = 0; b < 2; ++b) mbar_init(&xbar[b], C * W8_LEADERS);
    mbar_fence_init();
  }
  __syncthreads();
  // every rank's barriers are initialised before any peer arrives on them
  if (FC1) cluster_sync_all();

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  if (warp >= 8) {
    // ---- transform warpgroups: raw weight tiles (TMA, WSTAGES ahead) into
    // K-major swizzled tiles ----
    regs_dealloc<48>();
    const int tid = threadIdx.x - 256;
    auto load_w = [&](int i) {
      unsigned char* slot = smem + Plan::W_OFF + (i % W8_WSTAGES) * Plan::T_BYTES;
      uint64_t* bar = &wfull[i % W8_WSTAGES];
      mbar_arrive_tx(bar, Plan::T_BYTES);
      tma_load_2d(slot, &wmap, bar, item_col(i / ktiles), (i % ktiles) * W8_KT);
    };
    if (tid == 0)
      for (int i = 0; i < W8_WSTAGES && i < total; ++i) load_w(i);
    const int c = tid & 7, rb = tid >> 3;  // 16-column chunk, 4-row block
    for (int i = 0; i < total; ++i) {
      const int s = i % W8_WSTAGES, u = i % W8_USTAGES;
      mbar_wait(&wfull[s], (i / W8_WSTAGES) & 1);
      if (i >= W8_USTAGES) mbar_wait(&uempty[u], ((i / W8_USTAGES) + 1) & 1);
      const unsigned char* raw = smem + Plan::W_OFF + s * Plan::T_BYTES;
      unsigned char* us = smem + Plan::U_OFF + u * Plan::T_BYTES;
      uint32_t w[4][4];
#pragma unroll
      for (int rr = 0; rr < 4; ++rr) {
        const uint4 v = *reinterpret_cast<const uint4*>(raw + (rb * 4 + rr) * W8_BN + c * 16);
        w[rr][0] = v.x;
        w[rr][1] = v.y;
        w[rr][2] = v.z;
        w[rr][3] = v.w;
      }
      const int kb = rb * 4;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        uint32_t t0[4];
        transpose4x4(w[0][j], w[1][j], w[2][j], w[3][j], t0);
#pragma unroll
        for (int b = 0; b < 4; ++b) {
          const int n = c * 16 + ((4 * j + b) ^ c);
          const int o = n * W8_KT + (((kb >> 4) ^ (n & 7)) << 4) + (kb & 15);
          *reinterpret_cast<uint32_t*>(us + o) = t0[b];
        }
      }
      fence_async_smem();
      mbar_arrive(&ufull[u]);
      named_barrier(1, W8_TT);  // the raw slot is read: refill it
      if (tid == 0 && i + W8_WSTAGES < total) load_w(i + W8_WSTAGES);
    }
    return;
  }

  regs_alloc<200>();
  const int wg = warp / 4, g = lane / 4, t = lane % 4;
  const int ct = threadIdx.x % 128;
  // this warpgroup's copy of its item's column scales (cv) and bias (cv +
  // 128): each thread loads one column's pair an item ahead, stores it at
  // the item's start, and the epilogue reads it after the mainloop's
  // named barriers
  float* cv = colv + wg * 2 * W8_BN;
  float next_s = 0.f, next_b = 0.f;
  auto fetch_columns = [&](int n0) {
    const int col = n0 + ct;
    next_s = col < p.N ? p.w_scale[col] : 0.f;
    next_b = col < p.N && p.bias != nullptr ? __bfloat162float(p.bias[col]) : 0.f;
  };
  auto stage_columns = [&]() {
    named_barrier(2 + wg, 128);  // the previous epilogue's reads are done
    cv[ct] = next_s;
    cv[W8_BN + ct] = next_b;
  };

  // ---- both warpgroups on each unit, 64 rows each ----
  const int lr = wg * 64 + (warp % 4) * 16 + g;  // this thread's rows: lr, lr + 8
  uint64_t* xf = xfull + wg * W8_XSTAGES;
  auto load_x = [&](int i) {
    unsigned char* xs = smem + Plan::X_OFF + ((i % W8_XSTAGES) * 2 + wg) * Plan::X_BYTES;
    mbar_arrive_tx(&xf[i % W8_XSTAGES], Plan::X_BYTES);
    tma_load_2d(xs, &xmap, &xf[i % W8_XSTAGES], (i % ktiles) * W8_KT,
                unit_row(i / span) * W8_BM + wg * 64);
  };
  if (ct == 0)
    for (int i = 0; i < W8_XSTAGES && i < total; ++i) load_x(i);
  // tile i's slots are free once the warpgroup's products have read them
  auto release = [&](int i) {
    mbar_arrive(&uempty[i % W8_USTAGES]);
    named_barrier(2 + wg, 128);
    if (ct == 0 && i + W8_XSTAGES < total) load_x(i + W8_XSTAGES);
  };
  // FC2 folds each bf-block's sums; FC1 takes one block over all of K
  const int blk_tiles = FC1 ? ktiles : p.bf / W8_KT;
  const int kblk = (p.K + p.bf - 1) / p.bf;

  int acc[64];
  float accf[64];
#pragma unroll
  for (int e = 0; e < 64; ++e) acc[e] = 0;
  float rmax[2] = {0.f, 0.f}, sc[2] = {1.f, 1.f};
  int pending = -1;
  fetch_columns(item_col(0));
  for (int it = 0; it < nunits * sub; ++it) {
    const int k = it / sub, q = it % sub;
    const int row0 = unit_row(k) * W8_BM + lr;
    const int r0 = min(row0, p.M - 1), r1 = min(row0 + 8, p.M - 1);
    const int n0 = item_col(it);
    stage_columns();
    if (it + 1 < nunits * sub) fetch_columns(item_col(it + 1));
    if (!FC1) {
#pragma unroll
      for (int e = 0; e < 64; ++e) accf[e] = 0.f;
    }
    for (int kt = 0; kt < ktiles; ++kt) {
      const int i = it * ktiles + kt;
      const int s = i % W8_XSTAGES, u = i % W8_USTAGES;
      mbar_wait(&xf[s], (i / W8_XSTAGES) & 1);
      mbar_wait(&ufull[u], (i / W8_USTAGES) & 1);
      const unsigned char* xa = smem + Plan::X_OFF + (s * 2 + wg) * Plan::X_BYTES;
      const unsigned char* ub = smem + Plan::U_OFF + u * Plan::T_BYTES;
      const bool first = kt % blk_tiles == 0;
      fence_regs(acc);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < W8_KT / 32; ++kk)
        wgmma_s8_ss_n128(acc, smem_desc(xa + kk * 32, 16, 1024),
                         smem_desc(ub + kk * 32, 16, 1024), kk > 0 || !first);
      wgmma_commit();
      if ((kt + 1) % blk_tiles == 0 || kt == ktiles - 1) {
        // the block's integer sums are complete
        wgmma_wait<0>();
        fence_regs(acc);
        if (pending >= 0) release(pending);
        release(i);
        pending = -1;
        if (!FC1) {
          const int b = kt / blk_tiles;
          const float h0 = p.blk_scale[static_cast<long long>(r0) * kblk + b];
          const float h1 = p.blk_scale[static_cast<long long>(r1) * kblk + b];
#pragma unroll
          for (int e = 0; e < 64; ++e)
            accf[e] += static_cast<float>(acc[e]) * ((e & 2) ? h1 : h0);
        }
      } else {
        wgmma_wait<1>();  // the previous tile's products have landed
        fence_regs(acc);
        if (pending >= 0) release(pending);
        pending = i;
      }
    }
    // accumulator j * 4 + e: row lr (+ 8 for e >= 2), column n of the
    // wgmma, tile column n ^ ((n >> 4) & 7)
    if constexpr (!FC1) {
#pragma unroll
      for (int j = 0; j < 16; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int row = row0 + ((e & 2) ? 8 : 0);
          const int nn = j * 8 + 2 * t + (e & 1);
          const int tc = nn ^ ((nn >> 4) & 7);
          const int col = n0 + tc;
          if (row >= p.M || col >= p.N) continue;
          const float y0 = accf[j * 4 + e] * cv[tc];
          float y = p.bias != nullptr ? y0 + cv[W8_BN + tc] : y0;
          const long long o = static_cast<long long>(row) * p.N + col;
          if (p.ws != nullptr) {
            p.ws[o] = y;
          } else {
            if (p.residual != nullptr) y += __bfloat162float(p.residual[o]);
            p.out[o] = __float2bfloat16(y);
          }
        }
    } else {
      // v = gelu_as((s * sx) * s1 + b1), in the twin's order
      const float sx0 = p.row_scale[r0], sx1 = p.row_scale[r1];
      float v[64];
#pragma unroll
      for (int j = 0; j < 16; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int nn = j * 8 + 2 * t + (e & 1);
          const int tc = nn ^ ((nn >> 4) & 7);
          // past F the scale and bias are 0: gelu(0) = 0 moves no maximum
          float y = __fmul_rn(__fmul_rn(static_cast<float>(acc[j * 4 + e]), (e & 2) ? sx1 : sx0),
                              cv[tc]);
          if (p.bias != nullptr) y = __fadd_rn(y, cv[W8_BN + tc]);
          v[j * 4 + e] = gelu_as_mufu(y);
        }
      if (q == 0) rmax[0] = rmax[1] = 0.f;
      if (q < T) {
#pragma unroll
        for (int e = 0; e < 64; ++e)
          rmax[(e >> 1) & 1] = fmaxf(rmax[(e >> 1) & 1], fabsf(v[e]));
      }
      if (q == T - 1) {
        // the cluster's row maxima over the whole hidden block: each row's
        // leader (t == 0) sends its maximum to every rank and arrives on
        // that rank's barrier; each rank waits for all of them. A peer is
        // at most one unit ahead (it waits for this rank's maxima of the
        // next), so two buffers take turns.
        const int b = k & 1;
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          rmax[h] = fmaxf(rmax[h], __shfl_xor_sync(0xffffffffu, rmax[h], 1));
          rmax[h] = fmaxf(rmax[h], __shfl_xor_sync(0xffffffffu, rmax[h], 2));
        }
        if (t == 0) {
          float* mine = xred + (b * W8_MAX_CLUSTER + rank) * W8_BM + lr;
          for (int r = 0; r < C; ++r) {
            const uint32_t dst = peer_addr(mine, r);
            peer_store(dst, rmax[0]);
            peer_store(dst + 32, rmax[1]);  // row lr + 8
            peer_arrive(peer_addr(&xbar[b], r));
          }
        }
        mbar_wait_cluster(&xbar[b], (k >> 1) & 1);
        float mx[2] = {0.f, 0.f};
        for (int r = 0; r < C; ++r) {
          const float* theirs = xred + (b * W8_MAX_CLUSTER + r) * W8_BM + lr;
          mx[0] = fmaxf(mx[0], theirs[0]);
          mx[1] = fmaxf(mx[1], theirs[8]);
        }
#pragma unroll
        for (int h = 0; h < 2; ++h) sc[h] = fmaxf(mx[h] * (1.f / 127.f), 1e-8f);
        if (rank == 0 && t == 0) {
          const int jb = unit_jb(k);
          if (row0 < p.M) p.hs[static_cast<long long>(row0) * nblk + jb] = sc[0];
          if (row0 + 8 < p.M) p.hs[static_cast<long long>(row0 + 8) * nblk + jb] = sc[1];
        }
      }
      if (T == 1 || q >= T) {
        // quantize: two neighbouring wgmma columns are one 2-byte pair of
        // the tile (swapped when the swizzle's xor is odd)
#pragma unroll
        for (int j = 0; j < 16; ++j) {
          const int x = (j >> 1) & 7;
          const int col = n0 + ((j * 8 + 2 * t) ^ (x & 6));
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int row = row0 + 8 * h;
            if (row >= p.M || col >= p.N) continue;
            const uint32_t a0 = static_cast<uint8_t>(i8_quant(v[j * 4 + 2 * h], sc[h]));
            const uint32_t a1 = static_cast<uint8_t>(i8_quant(v[j * 4 + 2 * h + 1], sc[h]));
            const uint16_t pair =
                static_cast<uint16_t>((x & 1) ? (a1 | (a0 << 8)) : (a0 | (a1 << 8)));
            *reinterpret_cast<uint16_t*>(p.hq + static_cast<long long>(row) * p.N + col) = pair;
          }
        }
      }
    }
  }
}

// The cluster of FC1 for hidden blocks of bf columns: the largest divisor
// of bf / 128 that is at most W8_MAX_CLUSTER (ops/fused_mlp.py:
// w8a8_plan computes the same and passes it down).
inline int w8a8_cluster(int bf) {
  const int tiles = bf / W8_BN;
  for (int c = W8_MAX_CLUSTER; c > 1; --c)
    if (tiles % c == 0) return c;
  return 1;
}

// The clusters of `cluster` FC1 blocks the card holds at once (the
// persistent wave's size), or 0 when the runtime refuses the query.
inline int w8a8_fc1_clusters(int cluster) {
  auto kern = w8a8_gemm_kernel<true>;
  if (cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, W8Plan::SMEM) !=
      cudaSuccess)
    return 0;
  cudaLaunchConfig_t cfg = {};
  cfg.blockDim = dim3(W8Plan::THREADS, 1, 1);
  cfg.dynamicSmemBytes = W8Plan::SMEM;
  cfg.gridDim = dim3(cluster, 1, 1);
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  int active = 0;
  return cudaOccupancyMaxActiveClusters(&active, kern, &cfg) == cudaSuccess ? active : 0;
}

// x [M, K] int8 and w [K, N] int8 (N-major) through their tensor maps; FC1
// launches one wave of clusters of p.cluster blocks.
template <bool FC1>
cudaError_t launch_w8a8(const int8_t* x, const int8_t* w, const W8Args& p, cudaStream_t s) {
  auto kern = w8a8_gemm_kernel<FC1>;
  // set before the tensor maps: it makes the card's context current on this
  // thread, which the encoder needs
  cudaError_t err =
      cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, W8Plan::SMEM);
  if (err != cudaSuccess) return err;
  CUtensorMap xmap, wmap;
  const uint64_t xdims[2] = {static_cast<uint64_t>(p.K), static_cast<uint64_t>(p.M)};
  const uint64_t xstr[1] = {static_cast<uint64_t>(p.K)};
  const uint32_t xbox[2] = {W8_KT, 64};  // one warpgroup's rows
  const uint64_t wdims[2] = {static_cast<uint64_t>(p.N), static_cast<uint64_t>(p.K)};
  const uint64_t wstr[1] = {static_cast<uint64_t>(p.N)};
  const uint32_t wbox[2] = {W8_BN, W8_KT};
  if (!make_map(&xmap, CU_TENSOR_MAP_DATA_TYPE_UINT8, 2, x, xdims, xstr, xbox) ||
      !make_map(&wmap, CU_TENSOR_MAP_DATA_TYPE_UINT8, 2, w, wdims, wstr, wbox, false))
    return cudaErrorInvalidValue;
  W8Args a = p;
  a.row_tiles = (p.M + W8_BM - 1) / W8_BM;
  cudaLaunchConfig_t cfg = {};
  cfg.blockDim = dim3(W8Plan::THREADS, 1, 1);
  cfg.dynamicSmemBytes = W8Plan::SMEM;
  cfg.stream = s;
  cudaLaunchAttribute attr[1];
  if (FC1) {
    // one wave of clusters: as many as the card holds at once, each
    // walking the (row tile, hidden block) units with that stride
    const int active = w8a8_fc1_clusters(p.cluster);
    if (active < 1) return cudaErrorInvalidConfiguration;
    const int units = (p.N + p.bf - 1) / p.bf * a.row_tiles;
    a.clusters = active < units ? active : units;
    cfg.gridDim = dim3(a.clusters * p.cluster, 1, 1);
    attr[0].id = cudaLaunchAttributeClusterDimension;
    attr[0].val.clusterDim.x = p.cluster;
    attr[0].val.clusterDim.y = 1;
    attr[0].val.clusterDim.z = 1;
    cfg.attrs = attr;
    cfg.numAttrs = 1;
  } else {
    cfg.gridDim = dim3((p.N + W8_BN - 1) / W8_BN, a.row_tiles, 1);
  }
  err = cudaLaunchKernelEx(&cfg, kern, xmap, wmap, a);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

}  // namespace
