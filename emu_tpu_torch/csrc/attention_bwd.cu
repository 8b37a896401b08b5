// The recompute-based flash-attention backward over head-major [B, H, S, D]
// bf16 views, built for Hopper: two kernels, dQ and dK/dV.
//
// Replaces the TPU kernels of emu_tpu/ops/flash_attention.py's _flash_diff
// backward: _flash_bwd_whole (_dq_kernel_whole, _dkv_kernel_whole) and
// _flash_bwd_tiled (_dq_kernel_tiled, _dkv_kernel_tiled). The TPU's split
// into a whole-KV and a tiled tier is a VMEM artefact; here one tiled design
// covers both, and skips the causal tiles right of the diagonal at every
// length. The contract (flash_attention.py:634-647), with S = scale * Q K^T
// recomputed tile by tile and L the forward's per-row log-sum-exp:
//   D  = rowsum(dO o O)
//   P  = exp(S - L) where the column is kept, else 0
//   dV = P^T dO,  dS = P o (dO V^T - D),  dQ = dS K * scale,
//   dK = dS^T Q * scale.
// "Kept" is the forward's mask: the end-aligned causal diagonal, kv_valid,
// columns before Skv and rows before Sq. A fully masked row (a left-pad query)
// keeps no column, so P is 0 there from the mask (never from exp(S - L)) and
// its gradients are zero and finite, as the TPU kernels' `keep` makes them.
// P and dS are rounded to bf16 before their products, as the twin rounds them.
//
// Why two kernels: the dQ kernel walks K/V for a block of query rows, the
// dK/dV kernel walks Q/dO for a block of keys, and each owns the rows it
// writes, so no sum crosses blocks: no atomics, and dQ, dK and dV are the
// same bits on every run. The price is that both recompute S and dP: seven
// S x S x D products instead of the five a fused backward with atomic dQ
// sums needs.
//
// GQA: q head h reads kv head h / rep. The dK/dV block of a kv head walks all
// rep query heads of its group and sums them in its own fp32 accumulators.
//
// What bounds it on an H100: at the train shapes (Sq = Skv = 1024, D = 128)
// the seven products (half of them under the causal skip) against about
// 1 MB of inputs per (batch, head): operations, at 989 TFLOP/s bf16. The
// design keeps every product on wgmma fed by TMA, and every S, P, dS and
// gradient tile in registers:
//
// dQ kernel (128 query rows of one (b, h) a block; 384 threads):
// - one warp of a producer warpgroup (its registers handed to the consumers
//   with setmaxnreg: at 288 threads, a lone producer warp, ptxas spilled the
//   consumers at 166 registers) loads the Q and dO tiles once and keeps K/V
//   tiles of 64 keys in flight through TMA, 4 deep behind mbarriers, with
//   the tile's kv_valid column states (and whether all attend) beside them;
// - the two consumer warpgroups (64 rows each) first sum D = rowsum(dO o O)
//   of their rows in fp32 from 16-byte loads and write it to `dvec` for the
//   dK/dV kernel, launched after this one on the same stream;
// - per tile, S = Q K^T and dP = dO V^T are SS wgmmas; P = exp2(S * scale *
//   log2 e - L * log2 e) and dS = P o (dP - D) run on the accumulator
//   registers, the mask only on the tiles that need it (a causal diagonal, a
//   sequence end, an invalid key); dS becomes the bf16 register A operand of
//   dQ += dS K, read N-major (the transposed-B form), and that product is
//   in flight while the next tile's S and dS run. dQ stays in registers.
//
// dK/dV kernel (128 keys of one (b, kv head) a block; 384 threads):
// - K and V land once; a producer warpgroup (its registers handed to the
//   consumers with setmaxnreg) streams Q and dO tiles of 64 query rows with
//   their L * log2 e and D, 4 deep;
// - per tile, S^T = K Q^T and dP^T = V dO^T are SS wgmmas, P^T and dS^T
//   are computed on their registers, and dV += P^T dO, dK += dS^T Q are
//   register-A wgmmas; dK and dV (64 + 64 fp32 a thread at D = 128) stay in
//   registers.
//
// Tensor maps span each view's four dims at its own strides with an inner
// extent of D and boxes of 64 columns, so TMA zero-fills the pad of D up to
// DP (64 or 128) and the rows past the sequence ends. Under the causal mask
// the blocks' work differs by up to the sequence's length in tiles; the
// grid puts the heads on x, so every head's longest blocks (the last query
// rows for dQ, the first keys for dK/dV) are dispatched first.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

#include "attention_tiles.cuh"

namespace {

constexpr int BQ = 128;    // dQ kernel: query rows per block (two warpgroups)
constexpr int BKV = 128;   // dK/dV kernel: keys per block (two warpgroups)
constexpr int BT = 64;     // rows of a streamed tile: K/V for dQ, Q/dO for dK/dV
constexpr int STAGES = 4;  // the dQ kernel holds two stages while the next lands
constexpr int DQ_THREADS = 3 * 128;
constexpr int DKV_THREADS = 3 * 128;
constexpr float LOG2E = 1.4426950408889634f;

struct BwdArgs {
  const __nv_bfloat16* o;
  const __nv_bfloat16* dout;
  const float* lse;               // [B, H, Sq]
  float* dvec;                    // [B, H, Sq]: D, written by dQ, read by dK/dV
  const unsigned char* kv_valid;  // [B, Skv] (0 = masked) or null
  __nv_bfloat16* dq;
  __nv_bfloat16* dk;
  __nv_bfloat16* dv;
  long long o_sb, o_sh, o_ss;
  long long do_sb, do_sh, do_ss;
  long long dq_sb, dq_sh, dq_ss;
  long long dk_sb, dk_sh, dk_ss;
  long long dv_sb, dv_sh, dv_ss;
  int H, rep, Sq, Skv, D;
  float scale;
  int causal;
};

// dQ kernel's shared memory: Q and dO [DP/64][BQ][64], each stage's K and V
// [DP/64][BT][64] (bf16, rows of 128 bytes in the 128-byte swizzle), each
// stage's column states and all-attend flag, the rows' L * log2 e and D,
// the barriers.
template <int DP>
struct DqPlan {
  static constexpr int CHUNKS = DP / 64;
  static constexpr int Q_BYTES = CHUNKS * BQ * 128;  // one of Q, dO
  static constexpr int T_BYTES = CHUNKS * BT * 128;  // one of K, V
  static constexpr int STAGE_BYTES = 2 * T_BYTES;
  static constexpr int COL_STRIDE = BT + 16;
  static constexpr int COL_OFF = 2 * Q_BYTES + STAGES * STAGE_BYTES;
  static constexpr int ROW_OFF = COL_OFF + STAGES * COL_STRIDE;
  static constexpr int BAR_OFF = ROW_OFF + 2 * BQ * 4;
  static constexpr int SMEM = BAR_OFF + 8 * (1 + 2 * STAGES) + 1024;
};

// dK/dV kernel's shared memory: K and V [DP/64][BKV][64], each stage's Q and
// dO [DP/64][BT][64] and its rows' L * log2 e and D, the barriers.
template <int DP>
struct DkvPlan {
  static constexpr int CHUNKS = DP / 64;
  static constexpr int KV_BYTES = CHUNKS * BKV * 128;  // one of K, V
  static constexpr int T_BYTES = CHUNKS * BT * 128;    // one of Q, dO
  static constexpr int STAGE_BYTES = 2 * T_BYTES;
  static constexpr int ROW_OFF = 2 * KV_BYTES + STAGES * STAGE_BYTES;
  static constexpr int BAR_OFF = ROW_OFF + STAGES * 2 * BT * 4;
  static constexpr int SMEM = BAR_OFF + 8 * (1 + 2 * STAGES) + 1024;
};

__device__ __forceinline__ unsigned char* align1024(unsigned char* p) {
  return reinterpret_cast<unsigned char*>((reinterpret_cast<uintptr_t>(p) + 1023) &
                                          ~static_cast<uintptr_t>(1023));
}

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// s[64 x BT] = A[64 x DP] . B[BT x DP]^T, both K-major in shared memory:
// `a` at the warpgroup's first row of a tile of `a_rows` rows, `b` a tile of
// BT rows; every 16-deep step of the padded width (the pad is zeros), one
// commit group.
template <int DP>
__device__ __forceinline__ void issue_rows(float (&s)[BT / 2], const unsigned char* a,
                                           int a_rows, const unsigned char* b) {
#pragma unroll
  for (int kk = 0; kk < DP / 16; ++kk) {
    const int aoff = (kk / 4) * a_rows * 128 + (kk % 4) * 32;
    const int boff = (kk / 4) * BT * 128 + (kk % 4) * 32;
    qk_wgmma<BT>(s, smem_desc(a + aoff, 16, 1024), smem_desc(b + boff, 16, 1024), kk > 0);
  }
  wgmma_commit();
}

// acc[64 x DP] += A[64 x BT] (bf16 registers) . B[BT x DP], the tile `b`
// read N-major; not committed.
template <int DP>
__device__ __forceinline__ void issue_acc(float (&acc)[DP / 2], const uint32_t (&a)[BT / 16][4],
                                          const unsigned char* b) {
#pragma unroll
  for (int kk = 0; kk < BT / 16; ++kk)
    pv_wgmma<DP, BT>(acc, a[kk], smem_desc(b + kk * 16 * 128, BT * 128, 1024));
}

__device__ __forceinline__ void fence_frag(uint32_t (&f)[BT / 16][4]) {
#pragma unroll
  for (int kk = 0; kk < BT / 16; ++kk) fence_regs(f[kk]);
}

// One (b, h) row block's gradient rows into [B, S, H, D]-strided memory:
// rows below `rows_end`, columns below D, times `mul`.
template <int DP>
__device__ __forceinline__ void store_rows(__nv_bfloat16* p, long long ss, const float (&acc)[DP / 2],
                                           int row0, int rows_end, int D, int t, float mul) {
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = row0 + 8 * r;
    if (row >= rows_end) continue;
#pragma unroll
    for (int j = 0; j < DP / 8; ++j) {
      const int col = j * 8 + 2 * t;
      if (col >= D) continue;
      *reinterpret_cast<__nv_bfloat162*>(p + row * ss + col) =
          __floats2bfloat162_rn(acc[j * 4 + 2 * r] * mul, acc[j * 4 + 2 * r + 1] * mul);
    }
  }
}

template <int DP>
__global__ void __launch_bounds__(DQ_THREADS, 1)
    dq_kernel(const __grid_constant__ CUtensorMap qmap, const __grid_constant__ CUtensorMap domap,
              const __grid_constant__ CUtensorMap kmap, const __grid_constant__ CUtensorMap vmap,
              const BwdArgs a) {
  using Plan = DqPlan<DP>;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = align1024(smem_raw);
  unsigned char* qs = smem;
  unsigned char* dos = smem + Plan::Q_BYTES;
  unsigned char* kv0 = smem + 2 * Plan::Q_BYTES;
  unsigned char* cols = smem + Plan::COL_OFF;
  float* lrow = reinterpret_cast<float*>(smem + Plan::ROW_OFF);
  float* drow = lrow + BQ;
  uint64_t* qfull = reinterpret_cast<uint64_t*>(smem + Plan::BAR_OFF);
  uint64_t* full = qfull + 1;
  uint64_t* empty = full + STAGES;

  // the longest blocks (the last rows under the causal mask) first
  const int q0 = (gridDim.y - 1 - blockIdx.y) * BQ;
  const int h = blockIdx.x;
  const int b = blockIdx.z;
  const int hk = h / a.rep;
  const int diag = a.Skv - a.Sq;
  const bool kv = a.kv_valid != nullptr;
  int n_tiles = (a.Skv + BT - 1) / BT;
  if (a.causal) {
    const int last_col = q0 + BQ - 1 + diag;
    n_tiles = min(n_tiles, last_col < 0 ? 0 : last_col / BT + 1);
  }

  if (threadIdx.x == 0) {
    mbar_init(qfull, 1);
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(&full[s], 1 + (kv ? 32 : 0));
      mbar_init(&empty[s], 256);
    }
    mbar_fence_init();
  }
  __syncthreads();

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  if (warp >= 8) {
    // ---- producer warpgroup: one warp issues every copy ----
    regs_dealloc<24>();
    if (warp != 8) return;
    if (lane == 0) {
      mbar_arrive_tx(qfull, 2 * Plan::Q_BYTES);
      for (int c = 0; c < Plan::CHUNKS; ++c) {
        tma_load_4d(qs + c * BQ * 128, &qmap, qfull, c * 64, q0, h, b);
        tma_load_4d(dos + c * BQ * 128, &domap, qfull, c * 64, q0, h, b);
      }
    }
    for (int i = 0; i < n_tiles; ++i) {
      const int s = i % STAGES;
      if (i >= STAGES) mbar_wait(&empty[s], ((i / STAGES) + 1) & 1);
      unsigned char* ks = kv0 + s * Plan::STAGE_BYTES;
      const int j0 = i * BT;
      if (lane == 0) {
        mbar_arrive_tx(&full[s], Plan::STAGE_BYTES);
        for (int c = 0; c < Plan::CHUNKS; ++c) {
          tma_load_4d(ks + c * BT * 128, &kmap, &full[s], c * 64, j0, hk, b);
          tma_load_4d(ks + Plan::T_BYTES + c * BT * 128, &vmap, &full[s], c * 64, j0, hk, b);
        }
      }
      if (kv) {
        // 1 attend, 0 masked or past Skv; then whether all 64 attend
        unsigned char* st = cols + s * Plan::COL_STRIDE;
        bool all = true;
        for (int c = lane; c < BT; c += 32) {
          const int j = j0 + c;
          const bool ok = j < a.Skv && a.kv_valid[static_cast<long long>(b) * a.Skv + j];
          st[c] = ok;
          all = all && ok;
        }
        all = __all_sync(0xffffffffu, all);
        if (lane == 0) st[BT] = all;
        mbar_arrive(&full[s]);
      }
    }
    return;
  }
  regs_alloc<240>();

  // ---- consumer warpgroups: 64 query rows each ----
  const int wg = warp / 4, g = lane / 4, t = lane % 4;
  {
    // D = rowsum(dO o O) in fp32, two threads a row, 16-byte loads; L * log2 e
    const int tid = threadIdx.x % 128, rl = tid >> 1, part = tid & 1;
    const int row = q0 + wg * 64 + rl;
    float sum = 0.f;
    if (row < a.Sq) {
      const __nv_bfloat16* op = a.o + b * a.o_sb + h * a.o_sh + row * a.o_ss;
      const __nv_bfloat16* dp = a.dout + b * a.do_sb + h * a.do_sh + row * a.do_ss;
      for (int c = part * 8; c < a.D; c += 16) {
        const uint4 ov = *reinterpret_cast<const uint4*>(op + c);
        const uint4 dv = *reinterpret_cast<const uint4*>(dp + c);
        const __nv_bfloat162* o2 = reinterpret_cast<const __nv_bfloat162*>(&ov);
        const __nv_bfloat162* d2 = reinterpret_cast<const __nv_bfloat162*>(&dv);
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          const float2 of = __bfloat1622float2(o2[u]), df = __bfloat1622float2(d2[u]);
          sum = fmaf(of.x, df.x, sum);
          sum = fmaf(of.y, df.y, sum);
        }
      }
    }
    sum += __shfl_xor_sync(0xffffffffu, sum, 1);
    if (part == 0) {
      const long long idx = (static_cast<long long>(b) * a.H + h) * a.Sq + row;
      drow[wg * 64 + rl] = sum;
      lrow[wg * 64 + rl] = row < a.Sq ? a.lse[idx] * LOG2E : 0.f;
      if (row < a.Sq) a.dvec[idx] = sum;
    }
    named_barrier(1 + wg, 128);
  }
  const int wrow = q0 + wg * 64 + (warp % 4) * 16;  // this warp's first row
  const int rows[2] = {wrow + g, wrow + g + 8};
  float l2[2], dd[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l2[r] = lrow[rows[r] - q0];
    dd[r] = drow[rows[r] - q0];
  }
  const float sl2 = a.scale * LOG2E;
  const unsigned char* qa = qs + wg * 64 * 128;
  const unsigned char* doa = dos + wg * 64 * 128;

  float dq[DP / 2];
#pragma unroll
  for (int i = 0; i < DP / 2; ++i) dq[i] = 0.f;
  uint32_t dsa[BT / 16][4];  // dS of the previous tile: the A operand in flight
#pragma unroll
  for (int kk = 0; kk < BT / 16; ++kk)
#pragma unroll
    for (int e = 0; e < 4; ++e) dsa[kk][e] = 0u;

  mbar_wait(qfull, 0);
  for (int i = 0; i < n_tiles; ++i) {
    const int s = i % STAGES;
    const int j0 = i * BT;
    const unsigned char* ks = kv0 + s * Plan::STAGE_BYTES;
    const unsigned char* st = cols + s * Plan::COL_STRIDE;
    mbar_wait(&full[s], (i / STAGES) & 1);

    float sacc[BT / 2], pacc[BT / 2];
    fence_acc(sacc);
    fence_acc(pacc);
    fence_acc(dq);
    fence_frag(dsa);
    wgmma_fence();
    issue_rows<DP>(sacc, qa, BQ, ks);                   // S_i = Q K_i^T
    issue_rows<DP>(pacc, doa, BQ, ks + Plan::T_BYTES);  // dP_i = dO V_i^T
    if (i > 0) {
      // dQ += dS_{i-1} K_{i-1}, in flight during this tile's dS
      issue_acc<DP>(dq, dsa, kv0 + ((i - 1) % STAGES) * Plan::STAGE_BYTES);
      wgmma_commit();
      wgmma_wait<1>();
    } else {
      wgmma_wait<0>();
    }
    fence_acc(sacc);
    fence_acc(pacc);

    const bool need = (kv && !st[BT]) || j0 + BT > a.Skv || wrow + 15 >= a.Sq ||
                      (a.causal && j0 + BT - 1 > wrow + diag);
    uint32_t dsn[BT / 16][4];
#pragma unroll
    for (int j = 0; j < BT / 8; ++j) {
      float v[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = e >> 1;
        float p = ex2(fmaf(sacc[j * 4 + e], sl2, -l2[r]));
        if (need) {
          const int c = j * 8 + 2 * t + (e & 1);
          const int col = j0 + c;
          const bool ok = (kv ? st[c] != 0 : col < a.Skv) && rows[r] < a.Sq &&
                          !(a.causal && col > rows[r] + diag);
          p = ok ? p : 0.f;
        }
        v[e] = p * (pacc[j * 4 + e] - dd[r]);
      }
      dsn[j / 2][(j % 2) * 2 + 0] = pack_bf16(v[0], v[1]);
      dsn[j / 2][(j % 2) * 2 + 1] = pack_bf16(v[2], v[3]);
    }
    if (i > 0) {
      wgmma_wait<0>();  // dS_{i-1} K_{i-1} has landed: its stage is free
      fence_acc(dq);
      fence_frag(dsa);
      mbar_arrive(&empty[(i - 1) % STAGES]);
    }
#pragma unroll
    for (int kk = 0; kk < BT / 16; ++kk)
#pragma unroll
      for (int e = 0; e < 4; ++e) dsa[kk][e] = dsn[kk][e];
  }
  if (n_tiles > 0) {
    fence_acc(dq);
    fence_frag(dsa);
    wgmma_fence();
    issue_acc<DP>(dq, dsa, kv0 + ((n_tiles - 1) % STAGES) * Plan::STAGE_BYTES);
    wgmma_commit();
    wgmma_wait<0>();
    fence_acc(dq);
  }
  store_rows<DP>(a.dq + b * a.dq_sb + h * a.dq_sh, a.dq_ss, dq, rows[0], a.Sq, a.D, t, a.scale);
}

template <int DP>
__global__ void __launch_bounds__(DKV_THREADS, 1)
    dkv_kernel(const __grid_constant__ CUtensorMap qmap, const __grid_constant__ CUtensorMap domap,
               const __grid_constant__ CUtensorMap kmap, const __grid_constant__ CUtensorMap vmap,
               const BwdArgs a) {
  using Plan = DkvPlan<DP>;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = align1024(smem_raw);
  unsigned char* ks = smem;
  unsigned char* vs = smem + Plan::KV_BYTES;
  unsigned char* t0 = smem + 2 * Plan::KV_BYTES;
  float* rowv = reinterpret_cast<float*>(smem + Plan::ROW_OFF);
  uint64_t* kvfull = reinterpret_cast<uint64_t*>(smem + Plan::BAR_OFF);
  uint64_t* full = kvfull + 1;
  uint64_t* empty = full + STAGES;

  const int j0 = blockIdx.y * BKV;
  const int hk = blockIdx.x;
  const int b = blockIdx.z;
  const int diag = a.Skv - a.Sq;
  const int n_q = (a.Sq + BT - 1) / BT;
  // the first query tile holding a row that sees key j0 under the causal mask
  int t_first = 0;
  if (a.causal) {
    const int first_row = j0 - diag;
    t_first = first_row <= 0 ? 0 : min(first_row / BT, n_q);
  }
  const int per_head = n_q - t_first;
  const int n_tiles = a.rep * per_head;

  if (threadIdx.x == 0) {
    mbar_init(kvfull, 1);
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(&full[s], 1 + 32);
      mbar_init(&empty[s], 256);
    }
    mbar_fence_init();
  }
  __syncthreads();

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  if (warp >= 8) {
    // ---- producer warpgroup: one warp issues every copy ----
    regs_dealloc<24>();
    if (warp == 8) {
      if (lane == 0) {
        mbar_arrive_tx(kvfull, 2 * Plan::KV_BYTES);
        for (int c = 0; c < Plan::CHUNKS; ++c) {
          tma_load_4d(ks + c * BKV * 128, &kmap, kvfull, c * 64, j0, hk, b);
          tma_load_4d(vs + c * BKV * 128, &vmap, kvfull, c * 64, j0, hk, b);
        }
      }
      for (int i = 0; i < n_tiles; ++i) {
        const int h = hk * a.rep + i / per_head;
        const int i0 = (t_first + i % per_head) * BT;
        const int s = i % STAGES;
        if (i >= STAGES) mbar_wait(&empty[s], ((i / STAGES) + 1) & 1);
        unsigned char* st = t0 + s * Plan::STAGE_BYTES;
        if (lane == 0) {
          mbar_arrive_tx(&full[s], Plan::STAGE_BYTES);
          for (int c = 0; c < Plan::CHUNKS; ++c) {
            tma_load_4d(st + c * BT * 128, &qmap, &full[s], c * 64, i0, h, b);
            tma_load_4d(st + Plan::T_BYTES + c * BT * 128, &domap, &full[s], c * 64, i0, h, b);
          }
        }
        float* lr = rowv + s * 2 * BT;
        const long long base = (static_cast<long long>(b) * a.H + h) * a.Sq;
        for (int c = lane; c < BT; c += 32) {
          const int qi = i0 + c;
          lr[c] = qi < a.Sq ? a.lse[base + qi] * LOG2E : 0.f;
          lr[BT + c] = qi < a.Sq ? a.dvec[base + qi] : 0.f;
        }
        mbar_arrive(&full[s]);
      }
    }
    return;
  }
  regs_alloc<240>();

  // ---- consumer warpgroups: 64 keys each ----
  const int wg = warp / 4, g = lane / 4, t = lane % 4;
  const int wkey = j0 + wg * 64 + (warp % 4) * 16;  // this warp's first key
  const int keys[2] = {wkey + g, wkey + g + 8};
  bool kok[2];
#pragma unroll
  for (int r = 0; r < 2; ++r)
    kok[r] = keys[r] < a.Skv &&
             (a.kv_valid == nullptr || a.kv_valid[static_cast<long long>(b) * a.Skv + keys[r]]);
  const bool keys_all = __all_sync(0xffffffffu, kok[0] && kok[1]);
  const float sl2 = a.scale * LOG2E;
  const unsigned char* ka = ks + wg * 64 * 128;
  const unsigned char* va = vs + wg * 64 * 128;

  float dk[DP / 2], dv[DP / 2];
#pragma unroll
  for (int i = 0; i < DP / 2; ++i) {
    dk[i] = 0.f;
    dv[i] = 0.f;
  }

  mbar_wait(kvfull, 0);
  for (int i = 0; i < n_tiles; ++i) {
    const int i0 = (t_first + i % per_head) * BT;
    const int s = i % STAGES;
    const unsigned char* qt = t0 + s * Plan::STAGE_BYTES;
    const unsigned char* dot = qt + Plan::T_BYTES;
    const float* lr = rowv + s * 2 * BT;
    mbar_wait(&full[s], (i / STAGES) & 1);

    float sacc[BT / 2], pacc[BT / 2];
    fence_acc(sacc);
    fence_acc(pacc);
    wgmma_fence();
    issue_rows<DP>(sacc, ka, BKV, qt);   // S^T = K Q^T
    issue_rows<DP>(pacc, va, BKV, dot);  // dP^T = V dO^T
    wgmma_wait<0>();
    fence_acc(sacc);
    fence_acc(pacc);

    const bool need = !keys_all || i0 + BT > a.Sq || (a.causal && wkey + 15 > i0 + diag);
    uint32_t pa[BT / 16][4], dsa[BT / 16][4];
#pragma unroll
    for (int j = 0; j < BT / 8; ++j) {
      const int c = j * 8 + 2 * t;
      const float2 lv = *reinterpret_cast<const float2*>(lr + c);
      const float2 dv2 = *reinterpret_cast<const float2*>(lr + BT + c);
      float pv[4], dsv[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float lq = (e & 1) ? lv.y : lv.x;
        const float dq_ = (e & 1) ? dv2.y : dv2.x;
        float p = ex2(fmaf(sacc[j * 4 + e], sl2, -lq));
        if (need) {
          const int r = e >> 1;
          const int qi = i0 + c + (e & 1);
          const bool ok = kok[r] && qi < a.Sq && !(a.causal && keys[r] > qi + diag);
          p = ok ? p : 0.f;
        }
        pv[e] = p;
        dsv[e] = p * (pacc[j * 4 + e] - dq_);
      }
      pa[j / 2][(j % 2) * 2 + 0] = pack_bf16(pv[0], pv[1]);
      pa[j / 2][(j % 2) * 2 + 1] = pack_bf16(pv[2], pv[3]);
      dsa[j / 2][(j % 2) * 2 + 0] = pack_bf16(dsv[0], dsv[1]);
      dsa[j / 2][(j % 2) * 2 + 1] = pack_bf16(dsv[2], dsv[3]);
    }

    fence_acc(dk);
    fence_acc(dv);
    fence_frag(pa);
    fence_frag(dsa);
    wgmma_fence();
    issue_acc<DP>(dv, pa, dot);  // dV += P^T dO
    issue_acc<DP>(dk, dsa, qt);  // dK += dS^T Q
    wgmma_commit();
    wgmma_wait<0>();
    fence_acc(dk);
    fence_acc(dv);
    fence_frag(pa);
    fence_frag(dsa);
    mbar_arrive(&empty[s]);
  }

  store_rows<DP>(a.dk + b * a.dk_sb + hk * a.dk_sh, a.dk_ss, dk, keys[0], a.Skv, a.D, t, a.scale);
  store_rows<DP>(a.dv + b * a.dv_sb + hk * a.dv_sh, a.dv_ss, dv, keys[0], a.Skv, a.D, t, 1.f);
}

// q, k, v, dout: the tensor-mapped inputs; st: the 24 strides. The
// shared-memory attribute is set first: that runtime call binds the card's
// context to the calling thread (autograd runs the backward on a thread of
// its own), which cuTensorMapEncodeTiled needs.
template <int DP>
cudaError_t launch_bwd(bool dkv, const void* q, const void* k, const void* v, const void* dout,
                       const BwdArgs& a, const long long* st, int B, int Hkv,
                       cudaStream_t stream) {
  const void* kern = dkv ? reinterpret_cast<const void*>(dkv_kernel<DP>)
                         : reinterpret_cast<const void*>(dq_kernel<DP>);
  const int smem = dkv ? DkvPlan<DP>::SMEM : DqPlan<DP>::SMEM;
  cudaError_t err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  CUtensorMap qmap, domap, kmap, vmap;
  const int qrows = dkv ? BT : BQ, krows = dkv ? BKV : BT;
  if (!bhsd_map(&qmap, q, B, a.H, a.Sq, a.D, st[0], st[1], st[2], qrows) ||
      !bhsd_map(&domap, dout, B, a.H, a.Sq, a.D, st[12], st[13], st[14], qrows) ||
      !bhsd_map(&kmap, k, B, Hkv, a.Skv, a.D, st[3], st[4], st[5], krows) ||
      !bhsd_map(&vmap, v, B, Hkv, a.Skv, a.D, st[6], st[7], st[8], krows))
    return cudaErrorInvalidValue;
  if (dkv)
    dkv_kernel<DP><<<dim3(Hkv, (a.Skv + BKV - 1) / BKV, B), DKV_THREADS, smem, stream>>>(
        qmap, domap, kmap, vmap, a);
  else
    dq_kernel<DP><<<dim3(a.H, (a.Sq + BQ - 1) / BQ, B), DQ_THREADS, smem, stream>>>(
        qmap, domap, kmap, vmap, a);
  return cudaGetLastError();
}

int launch(bool dkv, const void* q, const void* k, const void* v, const void* o,
           const void* dout, const void* lse, void* dvec, const void* kv_valid, void* dq,
           void* dk, void* dv, const long long* st, int B, int H, int Hkv, int Sq, int Skv,
           int D, float scale, int causal, void* stream) {
  if (D <= 0 || D % 8 || D > 128 || Sq <= 0 || Skv <= 0 || Hkv <= 0 || H % Hkv)
    return static_cast<int>(cudaErrorInvalidValue);
  BwdArgs a;
  a.o = static_cast<const __nv_bfloat16*>(o);
  a.dout = static_cast<const __nv_bfloat16*>(dout);
  a.lse = static_cast<const float*>(lse);
  a.dvec = static_cast<float*>(dvec);
  a.kv_valid = static_cast<const unsigned char*>(kv_valid);
  a.dq = static_cast<__nv_bfloat16*>(dq);
  a.dk = static_cast<__nv_bfloat16*>(dk);
  a.dv = static_cast<__nv_bfloat16*>(dv);
  a.o_sb = st[9]; a.o_sh = st[10]; a.o_ss = st[11];
  a.do_sb = st[12]; a.do_sh = st[13]; a.do_ss = st[14];
  a.dq_sb = st[15]; a.dq_sh = st[16]; a.dq_ss = st[17];
  a.dk_sb = st[18]; a.dk_sh = st[19]; a.dk_ss = st[20];
  a.dv_sb = st[21]; a.dv_sh = st[22]; a.dv_ss = st[23];
  a.H = H; a.rep = H / Hkv; a.Sq = Sq; a.Skv = Skv; a.D = D;
  a.scale = scale;
  a.causal = causal;
  cudaStream_t cs = static_cast<cudaStream_t>(stream);
  const cudaError_t err = D <= 64 ? launch_bwd<64>(dkv, q, k, v, dout, a, st, B, Hkv, cs)
                                  : launch_bwd<128>(dkv, q, k, v, dout, a, st, B, Hkv, cs);
  return static_cast<int>(err);
}

}  // namespace

// The two entry points take the same arguments: emu_attention_bwd_dq
// launches the dQ kernel (and writes D), emu_attention_bwd_dkv the dK/dV
// kernel, which reads D; launch them in that order on one stream. q, k, v
// and dout are read through tensor maps (16-byte multiple strides, no
// broadcast dim of extent > 1, 16-byte aligned bases); o with 16-byte loads.
// strides: 24 values, (batch, head, seq) of q, k, v, o, dout, dq, dk, dv.
extern "C" int emu_attention_bwd_dq(
    const void* q, const void* k, const void* v, const void* o,
    const void* dout, const void* lse, void* dvec, const void* kv_valid,
    void* dq, void* dk, void* dv, const long long* strides, int B, int H,
    int Hkv, int Sq, int Skv, int D, float scale, int causal, void* stream) {
  return launch(false, q, k, v, o, dout, lse, dvec, kv_valid, dq, dk, dv,
                strides, B, H, Hkv, Sq, Skv, D, scale, causal, stream);
}

extern "C" int emu_attention_bwd_dkv(
    const void* q, const void* k, const void* v, const void* o,
    const void* dout, const void* lse, void* dvec, const void* kv_valid,
    void* dq, void* dk, void* dv, const long long* strides, int B, int H,
    int Hkv, int Sq, int Skv, int D, float scale, int causal, void* stream) {
  return launch(true, q, k, v, o, dout, lse, dvec, kv_valid, dq, dk, dv,
                strides, B, H, Hkv, Sq, Skv, D, scale, causal, stream);
}

// Dynamic shared memory of the dQ and dK/dV blocks for head width d
// (chip_smoke prints it).
extern "C" int emu_attention_bwd_smem(int dkv, int d) {
  if (dkv) return d <= 64 ? DkvPlan<64>::SMEM : DkvPlan<128>::SMEM;
  return d <= 64 ? DqPlan<64>::SMEM : DqPlan<128>::SMEM;
}
