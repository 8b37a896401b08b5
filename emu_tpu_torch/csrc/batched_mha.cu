// batched_mha: unmasked multi-head self-attention over token-major
// [B, S, H, D] bf16 views, D up to 256, built for Hopper.
//
// Replaces the TPU kernels emu_tpu/ops/flash_attention.py:batched_mha
// (_mha_kernel) and mha_packed_qkv (_packed_kernel, the same attention read
// from the q|k|v planes of one packed projection): softmax(scale * q k^T) v
// per (batch, head), fp32 logits and softmax, probabilities rounded to bf16
// before the P.V product and the fp32 sum of the unrounded ones dividing the
// output, no mask, no bias. On the card it carries the diffusion UNets'
// latent self-attention (SDXL's 32x32 level, 20 heads of 64; SD1.5's 32x32,
// 16x16 and 8x8 levels, 8 heads of 80, 160 and 160), the SwiGLU ViT's
// attention and the ViTs' packed-qkv attention.
//
// What bounds it on an H100: the Q.K^T and P.V products, 4 * S^2 * D
// operations a head at 989 TFLOP/s bf16, from 1024 tokens up; below that
// the bytes of q, k, v and the output, each moved once, and the latency of
// a few tiles. The design is kernel A's (attention.cu), with whose pieces
// it shares attention_tiles.cuh:
//
// - one block owns 128 query rows of one (batch, head): two consumer
//   warpgroups of 64 rows each and one producer warp, which loads the Q
//   tile once and keeps K/V tiles of BK keys in flight through TMA,
//   STAGES deep behind mbarriers;
// - the tensor maps span the strided [B, S, H, D] views, so the packed
//   projection is read in place (token stride 3 * H * D); TMA zero-fills
//   the pad of D up to DP and the rows past S;
// - S = Q.K^T is an SS wgmma; the online softmax (base 2, one FMA and one
//   ex2 a logit) runs on the accumulator registers; P becomes bf16 in
//   registers and is the A operand
//   of the P.V wgmma; O stays in registers until the epilogue;
// - the P.V product of tile i-1 is in flight while the softmax of tile i
//   runs (S_i and P_{i-1}.V_{i-1} are issued together; O is rescaled once
//   the product has landed), so the tensor cores and the softmax overlap
//   inside each warpgroup.
//
// What the wider heads need, and kernel A lacks: padded widths DP of 64,
// 128, 192 and 256. DP = 64 walks K/V in 128-key tiles, wider heads in
// 64-key tiles; the ring is 3 deep up to DP = 192 and 2 deep at 256 (Q
// 64 KB + two stages of K and V 128 KB, under the 227 KB a block may
// use); at DP = 256 O is 128 fp32 registers a thread. A P.V wider than
// 128 columns chains two wgmmas (attention_tiles.cuh). The ragged sequence
// edge is handled here: key columns past S take no part in the softmax
// (-inf) and query rows past S are not stored; the output is written
// token-major through its strides.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

#include <atomic>

#include "attention_tiles.cuh"

namespace {

constexpr int BQ = 128;         // query rows per block (two warpgroups)
constexpr int THREADS = 2 * 128 + 32;
constexpr int MAX_D = 256;
constexpr float LOG2E = 1.4426950408889634f;

struct MhaArgs {
  __nv_bfloat16* o;
  long long o_sb, o_ss, o_sh;
  int S, D;
  float scale;
};

// Shared memory of one block: Q [DP/64][BQ][64], each stage's K and V
// [DP/64][BK][64] (bf16, rows of 128 bytes in the 128-byte swizzle), the
// barriers.
template <int DP>
struct MhaPlan {
  static constexpr int BK = DP == 64 ? 128 : 64;
  static constexpr int STAGES = DP == 256 ? 2 : 3;
  static constexpr int CHUNKS = DP / 64;
  static constexpr int Q_BYTES = CHUNKS * BQ * 128;
  static constexpr int KV_BYTES = CHUNKS * BK * 128;  // one of K, V
  static constexpr int STAGE_BYTES = 2 * KV_BYTES;
  static constexpr int BAR_OFF = Q_BYTES + STAGES * STAGE_BYTES;
  static constexpr int SMEM = BAR_OFF + 8 * (1 + 2 * STAGES) + 1024;
};

// Issues S = Q.K^T of one warpgroup over every 16-deep step of the padded
// width (the pad is zeros) and commits it as one group.
template <int DP, int BK>
__device__ __forceinline__ void issue_qk(float (&s)[BK / 2], const unsigned char* qa,
                                         const unsigned char* ks) {
#pragma unroll
  for (int kk = 0; kk < DP / 16; ++kk) {
    const int off = (kk / 4) * BQ * 128 + (kk % 4) * 32;
    const int koff = (kk / 4) * BK * 128 + (kk % 4) * 32;
    qk_wgmma<BK>(s, smem_desc(qa + off, 16, 1024), smem_desc(ks + koff, 16, 1024), kk > 0);
  }
  wgmma_commit();
}

// Issues O += P.V over the BK keys of one V tile and commits it.
template <int DP, int BK>
__device__ __forceinline__ void issue_pv(float (&o)[DP / 2], const uint32_t (&p)[BK / 16][4],
                                         const unsigned char* vs) {
#pragma unroll
  for (int kk = 0; kk < BK / 16; ++kk)
    pv_wgmma<DP, BK>(o, p[kk], smem_desc(vs + kk * 16 * 128, BK * 128, 1024));
  wgmma_commit();
}

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// The online softmax of one tile on the accumulator's layout (rows g and
// g + 8 of the warp's 16, columns j * 8 + 2t, +1): columns from `valid` on
// are past S and take no part. The running max m is kept on the raw logits
// (the scale is positive); each probability is one FMA and one ex2,
// exp2(s * sl2 - m * sl2) = exp(scale * (s - m)). Updates m and the
// running sum l, returns each row's correction of the earlier sum in corr
// and the tile's probabilities as the bf16 A operand of the P.V product.
template <int BK>
__device__ __forceinline__ void softmax_tile(float (&s)[BK / 2], int valid, float sl2, int t,
                                             float (&m)[2], float (&l)[2], float (&corr)[2],
                                             uint32_t (&p)[BK / 16][4]) {
  float mx[2] = {-INFINITY, -INFINITY};
  if (valid < BK) {
#pragma unroll
    for (int j = 0; j < BK / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        if (j * 8 + 2 * t + (e & 1) >= valid) s[j * 4 + e] = -INFINITY;
  }
#pragma unroll
  for (int j = 0; j < BK / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) mx[e >> 1] = fmaxf(mx[e >> 1], s[j * 4 + e]);
  float ms[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
    mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
    const float m_new = fmaxf(m[r], mx[r]);  // finite: a tile's first column is valid
    corr[r] = ex2((m[r] - m_new) * sl2);
    m[r] = m_new;
    ms[r] = m_new * sl2;
    l[r] *= corr[r];
  }
#pragma unroll
  for (int j = 0; j < BK / 8; ++j) {
    float pj[4];
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      pj[e] = ex2(fmaf(s[j * 4 + e], sl2, -ms[e >> 1]));
      l[e >> 1] += pj[e];
    }
    p[j / 2][(j % 2) * 2 + 0] = pack_bf16(pj[0], pj[1]);
    p[j / 2][(j % 2) * 2 + 1] = pack_bf16(pj[2], pj[3]);
  }
}

// Keeps P's registers live (and unmoved) until the P.V product reading them
// has landed.
template <int BK>
__device__ __forceinline__ void fence_p(uint32_t (&p)[BK / 16][4]) {
#pragma unroll
  for (int kk = 0; kk < BK / 16; ++kk) fence_regs(p[kk]);
}

template <int DP>
__global__ void __launch_bounds__(THREADS, 1)
    batched_mha_kernel(const __grid_constant__ CUtensorMap qmap,
                       const __grid_constant__ CUtensorMap kmap,
                       const __grid_constant__ CUtensorMap vmap, const MhaArgs a) {
  using Plan = MhaPlan<DP>;
  constexpr int BK = Plan::BK, STAGES = Plan::STAGES;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~static_cast<uintptr_t>(1023));
  unsigned char* qs = smem;
  unsigned char* kv0 = smem + Plan::Q_BYTES;
  uint64_t* qfull = reinterpret_cast<uint64_t*>(smem + Plan::BAR_OFF);
  uint64_t* full = qfull + 1;
  uint64_t* empty = full + STAGES;

  const int q0 = blockIdx.x * BQ;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int n_tiles = (a.S + BK - 1) / BK;

  if (threadIdx.x == 0) {
    mbar_init(qfull, 1);
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
      mbar_arrive_tx(qfull, Plan::Q_BYTES);
      for (int c = 0; c < Plan::CHUNKS; ++c)
        tma_load_4d(qs + c * BQ * 128, &qmap, qfull, c * 64, q0, h, b);
      for (int i = 0; i < n_tiles; ++i) {
        const int s = i % STAGES;
        if (i >= STAGES) mbar_wait(&empty[s], ((i / STAGES) + 1) & 1);
        unsigned char* ks = kv0 + s * Plan::STAGE_BYTES;
        mbar_arrive_tx(&full[s], Plan::STAGE_BYTES);
        for (int c = 0; c < Plan::CHUNKS; ++c) {
          tma_load_4d(ks + c * BK * 128, &kmap, &full[s], c * 64, i * BK, h, b);
          tma_load_4d(ks + Plan::KV_BYTES + c * BK * 128, &vmap, &full[s], c * 64, i * BK, h, b);
        }
      }
    }
    return;
  }

  // ---- consumer warpgroups: 64 query rows each ----
  const int wg = warp / 4, g = lane / 4, t = lane % 4;
  const int r0 = q0 + wg * 64 + (warp % 4) * 16 + g;  // and r0 + 8
  const float sl2 = a.scale * LOG2E;
  const unsigned char* qa = qs + wg * 64 * 128;

  float o[DP / 2];
#pragma unroll
  for (int i = 0; i < DP / 2; ++i) o[i] = 0.f;
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f}, corr[2];
  float sacc[BK / 2];
  uint32_t pa[BK / 16][4];

  // tile 0: S, then its softmax (O is still zero: no correction)
  mbar_wait(qfull, 0);
  mbar_wait(&full[0], 0);
  fence_acc(sacc);
  wgmma_fence();
  issue_qk<DP, BK>(sacc, qa, kv0);
  wgmma_wait<0>();
  fence_acc(sacc);
  softmax_tile<BK>(sacc, a.S, sl2, t, m, l, corr, pa);

  for (int i = 1; i < n_tiles; ++i) {
    const int s = i % STAGES, sp = (i - 1) % STAGES;
    const unsigned char* ks = kv0 + s * Plan::STAGE_BYTES;
    const unsigned char* vprev = kv0 + sp * Plan::STAGE_BYTES + Plan::KV_BYTES;
    mbar_wait(&full[s], (i / STAGES) & 1);
    fence_acc(sacc);
    fence_acc(o);
    fence_p<BK>(pa);
    wgmma_fence();
    issue_qk<DP, BK>(sacc, qa, ks);          // S_i
    issue_pv<DP, BK>(o, pa, vprev);          // O += P_{i-1} V_{i-1}, in flight
    wgmma_wait<1>();                         // S_i has landed
    fence_acc(sacc);
    uint32_t pn[BK / 16][4];
    softmax_tile<BK>(sacc, a.S - i * BK, sl2, t, m, l, corr, pn);
    wgmma_wait<0>();                         // P_{i-1} V_{i-1} has landed
    fence_acc(o);
    fence_p<BK>(pa);
    mbar_arrive(&empty[sp]);
#pragma unroll
    for (int j = 0; j < DP / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) o[j * 4 + e] *= corr[e >> 1];
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk)
#pragma unroll
      for (int e = 0; e < 4; ++e) pa[kk][e] = pn[kk][e];
  }

  // the last tile's P.V
  fence_acc(o);
  fence_p<BK>(pa);
  wgmma_fence();
  issue_pv<DP, BK>(o, pa, kv0 + ((n_tiles - 1) % STAGES) * Plan::STAGE_BYTES + Plan::KV_BYTES);
  wgmma_wait<0>();
  fence_acc(o);

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
  }
  __nv_bfloat16* op = a.o + b * a.o_sb + h * a.o_sh;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = r0 + 8 * r;
    if (row >= a.S) continue;
    const float inv = 1.f / l[r];
#pragma unroll
    for (int j = 0; j < DP / 8; ++j) {
      const int col = j * 8 + 2 * t;
      if (col >= a.D) continue;
      *reinterpret_cast<__nv_bfloat162*>(op + row * a.o_ss + col) =
          __floats2bfloat162_rn(o[j * 4 + 2 * r] * inv, o[j * 4 + 2 * r + 1] * inv);
    }
  }
}

template <int DP>
cudaError_t launch_mha(const void* q, const void* k, const void* v, const MhaArgs& a, int B,
                       int H, long long q_sb, long long q_ss, long long q_sh, long long k_sb,
                       long long k_ss, long long k_sh, long long v_sb, long long v_ss,
                       long long v_sh, cudaStream_t stream) {
  using Plan = MhaPlan<DP>;
  CUtensorMap qmap, kmap, vmap;
  if (!bhsd_map(&qmap, q, B, H, a.S, a.D, q_sb, q_sh, q_ss, BQ) ||
      !bhsd_map(&kmap, k, B, H, a.S, a.D, k_sb, k_sh, k_ss, Plan::BK) ||
      !bhsd_map(&vmap, v, B, H, a.S, a.D, v_sb, v_sh, v_ss, Plan::BK))
    return cudaErrorInvalidValue;
  // the dynamic shared-memory limit, once per instantiation and device
  static std::atomic<unsigned> ready{0};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  const unsigned bit = 1u << (dev & 31);
  if (!(ready.load(std::memory_order_relaxed) & bit)) {
    err = cudaFuncSetAttribute(batched_mha_kernel<DP>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, Plan::SMEM);
    if (err != cudaSuccess) return err;
    ready.fetch_or(bit, std::memory_order_relaxed);
  }
  dim3 grid((a.S + BQ - 1) / BQ, H, B);
  batched_mha_kernel<DP><<<grid, THREADS, Plan::SMEM, stream>>>(qmap, kmap, vmap, a);
  return cudaGetLastError();
}

}  // namespace

// q, k, v, o: [B, S, H, D] bf16 with the given (batch, sequence, head)
// strides in elements (16-byte multiples, no broadcast dim of extent > 1),
// a contiguous last dim and 16-byte aligned bases; D a multiple of 8, at
// most 256. Launches on `stream`; returns cudaGetLastError().
extern "C" int emu_batched_mha_fwd(
    const void* q, const void* k, const void* v, void* o,
    long long q_sb, long long q_ss, long long q_sh,
    long long k_sb, long long k_ss, long long k_sh,
    long long v_sb, long long v_ss, long long v_sh,
    long long o_sb, long long o_ss, long long o_sh,
    int B, int S, int H, int D, float scale, void* stream) {
  if (D <= 0 || D > MAX_D || D % 8 != 0 || S <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  MhaArgs a;
  a.o = static_cast<__nv_bfloat16*>(o);
  a.o_sb = o_sb; a.o_ss = o_ss; a.o_sh = o_sh;
  a.S = S; a.D = D;
  a.scale = scale;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (D <= 64)
    err = launch_mha<64>(q, k, v, a, B, H, q_sb, q_ss, q_sh, k_sb, k_ss, k_sh, v_sb, v_ss, v_sh, s);
  else if (D <= 128)
    err = launch_mha<128>(q, k, v, a, B, H, q_sb, q_ss, q_sh, k_sb, k_ss, k_sh, v_sb, v_ss, v_sh, s);
  else if (D <= 192)
    err = launch_mha<192>(q, k, v, a, B, H, q_sb, q_ss, q_sh, k_sb, k_ss, k_sh, v_sb, v_ss, v_sh, s);
  else
    err = launch_mha<256>(q, k, v, a, B, H, q_sb, q_ss, q_sh, k_sb, k_ss, k_sh, v_sb, v_ss, v_sh, s);
  return static_cast<int>(err);
}

// Dynamic shared memory of a block for head width d (chip_smoke prints it).
extern "C" int emu_batched_mha_smem(int d) {
  return d <= 64 ? MhaPlan<64>::SMEM
                 : d <= 128 ? MhaPlan<128>::SMEM
                            : d <= 192 ? MhaPlan<192>::SMEM : MhaPlan<256>::SMEM;
}
