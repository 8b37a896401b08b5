// Kernel A: the flash-attention forward over head-major [B, H, S, D] bf16
// views, built for Hopper.
//
// Replaces the TPU kernels emu_tpu/ops/flash_attention.py:mha_bhsd (the
// ViT self-attention, per-head q/v biases folded in, ragged S masked),
// flash_attention/_flash_short (end-aligned causal mask plus a [B, Skv]
// kv_valid padding mask, the LLaMA prefill contract, with the lse the
// backward reads) and _flash_streaming (Skv > 4096: K/V stream through
// tiles with an online softmax at every length).
//
// What bounds it on an H100: the Q.K^T and P.V products (4 * S^2 * D flops
// a head) at 989 TFLOP/s bf16; q, k, v and the output are read and
// written once. The design keeps the logits, the probabilities and the
// output accumulator in registers:
//
// - one block owns 128 query rows of one (batch, head): two consumer
//   warpgroups of 64 rows each and one producer warp;
// - the producer loads the Q tile once and keeps K/V tiles of BK keys in
//   flight through TMA, STAGES deep behind mbarriers, with the tile's
//   kv_valid column states written beside them;
// - S = Q.K^T runs as wgmma (bf16, fp32 accumulate) from shared-memory
//   descriptors; the online softmax (base 2) runs on the accumulator in
//   its own register layout, each row's max and sum over the four threads
//   that hold it;
// - P becomes bf16 in registers and is the register A operand of the P.V
//   wgmma, whose B operand is the V tile read N-major (the transposed-B
//   form 16-bit types allow); the output accumulator stays in registers
//   until the epilogue.
//
// Tensor maps span each view's four dims ([B, H, S, D] at its own strides,
// so the packed qkv is read in place) with an inner extent of D and a box
// of 64 columns, so TMA zero-fills the pad of D in {40, 80, 88, 112} and
// the rows past S; no pad reaches device memory. The q bias is added to
// the Q tile after it lands. The v bias is added to the normalised output
// (every row's weights sum to 1, blind rows included): the twin adds it to
// V in bf16, so the two differ by one bf16 rounding of v + bias, averaged.
//
// Masked logits are -1e30 (not -inf): a row that sees no valid key (a
// left-pad query under causal + kv_valid) then averages V uniformly over
// all Skv columns, finite, as the plain version does, and its lse is
// -1e30 + log(Skv). Columns past Skv take no part at all. Causal tile
// skip: a block visits only the tiles that hold a column at or left of its
// last row's diagonal, unless a row of the block sees no valid key (it
// averages every column).
//
// With `lse` non-null the kernel also writes each row's log-sum-exp
// m + log(l) (fp32, [B, H, Sq]), which attention_bwd.cu reads.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

#include "attention_tiles.cuh"

namespace {

constexpr int BQ = 128;         // query rows per block (two warpgroups)
constexpr int STAGES = 3;       // K/V tiles in flight
constexpr int THREADS = 2 * 128 + 32;
constexpr float NEG = -1e30f;
constexpr float LOG2E = 1.4426950408889634f;

struct AttnArgs {
  const __nv_bfloat16* q_bias;    // [H, D] or null
  const __nv_bfloat16* v_bias;    // [Hkv, D] or null
  const unsigned char* kv_valid;  // [B, Skv] (0 = masked) or null
  __nv_bfloat16* o;
  float* lse;                     // [B, H, Sq] or null
  long long o_sb, o_sh, o_ss;
  int H, rep, Sq, Skv, D;
  float scale;
  int causal;
};

// Shared memory of one block: Q [DP/64][BQ][64], each stage's K and V
// [DP/64][BK][64] (bf16, rows of 128 bytes in the 128-byte swizzle), the
// stages' column states, the barriers.
template <int DP, int BK>
struct AttnPlan {
  static constexpr int CHUNKS = DP / 64;
  static constexpr int Q_BYTES = CHUNKS * BQ * 128;
  static constexpr int KV_BYTES = CHUNKS * BK * 128;  // one of K, V
  static constexpr int STAGE_BYTES = 2 * KV_BYTES;
  static constexpr int COL_OFF = Q_BYTES + STAGES * STAGE_BYTES;
  static constexpr int BAR_OFF = COL_OFF + STAGES * BK;
  static constexpr int SMEM = BAR_OFF + 8 * (1 + 2 * STAGES) + 1024;
};

template <int DP, int BK>
__global__ void __launch_bounds__(THREADS, 1)
    attention_kernel(const __grid_constant__ CUtensorMap qmap,
                     const __grid_constant__ CUtensorMap kmap,
                     const __grid_constant__ CUtensorMap vmap, const AttnArgs a) {
  using Plan = AttnPlan<DP, BK>;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~static_cast<uintptr_t>(1023));
  unsigned char* qs = smem;
  unsigned char* colstate = smem + Plan::COL_OFF;
  uint64_t* qfull = reinterpret_cast<uint64_t*>(smem + Plan::BAR_OFF);
  uint64_t* full = qfull + 1;
  uint64_t* empty = full + STAGES;

  const int q0 = blockIdx.x * BQ;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int hk = h / a.rep;
  const int diag = a.Skv - a.Sq;
  const bool kv = a.kv_valid != nullptr;

  __shared__ int first_s;
  if (threadIdx.x == 0) {
    mbar_init(qfull, 1);
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(&full[s], 1 + (kv ? 32 : 0));
      mbar_init(&empty[s], 256);
    }
    mbar_fence_init();
    first_s = a.Skv;
  }
  __syncthreads();
  int n_tiles = (a.Skv + BK - 1) / BK;
  if (a.causal) {
    // first valid key of this batch row (Skv when there is none)
    if (kv) {
      for (int j = threadIdx.x; j < a.Skv; j += THREADS)
        if (a.kv_valid[static_cast<long long>(b) * a.Skv + j]) {
          atomicMin(&first_s, j);
          break;
        }
      __syncthreads();
    }
    const int first = kv ? first_s : 0;
    // skip the tiles right of the last row's diagonal unless a row of this
    // block sees no valid key (it averages all Skv columns)
    if (q0 + diag >= first) {
      const int last_col = q0 + BQ - 1 + diag;
      n_tiles = min(n_tiles, last_col / BK + 1);
    }
  }

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  if (warp == 8) {
    // ---- producer warp ----
    if (lane == 0) {
      mbar_arrive_tx(qfull, Plan::Q_BYTES);
      for (int c = 0; c < Plan::CHUNKS; ++c)
        tma_load_4d(qs + c * BQ * 128, &qmap, qfull, c * 64, q0, h, b);
    }
    for (int i = 0; i < n_tiles; ++i) {
      const int s = i % STAGES;
      if (i >= STAGES) mbar_wait(&empty[s], ((i / STAGES) + 1) & 1);
      unsigned char* ks = smem + Plan::Q_BYTES + s * Plan::STAGE_BYTES;
      const int j0 = i * BK;
      if (lane == 0) {
        mbar_arrive_tx(&full[s], Plan::STAGE_BYTES);
        for (int c = 0; c < Plan::CHUNKS; ++c) {
          tma_load_4d(ks + c * BK * 128, &kmap, &full[s], c * 64, j0, hk, b);
          tma_load_4d(ks + Plan::KV_BYTES + c * BK * 128, &vmap, &full[s], c * 64, j0, hk, b);
        }
      }
      if (kv) {
        // 1 attend, 0 masked, 2 past the end (no part in the softmax)
        for (int c = lane; c < BK; c += 32) {
          const int j = j0 + c;
          colstate[s * BK + c] =
              j < a.Skv ? (a.kv_valid[static_cast<long long>(b) * a.Skv + j] ? 1 : 0) : 2;
        }
        mbar_arrive(&full[s]);
      }
    }
    return;
  }

  // ---- consumer warpgroups: 64 query rows each ----
  const int wg = warp / 4, g = lane / 4, t = lane % 4;
  const int r0 = q0 + wg * 64 + (warp % 4) * 16 + g;  // and r0 + 8
  const float sl2 = a.scale * LOG2E;

  mbar_wait(qfull, 0);
  if (a.q_bias != nullptr) {
    // q + bias in bf16, as the twin rounds it, on this warpgroup's rows
    const __nv_bfloat16* qb = a.q_bias + static_cast<long long>(h) * a.D;
    for (int idx = threadIdx.x % 128; idx < 64 * (DP / 8); idx += 128) {
      const int r = wg * 64 + idx / (DP / 8), cu = idx % (DP / 8);
      if (cu * 8 >= a.D) continue;
      uint4* p = reinterpret_cast<uint4*>(qs + (cu / 8) * BQ * 128 + r * 128 +
                                          (((cu % 8) ^ (r % 8)) << 4));
      uint4 val = *p;
      __nv_bfloat16* e = reinterpret_cast<__nv_bfloat16*>(&val);
#pragma unroll
      for (int i = 0; i < 8; ++i)
        e[i] = __float2bfloat16(__bfloat162float(e[i]) + __bfloat162float(qb[cu * 8 + i]));
      *p = val;
    }
    fence_async_smem();
    named_barrier(1 + wg, 128);
  }

  float o[DP / 2];
#pragma unroll
  for (int i = 0; i < DP / 2; ++i) o[i] = 0.f;
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};
  const unsigned char* qa = qs + wg * 64 * 128;

  for (int i = 0; i < n_tiles; ++i) {
    const int s = i % STAGES;
    const int j0 = i * BK;
    const unsigned char* ks = smem + Plan::Q_BYTES + s * Plan::STAGE_BYTES;
    const unsigned char* vs = ks + Plan::KV_BYTES;
    mbar_wait(&full[s], (i / STAGES) & 1);

    float sacc[BK / 2];
    fence_regs(sacc);
    wgmma_fence();
    // every 16-deep step of the padded width (the pad is zeros)
#pragma unroll
    for (int kk = 0; kk < DP / 16; ++kk) {
      const int off = (kk / 4) * BQ * 128 + (kk % 4) * 32;
      const int koff = (kk / 4) * BK * 128 + (kk % 4) * 32;
      qk_wgmma<BK>(sacc, smem_desc(qa + off, 16, 1024), smem_desc(ks + koff, 16, 1024), kk > 0);
    }
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(sacc);

    // masks, scale (base 2), running max
    const bool need_mask = kv || j0 + BK > a.Skv ||
                           (a.causal && j0 + BK - 1 > q0 + wg * 64 + (warp % 4) * 16 + diag);
    float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int j = 0; j < BK / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float x = sacc[j * 4 + e] * sl2;
        if (need_mask) {
          const int c = j * 8 + 2 * t + (e & 1);
          const int col = j0 + c;
          const int st = kv ? colstate[s * BK + c] : (col < a.Skv ? 1 : 2);
          const int qi = r0 + (e >= 2 ? 8 : 0);
          if (st == 2) x = -INFINITY;
          else if (st == 0 || (a.causal && col > qi + diag)) x = NEG;
        }
        sacc[j * 4 + e] = x;
        mx[e >> 1] = fmaxf(mx[e >> 1], x);
      }
    float corr[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
      const float m_new = fmaxf(m[r], mx[r]);
      corr[r] = exp2f(m[r] - m_new);
      m[r] = m_new;
      l[r] *= corr[r];
    }
    uint32_t pa[BK / 16][4];
#pragma unroll
    for (int j = 0; j < BK / 8; ++j) {
      float pj[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        pj[e] = exp2f(sacc[j * 4 + e] - m[e >> 1]);
        l[e >> 1] += pj[e];
      }
      pa[j / 2][(j % 2) * 2 + 0] = pack_bf16(pj[0], pj[1]);
      pa[j / 2][(j % 2) * 2 + 1] = pack_bf16(pj[2], pj[3]);
    }
#pragma unroll
    for (int j = 0; j < DP / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) o[j * 4 + e] *= corr[e >> 1];

    fence_regs(o);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk)
      pv_wgmma<DP, BK>(o, pa[kk], smem_desc(vs + kk * 16 * 128, BK * 128, 1024));
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(o);
    mbar_arrive(&empty[s]);
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
  }
  if (a.lse != nullptr && t == 0) {
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = r0 + 8 * r;
      // a blind row's logits are all NEG: NEG + log(l) in natural units,
      // as the twin's logsumexp gives it
      if (row < a.Sq)
        a.lse[(static_cast<long long>(b) * a.H + h) * a.Sq + row] =
            m[r] == NEG ? NEG + logf(l[r]) : (m[r] + log2f(l[r])) * 0.6931471805599453f;
    }
  }
  __nv_bfloat16* op = a.o + b * a.o_sb + h * a.o_sh;
  const __nv_bfloat16* vb =
      a.v_bias != nullptr ? a.v_bias + static_cast<long long>(hk) * a.D : nullptr;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = r0 + 8 * r;
    if (row >= a.Sq) continue;
    const float inv = 1.f / l[r];
#pragma unroll
    for (int j = 0; j < DP / 8; ++j) {
      const int col = j * 8 + 2 * t;
      if (col >= a.D) continue;
      float y0 = o[j * 4 + 2 * r] * inv, y1 = o[j * 4 + 2 * r + 1] * inv;
      if (vb != nullptr) {
        y0 += __bfloat162float(vb[col]);
        y1 += __bfloat162float(vb[col + 1]);
      }
      *reinterpret_cast<__nv_bfloat162*>(op + row * a.o_ss + col) = __floats2bfloat162_rn(y0, y1);
    }
  }
}

template <int DP, int BK>
cudaError_t launch_attention(const void* q, const void* k, const void* v, const AttnArgs& a,
                             int B, int Hkv, long long q_sb, long long q_sh, long long q_ss,
                             long long k_sb, long long k_sh, long long k_ss, long long v_sb,
                             long long v_sh, long long v_ss, cudaStream_t stream) {
  using Plan = AttnPlan<DP, BK>;
  CUtensorMap qmap, kmap, vmap;
  if (!bhsd_map(&qmap, q, B, a.H, a.Sq, a.D, q_sb, q_sh, q_ss, BQ) ||
      !bhsd_map(&kmap, k, B, Hkv, a.Skv, a.D, k_sb, k_sh, k_ss, BK) ||
      !bhsd_map(&vmap, v, B, Hkv, a.Skv, a.D, v_sb, v_sh, v_ss, BK))
    return cudaErrorInvalidValue;
  auto kern = attention_kernel<DP, BK>;
  cudaError_t err =
      cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, Plan::SMEM);
  if (err != cudaSuccess) return err;
  dim3 grid((a.Sq + BQ - 1) / BQ, a.H, B);
  kern<<<grid, THREADS, Plan::SMEM, stream>>>(qmap, kmap, vmap, a);
  return cudaGetLastError();
}

}  // namespace

extern "C" int emu_attention_fwd(
    const void* q, const void* k, const void* v, const void* q_bias,
    const void* v_bias, const void* kv_valid, void* o, void* lse,
    long long q_sb, long long q_sh, long long q_ss,
    long long k_sb, long long k_sh, long long k_ss,
    long long v_sb, long long v_sh, long long v_ss,
    long long o_sb, long long o_sh, long long o_ss,
    int B, int H, int Hkv, int Sq, int Skv, int D, float scale, int causal,
    void* stream) {
  if (D % 8 || D > 128) return static_cast<int>(cudaErrorInvalidValue);
  AttnArgs a;
  a.q_bias = static_cast<const __nv_bfloat16*>(q_bias);
  a.v_bias = static_cast<const __nv_bfloat16*>(v_bias);
  a.kv_valid = static_cast<const unsigned char*>(kv_valid);
  a.o = static_cast<__nv_bfloat16*>(o);
  a.lse = static_cast<float*>(lse);
  a.o_sb = o_sb; a.o_sh = o_sh; a.o_ss = o_ss;
  a.H = H; a.rep = H / Hkv; a.Sq = Sq; a.Skv = Skv; a.D = D;
  a.scale = scale;
  a.causal = causal;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const cudaError_t err =
      D <= 64 ? launch_attention<64, 128>(q, k, v, a, B, Hkv, q_sb, q_sh, q_ss, k_sb, k_sh,
                                          k_ss, v_sb, v_sh, v_ss, s)
              : launch_attention<128, 64>(q, k, v, a, B, Hkv, q_sb, q_sh, q_ss, k_sb, k_sh,
                                          k_ss, v_sb, v_sh, v_ss, s);
  return static_cast<int>(err);
}

// Dynamic shared memory of a block for head width d (chip_smoke prints it).
extern "C" int emu_attention_smem(int d) {
  return d <= 64 ? AttnPlan<64, 128>::SMEM : AttnPlan<128, 64>::SMEM;
}
