// Kernel A: tiled attention over head-major [B, H, S, D] bf16 views.
//
// Replaces the TPU kernels emu_tpu/ops/flash_attention.py:mha_bhsd (the
// ViT-g self-attention, per-head q/v biases folded in, ragged S masked) and
// flash_attention/_flash_short (end-aligned causal mask plus a [B, Skv]
// kv_valid padding mask, the LLaMA prefill contract).
//
// What bounds it on an H100: at ViT-g (S = 257, D = 88) and caption prefill
// (S ~ 80, D = 128) the S x S logits are tiny, so the cost is the Q.K^T and
// P.V products plus the softmax bookkeeping between them. The design keeps
// the logits out of device memory: one block owns 64 query rows of one
// (batch, head), walks K/V in 64-column tiles with an fp32 online softmax,
// and runs both products on the tensor cores through WMMA (bf16 in, fp32
// accumulate). D is zero-padded to a multiple of 16 in shared memory only,
// so D = 88 costs no extra device traffic, and rows past S are masked here,
// not padded by the caller. Inputs may be strided views (the last dim must
// be contiguous), so the [B, S, 3, H, D] qkv projection is read in place.
//
// Masked logits are set to -1e30 (not -inf): a fully masked row (a left-pad
// query under causal + kv_valid) then averages V uniformly, finite, exactly
// as the plain version does. Columns past Skv take no part at all.
//
// Causal tile skip: a block visits only the K/V tiles that hold a column at
// or left of its last row's diagonal, so a long causal prefill does about
// half the rectangle's work. The one exception keeps the plain version's
// semantics: a block holding a fully masked row (no valid key at or left of
// its diagonal: qi + diag below the batch row's first valid key) visits
// every tile, since that row's uniform average runs over all Skv columns.
// Because K/V stream through 64-column tiles with an online softmax, the
// same kernel also covers the TPU's streaming tier
// (flash_attention.py:_flash_streaming, Skv > 4096) at any length.
//
// With `lse` non-null the kernel also writes each row's log-sum-exp
// m + log(l) (fp32, [B, H, Sq]), the residual of the recompute-based
// backward in attention_bwd.cu (the TPU's _flash_short(with_lse=True)).
//
// First version: fragments go through shared memory between the two
// products. wgmma and TMA are later work.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <mma.h>
#include <math.h>

using namespace nvcuda;

namespace {

constexpr int BQ = 64;     // query rows per block
constexpr int BK = 64;     // key columns per tile
constexpr int WARPS = 4;   // each warp owns 16 query rows
constexpr int THREADS = WARPS * 32;
constexpr float NEG = -1e30f;

struct AttnArgs {
  const __nv_bfloat16* q;
  const __nv_bfloat16* k;
  const __nv_bfloat16* v;
  const __nv_bfloat16* q_bias;  // [H, D] or null
  const __nv_bfloat16* v_bias;  // [Hkv, D] or null
  const unsigned char* kv_valid;  // [B, Skv] (0 = masked) or null
  __nv_bfloat16* o;
  float* lse;                     // [B, H, Sq] or null
  long long q_sb, q_sh, q_ss;
  long long k_sb, k_sh, k_ss;
  long long v_sb, v_sh, v_ss;
  long long o_sb, o_sh, o_ss;
  int H, rep, Sq, Skv, D, Dp;
  float scale;
  int causal;
};

struct Layout {
  int ldq, lds, ldp, ldo;
  size_t q_off, k_off, v_off, s_off, p_off, o_off, st_off, col_off, total;
};

__host__ __device__ inline Layout make_layout(int Dp) {
  Layout L;
  L.ldq = Dp + 8;        // bf16 rows of Q, K, V tiles
  L.lds = BK + 4;        // fp32 logits rows
  L.ldp = BK + 8;        // bf16 probability rows
  L.ldo = Dp + 4;        // fp32 output accumulator rows
  size_t off = 0;
  L.q_off = off; off += sizeof(__nv_bfloat16) * BQ * L.ldq;
  L.k_off = off; off += sizeof(__nv_bfloat16) * BK * L.ldq;
  L.v_off = off; off += sizeof(__nv_bfloat16) * BK * L.ldq;
  L.s_off = off; off += sizeof(float) * WARPS * 16 * L.lds;
  L.p_off = off; off += sizeof(__nv_bfloat16) * WARPS * 16 * L.ldp;
  L.o_off = off; off += sizeof(float) * WARPS * 16 * L.ldo;
  L.st_off = off; off += sizeof(float) * WARPS * 16 * 3;  // m, l, corr
  L.col_off = off; off += sizeof(int) * BK;
  L.total = off;
  return L;
}

// Loads rows [r0, r0 + nrows) of one (b, h) plane into a [nrows, ldq] bf16
// tile, adding an optional per-head bias, zero-filling d >= D and rows past
// the sequence end.
__device__ inline void load_tile(__nv_bfloat16* dst, int ldq, int nrows,
                                 const __nv_bfloat16* src, long long ss,
                                 int r0, int seq, int D, int Dp,
                                 const __nv_bfloat16* bias) {
  const int vec_per_row = Dp / 8;
  for (int idx = threadIdx.x; idx < nrows * vec_per_row; idx += THREADS) {
    const int r = idx / vec_per_row;
    const int c8 = (idx % vec_per_row) * 8;
    const int row = r0 + r;
    uint4 val = make_uint4(0, 0, 0, 0);
    if (row < seq && c8 < D) {
      val = *reinterpret_cast<const uint4*>(src + row * ss + c8);
      if (bias != nullptr) {
        __nv_bfloat16* e = reinterpret_cast<__nv_bfloat16*>(&val);
#pragma unroll
        for (int i = 0; i < 8; ++i)
          e[i] = __float2bfloat16(__bfloat162float(e[i]) +
                                  __bfloat162float(bias[c8 + i]));
      }
    }
    *reinterpret_cast<uint4*>(dst + r * ldq + c8) = val;
  }
}

__global__ void __launch_bounds__(THREADS) attention_kernel(AttnArgs a) {
  extern __shared__ __align__(128) unsigned char smem[];
  const Layout L = make_layout(a.Dp);
  __nv_bfloat16* Qs = reinterpret_cast<__nv_bfloat16*>(smem + L.q_off);
  __nv_bfloat16* Ks = reinterpret_cast<__nv_bfloat16*>(smem + L.k_off);
  __nv_bfloat16* Vs = reinterpret_cast<__nv_bfloat16*>(smem + L.v_off);
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  float* Sw = reinterpret_cast<float*>(smem + L.s_off) + warp * 16 * L.lds;
  __nv_bfloat16* Pw =
      reinterpret_cast<__nv_bfloat16*>(smem + L.p_off) + warp * 16 * L.ldp;
  float* Ow = reinterpret_cast<float*>(smem + L.o_off) + warp * 16 * L.ldo;
  float* st = reinterpret_cast<float*>(smem + L.st_off) + warp * 48;
  float* m_s = st;
  float* l_s = st + 16;
  float* c_s = st + 32;
  int* colstate = reinterpret_cast<int*>(smem + L.col_off);

  const int q0 = blockIdx.x * BQ;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int hk = h / a.rep;

  const __nv_bfloat16* qp = a.q + b * a.q_sb + h * a.q_sh;
  const __nv_bfloat16* kp = a.k + b * a.k_sb + hk * a.k_sh;
  const __nv_bfloat16* vp = a.v + b * a.v_sb + hk * a.v_sh;
  const __nv_bfloat16* qb = a.q_bias ? a.q_bias + h * a.D : nullptr;
  const __nv_bfloat16* vb = a.v_bias ? a.v_bias + hk * a.D : nullptr;

  load_tile(Qs, L.ldq, BQ, qp, a.q_ss, q0, a.Sq, a.D, a.Dp, qb);
  for (int i = lane; i < 16 * L.ldo; i += 32) Ow[i] = 0.f;
  if (lane < 16) {
    m_s[lane] = -INFINITY;
    l_s[lane] = 0.f;
  }
  const int diag = a.Skv - a.Sq;
  int n_tiles = (a.Skv + BK - 1) / BK;
  if (a.causal) {
    // first valid key of this batch row (Skv when there is none)
    int first = 0;
    if (a.kv_valid != nullptr) {
      __shared__ int first_s;
      if (threadIdx.x == 0) first_s = a.Skv;
      __syncthreads();
      for (int j = threadIdx.x; j < a.Skv; j += THREADS)
        if (a.kv_valid[b * a.Skv + j]) {
          atomicMin(&first_s, j);
          break;
        }
      __syncthreads();
      first = first_s;
    }
    // skip the tiles right of the last row's diagonal unless a row of this
    // block sees no valid key (it averages all Skv columns)
    if (q0 + diag >= first) {
      const int last_col = q0 + BQ - 1 + diag;
      n_tiles = min(n_tiles, last_col < 0 ? 0 : last_col / BK + 1);
    }
  }

  for (int t = 0; t < n_tiles; ++t) {
    const int j0 = t * BK;
    __syncthreads();  // previous tile's K/V fully consumed
    load_tile(Ks, L.ldq, BK, kp, a.k_ss, j0, a.Skv, a.D, a.Dp, nullptr);
    load_tile(Vs, L.ldq, BK, vp, a.v_ss, j0, a.Skv, a.D, a.Dp, vb);
    for (int c = threadIdx.x; c < BK; c += THREADS) {
      const int j = j0 + c;
      int s = 2;  // past the end: no part in the softmax
      if (j < a.Skv) s = (a.kv_valid == nullptr || a.kv_valid[b * a.Skv + j]) ? 1 : 0;
      colstate[c] = s;
    }
    __syncthreads();

    // logits of this warp's 16 rows against the 64 columns
    for (int jt = 0; jt < BK / 16; ++jt) {
      wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc;
      wmma::fill_fragment(acc, 0.f);
      for (int d0 = 0; d0 < a.Dp; d0 += 16) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::row_major> fa;
        wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::col_major> fb;
        wmma::load_matrix_sync(fa, Qs + warp * 16 * L.ldq + d0, L.ldq);
        wmma::load_matrix_sync(fb, Ks + jt * 16 * L.ldq + d0, L.ldq);
        wmma::mma_sync(acc, fa, fb, acc);
      }
      wmma::store_matrix_sync(Sw + jt * 16, acc, L.lds, wmma::mem_row_major);
    }
    __syncwarp();

    // online softmax: two lanes per row, 32 columns each
    {
      const int r = lane >> 1;
      const int half = lane & 1;
      const int qi = q0 + warp * 16 + r;
      float* srow = Sw + r * L.lds + half * 32;
      float tmax = -INFINITY;
      for (int i = 0; i < 32; ++i) {
        const int c = half * 32 + i;
        const int cs = colstate[c];
        float s = srow[i] * a.scale;
        if (cs == 2) {
          s = -INFINITY;
        } else {
          bool keep = cs == 1;
          if (a.causal && j0 + c > qi + diag) keep = false;
          if (!keep) s = NEG;
        }
        srow[i] = s;
        tmax = fmaxf(tmax, s);
      }
      tmax = fmaxf(tmax, __shfl_xor_sync(0xffffffffu, tmax, 1));
      const float m_old = m_s[r];
      const float m_new = fmaxf(m_old, tmax);
      float sum = 0.f;
      __nv_bfloat16* prow = Pw + r * L.ldp + half * 32;
      for (int i = 0; i < 32; ++i) {
        const float s = srow[i];
        const float p = (s == -INFINITY) ? 0.f : expf(s - m_new);
        sum += p;
        prow[i] = __float2bfloat16(p);
      }
      sum += __shfl_xor_sync(0xffffffffu, sum, 1);
      __syncwarp();
      if (half == 0) {
        const float corr = expf(m_old - m_new);
        c_s[r] = corr;
        l_s[r] = l_s[r] * corr + sum;
        m_s[r] = m_new;
      }
    }
    __syncwarp();

    // rescale the running output rows, then O += P V
    for (int i = lane; i < 16 * a.Dp; i += 32) {
      const int r = i / a.Dp;
      const int c = i % a.Dp;
      Ow[r * L.ldo + c] *= c_s[r];
    }
    __syncwarp();
    for (int d0 = 0; d0 < a.Dp; d0 += 16) {
      wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc;
      wmma::load_matrix_sync(acc, Ow + d0, L.ldo, wmma::mem_row_major);
      for (int kk = 0; kk < BK / 16; ++kk) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::row_major> fa;
        wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::row_major> fb;
        wmma::load_matrix_sync(fa, Pw + kk * 16, L.ldp);
        wmma::load_matrix_sync(fb, Vs + kk * 16 * L.ldq + d0, L.ldq);
        wmma::mma_sync(acc, fa, fb, acc);
      }
      wmma::store_matrix_sync(Ow + d0, acc, L.ldo, wmma::mem_row_major);
    }
    __syncwarp();
  }

  if (a.lse != nullptr && lane < 16) {
    const int row = q0 + warp * 16 + lane;
    if (row < a.Sq)
      a.lse[(static_cast<long long>(b) * a.H + h) * a.Sq + row] =
          m_s[lane] + logf(l_s[lane]);
  }

  // normalise and store this warp's rows, 8 values per 16-byte store
  const int vec_per_row = a.D / 8;
  __nv_bfloat16* op = a.o + b * a.o_sb + h * a.o_sh;
  for (int i = lane; i < 16 * vec_per_row; i += 32) {
    const int r = i / vec_per_row;
    const int c8 = (i % vec_per_row) * 8;
    const int row = q0 + warp * 16 + r;
    if (row >= a.Sq) continue;
    const float inv = 1.f / l_s[r];
    uint4 val;
    __nv_bfloat16* e = reinterpret_cast<__nv_bfloat16*>(&val);
#pragma unroll
    for (int u = 0; u < 8; ++u) e[u] = __float2bfloat16(Ow[r * L.ldo + c8 + u] * inv);
    *reinterpret_cast<uint4*>(op + row * a.o_ss + c8) = val;
  }
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
  AttnArgs a;
  a.q = static_cast<const __nv_bfloat16*>(q);
  a.k = static_cast<const __nv_bfloat16*>(k);
  a.v = static_cast<const __nv_bfloat16*>(v);
  a.q_bias = static_cast<const __nv_bfloat16*>(q_bias);
  a.v_bias = static_cast<const __nv_bfloat16*>(v_bias);
  a.kv_valid = static_cast<const unsigned char*>(kv_valid);
  a.o = static_cast<__nv_bfloat16*>(o);
  a.lse = static_cast<float*>(lse);
  a.q_sb = q_sb; a.q_sh = q_sh; a.q_ss = q_ss;
  a.k_sb = k_sb; a.k_sh = k_sh; a.k_ss = k_ss;
  a.v_sb = v_sb; a.v_sh = v_sh; a.v_ss = v_ss;
  a.o_sb = o_sb; a.o_sh = o_sh; a.o_ss = o_ss;
  a.H = H; a.rep = H / Hkv; a.Sq = Sq; a.Skv = Skv; a.D = D;
  a.Dp = (D + 15) / 16 * 16;
  a.scale = scale;
  a.causal = causal;
  const Layout L = make_layout(a.Dp);
  cudaError_t err = cudaFuncSetAttribute(
      attention_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(L.total));
  if (err != cudaSuccess) return static_cast<int>(err);
  dim3 grid((Sq + BQ - 1) / BQ, H, B);
  attention_kernel<<<grid, THREADS, L.total, static_cast<cudaStream_t>(stream)>>>(a);
  return static_cast<int>(cudaGetLastError());
}
