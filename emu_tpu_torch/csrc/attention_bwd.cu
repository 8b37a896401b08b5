// The recompute-based flash-attention backward over head-major [B, H, S, D]
// bf16 views: two kernels, dQ and dK/dV.
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
// keeps no column, so P is 0 there and its gradients are zero and finite, as
// the TPU kernels' `keep` makes them.
//
// GQA: q head h reads kv head h / rep. The dK/dV block of a kv head walks all
// rep query heads of its group and sums them in its own fp32 accumulators,
// with no atomics, so dK and dV are the same bits on every run.
//
// What bounds it on an H100: at the train shapes (Sq = Skv = 1024, D = 128)
// the five S x S x D products (half of them under the causal skip) against
// about 1 MB of inputs per (batch, head): operations. This first version
// runs the products through WMMA (bf16 in, fp32 accumulate) with fragments
// staged in shared memory, as kernel A does; wgmma, TMA and a cp.async ring
// are later work.
//
// The dQ kernel also writes D (fp32, [B, H, Sq]); the dK/dV kernel, launched
// after it on the same stream, reads it.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <mma.h>
#include <math.h>

using namespace nvcuda;

namespace {

constexpr int BQ = 64;     // query rows per tile
constexpr int BK = 64;     // key rows per tile
constexpr int WARPS = 4;   // each warp owns 16 rows of its block's tile
constexpr int THREADS = WARPS * 32;

struct BwdArgs {
  const __nv_bfloat16* q;
  const __nv_bfloat16* k;
  const __nv_bfloat16* v;
  const __nv_bfloat16* o;
  const __nv_bfloat16* dout;
  const float* lse;               // [B, H, Sq]
  float* dvec;                    // [B, H, Sq]: D, written by dQ, read by dK/dV
  const unsigned char* kv_valid;  // [B, Skv] (0 = masked) or null
  __nv_bfloat16* dq;
  __nv_bfloat16* dk;
  __nv_bfloat16* dv;
  long long q_sb, q_sh, q_ss;
  long long k_sb, k_sh, k_ss;
  long long v_sb, v_sh, v_ss;
  long long o_sb, o_sh, o_ss;
  long long do_sb, do_sh, do_ss;
  long long dq_sb, dq_sh, dq_ss;
  long long dk_sb, dk_sh, dk_ss;
  long long dv_sb, dv_sh, dv_ss;
  int H, Hkv, rep, Sq, Skv, D, Dp;
  float scale;
  int causal;
};

struct Layout {
  int ldt, lds, ldp, ldo;
  size_t t0, t1, t2, t3, s_off, dp_off, p_off, ds_off, acc0, acc1, vec_off,
      state_off, total;
};

// Shared memory of both kernels: four bf16 tiles [64, Dp], per-warp fp32
// S and dP rows, per-warp bf16 P and dS rows, one or two fp32 accumulators
// [64, Dp], two fp32 row vectors and a per-column state.
__host__ __device__ inline Layout make_layout(int Dp, int n_acc) {
  Layout L;
  L.ldt = Dp + 8;
  L.lds = 64 + 4;
  L.ldp = 64 + 8;
  L.ldo = Dp + 4;
  size_t off = 0;
  const size_t tile = sizeof(__nv_bfloat16) * 64 * L.ldt;
  L.t0 = off; off += tile;
  L.t1 = off; off += tile;
  L.t2 = off; off += tile;
  L.t3 = off; off += tile;
  L.s_off = off; off += sizeof(float) * WARPS * 16 * L.lds;
  L.dp_off = off; off += sizeof(float) * WARPS * 16 * L.lds;
  L.p_off = off; off += sizeof(__nv_bfloat16) * WARPS * 16 * L.ldp;
  L.ds_off = off; off += sizeof(__nv_bfloat16) * WARPS * 16 * L.ldp;
  L.acc0 = off; off += sizeof(float) * 64 * L.ldo;
  L.acc1 = off; off += n_acc > 1 ? sizeof(float) * 64 * L.ldo : 0;
  L.vec_off = off; off += sizeof(float) * 2 * 64;
  L.state_off = off; off += sizeof(int) * 64;
  L.total = off;
  return L;
}

// Rows [r0, r0 + 64) of one (b, h) plane into a [64, ldt] bf16 tile,
// zero-filling d >= D and rows past the sequence end.
__device__ inline void load_tile(__nv_bfloat16* dst, int ldt,
                                 const __nv_bfloat16* src, long long ss,
                                 int r0, int seq, int D, int Dp) {
  const int vec_per_row = Dp / 8;
  for (int idx = threadIdx.x; idx < 64 * vec_per_row; idx += THREADS) {
    const int r = idx / vec_per_row;
    const int c8 = (idx % vec_per_row) * 8;
    const int row = r0 + r;
    uint4 val = make_uint4(0, 0, 0, 0);
    if (row < seq && c8 < D)
      val = *reinterpret_cast<const uint4*>(src + row * ss + c8);
    *reinterpret_cast<uint4*>(dst + r * ldt + c8) = val;
  }
}

// C[16, 64] (fp32, ldc) = A[16, Dp] B^T where B is [64, Dp] row-major: the
// 16 rows of `a` against the 64 rows of `bt`.
__device__ inline void rows_by_rows(float* c, int ldc, const __nv_bfloat16* a,
                                    const __nv_bfloat16* bt, int ldt, int Dp) {
  for (int jt = 0; jt < 4; ++jt) {
    wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc;
    wmma::fill_fragment(acc, 0.f);
    for (int d0 = 0; d0 < Dp; d0 += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::row_major> fa;
      wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::col_major> fb;
      wmma::load_matrix_sync(fa, a + d0, ldt);
      wmma::load_matrix_sync(fb, bt + jt * 16 * ldt + d0, ldt);
      wmma::mma_sync(acc, fa, fb, acc);
    }
    wmma::store_matrix_sync(c + jt * 16, acc, ldc, wmma::mem_row_major);
  }
}

// acc[16, Dp] (fp32, ldo) += A[16, 64] (bf16, ldp) B[64, Dp] (bf16, ldt).
__device__ inline void accumulate(float* acc_s, int ldo,
                                  const __nv_bfloat16* a, int ldp,
                                  const __nv_bfloat16* b, int ldt, int Dp) {
  for (int d0 = 0; d0 < Dp; d0 += 16) {
    wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc;
    wmma::load_matrix_sync(acc, acc_s + d0, ldo, wmma::mem_row_major);
    for (int kk = 0; kk < 4; ++kk) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::row_major> fa;
      wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::row_major> fb;
      wmma::load_matrix_sync(fa, a + kk * 16, ldp);
      wmma::load_matrix_sync(fb, b + kk * 16 * ldt + d0, ldt);
      wmma::mma_sync(acc, fa, fb, acc);
    }
    wmma::store_matrix_sync(acc_s + d0, acc, ldo, wmma::mem_row_major);
  }
}

// One block: 64 query rows of one (b, h); walks the K/V tiles up to its last
// row's diagonal.
__global__ void __launch_bounds__(THREADS) dq_kernel(BwdArgs a) {
  extern __shared__ __align__(128) unsigned char smem[];
  const Layout L = make_layout(a.Dp, 1);
  __nv_bfloat16* Qs = reinterpret_cast<__nv_bfloat16*>(smem + L.t0);
  __nv_bfloat16* dOs = reinterpret_cast<__nv_bfloat16*>(smem + L.t1);
  __nv_bfloat16* Ks = reinterpret_cast<__nv_bfloat16*>(smem + L.t2);
  __nv_bfloat16* Vs = reinterpret_cast<__nv_bfloat16*>(smem + L.t3);
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  float* Sw = reinterpret_cast<float*>(smem + L.s_off) + warp * 16 * L.lds;
  float* dPw = reinterpret_cast<float*>(smem + L.dp_off) + warp * 16 * L.lds;
  __nv_bfloat16* dSw =
      reinterpret_cast<__nv_bfloat16*>(smem + L.ds_off) + warp * 16 * L.ldp;
  float* accw = reinterpret_cast<float*>(smem + L.acc0) + warp * 16 * L.ldo;
  float* lse_s = reinterpret_cast<float*>(smem + L.vec_off);
  float* d_s = lse_s + 64;
  int* colstate = reinterpret_cast<int*>(smem + L.state_off);

  const int q0 = blockIdx.x * BQ;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int hk = h / a.rep;
  const long long row_base = (static_cast<long long>(b) * a.H + h) * a.Sq;

  const __nv_bfloat16* qp = a.q + b * a.q_sb + h * a.q_sh;
  const __nv_bfloat16* op = a.o + b * a.o_sb + h * a.o_sh;
  const __nv_bfloat16* dop = a.dout + b * a.do_sb + h * a.do_sh;
  const __nv_bfloat16* kp = a.k + b * a.k_sb + hk * a.k_sh;
  const __nv_bfloat16* vp = a.v + b * a.v_sb + hk * a.v_sh;

  load_tile(Qs, L.ldt, qp, a.q_ss, q0, a.Sq, a.D, a.Dp);
  load_tile(dOs, L.ldt, dop, a.do_ss, q0, a.Sq, a.D, a.Dp);
  for (int i = lane; i < 16 * L.ldo; i += 32) accw[i] = 0.f;
  // D = rowsum(dO o O) in fp32 from the bf16 values; lse of the rows
  for (int r = 0; r < 16; ++r) {
    const int row = q0 + warp * 16 + r;
    float sum = 0.f;
    if (row < a.Sq)
      for (int d = lane; d < a.D; d += 32)
        sum += __bfloat162float(dop[row * a.do_ss + d]) *
               __bfloat162float(op[row * a.o_ss + d]);
#pragma unroll
    for (int s = 16; s > 0; s >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, s);
    if (lane == 0) {
      d_s[warp * 16 + r] = sum;
      lse_s[warp * 16 + r] = row < a.Sq ? a.lse[row_base + row] : 0.f;
      if (row < a.Sq) a.dvec[row_base + row] = sum;
    }
  }
  __syncwarp();

  const int diag = a.Skv - a.Sq;
  int n_tiles = (a.Skv + BK - 1) / BK;
  if (a.causal) {
    const int last_col = q0 + BQ - 1 + diag;
    n_tiles = min(n_tiles, last_col < 0 ? 0 : last_col / BK + 1);
  }

  for (int t = 0; t < n_tiles; ++t) {
    const int j0 = t * BK;
    __syncthreads();  // the previous tile's K/V fully consumed
    load_tile(Ks, L.ldt, kp, a.k_ss, j0, a.Skv, a.D, a.Dp);
    load_tile(Vs, L.ldt, vp, a.v_ss, j0, a.Skv, a.D, a.Dp);
    for (int c = threadIdx.x; c < BK; c += THREADS) {
      const int j = j0 + c;
      colstate[c] = j < a.Skv && (a.kv_valid == nullptr ||
                                  a.kv_valid[b * a.Skv + j]);
    }
    __syncthreads();

    rows_by_rows(Sw, L.lds, Qs + warp * 16 * L.ldt, Ks, L.ldt, a.Dp);
    rows_by_rows(dPw, L.lds, dOs + warp * 16 * L.ldt, Vs, L.ldt, a.Dp);
    __syncwarp();
    for (int i = lane; i < 16 * BK; i += 32) {
      const int r = i / BK;
      const int c = i % BK;
      const int qi = q0 + warp * 16 + r;
      bool keep = colstate[c] && qi < a.Sq;
      if (a.causal && j0 + c > qi + diag) keep = false;
      const float p = keep ? expf(Sw[r * L.lds + c] * a.scale -
                                  lse_s[warp * 16 + r])
                           : 0.f;
      const float ds = p * (dPw[r * L.lds + c] - d_s[warp * 16 + r]);
      dSw[r * L.ldp + c] = __float2bfloat16(ds);
    }
    __syncwarp();
    accumulate(accw, L.ldo, dSw, L.ldp, Ks, L.ldt, a.Dp);
    __syncwarp();
  }

  __nv_bfloat16* dqp = a.dq + b * a.dq_sb + h * a.dq_sh;
  const int vec_per_row = a.D / 8;
  for (int i = lane; i < 16 * vec_per_row; i += 32) {
    const int r = i / vec_per_row;
    const int c8 = (i % vec_per_row) * 8;
    const int row = q0 + warp * 16 + r;
    if (row >= a.Sq) continue;
    uint4 val;
    __nv_bfloat16* e = reinterpret_cast<__nv_bfloat16*>(&val);
#pragma unroll
    for (int u = 0; u < 8; ++u)
      e[u] = __float2bfloat16(accw[r * L.ldo + c8 + u] * a.scale);
    *reinterpret_cast<uint4*>(dqp + row * a.dq_ss + c8) = val;
  }
}

// One block: 64 key rows of one (b, kv head); walks the query tiles of every
// query head of its group from its first row's diagonal on.
__global__ void __launch_bounds__(THREADS) dkv_kernel(BwdArgs a) {
  extern __shared__ __align__(128) unsigned char smem[];
  const Layout L = make_layout(a.Dp, 2);
  __nv_bfloat16* Ks = reinterpret_cast<__nv_bfloat16*>(smem + L.t0);
  __nv_bfloat16* Vs = reinterpret_cast<__nv_bfloat16*>(smem + L.t1);
  __nv_bfloat16* Qs = reinterpret_cast<__nv_bfloat16*>(smem + L.t2);
  __nv_bfloat16* dOs = reinterpret_cast<__nv_bfloat16*>(smem + L.t3);
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  float* Sw = reinterpret_cast<float*>(smem + L.s_off) + warp * 16 * L.lds;
  float* dPw = reinterpret_cast<float*>(smem + L.dp_off) + warp * 16 * L.lds;
  __nv_bfloat16* Pw =
      reinterpret_cast<__nv_bfloat16*>(smem + L.p_off) + warp * 16 * L.ldp;
  __nv_bfloat16* dSw =
      reinterpret_cast<__nv_bfloat16*>(smem + L.ds_off) + warp * 16 * L.ldp;
  float* acck = reinterpret_cast<float*>(smem + L.acc0) + warp * 16 * L.ldo;
  float* accv = reinterpret_cast<float*>(smem + L.acc1) + warp * 16 * L.ldo;
  float* lse_s = reinterpret_cast<float*>(smem + L.vec_off);
  float* d_s = lse_s + 64;
  int* keystate = reinterpret_cast<int*>(smem + L.state_off);

  const int j0 = blockIdx.x * BK;
  const int hk = blockIdx.y;
  const int b = blockIdx.z;

  load_tile(Ks, L.ldt, a.k + b * a.k_sb + hk * a.k_sh, a.k_ss, j0, a.Skv,
            a.D, a.Dp);
  load_tile(Vs, L.ldt, a.v + b * a.v_sb + hk * a.v_sh, a.v_ss, j0, a.Skv,
            a.D, a.Dp);
  for (int c = threadIdx.x; c < BK; c += THREADS) {
    const int j = j0 + c;
    keystate[c] = j < a.Skv && (a.kv_valid == nullptr ||
                                a.kv_valid[b * a.Skv + j]);
  }
  for (int i = lane; i < 16 * L.ldo; i += 32) {
    acck[i] = 0.f;
    accv[i] = 0.f;
  }
  __syncwarp();
  const int diag = a.Skv - a.Sq;
  const int n_q = (a.Sq + BQ - 1) / BQ;
  // the first query row that sees key j0 under the causal mask
  int t_first = 0;
  if (a.causal) {
    const int first_row = j0 - diag;
    t_first = first_row <= 0 ? 0 : first_row / BQ;
  }

  for (int r = 0; r < a.rep; ++r) {
    const int h = hk * a.rep + r;
    const long long row_base = (static_cast<long long>(b) * a.H + h) * a.Sq;
    const __nv_bfloat16* qp = a.q + b * a.q_sb + h * a.q_sh;
    const __nv_bfloat16* dop = a.dout + b * a.do_sb + h * a.do_sh;
    for (int t = t_first; t < n_q; ++t) {
      const int i0 = t * BQ;
      __syncthreads();  // the previous tile's Q/dO fully consumed
      load_tile(Qs, L.ldt, qp, a.q_ss, i0, a.Sq, a.D, a.Dp);
      load_tile(dOs, L.ldt, dop, a.do_ss, i0, a.Sq, a.D, a.Dp);
      for (int c = threadIdx.x; c < BQ; c += THREADS) {
        const int qi = i0 + c;
        lse_s[c] = qi < a.Sq ? a.lse[row_base + qi] : 0.f;
        d_s[c] = qi < a.Sq ? a.dvec[row_base + qi] : 0.f;
      }
      __syncthreads();

      // S^T and dP^T: this warp's 16 keys against the tile's 64 queries
      rows_by_rows(Sw, L.lds, Ks + warp * 16 * L.ldt, Qs, L.ldt, a.Dp);
      rows_by_rows(dPw, L.lds, Vs + warp * 16 * L.ldt, dOs, L.ldt, a.Dp);
      __syncwarp();
      for (int i = lane; i < 16 * BQ; i += 32) {
        const int rr = i / BQ;
        const int c = i % BQ;
        const int kj = j0 + warp * 16 + rr;
        const int qi = i0 + c;
        bool keep = keystate[warp * 16 + rr] && qi < a.Sq;
        if (a.causal && kj > qi + diag) keep = false;
        const float p = keep ? expf(Sw[rr * L.lds + c] * a.scale - lse_s[c])
                             : 0.f;
        Pw[rr * L.ldp + c] = __float2bfloat16(p);
        dSw[rr * L.ldp + c] =
            __float2bfloat16(p * (dPw[rr * L.lds + c] - d_s[c]));
      }
      __syncwarp();
      accumulate(accv, L.ldo, Pw, L.ldp, dOs, L.ldt, a.Dp);
      accumulate(acck, L.ldo, dSw, L.ldp, Qs, L.ldt, a.Dp);
      __syncwarp();
    }
  }

  __nv_bfloat16* dkp = a.dk + b * a.dk_sb + hk * a.dk_sh;
  __nv_bfloat16* dvp = a.dv + b * a.dv_sb + hk * a.dv_sh;
  const int vec_per_row = a.D / 8;
  for (int i = lane; i < 16 * vec_per_row; i += 32) {
    const int rr = i / vec_per_row;
    const int c8 = (i % vec_per_row) * 8;
    const int row = j0 + warp * 16 + rr;
    if (row >= a.Skv) continue;
    uint4 kval, vval;
    __nv_bfloat16* ek = reinterpret_cast<__nv_bfloat16*>(&kval);
    __nv_bfloat16* ev = reinterpret_cast<__nv_bfloat16*>(&vval);
#pragma unroll
    for (int u = 0; u < 8; ++u) {
      ek[u] = __float2bfloat16(acck[rr * L.ldo + c8 + u] * a.scale);
      ev[u] = __float2bfloat16(accv[rr * L.ldo + c8 + u]);
    }
    *reinterpret_cast<uint4*>(dkp + row * a.dk_ss + c8) = kval;
    *reinterpret_cast<uint4*>(dvp + row * a.dv_ss + c8) = vval;
  }
}

}  // namespace

// The two entry points take the same arguments: emu_attention_bwd_dq
// launches the dQ kernel (and writes D), emu_attention_bwd_dkv the dK/dV
// kernel, which reads D; launch them in that order on one stream.
namespace {

int launch(bool dkv, const void* q, const void* k, const void* v,
           const void* o, const void* dout, const void* lse, void* dvec,
           const void* kv_valid, void* dq, void* dk, void* dv,
           const long long* st, int B, int H, int Hkv, int Sq, int Skv, int D,
           float scale, int causal, void* stream) {
  BwdArgs a;
  a.q = static_cast<const __nv_bfloat16*>(q);
  a.k = static_cast<const __nv_bfloat16*>(k);
  a.v = static_cast<const __nv_bfloat16*>(v);
  a.o = static_cast<const __nv_bfloat16*>(o);
  a.dout = static_cast<const __nv_bfloat16*>(dout);
  a.lse = static_cast<const float*>(lse);
  a.dvec = static_cast<float*>(dvec);
  a.kv_valid = static_cast<const unsigned char*>(kv_valid);
  a.dq = static_cast<__nv_bfloat16*>(dq);
  a.dk = static_cast<__nv_bfloat16*>(dk);
  a.dv = static_cast<__nv_bfloat16*>(dv);
  a.q_sb = st[0]; a.q_sh = st[1]; a.q_ss = st[2];
  a.k_sb = st[3]; a.k_sh = st[4]; a.k_ss = st[5];
  a.v_sb = st[6]; a.v_sh = st[7]; a.v_ss = st[8];
  a.o_sb = st[9]; a.o_sh = st[10]; a.o_ss = st[11];
  a.do_sb = st[12]; a.do_sh = st[13]; a.do_ss = st[14];
  a.dq_sb = st[15]; a.dq_sh = st[16]; a.dq_ss = st[17];
  a.dk_sb = st[18]; a.dk_sh = st[19]; a.dk_ss = st[20];
  a.dv_sb = st[21]; a.dv_sh = st[22]; a.dv_ss = st[23];
  a.H = H; a.Hkv = Hkv; a.rep = H / Hkv; a.Sq = Sq; a.Skv = Skv; a.D = D;
  a.Dp = (D + 15) / 16 * 16;
  a.scale = scale;
  a.causal = causal;
  cudaStream_t cs = static_cast<cudaStream_t>(stream);
  const Layout L = make_layout(a.Dp, dkv ? 2 : 1);
  const void* fn = dkv ? reinterpret_cast<const void*>(dkv_kernel)
                       : reinterpret_cast<const void*>(dq_kernel);
  cudaError_t err = cudaFuncSetAttribute(
      fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(L.total));
  if (err != cudaSuccess) return static_cast<int>(err);
  if (dkv)
    dkv_kernel<<<dim3((Skv + BK - 1) / BK, Hkv, B), THREADS, L.total, cs>>>(a);
  else
    dq_kernel<<<dim3((Sq + BQ - 1) / BQ, H, B), THREADS, L.total, cs>>>(a);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

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
