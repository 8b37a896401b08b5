// Kernel D: decode attention against the stacked head-major KV cache
// [L, B, Hkv, S, D], or against a page pool [L, n_pages, Hkv, page, D]
// through a page table [B, P] (PAGED), with bf16 or int8 values (T) and the
// current chunk's k/v as extra columns (the deferred cache write).
//
// Replaces the TPU kernels emu_tpu/ops/decode_attention.py:decode_attention
// and :paged_decode_attention (one body, `_kernel`, lines 38-141), in all
// their forms: Sq = 1 (the decode step) and Sq = qn <= 32 with k_new/v_new
// (the speculative verify chunk and the chunked-prefill mixed step, where
// query i also sees chunk column j iff j <= i); bf16 caches, and int8 caches
// with per-(head, token) fp32 scales folded into the score and into the
// probabilities before P.V (no dequantized copy is ever made).
//
// Arithmetic order follows the TPU kernel: score = (q . k) [* k_scale[j]]
// * scale, masked positions -1e30; an fp32 online softmax; the cache
// probabilities [* v_scale[j]] rounded to bf16 before the P.V product; the
// extra columns' probabilities and values stay fp32 (not rounded); out =
// acc / (l + 1e-30). The split designs run the softmax in base 2 (log2 e
// folded into the scale, as kernel A does).
//
// What bounds it on an H100: bytes at Sq = 1. Each step reads the layer's
// K and V planes once per (batch row, kv head) and does 2*D FLOPs per
// cached position per query row; int8 halves those bytes. At Sq = 32 the
// FLOPs per byte reach ~32 (bf16) to ~64 (int8), more than CUDA-core FMAs
// keep up with, so the chunk form runs its products on the tensor cores.
//
// The dense cache and the page pool take the split designs (their copies
// follow the page table, and the pool takes the dense cache's plan, so a
// paged lane computes what the dense one does, bit for bit). The host's
// decode_plan (ops/decode_attention.py, a function of the shape) cuts each
// (batch row, kv head) plane's key axis into `nsplit` splits of whole
// chunks; the grid is
// at most one wave of co-resident blocks, each walking (split, plane) items
// in a fixed stride. Every block:
// - reads the split's kv_valid bytes first and loads only the chunks that
//   carry weight: a chunk with no valid position adds exactly nothing once
//   the row has a live column (exp(-1e30 - m) is 0), which holds whenever
//   k_new is given or the row has a valid position; a row with neither
//   reads every chunk and averages all S values, as the twin does;
// - keeps its fp32 (m, l, acc) per query row; the last split also takes
//   the extra columns. With nsplit > 1 each split writes its state to a
//   workspace and the block that finishes a plane last (an atomic ticket)
//   merges the splits in split order: no float atomics, the same bits on
//   every run.
// Two designs, one per query count:
// - split rows (Sq = 1, rep = H/Hkv <= 8): 128 threads; thread 0 streams
//   each chunk of 32 positions (the K rows, the V rows and the int8 scales
//   are contiguous runs of a plane) with cp.async.bulk into a 4-deep
//   mbarrier ring; each warp takes 8 positions of a chunk, 8 or 16 lanes a
//   position reading the rows with 16-byte shared loads, for every query
//   head of the kv head (GQA shares each read); one chunk max per warp,
//   then the four warps' states merge.
// - split mma (Sq > 1, or rep > 8): kernel A's plan for M = rep * qn <= 64
//   query rows (queries innermost) on one m64 tile, with two consumer
//   warpgroups taking alternate chunks of an item (each its own online
//   softmax; they merge at the item's end) and a producer warpgroup that
//   gives them most of its registers (setmaxnreg). bf16 chunks of 64
//   positions come by TMA (a 3-D map over [L*B*Hkv, S, D]: rows past S
//   fill zeros) into a 6-deep ring; int8 chunks come raw into a 4-deep ring
//   (one bulk copy each of K and V) and the producer converts them to bf16
//   (exact) into the swizzled tiles of a 4-deep ring. From a page pool, a
//   bf16 chunk is 64 / g boxes of g = gcd(page, 64) rows through a map
//   over [L*n_pages*Hkv, page, D], each box's page looked up in the table
//   by its own producer lane; page % 8 == 0 puts every box on an 8-row
//   (1024-byte) atom of the 128-byte swizzle, so the tile is laid out as
//   the dense single box lays it, and a box past the table's end starts
//   past the map's rows and fills zeros; an int8 chunk is one bulk copy a
//   page run. The producer also writes each
//   chunk's column states and scales beside it. S = Q.K^T is an SS wgmma;
//   mask and k_scale apply on the accumulator registers; P (times v_scale,
//   rounded to bf16) is the register A operand of the P.V wgmma. The qn
//   extra columns, with their triangle, are one more tile through the same
//   Q.K^T; their fp32 p goes through shared memory and meets v_new in fp32
//   FMAs.
// Rows that are not whole 16-byte units (or int8 scales of an S that is not
// a multiple of 4), and a bf16 pool's chunk forms over pages that are not a
// multiple of 8 rows, keep the first designs:
// - row kernel (Sq = 1, rep <= 8): one block per (kv head, batch row), four
//   warps striding over cache positions, each warp keeping an fp32 online
//   softmax for all rep query heads in registers; the warp states merge in
//   shared memory.
// - chunk kernel (Sq > 1, or rep > 8): K/V chunks of 64 positions staged
//   in shared memory as bf16 while the next chunk's loads are in flight;
//   the [M, 64] scores and the P.V product are mma.sync m16n8k16; the
//   online softmax runs per row in shared memory. With the extra columns, a
//   chunk with no valid position is skipped.
// The layer index and the page lookup are pointer arithmetic: no per-layer
// slice and no contiguous per-slot copy of a paged cache is ever made.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>
#include <stdint.h>
#include <string.h>

#include "attention_tiles.cuh"

namespace {

constexpr float NEG = -1e30f;

struct Args {
  const __nv_bfloat16* q;
  long long q_sb, q_sq, q_sh;
  const void* k;
  const void* v;
  const float* ks;            // int8 scales, logical view [L, B, Hkv, S]
  const float* vs;
  const unsigned char* valid; // [B, S]
  const __nv_bfloat16* kn;    // [B, Hkv, qn, D] by strides, or null
  long long kn_sb, kn_sg, kn_sq;
  const __nv_bfloat16* vn;
  long long vn_sb, vn_sg, vn_sq;
  const int* table;           // [B, P] physical pages (PAGED)
  int P, n_pages, page;
  int box;                    // rows of a paged TMA box: gcd(page, 64)
  __nv_bfloat16* o;           // [B, qn, H, D] contiguous
  int B, H, Hkv, qn, S, D;
  long long layer;
  float scale;
  // the split designs (dense cache)
  int nsplit, cps;            // splits of the key axis, chunks in each
  int items;                  // B * Hkv * nsplit (split-major)
  float* ws_o;                // [B * Hkv, nsplit, rep * qn, D] partial acc
  float* ws_ml;               // [B * Hkv, nsplit, rep * qn, 2]: (m, l)
  int* cnt;                   // [B * Hkv] tickets, 0 between calls
};

__device__ inline float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ inline float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ inline float round_bf16(float x) {
  return __bfloat162float(__float2bfloat16(x));
}

__device__ inline float to_float(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ inline float to_float(int8_t x) { return static_cast<float>(x); }

// Element offset of cache row (b, g, j) of the current layer.
template <bool PAGED>
__device__ inline long long row_offset(const Args& a, int b, int g, int j) {
  if (PAGED) {
    const long long phys = a.table[static_cast<long long>(b) * a.P + j / a.page];
    return (((a.layer * a.n_pages + phys) * a.Hkv + g) * a.page + j % a.page) *
           static_cast<long long>(a.D);
  }
  return (((a.layer * a.B + b) * a.Hkv + g) * static_cast<long long>(a.S) + j) *
         a.D;
}

// Offset of (b, g, j) in the logical [L, B, Hkv, S] scale planes.
__device__ inline long long scale_offset(const Args& a, int b, int g, int j) {
  return ((a.layer * a.B + b) * a.Hkv + g) * static_cast<long long>(a.S) + j;
}

// ---------------------------------------------------------------------------
// Row kernel: Sq = 1, rep <= 8
// ---------------------------------------------------------------------------

constexpr int WARPS = 4;
constexpr int THREADS = WARPS * 32;
constexpr int MAXREP = 8;   // query heads per kv head
constexpr int DPL = 4;      // head-dim elements per lane: D <= 128

template <typename T, bool PAGED>
__global__ void __launch_bounds__(THREADS) decode_row_kernel(Args a) {
  constexpr bool QUANT = sizeof(T) == 1;
  __shared__ float m_w[WARPS][MAXREP];
  __shared__ float l_w[WARPS][MAXREP];
  __shared__ float a_w[WARPS][MAXREP][DPL * 32];

  const int g = blockIdx.x;
  const int b = blockIdx.y;
  const int rep = a.H / a.Hkv;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int D = a.D;

  float qr[MAXREP][DPL];
  float acc[MAXREP][DPL];
  float m[MAXREP], l[MAXREP];
#pragma unroll
  for (int r = 0; r < MAXREP; ++r) {
    m[r] = -INFINITY;
    l[r] = 0.f;
#pragma unroll
    for (int i = 0; i < DPL; ++i) {
      const int d = lane + 32 * i;
      acc[r][i] = 0.f;
      qr[r][i] = (r < rep && d < D)
                     ? __bfloat162float(a.q[b * a.q_sb + (g * rep + r) * a.q_sh + d])
                     : 0.f;
    }
  }

  // one key/value row: score every query head, update its running softmax.
  // Cache rows: s *= k_scale, p * v_scale rounded to bf16 before P.V; the
  // extra (in-flight) row: fp32 p and v, no rounding.
  auto visit = [&](const float* kv, const float* vv, bool keep, float ksc,
                   float vsc, bool extra) {
#pragma unroll
    for (int r = 0; r < MAXREP; ++r) {
      if (r < rep) {
        float part = 0.f;
#pragma unroll
        for (int i = 0; i < DPL; ++i) part += qr[r][i] * kv[i];
        float s = warp_sum(part);
        if (QUANT && !extra) s *= ksc;
        s *= a.scale;
        if (!keep) s = NEG;
        const float m_new = fmaxf(m[r], s);
        const float corr = expf(m[r] - m_new);
        const float p = expf(s - m_new);
        const float pb = extra ? p : round_bf16(QUANT ? p * vsc : p);
        l[r] = l[r] * corr + p;
        m[r] = m_new;
#pragma unroll
        for (int i = 0; i < DPL; ++i) acc[r][i] = acc[r][i] * corr + pb * vv[i];
      }
    }
  };

  const T* kc = static_cast<const T*>(a.k);
  const T* vc = static_cast<const T*>(a.v);
  for (int j = warp; j < a.S; j += WARPS) {
    const long long off = row_offset<PAGED>(a, b, g, j);
    float kv[DPL], vv[DPL];
#pragma unroll
    for (int i = 0; i < DPL; ++i) {
      const int d = lane + 32 * i;
      kv[i] = d < D ? to_float(kc[off + d]) : 0.f;
      vv[i] = d < D ? to_float(vc[off + d]) : 0.f;
    }
    float ksc = 1.f, vsc = 1.f;
    if (QUANT) {
      const long long so = scale_offset(a, b, g, j);
      ksc = a.ks[so];
      vsc = a.vs[so];
    }
    visit(kv, vv, a.valid[static_cast<long long>(b) * a.S + j] != 0, ksc, vsc,
          false);
  }
  if (a.kn != nullptr && warp == 0) {
    const __nv_bfloat16* kr = a.kn + b * a.kn_sb + g * a.kn_sg;
    const __nv_bfloat16* vr = a.vn + b * a.vn_sb + g * a.vn_sg;
    float kv[DPL], vv[DPL];
#pragma unroll
    for (int i = 0; i < DPL; ++i) {
      const int d = lane + 32 * i;
      kv[i] = d < D ? __bfloat162float(kr[d]) : 0.f;
      vv[i] = d < D ? __bfloat162float(vr[d]) : 0.f;
    }
    visit(kv, vv, true, 1.f, 1.f, true);
  }

#pragma unroll
  for (int r = 0; r < MAXREP; ++r) {
    if (r < rep) {
      if (lane == 0) {
        m_w[warp][r] = m[r];
        l_w[warp][r] = l[r];
      }
#pragma unroll
      for (int i = 0; i < DPL; ++i) a_w[warp][r][lane + 32 * i] = acc[r][i];
    }
  }
  __syncthreads();

  // merge the four warps' partial softmax states
  for (int e = threadIdx.x; e < rep * D; e += THREADS) {
    const int r = e / D;
    const int d = e % D;
    float mx = -INFINITY;
#pragma unroll
    for (int w = 0; w < WARPS; ++w) mx = fmaxf(mx, m_w[w][r]);
    float den = 0.f, num = 0.f;
#pragma unroll
    for (int w = 0; w < WARPS; ++w) {
      if (m_w[w][r] == -INFINITY) continue;  // a warp that saw no position
      const float c = expf(m_w[w][r] - mx);
      den += l_w[w][r] * c;
      num += a_w[w][r][d] * c;
    }
    a.o[(static_cast<long long>(b) * a.H + g * rep + r) * D + d] =
        __float2bfloat16(num / (den + 1e-30f));
  }
}

// ---------------------------------------------------------------------------
// Chunk kernel: M = rep * qn query rows per kv head (queries innermost),
// scores and P.V on the tensor cores (mma.sync m16n8k16, bf16 in, fp32 out)
// ---------------------------------------------------------------------------

constexpr int CT = 128;     // threads: four warps
constexpr int CS = 64;      // cache positions per staged chunk
constexpr int MAXM = 64;    // query rows per block
constexpr int MTS = MAXM / 16;            // m16 tiles of query rows
constexpr int NTW = 4;      // n8 tiles of the head dim per warp: D <= 128
constexpr int STAGE = CS * 128 / 8 / CT;  // 16-byte loads per thread, D <= 128
constexpr int PSP = CS + 8; // row pitch of the fp32 scores (float2 stores
                            // of a half warp fall in distinct banks)
constexpr int PBP = CS + 8; // row pitch of the bf16 probabilities

struct ChunkSmem {          // carved from the dynamic shared memory
  __nv_bfloat16* qs;        // [MP][D + 8]
  __nv_bfloat16* kt;        // [CS][D + 8]
  __nv_bfloat16* vt;        // [CS][D + 8]
  float* ps;                // [MP][PSP]: scores; the extra columns' fp32 p
  __nv_bfloat16* pb;        // [MP][PBP]: a cache chunk's p [* v_scale], bf16
  float* row_m;             // [MP]
  float* row_l;
  float* row_c;             // this chunk's correction factor
  float* ksc;               // [CS]
  float* vsc;
  int* flag;                // [CS]: 1 attend, 0 masked (-1e30), 2 absent
};

// MP = M rounded up to whole m16 tiles
__host__ __device__ inline size_t chunk_smem_bytes(int MP, int D) {
  const size_t dp = D + 8;
  return (static_cast<size_t>(MP) + 2 * CS) * dp * 2 +
         static_cast<size_t>(MP) * PSP * 4 + static_cast<size_t>(MP) * PBP * 2 +
         3 * static_cast<size_t>(MP) * 4 + 3 * CS * 4;
}

__device__ inline ChunkSmem carve(unsigned char* base, int MP, int D) {
  const int dp = D + 8;
  ChunkSmem s;
  s.qs = reinterpret_cast<__nv_bfloat16*>(base);
  s.kt = s.qs + MP * dp;
  s.vt = s.kt + CS * dp;
  s.ps = reinterpret_cast<float*>(s.vt + CS * dp);
  s.pb = reinterpret_cast<__nv_bfloat16*>(s.ps + MP * PSP);
  s.row_m = reinterpret_cast<float*>(s.pb + MP * PBP);
  s.row_l = s.row_m + MP;
  s.row_c = s.row_l + MP;
  s.ksc = s.row_c + MP;
  s.vsc = s.ksc + CS;
  s.flag = reinterpret_cast<int*>(s.vsc + CS);
  return s;
}

__device__ inline uint32_t ld32(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// two bf16 values as one mma operand register, `lo` in the low half
__device__ inline uint32_t pack2(__nv_bfloat16 lo, __nv_bfloat16 hi) {
  return static_cast<uint32_t>(__bfloat16_as_ushort(lo)) |
         (static_cast<uint32_t>(__bfloat16_as_ushort(hi)) << 16);
}

// c[16x8] += a[16x16] . b[16x8], bf16 operands, fp32 accumulators
__device__ inline void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0,%1,%2,%3}, "
      "{%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// A operand (rows r0..r0+15, columns k0..k0+15) of a row-major bf16 tile
__device__ inline void load_a(uint32_t (&a)[4], const __nv_bfloat16* base,
                              int pitch, int r0, int k0) {
  const int g = (threadIdx.x % 32) / 4, t = threadIdx.x % 4;
  const __nv_bfloat16* p = base + (r0 + g) * pitch + k0 + 2 * t;
  a[0] = ld32(p);
  a[1] = ld32(p + 8 * pitch);
  a[2] = ld32(p + 8);
  a[3] = ld32(p + 8 * pitch + 8);
}

// One staged 16-byte unit of a K/V row → bf16 pairs in shared memory: 8
// bf16 values as they are, or 16 int8 values converted (exactly).
template <typename T>
__device__ inline void stage_unit(const uint4& u, __nv_bfloat162* dst) {
  const unsigned int w[4] = {u.x, u.y, u.z, u.w};
  if constexpr (sizeof(T) == 2) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      __nv_bfloat162 p;
      memcpy(&p, &w[i], 4);
      dst[i] = p;
    }
  } else {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int8_t* q = reinterpret_cast<const int8_t*>(&w[i]);
      dst[2 * i] = __floats2bfloat162_rn(q[0], q[1]);
      dst[2 * i + 1] = __floats2bfloat162_rn(q[2], q[3]);
    }
  }
}

// ps[MP, CS] = Q . K^T of the staged rows, then scaled and masked. Warp w
// owns columns 16w..16w+15. A cache chunk folds k_scale and the flags;
// the extra columns (EXTRA) apply the intra-chunk triangle: query i sees
// column j < qn iff j <= i % qn.
template <bool QUANT, bool EXTRA>
__device__ inline void score_tile(const ChunkSmem& s, int MT, int D,
                                  float scale, int qn) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;
  const int dp = D + 8;
  float c[MTS][2][4];
#pragma unroll
  for (int mt = 0; mt < MTS; ++mt)
#pragma unroll
    for (int nt = 0; nt < 2; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) c[mt][nt][e] = 0.f;
  for (int k0 = 0; k0 < D; k0 += 16) {
    uint32_t bk[2][2];
#pragma unroll
    for (int nt = 0; nt < 2; ++nt) {
      const __nv_bfloat16* p = s.kt + (warp * 16 + nt * 8 + g) * dp + k0 + 2 * t;
      bk[nt][0] = ld32(p);
      bk[nt][1] = ld32(p + 8);
    }
#pragma unroll
    for (int mt = 0; mt < MTS; ++mt) {
      if (mt < MT) {
        uint32_t aq[4];
        load_a(aq, s.qs, dp, mt * 16, k0);
        mma_bf16(c[mt][0], aq, bk[0]);
        mma_bf16(c[mt][1], aq, bk[1]);
      }
    }
  }
#pragma unroll
  for (int mt = 0; mt < MTS; ++mt) {
    if (mt >= MT) continue;
#pragma unroll
    for (int nt = 0; nt < 2; ++nt) {
      const int col = warp * 16 + nt * 8 + 2 * t;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int row = mt * 16 + g + 8 * h;
        float x[2];
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int j = col + e;
          float sc = c[mt][nt][2 * h + e];
          if (EXTRA) {
            sc = j >= qn ? -INFINITY : (j > row % qn ? NEG : sc * scale);
          } else {
            const int f = s.flag[j];
            if (QUANT) sc *= s.ksc[j];
            sc = f == 2 ? -INFINITY : (f == 0 ? NEG : sc * scale);
          }
          x[e] = sc;
        }
        *reinterpret_cast<float2*>(s.ps + row * PSP + col) = make_float2(x[0], x[1]);
      }
    }
  }
}

// Online-softmax update of the M live rows over the CS staged columns. A
// cache chunk writes p [* v_scale] rounded to bf16 into pb (the P.V
// operand); the extra columns keep fp32 p in ps.
template <bool QUANT, bool EXTRA>
__device__ inline void softmax_update(const ChunkSmem& s, int M) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  for (int i = warp; i < M; i += CT / 32) {
    float* row = s.ps + i * PSP;
    const float s0 = row[lane], s1 = row[lane + 32];
    const float m_old = s.row_m[i];
    const float m_new = fmaxf(m_old, warp_max(fmaxf(s0, s1)));
    const float p0 = expf(s0 - m_new), p1 = expf(s1 - m_new);
    const float corr = expf(m_old - m_new);
    const float sum = warp_sum(p0 + p1);
    if (EXTRA) {
      row[lane] = p0;
      row[lane + 32] = p1;
    } else {
      __nv_bfloat16* pr = s.pb + i * PBP;
      pr[lane] = __float2bfloat16(QUANT ? p0 * s.vsc[lane] : p0);
      pr[lane + 32] = __float2bfloat16(QUANT ? p1 * s.vsc[lane + 32] : p1);
    }
    if (lane == 0) {
      s.row_l[i] = s.row_l[i] * corr + sum;
      s.row_m[i] = m_new;
      s.row_c[i] = corr;
    }
  }
}

// The head-dim n8 tiles of warp w are w, w + 4, w + 8, w + 12 (those < D/8).
__device__ inline bool owns_tile(int nt, int D) {
  return ((threadIdx.x / 32) + 4 * nt) * 8 < D;
}

__device__ inline void rescale(const ChunkSmem& s, int MT, int D,
                               float (&acc)[MTS][NTW][4]) {
  const int g = (threadIdx.x % 32) / 4;
#pragma unroll
  for (int mt = 0; mt < MTS; ++mt) {
    if (mt >= MT) continue;
    const float c0 = s.row_c[mt * 16 + g], c1 = s.row_c[mt * 16 + g + 8];
#pragma unroll
    for (int nt = 0; nt < NTW; ++nt) {
      acc[mt][nt][0] *= c0;
      acc[mt][nt][1] *= c0;
      acc[mt][nt][2] *= c1;
      acc[mt][nt][3] *= c1;
    }
  }
}

// acc = acc * corr + P . V over a staged cache chunk (bf16 P from pb)
__device__ inline void pv_tile(const ChunkSmem& s, int MT, int D,
                               float (&acc)[MTS][NTW][4]) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;
  const int dp = D + 8;
  rescale(s, MT, D, acc);
#pragma unroll
  for (int k0 = 0; k0 < CS; k0 += 16) {
    uint32_t bv[NTW][2];
#pragma unroll
    for (int nt = 0; nt < NTW; ++nt) {
      if (!owns_tile(nt, D)) continue;
      const __nv_bfloat16* p = s.vt + (k0 + 2 * t) * dp + (warp + 4 * nt) * 8 + g;
      bv[nt][0] = pack2(p[0], p[dp]);
      bv[nt][1] = pack2(p[8 * dp], p[9 * dp]);
    }
#pragma unroll
    for (int mt = 0; mt < MTS; ++mt) {
      if (mt >= MT) continue;
      uint32_t ap[4];
      load_a(ap, s.pb, PBP, mt * 16, k0);
#pragma unroll
      for (int nt = 0; nt < NTW; ++nt)
        if (owns_tile(nt, D)) mma_bf16(acc[mt][nt], ap, bv[nt]);
    }
  }
}

// acc = acc * corr + p_n . v_new over the extra columns, fp32 throughout
// (the TPU kernel rounds neither p_n nor v_new)
__device__ inline void pv_extra(const ChunkSmem& s, int MT, int D, int qn,
                                float (&acc)[MTS][NTW][4]) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;
  const int dp = D + 8;
  rescale(s, MT, D, acc);
  for (int j = 0; j < qn; ++j) {
#pragma unroll
    for (int mt = 0; mt < MTS; ++mt) {
      if (mt >= MT) continue;
      const float p0 = s.ps[(mt * 16 + g) * PSP + j];
      const float p1 = s.ps[(mt * 16 + g + 8) * PSP + j];
#pragma unroll
      for (int nt = 0; nt < NTW; ++nt) {
        if (!owns_tile(nt, D)) continue;
        const float2 v = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(
            s.vt + j * dp + (warp + 4 * nt) * 8 + 2 * t));
        acc[mt][nt][0] = fmaf(p0, v.x, acc[mt][nt][0]);
        acc[mt][nt][1] = fmaf(p0, v.y, acc[mt][nt][1]);
        acc[mt][nt][2] = fmaf(p1, v.x, acc[mt][nt][2]);
        acc[mt][nt][3] = fmaf(p1, v.y, acc[mt][nt][3]);
      }
    }
  }
}

template <typename T, bool PAGED>
__global__ void __launch_bounds__(CT) decode_chunk_kernel(Args a) {
  constexpr bool QUANT = sizeof(T) == 1;
  constexpr int VEC = 16 / sizeof(T);             // elements per 16-byte load
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int gh = blockIdx.x;                      // kv head
  const int b = blockIdx.y;
  const int rep = a.H / a.Hkv;
  const int qn = a.qn;
  const int M = rep * qn;
  const int MT = (M + 15) / 16;
  const int D = a.D;
  const int dp = D + 8;
  const ChunkSmem s = carve(smem_raw, MT * 16, D);

  // q rows, zero-padded to whole m16 tiles: row i = r * qn + qi is query
  // qi of head gh * rep + r. The padded rows' P stays zero.
  for (int e = threadIdx.x; e < MT * 16 * D; e += CT) {
    const int i = e / D, d = e % D;
    const int r = i / qn, qi = i % qn;
    s.qs[i * dp + d] = i < M ? a.q[b * a.q_sb + qi * a.q_sq + (gh * rep + r) * a.q_sh + d]
                             : __float2bfloat16(0.f);
  }
  for (int e = threadIdx.x; e < MT * 16 * PBP; e += CT) s.pb[e] = __float2bfloat16(0.f);
  for (int i = threadIdx.x; i < MT * 16; i += CT) {
    s.row_m[i] = NEG;       // the TPU kernel's initial running max
    s.row_l[i] = 0.f;
  }
  float acc[MTS][NTW][4];
#pragma unroll
  for (int mt = 0; mt < MTS; ++mt)
#pragma unroll
    for (int nt = 0; nt < NTW; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mt][nt][e] = 0.f;

  // The next chunk's K/V rows, flag and scales are loaded into registers
  // while the current chunk is computed.
  const T* kc = static_cast<const T*>(a.k);
  const T* vc = static_cast<const T*>(a.v);
  const int units = CS * (D / VEC);               // per plane and chunk
  uint4 kr[STAGE], vr[STAGE];
  int fl = 2;
  float ks = 1.f, vs = 0.f;
  auto fetch = [&](int j0) {
    const int n = min(CS, a.S - j0);
#pragma unroll
    for (int u = 0; u < STAGE; ++u) {
      const int e = threadIdx.x + u * CT;
      const int j = e / (D / VEC), c = e % (D / VEC);
      kr[u] = vr[u] = make_uint4(0, 0, 0, 0);
      if (e < units && j < n) {
        const long long off = row_offset<PAGED>(a, b, gh, j0 + j) + c * VEC;
        kr[u] = *reinterpret_cast<const uint4*>(kc + off);
        vr[u] = *reinterpret_cast<const uint4*>(vc + off);
      }
    }
    const int j = threadIdx.x;
    fl = 2;
    ks = 1.f;
    vs = 0.f;
    if (j < n) {
      fl = a.valid[static_cast<long long>(b) * a.S + j0 + j] != 0;
      if (QUANT) {
        const long long so = scale_offset(a, b, gh, j0 + j);
        ks = a.ks[so];
        vs = a.vs[so];
      }
    }
  };

  fetch(0);
  for (int j0 = 0; j0 < a.S; j0 += CS) {
    __syncthreads();        // the previous chunk's readers are done
#pragma unroll
    for (int u = 0; u < STAGE; ++u) {
      const int e = threadIdx.x + u * CT;
      if (e >= units) break;
      const int j = e / (D / VEC), c = e % (D / VEC);
      stage_unit<T>(kr[u], reinterpret_cast<__nv_bfloat162*>(s.kt + j * dp) + c * VEC / 2);
      stage_unit<T>(vr[u], reinterpret_cast<__nv_bfloat162*>(s.vt + j * dp) + c * VEC / 2);
    }
    if (threadIdx.x < CS) {
      s.flag[threadIdx.x] = fl;
      s.ksc[threadIdx.x] = ks;
      s.vsc[threadIdx.x] = vs;
    }
    // With the extra columns every row sees at least one column, so a
    // chunk with no valid position adds exactly nothing: skip it.
    const bool any = __syncthreads_or(threadIdx.x < CS && fl == 1);
    if (j0 + CS < a.S) fetch(j0 + CS);
    if (!any && a.kn != nullptr) continue;
    score_tile<QUANT, false>(s, MT, D, a.scale, qn);
    __syncthreads();
    softmax_update<QUANT, false>(s, M);
    __syncthreads();
    pv_tile(s, MT, D, acc);
  }

  if (a.kn != nullptr) {
    __syncthreads();
    for (int e = threadIdx.x; e < qn * (D / 2); e += CT) {
      const int j = e / (D / 2), w = e % (D / 2);
      reinterpret_cast<__nv_bfloat162*>(s.kt + j * dp)[w] =
          reinterpret_cast<const __nv_bfloat162*>(a.kn + b * a.kn_sb + gh * a.kn_sg +
                                                   j * a.kn_sq)[w];
      reinterpret_cast<__nv_bfloat162*>(s.vt + j * dp)[w] =
          reinterpret_cast<const __nv_bfloat162*>(a.vn + b * a.vn_sb + gh * a.vn_sg +
                                                   j * a.vn_sq)[w];
    }
    __syncthreads();
    score_tile<QUANT, true>(s, MT, D, a.scale, qn);
    __syncthreads();
    softmax_update<QUANT, true>(s, M);
    __syncthreads();
    pv_extra(s, MT, D, qn, acc);
  }
  __syncthreads();

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;
#pragma unroll
  for (int mt = 0; mt < MTS; ++mt) {
    if (mt >= MT) continue;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int i = mt * 16 + g + 8 * h;
      if (i >= M) continue;
      const int r = i / qn, qi = i % qn;
      const float den = s.row_l[i] + 1e-30f;
      __nv_bfloat16* out = a.o + ((static_cast<long long>(b) * qn + qi) * a.H + gh * rep + r) * D;
#pragma unroll
      for (int nt = 0; nt < NTW; ++nt) {
        if (!owns_tile(nt, D)) continue;
        const int d = (warp + 4 * nt) * 8 + 2 * t;
        *reinterpret_cast<__nv_bfloat162*>(out + d) = __floats2bfloat162_rn(
            acc[mt][nt][2 * h] / den, acc[mt][nt][2 * h + 1] / den);
      }
    }
  }
}

// ---------------------------------------------------------------------------
// The split designs: dense cache, key axis split over blocks
// ---------------------------------------------------------------------------

constexpr float LOG2E = 1.4426950408889634f;
constexpr int MAXC = 32;        // chunks per split (the plan keeps to it)
constexpr int MAX_QN = 32;      // queries per row with k_new/v_new

// Elements [c, c + 8) of a bf16 row (any alignment; zeros from column n
// on) as one 16-byte unit.
__device__ inline uint4 load8_bf16(const __nv_bfloat16* row, int c, int n) {
  const __nv_bfloat16* p = row + c;
  if (c + 8 <= n && (reinterpret_cast<uintptr_t>(p) & 15) == 0)
    return *reinterpret_cast<const uint4*>(p);
  __nv_bfloat16 v[8];
#pragma unroll
  for (int x = 0; x < 8; ++x) v[x] = c + x < n ? p[x] : __float2bfloat16(0.f);
  uint4 u;
  memcpy(&u, v, 16);
  return u;
}

// The (split, plane) of a work item (split-major: the heavy first splits of
// every plane spread over the grid) and the split's chunk range.
struct Item {
  int split, pair, b, g, c0, c1, j_lo, j_hi;
  long long plane;              // (layer * B + b) * Hkv + g
};

__device__ inline Item item_of(const Args& a, int item, int cs) {
  Item it;
  const int pairs = a.B * a.Hkv;
  const int nch = (a.S + cs - 1) / cs;
  it.split = item / pairs;
  it.pair = item % pairs;
  it.b = it.pair / a.Hkv;
  it.g = it.pair % a.Hkv;
  it.c0 = it.split * a.cps;
  it.c1 = min(it.c0 + a.cps, nch);
  it.j_lo = it.c0 * cs;
  it.j_hi = min(it.c1 * cs, a.S);
  it.plane = (a.layer * a.B + it.b) * a.Hkv + it.g;
  return it;
}

// Reads the split's kv_valid bytes into vflag and lists the chunks to load
// in live[] (their count in *n_live). A chunk with no valid position is
// left out when the row has a live column elsewhere (k_new, or a valid
// position anywhere in the row): its columns then add exactly 0. Every
// thread of the block calls it; it ends with the list visible to all.
template <int CS, int NT>
__device__ inline void live_chunks(const Args& a, const Item& it, unsigned char* vflag,
                                   int* any_c, int* live, int* n_live) {
  for (int c = threadIdx.x; c < it.c1 - it.c0; c += NT) any_c[c] = 0;
  // every byte this thread reads, loaded before any is stored (one latency)
  constexpr int PER = (MAXC * CS + NT - 1) / NT;
  const unsigned char* vrow = a.valid + static_cast<long long>(it.b) * a.S;
  unsigned char vb[PER];
#pragma unroll
  for (int k = 0; k < PER; ++k) {
    const int j = it.j_lo + threadIdx.x + k * NT;
    vb[k] = j < it.j_hi ? vrow[j] : 0;
  }
  __syncthreads();
#pragma unroll
  for (int k = 0; k < PER; ++k) {
    const int j = it.j_lo + threadIdx.x + k * NT;
    if (j >= it.j_hi) break;
    vflag[j - it.j_lo] = vb[k];
    if (vb[k]) any_c[(j - it.j_lo) / CS] = 1;
  }
  int seen = 0;
  if (a.kn == nullptr)
    for (int j = threadIdx.x; j < a.S; j += NT) seen |= vrow[j];
  const int row_live = __syncthreads_or(seen);
  if (threadIdx.x == 0) {
    const bool skip = row_live || a.kn != nullptr;
    int n = 0;
    for (int c = 0; c < it.c1 - it.c0; ++c)
      if (!skip || any_c[c]) live[n++] = it.c0 + c;
    *n_live = n;
  }
  __syncthreads();
}

// Merges the splits of one plane in split order: row r (of M), columns d.
// m = -inf marks a split that saw no column.
__device__ inline float merge_splits(const Args& a, int pair, int M, int r, int d, float* den) {
  const long long base = static_cast<long long>(pair) * a.nsplit * M;
  float mx = -INFINITY;
  for (int sp = 0; sp < a.nsplit; ++sp)
    mx = fmaxf(mx, __ldcg(a.ws_ml + ((base + sp * M + r) * 2)));
  float num = 0.f, l = 0.f;
  for (int sp = 0; sp < a.nsplit; ++sp) {
    const long long o = base + sp * M + r;
    const float ms = __ldcg(a.ws_ml + o * 2);
    if (ms == -INFINITY) continue;
    const float c = exp2f(ms - mx);
    l += __ldcg(a.ws_ml + o * 2 + 1) * c;
    num += __ldcg(a.ws_o + o * a.D + d) * c;
  }
  *den = l;
  return num;
}

// After every thread of the `n` participating threads has written its
// split state: one ticket per plane; true in the block that came last.
__device__ inline bool last_of_plane(const Args& a, int pair, int* flag, int bar_id, int n) {
  __threadfence();
  named_barrier(bar_id, n);
  if (threadIdx.x % n == 0) *flag = atomicAdd(a.cnt + pair, 1) == a.nsplit - 1;
  named_barrier(bar_id, n);
  const bool last = *flag;
  if (last) __threadfence();
  return last;
}

// ---- split rows: Sq = 1, rep <= 8 ------------------------------------------

constexpr int RS_CS = 32;       // cache positions per chunk
// chunks in flight: 4 of bf16 (66 KB a block, three an SM), 6 of int8
__host__ __device__ constexpr int rs_stages(int itemsize) { return itemsize == 1 ? 6 : 4; }

template <typename T, int REPT>
struct RowPlan {
  static constexpr int DPL = REPT <= 2 ? 16 : 8;           // head dims per lane
  static constexpr int LPP = 128 / DPL;                    // lanes per position
  static constexpr int PPR = 32 / LPP;                     // positions per warp round
  static constexpr int ROUNDS = RS_CS / WARPS / PPR;       // rounds per chunk
  static constexpr int VEC = (16 / static_cast<int>(sizeof(T))) < DPL
                                 ? 16 / static_cast<int>(sizeof(T)) : DPL;
  static constexpr int NV = DPL / VEC;                     // vector reads per row
};

__host__ __device__ inline int rows_stage_bytes(int D, int itemsize) {
  return 2 * RS_CS * D * itemsize + 2 * RS_CS * 4;
}

__host__ __device__ inline int rows_smem(int D, int itemsize) {
  return rs_stages(itemsize) * rows_stage_bytes(D, itemsize) + MAXC * RS_CS;
}

// VEC elements of a cache row (one 16- or 8-byte shared load) as floats.
template <typename T, int VEC>
__device__ inline void load_vec(const T* p, float* out) {
  if constexpr (sizeof(T) == 2) {
    if constexpr (VEC == 8) {
      const uint4 u = *reinterpret_cast<const uint4*>(p);
      const uint32_t w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        out[2 * i] = __uint_as_float(w[i] << 16);
        out[2 * i + 1] = __uint_as_float(w[i] & 0xFFFF0000u);
      }
    }
  } else {
    uint32_t w[VEC / 4];
    if constexpr (VEC == 16) {
      const uint4 u = *reinterpret_cast<const uint4*>(p);
      w[0] = u.x; w[1] = u.y; w[2] = u.z; w[3] = u.w;
    } else {
      const uint2 u = *reinterpret_cast<const uint2*>(p);
      w[0] = u.x; w[1] = u.y;
    }
    // a signed byte b as fp32: (0x4B000000 | (b + 128)) - (2^23 + 128)
#pragma unroll
    for (int i = 0; i < VEC / 4; ++i) {
      const uint32_t x = w[i] ^ 0x80808080u;
      out[4 * i + 0] = __uint_as_float(__byte_perm(x, 0x4B000000u, 0x7540)) - 8388736.f;
      out[4 * i + 1] = __uint_as_float(__byte_perm(x, 0x4B000000u, 0x7541)) - 8388736.f;
      out[4 * i + 2] = __uint_as_float(__byte_perm(x, 0x4B000000u, 0x7542)) - 8388736.f;
      out[4 * i + 3] = __uint_as_float(__byte_perm(x, 0x4B000000u, 0x7543)) - 8388736.f;
    }
  }
}

template <typename T, int REPT, bool PAGED>
__global__ void __launch_bounds__(THREADS) decode_split_rows_kernel(Args a) {
  using P = RowPlan<T, REPT>;
  constexpr bool QUANT = sizeof(T) == 1;
  constexpr int RS_STAGES = rs_stages(sizeof(T));
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ uint64_t full[RS_STAGES];
  __shared__ int any_c[MAXC], live[MAXC];
  __shared__ int n_live, last_flag;
  __shared__ float m_w[WARPS][REPT], l_w[WARPS][REPT], s_ext[REPT];
  const int D = a.D, rep = a.H / a.Hkv;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int u = lane % P::LPP, grp = lane / P::LPP;
  const int row_bytes = D * static_cast<int>(sizeof(T));
  const int stage_bytes = rows_stage_bytes(D, sizeof(T));
  unsigned char* vflag = smem + RS_STAGES * stage_bytes;
  float* acc_w = reinterpret_cast<float*>(smem);   // [WARPS][REPT][D], after the chunks
  const float sl2 = a.scale * LOG2E;
  if (threadIdx.x == 0) {
    for (int s = 0; s < RS_STAGES; ++s) mbar_init(&full[s], 1);
    mbar_fence_init();
  }
  __syncthreads();

  int used = 0;   // chunks this block has taken through the ring
  for (int item = blockIdx.x; item < a.items; item += gridDim.x) {
    const Item it = item_of(a, item, RS_CS);
    const bool extra = a.kn != nullptr && it.split == a.nsplit - 1;
    // the item's query rows first: their loads overlap the list's
    float qv[REPT][P::DPL];
#pragma unroll
    for (int r = 0; r < REPT; ++r)
#pragma unroll
      for (int v = 0; v < P::NV; ++v)
#pragma unroll
        for (int e = 0; e < P::VEC; ++e) {
          const int d = v * P::LPP * P::VEC + u * P::VEC + e;
          qv[r][v * P::VEC + e] =
              (r < rep && d < D)
                  ? __bfloat162float(a.q[it.b * a.q_sb + (it.g * rep + r) * a.q_sh + d])
                  : 0.f;
        }
    __syncthreads();   // the previous item's readers of the lists are done
    live_chunks<RS_CS, THREADS>(a, it, vflag, any_c, live, &n_live);
    const int nl = n_live;

    // thread 0: one bulk copy each for the chunk's K rows, V rows (PAGED:
    // one a page the chunk touches) and (int8) k/v scales, all contiguous
    auto issue = [&](int i) {
      const int s = (used + i) % RS_STAGES;
      const int j0 = live[i] * RS_CS, n = min(RS_CS, a.S - j0);
      unsigned char* st = smem + s * stage_bytes;
      const long long row0 = it.plane * a.S + j0;   // the logical view's row
      const uint32_t kvb = n * row_bytes;
      mbar_arrive_tx(&full[s], 2 * kvb + (QUANT ? 8 * n : 0));
      for (int j = j0; j < j0 + n;) {
        const int len = PAGED ? min(a.page - j % a.page, j0 + n - j) : n;
        const long long src = row_offset<PAGED>(a, it.b, it.g, j) / a.D * row_bytes;
        bulk_load(st + (j - j0) * row_bytes, static_cast<const char*>(a.k) + src,
                  len * row_bytes, &full[s]);
        bulk_load(st + RS_CS * row_bytes + (j - j0) * row_bytes,
                  static_cast<const char*>(a.v) + src, len * row_bytes, &full[s]);
        j += len;
      }
      if (QUANT) {
        bulk_load(st + 2 * RS_CS * row_bytes, a.ks + row0, 4 * n, &full[s]);
        bulk_load(st + 2 * RS_CS * row_bytes + 4 * RS_CS, a.vs + row0, 4 * n, &full[s]);
      }
    };
    if (threadIdx.x == 0) {
      fence_async_smem();   // the previous item's generic writes to the stages
      for (int i = 0; i < min(nl, RS_STAGES); ++i) issue(i);
    }

    float m[REPT], l[REPT], acc[REPT][P::DPL];
#pragma unroll
    for (int r = 0; r < REPT; ++r) {
      m[r] = -INFINITY;
      l[r] = 0.f;
#pragma unroll
      for (int e = 0; e < P::DPL; ++e) acc[r][e] = 0.f;
    }

    for (int i = 0; i < nl; ++i) {
      const int s = (used + i) % RS_STAGES;
      mbar_wait(&full[s], ((used + i) / RS_STAGES) & 1);
      const int j0 = live[i] * RS_CS, n = min(RS_CS, a.S - j0);
      const unsigned char* st = smem + s * stage_bytes;
      const T* kt = reinterpret_cast<const T*>(st);
      const T* vt = reinterpret_cast<const T*>(st + RS_CS * row_bytes);
      const float* kss = reinterpret_cast<const float*>(st + 2 * RS_CS * row_bytes);
      const float* vss = kss + RS_CS;

      float sc[P::ROUNDS][REPT], mx[REPT];
#pragma unroll
      for (int r = 0; r < REPT; ++r) mx[r] = -INFINITY;
#pragma unroll
      for (int rd = 0; rd < P::ROUNDS; ++rd) {
        const int pos = warp * (RS_CS / WARPS) + rd * P::PPR + grp;
        const bool in = pos < n;
        float kv[P::DPL];
#pragma unroll
        for (int v = 0; v < P::NV; ++v) {
          const int d0 = v * P::LPP * P::VEC + u * P::VEC;
          if (in && d0 < D) {
            load_vec<T, P::VEC>(kt + pos * D + d0, kv + v * P::VEC);
          } else {
#pragma unroll
            for (int e = 0; e < P::VEC; ++e) kv[v * P::VEC + e] = 0.f;
          }
        }
        const float ksc = QUANT && in ? kss[pos] : 1.f;
        const bool keep = in && vflag[j0 + pos - it.j_lo] != 0;
#pragma unroll
        for (int r = 0; r < REPT; ++r) {
          float pp[4] = {0.f, 0.f, 0.f, 0.f};   // four chains, not one
#pragma unroll
          for (int e = 0; e < P::DPL; ++e) pp[e % 4] = fmaf(qv[r][e], kv[e], pp[e % 4]);
          float part = (pp[0] + pp[1]) + (pp[2] + pp[3]);
#pragma unroll
          for (int o = P::LPP / 2; o > 0; o >>= 1) part += __shfl_xor_sync(0xffffffffu, part, o);
          float x = part;
          if (QUANT) x *= ksc;
          x *= sl2;
          if (!keep) x = NEG;
          if (!in) x = -INFINITY;
          sc[rd][r] = x;
          mx[r] = fmaxf(mx[r], x);
        }
      }
#pragma unroll
      for (int r = 0; r < REPT; ++r) {
#pragma unroll
        for (int o = P::LPP; o < 32; o <<= 1)
          mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], o));
        const float m_new = fmaxf(m[r], mx[r]);
        const float corr = m_new == -INFINITY ? 1.f : exp2f(m[r] - m_new);
        m[r] = m_new;
        l[r] *= corr;
#pragma unroll
        for (int e = 0; e < P::DPL; ++e) acc[r][e] *= corr;
      }
#pragma unroll
      for (int rd = 0; rd < P::ROUNDS; ++rd) {
        const int pos = warp * (RS_CS / WARPS) + rd * P::PPR + grp;
        const bool in = pos < n;
        float vv[P::DPL];
#pragma unroll
        for (int v = 0; v < P::NV; ++v) {
          const int d0 = v * P::LPP * P::VEC + u * P::VEC;
          if (in && d0 < D) {
            load_vec<T, P::VEC>(vt + pos * D + d0, vv + v * P::VEC);
          } else {
#pragma unroll
            for (int e = 0; e < P::VEC; ++e) vv[v * P::VEC + e] = 0.f;
          }
        }
        const float vsc = QUANT && in ? vss[pos] : 1.f;
#pragma unroll
        for (int r = 0; r < REPT; ++r) {
          const float p = sc[rd][r] == -INFINITY ? 0.f : exp2f(sc[rd][r] - m[r]);
          if (u == 0) l[r] += p;
          const float pb = round_bf16(QUANT ? p * vsc : p);
#pragma unroll
          for (int e = 0; e < P::DPL; ++e) acc[r][e] = fmaf(pb, vv[e], acc[r][e]);
        }
      }
      __syncthreads();   // every warp is done with stage s
      if (threadIdx.x == 0 && i + RS_STAGES < nl) issue(i + RS_STAGES);
    }
    used += nl;

    // the warp's state: l over its lanes, acc over its position groups
#pragma unroll
    for (int r = 0; r < REPT; ++r) {
      l[r] = warp_sum(l[r]);
#pragma unroll
      for (int e = 0; e < P::DPL; ++e)
#pragma unroll
        for (int o = P::LPP; o < 32; o <<= 1)
          acc[r][e] += __shfl_xor_sync(0xffffffffu, acc[r][e], o);
    }
    __syncthreads();   // the stages are free: acc_w aliases them
#pragma unroll
    for (int r = 0; r < REPT; ++r) {
      if (lane == 0) {
        m_w[warp][r] = m[r];
        l_w[warp][r] = l[r];
      }
      if (grp == 0) {
#pragma unroll
        for (int v = 0; v < P::NV; ++v)
#pragma unroll
          for (int e = 0; e < P::VEC; ++e) {
            const int d = v * P::LPP * P::VEC + u * P::VEC + e;
            if (d < D) acc_w[(warp * REPT + r) * D + d] = acc[r][v * P::VEC + e];
          }
      }
    }
    if (extra) {
      // the extra column's score for each query head: (q . k_new) * scale
      const __nv_bfloat16* kr = a.kn + it.b * a.kn_sb + it.g * a.kn_sg;
      for (int r = warp; r < rep; r += WARPS) {
        float part = 0.f;
        for (int d = lane; d < D; d += 32)
          part += __bfloat162float(a.q[it.b * a.q_sb + (it.g * rep + r) * a.q_sh + d]) *
                  __bfloat162float(kr[d]);
        part = warp_sum(part);
        if (lane == 0) s_ext[r] = part * sl2;
      }
    }
    __syncthreads();

    // merge the warps (and the extra column): this split's (m, l, acc)
    const __nv_bfloat16* vr = extra ? a.vn + it.b * a.vn_sb + it.g * a.vn_sg : nullptr;
    for (int e = threadIdx.x; e < rep * D; e += THREADS) {
      const int r = e / D, d = e % D;
      float mx = -INFINITY;
#pragma unroll
      for (int w = 0; w < WARPS; ++w) mx = fmaxf(mx, m_w[w][r]);
      float den = 0.f, num = 0.f;
#pragma unroll
      for (int w = 0; w < WARPS; ++w) {
        if (m_w[w][r] == -INFINITY) continue;   // a warp that saw no column
        const float c = exp2f(m_w[w][r] - mx);
        den += l_w[w][r] * c;
        num += acc_w[(w * REPT + r) * D + d] * c;
      }
      if (extra) {
        const float se = s_ext[r];
        const float m2 = fmaxf(mx, se);
        const float c = exp2f(mx - m2), p = exp2f(se - m2);
        den = den * c + p;
        num = num * c + p * __bfloat162float(vr[d]);
        mx = m2;
      }
      if (a.nsplit == 1) {
        a.o[(static_cast<long long>(it.b) * a.H + it.g * rep + r) * D + d] =
            __float2bfloat16(num / (den + 1e-30f));
      } else {
        const long long o = (static_cast<long long>(it.pair) * a.nsplit + it.split) * rep + r;
        a.ws_o[o * D + d] = num;
        if (d == 0) {
          a.ws_ml[o * 2] = mx;
          a.ws_ml[o * 2 + 1] = den;
        }
      }
    }
    fence_async_smem();   // acc_w's writes before the next item's bulk copies
    if (a.nsplit > 1 && last_of_plane(a, it.pair, &last_flag, 1, THREADS)) {
      for (int e = threadIdx.x; e < rep * D; e += THREADS) {
        const int r = e / D, d = e % D;
        float den;
        const float num = merge_splits(a, it.pair, rep, r, d, &den);
        a.o[(static_cast<long long>(it.b) * a.H + it.g * rep + r) * D + d] =
            __float2bfloat16(num / (den + 1e-30f));
      }
      if (threadIdx.x == 0) a.cnt[it.pair] = 0;
    }
  }
}

// ---- split mma: Sq > 1 or rep > 8 ------------------------------------------

constexpr int MC_CS = 64;        // cache positions per chunk (one n64 product)
constexpr int MC_THREADS = 384;  // two consumer warpgroups, one producer warpgroup
constexpr int MC_SIDE = 2 * MC_CS * 4 + MC_CS;   // a stage's k/v scales, column states
constexpr int MC_RAW = 4;        // int8 chunks in flight, as read

// bf16 tiles come straight from TMA, 6 deep; int8 chunks wait in a 4-deep
// raw ring (one bulk copy each of K and V) before the producer warpgroup
// converts them, so 4 converted tiles suffice.
template <int DP, bool QUANT>
struct MmaPlan {
  static constexpr int STAGES = QUANT ? 4 : 6;
  static constexpr int CHUNKS = DP / 64;
  static constexpr int Q_BYTES = CHUNKS * 64 * 128;
  static constexpr int KV_BYTES = CHUNKS * MC_CS * 128;   // one of K, V
  static constexpr int STAGE_BYTES = 2 * KV_BYTES;
  static constexpr int SIDE_OFF = Q_BYTES + STAGES * STAGE_BYTES;
  static constexpr int FLAG_OFF = SIDE_OFF + STAGES * MC_SIDE;
  static constexpr int RAW_OFF = FLAG_OFF + MAXC * MC_CS;   // int8 chunks as read
  static constexpr int SMEM = RAW_OFF + (QUANT ? MC_RAW * 2 * MC_CS * DP : 0) + 1024;
};

// Byte offset of 8 bf16 columns [8u, 8u + 8) of row r in a [DP/64][rows][64]
// tile in the 128-byte swizzle.
__device__ inline int swz(int rows, int r, int col) {
  return (col / 64) * rows * 128 + r * 128 + ((((col % 64) / 8) ^ (r % 8)) << 4);
}

template <typename T, int DP, bool PAGED>
__global__ void __launch_bounds__(MC_THREADS, 1)
    decode_split_mma_kernel(const __grid_constant__ CUtensorMap kmap,
                            const __grid_constant__ CUtensorMap vmap, const Args a) {
  constexpr bool QUANT = sizeof(T) == 1;
  using Plan = MmaPlan<DP, QUANT>;
  constexpr int STAGES = Plan::STAGES;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~static_cast<uintptr_t>(1023));
  unsigned char* qs = smem;
  unsigned char* vflag = smem + Plan::FLAG_OFF;
  unsigned char* rawbuf = smem + Plan::RAW_OFF;   // int8: [MC_RAW][K, V][MC_CS][DP]
  __shared__ uint64_t full[STAGES], empty[STAGES], rawfull[MC_RAW];
  __shared__ int any_c[MAXC], live[MAXC];
  __shared__ int n_live, last_flag;
  const int rep = a.H / a.Hkv, qn = a.qn, M = rep * qn, D = a.D;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const float sl2 = a.scale * LOG2E;
  if (threadIdx.x == 0) {
    // one arrival a warp: each of the four producer (consumer) warps
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(&full[s], 4);
      mbar_init(&empty[s], 4);
    }
    for (int s = 0; s < MC_RAW; ++s) mbar_init(&rawfull[s], 1);
    mbar_fence_init();
  }
  __syncthreads();

  if (threadIdx.x >= 256) {
    // ---- producer warpgroup: every tile of every item, in order; it hands
    // most of its registers to the consumers ----
    regs_dealloc<56>();
    const int pt = threadIdx.x - 256;
    int used = 0;   // tiles (chunks and extra tiles) through the ring so far
    int rq = 0;     // int8 chunks through the raw ring so far
    for (int item = blockIdx.x; item < a.items; item += gridDim.x) {
      const Item it = item_of(a, item, MC_CS);
      const bool extra = a.kn != nullptr && it.split == a.nsplit - 1;
      __syncthreads();   // the previous item is done
      live_chunks<MC_CS, MC_THREADS>(a, it, vflag, any_c, live, &n_live);
      const int nl = n_live;
      const int tiles = nl + (extra ? 1 : 0);   // the extra columns come last
      // int8: cache chunk i's K and V rows (contiguous in the plane; PAGED:
      // one run a page the chunk touches) by bulk copy into raw slot `slot`
      auto raw_issue = [&](int i, int slot) {
        const int j0 = live[i] * MC_CS, n = min(MC_CS, a.S - j0);
        unsigned char* dst = rawbuf + slot * 2 * MC_CS * DP;
        mbar_arrive_tx(&rawfull[slot], 2 * n * D);
        for (int j = j0; j < j0 + n;) {
          const int len = PAGED ? min(a.page - j % a.page, j0 + n - j) : n;
          const long long off = row_offset<PAGED>(a, it.b, it.g, j);
          bulk_load(dst + (j - j0) * D, static_cast<const int8_t*>(a.k) + off, len * D,
                    &rawfull[slot]);
          bulk_load(dst + MC_CS * DP + (j - j0) * D, static_cast<const int8_t*>(a.v) + off,
                    len * D, &rawfull[slot]);
          j += len;
        }
      };
      float ksn = 0.f, vsn = 0.f;   // the coming chunk's scales
      if (QUANT) {
        if (pt == 0)
          for (int i = 0; i < min(nl, MC_RAW); ++i) raw_issue(i, (rq + i) % MC_RAW);
        if (nl > 0 && pt < MC_CS) {
          const int j = live[0] * MC_CS + pt;
          ksn = j < a.S ? a.ks[it.plane * a.S + j] : 0.f;
          vsn = j < a.S ? a.vs[it.plane * a.S + j] : 0.f;
        }
      }
      for (int i = 0; i < tiles; ++i) {
        const int gi = used + i, s = gi % STAGES;
        const bool ext = i == nl;
        const int j0 = ext ? 0 : live[i] * MC_CS;
        unsigned char* kt = smem + Plan::Q_BYTES + s * Plan::STAGE_BYTES;
        unsigned char* vt = kt + Plan::KV_BYTES;
        float* kss = reinterpret_cast<float*>(smem + Plan::SIDE_OFF + s * MC_SIDE);
        float* vss = kss + MC_CS;
        unsigned char* state = reinterpret_cast<unsigned char*>(vss + MC_CS);
        // int8: this chunk's raw rows have come by bulk copy
        const int rs = rq % MC_RAW;
        if (QUANT && !ext) mbar_wait(&rawfull[rs], (rq / MC_RAW) & 1);
        if (gi >= STAGES) mbar_wait(&empty[s], ((gi / STAGES) + 1) & 1);
        if (!ext && pt < MC_CS) {
          const int j = j0 + pt;
          state[pt] = j < a.S ? (vflag[j - it.j_lo] ? 1 : 0) : 2;
          if (QUANT) {
            kss[pt] = ksn;
            vss[pt] = vsn;
          }
        }
        // the next chunk's scales, ahead of their use
        if (QUANT && i + 1 < nl) {
          const int j = live[i + 1] * MC_CS + pt;
          ksn = pt < MC_CS && j < a.S ? a.ks[it.plane * a.S + j] : 0.f;
          vsn = pt < MC_CS && j < a.S ? a.vs[it.plane * a.S + j] : 0.f;
        }
        if (ext) {
          // k_new / v_new rows [0, qn) (any strides), a plane's units all
          // loaded before any is stored; zeros in K's rows past qn
          constexpr int EXU = MAX_QN * (DP / 8) / 128;   // units a thread
#pragma unroll
          for (int pl = 0; pl < 2; ++pl) {
            const __nv_bfloat16* src = pl ? a.vn + it.b * a.vn_sb + it.g * a.vn_sg
                                          : a.kn + it.b * a.kn_sb + it.g * a.kn_sg;
            const long long sq = pl ? a.vn_sq : a.kn_sq;
            uint4 u[EXU];
#pragma unroll
            for (int k = 0; k < EXU; ++k) {
              const int e = pt + k * 128, r = e / (DP / 8), c = (e % (DP / 8)) * 8;
              u[k] = r < qn ? load8_bf16(src + r * sq, c, D) : make_uint4(0u, 0u, 0u, 0u);
            }
#pragma unroll
            for (int k = 0; k < EXU; ++k) {
              const int e = pt + k * 128, r = e / (DP / 8), c = (e % (DP / 8)) * 8;
              *reinterpret_cast<uint4*>((pl ? vt : kt) + swz(MC_CS, r, c)) = u[k];
            }
          }
          for (int e = pt + MAX_QN * (DP / 8); e < MC_CS * (DP / 8); e += 128) {
            const int r = e / (DP / 8), c = (e % (DP / 8)) * 8;
            *reinterpret_cast<uint4*>(kt + swz(MC_CS, r, c)) = make_uint4(0u, 0u, 0u, 0u);
          }
        } else if (QUANT) {
          // int8 -> bf16 (exact) into the swizzled tiles; rows past S and
          // columns past D are zeros
          const int n = min(MC_CS, a.S - j0);
          const unsigned char* raw = rawbuf + rs * 2 * MC_CS * DP;
          constexpr int UNITS = MC_CS * DP / 16;   // per plane
          for (int e = pt; e < 2 * UNITS; e += 128) {
            const int pl = e / UNITS, r = (e % UNITS) / (DP / 16), c = (e % UNITS) % (DP / 16);
            uint4 u = make_uint4(0u, 0u, 0u, 0u);
            if (r < n && c * 16 < D)
              u = *reinterpret_cast<const uint4*>(raw + pl * MC_CS * DP + r * D + c * 16);
            unsigned char* dst = pl ? vt : kt;
            __nv_bfloat162 h[8];
            stage_unit<int8_t>(u, h);
            uint4 u0, u1;
            memcpy(&u0, h, 16);
            memcpy(&u1, h + 4, 16);
            *reinterpret_cast<uint4*>(dst + swz(MC_CS, r, c * 16)) = u0;
            *reinterpret_cast<uint4*>(dst + swz(MC_CS, r, c * 16 + 8)) = u1;
          }
          named_barrier(3, 128);   // the raw slot is read out
          if (pt == 0 && i + MC_RAW < nl) raw_issue(i + MC_RAW, rs);
          ++rq;
        }
        if (ext || QUANT) fence_async_smem();   // the written tiles are wgmma operands
        __syncwarp();
        if (!ext && !QUANT && pt < 32) {
          // bf16: the chunk by TMA, counted in full on the barrier. PAGED:
          // lane k loads the chunk's box k of a.box rows from its page (a
          // multiple of 8 rows, so each box lands on an 8-row swizzle atom
          // and the tile is laid out as the dense single box lays it);
          // a box past the table's end starts past the map's page rows
          // and fills zeros, as the dense map's rows past S do
          if (lane == 0) mbar_arrive_tx(&full[s], Plan::STAGE_BYTES);
          __syncwarp();
          if (PAGED && lane < MC_CS / a.box) {
            const int j = j0 + lane * a.box;
            int row = a.page, plane = 0;
            if (j < a.S) {
              const int phys = a.table[static_cast<long long>(it.b) * a.P + j / a.page];
              row = j % a.page;
              plane = static_cast<int>((a.layer * a.n_pages + phys) * a.Hkv + it.g);
            }
            const int dst = lane * a.box * 128;
#pragma unroll
            for (int c = 0; c < Plan::CHUNKS; ++c) {
              tma_load_3d(kt + c * MC_CS * 128 + dst, &kmap, &full[s], c * 64, row, plane);
              tma_load_3d(vt + c * MC_CS * 128 + dst, &vmap, &full[s], c * 64, row, plane);
            }
          } else if (!PAGED && lane == 0) {
#pragma unroll
            for (int c = 0; c < Plan::CHUNKS; ++c) {
              tma_load_3d(kt + c * MC_CS * 128, &kmap, &full[s], c * 64, j0,
                          static_cast<int>(it.plane));
              tma_load_3d(vt + c * MC_CS * 128, &vmap, &full[s], c * 64, j0,
                          static_cast<int>(it.plane));
            }
          }
        } else if (lane == 0) {
          mbar_arrive(&full[s]);
        }
      }
      used += tiles;
    }
    return;
  }

  // ---- consumer warpgroups: the 64-row tile of M = rep * qn rows; the
  // two take alternate tiles of an item and merge at its end ----
  regs_alloc<224>();
  const int cw = warp / 4, ct = threadIdx.x % 128;
  const int g = lane / 4, t = lane % 4;
  const int row0 = (warp % 4) * 16 + g;   // and row0 + 8
  float* scratch = reinterpret_cast<float*>(smem + Plan::Q_BYTES);   // over the stages
  int used = 0;
  for (int item = blockIdx.x; item < a.items; item += gridDim.x) {
    const Item it = item_of(a, item, MC_CS);
    const bool extra = a.kn != nullptr && it.split == a.nsplit - 1;
    __syncthreads();
    live_chunks<MC_CS, MC_THREADS>(a, it, vflag, any_c, live, &n_live);
    const int nl = n_live;
    const int tiles = nl + (extra ? 1 : 0);
    {
      constexpr int QU = 64 * (DP / 8) / 256;   // units a thread, loaded first
      uint4 qb[QU];
#pragma unroll
      for (int k = 0; k < QU; ++k) {
        const int e = threadIdx.x + k * 256, i = e / (DP / 8), c = (e % (DP / 8)) * 8;
        qb[k] = i < M ? load8_bf16(a.q + it.b * a.q_sb + (i % qn) * a.q_sq +
                                       (it.g * rep + i / qn) * a.q_sh,
                                   c, D)
                      : make_uint4(0u, 0u, 0u, 0u);
      }
#pragma unroll
      for (int k = 0; k < QU; ++k) {
        const int e = threadIdx.x + k * 256, i = e / (DP / 8), c = (e % (DP / 8)) * 8;
        *reinterpret_cast<uint4*>(qs + swz(64, i, c)) = qb[k];
      }
    }
    fence_async_smem();
    named_barrier(2, 256);

    float o[DP / 2];
#pragma unroll
    for (int i = 0; i < DP / 2; ++i) o[i] = 0.f;
    float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};
    for (int i = cw; i < tiles; i += 2) {
      const int gi = used + i, s = gi % STAGES;
      const bool ext = i == nl;
      unsigned char* kt = smem + Plan::Q_BYTES + s * Plan::STAGE_BYTES;
      unsigned char* vt = kt + Plan::KV_BYTES;
      const float* kss = reinterpret_cast<const float*>(smem + Plan::SIDE_OFF + s * MC_SIDE);
      const float* vss = kss + MC_CS;
      const unsigned char* state = reinterpret_cast<const unsigned char*>(vss + MC_CS);
      mbar_wait(&full[s], (gi / STAGES) & 1);
      float sacc[MC_CS / 2];
      fence_acc(sacc);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < DP / 16; ++kk) {
        const int off = (kk / 4) * 64 * 128 + (kk % 4) * 32;
        const int koff = (kk / 4) * MC_CS * 128 + (kk % 4) * 32;
        qk_wgmma<MC_CS>(sacc, smem_desc(qs + off, 16, 1024), smem_desc(kt + koff, 16, 1024),
                        kk > 0);
      }
      wgmma_commit();
      wgmma_wait<0>();
      fence_acc(sacc);
      float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
      for (int j = 0; j < MC_CS / 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int c = j * 8 + 2 * t + (e & 1);
          float x = sacc[j * 4 + e];
          if (ext) {
            const int qi = (row0 + (e >= 2 ? 8 : 0)) % qn;
            x = c >= qn ? -INFINITY : (c > qi ? NEG : x * sl2);
          } else {
            const int st = state[c];
            if (QUANT) x *= kss[c];
            x = st == 2 ? -INFINITY : (st == 0 ? NEG : x * sl2);
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
#pragma unroll
      for (int j = 0; j < DP / 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) o[j * 4 + e] *= corr[e >> 1];
      // p in place of the scores; l over this thread's columns
#pragma unroll
      for (int j = 0; j < MC_CS / 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          sacc[j * 4 + e] = exp2f(sacc[j * 4 + e] - m[e >> 1]);
          l[e >> 1] += sacc[j * 4 + e];
        }
      if (!ext) {
        uint32_t pa[MC_CS / 16][4];
#pragma unroll
        for (int j = 0; j < MC_CS / 8; ++j) {
          float pj[4];
#pragma unroll
          for (int e = 0; e < 4; ++e)
            pj[e] = QUANT ? sacc[j * 4 + e] * vss[j * 8 + 2 * t + (e & 1)] : sacc[j * 4 + e];
          pa[j / 2][(j % 2) * 2 + 0] = pack_bf16(pj[0], pj[1]);
          pa[j / 2][(j % 2) * 2 + 1] = pack_bf16(pj[2], pj[3]);
        }
        fence_acc(o);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < MC_CS / 16; ++kk)
          pv_wgmma<DP, MC_CS>(o, pa[kk], smem_desc(vt + kk * 16 * 128, MC_CS * 128, 1024));
        wgmma_commit();
        wgmma_wait<0>();
        fence_acc(o);
      } else {
        // the extra columns: fp32 p (no rounding) times fp32 v_new. The
        // warp's p rows go through the tile's K half (free once Q.K^T is
        // done) so every lane reads the whole row.
        float* pbuf = reinterpret_cast<float*>(const_cast<unsigned char*>(kt));
#pragma unroll
        for (int j = 0; j < MAX_QN / 8; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e)
            pbuf[(row0 + (e >= 2 ? 8 : 0)) * MAX_QN + j * 8 + 2 * t + (e & 1)] = sacc[j * 4 + e];
        __syncwarp();
        for (int jn = 0; jn < qn; ++jn) {
          const float p0 = pbuf[row0 * MAX_QN + jn], p1 = pbuf[(row0 + 8) * MAX_QN + jn];
#pragma unroll
          for (int j = 0; j < DP / 8; ++j) {
            const int col = j * 8 + 2 * t;
            const float2 v = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(
                vt + swz(MC_CS, jn, col) + (col % 8) * 2));
            o[j * 4 + 0] = fmaf(p0, v.x, o[j * 4 + 0]);
            o[j * 4 + 1] = fmaf(p0, v.y, o[j * 4 + 1]);
            o[j * 4 + 2] = fmaf(p1, v.x, o[j * 4 + 2]);
            o[j * 4 + 3] = fmaf(p1, v.y, o[j * 4 + 3]);
          }
        }
      }
      __syncwarp();
      if (lane == 0) mbar_arrive(&empty[s]);
    }
    used += tiles;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
      l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
    }
    // the second warpgroup's state joins the first's (the stages are free
    // once both have finished their tiles)
    named_barrier(2, 256);
    if (cw == 1) {
#pragma unroll
      for (int k = 0; k < DP / 2; ++k) scratch[k * 128 + ct] = o[k];
      float* ml = scratch + (DP / 2) * 128 + ct * 4;
      ml[0] = m[0];
      ml[1] = m[1];
      ml[2] = l[0];
      ml[3] = l[1];
      fence_async_smem();   // before the next item's copies overwrite it
    }
    named_barrier(2, 256);
    if (cw == 1) continue;
    {
      const float* ml = scratch + (DP / 2) * 128 + ct * 4;
      float c0[2], c1[2];
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const float m1 = ml[r], mm = fmaxf(m[r], m1);
        c0[r] = m[r] == -INFINITY ? 0.f : exp2f(m[r] - mm);
        c1[r] = m1 == -INFINITY ? 0.f : exp2f(m1 - mm);
        l[r] = l[r] * c0[r] + ml[2 + r] * c1[r];
        m[r] = mm;
      }
#pragma unroll
      for (int k = 0; k < DP / 2; ++k)
        o[k] = o[k] * c0[(k % 4) >> 1] + scratch[k * 128 + ct] * c1[(k % 4) >> 1];
    }
    // rows i = r * qn + qi: query qi of head g * rep + r
    auto out_row = [&](int i) {
      return a.o + ((static_cast<long long>(it.b) * qn + i % qn) * a.H + it.g * rep + i / qn) * D;
    };
    if (a.nsplit == 1) {
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int i = row0 + 8 * r;
        if (i >= M) continue;
        const float den = l[r] + 1e-30f;
        __nv_bfloat16* op = out_row(i);
#pragma unroll
        for (int j = 0; j < DP / 8; ++j) {
          const int col = j * 8 + 2 * t;
          if (col < D)
            *reinterpret_cast<__nv_bfloat162*>(op + col) =
                __floats2bfloat162_rn(o[j * 4 + 2 * r] / den, o[j * 4 + 2 * r + 1] / den);
        }
      }
      continue;
    }
    const long long base = (static_cast<long long>(it.pair) * a.nsplit + it.split) * M;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int i = row0 + 8 * r;
      if (i >= M) continue;
      if (t == 0) {
        a.ws_ml[(base + i) * 2] = m[r];
        a.ws_ml[(base + i) * 2 + 1] = l[r];
      }
#pragma unroll
      for (int j = 0; j < DP / 8; ++j) {
        const int col = j * 8 + 2 * t;
        if (col < D)
          *reinterpret_cast<float2*>(a.ws_o + (base + i) * D + col) =
              make_float2(o[j * 4 + 2 * r], o[j * 4 + 2 * r + 1]);
      }
    }
    if (!last_of_plane(a, it.pair, &last_flag, 1, 128)) continue;
    // each row's split weights once, then every column's pairs
    const long long pbase = static_cast<long long>(it.pair) * a.nsplit * M;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int i = row0 + 8 * r;
      if (i >= M) continue;
      float mx = -INFINITY;
      for (int sp = 0; sp < a.nsplit; ++sp)
        mx = fmaxf(mx, __ldcg(a.ws_ml + (pbase + sp * M + i) * 2));
      float den = 0.f, num[DP / 4];
#pragma unroll
      for (int j = 0; j < DP / 4; ++j) num[j] = 0.f;
      for (int sp = 0; sp < a.nsplit; ++sp) {
        const long long o_ = pbase + sp * M + i;
        const float ms = __ldcg(a.ws_ml + o_ * 2);
        if (ms == -INFINITY) continue;
        const float c = exp2f(ms - mx);
        den += c * __ldcg(a.ws_ml + o_ * 2 + 1);
#pragma unroll
        for (int j = 0; j < DP / 8; ++j) {
          const int col = j * 8 + 2 * t;
          if (col >= D) continue;
          const float2 v = __ldcg(reinterpret_cast<const float2*>(a.ws_o + o_ * D + col));
          num[2 * j] = fmaf(c, v.x, num[2 * j]);
          num[2 * j + 1] = fmaf(c, v.y, num[2 * j + 1]);
        }
      }
      __nv_bfloat16* op = out_row(i);
      const float inv = 1.f / (den + 1e-30f);
#pragma unroll
      for (int j = 0; j < DP / 8; ++j) {
        const int col = j * 8 + 2 * t;
        if (col < D)
          *reinterpret_cast<__nv_bfloat162*>(op + col) =
              __floats2bfloat162_rn(num[2 * j] * inv, num[2 * j + 1] * inv);
      }
    }
    if (threadIdx.x == 0) a.cnt[it.pair] = 0;
  }
}

// A 3-D map over bf16 planes of `rows` rows of D (the dense cache's [L * B
// * Hkv, S, D], or the pool's [L * n_pages * Hkv, page, D]): boxes of 64
// columns x `box` rows of one plane, 128-byte swizzle; rows past `rows`
// and columns past D fill zeros.
inline bool plane_map(CUtensorMap* map, const void* base, long long planes, int rows, int D,
                      int box) {
  const uint64_t dims[3] = {static_cast<uint64_t>(D), static_cast<uint64_t>(rows),
                            static_cast<uint64_t>(planes)};
  const uint64_t strides[2] = {2ULL * D, 2ULL * D * rows};
  const uint32_t boxes[3] = {64, static_cast<uint32_t>(box), 1};
  return make_map(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, base, dims, strides, boxes);
}

template <typename T, int DP, bool PAGED>
cudaError_t launch_split_mma(const Args& a, int grid, cudaStream_t stream) {
  CUtensorMap kmap, vmap;
  memset(&kmap, 0, sizeof(kmap));
  memset(&vmap, 0, sizeof(vmap));
  const long long planes = (a.layer + 1) * (PAGED ? a.n_pages : a.B) * a.Hkv;
  const int rows = PAGED ? a.page : a.S, box = PAGED ? a.box : MC_CS;
  if (sizeof(T) == 2 && (box % 8 != 0 || !plane_map(&kmap, a.k, planes, rows, a.D, box) ||
                         !plane_map(&vmap, a.v, planes, rows, a.D, box)))
    return cudaErrorInvalidValue;
  auto kern = decode_split_mma_kernel<T, DP, PAGED>;
  cudaError_t err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         MmaPlan<DP, sizeof(T) == 1>::SMEM);
  if (err != cudaSuccess) return err;
  kern<<<grid, MC_THREADS, MmaPlan<DP, sizeof(T) == 1>::SMEM, stream>>>(kmap, vmap, a);
  return cudaGetLastError();
}

template <typename T, int REPT, bool PAGED>
cudaError_t launch_split_rows(const Args& a, int grid, cudaStream_t stream) {
  auto kern = decode_split_rows_kernel<T, REPT, PAGED>;
  const int bytes = rows_smem(a.D, sizeof(T));
  cudaError_t err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return err;
  kern<<<grid, THREADS, bytes, stream>>>(a);
  return cudaGetLastError();
}

template <typename T, bool PAGED>
cudaError_t launch_split_rows_rep(const Args& a, int grid, cudaStream_t stream) {
  const int rep = a.H / a.Hkv;
  if (rep == 1) return launch_split_rows<T, 1, PAGED>(a, grid, stream);
  if (rep == 2) return launch_split_rows<T, 2, PAGED>(a, grid, stream);
  if (rep <= 4) return launch_split_rows<T, 4, PAGED>(a, grid, stream);
  return launch_split_rows<T, 8, PAGED>(a, grid, stream);
}

// The split designs, dense or paged: the row kernel (Sq = 1, rep <= 8) or
// the mma kernel.
template <typename T>
cudaError_t launch_split(const Args& a, int grid, cudaStream_t stream) {
  const int rep = a.H / a.Hkv;
  const bool paged = a.table != nullptr;
  if (a.qn == 1 && rep <= MAXREP)
    return paged ? launch_split_rows_rep<T, true>(a, grid, stream)
                 : launch_split_rows_rep<T, false>(a, grid, stream);
  if (a.D <= 64)
    return paged ? launch_split_mma<T, 64, true>(a, grid, stream)
                 : launch_split_mma<T, 64, false>(a, grid, stream);
  return paged ? launch_split_mma<T, 128, true>(a, grid, stream)
               : launch_split_mma<T, 128, false>(a, grid, stream);
}

template <typename T, bool PAGED>
cudaError_t launch_first(const Args& a, cudaStream_t stream) {
  const dim3 grid(a.Hkv, a.B);
  const int rep = a.H / a.Hkv;
  if (a.qn == 1 && rep <= MAXREP) {
    decode_row_kernel<T, PAGED><<<grid, THREADS, 0, stream>>>(a);
    return cudaGetLastError();
  }
  const size_t bytes = chunk_smem_bytes((rep * a.qn + 15) / 16 * 16, a.D);
  static size_t configured = 0;   // per instantiation
  if (bytes > configured) {
    const cudaError_t err = cudaFuncSetAttribute(
        decode_chunk_kernel<T, PAGED>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(bytes));
    if (err != cudaSuccess) return err;
    configured = bytes;
  }
  decode_chunk_kernel<T, PAGED><<<grid, CT, bytes, stream>>>(a);
  return cudaGetLastError();
}

}  // namespace

// quant: 0 bf16 values, 1 int8 values with fp32 scales. table == NULL: the
// dense stacked cache [L, B, Hkv, S, D]; else the pool [L, n_pages, Hkv,
// page, D] read through table [B, P] (S = P * page). nsplit > 0: the split
// designs (decode_plan: nsplit splits of cps chunks, `grid` blocks, fp32
// workspaces ws_o / ws_ml, zeroed tickets cnt [B * Hkv]; a bf16 pool's chunk
// forms need page % 8 == 0); nsplit == 0: the first designs (rows that are
// not whole 16-byte units, a bf16 pool's pages that break the box rule).
// Checks of shapes, types and limits (qn <= 32, rep *
// qn <= 64, D in {16, 32, 64, 128} for the chunk forms, D <= 128) are the
// wrapper's.
extern "C" int emu_decode_attention_fwd(
    const void* q, long long q_sb, long long q_sq, long long q_sh,
    const void* k_cache, const void* v_cache, const void* k_scale,
    const void* v_scale, const void* kv_valid, const void* k_new,
    long long kn_sb, long long kn_sg, long long kn_sq, const void* v_new,
    long long vn_sb, long long vn_sg, long long vn_sq, const void* table,
    int P, int n_pages, int page, void* out, int B, int H, int Hkv, int qn,
    int S, int D, long long layer, float scale, int quant, int nsplit, int cps,
    int grid, void* ws_o, void* ws_ml, void* cnt, void* stream) {
  Args a;
  memset(&a, 0, sizeof(a));
  a.q = static_cast<const __nv_bfloat16*>(q);
  a.q_sb = q_sb;
  a.q_sq = q_sq;
  a.q_sh = q_sh;
  a.k = k_cache;
  a.v = v_cache;
  a.ks = static_cast<const float*>(k_scale);
  a.vs = static_cast<const float*>(v_scale);
  a.valid = static_cast<const unsigned char*>(kv_valid);
  a.kn = static_cast<const __nv_bfloat16*>(k_new);
  a.kn_sb = kn_sb;
  a.kn_sg = kn_sg;
  a.kn_sq = kn_sq;
  a.vn = static_cast<const __nv_bfloat16*>(v_new);
  a.vn_sb = vn_sb;
  a.vn_sg = vn_sg;
  a.vn_sq = vn_sq;
  a.table = static_cast<const int*>(table);
  a.P = P;
  a.n_pages = n_pages;
  a.page = page;
  a.box = 64;
  while (page > 0 && a.box > 1 && page % a.box) a.box /= 2;   // gcd(page, 64)
  a.o = static_cast<__nv_bfloat16*>(out);
  a.B = B;
  a.H = H;
  a.Hkv = Hkv;
  a.qn = qn;
  a.S = S;
  a.D = D;
  a.layer = layer;
  a.scale = scale;
  a.nsplit = nsplit;
  a.cps = cps;
  a.items = B * Hkv * nsplit;
  a.ws_o = static_cast<float*>(ws_o);
  a.ws_ml = static_cast<float*>(ws_ml);
  a.cnt = static_cast<int*>(cnt);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (nsplit > 0) {
    if (cps > MAXC || qn > MAX_QN || grid <= 0 ||
        (nsplit > 1 && (ws_o == nullptr || ws_ml == nullptr || cnt == nullptr)))
      return static_cast<int>(cudaErrorInvalidValue);
    err = quant ? launch_split<int8_t>(a, grid, st) : launch_split<__nv_bfloat16>(a, grid, st);
  } else if (table == nullptr) {
    err = quant ? launch_first<int8_t, false>(a, st) : launch_first<__nv_bfloat16, false>(a, st);
  } else {
    err = quant ? launch_first<int8_t, true>(a, st) : launch_first<__nv_bfloat16, true>(a, st);
  }
  return static_cast<int>(err);
}

// Dynamic shared memory of the split designs at head width d and item size:
// the row kernel, or (rows == 0) the mma kernel (chip_smoke prints it).
extern "C" int emu_decode_split_smem(int rows, int d, int itemsize) {
  if (rows) return rows_smem(d, itemsize);
  if (itemsize == 1) return d <= 64 ? MmaPlan<64, true>::SMEM : MmaPlan<128, true>::SMEM;
  return d <= 64 ? MmaPlan<64, false>::SMEM : MmaPlan<128, false>::SMEM;
}
