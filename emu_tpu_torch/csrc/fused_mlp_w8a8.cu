// Kernel E: the W8A8 GELU MLP branch
//   [LN ->] quant -> fc1 (s8) -> GELU -> requant per hidden block -> fc2 (s8)
//   [-> LN] [+ x]
// bf16 in and out, int8 weights with fp32 per-output-channel scales.
//
// Replaces the TPU kernel emu_tpu/ops/fused_mlp.py:fused_mlp_w8a8, which the
// JAX package runs for the W8A8 EVA-4B MLP at >= 2048 rows (two or more
// 448-px images). Its numerics are kept: the (LayerNorm'd, fp32) input is
// quantized per row over all of K; fc1's exact integer sums are rescaled
// (row scale, then column scale) plus b1 in fp32, then GELU with the A&S
// erf the TPU kernel uses; the hidden activation is re-quantized per row
// WITHIN each block of bf hidden columns (the block is a parameter: 768 at
// EVA-4B widths), and fc2's integer sums of each block enter the fp32 sum
// with that block's scale; then the column scale, b2, LayerNorm, residual.
//
// What bounds it on an H100: 2 * M * K * F * 2 int8 operations (0.45 T at
// M = 4100, 0.23 ms at the int8 peak). The TPU kernel keeps a [512, N] fp32
// accumulator in VMEM while it walks the hidden blocks of a row block in
// sequence; a Hopper block cannot hold that, so the hidden activation
// crosses device memory once, as what fc2 reads: int8 hq [M, F] and its
// fp32 scales (M * F bytes, a quarter of the fp32 activation the first
// version wrote and read back between its fc1 and a requantization pass).
// Both products run on w8a8_gemm.cuh's wgmma GEMM, whose transform
// warpgroup turns the N-major int8 weights K-major in shared memory (the
// first version gathered them byte by byte into mma.sync tiles):
//   1. quant_rows_kernel: xq [M, K] int8 and sx [M] (with the pre form's
//      LayerNorm);
//   2. fc1 (w8a8_gemm_kernel<true>): GELU and the requantization in its
//      epilogue, the blocks of each hidden block a cluster that shares its
//      row maxima through distributed shared memory, one wave of clusters
//      walking the (row tile, hidden block) units;
//   3. fc2 (w8a8_gemm_kernel<false>): the per-block fold, * s2 + b2 and the
//      residual; the post form writes fp32 [M, N] and rows_epilogue_kernel
//      normalises each row and adds the residual.
// No step sums across blocks with atomics: two runs give the same bits.

#include "w8a8_gemm.cuh"

// Dynamic shared memory of a block of the W8A8 GEMM (chip_smoke prints it).
extern "C" int emu_w8a8_smem() { return W8Plan::SMEM; }

// The clusters of `cluster` fc1 blocks the card holds at once: fc1's
// persistent wave (chip_smoke prints it).
extern "C" int emu_w8a8_fc1_clusters(int cluster) { return w8a8_fc1_clusters(cluster); }

// ln_mode: 0 none, 1 pre (LayerNorm of x before quantization), 2 post
// (LayerNorm of the MLP output). cluster: fc1's cluster size, which
// w8a8_cluster(bf) gives (the caller's plan passes it down and it is
// checked here). Scratch the caller allocates: xq [M, K] int8, sx [M]
// fp32, hq [M, F] int8, hs [M, ceil(F / bf)] fp32, ws [M, N] fp32 (post).
// K, F and N multiples of 16, bf of 128, N <= 2048.
extern "C" int emu_fused_mlp_w8a8_fwd(const void* x, const void* w1, const void* s1,
                                      const void* b1, const void* w2, const void* s2,
                                      const void* b2, const void* ln_s, const void* ln_b,
                                      int ln_mode, int residual, float eps, void* xq, void* sx,
                                      void* hq, void* hs, void* ws, void* out, int M, int K,
                                      int F, int N, int bf, int cluster, void* stream) {
  if (M <= 0 || K % 16 || F % 16 || bf % W8_BN || N % 16
      || N > ROWS_MAX_PER_THREAD * 256 || cluster != w8a8_cluster(bf)
      || (ln_mode == 2 && ws == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const __nv_bfloat16* xb = static_cast<const __nv_bfloat16*>(x);
  const __nv_bfloat16* lns = static_cast<const __nv_bfloat16*>(ln_s);
  const __nv_bfloat16* lnb = static_cast<const __nv_bfloat16*>(ln_b);
  quant_rows_kernel<<<M, 256, 0, s>>>(xb, K, ln_mode == 1 ? ROW_LAYERNORM : ROW_PLAIN, lns,
                                      lnb, eps, static_cast<int8_t*>(xq),
                                      static_cast<float*>(sx));
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);

  W8Args a = {};  // fc1: hq, hs = requant(gelu((int * sx) * s1 + b1))
  a.w_scale = static_cast<const float*>(s1);
  a.bias = static_cast<const __nv_bfloat16*>(b1);
  a.M = M;
  a.N = F;
  a.K = K;
  a.row_scale = static_cast<const float*>(sx);
  a.hq = static_cast<int8_t*>(hq);
  a.hs = static_cast<float*>(hs);
  a.bf = bf;
  a.cluster = cluster;
  err = launch_w8a8<true>(static_cast<const int8_t*>(xq), static_cast<const int8_t*>(w1), a, s);
  if (err != cudaSuccess) return static_cast<int>(err);

  W8Args b = {};  // fc2: (sum over blocks of int * hs) * s2 + b2 [+ x]
  b.w_scale = static_cast<const float*>(s2);
  b.bias = static_cast<const __nv_bfloat16*>(b2);
  b.M = M;
  b.N = N;
  b.K = F;
  b.bf = bf;
  b.blk_scale = static_cast<const float*>(hs);
  b.residual = residual && ln_mode != 2 ? xb : nullptr;
  b.ws = ln_mode == 2 ? static_cast<float*>(ws) : nullptr;
  b.out = static_cast<__nv_bfloat16*>(out);
  err = launch_w8a8<false>(static_cast<const int8_t*>(hq), static_cast<const int8_t*>(w2), b, s);
  if (err != cudaSuccess || ln_mode != 2) return static_cast<int>(err);

  rows_epilogue_kernel<<<M, 256, 0, s>>>(static_cast<const float*>(ws), 1, M, N, nullptr, lns,
                                         lnb, eps, residual ? xb : nullptr,
                                         static_cast<__nv_bfloat16*>(out));
  return static_cast<int>(cudaGetLastError());
}
