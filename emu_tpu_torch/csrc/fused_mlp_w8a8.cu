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
// Layout on Hopper: four launches instead of one. The TPU kernel keeps a
// [512, N] fp32 accumulator in VMEM while it walks the hidden blocks of a
// row block in sequence; a Hopper block cannot hold that (the int32 and
// fp32 sums of a 64 x 1792 tile alone need more registers than an SM
// has), so here fc1 + GELU writes the fp32 hidden activation, one block
// per (row, hidden block) re-quantizes it (each owns a whole bf-wide
// block, so it takes the row max itself), fc2 runs as a tiled int8 GEMM
// over all of F, and a row epilogue applies b2, the post-LN and the
// residual. No step sums across blocks, so two runs give the same bits.
//
// What bounds it on an H100: 2 * M * K * F * 2 int8 operations (about
// 0.45 T at M = 4100, 0.2 ms at the int8 peak) and, in this first version,
// the byte-wise weight gathers of int8_gemm_kernel plus the fp32 hidden
// activation's trip through device memory (M * F * 4 bytes written and
// read). Keeping the hidden block on chip is the next step.

#include "int8_mma.cuh"

// ln_mode: 0 none, 1 pre (LayerNorm of x before quantization), 2 post
// (LayerNorm of the MLP output). Scratch the caller allocates: xq [M, K]
// int8, sx [M] fp32, h [M, F] fp32, hq [M, F] int8, hs [M, F / bf] fp32,
// ws [M, N] fp32.
extern "C" int emu_fused_mlp_w8a8_fwd(const void* x, const void* w1, const void* s1,
                                      const void* b1, const void* w2, const void* s2,
                                      const void* b2, const void* ln_s, const void* ln_b,
                                      int ln_mode, int residual, float eps, void* xq, void* sx,
                                      void* h, void* hq, void* hs, void* ws, void* out, int M,
                                      int K, int F, int N, int bf, void* stream) {
  if (K % KT || F % KT || bf % KT || F % bf || N > ROWS_MAX_PER_THREAD * 256)
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

  GemmArgs a = gemm_args();  // fc1: gelu((int * sx) * s1 + b1) -> fp32 [M, F]
  a.a = static_cast<const int8_t*>(xq);
  a.w = static_cast<const int8_t*>(w1);
  a.w_scale = static_cast<const float*>(s1);
  a.blk_scale = static_cast<const float*>(sx);
  a.blk = K;
  a.nblk = 1;
  a.bias = static_cast<const __nv_bfloat16*>(b1);
  a.gelu = 1;
  a.out_f32 = static_cast<float*>(h);
  a.M = M;
  a.N = F;
  a.K = K;
  err = launch_w8a8_gemm(a, s);
  if (err != cudaSuccess) return static_cast<int>(err);

  block_requant_kernel<<<dim3(M, F / bf), 256, 0, s>>>(
      static_cast<const float*>(h), F, F, bf, 0, static_cast<int8_t*>(hq),
      static_cast<float*>(hs));
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);

  GemmArgs b = gemm_args();  // fc2: (sum over blocks of int * hs) * s2 -> fp32 [M, N]
  b.a = static_cast<const int8_t*>(hq);
  b.w = static_cast<const int8_t*>(w2);
  b.w_scale = static_cast<const float*>(s2);
  b.blk_scale = static_cast<const float*>(hs);
  b.blk = bf;
  b.nblk = F / bf;
  b.out_f32 = static_cast<float*>(ws);
  b.M = M;
  b.N = N;
  b.K = F;
  err = launch_w8a8_gemm(b, s);
  if (err != cudaSuccess) return static_cast<int>(err);

  rows_epilogue_kernel<<<M, 256, 0, s>>>(
      static_cast<const float*>(ws), 1, M, N, static_cast<const __nv_bfloat16*>(b2),
      ln_mode == 2 ? lns : nullptr, lnb, eps, residual ? xb : nullptr,
      static_cast<__nv_bfloat16*>(out));
  return static_cast<int>(cudaGetLastError());
}
