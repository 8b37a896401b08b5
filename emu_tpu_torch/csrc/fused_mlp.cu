// Kernel B: the ViT MLP residual branch,
//   out = x + fc2(gelu(fc1(LN(x))))        (pre-LN optional, residual optional)
//   out = x + LN(fc2(gelu(fc1(x))))        (post-LN)
//   out = x + w3(silu(w1 LN(x) + b1) * (w2 LN(x) + b2)) + b3   (SwiGLU)
// bf16 in and out, fp32 LayerNorm, fp32 accumulation, exact erf GELU.
//
// Replaces the TPU kernel emu_tpu/ops/fused_mlp.py:fused_mlp: pre-LN +
// residual (every Emu1 ViT-g block), post-LN + residual (every bf16 Emu2
// EVA-4B block) and the SwiGLU form of the EVA rope variants. The TPU
// kernel keeps a [512, N] fp32 accumulator in VMEM while it walks the
// hidden dim, so the [M, F] hidden activation never leaves the core; it
// rounds that activation to bf16 (`h.astype(x.dtype)`) before the second
// product.
//
// What bounds it on an H100: the two products, 2 * M * K * F * 2 operations
// (71 GFLOP at ViT-g's 2056 x 1408 -> 6144, 0.072 ms at the bf16 peak),
// far above the bytes. The hidden activation cannot stay on chip at these
// widths: wgmma tiles are at least 64 rows, and a 64-row block that owned
// whole output rows would need 64 x N fp32 accumulators (360 KB at N =
// 1408) against a 256 KB register file; splitting N across blocks makes
// each recompute fc1, splitting F writes fp32 partial sums. The first
// version (16-row tiles on WMMA, the [16, N] accumulator in registers, F
// split over blocks into fp32 [splits, M, N]) re-read both weight
// matrices from L2 for every 16 rows (4.5 GB at ViT-g batch 8) and ran
// at 4-7x the time of the same chain of PyTorch calls.
//
// This design lets the hidden activation cross device memory ONCE, in
// bf16 (the value the TPU kernel rounds it to, so the numerics do not
// change; 25 MB at ViT-g batch 8, inside the 50 MB L2), and runs both
// products on dense_tma.cuh's TMA + wgmma GEMM (kernel H's plan: 128 x 128
// tiles, two consumer warpgroups, a producer warp, a 3-stage ring):
//   1. pre-LN: ln_rows_kernel writes xn = bf16(LN(x)), the TPU kernel's
//      `xn` scratch (an in-GEMM LN redid it for every column block and
//      measured slower than a row pass + the GEMM);
//   2. fc1 with the activation in its epilogue (EPI_GELU: + b1, erf GELU;
//      EPI_SWIGLU: gate and up columns of the same hidden units in one W
//      tile, silu(g + b1) * (u + b2)), in fp32, one rounding to h [M, F];
//   3. fc2 with H's epilogue: + b3/b2 and the residual in fp32, one
//      rounding; the post form writes y = h @ W + b in fp32 and the row
//      pass applies LN over N and adds the residual (H's post form).
// No step sums across blocks and nothing uses atomics: two runs give the
// same bits.

#include "dense_tma.cuh"

// GELU (w3 == NULL): w1 [K, F], b1 [F], w2 [Fw, N], b2 [N].
// SwiGLU (w3 != NULL): w1 (gate) and w2 (up) [K, F] with b1, b2 [F], w3
// [Fw, N] with b3 [N]. Biases may be NULL; every vector is bf16.
// F: the hidden width of w1 (and w2), a multiple of 8; the rows of the
// output weights Fw <= F (hidden columns past Fw are zero).
// ln_mode: 0 none, 1 pre (ln_s, ln_b [K]), 2 post ([N]). Scratch the
// caller allocates: xn [M, K] bf16 (pre), h [M, F] bf16, ws [M, N] fp32
// (post). residual needs N == K.
extern "C" int emu_fused_mlp_fwd(const void* x, const void* ln_s, const void* ln_b,
                                 const void* w1, const void* b1, const void* w2,
                                 const void* b2, const void* w3, const void* b3, void* xn,
                                 void* h, void* ws, void* out, int M, int K, int F, int Fw,
                                 int N, float eps, int residual, int ln_mode, void* stream) {
  if (M <= 0 || K % 8 || N % 8 || F % 8 || Fw > F || ln_mode < PLAIN || ln_mode > POST
      || (ln_mode != PLAIN && (ln_s == nullptr || ln_b == nullptr))
      || (ln_mode == PRE && xn == nullptr) || (ln_mode == POST && ws == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  const bool swiglu = w3 != nullptr;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  typedef const bf16* cb;
  cudaError_t err;
  if (ln_mode == PRE) {
    ln_rows_kernel<bf16><<<M, 256, 0, s>>>(static_cast<cb>(x), ln_s, ln_b, true, nullptr,
                                           static_cast<bf16*>(xn), K, eps);
    err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  DenseArgs a1 = {};   // h = act(LN(x) @ w1 + b1), [M, F]
  a1.x = static_cast<cb>(ln_mode == PRE ? xn : x);
  a1.w = static_cast<cb>(w1);
  a1.bias = b1;
  a1.bias_up = swiglu ? b2 : nullptr;
  a1.vec_bf16 = true;
  a1.out = static_cast<bf16*>(h);
  a1.M = M; a1.K = K; a1.Kw = K; a1.N = F; a1.mode = PLAIN;
  err = swiglu ? launch_tma<EPI_SWIGLU>(a1, static_cast<cb>(w2), s)
               : launch_tma<EPI_GELU>(a1, nullptr, s);
  if (err != cudaSuccess) return static_cast<int>(err);

  DenseArgs a2 = {};   // out = h @ wd + bd [+ x], or its fp32 ws (post)
  a2.x = static_cast<cb>(h);
  a2.w = static_cast<cb>(swiglu ? w3 : w2);
  a2.bias = swiglu ? b3 : b2;
  a2.vec_bf16 = true;
  a2.res = residual && ln_mode != POST ? static_cast<cb>(x) : nullptr;
  a2.ws = static_cast<float*>(ws);
  a2.out = static_cast<bf16*>(out);
  a2.M = M; a2.K = F; a2.Kw = Fw; a2.N = N; a2.mode = ln_mode == POST ? POST : PLAIN;
  err = launch_tma<EPI_DENSE>(a2, nullptr, s);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (ln_mode == POST) {
    ln_rows_kernel<float><<<M, 256, 0, s>>>(a2.ws, ln_s, ln_b, true,
                                            residual ? static_cast<cb>(x) : nullptr,
                                            static_cast<bf16*>(out), N, eps);
    return static_cast<int>(cudaGetLastError());
  }
  return static_cast<int>(cudaSuccess);
}
