// Kernels F and G: W4A8 products over fold-packed int4 weights.
//
// F replaces emu_tpu/ops/q4_matmul.py:matmul_q4: y = x @ dequant(W) (+ b)
// reading only the packed bytes. Activations are quantized to int8 per row
// over all of K (quant_rows_kernel); each 128-row tile of each nibble
// plane contributes an exact s8 x s4 integer dot on the tensor cores
// (w4a8_gemm_kernel, w4a8_gemm.cuh: wgmma s8, fed by a TMA + cp.async
// ring and a transform warpgroup that unpacks the nibbles K-major), scaled
// by its per-(group, column) scale into an fp32 sum; the per-row
// activation scale and the bias apply last. Packed row i holds input row i
// in the low nibble (value + 8) and input row i + K/2 in the high nibble
// (two's complement); the nibbles become signed bytes in shared memory, so
// the integer sums are the TPU kernel's (whose low-plane -8 folds in as
// 8 * rowsum).
//
// G replaces emu_tpu/ops/q4_matmul.py:fused_swiglu_q4, the decode MLP
// x + down(silu(gate(rms(x))) * up(rms(x))) with the fused gate|up layout:
// RMSNorm (HF rounding) + per-row quantization, the gate|up W4A8 product
// into fp32, silu(g) * u re-quantized per row WITHIN each hidden block of
// bf columns (hidden units j and j + F/2 sit in the two nibble planes of
// one packed down row), and the down W4A8 product with those per-(row,
// block) scales plus the residual. The TPU kernel walks the hidden blocks
// in sequence on one core; on Hopper one block per hidden block would use
// 35 of 132 SMs, so the four steps are four launches that each spread
// over the whole card, and the [rows, 2F] fp32 gate|up activations (a few
// hundred KB at decode) pass through device memory.
//
// What bounds them on an H100: at decode (1-32 rows) the weight bytes
// (int4: half a byte per weight; 16.5 GB for LLaMA-33B) against 3.35 TB/s;
// the ring keeps 64 KB of weights in flight per SM and K is split until
// about two waves of blocks stream them. At prefill (a few hundred rows)
// the int8 tensor-core rate (1979 TOP/s): 128 x 128 tiles, two consumer
// warpgroups issuing wgmma m64n128k32 while the transform warpgroup
// unpacks the next tile.

#include "w4a8_gemm.cuh"

// K splits of a W4A8 product at M rows: the caller's workspace for F (and
// each of G's two products) is an fp32 [splits, M, N] buffer when > 1.
extern "C" int emu_w4a8_splits(int M, int N, int K, int gs) {
  return w4a8_split_count(M, N, K, gs);
}

// Dynamic shared memory of a block of the W4A8 GEMM with cw consumer
// warpgroups (chip_smoke prints it).
extern "C" int emu_w4a8_smem(int cw) {
  return cw == 1 ? W4Plan<1>::SMEM : W4Plan<2>::SMEM;
}

extern "C" int emu_matmul_q4_fwd(const void* x, const void* packed, const void* scale4,
                                 const void* bias, void* xq, void* sx, void* ws, void* out,
                                 int M, int N, int K, int gs, void* stream) {
  if (K % (2 * KT) || gs % KT || (K / 2) % gs) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  quant_rows_kernel<<<M, 256, 0, s>>>(static_cast<const __nv_bfloat16*>(x), K, ROW_PLAIN,
                                      nullptr, nullptr, 0.f, static_cast<int8_t*>(xq),
                                      static_cast<float*>(sx));
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  GemmArgs a = gemm_args();
  a.a = static_cast<const int8_t*>(xq);
  a.w = static_cast<const int8_t*>(packed);
  a.w_scale = static_cast<const float*>(scale4);
  a.row_scale = static_cast<const float*>(sx);
  a.bias = static_cast<const __nv_bfloat16*>(bias);
  a.out_bf16 = static_cast<__nv_bfloat16*>(out);
  a.ws = static_cast<float*>(ws);
  a.M = M;
  a.N = N;
  a.K = K;
  a.gs = gs;
  return static_cast<int>(launch_w4a8(a, s));
}

// Scratch the caller allocates: xq [M, D] int8, sx [M] fp32, gu [M, 2F]
// fp32, hq [M, F] int8, hs [M, F / bf] fp32, and ws, fp32, as large as
// the larger split workspace of the two products (emu_w4a8_splits).
extern "C" int emu_fused_swiglu_q4_fwd(const void* x, const void* rms, const void* gu_packed,
                                       const void* gu_scale, const void* dn_packed,
                                       const void* dn_scale, void* xq, void* sx, void* gu,
                                       void* hq, void* hs, void* ws, void* out, int M, int D,
                                       int F, int gs_d, int gs_f, int bf, float eps,
                                       int residual, void* stream) {
  if (D % (2 * KT) || F % (2 * KT) || gs_d % KT || gs_f % KT || (D / 2) % gs_d ||
      bf % gs_f || (F / 2) % bf)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const __nv_bfloat16* xb = static_cast<const __nv_bfloat16*>(x);
  quant_rows_kernel<<<M, 256, 0, s>>>(xb, D, ROW_RMSNORM,
                                      static_cast<const __nv_bfloat16*>(rms), nullptr, eps,
                                      static_cast<int8_t*>(xq), static_cast<float*>(sx));
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);

  GemmArgs a = gemm_args();  // gate|up: [M, D] x [D/2, 2F] -> fp32 [M, 2F]
  a.a = static_cast<const int8_t*>(xq);
  a.w = static_cast<const int8_t*>(gu_packed);
  a.w_scale = static_cast<const float*>(gu_scale);
  a.row_scale = static_cast<const float*>(sx);
  a.out_f32 = static_cast<float*>(gu);
  a.ws = static_cast<float*>(ws);
  a.M = M;
  a.N = 2 * F;
  a.K = D;
  a.gs = gs_d;
  err = launch_w4a8(a, s);
  if (err != cudaSuccess) return static_cast<int>(err);

  block_requant_kernel<<<dim3(M, F / bf), 256, 0, s>>>(
      static_cast<const float*>(gu), 2LL * F, F, bf, 1, static_cast<int8_t*>(hq),
      static_cast<float*>(hs));
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);

  GemmArgs b = gemm_args();  // down: [M, F] x [F/2, D] -> bf16 [M, D] (+ x)
  b.a = static_cast<const int8_t*>(hq);
  b.w = static_cast<const int8_t*>(dn_packed);
  b.w_scale = static_cast<const float*>(dn_scale);
  b.blk_scale = static_cast<const float*>(hs);
  b.blk = bf;
  b.nblk = F / 2 / bf;
  b.residual = residual ? xb : nullptr;
  b.out_bf16 = static_cast<__nv_bfloat16*>(out);
  b.ws = static_cast<float*>(ws);
  b.M = M;
  b.N = D;
  b.K = F;
  b.gs = gs_f;
  return static_cast<int>(launch_w4a8(b, s));
}
