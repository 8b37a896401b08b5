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
// RMSNorm (HF rounding) + per-row quantization (rms_quant_kernel), then
// its own decode plan (w4a8_decode.cuh): the gate|up product with silu(g) *
// u re-quantized per row WITHIN each hidden block of bf columns (hidden
// units j and j + F/2 sit in the two nibble planes of one packed down row)
// in its epilogue, and the down product with those per-(row, block) scales
// plus the residual. The TPU kernel walks the hidden blocks in sequence on
// one core; here a thread-block cluster owns each hidden block (and each
// 256 columns of the down product), its blocks splitting K.
//
// What bounds them on an H100: at decode (1-32 rows) the weight bytes
// (int4: half a byte per weight; 16.5 GB for LLaMA-33B) against 3.35 TB/s;
// F's ring keeps 64 KB of weights in flight per SM and K is split until
// about two waves of blocks stream them; G's plan is w4a8_decode.cuh's. At prefill (a few hundred rows)
// the int8 tensor-core rate (1979 TOP/s): 128 x 128 tiles, two consumer
// warpgroups issuing wgmma m64n128k32 while the transform warpgroup
// unpacks the next tile.

#include "w4a8_decode.cuh"
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

// Scratch the caller allocates: xq [M, D] int8, sx [M] fp32, hq [M, F]
// int8, hs [M, F / bf] fp32. The plan (decode_plan in ops/q4_matmul.py):
// the gate|up product's K splits ks_gu (the cluster size, 1, 2, 4 or 8) and
// the packed rows of its longest split kmax_gu; the same for down.
extern "C" int emu_fused_swiglu_q4_fwd(const void* x, const void* rms, const void* gu_packed,
                                       const void* gu_scale, const void* dn_packed,
                                       const void* dn_scale, void* xq, void* sx, void* hq,
                                       void* hs, void* out, int M, int D, int F, int gs_d,
                                       int gs_f, int bf, float eps, int residual, int ks_gu,
                                       int kmax_gu, int ks_dn, int kmax_dn, void* stream) {
  if (M < 1 || M > 32 || D % 256 || D > 8 * RQ_VEC * RQ_THREADS || F % 256 ||
      gs_d % WD_FOLD || gs_f % WD_FOLD ||
      (D / 2) % gs_d || bf % gs_f || (F / 2) % bf || bf > 1024 || ks_gu < 1 || ks_gu > 8 ||
      ks_dn < 1 || ks_dn > 8)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const __nv_bfloat16* xb = static_cast<const __nv_bfloat16*>(x);
  rms_quant_kernel<<<M, RQ_THREADS, 0, s>>>(xb, static_cast<const __nv_bfloat16*>(rms), D, eps,
                                            static_cast<int8_t*>(xq), static_cast<float*>(sx));
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);

  DecodeArgs a = {};  // gate|up: [M, D] x [D/2, 2F] -> silu(g) * u as int8 blocks
  a.a = static_cast<const int8_t*>(xq);
  a.w = static_cast<const int8_t*>(gu_packed);
  a.w_scale = static_cast<const float*>(gu_scale);
  a.row_scale = static_cast<const float*>(sx);
  a.hq = static_cast<int8_t*>(hq);
  a.hs = static_cast<float*>(hs);
  a.M = M;
  a.N = 2 * F;
  a.K = D;
  a.gs = gs_d;
  a.F = F;
  a.bf = bf;
  a.ks = ks_gu;
  a.kmax = kmax_gu;
  err = launch_wd_rows<8, true>(a, F / bf, s);
  if (err != cudaSuccess) return static_cast<int>(err);

  DecodeArgs b = {};  // down: [M, F] x [F/2, D] -> bf16 [M, D] (+ x)
  b.a = static_cast<const int8_t*>(hq);
  b.w = static_cast<const int8_t*>(dn_packed);
  b.w_scale = static_cast<const float*>(dn_scale);
  b.blk_scale = static_cast<const float*>(hs);
  b.residual = residual ? xb : nullptr;
  b.out = static_cast<__nv_bfloat16*>(out);
  b.M = M;
  b.N = D;
  b.K = F;
  b.gs = gs_f;
  b.bf = bf;
  b.nblk = F / 2 / bf;
  b.ks = ks_dn;
  b.kmax = kmax_dn;
  return static_cast<int>(launch_wd_rows<4, false>(b, D / 256, s));
}

// Dynamic shared memory of a decode-plan block (ops/q4_matmul.py checks its
// own copy of the formula against it on the card).
extern "C" int emu_wd_smem(int nt, int threads, int kmax, int cols) {
  return wd_smem(nt, threads, kmax, cols);
}
