// Pieces shared by the attention kernels built on TMA and wgmma: kernel A
// (attention.cu), batched_mha (batched_mha.cu) and the backward
// (attention_bwd.cu, whose dQ += dS.K and dV += P^T.dO are pv_wgmma's form).
//
// - bhsd_map: a TMA tensor map over a strided [B, H, S, D] (or token-major
//   [B, S, H, D]) bf16 view, boxes of 64 columns x `rows` rows in the
//   128-byte swizzle; reads past D or S fill zeros, so no pad reaches
//   device memory.
// - qk_wgmma / pv_wgmma: the two products of one 64-row warpgroup, S =
//   Q.K^T (both operands in shared memory, K-major) and O += P.V (P in
//   registers, V read N-major, the transposed-B form). Tiles hold DP / 64
//   chunks of 64 columns; a P.V wider than 128 columns chains an n128 and
//   an n64 or n128 product over the chunks.
// - pack_bf16: two fp32 probabilities rounded into one bf16x2 register of
//   the P operand.

#pragma once

#include <cuda_bf16.h>
#include <stdint.h>

#include "hopper.cuh"
#include "wgmma.cuh"

namespace {

template <int N>
__device__ __forceinline__ void qk_wgmma(float (&d)[N / 2], uint64_t da, uint64_t db, int acc) {
  if constexpr (N == 64) wgmma_bf16_ss_n64(d, da, db, acc);
  else wgmma_bf16_ss_n128(d, da, db, acc);
}

// O[64 x DP] += P[64 x 16] . V[16 x DP]; `db` describes the V tile's first
// chunk at this K step, whose chunks lie BK * 128 bytes apart.
template <int DP, int BK>
__device__ __forceinline__ void pv_wgmma(float (&d)[DP / 2], const uint32_t (&a)[4], uint64_t db) {
  if constexpr (DP == 64) {
    wgmma_bf16_rs_n64(d, a, db, 1);
  } else if constexpr (DP == 128) {
    wgmma_bf16_rs_n128(d, a, db, 1);
  } else {
    // columns 128.. start two chunks on; the descriptor holds addresses >> 4
    constexpr uint64_t step = (2 * BK * 128) >> 4;
    wgmma_bf16_rs_n128(*reinterpret_cast<float(*)[64]>(&d[0]), a, db, 1);
    if constexpr (DP == 192)
      wgmma_bf16_rs_n64(*reinterpret_cast<float(*)[32]>(&d[64]), a, db + step, 1);
    else
      wgmma_bf16_rs_n128(*reinterpret_cast<float(*)[64]>(&d[64]), a, db + step, 1);
  }
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// A 4-D map of a [B, H, S, D] view at its strides (elements), box 64 x rows.
inline bool bhsd_map(CUtensorMap* map, const void* base, int B, int H, int S, int D, long long sb,
                     long long sh, long long ss, int rows) {
  const uint64_t dims[4] = {static_cast<uint64_t>(D), static_cast<uint64_t>(S),
                            static_cast<uint64_t>(H), static_cast<uint64_t>(B)};
  // a dim of extent 1 is never stepped: give it a stride the encoder takes;
  // a broadcast (stride-0) dim of extent > 1 has no map
  const long long raw[3] = {ss, sh, sb};
  const uint64_t ext[3] = {static_cast<uint64_t>(S), static_cast<uint64_t>(H),
                           static_cast<uint64_t>(B)};
  uint64_t strides[3];
  uint64_t prev = 2ULL * D;
  for (int i = 0; i < 3; ++i) {
    if (ext[i] > 1 && raw[i] <= 0) return false;
    strides[i] = ext[i] == 1 ? prev : static_cast<uint64_t>(raw[i]) * 2;
    prev = strides[i] * ext[i];
  }
  const uint32_t box[4] = {64, static_cast<uint32_t>(rows), 1, 1};
  return make_map(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, base, dims, strides, box);
}

}  // namespace
