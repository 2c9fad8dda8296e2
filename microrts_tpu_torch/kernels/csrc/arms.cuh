// The arm catalog's per-cell helpers shared by the kernels that read the
// env's packed legal mask (arms.cu, bayes.cu): an arm's legality and the
// warp's first maximum of a float over the arms.
#pragma once
#include "common.cuh"

// Legality of arm a for a cell whose packed mask is m.
__device__ __forceinline__ bool arm_legal(const int32_t* m, int a, int T) {
  if (!m[0]) return false;
  if (a == 0) return true;
  if (a < 13) return m[6 + a] != 0;  // move / harvest / return channels
  const int ab = 13 + 4 * T;
  if (a < ab) {
    const int pj = a - 13;
    return m[19 + pj / T] != 0 && m[23 + pj % T] != 0;
  }
  return m[23 + T + (a - ab)] != 0;
}

#define FULL_MASK 0xffffffffu

// (bv, bi) <- (v, i) where v is larger, or equal at a smaller index: the
// first maximum, as argmax takes it.
__device__ __forceinline__ void take_max(float& bv, int& bi, float v,
                                         int i) {
  if (v > bv || (v == bv && i < bi)) { bv = v; bi = i; }
}

// The warp's first maximum of the lanes' (bv, bi); 0 where no lane saw a
// value above -inf (bi still INF_I), as a serial strict-> scan from -inf
// at index 0 leaves it.
__device__ __forceinline__ int warp_first_max(float bv, int bi) {
  for (int o = 16; o > 0; o >>= 1) {
    const float ov = __shfl_xor_sync(FULL_MASK, bv, o);
    const int oi = __shfl_xor_sync(FULL_MASK, bi, o);
    take_max(bv, bi, ov, oi);
  }
  return bi == INF_I ? 0 : bi;
}
