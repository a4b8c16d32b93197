// The double-float add of the scan deposit's prefixes, as the plain
// PyTorch version computes it (ops/dfscan._df_add, its _two_sum written out
// in the same operation order): (a_hi + a_lo) + (b_hi + b_lo) as a (hi, lo)
// pair, into a. Adds and subtracts only, each an explicit round-to-nearest
// intrinsic, so no contraction or reassociation can change a bit. Shared by
// kernel 5 (dfscan.cu) and the tile carries (tilecarry.cu), so the two
// levels of the scan add alike.

#pragma once

__device__ __forceinline__ void df_add(float& a_hi, float& a_lo, float b_hi,
                                       float b_lo) {
  float s = __fadd_rn(a_hi, b_hi);
  float bb = __fsub_rn(s, a_hi);
  float e = __fadd_rn(__fsub_rn(a_hi, __fsub_rn(s, bb)), __fsub_rn(b_hi, bb));
  e = __fadd_rn(e, __fadd_rn(a_lo, b_lo));
  float hi = __fadd_rn(s, e);
  a_lo = __fsub_rn(e, __fsub_rn(hi, s));
  a_hi = hi;
}
