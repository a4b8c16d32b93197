// The base cell of a block-local coordinate, as the scan deposit computes
// it in plain PyTorch (ops/dfscan._base_cell): clip(int32(floor(r)), 0,
// cells - 1) with binning.floor_to_int32's saturating conversion.
//
// __float2int_rd rounds down, saturates at the int32 range's ends and
// takes NaN to 0, as floor_to_int32 does; its range ends clip to the same
// cells as floor_to_int32's clamp to [-2^31, 2^31 - 128]. Shared by
// kernel 5's fused load (dfscan.cu) and the payload sort's keyed pack
// (rowsort.cu), so the key and the fractions see one cell.

#pragma once

__device__ __forceinline__ int base_cell(float r, int cells) {
  return min(max(__float2int_rd(r), 0), cells - 1);
}
