// Within-row double-float (TwoSum hi/lo) inclusive prefix sum on Hopper.
//
// Replaces the TPU kernel mpi_grid_redistribute_tpu/ops/pallas_dfscan.py
// (_kernel / tile_df_cumsum_rows). For x [rows, tile] float32 it writes
// hi and lo [rows, tile]: the inclusive prefix of each row carried as an
// unevaluated (hi, lo) float pair, by the Hillis-Steele doubling loop of
// the reference's deposit._df_cumsum -- ceil(log2(tile)) steps, each one
// _df_add(hi[i], lo[i], hi[i - shift], lo[i - shift]) with zeros below
// the shift. That ORDER is the contract: the scan deposit's accuracy and
// its bit equality with the JAX package both rest on it, so a
// work-efficient scan (or a library cumsum) would not be a port.
//
// Design: one thread per element, one block per row (several rows per
// block when tile < 256). Each thread keeps its (hi, lo) in registers and
// publishes it to a double-buffered shared array before every step; one
// __syncthreads() per step separates a step's writes from its reads, and
// the double buffer keeps the next step's writes off the words a slow
// thread may still be reading. Device memory sees one read of x and one
// write each of hi and lo.
//
// Bound: device memory bandwidth -- 12 bytes per element (4 read, 8
// written); the ~11 adds per element and step are far below the card's
// float32 rate.
//
// Arithmetic: adds and subtracts only, each an explicit round-to-nearest
// intrinsic, so no contraction or reassociation can change a bit. Build
// without -ftz / --use_fast_math: denormals follow IEEE here, as in the
// plain PyTorch version on the card (XLA on the CPU and the TPU flush
// them, so bit comparisons with the JAX package avoid denormal inputs).
//
// Any tile from 1 to 1024 is accepted: the power-of-two and size gates of
// the TPU path are tiling constraints of that machine, not semantics.

#include <cuda_runtime.h>
#include <stdint.h>

#define DFSCAN_MAX_TILE 1024
#define DFSCAN_BLOCK 256

// deposit._df_add(a_hi, a_lo, b_hi, b_lo), its _two_sum written out in
// the same operation order
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

__global__ void dfscan_kernel(const float* __restrict__ x,
                              float* __restrict__ hi_out,
                              float* __restrict__ lo_out, long long rows,
                              int tile, int rows_per_block) {
  extern __shared__ float smem[];  // hi[2][width], lo[2][width]
  const int width = rows_per_block * tile;  // == blockDim.x
  const int t = threadIdx.x;
  const int local_row = t / tile;
  const int col = t - local_row * tile;
  const long long row = (long long)blockIdx.x * rows_per_block + local_row;
  const bool active = row < rows;
  const long long idx = row * tile + col;

  float h = active ? x[idx] : 0.0f;
  float l = 0.0f;
  int p = 0;
  for (int shift = 1; shift < tile; shift <<= 1) {
    float* bh = smem + p * width;
    float* bl = smem + (2 + p) * width;
    bh[t] = h;
    bl[t] = l;
    __syncthreads();
    float sh = 0.0f, sl = 0.0f;
    if (col >= shift) {
      sh = bh[t - shift];
      sl = bl[t - shift];
    }
    df_add(h, l, sh, sl);
    p ^= 1;
  }
  if (active) {
    hi_out[idx] = h;
    lo_out[idx] = l;
  }
}

extern "C" {

int dfscan_launch(const void* x, void* hi, void* lo, long long rows, int tile,
                  void* stream) {
  if (rows < 1 || tile < 1 || tile > DFSCAN_MAX_TILE)
    return (int)cudaErrorInvalidValue;
  const int rows_per_block = tile >= DFSCAN_BLOCK ? 1 : DFSCAN_BLOCK / tile;
  const int threads = rows_per_block * tile;
  const long long blocks = (rows + rows_per_block - 1) / rows_per_block;
  if (blocks > 2147483647LL) return (int)cudaErrorInvalidValue;
  const size_t smem = 4 * (size_t)threads * sizeof(float);
  dfscan_kernel<<<(unsigned int)blocks, threads, smem,
                  (cudaStream_t)stream>>>(
      (const float*)x, (float*)hi, (float*)lo, rows, tile, rows_per_block);
  return (int)cudaGetLastError();
}

const char* dfscan_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
