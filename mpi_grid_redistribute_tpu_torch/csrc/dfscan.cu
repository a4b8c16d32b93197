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
// work-efficient scan (or a library cumsum) would not be a port. Every
// element takes every step, the adds of shifted-in zeros included
// (-0.0 + 0.0 is +0.0, so skipping one would change bits).
//
// Design, tiles up to 1024: a warp per row, registers only -- no shared
// memory, no barrier.
// Lane l holds elements k * 32 + l for k < R = ceil(tile / 32), loaded as
// R independent coalesced warp loads; elements past the row end are zero,
// which changes no earlier prefix. A shift s >= 32 is a register move:
// element (k, l) takes (k - s / 32, l), or zero. A shift s < 32 shuffles
// every register once from lane (l - s) & 31; lane l takes register k's
// value when l >= s and register k - 1's otherwise (zero for k = 0). R is
// a template parameter, so every register index is a constant and the
// arrays stay in registers. For tile <= 16 a warp holds 32 / tile rows:
// lane l is column l % tile of row l / tile, and a shift reads zero when
// the lane's column is below it. The launch geometry (R and the rows per
// warp) is chosen on the host, ops/dfscan.geometry.
//
// Bound: device memory bandwidth -- 12 bytes per element (4 read, 8
// written). The 11 adds per element and step come close: an add takes an
// FMA's issue slot, so an H100 runs 33.5 T of them a second, and at
// [262144, 256] the 5.9 G adds need 0.18 ms against the 0.24 ms that the
// bytes need. The shuffles run on another pipe.
//
// Arithmetic: adds and subtracts only, each an explicit round-to-nearest
// intrinsic, so no contraction or reassociation can change a bit. Build
// without -ftz / --use_fast_math: denormals follow IEEE here, as in the
// plain PyTorch version on the card (XLA on the CPU and the TPU flush
// them, so bit comparisons with the JAX package avoid denormal inputs).
//
// Tiles above 1024 take a second geometry: one 1024-thread block per row,
// the row's hi/lo pair in shared memory, double-buffered (16 bytes an
// element), one barrier a step. Each thread computes the elements
// j = threadIdx.x + i * 1024 of the row from the previous buffer: the same
// _df_add(hi[j], lo[j], hi[j - s], lo[j - s]) with zeros below the shift,
// so the bits are those of the register route and the plain version. A
// block can use 232,448 bytes of shared memory on an H100, so this route
// takes tiles up to 14,528 (DFSCAN_MAX_BLOCK_TILE); ops/dfscan.geometry
// sends larger tiles to the plain version by that shape rule.
//
// The power-of-two and size gates of the TPU path are tiling constraints
// of that machine, not semantics: any tile from 1 to 14,528 is accepted.

#include <cuda_runtime.h>
#include <stdint.h>
#include "resource_usage.cuh"

#define DFSCAN_MAX_TILE 1024
#define DFSCAN_MAX_REGS (DFSCAN_MAX_TILE / 32)
#define DFSCAN_WARPS 8  // warps per block
#define DFSCAN_BLOCK_THREADS 1024  // threads per row on the block route
// the largest row whose two (hi, lo) buffers fit one block's 232,448
// bytes of shared memory
#define DFSCAN_MAX_BLOCK_TILE (232448 / 16)

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

__host__ __device__ constexpr int ceil_log2(int n) {
  return n <= 1 ? 0 : 1 + ceil_log2((n + 1) / 2);
}

template <int R>
__global__ void __launch_bounds__(DFSCAN_WARPS * 32)
    dfscan_kernel(const float* __restrict__ x, float* __restrict__ hi_out,
                  float* __restrict__ lo_out, long long rows, int tile,
                  int rows_per_warp) {
  const int lane = threadIdx.x & 31;
  const long long row0 =
      ((long long)blockIdx.x * DFSCAN_WARPS + (threadIdx.x >> 5)) *
      rows_per_warp;
  if (row0 >= rows) return;  // warp-uniform
  const int sub = R == 1 ? lane / tile : 0;  // the lane's row in the warp
  const int col = lane - sub * tile;         // its column in register 0
  const long long row = row0 + sub;
  const bool active = sub < rows_per_warp && row < rows;
  const long long off = row * tile;

  float h[R], l[R];
#pragma unroll
  for (int k = 0; k < R; ++k) {
    const int c = k * 32 + col;
    h[k] = active && c < tile ? x[off + c] : 0.0f;
    l[k] = 0.0f;
  }

#pragma unroll
  for (int e = 0; e < ceil_log2(R * 32); ++e) {
    const int s = 1 << e;
    if (s >= tile) break;  // warp-uniform
    if (s >= 32) {
      // register move; descending k keeps register k - d unmodified
      const int d = s / 32;
#pragma unroll
      for (int k = R - 1; k >= 0; --k) {
        const float sh = k >= d ? h[k >= d ? k - d : 0] : 0.0f;
        const float sl = k >= d ? l[k >= d ? k - d : 0] : 0.0f;
        df_add(h[k], l[k], sh, sl);
      }
    } else {
      const int src = (lane - s) & 31;
      const bool own = col >= s;
      float ph = 0.0f, pl = 0.0f;  // register k - 1 from lane src
#pragma unroll
      for (int k = 0; k < R; ++k) {
        const float ch = __shfl_sync(0xffffffffu, h[k], src);
        const float cl = __shfl_sync(0xffffffffu, l[k], src);
        df_add(h[k], l[k], own ? ch : ph, own ? cl : pl);
        ph = ch;
        pl = cl;
      }
    }
  }

  if (!active) return;
#pragma unroll
  for (int k = 0; k < R; ++k) {
    const int c = k * 32 + col;
    if (c < tile) {
      hi_out[off + c] = h[k];
      lo_out[off + c] = l[k];
    }
  }
}

template <int R>
static int launch_r(int regs, const float* x, float* hi, float* lo,
                    long long rows, int tile, int rows_per_warp,
                    cudaStream_t stream) {
  if (regs != R) {
    if constexpr (R < DFSCAN_MAX_REGS) {
      return launch_r<R + 1>(regs, x, hi, lo, rows, tile, rows_per_warp,
                             stream);
    }
    return (int)cudaErrorInvalidValue;
  }
  const long long warps = (rows + rows_per_warp - 1) / rows_per_warp;
  const long long blocks = (warps + DFSCAN_WARPS - 1) / DFSCAN_WARPS;
  if (blocks > 2147483647LL) return (int)cudaErrorInvalidValue;
  dfscan_kernel<R><<<(unsigned int)blocks, DFSCAN_WARPS * 32, 0, stream>>>(
      x, hi, lo, rows, tile, rows_per_warp);
  return (int)cudaGetLastError();
}

// One block per row: the row's (hi, lo) in two shared-memory buffers,
// [hi | lo] each; step e reads buffer e % 2 and writes the other.
__global__ void __launch_bounds__(DFSCAN_BLOCK_THREADS)
    dfscan_block_kernel(const float* __restrict__ x, float* __restrict__ hi_out,
                        float* __restrict__ lo_out, int tile) {
  extern __shared__ float sm[];
  float* src = sm;             // [hi: tile | lo: tile]
  float* dst = sm + 2 * tile;  // the other buffer
  const long long off = (long long)blockIdx.x * tile;
  for (int j = threadIdx.x; j < tile; j += DFSCAN_BLOCK_THREADS) {
    src[j] = x[off + j];
    src[tile + j] = 0.0f;
  }
  __syncthreads();
  for (int s = 1; s < tile; s <<= 1) {
    for (int j = threadIdx.x; j < tile; j += DFSCAN_BLOCK_THREADS) {
      float h = src[j], l = src[tile + j];
      const bool in = j >= s;
      df_add(h, l, in ? src[in ? j - s : 0] : 0.0f,
             in ? src[tile + (in ? j - s : 0)] : 0.0f);
      dst[j] = h;
      dst[tile + j] = l;
    }
    __syncthreads();
    float* t = src;
    src = dst;
    dst = t;
  }
  for (int j = threadIdx.x; j < tile; j += DFSCAN_BLOCK_THREADS) {
    hi_out[off + j] = src[j];
    lo_out[off + j] = src[tile + j];
  }
}

static int launch_block(const float* x, float* hi, float* lo, long long rows,
                        int tile, cudaStream_t stream) {
  if (rows > 2147483647LL) return (int)cudaErrorInvalidValue;
  const size_t smem = (size_t)tile * 4 * sizeof(float);
  static bool attr_set = false;
  if (!attr_set) {
    cudaError_t err = cudaFuncSetAttribute(
        dfscan_block_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        DFSCAN_MAX_BLOCK_TILE * 4 * (int)sizeof(float));
    if (err != cudaSuccess) return (int)err;
    attr_set = true;
  }
  dfscan_block_kernel<<<(unsigned int)rows, DFSCAN_BLOCK_THREADS, smem,
                        stream>>>(x, hi, lo, tile);
  return (int)cudaGetLastError();
}

// the register route's instances (R = 1..DFSCAN_MAX_REGS) and the block
// route's kernel
#define DFSCAN_ROW(R) {"dfscan_kernel<" #R ">", (const void*)dfscan_kernel<R>}
static const FnRow kDfscanFns[] = {
    DFSCAN_ROW(1), DFSCAN_ROW(2), DFSCAN_ROW(3), DFSCAN_ROW(4),
    DFSCAN_ROW(5), DFSCAN_ROW(6), DFSCAN_ROW(7), DFSCAN_ROW(8),
    DFSCAN_ROW(9), DFSCAN_ROW(10), DFSCAN_ROW(11), DFSCAN_ROW(12),
    DFSCAN_ROW(13), DFSCAN_ROW(14), DFSCAN_ROW(15), DFSCAN_ROW(16),
    DFSCAN_ROW(17), DFSCAN_ROW(18), DFSCAN_ROW(19), DFSCAN_ROW(20),
    DFSCAN_ROW(21), DFSCAN_ROW(22), DFSCAN_ROW(23), DFSCAN_ROW(24),
    DFSCAN_ROW(25), DFSCAN_ROW(26), DFSCAN_ROW(27), DFSCAN_ROW(28),
    DFSCAN_ROW(29), DFSCAN_ROW(30), DFSCAN_ROW(31), DFSCAN_ROW(32),
    {"dfscan_block_kernel", (const void*)dfscan_block_kernel},
};
#undef DFSCAN_ROW
static_assert(sizeof(kDfscanFns) / sizeof(FnRow) == DFSCAN_MAX_REGS + 1,
              "one row per register-route instance, and the block route");

extern "C" {

// regs and rows_per_warp as ops/dfscan.geometry chose them. The register
// route (tile <= 1024) is refused unless regs * 32 covers the tile, and
// rows_per_warp is 1 or (with one register) fits rows_per_warp * tile
// lanes in the warp; the block route (1024 < tile <= 14,528) takes
// regs = rows_per_warp = 0 and nothing else.
int dfscan_launch(const void* x, void* hi, void* lo, long long rows, int tile,
                  int regs, int rows_per_warp, void* stream) {
  if (rows >= 1 && tile > DFSCAN_MAX_TILE && tile <= DFSCAN_MAX_BLOCK_TILE &&
      regs == 0 && rows_per_warp == 0)
    return launch_block((const float*)x, (float*)hi, (float*)lo, rows, tile,
                        (cudaStream_t)stream);
  if (rows < 1 || tile < 1 || tile > DFSCAN_MAX_TILE || regs < 1 ||
      regs > DFSCAN_MAX_REGS || regs * 32 < tile || rows_per_warp < 1 ||
      (rows_per_warp > 1 && (regs != 1 || rows_per_warp * tile > 32)))
    return (int)cudaErrorInvalidValue;
  return launch_r<1>(regs, (const float*)x, (float*)hi, (float*)lo, rows,
                     tile, rows_per_warp, (cudaStream_t)stream);
}

// Every __global__ function's footprint (resource_usage.cuh).
int dfscan_resource_usage(int i, const char** name, int* out) {
  return fill_resource_usage(kDfscanFns,
                             (int)(sizeof(kDfscanFns) / sizeof(FnRow)), i,
                             name, out);
}

const char* dfscan_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
