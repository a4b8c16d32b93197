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
//
// The fused route (dfscan_kernel_cic_rows, entry dfscan_cic_rows_launch)
// is the scan deposit's use of this kernel with the stages in front of it
// and the pack after it taken in. It replaces no further TPU kernel: the
// reference computes the base cells, the fractions and the corner-weight
// rows in XLA, pads them into tiles, calls the TPU kernel, and
// concatenates hi and lo. Here a warp takes one tile of the sorted stream
// (the rows [n] of 16 bytes that ops/rowsort's key-value sort leaves: the
// D block-local coordinates, then the mass, then zeros) and makes one pass
// a pair of the group's channels: it reads each row's coordinates and mass
// in one 16-byte load (a warp's load is 512 contiguous bytes), computes
// the base cell and fraction as ops/dfscan.cic_frac does (torch.clamp's
// bits, NaN and signed zeros included), builds the two corner weights
// mass * ((t0 * t1) * t2) with t = frac or 1 - frac, zero past n, runs
// the doubling loop on both channels side by side in registers, and
// writes hi into row j and lo into row g + j of one [2 g, n_pad] pack:
// the layout the deposit gathers from. Products are explicit
// round-to-nearest intrinsics too, so nothing contracts into an FMA, and
// the bits are those of the plain stages (ops/dfscan.cic_tile_prefix_plain).
//
// Bound of the fused route: device memory bandwidth, 16 bytes read a row
// for the whole group, and 8 bytes written an element (hi and lo) of each
// channel: 16 + 8 g bytes a row, or 16 bytes an element of a group of 2
// channels, against the rows route's 12 an element plus the plain stages' own passes (the base cells,
// fractions, weight rows, the pad and the pack, each a full pass over the
// channels in device memory). The scan deposit's groups of 2 (above 2^24
// rows) take one pass; a group of 8 takes four, the later ones reading
// the tile again from the cache, where it still lies, and recomputing
// its fractions: that keeps no coordinate live across passes, so a lane
// holds the two channels' (hi, lo) and little else, and the card keeps
// enough warps in flight to hide the shuffles' and adds' latency (the
// fractions kept live for a whole group take over 100 registers a thread
// at D = 3, R = 8). A pass issues all its loads before it computes
// anything: with each load beside the fraction it feeds, a warp waits
// out one load after another, which doubles the launch's time on an
// H100. D is a template parameter (1 to 3) as R is; the fused route
// takes R = 1, 2, 4, ..., 32, a tile padded with zeros up to the next
// one.

#include <cuda_runtime.h>
#include <stdint.h>
#include "base_cell.cuh"
#include "df_add.cuh"
#include "resource_usage.cuh"

#define DFSCAN_MAX_TILE 1024
#define DFSCAN_MAX_REGS (DFSCAN_MAX_TILE / 32)
#define DFSCAN_WARPS 8  // warps per block
#define DFSCAN_BLOCK_THREADS 1024  // threads per row on the block route
// the largest row whose two (hi, lo) buffers fit one block's 232,448
// bytes of shared memory
#define DFSCAN_MAX_BLOCK_TILE (232448 / 16)
#define DFSCAN_CIC_DIMS 3  // the fused route's D = 1..3
#define DFSCAN_CIC_REGS 6  // and its R = 1, 2, 4, ..., 32
#define DFSCAN_CIC_PASS 2  // the fused route's channels a pass

__host__ __device__ constexpr int ceil_log2(int n) {
  return n <= 1 ? 0 : 1 + ceil_log2((n + 1) / 2);
}

// The doubling loop over the R registers of each lane (lane, its column
// col in register 0, the tile) for C rows side by side, one a channel:
// the rows route scans one (C = 1), the fused route two channels at once,
// which gives each step twice the independent adds. R and C are template
// parameters, so every register index is a constant and the arrays stay
// in registers.
template <int C, int R>
__device__ __forceinline__ void warp_df_scan(float (&h)[C][R],
                                             float (&l)[C][R], int lane,
                                             int col, int tile) {
#pragma unroll
  for (int e = 0; e < ceil_log2(R * 32); ++e) {
    const int s = 1 << e;
    if (s >= tile) break;  // warp-uniform
    if (s >= 32) {
      // register move; descending k keeps register k - d unmodified
      const int d = s / 32;
#pragma unroll
      for (int k = R - 1; k >= 0; --k) {
#pragma unroll
        for (int c = 0; c < C; ++c) {
          const float sh = k >= d ? h[c][k >= d ? k - d : 0] : 0.0f;
          const float sl = k >= d ? l[c][k >= d ? k - d : 0] : 0.0f;
          df_add(h[c][k], l[c][k], sh, sl);
        }
      }
    } else {
      const int src = (lane - s) & 31;
      const bool own = col >= s;
      float ph[C], pl[C];  // register k - 1 from lane src
#pragma unroll
      for (int c = 0; c < C; ++c) ph[c] = pl[c] = 0.0f;
#pragma unroll
      for (int k = 0; k < R; ++k) {
#pragma unroll
        for (int c = 0; c < C; ++c) {
          const float ch = __shfl_sync(0xffffffffu, h[c][k], src);
          const float cl = __shfl_sync(0xffffffffu, l[c][k], src);
          df_add(h[c][k], l[c][k], own ? ch : ph[c], own ? cl : pl[c]);
          ph[c] = ch;
          pl[c] = cl;
        }
      }
    }
  }
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

  float h[1][R], l[1][R];
#pragma unroll
  for (int k = 0; k < R; ++k) {
    const int c = k * 32 + col;
    h[0][k] = active && c < tile ? x[off + c] : 0.0f;
    l[0][k] = 0.0f;
  }

  warp_df_scan<1, R>(h, l, lane, col, tile);

  if (!active) return;
#pragma unroll
  for (int k = 0; k < R; ++k) {
    const int c = k * 32 + col;
    if (c < tile) {
      hi_out[off + c] = h[0][k];
      lo_out[off + c] = l[0][k];
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

// ---- the fused route: the scan deposit's channel groups ----------------

// torch.clamp(v, lo, hi) as PyTorch computes it on the card: NaN passes
// through, anything else is min(max(v, lo), hi). fmaxf and fminf alone
// would turn a NaN into a bound.
__device__ __forceinline__ float torch_clamp(float v, float lo, float hi) {
  return isnan(v) ? v : fminf(fmaxf(v, lo), hi);
}

// ops/dfscan.cic_frac for one coordinate r on an axis of `cells` cells:
// the base cell (base_cell.cuh), then clamp(r - float(cell), 0, 1).
__device__ __forceinline__ float cic_frac(float r, int cells) {
  const int i = base_cell(r, cells);
  return torch_clamp(__fsub_rn(r, __int2float_rn(i)), 0.0f, 1.0f);
}

struct CicShape {
  int cells[3];  // local_shape, axis by axis (unused axes 1)
};

// rows [n] float4, sorted (coordinates, then mass, one 16-byte load a
// row); pack [2 g, tiles * tile]: rows [0, g) the hi words, rows [g, 2 g)
// the lo words of corner channels c0 .. c0 + g - 1. Tile t is rows
// [t * tile, (t + 1) * tile) of the stream, zero past n; the warp geometry
// is the rows route's.
template <int D, int R>
__global__ void __launch_bounds__(DFSCAN_WARPS * 32)
    dfscan_kernel_cic_rows(const float4* __restrict__ rows, long long n,
                           float* __restrict__ pack, long long tiles,
                           int tile, int rows_per_warp, int c0, int g,
                           CicShape shape) {
  const int lane = threadIdx.x & 31;
  const long long row0 =
      ((long long)blockIdx.x * DFSCAN_WARPS + (threadIdx.x >> 5)) *
      rows_per_warp;
  if (row0 >= tiles) return;  // warp-uniform
  const int sub = R == 1 ? lane / tile : 0;  // the lane's tile in the warp
  const int col = lane - sub * tile;         // its column in register 0
  const long long row = row0 + sub;
  const bool active = sub < rows_per_warp && row < tiles;
  const long long off = row * tile;
  const long long n_pad = tiles * tile;

  // two channels a pass; each pass reads the rows' coordinates and mass
  // (from device memory once, from the cache after), computes their
  // fractions and the two corner weights, zero past n (a zero mass and
  // coordinate, so the weight is +0.0, as the pad writes), and scans
  // both channels side by side
#pragma unroll 1
  for (int j = 0; j < g; j += DFSCAN_CIC_PASS) {
    const int nc = min(DFSCAN_CIC_PASS, g - j);  // channels it writes
    float h[DFSCAN_CIC_PASS][R], l[DFSCAN_CIC_PASS][R];
    // every load first, so that they are in flight together
    float raw[D + 1][R];
#pragma unroll
    for (int k = 0; k < R; ++k) {
      const int c = k * 32 + col;
      const long long e = off + c;
      const bool in = active && c < tile && e < n;
      const float4 v = in ? rows[e] : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
      const float lanes[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
      for (int d = 0; d <= D; ++d) raw[d][k] = lanes[d];
    }
#pragma unroll
    for (int k = 0; k < R; ++k) {
      const float m = raw[D][k];
      float f[D];  // the fraction of +0.0 is +0.0
#pragma unroll
      for (int d = 0; d < D; ++d) f[d] = cic_frac(raw[d][k], shape.cells[d]);
#pragma unroll
      for (int q = 0; q < DFSCAN_CIC_PASS; ++q) {
        // bit D - 1 - d of the corner is its axis d (an odd last pass
        // computes its one channel twice and writes it once)
        const int corner = c0 + j + (q < nc ? q : 0);
        // mass * ((t0 * t1) * t2), the left fold the reference pins
        float w = 0.0f;
#pragma unroll
        for (int d = 0; d < D; ++d) {
          const float t = (corner >> (D - 1 - d)) & 1
                              ? f[d]
                              : __fsub_rn(1.0f, f[d]);
          w = d == 0 ? t : __fmul_rn(w, t);
        }
        h[q][k] = __fmul_rn(m, w);
        l[q][k] = 0.0f;
      }
    }

    warp_df_scan<DFSCAN_CIC_PASS, R>(h, l, lane, col, tile);

    if (active) {
#pragma unroll
      for (int q = 0; q < DFSCAN_CIC_PASS; ++q) {
        if (q >= nc) break;
        float* hi_out = pack + (long long)(j + q) * n_pad + off;
        float* lo_out = pack + (long long)(g + j + q) * n_pad + off;
#pragma unroll
        for (int k = 0; k < R; ++k) {
          const int c = k * 32 + col;
          if (c < tile) {
            hi_out[c] = h[q][k];
            lo_out[c] = l[q][k];
          }
        }
      }
    }
  }
}

// the fused route's register counts: powers of two, a tile padded up to
// the next one with zeros (which change no earlier prefix)
template <int D, int R>
static int launch_cic_r(int regs, const float4* rows, long long n,
                        float* pack, long long tiles, int tile,
                        int rows_per_warp, int c0, int g, CicShape shape,
                        cudaStream_t stream) {
  if (regs != R) {
    if constexpr (R < DFSCAN_MAX_REGS) {
      return launch_cic_r<D, R * 2>(regs, rows, n, pack, tiles, tile,
                                    rows_per_warp, c0, g, shape, stream);
    }
    return (int)cudaErrorInvalidValue;
  }
  const long long warps = (tiles + rows_per_warp - 1) / rows_per_warp;
  const long long blocks = (warps + DFSCAN_WARPS - 1) / DFSCAN_WARPS;
  if (blocks > 2147483647LL) return (int)cudaErrorInvalidValue;
  dfscan_kernel_cic_rows<D, R>
      <<<(unsigned int)blocks, DFSCAN_WARPS * 32, 0, stream>>>(
          rows, n, pack, tiles, tile, rows_per_warp, c0, g, shape);
  return (int)cudaGetLastError();
}

// the register route's instances (R = 1..DFSCAN_MAX_REGS), the block
// route's kernel and the fused route's instances (D = 1..3, R = 1..32 by
// powers of two)
#define DFSCAN_ROW(R) {"dfscan_kernel<" #R ">", (const void*)dfscan_kernel<R>}
#define DFSCAN_CIC_ROW(D, R)                        \
  {"dfscan_kernel_cic_rows<" #D "," #R ">",         \
   (const void*)dfscan_kernel_cic_rows<D, R>}
#define DFSCAN_CIC_ROWS(D)                                         \
  DFSCAN_CIC_ROW(D, 1), DFSCAN_CIC_ROW(D, 2), DFSCAN_CIC_ROW(D, 4), \
      DFSCAN_CIC_ROW(D, 8), DFSCAN_CIC_ROW(D, 16), DFSCAN_CIC_ROW(D, 32)
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
    DFSCAN_CIC_ROWS(1), DFSCAN_CIC_ROWS(2), DFSCAN_CIC_ROWS(3),
};
#undef DFSCAN_ROW
#undef DFSCAN_CIC_ROW
#undef DFSCAN_CIC_ROWS
static_assert(sizeof(kDfscanFns) / sizeof(FnRow) ==
                  DFSCAN_MAX_REGS + 1 + DFSCAN_CIC_DIMS * DFSCAN_CIC_REGS,
              "one row per register-route instance, the block route, and "
              "one per fused-route instance");

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

// The fused route (ops/dfscan.cic_tile_prefix_rows): rows [n] of 16
// bytes, 16-byte aligned (coordinates, then mass), pack [2 g, tiles *
// tile] float32; corner channels c0 .. c0 + g - 1 of 2^d, the axes' cell
// counts in cells0..2. Refused unless tiles = ceil(n / tile) (n >= 1),
// 1 <= d <= 3, the channels lie in [0, 2^d), each used axis has a cell,
// regs is a power of two from 1 to 32 with regs * 32 >= tile,
// tile <= 1024, and rows_per_warp follows the rows route's rule.
int dfscan_cic_rows_launch(const void* rows, long long n, void* pack,
                           long long tiles, int tile, int regs,
                           int rows_per_warp, int d, int c0, int g,
                           int cells0, int cells1, int cells2,
                           void* stream) {
  const CicShape shape = {{cells0, cells1, cells2}};
  if (n < 1 || tile < 1 || tile > DFSCAN_MAX_TILE || tiles < 1 ||
      (tiles - 1) * tile >= n || tiles * tile < n || regs < 1 ||
      regs > DFSCAN_MAX_REGS || (regs & (regs - 1)) != 0 ||
      regs * 32 < tile || rows_per_warp < 1 ||
      (rows_per_warp > 1 && (regs != 1 || rows_per_warp * tile > 32)) ||
      d < 1 || d > DFSCAN_CIC_DIMS || c0 < 0 || g < 1 || c0 + g > (1 << d) ||
      (uintptr_t)rows % sizeof(float4) != 0)
    return (int)cudaErrorInvalidValue;
  for (int a = 0; a < d; ++a)
    if (shape.cells[a] < 1) return (int)cudaErrorInvalidValue;
  const float4* p = (const float4*)rows;
  float* out = (float*)pack;
  cudaStream_t st = (cudaStream_t)stream;
  if (d == 1)
    return launch_cic_r<1, 1>(regs, p, n, out, tiles, tile, rows_per_warp,
                              c0, g, shape, st);
  if (d == 2)
    return launch_cic_r<2, 1>(regs, p, n, out, tiles, tile, rows_per_warp,
                              c0, g, shape, st);
  return launch_cic_r<3, 1>(regs, p, n, out, tiles, tile, rows_per_warp, c0,
                            g, shape, st);
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
