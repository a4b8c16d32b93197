// The scan deposit's tile carries on Hopper: the double-float inclusive
// prefix over the tiles' totals, as exclusive prefixes a tile.
//
// Replaces no TPU kernel: the reference runs this level in XLA
// (deposit._df_cumsum over the last element of each tile's within-tile
// prefix), and the port's plain version (ops/tilecarry.tile_carries_plain)
// runs the same Hillis-Steele doubling in PyTorch: ceil(log2(T)) steps over
// the T tile totals of each channel, each step _df_add(hi[t], lo[t],
// hi[t - s], lo[t - s]) with zeros below the shift s, then a zero column in
// front. That order is the contract, as in kernel 5 (dfscan.cu): every
// element takes every step, the adds of shifted-in zeros included. In
// PyTorch each step is ~14 launches (the shifted copies and the 11 adds),
// ~250 a channel group at the CIC cell's 262,144 tiles, each too small to
// fill the card, so the host's issue of them paced the deposit.
//
// Design: a launch runs up to TC_STEPS = 10 consecutive steps, with shifts
// stride * 1, 2, ..., 512. Steps whose shifts are multiples of `stride`
// join only elements of one residue class t mod stride, so a launch is
// independent scans of the classes' subsequences t = r + k * stride with
// shifts 1..512 in k, in shared memory (hi and lo double-buffered, one
// barrier a step). A class of at most TC_WIN = 2047 elements is scanned
// whole, several classes a block, each its own segment of the window: an
// element reads zero below its segment's start, which is the plain
// version's shifted-in zero. A longer class is cut into chunks of TC_OUT =
// 1024 consecutive k, a block each, loaded behind a halo of the TC_HALO =
// 1023 k before them (zeros below k = 0). After j steps an element depends
// on the 2^j - 1 elements before it, so the chunk's elements are exact
// after 10 steps: the halo's own values, which lack their left partners,
// are never read by them. Elements below k = 0 hold +0.0, and _df_add of
// zeros gives +0.0. The first launch (stride 1) reads the tile totals
// where kernel 5 wrote them (the last element of each tile of the [2 g,
// n_pad] pack, hi rows above lo rows); each next launch (stride 1024 times
// the last) reads the previous one's output from another buffer, since
// chunks' halos overlap; the last writes the [2 g, T + 1] result with its
// zero column. At 262,144 tiles that is two launches a group, chunked,
// then 1024 classes of 256 seven a block, in one C entry, where the plain
// version makes ~250.
//
// Arithmetic: df_add.cuh, the adds of kernel 5. Build without -ftz /
// --use_fast_math: denormals follow IEEE, as in the plain version.
//
// Bound: latency, not bytes. A group's tile totals are 2 g T floats read
// once (the halo reads them again, at most twice in all) and 2 g (T + 1)
// written: ~4 MB at 262,144 tiles and g = 2.

#include <cuda_runtime.h>
#include <limits.h>

#include "df_add.cuh"
#include "resource_usage.cuh"

#define TC_THREADS 1024
#define TC_STEPS 10  // the steps a launch: shifts stride * 1 .. 512
#define TC_HALO ((1 << TC_STEPS) - 1)
#define TC_OUT TC_THREADS  // the outputs a block
#define TC_WIN (TC_OUT + TC_HALO)

// Channel c = blockIdx.y of g: element t's hi at src[c * s_row + s_off +
// t * s_col], its lo g rows below; the result's at dst[c * d_row + d_off +
// t]. The window holds `per_block` segments of `seg` elements: block x's
// segment i is class r = (x / chunks) * per_block + i from k = (x % chunks)
// * TC_OUT - halo (halo 0 when a segment holds a whole class, TC_HALO when
// it holds a chunk, per_block then 1). `steps` <= TC_STEPS shifts of
// stride * 2^e; the elements from `halo` on in each segment are written.
// d_off = 1 writes the zero column at d_off - 1.
__global__ void __launch_bounds__(TC_THREADS)
    tile_carry_kernel(const float* __restrict__ src, long long s_row,
                      long long s_col, long long s_off,
                      float* __restrict__ dst, long long d_row,
                      long long d_off, int g, long long T, long long stride,
                      long long classes, int seg, int per_block, int halo,
                      long long chunks, int steps) {
  __shared__ float buf[2][2][TC_WIN];  // [buffer][hi, lo][window]
  const long long c = blockIdx.y;
  const long long r0 = (long long)(blockIdx.x / chunks) * per_block;
  const long long k0 = (long long)(blockIdx.x % chunks) * TC_OUT - halo;
  const int win = seg * per_block;
  const float* s_hi = src + c * s_row + s_off;
  const float* s_lo = src + (g + c) * s_row + s_off;
  for (int p = threadIdx.x; p < win; p += TC_THREADS) {
    const long long r = r0 + p / seg;
    const long long k = k0 + p % seg;
    const long long t = r + k * stride;
    const bool in = r < classes && k >= 0 && t < T;
    buf[0][0][p] = in ? s_hi[(in ? t : 0) * s_col] : 0.0f;
    buf[0][1][p] = in ? s_lo[(in ? t : 0) * s_col] : 0.0f;
  }
  __syncthreads();
  int cur = 0;
  for (int e = 0; e < steps; ++e) {
    const int s = 1 << e;
    for (int p = threadIdx.x; p < win; p += TC_THREADS) {
      float h = buf[cur][0][p], l = buf[cur][1][p];
      const bool in = p % seg >= s;
      df_add(h, l, in ? buf[cur][0][in ? p - s : 0] : 0.0f,
             in ? buf[cur][1][in ? p - s : 0] : 0.0f);
      buf[cur ^ 1][0][p] = h;
      buf[cur ^ 1][1][p] = l;
    }
    __syncthreads();
    cur ^= 1;
  }
  float* d_hi = dst + c * d_row + d_off;
  float* d_lo = dst + (g + c) * d_row + d_off;
  for (int p = threadIdx.x; p < win; p += TC_THREADS) {
    const long long r = r0 + p / seg;
    const long long k = k0 + p % seg;
    const long long t = r + k * stride;
    if (p % seg >= halo && r < classes && t < T) {
      d_hi[t] = buf[cur][0][p];
      d_lo[t] = buf[cur][1][p];
    }
  }
  if (d_off > 0 && blockIdx.x == 0 && threadIdx.x == 0) {
    d_hi[-1] = 0.0f;
    d_lo[-1] = 0.0f;
  }
}

static const FnRow kTilecarryFns[] = {
    {"tile_carry_kernel", (const void*)tile_carry_kernel},
};

extern "C" {

// pack [2 g, n_pad] float32 (row stride pack_row, columns contiguous), the
// within-tile prefixes of g channels, hi rows above lo rows; T = n_pad /
// tile tiles. Writes out [2 g, T + 1] (contiguous): column 0 zero, column
// t + 1 the inclusive double-float prefix of the tiles' last elements up to
// tile t. temp [2 g, T] (contiguous) is the launches' other buffer, used
// when T > 1024. Refused unless 1 <= g <= 65535, tile >= 1, n_pad a
// positive multiple of tile and pack_row >= n_pad.
int tilecarry_launch(const void* pack, long long pack_row, long long n_pad,
                     int g, long long tile, void* temp, void* out,
                     void* stream) {
  if (g < 1 || g > 65535 || tile < 1 || n_pad < tile || n_pad % tile ||
      pack_row < n_pad)
    return (int)cudaErrorInvalidValue;
  const cudaStream_t st = (cudaStream_t)stream;
  const long long T = n_pad / tile;
  int total = 0;  // the steps: shifts 1, 2, 4, ... below T
  while (total < 62 && (1LL << total) < T) ++total;
  const int launches = total == 0 ? 1 : (total + TC_STEPS - 1) / TC_STEPS;
  const float* src = (const float*)pack;
  long long s_row = pack_row, s_col = tile, s_off = tile - 1;
  long long stride = 1;
  for (int q = 0; q < launches; ++q) {
    const bool last = q == launches - 1;
    // the buffers alternate so that the last launch writes out
    float* dst = (float*)(((launches - 1 - q) % 2 == 0) ? out : temp);
    const long long d_row = dst == (float*)out ? T + 1 : T;
    const long long d_off = dst == (float*)out ? 1 : 0;
    const int steps = last ? total - q * TC_STEPS : TC_STEPS;
    const long long classes = stride < T ? stride : T;
    const long long len = (T + stride - 1) / stride;  // class 0's elements
    // a whole class a segment where it fits the window, else chunks
    const bool whole = len <= TC_WIN;
    const int seg = whole ? (int)len : TC_WIN;
    const int per_block = whole ? TC_WIN / seg : 1;
    const long long chunks = whole ? 1 : (len + TC_OUT - 1) / TC_OUT;
    const long long blocks = (classes + per_block - 1) / per_block * chunks;
    if (blocks > INT_MAX) return (int)cudaErrorInvalidValue;
    tile_carry_kernel<<<dim3((unsigned int)blocks, g), TC_THREADS, 0, st>>>(
        src, s_row, s_col, s_off, dst, d_row, d_off, g, T, stride, classes,
        seg, per_block, whole ? 0 : TC_HALO, chunks, steps);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    src = dst;
    s_row = d_row;
    s_col = 1;
    s_off = d_off;
    stride <<= TC_STEPS;
  }
  return 0;
}

// The kernel's __global__ function (resource_usage.cuh).
int tilecarry_resource_usage(int i, const char** name, int* out) {
  return fill_resource_usage(
      kTilecarryFns, (int)(sizeof(kTilecarryFns) / sizeof(FnRow)), i, name,
      out);
}

const char* tilecarry_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
