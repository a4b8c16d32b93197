// Segmented CIC deposit on Hopper: per-cell sums of the 2^D corner
// weights of a cell-sorted particle stream.
//
// Replaces the TPU kernel mpi_grid_redistribute_tpu/ops/pallas_segdep.py
// (_kernel / _segsum_tpu, entry segsum_sorted). Input: keys [N] int32,
// rel [D, N] block-local coordinates and mass [N] (or none: unit mass,
// nothing read) in the same order. Output: out [2^D, n_cells] float32,
// out[c, k] = the sum over the rows of key k of corner c's CIC weight.
// Keys outside [0, n_cells) are dropped (the sentinel n_cells marks an
// invalid row).
//
// Stream contract: the VALID keys never decrease along the stream;
// invalid keys may sit anywhere. A globally sorted stream qualifies, and
// so do per-slab sorts of vrank-major keys concatenated (slab v holds
// keys in [v*C, (v+1)*C) and its sentinels at its tail). It is inside the
// TPU kernel's chunk-monotone contract ("keys only ever advance"). A
// stream that breaks it gives wrong sums but never a write outside out;
// ops/segdep.segsum_sorted refuses such a stream under
// MPI_GRID_SEGDEP_DEBUG=1.
//
// The TPU design (one-hot [T, 128] matrix products into a VMEM chunk
// accumulator) exists because the TPU cannot scatter; none of it carries
// over. On Hopper the bound is device memory bandwidth: read keys, rel
// (and mass) once, write the canvas once; the weight arithmetic (~8
// operations per corner) is far below the card's float32 rate. The first
// design (one row per thread, a segmented warp scan of all 2^D channels
// for every row, a serial cross-warp loop in thread 0, each run's 2^D
// sums stored alone into planes n_cells apart) ran at 5.3x that bound.
// Taking the scan off the rows alone gained nothing: the lone stores into
// the 2^D planes cost as much. Here:
//   1. a block of 256 threads takes a tile of 2048 consecutive rows, 8
//      per lane; each lane loads its keys and rel words with 16-byte
//      loads through L1 (a warp reads 1 KB of each row contiguously).
//      Resident blocks that copy the next tile into a shared stage with
//      cp.async while they sum the current one were slower: the two
//      stages leave room for two blocks a multiprocessor, not three;
//   2. each lane builds its rows' corner weights in registers in
//      _corner_weights' operation order (float clip-floor fracs,
//      left-fold product, mass multiplied last, every multiply and add an
//      explicit round-to-nearest intrinsic so nothing contracts into an
//      FMA) and sums its runs sequentially; invalid rows are skipped and
//      do not break a run;
//   3. only each lane's summary -- first key, last key, the sum of its
//      last run -- goes through a segmented scan (shuffles within the
//      warp, then one warp over the 8 warp totals): 2 + 2^D words per
//      step per 8 rows instead of 1 + 2^D per row. The combine is "add if
//      the last keys are equal", which the contract makes exact;
//   4. runs land in a shared-memory window of the canvas, 1024 cells
//      (512 at D = 4) from the tile's first valid key (a tile of the
//      config-5 stream spans ~570 cells); the block then writes the window's cells strictly
//      between its first and last key with coalesced stores, empty cells
//      as zeros. A run that starts and ends inside a lane is placed at
//      once; with its exclusive prefix a lane places the run that ended
//      at its first row and the run its first break ends. Runs past the
//      window (sparse tiles) are stored directly;
//   5. tile edges: the run of a tile's first key may continue from
//      earlier tiles and its last run into later ones, so neither is
//      stored by the tile: its carry record holds (first key, last key,
//      the tile's total of its last run, its sum of its first run). A
//      second kernel of one 1024-thread block scans the records with the
//      same combine and stores the runs that cross or end at tile edges,
//      and the stream's last run. It is a parallel scan, so a cell whose
//      run spans thousands of tiles costs no serial walk; a decoupled
//      look-back would save its launch but needs tiles to publish and
//      spin in order, which this does not;
//   6. cells no tile's window covers (gaps between tiles, sparse tiles,
//      the canvas's ends) read 0 from a cudaMemsetAsync of the output. A
//      gap can be as long as the canvas (sparse or sentinel-heavy
//      streams), and zeroing it at its break would put it on one thread
//      or one block.
// D is a template parameter from 1 to 4 (16 channels): the lane
// registers, the carry records and the canvas window are sized from it,
// and D <= 3 compiles to the same code as before D = 4 was added.
// ops/segdep.geometry sends D >= 5 to the plain version by that shape
// rule (32 channels would need 64 KB of window, past the static 48 KB).
// No float atomics: the summation order is fixed, so results are
// bit-reproducible from run to run. PERF.md has the card times, and the
// probes (memset alone, stream read alone, no valid row, D = 1) that
// show where the rest of the time goes.

#include <cuda_runtime.h>
#include <limits.h>
#include <stdint.h>
#include "resource_usage.cuh"

#define SEGDEP_MAX_D 4
#define SEGDEP_THREADS 256
#define SEGDEP_WARPS (SEGDEP_THREADS / 32)
#define SEGDEP_RPL 8  // rows per lane
// canvas cells a tile stages in shared memory: 1024 up to D = 3 (32 KB
// at 8 channels), 512 at D = 4 (32 KB at 16), inside the 48 KB of static
// shared memory a block may declare
#define SEGDEP_WIN(D) ((D) <= 3 ? 1024 : 512)
#define SEGDEP_TILE (SEGDEP_THREADS * SEGDEP_RPL)
#define SEGDEP_SCAN_THREADS 1024
#define FULL_MASK 0xffffffffu

struct SegdepParams {
  float vmax[SEGDEP_MAX_D];  // float(vblock[d] - 1), the clip of floor(r)
};

// A stretch of the stream: its first and last valid key and the sum of
// its last run. Empty: fk = INT_MAX, lk = -1, t = 0.
template <int NCH>
struct Seg {
  int fk, lk;
  float t[NCH];
};

template <int NCH>
__device__ __forceinline__ Seg<NCH> seg_empty() {
  Seg<NCH> s;
  s.fk = INT_MAX;
  s.lk = -1;
#pragma unroll
  for (int c = 0; c < NCH; ++c) s.t[c] = 0.0f;
  return s;
}

// b = a (earlier) followed by b (later). Valid keys never decrease, so
// b's last run continues a's exactly when the last keys are equal.
template <int NCH>
__device__ __forceinline__ void seg_combine(const Seg<NCH>& a, Seg<NCH>& b) {
  if (b.lk < 0) {
    b = a;
    return;
  }
  if (a.lk == b.lk) {
#pragma unroll
    for (int c = 0; c < NCH; ++c) b.t[c] = __fadd_rn(a.t[c], b.t[c]);
  }
  b.fk = min(a.fk, b.fk);
}

template <int NCH>
__device__ __forceinline__ Seg<NCH> seg_shfl_up(const Seg<NCH>& s, int off) {
  Seg<NCH> o;
  o.fk = __shfl_up_sync(FULL_MASK, s.fk, off);
  o.lk = __shfl_up_sync(FULL_MASK, s.lk, off);
#pragma unroll
  for (int c = 0; c < NCH; ++c) o.t[c] = __shfl_up_sync(FULL_MASK, s.t[c], off);
  return o;
}

// in: the lane's element; returns the exclusive prefix over the warp,
// and leaves the inclusive one in s
template <int NCH>
__device__ __forceinline__ Seg<NCH> warp_scan(Seg<NCH>& s, int lane) {
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const Seg<NCH> o = seg_shfl_up(s, off);
    if (lane >= off) seg_combine(o, s);
  }
  Seg<NCH> e = seg_shfl_up(s, 1);
  if (lane == 0) e = seg_empty<NCH>();
  return e;
}

// Exclusive prefix of every thread's element over the block; the block's
// total in *total. s_w, s_wx: shared [warps] scratch.
template <int NCH, int WARPS>
__device__ __forceinline__ Seg<NCH> block_scan(Seg<NCH> s, Seg<NCH>* s_w,
                                               Seg<NCH>* s_wx,
                                               Seg<NCH>* total) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  Seg<NCH> e = warp_scan(s, lane);
  if (lane == 31) s_w[warp] = s;
  __syncthreads();
  if (warp == 0) {
    Seg<NCH> a = lane < WARPS ? s_w[lane] : seg_empty<NCH>();
    const Seg<NCH> ax = warp_scan(a, lane);
    if (lane < WARPS) s_wx[lane] = ax;
    if (lane == WARPS - 1) *total = a;
  }
  __syncthreads();
  const Seg<NCH> wp = s_wx[warp];
  seg_combine(wp, e);
  return e;
}

// jnp.clip / torch.clamp: max with lo, then min with hi; NaN passes
__device__ __forceinline__ float clip_f(float x, float lo, float hi) {
  x = (x < lo) ? lo : x;
  return (x > hi) ? hi : x;
}

// pallas_segdep._corner_weights' order: itertools.product over the
// corners, axis 0 the most significant bit
template <int D, bool MASS>
__device__ __forceinline__ void corner_weights(const float (&r)[D], float m,
                                               const SegdepParams& prm,
                                               float (&w)[1 << D]) {
  float frac[D];
#pragma unroll
  for (int d = 0; d < D; ++d) {
    const float i0 = clip_f(floorf(r[d]), 0.0f, prm.vmax[d]);
    frac[d] = clip_f(__fsub_rn(r[d], i0), 0.0f, 1.0f);
  }
#pragma unroll
  for (int c = 0; c < (1 << D); ++c) {
    float wc = 0.0f;
#pragma unroll
    for (int d = 0; d < D; ++d) {
      const int bit = (c >> (D - 1 - d)) & 1;
      const float tt = bit ? frac[d] : __fsub_rn(1.0f, frac[d]);
      wc = (d == 0) ? tt : __fmul_rn(wc, tt);
    }
    w[c] = MASS ? __fmul_rn(m, wc) : wc;
  }
}

template <int NCH>
__device__ __forceinline__ void put(float* __restrict__ out, int n_cells,
                                    int key, const float (&v)[NCH]) {
#pragma unroll
  for (int c = 0; c < NCH; ++c) out[(long long)c * n_cells + key] = v[c];
}

// a run's sums into the tile's shared canvas window when its key is in
// [lo, lo + WIN), else straight to out
template <int NCH, int WIN>
__device__ __forceinline__ void put_tile(float (*win)[WIN],
                                         float* __restrict__ out,
                                         int n_cells, int lo, int key,
                                         const float (&v)[NCH]) {
  const unsigned int off = (unsigned int)(key - lo);
  if (off < WIN) {
#pragma unroll
    for (int c = 0; c < NCH; ++c) win[c][off] = v[c];
  } else {
    put<NCH>(out, n_cells, key, v);
  }
}

// tile_meta[b] = (first valid key, last valid key) of tile b (INT_MAX, -1
// when it has none); tile_sums[b] = [total of its last run | its sum of
// its first run, set only when the tile holds more than one run]
template <int D, bool MASS>
__global__ void __launch_bounds__(SEGDEP_THREADS)
    segdep_tile_kernel(const int32_t* __restrict__ keys,
                       const float* __restrict__ rel,
                       const float* __restrict__ mass,
                       float* __restrict__ out, int2* __restrict__ tile_meta,
                       float* __restrict__ tile_sums, long long N,
                       int n_cells, SegdepParams prm, bool vec) {
  constexpr int NCH = 1 << D;
  constexpr int WIN = SEGDEP_WIN(D);
  __shared__ Seg<NCH> s_w[SEGDEP_WARPS], s_wx[SEGDEP_WARPS];
  __shared__ Seg<NCH> s_total;
  __shared__ float s_win[NCH][WIN];
  __shared__ int s_min[SEGDEP_WARPS];

  const long long row0 =
      (long long)blockIdx.x * SEGDEP_TILE + (long long)threadIdx.x * SEGDEP_RPL;

  // ---- the lane's 8 rows, all loads in flight before the arithmetic
  int k[SEGDEP_RPL];
  float r[D][SEGDEP_RPL];
  float ms[SEGDEP_RPL];
  if (vec && row0 + SEGDEP_RPL <= N) {
#pragma unroll
    for (int q = 0; q < SEGDEP_RPL / 4; ++q) {
      const int4 kv = __ldg(reinterpret_cast<const int4*>(keys + row0) + q);
      k[4 * q] = kv.x, k[4 * q + 1] = kv.y, k[4 * q + 2] = kv.z,
      k[4 * q + 3] = kv.w;
#pragma unroll
      for (int d = 0; d < D; ++d) {
        const float4 rv =
            __ldg(reinterpret_cast<const float4*>(rel + d * N + row0) + q);
        r[d][4 * q] = rv.x, r[d][4 * q + 1] = rv.y, r[d][4 * q + 2] = rv.z,
        r[d][4 * q + 3] = rv.w;
      }
      float4 mv = make_float4(1.0f, 1.0f, 1.0f, 1.0f);
      if (MASS) mv = __ldg(reinterpret_cast<const float4*>(mass + row0) + q);
      ms[4 * q] = mv.x, ms[4 * q + 1] = mv.y, ms[4 * q + 2] = mv.z,
      ms[4 * q + 3] = mv.w;
    }
  } else {
#pragma unroll
    for (int i = 0; i < SEGDEP_RPL; ++i) {
      const long long g = row0 + i;
      const bool in = g < N;
      k[i] = in ? keys[g] : -1;
#pragma unroll
      for (int d = 0; d < D; ++d) r[d][i] = in ? rel[d * N + g] : 0.0f;
      ms[i] = (MASS && in) ? mass[g] : 1.0f;
    }
  }

  // ---- the tile's first valid key (valid keys never decrease, so it is
  // their minimum) sets the canvas window [tile_fk, tile_fk + WIN), which
  // starts at zero
  int first = INT_MAX;
#pragma unroll
  for (int i = 0; i < SEGDEP_RPL; ++i)
    if (k[i] >= 0 && k[i] < n_cells) first = min(first, k[i]);
  first = __reduce_min_sync(FULL_MASK, first);
  if ((threadIdx.x & 31) == 0) s_min[threadIdx.x >> 5] = first;
  for (int i = threadIdx.x; i < NCH * WIN; i += SEGDEP_THREADS)
    (&s_win[0][0])[i] = 0.0f;
  __syncthreads();
  int tile_fk = s_min[0];
#pragma unroll
  for (int w = 1; w < SEGDEP_WARPS; ++w) tile_fk = min(tile_fk, s_min[w]);

  // ---- the lane's runs in stream order
  int fk = INT_MAX, cur = -1;
  bool broke = false;
  float sum[NCH], head[NCH];
#pragma unroll
  for (int c = 0; c < NCH; ++c) sum[c] = head[c] = 0.0f;
#pragma unroll
  for (int i = 0; i < SEGDEP_RPL; ++i) {
    const int key = k[i];
    if (key < 0 || key >= n_cells) continue;  // invalid: dropped
    float rr[D];
#pragma unroll
    for (int d = 0; d < D; ++d) rr[d] = r[d][i];
    float w[NCH];
    corner_weights<D, MASS>(rr, ms[i], prm, w);
    if (key == cur) {
#pragma unroll
      for (int c = 0; c < NCH; ++c) sum[c] = __fadd_rn(sum[c], w[c]);
    } else {
      if (cur < 0) {
        fk = key;
      } else if (!broke) {  // the lane's first run: may continue from before
        broke = true;
#pragma unroll
        for (int c = 0; c < NCH; ++c) head[c] = sum[c];
      } else {  // a run inside the lane
        put_tile<NCH, WIN>(s_win, out, n_cells, tile_fk, cur, sum);
      }
      cur = key;
#pragma unroll
      for (int c = 0; c < NCH; ++c) sum[c] = w[c];
    }
  }

  // ---- exclusive prefix of the lane summaries over the tile
  Seg<NCH> s;
  s.fk = fk;
  s.lk = cur;
#pragma unroll
  for (int c = 0; c < NCH; ++c) s.t[c] = sum[c];
  const Seg<NCH> e =
      block_scan<NCH, SEGDEP_WARPS>(s, s_w, s_wx, &s_total);
  float* carry = tile_sums + (long long)blockIdx.x * 2 * NCH;

  // ---- the runs that end at this lane's first row or first break; the
  // run of the tile's first key goes to the carry record instead
  if (cur >= 0) {
    const bool join = e.lk == fk;
    if (e.lk >= 0 && !join) {
      if (e.lk == tile_fk) {
#pragma unroll
        for (int c = 0; c < NCH; ++c) carry[NCH + c] = e.t[c];
      } else {
        put_tile<NCH, WIN>(s_win, out, n_cells, tile_fk, e.lk, e.t);
      }
    }
    if (broke) {
      float v[NCH];
#pragma unroll
      for (int c = 0; c < NCH; ++c)
        v[c] = join ? __fadd_rn(e.t[c], head[c]) : head[c];
      if (fk == tile_fk) {
#pragma unroll
        for (int c = 0; c < NCH; ++c) carry[NCH + c] = v[c];
      } else {
        put_tile<NCH, WIN>(s_win, out, n_cells, tile_fk, fk, v);
      }
    }
  }
  // ---- the window's cells strictly between the tile's first and last
  // keys (those two runs are the carry kernel's), coalesced
  __syncthreads();
  if (s_total.lk >= 0) {
    const int hi = min(s_total.lk - tile_fk, WIN);
#pragma unroll
    for (int c = 0; c < NCH; ++c)
      for (int i = 1 + threadIdx.x; i < hi; i += SEGDEP_THREADS)
        out[(long long)c * n_cells + tile_fk + i] = s_win[c][i];
  }
  if (threadIdx.x == 0) {
    tile_meta[blockIdx.x] = make_int2(s_total.fk, s_total.lk);
#pragma unroll
    for (int c = 0; c < NCH; ++c) carry[c] = s_total.t[c];
  }
}

template <int NCH>
__device__ __forceinline__ Seg<NCH> load_tile(const int2* __restrict__ meta,
                                              const float* __restrict__ sums,
                                              long long b) {
  Seg<NCH> x;
  const int2 mk = meta[b];
  x.fk = mk.x;
  x.lk = mk.y;
#pragma unroll
  for (int c = 0; c < NCH; ++c) x.t[c] = sums[b * 2 * NCH + c];
  return x;
}

// One block: the exclusive prefix P of every tile's carry record over the
// stream, then per tile the runs that end at its edge or at its first
// break, and the stream's last run.
template <int NCH>
__global__ void __launch_bounds__(SEGDEP_SCAN_THREADS)
    segdep_carry_kernel(const int2* __restrict__ tile_meta,
                        const float* __restrict__ tile_sums,
                        float* __restrict__ out, long long nb, int n_cells) {
  constexpr int WARPS = SEGDEP_SCAN_THREADS / 32;
  __shared__ Seg<NCH> s_w[WARPS], s_wx[WARPS];
  __shared__ Seg<NCH> s_total;
  const long long per = (nb + SEGDEP_SCAN_THREADS - 1) / SEGDEP_SCAN_THREADS;
  const long long b0 = threadIdx.x * per;
  const long long b1 = b0 + per < nb ? b0 + per : nb;

  Seg<NCH> a = seg_empty<NCH>();
  for (long long b = b0; b < b1; ++b) {
    Seg<NCH> x = load_tile<NCH>(tile_meta, tile_sums, b);
    seg_combine(a, x);
    a = x;
  }
  Seg<NCH> p = block_scan<NCH, WARPS>(a, s_w, s_wx, &s_total);
  for (long long b = b0; b < b1; ++b) {
    Seg<NCH> x = load_tile<NCH>(tile_meta, tile_sums, b);
    if (x.lk >= 0) {
      const bool join = p.lk == x.fk;
      if (p.lk >= 0 && !join) put<NCH>(out, n_cells, p.lk, p.t);
      if (x.fk != x.lk) {
        float v[NCH];
#pragma unroll
        for (int c = 0; c < NCH; ++c) {
          const float h = tile_sums[b * 2 * NCH + NCH + c];
          v[c] = join ? __fadd_rn(p.t[c], h) : h;
        }
        put<NCH>(out, n_cells, x.fk, v);
      }
    }
    seg_combine(p, x);
    p = x;
  }
  if (b0 < nb && b1 == nb && p.lk >= 0) put<NCH>(out, n_cells, p.lk, p.t);
}

template <int D, bool MASS>
static int launch_d(const void* keys, const void* rel, const void* mass,
                    void* out, void* tile_meta, void* tile_sums, long long N,
                    int n_cells, const SegdepParams& prm, bool vec,
                    long long nb, cudaStream_t s) {
  segdep_tile_kernel<D, MASS><<<(unsigned int)nb, SEGDEP_THREADS, 0, s>>>(
      (const int32_t*)keys, (const float*)rel, (const float*)mass,
      (float*)out, (int2*)tile_meta, (float*)tile_sums, N, n_cells, prm, vec);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  segdep_carry_kernel<1 << D><<<1, SEGDEP_SCAN_THREADS, 0, s>>>(
      (const int2*)tile_meta, (const float*)tile_sums, (float*)out, nb,
      n_cells);
  return (int)cudaGetLastError();
}

// every instance launch_d can pick: the tile kernel at D = 1..4 with and
// without a mass row, and the carry scan at 2^D channels
#define SEGDEP_ROWS(D)                                                     \
  {"segdep_tile_kernel<" #D ",false>",                                     \
   (const void*)segdep_tile_kernel<D, false>},                             \
      {"segdep_tile_kernel<" #D ",true>",                                  \
       (const void*)segdep_tile_kernel<D, true>},                          \
      {"segdep_carry_kernel<1<<" #D ">",                                   \
       (const void*)segdep_carry_kernel<1 << D>}
static const FnRow kSegdepFns[] = {SEGDEP_ROWS(1), SEGDEP_ROWS(2),
                                   SEGDEP_ROWS(3), SEGDEP_ROWS(4)};
#undef SEGDEP_ROWS

extern "C" {

// tile_meta: int32 [n_tiles, 2], tile_sums: float [n_tiles, 2 * 2^D]
// scratch with n_tiles = ceil(N / 2048) (ops/segdep.geometry; anything
// else is refused); vmax: host float [D]; mass may be NULL (unit mass).
int segdep_launch(const void* keys, const void* rel, const void* mass,
                  void* out, void* tile_meta, void* tile_sums, long long N,
                  int n_cells, int D, const float* vmax, long long n_tiles,
                  void* stream) {
  if (D < 1 || D > SEGDEP_MAX_D || N < 1 || n_cells < 1 ||
      n_tiles != (N + SEGDEP_TILE - 1) / SEGDEP_TILE ||
      n_tiles > 2147483647LL)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  cudaError_t err = cudaMemsetAsync(
      out, 0, (size_t)(1 << D) * (size_t)n_cells * sizeof(float), s);
  if (err != cudaSuccess) return (int)err;
  SegdepParams prm;
  for (int d = 0; d < SEGDEP_MAX_D; ++d) prm.vmax[d] = d < D ? vmax[d] : 0.0f;
  // 16-byte loads need every row start 16-byte aligned
  const bool vec = N % 4 == 0 && ((uintptr_t)keys & 15) == 0 &&
                   ((uintptr_t)rel & 15) == 0 &&
                   ((uintptr_t)mass & 15) == 0;
  const bool m = mass != nullptr;
#define SEGDEP_CASE(DD)                                                     \
  if (D == DD)                                                              \
    return m ? launch_d<DD, true>(keys, rel, mass, out, tile_meta,          \
                                  tile_sums, N, n_cells, prm, vec, n_tiles, \
                                  s)                                        \
             : launch_d<DD, false>(keys, rel, mass, out, tile_meta,         \
                                   tile_sums, N, n_cells, prm, vec,         \
                                   n_tiles, s);
  SEGDEP_CASE(1)
  SEGDEP_CASE(2)
  SEGDEP_CASE(3)
  SEGDEP_CASE(4)
#undef SEGDEP_CASE
  return (int)cudaErrorInvalidValue;
}

// Every __global__ function's footprint (resource_usage.cuh).
int segdep_resource_usage(int i, const char** name, int* out) {
  return fill_resource_usage(kSegdepFns,
                             (int)(sizeof(kSegdepFns) / sizeof(FnRow)), i,
                             name, out);
}

const char* segdep_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
