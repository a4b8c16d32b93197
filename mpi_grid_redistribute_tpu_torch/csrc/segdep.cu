// Segmented CIC deposit on Hopper: per-cell sums of the 2^D corner
// weights of a cell-sorted particle stream.
//
// Replaces the TPU kernel mpi_grid_redistribute_tpu/ops/pallas_segdep.py
// (_kernel / _segsum_tpu, entry segsum_sorted). Input: keys [N] int32,
// cell-sorted so that every valid key forms ONE contiguous run (a globally
// sorted stream, or per-slab sorts concatenated with sentinel runs at the
// slab tails), sentinel n_cells = invalid row; rel [D, N] block-local
// coordinates and mass [N] (or none: unit mass, nothing read) in the same
// order. Output: out [2^D, n_cells] float32, out[c, k] = the sum over the
// rows of key k of corner c's CIC weight. Keys outside [0, n_cells) are
// dropped.
//
// The TPU design (one-hot [T, 128] matrix products into a VMEM chunk
// accumulator) exists because the TPU cannot scatter; none of it carries
// over. Here:
//   1. one thread per row builds its 2^D corner weights in registers, in
//      _corner_weights' operation order (float clip-floor fracs, left-fold
//      product, mass multiplied last), each multiply and add an explicit
//      round-to-nearest intrinsic so nothing contracts into an FMA;
//   2. a block of 256 rows reduces its equal-key runs in stream order with
//      a segmented inclusive scan (warp shuffles, then the 8 warp totals
//      through shared memory); the row that ends a run holds its sum;
//   3. a run that starts and ends inside the block is stored with a plain
//      write; the block's first and last runs, which may continue across
//      the block's edges, go to a small carry buffer, and a second pass
//      (one thread per block) adds each run that crosses blocks in block
//      order and writes it once;
//   4. cells with no rows read 0 from a cudaMemsetAsync of the output.
// No float atomics: the summation order is fixed, so results are
// bit-reproducible from run to run.
//
// Bound: device memory bandwidth -- per row it reads 4 + 4D (+ 4 with
// mass) bytes, and the output is written once, 2^D * 4 bytes per cell;
// the weight arithmetic (~8 operations per corner) is far below the
// card's float32 rate.

#include <cuda_runtime.h>
#include <limits.h>
#include <stdint.h>

#define SEGDEP_MAX_D 3
#define SEGDEP_MAX_CH (1 << SEGDEP_MAX_D)
#define SEGDEP_BLOCK 256
#define SEGDEP_WARPS (SEGDEP_BLOCK / 32)
#define FULL_MASK 0xffffffffu

struct SegdepParams {
  float vmax[SEGDEP_MAX_D];  // float(vblock[d] - 1), the clip of floor(r)
};

// carry_meta[b] = (key of the block's first row, key of its last row,
// 1 if one run covers the whole block)
struct CarryMeta {
  int head_key, tail_key, single;
};

// jnp.clip / torch.clamp: max with lo, then min with hi; NaN passes
__device__ __forceinline__ float clip_f(float x, float lo, float hi) {
  x = (x < lo) ? lo : x;
  return (x > hi) ? hi : x;
}

__global__ void segdep_block_kernel(const int32_t* __restrict__ keys,
                                    const float* __restrict__ rel,
                                    const float* __restrict__ mass,
                                    float* __restrict__ out,
                                    float* __restrict__ carry_sum,
                                    CarryMeta* __restrict__ carry_meta,
                                    long long N, int n_cells, int D,
                                    SegdepParams prm) {
  __shared__ float s_wsum[SEGDEP_WARPS][SEGDEP_MAX_CH];
  __shared__ int s_wflag[SEGDEP_WARPS];
  __shared__ float s_wpre[SEGDEP_WARPS][SEGDEP_MAX_CH];
  __shared__ int s_first_break, s_last_break;

  const int nch = 1 << D;
  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
  const long long start = (long long)blockIdx.x * SEGDEP_BLOCK;
  const long long rem = N - start;
  const int count = rem < SEGDEP_BLOCK ? (int)rem : SEGDEP_BLOCK;
  const bool valid = t < count;
  const long long i = start + t;

  if (t == 0) {
    s_first_break = count;  // first run boundary after row 0 of the block
    s_last_break = 0;       // start of the block's last run
  }
  __syncthreads();

  const int key = valid ? keys[i] : INT_MIN;
  // a run head inside the block: row 0, or a key change (rows past the
  // end are heads too, so they never add into a real run)
  const bool head = !valid || t == 0 || keys[i - 1] != key;
  if (valid && t > 0 && head) {
    atomicMin(&s_first_break, t);
    atomicMax(&s_last_break, t);
  }

  // ---- corner weights (pallas_segdep._corner_weights order) -----------
  float w[SEGDEP_MAX_CH];
#pragma unroll
  for (int c = 0; c < SEGDEP_MAX_CH; ++c) w[c] = 0.0f;
  if (valid) {
    float frac[SEGDEP_MAX_D];
#pragma unroll
    for (int d = 0; d < SEGDEP_MAX_D; ++d) {
      if (d < D) {
        float r = rel[(long long)d * N + i];
        float i0 = clip_f(floorf(r), 0.0f, prm.vmax[d]);
        frac[d] = clip_f(__fsub_rn(r, i0), 0.0f, 1.0f);
      }
    }
    const float m = mass ? mass[i] : 1.0f;
#pragma unroll
    for (int c = 0; c < SEGDEP_MAX_CH; ++c) {
      if (c < nch) {
        float wc = 0.0f;
#pragma unroll
        for (int d = 0; d < SEGDEP_MAX_D; ++d) {
          if (d < D) {
            // itertools.product order: axis 0 is the most significant bit
            const int bit = (c >> (D - 1 - d)) & 1;
            const float tt = bit ? frac[d] : __fsub_rn(1.0f, frac[d]);
            wc = (d == 0) ? tt : __fmul_rn(wc, tt);
          }
        }
        w[c] = mass ? __fmul_rn(m, wc) : wc;
      }
    }
  }

  // ---- segmented inclusive scan within each warp ----------------------
  // (v, f) combine: left (lv, lf) then right (v, f) -> f ? v : lv + v
  int f = head ? 1 : 0;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const int of = __shfl_up_sync(FULL_MASK, f, off);
#pragma unroll
    for (int c = 0; c < SEGDEP_MAX_CH; ++c) {
      if (c < nch) {
        const float ov = __shfl_up_sync(FULL_MASK, w[c], off);
        if (lane >= off && !f) w[c] = __fadd_rn(ov, w[c]);
      }
    }
    if (lane >= off) f |= of;
  }
  if (lane == 31) {
    s_wflag[warp] = f;
#pragma unroll
    for (int c = 0; c < SEGDEP_MAX_CH; ++c)
      if (c < nch) s_wsum[warp][c] = w[c];
  }
  __syncthreads();

  // ---- exclusive carry into each warp, warps in order -----------------
  if (t == 0) {
    float acc[SEGDEP_MAX_CH];
#pragma unroll
    for (int c = 0; c < SEGDEP_MAX_CH; ++c) acc[c] = 0.0f;
    for (int wi = 0; wi < SEGDEP_WARPS; ++wi) {
#pragma unroll
      for (int c = 0; c < SEGDEP_MAX_CH; ++c) {
        if (c < nch) {
          s_wpre[wi][c] = acc[c];
          // warp 0 always holds a head (row 0), so acc starts as its total
          acc[c] = s_wflag[wi] ? s_wsum[wi][c]
                               : __fadd_rn(acc[c], s_wsum[wi][c]);
        }
      }
    }
  }
  __syncthreads();
  if (warp > 0 && !f) {
#pragma unroll
    for (int c = 0; c < SEGDEP_MAX_CH; ++c)
      if (c < nch) w[c] = __fadd_rn(s_wpre[warp][c], w[c]);
  }

  // ---- store the runs that end here -----------------------------------
  if (!valid) return;
  const bool last_row = t == count - 1;
  const bool run_end = last_row || keys[i + 1] != key;
  if (!run_end) return;
  const int first_break = s_first_break;
  const bool in_head_run = t < first_break;
  const bool in_tail_run = t >= s_last_break;
  const bool cont_prev = start > 0 && keys[start - 1] == keys[start];
  const bool cont_next = last_row && i + 1 < N && keys[i + 1] == key;
  if (t == first_break - 1) {  // the block's first run
#pragma unroll
    for (int c = 0; c < SEGDEP_MAX_CH; ++c)
      if (c < nch) carry_sum[(long long)blockIdx.x * 2 * nch + c] = w[c];
  }
  if (last_row) {  // the block's last run
#pragma unroll
    for (int c = 0; c < SEGDEP_MAX_CH; ++c)
      if (c < nch) carry_sum[(long long)blockIdx.x * 2 * nch + nch + c] = w[c];
    CarryMeta meta;
    meta.head_key = keys[start];
    meta.tail_key = key;
    meta.single = first_break == count;
    carry_meta[blockIdx.x] = meta;
  }
  if ((in_head_run && cont_prev) || (in_tail_run && cont_next)) return;
  if (key < 0 || key >= n_cells) return;
#pragma unroll
  for (int c = 0; c < SEGDEP_MAX_CH; ++c)
    if (c < nch) out[(long long)c * n_cells + key] = w[c];
}

// One thread per block b: if b's last run continues into b + 1 and began
// in b, add the partial sums of the blocks it spans, in block order, and
// write the run once.
__global__ void segdep_carry_kernel(const float* __restrict__ carry_sum,
                                    const CarryMeta* __restrict__ carry_meta,
                                    float* __restrict__ out, long long nb,
                                    int n_cells, int nch) {
  const long long b = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (b + 1 >= nb) return;
  const CarryMeta mb = carry_meta[b];
  const int key = mb.tail_key;
  if (key < 0 || key >= n_cells) return;
  if (carry_meta[b + 1].head_key != key) return;  // ends inside b
  if (mb.single && b > 0 && carry_meta[b - 1].tail_key == key)
    return;  // began in an earlier block, whose thread writes it
  float acc[SEGDEP_MAX_CH];
#pragma unroll
  for (int c = 0; c < SEGDEP_MAX_CH; ++c)
    if (c < nch) acc[c] = carry_sum[b * 2 * nch + nch + c];
  long long k = b + 1;
  while (true) {
#pragma unroll
    for (int c = 0; c < SEGDEP_MAX_CH; ++c)
      if (c < nch) acc[c] = __fadd_rn(acc[c], carry_sum[k * 2 * nch + c]);
    if (carry_meta[k].single && k + 1 < nb &&
        carry_meta[k + 1].head_key == key) {
      ++k;
    } else {
      break;
    }
  }
#pragma unroll
  for (int c = 0; c < SEGDEP_MAX_CH; ++c)
    if (c < nch) out[(long long)c * n_cells + key] = acc[c];
}

extern "C" {

// carry_sum: float [nb, 2 * 2^D], carry_meta: int32 [nb, 3] scratch with
// nb = ceil(N / 256); vmax: host float [D]; mass may be NULL (unit mass).
int segdep_launch(const void* keys, const void* rel, const void* mass,
                  void* out, void* carry_sum, void* carry_meta, long long N,
                  int n_cells, int D, const float* vmax, void* stream) {
  if (D < 1 || D > SEGDEP_MAX_D || N < 1 || n_cells < 1)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  const int nch = 1 << D;
  cudaError_t err = cudaMemsetAsync(
      out, 0, (size_t)nch * (size_t)n_cells * sizeof(float), s);
  if (err != cudaSuccess) return (int)err;
  SegdepParams prm;
  for (int d = 0; d < SEGDEP_MAX_D; ++d) prm.vmax[d] = d < D ? vmax[d] : 0.0f;
  const long long nb = (N + SEGDEP_BLOCK - 1) / SEGDEP_BLOCK;
  if (nb > 2147483647LL) return (int)cudaErrorInvalidValue;
  segdep_block_kernel<<<(unsigned int)nb, SEGDEP_BLOCK, 0, s>>>(
      (const int32_t*)keys, (const float*)rel, (const float*)mass,
      (float*)out, (float*)carry_sum, (CarryMeta*)carry_meta, N, n_cells, D,
      prm);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const int threads = 256;
  const long long blocks = (nb + threads - 1) / threads;
  segdep_carry_kernel<<<(unsigned int)blocks, threads, 0, s>>>(
      (const float*)carry_sum, (const CarryMeta*)carry_meta, (float*)out, nb,
      n_cells, nch);
  return (int)cudaGetLastError();
}

const char* segdep_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
