// Row scatter on Hopper: flat[targets[j], :] = rows[j, :].
//
// Replaces the TPU kernel mpi_grid_redistribute_tpu/ops/pallas_scatter.py
// (_scatter_sorted, entry scatter_rows). The TPU version sorts the
// arrivals, lays them out transposed as [8, P] for lane-aligned DMAs and
// streams the whole destination through VMEM in 8192-row blocks, because
// Mosaic cannot store a row at a dynamic address. Hopper can: each row is
// written in place, so the kernel touches only the arrivals' rows, never
// all n_rows. No sort: in-range targets are unique (the migrate plan's
// contract), so the order of the arrivals does not change the result.
//
// Contract (the TPU entry's, at every shape): flat is a row-major
// [n_rows, K] array of words of 1, 2, 4 or 8 bytes, rows is [P, K] of the
// same words, targets is int32 [P]; a target < 0 or >= n_rows is dropped.
// Words move as raw integers, so every bit pattern (NaN payloads, inf,
// denormals) survives exactly.
//
// Bound: device memory bandwidth. Each arrival reads its 4-byte target,
// and an in-range one reads and writes K words.
//
// Design: a warp per 32 arrivals. Lane l loads targets[32w + l] once
// (one coalesced load); a warp whose 32 targets are all dropped exits
// there. The warp then walks its 32 * K words of rows in 32-word strides:
// word q = 32c + l belongs to row j = q / K, column q - jK, and takes its
// target from lane j by a shuffle, so no target is read twice. K is a
// template parameter for 1..8 (the division becomes a multiply-shift, and
// each lane issues all its K loads before its first store) and a runtime
// value above 8. Neighbouring lanes read neighbouring words of
// rows and write neighbouring words of one destination row, so a row goes
// out in one or two 32-byte sectors; dropped rows are never read. Index
// math is 32-bit wherever n_rows * K and P * K fit in an int32 (the host
// chooses, ops/scatter.index_bits) and 64-bit otherwise.

#include <cuda_runtime.h>
#include <stdint.h>
#include "resource_usage.cuh"

#define SCATTER_WARPS 8  // warps per block

// KT > 0: K known at compile time; KT == 0: K = k_rt. I: unsigned index
// type (uint32_t on the 32-bit path, unsigned long long on the 64-bit one)
template <typename W, int KT, typename I>
__global__ void __launch_bounds__(SCATTER_WARPS * 32)
    scatter_rows_kernel(W* __restrict__ flat,
                        const int32_t* __restrict__ targets,
                        const W* __restrict__ rows, long long n_rows,
                        long long P, int k_rt) {
  const I K = KT > 0 ? (I)KT : (I)k_rt;
  const int lane = threadIdx.x & 31;
  const I base = ((I)blockIdx.x * SCATTER_WARPS + (threadIdx.x >> 5)) * 32;
  if (base >= (I)P) return;  // warp-uniform
  const I j = base + lane;
  const int32_t t = j < (I)P ? targets[j] : -1;
  const bool ok = t >= 0 && (long long)t < n_rows;
  const unsigned live = __ballot_sync(0xffffffffu, ok);
  if (live == 0) return;  // all 32 dropped: rows never read

  const I n_here = (I)P - base < 32 ? (I)P - base : 32;
  const I words = n_here * K;
  const W* src = rows + base * K;
  if constexpr (KT > 0) {
    // all K loads of the lane in flight before the first store
    W v[KT];
#pragma unroll
    for (int it = 0; it < KT; ++it) {
      const I q = (I)it * 32 + lane;
      if (q < words && ((live >> (q / K)) & 1u)) v[it] = src[q];
    }
#pragma unroll
    for (int it = 0; it < KT; ++it) {
      const I q = (I)it * 32 + lane;
      const I r = q / K;
      const int32_t tr = __shfl_sync(0xffffffffu, t, (int)(r & 31));
      if (q < words && ((live >> r) & 1u)) flat[(I)tr * K + (q - r * K)] = v[it];
    }
  } else {
    for (I q0 = 0; q0 < words; q0 += 32) {  // warp-uniform trip count
      const I q = q0 + lane;
      const I r = q / K;
      const int32_t tr = __shfl_sync(0xffffffffu, t, (int)(r & 31));
      if (q < words && ((live >> (r & 31)) & 1u))
        flat[(I)tr * K + (q - r * K)] = src[q];
    }
  }
}

template <typename W, int KT, typename I>
static int launch_k(void* flat, const void* targets, const void* rows,
                    long long n_rows, long long P, int K,
                    cudaStream_t stream) {
  const long long warps = (P + 31) / 32;
  const long long blocks = (warps + SCATTER_WARPS - 1) / SCATTER_WARPS;
  if (blocks > 2147483647LL) return (int)cudaErrorInvalidValue;
  scatter_rows_kernel<W, KT, I>
      <<<(unsigned int)blocks, SCATTER_WARPS * 32, 0, stream>>>(
          (W*)flat, (const int32_t*)targets, (const W*)rows, n_rows, P, K);
  return (int)cudaGetLastError();
}

template <typename W, typename I>
static int launch_w(void* flat, const void* targets, const void* rows,
                    long long n_rows, long long P, int K,
                    cudaStream_t s) {
  switch (K) {
    case 1: return launch_k<W, 1, I>(flat, targets, rows, n_rows, P, K, s);
    case 2: return launch_k<W, 2, I>(flat, targets, rows, n_rows, P, K, s);
    case 3: return launch_k<W, 3, I>(flat, targets, rows, n_rows, P, K, s);
    case 4: return launch_k<W, 4, I>(flat, targets, rows, n_rows, P, K, s);
    case 5: return launch_k<W, 5, I>(flat, targets, rows, n_rows, P, K, s);
    case 6: return launch_k<W, 6, I>(flat, targets, rows, n_rows, P, K, s);
    case 7: return launch_k<W, 7, I>(flat, targets, rows, n_rows, P, K, s);
    case 8: return launch_k<W, 8, I>(flat, targets, rows, n_rows, P, K, s);
    default: return launch_k<W, 0, I>(flat, targets, rows, n_rows, P, K, s);
  }
}

template <typename I>
static int launch_i(void* flat, const void* targets, const void* rows,
                    long long n_rows, long long P, int K, int word_bytes,
                    cudaStream_t s) {
  switch (word_bytes) {
    case 1: return launch_w<uint8_t, I>(flat, targets, rows, n_rows, P, K, s);
    case 2: return launch_w<uint16_t, I>(flat, targets, rows, n_rows, P, K, s);
    case 4: return launch_w<uint32_t, I>(flat, targets, rows, n_rows, P, K, s);
    case 8:
      return launch_w<unsigned long long, I>(flat, targets, rows, n_rows, P,
                                             K, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

// every instance launch_i/launch_w/launch_k can pick: word type W, K known
// at compile time (1..8) or not (0), index type I
#define SCATTER_ROW(W, KT, I)                                     \
  {"scatter_rows_kernel<" #W "," #KT "," #I ">",                  \
   (const void*)scatter_rows_kernel<W, KT, I>}
#define SCATTER_KS(W, I)                                          \
  SCATTER_ROW(W, 0, I), SCATTER_ROW(W, 1, I), SCATTER_ROW(W, 2, I), \
      SCATTER_ROW(W, 3, I), SCATTER_ROW(W, 4, I), SCATTER_ROW(W, 5, I), \
      SCATTER_ROW(W, 6, I), SCATTER_ROW(W, 7, I), SCATTER_ROW(W, 8, I)
#define SCATTER_WS(I)                                             \
  SCATTER_KS(uint8_t, I), SCATTER_KS(uint16_t, I), SCATTER_KS(uint32_t, I), \
      SCATTER_KS(unsigned long long, I)
static const FnRow kScatterFns[] = {SCATTER_WS(uint32_t),
                                    SCATTER_WS(unsigned long long)};
#undef SCATTER_WS
#undef SCATTER_KS
#undef SCATTER_ROW

extern "C" {

// index_bits: 32 or 64, as ops/scatter.index_bits chose it; 32 is refused
// where n_rows * K or P * K does not fit in an int32
int scatter_launch(void* flat, const void* targets, const void* rows,
                   long long n_rows, long long P, long long K, int word_bytes,
                   int index_bits, void* stream) {
  const long long i32max = 2147483647LL;
  if (n_rows < 1 || n_rows > i32max || P < 1 || K < 1 || K > i32max)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (index_bits == 32) {
    if (n_rows * K > i32max || P * K > i32max)
      return (int)cudaErrorInvalidValue;
    return launch_i<uint32_t>(flat, targets, rows, n_rows, P, (int)K,
                              word_bytes, s);
  }
  if (index_bits == 64)
    return launch_i<unsigned long long>(flat, targets, rows, n_rows, P,
                                        (int)K, word_bytes, s);
  return (int)cudaErrorInvalidValue;
}

// Every __global__ function's footprint (resource_usage.cuh).
int scatter_resource_usage(int i, const char** name, int* out) {
  return fill_resource_usage(kScatterFns,
                             (int)(sizeof(kScatterFns) / sizeof(FnRow)), i,
                             name, out);
}

const char* scatter_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
