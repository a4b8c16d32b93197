// Row scatter on Hopper: flat[targets[j], :] = rows[j, :].
//
// Replaces the TPU kernel mpi_grid_redistribute_tpu/ops/pallas_scatter.py
// (_scatter_sorted, entry scatter_rows). The TPU version sorts the
// arrivals, lays them out transposed as [8, P] for lane-aligned DMAs and
// streams the whole destination through VMEM in 8192-row blocks, because
// Mosaic cannot store a row at a dynamic address. Hopper can: one thread
// per (arrival, word) pair writes flat[t_j * K + c] = rows[j * K + c] in
// place, so the kernel touches only the arrivals' rows, never all n_rows.
// No sort: in-range targets are unique (the migrate plan's contract), so
// the order of the arrivals does not change the result.
//
// Contract (the TPU entry's, at every shape): flat is a row-major
// [n_rows, K] array of words of 1, 2, 4 or 8 bytes, rows is [P, K] of the
// same words, targets is int32 [P]; a target < 0 or >= n_rows is dropped.
// Words move as raw integers, so every bit pattern (NaN payloads, inf,
// denormals) survives exactly.
//
// Bound: device memory bandwidth. Each arrival reads 4 + K * w bytes and
// writes K * w; neighbouring threads read neighbouring words of rows and
// write neighbouring words of one destination row, so an arrival's row
// goes out in one or two 32-byte sectors.

#include <cuda_runtime.h>
#include <stdint.h>

template <typename W>
__global__ void scatter_rows_kernel(W* __restrict__ flat,
                                    const int32_t* __restrict__ targets,
                                    const W* __restrict__ rows,
                                    long long n_rows, long long P,
                                    long long K) {
  const long long total = P * K;
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
       i < total; i += stride) {
    const long long j = i / K;
    const long long c = i - j * K;
    const long long t = targets[j];
    if (t < 0 || t >= n_rows) continue;
    flat[t * K + c] = rows[i];
  }
}

template <typename W>
static int launch(void* flat, const void* targets, const void* rows,
                  long long n_rows, long long P, long long K,
                  cudaStream_t stream) {
  const int threads = 256;
  long long blocks = (P * K + threads - 1) / threads;
  if (blocks > 65536LL * 32) blocks = 65536LL * 32;  // grid-stride beyond
  scatter_rows_kernel<W><<<(unsigned int)blocks, threads, 0, stream>>>(
      (W*)flat, (const int32_t*)targets, (const W*)rows, n_rows, P, K);
  return (int)cudaGetLastError();
}

extern "C" {

int scatter_launch(void* flat, const void* targets, const void* rows,
                   long long n_rows, long long P, long long K, int word_bytes,
                   void* stream) {
  if (n_rows < 1 || P < 1 || K < 1) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  switch (word_bytes) {
    case 1: return launch<uint8_t>(flat, targets, rows, n_rows, P, K, s);
    case 2: return launch<uint16_t>(flat, targets, rows, n_rows, P, K, s);
    case 4: return launch<uint32_t>(flat, targets, rows, n_rows, P, K, s);
    case 8: return launch<unsigned long long>(flat, targets, rows, n_rows, P,
                                              K, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

const char* scatter_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
