// Landing column scatter on Hopper: flat[:, targets[j]] = cols[:, j].
//
// Replaces the TPU kernels mpi_grid_redistribute_tpu/ops/pallas_overlay.py
// (_overlay_sorted / _overlay_sorted_i8, entry overlay_scatter_planar).
// The TPU version sorts the updates by target, splits every word into byte
// or half-word planes and places them with one-hot matrix products, because
// the TPU places single elements badly. Hopper stores single words well:
// here one thread per update writes its K words straight to their column,
// so the kernel touches only the P updated columns, never all of m.
//
// Contract (same as the TPU entry): flat is [K, m] of 32-bit words (int32
// or float32, moved as raw bits, so any pattern -- NaN payloads included --
// survives exactly), cols is [K, P], in-range targets are unique, and a
// target < 0 or >= m is dropped. Updated in place.
//
// Bound: device memory bandwidth, and in practice the scattered writes:
// each update reads 4 + 4K bytes and writes 4K bytes, but a lone 4-byte
// store costs a whole 32-byte sector. Reads of targets and cols are
// coalesced (neighbouring threads, neighbouring columns of cols).
//
// Design: at the loop's ~2% migration almost no two updates share a
// sector, so the store pattern cannot merge them. Three other designs
// were timed on the card against this one (PERF.md): a warp per 32
// updates with batched loads and evict-first stores, the grid walking
// one plane at a time, and each block's targets sorted in shared memory
// first. None was faster, in random order or inside the migrate loop,
// so the plain one-thread-per-update kernel stays.

#include <cuda_runtime.h>
#include <stdint.h>

__global__ void overlay_kernel(int32_t* __restrict__ flat,
                               const int32_t* __restrict__ targets,
                               const int32_t* __restrict__ cols, long long m,
                               long long P, int K) {
  long long j = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (j >= P) return;
  int t = targets[j];
  if (t < 0 || (long long)t >= m) return;
  for (int k = 0; k < K; ++k) flat[(long long)k * m + t] = cols[(long long)k * P + j];
}

extern "C" {

int overlay_launch(void* flat, const void* targets, const void* cols,
                   long long m, long long P, int K, void* stream) {
  if (K < 1 || m < 1 || P < 1) return (int)cudaErrorInvalidValue;
  const int threads = 256;
  long long blocks = (P + threads - 1) / threads;
  overlay_kernel<<<(unsigned int)blocks, threads, 0, (cudaStream_t)stream>>>(
      (int32_t*)flat, (const int32_t*)targets, (const int32_t*)cols, m, P, K);
  return (int)cudaGetLastError();
}

const char* overlay_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
