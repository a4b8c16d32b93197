// Stable key-value radix sort of the scan deposit's payload rows on Hopper,
// with the segment keys computed in its pack.
//
// Replaces no TPU kernel. The reference computes the keys elementwise and
// sorts with lax.sort((key, iota, payload...), num_keys=2); the port's plain
// version (ops/rowsort.sort_keyed_rows_plain) runs that keys phase as ~40
// elementwise passes of 4-12 bytes over every slot, then torch.sort(key,
// stable=True) and one index_select of the payload by the sort's int64
// permutation, which reads it at random columns, a 32-byte sector for every
// 4-byte word. Here one C entry, rowsort_keys_launch, does it in two steps:
//
//   1. rowsort_keys_kernel<D> computes each slot's key and payload from the
//      slabs' positions, in the arithmetic of the plain keys phase
//      (ops/rowsort.slab_keys_plain): per axis r = (p - lo[v]) * inv_h
//      (round-to-nearest subtract, then multiply, no FMA), +0.0 on an
//      invalid slot; the cell clip(floor(r), 0, cells - 1) (base_cell.cuh)
//      summed with the block's row-major strides; the key v * n_cells +
//      cell, or the sentinel V * n_cells on an invalid slot; the mass, +0.0
//      on an invalid slot. It writes the key as uint32 into key_a and the
//      row (the D coordinates, then the mass; the lanes above it zero when
//      D < 3) as a float4 into rows_a: 4 D + 5 bytes a slot read and 20
//      written, 37 at D = 3;
//   2. cub's DeviceRadixSort::SortPairs sorts key_a with rows_a as its
//      values on a DoubleBuffer of each, over bits [0, bits) of the key only
//      (the keys lie in [0, V * n_cells], so the wrapper passes that
//      sentinel's bit length: 22 bits, three 8-bit passes, in a 128^3
//      deposit over 8 vranks). The result lies in the buffers `selector`
//      names on return.
//
// One sort instance: uint32 keys, 16-byte float4 values. The keys are int32
// and never negative, so their unsigned order is theirs. An LSD radix sort
// keeps equal keys in input order, so the sorted keys and rows are
// bit-equal to the plain keys phase followed by torch.sort(stable=True) and
// index_select (the route of the CPU and of the plain deposit). The rows
// are moved, never computed on after the pack: NaN payloads and signed
// zeros keep their bits.
//
// Bound: device memory bandwidth. Besides the pack's 37 bytes a slot, each
// pass of the sort reads and writes a key and its row, 40 bytes a slot, and
// cub's histogram pass reads the keys: ~10.7 GB at 67.1M slots and three
// passes.
//
// Nothing here allocates: the wrapper takes both buffers of each pair and
// cub's temporary storage (sized by rowsort_temp_bytes) from PyTorch's
// allocator.

#include <cuda_runtime.h>
#include <limits.h>
#include <stdint.h>

#include <algorithm>

#include <cub/device/device_radix_sort.cuh>

#include "base_cell.cuh"
#include "resource_usage.cuh"

#define ROWSORT_MAX_DIMS 3  // the payload's D = 1..3: D + 1 <= 4 lanes
#define ROWSORT_PACK_THREADS 256

// The block of a vrank: its cells and row-major strides, axis by axis
// (unused axes 1 cell, stride 0).
struct KeyBlock {
  int cells[ROWSORT_MAX_DIMS];
  int strides[ROWSORT_MAX_DIMS];
};

// pos [D, m] float32 (row stride pos_stride), valid [m] bool, mass [m]
// float32, lo [V, D] and inv_h [D] float32; slot e belongs to vrank e / n.
// m <= INT_MAX, so a slot and its vrank fit 32 bits.
template <int D>
__global__ void __launch_bounds__(ROWSORT_PACK_THREADS)
    rowsort_keys_kernel(const float* __restrict__ pos, long long pos_stride,
                        const uint8_t* __restrict__ valid,
                        const float* __restrict__ mass,
                        const float* __restrict__ lo,
                        const float* __restrict__ inv_h, KeyBlock block,
                        unsigned int n, unsigned int n_cells,
                        unsigned int sentinel, long long m,
                        uint32_t* __restrict__ key_out,
                        float4* __restrict__ rows_out) {
  float ih[D];
#pragma unroll
  for (int d = 0; d < D; ++d) ih[d] = inv_h[d];
  const long long step = (long long)gridDim.x * ROWSORT_PACK_THREADS;
  for (long long e = (long long)blockIdx.x * ROWSORT_PACK_THREADS +
                     threadIdx.x;
       e < m; e += step) {
    const bool ok = valid[e] != 0;
    const unsigned int v = (unsigned int)e / n;
    float row[4] = {0.0f, 0.0f, 0.0f, 0.0f};
    int cell = 0;
#pragma unroll
    for (int d = 0; d < D; ++d) {
      const float r = __fmul_rn(
          __fsub_rn(pos[d * pos_stride + e], lo[(long long)v * D + d]),
          ih[d]);
      row[d] = ok ? r : 0.0f;
      cell += base_cell(row[d], block.cells[d]) * block.strides[d];
    }
    row[D] = ok ? mass[e] : 0.0f;
    rows_out[e] = make_float4(row[0], row[1], row[2], row[3]);
    key_out[e] = ok ? v * n_cells + (unsigned int)cell : sentinel;
  }
}

static int launch_keys(int d, const float* pos, long long pos_stride,
                       const uint8_t* valid, const float* mass,
                       const float* lo, const float* inv_h,
                       const KeyBlock& block, unsigned int n,
                       unsigned int n_cells, unsigned int sentinel,
                       long long m, uint32_t* key_out, float4* rows_out,
                       cudaStream_t stream) {
  const unsigned int grid = (unsigned int)std::min(
      (m + ROWSORT_PACK_THREADS - 1) / ROWSORT_PACK_THREADS,
      (long long)INT_MAX);
  if (d == 1)
    rowsort_keys_kernel<1><<<grid, ROWSORT_PACK_THREADS, 0, stream>>>(
        pos, pos_stride, valid, mass, lo, inv_h, block, n, n_cells,
        sentinel, m, key_out, rows_out);
  else if (d == 2)
    rowsort_keys_kernel<2><<<grid, ROWSORT_PACK_THREADS, 0, stream>>>(
        pos, pos_stride, valid, mass, lo, inv_h, block, n, n_cells,
        sentinel, m, key_out, rows_out);
  else
    rowsort_keys_kernel<3><<<grid, ROWSORT_PACK_THREADS, 0, stream>>>(
        pos, pos_stride, valid, mass, lo, inv_h, block, n, n_cells,
        sentinel, m, key_out, rows_out);
  return (int)cudaGetLastError();
}

// The pack's instances, and cub's kernels of the one sort instance under
// the names cub 2.8's dispatch instantiates them (uint32 keys, float4
// values, a 32-bit item count). Another cub lists the pack alone, and the
// card's checks of this table fail on that (test_torch_cuda's
// test_sort_rows_resource_usage_lists_cub_kernels, chip_smoke.py's
// payload-sort phase) until the names here are those of its dispatch.
#if CUB_VERSION >= 200800 && CUB_VERSION < 200900
namespace rowsort_cub {
using Policy =
    cub::detail::radix::policy_hub<uint32_t, float4, uint32_t>::MaxPolicy;
using Dec = cub::detail::identity_decomposer_t;
}  // namespace rowsort_cub
#define ROWSORT_CUB_FNS                                                     \
  {"cub::DeviceRadixSortHistogramKernel",                                   \
   (const void*)cub::DeviceRadixSortHistogramKernel<                        \
       rowsort_cub::Policy, false, uint32_t, uint32_t, rowsort_cub::Dec>},  \
      {"cub::DeviceRadixSortExclusiveSumKernel",                            \
       (const void*)cub::DeviceRadixSortExclusiveSumKernel<                 \
           rowsort_cub::Policy, uint32_t>},                                 \
      {"cub::DeviceRadixSortOnesweepKernel",                                \
       (const void*)cub::DeviceRadixSortOnesweepKernel<                     \
           rowsort_cub::Policy, false, uint32_t, float4, uint32_t, int, int, \
           rowsort_cub::Dec>},                                              \
      {"cub::DeviceRadixSortSingleTileKernel",                              \
       (const void*)cub::DeviceRadixSortSingleTileKernel<                   \
           rowsort_cub::Policy, false, uint32_t, float4, uint32_t,          \
           rowsort_cub::Dec>},
#else
#define ROWSORT_CUB_FNS
#endif
static const FnRow kRowsortFns[] = {
    {"rowsort_keys_kernel<1>", (const void*)rowsort_keys_kernel<1>},
    {"rowsort_keys_kernel<2>", (const void*)rowsort_keys_kernel<2>},
    {"rowsort_keys_kernel<3>", (const void*)rowsort_keys_kernel<3>},
    ROWSORT_CUB_FNS};
#undef ROWSORT_CUB_FNS

static bool rowsort_shape_ok(long long n, int bits) {
  return n >= 1 && n <= INT_MAX && bits >= 1 && bits <= 32;
}

// cub's sort of the packed pair (key_a, rows_a), the b's its alternates.
static int rowsort_sort(void* key_a, void* key_b, void* rows_a, void* rows_b,
                        long long n, int bits, void* temp,
                        unsigned long long temp_bytes, int* selector,
                        cudaStream_t st) {
  cub::DoubleBuffer<uint32_t> keys((uint32_t*)key_a, (uint32_t*)key_b);
  cub::DoubleBuffer<float4> rows((float4*)rows_a, (float4*)rows_b);
  size_t tb = (size_t)temp_bytes;
  const cudaError_t err = cub::DeviceRadixSort::SortPairs(
      temp, tb, keys, rows, (int)n, 0, bits, st);
  if (err != cudaSuccess) return (int)err;
  if (keys.selector != rows.selector) return (int)cudaErrorUnknown;
  *selector = keys.selector;
  return (int)cudaGetLastError();
}

extern "C" {

// cub's temporary bytes for n rows sorted over `bits` key bits.
int rowsort_temp_bytes(long long n, int bits, unsigned long long* bytes) {
  if (!rowsort_shape_ok(n, bits)) return (int)cudaErrorInvalidValue;
  cub::DoubleBuffer<uint32_t> keys(nullptr, nullptr);
  cub::DoubleBuffer<float4> rows(nullptr, nullptr);
  size_t b = 0;
  const cudaError_t err = cub::DeviceRadixSort::SortPairs(
      nullptr, b, keys, rows, (int)n, 0, bits);
  *bytes = (unsigned long long)b;
  return (int)err;
}

// pos [d, vranks * n] float32 (row stride pos_stride), valid [vranks * n]
// bool, mass [vranks * n] float32, lo [vranks, d] and inv_h [d] float32;
// cells[0..d) the block of a vrank. Packs the keys in [0, vranks * n_cells]
// and the rows (rowsort_keys_kernel) into key_a and rows_a, then sorts them
// (cub) and writes into *selector the buffer (0: the a's, 1: the b's) that
// holds the sorted keys and rows. key_a/key_b [vranks * n] and
// rows_a/rows_b [vranks * n x 16 bytes] are the two buffers of each pair,
// 16-byte aligned; temp the temp_bytes that rowsort_temp_bytes gave.
// Refused unless 1 <= d <= 3, every cell count >= 1, vranks * n in
// [1, INT_MAX], the sentinel vranks * n_cells at most INT_MAX and below
// 2^bits, and 1 <= bits <= 32.
int rowsort_keys_launch(const void* pos, long long pos_stride,
                        const void* valid, const void* mass, const void* lo,
                        const void* inv_h, int d, const int* cells,
                        long long vranks, long long n, int bits, void* key_a,
                        void* key_b, void* rows_a, void* rows_b, void* temp,
                        unsigned long long temp_bytes, int* selector,
                        void* stream) {
  if (d < 1 || d > ROWSORT_MAX_DIMS || vranks < 1 || n < 1 ||
      !rowsort_shape_ok(vranks * n, bits))
    return (int)cudaErrorInvalidValue;
  KeyBlock block;
  long long n_cells = 1;
  for (int a = ROWSORT_MAX_DIMS - 1; a >= 0; --a) {
    block.cells[a] = a < d ? cells[a] : 1;
    block.strides[a] = a < d ? (int)n_cells : 0;
    if (block.cells[a] < 1) return (int)cudaErrorInvalidValue;
    n_cells *= block.cells[a];
    if (n_cells > INT_MAX) return (int)cudaErrorInvalidValue;
  }
  const long long sentinel = vranks * n_cells;  // the keys are int32
  if (sentinel > INT_MAX || (sentinel >> bits) != 0)
    return (int)cudaErrorInvalidValue;
  const cudaStream_t st = (cudaStream_t)stream;
  const long long m = vranks * n;
  const int code = launch_keys(
      d, (const float*)pos, pos_stride, (const uint8_t*)valid,
      (const float*)mass, (const float*)lo, (const float*)inv_h, block,
      (unsigned int)n, (unsigned int)n_cells, (unsigned int)sentinel, m,
      (uint32_t*)key_a, (float4*)rows_a, st);
  if (code != 0) return code;
  return rowsort_sort(key_a, key_b, rows_a, rows_b, m, bits, temp,
                      temp_bytes, selector, st);
}

// The pack's and the sort's __global__ functions (resource_usage.cuh).
int rowsort_resource_usage(int i, const char** name, int* out) {
  return fill_resource_usage(kRowsortFns,
                             (int)(sizeof(kRowsortFns) / sizeof(FnRow)), i,
                             name, out);
}

const char* rowsort_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
