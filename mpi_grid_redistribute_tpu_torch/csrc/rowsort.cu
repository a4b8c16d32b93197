// Stable key-value radix sort of the scan deposit's payload rows on Hopper.
//
// Replaces no TPU kernel. The reference sorts with lax.sort((key, iota,
// payload...), num_keys=2); the port ran that as torch.sort(key,
// stable=True) and one index_select of the stacked payload [D + 1, n] by
// the sort's int64 permutation. That gather reads D + 1 planar float32
// rows at n random columns, a 32-byte sector for every 4-byte word, and
// writes a payload that kernel 5 then reads back row by row. Here each
// particle's payload travels with its key instead:
//
//   1. rowsort_pack_kernel<D> writes rows_a [n] float4 = (the D block-local
//      coordinates, then the mass; the lanes above it zero when D < 3) and
//      the key as uint32 into key_a, one coalesced pass;
//   2. cub's DeviceRadixSort::SortPairs sorts key_a with rows_a as its
//      values on a DoubleBuffer of each, over bits [0, bits) of the key only
//      (the keys lie in [0, n_segments], so the wrapper passes
//      n_segments.bit_length(): 22 bits, three 8-bit passes, in a 128^3
//      deposit over 8 vranks). The result lies in the buffers `selector`
//      names on return.
//
// One instance: uint32 keys, 16-byte float4 values. The keys are int32
// and never negative, so their unsigned order is theirs. An LSD radix sort
// keeps equal keys in input order, so the sorted keys and rows are
// bit-equal to torch.sort(stable=True) followed by index_select
// (ops/rowsort.sort_rows_plain, the route of the CPU and of the plain
// deposit). The rows are moved, never computed on: NaN payloads and signed
// zeros keep their bits.
//
// Bound: device memory bandwidth. The pack reads 4 (D + 2) bytes a row and
// writes 20; each pass of the sort reads and writes a key and its row, 40
// bytes a row, besides cub's histogram pass over the keys. At 67.1M rows and
// three passes that is ~8 GB, against the ~8.6 GB of sectors the gather
// alone moved.
//
// Nothing here allocates: the wrapper takes both buffers of each pair and
// cub's temporary storage (sized by rowsort_temp_bytes) from PyTorch's
// allocator.

#include <cuda_runtime.h>
#include <limits.h>
#include <stdint.h>

#include <algorithm>

#include <cub/device/device_radix_sort.cuh>

#include "resource_usage.cuh"

#define ROWSORT_MAX_DIMS 3  // the payload's D = 1..3: D + 1 <= 4 lanes
#define ROWSORT_PACK_THREADS 256

template <int D>
__global__ void __launch_bounds__(ROWSORT_PACK_THREADS)
    rowsort_pack_kernel(const int32_t* __restrict__ key,
                        const float* __restrict__ rel,
                        const float* __restrict__ mass, long long n,
                        uint32_t* __restrict__ key_out,
                        float4* __restrict__ rows_out) {
  const long long step = (long long)gridDim.x * ROWSORT_PACK_THREADS;
  for (long long e = (long long)blockIdx.x * ROWSORT_PACK_THREADS +
                     threadIdx.x;
       e < n; e += step) {
    float v[4] = {0.0f, 0.0f, 0.0f, 0.0f};
#pragma unroll
    for (int d = 0; d < D; ++d) v[d] = rel[d * n + e];
    v[D] = mass[e];
    rows_out[e] = make_float4(v[0], v[1], v[2], v[3]);
    key_out[e] = (uint32_t)key[e];
  }
}

static int launch_pack(int d, const int32_t* key, const float* rel,
                       const float* mass, long long n, uint32_t* key_out,
                       float4* rows_out, cudaStream_t stream) {
  const long long blocks =
      std::min((n + ROWSORT_PACK_THREADS - 1) / ROWSORT_PACK_THREADS,
               (long long)INT_MAX);
  const unsigned int grid = (unsigned int)blocks;
  if (d == 1)
    rowsort_pack_kernel<1><<<grid, ROWSORT_PACK_THREADS, 0, stream>>>(
        key, rel, mass, n, key_out, rows_out);
  else if (d == 2)
    rowsort_pack_kernel<2><<<grid, ROWSORT_PACK_THREADS, 0, stream>>>(
        key, rel, mass, n, key_out, rows_out);
  else
    rowsort_pack_kernel<3><<<grid, ROWSORT_PACK_THREADS, 0, stream>>>(
        key, rel, mass, n, key_out, rows_out);
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
    {"rowsort_pack_kernel<1>", (const void*)rowsort_pack_kernel<1>},
    {"rowsort_pack_kernel<2>", (const void*)rowsort_pack_kernel<2>},
    {"rowsort_pack_kernel<3>", (const void*)rowsort_pack_kernel<3>},
    ROWSORT_CUB_FNS};
#undef ROWSORT_CUB_FNS

static bool rowsort_shape_ok(long long n, int bits) {
  return n >= 1 && n <= INT_MAX && bits >= 1 && bits <= 32;
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

// key [n] int32 in [0, 2^bits), rel [d, n] and mass [n] float32 (row
// stride n); key_a/key_b [n] and rows_a/rows_b [n x 16 bytes] the two
// buffers of each pair, 16-byte aligned; temp the temp_bytes that
// rowsort_temp_bytes gave. Writes into *selector the buffer (0: the a's,
// 1: the b's) that holds the sorted keys and rows. Refused unless
// 1 <= n <= INT_MAX, 1 <= bits <= 32 and 1 <= d <= 3.
int rowsort_launch(const void* key, const void* rel, const void* mass, int d,
                   long long n, int bits, void* key_a, void* key_b,
                   void* rows_a, void* rows_b, void* temp,
                   unsigned long long temp_bytes, int* selector,
                   void* stream) {
  if (!rowsort_shape_ok(n, bits) || d < 1 || d > ROWSORT_MAX_DIMS)
    return (int)cudaErrorInvalidValue;
  const cudaStream_t st = (cudaStream_t)stream;
  int code = launch_pack(d, (const int32_t*)key, (const float*)rel,
                         (const float*)mass, n, (uint32_t*)key_a,
                         (float4*)rows_a, st);
  if (code != 0) return code;
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
