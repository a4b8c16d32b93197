// The card's footprint of a source's __global__ functions, for
// analysis/kernelcheck.py's K003: each source lists its functions (every
// template instance its launcher can pick) in a FnRow table and exports
// <stem>_resource_usage(i, &name, out) over it.
//
// out[0] registers a thread, out[1] static shared bytes a block, out[2]
// local (spill) bytes a thread, out[3] the most threads a block can have,
// out[4] the SM version the binary was built for (90 for sm_90a), all
// from cudaFuncGetAttributes. Past the last function *name is NULL and
// the call returns cudaErrorInvalidValue, which ends the caller's loop.

#pragma once

#include <cuda_runtime.h>

struct FnRow {
  const char* name;
  const void* fn;
};

static inline int fill_resource_usage(const FnRow* rows, int n, int i,
                                      const char** name, int* out) {
  if (i < 0 || i >= n) {
    *name = nullptr;
    return (int)cudaErrorInvalidValue;
  }
  *name = rows[i].name;
  cudaFuncAttributes a;
  cudaError_t err = cudaFuncGetAttributes(&a, rows[i].fn);
  if (err != cudaSuccess) return (int)err;
  out[0] = a.numRegs;
  out[1] = (int)a.sharedSizeBytes;
  out[2] = (int)a.localSizeBytes;
  out[3] = a.maxThreadsPerBlock;
  out[4] = a.binaryVersion;
  return 0;
}
