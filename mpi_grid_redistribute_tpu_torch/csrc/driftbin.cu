// Fused drift + periodic wrap + destination binning on Hopper.
//
// Replaces the TPU kernel mpi_grid_redistribute_tpu/ops/pallas_driftbin.py
// (_kernel / _driftbin_call, entry drift_wrap_bin): one streaming pass over
// the planar int32 state [K, m] (m = V * n columns; position rows first,
// then velocity rows, alive row last), which
//   * drifts p + v * dt on the float32 view of the position rows,
//   * wraps each periodic axis twice (the drift wrap, then the engine's
//     binning wrap -- an identity for lo == 0, replicated for bit equality),
//   * bins by floor-multiply + clip + stride into the full vrank grid,
//   * writes the D position rows IN PLACE and the [V, n] destination key
//     (the sentinel R_total on stayers and holes).
// In place is the counterpart of the TPU call's input_output_aliases={0: 0}:
// the velocity and alive rows are never rewritten, so no full-state copy.
//
// Bound: device memory bandwidth. Per column it reads 2D + 1 words and
// writes D + 1 (28 B + 16 B at D = 3); one thread per column, neighbouring
// threads on neighbouring addresses of each row, so every access is
// coalesced. The vrank id is col / n, so any n works and the ragged last
// block is masked.
//
// Arithmetic conventions, pinned to the reference:
//   * no FMA: every multiply and add is an explicit round-to-nearest
//     intrinsic (nvcc would otherwise contract p + v * dt), which is the
//     TPU's unfused convention;
//   * power-of-two periodic extents take the reciprocal-multiply remainder
//     of binning.remainder_fast; other extents take jnp.remainder's
//     semantics (fmod plus the sign fix);
//   * float -> int32 saturates like XLA (NaN -> 0, out of range -> the
//     int32 ends) before the clip to [0, g - 1].

#include <cuda_runtime.h>
#include <stdint.h>
#include <limits.h>
#include "resource_usage.cuh"

#define DRIFTBIN_MAX_D 8

struct AxisConsts {
  float lo, ext, hi, inv_ext, inv_w;
  int periodic, pow2, shape, stride;
};

struct DriftbinParams {
  AxisConsts ax[DRIFTBIN_MAX_D];
};

__device__ __forceinline__ float wrap_axis(float p, const AxisConsts& a) {
  float q = __fsub_rn(p, a.lo);
  float r;
  if (a.pow2) {
    r = __fsub_rn(q, __fmul_rn(floorf(__fmul_rn(q, a.inv_ext)), a.ext));
    if (r < 0.0f || r >= a.ext) r = 0.0f;
  } else {
    r = fmodf(q, a.ext);
    if (r != 0.0f && ((r < 0.0f) != (a.ext < 0.0f))) r = __fadd_rn(r, a.ext);
  }
  // the reference's XLA folds `0 + r` to `r`: skipping the add at lo == 0
  // keeps an fmod result of -0.0 negative, as there
  float w = (a.lo == 0.0f) ? r : __fadd_rn(a.lo, r);
  return (w >= a.hi) ? a.lo : w;
}

__device__ __forceinline__ int floor_to_int32_sat(float x) {
  float f = floorf(x);
  if (f != f) return 0;
  if (f >= 2147483648.0f) return INT_MAX;
  if (f < -2147483648.0f) return INT_MIN;
  return (int)f;
}

__global__ void driftbin_kernel(int32_t* __restrict__ flat,
                                int32_t* __restrict__ key, long long m,
                                long long n, int K, int D, float dt,
                                int R_total, DriftbinParams prm) {
  long long col = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (col >= m) return;
  int v = (int)(col / n);
  int dv = 0;
  for (int d = 0; d < D; ++d) {
    const AxisConsts& a = prm.ax[d];
    float p = __int_as_float(flat[(long long)d * m + col]);
    float vel = __int_as_float(flat[(long long)(D + d) * m + col]);
    p = __fadd_rn(p, __fmul_rn(vel, dt));
    float pb = p;
    if (a.periodic) {
      p = wrap_axis(p, a);
      pb = wrap_axis(p, a);
    }
    flat[(long long)d * m + col] = __float_as_int(p);
    int c = floor_to_int32_sat(__fmul_rn(__fsub_rn(pb, a.lo), a.inv_w));
    c = min(max(c, 0), a.shape - 1);
    dv += c * a.stride;
  }
  bool alive = flat[(long long)(K - 1) * m + col] > 0;
  key[col] = (alive && dv != v) ? dv : R_total;
}

static const FnRow kDriftbinFns[] = {
    {"driftbin_kernel", (const void*)driftbin_kernel},
};

extern "C" {

// fconsts: D x (lo, ext, hi, inv_ext, inv_w); iconsts: D x (periodic, pow2,
// shape, stride) -- host arrays, copied into the kernel's parameters.
int driftbin_launch(void* flat, void* key, long long m, long long n, int K,
                    int D, float dt, int R_total, const float* fconsts,
                    const int* iconsts, void* stream) {
  if (D < 1 || D > DRIFTBIN_MAX_D || K < 2 * D + 1 || n < 1 || m < 1)
    return (int)cudaErrorInvalidValue;
  DriftbinParams prm;
  for (int d = 0; d < D; ++d) {
    prm.ax[d].lo = fconsts[5 * d + 0];
    prm.ax[d].ext = fconsts[5 * d + 1];
    prm.ax[d].hi = fconsts[5 * d + 2];
    prm.ax[d].inv_ext = fconsts[5 * d + 3];
    prm.ax[d].inv_w = fconsts[5 * d + 4];
    prm.ax[d].periodic = iconsts[4 * d + 0];
    prm.ax[d].pow2 = iconsts[4 * d + 1];
    prm.ax[d].shape = iconsts[4 * d + 2];
    prm.ax[d].stride = iconsts[4 * d + 3];
  }
  const int threads = 256;
  long long blocks = (m + threads - 1) / threads;
  driftbin_kernel<<<(unsigned int)blocks, threads, 0,
                    (cudaStream_t)stream>>>(
      (int32_t*)flat, (int32_t*)key, m, n, K, D, dt, R_total, prm);
  return (int)cudaGetLastError();
}

// Every __global__ function's footprint (resource_usage.cuh).
int driftbin_resource_usage(int i, const char** name, int* out) {
  return fill_resource_usage(kDriftbinFns,
                             (int)(sizeof(kDriftbinFns) / sizeof(FnRow)), i,
                             name, out);
}

const char* driftbin_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
