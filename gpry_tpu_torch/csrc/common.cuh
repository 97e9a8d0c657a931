// Shared device helpers for the gpry_tpu_torch kernels (float64 only).
//
// Kernel families follow gpry_tpu/ops/kernels.py:68-97 (fast path): the
// correlation k(r) is evaluated from r^2 of per-dimension differences
// ((x_i - x'_i) / l_i), never from ||a||^2 + ||b||^2 - 2ab, which cancels.
#pragma once

#include <cuda_runtime.h>
#include <math.h>

#define GPRY_FAMILY_RBF 0
#define GPRY_FAMILY_MATERN12 1
#define GPRY_FAMILY_MATERN32 2
#define GPRY_FAMILY_MATERN52 3

// SVM decision modes (gpry_tpu/models/classifier.py:26-28).
#define GPRY_MODE_ALL_FINITE 0
#define GPRY_MODE_FITTED 1
#define GPRY_MODE_NONE_FINITE 2

#define GPRY_DEFAULT_SMEM (48 * 1024)

// Unit-variance correlation as a function of r^2.  The Matern square
// roots are zero-safe at r = 0, as gpry_tpu's _safe_sqrt.
__device__ __forceinline__ double gpry_k_of_sq(int family, double sq) {
  switch (family) {
    case GPRY_FAMILY_RBF:
      return exp(-0.5 * sq);
    case GPRY_FAMILY_MATERN12: {
      double r = sq > 0.0 ? sqrt(sq) : 0.0;
      return exp(-r);
    }
    case GPRY_FAMILY_MATERN32: {
      double s = 3.0 * sq;
      double r = s > 0.0 ? sqrt(s) : 0.0;
      return (1.0 + r) * exp(-r);
    }
    case GPRY_FAMILY_MATERN52: {
      double s = 5.0 * sq;
      double r = s > 0.0 ? sqrt(s) : 0.0;
      return (1.0 + r + r * r / 3.0) * exp(-r);
    }
  }
  return NAN;
}

// SVM gate: the decision sum has already been accumulated; the mode
// overrides it exactly as svm_decision does.
__device__ __forceinline__ bool gpry_svm_finite(int mode, double dec_sum,
                                                double intercept) {
  if (mode == GPRY_MODE_ALL_FINITE) return true;
  if (mode == GPRY_MODE_NONE_FINITE) return false;
  return dec_sum + intercept > 0.0;
}

// NaN-propagating min(mean, clip), like jnp.minimum.
__device__ __forceinline__ double gpry_clip(double mean, double clip_max) {
  return (mean > clip_max) ? clip_max : mean;
}

__device__ __forceinline__ double gpry_warp_sum(double v) {
  for (int off = 16; off > 0; off >>= 1)
    v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

// Forward substitution L v = k for one query, by one warp: v holds k on
// entry and L^-1 k on exit (rows 0..n-1; the padded rows of L are the
// identity and k is zero there).  L is row-major with leading dimension
// nmax; each step is a warp dot product with a contiguous row of L.
// Returns ||L^-1 k||^2, the same on every lane.
__device__ __forceinline__ double gpry_warp_forward_subst(
    const double* __restrict__ L, int nmax, int n, double* v, int lane) {
  double sumsq = 0.0;
  for (int i = 0; i < n; ++i) {
    const double* Li = L + (size_t)i * nmax;
    double s = 0.0;
    for (int j = lane; j < i; j += 32) s += Li[j] * v[j];
    s = gpry_warp_sum(s);
    const double vi = (v[i] - s) / Li[i];
    __syncwarp();
    if (lane == 0) v[i] = vi;
    __syncwarp();
    sumsq += vi * vi;
  }
  return sumsq;
}

// Opt a kernel into more than 48 KB of dynamic shared memory when needed.
template <typename K>
static cudaError_t gpry_set_smem(K kernel, size_t bytes) {
  if (bytes <= GPRY_DEFAULT_SMEM) return cudaSuccess;
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)bytes);
}
