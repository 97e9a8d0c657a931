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
// the most dynamic shared memory a Hopper block can opt into
#define GPRY_MAX_SMEM (227 * 1024)

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

// ---------------------------------------------------------------------------
// Block-cooperative gated mean of one or two points (K1's small-batch
// design and K6).  A block stages the surrogate in shared memory once; the
// threads then split the n valid training rows and the support vectors of
// every evaluation and reduce with gpry_warp_sum plus one shared-memory
// step, so that one evaluation costs a few exponentials per thread and two
// block barriers instead of one thread's serial loop over all rows.
// ---------------------------------------------------------------------------

#define GPRY_BLOCK_THREADS 128
#define GPRY_BLOCK_WARPS (GPRY_BLOCK_THREADS / 32)

// Doubles of the staged surrogate: ls, x_loc, x_scale, trust_lo, trust_hi
// (d each), X / ls column-major (d x n) and alpha (n), the support vectors
// column-major (d x nsv) and the duals (nsv).  nsv is 0 unless the SVM
// mode is GPRY_MODE_FITTED; n (nsv) is 0 for a part that is read from a
// copy in global memory instead.
__host__ __device__ inline size_t gpry_staged_doubles(int n, int nsv, int d) {
  return 5 * (size_t)d + ((size_t)d + 1) * ((size_t)n + (size_t)nsv);
}

// Doubles of one evaluation's scratch: the two points preprocessed (qpre)
// and divided by the length scales (qls), the per-warp partial sums, and
// two parity slots of the out-of-gate bit masks.
__host__ __device__ inline size_t gpry_eval_doubles(int d) {
  return 4 * (size_t)d + 4 * GPRY_BLOCK_WARPS + 2;
}

struct GprySurrogate {
  int family, n, nsv, d, svm_mode;
  double variance, y_loc, y_scale, clip_max, intercept, gamma;
  const double *ls, *x_loc, *x_scale, *trust_lo, *trust_hi;
  const double *Xt, *alpha, *svt, *dual;
};

struct GpryEvalScratch {
  double *qpre, *qls, *red;
  int* bad;     // two parity slots
  int parity;   // the slot of the next evaluation (the same in every thread)
  double* tail; // the first free double of smem behind the scratch
};

// Stage the surrogate into smem (gpry_staged_doubles) and carve the
// evaluation scratch behind it.  g_xt (d x n) and g_svt (d x nsv), when not
// null, are copies of X / ls and of the support vectors in the staged
// layout in global memory (a surrogate too large for shared memory): that
// part is then read from there, with alpha or the duals, and not staged.
// Ends with a block barrier.
__device__ __forceinline__ GprySurrogate gpry_stage_surrogate(
    double* smem, GpryEvalScratch* sc, int family, int n, int nsv, int d,
    const double* __restrict__ X, const double* __restrict__ alpha,
    const double* __restrict__ theta, const double* __restrict__ x_loc,
    const double* __restrict__ x_scale, const double* __restrict__ trust_lo,
    const double* __restrict__ trust_hi, const double* __restrict__ sv,
    const double* __restrict__ dual, const double* __restrict__ scal,
    int svm_mode, const double* g_xt, const double* g_svt) {
  const int tid = threadIdx.x;
  GprySurrogate s;
  s.family = family;
  s.n = n;
  s.nsv = svm_mode == GPRY_MODE_FITTED ? nsv : 0;
  s.d = d;
  s.svm_mode = svm_mode;
  s.variance = exp(theta[0]);
  s.y_loc = scal[0];
  s.y_scale = scal[1];
  s.clip_max = scal[2];
  s.intercept = scal[3];
  s.gamma = scal[4];
  double* ls = smem;
  double* xl = ls + d;
  double* xs = xl + d;
  double* tl = xs + d;
  double* th = tl + d;
  // the parts staged here
  const int n_s = g_xt ? 0 : n;
  const int nsv_s = g_svt ? 0 : s.nsv;
  double* Xt = th + d;
  double* al = Xt + (size_t)d * n_s;
  double* svt = al + n_s;
  double* du = svt + (size_t)d * nsv_s;
  for (int k = tid; k < d; k += blockDim.x) {
    ls[k] = exp(theta[1 + k]);
    xl[k] = x_loc[k];
    xs[k] = x_scale[k];
    tl[k] = trust_lo[k];
    th[k] = trust_hi[k];
  }
  __syncthreads();
  for (int idx = tid; idx < n_s * d; idx += blockDim.x) {
    const int j = idx / d, k = idx - j * d;
    Xt[(size_t)k * n_s + j] = X[idx] / ls[k];
  }
  for (int j = tid; j < n_s; j += blockDim.x) al[j] = alpha[j];
  for (int idx = tid; idx < nsv_s * d; idx += blockDim.x) {
    const int j = idx / d, k = idx - j * d;
    svt[(size_t)k * nsv_s + j] = sv[idx];
  }
  for (int j = tid; j < nsv_s; j += blockDim.x) du[j] = dual[j];
  s.ls = ls;
  s.x_loc = xl;
  s.x_scale = xs;
  s.trust_lo = tl;
  s.trust_hi = th;
  s.Xt = g_xt ? g_xt : Xt;
  s.alpha = g_xt ? alpha : al;
  s.svt = g_svt ? g_svt : svt;
  s.dual = g_svt ? dual : du;
  double* scratch = smem + gpry_staged_doubles(n_s, nsv_s, d);
  sc->qpre = scratch;
  sc->qls = scratch + 2 * d;
  sc->red = scratch + 4 * d;
  sc->bad = (int*)(sc->red + 4 * GPRY_BLOCK_WARPS);
  sc->parity = 0;
  sc->tail = scratch + gpry_eval_doubles(d);
  if (tid < 2) sc->bad[tid] = 0;
  __syncthreads();
  return s;
}

// The gated mean (-inf outside the trust box, outside the optional prior
// box [lo, hi] and where the SVM predicts infinite; clipped above) of the
// points p in `need` (bit p), by the whole block; every thread gets the
// same out[p].  Point p's raw coordinate k is base[p][k] + t[p] * dir[k]
// (two roundings, as torch's x + t * e) or base[p][k] when dir is null.
// Entry: the bases and dir are visible to the block.  Two barriers.
__device__ __forceinline__ void gpry_block_gated_mean2(
    const GprySurrogate& s, GpryEvalScratch* sc, int need,
    const double* base0, const double* base1, const double* dir,
    double t0, double t1, const double* lo, const double* hi,
    double out[2]) {
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int d = s.d;
  int* bad = sc->bad + sc->parity;
  // A: one thread per (point, coordinate) transforms and gates.
  if (tid < 2 * d) {
    const int p = tid / d, k = tid - p * d;
    if (need & (1 << p)) {
      const double* b = p ? base1 : base0;
      const double xr = dir ? __dadd_rn(b[k], __dmul_rn(p ? t1 : t0, dir[k]))
                            : b[k];
      bool ok = (xr >= s.trust_lo[k]) && (xr <= s.trust_hi[k]);
      if (lo) ok = ok && (xr >= lo[k]) && (xr <= hi[k]);
      if (!ok) atomicOr(bad, 1 << p);
      const double xp = (xr - s.x_loc[k]) / s.x_scale[k];
      sc->qpre[p * d + k] = xp;
      sc->qls[p * d + k] = xp / s.ls[k];
    }
  }
  __syncthreads();
  // B: the threads split the rows; only points inside the gates are summed.
  int live = need & ~(*bad);
  if (s.svm_mode == GPRY_MODE_NONE_FINITE) live = 0;
  const bool l0 = live & 1, l1 = live & 2;
  double a0 = 0.0, a1 = 0.0, c0 = 0.0, c1 = 0.0;
  if (live) {
    const double* q0 = sc->qls;
    const double* q1 = sc->qls + d;
    for (int j = tid; j < s.n; j += blockDim.x) {
      double sq0 = 0.0, sq1 = 0.0;
      for (int k = 0; k < d; ++k) {
        const double xj = s.Xt[(size_t)k * s.n + j];
        const double f0 = q0[k] - xj, f1 = q1[k] - xj;
        sq0 += f0 * f0;
        sq1 += f1 * f1;
      }
      const double w = s.alpha[j];
      if (l0) a0 += (s.variance * gpry_k_of_sq(s.family, sq0)) * w;
      if (l1) a1 += (s.variance * gpry_k_of_sq(s.family, sq1)) * w;
    }
    const double* p0 = sc->qpre;
    const double* p1 = sc->qpre + d;
    for (int j = tid; j < s.nsv; j += blockDim.x) {
      double sq0 = 0.0, sq1 = 0.0;
      for (int k = 0; k < d; ++k) {
        const double v = s.svt[(size_t)k * s.nsv + j];
        const double f0 = p0[k] - v, f1 = p1[k] - v;
        sq0 += f0 * f0;
        sq1 += f1 * f1;
      }
      const double w = s.dual[j];
      if (l0) c0 += exp(-s.gamma * sq0) * w;
      if (l1) c1 += exp(-s.gamma * sq1) * w;
    }
    a0 = gpry_warp_sum(a0);
    a1 = gpry_warp_sum(a1);
    c0 = gpry_warp_sum(c0);
    c1 = gpry_warp_sum(c1);
    if (lane == 0) {
      sc->red[4 * warp + 0] = a0;
      sc->red[4 * warp + 1] = a1;
      sc->red[4 * warp + 2] = c0;
      sc->red[4 * warp + 3] = c1;
    }
  }
  __syncthreads();
  // C: every thread sums the warps' partials in the same order.
  if (live) {
    a0 = a1 = c0 = c1 = 0.0;
    for (int w = 0; w < GPRY_BLOCK_WARPS; ++w) {
      a0 += sc->red[4 * w + 0];
      a1 += sc->red[4 * w + 1];
      c0 += sc->red[4 * w + 2];
      c1 += sc->red[4 * w + 3];
    }
  }
  const double m0 = gpry_clip(a0 * s.y_scale + s.y_loc, s.clip_max);
  const double m1 = gpry_clip(a1 * s.y_scale + s.y_loc, s.clip_max);
  out[0] = (l0 && gpry_svm_finite(s.svm_mode, c0, s.intercept)) ? m0
                                                                : -INFINITY;
  out[1] = (l1 && gpry_svm_finite(s.svm_mode, c1, s.intercept)) ? m1
                                                                : -INFINITY;
  // every thread read this slot before the second barrier; the next
  // evaluation uses the other one
  if (tid == 0) *bad = 0;
  sc->parity ^= 1;
}
