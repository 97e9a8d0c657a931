// Shared device helpers for the gpry_tpu_torch kernels (float64 only).
//
// Kernel families follow gpry_tpu/ops/kernels.py:68-97 (fast path): the
// correlation k(r) is evaluated from r^2 of per-dimension differences
// ((x_i - x'_i) / l_i), never from ||a||^2 + ||b||^2 - 2ab, which cancels.
// Composite kernels (the spec trees of gpry_tpu/ops/kernels.py:112-312)
// run through a small interpreter, gpry_spec_cov / gpry_spec_diag below;
// each kernel takes the mode as a template parameter, so that the fast
// families' instances keep their inner loops.
#pragma once

#include <cooperative_groups.h>
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

// Spec-program op codes: 0-3 are the ARD leaves of the GPRY_FAMILY_* above
// (unit variance, d length scales), then the other leaves and the
// operators (ops/fused.py SPEC_OPS holds the same table).
#define GPRY_OP_RQ 4
#define GPRY_OP_EXPSINE 5
#define GPRY_OP_DOT 6
#define GPRY_OP_WHITE 7
#define GPRY_OP_CONST 8
#define GPRY_OP_SUM 9
#define GPRY_OP_PROD 10
#define GPRY_OP_POW 11
// the largest program and evaluation stack the interpreter takes (the
// wrappers refuse a larger tree)
#define GPRY_SPEC_MAX_NODES 32
#define GPRY_SPEC_MAX_STACK 16
// the double nearest pi, as torch.pi and jnp.pi
#define GPRY_PI 3.141592653589793

// The covariance a kernel evaluates, passed by value from the host: a fast
// family (nodes == 0), or a spec program in post order (nodes > 0) whose
// leaves read theta at their offsets.  ntheta is the length of one theta
// row.
struct GpryKern {
  int family;          // GPRY_FAMILY_* of the fast path
  int nodes;           // spec program length; 0 for a fast family
  int ntheta;          // theta entries per row
  const int* prog;     // device: op[nodes] | theta offset[nodes]
  const double* expo;  // device: the static exponent of each pow node
};

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

// D += A B on the FP64 tensor cores, one m8n8k4 step of a whole warp
// (mma.sync; wgmma has no f64): lane (g, t) = (lane / 4, lane % 4) holds
// A[g][t] of the 8 x 4 A, B[t][g] of the 4 x 8 B and D[g][2t], D[g][2t + 1]
// of the 8 x 8 D.
__device__ __forceinline__ void gpry_dmma(double& d0, double& d1, double a,
                                          double b) {
  asm volatile(
      "mma.sync.aligned.m8n8k4.row.col.f64.f64.f64.f64 {%0, %1}, {%2}, "
      "{%3}, {%0, %1};\n"
      : "+d"(d0), "+d"(d1)
      : "d"(a), "d"(b));
}

// D += A B on the FP64 tensor cores, one m16n8k4 step of a whole warp
// (sm_90): lane (g, t) holds A[g][t] and A[g + 8][t] of the 16 x 4 A,
// B[t][g] of the 4 x 8 B and D[g][2t], D[g][2t + 1], D[g + 8][2t],
// D[g + 8][2t + 1] of the 16 x 8 D: two m8n8k4 steps that share B, in one
// instruction.
__device__ __forceinline__ void gpry_dmma16(double& d0, double& d1,
                                            double& d2, double& d3,
                                            double a0, double a1, double b) {
  asm volatile(
      "mma.sync.aligned.m16n8k4.row.col.f64.f64.f64.f64 {%0, %1, %2, %3}, "
      "{%4, %5}, {%6}, {%0, %1, %2, %3};\n"
      : "+d"(d0), "+d"(d1), "+d"(d2), "+d"(d3)
      : "d"(a0), "d"(a1), "d"(b));
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

// ---------------------------------------------------------------------------
// The spec interpreter.  A block stages the program and exp(+-theta) in
// shared memory (gpry_stage_spec); gpry_spec_cov evaluates the cross form
// k(a, b) in post order on a per-thread stack, gpry_spec_diag the
// same-point variance k(a, a).  Points are read with a stride, so that
// row-major, column-major and tiled layouts all serve.  Semantics of
// gpry_tpu/ops/kernels.py spec_cross / spec_diag (sklearn's): WhiteKernel
// is zero in the cross form and counts only on the diagonal; ExpSineSquared
// takes the unscaled Euclidean distance; DotProduct the preprocessed
// coordinates as they are; pow a static exponent (a non-integer power of a
// negative value is NaN, as there).
// ---------------------------------------------------------------------------

struct GprySpec {
  int nodes;
  const int *op, *off;
  const double *expo, *et, *iet;  // exponents, exp(theta), exp(-theta)
};

// Doubles of shared memory the staged program takes (0 for a fast family):
// exp(theta) and exp(-theta), the exponents, and the int op codes and
// offsets (two ints a node, one double).
__host__ __device__ inline size_t gpry_spec_doubles(const GpryKern& k) {
  return k.nodes > 0 ? 2 * (size_t)k.nodes + 2 * (size_t)k.ntheta : 0;
}

// Stage the program and exp(+-theta) (one theta row) at dst, by threads
// tid = 0..nthreads-1.  The caller synchronizes before the first use.
__device__ __forceinline__ GprySpec gpry_stage_spec(
    double* dst, const GpryKern& k, const double* __restrict__ theta,
    int tid, int nthreads) {
  double* et = dst;
  double* iet = et + k.ntheta;
  double* ex = iet + k.ntheta;
  int* op = (int*)(ex + k.nodes);
  int* off = op + k.nodes;
  for (int i = tid; i < k.ntheta; i += nthreads) {
    et[i] = exp(theta[i]);
    iet[i] = exp(-theta[i]);
  }
  for (int i = tid; i < k.nodes; i += nthreads) {
    ex[i] = k.expo[i];
    op[i] = k.prog[i];
    off[i] = k.prog[k.nodes + i];
  }
  GprySpec s;
  s.nodes = k.nodes;
  s.op = op;
  s.off = off;
  s.expo = ex;
  s.et = et;
  s.iet = iet;
  return s;
}

// v ** e with the exact shortcuts torch's pow takes for these exponents.
__device__ __forceinline__ double gpry_pow(double v, double e) {
  if (e == 2.0) return v * v;
  if (e == 3.0) return v * v * v;
  if (e == 0.5) return sqrt(v);
  if (e == 1.0) return v;
  return pow(v, e);
}

// Apply operator node i to the top of the stack (sum, product: two values;
// pow: one).
__device__ __forceinline__ void gpry_spec_apply(const GprySpec& s, int i,
                                                int op, double* st,
                                                int& top) {
  if (op == GPRY_OP_POW) {
    st[top - 1] = gpry_pow(st[top - 1], s.expo[i]);
    return;
  }
  const double b = st[--top];
  const double a = st[top - 1];
  st[top - 1] = op == GPRY_OP_SUM ? a + b : a * b;
}

// The cross form k(a, b); a[k * sa], b[k * sb], k < d, in the coordinates
// the GP works in (preprocessed, not divided by any length scale).
static __device__ __noinline__ double gpry_spec_cov(const GprySpec s,
                                                    const double* a, int sa,
                                                    const double* b, int sb,
                                                    int d) {
  double st[GPRY_SPEC_MAX_STACK];
  int top = 0;
  for (int i = 0; i < s.nodes; ++i) {
    const int op = s.op[i], off = s.off[i];
    if (op >= GPRY_OP_SUM) {
      gpry_spec_apply(s, i, op, st, top);
      continue;
    }
    double v;
    if (op <= GPRY_FAMILY_MATERN52) {
      double sq = 0.0;
      for (int k = 0; k < d; ++k) {
        const double df = (a[k * sa] - b[k * sb]) * s.iet[off + k];
        sq += df * df;
      }
      v = gpry_k_of_sq(op, sq);
    } else if (op == GPRY_OP_RQ) {
      const double il = s.iet[off + 1], al = s.et[off];
      double sq = 0.0;
      for (int k = 0; k < d; ++k) {
        const double df = (a[k * sa] - b[k * sb]) * il;
        sq += df * df;
      }
      v = pow(1.0 + sq / (2.0 * al), -al);
    } else if (op == GPRY_OP_EXPSINE) {
      double sq = 0.0;
      for (int k = 0; k < d; ++k) {
        const double df = a[k * sa] - b[k * sb];
        sq += df * df;
      }
      const double r = sq > 0.0 ? sqrt(sq) : 0.0;
      const double sn = sin(GPRY_PI * r / s.et[off + 1]) / s.et[off];
      v = exp(-2.0 * sn * sn);
    } else if (op == GPRY_OP_DOT) {
      double acc = 0.0;
      for (int k = 0; k < d; ++k) acc += a[k * sa] * b[k * sb];
      const double s0 = s.et[off];
      v = s0 * s0 + acc;
    } else if (op == GPRY_OP_WHITE) {
      v = 0.0;
    } else {  // GPRY_OP_CONST
      v = s.et[off];
    }
    st[top++] = v;
  }
  return st[0];
}

// The same-point variance k(a, a), WhiteKernel included.
static __device__ __noinline__ double gpry_spec_diag(const GprySpec s,
                                                     const double* a, int sa,
                                                     int d) {
  double st[GPRY_SPEC_MAX_STACK];
  int top = 0;
  for (int i = 0; i < s.nodes; ++i) {
    const int op = s.op[i], off = s.off[i];
    if (op >= GPRY_OP_SUM) {
      gpry_spec_apply(s, i, op, st, top);
      continue;
    }
    double v;
    if (op <= GPRY_OP_EXPSINE) {
      v = 1.0;
    } else if (op == GPRY_OP_DOT) {
      double acc = 0.0;
      for (int k = 0; k < d; ++k) acc += a[k * sa] * a[k * sa];
      const double s0 = s.et[off];
      v = s0 * s0 + acc;
    } else {  // WhiteKernel, ConstantKernel
      v = s.et[off];
    }
    st[top++] = v;
  }
  return st[0];
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
// The block-cooperative gated mean (its staging serves K6 and K12; K6
// evaluates with gpry_block_gated_mean_line below).  A block stages the
// surrogate in shared memory once; the threads then split the n valid
// training rows and the support vectors of every evaluation and reduce
// with gpry_warp_sum, so that one evaluation costs a few exponentials per
// thread and two block barriers instead of one thread's serial loop over
// all rows.
// ---------------------------------------------------------------------------

#define GPRY_BLOCK_THREADS 128
#define GPRY_BLOCK_WARPS (GPRY_BLOCK_THREADS / 32)

// Doubles of the staged surrogate: ls, x_loc, x_scale, trust_lo, trust_hi
// (d each), X / ls column-major (d x n) and alpha (n), the support vectors
// column-major (d x nsv) and the duals (nsv), and a spec program
// (gpry_spec_doubles; in spec mode ls is 1, so X is staged as it is).
// nsv is 0 unless the SVM mode is GPRY_MODE_FITTED; n (nsv) is 0 for a part
// that is read from a copy in global memory instead.
__host__ __device__ inline size_t gpry_staged_doubles(int n, int nsv, int d,
                                                      size_t spec) {
  return 5 * (size_t)d + ((size_t)d + 1) * ((size_t)n + (size_t)nsv) + spec;
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
// SPEC: kern is a spec program, staged too (into *spec); ls is 1.  Ends
// with a block barrier.
template <bool SPEC>
__device__ __forceinline__ GprySurrogate gpry_stage_surrogate(
    double* smem, GpryEvalScratch* sc, const GpryKern& kern, int n, int nsv,
    int d,
    const double* __restrict__ X, const double* __restrict__ alpha,
    const double* __restrict__ theta, const double* __restrict__ x_loc,
    const double* __restrict__ x_scale, const double* __restrict__ trust_lo,
    const double* __restrict__ trust_hi, const double* __restrict__ sv,
    const double* __restrict__ dual, const double* __restrict__ scal,
    int svm_mode, const double* g_xt, const double* g_svt, GprySpec* spec) {
  const int tid = threadIdx.x;
  GprySurrogate s;
  s.family = kern.family;
  s.n = n;
  s.nsv = svm_mode == GPRY_MODE_FITTED ? nsv : 0;
  s.d = d;
  s.svm_mode = svm_mode;
  s.variance = SPEC ? 1.0 : exp(theta[0]);
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
    ls[k] = SPEC ? 1.0 : exp(theta[1 + k]);
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
  double* sp = du + nsv_s;
  if constexpr (SPEC) *spec = gpry_stage_spec(sp, kern, theta, tid, blockDim.x);
  s.ls = ls;
  s.x_loc = xl;
  s.x_scale = xs;
  s.trust_lo = tl;
  s.trust_hi = th;
  s.Xt = g_xt ? g_xt : Xt;
  s.alpha = g_xt ? alpha : al;
  s.svt = g_svt ? g_svt : svt;
  s.dual = g_svt ? dual : du;
  double* scratch = sp + gpry_spec_doubles(kern);
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

// ---------------------------------------------------------------------------
// The gated mean of up to PMAX points of one line a pass (K6): point q is
// x + t_of(q) dir, all evaluated with two barriers.  A warp sums a
// point (warp q mod warps): lane s the rows s, s + 32, ... (the fast
// families GPRY_LINE_ROWS of them at a time) and the support vectors
// likewise, then the warp's xor tree, and its lane 0 applies the gates, so
// that each point gets the arithmetic and summation order of every other
// and its value does not depend on which other points share its pass, nor
// on how many there are.  With CL = 2 a cluster of two blocks evaluates
// the same points, block r the rows of the 32-row chunks c with c mod 2 =
// r; the two sums meet through distributed shared memory after a cluster
// barrier, both blocks adding rank 0's, then rank 1's (a third barrier).
// ---------------------------------------------------------------------------

// rows a lane of the line evaluation sums at a time (the fast families)
#define GPRY_LINE_ROWS 8

// Doubles of the scratch of up to pmax points: the points preprocessed
// (qpre) and divided by the length scales (qls), pmax d each; the points'
// gated values (pmax); two parity copies of their sums for a cluster (2
// pmax each: the peer may still read one while the other is written); two
// parity slots of the out-of-gate bit masks.
__host__ __device__ inline size_t gpry_line_eval_doubles(int d, int pmax) {
  return 2 * (size_t)pmax * d + 5 * (size_t)pmax + 2;
}

struct GpryLineScratch {
  double *qpre, *qls, *fin, *red;
  int* bad;     // two parity slots
  int parity;   // the slot of the next evaluation (the same in every thread)
};

// Carve the scratch at `at` (gpry_line_eval_doubles(d, pmax) doubles); the
// caller's next barrier makes the cleared masks visible.
__device__ __forceinline__ GpryLineScratch gpry_line_scratch(double* at,
                                                             int d, int pmax) {
  GpryLineScratch sc;
  sc.qpre = at;
  sc.qls = at + (size_t)pmax * d;
  sc.fin = sc.qls + (size_t)pmax * d;
  sc.red = sc.fin + pmax;
  sc.bad = (int*)(sc.red + 4 * (size_t)pmax);
  sc.parity = 0;
  if (threadIdx.x < 2) sc.bad[threadIdx.x] = 0;
  return sc;
}

// The gates and clip of a point's sums: the mean of the GP sum a, -inf
// where the SVM sum c says infinite.
__device__ __forceinline__ double gpry_line_gate(const GprySurrogate& s,
                                                 double a, double c) {
  const double m = gpry_clip(a * s.y_scale + s.y_loc, s.clip_max);
  return gpry_svm_finite(s.svm_mode, c, s.intercept) ? m : -INFINITY;
}

// The gated mean (its gates: the trust box, the optional prior box [lo,
// hi], the SVM, the clip) of the np <= PMAX points x + t_of(q) dir (two
// roundings, as torch's x + t * e), by the whole
// block; every thread gets the same out[q] for q < np (out[q] for q >= np
// is not defined).  t_of(q) must give every thread the same value.  Entry:
// x and dir visible to the block.  Two barriers (with CL = 2 the second a
// cluster barrier, then a third).
template <bool SPEC, int PMAX, int CL, typename TOf>
__device__ __forceinline__ void gpry_block_gated_mean_line(
    const GprySurrogate& s, const GprySpec& spec, GpryLineScratch* sc,
    int np, const double* x, const double* dir, TOf t_of, const double* lo,
    const double* hi, double out[PMAX]) {
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int nw = blockDim.x >> 5;
  const int d = s.d;
  int* bad = sc->bad + sc->parity;
  double* red = sc->red + 2 * PMAX * sc->parity;
  int rank = 0;
  if constexpr (CL > 1)
    rank = (int)cooperative_groups::this_cluster().block_rank();
  const int j0 = 32 * rank + lane;
  // A: one thread per (point, coordinate) transforms and gates; a warp's
  // out-of-gate bits meet in one atomic.
  for (int base = 32 * warp; base < np * d; base += blockDim.x) {
    const int idx = base + lane;
    int bits = 0;
    if (idx < np * d) {
      const int q = idx / d, k = idx - q * d;
      const double xr = __dadd_rn(x[k], __dmul_rn(t_of(q), dir[k]));
      bool ok = (xr >= s.trust_lo[k]) && (xr <= s.trust_hi[k]);
      if (lo) ok = ok && (xr >= lo[k]) && (xr <= hi[k]);
      if (!ok) bits = 1 << q;
      const double xp = (xr - s.x_loc[k]) / s.x_scale[k];
      sc->qpre[q * d + k] = xp;
      sc->qls[q * d + k] = xp / s.ls[k];
    }
    bits = __reduce_or_sync(0xffffffffu, bits);
    if (lane == 0 && bits) atomicOr(bad, bits);
  }
  __syncthreads();
  // B: a warp a point inside the gates, its lanes over the rows.
  int live = ((1 << np) - 1) & ~(*bad);
  if (s.svm_mode == GPRY_MODE_NONE_FINITE) live = 0;
  for (int q = warp; q < np; q += nw) {
    if (!((live >> q) & 1)) {
      if (lane == 0) sc->fin[q] = -INFINITY;
      continue;
    }
    const double* qp = sc->qls + q * d;
    double a = 0.0, c = 0.0;
    if constexpr (SPEC) {
      // qls is the preprocessed point (ls = 1), Xt the preprocessed X
      for (int j = j0; j < s.n; j += 32 * CL)
        a += gpry_spec_cov(spec, qp, 1, s.Xt + j, s.n, d) * s.alpha[j];
    } else {
      // GPRY_LINE_ROWS of the lane's rows at a time, independent chains,
      // their sums added in a fixed order at the end
      constexpr int U = GPRY_LINE_ROWS, J = 32 * CL;
      double acc[U];
#pragma unroll
      for (int u = 0; u < U; ++u) acc[u] = 0.0;
      for (int j = j0; j < s.n; j += U * J) {
        double sq[U];
#pragma unroll
        for (int u = 0; u < U; ++u) sq[u] = 0.0;
        const double* xk = s.Xt + j;
        for (int k = 0; k < d; ++k, xk += s.n) {
          const double qk = qp[k];
#pragma unroll
          for (int u = 0; u < U; ++u) {
            if (j + u * J < s.n) {
              const double f = qk - xk[u * J];
              sq[u] += f * f;
            }
          }
        }
        // one dispatch on the family for the U rows
        double kv[U];
        if (s.family == GPRY_FAMILY_RBF) {
#pragma unroll
          for (int u = 0; u < U; ++u) kv[u] = exp(-0.5 * sq[u]);
        } else {
#pragma unroll
          for (int u = 0; u < U; ++u) kv[u] = gpry_k_of_sq(s.family, sq[u]);
        }
#pragma unroll
        for (int u = 0; u < U; ++u)
          if (j + u * J < s.n)
            acc[u] += (s.variance * kv[u]) * s.alpha[j + u * J];
      }
#pragma unroll
      for (int u = 0; u < U; ++u) a += acc[u];
    }
    const double* qr = sc->qpre + q * d;
    for (int j = j0; j < s.nsv; j += 32 * CL) {
      double sq = 0.0;
      for (int k = 0; k < d; ++k) {
        const double f = qr[k] - s.svt[(size_t)k * s.nsv + j];
        sq += f * f;
      }
      c += exp(-s.gamma * sq) * s.dual[j];
    }
    a = gpry_warp_sum(a);
    c = gpry_warp_sum(c);
    if (lane == 0) {
      if constexpr (CL > 1) {
        red[2 * q] = a;
        red[2 * q + 1] = c;
      } else {
        sc->fin[q] = gpry_line_gate(s, a, c);
      }
    }
  }
  if constexpr (CL > 1) {
    cooperative_groups::this_cluster().sync();
    // rank 0's sums, then rank 1's, in every block
    if (tid < np && ((live >> tid) & 1)) {
      double av = 0.0, cv = 0.0;
      for (int r = 0; r < CL; ++r) {
        const double* rr =
            cooperative_groups::this_cluster().map_shared_rank(red, r);
        av += rr[2 * tid];
        cv += rr[2 * tid + 1];
      }
      sc->fin[tid] = gpry_line_gate(s, av, cv);
    }
  }
  __syncthreads();
  // C: every thread reads the values.
#pragma unroll
  for (int q = 0; q < PMAX; ++q) out[q] = sc->fin[q];
  // every thread read this slot before the second barrier; the next
  // evaluation uses the other one
  if (tid == 0) *bad = 0;
  sc->parity ^= 1;
}

// ---------------------------------------------------------------------------
// A surrogate beyond a block's shared memory (K6, K12).  The plan says where
// a kernel keeps it, given the `rest` doubles of shared memory the kernel
// needs besides it: 0 all of it in shared memory, 1 the support vectors in
// global memory, 2 X / l as well.  The parts in global memory are a copy in
// the staged (column-major) layout that a staging kernel writes first, on
// the same stream, with the arithmetic of gpry_stage_surrogate (X as it is
// in spec mode), so that both copies hold the same numbers.  nsv_eff counts
// the support vectors of the fitted SVM mode only; spec the staged
// program's doubles.
// ---------------------------------------------------------------------------

static __global__ void gpry_stage_global_kernel(
    int spec, int n, int nsv, int d, const double* __restrict__ X,
    const double* __restrict__ theta, const double* __restrict__ sv,
    double* xt, double* svt) {
  const int stride = gridDim.x * blockDim.x;
  const int i0 = blockIdx.x * blockDim.x + threadIdx.x;
  if (xt) {
    for (int idx = i0; idx < n * d; idx += stride) {
      const int j = idx / d, k = idx - j * d;
      xt[(size_t)k * n + j] = X[idx] / (spec ? 1.0 : exp(theta[1 + k]));
    }
  }
  if (svt) {
    for (int idx = i0; idx < nsv * d; idx += stride) {
      const int j = idx / d, k = idx - j * d;
      svt[(size_t)k * nsv + j] = sv[idx];
    }
  }
}

static inline int gpry_stage_plan(int n, int nsv_eff, int d, size_t spec,
                                  size_t rest) {
  if (sizeof(double) * (gpry_staged_doubles(n, nsv_eff, d, spec) + rest) <=
      GPRY_MAX_SMEM)
    return 0;
  if (sizeof(double) * (gpry_staged_doubles(n, 0, d, spec) + rest) <=
      GPRY_MAX_SMEM)
    return 1;
  return 2;
}

// Bytes of shared memory under the plan.
static inline size_t gpry_stage_smem(int plan, int n, int nsv_eff, int d,
                                     size_t spec, size_t rest) {
  return sizeof(double) *
         (gpry_staged_doubles(plan == 2 ? 0 : n, plan >= 1 ? 0 : nsv_eff, d,
                              spec) +
          rest);
}

// Doubles of global memory the plan's copy takes.
static inline size_t gpry_stage_work(int plan, int n, int nsv_eff, int d) {
  return (size_t)d * ((plan == 2 ? (size_t)n : 0) +
                      (plan >= 1 ? (size_t)nsv_eff : 0));
}

// Carve the plan's copy out of work (*g_xt, *g_svt: null for a part in
// shared memory) and launch the staging kernel if there is a copy.
static cudaError_t gpry_stage_global(int plan, const GpryKern& kern, int n,
                                     int nsv_eff, int d, const void* X,
                                     const void* theta, const void* sv,
                                     void* work, double** g_xt,
                                     double** g_svt, cudaStream_t stream) {
  *g_xt = plan == 2 ? (double*)work : nullptr;
  *g_svt = plan >= 1 && nsv_eff > 0
               ? (double*)work + (plan == 2 ? (size_t)d * n : 0)
               : nullptr;
  if (!*g_xt && !*g_svt) return cudaSuccess;
  if (!work) return cudaErrorInvalidValue;
  const int items = (n > nsv_eff ? n : nsv_eff) * d;
  const int blocks = (items + 255) / 256 < 1024 ? (items + 255) / 256 : 1024;
  gpry_stage_global_kernel<<<blocks, 256, 0, stream>>>(
      kern.nodes > 0, n, nsv_eff, d, (const double*)X, (const double*)theta,
      (const double*)sv, *g_xt, *g_svt);
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// Derivatives in x (K8, K9).  The rules are those of torch's autograd
// through ops/kernels.py (the plain versions K8 and K9 are held to): the
// zero-safe square roots of the Matern and ExpSineSquared kernels have a
// zero gradient at r = 0 (_safe_sqrt), so every stationary kernel's
// gradient is 0 at a training point.
// ---------------------------------------------------------------------------

// the largest d whose gradients K8 and K9 take (the wrappers refuse a
// larger one; the nested sampler's range, K6 and K13)
#define GPRY_GRAD_MAX_D 64
// the coordinates one pass of a per-thread gradient sum holds: a d <= 32
// instance sums every coordinate in one pass, the d <= 64 instance in two
// passes of 32 (per coordinate the same rows in the same order, so the
// same sums), which keeps 2 x 32 doubles a thread in registers where 2 x 64
// would spill
#define GPRY_GRAD_W 32

// dk / d(r^2) of the unit-variance correlation gpry_k_of_sq; 0 at r^2 = 0
// for the Matern families, as the zero-safe square root's gradient.
__device__ __forceinline__ double gpry_dk_dsq(int family, double sq) {
  switch (family) {
    case GPRY_FAMILY_RBF:
      return -0.5 * exp(-0.5 * sq);
    case GPRY_FAMILY_MATERN12: {
      if (!(sq > 0.0)) return 0.0;
      const double r = sqrt(sq);
      return -exp(-r) * (0.5 / r);
    }
    case GPRY_FAMILY_MATERN32: {
      const double s = 3.0 * sq;
      if (!(s > 0.0)) return 0.0;
      return -1.5 * exp(-sqrt(s));
    }
    case GPRY_FAMILY_MATERN52: {
      const double s = 5.0 * sq;
      if (!(s > 0.0)) return 0.0;
      const double r = sqrt(s);
      return -(5.0 / 6.0) * (1.0 + r) * exp(-r);
    }
  }
  return NAN;
}

// gpry_k_of_sq and gpry_dk_dsq of one r^2 from one exponential (the same
// operations as the two, so the same values).
__device__ __forceinline__ void gpry_k_dk_of_sq(int family, double sq,
                                                double* k, double* dk) {
  switch (family) {
    case GPRY_FAMILY_RBF: {
      const double e = exp(-0.5 * sq);
      *k = e;
      *dk = -0.5 * e;
      return;
    }
    case GPRY_FAMILY_MATERN12: {
      const double r = sq > 0.0 ? sqrt(sq) : 0.0;
      const double e = exp(-r);
      *k = e;
      *dk = sq > 0.0 ? -e * (0.5 / r) : 0.0;
      return;
    }
    case GPRY_FAMILY_MATERN32: {
      const double s = 3.0 * sq;
      const double r = s > 0.0 ? sqrt(s) : 0.0;
      const double e = exp(-r);
      *k = (1.0 + r) * e;
      *dk = s > 0.0 ? -1.5 * e : 0.0;
      return;
    }
    case GPRY_FAMILY_MATERN52: {
      const double s = 5.0 * sq;
      const double r = s > 0.0 ? sqrt(s) : 0.0;
      const double e = exp(-r);
      *k = (1.0 + r + r * r / 3.0) * e;
      *dk = s > 0.0 ? -(5.0 / 6.0) * (1.0 + r) * e : 0.0;
      return;
    }
  }
  *k = *dk = NAN;
}

// d(v ** e) / dv as torch's pow_backward: e v^(e - 1), and 0 for e = 0.
__device__ __forceinline__ double gpry_dpow(double v, double e) {
  if (e == 0.0) return 0.0;
  const double em1 = e - 1.0;
  if (em1 == -0.5) return e / sqrt(v);
  if (em1 == -1.0) return e / v;
  return e * gpry_pow(v, em1);
}

// Forward mode of gpry_spec_cov (diag false: k(a, b)) or gpry_spec_diag
// (diag true: k(a, a); b unused): returns the value and writes its partial
// derivatives in a_k to grad: all d of them (WIN false, d <= GPRY_GRAD_W),
// or those of the window k0 <= k < k0 + kw to grad[k - k0] (WIN true; kw
// <= GPRY_GRAD_W, the caller's min(d - k0, GPRY_GRAD_W): a wider d calls
// once a window, each window's partials the same operations as in one
// call; the d <= 32 instances keep the unwindowed addressing).  Each stack
// entry carries a value and the window's partials.  Per node: an ARD leaf
// dk/d(r^2)
// 2 (a - b) / l^2; RationalQuadratic the chain rule through pow;
// ExpSineSquared 0 at r = 0; DotProduct b in the cross form and 2 a on the
// diagonal (the only prior term with a gradient); WhiteKernel and
// ConstantKernel 0; sum, product and pow the usual rules (gpry_dpow).
template <bool WIN>
static __device__ __noinline__ double gpry_spec_grad(const GprySpec s,
                                                     const double* a, int sa,
                                                     const double* b, int sb,
                                                     int d, bool diag,
                                                     double* grad, int k0 = 0,
                                                     int kw = 0) {
  if (!WIN) {
    k0 = 0;
    kw = d;
  }
  double st[GPRY_SPEC_MAX_STACK];
  double gs[GPRY_SPEC_MAX_STACK][GPRY_GRAD_W];
  int top = 0;
  for (int i = 0; i < s.nodes; ++i) {
    const int op = s.op[i], off = s.off[i];
    if (op == GPRY_OP_POW) {
      const double v = st[top - 1], e = s.expo[i];
      const double dv = gpry_dpow(v, e);
      st[top - 1] = gpry_pow(v, e);
      for (int k = 0; k < kw; ++k) gs[top - 1][k] *= dv;
      continue;
    }
    if (op >= GPRY_OP_SUM) {
      const double bv = st[--top];
      const double av = st[top - 1];
      double* ga = gs[top - 1];
      const double* gb = gs[top];
      if (op == GPRY_OP_SUM) {
        st[top - 1] = av + bv;
        for (int k = 0; k < kw; ++k) ga[k] += gb[k];
      } else {
        st[top - 1] = av * bv;
        for (int k = 0; k < kw; ++k) ga[k] = ga[k] * bv + av * gb[k];
      }
      continue;
    }
    double v;
    double* gv = gs[top];
    for (int k = 0; k < kw; ++k) gv[k] = 0.0;
    if (diag) {
      if (op == GPRY_OP_DOT) {
        double acc = 0.0;
        if constexpr (WIN) {
          for (int k = 0; k < d; ++k) acc += a[k * sa] * a[k * sa];
          for (int k = 0; k < kw; ++k) gv[k] = 2.0 * a[(k0 + k) * sa];
        } else {
          for (int k = 0; k < d; ++k) {
            acc += a[k * sa] * a[k * sa];
            gv[k] = 2.0 * a[k * sa];
          }
        }
        const double s0 = s.et[off];
        v = s0 * s0 + acc;
      } else {
        v = op <= GPRY_OP_EXPSINE ? 1.0 : s.et[off];
      }
    } else if (op <= GPRY_FAMILY_MATERN52) {
      double sq = 0.0;
      for (int k = 0; k < d; ++k) {
        const double df = (a[k * sa] - b[k * sb]) * s.iet[off + k];
        sq += df * df;
      }
      v = gpry_k_of_sq(op, sq);
      const double c = 2.0 * gpry_dk_dsq(op, sq);
      for (int k = 0; k < kw; ++k) {
        const double il = s.iet[off + k0 + k];
        gv[k] = c * ((a[(k0 + k) * sa] - b[(k0 + k) * sb]) * il) * il;
      }
    } else if (op == GPRY_OP_RQ) {
      const double il = s.iet[off + 1], al = s.et[off];
      double sq = 0.0;
      for (int k = 0; k < d; ++k) {
        const double df = (a[k * sa] - b[k * sb]) * il;
        sq += df * df;
      }
      const double base = 1.0 + sq / (2.0 * al);
      v = pow(base, -al);
      const double c = 2.0 * (-al * pow(base, -al - 1.0) / (2.0 * al));
      for (int k = 0; k < kw; ++k)
        gv[k] = c * ((a[(k0 + k) * sa] - b[(k0 + k) * sb]) * il) * il;
    } else if (op == GPRY_OP_EXPSINE) {
      double sq = 0.0;
      for (int k = 0; k < d; ++k) {
        const double df = a[k * sa] - b[k * sb];
        sq += df * df;
      }
      const double r = sq > 0.0 ? sqrt(sq) : 0.0;
      const double arg = GPRY_PI * r / s.et[off + 1];
      const double sn = sin(arg) / s.et[off];
      v = exp(-2.0 * sn * sn);
      if (r > 0.0) {
        const double dvdr =
            v * (-4.0 * sn) * (cos(arg) / s.et[off]) * (GPRY_PI / s.et[off + 1]);
        for (int k = 0; k < kw; ++k)
          gv[k] = dvdr * ((a[(k0 + k) * sa] - b[(k0 + k) * sb]) / r);
      }
    } else if (op == GPRY_OP_DOT) {
      double acc = 0.0;
      if constexpr (WIN) {
        for (int k = 0; k < d; ++k) acc += a[k * sa] * b[k * sb];
        for (int k = 0; k < kw; ++k) gv[k] = b[(k0 + k) * sb];
      } else {
        for (int k = 0; k < d; ++k) {
          acc += a[k * sa] * b[k * sb];
          gv[k] = b[k * sb];
        }
      }
      const double s0 = s.et[off];
      v = s0 * s0 + acc;
    } else if (op == GPRY_OP_WHITE) {
      v = 0.0;
    } else {  // GPRY_OP_CONST
      v = s.et[off];
    }
    st[top++] = v;
  }
  for (int k = 0; k < kw; ++k) grad[k] = gs[0][k];
  return st[0];
}

// Back substitution L^T w = v for one query, by one warp, in the axpy
// form: v holds L^-1 k on entry and w = L^-T L^-1 k on exit (rows
// 0..n-1).  Step i (from n - 1 down) fixes w_i = r_i / L_ii and subtracts
// w_i times the contiguous row i of L from the residuals of rows 0..i-1,
// so that L is read by rows, as in gpry_warp_forward_subst.
__device__ __forceinline__ void gpry_warp_back_subst(
    const double* __restrict__ L, int nmax, int n, double* v, int lane) {
  for (int i = n - 1; i >= 0; --i) {
    const double* Li = L + (size_t)i * nmax;
    const double wi = v[i] / Li[i];
    __syncwarp();
    for (int j = lane; j < i; j += 32) v[j] -= Li[j] * wi;
    if (lane == 0) v[i] = wi;
    __syncwarp();
  }
}

// ---------------------------------------------------------------------------
// The ungated GP mean and latent variance of one point, and their
// gradients, by a whole block of GPRY_BLOCK_THREADS (K8's route 1 one
// block per query; K9 stages the same GP, one block per restart lane, for
// its own evaluation).  The block stages ls, x_loc,
// x_scale, alpha, a work vector and X / ls (column-major; X as it is in
// spec mode) in shared memory; L stays in global memory (the 50 MB L2
// holds it).  A training set too large for shared memory reads X from
// global memory instead (row-major, divided by ls on the fly with the same
// arithmetic), and one too large for even the two n-vectors keeps them in
// global memory too: alpha read where it lies, the work vector in the
// block's own slice of a workspace (K8's route 2, K9's route 3).  The
// arithmetic is the same wherever the vectors lie, so are the bits.
// ---------------------------------------------------------------------------

struct GpryGP {
  int family, n, nmax, d;
  double variance;       // exp(theta[0]); 1 in spec mode
  const double* ls;      // (d) length scales; 1 in spec mode
  const double* x_loc;   // (d)
  const double* x_scale; // (d)
  const double* Xt;      // training row j, coordinate k at Xt[k xk + j xj]
  int xk, xj;
  bool scale_x;          // Xt is X in global memory: divide by ls on read
  const double* alpha;   // (n)
  const double* L;       // (nmax, nmax) row-major, global memory
  double* kv;            // (n): k, then L^-1 k, then L^-T L^-1 k
  double* red;           // partial sums (gpry_grad_red_doubles)
  double* res;           // (2 + 2 d): mean, var, grad mean, grad var
};

__host__ __device__ inline size_t gpry_grad_red_doubles(int d) {
  return (size_t)GPRY_BLOCK_WARPS * (2 * (size_t)d + 1) + (size_t)d + 1;
}

// Doubles of the staged GP: ls, x_loc, x_scale (d each), res (2 + 2 d),
// the partial sums, alpha and kv (n each, when staged), X (d n, when
// staged) and the spec program.
__host__ __device__ inline size_t gpry_gp_doubles(int n, int d, bool stage_x,
                                                  size_t spec,
                                                  bool stage_v = true) {
  return 3 * (size_t)d + 2 + 2 * (size_t)d + gpry_grad_red_doubles(d) +
         (stage_v ? 2 * (size_t)n : 0) + (stage_x ? (size_t)d * n : 0) +
         spec;
}

// Stage the GP at smem (gpry_gp_doubles) and return it; *tail is the
// first free double behind it.  SPEC: the spec program is staged too
// (*spec) and ls is 1.  VG (the vectors in global memory): alpha stays
// where it lies and the work vector is the block's n doubles of `work`
// (blockIdx.x n on); a template argument, so that an instance with the
// vectors in shared memory addresses them as such.  Ends with a barrier.
template <bool SPEC, bool VG = false>
__device__ __forceinline__ GpryGP gpry_stage_gp(
    double* smem, const GpryKern& kern, int n, int nmax, int d,
    bool stage_x, const double* __restrict__ X,
    const double* __restrict__ alpha, const double* __restrict__ L,
    const double* __restrict__ theta, const double* __restrict__ x_loc,
    const double* __restrict__ x_scale, GprySpec* spec, double** tail,
    double* work = nullptr) {
  const int tid = threadIdx.x;
  double* ls = smem;
  double* xl = ls + d;
  double* xs = xl + d;
  double* res = xs + d;
  double* red = res + 2 + 2 * d;
  double* al = red + gpry_grad_red_doubles(d);
  double* kv = VG ? work + (size_t)blockIdx.x * n : al + n;
  double* Xt = VG ? al : kv + n;
  double* sp = Xt + (stage_x ? (size_t)d * n : 0);
  for (int k = tid; k < d; k += blockDim.x) {
    ls[k] = SPEC ? 1.0 : exp(theta[1 + k]);
    xl[k] = x_loc[k];
    xs[k] = x_scale[k];
  }
  __syncthreads();
  if (stage_x)
    for (int idx = tid; idx < n * d; idx += blockDim.x) {
      const int j = idx / d, k = idx - j * d;
      Xt[(size_t)k * n + j] = X[idx] / ls[k];
    }
  if (!VG)
    for (int j = tid; j < n; j += blockDim.x) al[j] = alpha[j];
  if constexpr (SPEC) *spec = gpry_stage_spec(sp, kern, theta, tid, blockDim.x);
  GpryGP g;
  g.family = kern.family;
  g.n = n;
  g.nmax = nmax;
  g.d = d;
  g.variance = SPEC ? 1.0 : exp(theta[0]);
  g.ls = ls;
  g.x_loc = xl;
  g.x_scale = xs;
  g.Xt = stage_x ? Xt : X;
  g.xk = stage_x ? n : 1;
  g.xj = stage_x ? 1 : d;
  g.scale_x = !stage_x;
  g.alpha = VG ? alpha : al;
  g.L = L;
  g.kv = kv;
  g.red = red;
  g.res = res;
  *tail = sp + gpry_spec_doubles(kern);
  __syncthreads();
  return g;
}

// Training row j, coordinate k, in the staged coordinates.
__device__ __forceinline__ double gpry_xt(const GpryGP& g, int j, int k) {
  const double v = g.Xt[(size_t)k * g.xk + (size_t)j * g.xj];
  return g.scale_x ? v / g.ls[k] : v;
}

// The gradient sums of the point q (visible to the block) from alpha and
// g.kv = w = L^-T L^-1 k (visible to the block), with g.res[0], g.res[1]
// set: res[2 + k] = sum_j alpha_j dk_j / dq_k and res[2 + d + k] = d prior
// / dq_k - 2 sum_j w_j dk_j / dq_k.  The threads split the rows, each
// summing 2 d per-thread sums, then block reductions.  GD: the largest d
// the instance takes, 32 (one pass) or 64 (two passes of GPRY_GRAD_W
// coordinates: the rows again, for the second 32; a coordinate's sums are
// the same operations either way).  Every thread calls it; it ends with a
// barrier, after which res is visible.
template <bool SPEC, int GD>
__device__ __forceinline__ void gpry_block_grad_sums(const GpryGP& g,
                                                     const GprySpec& spec,
                                                     const double* q) {
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int n = g.n, d = g.d;
  double* part = g.red + GPRY_BLOCK_WARPS;  // [warp][2 d]
  double* gprior = part + GPRY_BLOCK_WARPS * 2 * d;
  if constexpr (GD <= GPRY_GRAD_W) {
    // per thread: sum_j alpha_j grad k_j and sum_j w_j grad k_j over its
    // rows (fast mode: without the common 1 / ls_k)
    double am[GPRY_GRAD_W], aw[GPRY_GRAD_W];
    for (int k = 0; k < d; ++k) am[k] = aw[k] = 0.0;
    for (int j = tid; j < n; j += blockDim.x) {
      const double a = g.alpha[j], w = g.kv[j];
      if constexpr (SPEC) {
        double gk[GPRY_GRAD_W];
        gpry_spec_grad<false>(spec, q, 1, g.Xt + (size_t)j * g.xj, g.xk, d,
                              false, gk);
        for (int k = 0; k < d; ++k) {
          am[k] += a * gk[k];
          aw[k] += w * gk[k];
        }
      } else {
        double sq = 0.0;
        for (int k = 0; k < d; ++k) {
          const double df = q[k] - gpry_xt(g, j, k);
          sq += df * df;
        }
        const double c = 2.0 * g.variance * gpry_dk_dsq(g.family, sq);
        const double ca = c * a, cw = c * w;
        for (int k = 0; k < d; ++k) {
          const double df = q[k] - gpry_xt(g, j, k);
          am[k] += ca * df;
          aw[k] += cw * df;
        }
      }
    }
    for (int k = 0; k < d; ++k) {
      const double sa = gpry_warp_sum(am[k]);
      const double sw = gpry_warp_sum(aw[k]);
      if (lane == 0) {
        part[warp * 2 * d + k] = sa;
        part[warp * 2 * d + d + k] = sw;
      }
    }
  } else {
    // coordinates k0 .. k0 + 31 a pass, the sums in registers
    for (int k0 = 0; k0 < d; k0 += GPRY_GRAD_W) {
      const int kw = d - k0 < GPRY_GRAD_W ? d - k0 : GPRY_GRAD_W;
      double am[GPRY_GRAD_W], aw[GPRY_GRAD_W];
#pragma unroll
      for (int k = 0; k < GPRY_GRAD_W; ++k) am[k] = aw[k] = 0.0;
      for (int j = tid; j < n; j += blockDim.x) {
        const double a = g.alpha[j], w = g.kv[j];
        if constexpr (SPEC) {
          double gk[GPRY_GRAD_W];
          gpry_spec_grad<true>(spec, q, 1, g.Xt + (size_t)j * g.xj, g.xk,
                               d, false, gk, k0, kw);
#pragma unroll
          for (int k = 0; k < GPRY_GRAD_W; ++k)
            if (k < kw) {
              am[k] += a * gk[k];
              aw[k] += w * gk[k];
            }
        } else {
          double sq = 0.0;
          for (int k = 0; k < d; ++k) {
            const double df = q[k] - gpry_xt(g, j, k);
            sq += df * df;
          }
          const double c = 2.0 * g.variance * gpry_dk_dsq(g.family, sq);
          const double ca = c * a, cw = c * w;
#pragma unroll
          for (int k = 0; k < GPRY_GRAD_W; ++k)
            if (k < kw) {
              const double df = q[k0 + k] - gpry_xt(g, j, k0 + k);
              am[k] += ca * df;
              aw[k] += cw * df;
            }
        }
      }
#pragma unroll
      for (int k = 0; k < GPRY_GRAD_W; ++k)
        if (k < kw) {  // uniform over the warp
          const double sa = gpry_warp_sum(am[k]);
          const double sw = gpry_warp_sum(aw[k]);
          if (lane == 0) {
            part[warp * 2 * d + k0 + k] = sa;
            part[warp * 2 * d + d + k0 + k] = sw;
          }
        }
    }
  }
  if (tid == 0) {
    if constexpr (SPEC && GD <= GPRY_GRAD_W) {
      gpry_spec_grad<false>(spec, q, 1, q, 1, d, true, gprior);
    } else if constexpr (SPEC) {
      for (int k0 = 0; k0 < d; k0 += GPRY_GRAD_W)
        gpry_spec_grad<true>(spec, q, 1, q, 1, d, true, gprior + k0, k0,
                             d - k0 < GPRY_GRAD_W ? d - k0 : GPRY_GRAD_W);
    } else {
      for (int k = 0; k < d; ++k) gprior[k] = 0.0;
    }
  }
  __syncthreads();
  if (tid < 2 * d) {
    double s = 0.0;
    for (int w = 0; w < GPRY_BLOCK_WARPS; ++w) s += part[w * 2 * d + tid];
    const int k = tid < d ? tid : tid - d;
    s = s / g.ls[k];
    if (tid < d)
      g.res[2 + k] = s;
    else
      g.res[2 + d + k] = gprior[k] - 2.0 * s;
  }
  __syncthreads();
}

// The mean k . alpha and the latent variance prior - |L^-1 k|^2 (not
// clamped) of the point q (d: preprocessed, divided by ls in fast mode;
// visible to the block) in the GP's coordinates, into res[0], res[1], and
// their gradients in the preprocessed coordinates,
//   res[2 + k]     = d mean / dq_k = sum_j alpha_j dk_j / dq_k,
//   res[2 + d + k] = d var / dq_k  = d prior / dq_k - 2 sum_j w_j dk_j / dq_k
// with w = L^-T L^-1 k.  The threads split the rows for k and its
// gradient (block reductions of 1 and 2 d sums, gpry_block_grad_sums); one
// warp runs the two substitution chains.  Every thread calls it; it ends
// with a barrier, after which res is visible.
template <bool SPEC, int GD>
__device__ void gpry_block_meanvar_grad(const GpryGP& g, const GprySpec& spec,
                                        const double* q) {
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int n = g.n, d = g.d;
  double m = 0.0;
  for (int j = tid; j < n; j += blockDim.x) {
    double kj;
    if constexpr (SPEC) {
      kj = gpry_spec_cov(spec, q, 1, g.Xt + (size_t)j * g.xj, g.xk, d);
    } else {
      double sq = 0.0;
      for (int k = 0; k < d; ++k) {
        const double df = q[k] - gpry_xt(g, j, k);
        sq += df * df;
      }
      kj = g.variance * gpry_k_of_sq(g.family, sq);
    }
    g.kv[j] = kj;
    m += kj * g.alpha[j];
  }
  m = gpry_warp_sum(m);
  if (lane == 0) g.red[warp] = m;
  __syncthreads();
  if (warp == 0) {
    const double sumsq = gpry_warp_forward_subst(g.L, g.nmax, n, g.kv, lane);
    gpry_warp_back_subst(g.L, g.nmax, n, g.kv, lane);
    if (lane == 0) {
      double mm = 0.0;
      for (int w = 0; w < GPRY_BLOCK_WARPS; ++w) mm += g.red[w];
      const double prior = SPEC ? gpry_spec_diag(spec, q, 1, d) : g.variance;
      g.res[0] = mm;
      g.res[1] = prior - sumsq;
    }
  }
  __syncthreads();
  gpry_block_grad_sums<SPEC, GD>(g, spec, q);
}

// ---------------------------------------------------------------------------
// What the LML evaluation of K10 and K11 (lml_blocked.cuh) takes from here:
// the data of one LML, the packed-triangle offsets, and the spec
// interpreter's forward mode in theta for the gradient.
// ---------------------------------------------------------------------------

// parameters whose derivatives one contraction pass carries
#define GPRY_LML_PCHUNK 16
// log(2 pi) as math.log(2.0 * math.pi)
#define GPRY_LOG_2PI 1.8378770664093453

// Offset of row i of a packed lower triangle.
__host__ __device__ inline size_t gpry_tri(int i) {
  return (size_t)i * ((size_t)i + 1) / 2;
}

// The data of one LML: the first n rows of X (row-major, d columns) and
// of y, the noise (one value, or one per row) and the relative jitter.
struct GpryLmlData {
  int n, d, noise_is_vec;
  const double* X;
  const double* y;
  const double* noise;
  double rel_jitter;
};

// Forward mode of gpry_spec_cov (diag false) / gpry_spec_diag (diag true)
// in theta: returns the value and writes to tan[c] its derivative in
// theta[j0 + c], c < GPRY_LML_PCHUNK (theta in log space, as the leaves
// read exp(theta)).  Per leaf: an ARD leaf dk/d(r^2) (-2 df_k^2) in its
// log length scale k (df_k the scaled difference), 0 on the diagonal;
// RationalQuadratic v (sq / (2 base) - alpha log base) in log alpha and
// sq base^(-alpha - 1) in log l; ExpSineSquared 4 v s^2 in log l and
// 4 v s cos(arg) arg / l in log p (0 at r = 0); DotProduct 2 sigma_0^2;
// WhiteKernel its value on the diagonal, 0 off it; ConstantKernel its
// value; sum, product and pow the usual rules (gpry_dpow).
static __device__ __noinline__ double gpry_spec_dtheta(
    const GprySpec s, const double* a, int sa, const double* b, int sb,
    int d, bool diag, int j0, double* tan) {
  double st[GPRY_SPEC_MAX_STACK];
  double tg[GPRY_SPEC_MAX_STACK][GPRY_LML_PCHUNK];
  int top = 0;
  for (int i = 0; i < s.nodes; ++i) {
    const int op = s.op[i], off = s.off[i];
    if (op == GPRY_OP_POW) {
      const double v = st[top - 1], e = s.expo[i];
      const double dv = gpry_dpow(v, e);
      st[top - 1] = gpry_pow(v, e);
      for (int c = 0; c < GPRY_LML_PCHUNK; ++c) tg[top - 1][c] *= dv;
      continue;
    }
    if (op >= GPRY_OP_SUM) {
      const double bv = st[--top];
      const double av = st[top - 1];
      double* ta = tg[top - 1];
      const double* tb = tg[top];
      if (op == GPRY_OP_SUM) {
        st[top - 1] = av + bv;
        for (int c = 0; c < GPRY_LML_PCHUNK; ++c) ta[c] += tb[c];
      } else {
        st[top - 1] = av * bv;
        for (int c = 0; c < GPRY_LML_PCHUNK; ++c)
          ta[c] = ta[c] * bv + av * tb[c];
      }
      continue;
    }
    double v;
    double* tv = tg[top];
    for (int c = 0; c < GPRY_LML_PCHUNK; ++c) tv[c] = 0.0;
    // the chunk slot of parameter off + m, or -1 outside the chunk
    auto slot = [&](int m) {
      const int c = off + m - j0;
      return (c >= 0 && c < GPRY_LML_PCHUNK) ? c : -1;
    };
    if (op <= GPRY_FAMILY_MATERN52) {
      if (diag) {
        v = 1.0;
      } else {
        double sq = 0.0;
        for (int k = 0; k < d; ++k) {
          const double df = (a[k * sa] - b[k * sb]) * s.iet[off + k];
          sq += df * df;
        }
        v = gpry_k_of_sq(op, sq);
        const double dk = gpry_dk_dsq(op, sq);
        for (int c = 0; c < GPRY_LML_PCHUNK; ++c) {
          const int k = j0 + c - off;
          if (k < 0 || k >= d) continue;
          const double df = (a[k * sa] - b[k * sb]) * s.iet[off + k];
          tv[c] = dk * (-2.0 * df * df);
        }
      }
    } else if (op == GPRY_OP_RQ) {
      if (diag) {
        v = 1.0;
      } else {
        const double il = s.iet[off + 1], al = s.et[off];
        double sq = 0.0;
        for (int k = 0; k < d; ++k) {
          const double df = (a[k * sa] - b[k * sb]) * il;
          sq += df * df;
        }
        const double base = 1.0 + sq / (2.0 * al);
        v = pow(base, -al);
        int c = slot(0);
        if (c >= 0) tv[c] = v * (sq / (2.0 * base) - al * log(base));
        c = slot(1);
        if (c >= 0) tv[c] = sq * pow(base, -al - 1.0);
      }
    } else if (op == GPRY_OP_EXPSINE) {
      if (diag) {
        v = 1.0;
      } else {
        double sq = 0.0;
        for (int k = 0; k < d; ++k) {
          const double df = a[k * sa] - b[k * sb];
          sq += df * df;
        }
        const double r = sq > 0.0 ? sqrt(sq) : 0.0;
        const double arg = GPRY_PI * r / s.et[off + 1];
        const double sn = sin(arg) / s.et[off];
        v = exp(-2.0 * sn * sn);
        int c = slot(0);
        if (c >= 0) tv[c] = 4.0 * v * sn * sn;
        c = slot(1);
        if (c >= 0) tv[c] = 4.0 * v * sn * (cos(arg) / s.et[off]) * arg;
      }
    } else if (op == GPRY_OP_DOT) {
      double acc = 0.0;
      for (int k = 0; k < d; ++k)
        acc += a[k * sa] * (diag ? a[k * sa] : b[k * sb]);
      const double s0 = s.et[off];
      v = s0 * s0 + acc;
      const int c = slot(0);
      if (c >= 0) tv[c] = 2.0 * s0 * s0;
    } else if (op == GPRY_OP_WHITE) {
      v = diag ? s.et[off] : 0.0;
      const int c = slot(0);
      if (diag && c >= 0) tv[c] = v;
    } else {  // GPRY_OP_CONST
      v = s.et[off];
      const int c = slot(0);
      if (c >= 0) tv[c] = v;
    }
    st[top++] = v;
  }
  for (int c = 0; c < GPRY_LML_PCHUNK; ++c) tan[c] = tg[0][c];
  return st[0];
}
