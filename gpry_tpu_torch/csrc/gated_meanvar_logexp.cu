// K2 gated_meanvar_logexp: gated GP mean and latent std, or the gated
// LogExp acquisition value, in one pass.
//
// Replaces gpry_tpu/ops/linalg.py:192 predict_meanvar reached through
// gpry_tpu/models/gp.py:100 surrogate_predict (gates: SVM decision
// gpry_tpu/models/classifier.py:40, trust box, upper clip) and, with
// out_logexp = 1, the epilogue of
// gpry_tpu/acquisition/batch_optimizer.py:27 _acq_values_gated:
//
//   mean = min(k_q . alpha * y_scale + y_loc, clip_max)
//   var  = max(k(x, x) - ||L^-1 k_q||^2, 0),  std = sqrt(var) * y_scale
//   gates: mean = -inf, std = 0 where the SVM says infinite or outside
//   the trust box
//   LogExp: 2 zeta (mean - y_max) + 0.5 log(std^2 - sigma_n^2), -inf where
//   std^2 <= sigma_n^2 or mean is not finite
//
// Design.  The variance keeps the numerics of the triangular-solve form
// (linalg.py:204-206): each query's k vector is built in shared memory and
// solved by forward substitution against the padded Cholesky factor L
// inside the kernel.  Two routes, chosen by the host side of this file
// (k2_plan, mirrored by ops/fused.py gated_meanvar_logexp_plan):
//
// * Route 0, blocked (gated_meanvar_blocked): a block of 8 warps owns Q =
//   8, 16 or 32 queries (sub_queries of subst_blocked.cuh fixes the edges
//   in nq: small batches take 8, so that their blocks split the work of
//   the tensor-core tiles, the acquisition screen 16, larger sweeps 32;
//   fewer where shared memory forces it), builds
//   their k vectors with all threads as rows of V (row j: entry j of every
//   query), reduces k . alpha and the SVM sum a warp a query, then solves
//   V = L^-1 K for all Q at once with the routine of subst_blocked.cuh:
//   16-row panels of L staged by cp.async once per block (L2 traffic: the
//   triangle once per Q queries, not once per query), the panel update on
//   the FP64 tensor cores, the 16 x 16 diagonal block by a half-warp a
//   query in registers.  sigma^2 = prior - ||V_q||^2.  Route 0 takes n as
//   long as the panels, V and the queries fit in shared memory (Q = 8: n <=
//   640 at d = 8) and L's rows are 16-byte aligned (even nmax; sub_plan).
// * Route 1, the large-n route (gated_meanvar_chain), K2's design before
//   route 0: a warp a query at a time: the warp reduces k . alpha
//   and the SVM sum, then runs the n sequential substitution steps, each a
//   warp-wide dot product of a contiguous row of L with the solved prefix
//   (L read once per query from L2).  It takes Q k vectors of nmax in
//   shared memory (Q from the host's _sweep_queries_per_block: 8, or fewer
//   down to 1), so any nmax up to ~29,000 at d = 8.
//
// The mean, the SVM sum, the gates and the LogExp epilogue are the same
// code on both routes (k2_epilogue), so the routes differ only in the
// summation order of ||V_q||^2.
//
// What bounds it on the H100.  At the acquisition screen (nq = 3,200, n ~
// 224, nmax = 320) the operations (n^2 / 2 multiply-adds of the
// substitution and the k vector a query) take ~3 us at 67 TFLOP/s; route
// 0 is bound by the dependent chain of a block's 14 panels (update,
// barrier, 16 shuffle steps, barrier), route 1 by each query's n
// dependent warp reductions.
#include "subst_blocked.cuh"

#define K2_THREADS 256
#define K2_WARPS (K2_THREADS / 32)

struct K2Args {
  GpryKern kern;
  int out_logexp, nq, n, nmax, nsv, d, Q;
  const double *Xq_raw, *X, *alpha, *L, *theta, *x_loc, *x_scale, *trust_lo,
      *trust_hi, *sv, *dual, *scal;
  int svm_mode;
  double zeta, noise_std;
  double *out0, *out1;
};

// The block's queries (Q from query q0, nqb of them real): ls, the
// preprocessed and length-scaled coordinates and the trust-box flag, in
// shared memory; and the staged spec program (SPEC).  One barrier.
struct K2Queries {
  double *ls, *qpre, *qls, *trust;
  double variance;
  GprySpec spec;
};

template <bool SPEC>
__device__ K2Queries k2_queries(const K2Args& a, double* smem, double* prog,
                                int q0, int nqb) {
  const int tid = threadIdx.x, d = a.d, Q = a.Q;
  K2Queries k;
  k.ls = smem;
  k.qpre = k.ls + d;
  k.qls = k.qpre + (size_t)Q * d;
  k.trust = k.qls + (size_t)Q * d;
  if constexpr (SPEC)
    k.spec = gpry_stage_spec(prog, a.kern, a.theta, tid, blockDim.x);
  for (int i = tid; i < d; i += blockDim.x)
    k.ls[i] = SPEC ? 1.0 : exp(a.theta[1 + i]);
  __syncthreads();
  k.variance = SPEC ? 1.0 : exp(a.theta[0]);
  for (int idx = tid; idx < nqb * d; idx += blockDim.x) {
    const int i = idx % d;
    const double xp = (a.Xq_raw[(size_t)q0 * d + idx] - a.x_loc[i]) /
                      a.x_scale[i];
    k.qpre[idx] = xp;
    k.qls[idx] = xp / k.ls[i];
  }
  for (int qi = tid; qi < nqb; qi += blockDim.x) {
    bool ok = true;
    for (int i = 0; i < d; ++i) {
      const double xr = a.Xq_raw[(size_t)(q0 + qi) * d + i];
      ok = ok && (xr >= a.trust_lo[i]) && (xr <= a.trust_hi[i]);
    }
    k.trust[qi] = ok ? 1.0 : 0.0;
  }
  __syncthreads();
  return k;
}

// k(query qi, training row x): x the row as it is, or (fast families,
// `scaled`) already divided by the length scales
template <bool SPEC>
__device__ __forceinline__ double k2_cov(const K2Args& a, const K2Queries& k,
                                         int qi, const double* x,
                                         bool scaled) {
  const int d = a.d;
  if constexpr (SPEC) {
    return gpry_spec_cov(k.spec, k.qpre + qi * d, 1, x, 1, d);
  } else {
    double sq = 0.0;
    for (int i = 0; i < d; ++i) {
      const double df = k.qls[qi * d + i] - (scaled ? x[i] : x[i] / k.ls[i]);
      sq += df * df;
    }
    return k.variance * gpry_k_of_sq(a.kern.family, sq);
  }
}

// k . alpha over the n rows of v (stride `stride`) and the SVM sum of query
// qi, by one warp; the same value on every lane.
__device__ __forceinline__ void k2_mean_svm(const K2Args& a,
                                            const K2Queries& k, int qi,
                                            const double* v, int stride,
                                            double& m, double& dec) {
  const int lane = threadIdx.x & 31, d = a.d;
  m = sub_dot_alpha(v, stride, a.n, a.alpha);
  dec = 0.0;
  if (a.svm_mode == GPRY_MODE_FITTED) {
    const double gamma = a.scal[4];
    for (int s = lane; s < a.nsv; s += 32) {
      double sq = 0.0;
      for (int i = 0; i < d; ++i) {
        const double df = k.qpre[qi * d + i] - a.sv[(size_t)s * d + i];
        sq += df * df;
      }
      dec += exp(-gamma * sq) * a.dual[s];
    }
    dec = gpry_warp_sum(dec);
  }
}

// The outputs of query q0 + qi from its mean sum, SVM sum and ||L^-1 k||^2.
template <bool SPEC>
__device__ __forceinline__ void k2_epilogue(const K2Args& a,
                                            const K2Queries& k, int q0,
                                            int qi, double m, double dec,
                                            double sumsq) {
  const double y_loc = a.scal[0], y_scale = a.scal[1], clip_max = a.scal[2];
  const double intercept = a.scal[3], y_max = a.scal[5];
  const int q = q0 + qi;
  const double prior =
      SPEC ? gpry_spec_diag(k.spec, k.qpre + qi * a.d, 1, a.d) : k.variance;
  const double var0 = prior - sumsq;
  const double var = (var0 < 0.0) ? 0.0 : var0;  // NaN stays NaN
  double mean = gpry_clip(m * y_scale + y_loc, clip_max);
  double std = sqrt(var) * y_scale;
  const bool ok =
      gpry_svm_finite(a.svm_mode, dec, intercept) && k.trust[qi] > 0.0;
  if (!ok) {
    mean = -INFINITY;
    std = 0.0;
  }
  if (a.out_logexp) {
    const double var2 = std * std - a.noise_std * a.noise_std;
    const bool ok2 = (var2 > 0.0) && isfinite(mean);
    a.out0[q] = ok2 ? 2.0 * a.zeta * (mean - y_max) + 0.5 * log(var2)
                    : -INFINITY;
  } else {
    a.out0[q] = mean;
    a.out1[q] = std;
  }
}

// Shared doubles of the queries' part: ls, qpre, qls, trust (and, route 0,
// the mean and SVM sums).
__host__ __device__ inline size_t k2_query_doubles(int d, int Q) {
  return (size_t)d + 2 * (size_t)Q * d + 3 * (size_t)Q;
}

// Route 0.  Shared layout: the queries' part | m[Q] | dec[Q] (inside it) |
// spec program | subst_blocked's V, stages, shares, sumsq.
template <bool SPEC>
__global__ void __launch_bounds__(SUB_THREADS)
gated_meanvar_blocked(K2Args a) {
  extern __shared__ double smem[];
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int Q = a.Q, q0 = blockIdx.x * Q, nqb = min(Q, a.nq - q0);
  double* ms = smem + (size_t)a.d + 2 * (size_t)Q * a.d + Q;
  double* ds = ms + Q;
  double* prog = smem + k2_query_doubles(a.d, Q);
  const GprySub sub = sub_carve(a.L, a.n, a.nmax, Q,
                                prog + gpry_spec_doubles(a.kern));
  const K2Queries k = k2_queries<SPEC>(a, smem, prog, q0, nqb);
  // (a spec program's qls are its qpre: its length scales are 1)
  sub_build_k<SPEC>(sub, a.kern.family, k.spec, k.variance, k.ls, k.qls,
                    a.X, a.d, nqb);
  for (int qi = warp; qi < nqb; qi += K2_WARPS) {
    double m, dec;
    k2_mean_svm(a, k, qi, sub.V + qi, Q + 4, m, dec);
    if (lane == 0) {
      ms[qi] = m;
      ds[qi] = dec;
    }
  }
  __syncthreads();
  sub_forward(sub);
  for (int qi = tid; qi < nqb; qi += blockDim.x)
    k2_epilogue<SPEC>(a, k, q0, qi, ms[qi], ds[qi], sub.sumsq[qi]);
}

// Route 1.  Shared layout: the queries' part | kv[Q][n] | spec program.
template <bool SPEC>
__global__ void __launch_bounds__(K2_THREADS)
gated_meanvar_chain(K2Args a) {
  extern __shared__ double smem[];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int Q = a.Q, n = a.n, q0 = blockIdx.x * Q, nqb = min(Q, a.nq - q0);
  double* kv = smem + k2_query_doubles(a.d, Q);
  const K2Queries k =
      k2_queries<SPEC>(a, smem, kv + (size_t)Q * n, q0, nqb);

  // phase 1: k vectors of the block's queries against the n valid rows
  for (int idx = tid; idx < nqb * n; idx += blockDim.x) {
    const int qi = idx / n, j = idx - qi * n;
    kv[(size_t)qi * n + j] =
        k2_cov<SPEC>(a, k, qi, a.X + (size_t)j * a.d, false);
  }
  __syncthreads();

  // phase 2: one warp per query
  for (int qi = warp; qi < nqb; qi += K2_WARPS) {
    double* v = kv + (size_t)qi * n;
    double m, dec;
    k2_mean_svm(a, k, qi, v, 1, m, dec);
    const double sumsq = gpry_warp_forward_subst(a.L, a.nmax, n, v, lane);
    if (lane == 0) k2_epilogue<SPEC>(a, k, q0, qi, m, dec, sumsq);
  }
}

// The route (0 blocked, 1 the chain; sub_plan) for nq queries against n
// training rows of the (nmax, nmax) factor L, the queries a block *Q and
// the shared memory *smem; qchain is the chain's queries a block.
static int k2_plan(const GpryKern& kern, int nq, int n, int nmax, int d,
                   int qchain, const void* L, int* Q, size_t* smem) {
  const size_t spec = gpry_spec_doubles(kern);
  if (sub_plan(nq, n, nmax, L, (size_t)d + spec, 2 * (size_t)d + 3, Q,
               smem) == 0)
    return 0;
  *Q = qchain;
  *smem = sizeof(double) * (k2_query_doubles(d, qchain) +
                            (size_t)qchain * (size_t)n + spec);
  return 1;
}

extern "C" int gpry_gated_meanvar_logexp_plan(GpryKern kern, int nq, int n,
                                              int nmax, int d, int qchain,
                                              const void* L, int* Q,
                                              size_t* smem) {
  return k2_plan(kern, nq, n, nmax, d, qchain, L, Q, smem);
}

// scal = [y_loc, y_scale, clip_max, svm intercept, svm gamma, y_max];
// qchain: route 1's queries a block.
extern "C" int gpry_gated_meanvar_logexp(
    GpryKern kern, int out_logexp, int nq, int n, int nmax, int nsv, int d,
    int qchain, const void* Xq_raw, const void* X, const void* alpha,
    const void* L, const void* theta, const void* x_loc,
    const void* x_scale, const void* trust_lo, const void* trust_hi,
    const void* sv, const void* dual, const void* scal, int svm_mode,
    double zeta, double noise_std, void* out0, void* out1, void* stream) {
  K2Args a{kern, out_logexp, nq, n, nmax, nsv, d, 0,
           (const double*)Xq_raw, (const double*)X, (const double*)alpha,
           (const double*)L, (const double*)theta, (const double*)x_loc,
           (const double*)x_scale, (const double*)trust_lo,
           (const double*)trust_hi, (const double*)sv, (const double*)dual,
           (const double*)scal, svm_mode, zeta, noise_std, (double*)out0,
           (double*)out1};
  size_t smem = 0;
  const int route =
      k2_plan(kern, nq, n, nmax, d, qchain, L, &a.Q, &smem);
  const bool spec = kern.nodes > 0;
  auto kernel = route == 0 ? (spec ? gated_meanvar_blocked<true>
                                   : gated_meanvar_blocked<false>)
                           : (spec ? gated_meanvar_chain<true>
                                   : gated_meanvar_chain<false>);
  cudaError_t e = gpry_set_smem(kernel, smem);
  if (e != cudaSuccess) return (int)e;
  if (nq <= 0) return 0;
  const dim3 grid((nq + a.Q - 1) / a.Q);
  kernel<<<grid, route == 0 ? SUB_THREADS : K2_THREADS, smem,
           (cudaStream_t)stream>>>(a);
  return (int)cudaGetLastError();
}
