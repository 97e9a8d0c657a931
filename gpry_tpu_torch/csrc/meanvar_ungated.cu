// K5 meanvar_ungated: the raw-space GP mean and latent std, with no gate
// and no clip, for the convergence audit's no-grad sweeps.
//
// Replaces gpry_tpu/ops/linalg.py:192 predict_meanvar reached through
// gpry_tpu/models/gp.py:85 surrogate_mean_std_smooth, as the audit calls it
// in gpry_tpu/run.py (the 4,096-point screen, the audit and apex polishes,
// the mode-centre and apex calibrations):
//
//   k    = sigma^2 k(r) against the n valid training rows
//   mean = k . alpha * y_scale + y_loc
//   var  = max(sigma^2 - ||L^-1 k||^2, 0),  std = sqrt(var) * y_scale
//
// Design: K2's two routes (gated_meanvar_logexp.cu) without its SVM and
// trust gates, its upper clip and its LogExp epilogue, chosen by the host
// side of this file (sub_ungated_plan of subst_blocked.cuh, mirrored by
// ops/fused.py meanvar_ungated_plan):
//
// * Route 0, blocked (meanvar_ungated_blocked): a block of SUB_THREADS
//   owns Q = 8, 16 or 32 queries (subst_blocked.cuh's sub_plan: Q by nq,
//   fewer where shared memory forces it) and runs sub_ungated of
//   subst_blocked.cuh: the k vectors as the rows of V (sub_build_k), k .
//   alpha a warp a query (sub_dot_alpha), V = L^-1 K for all Q at once
//   (sub_forward: 16-row panels of L staged by cp.async once per block,
//   the update on the FP64 tensor cores, the diagonal block by a
//   half-warp a query), then a thread a query writes mean and std.  K2
//   calls the same routine with the same sub_plan rule, so at one nq
//   (the same Q) K5's std is K2's ungated std bit for bit, and its mean
//   K2's wherever the clip does not bite; K8 (meanstd_grad.cu) runs the
//   same body with its gradients.  It takes n as long as the panels, V
//   and the queries fit in shared memory (Q = 8: n <= 640 at d = 8) and
//   L's rows are 16-byte aligned (an even nmax).
// * Route 1, the chain (meanvar_ungated_chain), K5's design before route
//   0: Q queries a block (Q chosen by the host from nmax, so that Q k
//   vectors fit in shared memory); phase 1 fills the Q x n k vectors with
//   all threads, phase 2 gives each warp one query: the warp reduces k .
//   alpha, then runs the n sequential substitution steps against the
//   row-major padded factor L (gpry_warp_forward_subst).  For an odd
//   nmax, an L that is not 16-byte aligned, or n beyond route 0.
//
// What bounds it on the H100.  Per query about n^2 / 2 multiply-adds of
// substitution and n (3d + 3) for the k vector: 2.3e8 FP64 operations at
// the audit screen (nq = 4,096, n = 224, d = 8), 3.5 us at the card's
// 67 TFLOP/s; the bytes (queries, training rows, the valid triangle of L,
// the outputs) are 0.55 MB.  Route 0 is bound by the dependent chain of a
// block's 14 panels (update, barrier, 16 shuffle steps, barrier), as K2's
// route 0; route 1 by each query's n dependent warp reductions.
//
// Spec mode (template SPEC), as K2's: the interpreter of common.cuh builds
// the k vectors from the preprocessed coordinates, and the prior variance
// is the query's gpry_spec_diag.
#include "subst_blocked.cuh"

#define K5_THREADS 256
#define K5_WARPS (K5_THREADS / 32)

// Route 0.
template <bool SPEC>
__global__ void __launch_bounds__(SUB_THREADS)
meanvar_ungated_blocked(SubUngated a) {
  extern __shared__ double smem[];
  sub_ungated<SPEC, 0>(a, smem);
}

// Route 1.
template <bool SPEC>
__global__ void meanvar_ungated_chain(
    GpryKern kern, int nq, int n, int nmax, int d, int Q,
    const double* __restrict__ Xq_raw, const double* __restrict__ X,
    const double* __restrict__ alpha, const double* __restrict__ L,
    const double* __restrict__ theta, const double* __restrict__ x_loc,
    const double* __restrict__ x_scale, const double* __restrict__ scal,
    double* __restrict__ mean_out, double* __restrict__ std_out) {
  // shared layout: ls[d] | qls[Q][d] | kv[Q][n] | spec program (SPEC)
  extern __shared__ double smem[];
  double* ls = smem;
  double* qls = ls + d;
  double* kv = qls + (size_t)Q * d;

  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const int q0 = blockIdx.x * Q;
  const int nqb = min(Q, nq - q0);
  const int family = kern.family;

  GprySpec spec;
  if constexpr (SPEC)
    spec = gpry_stage_spec(kv + (size_t)Q * n, kern, theta, tid, blockDim.x);
  for (int k = tid; k < d; k += blockDim.x)
    ls[k] = SPEC ? 1.0 : exp(theta[1 + k]);
  __syncthreads();
  const double variance = SPEC ? 1.0 : exp(theta[0]);

  // query coordinates, preprocessed and scaled by the length scales (by 1
  // in spec mode)
  for (int idx = tid; idx < nqb * d; idx += blockDim.x) {
    const int k = idx % d;
    qls[idx] = (Xq_raw[(size_t)q0 * d + idx] - x_loc[k]) / x_scale[k] / ls[k];
  }
  __syncthreads();

  // phase 1: k vectors of the block's queries against the n valid rows
  for (int idx = tid; idx < nqb * n; idx += blockDim.x) {
    const int qi = idx / n, j = idx - qi * n;
    if constexpr (SPEC) {
      kv[(size_t)qi * n + j] =
          gpry_spec_cov(spec, qls + qi * d, 1, X + (size_t)j * d, 1, d);
    } else {
      double sq = 0.0;
      for (int k = 0; k < d; ++k) {
        const double df = qls[qi * d + k] - X[(size_t)j * d + k] / ls[k];
        sq += df * df;
      }
      kv[(size_t)qi * n + j] = variance * gpry_k_of_sq(family, sq);
    }
  }
  __syncthreads();

  const double y_loc = scal[0], y_scale = scal[1];

  // phase 2: one warp per query
  for (int qi = warp; qi < nqb; qi += K5_WARPS) {
    double* v = kv + (size_t)qi * n;
    double m = 0.0;
    for (int j = lane; j < n; j += 32) m += v[j] * alpha[j];
    m = gpry_warp_sum(m);
    const double sumsq = gpry_warp_forward_subst(L, nmax, n, v, lane);
    if (lane == 0) {
      const double prior =
          SPEC ? gpry_spec_diag(spec, qls + qi * d, 1, d) : variance;
      const double var0 = prior - sumsq;
      const double var = (var0 < 0.0) ? 0.0 : var0;  // NaN stays NaN
      mean_out[q0 + qi] = m * y_scale + y_loc;
      std_out[q0 + qi] = sqrt(var) * y_scale;
    }
  }
}

// The route (0 blocked, 1 the chain; sub_ungated_plan, K7's solve's rule
// too) for nq queries against n training rows of the (nmax, nmax) factor
// L, the queries a block *Q and the shared memory *smem; qchain is the
// chain's queries a block.
extern "C" int gpry_meanvar_ungated_plan(GpryKern kern, int nq, int n,
                                         int nmax, int d, int qchain,
                                         const void* L, int* Q,
                                         size_t* smem) {
  return sub_ungated_plan(kern, nq, n, nmax, d, qchain, L, Q, smem);
}

// scal = [y_loc, y_scale, ...] (the surrogate's packed gate scalars; only
// the first two are read); qchain: route 1's queries a block.
extern "C" int gpry_meanvar_ungated(
    GpryKern kern, int nq, int n, int nmax, int d, int qchain,
    const void* Xq_raw, const void* X, const void* alpha, const void* L,
    const void* theta, const void* x_loc, const void* x_scale,
    const void* scal, void* mean_out, void* std_out, void* stream) {
  int Q = 0;
  size_t smem = 0;
  const int route =
      sub_ungated_plan(kern, nq, n, nmax, d, qchain, L, &Q, &smem);
  const bool spec = kern.nodes > 0;
  cudaError_t e;
  if (route == 0) {
    auto kernel = spec ? meanvar_ungated_blocked<true>
                       : meanvar_ungated_blocked<false>;
    e = gpry_set_smem(kernel, smem);
    if (e != cudaSuccess) return (int)e;
    if (nq <= 0) return 0;
    const SubUngated a{kern, nq, n, nmax, d, Q,
                       (const double*)Xq_raw, (const double*)X,
                       (const double*)alpha, (const double*)L,
                       (const double*)theta, (const double*)x_loc,
                       (const double*)x_scale, (const double*)scal,
                       (double*)mean_out, (double*)std_out, nullptr,
                       nullptr};
    kernel<<<(nq + Q - 1) / Q, SUB_THREADS, smem, (cudaStream_t)stream>>>(
        a);
    return (int)cudaGetLastError();
  }
  auto kernel = spec ? meanvar_ungated_chain<true>
                     : meanvar_ungated_chain<false>;
  e = gpry_set_smem(kernel, smem);
  if (e != cudaSuccess) return (int)e;
  if (nq <= 0) return 0;
  kernel<<<(nq + Q - 1) / Q, K5_THREADS, smem, (cudaStream_t)stream>>>(
      kern, nq, n, nmax, d, Q, (const double*)Xq_raw, (const double*)X,
      (const double*)alpha, (const double*)L, (const double*)theta,
      (const double*)x_loc, (const double*)x_scale, (const double*)scal,
      (double*)mean_out, (double*)std_out);
  return (int)cudaGetLastError();
}
