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
// Design: K2's body (gated_meanvar_logexp.cu) without its SVM and trust
// gates, its upper clip and its LogExp epilogue.  A block of 8 warps owns
// Q queries (Q chosen by the host from nmax, so that Q k vectors fit in
// shared memory); phase 1 fills the Q x n k vectors with all threads,
// phase 2 gives each warp one query: the warp reduces k . alpha, then runs
// the n sequential substitution steps against the row-major padded factor
// L (gpry_warp_forward_subst).
//
// What bounds it on the H100.  Per query about n^2 / 2 multiply-adds of
// substitution and n (3d + 3) for the k vector: 2.3e8 FP64 operations at
// the audit screen (nq = 4,096, n = 224, d = 8), 3.5 us at the card's
// 67 TFLOP/s; the bytes (queries, training rows, the valid triangle of L,
// the outputs) are 0.55 MB.  Each substitution step depends on the one
// before, so the
// chain of n dependent warp reductions, each reading a row of L from L2,
// bounds it (latency, not throughput), as it does K2.
//
// Spec mode (template SPEC), as K2's: the interpreter of common.cuh builds
// the k vectors from the preprocessed coordinates, and the prior variance
// is the query's gpry_spec_diag.
#include "common.cuh"

#define K5_THREADS 256
#define K5_WARPS (K5_THREADS / 32)

template <bool SPEC>
__global__ void meanvar_ungated_kernel(
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

static size_t meanvar_ungated_smem(const GpryKern& kern, int n, int d,
                                   int Q) {
  return sizeof(double) * ((size_t)d + (size_t)Q * d + (size_t)Q * n +
                           gpry_spec_doubles(kern));
}

// scal = [y_loc, y_scale, ...] (the surrogate's packed gate scalars; only
// the first two are read)
extern "C" int gpry_meanvar_ungated(
    GpryKern kern, int nq, int n, int nmax, int d, int Q, const void* Xq_raw,
    const void* X, const void* alpha, const void* L, const void* theta,
    const void* x_loc, const void* x_scale, const void* scal,
    void* mean_out, void* std_out, void* stream) {
  const size_t smem = meanvar_ungated_smem(kern, n, d, Q);
  auto kernel = kern.nodes ? meanvar_ungated_kernel<true>
                           : meanvar_ungated_kernel<false>;
  cudaError_t e = gpry_set_smem(kernel, smem);
  if (e != cudaSuccess) return (int)e;
  if (nq <= 0) return 0;
  const dim3 grid((nq + Q - 1) / Q);
  kernel<<<grid, K5_THREADS, smem, (cudaStream_t)stream>>>(
      kern, nq, n, nmax, d, Q, (const double*)Xq_raw, (const double*)X,
      (const double*)alpha, (const double*)L, (const double*)theta,
      (const double*)x_loc, (const double*)x_scale, (const double*)scal,
      (double*)mean_out, (double*)std_out);
  return (int)cudaGetLastError();
}
