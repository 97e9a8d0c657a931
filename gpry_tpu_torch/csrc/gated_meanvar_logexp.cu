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
// inside the kernel.  A block of 8 warps owns Q queries (Q chosen by the
// host from nmax, so that Q k-vectors fit in shared memory); phase 1 fills
// the Q x n k-vectors with all threads, phase 2 gives each warp one query
// at a time: the warp reduces k . alpha and the SVM sum, then runs the n
// sequential substitution steps, each a warp-wide dot product of a
// contiguous row of L with the solved prefix (coalesced reads of L, which
// stays resident in L2).
//
// What bounds it on the H100.  The n sequential steps per query, each a
// warp reduction (latency, not throughput): at the acquisition screen
// (nq = 3,200, n ~ 224, nmax = 320) there are 400 blocks, about one wave
// of warps on 132 SMs, so the kernel is latency-bound by the substitution
// chain; L2 traffic is the whole lower triangle of L once per query.
// Solving several queries per warp against one read of each L row is the
// next step for a later change.
#include "common.cuh"

#define K2_THREADS 256
#define K2_WARPS (K2_THREADS / 32)

__global__ void gated_meanvar_kernel(
    int family, int out_logexp, int nq, int n, int nmax, int nsv, int d,
    int Q, const double* __restrict__ Xq_raw, const double* __restrict__ X,
    const double* __restrict__ alpha, const double* __restrict__ L,
    const double* __restrict__ theta, const double* __restrict__ x_loc,
    const double* __restrict__ x_scale, const double* __restrict__ trust_lo,
    const double* __restrict__ trust_hi, const double* __restrict__ sv,
    const double* __restrict__ dual, const double* __restrict__ scal,
    int svm_mode, double zeta, double noise_std, double* __restrict__ out0,
    double* __restrict__ out1) {
  // shared layout: ls[d] | qpre[Q][d] | qls[Q][d] | trust[Q] | kv[Q][n]
  extern __shared__ double smem[];
  double* ls = smem;
  double* qpre = ls + d;
  double* qls = qpre + (size_t)Q * d;
  double* trust = qls + (size_t)Q * d;
  double* kv = trust + Q;

  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const int q0 = blockIdx.x * Q;
  const int nqb = min(Q, nq - q0);

  for (int k = tid; k < d; k += blockDim.x) ls[k] = exp(theta[1 + k]);
  __syncthreads();
  const double variance = exp(theta[0]);

  // query coordinates: preprocessed, and scaled by the length scales
  for (int idx = tid; idx < nqb * d; idx += blockDim.x) {
    const int k = idx % d;
    const double xp = (Xq_raw[(size_t)q0 * d + idx] - x_loc[k]) / x_scale[k];
    qpre[idx] = xp;
    qls[idx] = xp / ls[k];
  }
  for (int qi = tid; qi < nqb; qi += blockDim.x) {
    bool ok = true;
    for (int k = 0; k < d; ++k) {
      const double xr = Xq_raw[(size_t)(q0 + qi) * d + k];
      ok = ok && (xr >= trust_lo[k]) && (xr <= trust_hi[k]);
    }
    trust[qi] = ok ? 1.0 : 0.0;
  }
  __syncthreads();

  // phase 1: k vectors of the block's queries against the n valid rows
  for (int idx = tid; idx < nqb * n; idx += blockDim.x) {
    const int qi = idx / n, j = idx - qi * n;
    double sq = 0.0;
    for (int k = 0; k < d; ++k) {
      const double df = qls[qi * d + k] - X[(size_t)j * d + k] / ls[k];
      sq += df * df;
    }
    kv[(size_t)qi * n + j] = variance * gpry_k_of_sq(family, sq);
  }
  __syncthreads();

  const double y_loc = scal[0], y_scale = scal[1], clip_max = scal[2];
  const double intercept = scal[3], gamma = scal[4], y_max = scal[5];

  // phase 2: one warp per query
  for (int qi = warp; qi < nqb; qi += K2_WARPS) {
    double* v = kv + (size_t)qi * n;
    double m = 0.0;
    for (int j = lane; j < n; j += 32) m += v[j] * alpha[j];
    m = gpry_warp_sum(m);

    double dec = 0.0;
    if (svm_mode == GPRY_MODE_FITTED) {
      for (int s = lane; s < nsv; s += 32) {
        double sq = 0.0;
        for (int k = 0; k < d; ++k) {
          const double df = qpre[qi * d + k] - sv[(size_t)s * d + k];
          sq += df * df;
        }
        dec += exp(-gamma * sq) * dual[s];
      }
      dec = gpry_warp_sum(dec);
    }

    const double sumsq = gpry_warp_forward_subst(L, nmax, n, v, lane);

    if (lane == 0) {
      const int q = q0 + qi;
      const double var0 = variance - sumsq;
      const double var = (var0 < 0.0) ? 0.0 : var0;  // NaN stays NaN
      double mean = gpry_clip(m * y_scale + y_loc, clip_max);
      double std = sqrt(var) * y_scale;
      const bool ok =
          gpry_svm_finite(svm_mode, dec, intercept) && trust[qi] > 0.0;
      if (!ok) {
        mean = -INFINITY;
        std = 0.0;
      }
      if (out_logexp) {
        const double var2 = std * std - noise_std * noise_std;
        const bool ok2 = (var2 > 0.0) && isfinite(mean);
        out0[q] = ok2 ? 2.0 * zeta * (mean - y_max) + 0.5 * log(var2)
                      : -INFINITY;
      } else {
        out0[q] = mean;
        out1[q] = std;
      }
    }
  }
}

static size_t gated_meanvar_smem(int n, int d, int Q) {
  return sizeof(double) * ((size_t)d + 2 * (size_t)Q * d + (size_t)Q +
                           (size_t)Q * (size_t)n);
}

// scal = [y_loc, y_scale, clip_max, svm intercept, svm gamma, y_max]
extern "C" int gpry_gated_meanvar_logexp(
    int family, int out_logexp, int nq, int n, int nmax, int nsv, int d,
    int Q, const void* Xq_raw, const void* X, const void* alpha,
    const void* L, const void* theta, const void* x_loc,
    const void* x_scale, const void* trust_lo, const void* trust_hi,
    const void* sv, const void* dual, const void* scal, int svm_mode,
    double zeta, double noise_std, void* out0, void* out1, void* stream) {
  const size_t smem = gated_meanvar_smem(n, d, Q);
  cudaError_t e = gpry_set_smem(gated_meanvar_kernel, smem);
  if (e != cudaSuccess) return (int)e;
  if (nq <= 0) return 0;
  const dim3 grid((nq + Q - 1) / Q);
  gated_meanvar_kernel<<<grid, K2_THREADS, smem, (cudaStream_t)stream>>>(
      family, out_logexp, nq, n, nmax, nsv, d, Q, (const double*)Xq_raw,
      (const double*)X, (const double*)alpha, (const double*)L,
      (const double*)theta, (const double*)x_loc, (const double*)x_scale,
      (const double*)trust_lo, (const double*)trust_hi, (const double*)sv,
      (const double*)dual, (const double*)scal, svm_mode, zeta, noise_std,
      (double*)out0, (double*)out1);
  return (int)cudaGetLastError();
}
