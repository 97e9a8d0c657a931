// K1 gated_mean: the gated GP posterior mean, in one pass.
//
// Replaces gpry_tpu/ops/linalg.py:157 predict_mean reached through
// gpry_tpu/models/gp.py:121 surrogate_predict_mean, with the SVM gate of
// gpry_tpu/models/classifier.py:40 svm_decision fused in.  It also does the
// work of the deleted Pallas kernel fused_predict_mean_f32
// (git show 595786d:gpry_tpu/ops/pallas_kernels.py), in float64.
//
//   out[q] = min((sum_{j<n} s2 k(r_qj) alpha_j) * y_scale + y_loc, clip_max)
//            if svm_finite(q) and x_q inside the trust box, else -inf
//
// Design.  A block owns 128 queries (one per thread).  The n valid training
// rows and alpha are streamed through shared memory in tiles of 64 rows x d,
// scaled by the length scales as they are loaded; the loop runs to n, not to
// the padded nmax.  The support vectors are streamed the same way for the
// SVM decision.  The (nq, nmax) cross-covariance never exists in memory.
//
// What bounds it on the H100.  On the nested-sampling path nq = nlive/6
// (66 at d = 8), one block: the call is launch-bound, and the host-side
// launch and the surrounding torch ops dominate.  On the IS-refine sweep
// (nq = 65,536, n ~ 224) it is bound by the float64 exp (one per query and
// training row, plus one per support vector): float64 runs at half the f32
// non-tensor rate on this card, and the data (X, alpha, support vectors)
// sits in shared memory, so memory traffic is small.
#include "common.cuh"

#define K1_THREADS 128
#define K1_TILE 64

__global__ void gated_mean_kernel(
    int family, int nq, int n, int nsv, int d,
    const double* __restrict__ Xq_raw, const double* __restrict__ X,
    const double* __restrict__ alpha, const double* __restrict__ theta,
    const double* __restrict__ x_loc, const double* __restrict__ x_scale,
    const double* __restrict__ trust_lo, const double* __restrict__ trust_hi,
    const double* __restrict__ sv, const double* __restrict__ dual,
    const double* __restrict__ scal, int svm_mode, double* __restrict__ out) {
  // shared layout: ls[d] | qpre[d][T] | qls[d][T] | tile[TILE][d] | tw[TILE]
  extern __shared__ double smem[];
  double* ls = smem;
  double* qpre = ls + d;
  double* qls = qpre + d * K1_THREADS;
  double* tile = qls + d * K1_THREADS;
  double* tw = tile + K1_TILE * d;

  const int tid = threadIdx.x;
  const int q = blockIdx.x * K1_THREADS + tid;
  const bool active = q < nq;

  for (int k = tid; k < d; k += blockDim.x) ls[k] = exp(theta[1 + k]);
  __syncthreads();
  const double variance = exp(theta[0]);

  bool in_trust = true;
  if (active) {
    for (int k = 0; k < d; ++k) {
      const double xr = Xq_raw[(size_t)q * d + k];
      in_trust = in_trust && (xr >= trust_lo[k]) && (xr <= trust_hi[k]);
      const double xp = (xr - x_loc[k]) / x_scale[k];
      qpre[k * K1_THREADS + tid] = xp;
      qls[k * K1_THREADS + tid] = xp / ls[k];
    }
  }

  // GP mean over the n valid training rows.
  double acc = 0.0;
  for (int j0 = 0; j0 < n; j0 += K1_TILE) {
    const int nt = min(K1_TILE, n - j0);
    __syncthreads();
    for (int idx = tid; idx < nt * d; idx += blockDim.x) {
      const int j = idx / d, k = idx - j * d;
      tile[idx] = X[(size_t)(j0 + j) * d + k] / ls[k];
    }
    for (int j = tid; j < nt; j += blockDim.x) tw[j] = alpha[j0 + j];
    __syncthreads();
    if (active) {
      for (int j = 0; j < nt; ++j) {
        double sq = 0.0;
        for (int k = 0; k < d; ++k) {
          const double df = qls[k * K1_THREADS + tid] - tile[j * d + k];
          sq += df * df;
        }
        acc += (variance * gpry_k_of_sq(family, sq)) * tw[j];
      }
    }
  }

  // SVM decision over the (padded) support vectors: padded duals are 0.
  double dec = 0.0;
  if (svm_mode == GPRY_MODE_FITTED) {
    const double gamma = scal[4];
    for (int s0 = 0; s0 < nsv; s0 += K1_TILE) {
      const int nt = min(K1_TILE, nsv - s0);
      __syncthreads();
      for (int idx = tid; idx < nt * d; idx += blockDim.x)
        tile[idx] = sv[(size_t)s0 * d + idx];
      for (int j = tid; j < nt; j += blockDim.x) tw[j] = dual[s0 + j];
      __syncthreads();
      if (active) {
        for (int j = 0; j < nt; ++j) {
          double sq = 0.0;
          for (int k = 0; k < d; ++k) {
            const double df = qpre[k * K1_THREADS + tid] - tile[j * d + k];
            sq += df * df;
          }
          dec += exp(-gamma * sq) * tw[j];
        }
      }
    }
  }

  if (active) {
    const double y_loc = scal[0], y_scale = scal[1], clip_max = scal[2];
    const double intercept = scal[3];
    const double mean = gpry_clip(acc * y_scale + y_loc, clip_max);
    const bool ok = gpry_svm_finite(svm_mode, dec, intercept) && in_trust;
    out[q] = ok ? mean : -INFINITY;
  }
}

static size_t gated_mean_smem(int d) {
  return sizeof(double) *
         ((size_t)d + 2 * (size_t)d * K1_THREADS + (size_t)K1_TILE * d +
          K1_TILE);
}

// scal = [y_loc, y_scale, clip_max, svm intercept, svm gamma, y_max]
extern "C" int gpry_gated_mean(int family, int nq, int n, int nsv, int d,
                               const void* Xq_raw, const void* X,
                               const void* alpha, const void* theta,
                               const void* x_loc, const void* x_scale,
                               const void* trust_lo, const void* trust_hi,
                               const void* sv, const void* dual,
                               const void* scal, int svm_mode, void* out,
                               void* stream) {
  const size_t smem = gated_mean_smem(d);
  cudaError_t e = gpry_set_smem(gated_mean_kernel, smem);
  if (e != cudaSuccess) return (int)e;
  if (nq <= 0) return 0;
  const dim3 grid((nq + K1_THREADS - 1) / K1_THREADS);
  gated_mean_kernel<<<grid, K1_THREADS, smem, (cudaStream_t)stream>>>(
      family, nq, n, nsv, d, (const double*)Xq_raw, (const double*)X,
      (const double*)alpha, (const double*)theta, (const double*)x_loc,
      (const double*)x_scale, (const double*)trust_lo,
      (const double*)trust_hi, (const double*)sv, (const double*)dual,
      (const double*)scal, svm_mode, (double*)out);
  return (int)cudaGetLastError();
}
