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
// Two designs.  The wrapper (ops/fused.py gated_mean) takes the block
// design whenever its staged surrogate fits in a block's shared memory and
// 2 d <= 128, and the tiled design otherwise: on an H100 the block design
// was the faster at every batch measured, 16 to 65,536 queries (PERF.md).
//
// Tiled (any surrogate).  A block owns 128 queries (one per thread).  The n
// valid training rows and alpha are streamed through shared memory in tiles
// of 64 rows x d, scaled by the length scales as they are loaded; the loop
// runs to n, not to the padded nmax.  The support vectors are streamed the
// same way for the SVM decision.  The (nq, nmax) cross-covariance never
// exists in memory.  On the IS-refine sweep (nq = 65,536, n ~ 224) it is
// bound by the float64 exp (one per query and training row, plus one per
// support vector): the data sits in shared memory, so memory traffic is
// small.  Below a few thousand queries it fills only a few SMs, and each
// thread runs a chain of n + nsv dependent exponentials.
//
// Block per query (the MCMC step, the NS prior phase, the IS refine).  Up
// to K1_SMALL_GRID blocks each stage the surrogate in
// shared memory once and evaluate their queries two at a time with the
// block-cooperative routine of common.cuh (gpry_block_gated_mean2): the
// 128 threads split the rows, so one query costs a few exponentials per
// thread, a block reduction and two barriers.  What bounds it is that
// latency, and the staging of the surrogate per block.
//
// Spec mode (a composite kernel, template SPEC): both designs stage X as it
// is (no length scale divides the whole point) with the spec program and
// exp(+-theta), and each (query, training row) pair runs the interpreter
// of common.cuh (gpry_spec_cov) in place of variance * k(r^2).
#include "common.cuh"

#define K1_THREADS 128
#define K1_TILE 64
#define K1_SMALL_GRID 1056

template <bool SPEC>
__global__ void gated_mean_kernel(
    GpryKern kern, int nq, int n, int nsv, int d,
    const double* __restrict__ Xq_raw, const double* __restrict__ X,
    const double* __restrict__ alpha, const double* __restrict__ theta,
    const double* __restrict__ x_loc, const double* __restrict__ x_scale,
    const double* __restrict__ trust_lo, const double* __restrict__ trust_hi,
    const double* __restrict__ sv, const double* __restrict__ dual,
    const double* __restrict__ scal, int svm_mode, double* __restrict__ out) {
  // shared layout: ls[d] | qpre[d][T] | qls[d][T] | tile[TILE][d] | tw[TILE]
  //                | spec program (SPEC)
  extern __shared__ double smem[];
  double* ls = smem;
  double* qpre = ls + d;
  double* qls = qpre + d * K1_THREADS;
  double* tile = qls + d * K1_THREADS;
  double* tw = tile + K1_TILE * d;

  const int tid = threadIdx.x;
  const int q = blockIdx.x * K1_THREADS + tid;
  const bool active = q < nq;
  const int family = kern.family;

  GprySpec spec;
  if constexpr (SPEC)
    spec = gpry_stage_spec(tw + K1_TILE, kern, theta, tid, blockDim.x);
  for (int k = tid; k < d; k += blockDim.x)
    ls[k] = SPEC ? 1.0 : exp(theta[1 + k]);
  __syncthreads();
  const double variance = SPEC ? 1.0 : exp(theta[0]);

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
        if constexpr (SPEC) {
          acc += gpry_spec_cov(spec, qpre + tid, K1_THREADS, tile + j * d, 1,
                               d) * tw[j];
        } else {
          double sq = 0.0;
          for (int k = 0; k < d; ++k) {
            const double df = qls[k * K1_THREADS + tid] - tile[j * d + k];
            sq += df * df;
          }
          acc += (variance * gpry_k_of_sq(family, sq)) * tw[j];
        }
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

template <bool SPEC>
__global__ void __launch_bounds__(GPRY_BLOCK_THREADS)
gated_mean_small_kernel(
    GpryKern kern, int nq, int n, int nsv, int d,
    const double* __restrict__ Xq_raw, const double* __restrict__ X,
    const double* __restrict__ alpha, const double* __restrict__ theta,
    const double* __restrict__ x_loc, const double* __restrict__ x_scale,
    const double* __restrict__ trust_lo, const double* __restrict__ trust_hi,
    const double* __restrict__ sv, const double* __restrict__ dual,
    const double* __restrict__ scal, int svm_mode, double* __restrict__ out) {
  extern __shared__ double smem[];
  GpryEvalScratch sc;
  GprySpec spec;
  const GprySurrogate s = gpry_stage_surrogate<SPEC>(
      smem, &sc, kern, n, nsv, d, X, alpha, theta, x_loc, x_scale,
      trust_lo, trust_hi, sv, dual, scal, svm_mode, nullptr, nullptr,
      &spec);
  // queries q and q + gridDim.x together; the loop bound is block-uniform
  for (int q = blockIdx.x; q < nq; q += 2 * gridDim.x) {
    const int q1 = q + gridDim.x;
    const int need = 1 | (q1 < nq ? 2 : 0);
    double v[2];
    gpry_block_gated_mean2<SPEC>(s, spec, &sc, need, Xq_raw + (size_t)q * d,
                           Xq_raw + (size_t)(need & 2 ? q1 : q) * d, nullptr,
                           0.0, 0.0, nullptr, nullptr, v);
    if (threadIdx.x == 0) {
      out[q] = v[0];
      if (need & 2) out[q1] = v[1];
    }
  }
}

static size_t gated_mean_smem(const GpryKern& kern, int d) {
  return sizeof(double) *
         ((size_t)d + 2 * (size_t)d * K1_THREADS + (size_t)K1_TILE * d +
          K1_TILE + gpry_spec_doubles(kern));
}

// Shared memory of the block-per-query design (if svm_mode does not read
// the support vectors, they are not staged).
extern "C" size_t gpry_gated_mean_small_smem(GpryKern kern, int n, int nsv,
                                             int d, int svm_mode) {
  const int nsv_eff = svm_mode == GPRY_MODE_FITTED ? nsv : 0;
  return sizeof(double) *
         (gpry_staged_doubles(n, nsv_eff, d, gpry_spec_doubles(kern)) +
          gpry_eval_doubles(d));
}

// scal = [y_loc, y_scale, clip_max, svm intercept, svm gamma, y_max]
// design 0: tiled, one thread per query; 1: block per query.
extern "C" int gpry_gated_mean(GpryKern kern, int design, int nq, int n,
                               int nsv, int d, const void* Xq_raw,
                               const void* X, const void* alpha,
                               const void* theta, const void* x_loc,
                               const void* x_scale, const void* trust_lo,
                               const void* trust_hi, const void* sv,
                               const void* dual, const void* scal,
                               int svm_mode, void* out, void* stream) {
  if (nq <= 0) return 0;
  if (design == 1) {
    if (2 * d > GPRY_BLOCK_THREADS) return (int)cudaErrorInvalidValue;
    const size_t smem = gpry_gated_mean_small_smem(kern, n, nsv, d, svm_mode);
    auto kernel = kern.nodes ? gated_mean_small_kernel<true>
                             : gated_mean_small_kernel<false>;
    cudaError_t e = gpry_set_smem(kernel, smem);
    if (e != cudaSuccess) return (int)e;
    const dim3 grid(nq < K1_SMALL_GRID ? nq : K1_SMALL_GRID);
    kernel<<<grid, GPRY_BLOCK_THREADS, smem, (cudaStream_t)stream>>>(
        kern, nq, n, nsv, d, (const double*)Xq_raw, (const double*)X,
        (const double*)alpha, (const double*)theta, (const double*)x_loc,
        (const double*)x_scale, (const double*)trust_lo,
        (const double*)trust_hi, (const double*)sv, (const double*)dual,
        (const double*)scal, svm_mode, (double*)out);
    return (int)cudaGetLastError();
  }
  const size_t smem = gated_mean_smem(kern, d);
  auto kernel = kern.nodes ? gated_mean_kernel<true> : gated_mean_kernel<false>;
  cudaError_t e = gpry_set_smem(kernel, smem);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid((nq + K1_THREADS - 1) / K1_THREADS);
  kernel<<<grid, K1_THREADS, smem, (cudaStream_t)stream>>>(
      kern, nq, n, nsv, d, (const double*)Xq_raw, (const double*)X,
      (const double*)alpha, (const double*)theta, (const double*)x_loc,
      (const double*)x_scale, (const double*)trust_lo,
      (const double*)trust_hi, (const double*)sv, (const double*)dual,
      (const double*)scal, svm_mode, (double*)out);
  return (int)cudaGetLastError();
}
