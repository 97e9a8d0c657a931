// K14: one shard's partial of the training-axis (TP) sharded predict.
//
// Replaces the `local` body of gpry_tpu/parallel/mesh.py:188-199
// (_tp_predict_raw): the training rows are split over the mesh, and each
// shard of nloc rows starting at row0 computes
//
//   (a) tp_cross_mean: K_shard[i][q] = [row0 + i < n] k(x_i, xq_q) (the
//       cross form: a WhiteKernel counts zero) and mean_part[q] =
//       sum_i K_shard[i][q] alpha_i;
//   (b) tp_quad: quad_part[q] = sum_i K_shard[i][q] (M_shard k_full)[i][q],
//       with M_shard the shard's rows of K^-1 (nloc x nmax) and k_full
//       (nmax x nq) every shard's K_shard gathered in row order,
//
// so that the caller's sums over shards give the GP mean k^T alpha and
// the quadratic form k^T K^-1 k of sigma^2 = prior - k^T K^-1 k.
//
// What bounds it on the H100: (a) evaluates nloc x nq covariances
// (operations; tiny at the TP route's nq < 256); (b) reads M_shard once,
// 8 nloc nmax bytes (2 MB at nloc 256, nmax 1,024), and does 2 nloc nmax
// nq operations (33.5 MFLOP at nq 64): about balanced at nq 64, bytes
// below.  Design (simple, for correctness first):
//
// (a) one block of K14_THREADS a query: the threads take the rows in
//     turn (i = tid, tid + T, ...), write K_shard's column and sum
//     alpha_i k in that order; the warps' sums meet by the xor butterfly
//     and warp 0 adds the K14_THREADS / 32 of them in warp order.  No
//     atomics: a rerun gives the same bits.  The fast families divide
//     each coordinate by its length scale (x / l, as the plain version's
//     _scaled_sqdist); the spec instance runs the interpreter of
//     common.cuh on the coordinates as they are.
// (b) one block a panel of K14_QROWS rows of M_shard: a thread holds one
//     query of a chunk of K14_QLANES and the K14_QROWS row sums for one
//     of K14_QSPLIT interleaved slices of the contraction, so that a
//     warp's M loads are one broadcast address and its k_full loads one
//     coalesced row; the slices meet in shared memory in slice order, the
//     rows in row order, and the block writes its panel's partial per
//     query.  (M_shard k_full) never reaches global memory: only the
//     panels' partials do, and a second kernel sums them per query in
//     panel order.  M is read once from device memory (a panel's rows
//     stay in L2 across the query chunks of nq > K14_QLANES).
#include "common.cuh"

#define K14_THREADS 128
#define K14_QROWS 8
#define K14_QLANES 64
#define K14_QSPLIT 4
#define K14_QTHREADS (K14_QLANES * K14_QSPLIT)

template <bool SPEC>
__global__ void __launch_bounds__(K14_THREADS)
tp_cross_mean_kernel(const GpryKern kern, int nloc, int nq, int d, int row0,
                     int n, const double* __restrict__ X,
                     const double* __restrict__ alpha,
                     const double* __restrict__ Xq,
                     const double* __restrict__ theta,
                     double* __restrict__ K, double* __restrict__ mean) {
  // shared: the spec program (SPEC) | the query | the length scales
  extern __shared__ double smem[];
  __shared__ double warp_sum[K14_THREADS / 32];
  const int tid = threadIdx.x, q = blockIdx.x;
  GprySpec spec;
  if constexpr (SPEC) spec = gpry_stage_spec(smem, kern, theta, tid,
                                             K14_THREADS);
  double* xq = smem + gpry_spec_doubles(kern);
  double* ls = xq + d;
  for (int k = tid; k < d; k += K14_THREADS) {
    if constexpr (SPEC) {
      xq[k] = Xq[(size_t)q * d + k];
    } else {
      ls[k] = exp(theta[1 + k]);
      xq[k] = Xq[(size_t)q * d + k] / ls[k];
    }
  }
  __syncthreads();
  const double variance = SPEC ? 1.0 : exp(theta[0]);
  double acc = 0.0;
  for (int i = tid; i < nloc; i += K14_THREADS) {
    double v = 0.0;
    if (row0 + i < n) {
      const double* xi = X + (size_t)i * d;
      if constexpr (SPEC) {
        v = gpry_spec_cov(spec, xi, 1, xq, 1, d);
      } else {
        double sq = 0.0;
        for (int k = 0; k < d; ++k) {
          const double df = xi[k] / ls[k] - xq[k];
          sq += df * df;
        }
        v = variance * gpry_k_of_sq(kern.family, sq);
      }
    }
    K[(size_t)i * nq + q] = v;
    acc += v * alpha[i];
  }
  acc = gpry_warp_sum(acc);
  if ((tid & 31) == 0) warp_sum[tid >> 5] = acc;
  __syncthreads();
  if (tid == 0) {
    double s = 0.0;
    for (int w = 0; w < K14_THREADS / 32; ++w) s += warp_sum[w];
    mean[q] = s;
  }
}

// Block b: rows b K14_QROWS.. of M_shard (nloc x nmax, row-major), k_full
// (nmax x nq), K_shard (nloc x nq); partial[b][q] = sum over the panel's
// rows r of K_shard[r][q] (M_shard k_full)[r][q].
__global__ void __launch_bounds__(K14_QTHREADS)
tp_quad_kernel(int nloc, int nmax, int nq, const double* __restrict__ M,
               const double* __restrict__ kf,
               const double* __restrict__ Ks, double* __restrict__ partial) {
  __shared__ double red[K14_QSPLIT][K14_QLANES];
  const int tid = threadIdx.x;
  const int lane_q = tid % K14_QLANES, s = tid / K14_QLANES;
  const int r0 = blockIdx.x * K14_QROWS;
  const int rows = min(K14_QROWS, nloc - r0);
  const double* Mp = M + (size_t)r0 * nmax;
  for (int qc = 0; qc < nq; qc += K14_QLANES) {
    const int q = qc + lane_q;
    const bool live = q < nq;
    double acc[K14_QROWS];
#pragma unroll
    for (int r = 0; r < K14_QROWS; ++r) acc[r] = 0.0;
    if (live) {
#pragma unroll 4
      for (int j = s; j < nmax; j += K14_QSPLIT) {
        const double kv = kf[(size_t)j * nq + q];
#pragma unroll
        for (int r = 0; r < K14_QROWS; ++r)
          if (r < rows) acc[r] += Mp[(size_t)r * nmax + j] * kv;
      }
    }
    double part = 0.0;
#pragma unroll
    for (int r = 0; r < K14_QROWS; ++r)
      if (live && r < rows) part += Ks[(size_t)(r0 + r) * nq + q] * acc[r];
    red[s][lane_q] = part;
    __syncthreads();
    if (s == 0 && live) {
      double t = red[0][lane_q];
      for (int k = 1; k < K14_QSPLIT; ++k) t += red[k][lane_q];
      partial[(size_t)blockIdx.x * nq + q] = t;
    }
    __syncthreads();
  }
}

// quad[q] = sum_b partial[b][q], b in panel order.
__global__ void __launch_bounds__(K14_THREADS)
tp_quad_sum_kernel(int panels, int nq, const double* __restrict__ partial,
                   double* __restrict__ quad) {
  const int q = blockIdx.x * K14_THREADS + threadIdx.x;
  if (q >= nq) return;
  double t = 0.0;
  for (int b = 0; b < panels; ++b) t += partial[(size_t)b * nq + q];
  quad[q] = t;
}

// X (nloc, d), alpha (nloc), Xq (nq, d), theta (kern.ntheta); outputs
// K_shard (nloc, nq) and mean_part (nq).
extern "C" int gpry_tp_cross_mean(GpryKern kern, int nloc, int nq, int d,
                                  int row0, int n, const void* X,
                                  const void* alpha, const void* Xq,
                                  const void* theta, void* K_out,
                                  void* mean_out, void* stream) {
  if (nloc < 0 || nq < 0 || d <= 0) return (int)cudaErrorInvalidValue;
  if (nq == 0) return 0;
  const bool spec = kern.nodes > 0;
  const size_t smem = (gpry_spec_doubles(kern) + 2 * (size_t)d) *
                      sizeof(double);
  auto kernel = spec ? tp_cross_mean_kernel<true>
                     : tp_cross_mean_kernel<false>;
  cudaError_t e = gpry_set_smem(kernel, smem);
  if (e != cudaSuccess) return (int)e;
  kernel<<<nq, K14_THREADS, smem, (cudaStream_t)stream>>>(
      kern, nloc, nq, d, row0, n, (const double*)X, (const double*)alpha,
      (const double*)Xq, (const double*)theta, (double*)K_out,
      (double*)mean_out);
  return (int)cudaGetLastError();
}

// The panels tp_quad's first kernel writes (the rows of its workspace).
extern "C" int gpry_tp_quad_panels(int nloc) {
  return (nloc + K14_QROWS - 1) / K14_QROWS;
}

// M (nloc, nmax), k_full (nmax, nq), K_shard (nloc, nq); work
// gpry_tp_quad_panels(nloc) x nq doubles; output quad_part (nq).
extern "C" int gpry_tp_quad(int nloc, int nmax, int nq, const void* M,
                            const void* k_full, const void* K_shard,
                            void* work, void* quad_out, void* stream) {
  if (nloc < 0 || nmax < 0 || nq < 0) return (int)cudaErrorInvalidValue;
  if (nq == 0) return 0;
  const int panels = gpry_tp_quad_panels(nloc);
  if (panels > 0) {
    tp_quad_kernel<<<panels, K14_QTHREADS, 0, (cudaStream_t)stream>>>(
        nloc, nmax, nq, (const double*)M, (const double*)k_full,
        (const double*)K_shard, (double*)work);
    cudaError_t e = cudaGetLastError();
    if (e != cudaSuccess) return (int)e;
  }
  tp_quad_sum_kernel<<<(nq + K14_THREADS - 1) / K14_THREADS, K14_THREADS, 0,
                       (cudaStream_t)stream>>>(panels, nq,
                                               (const double*)work,
                                               (double*)quad_out);
  return (int)cudaGetLastError();
}

// The device this library's CUDA runtime launches on (the wrappers hold
// it against torch's current device the first time they launch there).
extern "C" int gpry_current_device(void) {
  int dev = -1;
  if (cudaGetDevice(&dev) != cudaSuccess) return -1;
  return dev;
}
