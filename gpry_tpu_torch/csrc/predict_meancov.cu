// K7 predict_meancov: the GP posterior mean and full covariance at nq
// query points.
//
// Replaces gpry_tpu/ops/linalg.py:172 predict_meancov, reached through
// gpry_tpu/models/gp.py:1254-1262 GaussianProcessRegressor.predict(
// return_cov=True).  In the GP's (preprocessed) coordinates, against the n
// valid training rows of the padded factor L (row-major, nmax x nmax):
//
//   Kq   = K(Xq, X[:n])                        (nq x n)
//   mean = Kq . alpha
//   V    = L^-1 Kq^T                           (n x nq)
//   cov  = K(Xq, Xq) - V^T V,  its diagonal k(x_i, x_i) - |V_i|^2
//
// where k(x_i, x_i) is the same-point variance (kernel_diag: a WhiteKernel
// term counts there and nowhere else, sklearn's semantics).
//
// Design: two kernels on one stream.
//  (a) meancov_solve_kernel: K5's body (meanvar_ungated.cu).  A block of 8
//      warps owns Q queries; all threads fill their k vectors in shared
//      memory, then one warp per query reduces k . alpha and runs the n
//      forward-substitution steps (gpry_warp_forward_subst), and writes the
//      solved column V_i to a scratch buffer (nq x n, row i = V_i).
//  (b) meancov_cov_kernel: a 32 x 8 block owns a 32 x 32 tile of cov; each
//      thread four entries of one column.  The tile's 32 + 32 rows of V are
//      streamed through shared memory in chunks of 32 training rows (padded
//      rows, so that the 32 lanes read distinct banks), the dot products
//      accumulate in registers, and the epilogue subtracts them from the
//      kernel covariance of the tile's two point sets, staged in shared
//      memory as K3 stages its tiles.
//
// The fast families and spec mode (template SPEC, the interpreter of
// common.cuh) share both kernels.
//
// What bounds it on the H100.  FP64 work: nq n^2 for the substitutions,
// 2 nq^2 n for V^T V, plus the kernel sums; at nq = 1,024, n = 224 about
// 0.52 GFLOP, ~8 us at 67 TFLOP/s; the output is nq^2 doubles (8.4 MB,
// 2.5 us at 3.35 TB/s).  Design (b) loads one V element from shared memory
// per multiply-add of a column (the row values are broadcasts), so shared
// memory bandwidth, not the FP64 rate, bounds it; (a) is a chain of n
// dependent warp reductions per query, as in K5.
#include "common.cuh"

#define K7_THREADS 256
#define K7_WARPS (K7_THREADS / 32)
#define K7_TILE 32
#define K7_ROWS 8
#define K7_TK 32
#define K7_LD (K7_TK + 1)

template <bool SPEC>
__global__ void meancov_solve_kernel(
    GpryKern kern, int nq, int n, int nmax, int d, int Q,
    const double* __restrict__ Xq, const double* __restrict__ X,
    const double* __restrict__ alpha, const double* __restrict__ L,
    const double* __restrict__ theta, double* __restrict__ V,
    double* __restrict__ mean_out) {
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

  for (int idx = tid; idx < nqb * d; idx += blockDim.x)
    qls[idx] = Xq[(size_t)q0 * d + idx] / ls[idx % d];
  __syncthreads();

  // k vectors of the block's queries against the n valid rows
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

  // one warp per query: the mean, the substitution, the column of V
  for (int qi = warp; qi < nqb; qi += K7_WARPS) {
    double* v = kv + (size_t)qi * n;
    double m = 0.0;
    for (int j = lane; j < n; j += 32) m += v[j] * alpha[j];
    m = gpry_warp_sum(m);
    gpry_warp_forward_subst(L, nmax, n, v, lane);
    double* Vq = V + (size_t)(q0 + qi) * n;
    for (int j = lane; j < n; j += 32) Vq[j] = v[j];
    if (lane == 0) mean_out[q0 + qi] = m;
  }
}

template <bool SPEC>
__global__ void meancov_cov_kernel(GpryKern kern, int nq, int n, int d,
                                   const double* __restrict__ Xq,
                                   const double* __restrict__ theta,
                                   const double* __restrict__ V,
                                   double* __restrict__ cov) {
  // shared layout: ls[d] | A[TILE][d] | Bt[d][TILE] | Vi[TILE][LD] |
  //                Vj[TILE][LD] | spec program (SPEC)
  extern __shared__ double smem[];
  double* ls = smem;
  double* A = ls + d;
  double* Bt = A + K7_TILE * d;
  double* Vi = Bt + K7_TILE * d;
  double* Vj = Vi + K7_TILE * K7_LD;

  const int i0 = blockIdx.y * K7_TILE, j0 = blockIdx.x * K7_TILE;
  const int tx = threadIdx.x, ty = threadIdx.y;
  const int tid = ty * K7_TILE + tx;
  const int nthreads = K7_TILE * K7_ROWS;
  const int family = kern.family;

  GprySpec spec;
  if constexpr (SPEC)
    spec = gpry_stage_spec(Vj + K7_TILE * K7_LD, kern, theta, tid, nthreads);
  for (int k = tid; k < d; k += nthreads)
    ls[k] = SPEC ? 1.0 : exp(theta[1 + k]);
  __syncthreads();
  const double variance = SPEC ? 1.0 : exp(theta[0]);
  for (int idx = tid; idx < K7_TILE * d; idx += nthreads) {
    const int t = idx / d, k = idx - t * d;
    const int i = i0 + t, j = j0 + t;
    A[idx] = (i < nq) ? Xq[(size_t)i * d + k] / ls[k] : 0.0;
    Bt[k * K7_TILE + t] = (j < nq) ? Xq[(size_t)j * d + k] / ls[k] : 0.0;
  }

  // (V^T V)[i, j] for the thread's four rows i and its column j
  double acc[K7_TILE / K7_ROWS] = {0.0, 0.0, 0.0, 0.0};
  for (int t0 = 0; t0 < n; t0 += K7_TK) {
    const int tk = min(K7_TK, n - t0);
    __syncthreads();
    for (int idx = tid; idx < K7_TILE * K7_TK; idx += nthreads) {
      const int r = idx / K7_TK, c = idx - r * K7_TK;
      const bool in = c < tk;
      Vi[r * K7_LD + c] =
          (in && i0 + r < nq) ? V[(size_t)(i0 + r) * n + t0 + c] : 0.0;
      Vj[r * K7_LD + c] =
          (in && j0 + r < nq) ? V[(size_t)(j0 + r) * n + t0 + c] : 0.0;
    }
    __syncthreads();
    for (int c = 0; c < tk; ++c) {
      const double vj = Vj[tx * K7_LD + c];
#pragma unroll
      for (int u = 0; u < K7_TILE / K7_ROWS; ++u)
        acc[u] += Vi[(ty + u * K7_ROWS) * K7_LD + c] * vj;
    }
  }
  __syncthreads();

  const int j = j0 + tx;
  if (j >= nq) return;
#pragma unroll
  for (int u = 0; u < K7_TILE / K7_ROWS; ++u) {
    const int ii = ty + u * K7_ROWS, i = i0 + ii;
    if (i >= nq) break;
    double kij;
    if constexpr (SPEC) {
      kij = i == j ? gpry_spec_diag(spec, A + ii * d, 1, d)
                   : gpry_spec_cov(spec, A + ii * d, 1, Bt + tx, K7_TILE, d);
    } else {
      double sq = 0.0;
      for (int k = 0; k < d; ++k) {
        const double df = A[ii * d + k] - Bt[k * K7_TILE + tx];
        sq += df * df;
      }
      kij = i == j ? variance : variance * gpry_k_of_sq(family, sq);
    }
    cov[(size_t)i * nq + j] = kij - acc[u];
  }
}

static size_t meancov_solve_smem(const GpryKern& kern, int n, int d, int Q) {
  return sizeof(double) * ((size_t)d + (size_t)Q * d + (size_t)Q * n +
                           gpry_spec_doubles(kern));
}

static size_t meancov_cov_smem(const GpryKern& kern, int d) {
  return sizeof(double) * ((size_t)d + 2 * (size_t)K7_TILE * d +
                           2 * (size_t)K7_TILE * K7_LD +
                           gpry_spec_doubles(kern));
}

// Xq (nq, d) preprocessed; X (nmax, d), alpha (nmax,), L (nmax, nmax)
// row-major; V scratch of nq * n doubles; outputs mean (nq,) and cov
// (nq, nq), both in the GP's coordinates.  Q: queries per block of (a).
extern "C" int gpry_predict_meancov(GpryKern kern, int nq, int n, int nmax,
                                    int d, int Q, const void* Xq,
                                    const void* X, const void* alpha,
                                    const void* L, const void* theta,
                                    void* V, void* mean, void* cov,
                                    void* stream) {
  if (nq <= 0) return 0;
  const size_t smem_a = meancov_solve_smem(kern, n, d, Q);
  auto solve = kern.nodes ? meancov_solve_kernel<true>
                          : meancov_solve_kernel<false>;
  cudaError_t e = gpry_set_smem(solve, smem_a);
  if (e != cudaSuccess) return (int)e;
  solve<<<(nq + Q - 1) / Q, K7_THREADS, smem_a, (cudaStream_t)stream>>>(
      kern, nq, n, nmax, d, Q, (const double*)Xq, (const double*)X,
      (const double*)alpha, (const double*)L, (const double*)theta,
      (double*)V, (double*)mean);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  const size_t smem_b = meancov_cov_smem(kern, d);
  auto covk = kern.nodes ? meancov_cov_kernel<true>
                         : meancov_cov_kernel<false>;
  e = gpry_set_smem(covk, smem_b);
  if (e != cudaSuccess) return (int)e;
  const int nt = (nq + K7_TILE - 1) / K7_TILE;
  covk<<<dim3(nt, nt), dim3(K7_TILE, K7_ROWS), smem_b,
         (cudaStream_t)stream>>>(kern, nq, n, d, (const double*)Xq,
                                 (const double*)theta, (const double*)V,
                                 (double*)cov);
  return (int)cudaGetLastError();
}
