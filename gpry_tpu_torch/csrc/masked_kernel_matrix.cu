// K3 masked_kernel_matrix_batched: the padded training covariance for R
// hyperparameter vectors at once, whole or as a panel of its rows.
//
// Replaces gpry_tpu/ops/linalg.py:34 masked_kernel_matrix as vmapped by
// gpry_tpu/models/gp.py:188 _lml_batch (and used by factorize, linalg.py:69,
// and the blocks of chol_append, linalg.py:82, which the reference builds
// as cross_kernel(X, X_new) and cross_kernel(X_new, X_new), :104 and :113):
//
//   K[r, i, j] = s2_r k(r_ij)                     i, j < n
//              + (noise_i + rel_jitter * s2_r)     i == j < n
//   K[r, i, i] = 1                                 i >= n   (padding)
//   K[r, i, j] = 0                                 otherwise
//
// so that chol(K) = [[L_valid, 0], [0, I]].  A row panel [r0, r1) is
// rows r0..r1-1 of that matrix, (R, r1 - r0, nmax), the diagonal and the
// noise indexed by the global row: an append of k points builds only its
// k new rows (K21 = P[:, :n], K12 its transpose, K22 = P[:, n:n+k]).
//
// What bounds it on the H100.  The output: R nmax^2 float64 values, 1.68 GB
// at the fit screen's R = 2,048 and nmax = 320, written once, so the store
// bandwidth; the float64 exp per element is the second bound.  On the
// paths it runs at R = 1 (nmax 64-320: 100 tiles, one partial wave) or as
// a panel of 1-8 rows, where a launch is latency: the staging's loads, the
// block barrier, the stores.
//
// Design.  A block of 32 x 8 threads owns one 32 x 32 tile of one lane r
// (grid.y); each thread computes four entries, the writes coalesced along
// j.  One kernel serves the whole matrix and a panel: it launches the row
// tiles built (all of them for the whole matrix) times the column tiles. A
// tile wholly in the padding (its rows or its columns at or beyond n)
// writes its ones and zeros with no staging and no arithmetic.  The others
// stage their row and column points (the column points transposed, so that
// a warp reads consecutive words) by plain loads, the first of each side
// issued before theta's, each point divided by its length scale on its way
// into shared memory (an exp of theta per thread, computed once where d
// divides 256: a thread's points then share one coordinate), so the first
// store follows one block barrier.  A fast family stores its four entries
// after their exponentials; a spec program stores each as the interpreter
// returns it.  (These choices, and cp.async staging, were timed against
// each other by profile_kernel_designs.py --k3.)  The division stays a
// division: x / l, as the plain version computes it, not x * (1 / l), which
// rounds otherwise.  (a - b)^2 is symmetric and the sum over k runs in the
// same order, so K(j, i) is K(i, j) bit for bit, and a panel's rows are the
// whole matrix's: the new rows of an append give its two blocks.
//
// Spec mode (template SPEC): each block stages its lane's theta row into
// the spec program's exp(+-theta) (the program's offsets index that row),
// stages the tile's points as they are, and runs the interpreter of
// common.cuh.  The diagonal is restored to k(x_i, x_i) (gpry_spec_diag), as
// gpry_tpu/ops/linalg.py:44-47 does: the WhiteKernel term enters the matrix
// only there.  The jitter scales with exp(theta_r[0]), as in the JAX
// package, whatever the first parameter is.
#include "common.cuh"

#define K3_TILE 32
#define K3_ROWS 8
#define K3_THREADS (K3_TILE * K3_ROWS)

struct K3Args {
  GpryKern kern;
  int nmax, n, d, r0, r1;
  const double *thetas, *X, *noise;
  int noise_is_vec;
  double rel_jitter;
  double* out;
};

// Rows r0..r1-1 of lane blockIdx.y: row tile bi, column tile bj,
// row-major over the rows built.
template <bool SPEC>
__global__ void __launch_bounds__(K3_THREADS)
masked_kernel_matrix_kernel(const K3Args a) {
  // shared layout: spec program (SPEC) | A[TILE][d] | Bt[d][TILE]
  extern __shared__ double smem[];
  const int tx = threadIdx.x, ty = threadIdx.y;
  const int tid = ty * K3_TILE + tx;
  const int nmax = a.nmax, n = a.n, d = a.d, r0 = a.r0, r1 = a.r1;
  const int ntc = (nmax + K3_TILE - 1) / K3_TILE;
  const int bi = blockIdx.x / ntc, bj = blockIdx.x - bi * ntc;
  const int i0 = r0 + bi * K3_TILE, j0 = bj * K3_TILE, j = j0 + tx;
  const int r = blockIdx.y;
  double* out_r = a.out + (size_t)r * (r1 - r0) * nmax;

  if (i0 >= n || j0 >= n) {
    // wholly padding: a diagonal entry here is one of rows >= n
    for (int ii = ty; ii < K3_TILE; ii += K3_ROWS) {
      const int i = i0 + ii;
      if (i < r1 && j < nmax)
        out_r[(size_t)(i - r0) * nmax + j] = i == j ? 1.0 : 0.0;
    }
    return;
  }

  const double* th = a.thetas + (size_t)r * a.kern.ntheta;
  double* A = smem + gpry_spec_doubles(a.kern);
  double* Bt = A + K3_TILE * d;
  // the valid row points (below n and inside the rows built) and columns
  const int ilim = min(n, r1);
  const int in = max(0, min(i0 + K3_TILE, ilim) - i0);
  const int jn = min(j0 + K3_TILE, n) - j0;
  const double* Xi = a.X + (size_t)i0 * d;
  const double* Xj = a.X + (size_t)j0 * d;
  // the amplitude's and the diagonal's loads, in flight with the staging;
  // this thread's entries lie in column j: a diagonal one is there
  const double th0 = th[0];
  const double nz = a.noise_is_vec ? a.noise[min(j, nmax - 1)]
                                   : a.noise[0];
  GprySpec spec;
  if constexpr (SPEC) spec = gpry_stage_spec(smem, a.kern, th, tid,
                                             K3_THREADS);
  // the points over the length scales (a spec program's as they are):
  // this thread's first coordinate of each side loaded before theta's
  // (all of them for d <= 8), its first length scale before the loops, a
  // new one only where its coordinate changes
  const double xa0 = tid < in * d ? Xi[tid] : 0.0;
  const double xb0 = tid < jn * d ? Xj[tid] : 0.0;
  int kl = tid % d;
  double lk = SPEC ? 1.0 : exp(th[1 + kl]);
  for (int idx = tid; idx < in * d; idx += K3_THREADS) {
    const int k = idx % d;
    if (!SPEC && k != kl) {
      lk = exp(th[1 + k]);
      kl = k;
    }
    const double x = idx == tid ? xa0 : Xi[idx];
    A[idx] = SPEC ? x : x / lk;
  }
  for (int idx = tid; idx < jn * d; idx += K3_THREADS) {
    const int t = idx / d, k = idx - t * d;
    if (!SPEC && k != kl) {
      lk = exp(th[1 + k]);
      kl = k;
    }
    const double x = idx == tid ? xb0 : Xj[idx];
    Bt[k * K3_TILE + t] = SPEC ? x : x / lk;
  }
  __syncthreads();

  const double variance = exp(th0);
  const int family = a.kern.family;
  double v[K3_TILE / K3_ROWS];
#pragma unroll
  for (int s = 0; s < K3_TILE / K3_ROWS; ++s) {
    const int ii = ty + K3_ROWS * s, i = i0 + ii;
    double val = 0.0;
    if (i < ilim && j < n) {
      if constexpr (SPEC) {
        val = i == j ? gpry_spec_diag(spec, A + ii * d, 1, d)
                     : gpry_spec_cov(spec, A + ii * d, 1, Bt + tx, K3_TILE,
                                     d);
      } else {
        double sq = 0.0;
        for (int k = 0; k < d; ++k) {
          const double df = A[ii * d + k] - Bt[k * K3_TILE + tx];
          sq += df * df;
        }
        val = variance * gpry_k_of_sq(family, sq);
      }
    }
    if (i == j) val += (i < n) ? (nz + a.rel_jitter * variance) : 1.0;
    if constexpr (SPEC) {
      // stored at once: no value is held across the interpreter's calls
      if (i < r1 && j < nmax) out_r[(size_t)(i - r0) * nmax + j] = val;
    } else {
      v[s] = val;
    }
  }
  // the tile's stores (a fast family's, after its four entries' exps)
  if constexpr (!SPEC) {
#pragma unroll
    for (int s = 0; s < K3_TILE / K3_ROWS; ++s) {
      const int i = i0 + ty + K3_ROWS * s;
      if (i < r1 && j < nmax) out_r[(size_t)(i - r0) * nmax + j] = v[s];
    }
  }
}

// thetas: R rows of kern.ntheta entries; out: R x (r1 - r0) x nmax, rows
// r0..r1-1 of each matrix (0, nmax: the whole one).
extern "C" int gpry_masked_kernel_matrix(GpryKern kern, int R, int nmax,
                                         int n, int d, int r0, int r1,
                                         const void* thetas, const void* X,
                                         const void* noise, int noise_is_vec,
                                         double rel_jitter, void* out,
                                         void* stream) {
  if (R > 65535 || r0 < 0 || r1 > nmax || r0 > r1)
    return (int)cudaErrorInvalidValue;
  K3Args a;
  a.kern = kern;
  a.nmax = nmax;
  a.n = n;
  a.d = d;
  a.r0 = r0;
  a.r1 = r1;
  a.thetas = (const double*)thetas;
  a.X = (const double*)X;
  a.noise = (const double*)noise;
  a.noise_is_vec = noise_is_vec;
  a.rel_jitter = rel_jitter;
  a.out = (double*)out;
  const size_t smem =
      sizeof(double) * (gpry_spec_doubles(kern) + 2 * (size_t)K3_TILE * d);
  auto kernel = kern.nodes ? masked_kernel_matrix_kernel<true>
                           : masked_kernel_matrix_kernel<false>;
  cudaError_t e = gpry_set_smem(kernel, smem);
  if (e != cudaSuccess) return (int)e;
  if (R <= 0 || r1 == r0) return 0;
  const int nt = (nmax + K3_TILE - 1) / K3_TILE;
  const dim3 grid((r1 - r0 + K3_TILE - 1) / K3_TILE * nt, R),
      block(K3_TILE, K3_ROWS);
  kernel<<<grid, block, smem, (cudaStream_t)stream>>>(a);
  return (int)cudaGetLastError();
}
