// K3 masked_kernel_matrix_batched: the padded training covariance for R
// hyperparameter vectors at once.
//
// Replaces gpry_tpu/ops/linalg.py:34 masked_kernel_matrix as vmapped by
// gpry_tpu/models/gp.py:188 _lml_batch (and used by factorize, linalg.py:69,
// and the blocks of chol_append, linalg.py:82):
//
//   K[r, i, j] = s2_r k(r_ij)                     i, j < n
//              + (noise_i + rel_jitter * s2_r)     i == j < n
//   K[r, i, i] = 1                                 i >= n   (padding)
//   K[r, i, j] = 0                                 otherwise
//
// so that chol(K) = [[L_valid, 0], [0, I]].
//
// Design.  A block of 32 x 8 threads writes one 32 x 32 tile of one lane r:
// it loads the tile's 32 row points and 32 column points, divided by that
// lane's length scales, into shared memory (the column points transposed,
// so that the 32 threads of a warp read consecutive words), then each thread
// computes four elements.  Writes are coalesced along j.
//
// What bounds it on the H100.  The output: R nmax^2 float64 values, 1.68 GB
// at the fit screen's R = 2,048 and nmax = 320, written once, so the store
// bandwidth; the float64 exp per element is the second bound.  The masked
// padding is written without any arithmetic.
#include "common.cuh"

#define K3_TILE 32
#define K3_ROWS 8

__global__ void masked_kernel_matrix_kernel(
    int family, int nmax, int n, int d, const double* __restrict__ thetas,
    const double* __restrict__ X, const double* __restrict__ noise,
    int noise_is_vec, double rel_jitter, double* __restrict__ out) {
  // shared layout: ls[d] | A[TILE][d] | Bt[d][TILE]
  extern __shared__ double smem[];
  double* ls = smem;
  double* A = ls + d;
  double* Bt = A + K3_TILE * d;

  const int r = blockIdx.z;
  const int i0 = blockIdx.y * K3_TILE, j0 = blockIdx.x * K3_TILE;
  const int tx = threadIdx.x, ty = threadIdx.y;
  const int tid = ty * K3_TILE + tx;
  const double* th = thetas + (size_t)r * (d + 1);

  for (int k = tid; k < d; k += K3_TILE * K3_ROWS) ls[k] = exp(th[1 + k]);
  __syncthreads();
  const double variance = exp(th[0]);

  for (int idx = tid; idx < K3_TILE * d; idx += K3_TILE * K3_ROWS) {
    const int t = idx / d, k = idx - t * d;
    const int i = i0 + t, j = j0 + t;
    A[idx] = (i < n) ? X[(size_t)i * d + k] / ls[k] : 0.0;
    Bt[k * K3_TILE + t] = (j < n) ? X[(size_t)j * d + k] / ls[k] : 0.0;
  }
  __syncthreads();

  const int j = j0 + tx;
  if (j >= nmax) return;
  double* out_r = out + (size_t)r * nmax * nmax;
  for (int ii = ty; ii < K3_TILE; ii += K3_ROWS) {
    const int i = i0 + ii;
    if (i >= nmax) break;
    double v = 0.0;
    if (i < n && j < n) {
      double sq = 0.0;
      for (int k = 0; k < d; ++k) {
        const double df = A[ii * d + k] - Bt[k * K3_TILE + tx];
        sq += df * df;
      }
      v = variance * gpry_k_of_sq(family, sq);
    }
    if (i == j) {
      const double nz = noise_is_vec ? noise[i] : noise[0];
      v += (i < n) ? (nz + rel_jitter * variance) : 1.0;
    }
    out_r[(size_t)i * nmax + j] = v;
  }
}

static size_t masked_kernel_matrix_smem(int d) {
  return sizeof(double) * ((size_t)d + 2 * (size_t)K3_TILE * d);
}

extern "C" int gpry_masked_kernel_matrix(int family, int R, int nmax, int n,
                                         int d, const void* thetas,
                                         const void* X, const void* noise,
                                         int noise_is_vec, double rel_jitter,
                                         void* out, void* stream) {
  const size_t smem = masked_kernel_matrix_smem(d);
  cudaError_t e = gpry_set_smem(masked_kernel_matrix_kernel, smem);
  if (e != cudaSuccess) return (int)e;
  if (R <= 0 || nmax <= 0) return 0;
  const int nt = (nmax + K3_TILE - 1) / K3_TILE;
  const dim3 grid(nt, nt, R), block(K3_TILE, K3_ROWS);
  masked_kernel_matrix_kernel<<<grid, block, smem, (cudaStream_t)stream>>>(
      family, nmax, n, d, (const double*)thetas, (const double*)X,
      (const double*)noise, noise_is_vec, rel_jitter, (double*)out);
  return (int)cudaGetLastError();
}
