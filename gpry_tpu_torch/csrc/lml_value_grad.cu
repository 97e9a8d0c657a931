// K10 lml_value_grad: the log marginal likelihood of R hyperparameter rows
// (and, in GRAD mode, its gradient in theta), without any R x nmax^2
// tensor.
//
// Replaces gpry_tpu/models/gp.py:189 _lml_batch / :196 _lml_batch_chunked
// (jax.vmap of gpry_tpu/ops/linalg.py:139 masked_lml over the rows, on
// :34 masked_kernel_matrix): the fit's LML screen over max(8 n_restarts,
// 2,048) candidates, the exact re-score of the polished endpoints and
// log_marginal_likelihood; in GRAD mode the value and gradient that the
// fit's L-BFGS needs (jax.value_and_grad of masked_lml).
//
// Design.  One block of GPRY_LML_THREADS per theta row, as many blocks as
// the wrapper gives (about two per SM): each loops over the rows r =
// blockIdx.x, blockIdx.x + gridDim.x, ..., reusing its own scratch, so the
// memory does not grow with R.  Each row is gpry_block_lml of common.cuh:
// the n x n valid block of K with y bordered below it, packed by rows in
// shared memory where it fits (n up to ~230; the block then holds its SM's
// shared memory alone), else in the block's workspace in global memory; a
// right-looking elimination with one block barrier per column that yields
// L and z = L^-1 y together; in GRAD mode L^-1 in place, alpha and the
// contraction of W = alpha alpha^T - K^-1 with the tangents of K in theta.
//
// What bounds it on the H100.  Per row n dependent elimination steps, each
// a block barrier over a shrinking trailing triangle: latency.  The FP64
// operations (n^3 / 3 for the factor, n^2 for the pair build; with GRAD
// about 2 n^3 / 3 more for L^-1 and K^-1 and p n^2 for the contraction)
// take well under a microsecond per row at n = 224 at 67 TFLOP/s, and the
// bytes (theta in, one value out) are nothing: the bound is operations.
//
// Spec mode (template SPEC): the interpreter of common.cuh builds K; the
// gradient is its forward mode in theta (gpry_spec_dtheta).
#include "common.cuh"

template <bool SPEC, bool GRAD>
__global__ void __launch_bounds__(GPRY_LML_THREADS) lml_value_grad_kernel(
    GpryKern kern, int R, GpryLmlData D, int in_smem,
    const double* __restrict__ thetas, double* __restrict__ work,
    size_t work_per_block, double* __restrict__ lml_out,
    double* __restrict__ grad_out) {
  extern __shared__ double smem[];
  double* w = work + (size_t)blockIdx.x * work_per_block;
  const int p = kern.ntheta;
  for (int r = blockIdx.x; r < R; r += gridDim.x) {
    const double v = gpry_block_lml<SPEC, GRAD>(
        kern, D, thetas + (size_t)r * p, w, smem, in_smem != 0,
        GRAD ? grad_out + (size_t)r * p : nullptr);
    if (threadIdx.x == 0) lml_out[r] = v;
  }
}

// Global doubles of one block's workspace.
extern "C" size_t gpry_lml_work_per_block(GpryKern kern, int n, int d) {
  return gpry_lml_work_doubles(
      n, d, gpry_lml_in_smem(n, d, gpry_spec_doubles(kern), 0));
}

// thetas (R, kern.ntheta); X (>= n rows, d); y (>= n); noise one value or
// one per row; work blocks x gpry_lml_work_per_block doubles; grad_out
// (R, kern.ntheta) when grad.
extern "C" int gpry_lml_value_grad(GpryKern kern, int R, int n, int d,
                                   int grad, int blocks, const void* thetas,
                                   const void* X, const void* y,
                                   const void* noise, int noise_is_vec,
                                   double rel_jitter, void* work,
                                   void* lml_out, void* grad_out,
                                   void* stream) {
  if (R < 0 || n < 0 || blocks < 1 || (grad && !grad_out))
    return (int)cudaErrorInvalidValue;
  if (R == 0) return 0;
  const size_t spec = gpry_spec_doubles(kern);
  const bool in_smem = gpry_lml_in_smem(n, d, spec, 0);
  const size_t smem =
      sizeof(double) * gpry_lml_smem_doubles(n, d, spec, in_smem);
  if (smem > GPRY_MAX_SMEM) return (int)cudaErrorInvalidConfiguration;
  auto kernel = kern.nodes ? (grad ? lml_value_grad_kernel<true, true>
                                   : lml_value_grad_kernel<true, false>)
                           : (grad ? lml_value_grad_kernel<false, true>
                                   : lml_value_grad_kernel<false, false>);
  cudaError_t e = gpry_set_smem(kernel, smem);
  if (e != cudaSuccess) return (int)e;
  GpryLmlData D;
  D.n = n;
  D.d = d;
  D.noise_is_vec = noise_is_vec;
  D.X = (const double*)X;
  D.y = (const double*)y;
  D.noise = (const double*)noise;
  D.rel_jitter = rel_jitter;
  kernel<<<blocks < R ? blocks : R, GPRY_LML_THREADS, smem,
           (cudaStream_t)stream>>>(kern, R, D, (int)in_smem,
                                   (const double*)thetas, (double*)work,
                                   gpry_lml_work_doubles(n, d, in_smem),
                                   (double*)lml_out, (double*)grad_out);
  return (int)cudaGetLastError();
}
