// K8 meanstd_grad: the raw-space GP mean and latent std, with no gate and
// no clip, and their gradients in the raw coordinates, at nq points.
//
// Replaces the jax.vmap(jax.jacfwd(surrogate_mean_std_smooth)) of
// gpry_tpu/models/gp.py:1272-1279 (predict(return_mean_grad=,
// return_std_grad=)), and serves the autograd of
// surrogate_mean_std_smooth on the card (models/gp.py):
//
//   x'   = (x - x_loc) / x_scale,  k_j = k(x', X_j) over the n valid rows
//   mean = k . alpha * y_scale + y_loc
//   var  = prior(x') - |L^-1 k|^2,  std = sqrt(max(var, 0)) * y_scale
//   d mean / dx = y_scale sum_j alpha_j dk_j/dx' / x_scale
//   d std / dx  = y_scale / (2 sqrt(max(var, 0))) d var/dx' / x_scale
//                 (0 where var < 0, as torch's clamp_min gradient), with
//   d var / dx' = d prior/dx' - 2 sum_j w_j dk_j/dx',  w = L^-T L^-1 k.
//
// Design: one block of 128 threads per query (grid-stride over the
// queries), the block routine gpry_block_meanvar_grad of common.cuh: the
// surrogate (X / l, alpha, a work vector) staged in shared memory once per
// block, the threads split the rows for k and its gradient and reduce 1
// and 2 d sums, one warp runs the forward and the back substitution
// against L in global memory.  Above 48 KB of shared memory the kernel
// opts in (gpry_set_smem); beyond the 227 KB a block holds, X is read from
// global memory.
//
// What bounds it on the H100.  Per query 2 n^2 / 2 multiply-adds of the
// two substitutions and about n (5 d + 3) for k and its gradient: 1.1e8
// FP64 operations at nq = 1,024, n = 224, d = 8, 1.7 us at 67 TFLOP/s.
// The two substitutions are chains of n dependent warp steps (a reduction
// for the forward one, a barrier for the back one), so latency, not the
// FP64 rate, bounds each query; 1,024 queries give about 8 blocks per SM.
//
// Spec mode (template SPEC): k comes from the interpreter of common.cuh,
// its gradient from the interpreter's forward mode (gpry_spec_grad), and
// the prior and its gradient (DotProduct only) from its diagonal program.
#include "common.cuh"

template <bool SPEC>
__global__ void __launch_bounds__(GPRY_BLOCK_THREADS) meanstd_grad_kernel(
    GpryKern kern, int nq, int n, int nmax, int d, int stage_x,
    const double* __restrict__ Xq_raw, const double* __restrict__ X,
    const double* __restrict__ alpha, const double* __restrict__ L,
    const double* __restrict__ theta, const double* __restrict__ x_loc,
    const double* __restrict__ x_scale, const double* __restrict__ scal,
    double* __restrict__ mean_out, double* __restrict__ std_out,
    double* __restrict__ gmean_out, double* __restrict__ gstd_out) {
  extern __shared__ double smem[];
  const int tid = threadIdx.x;
  GprySpec spec;
  double* q;
  const GpryGP g = gpry_stage_gp<SPEC>(smem, kern, n, nmax, d, stage_x != 0,
                                       X, alpha, L, theta, x_loc, x_scale,
                                       &spec, &q);
  const double y_loc = scal[0], y_scale = scal[1];
  for (int b = blockIdx.x; b < nq; b += gridDim.x) {
    if (tid < d)
      q[tid] = (Xq_raw[(size_t)b * d + tid] - g.x_loc[tid]) /
               g.x_scale[tid] / g.ls[tid];
    __syncthreads();
    gpry_block_meanvar_grad<SPEC, true>(g, spec, q);
    const double var_raw = g.res[1];
    const double var = (var_raw < 0.0) ? 0.0 : var_raw;  // NaN stays NaN
    const double sd = sqrt(var);
    if (tid == 0) {
      mean_out[b] = g.res[0] * y_scale + y_loc;
      std_out[b] = sd * y_scale;
    }
    if (tid < d) {
      // torch: the std's gradient y_scale / (2 sqrt(var)) passes the
      // clamp only where var_raw >= 0
      const double dsd = var_raw >= 0.0 ? y_scale / (2.0 * sd) : 0.0;
      gmean_out[(size_t)b * d + tid] =
          g.res[2 + tid] * y_scale / g.x_scale[tid];
      gstd_out[(size_t)b * d + tid] =
          dsd * g.res[2 + d + tid] / g.x_scale[tid];
    }
    __syncthreads();  // q and res serve the next query
  }
}

// scal = [y_loc, y_scale, ...] (the surrogate's packed gate scalars)
extern "C" int gpry_meanstd_grad(
    GpryKern kern, int nq, int n, int nmax, int d, const void* Xq_raw,
    const void* X, const void* alpha, const void* L, const void* theta,
    const void* x_loc, const void* x_scale, const void* scal,
    void* mean_out, void* std_out, void* gmean_out, void* gstd_out,
    void* stream) {
  if (d > GPRY_GRAD_MAX_D || nq < 0) return (int)cudaErrorInvalidValue;
  if (nq == 0) return 0;
  const size_t spec = gpry_spec_doubles(kern);
  bool stage_x = true;
  size_t smem = sizeof(double) * (gpry_gp_doubles(n, d, true, spec) + d);
  if (smem > GPRY_MAX_SMEM) {
    stage_x = false;
    smem = sizeof(double) * (gpry_gp_doubles(n, d, false, spec) + d);
  }
  if (smem > GPRY_MAX_SMEM) return (int)cudaErrorInvalidConfiguration;
  auto kernel = kern.nodes ? meanstd_grad_kernel<true>
                           : meanstd_grad_kernel<false>;
  cudaError_t e = gpry_set_smem(kernel, smem);
  if (e != cudaSuccess) return (int)e;
  int dev = 0, sms = 132;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  const int grid = nq < 4 * sms ? nq : 4 * sms;
  kernel<<<grid, GPRY_BLOCK_THREADS, smem, (cudaStream_t)stream>>>(
      kern, nq, n, nmax, d, (int)stage_x, (const double*)Xq_raw,
      (const double*)X, (const double*)alpha, (const double*)L,
      (const double*)theta, (const double*)x_loc, (const double*)x_scale,
      (const double*)scal, (double*)mean_out, (double*)std_out,
      (double*)gmean_out, (double*)gstd_out);
  return (int)cudaGetLastError();
}
