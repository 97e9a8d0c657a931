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
// Design: two routes, chosen by the host side of this file (k8_plan,
// mirrored by ops/fused.py meanstd_grad_plan):
//
// * Route 0, blocked (meanstd_grad_blocked): a block of SUB_THREADS owns
//   Q = 8, 16 or 32 queries (subst_blocked.cuh's sub_plan with K5's
//   shared layout, so K5's Q: 8 up to nq = 1,056, so 128 blocks at
//   1,024) and runs sub_ungated of subst_blocked.cuh, K5's body: the k
//   vectors (sub_build_k), k . alpha (sub_dot_alpha), V = L^-1 K
//   (sub_forward), so mean and std are K5's operations, bit for bit where
//   the two take the same Q; then W = L^-T V in place (sub_backward: 16-row
//   column panels of L staged by cp.async from the bottom, the update on
//   the FP64 tensor cores, the diagonal block by a half-warp a query), and
//   the gradient sweep: the training rows staged again (over the length
//   scales), T = 256 / Q threads a query split its rows, each recomputing
//   the squared distance from direct differences (q_k - x_jk) and c =
//   2 sigma^2 dk/dsq, and summing alpha_j c (q_k - x_jk) and w_j c (q_k -
//   x_jk) per coordinate in registers; a shuffle tree sums the T threads.
//   The sums stay in that form: alpha cancels heavily on a fitted GP, and
//   q_k sum alpha c - sum alpha c x_k would lose the gradient's digits.
//   The per-thread sums hold GD = 8 or 32 coordinates (two instances),
//   and at d = 33-64 (the GD = 64 instance) 32 coordinates a pass, the
//   sweep made twice (2 x 64 sums would spill from the registers); there
//   the rows are read from global memory over the length scales on the fly
//   (the stages hold 32 doubles a row).  It takes n as long as the panels,
//   V and the queries fit in shared memory (n <= 640 at d = 8) and L's rows
//   are 16-byte aligned (even nmax).
// * Route 1 (meanstd_grad_kernel), K8's design before route 0: one block
//   of 128 threads per query (grid-stride over the queries), the block
//   routine gpry_block_meanvar_grad of common.cuh: the surrogate (X / l,
//   alpha, a work vector) staged in shared memory once per block, the
//   threads split the rows for k and its gradient and reduce 1 and 2 d
//   sums, one warp runs the forward and the back substitution against L
//   in global memory.  Above 48 KB of shared memory the kernel opts in
//   (gpry_set_smem); beyond the 227 KB a block holds, X is read from
//   global memory.  For an odd nmax, an unaligned L, or n beyond route 0.
//   Its gradient sums (gpry_block_grad_sums) take d <= 32 in one pass and
//   d = 33-64 in two passes of 32 coordinates (the GD = 64 instance).
// * Route 2: route 1's kernel with alpha read from global memory and the
//   work vector in the block's slice of a global workspace (grid x n
//   doubles, sized by gpry_meanstd_grad_work), for n beyond route 1's
//   shared memory (n > 14,284 at d = 32): every n the fit (K11) takes, the
//   same arithmetic, so route 1's bits.
//
// What bounds it on the H100.  Per query 2 n^2 / 2 multiply-adds of the
// two substitutions and about n (5 d + 3) for k and its gradient: 1.1e8
// FP64 operations at nq = 1,024, n = 224, d = 8, 1.7 us at 67 TFLOP/s.
// Route 0 is bound by the dependent chains of its 2 x 14 panels (update,
// barrier, 16 shuffle steps, barrier); route 1 by each query's 2 n
// dependent warp steps (a reduction for the forward substitution, a
// barrier for the back one).
//
// Spec mode (template SPEC): k comes from the interpreter of common.cuh,
// its gradient from the interpreter's forward mode (gpry_spec_grad), and
// the prior and its gradient (DotProduct only) from its diagonal program.
#include "subst_blocked.cuh"

// Route 0; GD: the largest d its per-thread sums hold.
template <bool SPEC, int GD>
__global__ void __launch_bounds__(SUB_THREADS)
meanstd_grad_blocked(SubUngated a) {
  extern __shared__ double smem[];
  sub_ungated<SPEC, GD>(a, smem);
}

// Routes 1 and 2 (VG: alpha and the work vector in global memory).
template <bool SPEC, int GD, bool VG>
__global__ void __launch_bounds__(GPRY_BLOCK_THREADS) meanstd_grad_kernel(
    GpryKern kern, int nq, int n, int nmax, int d, int stage_x,
    double* __restrict__ work,
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
  const GpryGP g = gpry_stage_gp<SPEC, VG>(smem, kern, n, nmax, d,
                                           stage_x != 0, X, alpha, L, theta,
                                           x_loc, x_scale, &spec, &q, work);
  const double y_loc = scal[0], y_scale = scal[1];
  for (int b = blockIdx.x; b < nq; b += gridDim.x) {
    if (tid < d)
      q[tid] = (Xq_raw[(size_t)b * d + tid] - g.x_loc[tid]) /
               g.x_scale[tid] / g.ls[tid];
    __syncthreads();
    gpry_block_meanvar_grad<SPEC, GD>(g, spec, q);
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

// Route 1's shared memory (stage_v) or route 2's: the staged GP with X if
// that fits (*stage_x), else without.
static size_t k8_chain_smem(const GpryKern& kern, int n, int d, bool stage_v,
                            bool* stage_x) {
  const size_t spec = gpry_spec_doubles(kern);
  *stage_x = true;
  size_t smem =
      sizeof(double) * (gpry_gp_doubles(n, d, true, spec, stage_v) + d);
  if (smem > GPRY_MAX_SMEM) {
    *stage_x = false;
    smem = sizeof(double) * (gpry_gp_doubles(n, d, false, spec, stage_v) + d);
  }
  return smem;
}

// The route (0 blocked, 1 a block a query, 2 the same with the n-vectors
// in global memory; -1 beyond shared memory) for nq queries against n
// training rows of the (nmax, nmax) factor L, the queries a block *Q (1 on
// routes 1 and 2) and the shared memory *smem.
static int k8_plan(const GpryKern& kern, int nq, int n, int nmax, int d,
                   const void* L, int* Q, size_t* smem) {
  if (sub_plan(nq, n, nmax, L, (size_t)d + gpry_spec_doubles(kern),
               (size_t)d + 1, Q, smem) == 0)
    return 0;
  bool stage_x;
  *Q = 1;
  for (int route = 1; route <= 2; ++route) {
    *smem = k8_chain_smem(kern, n, d, route == 1, &stage_x);
    if (*smem <= GPRY_MAX_SMEM) return route;
  }
  return -1;
}

// Blocks of routes 1 and 2: one a query, at most 4 an SM (grid-stride).
static int k8_grid(int nq) {
  int dev = 0, sms = 132;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  return nq < 4 * sms ? nq : 4 * sms;
}

extern "C" int gpry_meanstd_grad_plan(GpryKern kern, int nq, int n,
                                      int nmax, int d, const void* L, int* Q,
                                      size_t* smem) {
  return k8_plan(kern, nq, n, nmax, d, L, Q, smem);
}

// Doubles of the global workspace a launch needs: route 2's n a block on
// the current device, 0 on the other routes.
extern "C" size_t gpry_meanstd_grad_work(GpryKern kern, int nq, int n,
                                         int nmax, int d, const void* L) {
  int Q;
  size_t smem;
  if (nq <= 0 || k8_plan(kern, nq, n, nmax, d, L, &Q, &smem) != 2) return 0;
  return (size_t)k8_grid(nq) * n;
}

// Routes 1 and 2's instance at d (GD 32 or 64), the vectors in global
// memory on route 2.
template <bool SPEC>
static auto k8_chain_kernel(int d, bool vg) {
  return d > GPRY_GRAD_W
             ? (vg ? meanstd_grad_kernel<SPEC, 64, true>
                   : meanstd_grad_kernel<SPEC, 64, false>)
             : (vg ? meanstd_grad_kernel<SPEC, 32, true>
                   : meanstd_grad_kernel<SPEC, 32, false>);
}

// scal = [y_loc, y_scale, ...] (the surrogate's packed gate scalars); work:
// gpry_meanstd_grad_work doubles (null where that is 0)
extern "C" int gpry_meanstd_grad(
    GpryKern kern, int nq, int n, int nmax, int d, const void* Xq_raw,
    const void* X, const void* alpha, const void* L, const void* theta,
    const void* x_loc, const void* x_scale, const void* scal,
    void* mean_out, void* std_out, void* gmean_out, void* gstd_out,
    void* work, void* stream) {
  if (d > GPRY_GRAD_MAX_D || nq < 0) return (int)cudaErrorInvalidValue;
  if (nq == 0) return 0;
  int Q = 0;
  size_t smem = 0;
  const int route = k8_plan(kern, nq, n, nmax, d, L, &Q, &smem);
  if (route < 0) return (int)cudaErrorInvalidConfiguration;
  if (route == 2 && work == nullptr) return (int)cudaErrorInvalidValue;
  const bool spec = kern.nodes > 0;
  const bool wide = d > GPRY_GRAD_W;
  cudaError_t e;
  if (route == 0) {
    auto kernel = spec ? (d <= 8 ? meanstd_grad_blocked<true, 8>
                                 : wide ? meanstd_grad_blocked<true, 64>
                                        : meanstd_grad_blocked<true, 32>)
                       : (d <= 8 ? meanstd_grad_blocked<false, 8>
                                 : wide ? meanstd_grad_blocked<false, 64>
                                        : meanstd_grad_blocked<false, 32>);
    e = gpry_set_smem(kernel, smem);
    if (e != cudaSuccess) return (int)e;
    const SubUngated a{kern, nq, n, nmax, d, Q,
                       (const double*)Xq_raw, (const double*)X,
                       (const double*)alpha, (const double*)L,
                       (const double*)theta, (const double*)x_loc,
                       (const double*)x_scale, (const double*)scal,
                       (double*)mean_out, (double*)std_out,
                       (double*)gmean_out, (double*)gstd_out};
    kernel<<<(nq + Q - 1) / Q, SUB_THREADS, smem, (cudaStream_t)stream>>>(
        a);
    return (int)cudaGetLastError();
  }
  bool stage_x;
  k8_chain_smem(kern, n, d, route == 1, &stage_x);
  auto kernel = spec ? k8_chain_kernel<true>(d, route == 2)
                     : k8_chain_kernel<false>(d, route == 2);
  e = gpry_set_smem(kernel, smem);
  if (e != cudaSuccess) return (int)e;
  kernel<<<k8_grid(nq), GPRY_BLOCK_THREADS, smem, (cudaStream_t)stream>>>(
      kern, nq, n, nmax, d, (int)stage_x, (double*)work,
      (const double*)Xq_raw,
      (const double*)X, (const double*)alpha, (const double*)L,
      (const double*)theta, (const double*)x_loc, (const double*)x_scale,
      (const double*)scal, (double*)mean_out, (double*)std_out,
      (double*)gmean_out, (double*)gstd_out);
  return (int)cudaGetLastError();
}
