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
// Design.  Each row is the evaluation K11 runs for a lane (lml_value and,
// in GRAD mode, lml_grad of lml_blocked.cuh): the bordered triangle built
// pair by pair, factored blocked in 16-column panels with the trailing
// update on the FP64 tensor cores.  Unlike a K11 lane, the screen is R
// independent rows, so the design is for rows in flight: a grid of
// blocks, as many as the SMs hold at once (the occupancy of the instance
// at its shared memory, cudaOccupancyMaxActiveBlocksPerMultiprocessor),
// each looping over the rows r = blockIdx.x, blockIdx.x + gridDim.x, ...
// on its own workspace, so that memory does not grow with R.  The route
// (k10_route, mirrored on the host by ops/fused.py lml_value_grad_plan):
// 0 keeps the packed triangle in shared memory, 1 keeps it in the block's
// global workspace (L2) and stages the tensor cores' operands through the
// fixed LML_STAGE buffer (32 KB), so that two blocks share an SM.  Both
// were measured at the screen's shape (PERF.md, section 6): for the fast
// families route 0 is the faster (the factor's trailing updates dominate,
// and through L2 each costs more than a second row in flight saves), for
// a spec program route 1 from K10_ROUTE1_N rows on (the interpreter's pair
// build dominates, and a second block hides its latency).  Route 1 also
// wherever route 0 does not fit.
//
// What bounds it on the H100.  Per row the n / 16 dependent panels of the
// factor (a warp's register factor of the diagonal block, the panel
// solve, the MMA update, three barriers each): latency, which the rows in
// flight on an SM overlap.  The FP64 operations (n^3 / 3 for the factor,
// n^2 for the pair build; with GRAD about 2 n^3 / 3 more for L^-1 and
// K^-1 and p n^2 for the contraction) take well under a microsecond per
// row at n = 224 at 67 TFLOP/s, and the bytes (theta in, one value out)
// are nothing: the bound is operations.
//
// Spec mode (template SPEC): the interpreter of common.cuh builds K; the
// gradient is its forward mode in theta (gpry_spec_dtheta).
#include "lml_blocked.cuh"

// A spec program's route 1 from this many valid rows on (where route 0
// still fits): there route 0's triangle holds an SM's shared memory alone,
// while route 1's fixed buffer lets two rows share it.
#define K10_ROUTE1_N 160

// The route of n rows (lml_route with no state besides the evaluation's,
// then a spec program's route 1 from K10_ROUTE1_N rows on, where route 1's
// fixed buffer is smaller than route 0's triangle); -1 when none fits.
static int k10_route(int n, int d, size_t spec, int* stage_x, size_t* smem) {
  const int route = lml_route(n, d, spec, 0, stage_x, smem);
  if (route == 0 && spec > 0 && n >= K10_ROUTE1_N) {
    lml_route_fits(n, d, spec, 0, 1, stage_x, smem);
    return 1;
  }
  return route;
}

template <bool SPEC, bool GRAD, bool GLOB>
__global__ void __launch_bounds__(LML_THREADS, 2) lml_value_grad_kernel(
    GpryKern kern, int R, GpryLmlData D, int stage_x,
    const double* __restrict__ thetas, double* __restrict__ work,
    size_t work_per_block, double* __restrict__ lml_out,
    double* __restrict__ grad_out) {
  extern __shared__ double smem[];
  const int tid = threadIdx.x, nt = blockDim.x;
  const int n = D.n, d = D.d, p = kern.ntheta;
  double* wk = work + (size_t)blockIdx.x * work_per_block;
  LmlEval E;
  E.dinv = smem;
  E.red = E.dinv + LML_NB;
  E.flag = (int*)(E.red + LML_WARPS * GPRY_LML_PCHUNK);
  E.ls = E.red + LML_WARPS * GPRY_LML_PCHUNK + 1;
  E.spx = E.ls + d;
  E.al = E.spx + gpry_spec_doubles(kern);
  double* tail;
  if (GLOB) {
    E.pan = E.al + n;
    E.A = wk + (size_t)d * n;
    tail = E.pan + LML_STAGE;
  } else {
    E.pan = nullptr;
    E.A = E.al + n;
    tail = E.A + gpry_tri(n + 1);
  }
  // X in shared memory when it fits: the fast families' X / ls (rebuilt
  // per row), or X itself once for the spec interpreter (lml_value's first
  // barrier makes it visible)
  E.Xt = stage_x ? tail : wk;
  E.Xr = D.X;
  if (SPEC && stage_x) {
    for (int i = tid; i < n * d; i += nt) tail[i] = D.X[i];
    E.Xr = tail;
  }
  GprySpec spec;
  for (int r = blockIdx.x; r < R; r += gridDim.x) {
    const double* th = thetas + (size_t)r * p;
    const double v = lml_value<SPEC, GLOB>(kern, D, th, E, &spec);
    if constexpr (GRAD) {
      double* g = grad_out + (size_t)r * p;
      // every thread holds the same v: a failed factor is NaN in all
      if (isnan(v)) {
        for (int j = tid; j < p; j += nt) g[j] = NAN;
      } else {
        lml_grad<SPEC, GLOB>(kern, D, th, E, spec, g);
      }
    }
    if (tid == 0) lml_out[r] = v;
  }
}

template <bool SPEC, bool GRAD>
static auto k10_instance(int route) {
  return route ? lml_value_grad_kernel<SPEC, GRAD, true>
               : lml_value_grad_kernel<SPEC, GRAD, false>;
}

static auto k10_kernel(const GpryKern& kern, int grad, int route) {
  return kern.nodes ? (grad ? k10_instance<true, true>(route)
                            : k10_instance<true, false>(route))
                    : (grad ? k10_instance<false, true>(route)
                            : k10_instance<false, false>(route));
}

// The route (0: shared, 1: global, -1: n too large) for n rows; whether X
// is staged, the shared memory (bytes), one block's global workspace
// (doubles) and, with `per_sm` not null, how many blocks of the instance
// an SM holds at once.
extern "C" int gpry_lml_value_grad_plan(GpryKern kern, int n, int d,
                                        int grad, int* stage_x, size_t* smem,
                                        size_t* work, int* per_sm) {
  const int route = k10_route(n, d, gpry_spec_doubles(kern), stage_x, smem);
  *work = route < 0 ? 0 : lml_work_doubles(n, d, route);
  if (per_sm) {
    *per_sm = 0;
    if (route < 0) return route;
    auto kernel = k10_kernel(kern, grad, route);
    if (gpry_set_smem(kernel, *smem) != cudaSuccess ||
        cudaOccupancyMaxActiveBlocksPerMultiprocessor(
            per_sm, kernel, LML_THREADS, *smem) != cudaSuccess)
      return -2;
  }
  return route;
}

// thetas (R, kern.ntheta); X (>= n rows, d); y (>= n); noise one value or
// one per row; work blocks x the plan's workspace doubles; grad_out (R,
// kern.ntheta) when grad.
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
  int stage_x;
  size_t smem, wpb;
  const int route =
      gpry_lml_value_grad_plan(kern, n, d, grad, &stage_x, &smem, &wpb,
                               nullptr);
  if (route < 0) return (int)cudaErrorInvalidConfiguration;
  auto kernel = k10_kernel(kern, grad, route);
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
  kernel<<<blocks < R ? blocks : R, LML_THREADS, smem,
           (cudaStream_t)stream>>>(kern, R, D, stage_x,
                                   (const double*)thetas, (double*)work,
                                   wpb, (double*)lml_out,
                                   (double*)grad_out);
  return (int)cudaGetLastError();
}
