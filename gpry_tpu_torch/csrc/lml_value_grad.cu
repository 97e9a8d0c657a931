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
// independent rows, so the design is for rows in flight: F rows at a time,
// each on a cluster of C blocks (one block on route 0) with its own
// workspace, cluster f looping over the rows f, f + F, ..., so that memory
// does not grow with R.  The route (k10_route, mirrored on
// the host by ops/fused.py lml_value_grad_plan): 0 keeps the packed
// triangle in shared memory, 1 keeps it in the row's global workspace and
// stages the tensor cores' operands through the fixed LML_STAGE buffer
// (32 KB), so that two blocks share an SM.  Both were measured at the
// screen's shape (PERF.md, section 6): for the fast families route 0 is
// the faster (the factor's trailing updates dominate, and through L2 each
// costs more than a second row in flight saves), for a spec program route
// 1 from K10_ROUTE1_N rows on (the interpreter's pair build dominates,
// and a second block hides its latency).  Route 1 also wherever route 0
// does not fit.  The plan (gpry_lml_value_grad_cluster, mirrored by
// ops/fused.py lml_value_grad_cluster): F = min(R, the blocks the SMs
// hold, the rows whose workspaces fit LML_WORK_BUDGET), then on route 1
// C = lml_cluster(F, SMs, the clusters the card holds at once), so that a
// screen of many rows at moderate n keeps a row a block and a few rows at
// large n take up to 16 SMs each.
//
// What bounds it on the H100.  Per row the n / 16 dependent panels of the
// factor (a warp's register factor of the diagonal block, the panel
// solve, the MMA update, three barriers each): latency, which the rows in
// flight on an SM overlap.  The FP64 operations (n^3 / 3 for the factor,
// n^2 for the pair build; with GRAD about 2 n^3 / 3 more for L^-1 and
// K^-1 and p n^2 for the contraction) take well under a microsecond per
// row at n = 224 at 67 TFLOP/s, and the bytes (theta in, one value out)
// are nothing: the bound is operations.  On route 1 at large n a row's
// trailing updates move its triangle through L2 or HBM once a panel, and
// a block moves it at one SM's rate: what a cluster multiplies.
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

// the most global memory the rows' workspaces take together (bytes;
// ops/fused.py LML_WORK_BUDGET): a fifth of the H100's 80 GB
#define LML_WORK_BUDGET (16ull << 30)

template <bool SPEC, bool GRAD, bool GLOB>
__global__ void __launch_bounds__(LML_THREADS, 2) lml_value_grad_kernel(
    GpryKern kern, int R, int C, GpryLmlData D, int stage_x,
    const double* __restrict__ thetas, double* __restrict__ work,
    size_t work_per_row, double* __restrict__ lml_out,
    double* __restrict__ grad_out) {
  extern __shared__ double smem[];
  const int tid = threadIdx.x, nt = blockDim.x;
  const int n = D.n, d = D.d, p = kern.ntheta;
  // rows in flight: cluster f on blocks C f .. C f + C - 1 (route 0: C =
  // 1)
  const int CL = GLOB ? C : 1;
  const int f = blockIdx.x / CL, rank = blockIdx.x - f * CL;
  const int F = gridDim.x / CL;
  double* wk = work + (size_t)f * work_per_row;
  LmlEval E;
  E.rank = rank;
  E.C = CL;
  E.xs = stage_x;
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
  for (int r = f; r < R; r += F) {
    const double* th = thetas + (size_t)r * p;
    const double v = lml_value<SPEC, GLOB>(kern, D, th, E, &spec);
    if constexpr (GRAD) {
      double* g = grad_out + (size_t)r * p;
      // every thread of the cluster holds the same v: a failed factor is
      // NaN in all
      if (isnan(v)) {
        if (rank == 0)
          for (int j = tid; j < p; j += nt) g[j] = NAN;
      } else {
        lml_grad<SPEC, GLOB>(kern, D, th, E, spec, rank == 0 ? g : nullptr);
      }
    }
    if (tid == 0 && rank == 0) lml_out[r] = v;
  }
  // no block leaves while another may read its shared memory
  if (GLOB && C > 1) cooperative_groups::this_cluster().sync();
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

// The rows in flight F and the cluster C of R rows (route 1: lml_cluster
// of F over the current device's SMs and act; route 0: 1), F = min(R, the
// blocks the SMs hold (per_sm of gpry_lml_value_grad_plan each),
// LML_WORK_BUDGET over a row's workspace), and into act[i] how many
// clusters of 2^i blocks (i = 0: blocks, per_sm a SM; on route 0 only
// those) the card runs at once (lml_actives; 0: it cannot schedule one).
// Returns the route (-1: n too large), or -2 when the runtime refused a
// query.
extern "C" int gpry_lml_value_grad_cluster(GpryKern kern, int R, int n, int d,
                                           int grad, int per_sm, int* F,
                                           int* C, int* act) {
  int stage_x, dev, sms;
  size_t smem, wpr;
  *F = *C = 1;
  for (int i = 0; i < 5; ++i) act[i] = 0;
  const int route = gpry_lml_value_grad_plan(kern, n, d, grad, &stage_x,
                                             &smem, &wpr, nullptr);
  if (route < 0) return route;
  if (cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) !=
          cudaSuccess)
    return -2;
  const unsigned long long row = 8ull * (wpr > 0 ? wpr : 1);
  const unsigned long long fit = LML_WORK_BUDGET / row;
  long long f = R;
  if (f > (long long)per_sm * sms) f = (long long)per_sm * sms;
  if ((unsigned long long)f > fit) f = (long long)fit;
  *F = f < 1 ? 1 : (int)f;
  if (route == 1 && lml_actives(k10_kernel(kern, grad, route), smem, true,
                                act) != cudaSuccess)
    return -2;
  act[0] = per_sm * sms;
  if (route == 1) *C = lml_cluster(*F, sms, act);
  return route;
}

// thetas (R, kern.ntheta); X (>= n rows, d); y (>= n); noise one value or
// one per row; F rows in flight on clusters of C (as
// gpry_lml_value_grad_cluster gave them); work F x the plan's workspace
// doubles; grad_out (R, kern.ntheta) when grad.
extern "C" int gpry_lml_value_grad(GpryKern kern, int R, int n, int d,
                                   int grad, int F, int C,
                                   const void* thetas,
                                   const void* X, const void* y,
                                   const void* noise, int noise_is_vec,
                                   double rel_jitter, void* work,
                                   void* lml_out, void* grad_out,
                                   void* stream) {
  if (R < 0 || n < 0 || F < 1 || !lml_cluster_ok(C) || (grad && !grad_out))
    return (int)cudaErrorInvalidValue;
  if (R == 0) return 0;
  int stage_x;
  size_t smem, wpr;
  const int route =
      gpry_lml_value_grad_plan(kern, n, d, grad, &stage_x, &smem, &wpr,
                               nullptr);
  if (route < 0 || (C > 1 && route != 1))
    return (int)cudaErrorInvalidConfiguration;
  auto kernel = k10_kernel(kern, grad, route);
  cudaError_t e = lml_attributes(kernel, smem, C);
  if (e != cudaSuccess) return (int)e;
  GpryLmlData D;
  D.n = n;
  D.d = d;
  D.noise_is_vec = noise_is_vec;
  D.X = (const double*)X;
  D.y = (const double*)y;
  D.noise = (const double*)noise;
  D.rel_jitter = rel_jitter;
  return (int)lml_launch(kernel, F * C, C, smem,
                         (cudaStream_t)stream, kern, R, C, D, stage_x,
                         (const double*)thetas, (double*)work, wpr,
                         (double*)lml_out, (double*)grad_out);
}
