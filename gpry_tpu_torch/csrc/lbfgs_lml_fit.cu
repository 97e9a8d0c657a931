// K11 lbfgs_lml_fit: the whole multistart bounded L-BFGS fit of the GP
// hyperparameters, in one launch.
//
// Replaces gpry_tpu/models/gp.py:236 _fit_theta_restarts: jax.vmap over
// the restarts of gpry_tpu/ops/lbfgs.py:168 minimize_lbfgs_bounded (the
// while_loop L-BFGS of :44-165, its Armijo while_loop :103-119) on
//
//   F(u) = -masked_lml(theta)  at  theta = lo + (hi - lo) sigmoid(clip(u,
//          -15, 15)),
//
// tol 1e-8.  Per lane, step for step the algorithm of
// gpry_tpu_torch/ops/lbfgs.py (the plain version's solver), as K9
// (csrc/lbfgs_logexp_ascent.cu) runs it for the LogExp ascent: u0 from
// to_unconstrained; the two-loop recursion over a history of 8 pairs
// (newest at slot 0) with gamma clipped to [1e-8, 1e8]; steepest descent
// when that is no descent direction; Armijo with at most 18 halvings,
// f(u + t d) <= f + 1e-4 t g.d; a pair stored only after a successful line
// search with s.y > 1e-10; a stop on a failed line search, |g| < 1e-8, a
// non-finite f or 5 iterations in a row that improve f by less than
// 16 eps (1 + |f|); at most maxiter iterations; a lane whose f ends
// non-finite returns (theta0 as mapped, f(theta0)).  nev counts the
// reference algorithm's value-and-gradient calls and line-search probes
// (1 + sum (n_ls + 1)); the iterations are returned too.
//
// What bounds it on the H100.  Per lane a chain of dependent evaluations
// of the LML of an n x n covariance (n = 224 on the main paths): about
// n^3 / 3 operations to factor it, n^3 / 3 more for L^-1 and as many for
// K^-1 = L^-T L^-1 in a gradient.  At the FP64 tensor cores' 67 TFLOP/s
// that is microseconds at n = 224; what bounds a lane there is latency:
// the n dependent pivots of the factorization, the barriers between its
// steps, the shared-memory traffic of the updates and the chain of
// instructions a kernel pair takes, at 8 warps a block and 255 registers a
// thread (one block an SM).  Past route 0 (n > 236 at d = 8; the default
// budget reaches 1,584 at d = 8, 4,480 at d = 16, 23,278 at d = 48) the
// triangle lives in global memory and the n^3-scale work is what counts:
// on one block a lane got one SM's share of the card (25 GFLOP/s at n =
// 23,278 on an H100), so route 1 runs a lane on a cluster.
//
// Design.  A lane per block (route 0) or per thread-block cluster of C
// blocks (route 1; C from lml_cluster: of the powers of two up to 16 with
// R C <= the SMs, the most blocks a lane per wave of resident clusters,
// 16 for a simple fit's 2 lanes and a full fit's 8 on an H100), launched
// with cudaLaunchKernelEx.
// The lane's state (u, f, g, the (S, Y, rho) history, kh, the stall
// count, nev) lives in shared memory, so a lane exits when it stops and
// the host reads nothing until the launch ends.  On a cluster every block holds the lane's state and
// runs its arithmetic: the value and gradient every block reads are the
// same bits (lml_blocked.cuh sums the blocks' partials in one order), so
// the blocks take the same decisions with no barrier for them, and rank 0
// writes the outputs.
// * An accepted probe is reused: a line-search probe at u + t d computes
//   the value (the factor of K, z = L^-1 y and log det) and leaves the
//   factor in place; when it passes, the gradient is computed from that
//   factor, so an iteration whose probe passes factors once (the value part
//   of the reference's value-and-gradient call runs the same code on the
//   same point: bit-identical).  A failed search (t = 0) keeps the f and g
//   the lane holds (u + 0 d is u), unless the direction has a non-finite
//   entry: then, as in the reference, u + 0 d and its f and g are NaN.
// * The evaluation is lml_value and lml_grad of lml_blocked.cuh (shared
//   with K10): the blocked factor with its trailing update on the FP64
//   tensor cores, then L^-1 and K^-1 in place on the same MMA tiles and
//   one pass over the pairs for the gradient.
// * Routes (lml_route with the lane's state, mirrored on the host by
//   ops/fused.py lbfgs_lml_fit_plan and lml_cluster): the packed triangle
//   in shared memory up to n = 236 at d = 8 (fast family); above that, in
//   the lane's global workspace, with the tensor cores' operands staged
//   through the fixed LML_STAGE buffer of each of the cluster's blocks: up
//   to n = 24,539 at d = 8 (23,843 at d = 32).  The wrapper raises
//   ValueError above.  X goes to shared memory too where it fits (route 0
//   up to n = 229 at d = 8).
// p = 1 + d (or a tree's parameter count) may exceed a warp, so warp 0
// runs the L-BFGS arithmetic with its lanes striding over the coordinates;
// dot products are warp reductions.  The updates whose rounding decides a
// line search or a stall (u + t d, the Armijo threshold) and the map to
// theta are written with explicit roundings, as torch evaluates them.
//
// Spec mode (template SPEC): the interpreter of common.cuh builds K, and
// the gradient is its forward mode in theta.
#include "lml_blocked.cuh"

#define K11_M 8
#define K11_LS 18
#define K11_STALL 5
#define K11_UCLIP 15.0

struct K11State {
  double f, f0, t, gd;
  long long nev;
  int kh, stall, nls, ok, stop, iters;
};

struct K11Lane {
  double *u, *u0, *g, *dir, *un, *gn, *lo, *A, *th, *sig, *gl, *q;
  double *S, *Y, *rho;
  K11State* st;
};

// Doubles of a lane's state: twelve p-vectors, the (S, Y) history, rho
// and the scalars.
__host__ __device__ inline size_t k11_lane_doubles(int p) {
  return 12 * (size_t)p + 2 * K11_M * (size_t)p + K11_M +
         sizeof(K11State) / sizeof(double);
}

// A dot product of two p-vectors by warp 0, lane k summing coordinates
// k, k + 32, ...; the same value in every lane.
__device__ __forceinline__ double k11_dot(const double* a, const double* b,
                                          int p, int lane) {
  double s = 0.0;
  for (int k = lane; k < p; k += 32) s += a[k] * b[k];
  return gpry_warp_sum(s);
}


// theta of the u-space point pu (p; coordinate k by thread k mod blockDim)
// into ln.th, sigmoid(clip(u)) into ln.sig; the caller's next barrier
// makes them visible.
__device__ __forceinline__ void k11_map(const K11Lane& ln, int p,
                                        const double* pu) {
  for (int k = threadIdx.x; k < p; k += blockDim.x) {
    const double u = pu[k];
    const double uc =
        u < -K11_UCLIP ? -K11_UCLIP : (u > K11_UCLIP ? K11_UCLIP : u);
    const double s = 1.0 / (1.0 + exp(-uc));
    ln.sig[k] = s;
    ln.th[k] = __dadd_rn(ln.lo[k], __dmul_rn(ln.A[k], s));
  }
}

// dF/du at pu into gout from the lml gradient in ln.gl (F = -lml).
__device__ __forceinline__ void k11_grad_u(const K11Lane& ln, int p,
                                           const double* pu, double* gout) {
  for (int k = threadIdx.x; k < p; k += blockDim.x) {
    const double s = ln.sig[k];
    const double gsig = -ln.gl[k] * ln.A[k];
    const double gu = (gsig * (1.0 - s)) * s;
    const double u = pu[k];
    gout[k] = (u >= -K11_UCLIP && u <= K11_UCLIP) ? gu : 0.0;
  }
  __syncthreads();
}

template <bool SPEC, bool GLOB>
__global__ void __launch_bounds__(LML_THREADS, 1) lbfgs_lml_fit_kernel(
    GpryKern kern, int R, int C, GpryLmlData D, int stage_x, int maxiter,
    const double* __restrict__ theta0s, const double* __restrict__ lo_g,
    const double* __restrict__ hi_g, double* __restrict__ work,
    size_t work_per_lane, double* __restrict__ th_out,
    double* __restrict__ f_out, long long* __restrict__ nev_out,
    long long* __restrict__ it_out) {
  extern __shared__ double smem[];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int nt = blockDim.x;
  // lane r on blocks C r .. C r + C - 1 (one cluster; route 0: C = 1)
  const int CL = GLOB ? C : 1;
  const int r = blockIdx.x / CL, rank = blockIdx.x - r * CL;
  const int p = kern.ntheta, n = D.n, d = D.d;
  double* wk = work + (size_t)r * work_per_lane;
  // the lane's state first, then the evaluation's buffers
  K11Lane ln;
  ln.u = smem;
  ln.u0 = ln.u + p;
  ln.g = ln.u0 + p;
  ln.dir = ln.g + p;
  ln.un = ln.dir + p;
  ln.gn = ln.un + p;
  ln.lo = ln.gn + p;
  ln.A = ln.lo + p;
  ln.th = ln.A + p;
  ln.sig = ln.th + p;
  ln.gl = ln.sig + p;
  ln.q = ln.gl + p;
  ln.S = ln.q + p;
  ln.Y = ln.S + K11_M * p;
  ln.rho = ln.Y + K11_M * p;
  ln.st = (K11State*)(ln.rho + K11_M);
  K11State* st = ln.st;
  LmlEval E;
  E.rank = rank;
  E.C = CL;
  E.xs = stage_x;
  E.dinv = smem + k11_lane_doubles(p);
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
  // per evaluation), or X itself once for the spec interpreter
  E.Xt = stage_x ? tail : wk;
  E.Xr = D.X;
  if (SPEC && stage_x) {
    for (int i = tid; i < n * d; i += nt) tail[i] = D.X[i];
    E.Xr = tail;
  }
  GprySpec spec;
  const double eps = 1e-12;
  const double stall_rtol = 16.0 * 2.220446049250313e-16;

  // u0 = to_unconstrained(theta0)
  for (int k = tid; k < p; k += nt) {
    const double lo = lo_g[k], A = hi_g[k] - lo;
    ln.lo[k] = lo;
    ln.A[k] = A;
    double t = (theta0s[(size_t)r * p + k] - lo) / A;
    t = t < 1e-9 ? 1e-9 : (t > 1.0 - 1e-9 ? 1.0 - 1e-9 : t);
    double u = log(t) - log1p(-t);
    u = u < -K11_UCLIP ? -K11_UCLIP : (u > K11_UCLIP ? K11_UCLIP : u);
    ln.u[k] = ln.u0[k] = u;
  }
  for (int i = tid; i < 2 * K11_M * p + K11_M; i += nt) ln.S[i] = 0.0;
  __syncthreads();
  k11_map(ln, p, ln.u);
  {
    const double F = -lml_value<SPEC, GLOB>(kern, D, ln.th, E, &spec);
    // a lane that starts non-finite stops at once: its g is never read
    if (isfinite(F)) {
      lml_grad<SPEC, GLOB>(kern, D, ln.th, E, spec, ln.gl);
      k11_grad_u(ln, p, ln.u, ln.g);
    }
    if (tid == 0) {
      st->f = st->f0 = F;
      st->stop = !isfinite(F);
      st->nev = 1;
      st->kh = 0;
      st->stall = 0;
      st->iters = 0;
    }
  }
  __syncthreads();

  for (int it = 0; it < maxiter; ++it) {
    if (st->stop) break;
    // the two-loop direction and the steepest-descent safeguard (warp 0)
    if (warp == 0) {
      const int kh = st->kh;
      double* q = ln.q;
      for (int k = lane; k < p; k += 32) q[k] = ln.g[k];
      double alf[K11_M];
#pragma unroll
      for (int j = 0; j < K11_M; ++j) {
        const double dot = k11_dot(ln.S + j * p, q, p, lane);
        const double a = j < kh ? ln.rho[j] * dot : 0.0;
        for (int k = lane; k < p; k += 32)
          q[k] = __dsub_rn(q[k], __dmul_rn(a, ln.Y[j * p + k]));
        alf[j] = a;
      }
      const double yy = k11_dot(ln.Y, ln.Y, p, lane);
      const double sy0 = k11_dot(ln.S, ln.Y, p, lane);
      double gamma = kh > 0 ? sy0 / (yy < eps ? eps : yy) : 1.0;
      gamma = gamma < 1e-8 ? 1e-8 : (gamma > 1e8 ? 1e8 : gamma);
      for (int k = lane; k < p; k += 32) q[k] = __dmul_rn(gamma, q[k]);
#pragma unroll
      for (int j = K11_M - 1; j >= 0; --j) {
        const double dot = k11_dot(ln.Y + j * p, q, p, lane);
        const double b = j < kh ? ln.rho[j] * dot : 0.0;
        const double c = j < kh ? alf[j] - b : 0.0;
        for (int k = lane; k < p; k += 32)
          q[k] = __dadd_rn(q[k], __dmul_rn(c, ln.S[j * p + k]));
      }
      for (int k = lane; k < p; k += 32) ln.dir[k] = -q[k];
      double gd = k11_dot(ln.g, ln.dir, p, lane);
      if (!(gd < 0.0)) {
        for (int k = lane; k < p; k += 32) ln.dir[k] = -ln.g[k];
        gd = k11_dot(ln.g, ln.dir, p, lane);
      }
      if (lane == 0) {
        st->gd = gd;
        st->t = 1.0;
        st->ok = 0;
        st->nls = 0;
      }
    }
    __syncthreads();
    // Armijo backtracking: each probe computes the value and leaves its
    // factor in place
    double Fn = 0.0;
    for (int ls = 0; ls < K11_LS; ++ls) {
      for (int k = tid; k < p; k += nt)
        ln.un[k] = __dadd_rn(ln.u[k], __dmul_rn(st->t, ln.dir[k]));
      __syncthreads();
      k11_map(ln, p, ln.un);
      const double Ft = -lml_value<SPEC, GLOB>(kern, D, ln.th, E, &spec);
      if (tid == 0) {
        st->nls += 1;
        const double thr =
            __dadd_rn(st->f, __dmul_rn(__dmul_rn(1e-4, st->t), st->gd));
        if (isfinite(Ft) && Ft <= thr)
          st->ok = 1;
        else
          st->t *= 0.5;
      }
      __syncthreads();
      if (st->ok) {
        Fn = Ft;
        break;
      }
    }
    const bool ok = st->ok != 0;
    if (ok) {
      // the accepted probe's factor: the gradient at un
      lml_grad<SPEC, GLOB>(kern, D, ln.th, E, spec, ln.gl);
      k11_grad_u(ln, p, ln.un, ln.gn);
    } else {
      // t = 0: u + 0 d is u, and the reference's value and gradient there
      // are the ones the lane holds; unless d has a non-finite entry, when
      // u + 0 d, and the value and gradient there, are NaN
      bool fin = true;
      for (int k = 0; k < p; ++k) fin = fin && isfinite(ln.dir[k]);
      for (int k = tid; k < p; k += nt) {
        ln.un[k] =
            fin ? ln.u[k] : __dadd_rn(ln.u[k], __dmul_rn(0.0, ln.dir[k]));
        ln.gn[k] = fin ? ln.g[k] : NAN;
      }
      Fn = fin ? st->f : NAN;
    }
    if (tid == 0) {
      if (!ok) st->t = 0.0;
      st->nev += st->nls + 1;
      st->iters += 1;
    }
    __syncthreads();
    // the history, the stops and the step (warp 0)
    if (warp == 0) {
      double sy = 0.0, gg = 0.0;
      for (int k = lane; k < p; k += 32) {
        const double s = __dsub_rn(ln.un[k], ln.u[k]);
        const double y = __dsub_rn(ln.gn[k], ln.g[k]);
        sy += s * y;
        gg += ln.gn[k] * ln.gn[k];
      }
      sy = gpry_warp_sum(sy);
      const double gnorm = sqrt(gpry_warp_sum(gg));
      const bool store = ok && sy > 1e-10;
      for (int k = lane; k < p; k += 32) {
        if (store) {
          for (int j = K11_M - 1; j > 0; --j) {
            ln.S[j * p + k] = ln.S[(j - 1) * p + k];
            ln.Y[j * p + k] = ln.Y[(j - 1) * p + k];
          }
          ln.S[k] = __dsub_rn(ln.un[k], ln.u[k]);
          ln.Y[k] = __dsub_rn(ln.gn[k], ln.g[k]);
        }
        ln.u[k] = ln.un[k];
        ln.g[k] = ln.gn[k];
      }
      __syncwarp();
      if (lane == 0) {
        if (store) {
          for (int j = K11_M - 1; j > 0; --j) ln.rho[j] = ln.rho[j - 1];
          ln.rho[0] = 1.0 / (sy < eps ? eps : sy);
          st->kh += 1;
        }
        const bool improved = (st->f - Fn) > stall_rtol * (1.0 + fabs(Fn));
        const int stall = improved ? 0 : st->stall + 1;
        st->stall = stall;
        st->stop = !ok || gnorm < 1e-8 || !isfinite(Fn) ||
                   stall >= K11_STALL;
        st->f = Fn;
      }
    }
    __syncthreads();
  }
  // the loop ends after a barrier: every thread reads the same f
  const bool bad = !isfinite(st->f);
  for (int k = tid; k < p; k += nt) {
    const double u = bad ? ln.u0[k] : ln.u[k];
    const double uc =
        u < -K11_UCLIP ? -K11_UCLIP : (u > K11_UCLIP ? K11_UCLIP : u);
    const double s = 1.0 / (1.0 + exp(-uc));
    if (rank == 0)
      th_out[(size_t)r * p + k] =
          __dadd_rn(ln.lo[k], __dmul_rn(ln.A[k], s));
  }
  if (tid == 0 && rank == 0) {
    f_out[r] = bad ? st->f0 : st->f;
    nev_out[r] = st->nev;
    it_out[r] = st->iters;
  }
  // no block leaves while another may read its shared memory
  if (GLOB && C > 1) cooperative_groups::this_cluster().sync();
}

// The route (0: shared, 1: global, -1: n too large), whether X is staged
// too, the shared memory (bytes) and the global workspace of one lane
// (doubles) it takes.
extern "C" int gpry_lbfgs_lml_fit_plan(GpryKern kern, int n, int d,
                                       int* stage_x, size_t* smem,
                                       size_t* work) {
  const int route =
      lml_route(n, d, gpry_spec_doubles(kern),
                k11_lane_doubles(kern.ntheta), stage_x, smem);
  *work = route < 0 ? 0 : lml_work_doubles(n, d, route);
  return route;
}

static auto k11_kernel(const GpryKern& kern, int route) {
  return kern.nodes ? (route ? lbfgs_lml_fit_kernel<true, true>
                             : lbfgs_lml_fit_kernel<true, false>)
                    : (route ? lbfgs_lml_fit_kernel<false, true>
                             : lbfgs_lml_fit_kernel<false, false>);
}

// The cluster of R lanes (route 1: lml_cluster over the current device's
// SMs and act; route 0: 1) into *C, and into act[i] how many clusters of
// 2^i blocks (i = 0: blocks; on route 0 only those) the card runs at once
// (lml_actives; 0: it cannot schedule one).  Returns the route (-1: n too
// large), or -2 when the runtime refused a query.
extern "C" int gpry_lbfgs_lml_fit_cluster(GpryKern kern, int R, int n, int d,
                                          int* C, int* act) {
  int stage_x, dev, sms;
  size_t smem, wpl;
  *C = 1;
  for (int i = 0; i < 5; ++i) act[i] = 0;
  const int route = gpry_lbfgs_lml_fit_plan(kern, n, d, &stage_x, &smem,
                                            &wpl);
  if (route < 0) return route;
  if (cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) !=
          cudaSuccess ||
      lml_actives(k11_kernel(kern, route), smem, route == 1, act) !=
          cudaSuccess)
    return -2;
  if (route == 1) *C = lml_cluster(R, sms, act);
  return route;
}

// theta0s (R, kern.ntheta) inside [lo, hi]; X (>= n rows, d); y (>= n);
// noise one value or one per row; work R x the plan's workspace doubles;
// C the cluster gpry_lbfgs_lml_fit_cluster gave for R lanes.  Outputs:
// theta (R, kern.ntheta), -lml (R), nev and iterations (R, int64).
extern "C" int gpry_lbfgs_lml_fit(GpryKern kern, int R, int C, int n, int d,
                                  int maxiter, const void* theta0s,
                                  const void* lo, const void* hi,
                                  const void* X, const void* y,
                                  const void* noise, int noise_is_vec,
                                  double rel_jitter, void* work,
                                  void* th_out, void* f_out, void* nev_out,
                                  void* it_out, void* stream) {
  if (R < 0 || n < 0 || !lml_cluster_ok(C)) return (int)cudaErrorInvalidValue;
  if (R == 0) return 0;
  int stage_x;
  size_t smem, wpl;
  const int route = gpry_lbfgs_lml_fit_plan(kern, n, d, &stage_x, &smem,
                                            &wpl);
  if (route < 0 || (C > 1 && route != 1))
    return (int)cudaErrorInvalidConfiguration;
  auto kernel = k11_kernel(kern, route);
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
  return (int)lml_launch(kernel, R * C, C, smem,
                         (cudaStream_t)stream, kern, R, C, D, stage_x,
                         maxiter, (const double*)theta0s, (const double*)lo,
                         (const double*)hi, (double*)work, wpl,
                         (double*)th_out, (double*)f_out,
                         (long long*)nev_out, (long long*)it_out);
}
