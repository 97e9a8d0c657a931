// K9 lbfgs_logexp_ascent: the whole multistart bounded L-BFGS ascent of
// the smooth LogExp acquisition of one Kriging-believer step, in one
// launch.
//
// Replaces gpry_tpu/acquisition/batch_optimizer.py:78-106
// _optimize_restarts: jax.vmap over the restarts of
// gpry_tpu/ops/lbfgs.py:168 minimize_lbfgs_bounded (the while_loop L-BFGS
// of :44-165, its Armijo while_loop :103-119), on the objective
//
//   F(u) = -(2 zeta (min(mu, clip_max) - y_max)
//            + 0.5 log(max(std^2 - sigma_n^2, 1e-300)))
//   at x = lo + (hi - lo) sigmoid(clip(u, -15, 15)),
//
// mu and std those of surrogate_mean_std_smooth (K8's function).  Per
// lane, step for step the algorithm of gpry_tpu_torch/ops/lbfgs.py (the
// plain version): u0 from to_unconstrained; the two-loop recursion over a
// history of 8 pairs (newest at slot 0) with gamma clipped to [1e-8, 1e8];
// steepest descent when that is no descent direction; Armijo with at most
// 18 halvings, f(u + t d) <= f + 1e-4 t g.d; a pair stored only after a
// successful line search with s.y > 1e-10; a stop on a failed line search,
// |g| < 1e-8, a non-finite f or 5 iterations in a row that improve f by
// less than 16 eps (1 + |f|); at most maxiter iterations; a lane whose f
// ends non-finite returns (x0 as mapped, f(x0)).  nev counts the
// value-and-gradient calls and the line-search probes.
//
// The gradient follows torch's autograd conventions of the plain version
// at its non-smooth points: min(mu, clip_max) gives half the gradient at a
// tie and none above; clamp_min(var, 1e-300) none below; clip(u, +-15)
// none outside; the latent variance's clamp at 0 none below 0, and at
// var = 0 exactly the std's gradient is 0 / 0 = NaN, as there.  A lane
// that starts on a training point (lane 0 of every believer step) sees
// std^2 < sigma_n^2 there: F = -2 zeta (mu - y_max) + 345.4 (the clamp),
// finite, with the mean's gradient only, and it ascends the mean until the
// log term is finite again; K9 and the plain version agree on that.
//
// Design.  One block of 128 threads per lane; the lane's state (u, f, g,
// the (S, Y, rho) history, kh, the stall count, nev) lives in shared
// memory, so a block exits when its own lane stops and nothing is read by
// the host until the launch ends.  Every evaluation is the block routine
// gpry_block_meanvar_grad of common.cuh (K8's): value and gradient at an
// accepted step, the value only (no back substitution, no gradient) at a
// line-search probe.  Warp 0 runs the L-BFGS arithmetic, lane k owning
// coordinate k (d <= 32): dot products are warp reductions.  The updates
// whose rounding decides a line search or a stall (u + t d, the Armijo
// threshold, the objective) are written with explicit roundings, as torch
// evaluates them, not contracted into fused multiply-adds.
//
// What bounds it on the H100.  Per lane a chain of dependent evaluations
// (one value-and-gradient call per iteration and a few probes), each two
// chains of n dependent warp steps (the substitutions) and four block
// barriers: latency.  The operations those evaluations need (about
// n^2 / 2 + n (3 d + 3) per probe, n^2 + n (5 d + 3) per value-and-gradient
// call) take well under a microsecond at 67 TFLOP/s; 8 lanes use 8 of the
// 132 SMs.
//
// Spec mode (template SPEC) as K8's.
#include "common.cuh"

#define K9_M 8
#define K9_LS 18
#define K9_STALL 5
#define K9_UCLIP 15.0

struct K9State {
  double f, f0, t, gd;
  long long nev;
  int kh, stall, nls, ok, stop, pad;
};

struct K9Lane {
  double *q, *sig, *u, *u0, *g, *dir, *un, *gn, *lo, *A, *S, *Y, *rho;
  K9State* st;
};

// Doubles of a lane's state: ten d-vectors, the (S, Y) history, rho and
// the scalars.
__host__ __device__ inline size_t k9_lane_doubles(int d) {
  return 10 * (size_t)d + 2 * K9_M * (size_t)d + K9_M +
         sizeof(K9State) / sizeof(double);
}

// The negated LogExp at the u-space point pu (d; coordinate k written by
// thread k), returned in every lane of warp 0; with GRAD, dF/du into gout
// (d, by warp 0's lanes).  Every thread calls it; it ends with a barrier
// inside gpry_block_meanvar_grad, then warp 0 reads the results.
template <bool SPEC, bool GRAD>
__device__ double k9_eval(const GpryGP& g, const GprySpec& spec,
                          const K9Lane& ln, const double* pu, double* gout,
                          double y_loc, double y_scale, double clip,
                          double y_max, double c1, double ns2) {
  const int tid = threadIdx.x, d = g.d;
  if (tid < d) {
    const double u = pu[tid];
    const double uc = u < -K9_UCLIP ? -K9_UCLIP : (u > K9_UCLIP ? K9_UCLIP : u);
    const double s = 1.0 / (1.0 + exp(-uc));
    const double x = __dadd_rn(ln.lo[tid], __dmul_rn(ln.A[tid], s));
    ln.sig[tid] = s;
    ln.q[tid] = (x - g.x_loc[tid]) / g.x_scale[tid] / g.ls[tid];
  }
  __syncthreads();
  gpry_block_meanvar_grad<SPEC, GRAD>(g, spec, ln.q);
  if (tid >= 32) return 0.0;
  const double var_raw = g.res[1];
  const double mu = __dadd_rn(__dmul_rn(g.res[0], y_scale), y_loc);
  const double var_c = (var_raw < 0.0) ? 0.0 : var_raw;
  const double sq = sqrt(var_c);
  const double sd = __dmul_rn(sq, y_scale);
  const double var = __dsub_rn(__dmul_rn(sd, sd), ns2);
  const double mu_c = gpry_clip(mu, clip);
  const double varcl = (var < 1e-300) ? 1e-300 : var;
  const double F = -__dadd_rn(__dmul_rn(c1, __dsub_rn(mu_c, y_max)),
                              __dmul_rn(0.5, log(varcl)));
  if (GRAD && tid < d) {
    const int k = tid;
    // torch.minimum: half the gradient at a tie, none above clip_max
    const double tie = (mu == clip) ? 0.5 : ((mu > clip) ? 0.0 : 1.0);
    const double g_mupre = (-c1 * tie) * y_scale;
    const double g_var = (var >= 1e-300) ? -0.5 / varcl : 0.0;
    const double g_sd = 2.0 * __dmul_rn(g_var, sd);  // g sd + g sd, exact
    const double g_varc = (g_sd * y_scale) / (2.0 * sq);
    const double g_vraw = (var_raw >= 0.0) ? g_varc : 0.0;
    const double gp = __dadd_rn(__dmul_rn(g_mupre, g.res[2 + k]),
                                __dmul_rn(g_vraw, g.res[2 + d + k]));
    const double s = ln.sig[k];
    const double gsig = (gp / g.x_scale[k]) * ln.A[k];
    const double gu = (gsig * (1.0 - s)) * s;
    const double u = pu[k];
    gout[k] = (u >= -K9_UCLIP && u <= K9_UCLIP) ? gu : 0.0;
  }
  return F;
}

template <bool SPEC>
__global__ void __launch_bounds__(GPRY_BLOCK_THREADS)
lbfgs_logexp_ascent_kernel(
    GpryKern kern, int R, int n, int nmax, int d, int stage_x, int maxiter,
    const double* __restrict__ x0s, const double* __restrict__ lo_g,
    const double* __restrict__ hi_g, const double* __restrict__ X,
    const double* __restrict__ alpha, const double* __restrict__ L,
    const double* __restrict__ theta, const double* __restrict__ x_loc,
    const double* __restrict__ x_scale, const double* __restrict__ scal,
    double c1, double ns2, double* __restrict__ xs_out,
    double* __restrict__ f_out, long long* __restrict__ nev_out) {
  extern __shared__ double smem[];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int r = blockIdx.x;
  GprySpec spec;
  double* tail;
  const GpryGP g = gpry_stage_gp<SPEC>(smem, kern, n, nmax, d, stage_x != 0,
                                       X, alpha, L, theta, x_loc, x_scale,
                                       &spec, &tail);
  K9Lane ln;
  ln.q = tail;
  ln.sig = ln.q + d;
  ln.u = ln.sig + d;
  ln.u0 = ln.u + d;
  ln.g = ln.u0 + d;
  ln.dir = ln.g + d;
  ln.un = ln.dir + d;
  ln.gn = ln.un + d;
  ln.lo = ln.gn + d;
  ln.A = ln.lo + d;
  ln.S = ln.A + d;
  ln.Y = ln.S + K9_M * d;
  ln.rho = ln.Y + K9_M * d;
  ln.st = (K9State*)(ln.rho + K9_M);
  K9State* st = ln.st;
  const double y_loc = scal[0], y_scale = scal[1], clip = scal[2],
               y_max = scal[5];
  const double eps = 1e-12;
  const double stall_rtol = 16.0 * 2.220446049250313e-16;

  // u0 = to_unconstrained(x0)
  if (tid < d) {
    const double lo = lo_g[tid], A = hi_g[tid] - lo;
    ln.lo[tid] = lo;
    ln.A[tid] = A;
    double t = (x0s[(size_t)r * d + tid] - lo) / A;
    t = t < 1e-9 ? 1e-9 : (t > 1.0 - 1e-9 ? 1.0 - 1e-9 : t);
    double u = log(t) - log1p(-t);
    u = u < -K9_UCLIP ? -K9_UCLIP : (u > K9_UCLIP ? K9_UCLIP : u);
    ln.u[tid] = ln.u0[tid] = u;
  }
  for (int i = tid; i < 2 * K9_M * d + K9_M; i += blockDim.x) ln.S[i] = 0.0;
  __syncthreads();
  {
    const double F = k9_eval<SPEC, true>(g, spec, ln, ln.u, ln.g, y_loc,
                                         y_scale, clip, y_max, c1, ns2);
    if (tid == 0) {
      st->f = st->f0 = F;
      st->stop = !isfinite(F);
      st->nev = 1;
      st->kh = 0;
      st->stall = 0;
    }
  }
  __syncthreads();

  const bool on = lane < d;
  for (int it = 0; it < maxiter; ++it) {
    if (st->stop) break;
    // the two-loop direction and the steepest-descent safeguard (warp 0)
    if (warp == 0) {
      const int kh = st->kh;
      const double gk = on ? ln.g[lane] : 0.0;
      double qk = gk;
      double alf[K9_M];
#pragma unroll
      for (int j = 0; j < K9_M; ++j) {
        const double sj = on ? ln.S[j * d + lane] : 0.0;
        const double yj = on ? ln.Y[j * d + lane] : 0.0;
        const double dot = gpry_warp_sum(sj * qk);
        const double a = j < kh ? ln.rho[j] * dot : 0.0;
        qk = __dsub_rn(qk, __dmul_rn(a, yj));
        alf[j] = a;
      }
      const double s0 = on ? ln.S[lane] : 0.0, y0 = on ? ln.Y[lane] : 0.0;
      const double yy = gpry_warp_sum(y0 * y0);
      const double sy0 = gpry_warp_sum(s0 * y0);
      double gamma = kh > 0 ? sy0 / (yy < eps ? eps : yy) : 1.0;
      gamma = gamma < 1e-8 ? 1e-8 : (gamma > 1e8 ? 1e8 : gamma);
      double rk = __dmul_rn(gamma, qk);
#pragma unroll
      for (int j = K9_M - 1; j >= 0; --j) {
        const double sj = on ? ln.S[j * d + lane] : 0.0;
        const double yj = on ? ln.Y[j * d + lane] : 0.0;
        const double dot = gpry_warp_sum(yj * rk);
        const double b = j < kh ? ln.rho[j] * dot : 0.0;
        const double c = j < kh ? alf[j] - b : 0.0;
        rk = __dadd_rn(rk, __dmul_rn(c, sj));
      }
      double dk = -rk;
      double gd = gpry_warp_sum(gk * dk);
      if (!(gd < 0.0)) {
        dk = -gk;
        gd = gpry_warp_sum(gk * dk);
      }
      if (on) ln.dir[lane] = dk;
      if (lane == 0) {
        st->gd = gd;
        st->t = 1.0;
        st->ok = 0;
        st->nls = 0;
      }
    }
    __syncthreads();
    // Armijo backtracking: the probes are value-only evaluations
    for (int ls = 0; ls < K9_LS; ++ls) {
      if (tid < d)
        ln.un[tid] = __dadd_rn(ln.u[tid], __dmul_rn(st->t, ln.dir[tid]));
      const double Ft = k9_eval<SPEC, false>(g, spec, ln, ln.un, nullptr,
                                             y_loc, y_scale, clip, y_max, c1,
                                             ns2);
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
      if (st->ok) break;
    }
    if (tid == 0) {
      if (!st->ok) st->t = 0.0;
      st->nev += st->nls + 1;
    }
    __syncthreads();
    if (tid < d)
      ln.un[tid] = __dadd_rn(ln.u[tid], __dmul_rn(st->t, ln.dir[tid]));
    const double Fn = k9_eval<SPEC, true>(g, spec, ln, ln.un, ln.gn, y_loc,
                                          y_scale, clip, y_max, c1, ns2);
    // the history, the stops and the step (warp 0)
    if (warp == 0) {
      const double uk = on ? ln.u[lane] : 0.0, unk = on ? ln.un[lane] : 0.0;
      const double gk = on ? ln.g[lane] : 0.0, gnk = on ? ln.gn[lane] : 0.0;
      const double s = unk - uk, y = gnk - gk;
      const double sy = gpry_warp_sum(s * y);
      const double gnorm = sqrt(gpry_warp_sum(gnk * gnk));
      const bool store = st->ok && sy > 1e-10;
      if (store && on) {
        for (int j = K9_M - 1; j > 0; --j) {
          ln.S[j * d + lane] = ln.S[(j - 1) * d + lane];
          ln.Y[j * d + lane] = ln.Y[(j - 1) * d + lane];
        }
        ln.S[lane] = s;
        ln.Y[lane] = y;
      }
      if (on) {
        ln.u[lane] = unk;
        ln.g[lane] = gnk;
      }
      __syncwarp();
      if (lane == 0) {
        if (store) {
          for (int j = K9_M - 1; j > 0; --j) ln.rho[j] = ln.rho[j - 1];
          ln.rho[0] = 1.0 / (sy < eps ? eps : sy);
          st->kh += 1;
        }
        const bool improved =
            (st->f - Fn) > stall_rtol * (1.0 + fabs(Fn));
        const int stall = improved ? 0 : st->stall + 1;
        st->stall = stall;
        st->stop = !st->ok || gnorm < 1e-8 || !isfinite(Fn) ||
                   stall >= K9_STALL;
        st->f = Fn;
      }
    }
    __syncthreads();
  }
  // the loop ends after a barrier: every thread reads the same f
  const bool bad = !isfinite(st->f);
  if (tid < d) {
    const double u = bad ? ln.u0[tid] : ln.u[tid];
    const double uc = u < -K9_UCLIP ? -K9_UCLIP : (u > K9_UCLIP ? K9_UCLIP : u);
    const double s = 1.0 / (1.0 + exp(-uc));
    xs_out[(size_t)r * d + tid] = __dadd_rn(ln.lo[tid], __dmul_rn(ln.A[tid], s));
  }
  if (tid == 0) {
    f_out[r] = bad ? st->f0 : st->f;
    nev_out[r] = st->nev;
  }
}

// scal = [y_loc, y_scale, clip_max, svm intercept, svm gamma, y_max]; c1 =
// 2 zeta, ns2 = sigma_n^2 (raw units), both as the plain version rounds
// them.
extern "C" int gpry_lbfgs_logexp_ascent(
    GpryKern kern, int R, int n, int nmax, int d, int maxiter,
    const void* x0s, const void* lo, const void* hi, const void* X,
    const void* alpha, const void* L, const void* theta, const void* x_loc,
    const void* x_scale, const void* scal, double c1, double ns2,
    void* xs_out, void* f_out, void* nev_out, void* stream) {
  if (d > GPRY_GRAD_MAX_D || R < 0) return (int)cudaErrorInvalidValue;
  if (R == 0) return 0;
  const size_t spec = gpry_spec_doubles(kern);
  const size_t lane = k9_lane_doubles(d);
  bool stage_x = true;
  size_t smem = sizeof(double) * (gpry_gp_doubles(n, d, true, spec) + lane);
  if (smem > GPRY_MAX_SMEM) {
    stage_x = false;
    smem = sizeof(double) * (gpry_gp_doubles(n, d, false, spec) + lane);
  }
  if (smem > GPRY_MAX_SMEM) return (int)cudaErrorInvalidConfiguration;
  auto kernel = kern.nodes ? lbfgs_logexp_ascent_kernel<true>
                           : lbfgs_logexp_ascent_kernel<false>;
  cudaError_t e = gpry_set_smem(kernel, smem);
  if (e != cudaSuccess) return (int)e;
  kernel<<<R, GPRY_BLOCK_THREADS, smem, (cudaStream_t)stream>>>(
      kern, R, n, nmax, d, (int)stage_x, maxiter, (const double*)x0s,
      (const double*)lo, (const double*)hi, (const double*)X,
      (const double*)alpha, (const double*)L, (const double*)theta,
      (const double*)x_loc, (const double*)x_scale, (const double*)scal, c1,
      ns2, (double*)xs_out, (double*)f_out, (long long*)nev_out);
  return (int)cudaGetLastError();
}
