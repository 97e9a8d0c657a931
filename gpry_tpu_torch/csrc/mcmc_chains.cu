// K12 mcmc_chains: every step of one phase of the adaptive Metropolis
// ensemble on the gated surrogate, for all B chains, in one launch.
//
// Replaces the scanned `phase` of gpry_tpu/mc/mcmc.py:44 run_mcmc_device
// (its step at :80-101, the two scans at :103-121), with the gated
// surrogate mean as the log-density (gpry_tpu/models/gp.py:121, K1's
// function) and -inf outside the prior box.  Per step i and chain b, from
// the pre-drawn z[i][b] (d normals) and u[i][b]:
//
//   prop = x_b + exp(log_step) (chol z[i][b])
//   lp_prop = gated mean at prop (-inf outside the prior box)
//   accept  = log u[i][b] < lp_prop - lp_b;  x_b, lp_b = prop, lp_prop if so
//
// and in the warm-up instance (adapt), after every step of all chains:
//
//   log_step += 0.05 (accepted / B - 0.234)      (Robbins-Monro)
//   s1 += sum_b x_b;  s2 += sum_b x_b x_b^T       (the moment sums)
//
// These are the semantics of ops/fused.py mcmc_chains_plain, the loop the
// port ran before; the draws come from the caller, so both versions see the
// same numbers.  The roundings that decide an accept or the step size are
// explicit (__dadd_rn, __dmul_rn, __dsub_rn, __ddiv_rn), so that the step
// size is bit-identical to the plain version's whenever the accept
// decisions are.
//
// Design.  One block for the ensemble, a warp per chain (min(B, 32) warps;
// a warp loops over its chains when B > 32).  The block stages the
// surrogate in shared memory once (gpry_stage_surrogate; beyond shared
// memory the support vectors, then X / l as well, are read from a staged
// copy in global memory, as K6 reads them), with the proposal's Cholesky
// factor and the prior box.  Each evaluation is the warp-level gated mean
// of common.cuh (gpry_warp_gated_mean): the lanes split the n training
// rows and the support vectors and reduce with warp shuffles; the lanes
// own the coordinates of the proposal.  The chains' states live in the
// output buffers in global memory (L1), each chain's row touched only by
// its warp.  The warm-up couples the chains once a step: every warp writes
// its accept flag, one block barrier, then every thread sums the flags in
// the same order (so all hold the same step size) and the threads add the
// step's moment sums, each owning entries of s1 and s2, and one more
// barrier.  The sampling phase has no coupling: each warp runs its chains'
// whole trajectories with no barrier.
//
// What bounds it on the H100.  Latency: per chain and step, one dependent
// chain of a d-term proposal, ~n/32 kernel values a lane, two five-step
// shuffle trees and a log; the warm-up adds two block barriers a step.
// The FP64 operations bound (the sums the inputs need, PERF.md) is
// microseconds for a whole phase.
//
// Spec mode (template SPEC): the staged surrogate holds X as it is plus the
// spec program, and each row runs the interpreter of common.cuh.
#include "common.cuh"

#define K12_MAX_WARPS 32

struct K12Chain {
  double* prop;  // the warp's proposal (d)
  double* qpre;  // its scratch (d each)
  double* qls;
};

// One Metropolis step of chain b at step i by its warp; returns the accept
// decision (the same on every lane).  x, lp: the chains' states (global).
template <bool SPEC>
__device__ __forceinline__ bool k12_step(
    const GprySurrogate& s, const GprySpec& spec, const K12Chain& w,
    const double* chol, const double* lo, const double* hi,
    const double* __restrict__ z, const double* __restrict__ u, int B, int d,
    int i, int b, double es, double* x, double* lp, double* Xs, double* lps,
    int lane) {
  const double lp_b = lp[b];
  const double* zr = z + ((size_t)i * B + b) * d;
  for (int k = lane; k < d; k += 32) {
    double acc = 0.0;
    for (int j = 0; j < d; ++j) acc += zr[j] * chol[k * d + j];
    w.prop[k] = __dadd_rn(x[(size_t)b * d + k], __dmul_rn(es, acc));
  }
  __syncwarp();
  const double lpp =
      gpry_warp_gated_mean<SPEC>(s, spec, w.prop, w.qpre, w.qls, lo, hi, lane);
  const bool accept = log(u[(size_t)i * B + b]) < __dsub_rn(lpp, lp_b);
  for (int k = lane; k < d; k += 32) {
    const double v = accept ? w.prop[k] : x[(size_t)b * d + k];
    x[(size_t)b * d + k] = v;
    Xs[((size_t)i * B + b) * d + k] = v;
  }
  if (lane == 0) {
    const double v = accept ? lpp : lp_b;
    lp[b] = v;
    lps[(size_t)i * B + b] = v;
  }
  __syncwarp();
  return accept;
}

template <bool SPEC, bool GX, bool GSV>
__global__ void __launch_bounds__(K12_MAX_WARPS * 32)
mcmc_chains_kernel(
    GpryKern kern, int B, int nsteps, int n, int nsv, int d, int adapt,
    const double* __restrict__ x0, const double* __restrict__ lp0,
    const double* __restrict__ log_step0, const double* __restrict__ chol_g,
    const double* __restrict__ box_lo, const double* __restrict__ box_hi,
    const double* __restrict__ z, const double* __restrict__ u,
    const double* __restrict__ X, const double* __restrict__ alpha,
    const double* __restrict__ theta, const double* __restrict__ x_loc,
    const double* __restrict__ x_scale, const double* __restrict__ trust_lo,
    const double* __restrict__ trust_hi, const double* __restrict__ sv,
    const double* __restrict__ dual, const double* __restrict__ scal,
    int svm_mode, const double* g_xt, const double* g_svt, double* x,
    double* lp, double* log_step_out, double* s1, double* s2, double* Xs,
    double* lps) {
  extern __shared__ double smem[];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int nw = blockDim.x >> 5, nt = blockDim.x;
  GpryEvalScratch sc;
  GprySpec spec;
  const GprySurrogate s = gpry_stage_surrogate<SPEC>(
      smem, &sc, kern, n, nsv, d, X, alpha, theta, x_loc, x_scale,
      trust_lo, trust_hi, sv, dual, scal, svm_mode, GX ? g_xt : nullptr,
      GSV ? g_svt : nullptr, &spec);
  // behind the staged surrogate: chol, the box, the warps' scratch, the
  // accept flags
  double* chol = sc.tail;
  double* lo = chol + (size_t)d * d;
  double* hi = lo + d;
  double* wscr = hi + d;
  int* accf = (int*)(wscr + 3 * (size_t)d * nw);
  for (int e = tid; e < d * d; e += nt) chol[e] = chol_g[e];
  for (int k = tid; k < d; k += nt) {
    lo[k] = box_lo[k];
    hi[k] = box_hi[k];
  }
  for (int e = tid; e < B * d; e += nt) x[e] = x0[e];
  for (int b = tid; b < B; b += nt) lp[b] = lp0[b];
  for (int e = tid; e < d + d * d; e += nt) {
    if (e < d) s1[e] = 0.0;
    else s2[e - d] = 0.0;
  }
  __syncthreads();
  K12Chain w;
  w.prop = wscr + 3 * (size_t)d * warp;
  w.qpre = w.prop + d;
  w.qls = w.qpre + d;
  double log_step = *log_step0;

  if (adapt) {
    for (int i = 0; i < nsteps; ++i) {
      const double es = exp(log_step);
      for (int b = warp; b < B; b += nw) {
        const bool a = k12_step<SPEC>(s, spec, w, chol, lo, hi, z, u, B, d, i,
                                      b, es, x, lp, Xs, lps, lane);
        if (lane == 0) accf[b] = a;
      }
      __syncthreads();
      int count = 0;
      for (int b = 0; b < B; ++b) count += accf[b];
      log_step = __dadd_rn(
          log_step,
          __dmul_rn(0.05, __dsub_rn(__ddiv_rn((double)count, (double)B),
                                    0.234)));
      for (int e = tid; e < d + d * d; e += nt) {
        double acc = 0.0;
        if (e < d) {
          for (int b = 0; b < B; ++b) acc += x[(size_t)b * d + e];
          s1[e] += acc;
        } else {
          const int r = (e - d) / d, c = (e - d) - r * d;
          for (int b = 0; b < B; ++b)
            acc += x[(size_t)b * d + r] * x[(size_t)b * d + c];
          s2[e - d] += acc;
        }
      }
      __syncthreads();
    }
  } else {
    const double es = exp(log_step);
    for (int b = warp; b < B; b += nw)
      for (int i = 0; i < nsteps; ++i)
        k12_step<SPEC>(s, spec, w, chol, lo, hi, z, u, B, d, i, b, es, x, lp,
                       Xs, lps, lane);
  }
  if (tid == 0) *log_step_out = log_step;
}

static int k12_warps(int B) { return B < K12_MAX_WARPS ? B : K12_MAX_WARPS; }

// Shared memory K12 needs besides the staged surrogate: the evaluation
// scratch that gpry_stage_surrogate carves, chol, the box, three d-vectors
// a warp and the accept flags (two ints a double).
static size_t k12_rest(int B, int d) {
  return gpry_eval_doubles(d) + (size_t)d * d + 2 * (size_t)d +
         3 * (size_t)d * k12_warps(B) + ((size_t)B + 1) / 2;
}

// Bytes of shared memory K12 needs with the whole surrogate in global
// memory: beyond GPRY_MAX_SMEM it cannot run (d above ~140 at 32 warps).
extern "C" size_t gpry_mcmc_chains_min_smem(GpryKern kern, int B, int d) {
  return sizeof(double) *
         (gpry_staged_doubles(0, 0, d, gpry_spec_doubles(kern)) +
          k12_rest(B, d));
}

// Doubles of global memory K12 needs for a surrogate of n valid rows and
// nsv support vectors (0 when it fits in shared memory).
extern "C" size_t gpry_mcmc_chains_work(GpryKern kern, int B, int n, int nsv,
                                        int d, int svm_mode) {
  const int nsv_eff = svm_mode == GPRY_MODE_FITTED ? nsv : 0;
  return gpry_stage_work(
      gpry_stage_plan(n, nsv_eff, d, gpry_spec_doubles(kern), k12_rest(B, d)),
      n, nsv_eff, d);
}

// x (B, d), lp (B,), log_step a device scalar, chol (d, d) row-major, the
// box (d,) twice, z (nsteps, B, d), u (nsteps, B); outputs x (B, d), lp
// (B,), log_step, s1 (d,), s2 (d, d) (zero unless adapt), the visited
// states X (nsteps, B, d) and lp (nsteps, B).  scal as K1's.  work:
// gpry_mcmc_chains_work doubles of device memory (may be null when that is
// 0).
extern "C" int gpry_mcmc_chains(
    GpryKern kern, int B, int nsteps, int n, int nsv, int d, int adapt,
    const void* x0, const void* lp0, const void* log_step, const void* chol,
    const void* lo, const void* hi, const void* z, const void* u,
    const void* X, const void* alpha, const void* theta, const void* x_loc,
    const void* x_scale, const void* trust_lo, const void* trust_hi,
    const void* sv, const void* dual, const void* scal, int svm_mode,
    void* work, void* x_out, void* lp_out, void* log_step_out, void* s1,
    void* s2, void* Xs, void* lps, void* stream) {
  if (B <= 0 || nsteps <= 0) return 0;
  if (gpry_mcmc_chains_min_smem(kern, B, d) > GPRY_MAX_SMEM)
    return (int)cudaErrorInvalidValue;
  const int nsv_eff = svm_mode == GPRY_MODE_FITTED ? nsv : 0;
  const size_t spec = gpry_spec_doubles(kern);
  const size_t rest = k12_rest(B, d);
  const int plan = gpry_stage_plan(n, nsv_eff, d, spec, rest);
  double *g_xt, *g_svt;
  cudaError_t err = gpry_stage_global(plan, kern, n, nsv_eff, d, X, theta, sv,
                                      work, &g_xt, &g_svt,
                                      (cudaStream_t)stream);
  if (err != cudaSuccess) return (int)err;
  const size_t smem = gpry_stage_smem(plan, n, nsv_eff, d, spec, rest);
  auto kernel =
      kern.nodes ? (g_xt    ? mcmc_chains_kernel<true, true, true>
                    : g_svt ? mcmc_chains_kernel<true, false, true>
                            : mcmc_chains_kernel<true, false, false>)
                 : (g_xt    ? mcmc_chains_kernel<false, true, true>
                    : g_svt ? mcmc_chains_kernel<false, false, true>
                            : mcmc_chains_kernel<false, false, false>);
  err = gpry_set_smem(kernel, smem);
  if (err != cudaSuccess) return (int)err;
  kernel<<<1, 32 * k12_warps(B), smem, (cudaStream_t)stream>>>(
      kern, B, nsteps, n, nsv, d, adapt, (const double*)x0,
      (const double*)lp0, (const double*)log_step, (const double*)chol,
      (const double*)lo, (const double*)hi, (const double*)z,
      (const double*)u, (const double*)X, (const double*)alpha,
      (const double*)theta, (const double*)x_loc, (const double*)x_scale,
      (const double*)trust_lo, (const double*)trust_hi, (const double*)sv,
      (const double*)dual, (const double*)scal, svm_mode, g_xt, g_svt,
      (double*)x_out, (double*)lp_out, (double*)log_step_out, (double*)s1,
      (double*)s2, (double*)Xs, (double*)lps);
  return (int)cudaGetLastError();
}
