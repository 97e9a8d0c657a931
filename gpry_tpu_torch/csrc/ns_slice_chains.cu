// K6 ns_slice_chains: the B constrained slice-sampling chains of one
// nested-sampling outer step, all num_repeats updates, in one launch.
//
// Replaces gpry_tpu/mc/nested.py:51 _slice_chain as vmapped over the kill
// batch inside _ns_segment (gpry_tpu/mc/nested.py:256-270), with the gated
// surrogate mean as the log-density (gpry_tpu/models/gp.py:121, K1's
// function) and -inf outside the prior box.  Per chain b and repeat r, from
// the pre-drawn nrm[r][b] (d normals) and u[r][.][b] (1 + 30 uniforms):
//
//   e = chol (nrm / |nrm|);  w0 = 0.9 u0 + 0.05;  [tlo, thi] = [-w0, 1 - w0]
//   step out: while l(x + tlo e) > lstar or l(x + thi e) > lstar, at most
//     6 times, double each end that is above lstar and re-evaluate it;
//   shrink: at most 30 times t = tlo + (thi - tlo) u_{1+i}; accept the
//     first l(x + t e) > lstar (strictly), else a miss replaces tlo when
//     t < 0 and thi otherwise;
//   calls: +2 for the first ends, +2 per doubling, +1 per shrink.
//
// These are the semantics of the lock-step loop in ops/fused.py
// (slice_chains_lockstep), which are those of JAX's _slice_chain; the draws
// come from the caller, so both versions see the same numbers.
//
// Design.  One block of 128 threads per chain; the chain's whole loop runs
// inside the block.  The block stages the surrogate (X / l, alpha, support
// vectors, duals) in shared memory once (a surrogate beyond the 227 KB a
// block can hold keeps its support vectors, then also X / l, in a copy in
// global memory that a staging kernel writes first, in the same layout and
// with the same arithmetic), then every log-density evaluation
// is the block-cooperative gated mean of common.cuh: the threads split the
// n training rows and the support vectors, and both step-out ends are
// summed in one pass with two accumulators (an end that did not move keeps
// its value: the evaluation is deterministic).  Every thread keeps the same
// copy of the chain's scalars (t, the bracket, the log-densities, calls).
//
// What bounds it on the H100.  Per chain, a chain of up to 37 x R
// dependent block reductions (each a few exponentials per thread, a warp
// shuffle tree and two barriers), so latency, not the FP64 rate: the
// work is 10-20 evaluations per repeat.  B = 33-66 chains fill a quarter
// to a half of the 132 SMs.  The operations bound, counting only the sums
// the chains need, is about a microsecond at B = 66, R = 40 (PERF.md).
//
// Spec mode (template SPEC): the staged surrogate holds X as it is plus the
// spec program, and each evaluation's rows run the interpreter of
// common.cuh (gpry_block_gated_mean2<true>); the staging kernel then copies
// X unscaled.
#include "common.cuh"

#define K6_SHRINKS 30
#define K6_STEP_OUT 6
#define K6_U (1 + K6_SHRINKS)

// GX / GSV: X / l / the support vectors are read from the staged copy in
// global memory (g_xt / g_svt).  Without them the pointers are known to be
// null, so that the shared-memory path compiles to shared-memory loads.
template <bool SPEC, bool GX, bool GSV>
__global__ void __launch_bounds__(GPRY_BLOCK_THREADS)
ns_slice_chains_kernel(
    GpryKern kern, int B, int R, int n, int nsv, int d,
    const double* __restrict__ x0, const double* __restrict__ lx0,
    const double* __restrict__ lstar_p, const double* __restrict__ chol,
    const double* __restrict__ box_lo, const double* __restrict__ box_hi,
    const double* __restrict__ nrm, const double* __restrict__ u,
    const double* __restrict__ X, const double* __restrict__ alpha,
    const double* __restrict__ theta, const double* __restrict__ x_loc,
    const double* __restrict__ x_scale, const double* __restrict__ trust_lo,
    const double* __restrict__ trust_hi, const double* __restrict__ sv,
    const double* __restrict__ dual, const double* __restrict__ scal,
    int svm_mode, const double* g_xt, const double* g_svt,
    double* __restrict__ x_out, double* __restrict__ lx_out,
    long long* __restrict__ calls_out) {
  extern __shared__ double smem[];
  const int tid = threadIdx.x;
  const int b = blockIdx.x;
  GpryEvalScratch sc;
  GprySpec spec;
  const GprySurrogate s = gpry_stage_surrogate<SPEC>(
      smem, &sc, kern, n, nsv, d, X, alpha, theta, x_loc, x_scale,
      trust_lo, trust_hi, sv, dual, scal, svm_mode, GX ? g_xt : nullptr,
      GSV ? g_svt : nullptr, &spec);
  // chain state behind the evaluation scratch: x, e, the box, the uniforms
  double* x = sc.tail;
  double* e = x + d;
  double* lo = e + d;
  double* hi = lo + d;
  double* su = hi + d;
  if (tid < d) {
    x[tid] = x0[(size_t)b * d + tid];
    lo[tid] = box_lo[tid];
    hi[tid] = box_hi[tid];
  }
  const double lstar = *lstar_p;
  double lx = lx0[b];
  long long calls = 0;
  double t = 0.0;
  bool accepted = false;

  for (int r = 0; r < R; ++r) {
    // the previous repeat's move, this repeat's direction and uniforms
    if (tid < d) {
      if (accepted) x[tid] = __dadd_rn(x[tid], __dmul_rn(t, e[tid]));
      const double* z = nrm + ((size_t)r * B + b) * d;
      double ss = 0.0;
      for (int j = 0; j < d; ++j) ss += z[j] * z[j];
      const double norm = sqrt(ss);
      double acc = 0.0;
      for (int j = 0; j < d; ++j) acc += (z[j] / norm) * chol[tid * d + j];
      e[tid] = acc;
    }
    if (tid < K6_U) su[tid] = u[((size_t)r * K6_U + tid) * B + b];
    __syncthreads();

    // step out by doubling, capped
    const double w0 = __dadd_rn(__dmul_rn(su[0], 0.9), 0.05);
    double tlo = -w0, thi = __dsub_rn(1.0, w0);
    double v[2];
    gpry_block_gated_mean2<SPEC>(s, spec, &sc, 3, x, x, e, tlo, thi, lo, hi, v);
    double l_lo = v[0], l_hi = v[1];
    calls += 2;
    for (int it = 0; it < K6_STEP_OUT; ++it) {
      const bool up_lo = l_lo > lstar, up_hi = l_hi > lstar;
      if (!(up_lo || up_hi)) break;
      if (up_lo) tlo = tlo * 2.0;
      if (up_hi) thi = thi * 2.0;
      gpry_block_gated_mean2<SPEC>(s, spec, &sc,
                                   (up_lo ? 1 : 0) | (up_hi ? 2 : 0), x, x,
                                   e, tlo, thi, lo, hi, v);
      if (up_lo) l_lo = v[0];
      if (up_hi) l_hi = v[1];
      calls += 2;
    }

    // shrinkage
    t = 0.0;
    accepted = false;
    double l_new = lx;
    for (int it = 0; it < K6_SHRINKS; ++it) {
      const double t_try =
          __dadd_rn(tlo, __dmul_rn(__dsub_rn(thi, tlo), su[1 + it]));
      gpry_block_gated_mean2<SPEC>(s, spec, &sc, 1, x, x, e, t_try, t_try,
                                   lo, hi, v);
      calls += 1;
      t = t_try;
      l_new = v[0];
      if (v[0] > lstar) {
        accepted = true;
        break;
      }
      if (t_try < 0) tlo = t_try;
      else if (t_try >= 0) thi = t_try;
    }
    if (accepted) lx = l_new;
    // every thread has read x, e and su for this repeat
    __syncthreads();
  }
  if (tid < d) {
    x_out[(size_t)b * d + tid] =
        accepted ? __dadd_rn(x[tid], __dmul_rn(t, e[tid])) : x[tid];
  }
  if (tid == 0) {
    lx_out[b] = lx;
    calls_out[b] = calls;
  }
}

// X / l and the support vectors in the staged (column-major) layout, for a
// surrogate that does not fit in shared memory; the arithmetic of
// gpry_stage_surrogate, so that both copies hold the same numbers (X as it
// is in spec mode).
__global__ void ns_stage_global_kernel(int spec, int n, int nsv, int d,
                                       const double* __restrict__ X,
                                       const double* __restrict__ theta,
                                       const double* __restrict__ sv,
                                       double* xt, double* svt) {
  const int stride = gridDim.x * blockDim.x;
  const int i0 = blockIdx.x * blockDim.x + threadIdx.x;
  if (xt) {
    for (int idx = i0; idx < n * d; idx += stride) {
      const int j = idx / d, k = idx - j * d;
      xt[(size_t)k * n + j] = X[idx] / (spec ? 1.0 : exp(theta[1 + k]));
    }
  }
  if (svt) {
    for (int idx = i0; idx < nsv * d; idx += stride) {
      const int j = idx / d, k = idx - j * d;
      svt[(size_t)k * nsv + j] = sv[idx];
    }
  }
}

// Where K6 keeps the surrogate: 0 all of it in shared memory, 1 the support
// vectors in global memory, 2 X / l as well.  nsv_eff counts the support
// vectors of the fitted SVM mode only; spec the staged program's doubles.
static int ns_stage_plan(int n, int nsv_eff, int d, size_t spec) {
  const size_t rest = gpry_eval_doubles(d) + 4 * (size_t)d + K6_U;
  if (sizeof(double) * (gpry_staged_doubles(n, nsv_eff, d, spec) + rest) <=
      GPRY_MAX_SMEM)
    return 0;
  if (sizeof(double) * (gpry_staged_doubles(n, 0, d, spec) + rest) <=
      GPRY_MAX_SMEM)
    return 1;
  return 2;
}

static size_t ns_smem(int plan, int n, int nsv_eff, int d, size_t spec) {
  return sizeof(double) *
         (gpry_staged_doubles(plan == 2 ? 0 : n, plan >= 1 ? 0 : nsv_eff, d,
                              spec) +
          gpry_eval_doubles(d) + 4 * (size_t)d + K6_U);
}

// Doubles of global memory K6 needs for a surrogate of n valid rows and
// nsv support vectors (0 when it fits in shared memory).
extern "C" size_t gpry_ns_slice_chains_work(GpryKern kern, int n, int nsv,
                                            int d, int svm_mode) {
  const int nsv_eff = svm_mode == GPRY_MODE_FITTED ? nsv : 0;
  const int plan = ns_stage_plan(n, nsv_eff, d, gpry_spec_doubles(kern));
  return (size_t)d * ((plan == 2 ? (size_t)n : 0) +
                      (plan >= 1 ? (size_t)nsv_eff : 0));
}

// x0 (B, d), lx0 (B,), lstar a device scalar, chol (d, d) row-major, the
// box (d,) twice, nrm (R, B, d), u (R, 31, B); outputs x (B, d), lx (B,),
// calls (B,) int64.  scal as K1's.  work: gpry_ns_slice_chains_work doubles
// of device memory (may be null when that is 0).
extern "C" int gpry_ns_slice_chains(
    GpryKern kern, int B, int R, int n, int nsv, int d, const void* x0,
    const void* lx0, const void* lstar, const void* chol, const void* lo,
    const void* hi, const void* nrm, const void* u, const void* X,
    const void* alpha, const void* theta, const void* x_loc,
    const void* x_scale, const void* trust_lo, const void* trust_hi,
    const void* sv, const void* dual, const void* scal, int svm_mode,
    void* work, void* x_out, void* lx_out, void* calls_out, void* stream) {
  if (B <= 0) return 0;
  if (2 * d > GPRY_BLOCK_THREADS) return (int)cudaErrorInvalidValue;
  const int nsv_eff = svm_mode == GPRY_MODE_FITTED ? nsv : 0;
  const size_t spec = gpry_spec_doubles(kern);
  const int plan = ns_stage_plan(n, nsv_eff, d, spec);
  double* g_xt = plan == 2 ? (double*)work : nullptr;
  double* g_svt = plan >= 1 && nsv_eff > 0
                      ? (double*)work + (plan == 2 ? (size_t)d * n : 0)
                      : nullptr;
  if ((g_xt || g_svt) && !work) return (int)cudaErrorInvalidValue;
  if (g_xt || g_svt) {
    const int items = (n > nsv_eff ? n : nsv_eff) * d;
    const int blocks = (items + 255) / 256 < 1024 ? (items + 255) / 256 : 1024;
    ns_stage_global_kernel<<<blocks, 256, 0, (cudaStream_t)stream>>>(
        kern.nodes > 0, n, nsv_eff, d, (const double*)X, (const double*)theta,
        (const double*)sv, g_xt, g_svt);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  const size_t smem = ns_smem(plan, n, nsv_eff, d, spec);
  auto kernel =
      kern.nodes ? (g_xt    ? ns_slice_chains_kernel<true, true, true>
                    : g_svt ? ns_slice_chains_kernel<true, false, true>
                            : ns_slice_chains_kernel<true, false, false>)
                 : (g_xt    ? ns_slice_chains_kernel<false, true, true>
                    : g_svt ? ns_slice_chains_kernel<false, false, true>
                            : ns_slice_chains_kernel<false, false, false>);
  cudaError_t err = gpry_set_smem(kernel, smem);
  if (err != cudaSuccess) return (int)err;
  kernel<<<B, GPRY_BLOCK_THREADS, smem, (cudaStream_t)stream>>>(
      kern, B, R, n, nsv, d, (const double*)x0, (const double*)lx0,
      (const double*)lstar, (const double*)chol, (const double*)lo,
      (const double*)hi, (const double*)nrm, (const double*)u,
      (const double*)X, (const double*)alpha, (const double*)theta,
      (const double*)x_loc, (const double*)x_scale,
      (const double*)trust_lo, (const double*)trust_hi, (const double*)sv,
      (const double*)dual, (const double*)scal, svm_mode, g_xt, g_svt,
      (double*)x_out, (double*)lx_out, (long long*)calls_out);
  return (int)cudaGetLastError();
}
