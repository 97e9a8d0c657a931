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
// Design.  One block of k6_threads(SPEC) threads per chain (for a spec
// program a cluster of two blocks that split the rows, k6_cluster); the
// chain's whole loop runs inside the block, every thread with the same copy
// of the chain's scalars (t, the bracket, calls).  The block stages the
// surrogate (X / l, alpha, support vectors, duals) in shared memory once (a
// surrogate beyond the 227 KB a block can hold keeps its support vectors,
// then also X / l, in a copy in global memory that a staging kernel writes
// first, in the same layout and with the same arithmetic).  Every
// log-density evaluation is a pass of gpry_block_gated_mean_line
// (common.cuh): up to K6_P points of the chain's line x + t e summed
// together, a warp a point, two barriers a pass, each point with the same
// arithmetic whatever shares its pass.  What costs is the number of
// dependent passes, so each pass carries every point whose value may be
// needed next:
// * Step out.  The ends after k doublings are tlo 2^k and thi 2^k (exact),
//   known before any is evaluated, and only their values at k < 6 decide
//   (the sixth doubling is taken, never read).  One pass evaluates both
//   ends' whole ladders, k < 6; the reference's rule is then walked over
//   the values: an end doubles until its value is not above lstar, at
//   most 6 times.
// * Shrink.  Candidate i + 1 depends only on whether candidate i was
//   accepted and on the sign of its t, which is known before it is
//   evaluated: given misses, the candidates are a chain, not a tree.  A
//   pass evaluates the next K6_WIDTH candidates as if the earlier ones of
//   the pass missed; the first accepted one ends the update, and the
//   later ones were wasted work, not calls.
// calls counts the reference's calls: +2 for the first ends, +2 per
// doubling step, +1 per shrink it takes.  passes (optional) counts the
// passes a chain made: per repeat 1 + ceil(shrinks / K6_WIDTH).
//
// What bounds it on the H100.  Per chain a chain of dependent passes (a
// few exponentials a thread per point, a warp shuffle tree and two
// barriers each): latency, not the FP64 rate.  B = 33-66 chains fill a
// quarter to a half of the 132 SMs (a spec program's clusters: a half to
// all).  The operations bound, counting only the sums the chains need, is
// about a microsecond at B = 66, R = 40 (PERF.md).
//
// Spec mode (template SPEC): the staged surrogate holds X as it is plus the
// spec program, and each evaluation's rows run the interpreter of
// common.cuh (gpry_block_gated_mean_line<true>); the staging kernel then copies
// X unscaled.
//
// The stop flag.  In a nested-sampling run K6 follows K13 (ns_step.cu) on
// the stream, which writes the run's stop flag `done` on the device; a
// step queued after the stop finds it set, and every block returns its
// chain's start with no call.
#include "common.cuh"


#define K6_SHRINKS 30
#define K6_STEP_OUT 6
#define K6_U (1 + K6_SHRINKS)
// Threads a block: a spec program's 16 warps give every point of the
// widest pass its warp (its interpreter's rows are the cost); the fast
// families' 8 warps take the widest pass in two rounds but run the
// chain's scalar code, which every thread repeats, in half the warps
// (PERF.md, section 6: both measured).
__host__ __device__ constexpr int k6_threads(bool spec) {
  return spec ? 512 : 256;
}
// Blocks a chain: a spec program's two split the rows and meet through
// distributed shared memory (its interpreter's rows are the cost); a fast
// family's row sums are cheaper than the cluster barrier.
__host__ __device__ constexpr int k6_cluster(bool spec) {
  return spec ? 2 : 1;
}
// shrink candidates a pass
#define K6_WIDTH 4
// the most points a pass evaluates: both whole ladders
#define K6_P (2 * K6_STEP_OUT)
static_assert(K6_WIDTH <= K6_P, "a shrink pass must fit the line scratch");

// t0 doubled k times (exact, as the reference's repeated t * 2.0).
__device__ __forceinline__ double k6_ladder(double t0, int k) {
  for (int i = 0; i < k; ++i) t0 = t0 * 2.0;
  return t0;
}

// Shrink candidate m of a pass whose uniforms start at su, from the
// bracket [lo, hi], every earlier candidate of the pass a miss (a miss
// replaces lo when its t < 0 and hi otherwise); lo and hi end as the
// bracket candidate m is drawn from.
__device__ __forceinline__ double k6_candidate(double& lo, double& hi,
                                               const double* su, int m) {
  for (int i = 0;; ++i) {
    const double t = __dadd_rn(lo, __dmul_rn(__dsub_rn(hi, lo), su[i]));
    if (i == m) return t;
    if (t < 0) lo = t;
    else if (t >= 0) hi = t;
  }
}

// GX / GSV: X / l / the support vectors are read from the staged copy in
// global memory (g_xt / g_svt).  Without them the pointers are known to be
// null, so that the shared-memory path compiles to shared-memory loads.
// With a cluster, rank 0 writes the outputs.
template <bool SPEC, bool GX, bool GSV>
__global__ void __launch_bounds__(k6_threads(SPEC), 1)
ns_slice_chains_kernel(
    GpryKern kern, int B, int R, int n, int nsv, int d,
    const double* __restrict__ x0,
    const double* __restrict__ lx0, const double* __restrict__ lstar_p,
    const double* __restrict__ chol, const double* __restrict__ box_lo,
    const double* __restrict__ box_hi, const double* __restrict__ nrm,
    const double* __restrict__ u, const double* __restrict__ X,
    const double* __restrict__ alpha, const double* __restrict__ theta,
    const double* __restrict__ x_loc, const double* __restrict__ x_scale,
    const double* __restrict__ trust_lo, const double* __restrict__ trust_hi,
    const double* __restrict__ sv, const double* __restrict__ dual,
    const double* __restrict__ scal, int svm_mode,
    const int* __restrict__ done, const double* g_xt, const double* g_svt,
    double* __restrict__ x_out, double* __restrict__ lx_out,
    long long* __restrict__ calls_out, long long* __restrict__ passes_out) {
  constexpr int CL = k6_cluster(SPEC);
  extern __shared__ double smem[];
  const int tid = threadIdx.x;
  const int b = blockIdx.x / CL;
  const bool writer = blockIdx.x % CL == 0;
  if (done && *done) {
    if (writer) {
      if (tid < d) x_out[(size_t)b * d + tid] = x0[(size_t)b * d + tid];
      if (tid == 0) {
        lx_out[b] = lx0[b];
        calls_out[b] = 0;
        if (passes_out) passes_out[b] = 0;
      }
    }
    return;
  }
  GpryEvalScratch sc;
  GprySpec spec;
  const GprySurrogate s = gpry_stage_surrogate<SPEC>(
      smem, &sc, kern, n, nsv, d, X, alpha, theta, x_loc, x_scale,
      trust_lo, trust_hi, sv, dual, scal, svm_mode, GX ? g_xt : nullptr,
      GSV ? g_svt : nullptr, &spec);
  // the line evaluation's scratch, then the chain state: x, e, the box,
  // the repeat's uniforms and normal draws, chol
  GpryLineScratch ls = gpry_line_scratch(sc.tail, d, K6_P);
  double* x = sc.tail + gpry_line_eval_doubles(d, K6_P);
  double* e = x + d;
  double* lo = e + d;
  double* hi = lo + d;
  double* su = hi + d;
  double* zs = su + K6_U;
  double* zn = zs + d;
  double* ch = zn + d;
  if (tid < d) {
    x[tid] = x0[(size_t)b * d + tid];
    lo[tid] = box_lo[tid];
    hi[tid] = box_hi[tid];
  }
  for (int i = tid; i < d * d; i += blockDim.x) ch[i] = chol[i];
  // the draws of a repeat are loaded during the one before (registers,
  // then shared memory at its end), so that no repeat waits on them
  double z_next = 0.0, u_next = 0.0;
  if (R > 0) {
    if (tid < d) zs[tid] = nrm[(size_t)b * d + tid];
    if (tid < K6_U) u_next = u[(size_t)tid * B + b];
  }
  __syncthreads();
  const double lstar = *lstar_p;
  double lx = lx0[b];
  long long calls = 0, passes = 0;
  double t = 0.0;
  bool accepted = false;
  double v[K6_P];
  // one pass over np points of the line x + t_of(q) e
  auto eval = [&](int np, auto t_of) {
    gpry_block_gated_mean_line<SPEC, K6_P, CL>(s, spec, &ls, np, x, e, t_of,
                                               lo, hi, v);
    ++passes;
  };

  for (int r = 0; r < R; ++r) {
    // the previous repeat's move, this repeat's direction (its d divisions
    // in d threads) and uniforms
    if (tid < d) {
      if (accepted) x[tid] = __dadd_rn(x[tid], __dmul_rn(t, e[tid]));
      double ss = 0.0;
      for (int j = 0; j < d; ++j) ss += zs[j] * zs[j];
      zn[tid] = zs[tid] / sqrt(ss);
    }
    if (tid < K6_U) su[tid] = u_next;
    if (r + 1 < R) {
      if (tid < d) z_next = nrm[((size_t)(r + 1) * B + b) * d + tid];
      if (tid < K6_U) u_next = u[((size_t)(r + 1) * K6_U + tid) * B + b];
    }
    __syncthreads();
    if (tid < d) {
      double acc = 0.0;
      for (int j = 0; j < d; ++j) acc += zn[j] * ch[tid * d + j];
      e[tid] = acc;
    }
    __syncthreads();

    // step out: each end doubles while its value is above lstar, at most
    // K6_STEP_OUT times; one pass evaluates both ends at 2^0 .. 2^5, and dl,
    // dh are the first doublings whose value is not above lstar
    const double w0 = __dadd_rn(__dmul_rn(su[0], 0.9), 0.05);
    const double tlo0 = -w0, thi0 = __dsub_rn(1.0, w0);
    eval(K6_P, [&](int q) {
      return q < K6_STEP_OUT ? k6_ladder(tlo0, q)
                             : k6_ladder(thi0, q - K6_STEP_OUT);
    });
    int dl = K6_STEP_OUT, dh = K6_STEP_OUT;
#pragma unroll
    for (int q = K6_P - 1; q >= 0; --q) {
      if (!(v[q] > lstar)) {
        if (q < K6_STEP_OUT) dl = q;
        else dh = q - K6_STEP_OUT;
      }
    }
    calls += 2 + 2 * (dl > dh ? dl : dh);
    double tlo = k6_ladder(tlo0, dl), thi = k6_ladder(thi0, dh);

    // shrinkage, K6_WIDTH candidates a pass
    t = 0.0;
    accepted = false;
    double l_new = lx;
    for (int it = 0; it < K6_SHRINKS && !accepted;) {
      const int m =
          K6_WIDTH < K6_SHRINKS - it ? K6_WIDTH : K6_SHRINKS - it;
      const double* sm = su + 1 + it;
      eval(m, [&](int q) {
        double a = tlo, c = thi;
        return k6_candidate(a, c, sm, q);
      });
      int hit = -1;
#pragma unroll
      for (int q = K6_P - 1; q >= 0; --q)
        if (q < m && v[q] > lstar) hit = q;
      const int taken = hit >= 0 ? hit + 1 : m;
      calls += taken;
      // the last candidate taken: its t and value; on a miss the bracket
      // after it
      t = k6_candidate(tlo, thi, sm, taken - 1);
#pragma unroll
      for (int q = 0; q < K6_P; ++q)
        if (q == taken - 1) l_new = v[q];
      if (hit >= 0) {
        accepted = true;
      } else {
        if (t < 0) tlo = t;
        else if (t >= 0) thi = t;
      }
      it += taken;
    }
    if (accepted) lx = l_new;
    // every thread has read zs (before the repeat's first barrier), zn, x,
    // e and su
    if (tid < d && r + 1 < R) zs[tid] = z_next;
    __syncthreads();
  }
  if (writer) {
    if (tid < d) {
      x_out[(size_t)b * d + tid] =
          accepted ? __dadd_rn(x[tid], __dmul_rn(t, e[tid])) : x[tid];
    }
    if (tid == 0) {
      lx_out[b] = lx;
      calls_out[b] = calls;
      if (passes_out) passes_out[b] = passes;
    }
  }
  // a block's shared memory must outlive its peer's last reads of it
  if constexpr (CL > 1) cooperative_groups::this_cluster().sync();
}

// Shared memory K6 needs besides the staged surrogate: the two-point
// evaluation scratch gpry_stage_surrogate carves, the line evaluation's,
// the chain's x, e and box, a repeat's uniforms, normal draws and their
// normalized copy, chol.
static size_t ns_rest(int d) {
  return gpry_eval_doubles(d) + gpry_line_eval_doubles(d, K6_P) +
         6 * (size_t)d + K6_U + (size_t)d * d;
}

// Doubles of global memory K6 needs for a surrogate of n valid rows and
// nsv support vectors (0 when it fits in shared memory).
extern "C" size_t gpry_ns_slice_chains_work(GpryKern kern, int n, int nsv,
                                            int d, int svm_mode) {
  const int nsv_eff = svm_mode == GPRY_MODE_FITTED ? nsv : 0;
  return gpry_stage_work(
      gpry_stage_plan(n, nsv_eff, d, gpry_spec_doubles(kern), ns_rest(d)), n,
      nsv_eff, d);
}

template <bool SPEC>
static auto k6_instance(const double* g_xt, const double* g_svt) {
  return g_xt    ? ns_slice_chains_kernel<SPEC, true, true>
         : g_svt ? ns_slice_chains_kernel<SPEC, false, true>
                 : ns_slice_chains_kernel<SPEC, false, false>;
}

// x0 (B, d), lx0 (B,), lstar a device scalar, chol (d, d) row-major, the
// box (d,) twice, nrm (R, B, d), u (R, 31, B); outputs x (B, d), lx (B,),
// calls (B,) int64 and, when not null, passes (B,) int64.  scal as K1's.
// done: the run's stop flag (int32, may be null).  work:
// gpry_ns_slice_chains_work doubles of device memory (may be null when
// that is 0).
extern "C" int gpry_ns_slice_chains(
    GpryKern kern, int B, int R, int n, int nsv, int d, const void* x0,
    const void* lx0, const void* lstar, const void* chol, const void* lo,
    const void* hi, const void* nrm, const void* u, const void* X,
    const void* alpha, const void* theta, const void* x_loc,
    const void* x_scale, const void* trust_lo, const void* trust_hi,
    const void* sv, const void* dual, const void* scal, int svm_mode,
    const void* done, void* work, void* x_out, void* lx_out,
    void* calls_out, void* passes_out, void* stream) {
  if (B <= 0) return 0;
  if (2 * d > 128) return (int)cudaErrorInvalidValue;
  const int nsv_eff = svm_mode == GPRY_MODE_FITTED ? nsv : 0;
  const size_t spec = gpry_spec_doubles(kern);
  const int plan = gpry_stage_plan(n, nsv_eff, d, spec, ns_rest(d));
  double *g_xt, *g_svt;
  cudaError_t err = gpry_stage_global(plan, kern, n, nsv_eff, d, X, theta, sv,
                                      work, &g_xt, &g_svt,
                                      (cudaStream_t)stream);
  if (err != cudaSuccess) return (int)err;
  const size_t smem = gpry_stage_smem(plan, n, nsv_eff, d, spec, ns_rest(d));
  const bool is_spec = kern.nodes > 0;
  auto kernel = is_spec ? k6_instance<true>(g_xt, g_svt)
                        : k6_instance<false>(g_xt, g_svt);
  err = gpry_set_smem(kernel, smem);
  if (err != cudaSuccess) return (int)err;
  const int cluster = k6_cluster(is_spec);
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(B * cluster);
  cfg.blockDim = dim3(k6_threads(is_spec));
  cfg.dynamicSmemBytes = smem;
  cfg.stream = (cudaStream_t)stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = cluster > 1 ? 1 : 0;
  err = cudaLaunchKernelEx(
      &cfg, kernel, kern, B, R, n, nsv, d, (const double*)x0,
      (const double*)lx0, (const double*)lstar, (const double*)chol,
      (const double*)lo, (const double*)hi, (const double*)nrm,
      (const double*)u, (const double*)X, (const double*)alpha,
      (const double*)theta, (const double*)x_loc, (const double*)x_scale,
      (const double*)trust_lo, (const double*)trust_hi, (const double*)sv,
      (const double*)dual, (const double*)scal, svm_mode, (const int*)done,
      (const double*)g_xt, (const double*)g_svt, (double*)x_out,
      (double*)lx_out, (long long*)calls_out, (long long*)passes_out);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}
