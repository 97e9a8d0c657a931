// K4 kriging_believer_fill: the greedy Kriging-believer fill of NORA's
// ranked pool, round by round on the device, with no host read.
//
// Replaces gpry_tpu/acquisition/ranked_pool.py:41 _bulk_fill_device (one
// XLA program there).  Given N candidates (preprocessed Xq_), their raw
// means y and an alive mask, the fill runs `size` rounds.  Round 0 ranks
// by the unconditioned acquisition acq0; round r >= 1 against the grown
// factor L (nmax x nmax, row-major, identity on the padded block) and the
// current count n:
//
//   V  = L^-1 K(Xq_, Xbuf[:n])^T                      (forward substitution)
//   sd = sqrt(max(k(x, x) - sum V^2, 0)) * y_scale    (ungated: no SVM,
//                                                      trust box or clip)
//   ac = acq(y, sd); alive &= isfinite(ac)
//   j  = argmax(alive ? ac : -inf), first index on ties (as jnp.argmax)
//
// and, on a finite pick, the rank-1 Cholesky append of the believer row n:
//   S12 = L^-1 K(Xbuf[:n], x_j),  s22 = sqrt(max(k22 + noise(n) - |S12|^2,
//   1e-12)),  L[n] = [S12, s22],  Xbuf[n] = x_j,  n += 1.
// (The JAX program also writes the lie into a y buffer; no output reads
// it, so it is not carried here.)
//
// Design: two kernels per round, launched back to back on one stream; n
// lives in a device int32, so that no round reads the host.
//  (a) The sweep (rounds >= 1), two routes chosen by k4_plan (mirrored by
//      ops/fused.py kriging_believer_fill_plan), as K2's k2_plan chooses:
//      * route 0, kb_sweep_blocked: a block of 8 warps owns Q = 8, 16 or
//        32 candidates (sub_queries of subst_blocked.cuh by N; fewer where
//        shared memory forces it) and solves their V = L^-1 K at once with
//        the routine of csrc/subst_blocked.cuh (K2's route 0 and K7's
//        solve): the k vectors as the rows of V (sub_build_k), 16-row
//        panels of L staged by cp.async once per block, the panel update
//        on the FP64 tensor cores, the diagonal block by a half-warp a
//        candidate in registers (sub_forward).
//      * route 1, kb_sweep_chain (the design before this one): a warp a
//        candidate, its k vector in shared memory and n dependent warp
//        reductions against L's rows; the plan takes it where even Q = 8
//        does not fit, or where L's rows are not 16-byte aligned (an odd
//        nmax), as k2_plan does.
//      For LogExp (the default acquisition) the epilogue, ac and the alive
//      update happen in the same pass; for any other acquisition function
//      the sweep writes sd and torch applies acqf.values and the alive
//      update between (a) and (b).  Dead candidates ride in their block
//      (their columns are solved and their output is -inf, or 0 for sd):
//      alive only shrinks by about one a round on the main path, so a
//      compacted list would save next to nothing against its own pass
//      (PERF.md, section 6).
//  (b) The select, kb_select_kernel: one block reduces the N (value,
//      index) pairs to j (first index on ties), writes the round's
//      outputs and appends row n of L in place, with no substitution from
//      round 1 on: the sweep just before it has solved every alive
//      candidate against this L at this n, and the candidate's column of V
//      is S12 (the same L, n and cross-covariance; no noise off the
//      diagonal), its sum of squares |S12|^2.  So the sweep writes each
//      alive candidate's solved row (n doubles) and its sum of squares to
//      a device buffer of N rows of nmax doubles, and the select
//      copies row j into L[n].  The whole buffer, not each block's best
//      candidate alone: with an acquisition other than LogExp the winner
//      is chosen by torch after the sweep, so the sweep cannot know which
//      row the select will take; the rows (7.3 MB at N = 4,096, n = 224)
//      stay in the card's 50 MB L2.  Round 0 ranks by acq0 with no sweep
//      before it; its append solves the one candidate with the same
//      routine (a block of 8 with one live column; route 1: warp 0's
//      chain).
//
// What bounds it on the H100.  The work is FP64: per conditioned round
// about N * n^2 / 2 multiply-adds of substitution plus N * n * (3d + 3)
// for the k vectors, 1.7e9 operations over the 7 conditioned rounds at
// bench.py's NORA shape (N = 4,096, n = 224-231, d = 8): 25 us at the
// card's 67 TFLOP/s FP64 peak; the bytes (the valid triangle of L and the
// candidates, each once) are 0.6 MB, 0.2 us at 3.35 TB/s.  Route 0 is
// bound by each block's dependent chain of n / 16 panels (as K2's), the
// select by its one-block argmax over N.
//
// Spec mode (template SPEC, every kernel): the k vectors come from the
// interpreter of common.cuh on the preprocessed coordinates; the sweep's
// prior variance is the candidate's gpry_spec_diag, and the append's k22 is
// gpry_spec_diag(x_j) + noise(n) (gpry_tpu/acquisition/ranked_pool.py:61,
// 96-98).
#include <limits.h>

#include "subst_blocked.cuh"

#define K4_THREADS 256
#define K4_WARPS (K4_THREADS / 32)

struct K4Sweep {
  GpryKern kern;
  int out_logexp, N, nmax, d, Q;
  const int* n_dev;
  const double *Xq_, *y, *Xbuf, *L, *theta, *scal;
  double zeta, noise_std;
  unsigned char* alive;
  double* out;
  double* rows;   // N x nmax: each alive candidate's solved row
  double* rsum;   // N: its sum of squares
};

// The outputs of candidate q from its sum of squares (one thread): -inf
// (LogExp) or 0 (sd) for a dead one; for a live one its sum of squares for
// the select, its value, and (LogExp) the alive update.
template <bool SPEC>
__device__ __forceinline__ void kb_epilogue(const K4Sweep& a,
                                            const GprySpec& spec,
                                            const double* qls, double variance,
                                            int q, bool live, double sumsq) {
  if (!live) {
    a.out[q] = a.out_logexp ? -INFINITY : 0.0;
    return;
  }
  a.rsum[q] = sumsq;
  const double y_scale = a.scal[1], y_max = a.scal[5];
  const double prior = SPEC ? gpry_spec_diag(spec, qls, 1, a.d) : variance;
  const double var0 = prior - sumsq;
  const double var = (var0 < 0.0) ? 0.0 : var0;  // NaN stays NaN
  const double sd = sqrt(var) * y_scale;
  if (a.out_logexp) {
    const double var2 = sd * sd - a.noise_std * a.noise_std;
    const bool ok = (var2 > 0.0) && isfinite(a.y[q]);
    const double ac =
        ok ? 2.0 * a.zeta * (a.y[q] - y_max) + 0.5 * log(var2) : -INFINITY;
    a.out[q] = ac;
    if (!isfinite(ac)) a.alive[q] = 0;
  } else {
    a.out[q] = sd;
  }
}

// The block's candidates (Q from q0, nqb of them real): ls and the
// coordinates over the length scales (a spec program's are 1) in shared
// memory, and the staged program (SPEC).  One barrier.
template <bool SPEC>
__device__ __forceinline__ GprySpec kb_queries(const GpryKern& kern,
                                               const double* theta,
                                               const double* Xq_, int d,
                                               int q0, int nqb, double* ls,
                                               double* qls, double* prog) {
  const int tid = threadIdx.x;
  GprySpec spec;
  if constexpr (SPEC)
    spec = gpry_stage_spec(prog, kern, theta, tid, blockDim.x);
  for (int k = tid; k < d; k += blockDim.x)
    ls[k] = SPEC ? 1.0 : exp(theta[1 + k]);
  __syncthreads();
  for (int idx = tid; idx < nqb * d; idx += blockDim.x)
    qls[idx] = Xq_[(size_t)q0 * d + idx] / ls[idx % d];
  return spec;
}

// Route 0.  Shared layout: ls[d] | qls[Q][d] | spec program |
// subst_blocked's V, stages, shares, sumsq.
template <bool SPEC>
__global__ void __launch_bounds__(SUB_THREADS) kb_sweep_blocked(K4Sweep a) {
  extern __shared__ double smem[];
  const int tid = threadIdx.x, Q = a.Q, d = a.d;
  const int q0 = blockIdx.x * Q, nqb = min(Q, a.N - q0);
  const int n = *a.n_dev, ldq = Q + 4;
  double* ls = smem;
  double* qls = ls + d;
  double* prog = qls + (size_t)Q * d;
  const GprySub sub =
      sub_carve(a.L, n, a.nmax, Q, prog + gpry_spec_doubles(a.kern));
  const GprySpec spec =
      kb_queries<SPEC>(a.kern, a.theta, a.Xq_, d, q0, nqb, ls, qls, prog);
  const double variance = SPEC ? 1.0 : exp(a.theta[0]);
  // dead candidates ride: their columns are solved with the others'
  sub_build_k<SPEC>(sub, a.kern.family, spec, variance, ls, qls, a.Xbuf, d,
                    nqb);
  sub_forward(sub);
  // every thread has read alive[] before the epilogue writes it
  bool live = false;
  if (tid < nqb) live = a.alive[q0 + tid];
  // the alive candidates' solved rows, for the select's append
  for (int idx = tid; idx < nqb * n; idx += blockDim.x) {
    const int qi = idx / n, j = idx - qi * n;
    if (a.alive[q0 + qi])
      a.rows[(size_t)(q0 + qi) * a.nmax + j] = sub.V[(size_t)j * ldq + qi];
  }
  __syncthreads();
  for (int qi = tid; qi < nqb; qi += blockDim.x)  // at most once a thread
    kb_epilogue<SPEC>(a, spec, qls + qi * d, variance, q0 + qi, live,
                      sub.sumsq[qi]);
}

// Route 1.  Shared layout: ls[d] | qls[Q][d] | kv[Q][nmax] | spec program.
template <bool SPEC>
__global__ void __launch_bounds__(K4_THREADS) kb_sweep_chain(K4Sweep a) {
  extern __shared__ double smem[];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int Q = a.Q, d = a.d, nmax = a.nmax;
  const int q0 = blockIdx.x * Q, nqb = min(Q, a.N - q0);
  const int n = *a.n_dev;
  double* ls = smem;
  double* qls = ls + d;
  double* kv = qls + (size_t)Q * d;
  const GprySpec spec = kb_queries<SPEC>(a.kern, a.theta, a.Xq_, d, q0, nqb,
                                         ls, qls, kv + (size_t)Q * nmax);
  __syncthreads();
  const double variance = SPEC ? 1.0 : exp(a.theta[0]);

  // phase 1: k vectors of the block's alive candidates
  for (int idx = tid; idx < nqb * n; idx += blockDim.x) {
    const int qi = idx / n, j = idx - qi * n;
    if (!a.alive[q0 + qi]) continue;
    if constexpr (SPEC) {
      kv[(size_t)qi * nmax + j] = gpry_spec_cov(
          spec, qls + qi * d, 1, a.Xbuf + (size_t)j * d, 1, d);
      continue;
    }
    double sq = 0.0;
    for (int k = 0; k < d; ++k) {
      const double df = qls[qi * d + k] - a.Xbuf[(size_t)j * d + k] / ls[k];
      sq += df * df;
    }
    kv[(size_t)qi * nmax + j] = variance * gpry_k_of_sq(a.kern.family, sq);
  }
  __syncthreads();

  // phase 2: one warp per candidate
  for (int qi = warp; qi < nqb; qi += K4_WARPS) {
    const int q = q0 + qi;
    if (!a.alive[q]) {
      if (lane == 0) a.out[q] = a.out_logexp ? -INFINITY : 0.0;
      continue;
    }
    double* v = kv + (size_t)qi * nmax;
    const double sumsq = gpry_warp_forward_subst(a.L, nmax, n, v, lane);
    for (int j = lane; j < n; j += 32) a.rows[(size_t)q * nmax + j] = v[j];
    __syncwarp();
    if (lane == 0)
      kb_epilogue<SPEC>(a, spec, qls + qi * d, variance, q, true, sumsq);
  }
}

// (value, index) order of jnp.argmax: larger value first, then the
// smaller index.
__device__ __forceinline__ bool kb_better(double v, int i, double bv,
                                          int bi) {
  return v > bv || (v == bv && i < bi);
}

struct K4Select {
  GpryKern kern;
  int N, nmax, d, slot, noise_is_vec, solve, route;
  const double *Xd_raw, *Xq_, *y, *sigma, *acq0, *ac;
  unsigned char* alive;
  const double *theta, *noise;
  int* n_dev;
  double *Xbuf, *L;
  const double *rows, *rsum;
  double *outX, *outY, *outS, *outA, *outC;
};

// One block.  Shared layout: ls[d] | qls[8][d] | spec program | (solve,
// route 0) subst_blocked's area for Q = 8, (solve, route 1) kv[nmax].
template <bool SPEC>
__global__ void __launch_bounds__(SUB_THREADS) kb_select_kernel(K4Select a) {
  extern __shared__ double smem[];
  const int d = a.d, N = a.N, nmax = a.nmax;
  double* ls = smem;
  double* qls = ls + d;
  double* prog = qls + (size_t)SUB_PB / 2 * d;
  double* area = prog + gpry_spec_doubles(a.kern);
  __shared__ double red_v[SUB_WARPS];
  __shared__ int red_i[SUB_WARPS];

  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;

  // masked argmax, first index on ties
  double bv = -INFINITY;
  int bi = INT_MAX;
  for (int i = tid; i < N; i += blockDim.x) {
    const double v = a.alive[i] ? a.ac[i] : -INFINITY;
    if (kb_better(v, i, bv, bi)) {
      bv = v;
      bi = i;
    }
  }
  for (int off = 16; off > 0; off >>= 1) {
    const double ov = __shfl_xor_sync(0xffffffffu, bv, off);
    const int oi = __shfl_xor_sync(0xffffffffu, bi, off);
    if (kb_better(ov, oi, bv, bi)) {
      bv = ov;
      bi = oi;
    }
  }
  if (lane == 0) {
    red_v[warp] = bv;
    red_i[warp] = bi;
  }
  GprySpec spec;
  if constexpr (SPEC)
    spec = gpry_stage_spec(prog, a.kern, a.theta, tid, blockDim.x);
  for (int k = tid; k < d; k += blockDim.x)
    ls[k] = SPEC ? 1.0 : exp(a.theta[1 + k]);
  __syncthreads();
  bv = red_v[0];
  bi = red_i[0];
  for (int w = 1; w < SUB_WARPS; ++w)
    if (kb_better(red_v[w], red_i[w], bv, bi)) {
      bv = red_v[w];
      bi = red_i[w];
    }
  const int j = bi;
  const bool valid = isfinite(bv);

  for (int k = tid; k < d; k += blockDim.x)
    a.outX[(size_t)a.slot * d + k] = valid ? a.Xd_raw[(size_t)j * d + k] : 0.0;
  if (tid == 0) {
    a.outY[a.slot] = valid ? a.y[j] : 0.0;
    a.outS[a.slot] = valid ? a.sigma[j] : 0.0;
    a.outA[a.slot] = valid ? a.acq0[j] : -INFINITY;
    a.outC[a.slot] = valid ? bv : -INFINITY;
  }
  const int n = *a.n_dev;
  // every thread has read alive[] and n_dev before they are written
  __syncthreads();
  if (tid == 0 && j < N) a.alive[j] = 0;
  if (!valid || n >= nmax) return;  // uniform over the block

  // rank-1 Cholesky append of the believer row n: S12 and |S12|^2 from
  // the sweep (rounds >= 1), or solved here (round 0)
  const double variance = SPEC ? 1.0 : exp(a.theta[0]);
  const double* xj = a.Xq_ + (size_t)j * d;
  double* Ln = a.L + (size_t)n * nmax;
  double sumsq = 0.0;
  if (!a.solve) {
    const double* r = a.rows + (size_t)j * nmax;
    for (int t = tid; t < n; t += blockDim.x) Ln[t] = r[t];
    sumsq = a.rsum[j];
  } else if (a.route == 0) {
    for (int k = tid; k < d; k += blockDim.x) qls[k] = xj[k] / ls[k];
    const GprySub sub = sub_carve(a.L, n, nmax, SUB_PB / 2, area);
    sub_build_k<SPEC>(sub, a.kern.family, spec, variance, ls, qls, a.Xbuf,
                      d, 1);
    sub_forward(sub);
    for (int t = tid; t < n; t += blockDim.x)
      Ln[t] = sub.V[(size_t)t * (SUB_PB / 2 + 4)];
    sumsq = sub.sumsq[0];
  } else {
    double* kv = area;
    for (int t = tid; t < n; t += blockDim.x) {
      if constexpr (SPEC) {
        kv[t] = gpry_spec_cov(spec, a.Xbuf + (size_t)t * d, 1, xj, 1, d);
        continue;
      }
      double sq = 0.0;
      for (int k = 0; k < d; ++k) {
        const double df = a.Xbuf[(size_t)t * d + k] / ls[k] - xj[k] / ls[k];
        sq += df * df;
      }
      kv[t] = variance * gpry_k_of_sq(a.kern.family, sq);
    }
    __syncthreads();
    if (warp == 0) {
      sumsq = gpry_warp_forward_subst(a.L, nmax, n, kv, lane);
      for (int t = lane; t < n; t += 32) Ln[t] = kv[t];
    }
  }
  for (int k = tid; k < d; k += blockDim.x)
    a.Xbuf[(size_t)n * d + k] = xj[k];
  if (tid == 0) {
    const double prior = SPEC ? gpry_spec_diag(spec, xj, 1, d) : variance;
    const double k22 = prior + (a.noise_is_vec ? a.noise[n] : a.noise[0]);
    double r = k22 - sumsq;
    r = (r < 1e-12) ? 1e-12 : r;  // NaN stays NaN
    Ln[n] = sqrt(r);
    *a.n_dev = n + 1;
  }
}

// The route (0 blocked, 1 the chain; sub_plan) for nq candidates against at
// most n rows of the (nmax, nmax) factor L, the candidates a block *Q and
// the shared memory *smem; qchain is the chain's candidates a block.  The
// round-0 select plans nq = 1 (Q = 8).
static int k4_plan(const GpryKern& kern, int nq, int n, int nmax, int d,
                   int qchain, const void* L, int* Q, size_t* smem) {
  const size_t spec = gpry_spec_doubles(kern);
  if (sub_plan(nq, n, nmax, L, (size_t)d + spec, (size_t)d, Q, smem) == 0)
    return 0;
  *Q = qchain;
  *smem = sizeof(double) * ((size_t)d + (size_t)qchain * d +
                            (size_t)qchain * (size_t)nmax + spec);
  return 1;
}

extern "C" int gpry_kb_plan(GpryKern kern, int nq, int n, int nmax, int d,
                            int qchain, const void* L, int* Q,
                            size_t* smem) {
  return k4_plan(kern, nq, n, nmax, d, qchain, L, Q, smem);
}

// scal = [y_loc, y_scale, clip_max, svm intercept, svm gamma, y_max];
// n_hi bounds the device count *n_dev (the plan's n); rows (N x nmax) and
// rsum (N) take each alive candidate's solved row and its sum of squares.
extern "C" int gpry_kb_sweep(GpryKern kern, int out_logexp, int N, int n_hi,
                             int nmax, int d, int qchain, const void* n_dev,
                             const void* Xq_, const void* y,
                             const void* Xbuf, const void* L,
                             const void* theta, const void* scal,
                             double zeta, double noise_std, void* alive,
                             void* out, void* rows, void* rsum,
                             void* stream) {
  K4Sweep a{kern, out_logexp, N, nmax, d, 0, (const int*)n_dev,
            (const double*)Xq_, (const double*)y, (const double*)Xbuf,
            (const double*)L, (const double*)theta, (const double*)scal,
            zeta, noise_std, (unsigned char*)alive, (double*)out,
            (double*)rows, (double*)rsum};
  size_t smem = 0;
  const int route = k4_plan(kern, N, n_hi, nmax, d, qchain, L, &a.Q, &smem);
  const bool spec = kern.nodes > 0;
  auto kernel =
      route == 0 ? (spec ? kb_sweep_blocked<true> : kb_sweep_blocked<false>)
                 : (spec ? kb_sweep_chain<true> : kb_sweep_chain<false>);
  cudaError_t e = gpry_set_smem(kernel, smem);
  if (e != cudaSuccess) return (int)e;
  if (N <= 0) return 0;
  const dim3 grid((N + a.Q - 1) / a.Q);
  kernel<<<grid, route == 0 ? SUB_THREADS : K4_THREADS, smem,
           (cudaStream_t)stream>>>(a);
  return (int)cudaGetLastError();
}

// solve = 1 (round 0): the append solves the pick's row itself (n_hi the
// count); else it copies the sweep's row (rows, rsum).
extern "C" int gpry_kb_select(GpryKern kern, int N, int n_hi, int nmax,
                              int d, int slot, int noise_is_vec, int solve,
                              const void* Xd_raw, const void* Xq_,
                              const void* y, const void* sigma,
                              const void* acq0, const void* ac, void* alive,
                              const void* theta, const void* noise,
                              void* n_dev, void* Xbuf, void* L,
                              const void* rows, const void* rsum, void* outX,
                              void* outY, void* outS, void* outA, void* outC,
                              void* stream) {
  K4Select a{kern, N, nmax, d, slot, noise_is_vec, solve, 0,
             (const double*)Xd_raw, (const double*)Xq_, (const double*)y,
             (const double*)sigma, (const double*)acq0, (const double*)ac,
             (unsigned char*)alive, (const double*)theta,
             (const double*)noise, (int*)n_dev, (double*)Xbuf, (double*)L,
             (const double*)rows, (const double*)rsum, (double*)outX,
             (double*)outY, (double*)outS, (double*)outA, (double*)outC};
  const size_t fixed = (size_t)d * (1 + SUB_PB / 2) + gpry_spec_doubles(kern);
  size_t smem = sizeof(double) * fixed;
  if (solve) {
    int Q;
    size_t plan_smem;
    a.route = k4_plan(kern, 1, n_hi, nmax, d, 1, L, &Q, &plan_smem);
    smem += sizeof(double) *
            (a.route == 0 ? sub_doubles(n_hi, SUB_PB / 2) : (size_t)nmax);
  }
  auto kernel = kern.nodes ? kb_select_kernel<true> : kb_select_kernel<false>;
  cudaError_t e = gpry_set_smem(kernel, smem);
  if (e != cudaSuccess) return (int)e;
  kernel<<<1, SUB_THREADS, smem, (cudaStream_t)stream>>>(a);
  return (int)cudaGetLastError();
}
