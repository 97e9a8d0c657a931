// Many queries' forward substitutions against one read of L: the blocked
// multi-query routine of the sweeps (K2 gated_meanvar_logexp.cu, K4's
// sweep kriging_believer_fill.cu, K5 meanvar_ungated.cu, K7's solve
// predict_meancov.cu and K8 meanstd_grad.cu, which also solves back with
// sub_backward; K5 and K8 share their whole body, sub_ungated below).
//
// For Q queries at once (Q a multiple of 8, up to SUB_MAXQ), a block of
// SUB_THREADS solves V = L^-1 K in place, K the n x Q matrix of the
// queries' k vectors (column q query q), in the solve form (no L^-1 or
// K^-1 is formed), and returns sumsq[q] = ||V_q||^2:
//
// * Panels of SUB_PB = 16 rows, left-looking.  The panel's rows of L (the
//   16 x (P0 + 16) row block) are staged in shared memory by cp.async,
//   double-buffered: the next panel's copy runs while this one is solved.
//   So L is read once per block of Q queries, not once per query.
// * The update V_I -= L_I,<I V_<I runs on the FP64 tensor cores
//   (gpry_dmma, m8n8k4): 2 x Q / 8 output tiles of 8 x 8, each tile's k
//   range split SUB_SPLITS ways (interleaved chunks of 4), the Q (tile,
//   split) shares dealt to the 8 warps (Q / 8 a warp, one after
//   another); the shares are summed in split order by the solve below.
//   The split does not depend on Q, so a query's solution is the same
//   bits whatever Q its block takes (whatever the batch it came in: a
//   batch split into shards, parallel/mesh.py, solves as the whole batch
//   does).  It costs ~10% at Q = 16 against the Q-dependent split it
//   replaced (PERF.md, PR 18).
// * The 16 x 16 diagonal block is solved by a half-warp per query, lane r
//   holding row r of the block in registers (a step of the chain: one
//   product with the staged 1 / L_jj, one shuffle, one update), as K9's
//   single-query panels.  (A thread a query, the rows in its registers
//   and L's block read as broadcasts, took 3.1x as long on the H100: its
//   loads and updates serialize in one warp.)
//
// The callers (route 0 of K2, K4's sweep, K5 and K8; K7's solve) share
// the whole route: the plan (sub_plan: Q by nq and shared memory, and
// whether L can be copied by cp.async at all), the prologue that builds
// the k vectors as the rows of V (sub_build_k) and the warp-per-query k .
// alpha (sub_dot_alpha).  So two callers give bit-identical solutions
// (at any nq: the solutions do not depend on Q).
//
// Two block barriers a panel.  Layout in shared memory (the caller
// carves it, sub_doubles): V as n_pad rows of ldq = Q + 4 doubles (row j
// holds entry j of every query; rows n..n_pad - 1 zero), the two stages of
// 16 rows of lda = n_pad + 4 doubles (16-byte aligned: the panel's rows
// are copied two doubles at a time), the tiles' shares, the panel's 1 /
// L_jj and sumsq.  The pads of 4 keep the tensor-core operand loads free
// of bank conflicts.
#pragma once

#include <cuda_pipeline.h>
#include <stdint.h>

#include "common.cuh"

#define SUB_THREADS 256
#define SUB_WARPS (SUB_THREADS / 32)
#define SUB_PB 16
#define SUB_MAXQ 32
// the queries a block by the batch size nq: 8 for small batches (their
// blocks then split the tensor-core tiles' work), 16 above SUB_Q16_NQ
// (the acquisition screen), 32 above SUB_Q32_NQ.  The update's k-split
// is SUB_SPLITS whatever Q is, so the solutions do not depend on Q.
#define SUB_Q16_NQ 1056
#define SUB_Q32_NQ 4224
// the ways each update tile's k range is split (SUB_WARPS / 2: Q = 8's
// two tiles fill the 8 warps)
#define SUB_SPLITS 4

__host__ __device__ inline int sub_queries(int nq) {
  return nq > SUB_Q32_NQ ? 32 : nq > SUB_Q16_NQ ? 16 : 8;
}

__host__ __device__ inline int sub_npad(int n) {
  return (n + SUB_PB - 1) / SUB_PB * SUB_PB;
}

// Doubles of the routine's shared memory: V, the two stages, the tiles'
// shares (SUB_SPLITS 8 x 8 shares a tile: Q x 64), 1 / L_jj, sumsq, and
// one to align.
__host__ __device__ inline size_t sub_doubles(int n, int Q) {
  const size_t np = (size_t)sub_npad(n);
  return np * (Q + 4) + 2 * SUB_PB * (np + 4) + (size_t)Q * 64 + SUB_PB +
         Q + 1;
}

// The route for nq queries against n rows of the (nmax, nmax) factor L:
// 0 (this routine) with *Q = sub_queries(nq), fewer down to 8 where
// shared memory forces it, and *smem the bytes of the caller's `fixed`
// doubles, `per_q` doubles a query and the routine's; 1 (the caller's
// warp-per-query chain) where even Q = 8 does not fit, or where L's rows
// are not 16-byte aligned (an odd nmax, or L a view at an odd offset):
// sub_load_panel copies two doubles at a time.
static inline int sub_plan(int nq, int n, int nmax, const void* L,
                           size_t fixed, size_t per_q, int* Q,
                           size_t* smem) {
  if (nmax % 2 != 0 || ((uintptr_t)L & 15) != 0) return 1;
  for (int q = sub_queries(nq); q >= 8; q /= 2) {
    const size_t bytes =
        sizeof(double) * (fixed + per_q * q + sub_doubles(n, q));
    if (bytes <= GPRY_MAX_SMEM) {
      *Q = q;
      *smem = bytes;
      return 0;
    }
  }
  return 1;
}

// The route of K5's sweep and K7's solve, by K5's layout (fixed d + the
// spec program, d + 1 a query): 0, this routine with *Q and *smem by
// sub_plan; else 1, the caller's warp-per-query chain, Q = qchain, with
// ls[d] | qls[Q][d] | kv[Q][n] | spec program in shared memory.  One rule,
// so K5 and K7 solve with the same Q at every nq, bit for bit.
static inline int sub_ungated_plan(const GpryKern& kern, int nq, int n,
                                   int nmax, int d, int qchain,
                                   const void* L, int* Q, size_t* smem) {
  if (sub_plan(nq, n, nmax, L, (size_t)d + gpry_spec_doubles(kern),
               (size_t)d + 1, Q, smem) == 0)
    return 0;
  *Q = qchain;
  *smem = sizeof(double) * ((size_t)d + (size_t)qchain * d +
                            (size_t)qchain * n + gpry_spec_doubles(kern));
  return 1;
}

struct GprySub {
  const double* L;  // (nmax, nmax) row-major, global memory
  int n, nmax, Q;
  double* V;       // sub_npad(n) x (Q + 4)
  double* stage;   // 2 x SUB_PB x (sub_npad(n) + 4)
  double* part;    // Q x 64: the (split, tile) shares
  double* dinv;    // SUB_PB: the panel's 1 / L_jj
  double* sumsq;   // Q
};

__device__ __forceinline__ GprySub sub_carve(const double* L, int n,
                                             int nmax, int Q, double* at) {
  GprySub s;
  const int np = sub_npad(n);
  s.L = L;
  s.n = n;
  s.nmax = nmax;
  s.Q = Q;
  s.V = at + (((size_t)at & 15) ? 1 : 0);
  s.stage = s.V + (size_t)np * (Q + 4);
  s.part = s.stage + 2 * SUB_PB * ((size_t)np + 4);
  s.dinv = s.part + (size_t)Q * 64;
  s.sumsq = s.dinv + SUB_PB;
  return s;
}

// Rows P0.. P0 + 15 of L, columns 0 .. P0 + 15, into stage `slot` (zeros
// outside the n x n block), by cp.async: a warp a row, a lane two columns
// (16 bytes: sub_plan takes this route only for an even nmax and a
// 16-byte aligned L).
__device__ __forceinline__ void sub_load_panel(const GprySub& s, int slot,
                                               int P0) {
  const int lda = sub_npad(s.n) + 4, w = P0 + SUB_PB;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  double* dst = s.stage + (size_t)slot * SUB_PB * lda;
  for (int r = warp; r < SUB_PB; r += SUB_WARPS) {
    const bool row = P0 + r < s.n;
    const double* src = s.L + (size_t)(P0 + r) * s.nmax;
    for (int c = 2 * lane; c < w; c += 64) {
      double* dp = dst + r * lda + c;
      if (row && c + 1 < s.n) {
        __pipeline_memcpy_async(dp, src + c, 2 * sizeof(double));
      } else {
        if (row && c < s.n)
          __pipeline_memcpy_async(dp, src + c, sizeof(double));
        else
          dp[0] = 0.0;
        dp[1] = 0.0;
      }
    }
  }
}

// The k vectors of the block's nqb queries (of s.Q) as the rows of V:
// row j holds k(query q, training row j) of every q, zeros beyond n and
// for the missing queries.  qls: the queries' preprocessed coordinates
// over the length scales, Q x d (a spec program's length scales are 1);
// ls the length scales and variance the amplitude of a fast family; X
// the training rows, nmax x d.  The rows (a fast family's over the length
// scales) are first staged in the panel stages, free until sub_forward
// starts (n d <= 32 n_pad doubles for d <= 32).  Every thread calls it;
// ls must be visible on entry, qls only after its first barrier.  Two
// barriers.
template <bool SPEC>
__device__ void sub_build_k(const GprySub& s, int family,
                            const GprySpec& spec, double variance,
                            const double* ls, const double* qls,
                            const double* X, int d, int nqb) {
  const int tid = threadIdx.x, Q = s.Q, ldq = Q + 4, np = sub_npad(s.n);
  const bool stx = d <= 32;
  if (stx)
    for (int e = tid; e < s.n * d; e += blockDim.x)
      s.stage[e] = SPEC ? X[e] : X[e] / ls[e % d];
  __syncthreads();
  const double* xr = stx ? s.stage : X;
  for (int idx = tid; idx < np * Q; idx += blockDim.x) {
    const int j = idx / Q, qi = idx - j * Q;
    double kv = 0.0;
    if (j < s.n && qi < nqb) {
      const double* xj = xr + (size_t)j * d;
      if constexpr (SPEC) {
        kv = gpry_spec_cov(spec, qls + qi * d, 1, xj, 1, d);
      } else {
        double sq = 0.0;
        for (int i = 0; i < d; ++i) {
          const double df = qls[qi * d + i] - (stx ? xj[i] : xj[i] / ls[i]);
          sq += df * df;
        }
        kv = variance * gpry_k_of_sq(family, sq);
      }
    }
    s.V[(size_t)j * ldq + qi] = kv;
  }
  __syncthreads();
}

// k . alpha over the n entries of a k vector v (stride `stride`: 1 for a
// vector of its own, Q + 4 for a column of V), by one warp; the same value
// on every lane.
__device__ __forceinline__ double sub_dot_alpha(const double* v, int stride,
                                                int n, const double* alpha) {
  double m = 0.0;
  for (int j = threadIdx.x & 31; j < n; j += 32)
    m += v[(size_t)j * stride] * alpha[j];
  return gpry_warp_sum(m);
}

// V = L^-1 V in place for the s.Q queries, sumsq[q] = ||V_q||^2.  Every
// thread of the block calls it; V holds the k vectors on entry, visible
// to all threads (the caller's barrier), and the solution and sumsq on
// exit (after a barrier).
static __device__ void sub_forward(const GprySub& s) {
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int n = s.n, Q = s.Q, ldq = Q + 4;
  const int lda = sub_npad(n) + 4, np = sub_npad(n) / SUB_PB;
  const int nqt = Q / 8, tiles = 2 * nqt;
  const int g = lane >> 2, t4 = lane & 3;
  // the solve: half-warp h takes queries h, h + 16 (both halves of a warp
  // take a query or neither: Q is a multiple of 8)
  const int hr = lane & 15, h = tid >> 4;

  if (np > 0) sub_load_panel(s, 0, 0);
  __pipeline_commit();
  __pipeline_wait_prior(0);
  __syncthreads();
  for (int p = 0; p < np; ++p) {
    const int P0 = p * SUB_PB;
    if (p + 1 < np) sub_load_panel(s, (p + 1) & 1, P0 + SUB_PB);
    __pipeline_commit();
    const double* Lp = s.stage + (size_t)(p & 1) * SUB_PB * lda;
    // the update's shares on the tensor cores: share `task` is tile
    // task % tiles, split task / tiles
    if (P0 > 0) {
      for (int task = warp; task < SUB_SPLITS * tiles; task += SUB_WARPS) {
        const int tile = task % tiles, split = task / tiles;
        const int ta = tile / nqt, tb = tile - ta * nqt;
        double d0 = 0.0, d1 = 0.0;
        const double* Arow = Lp + (8 * ta + g) * lda + t4;
        const double* Bcol = s.V + (size_t)t4 * ldq + 8 * tb + g;
        for (int k0 = 4 * split; k0 < P0; k0 += 4 * SUB_SPLITS)
          gpry_dmma(d0, d1, Arow[k0], Bcol[(size_t)k0 * ldq]);
        double* o = s.part + task * 64 + g * 8 + 2 * t4;
        o[0] = d0;
        o[1] = d1;
      }
    }
    if (tid >= SUB_THREADS - SUB_PB) {
      const int j = tid - (SUB_THREADS - SUB_PB);
      s.dinv[j] = P0 + j < n ? 1.0 / Lp[j * lda + P0 + j] : 0.0;
    }
    __syncthreads();
    // the diagonal block: a half-warp a query
    const int pn = n - P0 < SUB_PB ? n - P0 : SUB_PB;
    const bool mine = hr < pn;
    double Lr[SUB_PB];
#pragma unroll
    for (int j = 0; j < SUB_PB; ++j)
      Lr[j] = (mine && j < hr) ? Lp[hr * lda + P0 + j] : 0.0;
    const double di = s.dinv[hr];
#pragma unroll
    for (int qq = 0; qq < SUB_MAXQ / 16; ++qq) {
      const int q = h + 16 * qq;
      if (q >= Q) break;  // uniform over the warp
      double* vq = s.V + (size_t)(P0 + hr) * ldq + q;
      double r = *vq;
      if (P0 > 0) {
        const int at = ((hr >> 3) * nqt + (q >> 3)) * 64 + (hr & 7) * 8 +
                       (q & 7);
        for (int sp = 0; sp < SUB_SPLITS; ++sp)
          r -= s.part[sp * tiles * 64 + at];
      }
      double x = 0.0;
#pragma unroll
      for (int j = 0; j < SUB_PB; ++j) {
        const double xj = __shfl_sync(0xffffffffu, r * di, j, 16);
        if (hr == j) x = xj;
        r -= Lr[j] * xj;
      }
      if (mine) *vq = x;
    }
    // the next panel's rows landed, this one's solution visible
    __pipeline_wait_prior(0);
    __syncthreads();
  }
  // sumsq: a thread a query, the rows in order (as K7's covariance sums
  // them, so that its diagonal is this sigma^2 to rounding)
  if (tid < Q) {
    double v = 0.0;
    for (int j = 0; j < n; ++j) {
      const double x = s.V[(size_t)j * ldq + tid];
      v += x * x;
    }
    s.sumsq[tid] = v;
  }
  __syncthreads();
}

// Where entry (r, c) of a staged column panel lives: row r of 16 doubles,
// the column swizzled by the row (c ^ 4 (r mod 4)), so that the tensor-core
// operand loads of sub_backward (lane (g, t) reads rows 4 i + t, columns 8
// a + g) hit 16 distinct 8-byte banks in each half-warp, and the pairs of
// columns that sub_load_cpanel copies stay contiguous.
__device__ __forceinline__ int sub_cswz(int r, int c) {
  return r * SUB_PB + (c ^ ((r & 3) << 2));
}

// Rows P0 .. n_pad - 1 of L, columns P0 .. P0 + 15 (the panel's diagonal
// block, then L_{>I,I}), into stage `slot` (sub_cswz; zeros outside the n
// x n block), by cp.async: a thread 16 bytes, eight threads a row.  At
// most n_pad rows of 16: within a stage's 16 (n_pad + 4) doubles.
__device__ __forceinline__ void sub_load_cpanel(const GprySub& s, int slot,
                                                int P0) {
  const int lda = sub_npad(s.n) + 4, rows = sub_npad(s.n) - P0;
  double* dst = s.stage + (size_t)slot * SUB_PB * lda;
  for (int e = threadIdx.x; e < rows * (SUB_PB / 2); e += blockDim.x) {
    const int r = e >> 3, c = 2 * (e & 7);
    const bool row = P0 + r < s.n;
    const double* src = s.L + (size_t)(P0 + r) * s.nmax + P0 + c;
    double* dp = dst + sub_cswz(r, c);
    if (row && P0 + c + 1 < s.n) {
      __pipeline_memcpy_async(dp, src, 2 * sizeof(double));
    } else {
      if (row && P0 + c < s.n)
        __pipeline_memcpy_async(dp, src, sizeof(double));
      else
        dp[0] = 0.0;
      dp[1] = 0.0;
    }
  }
}

// W = L^-T V in place for the s.Q queries (after sub_forward: W = L^-T
// L^-1 K), in the solve form.  Panels of SUB_PB rows from the bottom,
// left-looking: W_I = L_II^-T (V_I - L_{>I,I}^T W_{>I}).  L's column panel
// (16 contiguous doubles a row) is staged by cp.async in the two stages,
// the next panel's copy running while this one is solved; the update runs
// on the FP64 tensor cores (gpry_dmma, the transposed operand read from
// the stage), split as sub_forward's; the 16 x 16 diagonal
// block is solved by a half-warp a query, lane r holding column r of
// L_II.  Every thread calls it; V must be visible to all threads on entry
// (sub_forward ends with a barrier), and W is on exit (after a barrier).
// Rows n .. n_pad - 1 of V stay zero.
static __device__ void sub_backward(const GprySub& s) {
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int n = s.n, Q = s.Q, ldq = Q + 4, npad = sub_npad(n);
  const int lda = npad + 4, np = npad / SUB_PB;
  const int nqt = Q / 8, tiles = 2 * nqt;
  const int g = lane >> 2, t4 = lane & 3;
  const int hr = lane & 15, h = tid >> 4;

  if (np > 0) sub_load_cpanel(s, (np - 1) & 1, (np - 1) * SUB_PB);
  __pipeline_commit();
  __pipeline_wait_prior(0);
  __syncthreads();
  for (int p = np - 1; p >= 0; --p) {
    const int P0 = p * SUB_PB, K = npad - P0 - SUB_PB;
    if (p > 0) sub_load_cpanel(s, (p - 1) & 1, P0 - SUB_PB);
    __pipeline_commit();
    const double* Lc = s.stage + (size_t)(p & 1) * SUB_PB * lda;
    // the update's shares on the tensor cores: A = L_{>I,I}^T (A[i][k] at
    // staged row 16 + k, column i), B = W_{>I}
    if (K > 0) {
      for (int task = warp; task < SUB_SPLITS * tiles; task += SUB_WARPS) {
        const int tile = task % tiles, split = task / tiles;
        const int ta = tile / nqt, tb = tile - ta * nqt;
        double d0 = 0.0, d1 = 0.0;
        const int ca = 8 * ta + g;
        const double* Bcol =
            s.V + (size_t)(P0 + SUB_PB + t4) * ldq + 8 * tb + g;
        for (int k0 = 4 * split; k0 < K; k0 += 4 * SUB_SPLITS)
          gpry_dmma(d0, d1, Lc[sub_cswz(SUB_PB + k0 + t4, ca)],
                    Bcol[(size_t)k0 * ldq]);
        double* o = s.part + task * 64 + g * 8 + 2 * t4;
        o[0] = d0;
        o[1] = d1;
      }
    }
    if (tid >= SUB_THREADS - SUB_PB) {
      const int j = tid - (SUB_THREADS - SUB_PB);
      s.dinv[j] = P0 + j < n ? 1.0 / Lc[sub_cswz(j, j)] : 0.0;
    }
    __syncthreads();
    // the diagonal block, upper triangular L_II^T: a half-warp a query
    const int pn = n - P0 < SUB_PB ? n - P0 : SUB_PB;
    const bool mine = hr < pn;
    double Ur[SUB_PB];
#pragma unroll
    for (int j = 0; j < SUB_PB; ++j)
      Ur[j] = (mine && j > hr) ? Lc[sub_cswz(j, hr)] : 0.0;
    const double di = s.dinv[hr];
#pragma unroll
    for (int qq = 0; qq < SUB_MAXQ / 16; ++qq) {
      const int q = h + 16 * qq;
      if (q >= Q) break;  // uniform over the warp
      double* vq = s.V + (size_t)(P0 + hr) * ldq + q;
      double r = *vq;
      if (K > 0) {
        const int at = ((hr >> 3) * nqt + (q >> 3)) * 64 + (hr & 7) * 8 +
                       (q & 7);
        for (int sp = 0; sp < SUB_SPLITS; ++sp)
          r -= s.part[sp * tiles * 64 + at];
      }
      double x = 0.0;
#pragma unroll
      for (int j = SUB_PB - 1; j >= 0; --j) {
        const double xj = __shfl_sync(0xffffffffu, r * di, j, 16);
        if (hr == j) x = xj;
        r -= Ur[j] * xj;
      }
      if (mine) *vq = x;
    }
    // the next panel's rows landed, this one's solution visible
    __pipeline_wait_prior(0);
    __syncthreads();
  }
}

// ---------------------------------------------------------------------------
// The ungated sweep on route 0: K5's raw-space mean and std (GD = 0) and
// K8's, with their gradients in the raw coordinates (GD = 8, 32 or 64, the
// largest d the instance takes: 64 sums its gradients in passes of 32
// coordinates), of a block's Q queries.  One body,
// so that where K5 and K8 take the same Q their mean and std are the same
// operations, bit for bit.
//
//   x' = (x - x_loc) / x_scale,  k = sigma^2 k(x' / l, X / l)
//   mean = k . alpha * y_scale + y_loc
//   var  = prior - |L^-1 k|^2,  std = sqrt(max(var, 0)) * y_scale
//   d mean / dx = y_scale sum_j alpha_j dk_j/dx' / x_scale
//   d std / dx  = y_scale / (2 std') d var/dx' / x_scale (0 where var < 0),
//   d var / dx' = d prior/dx' - 2 sum_j w_j dk_j/dx',  w = L^-T L^-1 k.
//
// Shared layout (sub_plan's fixed doubles d + the spec program, d + 1 a
// query): ls[d] | qls[Q][d] | m[Q] | spec program | subst_blocked's area.
// ---------------------------------------------------------------------------

struct SubUngated {
  GpryKern kern;
  int nq, n, nmax, d, Q;
  const double *Xq_raw, *X, *alpha, *L, *theta, *x_loc, *x_scale, *scal;
  double *mean_out, *std_out, *gmean_out, *gstd_out;
};

// The mean and std of query q0 + qi from its k . alpha and ||L^-1 k||^2;
// returns the variance before the clamp.
template <bool SPEC>
__device__ __forceinline__ double sub_ungated_out(const SubUngated& a,
                                                  const GprySpec& spec,
                                                  double variance,
                                                  const double* qv, int q,
                                                  double m, double sumsq) {
  const double y_loc = a.scal[0], y_scale = a.scal[1];
  const double prior = SPEC ? gpry_spec_diag(spec, qv, 1, a.d) : variance;
  const double var0 = prior - sumsq;
  const double var = (var0 < 0.0) ? 0.0 : var0;  // NaN stays NaN
  a.mean_out[q] = m * y_scale + y_loc;
  a.std_out[q] = sqrt(var) * y_scale;
  return var0;
}

template <bool SPEC, int GD>
__device__ __forceinline__ void sub_ungated(const SubUngated& a,
                                            double* smem) {
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int Q = a.Q, d = a.d, n = a.n, q0 = blockIdx.x * Q;
  const int nqb = min(Q, a.nq - q0);
  double* ls = smem;
  double* qls = ls + d;
  double* ms = qls + (size_t)Q * d;
  double* prog = ms + Q;
  const GprySub sub = sub_carve(a.L, n, a.nmax, Q,
                                prog + gpry_spec_doubles(a.kern));
  GprySpec spec;
  if constexpr (SPEC)
    spec = gpry_stage_spec(prog, a.kern, a.theta, tid, blockDim.x);
  for (int k = tid; k < d; k += blockDim.x)
    ls[k] = SPEC ? 1.0 : exp(a.theta[1 + k]);
  __syncthreads();
  const double variance = SPEC ? 1.0 : exp(a.theta[0]);
  // the queries, preprocessed and over the length scales (1 in spec mode)
  for (int idx = tid; idx < nqb * d; idx += blockDim.x) {
    const int k = idx % d;
    qls[idx] = (a.Xq_raw[(size_t)q0 * d + idx] - a.x_loc[k]) /
               a.x_scale[k] / ls[k];
  }
  // the k vectors as the rows of V, k . alpha a warp a query
  sub_build_k<SPEC>(sub, a.kern.family, spec, variance, ls, qls, a.X, d,
                    nqb);
  for (int qi = warp; qi < nqb; qi += SUB_WARPS) {
    const double m = sub_dot_alpha(sub.V + qi, Q + 4, n, a.alpha);
    if (lane == 0) ms[qi] = m;
  }
  __syncthreads();
  // V = L^-1 K
  sub_forward(sub);
  if constexpr (GD == 0) {
    for (int qi = tid; qi < nqb; qi += blockDim.x)
      sub_ungated_out<SPEC>(a, spec, variance, qls + qi * d, q0 + qi,
                            ms[qi], sub.sumsq[qi]);
  } else {
    // W = L^-T L^-1 K
    sub_backward(sub);
    // the training rows again (as sub_build_k staged them), over the
    // length scales, in the stages; at d > 32 (GD = 64) they do not fit
    // there, and the sweep reads them from global memory, over the length
    // scales on the fly (the same division: the same values)
    constexpr bool STX = GD <= GPRY_GRAD_W;
    if (STX)
      for (int e = tid; e < n * d; e += blockDim.x)
        sub.stage[e] = SPEC ? a.X[e] : a.X[e] / ls[e % d];
    __syncthreads();
    // the gradient sweep: T threads a query, thread r of them the rows r,
    // r + T, ...; each squared distance again from direct differences; W
    // coordinates a pass (GD = 64: two passes over the rows, 2 x 32 sums
    // in registers where 2 x 64 would spill)
    const int T = SUB_THREADS / Q, qi = tid / T, r = tid - qi * T;
    const int ldq = Q + 4;
    const double* qv = qls + qi * d;
    const double* xr = STX ? sub.stage : a.X;
    constexpr int W = GD < GPRY_GRAD_W ? GD : GPRY_GRAD_W;
    const int passes = GD > W ? (d + W - 1) / W : 1;
    for (int pass = 0; pass < passes; ++pass) {
      // coordinates k0 + k, k < kw, of this pass
      const int k0 = pass * W, kw = d - k0;
      double am[W], aw[W];
#pragma unroll
      for (int k = 0; k < W; ++k) am[k] = aw[k] = 0.0;
      for (int j = r; qi < nqb && j < n; j += T) {
        const double al = a.alpha[j], w = sub.V[(size_t)j * ldq + qi];
        const double* xj = xr + (size_t)j * d;
        if constexpr (SPEC) {
          double gk[GPRY_GRAD_W];
          if constexpr (GD > GPRY_GRAD_W)
            gpry_spec_grad<true>(spec, qv, 1, xj, 1, d, false, gk, k0,
                                 kw < W ? kw : W);
          else
            gpry_spec_grad<false>(spec, qv, 1, xj, 1, d, false, gk);
#pragma unroll
          for (int k = 0; k < W; ++k)
            if (k < kw) {
              am[k] += al * gk[k];
              aw[k] += w * gk[k];
            }
        } else {
          double sq = 0.0;
#pragma unroll
          for (int k = 0; k < GD; ++k)
            if (k < d) {
              const double df = qv[k] - (STX ? xj[k] : xj[k] / ls[k]);
              sq += df * df;
            }
          const double c = 2.0 * variance * gpry_dk_dsq(a.kern.family, sq);
          const double ca = c * al, cw = c * w;
#pragma unroll
          for (int k = 0; k < W; ++k)
            if (k < kw) {
              const int kk = k0 + k;
              const double df = qv[kk] - (STX ? xj[kk] : xj[kk] / ls[kk]);
              am[k] += ca * df;
              aw[k] += cw * df;
            }
        }
      }
      // the T threads' sums (T = 32, 16 or 8 neighbouring lanes)
      for (int off = T / 2; off > 0; off >>= 1) {
#pragma unroll
        for (int k = 0; k < W; ++k)
          if (k < kw) {
            am[k] += __shfl_xor_sync(0xffffffffu, am[k], off);
            aw[k] += __shfl_xor_sync(0xffffffffu, aw[k], off);
          }
      }
      if (r == 0 && qi < nqb) {
        const int q = q0 + qi;
        // (each pass writes the same mean and std)
        const double var0 = sub_ungated_out<SPEC>(
            a, spec, variance, qv, q, ms[qi], sub.sumsq[qi]);
        const double y_scale = a.scal[1];
        const double sd = sqrt((var0 < 0.0) ? 0.0 : var0);
        // torch: the std's gradient y_scale / (2 sqrt(var)) passes the
        // clamp only where var >= 0
        const double dsd = var0 >= 0.0 ? y_scale / (2.0 * sd) : 0.0;
        double gprior[GPRY_GRAD_W];
        if constexpr (SPEC && GD > GPRY_GRAD_W)
          gpry_spec_grad<true>(spec, qv, 1, qv, 1, d, true, gprior, k0,
                               kw < W ? kw : W);
        else if constexpr (SPEC)
          gpry_spec_grad<false>(spec, qv, 1, qv, 1, d, true, gprior);
#pragma unroll
        for (int k = 0; k < W; ++k)
          if (k < kw) {
            const int kk = k0 + k;
            const double sa = am[k] / ls[kk], sw = aw[k] / ls[kk];
            a.gmean_out[(size_t)q * d + kk] = sa * y_scale / a.x_scale[kk];
            a.gstd_out[(size_t)q * d + kk] =
                dsd * ((SPEC ? gprior[k] : 0.0) - 2.0 * sw) / a.x_scale[kk];
          }
      }
    }
  }
}
