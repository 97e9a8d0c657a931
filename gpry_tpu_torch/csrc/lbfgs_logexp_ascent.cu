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
// ends non-finite returns (x0 as mapped, f(x0)).  nev counts the reference
// algorithm's value-and-gradient calls and line-search probes.
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
// What bounds it on the H100.  Per lane a chain of dependent evaluations
// (one value-and-gradient call per iteration and a few probes); each needs
// the forward substitution L v = k (and, for a gradient, the back
// substitution L^T w = v): n dependent steps each, over the n (n + 1) / 2
// entries of L.  The operations (about n^2 / 2 + n (3 d + 3) per probe,
// n^2 + n (5 d + 3) per value-and-gradient call) take well under a
// microsecond at 67 TFLOP/s; what bounds a lane is the latency of the two
// chains and of reading L.  8 lanes use 8 of the 132 SMs; all read the
// same L, so they share it in L2.
//
// Design.  One block of 128 threads per lane; the lane's state (u, f, g,
// the (S, Y, rho) history, kh, the stall count, nev) lives in shared
// memory, so a block exits when its own lane stops and nothing is read by
// the host until the launch ends.  Warp 0 runs the L-BFGS arithmetic, lane
// k owning coordinate k (the GD = 32 instance, d <= 32) or coordinates k
// and k + 32 (GD = 64, d = 33-64): dot products are warp reductions of the
// lane's partial sums.  The updates whose rounding decides a line search or
// a stall (u + t d, the Armijo threshold, the objective) are written with
// explicit roundings, as torch evaluates them, not contracted into fused
// multiply-adds, for each coordinate a lane owns.  The gradient's
// per-thread sums take one pass over the rows at GD = 32 (written out in
// k9_grad) and two passes of 32 coordinates at GD = 64 (gpry_block_grad_sums
// of common.cuh, K8's route 1: 2 x 64 sums a thread would spill from the
// registers; a shared-memory reduction of 128 threads x 128 sums would not
// fit beside the GP).
// * An accepted probe is reused: a line-search probe computes k, the mean
//   and v = L^-1 k (the value) and leaves them in place; when it passes,
//   the back substitution and the gradient sums run on them, so an
//   iteration whose probe passes makes one forward substitution (the value
//   part of the reference's value-and-gradient call is the same code on the
//   same point: bit-identical).  A failed search (t = 0) keeps the f and g
//   the lane holds (u + 0 d is u), unless the direction has a non-finite
//   entry: then, as in the reference, u + 0 d and its f and g are NaN.
// * Blocked substitutions, in the solve form (no L^-1 is formed), in panels
//   of 32 rows: the 32 x 32 diagonal block is solved by one warp, lane i
//   holding row i of the block in registers, with shuffles and the staged
//   reciprocals 1 / L_ii (a step of the chain is one product, one shuffle
//   and one update); the panel's matrix-vector update of the other rows is
//   shared by all warps, each row's sum split four ways; one barrier a
//   panel instead of a shared-memory round trip a row.
// * Routes (k9_route, mirrored on the host by ops/fused.py
//   lbfgs_logexp_ascent_plan): route 0 stages L packed (n (n + 1) / 2
//   doubles) in shared memory once per launch, with X where that fits too
//   (n <= 227 at d = 8) and without it up to n = 235; every warp then solves
//   each diagonal block itself (the same arithmetic, so no barrier between
//   the solve and the update).  Routes 1 and 2 stream L from global memory
//   (L2) in 32 x 32 tiles through a ring of 4 (route 1) or 2 (route 2)
//   shared-memory stages by cp.async, left-looking both ways (a row panel
//   of L forward, a column panel back), so that only the current panel's
//   partial sums are kept; the solution overwrites k in place and 1 / L_ii
//   comes from the diagonal tile.  Shared memory then grows with n only by
//   the staged GP's alpha and k, as K8's does: route 1 up to n = 12,180 at
//   d = 8, route 2 up to 13,236 (12,756 at d = 32).  Route 3 streams L as
//   route 1 does (4 stages) and keeps alpha and k in global memory (alpha
//   where it lies, k in the lane's n doubles of a workspace; L1 and L2 hold
//   them), so it takes every n (the fit, K11, bounds the training set
//   first: n <= 23,611 at d = 40); the same arithmetic as route 2.
//
// Spec mode (template SPEC) as K8's.
#include <cuda_pipeline.h>

#include "common.cuh"

#define K9_M 8
#define K9_LS 18
#define K9_STALL 5
#define K9_UCLIP 15.0
// rows of a substitution panel and the padded leading dimension of a
// streamed tile
#define K9_P 32
#define K9_TLD 33
#define K9_FULL 0xffffffffu

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

// The stages of the streamed routes' tile ring.
__host__ __device__ inline int k9_stages(int route) {
  return route == 2 ? 2 : 4;
}

// Shared doubles of the substitutions: on route 0, 1 / L_ii, v (n each)
// and packed L; on routes 1-3, the current panel's per-warp partial sums
// (GPRY_BLOCK_WARPS x K9_P) and the tile ring.
__host__ __device__ inline size_t k9_sub_doubles(int n, int route) {
  return route == 0 ? 2 * (size_t)n + gpry_tri(n)
                    : (size_t)GPRY_BLOCK_WARPS * K9_P +
                          (size_t)k9_stages(route) * K9_P * K9_TLD;
}

// The route (0: L staged in shared memory, 1 and 2: streamed through 4 or
// 2 stages, 3: streamed through 4 with alpha and k in global memory; -1:
// nothing fits) and whether X is staged too, with the shared memory it
// takes.
__host__ __device__ inline int k9_route(int n, int d, size_t spec,
                                        int* stage_x, size_t* smem) {
  for (int route = 0; route < 4; ++route)
    for (int sx = 1; sx >= 0; --sx) {
      const size_t bytes =
          sizeof(double) * (gpry_gp_doubles(n, d, sx != 0, spec, route < 3) +
                            k9_lane_doubles(d) + k9_sub_doubles(n, route));
      if (bytes <= GPRY_MAX_SMEM) {
        *stage_x = sx;
        *smem = bytes;
        return route;
      }
    }
  *stage_x = 0;
  *smem = 0;
  return -1;
}

struct K9Sub {
  const double* L;  // (nmax, nmax) row-major, global memory
  int n, nmax;
  int stages;       // routes 1-3: the ring's stages
  double* dinv;     // route 0: 1 / L_ii (n)
  double* vv;       // route 0: v = L^-1 k (n)
  double* Lp;       // route 0: L packed by rows
  double* acc;      // routes 1-3: GPRY_BLOCK_WARPS x K9_P partial sums
  double* ring;     // routes 1-3: `stages` tiles of K9_P x K9_TLD
};

// v = L^-1 k on route 0: the residuals in kv (k on entry), v into vv.
// Every warp solves each diagonal block, lane i holding row i of the block
// in registers (the chain of a step: one product, one shuffle, one
// update), then all threads update the rows below it, each row's sum split
// four ways.  Returns warp 0's lane-wise sum of v^2.  One barrier a panel.
__device__ double k9_fwd_staged(const K9Sub& s, double* kv) {
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int nt = blockDim.x, n = s.n;
  double sumsq = 0.0;
  for (int P0 = 0; P0 < n; P0 += K9_P) {
    const int pn = n - P0 < K9_P ? n - P0 : K9_P;
    const bool mine = lane < pn;
    const double* Li = s.Lp + gpry_tri(P0 + (mine ? lane : 0)) + P0;
    double Lr[K9_P];
#pragma unroll
    for (int j = 0; j < K9_P; ++j) Lr[j] = (mine && j < lane) ? Li[j] : 0.0;
    const double di = mine ? s.dinv[P0 + lane] : 0.0;
    double r = mine ? kv[P0 + lane] : 0.0, v = 0.0;
#pragma unroll
    for (int j = 0; j < K9_P; ++j) {
      if (j < pn) {
        const double vj = __shfl_sync(K9_FULL, r * di, j);
        if (lane == j) v = vj;
        r -= Lr[j] * vj;
      }
    }
    if (warp == 0 && mine) {
      s.vv[P0 + lane] = v;
      sumsq += v * v;
    }
    // rows below (only after a full panel)
    for (int b = P0 + pn; b < n; b += nt) {
      const int i = b + tid;
      const bool act = i < n;
      const double* Lrow = s.Lp + gpry_tri(act ? i : 0) + P0;
      double a0 = 0.0, a1 = 0.0, a2 = 0.0, a3 = 0.0;
#pragma unroll
      for (int j = 0; j < K9_P; j += 4) {
        const double v0 = __shfl_sync(K9_FULL, v, j);
        const double v1 = __shfl_sync(K9_FULL, v, j + 1);
        const double v2 = __shfl_sync(K9_FULL, v, j + 2);
        const double v3 = __shfl_sync(K9_FULL, v, j + 3);
        if (act) {
          a0 += Lrow[j] * v0;
          a1 += Lrow[j + 1] * v1;
          a2 += Lrow[j + 2] * v2;
          a3 += Lrow[j + 3] * v3;
        }
      }
      if (act) kv[i] -= (a0 + a1) + (a2 + a3);
    }
    __syncthreads();
  }
  return sumsq;
}

// w = L^-T v on route 0: the residuals in vv (v on entry), w into kv;
// panels from the bottom, lane i holding column i of the diagonal block in
// registers, the update of the rows above in the axpy form (row j of L
// read along its columns), each sum split four ways.  One barrier a panel.
__device__ void k9_bwd_staged(const K9Sub& s, double* kv) {
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int nt = blockDim.x, n = s.n;
  for (int P0 = ((n - 1) / K9_P) * K9_P; P0 >= 0 && n > 0; P0 -= K9_P) {
    const int pn = n - P0 < K9_P ? n - P0 : K9_P;
    const bool mine = lane < pn;
    double Lc[K9_P];
#pragma unroll
    for (int j = 0; j < K9_P; ++j)
      Lc[j] = (mine && j > lane && j < pn)
                  ? s.Lp[gpry_tri(P0 + j) + P0 + lane]
                  : 0.0;
    const double di = mine ? s.dinv[P0 + lane] : 0.0;
    double r = mine ? s.vv[P0 + lane] : 0.0, w = 0.0;
#pragma unroll
    for (int j = K9_P - 1; j >= 0; --j) {
      if (j < pn) {
        const double wj = __shfl_sync(K9_FULL, r * di, j);
        if (lane == j) w = wj;
        r -= Lc[j] * wj;
      }
    }
    if (warp == 0 && mine) kv[P0 + lane] = w;
    for (int b = 0; b < P0; b += nt) {
      const int i = b + tid;
      const bool act = i < P0;
      double a0 = 0.0, a1 = 0.0, a2 = 0.0, a3 = 0.0;
#pragma unroll
      for (int j = 0; j < K9_P; j += 4) {
        const double w0 = __shfl_sync(K9_FULL, w, j);
        const double w1 = __shfl_sync(K9_FULL, w, j + 1);
        const double w2 = __shfl_sync(K9_FULL, w, j + 2);
        const double w3 = __shfl_sync(K9_FULL, w, j + 3);
        if (act && j < pn) {
          a0 += s.Lp[gpry_tri(P0 + j) + i] * w0;
          if (j + 1 < pn) a1 += s.Lp[gpry_tri(P0 + j + 1) + i] * w1;
          if (j + 2 < pn) a2 += s.Lp[gpry_tri(P0 + j + 2) + i] * w2;
          if (j + 3 < pn) a3 += s.Lp[gpry_tri(P0 + j + 3) + i] * w3;
        }
      }
      if (act) s.vv[i] -= (a0 + a1) + (a2 + a3);
    }
    __syncthreads();
  }
}

// Routes 1-3: tile (P, J) of L (rows 32 P.., columns 32 J..; zeros
// outside the n x n block) into ring slot `slot` by cp.async.
__device__ __forceinline__ void k9_load_tile(const K9Sub& s, int slot, int P,
                                             int J) {
  double* dst = s.ring + (size_t)slot * K9_P * K9_TLD;
  const int P0 = K9_P * P, J0 = K9_P * J;
  for (int e = threadIdx.x; e < K9_P * K9_P; e += blockDim.x) {
    const int row = e / K9_P, col = e % K9_P;
    double* dp = dst + row * K9_TLD + col;
    if (P0 + row < s.n && J0 + col < s.n)
      __pipeline_memcpy_async(
          dp, s.L + (size_t)(P0 + row) * s.nmax + J0 + col, sizeof(double));
    else
      *dp = 0.0;
  }
}

// The tile order of a substitution, left-looking: the forward takes row
// panel P = 0, 1, ... with J = 0..P, the back substitution column panel
// J = np - 1, ..., 0 with P = np - 1..J; the diagonal block last in each.
__device__ __forceinline__ void k9_next(bool fwd, int np, int& P, int& J) {
  if (fwd) {
    if (++J > P) {
      ++P;
      J = 0;
    }
  } else if (P > J) {
    --P;
  } else {
    --J;
    P = np - 1;
  }
}

// Routes 1-3: the forward (FWD: v = L^-1 k) or the back substitution (w =
// L^-T v) in place in kv, with L streamed tile by tile.  Off-diagonal
// tiles are shared by the warps, warp q taking 8 of the 32 columns
// (forward) or rows (back) into a partial sum it keeps in a register
// across the panel and leaves in s.acc at the panel's last off-diagonal
// tile; warp 0 solves each diagonal block.  One barrier a tile; returns
// warp 0's lane-wise sum of v^2 (forward).
template <bool FWD>
__device__ double k9_subst_stream(const K9Sub& s, double* kv) {
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int nt = blockDim.x, n = s.n, S = s.stages;
  const int np = (n + K9_P - 1) / K9_P, T = np * (np + 1) / 2;
  for (int i = tid; i < GPRY_BLOCK_WARPS * K9_P; i += nt) s.acc[i] = 0.0;
  int lp = FWD ? 0 : np - 1, lj = lp;  // the next tile to load
  for (int k = 0; k < S - 1; ++k) {
    if (k < T) {
      k9_load_tile(s, k, lp, lj);
      k9_next(FWD, np, lp, lj);
    }
    __pipeline_commit();
  }
  int P = FWD ? 0 : np - 1, J = P;
  double part = 0.0, sumsq = 0.0;
  for (int k = 0; k < T; ++k) {
    if (S == 4)
      __pipeline_wait_prior(2);
    else
      __pipeline_wait_prior(0);
    __syncthreads();
    if (k + S - 1 < T) {
      k9_load_tile(s, (k + S - 1) % S, lp, lj);
      k9_next(FWD, np, lp, lj);
    }
    __pipeline_commit();
    const double* Tt = s.ring + (size_t)(k % S) * K9_P * K9_TLD;
    const int P0 = K9_P * P, J0 = K9_P * J;
    if (J == P) {
      if (warp == 0) {
        const int pn = n - P0 < K9_P ? n - P0 : K9_P;
        const bool mine = lane < pn;
        double r = 0.0, x = 0.0, Lt[K9_P];
        if (mine) {
          r = kv[P0 + lane];
          for (int q = 0; q < GPRY_BLOCK_WARPS; ++q)
            r -= s.acc[q * K9_P + lane];
        }
        const double di = mine ? 1.0 / Tt[lane * K9_TLD + lane] : 0.0;
        // lane i: row i (forward) or column i (back) of the block; the
        // tile is zero outside the n x n block
#pragma unroll
        for (int j = 0; j < K9_P; ++j)
          Lt[j] = FWD ? (j < lane ? Tt[lane * K9_TLD + j] : 0.0)
                      : (j > lane ? Tt[j * K9_TLD + lane] : 0.0);
        if (FWD) {
#pragma unroll
          for (int j = 0; j < K9_P; ++j) {
            if (j < pn) {
              const double xj = __shfl_sync(K9_FULL, r * di, j);
              if (lane == j) x = xj;
              r -= Lt[j] * xj;
            }
          }
          if (mine) sumsq += x * x;
        } else {
#pragma unroll
          for (int j = K9_P - 1; j >= 0; --j) {
            if (j < pn) {
              const double xj = __shfl_sync(K9_FULL, r * di, j);
              if (lane == j) x = xj;
              r -= Lt[j] * xj;
            }
          }
        }
        if (mine) kv[P0 + lane] = x;
      }
    } else if (FWD) {
      // row P0 + lane against v of columns J0 + 8 warp ..
      const double* Tr = Tt + lane * K9_TLD + 8 * warp;
      const double* xv = kv + J0 + 8 * warp;
#pragma unroll
      for (int jj = 0; jj < 8; ++jj) part += Tr[jj] * xv[jj];
      if (J == P - 1) {
        s.acc[warp * K9_P + lane] = part;
        part = 0.0;
      }
    } else {
      // column J0 + lane against w of rows P0 + 8 warp ..
      double a = 0.0;
#pragma unroll
      for (int jj = 0; jj < 8; ++jj) {
        const int j = P0 + 8 * warp + jj;
        a += Tt[(8 * warp + jj) * K9_TLD + lane] * (j < n ? kv[j] : 0.0);
      }
      part += a;
      if (P == J + 1) {
        s.acc[warp * K9_P + lane] = part;
        part = 0.0;
      }
    }
    k9_next(FWD, np, P, J);
  }
  __pipeline_wait_prior(0);
  __syncthreads();
  return sumsq;
}

// The negated LogExp at the u-space point pu (d; coordinate k written by
// thread k): k, the mean and v = L^-1 k, left in g.kv, s.vv (the same
// vector on routes 1-3: v overwrites k) and g.res[0], g.res[1] for
// k9_grad (kv on route 3 in global memory).  Returns F in every lane of
// warp 0 (0 elsewhere).
// Every thread calls it.
template <bool SPEC, bool STREAM>
__device__ double k9_value(const GpryGP& g, const GprySpec& spec,
                           const K9Lane& ln, const K9Sub& s, const double* pu,
                           double y_loc, double y_scale, double clip,
                           double y_max, double c1, double ns2) {
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int n = g.n, d = g.d;
  if (tid < d) {
    const double u = pu[tid];
    const double uc = u < -K9_UCLIP ? -K9_UCLIP : (u > K9_UCLIP ? K9_UCLIP : u);
    const double sg = 1.0 / (1.0 + exp(-uc));
    const double x = __dadd_rn(ln.lo[tid], __dmul_rn(ln.A[tid], sg));
    ln.sig[tid] = sg;
    ln.q[tid] = (x - g.x_loc[tid]) / g.x_scale[tid] / g.ls[tid];
  }
  __syncthreads();
  const double* q = ln.q;
  double m = 0.0;
  for (int j = tid; j < n; j += blockDim.x) {
    double kj;
    if constexpr (SPEC) {
      kj = gpry_spec_cov(spec, q, 1, g.Xt + (size_t)j * g.xj, g.xk, d);
    } else {
      double sq = 0.0;
      for (int k = 0; k < d; ++k) {
        const double df = q[k] - gpry_xt(g, j, k);
        sq += df * df;
      }
      kj = g.variance * gpry_k_of_sq(g.family, sq);
    }
    g.kv[j] = kj;
    m += kj * g.alpha[j];
  }
  m = gpry_warp_sum(m);
  if (lane == 0) g.red[warp] = m;
  __syncthreads();
  double sumsq =
      STREAM ? k9_subst_stream<true>(s, g.kv) : k9_fwd_staged(s, g.kv);
  if (tid >= 32) return 0.0;
  sumsq = gpry_warp_sum(sumsq);
  double mm = 0.0;
  for (int w = 0; w < GPRY_BLOCK_WARPS; ++w) mm += g.red[w];
  const double prior = SPEC ? gpry_spec_diag(spec, q, 1, d) : g.variance;
  const double var_raw = prior - sumsq;
  if (lane == 0) {
    g.res[0] = mm;
    g.res[1] = var_raw;
  }
  const double mu = __dadd_rn(__dmul_rn(mm, y_scale), y_loc);
  const double var_c = (var_raw < 0.0) ? 0.0 : var_raw;
  const double sd = __dmul_rn(sqrt(var_c), y_scale);
  const double var = __dsub_rn(__dmul_rn(sd, sd), ns2);
  const double mu_c = gpry_clip(mu, clip);
  const double varcl = (var < 1e-300) ? 1e-300 : var;
  return -__dadd_rn(__dmul_rn(c1, __dsub_rn(mu_c, y_max)),
                    __dmul_rn(0.5, log(varcl)));
}

// dF/du at pu into gout (d, by threads 0..d-1) from what k9_value left:
// the back substitution w = L^-T v into g.kv, then d mean / dq and
// d var / dq into g.res (at GD = 64 by gpry_block_grad_sums, K8's route 1).
// Every thread calls it; it ends with a barrier.
template <bool SPEC, bool STREAM, int GD>
__device__ void k9_grad(const GpryGP& g, const GprySpec& spec,
                        const K9Lane& ln, const K9Sub& s, const double* pu,
                        double* gout, double y_loc, double y_scale,
                        double clip, double c1, double ns2) {
  const int tid = threadIdx.x;
  const int d = g.d;
  if (STREAM)
    k9_subst_stream<false>(s, g.kv);
  else
    k9_bwd_staged(s, g.kv);
  if constexpr (GD <= GPRY_GRAD_W) {
    // The d <= 32 instance writes its sums out here: the same operations
    // as gpry_block_grad_sums<SPEC, 32> (K8's), whose inlined form made
    // this instance 3% slower on an H100 80GB HBM3 at 700 W (254 registers
    // against 238, the same bits; compare_trees.sh kernels).
    const int lane = tid & 31, warp = tid >> 5;
    const int n = g.n;
    const double* q = ln.q;
    // per thread: sum_j alpha_j grad k_j and sum_j w_j grad k_j over its
    // rows (fast mode: without the common 1 / ls_k)
    double am[GPRY_GRAD_W], aw[GPRY_GRAD_W];
    for (int k = 0; k < d; ++k) am[k] = aw[k] = 0.0;
    for (int j = tid; j < n; j += blockDim.x) {
      const double a = g.alpha[j], w = g.kv[j];
      if constexpr (SPEC) {
        double gk[GPRY_GRAD_W];
        gpry_spec_grad<false>(spec, q, 1, g.Xt + (size_t)j * g.xj, g.xk, d,
                              false, gk);
        for (int k = 0; k < d; ++k) {
          am[k] += a * gk[k];
          aw[k] += w * gk[k];
        }
      } else {
        double sq = 0.0;
        for (int k = 0; k < d; ++k) {
          const double df = q[k] - gpry_xt(g, j, k);
          sq += df * df;
        }
        const double c = 2.0 * g.variance * gpry_dk_dsq(g.family, sq);
        const double ca = c * a, cw = c * w;
        for (int k = 0; k < d; ++k) {
          const double df = q[k] - gpry_xt(g, j, k);
          am[k] += ca * df;
          aw[k] += cw * df;
        }
      }
    }
    double* part = g.red + GPRY_BLOCK_WARPS;  // [warp][2 d]
    double* gprior = part + GPRY_BLOCK_WARPS * 2 * d;
    for (int k = 0; k < d; ++k) {
      const double sa = gpry_warp_sum(am[k]);
      const double sw = gpry_warp_sum(aw[k]);
      if (lane == 0) {
        part[warp * 2 * d + k] = sa;
        part[warp * 2 * d + d + k] = sw;
      }
    }
    if (tid == 0) {
      if constexpr (SPEC) {
        gpry_spec_grad<false>(spec, q, 1, q, 1, d, true, gprior);
      } else {
        for (int k = 0; k < d; ++k) gprior[k] = 0.0;
      }
    }
    __syncthreads();
    if (tid < 2 * d) {
      double sm = 0.0;
      for (int w = 0; w < GPRY_BLOCK_WARPS; ++w) sm += part[w * 2 * d + tid];
      const int k = tid < d ? tid : tid - d;
      sm = sm / g.ls[k];
      if (tid < d)
        g.res[2 + k] = sm;
      else
        g.res[2 + d + k] = gprior[k] - 2.0 * sm;
    }
    __syncthreads();
  } else {
    gpry_block_grad_sums<SPEC, GD>(g, spec, ln.q);
  }
  if (tid < d) {
    const int k = tid;
    const double var_raw = g.res[1];
    const double mu = __dadd_rn(__dmul_rn(g.res[0], y_scale), y_loc);
    const double var_c = (var_raw < 0.0) ? 0.0 : var_raw;
    const double sq = sqrt(var_c);
    const double sd = __dmul_rn(sq, y_scale);
    const double var = __dsub_rn(__dmul_rn(sd, sd), ns2);
    const double varcl = (var < 1e-300) ? 1e-300 : var;
    // torch.minimum: half the gradient at a tie, none above clip_max
    const double tie = (mu == clip) ? 0.5 : ((mu > clip) ? 0.0 : 1.0);
    const double g_mupre = (-c1 * tie) * y_scale;
    const double g_var = (var >= 1e-300) ? -0.5 / varcl : 0.0;
    const double g_sd = 2.0 * __dmul_rn(g_var, sd);  // g sd + g sd, exact
    const double g_varc = (g_sd * y_scale) / (2.0 * sq);
    const double g_vraw = (var_raw >= 0.0) ? g_varc : 0.0;
    const double gp = __dadd_rn(__dmul_rn(g_mupre, g.res[2 + k]),
                                __dmul_rn(g_vraw, g.res[2 + d + k]));
    const double sg = ln.sig[k];
    const double gsig = (gp / g.x_scale[k]) * ln.A[k];
    const double gu = (gsig * (1.0 - sg)) * sg;
    const double u = pu[k];
    gout[k] = (u >= -K9_UCLIP && u <= K9_UCLIP) ? gu : 0.0;
  }
  __syncthreads();
}

// Warp 0's dot product of two d-vectors whose entries k = lane + 32 c
// (c < C) a lane holds: the lane's partial sum, then a warp reduction.
template <int C>
__device__ __forceinline__ double k9_dot(const double* a, const double* b) {
  double s = a[0] * b[0];
#pragma unroll
  for (int c = 1; c < C; ++c) s += a[c] * b[c];
  return gpry_warp_sum(s);
}

// The two-loop direction into ln.dir and st->gd (t, ok, nls reset), by
// warp 0, lane k owning coordinates lane + 32 c, c < C (C = 1: d <= 32, 2:
// d <= 64): the same operations per coordinate, the dot products over the
// lane's C partial products.
template <int C>
__device__ __forceinline__ void k9_direction(const K9Lane& ln, K9State* st,
                                             int lane, int d, const bool* on,
                                             double eps) {
  const int kh = st->kh;
  double gk[C], qk[C], sj[C], yj[C], rk[C], dk[C];
#pragma unroll
  for (int c = 0; c < C; ++c) {
    gk[c] = on[c] ? ln.g[lane + 32 * c] : 0.0;
    qk[c] = gk[c];
  }
  double alf[K9_M];
#pragma unroll
  for (int j = 0; j < K9_M; ++j) {
#pragma unroll
    for (int c = 0; c < C; ++c) {
      sj[c] = on[c] ? ln.S[j * d + lane + 32 * c] : 0.0;
      yj[c] = on[c] ? ln.Y[j * d + lane + 32 * c] : 0.0;
    }
    const double dot = k9_dot<C>(sj, qk);
    const double a = j < kh ? ln.rho[j] * dot : 0.0;
#pragma unroll
    for (int c = 0; c < C; ++c) qk[c] = __dsub_rn(qk[c], __dmul_rn(a, yj[c]));
    alf[j] = a;
  }
#pragma unroll
  for (int c = 0; c < C; ++c) {
    sj[c] = on[c] ? ln.S[lane + 32 * c] : 0.0;
    yj[c] = on[c] ? ln.Y[lane + 32 * c] : 0.0;
  }
  const double yy = k9_dot<C>(yj, yj);
  const double sy0 = k9_dot<C>(sj, yj);
  double gamma = kh > 0 ? sy0 / (yy < eps ? eps : yy) : 1.0;
  gamma = gamma < 1e-8 ? 1e-8 : (gamma > 1e8 ? 1e8 : gamma);
#pragma unroll
  for (int c = 0; c < C; ++c) rk[c] = __dmul_rn(gamma, qk[c]);
#pragma unroll
  for (int j = K9_M - 1; j >= 0; --j) {
#pragma unroll
    for (int c = 0; c < C; ++c) {
      sj[c] = on[c] ? ln.S[j * d + lane + 32 * c] : 0.0;
      yj[c] = on[c] ? ln.Y[j * d + lane + 32 * c] : 0.0;
    }
    const double dot = k9_dot<C>(yj, rk);
    const double b = j < kh ? ln.rho[j] * dot : 0.0;
    const double cc = j < kh ? alf[j] - b : 0.0;
#pragma unroll
    for (int c = 0; c < C; ++c) rk[c] = __dadd_rn(rk[c], __dmul_rn(cc, sj[c]));
  }
#pragma unroll
  for (int c = 0; c < C; ++c) dk[c] = -rk[c];
  double gd = k9_dot<C>(gk, dk);
  if (!(gd < 0.0)) {
#pragma unroll
    for (int c = 0; c < C; ++c) dk[c] = -gk[c];
    gd = k9_dot<C>(gk, dk);
  }
#pragma unroll
  for (int c = 0; c < C; ++c)
    if (on[c]) ln.dir[lane + 32 * c] = dk[c];
  if (lane == 0) {
    st->gd = gd;
    st->t = 1.0;
    st->ok = 0;
    st->nls = 0;
  }
}

// The step's pair s = un - u, y = gn - g into the history (when the line
// search passed and s.y > 1e-10), u = un, g = gn; *sy and *gnorm = |gn| on
// every lane.  Warp 0, lane k owning coordinates lane + 32 c, c < C.
template <int C>
__device__ __forceinline__ void k9_history(const K9Lane& ln, int lane, int d,
                                           const bool* on, bool ok,
                                           double* sy_out,
                                           double* gnorm_out) {
  double unk[C], gnk[C], sv[C], yv[C];
#pragma unroll
  for (int c = 0; c < C; ++c) {
    const int k = lane + 32 * c;
    const double uk = on[c] ? ln.u[k] : 0.0;
    unk[c] = on[c] ? ln.un[k] : 0.0;
    const double gkc = on[c] ? ln.g[k] : 0.0;
    gnk[c] = on[c] ? ln.gn[k] : 0.0;
    sv[c] = unk[c] - uk;
    yv[c] = gnk[c] - gkc;
  }
  const double sy = k9_dot<C>(sv, yv);
  const double gnorm = sqrt(k9_dot<C>(gnk, gnk));
  const bool store = ok && sy > 1e-10;
#pragma unroll
  for (int c = 0; c < C; ++c) {
    const int k = lane + 32 * c;
    if (store && on[c]) {
      for (int j = K9_M - 1; j > 0; --j) {
        ln.S[j * d + k] = ln.S[(j - 1) * d + k];
        ln.Y[j * d + k] = ln.Y[(j - 1) * d + k];
      }
      ln.S[k] = sv[c];
      ln.Y[k] = yv[c];
    }
    if (on[c]) {
      ln.u[k] = unk[c];
      ln.g[k] = gnk[c];
    }
  }
  *sy_out = sy;
  *gnorm_out = gnorm;
}

// GD: the largest d the instance takes, 32 (a coordinate a lane of warp
// 0) or 64 (two); VG: route 3, alpha and k in global memory, k in the
// lane's n doubles of `work` (a template argument, so that the other
// routes address their staged vectors as shared memory).
template <bool SPEC, bool STREAM, int GD, bool VG>
__global__ void __launch_bounds__(GPRY_BLOCK_THREADS, 1)
lbfgs_logexp_ascent_kernel(
    GpryKern kern, int R, int n, int nmax, int d, int stage_x,
    int stages, int maxiter, const double* __restrict__ x0s,
    const double* __restrict__ lo_g, const double* __restrict__ hi_g,
    const double* __restrict__ X,
    const double* __restrict__ alpha, const double* __restrict__ L,
    const double* __restrict__ theta, const double* __restrict__ x_loc,
    const double* __restrict__ x_scale, const double* __restrict__ scal,
    double c1, double ns2, double* __restrict__ work,
    double* __restrict__ xs_out, double* __restrict__ f_out,
    long long* __restrict__ nev_out) {
  constexpr int C = GD / 32;  // coordinates a lane of warp 0
  extern __shared__ double smem[];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int nt = blockDim.x, nw = nt >> 5;
  const int r = blockIdx.x;
  GprySpec spec;
  double* tail;
  const GpryGP g = gpry_stage_gp<SPEC, VG>(smem, kern, n, nmax, d,
                                           stage_x != 0, X, alpha, L, theta,
                                           x_loc, x_scale, &spec, &tail,
                                           work);
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
  K9Sub sub;
  sub.L = L;
  sub.n = n;
  sub.nmax = nmax;
  sub.stages = stages;
  double* sb = tail + k9_lane_doubles(d);
  if (STREAM) {
    // the substitutions run in place in k
    sub.dinv = sub.Lp = nullptr;
    sub.vv = g.kv;
    sub.acc = sb;
    sub.ring = sb + GPRY_BLOCK_WARPS * K9_P;
  } else {
    sub.dinv = sb;
    sub.vv = sb + n;
    sub.Lp = sub.vv + n;
    sub.acc = sub.ring = nullptr;
    // 1 / L_ii and L packed by rows
    for (int i = tid; i < n; i += nt)
      sub.dinv[i] = 1.0 / L[(size_t)i * nmax + i];
    for (int i = warp; i < n; i += nw)
      for (int j = lane; j <= i; j += 32)
        sub.Lp[gpry_tri(i) + j] = L[(size_t)i * nmax + j];
  }
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
  for (int i = tid; i < 2 * K9_M * d + K9_M; i += nt) ln.S[i] = 0.0;
  __syncthreads();
  {
    const double F = k9_value<SPEC, STREAM>(g, spec, ln, sub, ln.u, y_loc,
                                            y_scale, clip, y_max, c1, ns2);
    k9_grad<SPEC, STREAM, GD>(g, spec, ln, sub, ln.u, ln.g, y_loc, y_scale,
                              clip, c1, ns2);
    if (tid == 0) {
      st->f = st->f0 = F;
      st->stop = !isfinite(F);
      st->nev = 1;
      st->kh = 0;
      st->stall = 0;
    }
  }
  __syncthreads();

  // warp 0's lane owns coordinates lane + 32 c, c < C
  bool on[C];
#pragma unroll
  for (int c = 0; c < C; ++c) on[c] = lane + 32 * c < d;
  for (int it = 0; it < maxiter; ++it) {
    if (st->stop) break;
    // the two-loop direction and the steepest-descent safeguard (warp 0)
    if (warp == 0) {
      k9_direction<C>(ln, st, lane, d, on, eps);
    }
    __syncthreads();
    // Armijo backtracking: each probe computes the value and leaves k, v
    // and the mean in place
    double Fn = 0.0;
    for (int ls = 0; ls < K9_LS; ++ls) {
      if (tid < d)
        ln.un[tid] = __dadd_rn(ln.u[tid], __dmul_rn(st->t, ln.dir[tid]));
      const double Ft = k9_value<SPEC, STREAM>(g, spec, ln, sub, ln.un,
                                               y_loc, y_scale, clip, y_max,
                                               c1, ns2);
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
      // the accepted probe's k and v: the gradient at un
      k9_grad<SPEC, STREAM, GD>(g, spec, ln, sub, ln.un, ln.gn, y_loc,
                                y_scale, clip, c1, ns2);
    } else {
      // t = 0: u + 0 d is u, and the reference's value and gradient there
      // are the ones the lane holds; unless d has a non-finite entry, when
      // u + 0 d, and the value and gradient there, are NaN
      bool fin = true;
      for (int k = 0; k < d; ++k) fin = fin && isfinite(ln.dir[k]);
      if (tid < d) {
        ln.un[tid] = fin ? ln.u[tid]
                         : __dadd_rn(ln.u[tid], __dmul_rn(0.0, ln.dir[tid]));
        ln.gn[tid] = fin ? ln.g[tid] : NAN;
      }
      Fn = fin ? st->f : NAN;
    }
    if (tid == 0) {
      if (!ok) st->t = 0.0;
      st->nev += st->nls + 1;
    }
    __syncthreads();
    // the history, the stops and the step (warp 0)
    if (warp == 0) {
      double sy, gnorm;
      k9_history<C>(ln, lane, d, on, ok, &sy, &gnorm);
      const bool store = ok && sy > 1e-10;
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
        st->stop = !ok || gnorm < 1e-8 || !isfinite(Fn) ||
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

// The route (0: L staged, 1-3: streamed, -1: nothing fits), whether X
// is staged, and the shared memory (bytes) it takes.  Route 3 needs n
// doubles of global workspace a lane.
extern "C" int gpry_lbfgs_logexp_ascent_plan(GpryKern kern, int n, int d,
                                             int* stage_x, size_t* smem) {
  return k9_route(n, d, gpry_spec_doubles(kern), stage_x, smem);
}

// The instance of `route` at d: L staged (route 0) or streamed (1-3), the
// vectors in global memory on route 3, GD 32 or 64.
template <bool SPEC>
static auto k9_kernel(int route, int d) {
  const bool w = d > GPRY_GRAD_W;
  if (route == 0)
    return w ? lbfgs_logexp_ascent_kernel<SPEC, false, 64, false>
             : lbfgs_logexp_ascent_kernel<SPEC, false, 32, false>;
  if (route < 3)
    return w ? lbfgs_logexp_ascent_kernel<SPEC, true, 64, false>
             : lbfgs_logexp_ascent_kernel<SPEC, true, 32, false>;
  return w ? lbfgs_logexp_ascent_kernel<SPEC, true, 64, true>
           : lbfgs_logexp_ascent_kernel<SPEC, true, 32, true>;
}

// scal = [y_loc, y_scale, clip_max, svm intercept, svm gamma, y_max]; c1 =
// 2 zeta, ns2 = sigma_n^2 (raw units), both as the plain version rounds
// them; work: R n doubles on route 3 (else unused, may be null).
extern "C" int gpry_lbfgs_logexp_ascent(
    GpryKern kern, int R, int n, int nmax, int d, int maxiter,
    const void* x0s, const void* lo, const void* hi, const void* X,
    const void* alpha, const void* L, const void* theta, const void* x_loc,
    const void* x_scale, const void* scal, double c1, double ns2,
    void* work, void* xs_out, void* f_out, void* nev_out, void* stream) {
  if (d > GPRY_GRAD_MAX_D || R < 0) return (int)cudaErrorInvalidValue;
  if (R == 0) return 0;
  int stage_x;
  size_t smem;
  const int route = gpry_lbfgs_logexp_ascent_plan(kern, n, d, &stage_x, &smem);
  if (route < 0) return (int)cudaErrorInvalidConfiguration;
  if (route == 3 && work == nullptr) return (int)cudaErrorInvalidValue;
  auto kernel = kern.nodes ? k9_kernel<true>(route, d)
                           : k9_kernel<false>(route, d);
  cudaError_t e = gpry_set_smem(kernel, smem);
  if (e != cudaSuccess) return (int)e;
  kernel<<<R, GPRY_BLOCK_THREADS, smem, (cudaStream_t)stream>>>(
      kern, R, n, nmax, d, stage_x, route ? k9_stages(route) : 0, maxiter,
      (const double*)x0s,
      (const double*)lo, (const double*)hi, (const double*)X,
      (const double*)alpha, (const double*)L, (const double*)theta,
      (const double*)x_loc, (const double*)x_scale, (const double*)scal, c1,
      ns2, (double*)work, (double*)xs_out, (double*)f_out,
      (long long*)nev_out);
  return (int)cudaGetLastError();
}
