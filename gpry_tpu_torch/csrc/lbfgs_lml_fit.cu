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
// that is microseconds; what bounds a lane is latency: the n dependent
// pivots of the factorization, the barriers between its steps, the
// shared-memory traffic of the updates and the chain of instructions a
// kernel pair takes, at 8 warps a block and 255 registers a thread (one
// block an SM).  2 to 8 lanes use 2 to 8 of the 132 SMs.
//
// Design.  One block of K11_THREADS per lane; the lane's state (u, f, g,
// the (S, Y, rho) history, kh, the stall count, nev) lives in shared
// memory, so a block exits when its own lane stops and the host reads
// nothing until the launch ends.
// * An accepted probe is reused: a line-search probe at u + t d computes
//   the value (the factor of K, z = L^-1 y and log det) and leaves the
//   factor in place; when it passes, the gradient is computed from that
//   factor, so an iteration whose probe passes factors once (the value part
//   of the reference's value-and-gradient call runs the same code on the
//   same point: bit-identical).  A failed search (t = 0) keeps the f and g
//   the lane holds (u + 0 d is u), unless the direction has a non-finite
//   entry: then, as in the reference, u + 0 d and its f and g are NaN.
// * The bordered matrix [[K, .], [y^T, .]] (packed lower triangle by rows,
//   y as row n) is factored blocked and right-looking, in panels of
//   K11_NB = 16 columns: one warp factors the 16 x 16 diagonal block in
//   registers (shuffles, no block barrier), a thread a row solves the
//   panel below it, and the trailing update runs on the FP64 tensor cores
//   (mma.sync m8n8k4; a warp takes 2 x 2 blocks of 8 x 8 tiles, two A and
//   two B fragments a step feeding four chains): three barriers a panel
//   instead of one a column.  Row n comes out as z.  The pair build takes
//   two pairs a lane at a time (independent chains).
// * The gradient, d lml / d theta_j = 1/2 sum_ab (alpha alpha^T - K^-1)_ab
//   dK_ab / dtheta_j, forms K^-1 once: M = L^-1 in place (the diagonal
//   blocks inverted by a warp each in registers, then each 16-row panel
//   M_I,<I = -(M_II L_I,<I) M_<I,<I with the product on the tensor cores,
//   the tiles held in registers across one barrier before they overwrite
//   their inputs), alpha = M^T z, K^-1 = M^T M in place (row panels from
//   the top, on the tensor cores, the same register trick), then one pass
//   over the pairs reads K^-1_ab and the pair's tangents (the fast
//   families from the pair's squared distance, one exponential a pair, two
//   pairs a lane; spec mode the interpreter's gpry_spec_dtheta).
// * Routes (k11_route, mirrored on the host by ops/fused.py
//   lbfgs_lml_fit_plan): the packed triangle in shared memory up to
//   n = 236 at d = 8 (fast family); above that, in the block's global
//   workspace (L2), with the operands of each tensor-core step staged by
//   cp.async in a shared buffer of fixed size (K11_STAGE doubles: two
//   chunks of 128 rows of the panel for the trailing update, 256 columns
//   of the row panel for L^-1, 256 rows of the column panel for K^-1), so
//   that shared memory grows with n only by alpha: up to n = 24,539 at
//   d = 8 (23,843 at d = 32).  The wrapper raises ValueError above.  X
//   (d n doubles) goes to shared memory too where it fits (route 0 up to
//   n = 229 at d = 8): the pair build and the contraction read it for
//   every pair, and from global memory each of those reads waits on L2.
// p = 1 + d (or a tree's parameter count) may exceed a warp, so warp 0
// runs the L-BFGS arithmetic with its lanes striding over the coordinates;
// dot products are warp reductions.  The updates whose rounding decides a
// line search or a stall (u + t d, the Armijo threshold) and the map to
// theta are written with explicit roundings, as torch evaluates them.
//
// Spec mode (template SPEC) as K10's.
#include <cuda_pipeline.h>

#include "common.cuh"

#define K11_M 8
#define K11_LS 18
#define K11_STALL 5
#define K11_UCLIP 15.0
#define K11_THREADS 256
#define K11_WARPS (K11_THREADS / 32)
// panel width of the blocked factorization, L^-1 and K^-1
#define K11_NB 16
// 8 x 8 output tiles a warp holds in registers across a barrier, and the
// columns of one such chunk of a 16-row panel
#define K11_MAXT 8
#define K11_CHUNK (K11_WARPS * K11_MAXT / 2 * 8)
// route 1: the staging buffer (doubles) and its shapes: two chunks of
// K11_SYRK_H panel rows (the trailing update), 16 rows of K11_STAGE / 16
// columns (L^-1) or K11_STAGE / 16 rows of 16 columns (K^-1)
#define K11_STAGE 4096
#define K11_SYRK_H (K11_STAGE / (2 * K11_NB))
#define K11_SPAN (K11_STAGE / K11_NB)

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

// Shared doubles of the evaluation besides the matrix: 1 / L_jj of the
// current diagonal block, the block reduction, the pivot flag, ls (d), the
// spec program and alpha (n).
__host__ __device__ inline size_t k11_aux_doubles(int n, int d,
                                                  size_t spec) {
  return K11_NB + K11_WARPS * GPRY_LML_PCHUNK + 1 + (size_t)d + spec +
         (size_t)n;
}

// 0: the packed bordered triangle ((n + 1) (n + 2) / 2 doubles) in shared
// memory; 1: in global memory, with the K11_STAGE staging buffer in shared
// memory; -1: neither fits.  *stage_x: X (d n doubles) in shared
// memory too (the first of the four that fits: route 0 with X, without,
// route 1 with, without); *smem the bytes it takes.
__host__ __device__ inline int k11_route(int n, int d, size_t spec, int p,
                                         int* stage_x, size_t* smem) {
  const size_t base = k11_lane_doubles(p) + k11_aux_doubles(n, d, spec);
  for (int route = 0; route < 2; ++route) {
    const size_t mat =
        route == 0 ? gpry_tri(n + 1) : (size_t)K11_STAGE;
    for (int sx = 1; sx >= 0; --sx) {
      const size_t bytes =
          sizeof(double) * (base + mat + (sx ? (size_t)d * n : 0));
      if (bytes <= GPRY_MAX_SMEM) {
        *stage_x = sx;
        *smem = bytes;
        return route;
      }
    }
  }
  *stage_x = 0;
  *smem = 0;
  return -1;
}

// Global doubles of one lane's workspace: X / ls transposed (d n) and, on
// route 1, the packed bordered triangle.
__host__ __device__ inline size_t k11_work_doubles(int n, int d, int route) {
  return (size_t)d * n + (route == 1 ? gpry_tri(n + 1) : 0);
}

// The evaluation's buffers.
struct K11Eval {
  double* A;     // the packed bordered triangle (shared or global memory)
  double* pan;   // route 1: the staging buffer (K11_STAGE, shared)
  double* dinv;  // K11_NB: 1 / L_jj of the current diagonal block
  double* red;   // K11_WARPS x GPRY_LML_PCHUNK
  int* flag;     // a pivot that is not > 0
  double* ls;    // d
  double* spx;   // the spec program
  double* al;    // alpha (n)
  double* Xt;    // fast families: X / ls transposed (d n), rebuilt per
                 // evaluation, in shared memory if staged, else global
  const double* Xr;  // spec mode: X row-major (staged once, or D.X)
};

__device__ __forceinline__ double* k11_row(double* A, int i) {
  return A + gpry_tri(i);
}

// Factor the diagonal block of the panel at column k0 (nbk <= K11_NB
// columns) in place, by one warp: lane i holds row k0 + i in registers and
// every column step is a broadcast of the pivot and of the new column
// (shuffles); dinv[j] = 1 / L_jj.  Returns (in every lane) whether a pivot
// was not > 0.
__device__ __forceinline__ bool k11_chol_diag(double* A, int k0, int nbk,
                                              double* dinv, int lane) {
  double* Ar = k11_row(A, k0 + lane) + k0;
  const bool mine = lane < nbk;
  double a[K11_NB];
#pragma unroll
  for (int j = 0; j < K11_NB; ++j) a[j] = (mine && j <= lane) ? Ar[j] : 0.0;
  bool bad = false;
#pragma unroll
  for (int j = 0; j < K11_NB; ++j) {
    if (j < nbk) {
      const double piv = __shfl_sync(0xffffffffu, a[j], j);
      bad = bad || !(piv > 0.0);
      const double inv = rsqrt(piv);
      const double ljj = piv * inv;
      // lanes below j: L_ij; lanes above j never read theirs
      const double m = lane == j ? ljj : a[j] * inv;
      a[j] = m;
#pragma unroll
      for (int k = j + 1; k < K11_NB; ++k)
        a[k] -= m * __shfl_sync(0xffffffffu, m, k);
      if (lane == 0) dinv[j] = inv;
    }
  }
  if (mine) {
#pragma unroll
    for (int j = 0; j < K11_NB; ++j)
      if (j <= lane) Ar[j] = a[j];
  }
  return bad;
}

// The panel below the diagonal block: rows [r0, r1) (the border row n
// included), columns k0..k0 + nbk - 1, L_ij = (A_ij - sum_{k<j} L_ik L_jk)
// / L_jj, a thread a row.
__device__ __forceinline__ void k11_trsm(double* A, int k0, int nbk, int r0,
                                         int r1, const double* dinv) {
  for (int i = r0 + (int)threadIdx.x; i < r1; i += blockDim.x) {
    double* Ai = k11_row(A, i) + k0;
    double x[K11_NB];
#pragma unroll
    for (int j = 0; j < K11_NB; ++j) x[j] = j < nbk ? Ai[j] : 0.0;
#pragma unroll
    for (int j = 0; j < K11_NB; ++j) {
      if (j < nbk) {
        const double* Lj = k11_row(A, k0 + j) + k0;
        double s = x[j];
#pragma unroll
        for (int k = 0; k < j; ++k) s -= x[k] * Lj[k];
        x[j] = s * dinv[j];
      }
    }
#pragma unroll
    for (int j = 0; j < K11_NB; ++j)
      if (j < nbk) Ai[j] = x[j];
  }
}

// Tile t of a lower triangle of tiles numbered by rows: (tr, tc), tc <= tr.
__device__ __forceinline__ void k11_tri_tile(int t, int& tr, int& tc) {
  int r = (int)((sqrt(8.0 * t + 1.0) - 1.0) * 0.5);
  while ((r + 1) * (r + 2) / 2 <= t) ++r;
  while (r * (r + 1) / 2 > t) --r;
  tr = r;
  tc = t - r * (r + 1) / 2;
}

// One 16 x 16 block of the trailing update of a panel: C rows r0 + [0, 16)
// by columns c0 + [0, 16) (c0 <= r0), A_rc -= sum_k P_rk P_ck over the
// panel's K11_NB columns, for r <= n (the border row too) and c <=
// min(r, n - 1), as 2 x 2 tiles of 8 x 8: per m8n8k4 step two A and two B
// fragments feed four independent chains.  pr[i] / pc[i]: the panel's row
// r0 + 8 i + g / c0 + 8 i + g (K11_NB doubles), null past row n.
__device__ __forceinline__ void k11_syrk_block(double* A,
                                               const double* const* pr,
                                               const double* const* pc,
                                               int r0, int c0, int n, int g,
                                               int t) {
  double d0[4], d1[4];
  double* Cr[4];
  int cc[4];
  bool v0[4], v1[4];
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    const int rt = r0 + 8 * (q >> 1), ct = c0 + 8 * (q & 1);
    const int ra = rt + g;
    cc[q] = ct + 2 * t;
    const bool live = ct <= rt && ra <= n;
    v0[q] = live && cc[q] <= ra && cc[q] < n;
    v1[q] = live && cc[q] + 1 <= ra && cc[q] + 1 < n;
    Cr[q] = k11_row(A, live ? ra : 0);
    d0[q] = v0[q] ? Cr[q][cc[q]] : 0.0;
    d1[q] = v1[q] ? Cr[q][cc[q] + 1] : 0.0;
  }
#pragma unroll
  for (int kk = 0; kk < K11_NB; kk += 4) {
    const double a0 = pr[0] ? -pr[0][kk + t] : 0.0;
    const double a1 = pr[1] ? -pr[1][kk + t] : 0.0;
    const double e0 = pc[0] ? pc[0][kk + t] : 0.0;
    const double e1 = pc[1] ? pc[1][kk + t] : 0.0;
    gpry_dmma(d0[0], d1[0], a0, e0);
    gpry_dmma(d0[1], d1[1], a0, e1);
    gpry_dmma(d0[2], d1[2], a1, e0);
    gpry_dmma(d0[3], d1[3], a1, e1);
  }
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    if (v0[q]) Cr[q][cc[q]] = d0[q];
    if (v1[q]) Cr[q][cc[q] + 1] = d1[q];
  }
}

// Route 1: rows [r0, r1) x columns [c0, c0 + w) of the packed matrix into
// pan (row r - r0 at (r - r0) ld) by cp.async, zeros above the diagonal;
// the caller synchronizes the block.
__device__ __forceinline__ void k11_stage(double* pan, int ld,
                                          const double* A, int r0, int r1,
                                          int c0, int w) {
  const int total = (r1 - r0) * w;
  for (int e = threadIdx.x; e < total; e += blockDim.x) {
    const int r = e / w, c = e - r * w;
    double* dst = pan + (size_t)r * ld + c;
    if (c0 + c <= r0 + r)
      __pipeline_memcpy_async(dst, A + gpry_tri(r0 + r) + c0 + c,
                              sizeof(double));
    else
      *dst = 0.0;
  }
  __pipeline_commit();
  __pipeline_wait_prior(0);
}

// The trailing update of the panel at k0 (columns k0..k0 + K11_NB - 1) on
// rows and columns from b0 = k0 + K11_NB, in 16 x 16 blocks, warps taking
// them in turn.  Route 0 reads the panel in place; route 1 stages it in
// chunks of K11_SYRK_H rows, a pair of chunks (rows, columns) at a time.
// Ends with a barrier on route 1; route 0's caller places its own.
template <bool GLOB>
__device__ void k11_syrk(const K11Eval& E, int k0, int b0, int n, int warp,
                         int lane) {
  const int g = lane >> 2, t = lane & 3;
  double* A = E.A;
  if (!GLOB) {
    const int TR = (n + 1 - b0 + 7) >> 3, SR = (TR + 1) >> 1;
    const int T = SR * (SR + 1) / 2;
    for (int s2 = warp; s2 < T; s2 += K11_WARPS) {
      int sr, sc;
      k11_tri_tile(s2, sr, sc);
      const int r0 = b0 + 16 * sr, c0 = b0 + 16 * sc;
      const double* pr[2];
      const double* pc[2];
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int ra = r0 + 8 * i + g, cb = c0 + 8 * i + g;
        pr[i] = ra <= n ? k11_row(A, ra) + k0 : nullptr;
        pc[i] = cb <= n ? k11_row(A, cb) + k0 : nullptr;
      }
      k11_syrk_block(A, pr, pc, r0, c0, n, g, t);
    }
    return;
  }
  double* bufr = E.pan;
  double* bufc = E.pan + K11_SYRK_H * K11_NB;
  for (int R0 = b0; R0 <= n; R0 += K11_SYRK_H) {
    const int nr = n + 1 - R0 < K11_SYRK_H ? n + 1 - R0 : K11_SYRK_H;
    const int SRr = (nr + 15) >> 4;
    k11_stage(bufr, K11_NB, A, R0, R0 + nr, k0, K11_NB);
    for (int C0 = b0; C0 <= R0; C0 += K11_SYRK_H) {
      const bool diag = C0 == R0;
      const int nc = diag ? nr : K11_SYRK_H;
      const int SRc = (nc + 15) >> 4;
      if (!diag) k11_stage(bufc, K11_NB, A, C0, C0 + nc, k0, K11_NB);
      __syncthreads();
      const double* cbuf = diag ? bufr : bufc;
      const int T = diag ? SRr * (SRr + 1) / 2 : SRr * SRc;
      for (int s2 = warp; s2 < T; s2 += K11_WARPS) {
        int sr, sc;
        if (diag) {
          k11_tri_tile(s2, sr, sc);
        } else {
          sr = s2 / SRc;
          sc = s2 - sr * SRc;
        }
        const double* pr[2];
        const double* pc[2];
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          const int ra = 16 * sr + 8 * i + g, cb = 16 * sc + 8 * i + g;
          pr[i] = ra < nr ? bufr + ra * K11_NB : nullptr;
          pc[i] = cb < nc ? cbuf + cb * K11_NB : nullptr;
        }
        k11_syrk_block(A, pr, pc, R0 + 16 * sr, C0 + 16 * sc, n, g, t);
      }
      __syncthreads();
    }
  }
}

// The factor of the bordered matrix in place: L (rows < n) and z (row n).
// Returns false (in every thread) if a pivot was not > 0.  Starts after a
// barrier, ends with one.
template <bool GLOB>
__device__ bool k11_cholesky(const K11Eval& E, int n) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  for (int k0 = 0; k0 < n; k0 += K11_NB) {
    const int nbk = n - k0 < K11_NB ? n - k0 : K11_NB;
    if (warp == 0) {
      const bool bad = k11_chol_diag(E.A, k0, nbk, E.dinv, lane);
      if (lane == 0 && bad) *E.flag = 1;
    }
    __syncthreads();
    if (*E.flag) return false;
    k11_trsm(E.A, k0, nbk, k0 + nbk, n + 1, E.dinv);
    __syncthreads();
    if (nbk == K11_NB && k0 + K11_NB < n) {
      k11_syrk<GLOB>(E, k0, k0 + K11_NB, n, warp, lane);
      if (!GLOB) __syncthreads();
    }
  }
  return true;
}

// Invert the diagonal block of rows I0..I0 + nbI - 1 of L in place, by one
// warp: lane r holds row r of the block and, column by column of the
// forward substitution, receives row k of the inverse by shuffles.
__device__ __forceinline__ void k11_inv_diag(double* A, int I0, int nbI,
                                             int lane) {
  const bool mine = lane < nbI;
  double* Ar = k11_row(A, I0 + lane) + I0;
  double l[K11_NB], x[K11_NB];
#pragma unroll
  for (int c = 0; c < K11_NB; ++c) {
    l[c] = (mine && c <= lane) ? Ar[c] : 0.0;
    x[c] = 0.0;
  }
#pragma unroll
  for (int k = 0; k < K11_NB; ++k) {
    if (k < nbI) {
      const double ikk = 1.0 / __shfl_sync(0xffffffffu, l[k], k);
      if (lane == k) {
#pragma unroll
        for (int c = 0; c <= k; ++c)
          x[c] = ((c == k ? 1.0 : 0.0) - x[c]) * ikk;
      }
#pragma unroll
      for (int c = 0; c <= k; ++c) {
        const double xk = __shfl_sync(0xffffffffu, x[c], k);
        if (lane > k) x[c] += l[k] * xk;
      }
    }
  }
  if (mine) {
#pragma unroll
    for (int c = 0; c < K11_NB; ++c)
      if (c <= lane) Ar[c] = x[c];
  }
}

// M = L^-1 in place on rows 0..n-1.  Ends with a barrier.
template <bool GLOB>
__device__ void k11_trtri(const K11Eval& E, int n) {
  const int tid = threadIdx.x, nt = blockDim.x;
  const int lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  double* A = E.A;
  for (int I0 = K11_NB * warp; I0 < n; I0 += K11_NB * K11_WARPS)
    k11_inv_diag(A, I0, n - I0 < K11_NB ? n - I0 : K11_NB, lane);
  __syncthreads();
  for (int I0 = K11_NB; I0 < n; I0 += K11_NB) {
    const int nbI = n - I0 < K11_NB ? n - I0 : K11_NB;
    // P = M_II L_I,<I in place, a thread a column
    for (int c = tid; c < I0; c += nt) {
      double l[K11_NB];
#pragma unroll
      for (int k = 0; k < K11_NB; ++k)
        l[k] = k < nbI ? k11_row(A, I0 + k)[c] : 0.0;
#pragma unroll
      for (int r = 0; r < K11_NB; ++r) {
        if (r < nbI) {
          const double* Mr = k11_row(A, I0 + r) + I0;
          double s = 0.0;
#pragma unroll
          for (int k = 0; k <= r; ++k) s += Mr[k] * l[k];
          k11_row(A, I0 + r)[c] = s;
        }
      }
    }
    __syncthreads();
    // M_I,<I = -P M_<I,<I, chunks of columns from the left: the tiles of a
    // chunk in registers, a barrier, then the writes (later chunks read
    // only columns to their right)
    for (int cs = 0; cs < I0; cs += K11_CHUNK) {
      const int ce = I0 < cs + K11_CHUNK ? I0 : cs + K11_CHUNK;
      const int TC = (ce - cs) >> 3;
      // this warp's tiles: column tiles 2 w, 2 w + 1 (+ 2 K11_WARPS), both
      // tile rows of each, four chains run together over the k the first
      // needs (B is zero above the diagonal of M: the second's two extra
      // steps add nothing)
      double acc[K11_MAXT][2];
#pragma unroll
      for (int s = 0; s < K11_MAXT; ++s) acc[s][0] = acc[s][1] = 0.0;
      bool rin[2];
#pragma unroll
      for (int tr = 0; tr < 2; ++tr) rin[tr] = 8 * tr + g < nbI;
      // route 0 reads P in place over [cs, I0); route 1 stages it K11_SPAN
      // columns at a time (row r at pan[r K11_SPAN])
      for (int kc = cs; kc < I0; kc += GLOB ? K11_SPAN : I0) {
        const int ke = GLOB && kc + K11_SPAN < I0 ? kc + K11_SPAN : I0;
        const int ko = GLOB ? kc : 0;
        if (GLOB) {
          k11_stage(E.pan, K11_SPAN, A, I0, I0 + nbI, kc, ke - kc);
          __syncthreads();
        }
        const double* Pr[2];
#pragma unroll
        for (int tr = 0; tr < 2; ++tr) {
          const int rr = rin[tr] ? 8 * tr + g : 0;  // this lane's panel row
          Pr[tr] =
              GLOB ? E.pan + (size_t)rr * K11_SPAN : k11_row(A, I0 + rr);
        }
#pragma unroll
        for (int m = 0; m < K11_MAXT / 4; ++m) {
          const int ct0 = 2 * warp + 2 * K11_WARPS * m;
          if (ct0 < TC) {
            const bool two = ct0 + 1 < TC;
            const int cb0 = cs + 8 * ct0 + g, cb1 = cb0 + 8;
            for (int k = cs + 8 * ct0 > kc ? cs + 8 * ct0 : kc; k < ke;
                 k += 4) {
              const int kb = k + t;
              const double* Mk = k11_row(A, kb);
              const double a0 = rin[0] ? -Pr[0][kb - ko] : 0.0;
              const double a1 = rin[1] ? -Pr[1][kb - ko] : 0.0;
              const double b0 = kb >= cb0 ? Mk[cb0] : 0.0;
              gpry_dmma(acc[4 * m][0], acc[4 * m][1], a0, b0);
              gpry_dmma(acc[4 * m + 1][0], acc[4 * m + 1][1], a1, b0);
              if (two) {
                const double b1 = kb >= cb1 ? Mk[cb1] : 0.0;
                gpry_dmma(acc[4 * m + 2][0], acc[4 * m + 2][1], a0, b1);
                gpry_dmma(acc[4 * m + 3][0], acc[4 * m + 3][1], a1, b1);
              }
            }
          }
        }
        if (GLOB) __syncthreads();
      }
      __syncthreads();
#pragma unroll
      for (int s = 0; s < K11_MAXT; ++s) {
        const int ct = 2 * warp + 2 * K11_WARPS * (s / 4) + (s / 2) % 2;
        const int rr = 8 * (s % 2) + g;
        if (ct < TC && rr < nbI) {
          double* Mr = k11_row(A, I0 + rr) + cs + 8 * ct + 2 * t;
          Mr[0] = acc[s][0];
          Mr[1] = acc[s][1];
        }
      }
    }
  }
  __syncthreads();
}

// K^-1 = M^T M in place on rows 0..n-1 (M = L^-1), row panels from the
// top: out[r][c] = sum_{k >= r} M_kr M_kc for c <= r reads only rows >= r,
// so a panel's tiles are held in registers across one barrier and then
// overwrite it.  Ends with a barrier.
template <bool GLOB>
__device__ void k11_lauum(const K11Eval& E, int n) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3;
  double* A = E.A;
  for (int I0 = 0; I0 < n; I0 += K11_NB) {
    const int nbI = n - I0 < K11_NB ? n - I0 : K11_NB;
    const int W = I0 + nbI;  // the panel's columns 0..W-1
    for (int cs = 0; cs < W; cs += K11_CHUNK) {
      const int ce = W < cs + K11_CHUNK ? W : cs + K11_CHUNK;
      const int TC = (ce - cs + 7) >> 3;
      // this warp's tiles: column tiles 2 w, 2 w + 1 (+ 2 K11_WARPS), both
      // tile rows, run together over k in [I0, n) (A is zero where k < r,
      // B where k < c); per step two A and two B fragments feed four chains
      double acc[K11_MAXT][2];
#pragma unroll
      for (int s = 0; s < K11_MAXT; ++s) acc[s][0] = acc[s][1] = 0.0;
      const int ra0 = I0 + g, ra1 = I0 + 8 + g;
      // route 0 reads the column panel in place over k in [I0, n); route 1
      // stages it K11_SPAN rows at a time (M[k][I0 + j] at
      // pan[(k - kc) K11_NB + j])
      for (int kc = I0; kc < n; kc += GLOB ? K11_SPAN : n) {
        const int ke = GLOB && kc + K11_SPAN < n ? kc + K11_SPAN : n;
        if (GLOB) {
          k11_stage(E.pan, K11_NB, A, kc, ke, I0, nbI);
          __syncthreads();
        }
#pragma unroll
        for (int m = 0; m < K11_MAXT / 4; ++m) {
          const int ct0 = 2 * warp + 2 * K11_WARPS * m;
          if (ct0 < TC) {
            const int cb0 = cs + 8 * ct0 + g, cb1 = cb0 + 8;
            for (int k = kc; k < ke; k += 4) {
              const int kk = k + t;
              const bool kin = kk < n;
              const double* Mk = k11_row(A, kin ? kk : 0);
              const double* Pk =
                  GLOB ? E.pan + (size_t)(kk - kc) * K11_NB : Mk;
              double a0 = 0.0, a1 = 0.0, b0 = 0.0, b1 = 0.0;
              if (kin) {
                if (kk >= ra0) a0 = GLOB ? Pk[g] : Mk[ra0];
                if (kk >= ra1) a1 = GLOB ? Pk[8 + g] : Mk[ra1];
                if (kk >= cb0) b0 = Mk[cb0];
                if (kk >= cb1) b1 = Mk[cb1];
              }
              gpry_dmma(acc[4 * m][0], acc[4 * m][1], a0, b0);
              gpry_dmma(acc[4 * m + 1][0], acc[4 * m + 1][1], a1, b0);
              gpry_dmma(acc[4 * m + 2][0], acc[4 * m + 2][1], a0, b1);
              gpry_dmma(acc[4 * m + 3][0], acc[4 * m + 3][1], a1, b1);
            }
          }
        }
        if (GLOB) __syncthreads();
      }
      __syncthreads();
#pragma unroll
      for (int s = 0; s < K11_MAXT; ++s) {
        const int ct = 2 * warp + 2 * K11_WARPS * (s / 4) + (s / 2) % 2;
        const int r = I0 + 8 * (s % 2) + g, c = cs + 8 * ct + 2 * t;
        if (ct < TC && r < n) {
          double* Mr = k11_row(A, r);
          if (c <= r && c < ce) Mr[c] = acc[s][0];
          if (c + 1 <= r && c + 1 < ce) Mr[c + 1] = acc[s][1];
        }
      }
    }
  }
  __syncthreads();
}

// The LML of theta (p entries, visible to the block) on the data D, the
// factor left in E.A (rows < n: L, row n: z), returned in every thread;
// NaN if K is not positive definite.  Every thread calls it; it starts and
// ends with a block barrier.
template <bool SPEC, bool GLOB>
__device__ double k11_value(const GpryKern& kern, const GpryLmlData& D,
                            const double* theta, const K11Eval& E,
                            GprySpec* spec) {
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int nt = blockDim.x, nw = nt >> 5;
  const int n = D.n, d = D.d;
  double* A = E.A;
  __syncthreads();
  if constexpr (SPEC)
    *spec = gpry_stage_spec(E.spx, kern, theta, tid, nt);
  else
    for (int k = tid; k < d; k += nt) E.ls[k] = exp(theta[1 + k]);
  if (tid == 0) *E.flag = 0;
  const double variance = exp(theta[0]);
  const double jitter = D.rel_jitter * variance;
  __syncthreads();
  if constexpr (!SPEC) {
    for (int idx = tid; idx < n * d; idx += nt) {
      const int j = idx / d, k = idx - j * d;
      E.Xt[(size_t)k * n + j] = D.X[idx] / E.ls[k];
    }
    __syncthreads();
  }
  // the bordered lower triangle: K (rows < n), y (row n); two pairs a lane
  // at a time (independent chains)
  constexpr int H = 2;
  for (int a = warp; a <= n; a += nw) {
    const int bmax = a < n ? a : n - 1;
    double* Aa = k11_row(A, a);
    for (int b0 = lane; b0 <= bmax; b0 += 32 * H) {
#pragma unroll
    for (int h = 0; h < H; ++h) {
      const int b = b0 + 32 * h;
      if (b > bmax) continue;
      double v;
      if (a == n) {
        v = D.y[b];
      } else if (a == b) {
        const double kd =
            SPEC ? gpry_spec_diag(*spec, E.Xr + (size_t)a * d, 1, d)
                 : variance;
        const double nz = D.noise_is_vec ? D.noise[a] : D.noise[0];
        v = kd + (nz + jitter);
      } else if constexpr (SPEC) {
        v = gpry_spec_cov(*spec, E.Xr + (size_t)a * d, 1,
                          E.Xr + (size_t)b * d, 1, d);
      } else {
        double sq = 0.0;
#pragma unroll 4
        for (int k = 0; k < d; ++k) {
          const double df =
              E.Xt[(size_t)k * n + a] - E.Xt[(size_t)k * n + b];
          sq += df * df;
        }
        v = variance * gpry_k_of_sq(kern.family, sq);
      }
      Aa[b] = v;
    }
    }
  }
  __syncthreads();
  if (!k11_cholesky<GLOB>(E, n)) return NAN;
  // log det and z^T z
  double ld = 0.0, qq = 0.0;
  const double* z = k11_row(A, n);
  for (int k = tid; k < n; k += nt) {
    ld += log(k11_row(A, k)[k]);
    qq += z[k] * z[k];
  }
  ld = gpry_warp_sum(ld);
  qq = gpry_warp_sum(qq);
  if (lane == 0) {
    E.red[2 * warp] = ld;
    E.red[2 * warp + 1] = qq;
  }
  __syncthreads();
  ld = qq = 0.0;
  for (int w = 0; w < nw; ++w) {
    ld += E.red[2 * w];
    qq += E.red[2 * w + 1];
  }
  __syncthreads();
  return (-0.5 * qq - ld) - (0.5 * n) * GPRY_LOG_2PI;
}

// The p derivatives of the LML into grad (any memory), from the factor
// k11_value left at theta.  Every thread calls it; it ends with a barrier.
template <bool SPEC, bool GLOB>
__device__ void k11_grad(const GpryKern& kern, const GpryLmlData& D,
                         const double* theta, const K11Eval& E,
                         const GprySpec& spec, double* grad) {
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int nt = blockDim.x, nw = nt >> 5;
  const int n = D.n, d = D.d, p = kern.ntheta;
  double* A = E.A;
  const double variance = exp(theta[0]);
  const double jitter = D.rel_jitter * variance;
  k11_trtri<GLOB>(E, n);
  // alpha = M^T z
  const double* z = k11_row(A, n);
  for (int a = tid; a < n; a += nt) {
    double s = 0.0;
    for (int c = a; c < n; ++c) s += k11_row(A, c)[a] * z[c];
    E.al[a] = s;
  }
  __syncthreads();
  k11_lauum<GLOB>(E, n);
  // the contraction, GPRY_LML_PCHUNK parameters a pass
  const double* Xt = E.Xt;
  constexpr int H = 2;
  for (int j0 = 0; j0 < p; j0 += GPRY_LML_PCHUNK) {
    double acc[GPRY_LML_PCHUNK];
#pragma unroll
    for (int c = 0; c < GPRY_LML_PCHUNK; ++c) acc[c] = 0.0;
    for (int a = warp; a < n; a += nw) {
      const double* Ka = k11_row(A, a);
      // two pairs a lane at a time (independent chains)
      for (int b0 = lane; b0 <= a; b0 += 32 * H) {
#pragma unroll
      for (int h = 0; h < H; ++h) {
        const int b = b0 + 32 * h;
        if (b > a) continue;
        const double w =
            (a == b ? 0.5 : 1.0) * (E.al[a] * E.al[b] - Ka[b]);
        if constexpr (SPEC) {
          double tg[GPRY_LML_PCHUNK];
          gpry_spec_dtheta(spec, E.Xr + (size_t)a * d, 1,
                           E.Xr + (size_t)b * d, 1, d, a == b, j0, tg);
          if (a == b && j0 == 0) tg[0] += jitter;
#pragma unroll
          for (int c = 0; c < GPRY_LML_PCHUNK; ++c) acc[c] += w * tg[c];
        } else {
          // the tangents of the pair (unrolled: acc stays in registers)
          double sq = 0.0, kv = 1.0, dks = 0.0;
          if (a != b) {
#pragma unroll 4
            for (int k = 0; k < d; ++k) {
              const double df = Xt[(size_t)k * n + a] - Xt[(size_t)k * n + b];
              sq += df * df;
            }
            gpry_k_dk_of_sq(kern.family, sq, &kv, &dks);
          }
          const double dk = variance * dks;
#pragma unroll
          for (int c = 0; c < GPRY_LML_PCHUNK; ++c) {
            const int j = j0 + c;
            if (j == 0) {
              acc[c] += w * (a == b ? variance + jitter : variance * kv);
            } else if (j <= d) {
              const double df =
                  Xt[(size_t)(j - 1) * n + a] - Xt[(size_t)(j - 1) * n + b];
              acc[c] += w * (dk * (-2.0 * df * df));
            }
          }
        }
      }
      }
    }
#pragma unroll
    for (int c = 0; c < GPRY_LML_PCHUNK; ++c) {
      const double s = gpry_warp_sum(acc[c]);
      if (lane == 0) E.red[warp * GPRY_LML_PCHUNK + c] = s;
    }
    __syncthreads();
    if (tid < GPRY_LML_PCHUNK && j0 + tid < p) {
      double s = 0.0;
      for (int w = 0; w < nw; ++w) s += E.red[w * GPRY_LML_PCHUNK + tid];
      grad[j0 + tid] = s;
    }
    __syncthreads();
  }
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
__global__ void __launch_bounds__(K11_THREADS, 1) lbfgs_lml_fit_kernel(
    GpryKern kern, int R, GpryLmlData D, int stage_x, int maxiter,
    const double* __restrict__ theta0s, const double* __restrict__ lo_g,
    const double* __restrict__ hi_g, double* __restrict__ work,
    size_t work_per_block, double* __restrict__ th_out,
    double* __restrict__ f_out, long long* __restrict__ nev_out,
    long long* __restrict__ it_out) {
  extern __shared__ double smem[];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int nt = blockDim.x;
  const int r = blockIdx.x, p = kern.ntheta, n = D.n, d = D.d;
  double* wk = work + (size_t)r * work_per_block;
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
  K11Eval E;
  E.dinv = smem + k11_lane_doubles(p);
  E.red = E.dinv + K11_NB;
  E.flag = (int*)(E.red + K11_WARPS * GPRY_LML_PCHUNK);
  E.ls = E.red + K11_WARPS * GPRY_LML_PCHUNK + 1;
  E.spx = E.ls + d;
  E.al = E.spx + gpry_spec_doubles(kern);
  double* tail;
  if (GLOB) {
    E.pan = E.al + n;
    E.A = wk + (size_t)d * n;
    tail = E.pan + K11_STAGE;
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
    const double F = -k11_value<SPEC, GLOB>(kern, D, ln.th, E, &spec);
    // a lane that starts non-finite stops at once: its g is never read
    if (isfinite(F)) {
      k11_grad<SPEC, GLOB>(kern, D, ln.th, E, spec, ln.gl);
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
      const double Ft = -k11_value<SPEC, GLOB>(kern, D, ln.th, E, &spec);
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
      k11_grad<SPEC, GLOB>(kern, D, ln.th, E, spec, ln.gl);
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
    th_out[(size_t)r * p + k] = __dadd_rn(ln.lo[k], __dmul_rn(ln.A[k], s));
  }
  if (tid == 0) {
    f_out[r] = bad ? st->f0 : st->f;
    nev_out[r] = st->nev;
    it_out[r] = st->iters;
  }
}

// The route (0: shared, 1: global, -1: n too large), whether X is staged
// too, the shared memory (bytes) and the global workspace of one lane
// (doubles) it takes.
extern "C" int gpry_lbfgs_lml_fit_plan(GpryKern kern, int n, int d,
                                       int* stage_x, size_t* smem,
                                       size_t* work) {
  const int route =
      k11_route(n, d, gpry_spec_doubles(kern), kern.ntheta, stage_x, smem);
  *work = route < 0 ? 0 : k11_work_doubles(n, d, route);
  return route;
}

// theta0s (R, kern.ntheta) inside [lo, hi]; X (>= n rows, d); y (>= n);
// noise one value or one per row; work R x the plan's workspace doubles.
// Outputs: theta (R, kern.ntheta), -lml (R), nev and iterations (R,
// int64).
extern "C" int gpry_lbfgs_lml_fit(GpryKern kern, int R, int n, int d,
                                  int maxiter, const void* theta0s,
                                  const void* lo, const void* hi,
                                  const void* X, const void* y,
                                  const void* noise, int noise_is_vec,
                                  double rel_jitter, void* work,
                                  void* th_out, void* f_out, void* nev_out,
                                  void* it_out, void* stream) {
  if (R < 0 || n < 0) return (int)cudaErrorInvalidValue;
  if (R == 0) return 0;
  int stage_x;
  size_t smem, wpb;
  const int route = gpry_lbfgs_lml_fit_plan(kern, n, d, &stage_x, &smem,
                                            &wpb);
  if (route < 0) return (int)cudaErrorInvalidConfiguration;
  auto kernel =
      kern.nodes ? (route ? lbfgs_lml_fit_kernel<true, true>
                          : lbfgs_lml_fit_kernel<true, false>)
                 : (route ? lbfgs_lml_fit_kernel<false, true>
                          : lbfgs_lml_fit_kernel<false, false>);
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
  kernel<<<R, K11_THREADS, smem, (cudaStream_t)stream>>>(
      kern, R, D, stage_x, maxiter, (const double*)theta0s,
      (const double*)lo,
      (const double*)hi, (double*)work, wpb, (double*)th_out,
      (double*)f_out, (long long*)nev_out, (long long*)it_out);
  return (int)cudaGetLastError();
}
