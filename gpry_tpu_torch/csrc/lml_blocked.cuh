// The log marginal likelihood of the valid block and its theta-gradient
// by one block of LML_THREADS, blocked for the H100's FP64 tensor cores:
// the evaluation that K10 (lml_value_grad.cu, a block per theta row) and
// K11 (lbfgs_lml_fit.cu, a block per restart lane) share.  It computes
// gpry_tpu/ops/linalg.py:139 masked_lml,
//
//   lml = -1/2 z^T z - sum_i log L_ii - n/2 log 2 pi,   L L^T = K,  L z = y,
//   d lml / d theta_j = 1/2 sum_ab (alpha alpha^T - K^-1)_ab dK_ab/dtheta_j,
//
// with K = k(X, X) on the n x n valid block, its diagonal the same-point
// covariance plus noise_i + rel_jitter exp(theta_0) (the padding is the
// identity with y = 0: it adds nothing).
//
// * lml_value: the bordered matrix [[K, .], [y^T, .]] (packed lower
//   triangle by rows, y as row n; the pair build two pairs a lane at a
//   time, independent chains) is factored blocked and right-looking
//   (lml_cholesky), in panels of LML_NB = 16 columns: one warp factors the
//   16 x 16 diagonal block in registers (shuffles, no block barrier;
//   lml_chol_diag), a thread a row solves the panel below it (lml_trsm),
//   and the trailing update runs on the FP64 tensor cores (lml_syrk,
//   mma.sync m8n8k4 through gpry_dmma; a warp takes 2 x 2 blocks of 8 x 8
//   tiles, two A and two B fragments a step feeding four chains): three
//   barriers a panel instead of one a column.  Row n comes out as z.  A
//   pivot that is not > 0 (or NaN) makes the value NaN, as cholesky_nan
//   does.  The factor stays in place for lml_grad.
// * lml_grad forms K^-1 once: M = L^-1 in place (lml_trtri: the diagonal
//   blocks inverted by a warp each in registers, then each 16-row panel
//   M_I,<I = -(M_II L_I,<I) M_<I,<I with the product on the tensor cores,
//   the tiles held in registers across one barrier before they overwrite
//   their inputs), alpha = M^T z, K^-1 = M^T M in place (lml_lauum: row
//   panels from the top, on the tensor cores, the same register trick),
//   then one pass over the pairs reads K^-1_ab and the pair's tangents
//   (the fast families from the pair's squared distance, one exponential a
//   pair, two pairs a lane; spec mode the interpreter's gpry_spec_dtheta),
//   GPRY_LML_PCHUNK parameters a pass.
// * Routes (lml_route): 0 keeps the packed triangle in shared memory; 1
//   keeps it in the lane's global workspace, with the operands of each
//   tensor-core step staged by cp.async in a shared buffer of fixed size
//   (LML_STAGE doubles: two chunks of 128 rows of the panel for the
//   trailing update, 256 columns of the row panel for L^-1, 256 rows of
//   the column panel for K^-1), so that shared memory grows with n only by
//   alpha.  X (d n doubles) goes to shared memory too where it fits: the
//   pair build and the contraction read it for every pair, and from global
//   memory each of those reads waits on L2.
// * Route 1 runs on a thread-block cluster of E.C blocks (1, 2, 4, 8 or
//   16; the kernels' plans choose it), one lane or row a cluster, so that
//   C SMs feed one triangle instead of one.  Every phase deals its work
//   over the cluster's warps (or threads) and ends with a cluster barrier
//   (lml_sync) where one block's barrier stood: the pair build and the
//   contraction by rows, the panel solve by rows, the trailing update by
//   pairs of 64-row chunks (pair q to block q mod C), L^-1's and K^-1's
//   8 x 8 column tiles by pairs (pair q to block q mod C, then warp q / C
//   mod 8), the diagonal blocks of L^-1 and the entries of alpha by
//   index.  Each block factors the panel's 16 x 16 diagonal block itself
//   (one warp, in registers, the same bits in every block) into its own
//   shared memory, so the panel solve needs no barrier besides its own
//   block's; rank 0 writes it back after the next cluster barrier.  The
//   reductions (log det, z^T z, the gradient) add the blocks' warp sums
//   read through distributed shared memory in one fixed order (rank, then
//   warp), so every block holds the same bits and the result does not
//   depend on scheduling; alpha is pushed to every block's copy.  An
//   evaluation starts with a cluster barrier and a failed pivot ends the
//   factor with one, so that no block writes the next evaluation's
//   triangle while another still reads this one's.  Each
//   output tile is computed by one warp with the same arithmetic as on
//   one block, so the factor, L^-1 and K^-1 are the one-block route's bit
//   for bit; only the sums' order differs with C.
//
// Spec mode (template SPEC): the interpreter of common.cuh builds K; the
// gradient is its forward mode in theta (gpry_spec_dtheta).
#pragma once

#include <cuda_pipeline.h>

#include <utility>

#include "common.cuh"

#define LML_THREADS 256
#define LML_WARPS (LML_THREADS / 32)
// panel width of the blocked factorization, L^-1 and K^-1
#define LML_NB 16
// 8 x 8 output tiles a warp holds in registers across a barrier, and the
// columns of one such chunk of a 16-row panel
#define LML_MAXT 8
#define LML_CHUNK (LML_WARPS * LML_MAXT / 2 * 8)
// route 1: the staging buffer (doubles) and its shapes: two chunks of
// LML_SYRK_H panel rows (the trailing update; half as many on a cluster,
// so that a panel's update has four times the chunk pairs to deal), 16
// rows of LML_STAGE / 16 columns (L^-1) or LML_STAGE / 16 rows of 16
// columns (K^-1); it also holds a block's factored diagonal block
#define LML_STAGE 4096
#define LML_SYRK_H (LML_STAGE / (2 * LML_NB))
#define LML_SPAN (LML_STAGE / LML_NB)
// the largest cluster of route 1 (the non-portable size above 8)
#define LML_MAX_CLUSTER 16

// Shared doubles of the evaluation besides the matrix: 1 / L_jj of the
// current diagonal block, the block reduction, the pivot flag, ls (d), the
// spec program and alpha (n).
__host__ __device__ inline size_t lml_aux_doubles(int n, int d,
                                                  size_t spec) {
  return LML_NB + LML_WARPS * GPRY_LML_PCHUNK + 1 + (size_t)d + spec +
         (size_t)n;
}

// Whether the evaluation fits a block's shared memory on `route` (0: the
// packed bordered triangle, (n + 1) (n + 2) / 2 doubles, in shared memory;
// 1: in global memory, with the LML_STAGE staging buffer in shared
// memory), with `extra` shared doubles of the kernel's own (K11's lane
// state; 0 for K10); *stage_x: X (d n doubles) in shared memory too where
// that fits as well; *smem the bytes it takes.
__host__ __device__ inline bool lml_route_fits(int n, int d, size_t spec,
                                               size_t extra, int route,
                                               int* stage_x, size_t* smem) {
  const size_t base = extra + lml_aux_doubles(n, d, spec);
  const size_t mat = route == 0 ? gpry_tri(n + 1) : (size_t)LML_STAGE;
  for (int sx = 1; sx >= 0; --sx) {
    const size_t bytes =
        sizeof(double) * (base + mat + (sx ? (size_t)d * n : 0));
    if (bytes <= GPRY_MAX_SMEM) {
      *stage_x = sx;
      *smem = bytes;
      return true;
    }
  }
  *stage_x = 0;
  *smem = 0;
  return false;
}

// The first route that fits (0, then 1; -1: neither), as lml_route_fits.
__host__ __device__ inline int lml_route(int n, int d, size_t spec,
                                         size_t extra, int* stage_x,
                                         size_t* smem) {
  for (int route = 0; route < 2; ++route)
    if (lml_route_fits(n, d, spec, extra, route, stage_x, smem))
      return route;
  return -1;
}

// Global doubles of one block's workspace: X / ls transposed (d n) and, on
// route 1, the packed bordered triangle.
__host__ __device__ inline size_t lml_work_doubles(int n, int d, int route) {
  return (size_t)d * n + (route == 1 ? gpry_tri(n + 1) : 0);
}


// The cluster of route 1 for `rows` lanes or rows in flight on `sms` SMs,
// with act[i] the clusters of 2^i blocks the card runs at once (i = 0..4,
// lml_actives): of the powers of two C up to LML_MAX_CLUSTER with rows x C
// <= sms (and 1), the one that gives a lane the most blocks per wave of
// resident clusters, C / ceil(rows / act[log2 C]), the larger C on a tie:
// a lane that waits for a second wave starts as soon as a lane of the
// first ends, so a tie favours the larger clusters (ops/fused.py
// lml_cluster).  On an H100 (7 clusters of 16 resident, 15 of 8) a full
// fit's 8 lanes take 16 blocks each.
__host__ __device__ inline int lml_cluster(int rows, int sms,
                                           const int* act) {
  int top = 0;
  while ((1 << top) < LML_MAX_CLUSTER &&
         (long long)rows * (2 << top) <= sms)
    ++top;
  int best = 1;
  long long waves = 0;  // the best's waves (0: none yet)
  for (int i = top; i >= 0; --i) {
    if (act[i] < 1) continue;
    const long long w = (rows + act[i] - 1) / act[i];
    if (waves == 0 || (long long)(1 << i) * waves > (long long)best * w) {
      best = 1 << i;
      waves = w;
    }
  }
  return best;
}

// The evaluation's buffers.
struct LmlEval {
  int rank, C;   // route 1: this block's rank in the lane's cluster, and
                 // the cluster's blocks (route 0: 0 and 1)
  int xs;        // X (or X / ls) staged in this block's shared memory
  double* A;     // the packed bordered triangle (shared or global memory)
  double* pan;   // route 1: the staging buffer (LML_STAGE, shared)
  double* dinv;  // LML_NB: 1 / L_jj of the current diagonal block
  double* red;   // LML_WARPS x GPRY_LML_PCHUNK
  int* flag;     // a pivot that is not > 0
  double* ls;    // d
  double* spx;   // the spec program
  double* al;    // alpha (n)
  double* Xt;    // fast families: X / ls transposed (d n), rebuilt per
                 // evaluation, in shared memory if staged, else global
  const double* Xr;  // spec mode: X row-major (staged once, or D.X)
};

__device__ __forceinline__ double* lml_row(double* A, int i) {
  return A + gpry_tri(i);
}

// The blocks working on one lane: E.C on route 1, one on route 0.
template <bool GLOB>
__device__ __forceinline__ int lml_C(const LmlEval& E) {
  return GLOB ? E.C : 1;
}

template <bool GLOB>
__device__ __forceinline__ int lml_rank(const LmlEval& E) {
  return GLOB ? E.rank : 0;
}

// The barrier of the blocks working on one lane: the cluster's on route 1
// with C > 1 (barrier.cluster arrive.release / wait.acquire: global and
// shared writes before it are visible to the cluster after it), else the
// block's.
template <bool GLOB>
__device__ __forceinline__ void lml_sync(const LmlEval& E) {
  if (GLOB && E.C > 1)
    cooperative_groups::this_cluster().sync();
  else
    __syncthreads();
}

// Block r's copy of a shared buffer of this block's (distributed shared
// memory on a cluster).
template <bool GLOB, typename T>
__device__ __forceinline__ T* lml_remote(const LmlEval& E, T* p, int r) {
  if (GLOB && E.C > 1)
    return cooperative_groups::this_cluster().map_shared_rank(p, r);
  return p;
}

// Factor the diagonal block of the panel at column k0 (nbk <= LML_NB
// columns), by one warp: lane i holds row k0 + i in registers and every
// column step is a broadcast of the pivot and of the new column
// (shuffles); dinv[j] = 1 / L_jj.  The factor goes back in place when
// `inplace`, and to dblk (row i at dblk + LML_NB i) when not null.
// Returns (in every lane) whether a pivot was not > 0.
__device__ __forceinline__ bool lml_chol_diag(double* A, int k0, int nbk,
                                              double* dinv, int lane,
                                              bool inplace = true,
                                              double* dblk = nullptr) {
  double* Ar = lml_row(A, k0 + lane) + k0;
  const bool mine = lane < nbk;
  double a[LML_NB];
#pragma unroll
  for (int j = 0; j < LML_NB; ++j) a[j] = (mine && j <= lane) ? Ar[j] : 0.0;
  bool bad = false;
#pragma unroll
  for (int j = 0; j < LML_NB; ++j) {
    if (j < nbk) {
      const double piv = __shfl_sync(0xffffffffu, a[j], j);
      bad = bad || !(piv > 0.0);
      const double inv = rsqrt(piv);
      const double ljj = piv * inv;
      // lanes below j: L_ij; lanes above j never read theirs
      const double m = lane == j ? ljj : a[j] * inv;
      a[j] = m;
#pragma unroll
      for (int k = j + 1; k < LML_NB; ++k)
        a[k] -= m * __shfl_sync(0xffffffffu, m, k);
      if (lane == 0) dinv[j] = inv;
    }
  }
  if (mine) {
#pragma unroll
    for (int j = 0; j < LML_NB; ++j) {
      if (j <= lane) {
        if (inplace) Ar[j] = a[j];
        if (dblk) dblk[LML_NB * lane + j] = a[j];
      }
    }
  }
  return bad;
}

// The panel below the diagonal block: rows [r0, r1) (the border row n
// included), columns k0..k0 + nbk - 1, L_ij = (A_ij - sum_{k<j} L_ik L_jk)
// / L_jj, a thread a row (thread t0 of nt over the lane's blocks); the
// diagonal block's L read in place, or from dblk when not null.
__device__ __forceinline__ void lml_trsm(double* A, int k0, int nbk, int r0,
                                         int r1, const double* dinv,
                                         int t0, int nt,
                                         const double* dblk = nullptr) {
  for (int i = r0 + t0; i < r1; i += nt) {
    double* Ai = lml_row(A, i) + k0;
    double x[LML_NB];
#pragma unroll
    for (int j = 0; j < LML_NB; ++j) x[j] = j < nbk ? Ai[j] : 0.0;
#pragma unroll
    for (int j = 0; j < LML_NB; ++j) {
      if (j < nbk) {
        const double* Lj = dblk ? dblk + LML_NB * j : lml_row(A, k0 + j) + k0;
        double s = x[j];
#pragma unroll
        for (int k = 0; k < j; ++k) s -= x[k] * Lj[k];
        x[j] = s * dinv[j];
      }
    }
#pragma unroll
    for (int j = 0; j < LML_NB; ++j)
      if (j < nbk) Ai[j] = x[j];
  }
}

// Tile t of a lower triangle of tiles numbered by rows: (tr, tc), tc <= tr.
__device__ __forceinline__ void lml_tri_tile(int t, int& tr, int& tc) {
  int r = (int)((sqrt(8.0 * t + 1.0) - 1.0) * 0.5);
  while ((r + 1) * (r + 2) / 2 <= t) ++r;
  while (r * (r + 1) / 2 > t) --r;
  tr = r;
  tc = t - r * (r + 1) / 2;
}

// One 16 x 16 block of the trailing update of a panel: C rows r0 + [0, 16)
// by columns c0 + [0, 16) (c0 <= r0), A_rc -= sum_k P_rk P_ck over the
// panel's LML_NB columns, for r <= n (the border row too) and c <=
// min(r, n - 1), as 2 x 2 tiles of 8 x 8: per m8n8k4 step two A and two B
// fragments feed four independent chains.  pr[i] / pc[i]: the panel's row
// r0 + 8 i + g / c0 + 8 i + g (LML_NB doubles), null past row n.
__device__ __forceinline__ void lml_syrk_block(double* A,
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
    Cr[q] = lml_row(A, live ? ra : 0);
    d0[q] = v0[q] ? Cr[q][cc[q]] : 0.0;
    d1[q] = v1[q] ? Cr[q][cc[q] + 1] : 0.0;
  }
#pragma unroll
  for (int kk = 0; kk < LML_NB; kk += 4) {
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
__device__ __forceinline__ void lml_stage(double* pan, int ld,
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

// The trailing update of the panel at k0 (columns k0..k0 + LML_NB - 1) on
// rows and columns from b0 = k0 + LML_NB, in 16 x 16 blocks, warps taking
// them in turn.  Route 0 reads the panel in place; route 1 stages it in
// chunks of H rows (LML_SYRK_H on one block, half that on a cluster), a
// pair of chunks (rows, columns) at a time, pair q (numbered by rows) on
// block q mod C.  On route 1 a block that took a pair ends with a barrier
// of its own; the caller places the lane's.
template <bool GLOB>
__device__ void lml_syrk(const LmlEval& E, int k0, int b0, int n, int warp,
                         int lane) {
  const int g = lane >> 2, t = lane & 3;
  double* A = E.A;
  if (!GLOB) {
    const int TR = (n + 1 - b0 + 7) >> 3, SR = (TR + 1) >> 1;
    const int T = SR * (SR + 1) / 2;
    for (int s2 = warp; s2 < T; s2 += LML_WARPS) {
      int sr, sc;
      lml_tri_tile(s2, sr, sc);
      const int r0 = b0 + 16 * sr, c0 = b0 + 16 * sc;
      const double* pr[2];
      const double* pc[2];
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int ra = r0 + 8 * i + g, cb = c0 + 8 * i + g;
        pr[i] = ra <= n ? lml_row(A, ra) + k0 : nullptr;
        pc[i] = cb <= n ? lml_row(A, cb) + k0 : nullptr;
      }
      lml_syrk_block(A, pr, pc, r0, c0, n, g, t);
    }
    return;
  }
  double* bufr = E.pan;
  double* bufc = E.pan + LML_SYRK_H * LML_NB;
  const int C = E.C, rank = E.rank;
  const int H = C > 1 ? LML_SYRK_H / 2 : LML_SYRK_H;
  int q = 0, staged = -1;
  for (int R0 = b0; R0 <= n; R0 += H) {
    const int nr = n + 1 - R0 < H ? n + 1 - R0 : H;
    const int SRr = (nr + 15) >> 4;
    for (int C0 = b0; C0 <= R0; C0 += H, ++q) {
      if (q % C != rank) continue;
      if (staged != R0) {
        lml_stage(bufr, LML_NB, A, R0, R0 + nr, k0, LML_NB);
        staged = R0;
      }
      const bool diag = C0 == R0;
      const int nc = diag ? nr : H;
      const int SRc = (nc + 15) >> 4;
      if (!diag) lml_stage(bufc, LML_NB, A, C0, C0 + nc, k0, LML_NB);
      __syncthreads();
      const double* cbuf = diag ? bufr : bufc;
      const int T = diag ? SRr * (SRr + 1) / 2 : SRr * SRc;
      for (int s2 = warp; s2 < T; s2 += LML_WARPS) {
        int sr, sc;
        if (diag) {
          lml_tri_tile(s2, sr, sc);
        } else {
          sr = s2 / SRc;
          sc = s2 - sr * SRc;
        }
        const double* pr[2];
        const double* pc[2];
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          const int ra = 16 * sr + 8 * i + g, cb = 16 * sc + 8 * i + g;
          pr[i] = ra < nr ? bufr + ra * LML_NB : nullptr;
          pc[i] = cb < nc ? cbuf + cb * LML_NB : nullptr;
        }
        lml_syrk_block(A, pr, pc, R0 + 16 * sr, C0 + 16 * sc, n, g, t);
      }
      __syncthreads();
    }
  }
}

// The factor of the bordered matrix in place: L (rows < n) and z (row n).
// Returns false (in every thread of the lane's blocks) if a pivot was not
// > 0.  Starts after a barrier of the lane's blocks, ends with one.
template <bool GLOB>
__device__ bool lml_cholesky(const LmlEval& E, int n) {
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int nt = blockDim.x;
  const int C = lml_C<GLOB>(E), rank = lml_rank<GLOB>(E);
  // on a cluster every block factors the diagonal block into its own
  // staging buffer (the trsm reads it there), and rank 0 writes it back
  // once every block has read the block's old entries
  double* dblk = GLOB ? E.pan : nullptr;
  for (int k0 = 0; k0 < n; k0 += LML_NB) {
    const int nbk = n - k0 < LML_NB ? n - k0 : LML_NB;
    if (warp == 0) {
      const bool bad =
          lml_chol_diag(E.A, k0, nbk, E.dinv, lane, C == 1, dblk);
      if (lane == 0 && bad) *E.flag = 1;
    }
    __syncthreads();
    // a failed pivot ends the factor in every block alike; the lane's
    // barrier keeps a block that leaves first from writing the next
    // evaluation's triangle while another still reads this diagonal block
    if (*E.flag) {
      if (GLOB) lml_sync<GLOB>(E);
      return false;
    }
    lml_trsm(E.A, k0, nbk, k0 + nbk, n + 1, E.dinv, rank * nt + tid, C * nt,
             dblk);
    lml_sync<GLOB>(E);
    if (C > 1 && rank == 0) {
      for (int e = tid; e < LML_NB * LML_NB; e += nt) {
        const int i = e / LML_NB, j = e - i * LML_NB;
        if (i < nbk && j <= i) lml_row(E.A, k0 + i)[k0 + j] = dblk[e];
      }
      __syncthreads();
    }
    if (nbk == LML_NB && k0 + LML_NB < n) {
      lml_syrk<GLOB>(E, k0, k0 + LML_NB, n, warp, lane);
      if (!GLOB || C > 1) lml_sync<GLOB>(E);
    } else if (C > 1) {
      lml_sync<GLOB>(E);
    }
  }
  return true;
}

// Invert the diagonal block of rows I0..I0 + nbI - 1 of L in place, by one
// warp: lane r holds row r of the block and, column by column of the
// forward substitution, receives row k of the inverse by shuffles.
__device__ __forceinline__ void lml_inv_diag(double* A, int I0, int nbI,
                                             int lane) {
  const bool mine = lane < nbI;
  double* Ar = lml_row(A, I0 + lane) + I0;
  double l[LML_NB], x[LML_NB];
#pragma unroll
  for (int c = 0; c < LML_NB; ++c) {
    l[c] = (mine && c <= lane) ? Ar[c] : 0.0;
    x[c] = 0.0;
  }
#pragma unroll
  for (int k = 0; k < LML_NB; ++k) {
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
    for (int c = 0; c < LML_NB; ++c)
      if (c <= lane) Ar[c] = x[c];
  }
}

// M = L^-1 in place on rows 0..n-1.  Ends with a barrier of the lane's
// blocks.  The column tiles of a row panel go in pairs: pair q (columns
// 16 q + [0, 16) of the chunk) to block q mod C, warp q / C mod 8; on one
// block, warp w takes pairs w, w + 8.
template <bool GLOB>
__device__ void lml_trtri(const LmlEval& E, int n) {
  const int tid = threadIdx.x, nt = blockDim.x;
  const int lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int C = lml_C<GLOB>(E), rank = lml_rank<GLOB>(E);
  const int NW = C * LML_WARPS;
  const int chunk = C * LML_CHUNK;
  double* A = E.A;
  for (int I0 = LML_NB * (rank * LML_WARPS + warp); I0 < n;
       I0 += LML_NB * NW)
    lml_inv_diag(A, I0, n - I0 < LML_NB ? n - I0 : LML_NB, lane);
  lml_sync<GLOB>(E);
  for (int I0 = LML_NB; I0 < n; I0 += LML_NB) {
    const int nbI = n - I0 < LML_NB ? n - I0 : LML_NB;
    // P = M_II L_I,<I in place, a thread a column
    for (int c = rank * nt + tid; c < I0; c += C * nt) {
      double l[LML_NB];
#pragma unroll
      for (int k = 0; k < LML_NB; ++k)
        l[k] = k < nbI ? lml_row(A, I0 + k)[c] : 0.0;
#pragma unroll
      for (int r = 0; r < LML_NB; ++r) {
        if (r < nbI) {
          const double* Mr = lml_row(A, I0 + r) + I0;
          double s = 0.0;
#pragma unroll
          for (int k = 0; k <= r; ++k) s += Mr[k] * l[k];
          lml_row(A, I0 + r)[c] = s;
        }
      }
    }
    lml_sync<GLOB>(E);
    // M_I,<I = -P M_<I,<I, chunks of columns from the left: the tiles of a
    // chunk in registers, a barrier, then the writes (later chunks read
    // only columns to their right)
    for (int cs = 0; cs < I0; cs += chunk) {
      const int ce = I0 < cs + chunk ? I0 : cs + chunk;
      const int TC = (ce - cs) >> 3;
      // this warp's tiles: the column tiles of its pairs, both tile rows
      // of each, four chains run together over the k the first needs (B
      // is zero above the diagonal of M: the second's two extra steps add
      // nothing)
      double acc[LML_MAXT][2];
#pragma unroll
      for (int s = 0; s < LML_MAXT; ++s) acc[s][0] = acc[s][1] = 0.0;
      bool rin[2];
#pragma unroll
      for (int tr = 0; tr < 2; ++tr) rin[tr] = 8 * tr + g < nbI;
      // route 0 reads P in place over [cs, I0); route 1 stages it LML_SPAN
      // columns at a time (row r at pan[r LML_SPAN]) from this block's
      // first column on
      for (int kc = cs + LML_NB * rank; kc < I0;
           kc += GLOB ? LML_SPAN : I0) {
        const int ke = GLOB && kc + LML_SPAN < I0 ? kc + LML_SPAN : I0;
        const int ko = GLOB ? kc : 0;
        if (GLOB) {
          lml_stage(E.pan, LML_SPAN, A, I0, I0 + nbI, kc, ke - kc);
          __syncthreads();
        }
        const double* Pr[2];
#pragma unroll
        for (int tr = 0; tr < 2; ++tr) {
          const int rr = rin[tr] ? 8 * tr + g : 0;  // this lane's panel row
          Pr[tr] =
              GLOB ? E.pan + (size_t)rr * LML_SPAN : lml_row(A, I0 + rr);
        }
#pragma unroll
        for (int m = 0; m < LML_MAXT / 4; ++m) {
          const int ct0 = 2 * (NW * m + C * warp + rank);
          if (ct0 < TC) {
            const bool two = ct0 + 1 < TC;
            const int cb0 = cs + 8 * ct0 + g, cb1 = cb0 + 8;
            for (int k = cs + 8 * ct0 > kc ? cs + 8 * ct0 : kc; k < ke;
                 k += 4) {
              const int kb = k + t;
              const double* Mk = lml_row(A, kb);
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
      lml_sync<GLOB>(E);
#pragma unroll
      for (int s = 0; s < LML_MAXT; ++s) {
        const int ct = 2 * (NW * (s / 4) + C * warp + rank) + (s / 2) % 2;
        const int rr = 8 * (s % 2) + g;
        if (ct < TC && rr < nbI) {
          double* Mr = lml_row(A, I0 + rr) + cs + 8 * ct + 2 * t;
          Mr[0] = acc[s][0];
          Mr[1] = acc[s][1];
        }
      }
    }
  }
  lml_sync<GLOB>(E);
}

// K^-1 = M^T M in place on rows 0..n-1 (M = L^-1), row panels from the
// top: out[r][c] = sum_{k >= r} M_kr M_kc for c <= r reads only rows >= r,
// so a panel's tiles are held in registers across one barrier and then
// overwrite it.  The column tiles are dealt as in lml_trtri.  Ends with a
// barrier of the lane's blocks.
template <bool GLOB>
__device__ void lml_lauum(const LmlEval& E, int n) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int C = lml_C<GLOB>(E), rank = lml_rank<GLOB>(E);
  const int NW = C * LML_WARPS;
  const int chunk = C * LML_CHUNK;
  double* A = E.A;
  for (int I0 = 0; I0 < n; I0 += LML_NB) {
    const int nbI = n - I0 < LML_NB ? n - I0 : LML_NB;
    const int W = I0 + nbI;  // the panel's columns 0..W-1
    for (int cs = 0; cs < W; cs += chunk) {
      const int ce = W < cs + chunk ? W : cs + chunk;
      const int TC = (ce - cs + 7) >> 3;
      // a block with no tile in this chunk stages nothing
      if (2 * rank >= TC) {
        lml_sync<GLOB>(E);
        continue;
      }
      // this warp's tiles: the column tiles of its pairs, both tile rows,
      // run together over k in [I0, n) (A is zero where k < r, B where
      // k < c); per step two A and two B fragments feed four chains
      double acc[LML_MAXT][2];
#pragma unroll
      for (int s = 0; s < LML_MAXT; ++s) acc[s][0] = acc[s][1] = 0.0;
      const int ra0 = I0 + g, ra1 = I0 + 8 + g;
      // route 0 reads the column panel in place over k in [I0, n); route 1
      // stages it LML_SPAN rows at a time (M[k][I0 + j] at
      // pan[(k - kc) LML_NB + j])
      for (int kc = I0; kc < n; kc += GLOB ? LML_SPAN : n) {
        const int ke = GLOB && kc + LML_SPAN < n ? kc + LML_SPAN : n;
        if (GLOB) {
          lml_stage(E.pan, LML_NB, A, kc, ke, I0, nbI);
          __syncthreads();
        }
#pragma unroll
        for (int m = 0; m < LML_MAXT / 4; ++m) {
          const int ct0 = 2 * (NW * m + C * warp + rank);
          if (ct0 < TC) {
            const int cb0 = cs + 8 * ct0 + g, cb1 = cb0 + 8;
            for (int k = kc; k < ke; k += 4) {
              const int kk = k + t;
              const bool kin = kk < n;
              const double* Mk = lml_row(A, kin ? kk : 0);
              const double* Pk =
                  GLOB ? E.pan + (size_t)(kk - kc) * LML_NB : Mk;
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
      lml_sync<GLOB>(E);
#pragma unroll
      for (int s = 0; s < LML_MAXT; ++s) {
        const int ct = 2 * (NW * (s / 4) + C * warp + rank) + (s / 2) % 2;
        const int r = I0 + 8 * (s % 2) + g, c = cs + 8 * ct + 2 * t;
        if (ct < TC && r < n) {
          double* Mr = lml_row(A, r);
          if (c <= r && c < ce) Mr[c] = acc[s][0];
          if (c + 1 <= r && c + 1 < ce) Mr[c + 1] = acc[s][1];
        }
      }
    }
  }
  lml_sync<GLOB>(E);
}

// The LML of theta (p entries, visible to the block) on the data D, the
// factor left in E.A (rows < n: L, row n: z), returned in every thread of
// the lane's blocks (the same bits in each); NaN if K is not positive
// definite.  Every thread calls it; it starts with a block barrier and
// ends with a barrier of the lane's blocks.
template <bool SPEC, bool GLOB>
__device__ double lml_value(const GpryKern& kern, const GpryLmlData& D,
                            const double* theta, const LmlEval& E,
                            GprySpec* spec) {
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int nt = blockDim.x, nw = nt >> 5;
  const int C = lml_C<GLOB>(E), rank = lml_rank<GLOB>(E);
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
  // on a cluster, the lane's barrier: no block writes X / ls or the
  // triangle before every block has left the previous evaluation
  lml_sync<GLOB>(E);
  if constexpr (!SPEC) {
    // X / ls: each block its own copy in shared memory, or the lane's one
    // copy in global memory split over its blocks
    const bool split = GLOB && C > 1 && !E.xs;
    const int t0 = split ? rank * nt + tid : tid, ts = split ? C * nt : nt;
    for (int idx = t0; idx < n * d; idx += ts) {
      const int j = idx / d, k = idx - j * d;
      E.Xt[(size_t)k * n + j] = D.X[idx] / E.ls[k];
    }
    if (split)
      lml_sync<GLOB>(E);
    else
      __syncthreads();
  }
  // the bordered lower triangle: K (rows < n), y (row n); two pairs a lane
  // at a time (independent chains)
  constexpr int H = 2;
  for (int a = rank * nw + warp; a <= n; a += C * nw) {
    const int bmax = a < n ? a : n - 1;
    double* Aa = lml_row(A, a);
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
  lml_sync<GLOB>(E);
  if (!lml_cholesky<GLOB>(E, n)) return NAN;
  // log det and z^T z: the warps' sums of every block of the lane, in
  // the order rank, warp
  double ld = 0.0, qq = 0.0;
  const double* z = lml_row(A, n);
  for (int k = rank * nt + tid; k < n; k += C * nt) {
    ld += log(lml_row(A, k)[k]);
    qq += z[k] * z[k];
  }
  ld = gpry_warp_sum(ld);
  qq = gpry_warp_sum(qq);
  if (lane == 0) {
    E.red[2 * warp] = ld;
    E.red[2 * warp + 1] = qq;
  }
  lml_sync<GLOB>(E);
  ld = qq = 0.0;
  for (int r = 0; r < C; ++r) {
    const double* red = lml_remote<GLOB>(E, E.red, r);
    for (int w = 0; w < nw; ++w) {
      ld += red[2 * w];
      qq += red[2 * w + 1];
    }
  }
  lml_sync<GLOB>(E);
  return (-0.5 * qq - ld) - (0.5 * n) * GPRY_LOG_2PI;
}

// The p derivatives of the LML into grad (any memory; null: this block
// writes none), from the factor lml_value left at theta.  Every thread of
// the lane's blocks calls it; it ends with a barrier of the lane's blocks.
template <bool SPEC, bool GLOB>
__device__ void lml_grad(const GpryKern& kern, const GpryLmlData& D,
                         const double* theta, const LmlEval& E,
                         const GprySpec& spec, double* grad) {
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int nt = blockDim.x, nw = nt >> 5;
  const int C = lml_C<GLOB>(E), rank = lml_rank<GLOB>(E);
  const int n = D.n, d = D.d, p = kern.ntheta;
  double* A = E.A;
  const double variance = exp(theta[0]);
  const double jitter = D.rel_jitter * variance;
  lml_trtri<GLOB>(E, n);
  // alpha = M^T z, each entry into every block's copy
  const double* z = lml_row(A, n);
  for (int a = rank * nt + tid; a < n; a += C * nt) {
    double s = 0.0;
    for (int c = a; c < n; ++c) s += lml_row(A, c)[a] * z[c];
    for (int r = 0; r < C; ++r) lml_remote<GLOB>(E, E.al, r)[a] = s;
  }
  lml_sync<GLOB>(E);
  lml_lauum<GLOB>(E, n);
  // the contraction, GPRY_LML_PCHUNK parameters a pass
  const double* Xt = E.Xt;
  constexpr int H = 2;
  for (int j0 = 0; j0 < p; j0 += GPRY_LML_PCHUNK) {
    double acc[GPRY_LML_PCHUNK];
#pragma unroll
    for (int c = 0; c < GPRY_LML_PCHUNK; ++c) acc[c] = 0.0;
    for (int a = rank * nw + warp; a < n; a += C * nw) {
      const double* Ka = lml_row(A, a);
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
    lml_sync<GLOB>(E);
    if (grad && tid < GPRY_LML_PCHUNK && j0 + tid < p) {
      double s = 0.0;
      for (int r = 0; r < C; ++r) {
        const double* red = lml_remote<GLOB>(E, E.red, r);
        for (int w = 0; w < nw; ++w) s += red[w * GPRY_LML_PCHUNK + tid];
      }
      grad[j0 + tid] = s;
    }
    lml_sync<GLOB>(E);
  }
}

// Host side of route 1's cluster launch.  A cluster of C blocks: 1 or a
// power of two up to LML_MAX_CLUSTER.
static inline bool lml_cluster_ok(int C) {
  return C >= 1 && C <= LML_MAX_CLUSTER && (C & (C - 1)) == 0;
}

// Opt `kernel` into `smem` bytes of dynamic shared memory and, above 8
// blocks a cluster, into the non-portable cluster size.
template <typename K>
static cudaError_t lml_attributes(K kernel, size_t smem, int C) {
  cudaError_t e = gpry_set_smem(kernel, smem);
  if (e != cudaSuccess || C <= 8) return e;
  return cudaFuncSetAttribute(
      kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
}

// How many clusters of C blocks of LML_THREADS (C = 1: blocks) with `smem`
// bytes each the card runs at once (cudaOccupancyMaxActiveClusters; 0: it
// cannot schedule one), after lml_attributes.
template <typename K>
static cudaError_t lml_active(K kernel, size_t smem, int C, int* active) {
  cudaError_t e = lml_attributes(kernel, smem, C);
  if (e != cudaSuccess) return e;
  if (C == 1) {
    int dev, sms, per_sm;
    if ((e = cudaGetDevice(&dev)) != cudaSuccess ||
        (e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                    dev)) != cudaSuccess ||
        (e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
             &per_sm, kernel, LML_THREADS, smem)) != cudaSuccess)
      return e;
    *active = per_sm * sms;
    return cudaSuccess;
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(C);
  cfg.blockDim = dim3(LML_THREADS);
  cfg.dynamicSmemBytes = smem;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = C;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cudaOccupancyMaxActiveClusters(active, (const void*)kernel, &cfg);
}

// act[i]: how many clusters of 2^i blocks (i = 0: blocks) the card runs at
// once, i = 0..4, as lml_active; on route 0 (`route1` false) only act[0],
// the others 0.
template <typename K>
static cudaError_t lml_actives(K kernel, size_t smem, bool route1,
                               int* act) {
  for (int i = 0, c = 1; c <= LML_MAX_CLUSTER; ++i, c *= 2) {
    act[i] = 0;
    if (c > 1 && !route1) continue;
    const cudaError_t e = lml_active(kernel, smem, c, act + i);
    if (e != cudaSuccess) return e;
  }
  return cudaSuccess;
}

// Launch `kernel` on `blocks` blocks of LML_THREADS in clusters of C (C = 1:
// no cluster) on `stream`, after lml_attributes; a launch the runtime
// refuses returns its error.
template <typename... P, typename... A>
static cudaError_t lml_launch(void (*kernel)(P...), int blocks, int C,
                              size_t smem, cudaStream_t stream,
                              A&&... args) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(blocks);
  cfg.blockDim = dim3(LML_THREADS);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  if (C > 1) {
    attr[0].id = cudaLaunchAttributeClusterDimension;
    attr[0].val.clusterDim.x = C;
    attr[0].val.clusterDim.y = 1;
    attr[0].val.clusterDim.z = 1;
    cfg.attrs = attr;
    cfg.numAttrs = 1;
  }
  cudaError_t e = cudaLaunchKernelEx(&cfg, kernel, std::forward<A>(args)...);
  if (e != cudaSuccess) return e;
  return cudaGetLastError();
}
