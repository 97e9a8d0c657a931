// K7 predict_meancov: the GP posterior mean and full covariance at nq
// query points.
//
// Replaces gpry_tpu/ops/linalg.py:172 predict_meancov, reached through
// gpry_tpu/models/gp.py:1254-1262 GaussianProcessRegressor.predict(
// return_cov=True).  In the GP's (preprocessed) coordinates, against the n
// valid training rows of the padded factor L (row-major, nmax x nmax):
//
//   Kq   = K(Xq, X[:n])                        (nq x n)
//   mean = Kq . alpha
//   V    = L^-1 Kq^T                           (n x nq)
//   cov  = K(Xq, Xq) - V^T V,  its diagonal k(x_i, x_i) - |V_i|^2
//
// where k(x_i, x_i) is the same-point variance (kernel_diag: a WhiteKernel
// term counts there and nowhere else, sklearn's semantics).
//
// Design: two kernels on one stream, the plan on the host (k7_plan,
// mirrored by ops/fused.py predict_meancov_plan).
//  (a) The solve, K5's (meanvar_ungated.cu): the route and the queries a
//      block by K5's rule (sub_plan with K5's layout), so that K7 and K5
//      take the same route and Q at every nq.  Route 0,
//      meancov_solve_blocked: Q = 8-32 queries a block on subst_blocked.cuh
//      (sub_build_k, sub_dot_alpha a warp a query, sub_forward).  Route 1,
//      meancov_solve_chain (an odd nmax, an L not 16-byte aligned, n
//      beyond route 0): a warp a query, gpry_warp_forward_subst.  Each
//      writes the mean, cov[i][i] = prior_i - sumsq_i from the solve's own
//      sum of squares (prior_i the variance, or gpry_spec_diag), formed as
//      K5 forms its var0, so diag(cov) equals K5's sigma^2 bit for bit
//      wherever the two are given the same coordinates; and V_i, the
//      query's solved column, as row i of a scratch of nq rows of n_pad =
//      sub_npad(n) doubles (zeros beyond n).  Query-major rows: the solve
//      writes each query's column as one contiguous row, and the product
//      stages a tile's queries as whole 16-byte aligned rows with no ragged
//      edge in n.
//  (b) The product, meancov_cov_dmma: a block of K7_PTHREADS owns one
//      K7_T x K7_T tile (ti, tj) of cov with ti >= tj, the lower tiles
//      only; each entry below the diagonal is stored at (i, j) and at (j,
//      i), so cov is symmetric bit for bit, and the diagonal is the
//      solve's.  The tile's query rows of V (rows i0.. and j0.., once for a
//      diagonal tile) stream through shared memory in chunks of K7_KC
//      training rows, copied by cp.async and double-buffered, each row
//      padded to K7_LDS doubles so that the tensor-core operand loads hit
//      16 distinct 8-byte banks a half-warp.  The first chunk is in flight
//      while each thread computes the kernel values K(x_i, x_j) of its
//      entries (gpry_k_of_sq, or gpry_spec_cov in spec mode) from the
//      tile's staged points, straight into its sums; V^T V is then
//      subtracted on the FP64 tensor cores (gpry_dmma16, m16n8k4, the A
//      operand negated), each warp holding a (K7_T / K7_WR) x (K7_T /
//      K7_WC) sub-tile in registers.  A warp whose sub-tile holds no entry
//      below the diagonal skips the products.
//
// The fast families and spec mode (template SPEC, the interpreter of
// common.cuh) share both kernels.
//
// What bounds it on the H100.  chip_smoke.py's bound counts the operations
// of one triangle (the covariance is symmetric): the k vectors and the
// mean, nq n^2 / 2 multiply-adds of substitution, and nq (nq + 1) / 2
// kernel values and n-long dot products, over the FP64 peak; at nq =
// 1,024, n = 224 about 0.31 GFLOP, 4.6 us at 67 TFLOP/s (the output, nq^2
// doubles, is 8.4 MB, 2.6 us at 3.35 TB/s).  (a) is bound by the
// dependent chain of a block's 16-row panels, as K5's route 0.  (b)
// computes only that triangle, on the tensor cores.  A block's own work
// is short (at nq = 1,024, 528 tiles of 32 x 32 against 224 training
// rows), so its latencies (the first chunk, the kernel values' exp
// chains, the barriers of each chunk) bound it: 32 x 32 tiles on 8 warps
// put four blocks, 32 warps, on each SM to hide them, where 64 x 64
// tiles (136 blocks, one an SM) took 1.5-2x as long, and 4 warps a tile
// as long at nq = 1,024 but 1.3-1.8x as long at 64 (profile_k7.py).
#include "subst_blocked.cuh"

// the solve's block (both routes)
#define K7_THREADS 256
#define K7_WARPS (K7_THREADS / 32)
// the product: the block's output tile, its warps as K7_WR x K7_WC, the
// training rows a stage and a staged row's doubles
#define K7_T 32
#define K7_WR 2
#define K7_WC 4
#define K7_KC 32
#define K7_LDS (K7_KC + 4)
#define K7_PTHREADS (32 * K7_WR * K7_WC)
// a warp's 8-row and 8-column blocks (K7_MI even: the rows go to the
// tensor cores 16 at a time)
#define K7_MI (K7_T / K7_WR / 8)
#define K7_NJ (K7_T / K7_WC / 8)
// doubles of one stage: the tile's K7_T rows i, then K7_T rows j
#define K7_STAGE (2 * K7_T * K7_LDS)

// (a), route 1: shared layout ls[d] | qls[Q][d] | kv[Q][n] | spec program
// (SPEC).
template <bool SPEC>
__global__ void meancov_solve_chain(
    GpryKern kern, int nq, int n, int nmax, int d, int Q,
    const double* __restrict__ Xq, const double* __restrict__ X,
    const double* __restrict__ alpha, const double* __restrict__ L,
    const double* __restrict__ theta, double* __restrict__ V,
    double* __restrict__ mean_out, double* __restrict__ cov) {
  extern __shared__ double smem[];
  double* ls = smem;
  double* qls = ls + d;
  double* kv = qls + (size_t)Q * d;

  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const int q0 = blockIdx.x * Q;
  const int nqb = min(Q, nq - q0);
  const int family = kern.family, np = sub_npad(n);

  GprySpec spec;
  if constexpr (SPEC)
    spec = gpry_stage_spec(kv + (size_t)Q * n, kern, theta, tid, blockDim.x);
  for (int k = tid; k < d; k += blockDim.x)
    ls[k] = SPEC ? 1.0 : exp(theta[1 + k]);
  __syncthreads();
  const double variance = SPEC ? 1.0 : exp(theta[0]);

  for (int idx = tid; idx < nqb * d; idx += blockDim.x)
    qls[idx] = Xq[(size_t)q0 * d + idx] / ls[idx % d];
  __syncthreads();

  // k vectors of the block's queries against the n valid rows
  for (int idx = tid; idx < nqb * n; idx += blockDim.x) {
    const int qi = idx / n, j = idx - qi * n;
    if constexpr (SPEC) {
      kv[(size_t)qi * n + j] =
          gpry_spec_cov(spec, qls + qi * d, 1, X + (size_t)j * d, 1, d);
    } else {
      double sq = 0.0;
      for (int k = 0; k < d; ++k) {
        const double df = qls[qi * d + k] - X[(size_t)j * d + k] / ls[k];
        sq += df * df;
      }
      kv[(size_t)qi * n + j] = variance * gpry_k_of_sq(family, sq);
    }
  }
  __syncthreads();

  // one warp per query: the mean, the substitution, the row of V, the
  // diagonal entry
  for (int qi = warp; qi < nqb; qi += K7_WARPS) {
    double* v = kv + (size_t)qi * n;
    const double m = sub_dot_alpha(v, 1, n, alpha);
    const double sumsq = gpry_warp_forward_subst(L, nmax, n, v, lane);
    double* Vq = V + (size_t)(q0 + qi) * np;
    for (int j = lane; j < np; j += 32) Vq[j] = j < n ? v[j] : 0.0;
    if (lane == 0) {
      const double prior =
          SPEC ? gpry_spec_diag(spec, qls + qi * d, 1, d) : variance;
      mean_out[q0 + qi] = m;
      cov[(size_t)(q0 + qi) * (nq + 1)] = prior - sumsq;
    }
  }
}

// (a), route 0.  Shared layout (K5's): ls[d] | qls[Q][d] | m[Q] | spec
// program (SPEC) | sub_forward's V, stages, shares, sumsq.
template <bool SPEC>
__global__ void __launch_bounds__(SUB_THREADS) meancov_solve_blocked(
    GpryKern kern, int nq, int n, int nmax, int d, int Q,
    const double* __restrict__ Xq, const double* __restrict__ X,
    const double* __restrict__ alpha, const double* __restrict__ L,
    const double* __restrict__ theta, double* __restrict__ V,
    double* __restrict__ mean_out, double* __restrict__ cov) {
  extern __shared__ double smem[];
  double* ls = smem;
  double* qls = ls + d;
  double* ms = qls + (size_t)Q * d;
  double* prog = ms + Q;
  const GprySub sub = sub_carve(L, n, nmax, Q, prog + gpry_spec_doubles(kern));
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int q0 = blockIdx.x * Q, nqb = min(Q, nq - q0);

  GprySpec spec;
  if constexpr (SPEC)
    spec = gpry_stage_spec(prog, kern, theta, tid, blockDim.x);
  for (int k = tid; k < d; k += blockDim.x)
    ls[k] = SPEC ? 1.0 : exp(theta[1 + k]);
  __syncthreads();
  const double variance = SPEC ? 1.0 : exp(theta[0]);
  for (int idx = tid; idx < nqb * d; idx += blockDim.x)
    qls[idx] = Xq[(size_t)q0 * d + idx] / ls[idx % d];
  sub_build_k<SPEC>(sub, kern.family, spec, variance, ls, qls, X, d, nqb);
  for (int qi = warp; qi < nqb; qi += K7_WARPS) {
    const double m = sub_dot_alpha(sub.V + qi, Q + 4, n, alpha);
    if (lane == 0) ms[qi] = m;
  }
  __syncthreads();
  sub_forward(sub);
  // the rows of V: a thread an entry, neighbouring threads on one row of
  // sub.V (four rows of 8 queries a warp: whole 32-byte sectors of V)
  const int np = sub_npad(n);
  for (int idx = tid; idx < np * nqb; idx += blockDim.x) {
    const int j = idx / nqb, qi = idx - j * nqb;
    V[(size_t)(q0 + qi) * np + j] = sub.V[(size_t)j * (Q + 4) + qi];
  }
  for (int qi = tid; qi < nqb; qi += blockDim.x) {
    const double prior =
        SPEC ? gpry_spec_diag(spec, qls + qi * d, 1, d) : variance;
    mean_out[q0 + qi] = ms[qi];
    cov[(size_t)(q0 + qi) * (nq + 1)] = prior - sub.sumsq[qi];
  }
}

// Lower tile t (row order: t = ti (ti + 1) / 2 + tj, tj <= ti).
__device__ __forceinline__ void k7_tile(int t, int* ti, int* tj) {
  long long i = (long long)((sqrt(8.0 * t + 1.0) - 1.0) * 0.5);
  while (i * (i + 1) / 2 > t) --i;
  while ((i + 1) * (i + 2) / 2 <= t) ++i;
  *ti = (int)i;
  *tj = (int)(t - i * (i + 1) / 2);
}

// Training rows k0 .. k0 + K7_KC - 1 of the tile's query rows of V (i0 +
// r, then j0 + r unless the tile is diagonal) into stage s, by cp.async:
// a thread 16 bytes, K7_KC / 2 threads a row; zeros for a query at or
// beyond nq and for the rows beyond n_pad.
__device__ __forceinline__ void k7_load(const double* __restrict__ V, int nq,
                                        int np, int i0, int j0, bool diag,
                                        int k0, double* s) {
  const int per = K7_KC / 2, rows = diag ? K7_T : 2 * K7_T;
  for (int e = threadIdx.x; e < rows * per; e += blockDim.x) {
    const int r = e / per, c = 2 * (e - r * per);
    const int q = (r < K7_T ? i0 : j0 - K7_T) + r;
    double* dp = s + r * K7_LDS + c;
    if (q < nq && k0 + c < np) {
      __pipeline_memcpy_async(dp, V + (size_t)q * np + k0 + c,
                              2 * sizeof(double));
    } else {
      dp[0] = 0.0;
      dp[1] = 0.0;
    }
  }
}

// (b).  Shared layout: two stages of K7_STAGE doubles | the tile's points
// over the length scales, K7_T rows i then (unless diagonal) K7_T rows j
// of d | 1 doubles (an odd stride: the rows a warp reads fall in distinct
// banks) | ls[d] | spec program (SPEC).
template <bool SPEC>
__global__ void __launch_bounds__(K7_PTHREADS) meancov_cov_dmma(
    GpryKern kern, int nq, int np, int d, const double* __restrict__ Xq,
    const double* __restrict__ theta, const double* __restrict__ V,
    double* __restrict__ cov) {
  extern __shared__ double smem[];
  double* stage = smem + (((size_t)smem & 15) ? 1 : 0);
  double* pts = stage + 2 * K7_STAGE;
  const int ldp = d | 1;
  double* ls = pts + 2 * (size_t)K7_T * ldp;
  double* prog = ls + d;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t4 = lane & 3;
  int ti, tj;
  k7_tile(blockIdx.x, &ti, &tj);
  const int i0 = ti * K7_T, j0 = tj * K7_T;
  const bool diag = ti == tj;
  // a diagonal tile of one query holds no entry below the diagonal
  if (diag && nq - i0 < 2) return;
  const double* pj = diag ? pts : pts + (size_t)K7_T * ldp;
  const int nk = (np + K7_KC - 1) / K7_KC;
  // the warp's sub-tile: rows rw.., columns cw.. of the tile
  const int rw = warp / K7_WC * (K7_T / K7_WR);
  const int cw = warp % K7_WC * (K7_T / K7_WC);
  const bool live = i0 + rw < nq && j0 + cw < nq &&
                    (!diag || rw + K7_T / K7_WR - 1 > cw);

  // the first chunk in flight while the kernel values are computed
  if (nk > 0) k7_load(V, nq, np, i0, j0, diag, 0, stage);
  __pipeline_commit();
  GprySpec spec;
  if constexpr (SPEC)
    spec = gpry_stage_spec(prog, kern, theta, tid, blockDim.x);
  for (int k = tid; k < d; k += blockDim.x)
    ls[k] = SPEC ? 1.0 : exp(theta[1 + k]);
  __syncthreads();
  for (int e = tid; e < (diag ? 1 : 2) * K7_T * d; e += blockDim.x) {
    const int r = e / d, k = e - r * d;
    const int q = (r < K7_T ? i0 : j0 - K7_T) + r;
    pts[r * ldp + k] = q < nq ? Xq[(size_t)q * d + k] / ls[k] : 0.0;
  }
  __syncthreads();

  // the kernel values K(x_i, x_j) of the thread's entries, into its sums:
  // entry (mi, nj, e) is row rw + 8 mi + g, column cw + 8 nj + 2 t4 + e of
  // the tile (its place in an m16n8k4 accumulator: rows g and g + 8 of a
  // 16-row block, mi even and odd)
  const double variance = SPEC ? 1.0 : exp(theta[0]);
  double acc[K7_MI][K7_NJ][2];
#pragma unroll
  for (int mi = 0; mi < K7_MI; ++mi)
#pragma unroll
    for (int nj = 0; nj < K7_NJ; ++nj)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int r = rw + 8 * mi + g, c = cw + 8 * nj + 2 * t4 + e;
        double kv = 0.0;
        if (i0 + r < nq && j0 + c < nq && (!diag || r > c)) {
          const double* a = pts + (size_t)r * ldp;
          const double* b = pj + (size_t)c * ldp;
          if constexpr (SPEC) {
            kv = gpry_spec_cov(spec, a, 1, b, 1, d);
          } else {
            double sq = 0.0;
            for (int k = 0; k < d; ++k) {
              const double df = a[k] - b[k];
              sq += df * df;
            }
            kv = variance * gpry_k_of_sq(kern.family, sq);
          }
        }
        acc[mi][nj][e] = kv;
      }
  __pipeline_wait_prior(0);
  __syncthreads();

  // the products: acc -= V_i^T V_j over the chunks, the next chunk's copy
  // in flight
  for (int kc = 0; kc < nk; ++kc) {
    if (kc + 1 < nk)
      k7_load(V, nq, np, i0, j0, diag, (kc + 1) * K7_KC,
              stage + ((kc + 1) & 1) * K7_STAGE);
    __pipeline_commit();
    const double* s = stage + (kc & 1) * K7_STAGE;
    if (live) {
      const double* sa = s + (rw + g) * K7_LDS + t4;
      const double* sb = s + (diag ? 0 : K7_T * K7_LDS) + (cw + g) * K7_LDS +
                         t4;
#pragma unroll
      for (int kk = 0; kk < K7_KC; kk += 4) {
        double a[K7_MI], b[K7_NJ];
#pragma unroll
        for (int mi = 0; mi < K7_MI; ++mi)
          a[mi] = -sa[8 * mi * K7_LDS + kk];
#pragma unroll
        for (int nj = 0; nj < K7_NJ; ++nj) b[nj] = sb[8 * nj * K7_LDS + kk];
#pragma unroll
        for (int mh = 0; mh < K7_MI / 2; ++mh)
#pragma unroll
          for (int nj = 0; nj < K7_NJ; ++nj)
            gpry_dmma16(acc[2 * mh][nj][0], acc[2 * mh][nj][1],
                        acc[2 * mh + 1][nj][0], acc[2 * mh + 1][nj][1],
                        a[2 * mh], a[2 * mh + 1], b[nj]);
      }
    }
    // the next chunk landed, this stage free for the one after
    __pipeline_wait_prior(0);
    __syncthreads();
  }

  // the stores: each entry below the diagonal at (i, j) and at (j, i)
#pragma unroll
  for (int mi = 0; mi < K7_MI; ++mi)
#pragma unroll
    for (int nj = 0; nj < K7_NJ; ++nj)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int r = rw + 8 * mi + g, c = cw + 8 * nj + 2 * t4 + e;
        const int i = i0 + r, j = j0 + c;
        if (i < nq && j < nq && (!diag || r > c)) {
          cov[(size_t)i * nq + j] = acc[mi][nj][e];
          cov[(size_t)j * nq + i] = acc[mi][nj][e];
        }
      }
}

static size_t meancov_cov_smem(const GpryKern& kern, int d) {
  return sizeof(double) * (2 * (size_t)K7_STAGE +
                           2 * (size_t)K7_T * (d | 1) + (size_t)d +
                           gpry_spec_doubles(kern) + 1);
}

// The plan: the solve's route and *Q, *smem_a (K5's, sub_ungated_plan: 0
// blocked, 1 the chain with Q = qchain); the product's lower tiles *tiles
// and shared memory *smem_b.  Returns the route, or -1 where the product's
// tile points do not fit in shared memory (d above 375).
static int k7_plan(const GpryKern& kern, int nq, int n, int nmax, int d,
                   int qchain, const void* L, int* Q, size_t* smem_a,
                   int* tiles, size_t* smem_b) {
  const int route =
      sub_ungated_plan(kern, nq, n, nmax, d, qchain, L, Q, smem_a);
  const int nt = (nq + K7_T - 1) / K7_T;
  *tiles = nt * (nt + 1) / 2;
  *smem_b = meancov_cov_smem(kern, d);
  return *smem_b > GPRY_MAX_SMEM ? -1 : route;
}

extern "C" int gpry_predict_meancov_plan(GpryKern kern, int nq, int n,
                                         int nmax, int d, int qchain,
                                         const void* L, int* Q,
                                         size_t* smem_a, int* tiles,
                                         size_t* smem_b) {
  return k7_plan(kern, nq, n, nmax, d, qchain, L, Q, smem_a, tiles, smem_b);
}

// Xq (nq, d) preprocessed; X (nmax, d), alpha (nmax,), L (nmax, nmax)
// row-major; V scratch of nq * sub_npad(n) doubles (16-byte aligned);
// outputs mean (nq,) and cov (nq, nq), both in the GP's coordinates.
// qchain: queries per block of (a) on route 1.
extern "C" int gpry_predict_meancov(GpryKern kern, int nq, int n, int nmax,
                                    int d, int qchain, const void* Xq,
                                    const void* X, const void* alpha,
                                    const void* L, const void* theta,
                                    void* V, void* mean, void* cov,
                                    void* stream) {
  if (nq <= 0) return 0;
  int Q = qchain, tiles = 0;
  size_t smem_a = 0, smem_b = 0;
  const int route =
      k7_plan(kern, nq, n, nmax, d, qchain, L, &Q, &smem_a, &tiles, &smem_b);
  if (route < 0) return (int)cudaErrorInvalidValue;
  const bool spec = kern.nodes > 0;
  auto solve = route == 0 ? (spec ? meancov_solve_blocked<true>
                                  : meancov_solve_blocked<false>)
                          : (spec ? meancov_solve_chain<true>
                                  : meancov_solve_chain<false>);
  cudaError_t e = gpry_set_smem(solve, smem_a);
  if (e != cudaSuccess) return (int)e;
  solve<<<(nq + Q - 1) / Q, K7_THREADS, smem_a, (cudaStream_t)stream>>>(
      kern, nq, n, nmax, d, Q, (const double*)Xq, (const double*)X,
      (const double*)alpha, (const double*)L, (const double*)theta,
      (double*)V, (double*)mean, (double*)cov);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  auto prod = spec ? meancov_cov_dmma<true> : meancov_cov_dmma<false>;
  e = gpry_set_smem(prod, smem_b);
  if (e != cudaSuccess) return (int)e;
  prod<<<tiles, K7_PTHREADS, smem_b, (cudaStream_t)stream>>>(
      kern, nq, sub_npad(n), d, (const double*)Xq, (const double*)theta,
      (const double*)V, (double*)cov);
  return (int)cudaGetLastError();
}
