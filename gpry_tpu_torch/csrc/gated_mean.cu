// K1 gated_mean: the gated GP posterior mean, in one pass.
//
// Replaces gpry_tpu/ops/linalg.py:157 predict_mean reached through
// gpry_tpu/models/gp.py:121 surrogate_predict_mean, with the SVM gate of
// gpry_tpu/models/classifier.py:40 svm_decision fused in.  It also does the
// work of the deleted Pallas kernel fused_predict_mean_f32
// (git show 595786d:gpry_tpu/ops/pallas_kernels.py), in float64.
//
//   out[q] = min((sum_{j<n} s2 k(r_qj) alpha_j) * y_scale + y_loc, clip_max)
//            if svm_finite(q) and x_q inside the trust box, else -inf
//
// What bounds it on the H100.  The float64 exp of every (query, row) pair
// (one per training row and one per support vector), ~40 FP64 instructions
// a pair at d = 8: 15.2 M pairs at the IS refine's nq = 65,536, n = 224.
// The data is small (the surrogate is read by every block, from L2), so
// below a few thousand queries what bounds a launch is how many of the
// card's FP64 pipes its pairs reach, and the latency of a chain of
// dependent exponentials.
//
// Design: one geometry for every shape.  A warp holds 32 queries, one a
// lane; a block packs its queries inside the trust box into its first
// slots (a ballot a warp, in order; a query outside is -inf whatever it
// sums, so it sums nothing) and keeps their preprocessed coordinates and
// those over the length scales in shared memory, whence a warp takes a
// query warp's into registers for d <= 32 (a fast family; instances for
// d <= 8 and d <= 32; above that, and in spec mode, where the interpreter
// reads a point through a pointer, they are read in place).  The rows a
// query sums (the n valid training rows, X / l with alpha, then the
// support vectors with their duals) stream through shared memory in
// double-buffered tiles, copied by cp.async (each thread divides the rows
// it copied by the length scales), one block barrier a tile: every warp
// of the block reads the staged tile, each row as a broadcast, so n is
// bounded by nothing and no surrogate is staged whole.  The GP sum and the
// SVM sum run in the same pass.  The block's work is its L live query
// warps times W row chunks (chunk c: rows c, c + W, ... of each tile, four
// rows at a time for independent exponentials), the L W units dealt to
// its W warps in turn: every warp sums about L / W of a query warp's rows
// whatever share of the queries the trust box left, and a unit's partial
// sums stay in shared memory, touched only by the warp that owns the
// unit.  Where the queries are few (the paths' 16-2,000), a block holds one
// query warp and 8 warps, and the rows are split further over the cl
// blocks of a thread-block cluster (up to 16), a block a contiguous share
// of the rows.  The partial sums meet once per query tile: a thread a slot
// adds its block's chunks from shared memory, then, after a cluster
// barrier, rank 0 the ranks' through distributed shared memory, each in a
// fixed order, and applies the gates.
//
// The plan (k1_plan; mirrored by ops/fused.py gated_mean_plan) takes as
// many row splits as one wave of K1_WAVE_BLOCKS blocks holds (8 a block,
// then a cluster of up to 16 within K1_CLUSTER_BLOCKS blocks in all), each
// split at least K1_MIN_ROWS rows, and as many query warps a block as the
// 8 warps leave;
// a tile is K1_TILE_ROWS rows a chunk, halved (then the query warps, then
// the splits) until the block fits in shared memory.
//
// The distances are direct differences (x_q / l - x_j / l)^2, as the
// reference computes them (gpry_tpu/ops/kernels.py:40-48), not |a|^2 + |b|^2
// - 2 a.b: the mean sums alpha that cancel.
//
// Spec mode (a composite kernel, template SPEC): X is staged as it is (no
// length scale divides the whole point) with the spec program and
// exp(+-theta), and each (query, training row) pair runs the interpreter
// of common.cuh (gpry_spec_cov) in place of variance * k(r^2).
#include <cuda_pipeline.h>

#include "common.cuh"

namespace cg = cooperative_groups;

// warps a block at most; the blocks of one wave (both instances hold 96
// registers a thread or more: 2 blocks of 8 warps on each of the H100's
// 132 SMs); the blocks of a launch with clusters (one an SM, so that every
// cluster is resident at once); rows a split sums at least; rows a chunk
// takes from one staged tile; the smallest tile; the largest cluster
// (beyond 8 a non-portable size)
#define K1_WARPS 8
#define K1_WAVE_BLOCKS 264
#define K1_CLUSTER_BLOCKS 132
#define K1_MIN_ROWS 2
#define K1_TILE_ROWS 32
#define K1_MIN_TILE 8
#define K1_MAX_CLUSTER 16
#define K1_PORTABLE_CLUSTER 8

struct K1Plan {
  int qw;  // query warps a block (32 queries each)
  int sw;  // row splits a block: warps holding the same queries
  int cl;  // blocks a cluster: row splits across blocks
  int tr;  // rows a staged tile (K1_TILE_ROWS a chunk)
  int dq;  // query coordinates in registers for d <= dq (8, 32); 0: smem
  size_t smem;
};

// Shared doubles: ls[d] | the queries, d x QB preprocessed (and for a
// fast family d x QB over the length scales) | two tiles of tr rows x d
// and tr weights | the partial sums, 2 x C x QB (C = qw sw chunks of the
// rows) | the slots' query indices (QB ints) and the live count of each
// query warp (K1_WARPS ints) | the spec program.
__host__ __device__ inline size_t k1_smem_doubles(int qw, int sw, int tr,
                                                  int d, size_t spec) {
  const size_t qb = 32 * (size_t)qw;
  return (size_t)d + (spec ? 1 : 2) * (size_t)d * qb +
         2 * (size_t)tr * (d + 1) + 2 * (size_t)qw * sw * qb +
         (qb + K1_WARPS) / 2 + spec;
}

// nq queries, each summing `rows` rows (n, plus the support vectors when
// the SVM is fitted); spec: the program's doubles (0 for a fast family).
static int k1_plan(int nq, int rows, int d, size_t spec, K1Plan* p) {
  const int qt = max(1, (nq + 31) / 32);
  const int most = max(1, rows / K1_MIN_ROWS);
  // as many splits a block as one wave of blocks holds, then, at 8, a
  // cluster as large as one block an SM allows
  int sw = 1;
  while (2 * sw <= min(most, K1_WARPS) &&
         (qt + min(K1_WARPS / (2 * sw), qt) - 1) /
                 min(K1_WARPS / (2 * sw), qt) <= K1_WAVE_BLOCKS)
    sw *= 2;
  p->cl = sw == K1_WARPS ? max(1, min(min(K1_MAX_CLUSTER, most / K1_WARPS),
                                      K1_CLUSTER_BLOCKS / qt))
                         : 1;
  p->sw = sw;
  p->qw = max(1, min(K1_WARPS / sw, qt));
  p->dq = spec ? 0 : d <= 8 ? 8 : d <= 32 ? 32 : 0;
  p->tr = K1_TILE_ROWS * p->qw * sw;
  for (;;) {
    p->smem = sizeof(double) * k1_smem_doubles(p->qw, p->sw, p->tr, d, spec);
    if (p->smem <= GPRY_MAX_SMEM) return 0;
    if (p->tr > K1_MIN_TILE)
      p->tr /= 2;
    else if (p->qw > 1)
      p->qw /= 2;
    else if (p->sw > 1)
      p->sw /= 2;
    else
      return (int)cudaErrorInvalidValue;
  }
}

struct K1Args {
  GpryKern kern;
  int nq, n, nsv, d, svm_mode;
  K1Plan g;
  const double *Xq_raw, *X, *alpha, *theta, *x_loc, *x_scale, *trust_lo,
      *trust_hi, *sv, *dual, *scal;
  double* out;
};

// Rows base..base + nt - 1 of the row stream (the training rows, then the
// support vectors) into tile T (nt x d, then the weights at T + tr d) by
// cp.async, one group.  the tile loop's scaling walks the same indices.
__device__ __forceinline__ void k1_load(const K1Args& a, double* T, int base,
                                        int nt) {
  const int d = a.d;
  for (int idx = threadIdx.x; idx < nt * d; idx += blockDim.x) {
    const int r = idx / d, row = base + r;
    const double* src = row < a.n
                            ? a.X + (size_t)base * d + idx
                            : a.sv + (size_t)(row - a.n) * d + (idx - r * d);
    __pipeline_memcpy_async(T + idx, src, sizeof(double));
  }
  double* w = T + (size_t)a.g.tr * d;
  for (int r = threadIdx.x; r < nt; r += blockDim.x) {
    const int row = base + r;
    __pipeline_memcpy_async(w + r, row < a.n ? a.alpha + row
                                             : a.dual + (row - a.n),
                            sizeof(double));
  }
  __pipeline_commit();
}

// The GP term of training row xr (staged over the length scales) for the
// query over the length scales in registers (qv) or in shared memory (qs,
// stride QB; a spec program reads the preprocessed point there).
template <bool SPEC, int DQ>
__device__ __forceinline__ double k1_gp_term(const K1Args& a,
                                             const GprySpec& spec,
                                             double variance,
                                             const double* qv,
                                             const double* qs, int QB,
                                             const double* xr) {
  const int d = a.d;
  if constexpr (SPEC) {
    return gpry_spec_cov(spec, qs, QB, xr, 1, d);
  } else {
    double sq = 0.0;
    if constexpr (DQ > 0) {
#pragma unroll
      for (int k = 0; k < DQ; ++k) {
        if (k < d) {
          const double df = qv[k] - xr[k];
          sq += df * df;
        }
      }
    } else {
      for (int k = 0; k < d; ++k) {
        const double df = qs[k * QB] - xr[k];
        sq += df * df;
      }
    }
    return variance * gpry_k_of_sq(a.kern.family, sq);
  }
}

template <bool SPEC, int DQ>
__global__ void __launch_bounds__(32 * K1_WARPS)
gated_mean_kernel(const K1Args a) {
  extern __shared__ double smem[];
  const K1Plan& g = a.g;
  const int d = a.d, tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int W = blockDim.x >> 5;
  const int QB = 32 * g.qw;
  const int rank = g.cl > 1 ? (int)cg::this_cluster().block_rank() : 0;

  double* ls = smem;
  double* qs = ls + d;
  double* tiles = qs + (SPEC ? 1 : 2) * d * QB;
  const int ts = g.tr * (d + 1);
  double* red = tiles + 2 * ts;
  int* slot = (int*)(red + 2 * W * QB);  // the slots' queries
  int* wlive = slot + QB;                 // live queries a query warp
  double* sp = red + 2 * W * QB + (QB + K1_WARPS) / 2;

  // this block's share [lo, hi) of the row stream
  const int nsv = a.svm_mode == GPRY_MODE_FITTED ? a.nsv : 0;
  const int m = a.svm_mode == GPRY_MODE_NONE_FINITE ? 0 : a.n + nsv;
  const int lo = (int)((long long)m * rank / g.cl);
  const int hi = (int)((long long)m * (rank + 1) / g.cl);
  const int ntiles = (hi - lo + g.tr - 1) / g.tr;
  if (ntiles > 0) k1_load(a, tiles, lo, min(g.tr, hi - lo));
  GprySpec spec;
  if constexpr (SPEC)
    spec = gpry_stage_spec(sp, a.kern, a.theta, tid, blockDim.x);
  else
    for (int k = tid; k < d; k += blockDim.x) ls[k] = exp(a.theta[1 + k]);
  const double variance = SPEC ? 1.0 : exp(a.theta[0]);

  // the block's QB queries, a query warp's 32 checked by its first warp:
  // those inside the trust box take the first slots, in order (every rank
  // of a cluster finds the same); the others are -inf and sum nothing.
  // The loads are unrolled and the tests not short-circuited, so that
  // they are in flight together; a query's preprocessed coordinates go to
  // its slot in shared memory (qs, d x QB), read there by the slot's
  // warps.
  const int qg0 = warp % g.qw;
  const int q0 = blockIdx.x / g.cl * QB + qg0 * 32 + lane;
  const bool checks = warp < g.qw;
  bool inside = false;
  int pos = 0;
  double xp0[DQ ? DQ : 1];
  if (checks) {
    if (q0 < a.nq) {
      const double* xq = a.Xq_raw + (size_t)q0 * d;
      inside = true;
      if constexpr (DQ > 0) {
#pragma unroll
        for (int k = 0; k < DQ; ++k) {
          if (k < d) {
            const double xr = xq[k];
            inside &= (xr >= a.trust_lo[k]) & (xr <= a.trust_hi[k]);
            xp0[k] = (xr - a.x_loc[k]) / a.x_scale[k];
          }
        }
      } else {
#pragma unroll 8
        for (int k = 0; k < d; ++k) {
          const double xr = xq[k];
          inside &= (xr >= a.trust_lo[k]) & (xr <= a.trust_hi[k]);
        }
      }
    }
    const unsigned ball = __ballot_sync(0xffffffffu, inside);
    pos = __popc(ball & ((1u << lane) - 1u));
    if (lane == 0) wlive[qg0] = __popc(ball);
  }
  __syncthreads();
  int nlive = 0;
  for (int w = 0; w < g.qw; ++w) {
    if (checks && w == qg0) pos += nlive;
    nlive += wlive[w];
  }
  if (checks) {
    if (inside) {
      slot[pos] = q0;
      if constexpr (DQ > 0) {
#pragma unroll
        for (int k = 0; k < DQ; ++k) {
          if (k < d) {
            qs[k * QB + pos] = xp0[k];
            qs[(d + k) * QB + pos] = xp0[k] / ls[k];
          }
        }
      } else {
        const double* xq = a.Xq_raw + (size_t)q0 * d;
#pragma unroll 8
        for (int k = 0; k < d; ++k) {
          const double xp = (xq[k] - a.x_loc[k]) / a.x_scale[k];
          qs[k * QB + pos] = xp;
          if constexpr (!SPEC) qs[(d + k) * QB + pos] = xp / ls[k];
        }
      }
    } else if (q0 < a.nq && rank == 0) {
      a.out[q0] = -INFINITY;
    }
  }
  __syncthreads();

  // the work: the L live query warps times C = W chunks of the rows
  // (chunk c: rows c, c + C, ... of every tile), L C units dealt to the W
  // warps in turn, so that every warp sums about L / W of a query warp's
  // rows whatever share of the queries the trust box left.  A unit's
  // partial sums live in shared memory (ra, rd: C x QB), touched only by
  // the warp that owns the unit.
  const int L = (nlive + 31) >> 5;
  const int C = W;
  double* ra = red;
  double* rd = red + C * QB;
  const double gamma = a.scal[4];
  for (int t = 0; t < ntiles; ++t) {
    const int base = lo + t * g.tr, nt = min(g.tr, hi - base);
    const int ngp = max(0, min(nt, a.n - base));
    double* T = tiles + (t & 1) * ts;
    __pipeline_wait_prior(0);
    if constexpr (!SPEC) {
      // the training rows this thread copied, over the length scales
      for (int idx = tid; idx < ngp * d; idx += blockDim.x)
        T[idx] = T[idx] / ls[idx % d];
    }
    // tile t visible; every warp is done with tile t - 1's buffer
    __syncthreads();
    if (t + 1 < ntiles)
      k1_load(a, tiles + ((t + 1) & 1) * ts, base + g.tr,
              min(g.tr, hi - base - g.tr));
    const double* Wt = T + (size_t)g.tr * d;
    for (int u = warp; u < L * C; u += W) {
      const int c = u / L, qi = (u - c * L) * 32 + lane;
      const double* qpre = qs + qi;
      const double* qls = qs + d * QB + qi;
      // the slot's query in registers (d <= DQ): preprocessed (the SVM's
      // coordinates) and over the length scales (the GP's)
      double qp[DQ ? DQ : 1], qv[DQ ? DQ : 1];
      if constexpr (DQ > 0) {
#pragma unroll
        for (int k = 0; k < DQ; ++k) {
          qp[k] = k < d ? qpre[k * QB] : 0.0;
          qv[k] = k < d ? qls[k * QB] : 0.0;
        }
      }
      double acc = t ? ra[c * QB + qi] : 0.0;
      double dec = t ? rd[c * QB + qi] : 0.0;
      // the GP rows, four at a time (independent exponentials), added in
      // row order
      int j = c;
      for (; j + 3 * C < ngp; j += 4 * C) {
        double term[4];
#pragma unroll
        for (int v = 0; v < 4; ++v)
          term[v] = k1_gp_term<SPEC, DQ>(a, spec, variance, qv,
                                         SPEC ? qpre : qls, QB,
                                         T + (j + v * C) * d) *
                    Wt[j + v * C];
#pragma unroll
        for (int v = 0; v < 4; ++v) acc += term[v];
      }
      for (; j < ngp; j += C)
        acc += k1_gp_term<SPEC, DQ>(a, spec, variance, qv,
                                    SPEC ? qpre : qls, QB, T + j * d) *
               Wt[j];
      for (j = ngp + c; j < nt; j += C) {
        const double* xr = T + j * d;
        double sq = 0.0;
        if constexpr (DQ > 0) {
#pragma unroll
          for (int k = 0; k < DQ; ++k) {
            if (k < d) {
              const double df = qp[k] - xr[k];
              sq += df * df;
            }
          }
        } else {
          for (int k = 0; k < d; ++k) {
            const double df = qpre[k * QB] - xr[k];
            sq += df * df;
          }
        }
        dec += exp(-gamma * sq) * Wt[j];
      }
      ra[c * QB + qi] = acc;
      rd[c * QB + qi] = dec;
    }
  }

  // the partial sums meet: thread s (slot s) adds its chunks in order,
  // then rank 0 the ranks' in order
  __syncthreads();
  const bool active = tid < nlive;
  double A = 0.0, Cs = 0.0;
  if (active && ntiles > 0) {
    for (int c = 0; c < C; ++c) {
      A += ra[c * QB + tid];
      Cs += rd[c * QB + tid];
    }
  }
  if (g.cl > 1) {
    cg::cluster_group cluster = cg::this_cluster();
    if (active) {
      ra[tid] = A;
      rd[tid] = Cs;
    }
    cluster.sync();
    if (rank == 0 && active) {
      double pa[K1_MAX_CLUSTER], pd[K1_MAX_CLUSTER];
#pragma unroll
      for (int r = 1; r < K1_MAX_CLUSTER; ++r) {
        if (r < g.cl) {
          pa[r] = cluster.map_shared_rank(ra, r)[tid];
          pd[r] = cluster.map_shared_rank(rd, r)[tid];
        }
      }
#pragma unroll
      for (int r = 1; r < K1_MAX_CLUSTER; ++r) {
        if (r < g.cl) {
          A += pa[r];
          Cs += pd[r];
        }
      }
    }
  }
  if (rank == 0 && active) {
    const double mean = gpry_clip(A * a.scal[1] + a.scal[0], a.scal[2]);
    a.out[slot[tid]] =
        gpry_svm_finite(a.svm_mode, Cs, a.scal[3]) ? mean : -INFINITY;
  }
  // the other ranks' sums stay until rank 0 has read them
  if (g.cl > 1) cg::this_cluster().sync();
}

// K1's plan for nq queries against n training rows and nsv_eff support
// vectors (nsv when the SVM is fitted, else 0): out = qw, sw, cl, tr, dq.
extern "C" int gpry_gated_mean_plan(GpryKern kern, int nq, int n,
                                    int nsv_eff, int d, int* out,
                                    size_t* smem) {
  K1Plan p;
  const int e = k1_plan(nq, n + nsv_eff, d, gpry_spec_doubles(kern), &p);
  if (e) return e;
  out[0] = p.qw;
  out[1] = p.sw;
  out[2] = p.cl;
  out[3] = p.tr;
  out[4] = p.dq;
  *smem = p.smem;
  return 0;
}

// scal = [y_loc, y_scale, clip_max, svm intercept, svm gamma, y_max]
extern "C" int gpry_gated_mean(GpryKern kern, int nq, int n, int nsv, int d,
                               const void* Xq_raw, const void* X,
                               const void* alpha, const void* theta,
                               const void* x_loc, const void* x_scale,
                               const void* trust_lo, const void* trust_hi,
                               const void* sv, const void* dual,
                               const void* scal, int svm_mode, void* out,
                               void* stream) {
  if (nq <= 0) return 0;
  K1Args a;
  a.kern = kern;
  a.nq = nq;
  a.n = n;
  a.nsv = nsv;
  a.d = d;
  a.svm_mode = svm_mode;
  a.Xq_raw = (const double*)Xq_raw;
  a.X = (const double*)X;
  a.alpha = (const double*)alpha;
  a.theta = (const double*)theta;
  a.x_loc = (const double*)x_loc;
  a.x_scale = (const double*)x_scale;
  a.trust_lo = (const double*)trust_lo;
  a.trust_hi = (const double*)trust_hi;
  a.sv = (const double*)sv;
  a.dual = (const double*)dual;
  a.scal = (const double*)scal;
  a.out = (double*)out;
  const int nsv_eff = svm_mode == GPRY_MODE_FITTED ? nsv : 0;
  int err = k1_plan(nq, n + nsv_eff, d, gpry_spec_doubles(kern), &a.g);
  if (err) return err;
  auto kernel = kern.nodes     ? gated_mean_kernel<true, 0>
                : a.g.dq == 8  ? gated_mean_kernel<false, 8>
                : a.g.dq == 32 ? gated_mean_kernel<false, 32>
                               : gated_mean_kernel<false, 0>;
  cudaError_t e = gpry_set_smem(kernel, a.g.smem);
  if (e != cudaSuccess) return (int)e;
  cudaLaunchConfig_t cfg = {};
  const int qt = (nq + 31) / 32;
  cfg.gridDim = dim3((qt + a.g.qw - 1) / a.g.qw * a.g.cl);
  cfg.blockDim = dim3(32 * a.g.qw * a.g.sw);
  cfg.dynamicSmemBytes = a.g.smem;
  cfg.stream = (cudaStream_t)stream;
  cudaLaunchAttribute attr[1];
  if (a.g.cl > 1) {
    if (a.g.cl > K1_PORTABLE_CLUSTER) {
      e = cudaFuncSetAttribute(
          kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
      if (e != cudaSuccess) return (int)e;
    }
    attr[0].id = cudaLaunchAttributeClusterDimension;
    attr[0].val.clusterDim.x = a.g.cl;
    attr[0].val.clusterDim.y = 1;
    attr[0].val.clusterDim.z = 1;
    cfg.attrs = attr;
    cfg.numAttrs = 1;
  }
  e = cudaLaunchKernelEx(&cfg, kernel, a);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}
