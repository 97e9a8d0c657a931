// K13 ns_step: the bookkeeping of one nested-sampling outer step, in one
// launch of one block, with no host read.
//
// Replaces gpry_tpu/mc/nested.py:184 _ns_segment outside the slice chains:
// its `outer_cond` (:211-227) and `outer_body` (:229-275) but the vmapped
// _slice_chain, which is K6 (ns_slice_chains.cu).  In order:
//
//   1. apply: if a kill is pending, the previous step's chains (K6's
//      outputs xs, ls, cs) replace the killed live points (kill[b]),
//      k += B, calls += sum(cs), steps += 1;
//   2. the stop test, outer_cond, into the device flag `done`: the dead
//      buffer's log-weights (dead_logl + logx_prev) + log_shell summed as
//      a logsumexp over the entries below k (JAX's mask makes the others
//      -inf, which add exactly 0), the live logsumexp - log nlive + log X,
//      their logaddexp, the evidence-share test, the plateau test once
//      k - k0_dead > nlive, and the room test k + B <= max_dead_tot;
//   3. if not done and `select`: a stable ascending sort of the nlive
//      log-likelihoods as (logl, index) pairs (NaN last, ties by index: the
//      order of torch.argsort(stable=True) and jnp.argsort), the B worst
//      written to the dead buffer at k and their slots to kill, lstar the
//      B-th, the survivors' mean and covariance / (nlive - B) + 1e-12 I,
//      its d x d Cholesky factor (all NaN when a pivot is not positive, as
//      JAX's), and the chains' starts x0, lx0: survivor starts[b] of the
//      sorted order (pre-drawn on the host's generator); the kill is then
//      pending.
//
// A run queues `seg` steps (K13 then K6 each) and one more K13 with
// select = 0 per segment, and reads `done` once per segment: K6 returns at
// once when `done` is set, and K13 changes nothing then, so the steps
// queued after the stop are no-ops.  These are the semantics of
// ops/fused.py ns_step_plain.  K13 never evaluates the covariance
// function, so it has no spec instance.
//
// The live order.  A run's state carries `order`, the live slots in the
// sorted order above, or -1 in its first entry where that is not known (a
// run's first step, a crafted state).  The survivors of a kill keep their
// log-likelihoods, so after the apply they are still in order: only the B
// new points need a place.  With the order known and the pending kill its
// first B slots (kill[b] == order[b], checked), the apply ranks the new
// points among themselves (B comparisons each) and against the survivors
// (a binary search), and places each survivor by a binary search among the
// new points: a merge under the same total order, so the result is what a
// full stable sort gives, bit for bit.  A select takes that order, loads a
// known one, or sorts in full (the order unknown or inconsistent), and
// writes it back; an apply without a select writes the merged order, or
// marks it unknown.
//
// Design.  One block of 1,024 threads does the step, in a cluster of
// K13_CLUSTER = 8 blocks (one launch) whose other blocks only share the
// stop test's two passes over the k dead entries: each block reduces its
// share, and block 0 combines the blocks' maxima, then their sums, in rank
// order through its shared memory (a cluster barrier each).  A block
// reduction is a shuffle tree in each warp, then one over the warps'
// partials in warp 0; the maxima and minima of the stop test are one
// reduction and its sums another.  The full sort, where it is still
// needed, is a bitonic sort in shared memory over the next power of two P
// >= nlive (pads: NaN with an index >= nlive, so they sort last): log2(P)
// (log2(P) + 1) / 2 passes, one barrier each.  The merge takes three
// barriers: the new points ranked by a warp's ballots, each placed by a
// binary search.  The survivors' mean is a warp per coordinate, the lanes
// splitting the survivors staged in shared memory, and their covariance
// the Gram matrix of the centred rows in 8 x 8 tiles on the FP64 tensor
// cores (gpry_dmma).  The Cholesky factor is left-looking in shared
// memory by one warp (a lane a row, rows padded to d + 1 doubles against
// bank conflicts), with a warp barrier a column and no block barrier.
//
// What bounds it on the H100.  Latency: one block's barriers and the
// dependent global reads between them, the stop test's passes over the k
// dead entries, and the factor's d dependent columns; the bytes it must
// move (the live set, the dead log-likelihoods below k and their volume
// constants, B dead points) take well under a microsecond at 3.35 TB/s
// (PERF.md).
#include "common.cuh"

#define K13_THREADS 1024
#define K13_WARPS (K13_THREADS / 32)
#define K13_MAX_NLIVE 4096
// the blocks of the cluster that share the stop test's dead passes
#define K13_CLUSTER 8
// the most shares of the survivors a covariance tile is split into
#define K13_SPLITS 8
// shared memory for the survivors staged for their mean and covariance
#define K13_STAGE_BYTES (64 * 1024)

// The stable total order of the sort: NaN after every number, ties by
// index.
__device__ __forceinline__ bool k13_less(double va, int ia, double vb,
                                         int ib) {
  const bool na = isnan(va), nb = isnan(vb);
  if (na != nb) return nb;
  if (!na && va != vb) return va < vb;
  return ia < ib;
}

// NaN-propagating max / min, as torch.max / torch.min and jnp.max.
__device__ __forceinline__ double k13_max(double a, double b) {
  return (isnan(a) || a > b) ? a : b;
}
__device__ __forceinline__ double k13_min(double a, double b) {
  return (isnan(a) || a < b) ? a : b;
}

#define K13_SUM 0
#define K13_MAX 1
#define K13_MIN 2

__device__ __forceinline__ double k13_op(int op, double a, double b) {
  return op == K13_SUM ? a + b : op == K13_MAX ? k13_max(a, b) : k13_min(a, b);
}

// Reduce the NV values v[j] over the block, each by its op[j]: a
// shuffle tree in each warp, then one over the warps' partials in warp 0;
// every thread returns the same values.  red: NV * K13_WARPS doubles of
// shared memory.  Three barriers.
template <int NV>
__device__ void k13_reduce(const int (&op)[NV], double (&v)[NV],
                           double* red) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int j = 0; j < NV; ++j) {
    for (int off = 16; off > 0; off >>= 1)
      v[j] = k13_op(op[j], v[j], __shfl_xor_sync(0xffffffffu, v[j], off));
    if (lane == 0) red[j * K13_WARPS + warp] = v[j];
  }
  __syncthreads();
  if (warp == 0) {
#pragma unroll
    for (int j = 0; j < NV; ++j) {
      double r = red[j * K13_WARPS + lane];
      for (int off = 16; off > 0; off >>= 1)
        r = k13_op(op[j], r, __shfl_xor_sync(0xffffffffu, r, off));
      if (lane == 0) red[j * K13_WARPS] = r;
    }
  }
  __syncthreads();
#pragma unroll
  for (int j = 0; j < NV; ++j) v[j] = red[j * K13_WARPS];
  __syncthreads();
}

// The number of the m entries (ka, ia), sorted by k13_less, that sort
// before (v, i).
__device__ __forceinline__ int k13_rank(const double* ka, const int* ia,
                                        int m, double v, int i) {
  int lo = 0, hi = m;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (k13_less(ka[mid], ia[mid], v, i))
      lo = mid + 1;
    else
      hi = mid;
  }
  return lo;
}

// Doubles of the shared area that holds the merge's scratch (ns + 2 B
// doubles and as many ints), then the staged survivors.
__host__ __device__ inline size_t k13_area_doubles(int ns, int B) {
  const size_t merge = (size_t)ns + 2 * (size_t)B;
  const size_t stage = K13_STAGE_BYTES / sizeof(double);
  return merge + (merge + 1) / 2 > stage ? merge + (merge + 1) / 2 : stage;
}

// The stop test's passes over the dead buffer: block `rank` of the
// cluster takes entries rank K13_THREADS + tid, with a stride of the
// cluster's threads.  Returns this block's max (MAX) or its sum of exp(f -
// shift) (SUM) of the log-weights f = (dead_logl + logx_prev) + log_shell
// over the k entries, the same on every thread.  Two barriers.
__device__ double k13_dead_pass(int op, int rank, int k, double shift,
                                const double* __restrict__ dead_logl,
                                const double* __restrict__ logx_prev,
                                const double* __restrict__ log_shell,
                                double* red) {
  const int ops[1] = {op};
  double v[1] = {op == K13_MAX ? -INFINITY : 0.0};
#pragma unroll 4
  for (int i = rank * K13_THREADS + threadIdx.x; i < k;
       i += K13_CLUSTER * K13_THREADS) {
    const double f = dead_logl[i] + logx_prev[i] + log_shell[i];
    v[0] = op == K13_MAX ? k13_max(v[0], f) : v[0] + exp(f - shift);
  }
  k13_reduce(ops, v, red);
  return v[0];
}

__global__ void __launch_bounds__(K13_THREADS)
ns_step_kernel(int nlive, int B, int d, int max_dead_tot, int k0_dead,
               double H0, double log_prec, int select, int P,
               double* __restrict__ live_X, double* __restrict__ live_logl,
               double* __restrict__ dead_X, double* __restrict__ dead_logl,
               const double* __restrict__ logx_prev,
               const double* __restrict__ log_shell,
               long long* __restrict__ count, int* __restrict__ done,
               long long* __restrict__ kill, double* __restrict__ x0,
               double* __restrict__ lx0, double* __restrict__ lstar,
               double* __restrict__ chol, int* __restrict__ order,
               const double* __restrict__ xs, const double* __restrict__ ls,
               const long long* __restrict__ cs,
               const long long* __restrict__ starts) {
  extern __shared__ double smem[];
  const int ns = nlive - B, ld = d + 1;
  double* key = smem;                     // P: the live set in order
  double* red = key + P;                  // 3 K13_WARPS
  double* mean = red + 3 * K13_WARPS;     // d
  double* L = mean + d;                   // d x ld, row-major
  double* area = L + (size_t)d * ld;      // k13_area_doubles(ns, B)
  int* idx = (int*)(area + k13_area_doubles(ns, B));  // P
  // the area: the merge's scratch, then the survivors staged
  double* skey = area;                    // ns: the survivors in order
  double* nkey = skey + ns;               // B: the new points
  double* nsrt = nkey + B;                // B: the new points in order
  int* sidx = (int*)(nsrt + B);           // ns
  int* nidx = sidx + ns;                  // B
  int* nsrti = nidx + B;                  // B
  __shared__ int bad;
  __shared__ double xch[2 * K13_CLUSTER];  // rank 0: the blocks' shares
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  long long k = count[0], calls = count[1], steps = count[2];
  const bool pending = count[3] != 0;
  bool known = order != nullptr && order[0] >= 0;
  namespace cg = cooperative_groups;
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = (int)cluster.block_rank();
  double* xch0 = cluster.map_shared_rank(xch, 0);
  if (rank > 0) {
    // the other blocks' shares of the stop test's dead passes (entries
    // below k are not written by this launch before its second cluster
    // barrier; count only after it)
    const int kk = (int)(k + (pending ? B : 0));
    const double m = k13_dead_pass(K13_MAX, rank, kk, 0.0, dead_logl,
                                   logx_prev, log_shell, red);
    if (tid == 0) xch0[rank] = m;
    cluster.sync();
    double mx = xch0[0];
    for (int r = 1; r < K13_CLUSTER; ++r) mx = k13_max(mx, xch0[r]);
    const double sm = k13_dead_pass(K13_SUM, rank, kk, isinf(mx) ? 0.0 : mx,
                                    dead_logl, logx_prev, log_shell, red);
    if (tid == 0) xch0[K13_CLUSTER + rank] = sm;
    cluster.sync();
    return;
  }

  // 1. the pending kill
  if (pending) {
    for (int e = tid; e < B * d; e += K13_THREADS) {
      const int b = e / d, j = e - b * d;
      live_X[(size_t)kill[b] * d + j] = xs[e];
    }
    for (int b = tid; b < B; b += K13_THREADS) live_logl[kill[b]] = ls[b];
    if (warp == 0) {
      long long c = 0;
      for (int b = lane; b < B; b += 32) c += cs[b];
      for (int off = 16; off > 0; off >>= 1)
        c += __shfl_xor_sync(0xffffffffu, c, off);
      calls += c;  // read by thread 0
    }
    k += B;
    steps += 1;
  }
  // 1b. the live order
  bool sorted = false;  // key and idx hold the live set in order
  if (pending && known) {
    bool ok = true;
    for (int b = tid; b < B; b += K13_THREADS) {
      const int i = (int)kill[b];
      ok = ok && order[b] == i;
      nkey[b] = ls[b];
      nidx[b] = i;
    }
    for (int s = tid; s < ns; s += K13_THREADS) {
      const int i = order[B + s];
      sidx[s] = i;
      skey[s] = live_logl[i];
    }
    known = __syncthreads_and(ok);
    if (known) {
      // a new point's rank among the new ones: a warp's ballots
      for (int b = warp; b < B; b += K13_WARPS) {
        const double v = nkey[b];
        const int i = nidx[b];
        int r = 0;
        for (int c0 = 0; c0 < B; c0 += 32) {
          const int c = c0 + lane;
          r += __popc(__ballot_sync(
              0xffffffffu, c < B && k13_less(nkey[c], nidx[c], v, i)));
        }
        if (lane == 0) {
          nsrt[r] = v;
          nsrti[r] = i;
          const int pos = r + k13_rank(skey, sidx, ns, v, i);
          key[pos] = v;
          idx[pos] = i;
        }
      }
      __syncthreads();
      for (int s = tid; s < ns; s += K13_THREADS) {
        const int pos = s + k13_rank(nsrt, nsrti, B, skey[s], sidx[s]);
        key[pos] = skey[s];
        idx[pos] = sidx[s];
      }
      sorted = true;
    }
  }
  __syncthreads();

  // 2. the stop test: the dead passes shared by the cluster's blocks
  // (the maxima, then the sums, each block's share through rank 0's
  // shared memory in rank order), the live ones here
  const int ops3[3] = {K13_MAX, K13_MAX, K13_MIN};
  double ext[3] = {-INFINITY, -INFINITY, INFINITY};
#pragma unroll 4
  for (int i = tid; i < (int)k; i += K13_CLUSTER * K13_THREADS)
    ext[0] = k13_max(ext[0], dead_logl[i] + logx_prev[i] + log_shell[i]);
  for (int i = tid; i < nlive; i += K13_THREADS) {
    ext[1] = k13_max(ext[1], live_logl[i]);
    ext[2] = k13_min(ext[2], live_logl[i]);
  }
  k13_reduce(ops3, ext, red);
  if (tid == 0) xch[0] = ext[0];
  cluster.sync();
  for (int r = 1; r < K13_CLUSTER; ++r) ext[0] = k13_max(ext[0], xch[r]);
  const double shift_d = isinf(ext[0]) ? 0.0 : ext[0];
  const double shift_l = isinf(ext[1]) ? 0.0 : ext[1];
  const int ops2[2] = {K13_SUM, K13_SUM};
  double sum[2] = {0.0, 0.0};
#pragma unroll 4
  for (int i = tid; i < (int)k; i += K13_CLUSTER * K13_THREADS)
    sum[0] += exp(dead_logl[i] + logx_prev[i] + log_shell[i] - shift_d);
  for (int i = tid; i < nlive; i += K13_THREADS)
    sum[1] += exp(live_logl[i] - shift_l);
  k13_reduce(ops2, sum, red);
  if (tid == 0) xch[K13_CLUSTER] = sum[0];
  cluster.sync();
  for (int r = 1; r < K13_CLUSTER; ++r) sum[0] += xch[K13_CLUSTER + r];
  const double logz_d = log(sum[0]) + shift_d;
  const double logx = -(H0 + ((double)k - (double)k0_dead) / nlive);
  const double logz_live =
      log(sum[1]) + shift_l - log((double)nlive) + logx;
  double logz_tot;
  if (isinf(logz_d) && logz_d == logz_live) {
    logz_tot = logz_d;
  } else {
    logz_tot = fmax(logz_d, logz_live) +
               log1p(exp(-fabs(logz_d - logz_live)));
  }
  const bool not_converged = (logz_live - logz_tot) > log_prec;
  const double lmax = ext[1], lmin = ext[2];
  const double spread = lmax - lmin;
  const bool plateau = (k - k0_dead > nlive) && isfinite(spread) &&
                       (spread < 1e-9 * fmax(fabs(lmax), 1.0));
  const bool go = (not_converged || isinf(logz_tot)) &&
                  (k + B <= max_dead_tot) && !plateau;
  const bool sel = go && select;

  // 3. the kill and the next chains' inputs
  if (sel) {
    if (!sorted && known) {
      for (int i = tid; i < nlive; i += K13_THREADS) {
        const int s = order[i];
        idx[i] = s;
        key[i] = live_logl[s];
      }
    } else if (!sorted) {
      for (int i = tid; i < P; i += K13_THREADS) {
        key[i] = i < nlive ? live_logl[i] : NAN;
        idx[i] = i;
      }
      for (int size = 2; size <= P; size <<= 1) {
        for (int stride = size >> 1; stride > 0; stride >>= 1) {
          __syncthreads();
          for (int t = tid; t < P / 2; t += K13_THREADS) {
            const int i = 2 * stride * (t / stride) + (t % stride);
            const int j = i + stride;
            const bool up = (i & size) == 0;
            const bool swap = up ? k13_less(key[j], idx[j], key[i], idx[i])
                                 : k13_less(key[i], idx[i], key[j], idx[j]);
            if (swap) {
              const double kv = key[i];
              key[i] = key[j];
              key[j] = kv;
              const int iv = idx[i];
              idx[i] = idx[j];
              idx[j] = iv;
            }
          }
        }
      }
    }
    __syncthreads();
    // the dead points in ascending order, and their slots
    for (int e = tid; e < B * d; e += K13_THREADS) {
      const int b = e / d, j = e - b * d;
      dead_X[(size_t)(k + b) * d + j] = live_X[(size_t)idx[b] * d + j];
    }
    for (int b = tid; b < B; b += K13_THREADS) {
      dead_logl[k + b] = key[b];
      kill[b] = idx[b];
    }
    if (tid == 0) *lstar = key[B - 1];
    if (order != nullptr)
      for (int i = tid; i < nlive; i += K13_THREADS) order[i] = idx[i];
    // the survivors' mean: a warp per coordinate, the lanes splitting the
    // survivors, staged rc at a time in rows of sld doubles (the
    // coordinates padded with zeros to 8 nt, and 4 more against bank
    // conflicts); one chunk stays staged for the covariance
    const int nt = (d + 7) >> 3, sld = 8 * nt + 4;
    const int rc = (K13_STAGE_BYTES / (int)sizeof(double) / sld) & ~3;
    double* xv = area;  // rc x sld
    double msum[2] = {0.0, 0.0};
    for (int c0 = 0; c0 < ns; c0 += rc) {
      const int m = min(rc, ns - c0);
      __syncthreads();
#pragma unroll 4
      for (int e = tid; e < m * d; e += K13_THREADS) {
        const int r = e / d, j = e - r * d;
        xv[r * sld + j] = live_X[(size_t)idx[B + c0 + r] * d + j];
      }
      __syncthreads();
      for (int q = 0; q < 2; ++q) {
        const int j = warp + q * K13_WARPS;
        if (j < d)
          for (int i = lane; i < m; i += 32) msum[q] += xv[i * sld + j];
      }
    }
    for (int q = 0; q < 2; ++q) {
      const int j = warp + q * K13_WARPS;
      const double sum = gpry_warp_sum(msum[q]);
      if (j < d && lane == 0) mean[j] = sum / ns;
    }
    __syncthreads();
    // the covariance: the Gram matrix of the centred survivors in 8 x 8
    // tiles of its upper triangle on the FP64 tensor cores (gpry_dmma,
    // 4 survivors a step), a warp a tile and a share of the survivors
    // (splits shares where there are fewer tiles than warps); the shares
    // summed in order
    const int ntile = nt * (nt + 1) / 2;
    const int splits =
        ntile >= K13_WARPS ? 1 : min(K13_SPLITS, K13_WARPS / ntile);
    const int g = lane >> 2, t4 = lane & 3;
    int tile[2], ta[2], tc[2];
    for (int q = 0; q < 2; ++q) {
      tile[q] = ntile >= K13_WARPS ? warp + q * K13_WARPS
                                   : (q == 0 && warp < ntile * splits
                                          ? warp % ntile : ntile);
      int a = 0, rem = tile[q];
      while (a < nt && rem >= nt - a) {
        rem -= nt - a;
        ++a;
      }
      ta[q] = a;
      tc[q] = a + rem;
    }
    const int split = ntile >= K13_WARPS ? 0 : warp / ntile;
    double acc[2][2] = {{0.0, 0.0}, {0.0, 0.0}};
    for (int c0 = 0; c0 < ns; c0 += rc) {
      const int m = min(rc, ns - c0), m4 = (m + 3) & ~3;
      const bool staged = c0 == 0 && ns <= rc;
      if (!staged) __syncthreads();
#pragma unroll 4
      for (int e = tid; e < m4 * 8 * nt; e += K13_THREADS) {
        const int r = e / (8 * nt), j = e - r * 8 * nt;
        double v = 0.0;
        if (r < m && j < d)
          v = (staged ? xv[r * sld + j]
                      : live_X[(size_t)idx[B + c0 + r] * d + j]) - mean[j];
        xv[r * sld + j] = v;
      }
      __syncthreads();
      for (int q = 0; q < 2; ++q) {
        if (tile[q] >= ntile) continue;
        for (int k0 = 4 * split; k0 < m4; k0 += 4 * splits) {
          const double* row = xv + (k0 + t4) * sld;
          gpry_dmma(acc[q][0], acc[q][1], row[8 * ta[q] + g],
                    row[8 * tc[q] + g]);
        }
      }
    }
    __syncthreads();
    double* part = area;  // splits x ntile 8 x 8 tiles
    for (int q = 0; q < 2; ++q) {
      if (tile[q] >= ntile) continue;
      double* o =
          part + ((size_t)split * ntile + tile[q]) * 64 + g * 8 + 2 * t4;
      o[0] = acc[q][0];
      o[1] = acc[q][1];
    }
    __syncthreads();
    for (int e = tid; e < d * d; e += K13_THREADS) {
      const int a = e / d, c = e - a * d;  // row a >= column c
      if (c > a) continue;
      const int ca = c >> 3, aa = a >> 3;
      const int tl = ca * nt - ca * (ca - 1) / 2 + (aa - ca);
      double sum = 0.0;
      for (int sp = 0; sp < splits; ++sp)
        sum += part[((size_t)sp * ntile + tl) * 64 + (c & 7) * 8 + (a & 7)];
      L[a * ld + c] = sum / ns + (a == c ? 1e-12 : 0.0);
    }
    __syncthreads();
    // the Cholesky factor, left-looking by warp 0: column j's pivot on
    // every lane (the same sum), its rows below a lane each
    if (warp == 0) {
      bool neg = false;
      for (int j = 0; j < d; ++j) {
        const double* Lj = L + j * ld;
        double sq = 0.0;
        for (int m = 0; m < j; ++m) sq += Lj[m] * Lj[m];
        const double piv = Lj[j] - sq;
        neg = neg || !(piv > 0.0);
        const double ljj = sqrt(piv);
        for (int i = j + 1 + lane; i < d; i += 32) {
          double* Li = L + i * ld;
          double dot = 0.0;
          for (int m = 0; m < j; ++m) dot += Li[m] * Lj[m];
          Li[j] = (Li[j] - dot) / ljj;
        }
        __syncwarp();
        if (lane == 0) L[j * ld + j] = ljj;
      }
      if (lane == 0) bad = neg;
    }
    __syncthreads();
    for (int e = tid; e < d * d; e += K13_THREADS) {
      const int r = e / d, c = e - r * d;
      chol[e] = bad ? NAN : (c <= r ? L[r * ld + c] : 0.0);
    }
    // the chains' starts
    for (int e = tid; e < B * d; e += K13_THREADS) {
      const int b = e / d, j = e - b * d;
      x0[e] = live_X[(size_t)idx[B + starts[b]] * d + j];
    }
    for (int b = tid; b < B; b += K13_THREADS) lx0[b] = key[B + starts[b]];
  } else if (order != nullptr) {
    if (sorted) {
      for (int i = tid; i < nlive; i += K13_THREADS) order[i] = idx[i];
    } else if (pending && tid == 0) {
      order[0] = -1;
    }
  }
  if (tid == 0) {
    *done = !go;
    count[0] = k;
    count[1] = calls;
    count[2] = steps;
    count[3] = sel;
  }
}

// Bytes of shared memory K13 takes besides its area.
static size_t ns_step_fixed(int d, int P) {
  return sizeof(double) * ((size_t)P + 3 * K13_WARPS + d +
                           (size_t)d * (d + 1)) +
         sizeof(int) * (size_t)P;
}

// The live set (nlive, d) and its log-likelihoods, the dead buffer
// (max_dead_tot, d) and its log-likelihoods with the volume constants
// (max_dead_tot,) twice, count int64 [k, calls, steps, pending], done
// int32, kill int64 (B,), x0 (B, d), lx0 (B,), lstar, chol (d, d)
// row-major, the live order int32 (nlive,) (-1 first where unknown; may be
// null: no order kept), the previous chains' xs (B, d), ls (B,), cs int64
// (B,), and the starts int64 (B,) in [0, nlive - B); all updated in place.
extern "C" int gpry_ns_step(int nlive, int B, int d, int max_dead_tot,
                            int k0_dead, double H0, double log_prec,
                            int select, void* live_X, void* live_logl,
                            void* dead_X, void* dead_logl,
                            const void* logx_prev, const void* log_shell,
                            void* count, void* done, void* kill, void* x0,
                            void* lx0, void* lstar, void* chol, void* order,
                            const void* xs, const void* ls, const void* cs,
                            const void* starts, void* stream) {
  if (nlive > K13_MAX_NLIVE || B <= 0 || B >= nlive ||
      2 * d > GPRY_BLOCK_THREADS)
    return (int)cudaErrorInvalidValue;
  int P = 1;
  while (P < nlive) P <<= 1;
  const size_t smem = ns_step_fixed(d, P) +
                      sizeof(double) * k13_area_doubles(nlive - B, B);
  cudaError_t err = gpry_set_smem(ns_step_kernel, smem);
  if (err != cudaSuccess) return (int)err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(K13_CLUSTER);
  cfg.blockDim = dim3(K13_THREADS);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = (cudaStream_t)stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = K13_CLUSTER;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(
      &cfg, ns_step_kernel, nlive, B, d, max_dead_tot, k0_dead, H0, log_prec,
      select, P, (double*)live_X, (double*)live_logl, (double*)dead_X,
      (double*)dead_logl, (const double*)logx_prev,
      (const double*)log_shell, (long long*)count, (int*)done,
      (long long*)kill, (double*)x0, (double*)lx0, (double*)lstar,
      (double*)chol, (int*)order, (const double*)xs, (const double*)ls,
      (const long long*)cs, (const long long*)starts);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}
