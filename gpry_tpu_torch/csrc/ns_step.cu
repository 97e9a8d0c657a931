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
// Design.  One block of 1,024 threads.  The reductions of the stop test
// are warp shuffles and one shared-memory step, every thread then summing
// the warps' partials in the same order.  The sort is a bitonic sort in
// shared memory over the next power of two P >= nlive (pads: NaN with an
// index >= nlive, so they sort last): log2(P) (log2(P) + 1) / 2 passes of
// P / 2 compare-exchanges, one barrier each; nlive <= 4,096 (50 d at d <=
// 64 and up to 4,096 live points) takes 48 KB.  The survivors' mean is a
// warp per coordinate and the covariance a warp per entry of the upper
// triangle, the lanes splitting the survivors; the Cholesky factor is
// left-looking, one column at a time (two barriers a column).
//
// What bounds it on the H100.  Latency: the ~78 barriers of the sort at
// nlive = 4,096 (45 at 400), the stop test's reductions over up to
// max_dead_tot dead entries, and the d column steps of the factor; the
// bytes it must move (the live set, the dead log-likelihoods below k and
// their volume constants, B dead points) take well under a microsecond at
// 3.35 TB/s (PERF.md).
#include "common.cuh"

#define K13_THREADS 1024
#define K13_WARPS (K13_THREADS / 32)
#define K13_MAX_NLIVE 4096

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

// Reduce v over the block; every thread returns the same value.  red:
// K13_WARPS doubles of shared memory.  Two barriers.
__device__ double k13_reduce(int op, double v, double* red) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  for (int off = 16; off > 0; off >>= 1)
    v = k13_op(op, v, __shfl_xor_sync(0xffffffffu, v, off));
  if (lane == 0) red[warp] = v;
  __syncthreads();
  double r = red[0];
  for (int w = 1; w < K13_WARPS; ++w) r = k13_op(op, r, red[w]);
  __syncthreads();
  return r;
}

// logsumexp of the n values f(i) over the block, as torch.logsumexp and
// JAX's logsumexp: the max, then log(sum exp(v - max)) + max with a max of
// +-inf taken as 0.
template <typename F>
__device__ double k13_logsumexp(int n, F f, double* red) {
  double m = -INFINITY;
  for (int i = threadIdx.x; i < n; i += K13_THREADS) m = k13_max(m, f(i));
  m = k13_reduce(K13_MAX, m, red);
  const double shift = isinf(m) ? 0.0 : m;
  double s = 0.0;
  for (int i = threadIdx.x; i < n; i += K13_THREADS) s += exp(f(i) - shift);
  s = k13_reduce(K13_SUM, s, red);
  return log(s) + shift;
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
               double* __restrict__ chol, const double* __restrict__ xs,
               const double* __restrict__ ls,
               const long long* __restrict__ cs,
               const long long* __restrict__ starts) {
  extern __shared__ double smem[];
  double* key = smem;              // P
  double* red = key + P;           // K13_WARPS
  double* mean = red + K13_WARPS;  // d
  double* L = mean + d;            // d x d, row-major
  int* idx = (int*)(L + (size_t)d * d);  // P
  __shared__ int bad;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  long long k = count[0], calls = count[1], steps = count[2];
  const bool pending = count[3] != 0;

  // 1. the pending kill
  if (pending) {
    for (int e = tid; e < B * d; e += K13_THREADS) {
      const int b = e / d, j = e - b * d;
      live_X[(size_t)kill[b] * d + j] = xs[e];
    }
    for (int b = tid; b < B; b += K13_THREADS) live_logl[kill[b]] = ls[b];
    long long c = 0;
    for (int b = 0; b < B; ++b) c += cs[b];
    k += B;
    calls += c;
    steps += 1;
  }
  if (tid == 0) bad = 0;
  __syncthreads();

  // 2. the stop test
  const double logz_d = k13_logsumexp(
      (int)k,
      [&](int i) { return dead_logl[i] + logx_prev[i] + log_shell[i]; },
      red);
  const double logx = -(H0 + ((double)k - (double)k0_dead) / nlive);
  const double logz_live =
      k13_logsumexp(nlive, [&](int i) { return live_logl[i]; }, red) -
      log((double)nlive) + logx;
  double logz_tot;
  if (isinf(logz_d) && logz_d == logz_live) {
    logz_tot = logz_d;
  } else {
    logz_tot = fmax(logz_d, logz_live) +
               log1p(exp(-fabs(logz_d - logz_live)));
  }
  const bool not_converged = (logz_live - logz_tot) > log_prec;
  double lmax = -INFINITY, lmin = INFINITY;
  for (int i = tid; i < nlive; i += K13_THREADS) {
    lmax = k13_max(lmax, live_logl[i]);
    lmin = k13_min(lmin, live_logl[i]);
  }
  lmax = k13_reduce(K13_MAX, lmax, red);
  lmin = k13_reduce(K13_MIN, lmin, red);
  const double spread = lmax - lmin;
  const bool plateau = (k - k0_dead > nlive) && isfinite(spread) &&
                       (spread < 1e-9 * fmax(fabs(lmax), 1.0));
  const bool go = (not_converged || isinf(logz_tot)) &&
                  (k + B <= max_dead_tot) && !plateau;
  const bool sel = go && select;

  // 3. the kill and the next chains' inputs
  if (sel) {
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
    // the survivors' mean: a warp per coordinate
    const int ns = nlive - B;
    for (int j = warp; j < d; j += K13_WARPS) {
      double sum = 0.0;
      for (int i = lane; i < ns; i += 32)
        sum += live_X[(size_t)idx[B + i] * d + j];
      sum = gpry_warp_sum(sum);
      if (lane == 0) mean[j] = sum / ns;
    }
    __syncthreads();
    // the covariance: a warp per entry of the upper triangle
    for (int e = warp; e < d * (d + 1) / 2; e += K13_WARPS) {
      int a = 0, rem = e;
      while (rem >= d - a) {
        rem -= d - a;
        ++a;
      }
      const int c = a + rem;
      double sum = 0.0;
      for (int i = lane; i < ns; i += 32) {
        const double* xi = live_X + (size_t)idx[B + i] * d;
        sum += (xi[a] - mean[a]) * (xi[c] - mean[c]);
      }
      sum = gpry_warp_sum(sum);
      if (lane == 0) {
        const double v = sum / ns + (a == c ? 1e-12 : 0.0);
        L[a * d + c] = v;
        L[c * d + a] = v;
      }
    }
    __syncthreads();
    // the Cholesky factor, left-looking, column j at a time
    for (int j = 0; j < d; ++j) {
      if (warp == 0) {
        double sq = 0.0;
        for (int m = lane; m < j; m += 32) sq += L[j * d + m] * L[j * d + m];
        sq = gpry_warp_sum(sq);
        if (lane == 0) {
          const double piv = L[j * d + j] - sq;
          if (!(piv > 0.0)) bad = 1;
          L[j * d + j] = sqrt(piv);
        }
      }
      __syncthreads();
      for (int i = j + 1 + tid; i < d; i += K13_THREADS) {
        double dot = 0.0;
        for (int m = 0; m < j; ++m) dot += L[i * d + m] * L[j * d + m];
        L[i * d + j] = (L[i * d + j] - dot) / L[j * d + j];
      }
      __syncthreads();
    }
    for (int e = tid; e < d * d; e += K13_THREADS) {
      const int r = e / d, c = e - r * d;
      chol[e] = bad ? NAN : (c <= r ? L[e] : 0.0);
    }
    // the chains' starts
    for (int e = tid; e < B * d; e += K13_THREADS) {
      const int b = e / d, j = e - b * d;
      x0[e] = live_X[(size_t)idx[B + starts[b]] * d + j];
    }
    for (int b = tid; b < B; b += K13_THREADS) lx0[b] = key[B + starts[b]];
  }
  if (tid == 0) {
    *done = !go;
    count[0] = k;
    count[1] = calls;
    count[2] = steps;
    count[3] = sel;
  }
}

// The live set (nlive, d) and its log-likelihoods, the dead buffer
// (max_dead_tot, d) and its log-likelihoods with the volume constants
// (max_dead_tot,) twice, count int64 [k, calls, steps, pending], done
// int32, kill int64 (B,), x0 (B, d), lx0 (B,), lstar, chol (d, d)
// row-major, the previous chains' xs (B, d), ls (B,), cs int64 (B,), and
// the starts int64 (B,) in [0, nlive - B); all updated in place.
extern "C" int gpry_ns_step(int nlive, int B, int d, int max_dead_tot,
                            int k0_dead, double H0, double log_prec,
                            int select, void* live_X, void* live_logl,
                            void* dead_X, void* dead_logl,
                            const void* logx_prev, const void* log_shell,
                            void* count, void* done, void* kill, void* x0,
                            void* lx0, void* lstar, void* chol,
                            const void* xs, const void* ls, const void* cs,
                            const void* starts, void* stream) {
  if (nlive > K13_MAX_NLIVE || B <= 0 || B >= nlive ||
      2 * d > GPRY_BLOCK_THREADS)
    return (int)cudaErrorInvalidValue;
  int P = 1;
  while (P < nlive) P <<= 1;
  const size_t smem = sizeof(double) * ((size_t)P + K13_WARPS + d +
                                        (size_t)d * d) +
                      sizeof(int) * (size_t)P;
  cudaError_t err = gpry_set_smem(ns_step_kernel, smem);
  if (err != cudaSuccess) return (int)err;
  ns_step_kernel<<<1, K13_THREADS, smem, (cudaStream_t)stream>>>(
      nlive, B, d, max_dead_tot, k0_dead, H0, log_prec, select, P,
      (double*)live_X, (double*)live_logl, (double*)dead_X,
      (double*)dead_logl, (const double*)logx_prev,
      (const double*)log_shell, (long long*)count, (int*)done,
      (long long*)kill, (double*)x0, (double*)lx0, (double*)lstar,
      (double*)chol, (const double*)xs, (const double*)ls,
      (const long long*)cs, (const long long*)starts);
  return (int)cudaGetLastError();
}
