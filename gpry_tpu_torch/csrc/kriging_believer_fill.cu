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
// Design: two kernels per round, launched back to back on one stream.
//  (a) gpry_kb_sweep: one warp per alive candidate, as K2
//      (gated_meanvar_logexp.cu): the candidate's k vector sits in shared
//      memory and each of the n sequential substitution steps is a warp
//      dot product with a contiguous row of L.  For LogExp (the default
//      acquisition) the epilogue, ac and the alive update happen in the
//      same pass; for any other acquisition function the sweep writes sd
//      and torch applies acqf.values and the alive update between (a)
//      and (b).  Dead candidates are skipped.
//  (b) gpry_kb_select: one block reduces the N (value, index) pairs to j,
//      writes the round's outputs, and appends row n of L in place (warp 0
//      runs the length-n substitution).  n lives in a device int32, so
//      the next round's sweep reads it without a host round trip.
//
// What bounds it on the H100.  The work is FP64: per conditioned round
// about N * n^2 / 2 multiply-adds of substitution plus N * n * (3d + 3)
// for the k vectors, 1.7e9 operations over the 7 conditioned rounds at
// bench.py's NORA shape (N = 4,096, n = 224-231, d = 8): 25 us at the
// card's 67 TFLOP/s FP64 peak; the bytes (the valid triangle of L and the
// candidates, each once) are 0.6 MB, 0.2 us at 3.35 TB/s.  Each
// substitution step depends on the one before, so a warp's chain of n
// dependent reductions, each reading one row of L, bounds the sweep
// (latency, not throughput), and the single-block append adds another
// length-n chain per round.  The design keeps the whole candidate set in
// one wave of warps (8 candidates per 256-thread block) and every round on
// the device; blocking several candidates per warp against one read of
// each L row, and a multi-warp append, are the next steps.
#include <limits.h>

#include "common.cuh"

#define K4_THREADS 256
#define K4_WARPS (K4_THREADS / 32)
#define K4_SEL_THREADS 512
#define K4_SEL_WARPS (K4_SEL_THREADS / 32)

__global__ void kb_sweep_kernel(
    int family, int out_logexp, int N, int nmax, int d, int Q,
    const int* __restrict__ n_dev, const double* __restrict__ Xq_,
    const double* __restrict__ y, const double* __restrict__ Xbuf,
    const double* __restrict__ L, const double* __restrict__ theta,
    const double* __restrict__ scal, double zeta, double noise_std,
    unsigned char* __restrict__ alive, double* __restrict__ out) {
  // shared layout: ls[d] | qls[Q][d] | kv[Q][nmax]
  extern __shared__ double smem[];
  double* ls = smem;
  double* qls = ls + d;
  double* kv = qls + (size_t)Q * d;

  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const int q0 = blockIdx.x * Q;
  const int nqb = min(Q, N - q0);
  const int n = *n_dev;

  for (int k = tid; k < d; k += blockDim.x) ls[k] = exp(theta[1 + k]);
  __syncthreads();
  const double variance = exp(theta[0]);
  for (int idx = tid; idx < nqb * d; idx += blockDim.x)
    qls[idx] = Xq_[(size_t)q0 * d + idx] / ls[idx % d];
  __syncthreads();

  // phase 1: k vectors of the block's alive candidates
  for (int idx = tid; idx < nqb * n; idx += blockDim.x) {
    const int qi = idx / n, j = idx - qi * n;
    if (!alive[q0 + qi]) continue;
    double sq = 0.0;
    for (int k = 0; k < d; ++k) {
      const double df = qls[qi * d + k] - Xbuf[(size_t)j * d + k] / ls[k];
      sq += df * df;
    }
    kv[(size_t)qi * nmax + j] = variance * gpry_k_of_sq(family, sq);
  }
  __syncthreads();

  const double y_scale = scal[1], y_max = scal[5];

  // phase 2: one warp per candidate
  for (int qi = warp; qi < nqb; qi += K4_WARPS) {
    const int q = q0 + qi;
    if (!alive[q]) {
      if (lane == 0) out[q] = out_logexp ? -INFINITY : 0.0;
      continue;
    }
    double* v = kv + (size_t)qi * nmax;
    const double sumsq = gpry_warp_forward_subst(L, nmax, n, v, lane);
    if (lane == 0) {
      const double var0 = variance - sumsq;
      const double var = (var0 < 0.0) ? 0.0 : var0;  // NaN stays NaN
      const double sd = sqrt(var) * y_scale;
      if (out_logexp) {
        const double var2 = sd * sd - noise_std * noise_std;
        const bool ok = (var2 > 0.0) && isfinite(y[q]);
        const double ac =
            ok ? 2.0 * zeta * (y[q] - y_max) + 0.5 * log(var2) : -INFINITY;
        out[q] = ac;
        if (!isfinite(ac)) alive[q] = 0;
      } else {
        out[q] = sd;
      }
    }
  }
}

// (value, index) order of jnp.argmax: larger value first, then the
// smaller index.
__device__ __forceinline__ bool kb_better(double v, int i, double bv,
                                          int bi) {
  return v > bv || (v == bv && i < bi);
}

__global__ void kb_select_kernel(
    int family, int N, int nmax, int d, int slot, int noise_is_vec,
    const double* __restrict__ Xd_raw, const double* __restrict__ Xq_,
    const double* __restrict__ y, const double* __restrict__ sigma,
    const double* __restrict__ acq0, const double* __restrict__ ac,
    unsigned char* __restrict__ alive, const double* __restrict__ theta,
    const double* __restrict__ noise, int* __restrict__ n_dev,
    double* __restrict__ Xbuf, double* __restrict__ L,
    double* __restrict__ outX, double* __restrict__ outY,
    double* __restrict__ outS, double* __restrict__ outA,
    double* __restrict__ outC) {
  // shared layout: ls[d] | kv[nmax]
  extern __shared__ double smem[];
  double* ls = smem;
  double* kv = ls + d;
  __shared__ double red_v[K4_SEL_WARPS];
  __shared__ int red_i[K4_SEL_WARPS];

  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;

  // masked argmax, first index on ties
  double bv = -INFINITY;
  int bi = INT_MAX;
  for (int i = tid; i < N; i += blockDim.x) {
    const double v = alive[i] ? ac[i] : -INFINITY;
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
  for (int k = tid; k < d; k += blockDim.x) ls[k] = exp(theta[1 + k]);
  __syncthreads();
  bv = red_v[0];
  bi = red_i[0];
  for (int w = 1; w < K4_SEL_WARPS; ++w)
    if (kb_better(red_v[w], red_i[w], bv, bi)) {
      bv = red_v[w];
      bi = red_i[w];
    }
  const int j = bi;
  const bool valid = isfinite(bv);

  for (int k = tid; k < d; k += blockDim.x)
    outX[(size_t)slot * d + k] = valid ? Xd_raw[(size_t)j * d + k] : 0.0;
  if (tid == 0) {
    outY[slot] = valid ? y[j] : 0.0;
    outS[slot] = valid ? sigma[j] : 0.0;
    outA[slot] = valid ? acq0[j] : -INFINITY;
    outC[slot] = valid ? bv : -INFINITY;
  }
  const int n = *n_dev;
  // every thread has read alive[] and n_dev before they are written
  __syncthreads();
  if (tid == 0 && j < N) alive[j] = 0;
  if (!valid || n >= nmax) return;

  // rank-1 Cholesky append of the believer row n
  const double variance = exp(theta[0]);
  for (int t = tid; t < n; t += blockDim.x) {
    double sq = 0.0;
    for (int k = 0; k < d; ++k) {
      const double df =
          Xbuf[(size_t)t * d + k] / ls[k] - Xq_[(size_t)j * d + k] / ls[k];
      sq += df * df;
    }
    kv[t] = variance * gpry_k_of_sq(family, sq);
  }
  __syncthreads();
  if (warp != 0) return;
  const double sumsq = gpry_warp_forward_subst(L, nmax, n, kv, lane);
  double* Ln = L + (size_t)n * nmax;
  for (int t = lane; t < n; t += 32) Ln[t] = kv[t];
  for (int k = lane; k < d; k += 32)
    Xbuf[(size_t)n * d + k] = Xq_[(size_t)j * d + k];
  if (lane == 0) {
    const double k22 = variance + (noise_is_vec ? noise[n] : noise[0]);
    double r = k22 - sumsq;
    r = (r < 1e-12) ? 1e-12 : r;  // NaN stays NaN
    Ln[n] = sqrt(r);
    *n_dev = n + 1;
  }
}

static size_t kb_sweep_smem(int nmax, int d, int Q) {
  return sizeof(double) *
         ((size_t)d + (size_t)Q * d + (size_t)Q * (size_t)nmax);
}

// scal = [y_loc, y_scale, clip_max, svm intercept, svm gamma, y_max]
extern "C" int gpry_kb_sweep(int family, int out_logexp, int N, int nmax,
                             int d, int Q, const void* n_dev,
                             const void* Xq_, const void* y,
                             const void* Xbuf, const void* L,
                             const void* theta, const void* scal,
                             double zeta, double noise_std, void* alive,
                             void* out, void* stream) {
  const size_t smem = kb_sweep_smem(nmax, d, Q);
  cudaError_t e = gpry_set_smem(kb_sweep_kernel, smem);
  if (e != cudaSuccess) return (int)e;
  if (N <= 0) return 0;
  const dim3 grid((N + Q - 1) / Q);
  kb_sweep_kernel<<<grid, K4_THREADS, smem, (cudaStream_t)stream>>>(
      family, out_logexp, N, nmax, d, Q, (const int*)n_dev,
      (const double*)Xq_, (const double*)y, (const double*)Xbuf,
      (const double*)L, (const double*)theta, (const double*)scal, zeta,
      noise_std, (unsigned char*)alive, (double*)out);
  return (int)cudaGetLastError();
}

extern "C" int gpry_kb_select(int family, int N, int nmax, int d, int slot,
                              int noise_is_vec, const void* Xd_raw,
                              const void* Xq_, const void* y,
                              const void* sigma, const void* acq0,
                              const void* ac, void* alive, const void* theta,
                              const void* noise, void* n_dev, void* Xbuf,
                              void* L, void* outX, void* outY, void* outS,
                              void* outA, void* outC, void* stream) {
  const size_t smem = sizeof(double) * ((size_t)d + (size_t)nmax);
  cudaError_t e = gpry_set_smem(kb_select_kernel, smem);
  if (e != cudaSuccess) return (int)e;
  kb_select_kernel<<<1, K4_SEL_THREADS, smem, (cudaStream_t)stream>>>(
      family, N, nmax, d, slot, noise_is_vec, (const double*)Xd_raw,
      (const double*)Xq_, (const double*)y, (const double*)sigma,
      (const double*)acq0, (const double*)ac, (unsigned char*)alive,
      (const double*)theta, (const double*)noise, (int*)n_dev,
      (double*)Xbuf, (double*)L, (double*)outX, (double*)outY,
      (double*)outS, (double*)outA, (double*)outC);
  return (int)cudaGetLastError();
}
