// K12 mcmc_chains: every step of one phase of the adaptive Metropolis
// ensemble on the gated surrogate, for all B chains, in one launch.
//
// Replaces the scanned `phase` of gpry_tpu/mc/mcmc.py:44 run_mcmc_device
// (its step at :80-101, the two scans at :103-121), with the gated
// surrogate mean as the log-density (gpry_tpu/models/gp.py:121, K1's
// function) and -inf outside the prior box.  Per step i and chain b, from
// the pre-drawn z[i][b] (d normals) and u[i][b]:
//
//   prop = x_b + exp(log_step) (chol z[i][b])
//   lp_prop = gated mean at prop (-inf outside the prior box)
//   accept  = log u[i][b] < lp_prop - lp_b;  x_b, lp_b = prop, lp_prop if so
//
// and in the warm-up instance (adapt), after every step of all chains:
//
//   log_step += 0.05 (accepted / B - 0.234)      (Robbins-Monro)
//   s1 += sum_b x_b;  s2 += sum_b x_b x_b^T       (the moment sums)
//
// These are the semantics of ops/fused.py mcmc_chains_plain, the loop the
// port ran before; the draws come from the caller, so both versions see the
// same numbers.  The roundings that decide an accept or the step size are
// explicit (__dadd_rn, __dmul_rn, __dsub_rn, __ddiv_rn), so that the step
// size is bit-identical to the plain version's whenever the accept
// decisions are.
//
// Design.  The chains spread over SMs.  Chain b lives in block b % blocks
// (slot b / blocks); a block runs G groups of W warps, and a group runs
// its chains (slots g, g + G, ...) one step at a time.  Each block stages
// the surrogate in shared memory once (gpry_stage_surrogate; beyond
// shared memory the support vectors, then X / l as well, are read from a
// staged copy in global memory, as K6 reads them), with the proposal's
// Cholesky factor and the prior box.  The chains' states x and lp stay in
// shared memory for the whole phase (in the output buffers only where the
// plan cannot fit them); the visited states Xs and lps are stored and
// never read back between steps.  Each group's warp 0 reads the draws
// ahead: z[i][b] and u[i][b] of its next R steps go by cp.async into a
// ring in shared memory, so that no step waits on a global load.  An
// evaluation splits the n training rows and the support vectors over the
// group's W * 32 lanes (W by n + nsv and the block's chains: enough that
// a lane sums about one row, up to 8, while the block's chains all run at
// once in 16 warps; the warps' partial sums meet in shared memory, in warp
// order, behind a named barrier of the group).  A step is one dependent
// chain, and a warp alone on its SM hides none of its latency: at path
// d's n = 224, 8 warps a chain take 0.55-0.63x the time of one (PERF.md).
//
// * Sampling (adapt = 0): no coupling, so as many blocks as chains up to
//   K12_SAMPLE_BLOCKS (then a few chains a block), each chain's whole
//   trajectory with no block or cluster barrier.
// * Warm-up (adapt = 1): every step couples all chains through the step
//   size.  The launch is one thread-block cluster of up to 16 blocks (the
//   non-portable size above 8): the smallest power of two of blocks at or
//   above B, each block ceil(B / blocks) chains.  A block holds at most
//   the whole of an SM (GPRY_MAX_SMEM, 16 warps of 128 registers), and on
//   the H100 cudaOccupancyMaxActiveClusters schedules a cluster of 16 such
//   blocks at every shape of the range (PERF.md), so the plan needs no
//   smaller cluster.  After each step a group's warp 0 writes its accept
//   flag into every block's shared memory (remote stores through
//   distributed shared memory, two buffers by the step's parity), one
//   barrier.cluster arrive / wait, and every warp sums the B flags from
//   its own block's copy; so every thread holds the same log_step, bit
//   for bit the plain version's.  The moment sums do not steer the
//   chains, so no step computes them: after the last step the cluster's
//   blocks sum them from the visited states Xs (each
//   entry of s1 and of s2's upper triangle by one block, its steps split
//   over the block's threads in contiguous chunks and the chunks added in
//   order; per step the chains in order).  That order differs from the
//   plain version's x.sum(0) and x.T @ x: s1 and s2 agree with it to
//   rounding (rel ~1e-15 on the main path; the card tests and
//   chip_smoke.py hold 1e-12 of the largest entry).
//
// What bounds it on the H100.  Latency: per chain and step, one dependent
// chain of a d-term proposal, ~n / (32 W) kernel values a lane, two
// five-step shuffle trees and a log; the warm-up adds one cluster barrier
// a step.  The FP64 operations bound (the sums the inputs need, PERF.md)
// is microseconds for a whole phase.
//
// Spec mode (template SPEC): the staged surrogate holds X as it is plus the
// spec program, and each row runs the interpreter of common.cuh.
#include <cuda_pipeline.h>

#include "common.cuh"

// warps a block: 16, so that a thread may hold 128 registers (the step's
// loop spilled at 32 warps' 64)
#define K12_MAX_WARPS 16
// the warps of the design before this one, whose range K12 keeps
#define K12_RANGE_WARPS 32
#define K12_MAX_CLUSTER 16
#define K12_PORTABLE_CLUSTER 8
#define K12_SAMPLE_BLOCKS 128
#define K12_RING 16
#define K12_MAX_W 8

// The launch geometry of one phase (k12_plan; mirrored by ops/fused.py
// mcmc_chains_plan).
struct K12Geo {
  int blocks;      // the grid (the warm-up's cluster)
  int chains;      // chains of the fullest block
  int groups;      // groups a block, G
  int warps;       // warps a chain, W
  int ring;        // steps of draws read ahead, R
  int state_smem;  // the chains' x and lp in shared memory (1) or global
  int chol_smem;   // the proposal factor in shared memory (1) or global
  int stage;       // gpry_stage_plan of the surrogate
  size_t smem;     // bytes of dynamic shared memory
};

__host__ __device__ inline int k12_threads(const K12Geo& g) {
  return 32 * g.groups * g.warps;
}

// Doubles of one group's scratch: the ring, the proposal, its
// preprocessed and length-scaled coordinates, the warps' partial sums and
// the gate flag.
__host__ __device__ inline size_t k12_group_doubles(int d, int W, int R) {
  return (size_t)R * (d + 1) + 3 * (size_t)d + 2 * (size_t)W + 1;
}

// Doubles behind the staged surrogate: the evaluation scratch that
// gpry_stage_surrogate carves, the box, the factor, the groups, the
// chains' states, and (warm-up) the moment sums' chunk partials (a double
// a thread) and the accept flags (two buffers of B bytes).
static size_t k12_rest(const K12Geo& g, int B, int d, int adapt) {
  return gpry_eval_doubles(d) + 2 * (size_t)d +
         (g.chol_smem ? (size_t)d * d : 0) +
         (size_t)g.groups * k12_group_doubles(d, g.warps, g.ring) +
         (g.state_smem ? (size_t)g.chains * (d + 1) : 0) +
         (adapt ? (2 * (size_t)B + 7) / 8 + k12_threads(g) : 0);
}

// Warps a chain from the rows an evaluation sums (n + nsv_eff) and the
// block's chains: enough that a lane sums about one row (a step is a
// dependent chain: a warp alone on its SM hides nothing), up to K12_MAX_W,
// as long as the block's chains all run at once in K12_MAX_WARPS.
static inline int k12_warps_per_chain(int n, int nsv_eff, int chains) {
  int w = 1;
  while (w < K12_MAX_W && 32 * w < n + nsv_eff &&
         2 * w * chains <= K12_MAX_WARPS)
    w *= 2;
  return w;
}

// The geometry of one phase: B chains, n rows and nsv_eff support vectors
// at dimension d (a spec program of `spec` doubles).
// Shared memory: the ring as deep as K12_RING, the states and the factor
// in it; where that does not fit beside the smallest staging of the
// surrogate, the ring shrinks to 1, then the states (at tens of thousands
// of chains) and then the factor (d above ~150) go to global memory.
// Returns 0, or 1 where nothing fits (the range gate,
// gpry_mcmc_chains_min_smem, refuses such shapes first).
static int k12_plan(int B, int n, int nsv_eff, int d, size_t spec, int adapt,
                    K12Geo* g) {
  if (adapt) {
    g->blocks = 1;
    while (g->blocks < B && g->blocks < K12_MAX_CLUSTER) g->blocks *= 2;
  } else {
    const int per = (B + K12_SAMPLE_BLOCKS - 1) / K12_SAMPLE_BLOCKS;
    g->blocks = (B + per - 1) / per;
  }
  g->chains = (B + g->blocks - 1) / g->blocks;
  g->warps = k12_warps_per_chain(n, nsv_eff, g->chains);
  // (a group of W > 1 warps syncs on named barrier 1 + g: at most 8)
  const int gmax = K12_MAX_WARPS / g->warps;
  g->groups = g->chains < gmax ? g->chains : gmax;
  g->ring = K12_RING;
  g->state_smem = 1;
  g->chol_smem = 1;
  const size_t cap = GPRY_MAX_SMEM / sizeof(double);
  const size_t base = gpry_staged_doubles(0, 0, d, spec);
  while (base + k12_rest(*g, B, d, adapt) > cap) {
    if (g->ring > 1) g->ring /= 2;
    else if (g->state_smem) g->state_smem = 0;
    else if (g->chol_smem) g->chol_smem = 0;
    else return 1;
  }
  const size_t rest = k12_rest(*g, B, d, adapt);
  g->stage = gpry_stage_plan(n, nsv_eff, d, spec, rest);
  g->smem = gpry_stage_smem(g->stage, n, nsv_eff, d, spec, rest);
  return 0;
}

struct K12Args {
  GpryKern kern;
  int B, nsteps, n, nsv, d, svm_mode;
  K12Geo g;
  const double *x0, *lp0, *log_step0, *chol_g, *box_lo, *box_hi, *z, *u;
  const double *X, *alpha, *theta, *x_loc, *x_scale, *trust_lo, *trust_hi,
      *sv, *dual, *scal;
  const double *g_xt, *g_svt;
  double *x, *lp, *log_step_out, *s1, *s2, *Xs, *lps;
};

// Wait until at most R - 1 groups of copies are pending (the ring's R).
template <int N>
__device__ __forceinline__ void k12_wait_group() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ void k12_wait_ring(int R) {
  switch (R) {
    case 16: k12_wait_group<15>(); break;
    case 8: k12_wait_group<7>(); break;
    case 4: k12_wait_group<3>(); break;
    case 2: k12_wait_group<1>(); break;
    default: k12_wait_group<0>(); break;
  }
}

struct K12Group {
  double *ring, *prop, *qpre, *qls, *red, *ok;
  int g, wg, gt, lane, W;
};

__device__ __forceinline__ void k12_group_sync(const K12Group& w) {
  if (w.W == 1) {
    __syncwarp();
  } else {
    asm volatile("bar.sync %0, %1;" ::"r"(1 + w.g), "r"(32 * w.W)
                 : "memory");
  }
}

// The group's place in its sequence of (step, chain) entries: the warm-up
// runs t = i Cg + ci (every chain of the group a step), the sampling phase
// t = ci nsteps + i (a chain's whole trajectory); slot = t % R.
struct K12Cursor {
  int i, ci, slot;
};

template <bool ADAPT>
__device__ __forceinline__ void k12_advance(K12Cursor& c, int Cg, int nsteps,
                                            int R) {
  if (ADAPT) {
    if (++c.ci == Cg) {
      c.ci = 0;
      ++c.i;
    }
  } else if (++c.i == nsteps) {
    c.i = 0;
    ++c.ci;
  }
  c.slot = (c.slot + 1) & (R - 1);
}

// The draws of step i, chain b into the ring's slot, by warp 0's lanes (8
// bytes each: z[i][b][0..d) and u[i][b]); every lane commits a group of
// copies, empty or not.
__device__ __forceinline__ void k12_fetch(const K12Args& a, const K12Group& w,
                                          bool any, int i, int b, int slot) {
  const int d = a.d;
  if (any) {
    double* dst = w.ring + (size_t)slot * (d + 1);
    const double* zr = a.z + ((size_t)i * a.B + b) * d;
    for (int e = w.lane; e <= d; e += 32)
      __pipeline_memcpy_async(dst + e,
                              e < d ? zr + e : a.u + (size_t)i * a.B + b,
                              sizeof(double));
  }
  __pipeline_commit();
}

// The gated mean at the group's proposal (its coordinates in qpre / qls,
// the gate in *ok, visible to the group), by the group's W warps: the
// lanes split the rows and the support vectors; warp 0 gets the value.
template <bool SPEC>
__device__ __forceinline__ double k12_group_mean(const GprySurrogate& s,
                                                 const GprySpec& spec,
                                                 const K12Group& w) {
  const int d = s.d, stride = 32 * w.W;
  double a = 0.0, c = 0.0;
  if (*w.ok != 0.0) {
    for (int j = w.gt; j < s.n; j += stride) {
      const double al = s.alpha[j];
      if constexpr (SPEC) {
        a += gpry_spec_cov(spec, w.qls, 1, s.Xt + j, s.n, d) * al;
      } else {
        double sq = 0.0;
        for (int k = 0; k < d; ++k) {
          const double f = w.qls[k] - s.Xt[(size_t)k * s.n + j];
          sq += f * f;
        }
        a += (s.variance * gpry_k_of_sq(s.family, sq)) * al;
      }
    }
    for (int j = w.gt; j < s.nsv; j += stride) {
      double sq = 0.0;
      for (int k = 0; k < d; ++k) {
        const double f = w.qpre[k] - s.svt[(size_t)k * s.nsv + j];
        sq += f * f;
      }
      c += exp(-s.gamma * sq) * s.dual[j];
    }
  }
  a = gpry_warp_sum(a);
  c = gpry_warp_sum(c);
  if (w.W > 1) {
    if (w.lane == 0) {
      w.red[2 * w.wg] = a;
      w.red[2 * w.wg + 1] = c;
    }
    k12_group_sync(w);
    if (w.wg != 0) return 0.0;
    a = 0.0;
    c = 0.0;
    for (int v = 0; v < w.W; ++v) {
      a += w.red[2 * v];
      c += w.red[2 * v + 1];
    }
  }
  if (*w.ok == 0.0) return -INFINITY;
  const double m = gpry_clip(a * s.y_scale + s.y_loc, s.clip_max);
  return gpry_svm_finite(s.svm_mode, c, s.intercept) ? m : -INFINITY;
}

// One Metropolis step of chain b (state xb, *lpb) at step i, its draws in
// the ring's slot, by the group's W warps; returns the accept decision on
// warp 0 (false elsewhere).  Warp 0 waits for the draws, proposes and
// gates (log u on the side); the group evaluates; warp 0 decides, stores
// the state and the visited state, and refills the slot with the draws of
// the entry R ahead (step i_next, chain b_next) if there is one.
template <bool SPEC>
__device__ __forceinline__ bool k12_step(const K12Args& a,
                                         const GprySurrogate& s,
                                         const GprySpec& spec,
                                         const K12Group& w,
                                         const double* chol,
                                         const double* lo, const double* hi,
                                         double es, int i, int b, double* xb,
                                         double* lpb, int slot, bool more,
                                         int i_next, int b_next) {
  const int d = a.d;
  const double* zr = w.ring + (size_t)slot * (d + 1);
  double lu = 0.0;
  if (w.wg == 0) {
    k12_wait_ring(a.g.ring);
    __syncwarp();
    lu = log(zr[d]);
    bool ok = s.svm_mode != GPRY_MODE_NONE_FINITE;
    for (int k = w.lane; k < d; k += 32) {
      double acc = 0.0;
      for (int j = 0; j < d; ++j) acc += zr[j] * chol[(size_t)k * d + j];
      const double v = __dadd_rn(xb[k], __dmul_rn(es, acc));
      w.prop[k] = v;
      ok = ok && (v >= s.trust_lo[k]) && (v <= s.trust_hi[k]) &&
           (v >= lo[k]) && (v <= hi[k]);
      const double xp = (v - s.x_loc[k]) / s.x_scale[k];
      w.qpre[k] = xp;
      w.qls[k] = xp / s.ls[k];
    }
    ok = __all_sync(0xffffffffu, ok);
    if (w.lane == 0) *w.ok = ok ? 1.0 : 0.0;
  }
  k12_group_sync(w);
  const double lpp = k12_group_mean<SPEC>(s, spec, w);
  if (w.wg != 0) return false;
  const double lp_b = *lpb;
  const bool accept = lu < __dsub_rn(lpp, lp_b);
  for (int k = w.lane; k < d; k += 32) {
    const double v = accept ? w.prop[k] : xb[k];
    xb[k] = v;
    a.Xs[((size_t)i * a.B + b) * d + k] = v;
  }
  __syncwarp();
  if (w.lane == 0) {
    const double v = accept ? lpp : lp_b;
    *lpb = v;
    a.lps[(size_t)i * a.B + b] = v;
  }
  __syncwarp();
  k12_fetch(a, w, more, i_next, b_next, slot);
  return accept;
}

// The moment sums of the warm-up from its visited states (after the last
// step's cluster barrier): entry e of s1 (e < d) or of s2's upper triangle
// by block e % blocks, its steps in blockDim contiguous chunks, each chunk
// summed step by step (the chains in order within a step), the chunks
// added in order by thread 0.
__device__ void k12_moments(const K12Args& a, int rank, double* part) {
  const int d = a.d, B = a.B, tid = threadIdx.x, nt = blockDim.x;
  const int E = d + d * (d + 1) / 2;
  const int per = (a.nsteps + nt - 1) / nt;
  const int i0 = min(a.nsteps, tid * per), i1 = min(a.nsteps, i0 + per);
  for (int e = rank; e < E; e += a.g.blocks) {
    int r = e, c = e;
    if (e >= d) {
      int q = e - d;
      r = 0;
      while (q >= d - r) {
        q -= d - r;
        ++r;
      }
      c = r + q;
    }
    double acc = 0.0;
    for (int i = i0; i < i1; ++i) {
      const double* xi = a.Xs + (size_t)i * B * d;
      double st = 0.0;
      for (int b = 0; b < B; ++b)
        st += e < d ? xi[(size_t)b * d + r]
                    : xi[(size_t)b * d + r] * xi[(size_t)b * d + c];
      acc += st;
    }
    part[tid] = acc;
    __syncthreads();
    if (tid == 0) {
      double tot = 0.0;
      for (int v = 0; v < nt; ++v) tot += part[v];
      if (e < d) {
        a.s1[e] = tot;
      } else {
        a.s2[(size_t)r * d + c] = tot;
        a.s2[(size_t)c * d + r] = tot;
      }
    }
    __syncthreads();
  }
}

template <bool SPEC, bool ADAPT>
__global__ void __launch_bounds__(K12_MAX_WARPS * 32)
mcmc_chains_kernel(K12Args a) {
  extern __shared__ double smem[];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int d = a.d, B = a.B, nb = a.g.blocks, G = a.g.groups;
  const int W = a.g.warps, Cb = a.g.chains, nt = blockDim.x;
  const int rank = blockIdx.x;  // the cluster's block rank (warm-up)
  GpryEvalScratch sc;
  GprySpec spec;
  const GprySurrogate s = gpry_stage_surrogate<SPEC>(
      smem, &sc, a.kern, a.n, a.nsv, d, a.X, a.alpha, a.theta, a.x_loc,
      a.x_scale, a.trust_lo, a.trust_hi, a.sv, a.dual, a.scal, a.svm_mode,
      a.g_xt, a.g_svt, &spec);
  // behind the staged surrogate: the box, the factor, the groups, the
  // states, (warm-up) the moment partials and the accept flags
  double* lo = sc.tail;
  double* hi = lo + d;
  double* chol = hi + d;
  double* grp = chol + (a.g.chol_smem ? (size_t)d * d : 0);
  double* xst = grp + (size_t)G * k12_group_doubles(d, W, a.g.ring);
  double* lpst = xst + (a.g.state_smem ? (size_t)Cb * d : 0);
  double* part = lpst + (a.g.state_smem ? Cb : 0);
  unsigned char* flags = (unsigned char*)(part + nt);  // [2][B]
  if (!a.g.state_smem) {
    xst = nullptr;
    lpst = nullptr;
  }
  if (!a.g.chol_smem) chol = (double*)a.chol_g;
  const int mine = rank < B ? (B - rank + nb - 1) / nb : 0;  // its chains
  for (int k = tid; k < d; k += nt) {
    lo[k] = a.box_lo[k];
    hi[k] = a.box_hi[k];
  }
  if (a.g.chol_smem)
    for (int e = tid; e < d * d; e += nt) chol[e] = a.chol_g[e];
  for (int e = tid; e < mine * d; e += nt) {
    const int sl = e / d, k = e - sl * d, b = sl * nb + rank;
    const double v = a.x0[(size_t)b * d + k];
    if (xst) xst[e] = v;
    else a.x[(size_t)b * d + k] = v;
  }
  for (int sl = tid; sl < mine; sl += nt) {
    const int b = sl * nb + rank;
    if (lpst) lpst[sl] = a.lp0[b];
    else a.lp[b] = a.lp0[b];
  }
  if (!ADAPT && rank == 0)
    for (int e = tid; e < d + d * d; e += nt) {
      if (e < d) a.s1[e] = 0.0;
      else a.s2[e - d] = 0.0;
    }
  __syncthreads();

  K12Group w;
  w.g = warp / W;
  w.wg = warp - w.g * W;
  w.gt = w.wg * 32 + lane;
  w.lane = lane;
  w.W = W;
  w.ring = grp + (size_t)w.g * k12_group_doubles(d, W, a.g.ring);
  w.prop = w.ring + (size_t)a.g.ring * (d + 1);
  w.qpre = w.prop + d;
  w.qls = w.qpre + d;
  w.red = w.qls + d;
  w.ok = w.red + 2 * W;
  // the group's chains: slots g, g + G, ...
  const int Cg = w.g < mine ? (mine - w.g + G - 1) / G : 0;
  const int T = Cg * a.nsteps, R = a.g.ring;
  auto chain_of = [&](int ci) { return (w.g + ci * G) * nb + rank; };
  // the entry the ring refills next (R ahead of the step)
  K12Cursor ahead{0, 0, 0};
  if (w.wg == 0)
    for (int t = 0; t < R; ++t) {
      k12_fetch(a, w, t < T, ahead.i, t < T ? chain_of(ahead.ci) : 0,
                ahead.slot);
      k12_advance<ADAPT>(ahead, Cg, a.nsteps, R);
    }
  double log_step = *a.log_step0;
  int t = 0;
  auto run = [&](int i, int ci, double es) {
    const int b = chain_of(ci), sl = w.g + ci * G;
    double* xb = xst ? xst + (size_t)sl * d : a.x + (size_t)b * d;
    double* lpb = lpst ? lpst + sl : a.lp + b;
    const bool more = t + R < T;
    const bool acc =
        k12_step<SPEC>(a, s, spec, w, chol, lo, hi, es, i, b, xb, lpb,
                       t & (R - 1), more, ahead.i,
                       more ? chain_of(ahead.ci) : 0);
    k12_advance<ADAPT>(ahead, Cg, a.nsteps, R);
    ++t;
    return acc;
  };

  if constexpr (ADAPT) {
    namespace cg = cooperative_groups;
    cg::cluster_group cluster = cg::this_cluster();
    for (int i = 0; i < a.nsteps; ++i) {
      const double es = exp(log_step);
      const int par = i & 1;
      for (int ci = 0; ci < Cg; ++ci) {
        const bool acc = run(i, ci, es);
        // the flag into every block's copy (remote stores; the cluster
        // barrier makes them visible)
        if (w.wg == 0 && lane < nb)
          cluster.map_shared_rank(flags, lane)[par * B + chain_of(ci)] = acc;
      }
      cluster.sync();
      // the B accept flags, from this block's copy, in every warp
      int cnt = 0;
      for (int b = lane; b < B; b += 32) cnt += flags[par * B + b];
      cnt = __reduce_add_sync(0xffffffffu, cnt);
      log_step = __dadd_rn(
          log_step,
          __dmul_rn(0.05, __dsub_rn(__ddiv_rn((double)cnt, (double)B),
                                    0.234)));
    }
    k12_moments(a, rank, part);
  } else {
    const double es = exp(log_step);
    for (int ci = 0; ci < Cg; ++ci)
      for (int i = 0; i < a.nsteps; ++i) run(i, ci, es);
  }
  if (w.wg == 0) __pipeline_wait_prior(0);
  __syncthreads();
  if (xst)
    for (int e = tid; e < mine * d; e += nt) {
      const int sl = e / d, k = e - sl * d;
      a.x[(size_t)(sl * nb + rank) * d + k] = xst[e];
    }
  if (lpst)
    for (int sl = tid; sl < mine; sl += nt) a.lp[sl * nb + rank] = lpst[sl];
  if (rank == 0 && tid == 0) *a.log_step_out = log_step;
}

// The range of the design before this one (one block, a warp a chain, the
// states in global memory), which this one keeps: shared memory for the
// smallest staging, its evaluation scratch, chol, the box, three
// d-vectors a warp (min(B, 32) warps) and the accept flags.  Bytes; beyond
// GPRY_MAX_SMEM the wrapper raises (d above 125 at 32 or more
// chains, 163 at one).
extern "C" size_t gpry_mcmc_chains_min_smem(GpryKern kern, int B, int d) {
  const int warps = B < K12_RANGE_WARPS ? B : K12_RANGE_WARPS;
  return sizeof(double) *
         (gpry_staged_doubles(0, 0, d, gpry_spec_doubles(kern)) +
          gpry_eval_doubles(d) + (size_t)d * d + 2 * (size_t)d +
          3 * (size_t)d * warps + ((size_t)B + 1) / 2);
}

// The geometry k12_plan gives (out: blocks, chains, groups, warps, ring,
// state_smem, chol_smem, stage; *smem the bytes); returns k12_plan's code.
extern "C" int gpry_mcmc_chains_plan(GpryKern kern, int B, int n, int nsv,
                                     int d, int svm_mode, int adapt, int* out,
                                     size_t* smem) {
  const int nsv_eff = svm_mode == GPRY_MODE_FITTED ? nsv : 0;
  K12Geo g;
  const int rc =
      k12_plan(B, n, nsv_eff, d, gpry_spec_doubles(kern), adapt, &g);
  if (rc) return rc;
  const int v[8] = {g.blocks, g.chains,    g.groups,    g.warps,
                    g.ring,   g.state_smem, g.chol_smem, g.stage};
  for (int k = 0; k < 8; ++k) out[k] = v[k];
  *smem = g.smem;
  return 0;
}

// Doubles of global memory K12 needs for a surrogate of n valid rows and
// nsv support vectors (0 when it fits in shared memory): the more that
// either phase stages there.
extern "C" size_t gpry_mcmc_chains_work(GpryKern kern, int B, int n, int nsv,
                                        int d, int svm_mode) {
  const int nsv_eff = svm_mode == GPRY_MODE_FITTED ? nsv : 0;
  const size_t spec = gpry_spec_doubles(kern);
  size_t most = 0;
  for (int adapt = 0; adapt < 2; ++adapt) {
    K12Geo g;
    if (k12_plan(B, n, nsv_eff, d, spec, adapt, &g)) continue;
    const size_t need = gpry_stage_work(g.stage, n, nsv_eff, d);
    most = need > most ? need : most;
  }
  return most;
}

// x (B, d), lp (B,), log_step a device scalar, chol (d, d) row-major, the
// box (d,) twice, z (nsteps, B, d), u (nsteps, B); outputs x (B, d), lp
// (B,), log_step, s1 (d,), s2 (d, d) (zero unless adapt), the visited
// states X (nsteps, B, d) and lp (nsteps, B).  scal as K1's.  work:
// gpry_mcmc_chains_work doubles of device memory (may be null when that is
// 0).
extern "C" int gpry_mcmc_chains(
    GpryKern kern, int B, int nsteps, int n, int nsv, int d, int adapt,
    const void* x0, const void* lp0,
    const void* log_step, const void* chol, const void* lo, const void* hi,
    const void* z, const void* u, const void* X, const void* alpha,
    const void* theta, const void* x_loc, const void* x_scale,
    const void* trust_lo, const void* trust_hi, const void* sv,
    const void* dual, const void* scal, int svm_mode, void* work,
    void* x_out, void* lp_out, void* log_step_out, void* s1, void* s2,
    void* Xs, void* lps, void* stream) {
  if (B <= 0 || nsteps <= 0) return 0;
  if (gpry_mcmc_chains_min_smem(kern, B, d) > GPRY_MAX_SMEM)
    return (int)cudaErrorInvalidValue;
  const int nsv_eff = svm_mode == GPRY_MODE_FITTED ? nsv : 0;
  const size_t spec = gpry_spec_doubles(kern);
  K12Args a;
  if (k12_plan(B, n, nsv_eff, d, spec, adapt, &a.g))
    return (int)cudaErrorInvalidValue;
  double *g_xt, *g_svt;
  cudaError_t err = gpry_stage_global(a.g.stage, kern, n, nsv_eff, d, X, theta, sv, work,
                          &g_xt, &g_svt, (cudaStream_t)stream);
  if (err != cudaSuccess) return (int)err;
  a.kern = kern;
  a.B = B;
  a.nsteps = nsteps;
  a.n = n;
  a.nsv = nsv;
  a.d = d;
  a.svm_mode = svm_mode;
  a.x0 = (const double*)x0;
  a.lp0 = (const double*)lp0;
  a.log_step0 = (const double*)log_step;
  a.chol_g = (const double*)chol;
  a.box_lo = (const double*)lo;
  a.box_hi = (const double*)hi;
  a.z = (const double*)z;
  a.u = (const double*)u;
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
  a.g_xt = g_xt;
  a.g_svt = g_svt;
  a.x = (double*)x_out;
  a.lp = (double*)lp_out;
  a.log_step_out = (double*)log_step_out;
  a.s1 = (double*)s1;
  a.s2 = (double*)s2;
  a.Xs = (double*)Xs;
  a.lps = (double*)lps;
  const bool is_spec = kern.nodes > 0;
  auto kernel = adapt ? (is_spec ? mcmc_chains_kernel<true, true>
                                 : mcmc_chains_kernel<false, true>)
                      : (is_spec ? mcmc_chains_kernel<true, false>
                                 : mcmc_chains_kernel<false, false>);
  err = gpry_set_smem(kernel, a.g.smem);
  if (err != cudaSuccess) return (int)err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(a.g.blocks);
  cfg.blockDim = dim3(k12_threads(a.g));
  cfg.dynamicSmemBytes = a.g.smem;
  cfg.stream = (cudaStream_t)stream;
  cudaLaunchAttribute attr[1];
  if (adapt) {
    if (a.g.blocks > K12_PORTABLE_CLUSTER) {
      err = cudaFuncSetAttribute(
          kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
      if (err != cudaSuccess) return (int)err;
    }
    attr[0].id = cudaLaunchAttributeClusterDimension;
    attr[0].val.clusterDim.x = a.g.blocks;
    attr[0].val.clusterDim.y = 1;
    attr[0].val.clusterDim.z = 1;
    cfg.attrs = attr;
    cfg.numAttrs = 1;
  }
  err = cudaLaunchKernelEx(&cfg, kernel, a);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}
