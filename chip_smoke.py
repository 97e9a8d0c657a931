#!/usr/bin/env python3
"""
Drive gpry_tpu_torch once on one CUDA card.

1. Build the fourteen CUDA kernels (K1 gated_mean, K2
   gated_meanvar_logexp, K3 masked_kernel_matrix_batched, K4
   kriging_believer_fill, K5 meanvar_ungated, K6 ns_slice_chains, K7
   predict_meancov, K8 meanstd_grad, K9 lbfgs_logexp_ascent, K10
   lml_value_grad, K11 lbfgs_lml_fit, K12 mcmc_chains, K13 ns_step, K14
   tp_cross_mean and tp_quad) from ``gpry_tpu_torch/csrc``, one nvcc per
   source, all at once.
2. Hold each kernel against its plain PyTorch version on the card at the
   shapes of the main paths (d = 8, n = 224 valid rows in a bucket of
   nmax = 320; K1 at nq = 16, 66, 2,000, 16,384 and 65,536, each in the
   geometry its plan gives it, K2 at nq = 3,200, K3 at R = 2,048, at R = 1
   and as the row panels of appends of 1 and 8 points (each panel equal to
   the whole matrix's rows bit for bit, the whole matrix bit for bit
   symmetric on the fast families), K4 at N = 4,096 candidates
   and a pool of 8, K5 at the audit's nq = 1, 8, 256, 2,048 and 4,096
   (its std K2's bit for bit where K2's gates pass), K6 at the NS's B = 66
   and 33 chains of 40 repeats, K7 at nq = 1, 63, 64, 65, 1,000, 1,024
   and 1,025 (its covariance symmetric and its diagonal K5's sigma^2, bit
   for bit, L aligned and, at 64, 8 bytes off), K8 at nq = 1,
   8, 32, 64 and 1,024 (its mean and std K5's bit for bit),
   K9 at 8 restart lanes, lane 0 on a training point, with no upper
   clip and with one that binds at half of the starts; K10 at the fit's
   LML screen of R = 2,048 theta rows, scalar and vector noise, and in
   its gradient mode on 8 rows and one that is not positive definite;
   K11 on path h's data, 8 lanes and the 2 of a simple fit, step for step
   over 3 iterations and then to maxiter 120; K12 at path d's ensemble
   (d = 8, 16 chains) and at d = 32 (64 chains) and beyond shared memory,
   step for step over the first 50 steps of each phase, then whole
   1,000 + 2,000-step runs by their statistics; K13 on crafted states at
   nlive 200, 400 and 3,200 (d = 64); K14 on every shard of path m's TP
   predict (n = 900 of nmax = 1,024 over 4 shards) at nq = 1, 64 and
   255, tp_quad beside ``torch.einsum``; K1, K6 and K12 with the SVM fitted
   and all finite), for the four fast families and,
   in each kernel's spec mode, for a composite kernel with every node kind
   (ALL_NODES); time both with CUDA events (K1, K3 at R = 1 and its
   panels, and K6 also by their kernel's own duration in a
   ``torch.profiler`` trace), and compute each
   kernel's bound: the larger of its FP64 operations over the H100 SXM's
   FP64 peak and its bytes over 3.35 TB/s.  K1's, K6's and K12's
   operations count only the sums their inputs need: the SVM decision of a
   point inside the trust box (and the prior box), the GP mean only where
   that decision is finite, over the points K6's chains must evaluate and
   the proposals K12's chains score; K13's the bytes of the live and dead
   buffers it touches and its few operations; K9's and K11's
   the sums of the evaluations their plain versions make (iterations and
   nev).  K10 is also timed against the route it replaces (K3,
   ``cholesky_ex`` and ``solve_triangular``).
3. Drive thirteen paths (before the checks of 2, after one throwaway trace
   that takes the profiler's start-up, each path under a
   ``torch.profiler`` trace of its own, CUDA activity: each kernel's device
   ms by path, the launches the traces hold, ``rank_s`` = device s -
   launches x the bound of one launch, and each path's device busy share
   over its run inside the trace; a trace that holds no device activity
   makes its path's device ms and every rank_s null, and the ranking is
   not printed),
   each with the launch counts set to 0 just before it
   and read just after, and check that each launched its kernels (K9 once
   per believer step on paths a, f, h, i and k; on the paths that fit, a,
   b, c, e, f, h, i, j and k, K11 once per fit that polishes and K10 once
   per LML screen and re-score, with no call of the torch L-BFGS or of
   cholesky_ex inside them; each path's fits and fit seconds are printed,
   and its polishes (but path k's, which are path a's) are replayed
   through K11's plain version, the two winners compared by
   each solver's own -LML and, for the fast families up to n = 128, by
   a 30-digit one), that
   K1's launches on paths a, b, c and e are below 1% of what the
   lock-step nested sampler made there (LOCKSTEP_K1_LAUNCHES), that every
   MCMC run launched K12 twice (and path d K1 twice: the start tries and
   the IS refine), that every NS run launched K13 once per queued step
   and once per segment end and K6 once per queued step and chain shard,
   reading the host at most ceil(steps / 8) + 2 times, and print the
   seconds each path
   spent in nested sampling:
   a. the default entry point: ``Runner(loglike, bounds).run()`` (the
      BatchOptimizer loop with the convergence audit) then
      ``generate_mc_sample()`` on the 8-dimensional correlated Gaussian
      of ``tests/model_generator.py`` (converged, KL(sample || truth)
      <= 0.05), then ``predict(X, return_cov=True)`` at 1,024 prior
      draws (K7; its diagonal against ``return_std``) and
      ``predict(X, return_std=True, return_mean_grad=True,
      return_std_grad=True)`` at the same draws (K8);
   b. bench.py's NORA operating point (d = 8, N = 224): 1 warm-up and 2
      timed iterations of a 26-restart fit, ``force_resample()`` and
      ``multi_add(n_points=8)``;
   c. the NORA Runner: ``Runner(..., gp_acquisition="NORA", options=
      {"audit": False})`` on the same Gaussian, ``run()``, whose final
      sample is the one drawn at the declaration (converged, KL <= 0.05);
   d. ``mc_sample_from_gp(sampler="mcmc")`` on c's surrogate (split-R-hat
      < 1.2, KL between the MCMC and the NS Gaussians <= 0.05);
   e. the audited NORA Runner on Himmelblau (``benchmarks/nongaussian.py``'s
      run): ``Runner(loglike, bounds, seed=100, gp_acquisition="NORA")``
      at the default options (converged; moment-KL of the final sample
      <= 0.05 against a grid-quadrature truth; every quadrant's mode holds
      >= 5% of the weight);
   f. the composite-kernel Runner: a's run with
      ``gpr={"kernel": SPEC_F}`` (C() * RBF + WhiteKernel), every kernel
      in spec mode (converged, KL <= 0.05; truth evals beside the JAX
      package's at the same seed, JAX_SPEC_EVALS);
   g. on f's surrogate: ``predict(X, return_cov=True)`` at 1,024 prior
      draws (its diagonal against ``return_std``) and the gradients of
      path a (K8 in spec mode), then one NORA
      ``multi_add(n_points=8)`` (K7 and K4 in spec mode);
   h. bench.py's BatchOptimizer operating point (d = 8, N = 224): 1
      warm-up and 2 timed iterations of a 26-restart fit and
      ``BatchOptimizer(...).multi_add(n_points=8)`` (K9 at n = 224);
   i. the resumed Runner: a's Runner with ``checkpoint=`` (a temporary
      directory, ``load_checkpoint="overwrite"``), stopped at iteration 3
      by a callback that raises, then resumed by a fresh Runner
      (``load_checkpoint="resume"``, a thread pool of 4 as its truth
      executor) and run to the end: its training sets within rel 1e-12,
      theta within 1e-10 and its truth evals equal to a's; each save's
      and the load's seconds and the checkpoint's bytes printed; the
      heartbeat touched inside the fits and the final NS; the final chain
      written; then a process pool of 2 (spawned, the CUDA context live)
      evaluates a module-level truth, equal to the serial values;
   j. the gradient-free polish at h's point: a 26-restart fit and one
      ``BatchOptimizer(..., acq_optimizer="sampling").multi_add(
      n_points=8)`` (scipy's Powell, each objective call one K2 launch at
      nq = 1): every point finite and in bounds, each polished value at
      least its start's, the K2 launches the polish's calls plus a screen
      and a lie a believer step, no K9; the wall time, the calls and a
      call's device and host microseconds printed;
   k. the MPI Runner: a's Runner with ``truth_executor="mpi"`` under an
      in-process 4-rank comm (ranks 1-3 evaluate their slices inside the
      gather), ``callback=diagnosis`` and a checkpoint: X, y, theta and
      the truth evals equal a's bit for bit, ranks 1-3 evaluated points,
      the last command ("stop",), every diagnosis consistent; then a rank-1
      Runner on the checkpoint waits (no truth call), re-syncs to rank 0's
      iteration and convergence, and predicts a's mean bit for bit;
   l. the periphery on a's Runner: the surrogate as a Cobaya likelihood,
      called at 1,000 points of a's final sample one point a call (one K2
      launch each, a float back), within rel 1e-12 of a batched predict
      and of the gated mean (K1), with a call's wall and device
      microseconds; and, where matplotlib imports, the Runner's plots and
      ``plot_model_2d`` on a d = 2 Runner (else that is logged);
   m. the device mesh (``gpry_tpu_torch/parallel/mesh.py``) over every
      visible card where there are two or more, else 4 shards on cuda:0
      (its distinct cards printed): the DP predict at nq = 4,096 on b's
      point, the fit's 16 restart lanes on h's data and an NS run with
      its chains over the shards, each equal to its unsharded launch bit
      for bit; the TP predict (K14) on a d = 8 surrogate of n = 900 in
      nmax = 1,024 at nq = 64 within tests/test_parallel.py's tolerances,
      and its sigma gap on a's final surrogate (printed, not gated); then
      a's Runner with ``available_mesh`` forced to the mesh: SHARD_STATS'
      fit and predict above 0 and, with no TP predict, a's training sets
      (rel 1e-10) and theta (rel 1e-4).
   Paths a-l run inside ``mesh_disabled()``, so that their evals and
   equalities are one card's on any machine.

Prints the card's ``nvidia-smi`` name and power limit, a JSON line with the
kernel results (spec-mode rows named "<kernel>/spec"), and as the last line
the contract line ``{"ok": true, "device": {...}}``.  Any failure raises
(exit code != 0) before a result is printed.

    python3 chip_smoke.py
"""

import json
import math
import os
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
D, N, NMAX, NSV = 8, 224, 320, 8
KL_GATE = 0.05
TOL_K1, TOL_K2, TOL_K3, TOL_K4, TOL_K6 = 1e-12, 1e-10, 1e-12, 1e-10, 1e-10
# K7: the mean within rel TOL_K7; the covariance within TOL_K7_COV
# max|K(Xq, Xq)| absolute (K - V^T V cancels near the training points)
TOL_K7, TOL_K7_COV = 1e-10, 1e-10
# K7 and path g's covariance at NQ_COV queries; diag(cov) against std^2
# within TOL_COV_DIAG max diag(cov), absolute (sigma^2 cancels to ~0 at a
# training point)
NQ_COV, TOL_COV_DIAG = 1024, 1e-9
# K7 about the edges of the product's 32-query tiles and at the paths'
# NQ_COV; timed at K7_TIMED
K7_NQ, K7_TIMED = (1, 63, 64, 65, 1000, NQ_COV, 1025), (1, 64, NQ_COV)
# K5: the mean within rel TOL_K5; sigma within TOL_K5_SIGMA sqrt(sigma^2)
# y_scale absolute (sigma^2 - |v|^2 cancels to ~0 at a training point)
TOL_K5, TOL_K5_SIGMA = 1e-10, 1e-7
# K5 at the audit screen
NQ_SCREEN = 4096
# K5 at the audit's batch sizes: the calibrations' few points, a polish's
# 256 cloud points and 2,048, the screen's NQ_SCREEN
K5_NQ = (1, 8, 256, 2048, NQ_SCREEN)
# K8: mean and std within rel TOL_K8, both gradients within TOL_K8_GRAD of
# their max |.|
TOL_K8, TOL_K8_GRAD = 1e-10, 1e-8
# K8 at the generic ascent's lanes (8, 32), at 64 and at predict's NQ_COV
# draws; timed at K8_TIMED
K8_NQ, K8_TIMED = (1, 8, 32, 64, NQ_COV), (8, 32, NQ_COV)
# K9 per lane: x within TOL_K9_X of the box width, f within
# TOL_K9_F (1 + |f|); step for step (the same nev) over K9_STEPS
# iterations
TOL_K9_X, TOL_K9_F, K9_STEPS = 1e-7, 1e-9, 3
# K9 and K11 also step for step at these n: past the shared-memory edge
# of K9's staged L (231: L staged, X not) and of both kernels' route 0
# (320: K9 streams L, K11 keeps the factor in global memory)
EDGE_NS = (231, 320)
# the JAX package's truth evals to convergence on path e's run
# (benchmarks/results_nongaussian.json, Himmelblau seed 100)
JAX_HIMMELBLAU_EVALS = 61
# K10 and K11 on route 1 (a row or a lane on a thread-block cluster):
# checked at K11's first n of it at d = D (237; K10's fast families keep
# route 0 there), 1,024 and 2,048 on ROUTE1_R rows
# or lanes and K10 also on the screen's ROUTE1_SCREEN rows (check_route1),
# timed at the kernel table's route-1 shapes (time_route1)
ROUTE1_NS = (237, 1024, 2048)
ROUTE1_R = (1, 2, 8, 16)
ROUTE1_SCREEN = 2049
# the rows of K10's yardstick call (torch.linalg.cholesky_ex, batched),
# scaled to ROUTE1_SCREEN
ROUTE1_CHOL_ROWS = 16
# [FIT]: one full and one simple fit at d = D on its default budget,
# 70 d^1.5 rounded up (run_fit_phase)
FIT_N = 1584
# path f's kernel: C() * RBF(ARD) + WhiteKernel, and the JAX package's
# truth evals to convergence on path f's run (gpry_tpu on the CPU,
# random_gaussian(d=8, rng=18), seed 1)
SPEC_F = {"Sum": [
    {"Product": [{"ConstantKernel": {"constant_value_bounds": [1e-4, 1e6]}},
                 {"RBF": {"length_scale_bounds": [1e-3, 10.0]}}]},
    {"WhiteKernel": {"noise_level": 1e-4,
                     "noise_level_bounds": [1e-8, 0.1]}}]}
JAX_SPEC_EVALS = 76


def all_nodes(d):
    """The spec-mode kernel checks' composite kernel at d dimensions: every
    node kind (ExpSineSquared of a Euclidean distance is not positive
    definite in general, so its period grows with d beyond D)."""
    return {"Sum": [
        {"Product": [{"ConstantKernel": {"constant_value": 1.3}},
                     {"Exponentiation": {"kernel": {"Matern": {
                         "nu": 2.5, "length_scale": [0.6] * d}},
                         "exponent": 2.0}}]},
        {"Sum": [{"Product": [{"ConstantKernel": {"constant_value": 0.5}},
                              {"RationalQuadratic": {
                                  "alpha": 1.5, "length_scale": 0.7}}]},
                 {"Sum": [{"ExpSineSquared": {
                     "length_scale": 1.0,
                     "periodicity": 3.0 * max(1.0, d / D)}},
                          {"Sum": [{"DotProduct": {"sigma_0": 0.3}},
                                   {"WhiteKernel": {
                                       "noise_level": 1e-3}}]}]}]}]}


ALL_NODES = all_nodes(D)
FAST = ("rbf", "matern12", "matern32", "matern52")
# K4 at bench.py's NORA operating point: N candidates, a pool of SIZE
N_CAND, SIZE = 4096, 8
# H100 SXM data sheet at its 700 W limit: FP64 with tensor cores (the
# least time), and HBM3
PEAK_FP64, PEAK_BYTES = 67e12, 3.35e12
SOURCES = {
    "gated_mean": ("gpry_tpu_torch/csrc/gated_mean.cu",
                   "gpry_tpu/models/gp.py:121"),
    "gated_meanvar_logexp": ("gpry_tpu_torch/csrc/gated_meanvar_logexp.cu",
                             "gpry_tpu/models/gp.py:100"),
    "masked_kernel_matrix_batched": (
        "gpry_tpu_torch/csrc/masked_kernel_matrix.cu",
        "gpry_tpu/ops/linalg.py:34"),
    "kriging_believer_fill": (
        "gpry_tpu_torch/csrc/kriging_believer_fill.cu",
        "gpry_tpu/acquisition/ranked_pool.py:41"),
    "meanvar_ungated": ("gpry_tpu_torch/csrc/meanvar_ungated.cu",
                        "gpry_tpu/models/gp.py:85"),
    "ns_slice_chains": ("gpry_tpu_torch/csrc/ns_slice_chains.cu",
                        "gpry_tpu/mc/nested.py:51"),
    "predict_meancov": ("gpry_tpu_torch/csrc/predict_meancov.cu",
                        "gpry_tpu/ops/linalg.py:172"),
    "meanstd_grad": ("gpry_tpu_torch/csrc/meanstd_grad.cu",
                     "gpry_tpu/models/gp.py:1272"),
    "lbfgs_logexp_ascent": ("gpry_tpu_torch/csrc/lbfgs_logexp_ascent.cu",
                            "gpry_tpu/acquisition/batch_optimizer.py:78"),
    "lml_value_grad": ("gpry_tpu_torch/csrc/lml_value_grad.cu",
                       "gpry_tpu/models/gp.py:189"),
    "lbfgs_lml_fit": ("gpry_tpu_torch/csrc/lbfgs_lml_fit.cu",
                      "gpry_tpu/models/gp.py:236"),
    "mcmc_chains": ("gpry_tpu_torch/csrc/mcmc_chains.cu",
                    "gpry_tpu/mc/mcmc.py:44"),
    "ns_step": ("gpry_tpu_torch/csrc/ns_step.cu",
                "gpry_tpu/mc/nested.py:184"),
    "tp_cross_mean": ("gpry_tpu_torch/csrc/tp_predict_partial.cu",
                      "gpry_tpu/parallel/mesh.py:188"),
    "tp_quad": ("gpry_tpu_torch/csrc/tp_predict_partial.cu",
                "gpry_tpu/parallel/mesh.py:196"),
}
# K10: the LML within rel TOL_K10 on well-conditioned rows (the plain
# factor's smallest pivot^2 at least K10_WELL max diag(K)); the NaN masks
# identical except on rows whose K has an eigenvalue below K10_SINGULAR max
# diag(K) (counted and printed); the gradient within TOL_K10_GRAD of max |g|
TOL_K10, TOL_K10_GRAD, K10_WELL, K10_SINGULAR = 1e-10, 1e-8, 1e-6, 1e-12
# K11 per lane over K11_STEPS iterations: the same nev, theta within
# TOL_K11_X of the box width, f within TOL_K11_F (1 + |f|); at maxiter
# K11_MAXITER the same winning lane, or the best f within TOL_K11_END
# (1 + |f|) or within the LML's own rounding spread at the two winners
# (lml_spread over K11_PERMS row orders), whichever is larger: path h's
# optimum sits at the box's edge with cond(K) ~ 3e11, where two summation
# orders of one LML differ by ~1e-5 (~2e-8 of |f|)
TOL_K11_X, TOL_K11_F, TOL_K11_END, K11_STEPS = 1e-7, 1e-9, 1e-8, 3
K11_MAXITER, K11_PERMS = 120, 8
# the paths that fit hyperparameters: K11 once per fit that polishes, K10
# for every screen and re-score (the spec-mode key on path f)
FIT_PATHS = {"batchoptimizer": "", "nora_bench": "", "nora_runner": "",
             "himmelblau_audit": "", "spec_runner": "/spec", "bo_bench": "",
             "resumed_runner": "", "polish": "", "mpi_runner": "",
             "mesh": "", "wide": ""}
# the fit paths whose polishes are not replayed: path k's fits are path
# a's, bit for bit (its training sets equal a's), and so are path m's
# (each split into the mesh's shards, a polish each); path n's 90 lanes at
# d = 40 would take the plain fit minutes
NO_REPLAY = ("mpi_runner", "mesh", "wide")
# K6 at the NS steps of the main paths: nlive 400 (final NS) and 200
# (NORA), num_repeats 40; its shrink candidates a pass
# (csrc/ns_slice_chains.cu K6_WIDTH)
K6_B, K6_R = (66, 33), 40
K6_WIDTH = 4
# K12 at path d's ensemble (d = 8, 16 chains) and at d = 32 (64 chains),
# and beyond shared memory at d = 8 (n valid rows of nmax); the prior box
# [-K12_BOX / 2, K12_BOX / 2]^d.  Step for step over the first K12_STEPS
# steps of each phase: the same accept decisions, x within TOL_K12_X of
# the box width, the log-densities within rel TOL_K12_LP (K6's: at n =
# 4,000 the mean sums rows whose alpha cancel, 3e-12 apart), the step
# size identical, the warm-up's moment sums within TOL_K12_MOM of their
# largest entry (the kernel sums them in another order); whole runs of
# K12_WARMUP +
# K12_SAMPLING steps: means and covariances within K12_SE standard errors
# of their difference, acceptance within TOL_K12_ACC, split-R-hat below
# K12_RHAT on both
K12_CONFIGS, K12_BIG, K12_BOX = ((8, 16), (32, 64)), (4000, 4096), 10.0
K12_WARMUP, K12_SAMPLING, K12_STEPS = 1000, 2000, 50
TOL_K12_X, TOL_K12_LP, K12_SE, TOL_K12_ACC, K12_RHAT = \
    1e-12, 1e-10, 4.0, 0.02, 1.2
TOL_K12_MOM = 1e-12
# K13 on crafted states at these (nlive, d), and through runs of 24 steps
# with K6-like new points of these kinds; timed at the final NS's (the
# row's) and at the largest
K13_SHAPES, K13_TIMED, TOL_K13_CHOL = ((200, 8), (400, 8), (3200, 64)), \
    ((400, 8), (3200, 64)), 1e-12
K13_KINDS = ("ties", "neg_inf", "nan", "plateau")
# K2 at the believer's one-point predict, a small batch and the
# acquisition screen
K2_NQ = (1, 8, 3200)
# path m: the shards of the logical mesh on one card (every visible card
# where there are two or more), the DP predict's queries at bench.py's
# NORA point, the TP predict's surrogate (n valid rows of nmax, d = D) and
# queries, the fit's restart lanes and the NS's live points
MESH_LOGICAL, MESH_DP_NQ = 4, 4096
MESH_TP_N, MESH_TP_NMAX, MESH_TP_NQ = 900, 1024, 64
MESH_FIT_LANES, MESH_NS_NLIVE = 16, 400
# the TP predict against the single-device one: tests/test_parallel.py's
# tolerances (mean rtol, atol; sigma rtol, atol)
TOL_TP_MEAN, TOL_TP_STD = (1e-9, 1e-12), (1e-6, 1e-9)
# K14 against its plain versions: max abs error over each output's scale
# (K_shard: its largest entry; the partial mean and quadratic form: the
# largest sum of the absolute values of their terms)
TOL_K14 = 1e-12
# path m's Runner against path a's: the training sets within rel
# TOL_MESH_X, theta within rel TOL_MESH_THETA (tests/test_parallel.py's)
TOL_MESH_X, TOL_MESH_THETA = 1e-10, 1e-4
# K1's launches on paths a, b, c and e when every slice step was a K1
# call (the chip run of the commit before K6; PERF.md, section 6)
LOCKSTEP_K1_LAUNCHES = {"batchoptimizer": 284164, "nora_bench": 199803,
                        "nora_runner": 720768, "himmelblau_audit": 271227}
# the kernels each path must launch
PATH_KERNELS = {
    "batchoptimizer": ("gated_mean", "gated_meanvar_logexp",
                       "masked_kernel_matrix_batched", "meanvar_ungated",
                       "ns_slice_chains", "predict_meancov", "meanstd_grad",
                       "lbfgs_logexp_ascent", "lml_value_grad",
                       "lbfgs_lml_fit", "ns_step"),
    "nora_bench": ("gated_mean", "gated_meanvar_logexp",
                   "masked_kernel_matrix_batched", "kriging_believer_fill",
                   "ns_slice_chains", "lml_value_grad", "lbfgs_lml_fit",
                   "ns_step"),
    "nora_runner": ("gated_mean", "gated_meanvar_logexp",
                    "masked_kernel_matrix_batched", "kriging_believer_fill",
                    "ns_slice_chains", "lml_value_grad", "lbfgs_lml_fit",
                    "ns_step"),
    "mcmc": ("gated_mean", "mcmc_chains"),
    "himmelblau_audit": ("gated_mean", "gated_meanvar_logexp",
                         "masked_kernel_matrix_batched",
                         "kriging_believer_fill", "meanvar_ungated",
                         "ns_slice_chains", "lml_value_grad",
                         "lbfgs_lml_fit", "ns_step"),
    "spec_runner": ("gated_mean/spec", "gated_meanvar_logexp/spec",
                    "masked_kernel_matrix_batched/spec",
                    "meanvar_ungated/spec", "ns_slice_chains/spec",
                    "lbfgs_logexp_ascent/spec", "lml_value_grad/spec",
                    "lbfgs_lml_fit/spec", "ns_step"),
    "spec_cov_nora": ("predict_meancov/spec", "kriging_believer_fill/spec",
                      "meanstd_grad/spec", "ns_step"),
    "bo_bench": ("gated_meanvar_logexp", "masked_kernel_matrix_batched",
                 "lbfgs_logexp_ascent", "lml_value_grad", "lbfgs_lml_fit"),
    "resumed_runner": ("gated_mean", "gated_meanvar_logexp",
                       "masked_kernel_matrix_batched", "meanvar_ungated",
                       "ns_slice_chains", "lbfgs_logexp_ascent",
                       "lml_value_grad", "lbfgs_lml_fit", "ns_step"),
    "polish": ("gated_meanvar_logexp", "masked_kernel_matrix_batched",
               "lml_value_grad", "lbfgs_lml_fit"),
    # path i's kernels (the diagnosis callback's predictions are K2's)
    "mpi_runner": ("gated_mean", "gated_meanvar_logexp",
                   "masked_kernel_matrix_batched", "meanvar_ungated",
                   "ns_slice_chains", "lbfgs_logexp_ascent",
                   "lml_value_grad", "lbfgs_lml_fit", "ns_step"),
    # the Cobaya likelihood's one-point predictions (K2) and the device
    # samplers' target density it is held against (K1)
    "periphery": ("gated_mean", "gated_meanvar_logexp"),
    # the DP predict (K2), the NS's chains (K6, K13), the fit's lanes
    # (K11), the TP predict (K14) and path a's Runner under the mesh
    "mesh": ("gated_meanvar_logexp", "ns_slice_chains", "lbfgs_lml_fit",
             "ns_step", "tp_cross_mean", "tp_quad"),
    # the default Runner at d = 40 for three believer iterations, then its
    # final NS
    "wide": ("gated_mean", "gated_meanvar_logexp",
             "masked_kernel_matrix_batched", "ns_slice_chains",
             "lbfgs_logexp_ascent", "lml_value_grad", "lbfgs_lml_fit",
             "ns_step"),
}
# the fourteen kernels' symbols, by row of the kernels line
SYMBOLS = {"gated_mean_kernel": "gated_mean",
           "gated_meanvar_blocked": "gated_meanvar_logexp",
           "gated_meanvar_chain": "gated_meanvar_logexp",
           "masked_kernel_matrix_kernel": "masked_kernel_matrix_batched",
           "kb_sweep_blocked": "kriging_believer_fill",
           "kb_sweep_chain": "kriging_believer_fill",
           "kb_select_kernel": "kriging_believer_fill",
           "meanvar_ungated_blocked": "meanvar_ungated",
           "meanvar_ungated_chain": "meanvar_ungated",
           "ns_slice_chains_kernel": "ns_slice_chains",
           "meancov_solve_blocked": "predict_meancov",
           "meancov_solve_chain": "predict_meancov",
           "meancov_cov_dmma": "predict_meancov",
           "meanstd_grad_blocked": "meanstd_grad",
           "meanstd_grad_kernel": "meanstd_grad",
           "lbfgs_logexp_ascent_kernel": "lbfgs_logexp_ascent",
           "lml_value_grad_kernel": "lml_value_grad",
           "lbfgs_lml_fit_kernel": "lbfgs_lml_fit",
           "mcmc_chains_kernel": "mcmc_chains",
           "ns_step_kernel": "ns_step",
           "tp_cross_mean_kernel": "tp_cross_mean",
           "tp_quad_kernel": "tp_quad",
           "tp_quad_sum_kernel": "tp_quad"}
# the paths whose BatchOptimizer must launch K9 once per believer step
BELIEVER_PATHS = {"batchoptimizer": "lbfgs_logexp_ascent",
                  "spec_runner": "lbfgs_logexp_ascent/spec",
                  "bo_bench": "lbfgs_logexp_ascent",
                  "resumed_runner": "lbfgs_logexp_ascent",
                  "mpi_runner": "lbfgs_logexp_ascent",
                  "mesh": "lbfgs_logexp_ascent",
                  "wide": "lbfgs_logexp_ascent"}
# path (n): the default Runner at d = WIDE_D, stopped after WIDE_ITERS
# believer iterations (of d points each) by its callback, its K9 launches all
# of the d <= 64 instance (INSTANCE_PATHS: the template argument GD in the
# trace's kernel name, lbfgs_logexp_ascent_kernel<SPEC, STREAM, GD, VG>);
# its Gaussian's prior box WIDE_PRIOR_STD standard
# deviations wide each way: at the generator's default of 5, 0.35% of
# uniform draws at d = 40 lie within the GPR's finiteness threshold
# (270 log units) of the best, and the initial design gives up after
# max_initial = 30 d^1.5 draws (it does so in gpry_tpu too); at 3, 17.6%
WIDE_D, WIDE_ITERS, WIDE_PRIOR_STD = 40, 3, 3.0
INSTANCE_PATHS = {"wide": ("lbfgs_logexp_ascent", ", 64, ")}
# path i against path a: the training sets within rel TOL_RESUME_X, theta
# within TOL_RESUME_THETA
TOL_RESUME_X, TOL_RESUME_THETA = 1e-12, 1e-10
# path i's interruption: its first Runner's callback raises at this
# iteration (the checkpoint then holds the end of the one before)
RESUME_STOP_AT = 3


def log(msg):
    print(msg, flush=True)


def card_line():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()
    return out[0]


def time_ms(fn, reps):
    """Mean milliseconds per call over ``reps`` calls (CUDA events, after
    one warm-up call)."""
    import torch
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def kernel_device_ms(fn, name, reps):
    """Mean duration in ms of the device kernels whose name contains
    ``name`` in a ``torch.profiler`` trace (CUDA activity) of ``reps``
    calls of ``fn`` (after one warm-up call; over the launches the trace
    holds, which may miss one): the kernel's own time on the card, without
    the host's launch.  None where two traces in a row held no launch of
    it (after many traces in one process a trace may hold no device
    activity at all): a device time is never stood in for by another
    clock's."""
    import torch
    from torch.autograd import DeviceType
    fn()
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CUDA]
    for _ in range(2):
        with torch.profiler.profile(activities=acts) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        durs = [e.time_range.elapsed_us() for e in prof.events()
                if e.device_type == DeviceType.CUDA and name in e.name]
        if durs:
            return 1e-3 * sum(durs) / len(durs)
    log(f"[TRACE] the profiler saw no launch of {name}: its device ms is "
        "not measured (null)")
    return None


def fmt_ms(ms):
    return "not measured" if ms is None else f"{ms:.4f}"


def busy_us(events):
    """Union of the device intervals of ``events`` in microseconds."""
    spans = sorted((e.time_range.start, e.time_range.end) for e in events)
    total, cur_s, cur_e = 0, None, None
    for s, e in spans:
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                total += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        total += cur_e - cur_s
    return total


def kernel_row(name):
    """(row of the kernels line, symbol) of a device kernel's name in a
    torch.profiler trace ("void <symbol><SPEC, ...>(...)": the spec
    instance by its first template argument), or None for a kernel that is
    not one of the thirteen (torch's own, and the staging kernel that K6
    and K12 launch first where the surrogate is too large for shared
    memory)."""
    name = name[5:] if name.startswith("void ") else name
    symbol = name.split("<", 1)[0].split("(", 1)[0]
    row = SYMBOLS.get(symbol)
    if row is None:
        return None
    return row + ("/spec" if name[len(symbol):].startswith("<true")
                  else ""), symbol


def device_split(prof, wall_s):
    """A path's device time from its torch.profiler trace: ms and
    launches by row of the kernels line (launches by symbol, so K4's sweep
    and select apart, K7's two kernels apart), the other device work, and
    the device's busy share (the union of every device interval over
    ``wall_s``, the path's own run inside the trace)."""
    from torch.autograd import DeviceType
    events = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    if not events:
        # a trace now and then holds no device activity (not a fault of
        # the path): its device figures are then null (rank_of), not 0
        log("[TRACE] the profiler saw no device activity on this path")
        return {"kernel_ms": None, "kernel_launches": {},
                "other_device_ms": None, "busy_ms": None, "wall_s": wall_s,
                "busy_share": None, "trace_empty": True}
    ms, launches, other = {}, {}, 0.0
    for e in events:
        us = e.time_range.elapsed_us()
        hit = kernel_row(e.name)
        if hit is None:
            other += 1e-3 * us
            continue
        row, symbol = hit
        ms[row] = ms.get(row, 0.0) + 1e-3 * us
        launches.setdefault(row, {})
        launches[row][symbol] = launches[row].get(symbol, 0) + 1
    busy = 1e-3 * busy_us(events)
    return {"kernel_ms": ms, "kernel_launches": launches,
            "other_device_ms": other, "busy_ms": busy, "wall_s": wall_s,
            "busy_share": 1e-3 * busy / wall_s, "trace_empty": False}


def rel_err(a, b):
    """(max abs error, max abs error / max |b|) over finite entries, after
    requiring identical -inf masks."""
    import torch
    if not torch.equal(torch.isfinite(a), torch.isfinite(b)):
        raise AssertionError("kernel and plain version differ in their "
                             "-inf masks")
    fin = torch.isfinite(b)
    if not bool(fin.any()):
        raise AssertionError("no finite value to compare")
    err = float(torch.max(torch.abs(a[fin] - b[fin])))
    return err, err / float(torch.max(torch.abs(b[fin])))


def sync():
    import torch
    if torch.cuda.is_available():
        torch.cuda.synchronize()


def bound(flops, nbytes):
    """The least time the card could take for ``flops`` FP64 operations
    and ``nbytes`` of memory traffic (each input read once, each output
    written once), and which of the two bounds it."""
    t_ops, t_bytes = flops / PEAK_FP64, nbytes / PEAK_BYTES
    return {"bound_ms": 1e3 * max(t_ops, t_bytes),
            "bound_by": "operations" if t_ops >= t_bytes else "bytes",
            "flops": float(flops), "bytes": float(nbytes)}


def spec_kernel(d=D):
    """(spec, theta0) of all_nodes(d) at d dimensions (the port's own
    build_kernel_spec)."""
    from gpry_tpu_torch.ops.kernels import build_kernel_spec
    spec, theta0, _ = build_kernel_spec(all_nodes(d), d)
    return spec, theta0


def is_spec(family):
    return isinstance(family, tuple)


def pair_flops(family, d=D):
    """FP64 operations of one kernel value k(x, x') at d dimensions and its
    multiply-add into a sum: per stationary ARD leaf r^2 over d and one
    exponential, per dot product d multiply-adds, per operator one (the
    fast families: 3 d + 3, as PR 4 counted them)."""
    if not is_spec(family):
        return 3 * d + 3
    from gpry_tpu_torch.ops import fused
    ops, _, _, _ = fused.encode_spec(family, d)
    names = {v: k for k, v in fused.SPEC_OPS.items()}
    cost = {"rq": 3 * d + 5, "expsine": 3 * d + 6, "dotproduct": 2 * d + 2,
            "white": 0, "constant": 0, "sum": 1, "product": 1, "pow": 1}
    return sum(cost.get(names[o], 3 * d + 3) for o in ops)


def synthetic_surrogate(family, dev, seed, svm="fitted", d=D, n=N,
                        nmax=NMAX, mode=False, ls_scale=1.0):
    """A surrogate snapshot at the main-path shapes (or d, n valid rows of
    nmax) with every gate active: a fitted SVM, a trust box inside the
    prior and an upper clip.  With ``svm="all_finite"`` the SVM is the
    placeholder of a run that has seen no -inf (the Gaussian paths' mode:
    no support vector is summed); with ``svm="ball"`` it is fitted and
    finite inside the ball of radius 3.5 about the prior box's centre (one
    posterior mode), the clip then at the 90% quantile of the mean at draws
    inside it.  With ``mode`` (the MCMC checks) it is a
    surrogate of the standard normal log-density as a run normalizes it:
    training points about the box's centre (raw standard deviation 2),
    y_loc and y_scale their values' mean and standard deviation, a trust
    box of [-3, 3]^d, the ball of radius 6 and the clip at the 90%
    quantile of the mean at draws of standard deviation 0.4; else the
    training points lie uniformly in the box.  ``family`` is a fast family
    or the all_nodes(d) spec tree; a fast family's length scales are drawn
    in [0.4, 0.9] times ``ls_scale`` (sqrt(d / D) keeps the kernel values
    of a wider d those of d = D)."""
    import numpy as np
    import torch
    from gpry_tpu_torch.models.classifier import MODE_ALL_FINITE, \
        MODE_FITTED, SVMParams, trivial_svm_params
    from gpry_tpu_torch.models.gp import SurrogateParams
    from gpry_tpu_torch.ops.linalg import factorize
    rng = np.random.default_rng(seed)
    t = lambda a: torch.as_tensor(np.asarray(a, float), dtype=torch.float64,
                                  device=dev)
    Xv = np.clip(rng.normal(0.5, 0.2, (n, d)), 0, 1) if mode else \
        rng.uniform(0, 1, (n, d))
    yv = -0.5 * np.sum(((Xv - 0.5) / (0.1 if mode else 0.3)) ** 2, axis=1)
    y_loc, y_scale = (yv.mean(), yv.std()) if mode else (-3.0, 2.5)
    yv = (yv - yv.mean()) / yv.std()
    Xp, yp = np.zeros((nmax, d)), np.zeros(nmax)
    Xp[:n], yp[:n] = Xv, yv
    if is_spec(family):
        theta0 = np.asarray(spec_kernel(d)[1])
        theta = theta0 + rng.uniform(-0.2, 0.2, len(theta0))
    else:
        theta = np.concatenate([[np.log(2.0)],
                                np.log(rng.uniform(0.4, 0.9, d) * ls_scale)])
    noise = t(1e-4)
    L, alpha = factorize(family, t(theta), t(Xp), t(yp), n, noise)
    if bool(torch.isnan(L).any()):
        raise AssertionError("synthetic factorization is not PD")
    sv = rng.uniform(0, 1, (NSV, d))
    dual = rng.normal(size=NSV)
    gamma = 2.0
    Xq = rng.uniform(0, 1, (4096, d))
    dec = np.exp(-gamma * ((Xq[:, None] - sv[None]) ** 2).sum(-1)) @ dual
    fitted = SVMParams(mode=MODE_FITTED, sv=t(sv), dual=t(dual),
                       intercept=t(-np.median(dec)), gamma=t(gamma))
    p = SurrogateParams(
        theta=t(theta), X=t(Xp), y=t(yp), n=n, noise_var=noise, L=L,
        alpha=alpha, x_loc=t(np.full(d, -5.0)), x_scale=t(np.full(d, 10.0)),
        y_loc=t(y_loc), y_scale=t(y_scale), y_max=t(0.0), clip_max=t(np.inf),
        svm=fitted, trust_lo=t(np.full(d, -3.0 if mode else -4.5)),
        trust_hi=t(np.full(d, 3.0 if mode else 4.5)))
    # an upper clip below the largest mean, so that it binds somewhere
    from gpry_tpu_torch.ops.fused import gated_mean_plain
    m = gated_mean_plain(family, p, t(rng.uniform(-5, 5, (4096, d))))
    if not mode:
        clip = torch.quantile(m[torch.isfinite(m)], 0.9)
        p = p.replace(clip_max=clip.to(torch.float64))
    if svm == "all_finite":
        p = p.replace(svm=trivial_svm_params(d, NSV, torch.float64, dev,
                                             MODE_ALL_FINITE))
    if svm == "ball":
        sv[0], dual = 0.5, np.eye(NSV)[0]
        p = p.replace(svm=SVMParams(
            mode=MODE_FITTED, sv=t(sv), dual=t(dual),
            intercept=t(-np.exp(-gamma * (0.6 if mode else 0.35) ** 2)),
            gamma=t(gamma)))
    if svm == "ball" or mode:
        m = gated_mean_plain(family, p, t(0.4 * rng.normal(size=(4096, d))))
        clip = torch.quantile(m[torch.isfinite(m)], 0.9)
        p = p.replace(clip_max=clip.to(torch.float64))
    return p


def needed_sums(p, X, lo=None, hi=None):
    """(points whose SVM decision the gated mean must sum, points whose GP
    mean it must sum) among ``X``: the SVM decision of every point inside
    the trust box and the prior box [lo, hi] (if given) when the SVM is
    fitted, the GP mean of those the SVM classifies finite."""
    import torch
    from gpry_tpu_torch.models.classifier import MODE_FITTED, svm_decision
    inside = torch.all((X >= p.trust_lo) & (X <= p.trust_hi), dim=-1)
    if lo is not None:
        inside &= torch.all((X >= lo) & (X <= hi), dim=-1)
    finite = svm_decision(p.svm, (X - p.x_loc) / p.x_scale)
    n_svm = int(inside.sum()) if p.svm.mode == MODE_FITTED else 0
    return n_svm, int((inside & finite).sum())


def sum_flops(n_svm, n_gp, family="rbf", d=D, n=N):
    """FP64 operations of those sums: per (point, support vector) r^2 over
    d, one exponential, one multiply-add; per (point, training row) the
    kernel value and its multiply-add (pair_flops)."""
    return n_svm * NSV * (3 * d + 3) + n_gp * n * pair_flops(family, d)


def k4_inputs(family, dev, noise_kind, rng, acqf, noise_std):
    """K4's arguments at the NORA shapes: N_CAND candidates inside the
    trust box with a finite LogExp value under the synthetic surrogate
    (their gated mean, std and acquisition from the plain K2), scalar or
    per-row noise."""
    import numpy as np
    import torch
    from gpry_tpu_torch.ops import fused
    t = lambda a: torch.as_tensor(np.asarray(a, float), dtype=torch.float64,
                                  device=dev)
    p = synthetic_surrogate(family, dev, seed=13)
    if noise_kind == "vector":
        p = p.replace(noise_var=t(rng.uniform(1e-5, 1e-3, NMAX)))
    Xc = t(rng.uniform(-4.5, 4.5, (4 * N_CAND, D)))
    y, sd = fused.gated_meanvar_logexp_plain(family, p, Xc)
    acq0 = acqf.values(y, sd, p.y_max, noise_std)
    keep = torch.nonzero(torch.isfinite(acq0))[:, 0][:N_CAND]
    if len(keep) < N_CAND:
        raise AssertionError("too few finite K4 candidates")
    alive = torch.ones(N_CAND, dtype=torch.bool, device=dev)
    fn = lambda yy, ss: acqf.values(yy, ss, p.y_max, noise_std)
    return (p, Xc[keep].contiguous(), y[keep].contiguous(),
            sd[keep].contiguous(), acq0[keep].contiguous(), alive, SIZE, fn)


def check_k4(dev, rng, families, timed):
    """K4 against its plain version: identical picks and -inf masks,
    outC and outS within rel TOL_K4, in both sweep modes (LogExp in the
    kernel; any other acquisition in torch between the two kernels).
    ``timed`` is timed at scalar noise."""
    import torch
    from gpry_tpu_torch.acquisition.functions import LogExp
    from gpry_tpu_torch.ops import fused
    acqf, noise_std = LogExp(dimension=D), 0.01
    worst = 0.0
    row = {}
    for fam in families:
        label = "spec" if is_spec(fam) else fam
        for noise_kind in ("scalar", "vector"):
            args = k4_inputs(fam, dev, noise_kind, rng, acqf, noise_std)
            t0 = time.perf_counter()
            ref = fused.kriging_believer_fill_plain(fam, *args)
            sync()
            plain_once = 1e3 * (time.perf_counter() - t0)
            if not bool(torch.isfinite(ref[4]).all()):
                raise AssertionError(f"K4 {label}: the plain fill left "
                                     "slots empty")
            for mode, logexp in (("logexp", (acqf.zeta, noise_std)),
                                 ("torch-acq", None)):
                out = fused.kriging_believer_fill(fam, *args, logexp=logexp)
                sync()
                for what, i in (("outX", 0), ("outY", 1), ("outA", 3)):
                    if not torch.equal(out[i], ref[i]):
                        raise AssertionError(
                            f"K4 {label} {noise_kind} {mode}: {what} "
                            "differs (different picks)")
                errC, relC = rel_err(out[4], ref[4])
                errS, relS = rel_err(out[2], ref[2])
                log(f"[K4] {label:8s} noise {noise_kind:6s} {mode:9s}: "
                    f"same picks; outC max abs err {errC:.3e} rel "
                    f"{relC:.3e}; outS rel {relS:.3e}")
                if not (relC <= TOL_K4 and relS <= TOL_K4):
                    raise AssertionError(f"K4 {label} {mode}: rel {relC}, "
                                         f"{relS} > {TOL_K4}")
                worst = max(worst, errC, errS)
            if fam == timed and noise_kind == "scalar":
                lexp = (acqf.zeta, noise_std)
                ms = time_ms(lambda: fused.kriging_believer_fill(
                    fam, *args, logexp=lexp), 20)
                plain = plain_once if is_spec(fam) else time_ms(
                    lambda: fused.kriging_believer_fill_plain(fam, *args), 5)
                log(f"[K4] {label} N={N_CAND} size={SIZE}: kernel {ms:.4f} "
                    f"ms, plain {plain:.4f} ms")
                row = {"ms": ms, "plain_ms": plain}
                # FP64 work of this fill: every conditioned round sweeps
                # the alive candidates (k vector, length-n substitution,
                # sum of squares), every round appends one row
                n0, pf = args[0].n, pair_flops(fam)
                flops = sum((N_CAND - r) * ((n0 + r) * pf
                                            + (n0 + r) ** 2 + 3 * (n0 + r))
                            for r in range(1, SIZE))
                flops += sum((n0 + r) * pf + (n0 + r) ** 2
                             for r in range(SIZE))
                nbytes = 8 * (N_CAND * (D + 3) + n0 * D
                              + n0 * (n0 + 1) // 2 + SIZE * (D + 4)) + N_CAND
                row.update(bound(flops, nbytes))
    row["max_abs_err"] = worst
    row["shape"] = f"N={N_CAND} n={N} nmax={NMAX} d={D} size={SIZE}"
    return row


def k5_bound(family, nq):
    """K5's bound at nq queries (n = N of NMAX, d = D): per query the k
    vector, the length-n forward substitution (n^2 / 2 multiply-adds), the
    mean and the sum of squares; bytes: the queries, the training rows,
    alpha, the valid triangle of L, two outputs."""
    return bound(nq * (N * pair_flops(family) + N * N + 4 * N),
                 8 * (nq * D + 2 * nq + N * D + N + N * (N + 1) // 2
                      + 4 * D))


def check_k5(dev, rng, families, timed):
    """K5 against its plain version at the audit's batch sizes K5_NQ (the
    calibrations' few points, a polish's 256, 2,048 and the screen's
    NQ_SCREEN; k2_queries, the last min(nq // 2, 64) on training points):
    the mean within rel TOL_K5, the std within TOL_K5_SIGMA sqrt(sigma^2)
    y_scale.  Where K5 and K2 take the same route-0 plan (asserted at
    these shapes), K5's std equals K2's bit for bit wherever K2's gates
    pass, and its mean wherever the clip does not bite too (some query of
    each family's batches in each).  Timed at each nq (CUDA events back to
    back, and the kernel's device ms in a torch.profiler trace), with the
    bound at each."""
    import torch
    from gpry_tpu_torch.ops import fused
    from gpry_tpu_torch.ops.kernels import kernel_diag
    worst = 0.0
    shapes = {}
    for fam in families:
        label = "spec" if is_spec(fam) else fam
        p = synthetic_surrogate(fam, dev, seed=14)
        sd = fused._spec_doubles(fused._kern(fam, D, dev))
        gated = below = 0
        for nq in K5_NQ:
            Xq = k2_queries(p, rng, nq, dev)
            k = min(nq // 2, 64)
            if k:
                Xq[nq - k:] = p.X[:k] * p.x_scale + p.x_loc
            ma, sa = fused.meanvar_ungated(fam, p, Xq)
            mb, sb = fused.meanvar_ungated_plain(fam, p, Xq)
            m2, s2 = fused.gated_meanvar_logexp(fam, p, Xq)
            torch.cuda.synchronize()
            err_m, rel_m = rel_err(ma, mb)
            err_s = float(torch.max(torch.abs(sa - sb)))
            prior = kernel_diag(fam, p.theta, (Xq - p.x_loc) / p.x_scale)
            tol_s = TOL_K5_SIGMA * float(torch.sqrt(prior.max())
                                         * p.y_scale)
            plan = fused.meanvar_ungated_plan(N, NMAX, D, nq, sd)
            if plan[:2] != fused.gated_meanvar_logexp_plan(N, NMAX, D, nq,
                                                           sd)[:2]:
                raise AssertionError(f"K5 {label} nq={nq}: K2's plan "
                                     "differs from K5's")
            ok = torch.isfinite(m2)
            free = ok & (ma < p.clip_max)
            gated, below = gated + int(ok.sum()), below + int(free.sum())
            same_s = torch.equal(sa[ok], s2[ok])
            same_m = torch.equal(ma[free], m2[free])
            log(f"[K5] {label:8s} nq={nq:5d} route {plan[:2]}: mean max abs "
                f"err {err_m:.3e} rel {rel_m:.3e}; std max abs err "
                f"{err_s:.3e} (tol {tol_s:.3e}); against K2 on "
                f"{int(ok.sum())} gated queries: std bit for bit {same_s}, "
                f"mean ({int(free.sum())} below the clip) {same_m}")
            if not (rel_m <= TOL_K5 and err_s <= tol_s):
                raise AssertionError(f"K5 {label} nq={nq}: mean rel {rel_m} "
                                     f"> {TOL_K5} or std abs {err_s} > "
                                     f"{tol_s}")
            if not (same_s and same_m):
                raise AssertionError(f"K5 {label} nq={nq}: not K2's "
                                     "ungated values bit for bit")
            worst = max(worst, err_m, err_s)
            if fam != timed:
                continue
            call = lambda: fused.meanvar_ungated(fam, p, Xq)
            shape = {"ms": time_ms(call, 50 if nq > 16 else 200),
                     "device_ms": kernel_device_ms(call, "meanvar_ungated",
                                                   50),
                     "plain_ms": time_ms(lambda: fused.meanvar_ungated_plain(
                         fam, p, Xq), 20),
                     "route": plan[:2], **k5_bound(fam, nq)}
            shapes[f"nq={nq}"] = shape
            log(f"[K5] {label} nq={nq}: " + json.dumps(shape))
        if not (gated and below):
            raise AssertionError(f"K5 {label}: no query passed K2's gates "
                                 "(below the clip)")
    top = shapes[f"nq={NQ_SCREEN}"]
    return {"max_abs_err": worst, "shapes": shapes,
            "shape": f"nq={NQ_SCREEN} n={N} nmax={NMAX} d={D}",
            **{k: top[k] for k in ("ms", "device_ms", "plain_ms", "bound_ms",
                                   "bound_by", "flops", "bytes")}}


def k6_inputs(family, dev, B, seed, svm="fitted"):
    """K6's arguments at an NS step of the main paths: B starts above lstar
    (the median of a prior sample of the box [-5, 5]^D under the synthetic
    surrogate), the survivors' covariance factor, and the draws of K6_R
    repeats."""
    import torch
    from gpry_tpu_torch.ops import fused
    p = synthetic_surrogate(family, dev, seed=15, svm=svm)
    gen = torch.Generator(device=dev).manual_seed(seed)
    f64 = torch.float64
    pool = torch.rand((20000, D), generator=gen, dtype=f64, device=dev) \
        * 10.0 - 5.0
    lp = fused.gated_mean_plain(family, p, pool)
    lstar = torch.quantile(lp[torch.isfinite(lp)], 0.5)
    above = pool[lp > lstar]
    chol = torch.linalg.cholesky(torch.cov(above.T)).contiguous()
    nrm = torch.randn((K6_R, B, D), generator=gen, dtype=f64, device=dev)
    u = torch.rand((K6_R, 1 + fused.NS_SHRINKS, B), generator=gen,
                   dtype=f64, device=dev)
    lo = torch.full((D,), -5.0, dtype=f64, device=dev)
    return p, (above[:B].contiguous(), lp[lp > lstar][:B].contiguous(),
               lstar, chol, nrm, u, lo, -lo)


def k6_replay(family, p, args):
    """A replay of the plain lock-step loop on K6's inputs (which evaluates
    every chain at every step): the points K6's chains must evaluate (both
    first step-out ends, an end again only when its doubling moved it, a
    shrink only until its chain accepted), and the passes each chain of
    the kernel makes: per repeat one for both step-out ladders and
    ceil(shrinks / K6_WIDTH) shrink passes; and, for comparison, the
    passes of a design that evaluates one step at a time (the pair, each
    doubling step, each shrink)."""
    import torch
    from gpry_tpu_torch.ops import fused
    x0, lx0, lstar, chol, nrm, u, lo, hi = args
    B = x0.shape[0]
    seen = []
    passes = torch.zeros(B, dtype=torch.int64, device=x0.device)
    stepwise = torch.zeros_like(passes)
    state = {"ends": None, "acc": None, "shrinks": None}

    def close_repeat():
        if state["shrinks"] is not None:
            passes.add_(-(-state["shrinks"] // K6_WIDTH))
        state["shrinks"] = None

    def logl_of(X):
        in_box = torch.all((X >= lo) & (X <= hi), dim=-1)
        out = torch.where(in_box, fused.gated_mean_plain(family, p, X),
                          torch.full_like(X[:, 0], -torch.inf))
        if len(X) == 2 * B:
            if state["ends"] is None:
                close_repeat()
                need = torch.ones(2 * B, dtype=torch.bool, device=X.device)
                passes.add_(1)
                stepwise.add_(1)
            else:
                # a doubling step moves an end: the chain is active
                need = torch.any(X != state["ends"], dim=1)
                stepwise.add_((need[:B] | need[B:]).long())
            state.update(ends=X, acc=None)
        else:
            if state["acc"] is None:
                state.update(ends=None, acc=torch.zeros(
                    B, dtype=torch.bool, device=X.device),
                    shrinks=torch.zeros(B, dtype=torch.int64,
                                        device=X.device))
            need = ~state["acc"]
            state["shrinks"] += need.long()
            stepwise.add_(need.long())
            state["acc"] = state["acc"] | (out > lstar)
        seen.append(X[need])
        return out

    fused.slice_chains_lockstep(logl_of, x0, lx0, lstar, chol, nrm, u)
    close_repeat()
    return torch.cat(seen), passes, stepwise


def check_k6(dev, families, timed, configs):
    """K6 against its plain version (the lock-step loop on plain K1) on the
    same draws for each (svm, B) of ``configs``: identical calls and -inf
    masks, x and lx within rel TOL_K6, and the passes each chain made those
    of the kernel's schedule (k6_replay).  ``timed`` is timed at B = 66
    with the SVM fitted (and all finite); the bound counts the sums of the
    points its chains must evaluate (k6_replay, needed_sums)."""
    import torch
    from gpry_tpu_torch.ops import fused
    worst = 0.0
    row = {"shapes": {}}
    for fam in families:
        label = "spec" if is_spec(fam) else fam
        for svm, B in configs:
            p, args = k6_inputs(fam, dev, B, seed=B, svm=svm)
            x, lx, calls, passes = fused.ns_slice_chains(
                fam, p, *args, return_passes=True)
            sync()
            pts, passes_r, stepwise = k6_replay(fam, p, args)
            if not torch.equal(passes, passes_r):
                raise AssertionError(f"K6 {label} {svm} B={B}: passes "
                                     "differ from the kernel's schedule")
            t0 = time.perf_counter()
            xr, lxr, callsr = fused.ns_slice_chains_plain(fam, p, *args)
            sync()
            plain = 1e3 * (time.perf_counter() - t0)
            if not torch.equal(calls, callsr):
                raise AssertionError(f"K6 {label} {svm} B={B}: calls "
                                     "differ")
            err_l, rel_l = rel_err(lx, lxr)
            err_x, rel_x = rel_err(x.reshape(-1), xr.reshape(-1))
            reps = B * K6_R
            log(f"[K6] {label:8s} svm {svm:10s} B={B} R={K6_R}: same calls "
                f"({int(calls.sum())} in all, {int(calls.sum()) / reps:.3f} "
                f"a repeat); passes a repeat {int(passes.sum()) / reps:.3f} "
                f"(one step a pass: {int(stepwise.sum()) / reps:.3f}); lx "
                f"max abs err {err_l:.3e} rel {rel_l:.3e}; x rel "
                f"{rel_x:.3e}")
            if not (rel_l <= TOL_K6 and rel_x <= TOL_K6):
                raise AssertionError(f"K6 {label} {svm} B={B}: rel "
                                     f"{rel_l}, {rel_x} > {TOL_K6}")
            worst = max(worst, err_l, err_x)
            if fam != timed or (svm == "all_finite" and B != 66):
                continue
            call = lambda: fused.ns_slice_chains(fam, p, *args)
            ms = time_ms(call, 20)
            dev_ms = kernel_device_ms(call, "ns_slice_chains", 10)
            n_svm, n_gp = needed_sums(p, pts, args[6], args[7])
            nbytes = 8 * (2 * B * D + 2 * B + K6_R * B * (D + 31) + N * D
                          + N + NSV * (D + 1) + D * D + 2 * D) + 8 * B
            shape = {"ms": ms, "device_ms": dev_ms, "plain_ms": plain,
                     "calls": int(calls.sum()), "evaluations": len(pts),
                     "passes_per_repeat": int(passes.sum()) / reps,
                     "stepwise_passes_per_repeat": int(stepwise.sum()) / reps,
                     "calls_per_repeat": int(calls.sum()) / reps,
                     "svm_sums": n_svm, "gp_sums": n_gp,
                     **bound(sum_flops(n_svm, n_gp, fam), nbytes)}
            row["shapes"][f"B={B} svm={svm}"] = shape
            log(f"[K6] {label} svm {svm} B={B} R={K6_R}: kernel {ms:.4f} ms "
                f"back to back, {fmt_ms(dev_ms)} ms on the card; plain "
                f"{plain:.1f} ms; {shape['calls']} calls, {len(pts)} "
                f"evaluations, {n_svm} SVM and {n_gp} GP sums needed; "
                f"bound {shape['bound_ms']:.6f} ms")
    row.update({k: v for k, v in row["shapes"]["B=66 svm=fitted"].items()
                if k in ("ms", "device_ms", "plain_ms", "bound_ms",
                         "bound_by", "flops", "bytes", "passes_per_repeat",
                         "stepwise_passes_per_repeat", "calls_per_repeat")})
    row["max_abs_err"] = worst
    row["shape"] = f"B=66 R={K6_R} n={N} nmax={NMAX} d={D} svm=fitted"
    return row


def k12_run(fam, p, state, chol, z, u, lo, hi, adapt, kernel, seen=None):
    """One MCMC phase from ``state`` (x, lp, log_step) on the draws z, u:
    K12, or its plain version (then the proposals it scores are appended
    to ``seen``, if given)."""
    from gpry_tpu_torch.ops import fused
    if kernel:
        return fused.mcmc_chains(fam, p, *state, chol, z, u, lo, hi, adapt)
    logp = fused._in_box_logp(fam, p, lo, hi)

    def logp_of(X):
        if seen is not None:
            seen.append(X)
        return logp(X)

    return fused.mcmc_chains_plain(logp_of, *state, chol, z, u, adapt)


def k12_accepts(Xs, x0):
    """The accept decision of every step and chain, read off the visited
    states (a proposal never equals its chain's state)."""
    import torch
    prev = torch.cat([x0[None], Xs[:-1]])
    return torch.any(Xs != prev, dim=-1)


def k12_same_steps(label, out, ref, x0, adapt):
    """The first K12_STEPS steps of one phase: the same accept decisions,
    x within TOL_K12_X of the box width, the log-densities within rel
    TOL_K12_LP and (warm-up) the step size identical and the moment sums
    s1, s2 within TOL_K12_MOM of their largest entry; returns the largest
    x error and the moment sums' largest gap over their largest entry (0
    for the sampling phase)."""
    import torch
    if not torch.equal(k12_accepts(out[5], x0), k12_accepts(ref[5], x0)):
        raise AssertionError(f"K12 {label}: accept decisions differ")
    err = float(torch.max(torch.abs(out[5] - ref[5])))
    _, rel = rel_err(out[6].reshape(-1), ref[6].reshape(-1))
    if not (err <= TOL_K12_X * K12_BOX and rel <= TOL_K12_LP):
        raise AssertionError(f"K12 {label}: x err {err}, lp rel {rel}")
    if adapt and float(out[2]) != float(ref[2]):
        raise AssertionError(f"K12 {label}: step size {float(out[2])!r} "
                             f"against {float(ref[2])!r}")
    mom = 0.0
    for k, name in ((3, "s1"), (4, "s2")) if adapt else ():
        scale = float(torch.max(torch.abs(ref[k])))
        gap = float(torch.max(torch.abs(out[k] - ref[k])))
        if not gap <= TOL_K12_MOM * scale:
            raise AssertionError(f"K12 {label}: {name} off by {gap} of "
                                 f"{scale}")
        mom = max(mom, gap / scale)
    return err, mom


def k12_stats(Xs, x0):
    """(mean, covariance, their standard errors from the chains' batch
    means and covariances, acceptance rate, split-R-hat) of a sampling
    phase's visited states (steps, chains, d)."""
    import numpy as np
    from gpry_tpu_torch.mc.mcmc import split_rhat
    acc = float(k12_accepts(Xs, x0).double().mean())
    X = Xs.transpose(0, 1).cpu().numpy()
    B, n, d = X.shape
    flat = X.reshape(-1, d)
    per_cov = np.stack([np.cov(c.T) for c in X])
    return (flat.mean(axis=0), np.cov(flat.T),
            X.mean(axis=1).std(axis=0, ddof=1) / np.sqrt(B),
            per_cov.std(axis=0, ddof=1) / np.sqrt(B), acc, split_rhat(X))


def k12_full(fam, p, x0, lp0, draws, lo, hi, kernel, seen=None):
    """A whole run as run_mcmc_device makes it from (x0, lp0): the warm-up
    on chol0, the proposal re-estimated from its moments, the sampling
    phase; returns (warm-up result, its factor, sampling result)."""
    import torch
    from gpry_tpu_torch.mc.mcmc import sampling_factor
    zw, uw, zs, us, chol0 = draws
    B, d = x0.shape
    step0 = torch.zeros((), dtype=torch.float64, device=x0.device)
    w = k12_run(fam, p, (x0, lp0, step0), chol0, zw, uw, lo, hi, True,
                kernel, seen)
    chol_w = sampling_factor(w[3], w[4], zw.shape[0] * B, chol0)
    s = k12_run(fam, p, w[:3], chol_w, zs, us, lo, hi, False, kernel, seen)
    return w, chol_w, s


def k12_inputs(fam, dev, svm, d, B, n, nmax, label):
    """K12's inputs at one configuration of check_k12: the surrogate of
    one mode (synthetic_surrogate, mode=True), B starts about its centre
    with finite log-densities, the draws of a whole run (z and u of the
    warm-up and the sampling phase, and the first phase's factor) and the
    prior box."""
    import torch
    from gpry_tpu_torch.ops import fused
    f64 = dict(dtype=torch.float64, device=dev)
    p = synthetic_surrogate(fam, dev, seed=21, svm=svm, d=d, n=n, nmax=nmax,
                            mode=True)
    gen = torch.Generator(device=dev).manual_seed(d + B)
    x0 = 0.3 * torch.randn((B, d), generator=gen, **f64)
    lp0 = fused.gated_mean_plain(fam, p, x0)
    if not bool(torch.isfinite(lp0).all()):
        raise AssertionError(f"K12 {label}: a start is not finite")
    draws = (torch.randn((K12_WARMUP, B, d), generator=gen, **f64),
             torch.rand((K12_WARMUP, B), generator=gen, **f64),
             torch.randn((K12_SAMPLING, B, d), generator=gen, **f64),
             torch.rand((K12_SAMPLING, B), generator=gen, **f64),
             torch.eye(d, **f64) * (K12_BOX / 10 * 2.38 / d ** 0.5))
    lo = torch.full((d,), -K12_BOX / 2, **f64)
    return p, x0, lp0, draws, lo, -lo


def check_k12(dev, families, timed):
    """K12 against its plain version at path d's ensemble (d = 8, B = 16)
    and at d = 32 (B = 64), on a surrogate with one mode (its training
    points about the box's centre), the SVM fitted (finite in a ball) and
    all finite, and once with the surrogate beyond shared memory (d = 8, n
    = 4,000): step for step over the first K12_STEPS steps of each phase
    (the same state and draws), then, for ``timed`` (and the large
    surrogate), a whole 1,000 + 2,000-step run of each by its statistics:
    means and covariances within K12_SE standard errors, acceptance rates
    within TOL_K12_ACC, split-R-hat below K12_RHAT on both.  Timed at every
    configuration of ``timed``; the bound counts the sums of the proposals
    the plain run scored (needed_sums)."""
    import numpy as np
    import torch
    from gpry_tpu_torch.ops import fused
    f64 = dict(dtype=torch.float64, device=dev)
    worst, shapes = 0.0, {}
    configs = [(svm, d, B, N, NMAX) for svm in ("ball", "all_finite")
               for d, B in K12_CONFIGS] + [("ball", D, 16) + K12_BIG]
    for fam0 in families:
        for svm, d, B, n, nmax in configs:
            big = n != N
            if big and fam0 != timed:
                continue
            fam = spec_kernel(d)[0] if is_spec(fam0) else fam0
            label = f"{'spec' if is_spec(fam) else fam} svm={svm} d={d} " \
                f"B={B} n={n}"
            p, x0, lp0, draws, lo, hi = k12_inputs(fam, dev, svm, d, B, n,
                                                   nmax, label)
            zw, uw, zs, us, chol0 = draws
            step0 = torch.zeros((), **f64)
            # step for step: the warm-up from the start, the sampling phase
            # from the kernel's warm-up end
            n0 = fused.LAUNCHES["mcmc_chains" + ("/spec" if is_spec(fam)
                                                 else "")]
            kw = k12_full(fam, p, x0, lp0, draws, lo, hi, True)
            mom = 0.0
            for adapt, state, chol, z, u in (
                    (True, (x0, lp0, step0), chol0, zw, uw),
                    (False, kw[0][:3], kw[1], zs, us)):
                a, b = (k12_run(fam, p, state, chol, z[:K12_STEPS],
                                u[:K12_STEPS], lo, hi, adapt, kern)
                        for kern in (True, False))
                sync()
                err, gap = k12_same_steps(
                    f"{label} {'warm-up' if adapt else 'sampling'}", a, b,
                    state[0], adapt)
                worst, mom = max(worst, err), max(mom, gap)
            key = "mcmc_chains" + ("/spec" if is_spec(fam) else "")
            if fused.LAUNCHES[key] != n0 + 4:
                raise AssertionError(f"K12 {label}: {fused.LAUNCHES[key]} "
                                     f"launches, expected {n0 + 4}")
            log(f"[K12] {label}: {K12_STEPS} steps of each phase: the same "
                f"accept decisions and step size; s1, s2 within {mom:.2e} "
                "of their largest entry")
            if fam0 != timed:
                continue
            # whole runs, by their statistics
            seen = []
            sync()
            t0 = time.perf_counter()
            pw = k12_full(fam, p, x0, lp0, draws, lo, hi, False, seen)
            sync()
            plain = 1e3 * (time.perf_counter() - t0)
            sk = k12_stats(kw[2][5], kw[0][0])
            sp = k12_stats(pw[2][5], pw[0][0])
            dm = np.max(np.abs(sk[0] - sp[0]) / np.hypot(sk[2], sp[2]))
            dc = np.max(np.abs(sk[1] - sp[1]) / np.hypot(sk[3], sp[3]))
            stats = {"mean_dev_se": float(dm), "cov_dev_se": float(dc),
                     "accept": [sk[4], sp[4]], "rhat": [sk[5], sp[5]],
                     "log_step": [float(kw[0][2]), float(pw[0][2])]}
            log(f"[K12] {label}: whole run " + json.dumps(stats))
            if not (dm <= K12_SE and dc <= K12_SE
                    and abs(sk[4] - sp[4]) <= TOL_K12_ACC
                    and sk[5] < K12_RHAT and sp[5] < K12_RHAT):
                raise AssertionError(f"K12 {label}: whole runs differ: "
                                     f"{stats}")
            calls = [lambda: k12_run(fam, p, (x0, lp0, step0), chol0, zw, uw,
                                     lo, hi, True, True),
                     lambda: k12_run(fam, p, kw[0][:3], kw[1], zs, us, lo, hi,
                                     False, True)]
            # one launch lasts milliseconds: CUDA events time it
            ms = [time_ms(c, 3) for c in calls]
            props = torch.cat(seen)
            n_svm, n_gp = needed_sums(p, props, lo, hi)
            steps = K12_WARMUP + K12_SAMPLING
            nbytes = 8 * (2 * steps * B * (d + 1) + n * (d + 1)
                          + NSV * (d + 1) + d * d + 2 * B * (d + 1) + 7 * d)
            shape = {"ms": sum(ms), "ms_phases": ms,
                     "plain_ms": plain, "proposals": len(props),
                     "svm_sums": n_svm, "gp_sums": n_gp, **stats,
                     **bound(sum_flops(n_svm, n_gp, fam, d, n), nbytes)}
            shapes[label] = shape
            log(f"[K12] {label}: kernel {shape['ms']:.3f} ms a run "
                f"(warm-up {ms[0]:.3f}, sampling {ms[1]:.3f}), plain "
                f"{plain:.1f} ms; bound {shape['bound_ms']:.6f} ms "
                f"({shape['bound_by']})")
    top = next(v for k, v in shapes.items()
               if f"svm=all_finite d={D} B=16" in k)
    return {"max_abs_err": worst, "shapes": shapes,
            "shape": f"d={D} B=16 {K12_WARMUP}+{K12_SAMPLING} steps n={N} "
                     f"nmax={NMAX} svm=all_finite",
            **{k: top[k] for k in ("ms", "plain_ms", "bound_ms", "bound_by",
                                   "flops", "bytes")}}


def k13_bound(nlive, d, B, k):
    """K13's bound for one step on ``st`` (the live set, the k dead
    entries' three arrays and the B points it moves, against its merge,
    logsumexps, covariance and factor)."""
    lg = max(1, (B - 1).bit_length())
    ns = nlive - B
    flops = 2 * (k + nlive) + B * (B + lg) + ns * lg + ns * d * (d + 1) \
        + ns * d + d ** 3 / 3
    nbytes = 8 * (nlive * (d + 1) + 3 * k + 4 * B * (d + 1) + d * d
                  + 3 * B) + 4 * nlive + 8 * 5
    return bound(flops, nbytes)


def check_k13(dev):
    """K13 against its plain version on crafted states (the kinds of
    tests/test_torch_cuda.py's ns_state, two seeds) at nlive 200 and 400
    (d = 8) and 3,200 (d = 64): the same stop flag, kill order, dead
    buffer, lstar, starts and live order, the Cholesky factor within
    TOL_K13_CHOL of its largest entry; after the previous chains are
    applied, the same live set, k, calls and steps.  Then through runs of
    24 steps with K6-like new points (ns_step_sequence: ties, -inf, NaN, a
    plateau; the live order kept, lost and refused), every output compared
    after every step.  Timed (device ms, torch.profiler) halfway through
    the dead buffer ("mid") at K13_TIMED, each call applying a kill and
    selecting the next: the steady state of a run (the live order known:
    the merge) and a run's first step (the order unknown: the full
    sort)."""
    import torch
    from gpry_tpu_torch.ops import fused
    from test_torch_cuda import ns_state, ns_step_sequence
    worst = 0.0
    for nlive, d in K13_SHAPES:
        for kind in ("ties", "neg_inf", "full", "converged", "plateau",
                     "mid"):
            for seed in (0, 1):
                st, starts, chains, consts = ns_state(dev, nlive, d, kind,
                                                      seed)
                ref = fused.NSState(*(t.clone() for t in st))
                n0 = fused.LAUNCHES["ns_step"]
                fused.ns_step(st, *chains, starts, *consts)
                fused.ns_step_plain(ref, *chains, starts, *consts)
                sync()
                if fused.LAUNCHES["ns_step"] != n0 + 1:
                    raise AssertionError("K13: not one launch")
                label = f"nlive={nlive} d={d} {kind} seed {seed}"
                for name in ("done", "count", "kill", "dead_X", "dead_logl",
                             "x0", "lx0", "lstar", "live_X", "live_logl",
                             "order"):
                    if not torch.equal(getattr(st, name), getattr(ref, name)):
                        raise AssertionError(f"K13 {label}: {name} differs")
                if not torch.equal(torch.isnan(st.chol),
                                   torch.isnan(ref.chol)):
                    raise AssertionError(f"K13 {label}: chol NaN masks")
                fin = ~torch.isnan(ref.chol)
                if bool(fin.any()):
                    err = float(torch.max(torch.abs(st.chol[fin]
                                                    - ref.chol[fin])))
                    scale = float(torch.max(torch.abs(ref.chol[fin])))
                    if not err <= TOL_K13_CHOL * scale:
                        raise AssertionError(f"K13 {label}: chol err {err}")
                    worst = max(worst, err)
                fused.ns_step(st, *chains, starts, *consts, select=False)
                fused.ns_step_plain(ref, *chains, starts, *consts,
                                    select=False)
                sync()
                for name in ("done", "count", "live_X", "live_logl",
                             "order"):
                    if not torch.equal(getattr(st, name), getattr(ref, name)):
                        raise AssertionError(f"K13 {label}: {name} differs "
                                             "after the apply")
            log(f"[K13] nlive={nlive} d={d} {kind}: identical (done "
                f"{int(st.done)})")
        for kind in K13_KINDS:
            st, ref = ns_step_sequence(dev, nlive, d, kind)
            fin = ~torch.isnan(ref.chol)
            if bool(fin.any()):
                worst = max(worst, float(torch.max(torch.abs(
                    st.chol[fin] - ref.chol[fin]))))
            log(f"[K13] nlive={nlive} d={d} 24 steps of {kind}: identical "
                f"(done {int(st.done)}, k {int(st.count[0])})")
    shapes = {}
    for nlive, d in K13_TIMED:
        st, starts, chains, consts = ns_state(dev, nlive, d, "mid")
        fused.ns_step(st, *chains, starts, *consts)
        ref = fused.NSState(*(t.clone() for t in st))
        c0 = st.count.clone()
        B, k = nlive // 6, int(c0[0])

        def call(step, state, first=False):
            state.count.copy_(c0)
            if first:
                state.order.fill_(-1)
            step(state, *chains, starts, *consts)

        ms = time_ms(lambda: call(fused.ns_step, st), 200)
        dev_ms = kernel_device_ms(lambda: call(fused.ns_step, st),
                                  "ns_step_kernel", 50)
        first_ms = kernel_device_ms(lambda: call(fused.ns_step, st, True),
                                    "ns_step_kernel", 50)
        plain = time_ms(lambda: call(fused.ns_step_plain, ref), 20)
        if int(st.done) or int(st.count[3]) != 1 or int(st.order[0]) < 0:
            raise AssertionError("K13: the timed state stopped")
        # ms: the device time; CUDA events' (the launch included) only
        # where the profiler saw no launch, and ms_of then says so
        row = {"ms": ms if dev_ms is None else dev_ms,
               "ms_of": "CUDA events" if dev_ms is None else
               "device (torch.profiler)", "device_ms": dev_ms,
               "events_ms": ms, "first_step_ms": first_ms,
               "plain_ms": plain, "k": k, **k13_bound(nlive, d, B, k),
               "shape": f"nlive={nlive} d={d} B={B} max_dead_tot="
                        f"{st.dead_logl.shape[0]} k={k}"}
        shapes[f"nlive={nlive} d={d}"] = row
        log(f"[K13] {row['shape']}: steady step {fmt_ms(dev_ms)} ms on "
            f"the card ({ms:.4f} ms back to back with a 4-entry copy), "
            f"first step (the full sort) {fmt_ms(first_ms)} ms; plain "
            f"{plain:.3f} "
            f"ms; bound {row['bound_ms']:.6f} ms ({row['bound_by']})")
    top = shapes[f"nlive={K13_TIMED[0][0]} d={K13_TIMED[0][1]}"]
    return {"max_abs_err": worst, "shapes": shapes,
            **{k: top[k] for k in ("ms", "ms_of", "device_ms", "events_ms",
                                   "plain_ms", "bound_ms", "bound_by",
                                   "flops", "bytes", "shape")}}


def k1_bound(family, p, Xq):
    """K1's bound at queries Xq: the sums their inputs need (needed_sums);
    the queries, the training set and the support vectors in, the outputs
    out."""
    nq = Xq.shape[0]
    n_svm, n_gp = needed_sums(p, Xq)
    return {"svm_sums": n_svm, "gp_sums": n_gp, **bound(
        sum_flops(n_svm, n_gp, family),
        8 * (nq * D + nq + N * D + N + NSV * (D + 1) + 4 * D))}


def check_k1(dev, rng, families, timed, sizes):
    """K1 at the batch sizes of the main paths with the SVM fitted and all
    finite, each in the geometry its plan gives it (gated_mean_plan);
    ``timed`` (SVM fitted) timed at every size by CUDA events and by its
    device ms (torch.profiler)."""
    import torch
    from gpry_tpu_torch.ops import fused
    worst = 0.0
    shapes = {}
    for fam in families:
        label = "spec" if is_spec(fam) else fam
        spec_doubles = fused._spec_doubles(fused._kern(fam, D, dev))
        for svm in ("fitted", "all_finite"):
            p = synthetic_surrogate(fam, dev, seed=11, svm=svm)
            is_timed = fam == timed and svm == "fitted"
            for nq in sizes:
                Xq = torch.as_tensor(rng.uniform(-5, 5, (nq, D)),
                                     dtype=torch.float64, device=dev)
                b = fused.gated_mean_plain(fam, p, Xq)
                a = fused.gated_mean(fam, p, Xq)
                torch.cuda.synchronize()
                err, rel = rel_err(a, b)
                geo = fused.gated_mean_plan(
                    nq, N, NSV if svm == "fitted" else 0, D, spec_doubles)
                log(f"[K1] {label:8s} svm {svm:10s} nq={nq:6d} plan "
                    f"{geo[:5]}: max abs err {err:.3e}, rel {rel:.3e}, "
                    f"finite {int(torch.isfinite(b).sum())}")
                if not rel <= TOL_K1:
                    raise AssertionError(f"K1 {label} {svm} nq={nq}: rel "
                                         f"{rel} > {TOL_K1}")
                worst = max(worst, err)
                if not is_timed:
                    continue
                reps = 20 if nq == 65536 else 200
                call = lambda: fused.gated_mean(fam, p, Xq)
                shape = {"plan": geo[:5], "ms": time_ms(call, reps),
                         "device_ms": kernel_device_ms(call, "gated_mean",
                                                       20),
                         "plain_ms": time_ms(
                             lambda: fused.gated_mean_plain(fam, p, Xq),
                             reps if not is_spec(fam) else 5),
                         **k1_bound(fam, p, Xq)}
                shapes[f"nq={nq}"] = shape
                log(f"[K1] {label} nq={nq}: " + json.dumps(shape))
    top = shapes["nq=65536"]
    return {"max_abs_err": worst, "shapes": shapes,
            "shape": f"nq=65536 n={N} nmax={NMAX} d={D}",
            **{k: top[k] for k in ("ms", "device_ms", "plain_ms", "bound_ms",
                                   "bound_by", "flops", "bytes")}}


def k2_bound(family, nq):
    """K2's bound at nq queries (n = N of NMAX, d = D): per query the k
    vector and the SVM sum, the length-n forward substitution (n^2 / 2
    multiply-adds), the mean and the sum of squares; the queries, the
    training set, the triangle of L, the support vectors in, the outputs
    out."""
    return bound(
        nq * (N * pair_flops(family) + NSV * (3 * D + 3) + N * N + 4 * N),
        8 * (nq * D + nq + N * D + N + N * (N + 1) // 2 + NSV * (D + 1)
             + 4 * D))


def k2_queries(p, rng, nq, dev):
    """K2's queries: at the screen's nq uniform over [-5, 5]^D (across and
    outside the trust box); in a small batch (nq < 16) the first two
    thirds (at least one) inside the trust box where the SVM says finite,
    so that their values pass the gates, the rest over [-5, 5]^D."""
    import numpy as np
    import torch
    from gpry_tpu_torch.models.classifier import svm_decision
    t = lambda a: torch.as_tensor(a, dtype=torch.float64, device=dev)
    if nq >= 16:
        return t(rng.uniform(-5, 5, (nq, D)))
    inside = (2 * nq + 2) // 3
    cand = t(rng.uniform(-4.5, 4.5, (64 * inside, D)))
    ok = cand[svm_decision(p.svm, (cand - p.x_loc) / p.x_scale)]
    if ok.shape[0] < inside:
        raise AssertionError("K2: too few draws pass the gates")
    return torch.cat([ok[:inside], t(rng.uniform(-5, 5, (nq - inside, D)))])


def check_k2(dev, rng, families, timed):
    """K2 at the acquisition screen's nq = K2_NQ[-1] and the believer's
    small batches (K2_NQ; k2_queries), in both output modes, each compared
    at TOL_K2 on at least one value that passed the gates; timed at each
    (CUDA events back to back, and at the small batches the kernel's
    device time in a torch.profiler trace)."""
    import torch
    from gpry_tpu_torch.ops import fused
    worst = 0.0
    shapes = {}
    lexp = (D ** -0.85, 0.01)
    for fam in families:
        label = "spec" if is_spec(fam) else fam
        p = synthetic_surrogate(fam, dev, seed=12)
        for nq in K2_NQ:
            Xq = k2_queries(p, rng, nq, dev)
            ma, sa = fused.gated_meanvar_logexp(fam, p, Xq)
            mb, sb = fused.gated_meanvar_logexp_plain(fam, p, Xq)
            la = fused.gated_meanvar_logexp(fam, p, Xq, logexp=lexp)
            lb = fused.gated_meanvar_logexp_plain(fam, p, Xq, logexp=lexp)
            torch.cuda.synchronize()
            for what, a, b in (("mean", ma, mb), ("std", sa, sb),
                               ("logexp", la, lb)):
                # a gated value is -inf, or a sigma of 0
                if not bool((b[torch.isfinite(b)] != 0).any()):
                    raise AssertionError(f"K2 {label} nq={nq} {what}: no "
                                         "value passed the gates")
                err, rel = rel_err(a, b)
                log(f"[K2] {label:8s} nq={nq:5d} {what:6s}: max abs err "
                    f"{err:.3e}, rel {rel:.3e}")
                if not rel <= TOL_K2:
                    raise AssertionError(f"K2 {label} nq={nq} {what}: rel "
                                         f"{rel} > {TOL_K2}")
                worst = max(worst, err)
            if fam != timed:
                continue
            call = lambda: fused.gated_meanvar_logexp(fam, p, Xq,
                                                      logexp=lexp)
            shape = {"ms": time_ms(call, 50 if nq > 16 else 200),
                     "plain_ms": time_ms(lambda: fused.
                                         gated_meanvar_logexp_plain(
                                             fam, p, Xq, logexp=lexp), 50),
                     "route": fused.gated_meanvar_logexp_plan(
                         N, NMAX, D, nq,
                         fused._spec_doubles(fused._kern(fam, D, dev)))[:2],
                     **k2_bound(fam, nq)}
            if nq < 16:
                shape["device_ms"] = kernel_device_ms(call, "gated_meanvar",
                                                      50)
            shapes[f"nq={nq}"] = shape
            log(f"[K2] {label} nq={nq}: " + json.dumps(shape))
    top = shapes[f"nq={K2_NQ[-1]}"]
    return {"max_abs_err": worst, "shapes": shapes,
            "shape": f"nq={K2_NQ[-1]} n={N} nmax={NMAX} d={D}",
            **{k: top[k] for k in ("ms", "plain_ms", "bound_ms", "bound_by",
                                   "flops", "bytes")}}


# K3's row panels: the appends of 1 and 8 points (chol_append, rows n -
# k .. n of the grown set)
K3_PANELS = (1, 8)


def check_k3(dev, rng, families, timed):
    """K3 at the fit's LML screen (R = 2048 thetas, one theta row per
    matrix), scalar and vector noise; at the paths' shapes, one theta row
    (factorize) and the row panels of K3_PANELS (chol_append): each panel
    equal to the whole matrix's rows bit for bit, the whole matrix bit for
    bit symmetric on the fast families (the spec families within TOL_K3 of
    the plain version, as the whole matrix is); ``timed`` at R = 1 and the
    panels by CUDA events and device ms (torch.profiler), each with its
    bound."""
    import numpy as np
    import torch
    from gpry_tpu_torch.ops import fused
    worst = 0.0
    R = 2048
    X = torch.zeros((NMAX, D), dtype=torch.float64, device=dev)
    X[:N] = torch.as_tensor(rng.uniform(0, 1, (N, D)), device=dev)
    noise_vec = torch.as_tensor(rng.uniform(1e-5, 1e-3, NMAX),
                                dtype=torch.float64, device=dev)
    chunk = 64

    def thetas_of(fam):
        if is_spec(fam):
            theta0 = np.asarray(spec_kernel()[1])
            th = theta0 + rng.uniform(-1.0, 1.0, (R, len(theta0)))
        else:
            th = np.column_stack([
                rng.uniform(np.log(1e-4), np.log(1e6), R),
                rng.uniform(np.log(1e-3), np.log(10.0), (R, D))])
        return torch.as_tensor(th, dtype=torch.float64, device=dev)

    def k3_plain(fam, th, noise):
        return torch.cat([fused.masked_kernel_matrix_plain(
            fam, th[i:i + chunk], X, N, noise)
            for i in range(0, len(th), chunk)])

    def timed_at(fam, th, noise, rows, reps, **b):
        call = lambda: fused.masked_kernel_matrix_batched(
            fam, th, X, N, noise, rows=rows)
        return {"ms": time_ms(call, reps),
                "device_ms": kernel_device_ms(call, "masked_kernel_matrix",
                                              50), **b}

    row = {}
    for fam in families:
        label = "spec" if is_spec(fam) else fam
        thetas = thetas_of(fam)
        for noise in (torch.tensor(1e-4, dtype=torch.float64, device=dev),
                      noise_vec):
            th = thetas if fam == timed and noise.ndim == 0 \
                else thetas[:256]
            a = fused.masked_kernel_matrix_batched(fam, th, X, N, noise)
            t0 = time.perf_counter()
            b = k3_plain(fam, th, noise)
            sync()
            plain_once = 1e3 * (time.perf_counter() - t0)
            err, rel = rel_err(a, b)
            log(f"[K3] {label:8s} R={len(th)} noise "
                f"{'vector' if noise.ndim else 'scalar'}: max abs err "
                f"{err:.3e}, rel {rel:.3e}")
            if not rel <= TOL_K3:
                raise AssertionError(f"K3 {label}: rel {rel} > {TOL_K3}")
            worst = max(worst, err)
            if not is_spec(fam) and not torch.equal(a, a.transpose(1, 2)):
                raise AssertionError(f"K3 {label}: the whole matrix is not "
                                     "bit for bit symmetric")
            for k in K3_PANELS:
                P = fused.masked_kernel_matrix_batched(
                    fam, th[:64], X, N, noise, rows=(N - k, N))
                Pb = fused.masked_kernel_matrix_plain(
                    fam, th[:64], X, N, noise, rows=(N - k, N))
                sync()
                if not torch.equal(P, a[:64, N - k:N]):
                    raise AssertionError(f"K3 {label}: the panel of {k} "
                                         "rows is not the whole matrix's")
                perr, prel = rel_err(P, Pb)
                if not prel <= TOL_K3:
                    raise AssertionError(f"K3 {label} panel {k}: rel "
                                         f"{prel} > {TOL_K3}")
                worst = max(worst, perr)
            del a, b
            if fam == timed and noise.ndim == 0:
                ms = time_ms(lambda: fused.masked_kernel_matrix_batched(
                    fam, thetas, X, N, noise), 10)
                plain = plain_once if is_spec(fam) else time_ms(
                    lambda: k3_plain(fam, thetas, noise), 3)
                # the paths' launches: one theta row (factorize), the
                # panels (chol_append)
                r1 = timed_at(fam, thetas[:1], noise, None, 200,
                              **k3_bound(timed, 1))
                panels = {f"k={k}": timed_at(fam, thetas[:1], noise,
                                             (N - k, N), 200,
                                             **k3_bound(timed, 1, k))
                          for k in K3_PANELS}
                log(f"[K3] {label} R={R}: kernel {ms:.4f} ms, plain "
                    f"{plain:.4f} ms; R=1: " + json.dumps(r1) +
                    "; panels: " + json.dumps(panels))
                row = {"ms": ms, "plain_ms": plain, "r1": r1,
                       "panels": panels, "path_bound_ms": r1["bound_ms"],
                       "panel_bound_ms": panels["k=1"]["bound_ms"]}
    row.update({"max_abs_err": worst,
                "shape": f"R={R} n={N} nmax={NMAX} d={D}"})
    row.update(k3_bound(timed, R))
    torch.cuda.empty_cache()
    return row


def k3_bound(family, R, k=None):
    """K3's bound for R theta rows: every valid entry of every theta's K
    once (the lower triangle: the matrix is symmetric), the whole padded
    matrix written; with k, a panel of k valid rows: k N entries, k rows
    written."""
    if k is None:
        return bound(R * N * (N + 1) // 2 * pair_flops(family),
                     8 * (R * (D + 1) + N * D + R * NMAX * NMAX))
    return bound(R * k * N * pair_flops(family),
                 8 * (R * (D + 1) + N * D + R * k * NMAX))


def k7_bound(family, nq):
    """K7's bound at nq queries (n = N of NMAX, d = D): the k vectors and
    the mean, the substitutions (n^2 / 2 multiply-adds per query), and
    Kqq - V^T V on one triangle (the covariance is symmetric); bytes: the
    queries, the training rows, alpha, the valid triangle of L, the mean
    and the whole covariance."""
    return bound(
        nq * N * (pair_flops(family) + 2) + nq * N * N
        + nq * (nq + 1) // 2 * (pair_flops(family) + 2 * N),
        8 * (nq * D + N * D + N + N * (N + 1) // 2 + nq + nq * nq))


def at_offset(t):
    """A contiguous copy of ``t`` whose data starts 8 bytes into its
    buffer (not 16-byte aligned: the solves take their route 1)."""
    import torch
    buf = torch.empty(t.numel() + 1, dtype=t.dtype, device=t.device)
    view = buf[1:].view(t.shape)
    view.copy_(t)
    return view


def k7_same_sigma(fam, p, Xq, cov):
    """Whether sqrt(max(diag(cov), 0)) y_scale equals K5's sigma at the
    same queries bit for bit: K5 is given Xq as raw coordinates with x_loc
    0 and x_scale 1, so that it forms K7's coordinates exactly."""
    import torch
    from gpry_tpu_torch.ops import fused
    p5 = p.replace(x_loc=torch.zeros_like(p.x_loc),
                   x_scale=torch.ones_like(p.x_scale))
    s5 = fused.meanvar_ungated(fam, p5, Xq)[1]
    s7 = torch.sqrt(torch.clamp_min(torch.diagonal(cov), 0.0)) * p.y_scale
    return bool(torch.equal(s7, s5))


def check_k7(dev, rng, families, timed):
    """K7 against its plain version at K7_NQ queries (the first ones on
    training points): the mean within rel TOL_K7, the covariance within an
    absolute TOL_K7_COV max|K(Xq, Xq)|, symmetric bit for bit, and
    sqrt(max(diag(cov), 0)) y_scale K5's sigma bit for bit (k7_same_sigma;
    K7's plan, route and Q, asserted K5's), with L 16-byte aligned (route
    0) and, at nq = 64, 8 bytes off (route 1).  Timed at K7_TIMED: the call
    (CUDA events), each of its two kernels' device ms (torch.profiler), the
    plain version, and at NQ_COV the library's two phases as yardsticks
    (never called by the port): solve_triangular for V and addmm for
    Kqq - V^T V."""
    import torch
    from gpry_tpu_torch.ops import fused
    from gpry_tpu_torch.ops.kernels import cross_kernel
    worst = 0.0
    shapes = {}
    for fam in families:
        label = "spec" if is_spec(fam) else fam
        p = synthetic_surrogate(fam, dev, seed=16)
        sd = fused._spec_doubles(fused._kern(fam, D, dev))
        for nq, layout in [(nq, "aligned") for nq in K7_NQ] + \
                [(64, "offset")]:
            Xq = torch.as_tensor(rng.uniform(0, 1, (nq, D)),
                                 dtype=torch.float64, device=dev)
            Xq[:min(nq, 32)] = p.X[:min(nq, 32)]
            q = p if layout == "aligned" else p.replace(L=at_offset(p.L))
            args = (q.theta, q.X, q.n, q.noise_var, q.L, q.alpha, Xq)
            ma, ca = fused.predict_meancov(fam, *args)
            mb, cb = fused.predict_meancov_plain(fam, *args)
            kqq = fused.predict_meancov_plain(
                fam, q.theta, q.X, 0, q.noise_var, q.L, q.alpha, Xq)[1]
            sync()
            err_m, rel_m = rel_err(ma, mb)
            err_c = float(torch.max(torch.abs(ca - cb)))
            tol_c = TOL_K7_COV * float(torch.max(torch.abs(kqq)))
            aligned = q.L.data_ptr() % 16 == 0
            plan = fused.predict_meancov_plan(N, NMAX, D, nq, sd, aligned)
            if plan[:2] != fused.meanvar_ungated_plan(N, NMAX, D, nq, sd,
                                                      aligned)[:2] or \
                    plan[0] != (layout == "offset"):
                raise AssertionError(f"K7 {label} nq={nq} {layout}: route "
                                     f"{plan[:2]} is not K5's")
            sym = bool(torch.equal(ca, ca.T))
            same = k7_same_sigma(fam, q, Xq, ca)
            log(f"[K7] {label:8s} nq={nq:5d} route {plan[:2]}: mean rel "
                f"{rel_m:.3e}; cov max abs err {err_c:.3e} (tol "
                f"{tol_c:.3e}); symmetric bit for bit {sym}; sigma K5's "
                f"bit for bit {same}")
            if not (rel_m <= TOL_K7 and err_c <= tol_c):
                raise AssertionError(f"K7 {label} nq={nq}: mean rel {rel_m} "
                                     f"or cov abs {err_c} > {tol_c}")
            if not (sym and same):
                raise AssertionError(f"K7 {label} nq={nq} {layout}: cov not "
                                     "symmetric or its diagonal not K5's "
                                     "sigma^2, bit for bit")
            worst = max(worst, err_m, err_c)
            if fam != timed or nq not in K7_TIMED or layout != "aligned":
                continue
            call = lambda: fused.predict_meancov(fam, *args)
            shape = {"ms": time_ms(call, 200 if nq < NQ_COV else 50),
                     "solve_device_ms": kernel_device_ms(
                         call, "meancov_solve", 50),
                     "product_device_ms": kernel_device_ms(
                         call, "meancov_cov", 50),
                     "plain_ms": time_ms(lambda: fused.predict_meancov_plain(
                         fam, *args), 20),
                     "route": plan[:2], **k7_bound(fam, nq)}
            if nq == NQ_COV:
                Ln = q.L[:N, :N]
                KqT = cross_kernel(fam, q.theta, q.X[:N], Xq)
                Vt = torch.linalg.solve_triangular(Ln, KqT, upper=False)
                shape["library_solve_ms"] = time_ms(
                    lambda: torch.linalg.solve_triangular(Ln, KqT,
                                                          upper=False), 50)
                shape["library_product_ms"] = time_ms(
                    lambda: torch.addmm(kqq, Vt.T, Vt, alpha=-1), 50)
            shapes[f"nq={nq}"] = shape
            log(f"[K7] {label} nq={nq}: " + json.dumps(shape))
    top = shapes[f"nq={NQ_COV}"]
    return {"max_abs_err": worst, "shapes": shapes,
            "shape": f"nq={NQ_COV} n={N} nmax={NMAX} d={D}",
            **{k: top[k] for k in ("ms", "solve_device_ms",
                                   "product_device_ms", "plain_ms",
                                   "library_solve_ms", "library_product_ms",
                                   "bound_ms", "bound_by", "flops",
                                   "bytes")}}


def grad_row_flops(family, d=D):
    """FP64 operations of one training row's gradient contribution
    dk(x, X_j)/dx weighted twice (alpha_j and w_j): for a fast family r^2
    again and dk/d(r^2) (3 d + 3) and two multiply-adds per coordinate;
    in spec mode the forward mode carries d partials beside each value
    ((1 + d) pair_flops)."""
    if not is_spec(family):
        return 3 * d + 3 + 5 * d
    return (1 + d) * pair_flops(family, d) + 4 * d


def k8_bound(family, nq, d=D, n=N):
    """K8's bound at nq queries (n = N of NMAX, d = D unless given): per
    query k and k . alpha, the two substitutions (n^2 / 2 multiply-adds
    each), each row's gradient; bytes: the queries, the training rows,
    alpha, the valid triangle of L, the four outputs."""
    return bound(
        nq * (n * (pair_flops(family, d) + 2) + 2 * n * n
              + n * grad_row_flops(family, d)),
        8 * (nq * d + n * d + n + n * (n + 1) // 2 + nq * (2 + 2 * d)))


def check_k8(dev, rng, families, timed):
    """K8 against its plain version (autograd) at K8_NQ (the generic
    ascent's lanes, predict's draws), the first queries on training
    points: mean and std within rel TOL_K8, both gradients within
    TOL_K8_GRAD of their max |.|.  Where K8 and K5 take the same route-0
    plan (asserted at these shapes), K8's mean and std equal K5's bit for
    bit.  Timed at K8_TIMED (CUDA events back to back, and the kernel's
    device ms in a torch.profiler trace), with the bound at each."""
    import torch
    from gpry_tpu_torch.ops import fused
    worst = 0.0
    shapes = {}
    for fam in families:
        label = "spec" if is_spec(fam) else fam
        p = synthetic_surrogate(fam, dev, seed=17)
        sd = fused._spec_doubles(fused._kern(fam, D, dev))
        for nq in K8_NQ:
            Xq = torch.as_tensor(rng.uniform(-5, 5, (nq, D)),
                                 dtype=torch.float64, device=dev)
            Xq[:min(nq, 32)] = p.X[:min(nq, 32)] * p.x_scale + p.x_loc
            out = fused.meanstd_grad(fam, p, Xq)
            ref = fused.meanstd_grad_plain(fam, p, Xq)
            m5, s5 = fused.meanvar_ungated(fam, p, Xq)
            sync()
            errs = []
            for what, a, b, tol in zip(("mean", "std", "dmean", "dstd"),
                                       out, ref, (TOL_K8, TOL_K8,
                                                  TOL_K8_GRAD,
                                                  TOL_K8_GRAD)):
                err, rel = rel_err(a.reshape(-1), b.reshape(-1))
                errs.append(f"{what} rel {rel:.3e}")
                if not rel <= tol:
                    raise AssertionError(f"K8 {label} nq={nq} {what}: rel "
                                         f"{rel} > {tol}")
                worst = max(worst, err)
            plan = fused.meanstd_grad_plan(N, NMAX, D, nq, sd)
            if plan[0] != 0 or plan != fused.meanvar_ungated_plan(N, NMAX, D,
                                                                  nq, sd):
                raise AssertionError(f"K8 {label} nq={nq}: K5's plan differs "
                                     "from K8's route 0")
            same = torch.equal(out[0], m5) and torch.equal(out[1], s5)
            log(f"[K8] {label:8s} nq={nq:5d} route {plan[:2]}: "
                + "; ".join(errs) + f"; mean and std K5's bit for bit {same}")
            if not same:
                raise AssertionError(f"K8 {label} nq={nq}: mean and std not "
                                     "K5's bit for bit")
            if fam != timed or nq not in K8_TIMED:
                continue
            call = lambda: fused.meanstd_grad(fam, p, Xq)
            shape = {"ms": time_ms(call, 20 if nq > 64 else 200),
                     "device_ms": kernel_device_ms(call, "meanstd_grad", 20),
                     "plain_ms": time_ms(lambda: fused.meanstd_grad_plain(
                         fam, p, Xq), 5),
                     "route": plan[:2], **k8_bound(fam, nq)}
            shapes[f"nq={nq}"] = shape
            log(f"[K8] {label} nq={nq}: " + json.dumps(shape))
    top = shapes[f"nq={NQ_COV}"]
    return {"max_abs_err": worst, "shapes": shapes,
            "shape": f"nq={NQ_COV} n={N} nmax={NMAX} d={D}",
            **{k: top[k] for k in ("ms", "device_ms", "plain_ms", "bound_ms",
                                   "bound_by", "flops", "bytes")}}


def k9_inputs(family, dev, seed, clip=False, n=N, d=D):
    """K9's arguments at the main paths' believer step: the synthetic
    surrogate with a classifier that has seen no -inf, no trust box and no
    upper clip (the ascent runs on the smooth surrogate; the synthetic clip
    at the 90% quantile of the mean would flatten the centre of the box,
    where a run's clip sits above its data), 8 restarts in the prior box
    [-5, 5]^D, lane 0 on the last training point (as multi_add places
    it), LogExp's zeta at D and a noise std of 0.01.  With ``clip``, an
    upper clip at the median of the mean at the 8 starts: 4 lanes start
    above it, where min(mean, clip_max) passes no gradient.  ``n`` valid
    rows of max(n, NMAX); at ``d`` dimensions (a fast family's length
    scales times sqrt(d / D), zeta at d)."""
    import torch
    from gpry_tpu_torch.ops import fused
    p = synthetic_surrogate(family, dev, seed=18, svm="all_finite", n=n,
                            nmax=max(n, NMAX), d=d,
                            ls_scale=math.sqrt(d / D))
    inf = torch.full((d,), torch.inf, dtype=torch.float64, device=dev)
    p = p.replace(clip_max=torch.tensor(torch.inf, dtype=torch.float64,
                                        device=dev),
                  trust_lo=-inf, trust_hi=inf)
    gen = torch.Generator(device=dev).manual_seed(seed)
    lo = torch.full((d,), -5.0, dtype=torch.float64, device=dev)
    x0s = torch.rand((8, d), generator=gen, dtype=torch.float64,
                     device=dev) * 10.0 - 5.0
    x0s[0] = p.X[n - 1] * p.x_scale + p.x_loc
    if clip:
        mu0 = fused.meanvar_ungated_plain(family, p, x0s)[0]
        p = p.replace(clip_max=torch.quantile(mu0, 0.5))
    return p, (d ** -0.85, 0.01, x0s, lo, -lo)


def check_k9(dev, families, timed):
    """K9 against its plain version lane by lane on 8 restarts at d = D,
    n = N (lane 0 on a training point), with no upper clip and with one
    that binds at half of the starts (k9_inputs): step for step over
    K9_STEPS iterations, the same nev, x within TOL_K9_X of the box width
    and f within TOL_K9_F (1 + |f|) per lane.  With no clip also to the
    end (maxiter 100): the same per-lane tolerances on x and f, and the
    pick (the largest gated rescore of the endpoints, K2) within
    TOL_K9_F (1 + |v|).  nev at the end is reported, not compared: near an
    optimum the stall test and the last line search decide on rounding
    that the kernel and the plain version do not share.  ``timed`` is
    timed, and its bound counts the sums of the evaluations its plain
    version makes: 1 + iterations value-and-gradient calls per lane, the
    rest of its nev probes.  Then at each n of EDGE_NS (no clip) step for
    step over K9_STEPS iterations with the same tolerances."""
    import torch
    from gpry_tpu_torch.ops import fused
    worst = 0.0
    row = {}
    for fam in families:
        for n in EDGE_NS:
            label = f"{'spec' if is_spec(fam) else fam} n={n}"
            p, args = k9_inputs(fam, dev, seed=19, n=n)
            width = float(torch.max(args[4] - args[3]))
            route = fused.lbfgs_logexp_ascent_plan(
                n, D, fused._spec_doubles(fused._kern(fam, D, dev)))
            xs, f, nev = fused.lbfgs_logexp_ascent(fam, p, *args,
                                                   maxiter=K9_STEPS)
            xr, fr, nevr = fused.lbfgs_logexp_ascent_plain(
                fam, p, *args, maxiter=K9_STEPS)
            sync()
            err_x = float(torch.max(torch.abs(xs - xr)))
            err_f = float(torch.max(torch.abs(f - fr) / (1 + torch.abs(fr))))
            log(f"[K9] {label:12s} (route {route[0]}, X staged "
                f"{route[1]}): over {K9_STEPS} iterations nev "
                f"{nev.tolist()} (plain {nevr.tolist()}), x max abs err "
                f"{err_x:.3e}, f rel {err_f:.3e}")
            if not (nev.tolist() == nevr.tolist()
                    and err_x <= TOL_K9_X * width and err_f <= TOL_K9_F):
                raise AssertionError(f"K9 {label}: nev {nev.tolist()} "
                                     f"against {nevr.tolist()}, x {err_x}, "
                                     f"f {err_f}")
            worst = max(worst, err_x, float(torch.max(torch.abs(f - fr))))
    for fam, clip in ((fam, clip) for fam in families
                      for clip in (False, True)):
        label = ("spec" if is_spec(fam) else fam) + (" clip" if clip else "")
        p, args = k9_inputs(fam, dev, seed=19, clip=clip)
        zeta, noise, x0s, lo, hi = args
        width = float(torch.max(hi - lo))
        xs, f, nev = fused.lbfgs_logexp_ascent(fam, p, *args,
                                               maxiter=K9_STEPS)
        xr, fr, nevr = fused.lbfgs_logexp_ascent_plain(fam, p, *args,
                                                       maxiter=K9_STEPS)
        sync()
        err_x = float(torch.max(torch.abs(xs - xr)))
        err_f = float(torch.max(torch.abs(f - fr) / (1 + torch.abs(fr))))
        log(f"[K9] {label:12s}: over {K9_STEPS} iterations nev "
            f"{nev.tolist()} (plain {nevr.tolist()}), x max abs err "
            f"{err_x:.3e}, f rel {err_f:.3e}")
        if not (nev.tolist() == nevr.tolist() and err_x <= TOL_K9_X * width
                and err_f <= TOL_K9_F):
            raise AssertionError(f"K9 {label}: after {K9_STEPS} iterations "
                                 f"nev {nev.tolist()} against "
                                 f"{nevr.tolist()}, x {err_x}, f {err_f}")
        worst = max(worst, err_x, float(torch.max(torch.abs(f - fr))))
        if clip:
            continue
        xs, f, nev = fused.lbfgs_logexp_ascent(fam, p, *args)
        t0 = time.perf_counter()
        xr, fr, nevr, iters = fused.lbfgs_logexp_ascent_plain(
            fam, p, *args, return_iters=True)
        sync()
        plain_once = 1e3 * (time.perf_counter() - t0)
        err_x = float(torch.max(torch.abs(xs - xr)))
        err_f = torch.abs(f - fr) / (1 + torch.abs(fr))
        vk = fused.gated_meanvar_logexp(fam, p, xs, logexp=(zeta, noise))
        vr = fused.gated_meanvar_logexp(fam, p, xr, logexp=(zeta, noise))
        pick_k, pick_r = float(vk.max()), float(vr.max())
        err_pick = abs(pick_k - pick_r) / (1 + abs(pick_r))
        log(f"[K9] {label:12s}: to the end x max abs err {err_x:.3e} (tol "
            f"{TOL_K9_X * width:.1e}), f rel {float(err_f.max()):.3e}, pick "
            f"rel {err_pick:.3e}; nev {nev.tolist()} (plain "
            f"{nevr.tolist()})")
        if not (err_x <= TOL_K9_X * width and bool(torch.all(
                err_f <= TOL_K9_F)) and err_pick <= TOL_K9_F
                and math.isfinite(pick_k)):
            raise AssertionError(f"K9 {label}: x {err_x}, f "
                                 f"{float(err_f.max())} or pick "
                                 f"{err_pick} beyond tolerance")
        worst = max(worst, err_x, float(torch.max(torch.abs(f - fr))))
        if fam == timed:
            ms = time_ms(lambda: fused.lbfgs_logexp_ascent(fam, p, *args),
                         10)
            n_vg = int((1 + iters).sum())
            n_probe = int((nevr - 1 - iters).sum())
            probe = N * (pair_flops(fam) + 2) + N * N
            vg = probe + N * N + N * grad_row_flops(fam)
            log(f"[K9] {label}: kernel {ms:.4f} ms, plain {plain_once:.1f} "
                f"ms; {n_vg} value-and-gradient calls and {n_probe} probes "
                "in the plain run")
            row = {"ms": ms, "plain_ms": plain_once,
                   "nev": nev.tolist(), "nev_plain": nevr.tolist(),
                   "value_grad_calls": n_vg, "probes": n_probe}
            R = x0s.shape[0]
            row.update(bound(n_vg * vg + n_probe * probe,
                             8 * (R * D + 2 * D + N * D + N
                                  + N * (N + 1) // 2 + R * (D + 2))))
    row.update({"max_abs_err": worst,
                "shape": f"R=8 n={N} nmax={NMAX} d={D} maxiter=100"})
    return row


def lml_flops(family, n, p=0, grad=False, d=D):
    """FP64 operations of one row's LML at d dimensions: the pair build (n
    (n + 1) / 2 kernel values), the Cholesky (n^3 / 3) and the substitution
    for z (n^2); with ``grad`` also L^-1 and K^-1 = L^-T L^-1 (n^3 / 3
    each) and the contraction with the p tangents of each pair (p n^2)."""
    ops = n * (n + 1) // 2 * pair_flops(family, d) + n ** 3 / 3 + n * n
    if grad:
        ops += 2 * n ** 3 / 3 + p * n * n
    return ops


def fit_data(dev, n=N, d=D):
    """Path h's data (bench_data, its first ``n`` points; at ``d``
    dimensions the same draw in the unit d-cube) in a GPR: the padded
    transformed X and y (n = N of nmax = NMAX at the table's shape), the
    noise and the fit's box."""
    import numpy as np
    import torch
    from gpry_tpu_torch.models.gp import GaussianProcessRegressor
    from gpry_tpu_torch.models.preprocessing import Normalize_bounds, \
        Normalize_y
    bounds, X, y = bench_data(n=n, d=d)
    gpr = GaussianProcessRegressor(
        bounds=bounds, preprocessing_X=Normalize_bounds(bounds),
        preprocessing_y=Normalize_y(), random_state=0, verbose=0)
    gpr.append_to_data(X, y, fit_gpr=False)
    gpr._refresh_buffers()
    if gpr.n != n or (n == N and gpr._dX.shape != (NMAX, D)):
        raise AssertionError(f"path h's data: {tuple(gpr._dX.shape)}, "
                             f"n {gpr.n}")
    t = lambda a: torch.as_tensor(np.asarray(a, float), dtype=torch.float64,
                                  device=dev)
    return gpr, t


def check_k10(dev, rng, families, timed):
    """K10 at the fit's LML screen: R = 2,048 theta rows drawn in the fit's
    box (variance 1e-4 to 1e6, length scales 1e-3 to 10; a spec's theta0
    +- 1; k10_screen_inputs) at n = N of nmax = NMAX, scalar and vector
    noise, value mode:
    the NaN masks identical except on rows with an eigenvalue of K below
    K10_SINGULAR max diag(K) (counted), the LML within rel TOL_K10 on the
    well-conditioned rows.  Gradient mode on 8 moderate rows and one that
    is not positive definite (a zero first pivot; a NaN theta in spec
    mode): the gradient within TOL_K10_GRAD of max |g|, NaN on that row in both.
    ``timed`` is timed against its plain version and the route it
    replaces (K3, ``cholesky_ex`` and ``solve_triangular``)."""
    import numpy as np
    import torch
    from gpry_tpu_torch.ops import fused
    worst = 0.0
    R = 2048
    noise_vec = torch.as_tensor(rng.uniform(1e-5, 1e-3, NMAX),
                                dtype=torch.float64, device=dev)
    row, counts = {}, {}
    for fam in families:
        label = "spec" if is_spec(fam) else fam
        thetas, X, y, _, _ = k10_screen_inputs(fam, dev, R=R)
        mid = np.asarray(spec_kernel()[1]) if is_spec(fam) else \
            np.log([2.0] + [0.5] * D)
        for noise in (torch.tensor(1e-4, dtype=torch.float64, device=dev),
                      noise_vec):
            kind = "vector" if noise.ndim else "scalar"
            a = fused.lml_value_grad(fam, thetas, X, y, N, noise)
            K = fused.masked_kernel_matrix_plain(fam, thetas, X, N, noise)
            L = fused.cholesky_nan(K)
            b = fused.lml_of_K(K, y, N)
            sync()
            dK = torch.diagonal(K, dim1=-2, dim2=-1)[:, :N]
            piv2 = torch.diagonal(L, dim1=-2, dim2=-1)[:, :N] ** 2
            well = torch.isfinite(b) & (piv2.min(1).values
                                        >= K10_WELL * dK.max(1).values)
            differ = torch.isfinite(a) != torch.isfinite(b)
            singular = 0
            for r in torch.nonzero(differ).flatten().tolist():
                ev = torch.linalg.eigvalsh(K[r, :N, :N])
                if not float(ev.min()) < K10_SINGULAR * float(dK[r].max()):
                    raise AssertionError(
                        f"K10 {label} {kind}: row {r} NaN in one version "
                        f"only, smallest eigenvalue {float(ev.min())} of "
                        f"max diag {float(dK[r].max())}")
                singular += 1
            rel = torch.abs(a - b)[well] / torch.abs(b[well])
            rel_w = float(rel.max()) if bool(well.any()) else 0.0
            fin = torch.isfinite(a) & torch.isfinite(b)
            rel_all = float((torch.abs(a - b)[fin]
                             / torch.abs(b[fin])).max())
            log(f"[K10] {label:8s} R={R} noise {kind}: {int(well.sum())} "
                f"well-conditioned rows, LML rel {rel_w:.3e} there "
                f"({rel_all:.3e} over all {int(fin.sum())} finite rows); "
                f"NaN {int((~torch.isfinite(b)).sum())} plain, "
                f"{int((~torch.isfinite(a)).sum())} kernel, masks differ "
                f"on {singular} near-singular rows")
            counts[f"{label}/{kind}"] = {
                "well": int(well.sum()), "finite": int(fin.sum()),
                "nan_mask_differs": singular}
            if not (rel_w <= TOL_K10 and int(well.sum()) >= 8):
                raise AssertionError(f"K10 {label} {kind}: rel {rel_w} > "
                                     f"{TOL_K10} on well-conditioned rows")
            worst = max(worst, float(torch.abs(a - b)[well].max()))
            del K, L
            # gradient mode: 8 moderate rows and one that is not PD (fast:
            # a variance that underflows to 0 over a zero noise entry, so
            # the first pivot is 0; spec: a NaN theta)
            tg = torch.as_tensor(mid + rng.uniform(-0.3, 0.3, (9, len(mid))),
                                 dtype=torch.float64, device=dev)
            nz = noise.expand(NMAX).clone()
            nz[0] = 0.0
            if is_spec(fam):
                tg[8] = torch.nan
            else:
                tg[8, 0] = -800.0
            ag, gg = fused.lml_value_grad(fam, tg, X, y, N, nz, grad=True)
            bg, gr = fused.lml_value_grad_plain(fam, tg, X, y, N, nz,
                                                grad=True)
            sync()
            if not (bool(torch.isnan(ag[8])) and bool(torch.isnan(bg[8]))
                    and bool(torch.isnan(gg[8]).all())
                    and bool(torch.isfinite(gg[:8]).all())):
                raise AssertionError(f"K10 {label} {kind}: the non-PD row "
                                     "is not NaN in both, or a PD row is")
            rel_v = float((torch.abs(ag[:8] - bg[:8])
                           / torch.abs(bg[:8])).max())
            rel_g = float(torch.abs(gg[:8] - gr[:8]).max()
                          / torch.abs(gr[:8]).max())
            log(f"[K10] {label:8s} gradient mode, noise {kind}: LML rel "
                f"{rel_v:.3e}, gradient rel {rel_g:.3e} of max |g|; the "
                "non-PD row NaN in both")
            if not (rel_v <= TOL_K10 and rel_g <= TOL_K10_GRAD):
                raise AssertionError(f"K10 {label} {kind} gradient mode: "
                                     f"LML rel {rel_v}, gradient {rel_g}")
            worst = max(worst, float(torch.abs(gg[:8] - gr[:8]).max()))
            if fam == timed and noise.ndim == 0:
                ms = time_ms(lambda: fused.lml_value_grad(
                    fam, thetas, X, y, N, noise), 10)
                plain = time_ms(lambda: fused.lml_value_grad_plain(
                    fam, thetas, X, y, N, noise), 3)
                route = time_ms(lambda: fused.lml_of_K(
                    fused.masked_kernel_matrix_batched(
                        fam, thetas, X, N, noise), y, N), 3)
                ms_g = time_ms(lambda: fused.lml_value_grad(
                    fam, tg[:8], X, y, N, noise, grad=True), 10)
                plain_g = time_ms(lambda: fused.lml_value_grad_plain(
                    fam, tg[:8], X, y, N, noise, grad=True), 3)
                log(f"[K10] {label} R={R}: kernel {ms:.4f} ms, plain "
                    f"{plain:.4f} ms, route (K3 + cholesky_ex + "
                    f"solve_triangular) {route:.4f} ms; gradient mode R=8: "
                    f"kernel {ms_g:.4f} ms, plain {plain_g:.4f} ms")
                p = thetas.shape[1]
                row = {"ms": ms, "plain_ms": plain, "route_ms": route,
                       "grad_ms": ms_g, "grad_plain_ms": plain_g,
                       "grad_bound_ms": bound(
                           8 * lml_flops(fam, N, p, grad=True),
                           8 * (8 * p + NMAX * D + 2 * NMAX + 8 * (1 + p)))
                       ["bound_ms"]}
                row.update(bound(R * lml_flops(fam, N),
                                 8 * (R * p + NMAX * D + NMAX + 1 + R)))
        torch.cuda.empty_cache()
    row.update({"max_abs_err": worst, "rows": counts,
                "shape": f"R={R} n={N} nmax={NMAX} d={D}"})
    return row


def lml_spread(fam, theta, X, y, n, noise, perms=K11_PERMS):
    """The rounding spread of the plain LML at ``theta`` (p,): max - min
    over ``perms`` orders of the n valid training rows (the same matrix,
    other summation orders), the first the identity."""
    import numpy as np
    import torch
    from gpry_tpu_torch.ops import fused
    rng = np.random.default_rng(0)
    vals = []
    for k in range(perms):
        order = np.arange(X.shape[0])
        if k:
            order[:n] = rng.permutation(n)
        idx = torch.as_tensor(order, device=X.device)
        nz = noise[idx] if noise.ndim else noise
        vals.append(float(fused.lml_value_grad_plain(
            fam, theta[None], X[idx], y[idx], n, nz)[0]))
    return max(vals) - min(vals)


def k11_starts(fam, gpr, lanes):
    """K11's box and starts on path h's data: the fit's box (a spec's
    theta0 +- 2) and ``lanes`` starts uniform in it (seeded by ``lanes``),
    lane 0 at the incumbent theta (a spec's theta0)."""
    import numpy as np
    if is_spec(fam):
        theta0 = np.asarray(spec_kernel()[1])
        lo, hi, first = theta0 - 2.0, theta0 + 2.0, theta0
    else:
        lo, hi = gpr.theta_bounds[:, 0], gpr.theta_bounds[:, 1]
        first = np.log([2.0] + [0.3] * D)
    th0 = np.random.default_rng(lanes).uniform(lo, hi, (lanes, len(lo)))
    th0[0] = first
    return lo, hi, th0


def check_k11(dev, families, timed):
    """K11 against its plain version lane by lane on path h's data: 8 lanes
    (lane 0 at the incumbent theta, the rest uniform in the fit's box; a
    spec's lanes in theta0 +- 2) and the 2 lanes of a ``simple`` fit: step
    for step over K11_STEPS iterations (the same nev, theta within
    TOL_K11_X of the box width, f within TOL_K11_F (1 + |f|)), then to
    K11_MAXITER: the same winning lane, or the best f within TOL_K11_END
    (1 + |f|) or within the LML's rounding spread at the two winners
    (``lml_spread``), whichever is larger.  ``timed`` on 8
    lanes is timed, and its bound counts the evaluations its plain
    version makes: 1 + iterations value-and-gradient calls per lane, the
    rest of its nev probes.  Then on the first n of path h's draw, for each
    n of EDGE_NS, 8 lanes step for step over K11_STEPS iterations with the
    same tolerances."""
    import numpy as np
    import torch
    from gpry_tpu_torch.ops import fused
    worst = 0.0
    for n in EDGE_NS:
        gpr, t = fit_data(dev, n=n)
        for fam in families:
            lo, hi, th0 = k11_starts(fam, gpr, 8)
            label = f"{'spec' if is_spec(fam) else fam} n={n}"
            args = (fam, gpr._dX, gpr._dy, n, gpr._noise_t(), t(th0), t(lo),
                    t(hi))
            route = fused.lbfgs_lml_fit_plan(
                n, D, len(lo), fused._spec_doubles(fused._kern(fam, D, dev)))
            th, f, nev = fused.lbfgs_lml_fit(*args, maxiter=K11_STEPS)
            thr, fr, nevr = fused.lbfgs_lml_fit_plain(*args,
                                                      maxiter=K11_STEPS)
            sync()
            fin = torch.isfinite(fr)
            err_x = float(torch.max(torch.abs(th - thr)))
            err_f = float(torch.max(torch.abs(f - fr)[fin]
                                    / (1 + torch.abs(fr[fin]))))
            log(f"[K11] {label:16s} (route {route[0]}, X staged {route[1]}):"
                f" over {K11_STEPS} "
                f"iterations nev {nev.tolist()} (plain {nevr.tolist()}), "
                f"theta max abs err {err_x:.3e}, f rel {err_f:.3e}")
            if not (nev.tolist() == nevr.tolist()
                    and torch.equal(torch.isnan(f), torch.isnan(fr))
                    and err_x <= TOL_K11_X * float(np.max(hi - lo))
                    and err_f <= TOL_K11_F):
                raise AssertionError(f"K11 {label}: nev {nev.tolist()} "
                                     f"against {nevr.tolist()}, theta "
                                     f"{err_x}, f {err_f}")
            worst = max(worst, err_x,
                        float(torch.max(torch.abs(f - fr)[fin])))
    gpr, t = fit_data(dev)
    row = {}
    for fam in families:
        for lanes in (8, 2):
            label = f"{'spec' if is_spec(fam) else fam} {lanes} lanes"
            lo, hi, th0 = k11_starts(fam, gpr, lanes)
            args = (fam, gpr._dX, gpr._dy, N, gpr._noise_t(), t(th0), t(lo),
                    t(hi))
            width = float(np.max(hi - lo))
            th, f, nev = fused.lbfgs_lml_fit(*args, maxiter=K11_STEPS)
            thr, fr, nevr = fused.lbfgs_lml_fit_plain(*args,
                                                      maxiter=K11_STEPS)
            sync()
            # a lane whose start is not positive definite returns it with
            # a NaN f, in both
            same_nan = torch.equal(torch.isnan(f), torch.isnan(fr))
            fin = torch.isfinite(fr)
            err_x = float(torch.max(torch.abs(th - thr)))
            err_f = float(torch.max(torch.abs(f - fr)[fin]
                                    / (1 + torch.abs(fr[fin]))))
            log(f"[K11] {label:16s}: over {K11_STEPS} iterations nev "
                f"{nev.tolist()} (plain {nevr.tolist()}), theta max abs err "
                f"{err_x:.3e}, f rel {err_f:.3e} ({int((~fin).sum())} lanes "
                "NaN at the start)")
            if not (nev.tolist() == nevr.tolist() and same_nan
                    and err_x <= TOL_K11_X * width and err_f <= TOL_K11_F):
                raise AssertionError(
                    f"K11 {label}: after {K11_STEPS} iterations nev "
                    f"{nev.tolist()} against {nevr.tolist()}, theta {err_x},"
                    f" f {err_f}")
            worst = max(worst, err_x, float(torch.max(torch.abs(f - fr)[fin])))
            th, f, nev, it = fused.lbfgs_lml_fit(
                *args, maxiter=K11_MAXITER, return_iters=True)
            t0 = time.perf_counter()
            thr, fr, nevr, itr = fused.lbfgs_lml_fit_plain(
                *args, maxiter=K11_MAXITER, return_iters=True)
            sync()
            plain_once = 1e3 * (time.perf_counter() - t0)
            f = torch.where(torch.isnan(f), torch.inf, f)
            fr = torch.where(torch.isnan(fr), torch.inf, fr)
            best, best_r = float(f.min()), float(fr.min())
            win, win_r = int(f.argmin()), int(fr.argmin())
            err_best = abs(best - best_r) / (1 + abs(best_r))
            spread = max(lml_spread(fam, th[win], *args[1:5]),
                         lml_spread(fam, thr[win_r], *args[1:5]))
            tol_end = max(TOL_K11_END, spread / (1 + abs(best_r)))
            ev = torch.linalg.eigvalsh(fused.masked_kernel_matrix_plain(
                fam, thr[win_r], gpr._dX, N, gpr._noise_t())[:N, :N])
            cond = float(ev[-1] / ev[0]) if float(ev[0]) > 0 else math.inf
            log(f"[K11] {label:16s}: to maxiter {K11_MAXITER} best f "
                f"{best:.12g} (plain {best_r:.12g}, rel {err_best:.3e}; the "
                f"LML's rounding spread there {spread:.3e}, "
                f"{spread / (1 + abs(best_r)):.3e} rel, cond(K) at the plain "
                f"winner {cond:.3e}), winner lane {win} "
                f"(plain {win_r}); f {f.tolist()} (plain {fr.tolist()}); nev "
                f"{nev.tolist()} (plain {nevr.tolist()}), iterations "
                f"{it.tolist()} (plain {itr.tolist()})")
            if not (math.isfinite(best)
                    and (win == win_r or err_best <= tol_end)):
                raise AssertionError(f"K11 {label}: best f {best} against "
                                     f"{best_r}, spread {spread}")
            if fam == timed and lanes == 8:
                ms = time_ms(lambda: fused.lbfgs_lml_fit(
                    *args, maxiter=K11_MAXITER), 3)
                n_vg = int((1 + itr).sum())
                n_probe = int((nevr - 1 - itr).sum())
                p = len(lo)
                log(f"[K11] {label}: kernel {ms:.4f} ms, plain "
                    f"{plain_once:.1f} ms; {n_vg} value-and-gradient calls "
                    f"and {n_probe} probes in the plain run")
                row = {"ms": ms, "plain_ms": plain_once,
                       "nev": nev.tolist(), "nev_plain": nevr.tolist(),
                       "value_grad_calls": n_vg, "probes": n_probe}
                row.update(bound(
                    n_vg * lml_flops(fam, N, p, grad=True)
                    + n_probe * lml_flops(fam, N),
                    8 * (2 * lanes * p + 2 * p + NMAX * D + 2 * NMAX
                         + 3 * lanes)))
    row.update({"max_abs_err": worst,
                "shape": f"R=8 n={N} nmax={NMAX} d={D} "
                         f"maxiter={K11_MAXITER}"})
    return row


def k10_screen_inputs(fam, dev, seed=7, R=2048, n=N):
    """K10's inputs at the fit's screen (check_k10's shape): R theta rows
    in the fit's box (a spec's theta0 +- 1), n (N) valid rows of nmax =
    NMAX, scalar noise."""
    import numpy as np
    import torch
    rng = np.random.default_rng(seed)
    X = torch.zeros((NMAX, D), dtype=torch.float64, device=dev)
    X[:n] = torch.as_tensor(rng.uniform(0, 1, (n, D)), device=dev)
    y = torch.zeros(NMAX, dtype=torch.float64, device=dev)
    y[:n] = torch.sin(3 * X[:n]).sum(1)
    if is_spec(fam):
        theta0 = np.asarray(spec_kernel()[1])
        th = theta0 + rng.uniform(-1.0, 1.0, (R, len(theta0)))
    else:
        th = np.column_stack([
            rng.uniform(np.log(1e-4), np.log(1e6), R),
            rng.uniform(np.log(1e-3), np.log(10.0), (R, D))])
    return (torch.as_tensor(th, dtype=torch.float64, device=dev), X, y, n,
            torch.tensor(1e-4, dtype=torch.float64, device=dev))


def time_fit_kernels(dev):
    """K9, K10, K11 and K6 at the kernel table's shapes, the fast family
    (RBF) and ALL_NODES: K9 and K11 at check_k9's and check_k11's timed
    inputs (8 lanes, d = D, n = N, maxiter 100 and K11_MAXITER), K10 at the
    screen (k10_screen_inputs, value mode) beside the route it replaced
    (K3, cholesky_ex, solve_triangular), ms per call (CUDA events; 10, 10,
    3 and 3 calls); K6 at B = 66, R = K6_R with the SVM fitted, device ms
    (torch.profiler, 10 calls).  It calls only the wrappers, with their
    arguments of every version since K6, so that compare_trees.sh can run
    it on an older checkout's gpry_tpu_torch."""
    from gpry_tpu_torch.ops import fused
    out = {}
    gpr, t = fit_data(dev)
    for fam, sfx in (("rbf", ""), (spec_kernel()[0], "/spec")):
        p, args = k9_inputs(fam, dev, seed=19)
        out["lbfgs_logexp_ascent" + sfx] = time_ms(
            lambda: fused.lbfgs_logexp_ascent(fam, p, *args), 10)
        thetas, X, y, n, noise = k10_screen_inputs(fam, dev)
        out["lml_value_grad" + sfx] = time_ms(
            lambda: fused.lml_value_grad(fam, thetas, X, y, n, noise), 10)
        out["lml_route" + sfx] = time_ms(lambda: fused.lml_of_K(
            fused.masked_kernel_matrix_batched(fam, thetas, X, n, noise), y,
            n), 3)
        lo, hi, th0 = k11_starts(fam, gpr, 8)
        fargs = (fam, gpr._dX, gpr._dy, N, gpr._noise_t(), t(th0), t(lo),
                 t(hi))
        out["lbfgs_lml_fit" + sfx] = time_ms(
            lambda: fused.lbfgs_lml_fit(*fargs, maxiter=K11_MAXITER), 3)
        p6, args6 = k6_inputs(fam, dev, 66, seed=66)
        out["ns_slice_chains" + sfx] = kernel_device_ms(
            lambda: fused.ns_slice_chains(fam, p6, *args6),
            "ns_slice_chains", 10)
    return out


def time_k2_k13(dev):
    """K2 and K13 at the kernel table's shapes: K2 at nq = K2_NQ (n = N of
    NMAX, d = D, the SVM fitted; RBF and ALL_NODES; LogExp mode), ms per
    call (CUDA events, 200 calls at the small batches, 50 at the screen)
    and at the small batches its device ms (torch.profiler, 50 calls);
    K13's device ms (50 calls) at K13_TIMED halfway through the dead
    buffer, each call applying a kill and selecting the next: the steady
    state (the live order known, where the state keeps one) and a run's
    first step (the order unknown).  It calls only the wrappers, with their
    arguments of every version since K13, so that compare_trees.sh can run
    it on an older checkout's gpry_tpu_torch (whose K13 sorts in full at
    every step)."""
    import numpy as np
    import torch
    from gpry_tpu_torch.ops import fused
    from test_torch_cuda import ns_state
    out = {}
    rng = np.random.default_rng(12)
    lexp = (D ** -0.85, 0.01)
    for fam, sfx in (("rbf", ""), (spec_kernel()[0], "/spec")):
        p = synthetic_surrogate(fam, dev, seed=12)
        for nq in K2_NQ:
            Xq = torch.as_tensor(rng.uniform(-5, 5, (nq, D)),
                                 dtype=torch.float64, device=dev)
            call = lambda: fused.gated_meanvar_logexp(fam, p, Xq,
                                                      logexp=lexp)
            key = f"gated_meanvar_logexp{sfx} nq={nq}"
            out[key] = time_ms(call, 50 if nq > 16 else 200)
            if nq < 16:
                out[key + " device"] = kernel_device_ms(call,
                                                        "gated_meanvar", 50)
    for nlive, d in K13_TIMED:
        st, starts, chains, consts = ns_state(dev, nlive, d, "mid")
        fused.ns_step(st, *chains, starts, *consts)
        c0 = st.count.clone()
        modes = ("steady", "first") if "order" in fused.NSState._fields \
            else ("steady",)
        for mode in modes:
            def call():
                st.count.copy_(c0)
                if mode == "first":
                    st.order.fill_(-1)
                fused.ns_step(st, *chains, starts, *consts)

            out[f"ns_step nlive={nlive} d={d} {mode}"] = kernel_device_ms(
                call, "ns_step_kernel", 50)
    return out


def time_k4_k12(dev):
    """K4 and K12 at the kernel table's shapes, RBF and ALL_NODES: K4's
    whole fill at check_k4's LogExp inputs (N_CAND candidates, a pool of
    SIZE, scalar noise), ms per fill (CUDA events, 20 fills) and the device
    ms of one sweep and one select apart (torch.profiler, 10 fills: 2 SIZE
    - 1 launches each); K12 at path d's ensemble (check_k12's inputs: d =
    D, 16 chains, the SVM all finite, n = N), a whole K12_WARMUP +
    K12_SAMPLING-step run's ms (CUDA events, 3 runs) and each phase's
    device ms (torch.profiler, 3 launches).  It calls only the wrappers,
    with their arguments of every version since K12, so that
    compare_trees.sh can run it on an older checkout's gpry_tpu_torch."""
    import numpy as np
    import torch
    from gpry_tpu_torch.acquisition.functions import LogExp
    from gpry_tpu_torch.mc.mcmc import sampling_factor
    from gpry_tpu_torch.ops import fused
    out = {}
    acqf, noise_std = LogExp(dimension=D), 0.01
    for fam, sfx in (("rbf", ""), (spec_kernel()[0], "/spec")):
        rng = np.random.default_rng(4)
        args = k4_inputs(fam, dev, "scalar", rng, acqf, noise_std)
        fill = lambda: fused.kriging_believer_fill(
            fam, *args, logexp=(acqf.zeta, noise_std))
        key = "kriging_believer_fill" + sfx
        out[key] = time_ms(fill, 20)
        out[key + " sweep device"] = kernel_device_ms(fill, "kb_sweep", 10)
        out[key + " select device"] = kernel_device_ms(fill, "kb_select",
                                                       10)
        fam12 = fam if not sfx else spec_kernel(D)[0]
        p, x0, lp0, draws, lo, hi = k12_inputs(fam12, dev, "all_finite", D,
                                               16, N, NMAX, "timing")
        zw, uw, zs, us, chol0 = draws
        step0 = torch.zeros((), dtype=torch.float64, device=dev)
        w = fused.mcmc_chains(fam12, p, x0, lp0, step0, chol0, zw, uw, lo,
                              hi, True)
        chol_w = sampling_factor(w[3], w[4], zw.shape[0] * 16, chol0)
        warm = lambda: fused.mcmc_chains(fam12, p, x0, lp0, step0, chol0, zw,
                                         uw, lo, hi, True)
        samp = lambda: fused.mcmc_chains(fam12, p, *w[:3], chol_w, zs, us,
                                         lo, hi, False)
        key = "mcmc_chains" + sfx
        out[key] = time_ms(lambda: (warm(), samp()), 3)
        out[key + " warm-up device"] = kernel_device_ms(warm, "mcmc_chains",
                                                        3)
        out[key + " sampling device"] = kernel_device_ms(samp,
                                                         "mcmc_chains", 3)
    return out


def time_k5_k8(dev):
    """K5 and K8 at the kernel table's shapes (n = N of NMAX, d = D; RBF
    and ALL_NODES; queries over [-5, 5]^D): K5 at nq = 1, 256 and
    NQ_SCREEN, K8 at nq = 8 and NQ_COV, ms per call (CUDA events, 200
    calls at the small batches, 50 above) and device ms (torch.profiler,
    50 calls).  It calls only the wrappers, with their arguments of every
    version since K8, so that compare_trees.sh can run it on an older
    checkout's gpry_tpu_torch."""
    import numpy as np
    import torch
    from gpry_tpu_torch.ops import fused
    out = {}
    rng = np.random.default_rng(15)
    for fam, sfx in (("rbf", ""), (spec_kernel()[0], "/spec")):
        p = synthetic_surrogate(fam, dev, seed=14)
        for name, fn, nqs in (
                ("meanvar_ungated", fused.meanvar_ungated,
                 (1, 256, NQ_SCREEN)),
                ("meanstd_grad", fused.meanstd_grad, (8, NQ_COV))):
            for nq in nqs:
                Xq = torch.as_tensor(rng.uniform(-5, 5, (nq, D)),
                                     dtype=torch.float64, device=dev)
                call = lambda: fn(fam, p, Xq)
                key = f"{name}{sfx} nq={nq}"
                out[key] = time_ms(call, 50 if nq > 256 else 200)
                out[key + " device"] = kernel_device_ms(call, name, 50)
    return out


def time_k7(dev):
    """K7 at nq = 1, 64 and NQ_COV (check_k7's surrogates and queries, RBF
    and ALL_NODES): ms per call (CUDA events, 200 calls, 50 at NQ_COV) and
    the device ms of its solve and of its product (torch.profiler, 50
    calls; the kernels' names of every version since K7 contain
    "meancov_solve" and "meancov_cov").  It calls only the wrapper, with
    its arguments of every version since K7, so that compare_trees.sh can
    run it on an older checkout's gpry_tpu_torch."""
    import numpy as np
    import torch
    from gpry_tpu_torch.ops import fused
    out = {}
    rng = np.random.default_rng(16)
    for fam, sfx in (("rbf", ""), (spec_kernel()[0], "/spec")):
        p = synthetic_surrogate(fam, dev, seed=16)
        for nq in (1, 64, NQ_COV):
            Xq = torch.as_tensor(rng.uniform(0, 1, (nq, D)),
                                 dtype=torch.float64, device=dev)
            Xq[:min(nq, 32)] = p.X[:min(nq, 32)]
            call = lambda: fused.predict_meancov(fam, p.theta, p.X, p.n,
                                                 p.noise_var, p.L, p.alpha,
                                                 Xq)
            key = f"predict_meancov{sfx} nq={nq}"
            out[key] = time_ms(call, 50 if nq == NQ_COV else 200)
            solve = kernel_device_ms(call, "meancov_solve", 50)
            prod = kernel_device_ms(call, "meancov_cov", 50)
            out[key + " solve device"] = solve
            out[key + " product device"] = prod
            out[key + " device"] = None if None in (solve, prod) else \
                solve + prod
    return out


def _digest(*tensors):
    """A short hash of the tensors' bytes: equal in two trees exactly when
    every value agrees bit for bit."""
    import hashlib
    h = hashlib.sha256()
    for t in tensors:
        h.update(t.detach().cpu().contiguous().numpy().tobytes())
    return h.hexdigest()[:16]


def time_k1_k3(dev):
    """K1 and K3 at the kernel table's shapes, RBF and ALL_NODES: K1 at nq
    = 66, 2,000 and 65,536 (the SVM fitted, queries over [-5, 5]^D), ms
    per call (CUDA events, 200 calls, 20 at 65,536) and device ms
    (torch.profiler, 20 calls); K3 at R = 1 and 2,048 (n = N of NMAX),
    ms and device ms; linalg.chol_append of 1 and 8 points onto N - k
    rows, ms per append (CUDA events, 200) and K3's device ms in it (its
    panel where the tree builds one, else its whole matrix); and digests
    of K3's outputs (R = 1, the first 64 matrices at R = 2,048) and of the
    appended factor and alpha, equal in two trees that agree bit for
    bit.  It calls only the wrappers, with their
    arguments of every version since K3, so that compare_trees.sh can run
    it on an older checkout's gpry_tpu_torch."""
    import numpy as np
    import torch
    from gpry_tpu_torch.ops import fused, linalg
    out = {}
    rng = np.random.default_rng(13)
    t = lambda a: torch.as_tensor(np.asarray(a, float), dtype=torch.float64,
                                  device=dev)
    X = np.zeros((NMAX, D))
    X[:N] = rng.uniform(0, 1, (N, D))
    y = np.zeros(NMAX)
    y[:N] = np.sin(3 * X[:N]).sum(1)
    noise = t(1e-4)
    for fam, sfx in (("rbf", ""), (spec_kernel()[0], "/spec")):
        p = synthetic_surrogate(fam, dev, seed=11)
        for nq in (66, 2000, 65536):
            Xq = t(rng.uniform(-5, 5, (nq, D)))
            call = lambda: fused.gated_mean(fam, p, Xq)
            key = f"gated_mean{sfx} nq={nq}"
            out[key] = time_ms(call, 20 if nq == 65536 else 200)
            out[key + " device"] = kernel_device_ms(call, "gated_mean", 20)
        theta = np.asarray(spec_kernel()[1]) if sfx else \
            np.log([1.0] + [0.5] * D)
        thetas = t(theta + rng.uniform(-0.3, 0.3, (2048, len(theta))))
        digests, Xd = [], t(X)
        for R in (1, 2048):
            th = thetas[:R]
            call = lambda: fused.masked_kernel_matrix_batched(
                fam, th, Xd, N, noise)
            key = f"masked_kernel_matrix{sfx} R={R}"
            out[key] = time_ms(call, 200 if R == 1 else 10)
            out[key + " device"] = kernel_device_ms(call, "masked_kernel",
                                                    20)
            digests.append(call()[:64].clone())
        for k in (1, 8):
            Xs, ys = t(X), t(y)
            Xs[N - k:], ys[N - k:] = 0.0, 0.0
            L0, _ = linalg.factorize(fam, thetas[0], Xs, ys, N - k, noise)
            args = (fam, thetas[0], Xs, ys, N - k, noise, L0,
                    t(X[N - k:N]), t(y[N - k:N]))
            call = lambda: linalg.chol_append(*args)
            key = f"chol_append{sfx} k={k}"
            out[key] = time_ms(call, 200)
            out[key + " K3 device"] = kernel_device_ms(call, "masked_kernel",
                                                       20)
            digests += list(call()[3:])
        out[f"digest{sfx}"] = _digest(*digests)
    return out


def k14_inputs(family, dev, P, nq, seed=31):
    """K14's arguments at path m's TP predict: the RBF surrogate of
    MESH_TP_N valid rows of MESH_TP_NMAX (d = D) split over P shards, its
    K^-1 (parallel.mesh._kinv_for) and nq queries in the prior box; for a
    spec tree its theta (the training rows and M are the RBF's: K14's
    checks need no factorization of the spec).  Returns (p, theta, Xq_
    (nq, D), M)."""
    import numpy as np
    import torch
    from gpry_tpu_torch.parallel import mesh as mesh_mod
    p = synthetic_surrogate("rbf", dev, seed, svm="all_finite",
                            n=MESH_TP_N, nmax=MESH_TP_NMAX)
    rng = np.random.default_rng(seed)
    Xq = torch.as_tensor(rng.uniform(-5, 5, (nq, D)), dtype=torch.float64,
                         device=dev)
    Xq_ = ((Xq - p.x_loc) / p.x_scale).contiguous()
    theta = p.theta if not is_spec(family) else torch.as_tensor(
        np.asarray(spec_kernel()[1], float), dtype=torch.float64,
        device=dev)
    return p, theta, Xq_, mesh_mod._kinv_for(p)


def k14_bounds(family, nloc, nmax, nq):
    """K14's bounds for one shard: (a) the nloc x nq pair evaluations and
    their multiply-adds with alpha, over X_shard, alpha, Xq read and
    K_shard, the mean written; (b) 2 nloc nmax nq operations over M_shard,
    k_full and K_shard read and the nq sums written."""
    a = bound(nloc * nq * (pair_flops(family) + 2),
              8 * (nloc * D + nloc + nq * D + nloc * nq + nq))
    b = bound(2 * nloc * nmax * nq,
              8 * (nloc * nmax + nmax * nq + nloc * nq + nq))
    return a, b


def check_k14(dev, families, timed):
    """K14 against its plain versions at path m's TP shapes (MESH_TP_N of
    MESH_TP_NMAX split over MESH_LOGICAL shards of nloc rows, MESH_TP_NQ
    queries; also nq 1 and 255): every shard's K_shard, partial mean and
    partial quadratic form within TOL_K14 of their scale (rel_k14), the
    fast families and the spec.  Timed (CUDA events) at the row's shape,
    the last shard (its padding rows) for ``timed``; tp_quad beside
    ``torch.einsum("ij,jq,iq->q", ...)``, the one library call of the
    same function.  Returns (rows of tp_cross_mean for ``timed``'s mode,
    row of tp_quad or None in spec mode)."""
    import torch
    from gpry_tpu_torch.ops import fused
    P = MESH_LOGICAL
    nloc = MESH_TP_NMAX // P
    errs = {"K": 0.0, "mean": 0.0, "quad": 0.0}
    for fam in families:
        for nq in (1, MESH_TP_NQ, 255):
            p, theta, Xq_, M = k14_inputs(fam, dev, P, nq)
            Ks = []
            for i in range(P):
                r0 = i * nloc
                args = (fam, theta, p.X[r0:r0 + nloc],
                        p.alpha[r0:r0 + nloc], Xq_, r0, p.n)
                K, mean = fused.tp_cross_mean(*args)
                Kr, meanr = fused.tp_cross_mean_plain(*args)
                errs["K"] = max(errs["K"], rel_k14(K, Kr, Kr.abs()))
                errs["mean"] = max(errs["mean"], rel_k14(
                    mean, meanr, (Kr.abs() * args[3].abs()[:, None]).sum(0)))
                Ks.append(Kr)
            k_full = torch.cat(Ks)
            for i in range(P):
                Mi = M[i * nloc:(i + 1) * nloc]
                quad = fused.tp_quad(Mi, k_full, Ks[i])
                quadr = fused.tp_quad_plain(Mi, k_full, Ks[i])
                scale = (Ks[i].abs() * (Mi.abs() @ k_full.abs())).sum(0)
                errs["quad"] = max(errs["quad"], rel_k14(quad, quadr, scale))
    log(f"[K14] {'spec' if is_spec(timed) else 'fast'}: max error over "
        f"scale " + json.dumps(errs))
    if max(errs.values()) > TOL_K14:
        raise AssertionError(f"K14 disagrees with its plain versions: "
                             f"{errs} > {TOL_K14}")
    p, theta, Xq_, M = k14_inputs(timed, dev, P, MESH_TP_NQ)
    r0 = (P - 1) * nloc
    args = (timed, theta, p.X[r0:], p.alpha[r0:], Xq_, r0, p.n)
    ba, bb = k14_bounds(timed, nloc, MESH_TP_NMAX, MESH_TP_NQ)
    row_a = {"max_abs_err": errs["mean"], "nloc": nloc,
             "nmax": MESH_TP_NMAX, "nq": MESH_TP_NQ,
             "ms": time_ms(lambda: fused.tp_cross_mean(*args), 200),
             "device_ms": kernel_device_ms(
                 lambda: fused.tp_cross_mean(*args), "tp_cross_mean", 50),
             "plain_ms": time_ms(lambda: fused.tp_cross_mean_plain(*args),
                                 50), **ba}
    log(f"[K14] tp_cross_mean{' spec' if is_spec(timed) else ''}: "
        + json.dumps(row_a))
    if is_spec(timed):
        return row_a, None
    K = fused.tp_cross_mean_plain(*args)[0]
    k_full = torch.cat([fused.tp_cross_mean_plain(
        timed, theta, p.X[i * nloc:(i + 1) * nloc],
        p.alpha[i * nloc:(i + 1) * nloc], Xq_, i * nloc, p.n)[0]
        for i in range(P)])
    Mi = M[r0:]
    row_b = {"max_abs_err": errs["quad"], "nloc": nloc,
             "nmax": MESH_TP_NMAX, "nq": MESH_TP_NQ,
             "ms": time_ms(lambda: fused.tp_quad(Mi, k_full, K), 200),
             "device_ms": kernel_device_ms(
                 lambda: fused.tp_quad(Mi, k_full, K), "tp_quad", 50),
             "plain_ms": time_ms(lambda: fused.tp_quad_plain(Mi, k_full, K),
                                 200),
             "library_ms": time_ms(lambda: torch.einsum(
                 "ij,jq,iq->q", Mi, k_full, K), 200), **bb}
    log("[K14] tp_quad: " + json.dumps(row_b))
    return row_a, row_b


def rel_k14(a, b, scale):
    """max |a - b| over max(scale) (K14's checks)."""
    import torch
    if not (torch.isfinite(a).all() and torch.isfinite(b).all()):
        raise AssertionError("K14: a non-finite output")
    return float(torch.max(torch.abs(a - b))) / max(
        float(torch.max(scale)), 1e-300)


# K8 and K9 at their d <= 64 instance (two coordinates a lane of K9's warp
# 0, the gradient sums in two passes of 32): at its first d, path (n)'s and
# its last, on the synthetic surrogate at n = N of NMAX there (a fast
# family's length scales times sqrt(d / D)); K8 at WIDE_NQ queries; both
# timed at WIDE_TIMED
WIDE_DS, WIDE_NQ, WIDE_TIMED = (33, 40, 64), (1, 8, 64), 40
# the main path's width at d = 48: the default budget 70 d^1.5 (23,278
# training points), where K9 and K8 take their global routes; the other
# kernels of that path once each there, K2, K5, K7 at BIG_NQ queries, K3's
# one-row panel; the fit's K10 (2 theta rows) and K11 (1 lane, maxiter 1)
# at d = 48 on their global route at BIG_FIT_N rows: at BIG_N one row's
# evaluation on one SM takes minutes (on an H100 80GB HBM3 at 700 W: K10
# at 2 rows 206 s, K11's first value and gradient 507 s), beyond this
# script's time limit (profile_lbfgs_routes.py --budget runs both at BIG_N)
BIG_D = 48
BIG_N = int(70 * BIG_D ** 1.5)
BIG_NQ = 8
BIG_FIT_N = 2048
# rows of a K3 plain panel where the whole (n, n, d) difference tensor of
# the plain LML exceeds the card (lml_panels)
PANEL_ROWS = 256


def wide_k8(dev, fam, d, rng):
    """K8 at d on the synthetic surrogate at WIDE_NQ queries (the first 4
    on training points) against its plain version: mean and std within rel
    TOL_K8, both gradients within TOL_K8_GRAD of their max |.|; returns
    (row, the surrogate, the last queries)."""
    import torch
    from gpry_tpu_torch.ops import fused
    label = f"{'spec' if is_spec(fam) else 'rbf'} d={d}"
    sd = fused._spec_doubles(fused._kern(fam, d, dev))
    p = synthetic_surrogate(fam, dev, seed=17, d=d,
                            ls_scale=math.sqrt(d / D))
    worst, routes = 0.0, {}
    for nq in WIDE_NQ:
        Xq = torch.as_tensor(rng.uniform(-5, 5, (nq, d)),
                             dtype=torch.float64, device=dev)
        Xq[:min(nq, 4)] = p.X[:min(nq, 4)] * p.x_scale + p.x_loc
        got = fused.meanstd_grad(fam, p, Xq)
        ref = fused.meanstd_grad_plain(fam, p, Xq)
        sync()
        errs = []
        for what, a, b, tol in zip(("mean", "std", "dmean", "dstd"), got,
                                   ref, (TOL_K8, TOL_K8, TOL_K8_GRAD,
                                         TOL_K8_GRAD)):
            err, rel = rel_err(a.reshape(-1), b.reshape(-1))
            errs.append(f"{what} rel {rel:.3e}")
            if not rel <= tol:
                raise AssertionError(f"K8 {label} nq={nq} {what}: rel {rel} "
                                     f"> {tol}")
            worst = max(worst, err)
        routes[f"nq={nq}"] = fused.meanstd_grad_plan(N, NMAX, d, nq, sd)[:2]
        log(f"[WIDE] K8 {label} nq={nq} route {routes[f'nq={nq}']}: "
            + "; ".join(errs))
    return {"max_abs_err": worst, "routes": routes}, p, Xq


def k9_objective(fam, p, x, zeta, noise):
    """K9's objective, the negated LogExp of the smooth surrogate, at the
    raw points x by the plain torch functions (meanvar_ungated_plain): the
    value that K9 reports for an endpoint x."""
    import torch
    from gpry_tpu_torch.ops import fused
    mu, sd = fused.meanvar_ungated_plain(fam, p, x)
    var = sd * sd - noise * noise
    return -(2.0 * zeta * (torch.minimum(mu, p.clip_max) - p.y_max)
             + 0.5 * torch.log(torch.clamp_min(var, 1e-300)))


def surrogate_on(p, dev):
    """The surrogate snapshot p with its tensors on dev."""
    import dataclasses
    import torch
    from gpry_tpu_torch.models.gp import SurrogateParams
    mv = lambda v: v.to(dev) if torch.is_tensor(v) else v
    fields = lambda o: {f.name: mv(getattr(o, f.name))
                        for f in dataclasses.fields(o) if f.init}
    kw = fields(p)
    kw["svm"] = type(p.svm)(**fields(p.svm))
    return SurrogateParams(**kw)


def k9_ends(fam, p, args):
    """K9 to the end (maxiter 100) and two runs of its plain version, on
    the card and on the CPU (the same arithmetic summed in another order:
    the rounding witness), on the same inputs.  A lane is stable where the
    two plain runs end within TOL_K9_X of the box width in x and TOL_K9_F
    (1 + |f|) in f: there the kernel's lane is held to the card's plain
    run at those tolerances.  Returns (the kernel's (x, f, nev), the card's
    plain (x, f, nev, iterations), the CPU's plain (x, f), the stable
    lanes, a bool tensor), the outputs on the CPU."""
    import torch
    from gpry_tpu_torch.ops import fused
    cpu = lambda *ts: [t.cpu() for t in ts]
    xs, f, nev = fused.lbfgs_logexp_ascent(fam, p, *args)
    xr, fr, nevr, iters = fused.lbfgs_logexp_ascent_plain(
        fam, p, *args, return_iters=True)
    sync()
    with torch.device("cpu"):
        xc, fc, _ = fused.lbfgs_logexp_ascent_plain(
            fam, surrogate_on(p, "cpu"), args[0], args[1], *cpu(*args[2:]))
    width = float(torch.max(args[4] - args[3]))
    xr_, fr_ = cpu(xr, fr)
    stable = ((xr_ - xc).abs().amax(1) <= TOL_K9_X * width) & (
        (fr_ - fc).abs() <= TOL_K9_F * (1 + fc.abs()))
    return cpu(xs, f, nev), (xr_, fr_, nevr, iters), (xc, fc), stable


def wide_k9(dev, fam, d):
    """K9 at d (k9_inputs: 8 lanes, lane 0 on a training point) against its
    plain version: step for step over K9_STEPS iterations (the same nev, x
    within TOL_K9_X of the box width, f within TOL_K9_F (1 + |f|)); then
    to the end (maxiter 100, k9_ends): on the lanes where the plain
    version on the card and on the CPU end together (stable), each lane's
    x and f against the card's plain run at those tolerances, and, where
    the two plain runs' picks (K2's gated rescore of the endpoints) agree
    within TOL_K9_F (1 + |v|), the kernel's pick too; on every lane its f
    within TOL_K9_F (1 + |f|) of the objective that the plain functions
    give at its x (k9_objective) and no worse than its start's.  On the
    other lanes the plain version's own summation order moves the end
    (over ~200 evaluations at d >= 33 with RBF most lanes follow their
    sums' rounding into other basins, on an H100 as on the CPU), so there
    the kernel is compared by those two tests only; the distances are
    printed.  Returns (row, the plain run's iterations, its nev, the
    inputs)."""
    import torch
    from gpry_tpu_torch.ops import fused
    label = f"{'spec' if is_spec(fam) else 'rbf'} d={d}"
    p, args = k9_inputs(fam, dev, seed=19, d=d)
    zeta, noise, x0s, lo, hi = args
    width = float(torch.max(hi - lo))
    plan = fused.lbfgs_logexp_ascent_plan(
        N, d, fused._spec_doubles(fused._kern(fam, d, dev)))
    xs, f, nev = fused.lbfgs_logexp_ascent(fam, p, *args, maxiter=K9_STEPS)
    xr, fr, nevr = fused.lbfgs_logexp_ascent_plain(fam, p, *args,
                                                   maxiter=K9_STEPS)
    sync()
    err_x = float(torch.max(torch.abs(xs - xr)))
    err_f = float(torch.max(torch.abs(f - fr) / (1 + torch.abs(fr))))
    log(f"[WIDE] K9 {label} (route {plan[0]}): over {K9_STEPS} iterations "
        f"nev {nev.tolist()} (plain {nevr.tolist()}), x max abs err "
        f"{err_x:.3e}, f rel {err_f:.3e}")
    if not (nev.tolist() == nevr.tolist() and err_x <= TOL_K9_X * width
            and err_f <= TOL_K9_F):
        raise AssertionError(f"K9 {label}: nev {nev.tolist()} against "
                             f"{nevr.tolist()}, x {err_x}, f {err_f}")
    worst = max(err_x, float(torch.max(torch.abs(f - fr))))
    (xs, f, nev), (xr, fr, nevr, iters), (xc, fc), stable = k9_ends(
        fam, p, args)
    f_at = k9_objective(fam, p, xs.to(dev), zeta, noise).cpu()
    f_start = k9_objective(fam, p, x0s, zeta, noise).cpu()
    err_end = float(torch.max(torch.abs(f - f_at) / (1 + torch.abs(f_at))))
    climbed = bool(torch.all(f <= f_start + TOL_K9_F * (1 + f_start.abs())))
    dx_kr, dx_rc = (xs - xr).abs().amax(1), (xr - xc).abs().amax(1)
    held = (dx_kr <= TOL_K9_X * width) & (
        (f - fr).abs() <= TOL_K9_F * (1 + fr.abs()))
    pick = lambda x: float(fused.gated_meanvar_logexp(
        fam, p, x.to(dev), logexp=(zeta, noise)).max())
    pick_k, pick_r, pick_c = pick(xs), pick(xr), pick(xc)
    pick_stable = abs(pick_r - pick_c) <= TOL_K9_F * (1 + abs(pick_c))
    log(f"[WIDE] K9 {label} to the end: stable lanes "
        f"{int(stable.sum())} of {stable.numel()}, the kernel's held on "
        f"{int((held & stable).sum())} of them (and on "
        f"{int((held & ~stable).sum())} others); x max abs distance to the "
        f"card's plain run by lane {[float(f'{v:.3g}') for v in dx_kr]}, "
        f"the CPU's plain run to it {[float(f'{v:.3g}') for v in dx_rc]}; "
        f"pick {pick_k:.12g} (plain {pick_r:.12g}, CPU {pick_c:.12g}, "
        f"gated {pick_stable}); each lane's f against the objective at its "
        f"x rel {err_end:.3e}, no worse than its start {climbed}; nev "
        f"{nev.tolist()} (plain {nevr.tolist()})")
    if not bool(torch.all(held | ~stable)):
        raise AssertionError(f"K9 {label}: lanes "
                             f"{torch.nonzero(stable & ~held).flatten().tolist()}"
                             f" end away from a stable plain run")
    if pick_stable and not abs(pick_k - pick_r) <= TOL_K9_F * (
            1 + abs(pick_r)):
        raise AssertionError(f"K9 {label}: pick {pick_k} against {pick_r}")
    if not (err_end <= TOL_K9_F and climbed and math.isfinite(pick_k)):
        raise AssertionError(f"K9 {label}: an endpoint's f is {err_end} from "
                             f"the objective at its x, or below its start "
                             f"({not climbed})")
    worst = max(worst, float(torch.max(torch.abs(f - f_at))))
    return {"max_abs_err": worst, "route": plan[0],
            "stable_lanes": int(stable.sum())}, iters, nevr, (p, args)


def k9_bound(fam, d, n, R, iters, nevr):
    """K9's bound from its plain run's evaluations: 1 + iterations
    value-and-gradient calls a lane, the rest of its nev probes (each a k
    vector and a forward substitution; a gradient adds the back
    substitution and each row's gradient); bytes: the starts, the box,
    the training rows, alpha, the valid triangle of L, the outputs."""
    n_vg = int((1 + iters).sum())
    n_probe = int((nevr - 1 - iters).sum())
    probe = n * (pair_flops(fam, d) + 2) + n * n
    vg = probe + n * n + n * grad_row_flops(fam, d)
    return {"value_grad_calls": n_vg, "probes": n_probe,
            **bound(n_vg * vg + n_probe * probe,
                    8 * (R * d + 2 * d + n * d + n + n * (n + 1) // 2
                         + R * (d + 2)))}


def check_wide(dev):
    """K8 and K9 at each d of WIDE_DS, RBF and all_nodes(d) (wide_k8,
    wide_k9: check_k8's and check_k9's tolerances); at d = WIDE_TIMED each
    timed (CUDA events; the plain version once for K9, 5 calls for K8)
    beside its bound.  Returns {kernel row: {"d=..": row}}."""
    import numpy as np
    from gpry_tpu_torch.ops import fused
    rng = np.random.default_rng(33)
    out = {}
    for d in WIDE_DS:
        for fam in ("rbf", spec_kernel(d)[0]):
            sfx = "/spec" if is_spec(fam) else ""
            row8, p, Xq = wide_k8(dev, fam, d, rng)
            row9, iters, nevr, (p9, args) = wide_k9(dev, fam, d)
            if d == WIDE_TIMED:
                nq = Xq.shape[0]
                row8.update(
                    nq=nq, ms=time_ms(lambda: fused.meanstd_grad(fam, p, Xq),
                                      50),
                    plain_ms=time_ms(lambda: fused.meanstd_grad_plain(
                        fam, p, Xq), 5), **k8_bound(fam, nq, d))
                t0 = time.perf_counter()
                fused.lbfgs_logexp_ascent_plain(fam, p9, *args)
                sync()
                row9.update(
                    ms=time_ms(lambda: fused.lbfgs_logexp_ascent(
                        fam, p9, *args), 10),
                    plain_ms=1e3 * (time.perf_counter() - t0),
                    **k9_bound(fam, d, N, args[2].shape[0], iters, nevr))
                log(f"[WIDE] d={d} {'spec' if sfx else 'rbf'}: K8 "
                    + json.dumps(row8) + "; K9 " + json.dumps(row9))
            out.setdefault("meanstd_grad" + sfx, {})[f"d={d}"] = row8
            out.setdefault("lbfgs_logexp_ascent" + sfx, {})[f"d={d}"] = row9
    return out


def big_surrogate(dev):
    """The smooth surrogate at d = BIG_D and the default budget there (n =
    nmax = BIG_N): the training points uniform in the unit box, y a
    Gaussian of width 0.3 standardized, RBF with the synthetic
    surrogate's length scales times sqrt(BIG_D / D), the noise 1e-4,
    factorized by the port (K3 and torch's Cholesky); a classifier that
    has seen no -inf, no trust box, no clip.  Returns (surrogate, theta,
    X, y, noise)."""
    import numpy as np
    import torch
    from gpry_tpu_torch.models.classifier import MODE_ALL_FINITE, \
        trivial_svm_params
    from gpry_tpu_torch.models.gp import SurrogateParams
    from gpry_tpu_torch.ops.linalg import factorize
    rng = np.random.default_rng(23)
    t = lambda a: torch.as_tensor(np.asarray(a, float), dtype=torch.float64,
                                  device=dev)
    Xv = rng.uniform(0, 1, (BIG_N, BIG_D))
    yv = -0.5 * np.sum(((Xv - 0.5) / 0.3) ** 2, axis=1)
    yv = (yv - yv.mean()) / yv.std()
    theta = t(np.concatenate([[np.log(2.0)], np.log(rng.uniform(
        0.4, 0.9, BIG_D) * math.sqrt(BIG_D / D))]))
    X, y, noise = t(Xv), t(yv), t(1e-4)
    L, alpha = factorize("rbf", theta, X, y, BIG_N, noise)
    if bool(torch.isnan(L).any()):
        raise AssertionError("the d = 48 factorization is not PD")
    inf = torch.full((BIG_D,), torch.inf, dtype=torch.float64, device=dev)
    p = SurrogateParams(
        theta=theta, X=X, y=y, n=BIG_N, noise_var=noise, L=L, alpha=alpha,
        x_loc=t(np.full(BIG_D, -5.0)), x_scale=t(np.full(BIG_D, 10.0)),
        y_loc=t(-3.0), y_scale=t(2.5), y_max=t(0.0), clip_max=t(np.inf),
        svm=trivial_svm_params(BIG_D, NSV, torch.float64, dev,
                               MODE_ALL_FINITE),
        trust_lo=-inf, trust_hi=inf)
    return p, theta, X, y, noise


def lml_panels(family, thetas, X, y, n, noise, grad=False):
    """lml_value_grad_plain's LML (with ``grad`` its gradient, the same
    formula: 1/2 sum_ab (alpha alpha^T - K^-1)_ab dK_ab/dtheta) where its
    whole (n, n, d) difference tensor exceeds the card (208 GB at d = 48,
    n = 23,278): K assembled from masked_kernel_matrix_plain's row panels
    of PANEL_ROWS (each entry the whole matrix's bit for bit), the
    contraction with dK/dtheta panel by panel; a theta row at a time."""
    import torch
    from gpry_tpu_torch.ops import fused
    nmax = X.shape[0]
    spans = [(r, min(r + PANEL_ROWS, nmax)) for r in range(0, nmax,
                                                            PANEL_ROWS)]
    lmls, grads = [], []
    for th in thetas:
        th = th[None]
        with torch.no_grad():
            K = torch.cat([fused.masked_kernel_matrix_plain(
                family, th, X, n, noise, rows=sp) for sp in spans], dim=-2)
            L = fused.cholesky_nan(K)
            del K
            lml, z = fused._lml_of_L(L, y, n)
        lmls.append(lml)
        if not grad:
            continue
        with torch.no_grad():
            alpha = torch.linalg.solve_triangular(L.mT, z[..., None],
                                                  upper=True)[..., 0]
            eye = torch.eye(nmax, dtype=L.dtype, device=L.device)
            M = torch.linalg.solve_triangular(L, eye[None], upper=False)
            del eye, L
            W = alpha[..., :, None] * alpha[..., None, :] - M.mT @ M
            del M
        g = torch.zeros_like(th)
        for sp in spans:
            with torch.enable_grad():
                tg = th.detach().requires_grad_(True)
                Kp = fused.masked_kernel_matrix_plain(family, tg, X, n,
                                                      noise, rows=sp)
                g += torch.autograd.grad(Kp, tg, grad_outputs=0.5 * W[
                    ..., sp[0]:sp[1], :])[0]
        del W
        grads.append(g)
    lml = torch.cat(lmls)
    return (lml, torch.cat(grads)) if grad else lml


def lbfgs_lml_fit_panels(family, X, y, n, noise, theta0s, lo, hi, maxiter):
    """lbfgs_lml_fit_plain (ops/lbfgs.py's solver on -lml, tol 1e-8) with
    lml_panels' value and gradient."""
    import torch
    from gpry_tpu_torch.ops.lbfgs import minimize_lbfgs_bounded

    class NegLML(torch.autograd.Function):
        @staticmethod
        def forward(ctx, thetas):
            lml, g = lml_panels(family, thetas, X, y, n, noise, grad=True)
            ctx.save_for_backward(g)
            return -lml

        @staticmethod
        def backward(ctx, go):
            g, = ctx.saved_tensors
            return -go[:, None] * g

    def nll(thetas):
        if thetas.requires_grad:
            return NegLML.apply(thetas)
        return -lml_panels(family, thetas, X, y, n, noise)

    return minimize_lbfgs_bounded(nll, theta0s, lo, hi, maxiter=maxiter,
                                  tol=1e-8, return_iters=True)


def timed_once(fn):
    """(the result of fn(), its ms: host clock around the call and a
    synchronize)."""
    sync()
    t0 = time.perf_counter()
    out = fn()
    sync()
    return out, 1e3 * (time.perf_counter() - t0)


def route1_thetas(fam, gpr, R, seed, well=False):
    """``R`` theta rows for K10 on fit_data's GPR: uniform in the fit's
    box, as the screen draws them (a spec's theta0 +- 2), or with ``well``
    in a well-conditioned part of it (variance 0.1-10, length scales
    0.2-1 of the unit box; a spec's theta0 +- 0.3)."""
    import numpy as np
    rng = np.random.default_rng(seed)
    d = gpr._dX.shape[1]
    if is_spec(fam):
        theta0 = np.asarray(spec_kernel(d)[1])
        h = 0.3 if well else 2.0
        return rng.uniform(theta0 - h, theta0 + h, (R, len(theta0)))
    if well:
        return np.column_stack([rng.uniform(np.log(0.1), np.log(10.0), R),
                                rng.uniform(np.log(0.2), 0.0, (R, d))])
    lo, hi = gpr.theta_bounds[:, 0], gpr.theta_bounds[:, 1]
    return rng.uniform(lo, hi, (R, len(lo)))


def k10_plain_chunked(fam, thetas, X, y, n, noise):
    """lml_value_grad_plain's LML (lml_of_K of its padded K) a few theta
    rows at a time (its R x nmax^2 matrices and the (rows, nmax, nmax, d)
    differences of K3's plain version at once would not fit the card at n
    = 2,048; about 2 GB of those a chunk), and which rows are
    well-conditioned (check_k10's rule: the plain factor's smallest
    pivot^2 at least K10_WELL max diag(K))."""
    import torch
    from gpry_tpu_torch.ops import fused
    nmax, d = X.shape
    rows = max(1, min(64, (2 << 30) // (8 * nmax * nmax * max(d, 1))))
    lml, well = [], []
    for i in range(0, thetas.shape[0], rows):
        th = thetas[i:i + rows]
        K = fused.masked_kernel_matrix_plain(fam, th, X, n, noise)
        L = fused.cholesky_nan(K)
        lml.append(fused._lml_of_L(L, y, n)[0])
        dK = torch.diagonal(K, dim1=-2, dim2=-1)[:, :n]
        piv2 = torch.diagonal(L, dim1=-2, dim2=-1)[:, :n] ** 2
        well.append(torch.isfinite(lml[-1]) & (
            piv2.min(1).values >= K10_WELL * dK.max(1).values))
        del K, L
    return torch.cat(lml), torch.cat(well)


def check_route1(dev):
    """K10 and K11 on route 1 (the triangle in global memory, a row or a
    lane on a thread-block cluster), RBF and ALL_NODES, at d = D and each
    n of ROUTE1_NS (fit_data's draw; at n = 237 K10's RBF rows take route
    0, its spec rows and K11 route 1): K10 on ROUTE1_R rows and on the
    screen's ROUTE1_SCREEN rows (route1_thetas, the well-conditioned part
    of the box) in value mode, the LML within rel TOL_K10 on the rows
    check_k10 calls well-conditioned (k10_plain_chunked), or, on a row
    past that, within the plain LML's own rounding spread there
    (lml_spread; one row of the 2,049 at n = 2,048 is at 1.8e-10), and on
    ROUTE1_R rows in
    gradient mode, the gradient within TOL_K10_GRAD of max |g|; K11 on
    ROUTE1_R lanes (k11_starts) step for step over K11_STEPS iterations
    (the same nev, theta within TOL_K11_X of the box width, f the plain
    LML at the lane's own end within TOL_K11_F (1 + |f|) or, on a lane
    past that, within the plain LML's rounding spread there).  Each
    against its plain version (K10's by k10_plain_chunked).  Prints each case's cluster (fused.CLUSTERS) and
    error; returns {kernel row: {"n=..": {"R=..": error}}}."""
    import numpy as np
    import torch
    from gpry_tpu_torch.ops import fused
    out = {}
    for n in ROUTE1_NS:
        gpr, t = fit_data(dev, n=n)
        noise = gpr._noise_t()
        for fam in ("rbf", spec_kernel()[0]):
            sfx = "/spec" if is_spec(fam) else ""
            kern = fused._kern(fam, D, dev)
            sd = fused._spec_doubles(kern)
            # K11's route 1 starts at n = 237; K10's fast families keep
            # route 0 there (up to 237), a spec program takes route 1
            k10_route = fused.lml_value_grad_plan(n, D, sd)[0]
            if fused.lbfgs_lml_fit_plan(n, D, kern.ntheta, sd)[0] != 1 or \
                    (n > 237 and k10_route != 1):
                raise AssertionError(f"route 1 at n={n}: the plans give "
                                     "another route")
            for R in ROUTE1_R + (ROUTE1_SCREEN,):
                thetas = t(route1_thetas(fam, gpr, R, seed=R + n, well=True))
                fused.reset_launch_counts()
                lml = fused.lml_value_grad(fam, thetas, gpr._dX, gpr._dy, n,
                                           noise)
                shape = dict(fused.CLUSTERS)
                ref, well = k10_plain_chunked(fam, thetas, gpr._dX,
                                              gpr._dy, n, noise)
                # rel_err holds the NaN rows (K not positive definite in
                # the plain factor) to the same rows; the LML within rel
                # TOL_K10 on the well-conditioned rows, as check_k10 holds
                err, _ = rel_err(lml, ref)
                fin = torch.isfinite(ref)
                relw = torch.where(well, torch.abs(lml - ref)
                                   / torch.abs(ref), torch.zeros_like(ref))
                # a well-conditioned row past TOL_K10 is held to the plain
                # LML's own rounding spread at its theta instead
                # (lml_spread, as check_k11 holds the fit's end), if larger
                over = torch.nonzero(relw > TOL_K10).flatten().tolist()
                spread_ok = all(
                    abs(float(lml[r] - ref[r])) <= lml_spread(
                        fam, thetas[r], gpr._dX, gpr._dy, n, noise)
                    for r in over)
                rel = float(relw.max())
                case = {"route": k10_route, "rel": rel, "max_abs_err": err,
                        "rel_all": float(torch.max(
                            torch.abs(lml - ref)[fin] / torch.abs(ref[fin]))),
                        "nan_rows": int((~fin).sum()),
                        "ill_rows": int((fin & ~well).sum()),
                        "rows_past_tol_within_spread":
                            len(over) if spread_ok else None,
                        "clusters": shape}
                if R in ROUTE1_R:
                    lg, g = fused.lml_value_grad(fam, thetas, gpr._dX,
                                                 gpr._dy, n, noise,
                                                 grad=True)
                    _, gr = fused.lml_value_grad_plain(
                        fam, thetas, gpr._dX, gpr._dy, n, noise, grad=True)
                    if not torch.equal(torch.isnan(g), torch.isnan(gr)):
                        raise AssertionError(f"K10{sfx} route 1 n={n} R={R}:"
                                             " the gradients' NaN rows differ")
                    case["grad_rel"] = float(
                        torch.max(torch.abs(g - gr)[fin])
                        / torch.max(torch.abs(gr[fin])))
                log(f"[ROUTE1] K10{sfx} n={n} R={R}: " + json.dumps(case))
                if not (spread_ok and
                        case.get("grad_rel", 0.0) <= TOL_K10_GRAD):
                    raise AssertionError(f"K10{sfx} route 1 n={n} R={R}: "
                                         f"{case}")
                out.setdefault("lml_value_grad" + sfx, {}).setdefault(
                    f"n={n}", {})[f"R={R}"] = case
            for lanes in ROUTE1_R:
                lo, hi, th0 = k11_starts(fam, gpr, lanes)
                args = (fam, gpr._dX, gpr._dy, n, noise, t(th0), t(lo),
                        t(hi))
                fused.reset_launch_counts()
                th, f, nev = fused.lbfgs_lml_fit(*args, maxiter=K11_STEPS)
                shape = dict(fused.CLUSTERS)
                thr, fr, nevr = fused.lbfgs_lml_fit_plain(*args,
                                                          maxiter=K11_STEPS)
                sync()
                fin = torch.isfinite(fr)
                err_x = float(torch.max(torch.abs(th - thr)))
                # f is -LML at the lane's own end: held to the plain LML
                # there within TOL_K11_F (1 + |f|) or, on a lane past that,
                # within the plain LML's own rounding spread at that theta
                # (the C blocks sum the log det and z^T z in another order)
                at = -fused.lml_value_grad_plain(fam, th, *args[1:5])
                relf = torch.where(fin, torch.abs(f - at)
                                   / (1 + torch.abs(at)), torch.zeros_like(fr))
                err_f = float(relf.max())
                over = torch.nonzero(relf > TOL_K11_F).flatten().tolist()
                spread_ok = all(
                    abs(float(f[r] - at[r])) <= lml_spread(
                        fam, th[r], *args[1:5]) for r in over)
                case = {"nev": nev.tolist(), "nev_plain": nevr.tolist(),
                        "theta_err": err_x, "f_rel": err_f,
                        "lanes_past_tol_within_spread":
                            len(over) if spread_ok else None,
                        "clusters": shape}
                log(f"[ROUTE1] K11{sfx} n={n} lanes={lanes}: "
                    + json.dumps(case))
                if not (nev.tolist() == nevr.tolist()
                        and torch.equal(torch.isnan(f), torch.isnan(fr))
                        and err_x <= TOL_K11_X * float(np.max(hi - lo))
                        and spread_ok):
                    raise AssertionError(f"K11{sfx} route 1 n={n} lanes="
                                         f"{lanes}: {case}")
                out.setdefault("lbfgs_lml_fit" + sfx, {}).setdefault(
                    f"n={n}", {})[f"lanes={lanes}"] = case
            torch.cuda.empty_cache()
    return out


def lml_cluster_plans(dev, n, d=D, lanes=(8, 2)):
    """The library's route-1 cluster plans at n (RBF): K11's for each count
    of ``lanes`` and K10's value instance for as many rows, each with how
    many clusters of 1, 2, 4, 8 and 16 blocks the card runs at once
    (cudaOccupancyMaxActiveClusters; a package whose plan returns one count
    fills the first): {"K11 <lanes> lanes": {"C": .., "active": [..]},
    "K10 <lanes> rows": {"F": .., "C": .., "active": [..]}}; {} for a
    package without cluster plans."""
    import ctypes
    from gpry_tpu_torch.ops import fused
    if not hasattr(fused.library(), "gpry_lbfgs_lml_fit_cluster"):
        return {}
    lib, kern = fused.library(), fused._kern("rbf", d, dev)
    sx, sm, wk, per_sm = ctypes.c_int(), ctypes.c_size_t(), \
        ctypes.c_size_t(), ctypes.c_int()
    lib.gpry_lml_value_grad_plan(kern, n, d, 0, ctypes.byref(sx),
                                 ctypes.byref(sm), ctypes.byref(wk),
                                 ctypes.byref(per_sm))
    out = {}
    for k in lanes:
        C, F, act = ctypes.c_int(), ctypes.c_int(), (ctypes.c_int * 5)()
        lib.gpry_lbfgs_lml_fit_cluster(kern, k, n, d, ctypes.byref(C), act)
        out[f"K11 {k} lanes"] = {"C": C.value, "active": list(act)}
        act = (ctypes.c_int * 5)()
        lib.gpry_lml_value_grad_cluster(kern, k, n, d, 0, per_sm.value,
                                        ctypes.byref(F), ctypes.byref(C), act)
        out[f"K10 {k} rows"] = {"F": F.value, "C": C.value,
                                "active": list(act)}
    return out


def route1_screen(dev, n=2048):
    """K10 on the screen's ROUTE1_SCREEN rows at d = D, n (check_route1's
    draw: route1_thetas, well-conditioned, seed ROUTE1_SCREEN + n), RBF and
    ALL_NODES, against k10_plain_chunked: the largest relative error on
    the well-conditioned rows, on all finite rows, the row it is on, and
    a digest of the LML's bits, so that two checkouts that agree bit for
    bit show the same digest.  It calls only the wrappers, so that
    compare_trees.sh can run it on an older checkout."""
    import hashlib
    import torch
    from gpry_tpu_torch.ops import fused
    gpr, t = fit_data(dev, n=n)
    noise = gpr._noise_t()
    out = {}
    for fam in ("rbf", spec_kernel()[0]):
        thetas = t(route1_thetas(fam, gpr, ROUTE1_SCREEN,
                                 seed=ROUTE1_SCREEN + n, well=True))
        lml = fused.lml_value_grad(fam, thetas, gpr._dX, gpr._dy, n, noise)
        ref, well = k10_plain_chunked(fam, thetas, gpr._dX, gpr._dy, n,
                                      noise)
        fin = torch.isfinite(ref)
        rel = torch.abs(lml - ref) / torch.abs(ref)
        relw = torch.where(well, rel, torch.zeros_like(rel))
        out["spec" if is_spec(fam) else "rbf"] = {
            "rel_well": float(relw.max()), "row": int(relw.argmax()),
            "rel_all": float(rel[fin].max()),
            "digest": hashlib.sha256(
                lml.cpu().numpy().tobytes()).hexdigest()[:16]}
    log(f"[ROUTE1-SCREEN] n={n}: " + json.dumps(out))
    return out


def time_route1(dev):
    """K10 and K11 at the route-1 shapes of the kernel table (RBF; CUDA
    events, one warm-up): K11 at d = D, n = 1,024 and 2,048 on 2 and 8
    lanes (k11_starts) at maxiter K11_STEPS, ms per call and per
    evaluation of the slowest lane; K10 on the screen's ROUTE1_SCREEN rows
    in the fit's box (route1_thetas) at d = D, n = 1,024 and 2,048 and at
    d = 16, n = 4,480 (the default budgets of d = 8 and 16 are 1,584 and
    4,480), value mode, ms per call (one call at n = 4,480, host clock
    to a synchronize) and its finite rows.  Beside each, the
    yardstick torch.linalg.cholesky_ex on the same K (one lane's K for
    K11; for K10 one batched call over ROUTE1_CHOL_ROWS of the rows,
    scaled to R: it computes the factor alone) and the bound (lml_flops).
    It calls only the wrappers, with their arguments of every version
    since K10, so that compare_trees.sh can run it on an older checkout.
    Returns {"K11 n=.. lanes=..": row, "K10 d=.. n=..": row}."""
    import torch
    from gpry_tpu_torch.ops import fused
    out = {}
    for n in (1024, 2048):
        gpr, t = fit_data(dev, n=n)
        noise = gpr._noise_t()
        for lanes in (2, 8):
            lo, hi, th0 = k11_starts("rbf", gpr, lanes)
            args = ("rbf", gpr._dX, gpr._dy, n, noise, t(th0), t(lo), t(hi))
            call = lambda: fused.lbfgs_lml_fit(*args, maxiter=K11_STEPS)
            ms = time_ms(call, 3)
            nev = call()[2]
            K = fused.masked_kernel_matrix_plain(
                "rbf", t(th0[:1]), gpr._dX, n, noise)[0, :n, :n].contiguous()
            lib = time_ms(lambda: torch.linalg.cholesky_ex(K), 10)
            row = {"ms": ms, "nev": nev.tolist(),
                   "ms_per_eval": ms / int(nev.max()),
                   "plan": lml_cluster_plans(dev, n, lanes=(lanes,)),
                   "cholesky_ex_ms": lib,
                   **bound(int(nev.max()) * lml_flops("rbf", n, D + 1,
                                                      grad=True), 0)}
            out[f"K11 n={n} lanes={lanes}"] = row
            log(f"[ROUTE1-TIME] K11 n={n} lanes={lanes}: " + json.dumps(row))
            del K
    for d, n in ((D, 1024), (D, 2048), (16, 4480)):
        gpr, t = fit_data(dev, n=n, d=d)
        noise = gpr._noise_t()
        thetas = t(route1_thetas("rbf", gpr, ROUTE1_SCREEN, seed=n))
        call = lambda: fused.lml_value_grad("rbf", thetas, gpr._dX, gpr._dy,
                                            n, noise)
        if n <= 2048:
            ms = time_ms(call, 2)
            lml = call()
        else:
            # one call: the one-block route takes minutes here
            lml, ms = timed_once(call)
        fin = int(torch.isfinite(lml).sum())
        # the rows' K one at a time (K3's plain version holds an (n, n, d)
        # difference tensor a row)
        K = torch.stack([fused.masked_kernel_matrix_plain(
            "rbf", thetas[i:i + 1], gpr._dX, n, noise)[0, :n, :n]
            for i in range(ROUTE1_CHOL_ROWS)])
        lib = time_ms(lambda: torch.linalg.cholesky_ex(K), 3)
        row = {"ms": ms, "R": ROUTE1_SCREEN, "finite_rows": fin,
               "cholesky_ex_ms": lib * ROUTE1_SCREEN / ROUTE1_CHOL_ROWS,
               **bound(ROUTE1_SCREEN * lml_flops("rbf", n, d=d), 0)}
        out[f"K10 d={d} n={n}"] = row
        log(f"[ROUTE1-TIME] K10 d={d} n={n} R={ROUTE1_SCREEN}: "
            + json.dumps(row))
        del K
        torch.cuda.empty_cache()
    return out


def run_fit_phase(dev):
    """[FIT]: one full fit (fit_gpr_hyperparameters() with the Runner's
    10 + 2 d restarts: the screen, 8 polish lanes, the re-score) and then
    one simple fit (simple=True: the screen and 2 lanes, or the screen
    alone when the basin did not move) at d = D and n = FIT_N, the
    default budget there, on bench_data's smooth Gaussian.  Prints each
    fit's seconds (host clock to a synchronize), its K10 and K11 launches
    and the clusters they ran on (fused.CLUSTERS, where the package counts
    them), and the plans' C for 8 and 2 lanes (lml_cluster_plans).  Fails
    unless both fits end with a finite LML.  It drives the package through
    the GPR alone, so that compare_trees.sh can run it on an older
    checkout."""
    import numpy as np
    import torch
    from gpry_tpu_torch.models.gp import GaussianProcessRegressor
    from gpry_tpu_torch.models.preprocessing import Normalize_bounds, \
        Normalize_y
    from gpry_tpu_torch.ops import fused
    bounds, X, y = bench_data(n=FIT_N)
    # the Runner's restarts (10 + 2 d): a full fit polishes 8 lanes
    gpr = GaussianProcessRegressor(
        bounds=bounds, preprocessing_X=Normalize_bounds(bounds),
        preprocessing_y=Normalize_y(), n_restarts_optimizer=10 + 2 * D,
        random_state=0, verbose=0)
    gpr.append_to_data(X, y, fit_gpr=False)
    out = {"d": D, "n": FIT_N}
    if dev.type == "cuda":
        out["plan"] = lml_cluster_plans(dev, FIT_N)
    for kind, simple in (("full", False), ("simple", True)):
        fused.reset_launch_counts()
        t0 = time.perf_counter()
        gpr.fit_gpr_hyperparameters(simple=simple)
        sync()
        secs = time.perf_counter() - t0
        lml = float(gpr.log_marginal_likelihood_value_)
        out[kind] = {"s": secs, "lml": lml,
                     "K10": fused.LAUNCHES["lml_value_grad"],
                     "K11": fused.LAUNCHES["lbfgs_lml_fit"],
                     "clusters": dict(getattr(fused, "CLUSTERS", {}))}
        if not np.isfinite(lml):
            raise AssertionError(f"[FIT] the {kind} fit ended with LML {lml}")
    log("[FIT] " + json.dumps(out))
    return out


def check_big(dev):
    """At d = BIG_D and n = BIG_N (big_surrogate, RBF): K9 on its global
    route (3; 2 lanes from uniform starts in the box) step for step over
    K9_STEPS iterations (the same nev, x within TOL_K9_X of the box width,
    f within TOL_K9_F (1 + |f|)) and K8 on its global route (2) at BIG_NQ
    queries (check_k8's tolerances); then once each at that n: K2 (mean
    and std, rel TOL_K2) and K5 (mean rel TOL_K5, std rel TOL_K5_SIGMA) at
    BIG_NQ queries, K7 (mean rel TOL_K7, cov within TOL_K7_COV
    max|K(Xq, Xq)|) at BIG_NQ, K3 as the panel of the last row (rel
    TOL_K3); on the first BIG_FIT_N rows of the same data (K10's and
    K11's global route at d = BIG_D), K10 at 2 theta rows (the
    surrogate's and 0.1 above: rel TOL_K10 against lml_panels) and K11 on
    1 lane from the surrogate's theta + 0.2 at maxiter 1 (the same nev and
    iterations, theta within TOL_K11_X of the box width, f within
    TOL_K11_F (1 + |f|), against lbfgs_lml_fit_panels).  Each kernel's ms
    (host clock around the launch) beside its plain version's and its
    bound.  Returns {kernel row: {"d=48 n=..": row}}."""
    import numpy as np
    import torch
    from gpry_tpu_torch.ops import fused
    fam, d, n = "rbf", BIG_D, BIG_N
    key = f"d={d} n={n}"
    t0 = time.perf_counter()
    p, theta, X, y, noise = big_surrogate(dev)
    log(f"[BIG] surrogate at d={d} n={n} built in "
        f"{time.perf_counter() - t0:.1f} s")
    rng = np.random.default_rng(48)
    out = {}
    tri = n * (n + 1) // 2

    def put(name, row):
        out.setdefault(name, {})[key] = row
        log(f"[BIG] {name}: " + json.dumps(row))

    # K9, route 3
    lo = torch.full((d,), -5.0, dtype=torch.float64, device=dev)
    x0s = torch.as_tensor(rng.uniform(-5, 5, (2, d)), dtype=torch.float64,
                          device=dev)
    args = (d ** -0.85, 0.01, x0s, lo, -lo)
    route = fused.lbfgs_logexp_ascent_plan(n, d)[0]
    if route != 3:
        raise AssertionError(f"K9 at d={d} n={n}: route {route}, not 3")
    (xs, f, nev), ms = timed_once(lambda: fused.lbfgs_logexp_ascent(
        fam, p, *args, maxiter=K9_STEPS))
    (xr, fr, nevr, iters), plain_ms = timed_once(
        lambda: fused.lbfgs_logexp_ascent_plain(
            fam, p, *args, maxiter=K9_STEPS, return_iters=True))
    err_x = float(torch.max(torch.abs(xs - xr)))
    err_f = float(torch.max(torch.abs(f - fr) / (1 + torch.abs(fr))))
    if not (nev.tolist() == nevr.tolist() and err_x <= TOL_K9_X * 10.0
            and err_f <= TOL_K9_F):
        raise AssertionError(f"K9 at d={d} n={n}: nev {nev.tolist()} "
                             f"against {nevr.tolist()}, x {err_x}, f {err_f}")
    put("lbfgs_logexp_ascent", {
        "route": route, "lanes": 2, "maxiter": K9_STEPS, "nev": nev.tolist(),
        "max_abs_err": max(err_x, float(torch.max(torch.abs(f - fr)))),
        "f_rel": err_f, "ms": ms, "plain_ms": plain_ms,
        **k9_bound(fam, d, n, 2, iters, nevr)})
    # K8, route 2
    Xq = torch.as_tensor(rng.uniform(-5, 5, (BIG_NQ, d)), dtype=torch.float64,
                         device=dev)
    route = fused.meanstd_grad_plan(n, n, d, BIG_NQ)[0]
    if route != 2:
        raise AssertionError(f"K8 at d={d} n={n}: route {route}, not 2")
    got, ms = timed_once(lambda: fused.meanstd_grad(fam, p, Xq))
    ref, plain_ms = timed_once(lambda: fused.meanstd_grad_plain(fam, p, Xq))
    row, worst = {"route": route, "nq": BIG_NQ}, 0.0
    for what, a, b, tol in zip(("mean", "std", "dmean", "dstd"), got, ref,
                               (TOL_K8, TOL_K8, TOL_K8_GRAD, TOL_K8_GRAD)):
        err, rel = rel_err(a.reshape(-1), b.reshape(-1))
        row[f"{what}_rel"] = rel
        worst = max(worst, err)
        if not rel <= tol:
            raise AssertionError(f"K8 at d={d} n={n} {what}: rel {rel}")
    put("meanstd_grad", {**row, "max_abs_err": worst, "ms": ms,
                         "plain_ms": plain_ms,
                         **k8_bound(fam, BIG_NQ, d, n)})
    # K2, K5, K7 at BIG_NQ
    for name, call, plain, tols in (
            ("gated_meanvar_logexp",
             lambda: fused.gated_meanvar_logexp(fam, p, Xq),
             lambda: fused.gated_meanvar_logexp_plain(fam, p, Xq),
             (TOL_K2, TOL_K2)),
            ("meanvar_ungated", lambda: fused.meanvar_ungated(fam, p, Xq),
             lambda: fused.meanvar_ungated_plain(fam, p, Xq),
             (TOL_K5, TOL_K5_SIGMA))):
        got, ms = timed_once(call)
        ref, plain_ms = timed_once(plain)
        errs = [rel_err(a, b) for a, b in zip(got, ref)]
        if not all(e[1] <= tol for e, tol in zip(errs, tols)):
            raise AssertionError(f"{name} at d={d} n={n}: {errs}")
        put(name, {"nq": BIG_NQ, "mean_rel": errs[0][1],
                   "std_rel": errs[1][1],
                   "max_abs_err": max(e[0] for e in errs), "ms": ms,
                   "plain_ms": plain_ms,
                   **bound(BIG_NQ * (n * (pair_flops(fam, d) + 2) + n * n),
                           8 * (BIG_NQ * d + n * d + n + tri
                                + 2 * BIG_NQ))})
    Xq_ = (Xq - p.x_loc) / p.x_scale
    (mean, cov), ms = timed_once(lambda: fused.predict_meancov(
        fam, theta, X, n, noise, p.L, p.alpha, Xq_))
    (mr, cr), plain_ms = timed_once(lambda: fused.predict_meancov_plain(
        fam, theta, X, n, noise, p.L, p.alpha, Xq_))
    em, rm = rel_err(mean, mr)
    ec = float(torch.max(torch.abs(cov - cr)))
    kqq = float(torch.max(torch.abs(fused.kernel_diag(fam, theta, Xq_))))
    if not (rm <= TOL_K7 and ec <= TOL_K7_COV * kqq):
        raise AssertionError(f"K7 at d={d} n={n}: mean rel {rm}, cov {ec}")
    put("predict_meancov", {
        "nq": BIG_NQ, "mean_rel": rm, "cov_abs_err": ec,
        "max_abs_err": max(em, ec), "ms": ms, "plain_ms": plain_ms,
        **bound(BIG_NQ * n * (pair_flops(fam, d) + 2) + BIG_NQ * n * n
                + BIG_NQ * (BIG_NQ + 1) // 2 * (pair_flops(fam, d) + 2 * n),
                8 * (BIG_NQ * d + n * d + n + tri + BIG_NQ
                     + BIG_NQ * BIG_NQ))})
    # K3: the last row's panel
    th = theta[None]
    panel, ms = timed_once(lambda: fused.masked_kernel_matrix_batched(
        fam, th, X, n, noise, rows=(n - 1, n)))
    ref, plain_ms = timed_once(lambda: fused.masked_kernel_matrix_plain(
        fam, th, X, n, noise, rows=(n - 1, n)))
    err, rel = rel_err(panel, ref)
    if not rel <= TOL_K3:
        raise AssertionError(f"K3's panel at d={d} n={n}: rel {rel}")
    put("masked_kernel_matrix_batched", {
        "rows": 1, "rel": rel, "max_abs_err": err, "ms": ms,
        "plain_ms": plain_ms,
        **bound(n * pair_flops(fam, d), 8 * (n * d + d + 1 + n))})
    del panel, ref, p
    torch.cuda.empty_cache()
    # K10 at 2 theta rows, K11 on 1 lane, on the first BIG_FIT_N rows
    n, key = BIG_FIT_N, f"d={d} n={BIG_FIT_N}"
    X, y = X[:n].contiguous(), y[:n].contiguous()
    tri = n * (n + 1) // 2
    for name, plan in (("K10", fused.lml_value_grad_plan(n, d)),
                       ("K11", fused.lbfgs_lml_fit_plan(n, d, d + 1))):
        if plan[0] != 1:
            raise AssertionError(f"{name} at d={d} n={n}: route {plan[0]}, "
                                 "not 1")
    thetas = torch.stack([theta, theta + 0.1])
    lml, ms = timed_once(lambda: fused.lml_value_grad(fam, thetas, X, y, n,
                                                      noise))
    ref, plain_ms = timed_once(lambda: lml_panels(fam, thetas, X, y, n,
                                                  noise))
    err, rel = rel_err(lml, ref)
    if not rel <= TOL_K10:
        raise AssertionError(f"K10 at d={d} n={n}: rel {rel}")
    put("lml_value_grad", {
        "R": 2, "rel": rel, "max_abs_err": err, "ms": ms,
        "plain_ms": plain_ms,
        **bound(2 * lml_flops(fam, n, d=d),
                8 * (2 * (d + 1) + n * d + n + 2))})
    torch.cuda.empty_cache()
    lo_t, hi_t = theta - 2.0, theta + 2.0
    th0 = (theta + 0.2)[None]
    fit = lambda: fused.lbfgs_lml_fit(fam, X, y, n, noise, th0, lo_t, hi_t,
                                      maxiter=1, return_iters=True)
    (tk, fk, nk, ik), ms = timed_once(fit)
    torch.cuda.empty_cache()
    (tr, fr, nr, ir), plain_ms = timed_once(lambda: lbfgs_lml_fit_panels(
        fam, X, y, n, noise, th0, lo_t, hi_t, 1))
    err_t = float(torch.max(torch.abs(tk - tr)))
    err_f = float(torch.max(torch.abs(fk - fr) / (1 + torch.abs(fr))))
    if not (nk.tolist() == nr.tolist() and ik.tolist() == ir.tolist()
            and err_t <= TOL_K11_X * 4.0 and err_f <= TOL_K11_F):
        raise AssertionError(f"K11 at d={d} n={n}: nev {nk.tolist()} "
                             f"against {nr.tolist()}, theta {err_t}, f "
                             f"{err_f}")
    p_th = d + 1
    n_vg, n_probe = int((1 + ir).sum()), int((nr - 1 - ir).sum())
    put("lbfgs_lml_fit", {
        "lanes": 1, "maxiter": 1, "nev": nk.tolist(), "f_rel": err_f,
        "max_abs_err": max(err_t, float(torch.max(torch.abs(fk - fr)))),
        "ms": ms, "plain_ms": plain_ms, "value_grad_calls": n_vg,
        "probes": n_probe,
        **bound(n_vg * lml_flops(fam, n, p_th, grad=True, d=d)
                + n_probe * lml_flops(fam, n, d=d),
                8 * (3 * p_th + n * d + n + 2))})
    del X, y
    torch.cuda.empty_cache()
    return out


def check_kernels(dev):
    """Compare K1-K14 with their plain versions, the fast families and the
    ALL_NODES spec (K13 and K14's tp_quad have no spec instance); returns
    per-kernel rows
    (spec mode as "<name>/spec")."""
    import numpy as np
    import torch
    rng = np.random.default_rng(7)
    spec = spec_kernel()[0]
    rows = {}
    for fams, timed, sfx in ((FAST, "rbf", ""), ((spec,), spec, "/spec")):
        t0 = time.perf_counter()
        sizes = (16, 66, 2000, 16384, 65536) if not sfx else (66, 65536)
        rows["gated_mean" + sfx] = check_k1(dev, rng, fams, timed, sizes)
        rows["gated_meanvar_logexp" + sfx] = check_k2(dev, rng, fams, timed)
        rows["masked_kernel_matrix_batched" + sfx] = check_k3(dev, rng, fams,
                                                              timed)
        rows["kriging_believer_fill" + sfx] = check_k4(dev, rng, fams, timed)
        torch.cuda.empty_cache()
        rows["meanvar_ungated" + sfx] = check_k5(dev, rng, fams, timed)
        configs = [(svm, B) for svm in ("fitted", "all_finite")
                   for B in K6_B] if not sfx else \
            [("fitted", 66), ("all_finite", 33)]
        rows["ns_slice_chains" + sfx] = check_k6(dev, fams, timed, configs)
        rows["predict_meancov" + sfx] = check_k7(dev, rng, fams, timed)
        rows["meanstd_grad" + sfx] = check_k8(dev, rng, fams, timed)
        rows["lbfgs_logexp_ascent" + sfx] = check_k9(dev, fams, timed)
        rows["lml_value_grad" + sfx] = check_k10(dev, rng, fams, timed)
        rows["lbfgs_lml_fit" + sfx] = check_k11(dev, fams, timed)
        rows["mcmc_chains" + sfx] = check_k12(dev, fams, timed)
        if not sfx:
            rows["ns_step"] = check_k13(dev)
        rows["tp_cross_mean" + sfx], quad = check_k14(dev, fams, timed)
        if quad is not None:
            rows["tp_quad"] = quad
        torch.cuda.empty_cache()
        log(f"[CHECKS] {'spec' if sfx else 'fast families'}: "
            f"{time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    for name, by_d in check_wide(dev).items():
        rows[name]["wide"] = by_d
    log(f"[CHECKS] K8 and K9 at d = {WIDE_DS}: "
        f"{time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    for name, by_n in check_route1(dev).items():
        rows[name]["route1"] = by_n
    log(f"[CHECKS] K10 and K11 on route 1 at n = {ROUTE1_NS}: "
        f"{time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    for name, by_n in check_big(dev).items():
        rows[name]["big"] = by_n
    log(f"[CHECKS] d = {BIG_D}, n = {BIG_N}: "
        f"{time.perf_counter() - t0:.1f} s")
    return rows


def timed_audit(runner):
    """Wrap the Runner's ``_convergence_audit`` to count its calls and
    vetoes and sum its wall seconds; returns the dict it fills."""
    stats = {"audits": 0, "audit_vetoes": 0, "audit_s": 0.0}
    inner = runner._convergence_audit

    def audit():
        t0 = time.perf_counter()
        ok = inner()
        sync()
        stats["audit_s"] += time.perf_counter() - t0
        stats["audits"] += 1
        stats["audit_vetoes"] += int(not ok)
        return ok

    runner._convergence_audit = audit
    return stats


def run_runner(label, resample=True, seed=1, **kwargs):
    """A Runner on the d = 8 correlated Gaussian at ``seed`` (``kwargs``
    pick the engine and options): ``run()`` then, with ``resample``,
    ``generate_mc_sample()`` (else the sample drawn at the declaration),
    gated on convergence and KL(sample || truth) <= KL_GATE.  Returns
    (runner, sample, summary)."""
    import numpy as np
    from model_generator import random_gaussian
    from gpry_tpu_torch.progress import _COLUMNS
    from gpry_tpu_torch.run import Runner
    from gpry_tpu_torch.utils.tools import kl_norm, mean_covmat_from_samples
    model = random_gaussian(d=D, rng=10 + D)
    t0 = time.perf_counter()
    runner = Runner(model.loglike, bounds=model.bounds, seed=seed,
                    verbose=2, **kwargs)
    audit = timed_audit(runner)
    runner.run()
    t_run = time.perf_counter() - t0
    t0 = time.perf_counter()
    sample = runner.last_mc_result
    if resample or sample is None:
        sample = runner.generate_mc_sample()
    t_mc = time.perf_counter() - t0
    mean, cov = mean_covmat_from_samples(sample["X"], sample["weights"])
    kl = max(kl_norm(mean, cov, model.mean, model.cov),
             kl_norm(model.mean, model.cov, mean, cov))
    tab = runner.progress.table
    col = lambda c: float(np.nansum(tab[:, _COLUMNS.index(c)]))
    summary = {"run_s": t_run, "generate_mc_sample_s": t_mc,
               "fit_s": col("time_fit"), "acquisition_s": col("time_acquire"),
               "truth_s": col("time_truth"), "ns_s": sample["time_ns"],
               "refine_s": sample["time_refine"], "kl": kl,
               "n_total": int(runner.gpr.n_total),
               "iterations": int(runner.current_iteration),
               "n_audited": int(runner._n_audited), **audit}
    log(f"[{label}] converged={runner.has_converged} n_total="
        f"{runner.gpr.n_total} iterations={runner.current_iteration} "
        f"KL={kl:.4g} refined={bool(sample.get('refined'))} "
        f"ns_steps={sample['ns_steps']} ns_calls={sample['n_calls']} "
        f"audited={runner._n_audited} audits={audit['audits']} audit "
        f"vetoes={audit['audit_vetoes']} audit s={audit['audit_s']:.3f}")
    log(f"[{label}] phase seconds: " + json.dumps(summary))
    if not runner.has_converged:
        raise AssertionError(f"{label}: the d=8 Runner did not converge")
    if not (np.isfinite(kl) and kl <= KL_GATE):
        raise AssertionError(f"{label}: KL(sample || truth) = {kl} > "
                             f"{KL_GATE}")
    if sample["X"].shape[1] != D or not np.all(np.isfinite(sample["X"])):
        raise AssertionError(f"{label}: the final sample is malformed")
    return runner, sample, summary


def check_cov(label, gpr, seed):
    """``predict(X, return_cov=True)`` at NQ_COV prior draws: finite, of
    shape (NQ_COV, NQ_COV), its mean the gated mean of ``return_std`` and,
    wherever that mean is finite, its diagonal (clamped at 0, as the std
    is) within TOL_COV_DIAG max diag(cov) of std^2.  Returns the summary."""
    import numpy as np
    rng = np.random.default_rng(seed)
    b = gpr.bounds
    X = rng.uniform(b[:, 0], b[:, 1], (NQ_COV, b.shape[0]))
    t0 = time.perf_counter()
    mean, cov = gpr.predict(X, return_cov=True)
    sync()
    t_cov = time.perf_counter() - t0
    mean_s, std = gpr.predict(X, return_std=True)
    fin = np.isfinite(mean_s)
    scale = float(np.max(np.diag(cov)))
    diag = np.maximum(np.diag(cov), 0.0)
    err = float(np.max(np.abs(diag[fin] - std[fin] ** 2))) \
        if fin.any() else 0.0
    summary = {"nq": NQ_COV, "predict_cov_s": t_cov, "finite": int(fin.sum()),
               "diag_max_abs_err": err, "max_diag": scale,
               "min_diag": float(np.min(np.diag(cov)))}
    log(f"[{label}] predict(return_cov=True): " + json.dumps(summary))
    if cov.shape != (NQ_COV, NQ_COV) or not np.all(np.isfinite(cov)):
        raise AssertionError(f"{label}: malformed covariance")
    if not np.array_equal(mean, mean_s, equal_nan=True):
        raise AssertionError(f"{label}: return_cov's mean is not the gated "
                             "mean of return_std")
    if not fin.any() or not err <= TOL_COV_DIAG * scale:
        raise AssertionError(f"{label}: diag(cov) - std^2 = {err} > "
                             f"{TOL_COV_DIAG} x max diag(cov) {scale}")
    return summary


def check_grad(label, gpr, seed):
    """``predict(X, return_std=True, return_mean_grad=True,
    return_std_grad=True)`` at NQ_COV prior draws (K8): finite gradients
    of shape (NQ_COV, d), the mean and std those of ``return_std``.
    Returns the summary."""
    import numpy as np
    rng = np.random.default_rng(seed)
    b = gpr.bounds
    X = rng.uniform(b[:, 0], b[:, 1], (NQ_COV, b.shape[0]))
    t0 = time.perf_counter()
    mean, std, g_mean, g_std = gpr.predict(
        X, return_std=True, return_mean_grad=True, return_std_grad=True)
    sync()
    t_grad = time.perf_counter() - t0
    mean_s, std_s = gpr.predict(X, return_std=True)
    summary = {"nq": NQ_COV, "predict_grad_s": t_grad,
               "max_abs_mean_grad": float(np.max(np.abs(g_mean))),
               "max_abs_std_grad": float(np.max(np.abs(g_std)))}
    log(f"[{label}] predict(return_mean_grad, return_std_grad): "
        + json.dumps(summary))
    if g_mean.shape != X.shape or g_std.shape != X.shape or \
            not (np.all(np.isfinite(g_mean)) and np.all(np.isfinite(g_std))):
        raise AssertionError(f"{label}: malformed gradients")
    if not (np.array_equal(mean, mean_s, equal_nan=True)
            and np.array_equal(std, std_s)):
        raise AssertionError(f"{label}: the gradient call's mean and std "
                             "are not return_std's")
    return summary


#: path a's run, for paths i, k and l: its training sets, theta and truth
#: evals, its Runner and its final sample
REFERENCE_RUN = {}


def run_default_with_cov():
    """Path a: the default Runner, then K7 and K8 on its surrogate."""
    runner, sample, summary = run_runner("SLICE")
    REFERENCE_RUN.update(
        X=runner.gpr.X_train_all.copy(), y=runner.gpr.y_train_all.copy(),
        theta=runner.gpr.kernel_theta.copy(), n_total=runner.gpr.n_total,
        runner=runner, sample=sample)
    summary["cov"] = check_cov("SLICE", runner.gpr, seed=21)
    summary["grad"] = check_grad("SLICE", runner.gpr, seed=21)
    return summary


def run_spec_runner():
    """Path f: the default Runner with the composite kernel SPEC_F."""
    runner, _, summary = run_runner("SPEC", gpr={"kernel": SPEC_F})
    if not isinstance(runner.gpr.family, tuple):
        raise AssertionError("spec_runner: the GP does not run a spec")
    band = max(4, 0.25 * JAX_SPEC_EVALS)
    summary["n_total_jax"] = JAX_SPEC_EVALS
    summary["within_band"] = abs(summary["n_total"] - JAX_SPEC_EVALS) <= band
    log(f"[SPEC] truth evals {summary['n_total']} (gpry_tpu: "
        f"{JAX_SPEC_EVALS}); within max(4, 25%): {summary['within_band']}")
    return runner, summary


def run_spec_cov_nora(runner):
    """Path g on f's surrogate: K7 and K8 in spec mode, then one NORA
    ``multi_add(n_points=8)`` (its ranked pool: K4 in spec mode)."""
    import numpy as np
    from gpry_tpu_torch.acquisition import NORA
    gpr = runner.gpr
    summary = {"cov": check_cov("SPEC-COV", gpr, seed=22),
               "grad": check_grad("SPEC-COV", gpr, seed=22)}
    acq = NORA(gpr.bounds, rng=np.random.default_rng(2), verbose=1)
    t0 = time.perf_counter()
    Xn, _, vals = acq.multi_add(gpr, n_points=D)
    sync()
    summary["nora_multi_add_s"] = time.perf_counter() - t0
    b = gpr.bounds
    if Xn.shape != (D, D) or not np.all(np.isfinite(vals)) or \
            not np.all((Xn >= b[:, 0]) & (Xn <= b[:, 1])):
        raise AssertionError(f"spec NORA: malformed proposal {Xn.shape}")
    log("[SPEC-NORA] " + json.dumps(summary))
    return summary


def run_wide():
    """Path (n): the default Runner (BatchOptimizer, LogExp, the audit on)
    on the d = WIDE_D correlated Gaussian of tests/model_generator.py (its
    prior box WIDE_PRIOR_STD standard deviations each way), its
    default budget max_total = 70 d^1.5 (17,708 at d = 40: the range check
    of K11, K9 and K8 runs at the full budget when it is built), stopped
    after WIDE_ITERS iterations by its ``callback`` (which raises there,
    as path i's does: max_finite would count only the points within the
    finiteness threshold of the best, 8 iterations on this run); then
    generate_mc_sample() at its default options (nlive 50 d, num_repeats 5
    d).  Fails unless the Runner ran WIDE_ITERS iterations of d believer
    steps each, its WIDE_ITERS d proposals are finite and inside the prior
    box, and the final sample is finite, of width d, from an NS run that
    ended.  KL(sample || truth) is printed, not gated: three iterations do
    not converge at d = 40."""
    import numpy as np
    from model_generator import random_gaussian
    from gpry_tpu_torch.acquisition.batch_optimizer import BatchOptimizer
    from gpry_tpu_torch.ops import fused
    from gpry_tpu_torch.run import Runner
    from gpry_tpu_torch.utils.tools import kl_norm, mean_covmat_from_samples
    d = WIDE_D
    model = random_gaussian(d=d, prior_size_in_std=WIDE_PRIOR_STD,
                            rng=10 + d)

    class Stop(Exception):
        pass

    def stop(runner):
        if runner.current_iteration >= WIDE_ITERS:
            raise Stop

    t0 = time.perf_counter()
    runner = Runner(model.loglike, bounds=model.bounds, seed=1, verbose=2,
                    callback=stop)
    t_build = time.perf_counter() - t0
    if runner.max_total != int(70 * d ** 1.5) or not runner.audit or \
            not isinstance(runner.acquisition, BatchOptimizer):
        raise AssertionError(f"wide: not the default Runner (max_total "
                             f"{runner.max_total}, audit {runner.audit})")
    try:
        runner.run()
    except Stop:
        pass
    t_run = time.perf_counter() - t0 - t_build
    new = np.asarray(runner.gpr.X_train_all)[-WIDE_ITERS * d:]
    lo, hi = model.bounds[:, 0], model.bounds[:, 1]
    n_init = int(runner.gpr.n_total) - WIDE_ITERS * d
    if not (runner.current_iteration == WIDE_ITERS
            and BELIEVER["steps"] == WIDE_ITERS * d
            and n_init >= runner.n_initial
            and np.all(np.isfinite(new)) and np.all(new >= lo)
            and np.all(new <= hi)):
        raise AssertionError(
            f"wide: {runner.current_iteration} iterations, "
            f"{BELIEVER['steps']} believer steps, n_total "
            f"{runner.gpr.n_total}, proposals finite "
            f"{bool(np.all(np.isfinite(new)))}, in the box "
            f"{bool(np.all((new >= lo) & (new <= hi)))}")
    t0 = time.perf_counter()
    sample = runner.generate_mc_sample()
    t_mc = time.perf_counter() - t0
    Xs = np.asarray(sample["X"])
    if not (Xs.ndim == 2 and Xs.shape[1] == d and len(Xs) > 0
            and np.all(np.isfinite(Xs)) and sample["ns_steps"] > 0):
        raise AssertionError(f"wide: the final sample is malformed "
                             f"({Xs.shape}, {sample['ns_steps']} NS steps)")
    mean, cov = mean_covmat_from_samples(Xs, sample["weights"])
    kl = max(kl_norm(mean, cov, model.mean, model.cov),
             kl_norm(model.mean, model.cov, mean, cov))
    summary = {"d": d, "max_total": int(runner.max_total),
               "initial_design": n_init, "n_total": int(runner.gpr.n_total),
               "n_finite": int(runner.gpr.n),
               "iterations": int(runner.current_iteration),
               "build_s": t_build, "run_s": t_run,
               "generate_mc_sample_s": t_mc, "ns_s": sample["time_ns"],
               "refine_s": sample["time_refine"],
               "ns_steps": int(sample["ns_steps"]),
               "ns_calls": int(sample["n_calls"]), "sample": len(Xs),
               "kl": float(kl), "fit_clusters": dict(fused.CLUSTERS)}
    log("[WIDE-RUNNER] " + json.dumps(summary))
    return summary


def bench_data(seed=0, n=N, d=D):
    """bench.py's make_data (bench.py:44-49): N = 224 uniform points in
    the unit 8-cube under a centred isotropic Gaussian (``n`` points: the
    same first N, then more of the same draw; ``d``: the unit d-cube)."""
    import numpy as np
    rng = np.random.default_rng(seed)
    bounds = np.array([[0.0, 1.0]] * d)
    X = rng.uniform(size=(n, d))
    y = -0.5 * 25 * np.sum((X - 0.5) ** 2, axis=1)
    return bounds, X, y


def run_bench(engine, n_timed=2):
    """bench.py's operating point on the port (bench.py:52-92) for
    ``engine`` "nora" (path b: ``force_resample()`` before each
    ``multi_add``) or "batchoptimizer" (path h: ``BatchOptimizer(...,
    random_state=1)``, ``multi_add(..., rng=np.random.default_rng(1))``):
    a 26-restart fit and ``multi_add(n_points=8)``, once to warm up and
    ``n_timed`` times timed."""
    import numpy as np
    from gpry_tpu_torch.acquisition import NORA, BatchOptimizer
    from gpry_tpu_torch.models.gp import GaussianProcessRegressor
    from gpry_tpu_torch.models.preprocessing import Normalize_bounds, \
        Normalize_y
    from gpry_tpu_torch.ops import fused
    tag = "NORA-BENCH" if engine == "nora" else "BO-BENCH"
    bounds, X, y = bench_data()
    gpr = GaussianProcessRegressor(
        bounds=bounds, preprocessing_X=Normalize_bounds(bounds),
        preprocessing_y=Normalize_y(), random_state=0, verbose=1)
    gpr.append_to_data(X, y, fit_gpr=False)
    if engine == "nora":
        acq = NORA(bounds, acq_func={"LogExp": {"dimension": D}},
                   rng=np.random.default_rng(1), verbose=1)
    else:
        acq = BatchOptimizer(bounds, acq_func={"LogExp": {"dimension": D}},
                             random_state=1, verbose=1)
    iters = []
    for i in range(1 + n_timed):
        acq.force_resample()
        before = dict(fused.LAUNCHES)
        t0 = time.perf_counter()
        gpr.fit_gpr_hyperparameters(n_restarts=10 + 2 * D)
        sync()
        t_fit = time.perf_counter() - t0
        if engine == "nora":
            Xn, _, acq_vals = acq.multi_add(gpr, n_points=D)
        else:
            Xn, _, acq_vals = acq.multi_add(gpr, n_points=D,
                                            rng=np.random.default_rng(1))
        sync()
        t_acq = time.perf_counter() - t0 - t_fit
        if Xn.shape != (D, D) or not np.all(np.isfinite(acq_vals)) or \
                not np.all((Xn >= bounds[:, 0]) & (Xn <= bounds[:, 1])):
            raise AssertionError(f"{tag} iteration {i}: malformed "
                                 f"proposal {Xn.shape}")
        it = {"fit_s": t_fit, "acq_s": t_acq,
              "launches": {k: fused.LAUNCHES[k] - before[k]
                           for k in before}}
        if engine == "nora":
            it.update(nlive=acq._nlive(gpr),
                      ns_samples=int(len(acq.last_MC_X)))
        log(f"[{tag}] {'warm-up' if i == 0 else f'iter {i}'}: "
            + json.dumps(it))
        iters.append(it)
    timed = [it["fit_s"] + it["acq_s"] for it in iters[1:]]
    summary = {"iters": iters, "fit_acq_s_min": min(timed),
               "fit_acq_s_median": float(np.median(timed))}
    log(f"[{tag}] fit + acquisition s/iter: min {min(timed):.4f}, "
        f"median {summary['fit_acq_s_median']:.4f}")
    return summary


def process_truth(x):
    """Path i's truth for the process pool: module-level, so that the
    standard pickle carries it to a spawned worker."""
    import numpy as np
    x = np.asarray(x, dtype=float)
    return float(-0.5 * np.sum(x * x) + np.sin(x[0]))


class _Interrupt(Exception):
    """Raised by path i's callback to stop its first Runner."""


def run_resumed():
    """Path i: path a's Runner with ``checkpoint=`` in a temporary
    directory, stopped at iteration RESUME_STOP_AT by a callback that
    raises, then resumed from the checkpoint by a fresh Runner with a
    thread pool of 4 as its truth executor and run to the end.  Its
    training sets, theta and truth evals must equal path a's (the
    checkpoint keeps the factor, the RNG stream and the loop's state as
    they were, and no kernel sums with atomics).  Prints each save's and
    the load's seconds and the checkpoint's bytes, and checks that the
    heartbeat file was touched inside the fits and the final NS and that
    the final chain was written.  Then a process pool of 2 (spawned, with
    this process's CUDA context live) evaluates a module-level truth."""
    import shutil
    import tempfile
    import numpy as np
    from model_generator import random_gaussian
    from gpry_tpu_torch import io as gio
    from gpry_tpu_torch.mc import samples
    from gpry_tpu_torch.models.gp import GaussianProcessRegressor
    from gpry_tpu_torch.parallel import TruthExecutor
    from gpry_tpu_torch.run import Runner
    from gpry_tpu_torch.truth import Truth
    if not REFERENCE_RUN:
        raise AssertionError("resumed_runner: path a has not run")
    model = random_gaussian(d=D, rng=10 + D)
    root = tempfile.mkdtemp(prefix="gpry_resume_")
    ckpt = os.path.join(root, "ckpt")
    heartbeat = os.path.join(ckpt, "liveness.heartbeat")
    saves, loads, ticks, last = [], [], {"fit": 0, "ns": 0}, [0.0]
    save_inner, read_inner = gio.save_checkpoint, gio.read_checkpoint
    liveness_inner = GaussianProcessRegressor._liveness
    ns_inner = samples.run_nested_device

    def timed_save(*args, **kwargs):
        t0 = time.perf_counter()
        save_inner(*args, **kwargs)
        saves.append(time.perf_counter() - t0)

    def timed_read(*args, **kwargs):
        t0 = time.perf_counter()
        out = read_inner(*args, **kwargs)
        loads.append(time.perf_counter() - t0)
        return out

    def touched():
        # the heartbeat holds the time of its last touch (none before the
        # first save has made the checkpoint's directory)
        if not os.path.exists(heartbeat):
            return 0
        with open(heartbeat) as f:
            stamp = float(f.read())
        new = stamp >= last[0]
        last[0] = stamp
        return int(new)

    def fit_tick(self):
        liveness_inner(self)
        if getattr(self, "liveness_callback", None) is not None:
            ticks["fit"] += touched()

    def ns_with_ticks(*args, on_segment=None, **kwargs):
        def tick():
            on_segment()
            ticks["ns"] += touched()
        return ns_inner(*args, on_segment=None if on_segment is None
                        else tick, **kwargs)

    def stop(runner):
        if runner.current_iteration == RESUME_STOP_AT:
            raise _Interrupt

    gio.save_checkpoint, gio.read_checkpoint = timed_save, timed_read
    GaussianProcessRegressor._liveness = fit_tick
    samples.run_nested_device = ns_with_ticks
    try:
        t0 = time.perf_counter()
        first = Runner(model.loglike, bounds=model.bounds, seed=1,
                       verbose=2, callback=stop, checkpoint=ckpt,
                       load_checkpoint="overwrite")
        try:
            first.run()
        except _Interrupt:
            pass
        else:
            raise AssertionError("resumed_runner: the first Runner was "
                                 "not interrupted")
        n_stopped, saves_first = first.gpr.n_total, len(saves)
        del first
        t_first = time.perf_counter() - t0
        t0 = time.perf_counter()
        runner = Runner(model.loglike, bounds=model.bounds, verbose=2,
                        checkpoint=ckpt, load_checkpoint="resume",
                        truth_executor={"mode": "threads", "max_workers": 4})
        if runner.current_iteration != RESUME_STOP_AT - 1:
            raise AssertionError(
                f"resumed_runner: resumed at iteration "
                f"{runner.current_iteration}, not {RESUME_STOP_AT - 1}")
        runner.run()
        runner.executor.shutdown()
        t_resumed = time.perf_counter() - t0
        gpr = runner.gpr
        files = [os.path.join(ckpt, f) for f in gio._CHECKPOINT_FILES]
        ckpt_bytes = {os.path.basename(f): os.path.getsize(f)
                      for f in files}
        chain = os.path.join(ckpt, "chains", "mc_samples.txt")
        chain_rows = np.loadtxt(chain, ndmin=2) \
            if os.path.exists(chain) else None
        # the process pool, with this process's CUDA context live
        truth = Truth(process_truth, model.bounds)
        Xp = np.random.default_rng(3).uniform(
            model.bounds[:, 0], model.bounds[:, 1], (16, D))
        t0 = time.perf_counter()
        pool = TruthExecutor(truth, mode="processes", max_workers=2)
        try:
            got = pool.logp_batch(Xp)
        finally:
            pool.shutdown()
        t_pool = time.perf_counter() - t0
        want = np.array([truth.logp(x) for x in Xp])
    finally:
        gio.save_checkpoint, gio.read_checkpoint = save_inner, read_inner
        GaussianProcessRegressor._liveness = liveness_inner
        samples.run_nested_device = ns_inner
        shutil.rmtree(root, ignore_errors=True)
    ref = REFERENCE_RUN
    same_shape = gpr.X_train_all.shape == ref["X"].shape
    err_x = float(np.max(np.abs(gpr.X_train_all - ref["X"]) / np.maximum(
        np.abs(ref["X"]), 1e-300))) if same_shape else math.inf
    err_y = float(np.max(np.abs(gpr.y_train_all - ref["y"]) / np.maximum(
        np.abs(ref["y"]), 1e-300))) if same_shape else math.inf
    err_t = float(np.max(np.abs(gpr.kernel_theta - ref["theta"])
                         / np.abs(ref["theta"])))
    summary = {
        "first_run_s": t_first, "resumed_run_s": t_resumed,
        "stopped_at_n_total": int(n_stopped),
        "n_total": int(gpr.n_total), "n_total_path_a": int(ref["n_total"]),
        "iterations": int(runner.current_iteration),
        "converged": bool(runner.has_converged),
        "saves": len(saves), "saves_before_stop": saves_first,
        "save_s": saves, "save_s_mean": float(np.mean(saves)),
        "load_s": loads, "checkpoint_bytes": ckpt_bytes,
        "checkpoint_bytes_total": int(sum(ckpt_bytes.values())),
        "heartbeat_ticks_in_fits": ticks["fit"],
        "heartbeat_ticks_in_final_ns": ticks["ns"],
        "chain_rows": None if chain_rows is None else len(chain_rows),
        "rel_err_X": err_x, "rel_err_y": err_y, "rel_err_theta": err_t,
        "process_pool_s": t_pool}
    log("[RESUME] " + json.dumps(summary))
    if not same_shape or gpr.n_total != ref["n_total"]:
        raise AssertionError(
            f"resumed_runner: {gpr.n_total} truth evals, path a "
            f"{ref['n_total']}")
    if not (err_x <= TOL_RESUME_X and err_y <= TOL_RESUME_X
            and err_t <= TOL_RESUME_THETA):
        raise AssertionError(
            f"resumed_runner: differs from path a (rel X {err_x}, y "
            f"{err_y}, theta {err_t})")
    if not runner.has_converged:
        raise AssertionError("resumed_runner: the run did not converge")
    if not (ticks["fit"] > 0 and ticks["ns"] > 0):
        raise AssertionError(f"resumed_runner: the heartbeat was not "
                             f"touched in the fits and the final NS: "
                             f"{ticks}")
    # the chain's columns: weight, -logpost (inf where a refine draw
    # fell outside the surrogate's support, at weight 0), the point
    if chain_rows is None or chain_rows.shape[1] != D + 2 or \
            not np.all(np.isfinite(chain_rows[:, [0] + list(
                range(2, D + 2))])) or not np.any(chain_rows[:, 0] > 0):
        raise AssertionError("resumed_runner: chains/mc_samples.txt is "
                             "missing or malformed")
    if not np.array_equal(got, want):
        raise AssertionError(f"resumed_runner: the process pool's values "
                             f"{got} differ from {want}")
    return summary


def run_polish():
    """Path j: bench.py's BatchOptimizer point (d = 8, N = 224) with the
    gradient-free polish: a 26-restart fit, then one ``multi_add(
    n_points=8)`` of ``BatchOptimizer(..., acq_optimizer="sampling")``
    (scipy's Powell, each objective call one K2 launch at nq 1).  Every
    point finite and inside the bounds, each polish's answer one of its own
    calls (Powell returns a point it evaluated: the K2 value there, bit for
    bit), and the K2 launches the screens (one a believer step), the lies
    (one a step) and the polish's calls (``obj_fun_eval_num`` less the
    screens' points).  How far each answer lies above or below its start
    (Powell's bounded line searches may end below it, as in the reference)
    is logged, not gated.  Host-bound by design: the per-call figures are
    in drive_paths."""
    import numpy as np
    from gpry_tpu_torch.acquisition import BatchOptimizer
    from gpry_tpu_torch.models.gp import GaussianProcessRegressor
    from gpry_tpu_torch.models.preprocessing import Normalize_bounds, \
        Normalize_y
    from gpry_tpu_torch.ops import fused
    bounds, X, y = bench_data()
    gpr = GaussianProcessRegressor(
        bounds=bounds, preprocessing_X=Normalize_bounds(bounds),
        preprocessing_y=Normalize_y(), random_state=0, verbose=1)
    gpr.append_to_data(X, y, fit_gpr=False)
    t0 = time.perf_counter()
    gpr.fit_gpr_hyperparameters(n_restarts=10 + 2 * D)
    sync()
    t_fit = time.perf_counter() - t0
    acq = BatchOptimizer(bounds, acq_func={"LogExp": {"dimension": D}},
                         acq_optimizer="sampling", random_state=1,
                         verbose=1)
    polish = acq._polish_gradient_free
    steps = []

    def watched(score, p, x0s, bounds_, as_t):
        seen = []

        def recorded(p_, X_):
            v = score(p_, X_)
            seen.append((X_.cpu().numpy()[0], float(v.cpu()[0])))
            return v

        t1 = time.perf_counter()
        xs, vals = polish(recorded, p, x0s, bounds_, as_t)
        t_step = time.perf_counter() - t1
        starts, answers = [], []
        for x0, x, v in zip(np.asarray(x0s), xs, vals):
            starts.append(next(f for y, f in seen if np.array_equal(y, x0)))
            answers.append(any(np.array_equal(y, x) and f == v
                               for y, f in seen))
        steps.append({"calls": len(seen), "s": t_step,
                      "polished": vals.tolist(), "starts": starts,
                      "answers_evaluated": answers})
        return xs, vals

    acq._polish_gradient_free = watched
    k2_0, evals0 = fused.LAUNCHES["gated_meanvar_logexp"], \
        acq.obj_fun_eval_num
    t0 = time.perf_counter()
    Xn, _, acq_vals = acq.multi_add(gpr, n_points=D,
                                    rng=np.random.default_rng(1))
    sync()
    t_acq = time.perf_counter() - t0
    k2 = fused.LAUNCHES["gated_meanvar_logexp"] - k2_0
    n_screen = min(10 * D * acq.n_restarts_optimizer, 4000)
    calls = acq.obj_fun_eval_num - evals0 - D * n_screen
    summary = {"fit_s": t_fit, "multi_add_s": t_acq, "calls": calls,
               "polish_s": float(sum(st["s"] for st in steps)),
               "k2_launches": k2, "obj_fun_eval_num":
               acq.obj_fun_eval_num - evals0, "screen_points": n_screen,
               "calls_by_step": [st["calls"] for st in steps],
               "worst_gain_over_start": float(min(
                   min(np.asarray(st["polished"]) - np.asarray(st["starts"]))
                   for st in steps)),
               "polishes_below_start": int(sum(
                   np.sum(np.asarray(st["polished"]) <
                          np.asarray(st["starts"])) for st in steps))}
    log("[POLISH] " + json.dumps(summary))
    if Xn.shape != (D, D) or not np.all(np.isfinite(Xn)) or \
            not np.all(np.isfinite(acq_vals)) or \
            not np.all((Xn >= bounds[:, 0]) & (Xn <= bounds[:, 1])):
        raise AssertionError(f"polish: malformed proposal {Xn}")
    for i, st in enumerate(steps):
        if not all(st["answers_evaluated"]):
            raise AssertionError(f"polish: believer step {i} returned a "
                                 f"point or value its K2 calls did not "
                                 f"give: {st}")
    if calls != sum(st["calls"] for st in steps) or \
            k2 != calls + 2 * len(steps):
        raise AssertionError(
            f"polish: {k2} K2 launches for {calls} polish calls and "
            f"{len(steps)} believer steps (a screen and a lie each)")
    return summary


class FakeComm4:
    """Rank 0's side of an in-process 4-rank MPI world (path k): rank 0 is
    this process; ranks 1-3 evaluate their slices of each broadcast batch
    inside ``gather``, through ``TruthExecutor._eval_slice`` on ``truth``.
    Counts the points each rank evaluated."""

    def __init__(self, truth=None):
        self.truth = truth
        self.cmds = []
        self.points = [0, 0, 0, 0]

    def bcast(self, value, root=0):
        self.cmds.append(value)
        return value

    def gather(self, value, root=0):
        import numpy as np
        from gpry_tpu_torch.parallel import TruthExecutor
        X = np.atleast_2d(self.cmds[-1][1])
        out = [value]
        self.points[0] += len(value)
        for rank in (1, 2, 3):
            ex = TruthExecutor(self.truth, mode="serial")
            out.append(ex._eval_slice(X, rank, 4))
            self.points[rank] += len(out[-1])
        return out


def set_ranks(comm, rank, size=4, barriers=None):
    """Set gpry_tpu_torch.mpi's globals to rank ``rank`` of ``size`` over
    ``comm``, the barrier appending to ``barriers``; returns the old
    values, for ``set_ranks_back``."""
    from gpry_tpu_torch import mpi
    names = ("multiple_processes", "is_main_process", "RANK", "SIZE",
             "mpi_comm", "sync_processes")
    old = {k: getattr(mpi, k) for k in names}
    new = (size > 1, rank == 0, rank, size, comm,
           lambda: barriers.append(rank))
    for k, v in zip(names, new):
        setattr(mpi, k, v)
    return old


def set_ranks_back(old):
    from gpry_tpu_torch import mpi
    for k, v in old.items():
        setattr(mpi, k, v)


def run_mpi_runner():
    """Path k: path a's Runner with ``truth_executor="mpi"`` under an
    in-process 4-rank comm (FakeComm4: ranks 1-3 evaluate their slices
    inside the gather), ``callback=diagnosis`` and a checkpoint in a
    temporary directory.  Its training set, y and theta must equal path
    a's bit for bit, with the same truth evals: where a slice is evaluated
    changes no value, and the order is restored.  Ranks 1-3 evaluated
    some points, rank 0 not all; the last command is ("stop",); every
    iteration's diagnosis has consistent sizes.  Then, as rank 1 (its
    barrier stubbed), a second Runner on the checkpoint with the serial
    executor waits instead of serving, makes no truth call, re-syncs to
    rank 0's iteration and convergence, and its GPR predicts path a's
    mean at NQ_COV points bit for bit."""
    import shutil
    import tempfile
    import numpy as np
    from model_generator import random_gaussian
    from gpry_tpu_torch.diag import diagnosis
    from gpry_tpu_torch.run import Runner
    ref = REFERENCE_RUN
    if not ref:
        raise AssertionError("mpi_runner: path a has not run")
    model = random_gaussian(d=D, rng=10 + D)
    root = tempfile.mkdtemp(prefix="gpry_mpi_")
    ckpt = os.path.join(root, "ckpt")
    reports, barriers, calls = [], [], {"rank1": 0}
    comm = FakeComm4()

    def rank1_loglike(x):
        calls["rank1"] += 1
        return model.loglike(x)

    old = set_ranks(comm, 0, barriers=barriers)
    try:
        t0 = time.perf_counter()
        runner = Runner(model.loglike, bounds=model.bounds, seed=1,
                        verbose=2, truth_executor="mpi",
                        callback=lambda r: reports.append(diagnosis(r)),
                        checkpoint=ckpt, load_checkpoint="overwrite")
        comm.truth = runner.truth
        runner.run()
        t_run = time.perf_counter() - t0
        set_ranks(comm, 1, barriers=barriers)
        t0 = time.perf_counter()
        rank1 = Runner(rank1_loglike, bounds=model.bounds, verbose=2,
                       checkpoint=ckpt, load_checkpoint="resume")
        rank1.current_iteration, rank1.has_converged = 0, False
        rank1.run()
        t_rank1 = time.perf_counter() - t0
    finally:
        set_ranks_back(old)
        shutil.rmtree(root, ignore_errors=True)
    rng = np.random.default_rng(21)
    b = model.bounds
    Xq = rng.uniform(b[:, 0], b[:, 1], (NQ_COV, D))
    mean_a = ref["runner"].gpr.predict(Xq)
    mean_1 = rank1.gpr.predict(Xq)
    gpr = runner.gpr
    same = gpr.X_train_all.shape == ref["X"].shape and \
        np.array_equal(gpr.X_train_all, ref["X"]) and \
        np.array_equal(gpr.y_train_all, ref["y"]) and \
        np.array_equal(gpr.kernel_theta, ref["theta"])
    summary = {
        "run_s": t_run, "rank1_s": t_rank1, "n_total": int(gpr.n_total),
        "n_total_path_a": int(ref["n_total"]),
        "iterations": int(runner.current_iteration),
        "converged": bool(runner.has_converged),
        "equal_to_path_a": bool(same),
        "points_by_rank": list(comm.points),
        "broadcasts": len(comm.cmds), "last_command": list(comm.cmds[-1]),
        "diagnoses": len(reports),
        "max_residual_last_batch": max(
            (r.get("max_residual_last_batch", 0.0) for r in reports),
            default=None),
        "rank1_truth_calls": calls["rank1"], "barriers": barriers,
        "rank1_iteration": int(rank1.current_iteration),
        "rank1_converged": bool(rank1.has_converged),
        "rank1_mean_equal": bool(np.array_equal(mean_1, mean_a,
                                                equal_nan=True))}
    log("[MPI] " + json.dumps(summary))
    if not same or gpr.n_total != ref["n_total"]:
        raise AssertionError(f"mpi_runner: differs from path a "
                             f"({gpr.n_total} truth evals, path a "
                             f"{ref['n_total']})")
    if not (sum(comm.points[1:]) > 0 and comm.points[0] < gpr.n_total):
        raise AssertionError(f"mpi_runner: points by rank {comm.points}")
    if comm.cmds[-1] != ("stop",) or barriers[:1] != [0]:
        raise AssertionError(f"mpi_runner: the workers were not released "
                             f"(last command {comm.cmds[-1]}, barriers "
                             f"{barriers})")
    if len(reports) != runner.current_iteration or \
            not all(r["sizes_consistent"] for r in reports):
        raise AssertionError(f"mpi_runner: diagnoses {reports}")
    if calls["rank1"] or barriers != [0, 1] or \
            rank1.current_iteration != runner.current_iteration or \
            rank1.has_converged != runner.has_converged:
        raise AssertionError(f"mpi_runner: rank 1 did not wait and re-sync: "
                             f"{summary}")
    if not summary["rank1_mean_equal"]:
        raise AssertionError("mpi_runner: rank 1's GPR does not predict "
                             "path a's mean bit for bit")
    return summary


#: path l's Cobaya likelihood calls, one point each
N_COBAYA_CALLS = 1000
#: path l: each call within this of the batched predictions (relative)
TOL_COBAYA = 1e-12


def run_periphery():
    """Path l, on path a's fitted Runner: the surrogate as a Cobaya
    likelihood (``cobaya_generate_gp_model_input``), called once per point
    at N_COBAYA_CALLS points of path a's final sample, as Cobaya calls it.
    Each call is one ``gpr.predict`` of one point (one K2 launch, one host
    read) and returns a float; each value is held within TOL_COBAYA
    (relative) against one batched ``gpr.predict`` plus the log prior
    volume, and against the device samplers' target density (the gated
    mean, K1) at the same points within the rounding bound of their sum,
    n eps y_scale sum_i |k_i alpha_i| (K1 and K2 sum k . alpha in other
    orders, and a fitted GP's alpha cancels: gated_mean_bound).  Then, where matplotlib imports, the
    Runner's plots (``plot_mc``, ``plot_distance_distribution``,
    ``plot_progress(trace=True, slices=True)``) and, on a d = 2 Runner of
    a few iterations, ``plot_model_2d`` of the mean, std and acquisition
    into a temporary directory, each file not empty; where it does not,
    that is logged and nothing is rendered."""
    import shutil
    import tempfile
    import numpy as np
    import torch
    from gpry_tpu_torch.mc.cobaya_mc import cobaya_generate_gp_model_input
    from gpry_tpu_torch.mc.samples import surrogate_logp_fn
    from gpry_tpu_torch.ops import fused
    ref = REFERENCE_RUN
    if not ref:
        raise AssertionError("periphery: path a has not run")
    runner, sample = ref["runner"], ref["sample"]
    gpr = runner.gpr
    params = runner.truth.params
    info = cobaya_generate_gp_model_input(gpr, params=params)
    lkl = info["likelihood"]["gp"]["external"]
    X = np.ascontiguousarray(sample["X"][:N_COBAYA_CALLS])
    kwargs = [dict(zip(params, map(float, x))) for x in X]
    vol = float(np.sum(np.log(gpr.bounds[:, 1] - gpr.bounds[:, 0])))
    k2_0 = fused.LAUNCHES["gated_meanvar_logexp"]
    t0 = time.perf_counter()
    got = [lkl(**kw) for kw in kwargs]
    t_calls = time.perf_counter() - t0
    k2 = fused.LAUNCHES["gated_meanvar_logexp"] - k2_0
    floats = all(type(v) is float for v in got)
    got = np.array(got)
    want = gpr.predict(X) + vol
    p = gpr.surrogate_params()
    dens = surrogate_logp_fn(gpr.family)(
        p, torch.as_tensor(X, dtype=p.X.dtype, device=p.X.device)
    ).cpu().numpy() + vol

    def rel(a, b):
        fin = np.isfinite(b)
        if not np.array_equal(np.isfinite(a), fin) or \
                not np.array_equal(a[~fin], b[~fin]):
            return math.inf
        return float(np.max(np.abs(a[fin] - b[fin]) / np.abs(b[fin]))) \
            if fin.any() else 0.0

    summary = {"calls": len(got), "calls_s": t_calls,
               "call_us": 1e6 * t_calls / len(got), "k2_launches": k2,
               "finite": int(np.isfinite(got).sum()), "floats": floats,
               "rel_err_batched_predict": rel(got, want),
               "rel_err_gated_mean": rel(got, dens), "plots": None}
    fin = np.isfinite(dens)
    bound = gated_mean_bound(gpr, p, X)
    err = np.abs(got - dens)
    summary["max_abs_err_gated_mean"] = float(np.max(err[fin], initial=0.0))
    summary["max_err_over_bound_gated_mean"] = float(
        np.max(err[fin] / bound[fin], initial=0.0)) \
        if np.array_equal(np.isfinite(got), fin) else math.inf
    try:
        import matplotlib  # noqa: F401
    except ImportError as excpt:
        log(f"[PERIPHERY] matplotlib does not import here ({excpt}): no "
            "plot rendered")
    else:
        root = tempfile.mkdtemp(prefix="gpry_plots_")
        try:
            summary["plots"] = render_plots(runner, root)
        finally:
            shutil.rmtree(root, ignore_errors=True)
    log("[PERIPHERY] " + json.dumps(summary))
    if not floats or k2 != len(got):
        raise AssertionError(f"periphery: {k2} K2 launches for {len(got)} "
                             f"likelihood calls (floats: {floats})")
    if not (summary["rel_err_batched_predict"] <= TOL_COBAYA
            and summary["max_err_over_bound_gated_mean"] <= 1.0):
        raise AssertionError(f"periphery: the Cobaya likelihood differs: "
                             f"{summary}")
    if summary["finite"] < len(got) // 2:
        raise AssertionError("periphery: most likelihood values are -inf")
    return summary


def gated_mean_bound(gpr, p, X):
    """The rounding bound of the surrogate mean's sum at each row of X,
    n eps |y_scale| sum_i |k(x, x_i) alpha_i| (n the valid rows), within
    which two kernels that sum k . alpha in other orders agree."""
    import numpy as np
    import torch
    from gpry_tpu_torch.ops import fused
    Xt = torch.as_tensor(X, dtype=p.X.dtype, device=p.X.device)
    Xq_ = (Xt - p.x_loc) / p.x_scale
    terms = (fused._cross_masked(gpr.family, p, Xq_) * p.alpha).abs().sum(1)
    eps = float(np.finfo(np.float64).eps)
    return (p.n * eps * abs(float(p.y_scale)) * terms).cpu().numpy()


def render_plots(runner, root):
    """Path l's plots (matplotlib imports): path a's Runner's, and
    ``plot_model_2d`` on a d = 2 Runner of a few iterations; returns each
    file's bytes, and raises if one is empty."""
    import numpy as np
    import torch
    from model_generator import random_gaussian
    from gpry_tpu_torch import plots as gplots
    from gpry_tpu_torch.run import Runner
    files = {"mc": os.path.join(root, "mc.png"),
             "distance": os.path.join(root, "distance.png")}
    runner.plot_mc(output=files["mc"])
    runner.plot_distance_distribution(output=files["distance"])
    keep, runner.checkpoint = runner.checkpoint, root
    try:
        runner.plot_progress(trace=True, slices=True)
    finally:
        runner.checkpoint = keep
    for name in ("timing", "convergence", "trace", "slices"):
        files[name] = os.path.join(root, "images", name + ".png")
    m2 = random_gaussian(d=2, rng=12)
    small = Runner(m2.loglike, bounds=m2.bounds, seed=1, verbose=1,
                   options={"max_total": 14, "n_points_per_acq": 2},
                   convergence_criterion="DontConverge", mc="uniform")
    small.run()
    acq = small.acquisition.acq_func
    noise = float(np.mean(small.gpr.noise_level))

    def acq_fn(mu, sd):
        return acq.values(torch.as_tensor(mu), torch.as_tensor(sd),
                          small.gpr.y_max, noise).numpy()

    for what, kw in (("mean", {}), ("std", {}),
                     ("acq", {"acq_func": acq_fn})):
        files["model_2d_" + what] = os.path.join(root, f"model_{what}.png")
        gplots.plot_model_2d(small.gpr, what=what,
                             save=files["model_2d_" + what], **kw)
    sizes = {k: os.path.getsize(f) if os.path.exists(f) else 0
             for k, f in files.items()}
    empty = [k for k, v in sizes.items() if not v]
    if empty:
        raise AssertionError(f"periphery: empty or missing plots {empty}")
    return sizes


def run_mcmc(runner, ns_sample):
    """``mc_sample_from_gp(sampler="mcmc")`` on the NORA Runner's
    surrogate: split-R-hat < 1.2 and KL between its Gaussian and the NS
    sample's <= KL_GATE (both directions)."""
    import numpy as np
    from gpry_tpu_torch.mc.samples import mc_sample_from_gp
    from gpry_tpu_torch.utils.tools import kl_norm, mean_covmat_from_samples
    t0 = time.perf_counter()
    s = mc_sample_from_gp(runner.gpr, sampler="mcmc", rng=5, verbose=2)
    t_mc = time.perf_counter() - t0
    m1, c1 = mean_covmat_from_samples(s["X"], s["weights"])
    m0, c0 = mean_covmat_from_samples(ns_sample["X"], ns_sample["weights"])
    kl = max(kl_norm(m1, c1, m0, c0), kl_norm(m0, c0, m1, c1))
    summary = {"mcmc_s": s["time_mcmc"], "refine_s": s["time_refine"],
               "total_s": t_mc, "rhat": s["rhat"], "kl_vs_ns": kl,
               "n_calls": s["n_calls"], "refined": bool(s.get("refined"))}
    log("[MCMC] " + json.dumps(summary))
    if not s["rhat"] < 1.2:
        raise AssertionError(f"MCMC split-R-hat {s['rhat']} >= 1.2")
    if not (np.isfinite(kl) and kl <= KL_GATE):
        raise AssertionError(f"KL(MCMC, NS) = {kl} > {KL_GATE}")
    if s["X"].shape[1] != D or not np.all(np.isfinite(s["X"])):
        raise AssertionError("the MCMC sample is malformed")
    return summary


def grid_truth_moments(model, n_grid=1001):
    """Exact posterior mean and covariance of a 2-d model by quadrature on
    an n_grid x n_grid grid over its bounds (benchmarks/nongaussian.py's
    truth_moments_grid)."""
    import numpy as np
    b = model.bounds
    g0 = np.linspace(b[0, 0], b[0, 1], n_grid)
    g1 = np.linspace(b[1, 0], b[1, 1], n_grid)
    X = np.stack(np.meshgrid(g0, g1, indexing="ij"), axis=-1).reshape(-1, 2)
    logp = model.loglike_batch(X)
    w = np.exp(logp - np.max(logp))
    w /= w.sum()
    mean = w @ X
    diff = X - mean
    return mean, (w[:, None] * diff).T @ diff


def run_himmelblau_audit(seed=100):
    """The audited NORA Runner on Himmelblau at the default options
    (benchmarks/nongaussian.py:110, seed 100): converged, moment-KL of the
    final sample against the grid-quadrature truth <= KL_GATE, every
    quadrant's mode >= 5% of the weight.  Other seeds serve
    compare_trees.sh's spread of the truth evals."""
    import numpy as np
    from model_generator import himmelblau
    from gpry_tpu_torch.run import Runner
    from gpry_tpu_torch.utils.tools import kl_norm, mean_covmat_from_samples
    model = himmelblau()
    mean_t, cov_t = grid_truth_moments(model)
    t0 = time.perf_counter()
    runner = Runner(model.loglike, bounds=model.bounds, seed=seed,
                    verbose=2, gp_acquisition="NORA")
    audit = timed_audit(runner)
    runner.run()
    if runner.last_mc_result is None:
        runner.generate_mc_sample()
    t_run = time.perf_counter() - t0
    s = runner.last_mc_result
    mean, cov = mean_covmat_from_samples(s["X"], s["weights"])
    kl = max(kl_norm(mean, cov, mean_t, cov_t),
             kl_norm(mean_t, cov_t, mean, cov))
    X, w = s["X"], s["weights"] / np.sum(s["weights"])
    quadrants = [float(np.sum(w[(sx * X[:, 0] > 0) & (sy * X[:, 1] > 0)]))
                 for sx, sy in ((1, 1), (-1, 1), (-1, -1), (1, -1))]
    summary = {"run_s": t_run, "converged": bool(runner.has_converged),
               "n_total": int(runner.gpr.n_total),
               "n_total_jax": JAX_HIMMELBLAU_EVALS,
               "iterations": int(runner.current_iteration),
               "n_audited": int(runner._n_audited), **audit,
               "moment_kl": float(kl), "quadrant_weights": quadrants}
    log(f"[HIMMELBLAU] converged={runner.has_converged} n_total="
        f"{runner.gpr.n_total} (gpry_tpu: {JAX_HIMMELBLAU_EVALS}) audited="
        f"{runner._n_audited} audit vetoes={audit['audit_vetoes']} audit "
        f"s={audit['audit_s']:.3f} momKL={kl:.4g} quadrants="
        f"{np.round(quadrants, 4).tolist()}")
    log("[HIMMELBLAU] " + json.dumps(summary))
    if not runner.has_converged:
        raise AssertionError("himmelblau_audit: the Runner did not converge")
    if not (np.isfinite(kl) and kl <= KL_GATE):
        raise AssertionError(f"himmelblau_audit: moment-KL {kl} > "
                             f"{KL_GATE}")
    if min(quadrants) < 0.05:
        raise AssertionError(f"himmelblau_audit: a mode holds < 5% of the "
                             f"weight: {quadrants}")
    return summary


def mesh_devices():
    """Path m's mesh: every visible card where there are two or more,
    else MESH_LOGICAL shards on cuda:0."""
    import torch
    n = torch.cuda.device_count()
    if n >= 2:
        return [torch.device("cuda", i) for i in range(n)]
    return [torch.device("cuda", 0)] * MESH_LOGICAL


def bits_equal(label, got, want):
    """Fail unless the tensors are equal bit for bit (NaN where NaN)."""
    import torch
    for g, w in zip(got, want):
        if g.shape != w.shape or not torch.equal(
                torch.nan_to_num(g, nan=7.0), torch.nan_to_num(w, nan=7.0)) \
                or not torch.equal(torch.isnan(g), torch.isnan(w)):
            raise AssertionError(f"mesh: {label} differs from the unsharded "
                                 "launch")


def run_mesh():
    """Path m: the device mesh (gpry_tpu_torch/parallel/mesh.py) over
    mesh_devices(), each shard's kernels launched on its own card:
    * the DP predict at MESH_DP_NQ queries on bench.py's NORA point (d =
      8, N = 224, a 26-restart fit): K2 on every shard, equal to the
      unsharded ``surrogate_predict`` bit for bit;
    * the TP predict on a d = 8 surrogate of MESH_TP_N rows of
      MESH_TP_NMAX at MESH_TP_NQ queries (K14 on every shard): within
      tests/test_parallel.py's tolerances of the single-device predict,
      its largest sigma gap printed; and on path a's final surrogate (a
      fitted, ill-conditioned d = 8 GP) at 255 points of its final sample,
      the largest |sigma_TP - sigma_solve| / sigma printed, not gated;
    * ``_sharded_fit_theta`` with MESH_FIT_LANES restarts on path h's
      data (N = 224): every lane's theta, -LML and evals equal the
      unsharded K11 launch's bit for bit;
    * an NS run (nlive MESH_NS_NLIVE, its kill batch the largest multiple
      of the mesh size not above nlive / 6) with its chains over the mesh
      (K6 on every shard): X, logZ and n_dead equal the unsharded run's
      bit for bit (the draws stay on the run's generator);
    * path a's Runner and its K7 / K8 checks with ``available_mesh``
      forced to the mesh: SHARD_STATS' fit and predict > 0, tp reported;
      with no TP predict the training sets within rel TOL_MESH_X of path
      a's and theta within TOL_MESH_THETA, else KL <= KL_GATE and the
      truth evals within max(4, 25%) of path a's."""
    import numpy as np
    import torch
    from gpry_tpu_torch.mc import samples
    from gpry_tpu_torch.models import gp as gpm
    from gpry_tpu_torch.parallel import mesh as mesh_mod
    mesh = mesh_mod.make_mesh(mesh_devices())
    P = mesh.shape["data"]
    log(f"[MESH] {P} shards over {mesh.n_distinct} distinct card(s): "
        + ", ".join(str(d) for d in mesh.devices))
    summary = {"shards": P, "distinct_cards": mesh.n_distinct}
    dev = mesh.devices[0]

    # DP predict at bench.py's NORA point
    from gpry_tpu_torch.models.preprocessing import Normalize_bounds, \
        Normalize_y
    bounds, X, y = bench_data()
    gpr = gpm.GaussianProcessRegressor(
        bounds=bounds, preprocessing_X=Normalize_bounds(bounds),
        preprocessing_y=Normalize_y(), random_state=0, verbose=0)
    gpr.append_to_data(X, y, fit_gpr=False)
    gpr.fit_gpr_hyperparameters(n_restarts=10 + 2 * D)
    p = gpr.surrogate_params()
    rng = np.random.default_rng(41)
    Xq = torch.as_tensor(rng.uniform(0, 1, (MESH_DP_NQ, D)),
                         dtype=torch.float64, device=dev)
    t0 = time.perf_counter()
    got = mesh_mod.sharded_predict(gpr.family, p, Xq, mesh)
    sync()
    summary["dp_predict_s"] = time.perf_counter() - t0
    bits_equal("the DP predict", got, gpm.surrogate_predict(gpr.family, p,
                                                             Xq))

    # TP predict
    pt, _, _, _ = k14_inputs("rbf", dev, P, MESH_TP_NQ)
    Xt = torch.as_tensor(rng.uniform(-5, 5, (MESH_TP_NQ, D)),
                         dtype=torch.float64, device=dev)
    t0 = time.perf_counter()
    mean_tp, std_tp = mesh_mod.tp_predict("rbf", pt, Xt, mesh)
    sync()
    summary["tp_predict_s"] = time.perf_counter() - t0
    mean_1, std_1 = gpm.surrogate_predict("rbf", pt, Xt)
    summary["tp_synthetic"] = tp_gap(mean_tp, std_tp, mean_1, std_1)
    if not summary["tp_synthetic"]["within"]:
        raise AssertionError("mesh: the TP predict is outside "
                             "tests/test_parallel.py's tolerances: "
                             + json.dumps(summary["tp_synthetic"]))
    ref = REFERENCE_RUN["runner"].gpr
    pa = ref.surrogate_params()
    if pa.X.shape[0] % P == 0:
        Xa = torch.as_tensor(REFERENCE_RUN["sample"]["X"][:255],
                             dtype=torch.float64, device=dev)
        summary["tp_path_a"] = tp_gap(
            *mesh_mod.tp_predict(ref.family, pa, Xa, mesh),
            *gpm.surrogate_predict(ref.family, pa, Xa))
        summary["tp_path_a"]["nmax"] = int(pa.X.shape[0])
        summary["tp_path_a"]["n"] = int(pa.n)

    # the fit's lanes
    fg, t = fit_data(dev)
    lo, hi = fg.theta_bounds[:, 0], fg.theta_bounds[:, 1]
    th0 = np.random.default_rng(43).uniform(lo, hi, (MESH_FIT_LANES,
                                                      len(lo)))
    args = (fg.family, fg._dX, fg._dy, fg.n, fg._noise_t(), t(th0), t(lo),
            t(hi))
    t0 = time.perf_counter()
    got = mesh_mod._sharded_fit_theta(*args, mesh, maxiter=120)
    sync()
    summary["fit_s"] = time.perf_counter() - t0
    bits_equal("the fit's lanes", got,
               gpm._fit_theta_restarts(*args, maxiter=120))
    summary["fit_nev"] = [int(v) for v in got[2].tolist()]

    # the NS's chains
    lo8 = torch.zeros(D, dtype=torch.float64, device=dev)
    hi8 = torch.ones(D, dtype=torch.float64, device=dev)
    B = (MESH_NS_NLIVE // 6) // P * P
    runs = []
    for m in (mesh, None):
        gen = torch.Generator(device=dev).manual_seed(45)
        t0 = time.perf_counter()
        runs.append(samples.run_nested_device(
            samples.surrogate_logp_fn(gpr.family), p, gen, lo8, hi8,
            nlive=MESH_NS_NLIVE, num_repeats=5 * D, kill_batch=B,
            max_dead=60 * MESH_NS_NLIVE, mesh=m))
        sync()
        summary["ns_s" if m is not None else "ns_unsharded_s"] = \
            time.perf_counter() - t0
    rs, r1 = runs
    if not (rs.n_dead == r1.n_dead and rs.logZ == r1.logZ
            and rs.n_calls == r1.n_calls):
        raise AssertionError(f"mesh: the sharded NS run ({rs.n_dead} dead, "
                             f"logZ {rs.logZ}) is not the unsharded one's "
                             f"({r1.n_dead}, {r1.logZ})")
    bits_equal("the NS run", (rs.X, rs.logl, rs.logw),
               (r1.X, r1.logl, r1.logw))
    summary["ns"] = {"kill_batch": B, "n_dead": rs.n_dead,
                     "logZ": rs.logZ, "steps": rs.n_steps}

    # path a's Runner under the mesh
    mesh_mod.SHARD_STATS.update(predict=0, fit=0, tp=0)
    inner = mesh_mod.available_mesh
    mesh_mod.available_mesh = lambda *a, **k: mesh
    try:
        runner, _, summary["runner"] = run_runner("MESH")
        summary["runner"]["cov"] = check_cov("MESH", runner.gpr, seed=21)
        summary["runner"]["grad"] = check_grad("MESH", runner.gpr, seed=21)
    finally:
        mesh_mod.available_mesh = inner
    stats = dict(mesh_mod.SHARD_STATS)
    summary["shard_stats"] = stats
    g = runner.gpr
    n_a = REFERENCE_RUN["n_total"]
    if stats["tp"] == 0:
        gap = {"n_total": int(g.n_total), "n_total_path_a": n_a}
        if g.X_train_all.shape == REFERENCE_RUN["X"].shape:
            gap.update({k: float(np.max(np.abs(a - b) / np.maximum(
                np.abs(b), 1e-300))) for k, a, b in (
                ("X_rel", g.X_train_all, REFERENCE_RUN["X"]),
                ("y_rel", g.y_train_all, REFERENCE_RUN["y"]),
                ("theta_rel", g.kernel_theta, REFERENCE_RUN["theta"]))})
        same = "X_rel" in gap and gap["X_rel"] <= TOL_MESH_X and \
            gap["y_rel"] <= TOL_MESH_X and gap["theta_rel"] <= TOL_MESH_THETA
        summary["runner"].update(path_a_gap=gap, equal_to_path_a=bool(same),
                                 bit_equal_to_path_a=bool(
                                     same and gap["X_rel"] == 0
                                     and gap["theta_rel"] == 0))
        if not same:
            raise AssertionError("mesh: the Runner under the mesh left path "
                                 "a's trajectory: " + json.dumps(gap))
    elif abs(g.n_total - n_a) > max(4, 0.25 * n_a):
        raise AssertionError(f"mesh: {g.n_total} truth evals under the "
                             f"mesh, path a {n_a}")
    log("[MESH] " + json.dumps(summary))
    if not (stats["fit"] > 0 and stats["predict"] > 0):
        raise AssertionError(f"mesh: the Runner did not dispatch through "
                             f"the mesh: {stats}")
    return summary


def tp_gap(mean_tp, std_tp, mean_1, std_1):
    """The TP predict against the single-device one: the largest mean and
    sigma errors, the largest |sigma_TP - sigma_solve| / sigma (sigma >
    0), and whether both are within TOL_TP_MEAN / TOL_TP_STD (rtol,
    atol)."""
    import torch
    if not torch.equal(torch.isfinite(mean_tp), torch.isfinite(mean_1)):
        raise AssertionError("mesh: the TP predict's gates differ")
    fin = torch.isfinite(mean_1)
    dm = torch.abs(mean_tp[fin] - mean_1[fin])
    ds = torch.abs(std_tp - std_1)
    pos = std_1 > 0
    (mr, ma), (sr, sa) = TOL_TP_MEAN, TOL_TP_STD
    return {"nq": int(mean_1.numel()),
            "max_abs_mean_err": float(dm.max()) if dm.numel() else 0.0,
            "max_abs_sigma_err": float(ds.max()),
            "max_rel_sigma_gap": float((ds[pos] / std_1[pos]).max())
            if bool(pos.any()) else 0.0,
            "within": bool(torch.all(dm <= ma + mr * mean_1[fin].abs())
                           and torch.all(ds <= sa + sr * std_1.abs()))}


NS_RUNS = {"runs": 0, "steps": 0, "s": 0.0, "segments": 0, "reads": 0,
           "max_reads_over_bound": -1, "k6_launches": 0}
# the MCMC runs per path (mc_sample_from_gp(sampler="mcmc") and the
# GaussianKL criteria's fallback)
MCMC_RUNS = {"runs": 0}
# the steps an NS run queues between two reads of its stop flag
NS_SEG = 8
# the believer steps of the BatchOptimizer (its LogExp ascents) per path
BELIEVER = {"steps": 0}
# K3's row panels per path, by row of the kernels line (a trace holds one
# symbol for K3's whole matrices and its panels)
K3_PANELS_RUN = {"masked_kernel_matrix_batched": 0,
                 "masked_kernel_matrix_batched/spec": 0}


def count_k3_panels():
    """Wrap ops.linalg.masked_kernel_matrix, through which every K3 call
    of the port goes, to count its row panels (chol_append's) into
    K3_PANELS_RUN."""
    from gpry_tpu_torch.ops import linalg
    inner = linalg.masked_kernel_matrix

    def counted(family, *args, rows=None, **kwargs):
        if rows is not None and rows[1] > rows[0]:
            K3_PANELS_RUN["masked_kernel_matrix_batched"
                          + ("/spec" if is_spec(family) else "")] += 1
        return inner(family, *args, rows=rows, **kwargs)

    linalg.masked_kernel_matrix = counted


def count_believer_steps():
    """Wrap the BatchOptimizer's LogExp ascent, called once per believer
    step, to count its calls into BELIEVER."""
    from gpry_tpu_torch.acquisition import batch_optimizer
    inner = batch_optimizer._optimize_restarts

    def counted(*args, **kwargs):
        BELIEVER["steps"] += 1
        return inner(*args, **kwargs)

    batch_optimizer._optimize_restarts = counted


def chain_shards(mesh, nlive, kill_batch=None):
    """The shards an NS run splits each step's chains over: the mesh's
    size where it divides the kill batch (mc.nested.run_nested_device's
    rule), else 1 (K6 once per queued step)."""
    B = max(1, int(nlive) // 6) if kill_batch is None else int(kill_batch)
    if mesh is None or B % mesh.shape["data"]:
        return 1
    return mesh.shape["data"]


def time_ns_runs():
    """Wrap the nested sampler where the port calls it (the final MC and
    NORA) to count its runs, steps, segments (of NS_SEG queued steps) and
    host reads and sum its wall seconds (each run ends in host reads, so
    its wall time is its time) into NS_RUNS, with the most any run's reads
    exceeded ceil(steps / NS_SEG) + 2 by; and the MCMC where the port
    calls it into MCMC_RUNS."""
    from gpry_tpu_torch.acquisition import nora
    from gpry_tpu_torch.mc import samples
    inner = samples.run_nested_device
    inner_mcmc = samples.run_mcmc_device

    def timed(*args, **kwargs):
        t0 = time.perf_counter()
        res = inner(*args, **kwargs)
        sync()
        NS_RUNS["s"] += time.perf_counter() - t0
        NS_RUNS["runs"] += 1
        NS_RUNS["steps"] += res.n_steps
        NS_RUNS["segments"] += res.n_reads - 1
        NS_RUNS["reads"] += res.n_reads
        NS_RUNS["k6_launches"] += NS_SEG * (res.n_reads - 1) * chain_shards(
            kwargs.get("mesh"), kwargs.get("nlive", 200),
            kwargs.get("kill_batch"))
        over = res.n_reads - (-(-res.n_steps // NS_SEG) + 2)
        NS_RUNS["max_reads_over_bound"] = max(
            NS_RUNS["max_reads_over_bound"], over)
        return res

    def counted(*args, **kwargs):
        MCMC_RUNS["runs"] += 1
        return inner_mcmc(*args, **kwargs)

    samples.run_nested_device = timed
    nora.run_nested_device = timed
    samples.run_mcmc_device = counted


# the GP fits per path: fits and their wall seconds, polishes (calls of
# _fit_theta_restarts), LML screens and re-scores (calls of
# _lml_batch_chunked) and the K10 launches they made, and the calls of the
# torch L-BFGS and of cholesky_ex made inside a polish, screen or re-score
FITS = {"fits": 0, "fit_s": 0.0, "polishes": 0, "lml_calls": 0,
        "k10_in_lml": 0, "torch_lbfgs_in_fit": 0, "cholesky_ex_in_fit": 0}
_IN_FIT = {"depth": 0}
# the polishes of the path being driven: each call's arguments and K11's
# results, for replay_fits
POLISHES = []


def instrument_fits():
    """Wrap the GP fit and its parts to fill FITS."""
    import torch
    from gpry_tpu_torch.models import gp as gpm
    from gpry_tpu_torch.ops import fused, lbfgs
    k10 = ("lml_value_grad", "lml_value_grad/spec")

    def inside(fn):
        def wrapped(*args, **kwargs):
            _IN_FIT["depth"] += 1
            try:
                return fn(*args, **kwargs)
            finally:
                _IN_FIT["depth"] -= 1
        return wrapped

    fit = gpm.GaussianProcessRegressor.fit_gpr_hyperparameters

    def timed_fit(self, *args, **kwargs):
        t0 = time.perf_counter()
        try:
            return fit(self, *args, **kwargs)
        finally:
            sync()
            FITS["fit_s"] += time.perf_counter() - t0
            FITS["fits"] += 1

    polish = inside(gpm._fit_theta_restarts)

    def counted_polish(*args, **kwargs):
        FITS["polishes"] += 1
        out = polish(*args, **kwargs)
        POLISHES.append((args, kwargs, out))
        return out

    screen = inside(gpm._lml_batch_chunked)

    def counted_screen(*args, **kwargs):
        before = sum(fused.LAUNCHES[k] for k in k10)
        out = screen(*args, **kwargs)
        FITS["lml_calls"] += 1
        FITS["k10_in_lml"] += sum(fused.LAUNCHES[k] for k in k10) - before
        return out

    def watch(fn, key):
        def watched(*args, **kwargs):
            FITS[key] += _IN_FIT["depth"] > 0
            return fn(*args, **kwargs)
        return watched

    gpm.GaussianProcessRegressor.fit_gpr_hyperparameters = timed_fit
    gpm._fit_theta_restarts = counted_polish
    gpm._lml_batch_chunked = counted_screen
    lbfgs.minimize_lbfgs = watch(lbfgs.minimize_lbfgs, "torch_lbfgs_in_fit")
    torch.linalg.cholesky_ex = watch(torch.linalg.cholesky_ex,
                                     "cholesky_ex_in_fit")


def check_fits(name, launches, fits):
    """On a path that fits (FIT_PATHS): one K11 launch per polish, one K10
    launch per screen and re-score, no torch L-BFGS and no cholesky_ex
    inside them."""
    sfx = FIT_PATHS.get(name)
    if sfx is None:
        return
    k11 = launches["lbfgs_lml_fit" + sfx]
    log(f"[{name}] GP fits: {fits['fits']} in {fits['fit_s']:.3f} s; "
        f"{fits['polishes']} polishes ({k11} K11 launches), "
        f"{fits['lml_calls']} screens and re-scores ({fits['k10_in_lml']} K10"
        f" launches); inside them {fits['torch_lbfgs_in_fit']} torch L-BFGS "
        f"and {fits['cholesky_ex_in_fit']} cholesky_ex calls")
    if not (fits["polishes"] > 0 and k11 == fits["polishes"]):
        raise AssertionError(f"{name}: {k11} K11 launches for "
                             f"{fits['polishes']} fits that polish")
    if not (fits["lml_calls"] > 0
            and fits["k10_in_lml"] == fits["lml_calls"]):
        raise AssertionError(f"{name}: {fits['k10_in_lml']} K10 launches "
                             f"for {fits['lml_calls']} screens and re-scores")
    if fits["torch_lbfgs_in_fit"] or fits["cholesky_ex_in_fit"]:
        raise AssertionError(f"{name}: the fit ran the torch L-BFGS or "
                             "cholesky_ex on the card")


# replay_fits scores the two winners of a fast-family fit with n <= this
# by their LML in TRUE_LML_DIGITS-digit arithmetic (mpmath, which torch
# installs through sympy)
TRUE_LML_MAX_N, TRUE_LML_DIGITS = 128, 30


def true_nll(family, theta, X, y, n, noise, rel_jitter=0.0):
    """-LML of a fast family at ``theta`` in TRUE_LML_DIGITS digits (K
    built from the float64 inputs as masked_kernel_matrix_plain does), or
    None for a spec tree, n > TRUE_LML_MAX_N or no mpmath.  At the fit's
    box edges cond(K) reaches ~1e15, where a float64 LML is off by ~1e-2."""
    if is_spec(family) or n > TRUE_LML_MAX_N:
        return None
    try:
        import mpmath
    except ImportError:
        return None
    mp = mpmath.mp
    with mpmath.workdps(TRUE_LML_DIGITS):
        th = [mp.mpf(float(v)) for v in theta]
        var, ls = mp.exp(th[0]), [mp.exp(v) for v in th[1:]]
        Xs = [[mp.mpf(v) / ls[k] for k, v in enumerate(row)]
              for row in X[:n].tolist()]
        nz = (noise.expand(n) if noise.ndim == 0 else noise[:n]).tolist()

        def k_of(sq):
            if family == "rbf":
                return mp.exp(-sq / 2)
            r = mp.sqrt({"matern12": 1, "matern32": 3,
                         "matern52": 5}[family] * sq)
            return {"matern12": 1, "matern32": 1 + r,
                    "matern52": 1 + r + r * r / 3}[family] * mp.exp(-r)

        K = mp.matrix(n, n)
        for a in range(n):
            for b in range(a):
                K[a, b] = K[b, a] = var * k_of(
                    sum((u - v) ** 2 for u, v in zip(Xs[a], Xs[b])))
            K[a, a] = var + mp.mpf(nz[a]) + mp.mpf(float(rel_jitter)) * var
        L = mp.cholesky(K)
        z, quad = [], mp.mpf(0)
        for i, yi in enumerate(y[:n].tolist()):
            zi = (mp.mpf(yi) - sum(L[i, k] * z[k] for k in range(i))) / L[i, i]
            z.append(zi)
            quad += zi * zi
        lml = -quad / 2 - sum(mp.log(L[i, i]) for i in range(n)) \
            - n * mp.log(2 * mp.pi) / 2
        return -float(lml)


def replay_fits(name):
    """The path's polishes again through K11's plain version on the same
    inputs (it launches nothing).  Per fit, by each solver's own reported
    best -LML: K11's lower, higher, or the same within the larger of
    TOL_K11_END (1 + |f|) and the LML's rounding spread at the two winners
    (lml_spread); and, for a fast family with n <= TRUE_LML_MAX_N, by the
    true -LML of the two winners (true_nll): which solver found the better
    hyperparameters.  Printed, not gated: the lanes part at rounding level
    and may end in other basins, and where K is near singular each
    solver's reported f is low by its own rounding noise, so only the
    true values rank them; the kernel is held step for step by check_k11.
    """
    import torch
    from gpry_tpu_torch.ops import fused
    t0 = time.perf_counter()
    tally = {"fits": len(POLISHES), "kernel_lower": 0, "kernel_higher": 0,
             "same": 0, "max_rel_diff": 0.0, "true_scored": 0,
             "true_kernel_better": 0, "true_plain_better": 0, "true_tie": 0,
             "kernel_f_err": 0.0, "plain_f_err": 0.0}
    for args, kwargs, (th, f, _) in POLISHES:
        thr, fr, _ = fused.lbfgs_lml_fit_plain(*args, **kwargs)
        f = torch.where(torch.isnan(f), torch.inf, f)
        fr = torch.where(torch.isnan(fr), torch.inf, fr)
        best, best_r = float(f.min()), float(fr.min())
        if not (math.isfinite(best) and math.isfinite(best_r)):
            key = "same" if best == best_r else (
                "kernel_lower" if best < best_r else "kernel_higher")
            tally[key] += 1
            continue
        win, win_r = th[int(f.argmin())], thr[int(fr.argmin())]
        data = args[1:5]
        spread = max(lml_spread(args[0], win, *data),
                     lml_spread(args[0], win_r, *data))
        diff = best - best_r
        if abs(diff) <= max(TOL_K11_END * (1 + abs(best_r)), spread):
            tally["same"] += 1
        else:
            tally["kernel_lower" if diff < 0 else "kernel_higher"] += 1
        tally["max_rel_diff"] = max(tally["max_rel_diff"],
                                    abs(diff) / (1 + abs(best_r)))
        rj = kwargs.get("rel_jitter", 0.0)
        tk = true_nll(args[0], win.tolist(), *data, rj)
        tp = true_nll(args[0], win_r.tolist(), *data, rj)
        if tk is None or tp is None:
            continue
        tally["true_scored"] += 1
        tally["kernel_f_err"] = max(tally["kernel_f_err"], abs(best - tk))
        tally["plain_f_err"] = max(tally["plain_f_err"], abs(best_r - tp))
        if abs(tk - tp) <= TOL_K11_END * (1 + abs(tp)):
            tally["true_tie"] += 1
        else:
            tally["true_kernel_better" if tk < tp
                  else "true_plain_better"] += 1
    log(f"[{name}] the path's {tally['fits']} polishes replayed through the "
        f"plain version: by the reported f, K11's best lower on "
        f"{tally['kernel_lower']}, higher on {tally['kernel_higher']}, the "
        f"same within the rounding spread on {tally['same']} (max rel diff "
        f"{tally['max_rel_diff']:.3e}); by the {TRUE_LML_DIGITS}-digit LML "
        f"of the two winners on {tally['true_scored']} of them, K11's better "
        f"on {tally['true_kernel_better']}, the plain's on "
        f"{tally['true_plain_better']}, tied on {tally['true_tie']}; the "
        f"reported f of the winners off the 30-digit one by up to "
        f"{tally['kernel_f_err']:.3e} (K11) and {tally['plain_f_err']:.3e} "
        f"(plain) ({time.perf_counter() - t0:.1f} s)")
    return tally


def drive(name, fn, *args, **kwargs):
    """Run one path with the launch counts, the NS clock, the believer
    steps and the fit counts set to 0 just before it and read just after;
    fail if a kernel of the path was not launched, if K9 was not launched
    once per believer step (BELIEVER_PATHS), if the fits did not run on
    K10 and K11 alone (check_fits), or if K1 was launched more than 1% as
    often as when the nested sampler ran its chains through K1."""
    from gpry_tpu_torch.ops import fused
    import torch
    fused.reset_launch_counts()
    NS_RUNS.update(runs=0, steps=0, s=0.0, segments=0, reads=0,
                   max_reads_over_bound=-1, k6_launches=0)
    MCMC_RUNS.update(runs=0)
    BELIEVER.update(steps=0)
    K3_PANELS_RUN.update({k: 0 for k in K3_PANELS_RUN})
    FITS.update({k: 0 for k in FITS})
    POLISHES.clear()
    t0 = time.perf_counter()
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        t1 = time.perf_counter()
        out = fn(*args, **kwargs)
        sync()
        t2 = time.perf_counter()
    trace = device_split(prof, t2 - t1)
    if name in INSTANCE_PATHS:
        trace["instances"] = check_instance(name, prof)
    # the profiler's start and stop around the run (its cost inside the
    # run, CUPTI's record of each launch, is in wall_s)
    trace["profiler_start_stop_s"] = time.perf_counter() - t0 - (t2 - t1)
    launches = dict(fused.LAUNCHES)
    trace["k3_panels"] = dict(K3_PANELS_RUN)
    log(f"[{name}] K3 launches, whole matrices and panels: " + json.dumps(
        {k: (launches[k] - c, c) for k, c in K3_PANELS_RUN.items()}))
    # the trace may miss a launch at its ends: printed, not gated
    missed = {row: (sum(by_symbol.values()), launches[row])
              for row, by_symbol in trace["kernel_launches"].items()
              if sum(by_symbol.values()) != launches[row]}
    if missed:
        log(f"[{name}] launches in the trace and counted differ: {missed}")
    log(f"[{name}] device: " + json.dumps(
        {k: trace[k] for k in ("busy_ms", "wall_s", "busy_share",
                               "other_device_ms",
                               "profiler_start_stop_s")}))
    ns = dict(NS_RUNS, believer_steps=BELIEVER["steps"], fits=dict(FITS),
              mcmc_runs=MCMC_RUNS["runs"])
    log(f"[{name}] kernel launches: {launches}")
    log(f"[{name}] nested sampling: {ns['runs']} runs, {ns['steps']} steps "
        f"in {ns['segments']} segments, {ns['reads']} host reads, "
        f"{ns['s']:.3f} s; MCMC runs {ns['mcmc_runs']}; BatchOptimizer "
        f"believer steps {ns['believer_steps']}")
    for kernel in PATH_KERNELS[name]:
        if launches[kernel] <= 0:
            raise AssertionError(f"kernel {kernel} was not launched on the "
                                 f"{name} path")
    check_mc_launches(name, launches, ns)
    k9 = BELIEVER_PATHS.get(name)
    if k9 is not None and launches[k9] != ns["believer_steps"]:
        raise AssertionError(
            f"{name}: {launches[k9]} K9 launches for "
            f"{ns['believer_steps']} believer steps")
    check_fits(name, launches, ns["fits"])
    if name in FIT_PATHS and name not in NO_REPLAY:
        ns["fits"]["replay"] = replay_fits(name)
    POLISHES.clear()
    before = LOCKSTEP_K1_LAUNCHES.get(name)
    if before is not None and not launches["gated_mean"] < 0.01 * before:
        raise AssertionError(
            f"{name}: {launches['gated_mean']} K1 launches, not below 1% "
            f"of the {before} of the lock-step nested sampler")
    ns["device"] = trace
    return out, launches, ns


def check_instance(name, prof):
    """The launches of INSTANCE_PATHS[name]'s kernel in the path's trace,
    by instance (its template arguments); fails unless the trace holds
    some and every one is of the instance named there."""
    from torch.autograd import DeviceType
    row, tag = INSTANCE_PATHS[name]
    counts = {}
    for e in prof.events():
        if e.device_type != DeviceType.CUDA:
            continue
        hit = kernel_row(e.name)
        if hit is not None and hit[0].split("/")[0] == row:
            inst = e.name.split("(", 1)[0]
            counts[inst] = counts.get(inst, 0) + 1
    log(f"[{name}] {row} launches in the trace by instance: "
        + json.dumps(counts))
    if not counts or any(tag not in inst for inst in counts):
        raise AssertionError(f"{name}: the trace's {row} launches are not "
                             f"all of the instance '{tag}': {counts}")
    return counts


def check_mc_launches(name, launches, ns):
    """The Monte-Carlo runs of a path went through K12 and K13: two K12
    launches per MCMC run; per NS run K13 once per queued step (NS_SEG a
    segment) and once per segment end, K6 once per queued step and chain
    shard (chain_shards: 1 without a mesh), and at
    most ceil(steps / NS_SEG) + 2 host reads; and on the MCMC path K1 only
    for the start tries and the IS refine (2 launches)."""
    k12 = launches["mcmc_chains"] + launches["mcmc_chains/spec"]
    k6 = launches["ns_slice_chains"] + launches["ns_slice_chains/spec"]
    want = {"mcmc_chains": (k12, 2 * ns["mcmc_runs"]),
            "ns_step": (launches["ns_step"], (NS_SEG + 1) * ns["segments"]),
            "ns_slice_chains": (k6, ns["k6_launches"])}
    for kernel, (got, expected) in want.items():
        if got != expected:
            raise AssertionError(f"{name}: {got} {kernel} launches, "
                                 f"expected {expected}")
    if ns["runs"] and ns["max_reads_over_bound"] > 0:
        raise AssertionError(f"{name}: an NS run read the host "
                             f"{ns['max_reads_over_bound']} times more than "
                             "ceil(steps / seg) + 2")
    if name == "mcmc" and launches["gated_mean"] != 2:
        raise AssertionError(f"mcmc: {launches['gated_mean']} K1 launches, "
                             "expected 2 (the start tries and the refine)")


def warm_profiler():
    """One throwaway torch.profiler trace of one small kernel call, so
    that no path's trace pays the profiler's start-up; logs whether it
    held the launch."""
    import torch
    from gpry_tpu_torch.ops import fused
    t0 = time.perf_counter()
    f64 = dict(dtype=torch.float64, device="cuda")
    x, th = torch.zeros((8, D), **f64), torch.zeros((1, D + 1), **f64)
    ms = kernel_device_ms(lambda: fused.masked_kernel_matrix_batched(
        "rbf", th, x, 8, torch.ones((), **f64)), "masked_kernel_matrix", 1)
    fused.reset_launch_counts()
    log(f"[TRACE] the profiler's start-up: one trace in "
        f"{time.perf_counter() - t0:.2f} s; K3 device ms {fmt_ms(ms)}")


def drive_paths():
    """The fourteen paths in order, (a)-(l) with the device mesh disabled
    (their evals and equalities stay those of one card whatever the
    machine holds), then (m) on the mesh, then (n) with the mesh disabled;
    returns their summaries and launches."""
    from gpry_tpu_torch.parallel import mesh as mesh_mod
    warm_profiler()
    t0 = time.perf_counter()
    time_ns_runs()
    count_believer_steps()
    count_k3_panels()
    instrument_fits()
    paths, launches, ns = {}, {}, {}
    with mesh_mod.mesh_disabled():
        drive_single_card_paths(paths, launches, ns)
    paths["mesh"], launches["mesh"], ns["mesh"] = drive("mesh", run_mesh)
    with mesh_mod.mesh_disabled():
        paths["wide"], launches["wide"], ns["wide"] = drive("wide", run_wide)
    for name, stats in ns.items():
        paths[name]["device"] = stats.pop("device")
        paths[name]["believer_steps"] = stats.pop("believer_steps")
        paths[name]["gp_fits"] = stats.pop("fits")
        paths[name]["mcmc_runs"] = stats.pop("mcmc_runs")
        paths[name]["nested_sampling"] = stats
    log(f"[PATHS] all fourteen paths in {time.perf_counter() - t0:.1f} s")
    return paths, launches


def drive_single_card_paths(paths, launches, ns):
    """Paths (a)-(l) in order, into the dicts of drive_paths."""
    paths["batchoptimizer"], launches["batchoptimizer"], \
        ns["batchoptimizer"] = drive("batchoptimizer", run_default_with_cov)
    paths["nora_bench"], launches["nora_bench"], ns["nora_bench"] = drive(
        "nora_bench", run_bench, "nora")
    (runner, ns_sample, paths["nora_runner"]), launches["nora_runner"], \
        ns["nora_runner"] = drive("nora_runner", run_runner, "NORA",
                                  resample=False, gp_acquisition="NORA",
                                  options={"audit": False})
    paths["mcmc"], launches["mcmc"], ns["mcmc"] = drive(
        "mcmc", run_mcmc, runner, ns_sample)
    paths["himmelblau_audit"], launches["himmelblau_audit"], \
        ns["himmelblau_audit"] = drive("himmelblau_audit",
                                       run_himmelblau_audit)
    (runner, paths["spec_runner"]), launches["spec_runner"], \
        ns["spec_runner"] = drive("spec_runner", run_spec_runner)
    paths["spec_cov_nora"], launches["spec_cov_nora"], \
        ns["spec_cov_nora"] = drive("spec_cov_nora", run_spec_cov_nora,
                                    runner)
    paths["bo_bench"], launches["bo_bench"], ns["bo_bench"] = drive(
        "bo_bench", run_bench, "batchoptimizer")
    paths["resumed_runner"], launches["resumed_runner"], \
        ns["resumed_runner"] = drive("resumed_runner", run_resumed)
    paths["polish"], launches["polish"], ns["polish"] = drive(
        "polish", run_polish)
    polish_per_call(paths["polish"], launches["polish"],
                    ns["polish"]["device"])
    paths["mpi_runner"], launches["mpi_runner"], ns["mpi_runner"] = drive(
        "mpi_runner", run_mpi_runner)
    paths["periphery"], launches["periphery"], ns["periphery"] = drive(
        "periphery", run_periphery)
    cobaya_per_call(paths["periphery"], ns["periphery"]["device"])


def polish_per_call(summary, launches, trace):
    """Path j's cost of one polish call: its wall time (the polish's
    seconds over its calls), K2's device time a launch in the path's trace
    (the mean over all its K2 launches there, the screens' and the lies'
    included) and the rest, the host's; fails if K9 was launched (the
    polish replaces the ascent) or if the trace's K2 launches are more
    than the wrapper's count or fewer than 99% of it (an empty trace among
    them)."""
    if launches["lbfgs_logexp_ascent"]:
        raise AssertionError("polish: K9 was launched")
    wall_us = 1e6 * summary["polish_s"] / summary["calls"]
    k2_ms = None if trace["kernel_ms"] is None else \
        trace["kernel_ms"].get("gated_meanvar_logexp")
    k2_traced = sum(trace["kernel_launches"].get(
        "gated_meanvar_logexp", {}).values())
    # CUPTI now and then drops a record (one of 10,209 K2 launches here
    # once, 15 of 936 on path e): the trace may miss up to 1% of the
    # counted launches, never hold one that was not counted
    counted = summary["k2_launches"]
    if not counted - 0.01 * counted <= k2_traced <= counted:
        raise AssertionError(
            f"polish: the trace holds {k2_traced} K2 launches, the wrapper "
            f"counted {counted}")
    device_us = None if not (k2_ms and k2_traced) else \
        1e3 * k2_ms / k2_traced
    summary["per_call"] = {
        "wall_us": wall_us, "k2_device_us": device_us,
        "host_us": None if device_us is None else wall_us - device_us,
        "k2_launches_traced": k2_traced}
    log("[POLISH] a call: " + json.dumps(summary["per_call"]))


def cobaya_per_call(summary, trace):
    """Path l's cost of one Cobaya likelihood call: its wall time, and K2's
    device time a launch in the path's trace (the mean over all its K2
    launches there: the calls', the one batched predict's and the plots'
    where they rendered) and its share of the wall."""
    k2_ms = None if trace["kernel_ms"] is None else \
        trace["kernel_ms"].get("gated_meanvar_logexp")
    k2_traced = sum(trace["kernel_launches"].get(
        "gated_meanvar_logexp", {}).values())
    device_us = None if not (k2_ms and k2_traced) else \
        1e3 * k2_ms / k2_traced
    summary["per_call"] = {
        "wall_us": summary["call_us"], "k2_device_us": device_us,
        "device_share": None if device_us is None
        else device_us / summary["call_us"],
        "k2_launches_traced": k2_traced}
    log("[PERIPHERY] a call: " + json.dumps(summary["per_call"]))


def rank_of(name, row, paths):
    """A kernel's device time on the paths (their torch.profiler traces):
    ms by path and in all (paths_device_ms; a row's device_ms is one
    call's, at its timed shape), the launches the traces hold (by symbol:
    K4's sweep and select, K7's two kernels apart), and rank_s, the seconds
    above the bound: the device time less the launches times the bound of
    one launch at the paths' shapes (K3: one theta row, row["r1"], for a
    whole matrix, a panel of one row for a panel, the panels counted
    apart, K3_PANELS_RUN; K4: a fill's
    bound over its 2 SIZE - 1 launches; K7: a call's over its two; the
    others: the kernel row's bound, at its timed shape).  A path
    whose trace held no device activity gives null for its device ms, and
    then for the sum and rank_s."""
    by_path = {p: None if v["device"]["kernel_ms"] is None
               else v["device"]["kernel_ms"].get(name, 0.0)
               for p, v in paths.items()}
    by_symbol = {}
    for v in paths.values():
        for sym, c in v["device"]["kernel_launches"].get(name, {}).items():
            by_symbol[sym] = by_symbol.get(sym, 0) + c
    per_launch = row.get("path_bound_ms", row["bound_ms"])
    if name.startswith("kriging_believer_fill"):
        per_launch = row["bound_ms"] / (2 * SIZE - 1)
    if name.startswith("predict_meancov") or name == "tp_quad":
        per_launch = row["bound_ms"] / 2
    panels = sum(v["device"]["k3_panels"].get(name, 0)
                 for v in paths.values())
    bound_s = 1e-3 * (per_launch * (sum(by_symbol.values()) - panels)
                      + row.get("panel_bound_ms", 0.0) * panels)
    out = {"device_ms_by_path": by_path, "paths_device_ms": None,
           "device_launches": by_symbol, "launch_bound_ms": per_launch,
           "rank_s": None}
    if name.startswith("masked_kernel_matrix_batched"):
        out["panel_launches"] = panels
    if None not in by_path.values():
        total = sum(by_path.values())
        out.update(paths_device_ms=total, rank_s=1e-3 * total - bound_s)
    return out


def main():
    if not os.path.isdir(os.path.join(HERE, "gpry_tpu_torch")):
        print("chip_smoke.py must run from a checkout of the repository "
              "(gpry_tpu_torch/ not found beside it).", file=sys.stderr)
        return 2
    sys.path.insert(0, HERE)
    sys.path.insert(0, os.path.join(HERE, "tests"))
    import torch
    if not torch.cuda.is_available():
        print("torch.cuda.is_available() is false: this smoke test needs "
              "a CUDA card.", file=sys.stderr)
        return 3
    from gpry_tpu_torch import config
    from gpry_tpu_torch.ops import fused
    dev = config.set_device("cuda")
    card = card_line()
    log(f"[CARD] {card}")
    log(f"[ENV] torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"{torch.cuda.get_device_name(0)}")
    t0 = time.perf_counter()
    fused.library()
    log(f"[BUILD] kernels built and loaded in "
        f"{time.perf_counter() - t0:.2f} s (nvcc "
        f"{fused.BUILD_SECONDS if fused.BUILD_SECONDS is not None else 0:.2f}"
        " s)")

    # the paths first, each under a torch.profiler trace of its own, while
    # the profiler has traced nothing else in this process
    paths, launches = drive_paths()
    t0 = time.perf_counter()
    rows = check_kernels(dev)
    log(f"[CHECKS] all kernel checks in {time.perf_counter() - t0:.1f} s")
    fit_phase = run_fit_phase(dev)
    kernels = []
    for base, (src, replaces) in SOURCES.items():
        for name in (base,) if base in fused.NO_SPEC else \
                (base, base + "/spec"):
            # library_ms: no single PyTorch call computes any of K1-K13
            # or K14's tp_cross_mean (PERF.md, section 6, says why for
            # each); tp_quad's row carries torch.einsum's time
            row = {"name": name, "route": "cuda", "source": src,
                   "replaces": replaces,
                   "launches": sum(c[name] for c in launches.values()),
                   "launches_by_path": {k: c[name]
                                        for k, c in launches.items()},
                   "library_ms": None}
            row.update(rows[name])
            row.update(rank_of(name, row, paths))
            kernels.append(row)
    empty = [p for p, v in paths.items() if v["device"]["trace_empty"]]
    if empty:
        log("[RANK] not ranked: the traces of " + ", ".join(empty) +
            " held no device activity")
    else:
        ranking = sorted(((r["rank_s"], r["name"]) for r in kernels),
                         reverse=True)
        log("[RANK] launches x (time - bound) on the paths, s: " +
            ", ".join(f"{n} {v:.4f}" for v, n in ranking))
    assert "jax" not in sys.modules
    assert not any(m == "gpry_tpu" or m.startswith("gpry_tpu.")
                   for m in sys.modules)
    print(json.dumps({"kernels": kernels, "paths": paths,
                      "fit_phase": fit_phase}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
