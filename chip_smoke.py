#!/usr/bin/env python3
"""
Drive gpry_tpu_torch once on one CUDA card.

1. Build the seven CUDA kernels (K1 gated_mean, K2 gated_meanvar_logexp,
   K3 masked_kernel_matrix_batched, K4 kriging_believer_fill, K5
   meanvar_ungated, K6 ns_slice_chains, K7 predict_meancov) from
   ``gpry_tpu_torch/csrc``, one nvcc per source, all at once.
2. Hold each kernel against its plain PyTorch version on the card at the
   shapes of the main paths (d = 8, n = 224 valid rows in a bucket of
   nmax = 320; K1 at nq = 16, 66, 2,000, 16,384 and 65,536 in both of
   its designs, K2 at nq = 3,200, K3 at R = 2,048, K4 at N = 4,096 candidates
   and a pool of 8, K5 at the audit screen's nq = 4,096, K6 at the NS's
   B = 66 and 33 chains of 40 repeats, K7 at nq = 1, 64 and 1,024; K1 and
   K6 with the SVM fitted and all finite), for the four fast families and,
   in each kernel's spec mode, for a composite kernel with every node kind
   (ALL_NODES); time both with CUDA events (K1 and K6 also by their
   kernel's own duration in a ``torch.profiler`` trace), and compute each
   kernel's bound: the larger of its FP64 operations over the H100 SXM's
   FP64 peak and its bytes over 3.35 TB/s.  K1's and K6's operations count
   only the sums their inputs need: the SVM decision of a point inside the
   trust box (and K6's prior box), the GP mean only where that decision
   is finite, over the points K6's chains must evaluate.
3. Drive seven paths, each with the launch counts set to 0 just before it
   and read just after, and check that each launched its kernels, that
   K1's launches on paths a, b, c and e are below 1% of what the
   lock-step nested sampler made there (LOCKSTEP_K1_LAUNCHES), and print
   the seconds each path spent in nested sampling:
   a. the default entry point: ``Runner(loglike, bounds).run()`` (the
      BatchOptimizer loop with the convergence audit) then
      ``generate_mc_sample()`` on the 8-dimensional correlated Gaussian
      of ``tests/model_generator.py`` (converged, KL(sample || truth)
      <= 0.05), then ``predict(X, return_cov=True)`` at 1,024 prior
      draws (K7; its diagonal against ``return_std``);
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
      draws (its diagonal against ``return_std``), then one NORA
      ``multi_add(n_points=8)`` (K7 and K4 in spec mode).

Prints the card's ``nvidia-smi`` name and power limit, a JSON line with the
kernel results (spec-mode rows named "<kernel>/spec"), and as the last line
the contract line ``{"ok": true, "device": {...}}``.  Any failure raises
(exit code != 0) before a result is printed.

    python3 chip_smoke.py
"""

import json
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
# K5: the mean within rel TOL_K5; sigma within TOL_K5_SIGMA sqrt(sigma^2)
# y_scale absolute (sigma^2 - |v|^2 cancels to ~0 at a training point)
TOL_K5, TOL_K5_SIGMA = 1e-10, 1e-7
# K5 at the audit screen
NQ_SCREEN = 4096
# the JAX package's truth evals to convergence on path e's run
# (benchmarks/results_nongaussian.json, Himmelblau seed 100)
JAX_HIMMELBLAU_EVALS = 61
# path f's kernel: C() * RBF(ARD) + WhiteKernel, and the JAX package's
# truth evals to convergence on path f's run (gpry_tpu on the CPU,
# random_gaussian(d=8, rng=18), seed 1)
SPEC_F = {"Sum": [
    {"Product": [{"ConstantKernel": {"constant_value_bounds": [1e-4, 1e6]}},
                 {"RBF": {"length_scale_bounds": [1e-3, 10.0]}}]},
    {"WhiteKernel": {"noise_level": 1e-4,
                     "noise_level_bounds": [1e-8, 0.1]}}]}
JAX_SPEC_EVALS = 76
# the spec-mode kernel checks' composite kernel: every node kind
ALL_NODES = {"Sum": [
    {"Product": [{"ConstantKernel": {"constant_value": 1.3}},
                 {"Exponentiation": {"kernel": {"Matern": {
                     "nu": 2.5, "length_scale": [0.6] * D}},
                     "exponent": 2.0}}]},
    {"Sum": [{"Product": [{"ConstantKernel": {"constant_value": 0.5}},
                          {"RationalQuadratic": {"alpha": 1.5,
                                                 "length_scale": 0.7}}]},
             {"Sum": [{"ExpSineSquared": {"length_scale": 1.0,
                                          "periodicity": 3.0}},
                      {"Sum": [{"DotProduct": {"sigma_0": 0.3}},
                               {"WhiteKernel": {"noise_level": 1e-3}}]}]}]}]}
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
}
# K6 at the NS steps of the main paths: nlive 400 (final NS) and 200
# (NORA), num_repeats 40
K6_B, K6_R = (66, 33), 40
# K1's launches on paths a, b, c and e when every slice step was a K1
# call (the chip run of the commit before K6; PERF.md, section 6)
LOCKSTEP_K1_LAUNCHES = {"batchoptimizer": 284164, "nora_bench": 199803,
                        "nora_runner": 720768, "himmelblau_audit": 271227}
# the kernels each path must launch
PATH_KERNELS = {
    "batchoptimizer": ("gated_mean", "gated_meanvar_logexp",
                       "masked_kernel_matrix_batched", "meanvar_ungated",
                       "ns_slice_chains", "predict_meancov"),
    "nora_bench": ("gated_mean", "gated_meanvar_logexp",
                   "masked_kernel_matrix_batched", "kriging_believer_fill",
                   "ns_slice_chains"),
    "nora_runner": ("gated_mean", "gated_meanvar_logexp",
                    "masked_kernel_matrix_batched", "kriging_believer_fill",
                    "ns_slice_chains"),
    "mcmc": ("gated_mean",),
    "himmelblau_audit": ("gated_mean", "gated_meanvar_logexp",
                         "masked_kernel_matrix_batched",
                         "kriging_believer_fill", "meanvar_ungated",
                         "ns_slice_chains"),
    "spec_runner": ("gated_mean/spec", "gated_meanvar_logexp/spec",
                    "masked_kernel_matrix_batched/spec",
                    "meanvar_ungated/spec", "ns_slice_chains/spec"),
    "spec_cov_nora": ("predict_meancov/spec", "kriging_believer_fill/spec"),
}


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
    ``name`` in a ``torch.profiler`` trace of ``reps`` calls of ``fn``
    (after one warm-up call; over the launches the trace holds, which may
    miss one): the kernel's own time on the card, without the host's
    launch."""
    import torch
    from torch.autograd import DeviceType
    fn()
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    durs = [e.time_range.elapsed_us() for e in prof.events()
            if e.device_type == DeviceType.CUDA and name in e.name]
    if not durs:
        raise AssertionError(f"the profiler saw no launch of {name}")
    return 1e-3 * sum(durs) / len(durs)


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


def spec_kernel():
    """(spec, theta0) of ALL_NODES at D dimensions (the port's own
    build_kernel_spec)."""
    from gpry_tpu_torch.ops.kernels import build_kernel_spec
    spec, theta0, _ = build_kernel_spec(ALL_NODES, D)
    return spec, theta0


def is_spec(family):
    return isinstance(family, tuple)


def pair_flops(family):
    """FP64 operations of one kernel value k(x, x') at D dimensions and its
    multiply-add into a sum: per stationary ARD leaf r^2 over d and one
    exponential, per dot product d multiply-adds, per operator one (the
    fast families: 3 D + 3, as PR 4 counted them)."""
    if not is_spec(family):
        return 3 * D + 3
    from gpry_tpu_torch.ops import fused
    ops, _, _, _ = fused.encode_spec(family, D)
    names = {v: k for k, v in fused.SPEC_OPS.items()}
    cost = {"rq": 3 * D + 5, "expsine": 3 * D + 6, "dotproduct": 2 * D + 2,
            "white": 0, "constant": 0, "sum": 1, "product": 1, "pow": 1}
    return sum(cost.get(names[o], 3 * D + 3) for o in ops)


def synthetic_surrogate(family, dev, seed, svm="fitted"):
    """A surrogate snapshot at the main-path shapes with every gate active:
    a fitted SVM, a trust box inside the prior and an upper clip.  With
    ``svm="all_finite"`` the SVM is the placeholder of a run that has seen
    no -inf (the Gaussian paths' mode: no support vector is summed).
    ``family`` is a fast family or the ALL_NODES spec tree."""
    import numpy as np
    import torch
    from gpry_tpu_torch.models.classifier import MODE_ALL_FINITE, \
        MODE_FITTED, SVMParams, trivial_svm_params
    from gpry_tpu_torch.models.gp import SurrogateParams
    from gpry_tpu_torch.ops.linalg import factorize
    rng = np.random.default_rng(seed)
    t = lambda a: torch.as_tensor(np.asarray(a, float), dtype=torch.float64,
                                  device=dev)
    Xv = rng.uniform(0, 1, (N, D))
    yv = -0.5 * np.sum(((Xv - 0.5) / 0.3) ** 2, axis=1)
    yv = (yv - yv.mean()) / yv.std()
    Xp, yp = np.zeros((NMAX, D)), np.zeros(NMAX)
    Xp[:N], yp[:N] = Xv, yv
    if is_spec(family):
        theta0 = np.asarray(spec_kernel()[1])
        theta = theta0 + rng.uniform(-0.2, 0.2, len(theta0))
    else:
        theta = np.concatenate([[np.log(2.0)],
                                np.log(rng.uniform(0.4, 0.9, D))])
    noise = t(1e-4)
    L, alpha = factorize(family, t(theta), t(Xp), t(yp), N, noise)
    if bool(torch.isnan(L).any()):
        raise AssertionError("synthetic factorization is not PD")
    sv = rng.uniform(0, 1, (NSV, D))
    dual = rng.normal(size=NSV)
    gamma = 2.0
    Xq = rng.uniform(0, 1, (4096, D))
    dec = np.exp(-gamma * ((Xq[:, None] - sv[None]) ** 2).sum(-1)) @ dual
    fitted = SVMParams(mode=MODE_FITTED, sv=t(sv), dual=t(dual),
                       intercept=t(-np.median(dec)), gamma=t(gamma))
    p = SurrogateParams(
        theta=t(theta), X=t(Xp), y=t(yp), n=N, noise_var=noise, L=L,
        alpha=alpha, x_loc=t(np.full(D, -5.0)), x_scale=t(np.full(D, 10.0)),
        y_loc=t(-3.0), y_scale=t(2.5), y_max=t(0.0), clip_max=t(np.inf),
        svm=fitted, trust_lo=t(np.full(D, -4.5)), trust_hi=t(np.full(D, 4.5)))
    # an upper clip below the largest mean, so that it binds somewhere
    from gpry_tpu_torch.ops.fused import gated_mean_plain
    m = gated_mean_plain(family, p, t(rng.uniform(-5, 5, (4096, D))))
    clip = torch.quantile(m[torch.isfinite(m)], 0.9)
    p = p.replace(clip_max=clip.to(torch.float64))
    if svm == "all_finite":
        p = p.replace(svm=trivial_svm_params(D, NSV, torch.float64, dev,
                                             MODE_ALL_FINITE))
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


def sum_flops(n_svm, n_gp, family="rbf"):
    """FP64 operations of those sums: per (point, support vector) r^2 over
    d, one exponential, one multiply-add; per (point, training row) the
    kernel value and its multiply-add (pair_flops)."""
    return n_svm * NSV * (3 * D + 3) + n_gp * N * pair_flops(family)


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


def check_k5(dev, rng, families, timed):
    """K5 against its plain version at the audit screen (nq = NQ_SCREEN,
    the first 64 queries on training points)."""
    import torch
    from gpry_tpu_torch.ops import fused
    from gpry_tpu_torch.ops.kernels import kernel_diag
    worst = 0.0
    row = {}
    for fam in families:
        label = "spec" if is_spec(fam) else fam
        p = synthetic_surrogate(fam, dev, seed=14)
        Xq = torch.as_tensor(rng.uniform(-5, 5, (NQ_SCREEN, D)),
                             dtype=torch.float64, device=dev)
        Xq[:64] = p.X[:64] * p.x_scale + p.x_loc
        ma, sa = fused.meanvar_ungated(fam, p, Xq)
        mb, sb = fused.meanvar_ungated_plain(fam, p, Xq)
        torch.cuda.synchronize()
        err_m, rel_m = rel_err(ma, mb)
        err_s = float(torch.max(torch.abs(sa - sb)))
        prior = kernel_diag(fam, p.theta, (Xq - p.x_loc) / p.x_scale)
        tol_s = TOL_K5_SIGMA * float(torch.sqrt(prior.max()) * p.y_scale)
        log(f"[K5] {label:8s} nq={NQ_SCREEN}: mean max abs err {err_m:.3e} "
            f"rel {rel_m:.3e}; std max abs err {err_s:.3e} (tol "
            f"{tol_s:.3e})")
        if not (rel_m <= TOL_K5 and err_s <= tol_s):
            raise AssertionError(f"K5 {label}: mean rel {rel_m} > {TOL_K5} "
                                 f"or std abs {err_s} > {tol_s}")
        worst = max(worst, err_m, err_s)
        if fam == timed:
            ms = time_ms(lambda: fused.meanvar_ungated(fam, p, Xq), 50)
            plain = time_ms(lambda: fused.meanvar_ungated_plain(fam, p, Xq),
                            50)
            log(f"[K5] {label} nq={NQ_SCREEN}: kernel {ms:.4f} ms, plain "
                f"{plain:.4f} ms")
            row = {"ms": ms, "plain_ms": plain}
    row["max_abs_err"] = worst
    row["shape"] = f"nq={NQ_SCREEN} n={N} nmax={NMAX} d={D}"
    # per query: the k vector, the length-n forward substitution (n^2 / 2
    # multiply-adds), the mean and the sum of squares; bytes: the queries,
    # the training rows, alpha, the valid triangle of L, two outputs
    nq = NQ_SCREEN
    row.update(bound(nq * (N * pair_flops(timed) + N * N + 4 * N),
                     8 * (nq * D + 2 * nq + N * D + N + N * (N + 1) // 2
                          + 4 * D)))
    return row


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


def k6_evaluated_points(family, p, args):
    """The points K6's chains must evaluate on these inputs, by a replay
    of the plain lock-step loop (which evaluates every chain at every
    step): both first step-out ends, an end again only when its doubling
    moved it, a shrink only until its chain accepted."""
    import torch
    from gpry_tpu_torch.ops import fused
    x0, lx0, lstar, chol, nrm, u, lo, hi = args
    B = x0.shape[0]
    seen, state = [], {"ends": None, "acc": None}

    def logl_of(X):
        in_box = torch.all((X >= lo) & (X <= hi), dim=-1)
        out = torch.where(in_box, fused.gated_mean_plain(family, p, X),
                          torch.full_like(X[:, 0], -torch.inf))
        if len(X) == 2 * B:
            need = torch.ones(2 * B, dtype=torch.bool, device=X.device) \
                if state["ends"] is None else \
                torch.any(X != state["ends"], dim=1)
            state.update(ends=X, acc=None)
        else:
            if state["acc"] is None:
                state.update(ends=None, acc=torch.zeros(
                    B, dtype=torch.bool, device=X.device))
            need = ~state["acc"]
            state["acc"] = state["acc"] | (out > lstar)
        seen.append(X[need])
        return out

    fused.slice_chains_lockstep(logl_of, x0, lx0, lstar, chol, nrm, u)
    return torch.cat(seen)


def check_k6(dev, families, timed, configs):
    """K6 against its plain version (the lock-step loop on plain K1) on the
    same draws for each (svm, B) of ``configs``: identical calls and -inf
    masks, x and lx within rel TOL_K6.  ``timed`` is timed at B = 66 with
    the SVM fitted (and all finite); the bound counts the sums of the
    points its chains must evaluate (k6_evaluated_points, needed_sums)."""
    import torch
    from gpry_tpu_torch.ops import fused
    worst = 0.0
    row = {"shapes": {}}
    for fam in families:
        label = "spec" if is_spec(fam) else fam
        for svm, B in configs:
            p, args = k6_inputs(fam, dev, B, seed=B, svm=svm)
            x, lx, calls = fused.ns_slice_chains(fam, p, *args)
            sync()
            t0 = time.perf_counter()
            xr, lxr, callsr = fused.ns_slice_chains_plain(fam, p, *args)
            sync()
            plain = 1e3 * (time.perf_counter() - t0)
            if not torch.equal(calls, callsr):
                raise AssertionError(f"K6 {label} {svm} B={B}: calls "
                                     "differ")
            err_l, rel_l = rel_err(lx, lxr)
            err_x, rel_x = rel_err(x.reshape(-1), xr.reshape(-1))
            log(f"[K6] {label:8s} svm {svm:10s} B={B} R={K6_R}: same calls "
                f"({int(calls.sum())} in all); lx max abs err "
                f"{err_l:.3e} rel {rel_l:.3e}; x rel {rel_x:.3e}")
            if not (rel_l <= TOL_K6 and rel_x <= TOL_K6):
                raise AssertionError(f"K6 {label} {svm} B={B}: rel "
                                     f"{rel_l}, {rel_x} > {TOL_K6}")
            worst = max(worst, err_l, err_x)
            if fam != timed or (svm == "all_finite" and B != 66):
                continue
            call = lambda: fused.ns_slice_chains(fam, p, *args)
            ms = time_ms(call, 20)
            dev_ms = kernel_device_ms(call, "ns_slice_chains", 10)
            pts = k6_evaluated_points(fam, p, args)
            n_svm, n_gp = needed_sums(p, pts, args[6], args[7])
            nbytes = 8 * (2 * B * D + 2 * B + K6_R * B * (D + 31) + N * D
                          + N + NSV * (D + 1) + D * D + 2 * D) + 8 * B
            shape = {"ms": ms, "device_ms": dev_ms, "plain_ms": plain,
                     "calls": int(calls.sum()), "evaluations": len(pts),
                     "svm_sums": n_svm, "gp_sums": n_gp,
                     **bound(sum_flops(n_svm, n_gp, fam), nbytes)}
            row["shapes"][f"B={B} svm={svm}"] = shape
            log(f"[K6] {label} svm {svm} B={B} R={K6_R}: kernel {ms:.4f} ms "
                f"back to back, {dev_ms:.4f} ms on the card; plain "
                f"{plain:.1f} ms; {shape['calls']} calls, {len(pts)} "
                f"evaluations, {n_svm} SVM and {n_gp} GP sums needed; "
                f"bound {shape['bound_ms']:.6f} ms")
    row.update({k: v for k, v in row["shapes"]["B=66 svm=fitted"].items()
                if k in ("ms", "device_ms", "plain_ms", "bound_ms",
                         "bound_by", "flops", "bytes")})
    row["max_abs_err"] = worst
    row["shape"] = f"B=66 R={K6_R} n={N} nmax={NMAX} d={D} svm=fitted"
    return row


def check_k1(dev, rng, families, timed, sizes):
    """K1 at the batch sizes of the main paths in both designs (block per
    query, tiled) with the SVM fitted and all finite; ``timed`` (SVM
    fitted) timed in the wrapper's own choice and each design."""
    import torch
    from gpry_tpu_torch.ops import fused
    worst = 0.0
    shapes = {}
    for fam in families:
        label = "spec" if is_spec(fam) else fam
        for svm in ("fitted", "all_finite"):
            p = synthetic_surrogate(fam, dev, seed=11, svm=svm)
            is_timed = fam == timed and svm == "fitted"
            for nq in sizes:
                Xq = torch.as_tensor(rng.uniform(-5, 5, (nq, D)),
                                     dtype=torch.float64, device=dev)
                b = fused.gated_mean_plain(fam, p, Xq)
                shape = {}
                for design in ("block", "tiled"):
                    a = fused.gated_mean(fam, p, Xq, _design=design)
                    torch.cuda.synchronize()
                    err, rel = rel_err(a, b)
                    log(f"[K1] {label:8s} svm {svm:10s} nq={nq:6d} "
                        f"{design}: max abs err {err:.3e}, rel {rel:.3e}, "
                        f"finite {int(torch.isfinite(b).sum())}")
                    if not rel <= TOL_K1:
                        raise AssertionError(f"K1 {label} {svm} nq={nq} "
                                             f"{design}: rel {rel} > {TOL_K1}")
                    worst = max(worst, err)
                    if is_timed:
                        reps = 20 if nq == 65536 else 200
                        call = lambda: fused.gated_mean(fam, p, Xq,
                                                        _design=design)
                        shape[f"ms_{design}"] = time_ms(call, reps)
                        shape[f"device_ms_{design}"] = kernel_device_ms(
                            call, "gated_mean", 20)
                if not is_timed:
                    continue
                reps = 20 if nq == 65536 else 200
                shape["ms"] = time_ms(lambda: fused.gated_mean(fam, p, Xq),
                                      reps)
                shape["plain_ms"] = time_ms(
                    lambda: fused.gated_mean_plain(fam, p, Xq),
                    reps if not is_spec(fam) else 5)
                n_svm, n_gp = needed_sums(p, Xq)
                shape.update({"svm_sums": n_svm, "gp_sums": n_gp})
                shape.update(bound(
                    sum_flops(n_svm, n_gp, fam),
                    8 * (nq * D + nq + N * D + N + NSV * (D + 1) + 4 * D)))
                shapes[f"nq={nq}"] = shape
                log(f"[K1] {label} nq={nq}: " + json.dumps(shape))
    top = shapes["nq=65536"]
    return {"max_abs_err": worst, "shapes": shapes,
            "shape": f"nq=65536 n={N} nmax={NMAX} d={D}",
            **{k: top[k] for k in ("ms", "plain_ms", "bound_ms", "bound_by",
                                   "flops", "bytes")}}


def check_k2(dev, rng, families, timed):
    """K2 at the acquisition screen, in both output modes."""
    import torch
    from gpry_tpu_torch.ops import fused
    worst = 0.0
    nq = 3200
    row = {}
    for fam in families:
        label = "spec" if is_spec(fam) else fam
        p = synthetic_surrogate(fam, dev, seed=12)
        Xq = torch.as_tensor(rng.uniform(-5, 5, (nq, D)),
                             dtype=torch.float64, device=dev)
        ma, sa = fused.gated_meanvar_logexp(fam, p, Xq)
        mb, sb = fused.gated_meanvar_logexp_plain(fam, p, Xq)
        lexp = (D ** -0.85, 0.01)
        la = fused.gated_meanvar_logexp(fam, p, Xq, logexp=lexp)
        lb = fused.gated_meanvar_logexp_plain(fam, p, Xq, logexp=lexp)
        torch.cuda.synchronize()
        for what, a, b in (("mean", ma, mb), ("std", sa, sb),
                           ("logexp", la, lb)):
            err, rel = rel_err(a, b)
            log(f"[K2] {label:8s} {what:6s}: max abs err {err:.3e}, "
                f"rel {rel:.3e}")
            if not rel <= TOL_K2:
                raise AssertionError(f"K2 {label} {what}: rel {rel} > "
                                     f"{TOL_K2}")
            worst = max(worst, err)
        if fam == timed:
            ms = time_ms(lambda: fused.gated_meanvar_logexp(
                fam, p, Xq, logexp=lexp), 50)
            plain = time_ms(lambda: fused.gated_meanvar_logexp_plain(
                fam, p, Xq, logexp=lexp), 50)
            log(f"[K2] {label} nq={nq}: kernel {ms:.4f} ms, plain "
                f"{plain:.4f} ms")
            row = {"ms": ms, "plain_ms": plain}
    row["max_abs_err"] = worst
    row["shape"] = f"nq={nq} n={N} nmax={NMAX} d={D}"
    # per query: the k vector and the SVM sum, the length-n forward
    # substitution (n^2 / 2 multiply-adds), the mean and sum of squares
    row.update(bound(
        nq * (N * pair_flops(timed) + NSV * (3 * D + 3) + N * N + 4 * N),
        8 * (nq * D + nq + N * D + N + N * (N + 1) // 2 + NSV * (D + 1)
             + 4 * D)))
    return row


def check_k3(dev, rng, families, timed):
    """K3 at the fit's LML screen (R = 2048 thetas, one theta row per
    matrix), scalar and vector noise."""
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
            del a, b
            if fam == timed and noise.ndim == 0:
                ms = time_ms(lambda: fused.masked_kernel_matrix_batched(
                    fam, thetas, X, N, noise), 10)
                plain = plain_once if is_spec(fam) else time_ms(
                    lambda: k3_plain(fam, thetas, noise), 3)
                log(f"[K3] {label} R={R}: kernel {ms:.4f} ms, plain "
                    f"{plain:.4f} ms")
                row = {"ms": ms, "plain_ms": plain}
    row.update({"max_abs_err": worst,
                "shape": f"R={R} n={N} nmax={NMAX} d={D}"})
    # every valid entry of every theta's K; the whole padded matrix written
    row.update(bound(R * N * N * pair_flops(timed),
                     8 * (R * (D + 1) + N * D + R * NMAX * NMAX)))
    torch.cuda.empty_cache()
    return row


def check_k7(dev, rng, families, timed):
    """K7 against its plain version at nq = 1, 64 and NQ_COV queries (the
    first ones on training points): the mean within rel TOL_K7, the
    covariance within an absolute TOL_K7_COV max|K(Xq, Xq)|."""
    import torch
    from gpry_tpu_torch.ops import fused
    worst = 0.0
    row = {}
    for fam in families:
        label = "spec" if is_spec(fam) else fam
        p = synthetic_surrogate(fam, dev, seed=16)
        for nq in (1, 64, NQ_COV):
            Xq = torch.as_tensor(rng.uniform(0, 1, (nq, D)),
                                 dtype=torch.float64, device=dev)
            Xq[:min(nq, 32)] = p.X[:min(nq, 32)]
            args = (p.theta, p.X, p.n, p.noise_var, p.L, p.alpha, Xq)
            ma, ca = fused.predict_meancov(fam, *args)
            mb, cb = fused.predict_meancov_plain(fam, *args)
            kqq = fused.predict_meancov_plain(
                fam, p.theta, p.X, 0, p.noise_var, p.L, p.alpha, Xq)[1]
            sync()
            err_m, rel_m = rel_err(ma, mb)
            err_c = float(torch.max(torch.abs(ca - cb)))
            tol_c = TOL_K7_COV * float(torch.max(torch.abs(kqq)))
            log(f"[K7] {label:8s} nq={nq:5d}: mean rel {rel_m:.3e}; cov max "
                f"abs err {err_c:.3e} (tol {tol_c:.3e})")
            if not (rel_m <= TOL_K7 and err_c <= tol_c):
                raise AssertionError(f"K7 {label} nq={nq}: mean rel {rel_m} "
                                     f"or cov abs {err_c} > {tol_c}")
            worst = max(worst, err_m, err_c)
            if fam == timed and nq == NQ_COV:
                ms = time_ms(lambda: fused.predict_meancov(fam, *args), 20)
                plain = time_ms(
                    lambda: fused.predict_meancov_plain(fam, *args), 20)
                log(f"[K7] {label} nq={nq}: kernel {ms:.4f} ms, plain "
                    f"{plain:.4f} ms")
                row = {"ms": ms, "plain_ms": plain}
    nq = NQ_COV
    row.update({"max_abs_err": worst,
                "shape": f"nq={nq} n={N} nmax={NMAX} d={D}"})
    # the k vectors and the mean, the substitutions (n^2 / 2 multiply-adds
    # per query), and Kqq - V^T V on one triangle (the covariance is
    # symmetric); bytes: the queries, the training rows, alpha, the valid
    # triangle of L, the mean and the whole covariance
    row.update(bound(
        nq * N * (pair_flops(timed) + 2) + nq * N * N
        + nq * (nq + 1) // 2 * (pair_flops(timed) + 2 * N),
        8 * (nq * D + N * D + N + N * (N + 1) // 2 + nq + nq * nq)))
    return row


def check_kernels(dev):
    """Compare K1-K7 with their plain versions, the fast families and the
    ALL_NODES spec; returns per-kernel rows (spec mode as "<name>/spec")."""
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
        torch.cuda.empty_cache()
        log(f"[CHECKS] {'spec' if sfx else 'fast families'}: "
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


def run_runner(label, resample=True, **kwargs):
    """A Runner on the d = 8 correlated Gaussian (``kwargs`` pick the
    engine and options): ``run()`` then, with ``resample``,
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
    runner = Runner(model.loglike, bounds=model.bounds, seed=1, verbose=2,
                    **kwargs)
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


def run_default_with_cov():
    """Path a: the default Runner, then K7 on its surrogate."""
    runner, sample, summary = run_runner("SLICE")
    summary["cov"] = check_cov("SLICE", runner.gpr, seed=21)
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
    """Path g on f's surrogate: K7 in spec mode, then one NORA
    ``multi_add(n_points=8)`` (its ranked pool: K4 in spec mode)."""
    import numpy as np
    from gpry_tpu_torch.acquisition import NORA
    gpr = runner.gpr
    summary = {"cov": check_cov("SPEC-COV", gpr, seed=22)}
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


def bench_data(seed=0):
    """bench.py's make_data (bench.py:44-49): N = 224 uniform points in
    the unit 8-cube under a centred isotropic Gaussian."""
    import numpy as np
    rng = np.random.default_rng(seed)
    bounds = np.array([[0.0, 1.0]] * D)
    X = rng.uniform(size=(N, D))
    y = -0.5 * 25 * np.sum((X - 0.5) ** 2, axis=1)
    return bounds, X, y


def run_nora_bench(n_timed=2):
    """bench.py's NORA operating point on the port (bench.py:52-92): a
    26-restart fit, ``force_resample()`` and ``multi_add(n_points=8)``,
    once to warm up and ``n_timed`` times timed."""
    import numpy as np
    from gpry_tpu_torch.acquisition import NORA
    from gpry_tpu_torch.models.gp import GaussianProcessRegressor
    from gpry_tpu_torch.models.preprocessing import Normalize_bounds, \
        Normalize_y
    from gpry_tpu_torch.ops import fused
    bounds, X, y = bench_data()
    gpr = GaussianProcessRegressor(
        bounds=bounds, preprocessing_X=Normalize_bounds(bounds),
        preprocessing_y=Normalize_y(), random_state=0, verbose=1)
    gpr.append_to_data(X, y, fit_gpr=False)
    acq = NORA(bounds, acq_func={"LogExp": {"dimension": D}},
               rng=np.random.default_rng(1), verbose=1)
    iters = []
    for i in range(1 + n_timed):
        acq.force_resample()
        before = dict(fused.LAUNCHES)
        t0 = time.perf_counter()
        gpr.fit_gpr_hyperparameters(n_restarts=10 + 2 * D)
        sync()
        t_fit = time.perf_counter() - t0
        Xn, _, acq_vals = acq.multi_add(gpr, n_points=D)
        sync()
        t_acq = time.perf_counter() - t0 - t_fit
        if Xn.shape != (D, D) or not np.all(np.isfinite(acq_vals)) or \
                not np.all((Xn >= bounds[:, 0]) & (Xn <= bounds[:, 1])):
            raise AssertionError(f"NORA bench iteration {i}: malformed "
                                 f"proposal {Xn.shape}")
        it = {"fit_s": t_fit, "acq_s": t_acq, "nlive": acq._nlive(gpr),
              "ns_samples": int(len(acq.last_MC_X)),
              "launches": {k: fused.LAUNCHES[k] - before[k]
                           for k in before}}
        log(f"[NORA-BENCH] {'warm-up' if i == 0 else f'iter {i}'}: "
            + json.dumps(it))
        iters.append(it)
    timed = [it["fit_s"] + it["acq_s"] for it in iters[1:]]
    summary = {"iters": iters, "fit_acq_s_min": min(timed),
               "fit_acq_s_median": float(np.median(timed))}
    log(f"[NORA-BENCH] fit + acquisition s/iter: min {min(timed):.4f}, "
        f"median {summary['fit_acq_s_median']:.4f}")
    return summary


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


def run_himmelblau_audit():
    """The audited NORA Runner on Himmelblau at the default options
    (benchmarks/nongaussian.py:110, seed 100): converged, moment-KL of the
    final sample against the grid-quadrature truth <= KL_GATE, every
    quadrant's mode >= 5% of the weight."""
    import numpy as np
    from model_generator import himmelblau
    from gpry_tpu_torch.run import Runner
    from gpry_tpu_torch.utils.tools import kl_norm, mean_covmat_from_samples
    model = himmelblau()
    mean_t, cov_t = grid_truth_moments(model)
    t0 = time.perf_counter()
    runner = Runner(model.loglike, bounds=model.bounds, seed=100, verbose=2,
                    gp_acquisition="NORA")
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


NS_RUNS = {"runs": 0, "steps": 0, "s": 0.0}


def time_ns_runs():
    """Wrap the nested sampler where the port calls it (the final MC and
    NORA) to count its runs and steps and sum its wall seconds (each run
    ends in host reads, so its wall time is its time) into NS_RUNS."""
    from gpry_tpu_torch.acquisition import nora
    from gpry_tpu_torch.mc import samples
    inner = samples.run_nested_device

    def timed(*args, **kwargs):
        t0 = time.perf_counter()
        res = inner(*args, **kwargs)
        sync()
        NS_RUNS["s"] += time.perf_counter() - t0
        NS_RUNS["runs"] += 1
        NS_RUNS["steps"] += res.n_steps
        return res

    samples.run_nested_device = timed
    nora.run_nested_device = timed


def drive(name, fn, *args, **kwargs):
    """Run one path with the launch counts and the NS clock set to 0 just
    before it and read just after; fail if a kernel of the path was not
    launched, or if K1 was launched more than 1% as often as when the
    nested sampler ran its chains through K1."""
    from gpry_tpu_torch.ops import fused
    fused.reset_launch_counts()
    NS_RUNS.update(runs=0, steps=0, s=0.0)
    out = fn(*args, **kwargs)
    sync()
    launches = dict(fused.LAUNCHES)
    ns = dict(NS_RUNS)
    log(f"[{name}] kernel launches: {launches}")
    log(f"[{name}] nested sampling: {ns['runs']} runs, {ns['steps']} steps, "
        f"{ns['s']:.3f} s")
    for kernel in PATH_KERNELS[name]:
        if launches[kernel] <= 0:
            raise AssertionError(f"kernel {kernel} was not launched on the "
                                 f"{name} path")
    before = LOCKSTEP_K1_LAUNCHES.get(name)
    if before is not None and not launches["gated_mean"] < 0.01 * before:
        raise AssertionError(
            f"{name}: {launches['gated_mean']} K1 launches, not below 1% "
            f"of the {before} of the lock-step nested sampler")
    return out, launches, ns


def drive_paths():
    """The seven paths in order; returns their summaries and launches."""
    t0 = time.perf_counter()
    time_ns_runs()
    paths, launches, ns = {}, {}, {}
    paths["batchoptimizer"], launches["batchoptimizer"], \
        ns["batchoptimizer"] = drive("batchoptimizer", run_default_with_cov)
    paths["nora_bench"], launches["nora_bench"], ns["nora_bench"] = drive(
        "nora_bench", run_nora_bench)
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
    for name, stats in ns.items():
        paths[name]["nested_sampling"] = stats
    log(f"[PATHS] all seven paths in {time.perf_counter() - t0:.1f} s")
    return paths, launches


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

    t0 = time.perf_counter()
    rows = check_kernels(dev)
    log(f"[CHECKS] all kernel checks in {time.perf_counter() - t0:.1f} s")
    paths, launches = drive_paths()
    kernels = []
    for base, (src, replaces) in SOURCES.items():
        for name in (base, base + "/spec"):
            # library_ms: no single PyTorch call computes any of the
            # seven functions (PERF.md, section 6, says why for each)
            row = {"name": name, "route": "cuda", "source": src,
                   "replaces": replaces,
                   "launches": sum(c[name] for c in launches.values()),
                   "launches_by_path": {k: c[name]
                                        for k, c in launches.items()},
                   "library_ms": None}
            row.update(rows[name])
            kernels.append(row)
    assert "jax" not in sys.modules
    assert not any(m == "gpry_tpu" or m.startswith("gpry_tpu.")
                   for m in sys.modules)
    print(json.dumps({"kernels": kernels, "paths": paths}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
