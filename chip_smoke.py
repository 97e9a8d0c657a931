#!/usr/bin/env python3
"""
Drive gpry_tpu_torch once on one CUDA card.

1. Build the six CUDA kernels (K1 gated_mean, K2 gated_meanvar_logexp,
   K3 masked_kernel_matrix_batched, K4 kriging_believer_fill, K5
   meanvar_ungated, K6 ns_slice_chains) from ``gpry_tpu_torch/csrc``, one
   nvcc per source, all at once.
2. Hold each kernel against its plain PyTorch version on the card at the
   shapes of the main paths (d = 8, n = 224 valid rows in a bucket of
   nmax = 320; K1 at nq = 16, 66, 2,000, 16,384 and 65,536 in both of
   its designs, K2 at nq = 3,200, K3 at R = 2,048, K4 at N = 4,096 candidates
   and a pool of 8, K5 at the audit screen's nq = 4,096, K6 at the NS's
   B = 66 and 33 chains of 40 repeats; K1 and K6 with the SVM fitted and
   all finite), time both with CUDA events (K1 and K6 also by their
   kernel's own duration in a ``torch.profiler`` trace), and compute each
   kernel's bound: the larger of its FP64 operations over the H100 SXM's
   FP64 peak and its bytes over 3.35 TB/s.  K1's and K6's operations count
   only the sums their inputs need: the SVM decision of a point inside the
   trust box (and K6's prior box), the GP mean only where that decision
   is finite, over the points K6's chains must evaluate.
3. Drive five paths, each with the launch counts set to 0 just before it
   and read just after, and check that each launched its kernels, that
   K1's launches on paths a, b, c and e are below 1% of what the
   lock-step nested sampler made there (LOCKSTEP_K1_LAUNCHES), and print
   the seconds each path spent in nested sampling:
   a. the default entry point: ``Runner(loglike, bounds).run()`` (the
      BatchOptimizer loop with the convergence audit) then
      ``generate_mc_sample()`` on the 8-dimensional correlated Gaussian
      of ``tests/model_generator.py`` (converged, KL(sample || truth)
      <= 0.05);
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
      >= 5% of the weight).

Prints the card's ``nvidia-smi`` name and power limit, a JSON line with the
kernel results, and as the last line the contract line
``{"ok": true, "device": {...}}``.  Any failure raises (exit code != 0)
before a result is printed.

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
# K5: the mean within rel TOL_K5; sigma within TOL_K5_SIGMA sqrt(sigma^2)
# y_scale absolute (sigma^2 - |v|^2 cancels to ~0 at a training point)
TOL_K5, TOL_K5_SIGMA = 1e-10, 1e-7
# K5 at the audit screen
NQ_SCREEN = 4096
# the JAX package's truth evals to convergence on path e's run
# (benchmarks/results_nongaussian.json, Himmelblau seed 100)
JAX_HIMMELBLAU_EVALS = 61
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
                       "ns_slice_chains"),
    "nora_bench": ("gated_mean", "gated_meanvar_logexp",
                   "masked_kernel_matrix_batched", "kriging_believer_fill",
                   "ns_slice_chains"),
    "nora_runner": ("gated_mean", "gated_meanvar_logexp",
                    "masked_kernel_matrix_batched", "kriging_believer_fill",
                    "ns_slice_chains"),
    "mcmc": ("gated_mean",),
    "himmelblau_audit": tuple(SOURCES),
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


def synthetic_surrogate(family, dev, seed, svm="fitted"):
    """A surrogate snapshot at the main-path shapes with every gate active:
    a fitted SVM, a trust box inside the prior and an upper clip.  With
    ``svm="all_finite"`` the SVM is the placeholder of a run that has seen
    no -inf (the Gaussian paths' mode: no support vector is summed)."""
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
    theta = np.concatenate([[np.log(2.0)], np.log(rng.uniform(0.4, 0.9, D))])
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


def sum_flops(n_svm, n_gp):
    """FP64 operations of those sums: per (point, training row or support
    vector) r^2 over d, one exponential, one multiply-add."""
    return (n_svm * NSV + n_gp * N) * (3 * D + 3)


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


def check_k4(dev, rng):
    """K4 against its plain version: identical picks and -inf masks,
    outC and outS within rel TOL_K4, in both sweep modes (LogExp in the
    kernel; any other acquisition in torch between the two kernels)."""
    import torch
    from gpry_tpu_torch.acquisition.functions import LogExp
    from gpry_tpu_torch.ops import fused
    acqf, noise_std = LogExp(dimension=D), 0.01
    worst = 0.0
    row = {}
    for fam in ("rbf", "matern12", "matern32", "matern52"):
        for noise_kind in ("scalar", "vector"):
            args = k4_inputs(fam, dev, noise_kind, rng, acqf, noise_std)
            ref = fused.kriging_believer_fill_plain(fam, *args)
            if not bool(torch.isfinite(ref[4]).all()):
                raise AssertionError(f"K4 {fam}: the plain fill left "
                                     "slots empty")
            for mode, logexp in (("logexp", (acqf.zeta, noise_std)),
                                 ("torch-acq", None)):
                out = fused.kriging_believer_fill(fam, *args, logexp=logexp)
                sync()
                for what, i in (("outX", 0), ("outY", 1), ("outA", 3)):
                    if not torch.equal(out[i], ref[i]):
                        raise AssertionError(
                            f"K4 {fam} {noise_kind} {mode}: {what} differs "
                            "(different picks)")
                errC, relC = rel_err(out[4], ref[4])
                errS, relS = rel_err(out[2], ref[2])
                log(f"[K4] {fam:8s} noise {noise_kind:6s} {mode:9s}: "
                    f"same picks; outC max abs err {errC:.3e} rel "
                    f"{relC:.3e}; outS rel {relS:.3e}")
                if not (relC <= TOL_K4 and relS <= TOL_K4):
                    raise AssertionError(f"K4 {fam} {mode}: rel {relC}, "
                                         f"{relS} > {TOL_K4}")
                worst = max(worst, errC, errS)
            if fam == "rbf" and noise_kind == "scalar":
                lexp = (acqf.zeta, noise_std)
                ms = time_ms(lambda: fused.kriging_believer_fill(
                    fam, *args, logexp=lexp), 20)
                plain = time_ms(lambda: fused.kriging_believer_fill_plain(
                    fam, *args), 5)
                log(f"[K4] rbf N={N_CAND} size={SIZE}: kernel {ms:.4f} ms, "
                    f"plain {plain:.4f} ms")
                row = {"ms": ms, "plain_ms": plain}
                # FP64 work of this fill: every conditioned round sweeps
                # the alive candidates (k vector, length-n substitution,
                # sum of squares), every round appends one row
                n0 = args[0].n
                flops = sum((N_CAND - r) * ((n0 + r) * (3 * D + 3)
                                            + (n0 + r) ** 2 + 3 * (n0 + r))
                            for r in range(1, SIZE))
                flops += sum((n0 + r) * (3 * D + 3) + (n0 + r) ** 2
                             for r in range(SIZE))
                nbytes = 8 * (N_CAND * (D + 3) + n0 * D
                              + n0 * (n0 + 1) // 2 + SIZE * (D + 4)) + N_CAND
                row.update(bound(flops, nbytes))
    row["max_abs_err"] = worst
    row["shape"] = f"N={N_CAND} n={N} nmax={NMAX} d={D} size={SIZE}"
    return row


def check_k5(dev, rng):
    """K5 against its plain version at the audit screen (nq = NQ_SCREEN,
    the first 64 queries on training points) for all four families."""
    import torch
    from gpry_tpu_torch.ops import fused
    worst = 0.0
    row = {}
    for fam in ("rbf", "matern12", "matern32", "matern52"):
        p = synthetic_surrogate(fam, dev, seed=14)
        Xq = torch.as_tensor(rng.uniform(-5, 5, (NQ_SCREEN, D)),
                             dtype=torch.float64, device=dev)
        Xq[:64] = p.X[:64] * p.x_scale + p.x_loc
        ma, sa = fused.meanvar_ungated(fam, p, Xq)
        mb, sb = fused.meanvar_ungated_plain(fam, p, Xq)
        torch.cuda.synchronize()
        err_m, rel_m = rel_err(ma, mb)
        err_s = float(torch.max(torch.abs(sa - sb)))
        tol_s = TOL_K5_SIGMA * float(torch.exp(0.5 * p.theta[0])
                                     * p.y_scale)
        log(f"[K5] {fam:8s} nq={NQ_SCREEN}: mean max abs err {err_m:.3e} "
            f"rel {rel_m:.3e}; std max abs err {err_s:.3e} (tol "
            f"{tol_s:.3e})")
        if not (rel_m <= TOL_K5 and err_s <= tol_s):
            raise AssertionError(f"K5 {fam}: mean rel {rel_m} > {TOL_K5} "
                                 f"or std abs {err_s} > {tol_s}")
        worst = max(worst, err_m, err_s)
        if fam == "rbf":
            ms = time_ms(lambda: fused.meanvar_ungated(fam, p, Xq), 50)
            plain = time_ms(lambda: fused.meanvar_ungated_plain(fam, p, Xq),
                            50)
            log(f"[K5] rbf nq={NQ_SCREEN}: kernel {ms:.4f} ms, plain "
                f"{plain:.4f} ms")
            row = {"ms": ms, "plain_ms": plain}
    row["max_abs_err"] = worst
    row["shape"] = f"nq={NQ_SCREEN} n={N} nmax={NMAX} d={D}"
    # per query: the k vector, the length-n forward substitution (n^2 / 2
    # multiply-adds), the mean and the sum of squares; bytes: the queries,
    # the training rows, alpha, the valid triangle of L, two outputs
    nq = NQ_SCREEN
    row.update(bound(nq * (N * (3 * D + 3) + N * N + 4 * N),
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


def check_k6(dev):
    """K6 against its plain version (the lock-step loop on plain K1) on the
    same draws, all four families, B in K6_B, with the SVM fitted and all
    finite: identical calls and -inf masks, x and lx within rel TOL_K6.
    Timed for the RBF family; the bound counts the sums of the points its
    chains must evaluate (k6_evaluated_points, needed_sums)."""
    import torch
    from gpry_tpu_torch.ops import fused
    worst = 0.0
    row = {"shapes": {}}
    for fam in ("rbf", "matern12", "matern32", "matern52"):
        for svm in ("fitted", "all_finite"):
            for B in K6_B:
                p, args = k6_inputs(fam, dev, B, seed=B, svm=svm)
                x, lx, calls = fused.ns_slice_chains(fam, p, *args)
                sync()
                xr, lxr, callsr = fused.ns_slice_chains_plain(fam, p, *args)
                if not torch.equal(calls, callsr):
                    raise AssertionError(f"K6 {fam} {svm} B={B}: calls "
                                         "differ")
                err_l, rel_l = rel_err(lx, lxr)
                err_x, rel_x = rel_err(x.reshape(-1), xr.reshape(-1))
                log(f"[K6] {fam:8s} svm {svm:10s} B={B} R={K6_R}: same calls "
                    f"({int(calls.sum())} in all); lx max abs err "
                    f"{err_l:.3e} rel {rel_l:.3e}; x rel {rel_x:.3e}")
                if not (rel_l <= TOL_K6 and rel_x <= TOL_K6):
                    raise AssertionError(f"K6 {fam} {svm} B={B}: rel "
                                         f"{rel_l}, {rel_x} > {TOL_K6}")
                worst = max(worst, err_l, err_x)
                if fam != "rbf" or (svm == "all_finite" and B != 66):
                    continue
                call = lambda: fused.ns_slice_chains(fam, p, *args)
                ms = time_ms(call, 20)
                dev_ms = kernel_device_ms(call, "ns_slice_chains", 10)
                t0 = time.perf_counter()
                fused.ns_slice_chains_plain(fam, p, *args)
                sync()
                plain = 1e3 * (time.perf_counter() - t0)
                pts = k6_evaluated_points(fam, p, args)
                n_svm, n_gp = needed_sums(p, pts, args[6], args[7])
                nbytes = 8 * (2 * B * D + 2 * B + K6_R * B * (D + 31) + N * D
                              + N + NSV * (D + 1) + D * D + 2 * D) + 8 * B
                shape = {"ms": ms, "device_ms": dev_ms, "plain_ms": plain,
                         "calls": int(calls.sum()), "evaluations": len(pts),
                         "svm_sums": n_svm, "gp_sums": n_gp,
                         **bound(sum_flops(n_svm, n_gp), nbytes)}
                row["shapes"][f"B={B} svm={svm}"] = shape
                log(f"[K6] rbf svm {svm} B={B} R={K6_R}: kernel {ms:.4f} ms "
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


def check_kernels(dev):
    """Compare K1-K6 with their plain versions; returns per-kernel rows."""
    import numpy as np
    import torch
    from gpry_tpu_torch.ops import fused
    families = ("rbf", "matern12", "matern32", "matern52")
    rng = np.random.default_rng(7)
    rows = {}

    # K1: the MCMC step (16 chains), the NS kill batch (nlive = 400 ->
    # B = 66), the NS prior phase (2,000), a large sweep (16,384) and the
    # IS refine (65,536), in both designs (block per query, tiled) and with
    # the SVM fitted and all finite; the wrapper's own choice is timed
    worst = 0.0
    shapes = {}
    for fam in families:
        for svm in ("fitted", "all_finite"):
            p = synthetic_surrogate(fam, dev, seed=11, svm=svm)
            timed = fam == "rbf" and svm == "fitted"
            for nq in (16, 66, 2000, 16384, 65536):
                Xq = torch.as_tensor(rng.uniform(-5, 5, (nq, D)),
                                     dtype=torch.float64, device=dev)
                b = fused.gated_mean_plain(fam, p, Xq)
                shape = {}
                for design in ("block", "tiled"):
                    a = fused.gated_mean(fam, p, Xq, _design=design)
                    torch.cuda.synchronize()
                    err, rel = rel_err(a, b)
                    log(f"[K1] {fam:8s} svm {svm:10s} nq={nq:6d} {design}: "
                        f"max abs err {err:.3e}, rel {rel:.3e}, finite "
                        f"{int(torch.isfinite(b).sum())}")
                    if not rel <= TOL_K1:
                        raise AssertionError(f"K1 {fam} {svm} nq={nq} "
                                             f"{design}: rel {rel} > {TOL_K1}")
                    worst = max(worst, err)
                    if timed:
                        reps = 20 if nq == 65536 else 200
                        call = lambda: fused.gated_mean(fam, p, Xq,
                                                        _design=design)
                        shape[f"ms_{design}"] = time_ms(call, reps)
                        shape[f"device_ms_{design}"] = kernel_device_ms(
                            call, "gated_mean", 20)
                if not timed:
                    continue
                reps = 20 if nq == 65536 else 200
                shape["ms"] = time_ms(lambda: fused.gated_mean(fam, p, Xq),
                                      reps)
                shape["plain_ms"] = time_ms(
                    lambda: fused.gated_mean_plain(fam, p, Xq), reps)
                n_svm, n_gp = needed_sums(p, Xq)
                shape.update({"svm_sums": n_svm, "gp_sums": n_gp})
                shape.update(bound(
                    sum_flops(n_svm, n_gp),
                    8 * (nq * D + nq + N * D + N + NSV * (D + 1) + 4 * D)))
                shapes[f"nq={nq}"] = shape
                log(f"[K1] rbf nq={nq}: " + json.dumps(shape))
    top = shapes["nq=65536"]
    rows["gated_mean"] = {"max_abs_err": worst, "shapes": shapes,
                          "shape": f"nq=65536 n={N} nmax={NMAX} d={D}",
                          **{k: top[k] for k in (
                              "ms", "plain_ms", "bound_ms", "bound_by",
                              "flops", "bytes")}}

    # K2: the acquisition screen, in both output modes
    worst = 0.0
    nq = 3200
    for fam in families:
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
            log(f"[K2] {fam:8s} {what:6s}: max abs err {err:.3e}, "
                f"rel {rel:.3e}")
            if not rel <= TOL_K2:
                raise AssertionError(f"K2 {fam} {what}: rel {rel} > "
                                     f"{TOL_K2}")
            worst = max(worst, err)
        if fam == "rbf":
            ms = time_ms(lambda: fused.gated_meanvar_logexp(
                fam, p, Xq, logexp=lexp), 50)
            plain = time_ms(lambda: fused.gated_meanvar_logexp_plain(
                fam, p, Xq, logexp=lexp), 50)
            log(f"[K2] rbf nq={nq}: kernel {ms:.4f} ms, plain "
                f"{plain:.4f} ms")
            rows["gated_meanvar_logexp"] = {"ms": ms, "plain_ms": plain}
    rows["gated_meanvar_logexp"]["max_abs_err"] = worst
    rows["gated_meanvar_logexp"]["shape"] = f"nq={nq} n={N} nmax={NMAX} d={D}"
    # per query: the k vector and the SVM sum, the length-n forward
    # substitution (n^2 / 2 multiply-adds), the mean and sum of squares
    rows["gated_meanvar_logexp"].update(bound(
        nq * ((N + NSV) * (3 * D + 3) + N * N + 4 * N),
        8 * (nq * D + nq + N * D + N + N * (N + 1) // 2 + NSV * (D + 1)
             + 4 * D)))

    # K3: the fit's LML screen (R = 2048 thetas), scalar and vector noise
    worst = 0.0
    R = 2048
    X = torch.zeros((NMAX, D), dtype=torch.float64, device=dev)
    X[:N] = torch.as_tensor(rng.uniform(0, 1, (N, D)), device=dev)
    thetas = torch.as_tensor(np.column_stack([
        rng.uniform(np.log(1e-4), np.log(1e6), R),
        rng.uniform(np.log(1e-3), np.log(10.0), (R, D))]),
        dtype=torch.float64, device=dev)
    noise_vec = torch.as_tensor(rng.uniform(1e-5, 1e-3, NMAX),
                                dtype=torch.float64, device=dev)

    def k3_plain(fam, th, noise):
        return torch.cat([fused.masked_kernel_matrix_plain(
            fam, th[i:i + 256], X, N, noise) for i in range(0, len(th), 256)])

    for fam in families:
        for noise in (torch.tensor(1e-4, dtype=torch.float64, device=dev),
                      noise_vec):
            th = thetas if fam == "rbf" and noise.ndim == 0 \
                else thetas[:256]
            a = fused.masked_kernel_matrix_batched(fam, th, X, N, noise)
            b = k3_plain(fam, th, noise)
            torch.cuda.synchronize()
            err, rel = rel_err(a, b)
            log(f"[K3] {fam:8s} R={len(th)} noise "
                f"{'vector' if noise.ndim else 'scalar'}: max abs err "
                f"{err:.3e}, rel {rel:.3e}")
            if not rel <= TOL_K3:
                raise AssertionError(f"K3 {fam}: rel {rel} > {TOL_K3}")
            worst = max(worst, err)
            del a, b
    noise = torch.tensor(1e-4, dtype=torch.float64, device=dev)
    ms = time_ms(lambda: fused.masked_kernel_matrix_batched(
        "rbf", thetas, X, N, noise), 10)
    plain = time_ms(lambda: k3_plain("rbf", thetas, noise), 3)
    log(f"[K3] rbf R={R}: kernel {ms:.4f} ms, plain {plain:.4f} ms")
    rows["masked_kernel_matrix_batched"] = {
        "max_abs_err": worst, "ms": ms, "plain_ms": plain,
        "shape": f"R={R} n={N} nmax={NMAX} d={D}"}
    # every valid entry of every theta's K; the whole padded matrix written
    rows["masked_kernel_matrix_batched"].update(bound(
        R * N * N * (3 * D + 3),
        8 * (R * (D + 1) + N * D + R * NMAX * NMAX)))
    torch.cuda.empty_cache()

    # K4: the ranked pool's greedy fill
    rows["kriging_believer_fill"] = check_k4(dev, rng)
    torch.cuda.empty_cache()

    # K5: the audit's screen
    rows["meanvar_ungated"] = check_k5(dev, rng)
    torch.cuda.empty_cache()

    # K6: the nested sampler's slice chains
    rows["ns_slice_chains"] = check_k6(dev)
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
    """The five paths in order; returns their summaries and launches."""
    t0 = time.perf_counter()
    time_ns_runs()
    paths, launches, ns = {}, {}, {}
    (_, _, paths["batchoptimizer"]), launches["batchoptimizer"], \
        ns["batchoptimizer"] = drive("batchoptimizer", run_runner, "SLICE")
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
    for name, stats in ns.items():
        paths[name]["nested_sampling"] = stats
    log(f"[PATHS] all five paths in {time.perf_counter() - t0:.1f} s")
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

    rows = check_kernels(dev)
    paths, launches = drive_paths()
    kernels = []
    for name, (src, replaces) in SOURCES.items():
        # library_ms: no single PyTorch call computes any of the six
        # functions (PERF.md, section 6, says why for each)
        row = {"name": name, "route": "cuda", "source": src,
               "replaces": replaces,
               "launches": sum(c[name] for c in launches.values()),
               "launches_by_path": {k: c[name] for k, c in launches.items()},
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
