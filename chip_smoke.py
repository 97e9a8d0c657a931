#!/usr/bin/env python3
"""
Drive gpry_tpu_torch once on one CUDA card.

1. Build the three CUDA kernels (K1 gated_mean, K2 gated_meanvar_logexp,
   K3 masked_kernel_matrix_batched) from ``gpry_tpu_torch/csrc``.
2. Hold each kernel against its plain PyTorch version on the card at the
   shapes of the main path (d = 8, n = 224 valid rows in a bucket of
   nmax = 320; K1 at nq = 66 and 65,536, K2 at nq = 3,200, K3 at
   R = 2,048), and time both with CUDA events.
3. Run the main path: ``Runner(loglike, bounds, options={"audit": False})``
   ``.run()`` and then ``generate_mc_sample()`` on the 8-dimensional
   correlated Gaussian of ``tests/model_generator.py``; check convergence,
   KL(sample || truth) <= 0.05, and that every kernel was launched.

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
TOL_K1, TOL_K2, TOL_K3 = 1e-12, 1e-10, 1e-12
SOURCES = {
    "gated_mean": ("gpry_tpu_torch/csrc/gated_mean.cu",
                   "gpry_tpu/models/gp.py:121"),
    "gated_meanvar_logexp": ("gpry_tpu_torch/csrc/gated_meanvar_logexp.cu",
                             "gpry_tpu/models/gp.py:100"),
    "masked_kernel_matrix_batched": (
        "gpry_tpu_torch/csrc/masked_kernel_matrix.cu",
        "gpry_tpu/ops/linalg.py:34"),
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


def synthetic_surrogate(family, dev, seed):
    """A surrogate snapshot at the main-path shapes with every gate active:
    a fitted SVM, a trust box inside the prior and an upper clip."""
    import numpy as np
    import torch
    from gpry_tpu_torch.models.classifier import MODE_FITTED, SVMParams
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
    svm = SVMParams(mode=MODE_FITTED, sv=t(sv), dual=t(dual),
                    intercept=t(-np.median(dec)), gamma=t(gamma))
    p = SurrogateParams(
        theta=t(theta), X=t(Xp), y=t(yp), n=N, noise_var=noise, L=L,
        alpha=alpha, x_loc=t(np.full(D, -5.0)), x_scale=t(np.full(D, 10.0)),
        y_loc=t(-3.0), y_scale=t(2.5), y_max=t(0.0), clip_max=t(np.inf),
        svm=svm, trust_lo=t(np.full(D, -4.5)), trust_hi=t(np.full(D, 4.5)))
    # an upper clip below the largest mean, so that it binds somewhere
    from gpry_tpu_torch.ops.fused import gated_mean_plain
    m = gated_mean_plain(family, p, t(rng.uniform(-5, 5, (4096, D))))
    clip = torch.quantile(m[torch.isfinite(m)], 0.9)
    return p.replace(clip_max=clip.to(torch.float64))


def check_kernels(dev):
    """Compare K1-K3 with their plain versions; returns per-kernel rows."""
    import numpy as np
    import torch
    from gpry_tpu_torch.ops import fused
    families = ("rbf", "matern12", "matern32", "matern52")
    rng = np.random.default_rng(7)
    rows = {}

    # K1: the NS kill batch (nlive = 400 -> B = 66) and the IS refine
    worst = 0.0
    shapes = {}
    for fam in families:
        p = synthetic_surrogate(fam, dev, seed=11)
        for nq in (66, 65536):
            Xq = torch.as_tensor(rng.uniform(-5, 5, (nq, D)),
                                 dtype=torch.float64, device=dev)
            a = fused.gated_mean(fam, p, Xq)
            b = fused.gated_mean_plain(fam, p, Xq)
            torch.cuda.synchronize()
            err, rel = rel_err(a, b)
            log(f"[K1] {fam:8s} nq={nq:6d}: max abs err {err:.3e}, "
                f"rel {rel:.3e}, finite {int(torch.isfinite(b).sum())}")
            if not rel <= TOL_K1:
                raise AssertionError(f"K1 {fam} nq={nq}: rel {rel} > "
                                     f"{TOL_K1}")
            worst = max(worst, err)
            if fam == "rbf":
                reps = 200 if nq == 66 else 20
                ms = time_ms(lambda: fused.gated_mean(fam, p, Xq), reps)
                plain = time_ms(lambda: fused.gated_mean_plain(fam, p, Xq),
                                reps)
                shapes[f"nq={nq}"] = {"ms": ms, "plain_ms": plain}
                log(f"[K1] rbf nq={nq}: kernel {ms:.4f} ms, plain "
                    f"{plain:.4f} ms")
    rows["gated_mean"] = {"max_abs_err": worst, "shapes": shapes,
                          "ms": shapes["nq=65536"]["ms"],
                          "plain_ms": shapes["nq=65536"]["plain_ms"]}

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
        "max_abs_err": worst, "ms": ms, "plain_ms": plain}
    torch.cuda.empty_cache()
    return rows


def run_slice():
    """The main path at d = 8; returns (runner, sample, phase seconds)."""
    import numpy as np
    from model_generator import random_gaussian
    from gpry_tpu_torch.run import Runner
    from gpry_tpu_torch.utils.tools import kl_norm, mean_covmat_from_samples
    model = random_gaussian(d=D, rng=10 + D)
    t0 = time.perf_counter()
    runner = Runner(model.loglike, bounds=model.bounds, seed=1, verbose=2,
                    options={"audit": False})
    runner.run()
    t_run = time.perf_counter() - t0
    t0 = time.perf_counter()
    sample = runner.generate_mc_sample()
    t_mc = time.perf_counter() - t0
    mean, cov = mean_covmat_from_samples(sample["X"], sample["weights"])
    kl = max(kl_norm(mean, cov, model.mean, model.cov),
             kl_norm(model.mean, model.cov, mean, cov))
    tab = runner.progress.table
    from gpry_tpu_torch.progress import _COLUMNS
    col = lambda c: float(np.nansum(tab[:, _COLUMNS.index(c)]))
    phases = {"run_s": t_run, "generate_mc_sample_s": t_mc,
              "fit_s": col("time_fit"), "acquisition_s": col("time_acquire"),
              "truth_s": col("time_truth"), "ns_s": sample["time_ns"],
              "refine_s": sample["time_refine"]}
    log(f"[SLICE] converged={runner.has_converged} n_total="
        f"{runner.gpr.n_total} iterations={runner.current_iteration} "
        f"KL={kl:.4g} refined={bool(sample.get('refined'))} "
        f"ns_steps={sample['ns_steps']} ns_calls={sample['n_calls']}")
    log("[SLICE] phase seconds: " + json.dumps(phases))
    if not runner.has_converged:
        raise AssertionError("the d=8 slice did not converge")
    if not (np.isfinite(kl) and kl <= KL_GATE):
        raise AssertionError(f"KL(sample || truth) = {kl} > {KL_GATE}")
    if sample["X"].shape[1] != D or not np.all(np.isfinite(sample["X"])):
        raise AssertionError("the final sample is malformed")
    return runner, kl, phases


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

    fused.reset_launch_counts()
    runner, kl, phases = run_slice()
    launches = dict(fused.LAUNCHES)
    log(f"[SLICE] kernel launches on the main path: {launches}")
    for name, count in launches.items():
        if count <= 0:
            raise AssertionError(f"kernel {name} was not launched on the "
                                 "main path")
    kernels = []
    for name, (src, replaces) in SOURCES.items():
        row = {"name": name, "route": "cuda", "source": src,
               "replaces": replaces, "launches": launches[name]}
        row.update(rows[name])
        kernels.append(row)
    assert "jax" not in sys.modules
    print(json.dumps({"kernels": kernels, "slice": dict(
        phases, kl=kl, n_total=int(runner.gpr.n_total),
        iterations=int(runner.current_iteration))}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
