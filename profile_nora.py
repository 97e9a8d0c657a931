#!/usr/bin/env python3
"""
Where the time of one NORA iteration, and of one of its nested-sampling
runs step by step, goes on one CUDA card.

bench.py's NORA operating point (d = 8, N = 224; ``chip_smoke.bench_data``):
a 26-restart fit, ``force_resample()`` and ``multi_add(n_points=8)``.

1. One iteration warms up; the next is timed by phase with the host clock
   (each phase ends in a synchronise): the fit, the NS run with its K2
   sweep (``NORA._run_ns``), the ranked-pool fill (``RankedPool.add_bulk``,
   K4) and the rest of ``multi_add``; with the kernel launches it made.
2. Windows run once unprofiled and once under ``torch.profiler``: a full
   fit, one whole NS run at NORA's settings (nlive = 200, 40 repeats, a
   prior sample of 2,000) at bench.py's point and one on the final
   surrogate of chip_smoke.py's path c (the NORA Runner on the d = 8
   Gaussian, ``run()`` first), and a ``multi_add`` that reuses the stored
   NS sample (one K2 sweep and the K4 fill).  The union of a window's
   device intervals (kernels and copies) over its wall time is the
   device's busy share: against the profiled wall (the profiler slows the
   host: a lower bound) and the unprofiled wall.  An NS run is split per
   step into the device time of K6 (the slice chains), of K13 (the
   step's bookkeeping), of the draws (torch's random kernels) and of
   every other device op, and the unprofiled wall per step; the device's
   idle time per step is the host's.

    python3 profile_nora.py [TREE]

TREE (default: this checkout) is a checkout whose ``gpry_tpu_torch`` is
profiled; the driving code is this script's own, so two trees are timed on
the same work.  Prints the card's name and power limit and one JSON line.
Needs a card.
"""

import json
import os
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))


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


def ns_step_split(by_name, steps):
    """Device ms per NS step of K6, K13, the draws and the rest."""
    parts = {"k6": "ns_slice_chains", "k13": "ns_step_kernel",
             "draws": "distribution"}
    out = {k: 0.0 for k in (*parts, "other")}
    for name, us in by_name.items():
        key = next((k for k, v in parts.items() if v in name), "other")
        out[key] += 1e-3 * us / steps
    return out


def main():
    tree = os.path.abspath(sys.argv[1]) if len(sys.argv) > 1 else HERE
    sys.path[:0] = [tree, HERE, os.path.join(HERE, "tests")]
    import numpy as np
    import torch
    if not torch.cuda.is_available():
        print("profile_nora.py needs a CUDA card.", file=sys.stderr)
        return 3
    from torch.autograd import DeviceType
    from chip_smoke import D, bench_data, card_line, run_runner
    from gpry_tpu_torch import config
    from gpry_tpu_torch.acquisition import NORA, RankedPool
    from gpry_tpu_torch.mc.nested import run_nested_device
    from gpry_tpu_torch.mc.samples import surrogate_logp_fn
    from gpry_tpu_torch.models.gp import GaussianProcessRegressor
    from gpry_tpu_torch.models.preprocessing import Normalize_bounds, \
        Normalize_y
    from gpry_tpu_torch.ops import fused
    dev = config.set_device("cuda")
    card = card_line()

    # synchronised host-clock phases, recorded by wrapping two methods
    spans = {}

    def timed(name, fn):
        def wrapper(*args, **kwargs):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn(*args, **kwargs)
            torch.cuda.synchronize()
            spans[name] = spans.get(name, 0.0) + time.perf_counter() - t0
            return out
        return wrapper

    NORA._run_ns = timed("ns_run", NORA._run_ns)
    RankedPool.add_bulk = timed("pool_fill", RankedPool.add_bulk)

    bounds, X, y = bench_data()
    gpr = GaussianProcessRegressor(
        bounds=bounds, preprocessing_X=Normalize_bounds(bounds),
        preprocessing_y=Normalize_y(), random_state=0, verbose=1)
    gpr.append_to_data(X, y, fit_gpr=False)
    acq = NORA(bounds, acq_func={"LogExp": {"dimension": D}},
               rng=np.random.default_rng(1), verbose=1)

    def fit():
        gpr.fit_gpr_hyperparameters(n_restarts=10 + 2 * D)

    def iteration():
        acq.force_resample()
        spans.clear()
        t0 = time.perf_counter()
        fit()
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        acq.multi_add(gpr, n_points=D)
        torch.cuda.synchronize()
        out = {"fit_s": t1 - t0, "multi_add_s": time.perf_counter() - t1}
        out.update({f"{k}_s": v for k, v in spans.items()})
        out["rest_of_multi_add_s"] = (out["multi_add_s"] - out["ns_run_s"]
                                      - out["pool_fill_s"])
        return out

    iteration()                                   # warm-up
    fused.reset_launch_counts()
    phases = iteration()
    phases["launches"] = dict(fused.LAUNCHES)
    print("[iteration] " + json.dumps(phases), flush=True)

    def ns_run_of(gpr, acq):
        """One NS run at NORA's settings on ``gpr``'s surrogate."""
        def run():
            p = gpr.surrogate_params()
            b = acq.bounds
            lo = torch.as_tensor(b[:, 0], dtype=p.X.dtype, device=dev)
            hi = torch.as_tensor(b[:, 1], dtype=p.X.dtype, device=dev)
            nlive = acq._nlive(gpr)
            res = run_nested_device(
                surrogate_logp_fn(gpr.family), p,
                torch.Generator(device=dev).manual_seed(3), lo, hi,
                nlive=nlive, num_repeats=int(acq.num_repeats),
                precision_criterion=acq.precision_criterion_target,
                max_dead=int(nlive * max(8, 2 * D)),
                n_prior=acq.nprior_per_nlive * nlive)
            return {"ns_steps": res.n_steps, "ns_calls": res.n_calls,
                    "nlive": nlive, "n_training": int(gpr.n)}
        return run

    def multi_add_reuse():
        acq.multi_add(gpr, n_points=D)

    activities = [torch.profiler.ProfilerActivity.CPU,
                  torch.profiler.ProfilerActivity.CUDA]
    runner_c, _, summary_c = run_runner("NORA", resample=False,
                                        gp_acquisition="NORA",
                                        options={"audit": False})
    windows = {"path_c_run": {k: summary_c[k] for k in (
        "run_s", "n_total", "kl", "iterations")}}
    for name, fn in (("fit", fit), ("ns_run", ns_run_of(gpr, acq)),
                     ("ns_run_path_c", ns_run_of(runner_c.gpr,
                                                 runner_c.acquisition)),
                     ("multi_add_reuse", multi_add_reuse)):
        fused.reset_launch_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        info = fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = dict(fused.LAUNCHES)
        with torch.profiler.profile(activities=activities) as prof:
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            wall_prof = time.perf_counter() - t0
        events = [e for e in prof.events()
                  if e.device_type == DeviceType.CUDA]
        if not events:
            raise AssertionError(f"{name}: the profiler recorded no device "
                                 "activity")
        by_name = {}
        for e in events:
            by_name[e.name] = by_name.get(e.name, 0.0) \
                + e.time_range.elapsed_us()
        top = sorted(by_name.items(), key=lambda kv: -kv[1])[:6]
        busy = busy_us(events) * 1e-6
        windows[name] = {
            "unprofiled_wall_s": wall, "profiled_wall_s": wall_prof,
            "device_s": busy, "device_events": len(events),
            "busy_share_range": [busy / wall_prof, busy / wall],
            "launches": launches,
            "device_ms_by_kernel": {k[:60]: v * 1e-3 for k, v in top}}
        if info:
            steps = info["ns_steps"]
            windows[name].update(
                info, wall_ms_per_step=1e3 * wall / steps,
                device_ms_per_step=ns_step_split(by_name, steps),
                idle_ms_per_step=1e3 * (wall - busy) / steps)
        print(f"[{name}] " + json.dumps(windows[name]), flush=True)
    print(card)
    print(json.dumps({"card": card, "phases_s": phases, "windows": windows}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
