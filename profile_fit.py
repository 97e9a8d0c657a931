#!/usr/bin/env python3
"""
Where the time of one GP hyperparameter fit goes on one CUDA card.

bench.py's operating point (chip_smoke.py's path h: d = 8, N = 224 in a
bucket of nmax = 320; ``chip_smoke.bench_data``): after a warm-up fit, a
26-restart fit (``fit_gpr_hyperparameters(n_restarts=26)``) and a
``simple`` fit are timed by phase with the host clock, each phase ending
in a synchronise: the LML screen and the exact re-score of the endpoints
(``_lml_batch_chunked``, before and after the polish), the polish
(``_fit_theta_restarts``) and the final ``factorize``.  Each phase's
recorded call then runs again alone under ``torch.profiler``: its device
kernels by name (launches, device ms), its host syncs (``.item()``-style
reads: ``aten::_local_scalar_dense``), and the union of its device
intervals (busy ms) against its profiled wall.

    python3 profile_fit.py [TREE]

TREE (default: this checkout) is a checkout whose ``gpry_tpu_torch`` is
profiled; the driving code is this script's own, so two trees are timed
on the same work.  Prints the card's name and power limit and one JSON
line.  Needs a card.
"""

import json
import os
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
PHASE_OF = {"_fit_theta_restarts": "polish", "factorize": "factorize"}


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


def profile_call(phase, call):
    """Run one recorded call again under torch.profiler; its kernels,
    host syncs and busy share."""
    import torch
    from torch.autograd import DeviceType
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        call["fn"](*call["args"], **call["kwargs"])
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    events = prof.events()
    dev = [e for e in events if e.device_type == DeviceType.CUDA]
    by_name = {}
    for e in dev:
        n, ms = by_name.get(e.name[:80], (0, 0.0))
        by_name[e.name[:80]] = (n + 1, ms + 1e-3 * e.time_range.elapsed_us())
    top = sorted(by_name.items(), key=lambda kv: -kv[1][1])[:6]
    return {"phase": phase, "s": call["s"], "profiled_wall_s": wall,
            "device_ops": len(dev),
            "device_ms": sum(ms for _, ms in by_name.values()),
            "busy_ms": 1e-3 * busy_us(dev),
            "host_syncs": sum(1 for e in events
                              if e.name == "aten::_local_scalar_dense"),
            "top": [{"name": k, "n": n, "ms": ms} for k, (n, ms) in top]}


def main():
    tree = os.path.abspath(sys.argv[1]) if len(sys.argv) > 1 else HERE
    sys.path[:0] = [tree, HERE]
    import torch
    if not torch.cuda.is_available():
        print("profile_fit.py needs a CUDA card.", file=sys.stderr)
        return 3
    from chip_smoke import D, bench_data, card_line
    from gpry_tpu_torch import config
    from gpry_tpu_torch.models import gp as gpm
    from gpry_tpu_torch.models.preprocessing import Normalize_bounds, \
        Normalize_y
    from gpry_tpu_torch.ops import fused
    config.set_device("cuda")
    fused.library()
    calls = []

    def record(name):
        inner = getattr(gpm, name)

        def timed(*args, **kwargs):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = inner(*args, **kwargs)
            torch.cuda.synchronize()
            calls.append({"name": name, "fn": inner, "args": args,
                          "kwargs": kwargs, "s": time.perf_counter() - t0})
            return out

        setattr(gpm, name, timed)

    for name in ("_lml_batch_chunked", "_fit_theta_restarts", "factorize"):
        record(name)
    bounds, X, y = bench_data()
    gpr = gpm.GaussianProcessRegressor(
        bounds=bounds, preprocessing_X=Normalize_bounds(bounds),
        preprocessing_y=Normalize_y(), random_state=0, verbose=1)
    gpr.append_to_data(X, y, fit_gpr=False)
    gpr.fit_gpr_hyperparameters(n_restarts=10 + 2 * D)
    fits = {}
    for label, kw in (("full", {"n_restarts": 10 + 2 * D}),
                      ("simple", {"simple": True})):
        calls.clear()
        fused.reset_launch_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        gpr.fit_gpr_hyperparameters(**kw)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = {k: v for k, v in fused.LAUNCHES.items() if v}
        phases, polished = [], False
        for c in list(calls):
            phase = PHASE_OF.get(c["name"]) or \
                ("rescore" if polished else "screen")
            polished = polished or c["name"] == "_fit_theta_restarts"
            phases.append(profile_call(phase, c))
        fits[label] = {"wall_s": wall, "kernel_launches": launches,
                       "lml": float(gpr.log_marginal_likelihood_value_),
                       "phases": phases}
        print(f"[FIT] {label}: {wall:.4f} s; " + "; ".join(
            f"{p['phase']} {p['s']:.4f} s ({p['host_syncs']} syncs, "
            f"{p['device_ops']} device ops, busy {p['busy_ms']:.2f} ms)"
            for p in phases), flush=True)
    card = card_line()
    print(card)
    print(json.dumps({"tree": tree, "card": card, "fits": fits}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
