"""
K9 and K11 on each side of their routes' edges, on one CUDA card.

    python3 profile_lbfgs_routes.py [--maxiter 3]
    python3 profile_lbfgs_routes.py --budget
    python3 profile_lbfgs_routes.py --rounding

K9 (lbfgs_logexp_ascent: chip_smoke.k9_inputs, 8 lanes, d = 8) at the
last n of each route and the first n of the next (route 0 stages L in
shared memory; routes 1 and 2 stream it through a ring of 4 or 2 tiles),
and K11 (lbfgs_lml_fit: path h's draw, chip_smoke.fit_data, 8 lanes) at
the last n of route 0, the first of route 1 and n = 1,700, RBF and
ALL_NODES, each over ``--maxiter`` iterations.  Prints the card's name and
power limit, then per point the route, the ms per call (CUDA events, one
warm-up and 3 calls), the evaluations of the slowest lane (nev) and the
ms per such evaluation, which is what a route changes.

With ``--budget``, instead, the fit's two kernels once each at the
default budget of d = 48, n = 23,278 (chip_smoke.big_surrogate, RBF),
where a row's or a lane's triangle (2.2 GB) lives in global memory: K10
at R = 2 theta rows (the surrogate's and 0.1 above) and K11 on one lane
from the surrogate's theta + 0.2 at maxiter 0 (its start's value and
gradient: one evaluation), each against its plain version by row panels
(chip_smoke.lml_panels, lbfgs_lml_fit_panels: the whole (n, n, d)
difference tensor would be 208 GB), with their seconds (host clock
around the call and a synchronize), relative errors and the clusters
they ran on; then K11 on 2 and on 8 lanes from that start (each lane's
f against the 1-lane run's: the same bits on the same cluster size).  chip_smoke.py runs K10 and
K11 at n = BIG_FIT_N, within its time limit.

With ``--rounding``, instead, K9's endpoints at d = 33, 40 and 64 against
two runs of its plain version, on the card and on the CPU (the same
arithmetic summed in another order), by chip_smoke.k9_ends: RBF and
all_nodes(d), k9_inputs at seeds 19-23 (d = 40) and 19 (d = 33, 64),
maxiter 100.  Per case: the lanes where the two plain runs end together
(stable), on how many of them the kernel's lane ends with them (x within
TOL_K9_X of the box width, f within TOL_K9_F (1 + |f|)), on how many
others it ends with the card's plain run, and the largest x distances,
kernel to card and CPU to card, on the other lanes.
"""

import argparse
import subprocess
import sys

import torch

import chip_smoke as cs


def edge(plan, route):
    """The last n that ``plan`` (n -> (route, ...)) puts on ``route``."""
    n = 1
    while plan(n + 1)[0] <= route:
        n += 1 if n < 400 else 64
    while plan(n)[0] > route:
        n -= 1
    return n


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--maxiter", type=int, default=3)
    ap.add_argument("--budget", action="store_true")
    ap.add_argument("--rounding", action="store_true")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("needs a CUDA card", file=sys.stderr)
        return 1
    from gpry_tpu_torch import config
    from gpry_tpu_torch.ops import fused
    config.set_device("cuda")
    dev = torch.device("cuda")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip().splitlines()[0])
    fused.build()
    if args.budget:
        return budget(dev)
    if args.rounding:
        return rounding(dev)
    for fam, tag in (("rbf", "rbf"), (cs.spec_kernel()[0], "spec")):
        kern = fused._kern(fam, cs.D, dev)
        sd = fused._spec_doubles(kern)
        k9 = lambda n: fused.lbfgs_logexp_ascent_plan(n, cs.D, sd)
        ns = []
        for r in (0, 1):
            e = edge(k9, r)
            ns += [e, e + 1]
        for n in ns:
            p, a = cs.k9_inputs(fam, dev, seed=19, n=n)
            call = lambda: fused.lbfgs_logexp_ascent(fam, p, *a,
                                                     maxiter=args.maxiter)
            ms = cs.time_ms(call, 3)
            nev = int(call()[2].max())
            print(f"K9  {tag:4s} n {n:6d} route {k9(n)[0]}: {ms:10.3f} ms, "
                  f"nev {nev:3d}, {ms / nev:8.4f} ms an evaluation")
            del p, a
            torch.cuda.empty_cache()
        k11 = lambda n: fused.lbfgs_lml_fit_plan(n, cs.D, kern.ntheta, sd)
        e = edge(k11, 0)
        for n in (e, e + 1, 1700):
            gpr, t = cs.fit_data(dev, n=n)
            lo, hi, th0 = cs.k11_starts(fam, gpr, 8)
            fa = (fam, gpr._dX, gpr._dy, n, gpr._noise_t(), t(th0), t(lo),
                  t(hi))
            call = lambda: fused.lbfgs_lml_fit(*fa, maxiter=args.maxiter)
            ms = cs.time_ms(call, 3)
            nev = int(call()[2].max())
            print(f"K11 {tag:4s} n {n:6d} route {k11(n)[0]}: {ms:10.3f} ms, "
                  f"nev {nev:3d}, {ms / nev:8.4f} ms an evaluation")
    return 0


def budget(dev):
    """K10 and K11 at d = cs.BIG_D, n = cs.BIG_N (the module docstring)."""
    import json
    from gpry_tpu_torch.ops import fused
    p, theta, X, y, noise = cs.big_surrogate(dev)
    n = cs.BIG_N
    thetas = torch.stack([theta, theta + 0.1])
    fused.reset_launch_counts()
    lml, s10 = cs.timed_once(lambda: fused.lml_value_grad(
        "rbf", thetas, X, y, n, noise))
    k10_clusters = dict(fused.CLUSTERS)
    ref, p10 = cs.timed_once(lambda: cs.lml_panels("rbf", thetas, X, y, n,
                                                   noise))
    print("K10 " + json.dumps({
        "d": cs.BIG_D, "n": n, "R": 2, "route": fused.lml_value_grad_plan(
            n, cs.BIG_D)[0], "s": 1e-3 * s10, "plain_s": 1e-3 * p10,
        "rel": cs.rel_err(lml, ref)[1], "clusters": k10_clusters}),
        flush=True)
    th0, lo, hi = (theta + 0.2)[None], theta - 2.0, theta + 2.0
    fused.reset_launch_counts()
    (tk, fk, nk), s11 = cs.timed_once(lambda: fused.lbfgs_lml_fit(
        "rbf", X, y, n, noise, th0, lo, hi, maxiter=0))
    (tr, fr, nr, _), p11 = cs.timed_once(lambda: cs.lbfgs_lml_fit_panels(
        "rbf", X, y, n, noise, th0, lo, hi, 0))
    print("K11 " + json.dumps({
        "d": cs.BIG_D, "n": n, "lanes": 1, "maxiter": 0,
        "route": fused.lbfgs_lml_fit_plan(n, cs.BIG_D, cs.BIG_D + 1)[0],
        "s": 1e-3 * s11, "plain_s": 1e-3 * p11, "nev": nk.tolist(),
        "nev_plain": nr.tolist(),
        "f_rel": float(torch.max(torch.abs(fk - fr)
                                 / (1 + torch.abs(fr)))),
        "clusters": dict(fused.CLUSTERS)}), flush=True)
    # 2 and 8 lanes from the same start: each lane's one evaluation on
    # its own cluster, every f the 1-lane run's bits
    for lanes in (2, 8):
        fused.reset_launch_counts()
        (_, fl, _), sl = cs.timed_once(lambda: fused.lbfgs_lml_fit(
            "rbf", X, y, n, noise, th0.expand(lanes, -1).contiguous(), lo,
            hi, maxiter=0))
        print("K11 " + json.dumps({
            "d": cs.BIG_D, "n": n, "lanes": lanes, "maxiter": 0,
            "s": 1e-3 * sl, "f_equal_1_lane": bool(torch.all(fl == fk[0])),
            "f_rel_1_lane": float(torch.max(torch.abs(fl - fk[0])
                                            / (1 + torch.abs(fk[0])))),
            "clusters": dict(fused.CLUSTERS)}), flush=True)
    return 0


def rounding(dev):
    """K9's endpoints against two plain runs (the module docstring)."""
    import json
    cases = [(33, 19), (64, 19)] + [(40, seed) for seed in range(19, 24)]
    for d, seed in cases:
        for fam in ("rbf", cs.spec_kernel(d)[0]):
            p, args = cs.k9_inputs(fam, dev, seed=seed, d=d)
            width = float(torch.max(args[4] - args[3]))
            (xs, f, _), (xr, fr, _, _), (xc, fc), stable = cs.k9_ends(
                fam, p, args)
            held = ((xs - xr).abs().amax(1) <= cs.TOL_K9_X * width) & (
                (f - fr).abs() <= cs.TOL_K9_F * (1 + fr.abs()))
            other = ~stable
            big = lambda t: float(t[other].max()) if bool(other.any()) \
                else 0.0
            print("K9 " + json.dumps({
                "family": "spec" if cs.is_spec(fam) else "rbf", "d": d,
                "seed": seed, "lanes": stable.numel(),
                "stable": int(stable.sum()),
                "held_on_stable": int((held & stable).sum()),
                "held_on_others": int((held & other).sum()),
                "others_max_dx_kernel": big((xs - xr).abs().amax(1)),
                "others_max_dx_cpu": big((xc - xr).abs().amax(1)),
                "best_f": [float(f.min()), float(fr.min()),
                           float(fc.min())]}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
