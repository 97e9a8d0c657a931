"""
K9 and K11 on each side of their routes' edges, on one CUDA card.

    python3 profile_lbfgs_routes.py [--maxiter 3]

K9 (lbfgs_logexp_ascent: chip_smoke.k9_inputs, 8 lanes, d = 8) at the
last n of each route and the first n of the next (route 0 stages L in
shared memory; routes 1 and 2 stream it through a ring of 4 or 2 tiles),
and K11 (lbfgs_lml_fit: path h's draw, chip_smoke.fit_data, 8 lanes) at
the last n of route 0, the first of route 1 and n = 1,700, RBF and
ALL_NODES, each over ``--maxiter`` iterations.  Prints the card's name and
power limit, then per point the route, the ms per call (CUDA events, one
warm-up and 3 calls), the evaluations of the slowest lane (nev) and the
ms per such evaluation, which is what a route changes.
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


if __name__ == "__main__":
    sys.exit(main())
