"""
Where a multistart hyperparameter fit of path h's data ends, over the
orders of its training rows.

    python3 profile_k11_endpoints.py [--device cpu|cuda] [--orders 8]
                                     [--family matern32] [--lanes 8]

``chip_smoke.py check_k11`` ends by comparing K11's best -LML after
K11_MAXITER iterations with its plain version's on path h's data (8 lanes,
lane 0 at the incumbent theta, the rest uniform in the fit's box): the
same winning lane, or the best f within TOL_K11_END (1 + |f|) or the LML's
rounding spread at the two winners.  This script runs the plain version
(``fused.lbfgs_lml_fit_plain``) from those starts with the n training rows
taken in ``--orders`` orders (the first the identity, then seeded
permutations of the valid rows): the same matrix and the same algorithm,
only the summation order differs.  It prints, per order, the best f, its
lane and every lane's f and iterations, and, with ``--device cuda``, K11's
endpoint on the same order beside it; then the distinct best f it saw.
Where the plain version alone ends at more than one value, the end-of-run
comparison on that fixture is decided by rounding, not by the kernel.
"""

import argparse
import sys
import time

import numpy as np
import torch

import chip_smoke as cs


def endpoints(order, fam, gpr, t, lo, hi, th0, maxiter, kernel):
    """(best f, its lane, f, iterations) of the plain fit on the rows in
    ``order`` and, with ``kernel``, the same of K11."""
    from gpry_tpu_torch.ops import fused
    idx = torch.as_tensor(order, device=gpr._dX.device)
    noise = gpr._noise_t()
    args = (fam, gpr._dX[idx], gpr._dy[idx], cs.N,
            noise[idx] if noise.ndim else noise, t(th0), t(lo), t(hi))
    out = []
    for solver in ((fused.lbfgs_lml_fit_plain,)
                   + ((fused.lbfgs_lml_fit,) if kernel else ())):
        _, f, _, it = solver(*args, maxiter=maxiter, return_iters=True)
        f = torch.where(torch.isnan(f), torch.inf, f).cpu()
        out.append((float(f.min()), int(f.argmin()), f.tolist(),
                    it.cpu().tolist()))
    return out


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cpu")
    ap.add_argument("--orders", type=int, default=8)
    ap.add_argument("--family", default="matern32")
    ap.add_argument("--lanes", type=int, default=8)
    args = ap.parse_args()
    from gpry_tpu_torch import config
    config.set_device(args.device)
    dev = torch.device(args.device)
    if dev.type == "cpu":
        torch.set_num_threads(2)
    kernel = dev.type == "cuda"
    gpr, t = cs.fit_data(dev)
    lo, hi, th0 = cs.k11_starts(args.family, gpr, args.lanes)
    rng = np.random.default_rng(0)
    nmax = gpr._dX.shape[0]
    print(f"path h's data: n = {cs.N} of nmax = {nmax}, d = {cs.D}, "
          f"{args.family}, {args.lanes} lanes, maxiter {cs.K11_MAXITER}, "
          f"on {dev.type}")
    bests = []
    for k in range(args.orders):
        order = np.arange(nmax)
        if k:
            order[:cs.N] = rng.permutation(cs.N)
        t0 = time.perf_counter()
        res = endpoints(order, args.family, gpr, t, lo, hi, th0,
                        cs.K11_MAXITER, kernel)
        for name, (best, win, f, it) in zip(("plain", "K11"), res):
            print(f"order {k} {name:5s}: best f {best:.12g} (lane {win}); "
                  f"f {['%.9g' % v for v in f]}; iterations {it}")
        print(f"order {k}: {time.perf_counter() - t0:.1f} s")
        bests.append(res[0][0])
    vals = sorted({round(b, 9) for b in bests})
    print(f"plain best f over {args.orders} orders: {vals} "
          f"(spread {max(bests) - min(bests):.6g})")
    return 0


if __name__ == "__main__":
    sys.exit(main())
