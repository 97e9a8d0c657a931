#!/usr/bin/env python3
"""
K1 (gated_mean) and K3 (masked_kernel_matrix_batched) split by phase on
one CUDA card.

    python3 profile_k1_k3.py [TREE]

TREE (default: this checkout) is a checkout whose ``gpry_tpu_torch`` is
split, as ``profile_ns_step.py`` splits K13 and K2: its ``csrc/`` is
copied into the git-ignored ``gpry_tpu_torch/_build/phases/`` of that
tree, a clock stamp (a block barrier, then thread 0 of one block adds the
``clock64()`` cycles since the last stamp to the phase that stamp
started) goes before each anchor of PHASES that the source has, and the
stamped source, compiled into a library of its own, serves the wrapper's
calls of that kernel while they are split.  The shipped sources carry no
stamp.

K1 at nq = 66, 2,000 and 65,536 (chip_smoke's RBF and ALL_NODES
surrogates, n = 224, d = 8, the SVM fitted; block 0, rank 0 of its
cluster): the prologue (the length scales or the spec program, the first
tile's copies, the trust box's packing of the queries, their
coordinates), the staging of each tile (the
wait for its copies, the division by the length scales, the tile barrier,
the next tile's copies), the pair loop, and the combine (the partial sums
through shared or distributed shared memory, the gates, the store).  K3
at R = 1 (the whole matrix) and as the panels of appends of 1 and 8
points (block 1: the second column tile of the first row tile, valid
entries): the staging (the exponentials of theta, the points' loads and
divisions, the barrier), the arithmetic and the stores (a spec
program's stores fall in its arithmetic).  Prints the
card's name and power limit, then one JSON line a shape: the kernel's
device ms as built
and with the stamps (``torch.profiler``), and each phase's share of the
stamped block's cycles and its device ms (the share times the stamped
kernel's device ms; the stamps' barriers are in it).
"""

import json
import os
import subprocess
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
# per source: (phase that starts at the anchor, anchor, before it or after
# it); an anchor a source lacks is skipped
PHASES = {
    "gated_mean.cu": (
        ("prologue", "  // this block's share [lo, hi) of the row stream", 0),
        ("stage", "    __pipeline_wait_prior(0);\n    if constexpr (!SPEC) {",
         0),
        ("pairs", "    for (int u = warp; u < L * C; u += W) {", 0),
        ("combine", "  // the partial sums meet", 0),
        ("end", "  // the other ranks' sums stay until rank 0 has read "
                "them", 0)),
    "masked_kernel_matrix.cu": (
        ("stage", "  const double* th = a.thetas + (size_t)r * "
                  "a.kern.ntheta;", 0),
        ("arithmetic", "  const double variance = exp(th0);", 0),
        ("stores", "  // the tile's stores", 0),
        ("end", "}\n\n// thetas: R rows of kern.ntheta entries", 0)),
}
K1_NQ = (66, 2000, 65536)
K3_PANELS = (1, 8)


def main():
    tree = os.path.abspath(sys.argv[1]) if len(sys.argv) > 1 else HERE
    sys.path[:0] = [tree, HERE, os.path.join(HERE, "tests")]
    import numpy as np
    import torch
    if not torch.cuda.is_available():
        print("profile_k1_k3.py needs a CUDA card.", file=sys.stderr)
        return 3
    import chip_smoke as cs
    import profile_ns_step as pns
    from gpry_tpu_torch import config
    from gpry_tpu_torch.ops import fused
    dev = config.set_device("cuda")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip().splitlines()[0])
    pns.PHASES.update(PHASES)
    base = fused.library()
    stamps = pns.STAMPS
    rng = np.random.default_rng(13)
    t = lambda a: torch.as_tensor(np.asarray(a, float), dtype=torch.float64,
                                  device=dev)

    # K1: block 0 (rank 0 of its cluster)
    lib, names = pns.stamped_library(fused, "gated_mean.cu")
    serving = pns.Serving(base, lib, "gpry_gated_mean")
    for fam, tag in (("rbf", "rbf"), (cs.spec_kernel()[0], "spec")):
        p = cs.synthetic_surrogate(fam, dev, seed=11)
        sd = fused._spec_doubles(fused._kern(fam, cs.D, dev))
        for nq in K1_NQ:
            Xq = t(rng.uniform(-5, 5, (nq, cs.D)))
            out = {"kernel": "gated_mean", "family": tag, "tree": tree,
                   "nq": nq, "n": cs.N, "d": cs.D}
            if hasattr(fused, "gated_mean_plan"):
                out["plan"] = fused.gated_mean_plan(nq, cs.N, cs.NSV, cs.D,
                                                    sd)[:5]
            out.update(pns.split(cs, fused, lib, names, serving,
                                 lambda: fused.gated_mean(fam, p, Xq),
                                 "gated_mean"))
            print(json.dumps(out), flush=True)

    # K3: block 1 (the second column tile of the first row tile)
    pns.STAMPS = stamps.replace(
        "threadIdx.x == 0 && blockIdx.x == 0",
        "threadIdx.x == 0 && threadIdx.y == 0 && blockIdx.x == 1")
    assert pns.STAMPS != stamps
    lib, names = pns.stamped_library(fused, "masked_kernel_matrix.cu")
    pns.STAMPS = stamps
    serving = pns.Serving(base, lib, "gpry_masked_kernel_matrix")
    X = np.zeros((cs.NMAX, cs.D))
    X[:cs.N] = rng.uniform(0, 1, (cs.N, cs.D))
    X = t(X)
    noise = t(1e-4)
    panel = "rows" in fused.masked_kernel_matrix_batched.__code__.co_varnames
    for fam, tag in (("rbf", "rbf"), (cs.spec_kernel()[0], "spec")):
        theta = np.asarray(cs.spec_kernel()[1]) if tag == "spec" else \
            np.log([1.0] + [0.5] * cs.D)
        th = t(theta[None])
        shapes = [("R=1", {})]
        if panel:
            shapes += [(f"panel k={k}", {"rows": (cs.N - k, cs.N)})
                       for k in K3_PANELS]
        for label, kw in shapes:
            out = {"kernel": "masked_kernel_matrix_batched", "family": tag,
                   "tree": tree, "shape": label, "n": cs.N,
                   "nmax": cs.NMAX, "d": cs.D}
            out.update(pns.split(
                cs, fused, lib, names, serving,
                lambda: fused.masked_kernel_matrix_batched(fam, th, X, cs.N,
                                                           noise, **kw),
                "masked_kernel"))
            print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
