#!/usr/bin/env python3
"""
K4 (kriging_believer_fill) and K12 (mcmc_chains) split on one CUDA card.

    python3 profile_fill_mcmc.py [TREE]

TREE (default: this checkout) is a checkout whose ``gpry_tpu_torch`` is
split; the stamps are profile_ns_step.py's (a copy of the tree's
``csrc/`` with a clock stamp before each anchor of PHASES below, compiled
into a library of its own that serves one entry point).  Prints the
card's name and power limit, then one JSON line a measurement:

* K4 at chip_smoke's check_k4 inputs (N = 4,096 candidates, a pool of 8,
  n = 224 of nmax = 320, d = 8; LogExp, scalar noise), RBF and ALL_NODES:
  a fill's ms (CUDA events) and each of its 15 launches' device ms in
  launch order (select 0, then sweep and select a round; torch.profiler,
  10 fills); the sweep's device ms with every candidate alive, with every
  other one dead from the start (they ride in their blocks), and over the
  alive half alone (N = 2,048: what a compacted list would sweep); the
  sweep split by phase (RBF; block 0's stamps over a fill's 7 sweeps).
* K12 at path d's ensemble (check_k12's inputs: d = 8, 16 chains, the
  SVM all finite, n = 224; RBF and ALL_NODES): each phase's device ms
  (torch.profiler, 3 launches) as built and by warps a chain (1, 2, 4, 8),
  the warm-up on a cluster of 8 blocks, the same by warps a chain at n =
  4,000 (the SVM fitted in a ball, X / l in global memory), and each phase
  split by step part (RBF, path d's shape; the stamps time warp 0's path,
  the chain's critical one).  The kernel fixes its warps a chain and its
  cluster by plan; each other choice is timed from a scratch build of
  ``mcmc_chains.cu`` with one line replaced (profile_kernel_designs.py's
  variants, K12_VARIANTS below), which serves the wrapper's calls.
"""

import json
import os
import subprocess
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
# per source: (phase that starts at the anchor, anchor, before it or after
# it); profile_ns_step.py's stamps read them (its subst_blocked.cuh
# anchors split the sweep's panels)
PHASES = {
    "kriging_believer_fill.cu": (
        ("queries", "  const GprySpec spec =\n      kb_queries<SPEC>(", 0),
        ("kvec", "  // dead candidates ride: their columns are solved", 0),
        ("rows", "  // the alive candidates' solved rows, for the select", 0),
        ("epilogue", "  for (int qi = tid; qi < nqb; qi += blockDim.x)  "
                     "// at most once a thread", 0),
        ("end", "                      sub.sumsq[qi]);\n", 1)),
    "mcmc_chains.cu": (
        ("ring", "    k12_wait_ring(a.g.ring);\n", 0),
        ("proposal", "    bool ok = s.svm_mode != GPRY_MODE_NONE_FINITE;\n",
         0),
        ("evaluation", "  const double lpp = k12_group_mean<SPEC>(s, spec, "
                       "w);\n", 0),
        ("accept_store", "  const double lp_b = *lpb;\n", 0),
        ("fetch", "  k12_fetch(a, w, more, i_next, b_next, slot);\n", 0),
        ("couple", "      cluster.sync();\n      // the B accept flags", 0),
        ("moments", "    k12_moments(a, rank, part);\n", 0),
        ("end", "  if (rank == 0 && tid == 0) *a.log_step_out = log_step;",
         0)),
}
REPS = 10
# K12's other designs: (source, the line as built, the line in the variant)
K12_VARIANTS = {
    **{f"k12_warps{w}": (
        "mcmc_chains.cu",
        "  g->warps = k12_warps_per_chain(n, nsv_eff, g->chains);",
        f"  g->warps = {w};") for w in (1, 2, 4, 8)},
    "k12_cluster8": ("mcmc_chains.cu", "#define K12_MAX_CLUSTER 16",
                     "#define K12_MAX_CLUSTER 8")}


def launch_ms(fn, prefix, reps):
    """Device ms of each launch of ``fn`` whose kernel name starts with
    ``prefix`` (after "void "), in launch order, averaged over ``reps``
    calls (torch.profiler, CUDA activity); None if the trace held none."""
    import torch
    from torch.autograd import DeviceType
    fn()
    torch.cuda.synchronize()
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    ev = sorted((e for e in prof.events()
                 if e.device_type == DeviceType.CUDA
                 and e.name.removeprefix("void ").startswith(prefix)),
                key=lambda e: e.time_range.start)
    if not ev or len(ev) % reps:
        return None
    per = len(ev) // reps
    return [{"kernel": ev[k].name.removeprefix("void ").split("(")[0],
             "ms": 1e-3 * sum(ev[r * per + k].time_range.elapsed_us()
                              for r in range(reps)) / reps}
            for k in range(per)]


def k4_lines(cs, fused, pns, base, dev, tree):
    import numpy as np
    from gpry_tpu_torch.acquisition.functions import LogExp
    acqf, noise_std = LogExp(dimension=cs.D), 0.01
    lexp = (acqf.zeta, noise_std)
    for fam, label in (("rbf", "rbf"), (cs.spec_kernel()[0], "all_nodes")):
        args = cs.k4_inputs(fam, dev, "scalar", np.random.default_rng(4),
                            acqf, noise_std)
        fill = lambda a=args: fused.kriging_believer_fill(fam, *a,
                                                          logexp=lexp)
        half = args[5].clone()
        half[1::2] = False
        dead = args[:5] + (half,) + args[6:]
        alive = tuple(a[0::2].contiguous() if i in (1, 2, 3, 4, 5) else a
                      for i, a in enumerate(args))
        out = {"kernel": "kriging_believer_fill", "tree": tree,
               "family": label, "N": cs.N_CAND, "size": cs.SIZE,
               "fill_ms": cs.time_ms(fill, 20),
               "launches": launch_ms(fill, "kb_", REPS),
               "sweep_device_ms": {
                   "all_alive": cs.kernel_device_ms(fill, "kb_sweep", REPS),
                   "half_dead_riding": cs.kernel_device_ms(
                       lambda: fused.kriging_believer_fill(
                           fam, *dead, logexp=lexp), "kb_sweep", REPS),
                   "alive_half_alone": cs.kernel_device_ms(
                       lambda: fused.kriging_believer_fill(
                           fam, *alive, logexp=lexp), "kb_sweep", REPS)}}
        print(json.dumps(out), flush=True)
        if label != "rbf":
            continue
        lib, names = pns.stamped_library(fused, "kriging_believer_fill.cu",
                                         ("subst_blocked.cuh",))
        serving = pns.Serving(base, lib, "gpry_kb_sweep")
        print(json.dumps({"kernel": "kriging_believer_fill sweep split",
                          "tree": tree, "family": label,
                          **pns.split(cs, fused, lib, names, serving, fill,
                                      "kb_sweep")}), flush=True)


def k12_lines(cs, fused, pns, base, dev, tree):
    import torch
    import profile_kernel_designs as pkd
    from gpry_tpu_torch.mc.mcmc import sampling_factor
    pkd.VARIANTS.update(K12_VARIANTS)
    pkd.ENTRIES["mcmc_chains.cu"] = ("gpry_mcmc_chains",
                                     "gpry_mcmc_chains_work")
    libs = pkd.build_variants(fused, K12_VARIANTS)
    variant = {name: pkd.Variant(base, path, "mcmc_chains.cu")
               for name, path in libs.items()}

    def timed(call, name=None):
        lib = base if name is None else variant[name]
        with pkd.serving(fused, lib):
            return cs.kernel_device_ms(call, "mcmc_chains_kernel", 3)
    for fam0, label in (("rbf", "rbf"), ("spec", "all_nodes")):
        for svm, n, nmax in (("all_finite", cs.N, cs.NMAX),
                             ("ball",) + cs.K12_BIG):
            fam = cs.spec_kernel(cs.D)[0] if fam0 == "spec" else fam0
            p, x0, lp0, draws, lo, hi = cs.k12_inputs(
                fam, dev, svm, cs.D, 16, n, nmax, "profile")
            zw, uw, zs, us, chol0 = draws
            step0 = torch.zeros((), dtype=torch.float64, device=dev)
            w = fused.mcmc_chains(fam, p, x0, lp0, step0, chol0, zw, uw, lo,
                                  hi, True)
            chol_w = sampling_factor(w[3], w[4], zw.shape[0] * 16, chol0)

            def phase(adapt):
                if adapt:
                    return lambda: fused.mcmc_chains(
                        fam, p, x0, lp0, step0, chol0, zw, uw, lo, hi, True)
                return lambda: fused.mcmc_chains(fam, p, *w[:3], chol_w, zs,
                                                 us, lo, hi, False)

            out = {"kernel": "mcmc_chains", "tree": tree, "family": label,
                   "svm": svm, "n": n, "d": cs.D, "B": 16,
                   "steps": [cs.K12_WARMUP, cs.K12_SAMPLING]}
            out["warps=plan"] = [timed(phase(a)) for a in (True, False)]
            for wpc in (1, 2, 4, 8):
                out[f"warps={wpc}"] = [timed(phase(a), f"k12_warps{wpc}")
                                       for a in (True, False)]
            out["warm-up by cluster"] = {
                16: out["warps=plan"][0],
                8: timed(phase(True), "k12_cluster8")}
            print(json.dumps(out), flush=True)
            if label != "rbf" or n != cs.N:
                continue
            # a chain's warps part after its evaluation: the stamps sync a
            # warp, not the block, and time warp 0's path
            stamps = pns.STAMPS
            pns.STAMPS = stamps.replace("__syncthreads();", "__syncwarp();")
            try:
                lib, names = pns.stamped_library(fused, "mcmc_chains.cu")
            finally:
                pns.STAMPS = stamps
            serving = pns.Serving(base, lib, "gpry_mcmc_chains")
            for adapt in (True, False):
                print(json.dumps({
                    "kernel": "mcmc_chains split", "tree": tree,
                    "family": label,
                    "phase": "warm-up" if adapt else "sampling",
                    **pns.split(cs, fused, lib, names, serving, phase(adapt),
                                "mcmc_chains_kernel")}), flush=True)


def main():
    tree = os.path.abspath(sys.argv[1]) if len(sys.argv) > 1 else HERE
    sys.path[:0] = [tree, HERE, os.path.join(HERE, "tests")]
    import torch
    if not torch.cuda.is_available():
        print("profile_fill_mcmc.py needs a CUDA card.", file=sys.stderr)
        return 3
    import chip_smoke as cs
    import profile_ns_step as pns
    from gpry_tpu_torch import config
    from gpry_tpu_torch.ops import fused
    pns.PHASES.update(PHASES)
    pns.REPS = REPS
    dev = config.set_device("cuda")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip().splitlines()[0])
    base = fused.library()
    k4_lines(cs, fused, pns, base, dev, tree)
    k12_lines(cs, fused, pns, base, dev, tree)
    return 0


if __name__ == "__main__":
    sys.exit(main())
