#!/usr/bin/env python3
"""
K5 (meanvar_ungated) and K8 (meanstd_grad) on their route 0, split by
phase, and two other designs of K8, on one CUDA card.

    python3 profile_k5_k8.py [TREE]

TREE (default: this checkout) is a checkout whose ``gpry_tpu_torch`` is
split, as ``profile_ns_step.py`` splits K13 and K2: its ``csrc/`` is
copied into the git-ignored ``gpry_tpu_torch/_build/phases/`` of that
tree, a clock stamp (a block barrier, then thread 0 of block 0 adds the
``clock64()`` cycles since the last stamp to the phase that stamp
started) goes before each anchor of PHASES that the sources have (K5's
and K8's route 0 is one body, ``sub_ungated`` of subst_blocked.cuh), and
the stamped source, compiled into a library of its own, serves the
wrapper's calls of that kernel while they are split.  The shipped
sources carry no stamp.  K5 at nq = 1, 256 and 4,096, K8 at nq = 8 and
1,024 (chip_smoke's RBF and ALL_NODES surrogates, n = 224 of nmax = 320,
d = 8, queries over [-5, 5]^8): the prologue (the spec program, the
length scales, the queries), the k vectors and k . alpha, the forward
substitution, K5's outputs; K8's back substitution, the training rows
staged again, the gradient sweep, the threads' reduction and the outputs.
One JSON line a shape: the kernel's device ms as built and stamped
(``torch.profiler``), each phase's share of block 0's stamped cycles and
its ms.

Then K8 at nq = 1,024 in two scratch builds, each one source of a copy
of ``csrc/`` with a few lines replaced (VARIANTS; the kernels fix their
design, so these serve the wrapper through a stand-in library as
``profile_kernel_designs.py`` does): ``k8_q16`` takes 16 queries a block
where the plan takes 8 (64 blocks at 1,024 instead of 128), and
``k8_expanded`` sums the gradient as q_k sum_j alpha_j c_j - sum_j
alpha_j c_j x_jk (and w likewise), the expanded product that a
tensor-core form would need, where the build sums alpha_j c_j (q_k -
x_jk).  Device ms as built, in the variant, in the variant and as built
again; each variant's largest gradient error against the plain version
(relative to max |.|, chip_smoke's TOL_K8_GRAD measure) beside the
build's, on chip_smoke's surrogate and on one whose length scales are
three times as long (RBF: alpha larger and cancelling); ``k8_expanded``
at RBF only (a spec program's sums are the interpreter's, unchanged).
Prints the card's name and power limit first.
"""

import json
import os
import shutil
import subprocess
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
# per source: (phase that starts at the anchor, anchor, before it or after
# it); the body of both kernels' route 0 is in subst_blocked.cuh
PHASES = {
    "meanvar_ungated.cu": (),
    "meanstd_grad.cu": (),
    "subst_blocked.cuh": (
        ("prologue", "  const GprySub sub = sub_carve(a.L, n, a.nmax, Q,",
         0),
        ("build_k", "  // the k vectors as the rows of V, k . alpha a warp "
                    "a query", 0),
        ("forward", "  // V = L^-1 K\n", 0),
        ("out", "    for (int qi = tid; qi < nqb; qi += blockDim.x)\n"
                "      sub_ungated_out", 0),
        ("end", "                            ms[qi], sub.sumsq[qi]);\n", 1),
        ("backward", "    // W = L^-T L^-1 K\n", 0),
        ("restage", "    // the training rows again", 0),
        ("sweep", "    // the gradient sweep: T threads", 0),
        ("reduce", "      // the T threads' sums", 0),
        ("epilogue", "      if (r == 0 && qi < nqb) {\n"
                     "        const int q = q0 + qi;", 0),
        ("end", "dsd * ((SPEC ? gprior[k] : 0.0) - 2.0 * sw) / "
                "a.x_scale[kk];\n          }\n      }\n    }\n", 1)),
}
K5_NQ, K8_NQ = (1, 256, 4096), (8, 1024)
# K8's other designs: (source compiled, file changed, [(old, new), ...])
VARIANTS = {
    "k8_q16": ("meanstd_grad.cu", "meanstd_grad.cu", [(
        "  if (sub_plan(nq, n, nmax, L, (size_t)d + gpry_spec_doubles(kern),"
        "\n               (size_t)d + 1, Q, smem) == 0)\n    return 0;\n"
        "  bool stage_x;",
        "  if (sub_plan(nq > SUB_Q16_NQ ? nq : SUB_Q16_NQ + 1, n, nmax, L,\n"
        "               (size_t)d + gpry_spec_doubles(kern), (size_t)d + 1,"
        " Q,\n               smem) == 0)\n    return 0;\n  bool stage_x;")]),
    "k8_expanded": ("meanstd_grad.cu", "subst_blocked.cuh", [
        ("      for (int k = 0; k < W; ++k) am[k] = aw[k] = 0.0;\n",
         "      for (int k = 0; k < W; ++k) am[k] = aw[k] = 0.0;\n"
         "      double sca = 0.0, scw = 0.0;\n"),
        ("          const double ca = c * al, cw = c * w;\n"
         "#pragma unroll\n"
         "          for (int k = 0; k < W; ++k)\n"
         "            if (k < kw) {\n"
         "              const int kk = k0 + k;\n"
         "              const double df = qv[kk] - (STX ? xj[kk] : xj[kk] / "
         "ls[kk]);\n"
         "              am[k] += ca * df;\n"
         "              aw[k] += cw * df;\n"
         "            }\n",
         "          const double ca = c * al, cw = c * w;\n"
         "          sca += ca;\n"
         "          scw += cw;\n"
         "#pragma unroll\n"
         "          for (int k = 0; k < W; ++k)\n"
         "            if (k < kw) {\n"
         "              const int kk = k0 + k;\n"
         "              const double xv = STX ? xj[kk] : xj[kk] / ls[kk];\n"
         "              am[k] -= ca * xv;\n"
         "              aw[k] -= cw * xv;\n"
         "            }\n"),
        ("      // the T threads' sums",
         "      if (!SPEC && qi < nqb) {\n"
         "#pragma unroll\n"
         "        for (int k = 0; k < W; ++k)\n"
         "          if (k < kw) {\n"
         "            am[k] += qv[k0 + k] * sca;\n"
         "            aw[k] += qv[k0 + k] * scw;\n"
         "          }\n"
         "      }\n"
         "      // the T threads' sums")]),
}
ENTRIES = ("gpry_meanstd_grad", "gpry_meanstd_grad_plan",
           "gpry_meanstd_grad_work")


def build_variants(fused):
    """Each variant's library path, all compiled at once."""
    root = os.path.join(fused._BUILD, "variants")
    cmds, libs = [], {}
    for name, (source, changed, reps) in VARIANTS.items():
        out = os.path.join(root, name)
        shutil.rmtree(out, ignore_errors=True)
        shutil.copytree(fused._CSRC, out)
        path = os.path.join(out, changed)
        with open(path) as f:
            text = f.read()
        for old, new in reps:
            if text.count(old) != 1:
                raise RuntimeError(f"{name}: {old!r} is not in {changed} "
                                   "once")
            text = text.replace(old, new)
        with open(path, "w") as f:
            f.write(text)
        libs[name] = os.path.join(out, "lib.so")
        cmds.append([fused._nvcc(), *fused.NVCC_FLAGS, "-shared", "-o",
                     libs[name], os.path.join(out, source)])
    fused._run_all(cmds)
    return libs


def grad_err(out, ref):
    """The larger of the two gradients' max |a - b| / max |b|."""
    import chip_smoke as cs
    return max(cs.rel_err(a.reshape(-1), b.reshape(-1))[1]
               for a, b in zip(out[2:], ref[2:]))


def main():
    tree = os.path.abspath(sys.argv[1]) if len(sys.argv) > 1 else HERE
    sys.path[:0] = [tree, HERE, os.path.join(HERE, "tests")]
    import numpy as np
    import torch
    if not torch.cuda.is_available():
        print("profile_k5_k8.py needs a CUDA card.", file=sys.stderr)
        return 3
    import chip_smoke as cs
    import profile_kernel_designs as pkd
    import profile_ns_step as pns
    from gpry_tpu_torch import config
    from gpry_tpu_torch.ops import fused
    from gpry_tpu_torch.ops.linalg import factorize
    dev = config.set_device("cuda")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip().splitlines()[0])
    pns.PHASES.update(PHASES)
    base = fused.library()
    rng = np.random.default_rng(15)
    t = lambda a: torch.as_tensor(np.asarray(a, float), dtype=torch.float64,
                                  device=dev)
    fams = (("rbf", "rbf"), (cs.spec_kernel()[0], "spec"))
    for source, entry, name, fn, nqs in (
            ("meanvar_ungated.cu", "gpry_meanvar_ungated", "meanvar_ungated",
             fused.meanvar_ungated, K5_NQ),
            ("meanstd_grad.cu", "gpry_meanstd_grad", "meanstd_grad",
             fused.meanstd_grad, K8_NQ)):
        lib, names = pns.stamped_library(fused, source,
                                         ("subst_blocked.cuh",))
        serving = pns.Serving(base, lib, entry)
        for fam, tag in fams:
            p = cs.synthetic_surrogate(fam, dev, seed=14)
            sd = fused._spec_doubles(fused._kern(fam, cs.D, dev))
            for nq in nqs:
                Xq = t(rng.uniform(-5, 5, (nq, cs.D)))
                out = {"kernel": name, "family": tag, "tree": tree,
                       "nq": nq, "n": cs.N, "nmax": cs.NMAX, "d": cs.D,
                       "plan": getattr(fused, name + "_plan")(
                           cs.N, cs.NMAX, cs.D, nq, sd)[:2]}
                out.update(pns.split(cs, fused, lib, names, serving,
                                     lambda: fn(fam, p, Xq), name))
                print(json.dumps(out), flush=True)

    libs = build_variants(fused)
    pkd.ENTRIES["meanstd_grad.cu"] = ENTRIES
    nq = 1024
    for fam, tag in fams:
        p = cs.synthetic_surrogate(fam, dev, seed=17)
        cases = {"synthetic": p}
        if tag == "rbf":
            th = p.theta.clone()
            th[1:] = th[1:] + np.log(3.0)
            L, alpha = factorize(fam, th, p.X, p.y, p.n, p.noise_var)
            cases["long"] = p.replace(theta=th, L=L, alpha=alpha)
        Xq = t(rng.uniform(-5, 5, (nq, cs.D)))
        Xq[:32] = p.X[:32] * p.x_scale + p.x_loc
        # the expanded form changes the fast families' sums only
        for variant in VARIANTS if tag == "rbf" else ("k8_q16",):
            lib = pkd.Variant(base, libs[variant], "meanstd_grad.cu")
            line = {"kernel": "meanstd_grad", "family": tag, "nq": nq,
                    "variant": variant, "grad_err": {}, "device_ms": []}
            for label, q in cases.items():
                ref = fused.meanstd_grad_plain(fam, q, Xq)
                err = {"as built": grad_err(fused.meanstd_grad(fam, q, Xq),
                                            ref)}
                with pkd.serving(fused, lib):
                    err[variant] = grad_err(fused.meanstd_grad(fam, q, Xq),
                                            ref)
                line["grad_err"][label] = err
            call = lambda: fused.meanstd_grad(fam, p, Xq)
            for use in (None, variant, variant, None):
                with pkd.serving(fused, base if use is None else lib):
                    line["device_ms"].append(cs.kernel_device_ms(
                        call, "meanstd_grad", 50))
            print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
