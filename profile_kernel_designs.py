"""
K10's two routes and K6's designs side by side, on one CUDA card, each
other design from a scratch build of the kernel's source with one line
changed.

    python3 profile_kernel_designs.py [--quick]

The kernels fix their design: K10 (lml_value_grad) keeps the triangle in
shared memory (route 0, one block an SM) for the fast families wherever it
fits and in the block's global workspace (route 1, two blocks an SM) for a
spec program from K10_ROUTE1_N = 160 rows on; K6 (ns_slice_chains)
evaluates K6_WIDTH = 4 shrink candidates a pass and runs a chain in one
block (fast families) or a cluster of two (a spec program, k6_cluster).
Each variant of VARIANTS copies ``gpry_tpu_torch/csrc/`` into the
git-ignored ``gpry_tpu_torch/_build/variants/<name>/``, replaces one line
there (which must occur once), compiles that one source into a library of
its own (all variants at once) and, while it is timed, serves the
wrapper's calls of that kernel from it.

K10 (value mode) at the fit's screen (chip_smoke's k10_screen_inputs:
2,048 theta rows, d = 8) at n = 96 to 236, as built and with every n on
route 0 where it fits or on route 1, beside the route it replaced (K3,
cholesky_ex, solve_triangular) at n = 224; RBF and ALL_NODES: ms a call
and the blocks an SM holds.  K6 (chip_smoke's k6_inputs: B = 66 and 33
chains, R = 40 repeats, the SVM fitted) as built and in each variant: its
device ms (torch.profiler) and passes a repeat; each variant's calls must
equal the build's and its x and lx agree within chip_smoke.TOL_K6 (K10:
the same NaN rows).  Prints the card's name and power limit, then one
line per point; ``--quick`` times fewer points.
"""

import argparse
import contextlib
import ctypes
import os
import shutil
import subprocess
import sys

import torch

import chip_smoke as cs

# name: (source, the line as built, the line in the variant)
VARIANTS = {
    "k10_route0": ("lml_value_grad.cu", "#define K10_ROUTE1_N 160",
                   "#define K10_ROUTE1_N (1 << 30)"),
    "k10_route1": ("lml_value_grad.cu",
                   "  if (route == 0 && spec > 0 && n >= K10_ROUTE1_N) {",
                   "  if (route == 0) {"),
    "k6_width2": ("ns_slice_chains.cu", "#define K6_WIDTH 4",
                  "#define K6_WIDTH 2"),
    "k6_width8": ("ns_slice_chains.cu", "#define K6_WIDTH 4",
                  "#define K6_WIDTH 8"),
    "k6_cluster_swapped": ("ns_slice_chains.cu", "  return spec ? 2 : 1;",
                           "  return spec ? 1 : 2;"),
}
# the C entry points each source serves
ENTRIES = {"lml_value_grad.cu": ("gpry_lml_value_grad_plan",
                                 "gpry_lml_value_grad"),
           "ns_slice_chains.cu": ("gpry_ns_slice_chains",
                                  "gpry_ns_slice_chains_work")}


def build_variants(fused, names):
    """Each variant's library path, all compiled at once."""
    root = os.path.join(fused._BUILD, "variants")
    cmds, libs = [], {}
    for name in names:
        src, old, new = VARIANTS[name]
        out = os.path.join(root, name)
        shutil.rmtree(out, ignore_errors=True)
        shutil.copytree(fused._CSRC, out)
        path = os.path.join(out, src)
        with open(path) as f:
            text = f.read()
        if text.count(old) != 1:
            raise RuntimeError(f"{name}: {old!r} is not in {src} once")
        with open(path, "w") as f:
            f.write(text.replace(old, new))
        libs[name] = os.path.join(out, "lib.so")
        cmds.append([fused._nvcc(), *fused.NVCC_FLAGS, "-shared", "-o",
                     libs[name], path])
    fused._run_all(cmds)
    return libs


class Variant:
    """The kernel library with one source's entry points taken from a
    variant's library (the same argument types)."""

    def __init__(self, base, path, src):
        lib = ctypes.CDLL(path)
        self._base, self._own = base, {}
        for entry in ENTRIES[src]:
            fn, ref = getattr(lib, entry), getattr(base, entry)
            fn.argtypes, fn.restype = ref.argtypes, ref.restype
            self._own[entry] = fn

    def __getattr__(self, name):
        return self._own.get(name) or getattr(self._base, name)


@contextlib.contextmanager
def serving(fused, lib):
    """The wrappers call ``lib`` (a Variant, or the build's library)."""
    base = fused.library()
    fused._lib = lib
    try:
        yield
    finally:
        fused._lib = base


def k10_lines(fused, dev, libs, quick):
    base = fused.library()
    plan = fused.lml_value_grad_plan
    for fam, tag in (("rbf", "rbf"), (cs.spec_kernel()[0], "spec")):
        kern = fused._kern(fam, cs.D, dev)
        sd = fused._spec_doubles(kern)
        for n in ((224,) if quick else (96, 128, 160, 192, 224, 236)):
            thetas, X, y, _, noise = cs.k10_screen_inputs(fam, dev, n=n)
            ref = None
            for name in (None, "k10_route0", "k10_route1"):
                lib = base if name is None else \
                    Variant(base, libs[name], "lml_value_grad.cu")
                sx, sm, wk, per_sm = ctypes.c_int(), ctypes.c_size_t(), \
                    ctypes.c_size_t(), ctypes.c_int()
                route = lib.gpry_lml_value_grad_plan(
                    kern, n, cs.D, 0, ctypes.byref(sx), ctypes.byref(sm),
                    ctypes.byref(wk), ctypes.byref(per_sm))
                # the host mirror plans the build's routes; a variant's
                # calls take the variant's
                fused.lml_value_grad_plan = \
                    plan if name is None else lambda *a, r=route: (r,)
                call = lambda: fused.lml_value_grad(fam, thetas, X, y, n,
                                                    noise)
                try:
                    with serving(fused, lib):
                        out = call()
                        ms = cs.time_ms(call, 10)
                finally:
                    fused.lml_value_grad_plan = plan
                if ref is None:
                    ref = out
                elif not torch.equal(torch.isnan(out), torch.isnan(ref)):
                    raise AssertionError(f"K10 {name}: NaN rows differ")
                print(f"K10 {tag} n={n} {name or 'as built'}: route "
                      f"{route}, {ms:.4f} ms, {per_sm.value} blocks an SM, "
                      f"{sm.value} B shared", flush=True)
            if n == cs.N:
                route_ms = cs.time_ms(lambda: fused.lml_of_K(
                    fused.masked_kernel_matrix_batched(fam, thetas, X, n,
                                                       noise), y, n), 3)
                print(f"K10 {tag} n={n}: the route replaced {route_ms:.4f} "
                      f"ms; the build takes route {plan(n, cs.D, sd)[0]}",
                      flush=True)


def k6_lines(fused, dev, libs, quick):
    base = fused.library()
    names = (None, "k6_width2", "k6_width8", "k6_cluster_swapped")
    for fam, tag in (("rbf", "rbf"), (cs.spec_kernel()[0], "spec")):
        for B in ((66,) if quick else (66, 33)):
            p, args = cs.k6_inputs(fam, dev, B, seed=B)
            x0, lx0, c0 = fused.ns_slice_chains(fam, p, *args)
            for name in names:
                lib = base if name is None else \
                    Variant(base, libs[name], "ns_slice_chains.cu")
                call = lambda: fused.ns_slice_chains(fam, p, *args,
                                                     return_passes=True)
                with serving(fused, lib):
                    x, lx, calls, passes = call()
                    torch.cuda.synchronize()
                    ms = cs.kernel_device_ms(call, "ns_slice_chains", 10)
                if not torch.equal(calls, c0):
                    raise AssertionError(f"K6 {name}: calls differ")
                for a, b in ((x, x0), (lx, lx0)):
                    if cs.rel_err(a.reshape(-1), b.reshape(-1))[1] \
                            > cs.TOL_K6:
                        raise AssertionError(f"K6 {name}: x or lx differ")
                reps = B * cs.K6_R
                print(f"K6 {tag} B={B} {name or 'as built'}: {ms:.4f} ms "
                      f"on the card, {int(passes.sum()) / reps:.3f} passes "
                      f"and {int(calls.sum()) / reps:.3f} calls a repeat",
                      flush=True)


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--quick", action="store_true")
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
    libs = build_variants(fused, VARIANTS)
    k10_lines(fused, dev, libs, args.quick)
    k6_lines(fused, dev, libs, args.quick)
    return 0


if __name__ == "__main__":
    sys.exit(main())
