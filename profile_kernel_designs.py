"""
K10's two routes, K6's designs, K1's plan constants and K3's staging
side by side, on one CUDA card, each other design from a scratch build of
the kernel's source with one line (or a few) changed.

    python3 profile_kernel_designs.py [--quick] [--k1] [--k3]

The kernels fix their design: K10 (lml_value_grad) keeps the triangle in
shared memory (route 0, one block an SM) for the fast families wherever it
fits and in the block's global workspace (route 1, two blocks an SM) for a
spec program from K10_ROUTE1_N = 160 rows on; K6 (ns_slice_chains)
evaluates K6_WIDTH = 4 shrink candidates a pass and runs a chain in one
block (fast families) or a cluster of two (a spec program, k6_cluster).
Each variant of VARIANTS copies ``gpry_tpu_torch/csrc/`` into the
git-ignored ``gpry_tpu_torch/_build/variants/<name>/``, replaces one line
or block there (each must occur once), compiles that one source into a
library of
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

K1 (gated_mean) fixes its geometry by plan (k1_plan: the blocks of a
wave, the blocks of a launch with clusters, the rows a split keeps at
least, the largest cluster); each k1_ variant changes one of those or
the spec instance's launch bounds.
At K1_NQ (chip_smoke's RBF and ALL_NODES surrogates, queries over
[-5, 5]^8, the SVM fitted), as built and in each variant: the plan
(query warps a block, splits, cluster, tile rows, register instance) and
the device ms (torch.profiler), each variant's values within
chip_smoke.TOL_K1 of the plain version.  Then the register instance for
d 9-32 (as built) against the queries read from shared memory
(k1_smem_above_8) at d = 16 and 32 (RBF, n = 224, queries inside the
trust box).

K3 (masked_kernel_matrix_batched) stages its points by plain loads, the
first of each side issued before theta's and each point divided on its
way into shared memory, and a spec program stores each entry as the
interpreter returns it; k3_plain_loads issues no load ahead, k3_cp_async
copies the points by cp.async and divides them in place after the wait,
k3_spec_stores_after holds a spec program's four entries and stores them
after the last, as a fast family does.  At R = 1, the panels of appends
of 1 and 8 points and R = 2,048 (RBF and ALL_NODES, n = 224 of nmax =
320, d = 8), for each variant: the device ms as built, in the variant,
in the variant and as built again; the variant's output equal to the
build's.
``--k1`` and ``--k3`` run those kernels' lines alone.
"""

import argparse
import contextlib
import ctypes
import itertools
import os
import shutil
import subprocess
import sys

import numpy as np
import torch

import chip_smoke as cs

# K3's staging as built (plain loads, the first of each side before
# theta's), with no load ahead (k3_plain_loads), by cp.async
# (k3_cp_async)
K3_BUILT_STAGING = """\
  const double xa0 = tid < in * d ? Xi[tid] : 0.0;
  const double xb0 = tid < jn * d ? Xj[tid] : 0.0;
  int kl = tid % d;
  double lk = SPEC ? 1.0 : exp(th[1 + kl]);
  for (int idx = tid; idx < in * d; idx += K3_THREADS) {
    const int k = idx % d;
    if (!SPEC && k != kl) {
      lk = exp(th[1 + k]);
      kl = k;
    }
    const double x = idx == tid ? xa0 : Xi[idx];
    A[idx] = SPEC ? x : x / lk;
  }
  for (int idx = tid; idx < jn * d; idx += K3_THREADS) {
    const int t = idx / d, k = idx - t * d;
    if (!SPEC && k != kl) {
      lk = exp(th[1 + k]);
      kl = k;
    }
    const double x = idx == tid ? xb0 : Xj[idx];
    Bt[k * K3_TILE + t] = SPEC ? x : x / lk;
  }
"""
K3_PLAIN_STAGING = """\
  int kl = tid % d;
  double lk = SPEC ? 1.0 : exp(th[1 + kl]);
  for (int idx = tid; idx < in * d; idx += K3_THREADS) {
    const int k = idx % d;
    if (!SPEC && k != kl) {
      lk = exp(th[1 + k]);
      kl = k;
    }
    A[idx] = SPEC ? Xi[idx] : Xi[idx] / lk;
  }
  for (int idx = tid; idx < jn * d; idx += K3_THREADS) {
    const int t = idx / d, k = idx - t * d;
    if (!SPEC && k != kl) {
      lk = exp(th[1 + k]);
      kl = k;
    }
    Bt[k * K3_TILE + t] = SPEC ? Xj[idx] : Xj[idx] / lk;
  }
"""
K3_CP_ASYNC_STAGING = """\
  for (int idx = tid; idx < in * d; idx += K3_THREADS)
    __pipeline_memcpy_async(A + idx, Xi + idx, sizeof(double));
  for (int idx = tid; idx < jn * d; idx += K3_THREADS) {
    const int t = idx / d, k = idx - t * d;
    __pipeline_memcpy_async(Bt + k * K3_TILE + t, Xj + idx, sizeof(double));
  }
  __pipeline_commit();
  int kl = tid % d;
  double lk = SPEC ? 1.0 : exp(th[1 + kl]);
  __pipeline_wait_prior(0);
  if constexpr (!SPEC) {
    for (int idx = tid; idx < in * d; idx += K3_THREADS) {
      const int k = idx % d;
      if (k != kl) {
        lk = exp(th[1 + k]);
        kl = k;
      }
      A[idx] = A[idx] / lk;
    }
    for (int idx = tid; idx < jn * d; idx += K3_THREADS) {
      const int t = idx / d, k = idx - t * d;
      if (k != kl) {
        lk = exp(th[1 + k]);
        kl = k;
      }
      Bt[k * K3_TILE + t] = Bt[k * K3_TILE + t] / lk;
    }
  }
"""

# name: (source, the line as built, the line in the variant[, further
# (as built, in the variant) pairs])
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
    "k1_no_cluster": ("gated_mean.cu", "#define K1_MAX_CLUSTER 16",
                      "#define K1_MAX_CLUSTER 1"),
    "k1_wave_132": ("gated_mean.cu", "#define K1_WAVE_BLOCKS 264",
                    "#define K1_WAVE_BLOCKS 132"),
    "k1_wave_528": ("gated_mean.cu", "#define K1_WAVE_BLOCKS 264",
                    "#define K1_WAVE_BLOCKS 528"),
    "k1_cluster_blocks_264": ("gated_mean.cu",
                              "#define K1_CLUSTER_BLOCKS 132",
                              "#define K1_CLUSTER_BLOCKS 264"),
    "k1_min_rows_4": ("gated_mean.cu", "#define K1_MIN_ROWS 2",
                      "#define K1_MIN_ROWS 4"),
    "k1_min_rows_8": ("gated_mean.cu", "#define K1_MIN_ROWS 2",
                      "#define K1_MIN_ROWS 8"),
    "k1_spec_3_blocks": ("gated_mean.cu",
                         "__global__ void __launch_bounds__(32 * K1_WARPS)",
                         "__global__ void __launch_bounds__(32 * K1_WARPS, "
                         "SPEC ? 3 : 1)"),
    "k1_smem_above_8": ("gated_mean.cu",
                        "  p->dq = spec ? 0 : d <= 8 ? 8 : d <= 32 ? 32 : 0;",
                        "  p->dq = spec ? 0 : d <= 8 ? 8 : 0;"),
    "k3_plain_loads": ("masked_kernel_matrix.cu", K3_BUILT_STAGING,
                       K3_PLAIN_STAGING),
    "k3_spec_stores_after": (
        "masked_kernel_matrix.cu",
        "    if constexpr (SPEC) {\n"
        "      // stored at once: no value is held across the interpreter's "
        "calls\n"
        "      if (i < r1 && j < nmax) out_r[(size_t)(i - r0) * nmax + j] = "
        "val;\n"
        "    } else {\n"
        "      v[s] = val;\n"
        "    }\n",
        "    v[s] = val;\n",
        ("  if constexpr (!SPEC) {\n#pragma unroll", "  {\n#pragma unroll")),
    "k3_cp_async": ("masked_kernel_matrix.cu", K3_BUILT_STAGING,
                    K3_CP_ASYNC_STAGING,
                    ('#include "common.cuh"',
                     '#include <cuda_pipeline.h>\n\n#include "common.cuh"')),
}
# K1's dimensions for the register instance against shared memory
K1_D = (16, 32)
# K1's batch sizes: the MCMC's start tries and kill batches, the NS
# prior phase, 16,384, the IS refine
K1_NQ = (16, 66, 400, 2000, 16384, 65536)
# the C entry points each source serves
ENTRIES = {"lml_value_grad.cu": ("gpry_lml_value_grad_plan",
                                 "gpry_lml_value_grad_cluster",
                                 "gpry_lml_value_grad"),
           "ns_slice_chains.cu": ("gpry_ns_slice_chains",
                                  "gpry_ns_slice_chains_work"),
           "gated_mean.cu": ("gpry_gated_mean", "gpry_gated_mean_plan"),
           "masked_kernel_matrix.cu": ("gpry_masked_kernel_matrix",)}


def build_variants(fused, names):
    """Each variant's library path, all compiled at once."""
    root = os.path.join(fused._BUILD, "variants")
    cmds, libs = [], {}
    for name in names:
        src, old, new, *more = VARIANTS[name]
        out = os.path.join(root, name)
        shutil.rmtree(out, ignore_errors=True)
        shutil.copytree(fused._CSRC, out)
        path = os.path.join(out, src)
        with open(path) as f:
            text = f.read()
        for old, new in ((old, new), *more):
            if text.count(old) != 1:
                raise RuntimeError(f"{name}: {old!r} is not in {src} once")
            text = text.replace(old, new)
        with open(path, "w") as f:
            f.write(text)
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
    plan, cluster = fused.lml_value_grad_plan, fused.lml_value_grad_cluster
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
                # the host mirror plans the build's routes and rows in
                # flight; a variant's calls take the variant's
                F, C, act = ctypes.c_int(), ctypes.c_int(), \
                    (ctypes.c_int * 5)()
                lib.gpry_lml_value_grad_cluster(
                    kern, thetas.shape[0], n, cs.D, 0, per_sm.value,
                    ctypes.byref(F), ctypes.byref(C), act)
                if name is not None:
                    fused.lml_value_grad_plan = lambda *a, r=route: (r,)
                    fused.lml_value_grad_cluster = \
                        lambda *a, fc=(F.value, C.value): fc
                call = lambda: fused.lml_value_grad(fam, thetas, X, y, n,
                                                    noise)
                try:
                    with serving(fused, lib):
                        out = call()
                        ms = cs.time_ms(call, 10)
                finally:
                    fused.lml_value_grad_plan = plan
                    fused.lml_value_grad_cluster = cluster
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


def k1_lines(fused, dev, libs):
    base = fused.library()
    names = [None] + [v for v in VARIANTS if v.startswith("k1_")
                      and v != "k1_smem_above_8"]
    rng = np.random.default_rng(13)
    for fam, tag in (("rbf", "rbf"), (cs.spec_kernel()[0], "spec")):
        p = cs.synthetic_surrogate(fam, dev, seed=11)
        kern = fused._kern(fam, cs.D, dev)
        for nq in K1_NQ:
            Xq = torch.as_tensor(rng.uniform(-5, 5, (nq, cs.D)),
                                 dtype=torch.float64, device=dev)
            ref = fused.gated_mean_plain(fam, p, Xq)
            for name in names:
                lib = base if name is None else \
                    Variant(base, libs[name], "gated_mean.cu")
                geo, sm = (ctypes.c_int * 5)(), ctypes.c_size_t()
                lib.gpry_gated_mean_plan(kern, nq, cs.N, cs.NSV, cs.D, geo,
                                         ctypes.byref(sm))
                call = lambda: fused.gated_mean(fam, p, Xq)
                with serving(fused, lib):
                    out = call()
                    ms = cs.kernel_device_ms(call, "gated_mean", 20)
                if cs.rel_err(out, ref)[1] > cs.TOL_K1:
                    raise AssertionError(f"K1 {name}: off the plain version")
                print(f"K1 {tag} nq={nq} {name or 'as built'}: plan "
                      f"{tuple(geo)}, {cs.fmt_ms(ms)} ms on the card",
                      flush=True)
    for d in K1_D:
        p = cs.synthetic_surrogate("rbf", dev, seed=d, d=d)
        kern = fused._kern("rbf", d, dev)
        for nq in (66, 2000, 65536):
            Xq = torch.as_tensor(rng.uniform(-4.4, 4.4, (nq, d)),
                                 dtype=torch.float64, device=dev)
            ref = fused.gated_mean_plain("rbf", p, Xq)
            for name in (None, "k1_smem_above_8", "k1_smem_above_8", None):
                lib = base if name is None else \
                    Variant(base, libs[name], "gated_mean.cu")
                geo, sm = (ctypes.c_int * 5)(), ctypes.c_size_t()
                lib.gpry_gated_mean_plan(kern, nq, cs.N, cs.NSV, d, geo,
                                         ctypes.byref(sm))
                call = lambda: fused.gated_mean("rbf", p, Xq)
                with serving(fused, lib):
                    out = call()
                    ms = cs.kernel_device_ms(call, "gated_mean", 20)
                if cs.rel_err(out, ref)[1] > cs.TOL_K1:
                    raise AssertionError(f"K1 {name}: off the plain version")
                print(f"K1 rbf d={d} nq={nq} {name or 'as built'}: plan "
                      f"{tuple(geo)}, {cs.fmt_ms(ms)} ms on the card",
                      flush=True)


def k3_lines(fused, dev, libs):
    base = fused.library()
    rng = np.random.default_rng(13)
    t = lambda a: torch.as_tensor(np.asarray(a, float), dtype=torch.float64,
                                  device=dev)
    X = np.zeros((cs.NMAX, cs.D))
    X[:cs.N] = rng.uniform(0, 1, (cs.N, cs.D))
    X, noise = t(X), t(1e-4)
    for fam, tag in (("rbf", "rbf"), (cs.spec_kernel()[0], "spec")):
        theta = np.asarray(cs.spec_kernel()[1]) if tag == "spec" else \
            np.log([1.0] + [0.5] * cs.D)
        thetas = t(theta + rng.uniform(-0.3, 0.3, (2048, len(theta))))
        shapes = [("R=1", thetas[:1], None)]
        shapes += [(f"panel k={k}", thetas[:1], (cs.N - k, cs.N))
                   for k in (1, 8)]
        shapes += [("R=2048", thetas, None)]
        for (label, th, rows), variant in itertools.product(
                shapes, [v for v in VARIANTS if v.startswith("k3_")]):
            call = lambda: fused.masked_kernel_matrix_batched(
                fam, th, X, cs.N, noise, rows=rows)
            ref, times = call(), []
            for name in (None, variant, variant, None):
                lib = base if name is None else \
                    Variant(base, libs[name], "masked_kernel_matrix.cu")
                with serving(fused, lib):
                    if not torch.equal(call(), ref):
                        raise AssertionError(f"K3 {name}: off the build")
                    times.append(cs.kernel_device_ms(
                        call, "masked_kernel_matrix",
                        10 if label == "R=2048" else 50))
            print(f"K3 {tag} {label}: device ms as built, {variant}, "
                  f"{variant}, as built: "
                  + ", ".join(f"{ms:.5f}" for ms in times), flush=True)


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--quick", action="store_true")
    ap.add_argument("--k1", action="store_true",
                    help="K1's variants alone (with --k3: and K3's)")
    ap.add_argument("--k3", action="store_true",
                    help="K3's variants alone (with --k1: and K1's)")
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
    every = not (args.k1 or args.k3)
    libs = build_variants(fused, [
        v for v in VARIANTS if every or (args.k1 and v.startswith("k1_"))
        or (args.k3 and v.startswith("k3_"))])
    if every:
        k10_lines(fused, dev, libs, args.quick)
        k6_lines(fused, dev, libs, args.quick)
    if every or args.k1:
        k1_lines(fused, dev, libs)
    if every or args.k3:
        k3_lines(fused, dev, libs)
    return 0


if __name__ == "__main__":
    sys.exit(main())
