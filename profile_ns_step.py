#!/usr/bin/env python3
"""
K13 (ns_step) and K2 (gated_meanvar_logexp, its route 0) split by phase on
one CUDA card.

    python3 profile_ns_step.py [TREE]

TREE (default: this checkout) is a checkout whose ``gpry_tpu_torch`` is
split.  Its ``csrc/`` is copied into the git-ignored
``gpry_tpu_torch/_build/phases/`` of that tree, where a clock stamp goes
before each phase comment or line of PHASES that a source has: a block
barrier, then thread 0 of block 0 adds the ``clock64()`` cycles since the
last stamp to the phase that stamp started (so a phase that runs several
times, as a panel of K2's substitution does, sums its runs, and a phase
in a branch not taken gets nothing).  Each kernel's source is compiled
into a library of its own, which serves the wrapper's calls of that
kernel while they are split.

K13 at each shape of K13_SHAPES (``tests/test_torch_cuda.py``'s "mid"
state: the final NS's nlive = 400 at d = 8, and nlive = 3,200 at d = 64,
halfway through the dead buffer): one step selects a kill first; then
every timed call applies the pending kill (the previous chains) and
selects the next, the steady state of a run, in which the live order is
known.  Where the tree's state carries the live order, the same call with
the order unknown (the full sort of a run's first step) is split too.  K2
(the tree's route 0, if it has one) at chip_smoke's K2_NQ on the RBF
surrogate of chip_smoke's K2 check (n = 224 of nmax = 320, d = 8).  Prints
the card's name and power limit, then one JSON line a shape: the kernel's
device ms as built and with the stamps (``torch.profiler``), and each
phase's share of the stamped cycles of block 0 and its device ms (the
share times the stamped kernel's device ms; the stamps' barriers are in
it).
"""

import json
import os
import shutil
import subprocess
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
# per source: (phase that starts at the anchor, anchor, before it or after
# it); an anchor a source lacks is skipped
PHASES = {
    "ns_step.cu": (
        ("apply", "  // 1. the pending kill", 0),
        ("order", "  // 1b. the live order", 0),
        ("stop", "  // 2. the stop test", 0),
        ("sort", "  // 3. the kill and the next chains' inputs", 0),
        ("dead", "    // the dead points in ascending order, and their "
                 "slots", 0),
        ("mean", "    // the survivors' mean", 0),
        ("cov", "    // the covariance", 0),
        ("chol", "    // the Cholesky factor", 0),
        ("starts", "    // the chains' starts", 0),
        ("end", "  if (tid == 0) {\n    *done = !go;", 0)),
    "gated_meanvar_logexp.cu": (
        ("queries", "  const K2Queries k = k2_queries<SPEC>(a, smem, prog, "
                    "q0, nqb);", 0),
        ("kvec", "  // the k vectors: row j of V holds", 0),
        ("mean_svm", "  for (int qi = warp; qi < nqb; qi += K2_WARPS) {\n"
                     "    double m, dec;\n    k2_mean_svm(a, k, qi, sub.V",
         0),
        ("epilogue", "  for (int qi = tid; qi < nqb; qi += blockDim.x)\n"
                     "    k2_epilogue", 0),
        ("end", "    k2_epilogue<SPEC>(a, k, q0, qi, ms[qi], ds[qi], "
                "sub.sumsq[qi]);\n", 1)),
    "subst_blocked.cuh": (
        ("load", "    if (p + 1 < np) sub_load_panel(s, (p + 1) & 1, P0 + "
                 "SUB_PB);", 0),
        ("update", "    // the update's shares on the tensor cores", 0),
        ("solve", "    // the diagonal block: a half-warp a query", 0),
        ("wait", "    // the next panel's rows landed, this one's solution "
                 "visible", 0),
        ("sumsq", "  // sumsq: a thread a query, the rows in order", 0)),
}
# the stamps: cycles a phase, the phase running and the last stamp
STAMPS = """
__device__ long long gpry_ph_acc[32];
__device__ long long gpry_ph_last;
__device__ int gpry_ph_cur;
#define GPRY_PHASE(i)                                        \\
  do {                                                       \\
    __syncthreads();                                         \\
    if (threadIdx.x == 0 && blockIdx.x == 0) {               \\
      const long long t = clock64();                         \\
      if (gpry_ph_cur >= 0) gpry_ph_acc[gpry_ph_cur] += t - gpry_ph_last; \\
      gpry_ph_last = t;                                      \\
      gpry_ph_cur = (i);                                     \\
    }                                                        \\
  } while (0)
"""
READ = """
extern "C" int gpry_phases_read(void* host) {
  return (int)cudaMemcpyFromSymbol(host, gpry_ph_acc, sizeof(gpry_ph_acc));
}
extern "C" int gpry_phases_clear() {
  static const long long zero[32] = {0};
  const int none = -1;
  cudaError_t e = cudaMemcpyToSymbol(gpry_ph_acc, zero, sizeof(zero));
  if (e == cudaSuccess)
    e = cudaMemcpyToSymbol(gpry_ph_cur, &none, sizeof(none));
  return (int)e;
}
"""
K13_SHAPES = ((400, 8), (3200, 64))
REPS = 30


def stamped_library(fused, source, headers=()):
    """Compile the stamped copy of the tree's ``source`` (with the stamped
    ``headers`` it includes); returns the loaded library and the phase
    names by stamp index."""
    import ctypes
    out = os.path.join(fused._BUILD, "phases", source[:-3])
    shutil.rmtree(out, ignore_errors=True)
    shutil.copytree(fused._CSRC, out)
    names = []
    for name in (source, *headers):
        path = os.path.join(out, name)
        with open(path) as f:
            text = f.read()
        for phase, anchor, after in PHASES[name]:
            if text.count(anchor) > 1:
                raise RuntimeError(f"{anchor!r} occurs more than once")
            if anchor not in text:
                continue
            stamp = f"GPRY_PHASE({len(names)});\n"
            text = text.replace(anchor, anchor + stamp if after
                                else stamp + anchor)
            names.append(phase)
        if name == source:
            head = '#include "common.cuh"\n'
            if head not in text:
                head = text[text.index("#include \""):].split("\n", 1)[0] \
                    + "\n"
            text = text.replace(head, STAMPS + head, 1) + READ
        with open(path, "w") as f:
            f.write(text)
    lib_path = os.path.join(out, "lib.so")
    fused._run_all([[fused._nvcc(), *fused.NVCC_FLAGS, "-shared", "-o",
                     lib_path, os.path.join(out, source)]])
    return ctypes.CDLL(lib_path), names


class Serving:
    """The build's library with one entry point taken from a stamped
    library (the same argument types)."""

    def __init__(self, base, lib, entry):
        self._base, self._lib, self._entry = base, lib, entry

    def __getattr__(self, name):
        if name == self._entry:
            fn, ref = getattr(self._lib, name), getattr(self._base, name)
            fn.argtypes, fn.restype = ref.argtypes, ref.restype
            return fn
        return getattr(self._base, name)


def split(cs, fused, lib, names, serving, call, kernel):
    """The stamped phases of ``call``: device ms as built and stamped, and
    each phase's share of block 0's cycles and its ms."""
    import ctypes
    import numpy as np
    import profile_kernel_designs as pkd
    import torch
    out = {"device_ms": cs.kernel_device_ms(call, kernel, REPS)}
    host = (ctypes.c_longlong * 32)()
    cycles = np.zeros(len(names))
    with pkd.serving(fused, serving):
        out["stamped_device_ms"] = cs.kernel_device_ms(call, kernel, REPS)
        if out["stamped_device_ms"] is None:
            raise RuntimeError(f"the profiler saw no launch of {kernel}: "
                               "no split without its device time")
        for _ in range(REPS):
            if lib.gpry_phases_clear() != 0:
                raise RuntimeError("gpry_phases_clear failed")
            call()
            torch.cuda.synchronize()
            if lib.gpry_phases_read(host) != 0:
                raise RuntimeError("gpry_phases_read failed")
            cycles += np.array(list(host)[:len(names)], dtype=float)
    share = cycles / cycles.sum()
    out["split"] = {n: {"share": float(s),
                        "ms": float(s * out["stamped_device_ms"])}
                    for n, s in zip(names, share) if n != "end"}
    return out


def main():
    tree = os.path.abspath(sys.argv[1]) if len(sys.argv) > 1 else HERE
    sys.path[:0] = [tree, HERE, os.path.join(HERE, "tests")]
    import numpy as np
    import torch
    if not torch.cuda.is_available():
        print("profile_ns_step.py needs a CUDA card.", file=sys.stderr)
        return 3
    import chip_smoke as cs
    from gpry_tpu_torch import config
    from gpry_tpu_torch.ops import fused
    from test_torch_cuda import ns_state
    dev = config.set_device("cuda")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip().splitlines()[0])
    base = fused.library()
    lib, names = stamped_library(fused, "ns_step.cu")
    serving = Serving(base, lib, "gpry_ns_step")
    has_order = "order" in fused.NSState._fields
    for nlive, d in K13_SHAPES:
        st, starts, chains, consts = ns_state(dev, nlive, d, "mid")
        fused.ns_step(st, *chains, starts, *consts)
        c0 = st.count.clone()
        out = {"kernel": "ns_step", "tree": tree, "nlive": nlive, "d": d,
               "B": nlive // 6, "k": int(c0[0])}
        for mode in ("steady", "first") if has_order else ("steady",):
            def call():
                st.count.copy_(c0)
                if mode == "first":
                    st.order.fill_(-1)
                fused.ns_step(st, *chains, starts, *consts)

            out[mode] = split(cs, fused, lib, names, serving, call,
                              "ns_step_kernel")
            if int(st.done):
                raise AssertionError("K13: the split state stopped")
        print(json.dumps(out), flush=True)
    if not os.path.exists(os.path.join(fused._CSRC, "subst_blocked.cuh")):
        return 0
    lib, names = stamped_library(fused, "gated_meanvar_logexp.cu",
                                 ("subst_blocked.cuh",))
    serving = Serving(base, lib, "gpry_gated_meanvar_logexp")
    p = cs.synthetic_surrogate("rbf", dev, seed=12)
    rng = np.random.default_rng(12)
    for nq in cs.K2_NQ:
        Xq = torch.as_tensor(rng.uniform(-5, 5, (nq, cs.D)),
                             dtype=torch.float64, device=dev)
        call = lambda: fused.gated_meanvar_logexp(
            "rbf", p, Xq, logexp=(cs.D ** -0.85, 0.01))
        out = {"kernel": "gated_meanvar_logexp", "tree": tree, "nq": nq,
               "n": cs.N, "nmax": cs.NMAX, "d": cs.D,
               "plan": fused.gated_meanvar_logexp_plan(cs.N, cs.NMAX, cs.D,
                                                       nq)[:2],
               **split(cs, fused, lib, names, serving, call,
                       "gated_meanvar")}
        print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
