#!/usr/bin/env python3
"""
K7 (predict_meancov) split by kernel and by phase, and other designs of its
product kernel, on one CUDA card.

    python3 profile_k7.py [TREE]

TREE (default: this checkout) is a checkout whose ``gpry_tpu_torch`` is
profiled.  First K7's two kernels apart at nq = 1, 64 and 1,024
(chip_smoke's RBF and ALL_NODES surrogates, n = 224 of nmax = 320, d = 8,
queries in the unit box, the first 32 on training points): each kernel's
device ms in a ``torch.profiler`` trace, the solve (``meancov_solve*``) and
the product (``meancov_cov*``).

Then the product split by phase at nq = 1,024, as ``profile_ns_step.py``
splits K13 and K2: the tree's ``csrc/`` is copied into the git-ignored
``gpry_tpu_torch/_build/phases/``, a clock stamp (a block barrier, then
thread 0 of block 1, the first tile below the diagonal, adds the
``clock64()`` cycles since the last stamp to the phase that stamp started)
goes before each anchor of PHASES, and the stamped source, compiled into a
library of its own, serves the wrapper's calls while they are split: the
prologue (the first chunk's copy issued, the length scales and the tile's
points staged), the kernel values (with the first chunk's wait), and in
each chunk the next chunk's copy issued, the products on the tensor cores
and the wait; then the stores.  The shipped sources carry no stamp.

Then the product in scratch builds, each of a copy of ``csrc/`` with a few
lines of ``predict_meancov.cu`` replaced (VARIANTS; the kernel fixes its
design, so these serve the wrapper through a stand-in library as
``profile_kernel_designs.py`` does), against the build's 32 x 32 lower
tiles on 8 warps of 16 x 8, ``mma.sync.m16n8k4``, 32 training rows a
stage and the tile's points at an odd stride: the whole square of tiles
(each entry computed where it is stored); ``m8n8k4``; 64 x 64 tiles on 8
warps of 32 x 16, with m16n8k4 and with m8n8k4; 32 x 32 tiles on 4 warps
of 16 x 16; 16 x 16 tiles on 2 warps of 16 x 8; 16 training rows a stage;
the points at stride d.  Device ms of the product as built, in the
variant, in the variant and as built again, at nq = 64 and 1,024; each
variant's covariance against the plain version (max abs error over max
|K(Xq, Xq)|, chip_smoke's TOL_K7_COV measure) and whether it is symmetric
bit for bit.  Prints the card's name and power limit first, then one JSON
line a measurement.
"""

import json
import os
import shutil
import subprocess
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
SRC = "predict_meancov.cu"
# (phase that starts at the anchor, anchor, before it or after it)
PHASES = {SRC: (
    ("prologue", "  // the first chunk in flight while the kernel values "
                 "are computed", 0),
    ("kvalues", "  // the kernel values K(x_i, x_j) of the thread's "
                "entries", 0),
    ("stage", "    if (kc + 1 < nk)\n      k7_load(", 0),
    ("mma", "    const double* s = stage + (kc & 1) * K7_STAGE;", 0),
    ("wait", "    // the next chunk landed", 0),
    ("stores", "  // the stores: each entry below the diagonal", 0),
    ("end", "          cov[(size_t)j * nq + i] = acc[mi][nj][e];\n"
            "        }\n      }\n", 1))}
NQ = (1, 64, 1024)
# the product's other designs: lists of (old, new) in predict_meancov.cu
WHOLE = [
    ("  int ti, tj;\n  k7_tile(blockIdx.x, &ti, &tj);\n",
     "  const int nt = (nq + K7_T - 1) / K7_T;\n"
     "  const int ti = blockIdx.x / nt, tj = blockIdx.x % nt;\n"),
    ("                    (!diag || rw + K7_T / K7_WR - 1 > cw);",
     "                    true;"),
    ("        if (i0 + r < nq && j0 + c < nq && (!diag || r > c)) {",
     "        if (i0 + r < nq && j0 + c < nq && (!diag || r != c)) {"),
    ("        if (i < nq && j < nq && (!diag || r > c)) {\n"
     "          cov[(size_t)i * nq + j] = acc[mi][nj][e];\n"
     "          cov[(size_t)j * nq + i] = acc[mi][nj][e];\n",
     "        if (i < nq && j < nq && (!diag || r != c)) {\n"
     "          cov[(size_t)i * nq + j] = acc[mi][nj][e];\n"),
    ("  *tiles = nt * (nt + 1) / 2;", "  *tiles = nt * nt;")]
M8 = [(
    "#pragma unroll\n"
    "        for (int mh = 0; mh < K7_MI / 2; ++mh)\n"
    "#pragma unroll\n"
    "          for (int nj = 0; nj < K7_NJ; ++nj)\n"
    "            gpry_dmma16(acc[2 * mh][nj][0], acc[2 * mh][nj][1],\n"
    "                        acc[2 * mh + 1][nj][0], acc[2 * mh + 1][nj][1],\n"
    "                        a[2 * mh], a[2 * mh + 1], b[nj]);\n",
    "#pragma unroll\n"
    "        for (int mi = 0; mi < K7_MI; ++mi)\n"
    "#pragma unroll\n"
    "          for (int nj = 0; nj < K7_NJ; ++nj)\n"
    "            gpry_dmma(acc[mi][nj][0], acc[mi][nj][1], a[mi], b[nj]);\n")]
TILE = "#define K7_T 32\n#define K7_WR 2\n#define K7_WC 4\n"


def tile(t, wr, wc):
    return [(TILE, f"#define K7_T {t}\n#define K7_WR {wr}\n"
                   f"#define K7_WC {wc}\n")]


VARIANTS = {"k7_whole": WHOLE, "k7_m8": M8, "k7_t64": tile(64, 2, 4),
            "k7_t64_m8": tile(64, 2, 4) + M8, "k7_w4": tile(32, 2, 2),
            "k7_t16": tile(16, 1, 2),
            "k7_kc16": [("#define K7_KC 32", "#define K7_KC 16")],
            "k7_pts_even": [("  const int ldp = d | 1;",
                             "  const int ldp = d;")]}
ENTRIES = ("gpry_predict_meancov", "gpry_predict_meancov_plan")


def build_variants(fused):
    """Each variant's library path, all compiled at once."""
    root = os.path.join(fused._BUILD, "variants")
    cmds, libs = [], {}
    for name, reps in VARIANTS.items():
        out = os.path.join(root, name)
        shutil.rmtree(out, ignore_errors=True)
        shutil.copytree(fused._CSRC, out)
        path = os.path.join(out, SRC)
        with open(path) as f:
            text = f.read()
        for old, new in reps:
            if text.count(old) != 1:
                raise RuntimeError(f"{name}: {old!r} is not in {SRC} once")
            text = text.replace(old, new)
        with open(path, "w") as f:
            f.write(text)
        libs[name] = os.path.join(out, "lib.so")
        cmds.append([fused._nvcc(), *fused.NVCC_FLAGS, "-shared", "-o",
                     libs[name], path])
    fused._run_all(cmds)
    return libs


def queries(cs, p, rng, nq, dev):
    """chip_smoke.check_k7's queries: the unit box, the first 32 on
    training points."""
    import torch
    Xq = torch.as_tensor(rng.uniform(0, 1, (nq, cs.D)), dtype=torch.float64,
                         device=dev)
    Xq[:min(nq, 32)] = p.X[:min(nq, 32)]
    return Xq


def cov_err(cs, fused, fam, p, Xq, cov):
    """(max |cov - plain| / max |K(Xq, Xq)|, cov symmetric bit for bit)."""
    import torch
    args = (p.theta, p.X, p.n, p.noise_var, p.L, p.alpha, Xq)
    ref = fused.predict_meancov_plain(fam, *args)[1]
    kqq = fused.predict_meancov_plain(fam, p.theta, p.X, 0, p.noise_var,
                                      p.L, p.alpha, Xq)[1]
    err = float(torch.max(torch.abs(cov - ref)) / torch.max(torch.abs(kqq)))
    return err, bool(torch.equal(cov, cov.T))


def main():
    tree = os.path.abspath(sys.argv[1]) if len(sys.argv) > 1 else HERE
    sys.path[:0] = [tree, HERE, os.path.join(HERE, "tests")]
    import numpy as np
    import torch
    if not torch.cuda.is_available():
        print("profile_k7.py needs a CUDA card.", file=sys.stderr)
        return 3
    import chip_smoke as cs
    import profile_kernel_designs as pkd
    import profile_ns_step as pns
    from gpry_tpu_torch import config
    from gpry_tpu_torch.ops import fused
    dev = config.set_device("cuda")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip().splitlines()[0])
    base = fused.library()
    fams = ((("rbf", "rbf"), (cs.spec_kernel()[0], "spec")))
    surr = {tag: cs.synthetic_surrogate(fam, dev, seed=16)
            for fam, tag in fams}
    rng = np.random.default_rng(16)
    Xqs = {nq: queries(cs, surr["rbf"], rng, nq, dev) for nq in NQ}

    for fam, tag in fams:
        p = surr[tag]
        for nq in NQ:
            call = lambda: fused.predict_meancov(fam, p.theta, p.X, p.n,
                                                 p.noise_var, p.L, p.alpha,
                                                 Xqs[nq])
            print(json.dumps({
                "kernel": "predict_meancov", "family": tag, "tree": tree,
                "nq": nq, "solve_device_ms": cs.kernel_device_ms(
                    call, "meancov_solve", 50),
                "product_device_ms": cs.kernel_device_ms(
                    call, "meancov_cov", 50)}), flush=True)

    # the stamps in block 1, the first tile below the diagonal
    pns.STAMPS = pns.STAMPS.replace("blockIdx.x == 0", "blockIdx.x == 1")
    pns.PHASES.update(PHASES)
    lib, names = pns.stamped_library(fused, SRC)
    serving = pns.Serving(base, lib, "gpry_predict_meancov")
    for fam, tag in fams:
        p = surr[tag]
        call = lambda: fused.predict_meancov(fam, p.theta, p.X, p.n,
                                             p.noise_var, p.L, p.alpha,
                                             Xqs[1024])
        out = {"kernel": "meancov_cov", "family": tag, "tree": tree,
               "nq": 1024, "n": cs.N, "nmax": cs.NMAX, "d": cs.D}
        out.update(pns.split(cs, fused, lib, names, serving, call,
                             "meancov_cov"))
        print(json.dumps(out), flush=True)

    libs = build_variants(fused)
    pkd.ENTRIES[SRC] = ENTRIES
    for fam, tag in fams:
        p = surr[tag]
        for nq in (64, 1024):
            Xq = Xqs[nq]
            call = lambda: fused.predict_meancov(fam, p.theta, p.X, p.n,
                                                 p.noise_var, p.L, p.alpha,
                                                 Xq)
            built = cov_err(cs, fused, fam, p, Xq, call()[1])
            for variant in VARIANTS:
                lib = pkd.Variant(base, libs[variant], SRC)
                line = {"kernel": "meancov_cov", "family": tag, "nq": nq,
                        "variant": variant, "device_ms": []}
                with pkd.serving(fused, lib):
                    err, sym = cov_err(cs, fused, fam, p, Xq, call()[1])
                line.update({"cov_err": {"as built": built[0],
                                         variant: err},
                             "symmetric": {"as built": built[1],
                                           variant: sym}})
                for use in (None, variant, variant, None):
                    with pkd.serving(fused, base if use is None else lib):
                        line["device_ms"].append(cs.kernel_device_ms(
                            call, "meancov_cov", 50))
                print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
