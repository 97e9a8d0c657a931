"""
gpry_tpu_torch's CUDA kernels against their plain versions on the card.

Marked ``cuda``: they need a CUDA card and nvcc, and skip elsewhere (the
decision is taken inside the fixture, never at import).  On the card
(the repository's conftest imports jax, which the card's machine lacks):

    python -m pytest tests/test_torch_cuda.py -q --noconftest
"""

import ctypes

import numpy as np
import pytest
import torch

from gpry_tpu_torch.models.classifier import MODE_ALL_FINITE, MODE_FITTED, \
    SVMParams, trivial_svm_params
from gpry_tpu_torch.models.gp import SurrogateParams
from gpry_tpu_torch.ops import fused
from gpry_tpu_torch.ops.kernels import build_kernel_spec, kernel_diag
from gpry_tpu_torch.ops.linalg import chol_append, factorize, \
    masked_kernel_matrix

pytestmark = pytest.mark.cuda
FAST = ("rbf", "matern12", "matern32", "matern52")
# composite kernels at dimension d (their theta0 is the test's theta): one
# with every node kind, and C() * RBF + WhiteKernel


def all_nodes(d):
    """ExpSineSquared of a Euclidean distance is not positive definite in
    general beyond one dimension: its period is 3 up to d = 3 and d
    above, so that the d = 16 training matrices factorize."""
    ls = [float(v) for v in np.resize([0.4, 0.5, 0.6], d)]
    return {"Sum": [
        {"Product": [{"ConstantKernel": {"constant_value": 1.3}},
                     {"Exponentiation": {"kernel": {"Matern": {
                         "nu": 2.5, "length_scale": ls}},
                         "exponent": 2.0}}]},
        {"Sum": [{"Product": [{"ConstantKernel": {"constant_value": 0.5}},
                              {"RationalQuadratic": {"alpha": 1.5,
                                                     "length_scale": 0.5}}]},
                 {"Sum": [{"ExpSineSquared": {
                     "length_scale": 1.0,
                     "periodicity": 3.0 * max(1.0, d / 3.0)}},
                          {"Sum": [{"DotProduct": {"sigma_0": 0.3}},
                                   {"WhiteKernel": {
                                       "noise_level": 1e-3}}]}]}]}]}


def c_rbf_white(d):
    return {"Sum": [
        {"Product": [{"ConstantKernel": {"constant_value": 1.3}},
                     {"RBF": {"length_scale": [0.4] * d}}]},
        {"WhiteKernel": {"noise_level": 1e-4}}]}


SPECS = {"all_nodes": all_nodes, "c_rbf_white": c_rbf_white}
FAMILIES = FAST + tuple(SPECS)


def family_and_theta(family, d=3):
    """The kernel argument and theta of a fast family or a named spec."""
    if family in SPECS:
        spec, theta0, _ = build_kernel_spec(SPECS[family](d), d)
        return spec, np.asarray(theta0)
    return family, np.log([1.3] + [0.4] * d)


def count_key(name, family):
    """The LAUNCHES key of kernel ``name`` for ``family`` (a family name
    of FAMILIES): spec-mode launches count apart."""
    return name + ("/spec" if family in SPECS else "")


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def surrogate(family, dev, n=40, nmax=64, d=3, seed=0, nsv=8, svm="fitted",
              ls=None, side=None):
    """A small surrogate with every gate active: the SVM fitted (or, with
    ``svm="all_finite"``, the placeholder of a run that has seen no -inf),
    a trust box inside the prior and an upper clip.  ``family`` is a fast
    family or a spec tree (its kernel argument, see family_and_theta); a
    fast family's length scale ``ls`` if given; the training points in the
    cube of ``side`` about the unit box's centre if given (else the unit
    box)."""
    rng = np.random.default_rng(seed)
    t = lambda a: torch.as_tensor(np.asarray(a, float), dtype=torch.float64,
                                  device=dev)
    X, y = np.zeros((nmax, d)), np.zeros(nmax)
    X[:n] = rng.uniform(0, 1, (n, d)) if side is None else \
        rng.uniform(0.5 - side / 2, 0.5 + side / 2, (n, d))
    y[:n] = np.sin(4 * X[:n]).sum(1)
    family, theta = family_and_theta(family, d)
    if ls is not None:
        theta = np.log([1.3] + [ls] * d)
    L, alpha = factorize(family, t(theta), t(X), t(y), n, t(1e-4))
    sv = rng.uniform(0, 1, (nsv, d))
    if svm == "fitted":
        svm = SVMParams(mode=MODE_FITTED, sv=t(sv),
                        dual=t(rng.normal(size=nsv)), intercept=t(0.1),
                        gamma=t(3.0))
    else:
        svm = trivial_svm_params(d, nsv, torch.float64, dev, MODE_ALL_FINITE)
    return SurrogateParams(
        theta=t(theta), X=t(X), y=t(y), n=n, noise_var=t(1e-4), L=L,
        alpha=alpha, x_loc=t(np.full(d, -1.0)), x_scale=t(np.full(d, 2.0)),
        y_loc=t(-1.0), y_scale=t(2.0), y_max=t(0.5), clip_max=t(1.0),
        svm=svm, trust_lo=t(np.full(d, -0.9)), trust_hi=t(np.full(d, 0.9)))


def _close(a, b, tol):
    assert torch.equal(torch.isfinite(a), torch.isfinite(b))
    fin = torch.isfinite(b)
    err = torch.max(torch.abs(a[fin] - b[fin])) / torch.max(torch.abs(b[fin]))
    assert float(err) <= tol


@pytest.mark.parametrize("family", FAMILIES)
def test_gated_mean_kernel(dev, family):
    p = surrogate(family, dev)
    key, family = count_key("gated_mean", family), family_and_theta(family)[0]
    Xq = torch.rand((1000, 3), dtype=torch.float64, device=dev) * 2.2 - 1.1
    n0 = fused.LAUNCHES[key]
    _close(fused.gated_mean(family, p, Xq),
           fused.gated_mean_plain(family, p, Xq), 1e-12)
    assert fused.LAUNCHES[key] == n0 + 1


# K1 at (nq, n, d): the paths' batch sizes (one query, the MCMC's start
# tries and kill batches 16-66, the NS prior phase 2,000, 16,384 and
# 32,768, the IS refine 65,536, and 100,000) at n = 224; few rows
# (one warp a query warp, four splits, eight warps with no cluster) and
# clusters at small nq (n 224, 320); n streamed
# far beyond shared memory (4,000, 20,000: clusters of 16, many tiles);
# each register instance and the queries in shared memory (d 16, 40).
# Every shape's geometry comes from its shape alone (gated_mean_plan);
# test_torch_k1_k3_plan.py checks that these reach every kind the plan
# has.
K1_SHAPES = ((1, 224, 3), (16, 224, 3), (66, 224, 3), (2000, 224, 3),
             (16384, 224, 3), (32768, 224, 3), (65536, 224, 3),
             (100000, 224, 3),
             (66, 1, 3), (66, 20, 3), (16, 320, 3), (16, 4000, 3),
             (16, 20000, 3), (16384, 4000, 3), (66, 224, 16),
             (65536, 224, 16), (66, 224, 40), (65536, 224, 40))


def k1_surrogate(family, dev, n, d, svm, seed=0, nsv=8):
    """A surrogate for K1 alone (no factor: K1 reads X and alpha): n
    training rows in [0, 1]^d, alpha ~ N(0, 1) / sqrt(n) so that the mean
    stays O(1) below a clip of 10, the trust box and the SVM of
    :func:`surrogate`."""
    rng = np.random.default_rng(seed)
    t = lambda a: torch.as_tensor(np.asarray(a, float), dtype=torch.float64,
                                  device=dev)
    family, theta = family_and_theta(family, d)
    p = surrogate(family if isinstance(family, str) else "rbf", dev, n=4,
                  nmax=8, d=d, seed=seed, nsv=nsv, svm=svm)
    return p.replace(
        theta=t(theta), X=t(rng.uniform(0, 1, (n, d))), y=t(np.zeros(n)),
        n=n, alpha=t(rng.normal(size=n) / np.sqrt(max(n, 1))),
        L=torch.empty(0, dtype=torch.float64, device=dev),
        clip_max=t(10.0))


@pytest.mark.parametrize("svm", ["fitted", "all_finite"])
@pytest.mark.parametrize("shape", K1_SHAPES)
@pytest.mark.parametrize("family", FAMILIES)
def test_gated_mean_kernel_shapes(dev, family, shape, svm):
    """K1 at K1_SHAPES, the SVM fitted and all finite: one launch, rel <=
    1e-12 against the plain version, the geometry the plan gives that
    shape (the C plan equal to the host mirror)."""
    nq, n, d = shape
    key = count_key("gated_mean", family)
    p = k1_surrogate(family, dev, n, d, svm)
    fam = family_and_theta(family, d)[0]
    kern = fused._kern(fam, d, dev)
    nsv = p.svm.sv.shape[0] if svm == "fitted" else 0
    geo, sm = (ctypes.c_int * 5)(), ctypes.c_size_t()
    assert fused.library().gpry_gated_mean_plan(
        kern, nq, n, nsv, d, geo, ctypes.byref(sm)) == 0
    assert tuple(geo) + (sm.value,) == fused.gated_mean_plan(
        nq, n, nsv, d, fused._spec_doubles(kern))
    gen = torch.Generator(device=dev).manual_seed(nq + n + d)
    Xq = torch.rand((nq, d), generator=gen, dtype=torch.float64,
                    device=dev) * 2.2 - 1.1
    # the first queries inside the trust box, so that some pass the gates
    Xq[:8] *= 0.4
    ref = fused.gated_mean_plain(fam, p, Xq)
    n0 = fused.LAUNCHES[key]
    out = fused.gated_mean(fam, p, Xq)
    torch.cuda.synchronize()
    assert fused.LAUNCHES[key] == n0 + 1
    if bool(torch.isfinite(ref).any()):
        _close(out, ref, 1e-12)
    else:
        assert torch.equal(out, ref)


@pytest.mark.parametrize("family", ("rbf", "all_nodes"))
@pytest.mark.parametrize("d", (2, 8, 16, 40, 90))
def test_gated_mean_plan_matches_the_kernel(dev, family, d):
    """fused.gated_mean_plan gives k1_plan's geometry and shared memory
    over a grid of batch sizes, rows and support vectors."""
    fam = family_and_theta(family, d)[0]
    kern = fused._kern(fam, d, dev)
    spec = fused._spec_doubles(kern)
    lib = fused.library()
    geo, sm = (ctypes.c_int * 5)(), ctypes.c_size_t()
    for nq in (1, 31, 33, 66, 400, 2000, 16384, 65536, 1 << 20):
        for n in (0, 1, 7, 64, 224, 1000, 4000, 20000, 100000):
            for nsv in (0, 8, 100):
                want = fused.gated_mean_plan(nq, n, nsv, d, spec)
                assert lib.gpry_gated_mean_plan(
                    kern, nq, n, nsv, d, geo, ctypes.byref(sm)) == 0
                assert tuple(geo) + (sm.value,) == want


def _chain_inputs(family, p, B, R, seed=0):
    """K6's arguments: B starts above lstar (the median of a prior sample
    in the box [-1, 1]^d, over the values below the upper clip), the
    survivors' covariance factor, and draws for R repeats."""
    dev, d = p.X.device, p.X.shape[1]
    gen = torch.Generator(device=dev).manual_seed(seed)
    pool = torch.rand((4000, d), generator=gen, dtype=torch.float64,
                      device=dev) * 2.0 - 1.0
    lp = fused.gated_mean_plain(family, p, pool)
    lstar = torch.quantile(lp[torch.isfinite(lp) & (lp < p.clip_max)], 0.5)
    above = pool[lp > lstar]
    assert len(above) >= B
    chol = torch.linalg.cholesky(torch.cov(above.T)).contiguous()
    nrm = torch.randn((R, B, d), generator=gen, dtype=torch.float64,
                      device=dev)
    u = torch.rand((R, 1 + fused.NS_SHRINKS, B), generator=gen,
                   dtype=torch.float64, device=dev)
    lo = -torch.ones(d, dtype=torch.float64, device=dev)
    return (above[:B].contiguous(), lp[lp > lstar][:B].contiguous(), lstar,
            chol, nrm, u, lo, -lo)


def _same_slice_chains(family, p, args):
    """K6 against its plain version on the same draws: identical calls and
    -inf masks, x and lx within rel 1e-10, and the passes each chain made
    those of the kernel's schedule (chip_smoke's replay of the lock-step
    loop); one launch.  Returns lx, calls and passes."""
    import chip_smoke
    key = count_key("ns_slice_chains", family)
    fam = family_and_theta(family)[0] if family in FAMILIES else family
    n0 = fused.LAUNCHES[key]
    x, lx, calls, passes = fused.ns_slice_chains(fam, p, *args,
                                                 return_passes=True)
    torch.cuda.synchronize()
    assert fused.LAUNCHES[key] == n0 + 1
    xr, lxr, callsr = fused.ns_slice_chains_plain(fam, p, *args)
    assert calls.dtype == torch.int64 and torch.equal(calls, callsr)
    _close(lx, lxr, 1e-10)
    _close(x, xr, 1e-10)
    _, replay, _ = chip_smoke.k6_replay(fam, p, args)
    assert torch.equal(passes, replay)
    return lx, calls, passes


@pytest.mark.parametrize("svm", ["fitted", "all_finite"])
@pytest.mark.parametrize("B", [1, 33, 66, 132])
@pytest.mark.parametrize("family", FAMILIES)
def test_ns_slice_chains_kernel(dev, family, B, svm):
    """K6 against its plain version (the lock-step loop on plain K1) on the
    same draws, with the SVM fitted and all finite, from one chain to one
    a SM: identical calls, identical -inf masks, x and lx within rel 1e-10,
    the schedule's passes; one launch for all chains and repeats."""
    p = surrogate(family, dev, svm=svm)
    args = _chain_inputs(family_and_theta(family)[0], p, B, R=12)
    lx, calls, _ = _same_slice_chains(family, p, args)
    assert int(calls.min()) >= 12 * 3
    assert bool((lx > args[2]).all())


@pytest.mark.parametrize("family", ("rbf", "all_nodes"))
def test_ns_slice_chains_step_out_cap(dev, family):
    """Steps far shorter than the slice and lstar below every value: each
    end doubles the 6 times of the cap (2 + 12 calls), and the first shrink
    is accepted: 15 calls a repeat, as the plain version, in 2 passes (both
    whole ladders, the shrink)."""
    p = surrogate(family, dev, svm="all_finite")
    x0, lx0, _, chol, nrm, u, lo, hi = _chain_inputs(
        family_and_theta(family)[0], p, 33, R=6)
    lstar = torch.tensor(-1e300, dtype=torch.float64, device=dev)
    args = (x0, lx0, lstar, 1e-9 * chol, nrm, u, lo, hi)
    _, calls, passes = _same_slice_chains(family, p, args)
    assert torch.equal(calls, torch.full_like(calls, 6 * 15))
    assert torch.equal(passes, torch.full_like(passes, 6 * 2))


@pytest.mark.parametrize("family", ("rbf", "all_nodes"))
def test_ns_slice_chains_every_shrink_misses(dev, family):
    """lstar above every value: no end steps out, all 30 shrinks miss (32
    calls a repeat, ceil(30 / 4) shrink passes) and no chain moves."""
    p = surrogate(family, dev)
    x0, lx0, _, chol, nrm, u, lo, hi = _chain_inputs(
        family_and_theta(family)[0], p, 33, R=5)
    lstar = torch.tensor(1e300, dtype=torch.float64, device=dev)
    args = (x0, lx0, lstar, chol, nrm, u, lo, hi)
    _, calls, passes = _same_slice_chains(family, p, args)
    assert torch.equal(calls, torch.full_like(calls, 5 * 32))
    assert torch.equal(passes, torch.full_like(passes, 5 * (1 + 8)))
    x, lx, _ = fused.ns_slice_chains(family_and_theta(family)[0], p, *args)
    assert torch.equal(x, x0) and torch.equal(lx, lx0)


@pytest.mark.parametrize("n,nmax,nsv,work", [
    (1100, 1152, 8, 0), (1100, 1152, 1152, 16 * 1152),
    (1800, 1856, 8, 16 * 1808)])
@pytest.mark.parametrize("family", ("rbf",) + tuple(SPECS))
def test_ns_slice_chains_d16(dev, family, n, nmax, nsv, work):
    """K6 at d = 16 (the JAX package's d16 campaign reaches nmax = 1,152):
    the whole surrogate in shared memory; the support vectors beyond it,
    read from a staged copy in global memory; X / l beyond it as well (in
    spec mode X as it is).  The spec program's few doubles move no
    surrogate to another placement.  Each launches once and agrees with
    its plain version."""
    p = surrogate(family, dev, n=n, nmax=nmax, d=16, nsv=nsv)
    p = p.replace(clip_max=torch.tensor(torch.inf, dtype=torch.float64,
                                        device=dev))
    key = count_key("ns_slice_chains", family)
    family = family_and_theta(family, 16)[0]
    assert fused.library().gpry_ns_slice_chains_work(
        fused._kern(family, 16, dev), n, nsv, 16, MODE_FITTED) == work
    args = _chain_inputs(family, p, 33, R=4)
    n0 = fused.LAUNCHES[key]
    x, lx, calls = fused.ns_slice_chains(family, p, *args)
    torch.cuda.synchronize()
    assert fused.LAUNCHES[key] == n0 + 1
    xr, lxr, callsr = fused.ns_slice_chains_plain(family, p, *args)
    assert torch.equal(calls, callsr)
    _close(lx, lxr, 1e-10)
    _close(x, xr, 1e-10)


@pytest.mark.parametrize("family", FAMILIES)
def test_gated_meanvar_logexp_kernel(dev, family):
    p = surrogate(family, dev)
    family = family_and_theta(family)[0]
    Xq = torch.rand((700, 3), dtype=torch.float64, device=dev) * 2.2 - 1.1
    for a, b in zip(fused.gated_meanvar_logexp(family, p, Xq),
                    fused.gated_meanvar_logexp_plain(family, p, Xq)):
        _close(a, b, 1e-10)
    _close(fused.gated_meanvar_logexp(family, p, Xq, logexp=(0.5, 0.01)),
           fused.gated_meanvar_logexp_plain(family, p, Xq,
                                            logexp=(0.5, 0.01)), 1e-10)


def _k2_surrogate(family, dev, n, nmax, d, svm, noise):
    """surrogate() at n valid rows of nmax, with scalar noise or a noise
    vector (the factor then differs row by row)."""
    p = surrogate(family, dev, n=n, nmax=nmax, d=d, svm=svm, seed=n)
    if noise == "vector":
        fam = family_and_theta(family, d)[0]
        nv = torch.linspace(1e-5, 1e-3, nmax, dtype=torch.float64,
                            device=dev)
        L, alpha = factorize(fam, p.theta, p.X, p.y, n, nv)
        p = p.replace(noise_var=nv, L=L, alpha=alpha)
    return p


def _k2_queries(rng, nq, d):
    """nq queries, two thirds inside the surrogate's trust box and the
    rest across and outside it."""
    inside = (2 * nq + 2) // 3
    return np.concatenate([rng.uniform(-0.85, 0.85, (inside, d)),
                           rng.uniform(-1.1, 1.1, (nq - inside, d))])


def _k2_same(family, p, Xq):
    """K2 in both output modes within 1e-10 (relative to the largest
    value) of its plain version, -inf masks identical (a batch whose
    every value is gated compares its masks alone); one launch each."""
    key = count_key("gated_meanvar_logexp",
                    "all_nodes" if isinstance(family, tuple) else "rbf")
    n0 = fused.LAUNCHES[key]
    lexp = (0.5, 0.01)
    pairs = list(zip(fused.gated_meanvar_logexp(family, p, Xq),
                     fused.gated_meanvar_logexp_plain(family, p, Xq)))
    pairs.append((fused.gated_meanvar_logexp(family, p, Xq, logexp=lexp),
                  fused.gated_meanvar_logexp_plain(family, p, Xq,
                                                   logexp=lexp)))
    for a, b in pairs:
        if bool(torch.isfinite(b).any()) and bool((b != 0).any()):
            _close(a, b, 1e-10)
        else:
            assert torch.equal(a, b)
    assert fused.LAUNCHES[key] == n0 + 2


@pytest.mark.parametrize("n", (1, 15, 16, 17, 224, 320))
@pytest.mark.parametrize("nq", (1, 7, 8, 9, 3200, 4000))
@pytest.mark.parametrize("family", ("rbf", "all_nodes"))
def test_gated_meanvar_logexp_kernel_shapes(dev, family, nq, n):
    """K2 (both instances, both output modes) at the batch sizes around
    its blocks of queries and the acquisition screen's, n around its
    16-row panels and the main path's (nmax = n's bucket, d = 8), with the
    SVM fitted and absent, scalar and vector noise; a third of the queries
    across and outside the trust box."""
    from gpry_tpu_torch.config import bucket_size
    d = 8
    rng = np.random.default_rng(nq + n)
    for svm in ("fitted", "all_finite"):
        for noise in ("scalar", "vector"):
            p = _k2_surrogate(family, dev, n, bucket_size(n), d, svm, noise)
            fam = family_and_theta(family, d)[0]
            Xq = torch.as_tensor(_k2_queries(rng, nq, d),
                                 dtype=torch.float64, device=dev)
            _k2_same(fam, p, Xq)


def _k2_edge(d, nq, spec):
    """The largest n that K2's route 0 takes at nq queries (the plan)."""
    n = 16
    while fused.gated_meanvar_logexp_plan(n + 1, 4096, d, nq, spec)[0] == 0:
        n += 1
    return n


@pytest.mark.parametrize("nq", (9, 3200))
@pytest.mark.parametrize("family", ("rbf", "all_nodes"))
def test_gated_meanvar_logexp_kernel_route_edge(dev, family, nq):
    """K2 on each side of the large-n route's edge (route 0 at n, route 1
    at n + 1; nmax the bucket of n + 1), both output modes."""
    from gpry_tpu_torch.config import bucket_size
    d = 8
    fam = family_and_theta(family, d)[0]
    spec = fused._spec_doubles(fused._kern(fam, d, dev))
    edge = _k2_edge(d, nq, spec)
    rng = np.random.default_rng(edge)
    Xq = torch.as_tensor(_k2_queries(rng, nq, d), dtype=torch.float64,
                         device=dev)
    for n, route in ((edge, 0), (edge + 1, 1)):
        nmax = bucket_size(edge + 1)
        assert fused.gated_meanvar_logexp_plan(n, nmax, d, nq,
                                               spec)[0] == route
        _k2_same(fam, _k2_surrogate(family, dev, n, nmax, d, "fitted",
                                    "scalar"), Xq)


@pytest.mark.parametrize("family", ("rbf", "all_nodes"))
@pytest.mark.parametrize("d", (2, 8, 32))
def test_gated_meanvar_logexp_plan_matches_the_kernel(dev, family, d):
    """fused.gated_meanvar_logexp_plan gives k2_plan's route, queries a
    block and shared memory, at an even and an odd nmax and for L's data
    16-byte aligned or 8 bytes off."""
    fam = family_and_theta(family, d)[0]
    kern = fused._kern(fam, d, dev)
    spec = fused._spec_doubles(kern)
    lib = fused.library()
    for nq in (1, 1056, 1057, 4224, 4225, 65536):
        for n in (0, 1, 224, _k2_edge(d, nq, spec), 5000):
            for nmax in (max(64, n + n % 2), max(65, n | 1)):
                qc = fused._sweep_queries_per_block(nmax, d, spec)
                for at in (4096, 4104):
                    route, q, smem = fused.gated_meanvar_logexp_plan(
                        n, nmax, d, nq, spec, aligned=at % 16 == 0)
                    Q, sm = ctypes.c_int(), ctypes.c_size_t()
                    assert lib.gpry_gated_meanvar_logexp_plan(
                        kern, nq, n, nmax, d, qc, ctypes.c_void_p(at),
                        ctypes.byref(Q), ctypes.byref(sm)) == route
                    assert (Q.value, sm.value) == (q, smem)


def _at_offset(t):
    """A contiguous copy of ``t`` whose data starts 8 bytes into its
    buffer (so not 16-byte aligned)."""
    buf = torch.empty(t.numel() + 1, dtype=t.dtype, device=t.device)
    view = buf[1:].view(t.shape)
    view.copy_(t)
    return view


@pytest.mark.parametrize("layout", ("odd_nmax", "offset"))
@pytest.mark.parametrize("n", (17, 224))
@pytest.mark.parametrize("family", ("rbf", "all_nodes"))
def test_unaligned_factor_takes_the_large_n_route(dev, family, n, layout):
    """Route 0 copies L's rows 16 bytes at a time.  An odd nmax, or L a
    view 8 bytes into its buffer, takes the large-n route instead, in K2
    (both output modes) and in K7's solve, and both match their plain
    versions (no misaligned copy, no sticky CUDA error); K7's covariance
    stays symmetric bit for bit."""
    from gpry_tpu_torch.config import bucket_size
    d, nq = 8, 9
    nmax = bucket_size(n) + (layout == "odd_nmax")
    fam = family_and_theta(family, d)[0]
    spec = fused._spec_doubles(fused._kern(fam, d, dev))
    p = _k2_surrogate(family, dev, n, nmax, d, "fitted", "scalar")
    if layout == "offset":
        p = p.replace(L=_at_offset(p.L))
    assert fused.gated_meanvar_logexp_plan(
        n, nmax, d, nq, spec, aligned=p.L.data_ptr() % 16 == 0)[0] == 1
    assert fused.gated_meanvar_logexp_plan(n, nmax - nmax % 2, d, nq,
                                           spec)[0] == 0
    rng = np.random.default_rng(n)
    Xq = torch.as_tensor(_k2_queries(rng, nq, d), dtype=torch.float64,
                         device=dev)
    _k2_same(fam, p, Xq)
    Xp = (Xq - p.x_loc) / p.x_scale
    ma, ca = fused.predict_meancov(fam, p.theta, p.X, p.n, p.noise_var,
                                   p.L, p.alpha, Xp)
    mb, cb = fused.predict_meancov_plain(fam, p.theta, p.X, p.n,
                                         p.noise_var, p.L, p.alpha, Xp)
    torch.cuda.synchronize()
    _close(ma, mb, 1e-10)
    kqq = fused.predict_meancov_plain(fam, p.theta, p.X, 0, p.noise_var,
                                      p.L, p.alpha, Xp)[1]
    atol = 1e-10 * float(torch.max(torch.abs(kqq)))
    assert float(torch.max(torch.abs(ca - cb))) <= atol
    assert torch.equal(ca, ca.T)


@pytest.mark.parametrize("family", FAMILIES)
def test_masked_kernel_matrix_kernel(dev, family):
    """K3 against its plain version for 33 theta rows, each matrix its own
    row (a spec's offsets index that row), scalar and per-row noise."""
    p = surrogate(family, dev)
    family = family_and_theta(family)[0]
    th = p.theta + 0.3 * torch.randn((33, len(p.theta)), dtype=torch.float64,
                                     device=dev)
    for noise in (p.noise_var, torch.full((64,), 1e-3, dtype=torch.float64,
                                          device=dev)):
        _close(fused.masked_kernel_matrix_batched(family, th, p.X, p.n,
                                                  noise, 1e-5),
               fused.masked_kernel_matrix_plain(family, th, p.X, p.n, noise,
                                                1e-5), 1e-12)


def _k3_inputs(family, dev, n, nmax, d, R=3, seed=0):
    """(kernel argument, R theta rows, X with n valid rows of nmax, scalar
    and vector noise) for K3."""
    rng = np.random.default_rng(seed)
    fam, theta = family_and_theta(family, d)
    t = lambda a: torch.as_tensor(np.asarray(a, float), dtype=torch.float64,
                                  device=dev)
    X = np.zeros((nmax, d))
    X[:n] = rng.uniform(0, 1, (n, d))
    th = theta + 0.3 * rng.normal(size=(R, len(theta)))
    return fam, t(th), t(X), (t(1e-4), t(rng.uniform(1e-5, 1e-3, nmax)))


# (n, nmax, d): the paths' bucket (224 of 320), a partial last tile (70 of
# 70 and 50 of 70), one row, no row, and d = 440, where the staged points
# fill nearly all of a block's shared memory
K3_SHAPES = ((224, 320, 8), (70, 70, 3), (50, 70, 3), (1, 64, 3),
             (0, 64, 3), (40, 64, 440))
# d = 440 for the fast families only: a spec program's exp(+-theta) puts
# it past a block's shared memory
K3_CASES = [(f, s) for f in FAMILIES for s in K3_SHAPES
            if s[2] < 440 or f in FAST]


@pytest.mark.parametrize("family, shape", K3_CASES)
def test_masked_kernel_matrix_whole_is_symmetric(dev, family, shape):
    """The whole matrix against its plain version at rel 1e-12, and bit
    for bit symmetric."""
    n, nmax, d = shape
    fam, th, X, noises = _k3_inputs(family, dev, n, nmax, d)
    for noise in noises:
        K = fused.masked_kernel_matrix_batched(fam, th, X, n, noise, 1e-5)
        torch.cuda.synchronize()
        _close(K, fused.masked_kernel_matrix_plain(fam, th, X, n, noise,
                                                   1e-5), 1e-12)
        assert torch.equal(K, K.transpose(1, 2))


@pytest.mark.parametrize("family, shape", K3_CASES)
def test_masked_kernel_matrix_panel(dev, family, shape):
    """Row panels (a new row, an append's 8 across n, the padding, the
    first and last rows, all rows but the first): one launch each (none
    for an empty panel), equal to the whole matrix's rows bit for bit and
    to the plain panel at rel 1e-12."""
    n, nmax, d = shape
    key = count_key("masked_kernel_matrix_batched", family)
    fam, th, X, noises = _k3_inputs(family, dev, n, nmax, d)
    for noise in noises:
        K = fused.masked_kernel_matrix_batched(fam, th, X, n, noise, 1e-5)
        for r0, r1 in ((n, min(nmax, n + 1)), (max(0, n - 4),
                                               min(nmax, n + 4)),
                       (0, 1), (nmax - 1, nmax), (1, nmax)):
            n0 = fused.LAUNCHES[key]
            P = fused.masked_kernel_matrix_batched(fam, th, X, n, noise,
                                                   1e-5, rows=(r0, r1))
            torch.cuda.synchronize()
            assert fused.LAUNCHES[key] == n0 + (r1 > r0)
            assert torch.equal(P, K[:, r0:r1])
            if r1 > r0:
                _close(P, fused.masked_kernel_matrix_plain(
                    fam, th, X, n, noise, 1e-5, rows=(r0, r1)), 1e-12)


def _chol_append_full_build(family, theta, X, y, n, noise_var, L, X_new,
                            y_new):
    """The append before the panel: both blocks read off one K3 build of
    the grown set's whole matrix."""
    nmax, k = X.shape[0], X_new.shape[0]
    X2, y2 = X.clone(), y.clone()
    X2[n:n + k], y2[n:n + k] = X_new, y_new
    K = masked_kernel_matrix(family, theta, X2, n + k, noise_var)
    m = (torch.arange(nmax, device=X.device) < n).to(X.dtype)
    S12 = torch.linalg.solve_triangular(L, K[:, n:n + k] * m[:, None],
                                        upper=False)
    S22 = fused.cholesky_nan(K[n:n + k, n:n + k] - S12.T @ S12)
    L2 = L.clone(memory_format=torch.contiguous_format)
    rows = torch.zeros((k, nmax), dtype=L.dtype, device=L.device)
    rows[:, :n] = S12[:n].T
    rows[:, n:n + k] = S22
    L2[n:n + k] = rows
    z = torch.linalg.solve_triangular(L2, y2[:, None], upper=False)
    return L2, torch.linalg.solve_triangular(L2.T, z, upper=True)[:, 0]


@pytest.mark.parametrize("k", (1, 8))
@pytest.mark.parametrize("family", FAMILIES)
def test_chol_append_panel_on_the_card(dev, family, k):
    """chol_append through K3's panel gives the factor and alpha of the
    whole-matrix route bit for bit (one K3 launch, a panel of k rows)."""
    p = surrogate(family, dev, n=40 + k, nmax=64)
    fam = family_and_theta(family)[0]
    X, y = p.X.clone(), p.y.clone()
    X[40:], y[40:] = 0.0, 0.0
    L0, _ = factorize(fam, p.theta, X, y, 40, p.noise_var)
    args = (fam, p.theta, X, y, 40, p.noise_var, L0, p.X[40:40 + k],
            p.y[40:40 + k])
    key = count_key("masked_kernel_matrix_batched", family)
    n0 = fused.LAUNCHES[key]
    got = chol_append(*args)
    assert fused.LAUNCHES[key] == n0 + 1
    want = _chol_append_full_build(*args)
    torch.cuda.synchronize()
    assert torch.equal(got[3], want[0]) and torch.equal(got[4], want[1])


@pytest.mark.parametrize("nq", [1, 8, 256, 2048, 4096])
@pytest.mark.parametrize("family", FAMILIES)
def test_meanvar_ungated_kernel(dev, family, nq):
    """K5 against its plain version at the audit's batch sizes (the
    calibrations' few points, a polish's 256 and 2,048, the screen's
    4,096), training points included: mean within rel 1e-10; std within an
    absolute 1e-7 sqrt(sigma^2) y_scale (sigma^2 - |v|^2 cancels to ~0 at a
    training point); one launch per call."""
    p = surrogate(family, dev)
    key = count_key("meanvar_ungated", family)
    family = family_and_theta(family)[0]
    Xq = torch.rand((nq, 3), dtype=torch.float64, device=dev) * 2.2 - 1.1
    Xq[:min(nq, 40)] = p.X[:min(nq, 40)] * p.x_scale + p.x_loc
    _k5_same(family, p, Xq, key)


def _k5_same(family, p, Xq, key):
    """K5 against its plain version (the tolerances of
    test_meanvar_ungated_kernel), one launch."""
    n0 = fused.LAUNCHES[key]
    ma, sa = fused.meanvar_ungated(family, p, Xq)
    mb, sb = fused.meanvar_ungated_plain(family, p, Xq)
    torch.cuda.synchronize()
    assert fused.LAUNCHES[key] == n0 + 1
    _close(ma, mb, 1e-10)
    # sqrt(sigma^2): the largest prior variance among the queries
    prior = kernel_diag(family, p.theta, (Xq - p.x_loc) / p.x_scale)
    atol = 1e-7 * float(torch.sqrt(prior.max()) * p.y_scale)
    assert float(torch.max(torch.abs(sa - sb))) <= atol


# K5's and K8's shapes at d = 8 by route: the paths' (route 0), an odd nmax
# and n beyond route 0's shared memory (route 1)
UNGATED_SHAPES = {"paths": (224, 320, 0), "odd_nmax": (224, 321, 1),
                  "large_n": (700, 704, 1)}


@pytest.mark.parametrize("shape", sorted(UNGATED_SHAPES))
@pytest.mark.parametrize("family", ("rbf", "all_nodes"))
def test_meanvar_ungated_kernel_routes(dev, family, shape):
    """K5 (both instances) on each route at d = 8, at nq = 1, 8, 256,
    2,048 and 4,096, the first queries on training points."""
    n, nmax, route = UNGATED_SHAPES[shape]
    d = 8
    p = _k2_surrogate(family, dev, n, nmax, d, "fitted", "scalar")
    key = count_key("meanvar_ungated", family)
    fam = family_and_theta(family, d)[0]
    sd = fused._spec_doubles(fused._kern(fam, d, dev))
    rng = np.random.default_rng(n + nmax)
    for nq in (1, 8, 256, 2048, 4096):
        assert fused.meanvar_ungated_plan(n, nmax, d, nq, sd)[0] == route
        Xq = torch.as_tensor(_k2_queries(rng, nq, d), dtype=torch.float64,
                             device=dev)
        Xq[:min(nq, 16)] = p.X[:min(nq, 16)] * p.x_scale + p.x_loc
        _k5_same(fam, p, Xq, key)


def _gated_queries(p, rng, nq, d):
    """nq queries, the first two thirds (at least one) where K2's gates
    pass (inside the trust box, the SVM finite), the rest across and
    outside the trust box."""
    from gpry_tpu_torch.models.classifier import svm_decision
    t = lambda a: torch.as_tensor(a, dtype=torch.float64, device=p.X.device)
    inside = (2 * nq + 2) // 3
    cand = t(rng.uniform(-0.85, 0.85, (64 * inside, d)))
    ok = cand[svm_decision(p.svm, (cand - p.x_loc) / p.x_scale)]
    assert ok.shape[0] >= inside
    return torch.cat([ok[:inside], t(rng.uniform(-1.1, 1.1,
                                                 (nq - inside, d)))])


@pytest.mark.parametrize("family", ("rbf", "all_nodes"))
def test_meanvar_ungated_is_k2_ungated(dev, family):
    """Where K5 and K2 take route 0 with the same Q (the paths' shapes),
    they run one routine: K5's std equals K2's bit for bit wherever K2's
    gates pass (some query at each nq), and K5's mean equals K2's
    wherever the clip does not bite (some query over the batches)."""
    n, nmax, d = 224, 320, 8
    p = _k2_surrogate(family, dev, n, nmax, d, "fitted", "scalar")
    fam = family_and_theta(family, d)[0]
    sd = fused._spec_doubles(fused._kern(fam, d, dev))
    rng = np.random.default_rng(5)
    below = 0
    for nq in (1, 8, 256, 2048, 4096):
        assert fused.meanvar_ungated_plan(n, nmax, d, nq, sd)[:2] == \
            fused.gated_meanvar_logexp_plan(n, nmax, d, nq, sd)[:2]
        Xq = _gated_queries(p, rng, nq, d)
        m5, s5 = fused.meanvar_ungated(fam, p, Xq)
        m2, s2 = fused.gated_meanvar_logexp(fam, p, Xq)
        torch.cuda.synchronize()
        ok = torch.isfinite(m2)
        assert bool(ok.any())
        assert torch.equal(s5[ok], s2[ok])
        free = ok & (m5 < p.clip_max)
        below += int(free.sum())
        assert torch.equal(m5[free], m2[free])
    assert below


@pytest.mark.parametrize("family", ("rbf", "all_nodes"))
@pytest.mark.parametrize("d", (2, 8, 32))
def test_meanvar_ungated_plan_matches_the_kernel(dev, family, d):
    """fused.meanvar_ungated_plan gives sub_ungated_plan's route, queries
    a block and shared memory, and fused.meanstd_grad_plan k8_plan's, at
    an even and an odd nmax and for L's data 16-byte aligned or 8 bytes
    off."""
    fam = family_and_theta(family, d)[0]
    kern = fused._kern(fam, d, dev)
    spec = fused._spec_doubles(kern)
    lib = fused.library()
    for nq in (1, 1056, 1057, 4224, 4225, 65536):
        for n in (0, 1, 224, 640, 641, 5000):
            for nmax in (max(64, n + n % 2), max(65, n | 1)):
                qc = fused._sweep_queries_per_block(nmax, d, spec)
                for at in (4096, 4104):
                    aligned = at % 16 == 0
                    Q, sm = ctypes.c_int(), ctypes.c_size_t()
                    route, q, smem = fused.meanvar_ungated_plan(
                        n, nmax, d, nq, spec, aligned=aligned)
                    assert lib.gpry_meanvar_ungated_plan(
                        kern, nq, n, nmax, d, qc, ctypes.c_void_p(at),
                        ctypes.byref(Q), ctypes.byref(sm)) == route
                    assert (Q.value, sm.value) == (q, smem)
                    route, q, smem = fused.meanstd_grad_plan(
                        n, nmax, d, nq, spec, aligned=aligned)
                    assert lib.gpry_meanstd_grad_plan(
                        kern, nq, n, nmax, d, ctypes.c_void_p(at),
                        ctypes.byref(Q), ctypes.byref(sm)) == route
                    assert (Q.value, sm.value) == (q, smem)


def _fill_inputs(family, dev, noise, N=500, size=4, n=40, nmax=64,
                 grow=64, ls=None):
    """K4's inputs on the small surrogate (n of nmax rows, re-padded to
    ``grow``; a fast family's length scale ``ls``): candidates inside the
    trust box with their gated mean, std and LogExp values; scalar or
    per-row noise."""
    from gpry_tpu_torch.acquisition.base import grow_surrogate
    from gpry_tpu_torch.acquisition.functions import LogExp
    p = surrogate(family, dev, n=n, nmax=nmax, ls=ls)
    family = family_and_theta(family)[0]
    if noise == "vector":
        p = p.replace(noise_var=torch.linspace(1e-4, 1e-3, nmax,
                                               dtype=torch.float64,
                                               device=dev))
    p = grow_surrogate(p, grow)
    gen = torch.Generator(device=dev).manual_seed(3)
    Xc = torch.rand((N, 3), generator=gen, dtype=torch.float64,
                    device=dev) * 1.6 - 0.8
    y, sd = fused.gated_meanvar_logexp_plain(family, p, Xc)
    acqf = LogExp(dimension=3)
    acq0 = acqf.values(y, sd, p.y_max, 0.01)
    keep = torch.isfinite(acq0)
    Xc, y, sd, acq0 = Xc[keep], y[keep], sd[keep], acq0[keep]
    alive = torch.ones(len(Xc), dtype=torch.bool, device=dev)
    fn = lambda yy, ss: acqf.values(yy, ss, p.y_max, 0.01)
    return (p, Xc.contiguous(), y.contiguous(), sd.contiguous(),
            acq0.contiguous(), alive, size, fn), acqf


@pytest.mark.parametrize("noise", ["scalar", "vector"])
@pytest.mark.parametrize("family", FAMILIES)
def test_kriging_believer_fill_kernel(dev, family, noise):
    """K4 against its plain version: identical picks and -inf masks,
    conditioned values within rel 1e-10, with the LogExp epilogue in the
    sweep and with the acquisition applied in torch between the kernels;
    one sweep per conditioned round and one select per round."""
    key = count_key("kriging_believer_fill", family)
    args, acqf = _fill_inputs(family, dev, noise)
    family = family_and_theta(family)[0]
    ref = fused.kriging_believer_fill_plain(family, *args)
    for logexp in ((acqf.zeta, 0.01), None):
        n0 = fused.LAUNCHES[key]
        out = fused.kriging_believer_fill(family, *args, logexp=logexp)
        assert fused.LAUNCHES[key] == n0 + 2 * 4 - 1
        assert torch.equal(torch.isfinite(out[4]), torch.isfinite(ref[4]))
        assert bool(torch.isfinite(ref[4]).all())
        for a, b in zip(out[:4], ref[:4]):
            assert torch.equal(a, b)
        _close(out[4], ref[4], 1e-10)


def _same_fill(family, args, acqf, state=False):
    """K4 in both sweep modes against its plain version on ``args``:
    identical picks and -inf masks, outC within rel 1e-10; one select per
    round and one sweep per conditioned round.  With ``state``, every row
    the fill appended to L against a direct substitution of its pick (rel
    1e-12) and its diagonal entry against k22 + noise - |S12|^2."""
    key = "kriging_believer_fill" + ("/spec" if isinstance(family, tuple)
                                     else "")
    p, size = args[0], args[6]
    ref = fused.kriging_believer_fill_plain(family, *args)
    assert bool(torch.isfinite(ref[4]).all())
    for logexp in ((acqf.zeta, 0.01), None):
        n0 = fused.LAUNCHES[key]
        out = fused._kb_fill(family, *args, logexp) if state else \
            fused.kriging_believer_fill(family, *args, logexp=logexp)
        torch.cuda.synchronize()
        assert fused.LAUNCHES[key] == n0 + 2 * size - 1
        for a, b in zip(out[:4], ref[:4]):
            assert torch.equal(a, b)
        _close(out[4], ref[4], 1e-10)
        if state:
            Xbuf, L, n_dev = out[5:]
            assert int(n_dev) == p.n + size
            for r in range(p.n, p.n + size):
                k12 = kernel_matrix_rows(family, p.theta, Xbuf[:r],
                                         Xbuf[r:r + 1])[:, 0]
                S12 = torch.linalg.solve_triangular(
                    L[:r, :r], k12[:, None], upper=False)[:, 0]
                _close(L[r, :r], S12, 1e-12)
                noise = p.noise_var if p.noise_var.ndim == 0 \
                    else p.noise_var[r]
                k22 = kernel_diag(family, p.theta, Xbuf[r:r + 1])[0] + noise
                s22 = torch.sqrt(torch.clamp_min(
                    k22 - torch.sum(L[r, :r] ** 2), 1e-12))
                _close(L[r, r:r + 1], s22[None], 1e-12)


def kernel_matrix_rows(family, theta, A, B):
    from gpry_tpu_torch.ops.kernels import cross_kernel
    return cross_kernel(family, theta, A, B)


@pytest.mark.parametrize("family", ("rbf", "matern32", "all_nodes"))
def test_kriging_believer_fill_dead_and_partial_blocks(dev, family):
    """Blocks that mix dead and alive candidates (every third dead from
    the start) and N = 500 (not a multiple of the 8 candidates a block):
    the dead ride in their blocks and are never picked."""
    args, acqf = _fill_inputs(family, dev, "scalar")
    fam = family_and_theta(family)[0]
    alive = args[5].clone()
    alive[::3] = False
    args = args[:5] + (alive,) + args[6:]
    assert len(args[1]) % 8 != 0
    assert fused.kriging_believer_fill_plan(
        43, 64, 3, len(args[1]),
        fused._spec_doubles(fused._kern(fam, 3, dev)))[:2] == (0, 8)
    _same_fill(fam, args, acqf)
    out = fused.kriging_believer_fill(fam, *args, logexp=(acqf.zeta, 0.01))
    picks = [int(torch.nonzero(torch.all(args[1] == x, dim=1))[0, 0])
             for x in out[0]]
    assert all(i % 3 != 0 for i in picks)


@pytest.mark.parametrize("noise", ["scalar", "vector"])
@pytest.mark.parametrize("family", ("rbf", "all_nodes"))
def test_kriging_believer_fill_odd_nmax(dev, family, noise):
    """An odd nmax (65): the sweep takes route 1 (the warp chain) and the
    round-0 append warp 0's chain; both sweep modes match the plain
    version, and every appended row its direct substitution."""
    args, acqf = _fill_inputs(family, dev, noise, grow=65)
    fam = family_and_theta(family)[0]
    spec = fused._spec_doubles(fused._kern(fam, 3, dev))
    assert args[0].L.shape == (65, 65)
    for nq in (1, len(args[1])):
        assert fused.kriging_believer_fill_plan(40, 65, 3, nq,
                                                spec)[0] == 1
    _same_fill(fam, args, acqf, state=True)


@pytest.mark.parametrize("noise", ["scalar", "vector"])
@pytest.mark.parametrize("family", ("rbf", "all_nodes"))
def test_kriging_believer_fill_appends_the_swept_row(dev, family, noise):
    """Every row the fill appends (round 0's solved in the select, the
    others copied from the sweep's solved rows) equals a direct
    substitution of the pick against the factor at that round's n, within
    rel 1e-12, with its diagonal entry; of 8,000 candidates drawn, the
    more than 1,056 with a finite acquisition make the sweep take 16
    candidates a block."""
    args, acqf = _fill_inputs(family, dev, noise, N=8000, size=5)
    fam = family_and_theta(family)[0]
    assert len(args[1]) > 1056
    spec = fused._spec_doubles(fused._kern(fam, 3, dev))
    assert fused.kriging_believer_fill_plan(44, 64, 3, len(args[1]),
                                            spec)[:2] == (0, 16)
    _same_fill(fam, args, acqf, state=True)


@pytest.mark.parametrize("family", ("rbf", "matern52"))
def test_kriging_believer_fill_only_q8_fits(dev, family):
    """Past the n at which 16 candidates a block no longer fit in shared
    memory (N = 1,100 candidates, d = 3; ~550 training points, a length
    scale of 0.08 so that the factor stays well conditioned), the sweep
    keeps route 0 with 8 a block, and the fill matches its plain
    version."""
    from gpry_tpu_torch.config import bucket_size
    fam = family_and_theta(family)[0]
    spec = fused._spec_doubles(fused._kern(fam, 3, dev))
    plan = fused.kriging_believer_fill_plan
    n = 300
    while plan(n + 3, bucket_size(n + 4), 3, 1100, spec)[1] == 16:
        n += 8
    nmax = bucket_size(n + 4)
    assert plan(n, nmax, 3, 1100, spec)[:2] == (0, 8)
    assert plan(n + 3, nmax, 3, 1100, spec)[:2] == (0, 8)
    args, acqf = _fill_inputs(family, dev, "scalar", N=3000, n=n, nmax=nmax,
                              grow=nmax, ls=0.08)
    assert len(args[1]) > 1056
    _same_fill(fam, args, acqf, state=True)


@pytest.mark.parametrize("family", ("rbf", "all_nodes"))
@pytest.mark.parametrize("d", (2, 8, 32))
def test_kriging_believer_fill_plan_matches_the_kernel(dev, family, d):
    """fused.kriging_believer_fill_plan gives k4_plan's route, candidates
    a block and shared memory, at an even and an odd nmax and for L's data
    16-byte aligned or 8 bytes off."""
    fam = family_and_theta(family, d)[0]
    kern = fused._kern(fam, d, dev)
    spec = fused._spec_doubles(kern)
    lib = fused.library()
    for nq in (1, 500, 1056, 1057, 4096, 4224, 4225):
        for n in (0, 1, 224, 600, 1200, 5000):
            for nmax in (max(64, n + 8 + n % 2), max(65, (n + 8) | 1)):
                qc = fused._sweep_queries_per_block(nmax, d, spec)
                for at in (4096, 4104):
                    route, q, smem = fused.kriging_believer_fill_plan(
                        n, nmax, d, nq, spec, aligned=at % 16 == 0)
                    Q, sm = ctypes.c_int(), ctypes.c_size_t()
                    assert lib.gpry_kb_plan(
                        kern, nq, n, nmax, d, qc, ctypes.c_void_p(at),
                        ctypes.byref(Q), ctypes.byref(sm)) == route
                    assert (Q.value, sm.value) == (q, smem)


def test_kernels_refuse_grad_and_float32(dev):
    p = surrogate("rbf", dev)
    Xq = torch.zeros((4, 3), dtype=torch.float64, device=dev)
    with pytest.raises(RuntimeError, match="requires grad"):
        fused.gated_mean("rbf", p, Xq.clone().requires_grad_(True))
    with pytest.raises(TypeError, match="float64"):
        fused.gated_mean("rbf", p, Xq.float())


@pytest.mark.parametrize("nq", [1, 63, 64, 65, 1000, 1024, 1025])
@pytest.mark.parametrize("family", FAMILIES)
def test_predict_meancov_kernel(dev, family, nq):
    """K7 against its plain version, training points among the queries,
    about the product's 64-query tiles: the mean within rel 1e-10; the
    covariance within an absolute 1e-10 max|K(Xq, Xq)| (K - V^T V cancels
    near the training points) and symmetric bit for bit; two launches per
    call."""
    p = surrogate(family, dev)
    key = count_key("predict_meancov", family)
    family = family_and_theta(family)[0]
    Xq = torch.rand((nq, 3), dtype=torch.float64, device=dev) * 2.2 - 1.1
    Xq[:min(nq, 40)] = p.X[:min(nq, 40)]
    n0 = fused.LAUNCHES[key]
    ma, ca = fused.predict_meancov(family, p.theta, p.X, p.n, p.noise_var,
                                   p.L, p.alpha, Xq)
    mb, cb = fused.predict_meancov_plain(family, p.theta, p.X, p.n,
                                         p.noise_var, p.L, p.alpha, Xq)
    torch.cuda.synchronize()
    assert fused.LAUNCHES[key] == n0 + 2
    _close(ma, mb, 1e-10)
    kqq = fused.predict_meancov_plain(family, p.theta, p.X, 0, p.noise_var,
                                      p.L, p.alpha, Xq)[1]
    atol = 1e-10 * float(torch.max(torch.abs(kqq)))
    assert float(torch.max(torch.abs(ca - cb))) <= atol
    assert torch.equal(ca, ca.T)


def _k7_sigma(p, cov):
    """sqrt(max(diag(cov), 0)) y_scale: K7's sigma in K5's units."""
    return torch.sqrt(torch.clamp_min(torch.diagonal(cov), 0.0)) * p.y_scale


@pytest.mark.parametrize("layout", ("aligned", "odd_nmax", "offset"))
@pytest.mark.parametrize("n", (17, 223, 224))
@pytest.mark.parametrize("family", ("rbf", "matern32", "all_nodes"))
def test_predict_meancov_sigma_is_k5s(dev, family, n, layout):
    """K7's solve takes K5's route and queries a block at every nq (route 0
    for an aligned L, route 1 for an odd nmax or L 8 bytes off) and forms
    diag(cov) as K5 forms its variance, so sqrt(max(diag(cov), 0)) y_scale
    equals K5's sigma bit for bit, both with K7 given the queries as
    GaussianProcessRegressor.predict preprocesses them ((x - x_loc) /
    x_scale in torch, which divides as K5's kernel does) and with K5 given
    them preprocessed and an identity transform; an odd n pads V's rows.
    The covariance matches its plain version and is symmetric bit for
    bit."""
    from gpry_tpu_torch.config import bucket_size
    d = 8
    nmax = bucket_size(n) + (layout == "odd_nmax")
    fam = family_and_theta(family, d)[0]
    sd = fused._spec_doubles(fused._kern(fam, d, dev))
    p = _k2_surrogate(family, dev, n, nmax, d, "fitted", "scalar")
    if layout == "offset":
        p = p.replace(L=_at_offset(p.L))
    aligned = p.L.data_ptr() % 16 == 0
    ident = p.replace(x_loc=torch.zeros_like(p.x_loc),
                      x_scale=torch.ones_like(p.x_scale))
    rng = np.random.default_rng(n + nmax)
    for nq in (1, 64, 65, 1024):
        plan = fused.predict_meancov_plan(n, nmax, d, nq, sd, aligned)
        assert plan[:3] == fused.meanvar_ungated_plan(n, nmax, d, nq, sd,
                                                      aligned)
        assert plan[0] == (layout != "aligned")
        Xraw = torch.as_tensor(_k2_queries(rng, nq, d), dtype=torch.float64,
                               device=dev)
        Xraw[:min(nq, 16)] = p.X[:min(nq, 16)] * p.x_scale + p.x_loc
        Xp = ((Xraw - p.x_loc) / p.x_scale).contiguous()
        args = (p.theta, p.X, p.n, p.noise_var, p.L, p.alpha, Xp)
        ma, ca = fused.predict_meancov(fam, *args)
        mb, cb = fused.predict_meancov_plain(fam, *args)
        s5 = fused.meanvar_ungated(fam, p, Xraw)[1]
        s5p = fused.meanvar_ungated(fam, ident, Xp)[1]
        torch.cuda.synchronize()
        assert torch.equal(_k7_sigma(p, ca), s5p)
        assert torch.equal(_k7_sigma(p, ca), s5)
        assert torch.equal(ca, ca.T)
        _close(ma, mb, 1e-10)
        kqq = fused.predict_meancov_plain(fam, p.theta, p.X, 0, p.noise_var,
                                          p.L, p.alpha, Xp)[1]
        atol = 1e-10 * float(torch.max(torch.abs(kqq)))
        assert float(torch.max(torch.abs(ca - cb))) <= atol


@pytest.mark.parametrize("family", ("rbf", "all_nodes"))
@pytest.mark.parametrize("d", (2, 8, 32))
def test_predict_meancov_plan_matches_the_kernel(dev, family, d):
    """fused.predict_meancov_plan gives k7_plan's solve route, queries a
    block and shared memory, and the product's tiles and shared memory, at
    an even and an odd nmax and for L's data 16-byte aligned or 8 bytes
    off; beyond the product's shared memory both refuse."""
    fam = family_and_theta(family, d)[0]
    kern = fused._kern(fam, d, dev)
    spec = fused._spec_doubles(kern)
    lib = fused.library()
    Q, sa, tiles, sb = ctypes.c_int(), ctypes.c_size_t(), ctypes.c_int(), \
        ctypes.c_size_t()
    refs = [ctypes.byref(x) for x in (Q, sa, tiles, sb)]
    for nq in (1, 63, 64, 65, 1056, 1057, 4224, 4225, 65536):
        for n in (0, 1, 17, 224, 640, 641, 5000):
            for nmax in (max(64, n + n % 2), max(65, n | 1)):
                qc = fused._sweep_queries_per_block(nmax, d, spec)
                for at in (4096, 4104):
                    route, q, smem, _, nt, smem_b = \
                        fused.predict_meancov_plan(n, nmax, d, nq, spec,
                                                   aligned=at % 16 == 0)
                    assert lib.gpry_predict_meancov_plan(
                        kern, nq, n, nmax, d, qc, ctypes.c_void_p(at),
                        *refs) == route
                    assert (Q.value, sa.value, tiles.value, sb.value) == \
                        (q, smem, nt, smem_b)
    if family == "rbf":
        big = 400
        with pytest.raises(ValueError, match="shared memory"):
            fused.predict_meancov_plan(224, 320, big, 64)
        kb = fused._kern(fam, big, dev)
        assert lib.gpry_predict_meancov_plan(
            kb, 64, 224, 320, big, 8, ctypes.c_void_p(4096), *refs) == -1


def test_spec_beyond_the_kernel_limits_raises(dev):
    """A spec of more nodes than the kernels take raises for CUDA tensors
    (no fallback), before any launch."""
    p = surrogate("rbf", dev)
    spec = ("white",)
    for _ in range(fused.SPEC_MAX_NODES // 2):
        spec = ("sum", ("white",), spec)
    theta = torch.zeros(fused.SPEC_MAX_NODES // 2 + 1, dtype=torch.float64,
                        device=dev)
    p = p.replace(theta=theta)
    Xq = torch.zeros((4, 3), dtype=torch.float64, device=dev)
    n0 = dict(fused.LAUNCHES)
    with pytest.raises(ValueError, match="at most"):
        fused.gated_mean(spec, p, Xq)
    with pytest.raises(ValueError, match="at most"):
        fused.predict_meancov(spec, theta, p.X, p.n, p.noise_var, p.L,
                              p.alpha, Xq)
    assert fused.LAUNCHES == n0


# K8 and K9 at d = 2, 8 (the main paths' n 224 of nmax 320) and 16: n 1,100
# of nmax 1,152 stages X in more than 48 KB of shared memory, n 1,800 reads
# it from global memory (beyond the 227 KB a block holds); K8 alone also at
# an odd nmax.  K8 takes its route 0 at the first two, route 1 at the rest.
GRAD_SHAPES = [(2, 40, 64), (8, 224, 320), (16, 1100, 1152),
               (16, 1800, 1856), (8, 224, 321)]


def grad_cases(shapes):
    """(family, d, n, nmax): every family at d <= 8; RBF and the specs at
    d = 16 (as K6's d = 16 test)."""
    return [(f, *sh) for sh in shapes for f in FAMILIES
            if sh[0] < 16 or f not in FAST[1:]]


def _grad_surrogate(family, dev, d, n, nmax):
    """The small surrogate at (d, n, nmax), with no upper clip (the
    smooth objective's clip is checked on the CPU)."""
    p = surrogate(family, dev, n=n, nmax=nmax, d=d)
    return p.replace(clip_max=torch.tensor(torch.inf, dtype=torch.float64,
                                           device=dev))


def _rel_max(a, b):
    """max |a - b| / max |b| over all entries (both finite)."""
    assert bool(torch.isfinite(a).all()) and bool(torch.isfinite(b).all())
    return float(torch.max(torch.abs(a - b)) / torch.max(torch.abs(b)))


@pytest.mark.parametrize("family,d,n,nmax", grad_cases(GRAD_SHAPES))
def test_meanstd_grad_kernel(dev, family, d, n, nmax):
    """K8 against its plain version (autograd) at nq = 1, 8, 32, 300 and
    1,024 (the generic ascent's lanes, predict's draws), the first 16
    queries on training points: mean and std within rel 1e-10, both
    gradients within 1e-8 of their max |.|; one launch per call, on the
    route its plan gives (route 0 for the first two shapes)."""
    p = _grad_surrogate(family, dev, d, n, nmax)
    key = count_key("meanstd_grad", family)
    family = family_and_theta(family, d)[0]
    sd = fused._spec_doubles(fused._kern(family, d, dev))
    for nq in (1, 8, 32, 300, 1024):
        assert fused.meanstd_grad_plan(n, nmax, d, nq, sd)[0] == \
            (0 if (n, nmax) in ((40, 64), (224, 320)) else 1)
        Xq = torch.rand((nq, d), dtype=torch.float64, device=dev) * 2.0 - 1.0
        Xq[:min(nq, 16)] = p.X[:min(nq, 16)] * p.x_scale + p.x_loc
        n0 = fused.LAUNCHES[key]
        out = fused.meanstd_grad(family, p, Xq)
        torch.cuda.synchronize()
        assert fused.LAUNCHES[key] == n0 + 1
        ref = fused.meanstd_grad_plain(family, p, Xq)
        for a, b, tol in zip(out, ref, (1e-10, 1e-10, 1e-8, 1e-8)):
            assert _rel_max(a, b) <= tol


@pytest.mark.parametrize("family", ("rbf", "all_nodes"))
@pytest.mark.parametrize("d,n,nmax", ((2, 40, 64), (8, 224, 320)))
def test_meanstd_grad_mean_std_are_k5s(dev, family, d, n, nmax):
    """Where K8 and K5 take route 0 with the same Q, K8's mean and std are
    K5's operations: equal bit for bit, at nq = 1, 8, 32, 300 and 1,024."""
    p = _grad_surrogate(family, dev, d, n, nmax)
    fam = family_and_theta(family, d)[0]
    sd = fused._spec_doubles(fused._kern(fam, d, dev))
    for nq in (1, 8, 32, 300, 1024):
        r8 = fused.meanstd_grad_plan(n, nmax, d, nq, sd)
        assert r8[0] == 0 and r8 == fused.meanvar_ungated_plan(n, nmax, d,
                                                               nq, sd)
        Xq = torch.rand((nq, d), dtype=torch.float64, device=dev) * 2.0 - 1.0
        Xq[:min(nq, 16)] = p.X[:min(nq, 16)] * p.x_scale + p.x_loc
        m8, s8 = fused.meanstd_grad(fam, p, Xq)[:2]
        m5, s5 = fused.meanvar_ungated(fam, p, Xq)
        torch.cuda.synchronize()
        assert torch.equal(m8, m5) and torch.equal(s8, s5)


@pytest.mark.parametrize("clip", (False, True), ids=("noclip", "clip"))
@pytest.mark.parametrize("family,d,n,nmax", grad_cases(GRAD_SHAPES[:3]))
def test_lbfgs_logexp_ascent_kernel(dev, family, d, n, nmax, clip):
    """K9 against its plain version (the lock-step torch L-BFGS over the
    autograd LogExp), lane 0 starting on a training point; with ``clip``,
    an upper clip at the median of the mean at the starts, so that half
    of the lanes start where min(mean, clip_max) passes no gradient.
    Lane by lane and step for step over 3 iterations (no lane near its
    stall yet): the same nev, x within 1e-9 of the box width, f within
    1e-10 (1 + |f|).  With no clip also to the end (maxiter 100), by the
    pick: the best f within 1e-9 (1 + |f|) and its x within 1e-7 of the
    box width.  Lanes are not compared at the end: near an optimum the
    stall test (an improvement of 16 eps (1 + |f|)) and the last line
    search decide on rounding that the two summation orders do not share
    (nev differs), and on a multimodal surface such a flip can send a lane
    to another optimum (ALL_NODES at d = 16: one lane of 8 ended 0.70
    away); with the clip, lanes on the flat side climb the std to maxiter.
    One launch per call."""
    p = _grad_surrogate(family, dev, d, n, nmax)
    key = count_key("lbfgs_logexp_ascent", family)
    family = family_and_theta(family, d)[0]
    lo = torch.full((d,), -1.0, dtype=torch.float64, device=dev)
    hi = -lo
    gen = torch.Generator(device=dev).manual_seed(d)
    x0s = torch.rand((8, d), generator=gen, dtype=torch.float64,
                     device=dev) * 2.0 - 1.0
    x0s[0] = p.X[n - 1] * p.x_scale + p.x_loc
    if clip:
        mu0 = fused.meanvar_ungated_plain(family, p, x0s)[0]
        p = p.replace(clip_max=torch.quantile(mu0, 0.5))
    zeta, noise = d ** -0.85, 0.01
    stages = ((3, 1e-9, 1e-10),) + (() if clip else ((100, 1e-7, 1e-9),))
    for maxiter, tol_x, tol_f in stages:
        n0 = fused.LAUNCHES[key]
        xs, f, nev = fused.lbfgs_logexp_ascent(family, p, zeta, noise, x0s,
                                               lo, hi, maxiter=maxiter)
        torch.cuda.synchronize()
        assert fused.LAUNCHES[key] == n0 + 1
        xr, fr, nevr = fused.lbfgs_logexp_ascent_plain(
            family, p, zeta, noise, x0s, lo, hi, maxiter=maxiter)
        if maxiter == 3:
            assert nev.tolist() == nevr.tolist()
        else:
            # the pick
            xs, f, xr, fr = xs[f.argmin()], f.min(), xr[fr.argmin()], fr.min()
        assert float(torch.max(torch.abs(xs - xr))) <= tol_x * 2.0
        assert bool(torch.all(torch.abs(f - fr)
                              <= tol_f * (1 + torch.abs(fr))))


def test_grad_kernels_refuse(dev):
    """K8 and K9 refuse float32, tensors that require grad, and d above
    the per-thread arrays, before any launch."""
    p = surrogate("rbf", dev)
    d = fused.GRAD_MAX_D + 1
    big = surrogate("rbf", dev, n=8, nmax=16, d=d, nsv=2)
    Xq = torch.zeros((4, 3), dtype=torch.float64, device=dev)
    lo, hi = Xq[0] - 1.0, Xq[0] + 1.0
    n0 = dict(fused.LAUNCHES)
    with pytest.raises(RuntimeError, match="requires grad"):
        fused.meanstd_grad("rbf", p, Xq.clone().requires_grad_(True))
    with pytest.raises(TypeError, match="float64"):
        fused.meanstd_grad("rbf", p, Xq.float())
    with pytest.raises(RuntimeError, match="requires grad"):
        fused.lbfgs_logexp_ascent("rbf", p, 0.5, 0.01,
                                  Xq.clone().requires_grad_(True), lo, hi)
    with pytest.raises(TypeError, match="float64"):
        fused.lbfgs_logexp_ascent("rbf", p, 0.5, 0.01, Xq.float(), lo, hi)
    Xb = torch.zeros((2, d), dtype=torch.float64, device=dev)
    with pytest.raises(ValueError, match="per-thread"):
        fused.meanstd_grad("rbf", big, Xb)
    with pytest.raises(ValueError, match="per-thread"):
        fused.lbfgs_logexp_ascent("rbf", big, 0.5, 0.01, Xb, Xb[0] - 1.0,
                                  Xb[0] + 1.0)
    assert fused.LAUNCHES == n0


def test_runner_refuses_d_above_grad_kernels(dev):
    """On the card the BatchOptimizer's ascent runs K8 / K9, which hold
    d <= GRAD_MAX_D = 64: a default Runner at d = 65 raises ValueError
    when it is built, before any truth evaluation."""
    from gpry_tpu_torch.run import Runner
    d = 65
    assert d == fused.GRAD_MAX_D + 1
    calls = []

    def loglike(X):
        calls.append(X)
        return -0.5 * float(np.sum(np.asarray(X) ** 2))

    with pytest.raises(ValueError, match="d=65 > 64"):
        Runner(loglike, [[-1.0, 1.0]] * d, verbose=0)
    assert not calls


@pytest.mark.parametrize("d", (33, 48))
def test_default_runner_builds_up_to_d48(dev, d):
    """A default Runner (BatchOptimizer, its default budget 70 d^1.5: 23,278
    points at d = 48) builds on the card at d = 33 and 48, its range check
    passing for K11, K9 and K8, with no truth evaluation; at d = 49 the
    fit's range (K11) refuses it."""
    from gpry_tpu_torch.acquisition.batch_optimizer import BatchOptimizer
    from gpry_tpu_torch.run import Runner
    calls = []

    def loglike(X):
        calls.append(X)
        return -0.5 * float(np.sum(np.asarray(X) ** 2))

    runner = Runner(loglike, [[-1.0, 1.0]] * d, verbose=0)
    assert isinstance(runner.acquisition, BatchOptimizer)
    assert runner.max_total == int(70 * d ** 1.5)
    with pytest.raises(ValueError, match="lbfgs_lml_fit"):
        Runner(loglike, [[-1.0, 1.0]] * 49, verbose=0)
    assert not calls


# K8 and K9 at d = 33-64, their d <= 64 instance (two coordinates a lane,
# the gradient sums in two passes of 32): (d, n, nmax) at the instance's
# first d, chip_smoke.py's path (n) width and its last, on K8's route 0
# (n 40 of 64, 224 of 320), its route 1 (n 700 of 704, beyond route 0;
# an odd nmax) and K9's routes 0 and 1; the training points in a cube
# of side sqrt(3 / d) about the centre, so that the kernel values are
# those of a d = 3 surrogate's, not ~1e-15
WIDE_SHAPES = [(33, 40, 64), (40, 224, 320), (64, 700, 704), (40, 224, 321)]


def _wide_surrogate(family, dev, d, n, nmax):
    p = surrogate(family, dev, n=n, nmax=nmax, d=d, side=float(np.sqrt(
        3.0 / d)))
    return p.replace(clip_max=torch.tensor(torch.inf, dtype=torch.float64,
                                           device=dev))


def _wide_queries(p, nq, d, seed):
    """nq raw queries in the training cube (raw = 2 x - 1), the first 4 on
    training points."""
    gen = torch.Generator(device=p.X.device).manual_seed(seed)
    half = float(np.sqrt(3.0 / d))
    Xq = (torch.rand((nq, d), generator=gen, dtype=torch.float64,
                     device=p.X.device) * 2.0 - 1.0) * half
    Xq[:min(nq, 4)] = p.X[:min(nq, 4)] * p.x_scale + p.x_loc
    return Xq


@pytest.mark.parametrize("family", ("rbf", "all_nodes"))
@pytest.mark.parametrize("d,n,nmax", WIDE_SHAPES)
def test_meanstd_grad_kernel_wide(dev, family, d, n, nmax):
    """K8's d <= 64 instance against its plain version at nq = 1, 8 and
    300: mean and std within rel 1e-10, both gradients within 1e-8 of
    their max |.| (test_meanstd_grad_kernel's tolerances), the gradients'
    coordinates past 32 not all zero; one launch a call, on the route its
    plan gives (route 0 at n 40 and 224 of an even nmax)."""
    p = _wide_surrogate(family, dev, d, n, nmax)
    key = count_key("meanstd_grad", family)
    fam = family_and_theta(family, d)[0]
    sd = fused._spec_doubles(fused._kern(fam, d, dev))
    for nq in (1, 8, 300):
        route = fused.meanstd_grad_plan(n, nmax, d, nq, sd)[0]
        assert route == (0 if n < 640 and nmax % 2 == 0 else 1)
        Xq = _wide_queries(p, nq, d, nq)
        n0 = fused.LAUNCHES[key]
        out = fused.meanstd_grad(fam, p, Xq)
        torch.cuda.synchronize()
        assert fused.LAUNCHES[key] == n0 + 1
        ref = fused.meanstd_grad_plain(fam, p, Xq)
        for a, b, tol in zip(out, ref, (1e-10, 1e-10, 1e-8, 1e-8)):
            assert _rel_max(a, b) <= tol
        assert bool(torch.any(ref[2][:, 32:] != 0.0))


@pytest.mark.parametrize("family", ("rbf", "all_nodes"))
@pytest.mark.parametrize("d,n,nmax", WIDE_SHAPES[:3])
def test_lbfgs_logexp_ascent_kernel_wide(dev, family, d, n, nmax):
    """K9's d <= 64 instance against its plain version, 8 lanes, lane 0 on
    a training point (test_lbfgs_logexp_ascent_kernel's check): step for
    step over 3 iterations, the same nev, x within 1e-9 of the box width,
    f within 1e-10 (1 + |f|); to the end (maxiter 100) by the pick: the
    best f within 1e-9 (1 + |f|).  One launch a call."""
    p = _wide_surrogate(family, dev, d, n, nmax)
    key = count_key("lbfgs_logexp_ascent", family)
    fam = family_and_theta(family, d)[0]
    half = float(np.sqrt(3.0 / d))
    lo = torch.full((d,), -half, dtype=torch.float64, device=dev)
    x0s = torch.cat([p.X[n - 1:n] * p.x_scale + p.x_loc,
                     _wide_queries(p, 11, d, d)[4:]])
    zeta, noise = d ** -0.85, 0.01
    for maxiter, tol_x, tol_f in ((3, 1e-9, 1e-10), (100, None, 1e-9)):
        n0 = fused.LAUNCHES[key]
        xs, f, nev = fused.lbfgs_logexp_ascent(fam, p, zeta, noise, x0s, lo,
                                               -lo, maxiter=maxiter)
        torch.cuda.synchronize()
        assert fused.LAUNCHES[key] == n0 + 1
        xr, fr, nevr = fused.lbfgs_logexp_ascent_plain(
            fam, p, zeta, noise, x0s, lo, -lo, maxiter=maxiter)
        if tol_x is not None:
            assert nev.tolist() == nevr.tolist()
            assert float(torch.max(torch.abs(xs - xr))) <= tol_x * 2 * half
            assert bool(torch.all(torch.abs(f - fr)
                                  <= tol_f * (1 + torch.abs(fr))))
        else:
            assert abs(float(f.min() - fr.min())) <= \
                tol_f * (1 + abs(float(fr.min())))


@pytest.mark.parametrize("family", ("rbf", "all_nodes"))
@pytest.mark.parametrize("d", (8, 40))
def test_lbfgs_logexp_ascent_kernel_global_route(dev, family, d):
    """K9 on both sides of its route-3 edge (the last n of route 2 and the
    next, where alpha and k leave shared memory for global memory; d = 8
    the d <= 32 instance, d = 40 the d <= 64 one), 2 lanes from starts in
    the training cube, against its plain version over 3 iterations: the
    same nev, x within 1e-7 of the box width, f within 1e-9 (1 + |f|)
    (test_lbfgs_logexp_ascent_kernel_large_n's tolerances); the launch
    takes the route its plan gives."""
    key = count_key("lbfgs_logexp_ascent", family)
    fam = family_and_theta(family, d)[0]
    sd = fused._spec_doubles(fused._kern(fam, d, dev))
    edge = _plan_edges(lambda m: fused.lbfgs_logexp_ascent_plan(m, d,
                                                                sd))[2]
    half = float(np.sqrt(3.0 / d))
    lo = torch.full((d,), -half, dtype=torch.float64, device=dev)
    for n, route in ((edge, 2), (edge + 1, 3)):
        assert fused.lbfgs_logexp_ascent_plan(n, d, sd)[0] == route
        p = _wide_surrogate(family, dev, d, n, n + 8)
        x0s = _wide_queries(p, 6, d, n)[4:]
        n0 = fused.LAUNCHES[key]
        xs, f, nev = fused.lbfgs_logexp_ascent(fam, p, d ** -0.85, 0.01,
                                               x0s, lo, -lo, maxiter=3)
        torch.cuda.synchronize()
        assert fused.LAUNCHES[key] == n0 + 1
        xr, fr, nevr = fused.lbfgs_logexp_ascent_plain(
            fam, p, d ** -0.85, 0.01, x0s, lo, -lo, maxiter=3)
        assert nev.tolist() == nevr.tolist()
        assert float(torch.max(torch.abs(xs - xr))) <= 1e-7 * 2 * half
        assert bool(torch.all(torch.abs(f - fr)
                              <= 1e-9 * (1 + torch.abs(fr))))
        del p


@pytest.mark.parametrize("family", ("rbf", "all_nodes"))
@pytest.mark.parametrize("d", (8, 40))
def test_meanstd_grad_kernel_global_route(dev, family, d):
    """K8 on both sides of its route-2 edge (the last n of route 1 and the
    next, where alpha and the work vector leave shared memory), at nq = 1
    and 4, against its plain version: mean and std within rel 1e-10, both
    gradients within 1e-8 of their max |.|; one launch a call."""
    key = count_key("meanstd_grad", family)
    fam = family_and_theta(family, d)[0]
    sd = fused._spec_doubles(fused._kern(fam, d, dev))
    edge = _plan_edges(lambda m: fused.meanstd_grad_plan(m, m + m % 2, d,
                                                         4, sd))[1]
    for n, route in ((edge, 1), (edge + 1, 2)):
        p = _wide_surrogate(family, dev, d, n, n | 1)
        for nq in (1, 4):
            assert fused.meanstd_grad_plan(n, n | 1, d, nq, sd)[0] == route
            Xq = _wide_queries(p, nq, d, nq)
            n0 = fused.LAUNCHES[key]
            out = fused.meanstd_grad(fam, p, Xq)
            torch.cuda.synchronize()
            assert fused.LAUNCHES[key] == n0 + 1
            ref = fused.meanstd_grad_plain(fam, p, Xq)
            for a, b, tol in zip(out, ref, (1e-10, 1e-10, 1e-8, 1e-8)):
                assert _rel_max(a, b) <= tol
        del p


@pytest.mark.parametrize("family", ("rbf", "all_nodes"))
@pytest.mark.parametrize("d", (33, 40, 64))
def test_meanstd_grad_plan_matches_the_kernel_wide(dev, family, d):
    """fused.meanstd_grad_plan gives k8_plan's route, queries a block and
    shared memory at d = 33-64, about each route's edge, at an even and an
    odd nmax; gpry_meanstd_grad_work is route 2's n doubles a block of its
    grid (one a query, at most 4 an SM) and 0 elsewhere."""
    fam = family_and_theta(family, d)[0]
    kern = fused._kern(fam, d, dev)
    sd = fused._spec_doubles(kern)
    lib = fused.library()
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    at = ctypes.c_void_p(4096)
    for nq in (1, 8, 1024):
        edges = _plan_edges(lambda m: fused.meanstd_grad_plan(m, m | 1, d,
                                                              nq, sd))
        ns = {1, 224, 600, 700, 30000}
        for e in edges[:2]:
            ns |= {e - 1, e, e + 1}
        for n in sorted(ns):
            for nmax in (n + n % 2, n | 1):
                Q, sm = ctypes.c_int(), ctypes.c_size_t()
                route, q, smem = fused.meanstd_grad_plan(n, nmax, d, nq, sd)
                assert lib.gpry_meanstd_grad_plan(
                    kern, nq, n, nmax, d, at, ctypes.byref(Q),
                    ctypes.byref(sm)) == route
                assert (Q.value, sm.value) == (q, smem)
                work = lib.gpry_meanstd_grad_work(kern, nq, n, nmax, d, at)
                assert work == (min(nq, 4 * sms) * n if route == 2 else 0)


@pytest.mark.parametrize("family", ("rbf", "all_nodes"))
def test_smooth_surrogate_autograd_on_k8(dev, family):
    """surrogate_mean_std_smooth on the card is K8 in an autograd Function:
    its gradient of any weighting of mean and std is the plain autograd's
    (rel 1e-8), one K8 launch per forward, and double backward raises."""
    from gpry_tpu_torch.models.gp import surrogate_mean_std_smooth
    p = _grad_surrogate(family, dev, 3, 40, 64)
    key = count_key("meanstd_grad", family)
    family = family_and_theta(family)[0]
    Xq = torch.rand((20, 3), dtype=torch.float64, device=dev) * 2.0 - 1.0
    w = torch.linspace(-1.0, 2.0, 20, dtype=torch.float64, device=dev)
    n0 = fused.LAUNCHES[key]
    Xg = Xq.clone().requires_grad_(True)
    m, s = surrogate_mean_std_smooth(family, p, Xg)
    g, = torch.autograd.grad((w * m + s * s).sum(), Xg, create_graph=True)
    assert fused.LAUNCHES[key] == n0 + 1
    Xr = Xq.clone().requires_grad_(True)
    mr, sr = fused.meanvar_ungated_plain(family, p, Xr)
    gr, = torch.autograd.grad((w * mr + sr * sr).sum(), Xr)
    assert _rel_max(g.detach(), gr) <= 1e-8
    with pytest.raises(RuntimeError, match="twice"):
        g.sum().backward()


def _lml_data(dev, n, nmax, d=3, seed=0):
    """Padded training data for the fit's kernels: n points in the unit
    cube (a smooth target), the rest zero."""
    rng = np.random.default_rng(seed)
    X = torch.zeros((nmax, d), dtype=torch.float64, device=dev)
    X[:n] = torch.as_tensor(rng.uniform(0, 1, (n, d)), device=dev)
    y = torch.zeros(nmax, dtype=torch.float64, device=dev)
    y[:n] = torch.sin(3 * X[:n]).sum(1)
    return X, y


def _lml_thetas(family, dev, R, d=3, seed=1):
    """R moderate theta rows (well-conditioned K) around the family's
    theta; the kernel argument."""
    fam, theta = family_and_theta(family, d)
    rng = np.random.default_rng(seed)
    th = theta + rng.uniform(-0.3, 0.3, (R, len(theta)))
    return fam, torch.as_tensor(th, dtype=torch.float64, device=dev)


@pytest.mark.parametrize("n,nmax", [(25, 32), (224, 320), (700, 704)])
@pytest.mark.parametrize("noise", ["scalar", "vector"])
@pytest.mark.parametrize("family", FAMILIES)
def test_lml_value_grad_kernel(dev, family, noise, n, nmax):
    """K10 against its plain version: value mode on 40 rows (more rows
    than blocks at n = 700 is not needed: every block loops) and gradient
    mode on 4; the LML within rel 1e-10, the gradient within 1e-8 of max
    |g|; n = 700 factors far beyond shared memory.  One launch a call."""
    X, y = _lml_data(dev, n, nmax)
    key = count_key("lml_value_grad", family)
    fam, th = _lml_thetas(family, dev, 40)
    nv = torch.tensor(1e-4, dtype=torch.float64, device=dev) \
        if noise == "scalar" else torch.linspace(
            1e-5, 1e-3, nmax, dtype=torch.float64, device=dev)
    n0 = fused.LAUNCHES[key]
    lml = fused.lml_value_grad(fam, th, X, y, n, nv)
    lml_g, g = fused.lml_value_grad(fam, th[:4], X, y, n, nv, grad=True)
    torch.cuda.synchronize()
    assert fused.LAUNCHES[key] == n0 + 2
    ref = fused.lml_value_grad_plain(fam, th, X, y, n, nv)
    ref_g, gr = fused.lml_value_grad_plain(fam, th[:4], X, y, n, nv,
                                           grad=True)
    assert bool(torch.isfinite(ref).all())
    assert float(torch.max(torch.abs(lml - ref) / torch.abs(ref))) <= 1e-10
    assert float(torch.max(torch.abs(lml_g - ref_g)
                           / torch.abs(ref_g))) <= 1e-10
    assert _rel_max(g, gr) <= 1e-8


# K10 on both sides of its route edges at d = 8: a spec program's route 1
# from n = 160 on, a fast family's route 0 up to n = 237
K10_EDGE_NS = (159, 160, 237, 238)


@pytest.mark.parametrize("R", (1, 7, 2049))
@pytest.mark.parametrize("n", K10_EDGE_NS)
@pytest.mark.parametrize("noise", ["scalar", "vector"])
@pytest.mark.parametrize("family", ("rbf", "all_nodes"))
def test_lml_value_grad_kernel_edges(dev, family, noise, n, R):
    """K10 at d = 8 on both sides of its route edges, from one row to more
    rows than the grid's blocks, each n on the route the plan gives it,
    against the plain version (value within rel 1e-10; the gradient of the
    first rows within 1e-8 of max |g|); one launch a call."""
    d, nmax = 8, 240
    X, y = _lml_data(dev, n, nmax, d=d)
    key = count_key("lml_value_grad", family)
    fam, th = _lml_thetas(family, dev, R, d=d)
    nv = torch.tensor(1e-4, dtype=torch.float64, device=dev) \
        if noise == "scalar" else torch.linspace(
            1e-5, 1e-3, nmax, dtype=torch.float64, device=dev)
    ref = fused.lml_value_grad_plain(fam, th, X, y, n, nv)
    ref_g, gr = fused.lml_value_grad_plain(fam, th[:4], X, y, n, nv,
                                           grad=True)
    assert bool(torch.isfinite(ref).all())
    sd = fused._spec_doubles(fused._kern(fam, d, dev))
    edge = 160 if family == "all_nodes" else 238
    assert fused.lml_value_grad_plan(n, d, sd)[0] == int(n >= edge)
    n0 = fused.LAUNCHES[key]
    lml = fused.lml_value_grad(fam, th, X, y, n, nv)
    lml_g, g = fused.lml_value_grad(fam, th[:4], X, y, n, nv, grad=True)
    torch.cuda.synchronize()
    assert fused.LAUNCHES[key] == n0 + 2
    assert float(torch.max(torch.abs(lml - ref) / torch.abs(ref))) <= 1e-10
    assert float(torch.max(torch.abs(lml_g - ref_g)
                           / torch.abs(ref_g))) <= 1e-10
    assert _rel_max(g, gr) <= 1e-8


@pytest.mark.parametrize("n,route", ((30, 0), (238, 1)))
def test_lml_value_grad_non_pd_row(dev, n, route):
    """A variance that underflows to 0 over a zero noise entry makes the
    first pivot 0: the row is NaN in K10 (on either route: n = 30 keeps the
    triangle in shared memory, n = 238 in global memory) and its plain
    version, value and gradient, and the other rows stay finite."""
    X, y = _lml_data(dev, n, n + 2)
    fam, th = _lml_thetas("rbf", dev, 3)
    th[0, 0] = -800.0
    nv = torch.full((n + 2,), 1e-4, dtype=torch.float64, device=dev)
    nv[0] = 0.0
    assert fused.lml_value_grad_plan(n, 3)[0] == route
    lml = fused.lml_value_grad(fam, th, X, y, n, nv)
    _, g = fused.lml_value_grad(fam, th, X, y, n, nv, grad=True)
    ref, gr = fused.lml_value_grad_plain(fam, th, X, y, n, nv, grad=True)
    assert bool(torch.isnan(ref[0])) and bool(torch.isnan(lml[0]))
    assert bool(torch.isnan(g[0]).all())
    assert bool(torch.isfinite(lml[1:]).all())
    assert float(torch.max(torch.abs(lml[1:] - ref[1:])
                           / torch.abs(ref[1:]))) <= 1e-10
    assert _rel_max(g[1:], gr[1:]) <= 1e-8


def _fit_args(family, dev, lanes, d=3, n=60, nmax=64):
    """K11's arguments: lanes starts in a box of +-2 around the family's
    theta, lane 0 at that theta."""
    X, y = _lml_data(dev, n, nmax, d)
    fam, theta = family_and_theta(family, d)
    lo, hi = theta - 2.0, theta + 2.0
    rng = np.random.default_rng(lanes)
    th0 = rng.uniform(lo, hi, (lanes, len(theta)))
    th0[0] = theta
    t = lambda a: torch.as_tensor(a, dtype=torch.float64, device=dev)
    nv = torch.tensor(1e-4, dtype=torch.float64, device=dev)
    return fam, (fam, X, y, n, nv, t(th0), t(lo), t(hi))


def _lanes_close(f, fr, tol):
    """The same lanes NaN (a start that is not positive definite returns
    it with a NaN f, in both), the others within tol (1 + |f|)."""
    assert torch.equal(torch.isnan(f), torch.isnan(fr))
    fin = ~torch.isnan(fr)
    assert bool(torch.all(torch.abs(f - fr)[fin]
                          <= tol * (1 + torch.abs(fr[fin]))))


def _best(f):
    return float(torch.where(torch.isnan(f), torch.inf, f).min())


@pytest.mark.parametrize("lanes", (8, 2))
@pytest.mark.parametrize("family", ("rbf", "matern52") + tuple(SPECS))
def test_lbfgs_lml_fit_kernel(dev, family, lanes):
    """K11 against its plain version lane by lane and step for step over
    3 iterations: the same nev and iterations, theta within 1e-7 of the
    box width, f within 1e-9 (1 + |f|); to maxiter 120, the best f within
    1e-8 (1 + |f|).  One launch a call."""
    key = count_key("lbfgs_lml_fit", family)
    _, args = _fit_args(family, dev, lanes)
    n0 = fused.LAUNCHES[key]
    th, f, nev, it = fused.lbfgs_lml_fit(*args, maxiter=3,
                                         return_iters=True)
    torch.cuda.synchronize()
    assert fused.LAUNCHES[key] == n0 + 1
    thr, fr, nevr, itr = fused.lbfgs_lml_fit_plain(*args, maxiter=3,
                                                   return_iters=True)
    assert nev.tolist() == nevr.tolist() and it.tolist() == itr.tolist()
    assert float(torch.max(torch.abs(th - thr))) <= 1e-7 * 4.0
    _lanes_close(f, fr, 1e-9)
    _, f, _ = fused.lbfgs_lml_fit(*args, maxiter=120)
    _, fr, _ = fused.lbfgs_lml_fit_plain(*args, maxiter=120)
    assert abs(_best(f) - _best(fr)) <= 1e-8 * (1 + abs(_best(fr)))


def test_lbfgs_lml_fit_kernel_d40(dev):
    """K11 at d = 40 (p = 41, beyond a warp's lanes) on the fast family:
    step for step over 3 iterations as above."""
    _, args = _fit_args("rbf", dev, 8, d=40, n=120, nmax=128)
    th, f, nev = fused.lbfgs_lml_fit(*args, maxiter=3)
    thr, fr, nevr = fused.lbfgs_lml_fit_plain(*args, maxiter=3)
    assert nev.tolist() == nevr.tolist()
    assert float(torch.max(torch.abs(th - thr))) <= 1e-7 * 4.0
    _lanes_close(f, fr, 1e-9)


def test_lbfgs_lml_fit_nan_lanes(dev):
    """A lane whose start is not finite (a NaN theta) stops at once with
    nev 1 and returns its start and a NaN f, as the plain version's lane,
    while the other lanes run; when every lane fails (a NaN noise level:
    no theta gives a finite LML), the fit raises LinAlgError after one
    K11 launch."""
    from gpry_tpu_torch.models.gp import GaussianProcessRegressor
    _, args = _fit_args("rbf", dev, 4)
    fam, X, y, n, nv, th0, lo, hi = args
    th0 = th0.clone()
    th0[0, 1] = torch.nan
    th, f, nev = fused.lbfgs_lml_fit(fam, X, y, n, nv, th0, lo, hi)
    thr, fr, nevr = fused.lbfgs_lml_fit_plain(fam, X, y, n, nv, th0, lo, hi)
    assert bool(torch.isnan(fr[0])) and bool(torch.isnan(f[0]))
    assert int(nev[0]) == int(nevr[0]) == 1
    assert torch.equal(torch.isnan(th[0]), torch.isnan(thr[0]))
    assert bool(torch.isfinite(f[1:]).all())
    assert abs(_best(f) - _best(fr)) <= 1e-8 * (1 + abs(_best(fr)))
    Xd = np.random.default_rng(3).uniform(0, 1, (20, 2))
    gpr = GaussianProcessRegressor(bounds=[[0.0, 1.0]] * 2, random_state=0,
                                   verbose=0)
    gpr.append_to_data(Xd, np.sin(Xd).sum(1), fit_gpr=False)
    gpr.noise_level_default = float("nan")
    n0 = fused.LAUNCHES["lbfgs_lml_fit"]
    with pytest.raises(np.linalg.LinAlgError):
        gpr.fit_gpr_hyperparameters(n_restarts=2)
    assert fused.LAUNCHES["lbfgs_lml_fit"] == n0 + 1


def test_fit_kernels_raise_when_the_build_fails(dev, monkeypatch):
    """No fallback: with the library unbuilt and nvcc refusing, K10 and
    K11 raise KernelBuildError for CUDA tensors and launch nothing."""
    def refuse():
        raise fused.KernelBuildError("nvcc refused the sources")

    monkeypatch.setattr(fused, "_lib", None)
    monkeypatch.setattr(fused, "_stale", lambda: True)
    monkeypatch.setattr(fused, "_nvcc", refuse)
    fam, args = _fit_args("rbf", dev, 2)
    _, X, y, n, nv, th0, _, _ = args
    n0 = dict(fused.LAUNCHES)
    with pytest.raises(fused.KernelBuildError):
        fused.lml_value_grad(fam, th0, X, y, n, nv)
    with pytest.raises(fused.KernelBuildError):
        fused.lbfgs_lml_fit(*args)
    assert fused.LAUNCHES == n0


# K9 and K11 across their panel edges (32 rows; K11's 16-column panels),
# the shared-memory edge of their route 0 (n 224, 231) and their route 1
# (n 320), at 1, 2 and 8 lanes, step for step over 3 iterations with
# chip_smoke.py's tolerances (TOL_K9_X, TOL_K9_F, TOL_K11_X, TOL_K11_F)
EDGE_NS = (1, 31, 32, 33, 224, 231, 320)
EDGE_FAMILIES = FAST + ("all_nodes",)


@pytest.mark.parametrize("lanes", (1, 2, 8))
@pytest.mark.parametrize("n", EDGE_NS)
@pytest.mark.parametrize("family", EDGE_FAMILIES)
def test_lbfgs_lml_fit_kernel_edges(dev, family, n, lanes):
    """K11 against its plain version at n valid rows of n + 8: the same nev
    and iterations per lane over 3 iterations, theta within 1e-7 of the box
    width, f within 1e-9 (1 + |f|); one launch."""
    key = count_key("lbfgs_lml_fit", family)
    _, args = _fit_args(family, dev, lanes, n=n, nmax=n + 8)
    n0 = fused.LAUNCHES[key]
    th, f, nev, it = fused.lbfgs_lml_fit(*args, maxiter=3,
                                         return_iters=True)
    torch.cuda.synchronize()
    assert fused.LAUNCHES[key] == n0 + 1
    thr, fr, nevr, itr = fused.lbfgs_lml_fit_plain(*args, maxiter=3,
                                                   return_iters=True)
    assert nev.tolist() == nevr.tolist() and it.tolist() == itr.tolist()
    assert float(torch.max(torch.abs(th - thr))) <= 1e-7 * 4.0
    _lanes_close(f, fr, 1e-9)


@pytest.mark.parametrize("lanes", (1, 2, 8))
@pytest.mark.parametrize("n", EDGE_NS)
@pytest.mark.parametrize("family", EDGE_FAMILIES)
def test_lbfgs_logexp_ascent_kernel_edges(dev, family, n, lanes):
    """K9 against its plain version at n valid rows of n + 8, the starts
    uniform in the box: the same nev per lane over 3 iterations, x within
    1e-7 of the box width, f within 1e-9 (1 + |f|); one launch.  (A start
    on a training point is test_lbfgs_logexp_ascent_kernel's and
    chip_smoke.py's check_k9's: next to one, the variance prior - |L^-1
    k|^2 cancels, and at n = 231 with Matern-1/2 the reference's f moves
    by ~3e-8 with the summation order: an unblocked substitution and the
    blocked one both differ from it by that much.)"""
    p = _grad_surrogate(family, dev, 3, n, n + 8)
    key = count_key("lbfgs_logexp_ascent", family)
    family = family_and_theta(family, 3)[0]
    lo = torch.full((3,), -1.0, dtype=torch.float64, device=dev)
    hi = -lo
    gen = torch.Generator(device=dev).manual_seed(n)
    x0s = torch.rand((lanes, 3), generator=gen, dtype=torch.float64,
                     device=dev) * 2.0 - 1.0
    n0 = fused.LAUNCHES[key]
    xs, f, nev = fused.lbfgs_logexp_ascent(family, p, 3 ** -0.85, 0.01, x0s,
                                           lo, hi, maxiter=3)
    torch.cuda.synchronize()
    assert fused.LAUNCHES[key] == n0 + 1
    xr, fr, nevr = fused.lbfgs_logexp_ascent_plain(
        family, p, 3 ** -0.85, 0.01, x0s, lo, hi, maxiter=3)
    assert nev.tolist() == nevr.tolist()
    assert float(torch.max(torch.abs(xs - xr))) <= 1e-7 * 2.0
    assert bool(torch.all(torch.abs(f - fr) <= 1e-9 * (1 + torch.abs(fr))))


@pytest.mark.parametrize("family", ("rbf", "all_nodes"))
def test_lbfgs_kernels_failed_search_and_non_pd_start(dev, family):
    """Lanes whose first line search runs out (a gradient so large that the
    18th halving still overshoots: y times 1e6 for K11, y_scale 1e12 for K9)
    stop with nev 1 + 19, at their start, as in the plain version; with
    the fast family, a K11 lane that starts where K is not positive
    definite (a variance that underflows to 0 over a zero noise entry)
    stops at once with a NaN f and its start, while the others run, as
    there (ALL_NODES's other terms keep K positive definite)."""
    fam, args = _fit_args(family, dev, 4, n=60, nmax=64)
    _, X, y, n, nv, th0, lo, hi = args
    big = (fam, X, y * 1e6, n, nv, th0, lo, hi)
    th, f, nev, it = fused.lbfgs_lml_fit(*big, maxiter=3, return_iters=True)
    thr, fr, nevr, itr = fused.lbfgs_lml_fit_plain(*big, maxiter=3,
                                                   return_iters=True)
    assert nev.tolist() == nevr.tolist() == [20] * 4
    assert it.tolist() == itr.tolist() == [1] * 4
    assert float(torch.max(torch.abs(th - thr))) <= 1e-7 * 4.0
    _lanes_close(f, fr, 1e-9)
    if family in FAST:
        nvv = torch.full((64,), 1e-4, dtype=torch.float64, device=dev)
        nvv[0] = 0.0
        lo2, th2 = lo.clone(), th0.clone()
        lo2[0] = th2[0, 0] = -800.0
        npd = (fam, X, y, n, nvv, th2, lo2, hi)
        th, f, nev, it = fused.lbfgs_lml_fit(*npd, maxiter=3,
                                             return_iters=True)
        thr, fr, nevr, itr = fused.lbfgs_lml_fit_plain(*npd, maxiter=3,
                                                       return_iters=True)
        assert bool(torch.isnan(f[0])) and bool(torch.isnan(fr[0]))
        assert int(nev[0]) == int(nevr[0]) == 1
        assert nev.tolist() == nevr.tolist() and it.tolist() == itr.tolist()
        assert float(torch.max(torch.abs(th - thr))) <= 1e-7 * 802.0
        _lanes_close(f, fr, 1e-9)
    p = _grad_surrogate(family, dev, 3, 40, 64)
    p = p.replace(y_scale=p.y_scale * 1e12)
    kfam = family_and_theta(family, 3)[0]
    lo = torch.full((3,), -1.0, dtype=torch.float64, device=dev)
    x0s = torch.rand((4, 3), generator=torch.Generator(
        device=dev).manual_seed(3), dtype=torch.float64, device=dev) * 2 - 1
    xs, f, nev = fused.lbfgs_logexp_ascent(kfam, p, 3 ** -0.85, 0.01, x0s,
                                           lo, -lo, maxiter=3)
    xr, fr, nevr = fused.lbfgs_logexp_ascent_plain(
        kfam, p, 3 ** -0.85, 0.01, x0s, lo, -lo, maxiter=3)
    assert nev.tolist() == nevr.tolist() == [20] * 4
    assert float(torch.max(torch.abs(xs - xr))) <= 1e-7 * 2.0
    assert bool(torch.all(torch.abs(f - fr) <= 1e-9 * (1 + torch.abs(fr))))


def _plan_edges(plan, top=1 << 16):
    """The largest n of each route of a host planner (n -> (route, ...)),
    by bisection over n up to ``top`` (a last route that takes every n
    ends there)."""
    def fits(n, route):
        try:
            return plan(n)[0] <= route
        except ValueError:
            return False
    edges, route = [], 0
    while fits(1, route) and (not edges or (edges[-1] < top and fits(
            edges[-1] + 1, route))):
        lo, hi = 1, top
        while lo < hi:
            mid = (lo + hi + 1) // 2
            lo, hi = (mid, hi) if fits(mid, route) else (lo, mid - 1)
        edges.append(lo)
        route += 1
    return edges


@pytest.mark.parametrize("family", ("rbf", "c_rbf_white", "all_nodes"))
@pytest.mark.parametrize("d", (2, 8, 32, 40, 64))
def test_lbfgs_plans_match_the_kernels(dev, family, d):
    """The host planners (fused.lbfgs_logexp_ascent_plan,
    fused.lbfgs_lml_fit_plan, fused.lml_value_grad_plan) give the kernels' own routes, shared memory and
    workspace for every n up to 400 and around the last n of each route,
    the cluster planners (fused.lbfgs_lml_fit_cluster,
    fused.lml_value_grad_cluster) the kernels' own clusters and rows in
    flight around the route edges, at 1,024 and at the last n both take,
    for 1 to 2,049 lanes or rows, each one the card schedules,
    and the fit's wrappers raise ValueError just past their last route,
    before any launch; K9's last route (3) takes every n, the fit's last n
    + 1 too."""
    lib = fused.library()
    fam = family_and_theta(family, d)[0]
    kern = fused._kern(fam, d, dev)
    sd = fused._spec_doubles(kern)
    sx, sm, wk = ctypes.c_int(), ctypes.c_size_t(), ctypes.c_size_t()
    k9 = _plan_edges(lambda n: fused.lbfgs_logexp_ascent_plan(n, d, sd))
    k11 = _plan_edges(lambda n: fused.lbfgs_lml_fit_plan(n, d, kern.ntheta,
                                                         sd))
    k10 = _plan_edges(lambda n: fused.lml_value_grad_plan(n, d, sd))
    assert len(k9) == 4 and k9[-1] == 1 << 16
    assert len(k11) == 2 and len(k10) == 2
    ns = set(range(1, 400))
    for e in k9 + k11 + k10:
        ns |= set(range(e - 24, e + 25))
    for n in sorted(ns):
        route = lib.gpry_lbfgs_logexp_ascent_plan(kern, n, d,
                                                  ctypes.byref(sx),
                                                  ctypes.byref(sm))
        try:
            py = fused.lbfgs_logexp_ascent_plan(n, d, sd)
        except ValueError:
            py = (-1, 0, 0)
        assert py == (route, sx.value, sm.value)
        route = lib.gpry_lbfgs_lml_fit_plan(kern, n, d, ctypes.byref(sx),
                                            ctypes.byref(sm),
                                            ctypes.byref(wk))
        try:
            py = fused.lbfgs_lml_fit_plan(n, d, kern.ntheta, sd)
        except ValueError:
            py = (-1, 0, 0, 0)
        assert py == (route, sx.value, sm.value, wk.value)
        route = lib.gpry_lml_value_grad_plan(
            kern, n, d, 0, ctypes.byref(sx), ctypes.byref(sm),
            ctypes.byref(wk), None)
        try:
            py = fused.lml_value_grad_plan(n, d, sd)
        except ValueError:
            py = (-1, 0, 0, 0)
        assert py == (route, sx.value, sm.value, wk.value)
    # the clusters of route 1 (and 1 on route 0) for lanes and rows from
    # one to the screen's, each one the card schedules
    sms = _sms(dev)
    C, F, per_sm = ctypes.c_int(), ctypes.c_int(), ctypes.c_int()
    act = (ctypes.c_int * 5)()
    top = min(k11[-1], k10[-1])
    for n in sorted({k11[0], k11[0] + 1, k10[0], k10[0] + 1, 1024, top}):
        for R in (1, 2, 8, 16, 26, 2049):
            got = lib.gpry_lbfgs_lml_fit_cluster(
                kern, R, n, d, ctypes.byref(C), act)
            active = {1 << i: act[i] for i in range(5)}
            assert got == fused.lbfgs_lml_fit_plan(n, d, kern.ntheta, sd)[0]
            assert C.value == fused.lbfgs_lml_fit_cluster(
                R, n, d, kern.ntheta, sms, active, sd)
            assert active[C.value] >= 1
            lib.gpry_lml_value_grad_plan(
                kern, n, d, 0, ctypes.byref(sx), ctypes.byref(sm),
                ctypes.byref(wk), ctypes.byref(per_sm))
            got = lib.gpry_lml_value_grad_cluster(
                kern, R, n, d, 0, per_sm.value, ctypes.byref(F),
                ctypes.byref(C), act)
            active = {1 << i: act[i] for i in range(5)}
            assert got == fused.lml_value_grad_plan(n, d, sd)[0]
            assert (F.value, C.value) == fused.lml_value_grad_cluster(
                R, n, d, sms, per_sm.value, active, sd)
            assert active[C.value] >= 1
    n0 = dict(fused.LAUNCHES)
    n = k10[-1] + 1
    X = torch.zeros((n, d), dtype=torch.float64, device=dev)
    y = torch.zeros(n, dtype=torch.float64, device=dev)
    th0 = torch.as_tensor(family_and_theta(family, d)[1], device=dev)[None]
    with pytest.raises(ValueError, match="exceeds"):
        fused.lml_value_grad(fam, th0, X, y, n, torch.tensor(
            1e-4, dtype=torch.float64, device=dev))
    assert fused.LAUNCHES == n0
    del X, y
    n = k11[-1] + 1
    X = torch.zeros((n, d), dtype=torch.float64, device=dev)
    y = torch.zeros(n, dtype=torch.float64, device=dev)
    th0 = torch.as_tensor(family_and_theta(family, d)[1], device=dev)[None]
    n0 = dict(fused.LAUNCHES)
    with pytest.raises(ValueError, match="exceeds"):
        fused.lbfgs_lml_fit(fam, X, y, n, torch.tensor(
            1e-4, dtype=torch.float64, device=dev), th0, th0[0] - 1.0,
            th0[0] + 1.0)
    del X, y
    assert fused.lbfgs_logexp_ascent_plan(k11[-1] + 1, d, sd)[0] == 3
    assert fused.LAUNCHES == n0


# Large n on the routes whose shared memory grows with n only by O(n)
# vectors, at d = 8: K11's route 1 (its operands staged in fixed chunks),
# K9's 4-stage ring (route 1) and its 2-stage ring (route 2)
@pytest.mark.parametrize("family", ("rbf", "all_nodes"))
def test_lbfgs_lml_fit_kernel_large_n(dev, family):
    """K11 at n = 1,700 of 1,704 (route 1), 2 lanes, against its plain
    version step for step over 3 iterations: the same nev and iterations,
    theta within 1e-7 of the box width, f within 1e-9 (1 + |f|)."""
    d, n = 8, 1700
    key = count_key("lbfgs_lml_fit", family)
    fam, args = _fit_args(family, dev, 2, d=d, n=n, nmax=n + 4)
    kern = fused._kern(fam, d, dev)
    assert fused.lbfgs_lml_fit_plan(n, d, kern.ntheta,
                                    fused._spec_doubles(kern))[0] == 1
    n0 = fused.LAUNCHES[key]
    th, f, nev, it = fused.lbfgs_lml_fit(*args, maxiter=3,
                                         return_iters=True)
    torch.cuda.synchronize()
    assert fused.LAUNCHES[key] == n0 + 1
    thr, fr, nevr, itr = fused.lbfgs_lml_fit_plain(*args, maxiter=3,
                                                   return_iters=True)
    assert nev.tolist() == nevr.tolist() and it.tolist() == itr.tolist()
    assert float(torch.max(torch.abs(th - thr))) <= 1e-7 * 4.0
    _lanes_close(f, fr, 1e-9)


# K10 and K11 on route 1, a row or a lane on a thread-block cluster: at
# K11's first route-1 n at d = 8 (237; K10's fast families keep route 0
# there), 1,024 and 2,048, on 1, 2, 8 and 16 rows or lanes
ROUTE1_NS = (237, 1024, 2048)
ROUTE1_R = (1, 2, 8, 16)


def _sms(dev):
    return torch.cuda.get_device_properties(dev).multi_processor_count


def _cluster_of(key):
    """The blocks a row or a lane ran on in the one launch that
    fused.CLUSTERS counted under ``key``."""
    got = [k for k in fused.CLUSTERS if k.startswith(key + " C=")]
    assert len(got) == 1 and fused.CLUSTERS[got[0]] == 1
    return int(got[0].split("C=")[1])


def _k10_per_sm(kern, n, d, grad=0):
    """The blocks of K10's instance an SM holds (the library's plan)."""
    sx, sm, wk, per_sm = ctypes.c_int(), ctypes.c_size_t(), \
        ctypes.c_size_t(), ctypes.c_int()
    fused.library().gpry_lml_value_grad_plan(
        kern, n, d, grad, ctypes.byref(sx), ctypes.byref(sm),
        ctypes.byref(wk), ctypes.byref(per_sm))
    return per_sm.value


def _active(kern, n, d, k10=False):
    """{C: clusters of C blocks of K11's (or K10's value) instance at n the
    card runs at once}, as the library's cluster plan queries them."""
    C, F, act = ctypes.c_int(), ctypes.c_int(), (ctypes.c_int * 5)()
    lib = fused.library()
    if k10:
        lib.gpry_lml_value_grad_cluster(kern, 1, n, d, 0,
                                        _k10_per_sm(kern, n, d),
                                        ctypes.byref(F), ctypes.byref(C), act)
    else:
        lib.gpry_lbfgs_lml_fit_cluster(kern, 1, n, d, ctypes.byref(C), act)
    return {1 << i: act[i] for i in range(5)}


@pytest.mark.parametrize("R", ROUTE1_R)
@pytest.mark.parametrize("n", ROUTE1_NS)
@pytest.mark.parametrize("family", ("rbf", "all_nodes"))
def test_lml_value_grad_cluster_route(dev, family, n, R):
    """K10 at d = 8 on the route and the cluster its plan gives (a spec
    program on route 1 at every n here, the fast family from n = 238; C
    from lml_value_grad_cluster over the card's SMs and the clusters it
    runs at once: 16 blocks a row at R <= 8), against its plain version:
    the LML within rel 1e-10, the gradient within 1e-8 of max |g|; one
    launch a call."""
    d = 8
    X, y = _lml_data(dev, n, n + 8, d=d)
    key = count_key("lml_value_grad", family)
    fam, th = _lml_thetas(family, dev, R, d=d)
    nv = torch.tensor(1e-4, dtype=torch.float64, device=dev)
    kern = fused._kern(fam, d, dev)
    sd = fused._spec_doubles(kern)
    route = fused.lml_value_grad_plan(n, d, sd)[0]
    assert route == int(n > 237 or family != "rbf")
    fused.reset_launch_counts()
    lml = fused.lml_value_grad(fam, th, X, y, n, nv)
    C = _cluster_of(key)
    want = fused.lml_value_grad_cluster(R, n, d, _sms(dev),
                                        _k10_per_sm(kern, n, d),
                                        _active(kern, n, d, k10=True), sd)[1]
    assert C == want and (route == 0 or R > 8 or C == 16)
    lml_g, g = fused.lml_value_grad(fam, th, X, y, n, nv, grad=True)
    torch.cuda.synchronize()
    assert fused.LAUNCHES[key] == 2
    ref, gr = fused.lml_value_grad_plain(fam, th, X, y, n, nv, grad=True)
    assert bool(torch.isfinite(ref).all())
    assert float(torch.max(torch.abs(lml - ref) / torch.abs(ref))) <= 1e-10
    assert float(torch.max(torch.abs(lml_g - ref)
                           / torch.abs(ref))) <= 1e-10
    assert _rel_max(g, gr) <= 1e-8


@pytest.mark.parametrize("lanes", ROUTE1_R)
@pytest.mark.parametrize("n", ROUTE1_NS)
@pytest.mark.parametrize("family", ("rbf", "all_nodes"))
def test_lbfgs_lml_fit_cluster_route(dev, family, n, lanes):
    """K11 at d = 8 on route 1, each lane on the cluster its plan gives
    (lbfgs_lml_fit_cluster over the card's SMs and the clusters it runs at
    once: 16 blocks a lane up to 8 lanes), against its plain version
    lane by lane and step for step over 3 iterations: the same nev and
    iterations, theta within 1e-7 of the box width, and f the plain LML at
    the lane's own theta within 1e-9 (1 + |f|) or, where larger, within
    the LML's own rounding spread there (_lml_spread)."""
    d = 8
    key = count_key("lbfgs_lml_fit", family)
    fam, args = _fit_args(family, dev, lanes, d=d, n=n, nmax=n + 8)
    kern = fused._kern(fam, d, dev)
    sd = fused._spec_doubles(kern)
    assert fused.lbfgs_lml_fit_plan(n, d, kern.ntheta, sd)[0] == 1
    fused.reset_launch_counts()
    th, f, nev, it = fused.lbfgs_lml_fit(*args, maxiter=3,
                                         return_iters=True)
    torch.cuda.synchronize()
    C = _cluster_of(key)
    active = _active(kern, n, d)
    assert C == fused.lbfgs_lml_fit_cluster(lanes, n, d, kern.ntheta,
                                            _sms(dev), active, sd)
    assert active[C] >= 1 and (lanes > 8 or C == 16)
    thr, fr, nevr, itr = fused.lbfgs_lml_fit_plain(*args, maxiter=3,
                                                   return_iters=True)
    assert nev.tolist() == nevr.tolist() and it.tolist() == itr.tolist()
    assert float(torch.max(torch.abs(th - thr))) <= 1e-7 * 4.0
    # f is -LML at the lane's own theta: against the plain LML there,
    # within 1e-9 (1 + |f|) or, where that is larger, within the LML's own
    # rounding spread at that theta (the C blocks sum the log det and z^T
    # z in another order than the plain version, and some starts of the
    # +-2 box leave K near singular)
    assert torch.equal(torch.isnan(f), torch.isnan(fr))
    fin = ~torch.isnan(fr)
    at = -fused.lml_value_grad_plain(fam, th, *args[1:5])
    tol = torch.maximum(1e-9 * (1 + torch.abs(at)),
                        _lml_spread(fam, th, *args[1:5]))
    assert bool(torch.all((torch.abs(f - at) <= tol)[fin]))


@pytest.mark.parametrize("family", ("rbf", "c_rbf_white"))
def test_lbfgs_lml_fit_cluster_singular_probes(dev, family):
    """K11 on 16-block clusters (2 lanes, n = 300, d = 8) whose line
    searches keep probing thetas where K is not positive definite: a noise
    of -0.05 at one training row, and data (y ~ 1e-3) that pull the
    variance down, so that most probes' factors fail at that row (about
    125 of the plain version's 150 evaluations; the same counts under
    another order of the rows).  The blocks of a cluster leave a failed
    factor and start the next probe together: five launches give the same
    bits, and they match the plain version step for step over 5
    iterations (nev, iterations, theta within 1e-7 of the box width, f
    within 1e-9 (1 + |f|))."""
    d, n, lanes = 8, 300, 2
    key = count_key("lbfgs_lml_fit", family)
    fam, theta = family_and_theta(family, d)
    X, y = _lml_data(dev, n, n + 4, d)
    y = 1e-3 * y
    nv = torch.full((n + 4,), 1e-4, dtype=torch.float64, device=dev)
    nv[n // 2] = -0.05
    lo, hi = theta - 2.0, theta + 2.0
    th0 = np.stack([theta, theta + np.resize([0.7, -0.4, 0.2], len(theta))])
    t = lambda a: torch.as_tensor(a, dtype=torch.float64, device=dev)
    args = (fam, X, y, n, nv, t(th0), t(lo), t(hi))
    low = theta.copy()
    low[0] = lo[0]
    assert bool(torch.isnan(fused.lml_value_grad_plain(fam, t(low[None]),
                                                       X, y, n, nv)).all())
    outs = []
    for _ in range(5):
        fused.reset_launch_counts()
        outs.append(fused.lbfgs_lml_fit(*args, maxiter=5, return_iters=True))
        torch.cuda.synchronize()
        assert _cluster_of(key) == 16
    for o in outs[1:]:
        assert all(torch.equal(a, b) for a, b in zip(o, outs[0]))
    th, f, nev, it = outs[0]
    thr, fr, nevr, itr = fused.lbfgs_lml_fit_plain(*args, maxiter=5,
                                                   return_iters=True)
    assert nev.tolist() == nevr.tolist() and it.tolist() == itr.tolist()
    assert min(it.tolist()) == 5 and min(nev.tolist()) >= 60
    assert float(torch.max(torch.abs(th - thr))) <= 1e-7 * 4.0
    _lanes_close(f, fr, 1e-9)


def _lml_spread(fam, thetas, X, y, n, nv, orders=4):
    """The LML's own rounding spread at each row of ``thetas``: max - min
    of the plain version's -LML over ``orders`` orders of the n training
    rows (the first as given)."""
    gen = torch.Generator().manual_seed(0)
    vals = []
    for i in range(orders):
        perm = torch.randperm(n, generator=gen) if i else torch.arange(n)
        perm = perm.to(X.device)
        Xp, yp = X.clone(), y.clone()
        Xp[:n], yp[:n] = X[:n][perm], y[:n][perm]
        vals.append(-fused.lml_value_grad_plain(fam, thetas, Xp, yp, n, nv))
    v = torch.stack(vals)
    return v.max(0).values - v.min(0).values


def test_cluster_plan_mismatch_raises(dev, monkeypatch):
    """No quiet fallback: where the host's cluster plan and the library's
    differ, K10 and K11 raise RuntimeError before any launch, and a CUDA
    tensor never takes the plain version or one block a lane instead."""
    d, n = 8, 300
    fam, args = _fit_args("rbf", dev, 2, d=d, n=n, nmax=n + 8)
    X, y = _lml_data(dev, n, n + 8, d=d)
    _, th = _lml_thetas("rbf", dev, 2, d=d)
    nv = torch.tensor(1e-4, dtype=torch.float64, device=dev)
    monkeypatch.setattr(fused, "lml_cluster", lambda rows, sms, active: 3)
    n0 = dict(fused.LAUNCHES)
    with pytest.raises(RuntimeError, match="plans"):
        fused.lbfgs_lml_fit(*args, maxiter=1)
    with pytest.raises(RuntimeError, match="plans"):
        fused.lml_value_grad("rbf", th, X, y, n, nv)
    assert fused.LAUNCHES == n0


@pytest.mark.parametrize("route", (1, 2))
@pytest.mark.parametrize("family", ("rbf", "all_nodes"))
def test_lbfgs_logexp_ascent_kernel_large_n(dev, family, route):
    """K9 at n = 3,100 (route 1) and at the first n of route 2, 2 lanes
    from uniform starts, against its plain version over 3 iterations: the
    same nev, x within 1e-7 of the box width, f within 1e-9 (1 + |f|)."""
    d = 8
    key = count_key("lbfgs_logexp_ascent", family)
    fam = family_and_theta(family, d)[0]
    sd = fused._spec_doubles(fused._kern(fam, d, dev))
    n = 3100
    if route == 2:
        n = _plan_edges(lambda m: fused.lbfgs_logexp_ascent_plan(m, d,
                                                                 sd))[1] + 1
    assert fused.lbfgs_logexp_ascent_plan(n, d, sd)[0] == route
    p = _grad_surrogate(family, dev, d, n, n + 8)
    lo = torch.full((d,), -1.0, dtype=torch.float64, device=dev)
    gen = torch.Generator(device=dev).manual_seed(n)
    x0s = torch.rand((2, d), generator=gen, dtype=torch.float64,
                     device=dev) * 2.0 - 1.0
    n0 = fused.LAUNCHES[key]
    xs, f, nev = fused.lbfgs_logexp_ascent(fam, p, d ** -0.85, 0.01, x0s,
                                           lo, -lo, maxiter=3)
    torch.cuda.synchronize()
    assert fused.LAUNCHES[key] == n0 + 1
    xr, fr, nevr = fused.lbfgs_logexp_ascent_plain(
        fam, p, d ** -0.85, 0.01, x0s, lo, -lo, maxiter=3)
    assert nev.tolist() == nevr.tolist()
    assert float(torch.max(torch.abs(xs - xr))) <= 1e-7 * 2.0
    assert bool(torch.all(torch.abs(f - fr) <= 1e-9 * (1 + torch.abs(fr))))


def test_runner_refuses_a_budget_past_the_lbfgs_kernels(dev):
    """On the card the fit (K11) takes a bounded n (the ascent's K9 and K8
    every n, since their global routes): a Runner whose max_total is past
    K11's last route raises ValueError when it is built, before any truth
    evaluation."""
    from gpry_tpu_torch.run import Runner
    d = 2
    n = _plan_edges(lambda m: fused.lbfgs_lml_fit_plan(m, d, d + 1))[-1] + 1
    calls = []

    def loglike(X):
        calls.append(X)
        return -0.5 * float(np.sum(np.asarray(X) ** 2))

    with pytest.raises(ValueError, match="exceeds"):
        Runner(loglike, [[-1.0, 1.0]] * d, verbose=0,
               options={"max_total": n})
    assert not calls
    Runner(loglike, [[-1.0, 1.0]] * d, verbose=0,
           options={"max_total": n - 1})
    assert not calls


def _mcmc_inputs(family, p, B, nsteps, seed=0, half=1.0):
    """K12's arguments: B starts with a finite log-density (from a sample
    of the box [-half, half]^d inside the prior box [-1, 1]^d), the
    proposal factor of the JAX package's first phase (2.38^2 / d times a
    tenth of the box, squared), a step size and the draws of nsteps
    steps."""
    dev, d = p.X.device, p.X.shape[1]
    gen = torch.Generator(device=dev).manual_seed(seed)
    f64 = dict(dtype=torch.float64, device=dev)
    pool = (torch.rand((4000, d), generator=gen, **f64) * 2.0 - 1.0) * half
    lp = fused.gated_mean_plain(family, p, pool)
    fin = torch.isfinite(lp)
    assert int(fin.sum()) >= B
    chol = torch.eye(d, **f64) * (0.2 * 2.38 / np.sqrt(d))
    z = torch.randn((nsteps, B, d), generator=gen, **f64)
    u = torch.rand((nsteps, B), generator=gen, **f64)
    lo = -torch.ones(d, **f64)
    return (pool[fin][:B].contiguous(), lp[fin][:B].contiguous(),
            torch.tensor(-0.3, **f64), chol, z, u, lo, -lo)


def _same_chains(out, ref, tol=1e-12):
    """K12's results against the plain version's: the visited states within
    tol of the box width (2), so the same accept decisions at every step;
    their log-densities within rel tol; the step size identical; the moment
    sums within rel tol."""
    x, lp, step, s1, s2, Xs, lps = out
    xr, lpr, stepr, s1r, s2r, Xsr, lpsr = ref
    assert float(torch.max(torch.abs(Xs - Xsr))) <= tol * 2.0
    assert float(torch.max(torch.abs(x - xr))) <= tol * 2.0
    _close(lps.reshape(-1), lpsr.reshape(-1), tol)
    _close(lp, lpr, tol)
    assert float(step) == float(stepr)
    for a, b in ((s1, s1r), (s2, s2r)):
        scale = max(float(torch.max(torch.abs(b))), 1.0)
        assert float(torch.max(torch.abs(a - b))) <= tol * scale


@pytest.mark.parametrize("adapt", (True, False), ids=("warmup", "sampling"))
@pytest.mark.parametrize("svm", ["fitted", "all_finite"])
@pytest.mark.parametrize("family", FAMILIES)
def test_mcmc_chains_kernel(dev, family, svm, adapt):
    """K12 against its plain version on the same state and draws, 50 steps
    of 8 chains at d = 3, with the SVM fitted and all finite, in both
    instances (warm-up: Robbins-Monro and the moment sums): the same accept
    decisions, x within 1e-12 of the box width, the step size identical;
    one launch for the phase."""
    p = surrogate(family, dev, svm=svm)
    key = count_key("mcmc_chains", family)
    family = family_and_theta(family)[0]
    x0, lp0, step, chol, z, u, lo, hi = _mcmc_inputs(family, p, 8, 50)
    n0 = fused.LAUNCHES[key]
    out = fused.mcmc_chains(family, p, x0, lp0, step, chol, z, u, lo, hi,
                            adapt)
    torch.cuda.synchronize()
    assert fused.LAUNCHES[key] == n0 + 1
    ref = fused.mcmc_chains_plain(fused._in_box_logp(family, p, lo, hi), x0,
                                  lp0, step, chol, z, u, adapt)
    _same_chains(out, ref)
    # the chains moved, and (warm-up) the step size adapted
    assert bool((out[5][-1] != x0).any())
    assert (float(out[2]) != -0.3) == adapt


@pytest.mark.parametrize("B", (40, 64))
def test_mcmc_chains_kernel_warps_loop(dev, B):
    """More chains than the block's 32 warps: a warp runs two chains (the
    ensemble of d = 32 has 64); the warm-up's step size and sums still
    couple all of them."""
    p = surrogate("rbf", dev, svm="all_finite")
    args = _mcmc_inputs("rbf", p, B, 30)
    out = fused.mcmc_chains("rbf", p, *args, True)
    ref = fused.mcmc_chains_plain(
        fused._in_box_logp("rbf", p, args[6], args[7]), *args[:6], True)
    _same_chains(out, ref)


@pytest.mark.parametrize("family", ("rbf", "c_rbf_white"))
def test_mcmc_chains_kernel_d80(dev, family):
    """K12 has no cap on d below what its shared memory holds: at d = 80
    (beyond K6's 64) it agrees with its plain version step for step;
    where the factor and scratch exceed a block's shared memory it raises
    ValueError before launching."""
    p = surrogate(family, dev, d=80, svm="all_finite")
    family = family_and_theta(family, 80)[0]
    # the starts inside the trust box [-0.9, 0.9]^d
    args = _mcmc_inputs(family, p, 16, 20, half=0.85)
    for adapt in (True, False):
        out = fused.mcmc_chains(family, p, *args, adapt)
        ref = fused.mcmc_chains_plain(
            fused._in_box_logp(family, p, args[6], args[7]), *args[:6],
            adapt)
        _same_chains(out, ref, 1e-10)
    big = surrogate("rbf", dev, d=160, svm="all_finite")
    with pytest.raises(ValueError, match="shared memory"):
        fused.mcmc_chains("rbf", big, *_mcmc_inputs("rbf", big, 32, 2,
                                                     half=0.85), True)


@pytest.mark.parametrize("n,nmax,nsv,work", [
    (1100, 1152, 1152, 16 * 1152), (1800, 1856, 8, 16 * 1808)])
@pytest.mark.parametrize("family", ("rbf",) + tuple(SPECS))
def test_mcmc_chains_beyond_smem(dev, family, n, nmax, nsv, work):
    """K12 at d = 16 with the support vectors, then also X / l, read from a
    staged copy in global memory (K6's placement): each phase launches
    once and agrees with its plain version."""
    p = surrogate(family, dev, n=n, nmax=nmax, d=16, nsv=nsv)
    key = count_key("mcmc_chains", family)
    family = family_and_theta(family, 16)[0]
    assert fused.library().gpry_mcmc_chains_work(
        fused._kern(family, 16, dev), 32, n, nsv, 16, MODE_FITTED) == work
    x0, lp0, step, chol, z, u, lo, hi = _mcmc_inputs(family, p, 32, 20)
    for adapt in (True, False):
        n0 = fused.LAUNCHES[key]
        out = fused.mcmc_chains(family, p, x0, lp0, step, chol, z, u, lo, hi,
                                adapt)
        torch.cuda.synchronize()
        assert fused.LAUNCHES[key] == n0 + 1
        ref = fused.mcmc_chains_plain(fused._in_box_logp(family, p, lo, hi),
                                      x0, lp0, step, chol, z, u, adapt)
        _same_chains(out, ref, 1e-10)


@pytest.mark.parametrize("adapt", (True, False), ids=("warmup", "sampling"))
@pytest.mark.parametrize("B, d", ((1, 3), (16, 3), (17, 3), (64, 32)))
@pytest.mark.parametrize("family", ("rbf", "all_nodes"))
def test_mcmc_chains_spread(dev, family, B, d, adapt):
    """The chains spread over blocks: 1, 16 and 17 chains at d = 3 (the
    warm-up's cluster of 1, 16 and 16 blocks, 17 leaving one block two
    chains) and 64 at d = 32 (16 blocks of 4): step for step against the
    plain version, one launch for the phase."""
    p = surrogate(family, dev, d=d, svm="all_finite" if d > 3 else "fitted")
    key = count_key("mcmc_chains", family)
    fam = family_and_theta(family, d)[0]
    args = _mcmc_inputs(fam, p, B, 40, half=0.85 if d > 3 else 1.0)
    g = fused.mcmc_chains_plan(B, p.n, 8 if d == 3 else 0, d,
                               fused._spec_doubles(fused._kern(fam, d, dev)),
                               adapt=adapt)
    assert g["blocks"] == (min(16, 1 << (B - 1).bit_length()) if adapt
                           else B)
    n0 = fused.LAUNCHES[key]
    out = fused.mcmc_chains(fam, p, *args, adapt)
    torch.cuda.synchronize()
    assert fused.LAUNCHES[key] == n0 + 1
    ref = fused.mcmc_chains_plain(
        fused._in_box_logp(fam, p, args[6], args[7]), *args[:6], adapt)
    _same_chains(out, ref)


@pytest.mark.parametrize("B", (16, 17, 40))
@pytest.mark.parametrize("family", ("rbf", "c_rbf_white"))
def test_mcmc_chains_cluster_edge(dev, family, B):
    """The warm-up's cluster of 16 blocks (the non-portable size) where a
    block holds a whole SM: n = 5,000 rows at d = 3 staged in shared
    memory, more than half of an SM's, so a block an SM; the cluster
    launches and agrees with the plain version step for step."""
    p = surrogate(family, dev, n=5000, nmax=5008, svm="fitted")
    fam = family_and_theta(family)[0]
    spec = fused._spec_doubles(fused._kern(fam, 3, dev))
    g = fused.mcmc_chains_plan(B, 5000, 8, 3, spec, adapt=True)
    assert (g["blocks"], g["stage"]) == (16, 0)
    assert g["smem"] > 227 * 1024 // 2
    args = _mcmc_inputs(fam, p, B, 40)
    ref = fused.mcmc_chains_plain(
        fused._in_box_logp(fam, p, args[6], args[7]), *args[:6], True)
    _same_chains(fused.mcmc_chains(fam, p, *args, True), ref, 1e-10)


@pytest.mark.parametrize("n, nmax, warps", (
    (24, 32, 1), (56, 64, 2), (120, 128, 4), (2100, 2112, 8)))
@pytest.mark.parametrize("adapt", (True, False), ids=("warmup", "sampling"))
@pytest.mark.parametrize("family", ("rbf", "all_nodes"))
def test_mcmc_chains_warps_per_chain(dev, family, adapt, n, nmax, warps):
    """A chain's evaluation split over 1, 2, 4 and 8 warps, as the plan
    picks them from n + nsv (8 support vectors) for 16 chains at d = 16
    (at n = 2,100, X / l read from global memory), agrees with the plain
    version step for step."""
    p = surrogate(family, dev, n=n, nmax=nmax, d=16, svm="fitted")
    fam = family_and_theta(family, 16)[0]
    spec = fused._spec_doubles(fused._kern(fam, 16, dev))
    assert fused.mcmc_chains_plan(16, n, 8, 16, spec,
                                  adapt=adapt)["warps"] == warps
    args = _mcmc_inputs(fam, p, 16, 20)
    ref = fused.mcmc_chains_plain(
        fused._in_box_logp(fam, p, args[6], args[7]), *args[:6], adapt)
    _same_chains(fused.mcmc_chains(fam, p, *args, adapt), ref, 1e-10)


@pytest.mark.parametrize("adapt, B, d, ring, states_global, factor_global", (
    (True, 1000, 64, 8, False, False), (True, 2000, 100, 1, True, False),
    (True, 1, 163, 1, True, True), (False, 2000, 100, 4, False, False),
    (False, 1, 163, 1, True, False)),
    ids=("warmup-ring", "warmup-states", "warmup-factor", "sampling-ring",
         "sampling-states"))
def test_mcmc_chains_plan_fallbacks(dev, adapt, B, d, ring, states_global,
                                    factor_global):
    """Where the ring of draws, the chains' states and the proposal factor
    do not all fit beside the staged surrogate (many chains a block, or d
    at the edge of the range), the plan of the phase run shortens the
    ring, then keeps the states in the output buffers, then (the warm-up
    at d = 163) reads the factor from global memory; each agrees with the
    plain version."""
    p = surrogate("rbf", dev, d=d, svm="all_finite")
    g = fused.mcmc_chains_plan(B, p.n, 0, d, adapt=adapt)
    assert (g["ring"], g["state_smem"], g["chol_smem"]) == \
        (ring, int(not states_global), int(not factor_global))
    args = _mcmc_inputs("rbf", p, B, 6, half=0.85)
    out = fused.mcmc_chains("rbf", p, *args, adapt)
    ref = fused.mcmc_chains_plain(
        fused._in_box_logp("rbf", p, args[6], args[7]), *args[:6], adapt)
    _same_chains(out, ref, 1e-10)


@pytest.mark.parametrize("family", ("rbf", "all_nodes"))
def test_mcmc_chains_plan_matches_the_kernel(dev, family):
    """fused.mcmc_chains_plan gives k12_plan's geometry and shared memory,
    and fused.mcmc_chains_min_smem the range gate's bytes, over chains,
    rows, support vectors, d and both phases."""
    lib = fused.library()
    for d in (1, 3, 8, 32, 80, 119):
        fam = family_and_theta(family, d)[0]
        kern = fused._kern(fam, d, dev)
        spec = fused._spec_doubles(kern)
        for B in (1, 16, 17, 64, 200, 1000):
            assert lib.gpry_mcmc_chains_min_smem(kern, B, d) == \
                fused.mcmc_chains_min_smem(B, d, spec)
            if fused.mcmc_chains_min_smem(B, d, spec) > 227 * 1024:
                continue
            for n, nsv in ((224, 8), (1100, 1152), (4000, 0)):
                for adapt in (0, 1):
                    g = fused.mcmc_chains_plan(B, n, nsv, d, spec, adapt)
                    out = (ctypes.c_int * 8)()
                    sm = ctypes.c_size_t()
                    assert lib.gpry_mcmc_chains_plan(
                        kern, B, n, nsv, d, MODE_FITTED, adapt, out,
                        ctypes.byref(sm)) == 0
                    assert list(out) == [g[k] for k in (
                        "blocks", "chains", "groups", "warps", "ring",
                        "state_smem", "chol_smem", "stage")]
                    assert sm.value == g["smem"]


def ns_state(dev, nlive, d, kind, seed=0):
    """A nested-sampling state (fused.NSState) after a prior phase of
    10 nlive draws, with the kill batch nlive // 6 and its starts, in one
    of these kinds: "ties" (the top third of the live log-likelihoods at
    one clipped value, a few -inf at the bottom), "neg_inf" (more -inf
    than the kill batch), "full" (room for one more kill, then none),
    "converged" (the live points' share of the evidence below 1%),
    "plateau" (every live value equal, past nlive kills) and "mid"
    ("ties" halfway through a dead buffer of the final NS's size).  The
    state is made with numpy from ``seed``.  Returns (state, starts, the
    previous chains' (xs, ls, cs), (k0_dead, H0, log precision))."""
    from gpry_tpu_torch.mc.nested import _volume_consts
    rng = np.random.default_rng(seed)
    B, n_prior, max_dead = nlive // 6, 10 * nlive, 60 * nlive
    k0 = n_prior - nlive
    lxp, lsh, H0 = _volume_consts(nlive, n_prior, max_dead)
    tot = k0 + max_dead
    live_X = rng.normal(size=(nlive, d))
    live_l = -0.5 * np.sum(live_X ** 2, axis=1)
    k = k0 + B * {"converged": 120, "plateau": 12,
                  "mid": max_dead // (2 * B)}.get(kind, 3)
    if kind == "full":
        k = tot - B + seed % 2
    if kind in ("ties", "mid"):
        top = np.argsort(live_l)[-nlive // 3:]
        live_l[top] = np.quantile(live_l, 2 / 3)
        live_l[rng.choice(nlive, 3, replace=False)] = -np.inf
    if kind == "neg_inf":
        live_l[rng.choice(nlive, B + 5, replace=False)] = -np.inf
    if kind == "plateau":
        live_l[:] = -1.25
    # the dead points below the live ones (up to the live top when the run
    # has converged); far below where only the room or the plateau may
    # stop the run
    fin = live_l[np.isfinite(live_l)]
    top = -1000.0 if kind in ("full", "plateau", "mid") else \
        np.max(fin) if kind == "converged" else np.min(fin) - 1
    dead_l = np.full(tot, -np.inf)
    dead_l[:k] = np.sort(top - rng.exponential(3.0, k))
    dead_X = np.zeros((tot, d))
    dead_X[:k] = rng.normal(size=(k, d))
    t = lambda a: torch.as_tensor(a, dtype=torch.float64, device=dev)
    i64 = dict(dtype=torch.int64, device=dev)
    st = fused.NSState(
        live_X=t(live_X), live_logl=t(live_l), dead_X=t(dead_X),
        dead_logl=t(dead_l), logx_prev=t(lxp), log_shell=t(lsh),
        count=torch.tensor([k, 12345, 7, 0], **i64),
        done=torch.zeros(1, dtype=torch.int32, device=dev),
        kill=torch.arange(B, **i64), x0=t(np.zeros((B, d))),
        lx0=t(np.zeros(B)), lstar=t(0.0), chol=t(np.zeros((d, d))),
        # the live order unknown (an older checkout's state has none)
        **({"order": torch.full((nlive,), -1, dtype=torch.int32,
                                device=dev)}
           if "order" in fused.NSState._fields else {}))
    starts = torch.as_tensor(rng.integers(0, nlive - B, B), **i64)
    chains = (t(rng.normal(size=(B, d))), t(-rng.exponential(1.0, B)),
              torch.as_tensor(rng.integers(10, 300, B), **i64))
    return st, starts, chains, (k0, H0, float(np.log(0.01)))


def _clone_state(st):
    return fused.NSState(*(t.clone() for t in st))


@pytest.mark.parametrize("kind", ("ties", "neg_inf", "full", "converged",
                                  "plateau", "mid"))
@pytest.mark.parametrize("nlive,d", ((200, 8), (400, 8), (3200, 64)))
def test_ns_step_kernel(dev, nlive, d, kind):
    """K13 against its plain version on crafted states: the same stop flag,
    kill order, dead buffer, lstar and starts, the Cholesky factor within
    1e-12 of its largest entry; then, the chains' results applied, the same
    live set, k, calls and steps.  One launch each."""
    for seed in (0, 1):
        st, starts, chains, consts = ns_state(dev, nlive, d, kind, seed)
        ref = _clone_state(st)
        n0 = fused.LAUNCHES["ns_step"]
        fused.ns_step(st, *chains, starts, *consts)
        torch.cuda.synchronize()
        assert fused.LAUNCHES["ns_step"] == n0 + 1
        fused.ns_step_plain(ref, *chains, starts, *consts)
        for name in ("done", "count", "kill", "dead_X", "dead_logl", "x0",
                     "lx0", "lstar", "live_X", "live_logl", "order"):
            assert torch.equal(getattr(st, name), getattr(ref, name)), name
        assert torch.equal(torch.isnan(st.chol), torch.isnan(ref.chol))
        fin = ~torch.isnan(ref.chol)
        if bool(fin.any()):
            err = torch.max(torch.abs(st.chol[fin] - ref.chol[fin]))
            assert float(err) <= 1e-12 * float(torch.max(torch.abs(
                ref.chol[fin])))
        expect_done = kind in ("converged", "plateau") or \
            (kind == "full" and seed == 1)
        assert bool(st.done) == expect_done
        fused.ns_step(st, *chains, starts, *consts, select=False)
        fused.ns_step_plain(ref, *chains, starts, *consts, select=False)
        for name in ("done", "count", "live_X", "live_logl"):
            assert torch.equal(getattr(st, name), getattr(ref, name)), name
        assert int(st.count[3]) == 0


def k6_like_points(rng, ref, B, d, kind, step):
    """B points as K6 returns them, made from the plain state ``ref``:
    above lstar, with exact ties (with survivors, among themselves and at
    lstar); with kind "neg_inf" a few -inf, "nan" one NaN made at step 13
    (applied by the next: the stop test then stops the run), "plateau"
    every point at the live maximum from step 5 on (the kills then leave
    only that value)."""
    live = ref.live_logl.cpu().numpy()
    lstar = float(ref.lstar)
    ls = lstar + rng.exponential(1.0, B)
    fin = live[np.isfinite(live) & (live >= lstar)]
    if fin.size:
        ls[: B // 4] = rng.choice(fin, B // 4)
    ls[B // 4: B // 4 + 3] = ls[B // 2]
    ls[-1] = lstar
    if kind == "neg_inf":
        ls[rng.choice(B, 3, replace=False)] = -np.inf
    if kind == "nan" and step == 13:
        ls[B // 3] = np.nan
    if kind == "plateau" and step >= 5:
        ls[:] = np.max(live[np.isfinite(live)])
    t = lambda a: torch.as_tensor(a, dtype=torch.float64,
                                  device=ref.live_X.device)
    return (t(rng.normal(size=(B, d))), t(ls),
            torch.as_tensor(rng.integers(1, 50, B), dtype=torch.int64,
                            device=ref.live_X.device))


def same_values(a, b):
    """torch.equal, with NaN equal to NaN."""
    if a.is_floating_point():
        nan = torch.isnan(a)
        return torch.equal(nan, torch.isnan(b)) and torch.equal(a[~nan],
                                                                b[~nan])
    return torch.equal(a, b)


def same_ns_states(st, ref, label):
    for name in ("done", "count", "kill", "dead_X", "dead_logl", "x0",
                 "lx0", "lstar", "live_X", "live_logl", "order"):
        assert same_values(getattr(st, name), getattr(ref, name)), \
            f"{label}: {name}"
    assert torch.equal(torch.isnan(st.chol), torch.isnan(ref.chol)), label
    fin = ~torch.isnan(ref.chol)
    if bool(fin.any()):
        err = torch.max(torch.abs(st.chol[fin] - ref.chol[fin]))
        assert float(err) <= 1e-12 * float(torch.max(torch.abs(
            ref.chol[fin]))), label


def ns_step_sequence(dev, nlive, d, kind, steps=24):
    """K13 and its plain version through ``steps`` steps of a run on the
    same inputs (ns_state's "ties" state, then K6-like new points of
    ``kind``), every output compared after every step (same_ns_states).
    The live order is kept by K13 (merged after the first step's full
    sort), marked unknown at steps 4 (a kill pending) and 8 (none), and at
    step 12 the kill is not the head of the order (the slots of its first
    two swapped), each of which K13 must detect and sort in full; a
    segment end (select=False) every 8 steps.  Returns the two states."""
    st, _, _, consts = ns_state(dev, nlive, d, "ties", 0)
    ref = _clone_state(st)
    B = nlive // 6
    rng = np.random.default_rng(nlive + d)
    chains = (torch.zeros((B, d), dtype=torch.float64, device=dev),
              torch.zeros(B, dtype=torch.float64, device=dev),
              torch.zeros(B, dtype=torch.int64, device=dev))
    for step in range(steps):
        if step in (4, 8):
            st.order[0] = ref.order[0] = -1
        if step == 12:
            for s_ in (st, ref):
                s_.kill[[0, 1]] = s_.kill[[1, 0]]
        starts = torch.as_tensor(rng.integers(0, nlive - B, B),
                                 dtype=torch.int64, device=dev)
        select = step % 8 != 7
        fused.ns_step(st, *chains, starts, *consts, select=select)
        fused.ns_step_plain(ref, *chains, starts, *consts, select=select)
        torch.cuda.synchronize()
        same_ns_states(st, ref, f"nlive={nlive} d={d} {kind} step {step}")
        if step == 1:
            assert int(st.order[0]) >= 0
        chains = k6_like_points(rng, ref, B, d, kind, step)
    return st, ref


@pytest.mark.parametrize("kind", ("ties", "neg_inf", "nan", "plateau"))
@pytest.mark.parametrize("nlive,d", ((200, 8), (400, 8), (3200, 64)))
def test_ns_step_kernel_sequences(dev, nlive, d, kind):
    """24 steps of a run with K6-like new points (ties, -inf, NaN, a
    plateau): K13 torch.equal to its plain version in every output but the
    Cholesky factor (within 1e-12 of its largest entry, NaN masks
    identical) after every step, the live order kept, lost and refused
    (ns_step_sequence); the NaN and the plateau stop the run."""
    st, _ = ns_step_sequence(dev, nlive, d, kind)
    if kind in ("nan", "plateau"):
        assert bool(st.done)


def test_ns_step_refuses_large_nlive(dev):
    st, starts, chains, consts = ns_state(dev, 4104, 2, "ties")
    with pytest.raises(ValueError, match="NS_STEP_MAX_NLIVE"):
        fused.ns_step(st, *chains, starts, *consts)


@pytest.mark.parametrize("family", ("rbf", "all_nodes"))
def test_ns_slice_chains_done_flag(dev, family):
    """With the run's stop flag set, K6 returns the starts and no call (a
    spec program's cluster of two blocks too); with it clear it runs as
    without it."""
    p = surrogate(family, dev)
    fam = family_and_theta(family)[0]
    args = _chain_inputs(fam, p, 33, R=4)
    flag = torch.ones(1, dtype=torch.int32, device=dev)
    x, lx, calls = fused.ns_slice_chains(fam, p, *args, flag)
    assert torch.equal(x, args[0]) and torch.equal(lx, args[1])
    assert int(calls.abs().sum()) == 0
    flag.zero_()
    x, lx, calls = fused.ns_slice_chains(fam, p, *args, flag)
    xr, lxr, callsr = fused.ns_slice_chains(fam, p, *args)
    assert torch.equal(x, xr) and torch.equal(calls, callsr)


def test_nested_run_on_k13(dev):
    """A nested-sampling run on the gated surrogate: K13 once per queued
    step plus once per segment, K6 once per queued step, one host read per
    segment and one at the end."""
    from gpry_tpu_torch.mc.nested import run_nested_device
    from gpry_tpu_torch.mc.samples import surrogate_logp_fn
    p = surrogate("rbf", dev, svm="all_finite")
    lo = -torch.ones(3, dtype=torch.float64, device=dev)
    n0 = dict(fused.LAUNCHES)
    res = run_nested_device(surrogate_logp_fn("rbf"), p,
                            torch.Generator(device=dev).manual_seed(1), lo,
                            -lo, nlive=60, num_repeats=6, max_dead=2000)
    segs = res.n_reads - 1
    assert fused.LAUNCHES["ns_step"] - n0["ns_step"] == 9 * segs
    assert fused.LAUNCHES["ns_slice_chains"] - n0["ns_slice_chains"] \
        == 8 * segs
    assert 8 * (segs - 1) < res.n_steps <= 8 * segs
    assert res.n_reads <= -(-res.n_steps // 8) + 2
    assert np.isfinite(res.logZ) and res.n_dead == 10 * res.n_steps


def _card_gpr(d=3, n=30, seed=2):
    """A GPR on the card, factorized at its initial hyperparameters (a
    well-conditioned kernel) with the SVM fitted on a few -inf points."""
    from gpry_tpu_torch import config
    from gpry_tpu_torch.models.gp import GaussianProcessRegressor
    from gpry_tpu_torch.models.preprocessing import Normalize_bounds, \
        Normalize_y
    config.set_device("cuda")
    rng = np.random.default_rng(seed)
    bounds = np.array([[-2.0, 2.0]] * d)
    X = rng.uniform(-2, 2, (n, d))
    y = -0.5 * np.sum((X / 0.7) ** 2, axis=1)
    y[np.sum(X ** 2, axis=1) > 9.0] = -np.inf
    gpr = GaussianProcessRegressor(
        bounds=bounds, preprocessing_X=Normalize_bounds(bounds),
        preprocessing_y=Normalize_y(), n_restarts_optimizer=2,
        random_state=1)
    gpr.append_to_data(X, y, fit_gpr=False)
    gpr._fitted = True
    return gpr, bounds, rng


def test_checkpoint_of_the_card_loads_on_the_cpu(dev, tmp_path):
    """A checkpoint written on the card holds no torch object: it loads
    with the CPU as the package device, its factor bit for bit the card's,
    and predicts the card's values within rel 1e-12."""
    from gpry_tpu_torch import config
    from gpry_tpu_torch import io as gio
    gpr, bounds, rng = _card_gpr()
    Xq = rng.uniform(-2, 2, (64, 3))
    mu_card, sd_card = gpr.predict(Xq, return_std=True)
    ck = str(tmp_path / "card")
    gio.save_checkpoint(ck, {"loglike": None}, gpr, None, None, {}, None)
    try:
        config.set_device("cpu")
        cpu = gio.ensure_gpr(ck)
        assert cpu._dL.device.type == "cpu" and cpu._device.type == "cpu"
        assert torch.equal(cpu._dL, gpr._dL.cpu())
        assert torch.equal(cpu._dalpha, gpr._dalpha.cpu())
        mu_cpu, sd_cpu = cpu.predict(Xq, return_std=True)
    finally:
        config.set_device("cuda")
    fin = np.isfinite(mu_card)
    assert fin.any() and np.array_equal(np.isfinite(mu_cpu), fin)
    np.testing.assert_allclose(mu_cpu[fin], mu_card[fin], rtol=1e-12)
    np.testing.assert_allclose(sd_cpu, sd_card, rtol=1e-12, atol=1e-14)


def test_polish_k2_calls_equal_the_plain_version(dev):
    """``acq_optimizer="sampling"``: every objective call of the polish is
    one K2 launch at nq 1, equal to K2's plain version on the same inputs;
    the launches at nq 1 are the polish's calls."""
    from gpry_tpu_torch.acquisition import batch_optimizer as bo
    gpr, bounds, rng = _card_gpr()
    acq = bo.BatchOptimizer(bounds, acq_optimizer="sampling",
                            n_restarts_optimizer=4, verbose=0)
    inner = fused.gated_meanvar_logexp
    seen = []

    def recorded(family, p, Xq, logexp=None):
        n0 = fused.LAUNCHES["gated_meanvar_logexp"]
        out = inner(family, p, Xq, logexp=logexp)
        if Xq.shape[0] == 1:
            assert fused.LAUNCHES["gated_meanvar_logexp"] == n0 + 1
            ref = fused.gated_meanvar_logexp_plain(family, p, Xq,
                                                   logexp=logexp)
            seen.append((out, ref))
        return out

    bo.gated_meanvar_logexp = recorded
    evals0 = acq.obj_fun_eval_num
    try:
        X_out, _, vals = acq.multi_add(gpr, n_points=2, rng=rng)
    finally:
        bo.gated_meanvar_logexp = inner
    n_screen = 2 * min(10 * 3 * 4, 4000)
    assert len(seen) == acq.obj_fun_eval_num - evals0 - n_screen > 0
    for out, ref in seen:
        a, b = out.cpu().numpy(), ref.cpu().numpy()
        assert np.array_equal(np.isfinite(a), np.isfinite(b))
        fin = np.isfinite(b)
        np.testing.assert_allclose(a[fin], b[fin], rtol=1e-10, atol=1e-12)
    assert np.all(np.isfinite(vals))
    assert np.all((X_out >= bounds[:, 0]) & (X_out <= bounds[:, 1]))


# ---------------------------------------------------------------------------
# K14 and the device mesh (parallel/mesh.py)
# ---------------------------------------------------------------------------


def k14_case(family, dev, nq, d=8, n=900, nmax=1024, P=4, seed=5):
    """K14's inputs at the TP predict's shapes: n valid rows of nmax (d
    = 8) split over P shards of nloc = nmax / P rows, nq queries, a
    symmetric positive definite M (nmax, nmax); the shards' plain K_shard
    gathered into k_full.  Returns (family, theta, X, alpha, Xq_, M,
    k_full, nloc, n)."""
    rng = np.random.default_rng(seed)
    t = lambda a: torch.as_tensor(np.asarray(a, float), dtype=torch.float64,
                                  device=dev)
    family, theta = family_and_theta(family, d)
    X = np.zeros((nmax, d))
    X[:n] = rng.uniform(0, 1, (n, d))
    alpha = np.zeros(nmax)
    alpha[:n] = rng.normal(size=n)
    A = rng.normal(size=(nmax, nmax)) / np.sqrt(nmax)
    M = A @ A.T + np.eye(nmax)
    Xq = rng.uniform(0, 1, (nq, d))
    nloc = nmax // P
    X, alpha, theta, Xq = t(X), t(alpha), t(theta), t(Xq)
    k_full = torch.cat([fused.tp_cross_mean_plain(
        family, theta, X[i * nloc:(i + 1) * nloc],
        alpha[i * nloc:(i + 1) * nloc], Xq, i * nloc, n)[0]
        for i in range(P)])
    return family, theta, X, alpha, Xq, t(M), k_full, nloc, n


def _within(a, b, scale, tol=1e-12):
    err = float(torch.max(torch.abs(a - b)))
    assert err <= tol * max(float(torch.max(scale)), 1e-300), err


@pytest.mark.parametrize("nq", [1, 64, 255])
@pytest.mark.parametrize("family", FAMILIES)
def test_tp_cross_mean_kernel(dev, family, nq):
    """K14 (a) against its plain version on every shard (nloc 256 of nmax
    1,024, the last shard's rows past n padding): K_shard within 1e-12 of
    its largest entry, the partial mean within 1e-12 of the largest sum
    of |k alpha|; one launch a call, counted under the family's key."""
    family, theta, X, alpha, Xq, _, _, nloc, n = k14_case(family, dev, nq)
    key = count_key("tp_cross_mean", family if isinstance(family, str)
                    else "all_nodes")
    for i in range(X.shape[0] // nloc):
        args = (family, theta, X[i * nloc:(i + 1) * nloc],
                alpha[i * nloc:(i + 1) * nloc], Xq, i * nloc, n)
        n0 = fused.LAUNCHES[key]
        K, mean = fused.tp_cross_mean(*args)
        assert fused.LAUNCHES[key] == n0 + 1
        Kr, meanr = fused.tp_cross_mean_plain(*args)
        _within(K, Kr, Kr.abs())
        _within(mean, meanr, (Kr.abs() * args[3].abs()[:, None]).sum(0))
        if i * nloc >= n:
            assert not bool(K.any())


@pytest.mark.parametrize("nq", [1, 64, 255])
def test_tp_quad_kernel(dev, nq):
    """K14 (b) against its plain version on every shard: within 1e-12 of
    the largest sum of the absolute values of its terms; two launches a
    call (the panels' product and their sum); a rerun gives the same
    bits."""
    _, _, X, _, _, M, k_full, nloc, _ = k14_case("rbf", dev, nq)
    for i in range(X.shape[0] // nloc):
        Mi, Ki = M[i * nloc:(i + 1) * nloc], k_full[i * nloc:(i + 1) * nloc]
        n0 = fused.LAUNCHES["tp_quad"]
        quad = fused.tp_quad(Mi, k_full, Ki)
        assert fused.LAUNCHES["tp_quad"] == n0 + 2
        ref = fused.tp_quad_plain(Mi, k_full, Ki)
        _within(quad, ref, (Ki.abs() * (Mi.abs() @ k_full.abs())).sum(0))
        assert torch.equal(quad, fused.tp_quad(Mi, k_full, Ki))


def test_launches_follow_torchs_device(dev):
    """The library's CUDA runtime launches on torch's current device
    (checked on every card the machine has)."""
    lib = fused.library()
    for i in range(torch.cuda.device_count()):
        with fused._launch_on(torch.device("cuda", i)):
            assert lib.gpry_current_device() == i == \
                torch.cuda.current_device()


def _mesh_cases(dev, devices):
    """The DP predict (K2, nq 1,024), the fit's 8 lanes (K11) and an NS
    run whose 20 chains a step go over a mesh of ``devices`` (K6), each
    against its unsharded launch bit for bit."""
    from gpry_tpu_torch.mc.nested import run_nested_device
    from gpry_tpu_torch.mc.samples import surrogate_logp_fn
    from gpry_tpu_torch.models import gp as gpm
    from gpry_tpu_torch.parallel import mesh as mesh_mod
    mesh = mesh_mod.make_mesh(devices)
    P = mesh.shape["data"]
    p = surrogate("rbf", dev, n=60, nmax=64, d=3)
    rng = np.random.default_rng(3)
    Xq = torch.as_tensor(rng.uniform(-1, 1, (1024, 3)), dtype=torch.float64,
                         device=dev)
    got = mesh_mod.sharded_predict("rbf", p, Xq, mesh)
    want = gpm.surrogate_predict("rbf", p, Xq)
    for a, b in zip(got, want):
        assert a.device == b.device and torch.equal(a, b)
    lo, hi = torch.full((4,), -3.0, dtype=torch.float64, device=dev), \
        torch.full((4,), 3.0, dtype=torch.float64, device=dev)
    th0 = torch.as_tensor(rng.uniform(-2, 2, (8, 4)), dtype=torch.float64,
                          device=dev)
    args = ("rbf", p.X, p.y, p.n, p.noise_var, th0, lo, hi)
    got = mesh_mod._sharded_fit_theta(*args, mesh, maxiter=60)
    want = gpm._fit_theta_restarts(*args, maxiter=60)
    for a, b in zip(got, want):
        assert torch.equal(a, b)
    box = torch.ones(3, dtype=torch.float64, device=dev)
    runs = [run_nested_device(
        surrogate_logp_fn("rbf"), p, torch.Generator(device=dev).manual_seed(
            2), -box, box, nlive=120, num_repeats=6, max_dead=3000,
        kill_batch=20, mesh=m) for m in (mesh, None)]
    assert 20 % P == 0
    assert runs[0].n_dead == runs[1].n_dead
    assert runs[0].logZ == runs[1].logZ
    assert torch.equal(runs[0].X, runs[1].X)
    return mesh


def test_mesh_dp_routes_on_a_logical_mesh(dev):
    """On [cuda:0] * 4 the DP predict, the fit's lanes and the NS's
    chains equal their unsharded launches bit for bit."""
    _mesh_cases(dev, [torch.device("cuda", 0)] * 4)


def test_mesh_dp_routes_on_the_cards(dev, monkeypatch):
    """On every card of a machine with two or more: the same, and each
    shard's K2 output lies on its own card (its launch went there)."""
    n = torch.cuda.device_count()
    if n < 2:
        pytest.skip("needs two or more CUDA cards")
    from gpry_tpu_torch.models import gp as gpm
    inner = gpm.surrogate_predict
    seen = []

    def recorded(family, p, Xq):
        out = inner(family, p, Xq)
        seen.append((Xq.device, p.X.device, out[0].device))
        return out

    monkeypatch.setattr(gpm, "surrogate_predict", recorded)
    devices = [torch.device("cuda", i) for i in range(n)]
    _mesh_cases(torch.device("cuda", 0), devices)
    assert [s[0] for s in seen[:n]] == devices
    assert all(a == b == c for a, b, c in seen)


def test_tp_predict_on_a_logical_mesh(dev):
    """The TP predict on [cuda:0] * 4 (K14 on every shard) against the
    single-device predict at tests/test_parallel.py's tolerances, at nmax
    1,024."""
    from gpry_tpu_torch.models import gp as gpm
    from gpry_tpu_torch.parallel import mesh as mesh_mod
    p = surrogate("rbf", dev, n=900, nmax=1024, d=8, svm="all_finite",
                  ls=0.3)
    p = p.replace(trust_lo=torch.full((8,), -np.inf, dtype=torch.float64,
                                      device=dev),
                  trust_hi=torch.full((8,), np.inf, dtype=torch.float64,
                                      device=dev),
                  clip_max=torch.tensor(np.inf, dtype=torch.float64,
                                        device=dev))
    mesh = mesh_mod.make_mesh([torch.device("cuda", 0)] * 4)
    Xq = torch.as_tensor(np.random.default_rng(8).uniform(-1, 1, (64, 8)),
                         dtype=torch.float64, device=dev)
    mean, std = mesh_mod.tp_predict("rbf", p, Xq, mesh)
    mean_1, std_1 = gpm.surrogate_predict("rbf", p, Xq)
    np.testing.assert_allclose(mean.cpu().numpy(), mean_1.cpu().numpy(),
                               rtol=1e-9, atol=1e-12)
    np.testing.assert_allclose(std.cpu().numpy(), std_1.cpu().numpy(),
                               rtol=1e-6, atol=1e-9)


@pytest.mark.parametrize("family", ["rbf", "c_rbf_white"])
def test_blocked_sweeps_do_not_depend_on_the_batch(dev, family):
    """K2, K5 and K8's mean and std give a query the same bits whatever
    the batch it came in, so the queries a block takes (Q = 8, 16, 32 by
    nq) do not change a solution (csrc/subst_blocked.cuh: the update's
    k-split is SUB_SPLITS whatever Q is): the whole batch against the
    same queries in shards of other Q, as the device mesh splits a
    predict.  (K8's gradient sweep gives a query 256 / Q threads, so its
    gradients still round by Q: no mesh route splits K8.)"""
    p = surrogate(family, dev, n=200, nmax=224, d=8)
    fam = family_and_theta(family, 8)[0]
    rng = np.random.default_rng(12)
    Xq = torch.as_tensor(rng.uniform(-1, 1, (4500, 8)), dtype=torch.float64,
                         device=dev)
    cuts = (0, 1000, 3000, 4500)
    qs = {fused.gated_meanvar_logexp_plan(200, 224, 8, b - a)[1]
          for a, b in zip(cuts, cuts[1:])}
    qs.add(fused.gated_meanvar_logexp_plan(200, 224, 8, 4500)[1])
    assert qs == {8, 16, 32}
    for fn in (lambda X: fused.gated_meanvar_logexp(fam, p, X),
               lambda X: (fused.gated_meanvar_logexp(
                   fam, p, X, logexp=(0.3, 0.01)),),
               lambda X: fused.meanvar_ungated(fam, p, X)):
        whole = fn(Xq)
        parts = [fn(Xq[a:b].contiguous()) for a, b in zip(cuts, cuts[1:])]
        for k, w in enumerate(whole):
            assert torch.equal(w, torch.cat([q[k] for q in parts]))
    whole = fused.meanstd_grad(fam, p, Xq[:1100])
    parts = [fused.meanstd_grad(fam, p, Xq[a:b].contiguous())
             for a, b in ((0, 500), (500, 1100))]
    for k, w in enumerate(whole[:2]):
        assert torch.equal(w, torch.cat([q[k] for q in parts]))
