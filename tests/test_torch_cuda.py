"""
gpry_tpu_torch's CUDA kernels against their plain versions on the card.

Marked ``cuda``: they need a CUDA card and nvcc, and skip elsewhere (the
decision is taken inside the fixture, never at import).  On the card
(the repository's conftest imports jax, which the card's machine lacks):

    python -m pytest tests/test_torch_cuda.py -q --noconftest
"""

import numpy as np
import pytest
import torch

from gpry_tpu_torch.models.classifier import MODE_ALL_FINITE, MODE_FITTED, \
    SVMParams, trivial_svm_params
from gpry_tpu_torch.models.gp import SurrogateParams
from gpry_tpu_torch.ops import fused
from gpry_tpu_torch.ops.kernels import build_kernel_spec, kernel_diag
from gpry_tpu_torch.ops.linalg import factorize

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


def surrogate(family, dev, n=40, nmax=64, d=3, seed=0, nsv=8, svm="fitted"):
    """A small surrogate with every gate active: the SVM fitted (or, with
    ``svm="all_finite"``, the placeholder of a run that has seen no -inf),
    a trust box inside the prior and an upper clip.  ``family`` is a fast
    family or a spec tree (its kernel argument, see family_and_theta)."""
    rng = np.random.default_rng(seed)
    t = lambda a: torch.as_tensor(np.asarray(a, float), dtype=torch.float64,
                                  device=dev)
    X, y = np.zeros((nmax, d)), np.zeros(nmax)
    X[:n] = rng.uniform(0, 1, (n, d))
    y[:n] = np.sin(4 * X[:n]).sum(1)
    family, theta = family_and_theta(family, d)
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


@pytest.mark.parametrize("svm", ["fitted", "all_finite"])
@pytest.mark.parametrize("nq", [1, 16, 66, 2000, 65536])
@pytest.mark.parametrize("family", FAMILIES)
def test_gated_mean_kernel_designs(dev, family, nq, svm):
    """K1 at the batch sizes of the main paths (one query, the MCMC step,
    the NS kill batch, the NS prior phase, the IS refine), with the SVM
    fitted and all finite: the wrapper's own choice, then each design
    forced; rel <= 1e-12 against the plain version."""
    p = surrogate(family, dev, svm=svm)
    key, family = count_key("gated_mean", family), family_and_theta(family)[0]
    Xq = torch.rand((nq, 3), dtype=torch.float64, device=dev) * 2.2 - 1.1
    # the first queries inside the trust box, so that some pass the gates
    Xq[:8] *= 0.4
    ref = fused.gated_mean_plain(family, p, Xq)
    for design in (None, "tiled", "block"):
        n0 = fused.LAUNCHES[key]
        out = fused.gated_mean(family, p, Xq, _design=design)
        torch.cuda.synchronize()
        assert fused.LAUNCHES[key] == n0 + 1
        if bool(torch.isfinite(ref).any()):
            _close(out, ref, 1e-12)
        else:
            assert torch.equal(out, ref)


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


@pytest.mark.parametrize("svm", ["fitted", "all_finite"])
@pytest.mark.parametrize("B", [33, 66])
@pytest.mark.parametrize("family", FAMILIES)
def test_ns_slice_chains_kernel(dev, family, B, svm):
    """K6 against its plain version (the lock-step loop on plain K1) on the
    same draws, with the SVM fitted and all finite: identical calls,
    identical -inf masks, x and lx within rel 1e-10; one launch for all
    chains and repeats."""
    p = surrogate(family, dev, svm=svm)
    key = count_key("ns_slice_chains", family)
    family = family_and_theta(family)[0]
    args = _chain_inputs(family, p, B, R=12)
    n0 = fused.LAUNCHES[key]
    x, lx, calls = fused.ns_slice_chains(family, p, *args)
    torch.cuda.synchronize()
    assert fused.LAUNCHES[key] == n0 + 1
    xr, lxr, callsr = fused.ns_slice_chains_plain(family, p, *args)
    assert calls.dtype == torch.int64 and torch.equal(calls, callsr)
    assert int(calls.min()) >= 12 * 3
    _close(lx, lxr, 1e-10)
    _close(x, xr, 1e-10)
    assert bool((lx > args[2]).all())


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


@pytest.mark.parametrize("nq", [4096, 2048])
@pytest.mark.parametrize("family", FAMILIES)
def test_meanvar_ungated_kernel(dev, family, nq):
    """K5 against its plain version at the audit's screen (4,096) and
    polish (2,048) sizes, training points included: mean within rel 1e-10;
    std within an absolute 1e-7 sqrt(sigma^2) y_scale (sigma^2 - |v|^2
    cancels to ~0 at a training point); one launch per call."""
    p = surrogate(family, dev)
    key = count_key("meanvar_ungated", family)
    family = family_and_theta(family)[0]
    Xq = torch.rand((nq, 3), dtype=torch.float64, device=dev) * 2.2 - 1.1
    Xq[:40] = p.X[:40] * p.x_scale + p.x_loc
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


def _fill_inputs(family, dev, noise, N=500, size=4):
    """K4's inputs on the small surrogate: candidates inside the trust box
    with their gated mean, std and LogExp values; scalar or per-row
    noise."""
    from gpry_tpu_torch.acquisition.base import grow_surrogate
    from gpry_tpu_torch.acquisition.functions import LogExp
    p = surrogate(family, dev)
    family = family_and_theta(family)[0]
    if noise == "vector":
        p = p.replace(noise_var=torch.linspace(1e-4, 1e-3, 64,
                                               dtype=torch.float64,
                                               device=dev))
    p = grow_surrogate(p, 64)
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


def test_kernels_refuse_grad_and_float32(dev):
    p = surrogate("rbf", dev)
    Xq = torch.zeros((4, 3), dtype=torch.float64, device=dev)
    with pytest.raises(RuntimeError, match="requires grad"):
        fused.gated_mean("rbf", p, Xq.clone().requires_grad_(True))
    with pytest.raises(TypeError, match="float64"):
        fused.gated_mean("rbf", p, Xq.float())


@pytest.mark.parametrize("nq", [1, 64, 1024])
@pytest.mark.parametrize("family", FAMILIES)
def test_predict_meancov_kernel(dev, family, nq):
    """K7 against its plain version, training points among the queries:
    the mean within rel 1e-10; the covariance within an absolute
    1e-10 max|K(Xq, Xq)| (K - V^T V cancels near the training points);
    two launches per call."""
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
