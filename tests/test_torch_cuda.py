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
from gpry_tpu_torch.ops.linalg import factorize

pytestmark = pytest.mark.cuda
FAMILIES = ("rbf", "matern12", "matern32", "matern52")


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def surrogate(family, dev, n=40, nmax=64, d=3, seed=0, nsv=8, svm="fitted"):
    """A small surrogate with every gate active: the SVM fitted (or, with
    ``svm="all_finite"``, the placeholder of a run that has seen no -inf),
    a trust box inside the prior and an upper clip."""
    rng = np.random.default_rng(seed)
    t = lambda a: torch.as_tensor(np.asarray(a, float), dtype=torch.float64,
                                  device=dev)
    X, y = np.zeros((nmax, d)), np.zeros(nmax)
    X[:n] = rng.uniform(0, 1, (n, d))
    y[:n] = np.sin(4 * X[:n]).sum(1)
    theta = np.log([1.3] + [0.4] * d)
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
    Xq = torch.rand((1000, 3), dtype=torch.float64, device=dev) * 2.2 - 1.1
    n0 = fused.LAUNCHES["gated_mean"]
    _close(fused.gated_mean(family, p, Xq),
           fused.gated_mean_plain(family, p, Xq), 1e-12)
    assert fused.LAUNCHES["gated_mean"] == n0 + 1


@pytest.mark.parametrize("svm", ["fitted", "all_finite"])
@pytest.mark.parametrize("nq", [1, 16, 66, 2000, 65536])
@pytest.mark.parametrize("family", FAMILIES)
def test_gated_mean_kernel_designs(dev, family, nq, svm):
    """K1 at the batch sizes of the main paths (one query, the MCMC step,
    the NS kill batch, the NS prior phase, the IS refine), with the SVM
    fitted and all finite: the wrapper's own choice, then each design
    forced; rel <= 1e-12 against the plain version."""
    p = surrogate(family, dev, svm=svm)
    Xq = torch.rand((nq, 3), dtype=torch.float64, device=dev) * 2.2 - 1.1
    # the first queries inside the trust box, so that some pass the gates
    Xq[:8] *= 0.4
    ref = fused.gated_mean_plain(family, p, Xq)
    for design in (None, "tiled", "block"):
        n0 = fused.LAUNCHES["gated_mean"]
        out = fused.gated_mean(family, p, Xq, _design=design)
        torch.cuda.synchronize()
        assert fused.LAUNCHES["gated_mean"] == n0 + 1
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
    args = _chain_inputs(family, p, B, R=12)
    n0 = fused.LAUNCHES["ns_slice_chains"]
    x, lx, calls = fused.ns_slice_chains(family, p, *args)
    torch.cuda.synchronize()
    assert fused.LAUNCHES["ns_slice_chains"] == n0 + 1
    xr, lxr, callsr = fused.ns_slice_chains_plain(family, p, *args)
    assert calls.dtype == torch.int64 and torch.equal(calls, callsr)
    assert int(calls.min()) >= 12 * 3
    _close(lx, lxr, 1e-10)
    _close(x, xr, 1e-10)
    assert bool((lx > args[2]).all())


@pytest.mark.parametrize("n,nmax,nsv,work", [
    (1100, 1152, 8, 0), (1100, 1152, 1152, 16 * 1152),
    (1800, 1856, 8, 16 * 1808)])
def test_ns_slice_chains_d16(dev, n, nmax, nsv, work):
    """K6 at d = 16 (the JAX package's d16 campaign reaches nmax = 1,152):
    the whole surrogate in shared memory; the support vectors beyond it,
    read from a staged copy in global memory; X / l beyond it as well.
    Each launches once and agrees with its plain version."""
    p = surrogate("rbf", dev, n=n, nmax=nmax, d=16, nsv=nsv)
    p = p.replace(clip_max=torch.tensor(torch.inf, dtype=torch.float64,
                                        device=dev))
    assert fused.library().gpry_ns_slice_chains_work(n, nsv, 16,
                                                     MODE_FITTED) == work
    args = _chain_inputs("rbf", p, 33, R=4)
    n0 = fused.LAUNCHES["ns_slice_chains"]
    x, lx, calls = fused.ns_slice_chains("rbf", p, *args)
    torch.cuda.synchronize()
    assert fused.LAUNCHES["ns_slice_chains"] == n0 + 1
    xr, lxr, callsr = fused.ns_slice_chains_plain("rbf", p, *args)
    assert torch.equal(calls, callsr)
    _close(lx, lxr, 1e-10)
    _close(x, xr, 1e-10)


@pytest.mark.parametrize("family", FAMILIES)
def test_gated_meanvar_logexp_kernel(dev, family):
    p = surrogate(family, dev)
    Xq = torch.rand((700, 3), dtype=torch.float64, device=dev) * 2.2 - 1.1
    for a, b in zip(fused.gated_meanvar_logexp(family, p, Xq),
                    fused.gated_meanvar_logexp_plain(family, p, Xq)):
        _close(a, b, 1e-10)
    _close(fused.gated_meanvar_logexp(family, p, Xq, logexp=(0.5, 0.01)),
           fused.gated_meanvar_logexp_plain(family, p, Xq,
                                            logexp=(0.5, 0.01)), 1e-10)


@pytest.mark.parametrize("family", FAMILIES)
def test_masked_kernel_matrix_kernel(dev, family):
    p = surrogate(family, dev)
    th = p.theta + torch.randn((33, 4), dtype=torch.float64, device=dev)
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
    Xq = torch.rand((nq, 3), dtype=torch.float64, device=dev) * 2.2 - 1.1
    Xq[:40] = p.X[:40] * p.x_scale + p.x_loc
    n0 = fused.LAUNCHES["meanvar_ungated"]
    ma, sa = fused.meanvar_ungated(family, p, Xq)
    mb, sb = fused.meanvar_ungated_plain(family, p, Xq)
    torch.cuda.synchronize()
    assert fused.LAUNCHES["meanvar_ungated"] == n0 + 1
    _close(ma, mb, 1e-10)
    atol = 1e-7 * float(torch.exp(0.5 * p.theta[0]) * p.y_scale)
    assert float(torch.max(torch.abs(sa - sb))) <= atol


def _fill_inputs(family, dev, noise, N=500, size=4):
    """K4's inputs on the small surrogate: candidates inside the trust box
    with their gated mean, std and LogExp values; scalar or per-row
    noise."""
    from gpry_tpu_torch.acquisition.base import grow_surrogate
    from gpry_tpu_torch.acquisition.functions import LogExp
    p = surrogate(family, dev)
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
    args, acqf = _fill_inputs(family, dev, noise)
    ref = fused.kriging_believer_fill_plain(family, *args)
    for logexp in ((acqf.zeta, 0.01), None):
        n0 = fused.LAUNCHES["kriging_believer_fill"]
        out = fused.kriging_believer_fill(family, *args, logexp=logexp)
        assert fused.LAUNCHES["kriging_believer_fill"] == n0 + 2 * 4 - 1
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
