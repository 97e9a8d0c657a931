"""
gpry_tpu_torch's CUDA kernels against their plain versions on the card.

Marked ``cuda``: they need a CUDA card and nvcc, and skip elsewhere (the
decision is taken inside the fixture, never at import).  On the card:

    python -m pytest tests/test_torch_cuda.py -q
"""

import numpy as np
import pytest
import torch

from gpry_tpu_torch.models.classifier import MODE_FITTED, SVMParams
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


def surrogate(family, dev, n=40, nmax=64, d=3, seed=0):
    rng = np.random.default_rng(seed)
    t = lambda a: torch.as_tensor(np.asarray(a, float), dtype=torch.float64,
                                  device=dev)
    X, y = np.zeros((nmax, d)), np.zeros(nmax)
    X[:n] = rng.uniform(0, 1, (n, d))
    y[:n] = np.sin(4 * X[:n]).sum(1)
    theta = np.log([1.3] + [0.4] * d)
    L, alpha = factorize(family, t(theta), t(X), t(y), n, t(1e-4))
    sv = rng.uniform(0, 1, (8, d))
    return SurrogateParams(
        theta=t(theta), X=t(X), y=t(y), n=n, noise_var=t(1e-4), L=L,
        alpha=alpha, x_loc=t(np.full(d, -1.0)), x_scale=t(np.full(d, 2.0)),
        y_loc=t(-1.0), y_scale=t(2.0), y_max=t(0.5), clip_max=t(1.0),
        svm=SVMParams(mode=MODE_FITTED, sv=t(sv), dual=t(rng.normal(size=8)),
                      intercept=t(0.1), gamma=t(3.0)),
        trust_lo=t(np.full(d, -0.9)), trust_hi=t(np.full(d, 0.9)))


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


def test_kernels_refuse_grad_and_float32(dev):
    p = surrogate("rbf", dev)
    Xq = torch.zeros((4, 3), dtype=torch.float64, device=dev)
    with pytest.raises(RuntimeError, match="requires grad"):
        fused.gated_mean("rbf", p, Xq.clone().requires_grad_(True))
    with pytest.raises(TypeError, match="float64"):
        fused.gated_mean("rbf", p, Xq.float())
