"""
The GP hyperparameter fit's kernels on the CPU: K10's plain version
(``fused.lml_value_grad_plain``: the LML and its analytic theta-gradient)
and K11's (``fused.lbfgs_lml_fit_plain``: the multistart L-BFGS of -LML)
against gpry_tpu's ``jax.value_and_grad(masked_lml)`` and
``_fit_theta_restarts``, in float64 on seeded numpy inputs.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import gpry_tpu.ops.linalg as jl
from gpry_tpu.models.gp import GaussianProcessRegressor as JGPR
from gpry_tpu.models.gp import _fit_theta_restarts as j_fit
from gpry_tpu.models.preprocessing import Normalize_bounds as JNB
from gpry_tpu.models.preprocessing import Normalize_y as JNY

from gpry_tpu_torch import config
from gpry_tpu_torch.models import gp as tgp
from gpry_tpu_torch.models.gp import GaussianProcessRegressor as TGPR
from gpry_tpu_torch.models.preprocessing import Normalize_bounds as TNB
from gpry_tpu_torch.models.preprocessing import Normalize_y as TNY
from gpry_tpu_torch.ops import fused
from gpry_tpu_torch.ops import kernels as tk
from gpry_tpu_torch.ops import linalg as tl

config.set_device("cpu")
# tiny shapes: one intra-op thread, so that parallel test workers do
# not oversubscribe the cores
torch.set_num_threads(1)
D = 3
FAST = ("rbf", "matern12", "matern32", "matern52")
SPECS = {
    # every node kind
    "all_nodes": {"Sum": [
        {"Product": [{"ConstantKernel": {"constant_value": 1.3}},
                     {"Exponentiation": {"kernel": {"Matern": {
                         "nu": 2.5, "length_scale": [0.5, 0.6, 0.7]}},
                         "exponent": 2.0}}]},
        {"Sum": [{"Product": [{"ConstantKernel": {"constant_value": 0.5}},
                              {"RationalQuadratic": {"alpha": 1.5,
                                                     "length_scale": 0.5}}]},
                 {"Sum": [{"ExpSineSquared": {"length_scale": 1.0,
                                              "periodicity": 3.0}},
                          {"Sum": [{"DotProduct": {"sigma_0": 0.3}},
                                   {"WhiteKernel": {"noise_level": 1e-3}}]}
                          ]}]}]},
    # C() * RBF + WhiteKernel
    "c_rbf_white": {"Sum": [
        {"Product": [{"ConstantKernel": {"constant_value": 1.5}},
                     {"RBF": {"length_scale": [0.3, 0.4, 0.5]}}]},
        {"WhiteKernel": {"noise_level": 1e-3}}]},
}
FAMILIES = FAST + tuple(SPECS)


def T(a):
    return torch.as_tensor(np.asarray(a, dtype=float), dtype=torch.float64)


def J(a):
    return jnp.asarray(np.asarray(a, dtype=float))


def problem(name, seed, n=30, nmax=48, noise="scalar", rows=4):
    """Padded data, the kernel argument and ``rows`` moderate thetas around
    the family's theta (a spec's theta0)."""
    rng = np.random.default_rng(seed)
    X = np.zeros((nmax, D))
    X[:n] = rng.uniform(0, 1, (n, D))
    y = np.zeros(nmax)
    y[:n] = np.sin(3 * X[:n]).sum(1) + 0.1 * rng.normal(size=n)
    if name in SPECS:
        family, theta0, _ = tk.build_kernel_spec(SPECS[name], D)
        theta0 = np.asarray(theta0)
    else:
        family, theta0 = name, np.log([1.5, 0.4, 0.5, 0.6])
    thetas = theta0 + rng.uniform(-0.3, 0.3, (rows, len(theta0)))
    nv = 1e-4 if noise == "scalar" else rng.uniform(1e-5, 1e-3, nmax)
    return family, X, y, n, nv, thetas


_J_VG = {}


def jax_value_grad(family, X, y, n, nv, thetas, rel_jitter=0.0):
    """gpry_tpu's LML and jax.value_and_grad of it, row by row."""
    if family not in _J_VG:
        _J_VG[family] = jax.jit(jax.value_and_grad(
            lambda t, X, y, n, nv, rj: jl.masked_lml(family, t, X, y, n, nv,
                                                     rj)))
    out = [_J_VG[family](J(t), J(X), J(y), n, J(nv), rel_jitter)
           for t in thetas]
    return (np.array([float(v) for v, _ in out]),
            np.stack([np.asarray(g) for _, g in out]))


def assert_grad_close(g, g_ref, tol):
    """Within ``tol`` of max |g_ref|, entry by entry."""
    assert np.all(np.isfinite(g)) and np.all(np.isfinite(g_ref))
    assert np.max(np.abs(g - g_ref)) <= tol * np.max(np.abs(g_ref))


@pytest.mark.parametrize("rel_jitter", (0.0, 1e-6), ids=("nojit", "jit"))
@pytest.mark.parametrize("noise", ("scalar", "vector"))
@pytest.mark.parametrize("name", FAMILIES)
def test_lml_value_grad_plain_matches_jax(name, noise, rel_jitter):
    """K10's plain version against jax.value_and_grad(masked_lml): the LML
    within rel 1e-10, the gradient within 1e-8 of max |g|; its value mode
    gives the same LML."""
    family, X, y, n, nv, thetas = problem(name, 1, noise=noise)
    lml, g = fused.lml_value_grad_plain(family, T(thetas), T(X), T(y), n,
                                        T(nv), rel_jitter, grad=True)
    lml_j, g_j = jax_value_grad(family, X, y, n, nv, thetas, rel_jitter)
    np.testing.assert_allclose(lml.numpy(), lml_j, rtol=1e-10)
    assert_grad_close(g.numpy(), g_j, 1e-8)
    lml_v = fused.lml_value_grad_plain(family, T(thetas), T(X), T(y), n,
                                       T(nv), rel_jitter)
    np.testing.assert_array_equal(lml_v.numpy(), lml.numpy())


@pytest.mark.parametrize("name", FAMILIES)
def test_lml_value_grad_plain_matches_autograd(name):
    """The W contraction against torch autograd through the Cholesky of
    the port's own masked_lml (rel 1e-9 of max |g|)."""
    family, X, y, n, nv, thetas = problem(name, 2, noise="vector")
    lml, g = fused.lml_value_grad_plain(family, T(thetas), T(X), T(y), n,
                                        T(nv), 1e-6, grad=True)
    th = T(thetas).requires_grad_(True)
    ref = tl.masked_lml(family, th, T(X), T(y), n, T(nv), 1e-6)
    g_ref, = torch.autograd.grad(ref.sum(), th)
    np.testing.assert_allclose(lml.numpy(), ref.detach().numpy(), rtol=1e-12)
    assert_grad_close(g.numpy(), g_ref.numpy(), 1e-9)


@pytest.mark.parametrize("name", ("matern12", "matern32", "matern52",
                                  "all_nodes"))
def test_lml_grad_at_a_repeated_point(name):
    """A training point given twice (r = 0 off the diagonal): the Matern
    terms' zero-safe square root contributes 0 to the length-scale
    gradient, as in gpry_tpu; both packages agree."""
    family, X, y, n, nv, thetas = problem(name, 3)
    X[1], y[1] = X[0], y[0]
    lml, g = fused.lml_value_grad_plain(family, T(thetas), T(X), T(y), n,
                                        T(nv), grad=True)
    lml_j, g_j = jax_value_grad(family, X, y, n, nv, thetas)
    np.testing.assert_allclose(lml.numpy(), lml_j, rtol=1e-10)
    assert_grad_close(g.numpy(), g_j, 1e-8)


def test_non_pd_row_is_nan_in_both_packages():
    """No noise and a repeated point: K is singular, and the row's LML is
    NaN in gpry_tpu and in K10's plain version, value and gradient; with
    noise the rows are finite."""
    family, X, y, n, _, thetas = problem("rbf", 4, rows=2)
    X[1] = X[0]
    lml, g = fused.lml_value_grad_plain(family, T(thetas), T(X), T(y), n,
                                        T(0.0), grad=True)
    lml_j = np.array([float(jl.masked_lml(family, J(t), J(X), J(y), n, 0.0))
                      for t in thetas])
    assert np.isnan(lml_j).all() and torch.isnan(lml).all()
    assert torch.isnan(g).all()
    lml2, g2 = fused.lml_value_grad_plain(family, T(thetas), T(X), T(y), n,
                                          T(1e-4), grad=True)
    assert torch.isfinite(lml2).all() and torch.isfinite(g2).all()


FIT_CASES = ("rbf", "matern32", "c_rbf_white", "all_nodes")


def fit_problem(name):
    family, X, y, n, nv, thetas = problem(name, 5, n=28, nmax=32, rows=4)
    p = thetas.shape[1]
    lo = thetas[0] - 2.0
    hi = thetas[0] + 2.0
    theta0s = np.random.default_rng(6).uniform(lo, hi, (4, p))
    return family, X, y, n, nv, theta0s, lo, hi


@pytest.mark.parametrize("name", FIT_CASES)
def test_lbfgs_lml_fit_plain_matches_jax(name):
    """K11's plain version against gpry_tpu's _fit_theta_restarts lane by
    lane: over 3 iterations the same nev and theta within 1e-8; at
    maxiter 120 the best -LML within 1e-6."""
    family, X, y, n, nv, theta0s, lo, hi = fit_problem(name)
    args_t = (family, T(X), T(y), n, T(nv), T(theta0s), T(lo), T(hi))
    args_j = (family, J(X), J(y), n, J(nv), J(theta0s), J(lo), J(hi))
    th, f, nev = fused.lbfgs_lml_fit_plain(*args_t, maxiter=3)
    th_j, f_j, nev_j = map(np.asarray, j_fit(*args_j, maxiter=3))
    assert nev.tolist() == nev_j.tolist()
    np.testing.assert_allclose(th.numpy(), th_j, rtol=0, atol=1e-8)
    np.testing.assert_allclose(f.numpy(), f_j, rtol=1e-10)
    th, f, nev, iters = fused.lbfgs_lml_fit_plain(*args_t, maxiter=120,
                                                  return_iters=True)
    _, f_j, _ = map(np.asarray, j_fit(*args_j, maxiter=120))
    assert abs(float(f.min()) - float(np.min(f_j))) < 1e-6
    assert torch.all((iters >= 1) & (iters <= 120))
    assert torch.all(nev >= 1 + 2 * iters)


def test_fit_routes_through_the_wrappers():
    """On CPU tensors the model's _fit_theta_restarts is K11's wrapper,
    which runs its plain version, and the LML screen is K10's wrapper, no
    launch counted."""
    family, X, y, n, nv, theta0s, lo, hi = fit_problem("rbf")
    args = (family, T(X), T(y), n, T(nv), T(theta0s), T(lo), T(hi))
    before = dict(fused.LAUNCHES)
    out = tgp._fit_theta_restarts(*args, maxiter=20)
    ref = fused.lbfgs_lml_fit_plain(*args, maxiter=20)
    for a, b in zip(out, ref):
        assert torch.equal(a, b)
    lml = tgp._lml_batch_chunked(family, T(X), T(y), n, T(nv), T(theta0s))
    assert torch.equal(lml, fused.lml_value_grad_plain(
        family, T(theta0s), T(X), T(y), n, T(nv)))
    assert fused.LAUNCHES == before


def test_fit_finds_the_jax_optimum_spec():
    """The spec-tree twin of test_torch_models'
    test_fit_finds_the_jax_optimum: C() * RBF + WhiteKernel at d = 2 on a
    slightly noisy likelihood (the case this kernel is for: without noise
    the WhiteKernel's optimum sits on its lower bound, where the LML is
    flat and both packages stop ~5e-5 apart), the same data and seed, the
    same best LML (within 1e-6)."""
    bounds = np.array([[-5.0, 5.0]] * 2)
    kernel = {"Sum": [
        {"Product": [{"ConstantKernel": {"constant_value_bounds":
                                         [1e-4, 1e6]}},
                     {"RBF": {"length_scale_bounds": [1e-3, 10.0]}}]},
        {"WhiteKernel": {"noise_level": 1e-4,
                         "noise_level_bounds": [1e-8, 0.1]}}]}
    rng = np.random.default_rng(11)
    X = rng.uniform(-5, 5, (30, 2))
    y = -0.5 * np.sum((X - [0.5, -0.3]) ** 2 / [1.2, 0.6], axis=1) \
        + 0.3 * rng.normal(size=30)
    kw = dict(bounds=bounds, kernel=kernel, n_restarts_optimizer=8,
              random_state=5, account_for_inf=None)
    j = JGPR(preprocessing_X=JNB(bounds), preprocessing_y=JNY(), **kw)
    t = TGPR(preprocessing_X=TNB(bounds), preprocessing_y=TNY(), **kw)
    j.append_to_data(X, y, fit_gpr=True)
    t.append_to_data(X, y, fit_gpr=True)
    assert isinstance(t.family, tuple)
    assert abs(t.log_marginal_likelihood_value_
               - j.log_marginal_likelihood_value_) < 1e-6
    assert abs(t.log_marginal_likelihood() - t.log_marginal_likelihood_value_
               ) < 1e-8
