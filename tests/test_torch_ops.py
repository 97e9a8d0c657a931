"""
Parity of gpry_tpu_torch's ops (kernels, padded linear algebra, the K3
plain version, the batched L-BFGS) with gpry_tpu's on the CPU in float64.
Inputs are made with seeded numpy and handed to both packages.
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

import gpry_tpu.ops.kernels as jk
import gpry_tpu.ops.linalg as jl
from gpry_tpu.ops.lbfgs import multistart_minimize

from gpry_tpu_torch import config
from gpry_tpu_torch.ops import fused
from gpry_tpu_torch.ops import kernels as tk
from gpry_tpu_torch.ops import linalg as tl
from gpry_tpu_torch.ops.lbfgs import minimize_lbfgs_bounded

config.set_device("cpu")
# tiny shapes: one intra-op thread, so that parallel test workers do
# not oversubscribe the cores
torch.set_num_threads(1)
FAST = ("rbf", "matern12", "matern32", "matern52")
# composite kernels (gpry_tpu/ops/kernels.py spec trees): every node kind,
# and C() * RBF + WhiteKernel
SPECS = {
    "spec_all_nodes": lambda d: {"Sum": [
        {"Product": [{"ConstantKernel": {"constant_value": 1.3}},
                     {"Exponentiation": {"kernel": {"Matern": {
                         "nu": 2.5, "length_scale": 0.5}},
                         "exponent": 2.0}}]},
        {"Sum": [{"Product": [{"ConstantKernel": {"constant_value": 0.5}},
                              {"RationalQuadratic": {"alpha": 1.5,
                                                     "length_scale": 0.5}}]},
                 {"Sum": [{"ExpSineSquared": {"length_scale": 1.0,
                                              "periodicity": 3.0}},
                          {"Sum": [{"DotProduct": {"sigma_0": 0.3}},
                                   {"WhiteKernel": {"noise_level": 1e-3}}]}
                          ]}]}]},
    "spec_c_rbf_white": lambda d: {"Sum": [
        {"Product": [{"ConstantKernel": {"constant_value": 1.5}},
                     {"RBF": {"length_scale": [0.3 + 0.1 * i
                                               for i in range(d)]}}]},
        {"WhiteKernel": {"noise_level": 1e-3}}]},
}
FAMILIES = FAST + tuple(SPECS)


def family_theta(name, theta, d):
    """The kernel argument and theta of a test case: a fast family with the
    test's ``theta``, or a spec (by name) at its theta0, in ``d``
    dimensions."""
    if name in SPECS:
        spec, theta0, _ = tk.build_kernel_spec(SPECS[name](d), d)
        return spec, np.asarray(theta0)
    return name, theta


def T(a):
    return torch.as_tensor(np.asarray(a, dtype=float), dtype=torch.float64)


def J(a):
    return jnp.asarray(np.asarray(a, dtype=float))


def padded_problem(seed, n=20, nmax=64, d=3, noise="scalar"):
    rng = np.random.default_rng(seed)
    X = np.zeros((nmax, d))
    X[:n] = rng.uniform(0, 1, (n, d))
    y = np.zeros(nmax)
    y[:n] = np.sin(3 * X[:n]).sum(1) + 0.1 * rng.normal(size=n)
    theta = np.concatenate([[np.log(1.5)], np.log(rng.uniform(0.2, 0.8, d))])
    nv = 1e-4 if noise == "scalar" else rng.uniform(1e-5, 1e-3, nmax)
    return X, y, n, theta, nv


@pytest.mark.parametrize("family", FAMILIES)
def test_cross_kernel_and_diag(family):
    rng = np.random.default_rng(0)
    X1, X2 = rng.uniform(-1, 2, (13, 4)), rng.uniform(-1, 2, (7, 4))
    X2[0] = X1[0]  # r = 0: the Matern square root must stay zero-safe
    family, theta = family_theta(family, np.log([1.7, 0.5, 0.8, 1.3, 2.0]),
                                 4)
    K_j = np.asarray(jk.cross_kernel(family, J(theta), J(X1), J(X2)))
    K_t = tk.cross_kernel(family, T(theta), T(X1), T(X2)).numpy()
    np.testing.assert_allclose(K_t, K_j, rtol=1e-12, atol=0)
    np.testing.assert_allclose(
        tk.kernel_diag(family, T(theta), T(X1)).numpy(),
        np.asarray(jk.kernel_diag(family, J(theta), J(X1))), rtol=1e-12)


def test_make_theta_and_bounds():
    np.testing.assert_allclose(
        tk.make_theta(1.3, [0.2, 0.7]).numpy(),
        np.asarray(jk.make_theta(1.3, jnp.asarray([0.2, 0.7]))), rtol=1e-12)
    th = np.log([2.0, 0.3, 0.6])
    for dyn in (False, True):
        np.testing.assert_allclose(
            tk.theta_bounds_dynamic(th, 2, prior_widths=[1.0, 2.0],
                                    dynamic=dyn),
            jk.theta_bounds_dynamic(th, 2, prior_widths=[1.0, 2.0],
                                    dynamic=dyn), rtol=1e-12)


def test_spec_trees_refused():
    """Spec trees run (tests/test_torch_spec.py); a node that is not a
    spec node is refused."""
    for bad in (("rbf3", 2), ("sum", ("white",)), ("pow", ("white",), "x")):
        with pytest.raises(ValueError):
            tk.cross_kernel(bad, T([0.0, 0.0, 0.0]), T(np.zeros((2, 2))),
                            T(np.zeros((2, 2))))
        with pytest.raises(ValueError):
            tk.check_family(bad)


@pytest.mark.parametrize("family", FAMILIES)
@pytest.mark.parametrize("noise", ["scalar", "vector"])
def test_masked_kernel_matrix_k3_plain(family, noise):
    X, y, n, theta, nv = padded_problem(1, noise=noise)
    family, theta = family_theta(family, theta, 3)
    thetas = np.stack([theta, theta + 0.3, theta - 0.2])
    for rel_jitter in (0.0, 1e-5):
        K_t = fused.masked_kernel_matrix_batched(
            family, T(thetas), T(X), n, T(nv), rel_jitter).numpy()
        for r in range(len(thetas)):
            K_j = np.asarray(jl.masked_kernel_matrix(
                family, J(thetas[r]), J(X), n, J(nv), rel_jitter))
            np.testing.assert_allclose(K_t[r], K_j, rtol=1e-10, atol=1e-12)
    # the padding block is the identity
    np.testing.assert_array_equal(
        K_t[:, n:, n:], np.broadcast_to(np.eye(64 - n), (3, 64 - n, 64 - n)))


@pytest.mark.parametrize("family", FAMILIES)
def test_factorize(family):
    X, y, n, theta, nv = padded_problem(2)
    family, theta = family_theta(family, theta, 3)
    L_t, a_t = tl.factorize(family, T(theta), T(X), T(y), n, T(nv))
    L_j, a_j = jl.factorize(family, J(theta), J(X), J(y), n, nv)
    np.testing.assert_allclose(L_t.numpy(), np.asarray(L_j), rtol=1e-10,
                               atol=1e-12)
    np.testing.assert_allclose(a_t.numpy(), np.asarray(a_j), rtol=1e-10,
                               atol=1e-10)


@pytest.mark.parametrize("noise", ["scalar", "vector"])
def test_chol_append_equals_factorize(noise):
    family = "rbf"
    X, y, n, theta, nv = padded_problem(3, n=24, noise=noise)
    n0, k = 20, 4
    Xs, ys = X.copy(), y.copy()
    Xs[n0:], ys[n0:] = 0.0, 0.0
    L0, _ = tl.factorize(family, T(theta), T(Xs), T(ys), n0, T(nv))
    X2, y2, n2, L2, a2 = tl.chol_append(
        family, T(theta), T(Xs), T(ys), n0, T(nv), L0, T(X[n0:n]),
        T(y[n0:n]))
    assert n2 == n
    L_f, a_f = tl.factorize(family, T(theta), T(X), T(y), n, T(nv))
    np.testing.assert_allclose(L2.numpy(), L_f.numpy(), rtol=1e-10,
                               atol=1e-12)
    np.testing.assert_allclose(a2.numpy(), a_f.numpy(), rtol=1e-10,
                               atol=1e-10)
    # padding stays [[L, 0], [0, I]]
    Ln = L2.numpy()
    np.testing.assert_array_equal(Ln[n:, n:], np.eye(64 - n))
    np.testing.assert_array_equal(Ln[:n, n:], 0.0)
    np.testing.assert_array_equal(Ln[n:, :n], 0.0)
    # and the JAX block append agrees
    Lj0, _ = jl.factorize(family, J(theta), J(Xs), J(ys), n0, J(nv))
    out_j = jl.chol_append(family, J(theta), J(Xs), J(ys), n0, J(nv), Lj0,
                           J(X[n0:n]), J(y[n0:n]))
    np.testing.assert_allclose(Ln, np.asarray(out_j[3]), rtol=1e-10,
                               atol=1e-12)


def test_chol_append_non_pd_gives_nan():
    """A duplicate point without noise makes the new block singular: like
    JAX's Cholesky, the new row is NaN instead of an exception."""
    X, y, n, theta, _ = padded_problem(4, n=10)
    L0, _ = tl.factorize("rbf", T(theta), T(X), T(y), n, T(0.0))
    out = tl.chol_append("rbf", T(theta), T(X), T(y), n, T(0.0), L0,
                         T(X[:1]), T(y[:1]))
    assert bool(torch.isnan(out[3][n]).any())


@pytest.mark.parametrize("family", FAMILIES)
def test_masked_lml_and_lml_batch(family):
    X, y, n, theta, nv = padded_problem(5)
    family, theta = family_theta(family, theta, 3)
    rng = np.random.default_rng(5)
    thetas = theta + rng.uniform(-1, 1, (6, len(theta)))
    thetas[-1, 0] = -40.0  # tiny variance: still PD through the noise
    lml_t = tl.lml_batch(family, T(X), T(y), n, T(nv), T(thetas)).numpy()
    lml_j = np.asarray([jl.masked_lml(family, J(t), J(X), J(y), n, nv)
                        for t in thetas])
    np.testing.assert_allclose(lml_t, lml_j, rtol=1e-9)
    lml_g = tl.masked_lml(family, T(thetas), T(X), T(y), n, T(nv)).numpy()
    np.testing.assert_allclose(lml_g, lml_j, rtol=1e-9)


def test_lml_non_pd_lane_is_nan():
    X, y, n, theta, _ = padded_problem(6)
    X[1] = X[0]
    lml = tl.lml_batch("rbf", T(X), T(y), n, T(0.0),
                       T(np.stack([theta, theta]))).numpy()
    assert np.all(np.isnan(lml))


@pytest.mark.parametrize("family", FAMILIES)
def test_predict_mean_and_meanvar(family):
    X, y, n, theta, nv = padded_problem(7)
    family, theta = family_theta(family, theta, 3)
    L, a = tl.factorize(family, T(theta), T(X), T(y), n, T(nv))
    Lj, aj = jl.factorize(family, J(theta), J(X), J(y), n, nv)
    Xq = np.random.default_rng(7).uniform(-0.2, 1.2, (30, 3))
    np.testing.assert_allclose(
        tl.predict_mean(family, T(theta), T(X), n, a, T(Xq)).numpy(),
        np.asarray(jl.predict_mean(family, J(theta), J(X), n, aj, J(Xq))),
        rtol=1e-10, atol=1e-10)
    m_t, v_t = tl.predict_meanvar(family, T(theta), T(X), n, T(nv), L, a,
                                  T(Xq))
    m_j, v_j = jl.predict_meanvar(family, J(theta), J(X), n, nv, Lj, aj,
                                  J(Xq))
    np.testing.assert_allclose(m_t.numpy(), np.asarray(m_j), rtol=1e-10,
                               atol=1e-10)
    np.testing.assert_allclose(v_t.numpy(), np.asarray(v_j), rtol=1e-9,
                               atol=1e-12)


def test_lbfgs_lml_optimum_matches_jax():
    """Multistart L-BFGS on the negative LML: the best optimum's value of
    the batched lock-step solver equals the vmapped JAX solver's."""
    X, y, n, theta, nv = padded_problem(8, n=25)
    lo = np.array([np.log(1e-4)] + [np.log(1e-3)] * 3)
    hi = np.array([np.log(1e6)] + [np.log(10.0)] * 3)
    x0s = np.random.default_rng(8).uniform(lo, hi, (6, 4))

    def nll_t(th):
        return -tl.masked_lml("rbf", th, T(X), T(y), n, T(nv))

    def nll_j(th):
        return -jl.masked_lml("rbf", th, J(X), J(y), n, nv)

    xs_t, f_t, nev_t = minimize_lbfgs_bounded(nll_t, T(x0s), T(lo), T(hi),
                                              maxiter=120)
    xs_j, f_j, nev_j = multistart_minimize(nll_j, J(x0s), J(lo), J(hi),
                                           maxiter=120, count_evals=True)
    assert abs(float(f_t.min()) - float(np.min(f_j))) < 1e-6
    assert np.all(nev_t.numpy() >= 1)
    # each lane's optimum is a local optimum of the same objective
    np.testing.assert_allclose(nll_t(xs_t).numpy(), f_t.numpy(), rtol=1e-12)


def test_lbfgs_nonfinite_start_returns_start():
    lo, hi = T([-1.0, -1.0]), T([1.0, 1.0])

    def f(x):
        v = torch.sum((x - 0.3) ** 2, dim=-1)
        return torch.where(x[:, 0] > 0.9, torch.full_like(v, torch.nan), v)

    x0 = T([[0.95, 0.0], [0.0, 0.0]])
    xs, fs, nev = minimize_lbfgs_bounded(f, x0, lo, hi, maxiter=50)
    np.testing.assert_allclose(xs[0].numpy(), [0.95, 0.0], atol=1e-6)
    assert nev[0] == 1
    np.testing.assert_allclose(xs[1].numpy(), [0.3, 0.3], atol=1e-5)


@pytest.mark.parametrize("x0", ([-0.5, 0.8], [0.9, -0.9], [0.1, 0.2]))
def test_lbfgs_iteration_counts(x0):
    """With ``return_iters`` the solver also returns each lane's
    iterations, and (x, f, nev) as without it; on one lane, a spying
    objective sees 1 + iters value-and-gradient calls and nev - 1 - iters
    line-search probes."""
    lo, hi = T([-1.0, -1.0]), T([1.0, 1.0])
    grad_calls = []

    def rosen(x):
        grad_calls.append(torch.is_grad_enabled())
        return (0.1 - x[:, 0]) ** 2 + 10.0 * (x[:, 1] - x[:, 0] ** 2) ** 2

    x, f, nev = minimize_lbfgs_bounded(rosen, T([x0]), lo, hi, maxiter=40)
    grad_calls.clear()
    x2, f2, nev2, iters = minimize_lbfgs_bounded(rosen, T([x0]), lo, hi,
                                                 maxiter=40,
                                                 return_iters=True)
    assert torch.equal(x, x2) and torch.equal(f, f2)
    assert torch.equal(nev, nev2)
    assert 0 < int(iters[0]) <= 40
    assert sum(grad_calls) == 1 + int(iters[0])
    assert len(grad_calls) - sum(grad_calls) == int(nev[0] - 1 - iters[0])


def test_wrapper_argument_checks():
    """The kernel wrappers refuse what the kernels do not take."""
    ok = torch.zeros((4, 2), dtype=torch.float64)
    cpu = torch.device("cpu")
    with pytest.raises(TypeError, match="float64"):
        fused._check_cuda("k", cpu, x=ok.float())
    with pytest.raises(ValueError, match="contiguous"):
        fused._check_cuda("k", cpu, x=ok.T)
    with pytest.raises(RuntimeError, match="requires grad"):
        fused._check_cuda("k", cpu, x=ok.clone().requires_grad_(True))
    with pytest.raises(ValueError, match="CUDA"):
        fused._check_cuda("k", cpu, x=ok)


def test_cpu_wrappers_use_plain_versions_without_launching():
    fused.reset_launch_counts()
    X, y, n, theta, nv = padded_problem(9)
    K = fused.masked_kernel_matrix_batched("rbf", T(theta[None]), T(X), n,
                                           T(nv))
    K0 = fused.masked_kernel_matrix_plain("rbf", T(theta[None]), T(X), n,
                                          T(nv))
    assert torch.equal(K, K0)
    assert all(v == 0 for v in fused.LAUNCHES.values())
