"""
The wide instance's functions at d = 40 (K8's and K9's d <= 64 instance
on the card): K8's plain version against gpry_tpu's jax.jacfwd gradients
of surrogate_mean_std_smooth, and K9's plain version against gpry_tpu's
LogExp ascent lane by lane, step for step over 3 iterations, on the CPU in
float64 with the same numpy-seeded inputs handed to both packages, at the
tolerances of tests/test_torch_ascent.py's d = 3 cases.  The fixture is
factorized at its initial, moderate hyperparameters (ROADMAP: parity
needs a well-conditioned fixture).  The kernels themselves run on the
card (tests/test_torch_cuda.py, chip_smoke.py).
"""

import sys
from pathlib import Path

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

sys.path.insert(0, str(Path(__file__).parent))

from gpry_tpu.models.gp import GaussianProcessRegressor as JGPR  # noqa: E402
from gpry_tpu.models.gp import \
    surrogate_mean_std_smooth as j_smooth  # noqa: E402
from gpry_tpu.models.preprocessing import Normalize_bounds as JNB  # noqa
from gpry_tpu.models.preprocessing import Normalize_y as JNY  # noqa: E402
from gpry_tpu.ops.lbfgs import minimize_lbfgs_bounded as j_minimize  # noqa

from gpry_tpu_torch import config  # noqa: E402
from gpry_tpu_torch.models.gp import GaussianProcessRegressor as TGPR  # noqa
from gpry_tpu_torch.models.preprocessing import Normalize_bounds as TNB  # noqa
from gpry_tpu_torch.models.preprocessing import Normalize_y as TNY  # noqa
from gpry_tpu_torch.ops import fused  # noqa: E402

config.set_device("cpu")
torch.set_num_threads(1)
D, N, R = 40, 48, 4
_rng = np.random.default_rng(40)
LO = -2.0 - _rng.uniform(0.0, 1.0, D)
BOUNDS = np.stack([LO, LO + 3.0 + _rng.uniform(0.0, 2.0, D)], axis=1)
WIDTH = BOUNDS[:, 1] - BOUNDS[:, 0]
CENTRE = _rng.uniform(-0.5, 0.5, D)
SCALE = _rng.uniform(0.5, 1.5, D)
ZETA, NOISE = D ** -0.85, 0.01


def all_nodes(d):
    """Every node kind (tests/test_torch_ascent.py's tree; the
    ExpSineSquared period grows with d as chip_smoke.py's all_nodes)."""
    return {"Sum": [
        {"Product": [{"ConstantKernel": {"constant_value": 1.3}},
                     {"Exponentiation": {"kernel": {"Matern": {
                         "nu": 2.5, "length_scale": [1.5] * d}},
                         "exponent": 2.0}}]},
        {"Sum": [{"Product": [{"ConstantKernel": {"constant_value": 0.5}},
                              {"RationalQuadratic": {"alpha": 1.5,
                                                     "length_scale": 1.5}}]},
                 {"Sum": [{"ExpSineSquared": {
                     "length_scale": 1.0, "periodicity": 3.0 * d / 8}},
                          {"Sum": [{"DotProduct": {"sigma_0": 0.3}},
                                   {"WhiteKernel": {"noise_level": 1e-3}}]}
                          ]}]}]}


# C() * RBF (the fast family) at a length scale of 1.5 in the unit box, as
# the tree's Matern: the default 0.1 leaves every k ~ 1e-70 at d = 40
KERNELS = {"rbf": {"RBF": {"length_scale": 1.5}}, "all_nodes": all_nodes(D)}


def T(a):
    return torch.as_tensor(np.asarray(a, dtype=float), dtype=torch.float64)


def truth(X):
    X = np.atleast_2d(X)
    return -0.5 * np.sum(((X - CENTRE) / SCALE) ** 2, axis=1)


def pair(name, seed=2):
    """A JAX GPR factorized at its initial hyperparameters and a port GPR
    carrying exactly its state (tests/test_torch_ascent.py's pattern)."""
    kernel = KERNELS[name]
    X = np.random.default_rng(seed).uniform(BOUNDS[:, 0], BOUNDS[:, 1],
                                            (N, D))
    j = JGPR(kernel=kernel, bounds=BOUNDS, preprocessing_X=JNB(BOUNDS),
             preprocessing_y=JNY(), n_restarts_optimizer=4, random_state=3)
    j.append_to_data(X, truth(X), fit_gpr=False)
    j._fitted = True
    t = TGPR(kernel=kernel, bounds=BOUNDS, preprocessing_X=TNB(BOUNDS),
             preprocessing_y=TNY(), n_restarts_optimizer=4, random_state=3)
    svm = {k: v for k, v in vars(j.infinities_classifier).items()
           if k != "backend"}
    t.load_numpy_state(j.kernel_theta, j.X_train_all, j.y_train_all,
                       j.preprocessing_X.loc, j.preprocessing_X.scale,
                       j.preprocessing_y.mean_, j.preprocessing_y.std_,
                       svm=svm)
    return j, t


@pytest.mark.parametrize("name", list(KERNELS))
def test_meanstd_grad_plain_matches_jax_at_d40(name):
    """K8's plain version at d = 40 against gpry_tpu's ``predict(
    return_mean_grad=, return_std_grad=)`` (jax.jacfwd of
    surrogate_mean_std_smooth) and its smooth values, the first 4 queries
    on training points: mean and std within rel 1e-9, both gradients
    within 1e-8 of their max |.|, every gradient entry finite and the
    second 32 coordinates' not all zero.  At the training points sigma
    sits at the noise floor (~0.01 of the others' ~25), where sigma^2 =
    prior - |L^-1 k|^2 cancels: there it is held within 1e-9 of the
    largest sigma, as the gradients are held to their largest entry (40
    squared differences a k summed in two orders: 3e-11 apart at d = 40)."""
    j, t = pair(name)
    assert isinstance(t.family, tuple) == (name == "all_nodes")
    Xq = np.random.default_rng(5).uniform(BOUNDS[:, 0], BOUNDS[:, 1],
                                          (24, D))
    Xq[:4] = t.X_train[:4]
    _, _, gm_j, gs_j = j.predict(Xq, return_std=True, return_mean_grad=True,
                                 return_std_grad=True)
    m_j, s_j = map(np.asarray, j_smooth(j.family, j.surrogate_params(),
                                        jnp.asarray(Xq)))
    m_t, s_t, gm_t, gs_t = (a.numpy() for a in fused.meanstd_grad_plain(
        t.family, t.surrogate_params(), T(Xq)))
    np.testing.assert_allclose(m_t, m_j, rtol=1e-9)
    np.testing.assert_allclose(s_t[4:], s_j[4:], rtol=1e-9)
    assert np.max(np.abs(s_t[:4] - s_j[:4])) <= 1e-9 * np.max(s_j)
    for a, b in ((gm_t, gm_j), (gs_t, gs_j)):
        assert b.shape == (24, D) and np.all(np.isfinite(b))
        assert np.any(b[:, 32:] != 0.0)
        assert np.max(np.abs(a - b)) <= 1e-8 * np.max(np.abs(b))


def j_neg_logexp(j):
    """The objective of gpry_tpu's _optimize_restarts
    (acquisition/batch_optimizer.py:90-97)."""
    p = j.surrogate_params()

    def neg_acq(x):
        mu, std = j_smooth(j.family, p, x[None])
        var = std[0] * std[0] - NOISE * NOISE
        mu_c = jnp.minimum(mu[0], p.clip_max)
        return -(2.0 * ZETA * (mu_c - p.y_max)
                 + 0.5 * jnp.log(jnp.maximum(var, 1e-300)))

    return neg_acq


@pytest.mark.parametrize("name", list(KERNELS))
def test_logexp_ascent_plain_matches_jax_at_d40(name):
    """K9's plain version at d = 40 against gpry_tpu's ascent
    (minimize_lbfgs_bounded on _optimize_restarts' objective, vmapped over
    the lanes, with count_evals), lane by lane and step for step over 3
    iterations, lane 0 on the last training point: the same nev per lane,
    x within 1e-9 of the box width, f within 1e-9 (1 + |f|); every lane
    moved from its start."""
    j, t = pair(name)
    p = t.surrogate_params()
    x0s = np.random.default_rng(4).uniform(BOUNDS[:, 0], BOUNDS[:, 1],
                                           (R, D))
    x0s[0] = t.X_train[-1]
    neg = j_neg_logexp(j)
    lo_j, hi_j = jnp.asarray(BOUNDS[:, 0]), jnp.asarray(BOUNDS[:, 1])
    xj, fj, nj = map(np.asarray, jax.vmap(lambda x0: j_minimize(
        neg, x0, lo_j, hi_j, maxiter=3, tol=1e-8, count_evals=True))(
        jnp.asarray(x0s)))
    xt, ft, nt = fused.lbfgs_logexp_ascent_plain(
        t.family, p, ZETA, NOISE, T(x0s), T(BOUNDS[:, 0]), T(BOUNDS[:, 1]),
        maxiter=3)
    assert nt.tolist() == nj.tolist()
    assert np.all(np.abs(xt.numpy() - xj) <= 1e-9 * WIDTH)
    np.testing.assert_array_less(np.abs(ft.numpy() - fj),
                                 1e-9 * (1 + np.abs(fj)))
    assert np.all(np.max(np.abs(xt.numpy() - x0s), axis=1) > 1e-6)
