"""
The surrogate's gradients (K8's plain version) and the BatchOptimizer's
LogExp ascent (K9's plain version) in gpry_tpu_torch, against gpry_tpu on
the CPU in float64, with the same numpy-seeded inputs handed to both
packages; the rule for a restart that starts on a training point; and the
routing of the BatchOptimizer and ``predict`` through the K8 / K9
wrappers.  The kernels themselves run on the card
(tests/test_torch_cuda.py, chip_smoke.py).
"""

import sys
from pathlib import Path

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

sys.path.insert(0, str(Path(__file__).parent))

from gpry_tpu.acquisition.batch_optimizer import \
    _optimize_restarts as j_optimize  # noqa: E402
from gpry_tpu.models.gp import GaussianProcessRegressor as JGPR  # noqa: E402
from gpry_tpu.models.gp import \
    surrogate_mean_std_smooth as j_smooth  # noqa: E402
from gpry_tpu.models.preprocessing import Normalize_bounds as JNB  # noqa
from gpry_tpu.models.preprocessing import Normalize_y as JNY  # noqa: E402
from gpry_tpu.ops.lbfgs import minimize_lbfgs_bounded as j_minimize  # noqa

from gpry_tpu_torch import config  # noqa: E402
from gpry_tpu_torch.acquisition import batch_optimizer as tbo  # noqa: E402
from gpry_tpu_torch.models import gp as tgp  # noqa: E402
from gpry_tpu_torch.models.gp import GaussianProcessRegressor as TGPR  # noqa
from gpry_tpu_torch.models.preprocessing import Normalize_bounds as TNB  # noqa
from gpry_tpu_torch.models.preprocessing import Normalize_y as TNY  # noqa
from gpry_tpu_torch.ops import fused  # noqa: E402
from gpry_tpu_torch.ops.lbfgs import to_constrained, \
    to_unconstrained  # noqa: E402

config.set_device("cpu")
# tiny shapes: one intra-op thread, so that parallel test workers do
# not oversubscribe the cores
torch.set_num_threads(1)
D = 3
BOUNDS = np.array([[-3.0, 4.0], [-2.0, 2.0], [-1.0, 3.0]])
WIDTH = BOUNDS[:, 1] - BOUNDS[:, 0]


def all_nodes(d):
    """A spec holding every node kind (tests/test_torch_spec.py's)."""
    return {"Sum": [
        {"Product": [{"ConstantKernel": {"constant_value": 1.3}},
                     {"Exponentiation": {"kernel": {"Matern": {
                         "nu": 2.5, "length_scale": [1.5] * d}},
                         "exponent": 2.0}}]},
        {"Sum": [{"Product": [{"ConstantKernel": {"constant_value": 0.5}},
                              {"RationalQuadratic": {"alpha": 1.5,
                                                     "length_scale": 1.5}}]},
                 {"Sum": [{"ExpSineSquared": {"length_scale": 1.0,
                                              "periodicity": 3.0}},
                          {"Sum": [{"DotProduct": {"sigma_0": 0.3}},
                                   {"WhiteKernel": {"noise_level": 1e-3}}]}
                          ]}]}]}


# chip_smoke.py's path (f) kernel: C() * RBF(ARD) + WhiteKernel
PATH_F = {"Sum": [
    {"Product": [{"ConstantKernel": {"constant_value_bounds": [1e-4, 1e6]}},
                 {"RBF": {"length_scale_bounds": [1e-3, 10.0]}}]},
    {"WhiteKernel": {"noise_level": 1e-4,
                     "noise_level_bounds": [1e-8, 0.1]}}]}

KERNELS = {"rbf": "RBF", "matern12": "matern12", "matern32": "matern32",
           "matern52": "matern52", "all_nodes": all_nodes(D),
           "path_f": PATH_F}


def T(a):
    return torch.as_tensor(np.asarray(a, dtype=float), dtype=torch.float64)


def truth(X):
    X = np.atleast_2d(X)
    return -0.5 * np.sum((X - [0.5, -0.3, 1.0]) ** 2 / [1.5, 0.4, 0.8],
                         axis=1)


def pair(name, n=30, seed=2):
    """A JAX GPR factorized at its initial (moderate) hyperparameters, so
    that parity is limited by rounding, and a port GPR carrying exactly
    its state (the pattern of tests/test_torch_acquisition.py)."""
    kernel = KERNELS[name]
    X = np.random.default_rng(seed).uniform(BOUNDS[:, 0], BOUNDS[:, 1],
                                            (n, D))
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


def starts(t, seed=4, R=8):
    """R restarts in the box, lane 0 on the last training point (as
    multi_add places it)."""
    x0s = np.random.default_rng(seed).uniform(BOUNDS[:, 0], BOUNDS[:, 1],
                                              (R, D))
    x0s[0] = t.X_train[-1]
    return x0s


ZETA, NOISE = D ** -0.85, 0.01


def j_neg_logexp(j):
    """The objective of gpry_tpu's _optimize_restarts
    (acquisition/batch_optimizer.py:90-97), for its minimizer with
    ``count_evals``."""
    p = j.surrogate_params()

    def neg_acq(x):
        mu, std = j_smooth(j.family, p, x[None])
        var = std[0] * std[0] - NOISE * NOISE
        mu_c = jnp.minimum(mu[0], p.clip_max)
        return -(2.0 * ZETA * (mu_c - p.y_max)
                 + 0.5 * jnp.log(jnp.maximum(var, 1e-300)))

    return neg_acq


def j_ascent(j, x0s, maxiter):
    lo, hi = jnp.asarray(BOUNDS[:, 0]), jnp.asarray(BOUNDS[:, 1])
    neg = j_neg_logexp(j)
    xs, f, nev = jax.vmap(lambda x0: j_minimize(
        neg, x0, lo, hi, maxiter=maxiter, tol=1e-8, count_evals=True))(
        jnp.asarray(x0s))
    return np.asarray(xs), np.asarray(f), np.asarray(nev)


@pytest.mark.parametrize("name", list(KERNELS))
def test_meanstd_grad_plain_matches_jax(name):
    """K8's plain version against gpry_tpu's ``predict(return_mean_grad=,
    return_std_grad=)`` (jax.jacfwd of surrogate_mean_std_smooth) and its
    smooth values, the first 5 queries on training points: mean and std
    within rel 1e-9, both gradients within 1e-8 of their max |.|.  The
    port's ``predict`` returns the same gradients (through the K8
    wrapper)."""
    j, t = pair(name)
    assert isinstance(t.family, tuple) == (name in ("all_nodes", "path_f"))
    Xq = np.random.default_rng(5).uniform(BOUNDS[:, 0], BOUNDS[:, 1],
                                          (60, D))
    Xq[:5] = t.X_train[:5]
    _, _, gm_j, gs_j = j.predict(Xq, return_std=True, return_mean_grad=True,
                                 return_std_grad=True)
    m_j, s_j = map(np.asarray, j_smooth(j.family, j.surrogate_params(),
                                        jnp.asarray(Xq)))
    m_t, s_t, gm_t, gs_t = (a.numpy() for a in fused.meanstd_grad_plain(
        t.family, t.surrogate_params(), T(Xq)))
    np.testing.assert_allclose(m_t, m_j, rtol=1e-9)
    np.testing.assert_allclose(s_t, s_j, rtol=1e-9)
    for a, b in ((gm_t, gm_j), (gs_t, gs_j)):
        assert np.all(np.isfinite(b))
        assert np.max(np.abs(a - b)) <= 1e-8 * np.max(np.abs(b))
    _, gm_p, gs_p = t.predict(Xq, return_mean_grad=True,
                              return_std_grad=True)
    np.testing.assert_array_equal(gm_p, gm_t)
    np.testing.assert_array_equal(gs_p, gs_t)


@pytest.mark.parametrize("name", ["rbf", "all_nodes"])
def test_logexp_ascent_plain_matches_jax_per_lane(name):
    """K9's plain version against gpry_tpu's ascent, lane by lane, lane 0
    on a training point.  Step for step over 3 iterations (gpry_tpu's
    minimize_lbfgs_bounded on _optimize_restarts' objective, with
    count_evals): the same nev per lane, x within 1e-9 of the box width,
    f within 1e-9 (1 + |f|).  To the end, against _optimize_restarts
    itself: the gated rescore and f within 1e-8 (1 + |.|) per lane, x
    within 1e-4 of the box width.  Where a lane
    may differ: near an optimum the stall test (improvements below
    16 eps (1 + |f|)) and the last line search decide on rounding that the
    two packages' summation orders do not share, so nev differs there and
    the endpoint moves along the optimum's flat directions (by up to
    ~1e-5 of the width for the spec tree here, where f and the gated
    rescore then differ by ~2e-9), while the value stays put."""
    j, t = pair(name)
    p = t.surrogate_params()
    x0s = starts(t)
    lo, hi = T(BOUNDS[:, 0]), T(BOUNDS[:, 1])
    xj, fj, nj = j_ascent(j, x0s, maxiter=3)
    xt, ft, nt = fused.lbfgs_logexp_ascent_plain(t.family, p, ZETA, NOISE,
                                                 T(x0s), lo, hi, maxiter=3)
    assert nt.tolist() == nj.tolist()
    assert np.all(np.abs(xt.numpy() - xj) <= 1e-9 * WIDTH)
    np.testing.assert_array_less(np.abs(ft.numpy() - fj),
                                 1e-9 * (1 + np.abs(fj)))
    xo, vo = map(np.asarray, j_optimize(
        j.family, j.surrogate_params(), ZETA, NOISE, jnp.asarray(x0s),
        jnp.asarray(BOUNDS[:, 0]), jnp.asarray(BOUNDS[:, 1])))
    xt, vt = map(lambda a: a.numpy(), tbo._optimize_restarts(
        t.family, p, ZETA, NOISE, T(x0s), lo, hi))
    assert np.all(np.abs(xt - xo) <= 1e-4 * WIDTH)
    np.testing.assert_array_equal(np.isfinite(vt), np.isfinite(vo))
    fin = np.isfinite(vo)
    assert fin.sum() >= 6
    np.testing.assert_array_less(np.abs(vt[fin] - vo[fin]),
                                 1e-8 * (1 + np.abs(vo[fin])))
    _, fj, _ = j_ascent(j, x0s, maxiter=100)
    _, ft, _ = fused.lbfgs_logexp_ascent_plain(t.family, p, ZETA, NOISE,
                                               T(x0s), lo, hi)
    np.testing.assert_array_less(np.abs(ft.numpy() - fj),
                                 1e-8 * (1 + np.abs(fj)))


@pytest.mark.parametrize("name", ["rbf", "path_f"])
def test_lane_on_a_training_point(name):
    """The rule for the restart that starts on a training point (lane 0 of
    every believer step), pinned in both packages.  With a plain kernel
    (RBF) the latent variance there is below the noise variance: the log
    term sits on its clamp, f0 = -2 zeta (mu - y_max) - 0.5 log(1e-300)
    (finite), and the gradient is the mean's alone (the clamp passes
    none; the std's 0 / 0 never arises, the latent variance stays
    positive), so the lane climbs the mean until the log term is finite
    again and ends more than 300 below f0.  With a WhiteKernel (path f's
    C * RBF + White) its level stays in the latent variance, sigma > sigma_n
    there, and the point is a regular start: f0 = -(2 zeta (mu - y_max) +
    0.5 log(sigma^2 - sigma_n^2)) with both terms' gradient.  Either way
    f0 and the gradient agree between the packages (rel 1e-12 / 1e-9) and
    the lane leaves the point after more than one evaluation, ending
    below f0."""
    j, t = pair(name)
    p = t.surrogate_params()
    x0 = t.X_train[-1:]
    lo, hi = T(BOUNDS[:, 0]), T(BOUNDS[:, 1])
    mu, std, gmu, _ = fused.meanstd_grad_plain(t.family, p, T(x0))
    var0 = float(std[0]) ** 2 - NOISE ** 2
    clamped = name == "rbf"
    assert (var0 < 0) == clamped and float(std[0]) > 0
    f0 = -2.0 * ZETA * (float(mu[0]) - float(p.y_max)) \
        - 0.5 * np.log(1e-300 if clamped else var0)
    # torch: f and its u-space gradient at u0
    u0 = to_unconstrained(T(x0), lo, hi).requires_grad_(True)
    X = to_constrained(u0, lo, hi)
    m, s = fused.meanvar_ungated_plain(t.family, p, X)
    var = s * s - NOISE * NOISE
    f = -(2.0 * ZETA * (torch.minimum(m, p.clip_max) - p.y_max)
          + 0.5 * torch.log(torch.clamp_min(var, 1e-300)))
    g_t, = torch.autograd.grad(f.sum(), u0)
    assert abs(float(f.detach()) - f0) <= 1e-12 * abs(f0)
    if clamped:
        sig = torch.sigmoid(u0.detach())
        g_mean_only = -2.0 * ZETA * gmu * T(WIDTH) * sig * (1 - sig)
        np.testing.assert_allclose(g_t.numpy(), g_mean_only.numpy(),
                                   rtol=1e-9)
    # gpry_tpu: the same f and gradient
    from gpry_tpu.ops.lbfgs import to_constrained as j_to_c
    from gpry_tpu.ops.lbfgs import to_unconstrained as j_to_u
    neg = j_neg_logexp(j)
    lo_j, hi_j = jnp.asarray(BOUNDS[:, 0]), jnp.asarray(BOUNDS[:, 1])
    f_j, g_j = jax.value_and_grad(lambda u: neg(j_to_c(u, lo_j, hi_j)))(
        j_to_u(jnp.asarray(x0[0]), lo_j, hi_j))
    assert abs(float(f_j) - f0) <= 1e-12 * abs(f0)
    np.testing.assert_allclose(np.asarray(g_j), g_t.numpy()[0], rtol=1e-9)
    # both lanes leave the point and end below f0
    x0s = starts(t)
    xj, fj, nj = j_ascent(j, x0s, maxiter=100)
    xt, ft, nt = fused.lbfgs_logexp_ascent_plain(t.family, p, ZETA, NOISE,
                                                 T(x0s), lo, hi)
    for x_end, f_end, nev in ((xj[0], fj[0], nj[0]),
                              (xt[0].numpy(), float(ft[0]), int(nt[0]))):
        assert nev > 1
        assert f_end < f0 - (300.0 if clamped else 0.0)
        assert np.max(np.abs(x_end - x0[0])) > 1e-3


def test_routing_through_the_wrappers(monkeypatch):
    """On the CPU the BatchOptimizer's LogExp ascent goes through
    fused.lbfgs_logexp_ascent (once per believer step) and
    predict(return_mean_grad=True) through fused.meanstd_grad; both run
    their plain versions and launch nothing."""
    _, t = pair("rbf")
    calls = {"lbfgs_logexp_ascent": 0, "meanstd_grad": 0}

    def spy(name, fn):
        def wrapped(*args, **kwargs):
            calls[name] += 1
            return fn(*args, **kwargs)
        return wrapped

    monkeypatch.setattr(tbo, "lbfgs_logexp_ascent", spy(
        "lbfgs_logexp_ascent", fused.lbfgs_logexp_ascent))
    monkeypatch.setattr(tgp, "meanstd_grad", spy(
        "meanstd_grad", fused.meanstd_grad))
    fused.reset_launch_counts()
    X, _, vals = tbo.BatchOptimizer(BOUNDS).multi_add(
        t, n_points=2, rng=np.random.default_rng(5))
    assert calls["lbfgs_logexp_ascent"] == 2 and np.all(np.isfinite(vals))
    t.predict(X, return_mean_grad=True)
    assert calls["meanstd_grad"] == 1
    assert all(v == 0 for v in fused.LAUNCHES.values())


def test_smooth_function_refuses_double_backward():
    """The autograd Function that serves surrogate_mean_std_smooth on the
    card (here over K8's plain version): its gradient of a function of the
    mean and std is the plain autograd's, and differentiating that
    gradient again raises."""
    _, t = pair("rbf")
    p = t.surrogate_params()
    Xq = T(np.random.default_rng(6).uniform(BOUNDS[:, 0], BOUNDS[:, 1],
                                            (7, D)))
    Xg = Xq.clone().requires_grad_(True)
    m, s = tgp._MeanStdSmooth.apply(Xg, t.family, p)
    g, = torch.autograd.grad((m * m + s * s).sum(), Xg, create_graph=True)
    Xr = Xq.clone().requires_grad_(True)
    mr, sr = tgp.surrogate_mean_std_smooth(t.family, p, Xr)
    gr, = torch.autograd.grad((mr * mr + sr * sr).sum(), Xr)
    np.testing.assert_allclose(g.detach().numpy(), gr.numpy(), rtol=1e-12)
    with pytest.raises(RuntimeError, match="twice"):
        g.sum().backward()
