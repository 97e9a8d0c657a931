"""
Parity of gpry_tpu_torch's acquisition (LogExp, the believer append, the
batched L-BFGS ascent, BatchOptimizer.multi_add) with gpry_tpu's on the
CPU in float64, on a GPR carried across with ``load_numpy_state``.
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from gpry_tpu.acquisition import functions as jf
from gpry_tpu.acquisition.base import append_lie as j_append_lie
from gpry_tpu.acquisition.batch_optimizer import BatchOptimizer as JBO
from gpry_tpu.acquisition.batch_optimizer import \
    _acq_values_gated as j_gated
from gpry_tpu.acquisition.batch_optimizer import \
    _optimize_restarts as j_optimize
from gpry_tpu.models.gp import GaussianProcessRegressor as JGPR
from gpry_tpu.models.gp import surrogate_predict as j_predict
from gpry_tpu.models.preprocessing import Normalize_bounds as JNB
from gpry_tpu.models.preprocessing import Normalize_y as JNY

from gpry_tpu_torch import config
from gpry_tpu_torch.acquisition import functions as tf
from gpry_tpu_torch.acquisition.base import append_lie as t_append_lie
from gpry_tpu_torch.acquisition.base import grow_surrogate
from gpry_tpu_torch.acquisition.batch_optimizer import BatchOptimizer as TBO
from gpry_tpu_torch.acquisition.batch_optimizer import \
    _acq_values_gated as t_gated
from gpry_tpu_torch.acquisition.batch_optimizer import \
    _optimize_restarts as t_optimize
from gpry_tpu_torch.models.gp import GaussianProcessRegressor as TGPR
from gpry_tpu_torch.models.gp import surrogate_predict as t_predict
from gpry_tpu_torch.models.preprocessing import Normalize_bounds as TNB
from gpry_tpu_torch.models.preprocessing import Normalize_y as TNY

config.set_device("cpu")
# tiny shapes: one intra-op thread, so that parallel test workers do
# not oversubscribe the cores
torch.set_num_threads(1)
D = 2
BOUNDS = np.array([[-3.0, 4.0], [-2.0, 2.0]])


def T(a):
    return torch.as_tensor(np.asarray(a, dtype=float), dtype=torch.float64)


def truth(X):
    X = np.atleast_2d(X)
    return -0.5 * np.sum((X - [0.5, -0.3]) ** 2 / [1.5, 0.4], axis=1)


def pair(n=24, seed=2, theta=(0.5, -1.2, -1.0)):
    """A JAX GPR factorized at a moderate, well-conditioned ``theta`` (so
    parity is limited by rounding, not by cancellation in K^-1 y) and a port
    GPR carrying exactly its state."""
    X = np.random.default_rng(seed).uniform(BOUNDS[:, 0], BOUNDS[:, 1],
                                            (n, D))
    y = truth(X)
    j = JGPR(bounds=BOUNDS, preprocessing_X=JNB(BOUNDS),
             preprocessing_y=JNY(), n_restarts_optimizer=4, random_state=3)
    j.append_to_data(X, y, fit_gpr=False)
    j._theta = np.asarray(theta, dtype=float)
    j._update_model()
    j._fitted = True
    t = TGPR(bounds=BOUNDS, preprocessing_X=TNB(BOUNDS),
             preprocessing_y=TNY(), n_restarts_optimizer=4, random_state=3)
    svm = {k: v for k, v in vars(j.infinities_classifier).items()
           if k != "backend"}
    t.load_numpy_state(j.kernel_theta, j.X_train_all, j.y_train_all,
                       j.preprocessing_X.loc, j.preprocessing_X.scale,
                       j.preprocessing_y.mean_, j.preprocessing_y.std_,
                       svm=svm)
    return j, t


@pytest.mark.parametrize("name", ["LogExp", "NonlinearLogExp", "Std",
                                  "ExpectedImprovement", "ConstantAcqFunc"])
def test_acquisition_values(name):
    rng = np.random.default_rng(0)
    mu = rng.normal(-3, 2, 50)
    std = np.abs(rng.normal(0, 1, 50))
    mu[:5] = -np.inf
    std[5:8] = 0.005
    kw = {"dimension": 3} if "LogExp" in name else {}
    fj, ft = getattr(jf, name)(**kw), getattr(tf, name)(**kw)
    vj = np.asarray(fj.values(jnp.asarray(mu), jnp.asarray(std), 0.5, 0.01))
    vt = ft.values(T(mu), T(std), 0.5, 0.01).numpy()
    np.testing.assert_array_equal(np.isinf(vt), np.isinf(vj))
    fin = np.isfinite(vj)
    np.testing.assert_allclose(vt[fin], vj[fin], rtol=1e-12, atol=1e-14)


def test_append_lie_and_grow():
    j, t = pair()
    p_j, p_t = j.surrogate_params(), t.surrogate_params()
    x, lie = np.array([[0.2, 0.1]]), np.array([-0.7])
    p_j2 = j_append_lie(j.family, p_j, jnp.asarray(x), jnp.asarray(lie))
    p_t2 = t_append_lie(t.family, p_t, T(x), T(lie))
    assert p_t2.n == int(p_j2.n) == p_t.n + 1
    np.testing.assert_allclose(p_t2.L.numpy(), np.asarray(p_j2.L),
                               rtol=1e-10, atol=1e-12)
    np.testing.assert_allclose(p_t2.alpha.numpy(), np.asarray(p_j2.alpha),
                               rtol=1e-9, atol=1e-9)
    # a full bucket grows with identity padding
    g = grow_surrogate(p_t, 128)
    assert g.X.shape[0] == 128
    np.testing.assert_array_equal(g.L[64:, 64:].numpy(), np.eye(64))
    Xq = np.random.default_rng(1).uniform(-3, 4, (20, D))
    np.testing.assert_allclose(t_predict(t.family, g, T(Xq))[0].numpy(),
                               t_predict(t.family, p_t, T(Xq))[0].numpy(),
                               rtol=1e-12)


def test_logexp_ascent_optimum_matches_jax():
    """Multistart L-BFGS on the LogExp objective: the best optimum's value
    agrees with the JAX package's."""
    j, t = pair()
    p_j, p_t = j.surrogate_params(), t.surrogate_params()
    x0s = np.random.default_rng(4).uniform(BOUNDS[:, 0], BOUNDS[:, 1],
                                           (8, D))
    zeta, noise = D ** -0.85, 0.01
    xs_j, v_j = j_optimize(j.family, p_j, zeta, noise, jnp.asarray(x0s),
                           jnp.asarray(BOUNDS[:, 0]),
                           jnp.asarray(BOUNDS[:, 1]))
    xs_t, v_t = t_optimize(t.family, p_t, zeta, noise, T(x0s),
                           T(BOUNDS[:, 0]), T(BOUNDS[:, 1]))
    assert abs(np.nanmax(v_t.numpy()) - np.nanmax(np.asarray(v_j))) < 1e-6


def test_multi_add_matches_jax():
    j, t = pair()
    out_j = JBO(BOUNDS).multi_add(j, n_points=3,
                                  rng=np.random.default_rng(5))
    out_t = TBO(BOUNDS).multi_add(t, n_points=3,
                                  rng=np.random.default_rng(5))
    np.testing.assert_allclose(out_t[0], out_j[0], atol=1e-5)
    np.testing.assert_allclose(out_t[1], out_j[1], atol=1e-6)
    np.testing.assert_allclose(out_t[2], out_j[2], atol=1e-6)
    # in bounds, distinct, with finite values
    assert np.all((out_t[0] >= BOUNDS[:, 0]) & (out_t[0] <= BOUNDS[:, 1]))
    assert len(np.unique(out_t[0].round(8), axis=0)) == 3
    assert np.all(np.isfinite(out_t[2]))


def test_multi_add_generic_acquisition():
    """A non-LogExp acquisition takes the generic (unfused) path."""
    j, t = pair()
    X, lies, vals = TBO(BOUNDS, acq_func="Std").multi_add(
        t, n_points=2, rng=np.random.default_rng(6))
    assert X.shape == (2, D) and np.all(np.isfinite(vals))
    mj, sj = j_predict(j.family, j.surrogate_params(), jnp.asarray(X[:1]))
    np.testing.assert_allclose(lies[0], float(mj[0]), rtol=1e-9)


# ---------------------------------------------------------------------------
# The gradient-free polish: acq_optimizer="sampling" (scipy's Powell) and a
# user callable (tests/test_round3.py:483, 501)
# ---------------------------------------------------------------------------


def _small_fitted(n, scale, seed):
    rng = np.random.default_rng(seed)
    bounds = np.array([[-1.0, 1.0]] * 2)
    gpr = TGPR(bounds=bounds, random_state=rng)
    X = rng.uniform(-1, 1, size=(n, 2))
    gpr.append_to_data(X, -scale * np.sum(X**2, axis=1),
                       fit_gpr={"n_restarts": 2})
    return gpr, bounds, rng


def test_batch_optimizer_sampling_powell():
    """tests/test_round3.py:483; each objective call is one gated value at
    one point (K2's plain version here), counted in obj_fun_eval_num, and
    each polished value is the gated value at its polished point (Powell
    returns a point it evaluated)."""
    from gpry_tpu_torch.acquisition import batch_optimizer as tbo
    gpr, bounds, rng = _small_fitted(14, 8.0, 42)
    acq = TBO(bounds, acq_optimizer="sampling", n_restarts_optimizer=4,
              verbose=0)
    calls, polished = [], []
    inner = tbo._acq_values_gated
    polish = acq._polish_gradient_free

    def counted(family, p, zeta, noise, X):
        calls.append(X.shape[0])
        return inner(family, p, zeta, noise, X)

    def watched(score, p, x0s, bounds_, as_t):
        xs, vals = polish(score, p, x0s, bounds_, as_t)
        n = len(calls)
        polished.append((vals, np.concatenate(
            [score(p, as_t(x[None])).numpy() for x in xs])))
        del calls[n:]
        return xs, vals

    tbo._acq_values_gated = counted
    acq._polish_gradient_free = watched
    try:
        X_out, y_lies, acq_vals = acq.multi_add(gpr, n_points=2, rng=rng)
    finally:
        tbo._acq_values_gated = inner
    assert X_out.shape == (2, 2)
    assert np.all(np.isfinite(acq_vals))
    assert np.all((X_out >= -1) & (X_out <= 1))
    n_screen = min(10 * 2 * 4, 4000)
    ones = [c for c in calls if c == 1]
    assert len(ones) > 0
    assert acq.obj_fun_eval_num == 2 * n_screen + len(ones)
    for vals, at_points in polished:
        np.testing.assert_allclose(vals, at_points, rtol=1e-12)


def _polish_twins(optimizer, n_starts=4, seed=6):
    """The reference's and the port's ``_polish_gradient_free`` on one
    surrogate (``pair``), the same LogExp and the same starts."""
    j, t = pair()
    zeta, noise = D ** -0.85, 0.01
    x0s = np.random.default_rng(seed).uniform(BOUNDS[:, 0], BOUNDS[:, 1],
                                              (n_starts, D))
    bo_j = JBO(BOUNDS, acq_optimizer=optimizer, verbose=0)
    bo_t = TBO(BOUNDS, acq_optimizer=optimizer, verbose=0)
    p_j, p_t = j.sweep_params(), t.surrogate_params()
    out_j = bo_j._polish_gradient_free(
        lambda p_, X_: j_gated(j.family, p_, zeta, noise, X_), p_j, x0s,
        BOUNDS, p_j.X.dtype)
    out_t = bo_t._polish_gradient_free(
        lambda p_, X_: t_gated(t.family, p_, zeta, noise, X_), p_t, x0s,
        BOUNDS, T)
    return out_j, out_t, bo_j.obj_fun_eval_num, bo_t.obj_fun_eval_num


def test_polish_gradient_free_matches_jax():
    """Powell's polish: the reference's points and values on the same
    surrogate and starts, to Powell's own tolerances (xtol = ftol = 1e-4:
    the two surfaces differ by rounding, so its line searches stop a few
    calls apart, at points 1e-6 apart on a flat top)."""
    for seed in (6, 2):
        (xs_j, v_j), (xs_t, v_t), n_j, n_t = _polish_twins("sampling",
                                                           seed=seed)
        assert n_t > 4 and n_j > 4
        np.testing.assert_allclose(xs_t, xs_j, rtol=0, atol=1e-4)
        np.testing.assert_allclose(v_t, v_j, rtol=1e-6)


def test_polish_returns_the_callables_answer():
    """A user callable's own (x_opt, f_opt) is what the polish returns,
    also where x_opt is a point it never evaluated, as in the reference."""
    evaluated = []

    def shrink(obj, x0, bounds=None):
        f = [obj(x0), obj(0.5 * x0)]
        evaluated.extend([x0, 0.5 * x0])
        return 0.25 * x0, min(f)

    (xs_j, v_j), (xs_t, v_t), n_j, n_t = _polish_twins(shrink)
    assert n_t == n_j == 8
    x0s = np.asarray(evaluated[::2][:4])
    np.testing.assert_array_equal(xs_t, 0.25 * x0s)
    np.testing.assert_array_equal(xs_t, xs_j)
    np.testing.assert_allclose(v_t, v_j, rtol=1e-9)


def test_batch_optimizer_callable_optimizer():
    """tests/test_round3.py:501: a user callable ``(fun, x0, bounds) ->
    (x, fun(x))``."""
    gpr, bounds, rng = _small_fitted(10, 5.0, 42)
    seen = []

    def my_opt(obj, x0, bounds=None):
        seen.append(bounds)
        return x0, obj(x0)

    acq = TBO(bounds, acq_optimizer=my_opt, n_restarts_optimizer=4,
              verbose=0)
    X_out, _, acq_vals = acq.multi_add(gpr, n_points=1, rng=rng)
    assert X_out.shape == (1, 2)
    assert np.all(np.isfinite(acq_vals))
    assert seen and np.array_equal(seen[0], bounds)
    with pytest.raises(ValueError, match="acq_optimizer"):
        TBO(bounds, acq_optimizer="annealing")
