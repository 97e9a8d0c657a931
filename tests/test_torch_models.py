"""
Parity of gpry_tpu_torch's models (the SVM classifier, the surrogate
snapshot, the gated K1/K2 plain versions, the GPR fit) with gpry_tpu's on
the CPU in float64.  A fitted JAX GPR is carried across with
``surrogate_from_numpy`` / ``GaussianProcessRegressor.load_numpy_state``.
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from gpry_tpu.acquisition.batch_optimizer import \
    _acq_values_gated as j_acq_values_gated
from gpry_tpu.models.classifier import SVM as JSVM
from gpry_tpu.models.classifier import svm_decision as j_svm_decision
from gpry_tpu.models.gp import GaussianProcessRegressor as JGPR
from gpry_tpu.models.gp import _lml_batch as j_lml_batch
from gpry_tpu.models.gp import surrogate_predict as j_predict
from gpry_tpu.models.gp import surrogate_predict_mean as j_predict_mean
from gpry_tpu.models.preprocessing import Normalize_bounds as JNB
from gpry_tpu.models.preprocessing import Normalize_y as JNY

from gpry_tpu_torch import config
from gpry_tpu_torch.models import classifier as tc
from gpry_tpu_torch.models.gp import GaussianProcessRegressor as TGPR
from gpry_tpu_torch.models.gp import _lml_batch as t_lml_batch
from gpry_tpu_torch.models.gp import surrogate_from_numpy
from gpry_tpu_torch.models.preprocessing import Normalize_bounds as TNB
from gpry_tpu_torch.models.preprocessing import Normalize_y as TNY
from gpry_tpu_torch.ops import fused

config.set_device("cpu")
# tiny shapes: one intra-op thread, so that parallel test workers do
# not oversubscribe the cores
torch.set_num_threads(1)
D = 2
BOUNDS = np.array([[-5.0, 5.0]] * D)


def T(a):
    return torch.as_tensor(np.asarray(a, dtype=float), dtype=torch.float64)


def truth(X):
    X = np.atleast_2d(X)
    y = -0.5 * np.sum((X - [0.5, -0.3]) ** 2 / [1.2, 0.6], axis=1)
    y[np.linalg.norm(X, axis=1) > 4.0] = -np.inf
    return y


def training(seed=3, n=40):
    X = np.random.default_rng(seed).uniform(-5, 5, (n, D))
    return X, truth(X)


def jax_gpr(seed=3, n=40, **kw):
    """A JAX GPR with an active classifier and trust region, factorized at
    its initial (prior-mean) hyperparameters: a well-conditioned kernel, so
    that parity is limited by rounding, not by cancellation in K^-1 y."""
    X, y = training(seed, n)
    kw.setdefault("trust_region_factor", 1.5)
    gpr = JGPR(bounds=BOUNDS, preprocessing_X=JNB(BOUNDS),
               preprocessing_y=JNY(), n_restarts_optimizer=8,
               random_state=7, **kw)
    gpr.append_to_data(X, y, fit_gpr=False)
    gpr._fitted = True
    return gpr


def ported(p):
    d = {k: (v if k == "svm" else np.asarray(v))
         for k, v in p._asdict().items()}
    d["svm"] = {k: np.asarray(v) for k, v in p.svm._asdict().items()}
    return surrogate_from_numpy(d, device="cpu")


def carried_gpr(j, **kw):
    """A port GPR holding exactly the JAX GPR's fitted state."""
    t = TGPR(bounds=BOUNDS, preprocessing_X=TNB(BOUNDS),
             preprocessing_y=TNY(), n_restarts_optimizer=8, random_state=7,
             trust_region_factor=j.trust_region_factor, **kw)
    svm = None
    if j.infinities_classifier is not None:
        svm = {k: v for k, v in vars(j.infinities_classifier).items()
               if k != "backend"}
    x_loc, x_scale = j.preprocessing_X.loc, j.preprocessing_X.scale
    t.load_numpy_state(j.kernel_theta, j.X_train_all, j.y_train_all, x_loc,
                       x_scale, j.preprocessing_y.mean_,
                       j.preprocessing_y.std_, svm=svm)
    return t


def queries(seed=4, n=400):
    # beyond the prior box: trust box and SVM both gate
    return np.random.default_rng(seed).uniform(-6, 6, (n, D))


def test_svm_fit_and_decision_match():
    X, y = training()
    Xn = (X + 5) / 10
    yn = np.where(np.isfinite(y), y, -np.inf)
    js, ts = JSVM(), tc.SVM()
    fj = js.fit(Xn, yn, 3.0)
    ft = ts.fit(Xn, yn, 3.0)
    np.testing.assert_array_equal(fj, ft)
    np.testing.assert_array_equal(js._sv, ts._sv)
    np.testing.assert_array_equal(js._dual, ts._dual)
    pj = js.device_params()
    pt = ts.device_params(device="cpu")
    assert pt.mode == int(pj.mode) == tc.MODE_FITTED
    Xq = np.random.default_rng(1).uniform(-0.2, 1.2, (300, D))
    np.testing.assert_array_equal(
        tc.svm_decision(pt, T(Xq)).numpy(),
        np.asarray(j_svm_decision(pj, jnp.asarray(Xq))))


@pytest.mark.parametrize("mode", [tc.MODE_ALL_FINITE, tc.MODE_NONE_FINITE])
def test_svm_trivial_modes(mode):
    p = tc.trivial_svm_params(D, device="cpu", mode=mode)
    out = tc.svm_decision(p, T(np.zeros((5, D))))
    assert out.dtype == torch.bool
    assert bool(out.all()) == (mode == tc.MODE_ALL_FINITE)


def test_gated_mean_plain_matches_surrogate_predict_mean():
    j = jax_gpr()
    p_j = j.surrogate_params()
    assert int(p_j.svm.mode) == tc.MODE_FITTED
    assert np.all(np.isfinite(np.asarray(p_j.trust_lo)))
    Xq = queries()
    # lower the clip so that it binds on some of the queries
    m0 = np.asarray(j_predict_mean(j.family, p_j, jnp.asarray(Xq)))
    p_j = p_j._replace(clip_max=jnp.asarray(
        np.median(m0[np.isfinite(m0)])))
    p_t = ported(p_j)
    m_j = np.asarray(j_predict_mean(j.family, p_j, jnp.asarray(Xq)))
    m_t = fused.gated_mean(j.family, p_t, T(Xq)).numpy()
    np.testing.assert_array_equal(np.isinf(m_t), np.isinf(m_j))
    fin = np.isfinite(m_j)
    assert 0 < fin.sum() < len(Xq)
    assert np.any(m_j[fin] == float(p_j.clip_max)), "clip never binds"
    np.testing.assert_allclose(m_t[fin], m_j[fin], rtol=1e-10)


def test_gated_meanvar_plain_matches_predict_and_acq():
    j = jax_gpr()
    p_j = j.surrogate_params()
    p_j = p_j._replace(clip_max=p_j.y_max)
    p_t = ported(p_j)
    Xq = queries(5)
    mj, sj = map(np.asarray, j_predict(j.family, p_j, jnp.asarray(Xq)))
    mt, st = (a.numpy() for a in fused.gated_meanvar_logexp(
        j.family, p_t, T(Xq)))
    np.testing.assert_array_equal(np.isinf(mt), np.isinf(mj))
    fin = np.isfinite(mj)
    np.testing.assert_allclose(mt[fin], mj[fin], rtol=1e-9)
    np.testing.assert_allclose(st, sj, rtol=1e-9, atol=1e-12)
    zeta, noise = D ** -0.85, 0.01
    aj = np.asarray(j_acq_values_gated(j.family, p_j, zeta, noise,
                                       jnp.asarray(Xq)))
    at = fused.gated_meanvar_logexp(j.family, p_t, T(Xq),
                                    logexp=(zeta, noise)).numpy()
    np.testing.assert_array_equal(np.isinf(at), np.isinf(aj))
    fin = np.isfinite(aj)
    assert fin.sum() > 0
    np.testing.assert_allclose(at[fin], aj[fin], rtol=1e-9, atol=1e-12)


def test_load_numpy_state_predicts_like_jax():
    j = jax_gpr()
    t = carried_gpr(j)
    assert t.n == j.n and t.n_total == j.n_total
    Xq = queries(6)
    mj, sj = j.predict(Xq, return_std=True, validate=False)
    mt, st = t.predict(Xq, return_std=True, validate=False)
    np.testing.assert_array_equal(np.isinf(mt), np.isinf(mj))
    fin = np.isfinite(mj)
    np.testing.assert_allclose(mt[fin], mj[fin], rtol=1e-9)
    np.testing.assert_allclose(st, sj, rtol=1e-9, atol=1e-12)
    # gradients of the smooth surrogate (autograd vs JAX jacfwd)
    Xin = np.random.default_rng(2).uniform(-2, 2, (10, D))
    gj = j.predict(Xin, return_mean_grad=True, return_std_grad=True)
    gt = t.predict(Xin, return_mean_grad=True, return_std_grad=True)
    for a, b in zip(gt[1:], gj[1:]):
        np.testing.assert_allclose(a, b, rtol=1e-8, atol=1e-10)


def test_lml_batch_matches():
    j = jax_gpr()
    t = carried_gpr(j)
    rng = np.random.default_rng(9)
    thetas = j.kernel_theta + rng.uniform(-1, 1, (8, D + 1))
    lj = np.asarray(j_lml_batch(j.family, j._dX, j._dy, j.n, j._noise_var_,
                                jnp.asarray(thetas)))
    lt = t_lml_batch(t.family, t._dX, t._dy, t.n, t._noise_t(),
                     T(thetas)).numpy()
    np.testing.assert_allclose(lt, lj, rtol=1e-9)


@pytest.mark.parametrize("kernel", ["RBF", "Matern"])
def test_fit_finds_the_jax_optimum(kernel):
    """Same data and seed: both fits screen the same numpy candidates, so
    the best LML found must agree."""
    X, y = training(11, 30)
    y = np.where(np.isfinite(y), y, -30.0)
    kw = dict(bounds=BOUNDS, kernel=kernel, n_restarts_optimizer=8,
              random_state=5, account_for_inf=None)
    j = JGPR(preprocessing_X=JNB(BOUNDS), preprocessing_y=JNY(), **kw)
    t = TGPR(preprocessing_X=TNB(BOUNDS), preprocessing_y=TNY(), **kw)
    j.append_to_data(X, y, fit_gpr=True)
    t.append_to_data(X, y, fit_gpr=True)
    assert abs(t.log_marginal_likelihood_value_
               - j.log_marginal_likelihood_value_) < 1e-6
    assert abs(t.log_marginal_likelihood() - t.log_marginal_likelihood_value_
               ) < 1e-8
    # a simple refit after a lie append keeps the model coherent
    t.append_to_data(X[:2] * 0.5, y[:2], fit_gpr="simple")
    assert t.fitted and t.n == 32


def test_append_without_fit_uses_block_append():
    """fit_gpr=False appends through chol_append; the result equals a full
    refactorization at the same theta."""
    j = jax_gpr(account_for_inf=None)
    t = carried_gpr(j, account_for_inf=None)
    Xn = np.array([[0.3, 0.1], [-0.4, 0.2]])
    yn = t.predict(Xn)
    t.append_to_data(Xn, yn, fit_gpr=False, fit_classifier=False)
    L_inc = t._dL.clone()
    t._update_model()
    np.testing.assert_allclose(L_inc.numpy(), t._dL.numpy(), rtol=1e-9,
                               atol=1e-12)


def test_surrogate_params_scal_follows_replace():
    j = jax_gpr()
    p = ported(j.surrogate_params())
    q = p.replace(y_max=T(3.5))
    assert float(q.scal[5]) == 3.5 and float(p.scal[5]) != 3.5


def test_remove_from_data_and_api_conveniences():
    """tests/test_gp.py:251: remove_from_data, predict_is_finite,
    training_set_as_df, compute_threshold_given_sigma and
    set_random_state."""
    pytest.importorskip("pandas")
    rng = np.random.default_rng(42)
    bounds = np.array([[0.0, 1.0]] * 2)
    X = rng.uniform(size=(20, 2))
    y = -0.5 * np.sum(((X - 0.5) / 0.2) ** 2, axis=1)
    y[0] = -np.inf
    gpr = TGPR(bounds=bounds, preprocessing_X=TNB(bounds),
               preprocessing_y=TNY(), n_restarts_optimizer=4,
               random_state=1)
    gpr.append_to_data(X, y)
    df = gpr.training_set_as_df
    assert len(df) == 20 and "is_finite" in df
    assert gpr.predict_is_finite(X[1:4]).shape == (3,)
    assert np.isclose(gpr.compute_threshold_given_sigma(20, 2),
                      gpr._diff_threshold)
    assert TGPR.compute_threshold_given_sigma(3, 4) == \
        JGPR.compute_threshold_given_sigma(3, 4)

    n_before = gpr.n_total
    gpr.remove_from_data([0, 5], fit=False)
    assert gpr.n_total == n_before - 2
    assert not np.isin(-np.inf, gpr.y_train_all)
    np.testing.assert_allclose(gpr.predict(X[1:3]), y[1:3], atol=0.5)
    gpr.remove_from_data([0], fit=True)
    assert gpr.n_total == n_before - 3
    gpr.set_random_state(123)
    assert isinstance(gpr._rng, np.random.Generator)
    with pytest.raises(ValueError, match="Invalid positions"):
        gpr.remove_from_data([gpr.n_total])


def test_remove_from_data_matches_jax():
    """remove_from_data(fit=False) on a GPR carried from the reference's:
    the same kept training set, factor, alpha and predictions as the
    reference's own remove_from_data."""
    j = jax_gpr()
    t = carried_gpr(j)
    j.remove_from_data([0, 5, 17], fit=False)
    t.remove_from_data([0, 5, 17], fit=False)
    np.testing.assert_array_equal(t.X_train_all, j.X_train_all)
    np.testing.assert_array_equal(t.y_train_all, j.y_train_all)
    np.testing.assert_array_equal(t.X_train, j.X_train)
    np.testing.assert_array_equal(t.y_train, j.y_train)
    assert t.n == j.n
    n = t.n
    np.testing.assert_allclose(t._dL.numpy()[:n, :n],
                               np.asarray(j._dL)[:n, :n], rtol=1e-12,
                               atol=1e-14)
    np.testing.assert_allclose(t._dalpha.numpy()[:n],
                               np.asarray(j._dalpha)[:n], rtol=1e-10,
                               atol=1e-12)
    Xq = queries()
    mj, sj = j.predict(Xq, return_std=True)
    mt, st = t.predict(Xq, return_std=True)
    np.testing.assert_array_equal(np.isfinite(mt), np.isfinite(mj))
    fin = np.isfinite(mj)
    np.testing.assert_allclose(mt[fin], mj[fin], rtol=1e-10, atol=1e-12)
    np.testing.assert_allclose(st, sj, rtol=1e-10, atol=1e-12)


def test_remove_from_data_equals_a_fresh_append():
    """After ``remove_from_data(fit=False)`` the factor and alpha are a
    fresh ``append_to_data`` of the kept points at the same theta."""
    X, y = training(5, 24)
    gpr = TGPR(bounds=BOUNDS, preprocessing_X=TNB(BOUNDS),
               preprocessing_y=TNY(), n_restarts_optimizer=2,
               random_state=7)
    gpr.append_to_data(X, y, fit_gpr=False)
    theta = np.copy(gpr._theta)
    gpr.remove_from_data([1, 7, 19], fit=False)
    keep = np.setdiff1d(np.arange(len(y)), [1, 7, 19])
    fresh = TGPR(bounds=BOUNDS, preprocessing_X=TNB(BOUNDS),
                 preprocessing_y=TNY(), n_restarts_optimizer=2,
                 random_state=7)
    fresh._theta = theta
    fresh.append_to_data(X[keep], y[keep], fit_gpr=False)
    assert gpr.n == fresh.n
    np.testing.assert_allclose(gpr._dL.numpy(), fresh._dL.numpy(),
                               rtol=1e-12, atol=1e-14)
    np.testing.assert_allclose(gpr._dalpha.numpy(), fresh._dalpha.numpy(),
                               rtol=1e-12, atol=1e-14)


def test_deepcopy_predicts_the_same():
    """A deep copy of a fitted GPR predicts what the GPR predicts."""
    import copy
    X, y = training(6, 20)
    gpr = TGPR(bounds=BOUNDS, preprocessing_X=TNB(BOUNDS),
               preprocessing_y=TNY(), n_restarts_optimizer=2,
               random_state=7)
    gpr.append_to_data(X, y, fit_gpr=False)
    Xq = queries(8, 50)
    np.testing.assert_array_equal(copy.deepcopy(gpr).predict(Xq),
                                  gpr.predict(Xq))
