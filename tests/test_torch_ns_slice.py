"""
K6's plain version (``ops.fused.ns_slice_chains_plain``, the lock-step
slice chains on the gated surrogate) against gpry_tpu's vmapped
``mc/nested.py:51 _slice_chain`` on the CPU in float64.  The draws are made
with ``jax.random`` exactly as ``_slice_chain`` splits its keys and handed
to the port, so the two run the same chains: identical calls per chain,
x and logl within rel 1e-12.  The surrogate is a JAX GPR's snapshot
carried over with ``surrogate_from_numpy``.
"""

from functools import partial

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from gpry_tpu.mc.nested import _slice_chain
from gpry_tpu.models.gp import GaussianProcessRegressor as JGPR
from gpry_tpu.models.gp import surrogate_predict_mean as j_predict_mean
from gpry_tpu.models.preprocessing import Normalize_bounds as JNB
from gpry_tpu.models.preprocessing import Normalize_y as JNY

from gpry_tpu_torch import config
from gpry_tpu_torch.mc import samples
from gpry_tpu_torch.mc.nested import run_nested_device
from gpry_tpu_torch.models.classifier import MODE_ALL_FINITE, MODE_FITTED
from gpry_tpu_torch.models.gp import surrogate_from_numpy, \
    surrogate_predict_mean
from gpry_tpu_torch.ops import fused

config.set_device("cpu")
torch.set_num_threads(1)
D, N, B, R = 2, 32, 8, 4
BOUNDS = np.array([[-4.0, 4.0]] * D)
REL = 1e-12


def T(a):
    return torch.tensor(np.asarray(a, dtype=float), dtype=torch.float64)


def jax_surrogate(family, with_inf):
    """A JAX GPR snapshot at its initial (well-conditioned) hyperparameters:
    with_inf gives the SVM -inf outside a disc (fitted mode), else every
    value is finite (all-finite mode); a trust box inside the prior."""
    X = np.random.default_rng(5).uniform(-4, 4, (N, D))
    y = -0.5 * np.sum((X - [0.5, -0.3]) ** 2 / [1.2, 0.6], axis=1)
    if with_inf:
        y[np.linalg.norm(X, axis=1) > 3.3] = -np.inf
    gpr = JGPR(kernel=family, bounds=BOUNDS, preprocessing_X=JNB(BOUNDS),
               preprocessing_y=JNY(), trust_region_factor=1.5,
               random_state=7)
    gpr.append_to_data(X, y, fit_gpr=False)
    gpr._fitted = True
    p = gpr.surrogate_params()
    assert int(p.svm.mode) == (MODE_FITTED if with_inf else MODE_ALL_FINITE)
    return gpr.family, p


def ported(p):
    d = {k: (v if k == "svm" else np.asarray(v))
         for k, v in p._asdict().items()}
    d["svm"] = {k: np.asarray(v) for k, v in p.svm._asdict().items()}
    return surrogate_from_numpy(d, device="cpu")


def jax_draws(keys, d):
    """Every random number ``_slice_chain`` draws from its chain key:
    per repeat ``split(key_r, 3)``, ``normal(k1, (d,))``, ``uniform(k2)``,
    then ``key, kk = split(key)`` and ``uniform(kk)`` per shrink.  Returns
    nrm (R, B, d) and u (R, 31, B) as numpy."""
    f64 = jnp.float64

    def one_repeat(key_r):
        k1, k2, k3 = jax.random.split(key_r, 3)
        nrm = jax.random.normal(k1, (d,), f64)
        u0 = jax.random.uniform(k2, dtype=f64)

        def shrink(key, _):
            key, kk = jax.random.split(key)
            return key, jax.random.uniform(kk, dtype=f64)

        _, us = jax.lax.scan(shrink, k3, None, length=fused.NS_SHRINKS)
        return nrm, jnp.concatenate([u0[None], us])

    nrm, u = jax.vmap(lambda k: jax.vmap(one_repeat)(
        jax.random.split(k, R)))(keys)
    return (np.asarray(nrm).transpose(1, 0, 2),
            np.asarray(u).transpose(1, 2, 0))


def chain_inputs(family, p_j, box=BOUNDS, chol_scale=1.0):
    """B starts above lstar (the 60th percentile of a prior sample) and the
    survivors' covariance factor, as an NS step sets them up."""
    rng = np.random.default_rng(11)
    pool = rng.uniform(box[:, 0], box[:, 1], (400, D))
    lp = np.asarray(j_predict_mean(family, p_j, jnp.asarray(pool)))
    lstar = float(np.quantile(lp[np.isfinite(lp)], 0.6))
    above = pool[lp > lstar]
    chol = np.linalg.cholesky(np.cov(above.T)) * chol_scale
    return above[:B], lp[lp > lstar][:B], lstar, chol


def run_both(family, p_j, x0, l0, lstar, chol, box=BOUNDS, seed=3):
    keys = jax.random.split(jax.random.PRNGKey(seed), B)
    lo, hi = jnp.asarray(box[:, 0]), jnp.asarray(box[:, 1])
    chain = partial(_slice_chain, partial(j_predict_mean, family), p_j)
    xj, lj, cj = jax.vmap(
        lambda k, x, l: chain(k, x, l, lstar, jnp.asarray(chol), R, lo, hi)
    )(keys, jnp.asarray(x0), jnp.asarray(l0))
    nrm, u = jax_draws(keys, D)
    xt, lt, ct = fused.ns_slice_chains_plain(
        family, ported(p_j), T(x0), T(l0), T(lstar), T(chol), T(nrm), T(u),
        T(box[:, 0]), T(box[:, 1]))
    return (np.asarray(xj), np.asarray(lj), np.asarray(cj)), \
        (xt.numpy(), lt.numpy(), ct.numpy())


def assert_same(j, t):
    (xj, lj, cj), (xt, lt, ct) = j, t
    np.testing.assert_array_equal(ct, cj)
    np.testing.assert_array_equal(np.isfinite(lt), np.isfinite(lj))
    fin = np.isfinite(lj)
    assert np.max(np.abs(lt[fin] - lj[fin])) <= REL * np.max(np.abs(lj[fin]))
    assert np.max(np.abs(xt - xj)) <= REL * np.max(np.abs(xj))


@pytest.mark.parametrize("with_inf", [True, False],
                         ids=["svm-fitted", "all-finite"])
@pytest.mark.parametrize("family", ["rbf", "matern52", pytest.param(
    {"Sum": [{"Product": [{"ConstantKernel": {}}, {"RBF": {}}]},
             {"WhiteKernel": {"noise_level": 1e-4}}]}, id="spec")])
def test_plain_chains_match_jax(family, with_inf):
    family, p_j = jax_surrogate(family, with_inf)
    x0, l0, lstar, chol = chain_inputs(family, p_j)
    j, t = run_both(family, p_j, x0, l0, lstar, chol)
    assert_same(j, t)
    # the chains moved, and stayed above lstar
    assert np.all(t[1] > lstar) and np.any(t[0] != x0)
    assert np.all(t[2] >= 2 * R + R)


def test_plain_chains_leave_the_box_like_jax():
    """Directions three prior widths long: every first step-out end lies
    outside the prior box (-inf there), so the chains shrink back in."""
    family, p_j = jax_surrogate("rbf", True)
    box = np.array([[-1.5, 1.5], [-1.5, 1.5]])
    x0, l0, lstar, _ = chain_inputs(family, p_j, box=box)
    chol = np.diag(3.0 * (box[:, 1] - box[:, 0]))
    j, t = run_both(family, p_j, x0, l0, lstar, chol, box=box)
    assert_same(j, t)
    assert np.all((t[0] >= box[:, 0]) & (t[0] <= box[:, 1]))
    # no doubling: both first ends are outside, hence not above lstar
    assert np.all(t[2] <= R * (2 + fused.NS_SHRINKS))


def test_plain_chains_spend_every_shrink_like_jax():
    """lstar at the surrogate's upper clip: no value is strictly above it,
    so every update spends its 30 shrinks and keeps its start."""
    family, p_j = jax_surrogate("matern52", True)
    x0, l0, _, chol = chain_inputs(family, p_j)
    lstar = float(p_j.clip_max)
    j, t = run_both(family, p_j, x0, l0, lstar, chol)
    assert_same(j, t)
    np.testing.assert_array_equal(t[2], R * (2 + fused.NS_SHRINKS))
    np.testing.assert_array_equal(t[0], x0)


@pytest.mark.parametrize("family", ["rbf", "matern32"])
def test_nested_surrogate_route_is_k6(family, monkeypatch):
    """run_nested_device on the gated surrogate takes K6's route (on the
    CPU its plain version), once per outer step, and gives bit-identical
    results to the lock-step loop that any other log-density runs."""
    _, p_j = jax_surrogate(family, True)
    p = ported(p_j)
    routed = []

    def k6(*args):
        routed.append(args[3].shape[0])
        return fused.ns_slice_chains(*args)

    monkeypatch.setattr(samples, "ns_slice_chains", k6)
    lo, hi = T(BOUNDS[:, 0]), T(BOUNDS[:, 1])

    def run(logl_fn):
        return run_nested_device(logl_fn, p, torch.Generator().manual_seed(4),
                                 lo, hi, nlive=48, num_repeats=3,
                                 max_dead=400, n_prior=96)

    res_k6 = run(samples.surrogate_logp_fn(family))
    res_plain = run(lambda params, X: surrogate_predict_mean(family, params,
                                                             X))
    assert len(routed) == res_k6.n_steps > 0 and set(routed) == {8}
    assert torch.equal(res_k6.X, res_plain.X)
    assert torch.equal(res_k6.logl, res_plain.logl)
    assert res_k6.n_calls == res_plain.n_calls
