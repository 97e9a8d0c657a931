"""
gpry_tpu_torch's device nested sampler, IS refinement and MC sampling on
the CPU.  Random draws come from torch Generators, so runs are compared with
the analytic truth and with the JAX package by distribution, not by index.
"""

import sys

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from gpry_tpu.mc.mcmc import split_rhat as j_split_rhat
from gpry_tpu.mc.nested import run_nested_device as j_run_nested
from gpry_tpu.mc.samples import mc_sample_from_gp as j_mc_sample
from gpry_tpu.models.gp import GaussianProcessRegressor as JGPR
from gpry_tpu.models.preprocessing import Normalize_bounds as JNB
from gpry_tpu.models.preprocessing import Normalize_y as JNY

from gpry_tpu_torch import config
from gpry_tpu_torch.mc.mcmc import run_mcmc_device, split_rhat
from gpry_tpu_torch.mc.nested import run_nested_device
from gpry_tpu_torch.mc.refine import ess
from gpry_tpu_torch.mc.samples import mc_sample_from_gp, write_samples_txt
from gpry_tpu_torch.models.gp import GaussianProcessRegressor as TGPR
from gpry_tpu_torch.models.preprocessing import Normalize_bounds as TNB
from gpry_tpu_torch.models.preprocessing import Normalize_y as TNY
from gpry_tpu_torch.utils.tools import mean_covmat_from_samples

config.set_device("cpu")
# tiny shapes: one intra-op thread, so that parallel test workers do
# not oversubscribe the cores
torch.set_num_threads(1)
MEAN = np.array([0.3, -0.5])
COV = np.array([[0.36, 0.12], [0.12, 0.25]])
BOX = np.array([[-3.0, 3.0], [-3.0, 3.0]])


def T(a):
    return torch.as_tensor(np.asarray(a, dtype=float), dtype=torch.float64)


def gauss_logl(params, X):
    """Normalized 2-d Gaussian log-density (torch)."""
    mean, icov, lognorm = params
    diff = X - mean
    return -0.5 * torch.einsum("ni,ij,nj->n", diff, icov, diff) - lognorm


def gauss_params():
    lognorm = 0.5 * np.log(np.linalg.det(2 * np.pi * COV))
    return T(MEAN), T(np.linalg.inv(COV)), float(lognorm)


@pytest.mark.parametrize("seed", [0, 1])
def test_ns_gaussian_logz_and_moments(seed):
    gen = torch.Generator().manual_seed(seed)
    res = run_nested_device(gauss_logl, gauss_params(), gen, T(BOX[:, 0]),
                            T(BOX[:, 1]), nlive=200, num_repeats=10,
                            max_dead=4000)
    logw, logl = res.logw.numpy(), res.logl.numpy()
    keep = np.isfinite(logw)
    w = np.exp(logw[keep] - logw[keep].max())
    # analytic: the Gaussian's mass is all inside the box, prior 1/36
    logz_true = -np.log(36.0)
    H = float(np.sum(w * (logl[keep] - res.logZ)) / w.sum())
    sigma = np.sqrt(H / 200)
    assert abs(res.logZ - logz_true) < 3 * sigma, (res.logZ, logz_true,
                                                   sigma)
    mean, cov = mean_covmat_from_samples(res.X.numpy()[keep], w)
    np.testing.assert_allclose(mean, MEAN, atol=0.05)
    # the JAX package's own NS test holds the std to 15% (tests/
    # test_nested.py); both samplers underestimate it by ~5% here
    np.testing.assert_allclose(np.sqrt(np.diag(cov)), np.sqrt(np.diag(COV)),
                               rtol=0.15)
    corr = cov[0, 1] / np.sqrt(cov[0, 0] * cov[1, 1])
    assert abs(corr - COV[0, 1] / np.sqrt(COV[0, 0] * COV[1, 1])) < 0.1
    assert res.n_calls > 0 and res.n_dead == int(keep.sum()) - 200


def test_ns_matches_jax_by_distribution():
    """Same problem in both packages: evidences within their joint 3 sigma,
    moments within the NS noise."""
    gen = torch.Generator().manual_seed(3)
    res_t = run_nested_device(gauss_logl, gauss_params(), gen, T(BOX[:, 0]),
                              T(BOX[:, 1]), nlive=150, num_repeats=8)
    icov = jnp.asarray(np.linalg.inv(COV))
    lognorm = 0.5 * np.log(np.linalg.det(2 * np.pi * COV))

    def jlogl(params, X):
        diff = X - jnp.asarray(MEAN)
        return -0.5 * jnp.einsum("ni,ij,nj->n", diff, icov, diff) - lognorm

    res_j = j_run_nested(jlogl, (), jax.random.PRNGKey(3),
                         jnp.asarray(BOX[:, 0]), jnp.asarray(BOX[:, 1]),
                         nlive=150, num_repeats=8)
    assert abs(res_t.logZ - float(res_j.logZ)) < 3 * np.sqrt(2 * 3.0 / 150)
    for res in (res_t, res_j):
        logw = np.asarray(res.logw)
        keep = np.isfinite(logw)
        m, _ = mean_covmat_from_samples(np.asarray(res.X)[keep],
                                        np.exp(logw[keep] - logw[keep].max()))
        np.testing.assert_allclose(m, MEAN, atol=0.06)


def test_ns_respects_box_and_neg_inf():
    def logl(params, X):
        base = -0.5 * torch.sum(((X - 0.7) / 0.05) ** 2, dim=-1)
        return torch.where(X[:, 0] < 0.3, torch.full_like(base, -torch.inf),
                           base)

    res = run_nested_device(logl, (), torch.Generator().manual_seed(1),
                            T([0.0, 0.0]), T([1.0, 1.0]), nlive=100,
                            num_repeats=6, max_dead=3000)
    keep = np.isfinite(res.logw.numpy()) & np.isfinite(res.logl.numpy())
    X = res.X.numpy()[keep]
    assert np.all((X >= 0) & (X <= 1))
    assert np.all(X[:, 0] >= 0.3)


def _gprs(d=2, n=30):
    bounds = BOX[:d]
    X = np.random.default_rng(2).uniform(bounds[:, 0], bounds[:, 1], (n, d))
    icov = np.linalg.inv(COV[:d, :d])
    diff = X - MEAN[:d]
    y = -0.5 * np.einsum("ni,ij,nj->n", diff, icov, diff)
    kw = dict(bounds=bounds, n_restarts_optimizer=4, random_state=1)
    j = JGPR(preprocessing_X=JNB(bounds), preprocessing_y=JNY(), **kw)
    t = TGPR(preprocessing_X=TNB(bounds), preprocessing_y=TNY(), **kw)
    j.append_to_data(X, y, fit_gpr=True)
    t.append_to_data(X, y, fit_gpr=True)
    return j, t


def test_mc_sample_from_gp_nested_with_refine(tmp_path):
    j, t = _gprs()
    s_t = mc_sample_from_gp(t, sampler="nested", rng=1,
                            options={"nlive": 100, "num_repeats": 8,
                                     "refine_n_draw": 8192}, verbose=0)
    s_j = j_mc_sample(j, sampler="nested", rng=1,
                      options={"nlive": 100, "num_repeats": 8,
                               "refine_n_draw": 8192}, verbose=0)
    assert s_t["refined"] and s_j["refined"]
    assert s_t["ess"] > 0.2 * len(s_t["X"])
    assert ess(s_t["weights"]) == pytest.approx(s_t["ess"])
    m_t, c_t = mean_covmat_from_samples(s_t["X"], s_t["weights"])
    m_j, c_j = mean_covmat_from_samples(s_j["X"], s_j["weights"])
    np.testing.assert_allclose(m_t, MEAN, atol=0.03)
    np.testing.assert_allclose(c_t, COV, atol=0.03)
    np.testing.assert_allclose(m_t, m_j, atol=0.03)
    np.testing.assert_allclose(c_t, c_j, atol=0.03)
    assert s_t["time_ns"] > 0 and s_t["time_refine"] > 0
    path = tmp_path / "chains" / "mc.txt"
    write_samples_txt(s_t, str(path))
    assert np.loadtxt(path).shape == (len(s_t["X"]), 4)


def test_mc_sample_uniform_and_refusals(monkeypatch):
    _, t = _gprs()
    s = mc_sample_from_gp(t, sampler="uniform", rng=0,
                          options={"n_samples": 500})
    np.testing.assert_allclose(s["logpost"], t.predict(s["X"]), rtol=1e-12)
    # the host NS engines and the Cobaya samplers are ported
    # (tests/test_torch_interfaces.py, tests/test_torch_cobaya.py); without
    # cobaya the Cobaya route raises ImportError, as gpry_tpu's does
    for name in ("cobaya", "cobaya.model"):
        monkeypatch.setitem(sys.modules, name, None)
    with pytest.raises(ImportError, match="cobaya"):
        mc_sample_from_gp(t, sampler="cobaya_mcmc")
    with pytest.raises(ValueError, match="Unknown sampler"):
        mc_sample_from_gp(t, sampler="polychrod")


@pytest.mark.parametrize("shape", [(8, 40, 2), (16, 301, 3), (1, 3, 1)])
def test_split_rhat_matches_jax(shape):
    """The host copy of split_rhat equals gpry_tpu's on the same chains
    (exactly: the same numpy operations), including the short-chain inf."""
    chains = np.random.default_rng(sum(shape)).normal(size=shape)
    chains[: shape[0] // 2] += 0.3   # some between-chain spread
    assert split_rhat(chains) == j_split_rhat(chains)


def test_mcmc_gaussian_moments():
    """As gpry_tpu's test_mcmc_gaussian_moments: the ensemble recovers a
    narrow Gaussian in the unit box (mean atol 0.02, std rtol 0.2), and its
    chains pass the split-R-hat gate the criteria use (< 1.2)."""
    d = 2

    def logl(params, X):
        mu, s = params
        return -0.5 * torch.sum(((X - mu) / s) ** 2, dim=-1)

    X, lps = run_mcmc_device(logl, (T(np.full(d, 0.6)), 0.1),
                             torch.Generator().manual_seed(2),
                             T(np.zeros(d)), T(np.ones(d)), n_chains=8,
                             n_steps=1500)
    assert X.shape == (8, 1500, d) and lps.shape == (8, 1500)
    Xf = X.numpy().reshape(-1, d)
    assert np.allclose(Xf.mean(axis=0), 0.6, atol=0.02)
    assert np.allclose(Xf.std(axis=0), 0.1, rtol=0.2)
    assert split_rhat(X.numpy()) < 1.2
    np.testing.assert_allclose(lps.numpy(), logl((T(np.full(d, 0.6)), 0.1),
                                                 X).numpy(), rtol=1e-12)


def test_mc_sample_from_gp_mcmc_matches_nested():
    """sampler="mcmc" on the same surrogate as the JAX package: the exact
    n_eval count and R-hat in the dict; after the IS refine (its default
    65,536 draws, which must beat the chains' nominal ESS of 8,000) the
    moments of both packages agree with the truth and with each other
    to atol 0.03, as the nested sampler's test holds them.  (Unrefined,
    1,000 steps of 8 chains scatter by ~0.03 in the mean in both packages
    over seeds 1-3, too loose for that gate.)"""
    j, t = _gprs()
    n0 = t.n_eval
    raw = mc_sample_from_gp(t, sampler="mcmc", rng=1,
                            options={"n_steps": 1000, "refine": False},
                            verbose=0)
    n_chains = max(8, 2 * 2)
    assert t.n_eval - n0 == n_chains * (16 + 500 + 1000) == raw["n_calls"]
    assert raw["rhat"] < 1.2 and len(raw["X"]) == n_chains * 1000
    opts = {"n_steps": 1000}
    s_t = mc_sample_from_gp(t, sampler="mcmc", rng=1, options=opts,
                            verbose=0)
    s_j = j_mc_sample(j, sampler="mcmc", rng=1, options=opts, verbose=0)
    assert s_t["rhat"] < 1.2 and s_j["rhat"] < 1.2
    assert s_t["refined"] and s_j["refined"]
    m_t, c_t = mean_covmat_from_samples(s_t["X"], s_t["weights"])
    m_j, c_j = mean_covmat_from_samples(s_j["X"], s_j["weights"])
    np.testing.assert_allclose(m_t, MEAN, atol=0.03)
    np.testing.assert_allclose(c_t, COV, atol=0.03)
    np.testing.assert_allclose(m_t, m_j, atol=0.03)
    np.testing.assert_allclose(c_t, c_j, atol=0.03)
