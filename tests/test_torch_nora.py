"""
Parity of gpry_tpu_torch's NORA slice with gpry_tpu's on the CPU in
float64: the K4 plain version and ``RankedPool.add_bulk`` against
``_bulk_fill_device``, NORA's schedule and sample reuse, the KL criteria,
and the NORA Runner end to end.  Inputs are made with numpy from a seed and
handed to both packages.
"""

import sys
from pathlib import Path

import numpy as np
import jax.numpy as jnp
import pytest
import torch

sys.path.insert(0, str(Path(__file__).parent))
from model_generator import kl_truth_gaussian, random_gaussian  # noqa: E402

import gpry_tpu.run as jax_run  # noqa: E402
from gpry_tpu import config as jconfig  # noqa: E402
from gpry_tpu import convergence as jconv  # noqa: E402
from gpry_tpu.acquisition import NORA as JNORA  # noqa: E402
from gpry_tpu.acquisition import RankedPool as JPool  # noqa: E402
from gpry_tpu.acquisition import functions as jf  # noqa: E402
from gpry_tpu.acquisition.base import grow_surrogate as j_grow  # noqa: E402
from gpry_tpu.acquisition.ranked_pool import _bulk_fill_device  # noqa: E402
from gpry_tpu.models.gp import GaussianProcessRegressor as JGPR  # noqa: E402
from gpry_tpu.models.gp import surrogate_predict as j_predict  # noqa: E402
from gpry_tpu.models.preprocessing import Normalize_bounds as JNB  # noqa
from gpry_tpu.models.preprocessing import Normalize_y as JNY  # noqa: E402
from gpry_tpu.parallel.mesh import mesh_disabled  # noqa: E402

import gpry_tpu_torch.run as torch_run  # noqa: E402
from gpry_tpu_torch import config  # noqa: E402
from gpry_tpu_torch import convergence as tconv  # noqa: E402
from gpry_tpu_torch.acquisition import NORA as TNORA  # noqa: E402
from gpry_tpu_torch.acquisition import RankedPool as TPool  # noqa: E402
from gpry_tpu_torch.acquisition import functions as tf  # noqa: E402
from gpry_tpu_torch.acquisition.base import grow_surrogate  # noqa: E402
from gpry_tpu_torch.models.gp import GaussianProcessRegressor as TGPR  # noqa
from gpry_tpu_torch.models.preprocessing import Normalize_bounds as TNB  # noqa
from gpry_tpu_torch.models.preprocessing import Normalize_y as TNY  # noqa
from gpry_tpu_torch.ops import fused  # noqa: E402

config.set_device("cpu")
# tiny shapes: one intra-op thread, so that parallel test workers do
# not oversubscribe the cores
torch.set_num_threads(1)
D, N_TRAIN, N_CAND, SIZE = 3, 40, 500, 4
BOUNDS = np.array([[-2.0, 3.0], [-1.0, 1.5], [-3.0, 1.0]])
THETA = np.log([1.3, 0.35, 0.3, 0.4])  # moderate: a well-conditioned K
KL_GATE = 0.05


def T(a):
    return torch.as_tensor(np.asarray(a, dtype=float), dtype=torch.float64)


def truth(X):
    X = np.atleast_2d(X)
    return -0.5 * np.sum((X - [0.5, 0.2, -1.0]) ** 2 / [1.5, 0.3, 0.8],
                         axis=1)


def gpr_pair(noise, seed=5):
    """A JAX and a port GPR with the same training set (and per-point noise
    when ``noise == "vector"``), both factorized at the moderate THETA."""
    rng = np.random.default_rng(seed)
    X = rng.uniform(BOUNDS[:, 0], BOUNDS[:, 1], (N_TRAIN, D))
    y = truth(X)
    nl = rng.uniform(5e-3, 2e-2, N_TRAIN) if noise == "vector" else None
    out = []
    for cls, nb, ny in ((JGPR, JNB, JNY), (TGPR, TNB, TNY)):
        g = cls(bounds=BOUNDS, preprocessing_X=nb(BOUNDS),
                preprocessing_y=ny(), n_restarts_optimizer=4, random_state=3)
        g.append_to_data(X, y, noise_level=nl, fit_gpr=False)
        g._theta = THETA.copy()
        g._update_model()
        g._fitted = True
        out.append(g)
    return out


def candidates(j, seed=6):
    """N_CAND candidates with the JAX package's gated mean, std and LogExp
    values (the common inputs of both fills)."""
    Xc = np.random.default_rng(seed).uniform(BOUNDS[:, 0], BOUNDS[:, 1],
                                             (N_CAND, D))
    p = j.surrogate_params()
    mu, sd = (np.asarray(a) for a in j_predict(j.family, p, jnp.asarray(Xc)))
    acqf = jf.LogExp(dimension=D)
    acq = np.asarray(acqf.values(jnp.asarray(mu), jnp.asarray(sd), j.y_max,
                                 float(np.mean(j.noise_level))))
    keep = np.isfinite(acq)
    return Xc[keep], mu[keep], sd[keep], acq[keep]


def _same_fill(a, b):
    """Identical picks and -inf masks; conditioned values within rel 1e-10
    (two triangular solves summing in different orders)."""
    aX, aY, aS, aA, aC = (np.asarray(x) for x in a)
    bX, bY, bS, bA, bC = (np.asarray(x) for x in b)
    np.testing.assert_array_equal(np.isfinite(aC), np.isfinite(bC))
    fin = np.isfinite(bC)
    assert fin.sum() == SIZE
    np.testing.assert_array_equal(aX, bX)
    np.testing.assert_array_equal(aY, bY)
    np.testing.assert_array_equal(aS, bS)
    np.testing.assert_array_equal(aA, bA)
    np.testing.assert_allclose(aC[fin], bC[fin], rtol=1e-10, atol=0)


@pytest.mark.parametrize("noise", ["scalar", "vector"])
def test_k4_plain_matches_jax_bulk_fill(noise):
    j, t = gpr_pair(noise)
    Xc, mu, sd, acq = candidates(j)
    noise_std = float(np.mean(j.noise_level))
    nmax = jconfig.bucket_size(N_TRAIN + SIZE)
    jacq = jf.LogExp(dimension=D)
    res_j = _bulk_fill_device(
        j.family, SIZE, (jacq, jf._params_token(jacq)),
        j_grow(j.surrogate_params(), nmax), jnp.asarray(Xc),
        jnp.asarray(mu), jnp.asarray(sd), jnp.asarray(acq),
        jnp.ones(len(Xc), bool), noise_std)
    p = grow_surrogate(t.surrogate_params(), nmax)
    if noise == "vector":
        assert p.noise_var.shape == (nmax,)
    tacq = tf.LogExp(dimension=D)
    args = (t.family, p, T(Xc), T(mu), T(sd), T(acq),
            torch.ones(len(Xc), dtype=torch.bool), SIZE,
            lambda yy, ss: tacq.values(yy, ss, p.y_max, noise_std))
    res_plain = fused.kriging_believer_fill_plain(*args)
    _same_fill(res_plain, res_j)
    # the wrapper takes the plain version on CPU tensors and launches nothing
    fused.reset_launch_counts()
    res_wrap = fused.kriging_believer_fill(*args, logexp=(tacq.zeta,
                                                          noise_std))
    assert fused.LAUNCHES["kriging_believer_fill"] == 0
    _same_fill(res_wrap, res_plain)


@pytest.mark.parametrize("noise", ["scalar", "vector"])
def test_ranked_pool_add_bulk_matches_jax(noise):
    j, t = gpr_pair(noise)
    Xc, mu, sd, acq = candidates(j)
    jacq, tacq = jf.LogExp(dimension=D), tf.LogExp(dimension=D)
    nstd = float(np.mean(j.noise_level))
    jfn = lambda yy, ss: np.asarray(jacq.values(jnp.asarray(yy),
                                                jnp.asarray(ss), j.y_max,
                                                nstd))
    tfn = lambda yy, ss: tacq.values(T(yy), T(ss), t.y_max, nstd).numpy()
    with mesh_disabled():   # the single-device fused fill
        jpool = JPool(SIZE, j, jfn, acqf=jacq)
        jpool.add(Xc, y=mu, sigma=sd, acq=acq, method="bulk")
    tpool = TPool(SIZE, t, tfn, acqf=tacq)
    tpool.add(Xc, y=mu, sigma=sd, acq=acq, method="bulk")
    (jX, jy, ja), (tX, ty, ta) = jpool.get(), tpool.get()
    assert len(tX) == SIZE
    np.testing.assert_array_equal(tX, jX)
    np.testing.assert_array_equal(ty, jy)
    np.testing.assert_allclose(ta, ja, rtol=1e-10, atol=0)
    # the host loop (no acqf object: K2 sweeps and believer appends) picks
    # the same points, and the one-by-one insertion agrees on the head
    host = TPool(SIZE, t, tfn)
    host.add(Xc, y=mu, sigma=sd, acq=acq, method="bulk")
    np.testing.assert_array_equal(host.get()[0], tX)
    np.testing.assert_allclose(host.get()[2], ta, rtol=1e-9, atol=0)
    single = TPool(SIZE, t, tfn)
    order = np.argsort(acq)[::-1][:12]
    single.add(Xc[order], y=mu[order], sigma=sd[order], acq=acq[order],
               method="single sort acq")
    np.testing.assert_array_equal(single.get()[0][0], tX[0])


def test_nora_schedule_and_reweighting_match_jax():
    j, t = gpr_pair("scalar")
    jn = JNORA(BOUNDS, acq_func={"LogExp": {"dimension": D}}, rng=1)
    tn = TNORA(BOUNDS, acq_func={"LogExp": {"dimension": D}}, rng=1)
    for n in (1, 5, 17, 40, 200):
        fake = type("G", (), {"n": n})()
        assert tn._nlive(fake) == jn._nlive(fake)
    assert tn._nlive(t) == jn._nlive(j) == 75
    rng = np.random.default_rng(8)
    X = rng.uniform(BOUNDS[:, 0], BOUNDS[:, 1], (300, D))
    logp = truth(X) + rng.normal(0, 0.1, 300)
    logw = logp + rng.normal(0, 0.5, 300)
    logw[:5] = -np.inf
    for eng in (jn, tn):
        eng.last_MC_X, eng.last_MC_logp = X.copy(), logp.copy()
        eng.last_MC_logw, eng.last_MC_sigma = logw.copy(), np.ones(300)
    assert tn._reweight_ess() == pytest.approx(jn._reweight_ess(), rel=1e-14)
    n_eval_j, n_eval_t = j.n_eval, t.n_eval
    jn._reweight_last(j)
    tn._reweight_last(t)
    assert t.n_eval - n_eval_t == j.n_eval - n_eval_j == 300
    np.testing.assert_array_equal(np.isfinite(tn.last_MC_logw),
                                  np.isfinite(jn.last_MC_logw))
    fin = np.isfinite(jn.last_MC_logw)
    np.testing.assert_allclose(tn.last_MC_logw[fin], jn.last_MC_logw[fin],
                               rtol=1e-10, atol=1e-12)
    np.testing.assert_allclose(tn.last_MC_logp, jn.last_MC_logp, rtol=1e-10)
    np.testing.assert_allclose(tn.last_MC_sigma, jn.last_MC_sigma,
                               rtol=1e-10, atol=1e-14)
    assert tn._reweight_ess() == pytest.approx(jn._reweight_ess(), rel=1e-9)
    X_a, logp_a, w_a = tn.last_MC_sample()
    assert X_a is tn.last_MC_X and w_a.max() == 1.0


def test_nora_multi_add_proposes_and_reuses():
    """As gpry_tpu's test_nora_multi_add: a fresh NS sample, then a
    reweighted reuse that excludes the proposed points."""
    _, t = gpr_pair("scalar")
    eng = TNORA(BOUNDS, acq_func={"LogExp": {"dimension": D}},
                nlive_max=60, num_repeats=6, rng=np.random.default_rng(3),
                verbose=1)
    X, y_lies, acq = eng.multi_add(t, n_points=3)
    assert X.shape == (3, D) and np.all(np.isfinite(acq))
    assert np.all((X >= BOUNDS[:, 0]) & (X <= BOUNDS[:, 1]))
    assert np.all(np.diff(acq) <= 1e-9)   # conditioned acq non-increasing
    assert eng.mean.shape == (D,) and eng.cov.shape == (D, D)
    X2, _, _ = eng.multi_add(t, n_points=2)
    for x in X2:
        assert not np.any(np.all(np.isclose(X, x), axis=1))
    state = eng.__getstate__()
    assert state["rng"] is None
    eng.force_resample()
    assert eng._iter_since_mc is None


class _Acq:
    def __init__(self, mean, cov):
        self.mean, self.cov = mean, cov


@pytest.mark.parametrize("name", ["GaussianKL", "GaussianKLTrain",
                                  "TrainAlignment"])
def test_kl_criteria_match_jax(name):
    j, t = gpr_pair("scalar")
    rng = np.random.default_rng(11)
    acqs = []
    for _ in range(3):
        A = rng.normal(size=(D, D))
        acqs.append(_Acq(rng.normal(0, 0.3, D), A @ A.T * 0.1 + np.eye(D)))
    cj = getattr(jconv, name)(BOUNDS, {})
    ct = getattr(tconv, name)(BOUNDS, {})
    assert (ct.limit, ct.limit_times, ct.policy) == \
        (cj.limit, cj.limit_times, cj.policy)
    for acq in acqs:
        res = []
        for c, g in ((cj, j), (ct, t)):
            try:
                res.append(c.is_converged(g, acquisition=acq))
            except (jconv.ConvergenceCheckError,
                    tconv.ConvergenceCheckError) as e:
                res.append(type(e).__name__)
        assert res[0] == res[1]
    np.testing.assert_allclose(ct.values, cj.values, rtol=1e-12,
                               equal_nan=True)
    assert ct.n_posterior_evals == cj.n_posterior_evals


def test_nora_runner_matches_jax():
    """The NORA Runner at d = 2 (random_gaussian(d=2, rng=12), seed 2, as
    gpry_tpu's test_pipeline_nora_gaussian, with the audit off in both):
    both converge with KL <= 0.05 and stop within max(4, 25%) truth evals
    of each other.  The NS draws differ (torch Generators against JAX
    keys), so the proposals are not the same points."""
    m = random_gaussian(d=2, rng=12)
    out = {}
    for name, mod in (("torch", torch_run), ("jax", jax_run)):
        runner = mod.Runner(m.loglike, bounds=m.bounds, seed=2, verbose=1,
                            gp_acquisition="NORA", options={"audit": False})
        runner.run()
        X, w, _ = runner.last_mc_samples()
        kl = kl_truth_gaussian(X, w, m.mean, m.cov)
        assert runner.has_converged, name
        assert kl <= KL_GATE, f"{name}: KL={kl} > {KL_GATE}"
        out[name] = runner
    t, j = out["torch"], out["jax"]
    assert [type(c).__name__ for c in t.convergence_criterion] == \
        [type(c).__name__ for c in j.convergence_criterion]
    assert isinstance(t.acquisition, TNORA) and t.acquisition.rng is t.rng
    assert t.diagnose_last_mc_sample()
    band = max(4, 0.25 * j.gpr.n_total)
    assert abs(t.gpr.n_total - j.gpr.n_total) <= band, \
        (t.gpr.n_total, j.gpr.n_total)
