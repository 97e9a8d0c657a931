"""
Parity of gpry_tpu_torch's mode-aware convergence audit with gpry_tpu's on
the CPU in float64: K5's plain version against ``surrogate_mean_std_smooth``,
the screen, the polishes, the calibrations, the whole audit and the
off-batch streak feed.  Inputs are made with numpy from a seed; a JAX GPR's
state is carried into the port with ``load_numpy_state`` and the Runners'
numpy streams are aligned, so both packages draw the same Sobol nets and
clouds.
"""

import sys
from pathlib import Path

import numpy as np
import jax.numpy as jnp
import pytest
import torch

sys.path.insert(0, str(Path(__file__).parent))
from model_generator import himmelblau  # noqa: E402

import gpry_tpu.run as jax_run  # noqa: E402
from gpry_tpu.models.gp import GaussianProcessRegressor as JGPR  # noqa: E402
from gpry_tpu.models.gp import \
    surrogate_mean_std_smooth as j_smooth  # noqa: E402
from gpry_tpu.models.preprocessing import Normalize_bounds as JNB  # noqa
from gpry_tpu.models.preprocessing import Normalize_y as JNY  # noqa: E402

import gpry_tpu_torch.run as torch_run  # noqa: E402
from gpry_tpu_torch import config  # noqa: E402
from gpry_tpu_torch.models.gp import surrogate_from_numpy  # noqa: E402
from gpry_tpu_torch.models.gp import surrogate_mean_std_sweep  # noqa: E402
from gpry_tpu_torch.ops import fused  # noqa: E402

config.set_device("cpu")
# tiny shapes: one intra-op thread, so that parallel test workers do
# not oversubscribe the cores
torch.set_num_threads(1)
FAMILIES = ("RBF", "Matern12", "Matern32", "Matern52")
# a composite kernel (spec tree): C() * RBF + WhiteKernel
SPEC = {"Sum": [{"Product": [{"ConstantKernel": {}}, {"RBF": {}}]},
                {"WhiteKernel": {"noise_level": 1e-4}}]}
# Himmelblau's four maxima; the audit fixtures train on the first three
MODES = np.array([[3.0, 2.0], [-2.805118, 3.131312],
                  [-3.779310, -3.283186], [3.584428, -1.848126]])


def T(a):
    return torch.as_tensor(np.asarray(a, dtype=float), dtype=torch.float64)


def ported(p):
    d = {k: (v if k == "svm" else np.asarray(v))
         for k, v in p._asdict().items()}
    d["svm"] = {k: np.asarray(v) for k, v in p.svm._asdict().items()}
    return surrogate_from_numpy(d, device="cpu")


def carry(j, t):
    """Give the port GPR ``t`` exactly the JAX GPR ``j``'s fitted state."""
    svm = None
    if j.infinities_classifier is not None:
        svm = {k: v for k, v in vars(j.infinities_classifier).items()
               if k != "backend"}
    t.load_numpy_state(j.kernel_theta, j.X_train_all, j.y_train_all,
                       j.preprocessing_X.loc, j.preprocessing_X.scale,
                       j.preprocessing_y.mean_, j.preprocessing_y.std_,
                       svm=svm)


def three_mode_training(seed=0, per_mode=14, n_far=12):
    """Points around three of Himmelblau's four maxima, plus uniform points
    kept more than 3 away from the fourth."""
    rng = np.random.default_rng(seed)
    X = [m + rng.normal(0.0, 0.5, (per_mode, 2)) for m in MODES[:3]]
    far = rng.uniform(-6.0, 6.0, (400, 2))
    far = far[np.linalg.norm(far - MODES[3], axis=1) > 3.0][:n_far]
    return np.clip(np.vstack(X + [far]), -6.0, 6.0)


def uniform_training(seed=1, n=40):
    """Uniform points in the prior box: at the GP's initial hyperparameters
    a well-conditioned kernel, for element-wise comparisons (the clusters
    of ``three_mode_training`` cancel in K^-1 y to ~1e-8 relative)."""
    return np.random.default_rng(seed).uniform(-6.0, 6.0, (n, 2))


def runner_pair(X, fit=False, seed=4):
    """A JAX and a port Runner (default options: audit on) on Himmelblau
    trained on ``X``, with the same GP state and the same numpy stream.
    ``fit``: the JAX GPR's fitted hyperparameters; otherwise its initial
    (prior-mean) ones."""
    m = himmelblau()
    y = m.loglike_batch(X)
    j = jax_run.Runner(m.loglike, bounds=m.bounds, seed=seed, verbose=0)
    if fit:
        j.gpr.append_to_data(X, y, fit_gpr={"n_restarts": 4})
    else:
        j.gpr.append_to_data(X, y, fit_gpr=False)
        j.gpr._fitted = True
    t = torch_run.Runner(m.loglike, bounds=m.bounds, seed=seed, verbose=0)
    carry(j.gpr, t.gpr)
    t.rng.bit_generator.state = j.rng.bit_generator.state
    for r in (j, t):
        r.progress.add_iteration()
    return j, t


@pytest.mark.parametrize("noise", ["scalar", "vector"])
@pytest.mark.parametrize("kernel", FAMILIES + (pytest.param(SPEC,
                                                            id="spec"),))
def test_meanvar_ungated_plain_matches_jax(kernel, noise):
    """K5's plain version (and the port's sweep entry point) against JAX's
    ``surrogate_mean_std_smooth``: mean within rel 1e-9; std within rel
    1e-9 plus an absolute 1e-7 sqrt(sigma^2) y_scale, for the queries at
    training points where sigma^2 - |v|^2 cancels to ~0."""
    rng = np.random.default_rng(5)
    bounds = np.array([[-3.0, 3.0], [-2.0, 4.0], [-1.0, 1.0]])
    X = rng.uniform(bounds[:, 0], bounds[:, 1], (48, 3))
    y = -0.5 * np.sum((X - [0.3, 1.0, 0.0]) ** 2 / [1.5, 2.0, 0.3], axis=1)
    nl = rng.uniform(5e-3, 2e-2, len(y)) if noise == "vector" else None
    j = JGPR(kernel=kernel, bounds=bounds, preprocessing_X=JNB(bounds),
             preprocessing_y=JNY(), random_state=3)
    j.append_to_data(X, y, noise_level=nl, fit_gpr=False)
    j._fitted = True
    p = j.surrogate_params()
    pt = ported(p)
    Xq = np.vstack([rng.uniform(bounds[:, 0] - 1, bounds[:, 1] + 1,
                                (300, 3)), X[:10]])
    mj, sj = (np.asarray(a) for a in j_smooth(j.family, p, jnp.asarray(Xq)))
    for mt, st in (fused.meanvar_ungated_plain(j.family, pt, T(Xq)),
                   surrogate_mean_std_sweep(j.family, pt, T(Xq))):
        np.testing.assert_allclose(mt.numpy(), mj, rtol=1e-9)
        atol = 1e-7 * float(np.exp(0.5 * j.kernel_theta[0])) \
            * float(p.y_scale)
        np.testing.assert_allclose(st.numpy(), sj, rtol=1e-9, atol=atol)


def test_audit_screen_matches_jax():
    """The same scrambled-Sobol net exactly; the calibration, mu_eff and z
    within rel 1e-9 (z where finite: the same infinite entries)."""
    j, t = runner_pair(uniform_training())
    thres = j.gpr.y_max - 9.0
    Xj, muj, zj = j._audit_screen(thres)
    Xt, mut, zt = t._audit_screen(thres)
    np.testing.assert_array_equal(Xt, Xj)
    np.testing.assert_allclose(t._audit_calib, j._audit_calib, rtol=1e-9)
    np.testing.assert_allclose(mut, muj, rtol=1e-9)
    np.testing.assert_array_equal(np.isfinite(zt), np.isfinite(zj))
    fin = np.isfinite(zj)
    np.testing.assert_allclose(zt[fin], zj[fin], rtol=1e-9)


def test_polishes_pick_the_same_points():
    """``_audit_polish`` and ``_apex_polish`` pick the same cloud points
    (exactly: the clouds come from the same numpy stream), with their mu
    within rel 1e-9."""
    j, t = runner_pair(uniform_training())
    thres = j.gpr.y_max - 9.0
    for r in (j, t):
        r._audit_screen(thres)
        r._X_audit_hist = [np.array([0.8, 0.3])]
    X0 = np.array([[4.0, -2.5], [0.0, 0.0], [-5.0, 5.0]])
    Pj, mj = j._audit_polish(X0, thres, margin=4.0)
    Pt, mt = t._audit_polish(X0, thres, margin=4.0)
    np.testing.assert_array_equal(Pt, Pj)
    np.testing.assert_allclose(mt, mj, rtol=1e-9)
    for frac in (0.06, 0.015):
        Aj, aj = j._apex_polish(X0, frac)
        At, at = t._apex_polish(X0, frac)
        np.testing.assert_array_equal(At, Aj)
        np.testing.assert_allclose(at, aj, rtol=1e-9)


def test_convergence_audit_matches_jax_on_three_of_four_modes():
    """A fitted Himmelblau GP that has seen three of its four modes: four
    declarations audited in a row.  Both packages veto each of them, spend
    the same truth evals and audit the same points (within 1e-8): the apex
    calibration, a real finding, and dirty screens after three rounds."""
    j, t = runner_pair(three_mode_training(), fit=True)
    out = {}
    for name, r in (("jax", j), ("torch", t)):
        verdicts = [r._convergence_audit() for _ in range(4)]
        out[name] = (verdicts, r._n_audited, r._audit_dirty_vetoes,
                     r.gpr.n_total, np.asarray(r._X_audit_hist))
    vj, vt = out["jax"], out["torch"]
    assert vj[0] == vt[0] == [False] * 4
    assert vj[1:4] == vt[1:4]
    assert vj[1] >= 8 and vj[2] >= 1
    np.testing.assert_allclose(vt[4], vj[4], rtol=0, atol=1e-8)


def test_mode_center_calibration_matches_jax():
    """``_mode_center_calibration`` with the same ``_last_modes``: one
    anchored centre (skipped), one unanchored at the unseen fourth maximum
    (evaluated); both packages veto and train on the same point."""
    j, t = runner_pair(np.vstack([uniform_training(), MODES[:1] + 0.01]))
    modes = [{"mean": MODES[0], "cov": 0.25 * np.eye(2), "weight": 0.7},
             {"mean": MODES[3] + 0.05, "cov": 0.04 * np.eye(2),
              "weight": 0.3}]
    verdict = {}
    for name, r in (("jax", j), ("torch", t)):
        r._last_modes = modes
        verdict[name] = r._mode_center_calibration()
    assert verdict["jax"] is verdict["torch"] is False
    assert j._n_audited == t._n_audited == 1
    assert j.gpr.n_total == t.gpr.n_total
    np.testing.assert_allclose(np.asarray(t._X_audit_hist),
                               np.asarray(j._X_audit_hist), atol=1e-12)
    assert t.convergence_criterion[0].n_pred \
        == j.convergence_criterion[0].n_pred


def test_feed_offbatch_convergence_matches_jax():
    """The same audit evals leave the same CorrectCounter streak: hits
    extend it, a miss resets it, -inf truths and non-finite predictions
    are skipped."""
    j, t = runner_pair(uniform_training())
    y_max = j.gpr.y_max
    new_y = np.array([y_max - 1.0, y_max - 2.0, -np.inf, y_max - 5.0,
                      y_max - 0.5, y_max - 0.2])
    pred_y = np.array([y_max - 1.001, y_max - 2.0, 0.0, y_max + 3.0,
                       np.nan, y_max - 0.2])
    for r in (j, t):
        r.convergence_criterion[0].n_pred = 3
    for lo, hi in ((0, 2), (2, 6)):
        for r in (j, t):
            r._feed_offbatch_convergence(new_y[lo:hi], pred_y[lo:hi])
        assert t.convergence_criterion[0].n_pred \
            == j.convergence_criterion[0].n_pred
    assert t.convergence_criterion[0].n_pred == 1
