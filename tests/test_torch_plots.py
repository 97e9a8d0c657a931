"""
gpry_tpu_torch's plots, diagnosis and getdist export on the CPU
(plots.py, diag.py, the Runner's plot methods, ``last_mc_samples(
as_getdist=True)``, ``NORA.last_MC_sample_getdist``): twins of the seven
tests of tests/test_plots.py on the same fixtures (matplotlib, Agg
backend, files written to tmp), ``diagnosis`` against gpry_tpu's on one
training set, and the getdist export with getdist missing and against a
stub ``getdist`` module.
"""

import os
import sys
import types
from pathlib import Path

import numpy as np
import pytest
import torch

sys.path.insert(0, str(Path(__file__).parent))

from gpry_tpu_torch import config  # noqa: E402
from gpry_tpu_torch import plots as gplots  # noqa: E402
from gpry_tpu_torch.convergence import CorrectCounter  # noqa: E402
from gpry_tpu_torch.models.gp import GaussianProcessRegressor  # noqa: E402
from gpry_tpu_torch.models.preprocessing import Normalize_bounds, \
    Normalize_y  # noqa: E402
from gpry_tpu_torch.progress import Progress, Timer  # noqa: E402

config.set_device("cpu")
torch.set_num_threads(1)


def _nonempty(path):
    path = Path(path)
    return path.exists() and path.stat().st_size > 0


@pytest.fixture(scope="module")
def fitted_gpr():
    """tests/test_plots.py:15's GPR, in the port."""
    rng = np.random.default_rng(0)
    bounds = np.array([[0.0, 1.0]] * 2)
    X = rng.uniform(size=(25, 2))
    y = -0.5 * np.sum(((X - 0.5) / 0.2) ** 2, axis=1)
    y[X[:, 0] > 0.9] = -np.inf
    gpr = GaussianProcessRegressor(
        bounds=bounds, preprocessing_X=Normalize_bounds(bounds),
        preprocessing_y=Normalize_y(), n_restarts_optimizer=4,
        random_state=1)
    gpr.append_to_data(X, y)
    return gpr


def test_plot_model_2d(fitted_gpr, tmp_path):
    """tests/test_plots.py:30."""
    for what in ("mean", "std"):
        out = tmp_path / f"model_{what}.png"
        gplots.plot_model_2d(fitted_gpr, what=what, n_grid=30,
                             save=str(out))
        assert out.exists() and out.stat().st_size > 1000


def test_plot_trace_and_slices(fitted_gpr, tmp_path):
    """tests/test_plots.py:38."""
    out = tmp_path / "trace.png"
    gplots.plot_trace(fitted_gpr, save=str(out))
    assert _nonempty(out)
    out2 = tmp_path / "slices.png"
    gplots.plot_slices(None, fitted_gpr, n_points=21, save=str(out2))
    assert _nonempty(out2)


def test_plot_corner_and_distance(fitted_gpr, tmp_path):
    """tests/test_plots.py:47."""
    rng = np.random.default_rng(1)
    X = rng.normal(0.5, 0.2, size=(500, 2))
    samples = {"X": X, "weights": np.ones(500),
               "logpost": -np.sum((X - 0.5) ** 2, axis=1)}
    out = tmp_path / "corner.png"
    gplots.plot_corner(samples, gpr=fitted_gpr, save=str(out))
    assert _nonempty(out)
    out2 = tmp_path / "dist.png"
    gplots.plot_distance_distribution(fitted_gpr, samples, save=str(out2))
    assert _nonempty(out2)
    assert gplots.plot_corner_getdist is gplots.plot_corner


def test_plot_convergence_and_timing(fitted_gpr, tmp_path):
    """tests/test_plots.py:63."""
    cc = CorrectCounter(fitted_gpr.bounds, {})
    cc.is_converged(fitted_gpr, new_y=[-1.0], pred_y=[-1.01])
    out = tmp_path / "conv.png"
    gplots.plot_convergence([cc], save=str(out))
    assert _nonempty(out)
    prog = Progress()
    prog.add_iteration()
    prog.add_current_n_truth(10, 9)
    with Timer() as t:
        pass
    prog.add_acquisition(t)
    prog.add_truth(t, n_evals=2)
    prog.add_fit(t)
    prog.add_convergence(t, 0.1)
    out2 = tmp_path / "timing.png"
    prog.plot_timing(save=str(out2))
    assert _nonempty(out2)


def test_plot_slices_func_and_reference(fitted_gpr, tmp_path):
    """tests/test_plots.py:84."""
    from gpry_tpu_torch.acquisition.functions import LogExp

    class _T:
        prior_bounds = fitted_gpr.bounds
        params = ["x_1", "x_2"]

        @staticmethod
        def logp(x):
            return float(-0.5 * np.sum(((np.asarray(x) - 0.5) / 0.2) ** 2))

    out = tmp_path / "slices_func.png"
    gplots.plot_slices_func(_T(), fitted_gpr, acquisition=LogExp(zeta=0.5),
                            n_points=25, max_points=5, save=str(out))
    assert out.exists() and out.stat().st_size > 1000
    out2 = tmp_path / "slices_ref.png"
    gplots.plot_slices_reference(_T(), fitted_gpr, X_ref=[0.5, 0.5],
                                 n_points=21, save=str(out2))
    assert _nonempty(out2)


def test_plot_corner_with_fiducials(fitted_gpr, tmp_path):
    """tests/test_plots.py:106."""
    rng = np.random.default_rng(2)
    X = rng.normal(0.5, 0.2, size=(400, 2))
    samples = {"X": X, "weights": np.ones(400),
               "logpost": -np.sum((X - 0.5) ** 2, axis=1)}
    fid_mc = {"X": rng.normal(0.52, 0.18, size=(400, 2))}
    out = tmp_path / "corner_fid.png"
    gplots.plot_corner(samples, gpr=fitted_gpr, fiducial_point=[0.5, 0.5],
                       fiducial_MC=fid_mc, save=str(out))
    assert out.exists() and out.stat().st_size > 1000


def test_diag_nora_dumps(tmp_path):
    """tests/test_plots.py:117: diag.plot_nora_sample writes the triangle
    and the d = 2 maps."""
    from gpry_tpu_torch.diag import diagnosis, plot_nora_sample
    from gpry_tpu_torch.run import Runner

    def loglike(x):
        return float(-0.5 * np.sum(((np.asarray(x) - 0.5) / 0.2) ** 2))

    ckpt = str(tmp_path / "diagckpt")
    runner = Runner(loglike, bounds=np.array([[0.0, 1.0]] * 2), seed=3,
                    verbose=1,
                    gp_acquisition={"NORA": {"nlive_max": 40,
                                             "num_repeats": 6}},
                    options={"n_initial": 6, "max_total": 10,
                             "n_points_per_acq": 2},
                    convergence_criterion=False, mc="uniform",
                    checkpoint=ckpt, load_checkpoint="overwrite")
    runner.run()
    runner.set_fiducial_point([0.5, 0.5])
    report = diagnosis(runner)
    assert report["sizes_consistent"]
    path = plot_nora_sample(runner)
    files = os.listdir(path)
    for prefix in ("NORA_iteration_", "contours_mean_", "contours_acq_"):
        names = [f for f in files if f.startswith(prefix)]
        assert names and all(_nonempty(os.path.join(path, f))
                             for f in names), prefix


def test_runner_plots(tmp_path):
    """``plots=True`` writes the progress plots after every iteration's
    save; ``plot_progress`` with the trace and slices, ``plot_mc`` and
    ``plot_distance_distribution`` write theirs; ``diagnosis(plot=True)``
    as a callback."""
    from gpry_tpu_torch.diag import diagnosis
    from gpry_tpu_torch.run import Runner

    def loglike(x):
        return float(-0.5 * np.sum(((np.asarray(x) - 0.5) / 0.2) ** 2))

    ckpt = str(tmp_path / "ckpt")
    reports = []
    runner = Runner(loglike, bounds=np.array([[0.0, 1.0]] * 2), seed=4,
                    verbose=1, plots=True,
                    callback=lambda r: reports.append(diagnosis(r,
                                                                plot=True)),
                    gpr={"n_restarts_optimizer": 2},
                    options={"n_initial": 6, "max_total": 10,
                             "n_points_per_acq": 2},
                    convergence_criterion="DontConverge", mc="uniform",
                    checkpoint=ckpt, load_checkpoint="overwrite")
    runner.run()
    assert len(reports) == runner.current_iteration >= 2
    assert all(r["sizes_consistent"] for r in reports)
    images = os.path.join(ckpt, "images")
    for name in ("timing.png", "convergence.png"):
        assert _nonempty(os.path.join(images, name)), name
    runner.plot_progress(trace=True, slices=True)
    for name in ("trace.png", "slices.png"):
        assert _nonempty(os.path.join(images, name)), name
    runner.plot_mc(output=str(tmp_path / "mc.png"))
    runner.plot_distance_distribution(output=str(tmp_path / "dist.png"))
    assert _nonempty(tmp_path / "mc.png")
    assert _nonempty(tmp_path / "dist.png")


def test_diagnosis_matches_jax():
    """``diagnosis`` of a gpry_tpu Runner and of a port Runner given the
    same training set (the reference GPR's state carried into the port,
    two appends, the second the "last batch", -inf values among them): the
    same sizes and classifier agreement, the last batch's largest residual
    within rel 1e-6."""
    from model_generator import random_gaussian
    from test_torch_audit import carry
    import gpry_tpu.run as jax_run
    from gpry_tpu.diag import diagnosis as jdiagnosis
    import gpry_tpu_torch.run as torch_run
    from gpry_tpu_torch.diag import diagnosis

    m = random_gaussian(d=2, rng=3)
    rng = np.random.default_rng(3)
    X = rng.uniform(m.bounds[:, 0], m.bounds[:, 1], size=(12, 2))
    y = np.array([m.loglike(x) for x in X])
    y[[1, 5, 9]] = -np.inf
    j = jax_run.Runner(m.loglike, bounds=m.bounds, seed=3, verbose=0,
                       options={"max_total": 12})
    j.gpr.append_to_data(X[:8], y[:8], fit_gpr={"n_restarts": 2})
    j.gpr.append_to_data(X[8:], y[8:], fit_gpr={"n_restarts": 2})
    t = torch_run.Runner(m.loglike, bounds=m.bounds, seed=3, verbose=0,
                         options={"max_total": 12})
    carry(j.gpr, t.gpr)
    t.gpr.n_last_appended = j.gpr.n_last_appended
    t.gpr.n_last_appended_finite = j.gpr.n_last_appended_finite
    j.current_iteration = t.current_iteration = 2
    want, got = jdiagnosis(j), diagnosis(t)
    assert set(got) == set(want)
    for key in ("iteration", "n_finite_threshold", "n_gpr_train",
                "sizes_consistent"):
        assert got[key] == want[key], key
    assert got["n_gpr_train"] == 9
    if "classifier_train_agreement" in want:
        assert got["classifier_train_agreement"] == \
            want["classifier_train_agreement"]
    np.testing.assert_allclose(got["max_residual_last_batch"],
                               want["max_residual_last_batch"], rtol=1e-6)


# ------------------------------------------------------------- getdist

class _MCSamples:
    """A stub of getdist's MCSamples: records its keyword arguments."""

    def __init__(self, **kwargs):
        self.kwargs = kwargs


def _stub_getdist(monkeypatch):
    mod = types.ModuleType("getdist")
    mod.MCSamples = _MCSamples
    monkeypatch.setitem(sys.modules, "getdist", mod)


def _nora_with_sample(nora_cls, d=2):
    nora = nora_cls(np.array([[0.0, 1.0]] * d))
    rng = np.random.default_rng(5)
    nora.last_MC_X = rng.uniform(size=(30, d))
    nora.last_MC_logp = -np.sum(nora.last_MC_X ** 2, axis=1)
    nora.last_MC_logw = nora.last_MC_logp - 1.0
    return nora


def test_getdist_export_without_getdist_raises(monkeypatch):
    """Without getdist, ``last_mc_samples(as_getdist=True)`` and
    ``NORA.last_MC_sample_getdist()`` raise ImportError naming getdist."""
    from model_generator import random_gaussian
    from gpry_tpu_torch.acquisition.nora import NORA
    from gpry_tpu_torch.run import Runner

    monkeypatch.setitem(sys.modules, "getdist", None)
    m = random_gaussian(d=2, rng=12)
    runner = Runner(m.loglike, bounds=m.bounds, seed=1, verbose=0)
    runner.last_mc_result = {"X": np.zeros((2, 2)), "weights": np.ones(2),
                             "logpost": np.zeros(2)}
    with pytest.raises(ImportError, match="getdist"):
        runner.last_mc_samples(as_getdist=True)
    with pytest.raises(ImportError, match="getdist"):
        _nora_with_sample(NORA).last_MC_sample_getdist()


def test_getdist_export_matches_jax(monkeypatch):
    """With a stub getdist, the port hands MCSamples the same samples,
    weights, loglikes and names as gpry_tpu for the same samples dict
    (``samples_dict_to_getdist``, ``last_mc_samples(as_getdist=True)``,
    ``NORA.last_MC_sample_getdist``)."""
    from model_generator import random_gaussian
    from gpry_tpu.acquisition.nora import NORA as JNORA
    from gpry_tpu.mc.samples import samples_dict_to_getdist as jconv
    from gpry_tpu_torch.acquisition.nora import NORA
    from gpry_tpu_torch.mc.samples import process_gdsamples, \
        samples_dict_to_getdist
    from gpry_tpu_torch.run import Runner

    _stub_getdist(monkeypatch)
    rng = np.random.default_rng(6)
    X = rng.normal(size=(50, 3))
    sd = {"X": X, "weights": rng.uniform(size=50),
          "logpost": -np.sum(X ** 2, axis=1)}

    def same(got, want):
        assert set(got.kwargs) == set(want.kwargs)
        for key in ("samples", "weights", "loglikes"):
            np.testing.assert_array_equal(got.kwargs[key], want.kwargs[key])
        assert list(got.kwargs["names"]) == list(want.kwargs["names"])
        assert got.kwargs["name_tag"] == want.kwargs["name_tag"]

    same(samples_dict_to_getdist(sd), jconv(sd))
    same(samples_dict_to_getdist(sd, params=["a", "b", "c"], name="s"),
         jconv(sd, params=["a", "b", "c"], name="s"))
    same(process_gdsamples(sd), jconv(sd))
    m = random_gaussian(d=3, rng=12)
    runner = Runner(m.loglike, bounds=m.bounds, seed=1, verbose=0)
    runner.last_mc_result = sd
    same(runner.last_mc_samples(as_getdist=True),
         jconv(sd, params=runner.truth.params))
    same(_nora_with_sample(NORA).last_MC_sample_getdist(params=["p", "q"]),
         _nora_with_sample(JNORA).last_MC_sample_getdist(params=["p", "q"]))
