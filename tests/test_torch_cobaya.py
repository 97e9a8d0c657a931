"""
gpry_tpu_torch's Cobaya interop on the CPU (cobaya.py, CobayaWrapper.yaml,
mc/cobaya_mc.py, TruthCobaya and its checkpoint): twins of the six tests of
tests/test_cobaya.py and of tests/test_round3.py:578, against
``tests/minicobaya.py`` (cobaya is not installed here; the double needs
pandas), and the surrogate likelihood against gpry_tpu's on one carried
GP state.
"""

import importlib
import os
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

sys.path.insert(0, str(Path(__file__).parent))

from gpry_tpu_torch import config  # noqa: E402

config.set_device("cpu")
torch.set_num_threads(1)

_HAS_REAL_COBAYA = importlib.util.find_spec("cobaya") is not None


@pytest.fixture
def cobaya_env():
    """The real cobaya where it is installed, else the minicobaya double
    (in sys.modules for the test)."""
    if _HAS_REAL_COBAYA:
        import cobaya
        yield cobaya
        return
    import minicobaya
    mod = minicobaya.install()
    try:
        yield mod
    finally:
        minicobaya.uninstall()


def _gauss_model_info():
    def loglike(x, y):
        return -0.5 * ((x - 0.5) ** 2 + (y + 0.5) ** 2) / 0.04

    return {
        "likelihood": {"gauss": {
            "external": loglike, "input_params": ["x", "y"]}},
        "params": {
            "x": {"prior": {"min": -2, "max": 2}},
            "y": {"prior": {"min": -2, "max": 2}},
        },
    }


def _gaussian_training(seed=2, n=40):
    """A 2-d Gaussian log-posterior at ``n`` uniform points."""
    rng = np.random.default_rng(seed)
    bounds = np.array([[-2.0, 2.0]] * 2)
    X = rng.uniform(-2, 2, size=(n, 2))
    y = -0.5 * np.sum((X - [0.5, -0.5]) ** 2, axis=1) / 0.04
    return bounds, X, y


def _port_gpr(bounds, X, y, restarts=3):
    from gpry_tpu_torch.models.gp import GaussianProcessRegressor
    from gpry_tpu_torch.models.preprocessing import Normalize_bounds, \
        Normalize_y
    gpr = GaussianProcessRegressor(
        bounds=bounds, preprocessing_X=Normalize_bounds(bounds),
        preprocessing_y=Normalize_y(), n_restarts_optimizer=restarts,
        random_state=3)
    gpr.append_to_data(X, y, fit_gpr={"n_restarts": restarts})
    return gpr


def test_defaults_schema():
    """tests/test_cobaya.py:51."""
    from gpry_tpu_torch.cobaya import DEFAULTS
    for key in ("n_initial", "max_initial", "max_total", "n_points_per_acq",
                "gpr", "gp_acquisition", "convergence_criterion",
                "mc_sampler", "checkpoint", "verbose"):
        assert key in DEFAULTS
    from gpry_tpu.cobaya import DEFAULTS as JAX_DEFAULTS
    assert DEFAULTS == JAX_DEFAULTS


def test_truth_cobaya_and_runner(cobaya_env):
    """tests/test_cobaya.py:59: a Runner driven by a Cobaya Model."""
    from cobaya.model import get_model
    from gpry_tpu_torch.run import Runner
    from gpry_tpu_torch.truth import TruthCobaya, get_truth

    model = get_model(_gauss_model_info())
    truth = get_truth(model)
    assert isinstance(truth, TruthCobaya)
    assert truth.params == ["x", "y"]
    assert truth.d == 2
    assert np.isfinite(truth.logp(np.array([0.5, -0.5])))
    assert truth.logp(np.array([5.0, 0.0])) == -np.inf

    runner = Runner(model, seed=0, verbose=1,
                    options={"max_total": 16, "max_initial": 12},
                    convergence_criterion="DontConverge", mc="uniform",
                    gpr={"n_restarts_optimizer": 1})
    runner.run()
    assert runner.gpr.n_total >= 15
    assert runner.last_mc_result is not None
    assert runner.model is model


def test_surrogate_as_cobaya_likelihood_mc(cobaya_env):
    """tests/test_cobaya.py:85: the surrogate as a Cobaya likelihood, and
    Cobaya's mcmc over it recovers the posterior mean."""
    from gpry_tpu_torch.mc.cobaya_mc import cobaya_generate_gp_model_input
    from gpry_tpu_torch.mc.samples import mc_sample_from_gp

    bounds, X, y = _gaussian_training()
    gpr = _port_gpr(bounds, X, y)
    info = cobaya_generate_gp_model_input(gpr, params=["x", "y"])
    assert set(info["params"]) == {"x", "y"}
    assert "gp" in info["likelihood"]
    lkl = info["likelihood"]["gp"]["external"]
    vol = np.sum(np.log(bounds[:, 1] - bounds[:, 0]))
    want = gpr.predict(np.array([[0.4, -0.4]]))[0] + vol
    got = lkl(x=0.4, y=-0.4)
    assert type(got) is float
    assert np.isclose(got, want)

    result = mc_sample_from_gp(
        gpr, sampler="cobaya_mcmc", rng=np.random.default_rng(4),
        options={"params": ["x", "y"], "covmat": np.diag([0.04, 0.04])})
    w = result["weights"] / result["weights"].sum()
    mean_mc = (result["X"] * w[:, None]).sum(axis=0)
    assert np.all(np.abs(mean_mc - [0.5, -0.5]) < 0.15), mean_mc


def test_cobaya_wrapper_sampler(cobaya_env):
    """tests/test_cobaya.py:127: the CobayaWrapper Sampler runs the loop."""
    from cobaya.model import get_model
    from gpry_tpu_torch.cobaya import CobayaWrapper

    model = get_model(_gauss_model_info())
    # the budget as the wrapper's own loop options: they override those
    # in "options" (the reference's twin sets only "options" and so runs
    # to the default 70 d^1.5 = 198 evaluations)
    wrapper_info = {
        "max_total": 20, "max_initial": 14,
        "options": {"max_total": 20, "max_initial": 14},
        "convergence_criterion": "DontConverge",
        "mc_sampler": "uniform",
        "truth_executor": {"threads": {"max_workers": 2}},
        "gpr": {"n_restarts_optimizer": 2},
        "seed": 1,
        "verbose": 1,
    }
    try:
        wrapper = CobayaWrapper(wrapper_info, model)
    except TypeError:
        pytest.skip("real cobaya Sampler signature differs")
    wrapper.run()
    sample = wrapper.samples()
    assert sample is not None and len(sample["X"]) > 100
    prods = wrapper.products()
    assert prods["runner"].gpr.n_total >= 15
    assert prods["runner"].executor.mode == "threads"
    assert prods["runner"].executor.max_workers == 2
    prods["runner"].executor.shutdown()
    logw = sample["logpost"] - sample["logpost"].max()
    w = np.exp(logw) * sample["weights"]
    w /= w.sum()
    mean_mc = (sample["X"] * w[:, None]).sum(axis=0)
    assert np.all(np.abs(mean_mc - [0.5, -0.5]) < 0.25), mean_mc


@pytest.mark.skipif(not _HAS_REAL_COBAYA, reason="cobaya not installed")
def test_wrapper_with_real_cobaya():
    """tests/test_cobaya.py:166."""
    from cobaya.model import get_model
    from gpry_tpu_torch.run import Runner

    model = get_model(_gauss_model_info())
    runner = Runner(model, seed=0, verbose=1)
    runner.run()
    assert runner.last_mc_result is not None


def test_yaml_schema_matches_defaults():
    """tests/test_cobaya.py:176: the YAML beside the package equals
    DEFAULTS."""
    import yaml
    import gpry_tpu_torch
    from gpry_tpu_torch.cobaya import DEFAULTS

    path = os.path.join(os.path.dirname(gpry_tpu_torch.__file__),
                        "CobayaWrapper.yaml")
    with open(path) as f:
        schema = yaml.safe_load(f)
    assert set(schema) == set(DEFAULTS)
    for key in ("n_initial", "max_total", "n_points_per_acq", "mc_sampler",
                "load_checkpoint", "verbose"):
        assert schema[key] == DEFAULTS[key], key


class _DummyGPR:
    pass


def _centred_gauss(x, y):
    """A module-level likelihood: the standard pickle carries it (the
    reference's checkpoint uses dill, which carries a local one too)."""
    return -0.5 * (x**2 + y**2) / 0.04


def test_truth_cobaya_checkpoint_roundtrip(tmp_path, cobaya_env):
    """tests/test_round3.py:578 through the port's io."""
    from cobaya.model import get_model
    from gpry_tpu_torch import io as gio
    from gpry_tpu_torch.progress import Progress
    from gpry_tpu_torch.truth import TruthCobaya

    info = {
        "likelihood": {"gauss": {
            "external": _centred_gauss, "input_params": ["x", "y"]}},
        "params": {"x": {"prior": {"min": -2, "max": 2}},
                   "y": {"prior": {"min": -2, "max": 2}}},
    }
    truth = TruthCobaya(get_model(info))
    gio.save_checkpoint(str(tmp_path), truth, _DummyGPR(), None, None, {},
                        Progress())
    tru2, *_ = gio.read_checkpoint(str(tmp_path))
    assert isinstance(tru2, TruthCobaya)
    assert tru2.params == ["x", "y"]
    x = np.array([0.1, -0.2])
    assert np.isclose(tru2.logp(x), truth.logp(x))


def test_truth_cobaya_checkpoint_of_a_local_likelihood(tmp_path, cobaya_env):
    """A Cobaya model whose likelihood is a local function (which the
    standard pickle cannot carry) is stored without its info; reading it
    back needs the model, as a lambda loglike needs its callable."""
    from cobaya.model import get_model
    from gpry_tpu_torch import io as gio
    from gpry_tpu_torch.progress import Progress
    from gpry_tpu_torch.truth import TruthCobaya

    model = get_model(_gauss_model_info())
    truth = TruthCobaya(model)
    gio.save_checkpoint(str(tmp_path), truth, _DummyGPR(), None, None, {},
                        Progress())
    with pytest.raises(ValueError, match="Pass the model again"):
        gio.read_checkpoint(str(tmp_path))
    tru2, *_ = gio.read_checkpoint(str(tmp_path), loglike=model)
    assert isinstance(tru2, TruthCobaya) and tru2.model is model


def test_cobaya_route_needs_cobaya(monkeypatch):
    """Without cobaya the route raises ImportError, as gpry_tpu's does;
    so does the wrapper class."""
    from gpry_tpu_torch import check_cobaya_installed, get_cobaya_class
    from gpry_tpu_torch.mc.samples import mc_sample_from_gp
    for name in ("cobaya", "cobaya.model", "cobaya.sampler"):
        monkeypatch.setitem(sys.modules, name, None)
    assert check_cobaya_installed() is False or _HAS_REAL_COBAYA
    bounds, X, y = _gaussian_training(n=12)
    gpr = _port_gpr(bounds, X, y, restarts=1)
    with pytest.raises(ImportError, match="cobaya"):
        mc_sample_from_gp(gpr, sampler="cobaya_mcmc")
    with pytest.raises(ImportError, match="cobaya"):
        get_cobaya_class()


def test_surrogate_likelihood_matches_jax():
    """A fitted gpry_tpu GPR's state carried into the port: the surrogate
    likelihood of ``cobaya_generate_gp_model_input`` agrees with
    gpry_tpu's at 20 points within rel 1e-9 (-inf at the same points), and
    the params blocks are equal.  The GP is fitted on Himmelblau, at
    moderate hyperparameters, as the repo's element-wise parity tests are:
    a fit to a Gaussian runs the length scales to their bound, where K's
    condition number makes two packages' solves differ at ~1e-6."""
    from model_generator import himmelblau
    from test_torch_audit import carry
    from gpry_tpu.mc.cobaya_mc import cobaya_generate_gp_model_input as jgen
    from gpry_tpu.models.gp import GaussianProcessRegressor as JGPR
    from gpry_tpu.models.preprocessing import Normalize_bounds as JNB
    from gpry_tpu.models.preprocessing import Normalize_y as JNY
    from gpry_tpu_torch.mc.cobaya_mc import cobaya_generate_gp_model_input
    from gpry_tpu_torch.models.gp import GaussianProcessRegressor
    from gpry_tpu_torch.models.preprocessing import Normalize_bounds, \
        Normalize_y

    m = himmelblau()
    bounds = m.bounds
    rng = np.random.default_rng(7)
    X = rng.uniform(bounds[:, 0], bounds[:, 1], size=(30, 2))
    j = JGPR(bounds=bounds, preprocessing_X=JNB(bounds),
             preprocessing_y=JNY(), n_restarts_optimizer=2, random_state=3)
    j.append_to_data(X, m.loglike_batch(X), fit_gpr={"n_restarts": 2})
    t = GaussianProcessRegressor(
        bounds=bounds, preprocessing_X=Normalize_bounds(bounds),
        preprocessing_y=Normalize_y(), random_state=3)
    carry(j, t)
    params = ["x", "y"]
    ji, ti = jgen(j, params=params), cobaya_generate_gp_model_input(
        t, params=params)
    assert ti["params"] == ji["params"]
    assert ti["likelihood"]["gp"]["input_params"] == \
        ji["likelihood"]["gp"]["input_params"]
    jl, tl = (info["likelihood"]["gp"]["external"] for info in (ji, ti))
    pts = np.random.default_rng(8).uniform(bounds[:, 0], bounds[:, 1],
                                           size=(20, 2))
    got = np.array([tl(x=a, y=b) for a, b in pts])
    want = np.array([jl(x=a, y=b) for a, b in pts])
    finite = np.isfinite(want)
    assert finite.sum() >= 10
    np.testing.assert_array_equal(np.isfinite(got), finite)
    np.testing.assert_array_equal(got[~finite], want[~finite])
    np.testing.assert_allclose(got[finite], want[finite], rtol=1e-9)
