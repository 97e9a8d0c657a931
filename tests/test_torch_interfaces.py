"""
gpry_tpu_torch's nested-sampler adapters on the CPU (gpry_tpu_torch/mc/
interfaces.py): twins of tests/test_ns_interfaces.py:59-137 against the
API doubles of tests/minins.py (each adapter end to end on an analytic 2-d
Gaussian: directly, through mc_sample_from_gp and through NORA's host
route), the fallback chain to the device sampler, and the registry's
strictness (tests/test_round3.py:527-549).
"""

import os
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

sys.path.insert(0, str(Path(__file__).parent))
import minins  # noqa: E402

from gpry_tpu_torch import config  # noqa: E402
from gpry_tpu_torch.mc import interfaces as ifc  # noqa: E402
from gpry_tpu_torch.mc.interfaces import (InterfaceDevice,  # noqa: E402
                                          _ns_interfaces,
                                          init_nested_sampler)

config.set_device("cpu")
torch.set_num_threads(1)

BOUNDS = np.array([[-2.0, 2.0], [-2.0, 2.0]])
MEAN = np.array([0.3, -0.4])
STD = np.array([0.25, 0.35])


def gauss_logp(X):
    X = np.atleast_2d(X)
    return -0.5 * np.sum(((X - MEAN) / STD) ** 2, axis=-1)


def check_moments(out, atol_mean=0.08, rtol_std=0.35):
    X = np.asarray(out["X"])
    w = np.asarray(out["weights"], dtype=float)
    assert len(X) == len(w) == len(out["logpost"])
    assert np.all(w >= 0) and w.max() > 0
    mean = np.average(X, axis=0, weights=w)
    var = np.average((X - mean) ** 2, axis=0, weights=w)
    assert np.allclose(mean, MEAN, atol=atol_mean), (mean, MEAN)
    assert np.allclose(np.sqrt(var), STD, rtol=rtol_std), (np.sqrt(var), STD)
    assert np.isfinite(out["logZ"])


@pytest.fixture
def no_ns_packages():
    minins.uninstall()
    yield
    minins.uninstall()


@pytest.mark.parametrize("name,install", [
    ("polychord", minins.install_polychord),
    ("ultranest", minins.install_ultranest),
    ("nessai", minins.install_nessai),
])
def test_host_adapter_runs(name, install, tmp_path, no_ns_packages):
    install()
    iface = _ns_interfaces[name](verbose=1, out_dir=str(tmp_path / name))
    iface.set_prior(BOUNDS, params=["a", "b"])
    iface.set_precision(nlive=80, num_repeats=10, precision_criterion=0.01,
                        nprior=160, seed=7)
    out = iface.run(gauss_logp)
    check_moments(out)
    logZ_true = np.log(2 * np.pi * STD.prod()) - np.log(16.0)
    assert abs(out["logZ"] - logZ_true) < 1.0
    iface.delete_output()


def test_device_adapter_runs_a_host_callable():
    """The port's own sampler behind the same contract, on a host
    log-density."""
    iface = InterfaceDevice(rng=3)
    iface.set_prior(BOUNDS)
    iface.set_precision(nlive=80, num_repeats=4, precision_criterion=0.01)
    out = iface.run(gauss_logp)
    check_moments(out)
    assert out["n_calls"] > 0


def test_import_error_without_packages(no_ns_packages):
    for name in ("polychord", "ultranest", "nessai"):
        with pytest.raises(ImportError):
            _ns_interfaces[name]()


def test_fallback_chain_reaches_device(no_ns_packages):
    with pytest.warns(UserWarning, match="falling back to 'device'"):
        iface = init_nested_sampler("polychord")
    assert isinstance(iface, InterfaceDevice)


def test_fallback_chain_prefers_installed(no_ns_packages):
    minins.install_ultranest()
    with pytest.warns(UserWarning, match="falling back to 'ultranest'"):
        iface = init_nested_sampler("polychord")
    assert type(iface).__name__ == "InterfaceUltraNest"


def test_init_nested_sampler_unknown_name_raises():
    with pytest.raises(ValueError, match="Unknown nested sampler"):
        init_nested_sampler("polychrod")


def test_init_nested_sampler_fallback_warns(monkeypatch):
    class _Unimportable(InterfaceDevice):
        def __init__(self, **kw):
            raise ImportError("not installed")

    monkeypatch.setattr(ifc, "_ns_interfaces", dict(
        ifc._ns_interfaces, polychord=_Unimportable,
        ultranest=_Unimportable))
    with pytest.warns(UserWarning, match="falling back to 'device'"):
        iface = ifc.init_nested_sampler("polychord")
    assert isinstance(iface, InterfaceDevice)


@pytest.fixture(scope="module")
def fitted_gpr():
    """One GPR fitted to the analytic Gaussian, shared by the tests below
    (none of them changes its training set)."""
    from gpry_tpu_torch.models.gp import GaussianProcessRegressor
    from gpry_tpu_torch.models.preprocessing import Normalize_bounds, \
        Normalize_y
    X = np.random.default_rng(42).uniform(BOUNDS[:, 0], BOUNDS[:, 1],
                                          size=(30, 2))
    y = gauss_logp(X)
    gpr = GaussianProcessRegressor(
        bounds=BOUNDS, preprocessing_X=Normalize_bounds(BOUNDS),
        preprocessing_y=Normalize_y(), n_restarts_optimizer=6,
        random_state=3)
    gpr.append_to_data(X, y, fit_gpr={"n_restarts": 6})
    return gpr


def test_mc_sample_from_gp_host_engine(rng, fitted_gpr, no_ns_packages):
    minins.install_ultranest()
    from gpry_tpu_torch.mc.samples import mc_sample_from_gp
    gpr = fitted_gpr
    n_eval_before = gpr.n_eval
    out = mc_sample_from_gp(gpr, sampler="ultranest", rng=rng,
                            options={"nlive": 80})
    check_moments(out, atol_mean=0.12, rtol_std=0.5)
    assert gpr.n_eval > n_eval_before
    with pytest.raises(ImportError):
        mc_sample_from_gp(gpr, sampler="nessai", rng=rng)


def test_nora_host_engine_route(rng, fitted_gpr, tmp_path, no_ns_packages):
    minins.install_polychord()
    cwd = os.getcwd()
    os.chdir(tmp_path)  # the double writes ./polychord_out
    try:
        from gpry_tpu_torch.acquisition.nora import NORA
        gpr = fitted_gpr
        nora = NORA(BOUNDS, sampler="polychord", nlive_max=80,
                    num_repeats=10, rng=rng)
        X_out, y_lies, acq_out = nora.multi_add(gpr, n_points=3)
        assert X_out.shape == (3, 2)
        assert np.all(np.isfinite(y_lies))
        assert np.all((X_out >= BOUNDS[:, 0]) & (X_out <= BOUNDS[:, 1]))
        X_mc, logp_mc, w_mc = nora.last_MC_sample()
        assert len(X_mc) > 100
        assert nora.mean is not None
        assert np.allclose(nora.mean, MEAN, atol=0.15)
    finally:
        os.chdir(cwd)


def test_nora_host_engine_falls_back_to_device(rng, fitted_gpr,
                                               no_ns_packages):
    """sampler='polychord' with nothing installed runs the device sampler
    (the reference's fallback chain, gpry/gp_acquisition.py:650-682)."""
    from gpry_tpu_torch.acquisition.nora import NORA
    gpr = fitted_gpr
    nora = NORA(BOUNDS, sampler="polychord", nlive_max=50, rng=rng)
    with pytest.warns(UserWarning, match="falling back to 'device'"):
        X_out, _, _ = nora.multi_add(gpr, n_points=2)
    assert X_out.shape == (2, 2)
