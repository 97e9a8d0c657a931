"""
End to end: gpry_tpu_torch's Runner (the default BatchOptimizer / LogExp /
CorrectCounter loop, at the default options with the convergence audit
and with options={"audit": False}) against gpry_tpu's Runner with the same
options and seed, on the CPU; plus the port's option defaults, import
boundary, device policy and explicit refusals.
"""

import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

sys.path.insert(0, str(Path(__file__).parent))
from model_generator import kl_truth_gaussian, random_gaussian  # noqa: E402

import gpry_tpu.run as jax_run  # noqa: E402
import gpry_tpu_torch.run as torch_run  # noqa: E402
from gpry_tpu_torch import config  # noqa: E402

config.set_device("cpu")
# tiny shapes: one intra-op thread, so that parallel test workers do
# not oversubscribe the cores
torch.set_num_threads(1)
KL_GATE = 0.05
REPO = Path(__file__).resolve().parent.parent


def _runners_match(d, **kwargs):
    """Both packages' Runners on the same Gaussian and seed: converged,
    KL(sample || truth) <= KL_GATE, truth evals within max(4, 25%)."""
    m = random_gaussian(d=d, rng=10 + d)
    out = {}
    for name, mod in (("torch", torch_run), ("jax", jax_run)):
        runner = mod.Runner(m.loglike, bounds=m.bounds, seed=1, verbose=1,
                            **kwargs)
        runner.run()
        X, w, _ = runner.last_mc_samples()
        kl = kl_truth_gaussian(X, w, m.mean, m.cov)
        assert runner.has_converged, name
        assert kl <= KL_GATE, f"{name}: KL={kl} > {KL_GATE} at d={d}"
        out[name] = runner.gpr.n_total
    band = max(4, 0.25 * out["jax"])
    assert abs(out["torch"] - out["jax"]) <= band, out


@pytest.mark.parametrize("d", [1, 2, 3])
def test_runner_matches_jax(d):
    _runners_match(d, options={"audit": False})


@pytest.mark.parametrize("d", [1, 2, 3])
def test_runner_defaults_match_jax(d):
    """``Runner(loglike, bounds)`` at the default options: the convergence
    audit runs at every declaration in both packages."""
    _runners_match(d)


def test_option_defaults_match_jax():
    """The port's option defaults (the audit's included) equal the JAX
    package's, and both Runners start with the same audit state."""
    m = random_gaussian(d=3, rng=13)
    j = jax_run.Runner(m.loglike, bounds=m.bounds, seed=0, verbose=0)
    t = torch_run.Runner(m.loglike, bounds=m.bounds, seed=0, verbose=0)
    assert t.options == j.options
    assert t.options["audit"] is True
    for attr in ("audit", "n_audit", "audit_rounds", "max_audit",
                 "audit_kappa", "audit_band_nstd", "_n_audited",
                 "_X_audit_hist", "_audit_calib", "_audit_dirty_vetoes"):
        assert getattr(t, attr) == getattr(j, attr), attr


def test_generate_mc_sample_and_progress():
    m = random_gaussian(d=2, rng=12)
    runner = torch_run.Runner(m.loglike, bounds=m.bounds, seed=3, verbose=0,
                              options={"audit": False})
    runner.run()
    s = runner.generate_mc_sample(add_options={"nlive": 60})
    assert runner.last_mc_result is s
    assert runner.mean is not None and runner.cov.shape == (2, 2)
    assert runner.diagnose_last_mc_sample()
    table = runner.progress.table
    assert table.shape == (runner.current_iteration, 11)
    assert np.all(np.isfinite(table[:, 2]))  # acquisition times
    assert runner.logp(m.mean[None]).shape == (1,)


def test_import_does_not_load_jax():
    code = ("import sys; import gpry_tpu_torch.run, gpry_tpu_torch.io, "
            "gpry_tpu_torch.parallel.executor, gpry_tpu_torch.mc.interfaces; "
            "bad = [m for m in sys.modules if m == 'jax' "
            "or m.startswith('jax.') or m.startswith('gpry_tpu.')] ; "
            "assert not bad, bad; print('ok')")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0 and out.stdout.strip() == "ok", out.stderr


def test_default_device_without_cuda_raises():
    """With no CUDA device, the default ("cuda") raises instead of moving
    to the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    env = dict(os.environ)
    env.pop("GPRY_TPU_TORCH_DEVICE", None)
    code = ("from gpry_tpu_torch import config\n"
            "try:\n    config.get_device()\n"
            "except RuntimeError as e:\n    print('raised', e)\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.stdout.startswith("raised"), out.stdout + out.stderr
    with pytest.raises(ValueError):
        config.set_device("mps")


@pytest.mark.parametrize("kwargs", [
    {"options": {"audit": False}, "plots": True},
    {"options": {"audit": False}, "truth_executor": "mpi"},
    {"options": {"audit": False}, "mc": "cobaya"},
    {"options": {"audit": False}, "truth_executor": {"mode": "mpi"}},
    {"options": {"audit": False}, "mc": "cobaya_mcmc"},
    {"options": {"audit": False}, "mc": {"cobaya_polychord": {}}},
])
def test_features_outside_the_slice_are_refused(kwargs):
    m = random_gaussian(d=2, rng=12)
    with pytest.raises(NotImplementedError,
                       match="ROADMAP.md §A, '(Plots|MPI|Cobaya)"):
        torch_run.Runner(m.loglike, bounds=m.bounds, seed=1, verbose=0,
                         **kwargs)


@pytest.mark.parametrize("kwargs", [
    {"gp_acquisition": {"NORA": {"sampler": "polychord"}}},
    {"checkpoint": "ckpt", "load_checkpoint": "overwrite"},
    {"mc": "polychord"},
    {"truth_executor": "processes"},
    {"gp_acquisition": {"BatchOptimizer": {"acq_optimizer": "sampling"}}},
])
def test_features_of_the_runner_slice_are_built(kwargs, tmp_path):
    """The features that earlier slices refused build now."""
    if "checkpoint" in kwargs:
        kwargs = dict(kwargs, checkpoint=str(tmp_path / "ckpt"))
    m = random_gaussian(d=2, rng=12)
    runner = torch_run.Runner(m.loglike, bounds=m.bounds, seed=1,
                              verbose=0, options={"audit": False}, **kwargs)
    runner.executor.shutdown()


def test_getdist_export_is_refused():
    m = random_gaussian(d=2, rng=12)
    runner = torch_run.Runner(m.loglike, bounds=m.bounds, seed=1,
                              verbose=0)
    runner.last_mc_result = {"X": np.zeros((2, 2)),
                             "weights": np.ones(2), "logpost": np.zeros(2)}
    with pytest.raises(NotImplementedError, match="getdist"):
        runner.last_mc_samples(as_getdist=True)
