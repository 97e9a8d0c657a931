"""
End to end: gpry_tpu_torch's Runner (the default BatchOptimizer / LogExp /
CorrectCounter loop, at the default options with the convergence audit
and with options={"audit": False}) against gpry_tpu's Runner with the same
options and seed, on the CPU; plus the port's option defaults, import
boundary, device policy, the features of the Runner's later slices and
the small public helpers against gpry_tpu's.
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
            "gpry_tpu_torch.parallel.executor, gpry_tpu_torch.mc.interfaces, "
            "gpry_tpu_torch.mpi, gpry_tpu_torch.cobaya, "
            "gpry_tpu_torch.mc.cobaya_mc, gpry_tpu_torch.plots, "
            "gpry_tpu_torch.diag; "
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
    {"gp_acquisition": {"NORA": {"sampler": "polychord"}}},
    {"checkpoint": "ckpt", "load_checkpoint": "overwrite"},
    {"mc": "polychord"},
    {"truth_executor": "processes"},
    {"gp_acquisition": {"BatchOptimizer": {"acq_optimizer": "sampling"}}},
    {"plots": True},
    {"truth_executor": "mpi"},
    {"mc": "cobaya"},
    {"truth_executor": {"mode": "mpi"}},
    {"mc": "cobaya_mcmc"},
    {"mc": {"cobaya_polychord": {}}},
])
def test_features_of_the_runner_slice_are_built(kwargs, tmp_path):
    """The features that earlier slices refused build now, each in one
    process."""
    if "checkpoint" in kwargs:
        kwargs = dict(kwargs, checkpoint=str(tmp_path / "ckpt"))
    m = random_gaussian(d=2, rng=12)
    runner = torch_run.Runner(m.loglike, bounds=m.bounds, seed=1,
                              verbose=0, options={"audit": False}, **kwargs)
    runner.executor.shutdown()
    if "mpi" in str(kwargs.get("truth_executor")):
        assert runner.executor.mode == "mpi"


def test_getdist_export_needs_getdist(monkeypatch):
    """``last_mc_samples(as_getdist=True)`` raises ImportError naming
    getdist where getdist is missing, as gpry_tpu's does."""
    monkeypatch.setitem(sys.modules, "getdist", None)
    m = random_gaussian(d=2, rng=12)
    runner = torch_run.Runner(m.loglike, bounds=m.bounds, seed=1,
                              verbose=0)
    runner.last_mc_result = {"X": np.zeros((2, 2)),
                             "weights": np.ones(2), "logpost": np.zeros(2)}
    with pytest.raises(ImportError, match="getdist"):
        runner.last_mc_samples(as_getdist=True)


def _spd5():
    rng = np.random.default_rng(5)
    M = rng.normal(size=(5, 5))
    return M @ M.T + 5.0 * np.eye(5), rng.normal(size=(5, 2))


def _gp5():
    """Five points in 2-d, their values and a theta (log amp^2, log l)."""
    rng = np.random.default_rng(6)
    X = rng.uniform(-1.0, 1.0, (5, 2))
    y = np.sin(3.0 * X[:, 0]) + X[:, 1] ** 2
    theta = np.log([1.3 ** 2, 0.4, 0.6])
    return X, y, theta


def _quad_min(j, t):
    """A 2-d quadratic from three starts in [-2, 2]^2."""
    c, w = np.array([0.3, -0.7]), np.array([1.0, 4.0])
    lo, hi = np.full(2, -2.0), np.full(2, 2.0)
    x0s = np.array([[1.5, 1.5], [-1.0, 0.5], [0.0, -1.8]])
    jf = lambda x: j.numpy.sum(w * (x - c) ** 2)
    tf = lambda X: ((X - torch.as_tensor(c)) ** 2 * torch.as_tensor(w)
                    ).sum(-1)
    want = j.lbfgs.multistart_minimize(
        jf, j.numpy.asarray(x0s), j.numpy.asarray(lo), j.numpy.asarray(hi),
        count_evals=True)
    got = t.lbfgs.multistart_minimize(
        tf, torch.as_tensor(x0s), torch.as_tensor(lo), torch.as_tensor(hi),
        count_evals=True)
    two = t.lbfgs.multistart_minimize(
        tf, torch.as_tensor(x0s), torch.as_tensor(lo), torch.as_tensor(hi))
    assert len(two) == 2
    return want, got


def _helper_outputs(name):
    """(gpry_tpu's, the port's) outputs of one public helper on the same
    inputs."""
    import types
    import jax.numpy as jnp
    import gpry_tpu.native as jnative
    import gpry_tpu.ops as jops
    import gpry_tpu.ops.lbfgs as jlbfgs
    import gpry_tpu.ops.linalg as jlinalg
    import gpry_tpu_torch.native as tnative
    import gpry_tpu_torch.ops as tops
    import gpry_tpu_torch.ops.lbfgs as tlbfgs
    T = lambda a: torch.as_tensor(np.asarray(a, dtype=float))
    A, B = _spd5()
    X, y, theta = _gp5()
    if name == "masked_cholesky":
        return jops.masked_cholesky(jnp.asarray(A)), tops.masked_cholesky(T(A))
    if name == "solve_lower":
        L = np.linalg.cholesky(A)
        return ([jops.solve_lower(jnp.asarray(L), jnp.asarray(b))
                 for b in (B, B[:, 0])],
                [tops.solve_lower(T(L), T(b)) for b in (B, B[:, 0])])
    if name == "masked_lml":
        args = ("rbf", theta, X, y, 5, 1e-3)
        return (jops.masked_lml(*[jnp.asarray(a) if isinstance(a, np.ndarray)
                                  else a for a in args]),
                tops.masked_lml(*[T(a) if isinstance(a, np.ndarray) else a
                                  for a in args]))
    if name == "chol_append":
        # the factor of the first 3 points (identity padding), then 2 more
        X0, y0 = X.copy(), y.copy()
        X0[3:], y0[3:] = 0.0, 0.0
        L0 = np.eye(5)
        K3 = np.asarray(jlinalg.masked_kernel_matrix(
            "rbf", jnp.asarray(theta), jnp.asarray(X0), 3, 1e-3))
        L0[:3, :3] = np.linalg.cholesky(K3[:3, :3])
        args = ("rbf", theta, X0, y0, 3, 1e-3, L0, X[3:], y[3:])
        return (jops.chol_append(*[jnp.asarray(a) if isinstance(a, np.ndarray)
                                   else a for a in args]),
                tops.chol_append(*[T(a) if isinstance(a, np.ndarray) else a
                                   for a in args]))
    if name == "multistart_minimize":
        return _quad_min(types.SimpleNamespace(numpy=jnp, lbfgs=jlbfgs),
                         types.SimpleNamespace(lbfgs=tlbfgs))
    if name == "native_available":
        return jnative.available(), tnative.available()
    raise ValueError(name)


@pytest.mark.parametrize("name", ["masked_cholesky", "solve_lower",
                                  "masked_lml", "chol_append",
                                  "multistart_minimize", "native_available"])
def test_public_helpers_match_jax(name):
    """The port's small public helpers (``ops`` exports,
    ``ops.lbfgs.multistart_minimize``, ``native.available``) against
    gpry_tpu's on the same inputs: the linear algebra within rel 1e-12,
    the multi-start minimum within 1e-7 of the box."""
    want, got = _helper_outputs(name)
    if name == "native_available":
        assert want is True and got is True
        return
    if name == "multistart_minimize":
        (jx, jf, jn), (tx, tf, tn) = want, got
        np.testing.assert_allclose(tx.numpy(), np.asarray(jx), atol=1e-7)
        np.testing.assert_allclose(tf.numpy(), np.asarray(jf), atol=1e-12)
        np.testing.assert_array_equal(tn.numpy(), np.asarray(jn))
        return
    want = want if isinstance(want, (list, tuple)) else [want]
    got = got if isinstance(got, (list, tuple)) else [got]
    assert len(want) == len(got)
    for w, g in zip(want, got):
        g = g.numpy() if isinstance(g, torch.Tensor) else np.asarray(g)
        np.testing.assert_allclose(g, np.asarray(w), rtol=1e-12, atol=1e-13)
