"""
gpry_tpu_torch's checkpoints on the CPU (gpry_tpu_torch/io.py and the
Runner's checkpoint, resume and run_resilient): twins of tests/test_io.py,
the truth stored without an unpicklable callable, a pickle stream free of
torch, a gpry_tpu checkpoint carried into the port, and the retry rule of
run_resilient.
"""

import os
import pickle
import pickletools
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

sys.path.insert(0, str(Path(__file__).parent))
from model_generator import random_gaussian  # noqa: E402

from gpry_tpu_torch import config  # noqa: E402
from gpry_tpu_torch import io as gio  # noqa: E402
from gpry_tpu_torch import run as torch_run  # noqa: E402
from gpry_tpu_torch.run import Runner  # noqa: E402

config.set_device("cpu")
torch.set_num_threads(1)
#: a GP fit of few restarts keeps each Runner to seconds on the CPU
FAST_GPR = {"n_restarts_optimizer": 3}


def _inside_unit_disc(x):
    """A log-likelihood that is -inf outside the unit disc (module level:
    the standard pickle carries it)."""
    x = np.asarray(x)
    r2 = float(np.sum(x ** 2))
    return -0.5 * r2 / 0.25 if r2 < 1.0 else -np.inf


@pytest.mark.parametrize("criterion", ["CorrectCounter", "DontConverge"])
def test_checkpoint_resume(tmp_path, criterion):
    """tests/test_io.py:20: a finished run's checkpoint resumes with the
    same training set and predictions; the heartbeat and the final chain
    are written beside it."""
    m = random_gaussian(d=2, rng=3)
    ckpt = str(tmp_path / "ckpt")
    # a short budget for both criteria (the reference lets CorrectCounter
    # run to convergence): the resume is what is tested
    options = {"max_total": 16, "max_initial": 10}
    runner = Runner(m.loglike, bounds=m.bounds, seed=4, verbose=1,
                    gpr=FAST_GPR, convergence_criterion=criterion,
                    options=options, checkpoint=ckpt,
                    load_checkpoint="overwrite",
                    mc={"nested": {"nlive": "10d", "num_repeats": 2,
                                   "refine": False}})
    runner.run()
    n_before = runner.gpr.n
    X_train = np.copy(runner.gpr.X_train)
    y_train = np.copy(runner.gpr.y_train)
    y_at_train = runner.gpr.predict(X_train[:3])
    converged = runner.has_converged
    del runner

    assert np.all(gio.check_checkpoint(ckpt))
    assert os.path.exists(os.path.join(ckpt, "liveness.heartbeat"))
    assert os.path.exists(os.path.join(ckpt, "chains", "mc_samples.txt"))

    runner2 = Runner(m.loglike, bounds=m.bounds, seed=4, verbose=1,
                     checkpoint=ckpt, load_checkpoint="resume")
    assert runner2.gpr.n == n_before
    assert runner2.has_converged == converged
    assert np.allclose(runner2.gpr.X_train, X_train)
    assert np.allclose(runner2.gpr.y_train, y_train)
    assert np.allclose(runner2.gpr.predict(X_train[:3]), y_at_train,
                       atol=1e-10)


def test_checkpoint_resume_with_infinities(tmp_path):
    """tests/test_io.py:49: the classifier comes back and gates the
    predictions as before."""
    bounds = np.array([[-2.0, 2.0]] * 2)
    ckpt = str(tmp_path / "ckpt_inf")
    runner = Runner(_inside_unit_disc, bounds=bounds, seed=6, verbose=1,
                    gpr=FAST_GPR, options={"max_total": 30, "max_initial": 30},
                    convergence_criterion="DontConverge", mc="uniform",
                    checkpoint=ckpt, load_checkpoint="overwrite")
    runner.run()
    assert runner.gpr.n < runner.gpr.n_total
    Xq = np.array([[1.9, 1.9], [0.1, 0.0]])
    pred_before = runner.gpr.predict(Xq)
    del runner
    # a truth of a module-level function comes back from tru.pkl itself
    runner2 = Runner(checkpoint=ckpt, load_checkpoint="resume", verbose=1)
    assert runner2.truth._loglike_orig is _inside_unit_disc
    assert np.array_equal(runner2.gpr.predict(Xq), pred_before)
    assert runner2.gpr.predict(np.array([[1.9, 1.9]]))[0] == -np.inf


def test_ensure_gpr_roundtrip(tmp_path):
    """tests/test_io.py:75."""
    m = random_gaussian(d=2, rng=5)
    ckpt = str(tmp_path / "ckpt2")
    runner = Runner(m.loglike, bounds=m.bounds, seed=5, verbose=1,
                    gpr=FAST_GPR, options={"max_total": 15, "max_initial": 10},
                    convergence_criterion="DontConverge", mc="uniform",
                    checkpoint=ckpt, load_checkpoint="overwrite")
    runner.run()
    mu_direct = runner.gpr.predict(runner.gpr.X_train[:2])
    gpr2 = gio.ensure_gpr(ckpt)
    assert gio.ensure_gpr(gpr2) is gpr2
    assert np.array_equal(gpr2.predict(gpr2.X_train[:2]), mu_direct)
    # the factor comes back as stored, not refactorized
    assert torch.equal(gpr2._dL, runner.gpr._dL)
    assert torch.equal(gpr2._dalpha, runner.gpr._dalpha)


class _StopLoop(Exception):
    pass


def test_resume_equals_continuous(tmp_path):
    """tests/test_io.py:92: a run interrupted at iteration 3 and resumed
    equals the uninterrupted run (the checkpoint keeps the iteration
    counter, the RNG stream and the factor as it was)."""
    m = random_gaussian(d=2, rng=11)
    opts = {"max_total": 24, "max_initial": 12, "n_points_per_acq": 2}

    r_cont = Runner(m.loglike, bounds=m.bounds, seed=13, verbose=1,
                    gpr=FAST_GPR, options=opts,
                    convergence_criterion="DontConverge", mc="uniform",
                    checkpoint=str(tmp_path / "cont"),
                    load_checkpoint="overwrite")
    r_cont.run()

    def stop_at_3(runner):
        if runner.current_iteration == 3:
            raise _StopLoop

    r_int = Runner(m.loglike, bounds=m.bounds, seed=13, verbose=1,
                   gpr=FAST_GPR, options=opts,
                   convergence_criterion="DontConverge", mc="uniform",
                   callback=stop_at_3,
                   checkpoint=str(tmp_path / "int"),
                   load_checkpoint="overwrite")
    with pytest.raises(_StopLoop):
        r_int.run()
    n_at_interrupt = r_int.gpr.n_total
    del r_int

    r_res = Runner(m.loglike, bounds=m.bounds, verbose=1, mc="uniform",
                   checkpoint=str(tmp_path / "int"),
                   load_checkpoint="resume")
    assert r_res.current_iteration == 2
    assert r_res.gpr.n_total < n_at_interrupt
    r_res.run()

    np.testing.assert_allclose(r_res.gpr.X_train_all,
                               r_cont.gpr.X_train_all, rtol=1e-12)
    np.testing.assert_allclose(r_res.gpr.y_train_all,
                               r_cont.gpr.y_train_all, rtol=1e-12)
    np.testing.assert_allclose(r_res.gpr.kernel_theta,
                               r_cont.gpr.kernel_theta, rtol=1e-10)


def _small_gpr():
    from gpry_tpu_torch.models import GaussianProcessRegressor
    bounds = np.array([[-1.0, 1.0]] * 2)
    gpr = GaussianProcessRegressor(bounds=bounds, random_state=0)
    X = np.random.default_rng(0).uniform(-1, 1, (8, 2))
    gpr.append_to_data(X, -np.sum(X**2, axis=1))
    return gpr, X


def test_save_checkpoint_atomic_on_dump_failure(tmp_path):
    """tests/test_io.py:135: a dump that raises leaves the previous
    generation whole and loadable, no tmp file, and the live GPR as it
    was."""
    gpr, X = _small_gpr()
    ck = str(tmp_path / "atomic")
    truth = {"loglike": None}
    gio.save_checkpoint(ck, truth, gpr, "ACQ-GEN-1", "con", {"gen": 1},
                        "pro")
    assert np.all(gio.check_checkpoint(ck))
    assert not [f for f in os.listdir(ck) if f.endswith(".tmp")]
    mu = gpr.predict(X[:2])
    L = gpr._dL.clone()

    class Unpicklable:
        def __reduce__(self):
            raise TypeError("cannot pickle this")

    with pytest.raises(TypeError):
        gio.save_checkpoint(ck, truth, gpr, Unpicklable(), "con",
                            {"gen": 2}, "pro")
    assert not [f for f in os.listdir(ck) if f.endswith(".tmp")]
    with open(os.path.join(ck, "acq.pkl"), "rb") as f:
        assert pickle.load(f) == "ACQ-GEN-1"
    with open(os.path.join(ck, "opt.pkl"), "rb") as f:
        assert pickle.load(f) == {"gen": 1}
    assert isinstance(gpr._dL, torch.Tensor) and torch.equal(gpr._dL, L)
    assert np.array_equal(gpr.predict(X[:2]), mu)


def test_gpr_pickle_holds_no_torch_global(tmp_path):
    """gpr.pkl names no torch module or class: its tensors, device and
    dtype are stored as host values (so a checkpoint of the card loads on
    a CPU-only machine)."""
    gpr, X = _small_gpr()
    ck = str(tmp_path / "ck")
    gio.save_checkpoint(ck, {"loglike": None}, gpr, None, None, {}, None)
    with open(os.path.join(ck, "gpr.pkl"), "rb") as f:
        stream = f.read()
    strings = [arg for _, arg, _ in pickletools.genops(stream)
               if isinstance(arg, str)]
    modules = {w for s in strings for w in s.split()}
    assert "gpry_tpu_torch.io" in modules
    assert not [m for m in modules if m == "torch" or
                m.startswith("torch.") or m.startswith("torch ")]
    gpr2 = gio.ensure_gpr(ck)
    assert gpr2._device == config.get_device()
    assert gpr2._dtype is torch.float64
    assert np.array_equal(gpr2.predict(X), gpr.predict(X))


def test_lambda_loglike_writes_six_files_and_needs_loglike(tmp_path):
    """A truth whose callable the standard pickle cannot carry: all six
    files are written, tru.pkl flags the missing callable, and a resume
    needs ``loglike=``."""
    m = random_gaussian(d=2, rng=7)
    ckpt = str(tmp_path / "lam")
    loglike = lambda x: m.loglike(x)  # noqa: E731
    runner = Runner(loglike, bounds=m.bounds, seed=2, verbose=1,
                    gpr=FAST_GPR, options={"max_total": 12, "max_initial": 8},
                    convergence_criterion="DontConverge", mc="uniform",
                    checkpoint=ckpt, load_checkpoint="overwrite")
    runner.run()
    assert np.all(gio.check_checkpoint(ckpt))
    with open(os.path.join(ckpt, "tru.pkl"), "rb") as f:
        tru = pickle.load(f)
    assert tru["loglike"] is None and tru["loglike_pickled"] is False
    with pytest.raises(ValueError, match="loglike="):
        Runner(checkpoint=ckpt, load_checkpoint="resume", verbose=1)
    with pytest.raises(ValueError, match="loglike="):
        gio.read_checkpoint(ckpt)
    r2 = Runner(loglike, checkpoint=ckpt, load_checkpoint="resume",
                verbose=1)
    assert r2.truth._loglike_orig is loglike
    np.testing.assert_array_equal(r2.truth.bounds, m.bounds)
    assert r2.gpr.n_total == runner.gpr.n_total


def test_incomplete_checkpoint_and_bad_mode(tmp_path):
    """An incomplete checkpoint refuses to resume; a checkpoint needs a
    load_checkpoint mode."""
    gpr, _ = _small_gpr()
    ck = str(tmp_path / "part")
    gio.save_checkpoint(ck, {"loglike": None}, gpr, None, None, {}, None)
    os.remove(os.path.join(ck, "pro.pkl"))
    m = random_gaussian(d=2, rng=1)
    with pytest.raises(RuntimeError, match="Incomplete checkpoint"):
        Runner(m.loglike, bounds=m.bounds, checkpoint=ck,
               load_checkpoint="resume")
    with pytest.raises(ValueError, match="load_checkpoint"):
        Runner(m.loglike, bounds=m.bounds, checkpoint=ck)


def test_older_options_are_backfilled(tmp_path):
    """Options saved without the exploration and audit keys resume with
    the live defaults (gpry_tpu/run.py:360-385)."""
    m = random_gaussian(d=2, rng=9)
    ckpt = str(tmp_path / "old")
    runner = Runner(m.loglike, bounds=m.bounds, seed=3, verbose=1,
                    gpr=FAST_GPR, options={"max_total": 10, "max_initial": 8},
                    convergence_criterion="DontConverge", mc="uniform",
                    checkpoint=ckpt, load_checkpoint="overwrite")
    runner.run()
    path = os.path.join(ckpt, "opt.pkl")
    with open(path, "rb") as f:
        opt = pickle.load(f)
    dropped = ("max_starved_explore", "audit", "n_audit", "audit_rounds",
               "max_audit", "audit_kappa", "audit_band_nstd",
               "mode_weight_tol", "mode_stable_checks", "max_mode_vetoes",
               "amp_underfit_frac")
    for k in dropped:
        opt.pop(k)
    with open(path, "wb") as f:
        pickle.dump(opt, f)
    r2 = Runner(m.loglike, checkpoint=ckpt, load_checkpoint="resume",
                verbose=1)
    for k in dropped:
        assert getattr(r2, k) == getattr(runner, k), k


def test_cross_load_from_gpry_tpu(tmp_path):
    """A checkpoint that gpry_tpu wrote (with dill) carries into the port:
    its arrays, theta and preprocessing through ``load_numpy_state``, and
    both predict the same values."""
    from gpry_tpu import io as jax_io
    from gpry_tpu.models import GaussianProcessRegressor as JaxGPR
    from gpry_tpu.models.preprocessing import Normalize_bounds as JNB
    from gpry_tpu.models.preprocessing import Normalize_y as JNY
    from gpry_tpu_torch.models import GaussianProcessRegressor
    from gpry_tpu_torch.models.preprocessing import Normalize_bounds, \
        Normalize_y

    m = random_gaussian(d=2, rng=21)
    rng = np.random.default_rng(4)
    X = rng.uniform(m.bounds[:, 0], m.bounds[:, 1], (24, 2))
    y = m.loglike_batch(X)
    jgpr = JaxGPR(bounds=m.bounds, preprocessing_X=JNB(m.bounds),
                  preprocessing_y=JNY(), n_restarts_optimizer=4,
                  random_state=1)
    # factorized at its initial (prior-mean) hyperparameters: a
    # well-conditioned kernel, so that parity is limited by rounding, not
    # by cancellation in K^-1 y
    jgpr.append_to_data(X, y, fit_gpr=False)
    ck = str(tmp_path / "jax")
    jax_io.save_checkpoint(ck, {"loglike": None}, jgpr, None, None, {},
                           None)
    src = jax_io.ensure_gpr(ck)
    gpr = GaussianProcessRegressor(
        bounds=m.bounds, preprocessing_X=Normalize_bounds(m.bounds),
        preprocessing_y=Normalize_y(), random_state=1)
    svm = {k: v for k, v in vars(src.infinities_classifier).items()
           if k != "backend"}
    gpr.load_numpy_state(
        src.kernel_theta, src.X_train_all, src.y_train_all,
        src.preprocessing_X.loc, src.preprocessing_X.scale,
        src.preprocessing_y.mean_, src.preprocessing_y.std_, svm=svm)
    Xq = rng.uniform(m.bounds[:, 0], m.bounds[:, 1], (16, 2))
    mu_j, sd_j = src.predict(Xq, return_std=True)
    mu_t, sd_t = gpr.predict(Xq, return_std=True)
    np.testing.assert_allclose(mu_t, mu_j, rtol=1e-9)
    np.testing.assert_allclose(sd_t, sd_j, rtol=1e-9)


def _resilient_counted(monkeypatch, fail_at, error):
    """Count Runner constructions; the first run's callback raises
    ``error`` at iteration ``fail_at``."""
    built = {"n": 0}
    inner = torch_run.Runner.__init__

    def counting(self, *args, **kwargs):
        built["n"] += 1
        inner(self, *args, **kwargs)

    monkeypatch.setattr(torch_run.Runner, "__init__", counting)

    def callback(runner):
        if built["n"] == 1 and runner.current_iteration == fail_at:
            raise error
    return built, callback


def test_run_resilient_retries_oom(tmp_path, monkeypatch):
    """A CUDA out-of-memory error is retried once, from the checkpoint,
    in a fresh Runner that continues the run."""
    m = random_gaussian(d=2, rng=8)
    built, callback = _resilient_counted(
        monkeypatch, 1, torch.cuda.OutOfMemoryError("CUDA out of memory."))
    runner = torch_run.run_resilient(
        m.loglike, gpr=FAST_GPR, checkpoint=str(tmp_path / "res"),
        retry_wait_s=0,
        bounds=m.bounds, seed=3, verbose=1, callback=callback,
        options={"max_total": 12, "max_initial": 8},
        convergence_criterion="DontConverge", mc="uniform")
    assert built["n"] == 2
    assert runner._resumed and runner.gpr.n_total == 12


def test_run_resilient_raises_sticky_cuda_error(tmp_path, monkeypatch):
    """A sticky CUDA error propagates on the first attempt, saying to
    restart the process and resume."""
    m = random_gaussian(d=2, rng=8)
    built, callback = _resilient_counted(
        monkeypatch, 1, RuntimeError(
            "CUDA error: an illegal memory access was encountered"))
    with pytest.raises(RuntimeError, match="illegal memory access") as err:
        torch_run.run_resilient(
            m.loglike, gpr=FAST_GPR, checkpoint=str(tmp_path / "res"),
            retry_wait_s=0,
            bounds=m.bounds, seed=3, verbose=1, callback=callback,
            options={"max_total": 12, "max_initial": 8},
            convergence_criterion="DontConverge", mc="uniform")
    assert "load_checkpoint='resume'" in str(err.value)
    assert built["n"] == 1
    with pytest.raises(ValueError, match="checkpoint"):
        torch_run.run_resilient(m.loglike, bounds=m.bounds)
