"""
gpry_tpu_torch's truth executors on the CPU (gpry_tpu_torch/parallel/
executor.py): twins of tests/test_parallel.py:108, 124, 146 and 250, the
process pool's start method, the serializer without cloudpickle, and an
unknown mode's refusal.
"""

import pickle
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from gpry_tpu_torch import config
from gpry_tpu_torch.parallel import executor as executor_module
from gpry_tpu_torch.parallel.executor import TruthExecutor

config.set_device("cpu")
torch.set_num_threads(1)


def _runner_and_model():
    """The Runner and a test model, imported here and not at the top: a
    spawned worker that unpickles ``_T`` imports this module, and should
    not pay for the Runner and scipy."""
    sys.path.insert(0, str(Path(__file__).parent))
    from model_generator import random_gaussian
    from gpry_tpu_torch.run import Runner
    return Runner, random_gaussian(d=2, rng=8)


class _T:
    """A truth whose logp the standard pickle carries."""

    def logp(self, x):
        return -float(np.sum(np.asarray(x) ** 2))


def _minus_sq(x):
    return -float(np.sum(np.asarray(x) ** 2))


@pytest.mark.parametrize("mode", ["serial", "threads", "processes"])
def test_truth_executor_modes(mode):
    """tests/test_parallel.py:108, with the process pool too."""
    X = np.random.default_rng(0).normal(size=(10, 3))
    expected = np.array([-np.sum(x**2) for x in X])
    ex = TruthExecutor(_T(), mode=mode, max_workers=1)
    try:
        out = ex.logp_batch(X)
    finally:
        ex.shutdown()
    np.testing.assert_allclose(out, expected)


def test_process_pool_is_spawned(monkeypatch):
    """The pool starts its workers with ``spawn``, so that none inherits
    the parent's CUDA context; a Truth of a module-level function crosses
    with the standard pickle (its payload evaluated here, as a worker
    does)."""
    from gpry_tpu_torch.truth import Truth
    monkeypatch.setattr(executor_module, "_serializer", lambda: pickle)
    truth = Truth(_minus_sq, np.array([[-3.0, 3.0]] * 2))
    ex = TruthExecutor(truth, mode="processes", max_workers=1)
    try:
        assert ex._pool._mp_context.get_start_method() == "spawn"
        out = [executor_module._call_pickled(ex._payload, x)
               for x in np.array([[1.0, 2.0], [0.0, 4.0]])]
    finally:
        ex.shutdown()
    np.testing.assert_allclose(out, [-5.0 - truth.log_prior_volume,
                                     -np.inf])


def test_runner_truth_executor_dict_spec():
    """tests/test_parallel.py:124: {"mode": ..., "max_workers": ...} and
    {"<mode>": {kwargs}} specs."""
    Runner, m = _runner_and_model()
    r1 = Runner(m.loglike, bounds=m.bounds, seed=8, verbose=0,
                truth_executor={"mode": "threads", "max_workers": 3})
    assert r1.executor.mode == "threads" and r1.executor.max_workers == 3
    r1.executor.shutdown()
    r2 = Runner(m.loglike, bounds=m.bounds, seed=8, verbose=0,
                truth_executor={"threads": {"max_workers": 2}})
    assert r2.executor.mode == "threads" and r2.executor.max_workers == 2
    r2.executor.shutdown()


def test_runner_with_thread_executor():
    """tests/test_parallel.py:146: the loop runs with a thread pool."""
    Runner, m = _runner_and_model()
    runner = Runner(m.loglike, bounds=m.bounds, seed=8, verbose=1,
                    truth_executor="threads", mc="uniform",
                    gpr={"n_restarts_optimizer": 3},
                    options={"max_total": 16, "max_initial": 10},
                    convergence_criterion="DontConverge")
    runner.run()
    runner.executor.shutdown()
    assert runner.gpr.n_total >= 14


def test_process_executor_with_closure():
    """tests/test_parallel.py:250: a lambda over a closure crosses to the
    workers through cloudpickle."""
    pytest.importorskip("cloudpickle")
    offset = np.array([1.5, -0.5, 0.25])

    class _Local:
        pass

    t = _Local()
    t.logp = lambda x: -float(np.sum((np.asarray(x) - offset) ** 2))
    X = np.random.default_rng(1).normal(size=(6, 3))
    expected = np.array([-np.sum((x - offset) ** 2) for x in X])
    ex = TruthExecutor(t, mode="processes", max_workers=2)
    try:
        out = ex.logp_batch(X)
    finally:
        ex.shutdown()
    np.testing.assert_allclose(out, expected)


def test_closure_without_cloudpickle_raises(monkeypatch):
    """Where cloudpickle does not import, the standard pickle serializes
    the callable, and a closure raises TypeError at construction, saying
    why."""
    monkeypatch.setattr(executor_module, "_serializer", lambda: pickle)
    offset = 1.0
    t = _T()
    t.logp = lambda x: -float(np.sum(np.asarray(x) - offset))
    with pytest.raises(TypeError, match="cloudpickle is not installed"):
        TruthExecutor(t, mode="processes", max_workers=1)
    ex = TruthExecutor(_T(), mode="processes", max_workers=1)
    assert ex._payload is not None
    ex.shutdown()


def test_mpi_and_unknown_modes_are_refused():
    """An unknown mode is refused.  The "mpi" mode, refused until it was
    ported, now builds, and in a single-process world evaluates serially
    (its ranks are held in tests/test_torch_mpi.py)."""
    ex = TruthExecutor(_T(), mode="mpi")
    X = np.random.default_rng(0).normal(size=(4, 3))
    np.testing.assert_array_equal(ex.logp_batch(X),
                                  [-np.sum(x**2) for x in X])
    with pytest.raises(ValueError, match="Unknown executor mode"):
        TruthExecutor(_T(), mode="fibers")
