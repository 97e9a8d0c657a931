"""
gpry_tpu_torch's MPI layer on the CPU (gpry_tpu_torch/mpi.py, the "mpi"
truth executor, the Runner's single-controller guard): twins of
tests/test_parallel.py:164, 272, 339, 373, 410, 446 and 493 and of
tests/test_round3.py:738, with a monkeypatched comm; the split helpers
against gpry_tpu's, exactly; the overwrite on a rank other than 0 and the
Progress sync once an iteration.
"""

import sys
from pathlib import Path

import numpy as np
import pytest
import torch

sys.path.insert(0, str(Path(__file__).parent))
from model_generator import random_gaussian  # noqa: E402

import gpry_tpu.mpi as jax_mpi  # noqa: E402
from gpry_tpu_torch import config  # noqa: E402
from gpry_tpu_torch import io as gio  # noqa: E402
from gpry_tpu_torch import mpi  # noqa: E402
from gpry_tpu_torch import run as run_mod  # noqa: E402
from gpry_tpu_torch.parallel.executor import TruthExecutor  # noqa: E402
from gpry_tpu_torch.run import Runner  # noqa: E402

config.set_device("cpu")
# tiny shapes: one intra-op thread, so that parallel test workers do
# not oversubscribe the cores
torch.set_num_threads(1)
# the Runners' fixture, cut for time: 2 fit restarts and the "uniform"
# final sample (the loop and the guard are what these tests hold)
SMALL = {"gpr": {"n_restarts_optimizer": 2}, "mc": "uniform"}


def _four_ranks(monkeypatch, comm, rank=0):
    """The mpi module's globals of rank ``rank`` in a 4-rank world."""
    monkeypatch.setattr(mpi, "multiple_processes", True)
    monkeypatch.setattr(mpi, "is_main_process", rank == 0)
    monkeypatch.setattr(mpi, "RANK", rank)
    monkeypatch.setattr(mpi, "SIZE", 4)
    monkeypatch.setattr(mpi, "mpi_comm", comm)


class _FakeComm4:
    """Rank 0's side of a 4-rank MPI world: rank 0 is this process; ranks
    1-3 evaluate their slices inside ``gather``, each through the port's
    own ``TruthExecutor._eval_slice`` on a truth of its own."""

    def __init__(self, worker_truths):
        self.cmds = []
        self.worker_truths = worker_truths  # rank -> truth-like object

    def bcast(self, value, root=0):
        self.cmds.append(value)
        return value

    def gather(self, value, root=0):
        cmd = self.cmds[-1]
        assert cmd[0] == "eval"
        X = np.atleast_2d(cmd[1])
        out = [value]
        for rank in (1, 2, 3):
            ex = TruthExecutor(self.worker_truths[rank], mode="serial")
            out.append(ex._eval_slice(X, rank, 4))
        return out


class _WorkerComm:
    """A rank other than 0: ``bcast`` hands out the queued commands,
    ``gather`` records what this rank sends."""

    def __init__(self, commands):
        self.commands = list(commands)
        self.gathered = []

    def bcast(self, value, root=0):
        return self.commands.pop(0)

    def gather(self, value, root=0):
        self.gathered.append(value)
        return None


class _CountingT:
    def __init__(self, fn=None):
        self.n = 0
        self.fn = fn

    def logp(self, x):
        self.n += 1
        if self.fn is not None:
            return self.fn(x)
        return -float(np.sum(np.asarray(x) ** 2))


def test_mpi_shim_single_process():
    """tests/test_parallel.py:164."""
    assert mpi.is_main_process and not mpi.multiple_processes
    assert mpi.bcast(42) == 42
    assert mpi.gather(3) == [3]
    assert mpi.allgather("x") == ["x"]
    assert mpi.scatter([7]) == 7
    np.testing.assert_array_equal(
        mpi.split_number_for_parallel_processes(10, 3), np.array([4, 3, 3]))
    np.testing.assert_array_equal(mpi.step_split(10, rank=1, n_proc=3),
                                  [1, 4, 7])
    parts = [mpi.step_split(10, rank=r, n_proc=3) for r in range(3)]
    merged = mpi.merge_step_split(*[np.arange(10)[p] for p in parts],
                                  n_proc=3)
    np.testing.assert_array_equal(merged, np.arange(10))
    out = mpi.multi_gather_array([np.arange(3), np.ones(2)])
    np.testing.assert_array_equal(out[0], np.arange(3))
    # one process: the seed's own stream, as gpry_tpu's
    a = mpi.get_random_generator(5).integers(1 << 30, size=4)
    b = jax_mpi.get_random_generator(5).integers(1 << 30, size=4)
    np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("size", [1, 2, 3, 4])
@pytest.mark.parametrize("n", [0, 1, 7, 10])
def test_split_helpers_match_jax(n, size):
    """The port's three split helpers equal gpry_tpu's exactly."""
    np.testing.assert_array_equal(
        mpi.split_number_for_parallel_processes(n, size),
        jax_mpi.split_number_for_parallel_processes(n, size))
    parts = []
    for rank in range(size):
        mine = mpi.step_split(n, rank=rank, n_proc=size)
        np.testing.assert_array_equal(
            mine, jax_mpi.step_split(n, rank=rank, n_proc=size))
        parts.append(np.arange(n, dtype=float)[mine] * 1.5)
    merged = mpi.merge_step_split(*parts, n_proc=size)
    want = jax_mpi.merge_step_split(*parts, n_proc=size)
    assert merged.dtype == want.dtype
    np.testing.assert_array_equal(merged, want)
    np.testing.assert_array_equal(merged, np.arange(n) * 1.5)


def test_per_rank_generators_match_jax(monkeypatch):
    """Under several ranks each rank's generator is the seed's spawned
    child of that rank, as gpry_tpu's."""
    for rank in range(3):
        for mod in (mpi, jax_mpi):
            monkeypatch.setattr(mod, "multiple_processes", True)
            monkeypatch.setattr(mod, "RANK", rank)
            monkeypatch.setattr(mod, "SIZE", 3)
        a = mpi.get_random_generator(11).integers(1 << 30, size=4)
        b = jax_mpi.get_random_generator(11).integers(1 << 30, size=4)
        np.testing.assert_array_equal(a, b)


def test_runner_nonroot_rank_waits(monkeypatch, tmp_path):
    """tests/test_parallel.py:272: a rank other than 0 does not run the
    loop; it waits at the barrier and re-syncs from the checkpoint."""
    m = random_gaussian(d=2, rng=9)
    ckpt = str(tmp_path / "mpi_ckpt")
    opts = {"max_total": 14, "max_initial": 10}
    r0 = Runner(m.loglike, bounds=m.bounds, seed=9, verbose=1, options=opts,
                convergence_criterion="DontConverge", checkpoint=ckpt,
                load_checkpoint="overwrite", **SMALL)
    r0.run()

    barriers = []
    monkeypatch.setattr(mpi, "multiple_processes", True)
    monkeypatch.setattr(mpi, "is_main_process", False)
    monkeypatch.setattr(mpi, "RANK", 1)
    monkeypatch.setattr(mpi, "sync_processes", lambda: barriers.append(1))
    truth_evals = {"n": 0}

    def counting_loglike(x):
        truth_evals["n"] += 1
        return m.loglike(x)

    r1 = Runner(counting_loglike, bounds=m.bounds, seed=9, verbose=1,
                options=opts, convergence_criterion="DontConverge",
                checkpoint=ckpt, load_checkpoint="resume", **SMALL)
    r1.current_iteration, r1.has_converged = 0, True
    r1.run()
    assert barriers == [1]               # waited at the barrier
    assert truth_evals["n"] == 0         # did not run the loop
    assert r1.gpr.n_total == r0.gpr.n_total  # re-synced from the checkpoint
    np.testing.assert_array_equal(r1.gpr.X_train_all, r0.gpr.X_train_all)
    # rank 0's loop state, from _runtime
    assert r1.current_iteration == r0.current_iteration
    assert r1.has_converged == r0.has_converged


def test_overwrite_on_a_nonroot_rank_keeps_the_checkpoint(monkeypatch,
                                                         tmp_path):
    """``load_checkpoint="overwrite"`` clears the checkpoint on the main
    process only (gpry_tpu/run.py:125-131): a rank that builds its Runner
    after rank 0's first saves leaves them alone."""
    m = random_gaussian(d=2, rng=9)
    ckpt = str(tmp_path / "ckpt")
    r0 = Runner(m.loglike, bounds=m.bounds, seed=9, verbose=0,
                options={"max_total": 10, "max_initial": 8},
                convergence_criterion="DontConverge", checkpoint=ckpt,
                load_checkpoint="overwrite", **SMALL)
    r0.run()
    assert all(gio.check_checkpoint(ckpt))
    monkeypatch.setattr(mpi, "multiple_processes", True)
    monkeypatch.setattr(mpi, "is_main_process", False)
    monkeypatch.setattr(mpi, "RANK", 2)
    Runner(m.loglike, bounds=m.bounds, seed=9, verbose=0, checkpoint=ckpt,
           load_checkpoint="overwrite")
    assert all(gio.check_checkpoint(ckpt))
    # on the main process it clears
    monkeypatch.setattr(mpi, "is_main_process", True)
    monkeypatch.setattr(mpi, "RANK", 0)
    Runner(m.loglike, bounds=m.bounds, seed=9, verbose=0, checkpoint=ckpt,
           load_checkpoint="overwrite")
    assert not any(gio.check_checkpoint(ckpt))


def test_mpi_truth_executor_distributes_4way(monkeypatch):
    """tests/test_parallel.py:339: a batch is split contiguously over the
    4 ranks and put back together in order."""
    worker_truths = {r: _CountingT() for r in (1, 2, 3)}
    comm = _FakeComm4(worker_truths)
    _four_ranks(monkeypatch, comm)
    t0 = _CountingT()
    ex = TruthExecutor(t0, mode="mpi")
    X = np.random.default_rng(0).normal(size=(10, 3))
    out = ex.logp_batch(X)
    np.testing.assert_allclose(out, [-np.sum(x**2) for x in X])
    # 10 points over 4 ranks: [3, 3, 2, 2]
    assert t0.n == 3
    assert [worker_truths[r].n for r in (1, 2, 3)] == [3, 2, 2]
    assert comm.cmds[0][0] == "eval"


def test_mpi_executor_worker_serves(monkeypatch):
    """tests/test_parallel.py:373: a worker evaluates its slice of every
    broadcast batch until the stop."""
    X = np.arange(20, dtype=float).reshape(10, 2)
    comm = _WorkerComm([("eval", X), ("stop",)])
    _four_ranks(monkeypatch, comm, rank=2)
    ex = TruthExecutor(_CountingT(lambda x: float(x[0])), mode="mpi")
    ex.serve()
    # rank 2 of 4 over 10 items: offsets [0, 3, 6, 8, 10] -> rows 6, 7
    assert comm.gathered == [[12.0, 14.0]]


def test_mpi_executor_error_raises_after_gather(monkeypatch):
    """tests/test_parallel.py:410: an error in rank 0's own slice still
    completes the gather, then raises."""
    comm = _FakeComm4({r: _CountingT() for r in (1, 2, 3)})
    gathers = []
    inner = comm.gather
    comm.gather = lambda v, root=0: (gathers.append(v),
                                     inner(v, root=root))[1]
    _four_ranks(monkeypatch, comm)

    def boom(x):
        raise RuntimeError("user loglike exploded")

    ex = TruthExecutor(_CountingT(boom), mode="mpi")
    X = np.random.default_rng(0).normal(size=(10, 3))
    with pytest.raises(RuntimeError, match="rank 0.*exploded"):
        ex.logp_batch(X)
    assert len(gathers) == 1
    assert gathers[0][0] == "__truth_error__"


def test_mpi_executor_worker_serves_through_error(monkeypatch):
    """tests/test_parallel.py:446: a worker whose slice raises sends an
    error marker through the gather and keeps serving."""
    X = np.arange(20, dtype=float).reshape(10, 2)
    comm = _WorkerComm([("eval", X), ("eval", X), ("stop",)])
    _four_ranks(monkeypatch, comm, rank=2)
    calls = {"n": 0}

    def flaky(x):
        calls["n"] += 1
        if calls["n"] == 1:
            raise ValueError("bad point")
        return float(x[0])

    ex = TruthExecutor(_CountingT(flaky), mode="mpi")
    ex.serve()
    assert len(comm.gathered) == 2
    assert comm.gathered[0][0] == "__truth_error__"
    assert "rank 2" in comm.gathered[0][1]
    assert comm.gathered[1] == [12.0, 14.0]


def test_runner_mpi_executor_end_to_end(monkeypatch):
    """tests/test_parallel.py:493: the loop stays on rank 0, every truth
    batch is split 4 ways, and the loop's end releases the workers."""
    m = random_gaussian(d=2, rng=12)
    worker_truths = {r: _CountingT(m.loglike) for r in (1, 2, 3)}
    comm = _FakeComm4(worker_truths)
    _four_ranks(monkeypatch, comm)
    syncs = []
    monkeypatch.setattr(mpi, "sync_processes", lambda: syncs.append(1))
    root_evals = {"n": 0}

    def loglike(x):
        root_evals["n"] += 1
        return m.loglike(x)

    runner = Runner(loglike, bounds=m.bounds, seed=12, verbose=1,
                    truth_executor="mpi",
                    options={"max_total": 16, "max_initial": 12,
                             "n_points_per_acq": 4},
                    convergence_criterion="DontConverge", **SMALL)
    runner.run()
    worker_n = sum(t.n for t in worker_truths.values())
    assert worker_n > 0
    assert root_evals["n"] < runner.gpr.n_total
    assert root_evals["n"] + worker_n == runner.gpr.n_total
    assert comm.cmds[-1] == ("stop",)
    assert syncs == [1]


def test_mpi_runner_equals_the_serial_runner(monkeypatch):
    """Where a slice is evaluated changes no value: the Runner under the
    4-rank comm has the serial Runner's training set, bit for bit."""
    m = random_gaussian(d=2, rng=12)
    kw = dict(bounds=m.bounds, seed=12, verbose=0,
              options={"max_total": 14, "max_initial": 10,
                       "n_points_per_acq": 3},
              convergence_criterion="DontConverge", **SMALL)
    serial = Runner(m.loglike, **kw).run()
    comm = _FakeComm4({})
    _four_ranks(monkeypatch, comm)
    monkeypatch.setattr(mpi, "sync_processes", lambda: None)
    split = Runner(m.loglike, truth_executor="mpi", **kw)
    # every rank evaluates the Runner's own truth (its prior included)
    comm.worker_truths = {r: split.truth for r in (1, 2, 3)}
    split.run()
    assert len(comm.cmds) > 2
    np.testing.assert_array_equal(split.gpr.X_train_all,
                                  serial.gpr.X_train_all)
    np.testing.assert_array_equal(split.gpr.y_train_all,
                                  serial.gpr.y_train_all)
    np.testing.assert_array_equal(split.gpr.kernel_theta,
                                  serial.gpr.kernel_theta)


def test_retryable_crash_keeps_mpi_workers_serving(monkeypatch):
    """tests/test_round3.py:738, with the port's retry rule: a CUDA
    out-of-memory error (run_resilient retries it) leaves the workers
    serving; an error that is not retried, a sticky CUDA error among them,
    releases them."""
    m = random_gaussian(d=2, rng=21)
    runner = Runner(m.loglike, bounds=m.bounds, seed=21, verbose=0,
                    options={"max_total": 8}, **SMALL)
    stopped, synced = [], []
    runner.executor.mode = "mpi"
    monkeypatch.setattr(runner.executor, "stop_workers",
                        lambda: stopped.append(1))
    monkeypatch.setattr(mpi, "multiple_processes", True)
    monkeypatch.setattr(mpi, "is_main_process", True)
    monkeypatch.setattr(mpi, "sync_processes", lambda: synced.append(1))

    def crash(excpt):
        def loop(self):
            raise excpt
        monkeypatch.setattr(run_mod.Runner, "_run_main_loop", loop)

    crash(torch.cuda.OutOfMemoryError("CUDA out of memory. Tried to "
                                      "allocate 2.00 GiB"))
    with pytest.raises(torch.cuda.OutOfMemoryError):
        runner._run_mpi_guarded()
    assert stopped == [] and synced == []   # left serving for the retry

    crash(ValueError("user-code bug"))
    with pytest.raises(ValueError):
        runner._run_mpi_guarded()
    assert stopped == [1] and synced == [1]  # released: no retry comes

    crash(RuntimeError("CUDA error: an illegal memory access was "
                       "encountered"))
    with pytest.raises(RuntimeError):
        runner._run_mpi_guarded()
    assert stopped == [1, 1] and synced == [1, 1]


def test_retry_rule_is_run_resilients():
    """One predicate decides for both: run_resilient retries what leaves
    the workers serving."""
    oom = torch.cuda.OutOfMemoryError("CUDA out of memory.")
    assert run_mod.is_retryable_cuda_error(oom)
    assert not run_mod.is_retryable_cuda_error(ValueError("x"))
    assert not run_mod.is_retryable_cuda_error(
        RuntimeError("CUDA error: unspecified launch failure"))


def test_progress_sync_once_an_iteration(monkeypatch):
    """The loop calls ``progress.mpi_sync()`` before each iteration's save
    (gpry_tpu/run.py:873)."""
    from gpry_tpu_torch.progress import Progress
    calls = []
    monkeypatch.setattr(Progress, "mpi_sync",
                        lambda self: calls.append(len(self.table)))
    m = random_gaussian(d=2, rng=9)
    runner = Runner(m.loglike, bounds=m.bounds, seed=9, verbose=0,
                    options={"max_total": 12, "max_initial": 8,
                             "n_points_per_acq": 2},
                    convergence_criterion="DontConverge", **SMALL).run()
    assert runner.current_iteration >= 2
    assert calls == list(range(1, runner.current_iteration + 1))
