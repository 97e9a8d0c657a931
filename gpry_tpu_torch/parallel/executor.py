"""
Host-side truth evaluation (port of gpry_tpu/parallel/executor.py).

The only genuinely host-bound work of the loop is the user's likelihood.
It runs serially (``mode="serial"``, no overhead for a fast likelihood), in
a thread pool (``"threads"``, for a likelihood that waits on I/O or
releases the GIL) or in a process pool (``"processes"``, for a CPU-bound
one).

The process pool is started with the ``spawn`` method, never ``fork``: the
parent holds a live CUDA context, which a forked child would inherit in a
state it cannot use.  ``forkserver`` would serve too, but its server is
itself forked from the parent on first use; ``spawn`` starts each worker
from a fresh interpreter, on every platform.  A worker imports only what
the callable needs, so it never initializes CUDA.

The callable is sent to the workers once, serialized with ``cloudpickle``
where it imports (so a lambda or a closure crosses the process boundary)
and with the standard ``pickle`` otherwise; without ``cloudpickle`` a
callable that ``pickle`` cannot carry raises ``TypeError`` at
construction.

For truth evaluation over several hosts there is ``mode="mpi"``: under
``mpirun -n k`` rank 0 keeps driving the loop (single-controller) while
each ``logp_batch`` is split contiguously over all k ranks (the
decomposition of the reference's ``_eval_truth_parallel``,
gpry/run.py:1200-1236 and gpry/mpi.py:80-102); the other ranks run
:meth:`TruthExecutor.serve`, a command loop that evaluates their slice of
every broadcast batch until rank 0 sends a stop.  In a single-process
world the mode evaluates serially.
"""

import multiprocessing
import os
import pickle
from concurrent.futures import ProcessPoolExecutor, ThreadPoolExecutor

import numpy as np

from gpry_tpu_torch import mpi

# what a rank whose slice raised sends through the gather, with its message
_TRUTH_ERROR = "__truth_error__"

# Worker-side cache of deserialized callables, keyed by their payload
_WORKER_FNS = {}


def _serializer():
    """``cloudpickle`` where it imports, else the standard ``pickle``."""
    try:
        import cloudpickle
    except ImportError:
        return pickle
    return cloudpickle


def _call_pickled(payload, x):
    fn = _WORKER_FNS.get(payload)
    if fn is None:
        # cloudpickle's payloads load with the standard pickle
        fn = pickle.loads(payload)
        _WORKER_FNS[payload] = fn
    return fn(x)


class TruthExecutor:
    """
    Evaluate ``truth.logp`` over batches of points.

    Parameters
    ----------
    mode : "serial" (default), "threads", "processes" or "mpi"
    max_workers : int, optional (default: the CPU count, at most 32)
    """

    def __init__(self, truth, mode="serial", max_workers=None):
        self.truth = truth
        self.mode = mode
        self.max_workers = max_workers or min(32, (os.cpu_count() or 1))
        self._pool = None
        self._payload = None
        if mode == "threads":
            self._pool = ThreadPoolExecutor(max_workers=self.max_workers)
        elif mode == "processes":
            ser = _serializer()
            try:
                self._payload = ser.dumps(truth.logp)
            except (pickle.PicklingError, AttributeError, TypeError) as excpt:
                raise TypeError(
                    "truth_executor='processes' must send the likelihood "
                    f"to its workers, and {ser.__name__} cannot serialize "
                    f"it ({excpt}); cloudpickle is not installed, so the "
                    "callable must be a module-level function (not a "
                    "lambda or a closure), or use mode='threads'.") \
                    from excpt
            self._pool = ProcessPoolExecutor(
                max_workers=self.max_workers,
                mp_context=multiprocessing.get_context("spawn"))
        elif mode not in ("serial", "mpi"):
            raise ValueError(f"Unknown executor mode '{mode}'.")

    # -- the "mpi" mode -------------------------------------------------------

    def _eval_slice(self, X, rank, size):
        """This rank's contiguous slice of the batch, evaluated
        (reference decomposition: gpry/mpi.py:80-102)."""
        sizes = mpi.split_number_for_parallel_processes(len(X), size)
        offs = np.concatenate([[0], np.cumsum(sizes)])
        return [self.truth.logp(x) for x in X[offs[rank]:offs[rank + 1]]]

    def serve(self):
        """The command loop of a rank other than 0 under ``mode="mpi"``:
        evaluate this rank's slice of every broadcast batch until rank 0
        broadcasts a stop.  A slice that raises sends an error marker
        through the gather (rank 0 would otherwise wait in its gather for
        ever) and the rank keeps serving, so that later collectives stay
        aligned."""
        comm = mpi.mpi_comm
        while True:
            cmd = comm.bcast(None, root=0)
            if cmd is None or cmd[0] == "stop":
                break
            X = np.atleast_2d(cmd[1])
            try:
                res = self._eval_slice(X, mpi.RANK, mpi.SIZE)
            except Exception as excpt:  # noqa: BLE001 - the user's loglike
                res = (_TRUTH_ERROR, f"rank {mpi.RANK}: {excpt!r}")
            comm.gather(res, root=0)

    def stop_workers(self):
        """Release the serving ranks (on rank 0 only)."""
        if self.mode == "mpi" and mpi.multiple_processes \
                and mpi.is_main_process and mpi.mpi_comm is not None:
            mpi.mpi_comm.bcast(("stop",), root=0)

    def _logp_batch_mpi(self, X):
        comm = mpi.mpi_comm
        comm.bcast(("eval", X), root=0)
        # the gather completes even where this rank's slice raises (the
        # workers, past the bcast, wait in theirs); errors travel as
        # markers and raise here once the collective is done
        try:
            mine = self._eval_slice(X, mpi.RANK, mpi.SIZE)
        except Exception as excpt:  # noqa: BLE001 - the user's loglike
            mine = (_TRUTH_ERROR, f"rank 0: {excpt!r}")
        gathered = comm.gather(mine, root=0)
        errors = [g[1] for g in gathered
                  if isinstance(g, tuple) and len(g) == 2
                  and g[0] == _TRUTH_ERROR]
        if errors:
            raise RuntimeError("truth evaluation failed on: "
                               + "; ".join(errors))
        return np.concatenate([np.asarray(g, dtype=float) for g in gathered])

    def logp_batch(self, X):
        """Evaluate the truth at each row of X, returning an array."""
        X = np.atleast_2d(X)
        if self.mode == "mpi" and mpi.multiple_processes \
                and mpi.mpi_comm is not None:
            return self._logp_batch_mpi(X)
        if self._pool is None:
            return np.array([self.truth.logp(x) for x in X])
        if self._payload is not None:
            futures = [self._pool.submit(_call_pickled, self._payload, x)
                       for x in X]
        else:
            futures = [self._pool.submit(self.truth.logp, x) for x in X]
        return np.array([f.result() for f in futures])

    def shutdown(self):
        """Stop the pool's workers."""
        if self._pool is not None:
            self._pool.shutdown(wait=True)
            self._pool = None

    def __del__(self):  # pragma: no cover
        try:
            self.shutdown()
        except Exception:
            pass
