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
construction.  The ``"mpi"`` mode is not ported yet (ROADMAP.md §A, "MPI").
"""

import multiprocessing
import os
import pickle
from concurrent.futures import ProcessPoolExecutor, ThreadPoolExecutor

import numpy as np

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
    mode : "serial" (default), "threads" or "processes"
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
        elif mode == "mpi":
            raise NotImplementedError(
                "truth_executor='mpi' is not ported to gpry_tpu_torch yet "
                "(ROADMAP.md §A, 'MPI').")
        elif mode != "serial":
            raise ValueError(f"Unknown executor mode '{mode}'.")

    def logp_batch(self, X):
        """Evaluate the truth at each row of X, returning an array."""
        X = np.atleast_2d(X)
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
