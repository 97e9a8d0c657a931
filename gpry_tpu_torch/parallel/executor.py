"""
Host-side truth evaluation.

The only genuinely host-bound work of the loop is the user's likelihood.
The port evaluates it serially; the JAX package's thread, process and MPI
modes (gpry_tpu/parallel/executor.py) are not ported yet.
"""

import numpy as np


class TruthExecutor:
    """Evaluate ``truth.logp`` over batches of points (``mode="serial"``)."""

    def __init__(self, truth, mode="serial"):
        if mode != "serial":
            raise NotImplementedError(
                f"truth_executor={mode!r} is not ported yet; only 'serial' "
                "is (ROADMAP.md §A, 'periphery': parallel/executor.py).")
        self.truth = truth
        self.mode = mode

    def logp_batch(self, X):
        """Evaluate the truth at each row of X, returning an array."""
        return np.array([self.truth.logp(x) for x in np.atleast_2d(X)])
