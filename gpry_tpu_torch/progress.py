"""
Per-iteration telemetry.

Reference surface: gpry/progress.py (284 LoC) — a pandas table with one row
per iteration (sizes, timings, eval counts, convergence value), plus Timer
context managers.  TimerCounter additionally diffs the GPR's eval counters
(reference: gpry/progress.py:257-285).  The ``mpi_sync`` reductions are
no-ops in the single-controller design (API kept).

The table is kept as a float array; pandas is imported only by ``data``,
which returns it as a DataFrame.
"""

from time import perf_counter

import numpy as np

_COLUMNS = (
    "n_total", "n_finite",
    "time_acquire", "evals_acquire",
    "time_truth", "evals_truth",
    "time_fit", "evals_fit",
    "time_convergence", "evals_convergence",
    "convergence_crit_value",
)


class Progress:
    """Per-iteration progress table (reference: gpry/progress.py:11-173)."""

    def __init__(self):
        self.table = np.empty((0, len(_COLUMNS)))

    @property
    def data(self):
        """The table as a pandas DataFrame."""
        import pandas as pd
        return pd.DataFrame(self.table, columns=list(_COLUMNS))

    def _set(self, col, value):
        self.table[-1, _COLUMNS.index(col)] = value

    def _get(self, col):
        return self.table[-1, _COLUMNS.index(col)]

    def add_iteration(self):
        self.table = np.vstack([self.table, np.full(len(_COLUMNS), np.nan)])

    def add_current_n_truth(self, n_total, n_finite):
        self._set("n_total", n_total)
        self._set("n_finite", n_finite)

    def add_acquisition(self, timer):
        self._add_timed("acquire", timer)

    def add_truth(self, timer, n_evals=None, accumulate=False):
        self._add_timed("truth", timer, n_evals, accumulate)

    def add_fit(self, timer, accumulate=False):
        self._add_timed("fit", timer, accumulate=accumulate)

    def add_convergence(self, timer, value=np.nan):
        self._add_timed("convergence", timer)
        self._set("convergence_crit_value", value)

    def _add_timed(self, phase, timer, n_evals=None, accumulate=False):
        # accumulate=True sums into the current iteration's row (a phase
        # that legitimately runs twice in one iteration, e.g. the
        # flat-surrogate exploration refit after the main fit)
        tcol, ecol = f"time_{phase}", f"evals_{phase}"
        evals = n_evals if n_evals is not None else \
            getattr(timer, "evals", np.nan)
        if accumulate:
            prev_t, prev_e = self._get(tcol), self._get(ecol)
            self._set(tcol, prev_t + timer.time if np.isfinite(prev_t)
                      else timer.time)
            # sum when both are finite; otherwise keep whichever is finite
            if np.isfinite(prev_e) and np.isfinite(evals):
                evals = prev_e + evals
            elif np.isfinite(prev_e):
                evals = prev_e
            self._set(ecol, evals)
            return
        self._set(tcol, timer.time)
        self._set(ecol, evals)

    def mpi_sync(self):
        """No-op (single-controller); kept for API parity."""

    def bcast_last_max_timers(self, *args, **kwargs):
        """No-op; kept for API parity."""
        return {}

    def plot_timing(self, truth=True, save=None, show=False):
        """Stacked-bar timing plot (reference: gpry/progress.py:176-239)."""
        import matplotlib
        matplotlib.use("Agg", force=False)
        import matplotlib.pyplot as plt
        cols = ["time_acquire", "time_fit", "time_convergence"]
        if truth:
            cols.insert(1, "time_truth")
        fig, ax = plt.subplots(figsize=(8, 4.5))
        bottom = np.zeros(len(self.table))
        x = np.arange(len(self.table))
        for col in cols:
            vals = np.nan_to_num(self.table[:, _COLUMNS.index(col)])
            ax.bar(x, vals, bottom=bottom, label=col[len("time_"):])
            bottom += vals
        ax.set_xlabel("iteration")
        ax.set_ylabel("time (s)")
        ax.legend()
        if save:
            fig.savefig(save, dpi=150, bbox_inches="tight")
        if show:  # pragma: no cover
            plt.show()
        plt.close(fig)
        return fig

    def __repr__(self):
        return repr(self.table)


class Timer:
    """Wall-clock context timer (reference: gpry/progress.py:243)."""

    def __init__(self):
        self.time = np.nan

    def __enter__(self):
        self._start = perf_counter()
        return self

    def __exit__(self, *exc):
        self.time = perf_counter() - self._start


class TimerCounter(Timer):
    """
    Timer that also diffs GP eval counters across the timed block
    (reference: gpry/progress.py:257-285).  Pass one or more objects with
    ``n_eval`` (and optionally ``n_eval_loglike``) attributes.
    """

    def __init__(self, *gps):
        super().__init__()
        self.gps = gps
        self.evals = np.nan
        self.evals_loglike = np.nan

    def __enter__(self):
        super().__enter__()
        self._evals_0 = sum(getattr(g, "n_eval", 0) for g in self.gps)
        self._evals_loglike_0 = sum(
            getattr(g, "n_eval_loglike", 0) for g in self.gps)
        return self

    def __exit__(self, *exc):
        super().__exit__(*exc)
        self.evals = sum(getattr(g, "n_eval", 0)
                         for g in self.gps) - self._evals_0
        self.evals_loglike = sum(
            getattr(g, "n_eval_loglike", 0)
            for g in self.gps) - self._evals_loglike_0
