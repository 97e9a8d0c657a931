"""
Proposal generators for initial samples and acquisition-optimizer restarts.

Reference surface: gpry/proposal.py (443 LoC).  Host-side numpy RNG programs
(they feed the outer loop, not jitted code), with batched ``get_batch``
methods so the TPU acquisition engine can draw thousands of screened starts
in one call instead of the reference's one-at-a-time ``get``.
"""

import numpy as np

from gpry_tpu_torch.utils.tools import check_and_return_bounds, is_in_bounds


def _rng_of(rng):
    if isinstance(rng, np.random.Generator):
        return rng
    return np.random.default_rng(rng)


class Proposer:
    """Base proposer (reference: gpry/proposal.py:45)."""

    def __init__(self, bounds):
        self.update_bounds(check_and_return_bounds(bounds))

    def update_bounds(self, bounds):
        self.bounds = check_and_return_bounds(bounds)

    def update(self, gpr):
        """Hook called when the GP surrogate is updated."""

    def get(self, rng=None):
        return self.get_batch(1, rng)[0]

    def get_batch(self, n, rng=None):
        raise NotImplementedError


class InitialPointProposer:
    """Marker mixin: proposer usable for initial truth samples
    (reference: gpry/proposal.py:91)."""


class UniformProposer(Proposer, InitialPointProposer):
    """Uniform draws in the bounds box (reference: gpry/proposal.py:136)."""

    def get_batch(self, n, rng=None):
        rng = _rng_of(rng)
        return rng.uniform(self.bounds[:, 0], self.bounds[:, 1],
                           size=(n, len(self.bounds)))


class PriorProposer(UniformProposer):
    """Samples from the prior: uniform within bounds for the built-in Truth
    (reference: gpry/proposal.py:117)."""

    def __init__(self, bounds, truth=None):
        super().__init__(bounds)
        self.truth = truth

    def get_batch(self, n, rng=None):
        if self.truth is not None and hasattr(self.truth, "prior_sample"):
            return np.atleast_2d(self.truth.prior_sample(n, rng=rng))
        return super().get_batch(n, rng)


class ReferenceProposer(PriorProposer, InitialPointProposer):
    """Samples from the truth's reference distribution, falling back to the
    prior (reference: gpry/proposal.py:97)."""

    def get_batch(self, n, rng=None):
        if self.truth is not None and hasattr(self.truth, "ref_sample"):
            try:
                return np.atleast_2d(self.truth.ref_sample(n, rng=rng))
            except (AttributeError, NotImplementedError):
                pass
        return super().get_batch(n, rng)


class MeanCovProposer(Proposer, InitialPointProposer):
    """Multivariate-normal proposals (reference: gpry/proposal.py:218)."""

    def __init__(self, bounds, mean, cov, include_mean=False):
        super().__init__(bounds)
        self._mean = np.atleast_1d(np.asarray(mean, dtype=float))
        self._cov = np.atleast_2d(np.asarray(cov, dtype=float))
        self._mean_used = not include_mean

    def get_batch(self, n, rng=None):
        rng = _rng_of(rng)
        out = np.empty((n, len(self._mean)))
        filled = 0
        if not self._mean_used and n > 0:
            out[0] = self._mean
            self._mean_used = True
            filled = 1
        # rejection-sample into bounds, with a safety cap
        tries = 0
        while filled < n and tries < 1000:
            draw = rng.multivariate_normal(
                self._mean, self._cov, size=(n - filled),
                method="cholesky" if self._is_posdef() else "svd")
            ok = is_in_bounds(draw, self.bounds)
            take = draw[ok][:n - filled]
            out[filled:filled + len(take)] = take
            filled += len(take)
            tries += 1
        if filled < n:  # degenerate cov or bounds: fill uniformly
            out[filled:] = rng.uniform(self.bounds[:, 0], self.bounds[:, 1],
                                       size=(n - filled, len(self.bounds)))
        return out

    def _is_posdef(self):
        try:
            np.linalg.cholesky(self._cov)
            return True
        except np.linalg.LinAlgError:
            return False


class CentroidsProposer(Proposer):
    """
    Centroids of random (d+1)-subsets of training points, with an
    exponential "kick" for exploration (reference: gpry/proposal.py:258-319).
    """

    def __init__(self, bounds, lambd=1.0):
        self.training = None
        self.training_ = None
        super().__init__(bounds)
        self.lambd = float(lambd)

    def update(self, gpr):
        self.training = np.copy(gpr.X_train)
        self.update_bounds(self.bounds)

    def update_bounds(self, bounds):
        super().update_bounds(bounds)
        if self.training is not None and len(self.training):
            self.training_ = self.training[
                is_in_bounds(self.training, self.bounds)]

    def get_batch(self, n, rng=None):
        # Fully vectorized (the acquisition engine screens thousands of
        # draws per Kriging-believer step; a Python loop here was ~0.25 s
        # per call — most of BatchOptimizer's per-step wall time).
        rng = _rng_of(rng)
        d = len(self.bounds)
        m = d + 1
        pool = self.training_ if (self.training_ is not None
                                  and len(self.training_) >= m) \
            else self.training
        if pool is None or len(pool) < 2:
            return UniformProposer(self.bounds).get_batch(n, rng)
        P = len(pool)
        mm = min(m, P)
        # batched distinct subsets: first mm of a random permutation,
        # via argpartition of iid keys
        subset_idx = np.argpartition(rng.random((n, P)), mm - 1,
                                     axis=1)[:, :mm]
        subsets = pool[subset_idx]                       # (n, mm, d)
        centroids = subsets.mean(axis=1)                 # (n, d)
        if mm < d:
            picks = rng.integers(0, mm, size=(n, d))
        else:
            picks = np.argpartition(rng.random((n, mm)), d - 1,
                                    axis=1)[:, :d]       # distinct per row
        chosen = subsets[np.arange(n)[:, None], picks,
                         np.arange(d)[None, :]]          # (n, d)
        kick = (chosen - centroids) * rng.exponential(
            scale=1.0 / self.lambd, size=(n, d))
        return np.clip(centroids + kick, self.bounds[:, 0],
                       self.bounds[:, 1])


class PartialProposer(Proposer, InitialPointProposer):
    """
    Mix of a wrapped proposer with a uniform fraction for exploration
    (default 25% uniform, reference: gpry/proposal.py:163-187).
    """

    def __init__(self, bounds, true_proposer, random_proposal_fraction=0.25):
        if not 0.0 <= random_proposal_fraction <= 1.0:
            raise ValueError(
                f"Invalid fraction {random_proposal_fraction}")
        if not isinstance(true_proposer, Proposer):
            raise ValueError("true_proposer must be a Proposer.")
        self.rpf = random_proposal_fraction
        self.random_proposer = UniformProposer(bounds)
        self.true_proposer = true_proposer
        super().__init__(bounds)

    def update(self, gpr):
        self.true_proposer.update(gpr)

    def update_bounds(self, bounds):
        super().update_bounds(bounds)
        if hasattr(self, "random_proposer"):
            self.random_proposer.update_bounds(bounds)
            self.true_proposer.update_bounds(bounds)

    def get_batch(self, n, rng=None):
        rng = _rng_of(rng)
        from_uniform = rng.random(n) < self.rpf
        n_unif = int(np.sum(from_uniform))
        out = np.empty((n, len(self.bounds)))
        if n_unif:
            out[from_uniform] = self.random_proposer.get_batch(n_unif, rng)
        if n - n_unif:
            out[~from_uniform] = self.true_proposer.get_batch(n - n_unif,
                                                              rng)
        return out
