"""
The "truth": wrapper around the user's expensive log-posterior.

Reference surface: gpry/truth.py (237 LoC) — bounds, parameter names/labels,
log-prior volume, reference-distribution sampling, and a uniform call
signature for the likelihood.  ``TruthCobaya`` wraps a Cobaya Model when
cobaya is installed (optional).
"""

import numpy as np

from gpry_tpu_torch.utils.tools import (check_and_return_bounds,
                                  generic_params_names, is_in_bounds,
                                  wrap_likelihood)


def get_truth(loglike, bounds=None, params=None, labels=None,
              ref_bounds=None, log_prior_volume=None):
    """
    Build a Truth from a callable + bounds, or pass through a Truth /
    Cobaya Model (reference: gpry/truth.py:20-48).
    """
    if isinstance(loglike, Truth):
        return loglike
    if hasattr(loglike, "logposterior") and hasattr(loglike, "prior"):
        return TruthCobaya(loglike)
    if bounds is None:
        raise ValueError("bounds are required when passing a callable.")
    if isinstance(bounds, dict):
        params = list(bounds)
        vals = []
        labels = labels or []
        use_labels = []
        for v in bounds.values():
            if isinstance(v, dict):
                vals.append(v["prior"])
                use_labels.append(v.get("latex"))
            else:
                vals.append(v)
                use_labels.append(None)
        labels = use_labels if any(use_labels) else labels
        bounds = vals
    return Truth(loglike, bounds, params=params, labels=labels,
                 ref_bounds=ref_bounds, log_prior_volume=log_prior_volume)


class Truth:
    """
    Uniform-prior truth over a bounds box (reference: gpry/truth.py:51-180).

    ``logp = loglike + logprior`` with the flat prior
    ``logprior = -log(prior volume)`` inside the box and -inf outside.
    """

    def __init__(self, loglike, bounds, params=None, labels=None,
                 ref_bounds=None, log_prior_volume=None, name=None):
        self.bounds = check_and_return_bounds(bounds)
        self._loglike_orig = loglike
        self.params = list(params) if params else \
            generic_params_names(self.d)
        self.labels = list(labels) if labels else list(self.params)
        self._loglike = wrap_likelihood(loglike, self.params)
        self.ref_bounds = (check_and_return_bounds(ref_bounds)
                           if ref_bounds is not None else None)
        if log_prior_volume is None:
            self._log_prior_volume = float(
                np.sum(np.log(self.bounds[:, 1] - self.bounds[:, 0])))
        else:
            self._log_prior_volume = float(log_prior_volume)
        self.name = name
        self.n_evals = 0

    @property
    def d(self):
        return self.bounds.shape[0]

    @property
    def prior_bounds(self):
        return self.bounds

    @property
    def log_prior_volume(self):
        return self._log_prior_volume

    def logprior(self, X):
        """Flat prior log-density (per point)."""
        X = np.atleast_2d(X)
        inside = is_in_bounds(X, self.bounds)
        out = np.where(inside, -self._log_prior_volume, -np.inf)
        return out

    def loglike(self, x):
        """User log-likelihood at a single point (raises nothing; nan -> -inf)."""
        self.n_evals += 1
        try:
            val = float(self._loglike(np.asarray(x, dtype=float)))
        except Exception:
            raise
        return val if np.isfinite(val) or val == -np.inf else -np.inf

    def logp(self, x):
        """Log-posterior (loglike + flat logprior) at a single point."""
        x = np.asarray(x, dtype=float)
        if not is_in_bounds(x[None], self.bounds)[0]:
            return -np.inf
        like = self.loglike(x)
        return like - self._log_prior_volume

    def prior_sample(self, n, rng=None):
        rng = rng if isinstance(rng, np.random.Generator) \
            else np.random.default_rng(rng)
        return rng.uniform(self.bounds[:, 0], self.bounds[:, 1],
                           size=(n, self.d))

    def ref_sample(self, n, rng=None):
        """Sample from the reference distribution (defaults to the prior,
        or a narrower ref_bounds box)."""
        rng = rng if isinstance(rng, np.random.Generator) \
            else np.random.default_rng(rng)
        b = self.ref_bounds if self.ref_bounds is not None else self.bounds
        return rng.uniform(b[:, 0], b[:, 1], size=(n, self.d))

    def as_dict(self):
        """Re-init dict for checkpointing (reference: gpry/truth.py:165)."""
        return {
            "loglike": self._loglike_orig,
            "bounds": np.asarray(self.bounds),
            "params": self.params,
            "labels": self.labels,
            "ref_bounds": self.ref_bounds,
            "log_prior_volume": self._log_prior_volume,
        }


class TruthCobaya(Truth):
    """
    Truth wrapping a Cobaya Model (reference: gpry/truth.py:182-237).
    Bounds are taken from the Cobaya prior at 99.995% confidence.
    """

    def __init__(self, model):
        try:
            import cobaya  # noqa: F401
        except ImportError as excpt:
            raise ImportError("cobaya is needed for TruthCobaya.") from excpt
        self.model = model
        params = list(model.parameterization.sampled_params())
        bounds = model.prior.bounds(confidence=0.99995)
        labels = [model.parameterization.labels().get(p, p) for p in params]
        super().__init__(self._cobaya_loglike, bounds, params=params,
                         labels=labels)

    def _cobaya_loglike(self, x):
        return float(self.model.logposterior(
            x, temperature=1).logpost)

    def logp(self, x):
        self.n_evals += 1
        x = np.asarray(x, dtype=float)
        if not is_in_bounds(x[None], self.bounds)[0]:
            return -np.inf
        val = self._cobaya_loglike(x)
        return val if np.isfinite(val) or val == -np.inf else -np.inf

    def ref_sample(self, n, rng=None):
        out = np.empty((n, self.d))
        for i in range(n):
            out[i] = self.model.prior.reference(
                max_tries=1000, random_state=rng)
        return out

    def prior_sample(self, n, rng=None):
        return self.model.prior.sample(n, random_state=rng)

    def as_dict(self):
        return {"model": self.model.info() if hasattr(self.model, "info")
                else None}
