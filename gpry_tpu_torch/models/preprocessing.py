"""
Invertible X- and y-preprocessors.

Same surface as the reference (gpry/preprocessing.py:29-684): pipelines of
transforms applied "behind the scenes" before GP fitting.  All built-in
transforms are affine, so they expose their parameters as ``(loc, scale)``
arrays that the jitted GP core folds into its computation; only fitting
happens on host (tiny data, once per iteration).
"""

import numpy as np

from gpry_tpu_torch.utils.tools import delta_logp_of_1d_nstd


class DummyPreprocessor:
    """Identity preprocessor (reference: gpry/preprocessing.py:29)."""

    is_linear = True
    fitted = True

    @staticmethod
    def fit(X, y):
        return None

    @staticmethod
    def transform(z):
        return z

    @staticmethod
    def inverse_transform(z):
        return z

    @staticmethod
    def transform_scale(scale):
        return scale

    @staticmethod
    def inverse_transform_scale(scale):
        return scale

    @staticmethod
    def transform_bounds(bounds):
        return bounds


class Normalize_bounds:
    """
    Affine map of each dimension from its prior bounds to [0, 1]
    (reference: gpry/preprocessing.py:311).
    """

    is_linear = True

    def __init__(self, bounds):
        bounds = np.atleast_2d(np.asarray(bounds, dtype=float))
        self.bounds = bounds
        self.loc = bounds[:, 0].copy()
        self.scale = (bounds[:, 1] - bounds[:, 0]).copy()
        if np.any(self.scale <= 0):
            raise ValueError(
                "All bounds must have lower < upper. Got "
                f"{bounds}"
            )
        self.fitted = True

    def fit(self, X, y):
        """Nothing to fit: the transform is fixed by the bounds."""
        return self

    def transform(self, X):
        return (np.asarray(X) - self.loc) / self.scale

    def inverse_transform(self, X):
        return np.asarray(X) * self.scale + self.loc

    def transform_scale(self, scale):
        return np.asarray(scale) / self.scale

    def inverse_transform_scale(self, scale):
        return np.asarray(scale) * self.scale

    def transform_bounds(self, bounds):
        bounds = np.atleast_2d(np.asarray(bounds, dtype=float))
        return (bounds - self.loc[:, None]) / self.scale[:, None]


class Normalize_y:
    """
    Standardize y to zero mean and unit std (optionally median/IQR),
    fit on finite values only (reference: gpry/preprocessing.py:528).
    """

    is_linear = True

    def __init__(self, use_median=False):
        self.mean_ = None
        self.std_ = None
        self.use_median = bool(use_median)

    @property
    def fitted(self):
        return self.mean_ is not None and self.std_ is not None

    def fit(self, X, y):
        y = np.asarray(y, dtype=float)
        yf = y[np.isfinite(y)]
        if self.use_median:
            y25, y50, y75 = np.percentile(yf, [25, 50, 75])
            self.mean_, self.std_ = y50, y75 - y25
        else:
            self.mean_, self.std_ = float(np.mean(yf)), float(np.std(yf))
        if self.std_ == 0 or not np.isfinite(self.std_):
            self.std_ = 1.0
        return self

    def transform(self, y):
        if not self.fitted:
            raise TypeError("mean_ and std_ have not been fit before")
        return (np.asarray(y) - self.mean_) / self.std_

    def inverse_transform(self, y):
        if not self.fitted:
            raise TypeError("mean_ and std_ have not been fit before")
        return np.asarray(y) * self.std_ + self.mean_

    def transform_scale(self, scale):
        if not self.fitted:
            raise TypeError("mean_ and std_ have not been fit before")
        return np.asarray(scale) / self.std_

    def inverse_transform_scale(self, scale):
        if not self.fitted:
            raise TypeError("mean_ and std_ have not been fit before")
        return np.asarray(scale) * self.std_


class NormalizeChi2_y(Normalize_y):
    """
    Center y at the 1-sigma chi2 level below the maximum, with std equal to
    that depth (reference: gpry/preprocessing.py:633).
    """

    def __init__(self, nsigma=1):
        if not (np.isscalar(nsigma) and nsigma > 0):
            raise TypeError(f"nsigma must be a positive number, got {nsigma}")
        super().__init__()
        self.nsigma = nsigma
        self.delta_logp = None

    def fit(self, X, y):
        X = np.atleast_2d(X)
        y = np.asarray(y, dtype=float)
        dim = X.shape[1]
        self.delta_logp = delta_logp_of_1d_nstd(self.nsigma, dim)
        yf = y[np.isfinite(y)]
        self.mean_ = float(np.max(yf)) - self.delta_logp
        self.std_ = self.delta_logp
        return self


class Whitening:
    """
    Rotate/scale X into the eigenbasis of the training covariance.
    Experimental in the reference too (gpry/preprocessing.py:179).
    """

    is_linear = True

    def __init__(self, bounds=None):
        self.bounds = bounds
        self.mean_ = None
        self.rot_ = None       # rows: eigvec / sqrt(eigval)
        self.inv_rot_ = None

    @property
    def fitted(self):
        return self.mean_ is not None

    def fit(self, X, y):
        X = np.atleast_2d(np.asarray(X, dtype=float))
        self.mean_ = X.mean(axis=0)
        cov = np.cov(X.T) if X.shape[0] > 1 else np.eye(X.shape[1])
        cov = np.atleast_2d(cov)
        evals, evecs = np.linalg.eigh(cov)
        evals = np.maximum(evals, 1e-300)
        self.rot_ = (evecs / np.sqrt(evals)).T
        self.inv_rot_ = np.linalg.inv(self.rot_)
        return self

    def transform(self, X):
        return (np.atleast_2d(X) - self.mean_) @ self.rot_.T

    def inverse_transform(self, X):
        return np.atleast_2d(X) @ self.inv_rot_.T + self.mean_

    def transform_bounds(self, bounds):
        raise NotImplementedError(
            "Whitening does not map axis-aligned bounds to axis-aligned "
            "bounds; use Normalize_bounds for bound-dependent components."
        )


def affine_params_X(pre, d):
    """
    Extract the diagonal-affine parameters ``(loc, scale)`` of a fitted
    X-preprocessor by probing its ``transform``, so that
    ``transform(x) == (x - loc) / scale`` — works for any diagonal affine
    preprocessor (or pipeline of them), not just those exposing
    ``loc``/``scale`` attributes.  Raises for non-diagonal (e.g. Whitening)
    or non-affine transforms instead of silently assuming identity.
    """
    t0 = np.atleast_2d(pre.transform(np.zeros((1, d))))[0]
    M = np.atleast_2d(pre.transform(np.eye(d))) - t0[None, :]
    if not np.allclose(M, np.diag(np.diagonal(M)), atol=1e-12):
        raise ValueError(
            f"X-preprocessor {pre!r} is not a diagonal affine transform; "
            "the device surrogate core cannot fold it in. Use "
            "Normalize_bounds (or a diagonal pipeline).")
    diag = np.diagonal(M).copy()
    if np.any(diag == 0) or not np.all(np.isfinite(diag)):
        raise ValueError(
            f"X-preprocessor {pre!r} has a singular/non-finite transform.")
    scale = 1.0 / diag
    loc = -t0 * scale
    return loc, scale


def affine_params_y(pre):
    """
    Extract ``(loc, scale)`` of a fitted scalar-affine y-preprocessor such
    that ``raw = transformed * scale + loc``.  Probes ``transform`` so
    pipelines and custom affine preprocessors work; raises for non-affine.
    """
    t0, t1, t2 = np.asarray(
        pre.transform(np.array([0.0, 1.0, 2.0])), dtype=float)
    slope = t1 - t0
    if slope == 0 or not np.isfinite(slope) or \
            not np.isclose(t2 - t1, slope, rtol=1e-9, atol=1e-12):
        raise ValueError(
            f"y-preprocessor {pre!r} is not an affine transform; the "
            "device surrogate core cannot fold it in.")
    scale = 1.0 / slope
    loc = -t0 * scale
    return loc, scale


class Pipeline_X:
    """Chain of X-preprocessors (reference: gpry/preprocessing.py:58)."""

    def __init__(self, steps):
        self.steps = list(steps)

    @property
    def is_linear(self):
        return all(getattr(s, "is_linear", False) for s in self.steps)

    @property
    def fitted(self):
        return all(getattr(s, "fitted", False) for s in self.steps)

    def fit(self, X, y):
        for step in self.steps:
            step.fit(X, y)
            X = step.transform(X)
        return self

    def transform(self, X):
        for step in self.steps:
            X = step.transform(X)
        return X

    def inverse_transform(self, X):
        for step in reversed(self.steps):
            X = step.inverse_transform(X)
        return X

    def transform_bounds(self, bounds):
        for step in self.steps:
            bounds = step.transform_bounds(bounds)
        return bounds

    def transform_scale(self, scale):
        for step in self.steps:
            scale = step.transform_scale(scale)
        return scale

    def inverse_transform_scale(self, scale):
        for step in reversed(self.steps):
            scale = step.inverse_transform_scale(scale)
        return scale


class Pipeline_y(Pipeline_X):
    """Chain of y-preprocessors (reference: gpry/preprocessing.py:414)."""

    def transform_bounds(self, bounds):
        raise TypeError("y-pipelines have no bounds transform.")
