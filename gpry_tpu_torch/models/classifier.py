"""
Infinities classifier ("SVM").

Same semantics as gpry_tpu/models/classifier.py: an RBF-kernel support-
vector classifier separating "finite" from "-inf-like" regions of the
target, where "finite" means ``y >= max(y) - diff_threshold``.  The fit (a
small QP, once per iteration) runs on the host in the C++ SMO trainer
(``gpry_tpu_torch.native``); there is no scikit-learn fallback.  The
decision function is exported as padded tensors (``SVMParams``) and
evaluated on the device: fused into the K1/K2 CUDA kernels, with
:func:`svm_decision` as its plain version.
"""

from dataclasses import dataclass

import numpy as np
import torch

from gpry_tpu_torch import config

# Decision modes for the padded device-side classifier.
MODE_ALL_FINITE = 0    # no SVC fit needed: everything classified finite
MODE_FITTED = 1        # use the decision function
MODE_NONE_FINITE = 2   # only -inf points seen: everything infinite


@dataclass(frozen=True)
class SVMParams:
    """Padded snapshot of a fitted classifier (``mode`` is a host int)."""
    mode: int
    sv: torch.Tensor         # (nsv_max, d) support vectors (padded zeros)
    dual: torch.Tensor       # (nsv_max,) signed dual coefs (padded zeros)
    intercept: torch.Tensor  # () float
    gamma: torch.Tensor      # () float


def svm_decision(params: SVMParams, X):
    """
    Device-side decision: True where finite is predicted.  ``X`` (nq, d)
    is in the preprocessed space the SVM was fit in.  Padded dual
    coefficients are zero, so padding contributes nothing.
    """
    if params.mode == MODE_ALL_FINITE:
        return torch.ones(X.shape[0], dtype=torch.bool, device=X.device)
    if params.mode == MODE_NONE_FINITE:
        return torch.zeros(X.shape[0], dtype=torch.bool, device=X.device)
    diff = X[:, None, :] - params.sv[None, :, :]
    sq = torch.sum(diff * diff, dim=-1)
    dec = torch.exp(-params.gamma * sq) @ params.dual + params.intercept
    return dec > 0


def trivial_svm_params(d, nsv_max=8, dtype=None, device=None,
                       mode=MODE_ALL_FINITE):
    """Everything-finite placeholder (classifier disabled or untrained)."""
    dtype = dtype or config.FIT_DTYPE
    device = device or config.get_device()
    return SVMParams(
        mode=int(mode),
        sv=torch.zeros((nsv_max, d), dtype=dtype, device=device),
        dual=torch.zeros((nsv_max,), dtype=dtype, device=device),
        intercept=torch.zeros((), dtype=dtype, device=device),
        gamma=torch.ones((), dtype=dtype, device=device),
    )


class SVM:
    """
    API-compatible stand-in for the reference's ``gpry.svm.SVM``
    (``C=1e7``, near-hard-margin, as gpry/svm.py:159).
    """

    def __init__(self, C=1e7, kernel="rbf", gamma="scale", tol=1e-3,
                 random_state=None):
        if kernel != "rbf":
            raise ValueError("Only the RBF kernel is supported.")
        self.C = C
        self.gamma = gamma
        self.tol = tol
        self.random_state = random_state
        self.X_train = None
        self.y_train = None
        self.y_finite = None
        self.at_least_one_finite = False
        self.all_finite = False
        self.diff_threshold = None
        self._max_y = None
        # fitted decision function: f(x) = sum dual_i K(x, sv_i) + b
        self._sv = None
        self._dual = None
        self._intercept = None
        self._gamma_val = None
        self.fit_stamp = 0

    # -- threshold logic (reference: gpry/svm.py:273-306) --------------------

    @staticmethod
    def _is_finite_raw(y, diff_threshold, max_y=None):
        y = np.asarray(y, dtype=float)
        if max_y is None:
            max_y = np.max(y)
        return np.greater_equal(y, max_y - diff_threshold) & np.isfinite(y)

    def is_finite(self, y):
        if self.y_train is None:
            raise ValueError("The SVM has not been trained yet!")
        return self._is_finite_raw(y, self.diff_threshold, self._max_y)

    @property
    def abs_threshold(self):
        return self._max_y - self.diff_threshold

    @property
    def d(self):
        if self.X_train is None:
            raise ValueError("No data added yet.")
        return self.X_train.shape[1]

    @property
    def n(self):
        return 0 if self.y_train is None else len(self.y_train)

    # -- fit / predict --------------------------------------------------------

    def fit(self, X, y, diff_threshold):
        """
        Fit on (preprocessed) X, y with the given threshold.  Returns the
        boolean finite classification of the training points.
        """
        self.fit_stamp += 1
        self.X_train = np.ascontiguousarray(X, dtype=float)
        self.y_train = np.asarray(y, dtype=float).copy()
        if not np.any(np.isfinite(self.y_train)):
            self.at_least_one_finite = False
            self.y_finite = np.full(len(self.y_train), False)
            return self.y_finite
        self.at_least_one_finite = True
        self.diff_threshold = diff_threshold
        self._max_y = np.max(self.y_train)
        self.y_finite = self._is_finite_raw(
            self.y_train, self.diff_threshold, self._max_y)
        if np.all(self.y_finite):
            self.all_finite = True
            self._sv = None
            return self.y_finite
        self.all_finite = False
        gamma = None if self.gamma == "scale" else float(self.gamma)
        from gpry_tpu_torch.native import train_rbf_svc
        (self._sv, self._dual, self._intercept,
         self._gamma_val) = train_rbf_svc(
            self.X_train, self.y_finite, C=self.C, gamma=gamma, tol=self.tol)
        return self.y_finite

    def decision_function(self, X):
        """f(x) = sum_i dual_i K_rbf(x, sv_i) + b (positive = finite)."""
        X = np.atleast_2d(np.asarray(X, dtype=float))
        sq = ((X[:, None, :] - self._sv[None, :, :]) ** 2).sum(-1)
        return np.exp(-self._gamma_val * sq) @ self._dual + self._intercept

    def predict(self, X, validate=True):
        """Boolean "finite predicted" array, in preprocessed coordinates."""
        if self.y_train is None:
            raise ValueError("The SVM has not been trained yet.")
        X = np.atleast_2d(X) if validate else X
        if self.all_finite:
            return np.full(len(X), True)
        if not self.at_least_one_finite:
            return np.full(len(X), False)
        return self.decision_function(X) > 0

    # -- device export --------------------------------------------------------

    def device_params(self, nsv_max=None, dtype=None,
                      device=None) -> SVMParams:
        """Padded tensors of the decision function for device sweeps;
        ``nsv_max`` buckets the support-vector buffer."""
        dtype = dtype or config.FIT_DTYPE
        device = device or config.get_device()
        if self.y_train is None or self.all_finite or self._sv is None:
            d = self.X_train.shape[1] if self.X_train is not None else 1
            mode = MODE_NONE_FINITE if (
                self.y_train is not None and not self.at_least_one_finite) \
                else MODE_ALL_FINITE
            return trivial_svm_params(d, nsv_max or 8, dtype, device, mode)
        nsv, d = self._sv.shape
        if nsv_max is None:
            nsv_max = config.bucket_size(nsv)
        pad = nsv_max - nsv
        if pad < 0:
            raise ValueError(f"nsv_max={nsv_max} < n_support={nsv}")
        as_t = lambda a: torch.as_tensor(np.asarray(a, dtype=float),
                                         dtype=dtype, device=device)
        return SVMParams(
            mode=MODE_FITTED,
            sv=as_t(np.pad(self._sv, ((0, pad), (0, 0)))),
            dual=as_t(np.pad(self._dual, (0, pad))),
            intercept=as_t(self._intercept),
            gamma=as_t(self._gamma_val),
        )
