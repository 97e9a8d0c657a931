"""
The GP surrogate model (port of gpry_tpu/models/gp.py).

* The GP state lives on the package device as padded float64 tensors
  (``SurrogateParams``, a frozen dataclass).
* Appending data uses the incremental block-Cholesky update
  (``ops.linalg.chol_append``); a NaN in the new rows refactorizes.
* Hyperparameters are fit screen-then-polish: one batched LML sweep over a
  dense candidate set (the K10 kernel) picks the seeds of a multistart
  L-BFGS polish of the LML (the K11 kernel, one launch per fit; on the CPU
  their plain versions, the lock-step torch solver over the analytic
  gradient).
* The classifier, preprocessing, trust region and upper clip reproduce the
  reference's prediction semantics; the gated sweeps are the K1 / K2 CUDA
  kernels, the convergence audit's ungated sweeps K5, the full covariance
  of ``predict(return_cov=True)`` K7 (``ops.fused``).
* With a device mesh (``parallel.mesh``: two or more cards) the fit's
  restart lanes and ``predict``'s rows are split over the cards; the
  results are the single card's.
* ``kernel`` is the reference's auto-built C() * RBF / Matern (a fast
  family) or any sklearn-style kernel expression, compiled to a spec tree
  (``ops.kernels.build_kernel_spec``) that every kernel runs in its spec
  mode.

The JAX package keeps a float32 search ladder, a float32 NS proposal and a
float32 ascent for its TPU.  The port takes its CPU branch everywhere: one
float64 rung, float64 sweeps.
"""

import dataclasses
import warnings
from dataclasses import dataclass, field

import numpy as np
import torch
from torch.autograd.function import once_differentiable

from gpry_tpu_torch import config
from gpry_tpu_torch.models.classifier import SVM, SVMParams, \
    trivial_svm_params
from gpry_tpu_torch.models.preprocessing import DummyPreprocessor
from gpry_tpu_torch.ops.fused import gated_mean, gated_meanvar_logexp, \
    lbfgs_lml_fit, meanstd_grad, meanvar_ungated
from gpry_tpu_torch.ops.kernels import build_kernel_spec, make_theta, \
    spec_diag, theta_bounds_dynamic
from gpry_tpu_torch.ops.linalg import chol_append, factorize, \
    predict_meancov, predict_meanvar
from gpry_tpu_torch.ops.linalg import lml_batch as _lml_batch
from gpry_tpu_torch.parallel import mesh as _mesh
from gpry_tpu_torch.utils.tools import check_and_return_bounds, \
    delta_logp_of_1d_nstd, get_Xnumber, shrink_bounds

_KERNEL_ALIASES = {
    "rbf": "rbf",
    "matern": "matern32",   # reference default nu=1.5 when "Matern" is given
    "matern12": "matern12",
    "matern32": "matern32",
    "matern52": "matern52",
}
_NU_TO_FAMILY = {0.5: "matern12", 1.5: "matern32", 2.5: "matern52"}

#: Restarts polished per fit (and acquisition lanes per ascent).
LBFGS_CHUNK = 8

#: Memory budget of one batched LML screen chunk (bytes).
LML_SCREEN_BUDGET = 4 * 2**30


@dataclass(frozen=True)
class SurrogateParams:
    """
    Snapshot of a fitted surrogate: GP factorization, affine pre/post-
    processing, classifier, clipping and trust region.  "Raw" quantities
    are in user coordinates; the GP core works in preprocessed ones.
    ``n`` is a host int; ``scal`` packs the gate scalars for the kernels.
    """
    theta: torch.Tensor      # (p,) log kernel hyperparameters
    X: torch.Tensor          # (nmax, d) transformed training inputs
    y: torch.Tensor          # (nmax,) transformed targets
    n: int                   # number of valid rows
    noise_var: torch.Tensor  # () or (nmax,) transformed noise variance
    L: torch.Tensor          # (nmax, nmax) padded Cholesky factor
    alpha: torch.Tensor      # (nmax,) K^-1 y (padded zeros)
    x_loc: torch.Tensor      # (d,) raw -> transformed: (x - loc) / scale
    x_scale: torch.Tensor    # (d,)
    y_loc: torch.Tensor      # () transformed -> raw: y * scale + loc
    y_scale: torch.Tensor    # ()
    y_max: torch.Tensor      # () max raw training target
    clip_max: torch.Tensor   # () raw-space upper clip (+inf = disabled)
    svm: SVMParams
    trust_lo: torch.Tensor   # (d,) raw trust-region bounds (-inf = none)
    trust_hi: torch.Tensor   # (d,)
    scal: torch.Tensor = field(init=False, repr=False)

    def __post_init__(self):
        # [y_loc, y_scale, clip_max, svm intercept, svm gamma, y_max]
        object.__setattr__(self, "scal", torch.stack([
            self.y_loc, self.y_scale, self.clip_max, self.svm.intercept,
            self.svm.gamma, self.y_max]).contiguous())

    def replace(self, **changes):
        return dataclasses.replace(self, **changes)


def surrogate_from_numpy(d, device=None):
    """
    Port ``SurrogateParams`` from the JAX package's ``p._asdict()`` with
    its fields as numpy arrays; ``d["svm"]`` is the SVMParams sub-tuple
    (a NamedTuple or a dict of arrays).
    """
    device = torch.device(device) if device is not None \
        else config.get_device()
    as_t = lambda a: torch.tensor(np.asarray(a, dtype=float),
                                  dtype=config.FIT_DTYPE, device=device)
    svm = d["svm"]
    svm = svm._asdict() if hasattr(svm, "_asdict") else dict(svm)
    fields = {k: as_t(v) for k, v in d.items() if k not in ("svm", "n")}
    return SurrogateParams(
        n=int(np.asarray(d["n"])),
        svm=SVMParams(mode=int(np.asarray(svm["mode"])), sv=as_t(svm["sv"]),
                      dual=as_t(svm["dual"]),
                      intercept=as_t(svm["intercept"]),
                      gamma=as_t(svm["gamma"])),
        **fields)


# ---------------------------------------------------------------------------
# Prediction functions on snapshots
# ---------------------------------------------------------------------------


class _MeanStdSmooth(torch.autograd.Function):
    """:func:`surrogate_mean_std_smooth` on the card: K8 computes the values
    and both gradients in one launch; the backward combines them per row,
    ``g_mean d mean/dx + g_std d std/dx``.  Differentiable once."""

    @staticmethod
    def forward(ctx, Xq_raw, family, p):
        mean, std, g_mean, g_std = meanstd_grad(family, p, Xq_raw.detach())
        ctx.save_for_backward(g_mean, g_std)
        # an output that is not used passes None, and adds no 0 * NaN
        ctx.set_materialize_grads(False)
        return mean, std

    @staticmethod
    @once_differentiable
    def backward(ctx, grad_mean, grad_std):
        g_mean, g_std = ctx.saved_tensors
        grad = None
        if grad_mean is not None:
            grad = grad_mean[:, None] * g_mean
        if grad_std is not None:
            part = grad_std[:, None] * g_std
            grad = part if grad is None else grad + part
        return grad, None, None


def surrogate_mean_std_smooth(family, p: SurrogateParams, Xq_raw):
    """
    Raw-space posterior mean and std WITHOUT the classifier/trust/clip
    gates: the smooth, differentiable part the acquisition ascent uses.
    On the card it is K8 (differentiable once, through its own gradients).
    """
    if Xq_raw.device.type == "cuda":
        return _MeanStdSmooth.apply(Xq_raw, family, p)
    Xq_ = (Xq_raw - p.x_loc) / p.x_scale
    mean_, var_ = predict_meanvar(
        family, p.theta, p.X, p.n, p.noise_var, p.L, p.alpha, Xq_)
    return mean_ * p.y_scale + p.y_loc, torch.sqrt(var_) * p.y_scale


@torch.no_grad()
def surrogate_mean_std_sweep(family, p: SurrogateParams, Xq_raw):
    """The values of :func:`surrogate_mean_std_smooth` for a no-grad sweep
    (the convergence audit's screens, polishes and calibrations): raw-space
    ``(mean, std)`` without gates or clip (K5)."""
    return meanvar_ungated(family, p, Xq_raw)


def surrogate_predict(family, p: SurrogateParams, Xq_raw):
    """Gated raw-space ``(mean, std)``: -inf / 0 outside the trust region
    or where the classifier predicts infinite; upper-clipped mean (K2)."""
    return gated_meanvar_logexp(family, p, Xq_raw)


def surrogate_predict_mean(family, p: SurrogateParams, Xq_raw):
    """Gated mean only: the NS / IS log-density target (K1)."""
    return gated_mean(family, p, Xq_raw)


def _lml_batch_chunked(family, X, y, n, noise_var, thetas, rel_jitter=0.0,
                       on_chunk=None):
    """
    Memory-budgeted LML sweep (gpry_tpu/models/gp.py:196-232).  On CUDA
    tensors one K10 launch, whose workspace does not grow with the rows.
    On the CPU each lane holds about three nmax^2 temporaries (K, its
    factor, the solve), so a dense screen over a large buffer is cut into
    power-of-two chunks of at most ``LML_SCREEN_BUDGET`` bytes.
    ``on_chunk`` is called after each chunk (the liveness tick of hang
    watchdogs).
    """
    nmax = int(X.shape[0])
    n_theta = int(thetas.shape[0])
    per_lane = 3 * nmax * nmax * X.element_size()
    chunk = int(LML_SCREEN_BUDGET // max(per_lane, 1))
    if X.device.type == "cuda" or chunk >= n_theta:
        chunk = n_theta
    else:
        chunk = max(8, 1 << (max(chunk, 1).bit_length() - 1))
    out = []
    for i in range(0, n_theta, chunk):
        out.append(_lml_batch(family, X, y, n, noise_var,
                              thetas[i:i + chunk], rel_jitter))
        if on_chunk is not None:
            on_chunk()
    return out[0] if len(out) == 1 else torch.cat(out)


def _fit_theta_restarts(family, X, y, n, noise_var, theta0s, lo, hi,
                        maxiter=200, rel_jitter=0.0):
    """Multi-restart LML maximization (K11 on CUDA tensors: one launch);
    returns ``(thetas, nlls, n_evals)`` per lane."""
    return lbfgs_lml_fit(family, X, y, n, noise_var, theta0s, lo, hi,
                         maxiter=maxiter, rel_jitter=rel_jitter)


class GaussianProcessRegressor:
    """
    The reference's GPR (gpry/gpr.py:27) with a PyTorch/CUDA core.
    Constructor arguments and defaults follow gpry/gpr.py:265-271.
    """

    def __init__(self, kernel="RBF", output_scale_prior=(1e-2, 1e3),
                 length_scale_prior=(1e-3, 1e1), noise_level=1e-2,
                 clip_factor=1.1, optimizer="lbfgs", n_restarts_optimizer=0,
                 preprocessing_X=None, preprocessing_y=None,
                 account_for_inf="SVM", inf_threshold="20s",
                 keep_min_finite=None, trust_region_factor=None,
                 trust_region_nstd=None, bounds=None, random_state=None,
                 demand_fit_min_n=160, verbose=1):
        if bounds is None:
            raise ValueError("'bounds' are required (auto-built kernels and "
                             "the infinities threshold depend on them).")
        self.bounds = check_and_return_bounds(bounds)
        self.verbose = verbose
        if np.iterable(noise_level):
            raise ValueError(
                "Pass a scalar default noise_level at init; per-point "
                "noise goes through append_to_data(noise_level=...).")
        self.noise_level_default = float(noise_level)
        self.noise_level_all = np.empty((0,))
        self._has_custom_noise = False
        if clip_factor is not None and clip_factor < 1:
            raise ValueError("'clip_factor' must be >= 1, or None.")
        self.clip_factor = clip_factor
        self.optimizer = optimizer
        self.n_restarts_optimizer = n_restarts_optimizer
        self.preprocessing_X = preprocessing_X or DummyPreprocessor
        self.preprocessing_y = preprocessing_y or DummyPreprocessor
        self.inf_value = np.inf
        self.minus_inf_value = -np.inf
        self.trust_region_factor = trust_region_factor
        self.trust_region_nstd = trust_region_nstd
        self.trust_bounds = None
        self._rng = np.random.default_rng(random_state)
        self.n_eval = 0
        self.n_eval_loglike = 0
        # Demand-driven fit frequency (gpry_tpu/models/gp.py:305-318):
        # from n >= demand_fit_min_n the incumbent theta is priced in the
        # screen; an unmoved basin skips (simple fit) or downgrades (full
        # fit) the polish.  None disables both.
        self.demand_fit_min_n = demand_fit_min_n
        self.n_fits_skipped = 0
        self.n_fits_downgraded = 0

        # --- infinities classifier -------------------------------------------
        self.inf_threshold = inf_threshold
        self.keep_min_finite = (keep_min_finite if keep_min_finite is not None
                                else max(2, self.d))
        if isinstance(account_for_inf, str) and \
                account_for_inf.lower() == "svm":
            self.infinities_classifier = SVM(random_state=random_state)
        elif account_for_inf is False or account_for_inf is None:
            self.infinities_classifier = None
        else:
            self.infinities_classifier = account_for_inf
        if self.infinities_classifier is not None:
            if self.inf_threshold is None:
                raise ValueError("Specify 'inf_threshold' when using an "
                                 "infinities classifier.")
            value, is_sigma, power = get_Xnumber(
                self.inf_threshold, "s", None, dtype=float,
                varname="inf_threshold")
            if power is not None:
                raise ValueError("Power for sigma units not supported.")
            self._diff_threshold = (
                delta_logp_of_1d_nstd(value, self.d) if is_sigma else value)
        else:
            self._diff_threshold = np.inf

        # --- kernel ---------------------------------------------------------
        self.output_scale_prior = tuple(output_scale_prior)
        self.length_scale_prior = tuple(length_scale_prior)
        if isinstance(kernel, str):
            kernel = {kernel: {}}
        if not isinstance(kernel, dict) or len(kernel) != 1:
            raise ValueError("'kernel' must be a name or single-key dict.")
        kname = list(kernel)[0]
        kargs = kernel[kname] or {}
        fam = _KERNEL_ALIASES.get(kname.lower())
        self._theta_bounds_spec = None
        if fam is not None and isinstance(kargs, dict) and \
                not (set(kargs) - {"nu", "length_scale"}):
            # Fast path: the reference's auto-built C() * RBF|Matern with
            # ARD length scales (gpry/gpr.py:328-363).
            kargs = dict(kargs)
            if "nu" in kargs:
                try:
                    fam = _NU_TO_FAMILY[float(kargs.pop("nu"))]
                except KeyError as excpt:
                    raise ValueError(
                        "Matern nu must be one of 0.5, 1.5, 2.5.") from excpt
            self.family = fam
            # Initial hyperparameters at the geometric mean of the priors
            # (reference: gpry/gpr.py:352-363), in preprocessed coordinates.
            out0 = float(np.sqrt(
                output_scale_prior[0] * output_scale_prior[1]))
            ls0 = kargs.pop("length_scale", None)
            if ls0 is None:
                ls0 = [float(np.sqrt(
                    length_scale_prior[0] * length_scale_prior[1]))] * self.d
            elif np.isscalar(ls0):
                ls0 = [float(ls0)] * self.d
            self._theta = make_theta(out0, ls0, device="cpu").numpy()
        else:
            # Extended kernel library (gpry_tpu/models/gp.py:380-392): any
            # sklearn-style kernel expression compiled to a spec tree.
            spec, theta0, bounds = build_kernel_spec(kernel, self.d)
            self.family = spec
            self._theta = np.asarray(theta0)
            self._theta_bounds_spec = np.asarray(bounds)
        self.bounds_ = self.preprocessing_X.transform_bounds(self.bounds) \
            if hasattr(self.preprocessing_X, "transform_bounds") \
            else self.bounds

        # --- training data ---------------------------------------------------
        self.X_train_all = np.empty((0, self.d))
        self.y_train_all = np.empty((0,))
        self.X_train = np.empty((0, self.d))
        self.y_train = np.empty((0,))
        self.n_last_appended = 0
        self.n_last_appended_finite = 0
        self._fitted = False
        self.log_marginal_likelihood_value_ = None

        # --- device state ----------------------------------------------------
        self._device = config.get_device()
        self._dtype = config.FIT_DTYPE
        self._nmax = 0
        self._dX = None      # (nmax, d) transformed
        self._dy = None      # (nmax,)
        self._dL = None
        self._dalpha = None
        self._noise_var_ = None  # transformed-space noise variance

    def _t(self, a):
        """A float64 tensor on the model's device."""
        return torch.as_tensor(np.asarray(a, dtype=float), dtype=self._dtype,
                               device=self._device)

    # ------------------------------------------------------------------ props

    @property
    def d(self):
        return self.bounds.shape[0]

    @property
    def n(self):
        return len(self.y_train)

    @property
    def n_finite(self):
        return self.n

    @property
    def n_total(self):
        return len(self.y_train_all)

    @property
    def y_max(self):
        if len(self.y_train) == 0:
            return self.minus_inf_value
        return np.max(self.y_train)

    @property
    def fitted(self):
        return self._fitted

    @property
    def noise_level(self):
        """Raw-space noise std: scalar default, or the per-point array when
        custom per-append noise was given."""
        if self._has_custom_noise:
            return self.noise_level_all
        return self.noise_level_default

    @property
    def X_train_infinite(self):
        if self.infinities_classifier is None:
            return np.empty((0, self.d))
        return self.X_train_all[~self._is_finite_all()]

    @property
    def y_train_infinite(self):
        if self.infinities_classifier is None:
            return np.empty((0,))
        return self.y_train_all[~self._is_finite_all()]

    @property
    def last_appended(self):
        n = self.n_last_appended
        return (np.copy(self.X_train_all[len(self.X_train_all) - n:]),
                np.copy(self.y_train_all[len(self.y_train_all) - n:]))

    @property
    def last_appended_finite(self):
        n = self.n_last_appended_finite
        return (np.copy(self.X_train[len(self.X_train) - n:]),
                np.copy(self.y_train[len(self.y_train) - n:]))

    @property
    def abs_finite_threshold(self):
        if self.infinities_classifier is None:
            return -np.inf
        return self.y_max - self._diff_threshold_keep_n()

    @property
    def kernel_theta(self):
        """Current log-hyperparameters [log outputscale^2, log ls_1...d]."""
        return np.asarray(self._theta)

    @property
    def scales(self):
        """(output_scale, length_scales) in raw coordinates.  Only defined
        for the auto-built C()*RBF/Matern kernels."""
        if isinstance(self.family, tuple):
            raise ValueError(
                "'scales' is only defined for the auto-built C()*RBF/Matern"
                " kernels; inspect 'kernel_theta' for extended kernels.")
        out = float(np.exp(0.5 * self._theta[0]))
        ls = np.exp(self._theta[1:])
        return (self.preprocessing_y.inverse_transform_scale(out),
                tuple(np.atleast_1d(
                    self.preprocessing_X.inverse_transform_scale(ls))))

    @property
    def theta_bounds(self):
        """Log-space hyperparameter optimization bounds."""
        if self._theta_bounds_spec is not None:
            return np.asarray(self._theta_bounds_spec)
        widths = None
        if hasattr(self.preprocessing_X, "transform_bounds"):
            b = self.preprocessing_X.transform_bounds(self.bounds)
            widths = b[:, 1] - b[:, 0]
        return theta_bounds_dynamic(
            self._theta, self.d, prior_widths=widths, dynamic=False,
            output_scale_prior=self.output_scale_prior,
            length_scale_prior=self.length_scale_prior)

    # ------------------------------------------------------------- thresholds

    def _diff_threshold_keep_n(self):
        """Threshold enlarged so that at least ``keep_min_finite`` points
        stay finite (reference: gpry/gpr.py:1475-1488)."""
        y = self.y_train_all
        n = self.keep_min_finite
        if n is None or n <= 1 or len(y) == 0 or \
                not np.any(np.isfinite(y)):
            return self._diff_threshold
        y_sorted = np.sort(y)
        diff_nth = y_sorted[-1] - y_sorted[-min(n, len(y_sorted))]
        return max(self._diff_threshold, diff_nth + 1e-6)

    def _is_finite_all(self, diff_threshold=None):
        if self.infinities_classifier is None:
            return np.isfinite(self.y_train_all)
        if diff_threshold is None:
            diff_threshold = self._diff_threshold_keep_n()
        return SVM._is_finite_raw(self.y_train_all, diff_threshold)

    def is_finite(self, y):
        """Threshold check in raw-y space."""
        if self.infinities_classifier is None:
            return np.isfinite(np.asarray(y))
        return SVM._is_finite_raw(
            np.asarray(y), self._diff_threshold_keep_n(),
            max_y=self.y_max if len(self.y_train) else None)

    def predict_is_finite(self, X, validate=True):
        """Classifier prediction at X (reference: gpry/gpr.py:526)."""
        X = np.atleast_2d(np.asarray(X, dtype=float))
        if self.infinities_classifier is None or \
                self.infinities_classifier.n == 0:
            return np.ones(len(X), dtype=bool)
        X_ = np.atleast_2d(self.preprocessing_X.transform(X))
        return np.asarray(self.infinities_classifier.predict(
            X_, validate=validate), dtype=bool)

    @property
    def training_set_as_df(self):
        """Training set as a pandas DataFrame (reference: gpry/gpr.py:490)."""
        import pandas as pd
        data = {f"x_{i + 1}": self.X_train_all[:, i]
                for i in range(self.d)}
        data["y"] = self.y_train_all
        data["is_finite"] = self._is_finite_all()
        return pd.DataFrame(data)

    def set_random_state(self, random_state):
        """Reset the RNG (reference: gpry/gpr.py:542)."""
        self._rng = random_state if isinstance(
            random_state, np.random.Generator) \
            else np.random.default_rng(random_state)

    @staticmethod
    def compute_threshold_given_sigma(n_sigma, n_dimensions):
        """Delta-logp depth of the n_sigma contour in n_dimensions
        (gpry_tpu/models/gp.py:580)."""
        return delta_logp_of_1d_nstd(n_sigma, n_dimensions)

    def remove_from_data(self, position, fit=True):
        """
        Remove training points by index into the full appended set and
        refresh the model (gpry_tpu/models/gp.py:585): ``fit=True`` refits
        the hyperparameters, ``fit=False`` refactorizes at the current
        ones.  The preprocessors and the classifier are refit on what is
        left.
        """
        position = np.atleast_1d(np.asarray(position, dtype=int))
        n_all = len(self.y_train_all)
        if np.any((position < 0) | (position >= n_all)):
            raise ValueError(f"Invalid positions {position} for a training "
                             f"set of size {n_all}.")
        keep = np.ones(n_all, dtype=bool)
        keep[position] = False
        self.X_train_all = self.X_train_all[keep]
        self.y_train_all = self.y_train_all[keep]
        self.noise_level_all = self.noise_level_all[keep]
        self.n_last_appended = 0
        self.n_last_appended_finite = 0
        return self.append_to_data(None, None, fit_gpr=bool(fit))

    # ------------------------------------------------------------ data append

    def append_to_data(self, X, y, noise_level=None, fit_gpr=True,
                       fit_classifier=True):
        """
        Append new points and update the model (reference semantics:
        gpry/gpr.py:577-770).  ``fit_gpr`` may be True, False, "simple", or a
        dict of ``fit_gpr_hyperparameters`` kwargs.
        """
        fit_gpr_kwargs = None
        if fit_gpr is True:
            fit_classifier = True
            fit_gpr_kwargs = {}
        elif str(fit_gpr) == "simple":
            fit_classifier = True
            fit_gpr_kwargs = {"simple": True}
            fit_gpr = True
        elif isinstance(fit_gpr, dict):
            fit_classifier = True
            fit_gpr_kwargs = dict(fit_gpr)
            fit_gpr = True
        elif fit_gpr is not False:
            raise ValueError(f"Invalid fit_gpr={fit_gpr!r}")
        fit_preprocessors = bool(fit_classifier)
        force_fit_gpr = False
        force_refresh = False
        if X is None and y is None:
            X = np.empty((0, self.d))
            y = np.empty((0,))
            force_fit_gpr = fit_gpr
            force_refresh = True
        elif X is None or y is None:
            raise ValueError("Pass both X and y, or neither.")
        X = np.atleast_2d(np.asarray(X, dtype=float))
        y = np.atleast_1d(np.asarray(y, dtype=float))
        if len(X) != len(y):
            raise ValueError(
                f"X and y must have the same length; got {len(X)} vs "
                f"{len(y)}.")
        if X.shape[1] != self.d:
            raise ValueError(
                f"X has {X.shape[1]} columns but the model is "
                f"{self.d}-dimensional.")

        if noise_level is None:
            noise_new = np.full(len(y), self.noise_level_default)
        elif np.iterable(noise_level):
            noise_new = np.asarray(noise_level, dtype=float)
            if len(noise_new) != len(y):
                raise ValueError(
                    f"noise_level has {len(noise_new)} entries but y has "
                    f"{len(y)}.")
            self._has_custom_noise = True
        else:
            noise_new = np.full(len(y), float(noise_level))
            self._has_custom_noise = True

        old_finite_mask = self._is_finite_all() \
            if len(self.y_train_all) else np.empty(0, dtype=bool)
        self.n_last_appended = len(y)
        self.X_train_all = np.append(self.X_train_all, X, axis=0)
        self.y_train_all = np.append(self.y_train_all, y)
        self.noise_level_all = np.append(self.noise_level_all, noise_new)

        # 1. Thresholding (with keep-min-finite adjustment).
        diff_threshold = self._diff_threshold_keep_n()
        is_finite_all = self._is_finite_all(diff_threshold)
        X_finite = np.copy(self.X_train_all[is_finite_all])
        y_finite = np.copy(self.y_train_all[is_finite_all])

        # 2. Preprocessors, fit on finite points only.
        if fit_preprocessors and len(y_finite):
            self.preprocessing_X.fit(X_finite, y_finite)
            self.preprocessing_y.fit(X_finite, y_finite)
            self.bounds_ = self.preprocessing_X.transform_bounds(self.bounds)

        # 3. Classifier, in the preprocessed space.
        if self.infinities_classifier is not None and fit_classifier:
            self._fit_classifier(diff_threshold)

        self.n_last_appended_finite = int(
            np.sum(is_finite_all[len(is_finite_all) - self.n_last_appended:]))
        if not self.n_last_appended_finite and not force_fit_gpr \
                and not force_refresh:
            return self

        # 4. GP training set = finite subset.
        appended_only = (
            len(old_finite_mask) == 0
            or (np.array_equal(is_finite_all[:len(old_finite_mask)],
                               old_finite_mask))
        )
        self.X_train = X_finite
        self.y_train = y_finite

        if fit_gpr:
            self.fit_gpr_hyperparameters(**fit_gpr_kwargs)
        elif (not force_refresh and appended_only and not fit_preprocessors
              and self._dL is not None
              and len(y_finite) <= self._nmax and self._fitted
              and noise_level is None):
            new_X = X_finite[len(y_finite) - self.n_last_appended_finite:]
            new_y = y_finite[len(y_finite) - self.n_last_appended_finite:]
            self._device_append(new_X, new_y)
        else:
            self._update_model()
        self.update_trust_region()
        return self

    def _fit_classifier(self, diff_threshold):
        y_fitted = getattr(self.preprocessing_y, "fitted", True)
        X_all_ = self.preprocessing_X.transform(self.X_train_all)
        y_all_ = self.preprocessing_y.transform(self.y_train_all) \
            if y_fitted else self.y_train_all
        thr_ = self.preprocessing_y.transform_scale(diff_threshold) \
            if y_fitted else diff_threshold
        self.infinities_classifier.fit(X_all_, y_all_, thr_)

    def load_numpy_state(self, theta, X_train_all, y_train_all, x_loc,
                         x_scale, y_loc, y_scale, svm=None):
        """
        Adopt a fitted model's state without refitting: log-hyperparameters
        ``theta``, the full appended training set, the fitted affine
        preprocessing (``x = (raw - x_loc) / x_scale``, ``raw_y = y *
        y_scale + y_loc``) and, when given, the classifier's fitted
        attributes (a dict of the SVM's instance attributes).  The model is
        then factorized at ``theta``, so it predicts what the source model
        predicts.
        """
        self.X_train_all = np.atleast_2d(np.asarray(X_train_all, float))
        self.y_train_all = np.asarray(y_train_all, dtype=float).copy()
        self.noise_level_all = np.full(len(self.y_train_all),
                                       self.noise_level_default)
        pre_X, pre_y = self.preprocessing_X, self.preprocessing_y
        pre_X.loc = np.asarray(x_loc, dtype=float).copy()
        pre_X.scale = np.asarray(x_scale, dtype=float).copy()
        pre_y.mean_, pre_y.std_ = float(y_loc), float(y_scale)
        self.bounds_ = pre_X.transform_bounds(self.bounds)
        if svm is not None and self.infinities_classifier is not None:
            for k, v in svm.items():
                setattr(self.infinities_classifier, k, v)
        finite = self._is_finite_all()
        self.X_train = np.copy(self.X_train_all[finite])
        self.y_train = np.copy(self.y_train_all[finite])
        self.n_last_appended = self.n_last_appended_finite = 0
        self._theta = np.asarray(theta, dtype=float).copy()
        self._update_model()
        self._fitted = True
        self.update_trust_region()
        return self

    # ------------------------------------------------------- device state mgmt

    def _transformed_training(self):
        X_ = np.atleast_2d(self.preprocessing_X.transform(self.X_train))
        y_ = np.asarray(self.preprocessing_y.transform(self.y_train))
        return X_, y_

    def _transformed_noise_var(self, nmax=None):
        """Noise variance in transformed-y units: a scalar, or an (nmax,)
        padded vector when per-point noise was given."""
        if not self._has_custom_noise:
            nl_ = self.preprocessing_y.transform_scale(
                self.noise_level_default)
            return float(nl_) ** 2
        if nmax is None:
            nmax = self._nmax
        finite = self._is_finite_all()
        nl_fin = self.preprocessing_y.transform_scale(
            self.noise_level_all[finite])
        default_ = float(self.preprocessing_y.transform_scale(
            self.noise_level_default)) ** 2
        out = np.full(nmax, default_)
        out[:len(nl_fin)] = np.square(nl_fin)
        return out

    def _refresh_buffers(self):
        """Padded device buffers for the current training set."""
        n = self.n
        X_, y_ = self._transformed_training()
        nmax = config.bucket_size(n)
        self._nmax = nmax
        Xp = np.zeros((nmax, self.d))
        Xp[:n] = X_
        yp = np.zeros(nmax)
        yp[:n] = y_
        self._dX = self._t(Xp)
        self._dy = self._t(yp)
        self._noise_var_ = self._transformed_noise_var(nmax)

    def _noise_t(self):
        return self._t(self._noise_var_)

    def _update_model(self):
        """Full padded refactorization for the current training set."""
        if self.n == 0:
            return self
        self._refresh_buffers()
        self._dL, self._dalpha = factorize(
            self.family, self._t(self._theta), self._dX, self._dy, self.n,
            self._noise_t())
        if bool(torch.isnan(self._dL).any()):
            raise np.linalg.LinAlgError(
                "The kernel matrix is not positive definite. Try increasing "
                "'noise_level'.")
        return self

    def _device_append(self, new_X_raw, new_y_raw):
        """Incremental block-Cholesky append of already-finite new points."""
        k = len(new_y_raw)
        if k == 0:
            return
        n_old = self.n - k
        if self.n > self._nmax:
            self._update_model()
            return
        X_ = np.atleast_2d(self.preprocessing_X.transform(new_X_raw))
        y_ = np.asarray(self.preprocessing_y.transform(new_y_raw))
        (self._dX, self._dy, _, self._dL, self._dalpha) = chol_append(
            self.family, self._t(self._theta), self._dX, self._dy, n_old,
            self._noise_t(), self._dL, self._t(X_), self._t(y_))
        if bool(torch.isnan(self._dL[n_old + k - 1]).any()):
            # Numerically unsafe append: fall back to full refactorization.
            self._update_model()

    # ------------------------------------------------- hyperparameter fit

    def _liveness(self):
        """Call the optional ``liveness_callback`` (the Runner sets it: it
        touches the checkpoint's heartbeat file, so that a hang watchdog
        tells a long fit from a dead process)."""
        cb = getattr(self, "liveness_callback", None)
        if cb is not None:
            try:
                cb()
            except Exception:
                pass

    def fit_gpr_hyperparameters(self, simple=False, start_from_current=True,
                                n_restarts=None, hyperparameter_bounds=None,
                                maxiter=120):
        """
        Screen-then-polish LML maximization (reference: gpry/gpr.py:883-994;
        JAX package: gpry_tpu/models/gp.py:816-1054, its CPU branch).
        """
        if simple:
            # warm start + ONE lane seeded by the batched screen
            start_from_current = True
            n_restarts = 2
        if not self._fitted:
            start_from_current = False
        if n_restarts is None:
            n_restarts = self.n_restarts_optimizer
        if self.optimizer is None or n_restarts <= 0:
            warnings.warn("Hyperparameters not (re)fit: no optimizer or "
                          "zero restarts requested.")
            self._update_model()
            self.log_marginal_likelihood_value_ = \
                self.log_marginal_likelihood()
            return self
        if self.n == 0:
            raise ValueError("No training data to fit.")
        bounds = np.asarray(hyperparameter_bounds if hyperparameter_bounds
                            is not None else self.theta_bounds)
        lo, hi = bounds[:, 0], bounds[:, 1]
        n_polish = int(min(LBFGS_CHUNK, max(n_restarts, 1)))
        theta0s = np.empty((n_polish, len(self._theta)))
        i0 = 0
        if start_from_current:
            theta0s[0] = np.clip(self._theta, lo, hi)
            i0 = 1
        if n_polish > i0:
            theta0s[i0:] = self._rng.uniform(
                lo, hi, size=(n_polish - i0, len(lo)))
        n = self.n
        old_nmax = self._nmax
        self._refresh_buffers()
        if self._dL is not None and old_nmax != self._nmax:
            # bucket crossed: drop the stale factorization now, so an
            # exception below leaves a coherent "unfitted" state
            self._dL = self._dalpha = None
        on_cpu = self._device.type == "cpu"
        noise = self._noise_t()
        demand_price = (start_from_current and self._fitted
                        and self.demand_fit_min_n is not None
                        and n >= self.demand_fit_min_n)
        demand_skip = simple and demand_price
        if n_polish > i0 + 1 or (simple and n_polish > i0):
            n_screen = max(8 * n_restarts, 256 if on_cpu else 2048)
            cand = self._rng.uniform(lo, hi, size=(n_screen, len(lo)))
            cand = np.vstack([theta0s[i0:], cand])
            if demand_price:
                cand = np.vstack([cand, theta0s[:1]])
            lml_c = _lml_batch_chunked(
                self.family, self._dX, self._dy, n, noise,
                self._t(cand), on_chunk=self._liveness).cpu().numpy()
            lml_c = np.where(np.isfinite(lml_c), lml_c, -np.inf)
            self.n_eval_loglike += len(cand)
            if demand_price:
                lml_cur = float(lml_c[-1])
                lml_c, cand = lml_c[:-1], cand[:-1]
                basin_unmoved = (np.isfinite(lml_cur)
                                 and float(np.max(lml_c)) <= lml_cur)
                if basin_unmoved and not demand_skip and n_polish > 2:
                    theta0s = theta0s[:2]
                    n_polish = 2
                    self.n_fits_downgraded += 1
                if demand_skip and basin_unmoved:
                    L_, alpha_ = factorize(
                        self.family, self._t(theta0s[0]), self._dX,
                        self._dy, n, noise)
                    if not bool(torch.isnan(L_).any()):
                        self._theta = np.asarray(theta0s[0])
                        self._dL, self._dalpha = L_, alpha_
                        self.log_marginal_likelihood_value_ = lml_cur
                        self.n_fits_skipped += 1
                        self._fitted = True
                        return self
            order = np.argsort(lml_c)[::-1]
            theta0s[i0:] = cand[order[:n_polish - i0]]

        self._liveness()
        # the restarts are DP-split over the device mesh when one is up
        # (parallel/mesh.py; the reference's MPI restart split,
        # gpry/run.py:1253-1293): the same lanes either way
        thetas, nlls, fit_nevs = _mesh.fit_theta_restarts_maybe_sharded(
            self.family, self._dX, self._dy, n, noise, self._t(theta0s),
            self._t(lo), self._t(hi), maxiter=maxiter)
        nlls = nlls.cpu().numpy()
        self.n_eval_loglike += int(fit_nevs.sum())
        nlls_safe = np.where(np.isfinite(nlls), nlls, np.inf)
        best = int(np.argmin(nlls_safe))
        if not np.isfinite(nlls[best]):
            raise np.linalg.LinAlgError(
                "All hyperparameter fits failed (non-finite LML). "
                f"n={n}, noise_var={np.mean(self._noise_var_):.3g}, "
                f"theta0s range=({theta0s.min():.3g}, {theta0s.max():.3g}), "
                f"lo={lo.round(2)}, hi={hi.round(2)}, nlls[:4]={nlls[:4]}")
        # Winner by exact LML over the endpoints (+ the incumbent), so that
        # refits are monotone.
        cand = thetas.cpu().numpy().astype(float)
        if self._fitted:
            cand = np.vstack([cand, np.asarray(self._theta, dtype=float)])
        lml_exact = _lml_batch_chunked(
            self.family, self._dX, self._dy, n, noise,
            self._t(cand)).cpu().numpy()
        self.n_eval_loglike += len(cand)
        if np.any(np.isfinite(lml_exact)):
            best_e = int(np.argmax(np.where(np.isfinite(lml_exact),
                                            lml_exact, -np.inf)))
            self._theta = cand[best_e]
            self.log_marginal_likelihood_value_ = float(lml_exact[best_e])
        else:
            self._theta = cand[best]
            self.log_marginal_likelihood_value_ = -float(nlls[best])
        self._dL, self._dalpha = factorize(
            self.family, self._t(self._theta), self._dX, self._dy, n, noise)
        self._fitted = True
        return self

    def log_marginal_likelihood(self, theta=None):
        """LML at ``theta`` (default: current; K10 on the card)."""
        if self.n == 0:
            return -np.inf
        theta = self._theta if theta is None else np.asarray(theta)
        if self._dX is None:
            self._update_model()
        self.n_eval_loglike += 1
        return float(_lml_batch(
            self.family, self._dX, self._dy, self.n, self._noise_t(),
            self._t(np.atleast_2d(theta)))[0])

    # -------------------------------------------------------- trust region

    def update_trust_region(self):
        """Reference: gpry/gpr.py:554 + gpry/tools.py:308."""
        if self.trust_region_factor is None:
            self.trust_bounds = None
            return
        self.trust_bounds = shrink_bounds(
            self.bounds, self.X_train, self.y_train,
            factor=self.trust_region_factor, nstd=self.trust_region_nstd)

    # ---------------------------------------------------------------- predict

    def surrogate_params(self, nsv_max=None) -> SurrogateParams:
        """Snapshot the full prediction state as tensors."""
        d = self.d
        from gpry_tpu_torch.models.preprocessing import (affine_params_X,
                                                         affine_params_y)
        if getattr(self.preprocessing_X, "fitted", True):
            x_loc, x_scale = affine_params_X(self.preprocessing_X, d)
        else:
            x_loc, x_scale = np.zeros(d), np.ones(d)
        if getattr(self.preprocessing_y, "fitted", False):
            y_loc, y_scale = affine_params_y(self.preprocessing_y)
        else:
            y_loc, y_scale = 0.0, 1.0
        if self.clip_factor is not None and self.n > 0:
            cf = self.clip_factor
            clip_max = cf * np.max(self.y_train) \
                - (cf - 1) * np.min(self.y_train)
        else:
            clip_max = np.inf
        if self.infinities_classifier is not None and \
                self.infinities_classifier.n > 0:
            svm_params = self.infinities_classifier.device_params(
                nsv_max=nsv_max, dtype=self._dtype, device=self._device)
        else:
            svm_params = trivial_svm_params(d, dtype=self._dtype,
                                            device=self._device)
        if self.trust_bounds is not None:
            trust_lo = np.asarray(self.trust_bounds[:, 0], dtype=float)
            trust_hi = np.asarray(self.trust_bounds[:, 1], dtype=float)
        else:
            trust_lo = np.full(d, -np.inf)
            trust_hi = np.full(d, np.inf)
        return SurrogateParams(
            theta=self._t(self._theta), X=self._dX, y=self._dy, n=self.n,
            noise_var=self._noise_t(), L=self._dL, alpha=self._dalpha,
            x_loc=self._t(x_loc), x_scale=self._t(x_scale),
            y_loc=self._t(y_loc), y_scale=self._t(y_scale),
            y_max=self._t(self.y_max), clip_max=self._t(clip_max),
            svm=svm_params, trust_lo=self._t(trust_lo),
            trust_hi=self._t(trust_hi))

    def predict(self, X, return_std=False, return_cov=False,
                return_mean_grad=False, return_std_grad=False,
                validate=True, ignore_trust_region=False):
        """
        Host-facing prediction with reference semantics
        (gpry/gpr.py:1022-1265).  Returns numpy arrays.
        ``return_cov`` returns the full posterior covariance (raw-y units,
        ungated, through K7) as the second output beside the gated mean; it
        is exclusive with return_std and the gradients, as in sklearn.
        """
        if return_cov and (return_std or return_mean_grad
                           or return_std_grad):
            raise ValueError(
                "return_cov is exclusive with return_std and gradients.")
        X = np.atleast_2d(np.asarray(X, dtype=float))
        if validate:
            if X.ndim != 2 or X.shape[1] != self.d:
                raise ValueError(
                    f"X must be (n, {self.d}); got shape {X.shape}.")
            if not np.isfinite(X).all():
                raise ValueError("X contains NaN or inf.")
        self.n_eval += len(X)
        if self._dL is None or self.n == 0:
            # Not fit: prior mean zero / prior std.
            out = [np.zeros(len(X))]
            if return_std:
                if isinstance(self.family, tuple):
                    out.append(np.sqrt(spec_diag(
                        self.family, torch.as_tensor(self._theta),
                        torch.as_tensor(X)).numpy()))
                else:
                    out.append(np.full(len(X),
                                       float(np.exp(0.5 * self._theta[0]))))
            if return_mean_grad:
                out.append(np.zeros_like(X))
            if return_std_grad:
                out.append(np.zeros_like(X))
            return tuple(out) if len(out) > 1 else out[0]
        p = self.surrogate_params()
        if ignore_trust_region:
            p = p.replace(trust_lo=self._t(np.full(self.d, -np.inf)),
                          trust_hi=self._t(np.full(self.d, np.inf)))
        Xd = self._t(X)
        if return_cov:
            mean, std = surrogate_predict(self.family, p, Xd)
            Xq_ = ((Xd - p.x_loc) / p.x_scale).contiguous()
            _, cov_ = predict_meancov(self.family, p.theta, p.X, p.n,
                                      p.noise_var, p.L, p.alpha, Xq_)
            cov = cov_.cpu().numpy() * float(p.y_scale) ** 2
            return mean.cpu().numpy(), cov
        # mesh-aware dispatch: large batches DP-split over the rows, small
        # ones with a large training buffer TP-split over the training
        # axis, otherwise the single-device K2 (parallel/mesh.py)
        mean, std = _mesh.predict_maybe_sharded(self.family, p, Xd)
        out = [mean.cpu().numpy()]
        if return_std:
            out.append(std.cpu().numpy())
        if return_mean_grad or return_std_grad:
            _, _, g_mean, g_std = meanstd_grad(self.family, p, Xd)
            if return_mean_grad:
                out.append(g_mean.cpu().numpy())
            if return_std_grad:
                out.append(g_std.cpu().numpy())
        return tuple(out) if len(out) > 1 else out[0]

    def predict_std(self, X, validate=True):
        """Std only (reference: gpry/gpr.py:1275)."""
        return self.predict(X, return_std=True, validate=validate)[1]


__all__ = ["GaussianProcessRegressor", "SurrogateParams", "LBFGS_CHUNK",
           "surrogate_from_numpy", "surrogate_mean_std_smooth",
           "surrogate_mean_std_sweep", "surrogate_predict",
           "surrogate_predict_mean"]
