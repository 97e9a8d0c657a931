"""
BatchOptimizer: gradient-based batch acquisition with Kriging-believer
(port of gpry_tpu/acquisition/batch_optimizer.py; reference behavior:
gpry/gp_acquisition.py:121-523).

Each believer step is one batched screen of proposer draws (the K2 kernel
in its LogExp mode), the multistart L-BFGS ascent of the smooth LogExp over
the polished starts in one K9 launch (any other acquisition: the lock-step
torch L-BFGS over K8's gradients), a K2 rescore of the endpoints, and an
O(nmax^2) block-Cholesky append of the lie.  With ``acq_optimizer=
"sampling"`` (scipy's Powell) or a callable, the polish is gradient-free
and host-driven instead: each objective call is one gated evaluation at
one point (a K2 launch for LogExp).
"""

import numpy as np
import torch

from gpry_tpu_torch import config
from gpry_tpu_torch.acquisition.base import GenericGPAcquisition, \
    append_lie
from gpry_tpu_torch.acquisition.functions import LogExp
from gpry_tpu_torch.acquisition.proposal import CentroidsProposer, \
    PartialProposer
from gpry_tpu_torch.models.gp import (LBFGS_CHUNK, SurrogateParams,
                                      surrogate_mean_std_smooth,
                                      surrogate_predict)
from gpry_tpu_torch.ops.fused import GRAD_MAX_D, gated_meanvar_logexp, \
    lbfgs_logexp_ascent
from gpry_tpu_torch.ops.lbfgs import minimize_lbfgs_bounded
from gpry_tpu_torch.utils.tools import check_and_return_bounds


def _acq_values_gated(family, p: SurrogateParams, zeta, noise_std_raw,
                      X_raw):
    """LogExp acquisition with all gates (-inf outside), in one K2 pass;
    ``noise_std_raw`` is the raw-space noise std, squared inside."""
    return gated_meanvar_logexp(family, p, X_raw,
                                logexp=(float(zeta), float(noise_std_raw)))


def _acq_values_generic(family, acqf, p: SurrogateParams, noise_std_raw,
                        X_raw):
    """Gated values of an arbitrary acquisition function."""
    mu, std = surrogate_predict(family, p, X_raw)
    vals = acqf.values(mu, std, p.y_max, noise_std_raw)
    return torch.where(torch.isfinite(mu), vals,
                       torch.full_like(vals, -torch.inf))


def _optimize_restarts_generic(family, acqf, p: SurrogateParams,
                               noise_std_raw, x0s, lo, hi, maxiter=100):
    """Batched multistart ascent of an arbitrary acquisition function over
    the smooth surrogate; endpoints re-scored gated."""

    def neg_acq(X):
        mu, std = surrogate_mean_std_smooth(family, p, X)
        mu_c = torch.minimum(mu, p.clip_max)
        return -acqf.values(mu_c, std, p.y_max, noise_std_raw)

    xs, _, _ = minimize_lbfgs_bounded(neg_acq, x0s, lo, hi, maxiter=maxiter,
                                      tol=1e-8)
    return xs, _acq_values_generic(family, acqf, p, noise_std_raw, xs)


def _optimize_restarts(family, p: SurrogateParams, zeta, noise_std_raw,
                       x0s, lo, hi, maxiter=100):
    """
    Batched multistart bounded maximization of the *smooth* LogExp
    acquisition (gates applied to the final values only, as the
    reference's analytic smooth gradients, gpry/gp_acquisition.py:316-334):
    one K9 launch, then one K2 rescore.  Returns (xs, gated acq values).
    """
    xs, _, _ = lbfgs_logexp_ascent(family, p, zeta, noise_std_raw, x0s, lo,
                                   hi, maxiter=maxiter)
    return xs, _acq_values_gated(family, p, zeta, noise_std_raw, xs)


class BatchOptimizer(GenericGPAcquisition):
    """
    Reference-compatible constructor (gpry/gp_acquisition.py:208-218):
    defaults ``n_restarts_optimizer="5d"``, ``n_repeats_propose=10``.
    """

    def __init__(self, bounds, acq_func="LogExp", acq_optimizer="lbfgs",
                 n_restarts_optimizer="5d", n_repeats_propose=10,
                 preprocessing_X=None, zeta_scaling=0.85, verbose=1,
                 proposer=None, random_state=None):
        if not (callable(acq_optimizer) or acq_optimizer in (
                "lbfgs", "fmin_l_bfgs_b", "sampling", None)):
            raise ValueError(f"Unknown acq_optimizer {acq_optimizer!r}: "
                             "'lbfgs', 'sampling' or a callable.")
        super().__init__(bounds, acq_func=acq_func,
                         preprocessing_X=preprocessing_X,
                         zeta_scaling=zeta_scaling, verbose=verbose)
        if self.d > GRAD_MAX_D and config.get_device().type == "cuda":
            # the ascent's gradients are K8's / K9's, at most two
            # coordinates a warp lane (the nested sampler's range too)
            raise ValueError(
                f"BatchOptimizer: d={self.d} > {GRAD_MAX_D}, the most its "
                "gradient kernels hold on the card; use the CPU.")
        self.acq_optimizer = acq_optimizer
        self.n_restarts_optimizer = self._parse_dim_spec(
            n_restarts_optimizer, "n_restarts_optimizer")
        self.n_repeats_propose = int(n_repeats_propose)
        # Default proposer: centroids of training subsets + 25% uniform
        # (reference: gpry/gp_acquisition.py:236-247 via proposal.py:163).
        self.proposer = proposer or PartialProposer(
            self.bounds, CentroidsProposer(self.bounds))
        self.obj_fun_eval_num = 0

    def multi_add(self, gpr, n_points=1, bounds=None, rng=None,
                  force_resample=False):
        """
        Propose ``n_points`` Kriging-believer points.
        Returns (X (n,d), y_lies (n,), acq_values (n,)).
        """
        if n_points < 1:
            raise ValueError(f"n_points must be >= 1, got {n_points}")
        rng = rng if isinstance(rng, np.random.Generator) \
            else np.random.default_rng(rng)
        bounds = check_and_return_bounds(
            bounds if bounds is not None else self.bounds)
        family = gpr.family
        p = gpr.surrogate_params()
        # LogExp takes the fused K2 path; any other acq_func is evaluated
        # and ascended through its own ``values`` (exact type: the
        # NonlinearLogExp subclass has another formula).
        fused = type(self.acq_func) is LogExp
        zeta = float(getattr(self.acq_func, "zeta", 1.0))
        noise_std_raw = float(self.acq_func._noise_std(gpr))
        dt, dev = p.X.dtype, p.X.device
        as_t = lambda a: torch.as_tensor(np.asarray(a, dtype=float),
                                         dtype=dt, device=dev)

        def score(p_, X_):
            if fused:
                return _acq_values_gated(family, p_, zeta, noise_std_raw,
                                         X_)
            return _acq_values_generic(family, self.acq_func, p_,
                                       noise_std_raw, X_)

        def ascend(p_, x0s_, lo_, hi_):
            if fused:
                return _optimize_restarts(family, p_, zeta, noise_std_raw,
                                          x0s_, lo_, hi_)
            return _optimize_restarts_generic(
                family, self.acq_func, p_, noise_std_raw, x0s_, lo_, hi_)

        lo, hi = as_t(bounds[:, 0]), as_t(bounds[:, 1])
        gradient_free = self.acq_optimizer not in ("lbfgs", "fmin_l_bfgs_b",
                                                   None)
        self.proposer.update(gpr)
        self.proposer.update_bounds(bounds)

        X_out = np.empty((n_points, self.d))
        y_lies = np.empty(n_points)
        acq_out = np.empty(n_points)
        # Screen-then-polish: n_restarts_optimizer sets the screening
        # breadth; only LBFGS_CHUNK lanes are polished.
        R = max(2, self.n_restarts_optimizer)
        R_polish = min(LBFGS_CHUNK, R)
        for i in range(n_points):
            n_screen = min(10 * self.d * R, 4000)
            cand = self.proposer.get_batch(n_screen, rng)
            acq_cand = score(p, as_t(cand)).cpu().numpy()
            self.obj_fun_eval_num += n_screen
            order = np.argsort(acq_cand)[::-1]
            starts = [cand[order[:R_polish - 1]]]
            # restart 0 from the last in-bounds training point
            # (reference: gpry/gp_acquisition.py:342-351)
            Xt = gpr.X_train
            in_b = np.all((Xt >= bounds[:, 0]) & (Xt <= bounds[:, 1]),
                          axis=1) if len(Xt) else np.array([], bool)
            if np.any(in_b):
                starts.insert(0, Xt[in_b][-1:])
            x0s = np.vstack(starts)[:R_polish]
            if len(x0s) < R_polish:
                x0s = np.vstack([x0s, cand[order[len(x0s):R_polish]]])

            if gradient_free:
                xs, vals = self._polish_gradient_free(score, p, x0s, bounds,
                                                      as_t)
            else:
                xs, vals = ascend(p, as_t(x0s), lo, hi)
                xs, vals = xs.cpu().numpy(), vals.cpu().numpy()
            # fall back to the best screened candidate if the polish failed
            if not np.any(np.isfinite(vals)):
                best_x = cand[order[0]]
                best_val = acq_cand[order[0]]
            else:
                j = int(np.nanargmax(vals))
                best_x, best_val = xs[j], vals[j]
                if acq_cand[order[0]] > best_val:
                    best_x, best_val = cand[order[0]], acq_cand[order[0]]
            X_out[i] = best_x
            acq_out[i] = best_val

            # Kriging believer: lie = GP prediction, conditioned in
            y_lie, _ = surrogate_predict(family, p, as_t(best_x[None]))
            y_lie = float(y_lie[0])
            if not np.isfinite(y_lie):
                y_lie = float(np.min(gpr.y_train)) if gpr.n else 0.0
            y_lies[i] = y_lie
            if i + 1 < n_points:
                p = append_lie(family, p, as_t(best_x[None]),
                               as_t([y_lie]))
        self.mean, self.cov = None, None
        return X_out, y_lies, acq_out

    def _polish_gradient_free(self, score, p, x0s, bounds, as_t):
        """
        Host-driven gradient-free polish of a few screened starts
        (gpry_tpu/acquisition/batch_optimizer.py:278-310, the reference's
        ``acq_optimizer="sampling"`` and user callables): scipy's Powell,
        or ``acq_optimizer(fun, x0, bounds=bounds) -> (x_opt, f_opt)``.
        Each objective call is one gated evaluation at one point
        (``score``; K2 for LogExp), counted in ``obj_fun_eval_num``.
        Returns the optimizer's own ``(x_opt, -f_opt)`` for each start.
        """
        import scipy.optimize

        def neg_acq(x):
            v = float(score(p, as_t(np.atleast_2d(x))).cpu()[0])
            self.obj_fun_eval_num += 1
            return -v if np.isfinite(v) else 1e30

        xs, vals = [], []
        for x0 in np.asarray(x0s)[:max(2, min(4, len(x0s)))]:
            if callable(self.acq_optimizer):
                x_opt, f_opt = self.acq_optimizer(neg_acq, x0, bounds=bounds)
            else:
                res = scipy.optimize.minimize(neg_acq, x0, method="Powell",
                                              bounds=bounds)
                x_opt, f_opt = res.x, float(res.fun)
            xs.append(np.asarray(x_opt, dtype=float))
            vals.append(-f_opt if np.isfinite(f_opt) else -np.inf)
        return np.asarray(xs), np.asarray(vals)
