"""
RankedPool: Kriging-believer ranking of acquisition candidates (port of
gpry_tpu/acquisition/ranked_pool.py; reference behavior:
gpry/gp_acquisition.py:1194-1670).

The pool keeps ``size`` candidates ranked by *conditioned* acquisition
value: the acquisition each point would have if the points above it had
already been added to the GP with their predicted values.  Conditioning is
an O(nmax^2 k) block-Cholesky append on the ``SurrogateParams`` snapshot
(``acquisition.base.append_lie``).  ``add_bulk`` fills the pool greedily:
at each of the ``size`` rounds one sweep computes the conditioned std of
all remaining candidates, the argmax is appended as a believer lie, and
non-finite entries drop out.  With the acquisition function object at
hand the whole fill is the K4 kernel (``ops.fused.kriging_believer_fill``),
with no host read per round; without it, or with a device mesh up, a
per-round host loop over K2 sweeps does the same (with a mesh its sweeps
are row-split over the devices: ``parallel.mesh.predict_maybe_sharded``,
through which every prediction here goes).
"""

import numpy as np
import torch

from gpry_tpu_torch import config
from gpry_tpu_torch.acquisition.base import append_lie, grow_surrogate
from gpry_tpu_torch.acquisition.functions import LogExp
from gpry_tpu_torch.ops.fused import kriging_believer_fill
from gpry_tpu_torch.parallel import mesh as _mesh


def _predict(family, p, Xq):
    """Gated ``(mean, std)`` (K2), row-split over the device mesh when one
    is up (the same results)."""
    return _mesh.predict_maybe_sharded(family, p, Xq)


class RankedPool:
    """
    Parameters
    ----------
    size : int
        Number of proposals to keep (the pool has one buffer slot).
    gpr : GaussianProcessRegressor
        The surrogate (used for its params snapshot and kernel family).
    acq_func : callable
        ``acq(y, sigma) -> value`` on numpy arrays (hyperparameters
        already bound).
    acqf : AcquisitionFunction, optional
        The acquisition function object; enables the K4 bulk fill.
    """

    def __init__(self, size, gpr, acq_func, verbose=1, acqf=None):
        self.size = int(size)
        self._gpr = gpr
        self._family = gpr.family
        self._acq_func = acq_func
        self._acqf = acqf
        self.verbose = verbose
        d = gpr.d
        self.X = np.zeros((size + 1, d))
        self.y = np.zeros(size + 1)
        self.sigma = np.zeros(size + 1)
        self.acq = np.zeros(size + 1)
        self.acq_cond = np.full(size + 1, -np.inf)
        self.cache_counter = 0
        self._base_params = None
        self._cond_params = [None] * (size + 1)  # conditioned on slots < i

    def __len__(self):
        return self.size

    @property
    def min_acq(self):
        """Conditioned acq of the last kept slot; -inf while not full
        (reference: gpry/gp_acquisition.py:1237-1247)."""
        return self.acq_cond[self.size - 1]

    def _params0(self):
        if self._base_params is None:
            self._base_params = self._gpr.surrogate_params()
        return self._base_params

    def _t(self, a):
        p = self._params0()
        return torch.as_tensor(np.asarray(a, dtype=float), dtype=p.X.dtype,
                               device=p.X.device)

    def _sd(self, p, X):
        """Gated std of ``X`` (host numpy) under snapshot ``p`` (K2)."""
        _, sd = _predict(self._family, p, self._t(np.atleast_2d(X)))
        return sd.cpu().numpy()

    def _conditioned_params(self, i):
        """Surrogate conditioned on pool slots 0..i-1 (cached)."""
        if i == 0:
            return self._params0()
        if self._cond_params[i] is None:
            p = self._conditioned_params(i - 1)
            y_lie = self.y[i - 1]
            if not np.isfinite(y_lie):  # -inf lie: condition at a low value
                y_lie = float(np.min(self._gpr.y_train)) \
                    if self._gpr.n else 0.0
            self._cond_params[i] = append_lie(
                self._family, p, self._t(self.X[i - 1][None]),
                self._t([y_lie]))
            self.cache_counter += 1
        return self._cond_params[i]

    def _invalidate_from(self, i):
        for j in range(i + 1, self.size + 1):
            self._cond_params[j] = None

    # ------------------------------------------------------------------- add

    def add(self, X, y=None, sigma=None, acq=None, method="bulk"):
        """
        Add a batch of candidates (reference:
        gpry/gp_acquisition.py:1290-1335).  ``method``: "bulk" (vectorized,
        default) or "single sort acq" / "single sort y" / "single"
        (one-by-one insertion).
        """
        X = np.atleast_2d(np.asarray(X, dtype=float))
        if y is None or sigma is None:
            mu, sd = _predict(self._family, self._params0(), self._t(X))
            y = mu.cpu().numpy() if y is None else np.atleast_1d(y)
            sigma = sd.cpu().numpy() if sigma is None \
                else np.atleast_1d(sigma)
        else:
            y = np.atleast_1d(np.asarray(y, dtype=float))
            sigma = np.atleast_1d(np.asarray(sigma, dtype=float))
        if acq is None:
            acq = np.asarray(self._acq_func(y, sigma))
        else:
            acq = np.atleast_1d(np.asarray(acq, dtype=float))
        method = method.lower()
        if method == "bulk":
            self.add_bulk(X, y, sigma, acq)
        elif method.startswith("single"):
            if "sort" in method:
                key = {"acq": acq, "y": y}[method.split()[-1]]
                order = np.argsort(key)[::-1]
            else:
                order = np.arange(len(X))
            for i in order:
                self.add_one(X[i], y[i], sigma[i], acq[i])
        else:
            raise ValueError(f"Unknown ranking method '{method}'.")

    def add_bulk(self, X, y, sigma, acq):
        """
        Vectorized greedy fill (reference: gpry/gp_acquisition.py:1337-1390).
        Selected and ineligible candidates are masked out instead of
        removed.
        """
        keep = np.isfinite(acq)
        X, y, sigma, acq = X[keep], y[keep], sigma[keep], acq[keep]
        if len(X) == 0:
            return
        alive = np.ones(len(X), dtype=bool)
        p0 = self._params0()
        if self._acqf is not None and _mesh.available_mesh(p0.X) is None:
            # one device: the whole greedy fill is one K4 run; with a mesh
            # the host loop below keeps the sweeps row-split over it
            self._add_bulk_device(p0, X, y, sigma, acq)
            return
        Xd = self._t(X)
        for i in range(self.size):
            if not np.any(alive):
                break
            if i == 0:
                acq_cond = np.where(alive, acq, -np.inf)
            else:
                p = self._conditioned_params(i)
                _, sd_cond = _predict(self._family, p, Xd)
                acq_cond = np.asarray(self._acq_func(y, sd_cond.cpu().numpy()))
                # conditioned-ineligible candidates drop out permanently
                acq_cond = np.where(alive & np.isfinite(acq_cond),
                                    acq_cond, -np.inf)
                alive &= np.isfinite(acq_cond)
            j = int(np.argmax(acq_cond))
            if not np.isfinite(acq_cond[j]):
                break
            self.X[i], self.y[i] = X[j], y[j]
            self.sigma[i], self.acq[i] = sigma[j], acq[j]
            self.acq_cond[i] = acq_cond[j]
            self._invalidate_from(i - 1 if i else 0)
            alive[j] = False

    def _add_bulk_device(self, p0, X, y, sigma, acq):
        """The whole greedy fill on the device (K4), one host read at the
        end (gpry_tpu/acquisition/ranked_pool.py:265-294)."""
        p = grow_surrogate(p0, config.bucket_size(int(p0.n) + self.size))
        noise_std = float(np.mean(self._gpr.noise_level))
        acqf = self._acqf
        logexp = (acqf.zeta, noise_std) if type(acqf) is LogExp else None
        outs = kriging_believer_fill(
            self._family, p, self._t(X), self._t(y), self._t(sigma),
            self._t(acq), torch.ones(len(X), dtype=torch.bool,
                                     device=p.X.device),
            self.size, lambda yy, sd: acqf.values(yy, sd, p.y_max, noise_std),
            logexp=logexp)
        outX, outY, outS, outA, outC = (o.cpu().numpy() for o in outs)
        filled = np.isfinite(outC)
        self.X[:self.size][filled] = outX[filled]
        self.y[:self.size][filled] = outY[filled]
        self.sigma[:self.size][filled] = outS[filled]
        self.acq[:self.size][filled] = outA[filled]
        self.acq_cond[:self.size] = outC
        self.cache_counter += int(filled.sum())
        self._invalidate_from(0)

    def add_one(self, X, y=None, sigma=None, acq=None):
        """
        Insert a single candidate with conditioned re-ranking
        (reference: gpry/gp_acquisition.py:1392-1520).
        """
        X = np.atleast_1d(np.asarray(X, dtype=float))
        if y is None or sigma is None:
            mu, sd = _predict(self._family, self._params0(),
                              self._t(X[None]))
            y = float(mu[0]) if y is None else float(y)
            sigma = float(sd[0]) if sigma is None else float(sigma)
        if acq is None:
            acq = float(self._acq_func(np.atleast_1d(y),
                                       np.atleast_1d(sigma))[0])
        if not np.isfinite(acq) or acq <= self.min_acq:
            return
        # Walk down: conditioned acq can only decrease with depth, so keep
        # descending while the (reconditioned) value loses to the incumbent.
        pos = 0
        acq_cond = acq
        while pos < self.size and acq_cond <= self.acq_cond[pos]:
            pos += 1
            if pos >= self.size:
                return
            sd_c = self._sd(self._conditioned_params(pos), X)
            acq_cond = float(self._acq_func(np.atleast_1d(y), sd_c)[0])
            if not np.isfinite(acq_cond):
                return
        # shift down and insert
        self.X[pos + 1:] = self.X[pos:-1]
        self.y[pos + 1:] = self.y[pos:-1]
        self.sigma[pos + 1:] = self.sigma[pos:-1]
        self.acq[pos + 1:] = self.acq[pos:-1]
        self.acq_cond[pos + 1:] = self.acq_cond[pos:-1]
        self.X[pos], self.y[pos] = X, y
        self.sigma[pos], self.acq[pos] = sigma, acq
        self.acq_cond[pos] = acq_cond
        self._invalidate_from(pos)
        # re-rank everything below the insertion point under the new
        # conditioning (cheap batched recomputation)
        self._resort_below(pos)

    def _resort_below(self, pos):
        """Recompute conditioned acq for slots > pos, greedily."""
        tail = slice(pos + 1, self.size + 1)
        Xt = self.X[tail].copy()
        yt = self.y[tail].copy()
        st = self.sigma[tail].copy()
        at = self.acq[tail].copy()
        valid = np.isfinite(self.acq_cond[tail])
        self.acq_cond[tail] = -np.inf
        if not np.any(valid):
            return
        # greedy refill of the tail using conditioned params from pos+1
        Xv, yv, sv, av = Xt[valid], yt[valid], st[valid], at[valid]
        i_out = pos + 1
        for _ in range(len(yv)):
            if i_out > self.size or len(yv) == 0:
                break
            sd_cond = self._sd(self._conditioned_params(i_out), Xv)
            acq_cond = np.asarray(self._acq_func(yv, sd_cond))
            j = int(np.argmax(acq_cond))
            if not np.isfinite(acq_cond[j]):
                break
            self.X[i_out], self.y[i_out] = Xv[j], yv[j]
            self.sigma[i_out], self.acq[i_out] = sv[j], av[j]
            self.acq_cond[i_out] = acq_cond[j]
            self._invalidate_from(i_out - 1 if i_out else 0)
            sel = np.ones(len(yv), dtype=bool)
            sel[j] = False
            Xv, yv, sv, av = Xv[sel], yv[sel], sv[sel], av[sel]
            i_out += 1

    # --------------------------------------------------------------- results

    def get(self):
        """Top ``size`` proposals as (X, y_lies, acq_values)."""
        filled = np.isfinite(self.acq_cond[:self.size])
        return (self.X[:self.size][filled], self.y[:self.size][filled],
                self.acq_cond[:self.size][filled])

    def reset(self, gpr=None):
        if gpr is not None:
            self._gpr = gpr
            self._family = gpr.family
        self.acq_cond[:] = -np.inf
        self._base_params = None
        self._cond_params = [None] * (self.size + 1)

    def __getstate__(self):
        """Drop unpicklable/heavy refs (reference:
        gpry/gp_acquisition.py:1564-1573)."""
        state = self.__dict__.copy()
        state["_gpr"] = None
        state["_acq_func"] = None
        state["_acqf"] = None
        state["_base_params"] = None
        state["_cond_params"] = [None] * (self.size + 1)
        return state
