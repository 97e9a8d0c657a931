"""
NORA: Nested sampling Optimization of the Ranked Acquisition (port of
gpry_tpu/acquisition/nora.py; reference behavior:
gpry/gp_acquisition.py:525-1191, the engine of arXiv:2305.19267).

Instead of ascending the acquisition, NORA runs a nested sampler over the
*surrogate* posterior, evaluates the acquisition on the (dead + live) NS
sample, and picks a Kriging-believer batch with a ranked pool.  The NS
sample doubles as the surrogate MC sample of the GaussianKL convergence
criterion and of the mean/cov estimates.

On the device:

* the NS run is ``mc.nested`` (every log-density through K1);
* the mean and std over the NS sample, and over the stored sample when it
  is reused, are one K2 sweep each;
* the acquisition over the sample is ``acq_func.values`` in torch (an
  elementwise pass);
* the ranked pool's greedy fill is the K4 kernel.

NS effort follows the reference schedule: ``nlive = min(3 n_train,
nlive_max)`` (in quarters of ``nlive_max``), ``num_repeats = 5d``,
``precision_criterion = 0.01`` (gpry/gp_acquisition.py:684-699).
``sampler="polychord"``, ``"ultranest"`` or ``"nessai"`` runs that host
engine (``mc.interfaces``) over the surrogate, each of its likelihood
requests one K1 sweep; an engine that does not import falls back along the
reference's chain to the device sampler, with a warning.
"""

import numpy as np
import torch

from gpry_tpu_torch.acquisition.base import GenericGPAcquisition
from gpry_tpu_torch.acquisition.ranked_pool import RankedPool
from gpry_tpu_torch.mc.nested import run_nested_device
from gpry_tpu_torch.mc.samples import surrogate_logp_fn
from gpry_tpu_torch.parallel import mesh as _mesh
from gpry_tpu_torch.parallel.rng import torch_generator_from_rng
from gpry_tpu_torch.utils.tools import (check_and_return_bounds,
                                        mean_covmat_from_samples)


class NORA(GenericGPAcquisition):
    """
    Reference-compatible constructor (gpry/gp_acquisition.py:584-634):
    defaults ``mc_every="1d"``, ``nlive_per_training=3``,
    ``nlive_max="25d"``, ``num_repeats="5d"``,
    ``precision_criterion_target=0.01``.
    """

    def __init__(self, bounds, acq_func="LogExp", mc_every="1d",
                 nlive_per_training=3, nlive_max="25d", num_repeats="5d",
                 precision_criterion_target=0.01, nprior_per_nlive=10,
                 min_ess_reuse="2d", sampler="device", preprocessing_X=None,
                 zeta_scaling=0.85, verbose=1, rng=None):
        super().__init__(bounds, acq_func=acq_func,
                         preprocessing_X=preprocessing_X,
                         zeta_scaling=zeta_scaling, verbose=verbose)
        self.mc_every = self._parse_dim_spec(mc_every, "mc_every")
        # Reweighting-collapse guard (as the JAX package, beyond the
        # reference): a reweighted sample whose effective size drops below
        # this forces a fresh NS run.
        self.min_ess_reuse = self._parse_dim_spec(min_ess_reuse,
                                                  "min_ess_reuse")
        self.nlive_per_training = int(nlive_per_training)
        self.nlive_max = self._parse_dim_spec(nlive_max, "nlive_max")
        self.num_repeats = self._parse_dim_spec(num_repeats, "num_repeats")
        self.precision_criterion_target = float(precision_criterion_target)
        self.nprior_per_nlive = int(nprior_per_nlive)
        self.sampler = sampler
        self.rng = rng if isinstance(rng, np.random.Generator) \
            else np.random.default_rng(rng)
        self._iter_since_mc = None  # None -> force MC at first call
        self.last_MC_X = None
        self.last_MC_logp = None
        self.last_MC_logw = None
        self.last_MC_sigma = None
        self._proposed = np.empty((0, self.d))
        self.mean = None
        self.cov = None
        self.last_logZ = None

    def force_resample(self):
        """Discard the cached NS sample: the next acquisition call runs a
        fresh nested-sampling sweep instead of reweighting the last one."""
        self._iter_since_mc = None

    # -- NS effort schedule (reference: gpry/gp_acquisition.py:684-699) ------

    def _nlive(self, gpr):
        nlive = min(self.nlive_per_training * max(gpr.n, 1), self.nlive_max)
        quarter = max(1, self.nlive_max // 4)
        return int(min(self.nlive_max,
                       max(quarter, int(np.ceil(nlive / quarter)) * quarter)))

    # ------------------------------------------------------------- NS running

    def _run_ns(self, gpr):
        if self.sampler not in (None, "device"):
            # a host engine, with the reference's fallback chain
            # (gpry/gp_acquisition.py:650-682) ending in the device sampler
            from gpry_tpu_torch.mc.interfaces import (InterfaceDevice,
                                                      init_nested_sampler)
            iface = init_nested_sampler(self.sampler, verbose=self.verbose)
            if not isinstance(iface, InterfaceDevice):
                return self._run_ns_host(gpr, iface)
        p = gpr.surrogate_params()
        dt, dev = p.X.dtype, p.X.device
        lo = torch.as_tensor(self.bounds[:, 0], dtype=dt, device=dev)
        hi = torch.as_tensor(self.bounds[:, 1], dtype=dt, device=dev)
        nlive = self._nlive(gpr)
        max_dead = int(nlive * max(8, 2 * self.d))
        gen = torch_generator_from_rng(self.rng, dev)
        # each step's chains DP-split over the available mesh (the analogue
        # of PolyChord's MPI-parallel live-point evolution)
        res = run_nested_device(
            surrogate_logp_fn(gpr.family), p, gen, lo, hi, nlive=nlive,
            num_repeats=int(self.num_repeats),
            precision_criterion=self.precision_criterion_target,
            max_dead=max_dead, n_prior=int(self.nprior_per_nlive) * nlive,
            mesh=_mesh.available_mesh(p.X))
        gpr.n_eval += int(res.n_calls)
        logw = res.logw.cpu().numpy()
        logl = res.logl.cpu().numpy()
        keep = np.isfinite(logw) & np.isfinite(logl)
        X = res.X.cpu().numpy()[keep]
        # std over the sample: one K2 sweep, row-split over the mesh
        _, sd = _mesh.predict_maybe_sharded(
            gpr.family, p, torch.as_tensor(X, dtype=dt, device=dev))
        self.last_MC_X = X
        self.last_MC_logp = logl[keep]
        self.last_MC_logw = logw[keep]
        self.last_MC_sigma = sd.cpu().numpy()
        self.last_logZ = float(res.logZ)
        self.log(f"[NORA] NS run: {len(X)} samples, nlive={nlive}, "
                 f"logZ={self.last_logZ:.3f}, calls={int(res.n_calls)}",
                 level=3)

    def _run_ns_host(self, gpr, iface):
        """NS by a host engine (gpry_tpu/acquisition/nora.py:178): each
        batch of its likelihood requests is one gated-mean sweep (K1) on
        the device."""
        from gpry_tpu_torch.models.gp import surrogate_predict_mean
        p = gpr.surrogate_params()
        dt, dev = p.X.dtype, p.X.device

        def logp_host(X):
            X = np.atleast_2d(np.asarray(X, dtype=float))
            return surrogate_predict_mean(
                gpr.family, p, torch.as_tensor(X, dtype=dt, device=dev)
            ).cpu().numpy()

        nlive = self._nlive(gpr)
        iface.set_prior(self.bounds)
        iface.set_precision(
            nlive=nlive, num_repeats=int(self.num_repeats),
            precision_criterion=self.precision_criterion_target,
            nprior=int(self.nprior_per_nlive) * nlive,
            seed=int(self.rng.integers(2**31)))
        res = iface.run(logp_host)
        X = np.asarray(res["X"], dtype=float)
        logp = np.asarray(res["logpost"], dtype=float)
        w = np.asarray(res["weights"], dtype=float)
        keep = np.isfinite(logp) & (w > 0)
        X, logp, w = X[keep], logp[keep], w[keep]
        gpr.n_eval += int(res.get("n_calls", len(X)))
        # std over the sample: one K2 sweep, row-split over the mesh
        _, sd = _mesh.predict_maybe_sharded(
            gpr.family, p, torch.as_tensor(X, dtype=dt, device=dev))
        self.last_MC_X = X
        self.last_MC_logp = logp
        self.last_MC_logw = np.log(w / np.max(w))
        self.last_MC_sigma = sd.cpu().numpy()
        self.last_logZ = float(res.get("logZ", np.nan))
        self.log(f"[NORA] host NS run ({type(iface).__name__}): {len(X)} "
                 f"samples, nlive={nlive}, logZ={self.last_logZ:.3f}",
                 level=3)

    def _reweight_last(self, gpr):
        """Reuse the stored NS sample under the updated GP
        (reference: gpry/gp_acquisition.py:875-919)."""
        p = gpr.surrogate_params()
        mu, sd = _mesh.predict_maybe_sharded(
            gpr.family, p, torch.as_tensor(self.last_MC_X, dtype=p.X.dtype,
                                           device=p.X.device))
        mu = mu.cpu().numpy()
        with np.errstate(invalid="ignore"):
            logw = self.last_MC_logw + (mu - self.last_MC_logp)
        # points newly gated to -inf under the updated GP produce
        # -inf - -inf = nan: they carry no posterior mass now
        self.last_MC_logw = np.where(np.isfinite(logw), logw, -np.inf)
        self.last_MC_logp = mu
        self.last_MC_sigma = sd.cpu().numpy()
        gpr.n_eval += len(mu)

    def _reweight_ess(self):
        """Kish effective sample size of the current (reweighted) sample."""
        logw = self.last_MC_logw
        if logw is None or not np.any(np.isfinite(logw)):
            return 0.0
        w = np.exp(logw - np.max(logw[np.isfinite(logw)]))
        w = np.where(np.isfinite(w), w, 0.0)
        s = w.sum()
        if s <= 0:
            return 0.0
        return float(s * s / np.sum(w * w))

    # ----------------------------------------------------------------- multi_add

    def multi_add(self, gpr, n_points=1, bounds=None, rng=None,
                  force_resample=False):
        """
        Propose ``n_points`` Kriging-believer points from the ranked NS
        sample (reference: gpry/gp_acquisition.py:971-1108).
        ``force_resample`` forces a fresh NS run even mid ``mc_every``
        cadence (the Runner sets it after a starved acquisition).
        Returns (X (n, d), y_lies (n,), acq_values (n,)), n <= n_points.
        """
        if rng is not None and isinstance(rng, np.random.Generator):
            self.rng = rng
        if force_resample:
            self._iter_since_mc = None
        if bounds is not None:
            b = check_and_return_bounds(bounds)
            if not np.allclose(b, self.bounds):
                self.bounds = b
                self._iter_since_mc = None  # force resample
        # 1. fresh NS sample or reweighted reuse
        if (self._iter_since_mc is None
                or self._iter_since_mc >= self.mc_every
                or self.last_MC_X is None or len(self.last_MC_X) == 0):
            self._run_ns(gpr)
            self._iter_since_mc = 0
            self._proposed = np.empty((0, self.d))
        else:
            self._reweight_last(gpr)
            ess = self._reweight_ess()
            if ess < self.min_ess_reuse:
                self.log(f"[NORA] reweighted ESS {ess:.1f} < "
                         f"{self.min_ess_reuse}: forcing a fresh NS run.",
                         level=3)
                self._run_ns(gpr)
                self._iter_since_mc = 0
                self._proposed = np.empty((0, self.d))
        self._iter_since_mc += 1

        # Degenerate NS outcome: every sample gated to -inf.  Return an
        # EMPTY proposal; the Runner's starvation path then retries with
        # force_resample and gives up gracefully after its budget.
        if (self.last_MC_X is None or len(self.last_MC_X) == 0
                or not np.any(np.isfinite(self.last_MC_logw))):
            self.log("[NORA] NS produced no finite-weight samples; "
                     "returning an empty proposal.", level=2)
            self.mean, self.cov = None, None
            return (np.empty((0, self.d)), np.empty(0), np.empty(0))

        X = self.last_MC_X
        y = self.last_MC_logp
        sd = self.last_MC_sigma

        # mean/cov of the surrogate posterior from the weighted sample
        w = np.exp(self.last_MC_logw - np.max(self.last_MC_logw))
        try:
            self.mean, self.cov = mean_covmat_from_samples(X, w)
        except Exception:
            self.mean, self.cov = None, None

        # 2. drop already-proposed points (gpry/gp_acquisition.py:1037-1047)
        if len(self._proposed):
            fresh = ~np.any(
                np.all(np.isclose(X[:, None, :], self._proposed[None],
                                  atol=1e-12), axis=-1), axis=-1)
            X, y, sd = X[fresh], y[fresh], sd[fresh]

        # 3. acquisition over the sample (one elementwise device pass);
        # noise_std is the acquisition function's own convention
        # (reference: gpry/acquisition_functions.py:973-983)
        noise_std = self.acq_func._noise_std(gpr)
        p = gpr.surrogate_params()
        as_t = lambda a: torch.as_tensor(np.asarray(a, dtype=float),
                                         dtype=p.X.dtype, device=p.X.device)

        def acq_fn(yy, ss):
            return self.acq_func.values(as_t(yy), as_t(ss), gpr.y_max,
                                        noise_std).cpu().numpy()

        acq = acq_fn(y, sd)

        # 4. ranked-pool Kriging-believer selection
        pool = RankedPool(n_points, gpr, acq_fn, verbose=self.verbose,
                          acqf=self.acq_func)
        pool.add(X, y=y, sigma=sd, acq=acq, method="bulk")
        X_out, y_lies, acq_out = pool.get()
        self._proposed = np.vstack([self._proposed, X_out]) \
            if len(self._proposed) else np.copy(X_out)
        return X_out, y_lies, acq_out

    # -------------------------------------------------------------- accessors

    def last_MC_sample(self):
        """(X, logp, weights) of the last surrogate NS sample
        (reference: gpry/gp_acquisition.py:921-954)."""
        if self.last_MC_X is None:
            raise ValueError("No NS sample available yet.")
        if len(self.last_MC_X) == 0 or \
                not np.any(np.isfinite(self.last_MC_logw)):
            raise ValueError("The last NS sample is empty (all samples "
                             "gated to -inf).")
        w = np.exp(self.last_MC_logw - np.max(self.last_MC_logw))
        return self.last_MC_X, self.last_MC_logp, w

    def last_MC_sample_getdist(self, params=None):
        """The last NS sample as getdist ``MCSamples`` (gpry_tpu's
        ``NORA.last_MC_sample_getdist``); ``ImportError`` where getdist is
        missing."""
        from gpry_tpu_torch.mc.samples import samples_dict_to_getdist
        X, logp, w = self.last_MC_sample()
        return samples_dict_to_getdist(
            {"X": X, "logpost": logp, "weights": w}, params=params)

    def __getstate__(self):
        state = self.__dict__.copy()
        state["rng"] = None
        return state

    def __setstate__(self, state):
        self.__dict__.update(state)
        if self.rng is None:
            self.rng = np.random.default_rng()
