"""
The Runner: the user-facing active-learning loop (port of
gpry_tpu/run.py, the core loop of its ``_run_main_loop``).

Same API and loop as the JAX package: initial truth sampling, then
acquire / evaluate / fit / check-convergence until converged or the budget
is spent, then a final MC run on the surrogate.  The host runs the outer
loop, truth evaluation and bookkeeping; GP fits, acquisition and the final
MC run on the package device (``config.get_device()``) through the CUDA
kernels of ``ops.fused``, with the reference's auto-built kernel or any
composite kernel (``gpr={"kernel": {...}}``, run in the kernels' spec
mode).

The port runs the BatchOptimizer loop (LogExp, CorrectCounter) and the
NORA loop (CorrectCounter + GaussianKL + TrainAlignment, with the
mode-signature stability veto), with the starvation (Sobol exploration)
fallback, the flat-surrogate and amplitude-underfit vetoes and the
mode-aware convergence audit (``options["audit"]``, on by default as in
the JAX package; its ungated sweeps are the K5 kernel); the final sampler
is "nested" (default), "mcmc" or "uniform".  Features of later slices
raise ``NotImplementedError`` naming their ROADMAP.md item: checkpoints,
plots, the host samplers, and truth executors other than "serial".

Defaults follow gpry/run.py:531-537: n_initial=3d, max_initial=30d^1.5,
max_total=70d^1.5, n_points_per_acq=d, fit_full_every=2*sqrt(d) (full
multi-restart fit), fit_simple_every=1.
"""

import numpy as np

from gpry_tpu_torch.acquisition import proposal as proposal_module
from gpry_tpu_torch.acquisition.base import GenericGPAcquisition
from gpry_tpu_torch.acquisition.batch_optimizer import BatchOptimizer
from gpry_tpu_torch.acquisition.nora import NORA
from gpry_tpu_torch.convergence import (ConvergenceCheckError,
                                        ConvergenceCriterion, CorrectCounter,
                                        DontConverge, GaussianKL,
                                        TrainAlignment, construct_criterion)
from gpry_tpu_torch.models.gp import GaussianProcessRegressor, \
    surrogate_mean_std_sweep
from gpry_tpu_torch.models.preprocessing import Normalize_bounds, \
    Normalize_y
from gpry_tpu_torch.parallel import TruthExecutor, get_random_generator
from gpry_tpu_torch.progress import Progress, Timer, TimerCounter
from gpry_tpu_torch.truth import get_truth
from gpry_tpu_torch.utils.modes import detect_modes, mode_signature, \
    modes_match
from gpry_tpu_torch.utils.tools import (check_candidates,
                                        credibility_of_nstd,
                                        delta_logp_of_1d_nstd,
                                        gaussian_distance, get_Xnumber,
                                        kl_norm, mean_covmat_from_evals,
                                        mean_covmat_from_samples)

_VERBOSITY_ERROR, _VERBOSITY_WARN, _VERBOSITY_INFO = 1, 2, 3
_VERBOSITY_DEBUG = 4


def _not_ported(what, item):
    return NotImplementedError(
        f"{what} is not ported to gpry_tpu_torch yet (ROADMAP.md §A, "
        f"'{item}').")


class Runner:
    """
    Drives the GP-surrogate characterization of a log-posterior
    (reference: gpry/run.py:36-197 for the argument documentation).
    """

    def __init__(self, loglike=None, bounds=None, ref_bounds=None,
                 params=None, gpr="RBF", gp_acquisition="LogExp",
                 initial_proposer="reference", convergence_criterion=None,
                 callback=None, callback_is_MPI_aware=False, options=None,
                 checkpoint=None, load_checkpoint=None, seed=None, mc=None,
                 plots=False, verbose=3, truth_executor="serial"):
        if checkpoint is not None or load_checkpoint is not None:
            raise _not_ported("checkpoint=", "io/checkpoints")
        if plots:
            raise _not_ported("plots=True", "periphery")
        if loglike is None:
            raise ValueError("'loglike' is required.")
        self.verbose = verbose
        self.rng = get_random_generator(seed)
        self.callback = callback
        self.callback_is_MPI_aware = callback_is_MPI_aware
        self._mc_options = self._construct_mc_options(mc)
        self.last_mc_result = None
        self._mc_at_n_total = -1
        self.fiducial_point = None
        self.fiducial_MC = None
        self.has_converged = False
        self.current_iteration = 0
        self.mean, self.cov = None, None
        # starved-acquisition exploration state (_starved_exploration_batch)
        self._n_explored = 0
        self._explore_net_i = 0
        self._explore_seed = None
        # True once exploration ever fired while the surrogate was FLAT:
        # convergence is then not accepted until the Sobol net is spent
        self._flat_explored = False
        # mode-signature veto state: the acquisition sample's signature at
        # the last convergence checks, and the consecutive vetoes since the
        # last stable signature (capped by max_mode_vetoes)
        self._mode_sig_hist = []
        self._mode_sig_now = None
        self._last_modes = None
        self._mode_veto_streak = 0
        # convergence-audit state (see _convergence_audit): truth evals
        # spent on audits, the box-normalized audited points (regions
        # audited once are masked for the rest of the run), the (amp,
        # y_floor) calibration of the last screen, and the dirty-screen
        # vetoes since the last real finding
        self._n_audited = 0
        self._X_audit_hist = []
        self._audit_calib = (0.0, 0.0)
        self._audit_dirty_vetoes = 0
        self.truth = get_truth(loglike, bounds=bounds, params=params,
                               labels=None, ref_bounds=ref_bounds)
        self.options = self._construct_options(options)
        self._load_options(self.options)
        self.gpr = self._construct_gpr(gpr)
        self.acquisition = self._construct_gp_acquisition(gp_acquisition)
        self.convergence_criterion = \
            self._construct_convergence_criterion(convergence_criterion)
        self.progress = Progress()
        self.initial_proposer = self._construct_initial_proposer(
            initial_proposer)
        for _cc in self.convergence_criterion:
            _cc.rng = self.rng
        if isinstance(truth_executor, dict):
            spec = dict(truth_executor)
            mode = spec.pop("mode") if "mode" in spec else list(spec)[0]
        else:
            mode = truth_executor
        self.executor = TruthExecutor(self.truth, mode=mode)

    # -------------------------------------------------------------- logging

    def log(self, msg, level=_VERBOSITY_INFO):
        if self.verbose >= level:
            print(msg)

    def banner(self, msg):
        self.log("+" + "=" * 70 + "\n| " + msg + "\n+" + "=" * 70)

    # ------------------------------------------------------------ properties

    @property
    def d(self):
        return self.truth.d

    @property
    def prior_bounds(self):
        """Prior bounds of the truth (reference: gpry/run.py:600)."""
        return self.truth.prior_bounds

    @property
    def n_total_left(self):
        return self.max_total - self.gpr.n_total

    @property
    def n_finite_left(self):
        return self.max_finite - self.gpr.n

    @property
    def params(self):
        return self.truth.params

    @property
    def labels(self):
        return self.truth.labels
    # ---------------------------------------- evaluation conveniences
    # (reference: gpry/run.py:615-668)

    def logp(self, X):
        """Surrogate log-posterior at X."""
        return self.gpr.predict(np.atleast_2d(np.asarray(X, dtype=float)))

    def logL(self, X):
        """Surrogate log-likelihood at X (log-posterior minus flat
        log-prior)."""
        return self.logp(X) + self.truth.log_prior_volume

    def logp_truth(self, X):
        """True log-posterior at X (counts as truth evaluations)."""
        X = np.atleast_2d(np.asarray(X, dtype=float))
        return np.array([self.truth.logp(x) for x in X])

    def logL_truth(self, X):
        """True log-likelihood at X."""
        return self.logp_truth(X) + self.truth.log_prior_volume

    def logprior(self, X):
        """Log-prior density at X."""
        return self.truth.logprior(X)

    def logpost_eval_and_report(self, X, level=_VERBOSITY_DEBUG):
        """Evaluate and return the true log-posterior at X, logging it
        (reference: gpry/run.py:654-662)."""
        self.log(f"Evaluating true posterior at\n{X}", level=level)
        logp = self.logp_truth(X)
        self.log(f"--> log(p) = {logp}", level=level)
        return logp

    # ------------------------------------------------------------ construction

    def _construct_options(self, options):
        """Defaults from gpry/run.py:521-537."""
        options = dict(options or {})
        d = self.d
        getn = lambda key, default: get_Xnumber(
            options.get(key, default), "d", d, dtype=int, varname=key)
        out = {
            "n_initial": getn("n_initial", "3d"),
            "max_initial": getn("max_initial", "30d1.5"),
            "n_points_per_acq": getn("n_points_per_acq", "d"),
            "fit_full_every": get_Xnumber(
                options.get("fit_full_every", 2 * np.sqrt(d)), "d", d,
                dtype=lambda x: int(np.ceil(x)), varname="fit_full_every"),
            "fit_simple_every": getn("fit_simple_every", 1),
            "n_resamples_before_giveup":
                int(options.get("n_resamples_before_giveup", 2)),
            # Last-resort space-filling exploration budget after starved
            # acquisitions (0 disables = the reference's give-up
            # semantics, gpry/run.py:885-911).
            "max_starved_explore": getn("max_starved_explore", "32d"),
            # Mode-aware convergence (beyond the reference, whose
            # CorrectCounter is blind to undiscovered modes): a declared
            # convergence is audited with a screening of the surrogate's
            # ungated belief over the prior box, spending up to n_audit
            # truth evals per declaration (max_audit total) on points
            # where the surrogate cannot RULE OUT top-band posterior
            # mass; finding real mass there vetoes the declaration.
            "audit": bool(options.get("audit", True)),
            "n_audit": getn("n_audit", "1d"),
            "audit_rounds": int(options.get("audit_rounds", 3)),
            "max_audit": getn("max_audit", "8d"),
            "audit_kappa": float(options.get("audit_kappa", 3.5)),
            "audit_band_nstd": float(options.get("audit_band_nstd", 4.0)),
            "mode_weight_tol": float(options.get("mode_weight_tol", 0.10)),
            "mode_stable_checks": int(options.get("mode_stable_checks", 3)),
            # cap on CONSECUTIVE signature vetoes (see the veto in
            # _run_main_loop), so an oscillating borderline cluster cannot
            # veto forever
            "max_mode_vetoes": int(options.get("max_mode_vetoes", 6)),
            # amplitude-underfit veto: minimum fitted output scale as a
            # fraction of the finite training-y span (see
            # _surrogate_is_amp_underfit); measured separation on the
            # spike fixture: underfit seeds 0.004-0.005, healthy 0.33
            "amp_underfit_frac": float(
                options.get("amp_underfit_frac", 0.05)),
        }
        if "max_total" in options:
            out["max_total"] = getn("max_total", None)
        else:
            # default: 70 d^1.5, or max_initial if that is larger
            # (reference: gpry/run.py:533 docstring)
            out["max_total"] = max(getn("max_total", "70d1.5"),
                                   out["max_initial"])
        out["max_finite"] = getn("max_finite", out["max_total"])
        return out

    def _load_options(self, options):
        self.n_initial = options["n_initial"]
        self.max_initial = options["max_initial"]
        self.max_total = options["max_total"]
        self.max_finite = options["max_finite"]
        self.n_points_per_acq = options["n_points_per_acq"]
        self.fit_full_every = options["fit_full_every"]
        self.fit_simple_every = options["fit_simple_every"]
        self.n_resamples_before_giveup = \
            options["n_resamples_before_giveup"]
        self.max_starved_explore = options["max_starved_explore"]
        self.audit = options["audit"]
        self.n_audit = options["n_audit"]
        self.audit_rounds = options["audit_rounds"]
        self.max_audit = options["max_audit"]
        self.audit_kappa = options["audit_kappa"]
        self.audit_band_nstd = options["audit_band_nstd"]
        self.mode_weight_tol = options["mode_weight_tol"]
        self.mode_stable_checks = options["mode_stable_checks"]
        self.max_mode_vetoes = options["max_mode_vetoes"]
        self.amp_underfit_frac = options["amp_underfit_frac"]
        if self.n_initial <= 0:
            raise ValueError("n_initial must be > 0.")
        if self.max_initial < self.n_initial:
            raise ValueError("max_initial must be >= n_initial.")

    def _construct_gpr(self, gpr):
        """Reference defaults: gpry/run.py:306-355 (n_restarts=10+2d)."""
        if isinstance(gpr, GaussianProcessRegressor):
            return gpr
        bounds = self.truth.prior_bounds
        if isinstance(gpr, str):
            gpr = {"kernel": gpr}
        if not isinstance(gpr, dict):
            raise ValueError(f"Cannot construct GPR from {gpr!r}.")
        kwargs = dict(gpr)
        kwargs.setdefault("kernel", "RBF")
        kwargs.setdefault("n_restarts_optimizer", 10 + 2 * self.d)
        kwargs.setdefault("preprocessing_X", Normalize_bounds(bounds))
        kwargs.setdefault("preprocessing_y", Normalize_y())
        kwargs.setdefault("bounds", bounds)
        kwargs.setdefault("random_state", self.rng)
        kwargs.setdefault("verbose", self.verbose)
        self._gpr_fit_restarts = kwargs["n_restarts_optimizer"]
        return GaussianProcessRegressor(**kwargs)

    def _construct_gp_acquisition(self, spec):
        """Reference: gpry/run.py:357-404 (zeta_scaling=0.85 default)."""
        if isinstance(spec, GenericGPAcquisition):
            return spec
        bounds = self.truth.prior_bounds
        if isinstance(spec, str):
            # Acquisition-function name -> BatchOptimizer with it, or an
            # engine name.
            if spec.lower() in ("batchoptimizer", "nora"):
                spec = {spec: {}}
            else:
                spec = {"BatchOptimizer": {"acq_func": spec}}
        if not isinstance(spec, dict) or len(spec) != 1:
            raise ValueError(f"Cannot construct acquisition from {spec!r}.")
        name = list(spec)[0]
        kwargs = dict(spec[name] or {})
        kwargs.setdefault("zeta_scaling", 0.85)
        kwargs.setdefault("verbose", self.verbose)
        cls = {"batchoptimizer": BatchOptimizer, "nora": NORA}.get(
            name.lower())
        if cls is None:
            raise ValueError(f"Unknown acquisition engine '{name}'.")
        if cls is NORA:
            kwargs.setdefault("rng", self.rng)
        return cls(bounds, **kwargs)

    def _construct_initial_proposer(self, spec):
        """Reference: gpry/run.py:406-444."""
        bounds = self.truth.prior_bounds
        if isinstance(spec, proposal_module.Proposer):
            return spec
        if isinstance(spec, str):
            spec = {spec: {}}
        if not isinstance(spec, dict) or len(spec) != 1:
            raise ValueError(f"Cannot construct proposer from {spec!r}.")
        name = list(spec)[0].lower()
        kwargs = dict(spec[list(spec)[0]] or {})
        if name == "reference":
            return proposal_module.ReferenceProposer(
                bounds, truth=self.truth, **kwargs)
        if name == "prior":
            return proposal_module.PriorProposer(
                bounds, truth=self.truth, **kwargs)
        if name == "uniform":
            return proposal_module.UniformProposer(bounds, **kwargs)
        if name == "meancov":
            return proposal_module.MeanCovProposer(bounds, **kwargs)
        raise ValueError(f"Unknown initial proposer '{name}'.")

    def _construct_convergence_criterion(self, spec):
        """
        Defaults (reference: gpry/run.py:446-457): CorrectCounter for
        BatchOptimizer; CorrectCounter + GaussianKL + TrainAlignment for
        NORA.
        """
        bounds = self.truth.prior_bounds
        if spec is False:
            return [DontConverge(bounds, {})]
        if spec is None:
            criteria = [CorrectCounter(bounds, {"policy": "s"})]
            if isinstance(self.acquisition, NORA):
                criteria += [
                    GaussianKL(bounds, {"policy": "s"}),
                    TrainAlignment(bounds, {"policy": "n"}),
                ]
            return criteria
        if isinstance(spec, ConvergenceCriterion):
            return [spec]
        if isinstance(spec, (list, tuple)):
            return [construct_criterion(s, bounds) for s in spec]
        return [construct_criterion(spec, bounds)]

    def _construct_mc_options(self, mc):
        """Reference: gpry/run.py:506-519."""
        if mc is None:
            out = {"sampler": "nested", "options": {}}
        elif isinstance(mc, str):
            out = {"sampler": mc, "options": {}}
        elif isinstance(mc, dict):
            if len(mc) == 1 and list(mc)[0] not in ("sampler", "options"):
                name = list(mc)[0]
                out = {"sampler": name, "options": dict(mc[name] or {})}
            else:
                out = {"sampler": mc.get("sampler", "nested"),
                       "options": dict(mc.get("options") or {})}
        else:
            raise ValueError(f"Cannot parse mc spec {mc!r}.")
        if out["sampler"] not in ("nested", "mcmc", "uniform"):
            raise _not_ported(f"mc sampler {out['sampler']!r}",
                              "periphery")
        return out

    # ---------------------------------------------------------------- the loop

    def run(self):
        """The active-learning loop (reference: gpry/run.py:776-1061)."""
        self._run_main_loop()
        return self

    def _run_main_loop(self):
        if self.gpr.n_total == 0:
            self.do_initial_training()
        self.resamples = 0
        self.has_converged = False
        while (self.n_total_left > 0 and self.n_finite_left > 0
               and not self.has_converged):
            self.current_iteration += 1
            it = self.current_iteration
            self.progress.add_iteration()
            self.progress.add_current_n_truth(self.gpr.n_total, self.gpr.n)
            self.banner(f"Iteration {it} "
                        f"(n_total={self.gpr.n_total}, n_finite={self.gpr.n})")

            # [ACQUISITION]
            n_points = min(self.n_points_per_acq, self.n_total_left)
            with TimerCounter(self.gpr) as timer_acq:
                new_X, y_pred, acq_vals = self.acquisition.multi_add(
                    self.gpr, n_points=n_points, bounds=self.gpr.trust_bounds,
                    rng=self.rng, force_resample=self.resamples > 0)
                dup = check_candidates(self.gpr.X_train, new_X)
                new_X, y_pred = new_X[~dup], np.asarray(y_pred)[~dup]
            self.progress.add_acquisition(timer_acq)
            self.log(f"[ACQUISITION] {len(new_X)} points proposed "
                     f"({timer_acq.time:.3g}s)", _VERBOSITY_INFO)
            # Starvation retry (reference: gpry/run.py:885-911): if fewer
            # than half the requested points came back, skip evaluating the
            # sub-minimal batch and force the acquisition to re-sample (NORA
            # runs a fresh NS) on the next pass, up to
            # n_resamples_before_giveup times.  Once retries are exhausted,
            # fall back to a bounded space-filling exploration batch
            # (_starved_exploration_batch) before giving up outright.
            explored_batch = False
            if len(new_X) < max(1, n_points // 2):
                self.resamples += 1
                if self.resamples > self.n_resamples_before_giveup:
                    if self._surrogate_is_flat():
                        self._flat_explored = True
                    # explore in initial-training-sized batches: the
                    # points are uninformed anyway, and batching amortizes
                    # the per-iteration NS + refit cost
                    new_X = self._starved_exploration_batch(
                        max(n_points, self.n_initial))
                    if new_X is None or len(new_X) == 0:
                        if not self.max_starved_explore:
                            why = ("exploration disabled "
                                   "(max_starved_explore=0)")
                        elif self._n_explored >= self.max_starved_explore \
                                or not self.n_total_left:
                            why = (f"exploration budget spent "
                                   f"({self._n_explored}"
                                   f"/{self.max_starved_explore})")
                        else:
                            why = ("the exploration net found no new "
                                   "points (saturated bounds)")
                        self.log("Acquisition returning no values after "
                                 f"{self.n_resamples_before_giveup} re-tries "
                                 f"and {why}. Giving up.",
                                 _VERBOSITY_ERROR)
                        break
                    explored_batch = True
                    self.log("[EXPLORATION] acquisition starved "
                             f"{self.resamples - 1}x; falling back to a "
                             f"Sobol exploration batch of {len(new_X)} "
                             f"({self._n_explored}/"
                             f"{self.max_starved_explore} budget spent)",
                             _VERBOSITY_WARN)
                else:
                    self.log("Acquisition returned less than half of the "
                             "requested points. Re-sampling (try "
                             f"{self.resamples}/"
                             f"{self.n_resamples_before_giveup})",
                             _VERBOSITY_WARN)
                    continue
            else:
                self.resamples = 0

            # [EVALUATION]
            with Timer() as timer_truth:
                new_y = self.executor.logp_batch(new_X)
            self.progress.add_truth(timer_truth, n_evals=len(new_X))
            self.log(f"[EVALUATION] truth at {len(new_X)} points "
                     f"({timer_truth.time:.3g}s)", _VERBOSITY_INFO)

            # [FIT]
            with TimerCounter(self.gpr) as timer_fit:
                self._fit_gpr(new_X, new_y)
            self.progress.add_fit(timer_fit)
            self.log(f"[FIT] GPR updated, n={self.gpr.n} "
                     f"({timer_fit.time:.3g}s)", _VERBOSITY_INFO)

            # callback
            if self.callback is not None:
                self.callback(self)

            # [CONVERGENCE]
            if explored_batch:
                # Exploration points carry no acquisition information: a
                # flat surrogate trivially "predicts" them right, so
                # feeding them to CorrectCounter would let a run converge
                # on a surrogate the acquisition never probed.  Convergence
                # must be earned by acquisition-driven iterations.
                self.progress.add_convergence(Timer(), np.nan)
                self.log("[CONVERGENCE] skipped on an exploration batch "
                         "(no acquisition information).", _VERBOSITY_INFO)
            else:
                with TimerCounter(self.gpr) as timer_conv:
                    self.has_converged, conv_value = \
                        self._check_convergence(new_X, new_y, y_pred)
                self.progress.add_convergence(timer_conv, conv_value)
                self.log(f"[CONVERGENCE] value={conv_value:.3g} "
                         f"converged={self.has_converged} "
                         f"({timer_conv.time:.3g}s)", _VERBOSITY_INFO)
                # track the acquisition sample's mode signature (host-side
                # clustering of ~1k resampled points; None for engines
                # without an MC sample, e.g. BatchOptimizer)
                self._mode_sig_now = self._acquisition_mode_signature()
            self.update_mean_cov()

            # Flat-surrogate convergence veto: a surrogate with (almost) no
            # dynamic range trivially "predicts" every acquired point right
            # (the spike fixture: every point sees only the broad base), so
            # CorrectCounter can declare convergence on a posterior the run
            # never actually learned.  Before accepting it, spend the Sobol
            # exploration budget hunting for missed structure; a genuinely
            # flat likelihood just spends the (bounded) budget and then
            # converges to the uniform posterior it deserves.
            #
            # The budget is spent to EXHAUSTION even after structure is
            # found: handing the hunt off to the convergence audit early
            # was tried (round 5) and reverted — on flat_base_spike seed
            # 100 the audit's kappa-sigma screen cannot resolve a
            # 1%-of-the-box spike the Sobol net had only scented (shoulder
            # hit, top unmapped), and the run declared at 40 evals with
            # momKL 2.5.  The net IS the detector here; its budget is the
            # price of safety on structureless-until-found targets.
            if self.has_converged and (self._surrogate_is_flat()
                                       or self._flat_explored):
                if self._surrogate_is_flat():
                    self._flat_explored = True
                exp_X = self._starved_exploration_batch(
                    max(n_points, self.n_initial))
                if exp_X is not None and len(exp_X):
                    self.has_converged = False
                    why = ("on a FLAT surrogate (training span < "
                           f"{self.flat_span} log units)"
                           if self._surrogate_is_flat() else
                           "after a blind (flat-surrogate) exploration "
                           "phase with Sobol budget left")
                    self.log(f"[EXPLORATION] convergence declared {why}: "
                             f"vetoed; exploring {len(exp_X)} Sobol points "
                             f"({self._n_explored}/"
                             f"{self.max_starved_explore} budget spent)",
                             _VERBOSITY_WARN)
                    with Timer() as timer_truth:
                        exp_y = self.executor.logp_batch(exp_X)
                    self.progress.add_truth(timer_truth, n_evals=len(exp_X),
                                            accumulate=True)
                    with TimerCounter(self.gpr) as timer_fit:
                        self._fit_gpr(exp_X, exp_y)
                    self.progress.add_fit(timer_fit, accumulate=True)

            # Amplitude-underfit veto (beyond the reference): a GP whose
            # fitted output scale is a tiny fraction of its own training-y
            # span is GLOBALLY overconfident -- its posterior sd is near
            # zero everywhere, so both CorrectCounter and the kappa-sigma
            # convergence audit are structurally blind (the audit can
            # "rule out" the whole box at kappa sigma with sd ~ 0.2 on
            # data spanning 20 log units; observed on the spike fixture at
            # n=19: output scale 0.096 vs span 21.5).  Veto and spend the
            # Sobol exploration budget; once data forces a sane amplitude
            # the veto goes quiet (healthy fits sit at ratio ~ 0.3).
            if self.has_converged and self._surrogate_is_amp_underfit():
                exp_X = self._starved_exploration_batch(
                    max(n_points, self.n_initial))
                self.has_converged = False
                amp = self._fitted_amp_span_ratio()
                if exp_X is not None and len(exp_X):
                    self.log("[EXPLORATION] convergence vetoed: fitted "
                             f"output scale is {amp:.3g} of the training-y "
                             f"span (< amp_underfit_frac="
                             f"{self.amp_underfit_frac}) -- the surrogate "
                             "is globally overconfident; exploring "
                             f"{len(exp_X)} Sobol points "
                             f"({self._n_explored}/"
                             f"{self.max_starved_explore} budget spent)",
                             _VERBOSITY_WARN)
                    with Timer() as timer_truth:
                        exp_y = self.executor.logp_batch(exp_X)
                    self.progress.add_truth(timer_truth, n_evals=len(exp_X),
                                            accumulate=True)
                    with TimerCounter(self.gpr) as timer_fit:
                        self._fit_gpr(exp_X, exp_y)
                    self.progress.add_fit(timer_fit, accumulate=True)
                else:
                    # No exploration budget left but the surrogate still
                    # cannot represent its own data's dynamic range:
                    # refuse the declaration (honest non-convergence,
                    # bounded by max_total) rather than report a
                    # converged=true row from a blind GP.
                    self.log("[EXPLORATION] convergence vetoed: fitted "
                             f"output scale is {amp:.3g} of the training-y "
                             "span and the exploration budget is spent; "
                             "refusing to declare from a globally "
                             "overconfident surrogate.", _VERBOSITY_WARN)

            # Mode-signature stability veto (beyond the reference): on a
            # MULTIMODAL surrogate, convergence requires the mode count
            # and weights of the acquisition's MC sample to agree across
            # the last ``mode_stable_checks`` convergence checks (a
            # signature still in flux means the mode weights, and possibly
            # the mode census, are not settled).  Costs no truth evals.
            if not explored_batch and self._mode_sig_now is not None:
                self._mode_sig_hist.append(self._mode_sig_now)
                del self._mode_sig_hist[:-max(self.mode_stable_checks, 1)]
            if self.has_converged and self._mode_sig_now is not None \
                    and self._mode_sig_now[0] >= 2:
                hist = self._mode_sig_hist[-self.mode_stable_checks:]
                stable = len(hist) >= self.mode_stable_checks and all(
                    modes_match(a, b, self.mode_weight_tol)
                    for a, b in zip(hist, hist[1:]))
                if stable:
                    self._mode_veto_streak = 0
                elif self._mode_veto_streak >= self.max_mode_vetoes:
                    # bounded veto: a borderline cluster oscillating across
                    # detect_modes' min_weight threshold would otherwise
                    # veto forever
                    self.log("[MODES] signature still unstable after "
                             f"{self._mode_veto_streak} consecutive "
                             "vetoes (max_mode_vetoes cap): accepting "
                             "the declaration.", _VERBOSITY_WARN)
                else:
                    self._mode_veto_streak += 1
                    self.has_converged = False
                    self.log("[MODES] convergence vetoed: multimodal "
                             f"signature {self._mode_sig_now} not stable "
                             f"over the last {self.mode_stable_checks} "
                             f"checks (history: {hist[:-1]}; veto "
                             f"{self._mode_veto_streak}/"
                             f"{self.max_mode_vetoes}).",
                             _VERBOSITY_WARN)

            # Convergence audit (beyond the reference): before accepting,
            # screen the surrogate's UNGATED belief over the prior box for
            # points where top-band posterior mass cannot be ruled out at
            # kappa sigma, and spend a few truth evals on the most
            # suspicious ones.  Real mass found there (an undiscovered
            # mode, a spike) vetoes the declaration and feeds the GP.
            if self.has_converged and self.audit:
                if not self._convergence_audit():
                    self.has_converged = False

            # [MC+DIAGNOSIS] on declared convergence
            if self.has_converged:
                self.log("[MC+DIAGNOSIS] convergence declared; running MC "
                         "and diagnosis...", _VERBOSITY_INFO)
                self.generate_mc_sample()
                if not self.diagnose_last_mc_sample():
                    self.log("Diagnosis failed: convergence vetoed.",
                             _VERBOSITY_WARN)
                    self.has_converged = False

        if not self.has_converged:
            self.log("Budget exhausted (or stopped) without convergence; "
                     "running final MC anyway.", _VERBOSITY_WARN)
            # an MC from an earlier (vetoed) convergence is stale if the
            # surrogate has grown since: re-sample the CURRENT surrogate
            if (self.last_mc_result is None
                    or self._mc_at_n_total != self.gpr.n_total):
                try:
                    self.generate_mc_sample()
                    self.diagnose_last_mc_sample()
                except Exception as excpt:
                    self.log(f"Final MC failed: {excpt}", _VERBOSITY_ERROR)
        return self

    #: training-value span (in log-posterior units) below which the
    #: surrogate counts as "flat" for the exploration-before-convergence
    #: veto: any real posterior structure inside the prior box spans many
    #: e-folds, while a structureless base varies by noise only.
    flat_span = 1.0

    def _surrogate_is_flat(self):
        """True when the finite training values span less than
        ``flat_span`` log units — the surrogate carries (almost) no
        information about where the posterior mass is."""
        y = self.gpr.y_train
        return len(y) > 0 and \
            float(np.max(y) - np.min(y)) < self.flat_span

    def _feed_offbatch_convergence(self, new_y, pred_y):
        """Feed audit/calibration truth evals to criteria that keep a
        correctness streak (CorrectCounter family): points the surrogate
        predicted right count toward the declaration, misses reset it —
        the same terms acquisition evals get.  Host-only: the predictions
        come in as numpy, so no kernel runs inside the try."""
        for cc in self.convergence_criterion:
            fn = getattr(cc, "score_offbatch", None)
            if fn is None:
                continue
            try:
                fn(self.gpr, new_y=new_y, pred_y=pred_y)
            except Exception as excpt:
                self.log(f"off-batch convergence scoring failed: {excpt}",
                         _VERBOSITY_WARN)

    def _fitted_amp_span_ratio(self):
        """Fitted GP output scale (raw y units) over the span of the
        finite training values; ``nan`` when undefined (extended kernels
        without a plain amplitude, or degenerate spans)."""
        y = self.gpr.y_train
        if len(y) < 2:
            return np.nan
        span = float(np.max(y) - np.min(y))
        if not np.isfinite(span) or span <= 0:
            return np.nan
        try:
            amp = float(self.gpr.scales[0])
        except (ValueError, AttributeError):
            return np.nan
        return amp / span

    def _surrogate_is_amp_underfit(self):
        """True when the fitted output scale is below
        ``amp_underfit_frac`` of the finite training-y span: the GP's
        prior sd (its *maximum* posterior sd anywhere) cannot account for
        the variation in its own data, so every uncertainty-based guard
        (CorrectCounter tolerance, audit kappa-sigma screen) is blind.
        Scale-free, so inert on genuinely flat posteriors (a good fit to
        small-span data keeps the ratio O(1))."""
        ratio = self._fitted_amp_span_ratio()
        return np.isfinite(ratio) and ratio < self.amp_underfit_frac

    def _starved_exploration_batch(self, n_points):
        """Last-resort space-filling exploration after exhausted
        starvation retries.

        When the acquisition engine keeps returning (near-)empty proposals
        even after forced NS resamples -- typically because the surrogate
        is flat and the acquisition has no gradient anywhere (e.g. a
        narrow spike on a broad base, where every initial point sees only
        the base: tests/model_generator.py:spike) -- the reference gives
        up outright (gpry/run.py:885-911).  Instead, spend up to
        ``max_starved_explore`` truth evaluations on a scrambled-Sobol
        sweep of the prior bounds: exploration with zero information is a
        search problem, and a low-discrepancy net finds localized
        structure far faster than iid draws.  The sequence index and seed
        persist across batches, so successive
        batches keep refining one space-filling net.  Returns ``None``
        when disabled (``max_starved_explore=0``) or exhausted.
        """
        n_budget = min(self.max_starved_explore - self._n_explored,
                       self.n_total_left)
        if n_budget <= 0:
            return None
        n = int(min(max(n_points, 1), n_budget))
        from scipy.stats import qmc
        if self._explore_seed is None:
            self._explore_seed = int(self.rng.integers(2 ** 31 - 1))
        eng = qmc.Sobol(self.d, scramble=True, seed=self._explore_seed)
        if self._explore_net_i:
            eng.fast_forward(self._explore_net_i)
        import warnings
        lo, hi = self.prior_bounds[:, 0], self.prior_bounds[:, 1]
        # Budget (_n_explored, counts points actually returned for truth
        # evaluation) is separate from the net position (_explore_net_i):
        # points skipped as duplicates of existing training points advance
        # the net but cost nothing.  Redraw until the batch is full so an
        # (extremely rare) all-duplicate draw cannot masquerade as an
        # exhausted budget; bounded rounds guard a saturated net.
        out = []
        got = 0
        for _ in range(8):
            if got >= n:
                break
            with warnings.catch_warnings():
                # non-power-of-two draws are fine: the net keeps extending
                warnings.simplefilter("ignore", UserWarning)
                u = eng.random(n - got)
            self._explore_net_i += len(u)
            X = lo + u * (hi - lo)
            seen = self.gpr.X_train_all
            if out:
                seen = np.concatenate([seen] + out, axis=0)
            X = X[~check_candidates(seen, X)]
            if len(X):
                out.append(X)
                got += len(X)
        if not out:
            return np.empty((0, self.d))
        self._n_explored += got
        return np.concatenate(out, axis=0)

    def _acquisition_mode_signature(self):
        """Mode signature of the acquisition engine's current MC sample
        (None when the engine has no sample, e.g. BatchOptimizer)."""
        if not hasattr(self.acquisition, "last_MC_sample"):
            self._last_modes = None
            return None
        try:
            X, _, w = self.acquisition.last_MC_sample()
        except (ValueError, AttributeError):
            self._last_modes = None
            return None
        try:
            self._last_modes = detect_modes(X, w, rng=self.rng)
            return mode_signature(self._last_modes)
        except Exception as excpt:
            self.log(f"[MODES] mode detection failed: {excpt}",
                     _VERBOSITY_DEBUG)
            self._last_modes = None
            return None

    # ------------------------------------------------- convergence audit
    # (gpry_tpu/run.py:1035-1578; every surrogate sweep below is one K5
    # launch on the model's device)

    def _ungated_sweep(self, X):
        """The surrogate's ungated raw-space ``(mean, std)`` at ``X`` as
        numpy arrays: one K5 sweep (``surrogate_mean_std_sweep``)."""
        p = self.gpr.surrogate_params()
        mu, sd = surrogate_mean_std_sweep(
            self.gpr.family, p, self.gpr._t(np.ascontiguousarray(X)))
        return mu.cpu().numpy(), sd.cpu().numpy()

    def _audit_screen(self, thres):
        """One audit screening pass: ungated surrogate belief over a fresh
        scrambled-Sobol net on the prior box.  Returns ``(Xs, mu_eff, z)``
        where ``z = (thres - mu_eff)/sd`` is the in-band z-score (small
        z = plausibly-missed mass).

        ``mu_eff`` is the GP mean with its far-field reversion target
        replaced: a y-normalized GP reverts to the TRAINING-SET AVERAGE
        log-posterior far from all data, which puts the entire far field a
        fraction of a sigma below the top band and floods the screen with
        false alarms.  For auditing it reverts to the WORST finite value
        seen instead, weighted by the GP's own uninformedness (sd/amp)^2 —
        the exact variance complement of the posterior-mean reversion
        weight k'K^-1k/amp^2."""
        from scipy.stats import qmc
        import warnings
        n_screen = 4096
        eng = qmc.Sobol(self.d, scramble=True,
                        seed=int(self.rng.integers(2 ** 31 - 1)))
        with warnings.catch_warnings():
            warnings.simplefilter("ignore", UserWarning)
            u = eng.random(n_screen)
        lo, hi = self.prior_bounds[:, 0], self.prior_bounds[:, 1]
        Xs = lo + u * (hi - lo)
        mu, sd = self._ungated_sweep(Xs)
        amp = np.nanmax(sd[np.isfinite(sd)], initial=0.0)
        y_all = np.asarray(self.gpr.y_train, float)
        finite = np.isfinite(y_all)
        y_floor = float(np.min(y_all[finite])) if np.any(finite) \
            else self.gpr.y_max
        self._audit_calib = (amp, y_floor)
        mu_eff, z = self._audit_zscore(mu, sd, thres)
        return Xs, mu_eff, z

    def _audit_zscore(self, mu, sd, thres):
        """Floor-corrected audit belief (see _audit_screen): returns
        ``(mu_eff, z)`` given the calibration set by the last screen."""
        amp, y_floor = self._audit_calib
        if amp > 0:
            w_floor = np.clip((sd / amp) ** 2, 0.0, 1.0)
            # Reversion target: the worst finite value seen — but capped a
            # full band BELOW the suspicion threshold when the training
            # set has never bracketed the band (y_floor >= thres), so that
            # an uninformed region stays AUDITABLE.
            band = self.gpr.y_max - thres
            target = min(y_floor, thres - band)
            mu_eff = (1.0 - w_floor) * mu + w_floor * target
        else:
            mu_eff = mu
        with np.errstate(divide="ignore", invalid="ignore"):
            z = (thres - mu_eff) / np.maximum(sd, 1e-300)
        z = np.where(np.isfinite(mu) & np.isfinite(sd), z, np.inf)
        return mu_eff, z

    def _cloud(self, X0, sigma_frac, n_local):
        """``n_local`` Gaussian cloud points around each row of ``X0``
        (sigma = ``sigma_frac`` of the box span per dimension, clipped to
        the box); the first point of each cloud is the row itself."""
        lo, hi = self.prior_bounds[:, 0], self.prior_bounds[:, 1]
        cloud = np.repeat(X0, n_local, axis=0)
        cloud = cloud + self.rng.normal(
            scale=sigma_frac, size=cloud.shape) * (hi - lo)
        cloud = np.clip(cloud, lo, hi)
        cloud[::n_local] = X0
        return cloud

    def _audit_polish(self, X0, thres, margin=0.0, n_local=256,
                      sigma_frac=0.06):
        """Move each audit pick to the most plausible point of its region:
        the argmin of z among cloud points that still pass the screen's own
        suspicion test (mu_eff < thres - margin, and outside the audited
        regions), over a Gaussian cloud around the pick.  One batched
        surrogate sweep for ALL picks' clouds — costs no truth evals.
        Returns (polished points, their effective mu)."""
        lo, hi = self.prior_bounds[:, 0], self.prior_bounds[:, 1]
        n0 = len(X0)
        cloud = self._cloud(X0, sigma_frac, n_local)
        mu, sd = self._ungated_sweep(cloud)
        mu_eff, z = self._audit_zscore(mu, sd, thres)
        z = np.where(mu_eff < thres - margin, z, np.inf)
        if self._X_audit_hist:
            # keep polished picks out of already-audited zones too (the
            # cloud can reach back into a masked region)
            hist = np.asarray(self._X_audit_hist)
            cn = (cloud - lo) / (hi - lo)
            d2 = np.min(np.sum(
                (cn[:, None, :] - hist[None, :, :]) ** 2, axis=-1),
                axis=1)
            z = np.where(d2 >= (0.08 ** 2) * len(lo), z, np.inf)
        best = z.reshape(n0, n_local).argmin(axis=1) \
            + np.arange(n0) * n_local
        return cloud[best], mu_eff[best]

    def _apex_polish(self, X0, sigma_frac, n_local=256):
        """One batched cloud ascent of the surrogate mean around each
        point of ``X0`` (free: surrogate sweeps only)."""
        n0 = len(X0)
        cloud = self._cloud(X0, sigma_frac, n_local)
        mu, _ = self._ungated_sweep(cloud)
        mu = np.where(np.isfinite(mu), mu, -np.inf)
        best = mu.reshape(n0, n_local).argmax(axis=1) \
            + np.arange(n0) * n_local
        return cloud[best], mu[best]

    def _calibrate_at(self, X_cal, tol, what):
        """Spend one truth eval at each row of ``X_cal`` (mode centers or
        belief apexes), train on them and return False (veto) when the
        surrogate's mean misses the truth by more than ``tol`` at any."""
        lo, hi = self.prior_bounds[:, 0], self.prior_bounds[:, 1]
        mu, _ = self._ungated_sweep(X_cal)
        with Timer() as timer_truth:
            y_cal = np.asarray(self.executor.logp_batch(X_cal))
        self.progress.add_truth(timer_truth, n_evals=len(X_cal),
                                accumulate=True)
        self._n_audited += len(X_cal)
        self._X_audit_hist.extend((X_cal - lo) / (hi - lo))
        self._feed_offbatch_convergence(y_cal, mu)
        err = np.where(np.isfinite(y_cal) & np.isfinite(mu),
                       np.abs(y_cal - mu), 0.0)
        bad = err > tol
        with TimerCounter(self.gpr) as timer_fit:
            self.gpr.append_to_data(
                X_cal, y_cal,
                fit_gpr=({"n_restarts": self._fit_restarts()}
                         if np.any(bad) else "simple"))
        self.progress.add_fit(timer_fit, accumulate=True)
        if np.any(bad):
            self._mode_sig_hist.clear()
            self._audit_dirty_vetoes = 0
            self._mode_veto_streak = 0
            k = int(np.argmax(err))
            self.log("[AUDIT] convergence vetoed: surrogate miscalibrated "
                     f"at {int(bad.sum())}/{len(X_cal)} of its own {what} "
                     f"(worst: truth {y_cal[k]:.4g} vs predicted "
                     f"{mu[k]:.4g}, tol {tol:.3g}); audit spend "
                     f"{self._n_audited}/{self.max_audit}.",
                     _VERBOSITY_WARN)
            return False
        self.log(f"[AUDIT] {len(X_cal)} {what} calibration-checked: "
                 "surrogate agrees with truth "
                 f"(spend {self._n_audited}/{self.max_audit}).",
                 _VERBOSITY_INFO)
        return True

    def _mode_center_calibration(self):
        """
        Calibration phase of the convergence audit: the surrogate must be
        RIGHT at the centers of its own detected modes.

        The below-band screen finds mass the surrogate doesn't know about;
        it is blind to mass the surrogate knows but models badly (a GP
        whose single per-dim lengthscale must span a broad mode and a
        narrow spike smooths the spike's peak down and confidently
        under-integrates it).  So: for every detected mode of the
        acquisition's MC sample whose center is not ANCHORED (no training
        point within 0.5 of the cluster's own per-dim sigma) and not
        already audited, spend one truth eval at the center.
        |y_true - mu| > band/4 vetoes and trains on the point.  On
        well-trained targets every center is anchored and the phase costs
        nothing.
        """
        modes = self._last_modes or []
        if not modes:
            return True
        band = delta_logp_of_1d_nstd(self.audit_band_nstd, self.d)
        lo, hi = self.prior_bounds[:, 0], self.prior_bounds[:, 1]
        r2_hist = (0.08 ** 2) * self.d
        X_tr = np.asarray(self.gpr.X_train, float)
        centers = []
        for c in modes:
            ctr = np.asarray(c["mean"], float)
            sig = np.sqrt(np.maximum(np.diag(np.asarray(c["cov"])), 0.0))
            if len(X_tr) and np.any(np.all(
                    np.abs(X_tr - ctr) <= 0.5 * sig, axis=1)):
                continue  # anchored: data at the mode's own scale
            if self._X_audit_hist:
                cn = (ctr - lo) / (hi - lo)
                hist = np.asarray(self._X_audit_hist)
                if np.min(np.sum((hist - cn) ** 2, axis=1)) < r2_hist:
                    continue  # this center's region was already audited
            centers.append(ctr)
        if not centers:
            return True
        n_budget = min(self.max_audit - self._n_audited, self.n_total_left)
        if n_budget <= 0:
            return True
        return self._calibrate_at(np.asarray(centers[:int(n_budget)]),
                                  0.25 * band, "mode centers")

    def _apex_calibration(self):
        """
        Calibration of the surrogate's SECONDARY belief apexes.

        A GP whose per-dim lengthscale is set by a broad mode smooths a
        narrow co-located feature's peak down; the smoothed apex is
        predicted IN-band (the below-band screen skips it) and the
        posterior is one connected blob (mode detection reports a single
        cluster), so both other guards are blind to it.  So: find the
        local maxima of the surrogate mean over the audit screen's Sobol
        net (kNN-16 local-max test), keep only SECONDARY apexes (more than
        band/8 below the net's global max, down to one band below the band
        edge), polish each with two batched cloud ascents of the mean, and
        spend one truth eval per unanchored, not-yet-audited apex;
        |y_true - mu| > band/4 vetoes and trains on the point.
        """
        from scipy.spatial import cKDTree
        band = delta_logp_of_1d_nstd(self.audit_band_nstd, self.d)
        n_budget = min(self.max_audit - self._n_audited, self.n_total_left)
        if n_budget <= 0:
            return True
        thres = self.gpr.y_max - band
        Xs, mu, _ = self._audit_screen(thres)
        lo, hi = self.prior_bounds[:, 0], self.prior_bounds[:, 1]
        Xn = (Xs - lo) / (hi - lo)
        k = min(len(Xn), 17)  # self + 16 neighbors
        _, nbr = cKDTree(Xn).query(Xn, k=k)
        is_max = mu >= mu[nbr].max(axis=1) - 1e-12
        gap = 0.125 * band
        cand = np.flatnonzero(is_max & (mu < mu.max() - gap)
                              & (mu > thres - band) & np.isfinite(mu))
        if len(cand) == 0:
            return True
        cand = cand[np.argsort(-mu[cand])][:4]
        # polish: two batched cloud ascents of the belief (free)
        X_apex = Xs[cand]
        for frac in (0.06, 0.015):
            X_apex, _ = self._apex_polish(X_apex, frac)
        # drop apexes anchored by a training point, already-audited ones,
        # and near-duplicates (two net maxima of one smoothed feature)
        r_anchor2 = (0.01 ** 2) * self.d
        r2_hist = (0.08 ** 2) * self.d
        Xn_tr = (np.asarray(self.gpr.X_train, float) - lo) / (hi - lo)
        keep = []
        for x in X_apex:
            xn = (x - lo) / (hi - lo)
            if len(Xn_tr) and np.min(
                    np.sum((Xn_tr - xn) ** 2, axis=1)) < r_anchor2:
                continue
            if self._X_audit_hist and np.min(np.sum(
                    (np.asarray(self._X_audit_hist) - xn) ** 2,
                    axis=1)) < r2_hist:
                continue
            if keep and np.min(np.sum(
                    (np.asarray(keep) - xn) ** 2, axis=1)) < r_anchor2:
                continue
            keep.append(xn)
        if not keep:
            return True
        X_cal = np.asarray(keep)[:int(n_budget)] * (hi - lo) + lo
        return self._calibrate_at(X_cal, 0.25 * band,
                                  "secondary belief apexes")

    def _convergence_audit(self):
        """
        Audit a declared convergence against UNDISCOVERED posterior mass.

        The reference's criteria only ever score points the acquisition
        itself proposed, so a surrogate that never saw a mode converges
        without it.  This audit asks the surrogate's own *ungated* belief
        where it cannot rule out top-band mass: screen a scrambled-Sobol
        net over the prior box and flag points whose in-band z-score is
        below ``kappa`` while the mean is clearly below the band (by a
        margin of band/2).  Candidates are audited in ASCENDING z order
        (by probability of hiding top-band mass), with a diversity radius,
        each polished to its region's most plausible point.

        It iterates screen -> evaluate -> refit rounds within one
        declaration (``audit_rounds`` rounds of up to ``n_audit`` truth
        evals; ``max_audit`` total per run).  Any truth value inside the
        band is real mass the surrogate missed: the declaration is vetoed
        and the points feed the training set.  Returns True when the
        declaration survives; with a clean first screen the audit costs no
        truth evals.
        """
        band = delta_logp_of_1d_nstd(self.audit_band_nstd, self.d)
        lo, hi = self.prior_bounds[:, 0], self.prior_bounds[:, 1]
        r2 = (0.15 ** 2) * self.d
        # history-mask radius, tighter than the within-batch diversity
        # radius: wide enough to stop re-auditing a region whose belief an
        # eval cannot move, narrow enough that a near-miss outside a mode's
        # in-band catchment does not shadow the mode core
        r2_hist = (0.08 ** 2) * self.d
        if not self._mode_center_calibration():
            return False
        if not self._apex_calibration():
            return False
        for audit_round in range(self.audit_rounds):
            thres = self.gpr.y_max - band
            n_budget = min(self.max_audit - self._n_audited,
                           self.n_total_left)
            if n_budget <= 0:
                self.log("[AUDIT] budget spent "
                         f"({self._n_audited}/{self.max_audit}); accepting "
                         "convergence unaudited.", _VERBOSITY_WARN)
                return True
            Xs, mu, z = self._audit_screen(thres)
            # a suspicious point must be a genuine SURPRISE candidate: the
            # surrogate claims clearly-below-band (margin of band/2) yet
            # cannot back it at kappa sigma; without the margin the audit
            # chases the band-boundary shell the surrogate already models
            margin = 0.5 * band
            suspicious = (z < self.audit_kappa) & (mu < thres - margin)
            if np.any(suspicious) and self._X_audit_hist:
                # drop candidates whose REGION was already audited this run
                Xn_all = (Xs - lo) / (hi - lo)
                hist = np.asarray(self._X_audit_hist)
                d2 = np.min(np.sum(
                    (Xn_all[:, None, :] - hist[None, :, :]) ** 2,
                    axis=-1), axis=1)
                suspicious &= d2 >= r2_hist
            if not np.any(suspicious):
                self.log("[AUDIT] no plausibly-missed mass at "
                         f"{self.audit_kappa} sigma over {len(Xs)} "
                         "screening points (outside already-audited "
                         "regions); convergence accepted "
                         f"({self._n_audited} audit evals so far).",
                         _VERBOSITY_INFO)
                return True
            n_pick = int(min(self.n_audit, n_budget))
            # greedy min-z selection with a diversity radius, in
            # box-normalized coordinates
            Xn = (Xs[suspicious] - lo) / (hi - lo)
            order = np.argsort(z[suspicious])
            picked = []
            for j in order:
                if len(picked) >= n_pick:
                    break
                if picked and np.min(np.sum(
                        (Xn[picked] - Xn[j]) ** 2, axis=1)) < r2:
                    continue
                picked.append(j)
            X_audit, mu_audit = self._audit_polish(
                Xs[suspicious][picked], thres, margin=margin)
            with Timer() as timer_truth:
                y_audit = self.executor.logp_batch(X_audit)
            self.progress.add_truth(timer_truth, n_evals=len(X_audit),
                                    accumulate=True)
            self._n_audited += len(X_audit)
            y_audit = np.asarray(y_audit)
            # (a known fault of the reference, ported as it is: the
            # floor-corrected mu_eff, not the GP mean, is scored)
            self._feed_offbatch_convergence(y_audit, mu_audit)
            found = y_audit > thres
            # mask the audited POINTS unconditionally: a truth value below
            # the infinities threshold never reaches the GP, so an
            # unmasked empty pick would be re-selected every round
            self._X_audit_hist.extend((X_audit - lo) / (hi - lo))
            # all audit points are informative: train on all of them
            with TimerCounter(self.gpr) as timer_fit:
                self.gpr.append_to_data(
                    X_audit, y_audit,
                    fit_gpr=({"n_restarts": self._fit_restarts()}
                             if np.any(found) else "simple"))
            self.progress.add_fit(timer_fit, accumulate=True)
            if np.any(found):
                # the mode census just changed: demand a fresh stability
                # streak before convergence can be declared again
                self._mode_sig_hist.clear()
                self._audit_dirty_vetoes = 0
                self._mode_veto_streak = 0
                self.log("[AUDIT] convergence vetoed: found REAL top-band "
                         f"mass at {int(found.sum())}/{len(X_audit)} "
                         f"audited points (best logp "
                         f"{np.max(y_audit):.4g} vs predicted "
                         f"{mu_audit[np.argmax(y_audit)]:.4g}, band "
                         f"{thres:.4g}); audit spend "
                         f"{self._n_audited}/{self.max_audit}.",
                         _VERBOSITY_WARN)
                return False
            self.log(f"[AUDIT] round {audit_round + 1}: {len(X_audit)} "
                     "suspicious points audited, no real mass found "
                     f"(spend {self._n_audited}/{self.max_audit}).",
                     _VERBOSITY_INFO)
        # Rounds exhausted with a DIRTY screen: while per-run audit budget
        # remains, veto rather than accept — the next declaration resumes
        # auditing with the region masks carried over.  Persistence until
        # max_audit is the contract.
        if self._n_audited < self.max_audit and self.n_total_left > 0:
            self._audit_dirty_vetoes += 1
            self.log(f"[AUDIT] convergence vetoed: screen still dirty "
                     f"after {self.audit_rounds} rounds (spend "
                     f"{self._n_audited}/{self.max_audit}); auditing "
                     "resumes at the next declaration.", _VERBOSITY_WARN)
            return False
        self.log(f"[AUDIT] audit budget spent without a clean screen; "
                 f"convergence accepted unaudited (spend "
                 f"{self._n_audited}/{self.max_audit}).", _VERBOSITY_WARN)
        return True

    def do_initial_training(self):
        """
        Draw initial points until n_initial finite truth values
        (reference: gpry/run.py:1063-1198).
        """
        n_finite, n_tried = 0, 0
        X_all, y_all = [], []
        while n_finite < self.n_initial:
            if n_tried >= self.max_initial:
                raise RuntimeError(
                    f"Could not find {self.n_initial} finite initial points "
                    f"within max_initial={self.max_initial} evaluations. "
                    "Try decreasing your prior volume.")
            # size each top-up batch to the remaining deficit, capped by
            # the remaining budget: truth evaluations are the expensive
            # resource, and a 1-point deficit must not trigger another
            # full n_initial-sized batch
            batch = min(max(self.n_initial - n_finite, 2),
                        self.max_initial - n_tried)
            X = np.atleast_2d(self.initial_proposer.get_batch(
                batch, self.rng))
            y = self.executor.logp_batch(X)
            X_all.append(X)
            y_all.append(y)
            n_tried += len(X)
            y_cat = np.concatenate(y_all)
            # count under the same thresholding the GPR will apply
            n_finite = int(np.sum(
                np.isfinite(y_cat)
                & (y_cat >= np.nanmax(y_cat) - self.gpr._diff_threshold)))
            self.log(f"[INITIAL] {n_finite}/{self.n_initial} finite points "
                     f"after {n_tried} evaluations", _VERBOSITY_INFO)
        X_init = np.vstack(X_all)
        y_init = np.concatenate(y_all)
        self.gpr.append_to_data(
            X_init, y_init,
            fit_gpr={"n_restarts": self._fit_restarts()})

    def _fit_restarts(self):
        # Explicit None checks, NOT truthiness: n_restarts_optimizer=0 is
        # a legitimate "never re-optimize hyperparameters" configuration
        # and must not be silently replaced by the default.  The GPR's own
        # attribute covers the prebuilt-instance and checkpoint-resume
        # paths, where _construct_gpr (which sets _gpr_fit_restarts)
        # never ran.
        configured = getattr(self, "_gpr_fit_restarts", None)
        if configured is None:
            configured = getattr(self.gpr, "n_restarts_optimizer", None)
        return (10 + 2 * self.d) if configured is None else int(configured)

    def _fit_gpr(self, new_X, new_y):
        """
        Fit cadence (reference: gpry/run.py:1238-1301): full multi-restart
        fit every ``fit_full_every`` iterations, single-start ("simple")
        fit every ``fit_simple_every``, plain factorization otherwise.
        """
        it = self.current_iteration
        if self.fit_full_every and it % self.fit_full_every == 0:
            fit = {"n_restarts": self._fit_restarts()}
        elif self.fit_simple_every and it % self.fit_simple_every == 0:
            fit = "simple"
        else:
            fit = False
        self.gpr.append_to_data(new_X, new_y, fit_gpr=fit)

    def _check_convergence(self, new_X, new_y, y_pred):
        """
        Evaluate all criteria and combine by policy
        (reference: gpry/run.py:1303-1333).
        """
        necessary_ok, any_sufficient, has_sufficient = True, False, False
        value = np.nan
        for cc in self.convergence_criterion:
            try:
                converged = cc.is_converged(
                    self.gpr, new_X=new_X, new_y=new_y, pred_y=y_pred,
                    acquisition=self.acquisition)
            except ConvergenceCheckError:
                converged = False
            if np.isnan(value):
                value = cc.last_value
            if cc.is_monitor:
                continue
            if cc.is_sufficient:
                has_sufficient = True
                any_sufficient = any_sufficient or converged
            if cc.is_necessary and not converged:
                necessary_ok = False
        converged_total = necessary_ok and \
            (any_sufficient if has_sufficient else True)
        return bool(converged_total), value

    def update_mean_cov(self, use_mc_sample=None):
        """
        Pull the current mean/cov estimate, preferring an explicit MC sample
        if given, then the acquisition engine, then convergence criteria
        (reference: gpry/run.py:1335-1352).
        """
        if use_mc_sample is not None:
            try:
                self.mean, self.cov = mean_covmat_from_samples(
                    use_mc_sample["X"], use_mc_sample["weights"])
                return
            except Exception:
                pass
        self.mean, self.cov = None, None
        acq_mean = getattr(self.acquisition, "mean", None)
        if acq_mean is not None:
            self.mean = acq_mean
            self.cov = self.acquisition.cov
            return
        for cc in self.convergence_criterion:
            if getattr(cc, "mean", None) is not None:
                self.mean, self.cov = cc.mean, cc.cov
                return

    def generate_mc_sample(self, sampler=None, output=None, add_options=None,
                           rng=None):
        """
        MC-sample the surrogate (reference: gpry/run.py:1594-1714).
        Returns the samples dict and stores it as ``last_mc_result``.
        """
        from gpry_tpu_torch.mc.samples import mc_sample_from_gp, \
            write_samples_txt
        sampler = sampler or self._mc_options["sampler"]
        options = dict(self._mc_options["options"])
        options.update(add_options or {})
        # inject the run's covariance estimate into MCMC-family samplers
        # (reference: gpry/mc.py:106-156 mcmc_info_from_run cov injection)
        if "mcmc" in str(sampler) and getattr(self, "cov", None) is not None:
            options.setdefault("covmat", self.cov)
        result = mc_sample_from_gp(
            self.gpr, bounds=self.truth.prior_bounds, sampler=sampler,
            rng=rng or self.rng, options=options, verbose=self.verbose)
        self.last_mc_result = result
        self._mc_at_n_total = self.gpr.n_total
        # the MC sample is the best moment estimate from here on
        # (reference: gpry/run.py:1713 update_mean_cov(use_mc_sample=...))
        self.update_mean_cov(use_mc_sample=result)
        if output:
            write_samples_txt(result, output, params=self.truth.params)
        return result

    def last_mc_samples(self, as_getdist=False):
        """Last MC samples as (X, weights, logpost)
        (reference: gpry/run.py:1716-1745)."""
        if self.last_mc_result is None:
            raise ValueError("No MC sample generated yet.")
        if as_getdist:
            raise _not_ported("getdist export", "periphery")
        r = self.last_mc_result
        return r["X"], r["weights"], r["logpost"]

    def last_mc_samples_pandas(self):
        """Last MC samples as a pandas DataFrame
        (reference: gpry/run.py:1716 as_pandas)."""
        import pandas as pd
        if self.last_mc_result is None:
            raise ValueError("No MC sample generated yet.")
        r = self.last_mc_result
        data = {p: r["X"][:, i] for i, p in enumerate(self.truth.params)}
        data["weight"] = r["weights"]
        data["logpost"] = r["logpost"]
        return pd.DataFrame(data)

    def diagnose_last_mc_sample(self):
        """
        Post-MC diagnosis (reference: gpry/run.py:1747-1784): (1) the
        training mean must lie within 0.5 central credibility of the MC
        sample; (2) KL(MC Gaussian || acquisition Gaussian) < d, for an
        engine with its own MC sample (NORA).  Failure vetoes convergence.
        """
        if self.last_mc_result is None:
            return True
        X, w = self.last_mc_result["X"], self.last_mc_result["weights"]
        if len(X) < 2 * self.d:
            return False
        mean_mc, cov_mc = mean_covmat_from_samples(X, w)
        ok = True
        try:
            mean_train = mean_covmat_from_evals(
                self.gpr.X_train, self.gpr.y_train)[0]
            dist = gaussian_distance(mean_train[None], mean_mc, cov_mc)[0]
            cred = credibility_of_nstd(dist, self.d)
            if not (0 <= cred < 0.5):
                self.log(f"[DIAGNOSIS] training-mean credibility {cred:.3f}"
                         " >= 0.5", _VERBOSITY_WARN)
                ok = False
        except Exception as excpt:
            self.log(f"[DIAGNOSIS] alignment check failed: {excpt}",
                     _VERBOSITY_WARN)
        # KL(mc || acq) < d against the acquisition's OWN last sample
        # (reference: gpry/run.py:1775-1784; skipped for engines without
        # one; a failed moment computation leaves the training test as the
        # verdict)
        if ok and hasattr(self.acquisition, "last_MC_sample"):
            try:
                X_a, _, w_a = self.acquisition.last_MC_sample()
                mean_acq, cov_acq = mean_covmat_from_samples(X_a, w_a)
                kl = kl_norm(mean_mc, cov_mc, mean_acq, cov_acq)
            except Exception as excpt:
                self.log(f"[DIAGNOSIS] KL check skipped: {excpt}",
                         _VERBOSITY_WARN)
            else:
                if not (kl < self.d):
                    self.log(f"[DIAGNOSIS] KL(mc||acq)={kl:.3g} >= d",
                             _VERBOSITY_WARN)
                    ok = False
        return ok

    # ------------------------------------------------------------- fiducials

    def set_fiducial_point(self, X, logpost=None):
        """Store a fiducial point for plots (reference: gpry/run.py:1354)."""
        self.fiducial_point = np.atleast_1d(np.asarray(X, dtype=float))
        self.fiducial_logpost = logpost

    def set_fiducial_MC(self, X, weights=None, logpost=None):
        """Store a fiducial MC sample for plots
        (reference: gpry/run.py:1400)."""
        self.fiducial_MC = {
            "X": np.atleast_2d(X),
            "weights": weights if weights is not None
            else np.ones(len(np.atleast_2d(X))),
            "logpost": logpost,
        }

