"""
Monte-Carlo samples of the surrogate (port of gpry_tpu/mc/samples.py).

The final sampler is the device nested sampler (``mc.nested``) or the
device ensemble MCMC (``mc.mcmc``), followed by the mixture
importance-sampling refinement (``mc.refine``); all of them score the
surrogate through the K1 kernel, the NS chains through K6 (with K13's
bookkeeping) and the MCMC's phases through K12.  ``"uniform"`` draws are
for tests.  ``"polychord"``, ``"ultranest"`` and ``"nessai"`` run that host
nested sampler (``mc.interfaces``) over the surrogate, each batch of its
likelihood requests one K1 sweep.  ``"cobaya"`` / ``"cobaya_mcmc"`` and
``"cobaya_polychord"`` run a Cobaya sampler over the surrogate
(``mc.cobaya_mc``), one K2 launch (``gpr.predict`` of one point) a
likelihood call.  A samples dict converts to getdist's ``MCSamples``
(:func:`samples_dict_to_getdist`).
"""

import os
import time

import numpy as np
import torch

from gpry_tpu_torch.mc.mcmc import run_mcmc_device, split_rhat
from gpry_tpu_torch.mc.nested import run_nested_device
from gpry_tpu_torch.models.gp import surrogate_predict_mean
from gpry_tpu_torch.ops.fused import mcmc_chains, ns_slice_chains
from gpry_tpu_torch.parallel import mesh as _mesh
from gpry_tpu_torch.parallel.rng import torch_generator_from_rng
from gpry_tpu_torch.utils.tools import (check_and_return_bounds,
                                        generic_params_names, get_Xnumber)


class _SurrogateLogp:
    """The gated surrogate log-density ``f(params, X) -> logp`` (K1), with
    the nested sampler's slice route (K6) and the MCMC's phase route
    (K12)."""

    def __init__(self, family):
        self.family = family

    def __call__(self, params, X):
        return surrogate_predict_mean(self.family, params, X)

    def slice_chains(self, params, x0, lx0, lstar, chol, nrm, u, lo, hi,
                     done=None):
        return ns_slice_chains(self.family, params, x0, lx0, lstar, chol,
                               nrm, u, lo, hi, done)

    def mcmc_chains(self, params, x, lp_x, log_step, chol, z, u, lo, hi,
                    adapt):
        return mcmc_chains(self.family, params, x, lp_x, log_step, chol, z,
                           u, lo, hi, adapt)


def surrogate_logp_fn(family):
    """The gated surrogate log-density ``f(params, X) -> logp`` (K1); its
    ``slice_chains`` runs a nested-sampling step's chains (K6), its
    ``mcmc_chains`` one phase of the MCMC ensemble (K12)."""
    return _SurrogateLogp(family)


def _rng_of(rng):
    if isinstance(rng, np.random.Generator):
        return rng
    # fresh OS entropy when no seed is given
    return np.random.default_rng(rng)


def mc_sample_from_gp(gpr, bounds=None, sampler="nested", rng=None,
                      options=None, verbose=1):
    """
    Draw MC samples from the surrogate posterior.  ``sampler``: "nested"
    (device NS, ``nlive=50d``, then IS refinement), "mcmc" (device
    ensemble of adaptive MH chains, then IS refinement), "uniform"
    (tests), a host nested sampler, "polychord", "ultranest" or "nessai",
    or a Cobaya sampler over the surrogate, "cobaya" (its mcmc),
    "cobaya_mcmc" or "cobaya_polychord" (``options["params"]`` names the
    parameters, ``options["covmat"]`` is the mcmc's proposal covariance;
    ``ImportError`` where the package is missing).  ``options["heartbeat"]``
    is called at each read of the device NS's stop flag.

    Returns a samples dict: {"X", "logpost", "weights", "logZ" (NS only),
    "rhat" (MCMC only), "n_calls", and the phase times "time_ns" /
    "time_refine" in seconds}.
    """
    options = dict(options or {})
    heartbeat = options.pop("heartbeat", None)
    if sampler in ("cobaya", "cobaya_mcmc", "cobaya_polychord"):
        # the surrogate as a Cobaya likelihood (gpry_tpu/mc/samples.py:56-63)
        from gpry_tpu_torch.mc.cobaya_mc import mc_sample_from_gp_cobaya
        flavor = "polychord" if sampler.endswith("polychord") else "mcmc"
        return mc_sample_from_gp_cobaya(
            gpr, bounds=bounds, params=options.pop("params", None),
            sampler=flavor, covmat=options.pop("covmat", None),
            add_options=options, rng=rng, verbose=verbose)
    if sampler not in ("nested", "mcmc", "uniform", "polychord",
                       "ultranest", "nessai"):
        raise ValueError(f"Unknown sampler {sampler!r}.")
    bounds = check_and_return_bounds(
        bounds if bounds is not None else gpr.bounds)
    d = bounds.shape[0]
    p = gpr.surrogate_params()
    dt, dev = p.X.dtype, p.X.device
    lo = torch.as_tensor(bounds[:, 0], dtype=dt, device=dev)
    hi = torch.as_tensor(bounds[:, 1], dtype=dt, device=dev)
    rng = _rng_of(rng)
    gen = torch_generator_from_rng(rng, dev)
    logp = surrogate_logp_fn(gpr.family)

    if sampler == "uniform":
        n = int(options.get("n_samples", 5000))
        X = torch.rand((n, d), generator=gen, dtype=dt, device=dev) \
            * (hi - lo) + lo
        logpost = logp(p, X)
        gpr.n_eval += n
        return {"X": X.cpu().numpy(), "logpost": logpost.cpu().numpy(),
                "weights": np.ones(n)}

    if sampler == "mcmc":
        return _mc_sample_mcmc(gpr, p, logp, gen, lo, hi, bounds, rng,
                               options, verbose)

    if sampler != "nested":
        return _mc_sample_host_ns(gpr, p, sampler, bounds, rng, options,
                                  verbose)

    nlive = get_Xnumber(options.get("nlive", "50d"), "d", d, dtype=int,
                        varname="nlive")
    num_repeats = get_Xnumber(options.get("num_repeats", "5d"), "d", d,
                              dtype=int, varname="num_repeats")
    max_dead = int(options.get("max_dead", max(4000, 60 * nlive)))
    t0 = time.perf_counter()
    # each step's chains DP-split over the available device mesh
    res = run_nested_device(
        logp, p, gen, lo, hi, nlive=int(nlive), num_repeats=int(num_repeats),
        precision_criterion=float(options.get("precision_criterion", 0.01)),
        max_dead=max_dead, on_segment=heartbeat,
        mesh=_mesh.available_mesh(p.X))
    logw = res.logw.cpu().numpy()
    logl = res.logl.cpu().numpy()
    keep = np.isfinite(logw) & np.isfinite(logl)
    X = res.X.cpu().numpy()[keep]
    logl, logw = logl[keep], logw[keep]
    time_ns = time.perf_counter() - t0
    out = {
        "X": X,
        "logpost": logl,
        "weights": np.exp(logw - np.max(logw)),
        "logZ": res.logZ,
        "n_calls": res.n_calls,
        "ns_steps": res.n_steps,
        "time_ns": time_ns,
        "time_refine": 0.0,
    }
    gpr.n_eval += res.n_calls
    if options.get("refine", True):
        from gpry_tpu_torch.mc.refine import is_refine_sample
        t0 = time.perf_counter()
        out = is_refine_sample(
            gpr, out, bounds, rng=rng,
            n_draw=int(options.get("refine_n_draw", 65536)),
            verbose=verbose)
        out["time_refine"] = time.perf_counter() - t0
    return out


def _mc_sample_host_ns(gpr, p, sampler, bounds, rng, options, verbose):
    """A host nested sampler of :func:`mc_sample_from_gp`
    (gpry_tpu/mc/samples.py:79-104): each batch of its likelihood requests
    is one gated-mean sweep (K1) on the device."""
    from gpry_tpu_torch.mc.interfaces import _ns_interfaces
    d = bounds.shape[0]
    iface = _ns_interfaces[sampler](verbose=verbose,
                                    out_dir=options.get("out_dir"))
    iface.set_prior(bounds, params=options.get("params"))
    nlive = get_Xnumber(options.get("nlive", "50d"), "d", d, dtype=int,
                        varname="nlive")
    num_repeats = get_Xnumber(options.get("num_repeats", "5d"), "d", d,
                              dtype=int, varname="num_repeats")
    iface.set_precision(
        nlive=int(nlive), num_repeats=int(num_repeats),
        precision_criterion=float(options.get("precision_criterion", 0.01)),
        nprior=options.get("nprior"), seed=int(rng.integers(2**31)))
    dt, dev = p.X.dtype, p.X.device

    def logp_host(X):
        X = np.atleast_2d(np.asarray(X, dtype=float))
        return surrogate_predict_mean(
            gpr.family, p, torch.as_tensor(X, dtype=dt, device=dev)
        ).cpu().numpy()

    out = iface.run(logp_host)
    gpr.n_eval += int(out.get("n_calls", len(out["X"])))
    return out


def _mc_sample_mcmc(gpr, p, logp, gen, lo, hi, bounds, rng, options,
                    verbose):
    """The "mcmc" branch of :func:`mc_sample_from_gp`
    (gpry_tpu/mc/samples.py:176-206)."""
    d = bounds.shape[0]
    n_chains = int(options.get("n_chains", max(8, 2 * d)))
    n_steps = int(options.get("n_steps", 2000))
    t0 = time.perf_counter()
    X3, logpost3 = run_mcmc_device(logp, p, gen, lo, hi, n_chains=n_chains,
                                   n_steps=n_steps,
                                   covmat=options.get("covmat"))
    X3, logpost3 = X3.cpu().numpy(), logpost3.cpu().numpy()
    # cross-chain convergence diagnostic (the reference leans on Cobaya's
    # R-1 here, gpry/convergence.py:430-472)
    rhat = split_rhat(X3)
    if verbose >= 2 and not (rhat - 1.0 < 0.1):
        import warnings
        warnings.warn(
            f"Device MCMC may not have converged: split-R-hat = "
            f"{rhat:.3f} (> 1.1). Increase n_steps/n_chains.")
    X = X3.reshape(-1, d)
    logpost = logpost3.ravel()
    keep = np.isfinite(logpost)
    # exact device-eval count: 16 start tries per chain, then one proposal
    # eval per chain per step over the warm-up (n_steps // 2) and sampling
    # phases
    n_calls = n_chains * (16 + n_steps // 2 + n_steps)
    gpr.n_eval += n_calls
    out = {"X": X[keep], "logpost": logpost[keep],
           "weights": np.ones(int(keep.sum())), "rhat": rhat,
           "n_calls": n_calls, "time_mcmc": time.perf_counter() - t0,
           "time_refine": 0.0}
    if options.get("refine", True):
        from gpry_tpu_torch.mc.refine import is_refine_sample
        t0 = time.perf_counter()
        out = is_refine_sample(
            gpr, out, bounds, rng=rng,
            n_draw=int(options.get("refine_n_draw", 65536)),
            verbose=verbose)
        out["time_refine"] = time.perf_counter() - t0
    return out


def process_gdsamples(samples_dict, params=None, name=None):
    """Alias of :func:`samples_dict_to_getdist` (reference: gpry/mc.py:459)."""
    return samples_dict_to_getdist(samples_dict, params=params, name=name)


def samples_dict_to_getdist(samples_dict, params=None, name=None):
    """
    A samples dict as a ``getdist.MCSamples`` (reference: gpry/mc.py:484);
    ``ImportError`` where getdist is missing.
    """
    try:
        from getdist import MCSamples
    except ImportError as excpt:
        raise ImportError(
            "getdist is not installed; install it for MCSamples export."
        ) from excpt
    X = np.asarray(samples_dict["X"])
    return MCSamples(
        samples=X,
        weights=np.asarray(samples_dict.get("weights")),
        loglikes=-np.asarray(samples_dict.get("logpost")),
        names=params or generic_params_names(X.shape[1]),
        name_tag=name,
    )


def write_samples_txt(samples_dict, path, params=None):
    """
    Plain-text chain output (weight, -logpost, params...) like the
    reference's final-MC chain files (gpry/mc.py:432-455).
    """
    X = np.asarray(samples_dict["X"])
    w = np.asarray(samples_dict.get("weights", np.ones(len(X))))
    logp = np.asarray(samples_dict.get("logpost", np.zeros(len(X))))
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    data = np.column_stack([w, -logp, X])
    header = "weight minus_logpost " + " ".join(
        params or generic_params_names(X.shape[1]))
    np.savetxt(path, data, header=header)
