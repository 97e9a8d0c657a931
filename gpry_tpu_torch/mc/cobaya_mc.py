"""
The surrogate as a Cobaya likelihood (port of gpry_tpu/mc/cobaya_mc.py).

After (or during) a run the fitted GP surrogate is given to Cobaya as an
external likelihood, so that any Cobaya sampler (mcmc, polychord) can draw
the final sample from it (reference surface: gpry/mc.py:43-325).  Cobaya
calls the likelihood once a step with one point: each call is one
``gpr.predict`` of one point, a kernel launch on the package device and
one host read, and returns a Python float.  Without cobaya the route
raises ``ImportError``.
"""

import warnings
from copy import deepcopy

import numpy as np

from gpry_tpu_torch import mpi
from gpry_tpu_torch.utils.tools import generic_params_names, is_valid_covmat


def cobaya_generate_gp_model_input(gpr, bounds=None, params=None):
    """
    The Cobaya model-input dict (``{"params", "likelihood"}``) whose
    likelihood is the GP surrogate (reference: gpry/mc.py:43-103).  The
    flat log-prior volume is added back, because the surrogate models the
    posterior.
    """
    if bounds is not None:
        bounds = np.atleast_2d(np.asarray(bounds, dtype=float))
        if gpr.bounds is not None and \
                bounds.shape != np.asarray(gpr.bounds).shape:
            raise ValueError(
                f"'bounds' has shape {bounds.shape}; expected "
                f"{np.asarray(gpr.bounds).shape}.")
    elif gpr.bounds is not None:
        bounds = deepcopy(np.asarray(gpr.bounds))
    else:
        raise ValueError("Provide bounds or a GPR that carries them.")
    if params is not None:
        if len(params) != gpr.d:
            raise ValueError(
                f"Got {len(params)} params for a {gpr.d}-dim model.")
        params = list(params)
    else:
        params = generic_params_names(gpr.d)
    log_prior_volume = float(np.sum(np.log(bounds[:, 1] - bounds[:, 0])))

    def surrogate_loglike(**kwargs):
        x = [kwargs[name] for name in params]
        return float(gpr.predict(np.atleast_2d(x), validate=False)[0]) \
            + log_prior_volume

    return {
        "params": {p: {"prior": [float(b[0]), float(b[1])]}
                   for p, b in zip(params, bounds)},
        "likelihood": {"gp": {"external": surrogate_loglike,
                              "input_params": params}},
    }


def mcmc_info_from_run(model, gpr, cov=None, cov_params=None, verbose=3):
    """
    The sampler block of Cobaya's mcmc over the surrogate (reference:
    gpry/mc.py:106-156): the reference point moved to the best training
    point (the rank's own best under MPI), the covariance given where it
    is valid.
    """
    try:
        i_best = np.argsort(gpr.y_train)[-(mpi.RANK + 1)]
        best = gpr.X_train[i_best]
    except IndexError:
        best = [None] * gpr.d
    model.prior.set_reference(dict(zip(model.prior.params, best)))
    info = {"mcmc": {"measure_speeds": False, "max_tries": 100000}}
    if cov is None or not is_valid_covmat(cov):
        if verbose >= 2:
            warnings.warn(
                "No (valid) covariance matrix for the mcmc sampler; "
                "convergence will be slower.")
    else:
        info["mcmc"]["covmat"] = np.asarray(cov)
        info["mcmc"]["covmat_params"] = list(cov_params) if cov_params \
            else list(model.prior.params)
    return info


def polychord_info_from_run():
    """PolyChord's sampler block (reference: gpry/mc.py:159-170)."""
    return {"polychord": {"measure_speeds": False}}


def mc_sample_from_gp_cobaya(gpr, bounds=None, params=None, sampler="mcmc",
                             covmat=None, add_options=None, output=None,
                             verbose=3, rng=None):
    """
    The final MC sample from the surrogate by a Cobaya sampler
    (reference: gpry/mc.py:173-325).  Returns the samples dict of
    ``mc_sample_from_gp``: {"X", "logpost", "weights"}.
    """
    try:
        from cobaya import run as cobaya_run
        from cobaya.model import get_model
    except ImportError as excpt:
        raise ImportError(
            "cobaya is required for the Cobaya MC route; use the device "
            "samplers otherwise.") from excpt
    info = cobaya_generate_gp_model_input(gpr, bounds=bounds, params=params)
    params = list(info["params"])
    model = get_model(info)
    if sampler == "mcmc":
        sampler_info = mcmc_info_from_run(model, gpr, cov=covmat,
                                          verbose=verbose)
    elif sampler == "polychord":
        sampler_info = polychord_info_from_run()
    else:
        raise ValueError(f"Unknown Cobaya sampler '{sampler}'.")
    for k, v in (add_options or {}).items():
        sampler_info[list(sampler_info)[0]][k] = v
    run_info = dict(info)
    run_info["sampler"] = sampler_info
    if output:
        run_info["output"] = output
    if isinstance(rng, np.random.Generator):
        run_info["seed"] = int(rng.integers(2**31))
    _, mc_sampler = cobaya_run(run_info)
    sample = mc_sampler.products()["sample"]
    data = getattr(sample, "data", sample)  # SampleCollection or DataFrame
    X = np.asarray(data[params])
    weights = np.asarray(data["weight"], dtype=float)
    logpost = -np.asarray(data["minuslogpost"], dtype=float)
    # gpr.n_eval is not bumped here: every likelihood call went through
    # gpr.predict, which counts its points
    return {"X": X, "logpost": logpost, "weights": weights}
