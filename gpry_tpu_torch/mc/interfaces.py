"""
Adapters over nested samplers, one contract for every engine (port of
gpry_tpu/mc/interfaces.py; reference: gpry/ns_interfaces.py).

``set_prior`` / ``set_precision`` / ``run`` / ``delete_output``, implemented
by:

* ``InterfaceDevice``: the port's own nested sampler (``mc.nested``) on
  the package device;
* ``InterfacePolyChord`` / ``InterfaceUltraNest`` / ``InterfaceNessai``:
  host engines, each behind its package's import (a missing package raises
  ``ImportError`` when the adapter is built).

:func:`init_nested_sampler` builds one by name with the reference's
fallback chain (polychord, then ultranest), which ends in the device
sampler, with a warning at each step.
"""

import os
import shutil
import warnings

import numpy as np
import torch

from gpry_tpu_torch.utils.tools import check_and_return_bounds


class NSInterface:
    """The nested-sampler adapter (reference: gpry/ns_interfaces.py:36)."""

    def __init__(self, verbose=1):
        self.verbose = verbose
        self.bounds = None
        self.params = None
        self.nlive = None
        self.num_repeats = None
        self.precision_criterion = None
        self.nprior = None
        self.seed = None
        self.out_dir = None

    def set_prior(self, bounds, params=None):
        self.bounds = check_and_return_bounds(bounds)
        self.params = params

    def set_precision(self, nlive=None, num_repeats=None,
                      precision_criterion=None, nprior=None, seed=None):
        if nlive is not None:
            self.nlive = int(nlive)
        if num_repeats is not None:
            self.num_repeats = int(num_repeats)
        if precision_criterion is not None:
            self.precision_criterion = float(precision_criterion)
        if nprior is not None:
            self.nprior = int(nprior)
        self.seed = seed

    def run(self, logp):
        """Nested sampling of ``logp(X) -> (n,)`` over the prior box;
        returns a samples dict {"X", "logpost", "weights", "logZ"}."""
        raise NotImplementedError

    def delete_output(self):
        if self.out_dir and os.path.isdir(self.out_dir):
            shutil.rmtree(self.out_dir, ignore_errors=True)


class InterfaceDevice(NSInterface):
    """The port's nested sampler (``mc.nested.run_nested_device``) on the
    package device."""

    def __init__(self, verbose=1, rng=None, out_dir=None):
        super().__init__(verbose=verbose)
        self.rng = rng if isinstance(rng, np.random.Generator) \
            else np.random.default_rng(rng)

    def run(self, logp_fn_and_params):
        """
        ``logp_fn_and_params``: a ``(fn, params)`` pair with ``fn(params,
        X)`` a log-density on device tensors (the gated surrogate of
        ``mc.samples.surrogate_logp_fn``, whose chains run on K6), or a
        host callable on numpy rows (every batch of the sampler's requests
        then goes through the host).
        """
        from gpry_tpu_torch import config
        from gpry_tpu_torch.mc.nested import run_nested_device
        from gpry_tpu_torch.parallel.rng import torch_generator_from_rng
        dt, dev = config.FIT_DTYPE, config.get_device()
        from gpry_tpu_torch.parallel import mesh as mesh_mod
        if isinstance(logp_fn_and_params, tuple):
            fn, params = logp_fn_and_params
            mesh = mesh_mod.available_mesh(platform=dev.type)
        else:
            host_fn = logp_fn_and_params

            def fn(params, X):
                out = np.asarray(host_fn(X.cpu().numpy()), dtype=float)
                return torch.as_tensor(out.reshape(X.shape[0]), dtype=dt,
                                       device=X.device)

            # every batch goes through the host: unmeshed
            params, mesh = None, None
        lo = torch.as_tensor(self.bounds[:, 0], dtype=dt, device=dev)
        hi = torch.as_tensor(self.bounds[:, 1], dtype=dt, device=dev)
        if self.seed is not None:
            self.rng = np.random.default_rng(self.seed)
        gen = torch_generator_from_rng(self.rng, dev)
        d = self.bounds.shape[0]
        nlive = self.nlive or 25 * d
        res = run_nested_device(
            fn, params, gen, lo, hi, nlive=nlive,
            num_repeats=self.num_repeats or 5 * d,
            precision_criterion=self.precision_criterion or 0.01,
            max_dead=int(nlive * max(10, 3 * d)), n_prior=self.nprior,
            mesh=mesh)
        logw = res.logw.cpu().numpy()
        keep = np.isfinite(logw)
        return {"X": res.X.cpu().numpy()[keep],
                "logpost": res.logl.cpu().numpy()[keep],
                "weights": np.exp(logw[keep] - logw[keep].max()),
                "logZ": float(res.logZ), "n_calls": int(res.n_calls)}


class InterfacePolyChord(NSInterface):
    """Host PolyChord (reference: gpry/ns_interfaces.py:102-270); needs
    pypolychord."""

    def __init__(self, verbose=1, out_dir=None):
        super().__init__(verbose=verbose)
        try:
            import pypolychord  # noqa: F401
        except ImportError as excpt:
            raise ImportError(
                "pypolychord is not installed; use InterfaceDevice (the "
                "device sampler) or install PolyChord.") from excpt
        self.out_dir = out_dir or "./polychord_out"

    def run(self, logp):
        import pypolychord
        from pypolychord.settings import PolyChordSettings
        d = self.bounds.shape[0]
        settings = PolyChordSettings(d, 0)
        if self.nlive:
            settings.nlive = self.nlive
        if self.num_repeats:
            settings.num_repeats = self.num_repeats
        if self.precision_criterion:
            settings.precision_criterion = self.precision_criterion
        if self.nprior:
            settings.nprior = self.nprior
        if self.seed is not None:
            settings.seed = int(self.seed)
        settings.base_dir = self.out_dir
        settings.file_root = "gpry_tpu_torch"
        settings.read_resume = False
        lo, hi = self.bounds[:, 0], self.bounds[:, 1]

        def prior(cube):
            return lo + np.asarray(cube) * (hi - lo)

        def likelihood(x):
            return float(np.atleast_1d(logp(np.asarray(x)[None]))[0]), []

        out = pypolychord.run_polychord(likelihood, d, 0, settings, prior)
        names = self.params or [f"x_{i}" for i in range(d)]
        out.make_paramnames_files([(p, p) for p in names])
        # the weighted chain <root>.txt: [weight, chi2 = -2 logp, params]
        samples = np.atleast_2d(np.loadtxt(out.root + ".txt"))
        return {"X": samples[:, 2:2 + d], "logpost": -0.5 * samples[:, 1],
                "weights": samples[:, 0], "logZ": float(out.logZ)}


class InterfaceUltraNest(NSInterface):
    """Host UltraNest in its vectorized mode (reference:
    gpry/ns_interfaces.py:422-537); needs ultranest."""

    def __init__(self, verbose=1, out_dir=None):
        super().__init__(verbose=verbose)
        try:
            import ultranest  # noqa: F401
        except ImportError as excpt:
            raise ImportError(
                "ultranest is not installed; use InterfaceDevice (the "
                "device sampler) or install ultranest.") from excpt
        self.out_dir = out_dir

    def run(self, logp):
        import ultranest
        d = self.bounds.shape[0]
        lo, hi = self.bounds[:, 0], self.bounds[:, 1]

        def transform(cube):
            return lo + cube * (hi - lo)

        sampler = ultranest.ReactiveNestedSampler(
            self.params or [f"x_{i}" for i in range(d)],
            lambda X: np.asarray(logp(X)), transform=transform,
            vectorized=True, log_dir=self.out_dir, resume="overwrite")
        # precision_criterion is frac_remain (gpry/ns_interfaces.py:483);
        # ultranest takes no seed
        result = sampler.run(
            min_num_live_points=self.nlive or 25 * d,
            frac_remain=self.precision_criterion or 0.01,
            viz_callback=None, show_status=False)
        ws = result["weighted_samples"]
        w = np.asarray(ws["weights"], dtype=float)
        keep = w > 0
        return {"X": np.asarray(ws["points"])[keep],
                "logpost": np.asarray(ws["logl"])[keep], "weights": w[keep],
                "logZ": float(result["logz"])}


class InterfaceNessai(NSInterface):
    """Host nessai, flow-accelerated NS (reference:
    gpry/ns_interfaces.py:272-419); needs nessai."""

    def __init__(self, verbose=1, out_dir=None):
        super().__init__(verbose=verbose)
        try:
            import nessai  # noqa: F401
        except ImportError as excpt:
            raise ImportError(
                "nessai is not installed; use InterfaceDevice (the device "
                "sampler) or install nessai.") from excpt
        self.out_dir = out_dir or "./nessai_out"

    def run(self, logp):
        from nessai.flowsampler import FlowSampler
        from nessai.model import Model as NessaiModel

        d = self.bounds.shape[0]
        names = self.params or [f"x{i}" for i in range(d)]
        lo, hi = self.bounds[:, 0], self.bounds[:, 1]
        log_volume = float(np.sum(np.log(hi - lo)))

        class _SurrogateModel(NessaiModel):
            """The log-density as a nessai Model: a flat prior on the box,
            ``logp`` as the likelihood."""

            def __init__(inner):
                inner.names = list(names)
                inner.bounds = {n: [float(lo[i]), float(hi[i])]
                                for i, n in enumerate(names)}

            def log_prior(inner, x):
                with np.errstate(divide="ignore"):
                    return np.log(inner.in_bounds(x).astype(float)) \
                        - log_volume

            def log_likelihood(inner, x):
                arr = np.stack([np.atleast_1d(x[n]) for n in inner.names],
                               axis=-1)
                return np.asarray(logp(np.atleast_2d(arr)))

        sampler = FlowSampler(
            _SurrogateModel(), output=self.out_dir,
            nlive=self.nlive or 25 * d,
            stopping=self.precision_criterion or 0.1, seed=self.seed,
            resume=False, plot=False)
        sampler.run(plot=False, save=False)
        post = sampler.posterior_samples
        X = np.stack([post[n] for n in names], axis=-1)
        # equal-weighted posterior samples; nessai's logL is our logp
        return {"X": X, "logpost": np.asarray(post["logL"], dtype=float),
                "weights": np.ones(len(X)),
                "logZ": float(sampler.log_evidence)}


_ns_interfaces = {
    "device": InterfaceDevice,
    "polychord": InterfacePolyChord,
    "ultranest": InterfaceUltraNest,
    "nessai": InterfaceNessai,
}


def init_nested_sampler(name="device", **kwargs):
    """
    The NS adapter ``name``, or, when its package does not import, the
    first of the reference's fallback chain (polychord, then ultranest,
    gpry/gp_acquisition.py:650-682) that does, then the device sampler,
    with a warning.
    """
    if name not in _ns_interfaces:
        raise ValueError(f"Unknown nested sampler {name!r}; "
                         f"available: {sorted(_ns_interfaces)}")
    try:
        return _ns_interfaces[name](**kwargs)
    except ImportError:
        pass
    for fallback in ("polychord", "ultranest", "device"):
        if fallback == name:
            continue
        try:
            iface = _ns_interfaces[fallback](**kwargs)
        except ImportError:
            continue
        warnings.warn(f"Nested sampler {name!r} is not importable; "
                      f"falling back to {fallback!r}.")
        return iface
    raise RuntimeError("No nested sampler available.")
