"""
The Cobaya sampler wrapper (port of gpry_tpu/cobaya.py).

Exposes the port's Runner as a Cobaya ``Sampler``, so that it can be
driven from Cobaya input files (reference surface: gpry/cobaya.py and
CobayaWrapper.yaml).  The class is built on first use and needs cobaya.

The declarative defaults (``CobayaWrapper.yaml`` beside this module) are
kept in ``DEFAULTS`` below.  The reference's YAML sets ``noise_level:
1e-1`` while its code default is 1e-2; this package uses the code default
1e-2 everywhere, as gpry_tpu does.
"""

DEFAULTS = {
    # loop options (reference CobayaWrapper.yaml:6-28)
    "n_initial": "3d",
    "max_initial": "30d1.5",
    "max_total": "70d1.5",
    "max_finite": None,
    "n_points_per_acq": "d",
    "fit_full_every": None,           # 2 sqrt(d) by default
    "fit_simple_every": 1,
    # component blocks (reference CobayaWrapper.yaml:31-93)
    "gpr": "RBF",
    "gp_acquisition": "LogExp",
    "initial_proposer": "reference",
    "convergence_criterion": None,
    "options": {},
    "mc_sampler": "nested",
    "truth_executor": "serial",
    "callback": None,
    "callback_is_MPI_aware": False,
    "checkpoint": None,
    "load_checkpoint": "resume",
    "seed": None,
    "plots": False,
    "verbose": 3,
}

#: the loop options among DEFAULTS, passed to the Runner's ``options``
_LOOP_OPTIONS = ("n_initial", "max_initial", "max_total", "max_finite",
                 "n_points_per_acq", "fit_full_every", "fit_simple_every")


def get_cobaya_class():
    """Build the CobayaWrapper Sampler class (requires cobaya)."""
    try:
        from cobaya.sampler import Sampler
    except ImportError as excpt:
        raise ImportError(
            "cobaya is required for the CobayaWrapper.") from excpt

    class CobayaWrapper(Sampler):
        """gpry_tpu_torch as a Cobaya sampler
        (reference: gpry/cobaya.py:34-340)."""

        _defaults = dict(DEFAULTS)

        def initialize(self):
            from gpry_tpu_torch.run import Runner
            opts = {k: getattr(self, k, v) for k, v in DEFAULTS.items()}
            loop_options = {k: opts[k] for k in _LOOP_OPTIONS
                            if opts[k] is not None}
            checkpoint = opts["checkpoint"]
            if checkpoint is None and getattr(self, "output", None):
                try:
                    checkpoint = self.output.add_suffix("gpry_checkpoint",
                                                        separator="_")
                except Exception:
                    checkpoint = None
            self.gpry_runner = Runner(
                self.model,
                gpr=opts["gpr"],
                gp_acquisition=opts["gp_acquisition"],
                initial_proposer=opts["initial_proposer"],
                convergence_criterion=opts["convergence_criterion"],
                options=dict(opts["options"] or {}, **loop_options),
                callback=opts["callback"],
                callback_is_MPI_aware=opts["callback_is_MPI_aware"],
                checkpoint=checkpoint,
                load_checkpoint=opts["load_checkpoint"] if checkpoint
                else None,
                seed=opts["seed"],
                mc=opts["mc_sampler"],
                plots=opts["plots"],
                verbose=opts["verbose"],
                truth_executor=opts["truth_executor"],
            )

        def run(self):
            self.gpry_runner.run()
            self.do_surrogate_sample()
            return self.gpry_runner

        def do_surrogate_sample(self):
            self.surrogate_sample = self.gpry_runner.generate_mc_sample()
            return self.surrogate_sample

        def samples(self, as_getdist=False):
            if as_getdist:
                return self.gpry_runner.last_mc_samples(as_getdist=True)
            return self.surrogate_sample

        def products(self):
            return {
                "runner": self.gpry_runner,
                "sample": getattr(self, "surrogate_sample", None),
                "progress": self.gpry_runner.progress,
            }

        @classmethod
        def get_version(cls):
            import gpry_tpu_torch
            return gpry_tpu_torch.__version__

    return CobayaWrapper


def __getattr__(name):
    if name == "CobayaWrapper":
        return get_cobaya_class()
    raise AttributeError(name)
