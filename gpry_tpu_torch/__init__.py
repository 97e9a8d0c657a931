"""
gpry_tpu_torch — the PyTorch/CUDA port of gpry_tpu (active-learning
Bayesian inference of expensive likelihoods with a GP surrogate), for one
NVIDIA H100.  The hot device programs are hand-written CUDA kernels
(``csrc/``); everything else is plain torch or host numpy.

The device is explicit: ``gpry_tpu_torch.config.set_device("cuda"|"cpu")``
or the environment variable ``GPRY_TPU_TORCH_DEVICE`` (default "cuda").
"""

__version__ = "0.1.0"

from gpry_tpu_torch import config  # noqa: F401


def check_cobaya_installed():
    """Whether Cobaya can be imported (reference: gpry/__init__.py)."""
    try:
        import cobaya  # noqa: F401
    except ModuleNotFoundError:
        return False
    return True


def get_cobaya_class():
    """The Cobaya sampler wrapper class (reference: gpry/__init__.py)."""
    from gpry_tpu_torch.cobaya import CobayaWrapper
    return CobayaWrapper


def __getattr__(name):
    # Lazy top-level exports (keep `import gpry_tpu_torch` light).
    if name == "Runner":
        from gpry_tpu_torch.run import Runner
        return Runner
    if name == "GaussianProcessRegressor":
        from gpry_tpu_torch.models.gp import GaussianProcessRegressor
        return GaussianProcessRegressor
    if name == "Truth":
        from gpry_tpu_torch.truth import Truth
        return Truth
    if name == "CobayaWrapper":
        from gpry_tpu_torch.cobaya import CobayaWrapper
        return CobayaWrapper
    if name == "run_resilient":
        from gpry_tpu_torch.run import run_resilient
        return run_resilient
    raise AttributeError(f"module 'gpry_tpu_torch' has no attribute '{name}'")
