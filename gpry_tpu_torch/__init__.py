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
    raise AttributeError(f"module 'gpry_tpu_torch' has no attribute '{name}'")
