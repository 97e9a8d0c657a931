def __getattr__(name):
    # Lazy exports: the kernel wrappers (ops.fused) import the classifier,
    # and gp imports them, so this package must not import gp eagerly.
    if name == "GaussianProcessRegressor":
        from gpry_tpu_torch.models.gp import GaussianProcessRegressor
        return GaussianProcessRegressor
    if name == "SVM":
        from gpry_tpu_torch.models.classifier import SVM
        return SVM
    raise AttributeError(
        f"module 'gpry_tpu_torch.models' has no attribute '{name}'")
