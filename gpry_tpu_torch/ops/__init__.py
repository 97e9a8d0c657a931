from gpry_tpu_torch.ops.kernels import (  # noqa: F401
    KERNEL_FAMILIES,
    cross_kernel,
    kernel_diag,
    make_theta,
    theta_bounds_dynamic,
)
