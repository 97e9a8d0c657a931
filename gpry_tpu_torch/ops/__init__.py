from gpry_tpu_torch.ops.kernels import (  # noqa: F401
    KERNEL_FAMILIES,
    build_kernel_spec,
    cross_kernel,
    kernel_diag,
    make_theta,
    spec_cross,
    spec_diag,
    theta_bounds_dynamic,
)
