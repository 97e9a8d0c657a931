"""
Covariance (kernel) functions as plain torch functions of a
log-hyperparameter vector theta (the fast-path families only).

theta layout (log space, as in gpry_tpu.ops.kernels):

    theta[..., 0]   = log(output_scale**2)     (constant kernel variance)
    theta[..., 1:]  = log(length_scale_i), i = 1..d   (anisotropic)

Every function here is differentiable (torch autograd); they are the plain
versions that the L-BFGS fit and ascent differentiate, and the reference
arithmetic that the CUDA kernels (ops/fused.py) fuse.  A leading batch
dimension on ``theta`` (and on ``X1``/``X2``) is supported throughout.

Supported families: "rbf", "matern12", "matern32", "matern52".
"""

import numpy as np
import torch

KERNEL_FAMILIES = ("rbf", "matern12", "matern32", "matern52")


def check_family(family):
    """Raise for anything but a fast-path family string."""
    if isinstance(family, tuple):
        raise NotImplementedError(
            "Kernel spec trees are not ported yet (ROADMAP.md §A, "
            "'predict_meancov and the spec trees').")
    if family not in KERNEL_FAMILIES:
        raise ValueError(f"Unknown kernel family '{family}'.")
    return family


def make_theta(output_scale, length_scales, dtype=torch.float64,
               device=None):
    """Build a theta vector from natural-space scales."""
    output_scale = torch.as_tensor(output_scale, dtype=dtype, device=device)
    length_scales = torch.atleast_1d(
        torch.as_tensor(length_scales, dtype=dtype, device=device))
    return torch.cat([torch.log(output_scale ** 2)[None],
                      torch.log(length_scales)])


def _scaled_sqdist(X1, X2, length_scales):
    """
    Pairwise squared distances of X1 (..., n, d) vs X2 (..., m, d) in units
    of the length scales (..., d), by per-dimension differences: exact in
    any dtype, unlike the ||a||^2+||b||^2-2ab expansion, which cancels.
    """
    A = X1 / length_scales[..., None, :]
    B = X2 / length_scales[..., None, :]
    diff = A[..., :, None, :] - B[..., None, :, :]
    return torch.sum(diff * diff, dim=-1)


def _safe_sqrt(s):
    """sqrt with a zero-safe gradient at s = 0 (Matern kernels)."""
    pos = s > 0.0
    safe = torch.where(pos, s, torch.ones_like(s))
    return torch.where(pos, torch.sqrt(safe), torch.zeros_like(s))


def k_of_sq(family, sq):
    """Unit-variance correlation k(r) as a function of r^2."""
    if family == "rbf":
        return torch.exp(-0.5 * sq)
    if family == "matern12":
        r = _safe_sqrt(sq)
        return torch.exp(-r)
    if family == "matern32":
        r = _safe_sqrt(3.0 * sq)
        return (1.0 + r) * torch.exp(-r)
    if family == "matern52":
        r = _safe_sqrt(5.0 * sq)
        return (1.0 + r + r * r / 3.0) * torch.exp(-r)
    raise ValueError(f"Unknown kernel family '{family}'.")


def cross_kernel(family, theta, X1, X2):
    """Covariance matrix K(X1, X2) of shape (..., n, m)."""
    check_family(family)
    variance = torch.exp(theta[..., 0])
    ls = torch.exp(theta[..., 1:])
    sq = _scaled_sqdist(X1, X2, ls)
    return variance[..., None, None] * k_of_sq(family, sq)


def kernel_diag(family, theta, X):
    """diag K(X, X): the constant ``exp(theta[0])`` for the fast families."""
    check_family(family)
    variance = torch.exp(theta[..., 0])
    return variance[..., None].expand(
        variance.shape + X.shape[-2:-1]).to(X.dtype)


def theta_bounds_dynamic(theta, d, prior_widths=None, dynamic=False,
                         output_scale_prior=(1e-2, 1e3),
                         length_scale_prior=(1e-3, 1e1)):
    """
    Log-space optimization bounds for theta (host numpy, as in the JAX
    package): static ``output_scale_prior**2`` for the variance; per length
    scale either the static ``length_scale_prior`` or, with
    ``dynamic=True``, ``[w * 1e-3, w * 100]`` for prior width ``w``.
    Returns an array of shape (1 + d, 2).
    """
    theta = np.asarray(theta)
    bounds = [[np.log(output_scale_prior[0] ** 2),
               np.log(output_scale_prior[1] ** 2)]]
    for i in range(d):
        if dynamic:
            if prior_widths is not None:
                ref = float(prior_widths[i])
            else:
                ref = float(np.exp(theta[1 + i]))
            bounds.append([np.log(ref * 1e-3), np.log(ref * 100.0)])
        else:
            bounds.append([np.log(length_scale_prior[0]),
                           np.log(length_scale_prior[1])])
    return np.array(bounds)
