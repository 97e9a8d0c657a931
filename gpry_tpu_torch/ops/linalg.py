"""
Masked / padded linear algebra for the fixed-shape GP core.

As in gpry_tpu/ops/linalg.py, training arrays are padded to a bucket size
``nmax`` with a validity count ``n`` (a host int here): rows >= n of ``X``
and ``y`` are zero, and the padded kernel matrix is ``[[K_valid, 0],
[0, I]]`` so its Cholesky factor is ``[[L, 0], [0, I]]``.

The padded matrix of ``factorize`` and the new rows of ``chol_append``
(a row panel) come from the K3 kernel (``ops.fused``); their Cholesky
factorizations and triangular solves are torch.  The batched LML
(``lml_batch``: the fit's screen and re-score) is the K10 kernel's
wrapper, and ``predict_meancov`` (the mean and full covariance,
gpry_tpu/ops/linalg.py:172) the K7 kernel's, both from ``ops.fused``.  A
lane whose matrix is not positive definite gives NaN (as JAX's Cholesky
does) instead of an exception: the callers test for NaN.
"""

import torch

from gpry_tpu_torch.ops.fused import (  # noqa: F401
    cholesky_nan, lml_of_K, lml_value_grad, masked_kernel_matrix_batched,
    masked_kernel_matrix_plain, predict_meancov)
from gpry_tpu_torch.ops.kernels import cross_kernel, kernel_diag


def _row_mask(n, nmax, dtype, device):
    return (torch.arange(nmax, device=device) < n).to(dtype)


def masked_kernel_matrix(family, theta, X, n, noise_var, rel_jitter=0.0,
                         rows=None):
    """Padded training covariance for one ``theta`` (through K3); ``rows=
    (r0, r1)``: its rows r0..r1-1 alone."""
    return masked_kernel_matrix_batched(
        family, theta[None].contiguous(), X, n, noise_var, rel_jitter,
        rows)[0]


def _solve_alpha(L, y):
    z = torch.linalg.solve_triangular(L, y[:, None], upper=False)
    return torch.linalg.solve_triangular(L.T, z, upper=True)[:, 0]


def masked_cholesky(K):
    """Cholesky factor of a padded kernel matrix (its identity padding
    stays identity), gpry_tpu/ops/linalg.py:59."""
    return torch.linalg.cholesky(K)


def solve_lower(L, B):
    """The triangular solve L z = B, L lower, B a vector or a matrix
    (gpry_tpu/ops/linalg.py:64)."""
    if B.ndim == 1:
        return torch.linalg.solve_triangular(L, B[:, None], upper=False)[:, 0]
    return torch.linalg.solve_triangular(L, B, upper=False)


def factorize(family, theta, X, y, n, noise_var):
    """Full (re-)factorization: ``(L, alpha)``, ``alpha = K^-1 y``; ``L``
    is row-major (the layout K2 reads)."""
    L = cholesky_nan(masked_kernel_matrix(family, theta, X, n,
                                          noise_var)).contiguous()
    return L, _solve_alpha(L, y)


def chol_append(family, theta, X, y, n, noise_var, L, X_new, y_new):
    """
    Incremental block Cholesky append of ``k`` new points at rows
    ``n..n+k``; returns ``(X', y', n', L', alpha')`` (new tensors, the
    inputs are not modified).  The new rows of L are ``[S12^T, S22]`` with
    ``S12 = L^-1 K(X_old, X_new)`` and ``S22 = chol(K22 - S12^T S12)``.
    K3 builds only the k new rows of the grown set, a (k, nmax) panel P,
    as gpry_tpu/ops/linalg.py:104,113 builds the two blocks: ``K12 =
    P[:, :n]^T`` (the matrix is symmetric bit for bit) and ``K22 = P[:,
    n:n+k]``.
    """
    nmax = X.shape[0]
    k = X_new.shape[0]
    X2 = X.clone()
    X2[n:n + k] = X_new
    y2 = y.clone()
    y2[n:n + k] = y_new
    P = masked_kernel_matrix(family, theta, X2, n + k, noise_var,
                             rows=(n, n + k))                 # (k, nmax)
    m = _row_mask(n, nmax, X.dtype, X.device)
    K12 = (P.T * m[:, None]).contiguous()                     # (nmax, k)
    S12 = torch.linalg.solve_triangular(L, K12, upper=False)  # (nmax, k)
    K22 = P[:, n:n + k]
    S22 = cholesky_nan(K22 - S12.T @ S12)
    L2 = L.clone(memory_format=torch.contiguous_format)
    rows = torch.zeros((k, nmax), dtype=L.dtype, device=L.device)
    rows[:, :n] = S12[:n].T
    rows[:, n:n + k] = S22
    L2[n:n + k] = rows
    return X2, y2, n + k, L2, _solve_alpha(L2, y2)


def masked_lml(family, theta, X, y, n, noise_var, rel_jitter=0.0):
    """
    Log marginal likelihood of the valid block for ``theta`` (..., 1 + d):
    ``-1/2 y^T K^-1 y - sum log diag L - n/2 log 2pi``.  Plain torch and
    differentiable in ``theta`` (autograd through the Cholesky).
    """
    K = masked_kernel_matrix_plain(family, theta, X, n, noise_var,
                                   rel_jitter)
    return lml_of_K(K, y, n)


@torch.no_grad()
def lml_batch(family, X, y, n, noise_var, thetas, rel_jitter=0.0):
    """LML for each row of ``thetas`` (R, 1 + d): K10 on CUDA tensors, its
    plain version (``masked_lml``'s arithmetic) on the CPU."""
    return lml_value_grad(family, thetas.contiguous(), X, y, n, noise_var,
                          rel_jitter)


def predict_mean(family, theta, X, n, alpha, Xq):
    """Posterior mean ``K(Xq, X) @ alpha`` in preprocessed coordinates
    (plain; the gated sweep is K1)."""
    m = _row_mask(n, X.shape[0], X.dtype, X.device)
    return (cross_kernel(family, theta, Xq, X) * m[None, :]) @ alpha


def predict_meanvar(family, theta, X, n, noise_var, L, alpha, Xq):
    """Posterior mean and latent variance at ``Xq`` (plain and
    differentiable; the gated sweep is K2)."""
    m = _row_mask(n, X.shape[0], X.dtype, X.device)
    Kq = cross_kernel(family, theta, Xq, X) * m[None, :]
    mean = Kq @ alpha
    V = torch.linalg.solve_triangular(L, Kq.T, upper=False)
    var = kernel_diag(family, theta, Xq) - torch.sum(V * V, dim=0)
    return mean, torch.clamp_min(var, 0.0)
