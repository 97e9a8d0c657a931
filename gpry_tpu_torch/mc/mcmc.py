"""
Ensemble MCMC over the surrogate on the device (port of
gpry_tpu/mc/mcmc.py).

An ensemble of adaptive random-walk Metropolis chains runs in lock step.
A warm-up phase adapts a global step size towards 23.4% acceptance
(Robbins-Monro) and accumulates the moments of the visited points; the
sampling phase then proposes with their Cholesky factor scaled by
2.38^2 / d.  Each phase draws all its random numbers at once and goes
through the log-density's own ``mcmc_chains`` route if it has one (the
gated surrogate, ``mc.samples.surrogate_logp_fn``: the CUDA kernel K12,
every step of the phase in one launch), else through the lock-step loop
``ops.fused.mcmc_chains_plain``, one batched call of the log-density per
step.  Nothing is read back to the host between steps.  Random numbers
come from an explicit ``torch.Generator``, so runs differ from the JAX
package's at the same seed: compare by distribution.
Used by the GaussianKL fallback and by ``mc_sample_from_gp(sampler=
"mcmc")``.
"""

import numpy as np
import torch

from gpry_tpu_torch.ops.fused import mcmc_chains_plain

_N_TRIES = 16


def split_rhat(chains):
    """
    Max (over dimensions) split-R-hat of an MCMC ensemble (Gelman-Rubin
    with each chain split in half).  ``chains``: (n_chains, n_steps, d),
    host numpy (a copy of gpry_tpu/mc/mcmc.py:22).
    """
    chains = np.asarray(chains)
    m, n, d = chains.shape
    half = n // 2
    if half < 2 or m < 1:
        return np.inf
    segs = chains[:, :2 * half].reshape(m * 2, half, d)
    means = segs.mean(axis=1)                     # (2m, d)
    within = segs.var(axis=1, ddof=1).mean(axis=0)
    between = half * means.var(axis=0, ddof=1)
    var_plus = (half - 1) / half * within + between / half
    return float(np.sqrt(var_plus / np.maximum(within, 1e-300)).max())


def sampling_factor(s1, s2, n_states, chol0):
    """The sampling phase's proposal factor from the warm-up's moment sums
    of ``n_states`` visited states: the Cholesky factor of their covariance
    (+ 1e-10 I) times 2.38^2 / d, or ``chol0`` where that is not finite
    (gpry_tpu/mc/mcmc.py:123-131)."""
    d = s1.shape[0]
    tt = float(max(n_states, 2))
    mean_w = s1 / tt
    cov_w = s2 / tt - torch.outer(mean_w, mean_w) \
        + 1e-10 * torch.eye(d, dtype=s1.dtype, device=s1.device)
    chol_w, info = torch.linalg.cholesky_ex(cov_w * (2.38**2 / d))
    bad = (info != 0) | torch.isnan(chol_w).any()
    return torch.where(bad, chol0, chol_w)


def run_mcmc_device(logp_fn, params, gen, lo, hi, n_chains=8, n_steps=2000,
                    n_warmup=None, covmat=None):
    """
    Run ``n_chains`` adaptive MH chains for ``n_steps`` each after a warm-up
    of ``n_warmup`` (default ``n_steps // 2``) on the device of ``lo``.
    ``logp_fn(params, X)`` is the log-density; one with a
    ``mcmc_chains(params, x, lp_x, log_step, chol, z, u, lo, hi, adapt)``
    method runs each phase through it (the gated surrogate: K12).  ``gen``
    is the ``torch.Generator`` of every draw: per phase of ``n`` steps
    ``z = randn((n, chains, d))``, then ``u = rand((n, chains))``.
    Returns the post-warm-up samples ``(X (chains, steps, d), logp
    (chains, steps))``.
    """
    d = lo.shape[0]
    dt, dev = lo.dtype, lo.device
    if n_warmup is None:
        n_warmup = n_steps // 2

    def logp_of(X):
        in_box = torch.all((X >= lo) & (X <= hi), dim=-1)
        return torch.where(in_box, logp_fn(params, X),
                           torch.full_like(X[:, 0], -torch.inf))

    route = getattr(logp_fn, "mcmc_chains", None)

    def phase(x, lp_x, log_step, chol, n, adapt):
        z = torch.randn((n, n_chains, d), generator=gen, dtype=dt,
                        device=dev)
        u = torch.rand((n, n_chains), generator=gen, dtype=dt, device=dev)
        if route is not None:
            return route(params, x, lp_x, log_step, chol, z, u, lo, hi,
                         adapt)
        return mcmc_chains_plain(logp_of, x, lp_x, log_step, chol, z, u,
                                 adapt)

    # start every chain from the best of a few uniform draws
    X0 = torch.rand((n_chains * _N_TRIES, d), generator=gen, dtype=dt,
                    device=dev) * (hi - lo) + lo
    lp0 = logp_fn(params, X0).reshape(n_chains, _N_TRIES)
    best = torch.argmax(lp0, dim=1)
    rows = torch.arange(n_chains, device=dev)
    x = X0.reshape(n_chains, _N_TRIES, d)[rows, best]
    lp_x = lp0[rows, best]

    if covmat is None:
        scale0 = (hi - lo) / 10.0
        cov0 = torch.diag(scale0 * scale0)
    else:
        cov0 = torch.as_tensor(np.asarray(covmat, dtype=float), dtype=dt,
                               device=dev)
    chol0 = torch.linalg.cholesky(cov0 * (2.38**2 / d))

    log_step = torch.zeros((), dtype=dt, device=dev)
    x, lp_x, log_step, s1, s2, _, _ = phase(x, lp_x, log_step, chol0,
                                            n_warmup, adapt=True)

    # re-estimate the proposal covariance from the warm-up states
    chol_w = sampling_factor(s1, s2, n_warmup * n_chains, chol0)
    *_, Xs, lps = phase(x, lp_x, log_step, chol_w, n_steps, adapt=False)
    return Xs.transpose(0, 1), lps.transpose(0, 1)
