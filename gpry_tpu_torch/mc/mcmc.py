"""
Ensemble MCMC over the surrogate on the device (port of
gpry_tpu/mc/mcmc.py).

An ensemble of adaptive random-walk Metropolis chains runs in lock step:
every step is ONE batched call of the log-density (the K1 kernel on the
main path) for all chains.  A warm-up phase adapts a global step size
towards 23.4% acceptance (Robbins-Monro) and accumulates the moments of
the visited points; the sampling phase then proposes with their Cholesky
factor scaled by 2.38^2 / d.  Nothing is read back to the host between
steps.  Random numbers come from an explicit ``torch.Generator``, so runs
differ from the JAX package's at the same seed: compare by distribution.
Used by the GaussianKL fallback and by ``mc_sample_from_gp(sampler=
"mcmc")``.
"""

import numpy as np
import torch

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


def _phase(logp_of, x, lp_x, log_step, chol, n, gen, adapt, out=None):
    """``n`` lock-step Metropolis steps.  ``adapt``: Robbins-Monro step
    adaptation and moment sums (returned); ``out``: (X, logp) buffers of
    the visited states, one row per step."""
    B, d = x.shape
    dt, dev = x.dtype, x.device
    s1 = torch.zeros(d, dtype=dt, device=dev)
    s2 = torch.zeros((d, d), dtype=dt, device=dev)
    for i in range(n):
        z = torch.randn((B, d), generator=gen, dtype=dt, device=dev)
        prop = x + torch.exp(log_step) * (z @ chol.T)
        lp_prop = logp_of(prop)
        lu = torch.log(torch.rand(B, generator=gen, dtype=dt, device=dev))
        accept = lu < (lp_prop - lp_x)
        x = torch.where(accept[:, None], prop, x)
        lp_x = torch.where(accept, lp_prop, lp_x)
        if adapt:
            log_step = log_step + 0.05 * (accept.to(dt).mean() - 0.234)
            s1 = s1 + x.sum(dim=0)
            s2 = s2 + x.T @ x
        if out is not None:
            out[0][i] = x
            out[1][i] = lp_x
    return x, lp_x, log_step, s1, s2


def run_mcmc_device(logp_fn, params, gen, lo, hi, n_chains=8, n_steps=2000,
                    n_warmup=None, covmat=None):
    """
    Run ``n_chains`` adaptive MH chains for ``n_steps`` each after a warm-up
    of ``n_warmup`` (default ``n_steps // 2``) on the device of ``lo``.
    ``logp_fn(params, X)`` is the log-density; ``gen`` the
    ``torch.Generator`` of every draw.  Returns the post-warm-up samples
    ``(X (chains, steps, d), logp (chains, steps))``.
    """
    d = lo.shape[0]
    dt, dev = lo.dtype, lo.device
    if n_warmup is None:
        n_warmup = n_steps // 2

    def logp_of(X):
        in_box = torch.all((X >= lo) & (X <= hi), dim=-1)
        return torch.where(in_box, logp_fn(params, X),
                           torch.full_like(X[:, 0], -torch.inf))

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
    x, lp_x, log_step, s1, s2 = _phase(logp_of, x, lp_x, log_step, chol0,
                                       n_warmup, gen, adapt=True)

    # re-estimate the proposal covariance from the warm-up states; a
    # factor that is not finite falls back to the initial one
    tt = float(max(n_warmup * n_chains, 2))
    mean_w = s1 / tt
    cov_w = s2 / tt - torch.outer(mean_w, mean_w) \
        + 1e-10 * torch.eye(d, dtype=dt, device=dev)
    chol_w, info = torch.linalg.cholesky_ex(cov_w * (2.38**2 / d))
    bad = (info != 0) | torch.isnan(chol_w).any()
    chol_w = torch.where(bad, chol0, chol_w)

    Xs = torch.empty((n_steps, n_chains, d), dtype=dt, device=dev)
    lps = torch.empty((n_steps, n_chains), dtype=dt, device=dev)
    _phase(logp_of, x, lp_x, log_step, chol_w, n_steps, gen, adapt=False,
           out=(Xs, lps))
    return Xs.transpose(0, 1), lps.transpose(0, 1)
