"""
Batched nested sampling on the device (port of gpry_tpu/mc/nested.py).

Algorithm (as the JAX package): ``nlive`` live points; each outer step
kills the ``B = nlive // 6`` worst and replaces them with ``B`` constrained
slice-sampling chains started from random survivors, each doing
``num_repeats`` slice updates along directions drawn from the survivors'
covariance (whitened slice sampling).  Volumes follow the deterministic
shrinkage with an exact prior phase; the run stops when the live points'
evidence share drops below ``precision_criterion``, on a plateau, or when
the dead buffer is full.

Each outer step's ``B`` chains go through the log-density's own slice
route: the gated surrogate (``mc.samples.surrogate_logp_fn``) carries
``slice_chains``, the CUDA kernel K6 that runs every chain's whole loop in
one launch; any other log-density runs the lock-step loop of
``ops.fused.slice_chains_lockstep``, one batched call per step-out and per
shrink for all chains.  Both take the same draws, made here per repeat
from the run's ``torch.Generator``.  The host reads one flag per outer
step (the stop test), so there is no compiled segment: the JAX package's
``_ns_init``, ``_ns_segment`` and ``_ns_finalize`` are the prior phase,
the ``while`` loop and the final assembly of :func:`run_nested_device`.
Random numbers come from an explicit ``torch.Generator``, so runs differ
from the JAX package's at the same seed; compare them by distribution.
"""

from typing import NamedTuple

import numpy as np
import torch

from gpry_tpu_torch.ops.fused import NS_SHRINKS, slice_chains_lockstep


class NSResult(NamedTuple):
    X: torch.Tensor        # (n_dead_buffer + nlive, d): dead then live
    logl: torch.Tensor     # (n_dead_buffer + nlive,)
    logw: torch.Tensor     # (n_dead_buffer + nlive,) unnormalized
    n_dead: int            # valid dead entries
    #: evidence under the deterministic volume approximation (biased by
    #: O(sqrt(n_dead)/nlive) nats; fine for reweighting, not for logZ work)
    logZ: float
    n_calls: int           # log-density evaluations
    n_steps: int           # outer NS steps


def _volume_consts(nlive, n_prior, max_dead):
    """Shrinking-live-count volume bookkeeping through the prior phase
    (gpry_tpu/mc/nested.py:124-141): exclusive log X before each dead
    point, the log shell width, and the prior phase's consumed volume."""
    k0_dead = n_prior - nlive
    idx = np.arange(k0_dead + max_dead)
    n_at_kill = np.where(idx < k0_dead, n_prior - idx,
                         float(nlive)).astype(np.float64)
    inv_n = 1.0 / n_at_kill
    logx_prev = -(np.cumsum(inv_n) - inv_n)
    log_shell = np.log(-np.expm1(-inv_n))
    return logx_prev, log_shell, float(inv_n[:k0_dead].sum())


def _slice_chains(logl_fn, params, logl_of, x, lx, lstar, chol, num_repeats,
                  gen, lo, hi):
    """
    ``B`` constrained slice chains from ``x`` (B, d) with log-densities
    ``lx`` > ``lstar``: the draws of every repeat (a direction's normals,
    then the step-out and shrink uniforms), then ``logl_fn``'s own
    ``slice_chains`` route if it has one, else the lock-step loop on
    ``logl_of``.  Returns (x, lx, calls (B,)).
    """
    B, d = x.shape
    dt, dev = x.dtype, x.device
    nrm = torch.empty((num_repeats, B, d), dtype=dt, device=dev)
    u = torch.empty((num_repeats, 1 + NS_SHRINKS, B), dtype=dt, device=dev)
    for r in range(num_repeats):
        nrm[r] = torch.randn((B, d), generator=gen, dtype=dt, device=dev)
        u[r] = torch.rand((1 + NS_SHRINKS, B), generator=gen, dtype=dt,
                          device=dev)
    route = getattr(logl_fn, "slice_chains", None)
    if route is not None:
        return route(params, x, lx, lstar, chol, nrm, u, lo, hi)
    return slice_chains_lockstep(logl_of, x, lx, lstar, chol, nrm, u)


def run_nested_device(logl_fn, params, gen, lo, hi, nlive=200,
                      num_repeats=10, precision_criterion=0.01,
                      max_dead=5000, kill_batch=None, n_prior=None):
    """
    Nested sampling of ``logl_fn(params, X)`` ((nq, d) -> (nq,)) under a
    uniform prior on the box [lo, hi], on the device of ``lo``.  A
    ``logl_fn`` with a ``slice_chains(params, x0, lx0, lstar, chol, nrm,
    u, lo, hi)`` method runs each step's chains through it (the gated
    surrogate: K6).

    ``n_prior`` (default ``nlive``): size of the initial prior sample; the
    worst ``n_prior - nlive`` draws are recorded as dead points with exact
    shrinking-live-count volumes.  ``gen`` is the ``torch.Generator`` of
    every draw.
    """
    nlive = int(nlive)
    B = max(1, nlive // 6) if kill_batch is None else int(kill_batch)
    n_prior = nlive if n_prior is None or n_prior < nlive else int(n_prior)
    max_dead = int(max_dead)
    dt, dev = lo.dtype, lo.device
    d = lo.shape[0]
    k0_dead = n_prior - nlive
    max_dead_tot = k0_dead + max_dead
    logx_prev_np, log_shell_np, H0 = _volume_consts(nlive, n_prior,
                                                    max_dead)
    dead_wconst = torch.as_tensor(logx_prev_np + log_shell_np, dtype=dt,
                                  device=dev)
    idx_dead = torch.arange(max_dead_tot, device=dev)
    log_nlive = float(np.log(nlive))
    log_prec = float(np.log(precision_criterion))

    def logl_of(X):
        in_box = torch.all((X >= lo) & (X <= hi), dim=-1)
        return torch.where(in_box, logl_fn(params, X),
                           torch.full_like(X[:, 0], -torch.inf))

    def logx_at(k):
        return -(H0 + (k - k0_dead) / nlive)

    def keep_going(live_logl, dead_logl, k):
        logz_d = torch.logsumexp(torch.where(
            idx_dead < k, dead_logl + dead_wconst,
            torch.full_like(dead_logl, -torch.inf)), dim=0)
        logz_live = torch.logsumexp(live_logl, dim=0) - log_nlive \
            + logx_at(k)
        logz_tot = torch.logaddexp(logz_d, logz_live)
        not_converged = (logz_live - logz_tot) > log_prec
        lmax = torch.max(live_logl)
        spread = lmax - torch.min(live_logl)
        plateau = torch.isfinite(spread) & (
            spread < 1e-9 * torch.clamp_min(torch.abs(lmax), 1.0))
        if k - k0_dead <= nlive:
            plateau = torch.zeros_like(plateau)
        return bool((not_converged | torch.isinf(logz_tot)) & ~plateau)

    # prior phase
    pool_X = torch.rand((n_prior, d), generator=gen, dtype=dt, device=dev) \
        * (hi - lo) + lo
    pool_logl = logl_fn(params, pool_X)
    order0 = torch.argsort(pool_logl, stable=True)
    live_X = pool_X[order0[k0_dead:]]
    live_logl = pool_logl[order0[k0_dead:]]
    dead_X = torch.zeros((max_dead_tot, d), dtype=dt, device=dev)
    dead_logl = torch.full((max_dead_tot,), -torch.inf, dtype=dt,
                           device=dev)
    dead_X[:k0_dead] = pool_X[order0[:k0_dead]]
    dead_logl[:k0_dead] = pool_logl[order0[:k0_dead]]
    k = k0_dead
    calls = torch.zeros((), dtype=torch.int64, device=dev) + n_prior
    n_steps = 0
    eye = torch.eye(d, dtype=dt, device=dev)

    while k + B <= max_dead_tot and keep_going(live_logl, dead_logl, k):
        order = torch.argsort(live_logl, stable=True)
        kill_idx, survive_idx = order[:B], order[B:]
        lstar = live_logl[order[B - 1]]
        dead_X[k:k + B] = live_X[kill_idx]
        dead_logl[k:k + B] = live_logl[kill_idx]
        Xs = live_X[survive_idx]
        diff = Xs - Xs.mean(dim=0)
        cov = diff.T @ diff / (nlive - B) + 1e-12 * eye
        chol = torch.linalg.cholesky_ex(cov).L  # no host sync
        starts = torch.randint(0, nlive - B, (B,), generator=gen,
                               device=dev)
        xs, ls, cs = _slice_chains(logl_fn, params, logl_of, Xs[starts],
                                   live_logl[survive_idx][starts], lstar,
                                   chol, int(num_repeats), gen, lo, hi)
        live_X[kill_idx] = xs
        live_logl[kill_idx] = ls
        k += B
        calls += cs.sum()
        n_steps += 1

    # assemble weighted samples: dead points + final live points
    dead_logw = torch.where(idx_dead < k, dead_logl + dead_wconst,
                            torch.full_like(dead_logl, -torch.inf))
    live_logw = live_logl + logx_at(k) - log_nlive
    logw = torch.cat([dead_logw, live_logw])
    return NSResult(X=torch.cat([dead_X, live_X]),
                    logl=torch.cat([dead_logl, live_logl]), logw=logw,
                    n_dead=k, logZ=float(torch.logsumexp(logw, dim=0)),
                    n_calls=int(calls), n_steps=n_steps)
