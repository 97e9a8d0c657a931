"""
Batched lock-step bound-constrained L-BFGS.

The JAX package vmaps a single-lane ``lax.while_loop`` solver
(gpry_tpu/ops/lbfgs.py).  Torch has no vmap over a while-loop, so here the
restarts are ONE batched solver: every tensor carries a leading lane axis,
and each lane keeps its own active mask, so a lane follows exactly the
iterates of the single-lane algorithm while the batch runs until every lane
has stopped (the semantics of a vmapped while-loop).

The algorithm is the JAX package's: a two-loop recursion over a history of
``memory_size`` (s, y) pairs, newest first; Armijo backtracking with at most
``max_linesearch_steps`` halvings; per-lane stops on the gradient-norm
tolerance, a stall (``stall_patience`` iterations each improving by less
than ``stall_rtol (1 + |f|)``), a failed line search or a non-finite value;
exact per-lane objective-evaluation counts.  Box constraints use the
sigmoid map ``x = lo + (hi - lo) sigmoid(u)`` with ``|u| <= 15``.

Objectives are batched: ``fun(X)`` maps (R, n) to (R,) lane values, and the
gradients come from ``torch.autograd.grad`` of their sum (the lanes are
independent, so each lane's gradient is its own).  The host reads one flag
per outer iteration (any lane active?) and one per line-search step (any
lane still backtracking?), as the vmapped loops' own conditions do.
"""

import torch

_SIGMOID_CLIP = 15.0  # |u| cap: sigmoid(15) differs from 1 by ~3e-7


def to_unconstrained(x, lo, hi):
    """Map x in (lo, hi) to the unconstrained u-space."""
    t = torch.clamp((x - lo) / (hi - lo), 1e-9, 1 - 1e-9)
    return torch.clamp(torch.log(t) - torch.log1p(-t), -_SIGMOID_CLIP,
                       _SIGMOID_CLIP)


def to_constrained(u, lo, hi):
    """Map unconstrained u to x in (lo, hi)."""
    return lo + (hi - lo) * torch.sigmoid(
        torch.clamp(u, -_SIGMOID_CLIP, _SIGMOID_CLIP))


def _dot(a, b):
    return torch.sum(a * b, dim=-1)


def _value_and_grad(fun, x):
    with torch.enable_grad():
        xg = x.detach().requires_grad_(True)
        f = fun(xg)
        g, = torch.autograd.grad(f.sum(), xg)
    return f.detach(), g


def _two_loop(g, S, Y, rho, kh, eps):
    """L-BFGS directions (R, n) from the per-lane histories, newest pair
    at slot 0; slots >= kh are unused."""
    M = S.shape[1]
    q = g
    alphas = []
    for j in range(M):
        valid = j < kh
        a = torch.where(valid, rho[:, j] * _dot(S[:, j], q),
                        torch.zeros_like(kh, dtype=g.dtype))
        q = q - a[:, None] * Y[:, j]
        alphas.append(a)
    yy = _dot(Y[:, 0], Y[:, 0])
    gamma = torch.where(kh > 0, _dot(S[:, 0], Y[:, 0])
                        / torch.clamp_min(yy, eps), torch.ones_like(yy))
    r = torch.clamp(gamma, 1e-8, 1e8)[:, None] * q
    for j in reversed(range(M)):
        valid = j < kh
        b = torch.where(valid, rho[:, j] * _dot(Y[:, j], r),
                        torch.zeros_like(yy))
        r = r + torch.where(valid, alphas[j] - b,
                            torch.zeros_like(yy))[:, None] * S[:, j]
    return -r


@torch.no_grad()
def minimize_lbfgs(fun, x0, maxiter=100, tol=1e-8, memory_size=8,
                   max_linesearch_steps=18, stall_patience=5,
                   stall_rtol=None, return_iters=False):
    """
    Minimize the lane objectives ``fun`` (R, n) -> (R,) from ``x0`` (R, n).
    Returns ``(x_opt, f_opt, n_evals)``; ``n_evals`` (R,) counts each
    lane's value-and-gradient calls and line-search probes.  A lane with a
    non-finite start returns ``(x0, fun(x0))``.  With ``return_iters``,
    also each lane's iterations (R,): its value-and-gradient calls are
    ``1 + iters``, its probes ``n_evals - 1 - iters``.
    """
    R, n = x0.shape
    M = memory_size
    dt, dev = x0.dtype, x0.device
    eps = 1e-12
    if stall_rtol is None:
        stall_rtol = 16 * torch.finfo(dt).eps
    f0, g0 = _value_and_grad(fun, x0)
    x, f, g = x0.clone(), f0.clone(), g0.clone()
    S = torch.zeros((R, M, n), dtype=dt, device=dev)
    Y = torch.zeros((R, M, n), dtype=dt, device=dev)
    rho = torch.zeros((R, M), dtype=dt, device=dev)
    kh = torch.zeros(R, dtype=torch.int64, device=dev)
    stall = torch.zeros(R, dtype=torch.int64, device=dev)
    stop = ~torch.isfinite(f0)
    nev = torch.ones(R, dtype=torch.int64, device=dev)
    iters = torch.zeros(R, dtype=torch.int64, device=dev)
    for _ in range(maxiter):
        active = ~stop
        if not bool(active.any()):
            break
        d = _two_loop(g, S, Y, rho, kh, eps)
        gd = _dot(g, d)
        d = torch.where((gd < 0)[:, None], d, -g)
        gd = _dot(g, d)
        # Armijo backtracking, per lane
        t = torch.ones(R, dtype=dt, device=dev)
        ok = torch.zeros(R, dtype=torch.bool, device=dev)
        n_ls = torch.zeros(R, dtype=torch.int64, device=dev)
        for _ls in range(max_linesearch_steps):
            searching = active & ~ok
            if not bool(searching.any()):
                break
            f_try = fun(x + t[:, None] * d)
            ok_try = torch.isfinite(f_try) & (f_try <= f + 1e-4 * t * gd)
            ok = torch.where(searching, ok_try, ok)
            t = torch.where(searching & ~ok_try, t * 0.5, t)
            n_ls = n_ls + searching.to(n_ls.dtype)
        t = torch.where(ok, t, torch.zeros_like(t))
        nev = nev + torch.where(active, n_ls + 1, torch.zeros_like(n_ls))
        iters = iters + active.to(iters.dtype)
        x_new = x + t[:, None] * d
        f_new2, g_new = _value_and_grad(fun, x_new)
        s = x_new - x
        yv = g_new - g
        sy = _dot(s, yv)
        store = active & ok & (sy > 1e-10)
        S = torch.where(store[:, None, None],
                        torch.cat([s[:, None], S[:, :-1]], dim=1), S)
        Y = torch.where(store[:, None, None],
                        torch.cat([yv[:, None], Y[:, :-1]], dim=1), Y)
        rho = torch.where(
            store[:, None],
            torch.cat([(1.0 / torch.clamp_min(sy, eps))[:, None],
                       rho[:, :-1]], dim=1), rho)
        kh = torch.where(store, kh + 1, kh)
        gnorm = torch.linalg.vector_norm(g_new, dim=-1)
        improved = (f - f_new2) > stall_rtol * (1 + torch.abs(f_new2))
        stall_new = torch.where(improved, torch.zeros_like(stall),
                                stall + 1)
        stop_new = (~ok) | (gnorm < tol) | ~torch.isfinite(f_new2) \
            | (stall_new >= stall_patience)
        x = torch.where(active[:, None], x_new, x)
        f = torch.where(active, f_new2, f)
        g = torch.where(active[:, None], g_new, g)
        stall = torch.where(active, stall_new, stall)
        stop = torch.where(active, stop_new, stop)
    bad = ~torch.isfinite(f)
    x = torch.where(bad[:, None], x0, x)
    f = torch.where(bad, f0, f)
    return (x, f, nev, iters) if return_iters else (x, f, nev)


def minimize_lbfgs_bounded(fun, x0, lo, hi, maxiter=100, tol=1e-8, **kw):
    """
    Box-constrained minimization via the sigmoid reparametrization.
    Returns ``(x_opt, f_opt, n_evals)`` (and the iterations, see
    :func:`minimize_lbfgs`) with x_opt strictly inside [lo, hi].
    """
    u0 = to_unconstrained(x0, lo, hi)
    u, *rest = minimize_lbfgs(lambda u: fun(to_constrained(u, lo, hi)),
                              u0, maxiter=maxiter, tol=tol, **kw)
    return (to_constrained(u, lo, hi), *rest)


def multistart_minimize(fun, x0s, lo, hi, maxiter=100, tol=1e-8,
                        count_evals=False):
    """
    Multi-start bounded minimization (gpry_tpu/ops/lbfgs.py:180): the
    starts ``x0s`` (R, d) are the lanes of one batched solve of the lane
    objectives ``fun`` (R, d) -> (R,).  Returns ``(xs (R, d), fs (R,))``,
    the caller picks the best; with ``count_evals=True`` also each lane's
    objective evaluations (R,).
    """
    xs, fs, nev = minimize_lbfgs_bounded(fun, x0s, lo, hi, maxiter=maxiter,
                                         tol=tol)
    return (xs, fs, nev) if count_evals else (xs, fs)
