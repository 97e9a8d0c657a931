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

Each outer step is two launches on the device and no host read: the
bookkeeping of ``ops.fused.ns_step`` (CUDA kernel K13; its plain version
on the CPU) applies the previous step's chains, evaluates the stop test
into a device flag and, unless it is set, kills the ``B`` worst and
writes the chains' starts, threshold and covariance factor; then the
chains run through the log-density's own slice route: the gated surrogate
(``mc.samples.surrogate_logp_fn``) carries ``slice_chains``, the CUDA
kernel K6 that runs every chain's whole loop in one launch and returns at
once when the flag is set; any other log-density runs the lock-step loop
of ``ops.fused.slice_chains_lockstep`` (whose results K13 drops once the
flag is set).  A step's draws are three calls on the run's
``torch.Generator``: the starts (``randint``), the directions' normals
(``randn`` (R, B, d)) and the step-out and shrink uniforms (``rand``
(R, 31, B)).  The host queues ``seg`` steps at a time and reads the flag
once per segment, as the JAX package's ``_ns_segment`` runs ``seg_steps``
steps per program: steps queued after the stop change nothing.  The
prior phase (the JAX package's ``_ns_init``) and the final assembly
(``_ns_finalize``) run once per run in torch.  Random numbers come from
an explicit ``torch.Generator``, so runs differ from the JAX package's at
the same seed; compare them by distribution.
"""

from typing import NamedTuple

import numpy as np
import torch

from gpry_tpu_torch.ops.fused import NS_SHRINKS, NSState, ns_step, \
    slice_chains_lockstep
from gpry_tpu_torch.parallel.mesh import sharded_slice_chains


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
    n_reads: int           # host reads of device values during the run


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


def _slice_chains(logl_fn, params, logl_of, st, nrm, u, lo, hi, mesh=None):
    """
    The ``B`` constrained slice chains of one step from the state ``st``
    (``ops.fused.NSState``) on the draws ``nrm`` (R, B, d) and ``u`` (R, 31,
    B): ``logl_fn``'s own ``slice_chains`` route if it has one (its chains
    split over ``mesh`` when given), else the lock-step loop on
    ``logl_of``.  Returns (x, lx, calls (B,)).
    """
    route = getattr(logl_fn, "slice_chains", None)
    if route is None:
        return slice_chains_lockstep(logl_of, st.x0, st.lx0, st.lstar,
                                     st.chol, nrm, u)
    if mesh is not None:
        return sharded_slice_chains(route, params, st.x0, st.lx0, st.lstar,
                                    st.chol, nrm, u, lo, hi, st.done, mesh)
    return route(params, st.x0, st.lx0, st.lstar, st.chol, nrm, u, lo, hi,
                 st.done)


def run_nested_device(logl_fn, params, gen, lo, hi, nlive=200,
                      num_repeats=10, precision_criterion=0.01,
                      max_dead=5000, kill_batch=None, n_prior=None, seg=8,
                      on_segment=None, mesh=None):
    """
    Nested sampling of ``logl_fn(params, X)`` ((nq, d) -> (nq,)) under a
    uniform prior on the box [lo, hi], on the device of ``lo``.  A
    ``logl_fn`` with a ``slice_chains(params, x0, lx0, lstar, chol, nrm,
    u, lo, hi, done)`` method runs each step's chains through it (the
    gated surrogate: K6).

    ``n_prior`` (default ``nlive``): size of the initial prior sample; the
    worst ``n_prior - nlive`` draws are recorded as dead points with exact
    shrinking-live-count volumes.  ``gen`` is the ``torch.Generator`` of
    every draw.  ``seg`` steps are queued between two reads of the stop
    flag; ``on_segment`` (a heartbeat) is called after each read.

    With ``mesh`` (a 1-D device mesh, ``parallel.mesh``, whose size
    divides the kill batch ``B``) each step's chains are split over the
    mesh, each shard's on its own device (K6 there); the draws stay on the
    run's generator and the chains are independent, so the run's samples
    equal the unsharded run's whatever the mesh.  The lock-step loop of a
    log-density with no ``slice_chains`` route runs unsharded.
    """
    nlive = int(nlive)
    B = max(1, nlive // 6) if kill_batch is None else int(kill_batch)
    n_prior = nlive if n_prior is None or n_prior < nlive else int(n_prior)
    max_dead, seg, R = int(max_dead), max(1, int(seg)), int(num_repeats)
    if mesh is not None and B % mesh.shape["data"]:
        mesh = None
    dt, dev = lo.dtype, lo.device
    d = lo.shape[0]
    k0_dead = n_prior - nlive
    max_dead_tot = k0_dead + max_dead
    logx_prev_np, log_shell_np, H0 = _volume_consts(nlive, n_prior,
                                                    max_dead)
    f64, i64 = dict(dtype=dt, device=dev), dict(dtype=torch.int64,
                                                device=dev)

    def logl_of(X):
        in_box = torch.all((X >= lo) & (X <= hi), dim=-1)
        return torch.where(in_box, logl_fn(params, X),
                           torch.full_like(X[:, 0], -torch.inf))

    # prior phase
    pool_X = torch.rand((n_prior, d), generator=gen, **f64) * (hi - lo) + lo
    pool_logl = logl_fn(params, pool_X)
    order0 = torch.argsort(pool_logl, stable=True)
    dead_X = torch.zeros((max_dead_tot, d), **f64)
    dead_logl = torch.full((max_dead_tot,), -torch.inf, **f64)
    dead_X[:k0_dead] = pool_X[order0[:k0_dead]]
    dead_logl[:k0_dead] = pool_logl[order0[:k0_dead]]
    st = NSState(
        live_X=pool_X[order0[k0_dead:]], live_logl=pool_logl[order0[k0_dead:]],
        dead_X=dead_X, dead_logl=dead_logl,
        logx_prev=torch.as_tensor(logx_prev_np, **f64),
        log_shell=torch.as_tensor(log_shell_np, **f64),
        count=torch.tensor([k0_dead, n_prior, 0, 0], **i64),
        done=torch.zeros(1, dtype=torch.int32, device=dev),
        kill=torch.arange(B, **i64), x0=torch.zeros((B, d), **f64),
        lx0=torch.zeros(B, **f64), lstar=torch.zeros((), **f64),
        chol=torch.zeros((d, d), **f64),
        order=torch.full((nlive,), -1, dtype=torch.int32, device=dev))
    consts = (k0_dead, H0, float(np.log(precision_criterion)))

    # the steps, seg at a time between two reads of the stop flag; the
    # chains of a step are applied by the next ns_step
    xs, ls, cs = torch.zeros((B, d), **f64), torch.zeros(B, **f64), \
        torch.zeros(B, **i64)
    queued, reads = 0, 0
    while True:
        for _ in range(seg):
            starts = torch.randint(0, nlive - B, (B,), generator=gen,
                                   device=dev)
            nrm = torch.randn((R, B, d), generator=gen, **f64)
            u = torch.rand((R, 1 + NS_SHRINKS, B), generator=gen, **f64)
            ns_step(st, xs, ls, cs, starts, *consts)
            xs, ls, cs = _slice_chains(logl_fn, params, logl_of, st, nrm, u,
                                       lo, hi, mesh)
        ns_step(st, xs, ls, cs, starts, *consts, select=False)
        queued += seg
        reads += 1
        done = bool(st.done)
        if on_segment is not None:
            on_segment()
        if done:
            break
        if queued > max_dead // B + seg:
            raise RuntimeError("nested sampling did not stop within the "
                               "room of its dead buffer.")

    # assemble weighted samples: dead points + final live points
    k = st.count[0]
    idx_dead = torch.arange(max_dead_tot, device=dev)
    dead_logw = torch.where(idx_dead < k,
                            st.dead_logl + st.logx_prev + st.log_shell,
                            torch.full_like(st.dead_logl, -torch.inf))
    logx = -(H0 + (k.to(dt) - k0_dead) / nlive)
    live_logw = st.live_logl + logx - float(np.log(nlive))
    logw = torch.cat([dead_logw, live_logw])
    logZ = torch.logsumexp(logw, dim=0)
    # the run's last host read
    logZ, k, calls, steps = torch.cat(
        [logZ.reshape(1), st.count[:3].to(dt)]).tolist()
    return NSResult(X=torch.cat([st.dead_X, st.live_X]),
                    logl=torch.cat([st.dead_logl, st.live_logl]), logw=logw,
                    n_dead=int(k), logZ=logZ, n_calls=int(calls),
                    n_steps=int(steps), n_reads=reads + 1)
