"""
Sharding over a 1-D mesh of CUDA devices (port of gpry_tpu/parallel/mesh.py).

The reference's parallelism is MPI task-parallelism over batch axes
(restarts, Kriging-believer candidates, NS-sample rows: SURVEY.md section
2.2 / gpry/mpi.py).  The JAX package maps it onto a device ``Mesh``; the
port onto a tuple of torch devices driven from one process:

* **DP over the query rows**: the gated predict's rows are split over the
  mesh (:func:`sharded_predict`, K2 on every shard), the padding sliced
  off; no collective.
* **DP over the optimizer restarts**: the multistart LML fit's lanes are
  split (:func:`_sharded_fit_theta`, K11 on every shard).
* **DP over the NS chains**: each nested-sampling step's slice chains are
  split (:func:`sharded_slice_chains`, K6 on every shard; called by
  ``mc.nested.run_nested_device``).
* **TP over the training rows**: for a few queries and a large training
  buffer, each shard computes its rows' cross covariances and partial
  mean and its partial of k^T K^-1 k (K14, ``ops.fused.tp_cross_mean`` /
  ``tp_quad``), and the parts are summed (:func:`tp_predict`).

Each shard's work is the single-device work on a subset of rows, lanes or
chains, launched on the shard's own device (the wrappers make it torch's
current device), so the DP routes give the unsharded results bit for bit.

The collectives are plain torch in one process: ``all_gather`` (tiled) is
``torch.cat`` of each shard's tensor copied to the reader's device;
``psum`` a sum on the root device in shard order, which is fixed, so that
a rerun gives the same bits.  A mesh may repeat a device: ``[cuda:0] * 4``
runs the same code, kernels and gathers on one card (its shards one after
another on its stream), as the JAX package's tests force 8 host devices;
torch has one CPU device, so the CPU tests shard over ``[cpu] * 8``.

The loop dispatches through :func:`fit_theta_restarts_maybe_sharded`,
:func:`predict_maybe_sharded` and :func:`available_mesh`, which its
callers read through this module at call time (a test forces a mesh by
setting ``available_mesh`` here).  The mesh spans every visible card when
there are two or more, and is ``None`` on one card and for CPU tensors.

Deliberate deviation from the JAX package: no ``row_bucket`` padding of
the DP predict's rows (eager torch compiles nothing per shape); the rows
are padded with copies of row 0 to a multiple of the mesh size only.
"""

import contextlib
import dataclasses
import weakref

import torch

from gpry_tpu_torch import config
from gpry_tpu_torch.models.classifier import svm_decision
from gpry_tpu_torch.ops.fused import tp_cross_mean, tp_quad
from gpry_tpu_torch.ops.kernels import kernel_diag


class Mesh:
    """A 1-D mesh: ``devices`` (torch devices, repeats allowed) along the
    axis ``axis_name``; ``shape[axis_name]`` is the shard count."""

    def __init__(self, devices, axis_name="data"):
        devices = tuple(_normalize(torch.device(d)) for d in devices)
        if not devices:
            raise ValueError("a mesh needs at least one device.")
        if len({d.type for d in devices}) != 1:
            raise ValueError(f"a mesh spans one device type; got {devices}.")
        self.devices = devices
        self.axis_names = (axis_name,)
        self.shape = {axis_name: len(devices)}

    @property
    def size(self):
        return len(self.devices)

    @property
    def n_distinct(self):
        """The distinct devices the mesh spans."""
        return len(set(self.devices))

    def __repr__(self):
        return f"Mesh({[str(d) for d in self.devices]}, {self.axis_names})"


def _normalize(device):
    """A CUDA device with its index (tensors report ``cuda:0``, not
    ``cuda``); raises without a card."""
    if device.type == "cuda" and device.index is None:
        return torch.device("cuda", torch.cuda.current_device())
    return device


def make_mesh(devices=None, axis_name="data"):
    """1-D mesh over the given devices, or every visible card (the CPU
    where there is none)."""
    if devices is None:
        n = torch.cuda.device_count()
        devices = [torch.device("cuda", i) for i in range(n)] or ["cpu"]
    return Mesh(devices, axis_name)


# ---------------------------------------------------------------------------
# Automatic mesh selection for the loop
# ---------------------------------------------------------------------------

_MESH_CACHE = {}
_MESH_ENABLED = True

#: host-side counts of the sharded dispatches (lets a run show that the
#: loop really went through the mesh)
SHARD_STATS = {"predict": 0, "fit": 0, "tp": 0}

#: the TP (training-axis) predict engages when the padded training buffer
#: is at least this large and the query batch is too small for row DP
TP_NMAX_MIN = 512


@contextlib.contextmanager
def mesh_disabled():
    """Force the single-device code paths (for tests / A-B comparisons)."""
    global _MESH_ENABLED
    prev = _MESH_ENABLED
    _MESH_ENABLED = False
    try:
        yield
    finally:
        _MESH_ENABLED = prev


def available_mesh(x=None, platform=None, axis_name="data"):
    """
    Cached 1-D mesh over every card of the platform holding ``x`` (or
    ``platform``, else the package device's), or None when fewer than two
    are visible, for CPU tensors, and inside :func:`mesh_disabled`.
    """
    if not _MESH_ENABLED:
        return None
    if platform is None:
        platform = x.device.type if isinstance(x, torch.Tensor) \
            else config.get_device().type
    if platform != "cuda":
        return None
    n = torch.cuda.device_count()
    if n < 2:
        return None
    key = (platform, n, axis_name)
    if key not in _MESH_CACHE:
        _MESH_CACHE[key] = Mesh([torch.device("cuda", i) for i in range(n)],
                                axis_name)
    return _MESH_CACHE[key]


def pad_to_multiple(X, m, axis=0):
    """Pad axis length up to a multiple of m with zeros; returns (padded,
    n_valid)."""
    n = X.shape[axis]
    pad = (-n) % m
    if pad == 0:
        return X, n
    shape = list(X.shape)
    shape[axis] = pad
    return torch.cat([X, X.new_zeros(shape)], dim=axis), n


# ---------------------------------------------------------------------------
# The collectives and the replicated operands
# ---------------------------------------------------------------------------


def _all_gather(parts, device):
    """The shards' tensors concatenated in shard order on ``device``."""
    return torch.cat([t.to(device) for t in parts])


def _psum(parts, device):
    """The shards' tensors summed on ``device`` in shard order."""
    total = parts[0].to(device)
    for t in parts[1:]:
        total = total + t.to(device)
    return total


def _moved(obj, device):
    """A copy of a dataclass of tensors (a surrogate snapshot, its SVM)
    with every tensor on ``device``."""
    changes = {}
    for f in dataclasses.fields(obj):
        if not f.init:
            continue
        v = getattr(obj, f.name)
        if isinstance(v, torch.Tensor):
            changes[f.name] = v.to(device)
        elif dataclasses.is_dataclass(v):
            changes[f.name] = _moved(v, device)
    return dataclasses.replace(obj, **changes)


#: [(weakref to a snapshot, {device: its copy there})], newest last
_REPLICAS = []
_REPLICAS_MAX = 4


def _params_on(p, device):
    """The snapshot ``p`` with its tensors on ``device`` (``p`` itself on
    its own device; a copy elsewhere, made once per snapshot and device)."""
    if p.X.device == device:
        return p
    alive = [(ref, copies) for ref, copies in _REPLICAS
             if ref() is not None]
    _REPLICAS[:] = alive
    for ref, copies in alive:
        if ref() is p:
            break
    else:
        copies = {}
        _REPLICAS.append((weakref.ref(p), copies))
        del _REPLICAS[:-_REPLICAS_MAX]
    if device not in copies:
        copies[device] = _moved(p, device)
    return copies[device]


# ---------------------------------------------------------------------------
# DP predict
# ---------------------------------------------------------------------------


def sharded_predict(family, p, Xq, mesh, axis_name="data"):
    """
    DP prediction: rows of Xq split over the mesh, each shard's gated
    ``(mean, std)`` (K2) on its own device, gathered on Xq's.  Xq's leading
    dim must be a multiple of the mesh size (use pad_to_multiple).
    """
    from gpry_tpu_torch.models import gp
    P = mesh.shape[axis_name]
    nq = Xq.shape[0]
    if nq % P:
        raise ValueError(f"sharded_predict: {nq} rows over {P} shards.")
    m = nq // P
    means, stds = [], []
    for i, dev in enumerate(mesh.devices):
        mean, std = gp.surrogate_predict(
            family, _params_on(p, dev),
            Xq[i * m:(i + 1) * m].to(dev).contiguous())
        means.append(mean)
        stds.append(std)
    return _all_gather(means, Xq.device), _all_gather(stds, Xq.device)


def device_put_sharded_rows(X, mesh, axis_name="data"):
    """X's leading axis split over the mesh: one tensor a shard, each on
    its device.  The leading dim must be a multiple of the mesh size."""
    P = mesh.shape[axis_name]
    if X.shape[0] % P:
        raise ValueError(f"{X.shape[0]} rows over {P} shards.")
    m = X.shape[0] // P
    return [X[i * m:(i + 1) * m].to(dev).contiguous()
            for i, dev in enumerate(mesh.devices)]


# ---------------------------------------------------------------------------
# TP (training-axis) gated prediction
# ---------------------------------------------------------------------------
# Mean: each shard's K(X_shard, q)^T alpha_shard, summed over shards.  Std:
# with M = K^-1 split by rows, sigma^2(q) = prior_var(q) - k_q^T M k_q, each
# shard computing k_q,shard^T (M_shard k_q) after the gather of k_q; K14
# computes both parts.  M is computed once per factorization from the
# padded L (identity padding keeps its padded block the identity; masked
# k_q rows keep it inert) and cached against L's identity: the port's
# factorizations and appends return a new L (ops/linalg.py factorize,
# chol_append), never one updated in place.

_KINV_CACHE = []  # [(weakref to L, M)], newest last, bounded
_KINV_CACHE_MAX = 2


def _kinv_for(p):
    """K^-1 for the factorization ``p.L`` (``torch.cholesky_inverse`` of
    the padded factor), cached by L's identity.  The cache holds only a
    weak reference to L, so an O(nmax^2) M dies with its factorization."""
    M_found = None
    alive = []
    for ref, M in _KINV_CACHE:
        L = ref()
        if L is None:
            continue
        alive.append((ref, M))
        if L is p.L:
            M_found = M
    _KINV_CACHE[:] = alive
    if M_found is not None:
        return M_found
    # row-major, so that each shard's rows are one contiguous block
    M = torch.cholesky_inverse(p.L).contiguous()
    _KINV_CACHE.append((weakref.ref(p.L), M))
    del _KINV_CACHE[:-_KINV_CACHE_MAX]
    return M


def _tp_predict_raw(family, p, M, Xq_, mesh, axis_name="data"):
    """The TP ``(mean, var)`` in the GP's units at the preprocessed queries
    Xq_ (nq, d): K14 on every shard, the gather of k_q and the two sums.
    ``M`` is K^-1 (``_kinv_for(p)``); nmax must divide over the mesh."""
    nmax = p.X.shape[0]
    P = mesh.shape[axis_name]
    if nmax % P:
        raise ValueError(f"_tp_predict_raw: nmax={nmax} over {P} shards.")
    nloc = nmax // P
    root = Xq_.device
    Ks, means = [], []
    for i, dev in enumerate(mesh.devices):
        r0 = i * nloc
        K_i, mean_i = tp_cross_mean(
            family, p.theta.to(dev), p.X[r0:r0 + nloc].to(dev),
            p.alpha[r0:r0 + nloc].to(dev), Xq_.to(dev), r0, p.n)
        Ks.append(K_i)
        means.append(mean_i)
    k_full, quads = {}, []
    for i, dev in enumerate(mesh.devices):
        if dev not in k_full:
            k_full[dev] = _all_gather(Ks, dev)
        quads.append(tp_quad(M[i * nloc:(i + 1) * nloc].to(dev),
                             k_full[dev], Ks[i]))
    mean_ = _psum(means, root)
    quad = _psum(quads, root)
    prior_var = kernel_diag(family, p.theta, Xq_)
    return mean_, torch.clamp_min(prior_var - quad, 0.0)


def tp_predict(family, p, Xq_raw, mesh, axis_name="data"):
    """
    Gated (mean, std) prediction with the TRAINING axis split over the
    mesh: the semantics of ``surrogate_predict`` (clip, SVM and trust gates
    applied on the root device), sigma from the quadratic form
    prior - k^T K^-1 k instead of the triangular solve.
    """
    Xq_ = ((Xq_raw - p.x_loc) / p.x_scale).contiguous()
    mean_, var_ = _tp_predict_raw(family, p, _kinv_for(p), Xq_, mesh,
                                  axis_name=axis_name)
    mean = torch.minimum(mean_ * p.y_scale + p.y_loc, p.clip_max)
    std = torch.sqrt(var_) * p.y_scale
    finite = svm_decision(p.svm, Xq_)
    in_trust = torch.all((Xq_raw >= p.trust_lo) & (Xq_raw <= p.trust_hi),
                         dim=-1)
    ok = finite & in_trust
    mean = torch.where(ok, mean, torch.full_like(mean, -torch.inf))
    std = torch.where(ok, std, torch.zeros_like(std))
    return mean, std


# ---------------------------------------------------------------------------
# Entry points of the loop (models.gp, acquisition, mc)
# ---------------------------------------------------------------------------


def predict_maybe_sharded(family, p, Xq, min_rows=256, axis_name="data"):
    """
    Gated surrogate prediction with the rows DP-split over the available
    mesh (padded with copies of row 0 to a multiple of the mesh size, the
    padding sliced off: the results are ``surrogate_predict``'s bit for
    bit).  Below ``min_rows`` queries: the TP route when a mesh is up and
    the padded training buffer is at least TP_NMAX_MIN rows and divides
    over it, else the plain single-device call.
    """
    from gpry_tpu_torch.models import gp
    mesh = available_mesh(Xq)
    nq = Xq.shape[0]
    if nq < min_rows:
        if (mesh is not None and p.X.shape[0] >= TP_NMAX_MIN
                and p.X.shape[0] % mesh.shape[axis_name] == 0):
            SHARD_STATS["tp"] += 1
            return tp_predict(family, p, Xq, mesh, axis_name=axis_name)
        return gp.surrogate_predict(family, p, Xq)
    if mesh is None:
        return gp.surrogate_predict(family, p, Xq)
    SHARD_STATS["predict"] += 1
    pad = (-nq) % mesh.shape[axis_name]
    Xp = torch.cat([Xq, Xq[:1].expand(pad, -1)]) if pad else Xq
    mean, std = sharded_predict(family, p, Xp, mesh, axis_name=axis_name)
    return mean[:nq], std[:nq]


def _sharded_fit_theta(family, X, y, n, noise_var, theta0s, lo, hi, mesh,
                       maxiter=200, rel_jitter=0.0, axis_name="data"):
    """Restart-sharded multi-start LML fit: ``models.gp._fit_theta_restarts``
    (K11) on each shard's lanes on its own device, the results gathered in
    lane order (the analogue of the reference's MPI restart split,
    gpry/run.py:1253-1293).  The restart count must divide over the
    mesh."""
    from gpry_tpu_torch.models import gp
    P = mesh.shape[axis_name]
    R = theta0s.shape[0]
    if R % P:
        raise ValueError(f"_sharded_fit_theta: {R} restarts over {P} "
                         "shards.")
    m = R // P

    def on(t, dev):
        return t.to(dev) if isinstance(t, torch.Tensor) else t

    outs = [gp._fit_theta_restarts(
        family, on(X, dev), on(y, dev), n, on(noise_var, dev),
        theta0s[i * m:(i + 1) * m].to(dev).contiguous(), on(lo, dev),
        on(hi, dev), maxiter=maxiter, rel_jitter=rel_jitter)
        for i, dev in enumerate(mesh.devices)]
    return tuple(_all_gather([o[k] for o in outs], theta0s.device)
                 for k in range(3))


def fit_theta_restarts_maybe_sharded(family, X, y, n, noise_var, theta0s,
                                     lo, hi, maxiter=200, rel_jitter=0.0):
    """
    Multi-restart LML fit, restart axis DP-split when a mesh is available
    and divides the restart count; the same results either way (each
    restart is an independent lane).  Returns (thetas, nlls, n_evals).
    """
    from gpry_tpu_torch.models import gp
    mesh = available_mesh(X)
    if mesh is not None and theta0s.shape[0] % mesh.shape["data"] == 0:
        SHARD_STATS["fit"] += 1
        return _sharded_fit_theta(family, X, y, n, noise_var, theta0s, lo,
                                  hi, mesh, maxiter=maxiter,
                                  rel_jitter=rel_jitter)
    return gp._fit_theta_restarts(family, X, y, n, noise_var, theta0s, lo,
                                  hi, maxiter=maxiter, rel_jitter=rel_jitter)


def sharded_slice_chains(route, params, x0, lx0, lstar, chol, nrm, u, lo,
                         hi, done, mesh, axis_name="data"):
    """
    One nested-sampling step's B slice chains split over the mesh (the
    analogue of PolyChord's MPI-parallel live-point evolution): each
    shard runs ``route`` (the gated surrogate's ``slice_chains``, K6) on
    its chains' starts and draws (``nrm[:, s]``, ``u[:, :, s]``) on its
    own device, with the run's stop flag copied there; x, lx and the
    calls are gathered in chain order.  B must divide over the mesh.
    """
    P = mesh.shape[axis_name]
    B = x0.shape[0]
    if B % P:
        raise ValueError(f"sharded_slice_chains: {B} chains over {P} "
                         "shards.")
    m = B // P
    outs = []
    for i, dev in enumerate(mesh.devices):
        s = slice(i * m, (i + 1) * m)
        outs.append(route(
            _params_on(params, dev), x0[s].to(dev).contiguous(),
            lx0[s].to(dev).contiguous(), lstar.to(dev), chol.to(dev),
            nrm[:, s].to(dev).contiguous(), u[:, :, s].to(dev).contiguous(),
            lo.to(dev), hi.to(dev), None if done is None else done.to(dev)))
    return tuple(_all_gather([o[k] for o in outs], x0.device)
                 for k in range(3))


__all__ = ["Mesh", "make_mesh", "available_mesh", "mesh_disabled",
           "SHARD_STATS", "TP_NMAX_MIN", "pad_to_multiple",
           "sharded_predict", "device_put_sharded_rows", "tp_predict",
           "predict_maybe_sharded", "fit_theta_restarts_maybe_sharded",
           "sharded_slice_chains"]
