"""
The hand-written CUDA kernels of the main path, their plain PyTorch
versions, and the wrappers that choose between them.

* K1 ``gated_mean`` (``csrc/gated_mean.cu``) replaces gpry_tpu's
  models/gp.py:121 surrogate_predict_mean (ops/linalg.py:157 predict_mean
  with models/classifier.py:40 svm_decision); plain version
  :func:`gated_mean_plain`.
* K2 ``gated_meanvar_logexp`` (``csrc/gated_meanvar_logexp.cu``) replaces
  models/gp.py:100 surrogate_predict and
  acquisition/batch_optimizer.py:27 _acq_values_gated (ops/linalg.py:192
  predict_meanvar); plain version :func:`gated_meanvar_logexp_plain`.
* K3 ``masked_kernel_matrix_batched`` (``csrc/masked_kernel_matrix.cu``)
  replaces ops/linalg.py:34 masked_kernel_matrix as vmapped by
  models/gp.py:188 _lml_batch; plain version
  :func:`masked_kernel_matrix_plain`.
* K4 ``kriging_believer_fill`` (``csrc/kriging_believer_fill.cu``)
  replaces acquisition/ranked_pool.py:41 _bulk_fill_device; plain version
  :func:`kriging_believer_fill_plain`.
* K5 ``meanvar_ungated`` (``csrc/meanvar_ungated.cu``) replaces
  models/gp.py:85 surrogate_mean_std_smooth (ops/linalg.py:192
  predict_meanvar) in the convergence audit's no-grad sweeps; plain version
  :func:`meanvar_ungated_plain`.
* K6 ``ns_slice_chains`` (``csrc/ns_slice_chains.cu``) replaces
  mc/nested.py:51 _slice_chain as vmapped in _ns_segment: all slice
  updates of one nested-sampling step's chains on the gated surrogate, in
  one launch; plain version :func:`ns_slice_chains_plain`, the lock-step
  loop :func:`slice_chains_lockstep` on K1's plain version.
* K7 ``predict_meancov`` (``csrc/predict_meancov.cu``) replaces
  ops/linalg.py:172 predict_meancov (``predict(return_cov=True)``); plain
  version :func:`predict_meancov_plain`.

Every kernel takes the covariance as a fast family (C() * RBF / Matern
with ARD length scales) or as a kernel spec tree (ops/kernels.py), which
:func:`encode_spec` turns into a post-order program that the kernels'
spec mode interprets (``csrc/common.cuh``).  A tree beyond
``SPEC_MAX_NODES`` nodes or ``SPEC_MAX_STACK`` stack entries raises
``ValueError`` for CUDA tensors.

A wrapper runs the plain version only when its input tensor lies on the
CPU.  For a CUDA tensor it launches the kernel or raises: there is no
fallback.  The kernels are float64-only and forward-only; a CUDA tensor
that requires grad is refused (the autograd paths call the plain versions
themselves, as the JAX package differentiated XLA there).

The seven sources compile in parallel, one ``nvcc`` per source, and link
into a shared library with a plain C interface
(``_build/libgpry_kernels.so`` inside the package), at first use, and load
over ``ctypes``.  Every launch goes on PyTorch's
current stream and is checked with ``cudaGetLastError``.

``LAUNCHES`` counts, per kernel, the launches the wrappers made (for K4,
both of its kernels: one select per round and one sweep per conditioned
round; for K6 one per call, with the staging kernel that a surrogate too
large for shared memory needs first; for K7 both of its kernels, two per
call).  Launches in spec mode count under ``"<name>/spec"``.
"""

import ctypes
import os
import shutil
import subprocess
import threading
import time

import torch

from gpry_tpu_torch.models.classifier import svm_decision
from gpry_tpu_torch.ops.kernels import check_family, cross_kernel, \
    kernel_diag, spec_n_params

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_CSRC = os.path.join(_PKG, "csrc")
_BUILD = os.path.join(_PKG, "_build")
_SOURCES = ("gated_mean.cu", "gated_meanvar_logexp.cu",
            "masked_kernel_matrix.cu", "kriging_believer_fill.cu",
            "meanvar_ungated.cu", "ns_slice_chains.cu", "predict_meancov.cu")
_HEADERS = ("common.cuh",)
_LIB_PATH = os.path.join(_BUILD, "libgpry_kernels.so")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-Xcompiler", "-fPIC")

_FAMILY_ID = {"rbf": 0, "matern12": 1, "matern32": 2, "matern52": 3}
#: spec-program op codes (csrc/common.cuh GPRY_OP_*; the ARD leaves share
#: the fast families' ids)
SPEC_OPS = {**_FAMILY_ID, "rq": 4, "expsine": 5, "dotproduct": 6,
             "white": 7, "constant": 8, "sum": 9, "product": 10, "pow": 11}
#: the largest spec program and evaluation stack the kernels take
SPEC_MAX_NODES, SPEC_MAX_STACK = 32, 16

KERNELS = ("gated_mean", "gated_meanvar_logexp",
           "masked_kernel_matrix_batched", "kriging_believer_fill",
           "meanvar_ungated", "ns_slice_chains", "predict_meancov")
#: launches per kernel made by the wrappers (never by the plain versions),
#: spec-mode launches under "<name>/spec"
LAUNCHES = {f"{k}{m}": 0 for k in KERNELS for m in ("", "/spec")}

#: seconds the last build took (None: the library was already built)
BUILD_SECONDS = None

_lib = None
_lib_lock = threading.Lock()

# K2 keeps one k vector per query in shared memory; the block's query
# count is the warp count (8) unless nmax forces fewer.
_K2_MAX_Q = 8
_SMEM_DEFAULT = 48 * 1024
_SMEM_MAX = 227 * 1024
# threads of the block-cooperative designs (K1's block design, K6): one
# thread per (point, coordinate) of two points prepares an evaluation
_BLOCK_THREADS = 128

#: the slice sampler's caps: step-out doublings and shrinks per update
NS_STEP_OUT = 6
NS_SHRINKS = 30


class KernelBuildError(RuntimeError):
    """nvcc is missing or refused the sources."""


class _Kern(ctypes.Structure):
    """``GpryKern`` of csrc/common.cuh, passed by value."""
    _fields_ = [("family", ctypes.c_int), ("nodes", ctypes.c_int),
                ("ntheta", ctypes.c_int), ("prog", ctypes.c_void_p),
                ("expo", ctypes.c_void_p)]


def reset_launch_counts():
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def _nvcc():
    found = shutil.which("nvcc")
    if found:
        return found
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    cand = os.path.join(cuda_home, "bin", "nvcc")
    if os.path.exists(cand):
        return cand
    raise KernelBuildError(
        "nvcc not found on PATH or under $CUDA_HOME/bin: the CUDA kernels "
        "cannot be built.")


def _stale():
    if not os.path.exists(_LIB_PATH):
        return True
    t_lib = os.path.getmtime(_LIB_PATH)
    return any(os.path.getmtime(os.path.join(_CSRC, f)) > t_lib
               for f in _SOURCES + _HEADERS)


def _run_all(cmds):
    """Run the commands at once and wait for every one; raise with the
    output of each that failed."""
    procs = [(cmd, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                    stderr=subprocess.PIPE, text=True))
             for cmd in cmds]
    failed = []
    for cmd, proc in procs:
        out, err = proc.communicate()
        if proc.returncode != 0:
            failed.append(f"nvcc failed ({proc.returncode}):\n"
                          f"{' '.join(cmd)}\n{out}\n{err}")
    if failed:
        raise KernelBuildError("\n".join(failed))


def build():
    """Compile ``csrc/*.cu`` into the package's ``_build/`` (if stale), one
    ``nvcc`` per source, all at once, link them, and return the path of the
    shared library."""
    global BUILD_SECONDS
    if not _stale():
        return _LIB_PATH
    os.makedirs(_BUILD, exist_ok=True)
    tag = f"{os.getpid()}.tmp"
    tmp = f"{_LIB_PATH}.{tag}"
    objs = [os.path.join(_BUILD, f"{f[:-3]}.{tag}.o") for f in _SOURCES]
    t0 = time.perf_counter()
    try:
        _run_all([[_nvcc(), *NVCC_FLAGS, "-c", "-o", obj,
                   os.path.join(_CSRC, f)]
                  for f, obj in zip(_SOURCES, objs)])
        _run_all([[_nvcc(), "-shared", "-o", tmp, *objs]])
    finally:
        for obj in objs:
            if os.path.exists(obj):
                os.remove(obj)
    os.replace(tmp, _LIB_PATH)
    BUILD_SECONDS = time.perf_counter() - t0
    return _LIB_PATH


def library():
    """The loaded kernel library (building it first if needed)."""
    global _lib
    with _lib_lock:
        if _lib is not None:
            return _lib
        lib = ctypes.CDLL(build())
        P, I, D, K = ctypes.c_void_p, ctypes.c_int, ctypes.c_double, _Kern
        lib.gpry_gated_mean.argtypes = [K] + [I] * 5 + [P] * 11 \
            + [I, P, P]
        lib.gpry_gated_mean.restype = I
        lib.gpry_gated_mean_small_smem.argtypes = [K] + [I] * 4
        lib.gpry_gated_mean_small_smem.restype = ctypes.c_size_t
        lib.gpry_spec_smem_doubles.argtypes = [K]
        lib.gpry_spec_smem_doubles.restype = ctypes.c_size_t
        lib.gpry_ns_slice_chains.argtypes = [K] + [I] * 5 + [P] * 18 \
            + [I] + [P] * 5
        lib.gpry_ns_slice_chains.restype = I
        lib.gpry_ns_slice_chains_work.argtypes = [K] + [I] * 4
        lib.gpry_ns_slice_chains_work.restype = ctypes.c_size_t
        lib.gpry_gated_meanvar_logexp.argtypes = [K] + [I] * 7 + [P] * 12 \
            + [I, D, D, P, P, P]
        lib.gpry_gated_meanvar_logexp.restype = I
        lib.gpry_masked_kernel_matrix.argtypes = [K] + [I] * 4 + [P] * 3 \
            + [I, D, P, P]
        lib.gpry_masked_kernel_matrix.restype = I
        lib.gpry_kb_sweep.argtypes = [K] + [I] * 5 + [P] * 7 \
            + [D, D, P, P, P]
        lib.gpry_kb_sweep.restype = I
        lib.gpry_kb_select.argtypes = [K] + [I] * 5 + [P] * 18
        lib.gpry_kb_select.restype = I
        lib.gpry_meanvar_ungated.argtypes = [K] + [I] * 5 + [P] * 11
        lib.gpry_meanvar_ungated.restype = I
        lib.gpry_predict_meancov.argtypes = [K] + [I] * 5 + [P] * 9
        lib.gpry_predict_meancov.restype = I
        _lib = lib
        return lib


# ---------------------------------------------------------------------------
# the covariance argument: a fast family or a spec program
# ---------------------------------------------------------------------------


def encode_spec(spec, d):
    """
    The post-order program of a kernel spec tree for the kernels' spec
    mode: ``(ops, offsets, exponents, depth)``, one entry per node (the
    theta offset of the node's first parameter; the static exponent of a
    ``pow`` node, else 0), and the evaluation stack depth it needs.
    Raises ``ValueError`` for a malformed tree, an ARD leaf whose dimension
    is not ``d``, or a tree beyond ``SPEC_MAX_NODES`` / ``SPEC_MAX_STACK``.
    """
    check_family(spec)
    ops, offs, expo = [], [], []

    def walk(node, off, below):
        """Append node's program; returns (params used, deepest stack)."""
        kind = node[0]
        if kind in ("sum", "product"):
            n1, d1 = walk(node[1], off, below)
            n2, d2 = walk(node[2], off + n1, below + 1)
            used, depth = n1 + n2, max(d1, d2)
        elif kind == "pow":
            used, depth = walk(node[1], off, below)
        else:
            if kind in _FAMILY_ID and int(node[1]) != d:
                raise ValueError(f"kernel spec leaf {node!r} does not match "
                                 f"the data's dimension d={d}.")
            used, depth = spec_n_params(node), below + 1
        ops.append(SPEC_OPS[kind])
        offs.append(off)
        expo.append(float(node[2]) if kind == "pow" else 0.0)
        return used, depth

    _, depth = walk(spec, 0, 0)
    if len(ops) > SPEC_MAX_NODES or depth > SPEC_MAX_STACK:
        raise ValueError(
            f"kernel spec of {len(ops)} nodes and stack depth {depth}: the "
            f"CUDA kernels take at most {SPEC_MAX_NODES} nodes and depth "
            f"{SPEC_MAX_STACK}.")
    return ops, offs, expo, depth


_KERN_CACHE = {}


def _kern(family, d, device):
    """The ``GpryKern`` argument for ``family`` at dimension ``d``: the
    fast family's id, or the spec program as int32 / float64 tensors on
    ``device`` (cached per spec, d and device; the cache keeps the tensors
    alive)."""
    if not isinstance(family, tuple):
        check_family(family)
        return _Kern(_FAMILY_ID[family], 0, 1 + d, None, None)
    key = (family, d, str(device))
    if key not in _KERN_CACHE:
        ops, offs, expo, _ = encode_spec(family, d)
        prog = torch.tensor(ops + offs, dtype=torch.int32, device=device)
        ex = torch.tensor(expo, dtype=torch.float64, device=device)
        _KERN_CACHE[key] = (_Kern(-1, len(ops), spec_n_params(family),
                                  prog.data_ptr(), ex.data_ptr()), prog, ex)
    return _KERN_CACHE[key][0]


def _count(name, family, launches=1):
    LAUNCHES[name + ("/spec" if isinstance(family, tuple) else "")] += \
        launches


def _check_theta(name, kern, theta):
    if theta.shape[-1] != kern.ntheta:
        raise ValueError(f"{name}: theta has {theta.shape[-1]} entries per "
                         f"row, the kernel takes {kern.ntheta}.")


# ---------------------------------------------------------------------------
# argument checks
# ---------------------------------------------------------------------------


def _check_cuda(name, device, **tensors):
    """Raise unless every tensor is contiguous float64 on ``device`` and
    none requires grad."""
    for key, t in tensors.items():
        if not isinstance(t, torch.Tensor):
            raise TypeError(f"{name}: '{key}' must be a tensor.")
        if t.dtype != torch.float64:
            raise TypeError(f"{name}: '{key}' must be float64, got "
                            f"{t.dtype} (the kernels are float64-only).")
        if t.device != device:
            raise ValueError(f"{name}: '{key}' is on {t.device}, expected "
                             f"{device}.")
        if not t.is_contiguous():
            raise ValueError(f"{name}: '{key}' must be contiguous.")
        if t.requires_grad:
            raise RuntimeError(
                f"{name}: '{key}' requires grad, but the CUDA kernel is "
                "forward-only; differentiate the plain version instead.")
    if device.type != "cuda":
        raise ValueError(f"{name}: expected CUDA tensors, got {device}.")


def _raise_on(name, rc):
    if rc != 0:
        raise RuntimeError(
            f"CUDA kernel {name} failed to launch: cudaError {rc} "
            f"({torch.cuda.get_device_name()})")


def _stream():
    return ctypes.c_void_p(torch.cuda.current_stream().cuda_stream)


def _ptr(t):
    return ctypes.c_void_p(t.data_ptr())


def _gate_tensors(p):
    """The surrogate's gate inputs as kernel arguments."""
    return dict(X=p.X, alpha=p.alpha, theta=p.theta, x_loc=p.x_loc,
                x_scale=p.x_scale, trust_lo=p.trust_lo, trust_hi=p.trust_hi,
                sv=p.svm.sv, dual=p.svm.dual, scal=p.scal)


# ---------------------------------------------------------------------------
# plain versions
# ---------------------------------------------------------------------------


def _gates(p, Xq_raw, Xq_):
    finite = svm_decision(p.svm, Xq_)
    in_trust = torch.all((Xq_raw >= p.trust_lo) & (Xq_raw <= p.trust_hi),
                         dim=-1)
    return finite & in_trust


def _cross_masked(family, p, Xq_):
    m = (torch.arange(p.X.shape[0], device=p.X.device) < p.n).to(p.X.dtype)
    return cross_kernel(family, p.theta, Xq_, p.X) * m[None, :]


def gated_mean_plain(family, p, Xq_raw):
    """Plain K1: the gated raw-space posterior mean (the NS/IS target)."""
    Xq_ = (Xq_raw - p.x_loc) / p.x_scale
    mean = (_cross_masked(family, p, Xq_) @ p.alpha) * p.y_scale + p.y_loc
    mean = torch.minimum(mean, p.clip_max)
    return torch.where(_gates(p, Xq_raw, Xq_), mean,
                       torch.full_like(mean, -torch.inf))


def meanvar_ungated_plain(family, p, Xq_raw):
    """Plain K5: the raw-space ``(mean, std)`` with no gate and no clip
    (the values of ``surrogate_mean_std_smooth``).  The variance uses the
    triangular-solve form."""
    Xq_ = (Xq_raw - p.x_loc) / p.x_scale
    Kq = _cross_masked(family, p, Xq_)
    mean = (Kq @ p.alpha) * p.y_scale + p.y_loc
    V = torch.linalg.solve_triangular(p.L, Kq.T, upper=False)
    var = kernel_diag(family, p.theta, Xq_) - torch.sum(V * V, dim=0)
    return mean, torch.sqrt(torch.clamp_min(var, 0.0)) * p.y_scale


def gated_meanvar_logexp_plain(family, p, Xq_raw, logexp=None):
    """
    Plain K2.  Without ``logexp``: the gated ``(mean, std)`` of
    ``surrogate_predict``.  With ``logexp=(zeta, noise_std)``: the gated
    LogExp values ``2 zeta (mean - y_max) + 0.5 log(std^2 - noise_std^2)``
    (-inf where that variance is <= 0 or the mean is not finite), as
    ``_acq_values_gated``.
    """
    mean, std = meanvar_ungated_plain(family, p, Xq_raw)
    mean = torch.minimum(mean, p.clip_max)
    ok = _gates(p, Xq_raw, (Xq_raw - p.x_loc) / p.x_scale)
    mean = torch.where(ok, mean, torch.full_like(mean, -torch.inf))
    std = torch.where(ok, std, torch.zeros_like(std))
    if logexp is None:
        return mean, std
    zeta, noise_std = logexp
    var2 = std * std - noise_std * noise_std
    ok2 = (var2 > 0) & torch.isfinite(mean)
    vals = 2.0 * zeta * (mean - p.y_max) + \
        0.5 * torch.log(torch.where(ok2, var2, torch.ones_like(var2)))
    return torch.where(ok2, vals, torch.full_like(vals, -torch.inf))


def masked_kernel_matrix_plain(family, thetas, X, n, noise_var,
                               rel_jitter=0.0):
    """
    Plain K3 (differentiable in ``thetas``): the padded training covariance
    ``[[K_valid + (noise + rel_jitter * exp(theta[0])) I, 0], [0, I]]`` for
    every leading index of ``thetas`` (..., p), its diagonal the same-point
    covariance (``kernel_diag``: a WhiteKernel term enters only there), as
    gpry_tpu/ops/linalg.py:34.  ``noise_var`` is a scalar or an (nmax,)
    vector.
    """
    nmax = X.shape[0]
    m = (torch.arange(nmax, device=X.device) < n).to(X.dtype)
    K = cross_kernel(family, thetas, X, X)
    if isinstance(family, tuple):
        # gpry_tpu/ops/linalg.py:47 restores it for every kernel; a fast
        # family's k(x, x) is its diagonal already, exactly, but adding the
        # zero difference reorders the autograd fit's sums, which moves the
        # fast-family Runner trajectories (ROADMAP.md §C)
        K = K + torch.diag_embed(kernel_diag(family, thetas, X)
                                 - torch.diagonal(K, dim1=-2, dim2=-1))
    K = K * (m[:, None] * m[None, :])
    noise = torch.as_tensor(noise_var, dtype=X.dtype, device=X.device)
    diag = noise.expand(nmax) + \
        rel_jitter * torch.exp(thetas[..., 0])[..., None]
    diag_fill = torch.where(m > 0, diag, torch.ones_like(diag))
    return K + torch.diag_embed(diag_fill)


def kriging_believer_fill_plain(family, p, Xd_raw, y, sigma, acq0, alive0,
                                size, acq_values):
    """
    Plain K4: the greedy Kriging-believer fill of ``size`` pool slots
    (gpry_tpu/acquisition/ranked_pool.py:41 _bulk_fill_device, line by
    line).  ``p`` has at least ``size`` free padded rows; ``acq_values(y,
    sd)`` is the acquisition of raw means and (ungated) conditioned stds.
    Returns ``(outX, outY, outS, outA, outC)``; unfilled slots carry
    ``outC = -inf``.
    """
    dt = p.X.dtype
    nmax = p.X.shape[0]
    N, d = Xd_raw.shape
    Xq_ = (Xd_raw - p.x_loc) / p.x_scale
    prior_var = kernel_diag(family, p.theta, Xq_)
    minus_inf = torch.tensor(-torch.inf, dtype=dt, device=Xd_raw.device)
    rows = torch.arange(nmax, device=Xd_raw.device)

    def noise_at(n):
        return p.noise_var if p.noise_var.ndim == 0 else p.noise_var[n]

    def sigma_cond(Xbuf, n, L):
        m = (rows < n).to(dt)
        Kq = cross_kernel(family, p.theta, Xq_, Xbuf) * m[None, :]
        V = torch.linalg.solve_triangular(L, Kq.T, upper=False)
        var = prior_var - torch.sum(V * V, dim=0)
        return torch.sqrt(torch.clamp_min(var, 0.0)) * p.y_scale

    outX = torch.zeros((size, d), dtype=dt, device=Xd_raw.device)
    outY = torch.zeros(size, dtype=dt, device=Xd_raw.device)
    outS = torch.zeros(size, dtype=dt, device=Xd_raw.device)
    outA = torch.full((size,), -torch.inf, dtype=dt, device=Xd_raw.device)
    outC = torch.full((size,), -torch.inf, dtype=dt, device=Xd_raw.device)
    Xbuf, n, L = p.X.clone(), p.n, p.L.clone()
    alive = alive0.clone()
    for i in range(size):
        if i == 0:
            # round 0 ranks by the unconditioned acquisition
            acq_cond = acq0
        else:
            ac = acq_values(y, sigma_cond(Xbuf, n, L))
            finite = torch.isfinite(ac)
            alive = alive & finite
            acq_cond = torch.where(finite, ac, minus_inf)
        acq_m = torch.where(alive, acq_cond, minus_inf)
        j = int(torch.argmax(acq_m))
        valid = bool(torch.isfinite(acq_m[j]))
        alive[j] = False
        if not valid:
            continue
        outX[i], outY[i], outS[i] = Xd_raw[j], y[j], sigma[j]
        outA[i], outC[i] = acq0[j], acq_m[j]
        # rank-1 Cholesky append of the believer lie at row n
        xj_ = Xq_[j]
        m = (rows < n).to(dt)
        K12 = cross_kernel(family, p.theta, Xbuf, xj_[None]) * m[:, None]
        S12 = torch.linalg.solve_triangular(L, K12, upper=False)[:, 0]
        k22 = kernel_diag(family, p.theta, xj_[None])[0] + noise_at(n)
        s22 = torch.sqrt(torch.clamp_min(k22 - torch.sum(S12 * S12),
                                         1e-12))
        L[n] = torch.where(rows == n, s22, S12)
        Xbuf[n] = xj_
        n += 1
    return outX, outY, outS, outA, outC


def predict_meancov_plain(family, theta, X, n, noise_var, L, alpha, Xq):
    """
    Plain K7 (gpry_tpu/ops/linalg.py:172 predict_meancov): the posterior
    mean and full covariance at ``Xq`` (nq, d), in the GP's (preprocessed)
    coordinates, given the padded factorization; the covariance's diagonal
    is the same-point variance ``kernel_diag - |V|^2``.
    """
    m = (torch.arange(X.shape[0], device=X.device) < n).to(X.dtype)
    Kq = cross_kernel(family, theta, Xq, X) * m[None, :]
    mean = Kq @ alpha
    V = torch.linalg.solve_triangular(L, Kq.T, upper=False)
    Kqq = cross_kernel(family, theta, Xq, Xq)
    Kqq = Kqq + torch.diag(kernel_diag(family, theta, Xq)
                           - torch.diagonal(Kqq))
    return mean, Kqq - V.T @ V


def slice_chains_lockstep(logl_of, x, lx, lstar, chol, nrm, u):
    """
    ``B`` constrained slice-sampling chains in lock step (gpry_tpu's
    mc/nested.py:51 _slice_chain, vmapped): from ``x`` (B, d) with
    log-densities ``lx`` > ``lstar``, one slice update per leading index of
    the draws ``nrm`` (R, B, d) and ``u`` (R, 1 + NS_SHRINKS, B), along
    ``chol``-whitened directions.  Every step-out and every shrink is ONE
    batched call of ``logl_of`` ((nq, d) -> (nq,), -inf outside the prior)
    for all chains; a chain that has finished keeps its state and does not
    count the calls.  Returns (x, lx, calls (B,) int64).
    """
    B, d = x.shape
    dt, dev = x.dtype, x.device
    calls = torch.zeros(B, dtype=torch.int64, device=dev)
    for r in range(nrm.shape[0]):
        e = (nrm[r] / torch.linalg.vector_norm(nrm[r], dim=1, keepdim=True)) \
            @ chol.T
        w0 = u[r, 0] * 0.9 + 0.05
        tlo, thi = -w0, 1.0 - w0
        ends = logl_of(torch.cat([x + tlo[:, None] * e,
                                  x + thi[:, None] * e]))
        l_lo, l_hi = ends[:B], ends[B:]
        calls += 2
        # step out by doubling, capped
        for _it in range(NS_STEP_OUT):
            active = (l_lo > lstar) | (l_hi > lstar)
            tlo = torch.where(l_lo > lstar, tlo * 2.0, tlo)
            thi = torch.where(l_hi > lstar, thi * 2.0, thi)
            ends = logl_of(torch.cat([x + tlo[:, None] * e,
                                      x + thi[:, None] * e]))
            l_lo = torch.where(active, ends[:B], l_lo)
            l_hi = torch.where(active, ends[B:], l_hi)
            calls += 2 * active
        # shrinkage sampling
        t = torch.zeros(B, dtype=dt, device=dev)
        l_new = lx
        accepted = torch.zeros(B, dtype=torch.bool, device=dev)
        for it in range(NS_SHRINKS):
            active = ~accepted
            t_try = tlo + (thi - tlo) * u[r, 1 + it]
            l_try = logl_of(x + t_try[:, None] * e)
            acc_try = l_try > lstar
            t = torch.where(active, t_try, t)
            l_new = torch.where(active, l_try, l_new)
            accepted = accepted | (active & acc_try)
            miss = active & ~acc_try
            tlo = torch.where(miss & (t_try < 0), t_try, tlo)
            thi = torch.where(miss & (t_try >= 0), t_try, thi)
            calls += active
        x = torch.where(accepted[:, None], x + t[:, None] * e, x)
        lx = torch.where(accepted, l_new, lx)
    return x, lx, calls


def ns_slice_chains_plain(family, p, x0, lx0, lstar, chol, nrm, u, lo, hi):
    """Plain K6: :func:`slice_chains_lockstep` on the gated surrogate
    mean (plain K1) with -inf outside the prior box [lo, hi]."""

    def logl_of(X):
        in_box = torch.all((X >= lo) & (X <= hi), dim=-1)
        return torch.where(in_box, gated_mean_plain(family, p, X),
                           torch.full_like(X[:, 0], -torch.inf))

    return slice_chains_lockstep(logl_of, x0, lx0, lstar, chol, nrm, u)


# ---------------------------------------------------------------------------
# wrappers
# ---------------------------------------------------------------------------


def gated_mean(family, p, Xq_raw, _design=None):
    """K1: gated posterior mean at ``Xq_raw`` (nq, d) for surrogate ``p``.

    K1 has two designs: one block per query when the surrogate fits in a
    block's shared memory and 2 d <= 128, else the tiled one (one thread
    per query).  ``_design`` ("block" or "tiled") forces one, for the
    kernel's own checks."""
    check_family(family)
    if Xq_raw.device.type == "cpu":
        return gated_mean_plain(family, p, Xq_raw)
    tensors = dict(Xq_raw=Xq_raw, **_gate_tensors(p))
    _check_cuda("gated_mean", Xq_raw.device, **tensors)
    nq, d = Xq_raw.shape
    kern = _kern(family, d, Xq_raw.device)
    _check_theta("gated_mean", kern, p.theta)
    out = torch.empty(nq, dtype=torch.float64, device=Xq_raw.device)
    if nq == 0:
        return out
    lib = library()
    nsv = p.svm.sv.shape[0]
    fits = 2 * d <= _BLOCK_THREADS and lib.gpry_gated_mean_small_smem(
        kern, int(p.n), nsv, d, int(p.svm.mode)) <= _SMEM_MAX
    if _design not in (None, "block", "tiled"):
        raise ValueError(f"gated_mean: unknown design {_design!r}.")
    if _design == "block" and not fits:
        raise ValueError("gated_mean: the block design needs the surrogate "
                         "in shared memory and 2 d <= 128.")
    block = fits if _design is None else _design == "block"
    rc = lib.gpry_gated_mean(
        kern, int(block), nq, int(p.n), nsv, d,
        *(_ptr(tensors[k]) for k in (
            "Xq_raw", "X", "alpha", "theta", "x_loc", "x_scale",
            "trust_lo", "trust_hi", "sv", "dual", "scal")),
        int(p.svm.mode), _ptr(out), _stream())
    _raise_on("gated_mean", rc)
    _count("gated_mean", family)
    return out


def _sweep_queries_per_block(nmax, d, kern):
    """Queries per block of the one-warp-per-query sweeps (K2, K4's sweep,
    K5, K7's solve): one per warp, fewer when nmax-long k vectors of 8
    queries (and the spec program) do not fit in the default 48 KB of
    shared memory."""
    per_q = 8 * (nmax + 2 * d + 1)
    fixed = 8 * (d + library().gpry_spec_smem_doubles(kern))
    q = min(_K2_MAX_Q, (_SMEM_DEFAULT - fixed) // per_q)
    if q >= 1:
        return q
    if fixed + per_q > _SMEM_MAX:
        raise ValueError(
            f"nmax={nmax} needs more shared memory per query than a Hopper "
            "block has.")
    return 1


def gated_meanvar_logexp(family, p, Xq_raw, logexp=None):
    """K2: gated ``(mean, std)`` at ``Xq_raw``, or with
    ``logexp=(zeta, noise_std)`` the gated LogExp acquisition values."""
    check_family(family)
    if Xq_raw.device.type == "cpu":
        return gated_meanvar_logexp_plain(family, p, Xq_raw, logexp)
    tensors = dict(Xq_raw=Xq_raw, L=p.L, **_gate_tensors(p))
    _check_cuda("gated_meanvar_logexp", Xq_raw.device, **tensors)
    nq, d = Xq_raw.shape
    nmax = p.X.shape[0]
    kern = _kern(family, d, Xq_raw.device)
    _check_theta("gated_meanvar_logexp", kern, p.theta)
    out0 = torch.empty(nq, dtype=torch.float64, device=Xq_raw.device)
    out1 = out0 if logexp is not None else torch.empty_like(out0)
    if nq == 0:
        return out0 if logexp is not None else (out0, out1)
    zeta, noise_std = (0.0, 0.0) if logexp is None else logexp
    Q = _sweep_queries_per_block(nmax, d, kern)
    lib = library()
    rc = lib.gpry_gated_meanvar_logexp(
        kern, int(logexp is not None), nq, int(p.n), nmax,
        p.svm.sv.shape[0], d, Q,
        *(_ptr(tensors[k]) for k in (
            "Xq_raw", "X", "alpha", "L", "theta", "x_loc", "x_scale",
            "trust_lo", "trust_hi", "sv", "dual", "scal")),
        int(p.svm.mode), float(zeta), float(noise_std), _ptr(out0),
        _ptr(out1), _stream())
    _raise_on("gated_meanvar_logexp", rc)
    _count("gated_meanvar_logexp", family)
    return out0 if logexp is not None else (out0, out1)


def meanvar_ungated(family, p, Xq_raw):
    """K5: the raw-space ``(mean, std)`` at ``Xq_raw`` with no gate and no
    clip, for no-grad sweeps (the convergence audit)."""
    check_family(family)
    if Xq_raw.device.type == "cpu":
        return meanvar_ungated_plain(family, p, Xq_raw)
    tensors = dict(Xq_raw=Xq_raw, X=p.X, alpha=p.alpha, L=p.L, theta=p.theta,
                   x_loc=p.x_loc, x_scale=p.x_scale, scal=p.scal)
    _check_cuda("meanvar_ungated", Xq_raw.device, **tensors)
    nq, d = Xq_raw.shape
    nmax = p.X.shape[0]
    kern = _kern(family, d, Xq_raw.device)
    _check_theta("meanvar_ungated", kern, p.theta)
    mean = torch.empty(nq, dtype=torch.float64, device=Xq_raw.device)
    std = torch.empty_like(mean)
    if nq == 0:
        return mean, std
    lib = library()
    rc = lib.gpry_meanvar_ungated(
        kern, nq, int(p.n), nmax, d, _sweep_queries_per_block(nmax, d, kern),
        *(_ptr(tensors[k]) for k in (
            "Xq_raw", "X", "alpha", "L", "theta", "x_loc", "x_scale",
            "scal")),
        _ptr(mean), _ptr(std), _stream())
    _raise_on("meanvar_ungated", rc)
    _count("meanvar_ungated", family)
    return mean, std


def masked_kernel_matrix_batched(family, thetas, X, n, noise_var,
                                 rel_jitter=0.0):
    """K3: padded training covariances (R, nmax, nmax) for ``thetas``
    (R, p); ``noise_var`` a scalar or an (nmax,) vector."""
    check_family(family)
    if X.device.type == "cpu":
        return masked_kernel_matrix_plain(family, thetas, X, n, noise_var,
                                          rel_jitter)
    R = thetas.shape[0]
    nmax, d = X.shape
    kern = _kern(family, d, X.device)
    if thetas.shape != (R, kern.ntheta):
        raise ValueError(f"thetas must be (R, {kern.ntheta}); got "
                         f"{tuple(thetas.shape)}.")
    if R > 65535:
        raise ValueError("masked_kernel_matrix_batched: R > 65535.")
    noise = torch.as_tensor(noise_var, dtype=torch.float64,
                            device=X.device).reshape(-1).contiguous()
    if noise.numel() not in (1, nmax):
        raise ValueError("noise_var must be a scalar or an (nmax,) vector.")
    _check_cuda("masked_kernel_matrix_batched", X.device, thetas=thetas, X=X,
                noise=noise)
    out = torch.empty((R, nmax, nmax), dtype=torch.float64, device=X.device)
    if R == 0 or nmax == 0:
        return out
    lib = library()
    rc = lib.gpry_masked_kernel_matrix(
        kern, R, nmax, int(n), d, _ptr(thetas), _ptr(X),
        _ptr(noise), int(noise.numel() == nmax), float(rel_jitter),
        _ptr(out), _stream())
    _raise_on("masked_kernel_matrix_batched", rc)
    _count("masked_kernel_matrix_batched", family)
    return out


def kriging_believer_fill(family, p, Xd_raw, y, sigma, acq0, alive0, size,
                          acq_values, logexp=None):
    """
    K4: the greedy Kriging-believer fill (see
    :func:`kriging_believer_fill_plain` for the arguments).  With
    ``logexp=(zeta, noise_std)`` the acquisition is LogExp and runs inside
    the sweep kernel; otherwise the sweep returns the conditioned stds and
    ``acq_values`` is applied in torch between the two kernels of a round.
    Every round stays on the device: nothing is read back to the host.
    """
    check_family(family)
    if Xd_raw.device.type == "cpu":
        return kriging_believer_fill_plain(family, p, Xd_raw, y, sigma, acq0,
                                           alive0, size, acq_values)
    dev = Xd_raw.device
    N, d = Xd_raw.shape
    nmax = p.X.shape[0]
    if p.n + size > nmax:
        raise ValueError(f"kriging_believer_fill: n={p.n} + size={size} "
                         f"exceeds the padded buffer nmax={nmax}.")
    if tuple(p.L.shape) != (nmax, nmax) or not p.L.is_contiguous():
        raise ValueError("kriging_believer_fill: L must be a row-major "
                         "(nmax, nmax) factor.")
    if alive0.dtype != torch.bool or alive0.shape != (N,):
        raise TypeError("kriging_believer_fill: alive0 must be an (N,) "
                        "bool tensor.")
    noise = p.noise_var.reshape(-1).contiguous()
    if noise.numel() not in (1, nmax):
        raise ValueError("noise_var must be a scalar or an (nmax,) vector.")
    tensors = dict(Xd_raw=Xd_raw, y=y, sigma=sigma, acq0=acq0, L=p.L,
                   X=p.X, theta=p.theta, x_loc=p.x_loc, x_scale=p.x_scale,
                   scal=p.scal, noise=noise)
    _check_cuda("kriging_believer_fill", dev, **tensors)
    if alive0.device != dev:
        raise ValueError(f"kriging_believer_fill: 'alive0' is on "
                         f"{alive0.device}, expected {dev}.")
    kern = _kern(family, d, dev)
    _check_theta("kriging_believer_fill", kern, p.theta)
    dt = torch.float64
    outX = torch.empty((size, d), dtype=dt, device=dev)
    outY, outS, outA, outC = (torch.empty(size, dtype=dt, device=dev)
                              for _ in range(4))
    if size <= 0:
        return outX, outY, outS, outA, outC
    # working state: updated in place by the kernels, never read on host
    Xq_ = ((Xd_raw - p.x_loc) / p.x_scale).contiguous()
    Xbuf, L = p.X.clone(), p.L.clone()
    alive = alive0.clone()
    n_dev = torch.tensor([p.n], dtype=torch.int32, device=dev)
    swept = torch.empty(N, dtype=dt, device=dev)
    zeta, noise_std = (0.0, 0.0) if logexp is None else logexp
    Q = _sweep_queries_per_block(nmax, d, kern)
    lib = library()
    for i in range(size):
        if i == 0:
            ac = acq0
        else:
            rc = lib.gpry_kb_sweep(
                kern, int(logexp is not None), N, nmax, d, Q, _ptr(n_dev),
                _ptr(Xq_), _ptr(y), _ptr(Xbuf), _ptr(L), _ptr(p.theta),
                _ptr(p.scal), float(zeta), float(noise_std), _ptr(alive),
                _ptr(swept), _stream())
            _raise_on("kriging_believer_fill (sweep)", rc)
            _count("kriging_believer_fill", family)
            if logexp is None:
                ac = acq_values(y, swept).to(dt).contiguous()
                alive &= torch.isfinite(ac)
            else:
                ac = swept
        rc = lib.gpry_kb_select(
            kern, N, nmax, d, i, int(noise.numel() == nmax), _ptr(Xd_raw),
            _ptr(Xq_), _ptr(y), _ptr(sigma), _ptr(acq0), _ptr(ac),
            _ptr(alive), _ptr(p.theta), _ptr(noise), _ptr(n_dev),
            _ptr(Xbuf), _ptr(L), _ptr(outX), _ptr(outY), _ptr(outS),
            _ptr(outA), _ptr(outC), _stream())
        _raise_on("kriging_believer_fill (select)", rc)
        _count("kriging_believer_fill", family)
    return outX, outY, outS, outA, outC


def ns_slice_chains(family, p, x0, lx0, lstar, chol, nrm, u, lo, hi):
    """
    K6: the constrained slice-sampling chains of one nested-sampling step
    on the gated surrogate ``p`` under the prior box [lo, hi], in one launch
    (see :func:`slice_chains_lockstep` for the arguments; ``lstar`` a 0-d
    tensor that stays on the device).  A surrogate beyond a block's shared
    memory is first copied into global memory in the staged layout, by a
    staging kernel on the same stream.  Returns (x, lx, calls (B,) int64).
    """
    check_family(family)
    if x0.device.type == "cpu":
        return ns_slice_chains_plain(family, p, x0, lx0, lstar, chol, nrm,
                                     u, lo, hi)
    dev = x0.device
    B, d = x0.shape
    R = nrm.shape[0]
    if tuple(nrm.shape) != (R, B, d) or \
            tuple(u.shape) != (R, 1 + NS_SHRINKS, B) or \
            tuple(lx0.shape) != (B,) or tuple(chol.shape) != (d, d):
        raise ValueError(
            f"ns_slice_chains: expected x0 (B, d), lx0 (B,), chol (d, d), "
            f"nrm (R, B, d) and u (R, {1 + NS_SHRINKS}, B); got "
            f"{tuple(x0.shape)}, {tuple(lx0.shape)}, {tuple(chol.shape)}, "
            f"{tuple(nrm.shape)}, {tuple(u.shape)}.")
    if 2 * d > _BLOCK_THREADS:
        raise ValueError(f"ns_slice_chains: d={d} > {_BLOCK_THREADS // 2}.")
    lstar = torch.as_tensor(lstar, dtype=torch.float64, device=dev)
    tensors = dict(x0=x0, lx0=lx0, lstar=lstar.reshape(()),
                   chol=chol.contiguous(), lo=lo.contiguous(),
                   hi=hi.contiguous(), nrm=nrm, u=u, **_gate_tensors(p))
    _check_cuda("ns_slice_chains", dev, **tensors)
    kern = _kern(family, d, dev)
    _check_theta("ns_slice_chains", kern, p.theta)
    x = torch.empty_like(x0)
    lx = torch.empty_like(lx0)
    calls = torch.empty(B, dtype=torch.int64, device=dev)
    if B == 0:
        return x, lx, calls
    lib = library()
    nsv, mode = p.svm.sv.shape[0], int(p.svm.mode)
    # a surrogate too large for shared memory is read from a staged copy
    # in global memory
    nwork = lib.gpry_ns_slice_chains_work(kern, int(p.n), nsv, d, mode)
    work = torch.empty(nwork, dtype=torch.float64, device=dev) \
        if nwork else None
    rc = lib.gpry_ns_slice_chains(
        kern, B, R, int(p.n), nsv, d,
        *(_ptr(tensors[k]) for k in (
            "x0", "lx0", "lstar", "chol", "lo", "hi", "nrm", "u", "X",
            "alpha", "theta", "x_loc", "x_scale", "trust_lo", "trust_hi",
            "sv", "dual", "scal")),
        mode, ctypes.c_void_p(None if work is None else work.data_ptr()),
        _ptr(x), _ptr(lx), _ptr(calls), _stream())
    _raise_on("ns_slice_chains", rc)
    _count("ns_slice_chains", family)
    return x, lx, calls


def predict_meancov(family, theta, X, n, noise_var, L, alpha, Xq):
    """
    K7: the posterior mean and full covariance at ``Xq`` (nq, d), in the
    GP's coordinates (the arguments of :func:`predict_meancov_plain`; ``L``
    row-major).  Two launches: the solve of every query's column of V,
    then the tiled ``K(Xq, Xq) - V^T V``.
    """
    check_family(family)
    if Xq.device.type == "cpu":
        return predict_meancov_plain(family, theta, X, n, noise_var, L,
                                     alpha, Xq)
    dev = Xq.device
    nq, d = Xq.shape
    nmax = X.shape[0]
    if tuple(L.shape) != (nmax, nmax):
        raise ValueError("predict_meancov: L must be (nmax, nmax).")
    _check_cuda("predict_meancov", dev, Xq=Xq, X=X, alpha=alpha, L=L,
                theta=theta)
    kern = _kern(family, d, dev)
    _check_theta("predict_meancov", kern, theta)
    mean = torch.empty(nq, dtype=torch.float64, device=dev)
    cov = torch.empty((nq, nq), dtype=torch.float64, device=dev)
    if nq == 0:
        return mean, cov
    V = torch.empty(nq * int(n), dtype=torch.float64, device=dev)
    lib = library()
    rc = lib.gpry_predict_meancov(
        kern, nq, int(n), nmax, d, _sweep_queries_per_block(nmax, d, kern),
        _ptr(Xq), _ptr(X), _ptr(alpha), _ptr(L), _ptr(theta), _ptr(V),
        _ptr(mean), _ptr(cov), _stream())
    _raise_on("predict_meancov", rc)
    _count("predict_meancov", family, 2)
    return mean, cov


__all__ = ["KERNELS", "LAUNCHES", "KernelBuildError", "SPEC_MAX_NODES",
           "SPEC_MAX_STACK", "build", "encode_spec", "library",
           "reset_launch_counts", "gated_mean", "gated_mean_plain",
           "gated_meanvar_logexp", "gated_meanvar_logexp_plain",
           "masked_kernel_matrix_batched", "masked_kernel_matrix_plain",
           "kriging_believer_fill", "kriging_believer_fill_plain",
           "meanvar_ungated", "meanvar_ungated_plain", "ns_slice_chains",
           "ns_slice_chains_plain", "predict_meancov",
           "predict_meancov_plain", "slice_chains_lockstep"]
