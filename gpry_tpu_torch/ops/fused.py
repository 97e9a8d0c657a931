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
  models/gp.py:188 _lml_batch, and as a row panel the blocks of
  ops/linalg.py:82 chol_append; plain version
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
  ops/linalg.py:172 predict_meancov (``predict(return_cov=True)``): K5's
  solve, then the lower tiles of K(Xq, Xq) - V^T V on the FP64 tensor
  cores; plain version :func:`predict_meancov_plain`.
* K8 ``meanstd_grad`` (``csrc/meanstd_grad.cu``) replaces the
  ``jax.vmap(jax.jacfwd(surrogate_mean_std_smooth))`` of models/gp.py:1272
  (``predict(return_mean_grad=, return_std_grad=)``) and serves the
  autograd of ``surrogate_mean_std_smooth`` on the card; plain version
  :func:`meanstd_grad_plain`.
* K9 ``lbfgs_logexp_ascent`` (``csrc/lbfgs_logexp_ascent.cu``) replaces
  acquisition/batch_optimizer.py:78 _optimize_restarts over
  ops/lbfgs.py:168 minimize_lbfgs_bounded: the whole multistart LogExp
  ascent of one believer step in one launch; plain version
  :func:`lbfgs_logexp_ascent_plain`.
* K10 ``lml_value_grad`` (``csrc/lml_value_grad.cu``) replaces
  models/gp.py:189 _lml_batch / :196 _lml_batch_chunked (ops/linalg.py:139
  masked_lml over R theta rows): the log marginal likelihood of every row
  and, in its gradient mode, its gradient in theta, with no R x nmax^2
  tensor; plain version :func:`lml_value_grad_plain`.
* K11 ``lbfgs_lml_fit`` (``csrc/lbfgs_lml_fit.cu``) replaces
  models/gp.py:236 _fit_theta_restarts: the whole multistart bounded
  L-BFGS fit of the hyperparameters in one launch; plain version
  :func:`lbfgs_lml_fit_plain`.
* K12 ``mcmc_chains`` (``csrc/mcmc_chains.cu``) replaces mc/mcmc.py:44
  run_mcmc_device's scanned ``phase`` (:77-121): every step of one phase of
  the adaptive Metropolis ensemble on the gated surrogate, in one launch;
  plain version :func:`mcmc_chains_plain` on plain K1.
* K13 ``ns_step`` (``csrc/ns_step.cu``) replaces the bookkeeping of one
  outer step of mc/nested.py:184 _ns_segment (``outer_cond`` and
  ``outer_body`` outside the slice chains, :211-275); plain version
  :func:`ns_step_plain`.  It never evaluates the covariance, so it has no
  spec instance.
* K14 ``tp_cross_mean`` and ``tp_quad`` (``csrc/tp_predict_partial.cu``)
  replace the ``local`` body of parallel/mesh.py:188-199 _tp_predict_raw:
  one shard's cross covariances and partial mean, then its partial of the
  quadratic form k^T K^-1 k; plain versions :func:`tp_cross_mean_plain`,
  :func:`tp_quad_plain`.  ``tp_quad`` evaluates no covariance, so it has
  no spec instance.

Every kernel but K13 and K14's ``tp_quad`` takes the covariance as a fast
family (C() * RBF / Matern with ARD length scales) or as a kernel spec
tree (ops/kernels.py), which :func:`encode_spec` turns into a post-order
program that the kernels' spec mode interprets (``csrc/common.cuh``).  A
tree beyond ``SPEC_MAX_NODES`` nodes or ``SPEC_MAX_STACK`` stack entries
raises ``ValueError`` for CUDA tensors.

A wrapper runs the plain version only when its input tensor lies on the
CPU.  For a CUDA tensor it launches the kernel or raises: there is no
fallback.  The kernels are float64-only and forward-only; a CUDA tensor
that requires grad is refused.  The gradients in x of the smooth
surrogate are K8's own outputs (models/gp.py wraps it in an autograd
Function); the fit's gradients in theta are K10's (its gradient mode) and
K11's (its own evaluation).

The fourteen sources compile in parallel, one ``nvcc`` per source, and link
into a shared library with a plain C interface
(``_build/libgpry_kernels.so`` inside the package), at first use, and load
over ``ctypes``.  Every launch goes on PyTorch's
current stream and is checked with ``cudaGetLastError``.  The wrappers
that a device mesh's shards call (K2, K6, K11, K14: ``parallel.mesh``)
launch with their tensors' device made torch's current device
(:func:`_launch_on`), on that device's current stream.

``LAUNCHES`` counts, per kernel, the launches the wrappers made (for K4,
both of its kernels: one select per round and one sweep per conditioned
round; for K6 one per call, with the staging kernel that a surrogate too
large for shared memory needs first; for K7 both of its kernels, two per
call; for K12 one per phase, with the same staging kernel when needed;
for K14's ``tp_quad`` both of its kernels, the panels' product and their
sum, two per call).
Launches in spec mode count under ``"<name>/spec"``.
"""

import contextlib
import ctypes
import math
import os
import shutil
import subprocess
import threading
import time
from typing import NamedTuple

import torch

from gpry_tpu_torch.models.classifier import svm_decision
from gpry_tpu_torch.ops.kernels import check_family, cross_kernel, \
    kernel_diag, spec_n_params
from gpry_tpu_torch.ops.lbfgs import minimize_lbfgs_bounded

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_CSRC = os.path.join(_PKG, "csrc")
_BUILD = os.path.join(_PKG, "_build")
_SOURCES = ("gated_mean.cu", "gated_meanvar_logexp.cu",
            "masked_kernel_matrix.cu", "kriging_believer_fill.cu",
            "meanvar_ungated.cu", "ns_slice_chains.cu", "predict_meancov.cu",
            "meanstd_grad.cu", "lbfgs_logexp_ascent.cu", "lml_value_grad.cu",
            "lbfgs_lml_fit.cu", "mcmc_chains.cu", "ns_step.cu",
            "tp_predict_partial.cu")
_HEADERS = ("common.cuh", "lml_blocked.cuh", "subst_blocked.cuh")
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
           "meanvar_ungated", "ns_slice_chains", "predict_meancov",
           "meanstd_grad", "lbfgs_logexp_ascent", "lml_value_grad",
           "lbfgs_lml_fit", "mcmc_chains", "ns_step", "tp_cross_mean",
           "tp_quad")
#: the kernels with no spec instance (they never evaluate the covariance)
NO_SPEC = ("ns_step", "tp_quad")
#: launches per kernel made by the wrappers (never by the plain versions),
#: spec-mode launches under "<name>/spec"
LAUNCHES = {f"{k}{m}": 0 for k in KERNELS for m in ("", "/spec")
            if not (m and k in NO_SPEC)}
#: K10's and K11's launches by the blocks a row or a lane ran on, as
#: "<name> C=<blocks>" (reset with LAUNCHES)
CLUSTERS = {}

#: seconds the last build took (None: the library was already built)
BUILD_SECONDS = None

_lib = None
_lib_lock = threading.Lock()

# The one-warp-per-query sweeps (K2's large-n route, K4's route 1, K5's
# route 1, K7's solve) keep one k vector per query in shared memory; the
# block's query count is the warp count (8) unless nmax forces fewer.
_K2_MAX_Q = 8
_SMEM_DEFAULT = 48 * 1024
_SMEM_MAX = 227 * 1024
# threads of the block-cooperative evaluation (csrc/common.cuh
# GPRY_BLOCK_THREADS; K6's staging): one thread per (point, coordinate) of
# two points prepares an evaluation
_BLOCK_THREADS = 128
#: the largest d of K6 and K13 (the range of the port's nested sampler)
CHAINS_MAX_D = _BLOCK_THREADS // 2

#: the largest d whose gradients K8 and K9 take (csrc/common.cuh
#: GPRY_GRAD_MAX_D; the nested sampler's CHAINS_MAX_D): instances for d <=
#: 32 (a coordinate a lane) and d <= 64 (two coordinates a lane, the
#: gradient sums in two passes of 32)
GRAD_MAX_D = 64

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
    CLUSTERS.clear()


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
        lib.gpry_gated_mean.argtypes = [K] + [I] * 4 + [P] * 11 \
            + [I, P, P]
        lib.gpry_gated_mean.restype = I
        lib.gpry_gated_mean_plan.argtypes = [K] + [I] * 4 + [P, P]
        lib.gpry_gated_mean_plan.restype = I
        lib.gpry_ns_slice_chains.argtypes = [K] + [I] * 5 + [P] * 18 \
            + [I] + [P] * 7
        lib.gpry_ns_slice_chains.restype = I
        lib.gpry_ns_slice_chains_work.argtypes = [K] + [I] * 4
        lib.gpry_ns_slice_chains_work.restype = ctypes.c_size_t
        lib.gpry_gated_meanvar_logexp.argtypes = [K] + [I] * 7 + [P] * 12 \
            + [I, D, D, P, P, P]
        lib.gpry_gated_meanvar_logexp.restype = I
        lib.gpry_gated_meanvar_logexp_plan.argtypes = [K] + [I] * 5 \
            + [P, P, P]
        lib.gpry_gated_meanvar_logexp_plan.restype = I
        lib.gpry_masked_kernel_matrix.argtypes = [K] + [I] * 6 + [P] * 3 \
            + [I, D, P, P]
        lib.gpry_masked_kernel_matrix.restype = I
        lib.gpry_kb_plan.argtypes = [K] + [I] * 5 + [P, P, P]
        lib.gpry_kb_plan.restype = I
        lib.gpry_kb_sweep.argtypes = [K] + [I] * 6 + [P] * 7 \
            + [D, D] + [P] * 5
        lib.gpry_kb_sweep.restype = I
        lib.gpry_kb_select.argtypes = [K] + [I] * 7 + [P] * 20
        lib.gpry_kb_select.restype = I
        lib.gpry_meanvar_ungated.argtypes = [K] + [I] * 5 + [P] * 11
        lib.gpry_meanvar_ungated.restype = I
        lib.gpry_meanvar_ungated_plan.argtypes = [K] + [I] * 5 + [P] * 3
        lib.gpry_meanvar_ungated_plan.restype = I
        lib.gpry_predict_meancov.argtypes = [K] + [I] * 5 + [P] * 9
        lib.gpry_predict_meancov.restype = I
        lib.gpry_predict_meancov_plan.argtypes = [K] + [I] * 5 + [P] * 5
        lib.gpry_predict_meancov_plan.restype = I
        lib.gpry_meanstd_grad.argtypes = [K] + [I] * 4 + [P] * 14
        lib.gpry_meanstd_grad.restype = I
        lib.gpry_meanstd_grad_plan.argtypes = [K] + [I] * 4 + [P] * 3
        lib.gpry_meanstd_grad_plan.restype = I
        lib.gpry_meanstd_grad_work.argtypes = [K] + [I] * 4 + [P]
        lib.gpry_meanstd_grad_work.restype = ctypes.c_size_t
        lib.gpry_lbfgs_logexp_ascent.argtypes = [K] + [I] * 5 + [P] * 10 \
            + [D, D] + [P] * 5
        lib.gpry_lbfgs_logexp_ascent.restype = I
        lib.gpry_lbfgs_logexp_ascent_plan.argtypes = [K, I, I, P, P]
        lib.gpry_lbfgs_logexp_ascent_plan.restype = I
        lib.gpry_lml_value_grad_plan.argtypes = [K] + [I] * 3 + [P] * 4
        lib.gpry_lml_value_grad_plan.restype = I
        lib.gpry_lml_value_grad_cluster.argtypes = [K] + [I] * 5 + [P] * 3
        lib.gpry_lml_value_grad_cluster.restype = I
        lib.gpry_lml_value_grad.argtypes = [K] + [I] * 6 + [P] * 4 \
            + [I, D] + [P] * 4
        lib.gpry_lml_value_grad.restype = I
        lib.gpry_lbfgs_lml_fit_plan.argtypes = [K, I, I, P, P, P]
        lib.gpry_lbfgs_lml_fit_plan.restype = I
        lib.gpry_lbfgs_lml_fit_cluster.argtypes = [K] + [I] * 3 + [P] * 2
        lib.gpry_lbfgs_lml_fit_cluster.restype = I
        lib.gpry_lbfgs_lml_fit.argtypes = [K] + [I] * 5 + [P] * 6 \
            + [I, D] + [P] * 6
        lib.gpry_lbfgs_lml_fit.restype = I
        lib.gpry_mcmc_chains_min_smem.argtypes = [K, I, I]
        lib.gpry_mcmc_chains_min_smem.restype = ctypes.c_size_t
        lib.gpry_mcmc_chains_work.argtypes = [K] + [I] * 5
        lib.gpry_mcmc_chains_work.restype = ctypes.c_size_t
        lib.gpry_mcmc_chains_plan.argtypes = [K] + [I] * 6 + [P, P]
        lib.gpry_mcmc_chains_plan.restype = I
        lib.gpry_mcmc_chains.argtypes = [K] + [I] * 6 + [P] * 18 + [I] \
            + [P] * 9
        lib.gpry_mcmc_chains.restype = I
        lib.gpry_ns_step.argtypes = [I] * 5 + [D, D, I] + [P] * 19
        lib.gpry_ns_step.restype = I
        lib.gpry_tp_cross_mean.argtypes = [K] + [I] * 5 + [P] * 7
        lib.gpry_tp_cross_mean.restype = I
        lib.gpry_tp_quad_panels.argtypes = [I]
        lib.gpry_tp_quad_panels.restype = I
        lib.gpry_tp_quad.argtypes = [I] * 3 + [P] * 6
        lib.gpry_tp_quad.restype = I
        lib.gpry_current_device.argtypes = []
        lib.gpry_current_device.restype = I
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


def _count_cluster(name, family, C):
    key = f"{name}{'/spec' if isinstance(family, tuple) else ''} C={C}"
    CLUSTERS[key] = CLUSTERS.get(key, 0) + 1


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


#: the devices on which the library's CUDA runtime was seen to follow
#: torch's current device
_DEVICES_CHECKED = set()


@contextlib.contextmanager
def _launch_on(device):
    """Make ``device`` torch's current device around a launch, so that the
    launch goes on that device's current stream and every per-device
    setting (shared memory opt-ins, the SM count) is that device's.  The
    library links its own CUDA runtime: the first launch on a device
    checks that its current device is torch's (both follow the driver's
    current context), and raises if not."""
    with torch.cuda.device(device):
        idx = torch.cuda.current_device()
        if idx not in _DEVICES_CHECKED:
            got = library().gpry_current_device()
            if got != idx:
                raise RuntimeError(
                    f"the kernel library's CUDA runtime is on device {got}, "
                    f"torch's on {idx}: a launch would go to the wrong "
                    "card.")
            _DEVICES_CHECKED.add(idx)
        yield


def _ptr(t):
    return ctypes.c_void_p(t.data_ptr())


def _ptr_or_null(t):
    return ctypes.c_void_p(None if t is None else t.data_ptr())


def _check_ints(name, device, dtype, **tensors):
    """Raise unless every ``(tensor, shape)`` is a contiguous ``dtype``
    tensor of that shape on ``device``."""
    for key, (t, shape) in tensors.items():
        if not isinstance(t, torch.Tensor) or t.dtype != dtype or \
                t.device != device or tuple(t.shape) != shape or \
                not t.is_contiguous():
            raise ValueError(f"{name}: '{key}' must be a contiguous {dtype} "
                             f"tensor of shape {shape} on {device}.")


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
                               rel_jitter=0.0, rows=None):
    """
    Plain K3 (differentiable in ``thetas``): the padded training covariance
    ``[[K_valid + (noise + rel_jitter * exp(theta[0])) I, 0], [0, I]]`` for
    every leading index of ``thetas`` (..., p), its diagonal the same-point
    covariance (``kernel_diag``: a WhiteKernel term enters only there), as
    gpry_tpu/ops/linalg.py:34.  ``noise_var`` is a scalar or an (nmax,)
    vector.  ``rows=(r0, r1)`` gives rows r0..r1-1 alone, (..., r1 - r0,
    nmax), each entry the whole matrix's bit for bit (the same operations
    on the same operands; the diagonal and the noise by the global row).
    """
    nmax = X.shape[0]
    m = (torch.arange(nmax, device=X.device) < n).to(X.dtype)
    noise = torch.as_tensor(noise_var, dtype=X.dtype, device=X.device)
    diag = noise.expand(nmax) + \
        rel_jitter * torch.exp(thetas[..., 0])[..., None]
    diag_fill = torch.where(m > 0, diag, torch.ones_like(diag))
    if rows is not None:
        return _masked_kernel_rows(family, thetas, X, m, diag_fill, *rows)
    K = cross_kernel(family, thetas, X, X)
    if isinstance(family, tuple):
        # gpry_tpu/ops/linalg.py:47 restores it for every kernel; a fast
        # family's k(x, x) is its diagonal already, exactly, but adding the
        # zero difference reorders the autograd fit's sums, which moves the
        # fast-family Runner trajectories (ROADMAP.md §C)
        K = K + torch.diag_embed(kernel_diag(family, thetas, X)
                                 - torch.diagonal(K, dim1=-2, dim2=-1))
    K = K * (m[:, None] * m[None, :])
    return K + torch.diag_embed(diag_fill)


def _masked_kernel_rows(family, thetas, X, m, diag_fill, r0, r1):
    """Rows r0..r1-1 of :func:`masked_kernel_matrix_plain`'s matrix: what
    ``diag_embed`` adds there (+0.0 off the diagonal, as it does) added on
    the global diagonal."""
    nmax = X.shape[0]
    if not 0 <= r0 <= r1 <= nmax:
        raise ValueError(f"rows ({r0}, {r1}) outside 0..{nmax}.")
    on = torch.arange(r0, r1, device=X.device)[:, None] == \
        torch.arange(nmax, device=X.device)[None, :]
    zero = torch.zeros((), dtype=X.dtype, device=X.device)
    K = cross_kernel(family, thetas, X[r0:r1], X)
    if isinstance(family, tuple):
        fix = kernel_diag(family, thetas, X)[..., r0:r1] - \
            torch.diagonal(K, offset=r0, dim1=-2, dim2=-1)
        K = K + torch.where(on, fix[..., :, None], zero)
    K = K * (m[r0:r1, None] * m[None, :])
    return K + torch.where(on, diag_fill[..., r0:r1, None], zero)


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


def meanstd_grad_plain(family, p, Xq_raw):
    """
    Plain K8: the raw-space ``(mean, std, d mean/dx, d std/dx)`` of
    ``surrogate_mean_std_smooth`` at ``Xq_raw`` (nq, d), the gradients by
    autograd of :func:`meanvar_ungated_plain` (its arithmetic; the rows are
    independent, so the gradient of a sum is per row).
    """
    with torch.enable_grad():
        Xg = Xq_raw.detach().clone().requires_grad_(True)
        mean, std = meanvar_ungated_plain(family, p, Xg)
        g_mean, = torch.autograd.grad(mean.sum(), Xg, retain_graph=True)
        g_std, = torch.autograd.grad(std.sum(), Xg)
    return mean.detach(), std.detach(), g_mean, g_std


def lbfgs_logexp_ascent_plain(family, p, zeta, noise_std_raw, x0s, lo, hi,
                              maxiter=100, return_iters=False):
    """
    Plain K9: the lock-step L-BFGS (ops/lbfgs.py) over the restarts ``x0s``
    (R, d) in the box [lo, hi], minimizing the negated smooth LogExp
    ``-(2 zeta (min(mean, clip_max) - y_max) + 0.5 log(max(std^2 -
    noise_std_raw^2, 1e-300)))`` of :func:`meanvar_ungated_plain` with its
    autograd gradient.  Returns ``(xs, f, nev)`` per lane (and, with
    ``return_iters``, the iterations, see ops/lbfgs.py).
    """

    def neg_acq(X):
        mu, std = meanvar_ungated_plain(family, p, X)
        var = std * std - noise_std_raw * noise_std_raw
        mu_c = torch.minimum(mu, p.clip_max)
        # clipped from below to keep the objective finite in line searches
        return -(2.0 * zeta * (mu_c - p.y_max)
                 + 0.5 * torch.log(torch.clamp_min(var, 1e-300)))

    return minimize_lbfgs_bounded(neg_acq, x0s, lo, hi, maxiter=maxiter,
                                  tol=1e-8, return_iters=return_iters)


def cholesky_nan(K):
    """Batched Cholesky; lanes that are not positive definite become NaN
    (as JAX's Cholesky) instead of an exception."""
    L, info = torch.linalg.cholesky_ex(K)
    bad = (info != 0)[..., None, None]
    return torch.where(bad, torch.full_like(L, torch.nan), L)


def _lml_of_L(L, y, n):
    """LML of padded factor(s) ``L`` (..., nmax, nmax) of K for ``y``, and
    ``z = L^-1 y``."""
    nmax = L.shape[-1]
    m = (torch.arange(nmax, device=L.device) < n).to(L.dtype)
    z = torch.linalg.solve_triangular(
        L, y.expand(L.shape[:-1])[..., None], upper=False)[..., 0]
    quad = torch.sum(z * z, dim=-1)
    logdet = torch.sum(m * torch.log(torch.diagonal(L, dim1=-2, dim2=-1)),
                       dim=-1)
    return -0.5 * quad - logdet - 0.5 * n * math.log(2.0 * math.pi), z


def lml_of_K(K, y, n):
    """LML of padded covariance(s) ``K`` (..., nmax, nmax) for ``y``."""
    return _lml_of_L(cholesky_nan(K), y, n)[0]


def lml_value_grad_plain(family, thetas, X, y, n, noise_var, rel_jitter=0.0,
                         grad=False):
    """
    Plain K10: the log marginal likelihood of the valid block (the padded
    ``masked_kernel_matrix_plain``, its Cholesky and ``z = L^-1 y``) for
    every row of ``thetas`` (R, p); with ``grad``, ``(lml, dlml/dtheta)``
    by the formula the kernel implements,
    ``1/2 sum_ab (alpha alpha^T - K^-1)_ab dK_ab/dtheta`` with
    ``alpha = L^-T z`` and ``K^-1 = L^-T L^-1``, the contraction with dK/dtheta
    taken as the vector-Jacobian product of the kernel matrix (one reverse
    pass gives all p derivatives).  A row whose K is not positive definite
    gives NaN (value and gradient).
    """
    if not grad:
        with torch.no_grad():
            return lml_of_K(masked_kernel_matrix_plain(
                family, thetas, X, n, noise_var, rel_jitter), y, n)
    with torch.enable_grad():
        th = thetas.detach().requires_grad_(True)
        K = masked_kernel_matrix_plain(family, th, X, n, noise_var,
                                       rel_jitter)
    with torch.no_grad():
        L = cholesky_nan(K.detach())
        lml, z = _lml_of_L(L, y, n)
        alpha = torch.linalg.solve_triangular(L.mT, z[..., None],
                                              upper=True)[..., 0]
        eye = torch.eye(L.shape[-1], dtype=L.dtype, device=L.device)
        M = torch.linalg.solve_triangular(L, eye.expand(L.shape),
                                          upper=False)
        W = alpha[..., :, None] * alpha[..., None, :] - M.mT @ M
    g, = torch.autograd.grad(K, th, grad_outputs=0.5 * W)
    return lml, g


class _NegLML(torch.autograd.Function):
    """``-lml`` of the rows of ``thetas`` with the gradient of
    :func:`lml_value_grad_plain` (the plain K11's objective)."""

    @staticmethod
    def forward(ctx, thetas, family, X, y, n, noise_var, rel_jitter):
        lml, g = lml_value_grad_plain(family, thetas, X, y, n, noise_var,
                                      rel_jitter, grad=True)
        ctx.save_for_backward(g)
        return -lml

    @staticmethod
    def backward(ctx, go):
        g, = ctx.saved_tensors
        return -go[:, None] * g, None, None, None, None, None, None


def lbfgs_lml_fit_plain(family, X, y, n, noise_var, theta0s, lo, hi,
                        maxiter=200, rel_jitter=0.0, return_iters=False):
    """
    Plain K11: the lock-step bounded L-BFGS (ops/lbfgs.py, tol 1e-8) of
    ``-lml`` over the restarts ``theta0s`` (R, p) in the box [lo, hi], with
    :func:`lml_value_grad_plain`'s gradient at the value-and-gradient calls
    and its value at the line-search probes.  Returns ``(thetas, -lml,
    nev)`` per lane (and, with ``return_iters``, the iterations).
    """

    def nll(thetas):
        if thetas.requires_grad:
            return _NegLML.apply(thetas, family, X, y, n, noise_var,
                                 rel_jitter)
        return -lml_value_grad_plain(family, thetas, X, y, n, noise_var,
                                     rel_jitter)

    return minimize_lbfgs_bounded(nll, theta0s, lo, hi, maxiter=maxiter,
                                  tol=1e-8, return_iters=return_iters)


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


def ns_slice_chains_plain(family, p, x0, lx0, lstar, chol, nrm, u, lo, hi,
                          done=None):
    """Plain K6: :func:`slice_chains_lockstep` on the gated surrogate
    mean (plain K1) with -inf outside the prior box [lo, hi].  When the
    stop flag ``done`` (int32 (1,), optional) is set, the chains keep their
    starts and count no call."""
    logl_of = _in_box_logp(family, p, lo, hi)
    if done is not None and bool(done):
        return x0.clone(), lx0.clone(), torch.zeros(
            x0.shape[0], dtype=torch.int64, device=x0.device)
    return slice_chains_lockstep(logl_of, x0, lx0, lstar, chol, nrm, u)


def _in_box_logp(family, p, lo, hi):
    """The gated surrogate mean (plain K1) with -inf outside [lo, hi]."""

    def logp_of(X):
        in_box = torch.all((X >= lo) & (X <= hi), dim=-1)
        return torch.where(in_box, gated_mean_plain(family, p, X),
                           torch.full_like(X[:, 0], -torch.inf))

    return logp_of


def mcmc_chains_plain(logp_of, x, lp_x, log_step, chol, z, u, adapt):
    """
    One phase of the adaptive Metropolis ensemble (gpry_tpu's
    mc/mcmc.py:80-101, the step of ``phase`` scanned at :103-121): ``n``
    lock-step steps of the ``B`` chains at ``x`` (B, d) with log-densities
    ``lp_x``, one per leading index of the draws ``z`` (n, B, d) and ``u``
    (n, B).  Step i proposes ``x + exp(log_step) (z[i] @ chol^T)``, scores
    it with ``logp_of`` ((B, d) -> (B,), -inf outside the prior) and
    accepts where ``log u[i] < lp_prop - lp_x``.  With ``adapt`` (the
    warm-up) ``log_step`` moves by ``0.05 (mean accept - 0.234)`` after
    every step (Robbins-Monro) and the moment sums ``s1`` (d,) and ``s2``
    (d, d) of the visited states accumulate; else they stay 0.  Returns
    ``(x, lp_x, log_step, s1, s2, X (n, B, d), lp (n, B))``, the last two
    the visited states.
    """
    n, B, d = z.shape
    dt, dev = x.dtype, x.device
    s1 = torch.zeros(d, dtype=dt, device=dev)
    s2 = torch.zeros((d, d), dtype=dt, device=dev)
    Xs = torch.empty((n, B, d), dtype=dt, device=dev)
    lps = torch.empty((n, B), dtype=dt, device=dev)
    for i in range(n):
        prop = x + torch.exp(log_step) * (z[i] @ chol.T)
        lp_prop = logp_of(prop)
        accept = torch.log(u[i]) < (lp_prop - lp_x)
        x = torch.where(accept[:, None], prop, x)
        lp_x = torch.where(accept, lp_prop, lp_x)
        if adapt:
            # the acceptance mean as a true division sum / B (JAX's mean;
            # on the card torch's mean, and its division by a host number,
            # multiply by 1 / B instead)
            rate = accept.to(dt).sum() / torch.full((), B, dtype=dt,
                                                    device=dev)
            log_step = log_step + 0.05 * (rate - 0.234)
            s1 = s1 + x.sum(dim=0)
            s2 = s2 + x.T @ x
        Xs[i] = x
        lps[i] = lp_x
    return x, lp_x, log_step, s1, s2, Xs, lps


class NSState(NamedTuple):
    """The device state of one nested-sampling run between its steps,
    which :func:`ns_step` (K13) updates in place; the JAX package's
    ``_ns_segment`` carries the same in its ``while_loop`` state, plus the
    inputs of the next step's slice chains (K6)."""
    live_X: torch.Tensor     # (nlive, d)
    live_logl: torch.Tensor  # (nlive,)
    dead_X: torch.Tensor     # (max_dead_tot, d)
    dead_logl: torch.Tensor  # (max_dead_tot,), -inf beyond k
    logx_prev: torch.Tensor  # (max_dead_tot,) log X before each dead point
    log_shell: torch.Tensor  # (max_dead_tot,) log shell width of each
    count: torch.Tensor      # int64 (4,): k, calls, steps, pending
    done: torch.Tensor       # int32 (1,): the stop flag
    kill: torch.Tensor       # int64 (B,): the live slots of the last kill
    x0: torch.Tensor         # (B, d): the chains' starts
    lx0: torch.Tensor        # (B,)
    lstar: torch.Tensor      # (): the kill threshold
    chol: torch.Tensor       # (d, d): the survivors' covariance factor
    order: torch.Tensor      # int32 (nlive,): the live slots sorted, -1
    #                          first where not known


def ns_step_plain(st, xs, ls, cs, starts, k0_dead, H0, log_prec,
                  select=True):
    """
    One nested-sampling step's bookkeeping on the state ``st``
    (:class:`NSState`), in place, with no host read (gpry_tpu's
    mc/nested.py:211-275, ``outer_cond`` and ``outer_body`` of
    ``_ns_segment`` outside the slice chains):

    1. if a kill is pending (``count[3]``), the previous step's chains
       ``xs`` (B, d), ``ls`` (B,), ``cs`` (B,) int64 replace the killed
       live points, ``k += B``, ``calls += sum(cs)``, ``steps += 1``;
    2. the stop test ``~outer_cond`` into ``done``: the live points' share
       of the evidence (the dead buffer's log-weights summed over all its
       entries, those at or beyond ``k`` as -inf), a plateau of the live
       log-likelihoods once more than ``nlive`` points died after the prior
       phase, and the room for ``B`` more dead points;
    3. with ``select`` and not done: the stable ascending sort of the live
       log-likelihoods, the ``B`` worst written to the dead buffer at
       ``k`` (and their slots to ``kill``), ``lstar`` the largest of them,
       the survivors' mean and covariance (+ 1e-12 I) and its Cholesky
       factor (NaN when not positive definite, as JAX's), and the chains'
       starts ``x0``, ``lx0``: survivor ``starts[b]`` (int64 in [0, nlive
       - B), pre-drawn) in sorted order; the kill is then pending.

    ``order`` is the live set's sorted order as K13 keeps it between
    steps: a select writes it; an apply whose kill is the head of a known
    order writes the new one (K13 merges the new points in); another apply
    marks it unknown (-1 first).  Here it is always sorted afresh.
    """
    nlive, d = st.live_X.shape
    B = st.kill.shape[0]
    max_dead_tot = st.dead_logl.shape[0]
    dt, dev = st.live_X.dtype, st.live_X.device
    cnt = st.count
    # 1. apply the pending kill
    pend = cnt[3] != 0
    st.live_X[st.kill] = torch.where(pend, xs, st.live_X[st.kill])
    st.live_logl[st.kill] = torch.where(pend, ls, st.live_logl[st.kill])
    cnt[0] += B * pend
    cnt[1] += cs.sum() * pend
    cnt[2] += pend.to(torch.int64)
    cnt[3] = 0
    merged = pend & (st.order[0] >= 0) & torch.all(st.order[:B] == st.kill)
    stale = pend & ~merged
    # 2. the stop test
    k = cnt[0]
    idx = torch.arange(max_dead_tot, device=dev)
    logz_d = torch.logsumexp(torch.where(
        idx < k, st.dead_logl + st.logx_prev + st.log_shell,
        torch.full_like(st.dead_logl, -torch.inf)), dim=0)
    logx = -(H0 + (k.to(dt) - k0_dead) / nlive)
    logz_live = torch.logsumexp(st.live_logl, dim=0) - math.log(nlive) + logx
    logz_tot = torch.logaddexp(logz_d, logz_live)
    not_converged = (logz_live - logz_tot) > log_prec
    lmax = torch.max(st.live_logl)
    spread = lmax - torch.min(st.live_logl)
    plateau = (k - k0_dead > nlive) & torch.isfinite(spread) & (
        spread < 1e-9 * torch.clamp_min(torch.abs(lmax), 1.0))
    go = (not_converged | torch.isinf(logz_tot)) & (k + B <= max_dead_tot) \
        & ~plateau
    st.done.copy_((~go).to(torch.int32).reshape(1))
    order = torch.argsort(st.live_logl, stable=True)
    keep = merged | (go & select)
    st.order.copy_(torch.where(keep, order.to(torch.int32), st.order))
    st.order[0] = torch.where(stale & ~keep, -1, st.order[0])
    if not select:
        return
    # 3. the kill and the next chains' inputs
    kill, surv = order[:B], order[B:]
    slots = torch.clamp_max(k + torch.arange(B, device=dev), max_dead_tot - 1)
    st.dead_X[slots] = torch.where(go, st.live_X[kill], st.dead_X[slots])
    st.dead_logl[slots] = torch.where(go, st.live_logl[kill],
                                      st.dead_logl[slots])
    Xs = st.live_X[surv]
    diff = Xs - Xs.mean(dim=0)
    cov = diff.T @ diff / (nlive - B) + 1e-12 * torch.eye(d, dtype=dt,
                                                          device=dev)
    st.kill.copy_(torch.where(go, kill, st.kill))
    st.lstar.copy_(torch.where(go, st.live_logl[order[B - 1]], st.lstar))
    st.chol.copy_(torch.where(go, cholesky_nan(cov), st.chol))
    st.x0.copy_(torch.where(go, Xs[starts], st.x0))
    st.lx0.copy_(torch.where(go, st.live_logl[surv][starts], st.lx0))
    cnt[3] = go.to(torch.int64)


# ---------------------------------------------------------------------------
# wrappers
# ---------------------------------------------------------------------------


def gated_mean(family, p, Xq_raw):
    """K1: gated posterior mean at ``Xq_raw`` (nq, d) for surrogate ``p``
    (geometry: :func:`gated_mean_plan`)."""
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
    rc = library().gpry_gated_mean(
        kern, nq, int(p.n), p.svm.sv.shape[0], d,
        *(_ptr(tensors[k]) for k in (
            "Xq_raw", "X", "alpha", "theta", "x_loc", "x_scale",
            "trust_lo", "trust_hi", "sv", "dual", "scal")),
        int(p.svm.mode), _ptr(out), _stream())
    _raise_on("gated_mean", rc)
    _count("gated_mean", family)
    return out


#: K1 (csrc/gated_mean.cu k1_plan): warps a block at most, the blocks of
#: one wave (2 on each of 132 SMs), the blocks of a launch with clusters
#: (one an SM), rows a split sums at least, rows a chunk takes from one
#: staged tile, the smallest tile, the largest cluster
_K1_WARPS, _K1_WAVE_BLOCKS, _K1_CLUSTER_BLOCKS = 8, 264, 132
_K1_MIN_ROWS = 2
_K1_TILE_ROWS, _K1_MIN_TILE, _K1_MAX_CLUSTER = 32, 8, 16


def gated_mean_plan(nq, n, nsv, d, spec_doubles=0):
    """
    K1's geometry for ``nq`` queries against ``n`` training rows and
    ``nsv`` support vectors (0 unless the SVM is fitted) at dimension
    ``d`` (a spec program of ``spec_doubles``), as csrc/gated_mean.cu
    k1_plan sizes it: ``(qw, sw, cl, tr, dq, smem_bytes)``.  A warp holds
    32 queries; a block ``qw`` query warps and ``qw sw`` warps (a power of
    2 ``sw`` up to 8 warps), a cluster ``cl`` blocks that split the rows
    further: as many splits as one wave of K1_WAVE_BLOCKS blocks holds,
    and at 8 a block a cluster of up to 16 within K1_CLUSTER_BLOCKS blocks
    in all, each split at least K1_MIN_ROWS rows.  (The kernel deals its
    live query warps' rows to its warps in chunks, whatever share of the
    queries the trust box leaves.)  A staged
    tile holds ``tr`` rows (32 a chunk, halved, then ``qw``, then ``sw``,
    until the block fits in shared memory); ``dq`` the register instance
    (d <= 8, 32; 0: the queries read from shared memory, and every spec
    program).  Raises ``ValueError`` where even one warp with 8-row tiles
    does not fit.
    """
    qt = max(1, -(-nq // 32))
    most = max(1, (n + nsv) // _K1_MIN_ROWS)
    sw = 1
    while 2 * sw <= min(most, _K1_WARPS) and -(-qt // min(
            _K1_WARPS // (2 * sw), qt)) <= _K1_WAVE_BLOCKS:
        sw *= 2
    cl = max(1, min(_K1_MAX_CLUSTER, most // _K1_WARPS,
                    _K1_CLUSTER_BLOCKS // qt)) if sw == _K1_WARPS else 1
    qw = max(1, min(_K1_WARPS // sw, qt))
    dq = 0 if spec_doubles else 8 if d <= 8 else 32 if d <= 32 else 0
    tr = _K1_TILE_ROWS * qw * sw
    while True:
        qb = 32 * qw
        smem = 8 * (d + (1 if spec_doubles else 2) * d * qb
                    + 2 * tr * (d + 1) + 2 * qw * sw * qb
                    + (qb + _K1_WARPS) // 2 + spec_doubles)
        if smem <= _SMEM_MAX:
            return qw, sw, cl, tr, dq, smem
        if tr > _K1_MIN_TILE:
            tr //= 2
        elif qw > 1:
            qw //= 2
        elif sw > 1:
            sw //= 2
        else:
            raise ValueError(f"gated_mean: d={d} needs more shared memory "
                             "than a Hopper block has.")


def _sweep_queries_per_block(nmax, d, spec_doubles):
    """Queries per block of the one-warp-per-query sweeps (K2's large-n
    route, K4's route 1, K5's route 1, K7's solve): one per warp, fewer
    when nmax-long k vectors of 8 queries (and the spec program of
    ``spec_doubles``) do not fit in the default 48 KB of shared memory."""
    per_q = 8 * (nmax + 2 * d + 1)
    fixed = 8 * (d + spec_doubles)
    q = min(_K2_MAX_Q, (_SMEM_DEFAULT - fixed) // per_q)
    if q >= 1:
        return q
    if fixed + per_q > _SMEM_MAX:
        raise ValueError(
            f"nmax={nmax} needs more shared memory per query than a Hopper "
            "block has.")
    return 1


#: K2's route 0 (csrc/gated_meanvar_logexp.cu, csrc/subst_blocked.cuh):
#: panel rows, and the batch sizes above which a block takes 16 and 32
#: queries (SUB_Q16_NQ, SUB_Q32_NQ)
_SUB_PB = 16
_SUB_Q16_NQ, _SUB_Q32_NQ = 1056, 4224


def gated_meanvar_logexp_plan(n, nmax, d, nq, spec_doubles=0,
                              aligned=True):
    """
    K2's route for ``nq`` queries against ``n`` valid training rows of
    ``nmax`` at dimension ``d`` (a spec program of ``spec_doubles``), as
    csrc/gated_meanvar_logexp.cu k2_plan sizes it: ``(route, Q,
    smem_bytes)``.  Route 0 solves Q = 8, 16 or 32 queries a block against
    16-row panels of L on the tensor cores (Q by nq, fewer where shared
    memory forces it; at d = 8, Q = 8, n <= 640); it copies L's rows 16
    bytes at a time, so it needs an even ``nmax`` and L's data 16-byte
    aligned (``aligned``: torch's own allocations are).  Route 1, the
    large-n route, a warp a query with Q k vectors of nmax in shared memory
    (_sweep_queries_per_block), up to nmax ~29,000 at d = 8.  Raises
    ``ValueError`` beyond route 1.
    """
    blocked = _sub_plan(n, nmax, nq, d + spec_doubles, 2 * d + 3, aligned)
    if blocked is not None:
        return (0,) + blocked
    q = _sweep_queries_per_block(nmax, d, spec_doubles)
    return 1, q, 8 * (d + 2 * q * d + 3 * q + q * n + spec_doubles)


def _sub_plan(n, nmax, nq, fixed, per_q, aligned):
    """csrc/subst_blocked.cuh sub_plan: ``(Q, smem_bytes)`` of the blocked
    route for nq queries against n rows (the caller's ``fixed`` doubles and
    ``per_q`` doubles a query beside the routine's), or None where even Q =
    8 does not fit or L cannot be copied 16 bytes at a time."""
    if nmax % 2 or not aligned:
        return None
    npad = -(-n // _SUB_PB) * _SUB_PB
    q = 32 if nq > _SUB_Q32_NQ else 16 if nq > _SUB_Q16_NQ else 8
    while q >= 8:
        # V, the two stages, the update's Q x 64 shares (SUB_SPLITS a
        # tile), 1 / L_jj, sumsq and one to align
        sub = npad * (q + 4) + 2 * _SUB_PB * (npad + 4) + q * 64 \
            + _SUB_PB + q + 1
        smem = 8 * (fixed + per_q * q + sub)
        if smem <= _SMEM_MAX:
            return q, smem
        q //= 2
    return None


def kriging_believer_fill_plan(n, nmax, d, nq, spec_doubles=0,
                               aligned=True):
    """
    K4's sweep route for ``nq`` candidates against at most ``n`` rows of
    ``nmax`` at dimension ``d`` (a spec program of ``spec_doubles``), as
    csrc/kriging_believer_fill.cu k4_plan sizes it: ``(route, Q,
    smem_bytes)``.  Route 0 solves Q = 8, 16 or 32 candidates a block on
    csrc/subst_blocked.cuh (Q by nq as K2's, fewer where shared memory
    forces it; an even ``nmax`` and L 16-byte aligned, ``aligned``); route
    1 a warp a candidate with Q k vectors of nmax in shared memory
    (_sweep_queries_per_block).  The round-0 append plans ``nq = 1``.
    Raises ``ValueError`` beyond route 1.
    """
    blocked = _sub_plan(n, nmax, nq, d + spec_doubles, d, aligned)
    if blocked is not None:
        return (0,) + blocked
    q = _sweep_queries_per_block(nmax, d, spec_doubles)
    return 1, q, 8 * (d + q * d + q * nmax + spec_doubles)


def meanvar_ungated_plan(n, nmax, d, nq, spec_doubles=0, aligned=True):
    """
    K5's route for ``nq`` queries against ``n`` valid training rows of
    ``nmax`` at dimension ``d`` (a spec program of ``spec_doubles``), as
    csrc/subst_blocked.cuh sub_ungated_plan sizes it (K7's solve too):
    ``(route, Q, smem_bytes)``.  Route 0 solves Q = 8, 16 or 32 queries a
    block on csrc/subst_blocked.cuh (Q by nq as K2's, fewer where shared
    memory forces it; at d = 8, Q = 8, n <= 640; an even ``nmax`` and L
    16-byte aligned, ``aligned``); route 1 a warp a query with Q k vectors
    in shared memory (_sweep_queries_per_block).  Raises ``ValueError``
    beyond route 1.
    """
    blocked = _sub_plan(n, nmax, nq, d + spec_doubles, d + 1, aligned)
    if blocked is not None:
        return (0,) + blocked
    q = _sweep_queries_per_block(nmax, d, spec_doubles)
    return 1, q, 8 * (d + q * d + q * n + spec_doubles)


#: K7's product (csrc/predict_meancov.cu K7_T, K7_KC): the block's output
#: tile and the training rows a stage (each staged row padded by 4 doubles)
_K7_T, _K7_KC = 32, 32


def predict_meancov_plan(n, nmax, d, nq, spec_doubles=0, aligned=True):
    """
    K7's plan for ``nq`` queries against ``n`` valid training rows of
    ``nmax`` at dimension ``d`` (a spec program of ``spec_doubles``), as
    csrc/predict_meancov.cu k7_plan sizes it: ``(route, Q, smem_solve,
    ldv, tiles, smem_product)``.  The solve takes K5's rule (its layout:
    fixed d + the spec program, d + 1 a query), so K7 and K5 take the
    same route and Q at every nq: route 0 solves Q = 8, 16 or 32 queries
    a block on csrc/subst_blocked.cuh (an even ``nmax`` and L 16-byte
    aligned, ``aligned``), route 1 a warp a query with Q k vectors in
    shared memory (_sweep_queries_per_block).  V is nq rows of ``ldv`` =
    n rounded up to 16 doubles; the product launches the ``tiles`` lower
    32 x 32 tiles of the covariance.  Raises ``ValueError`` beyond route 1
    and where the product's tile points do not fit in shared memory (d
    above 375).
    """
    route, q, smem_a = meanvar_ungated_plan(n, nmax, d, nq, spec_doubles,
                                            aligned)
    nt = -(-nq // _K7_T)
    return route, q, smem_a, -(-n // _SUB_PB) * _SUB_PB, nt * (nt + 1) // 2, \
        _k7_product_smem(d, spec_doubles)


def _k7_product_smem(d, spec_doubles):
    """csrc/predict_meancov.cu meancov_cov_smem: the product's shared
    bytes (two stages of the tile's 2 K7_T rows of V, the tile's points at
    an odd stride, the length scales, the spec program); raises
    ``ValueError`` beyond a block's."""
    smem = 8 * (4 * _K7_T * (_K7_KC + 4) + 2 * _K7_T * (d | 1) + d
                + spec_doubles + 1)
    if smem > _SMEM_MAX:
        raise ValueError(f"predict_meancov: the covariance tiles' points at "
                         f"d={d} need more shared memory than a Hopper "
                         "block has.")
    return smem


def _gp_doubles(n, d, stage_x, spec_doubles, stage_v=1):
    """csrc/common.cuh gpry_gp_doubles: the staged GP of the block routine
    (K8's routes 1 and 2, K9), alpha and the work vector in shared memory
    with ``stage_v``."""
    red = _BLOCK_WARPS * (2 * d + 1) + d + 1
    return 5 * d + 2 + red + stage_v * 2 * n + stage_x * d * n \
        + spec_doubles


def meanstd_grad_plan(n, nmax, d, nq, spec_doubles=0, aligned=True):
    """
    K8's route for ``nq`` queries against ``n`` valid training rows of
    ``nmax`` at dimension ``d`` (a spec program of ``spec_doubles``), as
    csrc/meanstd_grad.cu k8_plan sizes it: ``(route, Q, smem_bytes)``.
    Route 0 is K5's route 0 (the same Q and shared memory) with a blocked
    back substitution and the gradient sweep; route 1 a block of 128
    threads a query (Q = 1), X staged in shared memory while it fits, read
    from global memory beyond; route 2 route 1 with alpha and the work
    vector in global memory too (a workspace of n doubles a block), from
    where route 1's vectors stop fitting (n > 14,284 at d = 32, fast
    family) on, for every n.  Raises ``ValueError`` for d above
    GRAD_MAX_D.
    """
    _check_grad_d("meanstd_grad", d)
    blocked = _sub_plan(n, nmax, nq, d + spec_doubles, d + 1, aligned)
    if blocked is not None:
        return (0,) + blocked
    for route in (1, 2):
        for stage_x in (1, 0):
            smem = 8 * (_gp_doubles(n, d, stage_x, spec_doubles,
                                    int(route == 1)) + d)
            if smem <= _SMEM_MAX:
                return route, 1, smem
    raise ValueError(f"meanstd_grad: d={d} needs more shared memory than "
                     "a Hopper block has.")


def gated_meanvar_logexp(family, p, Xq_raw, logexp=None):
    """K2: gated ``(mean, std)`` at ``Xq_raw``, or with
    ``logexp=(zeta, noise_std)`` the gated LogExp acquisition values
    (routes: :func:`gated_meanvar_logexp_plan`)."""
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
    qchain = _sweep_queries_per_block(nmax, d, _spec_doubles(kern))
    lib = library()
    with _launch_on(Xq_raw.device):
        rc = lib.gpry_gated_meanvar_logexp(
            kern, int(logexp is not None), nq, int(p.n), nmax,
            p.svm.sv.shape[0], d, qchain,
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
    clip, for no-grad sweeps (the convergence audit; routes:
    :func:`meanvar_ungated_plan`)."""
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
    # the plan's Q is the chain's queries a block where it takes route 1
    qchain = meanvar_ungated_plan(int(p.n), nmax, d, nq, _spec_doubles(kern),
                                  p.L.data_ptr() % 16 == 0)[1]
    lib = library()
    rc = lib.gpry_meanvar_ungated(
        kern, nq, int(p.n), nmax, d, qchain,
        *(_ptr(tensors[k]) for k in (
            "Xq_raw", "X", "alpha", "L", "theta", "x_loc", "x_scale",
            "scal")),
        _ptr(mean), _ptr(std), _stream())
    _raise_on("meanvar_ungated", rc)
    _count("meanvar_ungated", family)
    return mean, std


def masked_kernel_matrix_batched(family, thetas, X, n, noise_var,
                                 rel_jitter=0.0, rows=None):
    """K3: padded training covariances (R, nmax, nmax) for ``thetas``
    (R, p); ``noise_var`` a scalar or an (nmax,) vector.  ``rows=(r0,
    r1)``: rows r0..r1-1 of each matrix alone, (R, r1 - r0, nmax)."""
    check_family(family)
    if X.device.type == "cpu":
        return masked_kernel_matrix_plain(family, thetas, X, n, noise_var,
                                          rel_jitter, rows)
    R = thetas.shape[0]
    nmax, d = X.shape
    r0, r1 = (0, nmax) if rows is None else rows
    if not 0 <= r0 <= r1 <= nmax:
        raise ValueError(f"rows ({r0}, {r1}) outside 0..{nmax}.")
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
    out = torch.empty((R, r1 - r0, nmax), dtype=torch.float64,
                      device=X.device)
    if R == 0 or r1 == r0:
        return out
    rc = library().gpry_masked_kernel_matrix(
        kern, R, nmax, int(n), d, r0, r1, _ptr(thetas), _ptr(X),
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
    The sweep's route: :func:`kriging_believer_fill_plan`.
    """
    check_family(family)
    if Xd_raw.device.type == "cpu":
        return kriging_believer_fill_plain(family, p, Xd_raw, y, sigma, acq0,
                                           alive0, size, acq_values)
    return _kb_fill(family, p, Xd_raw, y, sigma, acq0, alive0, size,
                    acq_values, logexp)[:5]


def _kb_fill(family, p, Xd_raw, y, sigma, acq0, alive0, size, acq_values,
             logexp):
    """K4's rounds on the card: the five results of
    :func:`kriging_believer_fill`, then the grown training buffer, factor
    and valid-row count ``(Xbuf, L, n)`` on the device (None when
    ``size`` is 0)."""
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
        return outX, outY, outS, outA, outC, None, None, None
    # working state: updated in place by the kernels, never read on host
    Xq_ = ((Xd_raw - p.x_loc) / p.x_scale).contiguous()
    Xbuf, L = p.X.clone(), p.L.clone()
    alive = alive0.clone()
    n_dev = torch.tensor([p.n], dtype=torch.int32, device=dev)
    swept = torch.empty(N, dtype=dt, device=dev)
    # each alive candidate's solved row and its sum of squares (the sweep
    # writes them, the next select appends the pick's)
    rows = torch.empty((N, nmax), dtype=dt, device=dev) if size > 1 \
        else swept
    rsum = torch.empty(N, dtype=dt, device=dev)
    zeta, noise_std = (0.0, 0.0) if logexp is None else logexp
    qchain = _sweep_queries_per_block(nmax, d, _spec_doubles(kern))
    lib = library()
    for i in range(size):
        # n_dev is at most p.n + i (a round with no pick appends nothing)
        n_hi = int(p.n) + i
        if i == 0:
            ac = acq0
        else:
            rc = lib.gpry_kb_sweep(
                kern, int(logexp is not None), N, n_hi, nmax, d, qchain,
                _ptr(n_dev), _ptr(Xq_), _ptr(y), _ptr(Xbuf), _ptr(L),
                _ptr(p.theta), _ptr(p.scal), float(zeta), float(noise_std),
                _ptr(alive), _ptr(swept), _ptr(rows), _ptr(rsum), _stream())
            _raise_on("kriging_believer_fill (sweep)", rc)
            _count("kriging_believer_fill", family)
            if logexp is None:
                ac = acq_values(y, swept).to(dt).contiguous()
                alive &= torch.isfinite(ac)
            else:
                ac = swept
        rc = lib.gpry_kb_select(
            kern, N, n_hi, nmax, d, i, int(noise.numel() == nmax),
            int(i == 0), _ptr(Xd_raw), _ptr(Xq_), _ptr(y), _ptr(sigma),
            _ptr(acq0), _ptr(ac), _ptr(alive), _ptr(p.theta), _ptr(noise),
            _ptr(n_dev), _ptr(Xbuf), _ptr(L), _ptr(rows), _ptr(rsum),
            _ptr(outX), _ptr(outY), _ptr(outS), _ptr(outA), _ptr(outC),
            _stream())
        _raise_on("kriging_believer_fill (select)", rc)
        _count("kriging_believer_fill", family)
    return outX, outY, outS, outA, outC, Xbuf, L, n_dev


def ns_slice_chains(family, p, x0, lx0, lstar, chol, nrm, u, lo, hi,
                    done=None, return_passes=False):
    """
    K6: the constrained slice-sampling chains of one nested-sampling step
    on the gated surrogate ``p`` under the prior box [lo, hi], in one launch
    (see :func:`slice_chains_lockstep` for the arguments; ``lstar`` a 0-d
    tensor that stays on the device).  ``done`` (int32 (1,), optional) is
    the run's stop flag on the device (K13 writes it): when it is set, the
    kernel returns the starts with no call.  A surrogate beyond a block's
    shared memory is first copied into global memory in the staged layout,
    by a staging kernel on the same stream.  Returns (x, lx, calls (B,)
    int64) and, with ``return_passes`` (CUDA only), the evaluation passes
    each chain made (B,) int64.
    """
    check_family(family)
    if x0.device.type == "cpu":
        if return_passes:
            raise ValueError("ns_slice_chains: passes are the kernel's; "
                             "the plain version makes none.")
        return ns_slice_chains_plain(family, p, x0, lx0, lstar, chol, nrm,
                                     u, lo, hi, done)
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
    if d > CHAINS_MAX_D:
        raise ValueError(f"ns_slice_chains: d={d} > {CHAINS_MAX_D}.")
    lstar = torch.as_tensor(lstar, dtype=torch.float64, device=dev)
    tensors = dict(x0=x0, lx0=lx0, lstar=lstar.reshape(()),
                   chol=chol.contiguous(), lo=lo.contiguous(),
                   hi=hi.contiguous(), nrm=nrm, u=u, **_gate_tensors(p))
    _check_cuda("ns_slice_chains", dev, **tensors)
    if done is not None:
        _check_ints("ns_slice_chains", dev, torch.int32, done=(done, (1,)))
    kern = _kern(family, d, dev)
    _check_theta("ns_slice_chains", kern, p.theta)
    x = torch.empty_like(x0)
    lx = torch.empty_like(lx0)
    calls = torch.empty(B, dtype=torch.int64, device=dev)
    passes = torch.empty(B, dtype=torch.int64, device=dev) \
        if return_passes else None
    out = (x, lx, calls, passes) if return_passes else (x, lx, calls)
    if B == 0:
        return out
    lib = library()
    nsv, mode = p.svm.sv.shape[0], int(p.svm.mode)
    # a surrogate too large for shared memory is read from a staged copy
    # in global memory
    nwork = lib.gpry_ns_slice_chains_work(kern, int(p.n), nsv, d, mode)
    work = torch.empty(nwork, dtype=torch.float64, device=dev) \
        if nwork else None
    with _launch_on(dev):
        rc = lib.gpry_ns_slice_chains(
            kern, B, R, int(p.n), nsv, d,
            *(_ptr(tensors[k]) for k in (
                "x0", "lx0", "lstar", "chol", "lo", "hi", "nrm", "u", "X",
                "alpha", "theta", "x_loc", "x_scale", "trust_lo",
                "trust_hi", "sv", "dual", "scal")),
            mode, _ptr_or_null(done), _ptr_or_null(work), _ptr(x),
            _ptr(lx), _ptr(calls), _ptr_or_null(passes), _stream())
    _raise_on("ns_slice_chains", rc)
    _count("ns_slice_chains", family)
    return out


#: K12's plan (csrc/mcmc_chains.cu): warps a block, the warm-up's cluster
#: (at most), the sampling phase's most blocks, the ring's depth, the most
#: warps a chain
_K12_MAX_WARPS, _K12_MAX_CLUSTER = 16, 16
_K12_SAMPLE_BLOCKS, _K12_RING, _K12_MAX_W = 128, 16, 8


def _staged_doubles(n, nsv, d, spec_doubles):
    """csrc/common.cuh gpry_staged_doubles."""
    return 5 * d + (d + 1) * (n + nsv) + spec_doubles


def _stage_plan(n, nsv, d, spec_doubles, rest):
    """csrc/common.cuh gpry_stage_plan: 0 the surrogate in shared memory,
    1 its support vectors in global memory, 2 X / l as well."""
    if 8 * (_staged_doubles(n, nsv, d, spec_doubles) + rest) <= _SMEM_MAX:
        return 0
    if 8 * (_staged_doubles(n, 0, d, spec_doubles) + rest) <= _SMEM_MAX:
        return 1
    return 2


def mcmc_chains_min_smem(B, d, spec_doubles=0):
    """csrc/mcmc_chains.cu gpry_mcmc_chains_min_smem: K12's range, that of
    the design before this one (one block, a warp a chain): bytes of its
    smallest staging, evaluation scratch, proposal factor, box, three
    d-vectors a warp and the accept flags.  Beyond 227 KB the wrapper
    raises ValueError."""
    return 8 * (_staged_doubles(0, 0, d, spec_doubles) + 4 * d + 18
                + d * d + 2 * d + 3 * d * min(B, 32)
                + (B + 1) // 2)


def mcmc_chains_plan(B, n, nsv_eff, d, spec_doubles=0, adapt=False):
    """
    K12's launch geometry for one phase, as csrc/mcmc_chains.cu k12_plan
    computes it: a dict of ``blocks`` (the grid; the warm-up's cluster),
    ``chains`` (of the fullest block; chain b lives in block b % blocks),
    ``groups`` a block and ``warps`` a chain (enough that a lane sums
    about one of the n + nsv_eff rows, up to 8,
    while the block's chains all run at once in 16 warps), ``ring`` (steps
    of draws read ahead), ``state_smem`` and ``chol_smem`` (the chains'
    states and the proposal factor in shared memory), ``stage``
    (gpry_stage_plan), ``smem`` (bytes) and ``threads``.  The warm-up
    (``adapt``) runs one cluster of the smallest power of two of blocks at
    or above B, at most 16; the sampling phase as many blocks as chains up
    to 128.  None where nothing fits (the wrapper refuses such shapes
    first).
    """
    if adapt:
        blocks = 1
        while blocks < B and blocks < _K12_MAX_CLUSTER:
            blocks *= 2
    else:
        per = -(-B // _K12_SAMPLE_BLOCKS)
        blocks = -(-B // per)
    chains = -(-B // blocks)
    w = 1
    while w < _K12_MAX_W and 32 * w < n + nsv_eff and \
            2 * w * chains <= _K12_MAX_WARPS:
        w *= 2
    g = dict(blocks=blocks, chains=chains,
             groups=min(chains, _K12_MAX_WARPS // w),
             warps=w, ring=_K12_RING, state_smem=1, chol_smem=1)

    def rest():
        threads = 32 * g["groups"] * w
        return (4 * d + 18 + 2 * d + g["chol_smem"] * d * d
                + g["groups"] * (g["ring"] * (d + 1) + 3 * d + 2 * w + 1)
                + g["state_smem"] * chains * (d + 1)
                + ((2 * B + 7) // 8 + threads if adapt else 0))

    base = _staged_doubles(0, 0, d, spec_doubles)
    while 8 * (base + rest()) > _SMEM_MAX:
        if g["ring"] > 1:
            g["ring"] //= 2
        elif g["state_smem"]:
            g["state_smem"] = 0
        elif g["chol_smem"]:
            g["chol_smem"] = 0
        else:
            return None
    r = rest()
    stage = _stage_plan(n, nsv_eff, d, spec_doubles, r)
    g.update(stage=stage, threads=32 * g["groups"] * w,
             smem=8 * (_staged_doubles(0 if stage == 2 else n,
                                       0 if stage >= 1 else nsv_eff, d,
                                       spec_doubles) + r))
    return g


def mcmc_chains(family, p, x, lp_x, log_step, chol, z, u, lo, hi, adapt):
    """
    K12: one phase of the adaptive Metropolis ensemble on the gated
    surrogate ``p`` under the prior box [lo, hi] (see
    :func:`mcmc_chains_plain` for the arguments and results; ``log_step``
    a 0-d tensor), every step in one launch, the chains spread over blocks
    (:func:`mcmc_chains_plan`): the sampling phase a block a chain (up to
    128 blocks), the warm-up one thread-block cluster of up to 16 blocks
    that couples the chains' step size every step.  A surrogate beyond a
    block's shared memory is read from a staged copy in global memory, as
    K6 reads it.  Raises ValueError beyond the range of the design before
    this one (its proposal factor and warps' scratch in one block's shared
    memory: d above 125 at 32 or more chains, 163 at one).
    """
    check_family(family)
    if x.device.type == "cpu":
        return mcmc_chains_plain(_in_box_logp(family, p, lo, hi), x, lp_x,
                                 log_step, chol, z, u, adapt)
    dev = x.device
    B, d = x.shape
    n = z.shape[0]
    if tuple(z.shape) != (n, B, d) or tuple(u.shape) != (n, B) or \
            tuple(lp_x.shape) != (B,) or tuple(chol.shape) != (d, d) or \
            tuple(log_step.shape) != ():
        raise ValueError(
            f"mcmc_chains: expected x (B, d), lp_x (B,), log_step (), chol "
            f"(d, d), z (n, B, d) and u (n, B); got {tuple(x.shape)}, "
            f"{tuple(lp_x.shape)}, {tuple(log_step.shape)}, "
            f"{tuple(chol.shape)}, {tuple(z.shape)}, {tuple(u.shape)}.")
    tensors = dict(x=x, lp_x=lp_x, log_step=log_step, chol=chol.contiguous(),
                   lo=lo.contiguous(), hi=hi.contiguous(), z=z, u=u,
                   **_gate_tensors(p))
    _check_cuda("mcmc_chains", dev, **tensors)
    kern = _kern(family, d, dev)
    _check_theta("mcmc_chains", kern, p.theta)
    f64 = dict(dtype=torch.float64, device=dev)
    x_out, lp_out = torch.empty_like(x), torch.empty_like(lp_x)
    step_out = log_step.clone()
    s1, s2 = torch.zeros(d, **f64), torch.zeros((d, d), **f64)
    Xs, lps = torch.empty((n, B, d), **f64), torch.empty((n, B), **f64)
    if n == 0 or B == 0:
        x_out.copy_(x)
        lp_out.copy_(lp_x)
        return x_out, lp_out, step_out, s1, s2, Xs, lps
    lib = library()
    if lib.gpry_mcmc_chains_min_smem(kern, B, d) > _SMEM_MAX:
        raise ValueError(f"mcmc_chains: {B} chains at d={d} need more than "
                         "a block's shared memory for the proposal factor "
                         "and the warps' scratch.")
    nsv, mode = p.svm.sv.shape[0], int(p.svm.mode)
    nwork = lib.gpry_mcmc_chains_work(kern, B, int(p.n), nsv, d, mode)
    work = torch.empty(nwork, **f64) if nwork else None
    rc = lib.gpry_mcmc_chains(
        kern, B, n, int(p.n), nsv, d, int(bool(adapt)),
        *(_ptr(tensors[k]) for k in (
            "x", "lp_x", "log_step", "chol", "lo", "hi", "z", "u", "X",
            "alpha", "theta", "x_loc", "x_scale", "trust_lo", "trust_hi",
            "sv", "dual", "scal")),
        mode, _ptr_or_null(work), _ptr(x_out), _ptr(lp_out), _ptr(step_out),
        _ptr(s1), _ptr(s2), _ptr(Xs), _ptr(lps), _stream())
    _raise_on("mcmc_chains", rc)
    _count("mcmc_chains", family)
    return x_out, lp_out, step_out, s1, s2, Xs, lps


#: the largest live set K13 sorts in shared memory
NS_STEP_MAX_NLIVE = 4096


def ns_step(st, xs, ls, cs, starts, k0_dead, H0, log_prec, select=True):
    """
    K13: one nested-sampling step's bookkeeping on the state ``st``
    (:class:`NSState`, updated in place; see :func:`ns_step_plain`), in
    one launch (a cluster of 8 blocks, which share the stop test's passes
    over the dead buffer) with no host read: the pending kill applied, the
    stop flag, and with ``select`` the next kill and the chains' inputs;
    the live order the state keeps spares the full sort (the new points
    are merged in).  ``k0_dead``, ``H0`` and ``log_prec`` are host
    numbers.
    Raises ValueError above ``NS_STEP_MAX_NLIVE`` live points or d >
    ``CHAINS_MAX_D``.
    """
    dev = st.live_X.device
    if dev.type == "cpu":
        return ns_step_plain(st, xs, ls, cs, starts, k0_dead, H0, log_prec,
                             select)
    nlive, d = st.live_X.shape
    B = st.kill.shape[0]
    max_dead_tot = st.dead_logl.shape[0]
    if nlive > NS_STEP_MAX_NLIVE:
        raise ValueError(f"ns_step: nlive={nlive} > NS_STEP_MAX_NLIVE="
                         f"{NS_STEP_MAX_NLIVE}, the most K13 sorts in "
                         "shared memory.")
    if d > CHAINS_MAX_D:
        raise ValueError(f"ns_step: d={d} > {CHAINS_MAX_D}.")
    if not 0 < B < nlive:
        raise ValueError(f"ns_step: the kill batch {B} must be in (0, "
                         f"{nlive}).")
    shapes = dict(live_logl=(nlive,), dead_X=(max_dead_tot, d),
                  logx_prev=(max_dead_tot,), log_shell=(max_dead_tot,),
                  x0=(B, d), lx0=(B,), lstar=(), chol=(d, d))
    tensors = dict(live_X=st.live_X, xs=xs, ls=ls,
                   **{k: getattr(st, k) for k in shapes})
    for key, shape in dict(shapes, xs=(B, d), ls=(B,)).items():
        if tuple(tensors[key].shape) != shape:
            raise ValueError(f"ns_step: '{key}' must be {shape}, got "
                             f"{tuple(tensors[key].shape)}.")
    _check_cuda("ns_step", dev, **tensors)
    _check_ints("ns_step", dev, torch.int64, count=(st.count, (4,)),
                kill=(st.kill, (B,)), cs=(cs, (B,)), starts=(starts, (B,)))
    _check_ints("ns_step", dev, torch.int32, done=(st.done, (1,)),
                order=(st.order, (nlive,)))
    rc = library().gpry_ns_step(
        nlive, B, d, max_dead_tot, int(k0_dead), float(H0),
        float(log_prec), int(bool(select)),
        *(_ptr(t) for t in (
            st.live_X, st.live_logl, st.dead_X, st.dead_logl, st.logx_prev,
            st.log_shell, st.count, st.done, st.kill, st.x0, st.lx0,
            st.lstar, st.chol, st.order, xs, ls, cs, starts)), _stream())
    _raise_on("ns_step", rc)
    LAUNCHES["ns_step"] += 1


def predict_meancov(family, theta, X, n, noise_var, L, alpha, Xq):
    """
    K7: the posterior mean and full covariance at ``Xq`` (nq, d), in the
    GP's coordinates (the arguments of :func:`predict_meancov_plain`; ``L``
    row-major).  Two launches: the solve of every query's column of V (K5's
    route and Q; the diagonal of the covariance from the solve's own sums,
    so equal to K5's sigma^2 bit for bit), then ``K(Xq, Xq) - V^T V`` on
    the lower tiles, on the FP64 tensor cores, each stored at its mirror
    too (plan: :func:`predict_meancov_plan`).  Raises ``ValueError`` where
    that plan does.
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
    sd = _spec_doubles(kern)
    _k7_product_smem(d, sd)
    # V: nq rows of n rounded up to whole 16-double panels
    V = torch.empty(nq * (-(-int(n) // _SUB_PB) * _SUB_PB),
                    dtype=torch.float64, device=dev)
    lib = library()
    rc = lib.gpry_predict_meancov(
        kern, nq, int(n), nmax, d, _sweep_queries_per_block(nmax, d, sd),
        _ptr(Xq), _ptr(X), _ptr(alpha), _ptr(L), _ptr(theta), _ptr(V),
        _ptr(mean), _ptr(cov), _stream())
    _raise_on("predict_meancov", rc)
    _count("predict_meancov", family, 2)
    return mean, cov


# K9's and K11's shared-memory routes, as csrc/lbfgs_logexp_ascent.cu
# k9_route and csrc/lbfgs_lml_fit.cu k11_route size them (the card tests
# hold the two to the same numbers)
_LANE_M = 8              # L-BFGS history pairs (K9_M, K11_M)
_STATE_DOUBLES = 8       # K9State, K11State
_BLOCK_WARPS = _BLOCK_THREADS // 32
_K9_P, _K9_TLD = 32, 33
_K9_STAGES = {1: 4, 2: 2, 3: 4}  # k9_stages: the streamed routes' ring
# the shared LML evaluation (csrc/lml_blocked.cuh LML_NB, LML_WARPS,
# GPRY_LML_PCHUNK, LML_STAGE) and K10's route-1 edge for a spec program
# (K10_ROUTE1_N)
_LML_NB, _LML_WARPS, _LML_PCHUNK, _LML_STAGE = 16, 8, 16, 4096
_K10_ROUTE1_N = 160
# route 1's largest cluster (LML_MAX_CLUSTER)
LML_MAX_CLUSTER = 16


def _tri(n):
    return n * (n + 1) // 2


def _spec_doubles(kern):
    """Shared doubles of a staged spec program (csrc/common.cuh
    gpry_spec_doubles)."""
    return 2 * kern.nodes + 2 * kern.ntheta if kern.nodes > 0 else 0


def _lane_doubles(v):
    """A lane's L-BFGS state over v coordinates (k9_lane_doubles with ten
    v-vectors, k11_lane_doubles with twelve)."""
    return 2 * _LANE_M * v + _LANE_M + _STATE_DOUBLES


def lbfgs_logexp_ascent_plan(n, d, spec_doubles=0):
    """
    K9's route for ``n`` training rows at dimension ``d`` (a spec program
    of ``spec_doubles``): ``(route, stage_x, smem_bytes)``.  Route 0 stages
    L packed (n (n + 1) / 2 doubles) in shared memory, with X when that fits
    too; routes 1 and 2 stream L through a ring of 4 or 2 tiles of 32 x 32
    and keep only the staged GP's n-vectors in shared memory; route 3
    streams L through 4 tiles and keeps the n-vectors in global memory (n
    doubles of workspace a lane), so it takes every n.  At d = 8 (fast
    family) route 0 takes n <= 235 (X staged up to n = 227), route 1 n <=
    12,180, route 2 n <= 13,236 (12,756 at d = 32, 12,596 at d = 40), route
    3 every n beyond.  Raises ``ValueError`` for d above GRAD_MAX_D.
    """
    _check_grad_d("lbfgs_logexp_ascent", d)
    for route in (0, 1, 2, 3):
        sub = 2 * n + _tri(n) if route == 0 else \
            _BLOCK_WARPS * _K9_P + _K9_STAGES[route] * _K9_P * _K9_TLD
        for stage_x in (1, 0):
            gp = _gp_doubles(n, d, stage_x, spec_doubles, int(route < 3))
            smem = 8 * (gp + 10 * d + _lane_doubles(d) + sub)
            if smem <= _SMEM_MAX:
                return route, stage_x, smem
    raise ValueError(f"lbfgs_logexp_ascent: d={d} needs more shared memory "
                     "than a Hopper block has.")


def _lml_fits(n, d, spec_doubles, extra, route):
    """``(stage_x, smem_bytes)`` of the shared LML evaluation on ``route``
    (csrc/lml_blocked.cuh lml_route_fits: X staged where it fits), with
    ``extra`` shared doubles of the kernel's own, or None."""
    base = extra + _LML_NB + _LML_WARPS * _LML_PCHUNK + 1 + d \
        + spec_doubles + n
    mat = _tri(n + 1) if route == 0 else _LML_STAGE
    for stage_x in (1, 0):
        smem = 8 * (base + mat + stage_x * d * n)
        if smem <= _SMEM_MAX:
            return stage_x, smem
    return None


def _lml_work(n, d, route):
    """Global doubles of one block's workspace: X / ls transposed and, on
    route 1, the packed bordered triangle (lml_work_doubles)."""
    return d * n + (_tri(n + 1) if route == 1 else 0)


def lbfgs_lml_fit_plan(n, d, p, spec_doubles=0):
    """
    K11's route for ``n`` training rows at dimension ``d``, ``p`` theta
    entries (a spec program of ``spec_doubles``): ``(route, stage_x,
    smem_bytes, work_doubles)``, the workspace per lane in global memory.
    Route 0 keeps the packed bordered triangle ((n + 1) (n + 2) / 2
    doubles) in shared memory; route 1 keeps it in the lane's global
    workspace and stages the tensor cores' operands through a shared buffer
    of 4,096 doubles in each block of the lane's cluster
    (:func:`lbfgs_lml_fit_cluster`); either stages X (d n doubles) in
    shared memory too where that fits.  At d = 8 (fast family, p = 9)
    route 0 takes n <= 236 (X staged up to n = 229), route 1 n <= 24,539
    (23,843 at d = 32).  Raises ``ValueError`` beyond route 1.
    """
    extra = 12 * p + _lane_doubles(p)
    for route in (0, 1):
        fits = _lml_fits(n, d, spec_doubles, extra, route)
        if fits:
            return (route, *fits, _lml_work(n, d, route))
    raise ValueError(f"lbfgs_lml_fit: n={n} at d={d} (p={p}) exceeds the "
                     "kernel's global route (shared memory).")


def lml_value_grad_plan(n, d, spec_doubles=0):
    """
    K10's route for ``n`` training rows at dimension ``d`` (a spec program
    of ``spec_doubles``): ``(route, stage_x, smem_bytes, work_doubles)``,
    the workspace per row in flight in global memory.  The evaluation is
    K11's without a lane's state: route 0 keeps the packed bordered
    triangle in shared memory, route 1 in the row's global workspace with
    the operands staged through 4,096 doubles a block, so that two blocks
    share an SM (and a row may take a cluster of blocks:
    :func:`lml_value_grad_cluster`).  The fast families take route 0
    wherever it fits (n <= 237 at d = 8), a spec program route 1 from n =
    160 on; route 1 reaches n = 24,807 at d = 8 (fast family), past K11's
    range at every d.  Raises ``ValueError`` beyond route 1.
    """
    route = next((r for r in (0, 1)
                  if _lml_fits(n, d, spec_doubles, 0, r)), None)
    if route is None:
        raise ValueError(f"lml_value_grad: n={n} at d={d} exceeds the "
                         "kernel's global route (shared memory).")
    # a spec program's route 1 from _K10_ROUTE1_N rows on (where route 1's
    # fixed buffer is smaller than route 0's triangle)
    if route == 0 and spec_doubles > 0 and n >= _K10_ROUTE1_N:
        route = 1
    return (route, *_lml_fits(n, d, spec_doubles, 0, route),
            _lml_work(n, d, route))


def lml_cluster(rows, sms, active):
    """
    The thread-block cluster of K10's and K11's route 1 for ``rows`` lanes
    or rows in flight on ``sms`` SMs (csrc/lml_blocked.cuh lml_cluster),
    with ``active`` mapping each C of 1, 2, 4, 8, 16 to the clusters of C
    blocks the card runs at once (as the library queries it,
    ``cudaOccupancyMaxActiveClusters``): of the powers of two C up to
    ``LML_MAX_CLUSTER`` with ``rows * C <= sms`` (and 1), the one that
    gives a lane the most blocks per wave of resident clusters, ``C /
    ceil(rows / active[C])``, the larger C on a tie.  On an H100 (7
    clusters of 16 resident, 15 of 8) 1-8 lanes take 16.
    """
    top = 1
    while top < LML_MAX_CLUSTER and rows * top * 2 <= sms:
        top *= 2
    best, waves = 1, 0
    c = top
    while c >= 1:
        if active[c] >= 1:
            w = -(-rows // active[c])
            if waves == 0 or c * waves > best * w:
                best, waves = c, w
        c //= 2
    return best


def lbfgs_lml_fit_cluster(R, n, d, p, sms, active, spec_doubles=0):
    """K11's cluster for ``R`` lanes at ``n`` rows (csrc/lbfgs_lml_fit.cu
    gpry_lbfgs_lml_fit_cluster): ``lml_cluster(R, sms, active)`` on route
    1, 1 on route 0.  Raises ``ValueError`` beyond route 1."""
    route = lbfgs_lml_fit_plan(n, d, p, spec_doubles)[0]
    return lml_cluster(R, sms, active) if route == 1 else 1


def lml_value_grad_cluster(R, n, d, sms, per_sm, active, spec_doubles=0):
    """
    K10's rows in flight and cluster ``(F, C)`` for ``R`` rows at ``n``
    (csrc/lml_value_grad.cu gpry_lml_value_grad_cluster), with ``per_sm``
    blocks of the instance on each of ``sms`` SMs: F = min(R, per_sm *
    sms, the rows whose workspaces fit ``LML_WORK_BUDGET``), at least 1;
    then on route 1 C = ``lml_cluster(F, sms, active)``, on route 0 1.  So
    a screen of 2,049 rows keeps a row a block up to the budget's n (n =
    4,480: F = 212, C = 1) and a few rows at large n take 16 blocks each.
    Raises ``ValueError`` beyond route 1.
    """
    route, _, _, work = lml_value_grad_plan(n, d, spec_doubles)
    F = max(1, min(R, per_sm * sms, LML_WORK_BUDGET // (8 * max(1, work))))
    return F, (lml_cluster(F, sms, active) if route == 1 else 1)


def check_lbfgs_range(family, d, n, ascent=True):
    """
    Raise ``ValueError`` unless K11 (the fit) and, with ``ascent``, K9 (the
    LogExp ascent) and K8 (its gradients on the generic route) take ``n``
    training rows at dimension ``d`` for ``family`` (their planners), so
    that a run whose budget is ``n`` points is refused before it starts
    rather than when its training set grows past them.  With the default
    budget 70 d^1.5 that passes every d <= 48 and refuses d = 49-64 with
    K11's message (its range) and d > 64 with K8's and K9's.
    """
    if isinstance(family, tuple):
        p = spec_n_params(family)
        spec = 2 * len(encode_spec(family, d)[0]) + 2 * p
    else:
        check_family(family)
        p, spec = 1 + d, 0
    lbfgs_lml_fit_plan(int(n), d, p, spec)
    if ascent:
        lbfgs_logexp_ascent_plan(int(n), d, spec)
        # K8's route 2 takes every n and its d limit is K9's, so this
        # refuses nothing that K9's plan passes; it keeps K8's own limits
        # checked here should they ever part from K9's
        meanstd_grad_plan(int(n), int(n), d, 1, spec)


def _check_grad_d(name, d):
    if d > GRAD_MAX_D:
        raise ValueError(f"{name}: d={d} > {GRAD_MAX_D}, the most the "
                         "kernel's per-thread gradient sums take.")


def meanstd_grad(family, p, Xq_raw):
    """
    K8: the raw-space ``(mean, std, d mean/dx, d std/dx)`` of the ungated,
    unclipped surrogate at ``Xq_raw`` (nq, d) in one launch (see
    :func:`meanstd_grad_plain`; routes: :func:`meanstd_grad_plan`).
    """
    check_family(family)
    if Xq_raw.device.type == "cpu":
        return meanstd_grad_plain(family, p, Xq_raw)
    dev = Xq_raw.device
    tensors = dict(Xq_raw=Xq_raw, X=p.X, alpha=p.alpha, L=p.L, theta=p.theta,
                   x_loc=p.x_loc, x_scale=p.x_scale, scal=p.scal)
    _check_cuda("meanstd_grad", dev, **tensors)
    nq, d = Xq_raw.shape
    _check_grad_d("meanstd_grad", d)
    nmax = p.X.shape[0]
    kern = _kern(family, d, dev)
    _check_theta("meanstd_grad", kern, p.theta)
    # raises ValueError beyond the kernel's routes, before any launch
    route = meanstd_grad_plan(int(p.n), nmax, d, nq, _spec_doubles(kern),
                              aligned=p.L.data_ptr() % 16 == 0)[0]
    mean = torch.empty(nq, dtype=torch.float64, device=dev)
    std = torch.empty_like(mean)
    g_mean = torch.empty((nq, d), dtype=torch.float64, device=dev)
    g_std = torch.empty_like(g_mean)
    if nq == 0:
        return mean, std, g_mean, g_std
    lib = library()
    L_ptr = _ptr(p.L)
    Q, smem = ctypes.c_int(), ctypes.c_size_t()
    got = lib.gpry_meanstd_grad_plan(kern, nq, int(p.n), nmax, d, L_ptr,
                                     ctypes.byref(Q), ctypes.byref(smem))
    if got != route:
        raise RuntimeError(f"meanstd_grad: the library plans route {got} "
                           f"where the host plans {route}.")
    # route 2's workspace: n doubles a block, the library's own grid
    work = torch.empty(lib.gpry_meanstd_grad_work(kern, nq, int(p.n), nmax,
                                                  d, L_ptr),
                       dtype=torch.float64, device=dev)
    rc = lib.gpry_meanstd_grad(
        kern, nq, int(p.n), nmax, d,
        *(_ptr(tensors[k]) for k in (
            "Xq_raw", "X", "alpha", "L", "theta", "x_loc", "x_scale",
            "scal")),
        _ptr(mean), _ptr(std), _ptr(g_mean), _ptr(g_std),
        _ptr_or_null(work if work.numel() else None), _stream())
    _raise_on("meanstd_grad", rc)
    _count("meanstd_grad", family)
    return mean, std, g_mean, g_std


def lbfgs_logexp_ascent(family, p, zeta, noise_std_raw, x0s, lo, hi,
                        maxiter=100):
    """
    K9: the multistart bounded L-BFGS ascent of the smooth LogExp from
    ``x0s`` (R, d) in the box [lo, hi] (see
    :func:`lbfgs_logexp_ascent_plain`), one block per lane, every line
    search inside the launch.  ``zeta`` and ``noise_std_raw`` are host
    floats.  Returns ``(xs, f, nev)``.
    """
    check_family(family)
    if x0s.device.type == "cpu":
        return lbfgs_logexp_ascent_plain(family, p, zeta, noise_std_raw, x0s,
                                         lo, hi, maxiter)
    dev = x0s.device
    R, d = x0s.shape
    if tuple(lo.shape) != (d,) or tuple(hi.shape) != (d,):
        raise ValueError(f"lbfgs_logexp_ascent: lo and hi must be ({d},).")
    if R > 65535:
        raise ValueError("lbfgs_logexp_ascent: R > 65535.")
    tensors = dict(x0s=x0s, lo=lo.contiguous(), hi=hi.contiguous(), X=p.X,
                   alpha=p.alpha, L=p.L, theta=p.theta, x_loc=p.x_loc,
                   x_scale=p.x_scale, scal=p.scal)
    _check_cuda("lbfgs_logexp_ascent", dev, **tensors)
    _check_grad_d("lbfgs_logexp_ascent", d)
    nmax = p.X.shape[0]
    kern = _kern(family, d, dev)
    _check_theta("lbfgs_logexp_ascent", kern, p.theta)
    plan = lbfgs_logexp_ascent_plan(int(p.n), d, _spec_doubles(kern))
    xs = torch.empty_like(x0s)
    f = torch.empty(R, dtype=torch.float64, device=dev)
    nev = torch.empty(R, dtype=torch.int64, device=dev)
    if R == 0:
        return xs, f, nev
    lib = library()
    sx, smem = ctypes.c_int(), ctypes.c_size_t()
    got = lib.gpry_lbfgs_logexp_ascent_plan(kern, int(p.n), d,
                                            ctypes.byref(sx),
                                            ctypes.byref(smem))
    if (got, sx.value, smem.value) != plan:
        raise RuntimeError(f"lbfgs_logexp_ascent: the library plans "
                           f"{(got, sx.value, smem.value)} where the host "
                           f"plans {plan}.")
    # route 3 keeps each lane's k vector in n doubles of global memory
    work = torch.empty(R * int(p.n), dtype=torch.float64, device=dev) \
        if plan[0] == 3 else None
    # the constants as the plain version rounds them: 2.0 * zeta and
    # noise_std_raw * noise_std_raw on the host
    zeta, noise_std_raw = float(zeta), float(noise_std_raw)
    rc = lib.gpry_lbfgs_logexp_ascent(
        kern, R, int(p.n), nmax, d, int(maxiter),
        *(_ptr(tensors[k]) for k in (
            "x0s", "lo", "hi", "X", "alpha", "L", "theta", "x_loc",
            "x_scale", "scal")),
        2.0 * zeta, noise_std_raw * noise_std_raw, _ptr_or_null(work),
        _ptr(xs), _ptr(f), _ptr(nev), _stream())
    _raise_on("lbfgs_logexp_ascent", rc)
    _count("lbfgs_logexp_ascent", family)
    return xs, f, nev


#: the most global memory K10's rows in flight take together (bytes;
#: csrc/lml_value_grad.cu LML_WORK_BUDGET): a fifth of the H100's 80 GB
LML_WORK_BUDGET = 16 << 30


def _sms(dev):
    return torch.cuda.get_device_properties(dev).multi_processor_count


def _actives():
    """The library's out-array of the clusters of 1, 2, 4, 8 and 16 blocks
    the card runs at once."""
    return (ctypes.c_int * 5)()


def _active_of(act):
    """``{C: clusters of C blocks the card runs at once}`` of ``act``."""
    return {1 << i: act[i] for i in range(5)}


def _check_cluster(name, got, want, C, active):
    """Raise unless the library's cluster plan ``got`` is the host's
    ``want`` and the card runs at least one cluster of its ``C`` blocks."""
    if got != want:
        raise RuntimeError(f"{name}: the library plans {got} where the host "
                           f"plans {want}.")
    if active[C] < 1:
        raise RuntimeError(f"{name}: the card cannot schedule the plan "
                           f"{got} (no cluster of its blocks fits).")


def _lml_args(name, family, thetas, X, y, n, noise_var):
    """Check K10's / K11's common arguments; returns (kern, noise (1,) or
    (nmax,), d)."""
    dev = thetas.device
    nmax, d = X.shape
    noise = torch.as_tensor(noise_var, dtype=torch.float64,
                            device=dev).reshape(-1).contiguous()
    if noise.numel() not in (1, nmax):
        raise ValueError(f"{name}: noise_var must be a scalar or an "
                         "(nmax,) vector.")
    if tuple(y.shape) != (nmax,) or not 0 <= int(n) <= nmax:
        raise ValueError(f"{name}: y must be ({nmax},) and 0 <= n <= {nmax}.")
    _check_cuda(name, dev, thetas=thetas, X=X, y=y, noise=noise)
    kern = _kern(family, d, dev)
    _check_theta(name, kern, thetas)
    return kern, noise, d


def lml_value_grad(family, thetas, X, y, n, noise_var, rel_jitter=0.0,
                   grad=False):
    """
    K10: the log marginal likelihood of the valid block for every row of
    ``thetas`` (R, p) on the padded data ``X`` (nmax, d), ``y`` (nmax,)
    with ``n`` valid rows and ``noise_var`` a scalar or an (nmax,) vector
    (see :func:`lml_value_grad_plain`); with ``grad``, ``(lml, dlml /
    dtheta)``.  One launch; F rows in flight, each on a cluster of C
    blocks with its own workspace, loop over the rows
    (:func:`lml_value_grad_plan`, :func:`lml_value_grad_cluster`).
    Raises ``ValueError`` past the last route, before any launch, and
    ``RuntimeError`` if the card cannot schedule the plan's cluster.
    """
    check_family(family)
    if thetas.device.type == "cpu":
        return lml_value_grad_plain(family, thetas, X, y, n, noise_var,
                                    rel_jitter, grad)
    dev = thetas.device
    kern, noise, d = _lml_args("lml_value_grad", family, thetas, X, y, n,
                               noise_var)
    R, p = thetas.shape
    route = lml_value_grad_plan(int(n), d, _spec_doubles(kern))[0]
    lml = torch.empty(R, dtype=torch.float64, device=dev)
    g = torch.empty((R, p), dtype=torch.float64, device=dev) if grad \
        else None
    if R == 0:
        return (lml, g) if grad else lml
    lib = library()
    # the workspace, the blocks an SM holds and the cluster: the library's
    # own plan, held to the host's
    sx, smem, per_row, per_sm = ctypes.c_int(), ctypes.c_size_t(), \
        ctypes.c_size_t(), ctypes.c_int()
    got = lib.gpry_lml_value_grad_plan(
        kern, int(n), d, int(grad), ctypes.byref(sx),
        ctypes.byref(smem), ctypes.byref(per_row), ctypes.byref(per_sm))
    if got != route or per_sm.value < 1:
        raise RuntimeError(f"lml_value_grad: the library plans route {got} "
                           f"({per_sm.value} blocks an SM) where the host "
                           f"plans {route}.")
    F, C, act = ctypes.c_int(), ctypes.c_int(), _actives()
    got = lib.gpry_lml_value_grad_cluster(
        kern, R, int(n), d, int(grad), per_sm.value, ctypes.byref(F),
        ctypes.byref(C), act)
    active = _active_of(act)
    _check_cluster("lml_value_grad", (got, F.value, C.value),
                   (route, *lml_value_grad_cluster(
                       R, int(n), d, _sms(dev), per_sm.value, active,
                       _spec_doubles(kern))), C.value, active)
    work = torch.empty(F.value * per_row.value, dtype=torch.float64,
                       device=dev)
    rc = lib.gpry_lml_value_grad(
        kern, R, int(n), d, int(grad), F, C, _ptr(thetas), _ptr(X),
        _ptr(y), _ptr(noise), int(noise.numel() > 1), float(rel_jitter),
        _ptr(work), _ptr(lml), ctypes.c_void_p(g.data_ptr() if grad
                                                else None), _stream())
    _raise_on("lml_value_grad", rc)
    _count("lml_value_grad", family)
    _count_cluster("lml_value_grad", family, C.value)
    return (lml, g) if grad else lml


def lbfgs_lml_fit(family, X, y, n, noise_var, theta0s, lo, hi, maxiter=200,
                  rel_jitter=0.0, return_iters=False):
    """
    K11: the multistart bounded L-BFGS fit of ``-lml`` from ``theta0s``
    (R, p) in the box [lo, hi] (see :func:`lbfgs_lml_fit_plain`), one block
    per lane on route 0 and one thread-block cluster per lane on route 1
    (:func:`lbfgs_lml_fit_cluster`), every line search inside the launch.
    Returns ``(thetas, -lml, nev)`` (and, with ``return_iters``, the
    iterations).  Raises ``RuntimeError`` if the card cannot schedule the
    plan's cluster.
    """
    check_family(family)
    if theta0s.device.type == "cpu":
        return lbfgs_lml_fit_plain(family, X, y, n, noise_var, theta0s, lo,
                                   hi, maxiter, rel_jitter, return_iters)
    dev = theta0s.device
    kern, noise, d = _lml_args("lbfgs_lml_fit", family, theta0s, X, y, n,
                               noise_var)
    R, p = theta0s.shape
    lo, hi = lo.contiguous(), hi.contiguous()
    if tuple(lo.shape) != (p,) or tuple(hi.shape) != (p,):
        raise ValueError(f"lbfgs_lml_fit: lo and hi must be ({p},).")
    if R > 65535:
        raise ValueError("lbfgs_lml_fit: R > 65535.")
    _check_cuda("lbfgs_lml_fit", dev, lo=lo, hi=hi)
    thetas = torch.empty_like(theta0s)
    f = torch.empty(R, dtype=torch.float64, device=dev)
    nev = torch.empty(R, dtype=torch.int64, device=dev)
    iters = torch.empty(R, dtype=torch.int64, device=dev)
    route = lbfgs_lml_fit_plan(int(n), d, p, _spec_doubles(kern))[0]
    if R > 0:
        lib = library()
        # the workspace as the kernel strides it: the library's own plan
        sx, smem, per_lane = ctypes.c_int(), ctypes.c_size_t(), \
            ctypes.c_size_t()
        if lib.gpry_lbfgs_lml_fit_plan(kern, int(n), d, ctypes.byref(sx),
                                       ctypes.byref(smem),
                                       ctypes.byref(per_lane)) < 0:
            raise ValueError(f"lbfgs_lml_fit: n={n} at d={d} exceeds the "
                             "kernel's global route (shared memory).")
        work = torch.empty(R * per_lane.value, dtype=torch.float64,
                           device=dev)
        with _launch_on(dev):
            C, act = ctypes.c_int(), _actives()
            got = lib.gpry_lbfgs_lml_fit_cluster(
                kern, R, int(n), d, ctypes.byref(C), act)
            active = _active_of(act)
            _check_cluster("lbfgs_lml_fit", (got, C.value),
                           (route, lbfgs_lml_fit_cluster(
                               R, int(n), d, p, _sms(dev), active,
                               _spec_doubles(kern))), C.value, active)
            rc = lib.gpry_lbfgs_lml_fit(
                kern, R, C, int(n), d, int(maxiter), _ptr(theta0s),
                _ptr(lo), _ptr(hi), _ptr(X), _ptr(y), _ptr(noise),
                int(noise.numel() > 1), float(rel_jitter), _ptr(work),
                _ptr(thetas), _ptr(f), _ptr(nev), _ptr(iters), _stream())
        _raise_on("lbfgs_lml_fit", rc)
        _count("lbfgs_lml_fit", family)
        _count_cluster("lbfgs_lml_fit", family, C.value)
    return (thetas, f, nev, iters) if return_iters else (thetas, f, nev)


# ---------------------------------------------------------------------------
# K14: one shard's partial of the training-axis (TP) sharded predict
# ---------------------------------------------------------------------------


def tp_cross_mean_plain(family, theta, X_shard, alpha_shard, Xq_, row0, n):
    """The ``local`` body of gpry_tpu/parallel/mesh.py:188-193 for one
    shard of the training rows (``X_shard`` (nloc, d) from row ``row0``,
    its ``alpha_shard``; ``n`` valid rows in all): ``(K_shard (nloc, nq),
    mean_part (nq,))`` with ``K_shard[i, q] = [row0 + i < n] k(x_i,
    xq_q)`` in the cross form and ``mean_part = K_shard^T alpha_shard``."""
    nloc = X_shard.shape[0]
    m = (row0 + torch.arange(nloc, device=X_shard.device) < n).to(
        X_shard.dtype)
    K = cross_kernel(family, theta, X_shard, Xq_) * m[:, None]
    return K, K.T @ alpha_shard


def tp_quad_plain(M_shard, k_full, K_shard):
    """gpry_tpu/parallel/mesh.py:196-197: ``sum_i K_shard[i, q] (M_shard
    k_full)[i, q]`` (nq,), M_shard the shard's rows of K^-1 (nloc, nmax)
    and k_full every shard's K_shard gathered (nmax, nq)."""
    return torch.sum(K_shard * (M_shard @ k_full), dim=0)


def tp_cross_mean(family, theta, X_shard, alpha_shard, Xq_, row0, n):
    """K14 (a): :func:`tp_cross_mean_plain` in one launch on the shard's
    own device (a block a query, the row sum in a fixed order)."""
    check_family(family)
    if X_shard.device.type == "cpu":
        return tp_cross_mean_plain(family, theta, X_shard, alpha_shard, Xq_,
                                   row0, n)
    dev = X_shard.device
    nloc, d = X_shard.shape
    nq = Xq_.shape[0]
    if tuple(alpha_shard.shape) != (nloc,) or Xq_.ndim != 2 or \
            Xq_.shape[1] != d:
        raise ValueError(f"tp_cross_mean: expected X_shard (nloc, d), "
                         f"alpha_shard (nloc,) and Xq_ (nq, d); got "
                         f"{tuple(X_shard.shape)}, "
                         f"{tuple(alpha_shard.shape)}, {tuple(Xq_.shape)}.")
    _check_cuda("tp_cross_mean", dev, theta=theta, X_shard=X_shard,
                alpha_shard=alpha_shard, Xq_=Xq_)
    kern = _kern(family, d, dev)
    _check_theta("tp_cross_mean", kern, theta)
    K = torch.empty((nloc, nq), dtype=torch.float64, device=dev)
    mean = torch.empty(nq, dtype=torch.float64, device=dev)
    if nq == 0:
        return K, mean
    lib = library()
    with _launch_on(dev):
        rc = lib.gpry_tp_cross_mean(
            kern, nloc, nq, d, int(row0), int(n), _ptr(X_shard),
            _ptr(alpha_shard), _ptr(Xq_), _ptr(theta), _ptr(K), _ptr(mean),
            _stream())
    _raise_on("tp_cross_mean", rc)
    _count("tp_cross_mean", family)
    return K, mean


def tp_quad(M_shard, k_full, K_shard):
    """K14 (b): :func:`tp_quad_plain` on the shard's own device: a block a
    panel of M_shard's rows, the product and the column sum fused (only
    the panels' partials reach global memory), then their sum per query
    in panel order; two launches."""
    if M_shard.device.type == "cpu":
        return tp_quad_plain(M_shard, k_full, K_shard)
    dev = M_shard.device
    nloc, nmax = M_shard.shape
    nq = k_full.shape[1] if k_full.ndim == 2 else -1
    if tuple(k_full.shape) != (nmax, nq) or \
            tuple(K_shard.shape) != (nloc, nq):
        raise ValueError(f"tp_quad: expected M_shard (nloc, nmax), k_full "
                         f"(nmax, nq) and K_shard (nloc, nq); got "
                         f"{tuple(M_shard.shape)}, {tuple(k_full.shape)}, "
                         f"{tuple(K_shard.shape)}.")
    _check_cuda("tp_quad", dev, M_shard=M_shard, k_full=k_full,
                K_shard=K_shard)
    quad = torch.empty(nq, dtype=torch.float64, device=dev)
    if nq == 0:
        return quad
    lib = library()
    work = torch.empty((lib.gpry_tp_quad_panels(nloc), nq),
                       dtype=torch.float64, device=dev)
    with _launch_on(dev):
        rc = lib.gpry_tp_quad(nloc, nmax, nq, _ptr(M_shard), _ptr(k_full),
                              _ptr(K_shard), _ptr(work), _ptr(quad),
                              _stream())
    _raise_on("tp_quad", rc)
    LAUNCHES["tp_quad"] += 2
    return quad


__all__ = ["KERNELS", "LAUNCHES", "CLUSTERS", "KernelBuildError",
           "SPEC_MAX_NODES", "SPEC_MAX_STACK", "build", "encode_spec",
           "library",
           "reset_launch_counts", "gated_mean", "gated_mean_plain",
           "gated_meanvar_logexp", "gated_meanvar_logexp_plain",
           "masked_kernel_matrix_batched", "masked_kernel_matrix_plain",
           "kriging_believer_fill", "kriging_believer_fill_plain",
           "meanvar_ungated", "meanvar_ungated_plain", "ns_slice_chains",
           "ns_slice_chains_plain", "predict_meancov",
           "predict_meancov_plain", "slice_chains_lockstep",
           "meanstd_grad", "meanstd_grad_plain", "lbfgs_logexp_ascent",
           "lbfgs_logexp_ascent_plain", "GRAD_MAX_D", "cholesky_nan",
           "lml_of_K", "lml_value_grad", "lml_value_grad_plain",
           "lbfgs_lml_fit", "lbfgs_lml_fit_plain", "mcmc_chains",
           "mcmc_chains_plain", "NSState", "ns_step", "ns_step_plain",
           "NS_STEP_MAX_NLIVE", "CHAINS_MAX_D", "lbfgs_logexp_ascent_plan",
           "lbfgs_lml_fit_plan", "lml_value_grad_plan", "LML_MAX_CLUSTER",
           "LML_WORK_BUDGET", "lml_cluster", "lbfgs_lml_fit_cluster",
           "lml_value_grad_cluster",
           "check_lbfgs_range", "tp_cross_mean", "tp_cross_mean_plain",
           "tp_quad", "tp_quad_plain"]
