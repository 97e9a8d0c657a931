"""
Native (C++) host components, loaded via ctypes.

The SMO C-SVC trainer (``svc_smo.cpp``, the same source as the JAX
package's) fits the infinities classifier.  It is compiled with ``g++`` at
first use into the package's git-ignored ``_build/`` directory.  There is
no fallback: a failed build raises.
"""

import ctypes
import os
import subprocess
import threading

import numpy as np

_DIR = os.path.dirname(os.path.abspath(__file__))
_SRC = os.path.join(_DIR, "svc_smo.cpp")
_LIB = os.path.join(os.path.dirname(_DIR), "_build", "libsvc_smo.so")
_lib = None
_lock = threading.Lock()


class NativeBuildError(RuntimeError):
    pass


def _load():
    global _lib
    with _lock:
        if _lib is not None:
            return _lib
        if not os.path.exists(_LIB) or \
                os.path.getmtime(_LIB) < os.path.getmtime(_SRC):
            os.makedirs(os.path.dirname(_LIB), exist_ok=True)
            tmp = f"{_LIB}.{os.getpid()}.tmp"
            cmd = ["g++", "-O3", "-fPIC", "-shared", _SRC, "-o", tmp]
            try:
                subprocess.run(cmd, check=True, capture_output=True,
                               text=True)
                os.replace(tmp, _LIB)
            except (subprocess.CalledProcessError, OSError) as excpt:
                raise NativeBuildError(
                    f"Building {os.path.basename(_SRC)} failed: {excpt}"
                ) from excpt
        lib = ctypes.CDLL(_LIB)
        lib.svc_train_rbf.restype = ctypes.c_int
        lib.svc_train_rbf.argtypes = [
            ctypes.POINTER(ctypes.c_double), ctypes.POINTER(ctypes.c_int),
            ctypes.c_int, ctypes.c_int, ctypes.c_double, ctypes.c_double,
            ctypes.c_double, ctypes.c_long,
            ctypes.POINTER(ctypes.c_double), ctypes.POINTER(ctypes.c_double),
        ]
        _lib = lib
        return lib


def available():
    """Whether the SMO trainer builds and loads."""
    try:
        _load()
        return True
    except NativeBuildError:
        return False


def train_rbf_svc(X, y_bool, C=1e7, gamma=None, tol=1e-3, max_iter=0):
    """
    Train a binary RBF C-SVC; returns (support_vectors, signed dual coefs,
    intercept, gamma).  ``y_bool`` True = positive class ("finite").
    ``gamma=None`` uses sklearn's "scale": 1 / (d * X.var()).
    """
    lib = _load()
    X = np.ascontiguousarray(X, dtype=np.float64)
    n, d = X.shape
    y = np.ascontiguousarray(y_bool, dtype=np.int32)
    if gamma is None:
        var = float(X.var())
        gamma = 1.0 / (d * var) if var > 0 else 1.0
    alpha = np.zeros(n, dtype=np.float64)
    b = ctypes.c_double(0.0)
    iters = lib.svc_train_rbf(
        X.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
        y.ctypes.data_as(ctypes.POINTER(ctypes.c_int)),
        n, d, float(C), float(gamma), float(tol), int(max_iter),
        alpha.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
        ctypes.byref(b))
    if iters < 0:
        raise RuntimeError("svc_train_rbf failed (invalid arguments).")
    sv = np.abs(alpha) > 1e-12
    return X[sv], alpha[sv], float(b.value), float(gamma)
