"""
Global numerical configuration for gpry_tpu_torch.

Device policy
-------------
Every tensor the package creates lives on ONE explicit device, chosen by
:func:`set_device` or the environment variable ``GPRY_TPU_TORCH_DEVICE``
("cuda" or "cpu"; default "cuda").  There is no silent fallback: asking for
"cuda" on a machine without a usable CUDA device raises.  The CPU is an
explicit choice (the parity tests make it), and on CPU every hand-written
kernel wrapper runs its plain PyTorch version instead.

Precision policy
----------------
The fit, the factorization and every prediction sweep run in float64
(``FIT_DTYPE``).  The dtype is passed at every tensor creation;
``torch.set_default_dtype`` is never called.
"""

import os

import torch

#: dtype used for GP state, Cholesky factorization, LML optimization and
#: all prediction sweeps.
FIT_DTYPE = torch.float64

_DEVICE = None


def set_device(device):
    """Choose the package device: "cuda" (default) or "cpu".

    Raises ``RuntimeError`` for "cuda" when no CUDA device is usable."""
    global _DEVICE
    dev = torch.device(device)
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"Unsupported device {device!r}: use 'cuda' or "
                         "'cpu'.")
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "gpry_tpu_torch is configured for 'cuda' but torch reports no "
            "usable CUDA device. Call gpry_tpu_torch.config.set_device('cpu')"
            " (or set GPRY_TPU_TORCH_DEVICE=cpu) to run on the CPU.")
    _DEVICE = dev
    return dev


def get_device():
    """The package device (resolved on first use from the environment)."""
    if _DEVICE is None:
        return set_device(os.environ.get("GPRY_TPU_TORCH_DEVICE", "cuda"))
    return _DEVICE


# ---------------------------------------------------------------------------
# Padded-buffer bucketing
# ---------------------------------------------------------------------------
# Identical to the JAX package's ladder, so padded buffers of the two
# packages match element for element.

_MIN_BUCKET = 64


def bucket_size(n: int) -> int:
    """Smallest padded buffer size >= ``n`` from the bucket ladder."""
    b = _MIN_BUCKET
    while b < n:
        # grow by 1.5x, rounded up to a multiple of 64
        b = ((int(b * 1.5) + 63) // 64) * 64
    return b
