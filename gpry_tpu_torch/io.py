"""
Checkpoints (port of gpry_tpu/io.py).

A checkpoint is a directory of six pickles, the JAX package's layout:
``tru.pkl`` (the Truth's re-init dict), ``gpr.pkl``, ``acq.pkl``,
``con.pkl``, ``opt.pkl`` and ``pro.pkl``.  They are written with the
standard ``pickle`` (the card's machine has no ``dill``).

Torch objects never reach the stream.  The pickler's ``reducer_override``
sees every object the six pickles reach (the GPR, its preprocessors, its
classifier, the acquisition's state, frozen dataclasses and named tuples
included) and writes a tensor as a host numpy array behind the tag
``_host_tensor``, a ``torch.device`` as ``_host_device`` and a
``torch.dtype`` by name.  On load each tensor comes back, bit for bit, on
``config.get_device()``: a checkpoint written on the card loads on a
CPU-only machine and the reverse.  The stored Cholesky factor and alpha
come back as they were: nothing is refactorized on load, so a resumed run
continues the same trajectory.  The live objects are never modified while
dumping, so a dump that raises leaves them as they were.

A truth whose callable the standard pickle cannot carry (a lambda, a
closure) is stored without it: ``tru.pkl`` then holds the rest of the
re-init dict and the flag ``loglike_pickled = False``, the other five files
are written as usual, and a resume needs the callable again
(``Runner(loglike=...)``, or ``read_checkpoint(path, loglike=...)``).  So
does a Cobaya model whose info holds such a callable (``model_pickled =
False``): a resume needs the model again.
"""

import os
import pickle

import numpy as np
import torch

from gpry_tpu_torch import config

_CHECKPOINT_FILES = ("tru.pkl", "gpr.pkl", "acq.pkl", "con.pkl", "opt.pkl",
                     "pro.pkl")


def create_path(path):
    """Create the checkpoint directory."""
    os.makedirs(path, exist_ok=True)
    return path


def clear_checkpoint(path):
    """
    Delete any of the six checkpoint files (and their ``*.tmp`` siblings)
    at ``path``.  Used by ``load_checkpoint="overwrite"``: saves write
    ``tru.pkl`` only when absent, so a stale truth of an earlier run must
    go first.
    """
    if path is None:
        return
    for fname in _CHECKPOINT_FILES:
        for suffix in ("", ".tmp"):
            try:
                os.remove(os.path.join(path, fname + suffix))
            except FileNotFoundError:
                pass


def check_checkpoint(path=None):
    """Boolean array: which of the six checkpoint files exist at
    ``path``."""
    if path is None:
        return np.full(len(_CHECKPOINT_FILES), False)
    return np.array([os.path.exists(os.path.join(path, f))
                     for f in _CHECKPOINT_FILES])


# ---------------------------------------------------------------------------
# torch <-> host
# ---------------------------------------------------------------------------


def _host_tensor(array):
    """A stored tensor, back on the package device."""
    return torch.from_numpy(array).to(config.get_device())


def _host_device():
    """A stored ``torch.device``: the package device of the loader."""
    return config.get_device()


def _host_dtype(name):
    return getattr(torch, name)


class _HostPickler(pickle.Pickler):
    """A pickler that writes torch tensors, devices and dtypes as host
    values behind the tags above, and refuses any other torch object."""

    def reducer_override(self, obj):
        if isinstance(obj, type):
            return NotImplemented
        if isinstance(obj, torch.Tensor):
            return _host_tensor, (obj.detach().cpu().numpy(),)
        if isinstance(obj, torch.device):
            return _host_device, ()
        if isinstance(obj, torch.dtype):
            return _host_dtype, (str(obj).rsplit(".", 1)[-1],)
        if type(obj).__module__.split(".", 1)[0] == "torch":
            raise pickle.PicklingError(
                f"a checkpoint cannot hold a {type(obj).__qualname__}: "
                "only torch tensors, devices and dtypes are stored (as host "
                "values).")
        return NotImplemented


def _truth_dict(truth):
    """``tru.pkl``'s object: the truth's re-init dict, without its callable
    when the standard pickle cannot carry it."""
    if not hasattr(truth, "as_dict"):
        return truth
    out = dict(truth.as_dict())
    # the callable: a Truth's loglike, or a TruthCobaya's model info (which
    # holds its likelihoods' callables)
    key = "loglike" if "loglike" in out else "model"
    if key not in out:
        return out
    try:
        pickle.dumps(out[key])
    except (pickle.PicklingError, AttributeError, TypeError) as excpt:
        out[key] = None
        out[f"{key}_pickled"] = False
        out[f"{key}_error"] = f"{type(excpt).__name__}: {excpt}"
    else:
        out[f"{key}_pickled"] = True
    return out


def save_checkpoint(path, truth, gpr, acquisition, convergence, options,
                    progress, update_truth=True):
    """
    Save the six checkpoint objects (gpry_tpu/io.py:83).  With
    ``update_truth=False``, ``tru.pkl`` is written only if absent (the
    truth does not change during a run).

    Two-phase commit: every object is pickled to a ``*.tmp`` sibling
    first, then all are renamed into place with ``os.replace``.  A dump
    that raises removes the tmp files and leaves the previous generation
    whole; a crash can leave at most a ``*.tmp`` behind, never a truncated
    checkpoint file.
    """
    if path is None:
        return
    create_path(path)
    objs = {"gpr.pkl": gpr, "acq.pkl": acquisition, "con.pkl": convergence,
            "opt.pkl": options, "pro.pkl": progress}
    if update_truth or not os.path.exists(os.path.join(path, "tru.pkl")):
        objs["tru.pkl"] = _truth_dict(truth)
    tmp_written = []
    try:
        for fname, obj in objs.items():
            tmp = os.path.join(path, fname + ".tmp")
            with open(tmp, "wb") as f:
                _HostPickler(f, protocol=pickle.HIGHEST_PROTOCOL).dump(obj)
            tmp_written.append((tmp, os.path.join(path, fname)))
    except BaseException:
        for fname in objs:
            try:
                os.remove(os.path.join(path, fname + ".tmp"))
            except OSError:
                pass
        raise
    for tmp, final in tmp_written:
        os.replace(tmp, final)


def _load(full):
    with open(full, "rb") as f:
        return pickle.load(f)


def _truth_of(truth_dict, path, loglike=None):
    """The Truth of a stored re-init dict (``loglike`` supplies a callable
    the checkpoint could not hold)."""
    if not isinstance(truth_dict, dict):
        return truth_dict
    if truth_dict.get("model_pickled") is False:
        # a Cobaya model whose info pickle could not carry: the caller
        # passes the model again
        from gpry_tpu_torch.truth import TruthCobaya
        if loglike is None or not hasattr(loglike, "logposterior"):
            raise ValueError(
                f"The checkpoint at {path} holds no Cobaya model: its info "
                "could not be pickled when it was written "
                f"({truth_dict.get('model_error')}). Pass the model again to "
                "resume: Runner(model, checkpoint=..., "
                "load_checkpoint='resume') or read_checkpoint(path, "
                "loglike=model).")
        return TruthCobaya(loglike)
    if truth_dict.get("model") is not None:
        # TruthCobaya: rebuild the Cobaya Model from its info dict
        from cobaya.model import get_model
        from gpry_tpu_torch.truth import TruthCobaya
        return TruthCobaya(get_model(truth_dict["model"]))
    if "loglike" not in truth_dict:
        return truth_dict
    kwargs = dict(truth_dict)
    pickled = kwargs.pop("loglike_pickled", True)
    error = kwargs.pop("loglike_error", None)
    if not pickled:
        if loglike is None:
            raise ValueError(
                f"The checkpoint at {path} holds no log-likelihood: its "
                f"callable could not be pickled when it was written "
                f"({error}); a lambda or a closure cannot be. Pass it again "
                "to resume: Runner(loglike=..., checkpoint=..., "
                "load_checkpoint='resume') or read_checkpoint(path, "
                "loglike=...).")
        kwargs["loglike"] = loglike
    from gpry_tpu_torch.truth import Truth
    return Truth(**kwargs)


def read_checkpoint(path, truth=None, loglike=None):
    """
    Load the six checkpoint objects; returns
    ``(truth, gpr, acquisition, convergence, options, progress)``
    (gpry_tpu/io.py:139).  ``truth`` replaces the stored one; ``loglike``
    is the callable of a truth stored without it (it is ignored when the
    stored truth has its own).
    """
    truth_dict, gpr, acq, con, opt, pro = [
        _load(os.path.join(path, f)) for f in _CHECKPOINT_FILES]
    if truth is None:
        truth = _truth_of(truth_dict, path, loglike=loglike)
    return truth, gpr, acq, con, opt, pro


def ensure_gpr(gpr):
    """A GPR instance, or the GPR of the checkpoint at the path ``gpr``
    (gpry_tpu/io.py:168)."""
    if isinstance(gpr, (str, os.PathLike)):
        full = os.path.join(gpr, "gpr.pkl")
        if not os.path.exists(full):
            raise ValueError(f"No GPR checkpoint found at {gpr}.")
        return _load(full)
    return gpr
