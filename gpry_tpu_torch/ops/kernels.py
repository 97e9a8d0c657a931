"""
Covariance (kernel) functions as plain torch functions of a
log-hyperparameter vector theta.

``family`` is a fast-path string ("rbf", "matern12", "matern32",
"matern52": C() * <family> with ARD length scales) or a hashable kernel
spec tuple (see :func:`spec_cross`), as in gpry_tpu.ops.kernels.  The
fast-path theta layout (log space):

    theta[..., 0]   = log(output_scale**2)     (constant kernel variance)
    theta[..., 1:]  = log(length_scale_i), i = 1..d   (anisotropic)

Every function here is differentiable (torch autograd); they are the plain
versions that the L-BFGS fit and ascent differentiate, and the reference
arithmetic that the CUDA kernels (ops/fused.py) fuse.  A leading batch
dimension on ``theta`` (and on ``X1``/``X2``) is supported throughout:
``theta`` (R, p) gives (R, n, m).
"""

import numpy as np
import torch

KERNEL_FAMILIES = ("rbf", "matern12", "matern32", "matern52")


def check_family(family):
    """Return ``family`` if it is a fast-path string or a well-formed kernel
    spec tuple; raise ``ValueError`` otherwise."""
    if isinstance(family, tuple):
        spec_n_params(family)
        return family
    if family not in KERNEL_FAMILIES:
        raise ValueError(f"Unknown kernel family '{family}'.")
    return family


def make_theta(output_scale, length_scales, dtype=torch.float64,
               device=None):
    """Build a theta vector from natural-space scales."""
    output_scale = torch.as_tensor(output_scale, dtype=dtype, device=device)
    length_scales = torch.atleast_1d(
        torch.as_tensor(length_scales, dtype=dtype, device=device))
    return torch.cat([torch.log(output_scale ** 2)[None],
                      torch.log(length_scales)])


def _scaled_sqdist(X1, X2, length_scales):
    """
    Pairwise squared distances of X1 (..., n, d) vs X2 (..., m, d) in units
    of the length scales (..., d), by per-dimension differences: exact in
    any dtype, unlike the ||a||^2+||b||^2-2ab expansion, which cancels.
    """
    A = X1 / length_scales[..., None, :]
    B = X2 / length_scales[..., None, :]
    diff = A[..., :, None, :] - B[..., None, :, :]
    return torch.sum(diff * diff, dim=-1)


def _safe_sqrt(s):
    """sqrt with a zero-safe gradient at s = 0 (Matern kernels)."""
    pos = s > 0.0
    safe = torch.where(pos, s, torch.ones_like(s))
    return torch.where(pos, torch.sqrt(safe), torch.zeros_like(s))


def k_of_sq(family, sq):
    """Unit-variance correlation k(r) as a function of r^2."""
    if family == "rbf":
        return torch.exp(-0.5 * sq)
    if family == "matern12":
        r = _safe_sqrt(sq)
        return torch.exp(-r)
    if family == "matern32":
        r = _safe_sqrt(3.0 * sq)
        return (1.0 + r) * torch.exp(-r)
    if family == "matern52":
        r = _safe_sqrt(5.0 * sq)
        return (1.0 + r + r * r / 3.0) * torch.exp(-r)
    raise ValueError(f"Unknown kernel family '{family}'.")


def cross_kernel(family, theta, X1, X2):
    """Covariance matrix K(X1, X2) of shape (..., n, m)."""
    check_family(family)
    if isinstance(family, tuple):
        return spec_cross(family, theta, X1, X2)
    variance = torch.exp(theta[..., 0])
    ls = torch.exp(theta[..., 1:])
    sq = _scaled_sqdist(X1, X2, ls)
    return variance[..., None, None] * k_of_sq(family, sq)


def kernel_diag(family, theta, X):
    """diag K(X, X), the same-point covariance: for WhiteKernel members it
    exceeds ``diagonal(cross_kernel(X, X))`` (sklearn semantics).  The
    constant ``exp(theta[0])`` for the fast families."""
    check_family(family)
    if isinstance(family, tuple):
        return spec_diag(family, theta, X)
    variance = torch.exp(theta[..., 0])
    return variance[..., None].expand(
        variance.shape + X.shape[-2:-1]).to(X.dtype)


# ---------------------------------------------------------------------------
# Kernel specs (gpry_tpu/ops/kernels.py:112-312): the full reference kernel
# library as hashable expression trees.
#
#   ("rbf", d) / ("matern12", d) / ("matern32", d) / ("matern52", d)
#       ARD stationary kernel, d log-length-scale params, unit variance
#   ("rq",)          RationalQuadratic: params [log alpha, log length_scale]
#   ("expsine",)     ExpSineSquared: params [log length_scale, log period]
#   ("dotproduct",)  DotProduct: params [log sigma_0]
#   ("white",)       WhiteKernel: params [log noise_level]
#   ("constant",)    ConstantKernel: params [log constant_value]
#   ("sum", a, b) / ("product", a, b)   operators, params concatenated
#   ("pow", a, p)    Exponentiation by the static float p
#
# theta packs depth-first (sklearn's composite-kernel theta), so
# ("product", ("constant",), ("rbf", d)) has the fast-path layout.
# ---------------------------------------------------------------------------

_ARD = ("rbf", "matern12", "matern32", "matern52")
_LEAF_NPARAMS = {"rq": 2, "expsine": 2, "dotproduct": 1, "white": 1,
                 "constant": 1}


def spec_n_params(spec):
    """Number of theta entries a spec consumes (depth-first layout);
    ``ValueError`` for a node that is not a spec node."""
    kind = spec[0] if isinstance(spec, tuple) and spec else None
    if kind in _ARD and len(spec) == 2:
        return int(spec[1])
    if kind in _LEAF_NPARAMS and len(spec) == 1:
        return _LEAF_NPARAMS[kind]
    if kind in ("sum", "product") and len(spec) == 3:
        return spec_n_params(spec[1]) + spec_n_params(spec[2])
    if kind == "pow" and len(spec) == 3:
        float(spec[2])
        return spec_n_params(spec[1])
    raise ValueError(f"Unknown kernel spec node {spec!r}")


def _batch_shape(theta, X1, X2=None):
    shape = torch.broadcast_shapes(theta.shape[:-1], X1.shape[:-2],
                                   () if X2 is None else X2.shape[:-2])
    return shape + X1.shape[-2:-1] + (() if X2 is None else X2.shape[-2:-1])


def spec_cross(spec, theta, X1, X2):
    """K(X1, X2) for a kernel spec, theta (..., p).  WhiteKernel contributes
    zero here (sklearn's ``kernel(X, Y)``); :func:`spec_diag` carries it."""
    kind = spec[0]
    if kind in _ARD:
        sq = _scaled_sqdist(X1, X2, torch.exp(theta))
        return k_of_sq(kind, sq)
    if kind == "rq":
        alpha = torch.exp(theta[..., 0])[..., None, None]
        ls = torch.exp(theta[..., 1:2])
        sq = _scaled_sqdist(X1, X2, ls)     # already in units of ls
        return (1.0 + sq / (2.0 * alpha)) ** (-alpha)
    if kind == "expsine":
        ls = torch.exp(theta[..., 0])[..., None, None]
        period = torch.exp(theta[..., 1])[..., None, None]
        diff = X1[..., :, None, :] - X2[..., None, :, :]
        r = _safe_sqrt(torch.sum(diff * diff, dim=-1))
        s = torch.sin(torch.pi * r / period) / ls
        return torch.exp(-2.0 * s * s)
    if kind == "dotproduct":
        s0 = torch.exp(theta[..., 0])[..., None, None]
        return s0 * s0 + X1 @ X2.transpose(-1, -2)
    if kind == "white":
        return torch.zeros(_batch_shape(theta, X1, X2), dtype=X1.dtype,
                           device=X1.device)
    if kind == "constant":
        return torch.exp(theta[..., 0])[..., None, None].expand(
            _batch_shape(theta, X1, X2))
    if kind in ("sum", "product"):
        n1 = spec_n_params(spec[1])
        k1 = spec_cross(spec[1], theta[..., :n1], X1, X2)
        k2 = spec_cross(spec[2], theta[..., n1:], X1, X2)
        return k1 + k2 if kind == "sum" else k1 * k2
    if kind == "pow":
        return spec_cross(spec[1], theta, X1, X2) ** float(spec[2])
    raise ValueError(f"Unknown kernel spec node {spec!r}")


def spec_diag(spec, theta, X):
    """Same-point variance diag K(X, X) (..., n) for a kernel spec,
    WhiteKernel included (sklearn's ``kernel.diag``)."""
    kind = spec[0]
    if kind in _ARD or kind in ("rq", "expsine"):
        return torch.ones(_batch_shape(theta, X), dtype=X.dtype,
                          device=X.device)
    if kind == "dotproduct":
        s0 = torch.exp(theta[..., 0])[..., None]
        return s0 * s0 + torch.sum(X * X, dim=-1)
    if kind in ("white", "constant"):
        return torch.exp(theta[..., 0])[..., None].expand(
            _batch_shape(theta, X))
    if kind in ("sum", "product"):
        n1 = spec_n_params(spec[1])
        d1 = spec_diag(spec[1], theta[..., :n1], X)
        d2 = spec_diag(spec[2], theta[..., n1:], X)
        return d1 + d2 if kind == "sum" else d1 * d2
    if kind == "pow":
        return spec_diag(spec[1], theta, X) ** float(spec[2])
    raise ValueError(f"Unknown kernel spec node {spec!r}")


# -- spec construction DSL (host numpy, as gpry_tpu.ops.kernels) ------------

_DEFAULT_BOUNDS = (1e-5, 1e5)


def _leaf(node, nparams, values, bounds_list):
    """Helper returning (spec_node, theta0 (log), bounds (log))."""
    theta0 = [float(np.log(v)) for v in values]
    bounds = [(float(np.log(lo)), float(np.log(hi)))
              for (lo, hi) in bounds_list]
    assert len(theta0) == nparams and len(bounds) == nparams
    return node, theta0, bounds


def build_kernel_spec(obj, d):
    """
    Build ``(spec, theta0, theta_bounds)`` from a declarative kernel
    description: a single-key dict ``{Name: {kwargs}}`` with sklearn-style
    names/arguments (RBF, Matern(nu), RationalQuadratic, ExpSineSquared,
    DotProduct, WhiteKernel, ConstantKernel) and operators
    ``{"Sum"|"Product": [k1, k2]}``, ``{"Exponentiation": {"kernel": k,
    "exponent": p}}``.  theta0 / bounds are in log space, depth-first,
    matching sklearn composite-kernel theta layout.
    """
    if isinstance(obj, str):
        obj = {obj: {}}
    if not (isinstance(obj, dict) and len(obj) == 1):
        raise ValueError(f"Cannot build a kernel spec from {obj!r}")
    name = list(obj)[0]
    kw = dict(obj[name] or {}) if isinstance(obj[name], dict) else obj[name]
    lname = name.lower()

    def get_val(key, default):
        return kw.get(key, default) if isinstance(kw, dict) else default

    def get_bounds(key):
        b = kw.get(key, _DEFAULT_BOUNDS) if isinstance(kw, dict) \
            else _DEFAULT_BOUNDS
        return tuple(b)

    if lname in ("rbf", "matern", "matern12", "matern32", "matern52"):
        if lname == "matern":
            nu = float(get_val("nu", 1.5))
            try:
                fam = {0.5: "matern12", 1.5: "matern32",
                       2.5: "matern52"}[nu]
            except KeyError as excpt:
                raise ValueError(
                    "Matern nu must be one of 0.5, 1.5, 2.5.") from excpt
        else:
            fam = lname
        ls = get_val("length_scale", 1.0)
        ls = [float(ls)] * d if np.isscalar(ls) else [float(v) for v in ls]
        if len(ls) != d:
            raise ValueError(f"length_scale needs {d} entries, got {len(ls)}")
        b = get_bounds("length_scale_bounds")
        return _leaf((fam, d), d, ls, [b] * d)
    if lname == "rationalquadratic":
        return _leaf(("rq",), 2,
                     [float(get_val("alpha", 1.0)),
                      float(get_val("length_scale", 1.0))],
                     [get_bounds("alpha_bounds"),
                      get_bounds("length_scale_bounds")])
    if lname == "expsinesquared":
        return _leaf(("expsine",), 2,
                     [float(get_val("length_scale", 1.0)),
                      float(get_val("periodicity", 1.0))],
                     [get_bounds("length_scale_bounds"),
                      get_bounds("periodicity_bounds")])
    if lname == "dotproduct":
        return _leaf(("dotproduct",), 1, [float(get_val("sigma_0", 1.0))],
                     [get_bounds("sigma_0_bounds")])
    if lname == "whitekernel":
        return _leaf(("white",), 1, [float(get_val("noise_level", 1.0))],
                     [get_bounds("noise_level_bounds")])
    if lname == "constantkernel":
        return _leaf(("constant",), 1,
                     [float(get_val("constant_value", 1.0))],
                     [get_bounds("constant_value_bounds")])
    if lname in ("sum", "product"):
        if not (isinstance(kw, (list, tuple)) and len(kw) == 2):
            raise ValueError(f"{name} takes a list of two kernels.")
        s1, t1, b1 = build_kernel_spec(kw[0], d)
        s2, t2, b2 = build_kernel_spec(kw[1], d)
        return (lname, s1, s2), t1 + t2, b1 + b2
    if lname == "exponentiation":
        s1, t1, b1 = build_kernel_spec(kw["kernel"], d)
        return ("pow", s1, float(kw["exponent"])), t1, b1
    raise ValueError(f"Unknown kernel '{name}'")


def theta_bounds_dynamic(theta, d, prior_widths=None, dynamic=False,
                         output_scale_prior=(1e-2, 1e3),
                         length_scale_prior=(1e-3, 1e1)):
    """
    Log-space optimization bounds for theta (host numpy, as in the JAX
    package): static ``output_scale_prior**2`` for the variance; per length
    scale either the static ``length_scale_prior`` or, with
    ``dynamic=True``, ``[w * 1e-3, w * 100]`` for prior width ``w``.
    Returns an array of shape (1 + d, 2).
    """
    theta = np.asarray(theta)
    bounds = [[np.log(output_scale_prior[0] ** 2),
               np.log(output_scale_prior[1] ** 2)]]
    for i in range(d):
        if dynamic:
            if prior_widths is not None:
                ref = float(prior_widths[i])
            else:
                ref = float(np.exp(theta[1 + i]))
            bounds.append([np.log(ref * 1e-3), np.log(ref * 100.0)])
        else:
            bounds.append([np.log(length_scale_prior[0]),
                           np.log(length_scale_prior[1])])
    return np.array(bounds)
