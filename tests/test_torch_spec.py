"""
Composite kernels (the kernel spec trees of gpry_tpu/ops/kernels.py) and
``predict(return_cov=True)`` in gpry_tpu_torch, against gpry_tpu on the
CPU in float64, with the same numpy-seeded inputs handed to both packages:

* ``build_kernel_spec``, ``cross_kernel`` / ``kernel_diag`` for every node
  kind and operator (the cases of tests/test_kernels.py), batched theta;
* the post-order program the CUDA kernels interpret (``encode_spec``),
  evaluated here in torch with the kernels' arithmetic, and its limits;
* the plain versions of K1, K2 and K4 on a spec surrogate (K3, K5 and K6
  have spec cases in tests/test_torch_ops.py, test_torch_audit.py and
  test_torch_ns_slice.py);
* K7's plain version and ``predict(return_cov=True)``; the LML;
* one Runner at d = 2 with C() * RBF + WhiteKernel; at d = 8 (the run of
  chip_smoke.py's path (f), marked slow, ~4 min):

    python -m pytest tests/test_torch_spec.py -m slow -s
"""

import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import jax.numpy as jnp
import pytest
import torch

sys.path.insert(0, str(Path(__file__).parent))
from model_generator import kl_truth_gaussian, random_gaussian  # noqa: E402

import gpry_tpu.ops.kernels as jk  # noqa: E402
import gpry_tpu.ops.linalg as jl  # noqa: E402
import gpry_tpu.run as jax_run  # noqa: E402
from gpry_tpu import config as jconfig  # noqa: E402
from gpry_tpu.acquisition import functions as jf  # noqa: E402
from gpry_tpu.acquisition.base import grow_surrogate as j_grow  # noqa: E402
from gpry_tpu.acquisition.batch_optimizer import \
    _acq_values_gated as j_acq_values_gated  # noqa: E402
from gpry_tpu.acquisition.ranked_pool import _bulk_fill_device  # noqa: E402
from gpry_tpu.models.gp import GaussianProcessRegressor as JGPR  # noqa: E402
from gpry_tpu.models.gp import surrogate_predict as j_predict  # noqa: E402
from gpry_tpu.models.gp import surrogate_predict_mean as \
    j_predict_mean  # noqa: E402
from gpry_tpu.models.preprocessing import Normalize_bounds as JNB  # noqa
from gpry_tpu.models.preprocessing import Normalize_y as JNY  # noqa: E402

import gpry_tpu_torch.run as torch_run  # noqa: E402
from gpry_tpu_torch import config  # noqa: E402
from gpry_tpu_torch.acquisition import functions as tf  # noqa: E402
from gpry_tpu_torch.acquisition.base import grow_surrogate  # noqa: E402
from gpry_tpu_torch.models.gp import GaussianProcessRegressor as TGPR  # noqa
from gpry_tpu_torch.models.gp import surrogate_from_numpy  # noqa: E402
from gpry_tpu_torch.models.preprocessing import Normalize_bounds as TNB  # noqa
from gpry_tpu_torch.models.preprocessing import Normalize_y as TNY  # noqa
from gpry_tpu_torch.ops import fused  # noqa: E402
from gpry_tpu_torch.ops import kernels as tk  # noqa: E402
from gpry_tpu_torch.ops import linalg as tl  # noqa: E402

config.set_device("cpu")
# tiny shapes: one intra-op thread, so that parallel test workers do
# not oversubscribe the cores
torch.set_num_threads(1)
KL_GATE = 0.05

# chip_smoke.py's path (f) kernel: C() * RBF(ARD) + WhiteKernel
PATH_F = {"Sum": [
    {"Product": [{"ConstantKernel": {"constant_value_bounds": [1e-4, 1e6]}},
                 {"RBF": {"length_scale_bounds": [1e-3, 10.0]}}]},
    {"WhiteKernel": {"noise_level": 1e-4,
                     "noise_level_bounds": [1e-8, 0.1]}}]}


def all_nodes(d):
    """A spec holding every node kind."""
    return {"Sum": [
        {"Product": [{"ConstantKernel": {"constant_value": 1.3}},
                     {"Exponentiation": {"kernel": {"Matern": {
                         "nu": 2.5, "length_scale": [0.5] * d}},
                         "exponent": 2.0}}]},
        {"Sum": [{"Product": [{"ConstantKernel": {"constant_value": 0.5}},
                              {"RationalQuadratic": {"alpha": 1.5,
                                                     "length_scale": 0.5}}]},
                 {"Sum": [{"ExpSineSquared": {"length_scale": 1.0,
                                              "periodicity": 3.0}},
                          {"Sum": [{"DotProduct": {"sigma_0": 0.3}},
                                   {"WhiteKernel": {"noise_level": 1e-3}}]}
                          ]}]}]}


# (kernel description, d): the cases of tests/test_kernels.py:39-86, plus
# every node kind at once and a non-integer power that goes negative
CASES = {
    "rbf_ard": ({"RBF": {"length_scale": [0.5, 0.8, 1.3]}}, 3),
    "matern12": ({"Matern": {"nu": 0.5, "length_scale": [0.6, 1.1]}}, 2),
    "matern32": ({"Matern": {"nu": 1.5, "length_scale": [0.6, 1.1]}}, 2),
    "matern52": ({"Matern": {"nu": 2.5, "length_scale": [0.6, 1.1]}}, 2),
    "rq": ({"RationalQuadratic": {"alpha": 1.3, "length_scale": 0.7}}, 2),
    "expsine": ({"ExpSineSquared": {"length_scale": 0.5,
                                    "periodicity": 2.0}}, 2),
    "dotproduct": ({"DotProduct": {"sigma_0": 1.5}}, 3),
    "white": ({"WhiteKernel": {"noise_level": 0.3}}, 2),
    "constant": ({"ConstantKernel": {"constant_value": 2.0}}, 2),
    "c_rbf_white": ({"Sum": [
        {"Product": [{"ConstantKernel": {"constant_value": 2.0}},
                     {"RBF": {"length_scale": [0.5, 0.7]}}]},
        {"WhiteKernel": {"noise_level": 0.1}}]}, 2),
    "rbf_squared": ({"Exponentiation": {
        "kernel": {"RBF": {"length_scale": [0.4, 0.9]}},
        "exponent": 2.0}}, 2),
    "all_nodes": (all_nodes(3), 3),
    "pow_nan": ({"Exponentiation": {"kernel": {"DotProduct": {
        "sigma_0": 0.2}}, "exponent": 1.5}}, 2),
}


def T(a):
    return torch.as_tensor(np.asarray(a, dtype=float), dtype=torch.float64)


def J(a):
    return jnp.asarray(np.asarray(a, dtype=float))


def ported(p):
    d = {k: (v if k == "svm" else np.asarray(v))
         for k, v in p._asdict().items()}
    d["svm"] = {k: np.asarray(v) for k, v in p.svm._asdict().items()}
    return surrogate_from_numpy(d, device="cpu")


def program_cross(spec, theta, X1, X2):
    """K(X1, X2) from ``encode_spec``'s program with the CUDA interpreter's
    arithmetic (csrc/common.cuh gpry_spec_cov): post order on a stack,
    ARD and RQ differences times exp(-theta)."""
    ops, offs, expo, _ = fused.encode_spec(spec, X1.shape[1])
    et, iet = torch.exp(theta), torch.exp(-theta)
    diff = X1[:, None, :] - X2[None, :, :]
    names = {v: k for k, v in fused.SPEC_OPS.items()}
    st = []
    for op, off, e in zip(ops, offs, expo):
        kind = names[op]
        if kind in ("sum", "product"):
            b, a = st.pop(), st.pop()
            st.append(a + b if kind == "sum" else a * b)
        elif kind == "pow":
            st.append(st.pop() ** e)
        elif kind in tk._ARD:
            d = X1.shape[1]
            sq = torch.sum((diff * iet[off:off + d]) ** 2, dim=-1)
            st.append(tk.k_of_sq(kind, sq))
        elif kind == "rq":
            sq = torch.sum((diff * iet[off + 1]) ** 2, dim=-1)
            st.append((1.0 + sq / (2.0 * et[off])) ** (-et[off]))
        elif kind == "expsine":
            r = tk._safe_sqrt(torch.sum(diff * diff, dim=-1))
            s = torch.sin(torch.pi * r / et[off + 1]) / et[off]
            st.append(torch.exp(-2.0 * s * s))
        elif kind == "dotproduct":
            st.append(et[off] ** 2 + torch.sum(X1[:, None] * X2[None],
                                               dim=-1))
        elif kind == "white":
            st.append(torch.zeros(diff.shape[:2], dtype=X1.dtype))
        else:
            st.append(et[off].expand(diff.shape[:2]))
    assert len(st) == 1
    return st[0]


@pytest.mark.parametrize("case", list(CASES))
def test_spec_kernel_matches_jax(case):
    """``build_kernel_spec`` gives JAX's spec, theta0 and bounds;
    ``cross_kernel`` and ``kernel_diag`` agree with ``spec_cross`` and
    ``spec_diag`` to rel 1e-12 (NaN where JAX is NaN); a batched theta (R,
    p) gives each row's result; the program the CUDA kernels interpret
    computes the same matrix."""
    obj, d = CASES[case]
    spec, theta0, bounds = tk.build_kernel_spec(obj, d)
    assert (spec, theta0, bounds) == jk.build_kernel_spec(obj, d)
    assert tk.spec_n_params(spec) == len(theta0)
    rng = np.random.default_rng(0)
    X1, X2 = rng.uniform(-1, 2, (13, d)), rng.uniform(-1, 2, (7, d))
    X2[0] = X1[0]  # r = 0: the square roots must stay zero-safe
    thetas = np.asarray(theta0) + rng.uniform(-0.3, 0.3, (4, len(theta0)))
    K_b = tk.cross_kernel(spec, T(thetas), T(X1), T(X2)).numpy()
    D_b = tk.kernel_diag(spec, T(thetas), T(X1)).numpy()
    assert K_b.shape == (4, 13, 7) and D_b.shape == (4, 13)
    for r, theta in enumerate(thetas):
        K_j = np.asarray(jk.cross_kernel(spec, J(theta), J(X1), J(X2)))
        K_t = tk.cross_kernel(spec, T(theta), T(X1), T(X2)).numpy()
        np.testing.assert_allclose(K_t, K_j, rtol=1e-12, atol=0)
        np.testing.assert_allclose(K_b[r], K_t, rtol=1e-12, atol=0)
        D_j = np.asarray(jk.kernel_diag(spec, J(theta), J(X1)))
        np.testing.assert_allclose(
            tk.kernel_diag(spec, T(theta), T(X1)).numpy(), D_j, rtol=1e-12)
        np.testing.assert_allclose(D_b[r], D_j, rtol=1e-12)
        np.testing.assert_allclose(
            program_cross(spec, T(theta), T(X1), T(X2)).numpy(), K_j,
            rtol=1e-12, atol=1e-15)
    if case == "pow_nan":
        assert np.isnan(K_b).any() and not np.isnan(K_b).all()
    else:
        assert np.isfinite(K_b).all()


def test_spec_program_and_its_limits():
    """``encode_spec``: the post-order program of a spec (theta offsets
    depth-first, the exponent on the pow node, the stack depth), and
    ValueError for a malformed tree, an ARD leaf of the wrong dimension,
    and a tree beyond the kernels' limits; ``check_family`` takes a
    well-formed tree."""
    spec, _, _ = tk.build_kernel_spec(all_nodes(3), 3)
    assert tk.check_family(spec) is spec
    ops, offs, expo, depth = fused.encode_spec(spec, 3)
    o = fused.SPEC_OPS
    assert ops == [o["constant"], o["matern52"], o["pow"], o["product"],
                   o["constant"], o["rq"], o["product"], o["expsine"],
                   o["dotproduct"], o["white"], o["sum"], o["sum"],
                   o["sum"], o["sum"]]
    assert offs == [0, 1, 1, 0, 4, 5, 4, 7, 9, 10, 9, 7, 4, 0]
    assert expo[2] == 2.0 and sum(expo) == 2.0
    assert depth == 5
    with pytest.raises(ValueError, match="dimension"):
        fused.encode_spec(spec, 2)
    for bad in (("rbf3", 2), ("sum", ("white",)), ("pow", ("white",))):
        with pytest.raises(ValueError):
            fused.encode_spec(bad, 2)
    big = ("white",)
    for _ in range(fused.SPEC_MAX_NODES // 2):
        big = ("sum", ("white",), big)
    with pytest.raises(ValueError, match="at most"):
        fused.encode_spec(big, 2)
    # the plain versions take any tree: on CPU tensors nothing is encoded
    theta = T(np.zeros(tk.spec_n_params(big)))
    K = fused.masked_kernel_matrix_plain(big, theta[None], T(np.eye(2)), 2,
                                         T(0.0))
    # 17 WhiteKernel terms of noise level exp(0) on the diagonal
    np.testing.assert_allclose(K[0].numpy(), 17.0 * np.eye(2))


# ---------------------------------------------------------------------------
# the plain versions of K1, K2 and K4 on a spec surrogate
# ---------------------------------------------------------------------------

D = 2
BOUNDS = np.array([[-5.0, 5.0]] * D)


def truth(X):
    X = np.atleast_2d(X)
    y = -0.5 * np.sum((X - [0.5, -0.3]) ** 2 / [1.2, 0.6], axis=1)
    y[np.linalg.norm(X, axis=1) > 4.0] = -np.inf
    return y


def jax_gpr(kernel, seed=3, n=40, **kw):
    """A JAX GPR with the spec kernel, an active classifier and a trust
    region, factorized at its initial hyperparameters."""
    X = np.random.default_rng(seed).uniform(-5, 5, (n, D))
    kw.setdefault("trust_region_factor", 1.5)
    gpr = JGPR(kernel=kernel, bounds=BOUNDS, preprocessing_X=JNB(BOUNDS),
               preprocessing_y=JNY(), n_restarts_optimizer=4,
               random_state=7, **kw)
    gpr.append_to_data(X, truth(X), fit_gpr=False)
    gpr._fitted = True
    return gpr


def carried_gpr(j, kernel):
    """A port GPR holding exactly the JAX GPR's state."""
    t = TGPR(kernel=kernel, bounds=BOUNDS, preprocessing_X=TNB(BOUNDS),
             preprocessing_y=TNY(), n_restarts_optimizer=4, random_state=7,
             trust_region_factor=j.trust_region_factor)
    svm = {k: v for k, v in vars(j.infinities_classifier).items()
           if k != "backend"}
    t.load_numpy_state(j.kernel_theta, j.X_train_all, j.y_train_all,
                       j.preprocessing_X.loc, j.preprocessing_X.scale,
                       j.preprocessing_y.mean_, j.preprocessing_y.std_,
                       svm=svm)
    return t


def test_spec_gated_mean_and_meanvar_plain_match_jax():
    """K1 and K2 (both output modes) on a surrogate with every node kind:
    identical -inf masks, values within rel 1e-9, the clip binding."""
    j = jax_gpr(all_nodes(D))
    assert isinstance(j.family, tuple)
    p_j = j.surrogate_params()
    Xq = np.random.default_rng(4).uniform(-6, 6, (400, D))
    m0 = np.asarray(j_predict_mean(j.family, p_j, J(Xq)))
    p_j = p_j._replace(clip_max=jnp.asarray(np.median(m0[np.isfinite(m0)])))
    p_t = ported(p_j)
    m_j = np.asarray(j_predict_mean(j.family, p_j, J(Xq)))
    m_t = fused.gated_mean(j.family, p_t, T(Xq)).numpy()
    np.testing.assert_array_equal(np.isinf(m_t), np.isinf(m_j))
    fin = np.isfinite(m_j)
    assert 0 < fin.sum() < len(Xq)
    assert np.any(m_j[fin] == float(p_j.clip_max)), "clip never binds"
    np.testing.assert_allclose(m_t[fin], m_j[fin], rtol=1e-9)
    mj, sj = map(np.asarray, j_predict(j.family, p_j, J(Xq)))
    mt, st = (a.numpy() for a in fused.gated_meanvar_logexp(
        j.family, p_t, T(Xq)))
    np.testing.assert_array_equal(np.isinf(mt), np.isinf(mj))
    np.testing.assert_allclose(mt[fin], mj[fin], rtol=1e-9)
    np.testing.assert_allclose(st, sj, rtol=1e-9, atol=1e-12)
    zeta, noise = D ** -0.85, 0.01
    aj = np.asarray(j_acq_values_gated(j.family, p_j, zeta, noise, J(Xq)))
    at = fused.gated_meanvar_logexp(j.family, p_t, T(Xq),
                                    logexp=(zeta, noise)).numpy()
    np.testing.assert_array_equal(np.isinf(at), np.isinf(aj))
    assert np.isfinite(aj).sum() > 0
    fin = np.isfinite(aj)
    np.testing.assert_allclose(at[fin], aj[fin], rtol=1e-9, atol=1e-12)


@pytest.mark.parametrize("noise", ["scalar", "vector"])
def test_spec_k4_plain_matches_jax_bulk_fill(noise):
    """K4's plain version against JAX's ``_bulk_fill_device`` with path
    (f)'s kernel (its WhiteKernel enters the appended rows' k22): the same
    picks, conditioned values within rel 1e-10."""
    size, n_train = 6, 30
    rng = np.random.default_rng(5)
    X = rng.uniform(-4, 4, (n_train, D))
    y = -0.5 * np.sum((X - [0.5, -0.3]) ** 2 / [1.2, 0.6], axis=1)
    nl = rng.uniform(5e-3, 2e-2, n_train) if noise == "vector" else None
    gprs = []
    for cls, nb, ny in ((JGPR, JNB, JNY), (TGPR, TNB, TNY)):
        g = cls(kernel=PATH_F, bounds=BOUNDS, preprocessing_X=nb(BOUNDS),
                preprocessing_y=ny(), random_state=3)
        g.append_to_data(X, y, noise_level=nl, fit_gpr=False)
        g._fitted = True
        gprs.append(g)
    j, t = gprs
    Xc = rng.uniform(-4, 4, (300, D))
    p = j.surrogate_params()
    mu, sd = (np.asarray(a) for a in j_predict(j.family, p, J(Xc)))
    noise_std = float(np.mean(j.noise_level))
    jacq = jf.LogExp(dimension=D)
    acq = np.asarray(jacq.values(J(mu), J(sd), j.y_max, noise_std))
    keep = np.isfinite(acq)
    Xc, mu, sd, acq = Xc[keep], mu[keep], sd[keep], acq[keep]
    nmax = jconfig.bucket_size(n_train + size)
    res_j = _bulk_fill_device(
        j.family, size, (jacq, jf._params_token(jacq)),
        j_grow(p, nmax), J(Xc), J(mu), J(sd), J(acq),
        jnp.ones(len(Xc), bool), noise_std)
    pt = grow_surrogate(t.surrogate_params(), nmax)
    tacq = tf.LogExp(dimension=D)
    res_t = fused.kriging_believer_fill_plain(
        t.family, pt, T(Xc), T(mu), T(sd), T(acq),
        torch.ones(len(Xc), dtype=torch.bool), size,
        lambda yy, ss: tacq.values(yy, ss, pt.y_max, noise_std))
    aX, aY, aS, aA, aC = (np.asarray(x) for x in res_t)
    bX, bY, bS, bA, bC = (np.asarray(x) for x in res_j)
    assert np.isfinite(bC).sum() == size
    np.testing.assert_array_equal(np.isfinite(aC), np.isfinite(bC))
    for a, b in ((aX, bX), (aY, bY), (aS, bS), (aA, bA)):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_allclose(aC, bC, rtol=1e-10, atol=0)


# ---------------------------------------------------------------------------
# K7 and predict(return_cov=True); the LML
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("kernel", ["RBF", "Matern",
                                    pytest.param(PATH_F, id="path_f"),
                                    pytest.param(all_nodes(D),
                                                 id="all_nodes")])
def test_predict_meancov_matches_jax(kernel):
    """``predict_meancov_plain`` against ``gpry_tpu.ops.linalg.
    predict_meancov`` (training points among the queries) and
    ``predict(return_cov=True)`` against the JAX GPR's: means within rel
    1e-9, covariances within an absolute 1e-10 max|K(Xq, Xq)| (K - V^T V
    cancels near the training points)."""
    j = jax_gpr(kernel)
    t = carried_gpr(j, kernel)
    p_j = j.surrogate_params()
    p_t = t.surrogate_params()
    rng = np.random.default_rng(8)
    Xq_raw = np.vstack([rng.uniform(-4, 4, (30, D)), j.X_train[:6]])
    Xq = (Xq_raw - j.preprocessing_X.loc) / j.preprocessing_X.scale
    mj, cj = (np.asarray(a) for a in jl.predict_meancov(
        j.family, p_j.theta, p_j.X, p_j.n, p_j.noise_var, p_j.L, p_j.alpha,
        J(Xq)))
    mt, ct = (a.numpy() for a in tl.predict_meancov(
        t.family, p_t.theta, p_t.X, p_t.n, p_t.noise_var, p_t.L, p_t.alpha,
        T(Xq)))
    kqq = np.asarray(jl.predict_meancov(
        j.family, p_j.theta, p_j.X, 0, p_j.noise_var, p_j.L, p_j.alpha,
        J(Xq))[1])
    atol = 1e-10 * np.max(np.abs(kqq))
    np.testing.assert_allclose(mt, mj, rtol=1e-9, atol=1e-12)
    assert np.max(np.abs(ct - cj)) <= atol
    mj, cj = j.predict(Xq_raw, return_cov=True)
    mt, ct = t.predict(Xq_raw, return_cov=True)
    np.testing.assert_array_equal(np.isinf(mt), np.isinf(mj))
    fin = np.isfinite(mj)
    np.testing.assert_allclose(mt[fin], mj[fin], rtol=1e-9)
    assert np.max(np.abs(ct - cj)) <= atol * float(p_j.y_scale) ** 2
    with pytest.raises(ValueError, match="exclusive"):
        t.predict(Xq_raw, return_cov=True, return_std=True)


def test_return_cov_diag_matches_std_with_white_kernel():
    """The port of tests/test_review2.py:126: with a WhiteKernel term the
    diagonal of ``predict(return_cov=True)`` is ``predict(return_std=True)``
    squared, because both take the same-point variance."""
    rng = np.random.default_rng(42)
    bounds = np.array([[-2.0, 2.0]] * 2)
    X = rng.uniform(-2, 2, size=(25, 2))
    y = -0.5 * np.sum(((X - 0.3) / 0.6) ** 2, axis=1)
    gpr = TGPR(bounds=bounds, kernel={"Sum": [
        {"RBF": {}}, {"WhiteKernel": {"noise_level": 0.05}}]},
        preprocessing_X=TNB(bounds), preprocessing_y=TNY(),
        n_restarts_optimizer=6, random_state=0)
    gpr.append_to_data(X, y)
    Xq = rng.uniform(-1, 1, size=(6, 2))
    _, cov = gpr.predict(Xq, return_cov=True)
    _, std = gpr.predict(Xq, return_std=True)
    assert np.allclose(np.diag(cov), std ** 2, rtol=1e-6, atol=1e-10)
    # the unfitted prior std is the same-point variance's root (raw X)
    g0 = TGPR(bounds=bounds, kernel={"Sum": [
        {"DotProduct": {"sigma_0": 0.5}}, {"WhiteKernel": {}}]})
    g0j = JGPR(bounds=bounds, kernel={"Sum": [
        {"DotProduct": {"sigma_0": 0.5}}, {"WhiteKernel": {}}]})
    np.testing.assert_allclose(g0.predict(Xq, return_std=True)[1],
                               g0j.predict(Xq, return_std=True)[1],
                               rtol=1e-12)
    with pytest.raises(ValueError, match="scales"):
        gpr.scales
    np.testing.assert_array_equal(
        gpr.theta_bounds, JGPR(bounds=bounds, kernel={"Sum": [
            {"RBF": {}}, {"WhiteKernel": {"noise_level": 0.05}}]}
        ).theta_bounds)


@pytest.mark.parametrize("kernel", [pytest.param(PATH_F, id="path_f"),
                                    pytest.param(all_nodes(D),
                                                 id="all_nodes")])
def test_spec_lml_matches_jax(kernel):
    """The log marginal likelihood at fixed theta (K3's plain version, the
    padded Cholesky), and the batched LML screen, within rel 1e-10."""
    j = jax_gpr(kernel)
    t = carried_gpr(j, kernel)
    thetas = j.kernel_theta + np.random.default_rng(9).uniform(
        -0.5, 0.5, (5, len(j.kernel_theta)))
    lj = np.array([j.log_marginal_likelihood(th) for th in thetas])
    lt = np.array([t.log_marginal_likelihood(th) for th in thetas])
    np.testing.assert_allclose(lt, lj, rtol=1e-10)
    lb = tl.lml_batch(t.family, t._dX, t._dy, t.n, t._noise_t(),
                      T(thetas)).numpy()
    np.testing.assert_allclose(lb, lj, rtol=1e-10)


def runners_match(d, rng):
    """``Runner(..., gpr={"kernel": <path (f)'s spec>})`` at the defaults
    (the audit on) in both packages: converged, KL(sample || truth) <=
    KL_GATE, truth evals within max(4, 25%); the port's GP runs the spec.
    Returns the truth evals of both."""
    m = random_gaussian(d=d, rng=rng)
    out = {}
    for name, mod in (("torch", torch_run), ("jax", jax_run)):
        runner = mod.Runner(m.loglike, bounds=m.bounds, seed=1, verbose=0,
                            gpr={"kernel": PATH_F})
        assert isinstance(runner.gpr.family, tuple)
        runner.run()
        X, w, _ = runner.last_mc_samples()
        kl = kl_truth_gaussian(X, w, m.mean, m.cov)
        assert runner.has_converged, name
        assert kl <= KL_GATE, f"{name}: KL={kl} > {KL_GATE}"
        out[name] = runner.gpr.n_total
    assert abs(out["torch"] - out["jax"]) <= max(4, 0.25 * out["jax"]), out
    return out


def test_spec_runner_matches_jax():
    runners_match(2, rng=12)


@pytest.mark.slow
def test_spec_runner_d8_matches_jax():
    """Path (f) of chip_smoke.py on the CPU: random_gaussian(d=8, rng=18),
    seed 1, converged with KL <= KL_GATE in both packages, truth evals
    within max(4, 25%).  The JAX package runs in a subprocess on one CPU
    device, as on a one-device host (this directory's conftest gives it an
    8-device mesh, which shards its sweeps); its count is chip_smoke.py's
    JAX_SPEC_EVALS."""
    m = random_gaussian(d=8, rng=18)
    runner = torch_run.Runner(m.loglike, bounds=m.bounds, seed=1, verbose=0,
                              gpr={"kernel": PATH_F})
    runner.run()
    X, w, _ = runner.last_mc_samples()
    out = {"torch": (runner.has_converged, runner.gpr.n_total,
                     kl_truth_gaussian(X, w, m.mean, m.cov))}
    code = (
        "import json, sys\n"
        "sys.path.insert(0, 'tests')\n"
        "from model_generator import kl_truth_gaussian, random_gaussian\n"
        "import gpry_tpu.run as jax_run\n"
        f"m = random_gaussian(d=8, rng=18)\n"
        "r = jax_run.Runner(m.loglike, bounds=m.bounds, seed=1, verbose=0,\n"
        f"                  gpr={{'kernel': {PATH_F!r}}})\n"
        "r.run()\n"
        "X, w, _ = r.last_mc_samples()\n"
        "print(json.dumps([bool(r.has_converged), int(r.gpr.n_total),\n"
        "                  float(kl_truth_gaussian(X, w, m.mean, m.cov))]))\n")
    env = dict(os.environ, XLA_FLAGS="", JAX_PLATFORMS="cpu")
    res = subprocess.run([sys.executable, "-c", code], env=env,
                         cwd=Path(__file__).resolve().parent.parent,
                         capture_output=True, text=True, timeout=1500)
    assert res.returncode == 0, res.stderr[-2000:]
    out["jax"] = tuple(json.loads(res.stdout.strip().splitlines()[-1]))
    print(f"(converged, truth evals, KL) at d = 8: {out}")
    for name, (converged, _, kl) in out.items():
        assert converged and kl <= KL_GATE, (name, out)
    n_t, n_j = out["torch"][1], out["jax"][1]
    assert abs(n_t - n_j) <= max(4, 0.25 * n_j), out
