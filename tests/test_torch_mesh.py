"""
The device mesh of gpry_tpu_torch (``parallel/mesh.py``) against gpry_tpu's
(``gpry_tpu/parallel/mesh.py``) on the CPU in float64: twins of
tests/test_parallel.py's mesh tests.  The JAX side shards over the 8
forced host devices (tests/conftest.py); the port over a logical mesh
``[cpu] * 8`` (torch has one CPU device, so every shard runs there, on
the kernels' plain versions).  Each twin gives the same numpy inputs to
both packages and holds the port against the JAX function at the
reference's tolerances, and against the port's own unsharded path (rtol
1e-12 for the DP predict and the NS, equal eval counts for the fit).
The NS's and the Runner's draws come from each framework's own generator,
so those two are held against JAX by distribution (NS) or not at all
(the Runner: the port's mesh run against its unsharded run).  Also:
K14's plain versions against the JAX ``local`` body of
``_tp_predict_raw``, the routing rules, and that the module imports
neither jax nor gpry_tpu.
"""

import subprocess
import sys
from pathlib import Path

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

sys.path.insert(0, str(Path(__file__).parent))
from model_generator import random_gaussian  # noqa: E402

from gpry_tpu import config as jconfig  # noqa: E402
from gpry_tpu.mc.nested import run_nested_device as j_run_ns  # noqa: E402
from gpry_tpu.mc.samples import surrogate_logp_fn as j_logp  # noqa: E402
from gpry_tpu.models.classifier import trivial_svm_params  # noqa: E402
from gpry_tpu.models.gp import SurrogateParams as JSP  # noqa: E402
from gpry_tpu.models.gp import surrogate_predict as j_predict  # noqa: E402
from gpry_tpu.ops import kernels as jk  # noqa: E402
from gpry_tpu.ops.linalg import factorize as j_factorize  # noqa: E402
from gpry_tpu.parallel import mesh as jmesh  # noqa: E402

from gpry_tpu_torch import config  # noqa: E402
from gpry_tpu_torch.acquisition import ranked_pool  # noqa: E402
from gpry_tpu_torch.acquisition.functions import LogExp  # noqa: E402
from gpry_tpu_torch.mc.nested import run_nested_device  # noqa: E402
from gpry_tpu_torch.mc.samples import surrogate_logp_fn  # noqa: E402
from gpry_tpu_torch.models import gp as tgp  # noqa: E402
from gpry_tpu_torch.models.gp import surrogate_from_numpy  # noqa: E402
from gpry_tpu_torch.ops import fused  # noqa: E402
from gpry_tpu_torch.ops import kernels as tk  # noqa: E402
from gpry_tpu_torch.parallel import mesh as tmesh  # noqa: E402
from gpry_tpu_torch.run import Runner  # noqa: E402

config.set_device("cpu")
torch.set_num_threads(1)
D, N, NMAX = 4, 48, 64
# tests/test_parallel.py's tolerances: TP's mean and sigma against the
# single-device predict (sigma's form differs: prior - k^T K^-1 k)
TP_MEAN = dict(rtol=1e-9, atol=1e-12)
TP_STD = dict(rtol=1e-6, atol=1e-9)
REL = 1e-12
# C() * RBF(ARD) + WhiteKernel
SPEC = {"Sum": [
    {"Product": [{"ConstantKernel": {"constant_value": 1.3}},
                 {"RBF": {"length_scale": [0.4, 0.6, 0.5, 0.3]}}]},
    {"WhiteKernel": {"noise_level": 1e-3}}]}


def T(a):
    return torch.tensor(np.asarray(a, dtype=float), dtype=torch.float64)


@pytest.fixture(scope="module")
def jmesh8():
    devices = jax.devices("cpu")
    if len(devices) < 8:
        pytest.skip("needs 8 virtual CPU devices")
    return jmesh.make_mesh(devices[:8])


@pytest.fixture(scope="module")
def mesh8():
    return tmesh.make_mesh([torch.device("cpu")] * 8)


@pytest.fixture(scope="module")
def params():
    """tests/test_parallel.py's surrogate (d = 4, n = 48 of nmax = 64), in
    both packages: (JAX SurrogateParams, the port's)."""
    rng = np.random.default_rng(0)
    dt = jconfig.FIT_DTYPE
    X = np.zeros((NMAX, D))
    X[:N] = rng.uniform(size=(N, D))
    y = np.zeros(NMAX)
    y[:N] = rng.normal(size=N)
    theta = jnp.asarray(jk.make_theta(1.5, [0.3] * D), dt)
    Xd, yd = jnp.asarray(X, dt), jnp.asarray(y, dt)
    L, alpha = j_factorize("rbf", theta, Xd, yd, N, 1e-4)
    jp = JSP(theta=theta, X=Xd, y=yd, n=jnp.asarray(N, jnp.int32),
             noise_var=jnp.asarray(1e-4, dt), L=L, alpha=alpha,
             x_loc=jnp.zeros(D, dt), x_scale=jnp.ones(D, dt),
             y_loc=jnp.asarray(0.0, dt), y_scale=jnp.asarray(1.0, dt),
             y_max=jnp.max(yd), clip_max=jnp.asarray(np.inf, dt),
             svm=trivial_svm_params(D, dtype=dt),
             trust_lo=jnp.full(D, -jnp.inf, dt),
             trust_hi=jnp.full(D, jnp.inf, dt))
    return jp, ported(jp)


def ported(jp):
    d = {k: (v if k == "svm" else np.asarray(v))
         for k, v in jp._asdict().items()}
    d["svm"] = {k: np.asarray(v) for k, v in jp.svm._asdict().items()}
    return surrogate_from_numpy(d, device="cpu")


def close(a, b, **tol):
    np.testing.assert_allclose(np.asarray(a), np.asarray(b), **tol)


def test_sharded_predict_matches_single(jmesh8, mesh8, params):
    """Twin of test_parallel.py:50: the DP predict against JAX's
    sharded_predict (np.allclose, as there) and against the port's own
    unsharded predict (rel 1e-12; the plain version's rows are
    independent, so equal here)."""
    jp, tp = params
    Xq = np.random.default_rng(1).uniform(size=(64, D))
    mean_s, std_s = tmesh.sharded_predict("rbf", tp, T(Xq), mesh8)
    with jmesh8:
        mean_j, std_j = jmesh.sharded_predict("rbf", jp, jnp.asarray(Xq),
                                              jmesh8)
    assert np.allclose(mean_s.numpy(), np.asarray(mean_j))
    assert np.allclose(std_s.numpy(), np.asarray(std_j))
    mean, std = tgp.surrogate_predict("rbf", tp, T(Xq))
    close(mean_s, mean, rtol=REL, atol=0)
    close(std_s, std, rtol=REL, atol=0)


def test_tp_predict_matches(jmesh8, mesh8, params):
    """Twin of test_parallel.py:60: the TP predict against JAX's
    tp_predict and against the port's single-device predict (atol
    1e-10; sigma rtol 1e-7, atol 1e-9, as there)."""
    jp, tp = params
    Xq = np.random.default_rng(2).uniform(size=(8, D))
    mean_tp, std_tp = tmesh.tp_predict("rbf", tp, T(Xq), mesh8)
    with jmesh8:
        mean_j, std_j = jmesh.tp_predict("rbf", jp, jnp.asarray(Xq), jmesh8)
    close(mean_tp, mean_j, rtol=0, atol=1e-10)
    close(std_tp, std_j, rtol=1e-7, atol=1e-9)
    mean, std = tgp.surrogate_predict("rbf", tp, T(Xq))
    assert np.allclose(mean_tp.numpy(), mean.numpy(), atol=1e-10)
    assert np.allclose(std_tp.numpy(), std.numpy(), rtol=1e-7, atol=1e-9)


def test_sharded_fit_theta_matches_single(jmesh8, mesh8, params):
    """Twin of test_parallel.py:73: 16 restarts over 8 shards at maxiter
    100.  Against the port's unsharded fit: the same evals lane by lane,
    -LML rel 1e-8, theta rtol 1e-4 (the reference's tolerances); against
    JAX's _sharded_fit_theta the same evals and -LML rel 1e-8."""
    jp, tp = params
    rng = np.random.default_rng(3)
    lo, hi = np.full(1 + D, -5.0), np.full(1 + D, 5.0)
    theta0s = rng.uniform(-3, 3, size=(16, 1 + D))
    thetas, nlls, nevs = tmesh._sharded_fit_theta(
        "rbf", tp.X, tp.y, N, T(1e-4), T(theta0s), T(lo), T(hi), mesh8,
        maxiter=100)
    nlls = nlls.numpy()
    assert nlls.shape == (16,)
    assert np.isfinite(nlls).sum() >= 14
    thetas_1, nlls_1, nevs_1 = tgp._fit_theta_restarts(
        "rbf", tp.X, tp.y, N, T(1e-4), T(theta0s), T(lo), T(hi),
        maxiter=100)
    nlls_1 = nlls_1.numpy()
    assert np.all(nevs_1.numpy() >= 1)
    assert nevs.tolist() == nevs_1.tolist()
    finite = np.isfinite(nlls) & np.isfinite(nlls_1)
    assert np.array_equal(np.isfinite(nlls), np.isfinite(nlls_1))
    close(nlls[finite], nlls_1[finite], rtol=1e-8)
    close(thetas.numpy()[finite], thetas_1.numpy()[finite], rtol=1e-4,
          atol=1e-6)
    with jmesh8:
        _, nlls_j, nevs_j = jmesh._sharded_fit_theta(
            "rbf", jp.X, jp.y, jp.n, 1e-4, jnp.asarray(theta0s),
            jnp.asarray(lo), jnp.asarray(hi), jmesh8, maxiter=100)
    assert nevs.tolist() == np.asarray(nevs_j).tolist()
    nlls_j = np.asarray(nlls_j)
    assert np.array_equal(np.isfinite(nlls), np.isfinite(nlls_j))
    close(nlls[finite], nlls_j[finite], rtol=1e-8)


def test_runner_mesh_matches_single_device(mesh8, monkeypatch):
    """Twin of test_parallel.py:181: the loop dispatches its LML fits and
    its sweeps through the mesh (SHARD_STATS) and makes the same training
    set and hyperparameters as with the mesh disabled (X, y rtol 1e-10,
    theta rtol 1e-4, as there)."""
    monkeypatch.setattr(tmesh, "available_mesh", lambda *a, **k: mesh8)

    def run_once():
        m = random_gaussian(d=2, rng=5)
        runner = Runner(
            m.loglike, bounds=m.bounds, seed=5, verbose=1,
            gp_acquisition={"NORA": {"nlive_max": 48,
                                     "nlive_per_training": 16,
                                     "num_repeats": 6, "mc_every": 2}},
            convergence_criterion=False,
            options={"n_initial": 6, "max_total": 12,
                     "n_points_per_acq": 2},
            mc="uniform")
        runner.run()
        return runner

    stats0 = dict(tmesh.SHARD_STATS)
    r_mesh = run_once()
    assert tmesh.SHARD_STATS["fit"] > stats0["fit"], \
        "mesh-sharded LML fit never dispatched"
    assert tmesh.SHARD_STATS["predict"] > stats0["predict"], \
        "mesh-sharded prediction sweep never dispatched"
    monkeypatch.setattr(tmesh, "available_mesh", lambda *a, **k: None)
    r_single = run_once()
    close(r_mesh.gpr.X_train_all, r_single.gpr.X_train_all, rtol=1e-10,
          atol=1e-12)
    close(r_mesh.gpr.y_train_all, r_single.gpr.y_train_all, rtol=1e-10,
          atol=1e-12)
    close(r_mesh.gpr.kernel_theta, r_single.gpr.kernel_theta, rtol=1e-4)


def test_nested_sampler_mesh_matches_single(jmesh8, mesh8, params):
    """Twin of test_parallel.py:229: the NS with each step's 8 chains over
    the mesh gives the unsharded run's samples (n_dead equal, X and logl
    rel 1e-12, logZ rel 1e-10).  The JAX run draws from its own keys:
    held by its logZ, within 0.3 nats (the runs' statistical spread at
    nlive 48 is ~0.05)."""
    jp, tp = params
    lo, hi = torch.full((D,), -1.0, dtype=torch.float64), \
        torch.full((D,), 2.0, dtype=torch.float64)
    kw = dict(nlive=48, num_repeats=6, precision_criterion=0.05,
              max_dead=768)
    res_s = run_nested_device(surrogate_logp_fn("rbf"), tp,
                              torch.Generator().manual_seed(3), lo, hi,
                              mesh=mesh8, **kw)
    res_1 = run_nested_device(surrogate_logp_fn("rbf"), tp,
                              torch.Generator().manual_seed(3), lo, hi,
                              mesh=None, **kw)
    assert res_s.n_dead == res_1.n_dead
    assert res_s.n_calls == res_1.n_calls
    close(res_s.X, res_1.X, rtol=REL, atol=1e-14)
    fin = torch.isfinite(res_1.logl)
    assert torch.equal(fin, torch.isfinite(res_s.logl))
    close(res_s.logl[fin], res_1.logl[fin], rtol=REL, atol=1e-13)
    close(res_s.logZ, res_1.logZ, rtol=1e-10)
    res_j = j_run_ns(j_logp("rbf"), jp, jax.random.PRNGKey(3),
                     jnp.full(D, -1.0), jnp.full(D, 2.0), mesh=jmesh8, **kw)
    assert abs(res_s.logZ - float(res_j.logZ)) < 0.3


def test_tp_predict_matches_surrogate_predict(jmesh8, mesh8, params):
    """Twin of test_parallel.py:544 at its tolerances (mean rtol 1e-9,
    atol 1e-12; sigma rtol 1e-6, atol 1e-9), against the port's predict
    and JAX's tp_predict."""
    jp, tp = params
    Xq = np.random.default_rng(4).uniform(size=(16, D))
    mean_tp, std_tp = tmesh.tp_predict("rbf", tp, T(Xq), mesh8)
    mean, std = tgp.surrogate_predict("rbf", tp, T(Xq))
    close(mean_tp, mean, **TP_MEAN)
    close(std_tp, std, **TP_STD)
    mean_j, std_j = jmesh.tp_predict("rbf", jp, jnp.asarray(Xq), jmesh8)
    close(mean_tp, mean_j, **TP_MEAN)
    close(std_tp, std_j, **TP_STD)


def test_predict_maybe_sharded_routes_tp(mesh8, params, monkeypatch):
    """Twin of test_parallel.py:559: a small batch and a training buffer
    of TP_NMAX_MIN rows take the TP route (SHARD_STATS['tp'] + 1) with
    the single-device results; 256 rows or more take the DP route
    (SHARD_STATS['predict'] + 1), rel 1e-12, row 0's padding sliced
    off."""
    jp, tp = params
    monkeypatch.setattr(tmesh, "TP_NMAX_MIN", 64)  # the fixture's nmax
    monkeypatch.setattr(tmesh, "available_mesh", lambda *a, **k: mesh8)
    Xq = np.random.default_rng(5).uniform(size=(8, D))
    tp0 = tmesh.SHARD_STATS["tp"]
    mean, std = tmesh.predict_maybe_sharded("rbf", tp, T(Xq))
    assert tmesh.SHARD_STATS["tp"] == tp0 + 1
    mean_1, std_1 = tgp.surrogate_predict("rbf", tp, T(Xq))
    close(mean, mean_1, **TP_MEAN)
    close(std, std_1, **TP_STD)
    mean_j, std_j = j_predict("rbf", jp, jnp.asarray(Xq))
    close(mean, mean_j, **TP_MEAN)
    close(std, std_j, **TP_STD)
    Xq = np.random.default_rng(6).uniform(size=(261, D))
    dp0 = tmesh.SHARD_STATS["predict"]
    mean, std = tmesh.predict_maybe_sharded("rbf", tp, T(Xq))
    assert tmesh.SHARD_STATS["predict"] == dp0 + 1
    assert mean.shape == (261,) and std.shape == (261,)
    mean_1, std_1 = tgp.surrogate_predict("rbf", tp, T(Xq))
    close(mean, mean_1, rtol=REL, atol=0)
    close(std, std_1, rtol=REL, atol=0)


def test_tp_predict_applies_gates(jmesh8, mesh8, params):
    """Twin of test_parallel.py:577: the trust box and the clip gate the
    TP predict as they gate the single-device one."""
    jp, tp = params
    jp = jp._replace(trust_lo=jnp.full(D, 0.2, jp.X.dtype),
                     trust_hi=jnp.full(D, 0.8, jp.X.dtype),
                     clip_max=jnp.asarray(0.5, jp.X.dtype))
    tp = ported(jp)
    Xq = np.random.default_rng(6).uniform(size=(12, D))
    mean_tp, std_tp = tmesh.tp_predict("rbf", tp, T(Xq), mesh8)
    mean, std = tgp.surrogate_predict("rbf", tp, T(Xq))
    close(mean_tp, mean, **TP_MEAN)
    close(std_tp, std, **TP_STD)
    mean_j, std_j = jmesh.tp_predict("rbf", jp, jnp.asarray(Xq), jmesh8)
    close(mean_tp, mean_j, **TP_MEAN)
    close(std_tp, std_j, **TP_STD)
    mean_tp = mean_tp.numpy()
    assert np.any(mean_tp == -np.inf)
    assert np.all(mean_tp[np.isfinite(mean_tp)] <= 0.5 + 1e-12)


def jax_local(family, theta, X_shard, alpha_shard, M_shard, k_full, Xq_,
              row0, n):
    """The ``local`` body of gpry_tpu/parallel/mesh.py:188-197 for one
    shard, with the gathered k_full given."""
    idx = row0 + jnp.arange(X_shard.shape[0])
    m = (idx < n).astype(X_shard.dtype)
    Kq = jk.cross_kernel(family, theta, X_shard, Xq_) * m[:, None]
    mean_part = Kq.T @ alpha_shard
    quad_part = jnp.sum(Kq * (M_shard @ k_full), axis=0)
    return Kq, mean_part, quad_part


@pytest.mark.parametrize("kind", ["rbf", "spec"])
def test_k14_plain_matches_the_jax_local_body(kind):
    """tp_cross_mean_plain and tp_quad_plain against the JAX ``local``
    body on the shards of a d = 4 GP (n = 40 of nmax = 64, 4 shards, so
    that the last ones hold padding), within rel 1e-12 of each output's
    largest entry, for RBF and C() * RBF(ARD) + WhiteKernel (whose white
    term the cross form drops)."""
    rng = np.random.default_rng(11)
    n, P, nq = 40, 4, 9
    if kind == "rbf":
        family = "rbf"
        theta = np.asarray(jk.make_theta(1.2, [0.4, 0.6, 0.5, 0.3]))
    else:
        family, theta, _ = jk.build_kernel_spec(SPEC, D)
        assert tk.build_kernel_spec(SPEC, D)[0] == family
        theta = np.asarray(theta, dtype=float)
    X = np.zeros((NMAX, D))
    X[:n] = rng.uniform(size=(n, D))
    alpha = np.zeros(NMAX)
    alpha[:n] = rng.normal(size=n)
    Xq = rng.uniform(size=(nq, D))
    A = rng.normal(size=(NMAX, NMAX))
    M = A @ A.T / NMAX + np.eye(NMAX)
    nloc = NMAX // P
    Ks, k_parts = [], []
    for i in range(P):
        s = slice(i * nloc, (i + 1) * nloc)
        K, mean = fused.tp_cross_mean_plain(family, T(theta), T(X[s]),
                                            T(alpha[s]), T(Xq), i * nloc, n)
        Ks.append((K, mean))
        k_parts.append(K)
    k_full = torch.cat(k_parts)
    for i in range(P):
        s = slice(i * nloc, (i + 1) * nloc)
        K, mean = Ks[i]
        quad = fused.tp_quad_plain(T(M[s]), k_full, K)
        Kj, mean_j, quad_j = map(np.asarray, jax_local(
            family, jnp.asarray(theta), jnp.asarray(X[s]),
            jnp.asarray(alpha[s]), jnp.asarray(M[s]),
            jnp.asarray(k_full.numpy()), jnp.asarray(Xq), i * nloc, n))
        for a, b in ((K, Kj), (mean, mean_j), (quad, quad_j)):
            scale = max(np.max(np.abs(b)), 1e-300)
            assert np.max(np.abs(a.numpy() - b)) <= REL * scale
        if i * nloc >= n:
            assert not K.any()


def test_mesh_module_imports_no_jax():
    """parallel/mesh.py (and what it imports) loads neither jax nor
    gpry_tpu."""
    code = ("import sys; import gpry_tpu_torch.parallel.mesh; "
            "bad = [m for m in sys.modules if m == 'jax' or "
            "m.startswith('jax.') or m == 'gpry_tpu' or "
            "m.startswith('gpry_tpu.')]; print(bad); "
            "sys.exit(1 if bad else 0)")
    root = Path(__file__).resolve().parent.parent
    out = subprocess.run([sys.executable, "-c", code], cwd=root,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stdout + out.stderr


def test_available_mesh_is_none_for_cpu_tensors(params):
    """No mesh for CPU tensors, for the CPU platform, and inside
    mesh_disabled(); a mesh may repeat a device."""
    _, tp = params
    assert tmesh.available_mesh(tp.X) is None
    assert tmesh.available_mesh(platform="cpu") is None
    assert tmesh.available_mesh() is None
    with tmesh.mesh_disabled():
        assert tmesh.available_mesh(tp.X) is None
    mesh = tmesh.make_mesh(["cpu"] * 3)
    assert mesh.shape["data"] == 3 and mesh.n_distinct == 1


def test_ranked_pool_skips_the_bulk_fill_under_a_mesh(mesh8, monkeypatch):
    """With a mesh up the ranked pool fills on the host loop (its sweeps
    row-split), never on K4's bulk fill; without one it takes K4's fill,
    and both fills pick the same points."""
    m = random_gaussian(d=2, rng=3)
    rng = np.random.default_rng(3)
    gpr = tgp.GaussianProcessRegressor(bounds=m.bounds,
                                       n_restarts_optimizer=4,
                                       random_state=3)
    X = rng.uniform(m.bounds[:, 0], m.bounds[:, 1], size=(20, 2))
    gpr.append_to_data(X, np.array([m.loglike(x) for x in X]))
    Xc = rng.uniform(m.bounds[:, 0], m.bounds[:, 1], size=(300, 2))
    acqf = LogExp(dimension=2, zeta=0.1)

    def acq(y, sigma):
        return acqf.values(T(y), T(sigma), float(gpr.y_max),
                           float(np.mean(gpr.noise_level))).numpy()

    fills = []
    inner = ranked_pool.kriging_believer_fill

    def spy(*args, **kwargs):
        fills.append(1)
        return inner(*args, **kwargs)

    monkeypatch.setattr(ranked_pool, "kriging_believer_fill", spy)
    picks = []
    for mesh in (mesh8, None):
        monkeypatch.setattr(tmesh, "available_mesh",
                            lambda *a, _m=mesh, **k: _m)
        fills.clear()
        stats0 = tmesh.SHARD_STATS["predict"]
        pool = ranked_pool.RankedPool(4, gpr, acq, acqf=acqf)
        pool.add(Xc)
        picks.append(pool.get()[0])
        if mesh is None:
            assert fills == [1]
        else:
            assert fills == []
            assert tmesh.SHARD_STATS["predict"] > stats0
    close(picks[0], picks[1], rtol=1e-10, atol=1e-12)
