"""
K1's host-side plan and K3's row panel on the CPU.

``fused.gated_mean_plan`` mirrors csrc/gated_mean.cu k1_plan (the card
tests hold the two to the same numbers): here every shape the two designs
before it took gets a geometry that fits a Hopper block, and the main
path's batch sizes get theirs.  K3's plain version builds a panel of rows
(``rows=(r0, r1)``) whose entries are the whole matrix's, bit for bit for
the fast families; ``chol_append`` builds its new rows through that panel
and gives the factor and alpha of the whole-matrix route bit for bit.
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

import gpry_tpu.ops.linalg as jl

from gpry_tpu_torch import config
from gpry_tpu_torch.ops import fused
from gpry_tpu_torch.ops import kernels as tk
from gpry_tpu_torch.ops import linalg as tl

from test_torch_k2_plan import spec_doubles
from test_torch_ops import SPECS, family_theta, padded_problem

config.set_device("cpu")
torch.set_num_threads(1)
SMEM_MAX = 227 * 1024
FAST = ("rbf", "matern12", "matern32", "matern52")


def T(a):
    return torch.as_tensor(np.asarray(a, dtype=float), dtype=torch.float64)


def J(a):
    return jnp.asarray(np.asarray(a, dtype=float))


def parent_took(d, spec):
    """The design before this plan took a shape if its tiled design (one
    thread a query, 128 a block; any n) fit: ls, two query copies of 128
    queries, a 64-row tile with its weights and the spec program in
    227 KB; its block design only shapes inside that."""
    return 8 * (d + 2 * d * 128 + 64 * d + 64 + spec) <= SMEM_MAX


@pytest.mark.parametrize("spec", (False, True))
@pytest.mark.parametrize("d", (1, 2, 8, 9, 16, 32, 33, 64, 65, 90))
def test_k1_plan_covers_the_parents_range(d, spec):
    """Every (nq, n, nsv, d) the parent took gets a geometry: n far beyond
    shared memory (4,000, 20,000: the rows stream), d above 64 (the
    queries in shared memory), a fast family and ALL_NODES."""
    sd = spec_doubles(d) if spec else 0
    while not parent_took(d, sd):
        # the edge of the parent's range for a spec program
        d -= 1
        sd = spec_doubles(d)
    for nq in (1, 16, 66, 2000, 16384, 65536, 100000):
        for n in (0, 1, 224, 4000, 20000):
            for nsv in (0, 8):
                qw, sw, cl, tr, dq, smem = fused.gated_mean_plan(nq, n, nsv,
                                                                 d, sd)
                assert smem <= SMEM_MAX
                assert sw in (1, 2, 4, 8) and 1 <= qw * sw <= 8
                assert 1 <= cl <= 16 and tr >= 8
                assert dq == (0 if spec or d > 32 else 8 if d <= 8 else 32)
                # queries a block do not exceed the batch's query warps
                assert qw <= max(1, -(-nq // 32))
                # a split sums at least 2 rows where there are splits
                if sw * cl > 1:
                    assert (n + nsv) // (sw * cl) >= 2


def test_k1_plan_takes_the_main_path():
    """d = 8, n = 224, 8 support vectors: the IS refine's 65,536 queries
    256 to a block (one wave of 2 blocks an SM); 16,384 64 to a block,
    four warps each; 2,000 a query warp a block over a cluster of 2 (one
    block an SM); the MCMC's start tries, the kill batches and the NS
    prior phase (16-400) a query warp a block over a cluster of 14 (10 at
    400); n = 4,000 and 20,000 stream over a cluster of 16; a spec program
    alike."""
    plan = fused.gated_mean_plan
    sd = spec_doubles(8)
    for spec in (0, sd):
        assert plan(65536, 224, 8, 8, spec)[:3] == (8, 1, 1)
        assert plan(16384, 224, 8, 8, spec)[:3] == (2, 4, 1)
        assert plan(2000, 224, 8, 8, spec)[:3] == (1, 8, 2)
        for nq in (16, 66, 256):
            assert plan(nq, 224, 8, 8, spec)[:3] == (1, 8, 14)
        assert plan(400, 224, 8, 8, spec)[:3] == (1, 8, 10)
    for n in (4000, 20000):
        assert plan(16, n, 8, 8)[:3] == (1, 8, 16)
    # one query of one row: one warp
    assert plan(1, 1, 0, 2)[:3] == (1, 1, 1)
    # the register instances by d, shared memory beyond 32 and for a spec
    assert [plan(66, 224, 8, d)[4] for d in (1, 8, 9, 32, 33)] == \
        [8, 8, 32, 32, 0]
    assert plan(66, 224, 8, 8, sd)[4] == 0


def test_k1_plan_shrinks_tiles_then_query_warps():
    """Where a block does not fit, the tile halves first (down to 8 rows),
    then the query warps, then the row splits; past one warp with 8-row
    tiles the plan raises (d = 358 for a fast family, far past the
    parent's d = 90)."""
    qw, sw, cl, tr, dq, smem = fused.gated_mean_plan(65536, 224, 8, 90)
    assert tr < 32 * qw * sw and dq == 0 and smem <= SMEM_MAX
    qw, sw, cl, tr = fused.gated_mean_plan(65536, 224, 8, 9)[:4]
    assert tr == 32 * qw * sw
    qw, sw, cl, tr, dq, smem = fused.gated_mean_plan(1, 224, 8, 357)
    assert (qw, tr) == (1, 8) and sw < 8 and smem <= SMEM_MAX
    assert fused.gated_mean_plan(65536, 224, 8, 357)[:4] == (1, 1, 1, 8)
    with pytest.raises(ValueError, match="shared memory"):
        fused.gated_mean_plan(1, 224, 8, 358)


def test_k1_card_shapes_reach_every_geometry():
    """The card tests' K1_SHAPES (tests/test_torch_cuda.py) reach every
    kind of geometry the plan has, by shape alone: 1, 2, 4 and 8 splits a
    block, no cluster, a cluster of a few blocks and one of 16, both
    register instances and the queries in shared memory (a fast family;
    a spec program keeps them in shared memory at every shape)."""
    from test_torch_cuda import K1_SHAPES
    for nsv in (0, 8):
        geos = [fused.gated_mean_plan(nq, n, nsv, d)
                for nq, n, d in K1_SHAPES]
        assert {g[1] for g in geos} == {1, 2, 4, 8}
        clusters = {g[2] for g in geos}
        assert {1, 16} <= clusters and any(1 < c < 16 for c in clusters)
        assert {g[4] for g in geos} == {0, 8, 32}
        assert {g[0] for g in geos} >= {1, 4, 8}


def _kind(name, d):
    """(kernel argument, theta of 5 lanes) of a family or named spec."""
    rng = np.random.default_rng(d)
    if name in SPECS:
        spec, theta0, _ = tk.build_kernel_spec(SPECS[name](d), d)
        th = np.asarray(theta0) + 0.3 * rng.normal(size=(5, len(theta0)))
        return spec, th
    return name, np.log([1.5] + [0.5] * d) + 0.3 * rng.normal(
        size=(5, 1 + d))


def _panels(n, nmax):
    """Row ranges of every kind: a new row, a batch across n, the padding,
    the first and last rows, empty, and the whole matrix."""
    return ((n, min(nmax, n + 1)), (max(0, n - 3), min(nmax, n + 5)),
            (0, 1), (nmax - 1, nmax), (7, 7), (n, nmax), (0, nmax))


@pytest.mark.parametrize("noise", ("scalar", "vector"))
@pytest.mark.parametrize("family", FAST + ("spec_c_rbf_white",))
def test_k3_plain_panel_equals_the_full_rows(family, noise):
    """Each panel of the plain version is the whole matrix's rows bit for
    bit (sign bits too), with the jitter, at several n and d."""
    for d in (1, 3, 8):
        fam, th = _kind(family, d)
        for n in (0, 1, 17, 64):
            X, _, _, _, nv = padded_problem(d + n, n=n, d=d, noise=noise)
            full = fused.masked_kernel_matrix_plain(fam, T(th), T(X), n,
                                                    T(nv), 1e-5)
            for r0, r1 in _panels(n, 64):
                P = fused.masked_kernel_matrix_plain(fam, T(th), T(X), n,
                                                     T(nv), 1e-5,
                                                     rows=(r0, r1))
                assert P.shape == (5, r1 - r0, 64)
                assert torch.equal(P, full[:, r0:r1])
                assert torch.equal(torch.signbit(P),
                                   torch.signbit(full[:, r0:r1]))


def test_k3_plain_panel_all_nodes():
    """ALL_NODES's DotProduct is a matrix product, whose rounding depends
    on the operands' shape: its panel agrees with the whole matrix's rows
    to rel 1e-12 (and every other node kind exactly: the c_rbf_white case
    above)."""
    fam, th = _kind("spec_all_nodes", 3)
    for n in (1, 17, 64):
        X, _, _, _, nv = padded_problem(n, n=n)
        full = fused.masked_kernel_matrix_plain(fam, T(th), T(X), n, T(nv))
        for r0, r1 in _panels(n, 64):
            P = fused.masked_kernel_matrix_plain(fam, T(th), T(X), n, T(nv),
                                                 rows=(r0, r1))
            np.testing.assert_allclose(P.numpy(), full[:, r0:r1].numpy(),
                                       rtol=1e-12,
                                       atol=1e-12 * float(full.abs().max()))


@pytest.mark.parametrize("d", (1, 2, 4))
@pytest.mark.parametrize("family", FAST + tuple(SPECS))
def test_k3_panel_equals_jax_rows(family, d):
    """The panel (through the wrapper, on the CPU) against the rows of
    gpry_tpu's masked_kernel_matrix, rel 1e-12, scalar and vector noise."""
    for seed, (n, noise) in enumerate(((20, "scalar"), (64, "vector"),
                                       (1, "scalar"))):
        X, _, _, theta, nv = padded_problem(seed, n=n, d=d, noise=noise)
        fam, th = family_theta(family, theta, d)
        K_j = np.asarray(jl.masked_kernel_matrix(fam, J(th), J(X), n, J(nv),
                                                 1e-5))
        scale = np.abs(K_j).max()
        for r0, r1 in _panels(n, 64):
            P = fused.masked_kernel_matrix_batched(
                fam, T(th[None]), T(X), n, T(nv), 1e-5, rows=(r0, r1))[0]
            np.testing.assert_allclose(P.numpy(), K_j[r0:r1], rtol=1e-12,
                                       atol=1e-12 * scale)


def test_k3_rows_outside_the_matrix_raise():
    X, _, n, theta, nv = padded_problem(0)
    for rows in ((-1, 2), (3, 2), (0, 65)):
        with pytest.raises(ValueError, match="rows"):
            fused.masked_kernel_matrix_batched("rbf", T(theta[None]), T(X),
                                               n, T(nv), rows=rows)


def chol_append_full_build(family, theta, X, y, n, noise_var, L, X_new,
                           y_new):
    """The append before the panel: both blocks read off one K3 build of
    the grown set's whole matrix."""
    nmax, k = X.shape[0], X_new.shape[0]
    X2, y2 = X.clone(), y.clone()
    X2[n:n + k], y2[n:n + k] = X_new, y_new
    K = tl.masked_kernel_matrix(family, theta, X2, n + k, noise_var)
    m = (torch.arange(nmax) < n).to(X.dtype)
    S12 = torch.linalg.solve_triangular(L, K[:, n:n + k] * m[:, None],
                                        upper=False)
    S22 = fused.cholesky_nan(K[n:n + k, n:n + k] - S12.T @ S12)
    L2 = L.clone(memory_format=torch.contiguous_format)
    rows = torch.zeros((k, nmax), dtype=L.dtype)
    rows[:, :n] = S12[:n].T
    rows[:, n:n + k] = S22
    L2[n:n + k] = rows
    return X2, y2, n + k, L2, tl._solve_alpha(L2, y2)


@pytest.mark.parametrize("noise", ("scalar", "vector"))
@pytest.mark.parametrize("family", FAST + ("spec_c_rbf_white",))
def test_chol_append_panel_equals_the_full_build(family, noise):
    """Through the panel, chol_append's X, y, n, L and alpha equal the
    whole-matrix route's bit for bit: K12 is the panel's transpose, which
    the symmetric whole matrix held at (i, j) and (j, i) alike; appends of
    1, 4 and 8 points."""
    for k in (1, 4, 8):
        X, y, n, theta, nv = padded_problem(k, n=24 + k, noise=noise)
        fam, th = family_theta(family, theta, 3)
        n0 = 24
        Xs, ys = X.copy(), y.copy()
        Xs[n0:], ys[n0:] = 0.0, 0.0
        L0, _ = tl.factorize(fam, T(th), T(Xs), T(ys), n0, T(nv))
        args = (fam, T(th), T(Xs), T(ys), n0, T(nv), L0, T(X[n0:n]),
                T(y[n0:n]))
        got, want = tl.chol_append(*args), chol_append_full_build(*args)
        assert got[2] == want[2] == n
        for a, b in zip(got[:2] + got[3:], want[:2] + want[3:]):
            assert torch.equal(a, b)
