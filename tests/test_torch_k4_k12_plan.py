"""
K4's and K12's host-side plans on the CPU: ``fused.kriging_believer_fill_plan``
(the mirror of csrc/kriging_believer_fill.cu k4_plan) and
``fused.mcmc_chains_plan`` (the mirror of csrc/mcmc_chains.cu k12_plan;
``fused.mcmc_chains_min_smem`` mirrors the range gate).  The card tests
hold each mirror to the C plan.  Here: the main path's shapes take the
blocked sweep and the spread geometry, the edges fall where the plans say,
and every shape the designs before these took still gets a plan.
"""

import pytest

from gpry_tpu_torch import config
from gpry_tpu_torch.ops import fused

from test_torch_k2_plan import spec_doubles

SMEM_MAX = 227 * 1024


def test_k4_route_0_takes_the_main_path():
    """At d = 8 and nmax = 320 (n = 224 + the pool of 8): the sweep of
    N = 4,096 candidates 16 a block, N = 500 and the round-0 append
    (nq = 1) 8, above 4,224 candidates 32, all on the blocked route."""
    plan = fused.kriging_believer_fill_plan
    for n in (224, 231):
        assert plan(n, 320, 8, 4096)[:2] == (0, 16)
        assert plan(n, 320, 8, 500)[:2] == (0, 8)
        assert plan(n, 320, 8, 1)[:2] == (0, 8)
        assert plan(n, 320, 8, 4225)[:2] == (0, 32)


def _q_edge(nq, d, spec=0):
    """The first n at which the sweep of nq candidates drops from its
    batch's Q to a smaller one (or to route 1)."""
    plan = fused.kriging_believer_fill_plan
    q0 = plan(16, 4096, d, nq, spec)[1]
    n = 16
    while plan(n, 4096, d, nq, spec)[:2] == (0, q0):
        n += 1
    return n, q0


@pytest.mark.parametrize("nq", (4096, 5000))
def test_k4_only_q8_fits(nq):
    """Past the edge where Q = 16 (nq 4,096) or 32 (nq 5,000) no longer
    fits, the sweep keeps route 0 with fewer candidates a block, down to
    Q = 8; past Q = 8's edge it takes route 1."""
    plan = fused.kriging_believer_fill_plan
    n, q0 = _q_edge(nq, 8)
    assert q0 in (16, 32)
    route, q, smem = plan(n, 4096, 8, nq)
    assert route == 0 and q < q0 and smem <= SMEM_MAX
    while plan(n, 4096, 8, nq)[0] == 0:
        assert plan(n, 4096, 8, nq)[1] >= 8
        n += 1
    assert plan(n - 1, 4096, 8, nq)[1] == 8
    assert plan(n, 4096, 8, nq)[:2] == \
        (1, fused._sweep_queries_per_block(4096, 8, 0))


@pytest.mark.parametrize("d", (2, 4, 8, 16, 32))
def test_k4_default_budget_fits(d):
    """A default Runner's budget, n = 70 d^1.5 in its bucket, takes a route
    at every pool and candidate count, for a fast family and ALL_NODES,
    within a block's shared memory."""
    n = int(70 * d ** 1.5)
    nmax = config.bucket_size(n + 8)
    for spec in (0, spec_doubles(d)):
        for nq in (1, 500, 4096, 65536):
            for m in (0, 1, 224, n):
                route, q, smem = fused.kriging_believer_fill_plan(
                    m, nmax, d, nq, spec)
                assert route in (0, 1) and q >= 1 and smem <= SMEM_MAX


@pytest.mark.parametrize("nmax, aligned", ((321, True), (320, False)))
def test_k4_unaligned_factor_takes_route_1(nmax, aligned):
    """The blocked sweep copies L's rows 16 bytes at a time: an odd nmax or
    an L not 16-byte aligned takes the warp chain, with the design before's
    candidates a block and shared memory."""
    q = fused._sweep_queries_per_block(nmax, 8, 0)
    for nq in (1, 4096):
        assert fused.kriging_believer_fill_plan(
            224, nmax, 8, nq, aligned=aligned) == \
            (1, q, 8 * (8 + q * 8 + q * nmax))


@pytest.mark.parametrize("d", (2, 8, 32))
def test_k4_large_n_route_keeps_the_range(d):
    """Route 1 takes every nmax the warp-per-candidate design took (its
    candidates a block from _sweep_queries_per_block) and raises where it
    did."""
    nmax = 1024
    while True:
        try:
            q = fused._sweep_queries_per_block(nmax, d, 0)
        except ValueError:
            break
        assert fused.kriging_believer_fill_plan(nmax - 8, nmax, d, 4096) \
            == (1, q, 8 * (d + q * d + q * nmax))
        nmax += 1024
    with pytest.raises(ValueError, match="shared memory"):
        fused.kriging_believer_fill_plan(nmax - 8, nmax, d, 4096)


@pytest.mark.parametrize("B, adapt, blocks, chains, groups, warps", (
    (1, False, 1, 1, 1, 8), (1, True, 1, 1, 1, 8),
    (16, False, 16, 1, 1, 8), (16, True, 16, 1, 1, 8),
    (17, False, 17, 1, 1, 8), (17, True, 16, 2, 2, 8),
    (64, True, 16, 4, 4, 4), (3, True, 4, 1, 1, 8),
    (200, False, 100, 2, 2, 8), (200, True, 16, 13, 13, 1),
    (1000, True, 16, 63, 16, 1)))
def test_k12_geometry(B, adapt, blocks, chains, groups, warps):
    """The sampling phase spreads the chains a block each up to 128
    blocks; the warm-up's cluster is the smallest power of two of blocks
    at or above B, at most 16; a block's groups are its chains, at most 16
    warps; at path d's n = 224 (+ 8 support vectors) a chain takes 8 warps
    while its block's chains fit."""
    g = fused.mcmc_chains_plan(B, 224, 8, 8, adapt=adapt)
    assert (g["blocks"], g["chains"], g["groups"], g["warps"]) == \
        (blocks, chains, groups, warps)
    assert g["threads"] == 32 * groups * warps and g["smem"] <= SMEM_MAX
    # every chain has a block: b % blocks, slot b // blocks < chains
    assert max(b // blocks for b in range(B)) < chains


def test_k12_cluster_edge():
    """The warm-up's cluster at its edges: 8 chains on 8 blocks (the
    portable size), 9 on 16 (the non-portable size), path d's 16 on 16
    blocks of 1, 17 on 16 with the fullest holding 2, 64 on 16 of 4; the
    sampling phase runs a block a chain."""
    plan = fused.mcmc_chains_plan
    for B, want in ((8, (8, 1)), (9, (16, 1)), (16, (16, 1)), (17, (16, 2)),
                    (64, (16, 4))):
        g = plan(B, 224, 0, 8, adapt=True)
        assert (g["blocks"], g["chains"]) == want
        assert plan(B, 224, 0, 8, adapt=False)["blocks"] == B


@pytest.mark.parametrize("rows, warps", (
    (0, 1), (32, 1), (33, 2), (64, 2), (65, 4), (128, 4), (129, 8),
    (232, 8), (4008, 8), (100000, 8)))
def test_k12_warps_per_chain(rows, warps):
    """Warps a chain from the rows an evaluation sums (n + nsv): a lane
    sums about one, up to 8 warps, while the block's chains all run at
    once in 16 warps (4 chains: at most 4 warps each; 16: one); a block
    holds at most 16 warps (its named barriers, one a group of W > 1, fit
    the 15 ids)."""
    for n, nsv in ((rows, 0), (rows - rows // 4, rows // 4)):
        for B, adapt, most in ((16, False, 8), (16, True, 8), (64, True, 4),
                               (256, True, 1)):
            g = fused.mcmc_chains_plan(B, n, nsv, 8, adapt=adapt)
            assert g["warps"] == min(warps, most)
            assert g["groups"] * g["warps"] <= 16


@pytest.mark.parametrize("spec", (False, True))
def test_k12_takes_the_former_range(spec):
    """Every (B, d) in the range of the design before this one (one block,
    a warp a chain: mcmc_chains_min_smem within 227 KB) gets a plan in both
    phases, within a block's shared memory and 16 warps; the
    first d past the range at B = 1 and 32 is refused by the gate."""
    for d in (1, 2, 8, 16, 32, 64, 80, 100, 119, 120, 140, 163):
        sd = spec_doubles(d) if spec else 0
        for B in (1, 2, 16, 17, 32, 64, 1000, 20000):
            if fused.mcmc_chains_min_smem(B, d, sd) > SMEM_MAX:
                continue
            for n, nsv in ((224, 8), (4000, 0), (1100, 1152)):
                for adapt in (False, True):
                    g = fused.mcmc_chains_plan(B, n, nsv, d, sd, adapt=adapt)
                    assert g is not None, (d, B, n, adapt)
                    assert g["smem"] <= SMEM_MAX
                    assert g["threads"] <= 512
    for B in (1, 32):
        d = 1
        while fused.mcmc_chains_min_smem(B, d, 0) <= SMEM_MAX:
            d += 1
        assert d == (164 if B == 1 else 126)


def test_k12_stages_as_before():
    """The surrogate's staging at the card tests' shapes beyond shared
    memory (d = 16, 32 chains): the support vectors in global memory at n =
    1,100 with 1,152 of them, X / l too at n = 1,800; all of it in shared
    memory at path d's shape."""
    for adapt in (False, True):
        assert fused.mcmc_chains_plan(32, 1100, 1152, 16,
                                      adapt=adapt)["stage"] == 1
        assert fused.mcmc_chains_plan(32, 1800, 8, 16,
                                      adapt=adapt)["stage"] == 2
        assert fused.mcmc_chains_plan(16, 224, 8, 8,
                                      adapt=adapt)["stage"] == 0
