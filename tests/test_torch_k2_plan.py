"""
K2's host-side plan (``fused.gated_meanvar_logexp_plan``, the mirror of
csrc/gated_meanvar_logexp.cu k2_plan; the card tests hold the two to the
same numbers) on the CPU: the blocked route takes the main path's shapes,
every default budget falls to a route, and the large-n route keeps every
nmax that the warp-per-query design took.
"""

import copy

import pytest

from gpry_tpu_torch import config
from gpry_tpu_torch.ops import fused
from gpry_tpu_torch.ops.kernels import build_kernel_spec

from test_torch_lbfgs_reuse import ALL_NODES

SMEM_MAX = 227 * 1024


def spec_doubles(d):
    """Shared doubles of ALL_NODES's program at d dimensions."""
    tree = copy.deepcopy(ALL_NODES)
    tree["Sum"][0]["Product"][1]["Exponentiation"]["kernel"]["Matern"][
        "length_scale"] = [0.6] * d
    spec, theta0, _ = build_kernel_spec(tree, d)
    return 2 * len(fused.encode_spec(spec, d)[0]) + 2 * len(theta0)


@pytest.mark.parametrize("d", (2, 4, 8, 16, 32))
def test_default_budget_fits_k2(d):
    """A default Runner's budget, n = 70 d^1.5 training points in their
    bucket, takes a route at every batch size, for a fast family and for
    ALL_NODES, within a block's shared memory; route 0 (the blocked
    substitution) up to its edge, then route 1."""
    n = int(70 * d ** 1.5)
    nmax = config.bucket_size(n)
    for spec in (0, spec_doubles(d)):
        for nq in (1, 8, 1057, 3200, 65536):
            route, q, smem = fused.gated_meanvar_logexp_plan(n, nmax, d, nq,
                                                             spec)
            assert smem <= SMEM_MAX and q >= 1
            for m in (1, 224, n):
                assert fused.gated_meanvar_logexp_plan(
                    m, nmax, d, nq, spec)[0] in (0, 1)


def test_route_0_takes_the_main_path():
    """At d = 8, n = 224 of nmax = 320 (fast family): 8 queries a block for
    the believer's one-point predict, 16 at the acquisition screen's 3,200,
    32 beyond 4,224; the blocked route up to n = 640 at 8 queries a block,
    the large-n route from 641."""
    plan = fused.gated_meanvar_logexp_plan
    assert plan(224, 320, 8, 1)[:2] == (0, 8)
    assert plan(224, 320, 8, 3200)[:2] == (0, 16)
    assert plan(224, 320, 8, 4225)[:2] == (0, 32)
    assert plan(640, 704, 8, 1)[0] == 0
    assert plan(641, 704, 8, 1)[:2] == (1, 8)


@pytest.mark.parametrize("d", (2, 8, 32))
def test_large_n_route_keeps_the_range(d):
    """Route 1 takes every nmax the warp-per-query design took (its queries
    a block from _sweep_queries_per_block), and raises where that did."""
    nmax = 1024
    while True:
        try:
            q = fused._sweep_queries_per_block(nmax, d, 0)
        except ValueError:
            break
        assert fused.gated_meanvar_logexp_plan(nmax, nmax, d, 64)[:2] \
            == (1, q)
        nmax += 1024
    with pytest.raises(ValueError, match="shared memory"):
        fused.gated_meanvar_logexp_plan(nmax, nmax, d, 64)


@pytest.mark.parametrize("nmax, aligned", ((321, True), (320, False)))
def test_unaligned_factor_takes_route_1(nmax, aligned):
    """Route 0 copies L's rows 16 bytes at a time: an odd nmax, or L's data
    not 16-byte aligned, takes route 1 at the main path's n = 224, with the
    queries a block of _sweep_queries_per_block."""
    q = fused._sweep_queries_per_block(nmax, 8, 0)
    for nq in (1, 3200):
        assert fused.gated_meanvar_logexp_plan(
            224, nmax, 8, nq, aligned=aligned)[:2] == (1, q)
