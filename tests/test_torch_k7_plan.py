"""
K7's host-side plan (``fused.predict_meancov_plan``, the mirror of
csrc/predict_meancov.cu k7_plan; the card test
``test_predict_meancov_plan_matches_the_kernel`` holds the two to the same
numbers) on the CPU: the solve takes K5's route and queries a block at
every batch size (so diag(cov) is K5's sigma^2 bit for bit), an odd nmax
or an unaligned L takes route 1, V's rows are padded to whole 16-double
panels, the product launches the lower 32 x 32 tiles, and no shape that
the design before it took is refused.
"""

import pytest

from gpry_tpu_torch import config
from gpry_tpu_torch.ops import fused

from test_torch_k2_plan import spec_doubles

SMEM_MAX = 227 * 1024
# the paths' shapes: n = 224 valid rows of nmax = 320 at d = 8
N, NMAX, D = 224, 320, 8


def parent_takes(n, nmax, d, sd):
    """Whether the design before the tensor-core product took the shape:
    its solve by K5's rule (route 0, else the chain, whose queries a block
    raise beyond shared memory) and its product's 32 x 32 tiles (ls, the
    tile's points, two 32 x 33 chunks of V, the spec program)."""
    try:
        fused.meanvar_ungated_plan(n, nmax, d, 64, sd)
    except ValueError:
        return False
    return 8 * (d + 64 * d + 2 * 32 * 33 + sd) <= SMEM_MAX


@pytest.mark.parametrize("spec", (False, True), ids=("rbf", "spec"))
def test_solve_takes_k5s_route_and_queries(spec):
    """At the paths' shape, every nq from 1 to 4,096: route 0 with K5's Q
    (8 queries a block up to 1,056, 16 above), within shared memory."""
    sd = spec_doubles(D) if spec else 0
    for nq in range(1, 4097):
        route, q, smem, _, _, smem_b = fused.predict_meancov_plan(
            N, NMAX, D, nq, sd)
        assert (route, q) == (0, 8 if nq <= 1056 else 16)
        assert (route, q, smem) == fused.meanvar_ungated_plan(N, NMAX, D,
                                                              nq, sd)
        assert max(smem, smem_b) <= SMEM_MAX


@pytest.mark.parametrize("nmax, aligned", ((321, True), (320, False)))
def test_unaligned_factor_takes_route_1(nmax, aligned):
    """Route 0 copies L's rows 16 bytes at a time: an odd nmax, or L's data
    not 16-byte aligned, takes the chain with its queries a block, as
    K5 does."""
    for spec in (0, spec_doubles(D)):
        q = fused._sweep_queries_per_block(nmax, D, spec)
        for nq in (1, 64, 1024, 4096):
            plan = fused.predict_meancov_plan(N, nmax, D, nq, spec,
                                              aligned=aligned)
            assert plan[:3] == (1, q, 8 * (D + q * D + q * N + spec))
            assert plan[:3] == fused.meanvar_ungated_plan(
                N, nmax, D, nq, spec, aligned=aligned)


@pytest.mark.parametrize("n", (0, 1, 15, 16, 17, 223, 224, 225))
def test_v_rows_and_tiles(n):
    """V's rows hold n rounded up to 16 doubles (whole 128-byte rows, so
    the product's cp.async copies stay 16-byte aligned and its k loop has
    no ragged edge); the product launches nt (nt + 1) / 2 tiles, nt the
    32-query tiles across nq."""
    for nq, tiles in ((1, 1), (32, 1), (33, 3), (63, 3), (64, 3), (65, 6),
                      (1000, 528), (1024, 528), (1025, 561)):
        _, _, _, ldv, nt, _ = fused.predict_meancov_plan(
            n, config.bucket_size(max(n, 1)), D, nq)
        assert ldv % 16 == 0 and n <= ldv < n + 16
        assert nt == tiles


@pytest.mark.parametrize("d", (2, 3, 4, 8, 16, 24, 32))
def test_takes_every_shape_the_parent_took(d):
    """No shape that the design before it took is refused, up to a default
    Runner's budget n = 70 d^1.5, fast family and ALL_NODES's program; both
    kernels within a block's shared memory."""
    top = int(70 * d ** 1.5)
    for sd in (0, spec_doubles(d)):
        for n in sorted({1, 16, 17, 224, 640, 641, top // 2, top}):
            if n > top:
                continue
            nmax = config.bucket_size(n)
            assert parent_takes(n, nmax, d, sd)
            for nq in (1, 64, 1024, 4096):
                route, q, smem, _, _, smem_b = fused.predict_meancov_plan(
                    n, nmax, d, nq, sd)
                assert route in (0, 1) and q >= 1
                assert max(smem, smem_b) <= SMEM_MAX


def test_refuses_tile_points_beyond_shared_memory():
    """The product stages its tile's 64 points: it takes d up to the
    nested sampler's range (CHAINS_MAX_D) and well beyond, and raises
    ValueError from the first d whose points do not fit."""
    d = fused.CHAINS_MAX_D
    while True:
        try:
            fused.predict_meancov_plan(N, NMAX, d + 1, 64)
        except ValueError as e:
            assert "shared memory" in str(e)
            break
        d += 1
    assert d >= 2 * fused.CHAINS_MAX_D
    assert fused.predict_meancov_plan(N, NMAX, d, 64)[5] <= SMEM_MAX
