"""
K5's and K8's host-side plans (``fused.meanvar_ungated_plan``, the mirror
of csrc/subst_blocked.cuh sub_ungated_plan, and ``fused.meanstd_grad_plan``, of
csrc/meanstd_grad.cu k8_plan; the card tests hold each to its C side) on
the CPU: route 0 (the blocked substitutions of csrc/subst_blocked.cuh)
takes the paths' shapes, route 1 an odd nmax, an unaligned L and n beyond
shared memory, neither refuses a shape that the design before route 0
took, and K5 takes K2's queries a block.
"""

import pytest

from gpry_tpu_torch import config
from gpry_tpu_torch.ops import fused

from test_torch_k2_plan import spec_doubles

SMEM_MAX = 227 * 1024
# the paths' shapes: n = 224 valid rows of nmax = 320 at d = 8
N, NMAX, D = 224, 320, 8
K5_NQ = (1, 8, 256, 2048, 4096)
K8_NQ = (1, 32, 1024)


def k8_parent_smem(n, d, spec, stage_x, stage_v=1):
    """Shared bytes of K8's block-per-query design (csrc/common.cuh
    gpry_gp_doubles, the staged GP, plus the query's d doubles); alpha and
    the work vector in shared memory with ``stage_v`` (route 1; route 2
    keeps them in global memory)."""
    red = 4 * (2 * d + 1) + d + 1
    return 8 * (3 * d + 2 + 2 * d + red + stage_v * 2 * n
                + stage_x * d * n + spec + d)


def k8_parent_max_n(d, spec):
    """The largest n that K8's block-per-query design took: X read from
    global memory, the rest of the staged GP in shared memory."""
    n = 0
    while k8_parent_smem(n + 1, d, spec, 0) <= SMEM_MAX:
        n += 1
    return n


@pytest.mark.parametrize("spec", (False, True), ids=("rbf", "spec"))
def test_route_0_takes_the_paths(spec):
    """At the paths' shapes, fast family and ALL_NODES's program: K5 on
    route 0 at the audit's batch sizes (8 queries a block up to 1,056, 16
    above, K2's Q there), K8 at the generic ascent's and predict's (8 a
    block)."""
    sd = spec_doubles(D) if spec else 0
    for nq in K5_NQ:
        route, q, smem = fused.meanvar_ungated_plan(N, NMAX, D, nq, sd)
        assert (route, q) == (0, 8 if nq <= 1056 else 16)
        assert (route, q) == fused.gated_meanvar_logexp_plan(N, NMAX, D, nq,
                                                            sd)[:2]
        assert smem <= SMEM_MAX
    for nq in K8_NQ:
        route, q, smem = fused.meanstd_grad_plan(N, NMAX, D, nq, sd)
        assert (route, q) == (0, 8) and smem <= SMEM_MAX


@pytest.mark.parametrize("nmax, aligned", ((321, True), (320, False)))
def test_unaligned_factor_takes_route_1(nmax, aligned):
    """Route 0 copies L's rows 16 bytes at a time: an odd nmax, or L's data
    not 16-byte aligned, takes route 1 at the paths' n (K5 with the
    chain's queries a block, K8 a block a query, X staged)."""
    q = fused._sweep_queries_per_block(nmax, D, 0)
    for nq in K5_NQ:
        assert fused.meanvar_ungated_plan(
            N, nmax, D, nq, aligned=aligned)[:2] == (1, q)
    for nq in K8_NQ:
        assert fused.meanstd_grad_plan(N, nmax, D, nq, aligned=aligned) \
            == (1, 1, k8_parent_smem(N, D, 0, 1))


@pytest.mark.parametrize("spec", (False, True), ids=("rbf", "spec"))
def test_route_1_beyond_shared_memory(spec):
    """Route 0 up to the n whose panels, V and queries fit in shared
    memory (n = 640 at d = 8 for a fast family), route 1 from the next n,
    at one query and at the screen's 4,096."""
    sd = spec_doubles(D) if spec else 0
    for nq in (1, 4096):
        n = 16
        while fused.meanvar_ungated_plan(n + 1, 2048, D, nq, sd)[0] == 0:
            n += 1
        if not spec and nq == 1:
            assert n == 640
        for plan in (fused.meanvar_ungated_plan, fused.meanstd_grad_plan):
            assert plan(n, 2048, D, nq, sd)[0] == 0
            assert plan(n + 1, 2048, D, nq, sd)[0] == 1


@pytest.mark.parametrize("d", (2, 8, 32))
def test_k5_keeps_the_chain_range(d):
    """K5 takes every nmax that its warp-per-query design took (route 1 at
    n = nmax, the queries a block of _sweep_queries_per_block), and raises
    where that did."""
    nmax = 1024
    while True:
        try:
            q = fused._sweep_queries_per_block(nmax, d, 0)
        except ValueError:
            break
        assert fused.meanvar_ungated_plan(nmax, nmax, d, 64)[:2] == (1, q)
        nmax += 1024
    with pytest.raises(ValueError, match="shared memory"):
        fused.meanvar_ungated_plan(nmax, nmax, d, 64)


@pytest.mark.parametrize("d", (1, 2, 8, 16, 32, fused.GRAD_MAX_D))
def test_k8_keeps_the_block_range(d):
    """K8 takes every n up to the largest that its block-per-query design
    took (X staged in shared memory while it fits, then read from global
    memory), at every d up to GRAD_MAX_D, fast family and ALL_NODES's
    program; one row beyond, route 2 (the same design with alpha and the
    work vector in global memory) takes it, and above GRAD_MAX_D it raises
    ValueError."""
    for sd in (0, spec_doubles(d)):
        top = k8_parent_max_n(d, sd)
        for n in (1, 224, 641, 1100, 1800, top // 2, top):
            if n > top:
                continue
            route, q, smem = fused.meanstd_grad_plan(n, config.bucket_size(
                n), d, 300, sd)
            assert smem <= SMEM_MAX and route in (0, 1)
            if route == 1:
                stage_x = int(k8_parent_smem(n, d, sd, 1) <= SMEM_MAX)
                assert (q, smem) == (1, k8_parent_smem(n, d, sd, stage_x))
        route, q, smem = fused.meanstd_grad_plan(
            top + 1, config.bucket_size(top + 1), d, 300, sd)
        stage_x = int(k8_parent_smem(top + 1, d, sd, 1, 0) <= SMEM_MAX)
        assert (route, q, smem) == (2, 1, k8_parent_smem(top + 1, d, sd,
                                                         stage_x, 0))
    with pytest.raises(ValueError, match="per-thread"):
        fused.meanstd_grad_plan(N, NMAX, fused.GRAD_MAX_D + 1, 8)


@pytest.mark.parametrize("d", (2, 8, 32))
def test_k5_takes_k2s_queries_a_block(d):
    """K5's Q is K2's wherever K2 takes route 0 at its batch size's Q (so
    the two solve with the same k-split, bit for bit), and never fewer;
    K8's route 0 is K5's (the same Q and shared memory)."""
    for sd in (0, spec_doubles(d)):
        for nq in (1, 8, 256, 1056, 1057, 2048, 4096, 4224, 4225, 65536):
            full = 32 if nq > 4224 else 16 if nq > 1056 else 8
            for n in (1, 15, 16, 17, 64, 224, 320, 500, 640):
                nmax = config.bucket_size(n)
                r2, q2, _ = fused.gated_meanvar_logexp_plan(n, nmax, d, nq,
                                                            sd)
                r5, q5, s5 = fused.meanvar_ungated_plan(n, nmax, d, nq, sd)
                if r2 == 0 and q2 == full:
                    assert (r5, q5) == (0, q2)
                if r2 == 0:
                    assert r5 == 0 and q5 >= q2
                if d <= fused.GRAD_MAX_D and r5 == 0:
                    assert fused.meanstd_grad_plan(n, nmax, d, nq, sd) == \
                        (0, q5, s5)
