"""
K8's and K9's host-side plans at the widths of the d <= 64 instance
(``fused.meanstd_grad_plan``, the mirror of csrc/meanstd_grad.cu k8_plan;
``fused.lbfgs_logexp_ascent_plan``, of csrc/lbfgs_logexp_ascent.cu
k9_route; the card tests hold each to its C side) and the Runner's range
check (``fused.check_lbfgs_range``) on the CPU: the default budget 70
d^1.5 falls to a route of both at every d up to 48, both reach the fit's
(K11's) last n, their routes' edges fall where the docstrings put them,
and d = 65 is refused.
"""

import pytest

from gpry_tpu_torch import config
from gpry_tpu_torch.ops import fused

from test_torch_k2_plan import spec_doubles
from test_torch_lbfgs_reuse import last_n

SMEM_MAX = 227 * 1024


def budget(d):
    return int(70 * d ** 1.5)


def k11_last(d):
    """The fit's last n at d (a fast family: 1 + d theta entries)."""
    return last_n(lambda n: fused.lbfgs_lml_fit_plan(n, d, 1 + d, 0))


def first_of(plan, route, hi=200_000):
    """The first n that ``plan`` sends to ``route`` or beyond (bisection;
    the routes grow with n)."""
    lo = 1
    while hi - lo > 1:
        mid = (lo + hi) // 2
        if plan(mid)[0] >= route:
            hi = mid
        else:
            lo = mid
    return hi


@pytest.mark.parametrize("d", range(2, 49))
def test_default_budget_fits_k8_and_k9(d):
    """At every d in 2-48 the default budget takes a route of K9 and of K8
    (at one query, an even and an odd nmax), fast family and ALL_NODES,
    within a block's shared memory."""
    n = budget(d)
    for sd in (0, spec_doubles(d)):
        route, _, smem = fused.lbfgs_logexp_ascent_plan(n, d, sd)
        assert route in (0, 1, 2, 3) and 0 < smem <= SMEM_MAX
        for nmax in (n + n % 2, n | 1):
            route, q, smem = fused.meanstd_grad_plan(n, nmax, d, 1, sd)
            assert route in (0, 1, 2) and 0 < smem <= SMEM_MAX


@pytest.mark.parametrize("d", (32, 40, 48))
def test_k8_and_k9_reach_the_fits_last_n(d):
    """K9 and K8 take K11's last n at d (route 3 and route 2: the
    n-vectors in global memory), fast family and ALL_NODES; at d = 32 K9
    took 12,756 and K8 14,284 rows before."""
    top = k11_last(d)
    assert top >= budget(d)
    for sd in (0, spec_doubles(d)):
        assert fused.lbfgs_logexp_ascent_plan(top, d, sd)[0] == 3
        assert fused.meanstd_grad_plan(top, top + top % 2, d, 1, sd)[:2] == \
            (2, 1)
    if d == 32:
        assert top > 14_284 > 12_756


def test_d_65_is_refused():
    """Both plans and the Runner's check raise ValueError at d = 65, at
    any n."""
    d = fused.GRAD_MAX_D + 1
    for n in (1, 224):
        with pytest.raises(ValueError, match="d=65 > 64"):
            fused.lbfgs_logexp_ascent_plan(n, d)
        with pytest.raises(ValueError, match="d=65 > 64"):
            fused.meanstd_grad_plan(n, config.bucket_size(n), d, 8)
        with pytest.raises(ValueError, match="d=65 > 64"):
            fused.check_lbfgs_range("rbf", d, n)


@pytest.mark.parametrize("d,edges", (
    (8, (235, 12180, 13236)), (32, (231, 11700, 12756)),
    (40, (229, 11540, 12596))))
def test_k9_route_edges(d, edges):
    """K9's last n of routes 0, 1 and 2 (csrc/lbfgs_logexp_ascent.cu and
    the planner's docstring: 235, 12,180 and 13,236 at d = 8; route 2 to
    12,756 at d = 32 and 12,596 at d = 40), route 3 from the next n; X
    staged on route 0 up to 227 at d = 8; route 3 alone keeps nothing of n
    in shared memory."""
    plan = lambda n: fused.lbfgs_logexp_ascent_plan(n, d)
    for route, last in enumerate(edges):
        assert plan(last)[0] == route
        assert plan(last + 1)[0] == route + 1
        assert first_of(plan, route + 1) == last + 1
    if d == 8:
        assert plan(227)[:2] == (0, 1) and plan(228)[:2] == (0, 0)
    s3 = {plan(n)[2] for n in (edges[2] + 1, 20_000, 10 ** 6)}
    assert len(s3) == 1 and plan(edges[2] + 1)[1] == 0


@pytest.mark.parametrize("d,edge", ((8, 14464), (32, 14284), (40, 14224)))
def test_k8_route_edges(d, edge):
    """K8's route 1 (a block a query, the n-vectors in shared memory) to
    14,464 rows at d = 8 and 14,284 at d = 32 (the planner's docstring),
    route 2 from the next n at any nq; route 0 where the blocked
    substitutions fit (n <= 624-640 at one query, an even nmax)."""
    for nq in (1, 300):
        plan = lambda n: fused.meanstd_grad_plan(n, n | 1, d, nq)
        assert plan(edge)[:2] == (1, 1)
        assert plan(edge + 1)[:2] == (2, 1)
        assert first_of(plan, 2) == edge + 1
    even = lambda n: fused.meanstd_grad_plan(n, n + n % 2, d, 1)
    assert even(600)[0] == 0 and even(700)[0] == 1


@pytest.mark.parametrize("d", range(33, 49))
def test_check_passes_the_default_budget(d):
    """check_lbfgs_range (the Runner's, on the card) passes the default
    budget at d = 33-48, with and without the ascent."""
    for ascent in (True, False):
        fused.check_lbfgs_range("rbf", d, budget(d), ascent=ascent)


def test_check_refuses_d_64_with_k11s_message():
    """At d = 64 the default budget (35,840) is past K11's range (22,915):
    refused with K11's message, the ascent's kernels taking it."""
    d = 64
    assert budget(d) > k11_last(d) == 22_915
    for ascent in (True, False):
        with pytest.raises(ValueError, match="lbfgs_lml_fit: n=35840"):
            fused.check_lbfgs_range("rbf", d, budget(d), ascent=ascent)
    assert fused.lbfgs_logexp_ascent_plan(budget(d), d)[0] == 3
    assert fused.meanstd_grad_plan(budget(d), budget(d), d, 1)[0] == 2
