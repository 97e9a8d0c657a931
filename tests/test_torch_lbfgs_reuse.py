"""
What K9's and K11's reuse of an accepted line-search probe rests on, and
the shared-memory routes of the two kernels, on the CPU.

K9 (csrc/lbfgs_logexp_ascent.cu) and K11 (csrc/lbfgs_lml_fit.cu) compute a
probe's value once and, when the probe passes, take the gradient at that
point from what the probe left (K11: the factor, z and log det; K9: k and
L^-1 k).  That is exact only if the value part of the reference's
value-and-gradient call equals its value-only probe bit for bit.  The
plain versions (ops/fused.py) are held to it here: their value with and
without autograd, and, over a short run of each plain solver
(ops/lbfgs.py, unchanged), every accepted probe's f against the next
value-and-gradient call's f, read by wrapping the objective the solver is
given.  A failed line search (t = 0) evaluates at u + 0 d = u: its f is the
one the lane holds.

The route planners (``fused.lbfgs_logexp_ascent_plan``,
``fused.lbfgs_lml_fit_plan``, ``fused.lml_value_grad_plan``) mirror the
kernels' own sizing (``k9_route``, ``lml_route``, ``k10_route``); the card
tests hold the two to the same numbers.
"""

import copy

import numpy as np
import pytest
import torch

from gpry_tpu_torch import config
from gpry_tpu_torch.models.gp import SurrogateParams
from gpry_tpu_torch.models.classifier import MODE_ALL_FINITE, \
    trivial_svm_params
from gpry_tpu_torch.ops import fused
from gpry_tpu_torch.ops.kernels import build_kernel_spec
from gpry_tpu_torch.ops.linalg import factorize

config.set_device("cpu")
# tiny shapes: one intra-op thread, so that parallel test workers do
# not oversubscribe the cores
torch.set_num_threads(1)
D = 3
FAST = ("rbf", "matern12", "matern32", "matern52")
# every node kind (tests/test_torch_cuda.py's all_nodes at d = 3)
ALL_NODES = {"Sum": [
    {"Product": [{"ConstantKernel": {"constant_value": 1.3}},
                 {"Exponentiation": {"kernel": {"Matern": {
                     "nu": 2.5, "length_scale": [0.6] * D}},
                     "exponent": 2.0}}]},
    {"Sum": [{"Product": [{"ConstantKernel": {"constant_value": 0.5}},
                          {"RationalQuadratic": {"alpha": 1.5,
                                                 "length_scale": 0.7}}]},
             {"Sum": [{"ExpSineSquared": {"length_scale": 1.0,
                                          "periodicity": 3.0}},
                      {"Sum": [{"DotProduct": {"sigma_0": 0.3}},
                               {"WhiteKernel": {"noise_level": 1e-3}}]}
                      ]}]}]}
FAMILIES = FAST + ("all_nodes",)


def T(a):
    return torch.as_tensor(np.asarray(a, dtype=float), dtype=torch.float64)


def kernel_and_theta(name):
    if name == "all_nodes":
        spec, theta0, _ = build_kernel_spec(ALL_NODES, D)
        return spec, np.asarray(theta0)
    return name, np.log([1.3] + [0.4] * D)


def fit_problem(name, n=30, nmax=40, lanes=4, seed=0, y_scale=1.0):
    """K11's arguments: padded data (a smooth target, times ``y_scale``),
    a per-row noise and ``lanes`` starts in a box of +-2 about the family's
    theta, lane 0 at it."""
    rng = np.random.default_rng(seed)
    X, y = np.zeros((nmax, D)), np.zeros(nmax)
    X[:n] = rng.uniform(0, 1, (n, D))
    y[:n] = y_scale * np.sin(3 * X[:n]).sum(1)
    fam, theta = kernel_and_theta(name)
    th0 = rng.uniform(theta - 2.0, theta + 2.0, (lanes, len(theta)))
    th0[0] = theta
    nv = rng.uniform(1e-5, 1e-3, nmax)
    return (fam, T(X), T(y), n, T(nv), T(th0), T(theta - 2.0),
            T(theta + 2.0))


def surrogate(name, n=30, nmax=40, seed=0, y_scale=2.0):
    """A small ungated surrogate (K9 runs on the smooth one) with no upper
    clip."""
    rng = np.random.default_rng(seed)
    X, y = np.zeros((nmax, D)), np.zeros(nmax)
    X[:n] = rng.uniform(0, 1, (n, D))
    y[:n] = np.sin(4 * X[:n]).sum(1)
    fam, theta = kernel_and_theta(name)
    L, alpha = factorize(fam, T(theta), T(X), T(y), n, T(1e-4))
    svm = trivial_svm_params(D, 4, torch.float64, torch.device("cpu"),
                             MODE_ALL_FINITE)
    p = SurrogateParams(
        theta=T(theta), X=T(X), y=T(y), n=n, noise_var=T(1e-4), L=L,
        alpha=alpha, x_loc=T(np.full(D, -1.0)), x_scale=T(np.full(D, 2.0)),
        y_loc=T(-1.0), y_scale=T(y_scale), y_max=T(0.5), clip_max=T(np.inf),
        svm=svm, trust_lo=T(np.full(D, -np.inf)),
        trust_hi=T(np.full(D, np.inf)))
    x0s = np.random.default_rng(seed + 1).uniform(-1, 1, (4, D))
    x0s[0] = p.X[n - 1].numpy() * 2.0 - 1.0
    return fam, p, T(x0s), T(np.full(D, -1.0)), T(np.full(D, 1.0))


@pytest.fixture
def recorder(monkeypatch):
    """Wrap the objective each plain solver hands to
    minimize_lbfgs_bounded: ``rec["fun"]`` is the objective, ``rec["calls"]``
    every call in order as (value-and-gradient call?, X, f)."""
    rec = {"calls": []}
    real = fused.minimize_lbfgs_bounded

    def spy(fun, x0, lo, hi, **kw):
        def wrapped(X):
            f = fun(X)
            rec["calls"].append((X.requires_grad, X.detach().clone(),
                                 f.detach().clone()))
            return f

        rec["fun"] = fun
        return real(wrapped, x0, lo, hi, **kw)

    monkeypatch.setattr(fused, "minimize_lbfgs_bounded", spy)
    return rec


def bits(t):
    return t.contiguous().view(torch.int64)


def held_f_of_every_gradient_call(calls):
    """For every value-and-gradient call after the first and every lane:
    the latest earlier call at the same point (bit for bit) must have given
    the same f, bit for bit.  Returns how many lanes matched a probe (an
    accepted one) and how many a value-and-gradient call (a failed search:
    t = 0)."""
    from_probe = from_vg = 0
    for i, (grad, X, f) in enumerate(calls):
        if not grad or i == 0:
            continue
        for r in range(X.shape[0]):
            for j in range(i - 1, -1, -1):
                g_j, X_j, f_j = calls[j]
                if torch.equal(bits(X_j[r]), bits(X[r])):
                    assert torch.equal(bits(f_j[r]), bits(f[r])), \
                        f"call {i} lane {r}: f {float(f[r])!r} against " \
                        f"{float(f_j[r])!r} at the same point"
                    if g_j:
                        from_vg += 1
                    else:
                        from_probe += 1
                    break
            else:
                raise AssertionError(f"call {i} lane {r}: no earlier call "
                                     "at this point")
    return from_probe, from_vg


@pytest.mark.parametrize("name", FAMILIES)
def test_lml_value_equals_the_gradient_calls_value(name):
    """K11's objective: the LML of lml_value_grad_plain without the
    gradient equals the value of its gradient mode bit for bit (scalar and
    per-row noise, with and without jitter)."""
    fam, X, y, n, nv, th0, _, _ = fit_problem(name, lanes=6)
    for noise in (nv, T(1e-4)):
        for rel_jitter in (0.0, 1e-6):
            v = fused.lml_value_grad_plain(fam, th0, X, y, n, noise,
                                           rel_jitter)
            vg, g = fused.lml_value_grad_plain(fam, th0, X, y, n, noise,
                                               rel_jitter, grad=True)
            assert bool(torch.isfinite(v).all())
            assert torch.equal(bits(v), bits(vg))


@pytest.mark.parametrize("name", FAMILIES)
def test_logexp_value_equals_the_gradient_calls_value(name, recorder):
    """K9's objective, the negated LogExp the plain ascent minimizes:
    under no_grad it equals its value under autograd bit for bit, at the
    starts (lane 0 on a training point) and at random points of the box."""
    fam, p, x0s, lo, hi = surrogate(name)
    fused.lbfgs_logexp_ascent_plain(fam, p, D ** -0.85, 0.01, x0s, lo, hi,
                                    maxiter=1)
    fun = recorder["fun"]
    X = torch.cat([x0s, T(np.random.default_rng(5).uniform(-1, 1,
                                                            (16, D)))])
    with torch.no_grad():
        f = fun(X)
    with torch.enable_grad():
        fg = fun(X.clone().requires_grad_(True))
    assert bool(torch.isfinite(f).all())
    assert torch.equal(bits(f), bits(fg.detach()))


@pytest.mark.parametrize("name", FAMILIES)
def test_fit_accepted_probe_is_the_next_value(name, recorder):
    """Over 3 iterations of K11's plain solver, every accepted probe's f
    equals the next value-and-gradient call's f bit for bit (the call K11
    now answers from the probe's factor)."""
    args = fit_problem(name)
    fused.lbfgs_lml_fit_plain(*args, maxiter=3)
    from_probe, _ = held_f_of_every_gradient_call(recorder["calls"])
    assert from_probe > 0


@pytest.mark.parametrize("name", FAMILIES)
def test_ascent_accepted_probe_is_the_next_value(name, recorder):
    """Over 3 iterations of K9's plain solver, every accepted probe's f
    equals the next value-and-gradient call's f bit for bit (the call K9
    now answers from the probe's k and L^-1 k)."""
    fam, p, x0s, lo, hi = surrogate(name)
    fused.lbfgs_logexp_ascent_plain(fam, p, D ** -0.85, 0.01, x0s, lo, hi,
                                    maxiter=3)
    from_probe, _ = held_f_of_every_gradient_call(recorder["calls"])
    assert from_probe > 0


@pytest.mark.parametrize("solver", ("fit", "ascent"))
def test_failed_search_keeps_the_held_value(solver, recorder):
    """A line search that runs out (a gradient so large that even the 18th
    halving overshoots: y times 1e6 for the fit, y_scale 1e12 for the
    ascent) sets t = 0; the value-and-gradient call at u + 0 d is at u,
    and its f is the one the lane held, bit for bit.  Every lane stops
    there after 1 + 19 evaluations."""
    if solver == "fit":
        args = fit_problem("rbf", y_scale=1e6)
        _, f, nev, iters = fused.lbfgs_lml_fit_plain(*args, maxiter=3,
                                                     return_iters=True)
        assert iters.tolist() == [1] * len(iters)
    else:
        fam, p, x0s, lo, hi = surrogate("rbf", y_scale=2e12)
        _, f, nev = fused.lbfgs_logexp_ascent_plain(
            fam, p, D ** -0.85, 0.01, x0s, lo, hi, maxiter=3)
    assert nev.tolist() == [1 + 18 + 1] * len(nev)
    from_probe, from_vg = held_f_of_every_gradient_call(recorder["calls"])
    assert from_probe == 0 and from_vg == len(nev)


# The largest n of each route at d = 8 (fast family), as the headers of
# csrc/lbfgs_logexp_ascent.cu and csrc/lbfgs_lml_fit.cu state them: K9
# stages L (route 0) up to 235 (with X up to 227) and streams it through 4
# stages (route 1) up to 12,180 and through 2 (route 2) up to 13,236, then
# through 4 with its n-vectors in global memory (route 3) at every n; K11
# keeps the bordered triangle in shared memory up to 236 (with X up to
# 229) and in global memory up to 24,539.
K9_EDGES_D8 = {"route0": 235, "stage_x": 227, "route1": 12180,
               "route2": 13236}
K11_EDGES_D8 = {"route0": 236, "stage_x": 229, "route1": 24539}
# K10 (csrc/lml_value_grad.cu) runs K11's evaluation without a lane's
# state: a fast family's route 0 up to n = 237, route 1 up to n = 24,807
# at d = 8; a spec program's route 1 from n = 160 on (K10_ROUTE1_N)
K10_EDGES_D8 = {"route0": 237, "route1": 24807, "spec_route1": 160}
SMEM_MAX = 232448


def spec_doubles(nodes, p):
    return 2 * nodes + 2 * p if nodes else 0


# (d, spec nodes, theta entries): fast families at d = 2, 8, 32; ALL_NODES
# at d = 8 (14 nodes, 16 entries); a tree of SPEC_MAX_NODES nodes (16
# ARD leaves at d = 8: 16 x 9 entries)
PLAN_CASES = [(2, 0, 3), (8, 0, 9), (32, 0, 33), (8, 14, 16),
              (8, fused.SPEC_MAX_NODES, 16 * 9)]


def walk_routes(plan, stop=None):
    """Plan n = 1, 2, ... until ValueError (or up to ``stop``, exclusive);
    returns the largest n of each route, per n the plan, and the first n
    not planned."""
    last, plans, n = {}, {}, 1
    while n != stop:
        try:
            out = plan(n)
        except ValueError:
            break
        plans[n] = out
        last[out[0]] = n
        n += 1
    return last, plans, n


def last_n(plan):
    """The largest n that ``plan`` takes (it takes 1 .. last_n and raises
    ValueError above), by bisection."""
    lo, hi = 1, 2
    while True:
        try:
            plan(hi)
        except ValueError:
            break
        lo, hi = hi, 2 * hi
    while hi - lo > 1:
        mid = (lo + hi) // 2
        try:
            plan(mid)
            lo = mid
        except ValueError:
            hi = mid
    return lo


@pytest.mark.parametrize("d,nodes,p", PLAN_CASES)
def test_ascent_plan(d, nodes, p):
    """K9's planner for every n up to the largest that K11 (the fit) takes
    at the same d: the shared memory within the 232,448 bytes a block may
    have, route 0 (X staged first) then routes 1, 2 and 3 (L streamed, the
    n-vectors in global memory: every n), each n once; ValueError above
    GRAD_MAX_D."""
    sd = spec_doubles(nodes, p)
    top = last_n(lambda n: fused.lbfgs_lml_fit_plan(n, d, p, sd))
    last, plans, stop = walk_routes(
        lambda n: fused.lbfgs_logexp_ascent_plan(n, d, sd), top + 2)
    routes = [plans[n][0] for n in sorted(plans)]
    assert routes == sorted(routes) and set(routes) == {0, 1, 2, 3}
    assert all(0 < plans[n][2] <= SMEM_MAX for n in plans)
    staged_x = [n for n in plans if plans[n][0] == 0 and plans[n][1] == 1]
    assert staged_x == list(range(1, len(staged_x) + 1))
    assert stop == top + 2 == last[3] + 1
    with pytest.raises(ValueError, match="per-thread"):
        fused.lbfgs_logexp_ascent_plan(1, fused.GRAD_MAX_D + 1, sd)
    if (d, nodes) == (8, 0):
        assert last[0] == K9_EDGES_D8["route0"]
        assert max(staged_x) == K9_EDGES_D8["stage_x"]
        assert last[1] == K9_EDGES_D8["route1"]
        assert last[2] == K9_EDGES_D8["route2"]


@pytest.mark.parametrize("d,nodes,p", PLAN_CASES)
def test_fit_plan(d, nodes, p):
    """K11's planner for every n up to the largest it takes: the shared
    memory within the 232,448 bytes a block may have, route 0 (X staged
    first) then route 1 (whose global workspace holds the bordered
    triangle), each n once; ValueError just past the last."""
    last, plans, stop = walk_routes(
        lambda n: fused.lbfgs_lml_fit_plan(n, d, p, spec_doubles(nodes, p)))
    routes = [plans[n][0] for n in sorted(plans)]
    assert routes == sorted(routes) and set(routes) == {0, 1}
    assert all(0 < plans[n][2] <= SMEM_MAX for n in plans)
    for n, (route, _, _, work) in plans.items():
        tri = (n + 1) * (n + 2) // 2
        assert work == d * n + (tri if route == 1 else 0)
    staged_x = [n for n in plans if plans[n][0] == 0 and plans[n][1] == 1]
    assert staged_x == list(range(1, len(staged_x) + 1))
    assert stop == last[1] + 1
    with pytest.raises(ValueError):
        fused.lbfgs_lml_fit_plan(stop, d, p, spec_doubles(nodes, p))
    if (d, nodes) == (8, 0):
        assert last[0] == K11_EDGES_D8["route0"]
        assert max(staged_x) == K11_EDGES_D8["stage_x"]
        assert last[1] == K11_EDGES_D8["route1"]


@pytest.mark.parametrize("d,nodes,p", PLAN_CASES)
def test_lml_value_grad_plan(d, nodes, p):
    """K10's planner for every n up to the largest it takes: route 0 where
    its triangle fits (a spec program's below n = 160), route 1 from there
    on, the shared memory within the 232,448 bytes a block may have, each n
    once, at least K11's range; ValueError just past the last n."""
    sd = spec_doubles(nodes, p)
    last, plans, stop = walk_routes(
        lambda n: fused.lml_value_grad_plan(n, d, sd))
    routes = [plans[n][0] for n in sorted(plans)]
    edge = 160 if nodes else last[0] + 1
    assert routes == [0] * (edge - 1) + [1] * (stop - edge)
    assert all(0 < plans[n][2] <= SMEM_MAX for n in plans)
    for n, (route, _, _, work) in plans.items():
        tri = (n + 1) * (n + 2) // 2
        assert work == d * n + (tri if route == 1 else 0)
    k11_last = max(walk_routes(
        lambda n: fused.lbfgs_lml_fit_plan(n, d, p, sd))[0].values())
    assert last[1] >= k11_last
    with pytest.raises(ValueError, match="exceeds"):
        fused.lml_value_grad_plan(stop, d, sd)
    # a fast family leaves route 0 only where its triangle stops fitting
    assert nodes or fused._lml_fits(last[0] + 1, d, sd, 0, 0) is None
    if (d, nodes) == (8, 0):
        assert last[0] == K10_EDGES_D8["route0"]
        assert last[1] == K10_EDGES_D8["route1"]
    if (d, nodes) == (8, 14):
        assert last[0] == K10_EDGES_D8["spec_route1"] - 1


@pytest.mark.parametrize("n,route", [(224, 0), (236, 0), (237, 0),
                                     (238, 1), (K10_EDGES_D8["route1"], 1)])
def test_lml_value_grad_plan_at_the_main_path(n, route):
    """K10's route at the screen's n = 224, around K11's route-0 edge (236,
    237), at its own (237, 238) and at the last n at d = 8, fast family:
    route 0 keeps the triangle in shared memory (with X at n = 224), one
    block an SM, and ALL_NODES takes route 1 there; one past the last n
    raises."""
    assert fused.lml_value_grad_plan(n, 8)[0] == route
    if n == 224:
        route0 = fused.lml_value_grad_plan(n, 8)
        assert route0[1] == 1 and route0[2] > SMEM_MAX // 2
        assert route0[3] == 8 * n
        assert fused.lml_value_grad_plan(n, 8, spec_doubles(14, 16))[0] == 1
    if n == K10_EDGES_D8["route1"]:
        with pytest.raises(ValueError, match="exceeds"):
            fused.lml_value_grad_plan(n + 1, 8)


@pytest.mark.parametrize("d", range(1, 49))
def test_default_budget_fits_the_lbfgs_kernels(d):
    """A default Runner's budget, max_total = 70 d^1.5 training points,
    fits the fit's and the ascent's kernels (K11, K9, K8) at every d up to
    48 for a fast family, and up to 47 for ALL_NODES (check_lbfgs_range,
    which the Runner calls when it is built on the card; at d = 48 its 56
    theta entries and its program hold K11 below the budget's 23,278); one
    point past the last route of K11 (which bounds K9 and K8, whose last
    route takes every n) raises ValueError."""
    n = int(70 * d ** 1.5)
    tree = copy.deepcopy(ALL_NODES)
    tree["Sum"][0]["Product"][1]["Exponentiation"]["kernel"]["Matern"][
        "length_scale"] = [0.6] * d
    spec = build_kernel_spec(tree, d)[0]
    fused.check_lbfgs_range("matern32", d, n)
    if d < 48:
        fused.check_lbfgs_range(spec, d, n)
    else:
        with pytest.raises(ValueError, match="lbfgs_lml_fit"):
            fused.check_lbfgs_range(spec, d, n)
    stop = 1 + last_n(lambda m: fused.lbfgs_lml_fit_plan(m, d, 1 + d, 0))
    with pytest.raises(ValueError, match="exceeds"):
        fused.check_lbfgs_range("matern32", d, stop)
