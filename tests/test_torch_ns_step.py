"""
K13's plain version (``ops.fused.ns_step_plain``, the bookkeeping of one
nested-sampling step) against gpry_tpu's ``mc/nested.py:184 _ns_segment``
on the CPU in float64, on states made with numpy: its stop flag equals
``~outer_cond`` (``seg_steps=0``) on converged, unconverged, plateaued and
full states, and after one step (``seg_steps=1``) the dead buffer, ``k``
and the killed slots are JAX's (the chains themselves differ by
generator).  The port's segmented run equals one that reads the flag after
every step.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from gpry_tpu.mc.nested import _ns_segment

from gpry_tpu_torch import config
from gpry_tpu_torch.mc import samples
from gpry_tpu_torch.mc.nested import _volume_consts, run_nested_device
from gpry_tpu_torch.ops import fused

from test_torch_ns_slice import BOUNDS, jax_surrogate, ported

config.set_device("cpu")
torch.set_num_threads(1)
NLIVE, D, B, N_PRIOR, MAX_DEAD = 48, 2, 8, 96, 400
K0 = N_PRIOR - NLIVE
TOT = K0 + MAX_DEAD
PREC = 0.01
KINDS = {
    # kind: (dead points after the prior phase, expected stop flag)
    "unconverged": (3 * B, False),
    "converged": (40 * B, True),
    "plateau": (12 * B, True),
    "room": (MAX_DEAD - B, False),
    "full": (MAX_DEAD - B + 1, True),
}


def j_logl(params, X):
    return -0.5 * jnp.sum(X ** 2, axis=-1)


def numpy_state(kind, seed):
    """(live_X, live_logl, dead_X, dead_logl, k): a live set with ties at
    its top (a clipped plateau) and a few -inf, the dead points below it
    (up to its top when the run has converged; far below where only the
    room or the plateau may stop the run)."""
    rng = np.random.default_rng(seed)
    live_X = rng.uniform(-3, 3, (NLIVE, D))
    live_l = -0.5 * np.sum(live_X ** 2, axis=1)
    top = np.argsort(live_l)[-NLIVE // 4:]
    live_l[top] = np.quantile(live_l, 0.75)
    live_l[rng.choice(NLIVE, 3, replace=False)] = -np.inf
    if kind == "plateau":
        live_l[:] = -0.75
    k = K0 + KINDS[kind][0]
    fin = live_l[np.isfinite(live_l)]
    low = -1000.0 if kind in ("plateau", "room", "full") else \
        np.max(fin) if kind == "converged" else np.min(fin) - 0.5
    dead_l = np.full(TOT, -np.inf)
    dead_l[:k] = np.sort(low - rng.exponential(2.0, k))
    dead_X = np.zeros((TOT, D))
    dead_X[:k] = rng.uniform(-3, 3, (k, D))
    return live_X, live_l, dead_X, dead_l, k


def port_state(live_X, live_l, dead_X, dead_l, k):
    lxp, lsh, H0 = _volume_consts(NLIVE, N_PRIOR, MAX_DEAD)
    t = lambda a: torch.tensor(np.asarray(a, dtype=float), dtype=torch.float64)
    st = fused.NSState(
        live_X=t(live_X), live_logl=t(live_l), dead_X=t(dead_X),
        dead_logl=t(dead_l), logx_prev=t(lxp), log_shell=t(lsh),
        count=torch.tensor([k, 500, 0, 0]),
        done=torch.zeros(1, dtype=torch.int32),
        kill=torch.arange(B), x0=t(np.zeros((B, D))), lx0=t(np.zeros(B)),
        lstar=t(0.0), chol=t(np.zeros((D, D))),
        order=torch.full((NLIVE,), -1, dtype=torch.int32))
    return st, (K0, H0, float(np.log(PREC)))


def jax_segment(state_np, seg_steps, seed=0):
    live_X, live_l, dead_X, dead_l, k = state_np
    state = (jax.random.PRNGKey(seed), jnp.asarray(live_X),
             jnp.asarray(live_l), jnp.asarray(dead_X), jnp.asarray(dead_l),
             jnp.asarray(k, jnp.int32), jnp.asarray(500, jnp.int32))
    return _ns_segment(j_logl, (), state, jnp.full(D, -3.0),
                       jnp.full(D, 3.0), jnp.asarray(PREC), nlive=NLIVE,
                       num_repeats=2, max_dead=MAX_DEAD, kill_batch=B,
                       mesh=None, n_prior=N_PRIOR, seg_steps=seg_steps)


@pytest.mark.parametrize("seed", (0, 1))
@pytest.mark.parametrize("kind", tuple(KINDS))
def test_stop_flag_matches_jax(kind, seed):
    """The plain step's stop flag is JAX's ~outer_cond on the same state;
    a stopped step changes nothing, an unstopped one makes a kill
    pending."""
    state_np = numpy_state(kind, seed)
    _, done_j = jax_segment(state_np, seg_steps=0)
    st, consts = port_state(*state_np)
    before = fused.NSState(*(t.clone() for t in st))
    starts = torch.as_tensor(np.random.default_rng(seed).integers(
        0, NLIVE - B, B))
    fused.ns_step_plain(st, before.x0, before.lx0,
                        torch.zeros(B, dtype=torch.int64), starts, *consts)
    assert bool(st.done) == bool(done_j) == KINDS[kind][1]
    assert int(st.count[3]) == (not KINDS[kind][1])
    if KINDS[kind][1]:
        for a, b in zip(st, before):
            if a is not st.done:
                assert torch.equal(a, b)


@pytest.mark.parametrize("seed", (0, 1, 2))
@pytest.mark.parametrize("kind", ("unconverged", "room"))
def test_one_step_matches_jax(kind, seed):
    """After one step, JAX's dead buffer and k equal the plain step's (the
    B worst in ascending order, ties and -inf by index, written at k), and
    JAX changed no live slot but the ones the plain step killed; lstar is
    the largest killed value and the starts are survivors above it."""
    state_np = numpy_state(kind, seed)
    (_, live_X_j, live_l_j, dead_X_j, dead_l_j, k_j, _), _ = \
        jax_segment(state_np, seg_steps=1, seed=seed)
    st, consts = port_state(*state_np)
    starts = torch.as_tensor(np.random.default_rng(seed).integers(
        0, NLIVE - B, B))
    zeros = (torch.zeros((B, D), dtype=torch.float64),
             torch.zeros(B, dtype=torch.float64),
             torch.zeros(B, dtype=torch.int64))
    fused.ns_step_plain(st, *zeros, starts, *consts)
    assert not bool(st.done) and int(st.count[3]) == 1
    np.testing.assert_array_equal(st.dead_X.numpy(), np.asarray(dead_X_j))
    np.testing.assert_array_equal(st.dead_logl.numpy(),
                                  np.asarray(dead_l_j))
    kept = np.setdiff1d(np.arange(NLIVE), st.kill.numpy())
    np.testing.assert_array_equal(np.asarray(live_X_j)[kept],
                                  state_np[0][kept])
    np.testing.assert_array_equal(np.asarray(live_l_j)[kept],
                                  state_np[1][kept])
    killed = st.dead_logl[state_np[4]:state_np[4] + B]
    assert float(st.lstar) == float(killed.max())
    assert bool((st.lx0 >= st.lstar).all())
    assert not bool(torch.isnan(st.chol).any())
    # the pending kill applied: k as JAX's
    fused.ns_step_plain(st, *zeros, starts, *consts, select=False)
    assert int(st.count[0]) == int(k_j) == state_np[4] + B
    assert int(st.count[2]) == 1 and int(st.count[3]) == 0


@pytest.mark.parametrize("route", ("lockstep", "k6"))
def test_segments_equal_a_read_per_step(route):
    """The run queued 8 steps at a time between two reads of the stop flag
    equals the run that reads it after every step, bit for bit; the reads
    stay within ceil(steps / 8) + 2."""
    family, p_j = jax_surrogate("rbf", True)
    p = ported(p_j)
    logl = samples.surrogate_logp_fn(family) if route == "k6" else \
        (lambda params, X: samples.surrogate_predict_mean(family, params, X))
    lo = torch.tensor(BOUNDS[:, 0])
    hi = torch.tensor(BOUNDS[:, 1])

    def run(seg):
        return run_nested_device(logl, p, torch.Generator().manual_seed(5),
                                 lo, hi, nlive=NLIVE, num_repeats=3,
                                 max_dead=MAX_DEAD, n_prior=N_PRIOR, seg=seg)

    res8, res1 = run(8), run(1)
    for a, b in zip(res8[:3], res1[:3]):
        assert torch.equal(a, b)
    assert res8[3:6] == res1[3:6] and res8.n_steps == res1.n_steps > 0
    assert res1.n_reads == res1.n_steps + 1
    assert res8.n_reads <= -(-res8.n_steps // 8) + 2


@pytest.mark.parametrize("seed", (0, 1))
def test_steps_match_jax_with_the_order_kept(seed):
    """Four steps in a row from a state whose live order is not known:
    each JAX step's new points (its live set at the slots the plain step
    killed) are applied as the chains' results of the next plain step;
    after every step JAX's dead buffer, k and live set equal the plain
    step's, and the order the state keeps (the plain version sorts afresh
    where K13 merges) is the stable sort of the live log-likelihoods."""
    state_np = numpy_state("unconverged", seed)
    st, consts = port_state(*state_np)
    rng = np.random.default_rng(3 + seed)
    chains = (torch.zeros((B, D), dtype=torch.float64),
              torch.zeros(B, dtype=torch.float64),
              torch.zeros(B, dtype=torch.int64))
    jstate = state_np
    for step in range(4):
        starts = torch.as_tensor(rng.integers(0, NLIVE - B, B))
        fused.ns_step_plain(st, *chains, starts, *consts)
        assert not bool(st.done) and int(st.count[3]) == 1
        assert torch.equal(st.order.long(),
                           torch.argsort(st.live_logl, stable=True))
        np.testing.assert_array_equal(st.live_logl.numpy(), jstate[1])
        (_, live_X_j, live_l_j, dead_X_j, dead_l_j, k_j, _), _ = \
            jax_segment(jstate, seg_steps=1, seed=step)
        np.testing.assert_array_equal(st.dead_X.numpy(),
                                      np.asarray(dead_X_j))
        np.testing.assert_array_equal(st.dead_logl.numpy(),
                                      np.asarray(dead_l_j))
        kill = st.kill.numpy()
        live_X_j, live_l_j = np.asarray(live_X_j), np.asarray(live_l_j)
        chains = (torch.as_tensor(live_X_j[kill]),
                  torch.as_tensor(live_l_j[kill]),
                  torch.ones(B, dtype=torch.int64))
        jstate = (live_X_j, live_l_j, np.asarray(dead_X_j),
                  np.asarray(dead_l_j), int(k_j))
    fused.ns_step_plain(st, *chains, starts, *consts, select=False)
    np.testing.assert_array_equal(st.live_X.numpy(), jstate[0])
    np.testing.assert_array_equal(st.live_logl.numpy(), jstate[1])
    assert int(st.count[0]) == jstate[4]
    assert torch.equal(st.order.long(),
                       torch.argsort(st.live_logl, stable=True))


def test_the_order_kept_lost_and_refused():
    """The live order of the state: a select writes it; an apply whose
    kill is the head of a known order keeps it sorted (K13's merge); an
    apply with the order unknown leaves it unknown (-1 first), and one
    whose kill is not the head of the order (the slots of its first two
    swapped) marks it unknown; a stopped step changes nothing."""
    st, consts = port_state(*numpy_state("unconverged", 1))
    starts = torch.zeros(B, dtype=torch.int64)
    new = lambda s: (torch.zeros((B, D), dtype=torch.float64),
                     torch.linspace(-1.0, 0.0, B, dtype=torch.float64) + s,
                     torch.ones(B, dtype=torch.int64))
    sorted_ = lambda: torch.argsort(st.live_logl, stable=True).to(
        torch.int32)
    assert int(st.order[0]) == -1
    fused.ns_step_plain(st, *new(0), starts, *consts)
    assert torch.equal(st.order, sorted_())
    fused.ns_step_plain(st, *new(0.5), starts, *consts, select=False)
    assert torch.equal(st.order, sorted_())
    fused.ns_step_plain(st, *new(0), starts, *consts)
    st.order[0] = -1
    fused.ns_step_plain(st, *new(1.0), starts, *consts, select=False)
    assert int(st.order[0]) == -1
    fused.ns_step_plain(st, *new(0), starts, *consts)
    st.kill[[0, 1]] = st.kill[[1, 0]]
    before = st.order.clone()
    fused.ns_step_plain(st, *new(1.5), starts, *consts, select=False)
    assert int(st.order[0]) == -1 and torch.equal(st.order[1:], before[1:])
