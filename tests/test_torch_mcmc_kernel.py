"""
K12's plain version (``ops.fused.mcmc_chains_plain``, one phase of the
adaptive Metropolis ensemble) and the port's ``run_mcmc_device`` on the
CPU in float64: the phase replays the lock-step loop the port ran before
K12 when fed the same draws, the surrogate's runs take K12's route once per
phase, and the ensemble matches gpry_tpu's ``run_mcmc_device`` by
distribution (the two packages draw from different generators).
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from gpry_tpu.mc.mcmc import run_mcmc_device as j_run_mcmc
from gpry_tpu.mc.mcmc import split_rhat as j_split_rhat

from gpry_tpu_torch import config
from gpry_tpu_torch.mc import samples
from gpry_tpu_torch.mc.mcmc import run_mcmc_device, split_rhat
from gpry_tpu_torch.models.gp import surrogate_predict_mean
from gpry_tpu_torch.ops import fused

from test_torch_ns_slice import jax_surrogate, ported

config.set_device("cpu")
torch.set_num_threads(1)
f64 = torch.float64


def gauss_logp(params, X):
    mu, s = params
    return -0.5 * torch.sum(((X - mu) / s) ** 2, dim=-1)


def j_gauss_logp(params, X):
    mu, s = params
    return -0.5 * jnp.sum(((X - mu) / s) ** 2, axis=-1)


def lockstep_phase(logp_of, x, lp_x, log_step, chol, n, gen, adapt):
    """The port's phase loop before K12 (one step at a time, its normals
    then its uniforms drawn per step), kept here as the reference."""
    B, d = x.shape
    s1 = torch.zeros(d, dtype=f64)
    s2 = torch.zeros((d, d), dtype=f64)
    Xs, lps = [], []
    for _ in range(n):
        z = torch.randn((B, d), generator=gen, dtype=f64)
        prop = x + torch.exp(log_step) * (z @ chol.T)
        lp_prop = logp_of(prop)
        lu = torch.log(torch.rand(B, generator=gen, dtype=f64))
        accept = lu < (lp_prop - lp_x)
        x = torch.where(accept[:, None], prop, x)
        lp_x = torch.where(accept, lp_prop, lp_x)
        if adapt:
            log_step = log_step + 0.05 * (accept.to(f64).mean() - 0.234)
            s1 = s1 + x.sum(dim=0)
            s2 = s2 + x.T @ x
        Xs.append(x)
        lps.append(lp_x)
    return x, lp_x, log_step, s1, s2, torch.stack(Xs), torch.stack(lps)


def the_same_draws(seed, n, B, d):
    """The lock-step loop's draws of ``n`` steps, in K12's layout."""
    gen = torch.Generator().manual_seed(seed)
    z, u = [], []
    for _ in range(n):
        z.append(torch.randn((B, d), generator=gen, dtype=f64))
        u.append(torch.rand(B, generator=gen, dtype=f64))
    return torch.stack(z), torch.stack(u)


def surrogate_case():
    family, p_j = jax_surrogate("rbf", True)
    p = ported(p_j)
    lo, hi = torch.full((2,), -4.0, dtype=f64), torch.full((2,), 4.0,
                                                           dtype=f64)
    return family, p, lo, hi


@pytest.mark.parametrize("adapt", (True, False), ids=("warmup", "sampling"))
@pytest.mark.parametrize("target", ("gauss", "surrogate"))
def test_plain_phase_replays_the_lockstep_loop(target, adapt):
    """Fed the draws the lock-step loop would draw, the plain phase gives
    its states, step size and moment sums exactly (a narrow Gaussian in
    the unit cube, and the gated surrogate with -inf outside a disc)."""
    B, n = 8, 40
    if target == "gauss":
        d = 3
        params = (torch.full((d,), 0.6, dtype=f64), 0.1)
        lo, hi = torch.zeros(d, dtype=f64), torch.ones(d, dtype=f64)
        x0 = torch.full((B, d), 0.6, dtype=f64) + 0.01 * torch.arange(
            B, dtype=f64)[:, None]

        def logp_of(X):
            in_box = torch.all((X >= lo) & (X <= hi), dim=-1)
            return torch.where(in_box, gauss_logp(params, X),
                               torch.full_like(X[:, 0], -torch.inf))
    else:
        family, p, lo, hi = surrogate_case()
        logp_of = fused._in_box_logp(family, p, lo, hi)
        d = 2
        x0 = torch.as_tensor(np.random.default_rng(3).uniform(-1, 1, (B, d)))
    lp0 = logp_of(x0)
    assert bool(torch.isfinite(lp0).all())
    chol = torch.linalg.cholesky(torch.eye(d, dtype=f64) * 0.02)
    step = torch.tensor(-0.2, dtype=f64)
    ref = lockstep_phase(logp_of, x0, lp0, step, chol, n,
                         torch.Generator().manual_seed(9), adapt)
    z, u = the_same_draws(9, n, B, d)
    out = fused.mcmc_chains_plain(logp_of, x0, lp0, step, chol, z, u, adapt)
    for a, b in zip(out, ref):
        assert torch.equal(a, b)
    if target == "surrogate":
        # the wrapper's CPU route is the plain phase on plain K1
        out_w = fused.mcmc_chains(family, p, x0, lp0, step, chol, z, u, lo,
                                  hi, adapt)
        for a, b in zip(out_w, ref):
            assert torch.equal(a, b)
    assert bool((out[5][-1] != x0).any())


def test_surrogate_route_is_k12(monkeypatch):
    """run_mcmc_device on the gated surrogate takes K12's route (on the CPU
    its plain version) once per phase, and gives bit-identical chains to
    the lock-step loop that any other log-density runs."""
    family, p, lo, hi = surrogate_case()
    routed = []

    def k12(*args):
        routed.append(args[-1])
        return fused.mcmc_chains(*args)

    monkeypatch.setattr(samples, "mcmc_chains", k12)

    def run(logp_fn):
        return run_mcmc_device(logp_fn, p, torch.Generator().manual_seed(4),
                               lo, hi, n_chains=8, n_steps=60)

    X, lps = run(samples.surrogate_logp_fn(family))
    Xp, lpsp = run(lambda params, X: surrogate_predict_mean(family, params,
                                                            X))
    assert routed == [True, False]
    assert X.shape == (8, 60, 2) and torch.equal(X, Xp)
    assert torch.equal(lps, lpsp)


def test_run_mcmc_matches_jax_by_distribution():
    """The same narrow Gaussian in the unit square through both packages'
    run_mcmc_device (8 chains, 750 + 1,500 steps): the means within 4
    standard errors of the chains' batch means, the standard deviations
    within 20% of each other, and split-R-hat below 1.1 in both and within
    0.05 of each other."""
    d, n_chains, n_steps = 2, 8, 1500
    X, _ = run_mcmc_device(gauss_logp, (torch.full((d,), 0.6, dtype=f64),
                                        0.1),
                           torch.Generator().manual_seed(2),
                           torch.zeros(d, dtype=f64), torch.ones(d, dtype=f64),
                           n_chains=n_chains, n_steps=n_steps)
    Xj, _ = j_run_mcmc(j_gauss_logp, (jnp.full((d,), 0.6), 0.1),
                       jax.random.PRNGKey(2), jnp.zeros(d), jnp.ones(d),
                       n_chains=n_chains, n_steps=n_steps)
    X, Xj = X.numpy(), np.asarray(Xj)
    assert X.shape == Xj.shape == (n_chains, n_steps, d)
    # standard errors from the chains' means (the chains are independent)
    se = np.sqrt((X.mean(axis=1).var(axis=0, ddof=1)
                  + Xj.mean(axis=1).var(axis=0, ddof=1)) / n_chains)
    m, mj = X.reshape(-1, d).mean(axis=0), Xj.reshape(-1, d).mean(axis=0)
    assert np.all(np.abs(m - mj) <= 4 * se), (m, mj, se)
    np.testing.assert_allclose(X.reshape(-1, d).std(axis=0),
                               Xj.reshape(-1, d).std(axis=0), rtol=0.2)
    r, rj = split_rhat(X), j_split_rhat(Xj)
    assert r < 1.1 and rj < 1.1 and abs(r - rj) < 0.05, (r, rj)
