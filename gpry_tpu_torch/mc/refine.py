"""
Importance-sampling refinement of a surrogate MC sample.

Why (beyond the reference): on multimodal surrogates the mode WEIGHTS of
a nested-sampling (or MCMC) sample carry large estimator noise — measured
on Himmelblau round 4: the trained surrogate's posterior moments are
exact to momKL ~1e-7 (grid quadrature) while the final device-NS sample
reports momKL 0.16-0.51, i.e. the entire headline error was the final
sampler, not the model.  The reference inherits whatever its external
sampler produces (gpry/mc.py:173-455) and has no equivalent.

The refinement (port of gpry_tpu/mc/refine.py): fit a Gaussian-mixture
proposal to the existing sample's detected modes (host-side MST
clustering, utils/modes.py), draw a large batch (default 2^16), score the
surrogate in ONE batched device predict (the K1 kernel) and
self-normalize the importance weights p(x)/q(x).  The proposal is
truncated to the prior box by rejection; truncation only rescales q by a
constant, which cancels in self-normalized weights.  A defensive uniform
mixture component bounds the weight variance wherever the mixture
underfits.

The refined sample replaces the input only when its effective sample
size clearly beats the input's (both measured by 1/sum(w_norm^2)), so a
bad proposal can never make the result worse.
"""

import numpy as np
import torch


def _mixture_logpdf(X, means, covs, log_wmix, lo, hi, log_eps):
    """log q(x) of the mode mixture + eps * Uniform(box), up to the
    (constant) box-truncation normalization."""
    from scipy.stats import multivariate_normal
    parts = [log_eps - np.sum(np.log(hi - lo))
             + np.zeros(len(X))]  # uniform component
    for m, C, lw in zip(means, covs, log_wmix):
        parts.append(lw + multivariate_normal.logpdf(
            X, mean=m, cov=C, allow_singular=True))
    P = np.stack(parts, axis=0)
    mx = P.max(axis=0)
    return mx + np.log(np.exp(P - mx).sum(axis=0))


def ess(weights):
    """Kish effective sample size of (unnormalized) weights."""
    w = np.asarray(weights, dtype=float)
    w = np.where(np.isfinite(w) & (w > 0), w, 0.0)
    s = w.sum()
    if s <= 0:
        return 0.0
    wn = w / s
    return float(1.0 / np.sum(wn ** 2))


def _is_round(gpr, X_seed, w_seed, bounds, rng, n_draw, eps_uniform,
              inflate):
    """One mixture-IS round: fit a mode-mixture proposal to the weighted
    seed sample, draw, score the surrogate in one batched device predict,
    and return ``(X, logp, w, n_modes)`` (or None when the proposal is
    unusable)."""
    from gpry_tpu_torch.models.gp import surrogate_predict_mean
    from gpry_tpu_torch.utils.modes import detect_modes
    lo, hi = bounds[:, 0], bounds[:, 1]
    d = bounds.shape[0]
    try:
        modes = detect_modes(X_seed, w_seed, n_resample=2048, rng=rng)
    except Exception:
        return None
    if not modes:
        return None
    means = [c["mean"] for c in modes]
    covs = [c["cov"] * inflate ** 2 for c in modes]
    wmix = np.array([c["weight"] for c in modes]) * (1.0 - eps_uniform)
    log_wmix = np.log(wmix)
    log_eps = np.log(eps_uniform)
    # --- draw from the truncated mixture by rejection --------------------
    X = np.empty((0, d))
    for _ in range(4):  # the mixture sits inside the box: few retries
        need = n_draw - len(X)
        if need <= 0:
            break
        comp = rng.choice(len(modes) + 1, size=need,
                          p=np.append(wmix, eps_uniform))
        draws = np.empty((need, d))
        uni = comp == len(modes)
        draws[uni] = lo + rng.random((int(uni.sum()), d)) * (hi - lo)
        for k in range(len(modes)):
            selk = comp == k
            if not np.any(selk):
                continue
            draws[selk] = rng.multivariate_normal(
                means[k], covs[k], size=int(selk.sum()),
                check_valid="ignore")
        inside = np.all((draws >= lo) & (draws <= hi), axis=1)
        X = np.concatenate([X, draws[inside]], axis=0)
    if len(X) < max(1024, 16 * d):
        return None  # mixture leaks out of the box: refuse
    # --- one batched device predict (the hot op: the K1 kernel) ----------
    p = gpr.surrogate_params()
    logp = surrogate_predict_mean(
        gpr.family, p, torch.as_tensor(X, dtype=p.X.dtype,
                                       device=p.X.device)).cpu().numpy()
    gpr.n_eval += len(X)
    logq = _mixture_logpdf(X, means, covs, log_wmix, lo, hi, log_eps)
    logw = logp - logq
    logw = np.where(np.isfinite(logw), logw, -np.inf)
    mx = logw.max()
    if not np.isfinite(mx):
        return None
    return X, logp, np.exp(logw - mx), len(modes)


def is_refine_sample(gpr, sample, bounds, rng=None, n_draw=65536,
                     eps_uniform=0.05, inflate=1.5, min_gain=2.0,
                     n_rounds=3, verbose=1):
    """
    Refine ``sample`` ({"X", "weights", ...}) by ITERATIVE mixture
    importance sampling against the surrogate.  Returns a NEW samples
    dict (with ``"refined": True``) when the best round's ESS beats the
    input's by ``min_gain``x, else the input sample unchanged.

    Iteration is the defense against an input sample that MISSED a mode
    the surrogate knows (observed: a final device-NS run dropped one of
    Himmelblau's four modes entirely; the surrogate itself was exact to
    momKL < 1e-5): round 1's proposal has no component there, but its
    uniform defense component lands draws in the missed mode whose huge
    p/q weights make it visible in the weighted draws — so round 2's
    proposal (fit to round 1's OUTPUT) covers it, and its ESS collapses
    the weight variance.  A single round would correctly refuse (tiny
    ESS) and return the flawed input unchanged.
    """
    rng = rng if isinstance(rng, np.random.Generator) \
        else np.random.default_rng(rng)
    X_in = np.asarray(sample["X"], dtype=float)
    w_in = np.asarray(sample["weights"], dtype=float)
    if len(X_in) < 8:
        return sample
    bounds = np.asarray(bounds, dtype=float)
    ess_old = ess(w_in)
    X_seed, w_seed = X_in, w_in
    best = None
    total_draws = 0  # surrogate calls across ALL rounds, kept or not
    for rnd in range(n_rounds):
        res = _is_round(gpr, X_seed, w_seed, bounds, rng, n_draw,
                        eps_uniform, inflate)
        if res is None:
            break
        X, logp, w, n_modes = res
        total_draws += len(X)
        ess_new = ess(w)
        if best is None or ess_new > best[0]:
            best = (ess_new, X, logp, w, n_modes)
        # seed the next round from this round's weighted draws
        X_seed, w_seed = X, w
        if ess_new >= 0.2 * len(X):
            break  # the proposal already explains the posterior: done
    if best is None or best[0] < min_gain * ess_old:
        if verbose >= 2 and best is not None:
            print(f"[IS-REFINE] kept input sample: refined ESS "
                  f"{best[0]:.0f} < {min_gain}x input ESS {ess_old:.0f}")
        if total_draws:
            # surrogate calls were spent even though the input is kept:
            # keep n_calls consistent with gpr.n_eval (incremented per
            # round in _is_round)
            out = dict(sample)
            out["n_calls"] = int(sample.get("n_calls", 0)) + total_draws
            return out
        return sample
    ess_new, X, logp, w, n_modes = best
    out = dict(sample)
    out.update({
        "X": X, "logpost": logp, "weights": w,
        "refined": True, "ess": ess_new, "ess_input": ess_old,
        "n_calls": int(sample.get("n_calls", 0)) + total_draws,
    })
    if verbose >= 2:
        print(f"[IS-REFINE] refined: ESS {ess_old:.0f} -> {ess_new:.0f} "
              f"({n_modes} proposal modes, {len(X)} draws)")
    return out
