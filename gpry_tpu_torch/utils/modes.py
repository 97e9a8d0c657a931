"""
Mode detection on weighted posterior samples, and the convergence-time
mode-coverage audit helpers.

Why this exists (beyond the reference): the reference's CorrectCounter is
structurally blind to undiscovered modes (gpry/convergence.py:755-879 only
scores points the acquisition itself proposed), so multimodal targets can
declare convergence with most of their mass unmapped (observed: Himmelblau
at momKL 130/822 in benchmarks/results_nongaussian.json, round 3).  The
Runner uses these helpers to (a) detect multimodality in the surrogate's
own MC sample, (b) demand mode-signature stability across convergence
checks, and (c) audit a declared convergence with a cheap screening of the
surrogate's *ungated* belief over the prior box (see Runner._convergence
_audit).

All of this is host-side numpy on ~1e3-point subsamples — the heavy device
work (the screening predict) happens in one batched jitted call.
"""

import numpy as np


def _weighted_resample(X, weights, n, rng):
    """Draw ``n`` indices proportional to ``weights`` (with replacement),
    then deduplicate for geometry — but KEEP the multiplicities:
    duplicates carry no geometry information, yet they carry all the
    MASS information.  Cluster weights must come from the counts, not
    the unique-point fractions — a mode represented by a few very-heavy
    points (e.g. recovered by an IS defense component) is 30% of the
    posterior but <1% of the unique points, and count-blind weighting
    dropped it below ``min_weight`` (measured: the missed-mode recovery
    test).  Returns ``(X_unique, counts)``."""
    w = np.asarray(weights, dtype=float)
    w = np.where(np.isfinite(w) & (w > 0), w, 0.0)
    s = w.sum()
    if s <= 0:
        return np.empty((0, X.shape[1])), np.empty((0,))
    idx = rng.choice(len(X), size=min(n, 4 * len(X)), p=w / s)
    uniq, counts = np.unique(idx, return_counts=True)
    return X[uniq], counts.astype(float)


def detect_modes(X, weights=None, n_resample=1024, link_factor=4.0,
                 min_weight=0.02, rng=None):
    """
    Cluster a weighted sample into posterior modes.

    MST-cut clustering in *whitened* coordinates: build the Euclidean
    minimum spanning tree of a weight-resampled subsample (over a kNN
    graph) and cut every edge longer than ``link_factor * median MST edge
    length``.  Scale-free and dimension-robust: within one connected
    structure (a unimodal cloud, a ring, a banana) MST edge lengths vary
    only by local density, while the bridge between well-separated modes
    is many times the median edge — cutting it splits the modes without
    fragmenting connected shapes the way fixed-radius friends-of-friends
    does.

    Returns a list of dicts sorted by descending weight:
    ``{"weight", "mean", "n"}`` — clusters below ``min_weight`` (sample
    mass fraction) are dropped as noise.

    ``min_weight=0.02`` is derived, not guessed: (a) at the default
    ``n_resample=1024`` a 2% cluster holds ~20 resampled points — below
    that, "clusters" are dominated by resampling noise (binomial sd at
    1% is ~0.3% absolute, a third of the weight itself); (b) omitting a
    sub-2% mode changes the mixture by <0.02 in total variation, under
    the 0.05 momKL convergence gate this machinery guards.  Modes at
    3-5% mass are ABOVE the cut and tracked (see
    tests/test_round5.py::test_detect_modes_small_mode_d4).
    """
    X = np.atleast_2d(np.asarray(X, dtype=float))
    if len(X) == 0:
        return []
    if weights is None:
        weights = np.ones(len(X))
    rng = rng if isinstance(rng, np.random.Generator) \
        else np.random.default_rng(rng)
    Xs, cnt = _weighted_resample(X, weights, n_resample, rng)
    m, d = Xs.shape
    if m == 0:
        return []
    if m == 1:
        span = np.maximum(X.max(axis=0) - X.min(axis=0), 1e-6)
        return [{"weight": 1.0, "mean": Xs[0],
                 "cov": np.diag((1e-3 * span) ** 2), "n": 1}]
    # whiten by the subsample covariance (regularized against collapsed
    # directions; a degenerate weighted sample must not crash the check)
    mu = Xs.mean(axis=0)
    C = np.cov(Xs.T, ddof=1).reshape(d, d)
    C += np.eye(d) * (1e-12 + 1e-9 * np.trace(C) / d)
    try:
        Lc = np.linalg.cholesky(C)
        Z = np.linalg.solve(Lc, (Xs - mu).T).T
    except np.linalg.LinAlgError:
        scale = np.where(Xs.std(axis=0) > 0, Xs.std(axis=0), 1.0)
        Z = (Xs - mu) / scale
    from scipy.sparse import coo_matrix
    from scipy.sparse.csgraph import (connected_components,
                                      minimum_spanning_tree)
    from scipy.spatial import cKDTree
    tree = cKDTree(Z)
    k = min(m, 9)  # self + 8 neighbors
    dist, idx = tree.query(Z, k=k)
    rows = np.repeat(np.arange(m), k - 1)
    cols = idx[:, 1:].ravel()
    vals = np.maximum(dist[:, 1:].ravel(), 1e-300)
    graph = coo_matrix((vals, (rows, cols)), shape=(m, m))
    mst = minimum_spanning_tree(graph).tocoo()
    edges = mst.data
    if len(edges) == 0:
        span = np.maximum(X.max(axis=0) - X.min(axis=0), 1e-6)
        cov = np.cov(Xs.T, ddof=1).reshape(d, d) if m > d + 1 \
            else np.diag((1e-3 * span) ** 2)
        return [{"weight": 1.0, "mean": Xs.mean(axis=0), "cov": cov,
                 "n": m}]
    # LOCAL bridge criterion: an edge is an inter-mode bridge when it is
    # long relative to its own endpoints' kNN scale (mean distance to the
    # 4 nearest neighbors).  A global cut at ``c * median(edges)`` would
    # shatter sparse modes whenever a dense mode dominates the median
    # (observed on an 80/20 two-scale mixture); the local scale adapts to
    # per-mode density.  The global-median floor guards the cut against
    # near-duplicate points collapsing the local scale.
    local = dist[:, 1:5].mean(axis=1)
    med = float(np.median(edges))
    scale = np.maximum(np.maximum(local[mst.row], local[mst.col]),
                       0.5 * med)
    keep = edges <= link_factor * scale
    pruned = coo_matrix((edges[keep], (mst.row[keep], mst.col[keep])),
                        shape=(m, m))
    _, labels = connected_components(pruned, directed=False)
    out = []
    cnt_tot = float(cnt.sum())
    for lab in np.unique(labels):
        sel = labels == lab
        w = float(cnt[sel].sum()) / cnt_tot
        if w >= min_weight:
            members = Xs[sel]
            wm = cnt[sel]
            mean = (wm[:, None] * members).sum(axis=0) / wm.sum()
            if len(members) >= d + 2:
                cov = np.cov(members.T, ddof=1).reshape(d, d)
            else:
                cov = np.zeros((d, d))
            # regularize against collapsed clusters (a near-duplicate
            # cluster must still yield a usable proposal covariance)
            span = X.max(axis=0) - X.min(axis=0)
            cov += np.diag(np.maximum(1e-12, (1e-3 * span) ** 2))
            out.append({"weight": w, "mean": mean,
                        "cov": cov, "n": int(sel.sum())})
    # renormalize over kept clusters so signatures compare cleanly
    tot = sum(c["weight"] for c in out) or 1.0
    for c in out:
        c["weight"] /= tot
    out.sort(key=lambda c: -c["weight"])
    return out


def mode_signature(modes):
    """(n_modes, sorted weight tuple) — the comparable summary."""
    return (len(modes), tuple(round(c["weight"], 4) for c in modes))


def modes_match(sig_a, sig_b, weight_tol=0.15, rel_tol=0.5):
    """Whether two mode signatures agree: same count, and every
    rank-matched weight within ``min(weight_tol, rel_tol * larger
    weight)``.

    The relative term closes the small-mode blind spot of a purely
    absolute tolerance: a 3%-mass mode drifting to 12% is a 4x mass
    change (its weight is still equilibrating), yet the absolute
    |0.03 - 0.12| = 0.09 < 0.15 would call it "stable".  For large
    modes the relative bound exceeds ``weight_tol`` and the behavior
    is unchanged (0.45 vs 0.55 still matches)."""
    if sig_a is None or sig_b is None:
        return False
    if sig_a[0] != sig_b[0]:
        return False
    return all(abs(wa - wb) <= min(weight_tol, rel_tol * max(wa, wb))
               for wa, wb in zip(sig_a[1], sig_b[1]))
