"""
Progress and diagnosis plots (port of gpry_tpu/plots.py).

Reference surface: gpry/plots.py (1255 LoC).  matplotlib, imported only
inside ``_plt()`` with the ``Agg`` backend, so that the module imports
where matplotlib is missing; the corner plot uses getdist where it imports
and a matplotlib pair grid otherwise.  Every array drawn here is host
numpy: ``gpr.predict`` returns numpy, and the GPR's training arrays, the
criteria's histories and NORA's sample are numpy too.
"""

import numpy as np


def _plt():
    import matplotlib
    matplotlib.use("Agg", force=False)
    import matplotlib.pyplot as plt
    return plt


def _finish(fig, save, show=False):
    if save:
        import os
        os.makedirs(os.path.dirname(save) or ".", exist_ok=True)
        fig.savefig(save, dpi=150, bbox_inches="tight")
    if show:  # pragma: no cover
        _plt().show()
    _plt().close(fig)
    return fig


def plot_convergence(criteria, save=None, show=False):
    """Criterion values vs truth evaluations
    (reference: gpry/plots.py:679)."""
    plt = _plt()
    if not isinstance(criteria, (list, tuple)):
        criteria = [criteria]
    fig, ax = plt.subplots(figsize=(7, 4.5))
    for cc in criteria:
        vals = np.asarray(cc.values, dtype=float)
        n_evals = np.asarray(cc.n_posterior_evals, dtype=float)
        if len(vals) == 0:
            continue
        ax.plot(n_evals, vals, "o-", label=type(cc).__name__)
        try:
            limit = cc.limit
            if np.isfinite(limit):
                ax.axhline(limit, ls="--", color="grey", alpha=0.5)
        except (NotImplementedError, TypeError):
            pass
    ax.set_yscale("log")
    ax.set_xlabel("number of posterior evaluations")
    ax.set_ylabel("criterion value")
    ax.legend()
    return _finish(fig, save, show)


def plot_trace(gpr, save=None, show=False):
    """Per-parameter trace of accepted training points
    (reference: gpry/plots.py:815)."""
    plt = _plt()
    X, y = gpr.X_train, gpr.y_train
    d = gpr.d
    fig, axes = plt.subplots(d + 1, 1, figsize=(7, 1.6 * (d + 1)),
                             sharex=True)
    axes = np.atleast_1d(axes)
    n = np.arange(len(y))
    for i in range(d):
        axes[i].plot(n, X[:, i], ".")
        axes[i].set_ylabel(f"x_{i + 1}")
    axes[-1].plot(n, y, ".")
    axes[-1].set_ylabel("log(p)")
    axes[-1].set_xlabel("training point index")
    return _finish(fig, save, show)


def plot_slices(truth, gpr, n_points=101, X_ref=None, save=None,
                show=False):
    """1-d slices of truth vs surrogate through ``X_ref`` (default: the
    best training point) (reference: gpry/plots.py:165-407)."""
    plt = _plt()
    d = gpr.d
    bounds = np.asarray(truth.prior_bounds if truth is not None
                        else gpr.bounds)
    if X_ref is not None:
        x0 = np.atleast_1d(np.asarray(X_ref, dtype=float))
    else:
        x0 = gpr.X_train[np.argmax(gpr.y_train)] if gpr.n else \
            bounds.mean(axis=1)
    fig, axes = plt.subplots(1, d, figsize=(4 * d, 3.2), squeeze=False)
    for i in range(d):
        ax = axes[0, i]
        grid = np.linspace(bounds[i, 0], bounds[i, 1], n_points)
        Xq = np.tile(x0, (n_points, 1))
        Xq[:, i] = grid
        mu, sd = gpr.predict(Xq, return_std=True)
        ax.plot(grid, mu, label="GP mean")
        ax.fill_between(grid, mu - sd, mu + sd, alpha=0.3)
        if truth is not None:
            yt = np.array([truth.logp(x) for x in Xq])
            ax.plot(grid, yt, "k--", label="truth")
        ax.axvline(x0[i], color="tab:blue", ls=":", alpha=0.6)
        ax.set_xlabel(f"x_{i + 1}")
        if i == 0:
            ax.set_ylabel("log(p)")
            ax.legend()
    return _finish(fig, save, show)


def plot_slices_reference(truth, gpr, X_ref, plot_truth=True, n_points=101,
                          save=None, show=False):
    """Slices of surrogate (and optionally truth) through a fixed
    reference/fiducial point (reference: gpry/plots.py:309-407)."""
    return plot_slices(truth if plot_truth else None, gpr,
                       n_points=n_points, X_ref=X_ref, save=save, show=show)


def param_samples_for_slices(X, i, bounds_i, n=200):
    """Slice grids along coordinate ``i`` for each row of ``X``: returns
    (len(X), n, d) (reference: gpry/plots.py:129-160)."""
    X = np.atleast_2d(np.asarray(X, dtype=float))
    grid = np.linspace(bounds_i[0], bounds_i[1], n)
    out = np.repeat(X[:, None, :], n, axis=1)
    out[:, :, i] = grid[None, :]
    return out


def plot_slices_func(truth, gpr, acquisition=None, X=None, n_points=200,
                     max_points=20, save=None, show=False):
    """
    Per-point slices of the surrogate (top row) and the acquisition
    (bottom row, when given) along each coordinate, lines colored by the GP
    mean at the sliced point (reference: gpry/plots.py:246-307).
    ``X`` defaults to the (up to ``max_points`` best) training points.
    """
    plt = _plt()
    import matplotlib as mpl
    d = gpr.d
    bounds = np.asarray(truth.prior_bounds if truth is not None
                        else gpr.bounds)
    if X is None:
        X = np.copy(gpr.X_train)
        y = np.copy(gpr.y_train)
        if len(y) > max_points:
            top = np.argsort(y)[-max_points:]
            X, y = X[top], y[top]
    else:
        X = np.atleast_2d(np.asarray(X, dtype=float))
        y = gpr.predict(X)
    nrows = 2 if acquisition is not None else 1
    fig, axes = plt.subplots(nrows, d, figsize=(4 * d, 2.6 * nrows),
                             squeeze=False, sharex="col")
    span = max(float(np.max(y) - np.min(y)), 1e-30)
    cmap = mpl.colormaps["viridis"]
    for i in range(d):
        Xs = param_samples_for_slices(X, i, bounds[i], n=n_points)
        for j in range(len(X)):
            color = cmap((y[j] - np.min(y)) / span)
            mu, sd = gpr.predict(Xs[j], return_std=True)
            axes[0, i].plot(Xs[j][:, i], mu, c=color, lw=1)
            axes[0, i].scatter([X[j, i]], [y[j]], color=color, s=10)
            if acquisition is not None:
                acq = acquisition.acq_func(Xs[j], gpr) \
                    if hasattr(acquisition, "acq_func") \
                    else acquisition(Xs[j], gpr)
                a = np.where(np.isfinite(acq), acq, np.nan)
                axes[-1, i].plot(Xs[j][:, i], a, c=color, lw=1)
        axes[0, i].set_ylabel(r"$\log(p)$" if i == 0 else "")
        if acquisition is not None and i == 0:
            axes[-1, i].set_ylabel(r"$\alpha(\mu,\sigma)$")
        axes[-1, i].set_xlabel(f"x_{i + 1}")
    return _finish(fig, save, show)


def plot_corner(samples_dict, params=None, gpr=None, truth_samples=None,
                fiducial_point=None, fiducial_MC=None, save=None,
                show=False):
    """
    Corner plot of an MC sample, with training points, a fiducial point
    (marker lines) and/or a fiducial MC sample (unfilled reference
    contours) overlaid (reference: gpry/plots.py:412-676 via getdist;
    matplotlib fallback).
    """
    X = np.asarray(samples_dict["X"])
    w = np.asarray(samples_dict.get("weights", np.ones(len(X))))
    d = X.shape[1]
    names = params or [f"x_{i + 1}" for i in range(d)]
    fid = np.atleast_1d(np.asarray(fiducial_point, dtype=float)) \
        if fiducial_point is not None else None
    try:
        from getdist import MCSamples, plots as gdplots
        to_plot = [MCSamples(samples=X, weights=w, names=names)]
        filled = [True]
        legend = ["surrogate MC"]
        if fiducial_MC is not None:
            Xf = np.asarray(fiducial_MC["X"])
            wf = np.asarray(fiducial_MC.get("weights", np.ones(len(Xf))))
            to_plot = [MCSamples(samples=Xf, weights=wf, names=names)] \
                + to_plot
            filled = [False] + filled
            legend = ["fiducial MC"] + legend
        markers = dict(zip(names, fid)) if fid is not None else None
        gdp = gdplots.get_subplot_plotter()
        gdp.triangle_plot(to_plot, filled=filled, legend_labels=legend,
                          markers=markers)
        fig = gdp.fig
        if gpr is not None:
            getdist_add_training(gdp, names, gpr)
        return _finish(fig, save, show)
    except ImportError:
        pass
    plt = _plt()
    fig, axes = plt.subplots(d, d, figsize=(2.2 * d, 2.2 * d),
                             squeeze=False)
    Xf = wf = None
    if fiducial_MC is not None:
        Xf = np.asarray(fiducial_MC["X"])
        wf = np.asarray(fiducial_MC.get("weights", np.ones(len(Xf))))
    for i in range(d):
        for j in range(d):
            ax = axes[i, j]
            if j > i:
                ax.axis("off")
                continue
            if i == j:
                ax.hist(X[:, i], bins=40, weights=w, density=True,
                        histtype="step")
                if Xf is not None:
                    ax.hist(Xf[:, i], bins=40, weights=wf, density=True,
                            histtype="step", color="k", ls="--")
                if fid is not None:
                    ax.axvline(fid[i], color="tab:red", ls=":")
            else:
                ax.hist2d(X[:, j], X[:, i], bins=40, weights=w)
                if gpr is not None and gpr.n:
                    ax.plot(gpr.X_train[:, j], gpr.X_train[:, i], "r.",
                            ms=2)
                if fid is not None:
                    ax.plot([fid[j]], [fid[i]], "r*", ms=10)
            if i == d - 1:
                ax.set_xlabel(names[j])
            if j == 0:
                ax.set_ylabel(names[i])
    return _finish(fig, save, show)


# API-parity alias: the reference names this plot_corner_getdist
# (gpry/plots.py:412); our plot_corner covers both the getdist and the
# matplotlib-fallback paths under one entry point.
plot_corner_getdist = plot_corner


def getdist_add_training(gdplot, params, gpr, colormap="viridis",
                         marker=".", marker_inf="x"):
    """Overlay training points on a getdist triangle plot
    (reference: gpry/plots.py:556)."""
    X, y = gpr.X_train, gpr.y_train
    Xinf = gpr.X_train_infinite
    for i in range(gpr.d):
        for j in range(i):
            ax = gdplot.subplots[i, j]
            if ax is None:
                continue
            ax.scatter(X[:, j], X[:, i], c=y, cmap=colormap, s=8,
                       marker=marker)
            if len(Xinf):
                ax.scatter(Xinf[:, j], Xinf[:, i], c="k", s=8,
                           marker=marker_inf)
    return gdplot


def plot_model_2d(gpr, bounds=None, n_grid=80, what="mean", acq_func=None,
                  save=None, show=False):
    """
    2-D contour maps of the surrogate (mean / std / acquisition) with the
    training set overlaid (reference: gpry/plots.py:1039-1167).
    ``what``: "mean", "std", or "acq" (requires ``acq_func(y, sigma)``).
    """
    plt = _plt()
    if gpr.d != 2:
        raise ValueError("plot_model_2d requires a 2-d model.")
    bounds = np.asarray(bounds if bounds is not None else gpr.bounds)
    gx = np.linspace(bounds[0, 0], bounds[0, 1], n_grid)
    gy = np.linspace(bounds[1, 0], bounds[1, 1], n_grid)
    GX, GY = np.meshgrid(gx, gy, indexing="ij")
    Xq = np.column_stack([GX.ravel(), GY.ravel()])
    mu, sd = gpr.predict(Xq, return_std=True)
    if what == "mean":
        Z = mu
    elif what == "std":
        Z = sd
    elif what == "acq":
        if acq_func is None:
            raise ValueError("Pass acq_func for what='acq'.")
        Z = np.asarray(acq_func(mu, sd))
    else:
        raise ValueError(f"Unknown what={what!r}")
    Z = np.where(np.isfinite(Z), Z, np.nan).reshape(n_grid, n_grid)
    fig, ax = plt.subplots(figsize=(6, 5))
    pcm = ax.pcolormesh(GX, GY, Z, shading="auto")
    fig.colorbar(pcm, ax=ax, label=what)
    if gpr.n:
        ax.plot(gpr.X_train[:, 0], gpr.X_train[:, 1], "r.", ms=4,
                label="training")
    Xinf = gpr.X_train_infinite
    if len(Xinf):
        ax.plot(Xinf[:, 0], Xinf[:, 1], "kx", ms=4, label="infinite")
    ax.legend(loc="upper right")
    ax.set_xlabel("x_1")
    ax.set_ylabel("x_2")
    return _finish(fig, save, show)


def plot_distance_distribution(gpr, samples_dict, save=None, show=False):
    """
    Histogram of Mahalanobis distances of training points under the MC
    sample's Gaussian approximation, against chi2 expectation
    (reference: gpry/plots.py:958).
    """
    from scipy.stats import chi2
    from gpry_tpu_torch.utils.tools import mean_covmat_from_samples
    plt = _plt()
    X = np.asarray(samples_dict["X"])
    w = np.asarray(samples_dict.get("weights", np.ones(len(X))))
    mean, cov = mean_covmat_from_samples(X, w)
    inv = np.linalg.inv(cov)
    diff = gpr.X_train - mean
    dist = np.sqrt(np.einsum("ij,jk,ik->i", diff, inv, diff))
    d = gpr.d
    fig, ax = plt.subplots(figsize=(6, 4))
    ax.hist(dist, bins=30, density=True, alpha=0.6,
            label="training points")
    grid = np.linspace(0, max(dist.max(), 5), 200)
    ax.plot(grid, 2 * grid * chi2.pdf(grid**2, d), "k--",
            label=rf"$\chi_{{{d}}}$ expectation")
    ax.set_xlabel("Mahalanobis distance (std)")
    ax.legend()
    return _finish(fig, save, show)
