"""
The per-iteration diagnosis callback (port of gpry_tpu/diag.py).

Reference surface: gpry/diag.py (222 LoC): a callback (``Runner(...,
callback=diagnosis)``) that checks the internal consistency of the
classifier and the GPR each iteration and can write plots.
"""

import os

import numpy as np
import torch


def diagnosis(runner, plot=False):
    """
    Consistency checks (reference: gpry/diag.py:26-151):

    * every GPR training point must be classified finite by the threshold;
    * the classifier's predictions at its own training points should agree
      with their labels (the SVC with C=1e7 nearly interpolates);
    * the prediction residuals at the points added last.

    Returns the report dict.
    """
    gpr = runner.gpr
    report = {"iteration": runner.current_iteration}

    # threshold consistency
    finite_mask = gpr._is_finite_all()
    report["n_finite_threshold"] = int(np.sum(finite_mask))
    report["n_gpr_train"] = gpr.n
    report["sizes_consistent"] = report["n_finite_threshold"] == gpr.n

    # classifier self-consistency
    clf = gpr.infinities_classifier
    if clf is not None and clf.n > 0 and not clf.all_finite:
        pred = clf.predict(clf.X_train)
        agree = float(np.mean(pred == clf.y_finite))
        report["classifier_train_agreement"] = agree
        if agree < 0.95:
            runner.log(f"[DIAG] classifier agreement low: {agree:.2f}", 2)

    # prediction residuals at the last appended finite points
    X_new, y_new = gpr.last_appended_finite
    if len(y_new):
        resid = np.abs(gpr.predict(X_new) - y_new)
        report["max_residual_last_batch"] = float(np.max(resid))

    if plot and runner.checkpoint:
        try:
            runner.plot_progress()
        except Exception:
            pass
        try:
            plot_nora_sample(runner)
        except Exception as excpt:  # plots must never kill the run
            runner.log(f"[DIAG] NORA plot failed: {excpt}", 2)
    runner.log(f"[DIAG] {report}", 3)
    return report


def plot_nora_sample(runner, path=None):
    """
    The per-iteration NORA plots (reference: gpry/diag.py:152-218): a
    triangle plot of the engine's last NS sample with the training set and
    any stored fiducials over it, and (d = 2 only) maps of the surrogate's
    mean, std and acquisition.  Returns the folder, or None for an engine
    without a sample.
    """
    from gpry_tpu_torch import plots as gplots
    from gpry_tpu_torch.acquisition.nora import NORA

    acq_engine = runner.acquisition
    if not isinstance(acq_engine, NORA) or acq_engine.last_MC_X is None:
        return None
    path = path or os.path.join(runner.checkpoint or ".", "images")
    os.makedirs(path, exist_ok=True)
    it = runner.current_iteration
    X, logp, w = acq_engine.last_MC_sample()
    gplots.plot_corner(
        {"X": X, "logpost": logp, "weights": w},
        params=runner.truth.params, gpr=runner.gpr,
        fiducial_point=runner.fiducial_point,
        fiducial_MC=runner.fiducial_MC,
        save=os.path.join(path, f"NORA_iteration_{it:03d}.png"))
    if runner.d == 2:
        noise_std = float(np.mean(runner.gpr.noise_level))

        def acq_fn(mu, sd):
            return acq_engine.acq_func.values(
                torch.as_tensor(mu), torch.as_tensor(sd), runner.gpr.y_max,
                noise_std).numpy()

        for what, kwargs in (("mean", {}), ("std", {}),
                             ("acq", {"acq_func": acq_fn})):
            gplots.plot_model_2d(
                runner.gpr, what=what,
                save=os.path.join(
                    path, f"contours_{what}_iteration_{it:03d}.png"),
                **kwargs)
    return path
