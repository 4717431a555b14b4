"""Unified optimizer wrappers for controller-tuning campaigns.

A transcription of ``flowcontrol_tpu/utils/optim_algs.py`` (ref:
src/utils/optim_algs.py): a single ``minimize`` entry point over scipy
Nelder-Mead/COBYLA/BFGS/SLSQP plus derivative-free ('dfo' via blackbox_opt)
and Bayesian ('bo' via SMT) backends, each with a built-in method used when
its package is not installed, and a population search ('pop') that scores
a whole generation with one call of ``batch_costfun``: on the card, one
batched closed-loop rollout of stacked controllers
(``Stepper.closed_loop_fn``).
"""

from __future__ import annotations

import logging
import time
from typing import Callable

import numpy as np
import scipy.optimize as so

logger = logging.getLogger(__name__)

_DEFAULT_MAXFEV = 100

_SCIPY_METHODS = {
    "nm": "Nelder-Mead",
    "cobyla": "COBYLA",
    "bfgs": "BFGS",
    "slsqp": "SLSQP",
}

_DEFAULT_OPTIONS = {
    "nm": dict(maxfev=_DEFAULT_MAXFEV, xatol=1e-4, fatol=1e-4, adaptive=True,
               initial_simplex=None, return_all=True, disp=False),
    "cobyla": dict(maxiter=_DEFAULT_MAXFEV, rhobeg=0.5, tol=1e-4, disp=False),
    "bfgs": dict(maxiter=_DEFAULT_MAXFEV, eps=1e-3, gtol=1e-4, disp=False,
                 return_all=True),
    "slsqp": dict(maxiter=_DEFAULT_MAXFEV, eps=1e-3, ftol=1e-4, disp=False),
    "dfo": dict(maxfev=_DEFAULT_MAXFEV, init_delta=0.5, tol_delta=1e-4,
                tol_f=1e-4, tol_norm_g=1e-4, sample_gen="auto", disp=False),
    "bo": dict(n_iter=_DEFAULT_MAXFEV, n_doe=10, criterion="EI", xlimits=None,
               random_state=None, disp=False),
    "pop": dict(n_iter=20, popsize=32, sigma0=0.5, seed=0, disp=False),
}


def construct_simplex(x0: np.ndarray, rectangular: bool = True, edgelen=1):
    """Initial NM simplex around x0 (ref: optim_algs.py:38-74)."""
    x0 = np.asarray(x0, dtype=float).ravel()
    n = x0.shape[0]
    if np.isscalar(edgelen):
        edgelen = [edgelen] * n
    if rectangular:
        simplex = np.zeros((n + 1, n))
        simplex[0] = x0
        for ii in range(n):
            simplex[ii + 1] = x0 + np.eye(n)[ii] * edgelen[ii]
    else:
        simplex = np.vstack((np.zeros((1, n)), np.diag(edgelen)))
        simplex = simplex - 1 / (n + 1) + x0
    return simplex


def nm_select_evaluated_points(x_best, x_all, y_all, verbose: bool = False):
    """Cost values of the best-so-far NM vertices (ref: optim_algs.py:77-117)."""
    uidx = np.unique(np.asarray(x_best), axis=0, return_index=True)[1]
    x_good = [x_best[i] for i in sorted(uidx)]
    y_good = [None] * len(x_good)
    for ii, el in enumerate(x_good):
        for jj in range(len(x_all)):
            if np.allclose(x_all[jj], el):
                y_good[ii] = y_all[jj]
                break
        if y_good[ii] is None:
            raise ValueError(f"Point x_best[{ii}] not found in x_all.")
    return x_good, y_good


def optimizer_default_options(alg: str) -> dict:
    try:
        return dict(_DEFAULT_OPTIONS[alg])
    except KeyError:
        raise ValueError(f"Unknown optimization algorithm: {alg!r}") from None


def optimizer_check_options(default_options: dict, options: dict) -> dict:
    """Merge user options into defaults, ignoring unknown keys."""
    return {k: options.get(k, v) for k, v in default_options.items()}


def _minimize_dfo_builtin(costfun, x0, options):
    """Own derivative-free trust-region fallback (compass/pattern search
    with an expanding/contracting radius). Used whenever blackbox_opt is
    absent so alg='dfo' is a live, tested code path in every environment —
    not an untestable optional-dependency branch."""
    x = np.asarray(x0, dtype=float).ravel()
    n = len(x)
    delta = float(options["init_delta"])
    tol_delta = float(options["tol_delta"])
    tol_f = float(options["tol_f"])
    maxfev = int(options["maxfev"])
    f = float(costfun(x))
    nfev = 1
    while delta > tol_delta and nfev < maxfev:
        improved = False
        for i in range(n):
            for sgn in (1.0, -1.0):
                cand = x.copy()
                cand[i] += sgn * delta
                fc = float(costfun(cand))
                nfev += 1
                if np.isfinite(fc) and fc < f - 1e-30:
                    gain = f - fc
                    x, f = cand, fc
                    improved = True
                    if gain < tol_f:
                        delta = tol_delta  # converged in f
                    break
                if nfev >= maxfev:
                    break
            if nfev >= maxfev:
                break
        delta = delta * (2.0 if improved else 0.5)
    return so.OptimizeResult(x=x, fun=f, nfev=nfev, success=True)


def _minimize_dfo(costfun, x0, options):
    """Derivative-free trust-region: blackbox_opt when installed, else the
    built-in compass-search fallback (same options surface)."""
    try:
        from blackbox_opt.bb_optimize import bb_optimize
    except ImportError:
        return _minimize_dfo_builtin(costfun, x0, options)
    res = bb_optimize(func=costfun, x_0=x0, alg="DFO", options=options)
    res.nfev = res.func_eval
    return res


def _minimize_bo_builtin(costfun: Callable, x0, options: dict):
    """Own Bayesian-optimization fallback: GP (RBF kernel, jittered
    Cholesky) + expected-improvement acquisition maximized over a random
    candidate cloud. Replaces SMT's EGO when absent — live and tested in
    every environment."""
    rng = np.random.default_rng(options["random_state"])
    xlimits = np.asarray(options["xlimits"], dtype=float)  # (dim, 2)
    dim = xlimits.shape[0]
    lo, hi = xlimits[:, 0], xlimits[:, 1]
    span = hi - lo

    def sample(m):
        return lo + span * rng.random((m, dim))

    n_doe = max(int(options["n_doe"]), 2)
    X = sample(n_doe)
    if x0 is not None:
        X[0] = np.clip(np.asarray(x0, dtype=float).ravel(), lo, hi)
    Y = np.array([float(costfun(x)) for x in X])

    def gp_posterior(Xs):
        # unit-scaled inputs, standardized outputs
        Xu, Xsu = X / span, Xs / span
        ell = 0.3 * np.sqrt(dim)
        d2 = ((Xu[:, None, :] - Xu[None, :, :]) ** 2).sum(-1)
        mu0, sd0 = Y.mean(), max(Y.std(), 1e-12)
        K = np.exp(-0.5 * d2 / ell**2) + 1e-6 * np.eye(len(X))
        L = np.linalg.cholesky(K)
        alpha = np.linalg.solve(L.T, np.linalg.solve(L, (Y - mu0) / sd0))
        d2s = ((Xsu[:, None, :] - Xu[None, :, :]) ** 2).sum(-1)
        ks = np.exp(-0.5 * d2s / ell**2)
        mu = mu0 + sd0 * ks @ alpha
        v = np.linalg.solve(L, ks.T)
        var = np.maximum(1.0 - (v**2).sum(0), 1e-12)
        return mu, sd0 * np.sqrt(var)

    from scipy.stats import norm

    for _ in range(int(options["n_iter"])):
        cand = sample(256 * dim)
        mu, sd = gp_posterior(cand)
        ybest = Y.min()
        z = (ybest - mu) / sd
        ei = sd * (z * norm.cdf(z) + norm.pdf(z))
        xn = cand[int(np.argmax(ei))]
        X = np.vstack([X, xn])
        Y = np.append(Y, float(costfun(xn)))
    ib = int(np.argmin(Y))
    res = so.OptimizeResult(
        x=X[ib].copy(), fun=float(Y[ib]), nfev=len(Y), success=True
    )
    res.x_data, res.y_data = X, Y
    return res


def _minimize_bo(costfun: Callable, x0, options: dict):
    """Bayesian optimization: SMT's EGO when installed, else the built-in
    GP-EI fallback (ref: optim_algs.py:208-267)."""
    try:
        from smt.applications import EGO
        from smt.surrogate_models import KRG
    except ImportError:
        return _minimize_bo_builtin(costfun, x0, options)
    xlimits = np.asarray(options["xlimits"])
    ego = EGO(
        n_iter=options["n_iter"],
        criterion=options["criterion"],
        n_doe=options["n_doe"],
        surrogate=KRG(design_space=xlimits, print_global=False),
        random_state=options["random_state"],
    )
    x_opt, y_opt, _, x_data, y_data = ego.optimize(
        fun=lambda x: np.apply_along_axis(costfun, 1, np.atleast_2d(x)).reshape(-1, 1)
    )
    res = so.OptimizeResult(
        x=np.asarray(x_opt).ravel(), fun=float(np.asarray(y_opt).ravel()[0]),
        nfev=len(y_data), success=True,
    )
    res.x_data, res.y_data = x_data, y_data
    return res


def _minimize_population(costfun, x0, options, batch_costfun=None):
    """Simple (mu, lambda) evolution loop evaluating whole populations.

    Pass ``batch_costfun(X (B, dim)) -> (B,)`` built on a batched closed-loop
    rollout: each generation is one device rollout (replaces the reference's
    MPI master-worker loop)."""
    rng = np.random.default_rng(options["seed"])
    x = np.asarray(x0, dtype=float).ravel()
    sigma = options["sigma0"]
    pop = options["popsize"]
    best_x, best_f = x.copy(), np.inf
    nfev = 0
    for _ in range(options["n_iter"]):
        cand = x[None, :] + sigma * rng.standard_normal((pop, len(x)))
        if batch_costfun is not None:
            f = np.asarray(batch_costfun(cand)).reshape(-1)
        else:
            f = np.array([costfun(c) for c in cand])
        nfev += pop
        f = np.where(np.isfinite(f), f, np.inf)
        order = np.argsort(f)
        elite = cand[order[: max(pop // 4, 1)]]
        x = elite.mean(axis=0)
        sigma *= 0.95
        if f[order[0]] < best_f:
            best_f, best_x = f[order[0]], cand[order[0]].copy()
    return so.OptimizeResult(x=best_x, fun=best_f, nfev=nfev, success=True)


def minimize(costfun: Callable, x0, alg: str, options: dict,
             verbose: bool = True, batch_costfun=None):
    """Run an optimizer (ref: optim_algs.py:270-322).

    alg ∈ {'nm', 'cobyla', 'bfgs', 'slsqp', 'dfo', 'bo', 'pop'}.
    """
    tstart = time.time()
    alg = alg.lower()
    options = dict(options)
    options["disp"] = verbose
    options = optimizer_check_options(optimizer_default_options(alg), options)
    if alg in _SCIPY_METHODS:
        res = so.minimize(fun=costfun, x0=x0, method=_SCIPY_METHODS[alg],
                          options=options)
    elif alg == "dfo":
        res = _minimize_dfo(costfun, x0, options)
    elif alg == "bo":
        res = _minimize_bo(costfun, x0, options)
    elif alg == "pop":
        res = _minimize_population(costfun, x0, options, batch_costfun)
    else:
        raise ValueError(f"Unknown optimization algorithm: {alg!r}")
    logger.info("Total time: %.1f s with %s method.", time.time() - tstart, alg)
    return res
