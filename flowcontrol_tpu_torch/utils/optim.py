"""Optimization-campaign utilities for controller tuning.

A transcription of ``flowcontrol_tpu/utils/optim.py`` (ref:
src/utils/optim.py) that needs no pandas. The reference's MPI master-worker
protocol (rank-0 optimizer + all-rank collective cost evaluation +
stop-flag broadcast, ref: optim.py:71-107) is replaced by one batched
rollout: ``batch_evaluate`` scores a whole candidate population with one
closed-loop rollout of stacked controllers (``core/controller.py``
``stack_controllers``, ``Stepper.closed_loop_fn``).

Where this module differs from the JAX package's:

- ``write_results`` and ``write_optim_csv`` write with the ``csv`` module
  the bytes pandas' ``DataFrame.to_csv(index=False)`` writes there (floats
  as their shortest repr, NaN as an empty cell, booleans as True/False).
- ``compute_signal_cost`` reduces a numpy array where the JAX package
  builds a ``pd.Series``, so a ``scaling`` callable receives an ndarray
  (and, for ``'terminal'``, the last value as a numpy scalar).
"""

from __future__ import annotations

import csv
import math
from pathlib import Path
from typing import Callable

import numpy as np


def fun_array(x: np.ndarray, fun: Callable[..., float], **kwargs) -> np.ndarray:
    """Evaluate a scalar cost on a batch of points: (n, dim) -> (n, 1)
    (ref: optim.py:48-68)."""
    x = np.atleast_2d(np.asarray(x))
    out = np.zeros((x.shape[0], 1))
    for i in range(x.shape[0]):
        out[i, 0] = fun(x[i, :], **kwargs)
    return out


def batch_evaluate(thetas: np.ndarray, rollout_cost_fn: Callable) -> np.ndarray:
    """Evaluate a candidate population with one batched rollout.

    ``rollout_cost_fn(thetas (B, dim)) -> costs (B,)`` is typically built
    from ``Stepper.closed_loop_fn`` over stacked controller parameters. This
    replaces the reference's MPI master-worker evaluation loop with one
    device rollout (SURVEY §2.5-3).
    """
    thetas = np.atleast_2d(np.asarray(thetas))
    return np.asarray(rollout_cost_fn(thetas)).reshape(-1)


def cummin(J: np.ndarray, x: np.ndarray | None = None):
    """Cumulative minimum of a cost history; optionally the matching points
    (ref: optim.py:110-137)."""
    J = np.asarray(J).reshape(-1)
    best = np.empty(len(J), dtype=int)
    cur = 0
    for i in range(len(J)):
        if J[i] < J[cur]:
            cur = i
        best[i] = cur
    Jc = J[best]
    if x is None:
        return Jc
    return Jc, np.asarray(x)[best]


def sobol_sample(n: int, ndim: int, bounds=None, seed: int = 0) -> np.ndarray:
    """Sobol low-discrepancy samples in the given box (ref: optim.py:177-225)."""
    from scipy.stats import qmc

    sampler = qmc.Sobol(d=ndim, scramble=True, seed=seed)
    x = sampler.random(n)
    if bounds is not None:
        lo = np.asarray([b[0] for b in bounds])
        hi = np.asarray([b[1] for b in bounds])
        x = lo + x * (hi - lo)
    return x


def _cell(v) -> str:
    """One value as pandas' ``to_csv`` writes it."""
    if isinstance(v, (bool, np.bool_)):
        return str(bool(v))
    if isinstance(v, (float, np.floating)):
        if math.isnan(v):
            return ""
        # float64 (a float subclass) as its shortest repr, f32 as numpy prints it
        return repr(float(v)) if isinstance(v, float) else str(v)
    return str(v)


def _write_rows(path: Path, columns, rows, mode: str, header: bool) -> None:
    with open(path, mode, newline="") as f:
        w = csv.writer(f, lineterminator="\n")
        if header:
            w.writerow(columns)
        for r in rows:
            w.writerow([_cell(v) for v in r])


def write_results(path, x: np.ndarray, J: np.ndarray, columns=None) -> None:
    """Campaign CSV writer (ref: optim.py:140-174)."""
    x = np.atleast_2d(np.asarray(x))
    J = np.asarray(J).reshape(-1)
    cols = columns or [f"x{i + 1}" for i in range(x.shape[1])]
    if len(J) != x.shape[0]:
        raise ValueError(f"{len(J)} costs for {x.shape[0]} points")
    Path(path).parent.mkdir(parents=True, exist_ok=True)
    _write_rows(Path(path), list(cols) + ["J"], (list(xi) + [ji] for xi, ji in zip(x, J)),
                "w", header=True)


def write_optim_csv(path, x, J, diverged=False, append=True) -> None:
    """Append one evaluation record, marking diverged candidates
    (ref: optim.py:291-311 — throw_error=False runs return None and are
    scored as diverged)."""
    x = np.atleast_1d(np.asarray(x, dtype=float))
    row = {f"x{i + 1}": v for i, v in enumerate(x)}
    row["J"] = np.nan if diverged else float(J)
    row["diverged"] = bool(diverged)
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    header = not (append and path.exists())
    _write_rows(path, list(row), [list(row.values())], "a" if append else "w", header)


# ── FlowSolver cost evaluation (ref: optim.py:231-288) ───────────────────────


def compute_signal_cost(signal, Tnorm: float, criterion: str,
                        scaling: Callable | None = None) -> float:
    """Integral (time-averaged) or terminal cost of a 1D timeseries.

    ``scaling`` receives a numpy array (the JAX package passes a
    ``pd.Series``)."""
    if criterion not in ("integral", "terminal"):
        raise ValueError(
            f"Unknown criterion {criterion!r}: expected 'integral' or 'terminal'."
        )
    scaling = scaling or (lambda v: v)
    sig = np.asarray(signal).reshape(-1)
    if criterion == "integral":
        return float(np.sum(scaling(sig)) * Tnorm)
    return float(scaling(sig[-1]))


def compute_control_cost(u_ctrl, Tnorm: float) -> float:
    """Time-normalized control effort ∫‖u‖² dt (all channels summed)."""
    return float(np.sum(np.asarray(u_ctrl) ** 2) * Tnorm)


def parallel_function_wrapper(x, stop_all, fun):
    """Reference-compatible cost-evaluation wrapper (ref: optim.py:71-107).

    In the reference, rank 0 drives the optimizer while all MPI ranks
    co-evaluate each collective FEM cost, with ``stop_all`` broadcast as the
    termination flag. This framework is single-program, so the wrapper
    reduces to: evaluate unless stopped. The signature and the stop-flag
    contract are preserved so reference optimization drivers port
    line-for-line; for population-scale search use ``batch_evaluate``.
    """
    if stop_all[0] != 0:
        return 0.0
    return float(fun(x))
