"""FEM convenience helpers: projections, subspace dof maps, timing summaries.

A transcription of ``flowcontrol_tpu/utils/fem.py`` (ref: src/utils/fem.py).
The C++ boundary-expression string builders (near_cpp/between_cpp, ref:
fem.py:53-70) have no equivalent here: boundary predicates are plain
vectorized Python (see Mesh2D.mark_boundaries). ``print0`` asks
``torch.distributed`` for the rank where the JAX package asks
``jax.process_index()``.
"""

from __future__ import annotations

import logging

import numpy as np

logger = logging.getLogger(__name__)


def projectm(flowsolver, fn, target: str = "velocity", bcs=None):
    """L2 projection onto velocity or pressure space (ref: fem.py:16 —
    project with a direct solver)."""
    from flowcontrol_tpu_torch.fem.projection import project_pressure, project_velocity

    if target == "velocity":
        return project_velocity(flowsolver.geom, flowsolver.space, fn)
    return project_pressure(flowsolver.geom, flowsolver.space, fn)


def print0(*args, **kwargs) -> None:
    """Rank-0 print (ref: fem.py:30): prints on rank 0 of
    ``torch.distributed`` when a process group is initialized, and always
    otherwise."""
    import torch.distributed as dist

    if not (dist.is_available() and dist.is_initialized()) or dist.get_rank() == 0:
        print(*args, **kwargs)


def apply_fun(flowsolver, field: np.ndarray, fun) -> float:
    """Global reduction of fun over all dof values (ref: fem.py:19-27 —
    allgather-then-reduce; single device array here)."""
    return float(fun(np.asarray(field).reshape(-1)))


def get_subspace_dofs(space) -> dict:
    """{'u': ..., 'v': ..., 'p': ...} global dof index arrays
    (ref: fem.py:76-86)."""
    n_vnodes = space.n_vnodes
    return {
        "u": np.arange(0, 2 * n_vnodes, 2),
        "v": np.arange(1, 2 * n_vnodes, 2),
        "p": 2 * n_vnodes + np.arange(space.n_pressure_dofs),
    }


def summarize_timings(timeseries, n_dofs: int | None = None) -> dict:
    """Per-iteration runtime summary (ref: fem.py:89-102): first/second
    iteration cost (compile), steady-state mean, time per iter per dof."""
    rt = np.asarray(timeseries["runtime"] if hasattr(timeseries, "keys") else timeseries)
    rt = rt[np.isfinite(rt)]
    rt = rt[rt > 0]
    out = {
        "iter_1": float(rt[0]) if len(rt) else np.nan,
        "iter_2": float(rt[1]) if len(rt) > 1 else np.nan,
        "mean_after_2": float(rt[2:].mean()) if len(rt) > 2 else np.nan,
        "steps_per_sec": float(1.0 / rt[2:].mean()) if len(rt) > 2 else np.nan,
    }
    if n_dofs:
        out["time_per_iter_per_dof"] = out["mean_after_2"] / n_dofs
    for k, v in out.items():
        logger.info(f"{k}: {v:.6g}")
    return out
