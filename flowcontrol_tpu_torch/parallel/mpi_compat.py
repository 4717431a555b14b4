"""The reference's MPI utility layer over ``torch.distributed``.

The counterpart of ``flowcontrol_tpu/parallel/mpi_compat.py`` (ref:
src/utils/mpi.py). The JAX package runs one program, so there most of
these are trivial; the port runs one process per rank, and they ask the
initialized process group, if there is one: without one the process is
rank 0 of 1, as the reference's serial run is.
"""

from __future__ import annotations

import logging

import numpy as np
import torch
import torch.distributed as dist


def _initialized() -> bool:
    return dist.is_available() and dist.is_initialized()


def get_rank() -> int:
    """(ref: mpi.py:12) — this process's rank in the world, 0 without one."""
    return dist.get_rank() if _initialized() else 0


def check_process_rank() -> None:
    """Log this process's rank (ref: mpi.py:17-19)."""
    logging.getLogger(__name__).info("================= Hello I am process %d", get_rank())


def get_size() -> int:
    """The world's size, 1 without one."""
    return dist.get_world_size() if _initialized() else 1


def mpi_broadcast(value):
    """(ref: mpi.py:86-88) — rank 0's ``value`` on every rank (a picklable
    object, ``broadcast_object_list``); the value itself without a world."""
    if not _initialized() or dist.get_world_size() == 1:
        return value
    box = [value]
    dist.broadcast_object_list(box, src=0)
    return box[0]


def peval(flowsolver, up, point, sensor_component: int = 0) -> float:
    """Point evaluation of a mixed field (ref: mpi.py:22-37).

    The reference tries the evaluation on every rank and Allreduce(MIN)s the
    result; here every rank holds the whole field (the port's ranks
    replicate dof vectors, ``parallel/sharding.py``), so each evaluates it
    directly through the P2/P1 interpolation row."""
    from flowcontrol_tpu_torch.fem.facets import point_probe_row

    if isinstance(up, torch.Tensor):
        up = up.detach().cpu().numpy()
    row = point_probe_row(flowsolver.space, np.asarray(point), sensor_component)
    return float(np.asarray(up, dtype=np.float64) @ row)


peval1 = peval
peval2 = peval


class MpiUtils:
    """Legacy namespace (ref: mpi.py:92-98)."""

    get_rank = staticmethod(get_rank)
    check_process_rank = staticmethod(check_process_rank)
    mpi_broadcast = staticmethod(mpi_broadcast)
    peval = staticmethod(peval)
