"""Coordinates of the mixed dofs.

The counterpart of ``flowcontrol_tpu/parallel/dofsharding.py``, as far as
the multifrontal ordering needs it: :func:`mixed_dof_coordinates`. The
dof-sharded operators of that module (halo exchange over several devices)
are not ported yet (ROADMAP.md, "Multi-GPU").
"""

from __future__ import annotations

import numpy as np


def mixed_dof_coordinates(space) -> np.ndarray:
    """(n_dofs, 2) coordinate of every mixed dof (vel nodes + P1 vertices)."""
    vel = np.repeat(space.vel_node_coords, 2, axis=0)  # (2*n_vnodes, 2)
    return np.concatenate([vel, space.mesh.coords], axis=0)
