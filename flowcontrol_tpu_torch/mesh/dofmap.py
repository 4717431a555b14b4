"""Taylor-Hood (P2 velocity / P1 pressure) DOF maps as flat arrays.

Replaces dolfin FunctionSpace / DofMap construction
(ref: src/flowcontrol/flowsolver.py:242-250). Built once on host; shipped to
the device as static index tensors. Transcribed from
``flowcontrol_tpu/mesh/dofmap.py``.

Global mixed-vector layout (size ``n_dofs = 2*n_vnodes + n_vertices``):

- velocity node ``k`` (vertices first, then edge midpoints), component ``c``
  → dof ``2*k + c`` (interleaved, dolfin-like)
- pressure vertex ``j`` → dof ``2*n_vnodes + j``

Local element layout (15 dofs):

- 0..11: velocity (node-major, component-minor) over the 6 P2 nodes
  (3 vertices, then 3 edge midpoints — edge ``k`` opposite vertex ``k``)
- 12..14: pressure at the 3 vertices
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from flowcontrol_tpu_torch.config import HOST_DTYPE, INDEX_DTYPE
from flowcontrol_tpu_torch.mesh.mesh import Mesh2D

N_LOCAL_VEL_NODES = 6
N_LOCAL_DOFS = 15  # 12 velocity + 3 pressure


@dataclass
class TaylorHoodSpace:
    """Mixed P2/P1 space metadata for a triangle mesh."""

    mesh: Mesh2D
    vel_node_coords: np.ndarray  # (n_vnodes, 2) — vertices then edge midpoints
    cell_vel_nodes: np.ndarray  # (nc, 6) P2 node ids per cell
    cell_dofs: np.ndarray  # (nc, 15) global mixed dof ids per cell

    @classmethod
    def build(cls, mesh: Mesh2D) -> "TaylorHoodSpace":
        nv = mesh.num_vertices
        edges = mesh.edges
        midpoints = 0.5 * (mesh.coords[edges[:, 0]] + mesh.coords[edges[:, 1]])
        vel_node_coords = np.concatenate([mesh.coords, midpoints], axis=0)
        cell_vel_nodes = np.concatenate(
            [mesh.cells, nv + mesh.cell_edges], axis=1
        ).astype(INDEX_DTYPE)  # (nc, 6)

        n_vnodes = vel_node_coords.shape[0]
        vel_dofs = (2 * cell_vel_nodes[:, :, None] + np.arange(2)).reshape(
            -1, 12
        )  # (nc, 12) node-major, comp-minor
        p_dofs = 2 * n_vnodes + mesh.cells
        cell_dofs = np.concatenate([vel_dofs, p_dofs], axis=1).astype(INDEX_DTYPE)
        return cls(
            mesh=mesh,
            vel_node_coords=np.ascontiguousarray(vel_node_coords, dtype=HOST_DTYPE),
            cell_vel_nodes=cell_vel_nodes,
            cell_dofs=np.ascontiguousarray(cell_dofs),
        )

    # ── Sizes ────────────────────────────────────────────────────────────────

    @property
    def n_vnodes(self) -> int:
        return self.vel_node_coords.shape[0]

    @property
    def n_vel_dofs(self) -> int:
        return 2 * self.n_vnodes

    @property
    def n_pressure_dofs(self) -> int:
        return self.mesh.num_vertices

    @property
    def n_dofs(self) -> int:
        return self.n_vel_dofs + self.n_pressure_dofs

    # ── Field layout helpers ─────────────────────────────────────────────────

    def split(self, x: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
        """Split a mixed vector into velocity ``(n_vnodes, 2)`` and pressure ``(nv,)``.

        Works on numpy arrays or torch tensors; supports leading batch dims.
        """
        nvel = self.n_vel_dofs
        u = x[..., :nvel].reshape(*x.shape[:-1], self.n_vnodes, 2)
        p = x[..., nvel:]
        return u, p

    def merge(self, u: np.ndarray, p: np.ndarray) -> np.ndarray:
        """Inverse of :meth:`split` (ref: FlowSolver.merge, flowsolver.py:845-862)."""
        batch = u.shape[:-2]
        uflat = u.reshape(*batch, self.n_vel_dofs)
        return np.concatenate([uflat, p], axis=-1) if isinstance(
            u, np.ndarray
        ) else None

    def velocity_dofs_of_nodes(self, nodes: np.ndarray, component: int | None = None):
        """Global velocity dof ids for the given P2 node ids."""
        nodes = np.asarray(nodes, dtype=np.int64)
        if component is None:
            return np.concatenate([2 * nodes, 2 * nodes + 1])
        return 2 * nodes + component

    def boundary_vel_nodes(self, facet_rows: np.ndarray) -> np.ndarray:
        """P2 node ids (vertices + edge midpoints) on the given boundary facets."""
        mesh = self.mesh
        f = mesh.boundary_facets[facet_rows]
        edge_nodes = mesh.num_vertices + mesh.boundary_edge_ids[facet_rows]
        return np.unique(np.concatenate([f.ravel(), edge_nodes]))

    def interpolate_velocity(self, fn) -> np.ndarray:
        """Nodal interpolation of ``fn(x) -> (n, 2)`` onto P2 nodes."""
        vals = np.asarray(fn(self.vel_node_coords), dtype=HOST_DTYPE)
        if vals.shape != (self.n_vnodes, 2):
            raise ValueError(f"expected ({self.n_vnodes}, 2), got {vals.shape}")
        return vals

    def interpolate_pressure(self, fn) -> np.ndarray:
        vals = np.asarray(fn(self.mesh.coords), dtype=HOST_DTYPE)
        if vals.shape != (self.mesh.num_vertices,):
            raise ValueError(f"bad pressure interp shape {vals.shape}")
        return vals
