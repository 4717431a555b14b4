"""DOF-sharded operators: domain decomposition with a halo exchange.

The counterpart of ``flowcontrol_tpu/parallel/dofsharding.py``, the
memory-scaling companion of ``parallel/sharding.py`` (which splits the
cells but keeps every dof vector whole on each rank). Here the dof vector
itself is split: each rank owns a contiguous block of spatially ordered
dofs, holds only the cells assigned to it, and fetches the halo it needs
from its two neighbours, the analogue of dolfin/PETSc's ghost-dof exchange
(ref: src/flowcontrol/flowsolver.py:236-238, src/utils/mpi.py).

Construction (host, once, the same on every rank): :class:`DofPartition`,
a bitwise copy of the JAX package's tables: the mixed dofs ordered by their
coordinate (x, then y), cut into blocks of ``n_loc``, each cell given to the
rank that owns its median dof, every cell's dofs inside that rank's window
of three blocks [left | own | right] (checked).

Apply (per product, :class:`DofShardedOperator`): two transfers fetch the
neighbours' blocks, the rank's own CSR (its cells, assembled over its
window of 3·n_loc dofs: the port's form of the JAX package's per-element
gather and scatter, as in ``parallel/sharding.py``) multiplies the window,
and two transfers return the halo's sums to the neighbours
(``comm.exchange``: ``batch_isend_irecv``, the JAX ``ppermute``).
Communication is O(n_loc) a rank.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from flowcontrol_tpu_torch.parallel import comm


def mixed_dof_coordinates(space) -> np.ndarray:
    """(n_dofs, 2) coordinate of every mixed dof (vel nodes + P1 vertices)."""
    vel = np.repeat(space.vel_node_coords, 2, axis=0)  # (2*n_vnodes, 2)
    return np.concatenate([vel, space.mesh.coords], axis=0)


@dataclass
class DofPartition:
    """Host-side description of a 1-D spatial dof decomposition."""

    perm: np.ndarray  # (n_pad,) spatial position -> global dof (pad: -1)
    iperm: np.ndarray  # (n,) global dof -> spatial position
    n_dofs: int
    n_loc: int
    n_dev: int
    cell_dev: np.ndarray  # (nc,) owning device per cell

    @classmethod
    def build(cls, space, n_dev: int) -> "DofPartition":
        n = space.n_dofs
        coords = mixed_dof_coordinates(space)
        order = np.lexsort((coords[:, 1], coords[:, 0]))  # sort by x, then y
        iperm = np.empty(n, dtype=np.int64)
        iperm[order] = np.arange(n)
        n_loc = -(-n // n_dev)
        n_pad = n_loc * n_dev
        perm = np.full(n_pad, -1, dtype=np.int64)
        perm[:n] = order
        sidx = iperm[space.cell_dofs]  # (nc, 15) spatial indices
        cell_dev = np.clip(
            np.median(sidx, axis=1).astype(np.int64) // n_loc, 0, n_dev - 1
        )
        # window feasibility: every cell dof within owner's 3-block window
        lo = (cell_dev - 1) * n_loc
        hi = (cell_dev + 2) * n_loc
        ok = (sidx >= lo[:, None]) & (sidx < hi[:, None])
        if not ok.all():
            bad = int((~ok.all(axis=1)).sum())
            raise ValueError(
                f"{bad} cells span more than one neighbor block "
                f"(n_loc={n_loc}); use fewer devices or a larger mesh"
            )
        return cls(
            perm=perm, iperm=iperm, n_dofs=n, n_loc=n_loc, n_dev=n_dev,
            cell_dev=cell_dev,
        )

    # ── global <-> sharded vector transport (host-side helpers) ─────────────

    def to_spatial(self, x_global: np.ndarray) -> np.ndarray:
        """(.., n) global-order -> (.., n_pad) spatial-order, zero padded."""
        x = np.asarray(x_global)
        out = np.zeros(x.shape[:-1] + (self.perm.shape[0],), dtype=x.dtype)
        out[..., : self.n_dofs] = 0.0
        valid = self.perm >= 0
        out[..., valid] = x[..., self.perm[valid]]
        return out

    def from_spatial(self, x_spatial: np.ndarray) -> np.ndarray:
        x = np.asarray(x_spatial)
        return x[..., self.iperm]


class DofShardedOperator:
    """y = A x with the dof vector and the cells split over the ranks of
    ``group``.

    ``apply`` takes and gives this rank's block (n_loc,) of a spatially
    ordered vector on ``device``; a rank holds O(n/n_dev) of the vector and
    O(nnz/n_dev) of the operator. ``a_e`` (nc, 15, 15) are the element
    tensors, ``cell_dofs`` (nc, 15) their mixed dofs; ``dtype`` the CSR's
    (default float64).
    """

    def __init__(self, a_e, cell_dofs, space, group, device, dtype: torch.dtype = torch.float64):
        from flowcontrol_tpu_torch.core.stepper import csr_to_device
        from flowcontrol_tpu_torch.fem.assembly import to_scipy_csr

        n_dev = comm.group_size(group)
        self.group = group
        self.rank = comm.group_rank(group)
        self.device = torch.device(device)
        self.dtype = dtype
        part = DofPartition.build(space, n_dev)
        self.part = part
        n_loc = part.n_loc
        cd_s = part.iperm[np.asarray(cell_dofs)]  # spatial indices (nc, 15)
        mine = np.where(part.cell_dev == self.rank)[0]
        # window-relative connectivity of this rank's cells: [0, 3 n_loc)
        rel = cd_s[mine] - (self.rank - 1) * n_loc
        self.n_cells = len(mine)
        self.window = 3 * n_loc
        a = to_scipy_csr(np.asarray(a_e)[mine], rel, self.window)
        self._a = csr_to_device(a, self.device, dtype)

    # ── public API ───────────────────────────────────────────────────────────

    def shard_vector(self, x_global: np.ndarray) -> torch.Tensor:
        """Global-order host vector -> this rank's block of the spatially
        ordered vector, on the device."""
        xs = self.part.to_spatial(x_global).reshape(self.part.n_dev, self.part.n_loc)
        return torch.as_tensor(np.ascontiguousarray(xs[self.rank]), dtype=self.dtype,
                               device=self.device)

    def unshard_vector(self, x_local: torch.Tensor) -> np.ndarray:
        """Every rank's block gathered -> the global-order host vector."""
        full = comm.all_gather_rows(x_local, self.group).reshape(-1)
        return self.part.from_spatial(full.cpu().numpy())

    def apply(self, x_local: torch.Tensor) -> torch.Tensor:
        """y = A x on this rank's block (n_loc,): the halo exchange, the
        window's product and the halo's sums returned."""
        n_dev, me, n_loc = self.part.n_dev, self.rank, self.part.n_loc
        left, right = (me - 1) % n_dev, (me + 1) % n_dev
        x_local = x_local.contiguous()
        from_left, from_right = torch.empty_like(x_local), torch.empty_like(x_local)
        # tag 0: a block travelling right, tag 1: travelling left
        comm.exchange([(x_local, right, 0), (x_local, left, 1)],
                      [(from_left, left, 0), (from_right, right, 1)], self.group)
        window = torch.cat([from_left, x_local, from_right])
        yw = torch.mv(self._a, window)
        y_left, y_own, y_right = yw[:n_loc], yw[n_loc: 2 * n_loc], yw[2 * n_loc:]
        # my left-window sums belong to the left neighbour, my right ones to
        # the right
        add_from_right, add_from_left = torch.empty_like(y_own), torch.empty_like(y_own)
        comm.exchange([(y_left.contiguous(), left, 1), (y_right.contiguous(), right, 0)],
                      [(add_from_right, right, 1), (add_from_left, left, 0)], self.group)
        return y_own + add_from_right + add_from_left

    def per_device_nbytes(self) -> int:
        """Bytes of this rank's share of the operator (its CSR's values,
        column indices and row pointers)."""
        a = self._a
        return int(sum(t.numel() * t.element_size()
                       for t in (a.values(), a.col_indices(), a.crow_indices())))
