"""Dirichlet boundary-condition handling.

Replaces dolfin.DirichletBC + SystemAssembler BC semantics
(ref: src/examples/cylinder/cylinderflowsolver.py:90-108 and
src/flowcontrol/flowsolver.py:693). dolfin's SystemAssembler performs
symmetric elimination: constrained rows AND columns are zeroed, the diagonal
set to 1, and the RHS lifted by ``b -= A[:, c] g`` before setting
``b[c] = g``. We reproduce exactly that, in two forms:

- host-side: modify a scipy CSR matrix (for direct factorization / export)
- device-side: masked matrix-free operator + precomputed lifting vectors
  (actuation values enter as rank-1 updates: ``lift_a = A @ profile_a``),
  so control amplitudes never trigger re-assembly — unlike the reference,
  where the actuator Expression is mutated and the RHS re-assembled
  (ref: flowsolver.py:724-728).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Sequence

import numpy as np

from flowcontrol_tpu_torch.config import HOST_DTYPE


@dataclass
class DirichletBC:
    """A set of constrained dofs with fixed values and/or an actuator profile.

    ``values``: static part of the BC value at each dof (usually 0 for
    perturbation-form BCs, uinf for full-field inlet).
    ``actuator_index``: if >= 0, the BC value is
    ``values + u_ctrl[actuator_index] * profile``.
    """

    dofs: np.ndarray  # (m,) int64 global dof ids
    values: np.ndarray  # (m,) float
    actuator_index: int = -1
    profile: np.ndarray | None = None  # (m,) float

    def __post_init__(self):
        self.dofs = np.asarray(self.dofs, dtype=np.int64)
        self.values = np.broadcast_to(
            np.asarray(self.values, dtype=HOST_DTYPE), self.dofs.shape
        ).copy()
        if self.profile is not None:
            self.profile = np.asarray(self.profile, dtype=HOST_DTYPE)


class BCSet:
    """Merged view of several DirichletBCs on one dof space.

    Later BCs overwrite earlier ones on shared dofs (dolfin applies BCs in
    list order, with the last write winning).
    """

    def __init__(self, bcs: Sequence[DirichletBC], n_dofs: int):
        self.n_dofs = n_dofs
        self.bcs = list(bcs)
        dof_value: dict[int, float] = {}
        dof_act: dict[int, tuple[int, float]] = {}
        n_act = 0
        for bc in self.bcs:
            for k, d in enumerate(bc.dofs):
                dof_value[int(d)] = float(bc.values[k])
                if bc.actuator_index >= 0:
                    dof_act[int(d)] = (bc.actuator_index, float(bc.profile[k]))
                    n_act = max(n_act, bc.actuator_index + 1)
                elif int(d) in dof_act:
                    del dof_act[int(d)]
        self.dofs = np.array(sorted(dof_value.keys()), dtype=np.int64)
        self.values = np.array([dof_value[d] for d in self.dofs], dtype=HOST_DTYPE)
        self.n_actuators = n_act
        # profiles: (n_act, m) sparse-ish dense matrix of actuator profiles
        self.profiles = np.zeros((n_act, len(self.dofs)), dtype=HOST_DTYPE)
        pos = {int(d): i for i, d in enumerate(self.dofs)}
        for d, (ai, pv) in dof_act.items():
            self.profiles[ai, pos[d]] = pv
        # masks
        self.free_mask = np.ones(n_dofs, dtype=bool)
        self.free_mask[self.dofs] = False

    # ── Full-size helper vectors ─────────────────────────────────────────────

    def g_static(self) -> np.ndarray:
        """(n,) vector with static BC values at constrained dofs, 0 elsewhere."""
        g = np.zeros(self.n_dofs, dtype=HOST_DTYPE)
        g[self.dofs] = self.values
        return g

    def g_profiles(self) -> np.ndarray:
        """(n_act, n) full-size actuator profile vectors."""
        g = np.zeros((self.n_actuators, self.n_dofs), dtype=HOST_DTYPE)
        g[:, self.dofs] = self.profiles
        return g

    def apply_vector(self, x: np.ndarray, u_ctrl=None) -> np.ndarray:
        """Overwrite constrained entries of x with BC values (dolfin bc.apply)."""
        x = np.array(x, dtype=HOST_DTYPE, copy=True)
        vals = self.values.copy()
        if self.n_actuators and u_ctrl is not None:
            vals = vals + np.asarray(u_ctrl, dtype=HOST_DTYPE) @ self.profiles
        x[self.dofs] = vals
        return x

    # ── Matrix modification (host) ───────────────────────────────────────────

    def eliminate_csr(self, a_csr):
        """Symmetric elimination on a scipy CSR matrix.

        Returns ``(A_bc, lift_cols)`` where ``A_bc`` has identity rows/cols at
        constrained dofs and ``lift_cols`` is the (n, m) matrix of original
        columns A[:, dofs] (rows at constrained dofs zeroed) needed for RHS
        lifting ``b_free -= lift_cols @ g``.
        """
        import scipy.sparse as sp

        n = self.n_dofs
        m = len(self.dofs)
        lift = a_csr[:, self.dofs].toarray() if m else np.zeros((n, 0))
        lift[self.dofs, :] = 0.0
        keep = sp.diags(self.free_mask.astype(np.float64))
        a_bc = keep @ a_csr @ keep
        a_bc = a_bc.tolil()
        a_bc[self.dofs, self.dofs] = 1.0
        return a_bc.tocsr(), np.asarray(lift)

    def reduce_rhs(self, b: np.ndarray, u_ctrl=None, lift_cols=None) -> np.ndarray:
        """Apply SystemAssembler RHS semantics: lift columns, set BC values."""
        b = np.array(b, dtype=HOST_DTYPE, copy=True)
        vals = self.values.copy()
        if self.n_actuators and u_ctrl is not None:
            vals = vals + np.asarray(u_ctrl, dtype=HOST_DTYPE) @ self.profiles
        if lift_cols is not None and len(self.dofs):
            b -= lift_cols @ vals
        b[self.dofs] = vals
        return b
