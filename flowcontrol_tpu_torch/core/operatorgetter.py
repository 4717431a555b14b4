"""State-space operator export: A, E, B, C around a base flow.

The counterpart of ``flowcontrol_tpu/core/operatorgetter.py`` (ref:
src/flowcontrol/operatorgetter.py). The operators are host scipy CSR
(A, E) and numpy (B, C) in float64:

- ``get_A`` = -dF/dq (Jacobian of the negated steady residual) with Dirichlet
  rows set to identity (dolfin bc.apply semantics — rows only, columns kept;
  ref: operatorgetter.py:79-82). Both a hand-coded path (the host element
  matrices) and an autodiff path (``torch.func.jacfwd`` of the element
  residual, on ``fs.device`` in float64) are provided, mirroring the
  reference's autodiff-vs-manual 1e-10 agreement contract.
- ``get_mass_matrix`` = velocity-only mass E (pressure rows zero).
- ``get_B``: FORCE actuators → load vector ∫ b·v dx; BC actuators → lifting
  ``A_raw · w`` with w the unit-profile boundary function
  (ref: operatorgetter.py:163-181).
- ``get_C``: sensor rows (already precomputed by each sensor).
"""

from __future__ import annotations

import logging

import numpy as np
import scipy.sparse as sp
import torch

from flowcontrol_tpu_torch.core.actuator import ACTUATOR_TYPE
from flowcontrol_tpu_torch.core.sensor import sensor_matrix
from flowcontrol_tpu_torch.fem.assembly import (
    linear_operator_element,
    mass_velocity_element,
    steady_jacobian_elements_autodiff,
    to_scipy_csr,
    velocity_cell_values,
)
from flowcontrol_tpu_torch.fem.bc import BCSet

logger = logging.getLogger(__name__)


class OperatorGetter:
    def __init__(self, flowsolver):
        self.flowsolver = flowsolver

    # ── A ────────────────────────────────────────────────────────────────────

    def _a_raw_csr(self, up0: np.ndarray, autodiff: bool) -> sp.csr_matrix:
        """-dF/dq without BCs (sign: A q = dynamics right-hand side)."""
        fs = self.flowsolver
        if autodiff:
            up = torch.as_tensor(up0, dtype=torch.float64, device=fs.device)
            j_e = steady_jacobian_elements_autodiff(
                fs.geom, fs.space, up, 1.0 / fs.params_flow.Re
            ).cpu().numpy()
        else:
            u0 = up0[: fs.space.n_vel_dofs].reshape(fs.space.n_vnodes, 2)
            j_e = linear_operator_element(
                fs.geom,
                velocity_cell_values(fs.space, u0),
                1.0 / fs.params_flow.Re,
            )
        return to_scipy_csr(-j_e, fs.space.cell_dofs, fs.space.n_dofs)

    def get_A(
        self,
        UP0: np.ndarray | None = None,
        autodiff: bool = True,
        u_ctrl=None,
    ) -> sp.csr_matrix:
        """Linearized dynamics matrix A = -dF/dq, Dirichlet rows → identity."""
        logger.info("Computing jacobian A...")
        fs = self.flowsolver
        if UP0 is None:
            UP0 = fs.fields.UP0
        if u_ctrl is None:
            fs.flush_actuators_u_ctrl()
        else:
            fs.set_actuators_u_ctrl(u_ctrl)
        a = self._a_raw_csr(np.asarray(UP0), autodiff)
        # dolfin bc.apply(matrix): zero rows, unit diagonal (rows only)
        bcset = BCSet(fs.bc.bcu, fs.space.n_dofs)
        a = a.tolil()
        a[bcset.dofs, :] = 0.0
        a[bcset.dofs, bcset.dofs] = 1.0
        return a.tocsr()

    # ── E ────────────────────────────────────────────────────────────────────

    def get_mass_matrix(self) -> sp.csr_matrix:
        """Velocity-only mass matrix E (pressure rows zero)."""
        logger.info("Computing mass matrix E...")
        fs = self.flowsolver
        m_e = mass_velocity_element(fs.geom)
        return to_scipy_csr(m_e, fs.space.cell_dofs, fs.space.n_dofs)

    # ── B ────────────────────────────────────────────────────────────────────

    def get_B(self, UP0: np.ndarray | None = None) -> np.ndarray:
        """Actuation matrix B (n_dofs, n_actuators)."""
        logger.info("Computing actuation matrix B...")
        fs = self.flowsolver
        if UP0 is None:
            UP0 = fs.fields.UP0
        acts = fs.params_control.actuator_list
        n = fs.space.n_dofs
        b = np.zeros((n, len(acts)))
        a_raw = None
        if any(a.actuator_type is ACTUATOR_TYPE.BC for a in acts):
            a_raw = self._a_raw_csr(np.asarray(UP0), autodiff=False)
        for ii, act in enumerate(acts):
            if act.actuator_type is ACTUATOR_TYPE.FORCE:
                b[:, ii] = fs._force_cols[ii]
            elif act.actuator_type is ACTUATOR_TYPE.BC:
                # lifting: unit-profile boundary function w, column = A_raw·w
                bc = fs.dirichlet_bc(act.boundary_name, actuator=ii)
                w = np.zeros(n)
                w[bc.dofs] = bc.profile
                b[:, ii] = a_raw @ w
            else:
                raise NotImplementedError(
                    f"Actuator type {act.actuator_type} not supported in get_B"
                )
        logger.info(f"Finished computing B of size {b.shape}")
        return b

    # ── C ────────────────────────────────────────────────────────────────────

    def get_C(self) -> np.ndarray:
        """Measurement matrix C (n_sensors, n_dofs) from precomputed rows."""
        logger.info("Computing measurement matrix C...")
        fs = self.flowsolver
        return sensor_matrix(fs.params_control.sensor_list, fs.space.n_dofs)

    def get_all(self, autodiff: bool = True, u_ctrl=None) -> tuple:
        """(A, E, B, C) — ref: operatorgetter.py:241-265."""
        a = self.get_A(autodiff=autodiff, u_ctrl=u_ctrl)
        e = self.get_mass_matrix()
        b = self.get_B()
        c = self.get_C()
        return a, e, b, c
