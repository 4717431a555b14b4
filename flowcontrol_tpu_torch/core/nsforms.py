"""Navier-Stokes operator bundles per time scheme.

Element-tensor equivalent of the reference's UFL variational forms
(ref: src/flowcontrol/nsforms.py). Instead of symbolic forms that a JIT
compiler turns into assembly kernels, NSForms builds the per-scheme element
tensors directly:

- ``transient_lhs(order, U0)`` — the constant LHS element tensors
  (assembled once, mirroring _prepare_systems; ref: flowsolver.py:665-701)
- ``rhs_coefficients(order)`` — mass/operator coefficients of the RHS terms
- the nonlinear convection kernel lives in fem.assembly (re-evaluated per step)

Scheme definitions (matching nsforms.py exactly):

BDF1 (ref :238-269):  (u - u_n)/dt + A u + b0 N(u_n) = f,  b0 = 1 if nonlinear
BDF2 (ref :271-305):  (3u - 4u_n + u_nn)/(2dt) + A u + 2N(u_n) - N(u_nn) = f
CN   (ref :191-236):  (u - u_n)/dt + ½A'(u + u_n) + N(u_n) = ½(f + f_n),
                      pressure fully implicit, shift on u only
with A = conv(U0) + lin(U0) + (1/Re)K + pressure blocks - shift·M_vel and
A' its velocity-only part.
"""

from __future__ import annotations

import numpy as np

from flowcontrol_tpu_torch.fem.assembly import (
    CellGeometry,
    linear_operator_element,
    velocity_operator_element,
    mass_velocity_element,
    velocity_cell_values,
)
from flowcontrol_tpu_torch.mesh.dofmap import TaylorHoodSpace


class NSForms:
    """Element tensors for transient/steady NS schemes."""

    def __init__(
        self,
        space: TaylorHoodSpace,
        geom: CellGeometry,
        Re: float,
        dt: float,
        is_nonlinear: bool = True,
        shift: float = 0.0,
    ):
        self.space = space
        self.geom = geom
        self.Re = float(Re)
        self.inv_re = 1.0 / Re
        self.dt = float(dt)
        self.is_nonlinear = is_nonlinear
        self.shift = float(shift)
        self._mass_e = None

    # ── Element tensors ──────────────────────────────────────────────────────

    def mass_elements(self) -> np.ndarray:
        """Velocity mass element tensors (cached)."""
        if self._mass_e is None:
            self._mass_e = mass_velocity_element(self.geom)
        return self._mass_e

    def spatial_operator_elements(self, u0_nodes: np.ndarray) -> np.ndarray:
        """A = conv(U0)+lin(U0)+(1/Re)K+pressure-blocks-shift·M (nc,15,15)."""
        u0_cells = velocity_cell_values(self.space, u0_nodes)
        return linear_operator_element(
            self.geom, u0_cells, self.inv_re, shift=self.shift
        )

    def velocity_operator_elements(
        self, u0_nodes: np.ndarray, include_shift: bool = False
    ) -> np.ndarray:
        """A' = velocity-only spatial operator (no pressure rows/cols).

        The CN explicit half applies this WITHOUT the spectral shift — the
        shift acts on the trial function only (ref: nsforms.py:234-235).
        """
        u0_cells = velocity_cell_values(self.space, u0_nodes)
        return velocity_operator_element(
            self.geom, u0_cells, self.inv_re,
            shift=self.shift if include_shift else 0.0,
        )

    def transient_lhs(self, order, u0_nodes: np.ndarray) -> np.ndarray:
        """LHS element tensors for the given scheme order (1, 2, or 'cn')."""
        m = self.mass_elements()
        a = self.spatial_operator_elements(u0_nodes)
        if order == 1:
            return m / self.dt + a
        if order == 2:
            return 1.5 * m / self.dt + a
        if order == "cn":
            # pressure implicit, spatial terms halved, shift NOT halved:
            # a includes -shift·M; halving a would halve the shift, so add
            # back the missing half (ref: nsforms.py:219-235).
            lhs = m / self.dt + 0.5 * a
            if self.shift:
                lhs = lhs - 0.5 * self.shift * m
            # pressure blocks must be FULL, not halved — add the other half
            from flowcontrol_tpu_torch.fem.assembly import (
                pressure_gradient_block,
                place_pressure_blocks,
            )

            lhs = lhs + 0.5 * place_pressure_blocks(
                pressure_gradient_block(self.geom)
            )
            return lhs
        raise ValueError(f"order must be 1, 2, or 'cn', got {order}")

    # ── RHS term coefficients ────────────────────────────────────────────────

    def rhs_coefficients(self, order) -> dict:
        """Coefficients of the RHS terms for the scan-side step function.

        rhs = c_mn·M u_n + c_mnn·M u_nn + c_nl_n·N(u_n) + c_nl_nn·N(u_nn)
              + c_lvel·A' u_n + c_f·F(u_ctrl) + c_fn·F(u_ctrl_prev)
        """
        b = 1.0 if self.is_nonlinear else 0.0
        if order == 1:
            return dict(
                c_mn=1.0 / self.dt, c_mnn=0.0, c_nl_n=-b, c_nl_nn=0.0,
                c_lvel=0.0, c_f=1.0, c_fn=0.0,
            )
        if order == 2:
            return dict(
                c_mn=2.0 / self.dt, c_mnn=-0.5 / self.dt,
                c_nl_n=-2.0 * b, c_nl_nn=1.0 * b,
                c_lvel=0.0, c_f=1.0, c_fn=0.0,
            )
        if order == "cn":
            return dict(
                c_mn=1.0 / self.dt, c_mnn=0.0, c_nl_n=-b, c_nl_nn=0.0,
                c_lvel=-0.5, c_f=0.5, c_fn=0.5,
            )
        raise ValueError(f"order must be 1, 2, or 'cn', got {order}")

    # ── Reference-named form surface (ref: nsforms.py:62-187) ────────────────
    # The reference returns UFL forms; the equivalents here return the
    # assembled element tensors / residual vectors those forms produce.

    def transient(self, order, u0_nodes: np.ndarray):
        """Scheme bundle for a transient step (ref: nsforms.py:62-114).

        Returns ``(lhs_elements, rhs_coefficients)`` — the one-time LHS
        element tensors and the per-step RHS recipe, i.e. exactly what the
        reference's ``dolfin.lhs/rhs`` split of the returned form yields.
        """
        return self.transient_lhs(order, u0_nodes), self.rhs_coefficients(order)

    def _steady_base_csr(self):
        if getattr(self, "_steady_base", None) is None:
            from flowcontrol_tpu_torch.fem.assembly import (
                place_pressure_blocks,
                place_velocity_scalar,
                pressure_gradient_block,
                scalar_stiffness_p2,
                to_scipy_csr,
            )

            base = place_velocity_scalar(
                self.inv_re * scalar_stiffness_p2(self.geom)
            ) + place_pressure_blocks(pressure_gradient_block(self.geom))
            self._steady_base = to_scipy_csr(
                base, self.space.cell_dofs, self.space.n_dofs
            )
        return self._steady_base

    def steady(self, up: np.ndarray, f_load: np.ndarray | None = None):
        """Nonlinear steady residual F(up) (ref: nsforms.py:116-147).

        The reference's form evaluates to the zero residual at steady state;
        here the residual vector itself is returned: N(u) + (1/Re)K u +
        pressure coupling − f.
        """
        from flowcontrol_tpu_torch.fem.assembly import nonlinear_convection_np

        up = np.asarray(up)
        r = nonlinear_convection_np(self.geom, self.space, up)
        r = r + self._steady_base_csr() @ up
        if f_load is not None:
            r = r - np.asarray(f_load)
        return r

    def picard(self, up: np.ndarray, f_load: np.ndarray | None = None):
        """Oseen (Picard) linearization frozen at ``up``
        (ref: nsforms.py:149-187).

        Returns ``(a_elements, L)``: the linearized LHS element tensors and
        the body-force RHS vector — the element-tensor counterpart of the
        reference's ``(a, L)`` form pair.
        """
        from flowcontrol_tpu_torch.fem.assembly import (
            convection_block,
            place_pressure_blocks,
            place_velocity_scalar,
            pressure_gradient_block,
            scalar_stiffness_p2,
            velocity_cell_values,
        )

        up = np.asarray(up)
        u_nodes = up[: self.space.n_vel_dofs].reshape(self.space.n_vnodes, 2)
        u_cells = velocity_cell_values(self.space, u_nodes)
        a_e = place_velocity_scalar(
            convection_block(self.geom, u_cells)
            + self.inv_re * scalar_stiffness_p2(self.geom)
        ) + place_pressure_blocks(pressure_gradient_block(self.geom))
        load = (
            np.zeros(self.space.n_dofs) if f_load is None
            else np.asarray(f_load)
        )
        return a_e, load
