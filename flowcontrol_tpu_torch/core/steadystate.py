"""Steady-state (base flow) solvers: Newton and Picard.

Mirrors the reference's SteadyStateSolver behavior
(ref: src/flowcontrol/steadystate.py:60-159): Newton with direct linear
solves and dolfin-default tolerances (abs 1e-10, rel 1e-9), and Picard
fixed-point iteration with relative-change convergence.

Runs host-side in float64 (one-time setup work with a sparse direct inner
solve). The resulting base flow feeds the device-resident linearized
operators. Transcribed from ``flowcontrol_tpu/core/steadystate.py``.
"""

from __future__ import annotations

import logging

import numpy as np

from flowcontrol_tpu_torch.fem.assembly import (
    CellGeometry,
    linear_operator_element,
    convection_block,
    scalar_stiffness_p2,
    pressure_gradient_block,
    place_velocity_scalar,
    place_pressure_blocks,
    nonlinear_convection_np,
    to_scipy_csr,
)
from flowcontrol_tpu_torch.fem.bc import BCSet
from flowcontrol_tpu_torch.mesh.dofmap import TaylorHoodSpace
from flowcontrol_tpu_torch.solvers.direct import HostSparseLU

logger = logging.getLogger(__name__)


class SteadyStateSolver:
    """Newton and Picard solvers for steady incompressible NS.

    Parameters
    ----------
    space, geom:
        Discretization.
    bcs:
        Full-field BCSet (inlet at uinf etc. — ref: flowsolver.py:329-337).
    inv_re:
        1 / Reynolds.
    f_load:
        Assembled body-force load vector (n_dofs,) or None.
    """

    def __init__(
        self,
        space: TaylorHoodSpace,
        geom: CellGeometry,
        bcs: BCSet,
        inv_re: float,
        f_load: np.ndarray | None = None,
        verbose: bool = True,
    ):
        self.space = space
        self.geom = geom
        self.bcs = bcs
        self.inv_re = float(inv_re)
        self.f_load = (
            np.zeros(space.n_dofs) if f_load is None else np.asarray(f_load)
        )
        self.verbose = verbose
        # constant linear part: (1/Re) K + pressure blocks (no convection)
        k = scalar_stiffness_p2(geom)
        gp = pressure_gradient_block(geom)
        base = place_velocity_scalar(self.inv_re * k) + place_pressure_blocks(gp)
        self._base_csr = to_scipy_csr(base, space.cell_dofs, space.n_dofs)

    # ── Residual ─────────────────────────────────────────────────────────────

    def residual(self, up: np.ndarray) -> np.ndarray:
        """Steady residual N(u) + (1/Re)K u + pressure terms - f."""
        return (
            nonlinear_convection_np(self.geom, self.space, up)
            + self._base_csr @ up
            - self.f_load
        )

    def _u_cells(self, up: np.ndarray) -> np.ndarray:
        u = up[: self.space.n_vel_dofs].reshape(self.space.n_vnodes, 2)
        return u[self.space.cell_vel_nodes, :]

    # ── Newton ───────────────────────────────────────────────────────────────

    def newton(
        self,
        up0: np.ndarray,
        max_iter: int = 25,
        atol: float = 1e-10,
        rtol: float = 1e-9,
        u_ctrl=None,
        ptc_dt0: float | None = None,
    ) -> np.ndarray:
        """Newton iteration with exact (hand-linearized) Jacobian.

        The Jacobian equals conv(U) + lin(U) + (1/Re)K + pressure blocks —
        identical to dolfin.derivative of the steady form
        (ref: steadystate.py:86-95 and operatorgetter.py:61-64).

        ``ptc_dt0``: optional pseudo-transient continuation — augments the
        Jacobian with M/dt_k and grows dt_k by the SER rule. Globalizes
        Newton for stiff high-Re base flows (e.g. the open cavity at
        Re=7500) where the plain step leaves the basin of attraction.
        """
        from flowcontrol_tpu_torch.fem.assembly import mass_velocity_element

        up = self.bcs.apply_vector(up0, u_ctrl=u_ctrl)
        r = self.residual(up)
        r[self.bcs.dofs] = 0.0  # up satisfies the BCs exactly
        r0 = np.linalg.norm(r)
        logger.info(f"Newton iteration 0: r = {r0:.3e}")
        if r0 < atol:
            return up
        r_prev = r0
        m_csr = None
        dt_k = ptc_dt0
        if ptc_dt0 is not None:
            m_csr = to_scipy_csr(
                mass_velocity_element(self.geom), self.space.cell_dofs,
                self.space.n_dofs,
            )
        for it in range(1, max_iter + 1):
            j_e = linear_operator_element(
                self.geom, self._u_cells(up), self.inv_re
            )
            j = to_scipy_csr(j_e, self.space.cell_dofs, self.space.n_dofs)
            if dt_k is not None:
                j = j + m_csr / dt_k
            j_bc, _ = self.bcs.eliminate_csr(j)
            rhs = -r
            rhs[self.bcs.dofs] = 0.0  # homogeneous increments at Dirichlet dofs
            delta = HostSparseLU(j_bc).solve(rhs)
            # backtracking line search for robustness at high Re (the
            # reference relies on dolfin's damped Newton)
            alpha = 1.0
            for _ in range(10):
                up_try = up + alpha * delta
                r_try = self.residual(up_try)
                r_try[self.bcs.dofs] = 0.0
                rn = np.linalg.norm(r_try)
                if rn < r_prev or alpha < 1e-3:
                    break
                alpha *= 0.5
            # SER update of the pseudo-timestep: grow as the residual drops
            if dt_k is not None:
                dt_k = min(dt_k * max(r_prev / max(rn, 1e-300), 1.0), 1e12)
            up, r, r_prev = up_try, r_try, rn
            if self.verbose:
                extra = f", ptc_dt = {dt_k:.2e}" if dt_k is not None else ""
                logger.info(
                    f"Newton iteration {it}: r (abs) = {rn:.3e} (tol={atol:.0e}), "
                    f"r (rel) = {rn / (r0 + 1e-300):.3e} (tol={rtol:.0e}), "
                    f"step = {alpha:g}{extra}"
                )
            if rn < atol or rn < rtol * r0:
                logger.info(f"Newton converged in {it} iterations.")
                return up
        logger.warning("Newton did not converge within max_iter.")
        return up

    # ── Picard ───────────────────────────────────────────────────────────────

    def picard(
        self,
        up0: np.ndarray,
        max_iter: int = 10,
        tol: float = 1e-8,
        u_ctrl=None,
    ) -> np.ndarray:
        """Fixed-point iteration: freeze advection velocity at the previous
        iterate, solve the linear Oseen system (ref: steadystate.py:98-159).
        """
        up = self.bcs.apply_vector(up0, u_ctrl=u_ctrl)
        for it in range(1, max_iter + 1):
            # Oseen operator: conv(U_k) + (1/Re) K + pressure blocks
            conv = convection_block(self.geom, self._u_cells(up))
            a_e = place_velocity_scalar(conv)
            a = to_scipy_csr(a_e, self.space.cell_dofs, self.space.n_dofs)
            a = a + self._base_csr
            a_bc, lift = self.bcs.eliminate_csr(a)
            b = self.bcs.reduce_rhs(self.f_load.copy(), u_ctrl=u_ctrl, lift_cols=lift)
            up1 = HostSparseLU(a_bc).solve(b)
            diff = np.linalg.norm(up1 - up)
            base = np.linalg.norm(up)
            rel_err = diff / (base + 1e-14)
            up = up1
            if self.verbose:
                logger.info(f"Picard {it}/{max_iter}  rel_err = {rel_err:.3e}")
            if rel_err < tol:
                logger.info(f"Picard converged (rel_err {rel_err:.3e} < {tol:.3e})")
                break
        return up
