"""Physics utilities: stress, vorticity, divergence, div-free perturbations.

Transcribed from ``flowcontrol_tpu/utils/physics.py`` (ref:
src/utils/physics.py), host numpy/scipy. The sympy-differentiated C-coded
Gaussian stream function (ref: physics.py:32-56) becomes closed-form numpy
— the derivatives of ψ = 0.25·exp(-½r²/σ²) are analytic.
"""

from __future__ import annotations

import numpy as np
import scipy.sparse.linalg as spla

from flowcontrol_tpu_torch.fem.projection import (
    pressure_mass_csr,
    project_velocity,
    velocity_mass_csr,
)


def get_div0_u_callable(xloc: float, yloc: float, size: float):
    """Divergence-free Gaussian perturbation u = (∂ψ/∂y, -∂ψ/∂x).

    ψ = 0.25·exp(-½ r²/σ²) with r² = (x-x0)² + (y-y0)²; peak |u| scaling is
    applied by the caller via ParamIC.amplitude (ref: physics.py:32-56).
    Returns a vectorized callable (n, 2) -> (n, 2).
    """
    if size <= 0:
        return lambda x: np.zeros_like(np.asarray(x))

    s2 = size**2

    def u(x):
        x = np.asarray(x)
        dx = x[:, 0] - xloc
        dy = x[:, 1] - yloc
        psi_fac = 0.25 * np.exp(-0.5 * (dx**2 + dy**2) / s2)
        dpsi_dx = -dx / s2 * psi_fac
        dpsi_dy = -dy / s2 * psi_fac
        return np.stack([dpsi_dy, -dpsi_dx], axis=1)

    return u


def get_div0_u(flowsolver, xloc: float, yloc: float, size: float) -> np.ndarray:
    """L2-project the div-free Gaussian onto the velocity space (n_vnodes, 2)."""
    return project_velocity(
        flowsolver.geom, flowsolver.space, get_div0_u_callable(xloc, yloc, size)
    )


def get_div0_u_random(flowsolver, sigma: float = 0.1, seed: int = 0) -> np.ndarray:
    """Random div-free field via curl of a random P2 potential
    (ref: physics.py:59-71). Returns velocity nodal values (n_vnodes, 2)."""
    rng = np.random.default_rng(seed)
    space, geom = flowsolver.space, flowsolver.geom
    a0 = sigma * rng.standard_normal(space.n_vnodes)
    # curl of the scalar potential, u = (∂a/∂y, -∂a/∂x), L2-projected from
    # its quadrature-point values
    a_cells = a0[space.cell_vel_nodes]  # (nc, 6)
    grad_q = np.einsum("cqni,cn->cqi", geom.dphi2, a_cells)  # (nc, 7, 2)
    curl_q = np.stack([grad_q[:, :, 1], -grad_q[:, :, 0]], axis=-1)
    r_e = np.einsum("cq,qa,cqd->cad", geom.wq, geom.phi2, curl_q)
    b = np.zeros((space.n_vnodes, 2))
    np.add.at(b, space.cell_vel_nodes.reshape(-1), r_e.reshape(-1, 2))
    return spla.spsolve(velocity_mass_csr(geom, space).tocsc(), b)


def _velocity_gradient_q(flowsolver, u_nodes) -> np.ndarray:
    """∂u_d/∂x_i at the cells' quadrature points (nc, 7, 2, 2) [c, q, i, d]."""
    space, geom = flowsolver.space, flowsolver.geom
    u_cells = np.asarray(u_nodes)[space.cell_vel_nodes, :]
    return np.einsum("cqni,cnd->cqid", geom.dphi2, u_cells)


def _project_p1(flowsolver, f_q: np.ndarray) -> np.ndarray:
    """L2-project quadrature-point values (nc, 7) onto the pressure (P1) space."""
    space, geom = flowsolver.space, flowsolver.geom
    r_e = np.einsum("cq,qb,cq->cb", geom.wq, geom.phi1, f_q)
    b = np.zeros(space.mesh.num_vertices)
    np.add.at(b, space.mesh.cells.reshape(-1), r_e.reshape(-1))
    return spla.spsolve(pressure_mass_csr(geom, space).tocsc(), b)


def compute_vorticity(flowsolver, u_nodes: np.ndarray) -> np.ndarray:
    """curl(u) projected onto the pressure (P1) space (ref: physics.py:22-24)."""
    g = _velocity_gradient_q(flowsolver, u_nodes)
    return _project_p1(flowsolver, g[:, :, 0, 1] - g[:, :, 1, 0])  # ∂u_y/∂x - ∂u_x/∂y


def compute_divergence(flowsolver, u_nodes: np.ndarray) -> np.ndarray:
    """div(u) projected onto the pressure (P1) space (ref: physics.py:27-29)."""
    g = _velocity_gradient_q(flowsolver, u_nodes)
    return _project_p1(flowsolver, g[:, :, 0, 0] + g[:, :, 1, 1])


def stress_tensor_field(flowsolver, u_nodes: np.ndarray, p: np.ndarray,
                        nu: float) -> np.ndarray:
    """σ = 2ν·sym(∇u) − p·I evaluated at cell quadrature points
    (ref: physics.py:17-19 — the symbolic UFL stress tensor).

    Returns (nc, 7, 2, 2).
    """
    space, geom = flowsolver.space, flowsolver.geom
    g = _velocity_gradient_q(flowsolver, u_nodes)  # ∂u_d/∂x_i
    sym_g = 0.5 * (g + np.swapaxes(g, 2, 3))
    p_cells = np.asarray(p)[space.mesh.cells]
    p_q = np.einsum("qb,cb->cq", geom.phi1, p_cells)
    eye = np.eye(2)
    return 2.0 * nu * sym_g - p_q[:, :, None, None] * eye[None, None]
