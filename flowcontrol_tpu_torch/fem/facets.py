"""Boundary-facet integrals: sensor rows, lift/drag functionals.

Replaces dolfin's ``ds`` boundary measures and facet assembly
(ref: src/flowcontrol/sensor.py:191-224 — wall-shear sensor;
src/examples/cylinder/cylinderflowsolver.py:115-126 — force coefficients).

Every boundary linear functional here is LINEAR in the mixed state (u, p), so
it is precomputed once as a dense row vector over the mixed dofs; evaluation
on the hot path is a single dot product (fused into the jitted step).
"""

from __future__ import annotations

import numpy as np

from flowcontrol_tpu_torch.fem import element as el
from flowcontrol_tpu_torch.mesh.dofmap import TaylorHoodSpace


def _facet_basis(space: TaylorHoodSpace, facet_rows: np.ndarray):
    """Shape values/gradients of the owning cell's basis at edge quad points.

    Returns dict with:
      cells (nf,), lengths (nf,),
      phi2 (nf, nq, 6), dphi2 (nf, nq, 6, 2)  [physical gradients],
      phi1 (nf, nq, 3), normals (nf, 2)
    """
    mesh = space.mesh
    cells = mesh.boundary_facet_cells[facet_rows]
    local = mesh.boundary_facet_local[facet_rows]
    bary = el.facet_quadrature_bary(local)  # (nf, nq, 3)
    phi2 = el.p2_shape(bary)  # (nf, nq, 6)
    dphi2_ref = el.p2_grad_ref(bary)  # (nf, nq, 6, 2)
    inv_jt, _ = el.cell_geometry(mesh.coords, mesh.cells)
    inv_jt_f = inv_jt[cells]  # (nf, 2, 2)
    dphi2 = np.einsum("fij,fqnj->fqni", inv_jt_f, dphi2_ref)
    phi1 = el.p1_shape(bary)
    f = mesh.boundary_facets[facet_rows]
    t = mesh.coords[f[:, 1]] - mesh.coords[f[:, 0]]
    lengths = np.linalg.norm(t, axis=1)
    normals = np.stack([t[:, 1], -t[:, 0]], axis=1) / lengths[:, None]
    return {
        "cells": cells,
        "lengths": lengths,
        "phi2": phi2,
        "dphi2": dphi2,
        "phi1": phi1,
        "normals": normals,
    }


def _scatter_rows(space: TaylorHoodSpace, cells, vel_contrib, p_contrib=None):
    """Scatter per-facet local contributions into a global row vector.

    vel_contrib: (nf, 6, 2) weights on velocity dofs of the owning cell.
    p_contrib:   (nf, 3) weights on pressure dofs, optional.
    """
    row = np.zeros(space.n_dofs, dtype=np.float64)
    vel_dofs = 2 * space.cell_vel_nodes[cells][:, :, None] + np.arange(2)
    np.add.at(row, vel_dofs.reshape(-1), vel_contrib.reshape(-1))
    if p_contrib is not None:
        p_dofs = 2 * space.n_vnodes + space.mesh.cells[cells]
        np.add.at(row, p_dofs.reshape(-1), p_contrib.reshape(-1))
    return row


def wall_shear_row(
    space: TaylorHoodSpace, facet_rows: np.ndarray, comp: int = 0, deriv: int = 1
) -> np.ndarray:
    """Row vector of ∫ ∂u_comp/∂x_deriv ds over the given boundary facets.

    The reference's SensorHorizontalWallShear linear form
    ``v[0].dx(1) * ds(idx)`` (ref: src/flowcontrol/sensor.py:191-197).
    """
    fb = _facet_basis(space, facet_rows)
    w = el.EDGE_QW[None, :] * fb["lengths"][:, None]  # (nf, nq)
    contrib = np.zeros((len(facet_rows), 6, 2))
    contrib[:, :, comp] = np.einsum("fq,fqn->fn", w, fb["dphi2"][:, :, :, deriv])
    return _scatter_rows(space, fb["cells"], contrib)


def boundary_force_rows(
    space: TaylorHoodSpace, facet_rows: np.ndarray, nu: float
) -> np.ndarray:
    """(2, n_dofs) rows of ∫ -σ(u,p)·n ds over facets (drag row, lift row).

    σ = 2ν sym(∇u) - p I (ref: src/utils/physics.py:17-19); the force on the
    body is -σ·n with n the outward normal of the fluid domain
    (ref: cylinderflowsolver.py:120-123).
    """
    fb = _facet_basis(space, facet_rows)
    w = el.EDGE_QW[None, :] * fb["lengths"][:, None]  # (nf, nq)
    n = fb["normals"]  # (nf, 2)
    rows = np.zeros((2, space.n_dofs))
    for d in range(2):  # force component
        # -2ν sym(∇u)_{dj} n_j = -ν (∂u_d/∂x_j + ∂u_j/∂x_d) n_j
        vel = np.zeros((len(facet_rows), 6, 2))
        # term ∂u_d/∂x_j n_j: weight on u_d dofs
        vel[:, :, d] += -nu * np.einsum("fq,fqnj,fj->fn", w, fb["dphi2"], n)
        # term ∂u_j/∂x_d n_j: weight on u_j dofs, all j
        for j in range(2):
            vel[:, :, j] += -nu * np.einsum(
                "fq,fqn,f->fn", w, fb["dphi2"][:, :, :, d], n[:, j]
            )
        # +p n_d (because -σ·n includes +p I n)
        pres = np.einsum("fq,fqb,f->fb", w, fb["phi1"], n[:, d])
        rows[d] = _scatter_rows(space, fb["cells"], vel, pres)
    return rows


def point_probe_row(
    space: TaylorHoodSpace, position, component: int
) -> np.ndarray:
    """Row vector evaluating field component at a point (P2/P1 interpolation).

    component 0/1 = velocity, 2 = pressure — mirrors SENSOR_TYPE
    (ref: src/flowcontrol/sensor.py:32-42, 96-98).
    """
    cell, bary = space.mesh.locate_cells(np.asarray([position]))
    cell = int(cell[0])
    row = np.zeros(space.n_dofs, dtype=np.float64)
    if component < 2:
        phi = el.p2_shape(bary)[0]  # (6,)
        nodes = space.cell_vel_nodes[cell]
        row[2 * nodes + component] = phi
    else:
        phi = el.p1_shape(bary)[0]  # (3,)
        verts = space.mesh.cells[cell]
        row[2 * space.n_vnodes + verts] = phi
    return row


def boundary_measure_length(space: TaylorHoodSpace, facet_rows: np.ndarray) -> float:
    """Total length of the selected boundary facets (∫ 1 ds)."""
    fb = _facet_basis(space, facet_rows)
    return float(fb["lengths"].sum())
