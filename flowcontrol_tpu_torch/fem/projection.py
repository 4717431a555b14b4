"""L2 projection onto velocity / pressure spaces (host-side, setup-time).

Replaces utils.fem.projectm (ref: src/utils/fem.py:16 — project with MUMPS):
solve ``M x = b`` with the velocity (or pressure) mass matrix, optionally
applying Dirichlet BCs to the projection system as dolfin.project does.
Used for initial conditions and diagnostics — not on the hot path.
Transcribed from ``flowcontrol_tpu/fem/projection.py``.
"""

from __future__ import annotations

import numpy as np
import scipy.sparse as sp
import scipy.sparse.linalg as spla

from flowcontrol_tpu_torch.fem.assembly import (
    CellGeometry,
    scalar_mass_p1,
    scalar_mass_p2,
    quadrature_points_physical,
)
from flowcontrol_tpu_torch.mesh.dofmap import TaylorHoodSpace


def velocity_mass_csr(geom: CellGeometry, space: TaylorHoodSpace):
    """Velocity-space scalar mass matrix (n_vnodes, n_vnodes) CSR.

    Memoized on the space object, keyed on the geometry OBJECT: IC setup
    builds it for the div-free perturbation AND the constrained
    re-projection. The memo holds the geometry itself, so a later geometry
    can never be mistaken for it (an ``id`` can be reused once the first
    object is collected)."""
    cached = getattr(space, "_vel_mass_csr", None)
    if cached is not None and cached[0] is geom:
        return cached[1]
    m6 = np.asarray(scalar_mass_p2(geom), dtype=np.float64)
    cn = space.cell_vel_nodes
    rows = np.repeat(cn, 6, axis=1).reshape(-1)
    cols = np.tile(cn, (1, 6)).reshape(-1)
    m = sp.coo_matrix(
        (m6.reshape(-1), (rows, cols)), shape=(space.n_vnodes, space.n_vnodes)
    ).tocsr()
    space._vel_mass_csr = (geom, m)
    return m


def _constrained_mass_solve(
    m, b: np.ndarray, nodes: np.ndarray, vals: np.ndarray
) -> np.ndarray:
    """Solve ``M u = b`` with Dirichlet rows replaced by identity
    (dolfin's non-symmetric ``bc.apply(A); bc.apply(b)`` elimination).

    The eliminated system is the SPD principal submatrix M_ff, so a
    Jacobi-CG converges in tens of iterations on a mass matrix — ~1 s at
    the 235k cavity where the previous LIL row-surgery + SuperLU spsolve
    path took tens of seconds per component (4 solves in the IC setup).
    Converged to the f64 rounding floor (rtol 1e-13) with an exact
    spsolve fallback, so the result is interchangeable with the direct
    solve against the parity gates."""
    n = m.shape[0]
    u = np.zeros(n)
    if len(nodes):
        u[nodes] = vals
    free = np.ones(n, dtype=bool)
    free[nodes] = False
    rhs = (b - m @ u)[free]
    mff = m[free][:, free].tocsr()
    dinv = 1.0 / mff.diagonal()
    pre = spla.LinearOperator(mff.shape, matvec=lambda x: dinv * x)
    x, info = spla.cg(mff, rhs, rtol=1e-13, atol=0.0, maxiter=400, M=pre)
    if info != 0:  # mass CG not converging signals a broken mesh/geometry
        x = spla.spsolve(mff.tocsc(), rhs)
    u[free] = x
    return u


def pressure_mass_csr(geom: CellGeometry, space: TaylorHoodSpace):
    m3 = np.asarray(scalar_mass_p1(geom), dtype=np.float64)
    cells = space.mesh.cells
    rows = np.repeat(cells, 3, axis=1).reshape(-1)
    cols = np.tile(cells, (1, 3)).reshape(-1)
    nv = space.mesh.num_vertices
    return sp.coo_matrix((m3.reshape(-1), (rows, cols)), shape=(nv, nv)).tocsr()


def project_velocity(
    geom: CellGeometry,
    space: TaylorHoodSpace,
    fn,
    bc_vel_nodes: np.ndarray | None = None,
    bc_values: np.ndarray | None = None,
) -> np.ndarray:
    """L2-project ``fn(x) -> (n, 2)`` onto P2 velocity; returns (n_vnodes, 2).

    ``bc_vel_nodes``/``bc_values``: optional Dirichlet constraints applied to
    the projection system per component (ref: flowsolver.py:532 —
    projectm(ic.u, V, bcs=bc.bcu)). ``bc_values`` is (m, 2); a NaN entry
    means "leave this component unconstrained".
    """
    m = velocity_mass_csr(geom, space)
    qp = quadrature_points_physical(space)  # (nc, 7, 2)
    fq = np.asarray(fn(qp.reshape(-1, 2)), dtype=np.float64).reshape(qp.shape[0], 7, 2)
    # rhs_a,d = sum_q wq phi2[q,a] f_d(q)
    r_e = np.einsum("cq,qa,cqd->cad", geom.wq, geom.phi2, fq)
    b = np.zeros((space.n_vnodes, 2))
    np.add.at(b, space.cell_vel_nodes.reshape(-1), r_e.reshape(-1, 2))

    out = np.empty((space.n_vnodes, 2))
    empty = np.array([], dtype=np.int64)
    for comp in range(2):
        bb = b[:, comp].copy()
        nodes, vv = empty, empty
        if bc_vel_nodes is not None and len(bc_vel_nodes):
            vals = bc_values[:, comp]
            mask = ~np.isnan(vals)
            nodes = np.asarray(bc_vel_nodes)[mask]
            vv = vals[mask]
        out[:, comp] = _constrained_mass_solve(m, bb, nodes, vv)
    return out


def project_velocity_nodal_constrained(
    geom: CellGeometry,
    space: TaylorHoodSpace,
    u_nodes: np.ndarray,
    bc_nodes: np.ndarray,
    bc_comps: np.ndarray,
    bc_vals: np.ndarray,
) -> np.ndarray:
    """Constrained L2 re-projection of a nodal P2 field, matching
    dolfin.project(v, V, bcs=...) semantics (ref: flowsolver.py:532 via
    src/utils/fem.py:16): solve ``M u = M u_in`` with the Dirichlet ROWS
    replaced by identity (non-symmetric elimination, as dolfin's
    ``bc.apply(A); bc.apply(b)`` does). Interior dofs adjacent to the
    boundary adjust through the mass coupling — they are NOT simply the
    input values, which matters for boundary-derivative sensors.
    """
    m = velocity_mass_csr(geom, space)
    u_in = np.asarray(u_nodes, dtype=np.float64)
    out = np.empty_like(u_in)
    for comp in range(2):
        b = m @ u_in[:, comp]
        sel = bc_comps == comp
        nodes = np.asarray(bc_nodes)[sel]
        out[:, comp] = _constrained_mass_solve(
            m, b, nodes, np.asarray(bc_vals)[sel]
        )
    return out


def project_pressure(geom: CellGeometry, space: TaylorHoodSpace, fn) -> np.ndarray:
    m = pressure_mass_csr(geom, space)
    qp = quadrature_points_physical(space)
    fq = np.asarray(fn(qp.reshape(-1, 2)), dtype=np.float64).reshape(qp.shape[0], 7)
    r_e = np.einsum("cq,qb,cq->cb", geom.wq, geom.phi1, fq)
    b = np.zeros(space.mesh.num_vertices)
    np.add.at(b, space.mesh.cells.reshape(-1), r_e.reshape(-1))
    return spla.spsolve(m.tocsc(), b)


def l2_norm_velocity(geom: CellGeometry, space: TaylorHoodSpace, u_nodes) -> float:
    """Exact ||u||_L2 of a P2 velocity field (via element mass blocks)."""
    m6 = scalar_mass_p2(geom)
    u_e = np.asarray(u_nodes)[space.cell_vel_nodes, :]
    val = np.einsum("cab,cad,cbd->", m6, u_e, u_e)
    return float(np.sqrt(max(val, 0.0)))


def l2_norm_function(geom: CellGeometry, space: TaylorHoodSpace, fn) -> float:
    """||f||_L2 of an arbitrary vector function via quadrature."""
    qp = quadrature_points_physical(space)
    fq = np.asarray(fn(qp.reshape(-1, 2))).reshape(qp.shape[0], 7, -1)
    val = np.einsum("cq,cqd,cqd->", geom.wq, fq, fq)
    return float(np.sqrt(max(val, 0.0)))
