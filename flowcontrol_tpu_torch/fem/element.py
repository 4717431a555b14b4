"""Taylor-Hood reference-element tables and per-cell element tensors.

Everything the reference delegates to UFL + FFC-generated C++ kernels
(ref: src/flowcontrol/nsforms.py — the variational forms) is expressed here
as small dense einsums over precomputed shape-function tables, batched over
all cells by broadcasting. Host numpy, transcribed from
``flowcontrol_tpu/fem/element.py``.

Conventions
-----------
Reference triangle: vertices (0,0), (1,0), (0,1); barycentric
``L0 = 1-x-y, L1 = x, L2 = y``. P2 nodes: 3 vertices then 3 edge midpoints,
edge ``k`` opposite vertex ``k`` (dolfin ordering). Affine map
``x = x0 + J xi`` with ``J = [p1-p0, p2-p0]``; physical gradients are
``grad_x = J^{-T} grad_xi``.

Quadrature: 7-point degree-5 rule — exact for every term in the reference's
NS forms on affine triangles (max total degree 5, from the P2*grad(P2)*P2
convection term; ref: src/flowcontrol/nsforms.py:238-305).

Local element layout (15 dofs): see flowcontrol_tpu_torch/mesh/dofmap.py.
"""

from __future__ import annotations

import numpy as np

from flowcontrol_tpu_torch.config import HOST_DTYPE

# ── Quadrature: 7-point, degree 5 (Strang-Fix) ──────────────────────────────
_A1, _B1 = 0.059715871789770, 0.470142064105115
_A2, _B2 = 0.797426985353087, 0.101286507323456
#: barycentric coordinates (L0, L1, L2) of the 7 quadrature points
QP_BARY = np.array(
    [
        [1 / 3, 1 / 3, 1 / 3],
        [_A1, _B1, _B1],
        [_B1, _A1, _B1],
        [_B1, _B1, _A1],
        [_A2, _B2, _B2],
        [_B2, _A2, _B2],
        [_B2, _B2, _A2],
    ],
    dtype=HOST_DTYPE,
)
#: quadrature weights, summing to 1 (multiply by triangle area)
QP_W = np.array(
    [
        0.225,
        0.132394152788506,
        0.132394152788506,
        0.132394152788506,
        0.125939180544827,
        0.125939180544827,
        0.125939180544827,
    ],
    dtype=HOST_DTYPE,
)
N_QP = 7


def p2_shape(bary: np.ndarray) -> np.ndarray:
    """P2 shape values at barycentric points. (nq, 3) -> (nq, 6)."""
    L0, L1, L2 = bary[..., 0], bary[..., 1], bary[..., 2]
    return np.stack(
        [
            L0 * (2 * L0 - 1),
            L1 * (2 * L1 - 1),
            L2 * (2 * L2 - 1),
            4 * L1 * L2,
            4 * L0 * L2,
            4 * L0 * L1,
        ],
        axis=-1,
    )


def p2_grad_ref(bary: np.ndarray) -> np.ndarray:
    """P2 reference-coordinate gradients. (nq, 3) -> (nq, 6, 2).

    d/dxi with L0 = 1-xi-eta, L1 = xi, L2 = eta.
    """
    L0, L1, L2 = bary[..., 0], bary[..., 1], bary[..., 2]
    z = np.zeros_like(L0)
    # dN/dL contracted with dL/dxi: dL0 = (-1,-1), dL1 = (1,0), dL2 = (0,1)
    d0 = 4 * L0 - 1  # dN0/dL0
    d1 = 4 * L1 - 1
    d2 = 4 * L2 - 1
    gx = np.stack(
        [-d0, d1, z, 4 * L2, -4 * L2, 4 * (L0 - L1)], axis=-1
    )  # d/dxi
    gy = np.stack(
        [-d0, z, d2, 4 * L1, 4 * (L0 - L2), -4 * L1], axis=-1
    )  # d/deta
    return np.stack([gx, gy], axis=-1)  # (nq, 6, 2)


def p1_shape(bary: np.ndarray) -> np.ndarray:
    """P1 shape values = barycentric coordinates themselves. (nq, 3)."""
    return np.asarray(bary, dtype=HOST_DTYPE).copy()


#: constant P1 reference gradients (3, 2)
P1_GRAD_REF = np.array([[-1.0, -1.0], [1.0, 0.0], [0.0, 1.0]], dtype=HOST_DTYPE)

#: tables at the volume quadrature points
PHI2 = p2_shape(QP_BARY)  # (7, 6)
DPHI2_REF = p2_grad_ref(QP_BARY)  # (7, 6, 2)
PHI1 = p1_shape(QP_BARY)  # (7, 3)


# ── Edge (facet) quadrature: 3-point Gauss, degree 5 along the edge ─────────
_G = np.sqrt(3.0 / 5.0)
#: parametric points on [0, 1] along an edge
EDGE_QP = np.array([0.5 * (1 - _G), 0.5, 0.5 * (1 + _G)], dtype=HOST_DTYPE)
#: weights summing to 1 (multiply by edge length)
EDGE_QW = np.array([5 / 18, 8 / 18, 5 / 18], dtype=HOST_DTYPE)
N_EDGE_QP = 3

#: local facet k (opposite vertex k) endpoints traversed CCW: (k+1, k+2) mod 3
FACET_VERTS = np.array([[1, 2], [2, 0], [0, 1]], dtype=np.int64)


def facet_quadrature_bary(local_facet: np.ndarray) -> np.ndarray:
    """Barycentric coords of edge quad points for given local facets.

    Parameters
    ----------
    local_facet : (nf,) int — local facet index in the owning cell.

    Returns
    -------
    (nf, N_EDGE_QP, 3) barycentric coordinates.
    """
    local_facet = np.asarray(local_facet)
    nf = local_facet.shape[0]
    bary = np.zeros((nf, N_EDGE_QP, 3), dtype=HOST_DTYPE)
    va = FACET_VERTS[local_facet, 0]  # (nf,)
    vb = FACET_VERTS[local_facet, 1]
    t = EDGE_QP[None, :]  # (1, nq)
    rows = np.arange(nf)[:, None]
    bary[rows, np.arange(N_EDGE_QP)[None, :], va[:, None]] = 1 - t
    bary[rows, np.arange(N_EDGE_QP)[None, :], vb[:, None]] = t
    return bary


# ── Per-cell geometry ────────────────────────────────────────────────────────


def cell_geometry(coords: np.ndarray, cells: np.ndarray):
    """Affine geometry factors for all cells.

    Returns
    -------
    inv_jt : (nc, 2, 2) — J^{-T}, maps reference gradients to physical.
    detj : (nc,) — Jacobian determinant (2 * area, positive for CCW cells).
    """
    p = coords[cells]  # (nc, 3, 2)
    j11 = p[:, 1, 0] - p[:, 0, 0]
    j21 = p[:, 1, 1] - p[:, 0, 1]
    j12 = p[:, 2, 0] - p[:, 0, 0]
    j22 = p[:, 2, 1] - p[:, 0, 1]
    detj = j11 * j22 - j12 * j21
    inv_jt = np.empty((cells.shape[0], 2, 2), dtype=HOST_DTYPE)
    # J^{-1} = 1/det [[j22, -j12], [-j21, j11]]; transpose it
    inv_jt[:, 0, 0] = j22 / detj
    inv_jt[:, 0, 1] = -j21 / detj
    inv_jt[:, 1, 0] = -j12 / detj
    inv_jt[:, 1, 1] = j11 / detj
    return inv_jt, detj


def physical_gradients(inv_jt: np.ndarray):
    """Physical P2 and P1 gradients at the volume quadrature points.

    Parameters
    ----------
    inv_jt : (nc, 2, 2)

    Returns
    -------
    dphi2 : (nc, N_QP, 6, 2)
    dphi1 : (nc, 3, 2)   (constant over the cell)
    """
    dphi2 = np.einsum("cij,qnj->cqni", inv_jt, DPHI2_REF)
    dphi1 = np.einsum("cij,nj->cni", inv_jt, P1_GRAD_REF)
    return dphi2, dphi1
