"""Host-side mesh generators for the benchmark flow domains.

The reference generates meshes with gmsh-OCC (ref: src/utils/mesh_generation/)
— a C++ dependency not available here and not needed: these are one-time
host-side preprocessing steps. We generate graded unstructured triangulations
with pure numpy + scipy.spatial.Delaunay:

1. lay down boundary polylines / circles with local target spacing,
2. fill each refinement zone with a hex-lattice point cloud at its density,
3. Delaunay-triangulate, drop triangles outside the domain (or inside holes),
4. Laplacian-smooth interior vertices.

The cylinder's 3-zone wake grading mirrors the reference generator
(ref: src/utils/mesh_generation/cylinder.py:11-25). Transcribed from
``flowcontrol_tpu/mesh/generation.py`` (the cylinder and the structured
rectangles; the other flows' domains come with their models).
"""

from __future__ import annotations

import numpy as np
from scipy.spatial import Delaunay

from flowcontrol_tpu_torch.config import HOST_DTYPE
from flowcontrol_tpu_torch.mesh.mesh import Mesh2D


# ── Structured unit square (lid cavity, test fixtures) ──────────────────────


def unit_square_mesh(nx: int, ny: int | None = None, diagonal: str = "right") -> Mesh2D:
    """Structured triangulated unit square, dolfin.UnitSquareMesh-compatible.

    ``diagonal``: 'right', 'left', or 'crossed' (4 triangles per quad with a
    center vertex — the reference's mesh*_crossed lid-cavity meshes).
    """
    ny = ny or nx
    return rectangle_mesh((0.0, 0.0), (1.0, 1.0), nx, ny, diagonal)


def rectangle_mesh(p0, p1, nx: int, ny: int, diagonal: str = "right",
                   x=None, y=None) -> Mesh2D:
    x = np.linspace(p0[0], p1[0], nx + 1) if x is None else np.asarray(x)
    y = np.linspace(p0[1], p1[1], ny + 1) if y is None else np.asarray(y)
    xx, yy = np.meshgrid(x, y, indexing="ij")
    coords = np.stack([xx.ravel(), yy.ravel()], axis=1)

    def vid(i, j):
        return i * (ny + 1) + j

    cells = []
    if diagonal == "crossed":
        centers = []
        ncv = coords.shape[0]
        for i in range(nx):
            for j in range(ny):
                cx = 0.5 * (x[i] + x[i + 1])
                cy = 0.5 * (y[j] + y[j + 1])
                cid = ncv + len(centers)
                centers.append((cx, cy))
                a, b = vid(i, j), vid(i + 1, j)
                c, d = vid(i + 1, j + 1), vid(i, j + 1)
                cells += [[a, b, cid], [b, c, cid], [c, d, cid], [d, a, cid]]
        coords = np.concatenate([coords, np.array(centers)], axis=0)
    else:
        for i in range(nx):
            for j in range(ny):
                a, b = vid(i, j), vid(i + 1, j)
                c, d = vid(i + 1, j + 1), vid(i, j + 1)
                if diagonal == "right":
                    cells += [[a, b, c], [a, c, d]]
                else:
                    cells += [[a, b, d], [b, c, d]]
    return Mesh2D(np.asarray(coords, dtype=HOST_DTYPE), np.asarray(cells))


# ── Graded unstructured meshes via zoned point clouds + Delaunay ────────────


def _hex_lattice(xmin, xmax, ymin, ymax, h) -> np.ndarray:
    """Hexagonal lattice covering a box with spacing ~h (good triangles)."""
    dy = h * np.sqrt(3) / 2
    rows = []
    ny = max(1, int(np.ceil((ymax - ymin) / dy)))
    for j in range(ny + 1):
        yj = ymin + j * dy
        if yj > ymax + 1e-12:
            break
        off = 0.5 * h if j % 2 else 0.0
        xs = np.arange(xmin + off, xmax + 1e-12, h)
        rows.append(np.stack([xs, np.full_like(xs, yj)], axis=1))
    return np.concatenate(rows, axis=0) if rows else np.zeros((0, 2))


def _circle_points(cx, cy, r, n) -> np.ndarray:
    th = np.linspace(0.0, 2 * np.pi, n, endpoint=False)
    return np.stack([cx + r * np.cos(th), cy + r * np.sin(th)], axis=1)


def _boundary_points(p0, p1, h) -> np.ndarray:
    """Points along segment p0->p1 at spacing ~h (excluding endpoint p1)."""
    p0, p1 = np.asarray(p0, float), np.asarray(p1, float)
    n = max(1, int(round(np.linalg.norm(p1 - p0) / h)))
    t = np.arange(n) / n
    return p0[None, :] + t[:, None] * (p1 - p0)[None, :]


def _rect_boundary(xmin, ymin, xmax, ymax, h) -> np.ndarray:
    return np.concatenate(
        [
            _boundary_points((xmin, ymin), (xmax, ymin), h),
            _boundary_points((xmax, ymin), (xmax, ymax), h),
            _boundary_points((xmax, ymax), (xmin, ymax), h),
            _boundary_points((xmin, ymax), (xmin, ymin), h),
        ]
    )


def _merge_point_groups(groups) -> np.ndarray:
    """Merge (points, h) groups in priority order, density-aware.

    A candidate point is rejected when it lies within 0.6·min(h_new, h_near)
    of an already-accepted point — this is what prevents sliver triangles at
    zone interfaces and along fixed boundaries.
    """
    from scipy.spatial import cKDTree

    acc_pts: list[np.ndarray] = []
    acc_h: list[np.ndarray] = []
    for pts, h in groups:
        pts = np.asarray(pts, dtype=HOST_DTYPE)
        if len(pts) == 0:
            continue
        hs = np.broadcast_to(
            np.asarray(h, dtype=HOST_DTYPE), (len(pts),)
        ).copy()
        if acc_pts:
            all_pts = np.concatenate(acc_pts)
            all_h = np.concatenate(acc_h)
            tree = cKDTree(all_pts)
            d, idx = tree.query(pts)
            limit = 0.6 * np.minimum(hs, all_h[idx])
            keep = d > limit
            pts, hs = pts[keep], hs[keep]
        acc_pts.append(pts)
        acc_h.append(hs)
    return np.concatenate(acc_pts)


def _smooth(mesh: Mesh2D, fixed: np.ndarray, n_iter: int = 8) -> Mesh2D:
    """Laplacian smoothing of non-fixed vertices."""
    coords = mesh.coords.copy()
    edges = mesh.edges
    nv = coords.shape[0]
    movable = np.ones(nv, dtype=bool)
    movable[fixed] = False
    for _ in range(n_iter):
        acc = np.zeros_like(coords)
        cnt = np.zeros(nv)
        np.add.at(acc, edges[:, 0], coords[edges[:, 1]])
        np.add.at(acc, edges[:, 1], coords[edges[:, 0]])
        np.add.at(cnt, edges[:, 0], 1)
        np.add.at(cnt, edges[:, 1], 1)
        avg = acc / np.maximum(cnt, 1)[:, None]
        coords[movable] = 0.7 * avg[movable] + 0.3 * coords[movable]
    return Mesh2D(coords, mesh.cells)


def _delaunay_mesh(
    points: np.ndarray,
    inside_fn,
    fixed_points: np.ndarray,
    smooth_iters: int = 8,
    min_quality: float = 0.0,
) -> Mesh2D:
    """Triangulate points, keep triangles whose centroid satisfies inside_fn."""
    points = np.ascontiguousarray(points, dtype=HOST_DTYPE)
    tri = Delaunay(points)
    cells = tri.simplices
    centroids = points[cells].mean(axis=1)
    keep = inside_fn(centroids)
    cells = cells[keep]
    # drop unused vertices
    used, inverse = np.unique(cells, return_inverse=True)
    coords = points[used]
    cells = inverse.reshape(cells.shape)
    mesh = Mesh2D(coords, cells)
    if smooth_iters:
        # fixed: boundary vertices + any vertex originally in fixed_points
        from scipy.spatial import cKDTree

        fixed = set(mesh.boundary_vertices.tolist())
        if len(fixed_points):
            tree = cKDTree(coords)
            d, idx = tree.query(fixed_points)
            fixed.update(idx[d < 1e-9].tolist())
        mesh = _smooth(mesh, np.array(sorted(fixed), dtype=np.int64), smooth_iters)
    return mesh


# ── Cylinder flow domain ─────────────────────────────────────────────────────

CYLINDER_DEFAULT_PARAM = {
    # Geometry and 3-zone grading after Sipp & Lebedev (2007), matching the
    # reference's generator defaults (ref: mesh_generation/cylinder.py:11-25).
    "xinfa": -10.0,
    "xinf": 20.0,
    "yinf": 8.0,
    "xplus": 1.5,
    "yint": 3.0,
    "lint": 1.5,
    "inftol": 5.0,
    "inftola": 5.0,
    "n1": 10.0,
    "n2": 5.0,
    "n3": 1.0,
    "segments": 360,
    "D": 1.0,
}


def cylinder_mesh(**mesh_param) -> Mesh2D:
    """Graded unstructured mesh around a circular cylinder (3 zones + hole)."""
    prm = {**CYLINDER_DEFAULT_PARAM, **mesh_param}
    h1, h2, h3 = 1 / prm["n1"], 1 / prm["n2"], 1 / prm["n3"]
    xinfa, xinf, yinf = prm["xinfa"], prm["xinf"], prm["yinf"]
    r = prm["D"] / 2
    lint, yint, xplus = prm["lint"], prm["yint"], prm["xplus"]
    xm0, xm1 = xinfa + prm["inftola"], xinf - prm["inftol"]

    h_cyl = min(h1, 2 * np.pi * r / prm["segments"])
    circle = _circle_points(0, 0, r, max(prm["segments"], int(2 * np.pi * r / h_cyl)))
    boundary = _rect_boundary(xinfa, -yinf, xinf, yinf, h3)
    groups = [(circle, h_cyl), (boundary, h3)]
    # graded rings around the cylinder from h_cyl up to h1
    rr, h = r, h_cyl
    while rr < 2.5 * r:
        rr += h
        groups.append(
            (_circle_points(0, 0, rr, max(8, int(2 * np.pi * rr / h))), h)
        )
        h = min(h1, h * 1.3)
    fixed = np.concatenate([circle, boundary])

    def in_zone1(p):
        return (p[:, 0] > -lint) & (p[:, 0] < xplus) & (np.abs(p[:, 1]) < lint)

    def in_zone2(p):
        return (p[:, 0] > xm0) & (p[:, 0] < xm1) & (np.abs(p[:, 1]) < yint)

    # zone lattices, finest first so they win the density merge
    lat1 = _hex_lattice(-lint, xplus, -lint, lint, h1)
    lat1 = lat1[in_zone1(lat1)]
    lat2 = _hex_lattice(xm0, xm1, -yint, yint, h2)
    lat2 = lat2[in_zone2(lat2) & ~in_zone1(lat2)]
    lat3 = _hex_lattice(xinfa, xinf, -yinf, yinf, h3)
    lat3 = lat3[~in_zone2(lat3)]
    groups += [(lat1, h1), (lat2, h2), (lat3, h3)]

    points = _merge_point_groups(groups)
    # drop points inside the cylinder hole and clip to the domain box
    rad = np.sqrt(points[:, 0] ** 2 + points[:, 1] ** 2)
    points = points[rad >= r - 1e-12]
    points = points[
        (points[:, 0] >= xinfa - 1e-9)
        & (points[:, 0] <= xinf + 1e-9)
        & (np.abs(points[:, 1]) <= yinf + 1e-9)
    ]

    def inside(p):
        return np.sqrt(p[:, 0] ** 2 + p[:, 1] ** 2) > r

    return _delaunay_mesh(points, inside, fixed)
