"""Host-side mesh generators for the benchmark flow domains.

The reference generates meshes with gmsh-OCC (ref: src/utils/mesh_generation/)
— a C++ dependency not available here and not needed: these are one-time
host-side preprocessing steps. We generate graded unstructured triangulations
with pure numpy + scipy.spatial.Delaunay:

1. lay down boundary polylines / circles with local target spacing,
2. fill each refinement zone with a hex-lattice point cloud at its density,
3. Delaunay-triangulate, drop triangles outside the domain (or inside holes),
4. Laplacian-smooth interior vertices.

Zone layouts mirror the reference generators: cylinder 3-zone wake grading
(ref: src/utils/mesh_generation/cylinder.py:11-25), cavity Sipp-Lebedev
layout (cavity.py), unit-square lid cavity (lidcavity.py), pinball
equilateral triangle of 3 cylinders (pinball.py). Transcribed from
``flowcontrol_tpu/mesh/generation.py``: every generator gives the JAX
package's mesh bit for bit.
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


def _boundary_points_graded(p0, p1, h_fn) -> np.ndarray:
    """Points along p0->p1 with LOCAL spacing h_fn(point) (excl. endpoint p1).

    Boundary spacing must track the adjacent interior density, otherwise
    Delaunay boundary recovery cuts corners where fine interior points sit
    closer to the wall than the wall points are to each other. Spacing is
    halved within 2h of the segment endpoints: small corner edges have small
    circumcircles, which keeps the corner triangles Delaunay and prevents
    corner chamfering.
    """
    p0, p1 = np.asarray(p0, float), np.asarray(p1, float)
    length = np.linalg.norm(p1 - p0)
    direction = (p1 - p0) / length
    ts = [0.0]
    hs = []
    while True:
        pt = p0 + ts[-1] * direction
        h = float(h_fn(pt[None, :])[0])
        dist_end = min(ts[-1], length - ts[-1])
        if dist_end < 2.0 * h:
            h = max(0.5 * h, 1e-12)
        hs.append(h)
        t_next = ts[-1] + h
        if t_next >= length - 0.4 * h:
            break
        ts.append(t_next)
    pts = p0[None, :] + np.asarray(ts)[:, None] * direction[None, :]
    return pts, np.asarray(hs[: len(ts)])


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


def mesh_quality(mesh: Mesh2D) -> dict:
    """Min/mean radius-ratio quality (1 = equilateral) and min angle stats."""
    p = mesh.coords[mesh.cells]
    a = np.linalg.norm(p[:, 1] - p[:, 2], axis=1)
    b = np.linalg.norm(p[:, 0] - p[:, 2], axis=1)
    c = np.linalg.norm(p[:, 0] - p[:, 1], axis=1)
    s = 0.5 * (a + b + c)
    area = np.sqrt(np.maximum(s * (s - a) * (s - b) * (s - c), 0.0))
    inradius = area / s
    circum = a * b * c / np.maximum(4 * area, 1e-300)
    q = 2 * inradius / circum
    return {
        "q_min": float(q.min()),
        "q_mean": float(q.mean()),
        "n_cells": mesh.num_cells,
        "n_vertices": mesh.num_vertices,
    }


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


# ── Open cavity (channel + square cavity) ────────────────────────────────────

CAVITY_DEFAULT_PARAM = {
    # Sipp-Lebedev-2007 open-cavity layout (ref: mesh_generation/cavity.py):
    # channel y in [0, 0.5], x in [-1.2, 2.5]; unit square cavity below
    # x in [0, 1], y in [-1, 0].
    "xinfa": -1.2,
    "xinf": 2.5,
    "yinf": 0.5,
    "x_cav_left": 0.0,
    "x_cav_right": 1.0,
    "y_cav_bottom": -1.0,
    "n_coarse": 20.0,
    "n_mid": 50.0,
    "n_fine": 100.0,
}


def cavity_mesh(**mesh_param) -> Mesh2D:
    prm = {**CAVITY_DEFAULT_PARAM, **mesh_param}
    h0, h1, h2 = 1 / prm["n_coarse"], 1 / prm["n_mid"], 1 / prm["n_fine"]
    xa, xi, yi = prm["xinfa"], prm["xinf"], prm["yinf"]
    xl, xr, yb = prm["x_cav_left"], prm["x_cav_right"], prm["y_cav_bottom"]

    def in_fine(p):  # shear layer over the cavity mouth
        return (
            (p[:, 0] > xl - 0.3)
            & (p[:, 0] < xr + 0.3)
            & (p[:, 1] > -0.35)
            & (p[:, 1] < 0.25)
        )

    def in_mid(p):
        in_channel_mid = (p[:, 0] > xl - 0.7) & (p[:, 0] < xr + 0.8) & (p[:, 1] < yi)
        in_cavity = (p[:, 0] > xl) & (p[:, 0] < xr) & (p[:, 1] > yb) & (p[:, 1] < 0)
        return in_channel_mid | in_cavity

    def h_local(p):
        """Local target spacing — boundary sampling must match the interior."""
        p = np.atleast_2d(p)
        h = np.full(len(p), h0)
        h[in_mid(p)] = h1
        h[in_fine(p)] = h2
        return h

    # boundary polyline of the L-shaped domain (channel + cavity), sampled
    # with the local zone spacing
    poly = [
        (xa, 0.0),
        (xl, 0.0),
        (xl, yb),
        (xr, yb),
        (xr, 0.0),
        (xi, 0.0),
        (xi, yi),
        (xa, yi),
    ]
    corners = np.asarray(poly, dtype=HOST_DTYPE)
    # corners first (never merged away), labeled with the refined spacing
    bnd = [(corners, 0.5 * h_local(corners))]
    for k in range(len(poly)):
        p0, p1 = poly[k], poly[(k + 1) % len(poly)]
        pts_seg, hs_seg = _boundary_points_graded(p0, p1, h_local)
        bnd.append((pts_seg[1:], hs_seg[1:]))  # corner already included
    fixed = np.concatenate([b[0] for b in bnd])

    lat0 = _hex_lattice(xa, xi, 0.0, yi, h0)
    lat0 = lat0[~in_mid(lat0)]
    lat_m1 = _hex_lattice(xl - 0.7, xr + 0.8, 0.0, yi, h1)
    lat_m2 = _hex_lattice(xl, xr, yb, 0.0, h1)
    lat_m = np.concatenate([lat_m1, lat_m2])
    lat_m = lat_m[in_mid(lat_m) & ~in_fine(lat_m)]
    lat_f = _hex_lattice(xl - 0.3, xr + 0.3, -0.35, 0.25, h2)
    lat_f = lat_f[in_fine(lat_f)]

    def inside(p):
        in_channel = (
            (p[:, 0] > xa) & (p[:, 0] < xi) & (p[:, 1] > 0) & (p[:, 1] < yi)
        )
        in_cav = (p[:, 0] > xl) & (p[:, 0] < xr) & (p[:, 1] > yb) & (p[:, 1] < 0)
        return in_channel | in_cav

    # clip LATTICE points strictly inside; boundary points are exempt
    # (corner points fail single-axis probes and must never be clipped)
    lats = []
    for lat, h in [(lat_f, h2), (lat_m, h1), (lat0, h0)]:
        lats.append((lat[inside(lat)], h))
    points = _merge_point_groups(bnd + lats)
    return _delaunay_mesh(points, inside, fixed)


# ── Lid-driven cavity ────────────────────────────────────────────────────────


def lidcavity_mesh(n: int = 64, diagonal: str = "crossed",
                   stretch: float = 0.0) -> Mesh2D:
    """Unit-square lid-driven cavity mesh (ref: mesh_generation/lidcavity.py).

    ``stretch`` > 0 applies a tanh clustering of grid lines toward all four
    walls (the reference grades its gmsh lid-cavity meshes in 3 wall bands);
    the Re≳5000 steady states have Re^-1/2 wall layers that a uniform grid
    cannot resolve. stretch≈2 shrinks the wall spacing ~4x at the cost of
    ~2x coarser cells mid-cavity.
    """
    if stretch > 0.0:
        s = np.linspace(-1.0, 1.0, n + 1)
        t = 0.5 * (1.0 + np.tanh(stretch * s) / np.tanh(stretch))
        t[0], t[-1] = 0.0, 1.0
        return rectangle_mesh((0.0, 0.0), (1.0, 1.0), n, n, diagonal,
                              x=t, y=t)
    return unit_square_mesh(n, n, diagonal=diagonal)


# ── Fluidic pinball ──────────────────────────────────────────────────────────

PINBALL_DEFAULT_PARAM = {
    # Three unit-diameter cylinders in an equilateral triangle of side 1.5D,
    # pointing upstream (ref: mesh_generation/pinball.py). Front cylinder at
    # (-1.5*cos(30°), 0); back two at (0, ±0.75).
    "xinfa": -6.0,
    "xinf": 20.0,
    "yinf": 6.0,
    "D": 1.0,
    "n1": 10.0,
    "n2": 5.0,
    "n3": 1.2,
    "segments": 180,
}


def pinball_centers(D: float = 1.0):
    side = 1.5 * D
    x_front = -side * np.cos(np.pi / 6)
    return np.array(
        [[x_front, 0.0], [0.0, side / 2], [0.0, -side / 2]], dtype=HOST_DTYPE
    )


def pinball_mesh(**mesh_param) -> Mesh2D:
    prm = {**PINBALL_DEFAULT_PARAM, **mesh_param}
    h1, h2, h3 = 1 / prm["n1"], 1 / prm["n2"], 1 / prm["n3"]
    xinfa, xinf, yinf = prm["xinfa"], prm["xinf"], prm["yinf"]
    r = prm["D"] / 2
    centers = pinball_centers(prm["D"])
    h_cyl = min(h1, 2 * np.pi * r / prm["segments"])

    boundary = _rect_boundary(xinfa, -yinf, xinf, yinf, h3)
    groups = []
    fixed = [boundary]
    for cx, cy in centers:
        circ = _circle_points(cx, cy, r, max(prm["segments"], 16))
        groups.append((circ, h_cyl))
        fixed.append(circ)
        rr, h = r, h_cyl
        while rr < 2.0 * r:
            rr += h
            groups.append(
                (_circle_points(cx, cy, rr, max(8, int(2 * np.pi * rr / h))), h)
            )
            h = min(h1, h * 1.3)
    groups.append((boundary, h3))

    def in_zone1(p):
        return (p[:, 0] > -2.5) & (p[:, 0] < 4.0) & (np.abs(p[:, 1]) < 2.0)

    def in_zone2(p):
        return (p[:, 0] > -4.0) & (p[:, 0] < 14.0) & (np.abs(p[:, 1]) < 3.0)

    lat1 = _hex_lattice(-2.5, 4.0, -2.0, 2.0, h1)
    lat1 = lat1[in_zone1(lat1)]
    lat2 = _hex_lattice(-4.0, 14.0, -3.0, 3.0, h2)
    lat2 = lat2[in_zone2(lat2) & ~in_zone1(lat2)]
    lat3 = _hex_lattice(xinfa, xinf, -yinf, yinf, h3)
    lat3 = lat3[~in_zone2(lat3)]
    groups += [(lat1, h1), (lat2, h2), (lat3, h3)]

    points = _merge_point_groups(groups)
    for cx, cy in centers:
        rad = np.sqrt((points[:, 0] - cx) ** 2 + (points[:, 1] - cy) ** 2)
        points = points[rad >= r - 1e-12]
    points = points[
        (points[:, 0] >= xinfa - 1e-9)
        & (points[:, 0] <= xinf + 1e-9)
        & (np.abs(points[:, 1]) <= yinf + 1e-9)
    ]

    def inside(p):
        ok = np.ones(len(p), dtype=bool)
        for cx, cy in centers:
            ok &= np.sqrt((p[:, 0] - cx) ** 2 + (p[:, 1] - cy) ** 2) > r
        return ok

    return _delaunay_mesh(points, inside, np.concatenate(fixed))
