"""Unstructured 2D triangle mesh as flat numpy arrays.

The mesh is pure data — vertex coordinates, cell connectivity, and derived
topology (edges, boundary facets) as flat integer arrays that feed the
assembly and the device tables directly. There is no mesh object graph, no
iterators, no callbacks: everything downstream consumes arrays. Transcribed
from ``flowcontrol_tpu/mesh/mesh.py``; point location uses that module's
numpy path (its C helper is a host speed-up with the same results).

Replaces the reference's dolfin.Mesh C++ object
(ref: src/flowcontrol/flowsolver.py:233-240) and CompiledSubDomain boundary
predicates (ref: src/examples/cylinder/cylinderflowsolver.py:35-83), which
become plain Python predicates evaluated once on facet midpoints at setup.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Callable, Dict

import numpy as np

from flowcontrol_tpu_torch.config import HOST_DTYPE, INDEX_DTYPE

#: Tolerance used by boundary predicates, mirroring dolfin.DOLFIN_EPS usage.
MESH_TOL = 1e-10


@dataclass
class Mesh2D:
    """Triangle mesh: ``coords (nv, 2)`` float64, ``cells (nc, 3)`` int32.

    Derived topology is computed lazily on first access and cached:

    - ``edges (ne, 2)``: unique vertex pairs, each sorted (lo, hi).
    - ``cell_edges (nc, 3)``: global edge index opposite each local vertex.
    - ``boundary_facets (nf, 2)``: vertex pairs of facets on the boundary,
      oriented so the owning cell lies to the LEFT of v0->v1 (outward normal
      is then (t_y, -t_x) for tangent t = v1 - v0).
    - ``boundary_facet_cells (nf,)``: owning cell of each boundary facet.
    - ``boundary_facet_local (nf,)``: local facet index (opposite vertex) in
      the owning cell.
    """

    coords: np.ndarray
    cells: np.ndarray
    _cache: Dict[str, np.ndarray] = field(default_factory=dict, repr=False)

    def __post_init__(self) -> None:
        self.coords = np.ascontiguousarray(self.coords, dtype=HOST_DTYPE)
        self.cells = np.ascontiguousarray(self.cells, dtype=INDEX_DTYPE)
        if self.coords.ndim != 2 or self.coords.shape[1] != 2:
            raise ValueError(f"coords must be (nv, 2), got {self.coords.shape}")
        if self.cells.ndim != 2 or self.cells.shape[1] != 3:
            raise ValueError(f"cells must be (nc, 3), got {self.cells.shape}")
        self._orient_cells()

    # ── Basic sizes ──────────────────────────────────────────────────────────

    @property
    def num_vertices(self) -> int:
        return self.coords.shape[0]

    @property
    def num_cells(self) -> int:
        return self.cells.shape[0]

    @property
    def num_edges(self) -> int:
        return self.edges.shape[0]

    def hmin(self) -> float:
        """Shortest edge length (diagnostic, like dolfin.Mesh.hmin)."""
        e = self.edges
        d = self.coords[e[:, 0]] - self.coords[e[:, 1]]
        return float(np.sqrt((d**2).sum(axis=1)).min())

    def hmax(self) -> float:
        e = self.edges
        d = self.coords[e[:, 0]] - self.coords[e[:, 1]]
        return float(np.sqrt((d**2).sum(axis=1)).max())

    # ── Orientation ──────────────────────────────────────────────────────────

    def _orient_cells(self) -> None:
        """Flip cells so all have positive signed area (CCW orientation)."""
        p = self.coords[self.cells]
        area2 = (p[:, 1, 0] - p[:, 0, 0]) * (p[:, 2, 1] - p[:, 0, 1]) - (
            p[:, 2, 0] - p[:, 0, 0]
        ) * (p[:, 1, 1] - p[:, 0, 1])
        flip = area2 < 0
        if flip.any():
            c = self.cells.copy()
            c[flip, 1], c[flip, 2] = self.cells[flip, 2], self.cells[flip, 1]
            self.cells = c

    # ── Derived topology ─────────────────────────────────────────────────────

    def _build_edges(self) -> None:
        c = self.cells
        # local edge k is opposite local vertex k (dolfin convention):
        # edge 0 = (v1, v2), edge 1 = (v0, v2), edge 2 = (v0, v1)
        raw = np.concatenate(
            [c[:, [1, 2]], c[:, [0, 2]], c[:, [0, 1]]], axis=0
        )  # (3*nc, 2)
        raw_sorted = np.sort(raw, axis=1)
        edges, inverse = np.unique(raw_sorted, axis=0, return_inverse=True)
        self._cache["edges"] = edges.astype(INDEX_DTYPE)
        self._cache["cell_edges"] = (
            inverse.reshape(3, -1).T.astype(INDEX_DTYPE)
        )  # (nc, 3)
        # count cells per edge to find boundary facets
        counts = np.bincount(inverse, minlength=edges.shape[0])
        boundary_edge_ids = np.nonzero(counts == 1)[0]
        # owning cell + local facet index for each boundary edge
        nc = self.num_cells
        edge_of = inverse.reshape(3, nc)  # [local_edge, cell]
        owner_cell = np.empty(len(boundary_edge_ids), dtype=INDEX_DTYPE)
        owner_local = np.empty(len(boundary_edge_ids), dtype=INDEX_DTYPE)
        # invert: for each (local, cell) occurrence record (edge -> cell, local)
        occ_edge = edge_of.ravel()  # order: local0 cells..., local1..., local2...
        occ_cell = np.tile(np.arange(nc, dtype=INDEX_DTYPE), 3)
        occ_local = np.repeat(np.arange(3, dtype=INDEX_DTYPE), nc)
        order = np.argsort(occ_edge, kind="stable")
        first_pos = np.searchsorted(occ_edge[order], boundary_edge_ids)
        owner_cell = occ_cell[order][first_pos]
        owner_local = occ_local[order][first_pos]
        # orient boundary facets CCW w.r.t. the owning cell: for local facet k
        # (opposite vertex k) of a CCW triangle (v0,v1,v2), the boundary is
        # traversed v_{k+1} -> v_{k+2}, which puts the cell on the left.
        nxt = np.array([[1, 2], [2, 0], [0, 1]], dtype=INDEX_DTYPE)
        facets = self.cells[owner_cell[:, None], nxt[owner_local]]
        self._cache["boundary_facets"] = facets.astype(INDEX_DTYPE)
        self._cache["boundary_facet_cells"] = owner_cell
        self._cache["boundary_facet_local"] = owner_local
        self._cache["boundary_edge_ids"] = boundary_edge_ids.astype(INDEX_DTYPE)

    def _derived(self, key: str) -> np.ndarray:
        if key not in self._cache:
            self._build_edges()
        return self._cache[key]

    @property
    def edges(self) -> np.ndarray:
        return self._derived("edges")

    @property
    def cell_edges(self) -> np.ndarray:
        return self._derived("cell_edges")

    @property
    def boundary_facets(self) -> np.ndarray:
        return self._derived("boundary_facets")

    @property
    def boundary_facet_cells(self) -> np.ndarray:
        return self._derived("boundary_facet_cells")

    @property
    def boundary_facet_local(self) -> np.ndarray:
        return self._derived("boundary_facet_local")

    @property
    def boundary_edge_ids(self) -> np.ndarray:
        """Global edge index of each boundary facet (aligned with boundary_facets)."""
        return self._derived("boundary_edge_ids")

    @property
    def boundary_vertices(self) -> np.ndarray:
        """Unique vertex indices lying on the boundary."""
        return np.unique(self.boundary_facets)

    # ── Geometry helpers ─────────────────────────────────────────────────────

    def cell_areas(self) -> np.ndarray:
        p = self.coords[self.cells]
        return 0.5 * np.abs(
            (p[:, 1, 0] - p[:, 0, 0]) * (p[:, 2, 1] - p[:, 0, 1])
            - (p[:, 2, 0] - p[:, 0, 0]) * (p[:, 1, 1] - p[:, 0, 1])
        )

    def facet_midpoints(self) -> np.ndarray:
        f = self.boundary_facets
        return 0.5 * (self.coords[f[:, 0]] + self.coords[f[:, 1]])

    def facet_normals(self) -> np.ndarray:
        """Outward unit normals of boundary facets."""
        f = self.boundary_facets
        t = self.coords[f[:, 1]] - self.coords[f[:, 0]]
        n = np.stack([t[:, 1], -t[:, 0]], axis=1)
        return n / np.linalg.norm(n, axis=1, keepdims=True)

    def facet_lengths(self) -> np.ndarray:
        f = self.boundary_facets
        t = self.coords[f[:, 1]] - self.coords[f[:, 0]]
        return np.linalg.norm(t, axis=1)

    # ── Boundary marking ─────────────────────────────────────────────────────

    def mark_boundaries(
        self, predicates: Dict[str, Callable[[np.ndarray], np.ndarray]]
    ) -> "BoundaryMarkers":
        """Classify boundary facets by named predicates.

        Each predicate receives facet midpoints ``(nf, 2)`` and returns a
        boolean mask. Facets are assigned the FIRST matching predicate (like
        dolfin marking order — later marks do not overwrite earlier ones here;
        the reference marks in order with overwrite, so callers should order
        predicates from most-generic to most-specific and we mark LAST match
        to mirror `subdomain.mark` overwrite semantics).
        """
        mids = self.facet_midpoints()
        nf = mids.shape[0]
        marker = np.full(nf, -1, dtype=np.int64)
        names = list(predicates.keys())
        for i, name in enumerate(names):
            mask = np.asarray(predicates[name](mids), dtype=bool)
            marker[mask] = i  # later predicates overwrite (dolfin .mark order)
        return BoundaryMarkers(names=names, facet_marker=marker, mesh=self)

    def locate_cells(self, points: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
        """Find the containing cell and barycentric coords of each point.

        Brute-force vectorized numpy over all cells per point (the few
        sensor probes of a run). Returns ``(cell_idx (np,), bary (np, 3))``.
        Raises if a point lies outside the mesh (beyond tolerance).
        """
        points = np.atleast_2d(np.asarray(points, dtype=HOST_DTYPE))
        p0 = self.coords[self.cells[:, 0]]
        p1 = self.coords[self.cells[:, 1]]
        p2 = self.coords[self.cells[:, 2]]
        d = (p1[:, 0] - p0[:, 0]) * (p2[:, 1] - p0[:, 1]) - (
            p2[:, 0] - p0[:, 0]
        ) * (p1[:, 1] - p0[:, 1])
        out_cells = np.empty(points.shape[0], dtype=INDEX_DTYPE)
        out_bary = np.empty((points.shape[0], 3), dtype=HOST_DTYPE)
        for k, pt in enumerate(points):
            w1 = (
                (p1[:, 0] - pt[0]) * (p2[:, 1] - pt[1])
                - (p2[:, 0] - pt[0]) * (p1[:, 1] - pt[1])
            ) / d
            w2 = (
                (p2[:, 0] - pt[0]) * (p0[:, 1] - pt[1])
                - (p0[:, 0] - pt[0]) * (p2[:, 1] - pt[1])
            ) / d
            w3 = 1.0 - w1 - w2
            inside = np.minimum(np.minimum(w1, w2), w3)
            c = int(np.argmax(inside))
            if inside[c] < -1e-8:
                raise ValueError(f"point {pt} lies outside the mesh")
            out_cells[k] = c
            out_bary[k] = (w1[c], w2[c], w3[c])
        return out_cells, out_bary


@dataclass
class BoundaryMarkers:
    """Named boundary facet classification.

    Mirrors the reference's MeshFunction + boundaries DataFrame
    (ref: src/flowcontrol/flowsolver.py:252-263) as flat arrays.
    """

    names: list
    facet_marker: np.ndarray  # (nf,) int, -1 = unmarked
    mesh: Mesh2D

    def index_of(self, name: str) -> int:
        return self.names.index(name)

    def facets(self, name: str) -> np.ndarray:
        """Boundary-facet row indices (into mesh.boundary_facets) for a name."""
        return np.nonzero(self.facet_marker == self.index_of(name))[0]

    def vertices(self, name: str) -> np.ndarray:
        """Unique mesh vertex ids on the named boundary."""
        f = self.mesh.boundary_facets[self.facets(name)]
        return np.unique(f)

    def edge_ids(self, name: str) -> np.ndarray:
        """Global edge ids of the named boundary facets."""
        return self.mesh.boundary_edge_ids[self.facets(name)]
