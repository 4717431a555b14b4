"""Export helpers: frequency responses, operators, fields, Bode plots.

Transcribed from ``flowcontrol_tpu/utils/io.py`` (ref: src/utils/io.py),
host numpy/scipy: the complex-field export of eigenmodes and frequency
responses (into the port's ``.ckpt`` snapshot directory, ``mesh/io.py``),
operator export (npz + COO + spy plot), DOF-map export, H(w) save/plot
(.mat + Bode PNGs per I/O pair), legacy-VTK fields, boundary forces and the
stress tensor. matplotlib is imported inside the plotting functions only.
"""

from __future__ import annotations

from pathlib import Path

import numpy as np
import scipy.io as sio
import scipy.sparse as sp
import scipy.sparse.linalg as spla

from flowcontrol_tpu_torch.fem.facets import boundary_force_rows
from flowcontrol_tpu_torch.mesh.io import FieldCheckpointFile
from flowcontrol_tpu_torch.utils.physics import stress_tensor_field


def export_complex_field(path, space, field: np.ndarray, name: str = "mode",
                         frequencies=None) -> None:
    """Write re/im/abs/arg of complex mixed fields, split into velocity and
    pressure, with frequency as the snapshot axis, into a ``.ckpt``
    snapshot directory (``path`` with that suffix; ref: io.py:61-158 —
    Paraview reads frequency as time)."""
    field = np.atleast_2d(np.asarray(field, dtype=np.complex128))
    if field.shape[1] != space.n_dofs:
        field = field.T
    frequencies = (
        np.arange(field.shape[0]) if frequencies is None else np.asarray(frequencies)
    )
    with FieldCheckpointFile(path, "w") as f:
        for k, (w, fld) in enumerate(zip(frequencies, field)):
            u = fld[: space.n_vel_dofs].reshape(space.n_vnodes, 2)
            p = fld[space.n_vel_dofs:]
            for part, fn in [
                ("re", np.real), ("im", np.imag), ("abs", np.abs), ("arg", np.angle),
            ]:
                f.write(f"{name}_u_{part}", fn(u), float(w), counter=k)
                f.write(f"{name}_p_{part}", fn(p), float(w), counter=k)


def export_square_operators(path_prefix, operators: dict, spy_png: bool = True) -> None:
    """Save sparse operators as npz + COO triplets (+ optional spy plot)
    (ref: io.py:237-251)."""
    path_prefix = Path(path_prefix)
    path_prefix.parent.mkdir(parents=True, exist_ok=True)
    for name, mat in operators.items():
        if sp.issparse(mat):
            sp.save_npz(str(path_prefix) + f"_{name}.npz", mat.tocsr())
            coo = mat.tocoo()
            np.savetxt(
                str(path_prefix) + f"_{name}_coo.txt",
                np.column_stack([coo.row, coo.col, coo.data]),
                fmt="%d %d %.18e",
            )
            if spy_png:
                try:
                    import matplotlib

                    matplotlib.use("Agg")
                    import matplotlib.pyplot as plt

                    fig, ax = plt.subplots()
                    ax.spy(mat, markersize=0.2)
                    ax.set_title(name)
                    fig.savefig(str(path_prefix) + f"_{name}_spy.png", dpi=120)
                    plt.close(fig)
                except Exception:
                    pass
        else:
            np.savez_compressed(str(path_prefix) + f"_{name}.npz", **{name: mat})


def export_dof_map(path, space) -> None:
    """Coordinates of every mixed dof (ref: io.py:275-296)."""
    n_vnodes = space.n_vnodes
    coords = np.zeros((space.n_dofs, 2))
    comp = np.zeros(space.n_dofs, dtype=np.int32)
    coords[: 2 * n_vnodes : 2] = space.vel_node_coords
    coords[1 : 2 * n_vnodes : 2] = space.vel_node_coords
    comp[1 : 2 * n_vnodes : 2] = 1
    coords[2 * n_vnodes :] = space.mesh.coords
    comp[2 * n_vnodes :] = 2
    np.savez_compressed(path, coords=coords, component=comp)


def save_Hw(path, Hw: np.ndarray, ww: np.ndarray) -> None:
    """Save a frequency response to .mat (ref: io.py:299-340)."""
    Hw = np.asarray(Hw)
    sio.savemat(str(path), {"Hw": Hw, "ww": np.asarray(ww)})


def load_Hw(path):

    d = sio.loadmat(str(path))
    return d["Hw"], d["ww"].ravel()


def plot_Hw(path_prefix, Hw: np.ndarray, ww: np.ndarray) -> None:
    """Bode magnitude/phase PNG per I/O pair (ref: io.py:343-428)."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    Hw = np.asarray(Hw)
    if Hw.ndim == 1:
        Hw = Hw[:, None, None]
    nw, p, m = Hw.shape
    for i in range(p):
        for j in range(m):
            fig, (ax1, ax2) = plt.subplots(2, 1, sharex=True, figsize=(6, 6))
            h = Hw[:, i, j]
            ax1.loglog(ww, np.abs(h))
            ax1.set_ylabel("|H|")
            ax1.grid(True, which="both", alpha=0.3)
            ax2.semilogx(ww, np.unwrap(np.angle(h)) * 180 / np.pi)
            ax2.set_ylabel("phase (deg)")
            ax2.set_xlabel("omega (rad/s)")
            ax2.grid(True, which="both", alpha=0.3)
            fig.suptitle(f"H({i + 1},{j + 1})")
            fig.tight_layout()
            fig.savefig(f"{path_prefix}_H{i + 1}{j + 1}.png", dpi=120)
            plt.close(fig)


def export_field_vtk(path, space, u_nodes=None, p=None, point_data=None) -> None:
    """Minimal legacy-VTK writer for quick visualization (P1 sub-fields)."""
    mesh = space.mesh
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    lines = [
        "# vtk DataFile Version 3.0", "flowcontrol_tpu field", "ASCII",
        "DATASET UNSTRUCTURED_GRID",
        f"POINTS {mesh.num_vertices} double",
    ]
    for x, y in mesh.coords:
        lines.append(f"{x} {y} 0.0")
    lines.append(f"CELLS {mesh.num_cells} {4 * mesh.num_cells}")
    for c in mesh.cells:
        lines.append(f"3 {c[0]} {c[1]} {c[2]}")
    lines.append(f"CELL_TYPES {mesh.num_cells}")
    lines += ["5"] * mesh.num_cells
    lines.append(f"POINT_DATA {mesh.num_vertices}")
    if u_nodes is not None:
        u = np.asarray(u_nodes)[: mesh.num_vertices]
        lines.append("VECTORS velocity double")
        for ux, uy in u:
            lines.append(f"{ux} {uy} 0.0")
    if p is not None:
        lines.append("SCALARS pressure double 1")
        lines.append("LOOKUP_TABLE default")
        lines += [str(v) for v in np.asarray(p)]
    if point_data:
        for name, vals in point_data.items():
            lines.append(f"SCALARS {name} double 1")
            lines.append("LOOKUP_TABLE default")
            lines += [str(v) for v in np.asarray(vals)[: mesh.num_vertices]]
    path.write_text("\n".join(lines))


def export_subdomains(path, mesh, markers) -> None:
    """Write the boundary classification for visualization
    (ref: io.py:171-185). Saves facet midpoints, marker ids, and names."""
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    np.savez_compressed(
        path,
        facet_midpoints=mesh.facet_midpoints(),
        facet_marker=markers.facet_marker,
        names=np.asarray(markers.names, dtype=object),
    )


def export_boundary_forces(path, flowsolver, boundary_name, u, p, nu) -> None:
    """Per-facet traction -σ·n on a named boundary (ref: io.py:188-234)."""
    rows = flowsolver.markers.facets(boundary_name)
    per_facet = []
    up = flowsolver.merge(u, p)
    for r in rows:
        fr = boundary_force_rows(flowsolver.space, np.asarray([r]), nu)
        per_facet.append(fr @ up)
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    np.savez_compressed(
        path,
        facet_rows=rows,
        midpoints=flowsolver.mesh.facet_midpoints()[rows],
        normals=flowsolver.mesh.facet_normals()[rows],
        force=np.asarray(per_facet),
    )


def export_stress_tensor(path, flowsolver, u, p, nu) -> None:
    """Quadrature-point stress tensor export (ref: io.py:188-234)."""
    sigma = stress_tensor_field(flowsolver, u, p, nu)
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    np.savez_compressed(path, sigma=sigma)


def export_npz_to_mat(infile, outfile, matname: str) -> None:
    """Load a scipy sparse matrix from ``infile`` (.npz) and save it as a
    MATLAB .mat under ``matname`` (ref: io.py:161-168)."""
    m = sp.load_npz(str(infile))
    sio.savemat(str(outfile), mdict={matname: m.tocsc()})


def export_sparse_matrix(A, figname=None) -> None:
    """Spy-plot PNG of a sparse matrix (ref: io.py:254-272). Accepts scipy
    sparse or a dense ndarray."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    a_csr = A if sp.issparse(A) else sp.csr_matrix(np.asarray(A))
    fig, ax = plt.subplots()
    ax.spy(a_csr, markersize=1)
    ax.set_title("Sparse matrix plot")
    fig.savefig(str(figname) if figname is not None else "spy.png")
    plt.close(fig)


def export_boundary_field(path, mesh, facet_rows=None, field=None,
                          name: str = "boundary_field") -> None:
    """Project a per-facet vector field (default: the facet normals) onto the
    boundary P1 vertices and export it (ref: io.py:188-207, which assembles
    the boundary-measure L2 projection with ``ident_zeros``).

    The L2 projection over the 1-D boundary mesh uses the consistent segment
    mass matrix (len/6 · [[2,1],[1,2]]); interior vertices keep identity rows
    with zero load — exactly dolfin's ``A.ident_zeros()`` behavior.
    """
    bf = mesh.boundary_facets  # (nf, 2) vertex ids
    rows = np.arange(len(bf)) if facet_rows is None else np.asarray(facet_rows)
    fvert = bf[rows]
    if field is None:
        field = mesh.facet_normals()[rows]
    field = np.asarray(field, dtype=np.float64)
    lengths = np.linalg.norm(
        mesh.coords[fvert[:, 1]] - mesh.coords[fvert[:, 0]], axis=1
    )
    nv = mesh.num_vertices
    i0, i1 = fvert[:, 0], fvert[:, 1]
    rows = np.concatenate([i0, i0, i1, i1])
    cols = np.concatenate([i0, i1, i0, i1])
    vals = np.concatenate(
        [lengths / 3.0, lengths / 6.0, lengths / 6.0, lengths / 3.0]
    )
    m = sp.csr_matrix((vals, (rows, cols)), shape=(nv, nv))
    # ident_zeros: untouched (interior) vertices get identity rows
    touched = np.zeros(nv, dtype=bool)
    touched[fvert.ravel()] = True
    ident = sp.diags((~touched).astype(np.float64))
    m = (m + ident).tocsc()
    load = np.zeros((nv, field.shape[1]))
    np.add.at(load, i0, 0.5 * lengths[:, None] * field)
    np.add.at(load, i1, 0.5 * lengths[:, None] * field)
    nh = spla.spsolve(m, load)
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    np.savez_compressed(path, coords=mesh.coords, **{name: nh})
