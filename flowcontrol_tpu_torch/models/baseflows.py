"""Committed base flows at the generated default meshes.

``_baseflows/<flow>_re<Re>_n<dofs>.npz`` holds U0 (n_vnodes, 2), P0 (nv,)
and the sha256 of the mesh it was computed on (``make_baseflow.py`` writes
them). A flow solver names its files by its ``BASEFLOW_NAME``; a file is
handed out only for a mesh with the same checksum, because scipy's Delaunay
may lay a generated mesh out differently on another machine.
"""

from __future__ import annotations

import hashlib
from pathlib import Path

import numpy as np

BASEFLOW_DIR = Path(__file__).parent / "_baseflows"


def mesh_checksum(mesh) -> str:
    """sha256 of a mesh's vertex coordinates (float64) and cells (int64)."""
    h = hashlib.sha256()
    h.update(np.ascontiguousarray(mesh.coords, dtype=np.float64).tobytes())
    h.update(np.ascontiguousarray(mesh.cells, dtype=np.int64).tobytes())
    return h.hexdigest()


def baseflow_name(fs) -> str:
    """The file name of ``fs``'s base flow: its flow, Reynolds number and
    dof count."""
    return f"{fs.BASEFLOW_NAME}_re{fs.params_flow.Re:g}_n{fs.space.n_dofs}.npz"


def committed_baseflow(fs, directory=None) -> Path | None:
    """The base flow of ``fs``'s flow, Reynolds number and mesh in
    ``directory`` (default: the committed files), or None where no file
    matches the mesh's checksum."""
    path = (BASEFLOW_DIR if directory is None else Path(directory)) / baseflow_name(fs)
    return path if path.exists() and same_mesh(path, fs.mesh) else None


def same_mesh(path: Path, mesh) -> bool:
    """Whether the base flow file ``path`` was computed on ``mesh``."""
    with np.load(path, allow_pickle=False) as d:
        return str(d["mesh_sha256"]) == mesh_checksum(mesh)


def write_baseflow(fs, directory) -> Path:
    """Write ``fs``'s base flow (U0, P0, its mesh's checksum) into
    ``directory`` under ``baseflow_name``; returns the path."""
    path = Path(directory) / baseflow_name(fs)
    path.parent.mkdir(parents=True, exist_ok=True)
    np.savez_compressed(path, U0=fs.fields.U0, P0=fs.fields.P0,
                        mesh_sha256=np.asarray(mesh_checksum(fs.mesh)))
    return path


def require_mesh(path: Path, stored: str, mesh) -> None:
    """Raise ``ValueError`` unless ``stored``, the checksum a file derived
    from one mesh carries, is ``mesh``'s."""
    if str(stored) != mesh_checksum(mesh):
        raise ValueError(f"{Path(path).name} was made on another mesh (checksum {str(stored)[:12]}, "
                         f"this mesh's {mesh_checksum(mesh)[:12]})")
