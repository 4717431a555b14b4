"""Mesh format conversion: gmsh .msh / dolfin .xml / legacy VTK → Mesh2D.

Transcribed from ``flowcontrol_tpu/mesh/convert.py`` (ref:
src/utils/mesh.py, which shells out to meshio): minimal readers for the 2D
triangle subsets of each format (gmsh ASCII v2.2/v4.1, dolfin XML, legacy
VTK, XDMF via ``mesh/io.py``), pure Python. The converters write the port's
XDMF: the ``.xdmf`` index beside ``.npy`` arrays (``mesh/io.py``
``write_xdmf_mesh``), not an HDF5 pair.
"""

from __future__ import annotations

import re
import xml.etree.ElementTree as ET
from pathlib import Path

import numpy as np

from flowcontrol_tpu_torch.mesh.mesh import Mesh2D


def read_dolfin_xml(path) -> Mesh2D:
    """dolfin .xml mesh (ref converts these with meshio; mesh.py:16-53)."""
    root = ET.parse(path).getroot()
    mesh_el = root.find("mesh")
    verts = mesh_el.find("vertices")
    cells = mesh_el.find("cells")
    nv = int(verts.get("size"))
    coords = np.zeros((nv, 2))
    for v in verts:
        coords[int(v.get("index"))] = (float(v.get("x")), float(v.get("y")))
    tri = []
    for c in cells:
        if c.tag == "triangle":
            tri.append((int(c.get("v0")), int(c.get("v1")), int(c.get("v2"))))
    return Mesh2D(coords, np.asarray(tri, dtype=np.int32))


def read_gmsh(path) -> Mesh2D:
    """gmsh ASCII .msh, v2.2 or v4.1 — triangles only."""
    text = Path(path).read_text()
    m = re.search(r"\$MeshFormat\s+([\d.]+)", text)
    version = float(m.group(1)) if m else 2.2
    if version >= 4.0:
        return _read_gmsh_v4(text)
    return _read_gmsh_v2(text)


def _block(text, name):
    m = re.search(rf"\${name}\s*\n(.*?)\$End{name}", text, re.S)
    return m.group(1).strip().splitlines() if m else []


def _read_gmsh_v2(text) -> Mesh2D:
    nodes = _block(text, "Nodes")
    n = int(nodes[0])
    coords = np.zeros((n, 2))
    idmap = {}
    for i, line in enumerate(nodes[1 : 1 + n]):
        parts = line.split()
        idmap[int(parts[0])] = i
        coords[i] = (float(parts[1]), float(parts[2]))
    elems = _block(text, "Elements")
    ne = int(elems[0])
    tris = []
    for line in elems[1 : 1 + ne]:
        parts = line.split()
        etype = int(parts[1])
        if etype == 2:  # 3-node triangle
            ntags = int(parts[2])
            vs = [idmap[int(p)] for p in parts[3 + ntags : 6 + ntags]]
            tris.append(vs)
    return Mesh2D(coords, np.asarray(tris, dtype=np.int32))


def _read_gmsh_v4(text) -> Mesh2D:
    nodes = _block(text, "Nodes")
    header = nodes[0].split()
    num_blocks, total = int(header[0]), int(header[1])
    coords = np.zeros((total, 2))
    idmap = {}
    row = 1
    count = 0
    for _ in range(num_blocks):
        bh = nodes[row].split()
        nb = int(bh[3])
        row += 1
        tags = [int(nodes[row + k]) for k in range(nb)]
        row += nb
        for k in range(nb):
            parts = nodes[row + k].split()
            idmap[tags[k]] = count
            coords[count] = (float(parts[0]), float(parts[1]))
            count += 1
        row += nb
    elems = _block(text, "Elements")
    eh = elems[0].split()
    num_eblocks = int(eh[0])
    row = 1
    tris = []
    for _ in range(num_eblocks):
        bh = elems[row].split()
        etype, nb = int(bh[2]), int(bh[3])
        row += 1
        for k in range(nb):
            if etype == 2:
                parts = elems[row + k].split()
                tris.append([idmap[int(p)] for p in parts[1:4]])
        row += nb
    return Mesh2D(coords[:count], np.asarray(tris, dtype=np.int32))


def read_legacy_vtk(path) -> Mesh2D:
    """Legacy ASCII VTK unstructured grid (triangles)."""
    lines = Path(path).read_text().splitlines()
    i = 0
    coords, cells = None, []
    while i < len(lines):
        line = lines[i]
        if line.startswith("POINTS"):
            n = int(line.split()[1])
            vals = []
            i += 1
            while len(vals) < 3 * n:
                vals += [float(v) for v in lines[i].split()]
                i += 1
            coords = np.asarray(vals).reshape(n, 3)[:, :2]
            continue
        if line.startswith("CELLS"):
            n = int(line.split()[1])
            i += 1
            for k in range(n):
                parts = [int(v) for v in lines[i + k].split()]
                if parts[0] == 3:
                    cells.append(parts[1:4])
            i += n
            continue
        i += 1
    return Mesh2D(coords, np.asarray(cells, dtype=np.int32))


def convert_to_xdmf(src, dst) -> Mesh2D:
    """Any supported format → the port's XDMF (ref: mesh.py xml/msh/vtu→xdmf)."""
    from flowcontrol_tpu_torch.mesh.io import write_xdmf_mesh

    src = Path(src)
    if src.suffix == ".xml":
        mesh = read_dolfin_xml(src)
    elif src.suffix == ".msh":
        mesh = read_gmsh(src)
    elif src.suffix in (".vtk", ".vtu"):
        mesh = read_legacy_vtk(src)
    elif src.suffix == ".xdmf":
        from flowcontrol_tpu_torch.mesh.io import read_xdmf_mesh

        mesh = read_xdmf_mesh(src)
    else:
        raise ValueError(f"unsupported mesh format: {src.suffix}")
    write_xdmf_mesh(dst, mesh)
    return mesh


def write_dolfin_xml(path, mesh: Mesh2D) -> None:
    """Write a 2D triangle mesh in dolfin XML (the format the reference's
    msh2xml conversion produces, ref: mesh.py:39-45)."""
    lines = [
        '<?xml version="1.0"?>',
        '<dolfin xmlns:dolfin="http://fenicsproject.org">',
        '  <mesh celltype="triangle" dim="2">',
        f'    <vertices size="{mesh.num_vertices}">',
    ]
    for i, (x, y) in enumerate(mesh.coords):
        lines.append(
            f'      <vertex index="{i}" x="{float(x)!r}" y="{float(y)!r}"/>'
        )
    lines.append("    </vertices>")
    lines.append(f'    <cells size="{mesh.num_cells}">')
    for i, (v0, v1, v2) in enumerate(mesh.cells):
        lines.append(
            f'      <triangle index="{i}" v0="{v0}" v1="{v1}" v2="{v2}"/>'
        )
    lines += ["    </cells>", "  </mesh>", "</dolfin>"]
    Path(path).write_text("\n".join(lines))


# ── Reference-named conversion entry points (ref: mesh.py:16-53) ─────────────
# The reference's converters take ONE path and write the converted mesh next
# to it with the new suffix; same contract here (no meshio needed).


def convert_mesh_xml2xdmf(xmlfile) -> None:
    """dolfin .xml → .xdmf (ref: mesh.py:16-27)."""
    src = Path(xmlfile).with_suffix(".xml")
    convert_to_xdmf(src, src.with_suffix(".xdmf"))


def convert_mesh_msh2xdmf(mshfile) -> None:
    """gmsh .msh → .xdmf (ref: mesh.py:29-37)."""
    src = Path(mshfile).with_suffix(".msh")
    convert_to_xdmf(src, src.with_suffix(".xdmf"))


def convert_mesh_msh2xml(mshfile) -> None:
    """gmsh .msh → dolfin .xml (ref: mesh.py:39-45)."""
    src = Path(mshfile).with_suffix(".msh")
    write_dolfin_xml(src.with_suffix(".xml"), read_gmsh(src))


def convert_mesh_vtu2xdmf(vtufile) -> None:
    """Legacy VTK → .xdmf (ref: mesh.py:47-53)."""
    src = Path(vtufile)
    if not src.exists():
        for ext in (".vtu", ".vtk"):
            if src.with_suffix(ext).exists():
                src = src.with_suffix(ext)
                break
    convert_to_xdmf(src, src.with_suffix(".xdmf"))
