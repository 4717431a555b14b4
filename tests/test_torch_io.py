"""The port's mesh and field files against the JAX package's, on the CPU.

The port writes its own numpy-only format (``flowcontrol_tpu_torch/mesh/
io.py``: ``.xdmf`` indexes over ``.npy`` arrays through ``Format="Binary"``
DataItems, ``.ckpt`` snapshot directories) and reads the JAX package's
HDF5 through h5py. Held here, bitwise unless said otherwise:

- the JAX package's committed mesh file (``Format="HDF"``) read by both
  packages; the port's own mesh files and inline ``Format="XML"`` items
  read back; the Binary items' ``Seek`` skips the ``.npy`` header;
- the port's own files written and read with ``h5py`` unimportable, and
  a JAX ``.h5`` file refused then with an ``ImportError`` that says why;
- the gmsh v2.2/v4.1, dolfin XML and legacy VTK readers and the converters
  against the JAX package's (the oracles of ``tests/test_compat_surface.py``
  and ``tests/test_mesh.py``);
- ``FieldCheckpointFile``'s counters, times and negative reads against the
  JAX package's, and the port reading a JAX-written ``.h5``;
- the Paraview index: each Binary DataItem, read at its ``Seek``, equal to
  the JAX package's ``viz/*`` and ``viz_mesh/*`` datasets for the same
  fields, with the same grids and times;
- ``export_complex_field``'s arrays and frequencies against the JAX
  package's.
"""

import sys
import xml.etree.ElementTree as ET
from pathlib import Path

import h5py
import numpy as np
import pytest
import torch

from flowcontrol_tpu.mesh import convert as convert_j
from flowcontrol_tpu.mesh import io as io_j
from flowcontrol_tpu.mesh.dofmap import TaylorHoodSpace as SpaceJ
from flowcontrol_tpu.mesh.generation import cylinder_mesh as cylinder_mesh_j
from flowcontrol_tpu.mesh.generation import unit_square_mesh as unit_square_mesh_j
from flowcontrol_tpu.utils.io import export_complex_field as export_complex_field_j
from flowcontrol_tpu_torch.mesh import convert as convert_t
from flowcontrol_tpu_torch.mesh import io as io_t
from flowcontrol_tpu_torch.mesh.dofmap import TaylorHoodSpace as SpaceT
from flowcontrol_tpu_torch.mesh.generation import cylinder_mesh as cylinder_mesh_t
from flowcontrol_tpu_torch.mesh.generation import unit_square_mesh as unit_square_mesh_t
from flowcontrol_tpu_torch.utils.io import export_complex_field as export_complex_field_t

torch.set_num_threads(1)

COARSE = dict(yinf=5.0, xinf=15.0, xinfa=-5.0, n1=4.0, n2=2.0, n3=0.8, segments=80)
JAX_MESH = (Path(__file__).parents[1] / "flowcontrol_tpu" / "models" / "_meshes"
            / "cylinder_8586114762.xdmf")

GMSH_V2 = """$MeshFormat
2.2 0 8
$EndMeshFormat
$Nodes
4
1 0 0 0
2 1 0 0
3 1 1 0
4 0 1 0
$EndNodes
$Elements
3
1 1 2 0 1 1 2
2 2 2 0 1 1 2 3
3 2 2 0 1 1 3 4
$EndElements
"""

GMSH_V4 = """$MeshFormat
4.1 0 8
$EndMeshFormat
$Nodes
1 4 1 4
2 1 0 4
1
2
3
4
0 0 0
1 0 0
1 1 0
0 1 0
$EndNodes
$Elements
2 3 1 3
1 1 1 1
1 1 2
2 1 2 2
2 1 2 3
3 1 3 4
$EndElements
"""

VTK = """# vtk DataFile Version 2.0
mesh
ASCII
DATASET UNSTRUCTURED_GRID
POINTS 4 double
0 0 0
1 0 0
1 1 0 0 1 0
CELLS 3 10
3 0 1 2
2 0 1
3 0 2 3
CELL_TYPES 3
5
3
5
"""


@pytest.fixture(scope="module")
def meshes():
    """The coarse cylinder of the integration tests, generated by each
    package (bitwise the same: tests/test_torch_mesh.py)."""
    return cylinder_mesh_j(**COARSE), cylinder_mesh_t(**COARSE)


def _same_mesh(a, b):
    assert np.array_equal(a.coords, b.coords) and a.coords.dtype == b.coords.dtype
    assert np.array_equal(a.cells, b.cells) and a.cells.dtype == b.cells.dtype


def _binary_items(path):
    """Every Binary DataItem of an .xdmf: (element, the array read at its
    Seek from the file it names)."""
    root = ET.parse(path).getroot()
    items = [it for it in root.iter("DataItem") if it.get("Format") == "Binary"]
    return [(it, io_t.read_data_item(it, path.parent)) for it in items]


def test_torch_io_reads_jax_mesh_file():
    """The JAX package's committed mesh (Format="HDF") read by both."""
    got, want = io_t.read_xdmf_mesh(JAX_MESH), io_j.read_xdmf_mesh(JAX_MESH)
    _same_mesh(got, want)
    assert got.num_cells == 3158


def test_torch_io_mesh_roundtrip(meshes, tmp_path):
    """write_xdmf_mesh then read_xdmf_mesh gives the mesh back, bitwise; its
    DataItems are Binary, little-endian, and their Seek is the .npy
    header's length; the JAX package reads the same mesh from its own file."""
    mesh_j, mesh_t = meshes
    io_t.write_xdmf_mesh(tmp_path / "t" / "cyl.xdmf", mesh_t)
    io_j.write_xdmf_mesh(tmp_path / "j" / "cyl.xdmf", mesh_j)
    back = io_t.read_xdmf_mesh(tmp_path / "t" / "cyl.xdmf")
    _same_mesh(back, mesh_t)
    _same_mesh(back, io_j.read_xdmf_mesh(tmp_path / "j" / "cyl.xdmf"))
    items = _binary_items(tmp_path / "t" / "cyl.xdmf")
    assert len(items) == 2
    for it, arr in items:
        npy = tmp_path / "t" / it.text
        assert it.get("Endian") == "Little"
        assert int(it.get("Seek")) == io_t.npy_data_offset(npy) == npy.stat().st_size - arr.nbytes
        assert np.array_equal(arr, np.load(npy))
    assert sorted(p.name for p in (tmp_path / "t").iterdir()) == [
        "cyl.xdmf", "cyl_geometry.npy", "cyl_topology.npy"]


def test_torch_io_reads_inline_xml_items(tmp_path):
    """A dolfin-style XDMF with inline Format="XML" DataItems (XYZ geometry)."""
    path = tmp_path / "inline.xdmf"
    path.write_text(
        '<Xdmf Version="3.0"><Domain><Grid Name="Grid">'
        '<Geometry GeometryType="XYZ"><DataItem DataType="Float" Dimensions="4 3" '
        'Format="XML" Precision="8">0 0 0 1 0 0 0 1 0 1 1 0</DataItem></Geometry>'
        '<Topology NodesPerElement="3" NumberOfElements="2" TopologyType="Triangle">'
        '<DataItem DataType="Int" Dimensions="2 3" Format="XML">0 1 2 1 3 2</DataItem>'
        "</Topology></Grid></Domain></Xdmf>"
    )
    m = io_t.read_xdmf_mesh(path)
    assert np.array_equal(m.coords, [[0, 0], [1, 0], [0, 1], [1, 1]])
    assert np.array_equal(m.cells, [[0, 1, 2], [1, 3, 2]])


def test_torch_io_reference_format_hdf(tmp_path):
    """The dolfin-style HDF layout of tests/test_mesh.py's oracle, read by
    both packages."""
    coords = np.array([[0.0, 0.0], [1.0, 0.0], [0.0, 1.0], [1.0, 1.0]])
    with h5py.File(tmp_path / "ref.h5", "w") as f:
        f["data0"] = coords
        f["data1"] = np.array([[0, 1, 2], [1, 3, 2]])
    xdmf = tmp_path / "ref.xdmf"
    xdmf.write_text(
        '<Xdmf Version="3.0"><Domain><Grid Name="Grid">'
        '<Geometry GeometryType="XY"><DataItem DataType="Float" '
        'Dimensions="4 2" Format="HDF" Precision="8">ref.h5:/data0</DataItem>'
        '</Geometry><Topology NodesPerElement="3" NumberOfElements="2" '
        'TopologyType="Triangle"><DataItem DataType="Int" Dimensions="2 3" '
        'Format="HDF" Precision="8">ref.h5:/data1</DataItem></Topology>'
        "</Grid></Domain></Xdmf>"
    )
    _same_mesh(io_t.read_xdmf_mesh(xdmf), io_j.read_xdmf_mesh(xdmf))


def test_torch_io_own_format_needs_no_h5py(meshes, tmp_path, monkeypatch):
    """With h5py unimportable, the port's own mesh files, snapshots, index
    and complex-field export are written and read; a JAX .h5 file, or an
    HDF DataItem, raises ImportError saying that only those need h5py."""
    monkeypatch.setitem(sys.modules, "h5py", None)
    with pytest.raises(ImportError):
        import h5py  # noqa: F401
    _, mesh = meshes
    io_t.write_xdmf_mesh(tmp_path / "m.xdmf", mesh)
    _same_mesh(io_t.read_xdmf_mesh(tmp_path / "m.xdmf"), mesh)
    u = np.random.default_rng(0).standard_normal((mesh.num_vertices, 2))
    io_t.write_field_snapshot(tmp_path / "U", "U", u, 0.5)
    assert np.array_equal(io_t.read_field_snapshot(tmp_path / "U.ckpt", "U", -1), u)
    xdmf = io_t.write_xdmf_timeseries_index(tmp_path / "U.ckpt", mesh, "U")
    assert len(_binary_items(xdmf)) == 3
    space = SpaceT.build(unit_square_mesh_t(2, 2))
    export_complex_field_t(tmp_path / "modes", space, np.ones(space.n_dofs, complex))
    with pytest.raises(ImportError, match="h5py.*port's own files"):
        io_t.FieldCheckpointFile(tmp_path / "jax.h5", "r")
    with pytest.raises(ImportError, match="h5py"):
        io_t.read_xdmf_mesh(JAX_MESH)


@pytest.mark.parametrize("fmt", ["gmsh_v2", "gmsh_v4", "vtk", "dolfin_xml"])
def test_torch_io_convert_readers_match_jax(fmt, meshes, tmp_path):
    """Each reader against the JAX package's on the same file; dolfin XML
    written by both packages is the same text (the coarse cylinder)."""
    if fmt == "dolfin_xml":
        mesh_j, mesh_t = meshes
        convert_t.write_dolfin_xml(tmp_path / "t.xml", mesh_t)
        convert_j.write_dolfin_xml(tmp_path / "j.xml", mesh_j)
        assert (tmp_path / "t.xml").read_text() == (tmp_path / "j.xml").read_text()
        got = convert_t.read_dolfin_xml(tmp_path / "t.xml")
        _same_mesh(got, convert_j.read_dolfin_xml(tmp_path / "t.xml"))
        _same_mesh(got, mesh_t)
        return
    text, suffix, read = {"gmsh_v2": (GMSH_V2, ".msh", "read_gmsh"),
                          "gmsh_v4": (GMSH_V4, ".msh", "read_gmsh"),
                          "vtk": (VTK, ".vtk", "read_legacy_vtk")}[fmt]
    src = tmp_path / f"m{suffix}"
    src.write_text(text)
    got = getattr(convert_t, read)(src)
    _same_mesh(got, getattr(convert_j, read)(src))
    assert got.num_vertices == 4 and got.num_cells == 2


@pytest.mark.parametrize("conv", ["xml2xdmf", "msh2xdmf", "msh2xml", "vtu2xdmf"])
def test_torch_io_converters(conv, tmp_path):
    """The reference-named converters (tests/test_compat_surface.py:41-66):
    each writes its output beside its input, in the port's XDMF where it
    writes XDMF, and it reads back as the JAX package's converter's."""
    small = unit_square_mesh_t(4, 4)
    src = {"xml2xdmf": "m.xml", "msh2xdmf": "t.msh", "msh2xml": "t.msh",
           "vtu2xdmf": "v.vtk"}[conv]
    for side in ("t", "j"):
        d = tmp_path / side
        d.mkdir()
        if src == "m.xml":
            convert_t.write_dolfin_xml(d / src, small)
        else:
            (d / src).write_text(GMSH_V2 if src.endswith(".msh") else VTK)
    getattr(convert_t, f"convert_mesh_{conv}")(tmp_path / "t" / src)
    getattr(convert_j, f"convert_mesh_{conv}")(tmp_path / "j" / src)
    if conv == "msh2xml":
        got = convert_t.read_dolfin_xml(tmp_path / "t" / "t.xml")
        want = convert_j.read_dolfin_xml(tmp_path / "j" / "t.xml")
    else:
        out = tmp_path / "t" / (src.split(".")[0] + ".xdmf")
        assert not out.with_suffix(".h5").exists()
        got = io_t.read_xdmf_mesh(out)
        want = io_j.read_xdmf_mesh(tmp_path / "j" / out.name)
    _same_mesh(got, want)
    if conv == "xml2xdmf":
        _same_mesh(got, small)


def _write_sequence(f):
    """The same writes to a file of either package: appended counters, an
    explicit counter past a gap, a rewrite of counter 0."""
    rng = np.random.default_rng(4)
    arrays = [rng.standard_normal((5, 2)) for _ in range(4)]
    assert f.write("U", arrays[0], 0.0) == 0
    assert f.write("U", arrays[1], 0.5) == 1
    assert f.write("U", arrays[2], 2.0, counter=4) == 4
    assert f.write("U", arrays[3], 0.25, counter=0) == 0
    assert f.write("P", arrays[1][:, 0], 1.0) == 0
    return arrays


def test_torch_io_checkpoint_file_matches_jax(tmp_path):
    """Counters, times (NaN where none was written), negative reads and
    n_checkpoints against the JAX package's HDF5 file; the port reads that
    .h5 (read-only) as the JAX package does; mode 'w' empties a file."""
    with io_t.FieldCheckpointFile(tmp_path / "t" / "snap", "a") as ft, \
            io_j.FieldCheckpointFile(tmp_path / "j" / "snap", "a") as fj:
        arrays = _write_sequence(ft)
        _write_sequence(fj)
        assert ft.path.name == "snap.ckpt" and fj.path.name == "snap.h5"
        for name in ("U", "P", "absent"):
            assert ft.n_checkpoints(name) == fj.n_checkpoints(name)
            np.testing.assert_array_equal(ft.times(name), fj.times(name))
        for counter in (0, 1, 4, -1, -2, -3):
            assert np.array_equal(ft.read("U", counter), fj.read("U", counter)), counter
        assert np.array_equal(ft.read("U", -1), arrays[2])
        assert np.array_equal(ft.read("U", 0), arrays[3])
    assert sorted(p.name for p in (tmp_path / "t" / "snap.ckpt" / "U").iterdir()) == [
        "0.npy", "1.npy", "4.npy"]
    with io_t.FieldCheckpointFile(tmp_path / "j" / "snap.h5", "r") as fh:
        assert fh.counters("U") == [0, 1, 4]
        np.testing.assert_array_equal(fh.times("U"), [0.25, 0.5, np.nan, np.nan, 2.0])
        assert np.array_equal(fh.read("U", -3), arrays[3])
        with pytest.raises(ValueError, match="read-only"):
            fh.write("U", arrays[0], 0.0)
    with pytest.raises(ValueError, match="writes none"):
        io_t.FieldCheckpointFile(tmp_path / "j" / "snap.h5", "a")
    with pytest.raises(FileNotFoundError):
        io_t.FieldCheckpointFile(tmp_path / "missing", "r")
    with io_t.FieldCheckpointFile(tmp_path / "t" / "snap.ckpt", "w") as ft:
        assert ft.n_checkpoints("U") == 0 and len(ft.times("U")) == 0


def test_torch_io_paraview_index_matches_jax(meshes, tmp_path):
    """The .xdmf indexes of U (P2 vector) and P (P1 scalar) snapshots: the
    port's Binary items, read at their Seek, equal the JAX package's
    viz/<name>/<k> and viz_mesh/* datasets; the same grids, attribute types,
    dimensions and times; a second index run adds only the new counters."""
    mesh_j, mesh_t = meshes
    space = SpaceT.build(mesh_t)
    rng = np.random.default_rng(5)
    fields = {"U": [rng.standard_normal((space.n_vnodes, 2)) for _ in range(3)],
              "P": [rng.standard_normal(space.n_pressure_dofs) for _ in range(3)]}
    times = [0.0, 0.025, 0.05]
    for name, snaps in fields.items():
        for io, mesh, side in ((io_t, mesh_t, "t"), (io_j, mesh_j, "j")):
            path = tmp_path / side / f"{name}_restart0,000"
            for k, (a, t) in enumerate(zip(snaps[:2], times)):
                io.write_field_snapshot(path, name, a, t)
            io.write_xdmf_timeseries_index(io_t.checkpoint_path(path) if side == "t"
                                           else path.with_suffix(".h5"), mesh, name)
            io.write_field_snapshot(path, name, snaps[2], times[2])
            io.write_xdmf_timeseries_index(io_t.checkpoint_path(path) if side == "t"
                                           else path.with_suffix(".h5"), mesh, name)
        xt = tmp_path / "t" / f"{name}_restart0,000.xdmf"
        xj = tmp_path / "j" / f"{name}_restart0,000.xdmf"
        gt = ET.parse(xt).getroot().findall(".//Grid[@GridType='Uniform']")
        gj = ET.parse(xj).getroot().findall(".//Grid[@GridType='Uniform']")
        assert [g.get("Name") for g in gt] == [g.get("Name") for g in gj] == [
            f"{name}_{k}" for k in range(3)]
        assert [g.find("Time").get("Value") for g in gt] == [
            g.find("Time").get("Value") for g in gj]
        with h5py.File(tmp_path / "j" / f"{name}_restart0,000.h5", "r") as f:
            for g_t, g_j in zip(gt, gj):
                for tag in ("Topology", "Geometry", "Attribute"):
                    it_t, it_j = g_t.find(f"{tag}/DataItem"), g_j.find(f"{tag}/DataItem")
                    assert it_t.get("Format") == "Binary" and it_j.get("Format") == "HDF"
                    assert it_t.get("Dimensions") == it_j.get("Dimensions"), tag
                    want = np.asarray(f[it_j.text.split(":", 1)[1]])
                    got = io_t.read_data_item(it_t, xt.parent)
                    assert got.dtype == want.dtype and np.array_equal(got, want), tag
                assert g_t.find("Attribute").attrib == g_j.find("Attribute").attrib
            assert f[f"viz/{name}/0"].shape == ((mesh_t.num_vertices, 3) if name == "U"
                                                 else (mesh_t.num_vertices,))


def test_torch_io_export_complex_field_matches_jax(tmp_path):
    """export_complex_field's re/im/abs/arg of u and p, and its frequencies
    as times, against the JAX package's, for two seeded complex modes given
    as columns (the eigenvector layout)."""
    space_t = SpaceT.build(unit_square_mesh_t(4, 4))
    space_j = SpaceJ.build(unit_square_mesh_j(4, 4))
    rng = np.random.default_rng(6)
    modes = rng.standard_normal((space_t.n_dofs, 2)) + 1j * rng.standard_normal((space_t.n_dofs, 2))
    freqs = np.array([0.77, 1.5])
    export_complex_field_t(tmp_path / "modes", space_t, modes, name="mode", frequencies=freqs)
    export_complex_field_j(tmp_path / "modes.h5", space_j, modes, name="mode", frequencies=freqs)
    with io_t.FieldCheckpointFile(tmp_path / "modes.ckpt", "r") as ft, \
            io_t.FieldCheckpointFile(tmp_path / "modes.h5", "r") as fj:
        for comp in ("u", "p"):
            for part in ("re", "im", "abs", "arg"):
                name = f"mode_{comp}_{part}"
                np.testing.assert_array_equal(ft.times(name), fj.times(name))
                np.testing.assert_array_equal(ft.times(name), freqs)
                for k in range(2):
                    assert np.array_equal(ft.read(name, k), fj.read(name, k)), (name, k)
        assert ft.read("mode_u_re", 1).shape == (space_t.n_vnodes, 2)
