"""Mesh and field files: XDMF indexes over ``.npy`` arrays.

The counterpart of ``flowcontrol_tpu/mesh/io.py`` (ref: src/utils/io.py:21-50
write_xdmf/read_xdmf, and the dolfin XDMF meshes read at
src/flowcontrol/flowsolver.py:233-240). The JAX package writes HDF5; the
port writes a format that needs numpy only, so that it runs where h5py is
absent:

- a field snapshot file is a directory named like the JAX ``.h5`` file with
  the suffix ``.ckpt`` (``U_restart0,000.ckpt/``), holding one
  ``<name>/<counter>.npy`` per snapshot (``np.save``: appending rewrites no
  earlier snapshot), ``times.json`` ({name: [time per counter]}, ``null``
  where a counter is missing) and, once indexed for Paraview,
  ``viz/<name>/<counter>.npy`` and ``viz_mesh/{geometry,topology}.npy``;
- every ``.xdmf`` the port writes (meshes, time series) points at ``.npy``
  files through ``Format="Binary"`` DataItems whose ``Seek`` skips the
  ``.npy`` header, so Paraview reads them without HDF5.

HDF5 is read, never written: :func:`read_xdmf_mesh` takes ``Format="HDF"``
DataItems and :class:`FieldCheckpointFile` opens ``.h5`` paths read-only,
both through an ``import h5py`` inside the call. Which format a call uses
follows the path's suffix, not what is installed.
"""

from __future__ import annotations

import json
import os
import shutil
import xml.etree.ElementTree as ET
from pathlib import Path

import numpy as np

from flowcontrol_tpu_torch.mesh.mesh import Mesh2D

#: XDMF NumberType of a numpy dtype kind
_NUMBER_TYPE = {"f": "Float", "i": "Int", "u": "UInt"}
#: numpy dtype kind of an XDMF NumberType
_KIND = {"Float": "f", "Int": "i", "UInt": "u", "Char": "i", "UChar": "u"}
_ENDIAN = {"Little": "<", "Big": ">", "Native": "="}
#: the suffix of the port's snapshot files (directories; see above)
SNAPSHOT_SUFFIX = ".ckpt"


def _require_h5py(what: str):
    try:
        import h5py
    except ImportError as e:
        raise ImportError(
            f"{what} is HDF5, which needs h5py: HDF5 files are the JAX package's "
            "(flowcontrol_tpu); the port's own files (.ckpt directories, .npy "
            "beside .xdmf) need numpy only"
        ) from e
    return h5py


# ── .npy files referenced from XDMF ─────────────────────────────────────────


def npy_data_offset(path) -> int:
    """Byte offset of the array data in a ``.npy`` file (its header's
    length): the ``Seek`` of a Binary DataItem that points at it."""
    with open(path, "rb") as f:
        version = np.lib.format.read_magic(f)
        if version == (1, 0):
            np.lib.format.read_array_header_1_0(f)
        else:
            np.lib.format.read_array_header_2_0(f)
        return f.tell()


def _save_npy(path: Path, data: np.ndarray) -> None:
    """``np.save`` of ``data`` as a C-ordered little-endian array (the
    layout a Binary DataItem describes)."""
    path.parent.mkdir(parents=True, exist_ok=True)
    data = np.asarray(data)
    np.save(path, np.ascontiguousarray(data, dtype=data.dtype.newbyteorder("<")))


def binary_data_item(npy_path, relative_to) -> str:
    """A ``Format="Binary"`` DataItem for the array in ``npy_path``, its file
    named relative to the directory ``relative_to`` (the ``.xdmf``'s)."""
    npy_path = Path(npy_path)
    arr = np.load(npy_path, mmap_mode="r")
    if arr.dtype.kind not in _NUMBER_TYPE:
        raise TypeError(f"{npy_path}: no XDMF number type for dtype {arr.dtype}")
    dims = " ".join(str(d) for d in arr.shape)
    rel = os.path.relpath(npy_path, relative_to)
    return (
        f'<DataItem Dimensions="{dims}" NumberType="{_NUMBER_TYPE[arr.dtype.kind]}" '
        f'Precision="{arr.dtype.itemsize}" Format="Binary" Endian="Little" '
        f'Seek="{npy_data_offset(npy_path)}">{rel}</DataItem>'
    )


def read_data_item(item: ET.Element, base: Path) -> np.ndarray:
    """The array of one XDMF DataItem: ``Format="Binary"`` (raw values at
    ``Seek`` in a file relative to ``base``), ``"XML"`` (inline text) or
    ``"HDF"`` (``file.h5:/dataset``, through h5py)."""
    fmt = item.get("Format", "XML")
    dims = tuple(int(d) for d in item.get("Dimensions", "").split())
    text = (item.text or "").strip()
    number_type = item.get("NumberType", item.get("DataType", "Float"))
    if fmt == "HDF":
        h5py = _require_h5py(f"DataItem {text!r}")
        h5file, dset = text.split(":", 1)
        with h5py.File(base / h5file, "r") as f:
            return np.asarray(f[dset])
    if fmt == "XML":
        dtype = np.float64 if _KIND[number_type] == "f" else np.int64
        return np.array(text.split(), dtype=dtype).reshape(dims)
    if fmt == "Binary":
        precision = int(item.get("Precision", "4"))
        dtype = np.dtype(f"{_ENDIAN[item.get('Endian', 'Native')]}{_KIND[number_type]}{precision}")
        data = np.fromfile(base / text, dtype=dtype, count=int(np.prod(dims)),
                           offset=int(item.get("Seek", "0")))
        return data.reshape(dims)
    raise ValueError(f"unsupported DataItem Format {fmt!r}")


# ── Meshes ───────────────────────────────────────────────────────────────────


def read_xdmf_mesh(path) -> Mesh2D:
    """Read a triangle mesh from an XDMF file: its Geometry and Topology
    DataItems in any format :func:`read_data_item` reads."""
    path = Path(path)
    if not path.exists():
        raise FileNotFoundError(f"Mesh file not found at {path}")
    root = ET.parse(path).getroot()
    geom_item = root.find(".//Geometry/DataItem")
    topo_item = root.find(".//Topology/DataItem")
    if geom_item is None or topo_item is None:
        raise ValueError(f"no Geometry/Topology DataItem found in {path}")
    coords = read_data_item(geom_item, path.parent)[:, :2].astype(np.float64)
    cells = read_data_item(topo_item, path.parent).astype(np.int32)
    return Mesh2D(coords, cells)


def _mesh_xml(geometry: Path, topology: Path, relative_to: Path) -> str:
    nc = np.load(topology, mmap_mode="r").shape[0]
    return (
        f'<Topology NumberOfElements="{nc}" TopologyType="Triangle" NodesPerElement="3">'
        f"{binary_data_item(topology, relative_to)}</Topology>"
        f'<Geometry GeometryType="XY">{binary_data_item(geometry, relative_to)}</Geometry>'
    )


def write_xdmf_mesh(path, mesh: Mesh2D) -> None:
    """Write ``mesh`` as ``path`` (.xdmf) and, beside it,
    ``<stem>_geometry.npy`` (float64 (nv, 2)) and ``<stem>_topology.npy``
    (int64 (nc, 3))."""
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    geometry = path.with_name(path.stem + "_geometry.npy")
    topology = path.with_name(path.stem + "_topology.npy")
    _save_npy(geometry, mesh.coords)
    _save_npy(topology, mesh.cells.astype(np.int64))
    path.write_text(
        '<?xml version="1.0"?><Xdmf Version="3.0"><Domain><Grid Name="mesh" '
        f'GridType="Uniform">{_mesh_xml(geometry, topology, path.parent)}'
        "</Grid></Domain></Xdmf>"
    )


# ── Field snapshots ──────────────────────────────────────────────────────────


def checkpoint_path(path) -> Path:
    """The file a snapshot path names: ``.h5`` paths as they are (the JAX
    package's files), every other path as a ``.ckpt`` directory."""
    path = Path(path)
    if path.suffix in (".h5", SNAPSHOT_SUFFIX):
        return path
    return Path(str(path) + SNAPSHOT_SUFFIX)


class FieldCheckpointFile:
    """Append-mode, counter-indexed field snapshot file, the port's
    counterpart of the reference's XDMFFile.write_checkpoint /
    read_checkpoint (ref: src/utils/io.py:21-50): a ``.ckpt`` directory
    (see the module docstring), or a JAX-written ``.h5`` file, read-only.

    ``mode``: ``'a'`` opens or creates, ``'w'`` empties first, ``'r'``
    reads an existing file.
    """

    def __init__(self, path, mode: str = "a"):
        if mode not in ("a", "w", "r"):
            raise ValueError(f"mode must be 'a', 'w' or 'r', got {mode!r}")
        self.path = checkpoint_path(path)
        self.mode = mode
        self._h5 = None
        if self.path.suffix == ".h5":
            if mode != "r":
                raise ValueError(
                    f"{self.path}: the port reads HDF5 files and writes none; open it "
                    "with mode='r' or write a .ckpt directory"
                )
            self._h5 = _require_h5py(str(self.path)).File(self.path, "r")
            return
        if mode == "r" and not self.path.is_dir():
            raise FileNotFoundError(f"no snapshot file at {self.path}")
        if mode == "w" and self.path.exists():
            shutil.rmtree(self.path)
        self.path.mkdir(parents=True, exist_ok=True)
        times = self.path / "times.json"
        self._times = json.loads(times.read_text()) if times.exists() else {}

    def counters(self, name: str) -> list[int]:
        """The counters written under ``name``, ascending."""
        if self._h5 is not None:
            return sorted(int(k) for k in self._h5[name].keys()) if name in self._h5 else []
        return sorted(int(p.stem) for p in (self.path / name).glob("*.npy"))

    def write(self, name: str, data: np.ndarray, time: float, counter: int | None = None):
        if self._h5 is not None or self.mode == "r":
            raise ValueError(f"{self.path} is open read-only")
        if counter is None:
            counter = len(self.counters(name))
        _save_npy(self.path / name / f"{counter}.npy", data)
        times = self._times.setdefault(name, [])
        times.extend([None] * (counter + 1 - len(times)))
        times[counter] = float(time)
        tmp = self.path / "times.json.tmp"
        tmp.write_text(json.dumps(self._times))
        os.replace(tmp, self.path / "times.json")
        return counter

    def read(self, name: str, counter: int = 0) -> np.ndarray:
        """Snapshot ``counter`` of ``name``; a counter not written (e.g. a
        negative one) indexes the written counters, -1 the last."""
        counters = self.counters(name)
        if counter not in counters:
            counter = counters[counter]
        if self._h5 is not None:
            return np.asarray(self._h5[name][str(counter)])
        return np.load(self.path / name / f"{counter}.npy")

    def n_checkpoints(self, name: str) -> int:
        return len(self.counters(name))

    def times(self, name: str) -> np.ndarray:
        if self._h5 is not None:
            return np.asarray(self._h5.attrs.get(f"{name}_times", []))
        return np.array([np.nan if t is None else t for t in self._times.get(name, [])],
                        dtype=np.float64)

    def close(self) -> None:
        if self._h5 is not None:
            self._h5.close()
            self._h5 = None

    def __enter__(self):
        return self

    def __exit__(self, *a):
        self.close()


def write_xdmf_timeseries_index(ckpt_path, mesh: Mesh2D, name: str, out_path=None) -> Path:
    """Write a Paraview-readable XDMF temporal collection over the snapshots
    ``name`` of a ``.ckpt`` directory (ref: src/utils/io.py:21-50: dolfin's
    XDMFFile writes this index itself).

    Linear triangles and vertex slices, as the JAX package draws them: the
    first ``n_vertices`` rows of a P2 velocity (vertices come first in the
    dof layout) zero-padded to 3 components, and the P1 pressure as it is,
    written once per counter as ``viz/<name>/<counter>.npy`` beside
    ``viz_mesh/{geometry,topology}.npy``. Returns the ``.xdmf`` path
    (default: the directory's with the suffix ``.xdmf``)."""
    with FieldCheckpointFile(ckpt_path, "a") as f:
        ckpt, times, counters = f.path, f.times(name), f.counters(name)
        first = f.read(name, counters[0]) if counters else None
    out_path = Path(out_path) if out_path else ckpt.with_suffix(".xdmf")
    nv = mesh.num_vertices
    geometry, topology = ckpt / "viz_mesh" / "geometry.npy", ckpt / "viz_mesh" / "topology.npy"
    if not geometry.exists():
        _save_npy(geometry, mesh.coords)
        _save_npy(topology, mesh.cells.astype(np.int64))
    is_vector = first is not None and first.ndim == 2
    for k in counters:
        viz = ckpt / "viz" / name / f"{k}.npy"
        if viz.exists():
            continue
        data = np.load(ckpt / name / f"{k}.npy")[:nv]
        if is_vector:
            data = np.pad(data, ((0, 0), (0, 3 - data.shape[1])))
        _save_npy(viz, data)

    mesh_xml = _mesh_xml(geometry, topology, out_path.parent)
    attr_type = "Vector" if is_vector else "Scalar"
    grids = []
    for k in counters:
        t = float(times[k]) if k < len(times) and np.isfinite(times[k]) else float(k)
        item = binary_data_item(ckpt / "viz" / name / f"{k}.npy", out_path.parent)
        grids.append(
            f'<Grid Name="{name}_{k}" GridType="Uniform"><Time Value="{t!r}"/>{mesh_xml}'
            f'<Attribute Name="{name}" AttributeType="{attr_type}" Center="Node">'
            f"{item}</Attribute></Grid>"
        )
    out_path.write_text(
        '<?xml version="1.0"?><Xdmf Version="3.0"><Domain>'
        f'<Grid Name="{name}_series" GridType="Collection" '
        f'CollectionType="Temporal">{"".join(grids)}</Grid></Domain></Xdmf>'
    )
    return out_path


def write_field_snapshot(path, name, data, time, counter=None, append=True):
    """One-shot write (ref: utils.io.write_xdmf)."""
    with FieldCheckpointFile(path, "a" if append else "w") as f:
        return f.write(name, data, time, counter)


def read_field_snapshot(path, name, counter=0):
    """One-shot read (ref: utils.io.read_xdmf)."""
    with FieldCheckpointFile(path, "r") as f:
        return f.read(name, counter)
