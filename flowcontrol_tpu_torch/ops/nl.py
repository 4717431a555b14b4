"""Nonlinear convection N(u) = ∫ ((u·∇)u)·v dx: plain torch and kernel K1.

N(u) is the one u-dependent element pass of every time step (and of
``Stepper.init_carry``). Three pieces live here:

- :class:`NLTables`: the per-cell quadrature tables and the velocity gather
  table on one device, built once per stepper, and K1's patch tables
  (:class:`NLPatches`): the cells along a Morton curve of their centroids,
  cut into patches of :data:`PATCH_CELLS` cells, each patch's nodes, the
  fixed order in which each node sums its cells' contributions, and which
  nodes lie on a patch boundary. The dof numbering is untouched.
- :func:`nonlinear_convection_plain`: the plain torch version (the einsums
  of ``flowcontrol_tpu/fem/assembly.py:_nonlinear_contributions`` plus the
  gather-table assembly). The CPU path and the tests use it.
- :func:`nonlinear_convection_patches_plain`: K1's walk over the patch
  tables in torch (per-patch node sums, direct writes, boundary partials
  summed in patch order), which the CPU tests hold against the JAX package.
- :func:`nonlinear_convection`: the wrapper the stepper calls. For a CPU
  tensor it returns the plain version; for a CUDA tensor it launches the
  hand-written kernel ``csrc/nl_convection.cu`` (K1, the port of the TPU
  kernel ``flowcontrol_tpu/ops/pallas_nl.py:_nl_kernel``) or raises — it
  never falls back. ``nonlinear_convection.launches`` counts kernel
  launches (one per call), so a run can show that its steps went through
  K1.
"""

from __future__ import annotations

import ctypes
from dataclasses import dataclass, field

import numpy as np
import torch

from flowcontrol_tpu_torch.fem.assembly import (
    CellGeometry,
    build_gather_table,
    gather_assemble,
    velocity_cell_dofs,
)
from flowcontrol_tpu_torch.mesh.dofmap import TaylorHoodSpace
from flowcontrol_tpu_torch.ops.cuda_build import CudaLibrary, counted


#: cells of one K1 patch (csrc/nl_convection.cu kCells: a block's 256
#: threads take the patch's cells for four samples at a time)
PATCH_CELLS = 64


def morton_order(xy: np.ndarray) -> np.ndarray:
    """Indices sorting points (m, 2) along a Morton (Z-order) curve of their
    positions quantized to 16 bits per axis in their bounding box; ties keep
    their order."""
    lo, hi = xy.min(axis=0), xy.max(axis=0)
    q = np.minimum((xy - lo) / np.maximum(hi - lo, 1e-300) * 65536, 65535).astype(np.int64)

    def spread(v):  # bit i of v to bit 2i
        v = (v | (v << 8)) & 0x00FF00FF
        v = (v | (v << 4)) & 0x0F0F0F0F
        v = (v | (v << 2)) & 0x33333333
        return (v | (v << 1)) & 0x55555555

    return np.argsort(spread(q[:, 0]) | (spread(q[:, 1]) << 1), kind="stable")


@dataclass
class NLPatches:
    """K1's patch tables (host numpy, int32 unless noted).

    perm (n_patches * cells,): the mesh cell at each patch position, -1 for
    the padding of the last patch; cell_loc (n_patches * cells, 6): the
    local node of each cell node (0 for padding); nodes (n_patches, lmax):
    the global velocity node of each local node (ascending), n_local
    (n_patches,); slots (n_patches, lmax, kmax): the contributions a local
    node sums, as cell * 6 + node within the patch, cells ascending, -1
    pads; dest (n_patches, lmax): the node itself where this patch alone
    touches it (written directly), else -(q + 1) for its partial slot q;
    halo_node (n_halo,): the boundary nodes (touched by more than one
    patch), ascending; halo_start (n_halo + 1,): each one's partial slots,
    in patch order; slot_halo (n_slots,): the boundary node of each slot.
    """

    cells: int
    perm: np.ndarray
    cell_loc: np.ndarray
    nodes: np.ndarray
    n_local: np.ndarray
    slots: np.ndarray
    dest: np.ndarray
    halo_node: np.ndarray
    halo_start: np.ndarray
    slot_halo: np.ndarray

    @classmethod
    def build(cls, cell_vel_nodes: np.ndarray, centroids: np.ndarray, n_vnodes: int,
              cells: int = PATCH_CELLS) -> "NLPatches":
        cvn = np.asarray(cell_vel_nodes, dtype=np.int64)
        nc = cvn.shape[0]
        n_patches = -(-nc // cells)
        perm = morton_order(np.asarray(centroids, dtype=np.float64))
        # (patch, node) pairs, sorted by patch then node: the local nodes
        pid = np.repeat(np.arange(nc) // cells, 6)
        key = pid * n_vnodes + cvn[perm].reshape(-1)
        uniq, inv = np.unique(key, return_inverse=True)
        u_patch, u_node = uniq // n_vnodes, uniq % n_vnodes
        n_local = np.bincount(u_patch, minlength=n_patches)
        first = np.concatenate([[0], np.cumsum(n_local)[:-1]])
        loc = np.arange(len(uniq)) - first[u_patch]
        lmax = int(n_local.max())
        cell_loc = np.zeros((n_patches * cells, 6), np.int64)
        cell_loc[:nc] = loc[inv].reshape(nc, 6)
        nodes = np.zeros((n_patches, lmax), np.int64)
        nodes[u_patch, loc] = u_node
        # each local node's contributions, in entry order (cell, then node)
        order = np.argsort(inv, kind="stable")
        counts = np.bincount(inv, minlength=len(uniq))
        rank = np.arange(len(order)) - np.repeat(np.cumsum(counts) - counts, counts)
        kmax = int(counts.max())
        slots = np.full((n_patches, lmax, kmax), -1, np.int64)
        entry = np.arange(nc * 6)  # (position in the patch order, node of the cell)
        slot_id = (entry // 6 % cells) * 6 + entry % 6
        slots[u_patch[inv[order]], loc[inv[order]], rank] = slot_id[order]
        # ownership: a node of one patch is written directly; the others
        # are summed from one partial per patch, in patch order
        share = np.bincount(u_node, minlength=n_vnodes)
        halo = share[u_node] > 1
        halo_node = np.flatnonzero(share > 1)
        h_of = np.full(n_vnodes, -1, np.int64)
        h_of[halo_node] = np.arange(len(halo_node))
        hp = np.flatnonzero(halo)  # pairs on a boundary, by (patch, node)
        q_order = hp[np.lexsort((u_patch[hp], u_node[hp]))]  # by (node, patch)
        q_of = np.empty(len(uniq), np.int64)
        q_of[q_order] = np.arange(len(q_order))
        dest = np.zeros((n_patches, lmax), np.int64)
        dest[u_patch, loc] = np.where(halo, -(q_of + 1), u_node)
        halo_start = np.concatenate([[0], np.cumsum(share[halo_node])])
        perm_pad = np.full(n_patches * cells, -1, np.int64)
        perm_pad[:nc] = perm

        def i32(a):
            return np.ascontiguousarray(a, dtype=np.int32)

        return cls(cells=cells, perm=i32(perm_pad), cell_loc=i32(cell_loc), nodes=i32(nodes),
                   n_local=i32(n_local), slots=i32(slots), dest=i32(dest),
                   halo_node=i32(halo_node), halo_start=i32(halo_start),
                   slot_halo=i32(h_of[u_node[q_order]]))

    @property
    def n_patches(self) -> int:
        return self.nodes.shape[0]

    @property
    def halo_share(self) -> float:
        """Share of the velocity nodes that lie on a patch boundary."""
        real = np.arange(self.nodes.shape[1]) < self.n_local[:, None]
        owned = int(((self.dest >= 0) & real).sum())
        return len(self.halo_node) / (len(self.halo_node) + owned)

    def geometry(self, dphi2: np.ndarray, wq: np.ndarray) -> np.ndarray:
        """(n_patches * cells, 91): each cell's dphi2 (7, 6, 2) then wq (7),
        in patch order; zero for the padding."""
        geo = np.concatenate([np.asarray(dphi2).reshape(len(wq), -1), np.asarray(wq)], axis=1)
        out = np.zeros((len(self.perm), geo.shape[1]), geo.dtype)
        real = self.perm >= 0
        out[real] = geo[self.perm[real]]
        return out


@dataclass
class NLTables:
    """Device tables of N(u) for one mesh.

    cell_vel_nodes (nc, 6) int32, dphi2 (nc, 7, 6, 2), wq (nc, 7) (includes
    detJ/2), phi2 (7, 6), gt_vel (n_dofs, kmax) int32: for each mixed dof
    the flat (cell, node, component) slots that assemble into it, padded
    with nc*12 (pressure rows are all padding). patches: K1's host tables;
    patch_dev: the same on the device (int32) and ``geo``, the geometry in
    patch order, as K1 reads them. K1's calls with one NLTables run in the
    order of one stream (they share its arrival counters). ``subset``: the
    tables hold only some of the mesh's cells (a rank's share,
    ``parallel/sharding.py``), so N(u) is zero at the nodes none of them
    touches, and K1's output starts zeroed.
    """

    cell_vel_nodes: torch.Tensor
    dphi2: torch.Tensor
    wq: torch.Tensor
    phi2: torch.Tensor
    gt_vel: torch.Tensor
    n_vnodes: int
    patches: NLPatches
    patch_dev: dict
    #: K1's arrival counters on the device, zero between calls (the kernel
    #: leaves them zero): one set per (device, size), made on first use and
    #: never replaced, since a CUDA graph that captured a K1 launch goes on
    #: using the set it captured
    arrivals: dict = field(default_factory=dict)
    subset: bool = False

    @classmethod
    def build(cls, geom: CellGeometry, space: TaylorHoodSpace,
              device: torch.device | str, dtype: torch.dtype,
              cells: np.ndarray | None = None) -> "NLTables":
        """The tables of every cell, or of the cells ``cells`` (indices
        into the mesh's cells) alone."""
        def f(a):
            return torch.as_tensor(np.ascontiguousarray(a), dtype=dtype, device=device)

        def i32(a):
            return torch.as_tensor(np.ascontiguousarray(a, dtype=np.int32), device=device)

        sel = slice(None) if cells is None else np.asarray(cells)
        cvn = space.cell_vel_nodes[sel]
        table = build_gather_table(velocity_cell_dofs(space)[sel], space.n_dofs)
        centroids = space.vel_node_coords[cvn[:, :3]].mean(axis=1)
        patches = NLPatches.build(cvn, centroids, space.n_vnodes)
        dphi2, wq = np.asarray(geom.dphi2)[sel], np.asarray(geom.wq)[sel]
        patch_dev = {k: i32(getattr(patches, k)) for k in (
            "cell_loc", "nodes", "n_local", "slots", "dest", "halo_node", "halo_start",
            "slot_halo")}
        patch_dev["geo"] = f(patches.geometry(dphi2, wq))
        return cls(
            cell_vel_nodes=i32(cvn),
            dphi2=f(dphi2),
            wq=f(wq),
            phi2=f(geom.phi2),
            gt_vel=i32(table),
            n_vnodes=space.n_vnodes,
            patches=patches,
            patch_dev=patch_dev,
            subset=cells is not None,
        )

    @property
    def n_dofs(self) -> int:
        return self.gt_vel.shape[0]


def nonlinear_contributions(t: NLTables, u: torch.Tensor) -> torch.Tensor:
    """Per-element contributions r_e (..., nc*12), flattened (cell, node, comp)."""
    batch = u.shape[:-1]
    u_nodes = u[..., : 2 * t.n_vnodes].reshape(batch + (t.n_vnodes, 2))
    u_e = u_nodes[..., t.cell_vel_nodes.long(), :]  # (..., nc, 6, 2)
    u_q = torch.einsum("qn,...cnd->...cqd", t.phi2, u_e)
    g_q = torch.einsum("cqni,...cnd->...cqid", t.dphi2, u_e)  # ∂u_d/∂x_i
    conv_q = torch.einsum("...cqi,...cqid->...cqd", u_q, g_q)
    r_e = torch.einsum("cq,qa,...cqd->...cad", t.wq, t.phi2, conv_q)
    return r_e.reshape(batch + (-1,))


def nonlinear_convection_plain(t: NLTables, u: torch.Tensor) -> torch.Tensor:
    """N(u) as a mixed vector (..., n_dofs), plain torch, any device/dtype."""
    return gather_assemble(nonlinear_contributions(t, u), t.gt_vel)


def nonlinear_convection_patches_plain(t: NLTables, u: torch.Tensor) -> torch.Tensor:
    """N(u) (..., n_dofs) by K1's walk over the patch tables, plain torch:
    each cell's contributions from the geometry in patch order, each patch
    node's sum over its slot list, written directly where the patch owns
    the node, else a partial per patch summed in patch order."""
    pd, pt = t.patch_dev, t.patches
    batch = u.shape[:-1]
    cells = pt.cells
    geo = pd["geo"]
    n_pc = geo.shape[0]
    dphi2 = geo[:, :84].reshape(n_pc, 7, 6, 2)
    wq = geo[:, 84:]
    loc = pd["cell_loc"].long().reshape(-1, cells, 6)
    node_of = torch.gather(pd["nodes"].long(), 1, loc.reshape(loc.shape[0], -1))  # (np, P*6)
    u_nodes = u[..., : 2 * t.n_vnodes].reshape(batch + (t.n_vnodes, 2))
    u_e = u_nodes[..., node_of.reshape(n_pc, 6), :]  # (..., n_pc, 6, 2)
    u_q = torch.einsum("qn,...cnd->...cqd", t.phi2, u_e)
    g_q = torch.einsum("cqni,...cnd->...cqid", dphi2, u_e)
    conv_q = torch.einsum("...cqi,...cqid->...cqd", u_q, g_q)
    r = torch.einsum("cq,qa,...cqd->...cad", wq, t.phi2, conv_q)  # (..., n_pc, 6, 2)
    # patch node sums over the slot lists (pads read an appended zero)
    r = torch.cat([r.reshape(batch + (-1, 2)), r.new_zeros(batch + (1, 2))], dim=-2)
    slots = pd["slots"].long()
    base = (torch.arange(slots.shape[0], device=slots.device) * cells * 6)[:, None, None]
    idx = torch.where(slots >= 0, slots + base, torch.full_like(slots, n_pc * 6))
    sums = r[..., idx, :].sum(dim=-2)  # (..., n_patches, lmax, 2)
    real = (torch.arange(slots.shape[1], device=slots.device)[None, :]
            < pd["n_local"].long()[:, None])
    dest = pd["dest"].long()
    out = u.new_zeros(batch + (t.n_dofs,))
    vel = out[..., : 2 * t.n_vnodes].view(batch + (t.n_vnodes, 2))
    own = real & (dest >= 0)
    vel[..., dest[own], :] = sums[..., own, :]
    part = real & (dest < 0)
    partial = sums.new_zeros(batch + (len(pt.slot_halo), 2))
    partial[..., -dest[part] - 1, :] = sums[..., part, :]
    starts = pd["halo_start"].long()
    if len(pt.halo_node):
        n_share = starts[1:] - starts[:-1]
        kmax = int(n_share.max())
        k = torch.arange(kmax, device=starts.device)
        q = torch.where(k[None, :] < n_share[:, None], starts[:-1, None] + k[None, :],
                        torch.full((len(n_share), kmax), len(pt.slot_halo), device=starts.device))
        partial = torch.cat([partial, partial.new_zeros(batch + (1, 2))], dim=-2)
        vel[..., pd["halo_node"].long(), :] = partial[..., q, :].sum(dim=-2)
    return out


def _declare(lib: ctypes.CDLL) -> None:
    p, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
    lib.nl_convection_f32.argtypes = (
        [p, p, i64, i32, i32, i32, p, p] + [p] * 8 + [i32] * 6 + [p, p, p])
    lib.nl_convection_f32.restype = i32
    lib.nl_samples_per_pass.argtypes = []
    lib.nl_samples_per_pass.restype = i32
    lib.nl_error_string.argtypes = [i32]
    lib.nl_error_string.restype = ctypes.c_char_p


#: K1's shared library, built from csrc/nl_convection.cu on first launch.
NL_KERNEL = CudaLibrary("nl_convection", "nl_convection.cu", _declare)


def sample_tile(batch: int, n_patches: int, per_pass: int, blocks: int = 1024) -> int:
    """Samples per K1 block, a multiple of the kernel's samples per pass:
    enough (patch, tile) blocks to fill the card several times over (about
    ``blocks`` of them), at most 4 passes a block."""
    passes = -(-batch * n_patches // (per_pass * blocks))
    return per_pass * max(1, min(4, passes))


def _check_table(name: str, x: torch.Tensor, dtype: torch.dtype, device: torch.device):
    if x.device != device or x.dtype != dtype or not x.is_contiguous():
        raise ValueError(
            f"K1 needs {name} as a contiguous {dtype} tensor on {device}, "
            f"got {x.dtype} on {x.device} (contiguous={x.is_contiguous()})"
        )


def _nonlinear_convection_cuda(t: NLTables, u: torch.Tensor) -> torch.Tensor:
    n = t.n_dofs
    if u.dtype != torch.float32:
        raise TypeError(f"K1 takes float32 tensors only, got {u.dtype}")
    if u.shape[-1] != n:
        raise ValueError(f"u has {u.shape[-1]} dofs, the tables {n}")
    dev = u.device
    pd, pt = t.patch_dev, t.patches
    _check_table("phi2", t.phi2, torch.float32, dev)
    _check_table("geo", pd["geo"], torch.float32, dev)
    for name in ("cell_loc", "nodes", "n_local", "slots", "dest", "halo_node", "halo_start",
                 "slot_halo"):
        _check_table(name, pd[name], torch.int32, dev)
    u2 = u.reshape(-1, n).contiguous()
    b = u2.shape[0]
    # K1 writes the nodes its patches touch and the pressure rows
    out = (torch.zeros if t.subset else torch.empty)((b, n), dtype=torch.float32, device=dev)
    lib = NL_KERNEL.get()
    tile = sample_tile(b, pt.n_patches, lib.nl_samples_per_pass())
    n_halo, n_slots = len(pt.halo_node), len(pt.slot_halo)
    partial = torch.empty((b, max(n_slots, 1), 2), dtype=torch.float32, device=dev)
    need = -(-b // tile) * max(n_halo, 1)
    arrivals = t.arrivals.get((dev, need))
    if arrivals is None:
        arrivals = t.arrivals[(dev, need)] = torch.zeros(need, dtype=torch.int32, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    rc = lib.nl_convection_f32(
        u2.data_ptr(), out.data_ptr(), n, t.n_vnodes, b, tile, t.phi2.data_ptr(),
        pd["geo"].data_ptr(), pd["cell_loc"].data_ptr(), pd["nodes"].data_ptr(),
        pd["n_local"].data_ptr(), pd["slots"].data_ptr(), pd["dest"].data_ptr(),
        pd["halo_node"].data_ptr(), pd["halo_start"].data_ptr(), pd["slot_halo"].data_ptr(),
        pt.n_patches, pt.cells, pt.nodes.shape[1], pt.slots.shape[2], n_halo, n_slots,
        partial.data_ptr(), arrivals.data_ptr(), stream,
    )
    if rc != 0:
        raise RuntimeError(
            f"K1 launch failed: {lib.nl_error_string(rc).decode()} (cudaError {rc})"
        )
    nonlinear_convection.launches += 1
    return out.reshape(u.shape)


@counted
def nonlinear_convection(t: NLTables, u: torch.Tensor) -> torch.Tensor:
    """N(u) for u (..., n_dofs): kernel K1 on CUDA, the plain version on CPU.

    The choice follows the tensor's device only. A CUDA tensor must be
    float32 and its tables must sit on the same card; anything else raises.
    """
    if u.device.type == "cuda":
        return _nonlinear_convection_cuda(t, u)
    if u.device.type == "cpu":
        return nonlinear_convection_plain(t, u)
    raise ValueError(f"no N(u) path for device type {u.device.type!r}")
