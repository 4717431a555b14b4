"""N(u) in the PyTorch port against the JAX package, and kernel K1.

- The port's plain torch N(u) in float64 against the JAX package's XLA
  ``nonlinear_convection`` to 1e-12 relative (the same einsums in another
  order), single and batched.
- The port's plain N(u) in float32 against the JAX package's Pallas kernel
  itself (``ops/pallas_nl.py``, K1 on the TPU), run in interpret mode on the
  CPU through the reference's own tables (RCM node windows, split hot
  layout), to 1e-5 relative: both are f32 with different summation orders.
  This pins the math of the TPU kernel the port replaces.
- K1's patch tables (the cells along a Morton curve, cut into patches):
  every (cell, node, component) slot is summed by exactly one patch node,
  each patch node is the node its slots name, and every velocity node is
  either owned by the one patch that touches it or has one partial slot
  per touching patch, in patch order. K1's plain walk over those tables
  against the JAX package: XLA in float64 to 1e-10 and the Pallas kernel
  in interpret mode in float32 to 1e-5.
K1 itself (``csrc/nl_convection.cu``) needs a CUDA device: its tests are in
``test_torch_cuda.py``.
"""

import numpy as np
import pytest
import torch

from flowcontrol_tpu.fem import assembly as asm_j
from flowcontrol_tpu.mesh.dofmap import TaylorHoodSpace as SpaceJ
from flowcontrol_tpu.mesh.generation import cylinder_mesh, unit_square_mesh
from flowcontrol_tpu_torch.fem.assembly import CellGeometry
from flowcontrol_tpu_torch.mesh.dofmap import TaylorHoodSpace
from flowcontrol_tpu_torch.ops.nl import (
    NLTables,
    nonlinear_convection,
    nonlinear_convection_patches_plain,
    nonlinear_convection_plain,
)

torch.set_num_threads(1)

COARSE = dict(yinf=5.0, xinf=15.0, xinfa=-5.0, n1=4.0, n2=2.0, n3=0.8, segments=80)
MESHES = {"square8": lambda: unit_square_mesh(8, 8), "cylinder": lambda: cylinder_mesh(**COARSE)}


@pytest.fixture(scope="module", params=sorted(MESHES))
def problem(request):
    mesh = MESHES[request.param]()
    space = TaylorHoodSpace.build(mesh)
    return mesh, space, CellGeometry(space)


def _rel(a, b):
    return np.abs(np.asarray(a) - np.asarray(b)).max() / np.abs(np.asarray(b)).max()


@pytest.mark.parametrize("batch", [1, 3])
def test_torch_nl_plain_f64_matches_xla(problem, batch):
    mesh, space, geom = problem
    sj = SpaceJ.build(mesh)
    gj = asm_j.CellGeometry(sj)
    u = np.random.default_rng(batch).standard_normal((batch, space.n_dofs))
    u_in = u[0] if batch == 1 else u
    ref = np.asarray(asm_j.nonlinear_convection(
        {"wq": gj.wq, "phi2": gj.phi2, "dphi2": gj.dphi2}, sj, u_in
    ))
    tables = NLTables.build(geom, space, "cpu", torch.float64)
    got = nonlinear_convection(tables, torch.as_tensor(u_in)).numpy()
    assert got.shape == ref.shape
    assert _rel(got, ref) <= 1e-12


def _pallas_k1_f32(problem, u):
    """N(u) by the JAX package's Pallas kernel K1 in interpret mode (f32),
    through the reference's own tables, in the port's dof order."""
    from flowcontrol_tpu.ops.cellwindows import build_cell_windows, node_rcm
    from flowcontrol_tpu.ops.pallas_nl import build_nl_pallas, nonlinear_convection_pallas

    _, space, geom = problem
    nv, n = space.n_vnodes, space.n_dofs
    nperm = node_rcm(space.cell_vel_nodes, nv)
    tree, static = build_cell_windows(
        space.cell_vel_nodes, nv,
        {"wq": geom.wq, "dphi2": geom.dphi2, "phi2": geom.phi2},
        dtype=np.float32, node_order=nperm, split_layout=True,
    )
    tree = dict(tree) | build_nl_pallas(tree, static)
    # the stepper's hot order: [u-dofs, v-dofs] in node-RCM order, then p
    hot_src = np.concatenate([2 * nperm, 2 * nperm + 1, np.arange(2 * nv, n)])
    y_hot = np.asarray(nonlinear_convection_pallas(tree, static, u[hot_src], n))
    ref = np.empty_like(y_hot)
    ref[hot_src] = y_hot
    return ref


def test_torch_nl_plain_f32_matches_pallas_k1(problem):
    _, space, geom = problem
    u = np.random.default_rng(7).standard_normal(space.n_dofs).astype(np.float32)
    ref = _pallas_k1_f32(problem, u)
    tables = NLTables.build(geom, space, "cpu", torch.float32)
    got = nonlinear_convection_plain(tables, torch.as_tensor(u)).numpy()
    assert got.dtype == np.float32
    assert _rel(got, ref) <= 1e-5


def test_torch_nl_wrapper_cpu_is_plain_and_counts_nothing(problem):
    """On a CPU tensor the wrapper is the plain version; it launches no
    kernel, so the launch count does not move."""
    _, space, geom = problem
    tables = NLTables.build(geom, space, "cpu", torch.float32)
    u = torch.as_tensor(np.random.default_rng(8).standard_normal(space.n_dofs), dtype=torch.float32)
    before = nonlinear_convection.launches
    assert torch.equal(nonlinear_convection(tables, u), nonlinear_convection_plain(tables, u))
    assert nonlinear_convection.launches == before


def test_torch_nl_patches_cover_every_slot_once(problem):
    _, space, geom = problem
    pt = NLTables.build(geom, space, "cpu", torch.float64).patches
    cvn = space.cell_vel_nodes
    nc = cvn.shape[0]
    assert sorted(pt.perm[pt.perm >= 0].tolist()) == list(range(nc))
    assert bool((pt.perm[nc:] == -1).all()) and len(pt.perm) == pt.n_patches * pt.cells
    p, node_l, k = np.nonzero(pt.slots >= 0)
    s = pt.slots[p, node_l, k]
    cell = pt.perm[p * pt.cells + s // 6]
    a = s % 6
    assert bool((cell >= 0).all())
    # each (cell, node, component) slot summed exactly once
    flat = np.concatenate([cell * 12 + 2 * a, cell * 12 + 2 * a + 1])
    assert np.array_equal(np.sort(flat), np.arange(nc * 12))
    # the patch node that sums a slot is the node of that slot, and the
    # cell's local nodes name the same nodes
    assert np.array_equal(pt.nodes[p, node_l], cvn[cell, a])
    pos = np.flatnonzero(pt.perm >= 0)
    assert np.array_equal(pt.nodes[pos // pt.cells][np.arange(len(pos))[:, None],
                                                   pt.cell_loc[pos]], cvn[pt.perm[pos]])
    # a node's slots in the fixed order (cells ascending, then the node),
    # the pads after them
    big = 1 << 30
    v = np.where(pt.slots >= 0, pt.slots, big)
    assert bool(((np.diff(v, axis=-1) > 0) | (v[..., 1:] == big)).all())
    assert bool(((pt.slots[..., 1:] < 0) | (pt.slots[..., :-1] >= 0)).all())


def test_torch_nl_patches_owner_or_partials_complete(problem):
    _, space, geom = problem
    pt = NLTables.build(geom, space, "cpu", torch.float64).patches
    nv = space.n_vnodes
    touching = [set() for _ in range(nv)]
    for pos in np.flatnonzero(pt.perm >= 0):
        for node in space.cell_vel_nodes[pt.perm[pos]]:
            touching[node].add(int(pos // pt.cells))
    real = np.arange(pt.nodes.shape[1]) < pt.n_local[:, None]
    p, node_l = np.nonzero(real)
    dest = pt.dest[p, node_l]
    owners = {}
    for pi, node, d in zip(p, pt.nodes[p, node_l], dest):
        if d >= 0:
            assert d == node and node not in owners
            owners[int(node)] = int(pi)
    slot_patch = np.full(len(pt.slot_halo), -1)
    slot_patch[-dest[dest < 0] - 1] = p[dest < 0]
    assert bool((slot_patch >= 0).all())
    halo = {int(node): h for h, node in enumerate(pt.halo_node)}
    assert len(owners) + len(halo) == nv and not set(owners) & set(halo)
    for node in range(nv):
        if node in owners:
            assert touching[node] == {owners[node]}
            continue
        h = halo[node]
        q = np.arange(pt.halo_start[h], pt.halo_start[h + 1])
        assert bool((pt.slot_halo[q] == h).all())
        assert slot_patch[q].tolist() == sorted(touching[node])  # one per patch, in order
    assert pt.halo_share < 1 and (pt.halo_share > 0) == (pt.n_patches > 1)


@pytest.mark.parametrize("batch", [1, 3])
def test_torch_nl_patches_plain_f64_matches_xla(problem, batch):
    mesh, space, geom = problem
    sj = SpaceJ.build(mesh)
    gj = asm_j.CellGeometry(sj)
    u = np.random.default_rng(20 + batch).standard_normal((batch, space.n_dofs))
    u_in = u[0] if batch == 1 else u
    ref = np.asarray(asm_j.nonlinear_convection(
        {"wq": gj.wq, "phi2": gj.phi2, "dphi2": gj.dphi2}, sj, u_in
    ))
    tables = NLTables.build(geom, space, "cpu", torch.float64)
    got = nonlinear_convection_patches_plain(tables, torch.as_tensor(u_in)).numpy()
    assert got.shape == ref.shape
    assert _rel(got, ref) <= 1e-10


def test_torch_nl_patches_plain_f32_matches_pallas_k1(problem):
    _, space, geom = problem
    u = np.random.default_rng(9).standard_normal(space.n_dofs).astype(np.float32)
    ref = _pallas_k1_f32(problem, u)
    tables = NLTables.build(geom, space, "cpu", torch.float32)
    got = nonlinear_convection_patches_plain(tables, torch.as_tensor(u)).numpy()
    assert got.dtype == np.float32
    assert _rel(got, ref) <= 1e-5
