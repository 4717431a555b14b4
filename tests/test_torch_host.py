"""Host setup of the PyTorch port against the JAX package: bitwise parity.

Mesh, dof maps, element tensors, gather tables, transient-LHS CSR and the
Dirichlet elimination are float64 numpy/scipy in both packages, transcribed
line for line, so they must agree exactly (``np.array_equal``) on the coarse
cylinder mesh of the integration tests. Also pins the port's default mesh to
the reference generator's and to the committed mesh file, and checks that
importing the port leaves JAX out of the process.
"""

import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from flowcontrol_tpu.fem import assembly as asm_j
from flowcontrol_tpu.mesh.dofmap import TaylorHoodSpace as SpaceJ
from flowcontrol_tpu.mesh.generation import cylinder_mesh as cylinder_mesh_j
from flowcontrol_tpu.models.cylinder import CylinderFlowSolver as CylJ
from flowcontrol_tpu_torch.fem import assembly as asm_t
from flowcontrol_tpu_torch.mesh.dofmap import TaylorHoodSpace as SpaceT
from flowcontrol_tpu_torch.mesh.generation import cylinder_mesh as cylinder_mesh_t
from flowcontrol_tpu_torch.models.cylinder import CylinderFlowSolver as CylT

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parents[1]
COARSE = dict(yinf=5.0, xinf=15.0, xinfa=-5.0, n1=4.0, n2=2.0, n3=0.8, segments=80)


@pytest.fixture(scope="module")
def meshes():
    return cylinder_mesh_j(**COARSE), cylinder_mesh_t(**COARSE)


@pytest.fixture(scope="module")
def solvers(meshes, tmp_path_factory):
    mj, mt = meshes
    kw = dict(Re=100, num_steps=2, mesh=None, solver_backend="host_lu", precision="f64")
    fj = CylJ.make_default(**{**kw, "mesh": mj}, path_out=tmp_path_factory.mktemp("j"))
    ft = CylT.make_default(**{**kw, "mesh": mt}, path_out=tmp_path_factory.mktemp("t"),
                           device="cpu")
    return fj, ft


def _csr_equal(a, b):
    a, b = a.tocsr(), b.tocsr()
    return (
        a.shape == b.shape
        and np.array_equal(a.indptr, b.indptr)
        and np.array_equal(a.indices, b.indices)
        and np.array_equal(a.data, b.data)
    )


@pytest.mark.parametrize("key", [
    "coords", "cells", "edges", "cell_edges", "boundary_facets",
    "boundary_facet_cells", "boundary_facet_local", "boundary_edge_ids",
])
def test_torch_mesh_bitwise(meshes, key):
    mj, mt = meshes
    assert np.array_equal(getattr(mj, key), getattr(mt, key))


@pytest.mark.parametrize("key", ["vel_node_coords", "cell_vel_nodes", "cell_dofs"])
def test_torch_dofmap_bitwise(meshes, key):
    sj, st = SpaceJ.build(meshes[0]), SpaceT.build(meshes[1])
    assert sj.n_dofs == st.n_dofs
    assert np.array_equal(getattr(sj, key), getattr(st, key))


def test_torch_element_tensors_bitwise(meshes):
    sj, st = SpaceJ.build(meshes[0]), SpaceT.build(meshes[1])
    gj, gt = asm_j.CellGeometry(sj), asm_t.CellGeometry(st)
    for key in ("inv_jt", "detj", "wq", "dphi2", "dphi1", "phi2", "phi1"):
        assert np.array_equal(getattr(gj, key), getattr(gt, key)), key
    u0 = np.random.default_rng(3).standard_normal((sj.n_vnodes, 2))
    uc = u0[sj.cell_vel_nodes]
    assert np.array_equal(asm_j.mass_velocity_element(gj), asm_t.mass_velocity_element(gt))
    assert np.array_equal(
        asm_j.linear_operator_element(gj, uc, 0.01, shift=0.3),
        asm_t.linear_operator_element(gt, uc, 0.01, shift=0.3),
    )
    assert np.array_equal(
        asm_j.velocity_operator_element(gj, uc, 0.01),
        asm_t.velocity_operator_element(gt, uc, 0.01),
    )
    up = np.random.default_rng(4).standard_normal(sj.n_dofs)
    assert np.array_equal(asm_j.nonlinear_convection_np(gj, sj, up),
                          asm_t.nonlinear_convection_np(gt, st, up))


@pytest.mark.parametrize("which", ["mixed", "velocity"])
def test_torch_gather_tables_bitwise(meshes, which):
    sj = SpaceJ.build(meshes[0])
    dofs = sj.cell_dofs if which == "mixed" else asm_j.velocity_cell_dofs(sj)
    tj = asm_j.build_gather_table(dofs, sj.n_dofs)
    tt = asm_t.build_gather_table(dofs, sj.n_dofs)
    assert tj.dtype == tt.dtype and np.array_equal(tj, tt)


def test_torch_gather_apply_matches_jax(meshes):
    """The torch gather-table element apply against the JAX one (f64)."""
    sj = SpaceJ.build(meshes[0])
    gj = asm_j.CellGeometry(sj)
    a_e = asm_j.mass_velocity_element(gj) + asm_j.linear_operator_element(
        gj, np.ones((sj.n_vnodes, 2))[sj.cell_vel_nodes], 0.01
    )
    table = asm_j.build_gather_table(sj.cell_dofs, sj.n_dofs)
    x = np.random.default_rng(5).standard_normal((2, sj.n_dofs))
    yj = np.asarray(asm_j.apply_element_tensors_gather(a_e, sj.cell_dofs, table, x, sj.n_dofs))
    yt = asm_t.apply_element_tensors_gather(
        torch.as_tensor(a_e), torch.as_tensor(sj.cell_dofs).long(),
        torch.as_tensor(table), torch.as_tensor(x),
    ).numpy()
    assert np.abs(yt - yj).max() <= 1e-13 * np.abs(yj).max()


@pytest.mark.parametrize("order", [1, 2, "cn"])
def test_torch_transient_lhs_and_bc_elimination_bitwise(solvers, order):
    fj, ft = solvers
    u0 = np.random.default_rng(6).standard_normal((fj.space.n_vnodes, 2))
    n = fj.space.n_dofs
    aj = asm_j.to_scipy_csr(fj.forms.transient_lhs(order, u0), fj.space.cell_dofs, n)
    at = asm_t.to_scipy_csr(ft.forms.transient_lhs(order, u0), ft.space.cell_dofs, n)
    assert _csr_equal(aj, at)
    bj, bt = fj._bcset_perturbation(), ft._bcset_perturbation()
    for key in ("dofs", "values", "profiles", "free_mask"):
        assert np.array_equal(getattr(bj, key), getattr(bt, key)), key
    a_bc_j, lift_j = bj.eliminate_csr(aj)
    a_bc_t, lift_t = bt.eliminate_csr(at)
    assert _csr_equal(a_bc_j, a_bc_t)
    assert np.array_equal(lift_j, lift_t)
    assert fj.forms.rhs_coefficients(order) == ft.forms.rhs_coefficients(order)


def test_torch_sensor_and_force_rows(solvers):
    """Sensor C rows and lift/drag rows. Point location may differ in the
    last bits (the reference locates points with a C helper, the port with
    its numpy path), so the rows agree to round-off, not bitwise."""
    fj, ft = solvers
    for sj, st in zip(fj.params_control.sensor_list, ft.params_control.sensor_list):
        assert np.abs(sj.row - st.row).max() <= 1e-14
    assert np.array_equal(fj._force_rows(), ft._force_rows())


def test_torch_default_mesh_matches_reference():
    """The port generates the default 56,383-dof mesh in memory, bit for
    bit the mesh the reference's generator gives for its default."""
    from flowcontrol_tpu_torch.models.cylinder import default_cylinder_mesh

    mj = cylinder_mesh_j(yinf=10.0)
    mt = default_cylinder_mesh()
    assert np.array_equal(mt.cells, mj.cells)
    assert np.array_equal(mt.coords, mj.coords)
    assert mt.num_cells == 12_274 and SpaceT.build(mt).n_dofs == 56_383


def test_torch_mesh_matches_committed_file():
    """The port's generator rebuilds the reference's committed mesh file
    (the graded bench mesh, ``bench.py`` MESH_KWARGS) exactly."""
    from flowcontrol_tpu.mesh.io import read_xdmf_mesh

    committed = read_xdmf_mesh(
        REPO / "flowcontrol_tpu" / "models" / "_meshes" / "cylinder_8586114762.xdmf"
    )
    mt = cylinder_mesh_t(yinf=10.0, n1=4.5, n2=2.2, n3=0.8, segments=100)
    assert np.array_equal(mt.cells, committed.cells)
    assert np.array_equal(mt.coords, committed.coords)


def test_torch_import_leaves_jax_out():
    """Every module of the port (found by walking the package) and
    ``chip_smoke`` import neither JAX nor the JAX package."""
    code = (
        "import importlib, pkgutil, sys\n"
        "import flowcontrol_tpu_torch\n"
        "names = [m.name for m in pkgutil.walk_packages(flowcontrol_tpu_torch.__path__,\n"
        "                                               'flowcontrol_tpu_torch.')]\n"
        "for name in names:\n"
        "    importlib.import_module(name)\n"
        "import chip_smoke\n"
        "assert {'flowcontrol_tpu_torch.solvers.krylov',\n"
        "        'flowcontrol_tpu_torch.solvers.factor_cache',\n"
        "        'flowcontrol_tpu_torch.examples.synthesize_controller',\n"
        "        'flowcontrol_tpu_torch.examples.run_cavity_feedback',\n"
        "        'flowcontrol_tpu_torch.tools',\n"
        "        'flowcontrol_tpu_torch.tools.cavity_feedback_synth',\n"
        "        'flowcontrol_tpu_torch.tools.pinball_mimo_synth',\n"
        "        'flowcontrol_tpu_torch.tools.pinball_design_search',\n"
        "        'flowcontrol_tpu_torch.tools.bifurcation_sweep',\n"
        "        'flowcontrol_tpu_torch.tools.lidcavity_hopf_sweep',\n"
        "        'flowcontrol_tpu_torch.examples.run_pinball_feedback'} <= set(names), names\n"
        "assert len(names) >= 70, len(names)\n"
        "bad = sorted(m for m in sys.modules if m == 'jax' or m.startswith('jax.')\n"
        "             or m == 'flowcontrol_tpu' or m.startswith('flowcontrol_tpu.'))\n"
        "assert not bad, bad\n"
    )
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr
