"""The port's operators (A, E, B, C), steady residual and physics helpers
against the JAX package's, on the CPU in float64.

Both packages build the small cylinder mesh (2,575 dofs), and both take one
base flow made from a seed (a uniform stream plus noise): the operators'
parity does not need a converged base flow. The JAX solver's ``UP0`` goes to
the port through ``_assign_steady_state``. A (manual and autodiff), E, B and
C agree with the JAX package's to 1e-10 relative, the port's autodiff A
(``torch.func.jacfwd`` inside ``vmap``) with its manual A to 1e-10, and the
steady residual and the physics helpers to 1e-10. The oracle cases of
``tests/integration/test_operatorgetter.py`` (the finite-difference
Jacobian, E velocity-only, B's lifting, C against the sensors) and of
``tests/test_components.py`` (divergence, vorticity) are held on the port.
"""

import numpy as np
import pytest
import torch

import flowcontrol_tpu.utils.physics as physics_j
import flowcontrol_tpu_torch.utils.physics as physics_t
from flowcontrol_tpu.core.operatorgetter import OperatorGetter as OperatorGetterJ
from flowcontrol_tpu.fem.assembly import steady_residual as steady_residual_j
from flowcontrol_tpu.mesh.generation import cylinder_mesh as cylinder_mesh_j
from flowcontrol_tpu.models.cylinder import CylinderFlowSolver as CylJ
from flowcontrol_tpu_torch.core.operatorgetter import OperatorGetter as OperatorGetterT
from flowcontrol_tpu_torch.fem.assembly import CellGeometry, steady_residual
from flowcontrol_tpu_torch.fem.bc import BCSet
from flowcontrol_tpu_torch.fem.projection import project_velocity
from flowcontrol_tpu_torch.mesh.dofmap import TaylorHoodSpace
from flowcontrol_tpu_torch.mesh.generation import cylinder_mesh as cylinder_mesh_t
from flowcontrol_tpu_torch.mesh.generation import unit_square_mesh
from flowcontrol_tpu_torch.models.cylinder import CylinderFlowSolver as CylT

torch.set_num_threads(1)

SMALL = dict(yinf=3.0, xinf=8.0, xinfa=-3.0, n1=2.0, n2=1.0, n3=0.5, segments=40)
TOL = 1e-10


def _rel(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return np.abs(a - b).max() / max(np.abs(b).max(), 1e-300)


def _sparse_rel(a, b):
    return abs(a - b).max() / abs(b).max()


@pytest.fixture(scope="module")
def solvers(tmp_path_factory):
    fj = CylJ.make_default(Re=100, num_steps=1, verbose=0, mesh=cylinder_mesh_j(**SMALL),
                           path_out=tmp_path_factory.mktemp("j"), solver_backend="host_lu",
                           precision="f64")
    rng = np.random.default_rng(0)
    u0 = np.zeros((fj.space.n_vnodes, 2))
    u0[:, 0] = 1.0
    u0 += 0.1 * rng.standard_normal(u0.shape)
    fj._assign_steady_state(u0, 0.1 * rng.standard_normal(fj.space.n_pressure_dofs))
    ft = CylT.make_default(Re=100, num_steps=1, verbose=0, mesh=cylinder_mesh_t(**SMALL),
                           path_out=tmp_path_factory.mktemp("t"), solver_backend="host_lu",
                           precision="f64", device="cpu")
    ft._assign_steady_state(fj.fields.U0, fj.fields.P0)
    return fj, ft


@pytest.fixture(scope="module")
def operators(solvers):
    fj, ft = solvers
    oj, ot = OperatorGetterJ(fj), OperatorGetterT(ft)
    return {
        "j": dict(zip("AEBC", oj.get_all(autodiff=False)), A_ad=oj.get_A(autodiff=True)),
        "t": dict(zip("AEBC", ot.get_all(autodiff=False)), A_ad=ot.get_A(autodiff=True)),
    }


@pytest.mark.parametrize("which", ["A", "A_ad", "E"])
def test_torch_operators_square_match_jax(operators, which):
    got, ref = operators["t"][which], operators["j"][which]
    assert got.shape == ref.shape and got.format == "csr"
    assert _sparse_rel(got, ref) <= TOL


def test_torch_operators_autodiff_matches_manual(operators):
    """(ref: test_operatorgetter.py:89-103 — rel err < 1e-10)"""
    assert _sparse_rel(operators["t"]["A_ad"], operators["t"]["A"]) <= TOL


@pytest.mark.parametrize("which", ["B", "C"])
def test_torch_operators_b_c_match_jax(operators, which):
    got, ref = operators["t"][which], operators["j"][which]
    assert got.shape == ref.shape
    assert _rel(got, ref) <= TOL


@pytest.mark.parametrize("forced", [False, True])
def test_torch_steady_residual_matches_jax(solvers, forced):
    fj, ft = solvers
    rng = np.random.default_rng(1)
    up = ft.fields.UP0 + 0.01 * rng.standard_normal(ft.space.n_dofs)
    f = rng.standard_normal((ft.space.n_vnodes, 2)) if forced else None
    got = steady_residual(ft.geom, ft.space, torch.as_tensor(up), 0.01, f_nodes=f)
    assert got.dtype == torch.float64
    ref = steady_residual_j(fj.geom, fj.space, up, 0.01, f_nodes=f)
    assert _rel(got.numpy(), np.asarray(ref)) <= TOL


def test_torch_operators_fd_jacobian(solvers, operators):
    """A matches the finite-difference Jacobian of the (negated) residual on
    random directions (ref: test_operatorgetter.py:106-130)."""
    _, fs = solvers
    a = operators["t"]["A"]
    up0 = fs.fields.UP0
    inv_re = 1.0 / fs.params_flow.Re
    free = np.ones(fs.space.n_dofs, dtype=bool)
    free[BCSet(fs.bc.bcu, fs.space.n_dofs).dofs] = False
    r0 = steady_residual(fs.geom, fs.space, up0, inv_re).numpy()
    rng = np.random.default_rng(0)
    eps = 1e-6
    for _ in range(3):
        d = rng.normal(size=fs.space.n_dofs)
        d /= np.linalg.norm(d)
        fd = -(steady_residual(fs.geom, fs.space, up0 + eps * d, inv_re).numpy() - r0) / eps
        an = a @ d
        err = np.abs(fd[free] - an[free]).max() / max(np.abs(an[free]).max(), 1e-12)
        assert err < 1e-4


def test_torch_operators_oracles(solvers, operators):
    """E velocity-only with the domain's area, B's lifting near the
    actuators, C the sensors' rows (ref: test_operatorgetter.py:63-97)."""
    _, fs = solvers
    e, b, c = operators["t"]["E"], operators["t"]["B"], operators["t"]["C"]
    n_vel = fs.space.n_vel_dofs
    assert abs(e[n_vel:, :]).max() == 0.0
    ones = np.zeros(e.shape[0])
    ones[:n_vel] = 1.0
    assert np.isclose(ones @ (e @ ones), 2 * fs.mesh.cell_areas().sum())
    assert b.shape == (fs.space.n_dofs, 2) and np.abs(b).max() > 0
    col = np.abs(b[:n_vel, 0]).reshape(-1, 2).sum(1)
    far = np.linalg.norm(fs.space.vel_node_coords, axis=1) > 3.0
    assert col[far].max() < 1e-2 * col.max()
    up = np.random.default_rng(1).normal(size=fs.space.n_dofs)
    assert np.allclose(c @ up, fs.make_measurement(up))


def test_torch_flowsolver_analysis_helpers_match_jax(solvers):
    """flush/get_actuators_u_ctrl, get_A's u_ctrl, compute_energy_field and
    get_subdomain as the JAX FlowSolver's."""
    fj, ft = solvers
    for fs in (fj, ft):
        fs.set_actuators_u_ctrl([0.3, -0.2])
    assert ft.get_actuators_u_ctrl() == fj.get_actuators_u_ctrl() == [0.3, -0.2]
    OperatorGetterT(ft).get_A(autodiff=False, u_ctrl=[0.1, 0.4])
    assert ft.get_actuators_u_ctrl() == [0.1, 0.4]
    for fs in (fj, ft):
        fs.flush_actuators_u_ctrl()
    assert ft.get_actuators_u_ctrl() == fj.get_actuators_u_ctrl() == [0.0, 0.0]
    u = np.random.default_rng(2).standard_normal((ft.space.n_vnodes, 2))
    fj.fields.u_, ft.fields.u_ = u, u.copy()
    assert _rel(ft.compute_energy_field(), fj.compute_energy_field()) <= TOL
    mid = ft.mesh.facet_midpoints()
    for name in ft.boundaries:
        assert np.array_equal(ft.get_subdomain(name)(mid), fj.get_subdomain(name)(mid)), name


def test_torch_physics_matches_jax(solvers):
    fj, ft = solvers
    u0, p0 = ft.fields.U0, ft.fields.P0
    pairs = [
        (physics_t.get_div0_u(ft, 1.0, 0.2, 0.4), physics_j.get_div0_u(fj, 1.0, 0.2, 0.4)),
        (physics_t.get_div0_u_random(ft, sigma=0.2, seed=3),
         physics_j.get_div0_u_random(fj, sigma=0.2, seed=3)),
        (physics_t.compute_vorticity(ft, u0), physics_j.compute_vorticity(fj, u0)),
        (physics_t.compute_divergence(ft, u0), physics_j.compute_divergence(fj, u0)),
        (physics_t.stress_tensor_field(ft, u0, p0, 0.01),
         physics_j.stress_tensor_field(fj, u0, p0, 0.01)),
    ]
    for k, (got, ref) in enumerate(pairs):
        assert got.shape == np.shape(ref) and _rel(got, ref) <= TOL, k


class _MockFS:
    def __init__(self, space):
        self.space = space
        self.geom = CellGeometry(space)


def test_torch_physics_oracles():
    """The div-free perturbation's weak divergence is small and a rigid
    rotation's vorticity is 2 (ref: tests/test_components.py:218-237)."""
    fs = _MockFS(TaylorHoodSpace.build(unit_square_mesh(8, 8)))
    u = project_velocity(fs.geom, fs.space, physics_t.get_div0_u_callable(0.5, 0.5, 0.25))
    assert np.abs(physics_t.compute_divergence(fs, u)).max() < 0.05 * np.abs(u).max()
    fs = _MockFS(TaylorHoodSpace.build(unit_square_mesh(4, 4)))
    u = fs.space.interpolate_velocity(
        lambda x: np.stack([-(x[:, 1] - 0.5), x[:, 0] - 0.5], axis=1)
    )
    assert np.allclose(physics_t.compute_vorticity(fs, u), 2.0, atol=1e-10)
