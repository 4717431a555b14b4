"""The port's open cavity (Re=7500) against the JAX package.

- The generated cavity mesh is bitwise the JAX package's, at the
  integration tests' coarse parameters (12, 25, 50) and at a smaller mesh.
- ``CavityFlowSolver`` of both packages on the small mesh: the same facets
  on each of the ten boundaries, the same perturbation and full-field
  Dirichlet dofs and values (single-component slip walls included), the
  same force-actuator column and sensor rows.
- One Picard and then one Newton iteration from the default (channel /
  cavity split) guess, host LU in float64: base flows within 1e-10.
- Five float64 steps with the Gaussian force actuator at u = 0.5 from one
  shared base field: y and the state within 1e-10.

Both packages always get ``mesh=``, so neither builds its default mesh.
"""

import numpy as np
import pytest
import torch

from flowcontrol_tpu.mesh.generation import cavity_mesh as cavity_mesh_j
from flowcontrol_tpu.models.cavity import CavityFlowSolver as CavJ
from flowcontrol_tpu_torch.core.sensor import sensor_matrix
from flowcontrol_tpu_torch.fem.bc import BCSet
from flowcontrol_tpu_torch.mesh.generation import cavity_mesh as cavity_mesh_t
from flowcontrol_tpu_torch.models.cavity import CavityFlowSolver as CavT
from flowcontrol_tpu_torch.models.baseflows import committed_baseflow, mesh_checksum

torch.set_num_threads(1)

SMALL = dict(n_coarse=6, n_mid=12, n_fine=25)
TOL = 1e-10


@pytest.fixture(scope="module", autouse=True)
def _factor_cache_off():
    """The port's multifrontal factors here are built cold and stored
    nowhere: the factor cache is off for the module (its own tests are in
    tests/test_torch_factor_cache.py)."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("FLOWCONTROL_TPU_FACTOR_CACHE", "off")
        yield


def _rel(a, b):
    a, b = np.asarray(a, dtype=np.float64), np.asarray(b, dtype=np.float64)
    return np.abs(a - b).max() / max(np.abs(b).max(), 1e-300)


def _make(cls, mesh, path_out, **kw):
    return cls.make_default(Re=7500, num_steps=5, mesh=mesh, path_out=path_out,
                            solver_backend="host_lu", precision="f64", **kw)


@pytest.fixture(scope="module")
def pair(tmp_path_factory):
    fj = _make(CavJ, cavity_mesh_j(**SMALL), tmp_path_factory.mktemp("j"))
    ft = _make(CavT, cavity_mesh_t(**SMALL), tmp_path_factory.mktemp("t"), device="cpu")
    return fj, ft


@pytest.mark.parametrize("params", [dict(n_coarse=12, n_mid=25, n_fine=50), SMALL])
def test_torch_cavity_mesh_bitwise(params):
    mj, mt = cavity_mesh_j(**params), cavity_mesh_t(**params)
    assert mt.coords.dtype == mj.coords.dtype and np.array_equal(mt.coords, mj.coords)
    assert np.array_equal(mt.cells, mj.cells)


def test_torch_cavity_boundaries_and_bcs_match_jax(pair):
    fj, ft = pair
    assert ft.space.n_dofs == fj.space.n_dofs
    assert list(ft.boundaries) == list(fj.boundaries)
    for name in fj.boundaries:
        assert np.array_equal(ft.markers.facets(name), fj.markers.facets(name)), name
        assert len(ft.markers.facets(name)) > 0, name
    bj, bt = fj._bcset_perturbation(), ft._bcset_perturbation()
    assert np.array_equal(bt.dofs, bj.dofs) and np.array_equal(bt.values, bj.values)
    # the slip walls constrain the normal (y) component only
    for name in ("upper_wall", "lower_wall_left_sf", "lower_wall_right_sf"):
        bc = ft.dirichlet_bc(name, value=0.0, component=1)
        assert (bc.dofs % 2 == 1).all() and len(bc.dofs) > 0
    fullj = BCSet(fj._make_BCs().bcu, fj.space.n_dofs)
    fullt = BCSet(ft._make_BCs().bcu, ft.space.n_dofs)
    assert np.array_equal(fullt.dofs, fullj.dofs) and np.array_equal(fullt.values, fullj.values)
    assert _rel(ft._force_cols, np.asarray(fj._force_cols)) <= TOL
    c_j = np.stack([np.asarray(s.row) for s in fj.params_control.sensor_list])
    assert _rel(sensor_matrix(ft.params_control.sensor_list, ft.space.n_dofs), c_j) <= TOL


@pytest.fixture(scope="module")
def base(pair):
    """Both packages' base flows after one Picard and after one Newton
    iteration: {stage: [(U0, P0, E0) of JAX, of the port]}."""
    out = {}
    for stage, kw in (("picard", dict(method="picard", max_iter=1, tol=1e-7)),
                      ("newton", dict(method="newton", max_iter=1))):
        out[stage] = []
        for fs in pair:
            if stage == "newton":
                kw["initial_guess"] = fs.fields.UP0
            fs.compute_steady_state(u_ctrl=[0.0], **kw)
            out[stage].append((fs.fields.U0.copy(), fs.fields.P0.copy(), fs.E0))
    return out


@pytest.mark.parametrize("stage", ["picard", "newton"])
def test_torch_cavity_picard_newton_match_jax(base, stage):
    (uj, pj, ej), (ut, pt, et) = base[stage]
    assert _rel(ut, uj) <= TOL
    assert _rel(pt, pj) <= TOL
    assert abs(et - ej) <= TOL * ej


def test_torch_cavity_force_actuator_steps_match_jax(base, tmp_path):
    u0, p0, _ = base["newton"][0]  # one shared base field: JAX's
    runs = []
    for cls, mesh, kw in ((CavJ, cavity_mesh_j(**SMALL), {}),
                          (CavT, cavity_mesh_t(**SMALL), {"device": "cpu"})):
        fs = _make(cls, mesh, tmp_path / cls.__module__, **kw)
        fs._assign_steady_state(u0, p0)
        fs.initialize_time_stepping()
        ys, states = [], []
        for _ in range(5):
            ys.append(fs.step(np.array([0.5])))
            states.append(np.asarray(fs.fields.up_, dtype=np.float64).copy())
        runs.append((fs, np.asarray(ys), np.asarray(states)))
    (_, yj, xj), (st, yt, xt) = runs
    assert yt.shape == (5, 2) and np.isfinite(yt).all()
    assert _rel(yt, yj) <= TOL
    # the states of the 5 steps, relative to the trajectory's largest value:
    # the impulsive force start makes the first steps' pressure ~1e3 times
    # the later steps', and its round-off is carried at that scale
    assert _rel(xt, xj) <= TOL
    assert st.compute_perturbation_energy() > 0


def test_torch_cavity_committed_baseflow_needs_matching_mesh(pair, tmp_path, monkeypatch):
    """A committed base flow is handed out only for the mesh it was computed
    on: the file's checksum must equal the mesh's."""
    import flowcontrol_tpu_torch.models.baseflows as baseflows

    _, ft = pair
    monkeypatch.setattr(baseflows, "BASEFLOW_DIR", tmp_path)
    assert committed_baseflow(ft) is None
    path = tmp_path / f"cavity_re7500_n{ft.space.n_dofs}.npz"
    np.savez_compressed(path, U0=np.zeros((ft.space.n_vnodes, 2)),
                        P0=np.zeros(ft.space.n_pressure_dofs),
                        mesh_sha256=np.asarray(mesh_checksum(ft.mesh)))
    assert committed_baseflow(ft) == path
    np.savez_compressed(path, U0=np.zeros(1), P0=np.zeros(1),
                        mesh_sha256=np.asarray(mesh_checksum(cavity_mesh_t(n_coarse=5))))
    assert committed_baseflow(ft) is None


def test_torch_cavity_f32_refinement_residual_in_f64(tmp_path):
    """The refinement sweep of an f32 multifrontal factor takes its residual
    in f64. On the Re=7500 cavity's BDF2 matrix an f32 residual leaves the
    solve at ~1e-4 relative (cond(A)·eps_f32, worst in the pressure; the
    card's 120k-dof cavity missed the 5e-4 field error through it), while
    one f64-residual sweep reaches ~1e-8."""
    import scipy.sparse.linalg as spla

    from flowcontrol_tpu_torch.fem.assembly import to_scipy_csr

    fs = CavT.make_default(mesh=cavity_mesh_t(n_coarse=4, n_mid=8, n_fine=16), device="cpu",
                           precision="f32", solver_backend="dense_lu", path_out=tmp_path,
                           stepper_options={"force_substructure": True})
    u0 = fs._default_steady_state_initial_guess()
    fs._assign_steady_state(u0, np.zeros(fs.space.n_pressure_dofs))
    fs.initialize_time_stepping()
    st = fs.stepper
    oi = st._order_idx[2]
    assert st._refine[oi] == 1 and st._dev["a_refine"][oi].dtype == torch.float64
    a_bc, _ = fs._bcset_perturbation().eliminate_csr(
        to_scipy_csr(fs.forms.transient_lhs(2, u0), fs.space.cell_dofs, fs.space.n_dofs))
    b = (a_bc @ np.random.default_rng(0).standard_normal(fs.space.n_dofs)).astype(np.float32)
    ref = spla.splu(a_bc.tocsc()).solve(b.astype(np.float64))
    rhs = torch.as_tensor(b)

    def err(x):
        return np.linalg.norm(x.double().numpy() - ref) / np.linalg.norm(ref)

    x0 = st._solve_once(oi, rhs)
    x1 = st._solve(2, rhs)
    assert x1.dtype == torch.float32
    assert err(x0) > 1e-5  # the f32 factor alone
    assert err(x1) <= 1e-6  # one sweep with an f64 residual
