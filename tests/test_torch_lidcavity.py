"""The port's lid-driven cavity (Re=8000 by default) against the JAX package.

- ``lidcavity_mesh`` is bitwise the JAX package's (n = 8, uniform and with
  ``stretch=2.0``), and ``mesh_quality`` gives the same numbers.
- ``LidCavityFlowSolver`` of both packages on the n = 8 mesh (1,235 dofs):
  the same facets on the four walls, the same perturbation and full-field
  Dirichlet dofs and values; the flow is enclosed, so both pin the first
  pressure dof (``2 * n_vnodes``).
- Picard (5) then Newton (15) at Re=1000 from rest, host LU in float64:
  base flows within 1e-10.
- Five float64 steps with the lid moved (u = 0.05) from one shared base
  field: y and the state within 1e-10.
- The multifrontal solve (``force_substructure``) on the cavity's BDF2
  matrix at n = 16 (4,771 dofs, so that the dissection recurses), pressure
  pin eliminated: the port's f64 factor solved by F's plain
  version and by the per-stage sweep within 1e-12 of the JAX package's
  ``multifrontal_solve`` on that factor (building F's stage descriptors
  checks every stage's inbox segments against ``MAX_SEGS``).
- The committed Re=8000 base flow belongs to the generated default mesh
  (``lidcavity_mesh(64)``, 74,371 dofs): its checksum and shapes match.

Both packages always get ``mesh=``, so neither builds its default mesh.
"""

import numpy as np
import pytest
import torch

from flowcontrol_tpu.mesh.generation import lidcavity_mesh as lidcavity_mesh_j
from flowcontrol_tpu.mesh.generation import mesh_quality as mesh_quality_j
from flowcontrol_tpu.models.lidcavity import LidCavityFlowSolver as LidJ
from flowcontrol_tpu_torch.core.sensor import sensor_matrix
from flowcontrol_tpu_torch.fem.bc import BCSet
from flowcontrol_tpu_torch.mesh.dofmap import TaylorHoodSpace
from flowcontrol_tpu_torch.mesh.generation import lidcavity_mesh as lidcavity_mesh_t
from flowcontrol_tpu_torch.mesh.generation import mesh_quality as mesh_quality_t
from flowcontrol_tpu_torch.models.baseflows import BASEFLOW_DIR, mesh_checksum
from flowcontrol_tpu_torch.models.lidcavity import LidCavityFlowSolver as LidT
from test_torch_mf_fused import _jax_tree

torch.set_num_threads(1)

N_SMALL = 8
RE = 1000
LID_U = 0.05
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
    return cls.make_default(Re=RE, num_steps=5, mesh=mesh, path_out=path_out,
                            solver_backend=kw.pop("solver_backend", "host_lu"),
                            precision="f64", **kw)


@pytest.fixture(scope="module")
def pair(tmp_path_factory):
    fj = _make(LidJ, lidcavity_mesh_j(N_SMALL), tmp_path_factory.mktemp("j"))
    ft = _make(LidT, lidcavity_mesh_t(N_SMALL), tmp_path_factory.mktemp("t"), device="cpu")
    return fj, ft


@pytest.mark.parametrize("stretch", [0.0, 2.0])
def test_torch_lidcavity_mesh_bitwise(stretch):
    mj, mt = lidcavity_mesh_j(N_SMALL, stretch=stretch), lidcavity_mesh_t(N_SMALL, stretch=stretch)
    assert mt.coords.dtype == mj.coords.dtype and np.array_equal(mt.coords, mj.coords)
    assert np.array_equal(mt.cells, mj.cells)
    assert mesh_quality_t(mt) == mesh_quality_j(mj)
    assert TaylorHoodSpace.build(mt).n_dofs == 1235


def test_torch_lidcavity_boundaries_bcs_and_pin_match_jax(pair):
    fj, ft = pair
    assert ft.space.n_dofs == fj.space.n_dofs == 1235
    assert list(ft.boundaries) == list(fj.boundaries) == ["lid", "leftwall", "rightwall",
                                                          "bottomwall"]
    for name in fj.boundaries:
        assert np.array_equal(ft.markers.facets(name), fj.markers.facets(name)), name
        assert len(ft.markers.facets(name)) == N_SMALL, name
    bj, bt = fj._bcset_perturbation(), ft._bcset_perturbation()
    assert np.array_equal(bt.dofs, bj.dofs) and np.array_equal(bt.values, bj.values)
    # enclosed: every boundary velocity dof is constrained, the pressure pinned
    pin = 2 * ft.space.n_vnodes
    assert pin in bt.dofs and pin in bj.dofs
    fullj = BCSet(fj._make_BCs().bcu, fj.space.n_dofs)
    fullt = BCSet(ft._make_BCs().bcu, ft.space.n_dofs)
    assert np.array_equal(fullt.dofs, fullj.dofs) and np.array_equal(fullt.values, fullj.values)
    assert ft._pin_pressure_needed(fullt) and fj._pin_pressure_needed(fullj)
    # the perturbation lid is the actuator (the walls win at its corners)
    assert np.array_equal(bt.profiles, np.asarray(bj.profiles))
    assert bt.n_actuators == 1 and bt.profiles.max() == 1.0
    c_j = np.stack([np.asarray(s.row) for s in fj.params_control.sensor_list])
    assert _rel(sensor_matrix(ft.params_control.sensor_list, ft.space.n_dofs), c_j) <= TOL


@pytest.fixture(scope="module")
def base(pair):
    """Both packages' base flows after Picard (5) from rest and Newton (15):
    {stage: [(U0, P0, E0) of JAX, of the port]}."""
    out = {}
    for stage, kw in (("picard", dict(method="picard", max_iter=5)),
                      ("newton", dict(method="newton", max_iter=15))):
        out[stage] = []
        for fs in pair:
            if stage == "newton":
                kw["initial_guess"] = fs.fields.UP0
            fs.compute_steady_state(u_ctrl=[0.0], **kw)
            out[stage].append((fs.fields.U0.copy(), fs.fields.P0.copy(), fs.E0))
    return out


@pytest.mark.parametrize("stage", ["picard", "newton"])
def test_torch_lidcavity_picard_newton_match_jax(base, stage):
    (uj, pj, ej), (ut, pt, et) = base[stage]
    assert _rel(ut, uj) <= TOL
    assert _rel(pt, pj) <= TOL
    assert abs(et - ej) <= TOL * ej
    assert np.abs(ut).max() >= 1.0  # the lid moves at uinf


def test_torch_lidcavity_lid_actuated_steps_match_jax(base, tmp_path):
    u0, p0, _ = base["newton"][0]  # one shared base field: JAX's
    runs = []
    for cls, mesh, kw in ((LidJ, lidcavity_mesh_j(N_SMALL), {}),
                          (LidT, lidcavity_mesh_t(N_SMALL), {"device": "cpu"})):
        fs = _make(cls, mesh, tmp_path / cls.__module__, **kw)
        fs._assign_steady_state(u0, p0)
        fs.initialize_time_stepping()
        ys, states = [], []
        for _ in range(5):
            ys.append(fs.step(np.array([LID_U])))
            states.append(np.asarray(fs.fields.up_, dtype=np.float64).copy())
        runs.append((fs, np.asarray(ys), np.asarray(states)))
    (_, yj, xj), (ft, yt, xt) = runs
    assert yt.shape == (5, 2) and np.isfinite(yt).all()
    assert _rel(yt, yj) <= TOL
    assert _rel(xt, xj) <= TOL
    # the perturbation lid moves at the control (the walls hold its
    # corners), the pinned pressure stays 0
    lid = ft.space.boundary_vel_nodes(ft.markers.facets("lid"))
    x_lid = ft.space.vel_node_coords[lid, 0]
    inner = lid[(x_lid > 0) & (x_lid < 1)]
    assert np.array_equal(ft.fields.u_[inner], np.tile([LID_U, 0.0], (len(inner), 1)))
    assert xt[:, 2 * ft.space.n_vnodes].tolist() == [0.0] * 5
    assert ft.compute_perturbation_energy() > 0


def test_torch_lidcavity_multifrontal_solve_matches_jax(tmp_path, monkeypatch):
    """The Stepper's multifrontal factor (``force_substructure``, f64 on the
    CPU) of the BDF2 matrix with the pressure pin eliminated, on the n = 16
    mesh (4,771 dofs: the dissection recurses) around a solid-body vortex:
    F's plain version and the per-stage sweep against the JAX package's
    solve on that factor. The first step borrows the BDF2 factor, as it
    does at the default mesh."""
    import jax.numpy as jnp

    from flowcontrol_tpu.solvers import multifrontal as mfj
    from flowcontrol_tpu_torch.core.stepper import Stepper
    from flowcontrol_tpu_torch.ops import mf_fused
    from flowcontrol_tpu_torch.solvers import multifrontal as mft

    monkeypatch.setattr(Stepper, "DENSE_TWO_FACTOR_MAX_N", 1000)
    fs = _make(LidT, lidcavity_mesh_t(16), tmp_path, device="cpu",
               solver_backend="dense_lu", stepper_options={"force_substructure": True})
    xy = fs.space.vel_node_coords
    fs._assign_steady_state(np.stack([xy[:, 1] - 0.5, 0.5 - xy[:, 0]], axis=1),
                            np.zeros(fs.space.n_pressure_dofs))
    fs.initialize_time_stepping()
    st = fs.stepper
    mf = st._solvers[st._order_idx[2]]
    assert st._solver_kinds == ["borrowed", "multifrontal"]
    assert isinstance(mf, mft.MultifrontalLU) and mf.desc.shape[0] == len(mf.stages) > 1
    assert sum(len(s.inbox) for s in mf.stages) >= 1  # an inbox segment to gather
    assert 2 * fs.space.n_vnodes in st.bcs.dofs
    b = np.random.default_rng(3).standard_normal((2, mf.n))
    dev, static = _jax_tree(mf)
    ref = np.asarray(mfj.multifrontal_solve(dev, jnp.asarray(b), **static))
    for got in (mf_fused.multifrontal_solve_fused_plain(mf, torch.as_tensor(b)),
                mft.multifrontal_solve(mf, torch.as_tensor(b))):
        assert np.abs(got.numpy() - ref).max() <= 1e-12 * np.abs(ref).max()


def test_torch_lidcavity_committed_baseflow_matches_default_mesh():
    """The committed Re=8000 file was computed on the generated default mesh."""
    mesh = lidcavity_mesh_t(64)
    space = TaylorHoodSpace.build(mesh)
    assert space.n_dofs == 74_371
    with np.load(BASEFLOW_DIR / "lidcavity_re8000_n74371.npz", allow_pickle=False) as d:
        assert str(d["mesh_sha256"]) == mesh_checksum(mesh)
        assert d["U0"].shape == (space.n_vnodes, 2)
        assert d["P0"].shape == (space.n_pressure_dofs,)
        assert np.isfinite(d["U0"]).all() and np.abs(d["U0"]).max() >= 1.0
