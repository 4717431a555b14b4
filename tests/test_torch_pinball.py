"""The port's fluidic pinball (Re=100 by default) against the JAX package.

- ``pinball_mesh`` is bitwise the JAX package's at a small size (664
  vertices, 5,734 dofs), and ``mesh_quality`` gives the same numbers.
- ``PinballFlowSolver`` of both packages on that mesh, in both actuation
  modes (ROTATION: 6 boundaries; SUCTION: 9, parabolic slots): the same
  facets on every boundary, the same perturbation and full-field Dirichlet
  dofs, values and actuator profiles, the same sensor rows; the flow is
  open, so no pressure dof is pinned.
- Picard (5) then Newton (15) at Re=30, host LU in float64: base flows and
  each surface's force coefficients within 1e-10.
- The three custom initial guesses are bitwise equal.
- Five float64 steps with the front cylinder rotating (u = [1, 0, 0]), and
  with the three slots blowing (u = [0.5, 0.5, 0.5]), from one shared base
  field: y and the state within 1e-10.
- The MIMO closed loop with the committed LQG compensator
  (``pinball_lqg_re100.mat``: 22 states, 3 x 3, discrete at dt = 0.005,
  u = +K(y)): a B = 2 fused rollout (``feedback_sign=+1``; gains 0.5 and 1
  on the compensator's output) against the JAX Stepper's
  ``rollout_closed_loop`` within 1e-10, and the gain-1 member against the
  lockstep loop ``u = K.step(y, dt); y = fs.step(u)`` of the port's
  ``Controller``.
- The multifrontal solve (``force_substructure``) on the pinball's BDF2
  matrix: the port's f64 factor solved by F's plain version and by the
  per-stage sweep within 1e-12 of the JAX package's ``multifrontal_solve``
  on that factor (building F's stage descriptors checks every stage's
  inbox segments against ``MAX_SEGS``).
- The committed Re=100 base flow belongs to the generated default mesh
  (``pinball_mesh()``, 67,920 dofs): its checksum and shapes match.

Both packages always get ``mesh=``, so neither builds its default mesh.
"""

from pathlib import Path

import numpy as np
import pytest
import torch

from flowcontrol_tpu.core.actuator import CYLINDER_ACTUATION_MODE as MODE_J
from flowcontrol_tpu.mesh.generation import mesh_quality as mesh_quality_j
from flowcontrol_tpu.mesh.generation import pinball_mesh as pinball_mesh_j
from flowcontrol_tpu.models.pinball import PinballFlowSolver as PinJ
from flowcontrol_tpu.models.pinball import pinball_custom_initial_guess as guess_j
from flowcontrol_tpu_torch.core.actuator import CYLINDER_ACTUATION_MODE as MODE_T
from flowcontrol_tpu_torch.core.sensor import sensor_matrix
from flowcontrol_tpu_torch.fem.bc import BCSet
from flowcontrol_tpu_torch.mesh.dofmap import TaylorHoodSpace
from flowcontrol_tpu_torch.mesh.generation import mesh_quality as mesh_quality_t
from flowcontrol_tpu_torch.mesh.generation import pinball_mesh as pinball_mesh_t
from flowcontrol_tpu_torch.models.baseflows import BASEFLOW_DIR, mesh_checksum
from flowcontrol_tpu_torch.models.pinball import PINBALL_LQG_RE100
from flowcontrol_tpu_torch.models.pinball import PinballFlowSolver as PinT
from flowcontrol_tpu_torch.models.pinball import pinball_custom_initial_guess as guess_t
from test_torch_mf_fused import _jax_tree

torch.set_num_threads(1)

SMALL = dict(n1=2.0, n2=1.2, n3=0.5, segments=32, xinf=14.0)
RE = 30
TOL = 1e-10
MODES = {"rotation": (MODE_J.ROTATION, MODE_T.ROTATION),
         "suction": (MODE_J.SUCTION, MODE_T.SUCTION)}
CONTROLS = {"rotation": [1.0, 0.0, 0.0], "suction": [0.5, 0.5, 0.5]}
SURFACES = {"rotation": ["actuator_mid", "actuator_top", "actuator_bot"],
            "suction": ["cylinder_mid", "actuator_mid", "cylinder_top", "actuator_top",
                        "cylinder_bot", "actuator_bot"]}


def _rel(a, b):
    a, b = np.asarray(a, dtype=np.float64), np.asarray(b, dtype=np.float64)
    return np.abs(a - b).max() / max(np.abs(b).max(), 1e-300)


def _make(cls, mode, path_out, num_steps=5, **kw):
    mesh = (pinball_mesh_j if cls is PinJ else pinball_mesh_t)(**SMALL)
    return cls.make_default(Re=RE, num_steps=num_steps, mesh=mesh, path_out=path_out,
                            mode_actuation=MODES[mode][cls is PinT],
                            solver_backend=kw.pop("solver_backend", "host_lu"), precision="f64",
                            **({"device": "cpu"} if cls is PinT else {}), **kw)


@pytest.fixture(scope="module")
def pairs(tmp_path_factory):
    """{mode: (JAX solver, port solver)} on the small mesh, built on use."""
    built = {}

    def get(mode):
        if mode not in built:
            path_out = tmp_path_factory.mktemp(mode)
            built[mode] = tuple(_make(cls, mode, path_out) for cls in (PinJ, PinT))
        return built[mode]

    return get


def test_torch_pinball_mesh_bitwise():
    mj, mt = pinball_mesh_j(**SMALL), pinball_mesh_t(**SMALL)
    assert mt.coords.dtype == mj.coords.dtype and np.array_equal(mt.coords, mj.coords)
    assert np.array_equal(mt.cells, mj.cells)
    assert mesh_quality_t(mt) == mesh_quality_j(mj)
    assert mt.num_vertices == 664 and TaylorHoodSpace.build(mt).n_dofs == 5734


@pytest.mark.parametrize("mode", list(MODES))
def test_torch_pinball_boundaries_and_bcs_match_jax(pairs, mode):
    fj, ft = pairs(mode)
    n_bnd = {"rotation": 6, "suction": 9}[mode]
    assert list(ft.boundaries) == list(fj.boundaries) and len(ft.boundaries) == n_bnd
    for name in fj.boundaries:
        assert np.array_equal(ft.markers.facets(name), fj.markers.facets(name)), name
        assert len(ft.markers.facets(name)) > 0, name
    bj, bt = fj._bcset_perturbation(), ft._bcset_perturbation()
    assert np.array_equal(bt.dofs, bj.dofs) and np.array_equal(bt.values, bj.values)
    assert np.array_equal(bt.profiles, np.asarray(bj.profiles)) and bt.n_actuators == 3
    assert 2 * ft.space.n_vnodes not in bt.dofs  # open flow: no pressure pin
    fullj = BCSet(fj._make_BCs().bcu, fj.space.n_dofs)
    fullt = BCSet(ft._make_BCs().bcu, ft.space.n_dofs)
    assert np.array_equal(fullt.dofs, fullj.dofs) and np.array_equal(fullt.values, fullj.values)
    c_j = np.stack([np.asarray(s.row) for s in fj.params_control.sensor_list])
    assert _rel(sensor_matrix(ft.params_control.sensor_list, ft.space.n_dofs), c_j) <= TOL


@pytest.fixture(scope="module")
def base(pairs):
    """Both packages' rotation-mode base flows after Picard (5) from the
    uniform guess and Newton (15): {stage: [(U0, P0, E0) of JAX, of the
    port]}."""
    out = {}
    for stage, kw in (("picard", dict(method="picard", max_iter=5)),
                      ("newton", dict(method="newton", max_iter=15))):
        out[stage] = []
        for fs in pairs("rotation"):
            if stage == "newton":
                kw["initial_guess"] = fs.fields.UP0
            fs.compute_steady_state(u_ctrl=[0.0] * 3, **kw)
            out[stage].append((fs.fields.U0.copy(), fs.fields.P0.copy(), fs.E0))
    return out


@pytest.mark.parametrize("stage", ["picard", "newton"])
def test_torch_pinball_picard_newton_match_jax(base, stage):
    (uj, pj, ej), (ut, pt, et) = base[stage]
    assert _rel(ut, uj) <= TOL
    assert _rel(pt, pj) <= TOL
    assert abs(et - ej) <= TOL * ej


@pytest.mark.parametrize("mode", list(MODES))
def test_torch_pinball_force_coefficients_match_jax(pairs, base, mode):
    u0, p0, _ = base["newton"][0]
    fj, ft = pairs(mode)
    cj, ct = fj.compute_force_coefficients(u0, p0), ft.compute_force_coefficients(u0, p0)
    assert list(ct) == list(cj) == SURFACES[mode]
    for name in cj:
        assert _rel(ct[name], cj[name]) <= TOL, name
    if mode == "rotation":  # the JAX integration test's physics check
        assert ct["actuator_top"][1] > 0 and ct["actuator_bot"][1] > 0
        assert np.isclose(ct["actuator_top"][0], -ct["actuator_bot"][0], atol=5e-2)


def test_torch_pinball_custom_initial_guess_bitwise(pairs):
    fj, ft = pairs("rotation")
    for mode in ("symmetric", "antisymmetric_top", "antisymmetric_bot"):
        gj, gt = np.asarray(guess_j(fj.space, mode)), guess_t(ft.space, mode)
        assert gt.dtype == gj.dtype and np.array_equal(gt, gj), mode
    with pytest.raises(ValueError):
        guess_t(ft.space, "sideways")


@pytest.mark.parametrize("mode", list(MODES))
def test_torch_pinball_actuated_steps_match_jax(base, tmp_path, mode):
    u0, p0, _ = base["newton"][0]  # one shared base field: JAX's
    runs = []
    for cls in (PinJ, PinT):
        fs = _make(cls, mode, tmp_path / cls.__module__)
        fs._assign_steady_state(u0, p0)
        fs.initialize_time_stepping()
        ys, states = [], []
        for _ in range(5):
            ys.append(fs.step(np.array(CONTROLS[mode])))
            states.append(np.asarray(fs.fields.up_, dtype=np.float64).copy())
        runs.append((fs, np.asarray(ys), np.asarray(states)))
    (_, yj, xj), (ft, yt, xt) = runs
    assert yt.shape == (5, 3) and np.isfinite(yt).all()
    assert _rel(yt, yj) <= TOL
    assert _rel(xt, xj) <= TOL
    if mode == "rotation":  # the front cylinder's surface speed is u·d/2
        nodes = ft.space.boundary_vel_nodes(ft.markers.facets("actuator_mid"))
        assert np.allclose(np.linalg.norm(ft.fields.u_[nodes], axis=1), 0.5, atol=1e-8)


def test_torch_pinball_mimo_closed_loop_matches_jax(base, tmp_path):
    """B = 2 fused closed loop with the committed LQG, u = +K(y)."""
    import jax.numpy as jnp

    import flowcontrol_tpu.models.pinball as pinball_j
    from flowcontrol_tpu.core.controller import Controller as ControllerJ
    from flowcontrol_tpu_torch.core.controller import Controller as ControllerT

    path_j = Path(pinball_j.__file__).parent / "_controllers" / "pinball_lqg_re100.mat"
    assert path_j.read_bytes() == PINBALL_LQG_RE100.read_bytes()  # the port's own copy
    u0, p0, _ = base["newton"][0]
    n_steps, gains = 5, np.array([0.5, 1.0])
    solvers = []
    for cls in (PinJ, PinT):
        fs = _make(cls, "rotation", tmp_path / cls.__module__, num_steps=n_steps)
        fs._assign_steady_state(u0, p0)
        # the example's initial condition where no mode file fits the mesh
        fs.params_ic.xloc, fs.params_ic.yloc = 1.0, 0.0
        fs.params_ic.radius, fs.params_ic.amplitude = 0.6, 0.01
        fs.initialize_time_stepping()
        fs._prepare_systems()
        solvers.append(fs)
    fj, ft = solvers
    dt = ft.params_time.dt
    kt, kj = ControllerT.from_file(PINBALL_LQG_RE100), ControllerJ.from_file(path_j)
    assert kt.native_dt == dt and (kt.nstates, kt.ninputs, kt.noutputs) == (22, 3, 3)

    def k_mats(k):
        ad, bd, cd, dd = k.discrete(dt, dtype=np.float64)
        return (np.stack([ad] * 2), np.stack([bd] * 2), gains[:, None, None] * cd,
                gains[:, None, None] * dd)

    up = np.asarray(fj._carry.u_n) + 1e-3 * np.random.default_rng(5).standard_normal(
        (2, ft.space.n_dofs))
    st, sj = ft.stepper, fj._stepper
    y0 = up @ np.asarray(st.c_rows).T
    carry, (ys, des, us, divs) = st.rollout_closed_loop(st.init_carry(up), k_mats(kt), y0,
                                                        n_steps, feedback_sign=1.0)
    assert us.shape == (n_steps, 2, 3) and not bool(divs.any())
    carry_j, (ys_j, des_j, us_j, _) = sj.rollout_closed_loop(
        sj.init_carry(jnp.asarray(up)), k_mats(kj), y0, n_steps, feedback_sign=1.0)
    assert _rel(ys, ys_j) <= TOL and _rel(us, us_j) <= TOL and _rel(des, des_j) <= TOL
    assert _rel(carry.u_n, carry_j.u_n) <= TOL
    assert float((us[:, 0] - us[:, 1]).abs().max()) > 0  # three controls, two gains
    # the gain-1 member through the normal entry points
    c, y, u_loop = st.init_carry(up[1]), y0[1], []
    for _ in range(n_steps):
        u = kt.step(y, dt)
        c, out = st.step(c, u)
        y = out.y.numpy()
        u_loop.append(u)
    assert _rel(us[:, 1], np.asarray(u_loop)) <= TOL and _rel(c.u_n, carry.u_n[1]) <= TOL


def test_torch_pinball_multifrontal_solve_matches_jax(base, tmp_path, monkeypatch):
    """The Stepper's multifrontal factor (``force_substructure``, f64 on the
    CPU) of the BDF2 matrix around the Re=30 base flow: F's plain version
    and the per-stage sweep against the JAX package's solve on that factor.
    The first step borrows the BDF2 factor, as it does at the default
    mesh."""
    import jax.numpy as jnp

    from flowcontrol_tpu.solvers import multifrontal as mfj
    from flowcontrol_tpu_torch.core.stepper import Stepper
    from flowcontrol_tpu_torch.ops import mf_fused
    from flowcontrol_tpu_torch.solvers import multifrontal as mft

    monkeypatch.setattr(Stepper, "DENSE_TWO_FACTOR_MAX_N", 1000)
    fs = _make(PinT, "rotation", tmp_path, solver_backend="dense_lu",
               stepper_options={"force_substructure": True})
    fs._assign_steady_state(*base["newton"][1][:2])
    fs.initialize_time_stepping()
    st = fs.stepper
    mf = st._solvers[st._order_idx[2]]
    assert st._solver_kinds == ["borrowed", "multifrontal"]
    assert isinstance(mf, mft.MultifrontalLU) and mf.desc.shape[0] == len(mf.stages) > 1
    assert sum(len(s.inbox) for s in mf.stages) >= 1  # an inbox segment to gather
    b = np.random.default_rng(3).standard_normal((2, mf.n))
    dev, static = _jax_tree(mf)
    ref = np.asarray(mfj.multifrontal_solve(dev, jnp.asarray(b), **static))
    for got in (mf_fused.multifrontal_solve_fused_plain(mf, torch.as_tensor(b)),
                mft.multifrontal_solve(mf, torch.as_tensor(b))):
        assert np.abs(got.numpy() - ref).max() <= 1e-12 * np.abs(ref).max()


def test_torch_pinball_committed_baseflow_matches_default_mesh():
    """The committed Re=100 file was computed on the generated default mesh."""
    mesh = pinball_mesh_t()
    space = TaylorHoodSpace.build(mesh)
    assert space.n_dofs == 67_920
    with np.load(BASEFLOW_DIR / "pinball_re100_n67920.npz", allow_pickle=False) as d:
        assert str(d["mesh_sha256"]) == mesh_checksum(mesh)
        assert d["U0"].shape == (space.n_vnodes, 2)
        assert d["P0"].shape == (space.n_pressure_dofs,)
        assert np.isfinite(d["U0"]).all() and np.isfinite(d["P0"]).all()
