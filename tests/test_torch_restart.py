"""Snapshots, the restart sidecar and the restart itself, the port against
the JAX package on the CPU.

The coarse cylinder of the integration tests, host LU in float64, the port
on ``device="cpu"``. Each package computes its base flow with
``save_every > 0`` (so ``compute_steady_state`` writes ``steady/``), reads
it back through ``load_steady_state()``, runs the closed loop of
``tests/integration/test_cylinder.py`` ``test_cylinder_closed_loop_and_restart``
for 10 steps with a checkpoint every 5 (the port reading its mesh from an
``.xdmf`` through ``make_default(meshpath=...)``), and restarts at
T = 0.025 from its JSON sidecar at BDF2, the controller's state restored.
Held to 1e-10 relative: the state at the restart and the restarted y
against the package's own continuous run and against the other package;
the port restarted from the checkpoints and sidecar the JAX package wrote
(``.h5``, through h5py) against the JAX package's own restart; the legacy
``ParamRestart`` path; a CN run and its ``restart_order='cn'`` restart; a
``start_order=2`` Stepper's step, rollouts and its one system against the
JAX package's. Also the exporter's CSV, sidecar and ``adjust_baseflow``
(``tests/test_components.py:172-216``), the steady state's files and its
``mesh_cells`` check, and, on each of the four models at a small mesh,
``meshpath=`` with a checkpoint and a restart.
"""

import json
import shutil

import numpy as np
import pytest
import torch

import flowcontrol_tpu.core.flowsolverparameters as fsp_j
import flowcontrol_tpu_torch.core.flowsolverparameters as fsp_t
from flowcontrol_tpu.core.controller import Controller as ControllerJ
from flowcontrol_tpu.core.exporter import FlowExporter as ExporterJ
from flowcontrol_tpu.core.flowfield import FlowFieldCollection as FieldsJ
from flowcontrol_tpu.core.flowfield import SimPaths as SimPathsJ
from flowcontrol_tpu.mesh.generation import cylinder_mesh as cylinder_mesh_j
from flowcontrol_tpu.models.cylinder import CylinderFlowSolver as CylJ
from flowcontrol_tpu_torch.core.actuator import CYLINDER_ACTUATION_MODE
from flowcontrol_tpu_torch.core.controller import Controller as ControllerT
from flowcontrol_tpu_torch.core.exporter import FlowExporter as ExporterT
from flowcontrol_tpu_torch.core.flowfield import FlowFieldCollection as FieldsT
from flowcontrol_tpu_torch.core.flowfield import SimPaths as SimPathsT
from flowcontrol_tpu_torch.core.stepper import Stepper, carry_to_numpy
from flowcontrol_tpu_torch.mesh.dofmap import TaylorHoodSpace
from flowcontrol_tpu_torch.mesh.generation import (
    cavity_mesh,
    cylinder_mesh,
    lidcavity_mesh,
    pinball_mesh,
    unit_square_mesh,
)
from flowcontrol_tpu_torch.mesh.io import read_field_snapshot, write_xdmf_mesh
from flowcontrol_tpu_torch.models.cavity import CavityFlowSolver
from flowcontrol_tpu_torch.models.cylinder import CylinderFlowSolver as CylT
from flowcontrol_tpu_torch.models.lidcavity import LidCavityFlowSolver
from flowcontrol_tpu_torch.models.pinball import PinballFlowSolver

torch.set_num_threads(1)

COARSE = dict(yinf=5.0, xinf=15.0, xinfa=-5.0, n1=4.0, n2=2.0, n3=0.8, segments=80)
TOL = 1e-10
DT = 0.005
T_RESTART = 0.025
# the oracle's small stable controller (tests/integration/test_cylinder.py:106)
K_MATS = dict(A=np.array([[-2.0, 1.0], [0.0, -3.0]]), B=np.array([[0.5], [1.0]]),
              C=np.array([[0.2, 0.1]]), D=np.zeros((1, 1)))
CARRY_FIELDS = ("u_n", "u_nn", "mu_n", "mu_nn", "n_prev", "u_ctrl_prev")


def _rel(a, b):
    a, b = np.asarray(a, dtype=np.float64), np.asarray(b, dtype=np.float64)
    return np.abs(a - b).max() / max(np.abs(b).max(), 1e-300)


class Side:
    """One package's classes and options."""

    def __init__(self, name):
        self.jax = name == "jax"
        self.cls = CylJ if self.jax else CylT
        self.controller = ControllerJ if self.jax else ControllerT
        self.fsp = fsp_j if self.jax else fsp_t

    def make(self, mesh, path_out, **kw):
        where = {"mesh": mesh} if self.jax else {"meshpath": mesh, "device": "cpu"}
        return self.cls.make_default(Re=100, verbose=0, path_out=path_out,
                                     solver_backend="host_lu", precision="f64", **where, **kw)


def _closed_loop(fs, k, y, n, snap_at=None):
    """n steps of u = K(-y[0]) on both actuators: y of each step, and the
    state and the controller's state after step ``snap_at``."""
    ys, snap = [], None
    for i in range(n):
        u = k.step(-y[0], DT)
        y = fs.step(np.array([u[0], u[0]]))
        ys.append(y)
        if i + 1 == snap_at:
            snap = (fs.fields.u_n.copy(), k.x.copy())
    return np.asarray(ys), snap


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Per package: the base flow (written to steady/), the continuous
    10-step closed loop with checkpoints at 5 and 10, and the restart at
    T = 0.025 from the sidecar, all in one output directory."""
    out = {}
    for name in ("jax", "torch"):
        side = Side(name)
        path = tmp_path_factory.mktemp(name)
        if side.jax:
            mesh = cylinder_mesh_j(**COARSE)
        else:
            mesh = path / "mesh" / "cylinder.xdmf"
            write_xdmf_mesh(mesh, cylinder_mesh(**COARSE))
        fb = side.make(mesh, path, num_steps=10, save_every=5)
        fb.compute_steady_state(u_ctrl=[0.0, 0.0], method="picard", max_iter=3)
        fb.compute_steady_state(u_ctrl=[0.0, 0.0], method="newton",
                                initial_guess=fb.fields.UP0, max_iter=10)
        fs = side.make(mesh, path, num_steps=10, save_every=5)
        fs.load_steady_state()
        fs.initialize_time_stepping()
        k = side.controller.from_matrices(**K_MATS)
        ys, (u5, kx5) = _closed_loop(fs, k, fs.y_meas, 10, snap_at=5)
        fs2 = side.make(mesh, path, num_steps=5, save_every=5, Tstart=T_RESTART)
        fs2.load_steady_state()
        fs2.initialize_time_stepping(Tstart=T_RESTART)
        u_restart = fs2.fields.u_n.copy()
        k.x = kx5.copy()
        ys2, _ = _closed_loop(fs2, k, ys[4], 5)
        out[name] = dict(side=side, path=path, mesh=mesh, fb=fb, fs=fs, fs2=fs2, ys=ys, u5=u5,
                         kx5=kx5, u_restart=u_restart, ys2=ys2)
    return out


def test_torch_restart_exporter_matches_jax(tmp_path):
    """The exporter of tests/test_components.py:172-216 in both packages:
    the same CSV text, the sidecar's exact keys and values (file names
    aside), and a snapshot with adjust_baseflow = 1 that holds the full
    field."""
    space = TaylorHoodSpace.build(unit_square_mesh(4, 4))
    exporters = {}
    for name, ext, sim, fields, exp in (("j", ".h5", SimPathsJ, FieldsJ, ExporterJ),
                                        ("t", ".ckpt", SimPathsT, FieldsT, ExporterT)):
        d = tmp_path / name
        paths = sim(U0=d / f"U0{ext}", P0=d / f"P0{ext}", steady_meta=d / "meta0.json",
                    U=d / f"U{ext}", P=d / f"P{ext}", Uprev=d / f"Uprev{ext}",
                    U_restart=d / f"Ur{ext}", Uprev_restart=d / f"Upr{ext}",
                    P_restart=d / f"Pr{ext}", timeseries=d / "ts.csv",
                    metadata=d / "meta.json", mesh=None)
        f = fields()
        f.U0 = np.ones((space.n_vnodes, 2))
        f.P0 = np.full(space.n_pressure_dofs, 2.0)
        ex = exp(paths, f, space, Tstart=0.5, dt=0.01, save_every=3)
        ex.log_ic(t=0.5, y_meas=[0.1, 0.2], dE=0.5)
        ex.log(u_ctrl=[1.0], y_meas=[0.3, 0.4], dE=0.6, t=0.51, runtime=0.001)
        ex.write_timeseries()
        u = 0.1 * np.ones((space.n_vnodes, 2))
        ex.export_snapshots(u, u, np.zeros(space.n_pressure_dofs), time=0.5, adjust_baseflow=1.0)
        ex.write_metadata(restart_order=2)
        ex.close()
        exporters[name] = (ex, paths)
    (ej, pj), (et, pt) = exporters["j"], exporters["t"]
    assert pt.timeseries.read_text() == pj.timeseries.read_text()
    assert et.columns() == list(ej.to_dataframe().columns)
    assert et.columns()[:3] == ["time", "dE", "runtime"]
    assert np.isnan(et.to_columns()["u_ctrl_1"][0])
    meta_j, meta_t = json.loads(pj.metadata.read_text()), json.loads(pt.metadata.read_text())
    assert meta_t == {"Tstart": 0.5, "dt": 0.01, "save_every": 3, "checkpoints_written": 1,
                      "restart_order": 2,
                      "files": {"U": "Ur.ckpt", "Uprev": "Upr.ckpt", "P": "Pr.ckpt"}}
    assert {**meta_t, "files": None} == {**meta_j, "files": None}
    assert np.allclose(read_field_snapshot(pt.U_restart, "U", 0), 1.1)
    assert np.allclose(read_field_snapshot(pt.P_restart, "P", 0), 2.0)
    for name, key in (("U_restart", "U"), ("Uprev_restart", "U_n"), ("P_restart", "P")):
        assert np.array_equal(read_field_snapshot(getattr(pt, name), key, 0),
                              read_field_snapshot(getattr(pj, name), key, 0)), name


def test_torch_restart_checkpoint_files_match_jax(runs):
    """The continuous run's files: the sidecar (file names aside), the CSV's
    columns, the snapshot counters, times and fields (1e-10), and the
    Paraview indexes' grids (the t = 0 snapshot and two checkpoints)."""
    j, t = runs["jax"]["fs"], runs["torch"]["fs"]
    meta_j = json.loads(j.paths.metadata.read_text())
    meta_t = json.loads(t.paths.metadata.read_text())
    assert set(meta_t) == {"Tstart", "dt", "save_every", "checkpoints_written",
                           "restart_order", "files"}
    assert {**meta_t, "files": None} == {**meta_j, "files": None}
    # the t = 0 snapshot is written before the count is reset
    assert meta_t["checkpoints_written"] == 2 and meta_t["restart_order"] == 2
    assert meta_t["files"] == {k: v.replace(".h5", ".ckpt") for k, v in meta_j["files"].items()}
    header = t.paths.timeseries.read_text().splitlines()[0].split(",")
    assert header == j.paths.timeseries.read_text().splitlines()[0].split(",")
    for attr, key in (("U_restart", "U"), ("Uprev_restart", "U_n"), ("P_restart", "P")):
        pt, pj = getattr(t.paths, attr), getattr(j.paths, attr)
        assert pt.suffix == ".ckpt" and pt.is_dir()
        assert sorted(p.name for p in (pt / key).iterdir()) == ["0.npy", "1.npy", "2.npy"]
        assert json.loads((pt / "times.json").read_text())[key] == pytest.approx([0.0, 0.025, 0.05])
        for k in range(3):
            assert _rel(read_field_snapshot(pt, key, k), read_field_snapshot(pj, key, k)) <= TOL
    for attr in ("U_restart", "P_restart"):
        xdmf = getattr(t.paths, attr).with_suffix(".xdmf")
        assert xdmf.read_text().count('GridType="Uniform"') == 3


def test_torch_restart_from_sidecar_matches_jax(runs):
    """Both packages restart at BDF2 from their sidecars: the state at the
    restart equals the continuous run's after step 5, and the restarted
    closed loop reproduces the continuous run's tail, each to 1e-10 and
    against the other package; the restarted Stepper built one system."""
    rj, rt = runs["jax"], runs["torch"]
    for r in (rj, rt):
        assert r["fs2"].order == 2
        assert _rel(r["u_restart"], r["u5"]) <= TOL
        assert _rel(r["ys2"], r["ys"][5:]) <= TOL
    assert _rel(rt["u_restart"], rj["u_restart"]) <= TOL
    assert _rel(rt["ys"], rj["ys"]) <= TOL
    assert _rel(rt["ys2"], rj["ys2"]) <= TOL
    assert _rel(rt["fs2"].fields.up_, rj["fs2"].fields.up_) <= TOL
    st = rt["fs2"].stepper
    assert st._solver_kinds == ["host"] and st._order_idx == {2: 0}
    assert rt["fs"].stepper._solver_kinds == ["host", "host"]  # BDF1, then BDF2
    assert rj["fs2"].stepper._orders == (2,)
    assert rt["fs2"].t == pytest.approx(0.05)
    # the restarted run's own checkpoint, at T = 0.025 + 5 steps
    meta = json.loads(rt["fs2"].paths.metadata.read_text())
    assert meta["Tstart"] == T_RESTART and meta["checkpoints_written"] == 1


def test_torch_restart_from_jax_checkpoints(runs, tmp_path):
    """The port restarts from the sidecar, checkpoints (.h5) and base flow
    (steady/*.h5) that the JAX package wrote: its state at the restart and
    its restarted y within 1e-10 of the JAX package's own restart."""
    rj = runs["jax"]
    path = tmp_path / "from_jax"
    shutil.copytree(rj["path"], path)
    mesh = path / "cylinder.xdmf"
    write_xdmf_mesh(mesh, cylinder_mesh(**COARSE))
    fs = Side("torch").make(mesh, path, num_steps=5, Tstart=T_RESTART)
    fs.load_steady_state((path / "steady" / "U0.h5", path / "steady" / "P0.h5"))
    assert np.array_equal(fs.fields.U0, rj["fb"].fields.U0)
    fs.initialize_time_stepping(Tstart=T_RESTART)
    assert fs.order == 2
    assert _rel(fs.fields.u_n, rj["u_restart"]) <= TOL
    k = ControllerT.from_matrices(**K_MATS)
    k.x = rj["kx5"].copy()
    ys, _ = _closed_loop(fs, k, rj["ys"][4], 5)
    assert _rel(ys, rj["ys2"]) <= TOL
    assert not list(path.glob("*restart0,025.ckpt"))  # save_every = 0 writes nothing


def test_torch_restart_legacy_param_restart(runs, tmp_path):
    """Without a sidecar, ParamRestart names the files (from Trestartfrom)
    and the counter (from the old dt and save_every), in both packages
    (tests/integration/test_cylinder.py:216): BDF2 from the first step, and
    the closed loop's tail within 1e-10 of the continuous runs."""
    got = {}
    for name in ("jax", "torch"):
        r = runs[name]
        side = r["side"]
        path = tmp_path / name
        shutil.copytree(r["path"], path)
        for p in path.glob("meta_restart*.json"):
            p.unlink()
        mesh = r["mesh"] if side.jax else path / "mesh" / "cylinder.xdmf"
        fs = side.make(mesh, path, num_steps=5, Tstart=T_RESTART)
        fs.params_restart = side.fsp.ParamRestart(save_every_old=5, restart_order=2,
                                                  dt_old=DT, Trestartfrom=0.0)
        fs.load_steady_state()
        fs.initialize_time_stepping(Tstart=T_RESTART)
        assert fs.order == 2
        k = side.controller.from_matrices(**K_MATS)
        k.x = r["kx5"].copy()
        got[name], _ = _closed_loop(fs, k, r["ys"][4], 5)
        assert _rel(got[name], r["ys"][5:]) <= TOL
    assert _rel(got["torch"], got["jax"]) <= TOL
    with pytest.raises(FileNotFoundError, match="no ParamRestart"):
        fs = Side("torch").make(runs["torch"]["mesh"], tmp_path / "torch", Tstart=T_RESTART)
        fs.load_steady_state()
        fs.initialize_time_stepping(Tstart=T_RESTART)


def test_torch_restart_steady_state_files(runs, tmp_path):
    """compute_steady_state with save_every > 0 writes steady/U0, P0 and
    meta.json (the mesh's cell count); load_steady_state() reads them back
    bitwise, matches the JAX package's files to 1e-10, and refuses a
    meta.json with another cell count; one .npz path still loads."""
    rj, rt = runs["jax"], runs["torch"]
    steady = rt["path"] / "steady"
    assert sorted(p.name for p in steady.iterdir()) == ["P0.ckpt", "U0.ckpt", "meta.json"]
    assert json.loads((steady / "meta.json").read_text()) == json.loads(
        (rj["path"] / "steady" / "meta.json").read_text()) == {
        "mesh_cells": rt["fs"].mesh.num_cells}
    assert np.array_equal(rt["fs"].fields.U0, rt["fb"].fields.U0)
    assert np.array_equal(rt["fs"].fields.P0, rt["fb"].fields.P0)
    assert _rel(rt["fb"].fields.U0, rj["fb"].fields.U0) <= TOL
    assert _rel(rt["fb"].fields.P0, rj["fb"].fields.P0) <= TOL
    bad = tmp_path / "bad"
    shutil.copytree(steady, bad)
    (bad / "meta.json").write_text(json.dumps({"mesh_cells": rt["fs"].mesh.num_cells + 1}))
    fs = Side("torch").make(rt["mesh"], tmp_path)
    with pytest.raises(ValueError, match="mesh cells"):
        fs.load_steady_state((bad / "U0.ckpt", bad / "P0.ckpt"))
    np.savez(tmp_path / "base.npz", U0=rj["fb"].fields.U0, P0=rj["fb"].fields.P0)
    fs.load_steady_state(tmp_path / "base.npz")
    assert np.array_equal(fs.fields.UP0, rj["fb"].fields.UP0)


def test_torch_restart_start_order_2_stepper_matches_jax(runs):
    """The restarted solvers' Steppers (start_order=2): BDF2 on the first
    step, from a restart carry (two states), through step, the compiled
    step and the open- and closed-loop rollouts, against the JAX package's
    start_order=2 Stepper to 1e-10."""
    sj, st = runs["jax"]["fs2"].stepper, runs["torch"]["fs2"].stepper
    assert st.start_order == 2 and st._order_of(0) == 2 and not st._borrow_first
    rng = np.random.default_rng(0)
    up_n = runs["torch"]["fs2"].fields.up_ + 1e-3 * rng.standard_normal(st.space.n_dofs)
    up_nn = runs["torch"]["fs2"].fields.up_
    us = 0.1 * rng.standard_normal((4, 2))
    for step_t, step_j in ((st.step, sj.compiled_step()), (st.compiled_step(), sj.compiled_step())):
        ct, cj = st.init_carry(up_n, up_nn), sj.init_carry(up_n, up_nn)
        for k, u in enumerate(us):
            ct, ot = step_t(ct, u)
            cj, oj = step_j(cj, u)
            assert _rel(ot.x, oj.x) <= TOL and _rel(ot.y, oj.y) <= TOL, k
            got = carry_to_numpy(ct)
            for f in CARRY_FIELDS:
                assert _rel(got[f], np.asarray(getattr(cj, f))) <= TOL, (k, f)
    ct, ot = st.rollout_open_loop(st.init_carry(up_n, up_nn), us)
    cj, oj = sj.rollout_open_loop(sj.init_carry(up_n, up_nn), us)
    assert _rel(ot.y, oj.y) <= TOL and _rel(ot.dE, oj.dE) <= TOL
    assert _rel(ct.u_n, cj.u_n) <= TOL and ct.it == 4
    mats = ControllerT.from_matrices(**K_MATS).discrete(DT)
    sel = np.array([[1.0, 0.0, 0.0]])
    k_mats = (mats[0], mats[1] @ sel, np.vstack([mats[2]] * 2), np.vstack([mats[3] @ sel] * 2))
    y0 = up_n @ st.c_rows.T
    ct, (yt, det, ut, _) = st.make_rollout_closed_loop(5)(st.init_carry(up_n, up_nn), k_mats, y0)
    cj, (yj, dej, uj, _) = sj.make_rollout_closed_loop(5)(sj.init_carry(up_n, up_nn), k_mats, y0)
    for a, b in ((yt, yj), (det, dej), (ut, uj), (ct.u_n, cj.u_n)):
        assert _rel(a, b) <= TOL


def test_torch_restart_start_order_2_builds_one_system(runs, monkeypatch):
    """Past the two-factor size the first step of a run borrows the BDF2
    factor (BDF1 kept as an f64 operator, Richardson sweeps); a restart
    builds the BDF2 factor alone and none of that. The multifrontal
    start_order=2 Stepper's step equals the host one's to 1e-10."""
    fs2 = runs["torch"]["fs2"]
    monkeypatch.setattr(Stepper, "DENSE_TWO_FACTOR_MAX_N", 1000)
    host = fs2.stepper
    kw = dict(space=host.space, forms=host.forms, bcs=host.bcs, u0_nodes=host.u0_nodes,
              c_rows=host.c_rows, force_cols=host.force_cols, dtype=torch.float64,
              device="cpu", force_substructure=True)
    first = Stepper(start_order=1, **kw)
    assert first._solver_kinds == ["borrowed", "multifrontal"] and first._dev["a_bc"]
    st = Stepper(start_order=2, **kw)
    assert st._solver_kinds == ["multifrontal"] and len(st._solvers) == 1
    assert not st._borrow_first and st._dev["a_bc"] == {}
    up_n = fs2.fields.up_
    c_mf, c_host = st.init_carry(up_n, up_n), host.init_carry(up_n, up_n)
    for u in ([0.1, 0.1], [0.0, 0.0]):
        c_mf, o_mf = st.step(c_mf, u)
        c_host, o_host = host.step(c_host, u)
        assert _rel(o_mf.x, o_host.x) <= TOL
    with pytest.raises(ValueError, match="start_order"):
        Stepper(start_order=3, **kw)


def test_torch_restart_cn(runs, tmp_path):
    """A Crank-Nicolson closed loop with checkpoints, and its restart:
    the sidecar's restart_order is 'cn', the restarted solver steps CN, and
    its state at the restart and its y match the JAX package's to 1e-10."""
    got = {}
    for name in ("jax", "torch"):
        r = runs[name]
        side, path = r["side"], tmp_path / name
        fs = side.make(r["mesh"], path, num_steps=10, save_every=5, time_scheme="cn")
        fs._assign_steady_state(r["fb"].fields.U0, r["fb"].fields.P0)
        fs.initialize_time_stepping()
        k = side.controller.from_matrices(**K_MATS)
        ys, (_, kx5) = _closed_loop(fs, k, fs.y_meas, 10, snap_at=5)
        assert json.loads(fs.paths.metadata.read_text())["restart_order"] == "cn"
        fs2 = side.make(r["mesh"], path, num_steps=5, Tstart=T_RESTART, time_scheme="cn")
        fs2._assign_steady_state(r["fb"].fields.U0, r["fb"].fields.P0)
        fs2.initialize_time_stepping(Tstart=T_RESTART)
        assert fs2.order == "cn"
        u_restart = fs2.fields.u_n.copy()
        k.x = kx5.copy()
        ys2, _ = _closed_loop(fs2, k, ys[4], 5)
        got[name] = (ys, u_restart, ys2)
    for a, b in zip(got["torch"], got["jax"]):
        assert _rel(a, b) <= TOL


# each model at a small mesh: its solver, its mesh, make_default keywords
MODELS = {
    "cylinder": (CylT, lambda: cylinder_mesh(yinf=3.0, xinf=8.0, xinfa=-3.0, n1=2.0, n2=1.0,
                                             n3=0.5, segments=40), {}),
    "cavity": (CavityFlowSolver, lambda: cavity_mesh(n_coarse=4, n_mid=8, n_fine=16), {}),
    "lidcavity": (LidCavityFlowSolver, lambda: lidcavity_mesh(8), {}),
    "pinball": (PinballFlowSolver,
                lambda: pinball_mesh(n1=2.0, n2=1.2, n3=0.5, segments=32, xinf=14.0),
                {"mode_actuation": CYLINDER_ACTUATION_MODE.ROTATION}),
}


@pytest.mark.parametrize("model", sorted(MODELS))
def test_torch_restart_every_model(model, tmp_path):
    """make_default(meshpath=...) on each model gives the mesh, boundaries
    and BC dofs of make_default(mesh=...); a 2-step run with a checkpoint
    every step (around a zero base flow, u = 0.1 on every actuator) and a
    restart from its sidecar at step 1 reproduce its second step to
    1e-10; a missing mesh file raises FileNotFoundError."""
    cls, make_mesh, kw = MODELS[model]
    mesh = make_mesh()
    write_xdmf_mesh(tmp_path / "mesh.xdmf", mesh)
    opts = dict(Re=100, verbose=0, device="cpu", solver_backend="host_lu", precision="f64", **kw)
    ref = cls.make_default(mesh=mesh, path_out=tmp_path / "ref", **opts)
    fs = cls.make_default(meshpath=tmp_path / "mesh.xdmf", path_out=tmp_path, num_steps=2,
                          save_every=1, **opts)
    assert np.array_equal(fs.mesh.coords, mesh.coords) and np.array_equal(fs.mesh.cells, mesh.cells)
    for name in ref.boundaries:
        assert np.array_equal(fs.markers.facets(name), ref.markers.facets(name)), name
    assert np.array_equal(fs._bcset_perturbation().dofs, ref._bcset_perturbation().dofs)
    zeros = (np.zeros((fs.space.n_vnodes, 2)), np.zeros(fs.space.n_pressure_dofs))
    fs._assign_steady_state(*zeros)
    fs.initialize_time_stepping()
    u = 0.1 * np.ones(fs.params_control.actuator_number)
    ys = [fs.step(u) for _ in range(2)]
    dt = fs.params_time.dt
    fs2 = cls.make_default(meshpath=tmp_path / "mesh.xdmf", path_out=tmp_path, num_steps=1,
                           Tstart=dt, **opts)
    fs2._assign_steady_state(*zeros)
    fs2.initialize_time_stepping(Tstart=dt)
    assert fs2.order == 2
    assert _rel(fs2.step(u), ys[1]) <= TOL
    with pytest.raises(FileNotFoundError, match="Mesh file not found"):
        cls.make_default(meshpath=tmp_path / "absent.xdmf", path_out=tmp_path, **opts)
