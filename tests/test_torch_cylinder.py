"""The port's cylinder slice end to end against the JAX package.

``CylinderFlowSolver`` of both packages on the coarse cylinder mesh of the
integration tests, host LU in float64: base flow (Picard then Newton), then
10 steps with zero control. The port agrees with a live JAX run to 1e-10
relative and with the pinned ``regression_values.json`` "cylinder" entries
at the tolerances ``test_cylinder_regression`` uses (U0_max 1e-8, the rest
1e-6).
"""

import json
from pathlib import Path

import numpy as np
import pytest
import torch

from flowcontrol_tpu.mesh.generation import cylinder_mesh as cylinder_mesh_j
from flowcontrol_tpu.models.cylinder import CylinderFlowSolver as CylJ
from flowcontrol_tpu_torch.mesh.generation import cylinder_mesh as cylinder_mesh_t
from flowcontrol_tpu_torch.models.cylinder import CylinderFlowSolver as CylT

torch.set_num_threads(1)

COARSE = dict(yinf=5.0, xinf=15.0, xinfa=-5.0, n1=4.0, n2=2.0, n3=0.8, segments=80)
REGRESSION = Path(__file__).parent / "integration" / "regression_values.json"
TOL = 1e-10


def _run(cls, mesh, path_out, **kw):
    fs = cls.make_default(Re=100, num_steps=10, mesh=mesh, path_out=path_out,
                          solver_backend="host_lu", precision="f64", **kw)
    fs.compute_steady_state(u_ctrl=[0.0, 0.0], method="picard", max_iter=3)
    fs.compute_steady_state(u_ctrl=[0.0, 0.0], method="newton",
                            initial_guess=fs.fields.UP0, max_iter=10)
    fs.initialize_time_stepping()
    ys = [fs.step(np.zeros(2)) for _ in range(10)]
    return fs, np.asarray(ys)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    fj, yj = _run(CylJ, cylinder_mesh_j(**COARSE), tmp_path_factory.mktemp("j"))
    ft, yt = _run(CylT, cylinder_mesh_t(**COARSE), tmp_path_factory.mktemp("t"), device="cpu")
    return fj, yj, ft, yt


def _rel(a, b):
    a, b = np.asarray(a, dtype=np.float64), np.asarray(b, dtype=np.float64)
    return np.abs(a - b).max() / max(np.abs(b).max(), 1e-300)


def test_torch_cylinder_matches_live_jax(runs):
    fj, yj, ft, yt = runs
    assert ft.space.n_dofs == fj.space.n_dofs
    assert _rel(ft.fields.U0, fj.fields.U0) <= TOL
    assert _rel(ft.fields.P0, fj.fields.P0) <= TOL
    assert abs(ft.cd0 - fj.cd0) <= TOL * abs(fj.cd0)
    assert abs(ft.cl0 - fj.cl0) <= TOL * abs(fj.cd0)
    assert _rel(yt, yj) <= TOL
    assert _rel(ft.fields.up_, fj.fields.up_) <= TOL
    assert abs(ft.compute_perturbation_energy() - fj.compute_perturbation_energy()) <= (
        TOL * fj.compute_perturbation_energy()
    )
    tj = fj.timeseries
    tt = ft.timeseries
    assert list(tt) == list(tj.columns)
    for col in tj.columns:
        ref, got = tj[col].to_numpy(dtype=float), tt[col]
        same_nan = np.array_equal(np.isnan(ref), np.isnan(got))
        if col == "runtime":
            assert same_nan
        else:
            assert same_nan and _rel(np.nan_to_num(got), np.nan_to_num(ref)) <= TOL, col


def test_torch_cylinder_regression_values(runs):
    _, _, ft, yt = runs
    vals = json.loads(REGRESSION.read_text())["cylinder"]
    assert ft.mesh.num_cells == vals["n_cells"]
    assert np.isclose(np.abs(ft.fields.U0).max(), vals["U0_max"], rtol=1e-8)
    assert np.isclose(np.abs(ft.fields.U0).mean(), vals["U0_mean"], rtol=1e-6)
    assert np.isclose(ft.cl0, vals["cl0"], rtol=1e-6)
    assert np.isclose(ft.cd0, vals["cd0"], rtol=1e-6)
    assert np.isclose(ft.t, 0.05, atol=1e-12)
    for i, key in enumerate(["y1", "y2", "y3"]):
        assert np.isclose(yt[-1, i], vals[key], rtol=1e-6), key
    assert np.isclose(ft.compute_perturbation_energy(), vals["dE"], rtol=1e-6)
    assert np.isclose(np.abs(ft.fields.u_n + ft.fields.U0).max(), vals["U_max"], rtol=1e-6)


def test_torch_cylinder_timeseries_csv(runs, tmp_path):
    """The CSV has the reference's columns, one row per logged step."""
    _, _, ft, _ = runs
    ft.write_timeseries()
    lines = ft.paths.timeseries.read_text().splitlines()
    assert lines[0].split(",") == ft.exporter.columns()
    assert len(lines) == 1 + 11  # header, IC row, 10 steps
    assert lines[1].split(",")[-2:] == ["", ""]  # the IC row has no control


def test_torch_cylinder_refuses_unported_io(tmp_path):
    mesh = cylinder_mesh_t(**COARSE)
    with pytest.raises(NotImplementedError):
        CylT.make_default(mesh=mesh, path_out=tmp_path, save_every=5)


@pytest.mark.parametrize("backend, precision, error", [
    ("host_lu", "auto", ValueError),  # the CPU validation backend
    ("dense_lu", "f64", TypeError),  # K1 takes float32 only
])
def test_torch_cylinder_refuses_off_device_setups(runs, tmp_path, backend, precision, error):
    """On a CUDA device the stepper refuses a host solve and a dtype K1 does
    not take, before it builds anything on the device."""
    fj, _, _, _ = runs
    fs = CylT.make_default(mesh=cylinder_mesh_t(**COARSE), path_out=tmp_path, device="cuda",
                           solver_backend=backend, precision=precision)
    fs._assign_steady_state(fj.fields.U0, fj.fields.P0)
    fs.initialize_time_stepping()
    with pytest.raises(error, match=backend if error is ValueError else "float32"):
        fs._prepare_systems()


def test_torch_cylinder_loads_reference_baseflow_npz(runs, tmp_path):
    """A base flow saved in the reference's ``models/_baseflows`` format
    (npz with U0, P0) is read as plain arrays and adopted unchanged."""
    fj, _, _, _ = runs
    path = tmp_path / "cylinder_re100.npz"
    np.savez_compressed(path, U0=fj.fields.U0, P0=fj.fields.P0)
    fs = CylT.make_default(mesh=cylinder_mesh_t(**COARSE), path_out=tmp_path)
    fs.load_steady_state(path)
    assert np.array_equal(fs.fields.U0, fj.fields.U0)
    assert np.array_equal(fs.fields.UP0, fj.fields.UP0)
    assert fs.E0 == fj.E0
    with pytest.raises(ValueError):
        fs._assign_steady_state(fj.fields.U0[:-1], fj.fields.P0)
