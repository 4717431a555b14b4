"""The port's Stepper against the JAX package's Stepper, step by step.

Both run the dense LU backend in float64 on the CPU on a small cylinder
mesh (2,575 dofs), from one base flow (computed by the JAX package) and one
carry (the JAX ``init_carry``, passed across with ``carry_from_numpy``), for
5 steps with a nonzero control. States, carries, y and dE agree to 1e-10
relative. Cases: the BDF1→BDF2 ramp with two factors; the same ramp with
``DENSE_TWO_FACTOR_MAX_N`` lowered on both classes, so the first step is the
"borrowed" Richardson solve against the BDF2 factor; and Crank-Nicolson.
"""

import numpy as np
import pytest
import torch

from flowcontrol_tpu.core.stepper import Stepper as StepperJ
from flowcontrol_tpu.mesh.generation import cylinder_mesh as cylinder_mesh_j
from flowcontrol_tpu.models.cylinder import CylinderFlowSolver as CylJ
from flowcontrol_tpu_torch.core.stepper import Stepper as StepperT
from flowcontrol_tpu_torch.core.stepper import carry_from_numpy, carry_to_numpy
from flowcontrol_tpu_torch.mesh.generation import cylinder_mesh as cylinder_mesh_t
from flowcontrol_tpu_torch.models.cylinder import CylinderFlowSolver as CylT

torch.set_num_threads(1)

SMALL = dict(yinf=3.0, xinf=8.0, xinfa=-3.0, n1=2.0, n2=1.0, n3=0.5, segments=40)
TOL = 1e-10
CARRY_FIELDS = ("u_n", "u_nn", "mu_n", "mu_nn", "n_prev", "u_ctrl_prev")


@pytest.fixture(scope="module")
def base_flow(tmp_path_factory):
    fj = CylJ.make_default(
        Re=100, mesh=cylinder_mesh_j(**SMALL), solver_backend="host_lu",
        precision="f64", path_out=tmp_path_factory.mktemp("bf"),
    )
    fj.compute_steady_state(u_ctrl=[0.0, 0.0], method="picard", max_iter=3)
    fj.compute_steady_state(u_ctrl=[0.0, 0.0], method="newton",
                            initial_guess=fj.fields.UP0, max_iter=10)
    return fj.fields.U0.copy(), fj.fields.P0.copy()


def _solvers(base_flow, tmp_path, scheme):
    kw = dict(Re=100, num_steps=5, solver_backend="dense_lu", precision="f64",
              time_scheme=scheme)
    fj = CylJ.make_default(mesh=cylinder_mesh_j(**SMALL), path_out=tmp_path / "j", **kw)
    ft = CylT.make_default(mesh=cylinder_mesh_t(**SMALL), path_out=tmp_path / "t",
                           device="cpu", **kw)
    for fs in (fj, ft):
        fs._assign_steady_state(*base_flow)
        fs.initialize_time_stepping()
        fs._prepare_systems()
    return fj, ft


def _rel(a, b):
    a, b = np.asarray(a, dtype=np.float64), np.asarray(b, dtype=np.float64)
    return np.abs(a - b).max() / max(np.abs(b).max(), 1e-300)


@pytest.mark.parametrize("case", ["bdf", "bdf_borrowed", "cn"])
def test_torch_stepper_matches_jax(base_flow, tmp_path, monkeypatch, case):
    if case == "bdf_borrowed":
        monkeypatch.setattr(StepperJ, "DENSE_TWO_FACTOR_MAX_N", 1000)
        monkeypatch.setattr(StepperT, "DENSE_TWO_FACTOR_MAX_N", 1000)
    fj, ft = _solvers(base_flow, tmp_path, "cn" if case == "cn" else "bdf")
    sj, st = fj._stepper, ft._stepper
    expected = {"bdf": ["lapack", "lapack"], "bdf_borrowed": ["borrowed", "lapack"],
                "cn": ["lapack"]}[case]
    assert sj._solver_kinds == expected and st._solver_kinds == expected
    assert sj.dense_operators and not sj.banded_operators and not sj.windowed_nl

    # the port's own init_carry from the same fields as the reference's
    cj = {k: np.asarray(v) for k, v in fj._carry._asdict().items()}
    ct_own = carry_to_numpy(ft._carry)
    for k in CARRY_FIELDS:
        assert _rel(ct_own[k], cj[k]) <= TOL, k

    carry_j, carry_t = fj._carry, carry_from_numpy(cj, "cpu", torch.float64)
    step_j = sj.compiled_step()
    for k in range(5):
        u = np.array([0.3 * np.cos(k), -0.2 + 0.05 * k])
        carry_j, out_j = step_j(carry_j, u)
        carry_t, out_t = st.step(carry_t, u)
        assert _rel(out_t.x, out_j.x) <= TOL, k
        assert _rel(out_t.y, out_j.y) <= TOL, k
        assert abs(float(out_t.dE) - float(out_j.dE)) <= TOL * abs(float(out_j.dE)), k
        assert not bool(out_t.diverged)
        ct = carry_to_numpy(carry_t)
        for f in CARRY_FIELDS:
            assert _rel(ct[f], np.asarray(getattr(carry_j, f))) <= TOL, (k, f)
        assert int(ct["it"]) == int(carry_j.it) == k + 1


def test_torch_rollout_open_loop_matches_steps(base_flow, tmp_path):
    """rollout_open_loop is the step loop: same outputs, stacked over T."""
    _, ft = _solvers(base_flow, tmp_path, "bdf")
    st = ft._stepper
    u_seq = np.stack([np.array([0.1 * k, -0.1]) for k in range(4)])
    carry, ys = ft._carry, []
    for u in u_seq:
        carry, out = st.step(carry, u)
        ys.append(out.y.numpy())
    carry_r, outs = st.rollout_open_loop(ft._carry, u_seq)
    assert outs.x is None and outs.y.shape == (4, st.ns) and outs.dE.shape == (4,)
    assert np.array_equal(outs.y.numpy(), np.stack(ys))
    assert torch.equal(carry_r.u_n, carry.u_n) and carry_r.it == 4


def test_torch_stepper_f32_factor_paths(base_flow, tmp_path):
    """f32 stepping on the CPU against the port's own f64 run: the factor is
    computed in f64 and stored f32, with no refinement sweep."""
    runs = {}
    for prec in ("f64", "f32"):
        fs = CylT.make_default(Re=100, mesh=cylinder_mesh_t(**SMALL), path_out=tmp_path,
                               solver_backend="dense_lu", precision=prec, device="cpu")
        fs._assign_steady_state(*base_flow)
        fs.initialize_time_stepping()
        for k in range(5):
            fs.step(np.array([0.3, -0.2]))
        runs[prec] = fs
    st = runs["f32"]._stepper
    assert st.dtype == torch.float32
    assert st._solvers[0].lu.dtype == torch.float32
    err = np.linalg.norm(runs["f32"].fields.up_ - runs["f64"].fields.up_) / np.linalg.norm(
        runs["f64"].fields.up_
    )
    assert err <= 1e-4


def test_torch_stepper_dense_lu_size_rule(base_flow, tmp_path, monkeypatch):
    """One rule sizes the dense LU: its f64 factorization (A and LU, 16 n^2
    bytes) fits the budget, or the Stepper refuses the size."""
    import flowcontrol_tpu_torch.core.stepper as stepper_mod

    fs = CylT.make_default(Re=100, mesh=cylinder_mesh_t(**SMALL), path_out=tmp_path,
                           solver_backend="dense_lu", device="cpu")
    n = fs.space.n_dofs
    for budget, fits in ((16 * n * n, True), (16 * n * n - 1, False)):
        monkeypatch.setattr(stepper_mod, "device_memory_budget_bytes", lambda device: budget)
        assert (stepper_mod.dense_lu_max_dofs_device("cpu") >= n) == fits
    fs._assign_steady_state(*base_flow)
    fs.initialize_time_stepping()
    with pytest.raises(MemoryError, match="multifrontal"):
        fs._prepare_systems()
