"""The port's Stepper against the JAX package's Stepper, step by step.

Both run the dense LU backend in float64 on the CPU on a small cylinder
mesh (2,575 dofs), from one base flow (computed by the JAX package) and one
carry (the JAX ``init_carry``, passed across with ``carry_from_numpy``), for
5 steps with a nonzero control. States, carries, y and dE agree to 1e-10
relative. Cases: the BDF1→BDF2 ramp with two factors; the same ramp with
``DENSE_TWO_FACTOR_MAX_N`` lowered on both classes, so the first step is the
"borrowed" Richardson solve against the BDF2 factor; and Crank-Nicolson.

The multifrontal kind (``stepper_options={"force_substructure": True}``)
is held to the JAX package's the same way over 10 steps (JAX factor cache
off), with both orders factored and with the borrowed first step; the
dense LU's size rule hands larger meshes to it ('dense_lu' and 'auto'); and
every f32 factor takes one refinement sweep with an f64 residual.

The blocked-LU kind (``trisolve="cuda"``: a ``BlockLU`` factor solved by the
K3 wrapper, on the CPU its plain version) is held to the JAX Stepper with
``trisolve="pallas"`` (the TPU kernel in interpret mode) with
``LAPACK_LU_MAX_N`` lowered on both classes. A batch of distinct states and
controls through ``init_carry`` + ``rollout_open_loop`` equals the
sequential single-stream runs and the JAX batched rollout, and
``rollout_closed_loop`` equals the JAX fused rollout and a Python loop of
``Controller.step`` + ``fs.step``, single and with a stack of controllers.
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


def _solvers(base_flow, tmp_path, scheme, opts_j=None, opts_t=None, **extra):
    """The two packages' solvers, prepared from one base flow. ``opts_j`` /
    ``opts_t`` are stepper options that only one package takes."""
    kw = dict(Re=100, num_steps=5, solver_backend="dense_lu", precision="f64",
              time_scheme=scheme, **extra)
    shared = kw.pop("stepper_options", {})
    fj = CylJ.make_default(mesh=cylinder_mesh_j(**SMALL), path_out=tmp_path / "j",
                           stepper_options={**shared, **(opts_j or {})}, **kw)
    ft = CylT.make_default(mesh=cylinder_mesh_t(**SMALL), path_out=tmp_path / "t",
                           device="cpu", stepper_options={**shared, **(opts_t or {})}, **kw)
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


@pytest.mark.parametrize("case", ["two_factors", "borrowed"])
def test_torch_stepper_f32_factor_paths(base_flow, tmp_path, monkeypatch, case):
    """f32 stepping on the CPU against the port's own f64 run: the factor is
    computed in f64 and stored f32, and each solve takes one refinement
    sweep with an f64 residual; the borrowed first step (BDF1 by Richardson
    sweeps on the BDF2 factor) takes its residual in f64 too."""
    if case == "borrowed":
        monkeypatch.setattr(StepperT, "DENSE_TWO_FACTOR_MAX_N", 1000)
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
    assert st._solvers[-1].lu.dtype == torch.float32
    assert st._dev["a_refine"][1].dtype == torch.float64
    if case == "borrowed":
        assert st._solver_kinds[0] == "borrowed" and st._refine == {1: 1}
        assert st._dev["a_bc"][0].dtype == torch.float64
    else:
        assert st._refine == {0: 1, 1: 1}
    err = np.linalg.norm(runs["f32"].fields.up_ - runs["f64"].fields.up_) / np.linalg.norm(
        runs["f64"].fields.up_
    )
    assert err <= 1e-4


@pytest.mark.parametrize("backend", ["dense_lu", "auto"])
def test_torch_stepper_dense_lu_size_rule(base_flow, tmp_path, monkeypatch, backend):
    """One rule sizes the dense LU: its f64 factorization (A and LU, 16 n^2
    bytes) fits the budget, or the Stepper takes the multifrontal solve
    ('auto' picks 'dense_lu' at this size and does not raise)."""
    import flowcontrol_tpu_torch.core.stepper as stepper_mod

    fs = CylT.make_default(Re=100, mesh=cylinder_mesh_t(**SMALL), path_out=tmp_path,
                           solver_backend=backend, device="cpu")
    n = fs.space.n_dofs
    for budget, fits in ((16 * n * n, True), (16 * n * n - 1, False)):
        monkeypatch.setattr(stepper_mod, "device_memory_budget_bytes", lambda device: budget)
        assert (stepper_mod.dense_lu_max_dofs_device("cpu") >= n) == fits
    assert fs._resolve_backend() == "dense_lu"
    fs._assign_steady_state(*base_flow)
    fs.initialize_time_stepping()
    fs._prepare_systems()
    assert fs._stepper._solver_kinds == ["multifrontal", "multifrontal"]
    y = fs.step(np.array([0.3, -0.2]))
    assert np.isfinite(y).all()


@pytest.mark.parametrize("free,reserved,allocated,fits_pinball", [
    (24.45 * 2**30, 0, 0, False),  # other solvers resident
    (84e9, 0, 0, True),  # a card holding nothing else
    (23e9, 61e9, 0.2e9, True),  # a dropped solver's blocks left in the cache
    (23e9, 61e9, 45e9, False),  # ... still held by a live one
])
def test_torch_stepper_dense_rule_counts_free_memory(monkeypatch, free, reserved, allocated,
                                                     fits_pinball):
    """On a card the dense rule sizes the f64 factorization against what is
    free, not the card's total: with 24.45 GiB free of an 80 GB H100's
    85.02 GB (other solvers resident) the pinball's 67,920 dofs no longer
    take the dense LU; on a card holding nothing else they still do. Blocks
    that PyTorch's caching allocator has reserved but does not use count as
    free (a dropped dense solver leaves its factorization there), blocks it
    has allocated do not. Counting the total allowed about 69,150 dofs in
    every case."""
    import flowcontrol_tpu_torch.core.stepper as stepper_mod

    total = 85.02e9
    monkeypatch.setattr(torch.cuda, "mem_get_info", lambda device=None: (int(free), int(total)))
    monkeypatch.setattr(torch.cuda, "memory_reserved", lambda device=None: int(reserved))
    monkeypatch.setattr(torch.cuda, "memory_allocated", lambda device=None: int(allocated))
    limit = stepper_mod.dense_lu_max_dofs_device("cuda")
    usable = int(free) + int(reserved) - int(allocated)
    assert limit == int((int(usable * 0.9) / 16) ** 0.5)
    assert (limit >= 67_920) == fits_pinball
    assert int((int(total * 0.9) / 16) ** 0.5) >= 67_920


@pytest.mark.parametrize("case", ["bdf", "bdf_borrowed"])
def test_torch_stepper_multifrontal_matches_jax(base_flow, tmp_path, monkeypatch, case):
    monkeypatch.setenv("FLOWCONTROL_TPU_FACTOR_CACHE", "off")
    if case == "bdf_borrowed":
        monkeypatch.setattr(StepperJ, "DENSE_TWO_FACTOR_MAX_N", 1000)
        monkeypatch.setattr(StepperT, "DENSE_TWO_FACTOR_MAX_N", 1000)
    fj, ft = _solvers(base_flow, tmp_path, "bdf", stepper_options={"force_substructure": True})
    sj, st = fj._stepper, ft._stepper
    expected = {"bdf": ["multifrontal", "multifrontal"],
                "bdf_borrowed": ["borrowed", "multifrontal"]}[case]
    assert sj._solver_kinds == expected and st._solver_kinds == expected
    assert sj._refine == 0 and st._refine == {}  # f64 factors: no sweep

    cj = {k: np.asarray(v) for k, v in fj._carry._asdict().items()}
    carry_j, carry_t = fj._carry, carry_from_numpy(cj, "cpu", torch.float64)
    step_j = sj.compiled_step()
    for k in range(10):
        u = np.array([0.3 * np.cos(k), -0.2 + 0.05 * k])
        carry_j, out_j = step_j(carry_j, u)
        carry_t, out_t = st.step(carry_t, u)
        assert _rel(out_t.x, out_j.x) <= TOL, k
        assert _rel(out_t.y, out_j.y) <= TOL, k
        assert abs(float(out_t.dE) - float(out_j.dE)) <= TOL * abs(float(out_j.dE)), k


def test_torch_stepper_multifrontal_refinement_sweep(base_flow, tmp_path, monkeypatch):
    """Every f32 multifrontal factor takes one refinement sweep: each step
    solves twice and stays within the f32 class of the f64 run."""
    from flowcontrol_tpu_torch.solvers.multifrontal import MultifrontalLU

    runs, solves = {}, [0]
    for prec in ("f64", "f32"):
        if prec == "f32":
            solve = MultifrontalLU.solve

            def counted(self, b):
                solves[0] += 1
                return solve(self, b)

            monkeypatch.setattr(MultifrontalLU, "solve", counted)
        fs = CylT.make_default(Re=100, mesh=cylinder_mesh_t(**SMALL), path_out=tmp_path,
                               precision=prec, device="cpu",
                               stepper_options={"force_substructure": True})
        fs._assign_steady_state(*base_flow)
        fs.initialize_time_stepping()
        for k in range(5):
            fs.step(np.array([0.3, -0.2]))
        runs[prec] = fs
    st = runs["f32"]._stepper
    assert st._solver_kinds == ["multifrontal", "multifrontal"]
    assert st._refine == {0: 1, 1: 1} and solves[0] == 2 * 5
    assert st._solvers[1].stages[0].inv.dtype == torch.float32
    err = np.linalg.norm(runs["f32"].fields.up_ - runs["f64"].fields.up_) / np.linalg.norm(
        runs["f64"].fields.up_
    )
    assert err <= 1e-4


@pytest.mark.parametrize("case", ["block", "block_borrowed"])
def test_torch_stepper_block_lu_matches_jax(base_flow, tmp_path, monkeypatch, case):
    """trisolve='cuda' above LAPACK_LU_MAX_N: a BlockLU factor (bs=256,
    n_pad=2816) solved through the K3 wrapper, against the JAX Stepper whose
    jitted step runs the TPU kernel in interpret mode."""
    from flowcontrol_tpu_torch.solvers.block_lu import BlockLU

    monkeypatch.setattr(StepperJ, "LAPACK_LU_MAX_N", 300)
    monkeypatch.setattr(StepperT, "LAPACK_LU_MAX_N", 300)
    if case == "block_borrowed":
        monkeypatch.setattr(StepperJ, "DENSE_TWO_FACTOR_MAX_N", 1000)
        monkeypatch.setattr(StepperT, "DENSE_TWO_FACTOR_MAX_N", 1000)
    fj, ft = _solvers(base_flow, tmp_path, "bdf",
                      opts_j={"trisolve": "pallas", "block_lu_bs": 256},
                      opts_t={"trisolve": "cuda", "block_lu_bs": 256})
    sj, st = fj._stepper, ft._stepper
    expected = {"block": ["block", "block"], "block_borrowed": ["borrowed", "block"]}[case]
    assert sj._solver_kinds == expected and st._solver_kinds == expected
    assert sj.trisolve == "pallas" and isinstance(st._solvers[-1], BlockLU)
    assert st._solvers[-1].bs == 256 and st._solvers[-1].n_pad == 2816 and st._refine == {}

    cj = {k: np.asarray(v) for k, v in fj._carry._asdict().items()}
    carry_j, carry_t = fj._carry, carry_from_numpy(cj, "cpu", torch.float64)
    step_j = sj.compiled_step()
    for k in range(5):
        u = np.array([0.3 * np.cos(k), -0.2 + 0.05 * k])
        carry_j, out_j = step_j(carry_j, u)
        carry_t, out_t = st.step(carry_t, u)
        assert _rel(out_t.x, out_j.x) <= TOL, k
        assert _rel(out_t.y, out_j.y) <= TOL, k
        assert abs(float(out_t.dE) - float(out_j.dE)) <= TOL * abs(float(out_j.dE)), k


def test_torch_stepper_trisolve_option():
    """Below LAPACK_LU_MAX_N the kind stays 'lapack' whatever trisolve says;
    an unknown value raises."""
    kw = dict(Re=100, mesh=cylinder_mesh_t(**SMALL), solver_backend="dense_lu",
              precision="f64", device="cpu")
    fs = CylT.make_default(stepper_options={"trisolve": "cuda"}, **kw)
    fs._assign_steady_state(np.zeros((fs.space.n_vnodes, 2)), np.zeros(fs.space.n_pressure_dofs))
    fs.initialize_time_stepping()
    assert fs.stepper._solver_kinds == ["lapack", "lapack"]
    bad = CylT.make_default(stepper_options={"trisolve": "xla"}, **kw)
    bad._assign_steady_state(fs.fields.U0, fs.fields.P0)
    bad.initialize_time_stepping()
    with pytest.raises(ValueError, match="trisolve"):
        bad._prepare_systems()


def _batch_of_states(up0):
    rng = np.random.default_rng(0)
    return np.stack([up0, up0 * 1.1, up0 * 0.5 + 1e-3 * rng.standard_normal(up0.shape)])


@pytest.mark.parametrize("kind", ["dense", "multifrontal"])
def test_torch_batched_rollout_matches_sequential_and_jax(base_flow, tmp_path, monkeypatch,
                                                          kind):
    """A batch of 3 distinct states with distinct controls: one batched
    rollout equals the three single-stream runs and the JAX batched
    rollout."""
    monkeypatch.setenv("FLOWCONTROL_TPU_FACTOR_CACHE", "off")
    extra = {"stepper_options": {"force_substructure": True}} if kind == "multifrontal" else {}
    fj, ft = _solvers(base_flow, tmp_path, "bdf", **extra)
    sj, st = fj._stepper, ft._stepper
    assert st._solver_kinds == [{"dense": "lapack"}.get(kind, kind)] * 2
    batch = _batch_of_states(np.asarray(fj._carry.u_n))
    u_seq = 0.1 * np.random.default_rng(1).standard_normal((4, 3, 2))

    carry_b = st.init_carry(batch)
    assert carry_b.u_n.shape == batch.shape and carry_b.u_ctrl_prev.shape == (3, 2)
    carry_b, outs = st.rollout_open_loop(carry_b, u_seq)
    assert outs.x is None and outs.y.shape == (4, 3, st.ns)
    assert outs.dE.shape == (4, 3) and outs.diverged.shape == (4, 3)
    assert not bool(outs.diverged.any()) and carry_b.it == 4

    for b in range(3):
        carry_1, outs_1 = st.rollout_open_loop(st.init_carry(batch[b]), u_seq[:, b])
        assert _rel(outs.y[:, b], outs_1.y) <= TOL, b
        assert _rel(outs.dE[:, b], outs_1.dE) <= TOL, b
        assert _rel(carry_b.u_n[b], carry_1.u_n) <= TOL, b

    import jax.numpy as jnp

    carry_j, outs_j = sj.make_rollout_open_loop()(sj.init_carry(jnp.asarray(batch)), u_seq)
    assert _rel(outs.y, outs_j.y) <= TOL and _rel(outs.dE, outs_j.dE) <= TOL
    assert _rel(carry_b.u_n, carry_j.u_n) <= TOL
    assert _rel(carry_b.u_ctrl_prev, carry_j.u_ctrl_prev) <= TOL


def _controller_mats():
    return dict(A=np.array([[-1.0, 0.5], [0.0, -2.0]]), B=np.array([[1.0], [0.5]]),
                C=np.array([[0.3, 0.1], [-0.2, 0.05]]), D=np.array([[0.05], [0.02]]))


@pytest.mark.parametrize("stacked", [False, True], ids=["single", "stack_of_3"])
def test_torch_rollout_closed_loop_matches_jax_and_python_loop(base_flow, tmp_path, stacked):
    """The fused plant + controller rollout against the JAX one and against
    the lockstep loop ``u = K.step(-y, dt); y = fs.step(u)`` of the port's
    own Controller (sensor 1 fed back). With a stack of 3 controllers
    (gains 0.5, 1, 1.5) and a batched carry, each member equals its own
    lockstep loop."""
    from flowcontrol_tpu.core.controller import Controller as ControllerJ
    from flowcontrol_tpu_torch.core.controller import Controller as ControllerT
    from flowcontrol_tpu_torch.core.controller import stack_controllers

    n_steps, gains = 5, ([0.5, 1.0, 1.5] if stacked else [1.0])
    fj, ft = _solvers(base_flow, tmp_path, "bdf")
    sj, st = fj._stepper, ft._stepper
    dt = ft.params_time.dt
    up0 = np.asarray(fj._carry.u_n) + 1e-2 * np.random.default_rng(2).standard_normal(
        st.space.n_dofs)
    sel = np.zeros((1, st.ns))
    sel[0, 0] = 1.0

    def k_mats_of(controllers):
        ad, bd, cd, dd = stack_controllers(controllers, dt, dtype=np.float64)
        mats = (ad, bd @ sel, cd, dd @ sel)
        return mats if stacked else tuple(m[0] for m in mats)

    kts = [g * ControllerT.from_matrices(**_controller_mats()) for g in gains]
    kjs = [g * ControllerJ.from_matrices(**_controller_mats()) for g in gains]
    for got, ref in zip(k_mats_of(kts), k_mats_of(kjs)):
        assert np.array_equal(got, ref)
    ups = np.stack([up0 * (1.0 + 0.1 * i) for i in range(len(gains))])
    ups = ups if stacked else ups[0]
    y0 = ups @ np.asarray(st.c_rows).T

    carry, (ys, des, us, divs) = st.rollout_closed_loop(
        st.init_carry(ups), k_mats_of(kts), y0, n_steps, feedback_sign=-1.0)
    lead = (n_steps, len(gains)) if stacked else (n_steps,)
    assert ys.shape == lead + (st.ns,) and us.shape == lead + (st.n_act,)
    assert des.shape == lead and divs.shape == lead and not bool(divs.any())

    import jax.numpy as jnp

    carry_j, (ys_j, des_j, us_j, _) = sj.rollout_closed_loop(
        sj.init_carry(jnp.asarray(ups)), k_mats_of(kjs), y0, n_steps, feedback_sign=-1.0)
    assert _rel(ys, ys_j) <= TOL and _rel(us, us_j) <= TOL and _rel(des, des_j) <= TOL
    assert _rel(carry.u_n, carry_j.u_n) <= TOL

    # the lockstep Python loop, member by member, through the port's step
    for i, k in enumerate(kts):
        up_i = ups[i] if stacked else ups
        c = st.init_carry(up_i)
        y = up_i @ np.asarray(st.c_rows).T
        k.reset()
        for t in range(n_steps):
            u = k.step(-y[:1], dt)
            c, out = st.step(c, u)
            y = out.y.numpy()
            got_y, got_u = (ys[t, i], us[t, i]) if stacked else (ys[t], us[t])
            assert _rel(got_u, u) <= TOL and _rel(got_y, y) <= TOL, (i, t)
