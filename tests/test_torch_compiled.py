"""The port's compiled entry points against the JAX package's, on the CPU.

``Stepper.compiled_step``, ``make_rollout_open_loop(with_state)`` (and
``rollout_open_loop(..., with_state)``), ``make_rollout_closed_loop`` and
``closed_loop_fn`` of both packages, and ``FlowSolver.step``, which runs the
compiled step, take the same seeded numpy inputs (states, controls,
controller matrices) on the small generated cylinder of
``tests/test_torch_stepper.py`` (2,575 dofs), dense LU, float64, BDF1 then
BDF2: states, carries, y, dE and u agree to 1e-10 relative. On the CPU the
compiled step is the eager step and the rollouts run their captured bodies
eagerly over the static carry, so these tests also hold the static carry's
bookkeeping (copied in once, out once, skipped when a rollout continues from
the carry the last one returned, returned carries kept as values) to the
JAX package's scan. The CUDA graphs themselves are held to the eager step on
the card (``tests/test_torch_cuda.py``).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from flowcontrol_tpu.mesh.generation import cylinder_mesh as cylinder_mesh_j
from flowcontrol_tpu.models.cylinder import CylinderFlowSolver as CylJ
from flowcontrol_tpu_torch.core.stepper import carry_to_numpy
from flowcontrol_tpu_torch.mesh.generation import cylinder_mesh as cylinder_mesh_t
from flowcontrol_tpu_torch.models.cylinder import CylinderFlowSolver as CylT

torch.set_num_threads(1)

SMALL = dict(yinf=3.0, xinf=8.0, xinfa=-3.0, n1=2.0, n2=1.0, n3=0.5, segments=40)
TOL = 1e-10
CARRY_FIELDS = ("u_n", "u_nn", "mu_n", "mu_nn", "n_prev", "u_ctrl_prev")


def _pair(base, path, **kw):
    """The two packages' cylinder solvers, f64 dense LU, prepared from one
    base flow."""
    opts = dict(Re=100, num_steps=5, solver_backend="dense_lu", precision="f64", **kw)
    fj = CylJ.make_default(mesh=cylinder_mesh_j(**SMALL), path_out=path / "j", **opts)
    ft = CylT.make_default(mesh=cylinder_mesh_t(**SMALL), path_out=path / "t", device="cpu",
                           **opts)
    for fs in (fj, ft):
        fs._assign_steady_state(*base)
        fs.initialize_time_stepping()
        fs._prepare_systems()
    return fj, ft


@pytest.fixture(scope="module")
def base(tmp_path_factory):
    """The base flow (U0, P0), by the port on the host in float64."""
    fs = CylT.make_default(Re=100, mesh=cylinder_mesh_t(**SMALL), solver_backend="host_lu",
                           precision="f64", device="cpu", path_out=tmp_path_factory.mktemp("bf"))
    fs.compute_steady_state(u_ctrl=[0.0, 0.0], method="picard", max_iter=3)
    fs.compute_steady_state(u_ctrl=[0.0, 0.0], method="newton",
                            initial_guess=fs.fields.UP0, max_iter=10)
    return fs.fields.U0.copy(), fs.fields.P0.copy()


@pytest.fixture(scope="module")
def steppers(base, tmp_path_factory):
    fj, ft = _pair(base, tmp_path_factory.mktemp("pair"))
    up0 = np.asarray(fj._carry.u_n)
    return fj._stepper, ft._stepper, up0


def _rel(a, b):
    a, b = np.asarray(a, dtype=np.float64), np.asarray(b, dtype=np.float64)
    return np.abs(a - b).max() / max(np.abs(b).max(), 1e-300)


def _states(up0, batch, seed):
    """A single state or ``batch`` distinct ones: the initial state plus
    seeded noise."""
    rng = np.random.default_rng(seed)
    lead = () if batch is None else (batch,)
    return up0 + 1e-2 * rng.standard_normal(lead + up0.shape)


def _assert_carries(ct, cj, it):
    got = carry_to_numpy(ct)
    for f in CARRY_FIELDS:
        assert _rel(got[f], np.asarray(getattr(cj, f))) <= TOL, f
    assert ct.it == int(cj.it) == it


def test_torch_compiled_step_matches_jax(steppers):
    """The compiled step (on the CPU: the eager step) against the JAX
    package's jitted step, BDF1 then BDF2."""
    sj, st, up0 = steppers
    step_t, step_j = st.compiled_step(), sj.compiled_step()
    assert step_t == st.step
    ups = _states(up0, None, 0)
    carry_t, carry_j = st.init_carry(ups), sj.init_carry(ups)
    u_seq = 0.1 * np.random.default_rng(1).standard_normal((4, 2))
    for k, u in enumerate(u_seq):
        carry_j, out_j = step_j(carry_j, u)
        carry_t, out_t = step_t(carry_t, u)
        assert _rel(out_t.x, out_j.x) <= TOL and _rel(out_t.y, out_j.y) <= TOL, k
        assert _rel(out_t.dE, out_j.dE) <= TOL and not bool(out_t.diverged), k
        _assert_carries(carry_t, carry_j, k + 1)


@pytest.mark.parametrize("batch", [None, 3], ids=["single", "batch_of_3"])
@pytest.mark.parametrize("with_state", [False, True])
def test_torch_rollout_open_loop_compiled_matches_jax(steppers, with_state, batch):
    """make_rollout_open_loop(with_state) against the JAX package's, from
    it = 0 (the first step eager, then the program) and continued from the
    returned carry (the static carry already holds it): y, dE, diverged
    and, with the state, x stacked over T. A carry held across the second
    rollout keeps its values."""
    sj, st, up0 = steppers
    ups = _states(up0, batch, 2)
    lead = () if batch is None else (batch,)
    u_seq = 0.1 * np.random.default_rng(3).standard_normal((2, 4) + lead + (2,))
    roll_t, roll_j = st.make_rollout_open_loop(with_state), sj.make_rollout_open_loop(with_state)
    carry_t, carry_j = st.init_carry(ups), sj.init_carry(jnp.asarray(ups))
    for leg in range(2):
        carry_t, outs_t = roll_t(carry_t, u_seq[leg])
        carry_j, outs_j = roll_j(carry_j, u_seq[leg])
        assert outs_t.y.shape == (4,) + lead + (st.ns,) and outs_t.dE.shape == (4,) + lead
        assert _rel(outs_t.y, outs_j.y) <= TOL and _rel(outs_t.dE, outs_j.dE) <= TOL, leg
        assert np.array_equal(outs_t.diverged.numpy(), np.asarray(outs_j.diverged))
        if with_state:
            assert outs_t.x.shape == (4,) + lead + (st.space.n_dofs,)
            assert _rel(outs_t.x, outs_j.x) <= TOL, leg
        else:
            assert outs_t.x is None and outs_j.x is None
        _assert_carries(carry_t, carry_j, 4 * (leg + 1))
        if leg == 0:
            held = {f: getattr(carry_t, f).clone() for f in CARRY_FIELDS}
            first = carry_t
    for f in CARRY_FIELDS:
        assert torch.equal(getattr(first, f), held[f]), f
    # rollout_open_loop is the same rollout
    again, outs = st.rollout_open_loop(first, u_seq[1], with_state=with_state)
    assert torch.equal(outs.y, outs_t.y) and torch.equal(again.u_n, carry_t.u_n)
    assert (outs.x is None) == (not with_state)


def _controllers(st, stacked, seed=4):
    """Seeded discrete controller matrices (Ad, Bd, Cd, Dd): two states fed
    by every sensor, driving both actuators; a stack of 3 or one."""
    rng = np.random.default_rng(seed)
    lead = (3,) if stacked else ()
    ad = 0.9 * np.eye(2) + 0.05 * rng.standard_normal(lead + (2, 2))
    bd = 0.1 * rng.standard_normal(lead + (2, st.ns))
    cd = 0.2 * rng.standard_normal(lead + (st.n_act, 2))
    dd = 0.05 * rng.standard_normal(lead + (st.n_act, st.ns))
    return ad, bd, cd, dd


@pytest.mark.parametrize("stacked", [False, True], ids=["single", "stack_of_3"])
@pytest.mark.parametrize("entry", ["make_rollout_closed_loop", "closed_loop_fn"])
def test_torch_closed_loop_compiled_matches_jax(steppers, entry, stacked):
    """The fused plant + controller rollout through ``entry`` against the
    JAX package's function of that name (its closed_loop_fn takes the
    device tables first), single and with a stack of 3 controllers on a
    batched carry: y, dE, u and the final carry; twice, the second
    continuing from the first's carry."""
    sj, st, up0 = steppers
    k_mats = _controllers(st, stacked)
    ups = _states(up0, 3 if stacked else None, 5)
    y0 = ups @ np.asarray(st.c_rows).T
    fn_t, fn_j = getattr(st, entry)(4, -1.0), getattr(sj, entry)(4, -1.0)
    if entry == "closed_loop_fn":
        fn_j = (lambda f: lambda c, k, y: f(sj._dev, c, k, y))(fn_j)
    carry_t, carry_j = st.init_carry(ups), sj.init_carry(jnp.asarray(ups))
    lead = (4, 3) if stacked else (4,)
    for leg in range(2):
        carry_t, (ys, des, us, divs) = fn_t(carry_t, k_mats, y0)
        carry_j, (ys_j, des_j, us_j, divs_j) = fn_j(carry_j, k_mats, y0)
        assert ys.shape == lead + (st.ns,) and us.shape == lead + (st.n_act,)
        assert des.shape == lead and not bool(divs.any())
        assert _rel(ys, ys_j) <= TOL and _rel(us, us_j) <= TOL and _rel(des, des_j) <= TOL, leg
        _assert_carries(carry_t, carry_j, 4 * (leg + 1))


def test_torch_flowsolver_step_compiled_matches_jax(base, tmp_path):
    """FlowSolver.step runs the compiled step (on the CPU the eager one)
    and matches the JAX package's FlowSolver.step: y and the mixed state of
    every step, with a control."""
    fj, ft = _pair(base, tmp_path)
    assert ft._step_compiled == ft._stepper.step
    for k in range(4):
        u = np.array([0.3 * np.cos(k), -0.2 + 0.05 * k])
        y_j, y_t = fj.step(u), ft.step(u)
        assert _rel(y_t, y_j) <= TOL, k
        assert _rel(ft.fields.up_, fj.fields.up_) <= TOL, k
    assert ft._carry.it == int(fj._carry.it) == 4


def test_torch_k3_schedule_cache_keeps_every_schedule():
    """K3's panel schedules on the device are never evicted: a CUDA graph
    of a panel launch reads the one it captured."""
    from flowcontrol_tpu_torch.ops.trisolve import _schedule_on

    cpu = torch.device("cpu")
    first = _schedule_on(2, 2, 1, cpu)
    for nb in range(3, 15):
        _schedule_on(nb, 2, 1, cpu)
    assert _schedule_on(2, 2, 1, cpu) is first


@pytest.mark.parametrize("batch", [1, 3])
def test_torch_csr_matmul_matches_jax_mass_apply(steppers, batch):
    """S's wrapper (on the CPU its plain version), the batched step's mass
    apply, against the JAX Stepper's mass apply on the same seeded batch."""
    from flowcontrol_tpu_torch.ops.spmm import csr_matmul

    sj, st, up0 = steppers
    x = np.random.default_rng(6).standard_normal((batch, up0.shape[0]))
    before = csr_matmul.launches
    got = csr_matmul(st._dev["m"], torch.as_tensor(x))
    assert csr_matmul.launches == before  # the plain version launches nothing
    assert got.shape == x.shape
    assert _rel(got, sj._apply(sj._dev, "m", jnp.asarray(x))) <= 1e-12


def test_torch_closed_loop_programs_keep_their_feedback_sign(steppers):
    """Two closed loops of the same shapes and opposite feedback signs on
    one Stepper (the sign is a constant of the captured body) each match
    the JAX package's with that sign."""
    sj, st, up0 = steppers
    k_mats = _controllers(st, False, seed=8)
    ups = _states(up0, None, 9)
    y0 = ups @ np.asarray(st.c_rows).T
    for sign in (-1.0, 1.0):
        _, (ys, _, us, _) = st.make_rollout_closed_loop(3, sign)(st.init_carry(ups), k_mats, y0)
        _, (ys_j, _, us_j, _) = sj.make_rollout_closed_loop(3, sign)(
            sj.init_carry(jnp.asarray(ups)), k_mats, y0)
        assert _rel(ys, ys_j) <= TOL and _rel(us, us_j) <= TOL, sign
