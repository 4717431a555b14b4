"""Controller synthesis and the population search, the slice as a whole,
against the JAX package on the CPU in float64.

On the small cylinder (2,575 dofs) with its Picard + Newton base flow
(computed by the port, carried to the JAX solver), both solvers on the host
LU from the same initial condition (``initialize_time_stepping``):

- one reduced model (the port's ``modal_rom`` at σ = 0.1 + 0.8j, two
  eigenpairs) fed to both packages' ``lqg_regulator`` over the example's
  grid qx in {0.1, 1, 10}: equal compensators to 1e-10;
- the three compensators stacked (each package's ``stack_controllers``) as
  a B = 3 closed loop: the JAX package's ``make_rollout_closed_loop``
  against the port's ``closed_loop_fn``, y, u and dE to 1e-10;
- a 2-generation, popsize-8 ``'pop'`` search through each package's
  ``minimize`` on its own rollout (the port's ``lqg_population_cost``; the
  same cost built from the JAX package's parts): equal costs to 1e-10 in
  every generation and the same ``res.x``;
- each package's own reduced model (ARPACK's start vector differs between
  calls and packages, so only what does not depend on the eigenvectors'
  phase is compared): equal poles, and H(jω) at three ω, to 1e-8;
- a second rollout call with new controllers gives what an eager loop of
  ``Stepper.step`` with them gives (the rollout copies its inputs into its
  fixed buffers on every call);
- the operators' B acts as the Stepper's u (same sign), so the sign read
  off the ROM's closed loop is the one the rollout needs.

And the port's copy of ``examples/synthesize_controller.py`` runs with
``device="cpu"``.
"""

import numpy as np
import pytest
import torch
from threadpoolctl import threadpool_limits

import flowcontrol_tpu.utils.lticontrol as ltc_j
import flowcontrol_tpu.utils.optim as optim_j
import flowcontrol_tpu.utils.optim_algs as algs_j
import flowcontrol_tpu_torch.utils.lticontrol as ltc_t
import flowcontrol_tpu_torch.utils.optim_algs as algs_t
from flowcontrol_tpu.core.controller import Controller as ControllerJ
from flowcontrol_tpu.core.controller import stack_controllers as stack_j
from flowcontrol_tpu.core.operatorgetter import OperatorGetter as OperatorGetterJ
from flowcontrol_tpu.mesh.generation import cylinder_mesh as cylinder_mesh_j
from flowcontrol_tpu.models.cylinder import CylinderFlowSolver as CylJ
from flowcontrol_tpu.utils.linalg import modal_rom as modal_rom_j
from flowcontrol_tpu.utils.statespace import StateSpace as SSJ
from flowcontrol_tpu_torch.core.controller import Controller as ControllerT
from flowcontrol_tpu_torch.core.controller import stack_controllers as stack_t
from flowcontrol_tpu_torch.core.operatorgetter import OperatorGetter as OperatorGetterT
from flowcontrol_tpu_torch.examples.synthesize_controller import lqg_population_cost
from flowcontrol_tpu_torch.mesh.generation import cylinder_mesh as cylinder_mesh_t
from flowcontrol_tpu_torch.models.cylinder import CylinderFlowSolver as CylT
from flowcontrol_tpu_torch.utils.linalg import modal_rom as modal_rom_t

torch.set_num_threads(1)

SMALL = dict(yinf=3.0, xinf=8.0, xinfa=-3.0, n1=2.0, n2=1.0, n3=0.5, segments=40)
SIGMA = 0.1 + 0.8j
GRID = (0.1, 1.0, 10.0)
STEPS = 12
SIGN = 1.0  # lqg_regulator's compensator takes +y
TOL = 1e-10


@pytest.fixture(scope="module", autouse=True)
def one_blas_thread():
    """One BLAS thread (ARPACK, the dense algebra), as torch gets one: the
    suite runs beside other test workers, and spinning BLAS threads of
    several processes on the same cores slow each other many times over."""
    with threadpool_limits(limits=1):
        yield


def _rel(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return np.abs(a - b).max() / max(np.abs(b).max(), 1e-300)


@pytest.fixture(scope="module")
def flows(tmp_path_factory):
    """(JAX solver, port solver) on the small mesh, f64 host LU, one base
    flow, time stepping initialized; the port's A, E, B, C."""
    kw = dict(Re=100, num_steps=STEPS, verbose=0, solver_backend="host_lu", precision="f64")
    ft = CylT.make_default(mesh=cylinder_mesh_t(**SMALL), path_out=tmp_path_factory.mktemp("t"),
                           device="cpu", **kw)
    ft.compute_steady_state(u_ctrl=[0.0, 0.0], method="picard", max_iter=3)
    ft.compute_steady_state(u_ctrl=[0.0, 0.0], method="newton", initial_guess=ft.fields.UP0)
    fj = CylJ.make_default(mesh=cylinder_mesh_j(**SMALL), path_out=tmp_path_factory.mktemp("j"),
                           **kw)
    fj._assign_steady_state(ft.fields.U0, ft.fields.P0)
    ops = OperatorGetterT(ft).get_all(autodiff=False)
    for fs in (fj, ft):
        fs.initialize_time_stepping()
        fs._prepare_systems()
    assert np.array_equal(np.asarray(fj._carry.u_n), ft._carry.u_n.numpy())
    return fj, ft, ops


@pytest.fixture(scope="module")
def rom(flows):
    rom_t, kept = modal_rom_t(*flows[2], shifts=(SIGMA,), k_per_shift=2)
    assert rom_t.nstates == 4 and len(kept) == 2
    return rom_t


def _as_jax(ss):
    return SSJ(ss.A, ss.B, ss.C, ss.D)


def _candidates(ltc, ctrl, rom):
    return [ctrl(k.A, k.B, k.C, k.D)
            for k in (ltc.lqg_regulator(rom, qx, 1.0, 1.0, 1.0)[0] for qx in GRID)]


@pytest.mark.parametrize("qx", GRID)
def test_torch_synthesis_lqg_on_one_rom_matches_jax(rom, qx):
    got = ltc_t.lqg_regulator(rom, qx, 1.0, 1.0, 1.0)
    want = ltc_j.lqg_regulator(_as_jax(rom), qx, 1.0, 1.0, 1.0)
    for k in "ABCD":
        assert _rel(getattr(got[0], k), getattr(want[0], k)) <= TOL, k
    assert _rel(got[1], want[1]) <= TOL and _rel(got[2], want[2]) <= TOL
    # the compensator takes +y: it stabilizes the ROM with +1, not with -1
    assert ltc_t.isstablecl(rom, got[0], sign=+1) and not ltc_t.isstablecl(rom, got[0], sign=-1)


def _batched(fj, ft, batch):
    import jax.numpy as jnp

    up = ft._carry.u_n.numpy()
    y0 = np.repeat(np.asarray(ft.y_meas)[None], batch, 0)
    ups = np.repeat(up[None], batch, 0)
    return (fj._stepper.init_carry(jnp.asarray(ups)), ft.stepper.init_carry(ups), y0)


def test_torch_synthesis_b3_closed_loop_matches_jax(flows, rom):
    fj, ft, _ = flows
    dt = ft.params_time.dt
    carry_j, carry_t, y0 = _batched(fj, ft, len(GRID))
    k_j = stack_j(_candidates(ltc_j, ControllerJ, _as_jax(rom)), dt, dtype=np.float64)
    k_t = stack_t(_candidates(ltc_t, ControllerT, rom), dt, dtype=np.float64)
    for a, b in zip(k_t, k_j):
        assert _rel(a, b) <= TOL
    cj, (ys_j, des_j, us_j, _) = fj._stepper.make_rollout_closed_loop(STEPS, SIGN)(carry_j, k_j,
                                                                                   y0)
    ct, (ys, des, us, div) = ft.stepper.closed_loop_fn(STEPS, SIGN)(carry_t, k_t, y0)
    assert ys.shape == (STEPS, 3, 3) and us.shape == (STEPS, 3, 2) and not bool(div.any())
    assert _rel(ys, ys_j) <= TOL and _rel(us, us_j) <= TOL and _rel(des, des_j) <= TOL
    assert _rel(ct.u_n, cj.u_n) <= TOL
    assert float((us[:, 0] - us[:, 2]).abs().max()) > 0


def _jax_population_cost(fj, carry, y0, rom, dt):
    """lqg_population_cost's cost, built from the JAX package's parts."""
    roll = fj._stepper.make_rollout_closed_loop(STEPS, SIGN)
    n, m, p = rom.nstates, rom.ninputs, rom.noutputs
    zero = ControllerJ(np.zeros((n, n)), np.zeros((n, p)), np.zeros((m, n)), np.zeros((m, p)))

    def cost(thetas):
        ks, failed = [], []
        for th in thetas:
            try:
                k = ltc_j.lqg_regulator(rom, *(10.0 ** th))[0]
                ks.append(ControllerJ(k.A, k.B, k.C, k.D))
                failed.append(False)
            except (np.linalg.LinAlgError, ValueError):
                ks.append(zero)
                failed.append(True)
        _, (ys, _, us, div) = roll(carry, stack_j(ks, dt, dtype=np.float64), y0)
        ys, us = np.asarray(ys), np.asarray(us)
        c = np.array([optim_j.compute_signal_cost((ys[:, i] ** 2).sum(-1), dt, "integral")
                      + optim_j.compute_control_cost(us[:, i], dt) for i in range(len(ks))])
        bad = np.asarray(failed) | np.asarray(div).any(0) | ~np.isfinite(c)
        return np.where(bad, np.inf, c)

    return cost


def test_torch_synthesis_population_search_matches_jax(flows, rom):
    fj, ft, _ = flows
    dt, pop = ft.params_time.dt, 8
    carry_j, carry_t, y0 = _batched(fj, ft, pop)
    seen = {"t": [], "j": []}

    def recorded(key, cost):
        def f(thetas):
            seen[key].append((np.array(thetas), cost(thetas)))
            return seen[key][-1][1]
        return f

    opts = {"n_iter": 2, "popsize": pop, "sigma0": 0.5, "seed": 0}
    cost_t = lqg_population_cost(ft.stepper.closed_loop_fn(STEPS, SIGN), carry_t, y0, rom, dt,
                                 dtype=np.float64)
    res_t = algs_t.minimize(None, np.zeros(4), "pop", opts, verbose=False,
                            batch_costfun=recorded("t", cost_t))
    res_j = algs_j.minimize(None, np.zeros(4), "pop", opts, verbose=False,
                            batch_costfun=recorded("j", _jax_population_cost(
                                fj, carry_j, y0, _as_jax(rom), dt)))
    assert len(seen["t"]) == len(seen["j"]) == 2
    for (th_t, c_t), (th_j, c_j) in zip(seen["t"], seen["j"]):
        assert np.array_equal(th_t, th_j)
        assert np.isfinite(c_t).all() and _rel(c_t, c_j) <= TOL
    assert np.array_equal(res_t.x, res_j.x) and _rel(res_t.fun, res_j.fun) <= TOL
    assert len(np.unique(seen["t"][0][1])) == pop  # the candidates differ


def test_torch_synthesis_population_cost_failed_candidate(flows, rom, monkeypatch):
    """A candidate whose Riccati solve raises scores +inf and keeps its
    slot with a zero controller; the others keep their costs."""
    fj, ft, _ = flows
    dt = ft.params_time.dt
    _, carry_t, y0 = _batched(fj, ft, 2)
    cost = lqg_population_cost(ft.stepper.closed_loop_fn(STEPS, SIGN), carry_t, y0, rom, dt,
                               dtype=np.float64)
    thetas = np.array([[0.0, 0.0, 0.0, 0.0], [1.0, 0.0, 0.0, 0.0]])
    ok = cost(thetas)
    real = ltc_t.lqg_regulator

    def fails_at_qx_10(g, qx, *w):
        if qx == 10.0:
            raise np.linalg.LinAlgError("no stabilizing solution")
        return real(g, qx, *w)

    monkeypatch.setattr(ltc_t, "lqg_regulator", fails_at_qx_10)
    got = cost(thetas)
    assert got[0] == ok[0] and np.isinf(got[1]) and np.isfinite(ok[1])


def test_torch_synthesis_operator_b_acts_as_the_stepper_u(flows):
    """The feedback sign read off the ROM holds for the Stepper only if the
    operators' B acts as the Stepper's u: one step from rest with a small u
    against the implicit-Euler step of E x' = A x + B u, y of the same sign
    and within 20% (the Stepper lifts the actuators' Dirichlet values)."""
    import scipy.sparse.linalg as spla

    _, ft, (a, e, b, c) = flows
    st, dt = ft.stepper, ft.params_time.dt
    for u in 1e-6 * np.eye(2):
        _, out = st.step(st.init_carry(np.zeros(ft.space.n_dofs)), u)
        y, y_lin = out.y.numpy(), c @ spla.spsolve((e / dt - a).tocsc(), b @ u)
        assert np.array_equal(np.sign(y), np.sign(y_lin))
        assert np.abs(y - y_lin).max() <= 0.2 * np.abs(y_lin).max()


def test_torch_synthesis_own_roms_match_jax(flows):
    """Each package's own ROM: poles and H(jω) to 1e-8 (phase-invariant)."""
    fj, ft, ops_t = flows
    ops_j = OperatorGetterJ(fj).get_all(autodiff=False)
    rom_t, kept_t = modal_rom_t(*ops_t, shifts=(SIGMA,), k_per_shift=2)
    rom_j, kept_j = modal_rom_j(*ops_j, shifts=(SIGMA,), k_per_shift=2)
    assert _rel(kept_t, kept_j) <= 1e-8
    poles_t, poles_j = (np.sort_complex(np.linalg.eigvals(r.A)) for r in (rom_t, rom_j))
    assert np.abs(poles_t - poles_j).max() <= 1e-8 * np.abs(poles_j).max()
    ww = np.array([0.1, 0.8, 2.0])
    # every kept mode is a complex pair here, whose block does not depend on
    # the eigenvectors' phase
    h_t, h_j = rom_t.frequency_response(ww), rom_j.frequency_response(ww)
    assert np.abs(h_t - h_j).max() <= 1e-8 * np.abs(h_j).max()


def test_torch_synthesis_rollout_reads_new_controllers(flows, rom):
    """A second call of one rollout with other controllers gives what an
    eager loop of Stepper.step with them gives."""
    fj, ft, _ = flows
    st, dt = ft.stepper, ft.params_time.dt
    _, carry, y0 = _batched(fj, ft, 2)
    roll = st.closed_loop_fn(STEPS, SIGN)
    first = stack_t(_candidates(ltc_t, ControllerT, rom)[:2], dt, dtype=np.float64)
    second = stack_t(_candidates(ltc_t, ControllerT, rom)[1:], dt, dtype=np.float64)
    _, (ys1, _, _, _) = roll(carry, first, y0)
    c2, (ys2, des2, us2, _) = roll(carry, second, y0)
    ad, bd, cd, dd = (torch.as_tensor(m) for m in second)
    c, y, xk = carry, torch.as_tensor(y0), torch.zeros(ad.shape[:-1], dtype=torch.float64)
    ys, des, us = [], [], []

    def mv(a, v):
        return torch.einsum("...ij,...j->...i", a, v)

    for _ in range(STEPS):
        u = mv(cd, xk) + mv(dd, SIGN * y)
        xk = mv(ad, xk) + mv(bd, SIGN * y)
        c, out = st.step(c, u)
        y = out.y
        ys.append(y)
        des.append(out.dE)
        us.append(u)
    assert torch.equal(ys2, torch.stack(ys)) and torch.equal(us2, torch.stack(us))
    assert torch.equal(des2, torch.stack(des)) and torch.equal(c2.u_n, c.u_n)
    assert float((ys1 - ys2).abs().max()) > 0


def test_torch_synthesize_controller_example_runs_on_cpu(tmp_path, monkeypatch):
    from flowcontrol_tpu_torch.examples import synthesize_controller

    monkeypatch.chdir(tmp_path)
    costs = synthesize_controller.main(num_steps=5, device="cpu")
    assert costs.shape == (3,) and np.isfinite(costs).all()
