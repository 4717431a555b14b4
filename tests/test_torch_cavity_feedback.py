"""The open cavity's closed loop (the synthesis tool and the example) against
the JAX package on the CPU in float64.

On the small cavity mesh (``SMALL``, as in tests/test_torch_cavity.py) with
one Picard + one Newton iterate computed by the port and carried to the JAX
solver, host LU, both packages' solvers on the same base flow:

- A, E, B and C from the tool's ``operators`` against the JAX package's
  ``OperatorGetter.get_all(autodiff=False, u_ctrl=[0.0])``: 1e-10;
- one ROM (``build_rom`` at a shift placed on the small mesh's own scan)
  fed to the tool's ``design_lqg`` and to the JAX package's
  ``dlqg_regulator`` with the JAX tool's weights, composed here as it
  composes them: compensators to 1e-10, the sampled radius (``certify``
  against the JAX tool's M) to 1e-12, the ROM energy ratios to 1e-10;
- each package's own ROM (ARPACK's start vector differs between packages,
  so only what does not depend on the eigenvectors' phase): poles and
  H(jω) at three ω to 1e-8; ``leading_mode``'s λ to 1e-8 and
  |v_tᴴ v_j| within 1e-8 of 1;
- the example, open and closed, 5 steps, against the JAX example's loop
  composed line by line (the same initial condition and the same ``.mat``,
  read by the JAX ``Controller.from_file``): y, u and dE to 1e-10; the
  fused ``closed_loop_fn(5, feedback_sign=+1.0)`` against the example's
  eager loop to 1e-10;
- the operators' B acts as the Stepper's u, with the same sign.

And the committed files at the default mesh (120,068 dofs): their checksum
is the default mesh's, another mesh is refused, the compensator closes the
ROM with a sampled radius below 1, and both packages read the same
discrete compensator at dt = 4e-4.
"""

import numpy as np
import pytest
import scipy.io as sio
import torch
from threadpoolctl import threadpool_limits

from flowcontrol_tpu.core.controller import Controller as ControllerJ
from flowcontrol_tpu.core.operatorgetter import OperatorGetter as OperatorGetterJ
from flowcontrol_tpu.mesh.generation import cavity_mesh as cavity_mesh_j
from flowcontrol_tpu.models.cavity import CavityFlowSolver as CavJ
from flowcontrol_tpu.utils.linalg import get_mat_vp_shift_invert as eigs_j
from flowcontrol_tpu.utils.linalg import modal_rom as modal_rom_j
from flowcontrol_tpu.utils.lticontrol import dlqg_regulator as dlqg_j
from flowcontrol_tpu.utils.statespace import StateSpace as SSJ
from flowcontrol_tpu_torch.core.controller import Controller as ControllerT
from flowcontrol_tpu_torch.examples import run_cavity_feedback as example
from flowcontrol_tpu_torch.mesh.generation import cavity_mesh as cavity_mesh_t
from flowcontrol_tpu_torch.models.baseflows import mesh_checksum
from flowcontrol_tpu_torch.models.cavity import (
    CavityFlowSolver as CavT,
    cavity_feedback_files,
    load_cavity_controller,
    load_cavity_mode,
)
from flowcontrol_tpu_torch.tools import cavity_feedback_synth as synth

torch.set_num_threads(1)

SMALL = dict(n_coarse=6, n_mid=12, n_fine=25)
SCAN_SIGMA = 0.5 + 12.5j  # one scan shift: the small mesh's unstable pair near 0.87 + 12.48j
STEPS = 5
TOL = 1e-10
DEFAULT_DOFS = 120_068


@pytest.fixture(scope="module", autouse=True)
def one_blas_thread():
    """One BLAS thread (ARPACK, scipy's dense algebra), as torch gets one."""
    with threadpool_limits(limits=1):
        yield


def _rel(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return np.abs(a - b).max() / max(np.abs(b).max(), 1e-300)


@pytest.fixture(scope="module")
def flows(tmp_path_factory):
    """(JAX solver, port solver, the port's A, E, B, C, the base flow's
    .npz) on the small mesh, f64 host LU, one base flow."""
    kw = dict(Re=7500, num_steps=STEPS, verbose=0, solver_backend="host_lu", precision="f64")
    ft = CavT.make_default(mesh=cavity_mesh_t(**SMALL), path_out=tmp_path_factory.mktemp("t"),
                           device="cpu", **kw)
    ft.compute_steady_state(u_ctrl=[0.0], method="picard", max_iter=1)
    ft.compute_steady_state(u_ctrl=[0.0], method="newton", max_iter=1, initial_guess=ft.fields.UP0)
    fj = CavJ.make_default(mesh=cavity_mesh_j(**SMALL), path_out=tmp_path_factory.mktemp("j"), **kw)
    fj._assign_steady_state(ft.fields.U0, ft.fields.P0)
    base = tmp_path_factory.mktemp("base") / "base.npz"
    np.savez(base, U0=ft.fields.U0, P0=ft.fields.P0)
    ft.initialize_time_stepping()
    return fj, ft, synth.operators(ft), base


@pytest.fixture(scope="module")
def design(flows, tmp_path_factory):
    """The port's ROM at a shift on the small mesh's scan, its LQG, the
    leading mode, and the files the tool writes for them."""
    _, ft, (a, e, b, c), _ = flows
    scan = synth.spectrum_scan(a, e, [SCAN_SIGMA], n=2)
    shift = complex(np.round(scan[np.argmax(scan.real)], 1))
    rom, kept = synth.build_rom(a, e, b, c, [shift], k_per_shift=2)
    k, _, _ = synth.design_lqg(rom, kept)
    mode = synth.leading_mode(a, e, shift)
    paths = synth.write_artifacts(ft, rom, kept, [shift], k, mode,
                                  out_dir=tmp_path_factory.mktemp("controllers"))
    return dict(shift=shift, rom=rom, kept=kept, k=k, mode=mode, paths=paths)


@pytest.fixture(scope="module")
def ops_j(flows):
    """The JAX package's A, E, B, C on the same base flow."""
    return OperatorGetterJ(flows[0]).get_all(autodiff=False, u_ctrl=[0.0])


def test_torch_cavity_feedback_operators_match_jax(flows, ops_j):
    fj, _, ops_t, _ = flows
    a, e, b, c = ops_j
    b = np.atleast_2d(np.asarray(b))
    b = b if b.shape[0] == fj.space.n_dofs else b.T
    for got, want in zip(ops_t[:2], (a, e)):  # sparse: compared entry by entry
        assert got.shape == want.shape
        assert abs(got - want).max() <= TOL * abs(want).max()
    for got, want in zip(ops_t[2:], (b, np.atleast_2d(np.asarray(c)))):
        assert got.shape == want.shape and _rel(got, want) <= TOL
    assert ops_t[2].shape == (fj.space.n_dofs, 1) and ops_t[3].shape == (2, fj.space.n_dofs)


def _jax_lqg(rom, kept):
    """The JAX tool's selection, weights and dlqg_regulator call
    (tools/cavity_feedback_synth.py:156-175), on the JAX package."""
    nx = rom.nstates
    sel, off = np.zeros(nx), 0
    for lam in kept:
        wdt = 1 if abs(lam.imag) <= 1e-6 else 2
        if lam.real > 0:
            sel[off:off + wdt] = 1.0
        off += wdt
    q = np.diag(sel + 0.01 * (1 - sel)) + 1e-9 * np.eye(nx)
    qw = np.diag(sel) + 1e-9 * np.eye(nx)
    return dlqg_j(SSJ(rom.A, rom.B, rom.C, rom.D), synth.DT, ru=100.0, rv=1e5, Q=q, Qw=qw)[0]


def _jax_interconnection(rom, k):
    """M and Adp as the JAX tool builds them (:179-185)."""
    from scipy.linalg import expm

    ai, bi, cr = np.asarray(rom.A), np.asarray(rom.B), np.asarray(rom.C)
    nx = ai.shape[0]
    adp = expm(ai * synth.DT)
    bdp = np.linalg.solve(ai, (adp - np.eye(nx))) @ bi
    return np.block([[adp, bdp @ np.asarray(k.C)], [np.asarray(k.B) @ cr, np.asarray(k.A)]]), adp


def test_torch_cavity_feedback_lqg_on_one_rom_matches_jax(design):
    rom, kept, k = design["rom"], design["kept"], design["k"]
    assert (np.real(kept) > 0).any(), kept  # the design has an unstable pair to hold
    kj = _jax_lqg(rom, kept)
    for name in "ABCD":
        assert _rel(getattr(k, name), getattr(kj, name)) <= TOL, name
    m, adp = _jax_interconnection(rom, kj)
    sr_j = float(np.abs(np.linalg.eigvals(m)).max())
    sr_t = synth.certify(rom, k)
    assert sr_t < 1.0 and abs(sr_t - sr_j) <= 1e-12
    # the JAX tool's energy loop (:187-197), from 0.5 on the leading mode's
    # first state
    nx = rom.nstates
    assert all(abs(lam.imag) > 1e-6 for lam in kept)  # pairs: mode i's first state is 2 i
    x0 = np.zeros(nx)
    x0[2 * int(np.argmax(kept.real))] = 0.5
    z, zo, want = np.concatenate([x0, np.zeros(nx)]), x0.copy(), {}
    for i in range(1, 4001):
        z, zo = m @ z, adp @ zo
        if i in synth.ENERGY_STEPS:
            want[i] = np.sum(z[:nx] ** 2) / np.sum(zo ** 2)
    got = synth.rom_energy_ratios(rom, k, kept)
    assert got.keys() == want.keys()
    assert all(abs(got[i] - want[i]) <= TOL * abs(want[i]) for i in want)


def test_torch_cavity_feedback_own_roms_and_mode_match_jax(ops_j, design):
    shift = design["shift"]
    rom_j, kept_j = modal_rom_j(*ops_j, shifts=[shift], k_per_shift=2, re_min=-2.0)
    rom_t, kept_t = design["rom"], design["kept"]
    assert _rel(np.sort_complex(kept_t), np.sort_complex(kept_j)) <= 1e-8
    poles_t, poles_j = (np.sort_complex(np.linalg.eigvals(r.A)) for r in (rom_t, rom_j))
    assert np.abs(poles_t - poles_j).max() <= 1e-8 * np.abs(poles_j).max()
    ww = np.array([5.0, 11.6, 20.0])
    h_t, h_j = rom_t.frequency_response(ww), rom_j.frequency_response(ww)
    assert np.abs(h_t - h_j).max() <= 1e-8 * np.abs(h_j).max()
    lam_t, v_t = design["mode"]
    vals, vecs = eigs_j(ops_j[0], ops_j[1], n=2, sigma=shift)
    i0 = int(np.argmax(vals.real))
    v_j = vecs[:, i0] / np.linalg.norm(vecs[:, i0])
    assert abs(lam_t - vals[i0]) <= 1e-8 * abs(vals[i0])
    assert abs(abs(np.vdot(v_t, v_j)) - 1.0) <= 1e-8


def _jax_example(fj, mode_path, lqg_path, closed):
    """The JAX example's loop (examples/run_cavity_feedback.py:52-77) on
    the JAX solver, the same files."""
    mode = np.load(mode_path)
    fj.params_ic.amplitude = 0.0
    fj.initialize_time_stepping(ic=1e-3 * np.asarray(mode["v_re"], dtype=float))
    k = ControllerJ.from_file(lqg_path) if closed else None
    dt = fj.params_time.dt
    for _ in range(STEPS):
        u_ctrl = k.step(y=np.asarray(fj.y_meas), dt=dt) if k is not None else np.zeros(1)
        fj.step(u_ctrl=np.asarray(u_ctrl).reshape(-1))
    ts = fj.timeseries
    return {c: ts[c].to_numpy() for c in ("y_meas_1", "y_meas_2", "u_ctrl_1", "dE")}


@pytest.fixture(scope="module")
def examples(flows, design, tmp_path_factory):
    """{closed: (the port example's timeseries, the JAX loop's)}."""
    fj, _, _, base = flows
    out = {}
    with pytest.MonkeyPatch.context() as mp:  # the small mesh's base flow, as a committed one
        mp.setattr(example, "committed_baseflow", lambda fs: base)
        mp.chdir(tmp_path_factory.mktemp("example"))
        for closed in (False, True):
            ts = example.main(num_steps=STEPS, closed_loop=closed, mesh=flows[1].mesh,
                              mode=design["paths"]["mode"], controller=design["paths"]["lqg"],
                              device="cpu", solver_backend="host_lu", precision="f64")
            out[closed] = ts, _jax_example(fj, design["paths"]["mode"], design["paths"]["lqg"],
                                           closed)
    return out


@pytest.mark.parametrize("closed", [False, True], ids=["open", "closed"])
def test_torch_cavity_feedback_example_matches_jax(examples, closed):
    got, want = examples[closed]
    assert len(got["dE"]) == STEPS + 1
    for col in want:  # u on the initial row is NaN in both
        assert np.array_equal(np.isnan(got[col]), np.isnan(want[col])), col
        assert np.isfinite(got[col][1:]).all() and _rel(got[col][1:], want[col][1:]) <= TOL, col
    u = got["u_ctrl_1"][1:]
    assert (np.abs(u).max() > 0) == closed


def test_torch_cavity_feedback_fused_rollout_matches_example(flows, design, examples):
    """closed_loop_fn(5, feedback_sign=+1.0) from the example's initial
    state against the example's eager loop (chip_smoke.py's phase 44 route)."""
    _, ft, _, _ = flows
    example.start(ft, load_cavity_mode(ft, design["paths"]["mode"]))
    st, dt = ft.stepper, ft.params_time.dt
    k = load_cavity_controller(ft, design["paths"]["lqg"])
    _, (ys, des, us, div) = st.closed_loop_fn(STEPS, feedback_sign=+1.0)(
        ft._carry, k.discrete(dt), np.asarray(ft.y_meas))
    got, _ = examples[True]
    assert not bool(div.any())
    assert _rel(ys.numpy(), np.stack([got["y_meas_1"][1:], got["y_meas_2"][1:]], 1)) <= TOL
    assert _rel(us.numpy()[:, 0], got["u_ctrl_1"][1:]) <= TOL
    assert _rel(des.numpy(), got["dE"][1:]) <= TOL


def test_torch_cavity_feedback_operator_b_acts_as_the_stepper_u(flows):
    """One step from rest with a small force against the implicit-Euler
    step of E x' = A x + B u with the Dirichlet rows held at zero, as the
    Stepper holds them (A's Dirichlet rows are the identity, E's and B's are
    not zero there, the reference's convention): the same y to 1e-10. A
    wrong sign would turn u = +K(y) into positive feedback."""
    import scipy.sparse.linalg as spla

    _, ft, (a, e, b, c), _ = flows
    st, dt = ft.stepper, ft.params_time.dt
    dofs = ft._bcset_perturbation().dofs
    step = (e / dt - a).tolil()
    step[dofs, :] = 0.0
    step[dofs, dofs] = 1.0
    u = np.array([1e-6])
    f = b @ u
    f[dofs] = 0.0
    _, out = st.step(st.init_carry(np.zeros(ft.space.n_dofs)), u)
    y, y_lin = out.y.numpy(), c @ spla.spsolve(step.tocsc(), f)
    assert np.array_equal(np.sign(y), np.sign(y_lin)) and _rel(y, y_lin) <= TOL


@pytest.fixture(scope="module")
def committed():
    return cavity_feedback_files(DEFAULT_DOFS)


def test_torch_cavity_feedback_committed_files_carry_the_default_mesh(committed):
    sha = mesh_checksum(cavity_mesh_t())
    for kind in ("rom", "mode"):
        with np.load(committed[kind], allow_pickle=False) as d:
            assert str(d["mesh_sha256"]) == sha, kind
    assert str(sio.loadmat(str(committed["lqg"]))["mesh_sha256"][0]) == sha
    with np.load(committed["mode"]) as d:
        assert d["v_re"].shape == (DEFAULT_DOFS,) and d["v_re"].dtype == np.float32


def test_torch_cavity_feedback_other_mesh_refused(flows, committed):
    _, ft, _, _ = flows
    with pytest.raises(ValueError, match="another mesh"):
        load_cavity_mode(ft, committed["mode"])
    with pytest.raises(ValueError, match="another mesh"):
        load_cavity_controller(ft, committed["lqg"])


def test_torch_cavity_feedback_committed_loop_certified(committed):
    with np.load(committed["rom"]) as d:
        rom = synth.StateSpace(d["A"], d["B"], d["C"])
        kept = d["kept"]
    k = ControllerT.from_file(committed["lqg"])
    assert k.native_dt == synth.DT and rom.nstates == sum(
        1 if abs(lam.imag) <= 1e-6 else 2 for lam in kept)
    assert synth.certify(rom, k) < 1.0


def test_torch_cavity_feedback_committed_controller_reads_in_both(committed):
    kt, kj = ControllerT.from_file(committed["lqg"]), ControllerJ.from_file(committed["lqg"])
    assert kt.native_dt == kj.native_dt == 4e-4
    for name in "ABCD":
        assert np.array_equal(np.asarray(getattr(kt, name)), np.asarray(getattr(kj, name))), name
