"""The fluidic pinball's MIMO closed loop (the synthesis tool, the example)
and the two Hopf sweeps against the JAX package on the CPU in float64.

On the small pinball mesh (``SMALL``, as in tests/test_torch_pinball.py) at
Re=30, the JAX tool's Re < 80 branch, rotation actuation, with a base flow
computed by the port (Picard 2 + Newton 2) and carried to the JAX solver,
host LU:

- A, E, B and C from the tools' ``operators`` (autodiff A) against the JAX
  package's ``OperatorGetter.get_all(autodiff=True, u_ctrl=[0, 0, 0])``:
  1e-10;
- one ROM (the port's, at the JAX tool's Re=30 shifts) fed to the tool's
  ``design`` and to the JAX package's ``dlqg_regulator``, composed here as
  the JAX tool composes them (its Q, Qw, ru, rv, M and energy loop):
  compensators to 1e-10, the sampled radius to 1e-12, the ROM energy
  ratios to 1e-10;
- the tool's rules (shifts, weights, horizons, amplitude) at Re 30 and 100
  against the JAX tool's constants, and ``choose_shifts`` on a scan;
- each package's own ROM at the JAX shifts: poles to 1e-8, H(jω) at three
  ω to 1e-8 over the complex pairs (a real mode's block carries the cos²
  of ARPACK's random eigenvector phase in both packages, ROADMAP "Faults
  in the reference"); ``leading_mode``'s λ to 1e-8 and |v_tᴴ v_j| within
  1e-8 of 1;
- one continuation stage (``make_baseflow.continuation_stage``, Newton
  from the Re=30 field at Re=35): 1e-10;
- the example, open and closed, 5 steps, against the JAX example's loop
  composed line by line (the same mode file and amplitude, the same
  ``.mat`` read by the JAX ``Controller.from_file``): y, u and dE to 1e-10;
  the fused ``closed_loop_fn(5, feedback_sign=+1.0)`` against the eager
  loop to 1e-10; the design search's 2-row batch (the design and the open
  loop) against the example's two runs: closed/open energy to 1e-10;
- each sweep on a small mesh against the JAX script's calls composed the
  same way, the leading λ to 1e-8: the cylinder's at Re 46 (each Re of its
  sweep is a cold start of its own), the lid cavity's continued over Re 200
  and 400 with eigenvalues at 400.

And the committed files at the default mesh (67,920 dofs, Re=100): their
checksum is the default mesh's (the committed base flow's, which
tests/test_torch_pinball.py holds against ``pinball_mesh()``), another
mesh is refused, the compensator is
3 x 3 and discrete at dt 5e-3, it closes the ROM with a sampled radius below
1, and both packages read it alike.
"""

import numpy as np
import pytest
import scipy.io as sio
import torch
from threadpoolctl import threadpool_limits

from flowcontrol_tpu.core.actuator import CYLINDER_ACTUATION_MODE as MODE_J
from flowcontrol_tpu.core.controller import Controller as ControllerJ
from flowcontrol_tpu.core.operatorgetter import OperatorGetter as OperatorGetterJ
from flowcontrol_tpu.mesh.generation import lidcavity_mesh as lidcavity_mesh_j
from flowcontrol_tpu.mesh.generation import pinball_mesh as pinball_mesh_j
from flowcontrol_tpu.models.cylinder import CylinderFlowSolver as CylJ
from flowcontrol_tpu.models.lidcavity import LidCavityFlowSolver as LidJ
from flowcontrol_tpu.models.pinball import PinballFlowSolver as PinJ
from flowcontrol_tpu.utils.linalg import get_mat_vp_shift_invert as eigs_j
from flowcontrol_tpu.utils.linalg import modal_rom as modal_rom_j
from flowcontrol_tpu.utils.lticontrol import dlqg_regulator as dlqg_j
from flowcontrol_tpu.utils.statespace import StateSpace as SSJ
from flowcontrol_tpu_torch.core.controller import Controller as ControllerT
from flowcontrol_tpu_torch.examples import run_pinball_feedback as example
from flowcontrol_tpu_torch.mesh.generation import lidcavity_mesh as lidcavity_mesh_t
from flowcontrol_tpu_torch.mesh.generation import pinball_mesh as pinball_mesh_t
from flowcontrol_tpu_torch.models import make_baseflow
from flowcontrol_tpu_torch.models.baseflows import BASEFLOW_DIR, write_baseflow
from flowcontrol_tpu_torch.models.pinball import (
    load_pinball_controller,
    load_pinball_mode,
    pinball_feedback_files,
)
from flowcontrol_tpu_torch.tools import bifurcation_sweep, lidcavity_hopf_sweep
from flowcontrol_tpu_torch.tools import pinball_design_search as search
from flowcontrol_tpu_torch.tools import cavity_feedback_synth as shared
from flowcontrol_tpu_torch.tools import pinball_mimo_synth as synth

torch.set_num_threads(1)

SMALL = dict(n1=2.0, n2=1.2, n3=0.5, segments=32, xinf=14.0)
RE = 30.0
STEPS = 5
TOL = 1e-10
DEFAULT_DOFS = 67_920
CYL_SMALL = dict(yinf=3.0, xinf=8.0, xinfa=-3.0, n1=2.0, n2=1.0, n3=0.5, segments=40)
LID_N = 8


@pytest.fixture(scope="module", autouse=True)
def one_blas_thread():
    """One BLAS thread (ARPACK, scipy's dense algebra), as torch gets one."""
    with threadpool_limits(limits=1):
        yield


@pytest.fixture(scope="module", autouse=True)
def _factor_cache_off():
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("FLOWCONTROL_TPU_FACTOR_CACHE", "off")
        yield


def _rel(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return np.abs(a - b).max() / max(np.abs(b).max(), 1e-300)


def _pin_j(path_out, re=RE, num_steps=STEPS):
    return PinJ.make_default(Re=re, mesh=pinball_mesh_j(**SMALL), num_steps=num_steps, verbose=0,
                             mode_actuation=MODE_J.ROTATION, path_out=path_out,
                             solver_backend="host_lu", precision="f64")


@pytest.fixture(scope="module")
def flows(tmp_path_factory):
    """(JAX solver, port solver, the port's A, E, B, C, the base flow's
    directory) on the small mesh at Re=30, one base flow."""
    ft = make_baseflow.pinball_solver(RE, mesh=pinball_mesh_t(**SMALL),
                                      path_out=tmp_path_factory.mktemp("t"))
    ft.compute_steady_state(u_ctrl=synth.U_CTRL0, method="picard", max_iter=2, tol=1e-7)
    ft.compute_steady_state(u_ctrl=synth.U_CTRL0, method="newton", max_iter=2,
                            initial_guess=ft.fields.UP0)
    fj = _pin_j(tmp_path_factory.mktemp("j"))
    fj._assign_steady_state(ft.fields.U0, ft.fields.P0)
    base = tmp_path_factory.mktemp("base")
    write_baseflow(ft, base)
    return fj, ft, shared.operators(ft, autodiff=True, u_ctrl=synth.U_CTRL0), base


@pytest.fixture(scope="module")
def ops_j(flows):
    """The JAX package's A, E, B, C on the same base flow."""
    return OperatorGetterJ(flows[0]).get_all(autodiff=True, u_ctrl=[0.0, 0.0, 0.0])


@pytest.fixture(scope="module")
def design(flows, tmp_path_factory):
    """The port's ROM at the JAX tool's Re=30 shifts, its LQG at the JAX
    tool's Re=30 weights, the leading mode, and the files the tool writes."""
    _, ft, (a, e, b, c), _ = flows
    shifts = synth.jax_shifts(RE)
    rom, kept = shared.build_rom(a, e, b, c, shifts, k_per_shift=synth.K_PER_SHIFT,
                                 re_min=synth.RE_MIN)
    ru, rv = synth.weights(RE)
    k, _, _ = synth.design(rom, kept, ru=ru, rv=rv)
    mode = synth.leading_mode(a, e)
    paths = shared.write_artifacts(ft, rom, kept, shifts, k, mode, dt=synth.DT,
                                   paths=pinball_feedback_files(
                                       ft.space.n_dofs, RE, tmp_path_factory.mktemp("controllers")))
    return dict(shifts=shifts, rom=rom, kept=kept, k=k, mode=mode, paths=paths)


def test_torch_pinball_feedback_operators_match_jax(flows, ops_j):
    fj, _, ops_t, _ = flows
    a, e, b, c = ops_j
    b = np.atleast_2d(np.asarray(b))
    b = b if b.shape[0] == fj.space.n_dofs else b.T
    for got, want in zip(ops_t[:2], (a, e)):  # sparse: compared entry by entry
        assert got.shape == want.shape
        assert abs(got - want).max() <= TOL * abs(want).max()
    for got, want in zip(ops_t[2:], (b, np.atleast_2d(np.asarray(c)))):
        assert got.shape == want.shape and _rel(got, want) <= TOL
    assert ops_t[2].shape == (fj.space.n_dofs, 3) and ops_t[3].shape == (3, fj.space.n_dofs)


def _jax_tool(rom, kept):
    """The JAX tool's selection, weights, dlqg_regulator call, M and energy
    loop (tools/pinball_mimo_synth.py:193-241) at Re=30, on the JAX
    package. Returns (compensator, radius, {N: ratio})."""
    from scipy.linalg import expm

    ai, bi, cr = np.asarray(rom.A), np.asarray(rom.B), np.asarray(rom.C)
    nx = ai.shape[0]
    sel, off, mode_off = np.zeros(nx), 0, {}
    for lam in kept:
        wdt = 1 if abs(lam.imag) <= 1e-6 else 2
        mode_off[complex(lam)] = off
        if lam.real > 0:
            sel[off:off + wdt] = 1.0
        off += wdt
    q = np.diag(sel) + 1e-9 * np.eye(nx)
    qw = np.diag(sel) + 1e-9 * np.eye(nx)
    ru = 100.0 if RE >= 80.0 else 1.0
    klqg = dlqg_j(SSJ(rom.A, rom.B, rom.C, rom.D), 5e-3, ru=ru, rv=1e-3, Q=q, Qw=qw)[0]
    adp = expm(ai * 5e-3)
    bdp = np.linalg.solve(ai, (adp - np.eye(nx))) @ bi
    m = np.block([[adp, bdp @ np.asarray(klqg.C)], [np.asarray(klqg.B) @ cr, np.asarray(klqg.A)]])
    sr = np.abs(np.linalg.eigvals(m)).max()
    lam0 = kept[np.argmax(kept.real)]
    x0 = np.zeros(nx)
    x0[mode_off[complex(lam0)]] = 0.5
    z, zo, ratios = np.concatenate([x0, np.zeros(nx)]), x0.copy(), {}
    n_rep = 20000 if RE >= 80.0 else 8000
    for i in range(1, n_rep + 1):
        z, zo = m @ z, adp @ zo
        if i % (n_rep // 4) == 0:
            ratios[i] = np.sum(z[:nx] ** 2) / np.sum(zo ** 2)
    return klqg, sr, ratios


def test_torch_pinball_feedback_lqg_on_one_rom_matches_jax(design):
    rom, kept, k = design["rom"], design["kept"], design["k"]
    assert (np.real(kept) > 0).any(), kept  # the design has an unstable mode to hold
    kj, sr_j, ratios_j = _jax_tool(rom, kept)
    for name in "ABCD":
        assert _rel(getattr(k, name), getattr(kj, name)) <= TOL, name
    sr_t = shared.certify(rom, k, dt=synth.DT)
    assert sr_t < 1.0 and abs(sr_t - sr_j) <= 1e-12
    got = shared.rom_energy_ratios(rom, k, kept, dt=synth.DT, steps=synth.energy_steps(RE))
    assert got.keys() == ratios_j.keys()
    assert all(abs(got[i] - ratios_j[i]) <= TOL * abs(ratios_j[i]) for i in ratios_j)


@pytest.mark.parametrize("re", [30.0, 100.0])
def test_torch_pinball_feedback_rules_match_the_jax_tool(re):
    """The JAX tool's constants (:99, :150-152, :218-219, :236; the
    example's :70) at both of its branches."""
    high = re >= 80.0
    assert synth.jax_shifts(re) == ([0.75j, 0.1 + 1.1j, 0j] if high else [0.75j, 0j])
    assert synth.weights(re) == ((100.0 if high else 1.0), 1e-3)
    n_rep = 20000 if high else 8000
    assert synth.energy_steps(re) == tuple(i * n_rep // 4 for i in range(1, 5))
    assert example.ic_amplitude(re) == (2e-4 if high else 1e-3)
    assert make_baseflow.continuation_schedule(min(30.0, re), re) == (
        [50.0, 70.0, 85.0, 100.0] if high else [])
    assert make_baseflow.continuation_schedule(50.0, 100.0) == [70.0, 85.0, 100.0]
    # the generated mesh's unstable λ at Re=100 (PERF.md): the JAX shifts
    # reach all three; one more above the band
    scan = np.array([0.04737, -0.08674, -0.08797 + 0.07363j, 0.02116 + 0.53338j,
                     0.02799 + 0.54259j, -0.05122 + 0.69945j, -0.02898 + 0.90117j,
                     -0.50106 + 1.42816j, -0.51436 + 1.77701j, -0.51788 + 1.96935j])
    assert synth.choose_shifts(scan, re) == synth.jax_shifts(re) + [-0.51 + 1.78j]
    # an unstable λ beyond every JAX shift's k nearest gets a shift of its own
    far = np.concatenate([scan, [0.01 + 3.0j]])
    assert synth.choose_shifts(far, re)[len(synth.jax_shifts(re))] == 0.01 + 3.0j


def test_torch_pinball_feedback_own_roms_and_mode_match_jax(ops_j, design):
    rom_j, kept_j = modal_rom_j(*ops_j, shifts=design["shifts"], k_per_shift=synth.K_PER_SHIFT,
                                re_min=synth.RE_MIN)
    rom_t, kept_t = design["rom"], design["kept"]
    assert _rel(np.sort_complex(kept_t), np.sort_complex(kept_j)) <= 1e-8
    poles_t, poles_j = (np.sort_complex(np.linalg.eigvals(r.A)) for r in (rom_t, rom_j))
    assert np.abs(poles_t - poles_j).max() <= 1e-8 * np.abs(poles_j).max()

    def pairs(rom, kept):  # the ROM over its complex pairs' states
        idx, off = [], 0
        for lam in kept:
            if abs(lam.imag) > 1e-6:
                idx += [off, off + 1]
            off += 1 if abs(lam.imag) <= 1e-6 else 2
        a, b, c = (np.asarray(m) for m in (rom.A, rom.B, rom.C))
        return SSJ(a[np.ix_(idx, idx)], b[idx], c[:, idx], np.zeros((c.shape[0], b.shape[1])))

    assert any(abs(lam.imag) > 1e-6 for lam in kept_t)
    ww = np.array([0.3, 0.75, 1.5])
    h_t, h_j = (pairs(r, kp).frequency_response(ww) for r, kp in ((rom_t, kept_t), (rom_j, kept_j)))
    assert np.abs(h_t - h_j).max() <= 1e-8 * np.abs(h_j).max()
    lam_t, v_t = design["mode"]
    best = None
    for sig in (0.05 + 0.55j, 0.05 + 0.0j):  # the JAX tool's :175-181
        vals, vecs = eigs_j(ops_j[0], ops_j[1], n=2, sigma=sig)
        i0 = int(np.argmax(vals.real))
        if best is None or vals[i0].real > best[0].real:
            best = vals[i0], vecs[:, i0]
    v_j = best[1] / np.linalg.norm(best[1])
    assert abs(lam_t - best[0]) <= 1e-8 * abs(best[0])
    assert abs(abs(np.vdot(v_t, v_j)) - 1.0) <= 1e-8


def test_torch_pinball_feedback_continuation_stage_matches_jax(flows, tmp_path):
    """Newton (12) at Re=35 from the Re=30 field: the JAX tool's stage
    (:104-115) against ``continuation_stage``."""
    _, ft, _, _ = flows
    guess = np.asarray(ft.fields.UP0)
    up_t = make_baseflow.continuation_stage(
        make_baseflow.pinball_solver(35.0, mesh=ft.mesh, path_out=tmp_path), guess)
    fj = _pin_j(tmp_path, re=35.0)
    fj.compute_steady_state(method="newton", max_iter=12, u_ctrl=[0.0, 0.0, 0.0],
                            initial_guess=guess)
    up_j = np.asarray(fj.fields.UP0)
    assert _rel(up_t, guess) > 1e-4  # the stage moved the field
    assert _rel(up_t, up_j) <= TOL


def _jax_example(fj, mode_path, lqg_path, closed):
    """The JAX example's loop (examples/run_pinball_feedback.py:65-101) on
    the JAX solver, the same files."""
    mode = np.load(mode_path)
    fj.params_ic.amplitude = 0.0
    amp = 2e-4 if RE >= 80.0 else 1e-3
    fj.initialize_time_stepping(ic=amp * np.asarray(mode["v_re"], dtype=float))
    k = ControllerJ.from_file(lqg_path) if closed else None
    dt = fj.params_time.dt
    for _ in range(STEPS):
        u_ctrl = k.step(y=np.asarray(fj.y_meas), dt=dt) if k is not None else np.zeros(3)
        fj.step(u_ctrl=np.asarray(u_ctrl).reshape(-1))
    ts = fj.timeseries
    return {c: ts[c].to_numpy() for c in ts.columns if c.startswith(("y_meas", "u_ctrl", "dE"))}


@pytest.fixture(scope="module")
def examples(flows, design, tmp_path_factory):
    """{closed: (the port example's timeseries, the JAX loop's)}."""
    fj, ft, _, base = flows
    out = {}
    with pytest.MonkeyPatch.context() as mp:
        mp.chdir(tmp_path_factory.mktemp("example"))
        for closed in (False, True):
            ts = example.main(num_steps=STEPS, closed_loop=closed, re=RE, mesh=ft.mesh,
                              mode=design["paths"]["mode"], controller=design["paths"]["lqg"],
                              device="cpu", path_out=base, solver_backend="host_lu",
                              precision="f64", stepper_options={})
            out[closed] = ts, _jax_example(fj, design["paths"]["mode"], design["paths"]["lqg"],
                                           closed)
    return out


@pytest.mark.parametrize("closed", [False, True], ids=["open", "closed"])
def test_torch_pinball_feedback_example_matches_jax(examples, closed):
    got, want = examples[closed]
    assert len(got["dE"]) == STEPS + 1 and len(want) == 7
    for col in want:  # u on the initial row is NaN in both
        assert np.array_equal(np.isnan(got[col]), np.isnan(want[col])), col
        assert np.isfinite(got[col][1:]).all() and _rel(got[col][1:], want[col][1:]) <= TOL, col
    u = np.stack([got[f"u_ctrl_{i}"][1:] for i in (1, 2, 3)], 1)
    assert (np.abs(u).max() > 0) == closed
    if closed:  # the three channels differ: MIMO action
        assert not np.allclose(u[-1], u[-1][0])


def test_torch_pinball_feedback_fused_rollout_matches_example(flows, design, examples):
    """closed_loop_fn(5, feedback_sign=+1.0) from the example's initial
    state against the example's eager loop (chip_smoke.py's phase 45 route)."""
    _, ft, _, _ = flows
    example.start(ft, load_pinball_mode(ft, design["paths"]["mode"]))
    st, dt = ft.stepper, ft.params_time.dt
    k = load_pinball_controller(ft, design["paths"]["lqg"])
    _, (ys, des, us, div) = st.closed_loop_fn(STEPS, feedback_sign=+1.0)(
        ft._carry, k.discrete(dt), np.asarray(ft.y_meas))
    got, _ = examples[True]
    assert not bool(div.any())
    assert _rel(ys.numpy(), np.stack([got[f"y_meas_{i}"][1:] for i in (1, 2, 3)], 1)) <= TOL
    assert _rel(us.numpy(), np.stack([got[f"u_ctrl_{i}"][1:] for i in (1, 2, 3)], 1)) <= TOL
    assert _rel(des.numpy(), got["dE"][1:]) <= TOL


def test_torch_pinball_feedback_design_search_matches_example(flows, design, examples):
    """The design search's batch of two rows (the design at the JAX tool's
    Re=30 weights, gain 1, and the open loop) through one closed loop,
    against the example's open and closed runs."""
    _, ft, _, base = flows
    rows = search.main([design["paths"]["rom"].parent], ru=synth.weights(RE)[:1],
                       rv=synth.weights(RE)[1:], gains=(1.0,), steps=STEPS, device="cpu", re=RE,
                       mesh=ft.mesh, path_out=base, solver_backend="host_lu", precision="f64",
                       stepper_options={})
    assert [r["gain"] for r in rows] == [1.0, 0.0] and not any(r["diverged"] for r in rows)
    (closed, _), (opened, _) = examples[True], examples[False]
    want = {n: closed["dE"][n] / opened["dE"][n] for n in rows[0]["plant_ratios"]}
    assert all(abs(rows[0]["plant_ratios"][n] - want[n]) <= TOL * want[n] for n in want)
    assert rows[1]["plant_ratios"] == {n: 1.0 for n in want}
    assert abs(rows[0]["sampled_radius"] - shared.certify(design["rom"], design["k"],
                                                          dt=synth.DT)) <= 1e-12
    assert rows[0]["umax"] == pytest.approx(np.abs(np.stack(
        [closed[f"u_ctrl_{i}"][1:] for i in (1, 2, 3)])).max(), rel=TOL)


def test_torch_pinball_feedback_example_without_files(flows, tmp_path, monkeypatch):
    """No mode file fits: the bump; no compensator: the JAX example's stop."""
    _, ft, _, base = flows
    monkeypatch.chdir(tmp_path)
    missing = pinball_feedback_files(ft.space.n_dofs, RE, tmp_path)
    with pytest.raises(SystemExit, match="run tools/pinball_mimo_synth first"):
        example.main(num_steps=1, re=RE, mesh=ft.mesh, mode=missing["mode"],
                     controller=missing["lqg"], device="cpu", path_out=base,
                     solver_backend="host_lu", precision="f64", stepper_options={})
    assert example.find_mode(ft, missing["mode"]) is None


def _jax_bifurcation(res):
    """tools/bifurcation_sweep.py's loop on the small mesh, JAX package."""
    out = {}
    for re in res:
        fs = CylJ.make_default(Re=re, num_steps=1, verbose=0, mesh_kwargs=CYL_SMALL,
                               solver_backend="host_lu", precision="f64")
        fs.compute_steady_state(method="picard", max_iter=3, tol=1e-7, u_ctrl=[0.0, 0.0])
        fs.compute_steady_state(method="newton", max_iter=25, u_ctrl=[0.0, 0.0],
                                initial_guess=fs.fields.UP0)
        og = OperatorGetterJ(fs)
        a, e = og.get_A(autodiff=False), og.get_mass_matrix()
        vals = eigs_j(a, e, n=4, sigma=0.75j, return_vectors=False)
        out[re] = vals[np.argmax(vals.real)]
    return out


def _eigs_v0(a, e, n=4, sigma=0.0, return_vectors=False):
    """``get_mat_vp_shift_invert`` (both packages' call, eigenvalues only)
    from one fixed ARPACK start vector."""
    import scipy.sparse.linalg as spla

    vals = spla.eigs(a.astype(np.complex128), k=n, M=e.astype(np.complex128), sigma=sigma,
                     which="LM", return_eigenvectors=False, v0=np.ones(a.shape[0], complex))
    return vals[np.argsort(-vals.real)]


def _jax_lidhopf(res, eig_from, tmp_path):
    """tools/lidcavity_hopf_sweep.py's loop on a small mesh, JAX package,
    its eigenvalues from ``_eigs_v0``."""
    mesh, up0, out = lidcavity_mesh_j(LID_N, stretch=2.0), None, {}
    for re in res:
        fs = LidJ.make_default(Re=re, num_steps=1, verbose=0, mesh=mesh, path_out=tmp_path,
                               solver_backend="host_lu", precision="f64")
        if up0 is None:
            fs.compute_steady_state(method="picard", max_iter=6, u_ctrl=[0.0])
            fs.compute_steady_state(method="newton", max_iter=30, u_ctrl=[0.0],
                                    initial_guess=fs.fields.UP0)
        else:
            fs.compute_steady_state(method="newton", max_iter=30, u_ctrl=[0.0],
                                    initial_guess=up0)
        up0 = fs.fields.UP0.copy()
        if re < eig_from:
            continue
        og = OperatorGetterJ(fs)
        a, e = og.get_A(autodiff=False), og.get_mass_matrix()
        best = None
        for sigma in (0.5j, 1.0j, 2.0j, 3.0j):
            vals = _eigs_v0(a, e, n=4, sigma=sigma, return_vectors=False)
            lead = vals[np.argmax(vals.real)]
            if best is None or lead.real > best.real:
                best = lead
        out[re] = best
    return out


def test_torch_bifurcation_sweep_matches_jax():
    res = (46,)
    got = bifurcation_sweep.sweep(res, mesh_kwargs=CYL_SMALL)
    want = _jax_bifurcation(res)
    assert got.keys() == want.keys()
    for re in res:
        assert abs(got[re] - want[re]) <= 1e-8 * abs(want[re]), re


def test_torch_lidcavity_hopf_sweep_matches_jax(tmp_path, monkeypatch):
    """The lid cavity's operator is far from normal: ARPACK's random start
    vector moves its λ by 1e-6 to 1e-4 from call to call here, so both
    sides solve from one start vector (``_eigs_v0``)."""
    monkeypatch.chdir(tmp_path)
    monkeypatch.setattr(bifurcation_sweep, "get_mat_vp_shift_invert", _eigs_v0)
    res, eig_from = (200, 400), 400
    got = lidcavity_hopf_sweep.sweep(res, mesh=lidcavity_mesh_t(LID_N, stretch=2.0),
                                     eig_from=eig_from)
    want = _jax_lidhopf(res, eig_from, tmp_path)
    assert sorted(got) == sorted(want) == [400]
    for re in want:
        assert abs(got[re] - want[re]) <= 1e-8 * abs(want[re]), re


@pytest.fixture(scope="module")
def committed():
    return pinball_feedback_files(DEFAULT_DOFS, 100.0)


def test_torch_pinball_feedback_committed_files_carry_the_default_mesh(committed):
    # the committed base flow's checksum, which tests/test_torch_pinball.py
    # holds against pinball_mesh()
    with np.load(BASEFLOW_DIR / f"pinball_re100_n{DEFAULT_DOFS}.npz") as d:
        sha = str(d["mesh_sha256"])
    for kind in ("rom", "mode"):
        with np.load(committed[kind], allow_pickle=False) as d:
            assert str(d["mesh_sha256"]) == sha, kind
    assert str(sio.loadmat(str(committed["lqg"]))["mesh_sha256"][0]) == sha
    with np.load(committed["mode"]) as d:
        assert d["v_re"].shape == (DEFAULT_DOFS,) and d["v_re"].dtype == np.float32


def test_torch_pinball_feedback_other_mesh_refused(flows, committed):
    _, ft, _, _ = flows
    with pytest.raises(ValueError, match="another mesh"):
        load_pinball_mode(ft, committed["mode"])
    with pytest.raises(ValueError, match="another mesh"):
        load_pinball_controller(ft, committed["lqg"])


def test_torch_pinball_feedback_committed_loop_certified(committed):
    with np.load(committed["rom"]) as d:
        rom = synth.StateSpace(d["A"], d["B"], d["C"])
        kept = d["kept"]
    k = ControllerT.from_file(committed["lqg"])
    assert (k.ninputs, k.noutputs) == (3, 3) and k.native_dt == synth.DT
    assert rom.nstates == sum(1 if abs(lam.imag) <= 1e-6 else 2 for lam in kept)
    assert (kept.real > 0).sum() >= 1
    assert shared.certify(rom, k, dt=synth.DT) < 1.0


def test_torch_pinball_feedback_committed_controller_is_the_design(committed):
    """The committed compensator is ``design`` at (RU, RV) on the committed
    ROM: what ``pinball_mimo_synth --rom`` rebuilds. The Riccati equations
    at rv 1e9 are ill-conditioned: a rebuild on an 8-core x86 host moved A
    and C by 1.1e-7 of their largest entry, B and D not at all."""
    with np.load(committed["rom"]) as d:
        rom, kept = synth.StateSpace(d["A"], d["B"], d["C"]), d["kept"]
    k, _, _ = synth.design(rom, kept, ru=synth.RU, rv=synth.RV)
    kc = ControllerT.from_file(committed["lqg"])
    for name in "ABCD":
        got, want = np.asarray(getattr(k, name)), np.asarray(getattr(kc, name))
        assert got.shape == want.shape and np.abs(got - want).max() <= 1e-6 * max(
            np.abs(want).max(), 1.0), name


def test_torch_pinball_feedback_committed_controller_reads_in_both(committed):
    kt, kj = ControllerT.from_file(committed["lqg"]), ControllerJ.from_file(committed["lqg"])
    assert kt.native_dt == kj.native_dt == 5e-3
    for name in "ABCD":
        assert np.array_equal(np.asarray(getattr(kt, name)), np.asarray(getattr(kj, name))), name
