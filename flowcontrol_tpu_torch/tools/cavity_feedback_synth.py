"""Synthesize the open cavity's LQG feedback at Re=7500 on the host and write
the files its closed loop replays.

    python -m flowcontrol_tpu_torch.tools.cavity_feedback_synth [--meshpath M.xdmf] [--out DIR]
        [--shifts 0.5+8j 1+11.1j 1+14.2j 0.4+17.2j "(-0.6+20.3j)"]

The port's copy of ``tools/cavity_feedback_synth.py``, its module-level
script cut into functions named after its parts. The JAX tool runs on the
reference's 235,374-dof stock mesh, which this repository does not hold,
around that mesh's four documented unstable pairs; this one runs on a mesh
it is given, by default the generated ``cavity_mesh()`` (120,068 dofs),
with the committed base flow where its checksum matches (else Picard then
Newton on the host). Its shifts come from that mesh's own spectrum: unless
``shifts`` are given, ``spectrum_scan`` at σ = 0.5 + jω, ω in SCAN_OMEGAS,
then ``choose_shifts``. Pipeline, all host float64 (``device="cpu"``,
``solver_backend="host_lu"``):

  base flow -> A, E, B, C            (core/operatorgetter.py)
  -> spectrum scan, shifts           (utils/linalg.get_mat_vp_shift_invert)
  -> Petrov-Galerkin modal ROM       (utils/linalg.modal_rom)
  -> sampled-data LQG on the ROM     (utils/lticontrol.dlqg_regulator,
                                     the weights RU, RV below)
  -> the sampled interconnection certified, ROM energy ratios
  -> the files                       (utils/lticontrol.export_controller)

Files, under ``models/_controllers/`` unless ``out_dir`` says otherwise
(``models/cavity.py`` ``cavity_feedback_files``), each with the checksum of
its mesh (``models/baseflows.mesh_checksum``):
  cavity_rom_re7500_n<dofs>.npz    ROM A, B, C, the kept eigenvalues, the shifts
  cavity_lqg_re7500_n<dofs>.mat    the discrete compensator A, B, C, D, dt
  cavity_mode_re7500_n<dofs>.npz   the leading eigenvalue, Re and Im of its
                                   eigenvector (float32, unit 2-norm)

At the default mesh, with ``--shifts`` given, a run takes about 25 minutes
on one CPU core (ten complex sparse LUs of 120,068 dofs, ARPACK's); the
scan adds nine shifts of about two minutes each. Imports torch, numpy and
scipy, never JAX.
"""

from __future__ import annotations

import argparse
import logging
import time
from pathlib import Path

import numpy as np
import scipy.io as sio
from scipy.linalg import expm

from flowcontrol_tpu_torch.core.operatorgetter import OperatorGetter
from flowcontrol_tpu_torch.models.baseflows import committed_baseflow, mesh_checksum
from flowcontrol_tpu_torch.models.cavity import (
    CONTROLLER_DIR,
    CavityFlowSolver,
    cavity_feedback_files,
)
from flowcontrol_tpu_torch.utils.linalg import get_mat_vp_shift_invert, modal_rom
from flowcontrol_tpu_torch.utils.lticontrol import dlqg_regulator, export_controller
from flowcontrol_tpu_torch.utils.statespace import StateSpace

log = logging.getLogger("cavity_feedback_synth")

RE = 7500.0
DT = 4e-4  # the cavity production dt (ref: cavityflowsolver.py:254-268)
#: the scan's shifts σ = SCAN_RE + jω
SCAN_RE = 0.5
SCAN_OMEGAS = tuple(np.arange(5.0, 25.01, 2.5))
SCAN_N = 6  # eigenvalues per scan shift
#: a λ counts as unstable above this real part
UNSTABLE_RE = 0.0
ENERGY_STEPS = (1000, 2000, 3000, 4000)
#: the LQG's weights in ``main``: the JAX tool's ru, with rv lowered from its
#: 1e5 to 1e3. Chosen on the full plant at the default mesh (closed loops of
#: 4000 steps on the card from the leading mode, the trajectory of the JAX
#: test): there the JAX tool's (100, 1e5) ends at 0.88 x the open loop's
#: energy, (100, 1e3) at 0.72-0.75 (the mode's phase, which ARPACK picks,
#: moves it) and stays bounded with its gain doubled;
#: rv <= 300 (and ru <= 10 at rv = 100) drive the plant unstable, as the
#: stock mesh's higher-gain designs did. The modal ROM does not see this:
#: it predicts 0.15-0.22 at step 4000 for both, and the plant's H(jω) near
#: the unstable frequencies is ~2x the ROM's.
RU, RV = 100.0, 1e3


def flow(mesh=None, meshpath=None) -> CavityFlowSolver:
    """The cavity at Re=7500 on the host in float64 (the JAX tool's
    ``make_default(..., solver_backend="host_lu", precision="f64")``) with
    its base flow: the committed file where the mesh's checksum matches,
    else Picard (10, tol 1e-7) then Newton (10) on the host."""
    t0 = time.time()
    fs = CavityFlowSolver.make_default(
        Re=RE, mesh=mesh, meshpath=meshpath, num_steps=10, save_every=0, verbose=10,
        path_out=Path.cwd() / "data_output_cavity_synth",
        solver_backend="host_lu", precision="f64", device="cpu",
    )
    log.info("cavity: %d dofs (%.0fs)", fs.space.n_dofs, time.time() - t0)
    base = committed_baseflow(fs)
    if base is not None:
        fs.load_steady_state(base)
        log.info("loaded committed base flow %s", base.name)
    else:
        t1 = time.time()
        fs.compute_steady_state(method="picard", max_iter=10, tol=1e-7, u_ctrl=[0.0])
        fs.compute_steady_state(method="newton", max_iter=10, u_ctrl=[0.0],
                                initial_guess=fs.fields.UP0)
        log.info("base flow by Picard + Newton (%.0fs)", time.time() - t1)
    return fs


def operators(fs, autodiff: bool = False, u_ctrl=(0.0,)) -> tuple:
    """(A, E, B, C) around ``fs``'s base flow at the control ``u_ctrl``, B
    as (n, n_act) and C as (n_sens, n) (the JAX tool's ``_operators``)."""
    t1 = time.time()
    a, e, b, c = OperatorGetter(fs).get_all(autodiff=autodiff, u_ctrl=list(u_ctrl))
    b = np.atleast_2d(np.asarray(b))
    if b.shape[0] != fs.space.n_dofs:
        b = b.T
    c = np.atleast_2d(np.asarray(c))
    log.info("operators: A %s nnz %d, B %s, C %s (%.0fs)", a.shape, a.nnz, b.shape, c.shape,
             time.time() - t1)
    return a, e, b, c


def spectrum_scan(a, e, sigmas, n: int = SCAN_N) -> np.ndarray:
    """The eigenvalues of A x = λ E x nearest each shift in ``sigmas`` (n
    each, shift-invert), one of each conjugate pair, duplicates across
    shifts dropped, sorted by imaginary part."""
    found = []
    for s in sigmas:
        t0 = time.time()
        vals = get_mat_vp_shift_invert(a, e, n=n, sigma=s, return_vectors=False)
        log.info("scan σ = %s: %s (%.0fs)", s, np.round(np.sort_complex(vals), 4), time.time() - t0)
        for lam in vals:
            if lam.imag < -1e-6:
                lam = np.conj(lam)
            if not any(abs(lam - f) < 1e-6 * max(1.0, abs(lam)) for f in found):
                found.append(lam)
    found = np.asarray(found)
    return found[np.argsort(found.imag)]


def choose_shifts(scan: np.ndarray) -> list:
    """The ROM's shifts from a scan: one at each unstable λ (Re > 0), else
    at the least-damped λ; then the next branch above them, the least-damped
    λ whose frequency is above theirs by at least 1, so the ROM reaches past
    the loop's active band (the JAX tool's reason: a design that left the
    first out-of-band mode unmodeled drove it unstable on the full plant,
    observation spillover at ω ≈ 19.6 on the stock mesh)."""
    scan = scan[scan.imag <= max(SCAN_OMEGAS)]
    band = list(scan[scan.real > UNSTABLE_RE]) or [scan[np.argmax(scan.real)]]
    above = scan[scan.imag > max(lam.imag for lam in band) + 1.0]
    if len(above):
        band.append(above[np.argmax(above.real)])
    return [complex(np.round(lam, 1)) for lam in band]


def build_rom(a, e, b, c, shifts, k_per_shift: int = 4, re_min: float = -2.0):
    """The Petrov-Galerkin modal ROM around ``shifts`` (``modal_rom``);
    returns (StateSpace, kept eigenvalues)."""
    t2 = time.time()
    rom, kept = modal_rom(a, e, b, c, shifts=list(shifts), k_per_shift=k_per_shift, re_min=re_min)
    log.info("ROM built: order %d, %d kept eigenvalues (%.0fs)", rom.nstates, len(kept),
             time.time() - t2)
    return rom, kept


def leading_mode(a, e, sigma: complex) -> tuple:
    """The eigenpair of largest real part among the two nearest ``sigma``:
    (λ, v) with v of unit 2-norm (complex128; ``write_artifacts`` stores its
    real and imaginary parts in float32, as the JAX tool's mode export)."""
    t3 = time.time()
    vals, vecs = get_mat_vp_shift_invert(a, e, n=2, sigma=sigma)
    i0 = int(np.argmax(vals.real))
    v = vecs[:, i0] / np.linalg.norm(vecs[:, i0])
    log.info("leading mode %.4f%+.4fj (%.0fs)", vals[i0].real, vals[i0].imag, time.time() - t3)
    return np.complex128(vals[i0]), v


def mode_offsets(kept) -> tuple:
    """The ROM's state selector (1 on the unstable modes' states) and each
    kept eigenvalue's first state."""
    widths = [1 if abs(lam.imag) <= 1e-6 else 2 for lam in kept]
    sel = np.zeros(sum(widths))
    offsets, off = {}, 0
    for lam, wdt in zip(kept, widths):
        offsets[complex(lam)] = off
        if lam.real > UNSTABLE_RE:
            sel[off:off + wdt] = 1.0
        off += wdt
    return sel, offsets


def design_lqg(rom: StateSpace, kept, dt: float = DT, ru: float = 100.0, rv: float = 1e5):
    """The sampled-data LQG of the JAX tool: state weights focused on the
    unstable subspace (Q = 1 on its states, 0.01 elsewhere, + 1e-9 I; Qw the
    selector + 1e-9 I), by default at its low-gain point (ru 100, rv 1e5;
    ``main`` takes RU, RV); returns ``dlqg_regulator``'s (Kd, F, L).

    Known fault kept from the JAX package (ROADMAP, "Faults in the
    reference"): ``dlqg_regulator`` puts the filter Kalman gain into a
    predictor-form compensator, so the separation principle does not
    certify the loop. ``certify`` builds the interconnection from the
    compensator as it is deployed, so its verdict holds all the same."""
    nx = rom.nstates
    sel, _ = mode_offsets(kept)
    q = np.diag(sel + 0.01 * (1 - sel)) + 1e-9 * np.eye(nx)
    qw = np.diag(sel) + 1e-9 * np.eye(nx)
    return dlqg_regulator(rom, dt, ru=ru, rv=rv, Q=q, Qw=qw)


def sampled_interconnection(rom: StateSpace, k: StateSpace, dt: float) -> tuple:
    """(M, Ad): the ROM sampled at ``dt`` (ZOH) in loop with the discrete
    compensator k, u = +k(y), state [x; x_k]; and the ROM's own Ad."""
    ai, bi, cr = (np.asarray(m) for m in (rom.A, rom.B, rom.C))
    nx = ai.shape[0]
    adp = expm(ai * dt)
    bdp = np.linalg.solve(ai, adp - np.eye(nx)) @ bi
    m = np.block([[adp, bdp @ np.asarray(k.C)], [np.asarray(k.B) @ cr, np.asarray(k.A)]])
    return m, adp


def certify(rom: StateSpace, k: StateSpace, dt: float = DT) -> float:
    """The sampled closed loop's spectral radius; ``AssertionError`` where
    it is not below 1 (the JAX tool's assert)."""
    m, _ = sampled_interconnection(rom, k, dt)
    sr = float(np.abs(np.linalg.eigvals(m)).max())
    if not sr < 1.0:
        raise AssertionError(f"sampled closed loop unstable (spectral radius {sr})")
    return sr


def rom_energy_ratios(rom: StateSpace, k: StateSpace, kept, dt: float = DT,
                      steps=ENERGY_STEPS) -> dict:
    """{N: closed-loop / open-loop ROM energy at step N, for N in ``steps``}
    from the leading mode's initial state (0.5 on its first state), the
    trajectory the closed-loop test pins."""
    m, adp = sampled_interconnection(rom, k, dt)
    nx = adp.shape[0]
    _, offsets = mode_offsets(kept)
    lam0 = kept[np.argmax(np.real(kept))]
    x0 = np.zeros(nx)
    x0[offsets[complex(lam0)]] = 0.5
    z, zo = np.concatenate([x0, np.zeros(nx)]), x0.copy()
    out = {}
    for i in range(1, max(steps) + 1):
        z, zo = m @ z, adp @ zo
        if i in steps:
            out[i] = float(np.sum(z[:nx] ** 2) / np.sum(zo ** 2))
            log.info("ROM closed/open energy at N=%d: %.3f", i, out[i])
    return out


def write_artifacts(fs, rom: StateSpace, kept, shifts, k: StateSpace, mode: tuple,
                    out_dir=None, paths=None, dt: float = DT) -> dict:
    """Write the three files for ``fs``'s mesh (``paths``, default
    ``cavity_feedback_files``'), each with the mesh's checksum, the
    compensator discrete at ``dt``."""
    paths = paths or cavity_feedback_files(fs.space.n_dofs, RE, out_dir)
    paths["rom"].parent.mkdir(parents=True, exist_ok=True)
    sha = mesh_checksum(fs.mesh)
    np.savez_compressed(paths["rom"], A=np.asarray(rom.A), B=np.asarray(rom.B),
                        C=np.asarray(rom.C), kept=np.asarray(kept),
                        shifts=np.asarray(shifts, dtype=complex), mesh_sha256=sha)
    export_controller(paths["lqg"], k, dt=dt)
    mat = {key: v for key, v in sio.loadmat(str(paths["lqg"])).items() if not key.startswith("__")}
    sio.savemat(str(paths["lqg"]), {**mat, "mesh_sha256": sha})
    eig, v = mode
    np.savez_compressed(paths["mode"], eig=eig, v_re=np.asarray(v.real, dtype=np.float32),
                        v_im=np.asarray(v.imag, dtype=np.float32), mesh_sha256=sha)
    return paths


def main(mesh=None, meshpath=None, out_dir=None, shifts=None) -> dict:
    """The whole synthesis; returns its figures (the scan, the shifts, the
    kept λ, the ROM order, the spectral radius, the energy ratios, the
    seconds) and the paths written."""
    t0 = time.time()
    fs = flow(mesh=mesh, meshpath=meshpath)
    a, e, b, c = operators(fs)
    scan = None
    if shifts is None:
        scan = spectrum_scan(a, e, [SCAN_RE + 1j * w for w in SCAN_OMEGAS])
        near = scan[scan.real > -2.0]
        log.info("scan: %d eigenvalues, %d with Re > -2: %s", len(scan), len(near),
                 np.round(near, 4))
        shifts = choose_shifts(scan)
    log.info("shifts %s", shifts)
    rom, kept = build_rom(a, e, b, c, shifts)
    rom_eigs = np.linalg.eigvals(np.asarray(rom.A))
    n_unstable = int((rom_eigs.real > UNSTABLE_RE).sum())
    log.info("ROM order %d; kept eigs %s; unstable %d", rom.nstates,
             np.round(np.sort_complex(kept), 4), n_unstable)
    lam0 = kept[np.argmax(np.real(kept))]
    mode = leading_mode(a, e, complex(np.round(lam0, 1)))
    k, _, _ = design_lqg(rom, kept, ru=RU, rv=RV)
    log.info("LQG weights ru %g, rv %g", RU, RV)
    sr = certify(rom, k)
    ratios = rom_energy_ratios(rom, k, kept)
    paths = write_artifacts(fs, rom, kept, shifts, k, mode, out_dir=out_dir)
    seconds = time.time() - t0
    log.info("controller exported: %s (%d states, %d inputs, %d outputs, discrete dt=%g, "
             "sampled spectral radius %.5f)", paths["lqg"], k.nstates, k.ninputs, k.noutputs,
             DT, sr)
    print(f"DONE rom={rom.nstates} states sampled_sr={sr:.5f} "
          f"open_max_re={rom_eigs.real.max():.4f} seconds={seconds:.0f}")
    return dict(scan=scan, shifts=shifts, kept=kept, rom_order=rom.nstates,
                n_unstable=n_unstable, eig=mode[0], radius=sr, energy_ratios=ratios,
                seconds=seconds, paths=paths)


if __name__ == "__main__":
    logging.basicConfig(level=logging.INFO)
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--meshpath", default=None, help="an .xdmf mesh (default: cavity_mesh())")
    ap.add_argument("--out", default=None, help=f"output directory (default {CONTROLLER_DIR})")
    ap.add_argument("--shifts", nargs="*", type=complex, default=None,
                    help="the ROM's shifts (default: from the spectrum scan); one "
                    "with a leading minus in parentheses, e.g. \"(-0.6+20.3j)\"")
    args = ap.parse_args()
    main(meshpath=args.meshpath, out_dir=args.out, shifts=args.shifts)
