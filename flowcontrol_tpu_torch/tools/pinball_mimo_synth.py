"""Synthesize the fluidic pinball's MIMO LQG feedback (3 rotation actuators x
3 downstream V-sensors) on the host and write the files its closed loop
replays.

    python -m flowcontrol_tpu_torch.tools.pinball_mimo_synth [--re 100] [--meshpath M.xdmf]
        [--out DIR] [--scan | --rom DIR]

The port's copy of ``tools/pinball_mimo_synth.py``, its module-level script
cut into functions named after its parts. The JAX tool runs on the
reference's 302,035-dof stock mesh, which this repository does not hold,
with shifts placed on that mesh's spectrum; this one runs on a mesh it is
given, by default the generated ``pinball_mesh()`` (67,920 dofs). Pipeline,
all host float64 (``device="cpu"``, ``solver_backend="host_lu"``):

  base flow (models/make_baseflow.pinball_baseflow: a file that fits, or
             continuation in Re, or Picard + Newton)
  -> A, E, B, C                      (core/operatorgetter.py, autodiff A)
  -> spectrum scan, shifts           (utils/linalg.get_mat_vp_shift_invert)
  -> Petrov-Galerkin modal ROM       (utils/linalg.modal_rom)
  -> sampled-data LQG on the ROM     (utils/lticontrol.dlqg_regulator)
  -> the sampled interconnection certified, ROM energy ratios
  -> the files                       (utils/lticontrol.export_controller)

By default it makes the committed design's recipe (SHIFTS, ROM_K, RU, RV,
chosen on the plant: see their comment); ``--scan`` makes the JAX tool's
own recipe at this mesh: its shifts (``jax_shifts``) plus those
``choose_shifts`` adds from a scan of the spectrum at σ = SCAN_RE + jω, ω
in SCAN_OMEGAS, K_PER_SHIFT eigenvalues a shift and its ``weights``;
``--rom DIR`` designs (RU, RV) on the ROM and the mode an earlier run wrote
into DIR. ARPACK starts from a random vector, so the ROM, and the
compensator made on it, differ from run to run (``read_rom``); the
committed compensator is rebuilt from the committed ROM:

    python -m flowcontrol_tpu_torch.tools.pinball_mimo_synth \
        --rom flowcontrol_tpu_torch/models/_controllers

The flow-independent steps are the cavity tool's
(``tools/cavity_feedback_synth.py``).

Files, under ``--out`` (default ``./data_output_pinball_synth``, with the
base flow it computes; the committed ones are ``models/_controllers/``)
named by ``models/pinball.py`` ``pinball_feedback_files``, each with the
checksum of its mesh (``models/baseflows.mesh_checksum``):
  pinball_rom_re<Re>_n<dofs>.npz    ROM A, B, C, the kept eigenvalues, the shifts
  pinball_lqg_re<Re>_n<dofs>.mat    the discrete compensator A, B, C, D, dt
  pinball_mode_re<Re>_n<dofs>.npz   the leading eigenvalue, Re and Im of its
                                    eigenvector (float32, unit 2-norm)

At the default mesh the ROM of SHIFTS took 827 s on one core of an 8-core
x86 host (16 complex sparse LUs of 67,920 dofs, ARPACK's), the scan 506 s
more. Imports torch, numpy and scipy, never JAX.
"""

from __future__ import annotations

import argparse
import logging
import time
from pathlib import Path

import numpy as np

from flowcontrol_tpu_torch.models import make_baseflow
from flowcontrol_tpu_torch.models.pinball import PinballFlowSolver, pinball_feedback_files
from flowcontrol_tpu_torch.tools import cavity_feedback_synth as shared
from flowcontrol_tpu_torch.utils.lticontrol import dlqg_regulator
from flowcontrol_tpu_torch.utils.statespace import StateSpace

log = logging.getLogger("pinball_mimo_synth")

RE = 100.0  # BASELINE config #4
DT = 5e-3  # the pinball production dt (ref: test_pinball.py:59-65)
U_CTRL0 = make_baseflow.PINBALL_U0
#: the scan's shifts σ = SCAN_RE + jω
SCAN_RE = 0.1
SCAN_OMEGAS = tuple(np.arange(0.0, 2.01, 0.25))
SCAN_N = 4  # eigenvalues per scan shift
K_PER_SHIFT = 6
RE_MIN = -1.0
#: the shifts ``leading_mode`` tries (the JAX tool's ``:175``)
MODE_SIGMAS = (0.05 + 0.55j, 0.05 + 0.0j)
#: The committed design's ROM and weights (``main``'s defaults; the JAX
#: tool's are ``jax_shifts``, K_PER_SHIFT and ``weights``). Chosen on the
#: full plant on the card (``tools/pinball_design_search.py``, 20,000 steps
#: from 2e-4 Re(v) of the leading mode, the JAX test's trajectory, with the
#: compensator's gain halved and doubled): every design with the JAX tool's
#: shifts (ROM order 24, 36 with k 10, 41 with k 12), the scan's shifts
#: (36) and the scan's with k 10 (56) diverged at (ru, rv) = (1e2-1e6,
#: 1e-3-1e3), as the stock mesh's did; low-gain designs stay bounded. The
#: rule, the lowest closed/open energy at 20,000 steps among the designs
#: that do not diverge with the gain halved or doubled, takes these shifts
#: with k 8 (order 88) at (1e4, 1e9): 0.9992 of the open loop's energy
#: (0.9995 halved, 1.038 doubled). The runner-up, the scan's shifts with
#: k 10 (56) at (1e3, 1e9), ends at 0.9995 (0.9998 halved, 0.9994 doubled),
#: below the open loop at every gain; both barely act (|u| < 1e-6). No
#: design tried reaches the JAX test's 0.5: the leading mode (the real
#: pitchfork, λ = 0.0474) reaches the sensors ~1e5 times more weakly than
#: the shedding pairs do, so a gain that moves it drives them unstable
#: (ROADMAP, "Faults in the reference").
SHIFTS = (0j, 0.25j, 0.5j, 0.75j, 0.1 + 1.1j, 1.5j, -0.51 + 1.78j, 2j)
ROM_K = 8
RU, RV = 1e4, 1e9


def jax_shifts(re: float) -> list:
    """The JAX tool's shifts (its ``:150-152``): the shedding branch near
    ω ≈ 0.75 and the origin, with a second oscillatory shift from Re 80 up.
    They were placed on the stock mesh's spectrum."""
    if re >= 80.0:
        return [0.0 + 0.75j, 0.1 + 1.1j, 0.0 + 0.0j]
    return [0.0 + 0.75j, 0.0 + 0.0j]


def weights(re: float) -> tuple:
    """The JAX tool's (ru, rv) (its ``:218-219``)."""
    return (100.0 if re >= 80.0 else 1.0), 1e-3


def energy_steps(re: float) -> tuple:
    """The quarters of the JAX tool's ROM energy horizon (its ``:236``):
    20,000 steps from Re 80 up, else 8,000."""
    n_rep = 20000 if re >= 80.0 else 8000
    return tuple(n_rep // 4 * i for i in range(1, 5))


def flow(re: float, out_dir: Path, mesh=None, meshpath=None) -> PinballFlowSolver:
    """The pinball at ``re`` on the host in float64 with its base flow
    (``make_baseflow.pinball_baseflow``; one it computes is written into
    ``out_dir``)."""
    t0 = time.time()
    fs = make_baseflow.pinball_solver(re, mesh=mesh, meshpath=meshpath, path_out=out_dir)
    log.info("pinball: %d dofs (%.0fs)", fs.space.n_dofs, time.time() - t0)
    make_baseflow.pinball_baseflow(fs, out_dir)
    return fs


def reaches(scan: np.ndarray, shift: complex, lam: complex, k: int = K_PER_SHIFT) -> bool:
    """Whether the ``k`` eigenvalues ARPACK returns at ``shift`` take in
    ``lam``, as far as the scan shows: fewer than ``k`` - 1 of the scan's λ
    (both halves of each pair) lie nearer ``shift``, one place kept for a λ
    the scan missed."""
    both = np.concatenate([scan, np.conj(scan[np.abs(scan.imag) > 1e-6])])
    return int((np.abs(both - shift) < abs(lam - shift) - 1e-12).sum()) < k - 1


def choose_shifts(scan: np.ndarray, re: float, k: int = K_PER_SHIFT) -> list:
    """The ROM's shifts from a scan of this mesh: the JAX tool's, then one at
    each unstable λ (Re > 0) that none of them ``reaches``, then one at the
    least-damped λ above the band, the cavity tool's rule (frequency above
    the unstable λ's by at least 1), so the ROM reaches past the loop's
    active band."""
    shifts = jax_shifts(re)
    unstable = scan[scan.real > shared.UNSTABLE_RE]
    for lam in unstable[np.argsort(-unstable.real)]:
        if not any(reaches(scan, s, lam, k) for s in shifts):
            shifts.append(complex(np.round(lam, 2)))
    band = unstable if len(unstable) else scan[[np.argmax(scan.real)]]
    above = scan[scan.imag > band.imag.max() + 1.0]
    if len(above):
        shifts.append(complex(np.round(above[np.argmax(above.real)], 2)))
    return shifts


def leading_mode(a, e) -> tuple:
    """The eigenpair of largest real part among the two nearest each of
    MODE_SIGMAS (the JAX tool's ``:175``): (λ, v), v of unit 2-norm."""
    best = None
    for sig in MODE_SIGMAS:
        lam, v = shared.leading_mode(a, e, sig)
        if best is None or lam.real > best[0].real:
            best = (lam, v)
    return best


def design(rom: StateSpace, kept, dt: float = DT, ru: float = 100.0, rv: float = 1e-3):
    """The JAX tool's sampled-data LQG (its ``:207-219``): Q = Qw = the
    selector of the unstable modes' states + 1e-9 I, by default at its
    Re ≥ 80 weights (ru 100, rv 1e-3; ``weights``); returns
    ``dlqg_regulator``'s (Kd, F, L).

    Known fault kept from the JAX package (ROADMAP, "Faults in the
    reference"): ``dlqg_regulator`` puts the filter Kalman gain into a
    predictor-form compensator, so the separation principle does not
    certify the loop. ``certify`` builds the interconnection from the
    compensator as it is deployed, so its verdict holds all the same."""
    nx = rom.nstates
    sel, _ = shared.mode_offsets(kept)
    q = np.diag(sel) + 1e-9 * np.eye(nx)
    qw = np.diag(sel) + 1e-9 * np.eye(nx)
    return dlqg_regulator(rom, dt, ru=ru, rv=rv, Q=q, Qw=qw)


def residues(rom: StateSpace, kept) -> dict:
    """{λ: the largest entry of |C_k B_k|} for each unstable kept λ: how
    strongly the actuators reach that mode's part of the sensors."""
    _, offsets = shared.mode_offsets(kept)
    out = {}
    for lam in kept[np.real(kept) > shared.UNSTABLE_RE]:
        o = offsets[complex(lam)]
        w = 1 if abs(lam.imag) <= 1e-6 else 2
        out[complex(np.round(lam, 4))] = float(np.abs(
            np.asarray(rom.C)[:, o:o + w] @ np.asarray(rom.B)[o:o + w]).max())
    return out


def read_rom(fs, directory) -> tuple:
    """(ROM, kept λ, shifts, (λ, v) of the leading mode) from the files this
    tool wrote into ``directory`` for ``fs``'s Re and mesh (``ValueError``
    on another mesh): a design on an earlier run's ROM. ARPACK starts from a
    random vector, so a real mode's block (``modal_rom``'s cos² of the
    eigenvector's phase, ROADMAP "Faults in the reference") differs from
    run to run; a design chosen on one ROM is made on that ROM."""
    from flowcontrol_tpu_torch.models.baseflows import require_mesh
    from flowcontrol_tpu_torch.models.pinball import load_pinball_mode

    paths = pinball_feedback_files(fs.space.n_dofs, fs.params_flow.Re, directory)
    with np.load(paths["rom"], allow_pickle=False) as d:
        require_mesh(paths["rom"], d["mesh_sha256"], fs.mesh)
        rom = StateSpace(d["A"], d["B"], d["C"])
        kept, shifts = d["kept"], [complex(x) for x in d["shifts"]]
    mode = load_pinball_mode(fs, paths["mode"])
    v = mode["v_re"].astype(np.float64) + 1j * mode["v_im"].astype(np.float64)
    return rom, kept, shifts, (np.complex128(mode["eig"]), v)


def main(re: float = RE, mesh=None, meshpath=None, out_dir=None, scan: bool = False,
         rom_dir=None) -> dict:
    """The whole synthesis; returns its figures (the scan, the shifts, the
    kept λ, the ROM order, the radii, the energy ratios, the seconds) and
    the paths written into ``out_dir`` (default
    ``./data_output_pinball_synth``). By default the committed design's
    recipe (SHIFTS, ROM_K, RU, RV); ``scan`` the JAX tool's at this mesh
    (``choose_shifts`` on a scan, K_PER_SHIFT, ``weights``); with
    ``rom_dir`` RU, RV on an earlier run's ROM and mode (``read_rom``): no
    operators, scan or eigenvalues."""
    t0 = time.time()
    out_dir = Path.cwd() / "data_output_pinball_synth" if out_dir is None else Path(out_dir)
    fs = flow(re, out_dir, mesh=mesh, meshpath=meshpath)
    found, ru, rv = None, RU, RV
    if rom_dir is not None:
        rom, kept, shifts, mode = read_rom(fs, rom_dir)
        log.info("ROM and mode read from %s", rom_dir)
    else:
        a, e, b, c = shared.operators(fs, autodiff=True, u_ctrl=U_CTRL0)
        shifts, k_per_shift = SHIFTS, ROM_K
        if scan:
            found = shared.spectrum_scan(a, e, [SCAN_RE + 1j * w for w in SCAN_OMEGAS], n=SCAN_N)
            near = found[found.real > RE_MIN]
            log.info("scan: %d eigenvalues, %d with Re > %g: %s", len(found), len(near), RE_MIN,
                     np.round(near, 4))
            shifts, k_per_shift, (ru, rv) = choose_shifts(found, re), K_PER_SHIFT, weights(re)
        log.info("shifts %s", shifts)
        rom, kept = shared.build_rom(a, e, b, c, shifts, k_per_shift=k_per_shift, re_min=RE_MIN)
        mode = leading_mode(a, e)
    rom_eigs = np.linalg.eigvals(np.asarray(rom.A))
    n_unstable = int((rom_eigs.real > shared.UNSTABLE_RE).sum())
    log.info("ROM order %d; kept eigs %s; unstable %d", rom.nstates,
             np.round(np.sort_complex(kept), 4), n_unstable)
    log.info("unstable modes' residues max|C_k B_k|: %s", residues(rom, kept))
    k, _, _ = design(rom, kept, ru=ru, rv=rv)
    k_radius = float(np.abs(np.linalg.eigvals(np.asarray(k.A))).max())
    log.info("LQG weights ru %g, rv %g; the compensator's own spectral radius %.5f", ru, rv,
             k_radius)
    sr = shared.certify(rom, k, dt=DT)
    ratios = shared.rom_energy_ratios(rom, k, kept, dt=DT, steps=energy_steps(re))
    paths = shared.write_artifacts(
        fs, rom, kept, shifts, k, mode, dt=DT,
        paths=pinball_feedback_files(fs.space.n_dofs, fs.params_flow.Re, out_dir))
    seconds = time.time() - t0
    log.info("controller exported: %s (%d states, %d inputs, %d outputs, discrete dt=%g, "
             "sampled spectral radius %.5f)", paths["lqg"], k.nstates, k.ninputs, k.noutputs,
             DT, sr)
    print(f"DONE re={re:g} rom={rom.nstates} states sampled_sr={sr:.5f} "
          f"open_max_re={rom_eigs.real.max():.4f} seconds={seconds:.0f}")
    return dict(scan=found, shifts=shifts, kept=kept, rom_order=rom.nstates,
                n_unstable=n_unstable, eig=mode[0], ru=ru, rv=rv, k_radius=k_radius, radius=sr,
                energy_ratios=ratios, seconds=seconds, paths=paths)


if __name__ == "__main__":
    logging.basicConfig(level=logging.INFO)
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--re", type=float, default=RE)
    ap.add_argument("--meshpath", default=None, help="an .xdmf mesh (default: pinball_mesh())")
    ap.add_argument("--out", default=None,
                    help="output directory (default ./data_output_pinball_synth)")
    how = ap.add_mutually_exclusive_group()
    how.add_argument("--scan", action="store_true",
                     help="the JAX tool's recipe: choose_shifts on a scan, k 6, its weights")
    how.add_argument("--rom", default=None,
                     help="design on the ROM and mode this tool wrote into this directory")
    args = ap.parse_args()
    main(args.re, meshpath=args.meshpath, out_dir=args.out, scan=args.scan, rom_dir=args.rom)
