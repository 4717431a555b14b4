"""Choose the pinball LQG's weights on the plant: batches of designs closed
around the full-order pinball on the card, each batch one closed loop
through the multifrontal solve F.

    python -m flowcontrol_tpu_torch.tools.pinball_design_search --roms DIR [DIR ...]
        [--ru 100 ...] [--rv 1e-3 1e-1 ...] [--gains 0.5 1 2] [--steps 20000] [--rows 8]
        [--out FILE]

Each DIR holds the ``pinball_{rom,mode}_re100_n<dofs>.npz`` that
``tools/pinball_mimo_synth.py`` wrote; the leading mode is the first DIR's
(one initial condition for every design). For each ROM and each (ru, rv)
it designs the tool's LQG (``pinball_mimo_synth.design``) and reports, on
the host, the compensator's own spectral radius, the sampled
interconnection's radius with the ROM and the ROM's closed/open energy at
the quarters of ``--steps``; then on the card, from 2e-4 x Re(v) (the
example's start), the plant's closed/open energy at those steps for the
compensator's output scaled by each of ``--gains`` (the margins), with
u = 0 as one more row. Rows go ``--rows`` at a time: 8, F's limit, by
default; past 8 a batch takes the per-stage sweep (K2, P1, S).
Compensators are padded with inert states to the batch's largest. One JSON
line a design and gain, in ``--out`` too. Imports torch, numpy and scipy,
never JAX.
"""

from __future__ import annotations

import argparse
import json
import logging
import time
from pathlib import Path

import numpy as np
import torch

from flowcontrol_tpu_torch.tools import cavity_feedback_synth as shared
from flowcontrol_tpu_torch.tools import pinball_mimo_synth as synth

log = logging.getLogger("pinball_design_search")

ROWS = 8  # F's largest batch


def host_figures(rom, kept, k, steps) -> dict:
    """The compensator's own radius, the sampled radius with the ROM and
    the ROM's closed/open energy at ``steps``."""
    m, _ = shared.sampled_interconnection(rom, k, synth.DT)
    return dict(k_radius=float(np.abs(np.linalg.eigvals(np.asarray(k.A))).max()),
                sampled_radius=float(np.abs(np.linalg.eigvals(m)).max()),
                rom_ratios=shared.rom_energy_ratios(rom, k, kept, dt=synth.DT, steps=steps))


def stacked(ks: list, dt: float) -> tuple:
    """The discrete (A, B, C, D) of each row, zero-padded to the largest
    order (the padded states start at zero and stay there); a row of None
    is the open loop (C = D = 0)."""
    nk = max([k.nstates for k in ks if k is not None] + [1])
    ns, na = next((k.ninputs, k.noutputs) for k in ks if k is not None)
    mats = [np.zeros((len(ks), nk, nk)), np.zeros((len(ks), nk, ns)),
            np.zeros((len(ks), na, nk)), np.zeros((len(ks), na, ns))]
    for i, k in enumerate(ks):
        if k is not None:
            ad, bd, cd, dd = k.discrete(dt)
            n = ad.shape[0]
            mats[0][i, :n, :n], mats[1][i, :n], mats[2][i, :, :n], mats[3][i] = ad, bd, cd, dd
    return tuple(mats)


def plant_batch(fs, u0: np.ndarray, y0: np.ndarray, ks: list, steps: int) -> dict:
    """One closed loop of len(ks) rows through F from the state ``u0``
    (y0 its sensors), ``steps`` steps; returns dE (steps, rows), max |u| a
    row and whether each row diverged, and the seconds."""
    st, dt = fs.stepper, fs.params_time.dt
    rows = len(ks)
    carry = st.init_carry(torch.as_tensor(u0, dtype=st.dtype, device=st.device)
                          .expand(rows, -1).contiguous())
    t0 = time.perf_counter()
    _, (ys, des, us, div) = st.closed_loop_fn(steps, feedback_sign=+1.0)(
        carry, stacked(ks, dt), np.tile(y0, (rows, 1)))
    de = des.double().cpu().numpy()
    out = dict(de=de, umax=us.abs().amax(dim=(0, 2)).double().cpu().numpy(),
               diverged=div.any(dim=0).cpu().numpy() | ~np.isfinite(de).all(axis=0))
    out["seconds"] = time.perf_counter() - t0
    return out


def main(roms, ru=(100.0,), rv=(1e-3,), gains=(0.5, 1.0, 2.0), steps: int = 20000,
         out=None, device: str = "cuda", rows: int = ROWS, re: float = synth.RE,
         **flow_kwargs) -> list:
    """Every design of ``roms`` x ``ru`` x ``rv`` on the host and on the
    plant at ``re`` (the example's solver, ``flow_kwargs`` passed on to its
    ``make_flow``) from the first directory's leading mode; returns the rows
    written."""
    from flowcontrol_tpu_torch.core.controller import Controller
    from flowcontrol_tpu_torch.examples import run_pinball_feedback as example
    from flowcontrol_tpu_torch.models.pinball import load_pinball_mode, pinball_feedback_files

    marks = tuple(steps // 4 * i for i in range(1, 5))
    fs = example.make_flow(steps, re=re, device=device, **flow_kwargs)
    example.start(fs, load_pinball_mode(fs, pinball_feedback_files(
        fs.space.n_dofs, fs.params_flow.Re, roms[0])["mode"]))
    u0 = np.concatenate([fs.fields.u_n.reshape(-1), fs.fields.p_n])
    y0 = np.asarray(fs.y_meas, dtype=float)
    designs = []
    for directory in roms:
        rom, kept, shifts, _ = synth.read_rom(fs, directory)
        for r_u in ru:
            for r_v in rv:
                k, _, _ = synth.design(rom, kept, ru=r_u, rv=r_v)
                base = dict(rom=str(directory), rom_order=rom.nstates,
                            shifts=[str(s) for s in shifts], ru=r_u, rv=r_v,
                            **host_figures(rom, kept, k, marks))
                log.info("design %s", {key: v for key, v in base.items() if key != "shifts"})
                for g in gains:
                    kg = Controller.from_matrices(A=np.asarray(k.A), B=np.asarray(k.B),
                                                  C=g * np.asarray(k.C), D=g * np.asarray(k.D),
                                                  dt=synth.DT)
                    designs.append((dict(base, gain=g), kg))
    designs.append((dict(rom=None, gain=0.0), None))  # the open loop
    results = []
    for i in range(0, len(designs), rows):
        chunk = designs[i:i + rows]
        res = plant_batch(fs, u0, y0, [k for _, k in chunk], steps)
        log.info("batch of %d rows, %d steps: %.1f s", len(chunk), steps, res["seconds"])
        for j, (meta, _) in enumerate(chunk):
            results.append((meta, res["de"][:, j], float(res["umax"][j]),
                            bool(res["diverged"][j])))
    de_open = results[-1][1]
    written = []
    for meta, de, umax, div in results:
        row = dict(meta, plant_ratios={n: float(de[n - 1] / de_open[n - 1]) for n in marks},
                   umax=umax, diverged=div, open_growth=float(de_open[-1] / de_open[0]))
        written.append(row)
        print(json.dumps(row), flush=True)
    if out is not None:
        Path(out).parent.mkdir(parents=True, exist_ok=True)
        Path(out).write_text("".join(json.dumps(r) + "\n" for r in written))
    return written


if __name__ == "__main__":
    logging.basicConfig(level=logging.INFO)
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--roms", nargs="+", required=True)
    ap.add_argument("--ru", nargs="+", type=float, default=[100.0])
    ap.add_argument("--rv", nargs="+", type=float, default=[1e-3])
    ap.add_argument("--gains", nargs="+", type=float, default=[0.5, 1.0, 2.0])
    ap.add_argument("--steps", type=int, default=20000)
    ap.add_argument("--out", default=None)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--rows", type=int, default=ROWS, help="rows a batch (8: F's limit)")
    args = ap.parse_args()
    main(args.roms, args.ru, args.rv, args.gains, args.steps, args.out, args.device, args.rows)
