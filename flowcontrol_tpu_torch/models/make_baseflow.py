"""Compute a flow's base flow at its generated default mesh on the host and
commit it.

    python -m flowcontrol_tpu_torch.models.make_baseflow {cavity,cylinder_big,lidcavity,pinball} [--out DIR]

Builds the flow's default solver on the CPU and runs its recipe in float64:

- ``cavity`` (open cavity, Re=7500): Picard (``max_iter=10, tol=1e-7``),
  then Newton (``max_iter=10``) from the Picard field, the JAX package's
  cavity tests' and bench's recipe;
- ``lidcavity`` (lid-driven cavity, Re=8000, ``lidcavity_mesh(64)``):
  Picard (5) from rest at Re=1000, then Newton (``max_iter=20``) at each Re
  of the continuation 1000, 2000, ..., 8000, each from the last field, with
  pseudo-transient continuation (``ptc_dt0=1``). This is the continuation
  of ``examples/lidcavity_workflows.py`` (1000, 3000, 5000, 8000) made
  finer: on this mesh the plain damped Newton stalls at a residual of 7e-4
  on the step from Re=1000 to 3000, and with pseudo-transient continuation
  it stalls at 3e-4 on the step from 5000 to 8000; Picard alone stalls
  near the Hopf (Re_c ≈ 7700);
- ``pinball`` (fluidic pinball, Re=100, rotation actuation): Picard
  (``max_iter=15, tol=1e-7``), then Newton (``max_iter=10``) from the
  Picard field (``examples/run_pinball_feedback.py``);
- ``cylinder_big`` (the half-million-dof cylinder, Re=100, the graded mesh
  of ``tools/scale_big.py`` at density 30: 506,553 dofs): Picard
  (``max_iter=4``), then Newton (``max_iter=8``) from the Picard field, the
  JAX package's ``tools/scale_big.py`` recipe.

It prints the seconds of each stage and the final steady residual, and
writes ``<flow>_re<Re>_n<dofs>.npz`` (U0, P0 and the mesh's checksum) into
``models/_baseflows/``; ``models/baseflows.committed_baseflow`` hands the
file out only for a mesh with the same checksum.

``pinball_baseflow`` gives a pinball solver at any Re and mesh its base
flow, as the JAX package's ``tools/pinball_mimo_synth.py`` does: a file
that fits, else Newton continuation in Re (``PINBALL_CONTINUATION``) from
the highest base flow below, else the recipe at min(30, Re) and
continuation from there; the synthesis tool and the example call it.
"""

from __future__ import annotations

import argparse
import logging
import time
from pathlib import Path

import numpy as np

from flowcontrol_tpu_torch.models.baseflows import (
    BASEFLOW_DIR,
    committed_baseflow,
    same_mesh,
    write_baseflow,
)

log = logging.getLogger("make_baseflow")

LID_CONTINUATION = tuple(range(1000, 8001, 1000))
LID_PTC_DT0 = 1.0
#: the pinball's continuation in Re (the JAX synthesis tool's schedule, its
#: ``:99``); the target Re ends it
PINBALL_CONTINUATION = (50.0, 70.0, 85.0, 100.0)
#: a pinball cold start runs the recipe at min(PINBALL_COLD_RE, Re)
PINBALL_COLD_RE = 30.0
PINBALL_U0 = [0.0, 0.0, 0.0]


def steady_residual(fs) -> float:
    """2-norm of the steady residual of ``fs``'s base flow at zero control,
    Dirichlet rows (and a pinned pressure dof) excluded: the norm the
    Newton iteration reports."""
    from flowcontrol_tpu_torch.core.steadystate import SteadyStateSolver
    from flowcontrol_tpu_torch.fem.bc import BCSet, DirichletBC

    bcu = fs._make_BCs().bcu
    if fs._pin_pressure_needed(BCSet(bcu, fs.space.n_dofs)):
        bcu = bcu + [DirichletBC(dofs=np.array([2 * fs.space.n_vnodes]), values=0.0)]
    bcs = BCSet(bcu, fs.space.n_dofs)
    ss = SteadyStateSolver(space=fs.space, geom=fs.geom, bcs=bcs, inv_re=1.0 / fs.params_flow.Re,
                           f_load=np.zeros(fs.space.n_dofs))
    r = ss.residual(fs.fields.UP0)
    r[bcs.dofs] = 0.0
    return float(np.linalg.norm(r))


def _timed(stages: list, name: str, fn) -> None:
    t0 = time.perf_counter()
    fn()
    stages.append((name, time.perf_counter() - t0))


def cavity(path_out) -> tuple:
    from flowcontrol_tpu_torch.models.cavity import CavityFlowSolver

    fs = CavityFlowSolver.make_default(Re=7500, device="cpu", verbose=1, path_out=path_out)
    stages = []
    _timed(stages, "Picard", lambda: fs.compute_steady_state(
        u_ctrl=[0.0], method="picard", max_iter=10, tol=1e-7))
    _timed(stages, "Newton", lambda: fs.compute_steady_state(
        u_ctrl=[0.0], method="newton", initial_guess=fs.fields.UP0, max_iter=10))
    return fs, stages


def lidcavity(path_out) -> tuple:
    from flowcontrol_tpu_torch.models.lidcavity import LidCavityFlowSolver

    stages, guess, fs = [], None, None
    for re_k in LID_CONTINUATION:
        fs = LidCavityFlowSolver.make_default(Re=re_k, device="cpu", verbose=1,
                                              path_out=path_out)
        if guess is None:
            _timed(stages, f"Picard Re={re_k}", lambda: fs.compute_steady_state(
                u_ctrl=[0.0], method="picard", max_iter=5))
            guess = fs.fields.UP0
        _timed(stages, f"Newton Re={re_k}", lambda: fs.compute_steady_state(
            u_ctrl=[0.0], method="newton", initial_guess=guess, max_iter=20,
            ptc_dt0=LID_PTC_DT0))
        guess = fs.fields.UP0
    return fs, stages


def pinball_solver(re: float = 100.0, mesh=None, meshpath=None, path_out=None):
    """The fluidic pinball at ``re`` with rotation actuation, on the host in
    float64."""
    from flowcontrol_tpu_torch.core.actuator import CYLINDER_ACTUATION_MODE
    from flowcontrol_tpu_torch.models.pinball import PinballFlowSolver

    return PinballFlowSolver.make_default(
        Re=re, mesh=mesh, meshpath=meshpath, num_steps=10, save_every=0, verbose=1,
        mode_actuation=CYLINDER_ACTUATION_MODE.ROTATION, path_out=path_out,
        solver_backend="host_lu", precision="f64", device="cpu")


def pinball_steady(fs, stages: list) -> None:
    """The pinball's recipe on ``fs``: Picard (15, tol 1e-7), then Newton
    (10) from the Picard field."""
    _timed(stages, f"Picard Re={fs.params_flow.Re:g}", lambda: fs.compute_steady_state(
        u_ctrl=PINBALL_U0, method="picard", max_iter=15, tol=1e-7))
    _timed(stages, f"Newton Re={fs.params_flow.Re:g}", lambda: fs.compute_steady_state(
        u_ctrl=PINBALL_U0, method="newton", initial_guess=fs.fields.UP0, max_iter=10))


def pinball(path_out) -> tuple:
    fs = pinball_solver(100.0, path_out=path_out)
    stages = []
    pinball_steady(fs, stages)
    return fs, stages


#: the half-million-dof cylinder's mesh density (506,553 dofs)
CYLINDER_BIG_DENSITY = 30.0


def cylinder_big_mesh_kwargs(density: float) -> dict:
    """The graded cylinder mesh of ``tools/scale_big.py`` at ``density``:
    dofs grow ~density^2 (3 -> 8,136, 30 -> 506,553)."""
    return dict(yinf=10.0, n1=density, n2=density / 2.0, n3=density / 5.5,
                segments=int(24 * density))


def cylinder_big_steady(fs, stages: list) -> None:
    """The half-million-dof cylinder's recipe on ``fs``: Picard (4), then
    Newton (8) from the Picard field (the JAX tool's ``:66-71``)."""
    _timed(stages, "Picard", lambda: fs.compute_steady_state(
        u_ctrl=[0.0, 0.0], method="picard", max_iter=4))
    _timed(stages, "Newton", lambda: fs.compute_steady_state(
        u_ctrl=[0.0, 0.0], method="newton", max_iter=8, initial_guess=fs.fields.UP0))


def cylinder_big(path_out, density: float = CYLINDER_BIG_DENSITY) -> tuple:
    from flowcontrol_tpu_torch.models.cylinder import CylinderFlowSolver

    t0 = time.perf_counter()
    fs = CylinderFlowSolver.make_default(
        Re=100, num_steps=1, save_every=0, verbose=1, path_out=path_out,
        solver_backend="host_lu", precision="f64", device="cpu",
        mesh_kwargs=cylinder_big_mesh_kwargs(density))
    stages = [("mesh", time.perf_counter() - t0)]
    cylinder_big_steady(fs, stages)
    return fs, stages


def continuation_schedule(re_lo: float, re: float) -> list:
    """The Reynolds numbers Newton visits from ``re_lo`` up to ``re``."""
    return sorted({r for r in (*PINBALL_CONTINUATION, re) if re_lo < r <= re})


def continuation_stage(fs, guess: np.ndarray) -> np.ndarray:
    """Newton (12) at ``fs``'s Re from ``guess`` (the JAX tool's stage, its
    ``:104-115``); returns its UP0."""
    fs.compute_steady_state(method="newton", max_iter=12, u_ctrl=PINBALL_U0,
                            initial_guess=guess)
    return np.asarray(fs.fields.UP0)


def _highest_below(fs, re: float, directories) -> tuple | None:
    """(Re, path) of the highest base flow below ``re`` in ``directories``
    computed on ``fs``'s mesh, or None."""
    found = [(float(p.stem.split("_re")[1].split("_n")[0]), p)
             for d in directories
             for p in Path(d).glob(f"{fs.BASEFLOW_NAME}_re*_n{fs.space.n_dofs}.npz")]
    found = [(r, p) for r, p in found if r < re and same_mesh(p, fs.mesh)]
    return max(found) if found else None


def pinball_baseflow(fs, out_dir) -> str:
    """Give the pinball solver ``fs`` its base flow at its Re: the committed
    file or one in ``out_dir`` that fits its mesh; else continuation from
    the highest such base flow below its Re; else the recipe at
    min(PINBALL_COLD_RE, Re) and continuation from there. A base flow it
    computes is written into ``out_dir``. Returns how it was found."""
    for directory in (None, out_dir):
        path = committed_baseflow(fs, directory)
        if path is not None:
            fs.load_steady_state(path)
            log.info("loaded base flow %s", path)
            return f"loaded {path.name}"
    re, t0, stages = float(fs.params_flow.Re), time.perf_counter(), []
    below = _highest_below(fs, re, (BASEFLOW_DIR, out_dir))
    if below is not None:
        re_lo, path = below
        fs.load_steady_state(path)
        guess, how = np.asarray(fs.fields.UP0), f"continuation from {path.name}"
    else:
        re_lo = min(PINBALL_COLD_RE, re)
        fs0 = fs if re_lo == re else pinball_solver(re_lo, mesh=fs.mesh, path_out=out_dir)
        pinball_steady(fs0, stages)
        guess, how = np.asarray(fs0.fields.UP0), f"cold start at Re={re_lo:g}"
    for re_i in continuation_schedule(re_lo, re):
        fs_i = fs if re_i == re else pinball_solver(re_i, mesh=fs.mesh, path_out=out_dir)
        _timed(stages, f"Newton Re={re_i:g}", lambda: continuation_stage(fs_i, guess))
        guess = np.asarray(fs_i.fields.UP0)
    path = write_baseflow(fs, out_dir)
    log.info("base flow by %s (%s; %.0f s), written to %s", how,
             ", ".join(f"{name} {s:.0f} s" for name, s in stages), time.perf_counter() - t0, path)
    return how


RECIPES = {"cavity": cavity, "cylinder_big": cylinder_big, "lidcavity": lidcavity,
           "pinball": pinball}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("flow", choices=sorted(RECIPES))
    ap.add_argument("--out", type=Path, default=BASEFLOW_DIR)
    args = ap.parse_args(argv)
    logging.basicConfig(level=logging.INFO, format="%(asctime)s %(message)s")
    t0 = time.perf_counter()
    fs, stages = RECIPES[args.flow](args.out)
    print(f"{args.flow}: mesh {fs.mesh.num_cells} cells, {fs.space.n_dofs} dofs; "
          + ", ".join(f"{name} {s:.1f} s" for name, s in stages)
          + f"; total {time.perf_counter() - t0:.1f} s; final steady residual "
          f"{steady_residual(fs):.3e}, max|U0| {np.abs(fs.fields.U0).max():.6f}", flush=True)
    print(f"wrote {write_baseflow(fs, args.out)}", flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
