"""Compute a flow's base flow at its generated default mesh on the host and
commit it.

    python -m flowcontrol_tpu_torch.models.make_baseflow {cavity,lidcavity,pinball} [--out DIR]

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
  Picard field (``examples/run_pinball_feedback.py``).

It prints the seconds of each stage and the final steady residual, and
writes ``<flow>_re<Re>_n<dofs>.npz`` (U0, P0 and the mesh's checksum) into
``models/_baseflows/``; ``models/baseflows.committed_baseflow`` hands the
file out only for a mesh with the same checksum.
"""

from __future__ import annotations

import argparse
import logging
import time
from pathlib import Path

import numpy as np

from flowcontrol_tpu_torch.models.baseflows import BASEFLOW_DIR, baseflow_name, mesh_checksum

LID_CONTINUATION = tuple(range(1000, 8001, 1000))
LID_PTC_DT0 = 1.0


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


def pinball(path_out) -> tuple:
    from flowcontrol_tpu_torch.core.actuator import CYLINDER_ACTUATION_MODE
    from flowcontrol_tpu_torch.models.pinball import PinballFlowSolver

    fs = PinballFlowSolver.make_default(Re=100, mode_actuation=CYLINDER_ACTUATION_MODE.ROTATION,
                                        device="cpu", verbose=1, path_out=path_out)
    stages = []
    _timed(stages, "Picard", lambda: fs.compute_steady_state(
        u_ctrl=[0.0] * 3, method="picard", max_iter=15, tol=1e-7))
    _timed(stages, "Newton", lambda: fs.compute_steady_state(
        u_ctrl=[0.0] * 3, method="newton", initial_guess=fs.fields.UP0, max_iter=10))
    return fs, stages


RECIPES = {"cavity": cavity, "lidcavity": lidcavity, "pinball": pinball}


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
    args.out.mkdir(parents=True, exist_ok=True)
    path = args.out / baseflow_name(fs)
    np.savez_compressed(path, U0=fs.fields.U0, P0=fs.fields.P0,
                        mesh_sha256=np.asarray(mesh_checksum(fs.mesh)))
    print(f"wrote {path}", flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
