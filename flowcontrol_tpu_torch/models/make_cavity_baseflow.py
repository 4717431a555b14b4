"""Compute the open cavity's Re=7500 base flow on the host and commit it.

    python -m flowcontrol_tpu_torch.models.make_cavity_baseflow [--out DIR]

Generates the default cavity mesh, runs the recipe of the JAX package's
cavity tests and bench (Picard, ``max_iter=10, tol=1e-7``, then Newton,
``max_iter=10``, from the Picard field) in float64 on the CPU, prints the
seconds of each and the final steady residual, and writes
``cavity_re7500_n<dofs>.npz`` (U0, P0 and the mesh's checksum) into
``models/_baseflows/``. ``models/cavity.committed_baseflow`` hands the file
out only for a mesh with the same checksum.
"""

from __future__ import annotations

import argparse
import logging
import time
from pathlib import Path

import numpy as np

from flowcontrol_tpu_torch.models.cavity import BASEFLOW_DIR, CavityFlowSolver, mesh_checksum

RE = 7500


def steady_residual(fs) -> float:
    """2-norm of the steady residual of ``fs``'s base flow at zero control,
    Dirichlet rows excluded (the norm the Newton iteration reports)."""
    from flowcontrol_tpu_torch.core.steadystate import SteadyStateSolver
    from flowcontrol_tpu_torch.fem.bc import BCSet

    bcs = BCSet(fs._make_BCs().bcu, fs.space.n_dofs)
    ss = SteadyStateSolver(space=fs.space, geom=fs.geom, bcs=bcs, inv_re=1.0 / fs.params_flow.Re,
                           f_load=np.zeros(fs.space.n_dofs))
    r = ss.residual(fs.fields.UP0)
    r[bcs.dofs] = 0.0
    return float(np.linalg.norm(r))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", type=Path, default=BASEFLOW_DIR)
    args = ap.parse_args(argv)
    logging.basicConfig(level=logging.INFO, format="%(asctime)s %(message)s")
    t0 = time.perf_counter()
    fs = CavityFlowSolver.make_default(Re=RE, device="cpu", verbose=1, path_out=args.out)
    print(f"mesh {fs.mesh.num_cells} cells, {fs.space.n_dofs} dofs, "
          f"set-up {time.perf_counter() - t0:.1f} s", flush=True)
    t0 = time.perf_counter()
    fs.compute_steady_state(u_ctrl=[0.0], method="picard", max_iter=10, tol=1e-7)
    t_picard = time.perf_counter() - t0
    t0 = time.perf_counter()
    fs.compute_steady_state(u_ctrl=[0.0], method="newton", initial_guess=fs.fields.UP0,
                            max_iter=10)
    t_newton = time.perf_counter() - t0
    res = steady_residual(fs)
    print(f"Picard {t_picard:.1f} s, Newton {t_newton:.1f} s, final steady residual {res:.3e}, "
          f"max|U0| {np.abs(fs.fields.U0).max():.6f}", flush=True)
    args.out.mkdir(parents=True, exist_ok=True)
    path = args.out / f"cavity_re{RE}_n{fs.space.n_dofs}.npz"
    np.savez_compressed(path, U0=fs.fields.U0, P0=fs.fields.P0,
                        mesh_sha256=np.asarray(mesh_checksum(fs.mesh)))
    print(f"wrote {path}", flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
