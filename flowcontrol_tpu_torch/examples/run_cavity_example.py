"""Open cavity Re=7500: base flow (Picard then Newton) and an unactuated
run with checkpoints, on the card unless asked for the CPU.

    python -m flowcontrol_tpu_torch.examples.run_cavity_example [--steps 200] [--full-mesh] [--device cpu]

The port's copy of ``examples/run_cavity_example.py`` (ref:
src/examples/cavity/run_cavity_example.py): the reference's recipe for the
base flow on the host (Picard 10 to 1e-7, then Newton 10), then unactuated
steps with a checkpoint every 50 (snapshots, the JSON sidecar, the
timeseries CSV and the Paraview indexes, under ``data_output_cavity/``).
The coarse test mesh unless ``--full-mesh`` (120,068 dofs: there the
committed base flow is loaded where its mesh checksum matches).
"""

import argparse
import logging
from pathlib import Path

import numpy as np

from flowcontrol_tpu_torch.models.baseflows import committed_baseflow
from flowcontrol_tpu_torch.models.cavity import CavityFlowSolver

logging.basicConfig(level=logging.INFO)

COARSE = dict(n_coarse=12, n_mid=25, n_fine=50)


def main(num_steps: int = 200, full_mesh: bool = False, device: str = "cuda",
         path_out=None):
    fs = CavityFlowSolver.make_default(
        Re=7500, num_steps=num_steps, save_every=50, verbose=10, device=device,
        path_out=Path.cwd() / "data_output_cavity" if path_out is None else Path(path_out),
        mesh_kwargs={} if full_mesh else COARSE,
    )
    path = committed_baseflow(fs)
    if path is not None:
        fs.load_steady_state(path)
    else:
        # ref recipe (run_cavity_example.py:70-71)
        fs.compute_steady_state(method="picard", max_iter=10, tol=1e-7, u_ctrl=[0.0])
        fs.compute_steady_state(method="newton", max_iter=10, u_ctrl=[0.0],
                                initial_guess=fs.fields.UP0)
    fs.initialize_time_stepping(ic=None)
    for _ in range(num_steps):
        fs.step(u_ctrl=np.zeros(1))
    fs.write_timeseries()
    ts = fs.timeseries
    print(f"t={ts['time'][-1]:.4f} y_last={np.round(fs.y_meas, 6)} dE_last={ts['dE'][-1]:.4e}")
    return ts


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--full-mesh", action="store_true")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args()
    main(num_steps=args.steps, full_mesh=args.full_mesh, device=args.device)
