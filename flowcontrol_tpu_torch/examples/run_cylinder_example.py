"""Cylinder Re=100: base flow, closed-loop control, restart, on the card
unless asked for the CPU.

    python -m flowcontrol_tpu_torch.examples.run_cylinder_example [--steps 100] [--full-mesh] [--device cpu]

The port's copy of ``examples/run_cylinder_example.py`` (ref:
src/examples/cylinder/run_cylinder_example.py): Picard warm start, Newton
base flow, a closed loop with a small stable LTI controller stepped in
lockstep with the flow, checkpoints every ``steps // 2`` steps (snapshots
in ``.ckpt`` directories, the JSON sidecar, the timeseries CSV and the
Paraview indexes, under ``data_output_cylinder/``), then a second solver
that restarts at mid-run from the sidecar and steps at BDF2 from its first
step. The coarse test mesh unless ``--full-mesh`` (56,383 dofs).
"""

import argparse
import logging
from pathlib import Path

import numpy as np

from flowcontrol_tpu_torch.core.controller import Controller
from flowcontrol_tpu_torch.examples.compute_operators import COARSE
from flowcontrol_tpu_torch.models.cylinder import CylinderFlowSolver

logging.basicConfig(level=logging.INFO)


def main(num_steps: int = 100, full_mesh: bool = False, device: str = "cuda",
         path_out=None):
    path_out = Path.cwd() / "data_output_cylinder" if path_out is None else Path(path_out)
    mesh_kwargs = {} if full_mesh else COARSE
    fs = CylinderFlowSolver.make_default(
        Re=100, num_steps=num_steps, save_every=num_steps // 2, verbose=10,
        path_out=path_out, mesh_kwargs=mesh_kwargs, device=device,
    )
    fs.compute_steady_state(u_ctrl=[0.0, 0.0], method="picard", max_iter=3)
    fs.compute_steady_state(
        u_ctrl=[0.0, 0.0], method="newton", initial_guess=fs.fields.UP0
    )
    print(f"base flow: cl0={fs.cl0:.5f} cd0={fs.cd0:.5f}")

    # simple stable output-feedback controller (see
    # examples/synthesize_controller.py for a model-based design)
    k = Controller.from_matrices(
        A=np.array([[-5.0, 2.0], [0.0, -8.0]]),
        B=np.array([[1.0], [0.5]]),
        C=np.array([[2.0, 0.5]]),
        D=np.zeros((1, 1)),
    )

    fs.initialize_time_stepping()
    y = fs.y_meas
    for _ in range(num_steps):
        u = k.step(-y[0], fs.params_time.dt)
        y = fs.step(np.array([u[0], u[0]]))
    fs.write_timeseries()
    ts = fs.timeseries
    print(f"t={ts['time'][-1]:.3f} y_last={np.round(y, 6)} dE_last={ts['dE'][-1]:.4e}")

    # restart from the JSON sidecar at mid-run (ref: flowsolver.py:551-663);
    # it reads the base flow compute_steady_state wrote under steady/
    t_mid = (num_steps // 2) * fs.params_time.dt
    fs2 = CylinderFlowSolver.make_default(
        Re=100, num_steps=num_steps // 2, save_every=0, verbose=10,
        Tstart=t_mid, path_out=path_out, mesh_kwargs=mesh_kwargs, device=device,
    )
    fs2.load_steady_state()
    fs2.initialize_time_stepping(Tstart=t_mid)
    for _ in range(num_steps // 2):
        fs2.step(np.zeros(2))
    print("restarted run final dE:", fs2.compute_perturbation_energy())
    return fs, fs2


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--full-mesh", action="store_true")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args()
    main(num_steps=args.steps, full_mesh=args.full_mesh, device=args.device)
