"""Lid-driven cavity Re=8000 (supercritical Hopf near Re_c≈7700): base flow
+ unactuated time simulation, on the card unless asked for the CPU.

    python -m flowcontrol_tpu_torch.examples.run_lidcavity_example [--steps 100] [--device cpu]

The port's copy of ``examples/run_lidcavity_example.py`` (ref:
src/examples/lidcavity/run_lidcavity_example.py): the default mesh
(``lidcavity_mesh(64)``, 74,371 dofs), the committed Re=8000 base flow
where its mesh checksum matches (else the Newton continuation of
``models/make_baseflow.py`` on the host: the reference's Picard-only recipe
stalls this close to the Hopf), then unactuated steps with the point
sensors logging and a checkpoint every 20 steps (snapshots, the JSON
sidecar, the timeseries CSV and the Paraview indexes).
"""

import argparse
import logging
from pathlib import Path

import numpy as np

from flowcontrol_tpu_torch.models import make_baseflow
from flowcontrol_tpu_torch.models.baseflows import committed_baseflow
from flowcontrol_tpu_torch.models.lidcavity import LidCavityFlowSolver

logging.basicConfig(level=logging.INFO)
log = logging.getLogger("lidcavity")


def main(num_steps: int = 100, device: str = "cuda"):
    fs = LidCavityFlowSolver.make_default(
        Re=8000, num_steps=num_steps, save_every=20, verbose=10, device=device,
        path_out=Path.cwd() / "data_output_lidcavity",
    )
    path = committed_baseflow(fs)
    if path is not None:
        fs.load_steady_state(path)
        log.info("loaded committed base flow %s", path.name)
    else:
        done, _ = make_baseflow.lidcavity(fs.params_save.path_out)
        fs._assign_steady_state(done.fields.U0, done.fields.P0)
    fs.initialize_time_stepping(ic=None)
    for _ in range(num_steps):
        fs.step(u_ctrl=[0.0])
    fs.write_timeseries()
    ts = fs.timeseries
    print(f"t={ts['time'][-1]:.3f} y_last={np.round(fs.y_meas, 6)} dE_last={ts['dE'][-1]:.4e}")
    return ts


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args()
    main(num_steps=args.steps, device=args.device)
