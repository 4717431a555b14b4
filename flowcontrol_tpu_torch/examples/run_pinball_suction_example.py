"""Fluidic pinball with suction (slot) actuation, on the card unless asked
for the CPU.

    python -m flowcontrol_tpu_torch.examples.run_pinball_suction_example [--steps 100] [--device cpu]

The port's copy of ``examples/run_pinball_suction_example.py`` (ref:
src/examples/pinball/run_pinball_suction_example.py): the 9-boundary
SUCTION layout with parabolic slots at Re=30 on a coarse generated mesh,
base flow by Picard then Newton on the host, and a symmetric blowing pulse
on all slots.
"""

import argparse
import logging
from pathlib import Path

import numpy as np

from flowcontrol_tpu_torch.core.actuator import CYLINDER_ACTUATION_MODE
from flowcontrol_tpu_torch.models.pinball import PinballFlowSolver

logging.basicConfig(level=logging.INFO)


def main(num_steps: int = 100, device: str = "cuda"):
    fs = PinballFlowSolver.make_default(
        Re=30, num_steps=num_steps, verbose=10, device=device,
        mode_actuation=CYLINDER_ACTUATION_MODE.SUCTION,
        path_out=Path.cwd() / "data_output_pinball_suction",
        mesh_kwargs=dict(n1=4.0, n2=2.0, n3=0.8, segments=60, xinf=14.0),
    )
    fs.compute_steady_state(u_ctrl=[0.0] * 3, method="picard", max_iter=5)
    fs.compute_steady_state(u_ctrl=[0.0] * 3, method="newton",
                            initial_guess=fs.fields.UP0)
    fs.initialize_time_stepping()
    for k in range(num_steps):
        amp = 0.5 if 20 <= k < 60 else 0.0  # blowing pulse on all slots
        fs.step(np.array([amp, amp, amp]))
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
