"""Fluidic pinball with rotation actuation and an open-loop schedule, on the
card unless asked for the CPU.

    python -m flowcontrol_tpu_torch.examples.run_pinball_rotation_example [--steps 100] [--device cpu]

The port's copy of ``examples/run_pinball_rotation_example.py`` (ref:
src/examples/pinball/run_pinball_rotation_example.py): a Gaussian-bump
rotation schedule applied to the three cylinders (ref :100-112) at Re=30 on
a coarse generated mesh, base flow by Picard then Newton on the host, with
per-surface force coefficients printed.
"""

import argparse
import logging
from pathlib import Path

import numpy as np

from flowcontrol_tpu_torch.core.actuator import CYLINDER_ACTUATION_MODE
from flowcontrol_tpu_torch.models.pinball import PinballFlowSolver

logging.basicConfig(level=logging.INFO)


def rotation_schedule(t, t0=0.25, sigma=0.1, amp=(1.0, -0.5, 0.5)):
    """Gaussian bump rotation rates for (mid, top, bot)."""
    g = np.exp(-0.5 * ((t - t0) / sigma) ** 2)
    return np.asarray(amp) * g


def main(num_steps: int = 100, device: str = "cuda"):
    fs = PinballFlowSolver.make_default(
        Re=30, num_steps=num_steps, verbose=10, device=device,
        mode_actuation=CYLINDER_ACTUATION_MODE.ROTATION,
        path_out=Path.cwd() / "data_output_pinball",
        mesh_kwargs=dict(n1=4.0, n2=2.0, n3=0.8, segments=60, xinf=14.0),
    )
    fs.compute_steady_state(u_ctrl=[0.0] * 3, method="picard", max_iter=5)
    fs.compute_steady_state(u_ctrl=[0.0] * 3, method="newton",
                            initial_guess=fs.fields.UP0)
    fs.initialize_time_stepping()
    for _ in range(num_steps):
        fs.step(rotation_schedule(fs.t))
    coeffs = fs.compute_force_coefficients(
        fs.fields.u_n + fs.fields.U0, fs.fields.p_n + fs.fields.P0
    )
    for name, (cl, cd) in coeffs.items():
        print(f"{name}: Cl={cl:.4f} Cd={cd:.4f}")
    fs.write_timeseries()
    return coeffs


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args()
    main(num_steps=args.steps, device=args.device)
