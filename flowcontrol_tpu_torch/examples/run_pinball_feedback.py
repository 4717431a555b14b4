"""Fluidic pinball with MIMO closed-loop rotation feedback, on the card
unless asked for the CPU.

    python -m flowcontrol_tpu_torch.examples.run_pinball_feedback [--steps 400] [--open-loop] [--device cpu]

The port's copy of ``examples/run_pinball_feedback.py``: three
independently rotating cylinders driven by the committed LQG compensator
(``models/_controllers/pinball_lqg_re100.mat``: 22 states, fed by the three
downstream V-sensors) at Re=100 on the generated default mesh (67,920
dofs), from the committed base flow where its mesh checksum matches (else
Picard then Newton on the host). The compensator was synthesized on the
reference's stock mesh, which this repository does not hold, so the initial
condition is the example's fallback (a small div-free bump downstream) and
the run reports the perturbation energy without expecting it to decay. On
this mesh the loop diverges: the compensator's own spectral radius is 4.50
a step and the plant does not hold it, so u grows ~4.5x a step and the
solve overflows within about 20 steps; the run then stops and says so.
"""

import argparse
import logging
from pathlib import Path

import numpy as np

from flowcontrol_tpu_torch.core.actuator import CYLINDER_ACTUATION_MODE
from flowcontrol_tpu_torch.core.controller import Controller
from flowcontrol_tpu_torch.models import make_baseflow
from flowcontrol_tpu_torch.models.baseflows import committed_baseflow
from flowcontrol_tpu_torch.models.pinball import PINBALL_LQG_RE100, PinballFlowSolver

logging.basicConfig(level=logging.INFO)
log = logging.getLogger("pinball_feedback")


def main(num_steps: int = 400, closed_loop: bool = True, device: str = "cuda"):
    fs = PinballFlowSolver.make_default(
        Re=100, num_steps=num_steps, verbose=10, device=device,
        mode_actuation=CYLINDER_ACTUATION_MODE.ROTATION,
        path_out=Path.cwd() / "data_output_pinball_feedback", throw_error=False,
    )
    path = committed_baseflow(fs)
    if path is not None:
        fs.load_steady_state(path)
        log.info("loaded committed base flow %s", path.name)
    else:
        done, _ = make_baseflow.pinball(fs.params_save.path_out)
        fs._assign_steady_state(done.fields.U0, done.fields.P0)
    fs.params_ic.xloc, fs.params_ic.yloc = 1.0, 0.0
    fs.params_ic.radius, fs.params_ic.amplitude = 0.6, 0.01
    fs.initialize_time_stepping()

    k = Controller.from_file(PINBALL_LQG_RE100) if closed_loop else None
    dt = fs.params_time.dt
    for i in range(num_steps):
        # u = +K(y): the compensator consumes the raw measurement (see
        # examples/run_pinball_feedback.py)
        u_ctrl = k.step(y=np.asarray(fs.y_meas), dt=dt) if k is not None else np.zeros(3)
        if fs.step(u_ctrl=np.asarray(u_ctrl).reshape(-1)) is None:
            print(f"diverged at step {i + 1} (|u| = {np.abs(u_ctrl).max():.3e})")
            break
    fs.write_timeseries()

    de = fs.timeseries["dE"]
    log.info("mode=%s  dE: start %.3e  peak %.3e  end %.3e",
             "closed" if closed_loop else "open", de[0], np.nanmax(de), de[-1])
    print(f"{'closed' if closed_loop else 'open'}-loop: dE_end={de[-1]:.4e} "
          f"dE_peak={np.nanmax(de):.4e} y_last={np.round(fs.y_meas, 6)}")
    return fs.timeseries


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--steps", type=int, default=400)
    ap.add_argument("--open-loop", action="store_true")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args()
    main(num_steps=args.steps, closed_loop=not args.open_loop, device=args.device)
