"""Single-stream steps/s of the cavity or the lid-driven cavity on the card,
to compare two checkouts of the port on one machine.

    python flowcontrol_tpu_torch/examples/single_stream_rate.py --flow cavity [--root DIR]

Builds the flow's default solver (the cavity at Re=7500, the lid-driven
cavity at Re=8000) on the card with its committed base flow (else the
recipe of ``models/make_baseflow.py`` on the host), then takes ``--steps``
steps with u = 0.5 (cavity) or 0.05 (lid) for the first 10 and 0 after, as
``chip_smoke.py`` phases 17 and 23 do. Prints the steps/s over the steps
after the first 10 (the kernels are built and the factorization made
before them) and y of the last step. ``--root`` imports
``flowcontrol_tpu_torch`` from another checkout, e.g. a parent commit
unpacked by ``git archive``: run parent, change, change, parent in one
call on one card, since a card's rate moves with its machine.
"""

import argparse
import sys
import time
from pathlib import Path

import numpy as np

FLOWS = {"cavity": ("cavity", "CavityFlowSolver", 7500, 0.5),
         "lidcavity": ("lidcavity", "LidCavityFlowSolver", 8000, 0.05)}
CTRL_STEPS = 10


def main(flow: str, steps: int = 200, tag: str = "") -> float:
    import importlib

    import torch

    from flowcontrol_tpu_torch.models import make_baseflow
    from flowcontrol_tpu_torch.models.baseflows import committed_baseflow

    module, cls, re, u_on = FLOWS[flow]
    solver = getattr(importlib.import_module(f"flowcontrol_tpu_torch.models.{module}"), cls)
    fs = solver.make_default(Re=re, num_steps=steps, device="cuda",
                             path_out=Path.cwd() / f"data_output_{flow}")
    path = committed_baseflow(fs)
    if path is not None:
        fs.load_steady_state(path)
    else:
        done, _ = make_baseflow.RECIPES[flow](fs.params_save.path_out)
        fs._assign_steady_state(done.fields.U0, done.fields.P0)
    fs.initialize_time_stepping()
    for i in range(steps):
        if i == CTRL_STEPS:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
        y = fs.step(np.array([u_on if i < CTRL_STEPS else 0.0]))
    torch.cuda.synchronize()
    sps = (steps - CTRL_STEPS) / (time.perf_counter() - t0)
    if not np.isfinite(y).all():
        raise AssertionError(f"non-finite y on the last step: {y}")
    print(f"{tag} {flow}: {sps:.2f} steps/s over the last {steps - CTRL_STEPS}, y[-1] "
          f"{np.asarray(y).tolist()} ({torch.cuda.get_device_name(0)}, "
          f"flowcontrol_tpu_torch from {Path(sys.modules['flowcontrol_tpu_torch'].__file__).parent})")
    return sps


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--flow", choices=sorted(FLOWS), required=True)
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--root", default=str(Path(__file__).resolve().parents[2]),
                    help="the checkout to import flowcontrol_tpu_torch from")
    ap.add_argument("--tag", default="", help="a label printed at the head of the result")
    args = ap.parse_args()
    sys.path.insert(0, str(Path(args.root).resolve()))
    main(args.flow, args.steps, args.tag)
