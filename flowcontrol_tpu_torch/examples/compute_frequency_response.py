"""Frequency response H(jw) = C (jwE - A)^-1 B of the cylinder with Bode
export, on the card unless asked for the CPU.

    python -m flowcontrol_tpu_torch.examples.compute_frequency_response [--device cpu] [--omegas 50]

The port's copy of ``examples/compute_frequency_response.py`` (ref:
src/examples/operators/compute_frequency_response.py:23-51): the 50-point
log sweep ``logspace(-1, 1, 50)`` for the coarse cylinder, by one dense
complex64 solve per ω on ``--device`` (``get_frequency_response_device``)
beside the host splu sweep, saved to ``data_output_freq/Hw.mat`` with one
Bode PNG per input/output pair (matplotlib). On the CPU each of those dense
LUs (7,889 dofs) takes ~40-55 s, so ask for a few ω there (``--omegas 3``).
"""

import argparse
from pathlib import Path

import numpy as np

from flowcontrol_tpu_torch.examples.compute_operators import solved_cylinder
from flowcontrol_tpu_torch.core.operatorgetter import OperatorGetter
from flowcontrol_tpu_torch.utils.io import plot_Hw, save_Hw
from flowcontrol_tpu_torch.utils.linalg import (
    get_frequency_response,
    get_frequency_response_device,
)


def main(device: str = "cuda", omegas: int = 50):
    out = Path.cwd() / "data_output_freq"
    fs = solved_cylinder(device, out)
    a, e, b, c = OperatorGetter(fs).get_all(autodiff=False)
    ww = np.logspace(-1, 1, omegas)
    hw = get_frequency_response_device(a, b, c, e, ww, device=device)
    hw_host = get_frequency_response(a, b, c, e, ww)
    out.mkdir(parents=True, exist_ok=True)
    save_Hw(out / "Hw.mat", hw, ww)
    plot_Hw(out / "bode", hw, ww)
    print(f"peak |H|: {np.abs(hw).max():.6e} (host {np.abs(hw_host).max():.6e}); "
          f"max|H - H_host| / max|H_host| = "
          f"{np.abs(hw - hw_host).max() / np.abs(hw_host).max():.3e}")
    return hw


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--omegas", type=int, default=50)
    args = ap.parse_args()
    main(device=args.device, omegas=args.omegas)
