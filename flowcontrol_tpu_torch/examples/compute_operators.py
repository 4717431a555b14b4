"""Export the A, E, B, C operators of the cylinder around its base flow, on
the card unless asked for the CPU.

    python -m flowcontrol_tpu_torch.examples.compute_operators [--device cpu]

The port's copy of ``examples/compute_operators.py`` (ref:
src/examples/operators/compute_operators.py:15-27): the cylinder at Re=100
on a coarse generated mesh, base flow by Picard then Newton on the host, the
operators on the host (A by the hand-linearized element matrices) written
to ``data_output_operators/``; the autodiff A (element Jacobians by
``torch.func.jacfwd`` on ``--device``) is held against it.
"""

import argparse
from pathlib import Path

import numpy as np

from flowcontrol_tpu_torch.core.operatorgetter import OperatorGetter
from flowcontrol_tpu_torch.models.cylinder import CylinderFlowSolver
from flowcontrol_tpu_torch.utils.io import export_square_operators

COARSE = dict(yinf=5.0, xinf=15.0, xinfa=-5.0, n1=4.0, n2=2.0, n3=0.8, segments=80)


def solved_cylinder(device: str, path_out: Path) -> CylinderFlowSolver:
    """The coarse cylinder at Re=100 with its base flow (Picard, then Newton)."""
    fs = CylinderFlowSolver.make_default(Re=100, num_steps=1, verbose=0, device=device,
                                         mesh_kwargs=COARSE, path_out=path_out)
    fs.compute_steady_state(u_ctrl=[0.0, 0.0], method="picard", max_iter=3)
    fs.compute_steady_state(u_ctrl=[0.0, 0.0], method="newton",
                            initial_guess=fs.fields.UP0)
    return fs


def compute_and_export(fs, name: str, out_dir: Path):
    og = OperatorGetter(fs)
    a, e, b, c = og.get_all(autodiff=False)
    out = out_dir / name
    export_square_operators(out, {"A": a, "E": e})
    np.savez_compressed(str(out) + "_BC.npz", B=b, C=c)
    print(f"{name}: A nnz={a.nnz}, B {b.shape}, C {c.shape}")
    a_ad = og.get_A(autodiff=True)
    print(f"{name}: autodiff A on {fs.device}: max|A_ad - A| / max|A| = "
          f"{abs(a_ad - a).max() / abs(a).max():.3e}")
    return a, e, b, c


def main(device: str = "cuda"):
    out_dir = Path.cwd() / "data_output_operators"
    return compute_and_export(solved_cylinder(device, out_dir), "cylinder", out_dir)


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda")
    main(device=ap.parse_args().device)
