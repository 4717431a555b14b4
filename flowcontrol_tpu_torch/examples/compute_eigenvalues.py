"""Global stability analysis of the cylinder: shift-invert eigenvalues of
(A, E), on the host and on the card unless asked for the CPU.

    python -m flowcontrol_tpu_torch.examples.compute_eigenvalues [--device cpu] [--full-mesh]

The port's copy of ``examples/compute_eigenvalues.py`` (ref:
src/examples/operators/compute_eigenvalues.py). Expected (reference
domain/mesh): the cylinder's Re=100 unstable eigenvalue 0.132643 +
0.770015j (ref :50-51); the JAX package gives 0.13292 + 0.77003j on its
default generated mesh (``--full-mesh``, 56,383 dofs). The host ARPACK
shift-invert is printed beside ``eig_arnoldi_dense_device`` on
``--device`` (a dense complex64 LU of A - σE). The two leading host modes
are written by ``export_complex_field`` to
``data_output_eig/modes.ckpt`` (re/im/abs/arg of u and p, their
frequencies as the snapshot times).
"""

import argparse
from pathlib import Path

from flowcontrol_tpu_torch.core.operatorgetter import OperatorGetter
from flowcontrol_tpu_torch.examples.compute_operators import COARSE
from flowcontrol_tpu_torch.models.cylinder import CylinderFlowSolver
from flowcontrol_tpu_torch.utils.io import export_complex_field
from flowcontrol_tpu_torch.utils.linalg import eig_arnoldi_dense_device, get_mat_vp_shift_invert

SIGMA = 0.1 + 0.8j


def main(device: str = "cuda", full_mesh: bool = False):
    fs = CylinderFlowSolver.make_default(
        Re=100, num_steps=1, verbose=0, device=device,
        mesh_kwargs={} if full_mesh else COARSE,
        path_out=Path.cwd() / "data_output_eig",
    )
    fs.compute_steady_state(u_ctrl=[0.0, 0.0], method="picard", max_iter=3)
    fs.compute_steady_state(u_ctrl=[0.0, 0.0], method="newton",
                            initial_guess=fs.fields.UP0)
    og = OperatorGetter(fs)
    a = og.get_A(autodiff=False)
    e = og.get_mass_matrix()
    vals, vecs = get_mat_vp_shift_invert(a, e, n=8, sigma=SIGMA)
    vals_dev, _ = eig_arnoldi_dense_device(a, e, n=8, sigma=SIGMA, device=device)
    print(f"leading eigenvalues (host ARPACK | eig_arnoldi_dense_device on {fs.device}):")
    for v, w in zip(vals, vals_dev):
        print(f"  {v.real:+.6f} {v.imag:+.6f}j | {w.real:+.6f} {w.imag:+.6f}j")
    export_complex_field(fs.params_save.path_out / "modes.ckpt", fs.space, vecs.T[:2],
                         name="mode", frequencies=vals.imag[:2])
    return vals, vals_dev


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--full-mesh", action="store_true")
    args = ap.parse_args()
    main(device=args.device, full_mesh=args.full_mesh)
