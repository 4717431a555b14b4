"""Leading eigenvalue of the cylinder's wake against Re: bracket the Hopf
point (ref: run_cylinder_example.py:4 — Re_c ~ 46).

    python -m flowcontrol_tpu_torch.tools.bifurcation_sweep

The port's copy of ``tools/bifurcation_sweep.py``, the same command line
and output: at each Re of RES the cylinder at MESH_KWARGS on the host in
float64 (``device="cpu"``, ``solver_backend="host_lu"``), a cold base flow
by Picard (3, tol 1e-7) then Newton (25), the manual A and the mass matrix
E, and the 4 eigenvalues of A x = λ E x nearest σ = 0.75j (host ARPACK and
splu). Imports torch, numpy and scipy, never JAX.
"""

from __future__ import annotations

import time

import numpy as np

from flowcontrol_tpu_torch.core.operatorgetter import OperatorGetter
from flowcontrol_tpu_torch.models.cylinder import CylinderFlowSolver
from flowcontrol_tpu_torch.utils.linalg import get_mat_vp_shift_invert

MESH_KWARGS = dict(yinf=10.0, n1=4.5, n2=2.2, n3=0.8, segments=100)
RES = (40, 43, 46, 47, 49, 52)
SIGMA = 0.0 + 0.75j


def leading_eig(fs, sigmas=(SIGMA,), n: int = 4) -> complex:
    """The eigenvalue of largest real part among the ``n`` nearest each of
    ``sigmas``, around ``fs``'s base flow (manual A, host ARPACK)."""
    og = OperatorGetter(fs)
    a, e = og.get_A(autodiff=False), og.get_mass_matrix()
    best = None
    for sigma in sigmas:
        vals = get_mat_vp_shift_invert(a, e, n=n, sigma=sigma, return_vectors=False)
        lead = vals[np.argmax(vals.real)]
        if best is None or lead.real > best.real:
            best = lead
    return complex(best)


def sweep(res=RES, mesh_kwargs=None, mesh=None, sigma: complex = SIGMA, n: int = 4) -> dict:
    """{Re: leading λ} over ``res``, each Re from a cold base flow on the
    cylinder mesh of ``mesh_kwargs`` (default MESH_KWARGS; or ``mesh``)."""
    out = {}
    for re in res:
        t0 = time.time()
        fs = CylinderFlowSolver.make_default(
            Re=re, num_steps=1, verbose=0, mesh=mesh,
            mesh_kwargs=None if mesh is not None else (mesh_kwargs or MESH_KWARGS),
            solver_backend="host_lu", precision="f64", device="cpu",
        )
        fs.compute_steady_state(method="picard", max_iter=3, tol=1e-7, u_ctrl=[0.0, 0.0])
        fs.compute_steady_state(method="newton", max_iter=25, u_ctrl=[0.0, 0.0],
                                initial_guess=fs.fields.UP0)
        out[re] = leading_eig(fs, (sigma,), n)
        print(f"Re={re}: leading eig {out[re]:.6f}  ({time.time() - t0:.0f}s)", flush=True)
    return out


if __name__ == "__main__":
    sweep()
