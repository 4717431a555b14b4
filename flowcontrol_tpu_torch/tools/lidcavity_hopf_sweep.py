"""Leading eigenvalue of the lid-driven cavity against Re: bracket the Hopf
point (ref: lidcavityflowsolver.py:3 — Re_c ~ 7700).

    python -m flowcontrol_tpu_torch.tools.lidcavity_hopf_sweep [N_MESH [STRETCH [Re ...]]]

The port's copy of ``tools/lidcavity_hopf_sweep.py``, the same command line
and output. It uses the wall-stretched structured mesh
(``lidcavity_mesh(N_MESH, stretch=STRETCH)``, default 48 and 2.0): uniform
grids cannot resolve the Re^-1/2 wall layers past Re~5000 and Newton stalls
on them. The base flow is continued in Re over RES on the host in float64
(``device="cpu"``, ``solver_backend="host_lu"``): Picard (6) then Newton
(30) at the first Re, Newton (30) from the last field after it. From
Re = EIG_FROM on, the leading eigenvalue among the 4 nearest each of
SIGMAS (manual A, host ARPACK and splu). Imports torch, numpy and scipy,
never JAX.
"""

from __future__ import annotations

import sys
import time
from pathlib import Path

from flowcontrol_tpu_torch.mesh.generation import lidcavity_mesh
from flowcontrol_tpu_torch.models.lidcavity import LidCavityFlowSolver
from flowcontrol_tpu_torch.tools.bifurcation_sweep import leading_eig

N_MESH, STRETCH = 48, 2.0
RES = (1000, 2000, 3000, 4000, 5000, 6000, 6500, 7000, 7400, 7700, 8000)
EIG_FROM = 6000
SIGMAS = (0.0 + 0.5j, 0.0 + 1.0j, 0.0 + 2.0j, 0.0 + 3.0j)


def sweep(res=RES, n_mesh: int = N_MESH, stretch: float = STRETCH, mesh=None,
          eig_from: float = EIG_FROM, sigmas=SIGMAS) -> dict:
    """{Re: leading λ} for each Re of ``res`` from ``eig_from`` on, along
    the continuation over ``res`` on ``mesh`` (default
    ``lidcavity_mesh(n_mesh, stretch=stretch)``)."""
    mesh = lidcavity_mesh(n_mesh, stretch=stretch) if mesh is None else mesh
    up0, out = None, {}
    for re in res:
        t0 = time.time()
        fs = LidCavityFlowSolver.make_default(
            Re=re, num_steps=1, verbose=0, mesh=mesh, path_out=Path.cwd() / "data_output_lidhopf",
            solver_backend="host_lu", precision="f64", device="cpu",
        )
        if up0 is None:
            fs.compute_steady_state(method="picard", max_iter=6, u_ctrl=[0.0])
            fs.compute_steady_state(method="newton", max_iter=30, u_ctrl=[0.0],
                                    initial_guess=fs.fields.UP0)
        else:
            fs.compute_steady_state(method="newton", max_iter=30, u_ctrl=[0.0], initial_guess=up0)
        up0 = fs.fields.UP0.copy()
        if re < eig_from:
            print(f"Re={re}: continuation ({time.time() - t0:.0f}s)", flush=True)
            continue
        out[re] = leading_eig(fs, sigmas)
        print(f"Re={re}: leading {out[re]:.6f}  ({time.time() - t0:.0f}s)", flush=True)
    return out


if __name__ == "__main__":
    args = sys.argv[1:]
    sweep(res=[int(r) for r in args[2:]] or RES,
          n_mesh=int(args[0]) if args else N_MESH,
          stretch=float(args[1]) if len(args) > 1 else STRETCH)
