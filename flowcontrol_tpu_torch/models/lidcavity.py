"""Lid-driven cavity flow (supercritical Hopf near Re_c≈7700; proposed Re=8000).

Behavioral port of the reference LidCavityFlowSolver
(ref: src/examples/lidcavity/lidcavityflowsolver.py): unit square, actuated
lid (uniform u), no-slip walls, zero steady-state initial guess, full-field
BC override putting the lid at uinf. Transcribed from
``flowcontrol_tpu/models/lidcavity.py``; ``make_default`` takes ``device=``
(e.g. ``'cuda'``) and the other ParamSolver fields as keywords, and a mesh
file as ``meshpath=`` (an ``.xdmf``, ``mesh/io.py``).

The flow is enclosed: every boundary velocity dof is constrained, so the
pressure is defined up to a constant and ``FlowSolver`` pins its first dof.
At the default mesh (``lidcavity_mesh(64)``, 16,384 cells, 74,371 mixed
dofs) the dense LU's f64 factorization does not fit an 80 GB card, so on
CUDA the Stepper takes the multifrontal solve.
"""

from __future__ import annotations

import logging
from pathlib import Path

import numpy as np

from flowcontrol_tpu_torch.core import flowsolverparameters as fsp
from flowcontrol_tpu_torch.core.actuator import ActuatorBCUniformU
from flowcontrol_tpu_torch.core.flowfield import BoundaryConditions
from flowcontrol_tpu_torch.core.flowsolver import FlowSolver
from flowcontrol_tpu_torch.core.sensor import SENSOR_TYPE, SensorPoint

logger = logging.getLogger(__name__)


class LidCavityFlowSolver(FlowSolver):
    """Lid-driven cavity flow. Proposed Re=8000."""

    BASEFLOW_NAME = "lidcavity"

    def _make_boundaries(self) -> dict:
        ud = self.params_mesh.user_data
        yup, ylo, xri, xle = ud["yup"], ud["ylo"], ud["xri"], ud["xle"]
        tol = 1e-9
        return {
            "lid": lambda x: np.abs(x[:, 1] - yup) < tol,
            "leftwall": lambda x: np.abs(x[:, 0] - xle) < tol,
            "rightwall": lambda x: np.abs(x[:, 0] - xri) < tol,
            "bottomwall": lambda x: np.abs(x[:, 1] - ylo) < tol,
        }

    def _make_bcs(self) -> BoundaryConditions:
        """(ref: lidcavityflowsolver.py:60-72)"""
        return BoundaryConditions(
            bcu=[
                self.dirichlet_bc("lid", actuator=0),
                self.dirichlet_bc("leftwall", value=(0.0, 0.0)),
                self.dirichlet_bc("rightwall", value=(0.0, 0.0)),
                self.dirichlet_bc("bottomwall", value=(0.0, 0.0)),
            ],
            bcp=[],
        )

    def _make_BCs(self) -> BoundaryConditions:
        """Steady-state BCs: lid moves at uinf; walls no-slip
        (ref: lidcavityflowsolver.py:74-82)."""
        bcu_lid_ss = self.dirichlet_bc("lid", value=(self.params_flow.uinf, 0.0))
        bcs = self._make_bcs()
        return BoundaryConditions(bcu=[bcu_lid_ss] + bcs.bcu[1:], bcp=[])

    def _default_steady_state_initial_guess(self) -> np.ndarray:
        """Zero — cavity starts from rest (ref: lidcavityflowsolver.py:83-95)."""
        return np.zeros((self.space.n_vnodes, 2))

    @classmethod
    def make_default(
        cls,
        Re: float = 8000,
        path_out=None,
        num_steps: int = 10,
        save_every: int = 0,
        Tstart: float = 0.0,
        verbose: int = 0,
        meshpath=None,
        mesh=None,
        n_mesh: int = 64,
        **solver_kwargs,
    ) -> "LidCavityFlowSolver":
        """(ref: lidcavityflowsolver.py:98-148)"""
        if path_out is None:
            path_out = Path.cwd() / "data_output_lidcavity"
        params_flow = fsp.ParamFlow(Re=Re, uinf=1.0)
        params_flow.user_data["D"] = 1.0
        params_time = fsp.ParamTime(num_steps=num_steps, dt=0.005, Tstart=Tstart)
        params_save = fsp.ParamSave(save_every=save_every, path_out=Path(path_out))
        params_solver = fsp.ParamSolver(
            **{**dict(throw_error=True, is_eq_nonlinear=True, shift=0.0),
               **solver_kwargs}
        )
        if mesh is None and meshpath is None:
            from flowcontrol_tpu_torch.mesh.generation import lidcavity_mesh

            mesh = lidcavity_mesh(n_mesh)
        params_mesh = fsp.ParamMesh(meshpath=meshpath, mesh=mesh)
        params_mesh.user_data.update({"yup": 1, "ylo": 0, "xri": 1, "xle": 0})
        params_control = fsp.ParamControl(
            sensor_list=[
                SensorPoint(sensor_type=SENSOR_TYPE.V, position=np.array([0.05, 0.5])),
                SensorPoint(sensor_type=SENSOR_TYPE.U, position=np.array([0.5, 0.95])),
            ],
            actuator_list=[ActuatorBCUniformU(boundary_name="lid")],
        )
        params_ic = fsp.ParamIC()
        return cls(
            params_flow=params_flow,
            params_time=params_time,
            params_save=params_save,
            params_solver=params_solver,
            params_mesh=params_mesh,
            params_control=params_control,
            params_ic=params_ic,
            verbose=verbose,
        )
