"""Flow past a cylinder at Re=100 (vortex shedding / stabilization benchmark).

Behavioral port of the reference CylinderFlowSolver
(ref: src/examples/cylinder/cylinderflowsolver.py): 6 boundaries (inlet,
outlet, lateral walls, cylinder body, two actuator slots at the poles),
perturbation-field BCs, lift/drag via boundary stress integrals, and the
same make_default configuration (Re=100, dt=0.005, 2 parabolic BC
actuators of 10° angular size, 3 V-velocity point sensors in the wake).
Transcribed from ``flowcontrol_tpu/models/cylinder.py``; ``make_default``
takes ``device=`` (e.g. ``'cuda'``) and the other ParamSolver fields as
keywords, and a mesh file as ``meshpath=`` (an ``.xdmf``, ``mesh/io.py``).
"""

from __future__ import annotations

import logging
from pathlib import Path

import numpy as np

from flowcontrol_tpu_torch.core import flowsolverparameters as fsp
from flowcontrol_tpu_torch.core.actuator import ActuatorBCParabolicV
from flowcontrol_tpu_torch.core.flowfield import BoundaryConditions
from flowcontrol_tpu_torch.core.flowsolver import FlowSolver
from flowcontrol_tpu_torch.core.sensor import SENSOR_TYPE, SensorPoint
from flowcontrol_tpu_torch.fem.facets import boundary_force_rows
from flowcontrol_tpu_torch.mesh.io import read_xdmf_mesh

logger = logging.getLogger(__name__)


def default_cylinder_mesh(**kwargs):
    """Generate the default cylinder mesh in memory (yinf=10 matches the
    reference's stock O1 domain: 12,274 cells, 56,383 mixed dofs). Nothing
    is cached on disk."""
    from flowcontrol_tpu_torch.mesh.generation import cylinder_mesh

    return cylinder_mesh(**{"yinf": 10.0, **kwargs})


class CylinderFlowSolver(FlowSolver):
    """Flow past a cylinder. Proposed Re=100."""

    BASEFLOW_NAME = "cylinder"

    def _make_boundaries(self) -> dict:
        """(ref: cylinderflowsolver.py:20-88) — later entries overwrite
        earlier ones on shared facets, matching dolfin marking order."""
        xinfa = self.params_mesh.user_data["xinfa"]
        xinf = self.params_mesh.user_data["xinf"]
        yinf = self.params_mesh.user_data["yinf"]
        radius = self.params_flow.user_data["D"] / 2
        ldelta = self.params_control.actuator_list[0].width
        tol = 1e-6

        def near_circle(x):
            return (np.abs(x[:, 0]) < radius + tol) & (np.abs(x[:, 1]) < radius + tol)

        return {
            "inlet": lambda x: np.abs(x[:, 0] - xinfa) < tol,
            "outlet": lambda x: np.abs(x[:, 0] - xinf) < tol,
            "walls": lambda x: (np.abs(x[:, 1] - yinf) < tol)
            | (np.abs(x[:, 1] + yinf) < tol),
            "cylinder": lambda x: near_circle(x)
            & ((x[:, 0] <= -ldelta) | (x[:, 0] >= ldelta)),
            # slot tolerance 0.01 mirrors between_cpp(tol="0.01")
            # (ref: cylinderflowsolver.py:64-69)
            "actuator_up": lambda x: near_circle(x)
            & (np.abs(x[:, 0]) < ldelta + 0.01)
            & (x[:, 1] > 0),
            "actuator_lo": lambda x: near_circle(x)
            & (np.abs(x[:, 0]) < ldelta + 0.01)
            & (x[:, 1] <= 0),
        }

    def _make_bcs(self) -> BoundaryConditions:
        """Perturbation BCs: zero on inlet/walls(y)/cylinder; actuator
        profiles on the slots (ref: cylinderflowsolver.py:90-108)."""
        return BoundaryConditions(
            bcu=[
                self.dirichlet_bc("inlet", value=(0.0, 0.0)),
                self.dirichlet_bc("walls", value=0.0, component=1),
                self.dirichlet_bc("cylinder", value=(0.0, 0.0)),
                self.dirichlet_bc("actuator_up", actuator=0),
                self.dirichlet_bc("actuator_lo", actuator=1),
            ],
            bcp=[],
        )

    # ── Force coefficients (ref: cylinderflowsolver.py:110-126) ─────────────

    def compute_steady_state(self, u_ctrl, method="newton", **kwargs):
        super().compute_steady_state(method=method, u_ctrl=u_ctrl, **kwargs)
        self.cl0, self.cd0 = self.compute_force_coefficients(
            self.fields.U0, self.fields.P0
        )

    def _force_rows(self) -> np.ndarray:
        if not hasattr(self, "_force_rows_cache"):
            rows = np.concatenate(
                [
                    self.markers.facets("cylinder"),
                    self.markers.facets("actuator_up"),
                    self.markers.facets("actuator_lo"),
                ]
            )
            D = self.params_flow.user_data["D"]
            nu = self.params_flow.uinf * D / self.params_flow.Re
            self._force_rows_cache = boundary_force_rows(self.space, rows, nu)
        return self._force_rows_cache

    def compute_force_coefficients(self, u, p) -> tuple[float, float]:
        """Lift and drag coefficients on the cylinder surface."""
        D = self.params_flow.user_data["D"]
        up = self.merge(u, p)
        drag, lift = self._force_rows() @ up
        qref = 0.5 * self.params_flow.uinf**2 * D
        return lift / qref, drag / qref

    @classmethod
    def make_default(
        cls,
        Re: float = 100,
        path_out=None,
        num_steps: int = 10,
        save_every: int = 0,
        Tstart: float = 0.0,
        verbose: int = 0,
        meshpath=None,
        mesh=None,
        mesh_kwargs: dict | None = None,
        **solver_kwargs,
    ) -> "CylinderFlowSolver":
        """Standard cylinder configuration (ref: cylinderflowsolver.py:128-186)."""
        if path_out is None:
            path_out = Path.cwd() / "data_output_cylinder"
        params_flow = fsp.ParamFlow(Re=Re, uinf=1.0)
        params_flow.user_data["D"] = 1.0
        params_time = fsp.ParamTime(num_steps=num_steps, dt=0.005, Tstart=Tstart)
        params_save = fsp.ParamSave(save_every=save_every, path_out=Path(path_out))
        params_solver = fsp.ParamSolver(
            **{**dict(throw_error=True, is_eq_nonlinear=True, shift=0.0),
               **solver_kwargs}
        )
        if mesh is None:
            mesh = (read_xdmf_mesh(meshpath) if meshpath is not None
                    else default_cylinder_mesh(**(mesh_kwargs or {})))
        params_mesh = fsp.ParamMesh(meshpath=meshpath, mesh=mesh)
        # domain extents from the actual mesh, read from ``meshpath`` where
        # one is given (robust to custom coarse meshes; the reference
        # hardcodes the stock O1 domain)
        params_mesh.user_data.update(
            {
                "xinf": float(mesh.coords[:, 0].max()),
                "xinfa": float(mesh.coords[:, 0].min()),
                "yinf": float(mesh.coords[:, 1].max()),
            }
        )

        radius = params_flow.user_data["D"] / 2
        width = ActuatorBCParabolicV.angular_size_deg_to_width(10, radius)
        params_control = fsp.ParamControl(
            sensor_list=[
                SensorPoint(sensor_type=SENSOR_TYPE.V, position=np.array([3.0, 0.0])),
                SensorPoint(sensor_type=SENSOR_TYPE.V, position=np.array([3.1, 1.0])),
                SensorPoint(sensor_type=SENSOR_TYPE.V, position=np.array([3.1, -1.0])),
            ],
            actuator_list=[
                ActuatorBCParabolicV(width=width, position_x=0.0, boundary_name="actuator_up"),
                ActuatorBCParabolicV(width=width, position_x=0.0, boundary_name="actuator_lo"),
            ],
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
