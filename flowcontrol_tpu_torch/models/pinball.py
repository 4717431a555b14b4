"""Fluidic pinball: three cylinders in an equilateral triangle (Re ≤ 100).

Behavioral port of the reference PinballFlowSolver
(ref: src/examples/pinball/pinballflowsolver.py): dual actuation modes —
SUCTION (parabolic slots at each cylinder pole/nose, 9 boundaries) vs
ROTATION (whole surfaces actuated, 6 boundaries) — per-surface lift/drag
coefficient dict, and the symmetric/antisymmetric custom initial guesses for
branch selection. Transcribed from ``flowcontrol_tpu/models/pinball.py``;
``make_default`` takes ``device=`` (e.g. ``'cuda'``) and the other
ParamSolver fields as keywords.

The JAX package caches its generated mesh as XDMF; the port generates the
mesh in memory on every ``make_default`` (the default: 14,748 cells, 67,920
mixed dofs) unless given ``mesh=`` or ``meshpath=`` (an ``.xdmf`` file,
``mesh/io.py``). The LQG
compensator of the MIMO closed loop, ``_controllers/pinball_lqg_re100.mat``
(22 states, 3 sensors, 3 rotation actuators, discrete at dt = 0.005), is
the JAX package's file.
"""

from __future__ import annotations

import logging
from pathlib import Path

import numpy as np

from flowcontrol_tpu_torch.core import flowsolverparameters as fsp
from flowcontrol_tpu_torch.core.actuator import (
    CYLINDER_ACTUATION_MODE,
    ActuatorBCParabolicV,
    ActuatorBCRotation,
)
from flowcontrol_tpu_torch.core.flowfield import BoundaryConditions
from flowcontrol_tpu_torch.core.flowsolver import FlowSolver
from flowcontrol_tpu_torch.core.sensor import SENSOR_TYPE, SensorPoint
from flowcontrol_tpu_torch.fem.facets import boundary_force_rows
from flowcontrol_tpu_torch.mesh.io import read_xdmf_mesh

logger = logging.getLogger(__name__)

#: the MIMO LQG compensator at Re=100 (u = +K(y): see
#: examples/run_pinball_feedback.py)
PINBALL_LQG_RE100 = Path(__file__).parent / "_controllers" / "pinball_lqg_re100.mat"


def default_pinball_mesh(**kwargs):
    """Generate the default pinball mesh in memory (14,748 cells, 67,920
    mixed dofs). Nothing is cached on disk."""
    from flowcontrol_tpu_torch.mesh.generation import pinball_mesh

    return pinball_mesh(**kwargs)


class PinballFlowSolver(FlowSolver):
    """Flow past 3 cylinders (fluidic pinball). Proposed Re=100."""

    BASEFLOW_NAME = "pinball"

    def _make_boundaries(self) -> dict:
        """(ref: pinballflowsolver.py:25-132)"""
        mode = self.params_control.user_data["mode_actuation"]
        ud = self.params_mesh.user_data
        xinfa, xinf, yinf = ud["xinfa"], ud["xinf"], ud["yinf"]
        radius = self.params_flow.user_data["D"] / 2
        x_mid = -1.5 * np.cos(np.pi / 6)
        tol = 1e-7

        def near_top(x):
            return (
                (np.abs(x[:, 0]) < radius + tol)
                & (x[:, 1] > radius / 2) & (x[:, 1] < 5 * radius / 2)
            )

        def near_bot(x):
            return (
                (np.abs(x[:, 0]) < radius + tol)
                & (x[:, 1] < -radius / 2) & (x[:, 1] > -5 * radius / 2)
            )

        def near_mid(x):
            return (
                (np.abs(x[:, 0] - x_mid) < radius + tol)
                & (np.abs(x[:, 1]) < radius + tol)
            )

        bnd = {
            "inlet": lambda x: np.abs(x[:, 0] - xinfa) < tol,
            "outlet": lambda x: np.abs(x[:, 0] - xinf) < tol,
            "walls": lambda x: (np.abs(x[:, 1] - yinf) < tol)
            | (np.abs(x[:, 1] + yinf) < tol),
        }
        if mode == CYLINDER_ACTUATION_MODE.SUCTION:
            ldelta = self.params_control.actuator_list[0].width
            bnd.update(
                {
                    "cylinder_top": near_top,
                    "cylinder_bot": near_bot,
                    "cylinder_mid": near_mid,
                    "actuator_mid": lambda x: near_mid(x)
                    & (np.abs(x[:, 0] - x_mid) < ldelta + 0.01),
                    "actuator_top": lambda x: near_top(x)
                    & (np.abs(x[:, 0]) < ldelta + 0.01),
                    "actuator_bot": lambda x: near_bot(x)
                    & (np.abs(x[:, 0]) < ldelta + 0.01),
                }
            )
        else:
            bnd.update(
                {
                    "actuator_mid": near_mid,
                    "actuator_top": near_top,
                    "actuator_bot": near_bot,
                }
            )
        return bnd

    def _make_bcs(self) -> BoundaryConditions:
        """(ref: pinballflowsolver.py:133-184)"""
        mode = self.params_control.user_data["mode_actuation"]
        bcu = [
            self.dirichlet_bc("inlet", value=(0.0, 0.0)),
            self.dirichlet_bc("walls", value=0.0, component=1),
        ]
        if mode == CYLINDER_ACTUATION_MODE.SUCTION:
            bcu += [
                self.dirichlet_bc("cylinder_top", value=(0.0, 0.0)),
                self.dirichlet_bc("cylinder_bot", value=(0.0, 0.0)),
                self.dirichlet_bc("cylinder_mid", value=(0.0, 0.0)),
            ]
        bcu += [
            self.dirichlet_bc("actuator_mid", actuator=0),
            self.dirichlet_bc("actuator_top", actuator=1),
            self.dirichlet_bc("actuator_bot", actuator=2),
        ]
        return BoundaryConditions(bcu=bcu, bcp=[])

    def _make_BCs(self) -> BoundaryConditions:
        """Steady-state BCs: uniform flow at inlet AND walls
        (ref: pinballflowsolver.py:186-192)."""
        uinf = self.params_flow.uinf
        bcu_inlet = self.dirichlet_bc("inlet", value=(uinf, 0.0))
        bcu_walls = self.dirichlet_bc("walls", value=(uinf, 0.0))
        bcs = self._make_bcs()
        return BoundaryConditions(bcu=[bcu_inlet, bcu_walls] + bcs.bcu[2:], bcp=[])

    # ── Force coefficients (ref: pinballflowsolver.py:194-232) ───────────────

    def compute_steady_state(self, u_ctrl, method="newton", **kwargs):
        super().compute_steady_state(method=method, u_ctrl=u_ctrl, **kwargs)
        force_coeffs = self.compute_force_coefficients(self.fields.U0, self.fields.P0)
        if self.verbose:
            for name, (cl, cd) in force_coeffs.items():
                logger.info(f"{name}: Cl={cl:.4f}, Cd={cd:.4f}")

    def compute_force_coefficients(self, u, p) -> dict:
        """{surface_name: (cl, cd)} for each cylinder surface."""
        mode = self.params_control.user_data["mode_actuation"]
        D = self.params_flow.user_data["D"]
        nu = self.params_flow.uinf * D / self.params_flow.Re
        if mode == CYLINDER_ACTUATION_MODE.SUCTION:
            surfaces = [
                "cylinder_mid", "actuator_mid", "cylinder_top",
                "actuator_top", "cylinder_bot", "actuator_bot",
            ]
        else:
            surfaces = ["actuator_mid", "actuator_top", "actuator_bot"]
        up = self.merge(u, p)
        qref = 0.5 * self.params_flow.uinf**2 * D
        result = {}
        for name in surfaces:
            rows = boundary_force_rows(self.space, self.markers.facets(name), nu)
            drag, lift = rows @ up
            result[name] = (lift / qref, drag / qref)
        return result

    @classmethod
    def make_default(
        cls,
        Re: float = 50,
        mode_actuation=None,
        path_out=None,
        num_steps: int = 10,
        save_every: int = 0,
        Tstart: float = 0.0,
        verbose: int = 0,
        meshpath=None,
        mesh=None,
        mesh_kwargs: dict | None = None,
        **solver_kwargs,
    ) -> "PinballFlowSolver":
        """(ref: pinballflowsolver.py:237-320)"""
        if path_out is None:
            path_out = Path.cwd() / "data_output_pinball"
        if mode_actuation is None:
            mode_actuation = CYLINDER_ACTUATION_MODE.ROTATION

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
                    else default_pinball_mesh(**(mesh_kwargs or {})))
        params_mesh = fsp.ParamMesh(meshpath=meshpath, mesh=mesh)
        params_mesh.user_data.update(
            {
                "xinf": float(mesh.coords[:, 0].max()),
                "xinfa": float(mesh.coords[:, 0].min()),
                "yinf": float(mesh.coords[:, 1].max()),
            }
        )

        d = params_flow.user_data["D"]
        position_mid = [-1.5 * np.cos(np.pi / 6), 0.0]
        position_top = [0.0, +0.75]
        # boundary_name links each actuator to its _make_boundaries entry
        # (needed by OperatorGetter.get_B's BC lifting — mirrors the
        # reference's ActuatorBC boundary resolution, ref: actuator.py:108-169)
        names = ("actuator_mid", "actuator_top", "actuator_bot")
        if mode_actuation == CYLINDER_ACTUATION_MODE.SUCTION:
            width = ActuatorBCParabolicV.angular_size_deg_to_width(10, d / 2)
            actuator_list = [
                ActuatorBCParabolicV(width=width, position_x=position_mid[0],
                                     boundary_name=names[0]),
                ActuatorBCParabolicV(width=width, position_x=position_top[0],
                                     boundary_name=names[1]),
                ActuatorBCParabolicV(width=width, position_x=position_top[0],
                                     boundary_name=names[2]),
            ]
        else:
            actuator_list = [
                ActuatorBCRotation(
                    position_x=position_mid[0], position_y=position_mid[1],
                    diameter=d, boundary_name=names[0],
                ),
                ActuatorBCRotation(
                    position_x=position_top[0], position_y=+position_top[1],
                    diameter=d, boundary_name=names[1],
                ),
                ActuatorBCRotation(
                    position_x=position_top[0], position_y=-position_top[1],
                    diameter=d, boundary_name=names[2],
                ),
            ]
        params_control = fsp.ParamControl(
            sensor_list=[
                SensorPoint(sensor_type=SENSOR_TYPE.V, position=np.array([8.0, 0.0])),
                SensorPoint(sensor_type=SENSOR_TYPE.V, position=np.array([10.0, 0.0])),
                SensorPoint(sensor_type=SENSOR_TYPE.V, position=np.array([12.0, 0.0])),
            ],
            actuator_list=actuator_list,
            user_data={"mode_actuation": mode_actuation},
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


def pinball_custom_initial_guess(space, mode: str = "symmetric") -> np.ndarray:
    """Uniform mixed-field initial guesses selecting steady branches
    (ref: pinballflowsolver.py:328-358)."""
    u = np.zeros((space.n_vnodes, 2))
    if mode == "symmetric":
        u[:, 0] = 1.0
    elif mode == "antisymmetric_top":
        u[:, 0] = 1.0 / np.sqrt(2)
        u[:, 1] = +1.0 / np.sqrt(2)
    elif mode == "antisymmetric_bot":
        u[:, 0] = 1.0 / np.sqrt(2)
        u[:, 1] = -1.0 / np.sqrt(2)
    else:
        raise ValueError(f"Unknown mode '{mode}'")
    return np.concatenate([u.reshape(-1), np.zeros(space.n_pressure_dofs)])
