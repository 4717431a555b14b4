"""Flow over an open cavity at Re=7500.

Behavioral port of the reference CavityFlowSolver
(ref: src/examples/cavity/cavityflowsolver.py): channel with inlet/outlet,
slip upper wall, cavity cut into the lower wall with slip/no-slip segment
split, Gaussian volume-force actuator upstream of the cavity, wall-shear +
point sensors, and the channel/cavity-split steady-state initial guess.
Transcribed from ``flowcontrol_tpu/models/cavity.py``; ``make_default``
takes ``device=`` (e.g. ``'cuda'``) and the other ParamSolver fields as
keywords, and a mesh file as ``meshpath=`` (an ``.xdmf``, ``mesh/io.py``).

At the default mesh (26,440 cells, 120,068 mixed dofs) the dense LU's f64
factorization does not fit an 80 GB card, so on CUDA the Stepper takes the
multifrontal solve.

The closed loop's inputs at that mesh (``tools/cavity_feedback_synth.py``
writes them): ``_controllers/cavity_{rom,lqg,mode}_re7500_n120068.*``, each
with the checksum of the mesh it was made on; ``load_cavity_mode`` and
``load_cavity_controller`` refuse a solver on another mesh.
"""

from __future__ import annotations

import logging
from pathlib import Path

import numpy as np

from flowcontrol_tpu_torch.core import flowsolverparameters as fsp
from flowcontrol_tpu_torch.core.actuator import ActuatorForceGaussianV
from flowcontrol_tpu_torch.core.flowfield import BoundaryConditions
from flowcontrol_tpu_torch.core.flowsolver import FlowSolver
from flowcontrol_tpu_torch.core.sensor import (
    SENSOR_TYPE,
    SensorHorizontalWallShear,
    SensorPoint,
)
from flowcontrol_tpu_torch.mesh.io import read_xdmf_mesh

logger = logging.getLogger(__name__)

CONTROLLER_DIR = Path(__file__).parent / "_controllers"


def cavity_feedback_files(n_dofs: int, Re: float = 7500, directory=None) -> dict:
    """The paths of the closed loop's three files at a mesh of ``n_dofs``:
    'rom' (the modal ROM), 'lqg' (the compensator) and 'mode' (the leading
    eigenmode, the initial condition)."""
    d = CONTROLLER_DIR if directory is None else Path(directory)
    return {kind: d / f"cavity_{kind}_re{Re:g}_n{n_dofs}.{'mat' if kind == 'lqg' else 'npz'}"
            for kind in ("rom", "lqg", "mode")}


def load_cavity_mode(fs, path=None) -> dict:
    """The leading eigenmode of ``fs``'s mesh: {'eig': λ, 'v_re', 'v_im'
    (float32, n_dofs)}, from ``path`` (default: the committed file at its
    dof count); ``ValueError`` where the file was made on another mesh."""
    from flowcontrol_tpu_torch.models.baseflows import require_mesh

    path = Path(path or cavity_feedback_files(fs.space.n_dofs, fs.params_flow.Re)["mode"])
    with np.load(path, allow_pickle=False) as d:
        require_mesh(path, d["mesh_sha256"], fs.mesh)
        return {k: d[k] for k in ("eig", "v_re", "v_im")}


def load_cavity_controller(fs, path=None):
    """The discrete LQG compensator of ``fs``'s mesh as a ``Controller``
    (u = +K(y)), from ``path`` (default: the committed file at its dof
    count); ``ValueError`` where the file was made on another mesh."""
    import scipy.io as sio

    from flowcontrol_tpu_torch.core.controller import Controller
    from flowcontrol_tpu_torch.models.baseflows import require_mesh

    path = Path(path or cavity_feedback_files(fs.space.n_dofs, fs.params_flow.Re)["lqg"])
    require_mesh(path, sio.loadmat(str(path))["mesh_sha256"][0], fs.mesh)
    return Controller.from_file(path)


def default_cavity_mesh(**kwargs):
    """Generate the default open-cavity mesh in memory (26,440 cells,
    120,068 mixed dofs). Nothing is cached on disk."""
    from flowcontrol_tpu_torch.mesh.generation import cavity_mesh

    return cavity_mesh(**kwargs)


class CavityFlowSolver(FlowSolver):
    """Flow over an open cavity. Proposed Re=7500."""

    BASEFLOW_NAME = "cavity"

    def _make_boundaries(self) -> dict:
        """10 boundaries (ref: cavityflowsolver.py:22-149)."""
        ud_m = self.params_mesh.user_data
        L = self.params_flow.user_data["L"]
        D = self.params_flow.user_data["D"]
        xinfa, xinf, yinf = ud_m["xinfa"], ud_m["xinf"], ud_m["yinf"]
        x0ns_left, x0ns_right = ud_m["x0ns_left"], ud_m["x0ns_right"]
        tol = 1e-7

        return {
            "inlet": lambda x: np.abs(x[:, 0] - xinfa) < tol,
            "outlet": lambda x: np.abs(x[:, 0] - xinf) < tol,
            "upper_wall": lambda x: np.abs(x[:, 1] - yinf) < tol,
            "cavity_left": lambda x: (np.abs(x[:, 0]) < tol)
            & (x[:, 1] > -D - tol) & (x[:, 1] < tol),
            "cavity_botm": lambda x: (np.abs(x[:, 1] + D) < tol)
            & (x[:, 0] > -tol) & (x[:, 0] < L + tol),
            "cavity_right": lambda x: (np.abs(x[:, 0] - L) < tol)
            & (x[:, 1] > -D - tol) & (x[:, 1] < tol),
            "lower_wall_left_sf": lambda x: (np.abs(x[:, 1]) < tol)
            & (x[:, 0] >= xinfa) & (x[:, 0] <= x0ns_left + tol),
            "lower_wall_left_ns": lambda x: (np.abs(x[:, 1]) < tol)
            & (x[:, 0] >= x0ns_left - tol) & (x[:, 0] <= 0),
            "lower_wall_right_ns": lambda x: (np.abs(x[:, 1]) < tol)
            & (x[:, 0] >= L - tol) & (x[:, 0] <= x0ns_right + tol),
            "lower_wall_right_sf": lambda x: (np.abs(x[:, 1]) < tol)
            & (x[:, 0] >= x0ns_right - tol) & (x[:, 0] <= xinf),
        }

    def _make_bcs(self) -> BoundaryConditions:
        """(ref: cavityflowsolver.py:151-193)"""
        return BoundaryConditions(
            bcu=[
                self.dirichlet_bc("inlet", value=(0.0, 0.0)),
                self.dirichlet_bc("upper_wall", value=0.0, component=1),
                self.dirichlet_bc("lower_wall_left_sf", value=0.0, component=1),
                self.dirichlet_bc("lower_wall_left_ns", value=(0.0, 0.0)),
                self.dirichlet_bc("lower_wall_right_ns", value=(0.0, 0.0)),
                self.dirichlet_bc("lower_wall_right_sf", value=0.0, component=1),
                self.dirichlet_bc("cavity_left", value=(0.0, 0.0)),
                self.dirichlet_bc("cavity_botm", value=(0.0, 0.0)),
                self.dirichlet_bc("cavity_right", value=(0.0, 0.0)),
            ],
            bcp=[],
        )

    def _default_steady_state_initial_guess(self) -> np.ndarray:
        """u=1 in the channel, u=0 inside the cavity
        (ref: cavityflowsolver.py:195-207)."""
        u = np.zeros((self.space.n_vnodes, 2))
        u[:, 0] = (self.space.vel_node_coords[:, 1] >= 0).astype(float)
        return u

    @classmethod
    def make_default(
        cls,
        Re: float = 7500,
        path_out=None,
        num_steps: int = 10,
        save_every: int = 0,
        Tstart: float = 0.0,
        verbose: int = 0,
        meshpath=None,
        mesh=None,
        mesh_kwargs: dict | None = None,
        **solver_kwargs,
    ) -> "CavityFlowSolver":
        """Standard open-cavity configuration (ref: cavityflowsolver.py:209-280)."""
        if path_out is None:
            path_out = Path.cwd() / "data_output_cavity"
        params_flow = fsp.ParamFlow(Re=Re, uinf=1.0)
        params_flow.user_data.update({"L": 1.0, "D": 1.0})
        params_time = fsp.ParamTime(num_steps=num_steps, dt=0.0004, Tstart=Tstart)
        params_save = fsp.ParamSave(save_every=save_every, path_out=Path(path_out))
        params_solver = fsp.ParamSolver(
            **{**dict(throw_error=True, is_eq_nonlinear=True, shift=0.0),
               **solver_kwargs}
        )
        if mesh is None:
            mesh = (read_xdmf_mesh(meshpath) if meshpath is not None
                    else default_cavity_mesh(**(mesh_kwargs or {})))
        params_mesh = fsp.ParamMesh(meshpath=meshpath, mesh=mesh)
        # x0ns_* split the lower wall into slip and no-slip segments; the
        # domain extents come from the actual mesh (read from ``meshpath``
        # where one is given)
        params_mesh.user_data.update(
            {
                "xinf": float(mesh.coords[:, 0].max()),
                "xinfa": float(mesh.coords[:, 0].min()),
                "yinf": float(mesh.coords[:, 1].max()),
                "x0ns_left": -0.4,
                "x0ns_right": 1.75,
            }
        )
        params_control = fsp.ParamControl(
            sensor_list=[
                SensorHorizontalWallShear(
                    sensor_index=100, x_sensor_left=1.0, x_sensor_right=1.1,
                    y_sensor=0.0, sensor_type=SENSOR_TYPE.OTHER,
                ),
                SensorPoint(sensor_type=SENSOR_TYPE.U, position=np.array([0.1, 0.1])),
            ],
            actuator_list=[
                ActuatorForceGaussianV(sigma=0.0849, position=np.array([-0.1, 0.02])),
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
