"""Parameter dataclasses for FlowSolver configuration.

API-parity port of the reference's 8 Param* dataclasses
(ref: src/flowcontrol/flowsolverparameters.py). Differences:

- ``ParamMesh`` may carry an in-memory ``Mesh2D`` instead of (or in addition
  to) an XDMF path — mesh generation is a first-class host-side step here.
- ``ParamSolver`` gains device-solver knobs: ``device`` (a torch device
  string, ``'cuda'`` unless the caller asks for ``'cpu'``),
  ``solver_backend`` ('auto' | 'host_lu' | 'dense_lu' | 'gmres' |
  'bicgstab'), ``precision``
  ('auto' | 'f32' | 'f64') and ``stepper_options`` (Stepper fields passed
  through) controlling the device hot loop.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from pathlib import Path
from typing import TYPE_CHECKING, Optional

from flowcontrol_tpu_torch.core.actuator import Actuator
from flowcontrol_tpu_torch.core.sensor import Sensor

if TYPE_CHECKING:
    from flowcontrol_tpu_torch.mesh.mesh import Mesh2D


@dataclass(kw_only=True)
class ParamFlowSolver:
    """Base class: provides the ``user_data`` escape hatch
    (ref: flowsolverparameters.py:26-37)."""

    user_data: dict = field(default_factory=dict)


@dataclass
class ParamFlow(ParamFlowSolver):
    """Reynolds number and horizontal inlet velocity."""

    Re: float
    uinf: float = 1.0


@dataclass
class ParamMesh(ParamFlowSolver):
    """Mesh source: an XDMF path and/or an in-memory mesh object."""

    meshpath: Optional[Path] = None
    mesh: Optional["Mesh2D"] = None

    def __post_init__(self):
        if self.meshpath is not None:
            self.meshpath = Path(self.meshpath)
        if self.meshpath is None and self.mesh is None:
            raise ValueError("ParamMesh needs meshpath or mesh")


@dataclass
class ParamControl(ParamFlowSolver):
    """Sensor/actuator lists; counts auto-computed
    (ref: flowsolverparameters.py:69-96)."""

    sensor_list: list[Sensor] = field(default_factory=list)
    sensor_number: int = field(init=False)
    actuator_list: list[Actuator] = field(default_factory=list)
    actuator_number: int = field(init=False)

    def __post_init__(self):
        self.sensor_number = len(self.sensor_list)
        self.actuator_number = len(self.actuator_list)


@dataclass
class ParamTime(ParamFlowSolver):
    """num_steps, dt, Tstart; Tfinal derived (ref: flowsolverparameters.py:99-124)."""

    num_steps: int
    dt: float
    Tstart: float = 0.0
    Tfinal: float = field(init=False)

    def __post_init__(self):
        self.Tfinal = self.num_steps * self.dt


@dataclass
class ParamRestart(ParamFlowSolver):
    """Legacy restart info (ref: flowsolverparameters.py:127-146)."""

    save_every_old: int = 0
    restart_order: int | str = 2
    dt_old: float = 0.0
    Trestartfrom: float = 0.0


@dataclass
class ParamSave(ParamFlowSolver):
    """Output dir, snapshot frequency, energy logging frequency."""

    path_out: Path
    save_every: int
    energy_every: int = 1

    def __post_init__(self):
        self.path_out = Path(self.path_out)


@dataclass
class ParamSolver(ParamFlowSolver):
    """Solver/equation options (ref: flowsolverparameters.py:169-192)
    plus device-backend knobs."""

    throw_error: bool = True
    shift: float = 0.0
    is_eq_nonlinear: bool = True
    time_scheme: str = "bdf"  # 'bdf' (BDF1→BDF2 ramp) or 'cn'
    # device additions:
    device: str = "cuda"  # torch device of the hot loop; 'cpu' only when asked for
    solver_backend: str = "auto"  # 'auto' | 'host_lu' | 'dense_lu' | 'gmres' | 'bicgstab'
    precision: str = "auto"  # 'auto' (f64 on CPU, f32 on CUDA) | 'f32' | 'f64'
    pin_pressure: bool | None = None  # None = auto-detect enclosed flows
    # extra Stepper keyword overrides — any core.stepper.Stepper dataclass
    # field, e.g. force_substructure=True (the multifrontal solve even
    # where the dense LU fits) or trisolve="cuda" (the blocked LU solved by
    # kernel K3 in place of the pivoted LU's triangular solves), or the
    # Krylov backends' krylov_rtol, gmres_iters, krylov_max_cycles and
    # measure_residual
    stepper_options: dict = field(default_factory=dict)


@dataclass
class ParamIC(ParamFlowSolver):
    """Divergence-free Gaussian initial perturbation parameters."""

    xloc: float = 0.0
    yloc: float = 0.0
    radius: float = 1.0
    amplitude: float = 1.0
