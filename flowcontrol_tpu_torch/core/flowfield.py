"""Flow-field containers and simulation paths.

Port of the reference data containers (ref: src/flowcontrol/flowfield.py):
SimPaths (frozen path bundle), FlowField (mixed field auto-split),
FlowFieldCollection (base flow + time-stepping history), BoundaryConditions.

Fields here are flat numpy arrays in the mixed Taylor-Hood layout (see
flowcontrol_tpu_torch/mesh/dofmap.py); the device-resident stepping state lives
in the stepper's carry and is mirrored back into this collection after each
step.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from pathlib import Path
from typing import List, Optional

import numpy as np

from flowcontrol_tpu_torch.fem.bc import DirichletBC
from flowcontrol_tpu_torch.mesh.dofmap import TaylorHoodSpace


@dataclass(frozen=True)
class SimPaths:
    """All simulation I/O paths (ref: flowfield.py:21-36)."""

    U0: Path
    P0: Path
    steady_meta: Path
    U: Path
    P: Path
    Uprev: Path
    U_restart: Path
    Uprev_restart: Path
    P_restart: Path
    timeseries: Path
    metadata: Path
    mesh: Optional[Path]


class FlowField:
    """A mixed (velocity, pressure) field with auto-split views
    (ref: flowfield.py:39-58)."""

    def __init__(self, up: np.ndarray, space: TaylorHoodSpace):
        self.up = np.asarray(up)
        self.space = space

    @property
    def u(self) -> np.ndarray:
        """Velocity nodal values (n_vnodes, 2)."""
        return self.up[: self.space.n_vel_dofs].reshape(self.space.n_vnodes, 2)

    @property
    def p(self) -> np.ndarray:
        """Pressure vertex values (nv,)."""
        return self.up[self.space.n_vel_dofs :]


@dataclass
class FlowFieldCollection:
    """Base flow, IC, and time-stepping history (ref: flowfield.py:61-97)."""

    U0: Optional[np.ndarray] = None  # base velocity (n_vnodes, 2)
    P0: Optional[np.ndarray] = None  # base pressure (nv,)
    UP0: Optional[np.ndarray] = None  # mixed base flow (n_dofs,)
    STEADY: Optional[np.ndarray] = None
    ic: Optional[FlowField] = None
    u_: Optional[np.ndarray] = None
    p_: Optional[np.ndarray] = None
    up_: Optional[np.ndarray] = None
    u_n: Optional[np.ndarray] = None
    u_nn: Optional[np.ndarray] = None
    p_n: Optional[np.ndarray] = None
    Usave: Optional[np.ndarray] = None
    Usave_n: Optional[np.ndarray] = None
    Psave: Optional[np.ndarray] = None


@dataclass
class BoundaryConditions:
    """Lists of velocity/pressure Dirichlet BCs (ref: flowfield.py:100-105)."""

    bcu: List[DirichletBC] = field(default_factory=list)
    bcp: List[DirichletBC] = field(default_factory=list)
