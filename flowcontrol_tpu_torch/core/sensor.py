"""Sensor classes for pointwise and subdomain-integral flow measurements.

Behavioral port of the reference sensors (ref: src/flowcontrol/sensor.py).
Every sensor reduces to a PRECOMPUTED row vector over the mixed dofs: the
reference's ``linear_form(v)`` duality (measurement when v is a Function,
C-matrix row when v is a TestFunction — ref: sensor.py:141-164) becomes
literal here — the row IS the C-matrix row, and measurement is a dot
product fused into the jitted step. MPI-safe ``peval`` (ref: utils/mpi.py)
is unnecessary: the state is a single device array.
"""

from __future__ import annotations

from abc import ABC, abstractmethod
from dataclasses import dataclass
from enum import IntEnum

import numpy as np

SENSOR_INDEX_DEFAULT = 10000


class SENSOR_TYPE(IntEnum):
    """Component extracted by a sensor (ref: sensor.py:32-42)."""

    U = 0
    V = 1
    P = 2
    OTHER = 3


@dataclass(kw_only=True)
class Sensor(ABC):
    sensor_type: SENSOR_TYPE
    require_loading: bool = False
    row: np.ndarray | None = None  # (n_dofs,) C-matrix row, set by load()

    @abstractmethod
    def load(self, flowsolver) -> None:
        """Precompute self.row from the discretization."""

    def eval(self, up: np.ndarray) -> float:
        """Scalar measurement from the mixed field (ref: sensor.py:61-78)."""
        if self.row is None:
            raise RuntimeError("Sensor not loaded; call load(flowsolver) first")
        return float(np.asarray(up) @ self.row)


@dataclass(kw_only=True)
class SensorPoint(Sensor):
    """Pointwise probe at a 2D location (ref: sensor.py:81-100)."""

    position: np.ndarray
    require_loading: bool = True

    def load(self, flowsolver) -> None:
        from flowcontrol_tpu_torch.fem.facets import point_probe_row

        self.row = point_probe_row(
            flowsolver.space, np.asarray(self.position), int(self.sensor_type)
        )


@dataclass(kw_only=True)
class SensorIntegral(Sensor):
    """Base for sensors integrating a quantity over a boundary subdomain
    (ref: sensor.py:103-168)."""

    sensor_index: int = SENSOR_INDEX_DEFAULT
    require_loading: bool = True


@dataclass(kw_only=True)
class SensorHorizontalWallShear(SensorIntegral):
    """∫ ∂u₁/∂x₂ ds over a horizontal wall segment (ref: sensor.py:171-224)."""

    x_sensor_left: float = 1.0
    x_sensor_right: float = 1.1
    y_sensor: float = 0.0

    def load(self, flowsolver) -> None:
        from flowcontrol_tpu_torch.fem.facets import wall_shear_row

        mesh = flowsolver.space.mesh
        mids = mesh.facet_midpoints()
        tol = 1e-8
        mask = (
            (np.abs(mids[:, 1] - self.y_sensor) < tol)
            & (mids[:, 0] >= self.x_sensor_left)
            & (mids[:, 0] <= self.x_sensor_right)
        )
        facet_rows = np.nonzero(mask)[0]
        if len(facet_rows) == 0:
            raise ValueError(
                f"no boundary facets found for wall-shear sensor at y={self.y_sensor}, "
                f"x in [{self.x_sensor_left}, {self.x_sensor_right}]"
            )
        self.row = wall_shear_row(flowsolver.space, facet_rows, comp=0, deriv=1)


def sensor_matrix(sensors, n_dofs: int) -> np.ndarray:
    """Stack sensor rows into the C matrix (n_sensors, n_dofs)."""
    return (
        np.stack([s.row for s in sensors])
        if sensors
        else np.zeros((0, n_dofs))
    )
