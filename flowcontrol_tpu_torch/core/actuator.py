"""Actuator classes for boundary-condition and body-force flow control.

Behavioral port of the reference actuators
(ref: src/flowcontrol/actuator.py). The JIT-compiled C++ dolfin Expressions
become plain vectorized numpy callables evaluated ONCE on node coordinates at
setup; the control amplitude ``u_ctrl`` is no longer baked into a mutable
Expression but enters the jitted step as an explicit input — actuation is a
precomputed profile scaled by ``u_ctrl`` (a rank-1 update), so no
re-assembly ever happens on the hot path.
"""

from __future__ import annotations

from abc import ABC, abstractmethod
from dataclasses import dataclass, field
from enum import IntEnum

import numpy as np


class ACTUATOR_TYPE(IntEnum):
    """BC applies a Dirichlet profile; FORCE adds a volumic force
    (ref: actuator.py:30-37)."""

    BC = 1
    FORCE = 2


class CYLINDER_ACTUATION_MODE(IntEnum):
    """User-facing hint: SUCTION (pole slots) or ROTATION (spinning surface)
    (ref: actuator.py:41-49)."""

    SUCTION = 1
    ROTATION = 2


@dataclass(kw_only=True)
class Actuator(ABC):
    """Abstract actuator. ``u_ctrl`` mirrors the reference's mutable
    expression amplitude (ref: actuator.py:53-105) for the imperative API;
    the functional step path passes amplitudes explicitly."""

    actuator_type: ACTUATOR_TYPE
    u_ctrl: float = 0.0

    @abstractmethod
    def profile(self, x: np.ndarray) -> np.ndarray:
        """Per-unit-u_ctrl velocity/force profile at coordinates (n, 2) -> (n, 2)."""

    def load_expression(self, flowsolver) -> None:
        """Hook for setup-time initialization (normalization etc.)."""
        return None


@dataclass(kw_only=True)
class ActuatorBC(Actuator):
    """Dirichlet-type actuator bound to a named boundary
    (ref: actuator.py:108-169)."""

    boundary_name: str | None = None
    actuator_type: ACTUATOR_TYPE = ACTUATOR_TYPE.BC


@dataclass(kw_only=True)
class ActuatorBCParabolicV(ActuatorBC):
    """Parabolic wall-normal velocity slot: v = u_ctrl·(1-((x-x0)/L)²) on
    [x0-L, x0+L], zero outside (ref: actuator.py:172-221)."""

    width: float = 0.0
    position_x: float = 0.0

    def profile(self, x: np.ndarray) -> np.ndarray:
        xi = x[:, 0] - self.position_x
        lsq = self.width**2
        v = np.where(np.abs(xi) >= self.width, 0.0, -(xi + self.width) * (xi - self.width) / lsq)
        return np.stack([np.zeros_like(v), v], axis=1)

    @staticmethod
    def angular_size_deg_to_width(angular_size_deg: float, cylinder_radius: float) -> float:
        """Slot angular span (deg) -> half-width L (ref: actuator.py:202-221)."""
        return cylinder_radius * np.sin(0.5 * angular_size_deg * np.pi / 180)


@dataclass(kw_only=True)
class ActuatorBCRotation(ActuatorBC):
    """Tangential velocity of a cylinder of diameter d spinning at rate
    u_ctrl: surface speed u_ctrl·d/2 (ref: actuator.py:224-252)."""

    position_x: float = 0.0
    position_y: float = 0.0
    diameter: float = 1.0

    def profile(self, x: np.ndarray) -> np.ndarray:
        th = np.arctan2(x[:, 1] - self.position_y, x[:, 0] - self.position_x)
        speed = self.diameter / 2
        return np.stack([-np.sin(th) * speed, np.cos(th) * speed], axis=1)


@dataclass(kw_only=True)
class ActuatorBCUniformU(ActuatorBC):
    """Uniform streamwise velocity (u_ctrl, 0) — lid-driven cavity
    (ref: actuator.py:255-277)."""

    def profile(self, x: np.ndarray) -> np.ndarray:
        return np.stack([np.ones(len(x)), np.zeros(len(x))], axis=1)


@dataclass(kw_only=True)
class ActuatorForceGaussianV(Actuator):
    """Unit-L2-norm Gaussian wall-normal volumic force
    (ref: actuator.py:280-313): f = (0, u_ctrl·η·exp(-r²/(2σ²))),
    η = 1/‖f‖_L2 computed at load time so the B column has unit norm."""

    sigma: float
    position: np.ndarray
    actuator_type: ACTUATOR_TYPE = ACTUATOR_TYPE.FORCE
    eta: float = field(default=1.0)

    def profile(self, x: np.ndarray) -> np.ndarray:
        r2 = (x[:, 0] - self.position[0]) ** 2 + (x[:, 1] - self.position[1]) ** 2
        g = self.eta * np.exp(-0.5 * r2 / self.sigma**2)
        return np.stack([np.zeros_like(g), g], axis=1)

    def load_expression(self, flowsolver) -> None:
        from flowcontrol_tpu_torch.fem.projection import l2_norm_function

        self.eta = 1.0
        btb = l2_norm_function(flowsolver.geom, flowsolver.space, self.profile)
        self.eta = 1.0 / btb
