"""LTI state-space Controller with ZOH one-step integration.

Behavioral match of the reference Controller
(ref: src/flowcontrol/controller.py): continuous state-space with internal
state ``x``, cached ZOH discretization keyed on dt, MIMO ``step(y, dt)``,
``reset()``, arithmetic preserving type with state concatenation, ``inv()``,
and ``.mat`` file I/O.

The counterpart of ``flowcontrol_tpu/core/controller.py`` (host numpy).
``discrete(dt)`` exports the (Ad, Bd, Cd, Dd) tuple so the controller update
runs on the device inside ``Stepper.rollout_closed_loop`` (the reference
steps the controller in Python between CFD steps, ref:
run_cylinder_example.py:83-86), and :func:`stack_controllers` stacks a
population of controllers for a batched rollout.
"""

from __future__ import annotations

from pathlib import Path
from typing import Callable

import numpy as np

from flowcontrol_tpu_torch.utils.statespace import StateSpace, c2d_zoh, ss_inv


def read_matfile(file) -> dict:
    """Read A, B, C, D matrices from a .mat file (ref: lticontrol.read_matfile).

    An optional scalar ``dt`` marks a DISCRETE-native artifact (sampled-data
    designs from utils.lticontrol.dlqg_regulator): A..D are then the
    already-discretized matrices valid at exactly that sampling period."""
    import scipy.io as sio

    data = sio.loadmat(str(file))
    out = {}
    for key in ("A", "B", "C", "D"):
        if key not in data:
            raise KeyError(f"matrix {key} missing from {file}")
        out[key] = np.atleast_2d(np.asarray(data[key], dtype=np.float64))
    if "dt" in data:
        out["dt"] = float(np.asarray(data["dt"]).reshape(-1)[0])
    return out


def write_matfile(file, sys: StateSpace) -> None:
    import scipy.io as sio

    sio.savemat(str(file), {"A": sys.A, "B": sys.B, "C": sys.C, "D": sys.D})


class Controller(StateSpace):
    """Continuous-time LTI controller with internal state and ZOH stepping."""

    def __init__(self, A, B, C, D, file: Path | None = None, x0=None,
                 dt: float | None = None):
        super().__init__(A, B, C, D)
        self.file = file
        self.x = (
            np.zeros(self.nstates)
            if x0 is None
            else np.asarray(x0, dtype=np.float64).reshape(self.nstates)
        )
        self._dt = None
        #: non-None = DISCRETE-native controller: A..D are already the
        #: sampled-data matrices, valid at exactly this period
        self.native_dt = dt

    # ── Constructors ─────────────────────────────────────────────────────────

    @classmethod
    def from_file(cls, file, x0=None) -> "Controller":
        m = read_matfile(file)
        return cls(m["A"], m["B"], m["C"], m["D"], x0=x0, file=Path(file),
                   dt=m.get("dt"))

    @classmethod
    def from_matrices(cls, A, B, C, D, file=None, x0=None,
                      dt: float | None = None) -> "Controller":
        return cls(A, B, C, D, x0=x0, file=file, dt=dt)

    # ── Stepping ─────────────────────────────────────────────────────────────

    def _discretize(self, dt: float) -> None:
        if self.native_dt is not None:
            if abs(dt - self.native_dt) > 1e-9 * max(abs(dt), 1e-30):
                raise ValueError(
                    f"discrete-native controller sampled at dt="
                    f"{self.native_dt}, cannot step at dt={dt}"
                )
            self._Ad, self._Bd = np.asarray(self.A), np.asarray(self.B)
            self._Cd, self._Dd = np.asarray(self.C), np.asarray(self.D)
        else:
            self._Ad, self._Bd, self._Cd, self._Dd = c2d_zoh(self, dt)
        self._dt = dt

    def step(self, y, dt: float) -> np.ndarray:
        """Advance one ZOH step: u = Cd x + Dd y; x <- Ad x + Bd y."""
        if self._dt != dt:
            self._discretize(dt)
        y = np.atleast_1d(np.asarray(y, dtype=np.float64))
        u = self._Cd @ self.x + self._Dd @ y
        self.x = self._Ad @ self.x + self._Bd @ y
        return u

    def reset(self) -> None:
        self.x = np.zeros(self.nstates)

    # ── Fused-rollout export ─────────────────────────────────────────────────

    def discrete(self, dt: float, dtype=None):
        """(Ad, Bd, Cd, Dd) numpy tuple for device-side fused stepping."""
        self._discretize(dt)  # honors discrete-native artifacts
        ad, bd, cd, dd = self._Ad, self._Bd, self._Cd, self._Dd
        if dtype is not None:
            ad, bd, cd, dd = (m.astype(dtype) for m in (ad, bd, cd, dd))
        return ad, bd, cd, dd

    # ── Algebra preserving Controller type + state concat ────────────────────

    def _overload(self, other, op: Callable) -> "Controller":
        # known fault kept from the JAX package (its controller.py:121): the
        # result drops ``native_dt``, so 2.0 * K of a discrete-native K is
        # ZOH-discretized a second time. To be fixed in both packages at once.
        k = op(other)
        k = Controller(k.A, k.B, k.C, k.D)
        if isinstance(other, Controller):
            k.x = np.concatenate([self.x, other.x])
        return k

    def __add__(self, other):
        return self._overload(other, super().__add__)

    def __radd__(self, other):
        return self._overload(other, super().__radd__)

    def __mul__(self, other):
        return self._overload(other, super().__mul__)

    def __rmul__(self, other):
        return self._overload(other, super().__rmul__)

    def inv(self) -> "Controller":
        k = ss_inv(self)
        return Controller(k.A, k.B, k.C, k.D)


def stack_controllers(controllers, dt: float, dtype=np.float32):
    """Stack N same-order controllers into batched (N, ...) discrete arrays.

    The stack is the ``k_mats`` of ``Stepper.rollout_closed_loop`` with a
    batched carry: one rollout steps N controllers and N plant copies.
    """
    mats = [k.discrete(dt, dtype=dtype) for k in controllers]
    ad = np.stack([m[0] for m in mats])
    bd = np.stack([m[1] for m in mats])
    cd = np.stack([m[2] for m in mats])
    dd = np.stack([m[3] for m in mats])
    return ad, bd, cd, dd
