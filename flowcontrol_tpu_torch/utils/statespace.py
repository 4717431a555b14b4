"""Minimal continuous-time LTI state-space algebra (numpy).

Self-contained replacement for the subset of python-control the reference
relies on (ref: src/flowcontrol/controller.py:22 subclasses
control.StateSpace; src/utils/lticontrol.py uses ss/c2d/norms). Dense and
small: host numpy is the right tool. A numpy transcription of
``flowcontrol_tpu/utils/statespace.py``; the fused closed-loop stepping on
the device takes the discrete matrices from
``flowcontrol_tpu_torch.core.controller``.
"""

from __future__ import annotations

import numpy as np
import scipy.linalg as sla


def _as2d(m, rows=None, cols=None):
    m = np.atleast_2d(np.asarray(m, dtype=np.float64))
    if rows is not None and m.shape == (1, 1) and rows * cols > 1:
        m = np.broadcast_to(m, (rows, cols)).copy()
    return m


class StateSpace:
    """Continuous-time LTI system dx = Ax + Bu, y = Cx + Du."""

    def __init__(self, A, B, C, D=None):
        self.A = _as2d(A)
        self.B = _as2d(B)
        if self.B.shape[0] != self.A.shape[0] and self.B.shape[1] == self.A.shape[0]:
            self.B = self.B.T
        self.C = _as2d(C)
        if self.C.shape[1] != self.A.shape[0] and self.C.shape[0] == self.A.shape[0]:
            self.C = self.C.T
        n, m, p = self.A.shape[0], self.B.shape[1], self.C.shape[0]
        self.D = _as2d(D if D is not None else np.zeros((p, m)), p, m)
        if self.D.shape != (p, m):
            self.D = np.broadcast_to(self.D, (p, m)).copy()
        assert self.A.shape == (n, n)
        assert self.B.shape == (n, m)
        assert self.C.shape == (p, n)

    # ── Shapes ───────────────────────────────────────────────────────────────

    @property
    def nstates(self) -> int:
        return self.A.shape[0]

    @property
    def ninputs(self) -> int:
        return self.B.shape[1]

    @property
    def noutputs(self) -> int:
        return self.C.shape[0]

    def __repr__(self):
        return (
            f"{type(self).__name__}(n={self.nstates}, "
            f"inputs={self.ninputs}, outputs={self.noutputs})"
        )

    # ── Algebra (python-control semantics) ───────────────────────────────────

    def __add__(self, other):
        other = _coerce(other, self)
        A = sla.block_diag(self.A, other.A)
        B = np.vstack([self.B, other.B])
        C = np.hstack([self.C, other.C])
        D = self.D + other.D
        return type(self)(A, B, C, D) if _same_sig(self, other) else StateSpace(A, B, C, D)

    def __radd__(self, other):
        return self.__add__(other)

    def __neg__(self):
        return type(self)(self.A, self.B, -self.C, -self.D)

    def __sub__(self, other):
        other = _coerce(other, self)
        return self.__add__(-other)

    def __mul__(self, other):
        """Series: (self * other)(u) = self(other(u))."""
        if np.isscalar(other):
            return type(self)(self.A, self.B * other, self.C, self.D * other)
        other = _coerce(other, self)
        n1, n2 = self.nstates, other.nstates
        A = np.block(
            [
                [self.A, self.B @ other.C],
                [np.zeros((n2, n1)), other.A],
            ]
        )
        B = np.vstack([self.B @ other.D, other.B])
        C = np.hstack([self.C, self.D @ other.C])
        D = self.D @ other.D
        return StateSpace(A, B, C, D)

    def __rmul__(self, other):
        if np.isscalar(other):
            return type(self)(self.A, self.B, other * self.C, other * self.D)
        return _coerce(other, self).__mul__(self)

    # ── Evaluation ───────────────────────────────────────────────────────────

    def frequency_response(self, w):
        """H(jw) for an array of frequencies. Returns (nw, p, m) complex."""
        w = np.atleast_1d(np.asarray(w, dtype=np.float64))
        n = self.nstates
        out = np.empty((len(w), self.noutputs, self.ninputs), dtype=np.complex128)
        for k, wk in enumerate(w):
            out[k] = self.C @ np.linalg.solve(
                1j * wk * np.eye(n) - self.A, self.B
            ) + self.D
        return out

    def poles(self):
        return np.linalg.eigvals(self.A)

    def dcgain(self):
        return self.D - self.C @ np.linalg.solve(self.A, self.B)

    def transpose(self):
        """Dual system (A^T, C^T, B^T, D^T)."""
        return StateSpace(self.A.T, self.C.T, self.B.T, self.D.T)

    def feedback(self, other=None, sign=-1):
        """Closed loop of self with feedback ``other`` (default unity)."""
        if other is None:
            other = StateSpace(
                np.zeros((0, 0)),
                np.zeros((0, self.noutputs)),
                np.zeros((self.ninputs, 0)),
                np.eye(self.ninputs, self.noutputs),
            )
        other = _coerce(other, self)
        # standard LFT formulas with u = r + sign * other(y)
        d1, d2 = self.D, other.D
        p1 = self.noutputs
        f = np.eye(p1) - sign * d1 @ d2
        finv = np.linalg.inv(f)
        a = np.block(
            [
                [
                    self.A + sign * self.B @ d2 @ finv @ self.C,
                    sign * self.B @ (other.C + sign * d2 @ finv @ d1 @ other.C),
                ],
                [
                    other.B @ finv @ self.C,
                    other.A + sign * other.B @ finv @ d1 @ other.C,
                ],
            ]
        )
        b = np.vstack(
            [self.B + sign * self.B @ d2 @ finv @ d1, other.B @ finv @ d1]
        )
        c = np.hstack([finv @ self.C, sign * finv @ d1 @ other.C])
        d = finv @ d1
        return StateSpace(a, b, c, d)


def _same_sig(a, b):
    return a.ninputs == b.ninputs and a.noutputs == b.noutputs


def _coerce(other, like: StateSpace) -> StateSpace:
    if isinstance(other, StateSpace):
        return other
    if np.isscalar(other) or isinstance(other, np.ndarray):
        d = np.atleast_2d(np.asarray(other, dtype=np.float64))
        if d.shape == (1, 1):
            d = d[0, 0] * np.eye(like.noutputs, like.ninputs)
        n = 0
        return StateSpace(
            np.zeros((n, n)), np.zeros((n, d.shape[1])), np.zeros((d.shape[0], n)), d
        )
    raise TypeError(f"cannot coerce {type(other)} to StateSpace")


def ss(A, B, C, D=None) -> StateSpace:
    return StateSpace(A, B, C, D)


def c2d_zoh(sys: StateSpace, dt: float):
    """Zero-order-hold discretization; returns (Ad, Bd, C, D).

    Uses the augmented-matrix exponential so singular A is handled exactly
    (matches control.c2d(method='zoh'), ref: controller.py:129).
    """
    n, m = sys.nstates, sys.ninputs
    if n == 0:
        return sys.A.copy(), sys.B.copy(), sys.C.copy(), sys.D.copy()
    aug = np.zeros((n + m, n + m))
    aug[:n, :n] = sys.A
    aug[:n, n:] = sys.B
    em = sla.expm(aug * dt)
    return em[:n, :n], em[:n, n:], sys.C.copy(), sys.D.copy()


def ss_inv(sys: StateSpace) -> StateSpace:
    """Inverse system (requires invertible D) — ref: lticontrol ss_inv."""
    dinv = np.linalg.inv(sys.D)
    return StateSpace(
        sys.A - sys.B @ dinv @ sys.C,
        sys.B @ dinv,
        -dinv @ sys.C,
        dinv,
    )
