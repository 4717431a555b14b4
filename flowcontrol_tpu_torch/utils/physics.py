"""Physics utilities: the divergence-free initial perturbation.

Transcribed from ``flowcontrol_tpu/utils/physics.py`` (ref:
src/utils/physics.py). The sympy-differentiated C-coded Gaussian stream
function (ref: physics.py:32-56) becomes closed-form numpy — the
derivatives of ψ = 0.25·exp(-½r²/σ²) are analytic. The other helpers of
that module (vorticity, divergence, stress) are not on the time-stepping
path and are not ported yet.
"""

from __future__ import annotations

import numpy as np


def get_div0_u_callable(xloc: float, yloc: float, size: float):
    """Divergence-free Gaussian perturbation u = (∂ψ/∂y, -∂ψ/∂x).

    ψ = 0.25·exp(-½ r²/σ²) with r² = (x-x0)² + (y-y0)²; peak |u| scaling is
    applied by the caller via ParamIC.amplitude (ref: physics.py:32-56).
    Returns a vectorized callable (n, 2) -> (n, 2).
    """
    if size <= 0:
        return lambda x: np.zeros_like(np.asarray(x))

    s2 = size**2

    def u(x):
        x = np.asarray(x)
        dx = x[:, 0] - xloc
        dy = x[:, 1] - yloc
        psi_fac = 0.25 * np.exp(-0.5 * (dx**2 + dy**2) / s2)
        dpsi_dx = -dx / s2 * psi_fac
        dpsi_dy = -dy / s2 * psi_fac
        return np.stack([dpsi_dy, -dpsi_dx], axis=1)

    return u
