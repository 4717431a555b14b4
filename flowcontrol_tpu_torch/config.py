"""Numerical configuration: device, dtype and memory-budget policy.

Precision policy (the counterpart of ``flowcontrol_tpu/config.py``)
-------------------------------------------------------------------
Host-side setup (mesh, DOF maps, global sparse assembly, steady-state
Newton) always runs in float64 numpy/scipy: it is one-time work and
accuracy matters.

The device hot loop (time stepping) runs on ONE explicit ``torch.device``
(``ParamSolver.device``), the card unless the caller asks for the CPU;
nothing here moves work elsewhere, and asking for a card where there is none
raises (:func:`require_device`). Its dtype is float64 on the CPU, where the
tests hold the port against the reference to round-off, and float32 on CUDA;
``ParamSolver.precision`` overrides either.

Matmuls on CUDA stay in full float32: TF32 keeps a 10-bit mantissa, the
same truncation that measured an N(u) error of 5e-3 under bf16 in the
reference (``flowcontrol_tpu/ops/cellwindows.py:47-53``). Importing this
module pins the torch flags that would otherwise allow it; that is its only
side effect.
"""

from __future__ import annotations

import os

import numpy as np
import torch

#: numpy dtype used for all host-side (setup-time) arithmetic.
HOST_DTYPE = np.float64

#: integer dtype for DOF maps / connectivity.
INDEX_DTYPE = np.int32

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
torch.set_float32_matmul_precision("highest")


def device_dtype(device: torch.device | str, precision: str = "auto") -> torch.dtype:
    """Hot-loop dtype: 'f32' / 'f64' explicit, 'auto' = f32 on CUDA, else f64."""
    if precision == "f32":
        return torch.float32
    if precision == "f64":
        return torch.float64
    if precision != "auto":
        raise ValueError(f"precision must be 'auto', 'f32' or 'f64', got {precision!r}")
    return torch.float32 if torch.device(device).type == "cuda" else torch.float64


def require_device(device: torch.device | str) -> torch.device:
    """``device`` as a ``torch.device``; raises ``RuntimeError`` for a CUDA
    device where torch sees no card (it never falls back to the CPU)."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"the hot loop runs on {device} (the default device), but torch sees "
            "no CUDA device here; pass device='cpu' to run on the CPU"
        )
    return device


def device_memory_budget_bytes(device: torch.device | str) -> int:
    """Usable memory for new solver state on ``device``. For a CUDA device
    0.9 x what the card has free now (``torch.cuda.mem_get_info``) plus the
    blocks PyTorch's caching allocator holds unused (reserved less
    allocated: the allocator hands them back before it fails an
    allocation), so that what other solvers hold counts against it and what
    dropped ones left in the cache does not; for the CPU 0.9 x the host's
    RAM (the counterpart of ``device_hbm_budget_bytes``, which counts the
    device's total)."""
    device = torch.device(device)
    if device.type == "cuda":
        free, _ = torch.cuda.mem_get_info(device)
        cached = torch.cuda.memory_reserved(device) - torch.cuda.memory_allocated(device)
        return int((free + cached) * 0.9)
    if device.type == "cpu":
        return int(os.sysconf("SC_PAGE_SIZE") * os.sysconf("SC_PHYS_PAGES") * 0.9)
    raise ValueError(f"no memory budget rule for device type {device.type!r}")
