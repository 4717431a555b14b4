"""Nonlinear convection N(u) = ∫ ((u·∇)u)·v dx: plain torch and kernel K1.

N(u) is the one u-dependent element pass of every time step (and of
``Stepper.init_carry``). Three pieces live here:

- :class:`NLTables`: the per-cell quadrature tables and the velocity gather
  table on one device, built once per stepper.
- :func:`nonlinear_convection_plain`: the plain torch version (the einsums
  of ``flowcontrol_tpu/fem/assembly.py:_nonlinear_contributions`` plus the
  gather-table assembly). The CPU path and the tests use it.
- :func:`nonlinear_convection`: the wrapper the stepper calls. For a CPU
  tensor it returns the plain version; for a CUDA tensor it launches the
  hand-written kernel ``csrc/nl_convection.cu`` (K1, the port of the TPU
  kernel ``flowcontrol_tpu/ops/pallas_nl.py:_nl_kernel``) or raises — it
  never falls back. ``nonlinear_convection.launches`` counts kernel
  launches, so a run can show that its steps went through K1.
"""

from __future__ import annotations

import ctypes
from dataclasses import dataclass

import numpy as np
import torch

from flowcontrol_tpu_torch.fem.assembly import (
    CellGeometry,
    build_gather_table,
    gather_assemble,
    velocity_cell_dofs,
)
from flowcontrol_tpu_torch.mesh.dofmap import TaylorHoodSpace
from flowcontrol_tpu_torch.ops.cuda_build import CudaLibrary


@dataclass
class NLTables:
    """Device tables of N(u) for one mesh.

    cell_vel_nodes (nc, 6) int32, dphi2 (nc, 7, 6, 2), wq (nc, 7) (includes
    detJ/2), phi2 (7, 6), gt_vel (n_dofs, kmax) int32: for each mixed dof
    the flat (cell, node, component) slots that assemble into it, padded
    with nc*12 (pressure rows are all padding).
    """

    cell_vel_nodes: torch.Tensor
    dphi2: torch.Tensor
    wq: torch.Tensor
    phi2: torch.Tensor
    gt_vel: torch.Tensor
    n_vnodes: int

    @classmethod
    def build(cls, geom: CellGeometry, space: TaylorHoodSpace,
              device: torch.device | str, dtype: torch.dtype) -> "NLTables":
        def f(a):
            return torch.as_tensor(np.ascontiguousarray(a), dtype=dtype, device=device)

        table = build_gather_table(velocity_cell_dofs(space), space.n_dofs)
        return cls(
            cell_vel_nodes=torch.as_tensor(
                np.ascontiguousarray(space.cell_vel_nodes, dtype=np.int32), device=device
            ),
            dphi2=f(geom.dphi2),
            wq=f(geom.wq),
            phi2=f(geom.phi2),
            gt_vel=torch.as_tensor(np.ascontiguousarray(table, dtype=np.int32), device=device),
            n_vnodes=space.n_vnodes,
        )

    @property
    def n_dofs(self) -> int:
        return self.gt_vel.shape[0]


def nonlinear_contributions(t: NLTables, u: torch.Tensor) -> torch.Tensor:
    """Per-element contributions r_e (..., nc*12), flattened (cell, node, comp)."""
    batch = u.shape[:-1]
    u_nodes = u[..., : 2 * t.n_vnodes].reshape(batch + (t.n_vnodes, 2))
    u_e = u_nodes[..., t.cell_vel_nodes.long(), :]  # (..., nc, 6, 2)
    u_q = torch.einsum("qn,...cnd->...cqd", t.phi2, u_e)
    g_q = torch.einsum("cqni,...cnd->...cqid", t.dphi2, u_e)  # ∂u_d/∂x_i
    conv_q = torch.einsum("...cqi,...cqid->...cqd", u_q, g_q)
    r_e = torch.einsum("cq,qa,...cqd->...cad", t.wq, t.phi2, conv_q)
    return r_e.reshape(batch + (-1,))


def nonlinear_convection_plain(t: NLTables, u: torch.Tensor) -> torch.Tensor:
    """N(u) as a mixed vector (..., n_dofs), plain torch, any device/dtype."""
    return gather_assemble(nonlinear_contributions(t, u), t.gt_vel)


def _declare(lib: ctypes.CDLL) -> None:
    p, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
    lib.nl_convection_f32.argtypes = [p, i64, p, p, p, p, i32, p, i32, p, p, i32, p]
    lib.nl_convection_f32.restype = i32
    lib.nl_error_string.argtypes = [i32]
    lib.nl_error_string.restype = ctypes.c_char_p


#: K1's shared library, built from csrc/nl_convection.cu on first launch.
NL_KERNEL = CudaLibrary("nl_convection", "nl_convection.cu", _declare)


def _check_table(name: str, x: torch.Tensor, dtype: torch.dtype, device: torch.device):
    if x.device != device or x.dtype != dtype or not x.is_contiguous():
        raise ValueError(
            f"K1 needs {name} as a contiguous {dtype} tensor on {device}, "
            f"got {x.dtype} on {x.device} (contiguous={x.is_contiguous()})"
        )


def _nonlinear_convection_cuda(t: NLTables, u: torch.Tensor) -> torch.Tensor:
    n = t.n_dofs
    if u.dtype != torch.float32:
        raise TypeError(f"K1 takes float32 tensors only, got {u.dtype}")
    if u.shape[-1] != n:
        raise ValueError(f"u has {u.shape[-1]} dofs, the tables {n}")
    dev = u.device
    for name, x, dt in (
        ("cell_vel_nodes", t.cell_vel_nodes, torch.int32),
        ("dphi2", t.dphi2, torch.float32),
        ("wq", t.wq, torch.float32),
        ("phi2", t.phi2, torch.float32),
        ("gt_vel", t.gt_vel, torch.int32),
    ):
        _check_table(name, x, dt, dev)
    nc = t.cell_vel_nodes.shape[0]
    u2 = u.reshape(-1, n).contiguous()
    b = u2.shape[0]
    r_e = torch.empty((b, nc, 12), dtype=torch.float32, device=dev)
    out = torch.empty((b, n), dtype=torch.float32, device=dev)
    lib = NL_KERNEL.get()
    stream = torch.cuda.current_stream(dev).cuda_stream
    rc = lib.nl_convection_f32(
        u2.data_ptr(), n, t.cell_vel_nodes.data_ptr(), t.dphi2.data_ptr(),
        t.wq.data_ptr(), t.phi2.data_ptr(), nc, t.gt_vel.data_ptr(),
        t.gt_vel.shape[1], r_e.data_ptr(), out.data_ptr(), b, stream,
    )
    if rc != 0:
        raise RuntimeError(
            f"K1 launch failed: {lib.nl_error_string(rc).decode()} (cudaError {rc})"
        )
    nonlinear_convection.launches += 1
    return out.reshape(u.shape)


def nonlinear_convection(t: NLTables, u: torch.Tensor) -> torch.Tensor:
    """N(u) for u (..., n_dofs): kernel K1 on CUDA, the plain version on CPU.

    The choice follows the tensor's device only. A CUDA tensor must be
    float32 and its tables must sit on the same card; anything else raises.
    """
    if u.device.type == "cuda":
        return _nonlinear_convection_cuda(t, u)
    if u.device.type == "cpu":
        return nonlinear_convection_plain(t, u)
    raise ValueError(f"no N(u) path for device type {u.device.type!r}")


nonlinear_convection.launches = 0
