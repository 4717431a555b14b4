"""Kernel K3: the fused blocked-LU forward/back substitution.

:func:`block_lu_solve_fused` solves ``A x = b`` from a ``BlockLU`` factor
``(lu, dinv)`` (``solvers/block_lu.py``) with the whole substitution, the
products with ``dinv`` included, in one hand-written CUDA kernel source,
``csrc/block_trisolve.cu``. The port of the TPU kernel
``flowcontrol_tpu/ops/pallas_trisolve.py`` (``pallas_block_lu_solve``), with
its signature. Its plain torch version is
``solvers.block_lu.block_lu_solve``.

The wrapper takes the plain version for CPU tensors and launches the kernel
for CUDA tensors, or raises on what the kernel does not take (float32 only,
one device, contiguous factors, a block size that is a multiple of 16); it
never falls back. ``block_lu_solve_fused.launches`` counts kernel launches:
the C entry point makes all of a solve's block-row launches itself,
:func:`launches_per_solve` of them, and the wrapper adds that many where it
calls it.
"""

from __future__ import annotations

import ctypes

import torch

from flowcontrol_tpu_torch.ops.cuda_build import CudaLibrary
from flowcontrol_tpu_torch.solvers.block_lu import block_lu_solve

#: the single right-hand-side kernel stages one block row of the vector in
#: static-limit shared memory (48 KB of float32)
K3_MAX_BS = 48 * 1024 // 4


def _declare(lib: ctypes.CDLL) -> None:
    p, i32 = ctypes.c_void_p, ctypes.c_int
    lib.block_trisolve_f32.argtypes = [p, p, p, p, i32, i32, i32, p]
    lib.block_trisolve_f32.restype = i32
    lib.block_trisolve_error_string.argtypes = [i32]
    lib.block_trisolve_error_string.restype = ctypes.c_char_p


#: K3's shared library, built from csrc/block_trisolve.cu on first launch.
TRISOLVE_KERNEL = CudaLibrary("block_trisolve", "block_trisolve.cu", _declare)


def launches_per_solve(nb: int) -> int:
    """Kernel launches of one K3 solve over ``nb`` block rows: nb - 1 forward
    updates, nb products with ``dinv`` and nb - 1 backward updates."""
    return 3 * nb - 2


def _solve_cuda(lu, dinv, b, bs: int, n: int) -> torch.Tensor:
    dev = lu.device
    n_pad = lu.shape[0]
    for name, x in (("lu", lu), ("dinv", dinv), ("b", b)):
        if x.dtype != torch.float32:
            raise TypeError(f"kernel K3 takes float32 only, got {name} {x.dtype} on {x.device}")
        if x.device != dev:
            raise ValueError(f"{name} is on {x.device}, the factor on {dev}")
    if bs % 16 or not 0 < bs <= K3_MAX_BS:
        raise ValueError(f"K3 needs a block size that is a multiple of 16 up to {K3_MAX_BS}, "
                         f"got {bs}")
    nb = n_pad // bs
    if lu.shape != (n_pad, n_pad) or n_pad % bs or dinv.shape != (nb, bs, bs):
        raise ValueError(f"factor shapes lu {tuple(lu.shape)}, dinv {tuple(dinv.shape)} do not "
                         f"form a blocked LU with bs={bs}")
    if not (lu.is_contiguous() and dinv.is_contiguous()):
        raise ValueError("K3 needs contiguous lu (n_pad, n_pad) and dinv (nb, bs, bs)")
    if b.shape[-1] != n or not 0 < n <= n_pad:
        raise ValueError(f"b has shape {tuple(b.shape)}, needs (..., {n}) with n <= {n_pad}")
    batch = b.shape[:-1]
    rows = b.reshape(-1, n)
    nrhs = rows.shape[0]
    if nrhs == 0:
        return torch.empty_like(b)
    # the kernel's panel layout: (n_pad, nrhs), one row per unknown; the
    # padding rows stay zero (the factor carries the identity there)
    x = torch.zeros((n_pad, nrhs), dtype=torch.float32, device=dev)
    x[:n] = rows.T
    out = torch.empty_like(x)
    lib = TRISOLVE_KERNEL.get()
    rc = lib.block_trisolve_f32(
        lu.data_ptr(), dinv.data_ptr(), x.data_ptr(), out.data_ptr(), n_pad, bs, nrhs,
        torch.cuda.current_stream(dev).cuda_stream,
    )
    if rc != 0:
        msg = lib.block_trisolve_error_string(rc).decode()
        raise RuntimeError(f"K3 block_lu_solve_fused launch failed: {msg} (cudaError {rc})")
    block_lu_solve_fused.launches += launches_per_solve(nb)
    return out[:n].T.contiguous().reshape(batch + (n,))


def block_lu_solve_fused(factors, b: torch.Tensor, bs: int, n: int) -> torch.Tensor:
    """K3: solve ``A x = b`` from BlockLU factors ``(lu, dinv)``; b is (..., n).

    The kernel for CUDA tensors, :func:`block_lu_solve` for CPU tensors.
    """
    lu, dinv = factors
    if lu.device.type == "cuda":
        return _solve_cuda(lu, dinv, b, bs, n)
    if lu.device.type == "cpu" and b.device.type == "cpu":
        return block_lu_solve(factors, b, bs=bs, n=n)
    raise ValueError(f"no K3 path for a factor on {lu.device} and b on {b.device}")


block_lu_solve_fused.launches = 0
