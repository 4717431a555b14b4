"""Kernel S: a sparse matrix applied to a batch of vectors in a fixed order.

:func:`csr_matmul` computes ``x @ a.T`` for a sparse CSR ``a`` (n_rows, n)
and a batch ``x`` (B, n): the batched step's mass apply (f32) and its
refinement residual's operator (f64). It stands for the JAX package's
element-tensor applies (``flowcontrol_tpu/core/stepper.py`` ``_apply``,
XLA gathers and products, no Pallas kernel). cuSPARSE's CSR × dense
product, which torch's ``a @ x.T`` launches, sums with atomics: two calls
on the same operands differ in their last bits, so the batched step was not
repeatable and its CUDA graph could not be held to the eager step bit for
bit. S (``csrc/csr_spmm.cu``) sums each output in its row's CSR order. The
wrapper lays the batch out dof-major (``x.T``, one copy) for the kernel and
back. A single vector keeps ``torch.mv`` (cuSPARSE's SpMV, repeatable).

The wrapper takes its plain version, ``(a @ x.T).T``, for CPU tensors and
launches the kernel for CUDA tensors, or raises on what it does not take; it
counts its launches in ``csr_matmul.launches``.
"""

from __future__ import annotations

import ctypes

import torch

from flowcontrol_tpu_torch.ops.cuda_build import CudaLibrary, counted


def _declare(lib: ctypes.CDLL) -> None:
    p, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
    for name in ("csr_spmm_f32", "csr_spmm_f64"):
        fn = getattr(lib, name)
        fn.argtypes = [p, p, p, i64, p, p, i32, p]
        fn.restype = i32
    lib.csr_spmm_error_string.argtypes = [i32]
    lib.csr_spmm_error_string.restype = ctypes.c_char_p


#: S's shared library, built from csrc/csr_spmm.cu on first launch.
SPMM_KERNEL = CudaLibrary("csr_spmm", "csr_spmm.cu", _declare)


def csr_matmul_plain(a: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """``x @ a.T`` for x (B, n), plain torch (cuSPARSE's product on CUDA)."""
    return (a @ x.T).T.contiguous()


def _csr_matmul_cuda(a: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    dev = a.device
    if a.layout != torch.sparse_csr:
        raise ValueError(f"S takes a sparse CSR matrix, got layout {a.layout}")
    if a.dtype not in (torch.float32, torch.float64) or x.dtype != a.dtype:
        raise TypeError(f"S takes float32 or float64 operands of one dtype, got a {a.dtype}, "
                        f"x {x.dtype}")
    if x.device != dev:
        raise ValueError(f"x is on {x.device}, a on {dev}")
    n_rows, n = a.shape
    if x.dim() != 2 or x.shape[1] != n:
        raise ValueError(f"x has shape {tuple(x.shape)}, needs (B, {n})")
    indptr, indices, val = a.crow_indices(), a.col_indices(), a.values()
    if indptr.dtype != torch.int64 or indices.dtype != torch.int64:
        raise TypeError(f"S takes int64 CSR indices, got {indptr.dtype}, {indices.dtype}")
    batch = x.shape[0]
    x_t = x.T.contiguous()
    out_t = torch.empty((n_rows, batch), dtype=a.dtype, device=dev)
    lib = SPMM_KERNEL.get()
    fn = lib.csr_spmm_f32 if a.dtype == torch.float32 else lib.csr_spmm_f64
    rc = fn(indptr.data_ptr(), indices.data_ptr(), val.data_ptr(), n_rows, x_t.data_ptr(),
            out_t.data_ptr(), batch, torch.cuda.current_stream(dev).cuda_stream)
    if rc != 0:
        msg = lib.csr_spmm_error_string(rc).decode()
        raise RuntimeError(f"S csr_matmul launch failed: {msg} (cudaError {rc})")
    csr_matmul.launches += 1
    return out_t.T.contiguous()


@counted
def csr_matmul(a: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """S: ``x @ a.T`` (B, n_rows) for a sparse CSR ``a`` (n_rows, n) and x
    (B, n). The kernel for CUDA tensors, the plain version for CPU
    tensors."""
    if a.device.type == "cuda":
        return _csr_matmul_cuda(a, x)
    if a.device.type == "cpu" and x.device.type == "cpu":
        return csr_matmul_plain(a, x)
    raise ValueError(f"no S path for a on {a.device} and x on {x.device}")
