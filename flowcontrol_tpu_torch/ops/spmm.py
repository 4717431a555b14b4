"""Kernel S: a sparse matrix applied to a batch of vectors in a fixed order.

:func:`csr_matmul` computes ``x @ a.T`` for a sparse CSR ``a`` (n_rows, n)
and a batch ``x`` (B, n): the batched step's mass apply (f32).
:func:`csr_residual` computes the refinement residual
``float32(b.double() - a @ x.double())`` for an f64 ``a`` and f32 ``b`` and
``x`` (B, n) in one launch. They stand for the JAX package's element-tensor
applies (``flowcontrol_tpu/core/stepper.py`` ``_apply``, XLA gathers and
products, no Pallas kernel). cuSPARSE's CSR × dense product, which torch's
``a @ x.T`` launches, sums with atomics: two calls on the same operands
differ in their last bits, so the batched step was not repeatable and its
CUDA graph could not be held to the eager step bit for bit. S
(``csrc/csr_spmm.cu``) sums each output in its row's CSR order, reading x
(B, n) and writing (B, n_rows) as the step holds them: one launch a call,
no layout copy. Its blocks walk the matrix's :class:`SpmmPlan`, built once
on the host from the sparsity pattern and attached to the matrix by
:func:`attach_plan`: :func:`plan_of` does it on the matrix's first batched
product (a single stream, which never runs S, builds none). It lives as
long as the matrix, so a CUDA graph of a launch keeps reading it; the
graphs' eager warm-up makes the first product before any capture, and a
first product reached during a capture raises. :func:`csr_matmul_rowwise` is
S's earlier row-wise kernel, kept as the reference order (the tiled kernel
gives its bits) for the ``cuda`` tests and ``chip_smoke.py``.

The wrappers take their plain versions (``(a @ x.T).T`` and the
residual's composition of it) for CPU tensors and launch the kernel for
CUDA tensors, or raise on what they do not take; they count their launches
in ``csr_matmul.launches`` and ``csr_residual.launches``.
"""

from __future__ import annotations

import ctypes
from dataclasses import dataclass

import numpy as np
import torch

from flowcontrol_tpu_torch.ops.cuda_build import CudaLibrary, counted

#: rows of one tile at most (csrc/csr_spmm.cu kTileRows)
TILE_ROWS = 64
#: distinct columns of x one tile stages at most (a row with more takes a
#: tile of its own). A block stages them for a slab of 64 right-hand sides
#: (csrc/csr_spmm.cu kSlab, 2 a lane): 128 x 65 x 4 bytes of f32, 33 KB
TILE_COLS = 128


def _declare(lib: ctypes.CDLL) -> None:
    p, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
    plan = [p, p, p, p, i32, i32, p]
    for name in ("csr_spmm_f32", "csr_spmm_f64"):
        fn = getattr(lib, name)
        fn.argtypes = plan + [p, i64, i64, p, i64, i32, p]
        fn.restype = i32
    lib.csr_residual_f32.argtypes = plan + [p, i64, i64, p, i64, i64, p, i64, i32, p]
    lib.csr_residual_f32.restype = i32
    for name in ("csr_spmm_rowwise_f32", "csr_spmm_rowwise_f64"):
        fn = getattr(lib, name)
        fn.argtypes = [p, p, p, i64, p, p, i32, p]
        fn.restype = i32
    lib.csr_spmm_tile_rows.argtypes = []
    lib.csr_spmm_tile_rows.restype = i32
    lib.csr_spmm_error_string.argtypes = [i32]
    lib.csr_spmm_error_string.restype = ctypes.c_char_p
    if lib.csr_spmm_tile_rows() != TILE_ROWS:
        raise RuntimeError(f"csrc/csr_spmm.cu tiles {lib.csr_spmm_tile_rows()} rows, "
                           f"ops/spmm.py plans {TILE_ROWS}")


#: S's shared library, built from csrc/csr_spmm.cu on first launch.
SPMM_KERNEL = CudaLibrary("csr_spmm", "csr_spmm.cu", _declare)


@dataclass(frozen=True)
class SpmmPlan:
    """S's tiles of one matrix: consecutive rows, at most ``TILE_ROWS`` of
    them, whose distinct columns number at most ``TILE_COLS``, or one row
    past it (a tile is cut between rows, never inside one, so each row's
    sum keeps its CSR order). ``tile_row0`` and ``col_off`` (tiles + 1):
    each tile's first row and the start of its sorted column list in ``cols``; ``indptr``
    (n_rows + 1): the row pointers, all int32; ``entries`` (nnz, 2) or
    (nnz, 4) int32, in CSR order: each nonzero's value (its float32 bits,
    or its float64's two words) and its column as an index into its tile's
    list (then a 0 word in float64), one 8- or 16-byte load in the
    kernel."""

    tile_row0: torch.Tensor
    col_off: torch.Tensor
    cols: torch.Tensor
    indptr: torch.Tensor
    entries: torch.Tensor
    max_cols: int  # the longest column list

    @property
    def n_tiles(self) -> int:
        return self.tile_row0.shape[0] - 1

    @property
    def staged_cols(self) -> int:
        """Columns staged per slab, summed over the tiles."""
        return self.cols.shape[0]

    @property
    def loc(self) -> torch.Tensor:
        """Each nonzero's index into its tile's column list."""
        return self.entries[:, 1 if self.entries.shape[1] == 2 else 2]

    @property
    def nbytes(self) -> int:
        """The plan's device bytes."""
        return sum(t.numel() * t.element_size()
                   for t in (self.tile_row0, self.col_off, self.cols, self.indptr, self.entries))

    @classmethod
    def build(cls, indptr, indices, values, device) -> "SpmmPlan":
        """The plan of the CSR matrix (``indptr``, ``indices``, ``values``:
        float32 or float64) on the host, its tensors on ``device``. A row
        with more than ``TILE_COLS`` distinct columns takes a tile of its
        own, and the plan's ``max_cols`` grows to it."""
        indptr = np.asarray(indptr, dtype=np.int64)
        indices = np.asarray(indices, dtype=np.int64)
        values = np.asarray(values)
        if values.dtype not in (np.float32, np.float64) or values.shape != indices.shape:
            raise TypeError(f"S plans float32 or float64 values, one a nonzero, got "
                            f"{values.dtype} {values.shape} for {indices.shape[0]} nonzeros")
        if indptr[-1] >= 2**31:
            raise ValueError(f"S plans int32 nonzeros, got {indptr[-1]}")
        n_rows = indptr.shape[0] - 1

        def columns(r0, r1):
            return np.unique(indices[indptr[r0]:indptr[r1]])

        row0, col_off, cols = [0], [0], []
        loc = np.empty(indices.shape[0], dtype=np.int32)
        r0 = 0
        while r0 < n_rows:
            r1 = min(r0 + TILE_ROWS, n_rows)
            c = columns(r0, r1)
            if c.size > TILE_COLS:
                # the column count grows with the rows: the most rows that fit
                ok, bad = r0, r1
                while bad - ok > 1:
                    mid = (ok + bad) // 2
                    if columns(r0, mid).size <= TILE_COLS:
                        ok = mid
                    else:
                        bad = mid
                r1 = max(ok, r0 + 1)  # a row past the budget alone takes a tile of its own
                c = columns(r0, r1)
            k0, k1 = indptr[r0], indptr[r1]
            loc[k0:k1] = np.searchsorted(c, indices[k0:k1])
            cols.append(c)
            row0.append(r1)
            col_off.append(col_off[-1] + c.size)
            r0 = r1
        words = values.view(np.int32).reshape(values.shape[0], -1)  # 1 or 2 words a value
        entries = np.zeros((values.shape[0], 2 * words.shape[1]), dtype=np.int32)
        entries[:, :words.shape[1]] = words
        entries[:, words.shape[1]] = loc

        def i32(a):
            return torch.as_tensor(np.asarray(a, dtype=np.int32), device=device)

        return cls(tile_row0=i32(row0), col_off=i32(col_off),
                   cols=i32(np.concatenate(cols) if cols else np.zeros(0)), indptr=i32(indptr),
                   entries=torch.as_tensor(entries, device=device),
                   max_cols=int(np.diff(col_off).max(initial=0)))


def attach_plan(a: torch.Tensor):
    """Build the plan of the sparse CSR ``a`` from its pattern and values
    and hold it on ``a`` as ``a.spmm_plan`` for ``a``'s lifetime. Returns
    ``a``."""
    a.spmm_plan = SpmmPlan.build(a.crow_indices().cpu().numpy(), a.col_indices().cpu().numpy(),
                                 a.values().cpu().numpy(), a.device)
    return a


def plan_of(a: torch.Tensor) -> SpmmPlan:
    """The tile plan of the sparse CSR ``a`` on CUDA, built and attached
    (:func:`attach_plan`) on the first call. The build copies the pattern
    to the host, which a CUDA graph cannot capture: during a capture a
    matrix without its plan raises."""
    plan = getattr(a, "spmm_plan", None)
    if plan is None:
        if torch.cuda.is_current_stream_capturing():
            raise RuntimeError("S builds a matrix's tile plan on its first batched product, "
                               "which must run before a CUDA graph captures one")
        plan = attach_plan(a).spmm_plan
    return plan


def csr_matmul_plain(a: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """``x @ a.T`` for x (B, n), plain torch (cuSPARSE's product on CUDA)."""
    return (a @ x.T).T.contiguous()


def csr_residual_plain(a: torch.Tensor, b: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """``(b.double() - x.double() @ a.T).to(b.dtype)``, plain torch."""
    return (b.double() - csr_matmul_plain(a, x.double())).to(b.dtype)


def _check(a: torch.Tensor, x: torch.Tensor, what: str) -> SpmmPlan:
    if a.layout != torch.sparse_csr:
        raise ValueError(f"S takes a sparse CSR matrix, got layout {a.layout}")
    if x.device != a.device:
        raise ValueError(f"{what} is on {x.device}, a on {a.device}")
    n = a.shape[1]
    if x.dim() != 2 or x.shape[1] != n:
        raise ValueError(f"{what} has shape {tuple(x.shape)}, needs (B, {n})")
    return plan_of(a)


def _launch(fn, plan: SpmmPlan, a: torch.Tensor, x: torch.Tensor, *rest) -> torch.Tensor:
    """Launch the tiled kernel ``fn`` over (B, n_rows) outputs of x's dtype:
    ``rest`` are the arguments between x's strides and the output's."""
    batch, n_rows = x.shape[0], a.shape[0]
    out = torch.empty((batch, n_rows), dtype=x.dtype, device=x.device)
    if batch == 0 or n_rows == 0:
        return out
    lib = SPMM_KERNEL.get()
    rc = getattr(lib, fn)(
        plan.tile_row0.data_ptr(), plan.col_off.data_ptr(), plan.cols.data_ptr(),
        plan.indptr.data_ptr(), plan.n_tiles, plan.max_cols, plan.entries.data_ptr(),
        x.data_ptr(), x.stride(0), x.stride(1), *rest, out.data_ptr(), n_rows, batch,
        torch.cuda.current_stream(x.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"S {fn} launch failed: {lib.csr_spmm_error_string(rc).decode()} "
                           f"(cudaError {rc})")
    return out


def _csr_matmul_cuda(a: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    if a.dtype not in (torch.float32, torch.float64) or x.dtype != a.dtype:
        raise TypeError(f"S takes float32 or float64 operands of one dtype, got a {a.dtype}, "
                        f"x {x.dtype}")
    plan = _check(a, x, "x")
    out = _launch("csr_spmm_f32" if a.dtype == torch.float32 else "csr_spmm_f64", plan, a, x)
    if out.numel():
        csr_matmul.launches += 1
    return out


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


def sparse_matvec(a: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """``a @ x`` over the last dimension of x (..., n) for a sparse CSR a:
    an SpMV for one vector, kernel S (``ops/spmm.py``, summed in a fixed
    order) for a batch."""
    if x.dim() == 1:
        return torch.mv(a, x)
    flat = x.reshape(-1, x.shape[-1])
    return csr_matmul(a, flat).reshape(x.shape[:-1] + (a.shape[0],))


def _csr_residual_cuda(a: torch.Tensor, b: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    if a.dtype != torch.float64 or x.dtype != torch.float32 or b.dtype != torch.float32:
        raise TypeError(f"S's residual takes a float64 matrix and float32 b and x, got a "
                        f"{a.dtype}, b {b.dtype}, x {x.dtype}")
    plan = _check(a, x, "x")
    if b.device != a.device or b.shape != (x.shape[0], a.shape[0]):
        raise ValueError(f"b has shape {tuple(b.shape)} on {b.device}, needs "
                         f"({x.shape[0]}, {a.shape[0]}) on {a.device}")
    out = _launch("csr_residual_f32", plan, a, x, b.data_ptr(), b.stride(0), b.stride(1))
    if out.numel():
        csr_residual.launches += 1
    return out


@counted
def csr_residual(a: torch.Tensor, b: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """S's refinement residual: ``float32(b.double() - x.double() @ a.T)``
    (B, n_rows) for an f64 sparse CSR ``a`` (n_rows, n), f32 x (B, n) and
    b (B, n_rows), in one launch, bitwise the composition with
    :func:`csr_matmul`. The kernel for CUDA tensors, the plain version
    (that composition) for CPU tensors."""
    if a.device.type == "cuda":
        return _csr_residual_cuda(a, b, x)
    if a.device.type == "cpu" and x.device.type == "cpu" and b.device.type == "cpu":
        return csr_residual_plain(a, b, x)
    raise ValueError(f"no S path for a on {a.device}, b on {b.device} and x on {x.device}")


def csr_matmul_rowwise(a: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """S's earlier row-wise kernel, the tiled kernel's reference order: x
    laid out dof-major (one copy), one thread per output summing its row in
    CSR order, and the result laid back (another copy). On CUDA only;
    nothing on the main path calls it."""
    if a.device.type != "cuda" or x.device != a.device:
        raise ValueError(f"the row-wise reference runs on CUDA, got a on {a.device}, x on "
                         f"{x.device}")
    if a.dtype not in (torch.float32, torch.float64) or x.dtype != a.dtype:
        raise TypeError(f"S takes float32 or float64 operands of one dtype, got a {a.dtype}, "
                        f"x {x.dtype}")
    n_rows, batch = a.shape[0], x.shape[0]
    x_t = x.T.contiguous()
    out_t = torch.empty((n_rows, batch), dtype=a.dtype, device=a.device)
    lib = SPMM_KERNEL.get()
    fn = lib.csr_spmm_rowwise_f32 if a.dtype == torch.float32 else lib.csr_spmm_rowwise_f64
    rc = fn(a.crow_indices().data_ptr(), a.col_indices().data_ptr(), a.values().data_ptr(),
            n_rows, x_t.data_ptr(), out_t.data_ptr(), batch,
            torch.cuda.current_stream(a.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"S csr_matmul_rowwise launch failed: "
                           f"{lib.csr_spmm_error_string(rc).decode()} (cudaError {rc})")
    return out_t.T.contiguous()
