"""The multifrontal sweep's two kernels: K2 (stage matvec) and P1 (inbox
gather-sum), each with its plain torch version.

- :func:`stack_matvec`: ``out[..., m, p] = Σ_q a[m, p, q] · v[..., m, q]``,
  one stage's factor stack against its vectors. The port of the TPU kernel
  K2 (``flowcontrol_tpu/ops/pallas_mf_matvec.py``: ``_mv_kernel``), which
  the JAX sweep runs as ``einsum("mpq,...mq->...mp")``. Up to
  :data:`K2_NARROW_MAX` right-hand sides take the narrow instance (a
  warp per row, v in shared memory); wider batches a tiled f32 product
  per node that reads each tile of ``a`` once per 64 right-hand sides.
- :func:`gather_sum_sub`: ``out[..., j] = xe[..., j] − Σ_k buf[..., t[k, j]]``,
  one inbox segment of the forward sweep. The port of the TPU probe P1
  (``tools/pallas_gather_probe.py``: ``take_2d_table``), which is the JAX
  sweep's ``_gather_sum0`` followed by the subtraction.

Both live in ``csrc/mf_sweep.cu``. Each wrapper takes its plain version for
CPU tensors and launches its kernel for CUDA tensors, or raises on what the
kernel does not take (float32 only, one device, the layouts below); it never
falls back. ``stack_matvec.launches`` and ``gather_sum_sub.launches`` count
kernel launches, so a run can show that its solves went through them.
"""

from __future__ import annotations

import ctypes

import torch

from flowcontrol_tpu_torch.ops.cuda_build import CudaLibrary, counted

#: largest q the narrow K2 instance (at most K2_NARROW_MAX right-hand
#: sides) stages in shared memory for 8 right-hand sides (227 KB per block
#: on Hopper); the wide instance takes any q
K2_MAX_Q = (227 * 1024) // (8 * 4)
#: most right-hand sides the narrow K2 instance takes; wider batches go to
#: the tiled product (csrc/mf_sweep.cu: stack_matmul_kernel)
K2_NARROW_MAX = 8


def _declare(lib: ctypes.CDLL) -> None:
    p, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
    lib.mf_stack_matvec_f32.argtypes = [p, i32, i32, i32, p, i64, p, i64, i32, p]
    lib.mf_stack_matvec_f32.restype = i32
    lib.mf_gather_sum_sub_f32.argtypes = [p, i64, p, i32, i32, p, i64, p, i64, i32, p]
    lib.mf_gather_sum_sub_f32.restype = i32
    lib.mf_error_string.argtypes = [i32]
    lib.mf_error_string.restype = ctypes.c_char_p


#: K2's and P1's shared library, built from csrc/mf_sweep.cu on first launch.
MF_KERNELS = CudaLibrary("mf_sweep", "mf_sweep.cu", _declare)


def _raise_on(rc: int, what: str) -> None:
    if rc != 0:
        msg = MF_KERNELS.get().mf_error_string(rc).decode()
        raise RuntimeError(f"{what} launch failed: {msg} (cudaError {rc})")


def _as_rows(x: torch.Tensor, inner: tuple, name: str) -> tuple[int, int]:
    """(batch, batch stride) of ``x`` viewed as (B, *inner) with the inner
    dims contiguous and one stride between batch rows."""
    size = 1
    for d in inner:
        size *= d
    if tuple(x.shape[x.dim() - len(inner):]) != inner:
        raise ValueError(f"{name} has shape {tuple(x.shape)}, needs (..., {inner})")
    stride = 1
    for k in range(1, len(inner) + 1):
        d = inner[-k]
        if d > 1 and x.stride(-k) != stride:  # a size-1 dim's stride is never used
            raise ValueError(f"{name} needs contiguous trailing dims {inner}, strides {x.stride()}")
        stride *= d
    lead = x.shape[: x.dim() - len(inner)]
    if len(lead) > 1:
        raise ValueError(f"{name} takes at most one batch dim, got shape {tuple(x.shape)}")
    batch = lead[0] if lead else 1
    bstride = x.stride(0) if lead else size
    return int(batch), int(bstride)


def _check_cuda(name: str, x: torch.Tensor, device: torch.device, dtype: torch.dtype):
    if x.device != device or x.dtype != dtype:
        raise ValueError(f"{name} must be {dtype} on {device}, got {x.dtype} on {x.device}")


# ── K2: stage matvec ─────────────────────────────────────────────────────────


def stack_matvec_plain(a: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """``out[..., m, p] = Σ_q a[m, p, q] v[..., m, q]``, plain torch."""
    return torch.einsum("mpq,...mq->...mp", a, v)


def _stack_matvec_cuda(a, v, out):
    m, p, q = a.shape
    dev = a.device
    _check_cuda("a", a, dev, torch.float32)
    _check_cuda("v", v, dev, torch.float32)
    if not a.is_contiguous():
        raise ValueError("K2 needs a contiguous factor stack a (m, p, q)")
    if m > 65535:
        raise ValueError(f"K2 launches one grid row per stack node (<= 65535), got m={m}")
    batch, v_bs = _as_rows(v, (m, q), "v")
    if batch <= K2_NARROW_MAX and q > K2_MAX_Q:
        raise ValueError(f"K2 stages q <= {K2_MAX_Q} values in shared memory for up to "
                         f"{K2_NARROW_MAX} right-hand sides, got q={q}")
    if out is None:
        out = torch.empty(v.shape[:-1] + (p,), dtype=torch.float32, device=dev)
    _check_cuda("out", out, dev, torch.float32)
    o_batch, o_bs = _as_rows(out, (m, p), "out")
    if o_batch != batch or out.dim() != v.dim():
        raise ValueError(f"out shape {tuple(out.shape)} does not match v {tuple(v.shape)}")
    if out.numel() == 0:
        return out
    if q == 0:
        return out.zero_()
    lib = MF_KERNELS.get()
    rc = lib.mf_stack_matvec_f32(
        a.data_ptr(), m, p, q, v.data_ptr(), v_bs, out.data_ptr(), o_bs, batch,
        torch.cuda.current_stream(dev).cuda_stream,
    )
    _raise_on(rc, "K2 stack_matvec")
    stack_matvec.launches += 1
    return out


@counted
def stack_matvec(a: torch.Tensor, v: torch.Tensor, out: torch.Tensor | None = None):
    """K2: ``out[..., m, p] = Σ_q a[m, p, q] v[..., m, q]``.

    ``a`` is one stage's stack (m, p, q); ``v`` is (m, q) or (B, m, q) with
    contiguous (m, q) rows. ``out``, when given, receives the result (it may
    be a strided view, e.g. a slice of the contribution buffer, but must not
    overlap ``v``). The kernel for CUDA tensors, the plain version for CPU
    tensors.
    """
    if a.device.type == "cuda":
        return _stack_matvec_cuda(a, v, out)
    if a.device.type == "cpu" and v.device.type == "cpu":
        r = stack_matvec_plain(a, v)
        return r if out is None else out.copy_(r)
    raise ValueError(f"no K2 path for a on {a.device} and v on {v.device}")


# ── P1: inbox gather-sum ─────────────────────────────────────────────────────


def gather_sum_sub_plain(buf: torch.Tensor, t: torch.Tensor, xe: torch.Tensor) -> torch.Tensor:
    """``xe[..., j] − Σ_k buf[..., t[k, j]]``, plain torch."""
    return xe - buf[..., t].sum(dim=-2)


def _gather_sum_sub_cuda(buf, t, xe, out):
    kmax, w = t.shape
    dev = buf.device
    _check_cuda("buf", buf, dev, torch.float32)
    _check_cuda("xe", xe, dev, torch.float32)
    _check_cuda("t", t, dev, torch.int32)
    if not t.is_contiguous():
        raise ValueError("P1 needs a contiguous table t (kmax, w)")
    batch, x_bs = _as_rows(xe, (w,), "xe")
    b_batch, b_bs = _as_rows(buf, (buf.shape[-1],), "buf")
    if b_batch != batch or buf.dim() != xe.dim():
        raise ValueError(f"buf shape {tuple(buf.shape)} does not match xe {tuple(xe.shape)}")
    if out is None:
        out = torch.empty(xe.shape, dtype=torch.float32, device=dev)
    _check_cuda("out", out, dev, torch.float32)
    o_batch, o_bs = _as_rows(out, (w,), "out")
    if o_batch != batch or out.dim() != xe.dim():
        raise ValueError(f"out shape {tuple(out.shape)} does not match xe {tuple(xe.shape)}")
    if out.numel() == 0:
        return out
    lib = MF_KERNELS.get()
    rc = lib.mf_gather_sum_sub_f32(
        buf.data_ptr(), b_bs, t.data_ptr(), kmax, w, xe.data_ptr(), x_bs,
        out.data_ptr(), o_bs, batch, torch.cuda.current_stream(dev).cuda_stream,
    )
    _raise_on(rc, "P1 gather_sum_sub")
    gather_sum_sub.launches += 1
    return out


@counted
def gather_sum_sub(buf: torch.Tensor, t: torch.Tensor, xe: torch.Tensor,
                   out: torch.Tensor | None = None):
    """P1: ``out[..., j] = xe[..., j] − Σ_k buf[..., t[k, j]]``.

    ``buf`` (..., C) is the contribution buffer with ``buf[..., 0] == 0``
    (the pads of ``t`` point there); ``t`` (kmax, w) holds buffer positions;
    ``xe`` (..., w) is the segment of the work vector. ``out`` may be ``xe``
    itself (an in-place update). The kernel for CUDA tensors, the plain
    version for CPU tensors.
    """
    if buf.device.type == "cuda":
        return _gather_sum_sub_cuda(buf, t, xe, out)
    if buf.device.type == "cpu" and xe.device.type == "cpu":
        r = gather_sum_sub_plain(buf, t, xe)
        return r if out is None else out.copy_(r)
    raise ValueError(f"no P1 path for buf on {buf.device} and xe on {xe.device}")
