"""The multifrontal sweep's two kernels: K2 (stage matvec) and P1 (the
sweep's gathers), each with its plain torch version.

- :func:`stack_matvec`: ``out[..., m, p] = Σ_q a[m, p, q] · v[..., m, q]``,
  one stage's factor stack against its vectors. The port of the TPU kernel
  K2 (``flowcontrol_tpu/ops/pallas_mf_matvec.py``: ``_mv_kernel``), which
  the JAX sweep runs as ``einsum("mpq,...mq->...mp")``. Up to
  :data:`K2_NARROW_MAX` right-hand sides take the narrow instance (a
  warp per row, v in shared memory); wider batches a tiled f32 product
  per node that reads each tile of ``a`` once per 64 right-hand sides.
- :func:`sweep_gather`: the batched sweep's one gather kernel, over the
  segments of a :class:`GatherPlan`: ``out[b, o + j] = xe[b, o + j] −
  Σ_k src[b, t[k, j]]`` (the inbox sums of one stage, every segment in one
  launch) or ``out[b, o + j] = src[b, t[0, j]]`` (the boundary gather and
  the entry and exit permutations), an index past src's row reading 0. The
  port of the TPU probe P1 (``tools/pallas_gather_probe.py``:
  ``take_2d_table``), the primitive of the JAX sweep's ``_gather_sum0``
  and of its boundary gather.
- :func:`gather_sum_sub`: ``xe[..., j] − Σ_k buf[..., t[k, j]]`` over one
  inbox segment, the earlier P1 kernel (one launch per segment), kept as
  the sweep's reference: nothing on the main path calls it, and it counts no
  launches.

Both kernels live in ``csrc/mf_sweep.cu``. Each wrapper takes its plain
version for CPU tensors and launches its kernel for CUDA tensors, or raises
on what the kernel does not take (float32 only, one device, the layouts
below); it never falls back. ``stack_matvec.launches`` and
``sweep_gather.launches`` count kernel launches, so a run can show that its
solves went through them.
"""

from __future__ import annotations

import ctypes
from dataclasses import dataclass

import numpy as np
import torch

from flowcontrol_tpu_torch.ops.cuda_build import CudaLibrary, counted

#: largest q the narrow K2 instance (at most K2_NARROW_MAX right-hand
#: sides) stages in shared memory for 8 right-hand sides (227 KB per block
#: on Hopper); the wide instance takes any q
K2_MAX_Q = (227 * 1024) // (8 * 4)
#: most right-hand sides the narrow K2 instance takes; wider batches go to
#: the tiled product (csrc/mf_sweep.cu: stack_matmul_kernel)
K2_NARROW_MAX = 8
#: columns of one P1 block's tile (csrc/mf_sweep.cu kGatherCols)
GATHER_COLS = 128
#: int32 words of one P1 segment's descriptor (csrc/mf_sweep.cu kSegWords):
#: its first output column, its width w, its depth kmax, the offset of its
#: (kmax, w) table in the flat table, its first tile
SEG_WORDS = 5


def _declare(lib: ctypes.CDLL) -> None:
    p, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
    lib.mf_stack_matvec_f32.argtypes = [p, i32, i32, i32, p, i64, p, i64, i32, p]
    lib.mf_stack_matvec_f32.restype = i32
    lib.mf_gather_sum_sub_f32.argtypes = [p, i64, p, i32, i32, p, i64, p, i64, i32, p]
    lib.mf_gather_sum_sub_f32.restype = i32
    lib.mf_sweep_gather_f32.argtypes = [p, i32, i32, p, p, i64, i32, p, i64, p, i64, i32, p]
    lib.mf_sweep_gather_f32.restype = i32
    lib.mf_error_string.argtypes = [i32]
    lib.mf_error_string.restype = ctypes.c_char_p
    lib.mf_gather_cols.argtypes = []
    lib.mf_gather_cols.restype = i32
    if lib.mf_gather_cols() != GATHER_COLS:
        raise RuntimeError(f"csrc/mf_sweep.cu tiles P1 by {lib.mf_gather_cols()} columns, "
                           f"ops/mf_matvec.py by {GATHER_COLS}")


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


# ── P1: the sweep's gathers ──────────────────────────────────────────────────


def gather_sum_sub_plain(buf: torch.Tensor, t: torch.Tensor, xe: torch.Tensor) -> torch.Tensor:
    """``xe[..., j] − Σ_k buf[..., t[k, j]]``, plain torch."""
    return xe - buf[..., t].sum(dim=-2)


def gather_plain(src: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    """``src[..., t[j]]`` with an index past src's last dim reading 0,
    plain torch."""
    n_src = src.shape[-1]
    if t.numel() and int(t.max()) >= n_src:
        src = torch.nn.functional.pad(src, (0, 1))
        t = t.clamp(max=n_src)
    return src[..., t]


@dataclass(frozen=True)
class GatherPlan:
    """The segments of one P1 launch. ``segs`` holds (first output column,
    width w, kmax, offset of the (kmax, w) table in ``tables``) per segment,
    ``tables`` the flat int32 table on the device (16-byte aligned) and
    ``desc`` the segments' descriptor rows there (:func:`gather_descriptors`),
    which the kernel reads: both live as long as the plan, so a captured
    launch keeps reading them. ``sub``: the inbox form (``xe − Σ``) or the
    gather form (kmax 1). ``n_tiles``: the launch's column tiles."""

    desc: torch.Tensor
    tables: torch.Tensor
    segs: tuple
    sub: bool
    n_tiles: int

    @property
    def width(self) -> int:
        """Columns of out the segments cover (the last one's end)."""
        return max((o + w for (o, w, _, _) in self.segs), default=0)

    def table(self, i: int) -> torch.Tensor:
        """Segment i's (kmax, w) table, a view of ``tables``."""
        _, w, kmax, t_off = self.segs[i]
        return self.tables[t_off: t_off + kmax * w].view(kmax, w)


def gather_descriptors(segs) -> tuple[np.ndarray, int]:
    """The descriptor rows (len(segs), SEG_WORDS) int32 of the P1 segments
    ``segs`` ((out column, w, kmax, table offset) each) and the tiles of
    their launch: each segment's tiles follow the previous one's."""
    rows = np.zeros((len(segs), SEG_WORDS), dtype=np.int64)
    tiles = 0
    for i, (o, w, kmax, t_off) in enumerate(segs):
        rows[i] = (o, w, kmax, t_off, tiles)
        tiles += -(-w // GATHER_COLS)
    if rows.size and rows.max() >= 2**31:
        raise ValueError("P1's descriptors hold int32 words")
    return rows.astype(np.int32), tiles


def sweep_gather_plain(plan: GatherPlan, src: torch.Tensor, xe: torch.Tensor | None = None,
                       out: torch.Tensor | None = None) -> torch.Tensor:
    """P1 over ``plan``'s segments, plain torch: per segment the inbox form
    :func:`gather_sum_sub_plain` or the gather form :func:`gather_plain`."""
    if out is None:
        out = (xe.clone() if plan.sub else
               torch.empty(src.shape[:-1] + (plan.width,), dtype=src.dtype, device=src.device))
    for i, (o, w, _, _) in enumerate(plan.segs):
        t = plan.table(i)
        if plan.sub:
            out[..., o: o + w] = gather_sum_sub_plain(src, t, xe[..., o: o + w])
        else:
            out[..., o: o + w] = gather_plain(src, t[0])
    return out


def _sweep_gather_cuda(plan, src, xe, out):
    dev = src.device
    _check_cuda("src", src, dev, torch.float32)
    for name, t in (("desc", plan.desc), ("tables", plan.tables)):
        _check_cuda(name, t, dev, torch.int32)
    if plan.tables.data_ptr() % 16:
        raise ValueError("P1 needs its flat table 16-byte aligned")
    if (xe is None) == plan.sub:
        raise ValueError("P1's inbox form takes xe, its gather form none")
    if src.dim() != 2:
        raise ValueError(f"P1 takes src (B, n_src), got shape {tuple(src.shape)}")
    batch, s_bs = _as_rows(src, (src.shape[-1],), "src")
    width = plan.width
    if out is None:
        out = xe.clone() if plan.sub else torch.empty((batch, width), dtype=torch.float32,
                                                      device=dev)
    rows = {"out": out} if xe is None else {"out": out, "xe": xe}
    strides = {}
    for name, t in rows.items():
        _check_cuda(name, t, dev, torch.float32)
        if t.dim() != 2 or t.shape[0] != batch or t.shape[1] < width or t.stride(1) != 1:
            raise ValueError(f"P1 needs {name} ({batch}, >= {width}) with unit column stride, "
                             f"got shape {tuple(t.shape)}, strides {t.stride()}")
        strides[name] = t.stride(0)
    if out.numel() == 0 or plan.n_tiles == 0:
        return out
    lib = MF_KERNELS.get()
    rc = lib.mf_sweep_gather_f32(
        plan.desc.data_ptr(), len(plan.segs), plan.n_tiles, plan.tables.data_ptr(),
        src.data_ptr(), s_bs, src.shape[-1], None if xe is None else xe.data_ptr(),
        strides.get("xe", 0), out.data_ptr(), strides["out"], batch,
        torch.cuda.current_stream(dev).cuda_stream,
    )
    _raise_on(rc, "P1 sweep_gather")
    sweep_gather.launches += 1
    return out


@counted
def sweep_gather(plan: GatherPlan, src: torch.Tensor, xe: torch.Tensor | None = None,
                 out: torch.Tensor | None = None) -> torch.Tensor:
    """P1: the gathers of the batched sweep over ``plan``'s segments, one
    launch. The inbox form (``plan.sub``): ``out[:, o + j] = xe[:, o + j] −
    Σ_k src[:, t[k, j]]``, with ``out`` and ``xe`` (B, >= width) possibly
    the same tensor (an in-place update); the gather form: ``out[:, o + j] =
    src[:, t[0, j]]``. ``src`` is (B, n_src) with unit column stride; an
    index >= n_src reads 0. ``out``, when not given, is a copy of ``xe``
    (the inbox form: columns outside the segments keep xe's values) or a
    new (B, width) tensor. The kernel for CUDA tensors, the plain version
    for CPU tensors."""
    if src.device.type == "cuda":
        return _sweep_gather_cuda(plan, src, xe, out)
    if src.device.type == "cpu" and plan.tables.device.type == "cpu":
        return sweep_gather_plain(plan, src, xe, out)
    raise ValueError(f"no P1 path for src on {src.device} and its tables on "
                     f"{plan.tables.device}")


def gather_sum_sub(buf: torch.Tensor, t: torch.Tensor, xe: torch.Tensor,
                   out: torch.Tensor | None = None):
    """The earlier P1: ``out[..., j] = xe[..., j] − Σ_k buf[..., t[k, j]]`` over
    one inbox segment, one launch. The sweep's reference order (the
    ``cuda`` tests and ``chip_smoke.py`` hold :func:`sweep_gather` to it);
    nothing on the main path calls it, and it counts no launches.

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
    _raise_on(rc, "P1 reference gather_sum_sub")
    return out
