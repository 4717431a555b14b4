"""Kernel K3: the fused blocked-LU forward/back substitution.

:func:`block_lu_solve_fused` solves ``A x = b`` from a ``BlockLU`` factor
``(lu, dinv)`` (``solvers/block_lu.py``) with the whole substitution, the
products with ``dinv`` included, in one hand-written CUDA kernel source,
``csrc/block_trisolve.cu``. The port of the TPU kernel
``flowcontrol_tpu/ops/pallas_trisolve.py`` (``pallas_block_lu_solve``), with
its signature. Its plain torch version is
``solvers.block_lu.block_lu_solve``.

One right-hand side takes 3 nb - 2 GEMV launches, made back to back by the
C entry point. A panel of right-hand sides takes one persistent launch that
walks :func:`panel_schedule`: items (kind, k, tile, slice) in dependency
order, each a 64-row tile of one block row over the whole panel width or,
near the critical path, over 64 of its columns.
:func:`block_lu_solve_scheduled_plain` walks the same schedule in torch,
checking every item's waits against the counters the kernel keeps, so the
CPU tests hold the schedule's order and its arithmetic against the JAX
package.

The wrapper takes the plain version for CPU tensors and launches the kernel
for CUDA tensors, or raises on what the kernel does not take (float32 only,
one device, contiguous factors, a block size that is a multiple of 16); it
never falls back. ``block_lu_solve_fused.launches`` counts kernel launches:
:func:`launches_per_solve` of them per solve, added where the wrapper calls
the C entry point.
"""

from __future__ import annotations

import ctypes
from functools import lru_cache

import numpy as np
import torch

from flowcontrol_tpu_torch.ops.cuda_build import CudaLibrary, counted
from flowcontrol_tpu_torch.solvers.block_lu import block_lu_solve

#: the single right-hand-side kernel stages one block row of the vector in
#: static-limit shared memory (48 KB of float32)
K3_MAX_BS = 48 * 1024 // 4
#: rows of one tile of the panel schedule (csrc/block_trisolve.cu kBM)
TILE_ROWS = 64
#: item kinds of the panel schedule (csrc/block_trisolve.cu)
FWD, DINV, BWD = 0, 1, 2


def _declare(lib: ctypes.CDLL) -> None:
    p, i32 = ctypes.c_void_p, ctypes.c_int
    lib.block_trisolve_f32.argtypes = [p, p, p, p, i32, i32, i32, i32, i32, p, i32, p, p]
    lib.block_trisolve_f32.restype = i32
    lib.block_trisolve_tile_rows.argtypes = []
    lib.block_trisolve_tile_rows.restype = i32
    lib.block_trisolve_error_string.argtypes = [i32]
    lib.block_trisolve_error_string.restype = ctypes.c_char_p
    if lib.block_trisolve_tile_rows() != TILE_ROWS:
        raise RuntimeError(f"csrc/block_trisolve.cu tiles {lib.block_trisolve_tile_rows()} "
                           f"rows, ops/trisolve.py schedules {TILE_ROWS}")


#: K3's shared library, built from csrc/block_trisolve.cu on first launch.
TRISOLVE_KERNEL = CudaLibrary("block_trisolve", "block_trisolve.cu", _declare)


def launches_per_solve(nb: int, nrhs: int) -> int:
    """Kernel launches of one K3 solve over ``nb`` block rows: for one
    right-hand side nb - 1 forward updates, nb products with ``dinv`` and
    nb - 1 backward updates; for a panel one persistent launch."""
    return 3 * nb - 2 if nrhs == 1 else 1


def tiles_per_block(bs: int) -> int:
    return -(-bs // TILE_ROWS)


#: block rows past the current step whose items the schedule splits into
#: 64-column slices (they lie on or next to the critical path)
SPLIT_AHEAD = 2


@lru_cache(maxsize=8)
def panel_schedule(nb: int, tpb: int, ns: int) -> np.ndarray:
    """The panel kernel's work items, (n_items, 4) int32 rows (kind, k,
    tile, slice), tile = block row * tpb + tile within it, in the order
    blocks claim them; ``ns`` = panel width / 64. Right-looking with
    lookahead: forward step k updates the tiles of block row k+1 first
    (they make y_{k+1}), then the rows below; backward step k multiplies
    block row k by dinv[k], then updates block row k-1 first, then the rows
    above. The dinv products and the updates of the SPLIT_AHEAD block rows
    next to the step are cut into ``ns`` items of 64 columns (slice 0 ..
    ns-1), so that the critical path runs on more blocks; the other items
    span the width (slice -1)."""
    items = []

    def add(kind, k, blk, split):
        for r in range(blk * tpb, (blk + 1) * tpb):
            items.extend((kind, k, r, c) for c in (range(ns) if split and ns > 1 else (-1,)))

    for k in range(nb - 1):
        for blk in range(k + 1, nb):
            add(FWD, k, blk, blk - k <= SPLIT_AHEAD)
    for k in reversed(range(nb)):
        add(DINV, k, k, SPLIT_AHEAD > 0)
        for blk in reversed(range(k)):
            add(BWD, k, blk, k - blk <= SPLIT_AHEAD)
    out = np.asarray(items, dtype=np.int32).reshape(-1, 4)
    out.flags.writeable = False
    return out


def item_waits(kind: int, k: int, tile: int, nb: int, tpb: int, ns: int):
    """What the kernel waits for before an item: ((counter, tile, at least),
    ...) with counter 'cnt' (64-column updates applied to a tile of the
    panel) or 'ocnt' (64-column slices of its rows of out written)."""
    blk = tile // tpb
    block_k = range(k * tpb, (k + 1) * tpb)
    if kind == FWD:
        return tuple(("cnt", i, k * ns) for i in block_k) + (("cnt", tile, k * ns),)
    if kind == DINV:
        return tuple(("cnt", i, (nb - 1) * ns) for i in block_k)
    return (tuple(("ocnt", i, ns) for i in block_k)
            + (("cnt", tile, (blk + nb - 1 - k) * ns),))


def block_lu_solve_scheduled_plain(factors, b: torch.Tensor, bs: int, n: int,
                                   ldx: int | None = None) -> torch.Tensor:
    """The panel kernel's walk in torch: :func:`panel_schedule` item by item
    in claim order, the same tile products over the panel padded to ``ldx``
    columns (default: as the kernel pads it), and every item's waits checked
    against counters kept as the kernel keeps them (an item whose wait is
    not yet met raises: the order is not topological). Any device and
    dtype; b is (..., n)."""
    lu, dinv = factors
    n_pad = lu.shape[0]
    nb, tpb = n_pad // bs, tiles_per_block(bs)
    if b.shape[-1] != n:
        raise ValueError(f"b has shape {tuple(b.shape)}, needs (..., {n})")
    batch = b.shape[:-1]
    nrhs = int(np.prod(batch, dtype=np.int64))
    ldx = ldx or panel_ldx(nrhs)
    ns = ldx // 64
    x = torch.zeros((n_pad, ldx), dtype=lu.dtype, device=lu.device)
    x[:n, :nrhs] = b.to(lu.dtype).reshape(-1, n).T
    out = torch.empty_like(x)
    counters = {"cnt": np.zeros(nb * tpb, np.int64), "ocnt": np.zeros(nb * tpb, np.int64)}
    for kind, k, tile, piece in panel_schedule(nb, tpb, ns).tolist():
        for name, i, at_least in item_waits(kind, k, tile, nb, tpb, ns):
            if counters[name][i] < at_least:
                raise AssertionError(f"item {(kind, k, tile, piece)} runs before {name}[{i}] "
                                     f"reaches {at_least}")
        blk = tile // tpb
        r0 = blk * bs + (tile % tpb) * TILE_ROWS
        r1 = min(r0 + TILE_ROWS, (blk + 1) * bs)
        col = slice(k * bs, (k + 1) * bs)
        cols = slice(None) if piece < 0 else slice(64 * piece, 64 * piece + 64)
        if kind == DINV:
            out[r0:r1, cols] = dinv[k, r0 - k * bs:r1 - k * bs] @ x[col, cols]
            counters["ocnt"][tile] += ns if piece < 0 else 1
        else:
            x[r0:r1, cols] -= lu[r0:r1, col] @ (x if kind == FWD else out)[col, cols]
            counters["cnt"][tile] += ns if piece < 0 else 1
    return out[:n, :nrhs].T.contiguous().reshape(batch + (n,)).to(b.dtype)


@lru_cache(maxsize=None)  # never evicted: a CUDA graph of a K3 launch reads its schedule
def _schedule_on(nb: int, tpb: int, ns: int, device: torch.device) -> torch.Tensor:
    return torch.as_tensor(np.array(panel_schedule(nb, tpb, ns)), device=device)


def panel_width(nrhs: int) -> int:
    """Column tile of the panel kernel: 64, 128 or 256 right-hand sides."""
    return 64 if nrhs <= 64 else 128 if nrhs <= 128 else 256


def panel_ldx(nrhs: int) -> int:
    """Columns of the kernel's panel: ``nrhs`` rounded up to whole column
    tiles (1 for the single right-hand side)."""
    bn = panel_width(nrhs)
    return 1 if nrhs == 1 else -(-nrhs // bn) * bn


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
    # the kernel's panel layout: (n_pad, ldx), one row per unknown, the
    # width padded to whole column tiles; padding rows and columns stay
    # zero (the factor carries the identity there)
    bn, ldx = panel_width(nrhs), panel_ldx(nrhs)
    x = torch.zeros((n_pad, ldx), dtype=torch.float32, device=dev)
    x[:n, :nrhs] = rows.T
    out = torch.empty_like(x)
    tpb = tiles_per_block(bs)
    sched = _schedule_on(nb, tpb, ldx // 64, dev) if nrhs > 1 else None
    scratch = torch.empty(1 + 2 * nb * tpb, dtype=torch.int32, device=dev) if nrhs > 1 else None
    lib = TRISOLVE_KERNEL.get()
    rc = lib.block_trisolve_f32(
        lu.data_ptr(), dinv.data_ptr(), x.data_ptr(), out.data_ptr(), n_pad, bs, nrhs, ldx, bn,
        sched.data_ptr() if sched is not None else None,
        sched.shape[0] if sched is not None else 0,
        scratch.data_ptr() if scratch is not None else None,
        torch.cuda.current_stream(dev).cuda_stream,
    )
    if rc != 0:
        msg = lib.block_trisolve_error_string(rc).decode()
        raise RuntimeError(f"K3 block_lu_solve_fused launch failed: {msg} (cudaError {rc})")
    block_lu_solve_fused.launches += launches_per_solve(nb, nrhs)
    return out[:n, :nrhs].T.contiguous().reshape(batch + (n,))


@counted
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
