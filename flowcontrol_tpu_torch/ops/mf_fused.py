"""Kernel F: the whole multifrontal solve in one launch, and its three
primitives P2, P3 and P4 on their own.

- :func:`multifrontal_solve_fused`: ``x = A⁻¹ b`` from a
  ``MultifrontalLU`` factor for ``b`` of shape (..., n) with at most
  :data:`F_MAX_ROWS` rows. One cooperative launch walks the factor's stage
  descriptor array (:data:`STAGE_WORDS` int64 words per stage, built by
  ``solvers/multifrontal.py``): the forward sweep (``xe`` gathered through
  the entry permutation less the inbox sums, ``z = inv·xe`` into a
  full-length vector, ``fbi·z`` into the contribution buffer) and the
  backward sweep (``z[stage] -= ginv·z[bd]``, each final value scattered
  to the output through the permutation), with grid-wide barriers between
  dependent phases (:func:`grid_syncs`). It is the whole-sweep kernel the JAX
  package could not build on the TPU (``docs/tpu-design.md``, the probes
  of ``tools/pallas_gather_probe.py``), and it replaces the JAX package's
  per-stage sweep (``flowcontrol_tpu/solvers/multifrontal.py``:
  ``multifrontal_solve``). Its plain version is
  :func:`multifrontal_solve_fused_plain`.
- The probes' patterns, which F is built from:
  :func:`take_along_axis_lanes` (P2, ``out[r, j] = v[r, idx[r, j]]``),
  :func:`dynamic_slice` (P3, ``v[s : s + w]`` at a runtime offset held in
  device memory) and :func:`dynamic_offset_accum_store` (P4,
  ``o[s : s + w] += v``). P1, the per-stage sweep's gathers (the inbox
  sums among them), is ``ops/mf_matvec.sweep_gather``.

All live in ``csrc/mf_fused.cu``. Each wrapper takes its plain version for
CPU tensors and launches its kernel for CUDA tensors, or raises on what the
kernel does not take; it never falls back. Each counts its kernel launches
in ``.launches``.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from flowcontrol_tpu_torch.ops.cuda_build import CudaLibrary, counted

#: the stage record of the descriptor array: these head words, then
#: MAX_SEGS inbox segments of SEG_FIELDS words (unused segments are zero).
#: Offsets are elements of the flat stacks (inv, ginv, fbi), of the flat bd
#: table and of the flat inbox tables; ``n_bd`` counts the stage's real
#: (non-pad) bd slots: a stage without one (the root) has no backward
#: phase; ``leaf`` is 1 when no stage's bd holds one of the stage's slots:
#: it then receives no inbox sums and nothing reads its results in the
#: backward sweep, so F runs all leaf stages together. Kept in step with
#: csrc/mf_fused.cu.
HEAD_FIELDS = ("e", "b", "m", "off", "c_off", "inv", "ginv", "fbi", "bd", "n_bd", "leaf",
               "n_segs")
SEG_FIELDS = ("m0", "m1", "tabbed", "inbox", "kmax")
MAX_SEGS = 4
STAGE_WORDS = len(HEAD_FIELDS) + MAX_SEGS * len(SEG_FIELDS)

#: most right-hand sides F takes in one launch (its per-warp accumulators)
F_MAX_ROWS = 8
#: threads of one F block (kept in step with csrc/mf_fused.cu)
F_BLOCK_THREADS = 512


def stage_record(words) -> tuple[dict, list]:
    """One stage's descriptor words as ({head field: value}, [segment dicts])."""
    words = [int(w) for w in words]
    head = dict(zip(HEAD_FIELDS, words))
    segs = []
    for k in range(head["n_segs"]):
        base = len(HEAD_FIELDS) + k * len(SEG_FIELDS)
        segs.append(dict(zip(SEG_FIELDS, words[base: base + len(SEG_FIELDS)])))
    return head, segs


def _declare(lib: ctypes.CDLL) -> None:
    p, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
    lib.mf_fused_solve_f32.argtypes = [
        p, i32, i32, p, p, p, p, p, p, p, p, p, i32, i32, i64, i64, i64, i64, p, p,
    ]
    lib.mf_fused_solve_f32.restype = i32
    lib.mf_fused_grid.argtypes = [i32, i32, i32] + [ctypes.POINTER(ctypes.c_int)] * 3
    lib.mf_fused_grid.restype = i32
    lib.mf_fused_smem_limit.argtypes = [i32, ctypes.POINTER(ctypes.c_longlong)]
    lib.mf_fused_smem_limit.restype = i32
    lib.mf_take_along_lanes_f32.argtypes = [p, i64, p, i32, i32, p, p]
    lib.mf_take_along_lanes_f32.restype = i32
    lib.mf_dynamic_slice_f32.argtypes = [p, p, i32, p, p]
    lib.mf_dynamic_slice_f32.restype = i32
    lib.mf_dynamic_accum_store_f32.argtypes = [p, p, p, i32, p]
    lib.mf_dynamic_accum_store_f32.restype = i32
    lib.mf_fused_error_string.argtypes = [i32]
    lib.mf_fused_error_string.restype = ctypes.c_char_p


#: F's, P2's, P3's and P4's shared library, built from csrc/mf_fused.cu on
#: first launch.
MF_FUSED_KERNEL = CudaLibrary("mf_fused", "mf_fused.cu", _declare)


def _raise_on(rc: int, what: str) -> None:
    if rc != 0:
        msg = MF_FUSED_KERNEL.get().mf_fused_error_string(rc).decode()
        raise RuntimeError(f"{what} launch failed: {msg} (cudaError {rc})")


def _stream(dev: torch.device):
    return torch.cuda.current_stream(dev).cuda_stream


def fused_grid(rows: int = 1, width: int = 1536, n_stages: int = 24) -> dict:
    """F's cooperative grid on the current device for ``rows`` right-hand
    sides, node vectors of ``width`` floats (a factor's ``max_front``, a
    multiple of 8) and ``n_stages`` stages (each accumulator count is its
    own kernel instance; its shared memory holds the stage descriptors and
    rows x width floats): blocks per SM (from the occupancy calculator),
    SMs and blocks."""
    vals = [ctypes.c_int(0) for _ in range(3)]
    lib = MF_FUSED_KERNEL.get()
    _raise_on(lib.mf_fused_grid(rows, width, n_stages, *[ctypes.byref(v) for v in vals]),
              "F occupancy query")
    return dict(zip(("blocks", "per_sm", "sms"), (v.value for v in vals)))


def fused_smem_bytes(mf, rows: int) -> int:
    """F's dynamic shared memory per block at ``rows`` right-hand sides
    (``csrc/mf_fused.cu`` ``smem_of``): every stage's descriptor words,
    16-byte aligned, and one node vector of ``max_front`` floats for each of
    the accumulator count's rows (1, 2, 4 or 8, the smallest that holds
    them)."""
    desc = -(-len(mf.stages) * STAGE_WORDS * 8 // 16) * 16
    return desc + (1 << (rows - 1).bit_length()) * mf.max_front * 4


def fused_smem_limit(rows: int) -> int:
    """The most dynamic shared memory an F block for ``rows`` right-hand
    sides may request on the current device (the opt-in less the kernel
    instance's static shared memory); asked once per device and width."""
    return _smem_limit(torch.cuda.current_device(), rows)


@functools.lru_cache(maxsize=None)
def _smem_limit(device: int, rows: int) -> int:
    val = ctypes.c_longlong(0)
    _raise_on(MF_FUSED_KERNEL.get().mf_fused_smem_limit(rows, ctypes.byref(val)),
              "F shared-memory query")
    return int(val.value)


def phase_labels(mf) -> list[tuple[str, tuple]]:
    """F's phases in launch order, each ending at a grid sync (the last at
    the end of the launch), as (name, stages): ("inv", leaves) and ("fbi",
    leaves) for all leaf stages at once (the root's updates excluded); then
    per other stage, deepest first, ("inbox", (si,)) when it has a tabbed
    inbox segment (its xe less the inbox sums, one pass over the grid;
    preceded by ("entry", ()) when no phase came before it), ("inv",
    (si,)) and ("fbi", (si,)) (none at the root); then ("ginv", (si,)) for
    those with real bd slots, root first, and ("ginv", leaves)."""
    records = [stage_record(w) for w in mf.desc.cpu().tolist()]
    last = len(records) - 1
    leaves = tuple(si for si, (h, _) in enumerate(records) if h["leaf"])
    labels = []
    if leaves:
        labels.append(("inv", leaves))
        if any(si < last for si in leaves):
            labels.append(("fbi", tuple(si for si in leaves if si < last)))
    for si, (h, segs) in enumerate(records):
        if h["leaf"]:
            continue
        if any(sg["tabbed"] for sg in segs):
            if not labels:
                labels.append(("entry", ()))
            labels.append(("inbox", (si,)))
        labels.append(("inv", (si,)))
        if si < last:
            labels.append(("fbi", (si,)))
    labels += [("ginv", (si,)) for si in reversed(range(len(records)))
               if not records[si][0]["leaf"] and records[si][0]["n_bd"]]
    if leaves:
        labels.append(("ginv", leaves))
    return labels


def grid_syncs(mf) -> int:
    """Grid-wide barriers in one F launch: one at the end of every phase of
    :func:`phase_labels` but the last."""
    return len(phase_labels(mf)) - 1


# ── F: the whole solve ───────────────────────────────────────────────────────


def _rows_of(mf, b: torch.Tensor):
    batch = b.shape[:-1]
    if b.shape[-1:] != (mf.n,):
        raise ValueError(f"b has shape {tuple(b.shape)}, needs (..., {mf.n})")
    rows = 1
    for d in batch:
        rows *= int(d)
    out_dtype = b.dtype if b.dtype in (torch.float32, torch.float64) else mf.dtype
    return batch, rows, out_dtype


def multifrontal_solve_fused_plain(mf, b: torch.Tensor) -> torch.Tensor:
    """``x = A⁻¹ b``, plain torch, walking ``mf``'s descriptor array over
    the flat stacks and tables in the order the kernel does."""
    batch, rows, out_dtype = _rows_of(mf, b)
    n, total, dtype = mf.n, mf.total_slots, mf.dtype
    bb = b.reshape(rows, n).to(dtype)
    stacks, bd_flat, inbox_flat = mf.flat_stacks, mf.flat_bd, mf.flat_inbox
    records = [stage_record(w) for w in mf.desc.cpu().tolist()]

    def view(flat, o, *shape):
        size = 1
        for d in shape:
            size *= d
        return flat[o: o + size].view(*shape)

    # b in slot order through the entry permutation (P2; pad slots read
    # zero); z holds the stage results, then the solution in slot order,
    # with a trailing zero slot for the bd pads
    xs = take_along_axis_lanes_plain(
        torch.nn.functional.pad(bb, (0, 1)), mf.perm.expand(rows, total + 1))
    z = torch.zeros((rows, total + 1), dtype=dtype, device=bb.device)
    buf = torch.empty((rows, 1 + mf.total_contrib), dtype=dtype, device=bb.device)
    buf[:, 0] = 0.0
    for si, (h, segs) in enumerate(records):
        e, bw, m, off = h["e"], h["b"], h["m"], h["off"]
        xe = xs[:, off: off + m * e].clone()
        for sg in segs:
            if sg["tabbed"]:  # P1, subtracted as the kernel stages xe
                w = (sg["m1"] - sg["m0"]) * e
                t = view(inbox_flat, sg["inbox"], sg["kmax"], w)
                s = sg["m0"] * e
                xe[:, s: s + w] += -buf[:, t].sum(dim=-2)
        zs = torch.einsum("mpq,rmq->rmp", view(stacks, h["inv"], m, e, e), xe.view(rows, m, e))
        z[:, off: off + m * e] = zs.reshape(rows, m * e)
        if si < len(records) - 1:  # the root's updates have no consumer
            c0 = 1 + h["c_off"]
            buf[:, c0: c0 + m * bw] = torch.einsum(
                "mpq,rmq->rmp", view(stacks, h["fbi"], m, bw, e), zs).reshape(rows, m * bw)
    for h, _ in reversed(records):
        if h["n_bd"] == 0:  # no real bd slot: z is final
            continue
        e, bw, m, off = h["e"], h["b"], h["m"], h["off"]
        zb = z[:, view(bd_flat, h["bd"], m * bw)].view(rows, m, bw)
        corr = torch.einsum("mpq,rmq->rmp", view(stacks, h["ginv"], m, e, bw), zb)
        z[:, off: off + m * e] += -corr.reshape(rows, m * e)
    # the kernel scatters each final value through perm; the same as this gather
    out = take_along_axis_lanes_plain(z, mf.ipos.expand(rows, n))
    return out.reshape(batch + (n,)).to(out_dtype)


def _solve_cuda(mf, b: torch.Tensor, trace: torch.Tensor | None = None) -> torch.Tensor:
    batch, rows, out_dtype = _rows_of(mf, b)
    dev = mf.flat_stacks.device
    if mf.dtype != torch.float32 or b.dtype not in (torch.float32, torch.float64):
        raise TypeError(f"kernel F takes a float32 factor, got {mf.dtype}, b {b.dtype}")
    if b.device != dev:
        raise ValueError(f"b is on {b.device}, the factor on {dev}")
    if not 0 < rows <= F_MAX_ROWS:
        raise ValueError(f"kernel F takes 1 to {F_MAX_ROWS} right-hand sides, got {rows}")
    need, limit = fused_smem_bytes(mf, rows), fused_smem_limit(rows)
    if need > limit:
        raise ValueError(f"kernel F needs {need} bytes of shared memory a block for {rows} "
                         f"row(s) of this factor ({len(mf.stages)} stages, max_front "
                         f"{mf.max_front}); the card allows {limit}")
    n, total = mf.n, mf.total_slots
    bb = b.reshape(rows, n).to(torch.float32).contiguous()
    # scratch, allocated here and never by the kernel: x, the stages' xe
    # less their inbox sums; z, the solution in slot order with its trailing
    # zero slot (rows padded to 4 floats); the contribution buffer [zero |
    # contributions] (the kernel writes both zeros before it reads them)
    zs = -(-(total + 1) // 4) * 4
    bs = 1 + mf.total_contrib
    x = torch.empty((rows, zs), dtype=torch.float32, device=dev)
    z = torch.empty((rows, zs), dtype=torch.float32, device=dev)
    buf = torch.empty((rows, bs), dtype=torch.float32, device=dev)
    out = torch.empty((rows, n), dtype=torch.float32, device=dev)
    lib = MF_FUSED_KERNEL.get()
    rc = lib.mf_fused_solve_f32(
        mf.desc.data_ptr(), mf.desc.shape[0], STAGE_WORDS, mf.flat_stacks.data_ptr(),
        mf.flat_bd.data_ptr(), mf.flat_inbox.data_ptr(), mf.perm.data_ptr(), bb.data_ptr(),
        out.data_ptr(), x.data_ptr(), z.data_ptr(), buf.data_ptr(), rows, mf.max_front, n,
        total, zs, bs, None if trace is None else trace.data_ptr(), _stream(dev),
    )
    _raise_on(rc, "F multifrontal_solve_fused")
    multifrontal_solve_fused.launches += 1
    return out.reshape(batch + (n,)).to(out_dtype)


@counted
def multifrontal_solve_fused(mf, b: torch.Tensor) -> torch.Tensor:
    """F: ``x = A⁻¹ b`` for b (..., n), at most :data:`F_MAX_ROWS` rows on
    CUDA. The kernel for a factor on CUDA (one launch), the plain version
    for a factor and b on the CPU."""
    dev = mf.flat_stacks.device
    if dev.type == "cuda":
        return _solve_cuda(mf, b)
    if dev.type == "cpu" and b.device.type == "cpu":
        return multifrontal_solve_fused_plain(mf, b)
    raise ValueError(f"no F path for a factor on {dev} and b on {b.device}")


def fused_phase_times(mf, b: torch.Tensor) -> list[dict]:
    """One traced F launch on ``b``: the device time of each phase (from
    the card's global timer, read by one thread after every grid sync; a
    traced launch adds one sync at its end) with the bytes of the stack it
    reads. Returns [{"phase", "stages", "us", "bytes"}] in launch order."""
    labels = phase_labels(mf)
    trace = torch.zeros(len(labels) + 1, dtype=torch.int64, device=mf.flat_stacks.device)
    _solve_cuda(mf, b, trace=trace)
    t = trace.cpu().tolist()

    def nbytes(ph, st):
        if ph == "inbox":
            return sum(tb.nbytes for tb in st.inbox)
        return getattr(st, ph).nbytes if ph in ("inv", "fbi", "ginv") else 0

    return [{"phase": ph, "stages": sis, "us": (t[k + 1] - t[k]) / 1e3,
             "bytes": sum(nbytes(ph, mf.stages[si]) for si in sis)}
            for k, (ph, sis) in enumerate(labels)]


# ── P2, P3, P4 on their own ──────────────────────────────────────────────────


def take_along_axis_lanes_plain(v: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """P2: ``out[r, j] = v[r, idx[r, j]]``, plain torch."""
    return torch.take_along_dim(v, idx.long(), dim=1)


def dynamic_slice_plain(v: torch.Tensor, s: torch.Tensor, width: int) -> torch.Tensor:
    """P3: ``v[s : s + width]`` with ``s`` a one-element int tensor, plain torch."""
    s0 = int(s.reshape(-1)[0])
    return v[s0: s0 + width].clone()


def dynamic_offset_accum_store_plain(o: torch.Tensor, s: torch.Tensor,
                                     v: torch.Tensor) -> torch.Tensor:
    """P4: ``o[s : s + len(v)] += v`` in place, plain torch; returns ``o``."""
    s0 = int(s.reshape(-1)[0])
    o[s0: s0 + v.shape[0]] += v
    return o


def _check(name, x, dev, dtype):
    if x.device != dev or x.dtype != dtype or not x.is_contiguous():
        raise ValueError(f"{name} must be contiguous {dtype} on {dev}, "
                         f"got {x.dtype} on {x.device}")


def _check_offset(s, dev, width, size):
    _check("s", s, dev, torch.int32)
    if s.numel() != 1:
        raise ValueError(f"s must hold one offset, got shape {tuple(s.shape)}")
    if not 0 < width <= 1024 or width > size:
        raise ValueError(f"width {width} must be in 1..{min(size, 1024)}")


@counted
def take_along_axis_lanes(v: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """P2: ``out[r, j] = v[r, idx[r, j]]`` for v (R, n) float32 and idx
    (R, w) int32. The kernel for CUDA tensors, the plain version for CPU
    tensors."""
    if v.device.type == "cpu" and idx.device.type == "cpu":
        return take_along_axis_lanes_plain(v, idx)
    dev = v.device
    _check("v", v, dev, torch.float32)
    _check("idx", idx, dev, torch.int32)
    if v.dim() != 2 or idx.dim() != 2 or idx.shape[0] != v.shape[0]:
        raise ValueError(f"v {tuple(v.shape)} and idx {tuple(idx.shape)} must be (R, n), (R, w)")
    out = torch.empty(idx.shape, dtype=torch.float32, device=dev)
    rc = MF_FUSED_KERNEL.get().mf_take_along_lanes_f32(
        v.data_ptr(), v.shape[1], idx.data_ptr(), idx.shape[0], idx.shape[1], out.data_ptr(),
        _stream(dev))
    _raise_on(rc, "P2 take_along_axis_lanes")
    take_along_axis_lanes.launches += 1
    return out


@counted
def dynamic_slice(v: torch.Tensor, s: torch.Tensor, width: int) -> torch.Tensor:
    """P3: ``v[s : s + width]`` for v (n,) float32, with the offset ``s`` a
    one-element int32 tensor on v's device (the kernel reads it there, as
    the probe reads its offset from SMEM). The kernel for CUDA tensors, the
    plain version for CPU tensors."""
    if v.device.type == "cpu" and s.device.type == "cpu":
        return dynamic_slice_plain(v, s, width)
    dev = v.device
    _check("v", v, dev, torch.float32)
    _check_offset(s, dev, width, v.numel())
    out = torch.empty(width, dtype=torch.float32, device=dev)
    rc = MF_FUSED_KERNEL.get().mf_dynamic_slice_f32(
        v.data_ptr(), s.data_ptr(), width, out.data_ptr(), _stream(dev))
    _raise_on(rc, "P3 dynamic_slice")
    dynamic_slice.launches += 1
    return out


@counted
def dynamic_offset_accum_store(o: torch.Tensor, s: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """P4: ``o[s : s + len(v)] += v`` in place for o (n,) and v (w,) float32,
    the offset ``s`` a one-element int32 tensor on o's device; returns
    ``o``. The kernel for CUDA tensors, the plain version for CPU tensors.
    The offset is not range-checked on the card (it is never copied to the
    host); the caller keeps ``s + w <= n``."""
    if o.device.type == "cpu" and s.device.type == "cpu" and v.device.type == "cpu":
        return dynamic_offset_accum_store_plain(o, s, v)
    dev = o.device
    _check("o", o, dev, torch.float32)
    _check("v", v, dev, torch.float32)
    _check_offset(s, dev, v.numel(), o.numel())
    rc = MF_FUSED_KERNEL.get().mf_dynamic_accum_store_f32(
        o.data_ptr(), s.data_ptr(), v.data_ptr(), v.numel(), _stream(dev))
    _raise_on(rc, "P4 dynamic_offset_accum_store")
    dynamic_offset_accum_store.launches += 1
    return o
