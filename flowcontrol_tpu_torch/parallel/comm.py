"""The collectives of the port's multi-GPU layer, over ``torch.distributed``.

The JAX package runs one program over a ``jax.sharding.Mesh`` and names its
collectives inside ``shard_map``; the port runs one process per rank, and
each collective here takes its process group explicitly (nothing reads the
default group):

- ``psum`` -> :func:`all_reduce_sum` (``all_reduce``);
- the tiled ``all_gather`` -> :func:`all_gather_rows` (``all_gather_into_tensor``,
  named ``all_gather_single`` by newer PyTorch);
- ``ppermute`` -> :func:`exchange` (``batch_isend_irecv``).

Staging. NCCL takes CUDA tensors. gloo takes CPU tensors for every op, and
CUDA tensors for ``broadcast`` and ``all_reduce`` only (PyTorch's table of
backends). So on a gloo group a CUDA tensor's gather and point-to-point
transfers go through pinned host buffers, explicitly: the tensor is copied
into a page-locked host tensor, the op runs on the host, and the result is
copied back to the card. (PyTorch 2.11's gloo gathers CUDA tensors too, off
the table; its send of one aborts with "Bad address".) :func:`staging`
names the route each op takes for a group and a device, so a caller can
print it. The backend is the group's: nothing here picks one by what is
installed.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

#: the ops that gloo runs on CUDA tensors itself (PyTorch's backend table);
#: every other op stages a CUDA tensor through pinned host memory on gloo
GLOO_CUDA_OPS = ("all_reduce", "broadcast")

_gather = getattr(dist, "all_gather_single", None) or dist.all_gather_into_tensor


def group_size(group) -> int:
    return dist.get_world_size(group)


def group_rank(group) -> int:
    return dist.get_rank(group)


def backend_of(group) -> str:
    return str(dist.get_backend(group))


def _staged(group, device: torch.device, op: str) -> bool:
    """Whether ``op`` on a tensor on ``device`` goes through pinned host
    buffers on ``group``; raises for what neither backend takes."""
    backend = backend_of(group)
    if backend == "nccl":
        if device.type != "cuda":
            raise ValueError(f"NCCL takes CUDA tensors, got one on {device}")
        return False
    if backend == "gloo":
        return device.type == "cuda" and op not in GLOO_CUDA_OPS
    raise ValueError(f"no collective route for backend {backend!r}")


def staging(group, device) -> dict:
    """The route of each op on ``group`` for tensors on ``device``:
    {op: 'direct' or 'pinned host'}."""
    device = torch.device(device)
    return {op: "pinned host" if _staged(group, device, op) else "direct"
            for op in ("all_reduce", "all_gather", "send/recv")}


def _to_host(x: torch.Tensor) -> torch.Tensor:
    h = torch.empty(x.shape, dtype=x.dtype, pin_memory=True)
    h.copy_(x)
    return h


def all_reduce_sum(x: torch.Tensor, group) -> torch.Tensor:
    """``psum``: the sum of ``x`` over the group's ranks, in place (both
    backends take it on the card, never staged); returns x."""
    dist.all_reduce(x, group=group)
    return x


def all_reduce_max(x: torch.Tensor, group) -> torch.Tensor:
    """The maximum of ``x`` over the group's ranks, in place; returns x."""
    dist.all_reduce(x, op=dist.ReduceOp.MAX, group=group)
    return x


def all_gather_rows(x: torch.Tensor, group) -> torch.Tensor:
    """The tiled ``all_gather`` along the leading dimension: every rank's
    ``x`` (equal shapes), stacked in rank order, (size, *x.shape)."""
    size = group_size(group)
    x = x.contiguous() if x.dim() else x.reshape(1)
    shape = (size * x.shape[0],) + tuple(x.shape[1:])  # the concatenation the op fills
    if _staged(group, x.device, "all_gather"):
        out = torch.empty(shape, dtype=x.dtype, pin_memory=True)
        _gather(out, _to_host(x), group=group)
        out = out.to(x.device)
    else:
        out = torch.empty(shape, dtype=x.dtype, device=x.device)
        _gather(out, x, group=group)
    return out.view((size,) + tuple(x.shape))


def all_gather_cols(x: torch.Tensor, group) -> torch.Tensor:
    """Every rank's ``x`` (rows, k) put side by side in rank order:
    (rows, size·k), the tiled gather along the last dimension."""
    g = all_gather_rows(x, group)  # (size, rows, k)
    if x.shape[0] == 1:
        return g.reshape(1, -1)
    return g.permute(1, 0, 2).reshape(x.shape[0], -1)


def exchange(sends, recvs, group) -> None:
    """``ppermute``: post every (tensor, group rank, tag) of ``sends`` and
    ``recvs`` together (``batch_isend_irecv``) and wait for all of them.
    The received tensors are written in place. A transfer to the rank
    itself is a copy. NCCL pairs a rank's k-th send to a peer with that
    peer's k-th receive from it, gloo by the tag too: every rank posts its
    transfers in the same order."""
    me = group_rank(group)
    ops, back = [], []
    local = [s for s in sends if s[1] == me]
    for (buf, peer, tag) in recvs:
        if peer == me:
            src = next(s for s in local if s[2] == tag)
            buf.copy_(src[0])
    for kind, items in ((dist.isend, sends), (dist.irecv, recvs)):
        for (t, peer, tag) in items:
            if peer == me:
                continue
            if not _staged(group, t.device, "send/recv"):
                buf = t
            elif kind is dist.isend:
                buf = _to_host(t)
            else:
                buf = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
                back.append((t, buf))
            ops.append(dist.P2POp(kind, buf, dist.get_global_rank(group, peer), group=group,
                                  tag=tag))
    if ops:
        for work in dist.batch_isend_irecv(ops):
            work.wait()
    for t, h in back:
        t.copy_(h)
