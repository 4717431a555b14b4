"""Distributed multifrontal solve: each stage's factor stacks split over the
ranks of a ``space`` process group.

The counterpart of ``flowcontrol_tpu/parallel/mf_sharded.py``: the
nested-dissection direct solve (``solvers/multifrontal.py``) as a
distributed execution, the analogue of the reference's MPI domain
decomposition (dolfin partitions the mesh across ranks and MUMPS factors
and solves distributed; ref: src/flowcontrol/flowsolver.py:236-238). Each
rank holds an equal slice of every stage's stacks, so the resident factor
bytes a rank are O(total/n_dev).

Built on the port's own stage layout (``MFStage``: a work vector in
stage-slot order, a contribution buffer, pull-form inbox tables; not the
JAX package's transposed-scatter tables). Two modes a stage, chosen at
build, as in the JAX package:

- node mode (m >= n_dev): rank d holds the contiguous node slice
  [d·m_loc, (d + 1)·m_loc) of ``inv``, ``ginv`` and ``fbi`` (m_loc =
  ceil(m / n_dev), the last slices padded with zero nodes). Forward: P1
  subtracts the slice's inbox sums (its columns of the stage's inbox
  tables), K2 makes z = inv·xe and the slice's boundary updates fbi·z.
  The inbox is pull-form: every contribution has one slot of the buffer,
  so the ranks' update slices are put together by ``all_gather``, not
  summed (the JAX package's push-form scatter needs a ``psum``). Backward:
  P1 gathers the slice's boundary, K2 makes ginv·x[bd], and one
  ``all_gather`` rebuilds the stage's block of x.
- row mode (m < n_dev, the top fronts): rank d holds a slice of the
  flattened factor's rows; a row slice of one node's stack is a K2 call
  with m = 1. Every rank makes the stage's full inbox sums and boundary
  gather (P1 on the replicated vectors), then its rows, and ``all_gather``
  rebuilds z, the updates and the backward correction.

The work vectors and the contribution buffer stay whole on every rank
(O(n), small beside the factors); a rank's rows are its slice of a
``batch`` group's batch. Kernel F (``ops/mf_fused.py``, the whole solve in
one launch) cannot run here: each stage needs a collective before the next.

Accounting as in the JAX package: ``total_factor_bytes`` sums the padded
slices (node mode m_pad·(e² + 2·e·b), row mode the rows padded to a
multiple of n_dev), ``per_device_factor_bytes`` is a rank's share of it,
exactly what it holds. The stage shapes are the JAX package's, so both
numbers equal the JAX package's for the same factor and n_dev.
``per_device_index_bytes`` counts this port's index tables a rank holds
(the P1 tables of its slices and the replicated ones of the row-mode
stages and the permutations). The JAX package refuses a factor whose
stacks are not in its canonical layout (``layout != 'ij'``); the port's
factor has one layout, so there is nothing to refuse.
"""

from __future__ import annotations

import numpy as np
import torch

from flowcontrol_tpu_torch.ops.mf_matvec import (
    GatherPlan,
    gather_descriptors,
    stack_matvec,
    sweep_gather,
)
from flowcontrol_tpu_torch.parallel import comm


def _round4(x: int) -> int:
    return -(-x // 4) * 4


def _row_pieces(r0: int, r1: int, per_node: int):
    """The global rows [r0, r1) of a flattened (m·per_node, k) stack cut at
    node boundaries: (node, first local row, end local row) each, local rows
    counted from r0."""
    out, r = [], r0
    while r < r1:
        k = r // per_node
        end = min(r1, (k + 1) * per_node)
        out.append((k, r - r0, end - r0))
        r = end
    return out


class ShardedMultifrontal:
    """A factored :class:`MultifrontalLU`'s stages split over ``group``.

    The rank copies its slices out of ``mf`` at build and keeps none of
    ``mf``'s stacks: once the caller drops ``mf``, the whole factor leaves
    the device and the rank holds ``per_device_factor_bytes``. ``solve``
    takes (..., n) right-hand sides (this rank's batch rows), the same on
    every rank of ``group``, and returns x on every rank."""

    def __init__(self, mf, group):
        n_dev, d = comm.group_size(group), comm.group_rank(group)
        self.group, self.n_dev, self.rank = group, n_dev, d
        self.n, self.total = mf.n, mf.total_slots
        self.dtype, self.device = mf.dtype, mf.device
        self.work_slots, self.total_contrib = mf.work_slots, mf.total_contrib
        self.p1_entry, self.p1_exit = mf.p1_entry, mf.p1_exit
        item = torch.empty((), dtype=mf.dtype).element_size()

        stacks, tables, launches, self._stages = [], [], [], []
        n_stack = n_tab = 0
        sharded_bytes = 0
        index_bytes = sum(t.numel() * t.element_size()
                          for t in (mf.p1_entry.tables, mf.p1_entry.desc, mf.p1_exit.desc))

        def put_stack(host_rows: np.ndarray) -> tuple[int, tuple]:
            nonlocal n_stack
            o = n_stack
            stacks.append((o, host_rows))
            n_stack += -(-host_rows.size // 64) * 64  # 256-byte aligned, as mf's
            return o, host_rows.shape

        def put_table(a: np.ndarray) -> int:
            nonlocal n_tab
            o = n_tab
            tables.append((o, a))
            n_tab += _round4(a.size)  # 16-byte aligned, as P1 reads it
            return o

        for st in mf.stages:
            e, b, m = st.e, st.b, st.m
            inv, ginv, fbi = (s.cpu().numpy() for s in (st.inv, st.ginv, st.fbi))
            rec = dict(e=e, b=b, m=m, off=st.off, c_off=st.c_off)
            if m >= n_dev:
                m_loc = -(-m // n_dev)
                a, c = min(d * m_loc, m), min((d + 1) * m_loc, m)
                rec.update(mode="node", m_loc=m_loc, a=a, c=c)
                for name, src in (("inv", inv), ("ginv", ginv), ("fbi", fbi)):
                    loc = np.zeros((m_loc,) + src.shape[1:], dtype=src.dtype)
                    loc[: c - a] = src[a:c]
                    rec[name] = put_stack(loc)
                sharded_bytes += n_dev * m_loc * (e * e + 2 * e * b) * item
                # the slice's columns of each tabbed inbox segment, and its
                # rows of the boundary table
                segs, ti = [], 0
                host_inbox = [t.cpu().numpy() for t in st.inbox]
                for (m0, m1, tabbed) in st.segs:
                    if not tabbed:
                        continue
                    t = host_inbox[ti]
                    ti += 1
                    lo, hi = max(a, m0), min(c, m1)
                    if lo >= hi:
                        continue
                    cols = np.ascontiguousarray(t[:, (lo - m0) * e: (hi - m0) * e])
                    segs.append(((lo - a) * e, (hi - lo) * e, cols.shape[0], put_table(cols)))
                rec["inbox_plan"] = len(launches) if segs else None
                if segs:
                    launches.append(dict(segs=segs, sub=True))
                rec["bd_plan"] = None
                if c > a:
                    bd = np.ascontiguousarray(st.bd32[a:c].cpu().numpy().reshape(-1))
                    rec["bd_plan"] = len(launches)
                    launches.append(dict(segs=[(0, bd.size, 1, put_table(bd))], sub=False))
            else:
                r_loc, u_loc = -(-m * e // n_dev), -(-m * b // n_dev)
                rec.update(mode="row", r_loc=r_loc, u_loc=u_loc)
                r0, r1 = min(d * r_loc, m * e), min((d + 1) * r_loc, m * e)
                q0, q1 = min(d * u_loc, m * b), min((d + 1) * u_loc, m * b)
                for name, src, k, lo, hi, n_loc in (
                        ("inv", inv.reshape(m * e, e), e, r0, r1, r_loc),
                        ("ginv", ginv.reshape(m * e, b), b, r0, r1, r_loc),
                        ("fbi", fbi.reshape(m * b, e), e, q0, q1, u_loc)):
                    loc = np.zeros((n_loc, k), dtype=src.dtype)
                    loc[: hi - lo] = src[lo:hi]
                    rec[name] = put_stack(loc)
                rec["z_pieces"] = _row_pieces(r0, r1, e)
                rec["u_pieces"] = _row_pieces(q0, q1, b)
                sharded_bytes += n_dev * (r_loc * (e + b) + u_loc * e) * item
                # the stage's full inbox sums and boundary gather (replicated)
                rec["inbox_full"], rec["bd_full"] = st.p1_inbox, st.p1_bd
                for plan in (st.p1_inbox, st.p1_bd):
                    if plan is not None:
                        index_bytes += sum(plan.table(i).numel() * 4 for i in range(len(plan.segs)))
            self._stages.append(rec)

        # this rank's slices and tables, on the device
        flat = torch.zeros(n_stack, dtype=self.dtype, device=self.device)
        for o, a in stacks:
            flat[o: o + a.size] = torch.as_tensor(a.reshape(-1), dtype=self.dtype)
        self.flat_stacks = flat
        tab = np.zeros(max(n_tab, 4), dtype=np.int32)
        for o, a in tables:
            tab[o: o + a.size] = a.reshape(-1)
        self._tables = torch.as_tensor(tab, device=self.device)
        rows = [gather_descriptors(launch["segs"]) for launch in launches]
        desc = (np.concatenate([r for r, _ in rows]) if rows
                else np.zeros((0, 5), dtype=np.int32))
        self._desc = torch.as_tensor(desc, device=self.device)
        plans, r0 = [], 0
        for launch, (_, tiles) in zip(launches, rows):
            plans.append(GatherPlan(desc=self._desc[r0: r0 + len(launch["segs"])],
                                    tables=self._tables, segs=tuple(launch["segs"]),
                                    sub=launch["sub"], n_tiles=tiles))
            r0 += len(launch["segs"])
        index_bytes += self._tables.numel() * 4 + self._desc.numel() * 4
        for rec in self._stages:
            for name in ("inv", "ginv", "fbi"):
                o, shape = rec[name]
                rec[name] = flat[o: o + int(np.prod(shape))].view(shape)
            if rec["mode"] == "node":
                rec["inbox_plan"] = None if rec["inbox_plan"] is None else plans[rec["inbox_plan"]]
                rec["bd_plan"] = None if rec["bd_plan"] is None else plans[rec["bd_plan"]]

        #: resident factor bytes a rank (exactly what its slices hold), their
        #: sum over the ranks, and the index tables a rank holds
        self.total_factor_bytes = sharded_bytes
        self.per_device_factor_bytes = sharded_bytes // n_dev
        self.per_device_index_bytes = int(index_bytes)
        held = sum(rec[k].numel() for rec in self._stages for k in ("inv", "ginv", "fbi")) * item
        if held != self.per_device_factor_bytes:
            raise AssertionError(f"rank holds {held} factor bytes, accounts "
                                 f"{self.per_device_factor_bytes}")
        #: collectives of one solve (all_gather each)
        self.gathers_per_solve = sum(
            (2 if rec["mode"] == "node" else 3) for rec in self._stages) - 1

    @property
    def factor_bytes(self) -> int:
        """This rank's factor bytes on the device."""
        return self.per_device_factor_bytes

    def launches_per_solve(self) -> tuple[int, int]:
        """(K2, P1) launches of one solve on this rank. Node mode, where the
        slice holds nodes: K2 for z, for the updates (not the root's) and
        for the backward correction, P1 for the slice's inbox columns and
        its boundary gather. Row mode: one K2 per node piece of the rank's
        rows for z and for the correction, and per piece of its update rows
        (not the root's), P1 for the stage's whole inbox and boundary
        gather. P1 once each for the entry and exit permutations. A K2 with
        no boundary columns, or a P1 plan with no tiles, launches nothing."""
        def p1(plan) -> int:
            return int(plan is not None and plan.n_tiles > 0)

        k2, n_p1 = 0, 2
        last = len(self._stages) - 1
        for si, s in enumerate(self._stages):
            fwd_upd, bd = si < last, s["b"] > 0
            if s["mode"] == "node":
                if s["c"] > s["a"]:
                    k2 += 1 + (fwd_upd and bd) + bd
                n_p1 += p1(s["inbox_plan"]) + p1(s["bd_plan"])
            else:
                z = len(s["z_pieces"])
                k2 += z * (1 + bd) + fwd_upd * len(s["u_pieces"])
                n_p1 += p1(s["inbox_full"]) + p1(s["bd_full"])
        return k2, n_p1

    def solve(self, b: torch.Tensor) -> torch.Tensor:
        """x = A^-1 b for b (..., n): the per-stage sweep of
        ``solvers/multifrontal.multifrontal_solve`` with this rank's slice of
        each stage and one ``all_gather`` over the group where the next
        stage needs the others' slices."""
        group = self.group
        batch = b.shape[:-1]
        n, dtype = self.n, self.dtype
        out_dtype = b.dtype if b.dtype in (torch.float32, torch.float64) else dtype
        rows = 1
        for k in batch:
            rows *= int(k)
        bb = b.reshape(rows, n).to(dtype)
        dev = bb.device
        xs = self.work_slots
        x = sweep_gather(self.p1_entry, bb, out=torch.empty((rows, xs), dtype=dtype, device=dev))
        z = torch.empty((rows, xs), dtype=dtype, device=dev)
        buf = torch.empty((rows, 1 + self.total_contrib), dtype=dtype, device=dev)
        buf[:, :1].zero_()

        last = len(self._stages) - 1
        for si, s in enumerate(self._stages):
            e, b_, m, off = s["e"], s["b"], s["m"], s["off"]
            c0 = 1 + s["c_off"]
            if s["mode"] == "node":
                a, c, m_loc = s["a"], s["c"], s["m_loc"]
                xe = x[:, off + a * e: off + c * e]
                if s["inbox_plan"] is not None:
                    sweep_gather(s["inbox_plan"], buf, xe=xe, out=xe)
                ze = z[:, off + a * e: off + c * e].view(rows, c - a, e)
                if c > a:
                    stack_matvec(s["inv"][: c - a], xe.view(rows, c - a, e), out=ze)
                if si < last:
                    upd = torch.zeros((rows, m_loc * b_), dtype=dtype, device=dev)
                    if c > a:
                        stack_matvec(s["fbi"][: c - a], ze,
                                     out=upd[:, : (c - a) * b_].view(rows, c - a, b_))
                    buf[:, c0: c0 + m * b_] = comm.all_gather_cols(upd, group)[:, : m * b_]
            else:
                xe = x[:, off: off + m * e]
                if s["inbox_full"] is not None:
                    sweep_gather(s["inbox_full"], buf, xe=xe, out=xe)
                zl = torch.zeros((rows, s["r_loc"]), dtype=dtype, device=dev)
                for (k, l0, l1) in s["z_pieces"]:
                    stack_matvec(s["inv"][l0:l1].view(1, l1 - l0, e),
                                 xe[:, k * e: (k + 1) * e].view(rows, 1, e),
                                 out=zl[:, l0:l1].view(rows, 1, l1 - l0))
                z[:, off: off + m * e] = comm.all_gather_cols(zl, group)[:, : m * e]
                if si < last:
                    ul = torch.zeros((rows, s["u_loc"]), dtype=dtype, device=dev)
                    for (k, l0, l1) in s["u_pieces"]:
                        stack_matvec(s["fbi"][l0:l1].view(1, l1 - l0, e),
                                     z[:, off + k * e: off + (k + 1) * e].view(rows, 1, e),
                                     out=ul[:, l0:l1].view(rows, 1, l1 - l0))
                    buf[:, c0: c0 + m * b_] = comm.all_gather_cols(ul, group)[:, : m * b_]

        for s in reversed(self._stages):
            e, b_, m, off = s["e"], s["b"], s["m"], s["off"]
            if s["mode"] == "node":
                a, c, m_loc = s["a"], s["c"], s["m_loc"]
                xl = torch.zeros((rows, m_loc * e), dtype=dtype, device=dev)
                if c > a:
                    xb = sweep_gather(s["bd_plan"], x)  # ancestor slots are final
                    corr = stack_matvec(s["ginv"][: c - a], xb.view(rows, c - a, b_))
                    torch.sub(z[:, off + a * e: off + c * e], corr.reshape(rows, (c - a) * e),
                              out=xl[:, : (c - a) * e])
                x[:, off: off + m * e] = comm.all_gather_cols(xl, group)[:, : m * e]
            else:
                xb = sweep_gather(s["bd_full"], x)
                cl = torch.zeros((rows, s["r_loc"]), dtype=dtype, device=dev)
                for (k, l0, l1) in s["z_pieces"]:
                    stack_matvec(s["ginv"][l0:l1].view(1, l1 - l0, b_),
                                 xb[:, k * b_: (k + 1) * b_].view(rows, 1, b_),
                                 out=cl[:, l0:l1].view(rows, 1, l1 - l0))
                corr = comm.all_gather_cols(cl, group)[:, : m * e]
                torch.sub(z[:, off: off + m * e], corr, out=x[:, off: off + m * e])

        return sweep_gather(self.p1_exit, x).reshape(batch + (n,)).to(out_dtype)
