"""Multifrontal direct solver: nested dissection with dense frontal
matrices, factored once on the host in f64, solved on one device.

The counterpart of ``flowcontrol_tpu/solvers/multifrontal.py``. It replaces
the reference's MUMPS solve (ref: src/flowcontrol/flowsolver.py:812-814)
past the size where one dense factor fits the device: factor storage is
~Σ sep² + n·leaf instead of n², because separators shrink with tree depth.

- ORDERING (host): recursive bisection by single BFS graph-level separators
  (a dof in level l couples only l±1, so one level disconnects its sides —
  see ``solvers/tridiag.graph_levels``), trimmed to the vertices that couple
  both sides, small nodes merged into their parents.
- FACTORIZATION (host, f64): classic multifrontal postorder with delayed
  pivoting; each node stores its pivoted inverse ``inv``, the composed
  operator ``ginv = inv·F_ib`` and ``F_bi``, rounded once to the store
  dtype. Nodes are grouped into stages (one tree depth each, regrouped by a
  penalty DP) and padded into stacks.
- SOLVE (device): one forward and one backward sweep over the stages,
  deepest first, on a preallocated work vector in stage-slot order and a
  contribution buffer. P1 (:func:`sweep_gather`) makes every gather of the
  sweep: the entry permutation, each stage's inbox sums (one launch over
  its segments) and boundary gather, the exit permutation; K2
  (:func:`stack_matvec`) the products ``inv·xe``, ``fbi·z`` and
  ``ginv·xb``. On CUDA, up to ``FUSED_MAX_ROWS`` right-hand sides take
  kernel F instead (``ops/mf_fused.py``): the whole solve in one launch,
  walking a stage descriptor array over the same stacks and tables.

The host half is transcribed from the JAX package and gives bitwise the
same tree, stacks and tables. Not carried over: the disk factor cache and
its streaming warm load (ROADMAP.md, "The rest of the multifrontal
solve"); the TPU A/B knobs ``layout='ji'`` and ``einsum`` and the
concat-growth sweep, which exist for XLA's relayout copies on the TPU
(replaced: one dataflow, results written in place); ``FC_MF_PACK=bucket``
and ``FC_MF_INBOX=full`` (still to port).
"""

from __future__ import annotations

import logging
import time
from dataclasses import dataclass, field

import numpy as np
import scipy.linalg as sla
import torch

from flowcontrol_tpu_torch.ops.mf_fused import (
    HEAD_FIELDS,
    MAX_SEGS,
    SEG_FIELDS,
    STAGE_WORDS,
    multifrontal_solve_fused,
)
from flowcontrol_tpu_torch.ops.mf_matvec import (
    GatherPlan,
    gather_descriptors,
    stack_matvec,
    sweep_gather,
)
from flowcontrol_tpu_torch.solvers.tridiag import graph_levels

logger = logging.getLogger(__name__)

#: most right-hand sides a solve on CUDA sends through kernel F (one launch
#: for the whole solve); wider batches take the per-stage sweep, whose K2
#: reads each factor stack once per 8 right-hand sides
FUSED_MAX_ROWS = 8


@dataclass
class _Node:
    elim: np.ndarray  # global dof ids eliminated at this node
    children: list = field(default_factory=list)
    depth: int = 0
    bd: np.ndarray | None = None  # exterior neighbors of the subtree
    delayed: np.ndarray | None = None  # pivots passed up to the parent


def _bincount_levels(level):
    return np.bincount(level[level >= 0])


def _choose_separator(level: np.ndarray, counts: np.ndarray,
                      window: int = 6):
    """Separator = the smallest level near the dof-count median (cut where
    the front is thin), subject to a balance guarantee: unbalanced splits
    recurse deep and fragment the stage structure."""
    n_lvl = len(counts)
    csum = np.cumsum(counts)
    total = csum[-1]
    mid = int(np.searchsorted(csum, total / 2))
    mid = min(max(mid, 1), n_lvl - 2)
    lo = max(1, mid - window)
    hi = min(n_lvl - 1, mid + window + 1)
    cand = np.arange(lo, hi)
    if len(cand):
        left = csum[cand - 1]
        right = total - csum[cand]
        ok = np.minimum(left, right) >= 0.25 * total
        if ok.any():
            cand = cand[ok]
            return int(cand[np.argmin(counts[cand])])
    return mid


def build_nd_tree(g, coords: np.ndarray, dofs: np.ndarray,
                  leaf_max: int = 1536, depth: int = 0,
                  trim_passes: int = 4) -> _Node:
    """Recursive nested-dissection tree over ``dofs`` (global ids).

    ``g`` is the symmetrized global pattern (CSR). Separators are single
    BFS levels of the induced subgraph, seeded along each coordinate axis;
    the smaller of the two is kept.
    """
    if len(dofs) <= leaf_max or depth >= 40:
        return _Node(elim=np.sort(dofs), depth=depth)
    sub = g[dofs][:, dofs].tocsr()  # g symmetric -> sub symmetric
    c = coords[dofs]
    # try BOTH axes and keep the smaller separator: geometric extent is a
    # bad proxy on graded/anisotropic meshes
    best = None
    for axis in (0, 1):
        level = graph_levels(sub, c, axis=axis, g=sub)
        counts = _bincount_levels(level)
        if len(counts) < 5:
            continue
        si = _choose_separator(level, counts)
        if best is None or counts[si] < best[0]:
            best = (int(counts[si]), level, si)
    if best is None:
        logger.warning(
            "multifrontal: unsplittable tile of %d dofs at depth %d — "
            "oversized leaf", len(dofs), depth,
        )
        return _Node(elim=np.sort(dofs), depth=depth)
    _, level, s = best
    # TRIM the level separator: any level-s vertex with no neighbor strictly
    # on one side can move to the other side without connecting left and
    # right. Factor content is ~sum(sep^2), so thinner separators cut factor
    # bytes directly.
    side = np.sign(level - s).astype(np.int8)  # -1 left, 0 sep, +1 right
    for _ in range(trim_passes):
        sep_loc = np.where(side == 0)[0]
        if not len(sep_loc):
            break
        moved = 0
        for v in sep_loc:
            nbrs = sub.indices[sub.indptr[v]: sub.indptr[v + 1]]
            sn = side[nbrs]
            has_l = (sn < 0).any()
            has_r = (sn > 0).any()
            if not has_r:
                side[v] = -1  # only-left couplings: join the left side
                moved += 1
            elif not has_l:
                side[v] = 1
                moved += 1
        if not moved:
            break
    left = dofs[side < 0]
    right = dofs[side > 0]
    sep = dofs[side == 0]
    if not len(left) or not len(right):
        return _Node(elim=np.sort(dofs), depth=depth)
    if not len(sep):
        # fully trimmed away (no crossing edges): keep one vertex as the
        # node's elim so every tree node eliminates something — moving a
        # no-right-neighbor vertex up is always separator-safe
        sep, left = left[:1], left[1:]
        if not len(left):
            return _Node(elim=np.sort(dofs), depth=depth)
    node = _Node(elim=np.sort(sep), depth=depth)
    node.children = [
        build_nd_tree(g, coords, left, leaf_max, depth + 1, trim_passes),
        build_nd_tree(g, coords, right, leaf_max, depth + 1, trim_passes),
    ]
    return node


def _merge_small_nodes(v: _Node, min_elim: int = 192):
    """Collapse nodes with tiny elim sets into their parent (the parent
    adopts the grandchildren): fewer, fatter stages."""
    new_children = []
    for c in v.children:
        _merge_small_nodes(c, min_elim)
        if len(c.elim) < min_elim:
            v.elim = np.sort(np.concatenate([v.elim, c.elim]))
            new_children.extend(c.children)
        else:
            new_children.append(c)
    v.children = new_children


def _set_depths(v: _Node, depth: int = 0):
    v.depth = depth
    for c in v.children:
        _set_depths(c, depth + 1)


def _annotate_boundaries(g, root: _Node):
    """bd(v) = exterior neighbors of subtree(v) — by the separator
    property these are exactly ancestor elim dofs. Bottom-up pass."""

    def visit(v) -> np.ndarray:  # returns subtree dof set (sorted)
        if not v.children:
            sub = v.elim
        else:
            parts = [visit(c) for c in v.children] + [v.elim]
            sub = np.sort(np.concatenate(parts))
        nbrs = np.unique(g[sub].indices)
        v.bd = np.setdiff1d(nbrs, sub, assume_unique=False)
        return sub

    visit(root)
    return root


def _postorder(root: _Node):
    out = []

    def rec(v):
        for c in v.children:
            rec(c)
        out.append(v)

    rec(root)
    return out


@dataclass
class MFStage:
    """One stage on the device: its stacks, index tables and static shape.

    ``inv`` (m, e, e), ``ginv`` (m, e, b), ``fbi`` (m, b, e) in the store
    dtype; ``bd`` (m, b) int64 absolute work-vector slots of the boundary
    (pads -> the trailing zero slot), ``bd32`` the same in int32; ``inbox``
    one int32 table (kmax, (m1 - m0)·e) per tabbed segment, positions in
    the contribution buffer (pads -> its leading zero); ``segs`` the
    (m0, m1, tabbed) node segments. P1's launches: ``p1_inbox`` the inbox
    sums over every tabbed segment (None without one; output columns from
    the stage's first slot), ``p1_bd`` the boundary gather."""

    e: int
    b: int
    m: int
    off: int  # first work-vector slot of the stage
    c_off: int  # first contribution-buffer position (after the leading zero)
    segs: tuple
    inv: torch.Tensor
    ginv: torch.Tensor
    fbi: torch.Tensor
    bd: torch.Tensor
    inbox: tuple
    # set by MultifrontalLU._finalize_p1
    bd32: torch.Tensor | None = None
    p1_inbox: GatherPlan | None = None
    p1_bd: GatherPlan | None = None


class MultifrontalLU:
    """Factor once on the host (f64); solve many on ``device``.

    ``solve`` takes (..., n) right-hand sides. ``timings`` holds the host
    set-up split in seconds; ``solve_err`` the measured per-solve error of
    the rounded factors and ``recommended_refine`` the refinement sweeps it
    calls for (0 or 1).
    """

    #: per-solve relative-error ceiling (measured by _measure_solve_err)
    #: below which the f32 factors stay in the zero-refinement-sweep
    #: trajectory class (the JAX package's calibration, kept as is)
    ZERO_SWEEP_ERR = 8e-4

    #: stage overhead, in bytes of factor read, that the DP repack prices
    #: against padding (the JAX package's default)
    LAM_BYTES = 8 * 2**20

    def __init__(self, a_csr, coords: np.ndarray, device,
                 dtype: torch.dtype = torch.float32, leaf_max: int = 1536):
        a_csr = a_csr.tocsr()
        n = a_csr.shape[0]
        self.n = n
        self.leaf_max = int(leaf_max)
        self.device = torch.device(device)
        self.dtype = dtype
        np_store = np.dtype(str(dtype).removeprefix("torch."))
        self.timings: dict[str, float] = {}
        t_all = t0 = time.perf_counter()
        payload = self._factorize(a_csr, coords, self.leaf_max, np_store)
        self.timings["ordering+factorization"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        # penalty-DP regrouping of each depth's nodes, then the nodes of
        # every stage sorted by inbox load (segmented inbox gathers)
        payload = _repack_dp(payload, n, lam_bytes=self.LAM_BYTES)
        payload = _sort_nodes_by_inbox_load(payload, n)
        self.timings["repack"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        self.solve_err = _measure_solve_err(a_csr, payload, n)
        self.timings["measure_err"] = time.perf_counter() - t0
        logger.info("multifrontal: measured per-solve error %.2e (store dtype %s)",
                    self.solve_err, np_store.name)
        t0 = time.perf_counter()
        tables = self._build_tables(payload)
        self.timings["tables"] = time.perf_counter() - t0
        self.recommended_refine = (
            0 if 0 <= self.solve_err < self.ZERO_SWEEP_ERR
            or np.dtype(np_store) == np.float64
            else 1
        )
        t0 = time.perf_counter()
        self._finalize_device(tables, payload)
        self.timings["upload"] = time.perf_counter() - t0
        self.timings["total"] = time.perf_counter() - t_all
        logger.info("multifrontal: ready in %.1fs — %d stages, factor %.3f GB",
                    self.timings["total"], self.n_depths, self.factor_bytes / 1e9)

    # ── host factorization ──────────────────────────────────────────────────

    @staticmethod
    def _factorize(a_csr, coords, leaf_max, np_store):
        n = a_csr.shape[0]
        t0 = time.time()
        g = ((a_csr != 0) + (a_csr != 0).T).tocsr()
        root = build_nd_tree(g, coords, np.arange(n), leaf_max=leaf_max)
        _merge_small_nodes(root)
        _set_depths(root)
        _annotate_boundaries(g, root)
        nodes = _postorder(root)
        logger.info(
            "multifrontal: tree %.1fs — %d nodes, max depth %d, "
            "max elim %d, max bd %d", time.time() - t0, len(nodes),
            max(v.depth for v in nodes),
            max(len(v.elim) for v in nodes),
            max(len(v.bd) for v in nodes),
        )

        t0 = time.time()
        updates: dict[int, tuple[np.ndarray, np.ndarray]] = {}
        stats_flops = 0.0
        n_delayed = 0

        for v in nodes:
            # DELAYED PIVOTING: a frontal pivot block of an indefinite
            # (saddle-point) matrix can be singular even though A is not;
            # dofs whose pivot falls below threshold join the boundary and
            # are passed up into the parent's front, as MUMPS delays pivots
            delayed_in = (
                np.concatenate([c.delayed for c in v.children])
                if v.children else np.array([], dtype=np.int64)
            )
            elim = np.concatenate([v.elim, delayed_in.astype(np.int64)])
            bd_static = v.bd
            ids = np.concatenate([elim, bd_static])
            # assemble each ORIGINAL entry A[i,j] exactly once across the
            # tree: here iff i or j belongs to THIS node's tree-assigned
            # elim set (pre-delay). Everything else arrives via children.
            f = a_csr[ids][:, ids].toarray()
            own = np.isin(ids, v.elim)
            # ...and never for pairs involving a DELAYED dof: its original
            # row/col was assembled at its own (deeper) node
            dly = np.isin(ids, delayed_in)
            f *= (own[:, None] | own[None, :]) & ~(
                dly[:, None] | dly[None, :]
            )
            # position of any global id inside `ids` (ids is NOT sorted)
            order = np.argsort(ids, kind="stable")
            ids_sorted = ids[order]
            for c in v.children:
                bd_c, u_c = updates.pop(id(c))
                loc = order[np.searchsorted(ids_sorted, bd_c)]
                assert np.array_equal(ids[loc], bd_c)
                f[np.ix_(loc, loc)] += u_c

            # choose the eliminable subset of `elim`
            keep = np.arange(len(elim))
            scale = max(np.abs(f[: len(elim), : len(elim)]).max(), 1e-300)
            while True:
                ne = len(keep)
                if ne == 0:
                    break
                f_ii = f[np.ix_(keep, keep)]
                lu, piv = sla.lu_factor(f_ii, check_finite=False)
                du = np.abs(np.diag(lu))
                bad = np.where(du <= 1e-10 * scale)[0]
                if not len(bad):
                    break
                # drop the dependent columns (pivot order = column order
                # under partial pivoting) and retry
                keep = np.delete(keep, bad)
            if len(keep) == 0 and len(bd_static) == 0:
                raise np.linalg.LinAlgError(
                    "singular root front — matrix is singular"
                )
            delayed_mask = np.ones(len(elim), dtype=bool)
            delayed_mask[keep] = False
            v.delayed = elim[delayed_mask]
            n_delayed += len(v.delayed)
            elim_kept = elim[keep]
            bd_full = np.concatenate([v.delayed, bd_static])
            # reorder the front as [kept | delayed | static bd]
            sel = np.concatenate(
                [keep, np.where(delayed_mask)[0],
                 len(elim) + np.arange(len(bd_static))]
            )
            f = f[np.ix_(sel, sel)]
            ne = len(keep)
            inv_ii = (
                sla.lu_solve((lu, piv), np.eye(ne), check_finite=False)
                if ne else np.zeros((0, 0))
            )
            f_ib = f[:ne, ne:]
            f_bi = f[ne:, :ne]
            # the backward sweep applies inv_ii @ f_ib as ONE stored
            # operator (ginv), composed here in f64 and rounded once
            giv = inv_ii @ f_ib if ne else f_ib
            stats_flops += 2 * ne**3 / 3 + 2 * ne * ne * len(bd_full) * 2
            if len(bd_full):
                updates[id(v)] = (bd_full, f[ne:, ne:] - f_bi @ giv)
            else:
                updates[id(v)] = (bd_full, np.zeros((0, 0)))
            v.elim = elim_kept
            v.bd = bd_full
            v.inv_ii = inv_ii.astype(np_store)
            v.ginv = giv.astype(np_store)
            v.f_bi = f_bi.astype(np_store)
        if n_delayed:
            logger.info("multifrontal: %d delayed pivots", n_delayed)
        logger.info("multifrontal: numeric factorization %.1fs (%.1f Gflop)",
                    time.time() - t0, stats_flops / 1e9)

        # ── pack padded stacks: stages = (depth, size-bucket) groups ────────
        # execution order only needs children-before-parents, i.e. deeper
        # stages first (_repack_dp regroups these)
        grid = [128, 256, 512, 768, 1024, 1536, 2048, 3072, 4096, 6144,
                8192, 12288, 16384]

        def bucket(x: int) -> int:
            for gv in grid:
                if x <= gv:
                    return gv
            return x

        groups: dict[tuple, list] = {}
        for v in nodes:
            key = (v.depth, bucket(max(len(v.elim), 1)),
                   bucket(max(len(v.bd), 1)))
            groups.setdefault(key, []).append(v)
        stage_keys = sorted(groups, key=lambda k: (-k[0], k[1], k[2]))
        payload: dict[str, np.ndarray] = {}
        payload["depth_order"] = np.asarray([k[0] for k in stage_keys])
        for di, key in enumerate(stage_keys):
            group = groups[key]
            e_max = key[1]
            b_max = key[2]
            m = len(group)
            elim_idx = np.full((m, e_max), n, dtype=np.int64)
            bd_idx = np.full((m, b_max), n, dtype=np.int64)
            inv_ii = np.zeros((m, e_max, e_max), dtype=np_store)
            g_inv = np.zeros((m, e_max, b_max), dtype=np_store)
            f_bi = np.zeros((m, b_max, e_max), dtype=np_store)
            for i, v in enumerate(group):
                ne, nb = len(v.elim), len(v.bd)
                elim_idx[i, :ne] = v.elim
                bd_idx[i, :nb] = v.bd
                inv_ii[i, :ne, :ne] = v.inv_ii
                g_inv[i, :ne, :nb] = v.ginv
                f_bi[i, :nb, :ne] = v.f_bi
            payload[f"elim_{di}"] = elim_idx
            payload[f"bd_{di}"] = bd_idx
            payload[f"inv_{di}"] = inv_ii
            payload[f"ginv_{di}"] = g_inv
            payload[f"fbi_{di}"] = f_bi
        return payload

    def _build_tables(self, payload):
        """The scatter-free index tables of the sweep.

        The work vector is laid out in (stage, node, slot) order so each
        stage's eliminated block is contiguous. Forward-sweep updates flow
        through per-stage INBOX tables over a compact contribution buffer:
        every stage writes its boundary updates (m·b_max values) into its
        slice of one flat buffer, and a consuming stage gathers only the
        contributions addressed to its own elim slots. Nodes arrive sorted
        by descending inbox load (_sort_nodes_by_inbox_load), so each
        stage's table splits into a few per-load segments and the
        untargeted tail (every leaf stage) gathers nothing.
        """
        n = self.n
        depths = payload["depth_order"]
        self.n_depths = len(depths)

        # slot layout: stage si owns [offset_si, offset_si + m*e_max)
        offsets = []
        total = 0
        for di in range(self.n_depths):
            m, e_max = payload[f"elim_{di}"].shape
            offsets.append(total)
            total += m * e_max
        self.total_slots = total

        # global dof -> slot (each dof eliminated exactly once)
        slot_of = np.full(n + 1, total, dtype=np.int64)  # pad -> pad slot
        for di in range(self.n_depths):
            elim_idx = payload[f"elim_{di}"]  # (m, e_max), pad == n
            flat = elim_idx.reshape(-1)
            slots = offsets[di] + np.arange(flat.size)
            real = flat < n
            slot_of[flat[real]] = slots[real]
        # slot -> global dof (pad slots -> n, reading the appended zero)
        perm = np.full(total, n, dtype=np.int64)
        for di in range(self.n_depths):
            flat = payload[f"elim_{di}"].reshape(-1)
            perm[offsets[di]: offsets[di] + flat.size] = flat

        # contribution buffer layout: stage si's updates occupy
        # [c_off_si, c_off_si + m*b_max); dest slot of every contribution
        c_offsets = []
        total_contrib = 0
        dest_parts = []
        for di in range(self.n_depths):
            bd_idx = payload[f"bd_{di}"]
            bd_slots = slot_of[np.minimum(bd_idx, n)]  # (m, b_max)
            c_offsets.append(total_contrib)
            total_contrib += bd_slots.size
            dest_parts.append(bd_slots.reshape(-1))
        dest = np.concatenate(dest_parts) if dest_parts else np.zeros(0, int)
        self.total_contrib = total_contrib

        assert total < 2**31 - 1
        tables = {
            "n_depths": self.n_depths,
            "total": total,
            "total_contrib": total_contrib,
            "perm": perm.astype(np.int32),
            "ipos": slot_of[:n].astype(np.int32),
            "stages": [],   # per-stage dicts of host int32 index arrays
            "static": [],   # per-stage static tuples
        }
        table_bytes = 0
        for di in range(self.n_depths):
            elim_idx = payload[f"elim_{di}"]
            bd_idx = payload[f"bd_{di}"]
            bd_slots = slot_of[np.minimum(bd_idx, n)]  # (m, b_max)
            # INBOX: contribution positions addressed to this stage's slot
            # range, localized, stored transposed (kmax, width). Pad value
            # is total_contrib. Contributions to this stage only come from
            # deeper (already-executed) stages.
            width = elim_idx.size
            off = offsets[di]
            e_max_d = elim_idx.shape[1]
            m_d = elim_idx.shape[0]
            dloc = dest - off
            dloc = np.where((dest >= off) & (dloc < width), dloc, width)
            cnt = np.bincount(dloc[dloc < width], minlength=width)
            node_load = cnt.reshape(m_d, e_max_d).max(axis=1)
            segs = _inbox_segments(node_load)
            inbox_ts = []
            seg_static = []
            for (m0, m1, kcap) in segs:
                ln = (m1 - m0) * e_max_d
                if kcap == 0 or ln == 0:
                    seg_static.append((m0, m1, False))
                    continue
                lo = m0 * e_max_d
                dseg = dloc - lo
                dseg = np.where((dloc >= lo) & (dseg < ln), dseg, ln)
                tab = _table_skip_pads(dseg, ln)
                # zero-sentinel-at-0 convention: the buffer is
                # [zero | contributions], so real positions shift +1 and
                # pads point at the leading zero
                tab = np.where(tab >= len(dseg), 0, tab + 1)
                assert tab.max(initial=0) <= c_offsets[di]
                table_bytes += tab.nbytes // 2  # int32 on device
                inbox_ts.append(
                    np.ascontiguousarray(tab.T.astype(np.int32))
                )
                seg_static.append((m0, m1, True))
            # backward-sweep boundary gather: bd slots are always strict
            # ancestors' slots (later stages), final when this stage reads them
            real_bd = bd_slots < total
            assert (bd_slots[real_bd] >= off + elim_idx.size).all()
            tables["stages"].append({
                "bd": bd_slots.astype(np.int32),
                "inbox_ts": tuple(inbox_ts),
            })
            tables["static"].append(
                (elim_idx.shape[1], bd_idx.shape[1], elim_idx.shape[0],
                 offsets[di], c_offsets[di], tuple(seg_static))
            )
        logger.info(
            "multifrontal: %d contributions, inbox tables %.1f MB",
            total_contrib, table_bytes / 2**20,
        )
        return tables

    def _finalize_device(self, tables, payload):
        """Put the permutations, the index tables and the payload's factor
        stacks (one layout, the canonical one) on ``self.device``.

        Every stage's ``inv``, ``ginv`` and ``fbi`` is a view of one flat
        float allocation (``flat_stacks``), its ``bd`` a view of one flat
        int64 table (``flat_bd``) and its inbox tables views of one flat
        int32 table (``flat_inbox``): the per-stage sweep and kernel F read
        the same bytes. ``desc`` is F's stage descriptor array
        (``ops/mf_fused.py``: ``STAGE_WORDS`` int64 words per stage).

        The per-stage sweep's P1 launches read ``p1_desc`` (their segment
        descriptors, ``ops/mf_matvec.gather_descriptors``), the inbox tables
        and ``p1_tables``: int32 copies of the entry permutation over the
        work vector's ``work_slots`` slots (pads -> n, read as zero), of
        ``ipos`` and of every stage's ``bd``, each 16-byte aligned."""
        dev = self.device
        self.n_depths = int(tables["n_depths"])
        self.total_slots = int(tables["total"])
        self.total_contrib = int(tables["total_contrib"])

        def idx(a, dt=torch.int64):
            return torch.as_tensor(np.ascontiguousarray(a), dtype=dt, device=dev)

        # slot -> dof, with one more slot (-> n) for the work vector's
        # trailing zero
        self.perm = idx(np.append(tables["perm"], self.n))
        self.ipos = idx(tables["ipos"])

        # host layout of the flat arrays: element offsets of every piece
        # (stacks aligned to 64 floats, so each starts 256-byte aligned)
        statics = []
        n_stack = n_bd = n_inbox = 0
        for di, (st_h, stat) in enumerate(zip(tables["stages"], tables["static"])):
            e, b, m, off, c_off = (int(v) for v in stat[:5])
            segs = tuple((int(m0), int(m1), bool(f)) for (m0, m1, f) in stat[5])
            o_stack = []
            for size in (m * e * e, m * e * b, m * b * e):  # inv, ginv, fbi
                o_stack.append(n_stack)
                n_stack += -(-size // 64) * 64
            o_bd, n_bd = n_bd, n_bd + m * b
            seg_rec, ti = [], 0
            for (m0, m1, tabbed) in segs:
                kmax = 0
                o_ib = 0
                if tabbed:
                    # the host table has one trailing column for the
                    # segment's pad row; the sweep reads the first (m1-m0)·e
                    kmax = st_h["inbox_ts"][ti].shape[0]
                    o_ib, n_inbox = n_inbox, n_inbox + kmax * (m1 - m0) * e
                    ti += 1
                seg_rec.append((m0, m1, int(tabbed), o_ib, kmax))
            statics.append((e, b, m, off, c_off, segs, o_stack, o_bd, seg_rec))
        dt = self.dtype
        self.flat_stacks = torch.zeros(n_stack, dtype=dt, device=dev)
        self.flat_bd = torch.empty(n_bd, dtype=torch.int64, device=dev)
        self.flat_inbox = torch.empty(n_inbox, dtype=torch.int32, device=dev)

        desc = np.zeros((self.n_depths, STAGE_WORDS), dtype=np.int64)
        # slots some stage's bd holds (the trailing pad slot aside): a stage
        # with none of them is a leaf stage for kernel F
        held = np.zeros(self.total_slots + 1, dtype=bool)
        for st_h in tables["stages"]:
            held[st_h["bd"]] = True
        held[self.total_slots] = False
        self.stages: list[MFStage] = []
        for di, (st_h, s) in enumerate(zip(tables["stages"], statics)):
            e, b, m, off, c_off, segs, o_stack, o_bd, seg_rec = s
            if len(seg_rec) > MAX_SEGS:
                raise ValueError(f"stage {di} has {len(seg_rec)} inbox segments, F takes "
                                 f"{MAX_SEGS}")
            views = []
            for o, name, shape in zip(o_stack, ("inv", "ginv", "fbi"),
                                      ((m, e, e), (m, e, b), (m, b, e))):
                v = self.flat_stacks[o: o + m * shape[1] * shape[2]].view(shape)
                v.copy_(torch.as_tensor(payload[f"{name}_{di}"]))
                views.append(v)
            bd = self.flat_bd[o_bd: o_bd + m * b].view(m, b)
            bd.copy_(torch.as_tensor(st_h["bd"].astype(np.int64)))
            inbox, ti = [], 0
            for (m0, m1, tabbed, o_ib, kmax) in seg_rec:
                if tabbed:
                    ln = (m1 - m0) * e
                    t = self.flat_inbox[o_ib: o_ib + kmax * ln].view(kmax, ln)
                    t.copy_(torch.as_tensor(
                        np.ascontiguousarray(st_h["inbox_ts"][ti][:, :ln]).astype(np.int32)))
                    inbox.append(t)
                    ti += 1
            n_bd = int((st_h["bd"] < self.total_slots).sum())
            leaf = int(not held[off: off + m * e].any())
            if leaf and any(tabbed for (_, _, tabbed) in segs):
                raise AssertionError(f"stage {di} receives inbox sums but no bd holds its slots")
            desc[di, : len(HEAD_FIELDS)] = (e, b, m, off, c_off, *o_stack, o_bd, n_bd, leaf,
                                            len(seg_rec))
            for k, rec in enumerate(seg_rec):
                base = len(HEAD_FIELDS) + k * len(SEG_FIELDS)
                desc[di, base: base + len(SEG_FIELDS)] = rec
            self.stages.append(MFStage(
                e=e, b=b, m=m, off=off, c_off=c_off, segs=segs,
                inv=views[0], ginv=views[1], fbi=views[2], bd=bd, inbox=tuple(inbox),
            ))
        self.desc = idx(desc)
        #: the largest front or boundary of any stage (a multiple of 8): the
        #: length of one node's vector, which kernel F stages in shared memory
        self.max_front = max(max(s.e, s.b) for s in self.stages)
        self._finalize_p1(tables, statics)

    def _finalize_p1(self, tables, statics):
        """The per-stage sweep's P1 launches (see :meth:`_finalize_device`)."""
        dev, n, total = self.device, self.n, self.total_slots
        #: slots of one row of the sweep's work vectors: the stage slots, the
        #: trailing zero slot the boundary pads read, rounded up to 4 floats
        #: (K2's wide instance then copies stage slices in 16-byte pieces)
        self.work_slots = -(-(total + 1) // 4) * 4
        pieces = [np.concatenate([tables["perm"], np.full(self.work_slots - total, n)]),
                  tables["ipos"]] + [st_h["bd"].reshape(-1) for st_h in tables["stages"]]
        offs, n_tab = [], 0
        for a in pieces:
            offs.append(n_tab)
            n_tab += -(-len(a) // 4) * 4
        host = np.zeros(n_tab, dtype=np.int32)
        for o, a in zip(offs, pieces):
            host[o: o + len(a)] = a
        self.p1_tables = torch.as_tensor(host, device=dev)
        self.perm32 = self.p1_tables[: self.work_slots]
        self.ipos32 = self.p1_tables[offs[1]: offs[1] + n]
        # (segments, tables, inbox form) of every launch, then one descriptor
        # array for all of them
        launches = [([(0, self.work_slots, 1, 0)], self.p1_tables, False),
                    ([(0, n, 1, offs[1])], self.p1_tables, False)]
        for di, (e, b, m, *_, seg_rec) in enumerate(statics):
            launches.append(([(0, m * b, 1, offs[2 + di])], self.p1_tables, False))
            inbox = [(m0 * e, (m1 - m0) * e, kmax, o_ib)
                     for (m0, m1, tabbed, o_ib, kmax) in seg_rec if tabbed]
            if inbox:
                launches.append((inbox, self.flat_inbox, True))
        rows = [gather_descriptors(segs) for segs, _, _ in launches]
        self.p1_desc = torch.as_tensor(np.concatenate([r for r, _ in rows]), device=dev)
        plans, r0 = [], 0
        for (segs, flat, sub), (r, tiles) in zip(launches, rows):
            plans.append(GatherPlan(desc=self.p1_desc[r0: r0 + len(segs)], tables=flat,
                                    segs=tuple(segs), sub=sub, n_tiles=tiles))
            r0 += len(segs)
        self.p1_entry, self.p1_exit = plans[0], plans[1]
        it = iter(plans[2:])
        for di, st in enumerate(self.stages):
            st.p1_bd = next(it)
            st.bd32 = self.p1_tables[offs[2 + di]: offs[2 + di] + st.m * st.b].view(st.m, st.b)
            st.p1_inbox = next(it) if st.inbox else None

    # ── public API ──────────────────────────────────────────────────────────

    @property
    def factor_bytes(self) -> int:
        """Bytes of the factor stacks on the device (one solve reads them all)."""
        return sum(s.inv.nbytes + s.ginv.nbytes + s.fbi.nbytes for s in self.stages)

    def launches_per_solve(self) -> tuple[int, int]:
        """(K2, P1) launches of one solve through the per-stage sweep:
        three K2 per stage (the root's forward update has no consumer, so
        one fewer); P1 once per stage with an inbox (all its segments),
        once per stage for the boundary gather, and once each for the entry
        and exit permutations."""
        k2 = 3 * len(self.stages) - 1
        p1 = sum(1 for s in self.stages if s.inbox) + len(self.stages) + 2
        return k2, p1

    def takes_fused(self, rows: int) -> bool:
        """Whether a solve of ``rows`` right-hand sides goes through kernel
        F (one launch) rather than the per-stage sweep (K2 and P1)."""
        return self.device.type == "cuda" and rows <= FUSED_MAX_ROWS

    def solve(self, b: torch.Tensor) -> torch.Tensor:
        """x = A^-1 b for b (..., n): kernel F for at most
        ``FUSED_MAX_ROWS`` rows on CUDA, else the per-stage sweep."""
        rows = 1
        for d in b.shape[:-1]:
            rows *= int(d)
        if b.device.type == "cuda" and self.takes_fused(rows):
            return multifrontal_solve_fused(self, b)
        return multifrontal_solve(self, b)


def _round128(x: int) -> int:
    return max(128, -(-int(x) // 128) * 128)


def _round8(x: int) -> int:
    return max(8, -(-int(x) // 8) * 8)


def _stage_phys_elems(m: int, e: int, b: int) -> int:
    """Physical elements of one stage's three factor stacks under the TPU's
    (8, 128) tile layout: only the MINOR dim pads to 128; the second-minor
    pads to 8. inv (m,e,e) -> e8*e128; ginv (m,e,b) -> e8*b128; fbi (m,b,e)
    -> b8*e128. Kept as the JAX package prices it so that the port's stages
    and stacks equal the reference's; Hopper stores the stacks unpadded, and
    a later change may reprice the DP for it."""
    e8, b8 = _round8(e), _round8(b)
    e128, b128 = _round128(e), _round128(b)
    return m * (e8 * e128 + e8 * b128 + b8 * e128)


def _measure_solve_err(a_csr, payload: dict, n: int, n_rhs: int = 4) -> float:
    """True-error probe of the rounded (store-dtype) factors, on host.

    Runs the same forward/backward sweeps as the device solve in numpy
    over the payload for synthetic RHS b = A x_true and returns the median
    relative error ||x - x_true|| / ||x_true||. The error, not the residual,
    decides the refinement recommendation (see
    MultifrontalLU.recommended_refine).
    """
    rng = np.random.default_rng(12345)
    xt = rng.standard_normal((n, n_rhs))
    xt /= np.linalg.norm(xt, axis=0, keepdims=True)
    b = a_csr @ xt  # (n, n_rhs) f64
    n_stages = len(payload["depth_order"])
    dt32 = payload["inv_0"].dtype
    bp = np.concatenate([b.astype(dt32), np.zeros((1, n_rhs), dt32)])
    acc = np.zeros((n + 1, n_rhs), dtype=dt32)
    zs = []
    for di in range(n_stages):
        elim = np.minimum(payload[f"elim_{di}"], n)  # (m, e_max) pad -> n
        bd = np.minimum(payload[f"bd_{di}"], n)
        xe = bp[elim] - acc[elim]  # (m, e_max, n_rhs)
        z = np.einsum("mij,mjr->mir", payload[f"inv_{di}"], xe)
        upd = np.einsum("mbi,mir->mbr", payload[f"fbi_{di}"], z)
        np.add.at(acc, bd.reshape(-1), upd.reshape(-1, n_rhs))
        zs.append(z)
    xs = np.zeros((n + 1, n_rhs), dtype=dt32)
    for di in reversed(range(n_stages)):
        elim = np.minimum(payload[f"elim_{di}"], n)
        bd = np.minimum(payload[f"bd_{di}"], n)
        corr = np.einsum("mib,mbr->mir", payload[f"ginv_{di}"], xs[bd])
        xs[elim.reshape(-1)] = (zs[di] - corr).reshape(-1, n_rhs)
    err = np.linalg.norm(xs[:n] - xt, axis=0)
    return float(np.median(err))


def _repack_dp(payload: dict, n: int, lam_bytes: float) -> dict:
    """Regroup the per-depth node forests by a penalty-DP partition.

    Nodes of one depth are lex-sorted by (n_elim, n_bd) and split into
    contiguous groups by a DP minimizing  padded_bytes + lam_bytes *
    n_groups  (lam_bytes prices one stage's fixed overhead). Same-depth
    nodes are never ancestor-related, so any regrouping within a depth is
    execution-safe. A pure host-side transform of the payload dict.
    """
    depths = payload["depth_order"]
    itemsize = payload["inv_0"].itemsize if "inv_0" in payload else 4
    lam = lam_bytes / itemsize  # penalty in elements
    # decompose stages into nodes
    per_depth: dict[int, list] = {}
    for di in range(len(depths)):
        e = payload[f"elim_{di}"]
        b = payload[f"bd_{di}"]
        inv = payload[f"inv_{di}"]
        giv = payload[f"ginv_{di}"]
        fbi = payload[f"fbi_{di}"]
        for i in range(e.shape[0]):
            ne = int((e[i] < n).sum())
            nb = int((b[i] < n).sum())
            per_depth.setdefault(int(depths[di]), []).append((
                ne, nb, e[i, :ne], b[i, :nb],
                inv[i, :ne, :ne], giv[i, :ne, :nb], fbi[i, :nb, :ne],
            ))

    groups: list[tuple[int, list]] = []  # (depth, [node, ...])
    for dv, nodes in per_depth.items():
        nodes.sort(key=lambda t: (t[0], t[1]))
        m = len(nodes)
        ne = [t[0] for t in nodes]
        nb = [t[1] for t in nodes]
        best = [np.inf] * (m + 1)
        prev = [0] * (m + 1)
        best[0] = 0.0
        for j in range(1, m + 1):
            mb = 0
            for i in range(j - 1, -1, -1):
                mb = max(mb, nb[i])
                # sorted: max elim in i..j-1 is ne[j-1]
                c = _stage_phys_elems(j - i, ne[j - 1], mb) + lam
                if best[i] + c < best[j]:
                    best[j] = best[i] + c
                    prev[j] = i
        cuts = []
        j = m
        while j > 0:
            cuts.append((prev[j], j))
            j = prev[j]
        for i, j in reversed(cuts):
            groups.append((dv, nodes[i:j]))

    # rebuild the payload: stages ordered deep -> root
    groups.sort(key=lambda g: (-g[0], max(t[0] for t in g[1])))
    out: dict[str, np.ndarray] = {
        "depth_order": np.asarray([g[0] for g in groups])
    }
    dt = payload["inv_0"].dtype
    for di, (dv, nodes) in enumerate(groups):
        m = len(nodes)
        # stack dims pad to multiples of 8
        e_max = _round8(max(t[0] for t in nodes))
        b_max = _round8(max(t[1] for t in nodes))
        elim_idx = np.full((m, e_max), n, dtype=np.int64)
        bd_idx = np.full((m, b_max), n, dtype=np.int64)
        inv = np.zeros((m, e_max, e_max), dtype=dt)
        giv = np.zeros((m, e_max, b_max), dtype=dt)
        fbi = np.zeros((m, b_max, e_max), dtype=dt)
        for i, (ne, nb, ei, bi, iv, gv, fb) in enumerate(nodes):
            elim_idx[i, :ne] = ei
            bd_idx[i, :nb] = bi
            inv[i, :ne, :ne] = iv
            giv[i, :ne, :nb] = gv
            fbi[i, :nb, :ne] = fb
        out[f"elim_{di}"] = elim_idx
        out[f"bd_{di}"] = bd_idx
        out[f"inv_{di}"] = inv
        out[f"ginv_{di}"] = giv
        out[f"fbi_{di}"] = fbi
    logger.info(
        "multifrontal: dp repack %d -> %d stages, %.2f -> %.2f GB padded",
        len(depths), len(groups),
        sum(payload[f"inv_{d}"].nbytes + payload[f"ginv_{d}"].nbytes
            + payload[f"fbi_{d}"].nbytes for d in range(len(depths))) / 2**30,
        sum(out[f"inv_{d}"].nbytes + out[f"ginv_{d}"].nbytes
            + out[f"fbi_{d}"].nbytes for d in range(len(groups))) / 2**30,
    )
    return out


def _sort_nodes_by_inbox_load(payload: dict, n: int) -> dict:
    """Sort every stage's nodes by DESCENDING inbox load (incoming
    forward-sweep contributions to the node's eliminated dofs) so the
    per-stage inbox gather can be segmented (see _build_tables). The node
    order within a stage is arbitrary by construction, so this is a pure
    permutation of the stage stacks."""
    n_stages = len(payload["depth_order"])
    counts = np.zeros(n + 1, dtype=np.int64)
    for di in range(n_stages):
        bd = payload[f"bd_{di}"].reshape(-1)
        real = bd[bd < n]
        if len(real):
            counts[:n] += np.bincount(real, minlength=n)
    out = dict(payload)
    for di in range(n_stages):
        elim = payload[f"elim_{di}"]
        load = counts[np.minimum(elim, n)].max(axis=1)
        order = np.argsort(-load, kind="stable")
        if np.array_equal(order, np.arange(len(order))):
            continue
        for nm in ("elim", "bd", "inv", "ginv", "fbi"):
            out[f"{nm}_{di}"] = np.ascontiguousarray(
                payload[f"{nm}_{di}"][order]
            )
    return out


def _inbox_segments(node_load: np.ndarray, max_segs: int = 4):
    """Segment a DESC-sorted node-load vector into ≤ max_segs groups of
    similar kmax (power-of-two buckets, adjacent-merge down to the cap).
    Returns [(m0, m1, kcap)] with kcap == 0 for the untargeted tail."""
    m = len(node_load)
    if m == 0:
        return [(0, 0, 0)]
    bucket = np.where(
        node_load <= 0, 0,
        2 ** np.ceil(np.log2(np.maximum(node_load, 1))).astype(np.int64),
    )
    # boundaries where the bucket value changes (desc-sorted ⇒ monotone)
    cuts = [0] + list(np.flatnonzero(np.diff(bucket)) + 1) + [m]
    segs = [(cuts[i], cuts[i + 1], int(bucket[cuts[i]]))
            for i in range(len(cuts) - 1)]
    # merge smallest-cost boundaries until within the cap (keep the
    # zero-load tail separate — merging it would re-pad it with gathers)
    while len(segs) > max_segs:
        best, cost = None, None
        for i in range(len(segs) - 1):
            (a0, a1, ka), (b0, b1, kb) = segs[i], segs[i + 1]
            if kb == 0:
                continue
            c = (b1 - b0) * (ka - kb)  # extra padded gathers if merged
            if cost is None or c < cost:
                best, cost = i, c
        if best is None:
            break
        (a0, _, ka), (_, b1, _) = segs[best], segs[best + 1]
        segs[best: best + 2] = [(a0, b1, ka)]
    return segs


def _table_skip_pads(dest: np.ndarray, n_out: int) -> np.ndarray:
    """Transposed-scatter gather table over destinations ``dest`` (pad
    entries == n_out are excluded; they point at the appended-zero slot).
    Returns (n_out + 1, kmax) with source positions, pad = len(dest)."""
    real = np.where(dest < n_out)[0]
    d = dest[real]
    order = np.argsort(d, kind="stable")
    d_sorted = d[order]
    pos = real[order]
    counts = np.bincount(d_sorted, minlength=n_out)
    kmax = max(int(counts.max(initial=0)), 1)
    table = np.full((n_out + 1, kmax), len(dest), dtype=np.int64)
    starts = np.concatenate([[0], np.cumsum(counts)])
    within = np.arange(len(d_sorted)) - starts[d_sorted]
    table[d_sorted, within] = pos
    return table


def multifrontal_solve(mf: MultifrontalLU, b: torch.Tensor) -> torch.Tensor:
    """x = A^-1 b for b (..., n) on ``mf.device``.

    One dataflow for any leading batch (the JAX package's ``_solve_threaded``)
    over two work vectors of ``mf.work_slots`` slots a row in stage-slot
    order, x and z, and a contribution buffer (B, 1 + total_contrib) whose
    position 0, the inbox pads' zero, is the only one read before a stage
    writes it. x ← b through the entry permutation (P1; pad slots and the
    trailing slots, which the boundary pads read, are 0). Forward sweep,
    deepest stage first: xe ← xe − Σ inbox (P1, in place, one launch over
    the stage's segments); z = inv·xe (K2, into z); the stage's boundary
    updates fbi·z (K2) go straight into its slice of the buffer. Backward
    sweep, root first: x[stage] ← z − ginv·x[bd] (the boundary gather P1,
    then K2 and one subtraction). x ← x through the exit permutation (P1).
    """
    batch = b.shape[:-1]
    n = mf.n
    dtype = mf.dtype
    out_dtype = b.dtype if b.dtype in (torch.float32, torch.float64) else dtype
    rows = 1
    for d in batch:
        rows *= int(d)
    bb = b.reshape(rows, n).to(dtype)
    dev = bb.device
    xs = mf.work_slots
    x = sweep_gather(mf.p1_entry, bb, out=torch.empty((rows, xs), dtype=dtype, device=dev))
    z = torch.empty((rows, xs), dtype=dtype, device=dev)
    buf = torch.empty((rows, 1 + mf.total_contrib), dtype=dtype, device=dev)
    buf[:, :1].zero_()

    last = len(mf.stages) - 1
    for si, st in enumerate(mf.stages):
        e, m, off = st.e, st.m, st.off
        xe = x[:, off: off + m * e]
        if st.p1_inbox is not None:
            sweep_gather(st.p1_inbox, buf, xe=xe, out=xe)
        ze = stack_matvec(st.inv, xe.view(rows, m, e),
                          out=z[:, off: off + m * e].view(rows, m, e))
        if si < last:  # the root's updates have no consumer
            c0 = 1 + st.c_off
            stack_matvec(st.fbi, ze, out=buf[:, c0: c0 + m * st.b].view(rows, m, st.b))

    for st in reversed(mf.stages):
        e, m, off = st.e, st.m, st.off
        xb = sweep_gather(st.p1_bd, x)  # ancestor slots are final
        corr = stack_matvec(st.ginv, xb.view(rows, m, st.b))
        torch.sub(z[:, off: off + m * e], corr.reshape(rows, m * e), out=x[:, off: off + m * e])

    return sweep_gather(mf.p1_exit, x).reshape(batch + (n,)).to(out_dtype)
