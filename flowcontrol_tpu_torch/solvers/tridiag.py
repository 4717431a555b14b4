"""BFS graph levels of a sparse matrix.

The counterpart of ``flowcontrol_tpu/solvers/tridiag.py``, as far as the
multifrontal ordering needs it: :func:`graph_levels`, the level structure
whose single levels serve as nested-dissection separators. The tridiagonal
substructured solve of that module is not ported: the multifrontal solve
supersedes it (ROADMAP.md, "Replaced, not transcribed").
"""

from __future__ import annotations

import numpy as np


def graph_levels(a_csr, coords: np.ndarray, axis: int = 0,
                 g=None) -> np.ndarray:
    """BFS level number of every dof in the (symmetrized) matrix graph,
    seeded from the min-coordinate boundary layer along ``axis``.

    A dof in level l couples only levels l-1..l+1, so one level separates
    the levels below it from those above it, independent of mesh grading.

    Dirichlet-eliminated rows are isolated vertices (identity rows couple
    nothing); they take the level of the spatially-nearest connected dof —
    any assignment is valid for them since no coupling constrains them.
    """
    n = a_csr.shape[0]
    if g is None:
        g = ((a_csr != 0) + (a_csr != 0).T).tocsr()
    deg = np.diff(g.indptr)
    offdiag = deg > 1  # isolated (BC) rows hold only their diagonal
    x = coords[:, axis]
    level = np.full(n, -1, dtype=np.int64)

    conn = np.where(offdiag)[0]
    if not len(conn):
        return np.zeros(n, dtype=np.int64)
    xc = x[conn]
    span = float(xc.max() - xc.min()) or 1.0
    seed = conn[xc <= xc.min() + 5e-3 * span]
    lvl = 0
    frontier = seed
    while True:
        while len(frontier):
            level[frontier] = lvl
            # expand: all neighbors of the frontier not yet leveled
            nbrs = np.concatenate([
                g.indices[g.indptr[i]: g.indptr[i + 1]] for i in frontier
            ]) if len(frontier) < 1024 else g[frontier].indices
            nxt = np.unique(nbrs)
            frontier = nxt[level[nxt] < 0]
            lvl += 1
        rest = np.where((level < 0) & offdiag)[0]
        if not len(rest):
            break
        # disconnected component: restart from its leftmost dof
        frontier = rest[x[rest] <= x[rest].min() + 1e-12]

    # isolated dofs: nearest connected dof by x (argpartition-free interp)
    iso = np.where(level < 0)[0]
    if len(iso):
        done = np.where(level >= 0)[0]
        order = np.argsort(x[done])
        pos = np.searchsorted(x[done][order], x[iso])
        pos = np.clip(pos, 0, len(done) - 1)
        level[iso] = level[done[order]][pos]
    return level
