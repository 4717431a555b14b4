"""Blocked dense LU without pivoting across blocks, and its plain solve.

The counterpart of ``flowcontrol_tpu/solvers/block_lu.py``: the classic
right-looking blocked LU with block-inverted diagonal pivots,

    for k:  Dk⁻¹ = inv(A_kk)
            L_jk  = A_jk · Dk⁻¹          (j > k)
            A_jl -= L_jk · A_kl          (j, l > k)

whose factor is what the fused substitution kernel K3
(``ops/trisolve.py``) consumes: ``lu`` (n_pad, n_pad) row-major with the L
blocks strictly below and the U blocks on and above the block diagonal,
and ``dinv`` (nb, bs, bs), the inverses of the U diagonal blocks. A
substitution over this factor is (bs × bs)·(bs × B) products only, so a
panel of right-hand sides amortizes the factor reads (the batched-rollout
regime), and there is no row permutation to carry.

No row pivoting across blocks: the time-step matrices are mass-dominated on
the velocity block and ordered velocity-first, so block-diagonal inversion
is stable in practice (``tests/test_torch_block_lu.py`` holds the saddle
structure).

The factorization's products are plain large matrix products
(``torch.matmul``/``addmm_``, ``torch.linalg.inv``); it updates the trailing
matrix in place, slice by slice. :func:`block_lu_solve` is the plain torch
version of K3: the tests and the CPU use it, and nothing on the card's
stepping path does (:meth:`BlockLU.solve` goes through the kernel's
wrapper, which launches K3 for a factor on the card or raises).
"""

from __future__ import annotations

import numpy as np
import torch

from flowcontrol_tpu_torch.solvers.direct import dense_from_csr_on_device

#: columns of the trailing matrix updated by one ``addmm_``: bounds any
#: temporary the product makes to (rows x this) instead of the trailing size
_UPDATE_COLS = 8192


def _block_lu_inplace(a: torch.Tensor, bs: int):
    """Right-looking blocked LU of ``a`` (n_pad, n_pad), IN PLACE.

    Returns (lu, dinv): ``lu`` is ``a`` itself, now holding the L blocks
    strictly below the block diagonal and the U blocks on and above it;
    ``dinv`` (nb, bs, bs) holds the inverses of the U diagonal blocks.
    """
    n_pad = a.shape[0]
    nb = n_pad // bs
    dinv = torch.empty((nb, bs, bs), dtype=a.dtype, device=a.device)
    for k in range(nb):
        r, e = k * bs, (k + 1) * bs
        dinv[k] = torch.linalg.inv(a[r:e, r:e])
        if e == n_pad:
            break
        l_col = a[e:, r:e] @ dinv[k]
        a[e:, r:e] = l_col
        for c0 in range(e, n_pad, _UPDATE_COLS):
            c1 = min(c0 + _UPDATE_COLS, n_pad)
            a[e:, c0:c1].addmm_(l_col, a[r:e, c0:c1], alpha=-1.0)
    return a, dinv


class BlockLU:
    """Factor once on ``device``; solve many times (batched RHS supported).

    Accepts a dense ndarray or any scipy sparse matrix; a sparse input is
    densified ON the device from its triplets, never as an n x n host
    array. The matrix is padded to a multiple of ``bs`` with the identity,
    so the padded part of every solution stays zero. A singular diagonal
    block raises ``torch.linalg.LinAlgError``.

    The factorization runs in ``dtype`` and the finished factor is stored
    in ``store_dtype`` (``dtype`` when None): factoring in f64 and storing
    f32 solves far more accurately than eliminating in f32. In flight are
    the n_pad² matrix in ``dtype`` (factored in place) and one block
    column; the stored copy is made before the in-flight one is released.
    """

    def __init__(self, a, bs: int = 1024, dtype: torch.dtype = torch.float32,
                 store_dtype: torch.dtype | None = None, device="cuda"):
        if bs <= 0:
            raise ValueError(f"block size must be positive, got {bs}")
        device = torch.device(device)
        n = a.shape[0]
        if a.shape != (n, n):
            raise ValueError(f"BlockLU needs a square matrix, got shape {a.shape}")
        n_pad = n + ((-n) % bs)
        if hasattr(a, "tocoo"):  # scipy sparse
            a_pad = dense_from_csr_on_device(a, device, dtype, n_pad=n_pad)
        else:
            a_pad = torch.eye(n_pad, dtype=dtype, device=device)
            a_pad[:n, :n] = torch.as_tensor(np.asarray(a, dtype=np.float64), dtype=dtype,
                                            device=device)
        lu, dinv = _block_lu_inplace(a_pad, bs)
        del a_pad
        if store_dtype is not None and store_dtype != dtype:
            lu, dinv = lu.to(store_dtype), dinv.to(store_dtype)
        self._set(lu, dinv, bs, n)

    def _set(self, lu: torch.Tensor, dinv: torch.Tensor, bs: int, n: int) -> None:
        n_pad = lu.shape[0]
        nb = n_pad // bs
        if lu.shape != (n_pad, n_pad) or n_pad % bs or dinv.shape != (nb, bs, bs):
            raise ValueError(
                f"factor shapes lu {tuple(lu.shape)}, dinv {tuple(dinv.shape)} do not "
                f"form a blocked LU with bs={bs}"
            )
        if not n_pad - bs < n <= n_pad:
            raise ValueError(f"n={n} does not pad to n_pad={n_pad} with bs={bs}")
        self.lu, self.dinv = lu, dinv
        self.bs, self.n, self.n_pad, self.nb = bs, n, n_pad, nb
        self.dtype = lu.dtype

    def tree(self):
        return (self.lu, self.dinv)

    def solve(self, b: torch.Tensor) -> torch.Tensor:
        """Kernel K3 for a factor on the card, its plain version on the CPU."""
        # imported here: ops/trisolve.py imports this module for the plain version
        from flowcontrol_tpu_torch.ops.trisolve import block_lu_solve_fused

        return block_lu_solve_fused(self.tree(), b, bs=self.bs, n=self.n)


def block_lu_from_numpy(lu, dinv, bs: int, n: int, device, dtype: torch.dtype) -> BlockLU:
    """A :class:`BlockLU` from a finished factor given as numpy arrays, e.g.
    a JAX ``BlockLU``'s ``lu`` and ``dinv`` passed through ``np.asarray``."""
    f = BlockLU.__new__(BlockLU)
    f._set(
        torch.tensor(np.asarray(lu), dtype=dtype, device=device),
        torch.tensor(np.asarray(dinv), dtype=dtype, device=device),
        int(bs), int(n),
    )
    return f


def block_lu_solve(factors, b: torch.Tensor, bs: int, n: int) -> torch.Tensor:
    """Solve A x = b from BlockLU factors ``(lu, dinv)``; b is (..., n).

    The plain torch version of kernel K3, on any device and dtype:

        forward   y_k = b_k − Σ_{j<k} L_kj y_j       (L unit block lower)
        backward  x_k = D_k⁻¹ (y_k − Σ_{j>k} U_kj x_j)

    on an (n_pad, B) panel, in the factor's dtype.
    """
    lu, dinv = factors
    n_pad = lu.shape[0]
    nb = n_pad // bs
    if b.shape[-1] != n:
        raise ValueError(f"b has shape {tuple(b.shape)}, needs (..., {n})")
    out_dtype = b.dtype if b.dtype in (torch.float32, torch.float64) else lu.dtype
    batch = b.shape[:-1]
    bt = b.to(lu.dtype).reshape(-1, n).T  # (n, B)
    x = torch.zeros((n_pad, bt.shape[1]), dtype=lu.dtype, device=lu.device)
    x[:n] = bt
    for k in range(1, nb):
        r = k * bs
        x[r:r + bs] -= lu[r:r + bs, :r] @ x[:r]
    for k in reversed(range(nb)):
        r, e = k * bs, (k + 1) * bs
        rhs_k = x[r:e] - lu[r:e, e:] @ x[e:] if e < n_pad else x[r:e]
        x[r:e] = dinv[k] @ rhs_k
    return x[:n].T.contiguous().reshape(batch + (n,)).to(out_dtype)
