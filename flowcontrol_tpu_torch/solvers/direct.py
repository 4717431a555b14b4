"""Direct linear solvers: host sparse LU and on-device dense LU.

The reference funnels every linear solve through MUMPS
(ref: src/flowcontrol/flowsolver.py:812-814). The counterpart of
``flowcontrol_tpu/solvers/direct.py``:

- ``HostSparseLU``: scipy splu (f64) — setup-time solves (steady state) and
  the host validation backend.
- ``DeviceDenseLU``: dense LU resident on the device through
  ``torch.linalg`` (cuSOLVER/cuBLAS on CUDA, LAPACK on the CPU). It
  replaces both of the JAX package's dense kinds: the XLA ``lu_factor`` and
  the matmul-blocked ``solvers/block_lu.py``, which exists only because
  XLA's LU ran out of VMEM on the TPU.
"""

from __future__ import annotations

import numpy as np
import scipy.sparse as sp
import scipy.sparse.linalg as spla
import torch


class HostSparseLU:
    """scipy splu wrapper (setup-time, f64)."""

    def __init__(self, a_csr):
        self._lu = spla.splu(a_csr.tocsc())
        self.n = a_csr.shape[0]

    def solve(self, b: np.ndarray) -> np.ndarray:
        """x = A^-1 b for one right-hand side b (n,)."""
        return self._lu.solve(np.asarray(b, dtype=np.float64))


def dense_from_csr_on_device(a_csr, device, dtype) -> torch.Tensor:
    """Densify a scipy CSR matrix ON the device: ships the O(nnz) triplets,
    never an n x n host array (25 GB in f64 at 56k dofs)."""
    coo = sp.coo_matrix(a_csr)
    coo.sum_duplicates()
    a = torch.zeros(coo.shape, dtype=dtype, device=device)
    rows = torch.as_tensor(coo.row.astype(np.int64), device=device)
    cols = torch.as_tensor(coo.col.astype(np.int64), device=device)
    a[rows, cols] = torch.as_tensor(coo.data, dtype=dtype, device=device)
    return a


def pivots_to_permutation(piv: np.ndarray) -> np.ndarray:
    """LAPACK's 1-based sequential row swaps (getrf pivots) -> the row
    permutation ``perm`` with ``L U x = b[perm]`` for ``A x = b``."""
    perm = list(range(len(piv)))
    for i, p in enumerate((np.asarray(piv) - 1).tolist()):
        perm[i], perm[p] = perm[p], perm[i]
    return np.asarray(perm, dtype=np.int64)


class DeviceDenseLU:
    """Dense LU with partial pivoting, factors resident on ``device``.

    The factorization (``torch.linalg.lu_factor_ex``: cuSOLVER getrf on
    CUDA) runs in f64 and the finished factor is stored in
    ``store_dtype``. Factoring in f64 and storing f32 solves far more
    accurately than eliminating in f32 (the reference measured a raw
    residual of 1.1e-4 against 0.34 at 56k dofs, ``core/stepper.py:411-415``),
    for the price of a transient f64 peak: A and LU together, 16 n^2 bytes
    (51 GB at 56,383 dofs), then 4 n^2 (12.7 GB) resident.

    A solve is the row permutation and two triangular solves on the stored
    factor (cuBLAS trsv for one right-hand side). ``torch.linalg.lu_solve``
    gives bitwise the same x but measured 13.4 ms against 8.2 ms at 56,383
    dofs in f32 (NVIDIA H100 80GB HBM3, 700 W): 5.3 ms of it is one extra
    elementwise pass over the factor's size.
    """

    def __init__(self, a_csr, device, store_dtype: torch.dtype):
        a = dense_from_csr_on_device(a_csr, device, torch.float64)
        lu, piv, info = torch.linalg.lu_factor_ex(a)
        del a
        if int(info) != 0:
            raise np.linalg.LinAlgError(
                f"dense LU is singular: zero pivot at column {int(info)}"
            )
        # keeps lu_factor's column-major layout, which the triangular
        # solves read without a copy
        self.lu = lu.to(store_dtype)
        del lu
        self.perm = torch.as_tensor(pivots_to_permutation(piv.cpu().numpy()), device=device)
        self.n = self.lu.shape[0]

    def solve(self, b: torch.Tensor) -> torch.Tensor:
        """x = A^-1 b for b (n,) or (k, n)."""
        rhs = b.to(self.lu.dtype).reshape(-1, self.n)[:, self.perm].T
        y = torch.linalg.solve_triangular(self.lu, rhs, upper=False, unitriangular=True)
        x = torch.linalg.solve_triangular(self.lu, y, upper=True)
        return x.T.reshape(b.shape).to(b.dtype)
