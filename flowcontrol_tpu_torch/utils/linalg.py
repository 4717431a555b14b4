"""Eigenvalue analysis and frequency response of (A, E, B, C) systems.

The counterpart of ``flowcontrol_tpu/utils/linalg.py`` (ref:
src/utils/linalg.py):

- the generalized eigenproblem A x = λ E x by shift-invert (ref:
  linalg.py:52-129, SLEPc Krylov-Schur + MUMPS) and the frequency response
  H(jω) = C (jωE - A)^{-1} B (ref: linalg.py:192-328): on the host the JAX
  package's own code (scipy ARPACK + splu), transcribed;
- on the device (the card unless ``device="cpu"``): shift-invert Arnoldi
  (``eig_arnoldi_dense_device``) and the frequency sweep
  (``get_frequency_response_device``), each on a dense complex LU of the
  shifted operator (``solvers/direct.py`` ``DeviceDenseLU``: cuSOLVER's
  getrf through ``torch.linalg``; the JAX package does this LU in XLA, so it
  stays a library call). They take A and E dense, as the JAX functions do,
  or as scipy CSR: only the shifted matrix is formed densely, on the device
  from its O(nnz) triplets, and E is applied as a sparse product. At the
  cylinder's 56,383 dofs one dense complex64 matrix is 25.4 GB: the JAX
  functions hold four at once (101 GB), these two (the matrix and its LU,
  50.9 GB).
"""

from __future__ import annotations

import logging
import time

import numpy as np
import scipy.sparse as sp
import scipy.sparse.linalg as spla
import torch

from flowcontrol_tpu_torch.config import require_device
from flowcontrol_tpu_torch.core.stepper import csr_to_device
from flowcontrol_tpu_torch.solvers.direct import DeviceDenseLU

logger = logging.getLogger(__name__)


# ── Generalized eigenproblem (shift-invert) ──────────────────────────────────


def get_mat_vp_shift_invert(
    a_csr,
    e_csr,
    n: int = 10,
    sigma: complex = 0.0,
    return_vectors: bool = True,
):
    """Eigenvalues of A x = λ E x nearest shift σ (host, ARPACK + splu).

    Matches the reference's SLEPc shift-invert usage
    (ref: linalg.py:52-129). E is singular (pressure rows zero): shift-invert
    handles this; spurious infinite eigenvalues are pushed away from σ.
    """
    vals, vecs = spla.eigs(
        a_csr.astype(np.complex128),
        k=n,
        M=e_csr.astype(np.complex128),
        sigma=sigma,
        which="LM",
        return_eigenvectors=True,
    )
    order = np.argsort(-vals.real)
    vals, vecs = vals[order], vecs[:, order]
    if return_vectors:
        return vals, vecs
    return vals


def _csr(m) -> sp.csr_matrix:
    """A scipy sparse matrix or a dense array as scipy CSR."""
    return sp.csr_matrix(m) if sp.issparse(m) else sp.csr_matrix(np.asarray(m))


def _real_dtype(dtype: torch.dtype) -> torch.dtype:
    if dtype == torch.complex64:
        return torch.float32
    if dtype == torch.complex128:
        return torch.float64
    raise TypeError(f"dtype must be torch.complex64 or torch.complex128, got {dtype}")


def _apply(a: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """A x for a real sparse CSR A and a complex x (n, k): two real sparse
    products."""
    return torch.complex(a @ x.real.contiguous(), a @ x.imag.contiguous())


class _ShiftedLU:
    """Dense LU of M = alpha A + beta E on the device, formed from the CSR
    triplets in complex128 and factored in ``dtype``."""

    def __init__(self, a_csr, e_csr, alpha: complex, beta: complex, device, dtype):
        m = (alpha * a_csr + beta * e_csr).astype(np.complex128)
        self.lu = DeviceDenseLU(m, device, dtype, factor_dtype=dtype)
        self.alpha, self.beta = alpha, beta

    def solve(self, rhs: torch.Tensor) -> torch.Tensor:
        """M^-1 rhs for rhs (n, k), in rhs's dtype."""
        return self.lu.solve(rhs.T).T

    def refine(self, rhs: torch.Tensor, x: torch.Tensor, a64: torch.Tensor,
               e64: torch.Tensor) -> torch.Tensor:
        """One refinement sweep, x + M^-1 (rhs - M x), its residual in
        complex128 from A and E as float64 sparse products (the Stepper's
        remedy for its f32 factors, on complex operators)."""
        x = x.to(torch.complex128)
        r = rhs.to(torch.complex128) - (self.alpha * _apply(a64, x) + self.beta * _apply(e64, x))
        return x + self.solve(r)


def eig_arnoldi_dense_device(
    a,
    e,
    n: int = 10,
    sigma: complex = 0.0,
    n_krylov: int = 60,
    dtype: torch.dtype = torch.complex64,
    device="cuda",
    stats: dict | None = None,
):
    """Shift-invert Arnoldi with a dense complex LU on ``device``.

    The counterpart of ``eig_arnoldi_dense_tpu``: the inner solve
    (A - σE)⁻¹ E v is an LU substitution, the Arnoldi loop (modified
    Gram-Schmidt, ``n_krylov`` steps) runs in ``dtype`` on the device, and
    the small Hessenberg eigenproblem on the host. A and E are dense arrays
    or scipy sparse matrices; E is applied as a sparse product. The start
    vector is drawn from a ``torch.Generator`` seeded with 0 (the JAX
    function draws from ``PRNGKey(0)``, which torch cannot reproduce).
    Raises without a card unless ``device="cpu"``. Returns (eigenvalues, Ritz
    vectors): the ``n`` nearest σ, as the host ARPACK path, ordered by real
    part. ``stats``, when given, gets the LU's and the Arnoldi loop's
    seconds.
    """
    dev = require_device(device)
    a_csr, e_csr = _csr(a), _csr(e)
    m = a_csr.shape[0]
    e_dev = csr_to_device(e_csr, dev, _real_dtype(dtype))
    t0 = time.perf_counter()
    op = _ShiftedLU(a_csr, e_csr, 1.0, -sigma, dev, dtype)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    t_lu = time.perf_counter() - t0

    gen = torch.Generator().manual_seed(0)
    v0 = torch.randn(m, generator=gen, dtype=torch.float32).to(dev, dtype)
    vs = torch.zeros((n_krylov + 1, m), dtype=dtype, device=dev)
    vs[0] = v0 / torch.linalg.vector_norm(v0)
    h = torch.zeros((n_krylov + 1, n_krylov), dtype=dtype, device=dev)
    t0 = time.perf_counter()
    for k in range(n_krylov):
        w = op.solve(_apply(e_dev, vs[k][:, None]))[:, 0]
        for j in range(k + 1):
            proj = torch.vdot(vs[j], w)
            w = w - proj * vs[j]
            h[j, k] = proj
        nrm = torch.linalg.vector_norm(w)
        h[k + 1, k] = nrm
        vs[k + 1] = w / torch.where(nrm > 0, nrm, torch.ones_like(nrm))
    h_small = h[:n_krylov, :n_krylov].cpu().numpy().astype(np.complex128)
    t_arnoldi = time.perf_counter() - t0
    del op
    theta, z = np.linalg.eig(h_small)
    lam = sigma + 1.0 / theta
    # the n Ritz values nearest σ (largest |θ|, ARPACK's "LM" in
    # shift-invert mode), ordered by real part. The JAX function orders all
    # of them by real part, which with a singular E puts first the spurious
    # λ = σ + 1/θ, θ ≈ 0, of the start vector's part in E's null space
    # (ROADMAP, "Faults in the reference").
    near = np.argsort(-np.abs(theta))[:n]
    order = near[np.argsort(-lam[near].real)]
    vecs = vs[:n_krylov].T.cpu().numpy().astype(np.complex128) @ z[:, order]
    if stats is not None:
        stats.update(lu_seconds=t_lu, arnoldi_seconds=t_arnoldi)
    return lam[order], vecs


# ── Frequency response ───────────────────────────────────────────────────────

#: refinement sweeps (complex128 residual) after each complex solve of
#: ``get_frequency_response_device``: one brings the cylinder's complex64 H
#: from 2.5e-3 to 1.4e-6 of the host's f64 answer
REFINE_SWEEPS = 1


def get_frequency_response(a_csr, b, c, q_csr, ww, d=None, verbose=False):
    """H(jω) = C (jωQ - A)^{-1} B, sequential host solves (f64).

    (ref: linalg.py:192-232 — scipy splu of the real 2n block; complex splu
    here is simpler and equivalent.)
    """
    b = np.atleast_2d(np.asarray(b, dtype=np.float64))
    if b.shape[0] != a_csr.shape[0]:
        b = b.T
    c = np.atleast_2d(np.asarray(c, dtype=np.float64))
    ww = np.atleast_1d(np.asarray(ww, dtype=np.float64))
    p, m = c.shape[0], b.shape[1]
    h = np.empty((len(ww), p, m), dtype=np.complex128)
    a_c = a_csr.astype(np.complex128).tocsc()
    q_c = q_csr.astype(np.complex128).tocsc()
    for k, w in enumerate(ww):
        lu = spla.splu(1j * w * q_c - a_c)
        x = lu.solve(b.astype(np.complex128))
        h[k] = c @ x
        if verbose and (k % max(1, len(ww) // 10) == 0):
            logger.info(f"freq response {k + 1}/{len(ww)}: w={w:.3f}")
    if d is not None:
        h = h + np.asarray(d)[None, :, :]
    return h


def get_frequency_response_device(a, b, c, q, ww, dtype: torch.dtype = torch.complex64,
                                  device="cuda", stats: dict | None = None):
    """H(jω) = C (jωQ - A)^{-1} B by one dense complex solve per ω on
    ``device``, in sequence (the JAX ``lax.map``, which bounds memory).

    The counterpart of ``get_frequency_response_tpu``. A and Q are dense
    arrays or scipy sparse matrices; each ω forms jωQ - A densely on the
    device, factors it in ``dtype`` and frees it before the next. Each solve
    takes ``REFINE_SWEEPS`` refinement sweeps with a complex128 residual from
    A and Q as float64 sparse products (the JAX function takes none; at the
    cylinder's 56,383 dofs the unrefined complex64 H is 2.5e-3 from the
    host's, the refined one 1.4e-6, on an NVIDIA H100). Raises
    without a card unless ``device="cpu"``. Returns (len(ww), p, m)
    complex128. ``stats``, when given, gets each ω's seconds and the
    unrefined response ``h_unrefined``.
    """
    dev = require_device(device)
    a_csr, q_csr = _csr(a), _csr(q)
    n = a_csr.shape[0]
    b = np.atleast_2d(np.asarray(b, dtype=np.float64))
    if b.shape[0] != n:
        b = b.T
    c_dev = torch.as_tensor(np.atleast_2d(np.asarray(c, dtype=np.float64)),
                            dtype=torch.complex128, device=dev)
    b_dev = torch.as_tensor(b, dtype=dtype, device=dev)
    a64, q64 = csr_to_device(a_csr, dev, torch.float64), csr_to_device(q_csr, dev, torch.float64)
    ww = np.atleast_1d(np.asarray(ww, dtype=np.float64))
    h = np.empty((len(ww), c_dev.shape[0], b.shape[1]), dtype=np.complex128)
    h0 = np.empty_like(h)
    seconds = []
    for k, w in enumerate(ww):
        t0 = time.perf_counter()
        op = _ShiftedLU(a_csr, q_csr, -1.0, 1j * w, dev, dtype)
        x = op.solve(b_dev)
        h0[k] = (c_dev @ x.to(torch.complex128)).cpu().numpy()
        for _ in range(REFINE_SWEEPS):
            x = op.refine(b_dev, x, a64, q64)
        h[k] = (c_dev @ x.to(torch.complex128)).cpu().numpy()
        del op, x
        seconds.append(time.perf_counter() - t0)
    if stats is not None:
        stats.update(seconds=seconds, h_unrefined=h0)
    return h


def get_frequency_response_sharded(a_dense, b, c, q_dense, ww, group,
                                   dtype: torch.dtype = torch.complex64, device="cuda"):
    """H(jω) with the ω list split over the ranks of the process group
    ``group`` (``torch.distributed.group.WORLD`` for every rank): the
    counterpart of the JAX package's
    ``get_frequency_response_sharded`` (its ω padded with its last value to
    a multiple of the ranks and cut into contiguous shards, one a device)
    and of the reference's MPI/MUMPS-distributed sweep (ref:
    linalg.py:272-328). Each rank solves its shard as
    :func:`get_frequency_response_device` does, on its ``device`` (each ω a
    dense complex LU in ``dtype`` and one refinement sweep with a
    complex128 residual), and one ``all_gather`` gives every rank the whole
    (len(ww), p, m) complex128 answer. A and Q dense or scipy sparse."""
    from flowcontrol_tpu_torch.parallel import comm

    dev = require_device(device)
    n_dev, rank = comm.group_size(group), comm.group_rank(group)
    ww = np.atleast_1d(np.asarray(ww, dtype=np.float64))
    n_pad = (-len(ww)) % n_dev
    ww_p = np.concatenate([ww, np.full(n_pad, ww[-1])])
    per = len(ww_p) // n_dev
    h = get_frequency_response_device(a_dense, b, c, q_dense, ww_p[rank * per: (rank + 1) * per],
                                      dtype=dtype, device=dev)
    mine = torch.view_as_real(torch.as_tensor(h, device=dev))  # (per, p, m, 2) float64
    full = comm.all_gather_rows(mine, group).reshape((len(ww_p),) + tuple(mine.shape[1:]))
    return torch.view_as_complex(full.contiguous()).cpu().numpy()[: len(ww)]


def get_field_response(a_csr, b, q_csr, ww):
    """Full-field response X(ω) = (jωQ - A)^{-1} B (ref: linalg.py:331-388)."""
    b = np.asarray(b, dtype=np.complex128).reshape(a_csr.shape[0], -1)
    a_c = a_csr.astype(np.complex128).tocsc()
    q_c = q_csr.astype(np.complex128).tocsc()
    out = np.empty((len(ww),) + b.shape, dtype=np.complex128)
    for k, w in enumerate(np.atleast_1d(ww)):
        out[k] = spla.splu(1j * w * q_c - a_c).solve(b)
    return out


# ── Matrix conversion helpers (ref: linalg.py:20-46) ─────────────────────────


def dense_to_sparse(mat, eliminate_zeros: bool = True):
    m = sp.csr_matrix(np.asarray(mat))
    if eliminate_zeros:
        m.eliminate_zeros()
    return m


def sparse_to_coo_triplets(mat):
    coo = mat.tocoo()
    return np.stack([coo.row, coo.col], axis=1), coo.data


# ── Reference-named entry points ─────────────────────────────────────────────
# The reference exposes one frequency-response routine per execution strategy
# (ref: linalg.py:192/235/272) and names its eigensolver after SLEPc
# (ref: linalg.py:52-129, eig/eig_utils.py:83-253). Same surface here, so
# reference-style callers port unchanged.

#: sequential host solves (ref: get_frequency_response_sequential)
get_frequency_response_sequential = get_frequency_response
#: the joblib-process sweep maps onto the sequential on-device sweep
get_frequency_response_parallel = get_frequency_response_device
#: the MPI/MUMPS-distributed sweep maps onto the rank-sharded sweep
get_frequency_response_mpi = get_frequency_response_sharded
#: legacy SLEPc name — backed by ARPACK shift-invert here (no SLEPc needed)
get_mat_vp_slepc = get_mat_vp_shift_invert


def eigenproblem_slepc(a, e=None, n: int = 10, sigma: complex = 0.0,
                       return_vectors: bool = True):
    """Legacy entry point (ref: eig/eig_utils.py:83-253): generalized
    eigenproblem A x = λ E x near shift σ (ARPACK host path — see
    ``eig_arnoldi_dense_device`` for the on-device variant)."""
    a = sp.csr_matrix(a)
    e = sp.identity(a.shape[0], format="csr") if e is None else sp.csr_matrix(e)
    return get_mat_vp_shift_invert(a, e, n=n, sigma=sigma,
                                   return_vectors=return_vectors)


def modal_rom(a_csr, e_csr, b, c, shifts=(0.0 + 0.75j,), k_per_shift: int = 6,
              re_min: float = -1.0, pair_tol: float = 1e-6):
    """Real modal (Petrov-Galerkin) reduced-order model of Eẋ = Ax + Bu,
    y = Cx from biorthogonal eigenpairs near the given shifts.

    For each right pair (λ, v) of A x = λ E x the matching LEFT vector w
    (wᴴA = λ wᴴ) is the conjugated eigenvector of (Aᵀ, Eᵀ) at λ̄; scaling
    wᴴE v = 1 makes the modal coordinates exactly decoupled, so the ROM
    is block-diagonal by construction — no QR projection whose
    near-singular Er manufactures spurious unstable eigenvalues. Complex
    pairs realify to [[σ, ω], [-ω, σ]] blocks with B_k = [Re(wᴴB); Im(wᴴB)],
    C_k = 2[Cv_r, -Cv_i].

    This is the reduced-model step the reference performs offline in
    Matlab (ref: src/examples/cylinder/data_input/sysid_o16_d=3_ssest.mat
    is such a fitted ROM) — here derived directly from the exported
    operators. Returns (StateSpace, kept_eigenvalues).
    """
    import scipy.linalg as sla

    from flowcontrol_tpu_torch.utils.statespace import StateSpace

    a_csr = sp.csr_matrix(a_csr)
    e_csr = sp.csr_matrix(e_csr)
    b = np.atleast_2d(np.asarray(b, dtype=float))
    if b.shape[0] != a_csr.shape[0]:
        b = b.T
    c = np.atleast_2d(np.asarray(c, dtype=float))
    at, et = a_csr.T.tocsr(), e_csr.T.tocsr()

    rights, lefts = [], []
    for s in shifts:
        vals, vecs = get_mat_vp_shift_invert(a_csr, e_csr, n=k_per_shift,
                                             sigma=s)
        rights += [(vals[i], vecs[:, i]) for i in range(len(vals))]
        avals, avecs = get_mat_vp_shift_invert(at, et, n=k_per_shift,
                                               sigma=np.conj(s))
        lefts += [(avals[i], avecs[:, i]) for i in range(len(avals))]

    blocks_a, blocks_b, blocks_c, kept = [], [], [], []
    for lam, v in rights:
        if lam.real < re_min or lam.imag < -pair_tol:
            continue  # keep one of each conjugate pair, drop deep-damped
        if any(abs(lam - k) < 1e-6 * max(1.0, abs(lam)) for k in kept):
            continue  # dedup across shifts
        # matching left vector: wᴴA = λwᴴE ⇔ Aᵀw = λ̄ Eᵀw (A, E real), so
        # the left vector at λ IS the (Aᵀ, Eᵀ) eigenvector at λ̄ — no
        # conjugation (conjugating pairs it with the wrong eigenvalue and
        # biorthogonality zeroes every wᴴEv)
        errs = [abs(al - np.conj(lam)) for al, _ in lefts]
        j = int(np.argmin(errs))
        if errs[j] > pair_tol * max(1.0, abs(lam)):
            continue
        w = lefts[j][1]
        scale = w.conj() @ (e_csr @ v)
        if abs(scale) < 1e-10:
            continue  # defective/unmatched pair
        w = w / np.conj(scale)  # now wᴴ E v = 1
        beta = w.conj() @ b  # (m,) or (m_act,) rows
        cv = c @ v
        if abs(lam.imag) <= pair_tol:  # real mode: 1x1 block
            # the reference's block, kept: Re(wᴴB) Re(Cv) scales by cos²φ
            # with the phase φ ARPACK gives v (ROADMAP, "Faults in the
            # reference"); the residue is (Cv)(wᴴB)
            blocks_a.append(np.array([[lam.real]]))
            blocks_b.append(np.atleast_2d(beta.real))
            blocks_c.append(np.atleast_2d(cv.real).T)
        else:
            # residue algebra: H_pair(s) = R/(s-λ) + R̄/(s-λ̄) with
            # R = (Cv)(wᴴB) equals the real block below exactly
            # (= 2[(s-σ)Re R - ω Im R]/((s-σ)² + ω²))
            sg, om = lam.real, lam.imag
            blocks_a.append(np.array([[sg, -om], [om, sg]]))
            blocks_b.append(np.vstack([beta.real, beta.imag]))
            blocks_c.append(np.column_stack([2 * cv.real, -2 * cv.imag]))
        kept.append(lam)
    if not blocks_a:
        raise ValueError("modal_rom: no usable eigenpairs near the shifts")

    ar = sla.block_diag(*blocks_a)
    br = np.vstack(blocks_b)
    cr = np.hstack(blocks_c)
    return (
        StateSpace(ar, br, cr, np.zeros((cr.shape[0], br.shape[1]))),
        np.asarray(kept),
    )
