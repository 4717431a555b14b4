"""Preconditioned Krylov solvers for the saddle-point NS systems.

The counterpart of ``flowcontrol_tpu/solvers/krylov.py``, plus the port's
own copy of the GMRES and BiCGStab that the JAX package takes from
``jax.scipy.sparse.linalg`` (JAX 0.9.0, ``jax/_src/scipy/sparse/linalg.py``).
They replace the reference's MUMPS solve (ref: src/flowcontrol/
flowsolver.py:812-814) where no factor is kept:

- The operator (:class:`CsrOperator`) is the BC-eliminated matrix ``a_bc``
  of ``BCSet.eliminate_csr`` on the device: identity on constrained rows
  and columns (the lid cavity's pressure pin among them). The JAX
  package's ``MatFreeOperator`` applies the same matrix as masked element
  tensors through a gather table, ``A_e(x·free)·free + x·(1−free)``, which
  exists for the TPU; here one vector is ``torch.mv`` on the zero-free CSR
  and a batch is kernel S (``ops/spmm.py``).
- Preconditioner (:class:`SimplePreconditioner`): SIMPLE block
  factorization,
      z_u = F̂⁻¹ r_u
      z_p = Ŝ⁻¹ (D z_u − r_p)
      z_u ← z_u − F̂⁻¹ (G z_p)
  with F̂⁻¹ damped-Jacobi sweeps on the velocity block and Ŝ = D diag(F)⁻¹ G
  inverted densely on the host in f64, stored in the solve's dtype and
  applied as one product (``torch.matmul``).
- :func:`gmres` (``solve_method='batched'``) and :func:`bicgstab`: the
  JAX implementations transcribed with their semantics: left
  preconditioning (the Krylov vector is ``M(A v)``, the residual
  ``M(b − A x)``), classical Gram-Schmidt, least squares through the normal
  equations, BiCGStab's breakdown codes, and inner products over the whole
  array: a (B, n) right-hand side is ONE vector to them, so a batched solve
  is one Krylov solve of the block-diagonal system and a member's answer
  depends on its companions (to within the solve's tolerance once it has
  converged). The JAX loops stop on data; here every condition that only
  gates a pass (the restart loop's ``residual_norm > atol``, the Arnoldi
  breakdown, BiCGStab's stopping test) is a
  device-side select between the pass's result and the state before it, so
  a call never waits on the host and gives the JAX loop's numbers.
- :func:`fgmres` and :func:`fgmres_restarted`: the JAX package's
  right-preconditioned fixed-count FGMRES, ported as they are.

The JAX package's ``HookedOperator`` (an SPMD-sharded apply) waits for the
multi-GPU slice (ROADMAP.md).
"""

from __future__ import annotations

import time

import numpy as np
import scipy.sparse as sp
import torch

from flowcontrol_tpu_torch.ops.spmm import sparse_matvec


class CsrOperator:
    """``a_bc`` as a sparse CSR tensor (``core/stepper.csr_to_device``):
    ``apply(x)`` over the last dimension of x (..., n)."""

    def __init__(self, a: torch.Tensor):
        self.a = a

    def apply(self, x: torch.Tensor) -> torch.Tensor:
        return sparse_matvec(self.a, x)


class SimplePreconditioner:
    """SIMPLE block preconditioner with a dense Schur inverse."""

    def __init__(self, op, inv_diag_f: torch.Tensor, s_inv: torch.Tensor,
                 vel_mask: torch.Tensor, n_vel: int, jacobi_sweeps: int = 2,
                 omega: float = 0.8):
        self.op = op
        self.inv_diag_f = inv_diag_f  # (n,) 1/diag on velocity, 0 on pressure
        self.s_inv = s_inv  # (np_, np_) dense inverse of the approximate Schur
        self.vel_mask = vel_mask  # (n,) 1.0 on velocity dofs
        self.n_vel = n_vel
        self.jacobi_sweeps = jacobi_sweeps
        self.omega = omega

    def _f_hat_inv(self, r_u: torch.Tensor) -> torch.Tensor:
        """Damped-Jacobi approximate solve of F z = r_u (velocity block)."""
        z = self.inv_diag_f * r_u
        for _ in range(self.jacobi_sweeps - 1):
            az = self.op.apply(z * self.vel_mask) * self.vel_mask
            z = z + self.omega * self.inv_diag_f * (r_u - az)
        return z * self.vel_mask

    def apply(self, r: torch.Tensor) -> torch.Tensor:
        n_vel = self.n_vel
        r_u = r * self.vel_mask
        r_p = r[..., n_vel:]
        z_u = self._f_hat_inv(r_u)
        # D z_u = pressure rows of A(z_u, 0)
        d_zu = self.op.apply(z_u)[..., n_vel:]
        z_p = torch.matmul(d_zu - r_p, self.s_inv.T)
        # G z_p = velocity rows of A(0, z_p)
        zp_full = torch.zeros_like(r)
        zp_full[..., n_vel:] = z_p
        g_zp = self.op.apply(zp_full) * self.vel_mask
        z_u = z_u - self._f_hat_inv(g_zp)
        out = z_u * self.vel_mask
        out[..., n_vel:] = z_p
        return out


def build_simple_preconditioner(
    a_bc_csr, free_mask: np.ndarray, n_vel: int, op, device,
    dtype: torch.dtype = torch.float32, jacobi_sweeps: int = 2,
) -> SimplePreconditioner:
    """Host-side construction from the BC-applied sparse matrix (f64), as
    the JAX package's ``build_simple_preconditioner``; the vectors and the
    Schur inverse go to ``device`` in ``dtype``. ``free_mask`` is taken for
    the JAX signature and read nowhere, as there. ``build_seconds`` on the
    result is the host build's time."""
    del free_mask
    t0 = time.perf_counter()
    n = a_bc_csr.shape[0]
    diag = np.asarray(a_bc_csr.diagonal())
    inv_diag = np.zeros(n)
    vel_sel = np.zeros(n)
    vel_sel[:n_vel] = 1.0
    # bc rows have diag 1 → inv 1 (their "solve" is identity)
    inv_diag[:n_vel] = 1.0 / np.maximum(np.abs(diag[:n_vel]), 1e-30) * np.sign(
        np.where(diag[:n_vel] == 0, 1.0, diag[:n_vel])
    )
    f_diag_inv = sp.diags(inv_diag[:n_vel]).tocsr()
    g = a_bc_csr[:n_vel, n_vel:]
    d = a_bc_csr[n_vel:, :n_vel]
    s_hat = (d @ f_diag_inv @ g).toarray()
    # pressure rows that are themselves constrained (pressure pin) appear as
    # identity rows in A → keep them identity in S
    fixed_p = np.abs(s_hat).sum(axis=1) < 1e-14
    s_hat[fixed_p, :] = 0.0
    s_hat[fixed_p, fixed_p] = 1.0
    s_inv = np.linalg.inv(s_hat)

    def tensor(a):
        return torch.as_tensor(a, dtype=dtype, device=device)

    pc = SimplePreconditioner(
        op=op, inv_diag_f=tensor(inv_diag * vel_sel), s_inv=tensor(s_inv),
        vel_mask=tensor(vel_sel), n_vel=n_vel, jacobi_sweeps=jacobi_sweeps,
    )
    pc.build_seconds = time.perf_counter() - t0
    return pc


# ── GMRES and BiCGStab: jax.scipy.sparse.linalg (JAX 0.9.0) transcribed ────


def _norm(x: torch.Tensor) -> torch.Tensor:
    """The 2-norm of the whole array (the JAX ``_norm``)."""
    return torch.sqrt(torch.sum(x * x))


def _vdot(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """The inner product of the two whole arrays (real)."""
    return torch.dot(x.reshape(-1), y.reshape(-1))


def _safe_normalize(x: torch.Tensor, thresh=None):
    """(x / ‖x‖, ‖x‖), or (0, 0) where ‖x‖ is not above ``thresh`` (by
    default the dtype's machine epsilon, an absolute threshold)."""
    norm = _norm(x)
    if thresh is None:
        thresh = torch.finfo(x.dtype).eps
    use = norm > thresh
    return torch.where(use, x / norm, 0.0), torch.where(use, norm, 0.0)


def _project(q_rows: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Qᵀ v for the Krylov vectors stored as rows (k, ...) of ``q_rows``."""
    return q_rows.reshape(q_rows.shape[0], -1) @ v.reshape(-1)


def _combine(q_rows: torch.Tensor, h: torch.Tensor) -> torch.Tensor:
    """Q h: the rows of ``q_rows`` (k, ...) weighted by h (k,)."""
    return (h @ q_rows.reshape(q_rows.shape[0], -1)).reshape(q_rows.shape[1:])


def _iterative_classical_gram_schmidt(q_rows, x):
    """Orthogonalize x against the rows of ``q_rows``: (q, r), r the overlaps.

    One classical Gram-Schmidt pass, as JAX 0.9.0's
    ``_iterative_classical_gram_schmidt(..., max_iterations=2)`` computes:
    its docstring speaks of "twice is enough", but its loop tests
    ``k < max_iterations - 1`` after the first pass has made ``k = 1``, so a
    second pass never runs."""
    r = _project(q_rows, x)
    return x - _combine(q_rows, r), r


def _kth_arnoldi_iteration(k: int, A, M, V: torch.Tensor):
    """The k'th Arnoldi step: (V's row k + 1, H's row k, breakdown) for the
    new vector M(A(V[k])) orthonormalized against V's rows. The caller
    writes them (or not, after a breakdown)."""
    eps = torch.finfo(V.dtype).eps
    v = M(A(V[k]))
    _, v_norm_0 = _safe_normalize(v)
    v, h = _iterative_classical_gram_schmidt(V, v)
    unit_v, v_norm_1 = _safe_normalize(v, thresh=eps * v_norm_0)
    h[k + 1] = v_norm_1
    return unit_v, h, v_norm_1 == 0.0


def _lstsq(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """min ‖a y − b‖ through the normal equations, by Cholesky (JAX:
    ``solve(aᵀa, aᵀb, assume_a='pos')``); ``cholesky_ex`` checks nothing on
    the host, so the call does not wait for the device."""
    a2 = a.T @ a
    b2 = a.T @ b
    lower, _ = torch.linalg.cholesky_ex(a2)
    return torch.cholesky_solve(b2[:, None], lower)[:, 0]


def _gmres_batched(A, b, x0, unit_residual, residual_norm, restart: int, M):
    """One restart of GMRES(restart), the JAX ``_gmres_batched``: ``restart``
    Arnoldi steps (none written after a breakdown), then the least squares
    problem solved from scratch. Returns (x, unit residual, its norm)."""
    V = torch.zeros((restart + 1,) + tuple(b.shape), dtype=b.dtype, device=b.device)
    V[0] = unit_residual
    H = torch.eye(restart, restart + 1, dtype=b.dtype, device=b.device)
    broken = None
    for k in range(restart):
        unit_v, h, breakdown = _kth_arnoldi_iteration(k, A, M, V)
        if broken is None:
            V[k + 1], H[k] = unit_v, h
            broken = breakdown
        else:
            V[k + 1] = torch.where(broken, V[k + 1], unit_v)
            H[k] = torch.where(broken, H[k], h)
            broken = broken | breakdown
    beta_vec = torch.zeros(restart + 1, dtype=b.dtype, device=b.device)
    beta_vec[0] = residual_norm
    y = _lstsq(H.T, beta_vec)
    x = x0 + _combine(V[:-1], y)
    unit_residual, residual_norm = _safe_normalize(M(b - A(x)))
    return x, unit_residual, residual_norm


def _identity(x):
    return x


def gmres(A, b: torch.Tensor, x0: torch.Tensor | None = None, *, tol: float = 1e-5,
          atol: float = 0.0, restart: int = 20, maxiter: int | None = None, M=None):
    """GMRES for A x = b, as ``jax.scipy.sparse.linalg.gmres(...,
    solve_method='batched')``: up to ``maxiter`` restarts of ``restart``
    Arnoldi steps, each restart taken while ‖M(b − A x)‖ > max(tol·‖b‖,
    atol). ``A`` and ``M`` are callables over b's shape; b may carry leading
    dimensions, which the inner products span (one system). Returns (x,
    info), info -1 where x holds a NaN, else 0 (a 0-d tensor)."""
    if x0 is None:
        x0 = torch.zeros_like(b)
    if M is None:
        M = _identity
    size = b.numel()
    if maxiter is None:
        maxiter = 10 * size
    restart = min(restart, size)
    b_norm = _norm(b)
    atol_t = torch.clamp(tol * b_norm, min=atol)
    unit_residual, residual_norm = _safe_normalize(M(b - A(x0)))
    x = x0
    for _ in range(maxiter):
        go = residual_norm > atol_t
        x2, u2, r2 = _gmres_batched(A, b, x, unit_residual, residual_norm, restart, M)
        x = torch.where(go, x2, x)
        unit_residual = torch.where(go, u2, unit_residual)
        residual_norm = torch.where(go, r2, residual_norm)
    info = torch.where(torch.isnan(_norm(x)), -1, 0)
    return x, info


def bicgstab(A, b: torch.Tensor, x0: torch.Tensor | None = None, *, tol: float = 1e-5,
             atol: float = 0.0, maxiter: int | None = None, M=None):
    """BiCGStab for A x = b, as ``jax.scipy.sparse.linalg.bicgstab``:
    iterations while ‖r‖² > max(tol²‖b‖², atol²), fewer than ``maxiter``
    have run and no breakdown (k = −10: ρ = 0; −11: ω = 0 or α = 0) stopped
    it. Inner products span b's leading dimensions. Returns (x, None)."""
    if x0 is None:
        x0 = torch.zeros_like(b)
    if M is None:
        M = _identity
    if maxiter is None:
        maxiter = 10 * b.numel()
    bs = _vdot(b, b)
    atol2 = torch.clamp(tol * tol * bs, min=atol * atol)
    r0 = b - A(x0)
    one = torch.ones((), dtype=b.dtype, device=b.device)
    x, r, rhat, alpha, omega, rho, p, q = x0, r0, r0, one, one, one, r0, r0
    k = torch.zeros((), dtype=torch.int64, device=b.device)
    for _ in range(maxiter):
        go = (_vdot(r, r) > atol2) & (k < maxiter) & (k >= 0)
        rho_ = _vdot(rhat, r)
        beta = rho_ / rho * alpha / omega
        p_ = r + beta * (p - omega * q)
        phat = M(p_)
        q_ = A(phat)
        alpha_ = rho_ / _vdot(rhat, q_)
        s = r - alpha_ * q_
        exit_early = _vdot(s, s) < atol2
        shat = M(s)
        t = A(shat)
        omega_ = _vdot(t, s) / _vdot(t, t)
        x_ = torch.where(exit_early, x + alpha_ * phat, x + (alpha_ * phat + omega_ * shat))
        r_ = torch.where(exit_early, s, s - omega_ * t)
        k_ = torch.where((omega_ == 0) | (alpha_ == 0), -11, k + 1)
        k_ = torch.where(rho_ == 0, -10, k_)
        x, r, alpha, omega, rho, p, q, k = (
            torch.where(go, new, old) for new, old in
            ((x_, x), (r_, r), (alpha_, alpha), (omega_, omega), (rho_, rho), (p_, p),
             (q_, q), (k_, k)))
    return x, None


# ── FGMRES (fixed iteration count) ──────────────────────────────────────────


def fgmres(op_apply, precond_apply, b: torch.Tensor, x0: torch.Tensor, n_iter: int,
           tol: float = 0.0) -> torch.Tensor:
    """Right-preconditioned GMRES(m) without restarts, fixed m = n_iter, for
    one vector (n,): always n_iter iterations (``tol`` is unused, as in the
    JAX function; the caller checks convergence). Modified Gram-Schmidt;
    the least squares problem by the pseudo-inverse (JAX: ``lstsq``, by SVD)."""
    del tol
    m = n_iter
    r0 = b - op_apply(x0)
    beta = torch.linalg.vector_norm(r0)
    qs = [r0 / torch.where(beta > 0, beta, 1.0)]
    zs = []
    h = torch.zeros((m + 1, m), dtype=b.dtype, device=b.device)
    for k in range(m):
        z = precond_apply(qs[k])
        w = op_apply(z)
        for j in range(k + 1):
            proj = torch.dot(qs[j], w)
            w = w - proj * qs[j]
            h[j, k] = proj
        hk1 = torch.linalg.vector_norm(w)
        h[k + 1, k] = hk1
        qs.append(w / torch.where(hk1 > 1e-30, hk1, 1.0))
        zs.append(z)
    e1 = torch.zeros(m + 1, dtype=b.dtype, device=b.device)
    e1[0] = beta
    y = torch.linalg.pinv(h) @ e1
    return x0 + y @ torch.stack(zs)


def fgmres_restarted(op_apply, precond_apply, b: torch.Tensor, x0: torch.Tensor, m: int,
                     restarts: int) -> torch.Tensor:
    """FGMRES(m) with a fixed number of restart cycles."""
    x = x0
    for _ in range(restarts):
        x = fgmres(op_apply, precond_apply, b, x, m)
    return x
