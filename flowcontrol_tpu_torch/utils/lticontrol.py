"""LTI controller-synthesis toolbox.

A numpy/scipy transcription of ``flowcontrol_tpu/utils/lticontrol.py``
(ref: src/utils/lticontrol.py, 855 LoC on python-control + slycot, neither
needed here): state-space algebra, H2/H∞ norms, Youla parametrization
(plain / Laguerre / LQG-LFT / coprime), LQG synthesis, mixed-sensitivity
H∞/H2 synthesis (two-Riccati DGKF), normalized coprime factorizations,
balanced truncation with unstable-part preservation, controller-from-residues
parametrization, slow-fast decomposition, and bumpless-switching state
conditioning. Same names, signatures and arithmetic.

All routines are small dense numpy/scipy on the host; the resulting
controllers feed the device's fused closed-loop rollouts
(``core/controller.py`` ``stack_controllers``,
``Stepper.closed_loop_fn``).
"""

from __future__ import annotations

import numpy as np
import scipy.linalg as sla
import scipy.signal

from flowcontrol_tpu_torch.utils.statespace import StateSpace, c2d_zoh, ss, ss_inv

__all__ = [
    "read_matfile", "read_ss", "write_ss", "ssdata", "ss_zero", "ss_one",
    "ss_vstack", "ss_hstack", "ss_vstack_list", "ss_hstack_list",
    "ss_blkdiag_list", "ss_inv", "ss_transpose", "show_ss", "isstable",
    "isstablecl", "norm", "lft", "youla", "build_block_Psi", "youla_laguerre",
    "youla_laguerre_mimo", "youla_laguerre_K00", "youla_lqg",
    "youla_lqg_lftmat", "youla_Qab", "youla_Q0b", "youla_left_coprime",
    "youla_right_coprime", "lqr", "lqe", "lqg_regulator", "hinfsyn", "h2syn",
    "hinfsyn_mref", "basis_laguerre_canonical", "basis_laguerre",
    "basis_laguerre_canonical_ss", "basis_laguerre_ss", "basis_laguerre_K00",
    "rncf", "lncf", "gram", "balreal", "baltransform", "reduceorder",
    "sys_hsv", "balred_rel", "stab_unstab_decomp", "controller_residues",
    "controller_residues_getidx", "controller_residues_wrapper", "slowfast",
    "condswitch", "compare_controllers", "export_controller", "c2d",
]


# ── I/O (ref: lticontrol.py:20-42) ───────────────────────────────────────────


def read_matfile(path) -> dict:
    import scipy.io as sio
    import warnings

    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        return sio.loadmat(str(path))


def read_ss(path) -> StateSpace:
    d = read_matfile(path)
    return StateSpace(d["A"], d["B"], d["C"], d["D"])


read_regulator = read_ss


def write_ss(sys: StateSpace, path) -> None:
    import scipy.io as sio

    sio.savemat(str(path), {"A": sys.A, "B": sys.B, "C": sys.C, "D": sys.D})


def ssdata(sys: StateSpace):
    return (
        np.asarray(sys.A), np.asarray(sys.B),
        np.asarray(sys.C), np.asarray(sys.D),
    )


# ── Algebra (ref: lticontrol.py:48-138) ──────────────────────────────────────


def ss_zero() -> StateSpace:
    return StateSpace(np.zeros((0, 0)), np.zeros((0, 1)), np.zeros((1, 0)), 0.0)


def ss_one() -> StateSpace:
    return StateSpace(np.zeros((0, 0)), np.zeros((0, 1)), np.zeros((1, 0)), 1.0)


def ss_vstack(sys1: StateSpace, *sysn) -> StateSpace:
    """Matlab [sys1; sys2]: same input, stacked outputs."""
    out = sys1
    for s2 in sysn:
        a = sla.block_diag(out.A, s2.A)
        b = np.vstack([out.B, s2.B])
        c = sla.block_diag(out.C, s2.C)
        d = np.vstack([out.D, s2.D])
        out = StateSpace(a, b, c, d)
    return out


def ss_hstack(sys1: StateSpace, *sysn) -> StateSpace:
    """Matlab [sys1, sys2]: stacked inputs, summed outputs."""
    out = sys1
    for s2 in sysn:
        a = sla.block_diag(out.A, s2.A)
        b = sla.block_diag(out.B, s2.B)
        c = np.hstack([out.C, s2.C])
        d = np.hstack([out.D, s2.D])
        out = StateSpace(a, b, c, d)
    return out


def ss_vstack_list(syslist) -> StateSpace:
    return ss_vstack(syslist[0], *syslist[1:])


def ss_hstack_list(syslist) -> StateSpace:
    return ss_hstack(syslist[0], *syslist[1:])


def ss_blkdiag_list(sys_list) -> StateSpace:
    out = sys_list[0]
    for s2 in sys_list[1:]:
        out = StateSpace(
            sla.block_diag(out.A, s2.A),
            sla.block_diag(out.B, s2.B),
            sla.block_diag(out.C, s2.C),
            sla.block_diag(out.D, s2.D),
        )
    return out


def ss_transpose(g: StateSpace) -> StateSpace:
    return StateSpace(g.A.T, g.C.T, g.B.T, g.D.T)


def show_ss(sys: StateSpace) -> None:
    for name, m in zip("ABCD", ssdata(sys)):
        print(f"{name} =\n{m}")


def c2d(sys: StateSpace, dt: float, method: str = "zoh"):
    """Discretize: ZOH or Tustin. Returns (Ad, Bd, Cd, Dd)."""
    if method == "zoh":
        return c2d_zoh(sys, dt)
    if method == "tustin":
        a, b, c, d = ssdata(sys)
        n = sys.nstates
        m_ = np.eye(n) - (dt / 2) * a
        mi = np.linalg.inv(m_)
        ad = mi @ (np.eye(n) + (dt / 2) * a)
        bd = mi @ b * dt
        cd = c @ mi
        dd = d + (dt / 2) * c @ mi @ b
        return ad, bd, cd, dd
    raise ValueError(f"unknown method {method}")


# ── Stability and norms (ref: lticontrol.py:144-177) ─────────────────────────


def isstable(cl: StateSpace) -> bool:
    if cl.nstates == 0:
        return True
    return bool(np.all(np.real(np.linalg.eigvals(cl.A)) < 0))


def isstablecl(g: StateSpace, k0: StateSpace, sign=+1) -> bool:
    return isstable(g.feedback(k0, sign=sign))


def gram(g: StateSpace, kind: str) -> np.ndarray:
    """Controllability ('c') or observability ('o') gramian (stable g)."""
    if kind.startswith("c"):
        return sla.solve_continuous_lyapunov(g.A, -g.B @ g.B.T)
    return sla.solve_continuous_lyapunov(g.A.T, -g.C.T @ g.C)


def h2norm(g: StateSpace) -> float:
    if not isstable(g):
        return np.inf
    if np.any(g.D != 0):
        return np.inf
    if g.nstates == 0:
        return 0.0
    wc = gram(g, "c")
    return float(np.sqrt(max(np.trace(g.C @ wc @ g.C.T), 0.0)))


def linfnorm(g: StateSpace, tol: float = 1e-8) -> float:
    """L∞ norm by Hamiltonian bisection (Boyd-Balakrishnan-Kabamba)."""
    a, b, c, d = ssdata(g)
    if g.nstates == 0:
        return float(np.linalg.norm(d, 2))
    # lower bound: max of dc gain, |D|, gain at a few frequencies
    svmax = lambda m: np.linalg.norm(m, 2)
    lo = svmax(d)
    for w in [0.0, 0.01, 0.1, 1.0, 10.0, 100.0]:
        h = c @ np.linalg.solve(1j * w * np.eye(g.nstates) - a, b) + d
        lo = max(lo, svmax(h))
    hi = max(2 * lo, 1e-6)

    def has_imag_eig(gam):
        r = gam**2 * np.eye(d.shape[1]) - d.T @ d
        try:
            rinv = np.linalg.inv(r)
        except np.linalg.LinAlgError:
            return True
        ham = np.block(
            [
                [a + b @ rinv @ d.T @ c, b @ rinv @ b.T],
                [-c.T @ (np.eye(d.shape[0]) + d @ rinv @ d.T) @ c,
                 -(a + b @ rinv @ d.T @ c).T],
            ]
        )
        ev = np.linalg.eigvals(ham)
        return bool(np.any(np.abs(ev.real) < 1e-8 * (1 + np.abs(ev.imag))))

    while has_imag_eig(hi):
        hi *= 2
        if hi > 1e14:
            return np.inf
    while (hi - lo) > tol * (1 + lo):
        mid = 0.5 * (lo + hi)
        if has_imag_eig(mid):
            lo = mid
        else:
            hi = mid
    return 0.5 * (lo + hi)


def norm(g: StateSpace, p=np.inf) -> float:
    """H2 or H∞ norm; inf for unstable systems (ref: lticontrol.py:154-177)."""
    if p not in (2, np.inf):
        raise ValueError("p must be 2 or np.inf")
    if not isstable(g):
        return np.inf
    return h2norm(g) if p == 2 else linfnorm(g)


# ── LFT (lower linear fractional transformation) ─────────────────────────────


def lft(p: StateSpace, k: StateSpace, ny: int | None = None, nu: int | None = None) -> StateSpace:
    """Lower LFT: close the LAST ny outputs / nu inputs of P around K."""
    nu = nu if nu is not None else k.noutputs
    ny = ny if ny is not None else k.ninputs
    a, b, c, d = ssdata(p)
    nz = p.noutputs - ny
    nw = p.ninputs - nu
    b1, b2 = b[:, :nw], b[:, nw:]
    c1, c2 = c[:nz, :], c[nz:, :]
    d11, d12 = d[:nz, :nw], d[:nz, nw:]
    d21, d22 = d[nz:, :nw], d[nz:, nw:]
    ak, bk, ck, dk = ssdata(k)
    r = np.eye(nu) - dk @ d22
    rinv = np.linalg.inv(r)
    s = np.eye(ny) - d22 @ dk
    sinv = np.linalg.inv(s)
    a_cl = np.block(
        [
            [a + b2 @ rinv @ dk @ c2, b2 @ rinv @ ck],
            [bk @ sinv @ c2, ak + bk @ sinv @ d22 @ ck],
        ]
    )
    b_cl = np.vstack([b1 + b2 @ rinv @ dk @ d21, bk @ sinv @ d21])
    c_cl = np.hstack([c1 + d12 @ rinv @ dk @ c2, d12 @ rinv @ ck])
    d_cl = d11 + d12 @ rinv @ dk @ d21
    return StateSpace(a_cl, b_cl, c_cl, d_cl)


# ── LQR / LQE / LQG (ref: lticontrol.py:341-374) ─────────────────────────────


def lqr(a, b, q, r):
    """Continuous LQR: returns (K, P) with u = -K x."""
    p = sla.solve_continuous_are(a, b, q, r)
    k = np.linalg.solve(r, b.T @ p)
    return k, p


def lqe(a, g_cov, c, qw, rv):
    """Kalman filter gain: returns (L, P) with observer x' = Ax + L(y - Cx)."""
    p = sla.solve_continuous_are(a.T, c.T, g_cov @ qw @ g_cov.T, rv)
    l_gain = p @ c.T @ np.linalg.inv(rv)
    return l_gain, p


def lqg_regulator(g: StateSpace, qx: float, ru: float, qw: float, rv: float):
    """LQG regulator with scalar weights (ref: lticontrol.py:341-374).

    Returns (Klqg, F, L) with F the state feedback (u = F x) and
    L = -L_kalman (sign convention ẋ = (A + LC)x + ...).
    """
    a, b, c, d = ssdata(g)
    n = a.shape[0]
    p, m = d.shape
    f = -lqr(a, b, qx * np.eye(n), ru * np.eye(m))[0]
    l_kal, _ = lqe(a, np.eye(n), c, qw * np.eye(n), rv * np.eye(p))
    l = -l_kal
    klqg = StateSpace(a + b @ f + l @ c + l @ d @ f, -l, f, np.zeros((m, p)))
    return klqg, np.asarray(f), np.asarray(l)


def dlqg_regulator(g: StateSpace, dt: float, qx=1.0, ru=1.0, qw=1.0,
                   rv=1.0, Q=None, Qw=None):
    """Sampled-data LQG: exact ZOH discretization of ``g`` then the two
    DISCRETE Riccati equations, so the sampled closed loop is stable by
    the discrete separation principle.

    Continuous-LQG + per-loop ZOH (``lqg_regulator`` -> Controller) fails
    when the compensator carries fast unstable poles: the pinball Re=100
    design (K max Re +51.6, dt 5e-3, |lam_K| dt ~ 0.26) is continuous-
    stable but its sampled interconnection has spectral radius > 1
    (measured, round 5). This synthesizes directly in discrete time.

    ``Q``/``Qw`` override the scalar qx/qw with full state-weight
    matrices (e.g. unstable-subspace-focused). Returns (Kd, F, L): the
    DISCRETE predictor-form compensator
    ``xk+ = (Ad - Bd F - L Cd) xk + L y,  u = -F xk`` as a StateSpace
    whose matrices are the sampled ones (deploy via
    ``Controller.from_matrices(..., dt=dt)`` or export with ``dt``).
    """
    from scipy.linalg import solve_discrete_are

    # known fault kept from the JAX package (its lticontrol.py:331): l below
    # is the FILTER Kalman gain, used in a PREDICTOR-form compensator, so
    # the closed loop's poles are eig(Ad - Bd F) and eig(Ad - L Cd), and the
    # second set is not guaranteed inside the unit circle: with a plant
    # pole at 30 and dt = 0.02 the sampled closed loop's spectral radius is
    # 1.0085 (the predictor gain Ad L gives 0.798), so the docstring's
    # stability claim does not hold. To be fixed in both packages at once.
    ad, bd, cd, dd = (np.asarray(m) for m in c2d_zoh(g, dt))
    if np.any(dd):
        raise ValueError("dlqg_regulator assumes D=0")
    n = ad.shape[0]
    p, m = dd.shape
    q = qx * np.eye(n) if Q is None else np.asarray(Q)
    qn = qw * np.eye(n) if Qw is None else np.asarray(Qw)
    pf = solve_discrete_are(ad, bd, q, ru * np.eye(m))
    f = np.linalg.solve(ru * np.eye(m) + bd.T @ pf @ bd, bd.T @ pf @ ad)
    pl = solve_discrete_are(ad.T, cd.T, qn, rv * np.eye(p))
    l = pl @ cd.T @ np.linalg.inv(cd @ pl @ cd.T + rv * np.eye(p))
    kd = StateSpace(ad - bd @ f - l @ cd, l, -f, np.zeros((m, p)))
    return kd, np.asarray(f), np.asarray(l)


# ── H∞ / H2 synthesis (two-Riccati DGKF) ─────────────────────────────────────


def _dgkf_partition(p: StateSpace, ny: int, nu: int):
    a, b, c, d = ssdata(p)
    nz = p.noutputs - ny
    nw = p.ninputs - nu
    return (
        a, b[:, :nw], b[:, nw:], c[:nz, :], c[nz:, :],
        d[:nz, :nw], d[:nz, nw:], d[nz:, :nw], d[nz:, nw:], nz, nw,
    )


def h2syn(p: StateSpace, ny: int, nu: int) -> StateSpace:
    """H2-optimal controller (standard two-Riccati solution).

    Assumes D11 = 0, D12 full column rank, D21 full row rank.
    """
    a, b1, b2, c1, c2, d11, d12, d21, d22, nz, nw = _dgkf_partition(p, ny, nu)
    r12 = d12.T @ d12
    r21 = d21 @ d21.T
    x = sla.solve_continuous_are(
        a, b2, c1.T @ c1, r12, s=c1.T @ d12
    )
    y = sla.solve_continuous_are(
        a.T, c2.T, b1 @ b1.T, r21, s=b1 @ d21.T
    )
    f2 = -np.linalg.solve(r12, b2.T @ x + d12.T @ c1)
    l2 = -(y @ c2.T + b1 @ d21.T) @ np.linalg.inv(r21)
    ak = a + b2 @ f2 + l2 @ c2 + l2 @ d22 @ f2
    k = StateSpace(ak, -l2, f2, np.zeros((nu, ny)))
    return k


def hinfsyn(p: StateSpace, ny: int, nu: int, gamma_range=(1e-3, 1e4),
            tol: float = 1e-3, max_iter: int = 80):
    """Suboptimal H∞ central controller by gamma bisection.

    General D11 is handled via the Glover-Doyle formulas (Zhou, Doyle,
    Glover, "Robust and Optimal Control", ch. 17): D12/D21 are first
    normalized to [0; I] / [0 I] by SVD (unitary rotations of z/w plus
    invertible u/y scalings absorbed back into the controller), then the two
    gamma-dependent Riccati equations with D11 cross terms give the central
    controller. Requires D12 full column rank, D21 full row rank,
    nz >= nu, nw >= ny. Returns (K, gamma_achieved).
    (ref: lticontrol.py:336-378 delegates this to python-control/slycot.)
    """
    a, b1, b2, c1, c2, d11, d12, d21, d22, nz, nw = _dgkf_partition(p, ny, nu)
    n = a.shape[0]
    if nz < nu or nw < ny:
        raise ValueError("hinfsyn: need nz >= nu and nw >= ny")

    # ── Normalize D12 -> [0; I] (nz x nu) and D21 -> [0 I] (ny x nw) ────────
    u12, s12, v12t = np.linalg.svd(d12)  # full: u12 (nz,nz), v12t (nu,nu)
    if nu and (s12.size < nu or s12[nu - 1] <= 1e-12 * max(1.0, s12[0])):
        raise ValueError("hinfsyn: D12 must have full column rank")
    uz = u12[:, np.r_[nu:nz, 0:nu]]          # z' = uz.T z  (range of D12 last)
    su = v12t.T @ np.diag(1.0 / s12)         # u = su u'
    u21, s21, v21t = np.linalg.svd(d21)      # u21 (ny,ny), v21t (nw,nw)
    if ny and (s21.size < ny or s21[ny - 1] <= 1e-12 * max(1.0, s21[0])):
        raise ValueError("hinfsyn: D21 must have full row rank")
    vw = v21t.T[:, np.r_[ny:nw, 0:ny]]       # w = vw w'  (range part last)
    sy = np.diag(1.0 / s21) @ u21.T          # y' = sy y

    c1n = uz.T @ c1
    b1n = b1 @ vw
    b2n = b2 @ su
    c2n = sy @ c2
    d11n = uz.T @ d11 @ vw
    d12n = uz.T @ d12 @ su                    # = [0; I]
    d21n = sy @ d21 @ vw                      # = [0 I]

    # D11 partitions conformal with the normalized D12/D21 structure
    nzr, nwr = nz - nu, nw - ny               # "full-rank-free" block sizes
    d1111 = d11n[:nzr, :nwr]
    d1112 = d11n[:nzr, nwr:]
    d1121 = d11n[nzr:, :nwr]
    d1122 = d11n[nzr:, nwr:]

    def _smax(m):
        return float(np.linalg.svd(m, compute_uv=False)[0]) if m.size else 0.0

    gamma0 = max(
        _smax(np.hstack([d1111, d1112])), _smax(np.vstack([d1111, d1121]))
    )

    bmat = np.hstack([b1n, b2n])
    cmat = np.vstack([c1n, c2n])
    d1dot = np.hstack([d11n, d12n])           # nz x (nw+nu)
    ddot1 = np.vstack([d11n, d21n])           # (nz+ny) x nw

    def try_gamma(gam):
        g2 = gam**2
        if gam <= gamma0 * (1 + 1e-12):
            return None
        try:
            # X Riccati: A'X+XA+C1'C1 - (XB+C1'D1.)R^{-1}(B'X+D1.'C1) = 0
            r = d1dot.T @ d1dot - sla.block_diag(
                g2 * np.eye(nw), np.zeros((nu, nu))
            )
            s = c1n.T @ d1dot
            x = sla.solve_continuous_are(a, bmat, c1n.T @ c1n, r, s=s)
            f = -np.linalg.solve(r, d1dot.T @ c1n + bmat.T @ x)
            # Y Riccati (dual)
            rt = ddot1 @ ddot1.T - sla.block_diag(
                g2 * np.eye(nz), np.zeros((ny, ny))
            )
            st = b1n @ ddot1.T
            y = sla.solve_continuous_are(a.T, cmat.T, b1n @ b1n.T, rt, s=st)
            lmat = -np.linalg.solve(rt, cmat @ y + st.T).T
            if np.any(np.linalg.eigvalsh((x + x.T) / 2) < -1e-8):
                return None
            if np.any(np.linalg.eigvalsh((y + y.T) / 2) < -1e-8):
                return None
            rho = max(np.abs(np.linalg.eigvals(x @ y)), default=0.0)
            if rho >= g2 * (1 - 1e-9):
                return None
            # scipy's ARE with indefinite R can return a non-stabilizing
            # solution; require X, Y to actually be stabilizing
            if n and np.any(np.real(np.linalg.eigvals(a + bmat @ f)) >= -1e-10):
                return None
            if n and np.any(np.real(np.linalg.eigvals(a + lmat @ cmat)) >= -1e-10):
                return None
            f1, f2 = f[:nw, :], f[nw:, :]
            f12 = f1[nwr:, :]                 # last ny rows of F1
            l2 = lmat[:, nz:]
            l12 = lmat[:, nzr:nz]             # last nu cols of L1
            # central-controller feedthrough terms (ZDG thm 17.1)
            m1 = g2 * np.eye(nzr) - d1111 @ d1111.T
            m2 = g2 * np.eye(nwr) - d1111.T @ d1111
            d11h = -d1121 @ d1111.T @ np.linalg.solve(m1, d1112) - d1122
            d12h = np.linalg.cholesky(
                np.eye(nu) - d1121 @ np.linalg.solve(m2, d1121.T)
            )
            d21h = np.linalg.cholesky(
                np.eye(ny) - d1112.T @ np.linalg.solve(m1, d1112)
            ).T
            z = np.linalg.inv(np.eye(n) - y @ x / g2)
            b2h = z @ (b2n + l12) @ d12h
            c2h = -d21h @ (c2n + f12)
            b1h = -z @ l2 + b2h @ np.linalg.solve(d12h, d11h)
            c1h = f2 + d11h @ np.linalg.solve(d21h, c2h)
            ah = a + bmat @ f + b1h @ np.linalg.solve(d21h, c2h)
            # back to original u/y coordinates: K = su K' sy
            k = StateSpace(ah, b1h @ sy, su @ c1h, su @ d11h @ sy)
            if np.abs(d22).max() > 0:
                # absorb plant feedthrough: K <- K (I + D22 K)^{-1}
                d22sys = StateSpace(
                    np.zeros((0, 0)), np.zeros((0, nu)), np.zeros((ny, 0)), d22
                )
                k = k.feedback(d22sys, sign=-1)
            cl = lft(p, k, ny=ny, nu=nu)
            if not isstable(cl):
                return None
            # belt-and-braces: the achieved closed-loop norm must beat gamma
            # (guards residual numerical issues in the indefinite AREs)
            if norm(cl, np.inf) >= gam * (1 + 1e-9):
                return None
            return k
        except (np.linalg.LinAlgError, ValueError):
            return None

    lo, hi = gamma_range
    lo = max(lo, gamma0)
    k_hi = try_gamma(hi)
    if k_hi is None:
        raise RuntimeError("hinfsyn: no stabilizing controller found at gamma_max")
    best = (k_hi, hi)
    for _ in range(max_iter):
        if (hi - lo) <= tol * (1 + lo):
            break
        mid = np.sqrt(lo * hi) if lo > 0 else 0.5 * (lo + hi)
        k_mid = try_gamma(mid)
        if k_mid is None:
            lo = mid
        else:
            hi = mid
            best = (k_mid, mid)
    return best


def hinfsyn_mref(g, we, wu, wb, wr, cl_ref, wcl, syn: str = "Hinf"):
    """SISO mixed-sensitivity synthesis with model reference
    (ref: lticontrol.py:380-413; negative feedback convention).

    Builds the generalized plant with weighted outputs
    [We·e; Wu·u; Wcl·(e_model)] and inputs [Wr·r; Wb·b; u], then runs H∞ or
    H2 synthesis. Returns (K, achieved closed-loop norm).
    """
    if syn not in ("Hinf", "H2"):
        raise ValueError("Only Hinf or H2 synthesis supported")
    zo = ss_zero()
    id_ = ss_one()
    wout = ss_blkdiag_list([we, wu, wcl, id_])
    win = ss_blkdiag_list([wr, wb, id_])
    p_syn = (
        ss_vstack(
            ss_hstack(id_, -id_, zo, zo),
            ss_hstack(zo, zo, id_, zo),
            ss_hstack(zo, id_, zo, -id_),
            ss_hstack(id_, -id_, zo, zo),
        )
        * ss_blkdiag_list([id_, g, id_, cl_ref])
        * ss_vstack(
            ss_hstack(id_, zo, zo),
            ss_hstack(zo, id_, id_),
            ss_hstack(zo, zo, id_),
            ss_hstack(zo, id_, zo),
        )
    )
    p_syn = wout * p_syn * win
    if syn == "Hinf":
        k, _ = hinfsyn(p_syn, 1, 1)
    else:
        k = h2syn(p_syn, 1, 1)
    return k, norm(lft(p_syn, k, ny=1, nu=1))


# ── Youla parametrization (ref: lticontrol.py:183-335) ───────────────────────


def build_block_Psi(g: StateSpace) -> StateSpace:
    """Block function Psi for Youla: SISO [0,1; I,-G]; SIMO generalization
    (ref: lticontrol.py:208-228)."""
    ny = g.noutputs
    o1 = ss_one()
    z1 = StateSpace(np.zeros((0, 0)), np.zeros((0, ny)), np.zeros((1, 0)),
                    np.zeros((1, ny)))
    e1 = StateSpace(np.zeros((0, 0)), np.zeros((0, ny)), np.zeros((ny, 0)),
                    np.eye(ny))
    return ss_vstack(ss_hstack(z1, o1), ss_hstack(e1, -g))


def youla(g: StateSpace, k0: StateSpace, q: StateSpace) -> StateSpace:
    """K = K0 + Psi.lft(Q), positive feedback convention
    (ref: lticontrol.py:183-205)."""
    gstab = g.feedback(other=k0, sign=+1)
    psi = build_block_Psi(gstab)
    kq = lft(psi, q)
    return k0 + kq


def youla_laguerre(g, k0, p, theta, verbose=False) -> StateSpace:
    """Youla controller with Laguerre-basis Q = θᵀΦ(s). SISO
    (ref: lticontrol.py:231-250)."""
    q = basis_laguerre_ss(p, theta)
    return youla(g, k0, q)


def youla_laguerre_mimo(g, k0, p, theta, verbose=False) -> StateSpace:
    """Youla for a SIMO plant: one Laguerre parameter vector per output
    channel, stacked horizontally (ref: lticontrol.py:252-281)."""
    theta = np.atleast_2d(np.asarray(theta, float))
    ny = g.noutputs
    if theta.shape[0] != ny:
        theta = theta.reshape(ny, -1)
    qs = [basis_laguerre_ss(p, theta[i]) for i in range(ny)]
    q = ss_hstack_list(qs)
    return youla(g, k0, q)


def youla_laguerre_K00(g, k0, p, theta, check=False) -> StateSpace:
    """Youla controller constrained to K(0) = 0, SISO
    (ref: lticontrol.py:284-290)."""
    q00 = basis_laguerre_K00(g, k0, p, theta)
    k = youla(g, k0, q00)
    if check:
        assert abs(np.asarray(k.dcgain()).ravel()[0]) < 1e-6
    return k


def youla_lqg(g, qx, ru, qw, rv, q) -> StateSpace:
    """Youla controller in LQG observer form (ref: lticontrol.py:293-297)."""
    j = youla_lqg_lftmat(g, qx, ru, qw, rv)
    return lft(j, q)


def youla_lqg_lftmat(g, qx, ru, qw, rv) -> StateSpace:
    """StateSpace J to be LFTed with Q for the LQG-form Youla parametrization
    (ref: lticontrol.py:299-311)."""
    _, b, c, d = ssdata(g)
    p_, m = d.shape
    klqg, f, l = lqg_regulator(g, qx, ru, qw, rv)
    return StateSpace(
        klqg.A,
        np.hstack((klqg.B, b + l @ d)),
        np.vstack((klqg.C, -c - d @ f)),
        np.block([[np.zeros((m, p_)), np.eye(m)], [np.eye(p_), klqg.D]]),
    )


def youla_Qab(ka, kb, gstab) -> StateSpace:
    """Qab such that Youla(G, Ka, Qab) = Kb (ref: lticontrol.py:314-317)."""
    return (kb - ka).feedback(gstab, sign=+1)


def youla_Q0b(ka, k0, g) -> StateSpace:
    """Q0b such that Youla(G, K0, Q0b) = Ka (ref: lticontrol.py:319-322)."""
    return (ka - k0).feedback(g.feedback(k0, sign=+1), sign=+1)


def youla_left_coprime(g, k, q) -> StateSpace:
    """Youla from left normalized coprime factors (ref: lticontrol.py:324-329)."""
    _, ml, nl = lncf(g)
    _, vl, ul = lncf(k)
    return ss_inv(vl + q * nl) * (ul + q * ml)


def youla_right_coprime(g, k, q) -> StateSpace:
    """Youla from right normalized coprime factors (ref: lticontrol.py:331-335)."""
    _, mr, nr = rncf(g)
    _, vr, ur = rncf(k)
    return (ur + mr * q) * ss_inv(vr + nr * q)


# ── Laguerre basis (ref: lticontrol.py:419-470) ─────────────────────────────


def basis_laguerre_canonical(p: float, n: int):
    """First N Laguerre transfer functions φ_i(s) as (num, den) coefficient
    pairs: φ_i = sqrt(2p)·(s-p)^{i-1}/(s+p)^i (ref: lticontrol.py:419-428)."""
    out = []
    for i in range(n):
        num = np.sqrt(2 * p) * np.poly([p] * i)  # (s-p)^i
        den = np.poly([-p] * (i + 1))  # (s+p)^{i+1}
        out.append((num, den))
    return out


def basis_laguerre(p: float, theta):
    """Q(s) = Σ θ_i φ_i(s) as a (num, den) pair (ref: lticontrol.py:430-434)."""
    theta = np.atleast_1d(np.asarray(theta, float))
    basis = basis_laguerre_canonical(p, len(theta))
    den = np.poly([-p] * len(theta))  # common denominator (s+p)^N
    num = np.zeros(len(theta) + 1)
    for i, (ni, _) in enumerate(basis):
        # multiply φ_i's numerator by (s+p)^{N-1-i} to reach the common den
        fill = np.poly([-p] * (len(theta) - 1 - i))
        term = np.polymul(ni, fill) * theta[i]
        num = np.polyadd(num, term)
    return num, den


def basis_laguerre_canonical_ss(p: float, n: int) -> StateSpace:
    """First N Laguerre basis elements as one 1-output N-input StateSpace
    (ref: lticontrol.py:436-445, canonical triangular realization)."""
    a = p
    a_vec = np.hstack((-a, 2 * a * (-1.0) ** (np.arange(2, n + 1))))
    a2 = np.triu(sla.circulant(a_vec).T)
    b2 = np.diag((-1.0) ** (np.arange(2, n + 2)))
    c2 = np.sqrt(2 * a) * (-1.0) ** (np.arange(2, n + 2))
    d2 = np.zeros((1, n))
    return StateSpace(a2, b2, c2.reshape(1, -1), d2)


def basis_laguerre_ss(p: float, theta) -> StateSpace:
    """Q = Σ θ_i φ_i(s; p) as a SISO StateSpace (ref: lticontrol.py:447-452)."""
    theta = np.atleast_1d(np.asarray(theta, float))
    phi = basis_laguerre_canonical_ss(p, len(theta))
    th = np.atleast_2d(theta).T  # (N, 1) input mixer
    return StateSpace(phi.A, phi.B @ th, phi.C, phi.D @ th)


def basis_laguerre_K00(g, k0, p, theta) -> StateSpace:
    """Laguerre Q enforcing K(0) = 0 via a null-space reparametrization, SISO
    (ref: lticontrol.py:454-470)."""
    theta = np.atleast_1d(np.asarray(theta, float))
    n = len(theta)
    k00 = float(np.asarray(k0.dcgain()).ravel()[0])
    gstab = g.feedback(k0, sign=+1)
    g00 = float(np.asarray(gstab.dcgain()).ravel()[0])
    b0 = -k00 / (1 + k00 * g00)
    a0 = b0 * np.sqrt(p / 2)
    j = np.atleast_2d(np.ones(n + 1) * (-1.0) ** np.arange(n + 1))
    y0 = sla.lstsq(j, np.array([a0]))[0]
    ker = sla.null_space(j)
    y = y0 + ker @ theta
    return basis_laguerre_ss(p=p, theta=y)


# ── Normalized coprime factorizations (ref: lticontrol.py:473-514) ───────────


def rncf(g: StateSpace):
    """Right normalized coprime factorization G = Nr·Mr⁻¹.

    Returns (FACT, Mr, Nr) with FACT = [Mr; Nr] inner
    (ref: lticontrol.py:473-502)."""
    a, b, c, d = ssdata(g)
    n = a.shape[0]
    p_, m = d.shape
    if n > 0:
        q = np.zeros((n, n))
        r = np.block([[np.eye(m), d.T], [d, -np.eye(p_)]])
        s = np.hstack((np.zeros((n, m)), c.T))
        bb = np.hstack((b, np.zeros((n, p_))))
        x = sla.solve_continuous_are(a, bb, q, r, s=s)
        k = np.linalg.solve(r, bb.T @ x + s.T)
    else:
        k = np.zeros((m + p_, n))
    _, sv, vh = sla.svd(d)
    v = vh.conj().T
    nsv = min(p_, m)
    diag_vec = np.hstack((1 / np.sqrt(1 + sv[:nsv] ** 2), np.ones(m - nsv)))
    z = v @ np.diag(diag_vec) @ vh
    f = -k[:m, :]
    amn = a + b @ f
    bmn = b @ z
    cmn = np.vstack((f, c + d @ f))
    dmn = np.vstack((z, d @ z))
    fact = StateSpace(amn, bmn, cmn, dmn)
    mr = StateSpace(amn, bmn, cmn[:m, :], dmn[:m, :])
    nr = StateSpace(amn, bmn, cmn[m:, :], dmn[m:, :])
    return fact, mr, nr


def lncf(g: StateSpace):
    """Left normalized coprime factorization G = Ml⁻¹·Nl
    (ref: lticontrol.py:505-514)."""
    fact = ss_transpose(rncf(ss_transpose(g))[0])
    amn, bmn, cmn, dmn = ssdata(fact)
    ncols_ml = g.noutputs
    ml = StateSpace(amn, bmn[:, :ncols_ml], cmn, dmn[:, :ncols_ml])
    nl = StateSpace(amn, bmn[:, ncols_ml:], cmn, dmn[:, ncols_ml:])
    return fact, ml, nl


# ── Balanced reduction (ref: lticontrol.py:520-633) ─────────────────────────


def baltransform(g: StateSpace) -> np.ndarray:
    """Balancing transformation T (Laub-Heath-Paige-Ward 1987)
    (ref: lticontrol.py:528-551)."""
    wo = gram(g, "o")
    wc = gram(g, "c")
    lo = np.linalg.cholesky(wo + 1e-300 * np.eye(len(wo)))
    lc = np.linalg.cholesky(wc + 1e-300 * np.eye(len(wc)))
    _, sv, vvh = np.linalg.svd(lo.T @ lc)
    return np.asarray(lc @ vvh.T @ np.diag(1 / np.sqrt(sv)))


def balreal(g: StateSpace) -> StateSpace:
    """Balanced realization of a stable G (ref: lticontrol.py:520-525)."""
    t = baltransform(g)
    a, b, c, d = ssdata(g)
    ti = np.linalg.inv(t)
    return StateSpace(ti @ a @ t, ti @ b, c @ t, d)


def stab_unstab_decomp(g: StateSpace):
    """Additive decomposition G = G_stable + G_unstable (+ D on the stable
    part) via ordered real Schur + Sylvester decoupling."""
    a, b, c, d = ssdata(g)
    n = a.shape[0]
    if n == 0:
        return g, None
    t, z, ndim = sla.schur(a, output="real", sort=lambda x: x.real < 0)
    ns = int(ndim)
    if ns == n:
        return g, None
    if ns == 0:
        zero = StateSpace(np.zeros((0, 0)), np.zeros((0, g.ninputs)),
                          np.zeros((g.noutputs, 0)), d)
        return zero, StateSpace(t, z.T @ b, c @ z, np.zeros_like(d))
    a11, a12, a22 = t[:ns, :ns], t[:ns, ns:], t[ns:, ns:]
    # decouple: find X with A11 X - X A22 + A12 = 0
    x = sla.solve_sylvester(a11, -a22, -a12)
    bt = z.T @ b
    ct = c @ z
    b1 = bt[:ns, :] - x @ bt[ns:, :]
    b2 = bt[ns:, :]
    c1 = ct[:, :ns]
    c2 = ct[:, ns:] + c1 @ x
    g_s = StateSpace(a11, b1, c1, d)
    g_u = StateSpace(a22, b2, c2, np.zeros_like(d))
    return g_s, g_u


def sys_hsv(sys: StateSpace) -> np.ndarray:
    """Hankel singular values; unstable modes reported as inf
    (ref: lticontrol.py:559-573 — slycot ab09md semantics)."""
    g_s, g_u = stab_unstab_decomp(sys)
    hsv = []
    if g_s.nstates > 0:
        wc = gram(g_s, "c")
        wo = gram(g_s, "o")
        ev = np.linalg.eigvals(wc @ wo)
        hsv += list(np.sqrt(np.maximum(ev.real, 0.0)))
    if g_u is not None:
        hsv += [np.inf] * g_u.nstates
    return np.flip(np.sort(np.asarray(hsv)))


def balred_rel(sys: StateSpace, hsv_threshold: float, method: str = "truncate"):
    """Balanced reduction by relative HSV threshold; unstable part preserved
    (ref: lticontrol.py:576-633). Returns (sys_r, hsv, nr)."""
    if method not in ("truncate", "matchdc"):
        raise ValueError("method must be 'truncate' or 'matchdc'")
    hsv = sys_hsv(sys)
    finite = hsv[np.isfinite(hsv)]
    hmax = finite.max() if len(finite) else 1.0
    keep = hsv / hmax >= hsv_threshold
    nr = int(keep.sum())
    g_s, g_u = stab_unstab_decomp(sys)
    n_u = 0 if g_u is None else g_u.nstates
    ns_keep = nr - n_u  # unstable states always kept (hsv = inf)
    if g_s.nstates == 0:
        red = g_s
    else:
        bal = balreal(g_s)
        a, b, c, d = ssdata(bal)
        k = ns_keep
        if method == "truncate" or k == g_s.nstates:
            red = StateSpace(a[:k, :k], b[:k, :], c[:, :k], d)
        else:
            # singular perturbation (matched DC gain)
            a11, a12 = a[:k, :k], a[:k, k:]
            a21, a22 = a[k:, :k], a[k:, k:]
            b1, b2 = b[:k, :], b[k:, :]
            c1, c2 = c[:, :k], c[:, k:]
            a22i = np.linalg.inv(a22)
            red = StateSpace(
                a11 - a12 @ a22i @ a21,
                b1 - a12 @ a22i @ b2,
                c1 - c2 @ a22i @ a21,
                d - c2 @ a22i @ b2,
            )
    if g_u is not None:
        red = red + g_u
    return red, hsv, nr


def reduceorder(g: StateSpace) -> StateSpace:
    """Order reduction by balanced truncation of negligible HSVs
    (ref: lticontrol.py:553-556)."""
    return balred_rel(g, 1e-9)[0]


minreal = reduceorder


# ── Controller parametrization via residues (ref: lticontrol.py:639-700) ─────


def controller_residues(real_c=None, real_p=None, cplx_c=None, cplx_p=None):
    """K(s) = Σ real_c/(s-real_p) + Σ 2·Re[cplx_c/(s-cplx_p)] in SS form."""
    real_c = [] if real_c is None else real_c
    real_p = [] if real_p is None else real_p
    cplx_c = [] if cplx_c is None else cplx_c
    cplx_p = [] if cplx_p is None else cplx_p
    k = StateSpace(np.zeros((0, 0)), np.zeros((0, 1)), np.zeros((1, 0)), 0.0)
    for c, p in zip(real_c, real_p):
        k = k + StateSpace([[p]], [[c]], [[1.0]], 0.0)
    re, im = np.real, np.imag
    for c, p in zip(cplx_c, cplx_p):
        # conjugate pair c/(s-p) + c̄/(s-p̄) in companion form
        k = k + StateSpace(
            np.array([[2 * re(p), -(np.abs(p) ** 2)], [1.0, 0.0]]),
            np.array([[2 * (re(p) * re(c) - im(p) * im(c))], [2 * re(c)]]),
            np.array([[0.0, 1.0]]),
            0.0,
        )
    return k


def controller_residues_getidx(n_real: int, n_cplx: int):
    """Index slices into the flat theta vector (ref: lticontrol.py:672-683)."""
    idx = np.arange(0, 2 * n_real + 4 * n_cplx)
    return (
        idx[0:n_real],
        idx[n_real: 2 * n_real],
        idx[2 * n_real: 2 * n_real + n_cplx],
        idx[2 * n_real + n_cplx: 2 * n_real + 2 * n_cplx],
        idx[2 * n_real + 2 * n_cplx: 2 * n_real + 3 * n_cplx],
        idx[2 * n_real + 3 * n_cplx:],
    )


def controller_residues_wrapper(theta, n_real: int, n_cplx: int):
    """Build K from flat theta = [real_c, real_p, cc_re, cc_im, cp_re, cp_im]."""
    theta = np.asarray(theta, float)
    expected = 2 * n_real + 4 * n_cplx
    if len(theta) != expected:
        raise ValueError(f"theta length {len(theta)} != {expected}")
    rc, rp, ccr, cci, cpr, cpi = controller_residues_getidx(n_real, n_cplx)
    return controller_residues(
        theta[rc], theta[rp],
        theta[ccr] + 1j * theta[cci], theta[cpr] + 1j * theta[cpi],
    )


# ── Slow-fast decomposition (ref: lticontrol.py:706-736) ─────────────────────


def ss2tf(g: StateSpace):
    """SISO transfer function (num, den) of G."""
    num, den = scipy.signal.ss2tf(g.A, g.B, g.C, g.D)
    return np.atleast_1d(num[0]), np.atleast_1d(den)


def slowfast(g: StateSpace, wlim: float):
    """G = Gslow + Gfast split at |pole| = wlim. SISO only
    (ref: lticontrol.py:706-731)."""
    if g.ninputs != 1 or g.noutputs != 1:
        raise ValueError("slowfast: SISO systems only")
    num, den = ss2tf(g)
    r, p, k = scipy.signal.residue(num, den)
    k = 0.0 if np.size(k) == 0 else float(np.sum(k))
    wn = np.abs(p)
    idx_slow = np.where(wn < wlim)[0]
    idx_fast = np.where(wn >= wlim)[0]

    def from_residues(idx, feedthrough):
        num_acc, den_acc = np.array([0.0]), np.array([1.0])
        for ii in idx:
            den_i = np.array([1.0, -p[ii]])
            num_acc = np.polyadd(np.polymul(num_acc, den_i), r[ii] * den_acc)
            den_acc = np.polymul(den_acc, den_i)
        num_acc = np.polyadd(num_acc, feedthrough * den_acc)
        a, b, c, d = scipy.signal.tf2ss(np.real(num_acc), np.real(den_acc))
        return StateSpace(a, b, c, d)

    return from_residues(idx_slow, 0.0), from_residues(idx_fast, k)


def make_tf_real(num, den):
    """(ref: lticontrol.py:734-736)"""
    return np.real(num), np.real(den)


# ── Controller conditioning for bumpless switching ───────────────────────────


def condswitch(ur, yr, k: StateSpace, dt: float, w_y: float, w_u: float,
               w_decay: float):
    """Condition a controller's initial state on past I/O signals
    (Paxman-style weighted least squares, ref: lticontrol.py:742-810).

    Returns (xn, yhat, uhat)."""
    ad, bd, cd, dd = c2d(k, dt, "tustin")
    r = len(np.asarray(ur).reshape(-1))
    u_r = np.asarray(ur, float).reshape(-1)
    y_r = np.asarray(yr, float).reshape(-1)
    n = ad.shape[0]
    inv_a = np.linalg.inv(ad)
    gamma_r = np.zeros((r, n))
    gamma_r[0, :] = (cd @ inv_a).ravel()
    for ii in range(r - 1):
        gamma_r[ii + 1, :] = gamma_r[ii, :] @ inv_a
    tr0 = np.zeros((r, 1))
    for ii in range(r):
        tr0[ii] = (cd @ np.linalg.matrix_power(inv_a, ii + 1) @ bd).ravel()[0]
    tr0[0] += -np.asarray(dd).ravel()[0]
    tr = np.zeros((r, r))
    tr[:, 0] = tr0.ravel()
    for jj in range(1, r):
        tr[jj:, jj] = tr0[:-jj].ravel()
    w_dec = np.diag(w_decay ** np.flip(np.arange(0, r)))
    w = sla.block_diag(w_u * np.eye(r), w_y * np.eye(r))
    w = w @ sla.block_diag(w_dec, w_dec)
    a_sol = w @ np.block(
        [[-tr, gamma_r], [np.eye(r), np.zeros((r, n))]]
    )
    b_sol = w @ np.hstack((u_r, y_r))
    sol = np.linalg.lstsq(a_sol, b_sol, rcond=None)[0]
    xn = sol[-n:]
    yhat = sol[:r]
    uhat = gamma_r @ xn - tr @ yhat
    return xn, yhat, uhat


# ── Misc (ref: lticontrol.py:816-830) ────────────────────────────────────────


def compare_controllers(k1: StateSpace, k2: StateSpace) -> dict:
    """Compare two controllers by H∞-norm and DC-gain differences."""
    return {
        "hinfnorm_diff": norm(k1) - norm(k2),
        "dcgain_diff": np.asarray(k1.dcgain()) - np.asarray(k2.dcgain()),
    }


def export_controller(filename, k: StateSpace, w=None,
                      dt: float | None = None) -> None:
    """Export frequency response and matrices of K to .mat
    (ref: lticontrol.py:823-828). ``dt`` marks a DISCRETE-native design
    (dlqg_regulator): the scalar is stored alongside A..D and the
    frequency response is evaluated on the unit circle at z=e^{jw dt}."""
    import scipy.io as sio

    w = np.logspace(-2, 3, 200) if w is None else np.asarray(w)
    if dt is None:
        h = k.frequency_response(w)
    else:
        a, b, c, d = (np.asarray(m) for m in (k.A, k.B, k.C, k.D))
        n = a.shape[0]
        h = np.stack([
            c @ np.linalg.solve(np.exp(1j * wi * dt) * np.eye(n) - a, b) + d
            for wi in w
        ])
    mag = np.abs(h)
    phase = np.angle(h)
    out = dict(mag=mag, phase=phase, w=w, A=k.A, B=k.B, C=k.C, D=k.D)
    if dt is not None:
        out["dt"] = float(dt)
    sio.savemat(str(filename), out)
