"""Time-stepping engine: the device hot loop.

The counterpart of ``flowcontrol_tpu/core/stepper.py`` (its dense slice).
Replaces the reference's per-step assemble + MUMPS back-substitution
(ref: src/flowcontrol/flowsolver.py:703-799) with one step of torch ops on
one explicit device:

    rhs = c_mn·M u_n + c_mnn·M u_nn  (carried mass applies)
        + c_nl_n·N(u_n) + c_nl_nn·N(u_nn)   (N(u): kernel K1 on CUDA)
        + actuation (force columns, BC lifting) and the Dirichlet values
    x   = direct solve with factors resident on the device
    y   = C x,  dE = ½ xᵀ M x  (the step's one mass apply, a CSR SpMV),
          divergence flag

All device state (LU factors, CSR operators, lifting vectors, sensor rows,
the N(u) tables) lives in one plain dict of tensors, ``self._dev``, on
``self.device``. A Python loop takes the place of ``lax.scan``; the step
counter is a host integer, so the BDF1→BDF2 ramp is a host branch over the
two coefficient sets rather than the reference's where-selected arrays —
the same arithmetic.

Not transcribed, because they exist for the TPU: the banded mass apply
(``ops/banded.py``; gathers are slow on a TPU, a CSR SpMV is not slow on a
GPU), the window-blocked N(u) (``ops/cellwindows.py``; K1 gathers
directly) and the hot dof order (permutes are costly on a TPU): the port
keeps mesh order everywhere. The multifrontal, substructured and Krylov
solves and batched/closed-loop rollouts are later slices (ROADMAP.md).
"""

from __future__ import annotations

import logging
import warnings
from dataclasses import dataclass, field
from typing import Any, NamedTuple

import numpy as np
import torch

from flowcontrol_tpu_torch.config import device_memory_budget_bytes
from flowcontrol_tpu_torch.fem.assembly import to_scipy_csr
from flowcontrol_tpu_torch.fem.bc import BCSet
from flowcontrol_tpu_torch.ops.nl import NLTables, nonlinear_convection
from flowcontrol_tpu_torch.solvers.direct import DeviceDenseLU, HostSparseLU

logger = logging.getLogger(__name__)


class StepCarry(NamedTuple):
    """State carried from step to step (mesh order).

    mu_n/mu_nn carry M@u forward: the step needs M@x anyway (dE = ½xᵀMx)
    and M is constant, so caching it makes the step's three mass applies
    (M u_n and M u_nn in the RHS, M x for dE) ONE."""

    u_n: torch.Tensor  # mixed state at step k (n,)
    u_nn: torch.Tensor  # mixed state at step k-1 (n,)
    mu_n: torch.Tensor  # M @ u_n (cached mass apply)
    mu_nn: torch.Tensor  # M @ u_nn
    n_prev: torch.Tensor  # N(u_nn) cached from the previous step (n,)
    u_ctrl_prev: torch.Tensor  # previous control (CN body-force averaging)
    it: int  # steps taken from this carry's start


class StepOutput(NamedTuple):
    y: torch.Tensor  # sensor measurements (ns,)
    dE: torch.Tensor  # perturbation kinetic energy
    diverged: torch.Tensor  # bool
    x: torch.Tensor | None  # full state (None in stacked rollout outputs)


_CARRY_TENSORS = ("u_n", "u_nn", "mu_n", "mu_nn", "n_prev", "u_ctrl_prev")


def carry_from_numpy(d: dict, device, dtype) -> StepCarry:
    """Port carry from a dict of numpy arrays in mesh order — e.g. a JAX
    ``StepCarry`` with every field passed through ``np.asarray``."""
    fields = {
        k: torch.tensor(np.asarray(d[k]), dtype=dtype, device=device)
        for k in _CARRY_TENSORS
    }
    return StepCarry(**fields, it=int(np.asarray(d["it"])))


def carry_to_numpy(carry: StepCarry) -> dict:
    """Inverse of :func:`carry_from_numpy` (``it`` as an int32 array)."""
    d = {k: getattr(carry, k).detach().cpu().numpy() for k in _CARRY_TENSORS}
    d["it"] = np.asarray(carry.it, dtype=np.int32)
    return d


def csr_to_device(a_csr, device, dtype) -> torch.Tensor:
    """scipy CSR -> torch sparse CSR on ``device`` (cuSPARSE SpMV on CUDA)."""
    a = a_csr.tocsr()
    with warnings.catch_warnings():
        # torch flags sparse CSR as beta and notes its invariant checks;
        # the checks are on here (one-time, at build)
        warnings.filterwarnings("ignore", message="Sparse (CSR tensor support|invariant checks)")
        return torch.sparse_csr_tensor(
            torch.as_tensor(a.indptr.astype(np.int64), device=device),
            torch.as_tensor(a.indices.astype(np.int64), device=device),
            torch.as_tensor(a.data, dtype=dtype, device=device),
            size=a.shape,
            check_invariants=True,
        )


def dense_lu_max_dofs_device(device) -> int:
    """Largest dof count the dense LU takes on ``device``: the factor is
    computed in f64, so A and LU together (16 n^2 bytes) must fit the
    memory budget. On an 80 GB card that is about 69k dofs, above the
    56,383-dof default cylinder mesh; the multifrontal solve for larger
    meshes is not ported yet."""
    return int((device_memory_budget_bytes(device) / 16) ** 0.5)


@dataclass
class Stepper:
    """Device-resident stepping engine for one linearized-around-U0 problem."""

    space: Any
    forms: Any  # NSForms
    bcs: BCSet  # perturbation-field BCs (+ optional pressure pin)
    u0_nodes: np.ndarray  # base-flow velocity (n_vnodes, 2)
    c_rows: np.ndarray  # (ns, n) sensor matrix
    force_cols: np.ndarray  # (n_act, n) body-force load vectors
    scheme: str = "bdf"  # 'bdf' or 'cn'
    backend: str = "dense_lu"  # 'dense_lu' | 'host_lu'
    dtype: torch.dtype = torch.float64
    device: Any = "cpu"
    #: the reference's size rule for its two dense kinds: 'lapack' up to
    #: this size, 'block' above. On the port both are the same torch.linalg
    #: LU; the label is kept so the selection reads as the reference's.
    LAPACK_LU_MAX_N = 8192
    #: above this many dofs only the BDF2 matrix is factored and the single
    #: BDF1 first step is solved by Richardson iteration preconditioned with
    #: that factor (A2^{-1}A1 has spectrum in [2/3, 1]: each sweep contracts
    #: >= 3x, ~20 sweeps reach the f32 floor, paid once per run).
    DENSE_TWO_FACTOR_MAX_N = 30_000
    BORROW_ITERS = 20
    _dev: dict = field(init=False, repr=False)

    def __post_init__(self):
        forms, space, bcs = self.forms, self.space, self.bcs
        n = space.n_dofs
        dt, dev_t = self.dtype, torch.device(self.device)
        self.device = dev_t
        if self.backend not in ("dense_lu", "host_lu"):
            raise ValueError(
                f"backend must be 'dense_lu' or 'host_lu', got {self.backend!r}"
            )
        if self.backend == "host_lu" and dev_t.type != "cpu":
            raise ValueError(
                f"host_lu is the CPU validation backend; on {dev_t} use dense_lu"
            )
        if dev_t.type == "cuda" and forms.is_nonlinear and dt != torch.float32:
            raise TypeError(f"N(u) kernel K1 takes float32 only, got {dt} on {dev_t}")
        if self.backend == "dense_lu" and n > dense_lu_max_dofs_device(dev_t):
            raise MemoryError(
                f"the f64 dense factorization of {n} dofs needs "
                f"{16 * n * n / 1e9:.1f} GB, over the memory budget of {dev_t}; "
                "the multifrontal solve for this size is not ported yet"
            )
        u0 = self.u0_nodes
        self.n_act = self.force_cols.shape[0]
        self.ns = self.c_rows.shape[0]

        # BDF1 on the first step then BDF2 (ref: flowsolver.py:740-743), or CN
        orders = ("cn",) if self.scheme == "cn" else (1, 2)
        self._order_idx = {o: i for i, o in enumerate(orders)}

        def tensor(a):
            return torch.as_tensor(np.ascontiguousarray(a), dtype=dt, device=dev_t)

        # (n_act, m) BC-profile values at constrained dofs; actuators without
        # a BC footprint (FORCE type) get zero rows
        profiles = np.zeros((self.n_act, len(bcs.dofs)))
        gp = bcs.g_profiles()
        if gp.shape[0]:
            profiles[: gp.shape[0], :] = gp[:, bcs.dofs]

        d: dict = {"lift_act": [], "lift_static": [], "a_bc": {}}
        self._solvers: list = []
        self._solver_kinds: list = []
        self._borrow_first = (
            self.backend == "dense_lu"
            and orders == (1, 2)
            and n > self.DENSE_TWO_FACTOR_MAX_N
        )
        for order in orders:
            oi = self._order_idx[order]
            lhs_e = forms.transient_lhs(order, u0)
            a_bc, lift_cols = bcs.eliminate_csr(to_scipy_csr(lhs_e, space.cell_dofs, n))
            del lhs_e
            la = (lift_cols @ profiles.T).T if self.n_act else np.zeros((0, n))
            d["lift_act"].append(tensor(la))
            d["lift_static"].append(tensor(lift_cols @ bcs.values))
            del lift_cols
            if self._borrow_first and order == 1:
                # no factor for BDF1: keep A1 (BC rows/cols eliminated) for
                # the Richardson matvec
                d["a_bc"][oi] = csr_to_device(a_bc, dev_t, dt)
                self._solvers.append(None)
                self._solver_kinds.append("borrowed")
                continue
            if self.backend == "dense_lu":
                # computed in f64 and stored in dt: rounding-limited, so no
                # refinement sweep (reference: field err 2.2e-4 with 0 sweeps
                # vs 1.8e-4 with 1, core/stepper.py:535-538)
                self._solvers.append(DeviceDenseLU(a_bc, dev_t, store_dtype=dt))
                self._solver_kinds.append("lapack" if n <= self.LAPACK_LU_MAX_N else "block")
            else:
                self._solvers.append(HostSparseLU(a_bc))
                self._solver_kinds.append("host")
            logger.info("prepare order=%s: %s solve", order, self._solver_kinds[-1])

        d["m"] = csr_to_device(
            to_scipy_csr(forms.mass_elements(), space.cell_dofs, n), dev_t, dt
        )
        d["lvel"] = None
        if self.scheme == "cn":
            d["lvel"] = csr_to_device(
                to_scipy_csr(
                    forms.velocity_operator_elements(u0, include_shift=False),
                    space.cell_dofs, n,
                ),
                dev_t, dt,
            )
        d["nl"] = NLTables.build(forms.geom, space, dev_t, dt) if forms.is_nonlinear else None
        d["c"] = tensor(self.c_rows)
        d["f_cols"] = tensor(self.force_cols)
        d["bc_dofs"] = torch.as_tensor(np.asarray(bcs.dofs, dtype=np.int64), device=dev_t)
        d["bc_values"] = tensor(bcs.values)
        d["bc_profiles"] = tensor(profiles)
        self._dev = d
        self._coeffs = {o: forms.rhs_coefficients(o) for o in orders}

    # ── Step math ────────────────────────────────────────────────────────────

    def _mass(self, x: torch.Tensor) -> torch.Tensor:
        return torch.mv(self._dev["m"], x)

    def _nl(self, x: torch.Tensor) -> torch.Tensor:
        if self._dev["nl"] is None:
            return torch.zeros_like(x)
        return nonlinear_convection(self._dev["nl"], x)

    def _rhs(self, order, carry: StepCarry, u_ctrl, nl_n):
        d = self._dev
        c = self._coeffs[order]
        oi = self._order_idx[order]
        rhs = c["c_mn"] * carry.mu_n
        if c["c_mnn"]:
            rhs = rhs + c["c_mnn"] * carry.mu_nn
        if c["c_nl_n"]:
            rhs = rhs + c["c_nl_n"] * nl_n
        if c["c_nl_nn"]:
            rhs = rhs + c["c_nl_nn"] * carry.n_prev
        if c["c_lvel"]:
            rhs = rhs + c["c_lvel"] * torch.mv(d["lvel"], carry.u_n)
        g = d["bc_values"]
        if self.n_act:
            f_amp = c["c_f"] * u_ctrl + c["c_fn"] * carry.u_ctrl_prev
            rhs = rhs + f_amp @ d["f_cols"]
            rhs = rhs - u_ctrl @ d["lift_act"][oi]
            g = g + u_ctrl @ d["bc_profiles"]
        rhs = rhs - d["lift_static"][oi]
        rhs[d["bc_dofs"]] = g
        return rhs

    def _solve_once(self, oi: int, rhs: torch.Tensor) -> torch.Tensor:
        s = self._solvers[oi]
        if isinstance(s, HostSparseLU):  # CPU only (see __post_init__)
            return torch.as_tensor(s.solve(rhs.numpy()), dtype=rhs.dtype)
        return s.solve(rhs)

    def _solve(self, order, rhs):
        oi = self._order_idx[order]
        if self._solver_kinds[oi] == "borrowed":
            # BDF1 first step in the single-factor regime: Richardson
            # iteration preconditioned by the BDF2 factor
            oi2 = self._order_idx[2]
            a1 = self._dev["a_bc"][oi]
            x = self._solve_once(oi2, rhs)
            for _ in range(self.BORROW_ITERS):
                x = x + self._solve_once(oi2, rhs - torch.mv(a1, x))
            return x
        return self._solve_once(oi, rhs)

    def _order_of(self, carry: StepCarry):
        if self.scheme == "cn":
            return "cn"
        return 1 if carry.it == 0 else 2

    def step(self, carry: StepCarry, u_ctrl) -> tuple[StepCarry, StepOutput]:
        """One time step: (carry, u_ctrl (n_act,)) -> (carry', StepOutput)."""
        u_ctrl = torch.as_tensor(u_ctrl, dtype=self.dtype, device=self.device).reshape(self.n_act)
        order = self._order_of(carry)
        nl_n = self._nl(carry.u_n)
        rhs = self._rhs(order, carry, u_ctrl, nl_n)
        x = self._solve(order, rhs)
        y = self._dev["c"] @ x
        # the ONE mass apply of the step: feeds dE now and the next step's
        # RHS via the carry (see StepCarry)
        mx = self._mass(x)
        de = 0.5 * torch.dot(x, mx)
        diverged = ~torch.isfinite(x).all()
        new_carry = StepCarry(
            u_n=x, u_nn=carry.u_n, mu_n=mx, mu_nn=carry.mu_n, n_prev=nl_n,
            u_ctrl_prev=u_ctrl, it=carry.it + 1,
        )
        return new_carry, StepOutput(y=y, dE=de, diverged=diverged, x=x)

    # ── Public API ───────────────────────────────────────────────────────────

    def init_carry(self, up0: np.ndarray, up_prev: np.ndarray | None = None) -> StepCarry:
        """Carry from an initial mixed state in mesh order (and an optional
        previous state for BDF2 restarts — ref: flowsolver.py:599-663)."""
        u0 = torch.as_tensor(np.asarray(up0), dtype=self.dtype, device=self.device)
        um1 = u0 if up_prev is None else torch.as_tensor(
            np.asarray(up_prev), dtype=self.dtype, device=self.device
        )
        mu0 = self._mass(u0)
        return StepCarry(
            u_n=u0,
            u_nn=um1,
            mu_n=mu0,
            mu_nn=mu0 if up_prev is None else self._mass(um1),
            n_prev=self._nl(um1),
            u_ctrl_prev=torch.zeros(self.n_act, dtype=self.dtype, device=self.device),
            it=0,
        )

    def rollout_open_loop(self, carry: StepCarry, u_seq):
        """Step through a prescribed control sequence (T, n_act), single
        stream. Returns (carry, StepOutput) with y, dE and diverged stacked
        over T; x is None (the final state is in the carry)."""
        u_seq = torch.as_tensor(np.asarray(u_seq), dtype=self.dtype, device=self.device)
        ys, des, divs = [], [], []
        for u in u_seq:
            carry, out = self.step(carry, u)
            ys.append(out.y)
            des.append(out.dE)
            divs.append(out.diverged)
        return carry, StepOutput(
            y=torch.stack(ys), dE=torch.stack(des), diverged=torch.stack(divs), x=None
        )
