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

Every state, control and output may carry leading batch dimensions: one
code path steps a single stream (n,) and a batch (B, n) of plant copies.

All device state (LU factors, CSR operators, lifting vectors, sensor rows,
the N(u) tables) lives in one plain dict of tensors, ``self._dev``, on
``self.device``. ``step`` runs eagerly. The counterparts of the JAX
package's compiled entry points (``compiled_step``,
``make_rollout_open_loop``, ``make_rollout_closed_loop``,
``closed_loop_fn``) run the steady-state step, and the rollouts' bodies, as
CUDA graphs (``core/graphs.py``) over a static carry; on the CPU the same
bodies run eagerly. The step counter is a host integer, so the BDF1→BDF2
ramp is a host branch over the two coefficient sets rather than the
reference's where-selected arrays — the same arithmetic — and the first
step of a run stays eager. A restart (``start_order=2``) builds the BDF2
system alone and takes BDF2 from its first step.

Not transcribed, because they exist for the TPU: the banded mass apply
(``ops/banded.py``; gathers are slow on a TPU, a CSR SpMV is not slow on a
GPU), the window-blocked N(u) (``ops/cellwindows.py``; K1 gathers
directly) and the hot dof order (permutes are costly on a TPU): the port
keeps mesh order everywhere. The direct solve is a dense LU while its f64
factorization fits the device (``trisolve="torch"``: pivoted, cuBLAS
triangular solves; ``trisolve="cuda"``: the blocked LU of
``solvers/block_lu.py`` solved by kernel K3), else the multifrontal solve
(``solvers/multifrontal.py``: on CUDA kernel F, the whole solve in one
launch, for up to 8 right-hand sides, and kernels K2 and P1 per stage for
wider batches; each wrapper counts its launches). The multifrontal
factor goes through the disk factor cache (``solvers/factor_cache.py``).
``backend='gmres'`` or ``'bicgstab'`` keeps no factor: each step is a
residual-controlled Krylov solve (``solvers/krylov.py``, in f64 whatever
the step's dtype) with the SIMPLE preconditioner, warm-started from the
previous state, cycles repeated on the host while a member's
``‖b − A x‖/‖b‖`` is above ``krylov_rtol``; its
compiled entry points run their bodies eagerly (a loop whose length the
host decides is not captured). ``StepOutput.res`` is that residual, always
measured on the Krylov backends, and -1.0 on the direct ones unless
``measure_residual``. The substructured solves are a later slice
(ROADMAP.md).
"""

from __future__ import annotations

import logging
import warnings
from dataclasses import dataclass, field
from typing import Any, NamedTuple

import numpy as np
import torch

from flowcontrol_tpu_torch.config import device_memory_budget_bytes, require_device
from flowcontrol_tpu_torch.core.graphs import Program
from flowcontrol_tpu_torch.fem.assembly import to_scipy_csr
from flowcontrol_tpu_torch.fem.bc import BCSet
from flowcontrol_tpu_torch.ops.nl import NLTables, nonlinear_convection
from flowcontrol_tpu_torch.ops.spmm import csr_residual, sparse_matvec
from flowcontrol_tpu_torch.parallel.dofsharding import mixed_dof_coordinates
from flowcontrol_tpu_torch.solvers.block_lu import BlockLU
from flowcontrol_tpu_torch.solvers.direct import DeviceDenseLU, HostSparseLU
from flowcontrol_tpu_torch.solvers.krylov import (
    CsrOperator,
    bicgstab,
    build_simple_preconditioner,
    gmres,
)
from flowcontrol_tpu_torch.solvers.multifrontal import MultifrontalLU

logger = logging.getLogger(__name__)


class StepCarry(NamedTuple):
    """State carried from step to step (mesh order). Every tensor may carry
    leading batch dimensions (B, ...); ``it`` is one count for all members.

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
    y: torch.Tensor  # sensor measurements (..., ns)
    dE: torch.Tensor  # perturbation kinetic energy (...)
    diverged: torch.Tensor  # bool (...), per batch member
    x: torch.Tensor | None  # full state (None in stacked rollout outputs)
    #: relative linear-solve residual ||b - A x|| / ||b|| of the step (...):
    #: always measured on the Krylov backends (it ends their cycle loop);
    #: -1.0 on the direct ones unless measure_residual=True (the JAX
    #: package's StepOutput.res)
    res: torch.Tensor | None = None


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
    """scipy CSR -> torch sparse CSR on ``device`` (cuSPARSE SpMV on CUDA),
    its stored zeros dropped (the element assembly stores every entry of
    the element tensors; an FMA with a stored 0 changes no sum's value).
    On CUDA, kernel S builds the matrix's tile plan on its first batched
    product (``ops/spmm.py`` ``plan_of``)."""
    a = a_csr.tocsr(copy=True)
    a.eliminate_zeros()
    device = torch.device(device)
    with warnings.catch_warnings():
        # torch flags sparse CSR as beta and notes its invariant checks;
        # the checks are on here (one-time, at build)
        warnings.filterwarnings("ignore", message="Sparse (CSR tensor support|invariant checks)")
        t = torch.sparse_csr_tensor(
            torch.as_tensor(a.indptr.astype(np.int64), device=device),
            torch.as_tensor(a.indices.astype(np.int64), device=device),
            torch.as_tensor(a.data, dtype=dtype, device=device),
            size=a.shape,
            check_invariants=True,
        )
    return t


def sparse_residual(a64: torch.Tensor, b: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """``(b.double() - a64 @ x.double()).to(b.dtype)`` over the last
    dimension: the composition for one vector, S's fused residual
    (``ops/spmm.py`` ``csr_residual``, the same bits in one launch) for a
    batch."""
    if x.dim() == 1:
        return (b.double() - torch.mv(a64, x.double())).to(b.dtype)
    n = x.shape[-1]
    r = csr_residual(a64, b.reshape(-1, a64.shape[0]), x.reshape(-1, n))
    return r.reshape(b.shape)


def dense_lu_max_dofs_device(device) -> int:
    """Largest dof count the dense LU takes on ``device``: the factor is
    computed in f64, so A and LU together (16 n^2 bytes) must fit the
    memory budget, which on a card counts what it has free. On an 80 GB
    card holding nothing else that is about 68.8k dofs, above the
    56,383-dof default cylinder mesh; past it the Stepper takes the
    multifrontal solve."""
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
    backend: str = "dense_lu"  # 'dense_lu' | 'host_lu' | 'gmres' | 'bicgstab'
    #: the first step's order: 1 (BDF1, then BDF2), or 2 (a restart from a
    #: checkpoint pair: BDF2 from the first step, its system alone built;
    #: ref: restart_order=2, flowsolver.py:795-796); 'cn' under scheme='cn'
    start_order: Any = 1
    dtype: torch.dtype = torch.float64
    device: Any = "cuda"  # the CPU only when asked for
    #: take the multifrontal solve even where the dense LU fits (the dense
    #: LU's kinds become 'multifrontal'; the borrowed first step stays)
    force_substructure: bool = False
    #: the dense solve above LAPACK_LU_MAX_N dofs: 'torch' (the pivoted
    #: torch.linalg LU, cuBLAS triangular solves) or 'cuda' (the blocked LU
    #: of solvers/block_lu.py, solved by the fused substitution kernel K3)
    trisolve: str = "torch"
    block_lu_bs: int = 1024
    #: the Krylov backends: one cycle is gmres(restart=maxiter=gmres_iters)
    #: (up to gmres_iters restarts of gmres_iters Arnoldi steps) or
    #: bicgstab(maxiter=gmres_iters); cycles repeat while any member's
    #: relative residual is above krylov_rtol, krylov_max_cycles at most
    gmres_iters: int = 30
    gmres_restarts: int = 2  # unused: the JAX package's legacy fixed budget
    krylov_rtol: float = 1e-8
    krylov_max_cycles: int = 8
    #: measure ||b - A x|| / ||b|| on the direct paths too (one more sparse
    #: product a step) and report it in StepOutput.res
    measure_residual: bool = False
    #: the multifrontal factor's knobs (None: the FC_MF_LEAF_MAX, FC_MF_TRIM
    #: and FC_MF_INBOX environment variables, then the defaults; see
    #: MultifrontalLU)
    mf_leaf_max: int | None = None
    mf_trim: bool | None = None
    mf_inbox: str | None = None
    #: the reference's size rule for its two dense kinds: 'lapack' (pivoted
    #: LU) up to this size, 'block' above. Under trisolve='cuda' 'block' is
    #: the BlockLU factor; under 'torch' it is the same pivoted LU as
    #: 'lapack', and the label only keeps the selection reading as the
    #: reference's.
    LAPACK_LU_MAX_N = 8192
    #: above this many dofs only the BDF2 matrix is factored and the single
    #: BDF1 first step is solved by Richardson iteration preconditioned with
    #: that factor (A2^{-1}A1 has spectrum in [2/3, 1]: each sweep contracts
    #: >= 3x, ~20 sweeps reach the f32 floor, paid once per run).
    DENSE_TWO_FACTOR_MAX_N = 30_000
    BORROW_ITERS = 20
    #: refinement sweeps (f64 residual) after each solve by an f32 factor
    REFINE_SWEEPS_F32 = 1
    _dev: dict = field(init=False, repr=False)

    def __post_init__(self):
        forms, space, bcs = self.forms, self.space, self.bcs
        n = space.n_dofs
        dt, dev_t = self.dtype, torch.device(self.device)
        self.device = dev_t
        if self.backend not in ("dense_lu", "host_lu", "gmres", "bicgstab"):
            raise ValueError(
                "backend must be 'dense_lu', 'host_lu', 'gmres' or 'bicgstab', got "
                f"{self.backend!r}"
            )
        if self.backend == "host_lu" and dev_t.type != "cpu":
            raise ValueError(
                f"host_lu is the CPU validation backend; on {dev_t} use dense_lu"
            )
        if self.start_order not in (1, 2, "cn"):
            raise ValueError(f"start_order must be 1, 2 or 'cn', got {self.start_order!r}")
        if self.trisolve not in ("torch", "cuda"):
            raise ValueError(f"trisolve must be 'torch' or 'cuda', got {self.trisolve!r}")
        if dev_t.type == "cuda" and forms.is_nonlinear and dt != torch.float32:
            raise TypeError(f"N(u) kernel K1 takes float32 only, got {dt} on {dev_t}")
        require_device(dev_t)
        dense = (
            self.backend == "dense_lu"
            and not self.force_substructure
            and n <= dense_lu_max_dofs_device(dev_t)
        )
        u0 = self.u0_nodes
        self.n_act = self.force_cols.shape[0]
        self.ns = self.c_rows.shape[0]

        # BDF1 on the first step then BDF2 (ref: flowsolver.py:740-743), BDF2
        # alone from a restart, or CN
        if self.scheme == "cn":
            orders = ("cn",)
        elif self.start_order == 2:
            orders = (2,)
        else:
            orders = (1, 2)
        self._order_idx = {o: i for i, o in enumerate(orders)}

        def tensor(a):
            return torch.as_tensor(np.ascontiguousarray(a), dtype=dt, device=dev_t)

        # (n_act, m) BC-profile values at constrained dofs; actuators without
        # a BC footprint (FORCE type) get zero rows
        profiles = np.zeros((self.n_act, len(bcs.dofs)))
        gp = bcs.g_profiles()
        if gp.shape[0]:
            profiles[: gp.shape[0], :] = gp[:, bcs.dofs]

        #: the Krylov backends' solve (the compiled entry points then run
        #: their bodies eagerly)
        self._krylov = self.backend in ("gmres", "bicgstab")
        d: dict = {"lift_act": [], "lift_static": [], "a_bc": {}, "a_refine": {}, "a_res": {}}
        self._solvers: list = []
        self._solver_kinds: list = []
        #: refinement sweeps per order index (REFINE_SWEEPS_F32 for an f32
        #: factor; none in f64)
        self._refine: dict = {}
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
                # no factor for BDF1: keep A1 (BC rows/cols eliminated), in
                # f64, for the Richardson matvec (its residual is taken in f64)
                d["a_bc"][oi] = csr_to_device(a_bc, dev_t, torch.float64)
                if self.measure_residual:
                    d["a_res"][oi] = d["a_bc"][oi]
                self._solvers.append(None)
                self._solver_kinds.append("borrowed")
                continue
            if dense:
                # computed in f64 and stored in dt
                if n > self.LAPACK_LU_MAX_N and self.trisolve == "cuda":
                    self._solvers.append(BlockLU(a_bc, bs=self.block_lu_bs, dtype=torch.float64,
                                                 store_dtype=dt, device=dev_t))
                else:
                    self._solvers.append(DeviceDenseLU(a_bc, dev_t, store_dtype=dt))
                self._solver_kinds.append("lapack" if n <= self.LAPACK_LU_MAX_N else "block")
            elif self.backend == "dense_lu":
                # past the dense range: host-f64 multifrontal factors stored
                # in dt
                mf = MultifrontalLU(a_bc, mixed_dof_coordinates(space), dev_t, dtype=dt,
                                    leaf_max=self.mf_leaf_max, trim=self.mf_trim,
                                    inbox=self.mf_inbox)
                self._solvers.append(mf)
                self._solver_kinds.append("multifrontal")
            elif self._krylov:
                # no factor: a_bc on the device and the SIMPLE
                # preconditioner (its Schur inverse dense), both in f64
                # whatever dt is: see _krylov_solve
                op = CsrOperator(csr_to_device(a_bc, dev_t, torch.float64))
                self._solvers.append((op, build_simple_preconditioner(
                    a_bc, bcs.free_mask, space.n_vel_dofs, op, dev_t, torch.float64)))
                self._solver_kinds.append(self.backend)
                logger.info("prepare order=%s: %s solve", order, self.backend)
                continue
            else:
                self._solvers.append(HostSparseLU(a_bc))
                self._solver_kinds.append("host")
            if dt == torch.float32 and self._solver_kinds[-1] != "host":
                # every f32 factor takes one refinement sweep, its residual
                # in f64 (A kept in f64 on the device): without it the f32
                # solves drift in the pressure and the reference's f32 pin
                # (field error below 1e-4 after a few steps,
                # tests/test_torch_cuda.py test_torch_cuda_f32_pin) fails on
                # the dense, block and multifrontal paths. The reference
                # refines its multifrontal factor only past a measured
                # per-solve error (core/stepper.py:428-458), which does not
                # predict that drift. An f32 residual cannot take the error
                # below cond(A)·eps_f32.
                self._refine[oi] = self.REFINE_SWEEPS_F32
                d["a_refine"][oi] = csr_to_device(a_bc, dev_t, torch.float64)
            if self.measure_residual and self._solver_kinds[-1] != "host":
                # the residual's operator: the refinement sweep's f64 A where
                # there is one (the f32 solve's residual then taken in f64),
                # else A in dt
                d["a_res"][oi] = d["a_refine"].get(oi)
                if d["a_res"][oi] is None:
                    d["a_res"][oi] = csr_to_device(a_bc, dev_t, dt)
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
        #: the compiled entry points' programs (core/graphs.py) by key, their
        #: static carries by batch shape, and on CUDA their side stream and
        #: graph memory pool
        self._programs: dict = {}
        self._statics: dict = {}
        self._graph_stream = self._graph_pool = None
        #: cycles the last Krylov solve ran, and all Krylov solves so far
        self.last_krylov_cycles = self.krylov_cycles = 0

    # ── Step math ────────────────────────────────────────────────────────────

    def _tensor(self, a) -> torch.Tensor:
        """``a`` (array-like or tensor) in the stepper's dtype on its device."""
        if not isinstance(a, torch.Tensor):
            a = np.asarray(a)
        return torch.as_tensor(a, dtype=self.dtype, device=self.device)

    def _mass(self, x: torch.Tensor) -> torch.Tensor:
        return sparse_matvec(self._dev["m"], x)

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
            rhs = rhs + c["c_lvel"] * sparse_matvec(d["lvel"], carry.u_n)
        g = d["bc_values"]
        if self.n_act:
            f_amp = c["c_f"] * u_ctrl + c["c_fn"] * carry.u_ctrl_prev
            rhs = rhs + f_amp @ d["f_cols"]
            rhs = rhs - u_ctrl @ d["lift_act"][oi]
            g = g + u_ctrl @ d["bc_profiles"]
        rhs = rhs - d["lift_static"][oi]
        rhs[..., d["bc_dofs"]] = g
        return rhs

    def _solve_once(self, oi: int, rhs: torch.Tensor) -> torch.Tensor:
        s = self._solvers[oi]
        if isinstance(s, HostSparseLU):  # CPU only (see __post_init__)
            return torch.as_tensor(s.solve(rhs.numpy()), dtype=rhs.dtype)
        return s.solve(rhs)

    def _residual(self, oi: int, rhs: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
        """Relative residual ||rhs - A x|| / ||rhs|| per batch member, A the
        order's ``a_res`` operator. An f64 A with an f32 step (the
        refinement sweep's, or the borrowed step's A1) gives the residual in
        f64, rounded to f32 (``sparse_residual``: S's fused residual for a
        batch); in f64 it is the JAX package's arithmetic."""
        a = self._dev["a_res"][oi]
        if a.dtype != x.dtype:
            r = sparse_residual(a, rhs, x)
        else:
            r = rhs - sparse_matvec(a, x)
        bn = torch.clamp(torch.linalg.vector_norm(rhs, dim=-1), min=1e-30)
        return torch.linalg.vector_norm(r, dim=-1) / bn

    def _krylov_solve(self, oi: int, rhs: torch.Tensor, x0: torch.Tensor):
        """Residual-controlled Krylov (the JAX package's ``_krylov_solve``):
        one cycle, then cycles while any member's measured relative residual
        is above ``krylov_rtol`` and fewer than ``krylov_max_cycles`` have
        run. Each cycle waits on the host once, for its residual. Returns
        (x, res) in the step's dtype; the cycles are counted in
        ``last_krylov_cycles`` and ``krylov_cycles``.

        The solve runs in f64 whatever the step's dtype (rhs and the start
        cast up, x and res cast back): in f32 the JAX package's GMRES loses
        the Arnoldi basis's orthogonality within ~10 steps (its one
        Gram-Schmidt pass) and solves its least squares through the normal
        equations (H's condition squared), so at the cylinder's widths its
        restarts diverge to inf; BiCGStab with tol 0 runs its recursive
        residual into underflow (ROADMAP.md, "Faults in the reference"). In
        f64 it is the JAX package's arithmetic."""
        op, pc = self._solvers[oi]
        b = rhs.to(torch.float64)
        bn = torch.clamp(torch.linalg.vector_norm(b, dim=-1), min=1e-30)

        def resnorm(x):
            return torch.linalg.vector_norm(b - op.apply(x), dim=-1) / bn

        def cycle(x):
            if self.backend == "gmres":
                x, _ = gmres(op.apply, b, x0=x, M=pc.apply, tol=0.0,
                             restart=self.gmres_iters, maxiter=self.gmres_iters)
            else:
                x, _ = bicgstab(op.apply, b, x0=x, M=pc.apply, tol=0.0,
                                maxiter=self.gmres_iters)
            return x

        x = cycle(x0.to(torch.float64))
        res, cycles = resnorm(x), 1
        while cycles < self.krylov_max_cycles and bool((res > self.krylov_rtol).any()):
            x = cycle(x)
            res, cycles = resnorm(x), cycles + 1
        self.last_krylov_cycles = cycles
        self.krylov_cycles += cycles
        return x.to(rhs.dtype), res.to(rhs.dtype)

    def _solve_step(self, order, rhs, x_guess):
        """The step's solve: (x, res), the solution and its relative
        residual (res -1.0 where it is not measured: the direct paths
        without ``measure_residual``, and the host LU). The Krylov backends
        start from ``x_guess``."""
        oi = self._order_idx[order]
        if self._krylov:
            return self._krylov_solve(oi, rhs, x_guess)
        x = self._solve(order, rhs)
        if oi in self._dev["a_res"]:
            return x, self._residual(oi, rhs, x)
        return x, torch.full(rhs.shape[:-1], -1.0, dtype=rhs.dtype, device=rhs.device)

    def _solve(self, order, rhs):
        """x = A⁻¹ rhs by the order's direct solve (its refinement sweeps
        included)."""
        oi = self._order_idx[order]
        if self._solver_kinds[oi] == "borrowed":
            # BDF1 first step in the single-factor regime: Richardson
            # iteration preconditioned by the BDF2 factor
            # (residual and iterate in f64, as in the refinement below)
            oi2 = self._order_idx[2]
            a1, b64 = self._dev["a_bc"][oi], rhs.double()
            x = self._solve_once(oi2, rhs).double()
            for _ in range(self.BORROW_ITERS):
                x = x + self._solve_once(oi2, (b64 - sparse_matvec(a1, x)).to(self.dtype)).double()
            return x.to(self.dtype)
        x = self._solve_once(oi, rhs)
        sweeps = self._refine.get(oi, 0)
        if sweeps:
            # mixed-precision refinement: residual and update in f64, the
            # correction solved with the f32 factor; the first sweep's
            # residual is taken from the f32 x and rhs (x64 is x.double()
            # there), fused for a batch
            a64 = self._dev["a_refine"][oi]
            x64 = x.double() + self._solve_once(oi, sparse_residual(a64, rhs, x)).double()
            for _ in range(sweeps - 1):
                r = (rhs.double() - sparse_matvec(a64, x64)).to(self.dtype)
                x64 = x64 + self._solve_once(oi, r).double()
            x = x64.to(self.dtype)
        return x

    def _order_of(self, it: int):
        if self.scheme == "cn":
            return "cn"
        return 1 if it == 0 and self.start_order != 2 else 2

    def _control(self, u_ctrl) -> torch.Tensor:
        u_ctrl = self._tensor(u_ctrl)
        if u_ctrl.shape[-1:] != (self.n_act,):
            raise ValueError(f"u_ctrl has shape {tuple(u_ctrl.shape)}, needs (..., {self.n_act})")
        return u_ctrl

    def _step_values(self, order, carry: StepCarry, u_ctrl: torch.Tensor):
        """The step's new values: (x, M x, N(u_n), y, dE, diverged, res)."""
        nl_n = self._nl(carry.u_n)
        rhs = self._rhs(order, carry, u_ctrl, nl_n)
        x, res = self._solve_step(order, rhs, carry.u_n)
        y = x @ self._dev["c"].T
        # the ONE mass apply of the step: feeds dE now and the next step's
        # RHS via the carry (see StepCarry)
        mx = self._mass(x)
        de = 0.5 * torch.einsum("...i,...i->...", x, mx)
        diverged = ~torch.isfinite(x).all(dim=-1)
        return x, mx, nl_n, y, de, diverged, res

    def step(self, carry: StepCarry, u_ctrl) -> tuple[StepCarry, StepOutput]:
        """One time step, run eagerly: (carry, u_ctrl (..., n_act)) ->
        (carry', StepOutput). :meth:`compiled_step` gives the same step as
        a CUDA graph."""
        u_ctrl = self._control(u_ctrl)
        x, mx, nl_n, y, de, diverged, res = self._step_values(self._order_of(carry.it), carry,
                                                              u_ctrl)
        new_carry = StepCarry(
            u_n=x, u_nn=carry.u_n, mu_n=mx, mu_nn=carry.mu_n, n_prev=nl_n,
            u_ctrl_prev=u_ctrl, it=carry.it + 1,
        )
        return new_carry, StepOutput(y=y, dE=de, diverged=diverged, x=x, res=res)

    def _advance(self, order, s: StepCarry, u_ctrl: torch.Tensor):
        """One step on the static carry ``s``, in place: the body of every
        captured program. Returns (y, dE, diverged, x, res)."""
        x, mx, nl_n, y, de, diverged, res = self._step_values(order, s, u_ctrl)
        s.u_nn.copy_(s.u_n)
        s.mu_nn.copy_(s.mu_n)
        s.u_n.copy_(x)
        s.mu_n.copy_(mx)
        s.n_prev.copy_(nl_n)
        s.u_ctrl_prev.copy_(u_ctrl)
        return y, de, diverged, x, res

    # ── Programs: the static carry and the captured bodies ──────────────────

    def _static_carry(self, carry: StepCarry) -> StepCarry:
        """The static carry for ``carry``'s batch shape (shared by that
        shape's programs), holding ``carry``'s values: copied in unless it
        already holds them (it does after a program returned ``carry``)."""
        batch = tuple(carry.u_n.shape[:-1])
        entry = self._statics.get(batch)
        if entry is None:
            def buf(k):
                return torch.empty(batch + (k,), dtype=self.dtype, device=self.device)

            n = self.space.n_dofs
            entry = self._statics[batch] = {
                "carry": StepCarry(*(buf(n) for _ in range(5)), buf(self.n_act), it=-1),
                "holds": None,
            }
        s = entry["carry"]
        if entry["holds"] is not carry:
            for k in _CARRY_TENSORS:
                getattr(s, k).copy_(getattr(carry, k))
        return s

    def _returned(self, s: StepCarry, it: int, **given) -> StepCarry:
        """The carry a program hands back: copies of the static carry's
        values (a later run overwrites it), except the fields ``given``,
        remembered as the one the static carry holds."""
        fields = {k: given[k] if k in given else getattr(s, k).clone() for k in _CARRY_TENSORS}
        carry = StepCarry(**fields, it=it)
        self._statics[tuple(s.u_n.shape[:-1])]["holds"] = carry
        return carry

    def _program(self, key, make_body) -> Program:
        """The program cached under ``key``, made from ``make_body()`` ->
        (body, its fixed tensors) on first use."""
        prog = self._programs.get(key)
        if prog is None:
            if self.device.type == "cuda" and not self._krylov and self._graph_stream is None:
                self._graph_stream = torch.cuda.Stream(self.device)
                self._graph_pool = torch.cuda.graph_pool_handle()
            body, fixed = make_body()
            prog = Program(body, self.device, self._graph_stream, self._graph_pool, fixed,
                           graphed=not self._krylov)
            self._programs[key] = prog
        return prog

    def graph_pool_bytes(self) -> int:
        """Bytes the captures of this Stepper's graphs added to their
        memory pool (0 on the CPU)."""
        return sum(p.pool_bytes for p in self._programs.values())

    # ── Public API ───────────────────────────────────────────────────────────

    def init_carry(self, up0: np.ndarray, up_prev: np.ndarray | None = None) -> StepCarry:
        """Carry from an initial mixed state (..., n) in mesh order (and an
        optional previous state for BDF2 restarts — ref:
        flowsolver.py:599-663)."""
        u0 = self._tensor(up0)
        um1 = u0 if up_prev is None else self._tensor(up_prev)
        mu0 = self._mass(u0)
        return StepCarry(
            u_n=u0,
            u_nn=um1,
            mu_n=mu0,
            mu_nn=mu0 if up_prev is None else self._mass(um1),
            n_prev=self._nl(um1),
            u_ctrl_prev=torch.zeros(u0.shape[:-1] + (self.n_act,), dtype=self.dtype,
                                    device=self.device),
            it=0,
        )

    def compiled_step(self):
        """The counterpart of the JAX package's jitted step: a callable
        ``(carry, u_ctrl) -> (carry', StepOutput)`` with the contract of
        :meth:`step`. On CUDA the steady-state order (BDF2, or CN) runs as
        a CUDA graph, captured once per batch shape and control shape over
        a static carry; the first step (``carry.it == 0``: BDF1 with its
        own factor, the borrowed BDF1 step, or a restart's BDF2 step) runs
        eagerly, once per run. On the Krylov backends, and on the CPU, it is
        :meth:`step`.
        A call copies the carry in (skipped when it is the carry the
        previous call returned, which the static carry still holds: the
        caller treats returned carries as values and does not write into
        them) and ``u_ctrl``, replays, and returns copies: a carry or
        output the caller holds keeps its values."""
        if self.device.type != "cuda" or self._krylov:
            return self.step
        return self._graphed_step

    def _graphed_step(self, carry: StepCarry, u_ctrl) -> tuple[StepCarry, StepOutput]:
        u_ctrl = self._control(u_ctrl)
        if carry.it == 0:
            return self.step(carry, u_ctrl)
        order = self._order_of(carry.it)
        s = self._static_carry(carry)

        def make():
            u = torch.empty_like(u_ctrl)
            return (lambda: self._advance(order, s, u)), {"u": u}

        prog = self._program(("step", order, tuple(s.u_n.shape), tuple(u_ctrl.shape)), make)
        prog.fixed["u"].copy_(u_ctrl)
        y, de, diverged, _, res = prog.run()
        new = self._returned(s, carry.it + 1, u_nn=carry.u_n, mu_nn=carry.mu_n,
                             u_ctrl_prev=u_ctrl)
        return new, StepOutput(y=y.clone(), dE=de.clone(), diverged=diverged.clone(), x=new.u_n,
                               res=res.clone())

    def _roll(self, carry: StepCarry, kind, num_steps: int, inputs: dict, outputs: dict,
              make_step):
        """A rollout of ``num_steps`` steps of one program over the static
        carry: the carry is copied in once and out once, each run writes
        its step's outputs into slot ``t`` of the (num_steps, ...) tensors
        named in ``outputs`` ({name: (shape, dtype)}; ``t`` lives on the
        device and the body advances it). ``make_step(order, s, fixed)``
        gives the step's body at ``order`` over the static carry ``s`` and
        the program's fixed tensors (the inputs, the outputs and ``t``, by
        name). ``kind`` and the shapes key the program. The first step of a
        run (``it == 0``) runs that body eagerly at its own order; the
        steady order runs as the program. Returns (carry', copies of the
        outputs)."""
        s = self._static_carry(carry)
        shapes = tuple(tuple(v.shape) for v in inputs.values()) + tuple(outputs.values())
        order = self._order_of(max(carry.it, 1))

        def make():
            fixed = {k: torch.empty_like(v) for k, v in inputs.items()}
            fixed.update({k: torch.empty(shape, dtype=dt, device=self.device)
                          for k, (shape, dt) in outputs.items()})
            fixed["t"] = torch.zeros(1, dtype=torch.int64, device=self.device)
            return make_step(order, s, fixed), fixed

        prog = self._program((kind, order, tuple(s.u_n.shape), shapes), make)
        for k, v in inputs.items():
            prog.fixed[k].copy_(v)
        prog.fixed["t"].zero_()
        first = min(num_steps, int(carry.it == 0))
        if first:
            make_step(self._order_of(0), s, prog.fixed)()
        for _ in range(first, num_steps):
            prog.run()
        new = self._returned(s, carry.it + num_steps) if num_steps else carry
        return new, {k: prog.fixed[k].clone() for k in outputs}

    def make_rollout_open_loop(self, with_state: bool = False):
        """The counterpart of the JAX package's jitted scan of the step: a
        callable ``(carry, u_seq (T, ..., n_act)) -> (carry', StepOutput)``
        with y, dE, diverged and res stacked over T, and x stacked too with
        ``with_state`` (T·B·n values beside the resident factor), else
        None: the final state is in the carry. On CUDA every step after
        the first of a run (``it == 0``, eager) replays one CUDA graph,
        captured once per batch shape and T; on the CPU the same body runs
        eagerly."""

        def roll(carry: StepCarry, u_seq):
            return self._rollout_open(carry, self._tensor(u_seq), with_state)

        return roll

    def _rollout_open(self, carry: StepCarry, u_seq: torch.Tensor, with_state: bool):
        steps, batch = u_seq.shape[0], tuple(carry.u_n.shape[:-1])
        lead = (steps,) + batch
        outputs = {"y": (lead + (self.ns,), self.dtype), "dE": (lead, self.dtype),
                   "diverged": (lead, torch.bool), "res": (lead, self.dtype)}
        if with_state:
            outputs["x"] = (lead + (self.space.n_dofs,), self.dtype)

        def make_step(order, s, f):
            def body():
                t = f["t"]
                y, de, diverged, x, res = self._advance(order, s, f["u"].index_select(0, t)[0])
                for k, v in (("y", y), ("dE", de), ("diverged", diverged), ("x", x),
                             ("res", res)):
                    if k in f:
                        f[k].index_copy_(0, t, v.unsqueeze(0))
                t.add_(1)
            return body

        carry, outs = self._roll(carry, "open", steps, {"u": u_seq}, outputs, make_step)
        return carry, StepOutput(y=outs["y"], dE=outs["dE"], diverged=outs["diverged"],
                                 x=outs.get("x"), res=outs["res"])

    def rollout_open_loop(self, carry: StepCarry, u_seq, with_state: bool = False):
        """Step through a prescribed control sequence (T, ..., n_act):
        :meth:`make_rollout_open_loop` ``(with_state)`` applied."""
        return self.make_rollout_open_loop(with_state)(carry, u_seq)

    def rollout_closed_loop(self, carry: StepCarry, k_mats, y0, num_steps: int,
                            feedback_sign: float = -1.0):
        """Fused plant + controller rollout, all on the device:
        :meth:`make_rollout_closed_loop` applied.

        ``k_mats`` = (Ad, Bd, Cd, Dd), the discrete controller matrices
        (``Controller.discrete``), or (B, ...) stacks of them with a batched
        carry (``stack_controllers``). Each step: u = Cd xk + Dd (sign·y);
        xk' = Ad xk + Bd (sign·y); then the plant step with u, matching the
        reference's lockstep loop (ref: run_cylinder_example.py:83-86).
        Returns (carry, (y, dE, u, diverged)) stacked over the steps.
        """
        return self.make_rollout_closed_loop(num_steps, feedback_sign)(carry, k_mats, y0)

    def make_rollout_closed_loop(self, num_steps: int, feedback_sign: float = -1.0):
        """The counterpart of the JAX package's jitted fused closed loop:
        :meth:`closed_loop_fn` (the port has no lowering step apart from
        the capture, which the rollout makes on first use)."""
        return self.closed_loop_fn(num_steps, feedback_sign)

    def closed_loop_fn(self, num_steps: int, feedback_sign: float = -1.0):
        """The fused closed-loop rollout ``(carry, k_mats, y0) -> (carry',
        (y, dE, u, diverged))``, batch-polymorphic as
        :meth:`rollout_closed_loop` is. The controller update (its four
        products) and the plant step make one body; on CUDA every step
        after the first of a run replays it as one CUDA graph, captured
        once per batch shape, controller shape and ``num_steps``; on the
        CPU it runs eagerly. (The JAX package's function of this name is
        the unjitted scan, taking its device tables as an argument.)"""

        def roll(carry: StepCarry, k_mats, y0):
            ad, bd, cd, dd = (self._tensor(m) for m in k_mats)
            y0 = self._tensor(y0)
            lead = (num_steps,) + tuple(y0.shape[:-1])
            # xk and yk, the controller's state and the last y, start from
            # zero and y0 and are carried from step to step in place
            inputs = {"ad": ad, "bd": bd, "cd": cd, "dd": dd, "yk": y0,
                      "xk": torch.zeros(ad.shape[:-1], dtype=self.dtype, device=self.device)}
            outputs = {"y": (lead + (self.ns,), self.dtype), "dE": (lead, self.dtype),
                       "u": (lead + (self.n_act,), self.dtype), "diverged": (lead, torch.bool)}

            def make_step(order, s, f):
                def mv(a, v):
                    return torch.einsum("...ij,...j->...i", a, v)

                def body():
                    t = f["t"]
                    fb = feedback_sign * f["yk"]
                    u = mv(f["cd"], f["xk"]) + mv(f["dd"], fb)
                    xk = mv(f["ad"], f["xk"]) + mv(f["bd"], fb)
                    y, de, diverged, _, _ = self._advance(order, s, u)
                    for k, v in (("y", y), ("dE", de), ("u", u), ("diverged", diverged)):
                        f[k].index_copy_(0, t, v.unsqueeze(0))
                    f["yk"].copy_(y)
                    f["xk"].copy_(xk)
                    t.add_(1)
                return body

            # the sign is a constant of the captured body: part of the key
            carry, outs = self._roll(carry, ("closed", feedback_sign), num_steps, inputs,
                                     outputs, make_step)
            return carry, (outs["y"], outs["dE"], outs["u"], outs["diverged"])

        return roll
