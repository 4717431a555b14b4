"""Element-sharded operators and the sharded Stepper over process groups.

The counterpart of ``flowcontrol_tpu/parallel/sharding.py``, the
replacement of the reference's MPI domain decomposition (dolfin partitions
the mesh across ranks at read time, ref: flowsolver.py:236-238). The JAX
package shards over the axes of a ``jax.sharding.Mesh`` inside one
program; the port runs one process per rank and each axis is a process
group (``torch.distributed.new_group``) that every sharded object takes
explicitly (:class:`DeviceMesh`):

- ``space``: the cells are split over its ranks; every rank holds the dof
  vectors whole, applies its own cells and one ``all_reduce`` makes the
  sum (the analogue of dolfin's ghost-dof accumulation). The JAX package
  applies each shard's element tensors through a gather table; here a rank
  holds the CSR assembled from its cells (cuSPARSE's SpMV for a vector,
  kernel S for a batch: the zero-free matrices of the single-card path),
  and N(u) runs kernel K1 over the rank's cells.
- ``batch``: a rollout batch is split over its ranks (data-parallel
  controller search); the two compose.

The host set-up is replicated: every rank builds the whole problem, then
keeps its share. :func:`shard_stepper` re-routes a Stepper's mass and CN
applies, N(u), its multifrontal solves (``parallel/mf_sharded.py``) and
its Krylov operator through the sharded versions.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch
import torch.distributed as dist

from flowcontrol_tpu_torch.parallel import comm


@dataclass
class DeviceMesh:
    """This rank's process groups of a (batch, space) grid of the world's
    ranks (rank r at batch row r // n_space, space column r % n_space, the
    JAX dry run's ``devices.reshape(n_batch, n_space)``). ``batch`` is None
    for an all-space mesh."""

    space: object
    batch: object | None
    space_rank: int
    batch_rank: int


def make_device_mesh(n_batch: int = 1) -> DeviceMesh:
    """The process groups of a ``space`` axis and, with ``n_batch`` > 1, a
    ``batch`` axis, over the initialized world (the JAX package's
    ``make_device_mesh``, which makes a one-axis ``Mesh``). Every rank of
    the world calls it (``new_group`` is collective) and gets its own
    groups."""
    world, rank = dist.get_world_size(), dist.get_rank()
    if world % n_batch:
        raise ValueError(f"a world of {world} ranks has no {n_batch} batch rows")
    n_space = world // n_batch
    space = batch = None
    for b in range(n_batch):
        g = dist.new_group([b * n_space + s for s in range(n_space)])
        if rank // n_space == b:
            space = g
    if n_batch > 1:
        for s in range(n_space):
            g = dist.new_group([b * n_space + s for b in range(n_batch)])
            if rank % n_space == s:
                batch = g
    return DeviceMesh(space=space, batch=batch, space_rank=rank % n_space,
                      batch_rank=rank // n_space)


def rank_cells(n_cells: int, group) -> np.ndarray:
    """The cells of this rank's shard of the ``space`` group: the JAX
    package's split of the padded cell axis into equal chunks, one a rank,
    its padding left out."""
    n, me = comm.group_size(group), comm.group_rank(group)
    per = -(-n_cells // n)
    return np.arange(min(me * per, n_cells), min((me + 1) * per, n_cells))


def sharded_apply_builder(a_e, cell_dofs, n_dofs: int, group, device, dtype: torch.dtype):
    """y = A x with the element tensors split over the ``space`` group:
    this rank's CSR, assembled from its cells in ``dtype`` on ``device``,
    then one ``all_reduce``. Returns apply(x) over the last dimension of x
    (..., n)."""
    from flowcontrol_tpu_torch.core.stepper import csr_to_device
    from flowcontrol_tpu_torch.fem.assembly import to_scipy_csr
    from flowcontrol_tpu_torch.ops.spmm import sparse_matvec

    cells = rank_cells(np.asarray(cell_dofs).shape[0], group)
    a = csr_to_device(to_scipy_csr(np.asarray(a_e)[cells], np.asarray(cell_dofs)[cells], n_dofs),
                      device, dtype)

    def apply(x):
        return comm.all_reduce_sum(sparse_matvec(a, x), group)

    return apply


def sharded_nonlinear_builder(geom, space, group, device, dtype: torch.dtype):
    """Sharded N(u): kernel K1 (``ops/nl.py``; its plain version for CPU
    tensors) over the tables of this rank's cells, then one ``all_reduce``
    over the ``space`` group. Returns nl(u) over u (..., n_dofs). (The JAX
    package's ``split_layout`` reads its TPU hot dof order, which the port
    does not keep.)"""
    from flowcontrol_tpu_torch.ops.nl import NLTables, nonlinear_convection

    tables = NLTables.build(geom, space, device, dtype,
                            cells=rank_cells(space.cell_dofs.shape[0], group))

    def nl(u):
        return comm.all_reduce_sum(nonlinear_convection(tables, u), group)

    return nl


def shard_stepper(stepper, space_group, batch_group=None):
    """Re-route a Stepper's applies and solves through sharded versions.

    Installs the Stepper's hooks: the mass and CN applies and N(u) over
    ``space_group`` (:func:`sharded_apply_builder`,
    :func:`sharded_nonlinear_builder`). A multifrontal kind's solver object
    becomes a :class:`~flowcontrol_tpu_torch.parallel.mf_sharded.ShardedMultifrontal`
    and the replicated factor is dropped (its stacks leave the device once
    nothing else holds the ``MultifrontalLU``, as the JAX package's
    ``dev["solvers"][oi] = ()``); the refinement sweeps and the borrowed
    BDF1 step reach it through ``_solve_once``, their f64 operators
    (``a_refine``, ``a_res``, ``a_bc``) stay replicated, and so do the dense
    kinds. On the Krylov backends the operator, inside GMRES or BiCGStab and
    inside SIMPLE's Jacobi sweeps, is the BC-masked sharded apply of the
    order's element tensors (f64), and with ``batch_group`` (this rank's
    rows are its share of the batch) their inner products and the cycle test
    span the whole batch (the JAX package's semantics: the batch is one
    system). The groups are those of :func:`make_device_mesh` (``mesh.space``,
    ``mesh.batch``). The Stepper's compiled entry points
    then run their bodies eagerly: the collectives are host calls, which a
    CUDA graph does not capture. Returns the stepper."""
    from flowcontrol_tpu_torch.parallel.mf_sharded import ShardedMultifrontal
    from flowcontrol_tpu_torch.solvers.krylov import HookedOperator, SimplePreconditioner

    space, forms, dev_t, dt = stepper.space, stepper.forms, stepper.device, stepper.dtype
    n = space.n_dofs
    applies = {"m": sharded_apply_builder(forms.mass_elements(), space.cell_dofs, n,
                                          space_group, dev_t, dt)}
    if stepper._dev["lvel"] is not None:
        applies["lvel"] = sharded_apply_builder(
            forms.velocity_operator_elements(stepper.u0_nodes, include_shift=False),
            space.cell_dofs, n, space_group, dev_t, dt)
    stepper._apply_hook = lambda key, x: applies[key](x)
    stepper._nl_hook = (sharded_nonlinear_builder(forms.geom, space, space_group, dev_t, dt)
                        if forms.is_nonlinear else None)
    stepper._groups = (space_group, batch_group)
    stepper._sharded_solvers = {}
    for oi, kind in enumerate(stepper._solver_kinds):
        if kind == "multifrontal":
            smf = ShardedMultifrontal(stepper._solvers[oi], space_group)
            stepper._sharded_solvers[oi] = smf
            stepper._solvers[oi] = smf  # the replicated factor is dropped here
    if stepper._krylov:
        fm = torch.as_tensor(stepper.bcs.free_mask.astype(np.float64), device=dev_t)
        order_of = {oi: o for o, oi in stepper._order_idx.items()}
        for oi, (op, pc) in enumerate(stepper._solvers):
            raw = sharded_apply_builder(forms.transient_lhs(order_of[oi], stepper.u0_nodes),
                                        space.cell_dofs, n, space_group, dev_t, torch.float64)

            def bc_masked_apply(x, _raw=raw, _fm=fm):
                return _raw(x * _fm) * _fm + x * (1.0 - _fm)

            sharded_op = HookedOperator(bc_masked_apply)
            stepper._solvers[oi] = (sharded_op, SimplePreconditioner(
                op=sharded_op, inv_diag_f=pc.inv_diag_f, s_inv=pc.s_inv, vel_mask=pc.vel_mask,
                n_vel=pc.n_vel, jacobi_sweeps=pc.jacobi_sweeps, omega=pc.omega))
    stepper._sharded = True
    return stepper
