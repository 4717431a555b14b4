"""The ranks' side of ``tests/test_torch_sharding.py``: what one rank of a
spawned gloo world computes with the port alone (no JAX, no
``flowcontrol_tpu``), returned to the parent, which holds it against the
JAX package. Every rank runs the same sequence of collectives.

One world of 4 (``world4``): ``mpi_compat``; ``DofShardedOperator`` over
4 ranks and over 2 (the two space groups of a {batch 2, space 2} mesh);
``ShardedMultifrontal`` on the lid cavity at ``n_mesh=14``
(``leaf_max=250``: node- and row-mode stages) over 4 ranks, one and three
right-hand sides, and over 2, three, beside the single-rank per-stage sweep;
``shard_stepper`` on the lid cavity at ``n_mesh=12`` (f64,
``force_substructure``, 3 steps); the JAX dry run's {batch 2, space 2} legs
on its small cylinder (one step and a 3-step closed loop of 4 members); the
sharded demo at ``n_mesh=12`` (its dense and GMRES legs, the latter with
``gmres_iters=10``); one GMRES step of a B = 4 lid-cavity batch sharded
over {batch 2, space 2} and over all-space, from the parent's base flow and
batch; the sharded ω sweep. On the card (``tests/test_torch_cuda.py``): ``cuda_world2``, two
gloo ranks sharing it, and ``cuda_nccl1``, a world of 1 over NCCL.
"""

from __future__ import annotations

import os
import tempfile
import time
from pathlib import Path

import numpy as np
import torch

#: the JAX dry run's closed-loop length (``__graft_entry__.py`` CL_STEPS)
CL_STEPS = 3
#: the dry run's small cylinder mesh (``__graft_entry__._build_small_cylinder``)
TINY_CYLINDER = dict(yinf=4.0, xinf=8.0, xinfa=-3.0, n1=1.6, n2=1.0, n3=0.5, segments=32)
#: the GMRES legs' stepper_options: one cycle of 3 restarts of 3 Arnoldi
#: steps, unconverged (residuals ~0.05-0.1), so that a batch's joint inner
#: products move each member's answer (by ~4e-3 of the peak against the same
#: rows stepped as a batch of their own)
GMRES_OPTIONS = {"gmres_iters": 3, "krylov_max_cycles": 1}


def controller_mats(ns: int, n_act: int, b: int):
    """The dry run's small stable MIMO test controller, batched over a gain
    sweep (``__graft_entry__._controller_mats``)."""
    ad = np.array([[-0.2, 0.1], [0.0, -0.3]])
    bd = np.ones((2, ns)) * 0.1
    cd = np.ones((n_act, 2)) * 0.05
    dd = np.zeros((n_act, ns))
    gains = np.linspace(0.5, 1.5, b)
    return (np.tile(ad, (b, 1, 1)), np.tile(bd, (b, 1, 1)), gains[:, None, None] * cd,
            np.tile(dd, (b, 1, 1)))


def omega_system(n: int = 12, seed: int = 3):
    """A small stable dense (A, B, C, Q) and an ω list of 7 (not a multiple
    of the ranks: the last ω is repeated as padding)."""
    rng = np.random.default_rng(seed)
    a = rng.standard_normal((n, n)) - 4.0 * n ** 0.5 * np.eye(n)
    q = np.eye(n) + 0.1 * np.diag(rng.random(n))
    return a, rng.standard_normal((n, 2)), rng.standard_normal((3, n)), q, np.linspace(0.1, 3.0, 7)


def lid_a_bc(n_mesh: int):
    """The lid cavity's BC-eliminated BDF2 matrix at Re=500 after 3 Picard
    iterations (``tests/test_mf_sharded.py``'s system), and its dof
    coordinates."""
    from flowcontrol_tpu_torch.fem.assembly import to_scipy_csr
    from flowcontrol_tpu_torch.models.lidcavity import LidCavityFlowSolver
    from flowcontrol_tpu_torch.parallel.dofsharding import mixed_dof_coordinates

    fs = LidCavityFlowSolver.make_default(Re=500, num_steps=1, verbose=0, n_mesh=n_mesh,
                                          solver_backend="host_lu", precision="f64", device="cpu",
                                          path_out=Path(tempfile.mkdtemp()))
    fs.compute_steady_state(u_ctrl=[0.0], method="picard", max_iter=3)
    lhs = to_scipy_csr(fs.forms.transient_lhs(2, fs.fields.U0), fs.space.cell_dofs,
                       fs.space.n_dofs)
    a_bc, _ = fs._bcset_perturbation().eliminate_csr(lhs)
    return a_bc, mixed_dof_coordinates(fs.space)


def gmres_batch(u_n: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """The GMRES legs' B = 4 batch: the base state ``u_n`` (n,) perturbed
    per member, and one control each, (4, n) and (4, 1)."""
    up = u_n[None, :] + 1e-2 * np.random.default_rng(4).standard_normal((4, u_n.shape[0]))
    return up, np.linspace(0.02, 0.04, 4)[:, None]


def _dof_operator(group, n_dev: int) -> dict:
    from flowcontrol_tpu_torch.fem.assembly import CellGeometry, mass_velocity_element
    from flowcontrol_tpu_torch.mesh.dofmap import TaylorHoodSpace
    from flowcontrol_tpu_torch.mesh.generation import unit_square_mesh
    from flowcontrol_tpu_torch.parallel.dofsharding import DofPartition, DofShardedOperator

    space = TaylorHoodSpace.build(unit_square_mesh(12, 12))
    a_e = mass_velocity_element(CellGeometry(space))
    op = DofShardedOperator(a_e, space.cell_dofs, space, group, "cpu")
    x = np.random.default_rng(0).standard_normal(space.n_dofs)
    y = op.unshard_vector(op.apply(op.shard_vector(x)))
    part = DofPartition.build(space, 4)
    x1 = np.random.default_rng(1).standard_normal(space.n_dofs)
    return {"y": y, "nbytes": op.per_device_nbytes(), "n_loc": op.part.n_loc,
            "window": op.window, "n_dev": n_dev, "cells": op.n_cells,
            "roundtrip": part.from_spatial(part.to_spatial(x1)) - x1,
            "part": {k: getattr(op.part, k) for k in ("perm", "iperm", "cell_dev")}}


def _sharded_solves(groups: dict) -> dict:
    """The lid cavity's factor (``n_mesh=14``, ``leaf_max=250``) and its
    single-rank per-stage sweep of one and three right-hand sides, then the
    sharded solves over each group of ``groups`` ({n_dev: group})."""
    from flowcontrol_tpu_torch.parallel.mf_sharded import ShardedMultifrontal
    from flowcontrol_tpu_torch.solvers.multifrontal import MultifrontalLU, multifrontal_solve

    a_bc, coords = lid_a_bc(14)
    mf = MultifrontalLU(a_bc, coords, "cpu", dtype=torch.float64, leaf_max=250)
    b = torch.as_tensor(np.random.default_rng(1).standard_normal((3, a_bc.shape[0])))
    out = {"x_sweep": multifrontal_solve(mf, b).numpy(),
           "x_sweep1": multifrontal_solve(mf, b[0]).numpy(), "single_bytes": mf.factor_bytes}
    for n_dev, group in groups.items():
        smf = ShardedMultifrontal(mf, group)
        out[n_dev] = {"x": smf.solve(b).numpy(), "x1": smf.solve(b[0]).numpy(),
                      "per_device_factor_bytes": smf.per_device_factor_bytes,
                      "total_factor_bytes": smf.total_factor_bytes,
                      "modes": [s["mode"] for s in smf._stages],
                      "held": smf.flat_stacks.numel() * 8}
    return out


def _stepper_leg(mesh, out_dir: Path) -> dict:
    """The JAX package's ``test_shard_stepper_distributes_direct_solve``."""
    from flowcontrol_tpu_torch.models.lidcavity import LidCavityFlowSolver
    from flowcontrol_tpu_torch.parallel.mf_sharded import ShardedMultifrontal
    from flowcontrol_tpu_torch.parallel.mpi_compat import peval
    from flowcontrol_tpu_torch.parallel.sharding import shard_stepper

    fs = LidCavityFlowSolver.make_default(
        Re=500, num_steps=3, verbose=0, n_mesh=12, path_out=out_dir / "stepper",
        solver_backend="dense_lu", precision="f64", device="cpu",
        stepper_options={"force_substructure": True},
    )
    fs.compute_steady_state(u_ctrl=[0.0], method="picard", max_iter=3)
    fs.initialize_time_stepping()
    st = fs.stepper
    kinds = list(st._solver_kinds)
    shard_stepper(st, mesh.space)
    ys = [fs.step(np.array([0.01])) for _ in range(3)]
    x = np.asarray(fs.fields.up_)
    return {"x": x, "y": ys[-1], "kinds": kinds,
            "sharded": sorted(oi for oi, s in enumerate(st._solvers)
                              if isinstance(s, ShardedMultifrontal)),
            "peval": peval(fs, fs.stepper._tensor(x), (0.5, 0.5), 0), "u0": fs.fields.U0}


def _batch_space_leg(mesh, out_dir: Path) -> dict:
    """The JAX dry run's legs 2 and 3 on a {batch 2, space 2} mesh: one step
    and a CL_STEPS closed loop of the 4-member batch, this rank's rows."""
    from flowcontrol_tpu_torch.mesh.generation import cylinder_mesh
    from flowcontrol_tpu_torch.models.cylinder import CylinderFlowSolver
    from flowcontrol_tpu_torch.parallel.sharding import shard_stepper

    fs = CylinderFlowSolver.make_default(
        Re=100, num_steps=10, verbose=0, mesh=cylinder_mesh(**TINY_CYLINDER), device="cpu",
        solver_backend="dense_lu", precision="f64", path_out=out_dir / "cylinder",
        stepper_options={"force_substructure": True},
    )
    fs.compute_steady_state(u_ctrl=[0.0, 0.0], method="picard", max_iter=4)
    fs.initialize_time_stepping()
    st = fs.stepper
    b = 4
    up0 = fs._carry.u_n.numpy()
    up_batch = up0[None, :] + 1e-3 * np.random.default_rng(0).standard_normal((b, up0.shape[0]))
    rows = slice(2 * mesh.batch_rank, 2 * mesh.batch_rank + 2)
    shard_stepper(st, mesh.space, mesh.batch)
    smf = next(iter(st._sharded_solvers.values()))
    carry = st.init_carry(up_batch[rows])
    new, out = st.step(carry, np.zeros((2, st.n_act)))
    k_mats = tuple(m[rows] for m in controller_mats(st.ns, st.n_act, b))
    _, (y_cl, _, u_cl, _) = st.closed_loop_fn(CL_STEPS)(carry, k_mats, np.zeros((2, st.ns)))
    return {"rows": (rows.start, rows.stop), "space_rank": mesh.space_rank,
            "batch_rank": mesh.batch_rank, "x_step": new.u_n.numpy(), "y_step": out.y.numpy(),
            "y_cl": y_cl.numpy(), "u_cl": u_cl.numpy(), "n_dofs": fs.space.n_dofs,
            "per_device_factor_bytes": smf.per_device_factor_bytes,
            "total_factor_bytes": smf.total_factor_bytes}


def _gmres_legs(mesh, mesh2, gmres_in, out_dir: Path) -> dict:
    """One GMRES step (GMRES_OPTIONS) of the B = 4 batch on the lid cavity
    at ``n_mesh=12`` (f64), from the parent's base flow and batch
    (``gmres_in``): sharded over {batch 2, space 2} (this batch group's two
    rows; the inner products summed over the batch group too) and over
    all-space (the whole batch); and, before sharding, this batch group's
    rows stepped as a batch of their own (what a batch group without its
    ``all_reduce`` would give)."""
    from flowcontrol_tpu_torch.models.lidcavity import LidCavityFlowSolver
    from flowcontrol_tpu_torch.parallel.sharding import shard_stepper

    u0, p0, up, u = gmres_in
    rows = slice(2 * mesh2.batch_rank, 2 * mesh2.batch_rank + 2)

    def stepper(name):
        fs = LidCavityFlowSolver.make_default(
            Re=500, num_steps=5, verbose=0, n_mesh=12, path_out=out_dir / name,
            solver_backend="gmres", precision="f64", device="cpu",
            stepper_options=dict(GMRES_OPTIONS))
        fs._assign_steady_state(u0.copy(), p0.copy())
        fs.initialize_time_stepping()
        return fs.stepper

    def step(st, r):
        return st.step(st.init_carry(up[r]), u[r])[0].u_n.numpy()

    st = stepper("gmres_bs")
    alone = step(st, rows)
    shard_stepper(st, mesh2.space, mesh2.batch)
    x_bs = step(st, rows)
    st = stepper("gmres_space")
    shard_stepper(st, mesh.space)
    return {"rows": (rows.start, rows.stop), "space_rank": mesh2.space_rank, "x_bs": x_bs,
            "x_space": step(st, slice(None)), "x_alone": alone}


def world4(rank: int, size: int, gmres_in: tuple) -> dict:
    import torch.distributed as dist

    from flowcontrol_tpu_torch.examples import demo_sharded
    from flowcontrol_tpu_torch.parallel import mpi_compat
    from flowcontrol_tpu_torch.parallel.sharding import make_device_mesh
    from flowcontrol_tpu_torch.utils.linalg import get_frequency_response_mpi

    os.environ["FLOWCONTROL_TPU_FACTOR_CACHE"] = "off"
    out_dir = Path(tempfile.mkdtemp(prefix=f"rank{rank}_"))
    mesh = make_device_mesh()
    mesh2 = make_device_mesh(n_batch=2)  # its space groups: ranks {0, 1} and {2, 3}
    out = {"mpi": (mpi_compat.get_rank(), mpi_compat.get_size(),
                   mpi_compat.mpi_broadcast(10 * rank + 7), mpi_compat.MpiUtils.get_rank()),
           "backend": str(dist.get_backend())}
    legs = (("dof", lambda: {4: _dof_operator(mesh.space, 4), 2: _dof_operator(mesh2.space, 2)}),
            ("smf", lambda: _sharded_solves({4: mesh.space, 2: mesh2.space})),
            ("stepper", lambda: _stepper_leg(mesh, out_dir)),
            ("batch_space", lambda: _batch_space_leg(mesh2, out_dir)),
            ("demo", lambda: demo_sharded.run("cpu", n_mesh=12, out_dir=out_dir / "demo",
                                              gmres_iters=10)),
            ("gmres", lambda: _gmres_legs(mesh, mesh2, gmres_in, out_dir)),
            ("omega", lambda: get_frequency_response_mpi(*omega_system(), dist.group.WORLD,
                                                         dtype=torch.complex128, device="cpu")))
    out["seconds"] = {}
    for name, leg in legs:
        t0 = time.perf_counter()
        out[name] = leg()
        out["seconds"][name] = time.perf_counter() - t0
    return out


# ── the card (tests/test_torch_cuda.py, marker cuda) ─────────────────────────


def cuda_world2(rank: int, size: int) -> dict:
    """Two gloo ranks sharing card 0: the sharded solve of a small cavity's
    f32 factor through K2 and P1 against the single-rank per-stage sweep,
    at 1 and 64 right-hand sides, and the sharded N(u) through K1 against K1
    on the whole coarse cylinder mesh, at 1 and 4."""
    from flowcontrol_tpu_torch.fem.assembly import CellGeometry, to_scipy_csr
    from flowcontrol_tpu_torch.mesh.dofmap import TaylorHoodSpace
    from flowcontrol_tpu_torch.mesh.generation import cavity_mesh, cylinder_mesh
    from flowcontrol_tpu_torch.models.cavity import CavityFlowSolver
    from flowcontrol_tpu_torch.ops.mf_matvec import stack_matvec, sweep_gather
    from flowcontrol_tpu_torch.ops.nl import NLTables, nonlinear_convection
    from flowcontrol_tpu_torch.parallel import comm
    from flowcontrol_tpu_torch.parallel.dofsharding import mixed_dof_coordinates
    from flowcontrol_tpu_torch.parallel.mf_sharded import ShardedMultifrontal
    from flowcontrol_tpu_torch.parallel.sharding import make_device_mesh, sharded_nonlinear_builder
    from flowcontrol_tpu_torch.solvers.multifrontal import MultifrontalLU, multifrontal_solve

    os.environ["FLOWCONTROL_TPU_FACTOR_CACHE"] = "off"
    dev = torch.device("cuda", 0)
    mesh = make_device_mesh()
    fs = CavityFlowSolver.make_default(mesh=cavity_mesh(n_coarse=4, n_mid=8, n_fine=16),
                                       device="cpu", path_out=Path(tempfile.mkdtemp()))
    lhs = fs.forms.transient_lhs(2, fs._default_steady_state_initial_guess())
    a_bc, _ = fs._bcset_perturbation().eliminate_csr(
        to_scipy_csr(lhs, fs.space.cell_dofs, fs.space.n_dofs))
    mf = MultifrontalLU(a_bc, mixed_dof_coordinates(fs.space), dev, dtype=torch.float32,
                        leaf_max=300)
    rng = np.random.default_rng(0)
    out = {"staging": comm.staging(mesh.space, dev), "solve": {}}
    rhs = {rows: torch.as_tensor(rng.standard_normal((rows, mf.n)), dtype=torch.float32,
                                 device=dev) for rows in (1, 64)}
    single = {rows: multifrontal_solve(mf, b) for rows, b in rhs.items()}
    smf = ShardedMultifrontal(mf, mesh.space)
    for rows, b in rhs.items():
        before = (stack_matvec.launches, sweep_gather.launches)
        x = smf.solve(b)
        torch.cuda.synchronize()
        out["solve"][rows] = {
            "rel": float((x - single[rows]).norm() / single[rows].norm()),
            "bitwise": bool(torch.equal(x, single[rows])),
            "launches": (stack_matvec.launches - before[0], sweep_gather.launches - before[1])}
    out["modes"] = [s["mode"] for s in smf._stages]
    out["factor_bytes"] = (smf.per_device_factor_bytes, smf.total_factor_bytes, mf.factor_bytes)

    space = TaylorHoodSpace.build(cylinder_mesh(yinf=5.0, xinf=15.0, xinfa=-5.0, n1=4.0, n2=2.0,
                                                n3=0.8, segments=80))
    geom = CellGeometry(space)
    nl = sharded_nonlinear_builder(geom, space, mesh.space, dev, torch.float32)
    whole = NLTables.build(geom, space, dev, torch.float32)
    out["nl"] = {}
    for rows in (1, 4):
        u = torch.as_tensor(np.random.default_rng(rows).standard_normal((rows, space.n_dofs)),
                            dtype=torch.float32, device=dev)
        before = nonlinear_convection.launches
        got = nl(u)
        k1 = nonlinear_convection.launches - before
        want = nonlinear_convection(whole, u)
        out["nl"][rows] = {"rel": float((got - want).abs().max() / want.abs().max()),
                           "launches": k1}
    return out


def cuda_nccl1(rank: int, size: int) -> dict:
    """A world of 1 over NCCL: the coarse cylinder (f32,
    ``force_substructure``) stepped 3 times unsharded and 3 times through
    ``shard_stepper`` from the same carry, with the launches of the sharded
    steps."""
    from flowcontrol_tpu_torch.mesh.generation import cylinder_mesh
    from flowcontrol_tpu_torch.models.cylinder import CylinderFlowSolver
    from flowcontrol_tpu_torch.ops.mf_fused import multifrontal_solve_fused
    from flowcontrol_tpu_torch.ops.mf_matvec import stack_matvec, sweep_gather
    from flowcontrol_tpu_torch.ops.nl import nonlinear_convection
    from flowcontrol_tpu_torch.parallel.sharding import make_device_mesh, shard_stepper

    os.environ["FLOWCONTROL_TPU_FACTOR_CACHE"] = "off"
    dev = torch.device("cuda", torch.cuda.current_device())
    fs = CylinderFlowSolver.make_default(
        Re=100, num_steps=10, verbose=0, device=dev, path_out=Path(tempfile.mkdtemp()),
        mesh=cylinder_mesh(yinf=5.0, xinf=15.0, xinfa=-5.0, n1=4.0, n2=2.0, n3=0.8,
                           segments=80),
        stepper_options={"force_substructure": True},
    )
    fs.compute_steady_state(u_ctrl=[0.0, 0.0], method="picard", max_iter=3)
    fs.initialize_time_stepping()
    st = fs.stepper
    u = np.array([0.3, -0.2])
    carry = fs._carry
    for _ in range(3):
        carry, out = st.step(carry, u)
    x_ref, y_ref = carry.u_n.double().cpu().numpy(), out.y.double().cpu().numpy()
    shard_stepper(st, make_device_mesh().space)
    counters = (nonlinear_convection, stack_matvec, sweep_gather, multifrontal_solve_fused)
    before = [c.launches for c in counters]
    carry = fs._carry
    for _ in range(3):
        carry, out = st.step(carry, u)
    torch.cuda.synchronize()
    x, y = carry.u_n.double().cpu().numpy(), out.y.double().cpu().numpy()
    return {"rel": float(np.linalg.norm(x - x_ref) / np.linalg.norm(x_ref)),
            "y": y, "y_ref": y_ref, "kinds": list(st._solver_kinds),
            "launches": [c.launches - b for c, b in zip(counters, before)]}
