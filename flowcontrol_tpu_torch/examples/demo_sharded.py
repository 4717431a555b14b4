"""Sharded execution demo (the reference's MPI smoke test).

    torchrun --nproc-per-node=4 -m flowcontrol_tpu_torch.examples.demo_sharded --device cpu
    torchrun --nproc-per-node=N -m flowcontrol_tpu_torch.examples.demo_sharded

The port's copy of ``examples/demo_sharded.py`` (ref:
src/examples/mpitest/demo_poisson.py, an annotated MPI Poisson demo): the
lid-driven cavity stepped on every rank, then its cells split over the
world's ranks (``parallel/sharding.shard_stepper``: the element applies and
N(u) summed by ``all_reduce``), and the sharded steps held to the
single-rank ones. The first leg steps the dense-LU path (the solve stays
replicated), the second the GMRES backend, whose operator, inside GMRES
and inside the SIMPLE preconditioner, is the sharded apply. With ``--device
cpu`` the ranks join over gloo and step in f64 (the JAX demo's precision
and its 1e-9); on the card they join over NCCL, one card a rank, and step
in f32 (kernel K1 takes f32 only). Each leg asserts its largest difference
is below ``--tol``.
"""

from __future__ import annotations

import argparse
import tempfile
from pathlib import Path

import numpy as np
import torch
import torch.distributed as dist

from flowcontrol_tpu_torch.models.lidcavity import LidCavityFlowSolver
from flowcontrol_tpu_torch.parallel.sharding import make_device_mesh, shard_stepper


def run(device: str, n_mesh: int = 16, tol: float = 1e-9, out_dir=None,
        gmres_iters: int = 30) -> dict:
    """Both legs on this rank, on ``device`` ('cpu': f64; a card: f32), in
    a world already joined; returns the sharded states, their single-rank
    references and the differences.
    ``gmres_iters``: the GMRES leg's Arnoldi steps per restart and restarts
    per cycle (the Stepper's default 30; every Arnoldi step of the sharded
    leg makes five ``all_reduce`` calls)."""
    out_dir = Path(out_dir or tempfile.mkdtemp(prefix="demo_sharded_"))
    precision = "f64" if torch.device(device).type == "cpu" else "f32"
    fs = LidCavityFlowSolver.make_default(
        Re=500, num_steps=5, verbose=0, n_mesh=n_mesh, path_out=out_dir / "dense",
        solver_backend="dense_lu", precision=precision, device=device,
    )
    fs.compute_steady_state(u_ctrl=[0.0], method="picard", max_iter=4)
    fs.compute_steady_state(u_ctrl=[0.0], method="newton", initial_guess=fs.fields.UP0)
    fs.initialize_time_stepping()
    st = fs.stepper
    zero = np.zeros(1)

    # single-rank reference
    carry = st.init_carry(fs._carry.u_n)
    for _ in range(3):
        carry, _ = st.step(carry, zero)
    ref = carry.u_n.cpu().numpy()

    # sharded: the cells over a 'space' group of every rank
    mesh = make_device_mesh()
    shard_stepper(st, mesh.space)
    carry = st.init_carry(fs._carry.u_n)
    for _ in range(3):
        carry, _ = st.step(carry, zero)
    sh = carry.u_n.cpu().numpy()
    err = float(np.abs(sh - ref).max())

    # ── Krylov leg: the GMRES operator (solver and preconditioner) sharded ──
    fs2 = LidCavityFlowSolver.make_default(
        Re=500, num_steps=5, verbose=0, n_mesh=n_mesh, path_out=out_dir / "gmres",
        solver_backend="gmres", precision=precision, device=device,
        stepper_options={"gmres_iters": gmres_iters},
    )
    fs2._assign_steady_state(fs.fields.U0.copy(), fs.fields.P0.copy())
    fs2.initialize_time_stepping()
    st2 = fs2.stepper
    carry2 = st2.init_carry(fs2._carry.u_n)
    carry2, _ = st2.step(carry2, zero)
    ref2 = carry2.u_n.cpu().numpy()
    shard_stepper(st2, mesh.space)
    carry2 = st2.init_carry(fs2._carry.u_n)
    carry2, _ = st2.step(carry2, zero)
    sh2 = carry2.u_n.cpu().numpy()
    err2 = float(np.abs(sh2 - ref2).max())
    return {"ranks": dist.get_world_size(), "backend": str(dist.get_backend()),
            "err": err, "err_gmres": err2, "x": sh, "x_ref": ref, "x_gmres": sh2,
            "x_gmres_ref": ref2, "u0": fs.fields.U0, "p0": fs.fields.P0, "tol": tol}


def main(argv=None) -> dict:
    from flowcontrol_tpu_torch.parallel.launch import init_from_env

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda", help="'cpu' (gloo) or 'cuda' (NCCL)")
    ap.add_argument("--n-mesh", type=int, default=16)
    ap.add_argument("--tol", type=float, default=1e-9)
    ap.add_argument("--gmres-iters", type=int, default=30)
    args = ap.parse_args(argv)
    cpu = torch.device(args.device).type == "cpu"
    rank, size = init_from_env("gloo" if cpu else "nccl")
    device = "cpu" if cpu else f"cuda:{torch.cuda.current_device()}"
    try:
        r = run(device, n_mesh=args.n_mesh, tol=args.tol, gmres_iters=args.gmres_iters)
        if rank == 0:
            print(f"ranks: {size} ({r['backend']}), sharded-vs-single max err: {r['err']:.2e}")
            print(f"gmres sharded-vs-single max err: {r['err_gmres']:.2e}")
        assert r["err"] < args.tol and r["err_gmres"] < args.tol, (r["err"], r["err_gmres"])
        if rank == 0:
            print("sharded demo OK")
        return r
    finally:
        dist.destroy_process_group()


if __name__ == "__main__":
    main()
