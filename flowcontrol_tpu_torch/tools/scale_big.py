"""Past the reference's biggest case: the half-million-dof cylinder through
the multifrontal f32 path on one card.

    python -m flowcontrol_tpu_torch.tools.scale_big sizes
    python -m flowcontrol_tpu_torch.tools.scale_big run [DENSITY] [--device cpu] [--out DIR]
    python -m flowcontrol_tpu_torch.tools.scale_big factor [DENSITY] --cache DIR [--out DIR]

The port's copy of the JAX package's ``tools/scale_big.py``. A graded
cylinder mesh (``models/make_baseflow.cylinder_big_mesh_kwargs``: dofs grow
~density², density 30 gives 506,553 dofs, 2.2x the reference's largest
artifact, the 235k-dof stock cavity), its base flow at Re=100, the BDF2
system's multifrontal factor (the 'auto' rule takes it: a dense LU of
16 n² bytes, 4.1 TB here, fits no card) and a 50-step single-stream
open-loop rollout, run twice (the first run pays for the CUDA graph's
capture).

- ``sizes``: the cells and dofs of densities 12, 24, 29, 30 and 32.
- ``run`` (default density 30, the JAX package's recorded ``run 30``;
  past 400,000 dofs, density 29 and up, as the JAX tool asserts):
  the committed base flow where the mesh matches
  (``models/_baseflows/cylinder_re100_n506553.npz``), else one in ``--out``
  that fits, else Picard 4 + Newton 8 on the host in float64
  (``make_baseflow.cylinder_big_steady``) written into ``--out`` (default
  ``./data_output_scale_big``, never the package); then the JAX tool's
  ``RESULT`` line (n_dofs, single steps/s, prepare s, compile s, y_last),
  the factor's set-up split (``MultifrontalLU.timings``, ``loaded_from``),
  stages, GB and kernel F's shared-memory bytes at 1 and 8 rows.
- ``factor``: the factor of ``run``'s system built on the host
  (``device="cpu"``) into the factor cache directory ``--cache``: its
  primary entry and its derived entry (the device layout), from the
  committed base flow or one in ``--out`` (it computes none). ``run`` with
  ``FLOWCONTROL_TPU_FACTOR_CACHE`` set to that directory streams the
  derived entry to the card instead of factorizing. The BLAS and torch
  threads follow ``OMP_NUM_THREADS``, ``OPENBLAS_NUM_THREADS`` and
  ``MKL_NUM_THREADS``.

Imports torch, numpy and scipy, never JAX.
"""

from __future__ import annotations

import argparse
import logging
import os
import resource
import tempfile
import time
from pathlib import Path

import numpy as np

from flowcontrol_tpu_torch.models.make_baseflow import (
    CYLINDER_BIG_DENSITY,
    cylinder_big_mesh_kwargs,
    cylinder_big_steady,
    steady_residual,
)

log = logging.getLogger("scale_big")

#: densities ``sizes`` prints (the JAX tool's, and the recorded run's 30)
SIZES = (12.0, 24.0, 29.0, 30.0, 32.0)
#: the rollout's steps (the JAX tool's)
ROLLOUT_STEPS = 50
#: ``run`` is the scaling run: it refuses a mesh at or below this many dofs
#: (the JAX tool's assertion)
MIN_DOFS = 400_000


def build(density: float, backend: str, precision: str, num_steps: int = ROLLOUT_STEPS,
          device=None, path_out=None, stepper_options=None):
    """The cylinder at Re=100 on the graded mesh of ``density`` (the JAX
    tool's ``build``); ``device`` as ``make_default`` takes it (the card
    unless 'cpu'); ``stepper_options`` the Stepper's (a small mesh takes
    the multifrontal solve with ``force_substructure``)."""
    from flowcontrol_tpu_torch.models.cylinder import CylinderFlowSolver

    kw = {} if device is None else {"device": device}
    return CylinderFlowSolver.make_default(
        Re=100, num_steps=num_steps, save_every=0, verbose=10,
        path_out=Path.cwd() / "data_output_scale_big" if path_out is None else path_out,
        solver_backend=backend, precision=precision,
        mesh_kwargs=cylinder_big_mesh_kwargs(density), stepper_options=stepper_options or {},
        **kw)


def base_flow(fs, out_dir) -> str:
    """Give ``fs`` its base flow: the committed file or one in ``out_dir``
    that fits its mesh, else the recipe (Picard 4 + Newton 8, host f64),
    written into ``out_dir``. Returns how it was found."""
    from flowcontrol_tpu_torch.models.baseflows import committed_baseflow, write_baseflow

    for directory in (None, out_dir):
        path = committed_baseflow(fs, directory)
        if path is not None:
            fs.load_steady_state(path)
            return f"loaded {path}"
    stages = []
    cylinder_big_steady(fs, stages)
    path = write_baseflow(fs, out_dir)
    return (f"computed ({', '.join(f'{name} {s:.0f} s' for name, s in stages)}; steady "
            f"residual {steady_residual(fs):.3e}), written to {path}")


def prepare(fs) -> float:
    """The JAX tool's set-up of the BDF2 system alone (its ``:80-86``):
    ``initialize_time_stepping``, order 2, ``_prepare_systems``; returns
    its seconds."""
    t0 = time.perf_counter()
    fs.initialize_time_stepping()
    fs.order = 2
    fs._prepare_systems()
    fs.first_step = False
    return time.perf_counter() - t0


def factor_report(st) -> str:
    """The multifrontal factor of ``st``'s BDF2 system: where it came
    from, its set-up split, stages, GB and (on a card) kernel F's grid and
    shared memory at 1 and 8 rows."""
    from flowcontrol_tpu_torch.ops.mf_fused import fused_grid, fused_smem_bytes

    mf = st._solvers[st._order_idx[2]]
    t = mf.timings
    line = (f"factor {mf.loaded_from}: " + ", ".join(f"{k} {v:.2f} s" for k, v in t.items())
            + f"; {len(mf.stages)} stages, {mf.factor_bytes / 1e9:.4f} GB of stacks, max_front "
            f"{mf.max_front}, per-solve error {mf.solve_err:.3e}")
    if mf.device.type == "cuda":
        for rows in (1, 8):
            g = fused_grid(rows, mf.max_front, len(mf.stages))
            line += (f"; F at {rows} row(s): {fused_smem_bytes(mf, rows)} bytes of shared "
                     f"memory, {g['blocks']} blocks ({g['per_sm']} per SM)")
    return line


def run(density: float = CYLINDER_BIG_DENSITY, device=None, out_dir=None) -> dict:
    """The JAX tool's ``run``: mesh, base flow, the BDF2 system's factor
    ('auto': the multifrontal solve, asserted), then the 50-step open-loop
    rollout twice. Returns the RESULT figures."""
    out_dir = Path.cwd() / "data_output_scale_big" if out_dir is None else Path(out_dir)
    t0 = time.perf_counter()
    fs = build(density, "dense_lu", "f32", device=device, path_out=out_dir)
    n = fs.space.n_dofs
    log.info("mesh: %d cells, %d dofs (%.0f s)", fs.mesh.num_cells, n, time.perf_counter() - t0)
    if n <= MIN_DOFS:
        raise AssertionError(f"density {density:g} only reached {n} dofs")
    how = base_flow(fs, out_dir)
    log.info("base flow %s (%.0f s)", how, time.perf_counter() - t0)

    prepare_s = prepare(fs)
    st = fs._stepper
    if st._solver_kinds != ["multifrontal"]:
        raise AssertionError(f"'auto' took {st._solver_kinds} at {n} dofs, not the multifrontal "
                             "solve")
    log.info("prepare: %.0f s, kinds=%s; %s", prepare_s, st._solver_kinds, factor_report(st))

    roll = st.make_rollout_open_loop()
    u_seq = np.zeros((ROLLOUT_STEPS, st.n_act), dtype=np.float32)
    t1 = time.perf_counter()
    _, outs = roll(fs._carry, u_seq)
    _ = outs.y.cpu()
    compile_s = time.perf_counter() - t1
    t1 = time.perf_counter()
    _, outs = roll(fs._carry, u_seq)
    y = outs.y.double().cpu().numpy()
    single = ROLLOUT_STEPS / (time.perf_counter() - t1)
    if not (np.isfinite(y).all() and bool(outs.dE.isfinite().all())):
        raise AssertionError("diverged")
    print(f"RESULT n_dofs={n} single={single:.1f} steps/s prepare={prepare_s:.0f}s "
          f"compile={compile_s:.0f}s y_last={y[-1].round(6)}", flush=True)
    return dict(n_dofs=n, single=single, prepare_s=prepare_s, compile_s=compile_s,
                y_last=y[-1], kinds=list(st._solver_kinds))


def factor(density: float, cache_dir, base_dir=None, stepper_options=None) -> str:
    """Build the factor of ``run``'s BDF2 system on the host into the
    factor cache ``cache_dir`` (primary and derived entries, written before
    it returns), from the committed base flow or one in ``base_dir`` that
    fits the mesh (``ValueError`` where none does: this computes none).
    Returns the factor's report."""
    from flowcontrol_tpu_torch.models.baseflows import committed_baseflow
    from flowcontrol_tpu_torch.solvers import factor_cache

    t0 = time.perf_counter()
    saved = os.environ.get("FLOWCONTROL_TPU_FACTOR_CACHE")
    os.environ["FLOWCONTROL_TPU_FACTOR_CACHE"] = str(cache_dir)
    try:
        with tempfile.TemporaryDirectory() as out:
            fs = build(density, "dense_lu", "f32", device="cpu", path_out=out,
                       stepper_options=stepper_options)
            path = committed_baseflow(fs) or (base_dir and committed_baseflow(fs, base_dir))
            if path is None:
                raise ValueError(f"no base flow matches the {fs.space.n_dofs}-dof mesh of "
                                 f"density {density:g}")
            fs.load_steady_state(path)
            t_mesh = time.perf_counter() - t0
            t_prep = prepare(fs)
        t1 = time.perf_counter()
        factor_cache.flush()
    finally:
        if saved is None:
            os.environ.pop("FLOWCONTROL_TPU_FACTOR_CACHE")
        else:
            os.environ["FLOWCONTROL_TPU_FACTOR_CACHE"] = saved
    rss = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 2**20  # KiB on Linux
    return (f"n_dofs {fs.space.n_dofs}: mesh and base flow {t_mesh:.2f} s, prepare {t_prep:.2f} s, "
            f"entries written {time.perf_counter() - t1:.2f} s more, {time.perf_counter() - t0:.2f} "
            f"s in all; peak host memory {rss:.2f} GiB; {factor_report(fs._stepper)}")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("cmd", choices=("sizes", "run", "factor"))
    ap.add_argument("density", nargs="?", type=float, default=CYLINDER_BIG_DENSITY)
    ap.add_argument("--device", default=None, help="'cpu' for the host (default: the card)")
    ap.add_argument("--out", type=Path, default=None)
    ap.add_argument("--cache", type=Path, default=None, help="factor: the cache directory")
    args = ap.parse_args(argv)
    logging.basicConfig(level=logging.INFO, format="%(asctime)s %(name)s %(message)s")
    if args.cmd == "sizes":
        for d in SIZES:
            t0 = time.perf_counter()
            fs = build(d, "host_lu", "f64", num_steps=1, device="cpu", path_out=args.out)
            print(f"density {d:.0f}: {fs.mesh.num_cells} cells, {fs.space.n_dofs} dofs "
                  f"({time.perf_counter() - t0:.1f} s)", flush=True)
    elif args.cmd == "run":
        run(args.density, device=args.device, out_dir=args.out)
    else:
        if args.cache is None:
            ap.error("factor needs --cache DIR")
        print(factor(args.density, args.cache, base_dir=args.out), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
