"""Start a world of ranks, one process each, and collect what they return.

The JAX package runs its sharded code as one program over virtual or real
devices; the port runs one process per rank. :func:`run_world` spawns them
(the ``spawn`` start method: the parent may have CUDA initialized, which a
forked child cannot use), lets each one join the process group through a
rendezvous file in a fresh temporary directory (never a fixed port, so
several worlds can start at once on one machine), runs ``target(rank,
world_size, *args)`` in each and returns their results in rank order.

A world that hangs or dies fails in bounded time: every collective gives
up after ``init_timeout_s`` (``init_process_group(timeout=...)``), and the
parent kills every rank and raises once one rank has failed or
``timeout_s`` has passed. Under ``torchrun`` no world is spawned:
:func:`init_from_env` joins the one ``torchrun`` started.
"""

from __future__ import annotations

import datetime
import os
import pickle
import shutil
import tempfile
import time
import traceback

import torch
import torch.distributed as dist
import torch.multiprocessing as mp


#: the environment variables that cap a rank's BLAS and OpenMP threads
THREAD_VARS = ("OMP_NUM_THREADS", "OPENBLAS_NUM_THREADS", "MKL_NUM_THREADS")
#: seconds between the parent's looks at its ranks' exit codes
POLL_S = 0.05


def _rank_main(rank: int, world_size: int, backend: str, init_file: str, init_timeout_s: float,
               target, args, result_path: str) -> None:
    threads = os.environ.get("OMP_NUM_THREADS")
    if threads:
        torch.set_num_threads(int(threads))
    if backend == "nccl":
        torch.cuda.set_device(rank % torch.cuda.device_count())
    dist.init_process_group(backend, init_method=f"file://{init_file}", rank=rank,
                            world_size=world_size,
                            timeout=datetime.timedelta(seconds=init_timeout_s))
    try:
        result = target(rank, world_size, *args)
        with open(result_path, "wb") as f:
            pickle.dump(result, f)
        dist.barrier()
    except BaseException:
        traceback.print_exc()
        raise
    finally:
        dist.destroy_process_group()


def run_world(target, world_size: int, args=(), *, backend: str = "gloo",
              timeout_s: float = 600.0, init_timeout_s: float = 60.0,
              threads: int | None = 1, out_dir=None) -> list:
    """Run ``target(rank, world_size, *args)`` in ``world_size`` spawned
    processes joined in one process group of ``backend`` and return their
    results (picklable) in rank order. ``target`` must live in an importable
    module. NCCL ranks take card ``rank % device_count``; gloo ranks choose
    their device themselves. ``threads``, where given, caps each rank's
    BLAS and OpenMP threads (the ranks share the machine's cores) and
    torch's intra-op threads. ``out_dir``, where given, keeps each rank's
    pickled result there (``rank<r>.pkl``). Raises ``RuntimeError`` naming the failed
    rank(s) and their exit codes, or ``TimeoutError`` after ``timeout_s``;
    either way every rank is stopped first."""
    ctx = mp.get_context("spawn")
    tmp = tempfile.mkdtemp(prefix="fc_world_")
    init_file = os.path.join(tmp, "rendezvous")
    paths = [os.path.join(out_dir or tmp, f"rank{r}.pkl") for r in range(world_size)]
    procs = [ctx.Process(target=_rank_main, daemon=True,
                         args=(r, world_size, backend, init_file, init_timeout_s, target, args,
                               paths[r]))
             for r in range(world_size)]
    caps = {k: str(threads) for k in THREAD_VARS} if threads else {}
    saved = {k: os.environ.get(k) for k in caps}
    try:
        os.environ.update(caps)  # a spawned child reads its environment at start
        try:
            for p in procs:
                p.start()
        finally:
            for k, v in saved.items():
                if v is None:
                    os.environ.pop(k, None)
                else:
                    os.environ[k] = v
        deadline = time.monotonic() + timeout_s
        while True:
            codes = [p.exitcode for p in procs]
            failed = [(r, c) for r, c in enumerate(codes) if c not in (None, 0)]
            if failed:
                raise RuntimeError(f"world of {world_size}: rank(s) failed (rank, exit code) "
                                   f"{failed}; the others were stopped")
            if all(c == 0 for c in codes):
                break
            if time.monotonic() > deadline:
                raise TimeoutError(f"world of {world_size} did not finish in {timeout_s:g} s "
                                   f"(exit codes {codes}); every rank was stopped")
            time.sleep(POLL_S)
        results = []
        for path in paths:
            with open(path, "rb") as f:
                results.append(pickle.load(f))
        return results
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
        for p in procs:
            if p.pid is not None:
                p.join(timeout=10)
        shutil.rmtree(tmp, ignore_errors=True)


def init_from_env(backend: str, init_timeout_s: float = 60.0) -> tuple[int, int]:
    """Join the world ``torchrun`` started (its ``RANK``, ``WORLD_SIZE``,
    ``MASTER_ADDR`` and ``MASTER_PORT``); NCCL ranks take card
    ``LOCAL_RANK``. Returns (rank, world size)."""
    rank, size = int(os.environ["RANK"]), int(os.environ["WORLD_SIZE"])
    if backend == "nccl":
        torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", rank)))
    dist.init_process_group(backend, init_method="env://", rank=rank, world_size=size,
                            timeout=datetime.timedelta(seconds=init_timeout_s))
    return rank, size
