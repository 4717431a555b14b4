"""The port's blocked-LU solves on the JAX package's own factor.

A JAX ``BlockLU`` factor (float64, CPU) is carried across with
``block_lu_from_numpy``; the port's plain ``block_lu_solve`` and the K3
wrapper ``block_lu_solve_fused`` (on the CPU: the plain version) are held
against JAX ``block_lu_solve`` and against the TPU kernel
``pallas_block_lu_solve`` run as ``tests/test_pallas_trisolve.py`` runs it
(interpret mode on the CPU), on the same seeded right-hand sides of shape
(n,), (3, n) and (2, 3, n): 1e-12 absolute in float64 (the same products,
summed in another order), and the residual of the system below 1e-12.

K3's panel schedule: a topological order of the dependencies the kernel
waits on, every 64-column slice of every tile updated once per step that
touches it, one launch per panel solve and 3 nb - 2 per single
right-hand side; its plain walk (``block_lu_solve_scheduled_plain``, which
checks every wait), over a 256-column panel with the items next to each
step split, against the TPU kernel and JAX's solve on the JAX factor, to
1e-12.
"""

import numpy as np
import pytest
import torch

from flowcontrol_tpu.ops.pallas_trisolve import pallas_block_lu_solve
from flowcontrol_tpu.solvers.block_lu import BlockLU as BlockLUJ
from flowcontrol_tpu.solvers.block_lu import block_lu_solve as block_lu_solve_j
from flowcontrol_tpu_torch.ops.trisolve import (
    BWD,
    DINV,
    FWD,
    SPLIT_AHEAD,
    block_lu_solve_fused,
    block_lu_solve_scheduled_plain,
    item_waits,
    launches_per_solve,
    panel_schedule,
    tiles_per_block,
)
from flowcontrol_tpu_torch.solvers.block_lu import block_lu_from_numpy, block_lu_solve

torch.set_num_threads(1)

BS = 128
# (n, diagonal shift, noise) of tests/test_pallas_trisolve.py: n = 300 pads
# to 384, n = 256 does not pad
SYSTEMS = {300: (30.0, 0.3, 0), 256: (10.0, 0.2, 1)}


@pytest.fixture(scope="module", params=sorted(SYSTEMS))
def system(request):
    n = request.param
    shift, noise, seed = SYSTEMS[n]
    a = np.eye(n) * shift + noise * np.random.default_rng(seed).standard_normal((n, n))
    fj = BlockLUJ(a, bs=BS, dtype=np.float64)
    ft = block_lu_from_numpy(np.asarray(fj.lu), np.asarray(fj.dinv), BS, n, "cpu", torch.float64)
    return n, a, fj, ft


@pytest.mark.parametrize("solve", [block_lu_solve, block_lu_solve_fused],
                         ids=["plain", "fused_wrapper"])
@pytest.mark.parametrize("batch", [(), (3,), (2, 3)], ids=["n", "3xn", "2x3xn"])
def test_torch_trisolve_matches_jax_on_jax_factor(system, solve, batch):
    n, a, fj, ft = system
    b = np.random.default_rng(10 + len(batch)).standard_normal(batch + (n,))
    before = block_lu_solve_fused.launches
    x = solve(ft.tree(), torch.as_tensor(b), bs=BS, n=n)
    assert block_lu_solve_fused.launches == before  # no kernel launch on the CPU
    assert x.shape == b.shape and x.dtype == torch.float64 and x.is_contiguous()
    x = x.numpy()
    x_xla = np.asarray(block_lu_solve_j((fj.lu, fj.dinv), b, bs=BS, n=n))
    x_pallas = np.asarray(pallas_block_lu_solve((fj.lu, fj.dinv), b, bs=BS, n=n))
    assert np.abs(x - x_xla).max() <= 1e-12
    assert np.abs(x - x_pallas).max() <= 1e-12
    res = a @ x.reshape(-1, n).T - b.reshape(-1, n).T
    assert np.linalg.norm(res) / np.linalg.norm(b) < 1e-12


def test_torch_trisolve_refuses_wrong_width(system):
    n, _, _, ft = system
    for solve in (block_lu_solve, block_lu_solve_fused):
        with pytest.raises(ValueError):
            solve(ft.tree(), torch.zeros(n + 1, dtype=torch.float64), bs=BS, n=n)


@pytest.mark.parametrize("ns", [1, 4])
@pytest.mark.parametrize("nb,bs", [(1, 128), (3, 128), (44, 16), (56, 1024)])
def test_torch_trisolve_panel_schedule_is_topological(nb, bs, ns):
    """Walked in claim order, every item's waits are met by the items before
    it (so spinning blocks cannot deadlock), and each tile receives exactly
    its updates, over every 64-column slice of a panel ns slices wide:
    forward from every k below its block row, backward from every k above,
    one dinv product; only the items next to the step are split."""
    tpb = tiles_per_block(bs)
    sched = panel_schedule(nb, tpb, ns)
    cnt, ocnt = np.zeros(nb * tpb, int), np.zeros(nb * tpb, int)
    done = np.zeros((3, nb, nb * tpb, ns), int)  # (kind, k, tile, slice) coverage
    for kind, k, tile, piece in sched.tolist():
        blk = tile // tpb
        assert (kind == FWD and k < blk) or (kind == DINV and k == blk) or (kind == BWD and k > blk)
        assert piece == -1 or (0 <= piece < ns and ns > 1 and (
            kind == DINV or abs(k - blk) <= SPLIT_AHEAD))
        for name, i, at_least in item_waits(kind, k, tile, nb, tpb, ns):
            assert (cnt if name == "cnt" else ocnt)[i] >= at_least
        (ocnt if kind == DINV else cnt)[tile] += ns if piece < 0 else 1
        done[kind, k, tile, slice(None) if piece < 0 else piece] += 1
    assert bool((cnt == (nb - 1) * ns).all()) and bool((ocnt == ns).all())
    assert done.max() == 1  # no slice of an update twice
    assert launches_per_solve(nb, 2) == launches_per_solve(nb, 256) == 1
    assert launches_per_solve(nb, 1) == 3 * nb - 2


@pytest.mark.parametrize("batch", [(), (3,), (2, 3)], ids=["n", "3xn", "2x3xn"])
def test_torch_trisolve_scheduled_walk_matches_jax_on_jax_factor(system, batch):
    n, a, fj, ft = system
    b = np.random.default_rng(30 + len(batch)).standard_normal(batch + (n,))
    # a panel of 256 columns: the items next to each step split in 4 slices
    x = block_lu_solve_scheduled_plain(ft.tree(), torch.as_tensor(b), bs=BS, n=n, ldx=256)
    assert x.shape == b.shape and x.dtype == torch.float64 and x.is_contiguous()
    x = x.numpy()
    x_pallas = np.asarray(pallas_block_lu_solve((fj.lu, fj.dinv), b, bs=BS, n=n))
    x_xla = np.asarray(block_lu_solve_j((fj.lu, fj.dinv), b, bs=BS, n=n))
    assert np.abs(x - x_pallas).max() <= 1e-12
    assert np.abs(x - x_xla).max() <= 1e-12
    res = a @ x.reshape(-1, n).T - b.reshape(-1, n).T
    assert np.linalg.norm(res) / np.linalg.norm(b) < 1e-12
