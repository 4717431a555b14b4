"""The port's multi-GPU layer against the JAX package's, on the CPU.

The port runs one process per rank over ``torch.distributed``; the JAX
package one program over a ``Mesh`` of the suite's virtual CPU devices.
One module-scoped world of 4 gloo ranks (spawned,
``flowcontrol_tpu_torch.parallel.launch.run_world``; each rank one thread,
its results pickled under ``tmp_path_factory``; the 2-rank checks on the
two space groups of a {batch 2, space 2} mesh) runs every port check once
(``tests/torch_sharding_ranks.py``), in a background thread while this
process computes the JAX package's answers; each test below then holds one
piece against them:

- ``mpi_compat`` inside the ranks (rank, size, broadcast, ``peval`` against
  the JAX package's on the same field, 1e-12);
- ``DofShardedOperator`` over 2 and 4 ranks on ``unit_square_mesh(12, 12)``
  against the JAX package's CSR (rtol 1e-10, atol 1e-12, as
  ``tests/test_dofsharding.py``), its memory scaling, the partition's tables
  bitwise the JAX package's ``DofPartition`` and its round trip;
- ``ShardedMultifrontal`` on the lid cavity at ``n_mesh=14`` (``leaf_max=250``:
  node- and row-mode stages) over 4 and 2 ranks, one and three right-hand
  sides: 1e-12 relative of the JAX package's multifrontal solve of the same
  system (``tests/test_mf_sharded.py`` holds the JAX package's sharded solve
  to that one at 1e-12; compiling the sharded one here would cost ~19 s of
  the suite's budget), ``per_device_factor_bytes`` and
  ``total_factor_bytes`` equal to those of the JAX package's
  ``ShardedMultifrontal`` over ``Mesh(4)`` and ``Mesh(2)``; and bitwise the
  port's single-rank per-stage sweep (the all_gather of disjoint slots sums
  nothing);
- ``shard_stepper`` on the lid cavity at ``n_mesh=12`` (f64,
  ``force_substructure``, 3 steps): x within 1e-10 relative and y rtol 1e-9
  of the JAX package's sharded step, the multifrontal kinds replaced by the
  sharded solve;
- the JAX dry run's {batch 2, space 2} legs (``__graft_entry__.py`` legs 2
  and 3: one step and a 3-step closed loop of 4 members on its small
  cylinder, f64, ``force_substructure``): 1e-10 of its unsharded baseline;
- the sharded demo (``flowcontrol_tpu_torch/examples/demo_sharded.py`` at
  ``n_mesh=12``, its GMRES leg at ``gmres_iters=10``: each Arnoldi step of
  the sharded leg makes five ``all_reduce`` calls): its base flow and dense
  leg within the JAX demo's 1e-9 of the JAX package's single-device steps,
  both legs within 1e-9 of the ranks' own single-rank steps (the JAX demo's
  check);
- one sharded GMRES step of a B = 4 lid-cavity batch (``n_mesh=12``, f64,
  unconverged: one cycle of 3 x 3 Arnoldi steps), over {batch 2, space 2}
  and over all-space, from the JAX demo's base flow (the JAX package's,
  handed to the ranks): within 1e-9 of the peak of the JAX package's
  unsharded B = 4 step on the same inputs, whose inner products span the
  batch, as the sharded legs' do over the batch group; each batch group's
  rows stepped as a batch of their own are ~4e-3 off it, so a batch group
  without its ``all_reduce`` fails;
- ``get_frequency_response_mpi`` (the ω list of 7 over 4 ranks) against
  the JAX package's ``get_frequency_response_sharded`` on a small dense
  system in complex128 (1e-10).
"""

import threading

import numpy as np
import pytest
from threadpoolctl import threadpool_limits

import jax
import jax.numpy as jnp
from jax.sharding import Mesh

import torch_sharding_ranks as ranks

from flowcontrol_tpu_torch.parallel.launch import run_world

N_MESH_MF = 14
REL_MF = 1e-12


def _rel(a, b) -> float:
    return float(np.linalg.norm(np.asarray(a) - np.asarray(b)) / np.linalg.norm(np.asarray(b)))


def _mesh(n_dev):
    return Mesh(np.array(jax.devices()[:n_dev]), ("space",))


@pytest.fixture(scope="module")
def lid_base(tmp_path_factory):
    """The JAX demo's lid cavity (``n_mesh=12``, f64, dense LU) with its base
    flow (Picard 4, Newton), initialized to step; and the GMRES legs' inputs
    made from them (the batch from its initial state): (U0, P0, the B = 4 batch, its controls)."""
    from flowcontrol_tpu.models.lidcavity import LidCavityFlowSolver

    with threadpool_limits(limits=1):
        fs = LidCavityFlowSolver.make_default(
            Re=500, num_steps=5, verbose=0, n_mesh=12, solver_backend="dense_lu",
            precision="f64", path_out=tmp_path_factory.mktemp("lid_base"))
        fs.compute_steady_state(u_ctrl=[0.0], method="picard", max_iter=4)
        fs.compute_steady_state(u_ctrl=[0.0], method="newton", initial_guess=fs.fields.UP0)
        fs.initialize_time_stepping()
    up, u = ranks.gmres_batch(np.concatenate([fs.fields.u_n.reshape(-1), fs.fields.p_n]))
    return fs, (fs.fields.U0.copy(), fs.fields.P0.copy(), up, u)


@pytest.fixture(scope="module")
def worlds(lid_base, tmp_path_factory):
    """The world, started at once in a background thread: a getter that
    waits for it and returns its ranks' results."""
    box = {}
    gmres_in = lid_base[1]

    def run():
        try:
            box["ranks"] = run_world(ranks.world4, 4, (gmres_in,), timeout_s=600,
                                     out_dir=str(tmp_path_factory.mktemp("world4")))
        except BaseException as e:  # re-raised by the getter
            box["error"] = e

    thread = threading.Thread(target=run, daemon=True)
    thread.start()

    def get():
        thread.join()
        if "error" in box:
            raise box["error"]
        return box["ranks"]

    return get


def _jax_mf(tmp):
    """The JAX package's sharded multifrontal solve on the lid cavity."""
    from flowcontrol_tpu.fem.assembly import to_scipy_csr
    from flowcontrol_tpu.models.lidcavity import LidCavityFlowSolver
    from flowcontrol_tpu.parallel.dofsharding import mixed_dof_coordinates
    from flowcontrol_tpu.parallel.mf_sharded import ShardedMultifrontal
    from flowcontrol_tpu.solvers.multifrontal import MultifrontalLU

    fs = LidCavityFlowSolver.make_default(Re=500, num_steps=1, verbose=0, n_mesh=N_MESH_MF,
                                          solver_backend="host_lu", precision="f64",
                                          path_out=tmp / "mf")
    fs.compute_steady_state(u_ctrl=[0.0], method="picard", max_iter=3)
    lhs = to_scipy_csr(fs.forms.transient_lhs(2, fs.fields.U0), fs.space.cell_dofs,
                       fs.space.n_dofs)
    a_bc, _ = fs._bcset_perturbation().eliminate_csr(lhs)
    mf = MultifrontalLU(a_bc, mixed_dof_coordinates(fs.space), leaf_max=250,
                        dtype=jnp.float64)
    rhs = np.random.default_rng(1).standard_normal((3, a_bc.shape[0]))
    bytes_ = {}
    for n in (4, 2):
        smf = ShardedMultifrontal(mf.tree(), mf.static(), _mesh(n))
        bytes_[n] = (smf.per_device_factor_bytes, smf.total_factor_bytes)
    return {"x": np.asarray(mf.solve(rhs)), "bytes": bytes_}


def _jax_stepper(tmp):
    """The JAX package's sharded lid-cavity step (test_mf_sharded.py)."""
    from flowcontrol_tpu.models.lidcavity import LidCavityFlowSolver
    from flowcontrol_tpu.parallel.sharding import shard_stepper

    fs = LidCavityFlowSolver.make_default(
        Re=500, num_steps=3, verbose=0, n_mesh=12, path_out=tmp / "stepper",
        solver_backend="dense_lu", precision="f64",
        stepper_options={"force_substructure": True},
    )
    fs.compute_steady_state(u_ctrl=[0.0], method="picard", max_iter=3)
    fs.initialize_time_stepping()
    fs.stepper
    shard_stepper(fs._stepper, _mesh(4), axis="space")
    for _ in range(3):
        y = fs.step(np.array([0.01]))
    return {"fs": fs, "x": np.asarray(fs.fields.up_), "y": y}


@pytest.fixture(scope="module")
def refs(worlds, lid_base, tmp_path_factory):
    """Every JAX answer, computed while the worlds run (the factor cache
    off, as the ranks have it)."""
    from flowcontrol_tpu.utils.linalg import get_frequency_response_sharded

    tmp = tmp_path_factory.mktemp("jax")
    mp = pytest.MonkeyPatch()
    mp.setenv("FLOWCONTROL_TPU_FACTOR_CACHE", "off")
    # one BLAS thread (the factorizations' dense algebra), as the ranks have:
    # the suite's workers and this file's ranks share the cores
    try:
        with threadpool_limits(limits=1):
            out = {"square": _jax_square(), "stepper": _jax_stepper(tmp), "mf": _jax_mf(tmp),
                   "dryrun": _jax_dryrun(tmp), "demo": _jax_demo(lid_base[0]),
                   "gmres": _jax_gmres(lid_base[1], tmp)}
    finally:
        mp.undo()
    a, b, c, q, ww = ranks.omega_system()
    out["omega"] = get_frequency_response_sharded(a, b, c, q, ww, dtype=np.complex128)
    return out


def test_torch_mpi_compat_in_ranks(worlds, refs):
    from flowcontrol_tpu.parallel.mpi_compat import peval

    w4 = worlds()
    for rank, r in enumerate(w4):
        assert r["mpi"] == (rank, 4, 7, rank)  # rank, size, rank 0's broadcast
        assert r["backend"] == "gloo"
    st = w4[0]["stepper"]
    want = peval(refs["stepper"]["fs"], st["x"], (0.5, 0.5), 0)
    assert abs(st["peval"] - want) <= 1e-12 * max(1.0, abs(want))


def _jax_square():
    from flowcontrol_tpu.fem.assembly import CellGeometry, mass_velocity_element, to_scipy_csr
    from flowcontrol_tpu.mesh.dofmap import TaylorHoodSpace
    from flowcontrol_tpu.mesh.generation import unit_square_mesh

    space = TaylorHoodSpace.build(unit_square_mesh(12, 12))
    a_e = np.asarray(mass_velocity_element(CellGeometry(space)))
    return space, to_scipy_csr(a_e, space.cell_dofs, space.n_dofs)


@pytest.mark.parametrize("n_dev", [2, 4])
def test_torch_dof_sharded_apply_matches_csr(worlds, refs, n_dev):
    space, a_csr = refs["square"]
    x = np.random.default_rng(0).standard_normal(space.n_dofs)
    for r in worlds():
        assert np.allclose(r["dof"][n_dev]["y"], a_csr @ x, rtol=1e-10, atol=1e-12)


def test_torch_dof_sharded_memory_scales_and_partition_matches_jax(worlds, refs):
    from flowcontrol_tpu.parallel.dofsharding import DofPartition

    space, _ = refs["square"]
    d2 = [r["dof"][2] for r in worlds()[:2]]  # ranks 0 and 1: one space group
    d4 = [r["dof"][4] for r in worlds()]
    # a rank's share of the operator halves (up to load imbalance), its
    # vector block halves, and it addresses a window of three blocks
    assert max(d["nbytes"] for d in d4) < 0.7 * max(d["nbytes"] for d in d2)
    assert d4[0]["n_loc"] <= -(-d2[0]["n_loc"] // 2) + 1
    assert all(d["window"] == 3 * d["n_loc"] for d in d2 + d4)
    assert sum(d["cells"] for d in d4) == sum(d["cells"] for d in d2) == space.mesh.num_cells
    for n_dev, ds in ((2, d2), (4, d4)):
        part = DofPartition.build(space, n_dev)
        for k in ("perm", "iperm", "cell_dev"):
            assert np.array_equal(ds[0]["part"][k], getattr(part, k)), k
    assert np.abs(d4[0]["roundtrip"]).max() == 0.0


def test_torch_sharded_multifrontal_matches_jax(worlds, refs):
    jax_mf = refs["mf"]
    x_j = jax_mf["x"]
    for r in worlds():
        for n_dev in (4, 2):
            s = r["smf"][n_dev]
            for i in range(x_j.shape[0]):  # normwise: entries span many magnitudes
                assert _rel(s["x"][i], x_j[i]) < REL_MF, (n_dev, i)
            assert _rel(s["x1"], x_j[0]) < REL_MF
            assert (s["per_device_factor_bytes"], s["total_factor_bytes"]) == jax_mf["bytes"][n_dev]
            assert s["per_device_factor_bytes"] * n_dev == s["total_factor_bytes"]
            assert s["held"] >= s["per_device_factor_bytes"]
    s0 = worlds()[0]["smf"]
    assert {"node", "row"} <= set(s0[4]["modes"])
    assert s0[4]["per_device_factor_bytes"] < 0.5 * s0["single_bytes"]


def test_torch_sharded_multifrontal_is_the_single_rank_sweep(worlds):
    """The pull-form inbox gives every contribution its own slot: the ranks'
    slices are gathered, never summed, so the sharded solve is the
    single-rank per-stage sweep, bitwise (on the CPU's plain kernels)."""
    for r in worlds():
        s = r["smf"]
        for n_dev in (4, 2):
            assert np.array_equal(s[n_dev]["x"], s["x_sweep"])
            assert np.array_equal(s[n_dev]["x1"], s["x_sweep1"])


def test_torch_shard_stepper_matches_jax(worlds, refs):
    jax_stepper = refs["stepper"]
    for r in worlds():
        st = r["stepper"]
        assert st["kinds"] == ["borrowed", "multifrontal"] or "multifrontal" in st["kinds"]
        assert st["sharded"] == [i for i, k in enumerate(st["kinds"]) if k == "multifrontal"]
        assert _rel(st["x"], jax_stepper["x"]) < 1e-10
        assert np.allclose(st["y"], jax_stepper["y"], rtol=1e-9, atol=1e-12)


def _jax_dryrun(tmp):
    """The JAX dry run's unsharded baseline for its legs 2 and 3."""
    import __graft_entry__ as graft

    fs = graft._build_small_cylinder(tiny=True, dtype=np.float64,
                                     stepper_options={"force_substructure": True})
    return graft._baseline_unsharded(fs, 4, jnp)


def test_torch_batch_space_closed_loop_matches_jax(worlds, refs):
    w4, jax_dryrun = worlds(), refs["dryrun"]
    legs = sorted((r["batch_space"] for r in w4 if r["batch_space"]["space_rank"] == 0),
                  key=lambda leg: leg["rows"])
    assert [leg["rows"] for leg in legs] == [(0, 2), (2, 4)]
    x = np.concatenate([leg["x_step"] for leg in legs])
    y = np.concatenate([leg["y_step"] for leg in legs])
    y_cl = np.concatenate([leg["y_cl"] for leg in legs], axis=1)
    assert _rel(x, jax_dryrun["x_step"]) < 1e-10
    assert np.allclose(y, jax_dryrun["y_step"], rtol=1e-10, atol=1e-14)
    assert y_cl.shape == jax_dryrun["y_cl"].shape
    assert np.allclose(y_cl, jax_dryrun["y_cl"], rtol=1e-10, atol=1e-14)
    for r in w4:
        leg = r["batch_space"]
        assert leg["per_device_factor_bytes"] * 2 == leg["total_factor_bytes"]
        twin = next(o["batch_space"] for o in w4 if o["batch_space"]["rows"] == leg["rows"])
        assert np.array_equal(leg["y_cl"], twin["y_cl"])  # both space ranks hold the rows


def _jax_demo(fs):
    """The JAX demo's single-device legs at n_mesh 12 (examples/demo_sharded.py)
    on the lid cavity of ``lid_base``."""
    st = fs.stepper
    step = jax.jit(st.step_fn())
    carry = st.init_carry(fs._carry.u_n)
    for _ in range(3):
        carry, _ = step(st._dev, carry, jnp.zeros(1))
    return {"x": np.asarray(carry.u_n), "u0": np.asarray(fs.fields.U0)}


def test_torch_demo_sharded_matches_jax(worlds, refs):
    jax_demo = refs["demo"]
    for r in worlds():
        d = r["demo"]
        assert d["ranks"] == 4 and d["backend"] == "gloo"
        assert d["err"] < 1e-9 and d["err_gmres"] < 1e-9  # the ranks' own check
        assert np.abs(d["u0"] - jax_demo["u0"]).max() < 1e-9
        assert np.abs(d["x"] - jax_demo["x"]).max() < 1e-9
        assert np.abs(d["x_gmres"] - d["x_gmres_ref"]).max() < 1e-9


def _jax_gmres(gmres_in, tmp):
    """The JAX package's unsharded GMRES step of the B = 4 batch (one
    system: its inner products span the batch)."""
    from flowcontrol_tpu.models.lidcavity import LidCavityFlowSolver

    u0, p0, up, u = gmres_in
    fs = LidCavityFlowSolver.make_default(Re=500, num_steps=5, verbose=0, n_mesh=12,
                                          path_out=tmp / "gmres", solver_backend="gmres",
                                          precision="f64",
                                          stepper_options=dict(ranks.GMRES_OPTIONS))
    fs._assign_steady_state(u0.copy(), p0.copy())
    fs.initialize_time_stepping()
    st = fs.stepper
    carry, _ = st.rollout_open_loop(st.init_carry(up), u[None])
    return np.asarray(carry.u_n)


def test_torch_sharded_gmres_step_matches_jax(worlds, refs):
    """{batch 2, space 2} and all-space against the JAX package's unsharded
    B = 4 GMRES step, 1e-9 of its peak (the demo's tolerance)."""
    x_j = refs["gmres"]
    peak = np.abs(x_j).max()
    w4 = worlds()
    legs = sorted((r["gmres"] for r in w4 if r["gmres"]["space_rank"] == 0),
                  key=lambda leg: leg["rows"])
    assert [leg["rows"] for leg in legs] == [(0, 2), (2, 4)]
    x_bs = np.concatenate([leg["x_bs"] for leg in legs])
    alone = np.concatenate([leg["x_alone"] for leg in legs])
    assert x_bs.shape == x_j.shape == (4, x_j.shape[1])
    assert np.abs(x_bs - x_j).max() <= 1e-9 * peak
    for r in w4:
        assert np.abs(r["gmres"]["x_space"] - x_j).max() <= 1e-9 * peak
        twin = next(o["gmres"] for o in w4 if o["gmres"]["rows"] == r["gmres"]["rows"])
        assert np.array_equal(r["gmres"]["x_bs"], twin["x_bs"])  # both space ranks hold the rows
    # the batch group's all_reduce matters: its rows alone are another answer
    assert np.abs(alone - x_j).max() > 1e-4 * peak


def test_torch_sharded_omega_sweep_matches_jax(worlds, refs):
    h_j, ww = refs["omega"], ranks.omega_system()[-1]
    for r in worlds():
        assert r["omega"].shape == h_j.shape == (len(ww), 3, 2)
        assert np.allclose(r["omega"], h_j, rtol=1e-10, atol=1e-14)
