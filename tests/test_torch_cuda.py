"""Tests of the PyTorch port that need an NVIDIA GPU (marker ``cuda``).

They skip without a CUDA device. This file imports neither JAX nor the JAX
package, so it also runs on a GPU machine without them:

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_cuda.py

- Kernel K1 (``csrc/nl_convection.cu``) against its plain torch version
  and its plain walk over the patch tables on the coarse cylinder and
  cavity meshes, batch 1, 4, 64 and 256: relative error <= 1e-5 (f32,
  different summation order), two calls bitwise equal, one counted launch
  per call, float32 only.
- The cylinder slice on the card (f32, dense LU, K1) against the port's own
  float64 CPU run from the same base flow: y within 5e-4 relative of the
  f64 run's peak and the 10-step field within 5e-4.
- The dense rule on the default cylinder (56,383 dofs): an 'auto' Stepper
  takes the dense LU, is dropped with its factorization left in PyTorch's
  cache (so that what ``mem_get_info`` reports free would not hold a second
  one), and a second 'auto' Stepper in the same process still takes it.
- The reference's f32 pin (``tests/integration/test_cylinder.py``
  ``test_cylinder_dense_f32_production_path_fast`` and
  ``tests/integration/test_cavity.py``
  ``test_cavity_dense_f32_production_path_fast``) on every solve path the
  port has on the card (dense, multifrontal, block): 4 actuated cylinder
  steps and 3 cavity steps on the reference's coarse meshes, against the
  port's float64 host-LU run on the CPU from the port's own f64 base flow:
  field error below 1e-4 relative, y within rtol 5e-4 and atol 1e-6.
- The same pin on the lid cavity (Re=1000, ``lidcavity_mesh(32)``, its
  pressure pin among the BC dofs, 3 steps with the lid moved) and the
  pinball (Re=30, the reference's coarse pinball mesh, 4 steps with the
  three cylinders turning), through the multifrontal path (F).
- Kernels K2 and P1 (``csrc/mf_sweep.cu``) against their plain torch
  versions at batch 1 and 4 (K2 also at 2 and 9, its other instances; at
  stage shapes that are multiples of 8 and one that is not; P1 on random
  tables of both forms, one deeper than a staged chunk, one ragged, one
  with pads past src's row): relative error <= 1e-5 (P1's gather form:
  bitwise), one counted launch per call; a CUDA tensor they do not take is
  refused. P1 ``torch.equal`` to the earlier per-segment kernel
  (``gather_sum_sub``) on every stage's inbox of the coarse cylinder's and
  a small cavity's factors, batch 9, 33, 64 and 256, one launch a stage; its
  gather form ``torch.equal`` to ``torch.index_select`` on the same int32
  tables (the entry and exit permutations, every boundary); the batched
  solve ``torch.equal`` to the earlier dataflow
  (``tests/mf_sweep_reference.py``) at batch 64 and 256, with exactly
  ``launches_per_solve()`` K2 and P1 launches. K2's wide instance (the tiled
  product) at batch 9, 64, 100 and 256, on stage shapes with p or q = 8,
  widths that are not a multiple of its 64-wide tiles and a 1,528 front,
  through strided v and out: also bitwise repeatable, and writing nothing
  outside out.
- Kernel K3 (``csrc/block_trisolve.cu``) against its plain torch version
  ``block_lu_solve`` and its schedule's plain walk on a ``BlockLU`` factor
  built on the card, at sizes that pad (n % bs != 0) and that do not,
  block sizes 16 to 256 and 44 block rows (bs = 16), batch 1 (the GEMV
  instance), 3, 8, 64, 100 and 256 (the persistent panel instance, ragged
  and at the batched paths' width) and a (2, 3) batch: relative error
  <= 1e-5, residual <= 1e-5, two calls bitwise equal, exact launch counts
  (3 nb - 2 per solve at batch 1, one for a panel), float64 refused.
- Kernel F (``csrc/mf_fused.cu``) against its plain torch version
  ``multifrontal_solve_fused_plain`` and against the per-stage K2/P1 sweep
  on a small cavity factor built on the card (f32, 3,486 dofs), rows 1, 3,
  4 and 8: relative error <= 1e-5, two calls bitwise equal, one counted
  launch per solve; ``MultifrontalLU.solve`` takes F up to
  ``FUSED_MAX_ROWS`` rows and the per-stage sweep past that; F refuses 9
  rows. On a factor of 39 stages (the half-million-dof cylinder's graded
  mesh at density 4, small leaves and a cheap stage price; 60 grid syncs),
  rows 1 and 8: bitwise the per-stage sweep, within 1e-5 of the plain
  version. F's shared memory at 8 rows within the card's opt-in there,
  and a request past it (``max_front`` raised on a copy) refused with
  ``ValueError`` before any launch.
- P2, P3 and P4 (the same source) at the probe's shapes and at one other:
  bitwise equal to their plain versions, one counted launch per call.
- Kernel S (``csrc/csr_spmm.cu``, the batched step's sparse products)
  against its plain version (cuSPARSE's product) on the coarse cylinder's
  mass matrix, f32 and f64, batch 1, 3, 64 and 256: relative error <= 1e-5
  (f32) or 1e-12 (f64), two calls bitwise equal, one counted launch per
  call. A matrix gets its tile plan on its first batched product: none
  after ``csr_to_device`` or single-stream steps, and a first product
  inside a CUDA graph capture raises. The tiled kernel ``torch.equal`` to
  the row-wise reference kernel
  (the order it keeps), f32 and f64, batch 2, 3, 33, 64 and 256, on the
  coarse cylinder's mass and BDF2 operator and on matrices whose dense row
  forces a tile to be cut (or, past the column budget, takes a tile of its
  own), through a row-major and a column-major x; one
  counted launch per call and, in a profiler window of one call, one
  kernel and no copy. ``csr_residual`` ``torch.equal`` to its composition
  ``(b.double() - csr_matmul(a, x.double())).to(float32)`` on the same
  matrices and widths, one counted launch per call.
- The compiled entry points as CUDA graphs, on every path (dense,
  multifrontal through F at B = 1 and through K2/P1 at B = 256, block
  through K3 at B = 1 and 256, the cavity's multifrontal at B = 1 and 64,
  the lid cavity's and the pinball's multifrontal at B = 1):
  ``compiled_step`` bitwise equal to ``Stepper.step`` step by step, its
  graph holding the path's kernels, each replay adding exactly the
  eager step's launches, a held carry keeping its values; 20-step
  ``make_rollout_open_loop`` and ``make_rollout_closed_loop`` bitwise
  equal to the eager loops; a graph of K1 over 100 replays bitwise equal
  to the eager call; a body that cannot be captured raises. The f32 pin
  runs through ``compiled_step``'s graph. The pinball's MIMO closed loop
  with the committed 22-state 3 x 3 LQG (u = +K(y)), 6 graphed steps at
  B = 2 (F) and B = 64 (K2, P1), bitwise equal to the eager loop. A
  restarted cylinder (``start_order=2``, from a sidecar) on the
  multifrontal path: one system, and ``compiled_step`` and
  ``make_rollout_closed_loop`` from the restart carry bitwise equal to the
  eager step, every step launching K1 once and F twice (no borrowed
  sweep).
- The controller search (``examples/synthesize_controller.py``
  ``lqg_population_cost``, ``utils/optim_algs.py``): the coarse cylinder's
  B = 256 closed-loop graph run with one set of controllers, then replayed
  with another, bitwise equal to the eager loop with the second set; a
  2-generation, popsize-16 search over the LQG weights of a reduced model
  of the coarse cylinder on the card (f32, K2, P1, S) against the same
  search on the CPU in f64: every cost within rtol 5e-4, the same elites
  and ``res.x``; ``utils/profiling.py`` ``device_memory_stats`` on the card.
- The analysis path's device functions (``utils/linalg.py``) on a sparse
  400-dof descriptor system with a singular E: ``eig_arnoldi_dense_device``
  on the card in complex64 against the same function on the CPU in
  complex128 (leading eigenvalue within 1e-2, ``tests/test_linalg.py``'s
  tolerance) and ``get_frequency_response_device`` the same way (2e-4
  relative), the refined answer and the unrefined one (``stats``). Without
  a card both raise rather than run on the CPU (a CPU test, unmarked).
- The Krylov backend: the JAX package's GMRES fixture (the lid cavity at
  ``n_mesh=12``, Re=500, 5 steps) on the card (an f32 step, its Krylov
  solve in f64) against the port's f64 GMRES on the CPU: field and y
  within 5e-4.
- The factor cache: a small cavity's factor built cold on the card, then
  streamed back from its derived entry: every device array and the F and
  sweep solves bitwise equal; the same factor built on the CPU and
  streamed to the card, bitwise a card build's. The knobs ``inbox='full'``,
  ``FC_MF_PACK=bucket`` and ``trim=False``: F (rows 1, 8) and the sweep
  (B = 64) within 1e-5 of F's plain walk.
- Multi-GPU (``parallel/``, worlds spawned from
  ``tests/torch_sharding_ranks.py``): two gloo ranks sharing the card, the
  sharded multifrontal solve through K2 and P1 against the single-rank
  sweep and the sharded N(u) through K1 against K1 on the whole mesh; a
  world of 1 over NCCL through ``shard_stepper`` against the unsharded
  steps.
"""

import numpy as np
import pytest
import torch

from flowcontrol_tpu_torch.fem.assembly import CellGeometry, to_scipy_csr
from flowcontrol_tpu_torch.mesh.dofmap import TaylorHoodSpace
from flowcontrol_tpu_torch.core.actuator import CYLINDER_ACTUATION_MODE
from flowcontrol_tpu_torch.mesh.generation import (
    cavity_mesh,
    cylinder_mesh,
    lidcavity_mesh,
    pinball_mesh,
)
from flowcontrol_tpu_torch.models.cavity import CavityFlowSolver
from flowcontrol_tpu_torch.models.cylinder import CylinderFlowSolver
from flowcontrol_tpu_torch.models.lidcavity import LidCavityFlowSolver
from flowcontrol_tpu_torch.models.pinball import PINBALL_LQG_RE100, PinballFlowSolver
from flowcontrol_tpu_torch.ops import mf_fused
from flowcontrol_tpu_torch.ops.mf_matvec import (
    GatherPlan,
    gather_descriptors,
    gather_sum_sub,
    stack_matvec,
    stack_matvec_plain,
    sweep_gather,
    sweep_gather_plain,
)
from flowcontrol_tpu_torch.core.stepper import Stepper
from flowcontrol_tpu_torch.ops.nl import (
    NLTables,
    nonlinear_convection,
    nonlinear_convection_patches_plain,
    nonlinear_convection_plain,
)
from flowcontrol_tpu_torch.ops.spmm import csr_matmul, csr_residual
from flowcontrol_tpu_torch.ops.trisolve import (
    block_lu_solve_fused,
    block_lu_solve_scheduled_plain,
    launches_per_solve,
)
from flowcontrol_tpu_torch.parallel.dofsharding import mixed_dof_coordinates
from flowcontrol_tpu_torch.solvers.block_lu import BlockLU, block_lu_solve
from flowcontrol_tpu_torch.solvers.direct import DeviceDenseLU
from flowcontrol_tpu_torch.solvers.multifrontal import MultifrontalLU, multifrontal_solve
from mf_sweep_reference import multifrontal_solve_reference

COARSE = dict(yinf=5.0, xinf=15.0, xinfa=-5.0, n1=4.0, n2=2.0, n3=0.8, segments=80)
# the reference's coarse meshes (tests/integration/conftest.py and, for the
# lid cavity, tests/integration/test_lidcavity.py)
MESHES = {"cylinder": lambda: cylinder_mesh(**COARSE),
          "cavity": lambda: cavity_mesh(n_coarse=12, n_mid=25, n_fine=50)}
NEW_MESHES = {"lidcavity": lambda: lidcavity_mesh(32),
              "pinball": lambda: pinball_mesh(n1=4.0, n2=2.0, n3=0.8, segments=60, xinf=14.0)}
# each flow's solver, the Reynolds number of its coarse tests and its
# make_default keywords
FLOWS = {"cylinder": (CylinderFlowSolver, 100, {}), "cavity": (CavityFlowSolver, 7500, {}),
         "lidcavity": (LidCavityFlowSolver, 1000, {}),
         "pinball": (PinballFlowSolver, 30,
                     {"mode_actuation": CYLINDER_ACTUATION_MODE.ROTATION})}


@pytest.fixture(scope="module", autouse=True)
def _factor_cache_off():
    """The port's multifrontal factors here are built cold and stored
    nowhere: the factor cache is off for the module (its own tests are in
    tests/test_torch_factor_cache.py)."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("FLOWCONTROL_TPU_FACTOR_CACHE", "off")
        yield


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (NVIDIA GPU)")
    return torch.device("cuda", 0)


@pytest.mark.cuda
@pytest.mark.parametrize("batch", [1, 4, 64, 256])
@pytest.mark.parametrize("mesh", sorted(MESHES))
def test_torch_cuda_k1_matches_plain(cuda, mesh, batch):
    space = TaylorHoodSpace.build(MESHES[mesh]())
    tables = NLTables.build(CellGeometry(space), space, cuda, torch.float32)
    u = torch.as_tensor(
        np.random.default_rng(batch).standard_normal((batch, space.n_dofs)),
        dtype=torch.float32, device=cuda,
    )
    before = nonlinear_convection.launches
    got = nonlinear_convection(tables, u)
    again = nonlinear_convection(tables, u)
    ref = nonlinear_convection_plain(tables, u)
    walk = nonlinear_convection_patches_plain(tables, u)
    torch.cuda.synchronize()
    assert nonlinear_convection.launches == before + 2
    assert got.shape == u.shape
    assert torch.equal(got, again)  # fixed-order sums: bitwise repeatable
    assert bool((got[:, 2 * space.n_vnodes:] == 0).all())  # pressure rows
    for want in (ref, walk):
        assert float((got - want).abs().max() / want.abs().max()) <= 1e-5
    with pytest.raises(TypeError):
        nonlinear_convection(tables, u.double())


@pytest.mark.cuda
def test_torch_cuda_cylinder_f32_against_cpu_f64(cuda, tmp_path):
    mesh = cylinder_mesh(**COARSE)
    ref = CylinderFlowSolver.make_default(
        Re=100, mesh=mesh, path_out=tmp_path, device="cpu", precision="f64",
        solver_backend="dense_lu",
    )
    ref.compute_steady_state(u_ctrl=[0.0, 0.0], method="picard", max_iter=3)
    ref.compute_steady_state(u_ctrl=[0.0, 0.0], method="newton",
                             initial_guess=ref.fields.UP0, max_iter=10)
    gpu = CylinderFlowSolver.make_default(Re=100, mesh=mesh, path_out=tmp_path, device="cuda")
    gpu._assign_steady_state(ref.fields.U0, ref.fields.P0)
    runs = []
    for fs in (ref, gpu):
        fs.initialize_time_stepping()
        runs.append(np.asarray([fs.step(np.array([0.2, -0.1])) for _ in range(10)]))
    assert gpu.stepper.dtype == torch.float32 and gpu.stepper.device.type == "cuda"
    y64, y32 = runs
    assert np.abs(y32 - y64).max() <= 5e-4 * np.abs(y64).max()
    err = np.linalg.norm(gpu.fields.up_ - ref.fields.up_) / np.linalg.norm(ref.fields.up_)
    assert err <= 5e-4


@pytest.mark.cuda
def test_torch_cuda_dense_rule_counts_cached_blocks(cuda, tmp_path):
    """A dropped dense Stepper leaves its f64 factorization's blocks in
    PyTorch's cache; the dense rule counts them, so a second 'auto' Stepper
    of the default cylinder in the same process still takes the dense LU."""
    import gc

    from flowcontrol_tpu_torch.core.stepper import dense_lu_max_dofs_device

    gc.collect()
    torch.cuda.empty_cache()
    kinds = []
    for _ in range(2):
        fs = CylinderFlowSolver.make_default(Re=100, path_out=tmp_path, device="cuda")
        n = fs.space.n_dofs
        fs._assign_steady_state(np.zeros((fs.space.n_vnodes, 2)),
                                np.zeros(fs.space.n_pressure_dofs))
        fs.initialize_time_stepping()
        kinds.append(list(fs.stepper._solver_kinds))
        del fs
        gc.collect()
        if len(kinds) == 1:  # the cache alone must decide
            free, _ = torch.cuda.mem_get_info(cuda)
            assert int((0.9 * free / 16) ** 0.5) < n <= dense_lu_max_dofs_device(cuda)
    assert n == 56_383
    assert all("multifrontal" not in k for k in kinds), kinds


# the card's solve paths: the default dense LU, the multifrontal solve and
# the blocked LU solved by K3
PATHS = {"dense": {}, "multifrontal": {"force_substructure": True}, "block": {"trisolve": "cuda"}}
SOLVERS = {"dense": DeviceDenseLU, "multifrontal": MultifrontalLU, "block": BlockLU}


@pytest.fixture(scope="module")
def pin_base_flows(tmp_path_factory):
    """The reference's coarse base flows, computed by the port in float64 on
    the CPU with the reference's recipes (cylinder: Picard 3 + Newton 10;
    cavity: Picard 10 to 1e-7 + Newton 10; lid cavity at Re=1000 and pinball
    at Re=30: Picard 5 + Newton 15, tests/integration/test_lidcavity.py and
    test_pinball.py), or None without a card (the tests that use it skip
    first)."""
    if not torch.cuda.is_available():
        return None
    out = {}
    for name, picard, newton in (
        ("cylinder", dict(max_iter=3), 10),
        ("cavity", dict(max_iter=10, tol=1e-7), 10),
        ("lidcavity", dict(max_iter=5), 15),
        ("pinball", dict(max_iter=5), 15),
    ):
        cls, re, kw = FLOWS[name]
        mesh = {**MESHES, **NEW_MESHES}[name]()
        fs = cls.make_default(Re=re, mesh=mesh, device="cpu", precision="f64",
                              solver_backend="host_lu", path_out=tmp_path_factory.mktemp(name),
                              **kw)
        u = [0.0] * fs.params_control.actuator_number
        fs.compute_steady_state(u_ctrl=u, method="picard", **picard)
        fs.compute_steady_state(u_ctrl=u, method="newton", initial_guess=fs.fields.UP0,
                                max_iter=newton)
        out[name] = (mesh, fs.fields.U0.copy(), fs.fields.P0.copy())
    return out


# each flow's f32 pin case: steps and control (the reference's production
# cases for the cylinder and the cavity; the lid moved, the front cylinder
# turning)
PIN_CASES = {"cylinder": (4, [0.3, -0.2]), "cavity": (3, [0.0]), "lidcavity": (3, [0.05]),
             "pinball": (4, [0.3, -0.2, 0.1])}


def _pin_run(name, base, tmp_path, **kw):
    """The reference's production case: cylinder Re=100, 4 steps with u =
    [0.3, -0.2]; cavity Re=7500, 3 steps with u = [0]; and the lid cavity's
    (Re=1000, 3 steps, u = [0.05]) and the pinball's (Re=30, 4 steps, u =
    [0.3, -0.2, 0.1]). Returns (y of every step, final mixed state, the
    solver)."""
    mesh, u0, p0 = base
    cls, re, flow_kw = FLOWS[name]
    steps, u = PIN_CASES[name]
    u = np.asarray(u)
    fs = cls.make_default(Re=re, mesh=mesh, num_steps=steps, path_out=tmp_path, **flow_kw,
                          **kw)
    fs._assign_steady_state(u0, p0)
    fs.initialize_time_stepping()
    ys = np.asarray([fs.step(u) for _ in range(steps)])
    return ys, np.asarray(fs.fields.up_, dtype=float), fs


@pytest.mark.cuda
@pytest.mark.parametrize("path", sorted(PATHS))
@pytest.mark.parametrize("name", ["cylinder", "cavity"])
def test_torch_cuda_f32_pin(cuda, pin_base_flows, name, path, tmp_path, monkeypatch):
    """The reference's f32 pin on one of the card's solve paths: field error
    below 1e-4 relative and y within rtol 5e-4, atol 1e-6 of the port's
    float64 host-LU run (the reference compares every y of the cylinder and
    the last y of the cavity)."""
    base = pin_base_flows[name]
    if path == "block":
        # the block kind engages above LAPACK_LU_MAX_N dofs; the coarse
        # cylinder has 7,889, so the threshold is lowered for this test
        # (the Stepper reads it while it is built)
        monkeypatch.setattr(Stepper, "LAPACK_LU_MAX_N", 4096)
    y_ref, x_ref, _ = _pin_run(name, base, tmp_path / "f64", device="cpu", precision="f64",
                               solver_backend="host_lu")
    y_32, x_32, fs = _pin_run(name, base, tmp_path / "f32", device="cuda",
                              stepper_options=PATHS[path])
    st = fs.stepper
    assert st.device.type == "cuda" and st.dtype == torch.float32
    assert isinstance(st._solvers[-1], SOLVERS[path])
    rel = np.linalg.norm(x_32 - x_ref) / np.linalg.norm(x_ref)
    nv2 = 2 * fs.space.n_vnodes  # the velocity dofs, then the pressure's

    def part(s):
        return np.linalg.norm((x_32 - x_ref)[s]) / np.linalg.norm(x_ref[s])

    measured = (f"field {rel:.3e}: velocity {part(slice(nv2)):.3e}, pressure "
                f"{part(slice(nv2, None)):.3e}; y max|f32 - f64| {np.abs(y_32 - y_ref).max():.3e}")
    print(f"f32 pin {name} {path} (refinement sweeps {st._refine}): {measured}")
    # the steps after the first ran through compiled_step's CUDA graph
    assert fs._step_compiled == st._graphed_step
    assert [p.replays for p in st._programs.values()] == [len(y_32) - 2]
    assert rel < 1e-4, measured
    if name == "cylinder":
        assert np.allclose(y_32, y_ref, rtol=5e-4, atol=1e-6), np.abs(y_32 - y_ref).max()
    else:
        assert np.allclose(y_32[-1], y_ref[-1], rtol=5e-4, atol=1e-6), (y_32[-1], y_ref[-1])


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["lidcavity", "pinball"])
def test_torch_cuda_f32_pin_new_flows(cuda, pin_base_flows, name, tmp_path):
    """The reference's f32 pin on the lid cavity (with its pressure pin) and
    the pinball, through the multifrontal path (F): field error below 1e-4
    relative and every y within rtol 5e-4, atol 1e-6 of the port's float64
    host-LU run."""
    y_ref, x_ref, _ = _pin_run(name, pin_base_flows[name], tmp_path / "f64", device="cpu",
                               precision="f64", solver_backend="host_lu")
    y_32, x_32, fs = _pin_run(name, pin_base_flows[name], tmp_path / "f32", device="cuda",
                              stepper_options=PATHS["multifrontal"])
    st = fs.stepper
    assert st.dtype == torch.float32 and isinstance(st._solvers[-1], MultifrontalLU)
    assert st._solvers[-1].takes_fused(1)
    if name == "lidcavity":
        assert 2 * fs.space.n_vnodes in st.bcs.dofs  # the pressure pin
    rel = np.linalg.norm(x_32 - x_ref) / np.linalg.norm(x_ref)
    print(f"f32 pin {name} multifrontal (refinement sweeps {st._refine}): field {rel:.3e}; y "
          f"max|f32 - f64| {np.abs(y_32 - y_ref).max():.3e}")
    assert fs._step_compiled == st._graphed_step
    assert rel < 1e-4
    assert np.allclose(y_32, y_ref, rtol=5e-4, atol=1e-6), np.abs(y_32 - y_ref).max()


@pytest.mark.cuda
@pytest.mark.parametrize("batch", [1, 2, 4, 9])
@pytest.mark.parametrize("m,p,q", [(6, 280, 744), (1, 1488, 1024), (3, 8, 216), (2, 37, 13)])
def test_torch_cuda_k2_matches_plain(cuda, batch, m, p, q):
    rng = np.random.default_rng(m * p + q)
    a = torch.as_tensor(rng.standard_normal((m, p, q)), dtype=torch.float32, device=cuda)
    # v as the sweep passes it: a strided row view of a wider work vector
    x = torch.as_tensor(rng.standard_normal((batch, m * q + 9)), dtype=torch.float32,
                        device=cuda)
    v = x[:, 4: 4 + m * q].view(batch, m, q)
    before = stack_matvec.launches
    got = stack_matvec(a, v)
    ref = stack_matvec_plain(a, v)
    torch.cuda.synchronize()
    assert stack_matvec.launches == before + 1
    assert got.shape == (batch, m, p)
    assert float((got - ref).abs().max() / ref.abs().max()) <= 1e-5
    with pytest.raises(ValueError):
        stack_matvec(a.double(), v.double())


@pytest.mark.cuda
@pytest.mark.parametrize("batch", [9, 64, 100, 256])
@pytest.mark.parametrize("m,p,q", [(6, 280, 744), (1, 1528, 1528), (3, 8, 216), (5, 216, 8),
                                   (2, 37, 13), (40, 24, 40)])
def test_torch_cuda_k2_wide_matches_plain(cuda, batch, m, p, q):
    """The tiled product past 8 right-hand sides, on strided v and out as
    the sweep passes them (xe a row slice of the work vector, out a slice
    of the contribution buffer): rows 16-byte aligned, as the sweep lays
    them out (16-byte copies), and not (4-byte copies)."""
    rng = np.random.default_rng(batch * 7 + m * p + q)
    a = torch.as_tensor(rng.standard_normal((m, p, q)), dtype=torch.float32, device=cuda)
    for pad in (12, 9):  # a row stride of m q + 12 keeps rows aligned when q % 4 == 0
        x = torch.as_tensor(rng.standard_normal((batch, m * q + pad)), dtype=torch.float32,
                            device=cuda)
        v = x[:, 4: 4 + m * q].view(batch, m, q)
        buf = torch.full((batch, m * p + 7), 7.0, dtype=torch.float32, device=cuda)
        out = buf[:, 1: 1 + m * p].view(batch, m, p)
        ref = stack_matvec_plain(a, v)
        before = stack_matvec.launches
        got = stack_matvec(a, v, out=out)
        again = stack_matvec(a, v)
        torch.cuda.synchronize()
        assert stack_matvec.launches == before + 2
        assert got.data_ptr() == out.data_ptr() and again.shape == (batch, m, p)
        assert torch.equal(got, again)  # one fixed order over q: bitwise repeatable
        assert float((got - ref).abs().max() / ref.abs().max()) <= 1e-5
        # nothing written outside out
        assert bool((buf[:, 0] == 7.0).all()) and bool((buf[:, 1 + m * p:] == 7.0).all())


def _plan(segs, flat, sub, device):
    """A P1 plan over ``segs`` ((out column, w, kmax, table offset) each) of
    the flat int32 table ``flat`` on ``device``."""
    rows, tiles = gather_descriptors(segs)
    return GatherPlan(desc=torch.as_tensor(rows, device=device), tables=flat, segs=tuple(segs),
                      sub=sub, n_tiles=tiles)


@pytest.mark.cuda
@pytest.mark.parametrize("batch", [1, 4])
def test_torch_cuda_p1_matches_plain(cuda, batch):
    """P1 on random tables: the inbox form over three segments (kmax 5,
    70 (three staged chunks) and 2; widths 700, 96 and a ragged 45 whose
    table rows are not 16-byte aligned) in place, and the gather form with
    pads past src's row."""
    rng = np.random.default_rng(batch)
    n_buf = 3001
    buf = torch.as_tensor(rng.standard_normal((batch, n_buf)), dtype=torch.float32, device=cuda)
    buf[:, 0] = 0.0
    segs, o, t_off = [], 0, 0
    for kmax, w in ((5, 700), (70, 96), (2, 45)):
        segs.append((o, w, kmax, t_off))
        o, t_off = o + w + 3, t_off + kmax * w
    flat = torch.as_tensor(rng.integers(0, n_buf, t_off), dtype=torch.int32, device=cuda)
    plan = _plan(segs, flat, True, cuda)
    x = torch.as_tensor(rng.standard_normal((batch, plan.width + 5)), dtype=torch.float32,
                        device=cuda)
    ref = sweep_gather_plain(plan, buf, xe=x, out=x.clone())
    got = x.clone()
    before = sweep_gather.launches
    sweep_gather(plan, buf, xe=got, out=got)
    torch.cuda.synchronize()
    assert sweep_gather.launches == before + 1
    assert float((got - ref).abs().max() / ref.abs().max()) <= 1e-5
    for lo, hi in ((700, 703), (799, 802), (plan.width, plan.width + 5)):  # between segments
        assert torch.equal(got[:, lo: hi], x[:, lo: hi])
    # the gather form: indices up to n_buf + 9, those past the row read 0
    table = torch.as_tensor(rng.integers(0, n_buf + 10, 777), dtype=torch.int32, device=cuda)
    gplan = _plan([(0, 777, 1, 0)], table, False, cuda)
    got = sweep_gather(gplan, buf)
    padded = torch.nn.functional.pad(buf, (0, 10))
    assert torch.equal(got, padded[:, table.long()]) and sweep_gather.launches == before + 2
    with pytest.raises(ValueError):
        sweep_gather(gplan, buf.double())
    with pytest.raises(ValueError):
        sweep_gather(plan, buf)  # the inbox form takes xe


@pytest.fixture(scope="module")
def sweep_factors(tmp_path_factory):
    """{flow: f32 multifrontal factor on the card}: the coarse cylinder's
    BDF2 matrix (leaf_max 700) and a small cavity's (leaf_max 300), around
    the default initial guess; None without a card."""
    if not torch.cuda.is_available():
        return None
    out = {}
    for name, cls, mesh, leaf in (
            ("cylinder", CylinderFlowSolver, MESHES["cylinder"](), 700),
            ("cavity", CavityFlowSolver, cavity_mesh(n_coarse=4, n_mid=8, n_fine=16), 300)):
        fs = cls.make_default(mesh=mesh, device="cpu", path_out=tmp_path_factory.mktemp(name))
        lhs = fs.forms.transient_lhs(2, fs._default_steady_state_initial_guess())
        a_bc, _ = fs._bcset_perturbation().eliminate_csr(
            to_scipy_csr(lhs, fs.space.cell_dofs, fs.space.n_dofs))
        out[name] = MultifrontalLU(a_bc, mixed_dof_coordinates(fs.space),
                                   torch.device("cuda", 0), dtype=torch.float32, leaf_max=leaf)
    return out


@pytest.mark.cuda
@pytest.mark.parametrize("batch", [9, 33, 64, 256])
@pytest.mark.parametrize("flow", ["cylinder", "cavity"])
def test_torch_cuda_p1_equals_segment_kernel(cuda, sweep_factors, flow, batch):
    """Every stage's inbox in one P1 launch, in place on a work vector,
    torch.equal to the earlier kernel launched once per segment."""
    mf = sweep_factors[flow]
    rng = np.random.default_rng(batch)
    buf = torch.as_tensor(rng.standard_normal((batch, 1 + mf.total_contrib)),
                          dtype=torch.float32, device=cuda)
    buf[:, 0] = 0.0
    x = torch.as_tensor(rng.standard_normal((batch, mf.work_slots)), dtype=torch.float32,
                        device=cuda)
    got, want = x.clone(), x.clone()
    n_stages = 0
    for st in mf.stages:
        if st.p1_inbox is None:
            continue
        n_stages += 1
        xe = got[:, st.off: st.off + st.m * st.e]
        before = sweep_gather.launches
        sweep_gather(st.p1_inbox, buf, xe=xe, out=xe)
        assert sweep_gather.launches == before + 1
        for i, (o, w, _, _) in enumerate(st.p1_inbox.segs):
            seg = want[:, st.off + o: st.off + o + w]
            gather_sum_sub(buf, st.inbox[i], seg, out=seg)
    torch.cuda.synchronize()
    assert n_stages > 1 and torch.equal(got, want)


@pytest.mark.cuda
@pytest.mark.parametrize("batch", [9, 33, 64, 256])
@pytest.mark.parametrize("flow", ["cylinder", "cavity"])
def test_torch_cuda_p1_gather_matches_index_select(cuda, sweep_factors, flow, batch):
    """P1's gather form torch.equal to torch.index_select on the same int32
    tables: the entry permutation (its pads read b's appended zero), every
    stage's boundary and the exit permutation."""
    mf = sweep_factors[flow]
    rng = np.random.default_rng(batch + 1)
    bb = torch.as_tensor(rng.standard_normal((batch, mf.n)), dtype=torch.float32, device=cuda)
    x = torch.as_tensor(rng.standard_normal((batch, mf.work_slots)), dtype=torch.float32,
                        device=cuda)
    pairs = [(sweep_gather(mf.p1_entry, bb),
              torch.index_select(torch.nn.functional.pad(bb, (0, 1)), 1, mf.perm32)),
             (sweep_gather(mf.p1_exit, x), torch.index_select(x, 1, mf.ipos32))]
    pairs += [(sweep_gather(st.p1_bd, x), torch.index_select(x, 1, st.bd32.reshape(-1)))
              for st in mf.stages]
    torch.cuda.synchronize()
    for got, want in pairs:
        assert torch.equal(got, want)


@pytest.mark.cuda
@pytest.mark.parametrize("batch", [64, 256])
@pytest.mark.parametrize("flow", ["cylinder", "cavity"])
def test_torch_cuda_sweep_equals_earlier_dataflow(cuda, sweep_factors, flow, batch):
    """The batched solve torch.equal to the earlier dataflow (one P1 per
    inbox segment, torch's index kernels, the copy of z), with exactly the
    K2 and P1 launches ``launches_per_solve`` gives."""
    mf = sweep_factors[flow]
    b = torch.as_tensor(np.random.default_rng(batch).standard_normal((batch, mf.n)),
                        dtype=torch.float32, device=cuda)
    before = (stack_matvec.launches, sweep_gather.launches)
    got = multifrontal_solve(mf, b)
    counts = (stack_matvec.launches - before[0], sweep_gather.launches - before[1])
    want = multifrontal_solve_reference(mf, b)
    torch.cuda.synchronize()
    assert counts == mf.launches_per_solve()
    assert torch.equal(got, want) and bool(torch.isfinite(got).all())
    assert torch.equal(mf.solve(b), got)  # the factor's own route past FUSED_MAX_ROWS


@pytest.mark.cuda
@pytest.mark.parametrize("batch", [(), (3,), (8,), (2, 3), (64,), (100,), (256,)],
                         ids=["1", "3", "8", "2x3", "64", "100", "256"])
@pytest.mark.parametrize("n,bs", [(300, 128), (256, 64), (1000, 256), (50, 16), (700, 16)])
def test_torch_cuda_k3_matches_plain(cuda, n, bs, batch):
    """(700, 16) has 44 block rows: the persistent panel launch walks ~2,000
    items whose waits chain through every block row."""
    rng = np.random.default_rng(n + bs)
    a = np.eye(n) * 30 + 0.3 * rng.standard_normal((n, n))
    f = BlockLU(a, bs=bs, dtype=torch.float64, store_dtype=torch.float32, device=cuda)
    assert f.lu.dtype == torch.float32 and f.n_pad % bs == 0
    b = torch.as_tensor(rng.standard_normal(batch + (n,)), dtype=torch.float32, device=cuda)
    per_solve = launches_per_solve(f.nb, int(np.prod(batch, dtype=int)))
    assert per_solve == (3 * f.nb - 2 if batch == () else 1)
    before = block_lu_solve_fused.launches
    got = block_lu_solve_fused(f.tree(), b, bs=bs, n=n)
    again = block_lu_solve_fused(f.tree(), b, bs=bs, n=n)
    ref = block_lu_solve(f.tree(), b, bs=bs, n=n)
    walk = block_lu_solve_scheduled_plain(f.tree(), b, bs=bs, n=n)
    torch.cuda.synchronize()
    assert block_lu_solve_fused.launches == before + 2 * per_solve
    # the factor's own solve goes through the kernel too, never the plain version
    assert torch.equal(f.solve(b), got)
    assert block_lu_solve_fused.launches == before + 3 * per_solve
    assert got.shape == b.shape and got.is_contiguous()
    assert torch.equal(got, again)  # fixed-order sums: bitwise repeatable
    for want in (ref, walk):
        assert float((got - want).abs().max() / want.abs().max()) <= 1e-5
    res = torch.as_tensor(a, device=cuda) @ got.double().reshape(-1, n).T - b.double().reshape(
        -1, n).T
    assert float(res.norm() / b.double().norm()) <= 1e-5
    with pytest.raises(TypeError):
        block_lu_solve_fused(f.tree(), b.double(), bs=bs, n=n)
    with pytest.raises(ValueError):
        block_lu_solve_fused(f.tree(), b[..., :-1], bs=bs, n=n)


@pytest.fixture(scope="module")
def cavity_factor(tmp_path_factory):
    """A small cavity's BDF2 multifrontal factor on the card (f32), or None
    without a card (the tests that use it skip first)."""
    if not torch.cuda.is_available():
        return None
    fs = CavityFlowSolver.make_default(mesh=cavity_mesh(n_coarse=4, n_mid=8, n_fine=16),
                                       device="cpu", path_out=tmp_path_factory.mktemp("cav"))
    lhs = fs.forms.transient_lhs(2, fs._default_steady_state_initial_guess())
    a_bc, _ = fs._bcset_perturbation().eliminate_csr(
        to_scipy_csr(lhs, fs.space.cell_dofs, fs.space.n_dofs))
    return MultifrontalLU(a_bc, mixed_dof_coordinates(fs.space), torch.device("cuda", 0),
                          dtype=torch.float32, leaf_max=300)


@pytest.mark.cuda
@pytest.mark.parametrize("rows", [1, 3, 4, 8])
def test_torch_cuda_f_matches_plain(cuda, cavity_factor, rows):
    mf = cavity_factor
    b = torch.as_tensor(np.random.default_rng(rows).standard_normal((rows, mf.n)),
                        dtype=torch.float32, device=cuda)
    f = mf_fused.multifrontal_solve_fused
    before = f.launches
    got = f(mf, b)
    again = f(mf, b)
    ref = mf_fused.multifrontal_solve_fused_plain(mf, b)
    sweep = multifrontal_solve(mf, b)
    torch.cuda.synchronize()
    assert f.launches == before + 2
    assert got.shape == b.shape and got.dtype == torch.float32
    assert torch.equal(got, again)  # fixed-order sums: bitwise repeatable
    assert float((got - ref).abs().max() / ref.abs().max()) <= 1e-5
    assert float((got - sweep).abs().max() / sweep.abs().max()) <= 1e-5
    # the factor's own solve routes by width: F up to FUSED_MAX_ROWS rows
    assert mf.takes_fused(rows)
    assert torch.equal(mf.solve(b), got) and f.launches == before + 3
    assert torch.equal(mf.solve(b[0]), f(mf, b[0]))


@pytest.mark.cuda
def test_torch_cuda_f_width_limit(cuda, cavity_factor):
    mf = cavity_factor
    b = torch.ones((9, mf.n), dtype=torch.float32, device=cuda)
    before = (mf_fused.multifrontal_solve_fused.launches, stack_matvec.launches)
    x = mf.solve(b)  # past FUSED_MAX_ROWS: the per-stage sweep
    torch.cuda.synchronize()
    assert mf_fused.multifrontal_solve_fused.launches == before[0]
    assert stack_matvec.launches > before[1] and bool(torch.isfinite(x).all())
    with pytest.raises(ValueError):
        mf_fused.multifrontal_solve_fused(mf, b)
    with pytest.raises(TypeError):
        mf_fused.multifrontal_solve_fused(mf, b[:1].to(torch.float16))


@pytest.mark.cuda
@pytest.mark.parametrize("n,w,s", [(1024, 128, (640, 256)), (5000, 1000, (3999, 17))])
def test_torch_cuda_p2_p3_p4_match_plain(cuda, n, w, s):
    rng = np.random.default_rng(n)
    v = torch.as_tensor(rng.standard_normal(n), dtype=torch.float32, device=cuda)
    v2 = torch.as_tensor(rng.standard_normal((8, n)), dtype=torch.float32, device=cuda)
    lanes = torch.as_tensor(rng.integers(0, n, (8, w)), dtype=torch.int32, device=cuda)
    s_ds, s_acc = (torch.tensor([o], dtype=torch.int32, device=cuda) for o in s)
    calls = (  # (kernel, its arguments (made anew for each call), plain version)
        (mf_fused.take_along_axis_lanes, lambda: (v2, lanes),
         mf_fused.take_along_axis_lanes_plain),
        (mf_fused.dynamic_slice, lambda: (v, s_ds, w), mf_fused.dynamic_slice_plain),
        (mf_fused.dynamic_offset_accum_store, lambda: (v.clone(), s_acc, v[:w]),
         mf_fused.dynamic_offset_accum_store_plain),  # in place on its copy of v
    )
    for kern, args, plain in calls:
        before = kern.launches
        got = kern(*args())
        ref = plain(*args())
        torch.cuda.synchronize()
        assert kern.launches == before + 1
        assert torch.equal(got, ref), kern.__name__


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("batch", [1, 3, 64, 256])
def test_torch_cuda_s_matches_plain(cuda, dtype, batch):
    """Kernel S (csrc/csr_spmm.cu) against its plain version (cuSPARSE's
    product) on the coarse cylinder's mass matrix: relative error <= 1e-5
    (f32) or 1e-12 (f64), two calls bitwise equal, one counted launch per
    call; mixed dtypes refused."""
    from flowcontrol_tpu_torch.core.stepper import csr_to_device
    from flowcontrol_tpu_torch.ops.spmm import csr_matmul, csr_matmul_plain

    fs = CylinderFlowSolver.make_default(mesh=cylinder_mesh(**COARSE), device="cpu")
    a = csr_to_device(to_scipy_csr(fs.forms.mass_elements(), fs.space.cell_dofs,
                                   fs.space.n_dofs), cuda, dtype)
    x = torch.as_tensor(np.random.default_rng(batch).standard_normal((batch, fs.space.n_dofs)),
                        dtype=dtype, device=cuda)
    before = csr_matmul.launches
    got = csr_matmul(a, x)
    again = csr_matmul(a, x)
    ref = csr_matmul_plain(a, x)
    torch.cuda.synchronize()
    assert csr_matmul.launches == before + 2
    assert got.shape == x.shape and got.dtype == dtype and got.is_contiguous()
    assert torch.equal(got, again)  # fixed-order sums: bitwise repeatable
    tol = 1e-5 if dtype == torch.float32 else 1e-12
    assert float((got - ref).abs().max() / ref.abs().max()) <= tol
    with pytest.raises(TypeError):
        csr_matmul(a, x.to(torch.float16))


@pytest.fixture(scope="module")
def s_matrices():
    """S's test matrices (scipy CSR): the coarse cylinder's mass and BDF2
    operator (a seeded base flow), and random 1,000 x 3,000 matrices, ~8
    nonzeros a row, whose row 300 holds 100 distinct columns ("split": its
    tile overflows the plan's column budget and is cut) or 200
    ("split_alone": past the budget, the row takes a tile of its own)."""
    import scipy.sparse as sp

    fs = CylinderFlowSolver.make_default(mesh=cylinder_mesh(**COARSE), device="cpu")
    space = fs.space
    u0 = np.random.default_rng(0).standard_normal((space.n_vnodes, 2))

    def split(dense):
        rng = np.random.default_rng(1)
        a = sp.random(1000, 3000, density=8 / 3000, format="lil", random_state=rng)
        a[300, rng.choice(3000, dense, replace=False)] = rng.standard_normal(dense)
        a = a.tocsr()
        a.sort_indices()
        return a

    return {"mass": to_scipy_csr(fs.forms.mass_elements(), space.cell_dofs, space.n_dofs),
            "operator": to_scipy_csr(fs.forms.transient_lhs(2, u0), space.cell_dofs,
                                     space.n_dofs),
            "split": split(100), "split_alone": split(200)}


def _s_matrix(s_matrices, which, device, dtype):
    """One of S's test matrices on the card with its plan; "split_alone"'s
    dense row holds a tile of its own, past the column budget."""
    from flowcontrol_tpu_torch.core.stepper import csr_to_device
    from flowcontrol_tpu_torch.ops.spmm import TILE_COLS, plan_of

    a = csr_to_device(s_matrices[which], device, dtype)
    plan_of(a)
    if which == "split_alone":
        row0 = a.spmm_plan.tile_row0.cpu().tolist()
        assert 300 in row0 and row0[row0.index(300) + 1] == 301
        assert a.spmm_plan.max_cols > TILE_COLS
    return a


@pytest.mark.cuda
@pytest.mark.parametrize("batch", [2, 3, 33, 64, 256])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("which", ["mass", "operator", "split", "split_alone"])
def test_torch_cuda_s_matches_rowwise(cuda, s_matrices, which, dtype, batch):
    """The tiled S against the earlier row-wise kernel, the order it keeps:
    torch.equal, through a row-major and a column-major x; two calls
    bitwise equal; one counted launch per call; within 1e-5 (f32) or 1e-12
    (f64) of cuSPARSE's product."""
    from flowcontrol_tpu_torch.ops.spmm import csr_matmul_plain, csr_matmul_rowwise

    a = _s_matrix(s_matrices, which, cuda, dtype)
    if which == "split":
        rows = torch.diff(a.spmm_plan.tile_row0).cpu()
        assert bool((rows[:-1] < 64).any())  # the dense row's tile was cut
    x = torch.as_tensor(np.random.default_rng(batch).standard_normal((batch, a.shape[1])),
                        dtype=dtype, device=cuda)
    x_cm = x.T.contiguous().T  # column-major: strides (1, batch)
    before = csr_matmul.launches
    got, again, got_cm = csr_matmul(a, x), csr_matmul(a, x), csr_matmul(a, x_cm)
    ref, plain = csr_matmul_rowwise(a, x), csr_matmul_plain(a, x)
    torch.cuda.synchronize()
    assert csr_matmul.launches == before + 3
    assert got.shape == (batch, a.shape[0]) and got.dtype == dtype and got.is_contiguous()
    assert torch.equal(got, ref) and torch.equal(got, again) and torch.equal(got_cm, ref)
    tol = 1e-5 if dtype == torch.float32 else 1e-12
    assert float((got - plain).abs().max() / plain.abs().max()) <= tol


@pytest.mark.cuda
@pytest.mark.parametrize("batch", [2, 3, 33, 64, 256])
@pytest.mark.parametrize("which", ["mass", "operator", "split", "split_alone"])
def test_torch_cuda_s_residual_matches_composition(cuda, s_matrices, which, batch):
    """csr_residual in one launch against the composition it fuses:
    torch.equal, with x and b row-major and column-major; f32 operands
    refused for the matrix."""
    a = _s_matrix(s_matrices, which, cuda, torch.float64)
    rng = np.random.default_rng(batch)
    x = torch.as_tensor(rng.standard_normal((batch, a.shape[1])), dtype=torch.float32,
                        device=cuda)
    b = torch.as_tensor(rng.standard_normal((batch, a.shape[0])), dtype=torch.float32,
                        device=cuda)
    before = csr_residual.launches
    got = csr_residual(a, b, x)
    got_cm = csr_residual(a, b.T.contiguous().T, x.T.contiguous().T)
    want = (b.double() - csr_matmul(a, x.double())).to(torch.float32)
    torch.cuda.synchronize()
    assert csr_residual.launches == before + 2
    assert got.dtype == torch.float32 and torch.equal(got, want) and torch.equal(got_cm, want)
    with pytest.raises(TypeError):
        csr_residual(a.to(torch.float32), b, x)


@pytest.mark.cuda
def test_torch_cuda_s_one_kernel_no_copy(cuda, s_matrices):
    """A profiler window of one S call (the mass at B = 256) and one
    residual holds one kernel each and no copy."""
    from torch.profiler import ProfilerActivity, profile

    from flowcontrol_tpu_torch.core.stepper import csr_to_device

    m = csr_to_device(s_matrices["mass"], cuda, torch.float32)
    a = csr_to_device(s_matrices["operator"], cuda, torch.float64)
    x = torch.randn((256, m.shape[1]), device=cuda)
    b = torch.randn((256, a.shape[0]), device=cuda)
    for call in (lambda: csr_matmul(m, x), lambda: csr_residual(a, b, x)):
        call()
        torch.cuda.synchronize()
        # after CUDA graphs ran in the process the profiler now and then
        # hands back a window with no device record at all: up to three
        # windows, as chip_smoke.py's device_ms takes
        for _ in range(3):
            with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
                call()
                torch.cuda.synchronize()
            kernels = [e for e in prof.events() if str(e.device_type).endswith("CUDA")]
            if kernels:
                break
        names = [e.name for e in kernels]
        assert len(kernels) == 1 and "csr_spmm_tiled_kernel" in names[0], names
        assert not any("copy" in n.lower() or "memcpy" in n.lower() for n in names), names


@pytest.mark.cuda
def test_torch_cuda_s_plan_on_first_product(cuda, s_matrices, pin_base_flows, tmp_path):
    """A matrix on the card gets S's tile plan on its first batched product:
    none after csr_to_device; a first product inside a CUDA graph capture
    raises; the eager one builds it. A single-stream Stepper builds none in
    its steps, and its first batched steps build the mass's and the BDF2
    refinement operator's."""
    from flowcontrol_tpu_torch.core.stepper import csr_to_device
    from flowcontrol_tpu_torch.ops.spmm import csr_matmul_rowwise

    a = csr_to_device(s_matrices["mass"], cuda, torch.float32)
    x = torch.randn((64, a.shape[1]), device=cuda)
    assert not hasattr(a, "spmm_plan")
    graph = torch.cuda.CUDAGraph()
    with pytest.raises(RuntimeError, match="tile plan"):
        with torch.cuda.graph(graph):
            csr_matmul(a, x)
    assert not hasattr(a, "spmm_plan")
    got = csr_matmul(a, x)
    assert hasattr(a, "spmm_plan") and torch.equal(got, csr_matmul_rowwise(a, x))

    mesh, u0, p0 = pin_base_flows["cylinder"]
    fs = CylinderFlowSolver.make_default(mesh=mesh, path_out=tmp_path, device="cuda",
                                         stepper_options=PATHS["multifrontal"])
    fs._assign_steady_state(u0, p0)
    fs.initialize_time_stepping()
    st = fs.stepper
    for _ in range(3):
        fs.step(np.array([0.1, -0.1]))
    mats = {"m": st._dev["m"], "a_refine": st._dev["a_refine"][st._order_idx[2]]}
    assert not any(hasattr(m, "spmm_plan") for m in mats.values())
    c = st.init_carry(fs._carry.u_n.expand(4, -1).contiguous())
    for _ in range(2):  # the BDF1 step, then a BDF2 step
        c, _ = st.step(c, torch.zeros((4, st.n_act), dtype=st.dtype, device=cuda))
    assert all(hasattr(m, "spmm_plan") for m in mats.values())


# ── The compiled entry points as CUDA graphs ─────────────────────────────────

# (flow, solve path, batch): every path's captured step on the reference's
# coarse meshes, at the main paths' widths (the cavity's multifrontal factor
# taken with force_substructure; its generated default mesh is past the
# dense range)
GRAPH_CASES = [("cylinder", "dense", 1), ("cylinder", "multifrontal", 1),
               ("cylinder", "multifrontal", 256), ("cylinder", "block", 1),
               ("cylinder", "block", 256), ("cavity", "multifrontal", 1),
               ("cavity", "multifrontal", 64), ("lidcavity", "multifrontal", 1),
               ("pinball", "multifrontal", 1)]
GRAPH_STEPS = 6
CARRY_FIELDS = ("u_n", "u_nn", "mu_n", "mu_nn", "n_prev", "u_ctrl_prev")


def _graph_kernels(path, batch):
    """The counted kernels a captured step of ``path`` at ``batch`` holds."""
    solve = {"dense": set(), "block": {block_lu_solve_fused},
             "multifrontal": ({mf_fused.multifrontal_solve_fused} if batch <= 8
                              else {stack_matvec, sweep_gather})}[path]
    spmm = {csr_matmul, csr_residual} if batch > 1 else set()  # the mass, the residual
    return {nonlinear_convection} | solve | spmm


def _graph_case(pin_base_flows, name, path, batch, tmp_path, monkeypatch):
    """A Stepper on the card for one case, a seeded batch of states near
    the base flow and seeded controls for 20 steps."""
    if path == "block":
        monkeypatch.setattr(Stepper, "LAPACK_LU_MAX_N", 4096)
    mesh, u0, p0 = pin_base_flows[name]
    cls, re, flow_kw = FLOWS[name]
    fs = cls.make_default(Re=re, mesh=mesh, path_out=tmp_path, device="cuda",
                          stepper_options=PATHS[path], **flow_kw)
    fs._assign_steady_state(u0, p0)
    fs.initialize_time_stepping()
    st = fs.stepper
    assert isinstance(st._solvers[-1], SOLVERS[path]) and st.dtype == torch.float32
    rng = np.random.default_rng(batch)
    lead = () if batch == 1 else (batch,)
    up = fs._carry.u_n.double().cpu().numpy() + 1e-3 * rng.standard_normal(lead + (fs.space.n_dofs,))
    us = 0.1 * rng.standard_normal((20,) + lead + (st.n_act,))
    return st, up, us


def _same(got, want, path):
    """Bitwise, or on the dense path within 1e-6 relative (cuBLAS may take
    another algorithm under capture); returns which held."""
    if torch.equal(got, want):
        return "bitwise"
    assert path == "dense", f"replay differs from the eager step on the {path} path"
    rel = float((got.double() - want.double()).abs().max() / want.double().abs().max())
    assert rel <= 1e-6, rel
    return f"within {rel:.1e}"


@pytest.mark.cuda
@pytest.mark.parametrize("name,path,batch", GRAPH_CASES)
def test_torch_cuda_graph_step_matches_eager(cuda, pin_base_flows, name, path, batch,
                                             tmp_path, monkeypatch):
    """compiled_step against Stepper.step from one carry: the first step
    eager in both, then the captured step (warm-up, then replays): every
    output and carry field bitwise equal (the dense path: or within 1e-6);
    the graph holds the path's kernels, each replay adds exactly the
    launches the eager step makes, and a carry the caller holds keeps its
    values."""
    from flowcontrol_tpu_torch.ops.cuda_build import COUNTED

    st, up, us = _graph_case(pin_base_flows, name, path, batch, tmp_path, monkeypatch)
    eager, c = [], st.init_carry(up)
    for k in range(GRAPH_STEPS):
        before = [fn.launches for fn in COUNTED]
        c, out = st.step(c, us[k])
        eager.append((c, out))
    eager_counts = {fn: fn.launches - b for fn, b in zip(COUNTED, before) if fn.launches != b}
    step = st.compiled_step()
    c = st.init_carry(up)
    held = verdicts = None
    for k in range(GRAPH_STEPS):
        if k == 2:
            before = [fn.launches for fn in COUNTED]
            verdicts = set()
        c, out = step(c, us[k])
        ce, oe = eager[k]
        for got, want in [(out.y, oe.y), (out.dE, oe.dE), (out.x, oe.x),
                          *((getattr(c, f), getattr(ce, f)) for f in CARRY_FIELDS)]:
            v = _same(got, want, path)
            if verdicts is not None:
                verdicts.add(v)
        assert torch.equal(out.diverged, oe.diverged) and c.it == ce.it == k + 1
        if k == 1:
            held = (c, [getattr(c, f).clone() for f in CARRY_FIELDS])
    torch.cuda.synchronize()
    progs = [p for p in st._programs.values() if p.graph is not None]
    assert len(progs) == 1 and progs[0].replays == GRAPH_STEPS - 2
    prog = progs[0]
    assert set(prog.counts) >= _graph_kernels(path, batch), prog.counts
    assert prog.counts == eager_counts
    for fn, b in zip(COUNTED, before):
        assert fn.launches - b == (GRAPH_STEPS - 2) * prog.counts.get(fn, 0), fn.__name__
    for f, v in zip(CARRY_FIELDS, held[1]):
        assert torch.equal(getattr(held[0], f), v), f
    print(f"graph step {name} {path} B={batch}: replays against the eager step: "
          f"{sorted(verdicts)}; launches per replay "
          f"{ {fn.__name__: k for fn, k in prog.counts.items()} }; pool {prog.pool_bytes} bytes")


def _mats(st, batch, device):
    rng = np.random.default_rng(7)
    lead = () if batch == 1 else (batch,)
    mats = (0.9 * np.eye(2) + 0.05 * rng.standard_normal(lead + (2, 2)),
            0.1 * rng.standard_normal(lead + (2, st.ns)),
            0.2 * rng.standard_normal(lead + (st.n_act, 2)),
            0.05 * rng.standard_normal(lead + (st.n_act, st.ns)))
    return [torch.as_tensor(m, dtype=st.dtype, device=device) for m in mats]


@pytest.mark.cuda
@pytest.mark.parametrize("loop", ["open", "closed"])
@pytest.mark.parametrize("name,path,batch", GRAPH_CASES)
def test_torch_cuda_graph_rollout_matches_eager(cuda, pin_base_flows, name, path, batch, loop,
                                                tmp_path, monkeypatch):
    """A 20-step graphed rollout (make_rollout_open_loop, or
    make_rollout_closed_loop with a seeded controller, stacked over the
    batch) against the eager loop of Stepper.step and the controller's
    products: y, dE (u) and the final carry bitwise (the dense path: or
    within 1e-6)."""
    st, up, us = _graph_case(pin_base_flows, name, path, batch, tmp_path, monkeypatch)
    c = st.init_carry(up)
    ys, des, uu = [], [], []
    if loop == "open":
        for u in us:
            c, out = st.step(c, u)
            ys.append(out.y)
            des.append(out.dE)
        carry, outs = st.make_rollout_open_loop()(st.init_carry(up), us)
        got = [(outs.y, torch.stack(ys)), (outs.dE, torch.stack(des))]
    else:
        ad, bd, cd, dd = _mats(st, batch, cuda)
        y0 = torch.as_tensor(up, dtype=st.dtype, device=cuda) @ st._dev["c"].T
        xk, y = torch.zeros(ad.shape[:-1], dtype=st.dtype, device=cuda), y0

        def mv(a, v):
            return torch.einsum("...ij,...j->...i", a, v)

        for _ in range(20):
            fb = -y
            u = mv(cd, xk) + mv(dd, fb)
            xk = mv(ad, xk) + mv(bd, fb)
            c, out = st.step(c, u)
            y = out.y
            ys.append(y)
            des.append(out.dE)
            uu.append(u)
        carry, (ys_g, des_g, us_g, _) = st.make_rollout_closed_loop(20)(
            st.init_carry(up), (ad, bd, cd, dd), y0)
        got = [(ys_g, torch.stack(ys)), (des_g, torch.stack(des)), (us_g, torch.stack(uu))]
    verdicts = {_same(g, w, path) for g, w in got}
    verdicts |= {_same(getattr(carry, f), getattr(c, f), path) for f in CARRY_FIELDS}
    assert carry.it == c.it == 20
    print(f"graph rollout ({loop}) {name} {path} B={batch}: {sorted(verdicts)}")


def _launches_per_step(run, steps):
    """Runs ``run()`` and returns the K1 and F launches it made, divided by
    ``steps``."""
    before = (nonlinear_convection.launches, mf_fused.multifrontal_solve_fused.launches)
    out = run()
    return out, ((nonlinear_convection.launches - before[0]) / steps,
                 (mf_fused.multifrontal_solve_fused.launches - before[1]) / steps)


@pytest.mark.cuda
def test_torch_cuda_restart_graph_matches_eager(cuda, pin_base_flows, tmp_path, monkeypatch):
    """A restarted cylinder (start_order=2: a 2-step run with a checkpoint
    every step, then a solver restarted from its sidecar after step 1) on
    the multifrontal path, with the two-factor size lowered so that the run
    from rest borrows its first step: the restart builds one system and no
    borrowed operator. From the restart carry (it = 0), compiled_step and
    make_rollout_closed_loop against the eager Stepper.step: y, dE, u, x
    and every carry field bitwise equal, and every step, eager, warm-up or
    replayed, launches K1 once and F twice (the solve and its refinement
    sweep): no borrowed sweep."""
    monkeypatch.setattr(Stepper, "DENSE_TWO_FACTOR_MAX_N", 1000)
    mesh, u0, p0 = pin_base_flows["cylinder"]
    opts = dict(Re=100, mesh=mesh, path_out=tmp_path, device="cuda",
                stepper_options=PATHS["multifrontal"])
    fs = CylinderFlowSolver.make_default(num_steps=2, save_every=1, **opts)
    fs._assign_steady_state(u0, p0)
    fs.initialize_time_stepping()
    for _ in range(2):
        fs.step(np.array([0.3, -0.2]))
    assert fs.stepper._solver_kinds == ["borrowed", "multifrontal"]
    dt = fs.params_time.dt
    fs2 = CylinderFlowSolver.make_default(num_steps=GRAPH_STEPS, Tstart=dt, **opts)
    fs2._assign_steady_state(u0, p0)
    fs2.initialize_time_stepping(Tstart=dt)
    st = fs2.stepper
    assert fs2.order == 2 and st._solver_kinds == ["multifrontal"] and not st._dev["a_bc"]
    carry0 = fs2._carry
    us = 0.1 * np.random.default_rng(0).standard_normal((GRAPH_STEPS, st.n_act))
    eager, c = [], carry0
    for u in us:
        (c, out), per = _launches_per_step(lambda: st.step(c, u), 1)
        assert per == (1, 2)
        eager.append((c, out))
    step, c = st.compiled_step(), carry0
    for k, u in enumerate(us):
        (c, out), per = _launches_per_step(lambda: step(c, u), 1)
        assert per == (1, 2), k
        ce, oe = eager[k]
        for got, want in [(out.y, oe.y), (out.dE, oe.dE), (out.x, oe.x),
                          *((getattr(c, f), getattr(ce, f)) for f in CARRY_FIELDS)]:
            assert torch.equal(got, want), k
    ad, bd, cd, dd = _mats(st, 1, cuda)
    y0 = carry0.u_n @ st._dev["c"].T
    xk, y, ys, uu, c = torch.zeros(ad.shape[:-1], dtype=st.dtype, device=cuda), y0, [], [], carry0

    def mv(a, v):
        return torch.einsum("...ij,...j->...i", a, v)

    for _ in range(GRAPH_STEPS):
        fb = -y
        u = mv(cd, xk) + mv(dd, fb)
        xk = mv(ad, xk) + mv(bd, fb)
        c, out = st.step(c, u)
        y = out.y
        ys.append(y)
        uu.append(u)
    roll = st.make_rollout_closed_loop(GRAPH_STEPS)
    for _ in range(2):  # the first rollout captures, the second replays
        (carry, (ys_g, _, us_g, _)), per = _launches_per_step(
            lambda: roll(carry0, (ad, bd, cd, dd), y0), GRAPH_STEPS)
        assert per == (1, 2)
        assert torch.equal(ys_g, torch.stack(ys)) and torch.equal(us_g, torch.stack(uu))
        for f in CARRY_FIELDS:
            assert torch.equal(getattr(carry, f), getattr(c, f)), f
    # the step: steps 3.. replayed; the rollouts: their second and later
    # steps, less the first rollout's capture
    assert [p.replays for p in st._programs.values()] == [GRAPH_STEPS - 2, 2 * GRAPH_STEPS - 3]


@pytest.mark.cuda
def test_torch_cuda_graph_k1_replays(cuda):
    """A CUDA graph of one K1 launch (its self-resetting arrival counters
    captured): 100 replays on changing inputs, each bitwise equal to the
    eager call, with eager calls of another width (another set of
    counters) in between; one counted launch per replay."""
    from flowcontrol_tpu_torch.core.graphs import Program

    space = TaylorHoodSpace.build(MESHES["cylinder"]())
    tables = NLTables.build(CellGeometry(space), space, cuda, torch.float32)
    rng = np.random.default_rng(11)
    inputs = torch.as_tensor(rng.standard_normal((5, 1, space.n_dofs)), dtype=torch.float32,
                             device=cuda)
    wide = torch.as_tensor(rng.standard_normal((64, space.n_dofs)), dtype=torch.float32,
                           device=cuda)
    u = inputs[0].clone()
    prog = Program(lambda: nonlinear_convection(tables, u), cuda)
    prog.run()
    for i in range(100):
        u.copy_(inputs[i % 5])
        before = nonlinear_convection.launches
        got = prog.run().clone()
        assert nonlinear_convection.launches == before + 1
        assert torch.equal(got, nonlinear_convection(tables, inputs[i % 5])), i
        if i % 10 == 0:
            nonlinear_convection(tables, wide)
    assert prog.replays == 100 and prog.counts == {nonlinear_convection: 1}


@pytest.mark.cuda
def test_torch_cuda_graph_capture_failure_raises(cuda):
    """A body that cannot be captured (it copies to the host) raises: no
    program falls back to running its body eagerly."""
    from flowcontrol_tpu_torch.core.graphs import Program

    x = torch.ones(8, device=cuda)
    prog = Program(lambda: float(x.sum()), cuda)
    with pytest.raises(RuntimeError):
        prog.run()
    assert prog.graph is None


@pytest.mark.cuda
@pytest.mark.parametrize("batch", [2, 64])
def test_torch_cuda_graph_lqg_closed_loop_matches_eager(cuda, pin_base_flows, batch, tmp_path,
                                                        monkeypatch):
    """The pinball's MIMO closed loop as a graph: the committed 22-state
    3 x 3 LQG (u = +K(y), feedback_sign=+1), its output scaled by a gain per
    member, 6 steps of make_rollout_closed_loop (the compensator, designed
    for the stock mesh, drives u up ~4.5x a step on this one) against the
    eager loop of Stepper.step and the controller's products: y, dE, u and
    the final carry bitwise. B = 2 goes through F, B = 64 through K2 and
    P1."""
    from flowcontrol_tpu_torch.core.controller import Controller

    st, up, _ = _graph_case(pin_base_flows, "pinball", "multifrontal", batch, tmp_path,
                            monkeypatch)
    k = Controller.from_file(PINBALL_LQG_RE100)
    gains = torch.linspace(0.5, 1.5, batch, dtype=st.dtype, device=cuda)
    ad, bd, cd, dd = (torch.as_tensor(m, dtype=st.dtype, device=cuda)
                      for m in k.discrete(0.005, dtype=np.float32))
    mats = (ad.expand(batch, -1, -1), bd.expand(batch, -1, -1),
            gains[:, None, None] * cd, gains[:, None, None] * dd)
    y0 = torch.as_tensor(up, dtype=st.dtype, device=cuda) @ st._dev["c"].T
    c, y, xk = st.init_carry(up), y0, torch.zeros((batch, k.nstates), dtype=st.dtype,
                                                  device=cuda)
    ys, des, uu = [], [], []

    def mv(a, v):
        return torch.einsum("...ij,...j->...i", a, v)

    for _ in range(6):
        u = mv(mats[2], xk) + mv(mats[3], y)
        xk = mv(mats[0], xk) + mv(mats[1], y)
        c, out = st.step(c, u)
        y = out.y
        ys.append(y)
        des.append(out.dE)
        uu.append(u)
    carry, (ys_g, des_g, us_g, _) = st.make_rollout_closed_loop(6, feedback_sign=1.0)(
        st.init_carry(up), mats, y0)
    for got, want in [(ys_g, torch.stack(ys)), (des_g, torch.stack(des)),
                      (us_g, torch.stack(uu))] + [(getattr(carry, f), getattr(c, f))
                                                  for f in CARRY_FIELDS]:
        assert torch.equal(got, want)
    assert carry.it == c.it == 6 and float((us_g[:, 0] - us_g[:, -1]).abs().max()) > 0


# ── The controller search ───────────────────────────────────────────────────


@pytest.mark.cuda
def test_torch_cuda_graph_closed_loop_new_controllers(cuda, pin_base_flows, tmp_path,
                                                      monkeypatch):
    """The B = 256 closed-loop graph (coarse cylinder, multifrontal: K2, P1,
    S) run with one set of controllers, then replayed with another: the
    replay bitwise equal to the eager loop of Stepper.step with the second
    set (the rollout copies its inputs into its fixed buffers on every
    call)."""
    st, up, _ = _graph_case(pin_base_flows, "cylinder", "multifrontal", 256, tmp_path,
                            monkeypatch)
    first = _mats(st, 256, cuda)
    second = [first[0], first[1], 1.5 * first[2], -0.5 * first[3]]
    y0 = torch.as_tensor(up, dtype=st.dtype, device=cuda) @ st._dev["c"].T
    roll = st.make_rollout_closed_loop(20)
    _, (ys1, _, _, _) = roll(st.init_carry(up), first, y0)
    carry, (ys_g, des_g, us_g, _) = roll(st.init_carry(up), second, y0)
    progs = [p for p in st._programs.values() if p.graph is not None]
    # 19 graph runs a call; the first call's first run is the warm-up and capture
    assert len(progs) == 1 and progs[0].replays == 2 * 19 - 1
    c, y, xk = st.init_carry(up), y0, torch.zeros(second[0].shape[:-1], dtype=st.dtype,
                                                  device=cuda)
    ys, des, uu = [], [], []

    def mv(a, v):
        return torch.einsum("...ij,...j->...i", a, v)

    for _ in range(20):
        u = mv(second[2], xk) + mv(second[3], -y)
        xk = mv(second[0], xk) + mv(second[1], -y)
        c, out = st.step(c, u)
        y = out.y
        ys.append(y)
        des.append(out.dE)
        uu.append(u)
    for got, want in [(ys_g, torch.stack(ys)), (des_g, torch.stack(des)),
                      (us_g, torch.stack(uu))] + [(getattr(carry, f), getattr(c, f))
                                                  for f in CARRY_FIELDS]:
        assert torch.equal(got, want)
    assert float((ys1 - ys_g).abs().max()) > 0


@pytest.mark.cuda
def test_torch_cuda_population_search_matches_cpu(cuda, pin_base_flows, tmp_path):
    """A 2-generation search, popsize 16, 30 steps: lqg_population_cost over
    a reduced model of the coarse cylinder (modal_rom, two eigenpairs at
    0.1 + 0.8j, from the CPU solver's operators), on the card (f32,
    force_substructure: K2, P1, S) and on the CPU (f64, host LU) from the
    same initial condition: every cost within rtol 5e-4, the same elites,
    and res.x equal."""
    from flowcontrol_tpu_torch.core.operatorgetter import OperatorGetter
    from flowcontrol_tpu_torch.examples.synthesize_controller import lqg_population_cost
    from flowcontrol_tpu_torch.utils.linalg import modal_rom
    from flowcontrol_tpu_torch.utils.optim_algs import minimize

    mesh, u0, p0 = pin_base_flows["cylinder"]
    pop, steps = 16, 30

    def solver(device, **kw):
        fs = CylinderFlowSolver.make_default(Re=100, mesh=mesh, num_steps=steps, device=device,
                                             path_out=tmp_path / str(device), **kw)
        fs._assign_steady_state(u0, p0)
        fs.initialize_time_stepping()
        return fs

    fc = solver("cpu", precision="f64", solver_backend="host_lu")
    fg = solver(cuda, stepper_options={"force_substructure": True})
    rom, _ = modal_rom(*OperatorGetter(fc).get_all(autodiff=False), shifts=(0.1 + 0.8j,),
                       k_per_shift=2)
    fc.stepper  # the initial condition's carry
    up = np.repeat(fc._carry.u_n.numpy()[None], pop, 0)
    y0 = np.repeat(np.asarray(fc.y_meas)[None], pop, 0)
    runs = {}
    for name, fs, dtype in (("cpu", fc, np.float64), ("cuda", fg, np.float32)):
        st, seen = fs.stepper, []
        cost = lqg_population_cost(st.closed_loop_fn(steps, 1.0), st.init_carry(up), y0, rom,
                                   fs.params_time.dt, dtype=dtype)

        def recorded(thetas, cost=cost, seen=seen):
            seen.append((np.array(thetas), cost(thetas)))
            return seen[-1][1]

        res = minimize(None, np.zeros(4), "pop", {"n_iter": 2, "popsize": pop, "sigma0": 0.5,
                                                  "seed": 0}, verbose=False,
                       batch_costfun=recorded)
        runs[name] = (seen, res)
    (seen_c, res_c), (seen_g, res_g) = runs["cpu"], runs["cuda"]
    for (th_c, c_c), (th_g, c_g) in zip(seen_c, seen_g):
        assert np.allclose(th_g, th_c, rtol=0, atol=1e-12)
        assert np.isfinite(c_c).all() and np.allclose(c_g, c_c, rtol=5e-4, atol=0)
        assert set(np.argsort(c_g)[: pop // 4]) == set(np.argsort(c_c)[: pop // 4])
    assert np.allclose(res_g.x, res_c.x, rtol=0, atol=1e-12)
    print(f"search on the card against the CPU: max relative cost difference "
          f"{max(np.abs(g[1] / c[1] - 1).max() for g, c in zip(seen_g, seen_c)):.3e}")


@pytest.mark.cuda
def test_torch_cuda_device_memory_stats(cuda):
    from flowcontrol_tpu_torch.utils.profiling import device_memory_stats

    x = torch.ones(1 << 20, device=cuda)
    stats = device_memory_stats()
    assert sorted(stats) == [f"cuda:{i}" for i in range(torch.cuda.device_count())]
    assert stats["cuda:0"]["allocated_bytes.all.current"] >= x.numel() * 4
    assert device_memory_stats("cpu") == {}


# ── The analysis path's device functions ────────────────────────────────────


def _descriptor_system(n: int = 400, seed: int = 5):
    """A sparse A with a weakly unstable pair near 0.1 + 0.8j among damped
    modes, a singular E (its last tenth of rows zero, as the flow mass's
    pressure rows), B (n, 2) and C (3, n)."""
    import scipy.sparse as sp

    rng = np.random.default_rng(seed)
    a = sp.random(n, n, density=0.02, random_state=seed, format="lil") * 0.05
    a.setdiag(-np.linspace(0.5, 5.0, n))
    a[0, 0], a[0, 1], a[1, 0], a[1, 1] = 0.1, 0.8, -0.8, 0.1
    e = sp.eye(n, format="lil")
    for i in range(n - n // 10, n):
        e[i, i] = 0.0
    return (a.tocsr(), e.tocsr(), rng.standard_normal((n, 2)),
            rng.standard_normal((3, n)))


@pytest.mark.cuda
def test_torch_cuda_eig_arnoldi_matches_cpu(cuda):
    from flowcontrol_tpu_torch.utils.linalg import eig_arnoldi_dense_device

    a, e, _, _ = _descriptor_system()
    kw = dict(n=4, sigma=0.1 + 0.8j, n_krylov=60)
    got, vecs = eig_arnoldi_dense_device(a, e, dtype=torch.complex64, device=cuda, **kw)
    ref, _ = eig_arnoldi_dense_device(a, e, dtype=torch.complex128, device="cpu", **kw)
    assert abs(got[0] - ref[0]) < 1e-2
    assert abs(ref[0] - (0.1 + 0.8j)) < 0.05 and vecs.shape == (a.shape[0], 4)


@pytest.mark.cuda
@pytest.mark.parametrize("refined", [False, True])
def test_torch_cuda_frequency_response_matches_cpu(cuda, refined):
    from flowcontrol_tpu_torch.utils.linalg import get_frequency_response_device

    a, e, b, c = _descriptor_system()
    ww = np.array([0.1, 0.77, 2.15, 10.0])
    stats = {}
    got = get_frequency_response_device(a, b, c, e, ww, dtype=torch.complex64, device=cuda,
                                        stats=stats)
    got = got if refined else stats["h_unrefined"]
    ref = get_frequency_response_device(a, b, c, e, ww, dtype=torch.complex128, device="cpu")
    assert np.abs(got - ref).max() <= 2e-4 * np.abs(ref).max()


def test_torch_analysis_device_functions_raise_without_card(monkeypatch):
    """Without a card the device functions raise; they do not run on the
    CPU unless asked to (``device="cpu"``)."""
    from flowcontrol_tpu_torch.utils.linalg import (
        eig_arnoldi_dense_device,
        get_frequency_response_device,
    )

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    a, e, b, c = _descriptor_system(40)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        eig_arnoldi_dense_device(a, e, n=2, sigma=0.1 + 0.8j, n_krylov=10)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        get_frequency_response_device(a, b, c, e, [1.0])


def _lid_krylov(base, tmp_path, device, **kw):
    """The JAX package's Krylov fixture (the lid cavity at n_mesh=12,
    Re=500) on the port: 5 GMRES steps from the base flow with its initial
    perturbation, zero control."""
    fs = LidCavityFlowSolver.make_default(Re=500, num_steps=5, n_mesh=12, path_out=tmp_path,
                                          solver_backend="gmres", device=device, **kw)
    fs._assign_steady_state(*base)
    fs.initialize_time_stepping()
    ys = np.asarray([fs.step(np.zeros(1)) for _ in range(5)])
    return fs, ys, np.asarray(fs.fields.up_, dtype=float)


@pytest.mark.cuda
def test_torch_cuda_gmres_step_matches_cpu(cuda, tmp_path):
    """The GMRES step on the card (an f32 step, its Krylov solve in f64)
    against the port's f64 GMRES step on the CPU: field within 5e-4
    relative, y within 5e-4 of the f64 run's peak; every step's residual
    measured and at most krylov_rtol, K1 once a step; the compiled step is
    the eager one."""
    ref = LidCavityFlowSolver.make_default(Re=500, n_mesh=12, path_out=tmp_path / "b",
                                           device="cpu", precision="f64",
                                           solver_backend="host_lu")
    ref.compute_steady_state(u_ctrl=[0.0], method="picard", max_iter=4)
    ref.compute_steady_state(u_ctrl=[0.0], method="newton", initial_guess=ref.fields.UP0,
                             max_iter=10)
    base = (ref.fields.U0, ref.fields.P0)
    f64, y64, x64 = _lid_krylov(base, tmp_path / "c", "cpu", precision="f64")
    before = nonlinear_convection.launches
    f32, y32, x32 = _lid_krylov(base, tmp_path / "g", "cuda")
    st = f32.stepper
    assert st.dtype == torch.float32 and st._solver_kinds == ["gmres", "gmres"]
    assert nonlinear_convection.launches - before == 5 + 1  # and init_carry's
    assert f32._step_compiled == st.step and 0.0 <= f32.last_solve_res <= st.krylov_rtol
    err = np.linalg.norm(x32 - x64) / np.linalg.norm(x64)
    print(f"GMRES f32 card vs f64 CPU: field {err:.3e}, y {np.abs(y32 - y64).max():.3e}, "
          f"res {f32.last_solve_res:.3e}, cycles {st.krylov_cycles}")
    assert err <= 5e-4
    assert np.abs(y32 - y64).max() <= 5e-4 * np.abs(y64).max()


def _cavity_system(tmp_path):
    fs = CavityFlowSolver.make_default(mesh=cavity_mesh(n_coarse=4, n_mid=8, n_fine=16),
                                       device="cpu", path_out=tmp_path)
    lhs = fs.forms.transient_lhs(2, fs._default_steady_state_initial_guess())
    a_bc, _ = fs._bcset_perturbation().eliminate_csr(
        to_scipy_csr(lhs, fs.space.cell_dofs, fs.space.n_dofs))
    return a_bc, mixed_dof_coordinates(fs.space)


@pytest.mark.cuda
def test_torch_cuda_factor_cache_stream_bitwise(cuda, tmp_path, monkeypatch):
    """A small cavity's factor (f32) built cold on the card with the cache
    in a new directory, then streamed back from its derived entry through
    pinned staging buffers (pieces smaller than a stage, so the two buffers
    take turns): every device array bitwise equal, and F's solve (rows 1)
    and the per-stage sweep's (B = 64) bitwise equal."""
    from flowcontrol_tpu_torch.solvers import factor_cache
    from flowcontrol_tpu_torch.solvers import multifrontal as mf_module

    a_bc, coords = _cavity_system(tmp_path / "s")
    monkeypatch.setenv("FLOWCONTROL_TPU_FACTOR_CACHE", str(tmp_path / "cache"))
    cold = MultifrontalLU(a_bc, coords, cuda, dtype=torch.float32, leaf_max=300)
    factor_cache.flush()
    monkeypatch.setattr(mf_module, "STREAM_CHUNK_BYTES", 1 << 16)
    warm = MultifrontalLU(a_bc, coords, cuda, dtype=torch.float32, leaf_max=300)
    assert (cold.loaded_from, warm.loaded_from) == ("build", "stream")
    for k in ("perm", "ipos", "flat_stacks", "flat_bd", "flat_inbox", "desc", "p1_tables",
              "p1_desc"):
        assert torch.equal(getattr(warm, k), getattr(cold, k)), k
    assert warm.solve_err == cold.solve_err
    rng = np.random.default_rng(0)
    for rows in (1, 64):
        b = torch.as_tensor(rng.standard_normal((rows, cold.n)), dtype=torch.float32, device=cuda)
        assert torch.equal(warm.solve(b), cold.solve(b)), rows


@pytest.mark.cuda
def test_torch_cuda_factor_built_on_the_host_streams_bitwise(cuda, tmp_path, monkeypatch):
    """A small cavity's factor (f32) built on the CPU into a cache
    directory (as ``tools/scale_big.py factor`` builds the half-million-dof
    one beside ``chip_smoke.py``'s other phases), then streamed to the
    card: every device array, F's solve (rows 1) and the sweep's (B = 64)
    bitwise equal to a factor built cold on the card."""
    from flowcontrol_tpu_torch.solvers import factor_cache

    a_bc, coords = _cavity_system(tmp_path / "s")
    monkeypatch.setenv("FLOWCONTROL_TPU_FACTOR_CACHE", str(tmp_path / "cache"))
    host = MultifrontalLU(a_bc, coords, "cpu", dtype=torch.float32, leaf_max=300)
    factor_cache.flush()
    streamed = MultifrontalLU(a_bc, coords, cuda, dtype=torch.float32, leaf_max=300)
    monkeypatch.setenv("FLOWCONTROL_TPU_FACTOR_CACHE", "off")
    cold = MultifrontalLU(a_bc, coords, cuda, dtype=torch.float32, leaf_max=300)
    assert (host.loaded_from, streamed.loaded_from, cold.loaded_from) == (
        "build", "stream", "build")
    for k in ("perm", "ipos", "flat_stacks", "flat_bd", "flat_inbox", "desc", "p1_tables",
              "p1_desc"):
        assert torch.equal(getattr(streamed, k), getattr(cold, k)), k
    assert streamed.solve_err == cold.solve_err
    rng = np.random.default_rng(2)
    for rows in (1, 64):
        b = torch.as_tensor(rng.standard_normal((rows, cold.n)), dtype=torch.float32, device=cuda)
        assert torch.equal(streamed.solve(b), cold.solve(b)), rows


@pytest.fixture(scope="module")
def deep_factor():
    """A factor with more stages than the open cavity's 24: the
    half-million-dof cylinder's graded mesh at density 4 (12,638 dofs,
    ``tools/scale_big.py``), leaves of at most 256 dofs and the DP repack's
    price of a stage at 0.05 MB (39 stages, 60 grid syncs, where the
    default knobs give 6 stages); f32 on the card, or None without one."""
    if not torch.cuda.is_available():
        return None
    from flowcontrol_tpu_torch.models.make_baseflow import cylinder_big_mesh_kwargs

    fs = CylinderFlowSolver.make_default(mesh=cylinder_mesh(**cylinder_big_mesh_kwargs(4.0)),
                                         device="cpu")
    lhs = fs.forms.transient_lhs(2, fs._default_steady_state_initial_guess())
    a_bc, _ = fs._bcset_perturbation().eliminate_csr(
        to_scipy_csr(lhs, fs.space.cell_dofs, fs.space.n_dofs))
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("FC_MF_PACK_LAM_MB", "0.05")
        return MultifrontalLU(a_bc, mixed_dof_coordinates(fs.space), torch.device("cuda", 0),
                              dtype=torch.float32, leaf_max=256)


@pytest.mark.cuda
@pytest.mark.parametrize("rows", [1, 8])
def test_torch_cuda_f_many_stages_matches_plain_and_sweep(cuda, deep_factor, rows):
    mf = deep_factor
    assert len(mf.stages) > 24 and mf_fused.grid_syncs(mf) > 36
    b = torch.as_tensor(np.random.default_rng(rows).standard_normal((rows, mf.n)),
                        dtype=torch.float32, device=cuda)
    f = mf_fused.multifrontal_solve_fused
    before = f.launches
    got = f(mf, b)
    ref = mf_fused.multifrontal_solve_fused_plain(mf, b)
    sweep = multifrontal_solve(mf, b)
    torch.cuda.synchronize()
    assert f.launches == before + 1
    assert torch.equal(got, sweep)  # the sweep's summation order, stage by stage
    assert float((got - ref).abs().max() / ref.abs().max()) <= 1e-5


@pytest.mark.cuda
def test_torch_cuda_f_shared_memory_refused_past_the_opt_in(cuda, deep_factor):
    """F's request at 8 rows stays within the card's opt-in on a real
    factor; a factor whose node vectors would not fit 8 rows (its
    ``max_front`` raised on a copy) is refused with ``ValueError`` before
    any launch, and still solves 1 row, bitwise the factor's own F."""
    import copy

    mf = deep_factor
    assert mf_fused.fused_smem_bytes(mf, 8) <= mf_fused.fused_smem_limit(8)
    wide = copy.copy(mf)
    limit = mf_fused.fused_smem_limit(8)
    wide.max_front = -(-(limit // (8 * 4) + 1) // 8) * 8
    assert mf_fused.fused_smem_bytes(wide, 8) > limit >= mf_fused.fused_smem_bytes(wide, 1)
    b = torch.as_tensor(np.random.default_rng(3).standard_normal((8, mf.n)),
                        dtype=torch.float32, device=cuda)
    f = mf_fused.multifrontal_solve_fused
    before = f.launches
    with pytest.raises(ValueError, match="shared memory"):
        f(wide, b)
    assert f.launches == before
    assert torch.equal(f(wide, b[:1]), f(mf, b[:1]))


@pytest.mark.cuda
def test_torch_cuda_mf_knobs_match_plain(cuda, tmp_path, monkeypatch):
    """The knobs inbox='full', FC_MF_PACK=bucket and trim=False on a small
    cavity's factor (f32): F (rows 1 and 8) and the per-stage sweep
    (B = 64) within 1e-5 of F's plain descriptor walk."""
    a_bc, coords = _cavity_system(tmp_path)
    monkeypatch.setenv("FC_MF_PACK", "bucket")
    mf = MultifrontalLU(a_bc, coords, cuda, dtype=torch.float32, leaf_max=300, inbox="full",
                        trim=False)
    assert all(len(s.segs) == 1 for s in mf.stages)
    rng = np.random.default_rng(1)
    for rows in (1, 8, 64):
        b = torch.as_tensor(rng.standard_normal((rows, mf.n)), dtype=torch.float32, device=cuda)
        got = (mf_fused.multifrontal_solve_fused(mf, b) if rows <= 8
               else multifrontal_solve(mf, b))
        want = mf_fused.multifrontal_solve_fused_plain(mf, b)
        assert float((got - want).abs().max() / want.abs().max()) <= 1e-5, rows


@pytest.mark.cuda
def test_torch_cuda_sharded_gloo_two_ranks(cuda):
    """Two gloo ranks sharing the card (tests/torch_sharding_ranks.py
    ``cuda_world2``): the sharded multifrontal solve of a small cavity's f32
    factor through K2 and P1 within 1e-6 of the single-rank per-stage sweep
    at 1 and 64 right-hand sides (whether it is bitwise is printed), each
    rank holding half the factor; the sharded N(u) through K1 within 1e-5 of
    K1 on the whole mesh, one launch a rank. gloo gathers CUDA tensors
    through pinned host buffers."""
    from flowcontrol_tpu_torch.parallel.launch import run_world

    from torch_sharding_ranks import cuda_world2

    res = run_world(cuda_world2, 2, timeout_s=600)
    for rank, r in enumerate(res):
        print(f"rank {rank}: staging {r['staging']}, modes {r['modes']}, factor bytes "
              f"{r['factor_bytes']}, solve {r['solve']}, N(u) {r['nl']}")
        assert r["staging"] == {"all_reduce": "direct", "all_gather": "pinned host",
                                "send/recv": "pinned host"}
        per, total, whole = r["factor_bytes"]
        assert per * 2 == total and per < whole
        for rows, s in r["solve"].items():
            assert s["rel"] <= 1e-6 and min(s["launches"]) > 0, (rows, s)
        for rows, s in r["nl"].items():
            assert s["rel"] <= 1e-5 and s["launches"] == 1, (rows, s)


@pytest.mark.cuda
def test_torch_cuda_sharded_nccl_world_of_one(cuda):
    """A world of 1 over NCCL (tests/torch_sharding_ranks.py ``cuda_nccl1``):
    3 steps of the coarse cylinder through ``shard_stepper`` (K1, and the
    sharded solve through K2 and P1, F never) within 1e-5 of the unsharded
    steps (F) from the same carry."""
    from flowcontrol_tpu_torch.parallel.launch import run_world

    from torch_sharding_ranks import cuda_nccl1

    (r,) = run_world(cuda_nccl1, 1, backend="nccl", timeout_s=600)
    print(f"NCCL world of 1: field {r['rel']:.3e}, y {r['y']} (unsharded {r['y_ref']}), "
          f"launches K1/K2/P1/F {r['launches']}, kinds {r['kinds']}")
    assert r["rel"] <= 1e-5
    assert np.allclose(r["y"], r["y_ref"], rtol=1e-4, atol=1e-7)
    k1, k2, p1, f = r["launches"]
    assert k1 == 3 and k2 > 0 and p1 > 0 and f == 0
