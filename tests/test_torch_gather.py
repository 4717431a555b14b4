"""P1 (``ops/mf_matvec.sweep_gather``) and the per-stage multifrontal sweep
built around it, on the CPU through the plain versions, against the JAX
package and against the sweep's earlier dataflow.

Inputs: the BC-eliminated BDF2 matrices of the integration tests' coarse
cylinder (7,889 dofs, ``leaf_max=700``) and of a small open cavity (3,486
dofs, ``leaf_max=300``), taken around the default initial guess, so that
the nested dissection recurses and several stages receive inbox sums.

- The sweep (``multifrontal_solve``) is bitwise equal to the earlier
  dataflow (``tests/mf_sweep_reference.py``: the padded int64 entry gather,
  the zeroed buffer, one P1 per inbox segment, z copied over xe, int64
  boundary and exit gathers), f32 and f64, one right-hand side and
  batches; in f64 it agrees with the JAX package's solve to 1e-10.
- P1's descriptors cover every inbox table entry exactly once, in the
  tables' order, and every segment's output columns once; the gather
  plans cover the work vector (entry), the dofs (exit) and every stage's
  boundary.
- No position of the contribution buffer but 0 is read before a stage
  writes it (the sweep zeroes only position 0).
- The int32 ``perm``, ``ipos`` and ``bd`` tables equal their int64
  counterparts.
- P1's plain version against the JAX package's primitives on the same
  tables: the inbox form against ``_gather_sum0`` (f32, 1e-6 of the largest
  term: another summation order), the gather form against ``jnp.take``
  (bitwise).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from flowcontrol_tpu.solvers import multifrontal as mfj
from flowcontrol_tpu_torch.fem.assembly import to_scipy_csr
from flowcontrol_tpu_torch.mesh.generation import cavity_mesh, cylinder_mesh
from flowcontrol_tpu_torch.models.cavity import CavityFlowSolver
from flowcontrol_tpu_torch.models.cylinder import CylinderFlowSolver
from flowcontrol_tpu_torch.ops.mf_matvec import GATHER_COLS, sweep_gather
from flowcontrol_tpu_torch.parallel.dofsharding import mixed_dof_coordinates
from flowcontrol_tpu_torch.solvers.multifrontal import MultifrontalLU
from mf_sweep_reference import multifrontal_solve_reference

torch.set_num_threads(1)

COARSE = dict(yinf=5.0, xinf=15.0, xinfa=-5.0, n1=4.0, n2=2.0, n3=0.8, segments=80)
FLOWS = {"cylinder": (lambda tmp: CylinderFlowSolver.make_default(
                          mesh=cylinder_mesh(**COARSE), device="cpu", path_out=tmp), 700),
         "cavity": (lambda tmp: CavityFlowSolver.make_default(
                        mesh=cavity_mesh(n_coarse=4, n_mid=8, n_fine=16), device="cpu",
                        path_out=tmp), 300)}
DTYPES = {"f32": torch.float32, "f64": torch.float64}


@pytest.fixture(scope="module")
def systems(tmp_path_factory):
    """{flow: (a_bc, coords, leaf_max)}: the BDF2 matrix around the default
    initial guess."""
    out = {}
    for name, (make, leaf) in FLOWS.items():
        fs = make(tmp_path_factory.mktemp(name))
        lhs = fs.forms.transient_lhs(2, fs._default_steady_state_initial_guess())
        a_bc, _ = fs._bcset_perturbation().eliminate_csr(
            to_scipy_csr(lhs, fs.space.cell_dofs, fs.space.n_dofs))
        out[name] = (a_bc, mixed_dof_coordinates(fs.space), leaf)
    return out


@pytest.fixture(scope="module")
def factors(systems):
    """factors(flow, dtype name): the port's factor on the CPU, built on use."""
    built = {}

    def get(flow, name):
        if (flow, name) not in built:
            a_bc, coords, leaf = systems[flow]
            built[flow, name] = MultifrontalLU(a_bc, coords, "cpu", dtype=DTYPES[name],
                                               leaf_max=leaf)
        return built[flow, name]

    return get


@pytest.mark.parametrize("shape", [(), (3,), (2, 3)], ids=["1", "3", "2x3"])
@pytest.mark.parametrize("name", sorted(DTYPES))
@pytest.mark.parametrize("flow", sorted(FLOWS))
def test_torch_gather_sweep_equals_earlier_dataflow(factors, flow, name, shape):
    mf = factors(flow, name)
    b = torch.as_tensor(np.random.default_rng(len(shape)).standard_normal(shape + (mf.n,)),
                        dtype=DTYPES[name])
    got = mf.solve(b)
    want = multifrontal_solve_reference(mf, b)
    bits = torch.int32 if name == "f32" else torch.int64
    assert got.shape == b.shape and got.dtype == b.dtype
    assert torch.equal(got.reshape(-1).view(bits), want.reshape(-1).view(bits))


@pytest.mark.parametrize("flow", sorted(FLOWS))
def test_torch_gather_sweep_matches_jax_f64(systems, factors, flow, monkeypatch):
    a_bc, coords, leaf = systems[flow]
    monkeypatch.setenv("FLOWCONTROL_TPU_FACTOR_CACHE", "off")
    mj = mfj.MultifrontalLU(a_bc, coords, leaf_max=leaf, dtype=jnp.float64)
    mt = factors(flow, "f64")
    b = np.random.default_rng(5).standard_normal((3, a_bc.shape[0]))
    xt = mt.solve(torch.as_tensor(b)).numpy()
    xj = np.asarray(mj.solve(b))
    assert np.abs(xt - xj).max() <= 1e-10 * np.abs(xj).max()


def _tiles(segs):
    return np.cumsum([0] + [-(-w // GATHER_COLS) for (_, w, _, _) in segs])


@pytest.mark.parametrize("flow", sorted(FLOWS))
def test_torch_gather_descriptors_cover_every_entry_once(factors, flow):
    mf = factors(flow, "f32")
    desc = mf.p1_desc.numpy()
    entries = []  # (table offset, size) of every inbox segment, in stage order
    n_with_inbox = 0
    for st in mf.stages:
        tabbed = [(m0, m1) for (m0, m1, t) in st.segs if t]
        plan = st.p1_inbox
        assert (plan is None) == (not tabbed)
        if plan is None:
            continue
        n_with_inbox += 1
        assert plan.sub and plan.tables is mf.flat_inbox and len(plan.segs) == len(tabbed)
        cols = np.zeros(st.m * st.e, dtype=int)
        for i, ((m0, m1), (o, w, kmax, t_off)) in enumerate(zip(tabbed, plan.segs)):
            assert (o, w) == (m0 * st.e, (m1 - m0) * st.e)
            assert torch.equal(plan.table(i), st.inbox[i]) and kmax == st.inbox[i].shape[0]
            cols[o: o + w] += 1
            entries.append((t_off, kmax * w))
        assert cols.max() == 1  # each output column at most once
        rows = plan.desc.numpy()
        assert np.array_equal(rows[:, :4], np.asarray(plan.segs))
        assert np.array_equal(rows[:, 4], _tiles(plan.segs)[:-1])
        assert plan.n_tiles == _tiles(plan.segs)[-1]
    # the inbox segments' tables tile the flat inbox table, in order
    assert n_with_inbox > 1 and entries[0][0] == 0
    for (o0, s0), (o1, _) in zip(entries, entries[1:]):
        assert o1 == o0 + s0
    assert entries[-1][0] + entries[-1][1] == mf.flat_inbox.numel()
    # the gather plans: entry, exit, each stage's boundary
    for plan, width, table in [(mf.p1_entry, mf.work_slots, mf.perm32),
                               (mf.p1_exit, mf.n, mf.ipos32)] + [
            (st.p1_bd, st.m * st.b, st.bd32.reshape(-1)) for st in mf.stages]:
        assert not plan.sub and plan.tables is mf.p1_tables and len(plan.segs) == 1
        assert plan.segs[0][:3] == (0, width, 1) and plan.segs[0][3] % 4 == 0
        assert torch.equal(plan.table(0)[0], table)
        assert plan.n_tiles == -(-width // GATHER_COLS)
    # every launch's rows are one block of the descriptor array
    assert desc.shape[0] == 2 + len(mf.stages) + sum(len(s.p1_inbox.segs) for s in mf.stages
                                                     if s.p1_inbox is not None)


@pytest.mark.parametrize("flow", sorted(FLOWS))
def test_torch_gather_buffer_reads_only_position0_unwritten(factors, flow):
    """Walking the forward sweep's stages in order, every contribution
    buffer position an inbox table reads, but 0, was written by an earlier
    stage's boundary update; no stage writes position 0."""
    mf = factors(flow, "f32")
    written = np.zeros(1 + mf.total_contrib, dtype=bool)
    read_zero = False
    last = len(mf.stages) - 1
    for si, st in enumerate(mf.stages):
        for t in st.inbox:
            pos = np.unique(t.numpy())
            read_zero |= bool((pos == 0).any())
            assert written[pos[pos != 0]].all(), f"stage {si} reads an unwritten position"
        if si < last:
            c0 = 1 + st.c_off
            assert not written[c0: c0 + st.m * st.b].any()
            written[c0: c0 + st.m * st.b] = True
    assert read_zero and not written[0]


@pytest.mark.parametrize("flow", sorted(FLOWS))
def test_torch_gather_int32_tables_equal_int64(factors, flow):
    mf = factors(flow, "f32")
    total = mf.total_slots
    for t32 in (mf.perm32, mf.ipos32, *(st.bd32 for st in mf.stages)):
        assert t32.dtype == torch.int32
    assert torch.equal(mf.perm32[: total + 1].long(), mf.perm)
    assert bool((mf.perm32[total + 1:] == mf.n).all()) and mf.work_slots % 4 == 0
    assert torch.equal(mf.ipos32.long(), mf.ipos)
    for st in mf.stages:
        assert torch.equal(st.bd32.long(), st.bd)


@pytest.mark.parametrize("flow", sorted(FLOWS))
def test_torch_gather_plain_matches_jax(factors, flow):
    """The inbox form against JAX ``_gather_sum0`` on every stage's tables
    (a batch of 2, in place on the work vector as the sweep calls it); the
    gather form against ``jnp.take``: the entry permutation (pads read the
    appended zero), every boundary and the exit permutation."""
    mf = factors(flow, "f32")
    rng = np.random.default_rng(9)
    buf = rng.standard_normal((2, 1 + mf.total_contrib)).astype(np.float32)
    buf[:, 0] = 0.0
    x = rng.standard_normal((2, mf.work_slots)).astype(np.float32)
    got = torch.as_tensor(x.copy())
    for st in mf.stages:
        if st.p1_inbox is None:
            continue
        xe = got[:, st.off: st.off + st.m * st.e]
        sweep_gather(st.p1_inbox, torch.as_tensor(buf), xe=xe, out=xe)
        for i, (o, w, kmax, _) in enumerate(st.p1_inbox.segs):
            t = np.asarray(st.p1_inbox.table(i))
            lo = st.off + o
            ref = x[:, lo: lo + w] - np.asarray(mfj._gather_sum0(jnp.asarray(buf), t))
            scale = np.abs(buf).max() * kmax + np.abs(x).max()
            assert np.abs(got[:, lo: lo + w].numpy() - ref).max() <= 1e-6 * scale
    bb = rng.standard_normal((2, mf.n)).astype(np.float32)
    entry = sweep_gather(mf.p1_entry, torch.as_tensor(bb)).numpy()
    padded = jnp.pad(jnp.asarray(bb), ((0, 0), (0, 1)))
    assert np.array_equal(entry, np.asarray(jnp.take(padded, mf.perm32.numpy(), axis=1)))
    for st in mf.stages:
        got_b = sweep_gather(st.p1_bd, torch.as_tensor(x)).numpy()
        want_b = jnp.take(jnp.asarray(x), st.bd32.numpy().reshape(-1), axis=1)
        assert np.array_equal(got_b, np.asarray(want_b))
    got_x = sweep_gather(mf.p1_exit, torch.as_tensor(x)).numpy()
    assert np.array_equal(got_x, np.asarray(jnp.take(jnp.asarray(x), mf.ipos32.numpy(), axis=1)))
