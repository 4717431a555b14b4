"""Kernel F's plain version and the primitives P2-P4 against the JAX package.

Inputs: the BC-eliminated BDF2 matrices (around each flow's default
steady-state guess) of a small cylinder (2,774 dofs) and a small cavity
(3,486 dofs), factored by the port in float64 with ``leaf_max=300``, so
that the dissection recurses and stages carry up to three tabbed inbox
segments.

- ``multifrontal_solve_fused_plain``, which walks the stage descriptor
  array over the flat stacks and tables, against the JAX package's
  ``multifrontal_solve`` on the same factor carried across (the port's
  stacks and tables handed to the JAX solve as its device tree): within
  1e-12 relative, rows 1 and 3. Also against the port's per-stage sweep.
- The descriptor array: offsets increasing and inside the flat arrays,
  views of the flat arrays equal to the per-stage tensors, inbox pads at
  the buffer's zero, bd pads at the work vector's trailing zero slot.
- P2, P3 and P4 plain against the ``jnp`` operations the probe bodies of
  ``tools/pallas_gather_probe.py`` apply, at the probe's shapes: bitwise.
- On the CPU, ``MultifrontalLU.solve`` keeps the per-stage sweep and the F
  wrapper its plain version, with no launch counted.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from flowcontrol_tpu.solvers import multifrontal as mfj
from flowcontrol_tpu_torch.fem.assembly import to_scipy_csr
from flowcontrol_tpu_torch.mesh.generation import cavity_mesh, cylinder_mesh
from flowcontrol_tpu_torch.models.cavity import CavityFlowSolver
from flowcontrol_tpu_torch.models.cylinder import CylinderFlowSolver
from flowcontrol_tpu_torch.ops import mf_fused
from flowcontrol_tpu_torch.parallel.dofsharding import mixed_dof_coordinates
from flowcontrol_tpu_torch.solvers import multifrontal as mft

torch.set_num_threads(1)

FLOWS = {
    "cylinder": (CylinderFlowSolver, lambda: cylinder_mesh(
        yinf=3.0, xinf=8.0, xinfa=-3.0, n1=3.0, n2=1.5, n3=0.6, segments=40)),
    "cavity": (CavityFlowSolver, lambda: cavity_mesh(n_coarse=4, n_mid=8, n_fine=16)),
}
LEAF = 300


@pytest.fixture(scope="module", autouse=True)
def _factor_cache_off():
    """The port's multifrontal factors here are built cold and stored
    nowhere: the factor cache is off for the module (its own tests are in
    tests/test_torch_factor_cache.py)."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("FLOWCONTROL_TPU_FACTOR_CACHE", "off")
        yield


@pytest.fixture(scope="module")
def factors(tmp_path_factory):
    """{flow: the port's f64 MultifrontalLU}, built on use."""
    built = {}

    def get(name):
        if name not in built:
            cls, mesh = FLOWS[name]
            fs = cls.make_default(mesh=mesh(), device="cpu", path_out=tmp_path_factory.mktemp(name))
            lhs = fs.forms.transient_lhs(2, fs._default_steady_state_initial_guess())
            a_bc, _ = fs._bcset_perturbation().eliminate_csr(
                to_scipy_csr(lhs, fs.space.cell_dofs, fs.space.n_dofs))
            built[name] = mft.MultifrontalLU(a_bc, mixed_dof_coordinates(fs.space), "cpu",
                                             dtype=torch.float64, leaf_max=LEAF)
        return built[name]

    return get


def _jax_tree(mf):
    """The JAX solve's device tree and static arguments for the port's
    factor ``mf`` (its slot-suffix bd tables rebuilt as the JAX package
    builds them)."""
    stages, static = [], []
    for st in mf.stages:
        bd = st.bd.numpy()
        sfx_base = st.off + st.m * st.e
        bd_s = np.where(bd < mf.total_slots, bd - sfx_base + 1, 0)
        stages.append({
            "bd": jnp.asarray(bd.astype(np.int32)),
            "bd_s": jnp.asarray(bd_s.astype(np.int32)),
            "inbox_ts": tuple(jnp.asarray(t.numpy()) for t in st.inbox),
            "inv": jnp.asarray(st.inv.numpy()),
            "ginv": jnp.asarray(st.ginv.numpy()),
            "fbi": jnp.asarray(st.fbi.numpy()),
        })
        static.append((st.e, st.b, st.m, st.off, st.c_off, st.segs))
    dev = {"perm": jnp.asarray(mf.perm.numpy()[:-1].astype(np.int32)),
           "ipos": jnp.asarray(mf.ipos.numpy().astype(np.int32)), "stages": stages}
    return dev, dict(n=mf.n, total=mf.total_slots, total_contrib=mf.total_contrib,
                     stages=tuple(static), layout="ij", einsum="xla")


@pytest.mark.parametrize("rows", [1, 3])
@pytest.mark.parametrize("flow", list(FLOWS))
def test_torch_mf_fused_plain_matches_jax_solve(factors, flow, rows):
    mf = factors(flow)
    assert sum(len(s.inbox) for s in mf.stages) >= 2  # inbox segments to gather
    shape = () if rows == 1 else (rows,)
    b = np.random.default_rng(rows).standard_normal(shape + (mf.n,))
    dev, static = _jax_tree(mf)
    ref = np.asarray(mfj.multifrontal_solve(dev, jnp.asarray(b), **static))
    assert ref.dtype == np.float64  # the JAX package turns on x64
    got = mf_fused.multifrontal_solve_fused_plain(mf, torch.as_tensor(b))
    assert got.shape == b.shape and got.dtype == torch.float64
    assert np.abs(got.numpy() - ref).max() <= 1e-12 * np.abs(ref).max()
    sweep = mft.multifrontal_solve(mf, torch.as_tensor(b)).numpy()
    assert np.abs(got.numpy() - sweep).max() <= 1e-12 * np.abs(sweep).max()


@pytest.mark.parametrize("flow", list(FLOWS))
def test_torch_mf_fused_descriptor_invariants(factors, flow):
    mf = factors(flow)
    desc = mf.desc.numpy()
    assert desc.dtype == np.int64 and desc.shape == (len(mf.stages), mf_fused.STAGE_WORDS)
    recs = [mf_fused.stage_record(w) for w in desc]
    prev = {k: -1 for k in ("off", "c_off", "inv", "ginv", "fbi", "bd")}
    n_tabbed = 0
    for (h, segs), st in zip(recs, mf.stages):
        assert (h["e"], h["b"], h["m"], h["off"], h["c_off"]) == (st.e, st.b, st.m, st.off,
                                                                 st.c_off)
        assert h["e"] % 4 == 0 and h["b"] % 4 == 0  # F's 16-byte loads
        for k in prev:  # every offset increases from stage to stage
            assert h[k] > prev[k], k
        assert h["inv"] < h["ginv"] < h["fbi"] and h["inv"] % 64 == 0
        prev = {k: h[k] for k in prev}
        for k, (o, shape) in enumerate(((h["inv"], (st.m, st.e, st.e)),
                                        (h["ginv"], (st.m, st.e, st.b)),
                                        (h["fbi"], (st.m, st.b, st.e)))):
            view = mf.flat_stacks[o: o + np.prod(shape)].view(shape)
            assert torch.equal(view, (st.inv, st.ginv, st.fbi)[k])
            assert view.data_ptr() == (st.inv, st.ginv, st.fbi)[k].data_ptr()  # no copy
        bd = mf.flat_bd[h["bd"]: h["bd"] + st.m * st.b]
        assert torch.equal(bd, st.bd.reshape(-1)) and bd.data_ptr() == st.bd.data_ptr()
        # boundary pads point at the work vector's trailing zero slot, real
        # entries at strict ancestors' slots; n_bd counts the real ones
        real = bd < mf.total_slots
        assert h["n_bd"] == int(real.sum())
        assert (bd[~real] == mf.total_slots).all()
        assert (bd[real] >= st.off + st.m * st.e).all()
        assert [(sg["m0"], sg["m1"], bool(sg["tabbed"])) for sg in segs] == list(st.segs)
        tabbed = [sg for sg in segs if sg["tabbed"]]
        for sg, t in zip(tabbed, st.inbox):
            w = (sg["m1"] - sg["m0"]) * st.e
            flat = mf.flat_inbox[sg["inbox"]: sg["inbox"] + sg["kmax"] * w].view(sg["kmax"], w)
            assert torch.equal(flat, t) and flat.data_ptr() == t.data_ptr()
            # buffer positions come from deeper stages; pads read its zero
            assert int(t.max()) <= st.c_off and int(t.min()) >= 0
            assert (t == 0).any()
            n_tabbed += 1
    assert n_tabbed == sum(len(s.inbox) for s in mf.stages) >= 2
    # F stages one node's vector of up to max_front floats per right-hand side
    assert mf.max_front == max(max(s.e, s.b) for s in mf.stages) and mf.max_front % 8 == 0
    # only the root has no real bd slot, and so no backward phase; the
    # leaf stage reads no inbox
    assert [h["n_bd"] == 0 for h, _ in recs] == [False] * (len(recs) - 1) + [True]
    assert not any(sg["tabbed"] for sg in recs[0][1])
    # a leaf stage: no stage's bd holds one of its slots; exactly the
    # stages without a tabbed inbox segment, and never the root
    held = torch.zeros(mf.total_slots + 1, dtype=torch.bool)
    held[mf.flat_bd] = True
    held[mf.total_slots] = False
    leaves = []
    for si, ((h, segs), st) in enumerate(zip(recs, mf.stages)):
        assert h["leaf"] == int(not held[st.off: st.off + st.m * st.e].any())
        assert h["leaf"] == int(not any(sg["tabbed"] for sg in segs))
        leaves += [si] * h["leaf"]
    assert 0 < len(leaves) < len(mf.stages) - 1 and not recs[-1][0]["leaf"]
    # phases: the leaf stages' inv and fbi together; per other stage an
    # inbox pass, inv and fbi (none at the root); backward, one per other
    # stage but the root, then the leaf stages together; a sync between each
    labels = mf_fused.phase_labels(mf)
    inner = len(mf.stages) - len(leaves)
    assert labels[:2] == [("inv", tuple(leaves)), ("fbi", tuple(leaves))]
    assert len(labels) == 2 + 3 * inner - 1 + (inner - 1) + 1
    assert labels[-1] == ("ginv", tuple(leaves))
    assert labels[-2] == ("ginv", (min(set(range(len(recs))) - set(leaves)),))
    assert mf_fused.grid_syncs(mf) == len(labels) - 1


def test_torch_mf_fused_cpu_routing(factors):
    mf = factors("cavity")
    b = torch.as_tensor(np.random.default_rng(0).standard_normal((2, mf.n)))
    before = mf_fused.multifrontal_solve_fused.launches
    assert not mf.takes_fused(1)  # a factor on the CPU keeps the per-stage sweep
    x = mf_fused.multifrontal_solve_fused(mf, b)
    assert mf_fused.multifrontal_solve_fused.launches == before
    assert torch.allclose(x, mf.solve(b), rtol=0, atol=1e-12 * float(x.abs().max()))
    with pytest.raises(ValueError):
        mf_fused.multifrontal_solve_fused(mf, b[:, :-1])


def test_torch_p2_p3_p4_plain_match_probe_bodies():
    """The probes' own inputs (tools/pallas_gather_probe.py: n = 1024, (8, 128)
    lanes, offsets 640 and 256) through each plain version and the jnp
    operation its probe body applies."""
    n, k = 1024, 8
    rng = np.random.default_rng(0)
    v = rng.standard_normal(n).astype(np.float32)
    rng.integers(0, n, (k, 128))  # P1's table, drawn in the probe's order
    v2 = rng.standard_normal((8, n)).astype(np.float32)
    lanes = rng.integers(0, n, (8, 128)).astype(np.int32)

    p2 = mf_fused.take_along_axis_lanes(torch.as_tensor(v2), torch.as_tensor(lanes))
    assert np.array_equal(p2.numpy(), np.asarray(jnp.take_along_axis(v2, lanes, axis=1)))

    s = torch.tensor([640], dtype=torch.int32)
    p3 = mf_fused.dynamic_slice(torch.as_tensor(v), s, 128)
    ref3 = np.asarray(jax.lax.dynamic_slice(jnp.asarray(v), (jnp.int32(640),), (128,)))
    assert np.array_equal(p3.numpy(), ref3)

    o = rng.standard_normal(n).astype(np.float32)
    s = torch.tensor([256], dtype=torch.int32)
    p4 = mf_fused.dynamic_offset_accum_store(torch.as_tensor(o.copy()), s, torch.as_tensor(v[:128]))
    ref4 = np.asarray(jnp.asarray(o).at[256: 256 + 128].add(jnp.asarray(v)[:128]))
    assert np.array_equal(p4.numpy(), ref4)
    assert (mf_fused.take_along_axis_lanes.launches, mf_fused.dynamic_slice.launches,
            mf_fused.dynamic_offset_accum_store.launches) == (0, 0, 0)
