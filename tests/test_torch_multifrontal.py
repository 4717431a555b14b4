"""The port's multifrontal solve against the JAX package's.

Inputs: the BC-eliminated BDF2 matrix of the integration tests' coarse
cylinder (7,889 dofs, base flow from 3 Picard iterations) with
``leaf_max=700``, so that the nested dissection recurses. JAX runs on the
CPU with its factor cache off, so both packages factor from scratch.

- Host half: the nested-dissection tree, the factor payload (after the DP
  repack and the inbox-load sort), the index tables, the factor stacks and
  the measured per-solve error are bitwise equal to the JAX package's.
- Solve: the port's plain f64 sweep within 1e-12 relative of JAX
  ``multifrontal_solve`` (single RHS and a (2, 3) batch) and within 1e-11
  of scipy's splu.
- K2's plain version against the JAX Pallas ``stack_matvec`` (interpret
  mode off-TPU) at that test's shapes (f32, rtol 2e-5), and at non-aligned
  shapes (p, q in {8, 216, 744}) against an f64 einsum; P1's plain version
  against JAX ``_gather_sum0`` on real inbox tables (f32 summation order
  differs: 1e-6 of the largest term).
- One solve calls K2 and P1 (``sweep_gather``) exactly
  ``launches_per_solve()`` times (the count the chip smoke run asserts on
  the card).
"""

import numpy as np
import pytest
import scipy.sparse.linalg as spla
import torch

import jax.numpy as jnp

from flowcontrol_tpu.fem.assembly import to_scipy_csr
from flowcontrol_tpu.mesh.generation import cylinder_mesh as cylinder_mesh_j
from flowcontrol_tpu.models.cylinder import CylinderFlowSolver as CylJ
from flowcontrol_tpu.ops.pallas_mf_matvec import stack_matvec as stack_matvec_j
from flowcontrol_tpu.parallel import dofsharding as dofsharding_j
from flowcontrol_tpu.solvers import multifrontal as mfj
from flowcontrol_tpu.solvers import tridiag as tridiag_j
from flowcontrol_tpu_torch.mesh.dofmap import TaylorHoodSpace as SpaceT
from flowcontrol_tpu_torch.mesh.generation import cylinder_mesh as cylinder_mesh_t
from flowcontrol_tpu_torch.ops import mf_matvec
from flowcontrol_tpu_torch.parallel import dofsharding as dofsharding_t
from flowcontrol_tpu_torch.solvers import multifrontal as mft
from flowcontrol_tpu_torch.solvers import tridiag as tridiag_t

torch.set_num_threads(1)

COARSE = dict(yinf=5.0, xinf=15.0, xinfa=-5.0, n1=4.0, n2=2.0, n3=0.8, segments=80)
LEAF = 700
DTYPES = {"f32": (jnp.float32, torch.float32, np.float32),
          "f64": (jnp.float64, torch.float64, np.float64)}


@pytest.fixture(scope="module")
def bdf2_system(tmp_path_factory):
    """(a_bc, coords) of the coarse cylinder's BDF2 matrix."""
    fs = CylJ.make_default(
        Re=100, num_steps=1, mesh=cylinder_mesh_j(**COARSE), solver_backend="host_lu",
        precision="f64", path_out=tmp_path_factory.mktemp("mf"),
    )
    fs.compute_steady_state(u_ctrl=[0.0, 0.0], method="picard", max_iter=3)
    lhs_e = fs.forms.transient_lhs(2, fs.fields.U0)
    a_bc, _ = fs._bcset_perturbation().eliminate_csr(
        to_scipy_csr(lhs_e, fs.space.cell_dofs, fs.space.n_dofs)
    )
    return a_bc, dofsharding_j.mixed_dof_coordinates(fs.space)


@pytest.fixture(scope="module")
def pairs(bdf2_system):
    """{dtype name: (JAX MultifrontalLU, port MultifrontalLU)}, built on use."""
    a_bc, coords = bdf2_system
    built = {}

    def get(name):
        if name not in built:
            dj, dt, _ = DTYPES[name]
            with pytest.MonkeyPatch.context() as mp:
                mp.setenv("FLOWCONTROL_TPU_FACTOR_CACHE", "off")
                mj = mfj.MultifrontalLU(a_bc, coords, leaf_max=LEAF, dtype=dj)
            mt = mft.MultifrontalLU(a_bc, coords, "cpu", dtype=dt, leaf_max=LEAF)
            built[name] = (mj, mt)
        return built[name]

    return get


def test_torch_mf_host_helpers_match_jax(bdf2_system):
    a_bc, coords = bdf2_system
    space = SpaceT.build(cylinder_mesh_t(**COARSE))
    assert np.array_equal(dofsharding_t.mixed_dof_coordinates(space), coords)
    for axis in (0, 1):
        assert np.array_equal(tridiag_t.graph_levels(a_bc, coords, axis=axis),
                              tridiag_j.graph_levels(a_bc, coords, axis=axis))


def test_torch_mf_tree_matches_jax(bdf2_system):
    a_bc, coords = bdf2_system
    n = a_bc.shape[0]
    g = ((a_bc != 0) + (a_bc != 0).T).tocsr()
    trees = []
    for mod in (mfj, mft):
        root = mod.build_nd_tree(g, coords, np.arange(n), leaf_max=LEAF)
        mod._merge_small_nodes(root)
        mod._set_depths(root)
        mod._annotate_boundaries(g, root)
        trees.append(mod._postorder(root))
    tj, tt = trees
    assert len(tt) == len(tj) > 3  # the dissection recursed
    for vj, vt in zip(tj, tt):
        assert vt.depth == vj.depth
        assert np.array_equal(vt.elim, vj.elim) and np.array_equal(vt.bd, vj.bd)


def test_torch_mf_payload_matches_jax(bdf2_system):
    a_bc, coords = bdf2_system
    n = a_bc.shape[0]
    payloads = []
    for mod in (mfj, mft):
        p = mod.MultifrontalLU._factorize(a_bc, coords, LEAF, np.dtype(np.float32))
        payloads.append(p)
        p = mod._repack_dp(p, n, lam_bytes=8 * 2**20)
        payloads.append(mod._sort_nodes_by_inbox_load(p, n))
    for pj, pt in ((payloads[0], payloads[2]), (payloads[1], payloads[3])):
        assert sorted(pt) == sorted(pj)
        for k in pj:
            assert pt[k].dtype == pj[k].dtype and np.array_equal(pt[k], pj[k]), k
    assert mft._measure_solve_err(a_bc, payloads[3], n) == mfj._measure_solve_err(
        a_bc, payloads[1], n
    )


@pytest.mark.parametrize("name", ["f32", "f64"])
def test_torch_mf_tables_and_stacks_match_jax(pairs, name):
    mj, mt = pairs(name)
    assert mt.solve_err == mj.solve_err
    assert mt.recommended_refine == mj.recommended_refine
    assert (mt.n_depths, mt.total_slots, mt.total_contrib) == (
        mj.n_depths, mj.total_slots, mj.total_contrib
    )
    dj = mj.tree()
    assert np.array_equal(mt.perm.numpy()[:-1], np.asarray(dj["perm"]))
    assert mt.perm.numpy()[-1] == mt.n  # the work vector's trailing zero slot
    assert np.array_equal(mt.ipos.numpy(), np.asarray(dj["ipos"]))
    assert [(s.e, s.b, s.m, s.off, s.c_off, s.segs) for s in mt.stages] == list(mj._stage_static)
    for sj, st in zip(dj["stages"], mt.stages):
        assert np.array_equal(st.bd.numpy(), np.asarray(sj["bd"]))
        assert len(st.inbox) == len(sj["inbox_ts"])
        for hj, ht in zip(sj["inbox_ts"], st.inbox):
            # the host table's trailing column is its pad row's; the sweep
            # reads the segment's own columns
            assert ht.shape[1] == np.asarray(hj).shape[1] - 1
            assert np.array_equal(ht.numpy(), np.asarray(hj)[:, : ht.shape[1]])
        for k in ("inv", "ginv", "fbi"):
            a = getattr(st, k).numpy()
            assert a.dtype == DTYPES[name][2] and np.array_equal(a, np.asarray(sj[k])), k


@pytest.mark.parametrize("shape", [(), (2, 3)])
def test_torch_mf_solve_matches_jax_f64(bdf2_system, pairs, shape):
    a_bc, _ = bdf2_system
    mj, mt = pairs("f64")
    b = np.random.default_rng(0).standard_normal(shape + (a_bc.shape[0],))
    xt = mt.solve(torch.as_tensor(b)).numpy()
    xj = np.asarray(mj.solve(b))
    assert xt.shape == b.shape and xt.dtype == np.float64
    assert np.abs(xt - xj).max() <= 1e-12 * np.abs(xj).max()
    lu = spla.splu(a_bc.tocsc())
    for idx in np.ndindex(*shape):
        ref = lu.solve(b[idx])
        assert np.linalg.norm(xt[idx] - ref) <= 1e-11 * np.linalg.norm(ref)


def test_torch_mf_solve_launch_count(pairs, monkeypatch):
    """One solve calls K2 3·stages − 1 times and P1 once per stage with an
    inbox, once per stage for the boundary gather and once each for the
    entry and exit permutations, the counts ``launches_per_solve`` gives."""
    _, mt = pairs("f32")
    calls = {"k2": 0, "p1": 0}

    def counted(key, fn):
        def wrapped(*args, **kw):
            calls[key] += 1
            return fn(*args, **kw)
        return wrapped

    monkeypatch.setattr(mft, "stack_matvec", counted("k2", mf_matvec.stack_matvec))
    monkeypatch.setattr(mft, "sweep_gather", counted("p1", mf_matvec.sweep_gather))
    mt.solve(torch.ones(mt.n))
    assert (calls["k2"], calls["p1"]) == mt.launches_per_solve()
    with_inbox = sum(1 for s in mt.stages if s.inbox)
    assert with_inbox > 0 and calls["p1"] == with_inbox + len(mt.stages) + 2


@pytest.mark.parametrize("m,p,q", [(1, 128, 128), (3, 256, 128), (5, 768, 1536), (2, 384, 2048)])
def test_torch_k2_plain_matches_pallas(m, p, q):
    rng = np.random.default_rng(7)
    a = rng.standard_normal((m, p, q)).astype(np.float32)
    v = rng.standard_normal((m, q)).astype(np.float32)
    ref = np.asarray(stack_matvec_j(jnp.asarray(a), jnp.asarray(v)))
    got = mf_matvec.stack_matvec(torch.as_tensor(a), torch.as_tensor(v)).numpy()
    assert got.dtype == np.float32 and got.shape == (m, p)
    np.testing.assert_allclose(got, ref, rtol=2e-5, atol=1e-4 * np.sqrt(q))


@pytest.mark.parametrize("p", [8, 216, 744])
@pytest.mark.parametrize("q", [8, 216, 744])
def test_torch_k2_plain_unaligned_f64(p, q):
    """Every stage shape of the port (multiples of 8), single RHS and a
    batch of 3, against an f64 einsum of the f32 operands."""
    rng = np.random.default_rng(p * 1000 + q)
    a = rng.standard_normal((3, p, q)).astype(np.float32)
    v = rng.standard_normal((3, 3, q)).astype(np.float32)
    ref = np.einsum("mpq,bmq->bmp", a.astype(np.float64), v.astype(np.float64))
    got = mf_matvec.stack_matvec(torch.as_tensor(a), torch.as_tensor(v)).numpy()
    np.testing.assert_allclose(got, ref, rtol=2e-5, atol=1e-4 * np.sqrt(q))
    out = torch.empty((3, 3, p))
    mf_matvec.stack_matvec(torch.as_tensor(a), torch.as_tensor(v[0]), out=out[1])
    np.testing.assert_allclose(out[1].numpy(), ref[0], rtol=2e-5, atol=1e-4 * np.sqrt(q))


def test_torch_p1_plain_matches_jax_gather_sum0(pairs):
    mj, mt = pairs("f32")
    rng = np.random.default_rng(3)
    buf = rng.standard_normal(1 + mt.total_contrib).astype(np.float32)
    buf[0] = 0.0  # the pads' zero
    n_tabbed = 0
    for sj, st in zip(mj.tree()["stages"], mt.stages):
        for tj, tt in zip(sj["inbox_ts"], st.inbox):
            ln = tt.shape[1]
            xe = rng.standard_normal(ln).astype(np.float32)
            ref = xe - np.asarray(mfj._gather_sum0(jnp.asarray(buf), tj))[:ln]
            got = mf_matvec.gather_sum_sub(torch.as_tensor(buf), tt, torch.as_tensor(xe))
            scale = np.abs(buf).max() * tt.shape[0] + np.abs(xe).max()
            assert np.abs(got.numpy() - ref).max() <= 1e-6 * scale
            # in place on a strided batch row, as the sweep calls it
            xb = torch.zeros((2, ln + 5))
            xb[1, 2: 2 + ln] = torch.as_tensor(xe)
            seg = xb[:, 2: 2 + ln]
            mf_matvec.gather_sum_sub(torch.as_tensor(np.stack([buf, buf])), tt, seg, out=seg)
            assert np.abs(xb[1, 2: 2 + ln].numpy() - ref).max() <= 1e-6 * scale
            n_tabbed += 1
    assert n_tabbed > 0
