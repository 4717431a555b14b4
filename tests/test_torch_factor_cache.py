"""The port's factor cache and the multifrontal solve's use of it, against
the JAX package's.

- ``solvers/factor_cache.py``: the six cases of ``tests/test_factor_cache.py``
  on the port's copy (round trip as a directory of ``.npy`` files, the
  legacy ``.npz`` read, a missing entry, a corrupt entry read as a miss, the
  LRU cap by mtime, an in-flight temporary directory never evicted).
- Inputs of the rest: ``tests/test_torch_multifrontal.py``'s system, the
  BC-eliminated BDF2 matrix of the coarse cylinder (7,889 dofs, base flow
  from 3 Picard iterations) with ``leaf_max=700``, factored in float64 and
  stored in float64; each case points ``FLOWCONTROL_TPU_FACTOR_CACHE`` at a
  directory of its own.
- A primary entry (the canonical payload) written by the JAX package's
  ``MultifrontalLU`` is read by the port's (``loaded_from == 'primary'``),
  which then holds bitwise the tables, stacks, descriptors and measured
  error of a cold port build; a primary entry written by the port is read by
  the JAX package's, which then holds bitwise the port's tables and stacks.
- Cold (``'build'``), then the streamed derived entry (``'stream'``), then
  with the derived entry removed the primary (``'primary'``): bitwise the
  same device arrays, solves and ``solve_err``; a derived entry that does
  not fit is a cache miss (a warning, then the cold path).
- The knobs ``FC_MF_PACK=bucket``, ``inbox='full'``, ``trim=False`` and
  ``leaf_max=512`` (each package building on its own, cache off): tables
  and stacks bitwise the JAX package's, and the port's per-stage sweep and
  F's plain descriptor walk within 1e-12 of the JAX package's solve.
"""

import logging
import os
import shutil

import numpy as np
import pytest
import torch
from threadpoolctl import threadpool_limits

import jax.numpy as jnp

from flowcontrol_tpu.fem.assembly import to_scipy_csr
from flowcontrol_tpu.mesh.generation import cylinder_mesh as cylinder_mesh_j
from flowcontrol_tpu.models.cylinder import CylinderFlowSolver as CylJ
from flowcontrol_tpu.parallel import dofsharding as dofsharding_j
from flowcontrol_tpu.solvers import factor_cache as fc_j
from flowcontrol_tpu.solvers import multifrontal as mfj
from flowcontrol_tpu_torch.ops.mf_fused import multifrontal_solve_fused_plain
from flowcontrol_tpu_torch.solvers import factor_cache as fc
from flowcontrol_tpu_torch.solvers import multifrontal as mft

torch.set_num_threads(1)

COARSE = dict(yinf=5.0, xinf=15.0, xinfa=-5.0, n1=4.0, n2=2.0, n3=0.8, segments=80)
LEAF = 700
#: the device arrays of a port factor, compared bitwise
FACTOR_ARRAYS = ("perm", "ipos", "flat_stacks", "flat_bd", "flat_inbox", "desc", "p1_tables",
                 "p1_desc")


@pytest.fixture(scope="module", autouse=True)
def one_blas_thread():
    """One BLAS thread (the factorizations' and SIMPLE's dense algebra), as
    torch gets one: the suite runs beside other test workers, and spinning
    BLAS threads of several processes on the same cores slow each other
    many times over."""
    with threadpool_limits(limits=1):
        yield


@pytest.fixture()
def cache_env(tmp_path, monkeypatch):
    monkeypatch.setenv("FLOWCONTROL_TPU_FACTOR_CACHE", str(tmp_path))
    return tmp_path


def _roundtrip(d, monkeypatch):
    arrays = {
        "n": np.int64(7),
        "depth_order": np.arange(4),
        "inv_0": np.random.default_rng(0).standard_normal((3, 5, 5)),
    }
    fc.save("deadbeef", **arrays)
    out = fc.load("deadbeef")
    assert out is not None
    assert int(out["n"]) == 7
    np.testing.assert_array_equal(out["depth_order"], arrays["depth_order"])
    np.testing.assert_allclose(out["inv_0"], arrays["inv_0"])
    # entry is a directory of raw .npy files (fast fread path, not zip)
    assert (d / "deadbeef").is_dir()
    assert sorted(f.name for f in (d / "deadbeef").glob("*.npy")) == [
        "depth_order.npy", "inv_0.npy", "n.npy",
    ]


def _legacy_npz(d, monkeypatch):
    np.savez(d / "cafe.npz", a=np.arange(3), n=np.int64(3))
    out = fc.load("cafe")
    assert out is not None and int(out["n"]) == 3
    np.testing.assert_array_equal(out["a"], np.arange(3))


def _missing(d, monkeypatch):
    assert fc.load("0000") is None


def _corrupt(d, monkeypatch):
    (d / "bad").mkdir()
    (d / "bad" / "x.npy").write_bytes(b"not a npy file")
    assert fc.load("bad") is None


def _lru_cap(d, monkeypatch):
    monkeypatch.setenv("FLOWCONTROL_TPU_FACTOR_CACHE_GB", "0.00002")  # ~21 KB
    big = np.zeros(2048)  # 16 KB each
    fc.save("old", x=big)
    os.utime(d / "old", (1, 1))  # force oldest mtime
    fc.save("new", x=big)  # cap enforcement runs on save
    assert fc.load("new") is not None
    assert fc.load("old") is None  # evicted (dir removed)


def _inflight_tmp(d, monkeypatch):
    monkeypatch.setenv("FLOWCONTROL_TPU_FACTOR_CACHE_GB", "0.00002")
    t = d / "writer123.tmp"
    t.mkdir()
    (t / "x.npy").write_bytes(b"\x00" * 100_000)
    fc.save("entry", x=np.zeros(2048))
    assert t.exists()  # in-flight temp dirs are never evicted
    assert fc.load("entry") is not None


@pytest.mark.parametrize("case", [_roundtrip, _legacy_npz, _missing, _corrupt, _lru_cap,
                                  _inflight_tmp], ids=lambda f: f.__name__.strip("_"))
def test_torch_factor_cache_cases(cache_env, monkeypatch, case):
    case(cache_env, monkeypatch)


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


def _port(system, **kw):
    a_bc, coords = system
    return mft.MultifrontalLU(a_bc, coords, "cpu", dtype=torch.float64,
                              **{"leaf_max": LEAF, **kw})


def _jax(system, **kw):
    a_bc, coords = system
    return mfj.MultifrontalLU(a_bc, coords, dtype=jnp.float64, **{"leaf_max": LEAF, **kw})


def _same_factor(a, b):
    """Two port factors hold bitwise the same device arrays, stages and
    measured error."""
    for k in FACTOR_ARRAYS:
        assert torch.equal(getattr(a, k), getattr(b, k)), k
    assert [(s.e, s.b, s.m, s.off, s.c_off, s.segs) for s in a.stages] == \
        [(s.e, s.b, s.m, s.off, s.c_off, s.segs) for s in b.stages]
    assert [p.segs for p in (a.p1_entry, a.p1_exit)] == [p.segs for p in (b.p1_entry, b.p1_exit)]
    assert (a.solve_err, a.recommended_refine, a.max_front, a.work_slots) == \
        (b.solve_err, b.recommended_refine, b.max_front, b.work_slots)


def _same_as_jax(mj, mt):
    """The port's tables and stacks bitwise the JAX package's
    (``tests/test_torch_multifrontal.py``'s comparison)."""
    assert mt.solve_err == mj.solve_err
    dj = mj.tree()
    assert np.array_equal(mt.perm.numpy()[:-1], np.asarray(dj["perm"]))
    assert np.array_equal(mt.ipos.numpy(), np.asarray(dj["ipos"]))
    assert [(s.e, s.b, s.m, s.off, s.c_off, s.segs) for s in mt.stages] == list(mj._stage_static)
    for sj, st in zip(dj["stages"], mt.stages):
        assert np.array_equal(st.bd.numpy(), np.asarray(sj["bd"]))
        assert len(st.inbox) == len(sj["inbox_ts"])
        for hj, ht in zip(sj["inbox_ts"], st.inbox):
            assert np.array_equal(ht.numpy(), np.asarray(hj)[:, : ht.shape[1]])
        for k in ("inv", "ginv", "fbi"):
            assert np.array_equal(getattr(st, k).numpy(), np.asarray(sj[k])), k


@pytest.fixture(scope="module")
def jax_primary(bdf2_system, tmp_path_factory):
    """A cache directory holding the JAX package's primary entry (and its
    own derived one), written by a cold JAX build."""
    d = tmp_path_factory.mktemp("jax_cache")
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("FLOWCONTROL_TPU_FACTOR_CACHE", str(d))
        mj = _jax(bdf2_system)
        fc_j.flush()
    assert mj.loaded_from == "build"
    return d


@pytest.fixture(scope="module")
def port_cold(bdf2_system, tmp_path_factory):
    """(cache directory, factor): a cold port build and the entries it
    stored."""
    d = tmp_path_factory.mktemp("port_cache")
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("FLOWCONTROL_TPU_FACTOR_CACHE", str(d))
        cold = _port(bdf2_system)
        fc.flush()
    assert cold.loaded_from == "build"
    return d, cold


def _derived(d):
    (p,) = [p for p in d.iterdir() if mft.DERIVED_TAG in p.name]
    return p


def test_torch_factor_cache_stream_primary_and_across_packages(bdf2_system, port_cold,
                                                               jax_primary, tmp_path,
                                                               monkeypatch):
    a_bc, _ = bdf2_system
    b = torch.as_tensor(np.random.default_rng(0).standard_normal((3, a_bc.shape[0])))
    d0, cold = port_cold
    d = tmp_path / "port"
    shutil.copytree(d0, d)
    monkeypatch.setenv("FLOWCONTROL_TPU_FACTOR_CACHE", str(d))
    # the port's derived entry streamed; the JAX package reads the port's
    # primary entry; the port's primary with the derived entry removed
    stream = _port(bdf2_system)
    mj = _jax(bdf2_system)
    fc_j.flush()
    shutil.rmtree(_derived(d))
    primary = _port(bdf2_system)
    # the port reads the JAX package's primary entry
    d = tmp_path / "jax"
    shutil.copytree(jax_primary, d)
    monkeypatch.setenv("FLOWCONTROL_TPU_FACTOR_CACHE", str(d))
    from_jax = _port(bdf2_system)
    fc.flush()
    assert [m.loaded_from for m in (stream, primary, from_jax)] == ["stream", "primary",
                                                                    "primary"]
    assert mj.loaded_from == "primary"
    _same_as_jax(mj, cold)
    want = cold.solve(b)
    for m in (stream, primary, from_jax):
        _same_factor(m, cold)
        assert torch.equal(m.solve(b), want)
    assert stream.timings["ordering+factorization"] == 0.0 < stream.timings["load"]


def test_torch_factor_cache_unfit_derived_entry_is_a_miss(bdf2_system, port_cold, tmp_path,
                                                          monkeypatch, caplog):
    d0, cold = port_cold
    shutil.copytree(d0, tmp_path / "c")
    monkeypatch.setenv("FLOWCONTROL_TPU_FACTOR_CACHE", str(tmp_path / "c"))
    # another dtype than the factor's
    np.save(_derived(tmp_path / "c") / "flat_stacks.npy", np.zeros(8, dtype=np.float32))
    with caplog.at_level(logging.WARNING):
        again = _port(bdf2_system)
    fc.flush()
    assert again.loaded_from == "primary" and "unreadable" in caplog.text
    _same_factor(again, cold)


@pytest.mark.parametrize("knob", [{"pack": "bucket"}, {"inbox": "full"}, {"trim": False},
                                  {"leaf_max": 512}], ids=lambda k: "-".join(map(str, *k.items())))
def test_torch_factor_knobs_match_jax(bdf2_system, jax_primary, tmp_path, monkeypatch, knob):
    """``pack`` and ``inbox`` shape what is built from the factor payload:
    both packages take it from the JAX package's primary entry. ``trim``
    and ``leaf_max`` shape the factorization: each package factors on its
    own, the cache off."""
    kw = dict(knob)
    if "pack" in kw:
        monkeypatch.setenv("FC_MF_PACK", kw.pop("pack"))
    if "pack" in knob or "inbox" in knob:
        shutil.copytree(jax_primary, tmp_path / "c")
        for p in (tmp_path / "c").iterdir():  # the primary entry alone
            if p.name.count("-"):
                shutil.rmtree(p)
        monkeypatch.setenv("FLOWCONTROL_TPU_FACTOR_CACHE", str(tmp_path / "c"))
    else:
        monkeypatch.setenv("FLOWCONTROL_TPU_FACTOR_CACHE", "off")
    mj, mt = _jax(bdf2_system, **kw), _port(bdf2_system, **kw)
    fc.flush()
    fc_j.flush()
    want_from = "primary" if "pack" in knob or "inbox" in knob else "build"
    assert mj.loaded_from == mt.loaded_from == want_from
    _same_as_jax(mj, mt)
    if "inbox" in kw:
        assert all(len(s.segs) == 1 for s in mt.stages)
    b = np.random.default_rng(1).standard_normal((2, mt.n))
    xj = np.asarray(mj.solve(b))
    for x in (mt.solve(torch.as_tensor(b)), multifrontal_solve_fused_plain(mt, torch.as_tensor(b))):
        assert np.abs(x.numpy() - xj).max() <= 1e-12 * np.abs(xj).max()
