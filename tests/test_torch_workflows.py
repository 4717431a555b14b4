"""The port's copies of two examples against the JAX package's, on the CPU.

- ``convert_npz_to_mat``: a scipy sparse ``.npz`` and a plain ``.npz``
  converted by both packages' examples give the same ``.mat`` arrays.
- ``lidcavity_workflows`` at a small size (``n_mesh=8``, the continuation
  Re 500 → 800, ``batch_run`` of 2 members for 3 steps, the 6 eigenvalues
  nearest 0.5j), f64: base flows and dE within 1e-10, eigenvalues 1e-8.
  Both examples' ARPACK calls get one fixed start vector: without one,
  ARPACK draws a new start on every call, and on this problem (E singular
  on the pressure dofs) its Ritz values then move by ~1e-3 from call to
  call in either package (measured: the JAX example's own two calls differ
  by 2.5e-3, and both lie within ~1e-2 of the dense spectrum).
"""

import importlib.util
from pathlib import Path

import numpy as np
import pytest
import scipy.io as sio
import scipy.sparse as sp
import torch
from threadpoolctl import threadpool_limits

ROOT = Path(__file__).resolve().parents[1]

torch.set_num_threads(1)


def _jax_example(name: str):
    spec = importlib.util.spec_from_file_location(f"jax_example_{name}",
                                                  ROOT / "examples" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_torch_convert_npz_to_mat_matches_jax(tmp_path):
    from flowcontrol_tpu_torch.examples import convert_npz_to_mat as conv_t

    conv_j = _jax_example("convert_npz_to_mat")
    rng = np.random.default_rng(0)
    sp.save_npz(tmp_path / "A.npz", sp.random(30, 20, density=0.2, random_state=1, format="csr"))
    np.savez(tmp_path / "H.npz", H=rng.standard_normal((4, 3)) + 1j, w=np.linspace(0, 1, 4))
    for name in ("A", "H"):
        for tag, conv in (("t", conv_t), ("j", conv_j)):
            conv.convert(tmp_path / f"{name}.npz", tmp_path / f"{name}_{tag}.mat")
        t = sio.loadmat(tmp_path / f"{name}_t.mat")
        j = sio.loadmat(tmp_path / f"{name}_j.mat")
        keys = sorted(k for k in j if not k.startswith("__"))
        assert keys == sorted(k for k in t if not k.startswith("__")) and keys
        for k in keys:
            assert np.array_equal(t[k], j[k]), (name, k)


@pytest.fixture(scope="module")
def workflows(tmp_path_factory):
    """Both examples' three workflows, with one BLAS thread (the suite's
    workers share the cores)."""
    with threadpool_limits(limits=1):
        return _workflows(tmp_path_factory)


def _workflows(tmp_path_factory):
    import scipy.sparse.linalg as spla

    from flowcontrol_tpu_torch.examples import lidcavity_workflows as wf_t

    eigs = spla.eigs

    def eigs_fixed_start(a, *args, **kw):
        if kw.get("v0") is None:
            v0 = np.random.default_rng(0).standard_normal((2, a.shape[0]))
            kw["v0"] = v0[0] + 1j * v0[1]
        return eigs(a, *args, **kw)

    wf_j = _jax_example("lidcavity_workflows")
    out = tmp_path_factory.mktemp("wf")
    wf_j.cwd = out  # the JAX example writes next to itself otherwise
    res = {}
    fs_j, flows_j = wf_j.steady_state_increasing_Re(res=(500, 800), n_mesh=8)
    fs_t, flows_t = wf_t.steady_state_increasing_Re(res=(500, 800), n_mesh=8, device="cpu",
                                                    path_out=out / "t")
    res["flows"] = (flows_t, flows_j)
    res["de"] = (wf_t.batch_run(fs_t, n_batch=2, num_steps=3),
                 wf_j.batch_run(fs_j, n_batch=2, num_steps=3))
    mp = pytest.MonkeyPatch()
    mp.setattr(spla, "eigs", eigs_fixed_start)
    try:
        res["eig"] = (wf_t.eigenvalues(fs_t), wf_j.eigenvalues(fs_j))
    finally:
        mp.undo()
    return res


def test_torch_lidcavity_workflows_continuation_matches_jax(workflows):
    flows_t, flows_j = workflows["flows"]
    assert sorted(flows_t) == sorted(flows_j) == [500, 800]
    for re_k in flows_j:
        for a, b in zip(flows_t[re_k], flows_j[re_k]):
            assert np.abs(a - b).max() <= 1e-10 * max(1.0, np.abs(b).max())


def test_torch_lidcavity_workflows_batch_run_matches_jax(workflows):
    de_t, de_j = workflows["de"]
    assert de_t.shape == de_j.shape == (3, 2)
    assert np.allclose(de_t, de_j, rtol=1e-10, atol=1e-16)


def test_torch_lidcavity_workflows_eigenvalues_match_jax(workflows):
    ev_t, ev_j = workflows["eig"]
    assert len(ev_t) == len(ev_j) == 6
    for lam in ev_j:
        assert np.abs(ev_t - lam).min() <= 1e-8 * max(1.0, abs(lam))
