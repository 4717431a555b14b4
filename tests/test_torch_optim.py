"""The port's ``utils/{optim,optim_algs,fem,profiling}.py`` against the JAX
package's, on the CPU.

- The optimizer oracles of ``tests/test_components.py`` (its test functions
  from ``test_minimize_nm_quadratic`` to ``test_construct_simplex``), run
  with ``flowcontrol_tpu.utils.optim`` and ``optim_algs`` resolving to the
  port's modules.
- Every algorithm of ``minimize`` ('nm', 'cobyla', 'bfgs', 'slsqp', 'dfo',
  'bo', 'pop' with a batched cost) on one seeded quadratic in both
  packages: equal ``x`` and ``fun`` to 1e-12.
- The campaign writers: ``write_results`` and ``write_optim_csv`` (the
  port's ``csv`` module) give the bytes of the JAX package's pandas
  writers; the other helpers give its values.
- ``fem`` (``summarize_timings``, ``get_subspace_dofs``, ``apply_fun``,
  ``projectm``, ``print0`` with and without a process group) and
  ``profiling`` (``timed``, a ``trace`` file on the CPU,
  ``device_memory_stats``) against the JAX package's where it has a
  counterpart.
"""

import sys

import numpy as np
import pytest
import torch

import flowcontrol_tpu.utils.fem as fem_j
import flowcontrol_tpu.utils.optim as optim_j
import flowcontrol_tpu.utils.optim_algs as algs_j
import flowcontrol_tpu.utils.profiling as prof_j
import flowcontrol_tpu_torch.utils.fem as fem_t
import flowcontrol_tpu_torch.utils.optim as optim_t
import flowcontrol_tpu_torch.utils.optim_algs as algs_t
import flowcontrol_tpu_torch.utils.profiling as prof_t
import test_components as oracles
from flowcontrol_tpu.fem.assembly import CellGeometry as GeomJ
from flowcontrol_tpu.mesh.dofmap import TaylorHoodSpace as SpaceJ
from flowcontrol_tpu.mesh.generation import unit_square_mesh as square_j
from flowcontrol_tpu_torch.fem.assembly import CellGeometry as GeomT
from flowcontrol_tpu_torch.mesh.dofmap import TaylorHoodSpace as SpaceT
from flowcontrol_tpu_torch.mesh.generation import unit_square_mesh as square_t

torch.set_num_threads(1)

ORACLES = ["test_minimize_nm_quadratic", "test_minimize_pop_batched",
           "test_minimize_dfo_builtin_quadratic", "test_minimize_bo_builtin_quadratic",
           "test_optim_helpers", "test_construct_simplex"]


@pytest.mark.parametrize("name", ORACLES)
def test_torch_optim_oracles(name, monkeypatch):
    monkeypatch.setitem(sys.modules, "flowcontrol_tpu.utils.optim", optim_t)
    monkeypatch.setitem(sys.modules, "flowcontrol_tpu.utils.optim_algs", algs_t)
    getattr(oracles, name)()


# ── minimize against the JAX package ─────────────────────────────────────────

_C = np.random.default_rng(4).standard_normal(3)


def _quadratic(x):
    x = np.asarray(x, dtype=float)
    return float(((x - _C) ** 2 * np.array([1.0, 2.0, 0.5])).sum() + 0.3 * x[0] * x[1])


def _batch(xs):
    return np.array([_quadratic(x) for x in xs])


ALGS = {
    "nm": {"maxfev": 150},
    "cobyla": {"maxiter": 60},
    "bfgs": {"maxiter": 30},
    "slsqp": {"maxiter": 30},
    "dfo": {"maxfev": 120},
    "bo": {"n_iter": 6, "n_doe": 5, "xlimits": [[-2.0, 2.0]] * 3, "random_state": 3},
    "pop": {"n_iter": 5, "popsize": 12, "sigma0": 0.7, "seed": 5},
}


@pytest.mark.parametrize("alg", sorted(ALGS))
def test_torch_minimize_matches_jax(alg):
    x0 = np.array([0.3, -0.2, 0.1])
    kw = {"batch_costfun": _batch} if alg == "pop" else {}
    got = algs_t.minimize(_quadratic, x0, alg, dict(ALGS[alg]), verbose=False, **kw)
    want = algs_j.minimize(_quadratic, x0, alg, dict(ALGS[alg]), verbose=False, **kw)
    assert np.abs(np.asarray(got.x) - np.asarray(want.x)).max() <= 1e-12
    assert abs(float(got.fun) - float(want.fun)) <= 1e-12 * max(abs(float(want.fun)), 1.0)
    assert got.nfev == want.nfev


def test_torch_minimize_rejects_unknown_alg():
    with pytest.raises(ValueError):
        algs_t.minimize(_quadratic, np.zeros(3), "cma", {}, verbose=False)


# ── The campaign writers and helpers ─────────────────────────────────────────


@pytest.mark.parametrize("x", [np.array([[0.1, 1e-5], [1.0, -2.5e20], [np.inf, -0.0]]),
                               np.array([[1, 2], [3, 4], [5, 6]]),
                               np.array([[0.1, 0.2], [0.3, 0.4], [0.5, 0.6]], dtype=np.float32)])
def test_torch_write_results_bytes_match_pandas(x, tmp_path):
    j = np.array([1.0 / 3, np.nan, 2.0])
    optim_t.write_results(tmp_path / "t" / "r.csv", x, j)
    optim_j.write_results(tmp_path / "j" / "r.csv", x, j)
    optim_t.write_results(tmp_path / "t" / "c.csv", x, j, columns=["qx", "ru"])
    optim_j.write_results(tmp_path / "j" / "c.csv", x, j, columns=["qx", "ru"])
    for f in ("r.csv", "c.csv"):
        assert (tmp_path / "t" / f).read_bytes() == (tmp_path / "j" / f).read_bytes()


def test_torch_write_optim_csv_bytes_match_pandas(tmp_path):
    rows = [([0.1, -2.0], 3.5, False), ([1e-7, 4.0], None, True), ([2, 3], 0.25, False)]
    for append in (True, False):
        for pkg, m in (("t", optim_t), ("j", optim_j)):
            for x, jv, div in rows:
                m.write_optim_csv(tmp_path / pkg / f"{append}.csv", x, jv, diverged=div,
                                  append=append)
        assert ((tmp_path / "t" / f"{append}.csv").read_bytes()
                == (tmp_path / "j" / f"{append}.csv").read_bytes())


def test_torch_optim_helpers_match_jax():
    rng = np.random.default_rng(8)
    sig, u = rng.standard_normal(50), rng.standard_normal((50, 2))
    xs = rng.standard_normal((6, 2))
    js = rng.standard_normal(6)
    for m in (optim_t, optim_j):
        assert m.parallel_function_wrapper([0.5, 1.0], [1], _quadratic) == 0.0
    pairs = [
        (optim_t.compute_signal_cost(sig, 0.01, "integral", scaling=np.abs),
         optim_j.compute_signal_cost(sig, 0.01, "integral", scaling=np.abs)),
        (optim_t.compute_signal_cost(sig, 0.01, "terminal", scaling=lambda v: v ** 2),
         optim_j.compute_signal_cost(sig, 0.01, "terminal", scaling=lambda v: v ** 2)),
        (optim_t.compute_control_cost(u, 0.01), optim_j.compute_control_cost(u, 0.01)),
        (optim_t.cummin(js, xs), optim_j.cummin(js, xs)),
        (optim_t.sobol_sample(8, 3, bounds=[(0, 1), (-1, 1), (2, 3)], seed=2),
         optim_j.sobol_sample(8, 3, bounds=[(0, 1), (-1, 1), (2, 3)], seed=2)),
        (optim_t.fun_array(xs, lambda x, s: s * x.sum(), s=2.0),
         optim_j.fun_array(xs, lambda x, s: s * x.sum(), s=2.0)),
        (optim_t.batch_evaluate(xs, lambda t: t.sum(1)), optim_j.batch_evaluate(xs, lambda t: t.sum(1))),
        (optim_t.parallel_function_wrapper(xs[0], [0], np.sum),
         optim_j.parallel_function_wrapper(xs[0], [0], np.sum)),
    ]
    for got, want in pairs:
        for g, w in zip(got if isinstance(got, tuple) else (got,),
                        want if isinstance(want, tuple) else (want,)):
            assert np.array_equal(np.asarray(g), np.asarray(w))
    with pytest.raises(ValueError):
        optim_t.compute_signal_cost(sig, 0.01, "mean")


# ── fem and profiling ────────────────────────────────────────────────────────


class _FS:
    def __init__(self, space, geom):
        self.space, self.geom = space, geom


@pytest.fixture(scope="module")
def spaces():
    sj, st = SpaceJ.build(square_j(4, 4)), SpaceT.build(square_t(4, 4))
    return _FS(sj, GeomJ(sj)), _FS(st, GeomT(st))


def test_torch_fem_matches_jax(spaces):
    fj, ft = spaces
    sub_t, sub_j = fem_t.get_subspace_dofs(ft.space), fem_j.get_subspace_dofs(fj.space)
    assert sorted(sub_t) == sorted(sub_j) and all(np.array_equal(sub_t[k], sub_j[k]) for k in sub_j)
    rt = np.array([0.0, 1.5, 0.7, np.nan, 0.2, 0.3, 0.25])
    for ts in (rt, {"runtime": rt}, rt[:2]):
        got, want = fem_t.summarize_timings(ts, n_dofs=100), fem_j.summarize_timings(ts, n_dofs=100)
        assert sorted(got) == sorted(want)
        assert all(np.array_equal(got[k], want[k], equal_nan=True) for k in want)
    field = np.random.default_rng(2).standard_normal(ft.space.n_dofs)
    assert fem_t.apply_fun(ft, field, np.max) == fem_j.apply_fun(fj, field, np.max)

    def vel(x):
        return np.stack([np.sin(x[:, 0]), x[:, 0] * x[:, 1]], axis=1)

    def pres(x):
        return np.cos(x[:, 0] + 2 * x[:, 1])

    for fn, target in ((vel, "velocity"), (pres, "pressure")):
        got = fem_t.projectm(ft, fn, target=target)
        want = np.asarray(fem_j.projectm(fj, fn, target=target))
        assert np.abs(got - want).max() <= 1e-12 * np.abs(want).max()


def test_torch_fem_print0(capsys, monkeypatch):
    import torch.distributed as dist

    fem_t.print0("alone", 1)
    assert capsys.readouterr().out == "alone 1\n"
    monkeypatch.setattr(dist, "is_initialized", lambda: True)
    for rank, out in ((0, "rank zero\n"), (1, "")):
        monkeypatch.setattr(dist, "get_rank", lambda r=rank: r)
        fem_t.print0("rank", "zero")
        assert capsys.readouterr().out == out


def test_torch_profiling(tmp_path):
    res_t, res_j = {}, {}
    for m, res in ((prof_t, res_t), (prof_j, res_j)):
        with m.timed("block", res):
            sum(range(1000))
        with m.timed("unused"):
            pass
    assert sorted(res_t) == sorted(res_j) == ["block"] and res_t["block"] >= 0.0
    with prof_t.trace(str(tmp_path / "tr")) as logdir:
        torch.ones(64).cumsum(0)
    assert logdir == str(tmp_path / "tr")
    assert (tmp_path / "tr" / "trace.json").stat().st_size > 0
    assert prof_t.device_memory_stats("cpu") == {}


def test_torch_device_memory_stats_needs_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError):
        prof_t.device_memory_stats()
