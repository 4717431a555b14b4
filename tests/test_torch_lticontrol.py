"""The port's ``utils/lticontrol.py`` against the JAX package's, on the CPU.

- The oracles of ``tests/test_lticontrol.py`` (analytic norms, LFT, LQR
  and LQG, Youla, Laguerre bases, coprime factorizations, balanced
  reduction, H2/H∞ synthesis, residues, slow-fast, bumpless switching, the
  frozen anchors of ``tests/data/lti_anchors.json`` read in place): each
  of its test functions runs with that module's ``ltc`` and ``StateSpace``
  swapped for the port's.
- Every name in ``__all__``, and ``dlqg_regulator``, called in both
  packages on the same seeded numpy systems: equal results to 1e-10
  relative (state-space results matrix by matrix).
- A ``.mat`` written by each package (``write_ss``, ``export_controller``)
  and read by the other.
- ``dlqg_regulator``'s known fault (ROADMAP.md, "Faults in the
  reference"), reproduced in both packages: the filter Kalman gain in a
  predictor-form compensator leaves the sampled closed loop unstable,
  spectral radius 1.0085 at a plant pole of 30 with dt = 0.02.
"""

import contextlib
import io
import json

import numpy as np
import pytest
import scipy.io as sio

import flowcontrol_tpu.utils.lticontrol as ltc_j
import flowcontrol_tpu_torch.utils.lticontrol as ltc_t
import test_lticontrol as oracles
from flowcontrol_tpu.utils.statespace import StateSpace as SSJ
from flowcontrol_tpu_torch.utils.statespace import StateSpace as SST

TOL = 1e-10
PACKAGES = {"jax": (ltc_j, SSJ), "port": (ltc_t, SST)}


# ── The oracles of tests/test_lticontrol.py on the port ──────────────────────

ORACLES = sorted(n for n in dir(oracles) if n.startswith("test_"))


@pytest.mark.parametrize("name", ORACLES)
def test_torch_lticontrol_oracles(name, monkeypatch, tmp_path):
    monkeypatch.setattr(oracles, "ltc", ltc_t)
    monkeypatch.setattr(oracles, "StateSpace", SST)
    fn = getattr(oracles, name)
    args = {}
    for p in fn.__code__.co_varnames[: fn.__code__.co_argcount]:
        if p == "plant_and_k0":  # the oracle module's fixture, on the port
            g = SST([[0.2, 1.0], [0.0, -1.0]], [[0.0], [1.0]], [[1.0, 0.0]], 0.0)
            args[p] = (g, ltc_t.lqg_regulator(g, 1.0, 1.0, 1.0, 1.0)[0])
        elif p == "anchors":
            args[p] = json.loads(oracles._ANCHORS.read_text())
        elif p == "tmp_path":
            args[p] = tmp_path
        else:
            raise AssertionError(f"{name} takes an unknown fixture {p!r}")
    fn(**args)


# ── Every name against the JAX package ──────────────────────────────────────


def _stable(ss, n=4, m=2, p=3, seed=0):
    rng = np.random.default_rng(seed)
    a = rng.standard_normal((n, n))
    a -= (max(np.linalg.eigvals(a).real.max(), 0.0) + 0.5) * np.eye(n)
    return ss(a, rng.standard_normal((n, m)), rng.standard_normal((p, n)),
              0.1 * rng.standard_normal((p, m)))


def _siso(ss):
    """The oracles' unstable SISO plant."""
    return ss([[0.2, 1.0], [0.0, -1.0]], [[0.0], [1.0]], [[1.0, 0.0]], 0.0)


def _generalized(ss):
    """tests/test_lticontrol.py's H∞/H2 plant: z = [x; u], y = x + w2."""
    return ss([[1.0]], np.array([[1.0, 0.0, 1.0]]), np.array([[1.0], [0.0], [1.0]]),
              np.array([[0.0, 0.0, 0.0], [0.0, 0.0, 1.0], [0.0, 1.0, 0.0]]))


def _first_order(ss, tau, k):
    return ss([[-1.0 / tau]], [[k / tau]], [[1.0]], 0.0)


def _k0(m, ss):
    return m.lqg_regulator(_siso(ss), 1.0, 1.0, 1.0, 1.0)[0]


def _mat(m, ss, path):
    sio.savemat(str(path), {k: v for k, v in zip("ABCD", m.ssdata(_stable(ss)))})
    return path


def _print(m, ss, path=None):
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        m.show_ss(_stable(ss))
    return out.getvalue()


def _mref(m, ss, path=None):
    one = m.ss_one()
    return m.hinfsyn_mref(_first_order(ss, 1.0, 2.0), _first_order(ss, 10.0, 10.0), one * 0.1,
                          one * 0.1, one, _first_order(ss, 1.0, 0.5),
                          _first_order(ss, 0.5, 1.0), syn="Hinf")


def _condswitch(m, ss, path=None):
    k = ss([[-1.0, 0.4], [0.0, -2.0]], [[1.0], [0.5]], [[1.0, 0.2]], 0.1)
    rng = np.random.default_rng(3)
    return m.condswitch(rng.standard_normal(10), rng.standard_normal(10), k, 0.05,
                        w_y=1.0, w_u=2.0, w_decay=0.9)


def _exported(m, ss, path):
    m.export_controller(path, _stable(ss), w=np.logspace(-1, 1, 7), dt=None)
    m.export_controller(str(path) + "_d.mat", _stable(ss), w=np.logspace(-1, 1, 7), dt=0.05)
    return {k: v for f in (path, str(path) + "_d.mat") for k, v in sio.loadmat(str(f)).items()
            if not k.startswith("__")}


def _written(m, ss, path):
    m.write_ss(_stable(ss), path)
    return {k: v for k, v in sio.loadmat(str(path)).items() if not k.startswith("__")}


CASES = {
    "read_matfile": lambda m, ss, p: {k: v for k, v in m.read_matfile(_mat(m, ss, p)).items()
                                      if not k.startswith("__")},
    "read_ss": lambda m, ss, p: m.read_ss(_mat(m, ss, p)),
    "write_ss": _written,
    "ssdata": lambda m, ss, p: m.ssdata(_stable(ss)),
    "ss_zero": lambda m, ss, p: m.ss_zero(),
    "ss_one": lambda m, ss, p: m.ss_one(),
    "ss_vstack": lambda m, ss, p: m.ss_vstack(_stable(ss, p=2), _stable(ss, p=1, seed=1)),
    "ss_hstack": lambda m, ss, p: m.ss_hstack(_stable(ss, m=2), _stable(ss, m=1, seed=1)),
    "ss_vstack_list": lambda m, ss, p: m.ss_vstack_list([_stable(ss, seed=s) for s in range(3)]),
    "ss_hstack_list": lambda m, ss, p: m.ss_hstack_list([_stable(ss, seed=s) for s in range(3)]),
    "ss_blkdiag_list": lambda m, ss, p: m.ss_blkdiag_list([_stable(ss, seed=s) for s in range(3)]),
    "ss_inv": lambda m, ss, p: m.ss_inv(ss(*m.ssdata(_stable(ss, p=2))[:3], [[1.0, 0.2], [0.3, 2.0]])),
    "ss_transpose": lambda m, ss, p: m.ss_transpose(_stable(ss)),
    "show_ss": lambda m, ss, p: _print(m, ss),
    "isstable": lambda m, ss, p: (m.isstable(_stable(ss)), m.isstable(_siso(ss))),
    "isstablecl": lambda m, ss, p: [m.isstablecl(_siso(ss), _k0(m, ss), sign=s) for s in (1, -1)],
    "norm": lambda m, ss, p: (m.norm(ss(*m.ssdata(_stable(ss))[:3], np.zeros((3, 2))), 2),
                              m.norm(_stable(ss), np.inf)),
    "lft": lambda m, ss, p: m.lft(_generalized(ss), _first_order(ss, 2.0, 0.5), ny=1, nu=1),
    "youla": lambda m, ss, p: m.youla(_siso(ss), _k0(m, ss), m.basis_laguerre_ss(1.5, [0.3, -0.1])),
    "build_block_Psi": lambda m, ss, p: m.build_block_Psi(_siso(ss)),
    "youla_laguerre": lambda m, ss, p: m.youla_laguerre(_siso(ss), _k0(m, ss), 2.0, [0.2, -0.4]),
    "youla_laguerre_mimo": lambda m, ss, p: m.youla_laguerre_mimo(
        _stable(ss, m=1, p=2), m.lqg_regulator(_stable(ss, m=1, p=2), 1.0, 1.0, 1.0, 1.0)[0],
        2.0, [0.2, -0.4, 0.1, 0.3]),
    "youla_laguerre_K00": lambda m, ss, p: m.youla_laguerre_K00(_siso(ss), _k0(m, ss), 2.0,
                                                                 [0.1, -0.2]),
    "youla_lqg": lambda m, ss, p: m.youla_lqg(_siso(ss), 1.0, 1.0, 1.0, 1.0,
                                              m.basis_laguerre_ss(1.0, [0.2])),
    "youla_lqg_lftmat": lambda m, ss, p: m.youla_lqg_lftmat(_siso(ss), 2.0, 1.0, 0.5, 1.0),
    "youla_Qab": lambda m, ss, p: m.youla_Qab(
        _k0(m, ss), m.youla_laguerre(_siso(ss), _k0(m, ss), 1.5, [0.3, -0.1]),
        _siso(ss).feedback(_k0(m, ss), sign=+1)),
    "youla_Q0b": lambda m, ss, p: m.youla_Q0b(
        m.youla_laguerre(_siso(ss), _k0(m, ss), 1.5, [0.3, -0.1]), _k0(m, ss), _siso(ss)),
    "youla_left_coprime": lambda m, ss, p: m.youla_left_coprime(
        _siso(ss), _k0(m, ss), m.basis_laguerre_ss(1.0, [0.2])),
    "youla_right_coprime": lambda m, ss, p: m.youla_right_coprime(
        _siso(ss), _k0(m, ss), m.basis_laguerre_ss(1.0, [0.2])),
    "lqr": lambda m, ss, p: m.lqr(_stable(ss).A, _stable(ss).B, 2.0 * np.eye(4), np.eye(2)),
    "lqe": lambda m, ss, p: m.lqe(_stable(ss).A, np.eye(4), _stable(ss).C, np.eye(4),
                                  0.5 * np.eye(3)),
    "lqg_regulator": lambda m, ss, p: m.lqg_regulator(_stable(ss), 0.1, 2.0, 10.0, 0.5),
    "dlqg_regulator": lambda m, ss, p: m.dlqg_regulator(
        ss(_stable(ss).A, _stable(ss).B, _stable(ss).C, np.zeros((3, 2))), 0.05, qx=2.0, rv=0.1),
    "hinfsyn": lambda m, ss, p: m.hinfsyn(_generalized(ss), ny=1, nu=1),
    "h2syn": lambda m, ss, p: m.h2syn(_generalized(ss), ny=1, nu=1),
    "hinfsyn_mref": _mref,
    "basis_laguerre_canonical": lambda m, ss, p: m.basis_laguerre_canonical(1.7, 4),
    "basis_laguerre": lambda m, ss, p: m.basis_laguerre(2.0, [0.7, -0.3, 0.2]),
    "basis_laguerre_canonical_ss": lambda m, ss, p: m.basis_laguerre_canonical_ss(1.7, 4),
    "basis_laguerre_ss": lambda m, ss, p: m.basis_laguerre_ss(2.0, [0.7, -0.3, 0.2]),
    "basis_laguerre_K00": lambda m, ss, p: m.basis_laguerre_K00(_siso(ss), _k0(m, ss), 2.0,
                                                                 [0.1, -0.2]),
    "rncf": lambda m, ss, p: m.rncf(_stable(ss)),
    "lncf": lambda m, ss, p: m.lncf(_stable(ss)),
    "gram": lambda m, ss, p: (m.gram(_stable(ss), "c"), m.gram(_stable(ss), "o")),
    "balreal": lambda m, ss, p: m.balreal(_stable(ss)),
    "baltransform": lambda m, ss, p: m.baltransform(_stable(ss)),
    "reduceorder": lambda m, ss, p: m.reduceorder(_stable(ss, n=6)),
    "sys_hsv": lambda m, ss, p: m.sys_hsv(_stable(ss, n=6)),
    "balred_rel": lambda m, ss, p: m.balred_rel(_stable(ss, n=6), 1e-2, method="matchdc"),
    "stab_unstab_decomp": lambda m, ss, p: m.stab_unstab_decomp(
        ss(np.diag([0.7, -3.0, 0.2, -1.0]) + np.triu(np.ones((4, 4)), 1),
           np.ones((4, 2)), np.ones((3, 4)), np.zeros((3, 2)))),
    "controller_residues": lambda m, ss, p: m.controller_residues([2.0], [-1.0], [1.0 + 0.5j],
                                                                  [-0.5 + 2.0j]),
    "controller_residues_getidx": lambda m, ss, p: m.controller_residues_getidx(2, 3),
    "controller_residues_wrapper": lambda m, ss, p: m.controller_residues_wrapper(
        np.array([2.0, -1.0, 1.0, 0.5, -0.5, 2.0]), 1, 1),
    "slowfast": lambda m, ss, p: m.slowfast(
        ss(np.diag([-0.1, -50.0, -3.0]), [[1.0], [1.0], [0.5]], [[1.0, 2.0, 0.3]], 0.0), 1.0),
    "condswitch": _condswitch,
    "compare_controllers": lambda m, ss, p: m.compare_controllers(_stable(ss), _stable(ss, seed=1)),
    "export_controller": _exported,
    "c2d": lambda m, ss, p: (m.c2d(_stable(ss), 0.05), m.c2d(_stable(ss), 0.05, "tustin")),
}


def _same(got, want, where="result"):
    """got (the port's) equals want (the JAX package's) to TOL relative."""
    if hasattr(want, "A") and hasattr(want, "D"):
        assert type(got).__name__ == type(want).__name__, where
        for k in "ABCD":
            _same(getattr(got, k), getattr(want, k), f"{where}.{k}")
    elif isinstance(want, dict):
        assert sorted(got) == sorted(want), where
        for k in want:
            _same(got[k], want[k], f"{where}[{k!r}]")
    elif isinstance(want, (tuple, list)):
        assert isinstance(got, (tuple, list)) and len(got) == len(want), where
        for i, (g, w) in enumerate(zip(got, want)):
            _same(g, w, f"{where}[{i}]")
    elif isinstance(want, str):
        assert got == want, where
    else:
        got, want = np.asarray(got), np.asarray(want)
        assert got.shape == want.shape and got.dtype.kind == want.dtype.kind, where
        if want.dtype.kind in "biu":
            assert np.array_equal(got, want), where
            return
        fin = np.isfinite(want)
        assert np.array_equal(fin, np.isfinite(got)) and np.array_equal(got[~fin], want[~fin]), where
        scale = max(np.abs(want[fin]).max(initial=0.0), 1e-300)
        assert np.abs(got[fin] - want[fin]).max(initial=0.0) <= TOL * scale, where


@pytest.mark.parametrize("name", sorted(set(ltc_t.__all__) | {"dlqg_regulator"}))
def test_torch_lticontrol_name_matches_jax(name, tmp_path):
    assert ltc_t.__all__ == ltc_j.__all__
    case = CASES[name]
    got = case(ltc_t, SST, tmp_path / "port.mat")
    want = case(ltc_j, SSJ, tmp_path / "jax.mat")
    _same(got, want, name)


# ── .mat files across the packages ──────────────────────────────────────────


@pytest.mark.parametrize("writer,reader", [("jax", "port"), ("port", "jax")])
def test_torch_lticontrol_mat_files_cross(writer, reader, tmp_path):
    (mw, ssw), (mr, ssr) = PACKAGES[writer], PACKAGES[reader]
    g = _stable(ssw)
    mw.write_ss(g, tmp_path / "g.mat")
    back = mr.read_ss(tmp_path / "g.mat")
    assert isinstance(back, ssr)
    for k in "ABCD":
        assert np.array_equal(getattr(back, k), getattr(g, k)), k
    mw.export_controller(tmp_path / "k.mat", g, dt=0.05)
    d = mr.read_matfile(tmp_path / "k.mat")
    assert d["dt"].item() == 0.05 and np.array_equal(d["A"], g.A)
    assert d["mag"].shape == (200, 3, 2)


# ── dlqg_regulator's fault, kept in both packages ───────────────────────────


@pytest.mark.parametrize("package", sorted(PACKAGES))
def test_torch_dlqg_regulator_fault_reproduced(package):
    """The sampled closed loop of dlqg_regulator's compensator with a plant
    pole at 30 (|λ| dt = 0.6), dt = 0.02: spectral radius 1.0085 (unstable);
    the predictor gain Ad L in the same compensator gives a stable loop.
    The plant is tests/test_lticontrol.py's sampled-stability plant with its
    damped pair replaced by the poles 30 and -0.4."""
    m, ss = PACKAGES[package]
    rng = np.random.default_rng(3)
    b, c = rng.standard_normal((4, 1)), rng.standard_normal((2, 4))
    a = np.array([[0.2, 1.5, 0, 0], [-1.5, 0.2, 0, 0], [0, 0, 30.0, 0], [0, 0, 0, -0.4]])
    dt = 0.02
    kd, f, l_filter = m.dlqg_regulator(m.ss(a, b, c, np.zeros((2, 1))), dt, rv=0.1)
    ad, bd, cd, _ = (np.asarray(x) for x in m.c2d(m.ss(a, b, c, np.zeros((2, 1))), dt))

    def radius(l_gain):
        kb, ka = l_gain, ad - bd @ f - l_gain @ cd
        return np.abs(np.linalg.eigvals(np.block([[ad, -bd @ f], [kb @ cd, ka]]))).max()

    assert np.array_equal(np.asarray(kd.B), l_filter)
    assert abs(radius(l_filter) - 1.0085) <= 1e-4
    assert radius(ad @ l_filter) < 1.0
