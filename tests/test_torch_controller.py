"""The port's Controller and state-space utilities against the JAX package's.

Both are host numpy: the same seeded matrices go through
``flowcontrol_tpu.utils.statespace`` / ``flowcontrol_tpu.core.controller``
and their copies in the port, and the results are compared bitwise
(``np.array_equal``: the port's copies are transcriptions, the same numpy
calls in the same order).
"""

import numpy as np
import pytest

from flowcontrol_tpu.core import controller as cj
from flowcontrol_tpu.utils import statespace as sj
from flowcontrol_tpu_torch.core import controller as ct
from flowcontrol_tpu_torch.utils import statespace as st


def _mats(seed, nx=4, nu=2, ny=2):
    rng = np.random.default_rng(seed)
    a = rng.standard_normal((nx, nx)) - 2.0 * np.eye(nx)
    return a, rng.standard_normal((nx, nu)), rng.standard_normal((ny, nx)), rng.standard_normal(
        (ny, nu))


def _same(got, ref):
    return all(np.array_equal(np.asarray(g), np.asarray(r)) for g, r in zip(got, ref))


def _abcd(s):
    return s.A, s.B, s.C, s.D


@pytest.mark.parametrize("seed,dt", [(0, 0.005), (1, 0.05), (2, 1.0)])
def test_torch_c2d_zoh_bitwise(seed, dt):
    m = _mats(seed)
    assert _same(st.c2d_zoh(st.StateSpace(*m), dt), sj.c2d_zoh(sj.StateSpace(*m), dt))


def test_torch_c2d_zoh_singular_a():
    m = (np.zeros((2, 2)), np.eye(2), np.eye(2), np.zeros((2, 2)))
    ad, bd, _, _ = st.c2d_zoh(st.ss(*m), 0.1)
    assert _same((ad, bd), sj.c2d_zoh(sj.ss(*m), 0.1)[:2])
    assert np.allclose(ad, np.eye(2)) and np.allclose(bd, 0.1 * np.eye(2))


@pytest.mark.parametrize("seed", [3, 4])
def test_torch_ss_inv_and_algebra_bitwise(seed):
    m, m2 = _mats(seed), _mats(seed + 10)
    gt, gj = st.StateSpace(*m), sj.StateSpace(*m)
    ht, hj = st.StateSpace(*m2), sj.StateSpace(*m2)
    assert _same(_abcd(st.ss_inv(gt)), _abcd(sj.ss_inv(gj)))
    assert _same(_abcd(gt + ht), _abcd(gj + hj))
    assert _same(_abcd(gt * ht), _abcd(gj * hj))
    assert _same(_abcd(2.0 * gt), _abcd(2.0 * gj))
    assert _same(_abcd(gt.feedback()), _abcd(gj.feedback()))
    w = np.array([0.3, 1.7, 20.0])
    assert np.array_equal(gt.frequency_response(w), gj.frequency_response(w))
    assert np.array_equal(np.sort_complex(gt.poles()), np.sort_complex(gj.poles()))


@pytest.mark.parametrize("seed,dt", [(5, 0.005), (6, 0.02)])
def test_torch_controller_step_bitwise(seed, dt):
    m = _mats(seed)
    kt, kj = ct.Controller.from_matrices(*m), cj.Controller.from_matrices(*m)
    ys = np.random.default_rng(seed).standard_normal((6, 2))
    for y in ys:
        assert np.array_equal(kt.step(y, dt), kj.step(y, dt))
        assert np.array_equal(kt.x, kj.x)
    kt.reset()
    assert np.array_equal(kt.x, np.zeros(4))


@pytest.mark.parametrize("native_dt", [None, 0.01])
def test_torch_controller_discrete_bitwise(native_dt):
    """``discrete``: ZOH of a continuous controller; the stored matrices
    verbatim for a discrete-native one, which refuses another dt."""
    m = _mats(7)
    kt = ct.Controller.from_matrices(*m, dt=native_dt)
    kj = cj.Controller.from_matrices(*m, dt=native_dt)
    got, ref = kt.discrete(0.01, dtype=np.float32), kj.discrete(0.01, dtype=np.float32)
    assert _same(got, ref) and all(g.dtype == np.float32 for g in got)
    assert _same(kt.discrete(0.01), kj.discrete(0.01))
    if native_dt is not None:
        assert _same(kt.discrete(0.01), m)
        with pytest.raises(ValueError):
            kt.step(np.zeros(2), 0.02)


def test_torch_controller_algebra_keeps_type_and_state():
    m, m2 = _mats(8), _mats(9)
    kt1, kt2 = ct.Controller.from_matrices(*m, x0=np.arange(4.0)), ct.Controller.from_matrices(*m2)
    kj1, kj2 = cj.Controller.from_matrices(*m, x0=np.arange(4.0)), cj.Controller.from_matrices(*m2)
    for op in (lambda a, b: a + b, lambda a, b: a * b):
        rt, rj = op(kt1, kt2), op(kj1, kj2)
        assert isinstance(rt, ct.Controller)
        assert _same(_abcd(rt), _abcd(rj)) and np.array_equal(rt.x, rj.x)
    assert _same(_abcd(kt1.inv()), _abcd(kj1.inv())) and isinstance(kt1.inv(), ct.Controller)


def test_torch_stack_controllers_bitwise():
    dt = 0.005
    gains = np.linspace(0.5, 1.5, 5)
    m = _mats(11)
    got = ct.stack_controllers([g * ct.Controller.from_matrices(*m) for g in gains], dt)
    ref = cj.stack_controllers([g * cj.Controller.from_matrices(*m) for g in gains], dt)
    assert _same(got, ref)
    assert got[0].shape == (5, 4, 4) and got[3].shape == (5, 2, 2)
    assert all(g.dtype == np.float32 for g in got)


def test_torch_controller_matfile_round_trip(tmp_path):
    """A file written by one package reads back in the other, bitwise; the
    optional ``dt`` marks a discrete-native artifact."""
    import scipy.io as sio

    m = _mats(12)
    ct.write_matfile(tmp_path / "t.mat", st.StateSpace(*m))
    cj.write_matfile(tmp_path / "j.mat", sj.StateSpace(*m))
    for f in ("t.mat", "j.mat"):
        kt, kj = ct.Controller.from_file(tmp_path / f), cj.Controller.from_file(tmp_path / f)
        assert _same(_abcd(kt), m) and _same(_abcd(kj), m)
        assert kt.native_dt is None and kt.file == tmp_path / f
    sio.savemat(tmp_path / "d.mat", dict(zip("ABCD", m), dt=0.01))
    assert ct.Controller.from_file(tmp_path / "d.mat").native_dt == 0.01
    assert ct.read_matfile(tmp_path / "d.mat")["dt"] == cj.read_matfile(tmp_path / "d.mat")["dt"]
    sio.savemat(tmp_path / "bad.mat", {"A": m[0]})
    with pytest.raises(KeyError):
        ct.read_matfile(tmp_path / "bad.mat")
