"""The port's ``utils/signal.py`` against the JAX package's, on the CPU.

- The oracles of ``tests/test_signal.py`` (dominant frequency, LCO
  sampling, padding and saturation, the multisine's flat spectrum, crest
  factor and tiling, the streaming generator, the one-line JSON lists),
  each of its test functions run with the names it imports swapped for the
  port's.
- Every function and class against the JAX package's with equal ``rng``
  seeds: the same values (bitwise: the same numpy calls in the same order).
- ``plotsignal`` writes its two figures (matplotlib imported on call).
"""

import json

import numpy as np
import pytest

import flowcontrol_tpu.utils.signal as sig_j
import flowcontrol_tpu_torch.utils.signal as sig_t
import test_signal as oracles

ORACLES = sorted(n for n in dir(oracles) if n.startswith("test_"))


@pytest.mark.parametrize("name", ORACLES)
def test_torch_signal_oracles(name, monkeypatch):
    for k in vars(oracles).copy():
        if getattr(sig_j, k, None) is getattr(oracles, k) and not k.startswith("_"):
            monkeypatch.setattr(oracles, k, getattr(sig_t, k))
    assert oracles.multisine is sig_t.multisine
    getattr(oracles, name)()


def _rng():
    return np.random.default_rng(12)


CASES = {
    "compute_signal_frequency": lambda m: m.compute_signal_frequency(
        np.sin(2 * np.pi * 0.9 * np.arange(0, 30, 0.02)) + 0.1 * _rng().standard_normal(1500),
        30.0, 0.02, nzp=8),
    "sample_lco": lambda m: m.sample_lco(3.0, 11.0, 7),
    "pad_upto": lambda m: (m.pad_upto([1, 2], 5, v=3), m.pad_upto(np.arange(3.0), 6)),
    "saturate": lambda m: [m.saturate(x, -1.0, 2.0) for x in (-3.0, 0.5, 7.0)],
    "crest_factor": lambda m: m.crest_factor(_rng().standard_normal(100)),
    "multisine": lambda m: m.multisine(200, 20.0, 0.05, 0.6, skip_even=True, opt_cf=5,
                                       include_fbounds=False, rng=_rng()),
    "multisine_MP": lambda m: m.multisine_MP(3, 2, N=64, Fs=4.0, fmin=0.1, fmax=0.9, rng=_rng()),
    "multisine_batch": lambda m: m.multisine_batch(4, 3, N=32, Fs=2.0, fmin=0.0, fmax=1.0,
                                                   opt_cf=2, rng=_rng()),
    "MultisineGenerator": lambda m: (
        m.MultisineGenerator(N=64, Fs=8.0, fmin=0.1, fmax=0.9, skip_even=1,
                             rng=_rng()).generate(np.linspace(0, 5, 41)),
        m.MultisineGenerator.compute_spectrum(50, 5.0, 0.2, 0.8),
        m.MultisineGenerator.compute_harmonics(0.3, 12, 4.0, fmax=0.9, skip_even=1),
        m.MultisineGenerator(N=8, Fs=1.0, freqsin=[0.1, 0.2], phi=[0.5, 1.0]).generate(2.5)),
    "MyEncoder": lambda m: json.dumps(
        {"a": m.NoIndent([1, 2.5, "x"]), "b": {"c": m.NoIndent((3, 4)), "d": np.float64(0.25)},
         "e": [np.int64(7)]}, cls=m.MyEncoder, indent=2, sort_keys=True),
}


@pytest.mark.parametrize("name", sorted(CASES))
def test_torch_signal_matches_jax(name):
    got, want = CASES[name](sig_t), CASES[name](sig_j)
    if isinstance(want, str):
        assert got == want
    else:
        for g, w in zip(got if isinstance(got, tuple) else (got,),
                        want if isinstance(want, tuple) else (want,)):
            assert np.array_equal(np.asarray(g), np.asarray(w))


def test_torch_signal_noindent_refuses_scalars():
    with pytest.raises(TypeError):
        sig_t.NoIndent(3)
    with pytest.raises(TypeError):
        sig_t.pad_upto((1, 2), 4)


def test_torch_signal_plotsignal_writes_figures(tmp_path):
    y = sig_t.multisine(128, 10.0, 0.1, 0.5, rng=_rng())
    sig_t.plotsignal(y, 10.0, Fmin=0.5, Fmax=2.5, path_prefix=tmp_path / "ms")
    for part in ("time", "freq"):
        assert (tmp_path / f"ms_{part}.png").stat().st_size > 1000
