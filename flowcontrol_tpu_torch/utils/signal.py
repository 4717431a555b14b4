"""Signal processing and multisine generation for system identification.

A numpy transcription of ``flowcontrol_tpu/utils/signal.py`` (ref:
src/utils/signal.py): dominant-frequency estimation, LCO sampling,
flat-spectrum multisine excitation with crest-factor optimization, M×P
realization tiling, a streaming per-sample generator, and single-line JSON
list encoding helpers. Random phases are drawn from the ``rng`` argument
exactly as there, so equal seeds give equal signals in both packages.
``multisine_batch`` gives a (M, N·P) bank of excitations for a batched
open-loop rollout (``Stepper.rollout_open_loop`` with a (T, M, n_act)
control sequence). matplotlib is imported inside ``plotsignal`` only.
"""

from __future__ import annotations

import json
import re

import numpy as np


# ── Array utilities (ref: signal.py:17-80) ───────────────────────────────────


def compute_signal_frequency(sig, Tf: float, dt: float, nzp: int = 10) -> float:
    """Dominant frequency of a periodic signal via zero-padded FFT.

    The first half of the record (transient) is discarded
    (ref: signal.py:17-44)."""
    start = int((Tf / 2) / dt)
    s = np.asarray(sig)[start:]
    s = s - s.mean()
    fs = 1.0 / dt
    nn = len(s) * nzp
    spec = np.abs(np.fft.rfft(s, nn))
    freqs = np.fft.rfftfreq(nn, d=dt)
    return float(freqs[np.argmax(spec)])


def sample_lco(Tlco: float, Tstartlco: float, nsim: int) -> np.ndarray:
    """nsim sampling times spread over one LCO period (ref: signal.py:47-64)."""
    return Tstartlco + Tlco / nsim * np.arange(nsim)


def pad_upto(L, N: int, v=0):
    """Pad list or array up to N elements with value v (ref: signal.py:67-75)."""
    if isinstance(L, list):
        return L + (N - len(L)) * [v]
    if isinstance(L, np.ndarray):
        return np.pad(L, (0, N - L.shape[0]), constant_values=v)
    raise TypeError("Type not supported for padding")


def saturate(x, xmin, xmax):
    """Clamp scalar x to [xmin, xmax] (ref: signal.py:78-80)."""
    return xmin if x < xmin else xmax if x > xmax else x


def crest_factor(y) -> float:
    """max|y| / rms(y)."""
    y = np.asarray(y)
    return float(np.max(np.abs(y)) / np.sqrt(np.mean(y**2)))


# ── Multisine (ref: signal.py:92-186) ────────────────────────────────────────


def _frequency_grid(N, Fs, fmin, fmax, skip_even, include_fbounds):
    f_lo = max(fmin, 0.0) * Fs / 2
    f_hi = min(fmax, 1.0) * Fs / 2
    step = 2 if skip_even else 1
    start = 1 if skip_even else 0
    freqs = np.arange(start, N + start, step) * Fs / N
    if include_fbounds:
        mask = (freqs >= f_lo) & (freqs <= f_hi)
    else:
        mask = (freqs > f_lo) & (freqs < f_hi)
    return freqs[mask]


def multisine(
    N: int,
    Fs: float,
    fmin: float,
    fmax: float,
    skip_even: bool = False,
    opt_cf: int = 0,
    include_fbounds: bool = True,
    rng=None,
) -> np.ndarray:
    """One period of a flat-spectrum multisine over [fmin, fmax]·Fs/2.

    ``opt_cf`` random-phase retries keep the realization with the lowest
    crest factor (ref: signal.py:92-160).
    """
    rng = np.random.default_rng() if rng is None else rng
    freqs = _frequency_grid(N, Fs, fmin, fmax, skip_even, include_fbounds)
    nf = len(freqs)
    t = np.linspace(0, (N - 1) / Fs, N)

    def realization():
        phi = 2 * np.pi * rng.random(nf)
        return np.sin(2 * np.pi * freqs[:, None] * t[None, :] + phi[:, None]).sum(
            axis=0
        ) / np.sqrt(nf)

    y = realization()
    best = crest_factor(y)
    for _ in range(int(opt_cf)):
        y2 = realization()
        cf = crest_factor(y2)
        if cf < best:
            y, best = y2, cf
    return y


def multisine_MP(M: int, P: int, unwrap: bool = True, **kwargs):
    """M independent realizations tiled over P periods (ref: signal.py:163-186)."""
    yy = np.stack([multisine(**kwargs) for _ in range(M)])
    yy = np.tile(yy, (1, P))
    return yy.ravel() if unwrap else yy


def multisine_batch(M: int, P: int, **kwargs) -> np.ndarray:
    """(M, N·P) excitation bank for batched system-ID rollouts."""
    return multisine_MP(M, P, unwrap=False, **kwargs)


class MultisineGenerator:
    """Streaming multisine: evaluate at any t without storing the signal
    (ref: signal.py:226-288). Periodic with the grid's fundamental."""

    def __init__(
        self, N, Fs, fmin=0.0, fmax=1.0, skip_even=0, include_fbounds=1,
        freqsin=None, phi=None, rng=None,
    ):
        if freqsin is None:
            freqsin = self.compute_spectrum(
                N=N, Fs=Fs, fmin=fmin, fmax=fmax,
                skip_even=skip_even, include_fbounds=include_fbounds,
            )
        freqsin = np.asarray(freqsin, dtype=float)
        rng = np.random.default_rng() if rng is None else rng
        if phi is None:
            phi = 2 * np.pi * rng.random(freqsin.shape)
        self.nfreq = len(freqsin)
        self.Fs = Fs
        self.freqsin = freqsin
        self.phi = np.asarray(phi, dtype=float)

    @staticmethod
    def compute_spectrum(N, Fs, fmin=0.0, fmax=1.0, skip_even=0, include_fbounds=1):
        return _frequency_grid(N, Fs, fmin, fmax, skip_even, include_fbounds)

    @staticmethod
    def compute_harmonics(f0, nharm, Fs, fmin=0.0, fmax=1.0, skip_even=0,
                          include_fbounds=1):
        f_lo = max(fmin, 0.0) * Fs / 2
        f_hi = min(fmax, 1.0) * Fs / 2
        step = 2 if skip_even else 1
        start = 1 if skip_even else 0
        freqs = f0 * np.arange(start, nharm + start, step)
        if include_fbounds:
            mask = (freqs >= f_lo) & (freqs <= f_hi)
        else:
            mask = (freqs > f_lo) & (freqs < f_hi)
        return freqs[mask]

    def generate(self, t, vectorized: bool = True):
        """Signal value at time t (scalar or array)."""
        t = np.asarray(t)
        val = np.sin(
            2 * np.pi * self.freqsin * t[..., None] + self.phi
        ).sum(axis=-1)
        return val / np.sqrt(self.nfreq)


# ── JSON helpers (ref: signal.py:294-341) ────────────────────────────────────


class NoIndent:
    """Wrap a list/tuple so MyEncoder emits it on a single line."""

    def __init__(self, value):
        if not isinstance(value, (list, tuple)):
            raise TypeError("Only lists and tuples can be wrapped")
        self.value = value


class MyEncoder(json.JSONEncoder):
    """JSON encoder serializing NoIndent-wrapped lists on one line."""

    FORMAT_SPEC = "@@{}@@"
    regex = re.compile(FORMAT_SPEC.format(r"(\d+)"))

    def __init__(self, **kwargs):
        ignore = {"cls", "indent"}
        self._kwargs = {k: v for k, v in kwargs.items() if k not in ignore}
        self._registry = {}
        super().__init__(**kwargs)

    def default(self, obj):
        if isinstance(obj, np.generic):
            return obj.item()
        if isinstance(obj, NoIndent):
            key = id(obj)
            self._registry[key] = obj
            return self.FORMAT_SPEC.format(key)
        return super().default(obj)

    def iterencode(self, obj, **kwargs):
        self._registry.clear()
        for encoded in super().iterencode(obj, **kwargs):
            match = self.regex.search(encoded)
            if match:
                obj_id = int(match.group(1))
                json_repr = json.dumps(self._registry[obj_id].value, **self._kwargs)
                encoded = encoded.replace(
                    '"{}"'.format(self.FORMAT_SPEC.format(obj_id)), json_repr
                )
            yield encoded
        self._registry.clear()


def plotsignal(y, Fs, t=None, Fmin=None, Fmax=None, path_prefix=None):
    """Plot a signal in time and frequency domains (ref: signal.py:194-224).

    Headless-safe: with ``path_prefix`` given (or no display), figures are
    saved as ``<prefix>_time.png`` / ``<prefix>_freq.png`` instead of shown.
    """
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    y = np.asarray(y)
    n = len(y)
    if t is None:
        t = np.linspace(0, (n - 1) / Fs, n)
    fig1, ax = plt.subplots()
    ax.plot(t, y)
    ax.set_title("Sum of sines")
    ax.set_xlabel("Time (s)")
    fig1.tight_layout()

    mm = 10 * n
    xx = np.fft.fft(y, n) / np.sqrt(n)
    xx_zp = np.fft.fft(y, mm) / np.sqrt(n)
    ff = np.arange(n) * Fs / n
    ff_zp = np.arange(mm) * Fs / mm
    fig2, ax = plt.subplots()
    ax.stem(ff, np.abs(xx))
    ax.plot(ff_zp, np.abs(xx_zp), alpha=0.2, color="r")
    if Fmin is not None and Fmax is not None:
        for xline in (Fmin, Fmax):
            ax.axvline(x=xline, color="k", linestyle="--")
    ax.set_xlabel("Frequency (Hz)")
    prefix = str(path_prefix) if path_prefix is not None else "signal"
    fig1.savefig(f"{prefix}_time.png", dpi=120)
    fig2.savefig(f"{prefix}_freq.png", dpi=120)
    plt.close(fig1)
    plt.close(fig2)
