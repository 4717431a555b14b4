"""Profiling helpers: per-step timing (reference parity) and device traces.

The counterpart of ``flowcontrol_tpu/utils/profiling.py``. The reference
measures wall time per step into the timeseries ``runtime`` column and
summarizes it with ``utils.fem.summarize_timings`` (ref: SURVEY §5.1); both
exist here. ``trace`` records a ``torch.profiler`` trace (host, and the
card's kernels and copies where there is one) where the JAX package records
a ``jax.profiler`` one, and ``device_memory_stats`` reads
``torch.cuda.memory_stats``.
"""

from __future__ import annotations

import contextlib
import tempfile
import time
from pathlib import Path

import torch

from flowcontrol_tpu_torch.config import require_device


@contextlib.contextmanager
def trace(logdir: str | None = None):
    """Capture a ``torch.profiler`` trace around a code block and write it
    as a Chrome trace, ``<logdir>/trace.json`` (open it in Perfetto or
    chrome://tracing). ``logdir`` defaults to ``flowcontrol_tpu_torch_trace``
    in the temporary directory (the JAX package's default is a fixed
    ``/tmp`` path). Yields ``logdir``."""
    from torch.profiler import ProfilerActivity, profile

    logdir = Path(logdir or Path(tempfile.gettempdir()) / "flowcontrol_tpu_torch_trace")
    logdir.mkdir(parents=True, exist_ok=True)
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities) as prof:
        yield str(logdir)
        if torch.cuda.is_available():
            torch.cuda.synchronize()
    prof.export_chrome_trace(str(logdir / "trace.json"))


@contextlib.contextmanager
def timed(label: str, results: dict | None = None):
    """Wall-time a block (host side), storing into ``results[label]``."""
    t0 = time.time()
    yield
    dt = time.time() - t0
    if results is not None:
        results[label] = dt


def device_memory_stats(device="cuda") -> dict:
    """``torch.cuda.memory_stats`` of every visible card, keyed
    ``'cuda:<i>'``; ``{}`` for ``device="cpu"`` (torch keeps no such
    statistics for the host). Raises ``RuntimeError`` when a card is asked
    for and torch sees none (the JAX function takes no argument and reads
    every device JAX sees)."""
    if require_device(device).type != "cuda":
        return {}
    return {f"cuda:{i}": torch.cuda.memory_stats(i) for i in range(torch.cuda.device_count())}
