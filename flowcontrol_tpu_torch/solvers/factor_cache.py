"""Disk cache for expensive one-time factorization byproducts.

The counterpart of ``flowcontrol_tpu/solvers/factor_cache.py``, a copy
(numpy only), with the same environment names, key and entry format, so one
setting governs both packages and an entry written by either serves the
other where their contents agree (the multifrontal solve's primary entry:
``solvers/multifrontal.py``).

The reference pays its setup cost (MUMPS symbolic+numeric factorization,
ref: src/flowcontrol/flowsolver.py:665-701) on every run; the port's largest
setup cost is the multifrontal solve's host factorization. Entries are keyed
by a content hash of the BC-eliminated matrix plus the factorization
parameters, so a restarted campaign on the same mesh/dt warm-starts.

Cache location: ``FLOWCONTROL_TPU_FACTOR_CACHE`` (``off`` disables),
default ``~/.cache/flowcontrol_tpu/factors``. Total size is capped
(LRU by mtime; ``FLOWCONTROL_TPU_FACTOR_CACHE_GB``, default 20): entries
at production scale run to GBs each, and an uncapped cache fills a disk
in a week of mesh experiments.
"""

from __future__ import annotations

import hashlib
import logging
import os
import shutil
import tempfile
import threading
from pathlib import Path

import numpy as np

logger = logging.getLogger(__name__)


def cache_dir() -> Path | None:
    d = os.environ.get(
        "FLOWCONTROL_TPU_FACTOR_CACHE",
        os.path.join(
            os.path.expanduser("~"), ".cache", "flowcontrol_tpu", "factors"
        ),
    )
    if not d or d.lower() == "off":
        return None
    p = Path(d)
    try:
        p.mkdir(parents=True, exist_ok=True)
    except OSError:
        return None
    return p


def matrix_key(a_csr, *extras) -> str:
    """Content hash of a CSR matrix + parameter strings."""
    h = hashlib.sha256()
    h.update(np.asarray(a_csr.shape, dtype=np.int64).tobytes())
    h.update(np.ascontiguousarray(a_csr.indptr).tobytes())
    h.update(np.ascontiguousarray(a_csr.indices).tobytes())
    h.update(np.ascontiguousarray(a_csr.data).tobytes())
    for e in extras:
        h.update(repr(e).encode())
    return h.hexdigest()[:24]


def cache_cap_bytes() -> int:
    gb = float(os.environ.get("FLOWCONTROL_TPU_FACTOR_CACHE_GB", "20"))
    return int(gb * 2**30)


def _entry_size(p: Path) -> int:
    if p.is_dir():
        return sum(f.stat().st_size for f in p.iterdir())
    return p.stat().st_size


def _evict(p: Path) -> None:
    if p.is_dir():
        shutil.rmtree(p, ignore_errors=True)
    else:
        p.unlink()


def _enforce_cap(d: Path) -> None:
    """Evict oldest-touched entries until the cache fits the size cap."""
    try:
        entries = sorted(
            (
                (p.stat().st_mtime, _entry_size(p), p)
                for p in d.iterdir()
                if p.suffix == ".npz"
                or (p.is_dir() and not p.name.endswith(".tmp"))
            ),
            reverse=True,  # newest first
        )
    except OSError:
        return
    cap = cache_cap_bytes()
    total = 0
    for mtime, size, f in entries:
        total += size
        if total > cap:
            try:
                _evict(f)
                logger.info(
                    "factor cache evict (%.1f GB over %.0f GB cap): %s",
                    total / 2**30, cap / 2**30, f,
                )
            except OSError:
                pass


def entry_dir(key: str) -> Path | None:
    """Directory of a raw-.npy cache entry, or None. Callers that stream
    (load one array, hand it to the device, load the next) read the files
    themselves — overlapping fread with the H2D transfer instead of
    paying fread-then-upload sequentially (see MultifrontalLU)."""
    d = cache_dir()
    if d is None:
        return None
    p = d / key
    if p.is_dir():
        p.touch()  # mark recently-used for LRU eviction
        return p
    return None


def load(key: str) -> dict | None:
    d = cache_dir()
    if d is None:
        return None
    # current format: a directory of raw .npy files — one fread each, so
    # multi-GB factor payloads load at page-cache/disk speed. The legacy
    # single-.npz format read the same bytes through zipfile at ~60 MB/s
    # (measured 39 s for a 2.4 GB entry, warm) — kept readable below.
    p = d / key
    if p.is_dir():
        try:
            out = {
                f.stem: np.load(f, allow_pickle=False)
                for f in sorted(p.glob("*.npy"))
            }
            if not out:
                return None
            p.touch()  # mark recently-used for LRU eviction
            logger.info("factor cache hit: %s", p)
            return out
        except Exception:  # truncated/corrupt entry: treat as miss
            logger.warning("factor cache entry unreadable, ignoring: %s", p)
            return None
    f = d / f"{key}.npz"
    if not f.exists():
        return None
    try:
        with np.load(f) as z:
            out = {k: z[k] for k in z.files}
        logger.info("factor cache hit (legacy npz): %s", f)
        # opportunistic upgrade: rewrite in the fast .npy-directory format
        # and drop the zip, so the slow path is paid at most once per entry
        try:
            save(key, **out)
            f.unlink()
        except OSError:
            pass
        return out
    except Exception:
        logger.warning("factor cache entry unreadable, ignoring: %s", f)
        return None


_inflight: list = []
_inflight_lock = threading.Lock()


def save_async(key: str, **arrays: np.ndarray):
    """Run :func:`save` on a background thread (atomic publish makes this
    safe; callers must not mutate the passed arrays). Non-daemon, so the
    interpreter joins it at shutdown and the entry always lands. Use
    :func:`flush` to wait for pending stores (tests, benchmarks)."""
    t = threading.Thread(
        target=save, args=(key,), kwargs=arrays, name=f"fc-save-{key[:8]}"
    )
    with _inflight_lock:
        # prune finished stores so long campaigns that never call flush()
        # do not accumulate dead Thread objects
        _inflight[:] = [x for x in _inflight if x.is_alive()]
        _inflight.append(t)
    t.start()
    return t


def flush() -> None:
    """Block until every pending :func:`save_async` store has published."""
    while True:
        with _inflight_lock:
            if not _inflight:
                return
            t = _inflight.pop()
        t.join()


def save(key: str, **arrays: np.ndarray) -> None:
    d = cache_dir()
    if d is None:
        return
    final = d / key
    # atomic publish: write into a temp dir, rename into place (concurrent
    # runs may race on the same entry — first writer wins)
    tmp = Path(tempfile.mkdtemp(dir=d, suffix=".tmp"))
    try:
        for name, arr in arrays.items():
            np.save(tmp / f"{name}.npy", np.asarray(arr), allow_pickle=False)
        try:
            os.replace(tmp, final)
        except OSError:  # entry appeared concurrently — keep theirs
            shutil.rmtree(tmp, ignore_errors=True)
        logger.info("factor cache store: %s", final)
        _enforce_cap(d)
    except OSError:
        shutil.rmtree(tmp, ignore_errors=True)
