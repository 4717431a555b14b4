"""Build and load the port's hand-written CUDA kernels.

Each kernel is a ``csrc/*.cu`` file with a plain C interface. On first use
it is compiled with ``nvcc`` for Hopper (``sm_90a``) into a shared library
and loaded with ``ctypes``; nothing is compiled when a module is imported,
so the package imports on machines without a CUDA toolkit. The library
lands in ``flowcontrol_tpu_torch/_build/`` (listed in ``.gitignore``) under
a name keyed by a hash of the sources and flags, so a changed source is
rebuilt and an unchanged one is reused.

Every kernel wrapper counts its launches in ``.launches`` (:func:`counted`);
:data:`COUNTED` lists them, so that a CUDA graph can add on each replay the
launches it captured (``core/graphs.py``).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path

_PKG = Path(__file__).resolve().parents[1]
CSRC_DIR = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"

NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v",
)

#: the kernel wrappers that count their launches (see :func:`counted`)
COUNTED: list = []


def counted(fn):
    """Give the kernel wrapper ``fn`` its launch count, ``fn.launches = 0``
    (the wrapper adds to it where it launches its kernel), and list it in
    :data:`COUNTED`."""
    fn.launches = 0
    COUNTED.append(fn)
    return fn


def find_nvcc() -> str:
    """``nvcc`` from ``$CUDA_HOME/bin``, the ``PATH`` or ``/usr/local/cuda``."""
    candidates = []
    if os.environ.get("CUDA_HOME"):
        candidates.append(os.path.join(os.environ["CUDA_HOME"], "bin", "nvcc"))
    candidates += [shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"]
    for c in candidates:
        if c and os.path.isfile(c) and os.access(c, os.X_OK):
            return c
    raise RuntimeError(
        "nvcc not found (looked in $CUDA_HOME/bin, PATH, /usr/local/cuda/bin): "
        "the CUDA kernels are built from source on first use"
    )


class CudaLibrary:
    """One ``csrc`` source compiled to a shared library, built and loaded
    on the first :meth:`get`. ``declare(lib)`` sets each C function's
    ``argtypes``/``restype``. After the first call, ``build_seconds`` is the
    compile time (0.0 when a built library was reused) and ``build_log``
    holds nvcc's output (``-Xptxas=-v``: registers, shared memory, spills).
    Threads may call :meth:`get` at once: one builds, the others wait.
    """

    def __init__(self, name: str, source: str, declare):
        self.name = name
        self.source = CSRC_DIR / source
        self._declare = declare
        self._lib = None
        self._lock = threading.Lock()
        self.build_seconds: float | None = None
        self.build_log = ""

    def library_path(self) -> Path:
        h = hashlib.sha256(self.source.read_bytes())
        h.update(" ".join(NVCC_FLAGS).encode())
        return BUILD_DIR / f"lib{self.name}-{h.hexdigest()[:16]}.so"

    def _build(self, out: Path) -> None:
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = out.with_name(f"{out.stem}.{os.getpid()}.tmp.so")
        cmd = [find_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(self.source)]
        t0 = time.perf_counter()
        proc = subprocess.run(cmd, capture_output=True, text=True)
        self.build_seconds = time.perf_counter() - t0
        self.build_log = proc.stdout + proc.stderr
        if proc.returncode != 0:
            raise RuntimeError(
                f"nvcc failed building {self.source.name} "
                f"(exit {proc.returncode}):\n{self.build_log}"
            )
        os.replace(tmp, out)  # atomic: a concurrent build never sees a partial file

    def get(self) -> ctypes.CDLL:
        with self._lock:
            if self._lib is None:
                out = self.library_path()
                if out.exists():
                    self.build_seconds = 0.0
                else:
                    self._build(out)
                lib = ctypes.CDLL(str(out))
                self._declare(lib)
                self._lib = lib
        return self._lib

