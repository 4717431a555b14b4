"""CUDA graphs of the Stepper's compiled entry points.

The JAX package compiles its step with ``jax.jit`` and its rollouts with
``lax.scan``: the host dispatches a whole step, or a whole rollout, once.
The port's counterpart is a CUDA graph (``torch.cuda.CUDAGraph``): the
step's kernels (K1, F, K2, P1, K3 and torch's own) are captured once over
fixed tensors and replayed with one launch.

A :class:`Program` is a body of torch operations and kernel launches that
reads and writes fixed tensors (the caller copies inputs into them before
a run and reads outputs after it). On the CPU a run calls the body. On
CUDA the first run calls the body on the program's side stream, as a real
run that also does every one-time thing (the kernels' builds and library
loads, F's grid set-up, K1's arrival counters, cuBLAS's workspace for that
stream), then captures the body into a graph; every later run replays the
graph on the current stream. A capture that fails raises: nothing falls
back to the eager body.

The kernel wrappers count their launches in Python, which a replay does
not run. So a capture records how many launches of each counted wrapper
(``ops/cuda_build.COUNTED``) it saw, takes them back off the counts (a
capture launches nothing), and every replay adds them again.
"""

from __future__ import annotations

from typing import Callable

import torch

from flowcontrol_tpu_torch.ops.cuda_build import COUNTED


class Program:
    """``body()`` run eagerly on the CPU and as a captured CUDA graph on
    CUDA (eagerly there too with ``graphed=False``: a body whose loop
    length the host decides, as the Krylov solves' residual loop).
    ``stream`` (a side stream) and ``pool`` (a graph memory pool) may be
    shared by the programs of one Stepper, which runs them one at a time.
    ``fixed`` holds the tensors the body reads and writes (the caller's
    inputs and outputs), alive for as long as the program."""

    def __init__(self, body: Callable, device: torch.device, stream=None, pool=None,
                 fixed=None, graphed: bool = True):
        self.body = body
        self.device = device
        self.graphed = graphed
        self.stream = stream
        self.pool = pool
        self.fixed = fixed
        self.graph: torch.cuda.CUDAGraph | None = None
        #: the body's return value as captured: the graph writes it anew on
        #: every replay
        self.outputs = None
        #: launches of each counted wrapper in one replay
        self.counts: dict = {}
        #: bytes the capture added to the memory pool
        self.pool_bytes = 0
        #: graph replays so far
        self.replays = 0

    def run(self):
        """One run of the body; returns what the body returns (on CUDA
        after the first run: the captured outputs, which the next run
        overwrites)."""
        if self.device.type != "cuda" or not self.graphed:
            return self.body()
        if self.graph is None:
            return self._warm_up_and_capture()
        self.graph.replay()
        self.replays += 1
        for fn, k in self.counts.items():
            fn.launches += k
        return self.outputs

    def _warm_up_and_capture(self):
        cur = torch.cuda.current_stream(self.device)
        s = self.stream if self.stream is not None else torch.cuda.Stream(self.device)
        s.wait_stream(cur)
        with torch.cuda.stream(s):
            out = self.body()  # the warm-up: a real run, counted as such
            before = [fn.launches for fn in COUNTED]
            graph = torch.cuda.CUDAGraph()
            with torch.cuda.graph(graph, pool=self.pool, stream=s):
                # (read inside: entering the capture empties torch's cache)
                reserved = torch.cuda.memory_reserved(self.device)
                self.outputs = self.body()
                self.pool_bytes = torch.cuda.memory_reserved(self.device) - reserved
            self.counts = {fn: fn.launches - b for fn, b in zip(COUNTED, before)
                           if fn.launches != b}
            for fn, b in zip(COUNTED, before):
                fn.launches = b
        cur.wait_stream(s)
        self.graph = graph
        return out
