"""A body of kernel launches captured once as a CUDA graph, then replayed.

The capture protocol of the port's CUDA graphs: the level loop of
``Executor.run(fuse=)`` (``regex/executor.FusedLevels``) and the
tensor-parallel bootstrap (``parallel/tensor.make_tp_pbs_fn``).  Both are
switched by one environment variable, FHE_REGEX_FUSE_LEVELS=0|1
(``forced_fuse``), which forces them off or on over their defaults.
"""

from __future__ import annotations

import os
import time
from typing import Callable, Dict, Optional

import torch

from fhe_regex_tpu_torch.ops import pbs_cuda


def forced_fuse() -> Optional[bool]:
    """FHE_REGEX_FUSE_LEVELS: "1" forces the port's CUDA graphs on, any
    other value off; None when it is unset (each graph's own default)."""
    env = os.environ.get("FHE_REGEX_FUSE_LEVELS")
    return None if env is None else env == "1"


class CapturedBody:
    """``body()``, a sequence of launches on ``device`` over tensors whose
    addresses stay fixed, run as one ``torch.cuda.CUDAGraph``.

    The first ``launch`` makes one warm-up pass of the body on a side
    stream, which computes that call's result (the kernels' shared-memory
    opt-in, cuFFT plans, cuBLAS and NCCL set-up happen there, since none
    may happen in a capture), empties the allocator's cache, then captures
    the body, which records and does not run it; every later ``launch``
    replays.  A capture that fails raises: nothing falls back to running
    the body eagerly.  The owner keeps alive every tensor the body reads
    or writes, since the graph holds their addresses.

    ``launches``: the kernel launches one replay makes, by wrapper (the
    capture's wrapper calls are taken back from the wrappers' counts, and
    each replay adds them, ``pbs_cuda.add_launches``); ``pool_bytes``:
    device memory the capture reserved, the graph's private pool;
    ``warmup_s`` and ``capture_s``: the warm-up pass, and capture with
    instantiation, in seconds."""

    def __init__(self, body: Callable[[], None], device: torch.device):
        self.body = body
        self.device = device
        self.graph = None
        self.launches: Dict[str, int] = {}
        self.pool_bytes = 0
        self.warmup_s = 0.0
        self.capture_s = 0.0

    def _capture(self) -> None:
        dev = self.device
        t0 = time.perf_counter()
        side = torch.cuda.Stream(dev)
        side.wait_stream(torch.cuda.current_stream(dev))
        with torch.cuda.stream(side):
            self.body()
        torch.cuda.current_stream(dev).wait_stream(side)
        torch.cuda.synchronize(dev)
        self.warmup_s = time.perf_counter() - t0
        torch.cuda.empty_cache()
        reserved = torch.cuda.memory_reserved(dev)
        graph = torch.cuda.CUDAGraph()
        before = pbs_cuda.launch_counts()
        t0 = time.perf_counter()
        try:
            with torch.cuda.graph(graph):
                self.body()
        finally:
            # the capture called the wrappers but launched nothing
            delta = pbs_cuda.launch_delta(before, pbs_cuda.launch_counts())
            pbs_cuda.add_launches(delta, -1)
        self.capture_s = time.perf_counter() - t0
        self.pool_bytes = torch.cuda.memory_reserved(dev) - reserved
        self.launches = delta
        self.graph = graph

    def launch(self) -> None:
        """The warm-up pass and the capture on the first call; a replay,
        with its launches added to the wrappers' counts, on every later
        one."""
        if self.graph is None:
            self._capture()
        else:
            self.graph.replay()
            pbs_cuda.add_launches(self.launches)
