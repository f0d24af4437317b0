"""Dispatch watchdog: self-diagnosis for anomalous device launches.

Round 3 observed a one-off 1694 s fused-megarun dispatch whose fresh-process
repeats took 4.1 s (docs/BENCHMARKS.md round-3 anomaly note); the mitigation
(the FUSE_MAX_PBS cap) is kept, but the executor had no instrumentation that
would let a recurrence be *attributed* (relay stall vs XLA recompile vs
donation bug).  This module is that instrumentation (VERDICT r3 #8): a
per-launch-shape exponential moving average of wall time; when a launch
exceeds ``ratio`` x its established EMA (and an absolute floor, so cheap
launches never alarm), a structured warning is logged with the shape key,
the elapsed time, and the expectation it violated.
"""

from __future__ import annotations

import logging
import threading
from typing import Dict, Optional, Tuple

logger = logging.getLogger("fhe_regex_tpu_torch.watchdog")


class LaunchWatchdog:
    """EMA-based anomaly detector for repeated same-shape launches.

    ``observe(key, seconds)`` returns a warning string (also logged) when
    the launch is anomalous, else None.  The first ``warmup`` observations
    of a key are DISCARDED (cold compiles are expected to be slow and must
    neither alarm nor train the EMA); the EMA then seeds from the MINIMUM
    of the first two post-warmup observations, so a stall on the very
    first warm run — the round-3 anomaly's own shape — still alarms once
    the second observation reveals the true baseline (advisor round 4).
    Thread-safe: serving runs observe() and snapshot() from different
    threads.
    """

    def __init__(self, ratio: float = 10.0, floor_seconds: float = 5.0,
                 alpha: float = 0.3, warmup: int = 1):
        self.ratio = ratio
        self.floor = floor_seconds
        self.alpha = alpha
        self.warmup = warmup
        self._lock = threading.Lock()
        self._ema: Dict[Tuple, float] = {}
        self._first: Dict[Tuple, float] = {}
        self._seen: Dict[Tuple, int] = {}

    def _warn(self, key: Tuple, seconds: float, ema: float) -> str:
        warning = (
            f"anomalous launch: shape {key} took {seconds:.1f}s vs "
            f"EMA {ema:.2f}s (> {self.ratio:.0f}x) — suspect relay "
            f"stall / silent XLA recompile / host contention; see "
            f"docs/BENCHMARKS.md round-3 anomaly note")
        logger.warning(warning)
        return warning

    def observe(self, key: Tuple, seconds: float) -> Optional[str]:
        with self._lock:
            seen = self._seen.get(key, 0)
            self._seen[key] = seen + 1
            if seen < self.warmup:
                return None    # cold compile: discard, don't train the EMA
            ema = self._ema.get(key)
            if ema is None:
                first = self._first.get(key)
                if first is None:
                    self._first[key] = seconds   # await a second opinion
                    return None
                # seed from the smaller of the two: if one was a stall,
                # the other exposes it retroactively
                ema = self._ema[key] = min(first, seconds)
                del self._first[key]
                hi = max(first, seconds)
                if hi > self.floor and hi > self.ratio * ema:
                    return self._warn(key, hi, ema)
                return None
            if seconds > self.floor and seconds > self.ratio * ema:
                # do NOT fold the anomaly into the EMA: one stall must
                # not desensitize the detector to the next one
                return self._warn(key, seconds, ema)
            self._ema[key] = (1 - self.alpha) * ema + self.alpha * seconds
            return None

    def snapshot(self) -> Dict[str, float]:
        """Copy of the per-shape EMAs (for serve.py /stats)."""
        with self._lock:
            return {str(k): round(v, 4) for k, v in self._ema.items()}
