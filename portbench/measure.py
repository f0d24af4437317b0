"""Arithmetic the metric readers share: percentiles over all requests,
the union of intervals, and the window's sums."""

from __future__ import annotations

import statistics
from typing import Iterable, List, Optional, Tuple


def percentile(values: List[float], q: int) -> Optional[float]:
    """The q-th percentile of all values (linear between the order
    statistics, ``statistics.quantiles`` method "inclusive"); None for
    fewer than two values."""
    if len(values) < 2:
        return None
    return statistics.quantiles(values, n=100, method="inclusive")[q - 1]


def union_seconds(intervals: Iterable[Tuple[int, int]]) -> float:
    """Length in seconds of the union of [start, end) intervals given in
    nanoseconds (the arithmetic of ``chip_profile.busy_us``)."""
    total, end = 0, None
    for s, e in sorted(intervals):
        if end is None or s > end:
            total += e - s
            end = e
        elif e > end:
            total += e - end
            end = e
    return total / 1e9


def gaps(intervals: Iterable[Tuple[int, int]], lo: int, hi: int
         ) -> List[Tuple[int, int]]:
    """The stretches of [lo, hi) that no interval covers."""
    out, at = [], lo
    for s, e in sorted(intervals):
        if s > at:
            out.append((at, min(s, hi)))
        at = max(at, e)
        if at >= hi:
            break
    if at < hi:
        out.append((at, hi))
    return [(s, e) for s, e in out if e > s]


def contents(rec) -> int:
    return sum(len(r["contents"]) for r in rec["requests"])


def client_seconds(rec) -> List[float]:
    return [r["seconds"] for r in rec["requests"]]


def daemon_share(rec) -> Optional[float]:
    """1 - (seconds inside the service's match calls) / (client-seen
    seconds), over the window's requests."""
    seen = sum(client_seconds(rec))
    if not seen or any(r["service_s"] is None for r in rec["requests"]):
        return None
    return 1.0 - sum(r["service_s"] for r in rec["requests"]) / seen


def program_stats(rec, r) -> Optional[dict]:
    """The daemon's /stats circuit entry of request r's pattern and
    content length, read after the window."""
    stats = rec.get("stats_after")
    if not stats:
        return None
    for prog in stats["programs"]:
        if prog["pattern"] == r["pattern"] and prog["fold"] == r["fold"]:
            return prog["lengths"].get(str(r["content_len"]))
    return None


def rotations_per_content(rec) -> Optional[float]:
    """Rotation rows the compiled plans need, weighted by the window's
    contents."""
    total = 0
    for r in rec["requests"]:
        st = program_stats(rec, r)
        if st is None:
            return None
        total += st["rotations"] * len(r["contents"])
    n = contents(rec)
    return total / n if n else None


def launches_per_content(rec) -> Optional[float]:
    """Kernel launches the program counted over the window, per content."""
    before, after = rec.get("stats_before"), rec.get("stats_after")
    n = contents(rec)
    if not before or not after or not n:
        return None
    made = sum(after["kernel_launches"][k] - before["kernel_launches"].get(k, 0)
               for k in after["kernel_launches"])
    return made / n


def rotation_roofline(rec) -> Optional[float]:
    """Least time of the traced requests' needed rotation rows at the
    published peaks over the traced device time of the rotation kernels,
    in %."""
    from portbench.roofline import least_seconds

    trace = rec.get("trace")
    if not trace or not trace["rotation_s"]:
        return None
    least = 0.0
    for r in rec["requests"][trace["first"]:]:
        st = program_stats(rec, r)
        if st is None:
            return None
        least += least_seconds(rec["params"],
                               st["rotations"] * len(r["contents"]),
                               st["levels"])
    return 100.0 * least / trace["rotation_s"]


def idle_share(rec) -> Optional[float]:
    trace = rec.get("trace")
    if not trace or not trace["window_s"]:
        return None
    return 1.0 - trace["busy_s"] / trace["window_s"]
