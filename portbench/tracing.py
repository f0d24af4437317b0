"""The device trace of a window: ``torch.profiler`` with CUDA activity.

Device intervals come from the profiler's Kineto events, whose times are
nanoseconds on the host's wall clock (``time.time_ns``), the clock of the
harness's own spans.  From them: the device's busy time over the window
(the union of its operations' intervals), the device time of the
rotation kernels by name, the operations that took most time, and the
idle gaps grouped by what the host was doing (the innermost span of the
harness that covers a gap's middle).
"""

from __future__ import annotations

import bisect
import re
from collections import defaultdict

from portbench.measure import gaps, union_seconds

# the kernels of a blind rotation, by the names of csrc/*.cu
ROTATION_KERNELS = re.compile(r"\b(acc_init(64)?|stage1(_64)?|ext_product(64)?)\b")

# the harness's span names, innermost first, for labelling idle gaps
SPAN_ORDER = ("daemon.service", "client.post", "client.encrypt")


class DeviceTrace:
    """The profiler over a CUDA device; on the CPU (tests) it records no
    device operation."""

    def __init__(self, device: str):
        import torch
        from torch.profiler import ProfilerActivity, profile

        self._prof = (profile(activities=[ProfilerActivity.CUDA])
                      if torch.device(device).type == "cuda" else None)

    def __enter__(self):
        if self._prof is not None:
            self._prof.__enter__()
        return self

    def __exit__(self, *exc):
        if self._prof is not None:
            self._prof.__exit__(*exc)
        return False

    def device_events(self):
        """[(name, start_ns, end_ns)] of every device operation traced."""
        from torch.autograd import DeviceType

        out = []
        if self._prof is None:
            return out
        for e in self._prof.profiler.kineto_results.events():
            if e.device_type() == DeviceType.CUDA:
                out.append((e.name(), e.start_ns(), e.end_ns()))
        return out


def short_name(name: str) -> str:
    """A kernel's name without its return type and argument list."""
    if name.endswith(")"):
        depth = 0
        for i in range(len(name) - 1, -1, -1):
            depth += {")": 1, "(": -1}.get(name[i], 0)
            if depth == 0:
                name = name[:i]
                break
    name = name.strip()
    return (name[5:] if name.startswith("void ") else name) or "(unnamed)"


def summarize(events, lo: int, hi: int, spans) -> dict:
    """The window [lo, hi) ns of a trace: busy and window seconds, the
    rotation kernels' device seconds, the ten device operations that took
    most time and the idle seconds by host activity (``spans``: [(name,
    start_ns, end_ns)] of the harness)."""
    inside = [(n, max(s, lo), min(e, hi)) for n, s, e in events
              if e > lo and s < hi]
    busy = union_seconds((s, e) for _, s, e in inside)
    by_name = defaultdict(float)
    rotation = 0.0
    for n, s, e in inside:
        by_name[short_name(n)] += (e - s) / 1e9
        if ROTATION_KERNELS.search(n):
            rotation += (e - s) / 1e9
    # spans of one name never overlap: each comes from one thread in turn
    by_span = {name: sorted((a, b) for n, a, b in spans if n == name)
               for name in SPAN_ORDER}
    starts = {name: [a for a, _ in v] for name, v in by_span.items()}

    def label(t: int) -> str:
        for name in SPAN_ORDER:
            i = bisect.bisect_right(starts[name], t) - 1
            if i >= 0 and t < by_span[name][i][1]:
                return name
        return "client.other"

    idle = defaultdict(float)
    for s, e in gaps(((s, e) for _, s, e in inside), lo, hi):
        idle[label((s + e) // 2)] += (e - s) / 1e9
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:10]
    top_idle = sorted(idle.items(), key=lambda kv: -kv[1])[:10]
    return {"busy_s": busy, "window_s": (hi - lo) / 1e9,
            "rotation_s": rotation,
            "device_ops": [[n, t] for n, t in top],
            "idle_gaps": [[n, t] for n, t in top_idle]}
