"""Least time of the traced /match_long requests' rotations at the H100's
published peaks over the traced device time of the rotation kernels, in %:
a request needs its window plan's rows times its windows in the plan's
levels, then its OR tree's bootstraps in its rounds (/stats long, per
request of its pattern over the window)."""

from portbench.program_counters import window_delta
from portbench.roofline import least_seconds


def read(rec):
    trace, rows = rec.get("trace"), window_delta(rec, "long")
    if not trace or not trace["rotation_s"] or not rows:
        return None
    least = 0.0
    for r in rec["requests"][trace["first"]:]:
        row = rows.get(r["pattern"])
        if not row or not row["requests"]:
            return None
        n = row["requests"]
        least += least_seconds(rec["params"],
                               (row["window_rows"] + row["or_rows"]) / n,
                               (row["window_levels"] + row["or_rounds"]) / n)
    return 100.0 * least / trace["rotation_s"]
