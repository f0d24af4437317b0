"""Rotation rows the window's steps needed over the rows they handed the
blind rotation (/stats launches_by_width: each level, packed step or
graph replay of the executor)."""

from portbench.program_counters import window_delta


def read(rec):
    rows = window_delta(rec, "launches_by_width")
    if not rows:
        return None
    launched = sum(r["rows_launched"] for r in rows.values())
    return (sum(r["rows_needed"] for r in rows.values()) / launched
            if launched else None)
