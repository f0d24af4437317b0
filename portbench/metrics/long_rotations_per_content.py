"""Rotation rows a windowed /match_long request needs: its window plan's
rows times its windows, and the bootstraps of its OR tree (/stats long),
per request over the window."""

from portbench.program_counters import window_delta


def read(rec):
    rows = window_delta(rec, "long")
    n = sum(r["requests"] for r in rows.values()) if rows else 0
    if not n:
        return None
    return sum(r["window_rows"] + r["or_rows"] for r in rows.values()) / n
