"""Counters the program keeps in its daemon's /stats
(``fhe_regex_tpu_torch/serve.py``), differenced over the window: a traced
run reads /stats just before the window's first request and after its
last, and no other request reaches the daemon in between."""

from __future__ import annotations

from typing import Optional


def window_delta(rec, key: str) -> Optional[dict]:
    """{row: {field: after - before}} of /stats' ``key`` (a dict of rows of
    numbers) over the window; None where a read is missing or the program
    keeps no such counters."""
    before, after = rec.get("stats_before"), rec.get("stats_after")
    if not before or not after or key not in after:
        return None
    prev = before.get(key, {})
    return {k: {f: v - prev.get(k, {}).get(f, 0) for f, v in row.items()}
            for k, row in after[key].items()}
