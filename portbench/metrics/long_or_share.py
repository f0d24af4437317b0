"""Seconds of the OR rounds over the window bits (/stats long or_s: the
program's long.or_reduce span, from the first OR launch to the answer on
the host) over the /match_long requests' service seconds (/stats requests
service_s: the program's serve.service span)."""

from portbench.program_counters import window_delta


def read(rec):
    rows, requests = window_delta(rec, "long"), window_delta(rec, "requests")
    if not rows or not requests or "/match_long" not in requests:
        return None
    service = requests["/match_long"].get("service_s")
    return sum(r["or_s"] for r in rows.values()) / service if service \
        else None
