"""Encrypted contents answered per second over the whole window."""

from portbench.measure import contents


def read(rec):
    return contents(rec) / rec["window_s"] if rec["window_s"] else None
