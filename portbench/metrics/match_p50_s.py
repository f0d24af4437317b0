"""Median client-seen seconds of all the window's requests."""

from portbench.measure import client_seconds, percentile


def read(rec):
    return percentile(client_seconds(rec), 50)
