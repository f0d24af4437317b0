"""90th percentile of client-seen seconds over all the window's
requests."""

from portbench.measure import client_seconds, percentile


def read(rec):
    return percentile(client_seconds(rec), 90)
