"""1 - union of device intervals over the traced window."""

from portbench.measure import idle_share


def read(rec):
    return idle_share(rec)
