"""Rotation rows the compiled plans need per /match request (/stats
programs), over the window's requests."""

from portbench.measure import rotations_per_content


def read(rec):
    return rotations_per_content(rec)
