"""Rotation rows the compiled plan needs per content (/stats programs)."""

from portbench.measure import rotations_per_content


def read(rec):
    return rotations_per_content(rec)
