"""Least time of the needed rotation rows at the H100's published peaks
over the traced device time of the rotation kernels, in %."""

from portbench.measure import rotation_roofline


def read(rec):
    return rotation_roofline(rec)
