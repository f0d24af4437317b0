"""Kernel launches over the window per /match request (/stats
kernel_launches)."""

from portbench.measure import launches_per_content


def read(rec):
    return launches_per_content(rec)
