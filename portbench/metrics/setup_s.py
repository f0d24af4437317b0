"""Seconds from process start to the first timed request, less the
client's key generation: torch, the kernels, the server key on the
device, the service, the warm-up of the cell's shapes and the daemon's
port."""


def read(rec):
    return rec["setup_seconds"]
