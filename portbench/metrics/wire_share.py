"""The daemon's wire seconds over client-seen seconds: its serve.read,
serve.decode, serve.encode and serve.write spans (body off the socket,
JSON and base64 both ways, reply onto the socket), summed per endpoint in
/stats over the window."""

from portbench.measure import client_seconds
from portbench.program_counters import window_delta

PHASES = ("read_s", "decode_s", "encode_s", "write_s")


def read(rec):
    rows = window_delta(rec, "requests")
    seen = sum(client_seconds(rec))
    if not rows or not seen or any(k not in row for row in rows.values()
                                   for k in PHASES):
        return None
    return sum(row[k] for row in rows.values() for k in PHASES) / seen
