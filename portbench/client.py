"""The client: one closed loop of requests to the daemon over HTTP.

The wire format is the daemon's: JSON with each ciphertext array as
{"b64", "shape", "dtype"} of its raw little-endian words.  A request is
timed from the start of its POST (the body's encoding included) until the
client holds the decoded reply; the encryption before it is not timed.
"""

from __future__ import annotations

import base64
import http.client
import json
import sys
import time

import numpy as np


def encode(a: np.ndarray) -> dict:
    a = np.ascontiguousarray(a)
    return {"b64": base64.b64encode(a.tobytes()).decode(),
            "shape": list(a.shape), "dtype": str(a.dtype)}


def decode(d: dict) -> np.ndarray:
    return np.frombuffer(base64.b64decode(d["b64"]),
                         np.dtype(d["dtype"])).reshape(d["shape"])


class Client:
    def __init__(self, port: int):
        self.port = port

    def call(self, method: str, path: str, obj=None) -> dict:
        conn = http.client.HTTPConnection("127.0.0.1", self.port,
                                          timeout=600)
        try:
            body = None if obj is None else json.dumps(obj).encode()
            conn.request(method, path, body,
                         {"Content-Type": "application/json"})
            resp = conn.getresponse()
            data = json.loads(resp.read())
        finally:
            conn.close()
        if resp.status != 200:
            raise RuntimeError(f"{path}: HTTP {resp.status} {data}")
        return data

    def match(self, req, cts: np.ndarray, spans: list):
        """POST one request; -> (reply ciphertexts or None on an error,
        start_ns, end_ns).  A failed request is returned, not raised: it
        counts as failed."""
        t0 = time.time_ns()
        body = {"pattern": req.pattern, "fold": req.fold,
                "ct": encode(cts if req.endpoint == "/match_many"
                             else cts[0])}
        try:
            out = decode(self.call("POST", req.endpoint, body)["ct"])
        except (OSError, RuntimeError, KeyError, ValueError) as e:
            print(f"request {req.index} ({req.shape}) failed: {e}",
                  file=sys.stderr, flush=True)
            out = None
        t1 = time.time_ns()
        spans.append(("client.post", t0, t1))
        return out, t0, t1
