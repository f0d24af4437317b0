"""The program under test: the port's serving daemon, in this process.

``start`` builds ``fhe_regex_tpu_torch.serve.MatchService`` on the server
key, warms the cell's shapes and serves ``serve.make_server`` from a
thread on a free loopback port.  The service is a subclass that records a
span around every ``match`` / ``match_many`` call (ended after a device
synchronise), the seconds the program itself spends on a request; the
rest of what the client sees is HTTP, JSON and base64.
"""

from __future__ import annotations

import threading
import time


def timed_service_class():
    from fhe_regex_tpu_torch.serve import MatchService

    class TimedService(MatchService):
        """MatchService with a span around each match call."""

        def __init__(self, *args, **kwargs):
            super().__init__(*args, **kwargs)
            self.spans = []        # [(name, start_ns, end_ns)]

        def _timed(self, fn, *args, **kwargs):
            import torch

            t0 = time.time_ns()
            out = fn(*args, **kwargs)
            if self.device.type == "cuda":
                torch.cuda.synchronize(self.device)
            self.spans.append(("daemon.service", t0, time.time_ns()))
            return out

        def match(self, *args, **kwargs):
            return self._timed(super().match, *args, **kwargs)

        def match_many(self, *args, **kwargs):
            return self._timed(super().match_many, *args, **kwargs)

    return TimedService


class Daemon:
    """The daemon serving from a thread of this process."""

    def __init__(self, server_key, backend, device):
        from fhe_regex_tpu_torch import serve

        self.service = timed_service_class()(server_key, backend=backend,
                                             device=device)
        self._serve = serve
        self.server = None
        self._thread = None

    def warm(self, mix: dict, params) -> None:
        """Run every shape of the mix once, at its endpoint and batch, on
        trivial ciphertexts, so that no plan is compiled or uploaded and
        no kernel loaded inside the window."""
        from portbench.tfhe import trivial_contents

        for shape in sorted(set(mix["cycle"])):
            sh = mix["shapes"][shape]
            cts = trivial_contents(params, ["a" * sh["content_len"]]
                                   * int(mix["batch"]))
            if mix["endpoint"] == "/match":
                self.service.match(sh["pattern"], cts[0], mix["fold"])
            else:
                self.service.match_many(sh["pattern"], cts, mix["fold"])
        self.service.spans.clear()

    def open(self) -> int:
        """Serve on a free loopback port; returns the port."""
        self.server = self._serve.make_server(self.service, "127.0.0.1", 0)
        self._thread = threading.Thread(target=self.server.serve_forever,
                                        kwargs={"poll_interval": 0.05},
                                        name="daemon", daemon=True)
        self._thread.start()
        return self.server.server_address[1]

    def close(self) -> None:
        if self.server is not None:
            self.server.shutdown()
            self.server.server_close()
            self._thread.join(timeout=30)
            self.server = None
