"""Spans of the serving path, on the host's wall clock.

A span is a named stretch of one thread's time: its start and end in
``time.time_ns()`` nanoseconds (the clock of ``torch.profiler``'s Kineto
events, so spans and device intervals lie on one timeline), the id of the
request it belongs to, the name of its parent span and a few attributes.

``Recorder.request()`` opens a request on the calling thread (the daemon's
handler opens one per POST, ``serve.request``): every span the thread
opens until the request closes, in any module, carries the request's id
and its parent's name.  A span opened outside a request is timed and kept
by nobody.

A span's ``seconds`` are for its caller to add to a counter, whether or
not anything records.  The spans of a request that opens while its
recorder's ``recording`` is on (``start()`` / ``stop()``; off by default)
are kept, each as it closes, in a bounded buffer of the recorder:
a request is kept whole or not at all.  ``drain()`` hands the kept spans
over and empties the buffer; a request still open keeps its later spans
for the next drain.  Off, a span costs two ``time_ns`` calls and grows no
list.
"""

from __future__ import annotations

import collections
import contextlib
import itertools
import threading
import time
from typing import Iterator, List, Optional

_local = threading.local()     # .request: the thread's open _Request


class _Request:
    __slots__ = ("id", "recorder", "keep", "stack")

    def __init__(self, rid: int, recorder: "Recorder"):
        self.id = rid
        self.recorder = recorder
        self.keep = recorder.recording
        self.stack: List[str] = []      # names of the thread's open spans


def _current() -> Optional[_Request]:
    return getattr(_local, "request", None)


class Span:
    """One span; a context manager, or opened by the constructor and ended
    by ``close()``.  Spans of one thread close in the reverse order of
    their opening."""

    __slots__ = ("name", "start_ns", "end_ns", "request", "parent", "attrs",
                 "_rq")

    def __init__(self, name: str, **attrs):
        rq = _current()
        self.name = name
        self.attrs = attrs
        self._rq = rq
        self.request = None if rq is None else rq.id
        self.parent = rq.stack[-1] if rq is not None and rq.stack else None
        if rq is not None:
            rq.stack.append(name)
        self.end_ns: Optional[int] = None
        self.start_ns = time.time_ns()

    @property
    def seconds(self) -> float:
        return (self.end_ns - self.start_ns) / 1e9

    def close(self) -> float:
        """End the span (once; a later call changes nothing) and return
        its seconds."""
        if self.end_ns is None:
            self.end_ns = time.time_ns()
            rq = self._rq
            if rq is not None:
                rq.stack.pop()
                if rq.keep:
                    rq.recorder._spans.append(self)
        return self.seconds

    def __enter__(self) -> "Span":
        return self

    def __exit__(self, *exc) -> bool:
        self.close()
        return False

    def as_dict(self) -> dict:
        return {"name": self.name, "start_ns": self.start_ns,
                "end_ns": self.end_ns, "request": self.request,
                "parent": self.parent, **self.attrs}


def recording() -> bool:
    """Whether the calling thread is inside a request that is kept (the
    executor times its levels on the device only then)."""
    rq = _current()
    return rq is not None and rq.keep


class Recorder:
    """The spans of the requests one daemon serves, at most CAPACITY:
    past it the oldest are dropped (a 51 s window of /match requests
    keeps about 4000)."""

    CAPACITY = 1 << 16

    def __init__(self):
        self.recording = False
        self._spans: "collections.deque[Span]" = collections.deque(
            maxlen=self.CAPACITY)
        self._ids = itertools.count(1)

    def start(self) -> None:
        self.recording = True

    def stop(self) -> None:
        self.recording = False

    def drain(self) -> List[dict]:
        """The kept spans as dicts ("name", "start_ns", "end_ns",
        "request", "parent" and the span's attributes), oldest first; the
        buffer is left empty."""
        out = []
        while True:
            try:
                out.append(self._spans.popleft().as_dict())
            except IndexError:
                return out

    @contextlib.contextmanager
    def request(self, name: str = "serve.request") -> Iterator[Span]:
        """A new request on this thread, and its outermost span."""
        outer = _current()
        _local.request = _Request(next(self._ids), self)
        try:
            with Span(name) as sp:
                yield sp
        finally:
            _local.request = outer
