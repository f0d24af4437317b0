"""Spans and counters of the port's daemon and executor (utils/trace.py).

The daemon (``serve.make_server`` on a loopback port, in this process)
serves real encryptions at ``TEST_PARAMS_NOISY`` on the CPU.  With its
recorder off a request keeps no span and makes no CUDA event; with it on,
the spans of one POST share its request id and nest as ``serve.py``'s
docstring lists them, inside the request's ``serve.request``.  The row
counters agree with the compiled plans, and ``run(profile=True)`` keeps
its per-level stats.  The test marked ``card`` counts
``torch.cuda.synchronize`` calls on a CUDA device:

    python -m pytest --noconftest tests/test_torch_trace.py -q -m card

(``--noconftest``: the suite's conftest loads the JAX package, which the
card's machine does not have).  This file imports no JAX.
"""

import contextlib
import json
import threading
import time
import types
import urllib.request

import numpy as np
import pytest
import torch

import fhe_regex_tpu_torch as port
from fhe_regex_tpu_torch import serve
from fhe_regex_tpu_torch.regex import executor as tex
from fhe_regex_tpu_torch.utils import trace

torch.set_num_threads(2)

SERVE_SPANS = ("serve.read", "serve.decode", "serve.service", "serve.encode",
               "serve.write")


@pytest.fixture(scope="module")
def keys():
    return port.gen_keys(port.get_params("TEST_PARAMS_NOISY"), seed=5)


@contextlib.contextmanager
def _daemon(sk, device="cpu", backend="torch"):
    svc = serve.MatchService(sk, backend=backend, device=device)
    srv = serve.make_server(svc, port=0)
    t = threading.Thread(target=srv.serve_forever, daemon=True)
    t.start()
    try:
        yield f"http://127.0.0.1:{srv.server_address[1]}", svc
    finally:
        srv.shutdown()
        srv.server_close()
        t.join(timeout=30)
        assert not t.is_alive()


@pytest.fixture(scope="module")
def daemon(keys):
    with _daemon(keys[1]) as d:
        yield d


def _post(url, path, obj):
    body = json.dumps(obj).encode()
    req = urllib.request.Request(url + path, body,
                                 {"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=300) as r:
        return json.loads(r.read()), len(body)


def _get(url, path):
    with urllib.request.urlopen(url + path, timeout=60) as r:
        return json.loads(r.read())


def _one(ck, s, pattern="/ab?c/"):
    return {"pattern": pattern, "ct": serve.encode_array(
        port.encrypt_str(ck, s))}


def _many(ck, strs, pattern="/ab?c/", **kw):
    return {"pattern": pattern, **kw, "ct": serve.encode_array(
        np.stack([port.encrypt_str(ck, s) for s in strs]))}


@contextlib.contextmanager
def _recording(svc):
    svc.recorder.drain()
    svc.recorder.start()
    try:
        yield
    finally:
        svc.recorder.stop()


def _drain(svc, requests):
    """The kept spans once ``requests`` requests have closed: a handler
    closes its last spans after the client holds the reply."""
    spans, deadline = [], time.time() + 30
    while sum(s["name"] == "serve.request" for s in spans) < requests:
        assert time.time() < deadline, spans
        time.sleep(0.01)
        spans += svc.recorder.drain()
    return spans


def _by_request(spans):
    out = {}
    for s in spans:
        out.setdefault(s["request"], []).append(s)
    return out


def _refuse(*a, **k):
    raise AssertionError("made a CUDA event or synchronised")


def test_recording_off_keeps_no_span_and_makes_no_event(keys, daemon,
                                                        monkeypatch):
    """Off (the default), a request keeps no span, makes no CUDA event and
    synchronises nothing, and its counters still count."""
    ck, _ = keys
    url, svc = daemon
    monkeypatch.setattr(torch.cuda, "Event", _refuse)
    monkeypatch.setattr(torch.cuda, "synchronize", _refuse)
    assert not svc.recorder.recording
    before = _get(url, "/stats")["requests"].get("/match_many", {})
    out, sent = _post(url, "/match_many", _many(ck, ["xabcx", "xxxxx"]))
    assert [port.decrypt(ck, r) for r in
            serve.decode_array(out["ct"])] == [1, 0]
    deadline = time.time() + 30
    while True:     # write_s and seconds count once the reply is out
        row = _get(url, "/stats")["requests"]["/match_many"]
        if row["seconds"] > before.get("seconds", 0):
            break
        assert time.time() < deadline
        time.sleep(0.01)
    assert svc.recorder.drain() == []
    assert row["count"] == before.get("count", 0) + 1
    assert row["bytes_in"] - before.get("bytes_in", 0) == sent
    assert row["bytes_out"] - before.get("bytes_out", 0) == len(
        json.dumps(out).encode())
    for k in ("read_s", "decode_s", "service_s", "encode_s", "write_s"):
        assert row[k] > before.get(k, 0)
    assert row["seconds"] - before.get("seconds", 0) > (
        row["service_s"] - before.get("service_s", 0))


@pytest.mark.parametrize("path", ["/match", "/match_many"])
def test_spans_nest_within_their_request(keys, daemon, path):
    """On, each POST's spans share one request id and nest as the daemon
    documents them: serve.* under serve.request, the service's and the
    executor's under serve.service, the executor's steps under its run;
    every span lies inside its request's serve.request."""
    ck, _ = keys
    url, svc = daemon
    req = (_one(ck, "xabc") if path == "/match"
           else _many(ck, ["xabc", "abxx", "aacb"]))
    with _recording(svc):
        _post(url, path, req)
        _post(url, path, req)
    spans = _drain(svc, 2)
    assert svc.recorder.drain() == []
    requests = _by_request(spans)
    assert None not in requests and len(requests) == 2
    run = "executor.run" if path == "/match" else "executor.run_many"
    for rid, rs in requests.items():
        (root,) = [s for s in rs if s["name"] == "serve.request"]
        assert root["parent"] is None
        parent = {s["name"]: s["parent"] for s in rs}
        assert len(parent) == len({s["name"] for s in rs})
        want = dict.fromkeys(SERVE_SPANS, "serve.request")
        want.update({"service.lookup": "serve.service",
                     "service.wait": "serve.service", run: "serve.service",
                     "executor.fill": run, "executor.level": run,
                     "executor.finalize": run, "serve.request": None})
        assert parent == want
        for s in rs:
            assert root["start_ns"] <= s["start_ns"] <= s["end_ns"] \
                <= root["end_ns"]
        order = [s["name"] for s in sorted(rs, key=lambda s: s["start_ns"])
                 if s["parent"] == "serve.request"]
        assert order == list(SERVE_SPANS)
        levels = [s for s in rs if s["name"] == "executor.level"]
        assert levels and all(s["device_s"] >= 0 and s["rows_needed"]
                              <= s["rows_launched"] for s in levels)


def test_rows_needed_are_the_plans_rotations(keys, daemon):
    """Over a /match_many of C contents, the rows needed equal /stats'
    rotations of the program times C, and the rows launched the widths of
    the packed plan's launches."""
    ck, _ = keys
    url, svc = daemon
    strs = ["abcab", "xxxxx", "xxabc", "acacb", "bbbbb"]
    before = svc.executor.launches_by_width()
    _post(url, "/match_many", _many(ck, strs, pattern="/a[bc]+$/"))
    after = svc.executor.launches_by_width()
    delta = {k: {f: v[f] - before.get(k, {}).get(f, 0) for f in v}
             for k, v in after.items()}
    stats = _get(url, "/stats")
    prog = next(p for p in stats["programs"] if p["pattern"] == "/a[bc]+$/")
    rot = prog["lengths"]["5"]["rotations"]
    assert sum(d["rows_needed"] for d in delta.values()) == rot * len(strs)
    circuit = svc._programs[("/a[bc]+$/", "tree", None, None,
                             False)].circuit(5)
    chunks = (svc.executor._device_chunks_many_mv if circuit.multivalue
              else svc.executor._device_chunks_many)(circuit, len(strs),
                                                     False)
    widths = ([sum(c[0].shape[0] for c in rot_chunks)
               for rot_chunks, _ in chunks] if circuit.multivalue
              else [c[0].shape[0] for c in chunks])
    assert sum(d["rows_launched"] for d in delta.values()) == sum(widths)
    assert sum(d["steps"] for d in delta.values()) == len(chunks)
    assert stats["launches_by_width"] == after


@pytest.mark.parametrize("multivalue", [False, True])
def test_rows_launched_are_the_level_widths(keys, daemon, multivalue):
    """/match launches each level's batch: the lut_idx width (classic) or
    the rotation batch (multi-value), one step a level."""
    ck, _ = keys
    url, svc = daemon
    before = svc.executor.launches_by_width()
    _post(url, "/match", dict(_one(ck, "xxabc", "/b.c|ab/"),
                              multivalue=multivalue))
    after = svc.executor.launches_by_width()
    circuit = svc._programs[("/b.c|ab/", "tree", None, multivalue,
                             False)].circuit(5)
    assert circuit.multivalue is multivalue
    want = {}
    for lv in circuit.levels:
        w = (lv.rot_slots.shape[0] if multivalue else lv.lut_idx.shape[0])
        n = (lv.mv_rot_count if multivalue else int((lv.lut_idx >= 0).sum()))
        row = want.setdefault(str(w), [0, 0, 0])
        row[0] += 1
        row[1] += w
        row[2] += n
    got = {k: [v["steps"] - before.get(k, {}).get("steps", 0),
               v["rows_launched"] - before.get(k, {}).get("rows_launched", 0),
               v["rows_needed"] - before.get(k, {}).get("rows_needed", 0)]
           for k, v in after.items()}
    assert {k: v for k, v in got.items() if v[0]} == want


def test_service_counters(keys, daemon):
    """A lookup that compiles is a plan miss, the next one of the same
    pattern and length is not; every device call waits under service.wait."""
    ck, _ = keys
    url, svc = daemon
    s0 = _get(url, "/stats")
    _post(url, "/match", _one(ck, "abcab", "/c.b/"))
    s1 = _get(url, "/stats")
    _post(url, "/match", _one(ck, "abcab", "/c.b/"))
    s2 = _get(url, "/stats")
    assert s1["plan_misses"] == s0["plan_misses"] + 1
    assert s2["plan_misses"] == s1["plan_misses"]
    assert s2["lookup_s"] > s1["lookup_s"] > s0["lookup_s"]
    assert s2["wait_s"] > s1["wait_s"] > s0["wait_s"] >= 0


@pytest.mark.parametrize("multivalue", [False, True])
def test_profile_keeps_its_stats(keys, multivalue):
    """run(profile=True) keeps width / active / seconds a level (and the
    rotation batch on the multi-value plan) and the failure contract."""
    ck, sk = keys
    ex = port.executor_for(sk, "torch", device="cpu")
    from fhe_regex_tpu_torch.models.patterns import CompiledPattern

    circuit = CompiledPattern("/b.c|ab/", params=sk.params,
                              multivalue=multivalue).circuit(4)
    ct = port.encrypt_str(ck, "abcx")
    out = ex.run(circuit, ct, profile=True)
    assert port.decrypt(ck, out) == 1
    want = {"width", "active", "seconds"} | (
        {"rotations"} if multivalue else set())
    assert len(ex.last_run_stats) == len(circuit.levels)
    for st, lv in zip(ex.last_run_stats, circuit.levels):
        assert set(st) == want and st["seconds"] >= 0
        assert st["width"] == lv.lut_idx.shape[0]
        assert st["active"] == int((lv.lut_idx >= 0).sum())
    assert ex.last_run_pfail["pbs_count"] == circuit.pbs_count


class _FakeEvent:
    """A CUDA event on a clock that each record advances by 0.5 ms."""
    made = 0
    clock = 0.0

    def __init__(self, enable_timing=False):
        assert enable_timing
        _FakeEvent.made += 1
        self.t = None

    def record(self, stream=None):
        _FakeEvent.clock += 0.5
        self.t = _FakeEvent.clock

    def synchronize(self):
        pass

    def elapsed_time(self, end):
        return end.t - self.t


def test_steps_make_events_only_when_timed(monkeypatch):
    """On a CUDA device an untimed step makes no event and counts its rows
    at once; a timed one makes a pair, read by close() into its span and
    the counters."""
    counted = []
    ex = types.SimpleNamespace(device=torch.device("cuda"),
                               _count_step=lambda *a: counted.append(a))
    monkeypatch.setattr(torch.cuda, "current_stream", lambda *a: None)
    monkeypatch.setattr(torch.cuda, "Event", _refuse)
    steps = tex._Steps(ex, False)
    with steps.step("256", 256, 200):
        pass
    assert counted == [("256", 256, 200, None)] and steps.close() == []
    counted.clear()
    monkeypatch.setattr(torch.cuda, "Event", _FakeEvent)
    _FakeEvent.made = 0
    rec = trace.Recorder()
    rec.start()
    with rec.request("r"):
        steps = tex._Steps(ex, True)
        for w in (64, 8):
            with steps.step(str(w), w, w - 1):
                pass
        assert counted == []
        assert steps.close() == [5e-4, 5e-4]
    assert _FakeEvent.made == 4
    assert counted == [("64", 64, 63, 5e-4), ("8", 8, 7, 5e-4)]
    levels = [s for s in rec.drain() if s["name"] == "executor.level"]
    assert [s["device_s"] for s in levels] == [5e-4, 5e-4]


def test_recorder_keeps_spans_of_its_requests_only(monkeypatch):
    """A span outside a request is kept by nobody; a request's spans are
    kept only while its recorder records, up to its capacity; drain
    empties the buffer; a nested request restores the outer one."""
    monkeypatch.setattr(trace.Recorder, "CAPACITY", 3)
    rec = trace.Recorder()
    with trace.Span("alone") as sp:
        pass
    assert sp.request is None and sp.seconds >= 0
    with rec.request("r1"):
        with trace.Span("a"):
            assert not trace.recording()
    assert rec.drain() == []
    rec.start()
    with rec.request("r2") as outer:
        assert trace.recording()
        inner_rec = trace.Recorder()
        with inner_rec.request("r3"):
            assert not trace.recording()
        with trace.Span("b", k=1):
            with trace.Span("c"):
                pass
    got = rec.drain()
    assert [(s["name"], s["parent"], s["request"]) for s in got] == [
        ("c", "b", outer.request), ("b", "r2", outer.request),
        ("r2", None, outer.request)]
    assert got[1]["k"] == 1 and rec.drain() == []
    with rec.request("r4"):
        for _ in range(5):
            with trace.Span("d"):
                pass
    assert len(rec.drain()) == 3


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return "cuda"


@pytest.mark.card
def test_no_synchronize_is_added_on_the_card(card, monkeypatch):
    """On the card: run(profile=True) times its levels without a
    torch.cuda.synchronize, and a daemon request calls none with the
    recorder off or on; on, its levels carry device seconds that fit in
    their run."""
    ck, sk = port.gen_keys(port.get_params("TEST_PARAMS"), seed=7)
    calls = []
    real = torch.cuda.synchronize

    def counted(*a, **k):
        calls.append(a)
        return real(*a, **k)

    from fhe_regex_tpu_torch.models.patterns import CompiledPattern

    ex = port.executor_for(sk, device=card)
    circuit = CompiledPattern("/ab?c/", params=sk.params).circuit(4)
    ex.run(circuit, port.encrypt_str(ck, "xabc"))       # plans uploaded
    monkeypatch.setattr(torch.cuda, "synchronize", counted)
    out = ex.run(circuit, port.encrypt_str(ck, "xabc"), profile=True)
    assert port.decrypt(ck, out) == 1 and calls == []
    assert all(st["seconds"] > 0 for st in ex.last_run_stats)
    with _daemon(sk, device=card, backend=None) as (url, svc):
        req = _many(ck, ["xabcx", "xxxxx"])
        _post(url, "/match_many", req)
        assert calls == []
        with _recording(svc):
            out, _ = _post(url, "/match_many", req)
        assert calls == []
        assert [port.decrypt(ck, r) for r in
                serve.decode_array(out["ct"])] == [1, 0]
    spans = _drain(svc, 1)
    (run,) = [s for s in spans if s["name"] == "executor.run_many"]
    levels = [s for s in spans if s["name"] == "executor.level"]
    assert levels and all(s["device_s"] > 0 for s in levels)
    assert sum(s["device_s"] for s in levels) * 1e9 <= (run["end_ns"]
                                                        - run["start_ns"])
