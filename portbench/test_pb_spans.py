"""CPU tests of the metrics that read the program's own counters
(``wire_share``, ``row_fill``) and of the program's spans in a traced run
of the harness: hand-made records, the older metrics' readings on one
fixed record, and a traced run at test size."""

import time

import pytest

from portbench import harness, tracing

SPEC = harness.load_json(harness.CHECKOUT / "BENCHMARK.json")
DATA = harness.HERE / "testdata"


def _rec(before, after, seconds=(1.0, 3.0)):
    return {"stats_before": before, "stats_after": after,
            "requests": [{"seconds": s, "contents": ["x"]} for s in seconds]}


def test_wire_share_is_the_wire_phases_over_client_seconds():
    phases = {"read_s": 0.1, "decode_s": 0.2, "encode_s": 0.05,
              "write_s": 0.05, "service_s": 3.0, "count": 2}
    before = {"requests": {"/match": dict(phases, read_s=0.0)}}
    after = {"requests": {"/match": {k: 2 * v for k, v in phases.items()},
                          "/compile": dict.fromkeys(phases, 0.1)}}
    got = harness.reader("wire_share.batch")(_rec(before, after))
    assert got == pytest.approx((0.2 + 0.2 + 0.05 + 0.05 + 0.4) / 4.0)
    # a daemon without the phase counters, or no /stats read: nothing
    old = {"requests": {"/match": {"count": 2, "seconds": 4.0}}}
    assert harness.reader("wire_share.single")(_rec(old, old)) is None
    assert harness.reader("wire_share")(_rec(None, after)) is None


def test_row_fill_is_rows_needed_over_rows_launched():
    before = {"launches_by_width": {"1024+1024": {
        "steps": 1, "rows_launched": 2048, "rows_needed": 2048,
        "device_s": 0.0}}}
    after = {"launches_by_width": {
        "1024+1024": {"steps": 2, "rows_launched": 4096,
                      "rows_needed": 4096, "device_s": 0.0},
        "256": {"steps": 2, "rows_launched": 512, "rows_needed": 512,
                "device_s": 0.0},
        "64": {"steps": 3, "rows_launched": 192, "rows_needed": 0,
               "device_s": 0.0}}}
    assert harness.reader("row_fill.batch")(_rec(before, after)) == \
        pytest.approx(2560 / 2752)
    assert harness.reader("row_fill")(_rec({"requests": {}},
                                           {"requests": {}})) is None
    assert harness.reader("row_fill")(_rec(before, before)) is None


def test_older_metrics_read_as_they_did():
    """The ten per-layer and four end-to-end metrics of the benchmark
    before the program's counters, on one fixed record, read the values
    they read before those counters existed."""
    from fhe_regex_tpu_torch.params import get_params

    stats0 = {"kernel_launches": {"ext_product": 10, "stage1": 10}}
    stats1 = {"kernel_launches": {"ext_product": 19, "stage1": 19},
              "programs": [{"pattern": "/abc/", "fold": "tree", "lengths": {
                  "16": {"rotations": 96, "levels": 3}}}]}
    requests = [{"pattern": "/abc/", "fold": "tree", "content_len": 16,
                 "contents": ["x"] * 32, "seconds": s, "service_s": 0.9 * s}
                for s in (1.0, 2.0, 3.0, 4.0)]
    rec = {"params": get_params("TPU_MESSAGE_2_CARRY_2"),
           "setup_seconds": 9.5, "window_s": 10.0, "requests": requests,
           "stats_before": stats0, "stats_after": stats1,
           "trace": {"busy_s": 9.0, "window_s": 10.0, "rotation_s": 8.0,
                     "first": 2}}
    want = {"contents_per_s": 12.8, "match_p50_s": 2.5,
            "match_p90_s": 3.7, "setup_s": 9.5,
            "daemon_share.batch": 0.1, "daemon_share.single": 0.1,
            "rotations_per_content": 96.0, "rotations_per_match": 96.0,
            "launches_per_content": 18 / 128, "launches_per_match": 18 / 128,
            "idle_share.batch": 0.1, "idle_share.single": 0.1}
    for name, value in want.items():
        assert harness.reader(name)(rec) == pytest.approx(value), name
    from portbench.roofline import least_seconds

    least = 2 * least_seconds(rec["params"], 96 * 32, 3)
    for name in ("rotation_roofline.batch", "rotation_roofline.single"):
        assert harness.reader(name)(rec) == pytest.approx(100 * least / 8.0)
    older = {m["name"] for m in SPEC["end_to_end"] + SPEC["per_layer"]} - {
        m["name"] for m in SPEC["per_layer"]
        if m["name"].split(".")[0] in ("wire_share", "row_fill")}
    assert older == set(want) | {"rotation_roofline.batch",
                                 "rotation_roofline.single"}


@pytest.mark.parametrize("traffic", ["tiny_many", "tiny_single"])
def test_program_spans_lie_inside_the_clients_posts(traffic, monkeypatch):
    """A traced run at test size with the daemon's recorder on: every
    program span of a request lies inside one of the client's POST spans
    (one clock), the service's spans inside the benchmark's own
    daemon.service span, and the new metrics read within [0, 1], the wire
    no more than daemon_share."""
    from portbench import daemon as pb_daemon

    cell = f"tiny32.{traffic}"
    var = "batch" if traffic == "tiny_many" else "single"
    spec = {"workloads": [{"name": cell, "config": "tiny32",
                           "traffic": traffic, "chips": 1}],
            "end_to_end": [],
            "per_layer": [{"name": f"{m}.{var}", "unit": "fraction"}
                          for m in ("daemon_share", "wire_share",
                                    "row_fill")]}
    services, seen = [], []
    opened = pb_daemon.Daemon.open

    def open_recording(self):
        self.service.recorder.start()
        services.append(self.service)
        return opened(self)

    summarize = tracing.summarize

    def keep(events, lo, hi, spans):
        seen.extend(spans)
        return summarize(events, lo, hi, spans)

    monkeypatch.setattr(pb_daemon.Daemon, "open", open_recording)
    monkeypatch.setattr(tracing, "summarize", keep)
    res = harness.run_cell(spec, cell, 20260000003, 1.5, True, "cpu",
                           time.time(), data_dir=DATA)
    assert res["correct"], res["checks"]
    posts = sorted((a, b) for n, a, b in seen if n == "client.post")
    service = sorted((a, b) for n, a, b in seen if n == "daemon.service")
    spans = services[0].recorder.drain()
    requests = {s["request"] for s in spans}
    assert len(requests) == res["attempted"] == len(posts)
    for s in spans:
        assert any(a <= s["start_ns"] <= s["end_ns"] <= b for a, b in posts)
        if s["name"].startswith(("service.", "executor.")):
            assert any(a <= s["start_ns"] <= s["end_ns"] <= b
                       for a, b in service), s
    m = {k: v["value"] for k, v in res["metrics"].items()}
    assert set(m) == {f"{n}.{var}" for n in ("daemon_share", "wire_share",
                                             "row_fill")}
    assert 0 <= m[f"wire_share.{var}"] <= m[f"daemon_share.{var}"] <= 1
    assert 0 < m[f"row_fill.{var}"] <= 1
