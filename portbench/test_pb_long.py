"""CPU tests of the readers of the long-document cell (``long_*``) on
hand-made records, and a traced run of a /match_long mix at test size."""

import time

import pytest

from portbench import harness

DATA = harness.HERE / "testdata"
PATTERN = "/agggtaaa|tttaccct/"


def _row(n, **kw):
    row = dict.fromkeys(("requests", "chars", "windows", "window_rows",
                         "window_levels", "or_rounds", "or_rows", "or_s"), 0)
    row.update(requests=n, chars=1024 * n, windows=19 * n,
               window_rows=892 * 19 * n, window_levels=11 * n,
               or_rounds=3 * n, or_rows=9 * n, **kw)
    return row


def _rec(trace=None):
    from fhe_regex_tpu_torch.params import get_params

    before = {"long": {PATTERN: _row(2, or_s=0.1)},
              "requests": {"/match_long": {"service_s": 4.0}}}
    after = {"long": {PATTERN: _row(6, or_s=0.4)},
             "requests": {"/match_long": {"service_s": 14.0}}}
    return {"params": get_params("TPU_MESSAGE_2_CARRY_2"),
            "stats_before": before, "stats_after": after, "trace": trace,
            "requests": [{"pattern": PATTERN, "contents": ["x"]}] * 4}


def test_long_readers_on_a_record():
    from portbench.roofline import least_seconds

    rec = _rec({"busy_s": 9.0, "window_s": 10.0, "rotation_s": 8.0,
                "first": 1})
    assert harness.reader("long_rotations_per_content")(rec) == \
        892 * 19 + 9
    assert harness.reader("long_or_share")(rec) == pytest.approx(0.3 / 10)
    least = 3 * least_seconds(rec["params"], 892 * 19 + 9, 11 + 3)
    assert harness.reader("long_roofline")(rec) == pytest.approx(
        100 * least / 8.0)
    assert harness.reader("idle_share.long")(rec) == pytest.approx(0.1)


def test_long_readers_read_nothing_from_a_program_without_the_table():
    rec = _rec({"busy_s": 9.0, "window_s": 10.0, "rotation_s": 8.0,
                "first": 1})
    for stats in (rec["stats_before"], rec["stats_after"]):
        del stats["long"]
    for name in ("long_rotations_per_content", "long_or_share",
                 "long_roofline"):
        assert harness.reader(name)(rec) is None
        assert harness.reader(name)(_rec()) is not None or \
            name == "long_roofline"


def test_traced_long_run_at_test_size_reads_its_metrics():
    cell = "tiny32.tiny_long"
    spec = {"workloads": [{"name": cell, "config": "tiny32",
                           "traffic": "tiny_long", "chips": 1}],
            "end_to_end": [{"name": "contents_per_s", "unit": "contents/s"}],
            "per_layer": [{"name": n, "unit": "x"} for n in (
                "idle_share.long", "wire_share.long",
                "long_rotations_per_content", "long_or_share",
                "long_roofline", "row_fill.long",
                "launches_per_content.long")]}
    res = harness.run_cell(spec, cell, 20260000018, 1.0, True, "cpu",
                           time.time(), data_dir=DATA)
    assert res["correct"], res["checks"]
    m = {k: v["value"] for k, v in res["metrics"].items()}
    # the CPU trace holds no device operation: no roofline, all idle
    assert set(m) == {"idle_share.long", "wire_share.long",
                      "long_rotations_per_content", "long_or_share",
                      "row_fill.long", "launches_per_content.long"}
    # the window plan's levels and the OR rounds fill part of their rows;
    # the plain CPU rotation launches no kernel
    assert 0 < m["row_fill.long"] < 1
    assert m["launches_per_content.long"] == 0
    assert m["idle_share.long"] == 1.0
    assert 0 < m["wire_share.long"] < 1
    assert 0 < m["long_or_share"] < 1
    from fhe_regex_tpu_torch.models.patterns import CompiledPattern
    from fhe_regex_tpu_torch.params import get_params

    c = CompiledPattern("/a[bc]d/", params=get_params("TEST_PARAMS_NOISY"),
                        multivalue=None).circuit(64)
    assert m["long_rotations_per_content"] == 2 * c.rotation_count + 1
    res = harness.run_cell(spec, cell, 20260000018, 1.0, False, "cpu",
                           time.time(), data_dir=DATA)
    assert res["correct"] and set(res["metrics"]) == {"contents_per_s"}
