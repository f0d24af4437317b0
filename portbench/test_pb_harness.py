"""CPU tests of the harness: discovery by name, traffic, the arithmetic of
the metrics, the frozen bounds, the import check."""

import json
import sys
import types

import numpy as np
import pytest

from portbench import harness, measure, roofline, tfhe, tracing
from portbench.traffic import Traffic, charset, render

SPEC = harness.load_json(harness.CHECKOUT / "BENCHMARK.json")


def test_every_cell_finds_its_files_by_name():
    for w in SPEC["workloads"]:
        cfg = harness.load_json(harness.HERE / "configs" / f"{w['config']}.json")
        mix = harness.load_json(harness.HERE / "mixes" / f"{w['traffic']}.json")
        assert cfg["name"] == w["config"]
        assert set(mix["cycle"]) <= set(mix["shapes"])
        assert w["name"] == f"{w['config']}.{w['traffic']}"
        for trace in (False, True):
            names = [m["name"] for m in harness.cell_metrics(SPEC, w["name"],
                                                             trace)]
            assert names, (w["name"], trace)
            for name in names:
                assert callable(harness.reader(name))
    for c in SPEC["configs"]:
        assert (harness.CHECKOUT / c["file"]).exists()


def test_every_per_layer_metric_moves_a_metric_its_cells_report():
    e2e = {m["name"]: m for m in SPEC["end_to_end"]}
    for m in SPEC["per_layer"]:
        moved = e2e[m["moves"]]
        for cell in m["workloads"]:
            assert cell in moved.get("workloads", [cell])


def test_config_params_are_the_programs():
    for c in SPEC["configs"]:
        harness.port_params(harness.load_json(harness.CHECKOUT / c["file"]))


def test_harness_names_no_config_mix_or_metric():
    names = ([c["name"] for c in SPEC["configs"]]
             + [w["traffic"] for w in SPEC["workloads"]]
             + [m["name"] for m in SPEC["end_to_end"] + SPEC["per_layer"]])
    for f in ("run.py", "harness.py", "daemon.py", "client.py", "traffic.py"):
        src = (harness.HERE / f).read_text()
        for n in names:
            assert f'"{n}"' not in src and f"'{n}'" not in src, (f, n)


def test_traffic_repeats_for_a_seed_and_keeps_the_cycle():
    mix = harness.load_json(harness.HERE / "mixes" / "single6.json")
    a = [Traffic(mix, 7).next() for _ in range(1)]
    t1, t2, t3 = Traffic(mix, 7), Traffic(mix, 7), Traffic(mix, 8)
    r1 = [t1.next() for _ in range(28)]
    r2 = [t2.next() for _ in range(28)]
    r3 = [t3.next() for _ in range(28)]
    assert [(r.shape, r.contents) for r in r1] == [(r.shape, r.contents)
                                                  for r in r2]
    assert [(r.shape, r.contents) for r in r1] != [(r.shape, r.contents)
                                                  for r in r3]
    assert a[0].contents == r1[0].contents
    cyc = len(mix["cycle"])
    for k in range(0, 28, cyc):
        assert sorted(r.shape for r in r1[k:k + cyc]) == sorted(mix["cycle"])
    for r in r1:
        assert len(r.contents[0]) == mix["shapes"][r.shape]["content_len"]


def test_templates_render_to_their_length():
    rng = np.random.default_rng(3)
    assert charset("a-cXY") == ["a", "b", "c", "X", "Y"]
    tpl = [{"chars": "a-z", "min": 0, "max": 13}, {"words": ["abc"]},
           {"chars": "a-z", "min": 0, "max": 13}]
    for _ in range(50):
        s = render(tpl, 16, rng)
        assert len(s) == 16 and "abc" in s


def test_encryptions_are_fresh_and_decrypt():
    mix = harness.load_json(harness.HERE / "mixes" / "many32.json")
    for name in ("tiny32", "tiny64"):
        cfg = harness.load_json(harness.HERE / "testdata" / "configs"
                                / f"{name}.json")
        p = tfhe.Params.from_config(cfg)
        ck, bsk, ksk = tfhe.gen_keys(p, 11, "cpu")
        ck2, bsk2, _ = tfhe.gen_keys(p, 11, "cpu")
        assert np.array_equal(bsk, bsk2) and np.array_equal(ck.lwe_key,
                                                            ck2.lwe_key)
        assert bsk.dtype == p.word and ksk.dtype == p.word
        req = Traffic(mix, 5).next()
        rng = np.random.default_rng(1)
        a = tfhe.encrypt_contents(ck, req.contents, rng)
        b = tfhe.encrypt_contents(ck, req.contents, rng)
        assert a.shape == (32, 16, p.num_blocks, p.lwe_dimension + 1)
        assert not np.array_equal(a, b)
        want = tfhe.byte_blocks(p, req.contents)
        for ct in (a, b):
            ph = tfhe.phases(ck, ct)
            assert np.array_equal(np.rint(ph), want)
            assert np.abs(ph - want).max() < 0.01


def test_rate_is_all_completed_work_over_the_window():
    rec = {"window_s": 4.0, "requests": [
        {"contents": ["x"] * 32, "seconds": 1.0},
        {"contents": ["x"] * 32, "seconds": 1.5}]}
    assert harness.reader("contents_per_s")(rec) == 16.0


def test_percentiles_are_over_all_requests():
    secs = [0.1] * 80 + [1.0] * 20
    rec = {"requests": [{"seconds": s} for s in secs]}
    assert harness.reader("match_p50_s")(rec) == 0.1
    assert harness.reader("match_p90_s")(rec) == 1.0
    assert measure.percentile([1.0, 2.0, 3.0, 4.0, 5.0], 50) == 3.0
    assert measure.percentile([1.0], 50) is None


def test_union_of_intervals_and_idle_gaps():
    iv = [(0, 10), (5, 15), (20, 30), (25, 26)]
    assert measure.union_seconds(iv) == 25 / 1e9
    assert measure.gaps(iv, 0, 40) == [(15, 20), (30, 40)]
    ev = [("void ext_product<4>(int)", 0, 10), ("stage1", 10, 12),
          ("Memcpy DtoH", 20, 30)]
    spans = [("client.post", 0, 40), ("daemon.service", 0, 25)]
    s = tracing.summarize(ev, 0, 40, spans)
    assert s["busy_s"] == 22 / 1e9 and s["window_s"] == 40 / 1e9
    assert s["rotation_s"] == 12 / 1e9
    assert s["device_ops"][0] == ["ext_product<4>", 10 / 1e9]
    assert tracing.short_name(
        "void (anonymous namespace)::ext_product<4>(signed char const*, int)"
    ) == "(anonymous namespace)::ext_product<4>"
    assert tracing.short_name("") == "(unnamed)"
    assert dict(s["idle_gaps"]) == {"daemon.service": 8 / 1e9,
                                    "client.post": 10 / 1e9}
    rec = {"trace": s}
    assert harness.reader("idle_share.batch")(rec) == pytest.approx(
        1 - 22 / 40)


def test_a_variant_without_a_file_is_read_by_its_base_name():
    assert not (harness.HERE / "metrics" / "idle_share.single.py").exists()
    assert harness.reader("idle_share.single").__module__ == \
        "portbench.metrics.idle_share.single"
    rec = {"trace": {"busy_s": 3.0, "window_s": 4.0}}
    assert harness.reader("idle_share.single")(rec) == \
        harness.reader("idle_share")(rec)
    with pytest.raises(FileNotFoundError):
        harness.reader("no_such_metric.batch")


def test_counters_read_from_stats():
    stats0 = {"kernel_launches": {"a": 5, "b": 1}}
    stats1 = {"kernel_launches": {"a": 14, "b": 1},
              "programs": [{"pattern": "/abc/", "fold": "tree", "lengths": {
                  "16": {"rotations": 96, "levels": 6}}}]}
    rec = {"stats_before": stats0, "stats_after": stats1, "requests": [
        {"pattern": "/abc/", "fold": "tree", "content_len": 16,
         "contents": ["x"] * 32}]}
    assert harness.reader("rotations_per_content")(rec) == 96
    assert harness.reader("launches_per_content")(rec) == 9 / 32


@pytest.mark.parametrize("name", ["TPU_MESSAGE_2_CARRY_2",
                                  "TPU64_MESSAGE_2_CARRY_2"])
@pytest.mark.parametrize("B", [8, 256, 1024])
def test_frozen_bounds_equal_chip_smokes(name, B):
    sys.path.insert(0, str(harness.CHECKOUT))
    import chip_smoke
    from fhe_regex_tpu_torch.params import get_params

    p = get_params(name)
    assert roofline.rotation_bound(p, B, 1) == chip_smoke.rotation_bound(
        p, B, 1)
    assert roofline.rotation_bound(p, B, 3, (1, 2)) == \
        chip_smoke.rotation_bound(p, B, 3, (1, 2))
    if p.torus_bits == 32:
        assert roofline.fft_rotation_bound(p, B, 1) == \
            chip_smoke.fft_rotation_bound(p, B, 1)
        # the FFT formulation is the lesser at 32 bits
        assert roofline.least_seconds(p, B, 1) * 1e3 <= \
            roofline.rotation_bound(p, B, 1)[0]
    # one level's least time is that level's own bound
    want = min([roofline.rotation_bound(p, B, 1)[0]] + (
        [roofline.fft_rotation_bound(p, B, 1)[0]] if p.torus_bits == 32
        else []))
    assert roofline.least_seconds(p, B, 1) * 1e3 == pytest.approx(want)


def test_import_check_compares_whole_top_level_names(monkeypatch):
    assert "fhe_regex_tpu_torch" not in harness.FORBIDDEN
    monkeypatch.setitem(sys.modules, "fhe_regex_tpu_torch_extra",
                        types.ModuleType("fhe_regex_tpu_torch_extra"))
    monkeypatch.setitem(sys.modules, "jaxtyping",
                        types.ModuleType("jaxtyping"))
    assert "jax" not in harness.forbidden_modules()
    monkeypatch.setitem(sys.modules, "jax.numpy", types.ModuleType("x"))
    assert "jax" in harness.forbidden_modules()
    monkeypatch.setitem(sys.modules, "fhe_regex_tpu.params",
                        types.ModuleType("y"))
    assert "fhe_regex_tpu" in harness.forbidden_modules()


def test_benchmark_json_keys():
    assert set(SPEC) == {"command", "paths", "run_seconds", "configs",
                         "workloads", "end_to_end", "per_layer"}
    assert len(json.dumps(SPEC)) < 64 * 1024
    e2e = {m["name"] for m in SPEC["end_to_end"]}
    assert "setup_s" in e2e
