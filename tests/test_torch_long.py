"""Long documents on the port's daemon: ``MatchService.match_long`` and the
HTTP route ``/match_long`` on DNA chunks at ``TEST_PARAMS``.

* Seeded random DNA chunks (hits with a planted variant, and misses) of
  three of regex-redux's nine variant patterns, in windows small enough
  that the OR tree of the windows' bits takes two or more rounds: each
  served answer decrypts to Python ``re.search`` on the whole chunk and is
  ``has_match_long``'s ciphertext bit for bit.
* The window circuit is a cached program: a repeated request compiles
  nothing and uploads no plan, and the warm-up manifest's ``"long"``
  entries leave nothing for the first request to compile.
* A request downloads one row, its answer; the OR rounds are executor
  steps under "or" in ``launches_by_width`` and ``executor.level`` spans.
* The ``/stats`` ``long`` counters equal the window layout, the circuit
  and the OR tree counted by hand.
"""

import json
import re
import threading
import urllib.request

import numpy as np
import pytest
import torch

import fhe_regex_tpu_torch as port
from fhe_regex_tpu_torch import serve
from fhe_regex_tpu_torch.regex import executor as tex

torch.set_num_threads(2)

# three of regex-redux's nine variants, each with its 8-character spellings
VARIANTS = {
    "/agggtaaa|tttaccct/": ["agggtaaa", "tttaccct"],
    "/[cgt]gggtaaa|tttaccc[acg]/": ["cgggtaaa", "ggggtaaa", "tgggtaaa",
                                    "tttaccca", "tttacccc", "tttacccg"],
    "/agggtaa[cgt]|[acg]ttaccct/": ["agggtaac", "agggtaag", "agggtaat",
                                    "attaccct", "cttaccct", "gttaccct"],
}
DNA = "a" * 30 + "c" * 20 + "g" * 20 + "t" * 30
L = 40          # a chunk: windows of 16 (stride 8) or 12 (stride 4)


def _chunk(pattern: str, hit: bool, seed: int) -> str:
    rng = np.random.default_rng(seed)
    s = "".join(DNA[i] for i in rng.integers(len(DNA), size=L))
    if hit:
        a = int(rng.integers(0, L - 8))
        words = VARIANTS[pattern]
        s = s[:a] + words[int(rng.integers(len(words)))] + s[a + 8:]
    return s


def _or_tree_by_hand(M: int):
    """(rounds, bootstraps) of an OR tree of triples, a lone bit carried."""
    rounds = rows = 0
    while M > 1:
        rounds += 1
        rows += M // 3 + (M % 3 == 2)
        M = M // 3 + (M % 3 != 0)
    return rounds, rows


@pytest.fixture(scope="module")
def keys():
    return port.gen_keys(port.get_params("TEST_PARAMS"), seed=18)


@pytest.fixture(scope="module")
def daemon(keys):
    """(URL, MatchService) of the port's daemon on the CPU."""
    svc = serve.MatchService(keys[1], device="cpu")
    srv = serve.make_server(svc, port=0)
    t = threading.Thread(target=srv.serve_forever, daemon=True)
    t.start()
    yield f"http://127.0.0.1:{srv.server_address[1]}", svc
    srv.shutdown()
    srv.server_close()
    t.join(timeout=10)


def _post(url, path, obj):
    req = urllib.request.Request(url + path, json.dumps(obj).encode(),
                                 {"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=300) as r:
        return json.loads(r.read())


def _stats(url):
    with urllib.request.urlopen(url + "/stats", timeout=60) as r:
        return json.loads(r.read())


@pytest.mark.parametrize("hit", [True, False])
@pytest.mark.parametrize("pattern", sorted(VARIANTS))
@pytest.mark.parametrize("window", [16, 12])
def test_served_answer_is_re_search_and_has_match_long(keys, daemon, pattern,
                                                       hit, window):
    ck, sk = keys
    url, _ = daemon
    seed = 1800 + 2 * sorted(VARIANTS).index(pattern) + hit
    s = _chunk(pattern, hit, seed)
    ct = port.encrypt_str(ck, s)
    W, starts = port._window_plan(8, L, window)
    assert _or_tree_by_hand(len(starts))[0] >= 2
    req = {"pattern": pattern, "window": window,
           "ct": serve.encode_array(ct)}
    got = serve.decode_array(_post(url, "/match_long", req)["ct"])
    want = int(re.search(pattern[1:-1], s) is not None)
    assert port.decrypt(ck, got) == want
    if hit:
        assert want == 1
    ref = port.has_match_long(sk, ct, pattern, window=window, device="cpu")
    assert got.dtype == ref.dtype and np.array_equal(got, ref)


def _plan_caches(circuit):
    return {k: dict(v) for k, v in circuit.__dict__.items()
            if k.startswith("_torch_")}


def test_repeated_request_compiles_and_uploads_nothing(keys, daemon):
    ck, _ = keys
    url, svc = daemon
    pattern = "/agggtaaa|tttaccct/"
    req = {"pattern": pattern, "window": 12,
           "ct": serve.encode_array(port.encrypt_str(ck, _chunk(
               pattern, True, 1)))}
    _post(url, "/match_long", req)
    before = _stats(url)
    prog = svc._program(pattern, "tree", None, None, False)
    circuit = prog.circuit(12)
    caches = _plan_caches(circuit)
    trees, luts = dict(svc.executor._or_trees), svc.executor._or_luts
    _post(url, "/match_long", req)
    after = _stats(url)
    assert after["plan_misses"] == before["plan_misses"]
    assert len(after["programs"]) == len(before["programs"])
    assert prog.circuit(12) is circuit
    again = _plan_caches(circuit)
    assert again.keys() == caches.keys()
    for k, v in again.items():
        assert v.keys() == caches[k].keys()
        assert all(v[x] is caches[k][x] for x in v)
    assert svc.executor._or_trees == trees
    assert svc.executor._or_luts is luts
    # the window circuit is a program of /stats at the window's length
    row = next(p for p in after["programs"] if p["pattern"] == pattern
               and p["multivalue"] is None)
    assert "12" in row["lengths"]


def test_warmup_long_leaves_nothing_to_compile(keys):
    ck, sk = keys
    svc = serve.MatchService(sk, device="cpu")
    pattern = "/agggtaa[cgt]|[acg]ttaccct/"
    report = svc.warmup([{"pattern": pattern, "content_len": L,
                          "long": True, "window": 12}])
    assert report[0]["long"] is True
    misses = svc.stats()["plan_misses"]
    circuit = svc._program(pattern, "tree", None, None, False).circuit(12)
    M = len(port._window_plan(8, L, 12)[1])
    assert (M, False, "cpu") in circuit.__dict__["_torch_rows_many"]
    assert M in svc.executor._or_trees
    s = _chunk(pattern, True, 3)
    out = svc.match_long(pattern, port.encrypt_str(ck, s), 12)
    assert port.decrypt(ck, out) == 1
    assert svc.stats()["plan_misses"] == misses


def test_one_download_and_or_rounds_are_executor_steps(keys, monkeypatch):
    ck, sk = keys
    svc = serve.MatchService(sk, device="cpu")
    pattern = "/[cgt]gggtaaa|tttaccc[acg]/"
    ct = port.encrypt_str(ck, _chunk(pattern, True, 4))
    svc.match_long(pattern, ct, 12)           # compile and upload first
    by_width = svc.executor.launches_by_width()
    downloads = []
    real_cpu = torch.Tensor.cpu

    def counted_cpu(t, *a, **kw):
        downloads.append(tuple(t.shape))
        return real_cpu(t, *a, **kw)

    monkeypatch.setattr(torch.Tensor, "cpu", counted_cpu)
    svc.recorder.start()
    with svc.recorder.request():
        out = svc.match_long(pattern, ct, 12)
    monkeypatch.undo()
    spans = svc.recorder.drain()
    assert port.decrypt(ck, out) == 1
    assert downloads == [(ct.shape[-1],)]
    M = len(port._window_plan(8, L, 12)[1])
    rounds, rows = _or_tree_by_hand(M)
    ors = [sp for sp in spans
           if sp["name"] == "executor.level" and sp["width"] == "or"]
    assert len(ors) == rounds
    assert sum(sp["rows_needed"] for sp in ors) == rows
    assert all(sp["parent"] == "long.or_reduce" for sp in ors)
    (red,) = [sp for sp in spans if sp["name"] == "long.or_reduce"]
    assert red["start_ns"] <= min(sp["start_ns"] for sp in ors)
    assert red["end_ns"] >= max(sp["end_ns"] for sp in ors)
    after = svc.executor.launches_by_width()["or"]
    assert after["steps"] - by_width["or"]["steps"] == rounds
    assert after["rows_needed"] - by_width["or"]["rows_needed"] == rows
    assert after["rows_launched"] - by_width["or"]["rows_launched"] == \
        rounds * tex.default_min_bucket()


def test_stats_long_counts_windows_rows_and_or_tree(keys):
    ck, sk = keys
    svc = serve.MatchService(sk, device="cpu")
    done = {}
    for pattern, window in (("/agggtaaa|tttaccct/", 12),
                            ("/agggtaaa|tttaccct/", 16),
                            ("/agggtaa[cgt]|[acg]ttaccct/", 16)):
        ct = port.encrypt_str(ck, _chunk(pattern, False, 5))
        svc.match_long(pattern, ct, window)
        W, starts = port._window_plan(8, L, window)
        c = svc._program(pattern, "tree", None, None, False).circuit(W)
        rounds, rows = _or_tree_by_hand(len(starts))
        want = done.setdefault(pattern, dict.fromkeys(
            ("requests", "chars", "windows", "window_rows", "window_levels",
             "or_rounds", "or_rows"), 0))
        for k, v in (("requests", 1), ("chars", L),
                     ("windows", len(starts)),
                     ("window_rows", c.rotation_count * len(starts)),
                     ("window_levels", len(c.levels)),
                     ("or_rounds", rounds), ("or_rows", rows)):
            want[k] += v
    # an anchored pattern takes the direct circuit and counts no window
    svc.match_long("/^agggtaaa/", port.encrypt_str(ck, "agggtaaa" * 5))
    got = svc.stats()["long"]
    assert set(got) == set(done)
    for pattern, want in done.items():
        row = dict(got[pattern])
        assert row.pop("or_s") > 0
        assert row == want
