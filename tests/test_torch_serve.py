"""The PyTorch port's serving daemon (fhe_regex_tpu_torch/serve.py) against
the JAX package's.

Both daemons run behind ``make_server(..., port=0)`` in this process: the
JAX package's ``MatchService(sk, backend="jnp")`` and the port's
``MatchService(sk, backend="torch", device="cpu")`` under the converted
keys.  The client sends each request to both over HTTP and holds the
port's answer to the JAX package's, bit for bit (``/compile``: the same
stats), and decrypts it with the client key the servers never see.  Also:
``/health``, ``/stats`` with the watchdog's ``launch_ema_s``, the warmup
manifest, clean 400s, and no daemon without CUDA unless ``device="cpu"``.

Tolerance is zero.  Contents are real (noisy) encryptions from the JAX
package at ``TEST_PARAMS_NOISY``.
"""

import json
import threading
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch

import fhe_regex_tpu as J
from fhe_regex_tpu import serve as jserve

import fhe_regex_tpu_torch as port
from fhe_regex_tpu_torch import serve
from fhe_regex_tpu_torch.convert import client_key_from_jax, server_key_from_jax

torch.set_num_threads(2)


@pytest.fixture(scope="module")
def both(noisy_keys):
    """(JAX keys, port keys) for TEST_PARAMS_NOISY."""
    ck, sk = noisy_keys
    return (ck, sk), (client_key_from_jax(ck), server_key_from_jax(sk))


@pytest.fixture(scope="module")
def servers(both):
    """(port daemon URL, JAX daemon URL, port MatchService)."""
    (_, sk), (_, tsk) = both
    svc = serve.MatchService(tsk, backend="torch", device="cpu")
    srvs = [serve.make_server(svc, port=0),
            jserve.make_server(jserve.MatchService(sk, backend="jnp"),
                               port=0)]
    threads = [threading.Thread(target=s.serve_forever, daemon=True)
               for s in srvs]
    for t in threads:
        t.start()
    yield tuple(f"http://127.0.0.1:{s.server_address[1]}"
                for s in srvs) + (svc,)
    for s, t in zip(srvs, threads):
        s.shutdown()
        s.server_close()
        t.join(timeout=10)


def _post(url, path, obj):
    req = urllib.request.Request(url + path, json.dumps(obj).encode(),
                                 {"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=300) as r:
        return json.loads(r.read())


def _get(url, path):
    with urllib.request.urlopen(url + path, timeout=60) as r:
        return json.loads(r.read())


# (path, request with {"one": str} / {"many": [str]} for the ciphertext,
#  expected decryption of the answer)
CASES = {
    "match": ("/match", {"pattern": "/ab?c/", "ct": {"one": "xabcx"}}, 1),
    "match_mv": ("/match", {"pattern": "/^[a-d][^xyz]$/i", "multivalue": True,
                            "ct": {"one": "bq"}}, 1),
    "match_patterns": ("/match", {"patterns": ["/ab?c/", "/^x/", "/./"],
                                  "ct": {"one": "abc"}}, [1, 0, 1]),
    "match_positions": ("/match", {"pattern": "/abc/", "positions": True,
                                   "ct": {"one": "abcabc"}},
                        [1, 0, 0, 1, 0, 0]),
    "match_many": ("/match_many", {"pattern": "/abc/",
                                   "ct": {"many": ["abcx", "xxxx", "xabc"]}},
                   [1, 0, 1]),
    "match_many_patterns": ("/match_many",
                            {"patterns": ["/abc/", "/x{2}/"],
                             "ct": {"many": ["abcx", "xxxx"]}},
                            [[1, 0], [0, 1]]),
    "match_many_positions": ("/match_many",
                             {"pattern": "/abc/", "positions": True,
                              "ct": {"many": ["abcx", "xabc"]}},
                             [[1, 0, 0, 0], [0, 1, 0, 0]]),
    "match_long": ("/match_long", {"pattern": "/abc/", "window": 6,
                                   "ct": {"one": "xxxxxxxxabcx"}}, 1),
    "count": ("/count", {"pattern": "/abc/", "ct": {"one": "abcabxabc"}}, 2),
}


def _bits(tck, res):
    """Decrypted match bits of a result with any leading axes."""
    return (port.decrypt(tck, res) if res.ndim == 2
            else [_bits(tck, r) for r in res])


@pytest.mark.parametrize("case", sorted(CASES))
def test_endpoint_equals_jax(both, servers, case):
    """The same request to both daemons: the port's ciphertext equals the
    JAX package's, and decrypts to the expected answer."""
    (ck, _), (tck, _) = both
    turl, jurl, _ = servers
    path, req, want = CASES[case]
    req = dict(req)
    c = req["ct"]
    req["ct"] = serve.encode_array(
        J.encrypt_str(ck, c["one"]) if "one" in c
        else np.stack([J.encrypt_str(ck, s) for s in c["many"]]))
    got = serve.decode_array(_post(turl, path, req)["ct"])
    ref = jserve.decode_array(_post(jurl, path, req)["ct"])
    assert got.dtype == ref.dtype and np.array_equal(got, ref)
    if case == "count":
        assert port.decrypt_count(tck, got) == want
    else:
        assert _bits(tck, got) == want


@pytest.mark.parametrize("req", [
    {"pattern": "/ab?c/", "content_len": 3},
    {"patterns": ["/abc/", "/abd/"], "content_len": 4},
    {"pattern": "/abc/", "positions": True, "content_len": 6},
])
def test_compile_equals_jax(servers, req):
    """/compile: the same circuit stats (counts, levels, p_fail) as the
    JAX daemon's."""
    turl, jurl, _ = servers
    got = _post(turl, "/compile", req)
    assert got == _post(jurl, "/compile", req)
    assert got["bootstraps"] > 0 and got["levels"] > 0


def test_health(servers):
    turl, _, _ = servers
    assert _get(turl, "/health") == {"status": "ok",
                                     "params": "TEST_PARAMS_NOISY",
                                     "backend": "torch"}


def test_stats_counts_and_launch_ema(both, servers):
    """/stats counts the requests and, after the watchdog's discarded and
    seeding runs, shows launch_ema_s for a "levels" and a "many" shape;
    a profiled /match leaves its per-level timings."""
    (ck, _), (tck, _) = both
    turl, _, _ = servers
    one = serve.encode_array(J.encrypt_str(ck, "xab"))
    many = serve.encode_array(np.stack([J.encrypt_str(ck, s)
                                        for s in ("xab", "yyy")]))
    before = _get(turl, "/stats")["requests"].get("/match", {"count": 0})
    for _ in range(3):
        out = _post(turl, "/match", {"pattern": "/ab/", "ct": one,
                                     "profile": True})
        _post(turl, "/match_many", {"pattern": "/ab/", "ct": many})
    assert port.decrypt(tck, serve.decode_array(out["ct"])) == 1
    stats = _get(turl, "/stats")
    assert stats["requests"]["/match"]["count"] == before["count"] + 3
    assert stats["requests"]["/match_many"]["count"] >= 3
    ema = stats["launch_ema_s"]
    assert any(k.startswith("('levels'") for k in ema)
    assert any(k.startswith("('many'") for k in ema)
    prog = next(p for p in stats["programs"] if p["pattern"] == "/ab/")
    assert prog["lengths"]["3"]["bootstraps"] > 0
    prof = stats["last_profile"]
    assert prof["pattern"] == "/ab/" and prof["content_len"] == 3
    assert prof["levels"] and all("seconds" in lv for lv in prof["levels"])
    assert prof["p_fail"]["pbs_count"] > 0


def test_stats_kernel_launches(both, servers):
    """/stats reports every CUDA kernel wrapper's launch count; the CPU
    path takes the plain versions, so a /match launches none."""
    from fhe_regex_tpu_torch.ops import pbs_cuda

    (ck, _), _ = both
    turl, _, _ = servers
    one = serve.encode_array(J.encrypt_str(ck, "xab"))
    _post(turl, "/match", {"pattern": "/ab/", "ct": one})
    got = _get(turl, "/stats")["kernel_launches"]
    assert got == pbs_cuda.launch_counts()
    assert set(got) == {k.__name__ for k in pbs_cuda.KERNELS}
    assert len(got) == 8 and not any(got.values())


def test_stats_rotation_steps(both, servers):
    """/stats reports the 32-bit fused rotations' CMUX steps x rows by
    path, beside and not inside ``kernel_launches`` (whose keys are the
    wrappers'); the CPU path takes neither."""
    from fhe_regex_tpu_torch.ops import pbs_cuda

    (ck, _), _ = both
    turl, _, _ = servers
    one = serve.encode_array(J.encrypt_str(ck, "xab"))
    _post(turl, "/match", {"pattern": "/ab/", "ct": one})
    stats = _get(turl, "/stats")
    assert stats["rotation_steps"] == pbs_cuda.rotation_steps()
    assert set(stats["rotation_steps"]) == {"spectral", "spectral_pair",
                                            "limb"}
    assert not set(stats["rotation_steps"]) & set(stats["kernel_launches"])


@pytest.mark.parametrize("req", [
    {"pattern": "/[0-9]/"},                              # Q4: parse error
    {"pattern": "/a*bc/", "branch_budget": 1},           # budget exceeded
    {"patterns": ["/a/"], "positions": True},            # single pattern only
])
def test_bad_request_is_clean_400(both, servers, req):
    (ck, _), _ = both
    turl, _, _ = servers
    req = dict(req, ct=serve.encode_array(J.encrypt_str(ck, "aaabc")))
    with pytest.raises(urllib.error.HTTPError) as ei:
        _post(turl, "/match", req)
    assert ei.value.code == 400
    assert "error" in json.loads(ei.value.read())


def test_warmup_manifest(both):
    """Each manifest entry compiles and runs its shapes ("many": C the
    packed plan too); a later match finds the cached program."""
    (ck, _), (tck, tsk) = both
    svc = serve.MatchService(tsk, backend="torch", device="cpu")
    report = svc.warmup([
        {"pattern": "/ab?c/", "content_len": 3, "many": 2},
        {"patterns": ["/ab/", "/bc$/"], "content_len": 3},
    ])
    assert len(report) == 2
    assert report[0]["seconds"] >= 0 and report[0]["many"] == 2
    assert len(svc._programs) == 2
    out = svc.match("/ab?c/", J.encrypt_str(ck, "abc"))
    assert port.decrypt(tck, out) == 1
    assert len(svc._programs) == 2


def test_no_cuda_no_daemon(both, monkeypatch):
    """device=None means CUDA: without a card MatchService and serve.main
    raise, and device="cpu" still serves."""
    (_, _), (_, tsk) = both
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        serve.MatchService(tsk)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        serve.main(["--params", "TEST_PARAMS", "--seed", "1", "--port", "0"])
    assert serve.MatchService(tsk, device="cpu").device.type == "cpu"


def test_encode_decode_match_jax():
    """The wire format is the JAX daemon's."""
    a = np.arange(24, dtype=np.uint64).reshape(2, 3, 4)
    enc = serve.encode_array(a)
    assert enc == jserve.encode_array(a)
    assert np.array_equal(jserve.decode_array(enc), a)
    assert serve.decode_array(enc).dtype == np.uint64
