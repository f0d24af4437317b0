"""The packed serving paths of the PyTorch port against the JAX package.

* ``_chunk_sizes`` and the packed launch plans of
  ``Executor._device_chunks_many`` equal the JAX package's, array for array.
* ``has_match_many``, ``has_match_many_patterns``,
  ``has_match_many_positions``, ``has_match_patterns``,
  ``has_match_positions``, ``has_match_long`` (windowed and anchored),
  ``has_match_many_long``, ``count_matches`` and ``run_circuit`` give the
  JAX package's ciphertexts bit for bit (each package's default plan,
  which is multi-value where the packed paths' auto rule picks it; Python
  builder): the same numpy contents go through both packages under the
  same keys.
* The CLI's ``--count``, ``--positions``, ``--long`` and
  ``--branch-budget``; ``multivalue=True`` on every entry point equals the
  JAX package; a circuit flagged multi-value without its plan is refused;
  without a CUDA device the entry points raise unless ``device="cpu"`` is
  given.

Tolerance is zero.  Contents are real (noisy) encryptions from the JAX
package at ``TEST_PARAMS_NOISY``, and at ``TEST_PARAMS_64`` for one case.
"""

import numpy as np
import pytest
import torch

import fhe_regex_tpu as J
from fhe_regex_tpu.params import TEST_PARAMS_64
from fhe_regex_tpu.regex import executor as jex

import fhe_regex_tpu_torch as port
from fhe_regex_tpu_torch.convert import client_key_from_jax, server_key_from_jax
from fhe_regex_tpu_torch.regex import executor as tex
from fhe_regex_tpu_torch.regex.engine import compile_match

torch.set_num_threads(2)

JAX_KW = dict(engine="python", backend=None)


@pytest.fixture(scope="module")
def both(noisy_keys):
    """(JAX keys, port keys) for TEST_PARAMS_NOISY."""
    ck, sk = noisy_keys
    return (ck, sk), (client_key_from_jax(ck), server_key_from_jax(sk))


def _enc(ck, strings):
    return np.stack([J.encrypt_str(ck, s) for s in strings])


@pytest.mark.parametrize("wide", [False, True])
@pytest.mark.parametrize("total", [1, 63, 64, 65, 255, 256, 257, 300, 511,
                                   700, 768, 769, 1023, 1024, 1025, 1856,
                                   2900, 4000])
def test_chunk_sizes_match_jax(total, wide):
    assert tex._chunk_sizes(total, wide) == jex._chunk_sizes(total, wide)
    assert sum(tex._chunk_sizes(total, wide)) >= total


@pytest.mark.parametrize("C,wide", [(1, False), (3, False), (5, True),
                                    (48, True), (48, False)])
def test_packed_plan_matches_jax(both, C, wide):
    from fhe_regex_tpu.params import TEST_PARAMS as JP

    params = port.get_params("TEST_PARAMS")
    circuit = tex.compile_circuit(params, *compile_match(12, "/a[bc]d/",
                                                         fold="tree"))
    jc = jex.compile_circuit(JP, *J.compile_match(12, "/a[bc]d/",
                                                  fold="tree"))
    ex = port.executor_for(both[1][1], device="cpu")
    got = ex._device_chunks_many(circuit, C, wide)
    want = jex.Executor._device_chunks_many(None, jc, C, wide)
    assert ex._device_chunks_many(circuit, C, wide) is got     # cached
    assert len(got) == len(want)
    for g, w in zip(got, want):
        for a, b in zip(g, w):
            assert np.array_equal(a.numpy(), np.asarray(b))


@pytest.mark.parametrize("strings,pattern", [
    (["xabcxx", "abxabx", "zzzabc"], "/abc/"),
    (["Abx", "cdy", "xyz"], "/^ab|cd/i"),
])
def test_has_match_many_equals_jax(both, strings, pattern):
    (ck, sk), (tck, tsk) = both
    cts = _enc(ck, strings)
    want = J.has_match_many(sk, cts, pattern, **JAX_KW)
    got = port.has_match_many(tsk, cts, pattern, device="cpu")
    assert got.dtype == want.dtype and np.array_equal(got, want)
    single = [port.decrypt(tck, port.has_match(tsk, c, pattern, fold="tree",
                                               device="cpu")) for c in cts]
    assert [port.decrypt(tck, r) for r in got] == single


def test_has_match_many_wide_equals_narrow(both):
    (ck, _), (_, tsk) = both
    cts = _enc(ck, ["abcab", "bcabc"])
    narrow = port.has_match_many(tsk, cts, "/ca/", device="cpu",
                                 wide_batch=False)
    wide = port.has_match_many(tsk, cts, "/ca/", device="cpu",
                               wide_batch=True)
    assert np.array_equal(narrow, wide)


def test_has_match_many_patterns_equals_jax(both):
    (ck, sk), (tck, tsk) = both
    pats = ["/ab/", "/b.d/", "/^x/"]
    cts = _enc(ck, ["xabcd", "abxbd"])
    want = J.has_match_many_patterns(sk, cts, pats, **JAX_KW)
    got = port.has_match_many_patterns(tsk, cts, pats, device="cpu")
    assert got.shape == (2, 3) + want.shape[2:]
    assert np.array_equal(got, want)
    assert [[port.decrypt(tck, r) for r in row] for row in got] == [
        [1, 1, 1], [1, 0, 0]]


def test_has_match_many_positions_equals_jax(both):
    (ck, sk), (tck, tsk) = both
    cts = _enc(ck, ["abab", "xaby"])
    want = J.has_match_many_positions(sk, cts, "/ab/", **JAX_KW)
    got = port.has_match_many_positions(tsk, cts, "/ab/", device="cpu")
    assert np.array_equal(got, want)
    assert [[port.decrypt(tck, r) for r in row] for row in got] == [
        [1, 0, 1, 0], [0, 1, 0, 0]]


def test_has_match_patterns_and_positions_equal_jax(both):
    (ck, sk), (tck, tsk) = both
    ct = J.encrypt_str(ck, "cabcab")
    pats = ["/ca/", "/^b/", "/b$/"]
    want = J.has_match_patterns(sk, ct, pats, **JAX_KW)
    got = port.has_match_patterns(tsk, ct, pats, device="cpu")
    assert np.array_equal(got, want)
    assert [port.decrypt(tck, r) for r in got] == [1, 0, 1]
    want = J.has_match_positions(sk, ct, "/ab/", **JAX_KW)
    got = port.has_match_positions(tsk, ct, "/ab/", device="cpu")
    assert np.array_equal(got, want)
    assert [port.decrypt(tck, r) for r in got] == [0, 1, 0, 0, 1, 0]


@pytest.mark.parametrize("content,pattern,window,exp", [
    ("xxxxxxxxabcx", "/abc/", 6, 1),      # windowed: three windows + OR tree
    ("xxxxxxxxxxxx", "/abc/", 6, 0),
    ("abcxxxxxxx", "/^abc/", None, 1),    # ^: the first span+1 chars
    ("xxxxxxxabc", "/abc$/", None, 1),    # $: the last span chars
    ("abcxxxxxxx", "/^abc$/", None, 0),   # both: trivial FALSE
    # OR trees of more than one round: 4 windows (OR3 and a carried row,
    # then OR2), 5 (OR3 and OR2, then OR2) and 19 (19 -> 7 -> 3 -> 1)
    ("xxxxxxxxxxxxabc", "/abc/", 6, 1),   # the hit in the carried row
    ("xxxxxxxxxxxxxxx", "/abc/", 6, 0),
    ("xxxxxxxxxxxabcxxxx", "/abc/", 6, 1),  # the hit in the OR2 pair
    ("x" * 57 + "abc", "/abc/", 6, 1),
    ("x" * 29 + "abc" + "x" * 28, "/abc/", 6, 1),
])
def test_has_match_long_equals_jax(both, content, pattern, window, exp):
    (ck, sk), (tck, tsk) = both
    ct = J.encrypt_str(ck, content)
    want = J.has_match_long(sk, ct, pattern, window=window, **JAX_KW)
    got = port.has_match_long(tsk, ct, pattern, window=window, device="cpu")
    assert got.dtype == want.dtype and np.array_equal(got, want)
    assert port.decrypt(tck, got) == exp


def test_has_match_many_long_equals_jax(both):
    (ck, sk), (tck, tsk) = both
    cts = _enc(ck, ["xxabcxxxxxxx", "xxxxxxxxxxxx", "xxxxxxxxxabc"])
    want = J.has_match_many_long(sk, cts, "/abc/", window=6, **JAX_KW)
    got = port.has_match_many_long(tsk, cts, "/abc/", window=6, device="cpu")
    assert np.array_equal(got, want)
    assert [port.decrypt(tck, r) for r in got] == [1, 0, 1]


@pytest.mark.parametrize("L", [15, 60])
def test_has_match_many_long_tree_equals_jax(both, L):
    """Contents of 4 and 19 windows, whose OR trees take two and three
    rounds with a carried row, each hit in a different window."""
    (ck, sk), (tck, tsk) = both
    strings = ["x" * (L - 3) + "abc", "x" * L, "abc" + "x" * (L - 3),
               "x" * (L // 2) + "abc" + "x" * (L - L // 2 - 3)]
    cts = _enc(ck, strings)
    want = J.has_match_many_long(sk, cts, "/abc/", window=6, **JAX_KW)
    got = port.has_match_many_long(tsk, cts, "/abc/", window=6, device="cpu")
    assert np.array_equal(got, want)
    assert [port.decrypt(tck, r) for r in got] == [1, 0, 1, 1]


def test_count_matches_equals_jax(both):
    (ck, sk), (tck, tsk) = both
    ct = J.encrypt_str(ck, "abcabxab")
    want = J.count_matches(sk, ct, "/ab/")
    got = port.count_matches(tsk, ct, "/ab/", device="cpu")
    assert np.array_equal(got, want)
    assert port.decrypt_count(tck, got) == J.decrypt_count(ck, want) == 3


def test_run_circuit_equals_jax(both):
    (ck, sk), (tck, tsk) = both
    ct = J.encrypt_str(ck, "xab")
    jb, jroot = J.compile_match(3, "/ab/", num_blocks=sk.params.num_blocks)
    want = J.run_circuit(sk, jb, jroot, ct)
    b, root = compile_match(3, "/ab/", num_blocks=tsk.params.num_blocks)
    got = port.run_circuit(tsk, b, root, ct, device="cpu")
    assert np.array_equal(got, want) and port.decrypt(tck, got) == 1
    jb, jroots = J.compile_match(3, "/ab/", num_blocks=sk.params.num_blocks)
    b, roots = compile_match(3, "/ab/", num_blocks=tsk.params.num_blocks)
    got = port.run_circuit(tsk, b, [roots, roots], ct, device="cpu")
    assert np.array_equal(got, J.run_circuit(sk, jb, [jroots, jroots], ct))


def test_has_match_many_64bit_equals_jax():
    from fhe_regex_tpu.crypto.keys import gen_keys

    ck, sk = gen_keys(TEST_PARAMS_64, seed=5)
    tck, tsk = client_key_from_jax(ck), server_key_from_jax(sk)
    cts = _enc(ck, ["xab", "bax"])
    want = J.has_match_many(sk, cts, "/ab/", **JAX_KW)
    got = port.has_match_many(tsk, cts, "/ab/", device="cpu")
    assert got.dtype == np.uint64 and np.array_equal(got, want)
    assert [port.decrypt(tck, r) for r in got] == [1, 0]


def test_cli_serving_flags(capsys):
    from fhe_regex_tpu_torch.cli import main

    args = ["--params", "TEST_PARAMS", "--trivial", "--device", "cpu",
            "--seed", "1"]
    assert main(args + ["--count", "abcab", "/ab/"]) == 0
    assert main(args + ["--positions", "abcab", "/ab/"]) == 0
    assert main(args + ["--long", "xxxxxxxxxxxxxxxxxabcx", "/abc/"]) == 0
    assert capsys.readouterr().out.splitlines() == [
        "count: 2", "positions: 10010", "res: 1"]
    assert main(args + ["--branch-budget", "2", "abcab",
                        "/a{1,4}b{1,4}/"]) == 3


PACKED = ["has_match_many", "has_match_many_patterns",
          "has_match_many_positions", "has_match_many_long"]
SINGLE = ["has_match", "has_match_patterns", "has_match_positions",
          "has_match_long"]


@pytest.mark.parametrize("name", PACKED + SINGLE)
def test_multivalue_not_ported(both, name):
    """multivalue=True, which raised before multi-value bootstrapping was
    ported, now runs on every entry point and equals the JAX package."""
    (ck, sk), (_, tsk) = both
    ct = _enc(ck, ["ab"])
    arg = ["/a/"] if "patterns" in name else "/a/"
    x = ct if name in PACKED else ct[0]
    got = getattr(port, name)(tsk, x, arg, device="cpu", multivalue=True)
    want = getattr(J, name)(sk, x, arg, multivalue=True, **JAX_KW)
    assert got.dtype == want.dtype and np.array_equal(got, want)


def test_run_many_refuses_multivalue_circuit(both):
    """A circuit flagged multi-value without its multi-value plan (the
    level plans of compile_circuit(multivalue=True)) is refused."""
    circuit = tex.compile_circuit(both[1][1].params,
                                  *compile_match(2, "/a/"))
    circuit.multivalue = True
    ex = port.executor_for(both[1][1], device="cpu")
    with pytest.raises(ValueError, match="multi-value plan"):
        ex.run_many(circuit, _enc(both[0][0], ["ab"]))
    with pytest.raises(ValueError, match="multi-value plan"):
        ex.run(circuit, _enc(both[0][0], ["ab"])[0])


def test_no_cuda_needs_explicit_cpu(both, monkeypatch, capsys):
    """device=None means CUDA: without a card the entry points raise and
    name device="cpu", which still works."""
    (ck, _), (tck, tsk) = both
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match='device="cpu"'):
        port.executor_for(tsk)
    assert port.executor_for(tsk, device="cpu").device.type == "cpu"
    ct = J.encrypt_str(ck, "ab")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        port.has_match(tsk, ct, "/a/")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        port.has_match_many(tsk, ct[None], "/a/")
    assert port.decrypt(tck, port.has_match(tsk, ct, "/a/",
                                            device="cpu")) == 1
    from fhe_regex_tpu_torch.cli import main

    assert main(["--params", "TEST_PARAMS", "--trivial", "abc", "/b/"]) == 2
    assert "no CUDA device" in capsys.readouterr().err


def test_wide_batch_default(both, monkeypatch):
    """wide_batch=None: on for a CUDA device, off elsewhere, and
    FHE_REGEX_WIDE_BATCH overrides (as the JAX package resolves it)."""
    seen = []
    real = tex._chunk_sizes

    def spy(total, use_wide):
        seen.append(use_wide)
        return real(total, use_wide)

    monkeypatch.setattr(tex, "_chunk_sizes", spy)
    (ck, _), (_, tsk) = both
    cts = _enc(ck, ["ab"])
    monkeypatch.delenv("FHE_REGEX_WIDE_BATCH", raising=False)
    port.has_match_many(tsk, cts, "/b/", device="cpu")
    monkeypatch.setenv("FHE_REGEX_WIDE_BATCH", "1")
    port.has_match_many(tsk, cts, "/ab/", device="cpu")
    assert seen and not any(seen[:1]) and seen[-1] is True
