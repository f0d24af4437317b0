"""The plain reference against the port, and its judgement of replies."""

import numpy as np
import pytest

from portbench import harness, reference
from portbench.traffic import render

SHAPES = harness.load_json(harness.HERE / "mixes" / "single6.json")["shapes"]


@pytest.mark.parametrize("name", sorted(SHAPES))
def test_reference_agrees_with_the_port(name):
    """Every shape of single6 at TEST_PARAMS (trivial ciphertexts, the
    port's plain path on the CPU): hits and misses of its templates and
    edge contents, the port's decrypted bit equal to the reference's."""
    from fhe_regex_tpu_torch import (decrypt, gen_keys, has_match_many,
                                     trivial_encrypt_str)
    from fhe_regex_tpu_torch.params import TEST_PARAMS

    shape = SHAPES[name]
    L = shape["content_len"]
    rng = np.random.default_rng(sum(map(ord, name)))
    contents = [render(shape[kind], L, rng) for kind in ("hit", "miss")
                for _ in range(4)]
    contents += ["a" * L, "A" * L]
    ck, sk = gen_keys(TEST_PARAMS, seed=1)
    cts = np.stack([trivial_encrypt_str(TEST_PARAMS, c) for c in contents])
    got = has_match_many(sk, cts, shape["pattern"], device="cpu")
    bits = [decrypt(ck, g) for g in got]
    want = [reference.expected_bit(shape["pattern"], c) for c in contents]
    assert bits == want, list(zip(contents, bits, want))
    assert 0 < sum(want[:8]) < 8, "templates give hits and misses"


@pytest.mark.parametrize("pattern,content,bit", [
    ("/^abc$/", "abc", 1), ("/^abc$/", "abcd", 0), ("/abc/", "xxabcx", 1),
    ("/^[a-d][^xyz]$/i", "bq", 1), ("/^[a-d][^xyz]$/i", "aq", 0),
    ("/^[a-d][^xyz]$/i", "Bq", 0), ("/^[a-d][^xyz]$/i", "bx", 0),
    ("/^[a-d][^xyz]$/i", "bX", 1), ("/^a[b-d]{2,4}e$/i", "Acdde", 1),
    ("/^a[b-d]{2,4}e$/i", "Abcde", 0), ("/^ab|cd$/", "abx", 0),
    ("/^ab|cd$/", "ab", 1), ("/^ab{2,4}c+d*$/", "abbccdd", 1),
    ("/^ab{2,4}c+d*$/", "abbbbbc", 0), ("/a.c/", "zabcz", 1),
    ("/^(ab|cd)[a-z]{3,}e?$/i", "CDqrse", 1), ("/^(ab|cd)[a-z]{3,}e?$/i", "CDqrst", 0),
    ("/^(ab|cd)[a-z]{3,}e?$/i", "cdaqrs", 0), ("/a{,2}b/", "b", 1), ("/^a{,2}b/", "aaab", 1), ("/^a{,2}b/", "aaaab", 0), ("/^abc*$/", "ab", 0), ("/^abc*$/", "abc", 1), ("/^ab?$/", "a", 0),
    ("/abc/", "", 0)])
def test_reference_dialect(pattern, content, bit):
    assert reference.expected_bit(pattern, content) == bit


def test_check_reads_answers_duplicates_and_phase_gaps():
    want = np.array([1, 0])
    cts = np.arange(2 * 4 * 3).reshape(2, 4, 3)
    ph = np.array([[1.01, 0.0, 0.0, 0.0], [-0.03, 0.0, 0.0, 0.0]])
    assert reference.check(ph, want, cts) == {
        "wrong_answers": 0, "duplicate_replies": 0,
        "phase_gap": pytest.approx(0.03),
        "phase_var": pytest.approx((0.01 ** 2 + 0.03 ** 2) / 8)}
    ph[1, 2] = 1.0
    assert reference.check(ph, want, cts)["wrong_answers"] == 1
    ph = np.array([[0.2, 0, 0, 0], [0.4, 0, 0, 0]])
    got = reference.check(ph, want, cts)
    assert got["wrong_answers"] == 1 and got["phase_gap"] == \
        pytest.approx(0.8)
    cts[1, 0] = cts[0, 0]
    assert reference.check(ph, want, cts)["duplicate_replies"] == 1
    cts[:, 0, :-1] = 0                 # trivial ciphertexts do not count
    assert reference.check(ph, want, cts)["duplicate_replies"] == 0


def test_phase_var_is_the_mean_square_over_bootstrapped_blocks():
    want = np.array([1, 0])
    cts = np.ones((2, 4, 3), np.uint32)
    cts[:, 1:, :-1] = 0                # blocks 1-3 trivial, as replies are
    ph = np.array([[1.02, 0, 0, 0], [0.04, 0, 0, 0]])
    got = reference.check(ph, want, cts)
    assert got["phase_var"] == pytest.approx((0.02 ** 2 + 0.04 ** 2) / 2)
    cts[1, 0, :-1] = 0
    assert reference.check(ph, want, cts)["phase_var"] == \
        pytest.approx(0.02 ** 2)


@pytest.mark.parametrize("mix_name,seed,count", [("single6", 3000000018, 160),
                                                 ("many32", 3000000011, 4)])
def test_reference_agrees_with_the_port_on_a_window_of_traffic(
        mix_name, seed, count):
    """The requests of a whole window of a seed (160 /match requests, as
    many as a 51 s window at 64 bits holds; 128 contents of /match_many)
    on the port's plain path at TEST_PARAMS: every decrypted bit equals
    the reference's."""
    from fhe_regex_tpu_torch import (decrypt, gen_keys, has_match_many,
                                     trivial_encrypt_str)
    from fhe_regex_tpu_torch.params import TEST_PARAMS

    from portbench.traffic import Traffic

    mix = harness.load_json(harness.HERE / "mixes" / f"{mix_name}.json")
    traffic = Traffic(mix, seed)
    by_shape = {}
    for _ in range(count):
        req = traffic.next()
        by_shape.setdefault(req.shape, []).extend(req.contents)
    ck, sk = gen_keys(TEST_PARAMS, seed=1)
    for shape, contents in sorted(by_shape.items()):
        pattern = mix["shapes"][shape]["pattern"]
        cts = np.stack([trivial_encrypt_str(TEST_PARAMS, c)
                        for c in contents])
        got = [decrypt(ck, g) for g in
               has_match_many(sk, cts, pattern, device="cpu")]
        want = [reference.expected_bit(pattern, c) for c in contents]
        assert got == want, [(c, g, w) for c, g, w in
                             zip(contents, got, want) if g != w]
        assert 0 < sum(want) < len(want), shape
