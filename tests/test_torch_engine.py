"""End-to-end has_match through the PyTorch port, against the JAX package.

* Every reference and quirk vector (tests/test_engine.py) decrypts to the
  expected bit through the port in both fold modes, with the same circuit
  counters as the JAX package's compiler.
* On a subset with real (noisy) encryption, the port's result ciphertext
  equals JAX ``has_match``'s bit for bit: the same numpy content goes
  through both packages under the same keys.
* The port's ``compile_circuit`` produces the JAX package's level plans.
"""

import numpy as np
import pytest
import torch

from fhe_regex_tpu import has_match as jax_has_match
from fhe_regex_tpu.regex.engine import compile_match as jax_compile_match
from fhe_regex_tpu.regex.executor import compile_circuit as jax_compile_circuit
from fhe_regex_tpu.params import TEST_PARAMS as JAX_TEST_PARAMS
from fhe_regex_tpu.params import TEST_PARAMS_NOISY as JAX_NOISY

import fhe_regex_tpu_torch as port
from fhe_regex_tpu_torch.convert import client_key_from_jax, server_key_from_jax
from fhe_regex_tpu_torch.regex.engine import compile_match
from fhe_regex_tpu_torch.regex.executor import compile_circuit

from tests.test_engine import QUIRK_VECTORS, REFERENCE_VECTORS

torch.set_num_threads(2)

VECTORS = REFERENCE_VECTORS + QUIRK_VECTORS


@pytest.fixture(scope="module")
def port_keys(keys):
    return client_key_from_jax(keys[0]), server_key_from_jax(keys[1])


@pytest.fixture(scope="module")
def port_noisy_keys(noisy_keys):
    return (client_key_from_jax(noisy_keys[0]),
            server_key_from_jax(noisy_keys[1]))


@pytest.mark.parametrize("fold", ["reference", "tree"])
@pytest.mark.parametrize("content,pattern,exp", VECTORS,
                         ids=[f"{c}~{p}" for c, p, _ in VECTORS])
def test_vectors_decrypt_through_port(port_keys, content, pattern, exp, fold):
    ck, sk = port_keys
    params = sk.params
    ct = port.trivial_encrypt_str(params, content)
    res = port.has_match(sk, ct, pattern, fold=fold, device="cpu")
    assert res.dtype == np.uint32
    assert res.shape == (params.num_blocks, params.lwe_dimension + 1)
    assert port.decrypt(ck, res) == exp
    b, _ = compile_match(len(content), pattern, num_blocks=params.num_blocks,
                         fold=fold)
    jb, _ = jax_compile_match(len(content), pattern,
                              num_blocks=params.num_blocks, fold=fold)
    assert (b.ct_ops, b.cache_hits) == (jb.ct_ops, jb.cache_hits)


BITEXACT = [
    ("xaby", "/ab/", "reference"),
    ("123abc456", "/abc/", "tree"),
    ("cdaabc", "/a*bc/", "reference"),
    ("Ab", "/ab/i", "tree"),
    ("abcd", "/^ab|cd$/", "reference"),
    ("abbbbc", "/ab{2,4}c/", "tree"),
    ("x", "/[^abc]/", "reference"),
    ("Acdde", "/^a[b-d]{2,4}e$/i", "tree"),
]


@pytest.mark.parametrize("content,pattern,fold", BITEXACT,
                         ids=[f"{f}:{c}~{p}" for c, p, f in BITEXACT])
def test_result_ciphertext_equals_jax(noisy_keys, port_noisy_keys, content,
                                      pattern, fold):
    from fhe_regex_tpu import encrypt_str as jax_encrypt_str

    ck, sk = noisy_keys
    ct = jax_encrypt_str(ck, content)          # one encryption, both packages
    want = jax_has_match(sk, ct, pattern, fold=fold, engine="python",
                         backend="jnp")
    got = port.has_match(port_noisy_keys[1], ct, pattern, fold=fold,
                         device="cpu")
    assert got.dtype == want.dtype
    assert np.array_equal(got, want)


@pytest.mark.parametrize("n,pattern,fold", [
    (3, "/^abc$/", "reference"),
    (16, "/abc/", "tree"),
    (2, "/^[a-d][^xyz]$/i", "tree"),
    (32, "/^ab{2,4}c+d*$/", "tree"),
    (12, "/^(ab|cd)[a-z]{3,}e?$/i", "reference"),
])
def test_level_plans_equal_jax(n, pattern, fold):
    params = port.get_params("TEST_PARAMS")
    circ = compile_circuit(params, *compile_match(n, pattern, fold=fold),
                           min_bucket=port.default_min_bucket())
    jc = jax_compile_circuit(JAX_TEST_PARAMS,
                             *jax_compile_match(n, pattern, fold=fold),
                             min_bucket=8)
    assert (circ.num_slots, circ.ct_ops, circ.cache_hits, circ.pbs_count) == (
        jc.num_slots, jc.ct_ops, jc.cache_hits, jc.pbs_count)
    assert np.array_equal(circ.luts, jc.luts)
    assert len(circ.levels) == len(jc.levels)
    for a, b in zip(circ.levels, jc.levels):
        for f in ("in_slots", "in_coefs", "consts", "lut_idx", "out_idx"):
            assert np.array_equal(getattr(a, f), getattr(b, f)), f


def test_real_encryption_roundtrip(port_noisy_keys):
    ck, sk = port_noisy_keys
    ct = port.encrypt_str(ck, "xaby")
    assert port.decrypt(ck, port.has_match(sk, ct, "/ab/", device="cpu")) == 1
    assert port.decrypt(ck, port.has_match(sk, ct, "/ba/", device="cpu")) == 0


def test_executor_profile_stats(port_keys):
    ck, sk = port_keys
    params = sk.params
    circuit = compile_circuit(params, *compile_match(3, "/ab?c/", fold="tree"))
    ex = port.executor_for(sk, device="cpu")
    assert port.executor_for(sk, device="cpu") is ex
    res = ex.run(circuit, port.trivial_encrypt_str(params, "abc"),
                 profile=True)
    assert port.decrypt(ck, res) == 1
    stats = ex.last_run_stats
    assert len(stats) == len(circuit.levels)
    assert all(s["seconds"] > 0 and s["active"] >= 1 for s in stats)
    assert sum(s["active"] for s in stats) == circuit.pbs_count


def test_trivial_result_for_anychar(port_keys):
    """Q10: /./ short-circuits to a trivial (noiseless) ciphertext."""
    ck, sk = port_keys
    ct = port.trivial_encrypt_str(sk.params, "x")
    res = port.has_match(sk, ct, "/./", device="cpu")
    assert res[0, :-1].max() == 0
    assert port.decrypt(ck, res) == 1


def test_multi_root_circuit(port_keys):
    """A list of roots returns one result row per root."""
    ck, sk = port_keys
    from fhe_regex_tpu_torch.regex.engine import compile_match_multi

    circuit = compile_circuit(sk.params, *compile_match_multi(
        2, ["/ab/", "/ba/", "/b/"], num_blocks=sk.params.num_blocks))
    res = port.executor_for(sk, device="cpu").run(
        circuit, port.trivial_encrypt_str(sk.params, "ab"))
    assert [port.decrypt(ck, r) for r in res] == [1, 0, 1]


def test_key_conversion_checks_params(keys):
    import dataclasses

    ck, sk = keys
    bad = dataclasses.replace(sk, params=dataclasses.replace(
        JAX_NOISY, name="TEST_PARAMS"))
    with pytest.raises(ValueError, match="differs in lwe_noise_std"):
        server_key_from_jax(bad)
    short = dataclasses.replace(sk, bsk=sk.bsk[:-1])
    with pytest.raises(ValueError, match="bsk shape"):
        server_key_from_jax(short)
    pck = client_key_from_jax(ck)
    assert np.array_equal(pck.lwe_key, ck.lwe_key)
    assert pck.params == port.get_params("TEST_PARAMS")
