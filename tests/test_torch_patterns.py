"""Pattern programs and the circuit-compiler choice (``engine=``) of the
PyTorch port against the JAX package.

* ``CompiledPattern`` (``models/patterns.py``) serves one pattern against
  contents of several lengths from its per-length circuit cache, with the
  JAX package's ciphertexts and circuit stats.
* ``engine=`` on every entry point takes the JAX package's place in the
  signature and gives its ciphertexts; ``--engine`` on the CLI.  The
  ``native`` cases need ``native/libfheregex.so`` (``make -C native``) and
  skip without it, as ``tests/test_native_circuit.py`` does.

Tolerance is zero.  Contents are real (noisy) encryptions from the JAX
package at ``TEST_PARAMS_NOISY``.
"""

import inspect

import numpy as np
import pytest
import torch

import fhe_regex_tpu as J
from fhe_regex_tpu.models.patterns import CompiledPattern as JaxPattern

import fhe_regex_tpu_torch as port
from fhe_regex_tpu_torch.convert import client_key_from_jax, server_key_from_jax
from fhe_regex_tpu_torch.models.patterns import (DRIVER_CONFIGS,
                                                 CompiledPattern,
                                                 CompiledPatternSet,
                                                 CompiledPositions)
from fhe_regex_tpu_torch.regex import native
from fhe_regex_tpu_torch.regex.engine import BranchBudgetExceeded

torch.set_num_threads(2)

ENGINES = ["python"] + (["native"] if native.available() else [])


@pytest.fixture(scope="module")
def both(noisy_keys):
    """(JAX keys, port keys) for TEST_PARAMS_NOISY."""
    ck, sk = noisy_keys
    return (ck, sk), (client_key_from_jax(ck), server_key_from_jax(sk))


def test_compiled_pattern_reuse_across_contents(both):
    """One program, contents of three lengths: a circuit per length,
    each answer the JAX program's ciphertext."""
    (ck, sk), (tck, tsk) = both
    prog = CompiledPattern("/ab?c/", params=tsk.params, engine="python")
    jprog = JaxPattern("/ab?c/", params=sk.params, engine="python")
    ex = port.executor_for(tsk, device="cpu")
    jx = J.executor_for(sk, "jnp")
    for content, want in [("abc", 1), ("ac", 1), ("adc", 0), ("xabcx", 1)]:
        ct = J.encrypt_str(ck, content)
        got = prog.match(ex, ct)
        assert np.array_equal(got, jprog.match(jx, ct))
        assert port.decrypt(tck, got) == want, content
    assert set(prog._circuits) == {3, 2, 5}
    assert prog.stats(3) == jprog.stats(3)
    cts = np.stack([J.encrypt_str(ck, s) for s in ("xabc", "abxx")])
    assert np.array_equal(prog.match_many(ex, cts), jprog.match_many(jx, cts))


def test_pattern_set_and_positions_programs(both):
    (ck, _), (tck, tsk) = both
    ex = port.executor_for(tsk, device="cpu")
    ct = J.encrypt_str(ck, "abcab")
    pset = CompiledPatternSet(["/ab/", "/^c/"], params=tsk.params)
    assert [port.decrypt(tck, r) for r in pset.match(ex, ct)] == [1, 0]
    assert pset.stats(5)["patterns"] == 2
    pos = CompiledPositions("/ab/", params=tsk.params)
    assert [port.decrypt(tck, r) for r in pos.match(ex, ct)] == [
        1, 0, 0, 1, 0]


def test_compiled_pattern_budget_and_driver_configs():
    params = port.get_params("TEST_PARAMS")
    with pytest.raises(BranchBudgetExceeded):
        CompiledPattern("/a*bc/", params=params, branch_budget=1).circuit(6)
    assert len(DRIVER_CONFIGS) == 5
    for cfg in DRIVER_CONFIGS:
        CompiledPattern(cfg["pattern"], params=params)


ENTRY_POINTS = ["has_match", "has_match_many", "has_match_patterns",
                "has_match_positions", "has_match_many_patterns",
                "has_match_many_positions", "has_match_long",
                "has_match_many_long"]


@pytest.mark.parametrize("name", ENTRY_POINTS + ["_compile_multi",
                                                 "_compile_positions"])
def test_engine_in_the_jax_place(name):
    """engine= comes right after fold, as in the JAX package; the private
    compilers take the JAX package's arguments in its order, and the entry
    points every JAX argument (mesh= too) in its place."""
    params = list(inspect.signature(getattr(port, name)).parameters)
    jparams = list(inspect.signature(getattr(J, name)).parameters)
    assert params.index("engine") == params.index("fold") + 1
    if name.startswith("_"):
        assert params == jparams
    else:
        assert jparams == [p for p in params if p in jparams]
        assert inspect.signature(getattr(port, name)).parameters[
            "engine"].default is None


PUBLIC = [n for n in J.__all__ if inspect.isfunction(getattr(J, n))]


@pytest.mark.parametrize("name", PUBLIC + ["serve.MatchService"])
def test_jax_parameters_are_a_prefix(name):
    """Every public function of the JAX package, and its daemon's
    MatchService, takes its parameters first in the port, with the same
    names and kinds, so a call that binds positionally in JAX binds alike
    in the port; the port's own (``device``) come after them."""
    from fhe_regex_tpu import serve as jserve
    from fhe_regex_tpu_torch import serve as tserve

    def params(module, serve):
        obj = (getattr(serve, name.split(".")[1]) if "." in name
               else getattr(module, name))
        return [(p.name, p.kind)
                for p in inspect.signature(obj).parameters.values()]

    jparams = params(J, jserve)
    assert params(port, tserve)[:len(jparams)] == jparams


def test_positional_has_match_equals_jax():
    """``has_match`` with every JAX parameter given by position (fold
    "tree", the Python compiler, multivalue False) at TEST_PARAMS gives
    the JAX package's ciphertext bit for bit."""
    from fhe_regex_tpu.params import TEST_PARAMS

    ck, sk = J.gen_keys(TEST_PARAMS, seed=1)
    ct = J.encrypt_str(ck, "abc")
    args = ("/b/", None, None, "tree", "python", None, False)
    want = J.has_match(sk, ct, *args)
    got = port.has_match(server_key_from_jax(sk), ct, *args, device="cpu")
    assert got.dtype == want.dtype and np.array_equal(got, want)
    assert J.decrypt(ck, want) == 1


@pytest.mark.parametrize("engine", ENGINES)
@pytest.mark.parametrize("name", ENTRY_POINTS)
def test_engine_entry_point_equals_jax(both, name, engine):
    """engine= on each entry point gives the JAX package's ciphertext
    (the JAX side on its Python builder)."""
    (ck, sk), (_, tsk) = both
    cts = np.stack([J.encrypt_str(ck, s) for s in ("xab", "bab")])
    arg = ["/ab/", "/^b/"] if "patterns" in name else "/ab/"
    x = cts if "many" in name else cts[0]
    got = getattr(port, name)(tsk, x, arg, engine=engine, device="cpu")
    want = getattr(J, name)(sk, x, arg, engine="python")
    assert got.dtype == want.dtype and np.array_equal(got, want)


@pytest.mark.parametrize("engine", ENGINES)
def test_cli_engine(capsys, engine):
    from fhe_regex_tpu_torch.cli import main

    args = ["--params", "TEST_PARAMS", "--trivial", "--device", "cpu",
            "--seed", "1", "--fold", "tree", "--engine", engine]
    assert main(args + ["abc", "/b/"]) == 0
    assert main(args + ["--positions", "abcab", "/ab/"]) == 0
    assert capsys.readouterr().out.splitlines() == ["res: 1",
                                                    "positions: 10010"]


@pytest.mark.skipif(not native.available(), reason="native lib not built")
@pytest.mark.parametrize("cfg", DRIVER_CONFIGS, ids=lambda c: c["name"])
def test_native_circuit_equals_python(cfg):
    """The C++ builder gives the Python builder's circuit, op for op."""
    from fhe_regex_tpu_torch.regex.engine import compile_match

    n, pattern = cfg["content_len"], cfg["pattern"]
    pb, proot = compile_match(n, pattern, fold="tree")
    nb, nroot = native.compile_match_native(n, pattern, fold="tree")
    assert (nb.ct_ops, nb.cache_hits, nb.num_content_slots) == (
        pb.ct_ops, pb.cache_hits, pb.num_content_slots)
    assert nroot.val == proot.val and nb.ops == pb.ops
