"""Multi-value bootstrapping in the PyTorch port against the JAX package.

* ``compile_circuit(multivalue=True)`` plans, ``_compile_auto_mv``'s choice
  (with its MvMarginError fallback), the packed multi-value launch plans
  and ``_resolve_multivalue`` equal the JAX package's.
* ``mv_extract`` / ``mv_extract64`` equal the JAX functions on the same
  accumulators, mod 2^32 / 2^64, and reject the same weights.
* Every entry point gives the JAX package's ciphertexts bit for bit under
  the multi-value plan: ``has_match_many`` with the default ``multivalue``
  (which picks that plan), ``has_match``, ``has_match_positions``,
  ``has_match_patterns`` and ``has_match_many_patterns`` with
  ``multivalue=True``, and ``has_match_many`` at 64 bits.

Tolerance is zero.  Keys and contents come from seeds through the JAX
package (``keys`` / ``noisy_keys`` fixtures, ``TEST_PARAMS_64`` seed 11)
and go to the port as the same numpy arrays.
"""

import numpy as np
import pytest
import torch

import fhe_regex_tpu as J
import jax.numpy as jnp
from fhe_regex_tpu.ops import mv as jmv
from fhe_regex_tpu.params import (TEST_PARAMS, TEST_PARAMS_64,
                                  TEST_PARAMS_NOISY)
from fhe_regex_tpu.regex import executor as jex

import fhe_regex_tpu_torch as port
from fhe_regex_tpu_torch.convert import client_key_from_jax, server_key_from_jax
from fhe_regex_tpu_torch.ops import mv as tmv
from fhe_regex_tpu_torch.params import get_params
from fhe_regex_tpu_torch.regex import executor as tex
from fhe_regex_tpu_torch.regex.engine import (compile_match,
                                              compile_match_multi,
                                              compile_match_positions)

torch.set_num_threads(2)

JAX_KW = dict(engine="python", backend=None)


def _enc(ck, strings):
    return np.stack([J.encrypt_str(ck, s) for s in strings])


def _port(keys):
    return client_key_from_jax(keys[0]), server_key_from_jax(keys[1])


@pytest.fixture(scope="module")
def keys64():
    from fhe_regex_tpu.crypto.keys import gen_keys
    return gen_keys(TEST_PARAMS_64, seed=11)


PLAN_CASES = [
    (TEST_PARAMS, "/abc/", 16, "tree"),
    (TEST_PARAMS, "/^[a-d][^xyz]$/i", 2, "tree"),
    (TEST_PARAMS, "/^(ab|cd)[a-z]{3,}e?$/i", 16, "reference"),
    (TEST_PARAMS_NOISY, "/a*bc/", 6, "tree"),
    (TEST_PARAMS_64, "/[a-d]d/", 4, "tree"),
]


def _plans(P, pattern, L, fold, **kw):
    tc = tex.compile_circuit(get_params(P.name),
                             *compile_match(L, pattern, fold=fold),
                             multivalue=True, **kw)
    jc = jex.compile_circuit(P, *J.compile_match(L, pattern, fold=fold),
                             multivalue=True, **kw)
    return tc, jc


@pytest.mark.parametrize("P,pattern,L,fold", PLAN_CASES,
                         ids=lambda v: getattr(v, "name", str(v)))
def test_mv_plan_equals_jax(P, pattern, L, fold):
    tc, jc = _plans(P, pattern, L, fold)
    assert tc.multivalue and jc.multivalue
    assert (tc.pbs_count, tc.rotation_count) == (jc.pbs_count,
                                                 jc.rotation_count)
    assert tc.rotation_count < tc.pbs_count
    assert len(tc.levels) == len(jc.levels)
    for a, b in zip(tc.levels, jc.levels):
        for f in ("in_slots", "in_coefs", "consts", "lut_idx", "out_idx",
                  "rot_slots", "rot_coefs", "rot_consts", "mv_weights",
                  "mv_leader"):
            assert np.array_equal(getattr(a, f), getattr(b, f)), f
        assert a.mv_positions == b.mv_positions
        assert a.mv_rot_count == b.mv_rot_count
    assert tex.worst_mv_norm2(tc) == jex.worst_mv_norm2(jc)
    assert tex.circuit_pfail(tc.params, tc, bsk_drop=None) == \
        jex.circuit_pfail(P, jc, bsk_drop=None)


def test_abc_16_takes_mv_plan_with_jax_counts():
    """The serving configuration's circuit: 96 rotations for 122
    bootstraps, so both packages' auto rule picks the multi-value plan."""
    tb, troot = compile_match(16, "/abc/", fold="tree")
    jb, jroot = J.compile_match(16, "/abc/", fold="tree")
    got = port._compile_auto_mv(get_params("TEST_PARAMS"), tb, troot, None)
    want = J._compile_auto_mv(TEST_PARAMS, jb, jroot, None)
    assert got.multivalue and want.multivalue
    assert (got.pbs_count, got.rotation_count) == (122, 96) == (
        want.pbs_count, want.rotation_count)


@pytest.mark.parametrize("pattern,L", [
    ("/^[a-d][^xyz]$/i", 2), ("/^abc$/", 3), ("/abc/", 8),
    ("/^(ab|cd)[a-z]{3,}e?$/i", 16), ("/ab|cd/", 5)])
@pytest.mark.parametrize("savings", [None, "0.3", "0.05", "bad"])
def test_compile_auto_mv_matches_jax(monkeypatch, pattern, L, savings):
    if savings is None:
        monkeypatch.delenv("FHE_REGEX_MV_MIN_SAVINGS", raising=False)
    else:
        monkeypatch.setenv("FHE_REGEX_MV_MIN_SAVINGS", savings)
    assert port.MV_AUTO_MIN_SAVINGS == J.MV_AUTO_MIN_SAVINGS
    for mv in (None, True, False):
        got = port._compile_auto_mv(get_params("TEST_PARAMS"),
                                    *compile_match(L, pattern, fold="tree"),
                                    mv)
        want = J._compile_auto_mv(TEST_PARAMS,
                                  *J.compile_match(L, pattern, fold="tree"),
                                  mv)
        assert got.multivalue == want.multivalue, (mv, savings)
        assert got.rotation_count == want.rotation_count


def test_compile_auto_mv_margin_fallback(monkeypatch):
    """A LUT factor under 5 sigma: compile_circuit(multivalue=True) raises
    MvMarginError in both packages and auto falls back to classic."""
    from fhe_regex_tpu.params import Params as JParams

    from fhe_regex_tpu_torch.params import Params as TParams

    for cls in (JParams, TParams):
        real = cls.noise_budget_report

        def tight(self, mv_norm2=None, _real=real, **kw):
            rep = _real(self, mv_norm2=mv_norm2, **kw)
            if mv_norm2 is not None and mv_norm2 > 2:
                rep = dict(rep, sigma_margin=4.0)
            return rep

        monkeypatch.setattr(cls, "noise_budget_report", tight)
    tb, troot = compile_match(2, "/^[a-d][^xyz]$/i", fold="tree")
    jb, jroot = J.compile_match(2, "/^[a-d][^xyz]$/i", fold="tree")
    with pytest.raises(tex.MvMarginError, match="multivalue=False"):
        tex.compile_circuit(get_params("TEST_PARAMS"), tb, troot,
                            multivalue=True)
    with pytest.raises(jex.MvMarginError):
        jex.compile_circuit(TEST_PARAMS, jb, jroot, multivalue=True)
    got = port._compile_auto_mv(get_params("TEST_PARAMS"), tb, troot, None)
    want = J._compile_auto_mv(TEST_PARAMS, jb, jroot, None)
    assert not got.multivalue and not want.multivalue


@pytest.mark.parametrize("multivalue,packed,env,want", [
    (None, True, None, None), (None, False, None, False),
    (True, False, None, True), (False, True, None, False),
    (None, False, "1", True), (None, True, "0", False),
    (True, True, "0", True), (None, True, "x", None)])
def test_resolve_multivalue_matches_jax(monkeypatch, multivalue, packed, env,
                                        want):
    if env is None:
        monkeypatch.delenv("FHE_REGEX_MULTIVALUE", raising=False)
    else:
        monkeypatch.setenv("FHE_REGEX_MULTIVALUE", env)
    assert port._resolve_multivalue(multivalue, packed) is want
    assert J._resolve_multivalue(multivalue, TEST_PARAMS, None,
                                 packed=packed) is want


def _mv_inputs(P, seed, R=5, W=9):
    rng = np.random.default_rng(seed)
    k1, N = P.glwe_dimension + 1, P.polynomial_size
    dt = np.uint32 if P.torus_bits == 32 else np.uint64
    accs = rng.integers(0, 1 << P.torus_bits, size=(R, k1, N),
                        dtype=np.uint64).astype(dt)
    accs.reshape(-1)[:3] = [0, dt(1) << dt(P.torus_bits - 1), np.iinfo(dt).max]
    S = len(tmv.mv_support_positions(P))
    weights = rng.integers(-31, 32, size=(W, S)).astype(np.int32)
    weights[0, :2] = [-31, 31]
    leader = rng.integers(0, R, size=W).astype(np.int32)
    return accs, weights, leader


@pytest.mark.parametrize("subset", [False, True])
def test_mv_extract_equals_jax(subset):
    P = TEST_PARAMS
    accs, weights, leader = _mv_inputs(P, 3)
    pos = tmv.mv_support_positions(P)
    cols = [0, 3, 7, 15] if subset else list(range(len(pos)))
    positions = tuple(int(pos[c]) for c in cols) if subset else None
    w = weights[:, cols]
    want = np.asarray(jmv.mv_extract(P, jnp.asarray(accs.view(np.int32)),
                                     jnp.asarray(w), jnp.asarray(leader),
                                     positions))
    got = tmv.mv_extract(get_params(P.name),
                         torch.from_numpy(accs.view(np.int32)),
                         torch.from_numpy(w), torch.from_numpy(leader),
                         positions)
    assert got.dtype == torch.int32
    assert np.array_equal(got.numpy(), want)


@pytest.mark.parametrize("subset", [False, True])
def test_mv_extract64_equals_jax(subset):
    from fhe_regex_tpu_torch.ops.pbs64 import limbs_to_np, np_to_limbs

    P = TEST_PARAMS_64
    accs, weights, leader = _mv_inputs(P, 4)
    pos = tmv.mv_support_positions(P)
    cols = [1, 2, 14] if subset else list(range(len(pos)))
    positions = tuple(int(pos[c]) for c in cols) if subset else None
    w = weights[:, cols]
    want = np.asarray(jmv.mv_extract64(P, jnp.asarray(np_to_limbs(accs)), w,
                                       jnp.asarray(leader), positions))
    got = tmv.mv_extract64(get_params(P.name),
                           torch.from_numpy(accs.view(np.int64)), w,
                           torch.from_numpy(leader), positions)
    assert np.array_equal(got.numpy().view(np.uint64), limbs_to_np(want))


def test_mv_extract64_rejects_what_jax_rejects():
    P = TEST_PARAMS_64
    accs, weights, leader = _mv_inputs(P, 5)
    weights[2, 3] = 32
    with pytest.raises(AssertionError, match="< 32"):
        jmv.mv_extract64(P, jnp.zeros(accs.shape + (2,), jnp.int32), weights,
                         jnp.asarray(leader))
    with pytest.raises(AssertionError, match="< 32"):
        tmv.mv_extract64(get_params(P.name),
                         torch.from_numpy(accs.view(np.int64)), weights,
                         torch.from_numpy(leader))


def test_mv_lut_table_and_backends():
    for P in (TEST_PARAMS, TEST_PARAMS_64):
        t = tmv.mv_lut_table(get_params(P.name))
        want = jmv.mv_lut_table(P)
        if P.torus_bits == 32:
            assert t.dtype == torch.int32
            assert np.array_equal(t.numpy().view(np.uint32), want)
        else:
            from fhe_regex_tpu_torch.ops.pbs64 import join64_np
            assert t.dtype == torch.int64 and t.shape == (1, P.polynomial_size)
            assert np.array_equal(t.numpy().view(np.uint64),
                                  join64_np(want[..., 0], want[..., 1]))
    assert set(tmv.MV_BACKENDS) >= set(jmv.MV_BACKENDS)
    from fhe_regex_tpu_torch.ops.pbs import BACKENDS
    # every backend but fft, which has no multi-value rotation in either
    # package
    assert "fft" not in jmv.MV_BACKENDS
    assert sorted(tmv.MV_BACKENDS.values()) == sorted(
        b for b in BACKENDS if b != "fft")


def test_mv_pbs_batch_and_core_equal_jax(keys):
    """Grouped multi-value PBS, two inputs and four derived outputs: the
    port's plain ``mv_pbs_batch`` and ``make_mv_core`` on a ``torch`` key
    equal the JAX package's ``mv_pbs_batch``."""
    from fhe_regex_tpu.crypto import lwe as jlwe
    from fhe_regex_tpu.ops.luts import LUT_AND2, LUT_EQ, LUT_GT, LUT_OR2, mv_weights
    from fhe_regex_tpu.ops.pbs import server_key_device_arrays

    from fhe_regex_tpu_torch.ops.pbs import prepare_server_key

    ck, sk = keys
    P = TEST_PARAMS
    rot = np.stack([jlwe.encrypt_lwe(P, ck.lwe_key, m, ck.rng) for m in (5, 3)])
    weights = np.stack([mv_weights(P, k) for k in
                        (LUT_EQ(5), LUT_GT(5), LUT_AND2, LUT_OR2)])
    leader = np.asarray([0, 0, 1, 1], np.int32)
    bsk, ksk = server_key_device_arrays(sk)
    want = np.asarray(jmv.mv_pbs_batch(P, bsk, ksk, jnp.asarray(weights),
                                       jnp.asarray(leader),
                                       jnp.asarray(rot.view(np.int32))))
    tsk = server_key_from_jax(sk)
    dev = prepare_server_key(tsk.params, tsk, "cpu", "torch")
    args = (torch.from_numpy(weights), torch.from_numpy(leader),
            torch.from_numpy(rot.view(np.int32)))
    got = tmv.mv_pbs_batch(tsk.params, dev.bsk, dev.ksk, *args)
    assert np.array_equal(got.numpy(), want)
    core = tmv.make_mv_core(dev)(tmv.mv_lut_table(tsk.params), *args)
    assert np.array_equal(core.numpy(), want)
    assert [jlwe.decrypt_lwe(P, ck.lwe_key, want[i].view(np.uint32))
            for i in range(4)] == [1, 0, 1, 1]    # eq5(5) gt5(5) and2 or2


@pytest.mark.parametrize("C,wide", [(1, False), (5, True), (40, False),
                                    (40, True)])
def test_packed_mv_plan_matches_jax(keys, C, wide):
    """Executor._device_chunks_many_mv equals the JAX package's plan, step
    for step (rotation chunks and the packed finish arrays)."""
    tc, jc = _plans(TEST_PARAMS, "/a[bc]d/", 12, "tree")
    ex = port.executor_for(server_key_from_jax(keys[1]), device="cpu")
    got = ex._device_chunks_many_mv(tc, C, wide)
    jex_self = type("E", (), {"_mv_acc_rows_cap": jex.Executor.MAX_MV_ACC_ROWS,
                              "_mv_pad_rows": staticmethod(
                                  jex.Executor._mv_pad_rows)})()
    want = jex.Executor._device_chunks_many_mv(jex_self, jc, C, wide)
    assert ex._device_chunks_many_mv(tc, C, wide) is got          # cached
    assert len(got) == len(want)
    for (g_rot, g_fin), (w_rot, _, w_fin) in zip(got, want):
        assert len(g_rot) == len(w_rot)
        for a, b in zip(g_rot, w_rot):
            for x, y in zip(a, b):
                assert np.array_equal(x.numpy(), np.asarray(y))
        for x, y in zip(g_fin[:3], w_fin[:3]):
            assert np.array_equal(x.numpy(), np.asarray(y))
        assert g_fin[3] == w_fin[3]


def test_has_match_many_default_takes_mv_and_equals_jax(keys, monkeypatch):
    """The serving path with the default multivalue: /abc/ over 16
    characters at TEST_PARAMS picks the multi-value plan and gives the JAX
    package's ciphertexts bit for bit."""
    monkeypatch.delenv("FHE_REGEX_MULTIVALUE", raising=False)
    monkeypatch.delenv("FHE_REGEX_MV_MIN_SAVINGS", raising=False)
    ck, sk = keys
    tck, tsk = _port(keys)
    strings = ["xxxxxabcxxxxxxxx", "xxxxxaqcxxxxxxxx", "abcxxxxxxxxxxabc"]
    cts = _enc(ck, strings)
    seen = []
    real = port._compile_auto_mv

    def spy(*args, **kw):
        seen.append(real(*args, **kw))
        return seen[-1]

    monkeypatch.setattr(port, "_compile_auto_mv", spy)
    got = port.has_match_many(tsk, cts, "/abc/", device="cpu")
    assert seen[-1].multivalue and seen[-1].rotation_count == 96
    want = J.has_match_many(sk, cts, "/abc/", **JAX_KW)
    assert got.dtype == want.dtype and np.array_equal(got, want)
    assert [port.decrypt(tck, r) for r in got] == [1, 0, 1]
    classic = port.has_match_many(tsk, cts, "/abc/", device="cpu",
                                  multivalue=False)
    assert not np.array_equal(classic, got)
    assert [port.decrypt(tck, r) for r in classic] == [1, 0, 1]


@pytest.mark.parametrize("content,pattern,want", [
    ("bx", "/^[a-d][^xyz]$/", 0), ("cdaabc", "/a*bc/", 1)])
def test_has_match_multivalue_equals_jax(noisy_keys, content, pattern, want):
    ck, sk = noisy_keys
    tck, tsk = _port(noisy_keys)
    ct = J.encrypt_str(ck, content)
    exp = J.has_match(sk, ct, pattern, multivalue=True, **JAX_KW)
    got = port.has_match(tsk, ct, pattern, multivalue=True, device="cpu")
    assert np.array_equal(got, exp)
    assert port.decrypt(tck, got) == want


def test_positions_and_patterns_multivalue_equal_jax(keys):
    ck, sk = keys
    tck, tsk = _port(keys)
    ct = J.encrypt_str(ck, "abcabc")
    got = port.has_match_positions(tsk, ct, "/abc/", multivalue=True,
                                   device="cpu")
    assert np.array_equal(got, J.has_match_positions(
        sk, ct, "/abc/", multivalue=True, **JAX_KW))
    assert [port.decrypt(tck, r) for r in got] == [1, 0, 0, 1, 0, 0]
    pats = ["/abc/", "/abd/", "/[a-c]c/"]
    got = port.has_match_patterns(tsk, ct, pats, multivalue=True,
                                  device="cpu")
    assert np.array_equal(got, J.has_match_patterns(
        sk, ct, pats, multivalue=True, **JAX_KW))
    assert [port.decrypt(tck, r) for r in got] == [1, 0, 1]
    cts = _enc(ck, ["abx", "cdx", "xxx"])
    pats = ["/ab/", "/cd/", "/[a-d]d/"]
    got = port.has_match_many_patterns(tsk, cts, pats, multivalue=True,
                                       device="cpu")
    assert np.array_equal(got, J.has_match_many_patterns(
        sk, cts, pats, multivalue=True, **JAX_KW))
    assert [[port.decrypt(tck, r) for r in row] for row in got] == [
        [1, 0, 0], [0, 1, 1], [0, 0, 0]]


def test_has_match_many_64bit_multivalue_equals_jax(keys64):
    ck, sk = keys64
    tck, tsk = _port(keys64)
    cts = _enc(ck, ["bq", "xq", "dd"])
    got = port.has_match_many(tsk, cts, "/^[a-d][^xyz]$/i", multivalue=True,
                              device="cpu")
    want = J.has_match_many(sk, cts, "/^[a-d][^xyz]$/i", multivalue=True,
                            **JAX_KW)
    assert got.dtype == np.uint64 and np.array_equal(got, want)
    assert [port.decrypt(tck, r) for r in got] == [1, 0, 1]


def test_run_profile_reports_rotations_and_pfail(noisy_keys):
    """run(profile=True) on a multi-value circuit: a rotation batch per
    level and the failure contract at the key's operating point."""
    tsk = server_key_from_jax(noisy_keys[1])
    P = get_params("TEST_PARAMS_NOISY")
    circuit = tex.compile_circuit(P, *compile_match(2, "/^[a-d][^xyz]$/i",
                                                    fold="tree"),
                                  multivalue=True)
    ex = port.executor_for(tsk, device="cpu")
    ex.run(circuit, J.encrypt_str(noisy_keys[0], "bd"), profile=True)
    assert [s["rotations"] for s in ex.last_run_stats] == [
        int(lv.rot_slots.shape[0]) for lv in circuit.levels]
    assert ex.last_run_pfail == tex.circuit_pfail(P, circuit, bsk_drop=None)
    assert ex.last_run_pfail["mv_norm2"] == tex.worst_mv_norm2(circuit)


def test_cli_multivalue(capsys):
    from fhe_regex_tpu_torch.cli import main

    args = ["--params", "TEST_PARAMS", "--trivial", "--device", "cpu",
            "--seed", "1", "--multivalue"]
    assert main(args + ["abc", "/b/"]) == 0
    assert main(args + ["--positions", "abcab", "/ab/"]) == 0
    assert capsys.readouterr().out.splitlines() == ["res: 1",
                                                    "positions: 10010"]
    assert main(args + ["--count", "abcab", "/ab/"]) == 2
    assert "not supported with --count" in capsys.readouterr().err


def test_multi_and_positions_builders_plan_equal_jax():
    """Multi-root circuits (patterns, positions) compile the same
    multi-value plans in both packages."""
    P = TEST_PARAMS
    for tb, jb in ((compile_match_multi(5, ["/ab/", "/b[cd]/"], fold="tree"),
                    J.regex.engine.compile_match_multi(
                        5, ["/ab/", "/b[cd]/"], fold="tree")),
                   (compile_match_positions(5, "/a[bc]/", fold="tree"),
                    J.regex.engine.compile_match_positions(
                        5, "/a[bc]/", fold="tree"))):
        tc = tex.compile_circuit(get_params(P.name), *tb, multivalue=True)
        jc = jex.compile_circuit(P, *jb, multivalue=True)
        assert tc.rotation_count == jc.rotation_count
        for a, b in zip(tc.levels, jc.levels):
            assert np.array_equal(a.mv_weights, b.mv_weights)
            assert np.array_equal(a.mv_leader, b.mv_leader)
