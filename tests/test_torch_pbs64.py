"""The 64-bit torus path of the PyTorch port against the JAX package.

Stage by stage (fhe_regex_tpu_torch.ops.pbs64 against fhe_regex_tpu.ops.pbs64),
the plain blind rotation against both 64-bit Pallas kernels run in interpret
mode (``pallas64`` on the whole key, ``pallas64-bg`` on a key rounded by its
limb drop), the key-limb drop itself, the executor's 64-bit affine combine
and level plans, and ``has_match`` result ciphertexts, bit for bit.

Inputs come from numpy seeds and the JAX package's ``gen_keys`` and reach both
packages as the same arrays: uint64 in the port (int64 tensors with the same
bits), int32 limb pairs in the JAX package.  Tolerance is zero throughout:
everything is integer arithmetic mod 2^64, and the port's float64
contractions are exact by the bounds in ``ops/pbs64.py``.  The sets are
``TEST_PARAMS_64`` (zero noise) and a noisy variant of it; N = 2048 stays out.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fhe_regex_tpu import encrypt_str as jax_encrypt_str
from fhe_regex_tpu import has_match as jax_has_match
from fhe_regex_tpu.crypto import lwe as jlwe
from fhe_regex_tpu.crypto.golden import make_lut_poly, pbs as golden_pbs
from fhe_regex_tpu.crypto.keys import gen_keys as jax_gen_keys
from fhe_regex_tpu.ops import pbs as jpbs
from fhe_regex_tpu.ops import pbs64 as j64
from fhe_regex_tpu.ops import pbs_pallas
from fhe_regex_tpu.params import (REF_MESSAGE_2_CARRY_2_64, TEST_PARAMS,
                                  TEST_PARAMS_64, TPU64_MESSAGE_2_CARRY_2)
from fhe_regex_tpu.regex.engine import compile_match as jax_compile_match
from fhe_regex_tpu.regex.executor import Executor as JaxExecutor
from fhe_regex_tpu.regex.executor import _np_to_limbs
from fhe_regex_tpu.regex.executor import compile_circuit as jax_compile_circuit

import fhe_regex_tpu_torch as port
from fhe_regex_tpu_torch.convert import server_key_from_jax
from fhe_regex_tpu_torch.crypto.keys import ServerKey
from fhe_regex_tpu_torch.ops import pbs as tpbs
from fhe_regex_tpu_torch.ops import pbs64 as t64
from fhe_regex_tpu_torch.ops.pbs_cuda import (blind_rotate_fused64,
                                              blind_rotate_fused64_bg)
from fhe_regex_tpu_torch.params import Params as TParams
from fhe_regex_tpu_torch.regex.engine import compile_match
from fhe_regex_tpu_torch.regex.executor import Executor, compile_circuit

from tests.test_engine import REFERENCE_VECTORS

torch.set_num_threads(2)

NOISY64 = dataclasses.replace(TEST_PARAMS_64, name="T64N",
                              lwe_noise_std=float(1 << 20),
                              glwe_noise_std=float(1 << 18))
SETS = {"TEST_PARAMS_64": TEST_PARAMS_64, "T64N": NOISY64}

EDGES = np.array([0, 1, (1 << 32) - 1, 1 << 32, (1 << 63) - 1, 1 << 63,
                  (1 << 63) + 1, (1 << 64) - 2, (1 << 64) - 1], np.uint64)
FS = [lambda x: (3 * x + 1) % 16, lambda x: (x * x) % 16]


def _tp(p) -> TParams:
    """The port's Params with the fields of a JAX-package set."""
    return TParams(**{f.name: getattr(p, f.name)
                      for f in dataclasses.fields(TParams)})


def _jl(a: np.ndarray):
    """uint64 -> the JAX package's int32 limb pairs, as (lo, hi)."""
    lo, hi = t64.split64_np(a)
    return jnp.asarray(lo), jnp.asarray(hi)


def _u64(t: torch.Tensor) -> np.ndarray:
    return t.numpy().view(np.uint64)


def _j64(lo, hi) -> np.ndarray:
    return t64.join64_np(np.asarray(lo), np.asarray(hi))


def _random_u64(rng, shape) -> np.ndarray:
    return rng.integers(0, 1 << 64, size=shape, dtype=np.uint64)


def _boundary_values(shift: int) -> np.ndarray:
    """Values on either side of the rounding boundaries k*2^shift + 2^(shift-1)."""
    vals = []
    for k in (0, 1, 2, 3, 1000, (1 << (64 - shift)) - 1):
        mid = (k << shift) + (1 << (shift - 1))
        vals += [(mid + e) % (1 << 64) for e in (-1, 0, 1)]
    return np.array(vals, np.uint64)


@pytest.fixture(scope="module")
def keys64():
    return {name: jax_gen_keys(p, seed=11 + i)
            for i, (name, p) in enumerate(SETS.items())}


def _port_sk(name, keys64) -> ServerKey:
    _, sk = keys64[name]
    return ServerKey(params=_tp(SETS[name]), bsk=sk.bsk, ksk=sk.ksk)


def _rotation_inputs(name, keys64, B, seed):
    """Real encryptions, two LUTs, a LUT selection, and the mod switch."""
    P = SETS[name]
    ck, _ = keys64[name]
    rng = np.random.default_rng(seed)
    msgs = rng.integers(0, 16, size=B)
    cts = np.stack([jlwe.encrypt_lwe(P, ck.lwe_key, int(m), ck.rng)
                    for m in msgs])
    luts = np.stack([make_lut_poly(P, f) for f in FS])
    lut_idx = (np.arange(B) % 2).astype(np.int32)
    ms = np.asarray(j64.mod_switch64(P, *_jl(cts)))
    return msgs, cts, luts, lut_idx, ms


# ---------------- host helpers and single stages ----------------


def test_host_limb_helpers_match_jax():
    rng = np.random.default_rng(0)
    x = np.concatenate([EDGES, _random_u64(rng, 200)]).reshape(-1, 11)
    for a, b in zip(t64.split64_np(x), j64.split64_np(x)):
        assert np.array_equal(a, b)
    assert np.array_equal(t64.join64_np(*t64.split64_np(x)), x)
    limbs = t64.np_to_limbs(x)
    assert np.array_equal(limbs, _np_to_limbs(x, 64))
    assert np.array_equal(t64.limbs_to_np(limbs), x)
    assert np.array_equal(_u64(t64.to_torch64(x)), x)


@pytest.mark.parametrize("name", ["TEST_PARAMS_64", "TPU64_MESSAGE_2_CARRY_2"])
def test_mod_switch64_matches_jax(name):
    from fhe_regex_tpu.params import get_params

    P = get_params(name)
    N = P.polynomial_size
    shift = P.torus_bits - (N.bit_length() - 1) - 1
    rng = np.random.default_rng(1)
    v = np.concatenate([EDGES, _boundary_values(shift),
                        _random_u64(rng, 500)])
    cts = np.resize(v, (len(v) // 10 + 1) * 10).reshape(-1, 10)
    got = t64.mod_switch64(port.get_params(name), t64.to_torch64(cts))
    assert got.dtype == torch.int32
    assert np.array_equal(got.numpy(),
                          np.asarray(j64.mod_switch64(P, *_jl(cts))))


@pytest.mark.parametrize("base_log,level", [(23, 1), (3, 5), (7, 3), (10, 3)])
def test_decompose64_matches_jax(base_log, level):
    rng = np.random.default_rng(base_log * 10 + level)
    v = np.concatenate([EDGES, _boundary_values(64 - base_log * level),
                        _random_u64(rng, 2000)])
    got = t64.decompose64(t64.to_torch64(v), base_log, level)
    assert got.shape == (level, v.size) and got.dtype == torch.int32
    want = np.asarray(j64.decompose64(*_jl(v), base_log, level))
    assert np.array_equal(got.numpy(), want)
    assert int(got.abs().max()) <= (1 << base_log) // 2


def test_negacyclic_rotate64_matches_jax():
    rng = np.random.default_rng(2)
    N = 256
    polys = _random_u64(rng, (9, 2, N))
    polys[0, 0, :len(EDGES)] = EDGES
    r = np.array([0, 1, N - 1, N, N + 1, 2 * N - 1, 77, 300, 511], np.int32)
    got = t64.negacyclic_rotate_batch64(t64.to_torch64(polys),
                                        torch.from_numpy(r))
    want = j64.negacyclic_rotate_batch64(*_jl(polys), jnp.asarray(r))
    assert np.array_equal(_u64(got), _j64(*want))


def test_sample_extract64_matches_jax():
    rng = np.random.default_rng(3)
    accs = _random_u64(rng, (6, 2, TEST_PARAMS_64.polynomial_size))
    accs[0, 0, 1:] = 1 << 63            # -(-2^63) wraps to itself
    accs[1, 0, 1:len(EDGES) + 1] = EDGES
    got = t64.sample_extract64(_tp(TEST_PARAMS_64), t64.to_torch64(accs))
    want = j64.sample_extract64(TEST_PARAMS_64, *_jl(accs))
    assert np.array_equal(_u64(got), _j64(*want))


@pytest.mark.parametrize("name", list(SETS))
def test_key_switch64_matches_jax(keys64, name):
    P = SETS[name]
    _, sk = keys64[name]
    rng = np.random.default_rng(4)
    big = _random_u64(rng, (12, P.glwe_key_dim + 1))
    big[0, :len(EDGES)] = EDGES
    ksk = t64.prepare_ksk64(t64.to_torch64(sk.ksk))
    got = t64.key_switch64(_tp(P), ksk, t64.to_torch64(big))
    want = j64.key_switch64(P, jnp.asarray(j64.prepare_ksk64(P, sk.ksk)),
                            *_jl(big))
    assert np.array_equal(_u64(got), _j64(*want))


# ---------------- blind rotation: plain version against the JAX kernels ----


@pytest.mark.parametrize("name,B", [("TEST_PARAMS_64", 5), ("T64N", 8)])
def test_blind_rotate64_matches_jax(keys64, name, B):
    P = SETS[name]
    _, sk = keys64[name]
    _, _, luts, lut_idx, ms = _rotation_inputs(name, keys64, B, seed=B)
    want = j64.blind_rotate64(P, jnp.asarray(j64.prepare_bsk64(P, sk.bsk)),
                              *_jl(luts), jnp.asarray(lut_idx),
                              jnp.asarray(ms))
    got = t64.blind_rotate64(_tp(P), t64.to_torch64(sk.bsk),
                             t64.to_torch64(luts), torch.from_numpy(lut_idx),
                             torch.from_numpy(ms))
    assert got.shape == (B, 2, P.polynomial_size) and got.dtype == torch.int64
    assert np.array_equal(_u64(got), _j64(*want))


@pytest.mark.parametrize("stack_rows", [False, True])
def test_blind_rotate64_matches_pallas64_interpret(keys64, stack_rows):
    """The plain rotation equals Pallas kernel #5 (``pallas64``), the
    kernel ``blind_rotate_fused64`` replaces, in both of its layouts."""
    P = NOISY64
    _, sk = keys64["T64N"]
    _, _, luts, lut_idx, ms = _rotation_inputs("T64N", keys64, 8, seed=31)
    prep = (pbs_pallas.prepare_bsk_fused64_raw if stack_rows
            else pbs_pallas.prepare_bsk_fused64)
    want = pbs_pallas.blind_rotate_fused64(
        P, jnp.asarray(prep(P, sk.bsk)), *_jl(luts), jnp.asarray(lut_idx),
        jnp.asarray(ms), stack_rows)
    got = t64.blind_rotate64(_tp(P), t64.to_torch64(sk.bsk),
                             t64.to_torch64(luts), torch.from_numpy(lut_idx),
                             torch.from_numpy(ms))
    assert np.array_equal(_u64(got), _j64(*want))


def test_rounded_key_rotation_matches_pallas64_bg_interpret(keys64):
    """Pallas kernel #6 (``pallas64-bg``) with a key-limb drop computes the
    plain rotation on the rounded key, bit for bit, and so does the
    ``blind_rotate_fused64_bg`` wrapper on CPU tensors."""
    P, drop = NOISY64, (1, 1)
    _, sk = keys64["T64N"]
    _, _, luts, lut_idx, ms = _rotation_inputs("T64N", keys64, 8, seed=41)
    raw = pbs_pallas.prepare_bsk_fused64_raw(P, sk.bsk, drop)
    want = pbs_pallas.blind_rotate_fused64_bg(
        P, jnp.asarray(raw), *_jl(luts), jnp.asarray(lut_idx),
        jnp.asarray(ms), drop)
    tp = _tp(P)
    args = (t64.to_torch64(t64.round_bsk64(tp, sk.bsk, drop)),
            t64.to_torch64(luts), torch.from_numpy(lut_idx),
            torch.from_numpy(ms))
    got = t64.blind_rotate64(tp, *args)
    assert np.array_equal(_u64(got), _j64(*want))
    assert torch.equal(blind_rotate_fused64_bg(tp, *args), got)
    whole = t64.blind_rotate64(tp, t64.to_torch64(sk.bsk), *args[1:])
    assert not torch.equal(whole, got)          # the drop changes the bits


# ---------------- the key-limb drop ----------------


@pytest.mark.parametrize("drop", [(0, 0), (1, 1), (1, 2), (2, 2), (3, 0)])
def test_round_bsk64_matches_prepare_bsk_fused64_raw(keys64, drop):
    """round_bsk64 is the rounding ``prepare_bsk_fused64_raw`` applies: read
    the rounded key back out of the raw (lo, hi) window layout."""
    P = TEST_PARAMS_64
    _, sk = keys64["TEST_PARAMS_64"]
    n, N = P.lwe_dimension, P.polynomial_size
    k1 = P.glwe_dimension + 1
    rows = k1 * P.pbs_level
    raw = pbs_pallas.prepare_bsk_fused64_raw(P, sk.bsk, drop)
    pairs = raw.reshape(n, k1, -1, raw.shape[-1])[:, :, :rows * 2, :N]
    pairs = pairs.reshape(n, k1, rows, 2, N)
    want = t64.join64_np(pairs[:, :, :, 0], pairs[:, :, :, 1])
    got = t64.round_bsk64(_tp(P), sk.bsk, drop)
    assert got.dtype == np.uint64
    assert np.array_equal(got, want.transpose(0, 2, 1, 3))
    for c, m in enumerate((drop[0], drop[1])):
        assert not np.any(got[:, :, c, :] % np.uint64(1 << (8 * m)))


ALL64 = [TEST_PARAMS_64, NOISY64, TPU64_MESSAGE_2_CARRY_2,
         REF_MESSAGE_2_CARRY_2_64]


@pytest.mark.parametrize("P", ALL64, ids=[p.name for p in ALL64])
def test_default_drop64_matches_jax(monkeypatch, P):
    monkeypatch.delenv("FHE_REGEX_DROP64", raising=False)
    assert t64.default_drop64(_tp(P)) == jpbs.default_drop64(P)
    monkeypatch.setenv("FHE_REGEX_DROP64", "2,1")
    assert t64.default_drop64(_tp(P)) == jpbs.default_drop64(P) == (2, 1)


def _gate_outcome(gate, params, drop):
    try:
        gate(params, drop)
    except ValueError as e:
        return str(e)
    return None


@pytest.mark.parametrize("drop", [(0, 0), (1, 1), (1, 2), (2, 2), (3, 3)])
@pytest.mark.parametrize("P", ALL64, ids=[p.name for p in ALL64])
def test_gate_drop64_matches_jax(P, drop):
    assert (_gate_outcome(t64._gate_drop64, _tp(P), drop)
            == _gate_outcome(jpbs._gate_drop64, P, drop))


# ---------------- full PBS ----------------


@pytest.mark.parametrize("name", list(SETS))
def test_pbs_batch64_matches_jax_and_golden(keys64, name):
    P = SETS[name]
    ck, sk = keys64[name]
    msgs, cts, luts, lut_idx, _ = _rotation_inputs(name, keys64, 8, seed=21)
    jdev = jpbs.prepare_server_key(P, sk, "jnp64")
    want = t64.limbs_to_np(np.asarray(jpbs.make_pbs_fn(jdev)(
        jnp.asarray(t64.np_to_limbs(luts)), jnp.asarray(lut_idx),
        jnp.asarray(t64.np_to_limbs(cts)))))
    dev = tpbs.prepare_server_key(_tp(P), _port_sk(name, keys64), "cpu")
    assert dev.backend == "torch64" and dev.bsk.dtype == torch.int64
    got = _u64(tpbs.make_pbs_core(dev)(t64.to_torch64(luts),
                                       torch.from_numpy(lut_idx),
                                       t64.to_torch64(cts)))
    assert np.array_equal(got, want)
    for i in (0, 5):
        g = golden_pbs(P, sk.bsk, sk.ksk, cts[i], luts[lut_idx[i]])
        assert np.array_equal(g, got[i])
    dec = [jlwe.decrypt_lwe(P, ck.lwe_key, got[i]) for i in range(8)]
    assert dec == [FS[lut_idx[i]](int(m)) for i, m in enumerate(msgs)]


# ---------------- executor and has_match ----------------


def test_affine_combine64_matches_jax():
    """The one int64 expression of the port's executor equals the JAX
    executor's shift / negate / select ladder on limb pairs."""
    P = TEST_PARAMS_64
    rng = np.random.default_rng(6)
    W, n1 = 24, P.lwe_dimension + 1
    near = np.array([(1 << 63) + d for d in (-3, -1, 0, 1, 2)]
                    + [(1 << 64) - 1, (1 << 62) + 5], np.uint64)
    gathered = np.where(rng.random((W, 3, n1)) < 0.5,
                        rng.choice(near, size=(W, 3, n1)),
                        _random_u64(rng, (W, 3, n1)))
    coefs = rng.choice([0, 1, -1, 2, -2, 4, -4], size=(W, 3)).astype(np.int32)
    consts = rng.integers(-4, 9, size=W).astype(np.int32)
    jex = JaxExecutor.__new__(JaxExecutor)
    jex.params = P
    want = t64.limbs_to_np(np.asarray(jex._affine_combine(
        jnp.asarray(t64.np_to_limbs(gathered)), jnp.asarray(coefs),
        jnp.asarray(consts))))
    ex = Executor.__new__(Executor)
    ex.params = _tp(P)
    got = ex._affine_combine(t64.to_torch64(gathered),
                             torch.from_numpy(coefs), torch.from_numpy(consts))
    assert got.dtype == torch.int64
    assert np.array_equal(_u64(got), want)


@pytest.mark.parametrize("n,pattern,fold", [
    (3, "/^abc$/", "reference"),
    (16, "/abc/", "tree"),
    (2, "/^[a-d][^xyz]$/i", "tree"),
    (12, "/^(ab|cd)[a-z]{3,}e?$/i", "reference"),
])
def test_level_plans_equal_jax_64(n, pattern, fold):
    params = port.get_params("TEST_PARAMS_64")
    circ = compile_circuit(params, *compile_match(n, pattern, fold=fold),
                           min_bucket=port.default_min_bucket())
    jc = jax_compile_circuit(TEST_PARAMS_64,
                             *jax_compile_match(n, pattern, fold=fold),
                             min_bucket=8)
    assert (circ.num_slots, circ.ct_ops, circ.cache_hits, circ.pbs_count) == (
        jc.num_slots, jc.ct_ops, jc.cache_hits, jc.pbs_count)
    assert circ.luts.dtype == jc.luts.dtype == np.uint64
    assert np.array_equal(circ.luts, jc.luts)
    assert len(circ.levels) == len(jc.levels)
    for a, b in zip(circ.levels, jc.levels):
        for f in ("in_slots", "in_coefs", "consts", "lut_idx", "out_idx"):
            assert np.array_equal(getattr(a, f), getattr(b, f)), f


@pytest.mark.parametrize("fold", ["reference", "tree"])
@pytest.mark.parametrize("content,pattern,exp", REFERENCE_VECTORS,
                         ids=[f"{c}~{p}" for c, p, _ in REFERENCE_VECTORS])
def test_has_match_ciphertext_equals_jax_64(keys64, content, pattern, exp,
                                            fold):
    ck, sk = keys64["TEST_PARAMS_64"]
    ct = port.trivial_encrypt_str(port.get_params("TEST_PARAMS_64"), content)
    want = jax_has_match(sk, ct, pattern, fold=fold, engine="python",
                         backend="jnp64")
    got = port.has_match(server_key_from_jax(sk), ct, pattern, fold=fold,
                         device="cpu")
    assert got.dtype == want.dtype == np.uint64
    assert np.array_equal(got, want)
    assert jlwe.decrypt_byte(TEST_PARAMS_64, ck.lwe_key, got) == exp


@pytest.mark.parametrize("content,pattern,fold", [
    ("xaby", "/ab/", "reference"),
    ("Acdde", "/^a[b-d]{2,4}e$/i", "tree"),
])
def test_has_match_real_encryption_equals_jax_64(keys64, content, pattern,
                                                 fold):
    ck, sk = keys64["T64N"]
    ct = jax_encrypt_str(ck, content)          # one encryption, both packages
    want = jax_has_match(sk, ct, pattern, fold=fold, engine="python",
                         backend="jnp64")
    got = port.has_match(_port_sk("T64N", keys64), ct, pattern, fold=fold,
                         device="cpu")
    assert np.array_equal(got, want)
    assert jlwe.decrypt_byte(NOISY64, ck.lwe_key, got) == 1


def test_port_keys_roundtrip_64():
    """The port's own gen_keys / encrypt_str / has_match / decrypt at 64
    bits, with uint64 ciphertexts of the radix shape."""
    params = port.get_params("TEST_PARAMS_64")
    ck, sk = port.gen_keys(params, seed=5)
    ct = port.encrypt_str(ck, "xaby")
    assert ct.dtype == np.uint64
    res = port.has_match(sk, ct, "/ab/", fold="tree", device="cpu")
    assert res.dtype == np.uint64
    assert res.shape == (params.num_blocks, params.lwe_dimension + 1)
    assert port.decrypt(ck, res) == 1
    assert port.decrypt(ck, port.has_match(sk, ct, "/ba/", device="cpu")) == 0


# ---------------- backends, wrappers, keys ----------------


@pytest.mark.parametrize("backend,device,P,want", [
    (None, "cpu", TEST_PARAMS_64, "torch64"),
    (None, "cuda", TEST_PARAMS_64, "cuda64-bg"),
    (None, "cuda:0", TPU64_MESSAGE_2_CARRY_2, "cuda64-bg"),
    ("cuda64", "cpu", TPU64_MESSAGE_2_CARRY_2, "cuda64"),
    ("torch64", "cuda", TEST_PARAMS_64, "torch64"),
    (None, "cuda", TEST_PARAMS, "cuda-fused"),
    (None, "cpu", TEST_PARAMS, "torch"),
    (None, "cuda", None, "cuda-fused"),
])
def test_resolve_backend_64(backend, device, P, want):
    params = None if P is None else _tp(P)
    assert tpbs.resolve_backend(backend, device, params) == want


@pytest.mark.parametrize("backend,P,match", [
    ("torch", TEST_PARAMS_64, "needs a 32-bit"),
    ("cuda-fused", TPU64_MESSAGE_2_CARRY_2, "needs a 32-bit"),
    ("torch64", TEST_PARAMS, "needs a 64-bit"),
    ("cuda64-bg", TEST_PARAMS, "needs a 64-bit"),
    ("pallas64-bg", TEST_PARAMS_64, "unknown backend"),
])
def test_resolve_backend_width_errors(backend, P, match):
    with pytest.raises(ValueError, match=match):
        tpbs.resolve_backend(backend, "cpu", _tp(P))


def test_prepare_server_key_errors_64(keys64):
    tsk = _port_sk("TEST_PARAMS_64", keys64)
    for backend in ("cuda64", "cuda64-bg"):
        with pytest.raises(ValueError, match="needs a CUDA device"):
            tpbs.prepare_server_key(tsk.params, tsk, "cpu", backend)
    narrow = dataclasses.replace(tsk, bsk=tsk.bsk.astype(np.uint32))
    with pytest.raises(TypeError, match="bsk is uint32"):
        tpbs.prepare_server_key(tsk.params, narrow, "cpu")


def test_kernel_wrappers_take_plain_path_on_cpu_64(keys64):
    """On CPU tensors both 64-bit wrappers are the plain rotation and
    launch nothing; the batch-block rule is checked first, as in JAX."""
    tp = _tp(NOISY64)
    _, sk = keys64["T64N"]
    _, _, luts, lut_idx, ms = _rotation_inputs("T64N", keys64, 16, seed=5)
    args = (tp, t64.to_torch64(sk.bsk), t64.to_torch64(luts),
            torch.from_numpy(lut_idx), torch.from_numpy(ms))
    before = (blind_rotate_fused64.launches, blind_rotate_fused64_bg.launches)
    want = t64.blind_rotate64(*args)
    assert torch.equal(blind_rotate_fused64(*args), want)
    for tb in (None, 16, 8):
        assert torch.equal(blind_rotate_fused64_bg(*args, tb=tb), want)
    assert before == (blind_rotate_fused64.launches,
                      blind_rotate_fused64_bg.launches)
    for tb in (4, 12, 24, 0):
        with pytest.raises(ValueError, match="batch block"):
            blind_rotate_fused64_bg(*args, tb=tb)
    short = (tp, args[1], args[2], args[3][:5], args[4][:5])
    with pytest.raises(ValueError, match="8-aligned blocks"):
        blind_rotate_fused64_bg(*short)
    meta = torch.empty((8, tp.lwe_dimension + 1), dtype=torch.int32,
                       device="meta")
    for fn in (blind_rotate_fused64, blind_rotate_fused64_bg):
        with pytest.raises(ValueError, match="no blind rotation kernel"):
            fn(tp, meta, meta, meta, meta)


def test_server_key_from_jax_keeps_64bit_words(keys64):
    """A 64-bit JAX key crosses bit for bit (it used to be cast to uint32),
    and a key whose dtype contradicts its set raises."""
    _, sk = keys64["TEST_PARAMS_64"]
    tsk = server_key_from_jax(sk)
    assert tsk.bsk.dtype == tsk.ksk.dtype == np.uint64
    assert np.array_equal(tsk.bsk, sk.bsk) and np.array_equal(tsk.ksk, sk.ksk)
    assert np.any(sk.bsk >> np.uint64(32))         # high words were at stake
    cut = dataclasses.replace(sk, bsk=sk.bsk.astype(np.uint32))
    with pytest.raises(ValueError, match="64-bit torus"):
        server_key_from_jax(cut)


def test_cli_64bit_on_cpu(capsys):
    from fhe_regex_tpu_torch.cli import main

    args = ["--params", "TEST_PARAMS_64", "--trivial", "--device", "cpu",
            "--seed", "1"]
    assert main(args + ["abc", "/b/"]) == 0
    assert main(args + ["--backend", "torch64", "abc", "/x/"]) == 0
    assert capsys.readouterr().out.splitlines() == ["res: 1", "res: 0"]
    assert main(args + ["--backend", "cuda64-bg", "abc", "/b/"]) == 2
    assert main(args + ["--backend", "torch", "abc", "/b/"]) == 2
