"""The PyTorch PBS pipeline (fhe_regex_tpu_torch.ops.pbs) against the JAX
package, stage by stage and end to end, bit for bit.

Inputs come from numpy (seeded generators and the shared ``keys`` /
``noisy_keys`` fixtures, converted with ``fhe_regex_tpu_torch.convert``) and
reach both packages as the same arrays.  Tolerance is zero: every stage is
integer arithmetic mod 2^32, and the port's float64 contractions are exact
by the bounds in its docstrings.  The Pallas fused kernel runs in interpret
mode, as the JAX package's own tests run it on the CPU.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fhe_regex_tpu.crypto import lwe as jlwe
from fhe_regex_tpu.crypto.golden import make_lut_poly, pbs as golden_pbs
from fhe_regex_tpu.ops import pbs as jpbs
from fhe_regex_tpu.ops import pbs_pallas
from fhe_regex_tpu.params import TEST_PARAMS, TEST_PARAMS_NOISY

from fhe_regex_tpu_torch.convert import server_key_from_jax
from fhe_regex_tpu_torch.ops import pbs as tpbs
from fhe_regex_tpu_torch.ops.pbs_cuda import blind_rotate_fused
from fhe_regex_tpu_torch.params import get_params as tget_params

torch.set_num_threads(2)

EDGES = np.array([0, 1, 0x7FFFFFFF, 0x80000000, 0x80000001, 0xFFFFFFFF,
                  0xFFFFFFFE], np.uint32)


def _t(a: np.ndarray) -> torch.Tensor:
    """uint32/int32 numpy -> int32 torch with the same bits."""
    return torch.from_numpy(np.ascontiguousarray(a).view(np.int32))


def _j(a: np.ndarray):
    return jnp.asarray(np.ascontiguousarray(a).view(np.int32))


def _eq(torch_out: torch.Tensor, jax_out) -> bool:
    return np.array_equal(torch_out.numpy(), np.asarray(jax_out))


def _boundary_values(shift: int) -> np.ndarray:
    """Values on either side of the rounding boundaries k*2^shift - 2^(shift-1)."""
    k = np.array([0, 1, 2, 3, 1000, (1 << (32 - shift)) - 1], np.int64)
    mid = (k << shift) + (1 << (shift - 1))
    vals = np.concatenate([mid - 1, mid, mid + 1])
    return (vals & 0xFFFFFFFF).astype(np.uint32)


def _random_u32(rng, shape) -> np.ndarray:
    return rng.integers(0, 1 << 32, size=shape, dtype=np.uint64).astype(np.uint32)


@pytest.mark.parametrize("name", ["TEST_PARAMS", "TPU_MESSAGE_2_CARRY_2"])
def test_mod_switch_matches_jax(name):
    from fhe_regex_tpu.params import get_params

    params = tget_params(name)
    N = params.polynomial_size
    shift = params.torus_bits - (N.bit_length() - 1) - 1
    rng = np.random.default_rng(1)
    v = np.concatenate([EDGES, _boundary_values(shift),
                        _random_u32(rng, 500)])
    cts = np.resize(v, (len(v) // 10 + 1) * 10).reshape(-1, 10)
    got = tpbs.mod_switch(params, _t(cts))
    assert got.dtype == torch.int32
    assert _eq(got, jpbs.mod_switch(get_params(name), _j(cts)))


@pytest.mark.parametrize("base_log,level", [(7, 3), (3, 5), (8, 2), (4, 4)])
def test_decompose_matches_jax(base_log, level):
    rng = np.random.default_rng(base_log * 10 + level)
    v = np.concatenate([EDGES, _boundary_values(32 - base_log * level),
                        _random_u32(rng, 2000)])
    got = tpbs.decompose(_t(v), base_log, level)
    assert got.shape == (level, v.size) and got.dtype == torch.int32
    assert _eq(got, jpbs.decompose(_j(v), base_log, level))
    assert int(got.abs().max()) <= (1 << base_log) // 2


def test_negacyclic_rotate_matches_jax():
    rng = np.random.default_rng(2)
    N = 256
    polys = _random_u32(rng, (9, 2, N))
    r = np.array([0, 1, N - 1, N, N + 1, 2 * N - 1, 77, 300, 511], np.int32)
    got = tpbs.negacyclic_rotate_batch(_t(polys), torch.from_numpy(r))
    want = jpbs.negacyclic_rotate_batch(_j(polys), jnp.asarray(r))
    assert _eq(got, want)


def test_sample_extract_matches_jax():
    rng = np.random.default_rng(3)
    accs = _random_u32(rng, (6, 2, TEST_PARAMS.polynomial_size))
    accs[0, 0, 1:] = 0x80000000        # -(-2^31) wraps to itself
    got = tpbs.sample_extract(tget_params("TEST_PARAMS"), _t(accs))
    assert _eq(got, jpbs.sample_extract(TEST_PARAMS, _j(accs)))


def test_key_switch_matches_jax(noisy_keys):
    _, sk = noisy_keys
    P = TEST_PARAMS_NOISY
    rng = np.random.default_rng(4)
    big = _random_u32(rng, (12, P.glwe_key_dim + 1))
    big[0, :4] = EDGES[:4]
    tsk = server_key_from_jax(sk)
    ksk = tpbs.prepare_ksk(_t(tsk.ksk))
    got = tpbs.key_switch(tsk.params, ksk, _t(big))
    assert _eq(got, jpbs.key_switch(P, _j(sk.ksk), _j(big)))


def _rotation_inputs(params, keys, B, seed):
    """Real encryptions, mod-switched, plus two LUTs and a LUT selection."""
    ck, _ = keys
    rng = np.random.default_rng(seed)
    msgs = rng.integers(0, 16, size=B)
    cts = np.stack([jlwe.encrypt_lwe(params, ck.lwe_key, int(m), ck.rng)
                    for m in msgs])
    luts = np.stack([make_lut_poly(params, lambda x: (3 * x + 1) % 16),
                     make_lut_poly(params, lambda x: (x * x) % 16)])
    lut_idx = (np.arange(B) % 2).astype(np.int32)
    ms = np.array(jpbs.mod_switch(params, _j(cts)))
    return msgs, cts, luts, lut_idx, ms


@pytest.mark.parametrize("B", [8, 5])
def test_blind_rotate_matches_jax_scan(noisy_keys, B):
    P = TEST_PARAMS_NOISY
    _, sk = noisy_keys
    _, _, luts, lut_idx, ms = _rotation_inputs(P, noisy_keys, B, seed=B)
    want = jpbs.blind_rotate(P, _j(sk.bsk), _j(luts), jnp.asarray(lut_idx),
                             jnp.asarray(ms))
    tsk = server_key_from_jax(sk)
    got = tpbs.blind_rotate(tsk.params, _t(tsk.bsk), _t(luts),
                            torch.from_numpy(lut_idx), torch.from_numpy(ms))
    assert got.shape == (B, 2, P.polynomial_size)
    assert _eq(got, want)


def test_blind_rotate_matches_pallas_fused_interpret(noisy_keys):
    """The plain rotation equals the Pallas kernel the CUDA kernel replaces
    (stack_rows + bank_split, as has_match runs it on the TPU)."""
    P = TEST_PARAMS_NOISY
    _, sk = noisy_keys
    _, _, luts, lut_idx, ms = _rotation_inputs(P, noisy_keys, 8, seed=11)
    raw = jnp.asarray(pbs_pallas.prepare_bsk_fused_raw(P, sk.bsk))
    want = pbs_pallas.blind_rotate_fused(
        P, raw, _j(luts), jnp.asarray(lut_idx), jnp.asarray(ms),
        stack_rows=True, bank_split=True)
    tsk = server_key_from_jax(sk)
    got = tpbs.blind_rotate(tsk.params, _t(tsk.bsk), _t(luts),
                            torch.from_numpy(lut_idx), torch.from_numpy(ms))
    assert _eq(got, want)


@pytest.mark.parametrize("fixture,name", [("keys", "TEST_PARAMS"),
                                          ("noisy_keys", "TEST_PARAMS_NOISY")])
def test_pbs_batch_matches_jax_and_golden(request, fixture, name):
    from fhe_regex_tpu.params import get_params

    keys = request.getfixturevalue(fixture)
    ck, sk = keys
    P = get_params(name)
    msgs, cts, luts, lut_idx, _ = _rotation_inputs(P, keys, 8, seed=21)
    want = jpbs.pbs_batch(P, _j(sk.bsk), _j(sk.ksk), _j(luts),
                          jnp.asarray(lut_idx), _j(cts))
    tsk = server_key_from_jax(sk)
    dev = tpbs.prepare_server_key(tsk.params, tsk, "cpu", "torch")
    core = tpbs.make_pbs_core(dev)
    got = core(_t(luts), torch.from_numpy(lut_idx), _t(cts))
    assert _eq(got, want)
    out = got.numpy().view(np.uint32)
    for i in (0, 5):
        g = golden_pbs(P, sk.bsk, sk.ksk, cts[i], luts[lut_idx[i]])
        assert np.array_equal(g, out[i])
    fs = [lambda x: (3 * x + 1) % 16, lambda x: (x * x) % 16]
    dec = [jlwe.decrypt_lwe(P, ck.lwe_key, out[i]) for i in range(8)]
    assert dec == [fs[lut_idx[i]](int(m)) for i, m in enumerate(msgs)]


def test_kernel_wrapper_takes_plain_path_on_cpu(noisy_keys):
    """On CPU tensors the CUDA wrapper is the plain rotation and launches
    nothing."""
    _, sk = noisy_keys
    tsk = server_key_from_jax(sk)
    _, _, luts, lut_idx, ms = _rotation_inputs(TEST_PARAMS_NOISY, noisy_keys,
                                               3, seed=5)
    args = (tsk.params, _t(tsk.bsk), _t(luts), torch.from_numpy(lut_idx),
            torch.from_numpy(ms))
    before = blind_rotate_fused.launches
    assert torch.equal(blind_rotate_fused(*args), tpbs.blind_rotate(*args))
    assert blind_rotate_fused.launches == before


@pytest.mark.parametrize("backend,device,want", [
    (None, "cpu", "torch"),
    (None, "cuda", "cuda-fused"),
    (None, "cuda:0", "cuda-fused"),
    ("torch", "cuda", "torch"),
    ("cuda-fused", "cpu", "cuda-fused"),
])
def test_resolve_backend(backend, device, want):
    assert tpbs.resolve_backend(backend, device) == want


def test_backend_errors(keys):
    tsk = server_key_from_jax(keys[1])
    with pytest.raises(ValueError, match="unknown backend"):
        tpbs.resolve_backend("pallas-fused", "cpu")
    with pytest.raises(ValueError, match="needs a CUDA device"):
        tpbs.prepare_server_key(tsk.params, tsk, "cpu", "cuda-fused")
