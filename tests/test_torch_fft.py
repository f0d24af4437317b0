"""The FFT backend of the PyTorch port (``ops/pbs_fft.py``, backend
``fft``) against the JAX package's ``ops/pbs_fft.py`` and the port's exact
``torch`` backend.

* Host helpers and the spectral key equal the JAX package's: the port's
  complex128 spectrum (its one limb plan, JAX's "mixed"), split into
  (re, im) and cast to float32, is the JAX key of transform ``xla``
  exactly.
* The port's ``fft`` PBS runs in float64, where every limb rounds to its
  exact integer, so it is bit-equal (tolerance zero) to the port's
  ``torch`` PBS at TEST_PARAMS, TEST_PARAMS_NOISY and the production
  geometry (N = 2048, n cut to 16).  Against JAX ``fft`` (either of its
  transforms): bit-equal to plan "8" (exact in f32 too); against "mixed",
  whose f32 16-bit limb is noisy in the JAX package, the same decryptions
  and decryption phases within 2^(torus - message - carry - 3), as
  ``tests/test_pbs_fft.py`` holds the JAX backend.
* The entry points, the CLI and the daemon accept ``fft``; the packed
  paths' auto plan is classic there (the JAX package compiles the
  multi-value plan and then raises, a fault not copied), and
  ``multivalue=True`` raises as in the JAX package.

Keys come from seeds through the JAX package (``keys`` / ``noisy_keys``)
and reach the port as the same numpy arrays.
"""

import dataclasses
import json
import threading
import urllib.request

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import fhe_regex_tpu as J
from fhe_regex_tpu.crypto import lwe as jlwe
from fhe_regex_tpu.crypto.golden import make_lut_poly
from fhe_regex_tpu.ops import pbs as jpbs
from fhe_regex_tpu.ops import pbs_fft as jfft
from fhe_regex_tpu.params import TEST_PARAMS_64, TEST_PARAMS_NOISY

import fhe_regex_tpu_torch as port
from fhe_regex_tpu_torch.convert import client_key_from_jax, server_key_from_jax
from fhe_regex_tpu_torch.ops import pbs as tpbs
from fhe_regex_tpu_torch.ops import pbs_fft as tfft
from fhe_regex_tpu_torch.params import get_params

torch.set_num_threads(2)

JAX_KW = dict(engine="python")


def _port(keys):
    return client_key_from_jax(keys[0]), server_key_from_jax(keys[1])


def _fresh(sk):
    """The JAX server key as a new object: the JAX package caches its
    executor, and with it the limb plan FHE_REGEX_FFT_LIMBS named, on the
    key object."""
    return dataclasses.replace(sk)


def _enc(ck, strings):
    return np.stack([J.encrypt_str(ck, s) for s in strings])


# ---------------- host helpers and the spectral key ----------------


@pytest.mark.parametrize("plan", [(8, 8, 8, 8), (16, 8, 8), (16, 16)])
def test_limbs_and_weights_equal_jax(plan):
    rng = np.random.default_rng(0)
    x = rng.integers(-2**31, 2**31, size=5000, dtype=np.int64)
    x = np.concatenate([[-2**31, -1, 0, 1, 2**31 - 1], x]).astype(np.int32)
    assert np.array_equal(tfft._limbs_signed(torch.from_numpy(x), plan),
                          jfft._limbs_signed(x, plan))
    assert tfft.plan_weights(plan) == jfft.plan_weights(plan)
    assert tfft.PLAN == jfft.resolve_plan("mixed")


@pytest.mark.parametrize("M", [2, 8, 64, 128, 512, 1024, 2048])
def test_spectrum_multiplies_negacyclically(M):
    """``negacyclic_fft`` (torch) is the JAX package's host spectrum to
    float64 rounding, and the inverse of a product of two spectra rounds
    to the exact negacyclic product of a 16-bit limb and a 7-bit digit
    polynomial."""
    rng = np.random.default_rng(M)
    N = 2 * M
    a = rng.integers(-2**15, 2**15, (2, N))
    b = rng.integers(-64, 65, (2, N))
    A = tfft.negacyclic_fft(torch.from_numpy(a).double())
    want = jfft.negacyclic_fft_host(a.astype(np.float64))
    assert np.abs(A.numpy() - want).max() <= 1e-12 * np.abs(want).max()
    y = torch.fft.ifft(A * tfft.negacyclic_fft(torch.from_numpy(b).double()))
    y = y * torch.from_numpy(np.conj(tfft._twist(N)))
    got = torch.round(torch.cat([y.real, y.imag], dim=-1)).long().numpy()
    for row in range(2):
        full = np.convolve(a[row], b[row])                     # degree 2N-2
        exact = full[:N] - np.concatenate([full[N:], [0]])     # X^N = -1
        assert np.array_equal(got[row], exact)


@pytest.mark.parametrize("which", ["keys", "noisy_keys"])
def test_key_spectrum_equals_jax(request, which):
    """The spectral key in float32 (re, im) is the JAX key of plan "mixed"
    and transform ``xla`` exactly."""
    sk = request.getfixturevalue(which)[1]
    got = tfft.prepare_bsk_fft(get_params(sk.params.name), sk.bsk)
    want = jfft.prepare_bsk_fft(sk.params, sk.bsk, "mixed", "xla")
    assert got.dtype == torch.complex128
    spec = got.numpy()
    ri = np.stack([spec.real, spec.imag], axis=-2).astype(np.float32)
    assert ri.shape == want.shape and np.array_equal(ri, want)


def test_server_key_holds_the_spectrum(noisy_keys):
    """An fft key's ``bsk`` is its complex128 spectrum; a spectrum of
    another shape is refused."""
    tsk = server_key_from_jax(noisy_keys[1])
    P = tsk.params
    dk = tpbs.prepare_server_key(P, tsk, "cpu", "fft")
    assert dk.backend == "fft" and dk.bsk.dtype == torch.complex128
    assert tuple(dk.bsk.shape) == (16, 6, 2, 3, 128)
    with pytest.raises(ValueError, match="spectral key"):
        tfft.blind_rotate_fft(P, dk.bsk[..., :2, :],
                              torch.zeros((1, 256), dtype=torch.int32),
                              torch.zeros(1, dtype=torch.int32),
                              torch.zeros((1, 17), dtype=torch.int32))


# ---------------- the PBS ----------------


def _pbs_inputs(params, ck, msgs, f):
    cts = np.stack([jlwe.encrypt_lwe(params, ck.lwe_key, m, ck.rng)
                    for m in msgs])
    luts = np.stack([make_lut_poly(params, f)]).view(np.int32)
    return cts.view(np.int32), luts


def _port_pbs(params, sk, cts, luts, backend):
    dk = tpbs.prepare_server_key(get_params(params.name), sk, "cpu", backend)
    idx = torch.zeros(len(cts), dtype=torch.int32)
    return tpbs.make_pbs_core(dk)(torch.from_numpy(luts), idx,
                                  torch.from_numpy(cts)).numpy()


def _f_affine(x):
    return (x * 7 + 2) % 16


def _f_square(x):
    return (x * x) % 16


@pytest.mark.parametrize("f", [_f_affine, _f_square],
                         ids=["affine", "square"])
@pytest.mark.parametrize("which", ["keys", "noisy_keys"])
def test_fft_pbs_equals_torch(request, which, f):
    ck, sk = request.getfixturevalue(which)
    params = ck.params
    cts, luts = _pbs_inputs(params, ck, [0, 3, 8, 15, 6, 1, 9, 12], f)
    tsk = server_key_from_jax(sk)
    got = _port_pbs(params, tsk, cts, luts, "fft")
    want = _port_pbs(params, tsk, cts, luts, "torch")
    assert got.dtype == np.int32 and np.array_equal(got, want)


def _phases(params, ck, c):
    n = params.lwe_dimension
    a = c[:, :n].astype(np.int64)
    return (c[:, n].astype(np.int64) - a @ ck.lwe_key.astype(np.int64)) \
        & 0xFFFFFFFF


@pytest.mark.parametrize("jax_transform", ["xla", "matmul"])
@pytest.mark.parametrize("jax_plan", ["8", "mixed"])
def test_fft_pbs_against_jax(noisy_keys, jax_plan, jax_transform):
    """The port's one path against each JAX plan and transform.  Plan "8":
    bit-equal to JAX fft.  "mixed": JAX's f32 16-bit limb is noisy, so the
    same decryptions and phases within the margin."""
    ck, sk = noisy_keys
    P = TEST_PARAMS_NOISY
    f = lambda x: (x * 5 + 1) % 16                               # noqa: E731
    msgs = [0, 4, 9, 15, 2, 6, 11, 13]
    cts, luts = _pbs_inputs(P, ck, msgs, f)
    got = _port_pbs(P, server_key_from_jax(sk), cts, luts, "fft")
    fn = jpbs.make_pbs_fn(jpbs.prepare_server_key(
        P, sk, "fft", fft_plan=jax_plan, fft_transform=jax_transform))
    want = np.asarray(fn(jnp.asarray(luts), jnp.zeros(len(msgs), jnp.int32),
                         jnp.asarray(cts)))
    if jax_plan == "8":
        assert np.array_equal(got, want)
    u_got, u_want = got.view(np.uint32), want.view(np.uint32)
    dec = [jlwe.decrypt_lwe(P, ck.lwe_key, o) for o in u_got]
    assert dec == [jlwe.decrypt_lwe(P, ck.lwe_key, o) for o in u_want]
    assert dec == [f(m) for m in msgs]
    d = (_phases(P, ck, u_got) - _phases(P, ck, u_want)) & 0xFFFFFFFF
    d = np.abs(((d + (1 << 31)) & 0xFFFFFFFF) - (1 << 31))
    assert d.max() < 2 ** (P.torus_bits - P.message_bits - P.carry_bits - 3)


@pytest.fixture(scope="module")
def prod_shape():
    """TPU_MESSAGE_2_CARRY_2 with only n cut to 16 and no noise (the
    geometry of tests/test_pbs_fft.py::test_fft_production_geometry_n2048):
    N = 2048, M = 1024, l = 3, the one shape where the 16-bit limb's
    values pass 2^31.  Returns the set, keys, messages and ciphertexts and
    both backends' keys."""
    from fhe_regex_tpu_torch.crypto import lwe

    P = dataclasses.replace(get_params("TPU_MESSAGE_2_CARRY_2"),
                            name="TEST_PROD_SHAPE_FFT", lwe_dimension=16,
                            lwe_noise_std=0.0, glwe_noise_std=0.0)
    ck, sk = port.gen_keys(P, seed=11)
    msgs = [0, 3, 6, 9, 12, 15, 5, 10]
    cts = np.stack([lwe.encrypt_lwe(P, ck.lwe_key, m, ck.rng) for m in msgs])
    dks = {b: tpbs.prepare_server_key(P, sk, "cpu", b)
           for b in ("torch", "fft")}
    return P, ck, msgs, torch.from_numpy(cts.view(np.int32)), dks


@pytest.mark.parametrize("f", [_f_affine, _f_square],
                         ids=["affine", "square"])
def test_fft_pbs_production_geometry(prod_shape, f):
    from fhe_regex_tpu_torch.crypto import lwe

    P, ck, msgs, cts, dks = prod_shape
    x = (torch.from_numpy(np.stack([make_lut_poly(P, f)]).view(np.int32)),
         torch.zeros(len(msgs), dtype=torch.int32), cts)
    got = tpbs.make_pbs_core(dks["fft"])(*x)
    assert torch.equal(got, tpbs.make_pbs_core(dks["torch"])(*x))
    dec = [lwe.decrypt_lwe(P, ck.lwe_key, o) for o in got.numpy()
           .view(np.uint32)]
    assert dec == [f(m) for m in msgs]


# ---------------- entry points ----------------


@pytest.mark.parametrize("pattern,content,bit", [("/abc/", "xabcx", 1),
                                                 ("/^a[b-d]{2}e$/i", "Abdf",
                                                  0)])
def test_has_match_equals_jax(noisy_keys, monkeypatch, pattern, content, bit):
    """JAX on plan "8" (FHE_REGEX_FFT_LIMBS, which only the JAX package
    reads): its ciphertext bit for bit; JAX's default "mixed": the same
    decryption."""
    ck, sk = noisy_keys
    tck, tsk = _port(noisy_keys)
    ct = J.encrypt_str(ck, content)
    got = port.has_match(tsk, ct, pattern, backend="fft", device="cpu",
                         **JAX_KW)
    assert port.decrypt(tck, got) == bit
    monkeypatch.delenv("FHE_REGEX_FFT_LIMBS", raising=False)
    mixed = J.has_match(_fresh(sk), ct, pattern, backend="fft", **JAX_KW)
    assert J.decrypt(ck, mixed) == bit
    monkeypatch.setenv("FHE_REGEX_FFT_LIMBS", "8")
    want = J.has_match(_fresh(sk), ct, pattern, backend="fft", **JAX_KW)
    assert got.dtype == want.dtype and np.array_equal(got, want)


def test_has_match_many_takes_classic_plan(noisy_keys, monkeypatch):
    """The reference fault not copied: JAX has_match_many(backend="fft")
    compiles the multi-value plan (auto) and raises; the port takes the
    classic plan and equals JAX's multivalue=False ciphertexts."""
    monkeypatch.delenv("FHE_REGEX_MULTIVALUE", raising=False)
    monkeypatch.delenv("FHE_REGEX_MV_MIN_SAVINGS", raising=False)
    monkeypatch.setenv("FHE_REGEX_FFT_LIMBS", "8")     # the JAX side only
    ck, sk = noisy_keys
    sk = _fresh(sk)
    tck, tsk = _port(noisy_keys)
    cts = _enc(ck, ["xxabcxxx", "xxaqcxxx"])
    with pytest.raises(ValueError,
                       match="multi-value bootstrap not supported on 'fft'"):
        J.has_match_many(sk, cts, "/abc/", backend="fft", **JAX_KW)
    seen = []
    real = port._compile_auto_mv

    def spy(*args, **kw):
        seen.append(real(*args, **kw))
        return seen[-1]

    monkeypatch.setattr(port, "_compile_auto_mv", spy)
    got = port.has_match_many(tsk, cts, "/abc/", backend="fft", device="cpu",
                              **JAX_KW)
    assert not seen[-1].multivalue
    assert real(tsk.params, *port.compile_match(8, "/abc/"), None).multivalue
    want = J.has_match_many(sk, cts, "/abc/", backend="fft", multivalue=False,
                            **JAX_KW)
    assert got.dtype == want.dtype and np.array_equal(got, want)
    assert [port.decrypt(tck, r) for r in got] == [1, 0]
    with pytest.raises(ValueError,
                       match="multi-value bootstrap not supported on 'fft'"):
        port.has_match_many(tsk, cts, "/abc/", backend="fft", device="cpu",
                            multivalue=True)


def test_cli_and_64bit(capsys):
    from fhe_regex_tpu_torch.cli import main

    assert main(["--params", "TEST_PARAMS", "--trivial", "--device", "cpu",
                 "--seed", "1", "--backend", "fft", "abc", "/b/"]) == 0
    assert capsys.readouterr().out.splitlines() == ["res: 1"]
    assert main(["--params", "TEST_PARAMS_64", "--trivial", "--device",
                 "cpu", "--seed", "1", "--backend", "fft", "abc", "/b/"]) == 2
    assert "32-bit parameter set" in capsys.readouterr().err
    ck, sk = port.gen_keys(get_params(TEST_PARAMS_64.name), seed=1)
    with pytest.raises(ValueError, match="32-bit parameter set"):
        tpbs.prepare_server_key(sk.params, sk, "cpu", "fft")
    with pytest.raises(ValueError, match="32-bit parameter set"):
        port.has_match(sk, port.encrypt_str(ck, "ab"), "/a/", backend="fft",
                       device="cpu")


def test_daemon_serves_fft_on_the_classic_plan(noisy_keys):
    """MatchService on fft: /health names it, the warmup manifest and
    /match_many run the classic plan (rotations == bootstraps) and equal
    has_match_many."""
    from fhe_regex_tpu_torch.serve import (MatchService, decode_array,
                                           encode_array, make_server)

    tck, tsk = _port(noisy_keys)
    svc = MatchService(tsk, backend="fft", device="cpu")
    report = svc.warmup([{"pattern": "/abc/", "content_len": 8, "many": 2}])
    assert report[0]["many"] == 2
    stats = svc.compile("/abc/", 8)
    assert stats["rotations"] == stats["bootstraps"]
    cts = _enc(noisy_keys[0], ["xxabcxxx", "xxaqcxxx"])
    srv = make_server(svc, port=0)
    th = threading.Thread(target=srv.serve_forever, daemon=True)
    th.start()
    try:
        url = f"http://127.0.0.1:{srv.server_address[1]}"
        with urllib.request.urlopen(url + "/health", timeout=60) as r:
            health = json.loads(r.read())
        req = urllib.request.Request(
            url + "/match_many",
            json.dumps({"pattern": "/abc/", "ct": encode_array(cts)})
            .encode(), {"Content-Type": "application/json"})
        with urllib.request.urlopen(req, timeout=300) as r:
            got = decode_array(json.loads(r.read())["ct"])
    finally:
        srv.shutdown()
        srv.server_close()
        th.join(timeout=30)
    assert not th.is_alive()
    assert health == {"status": "ok", "params": "TEST_PARAMS_NOISY",
                      "backend": "fft"}
    want = port.has_match_many(tsk, cts, "/abc/", backend="fft", device="cpu")
    assert np.array_equal(got, want)
    assert [port.decrypt(tck, r) for r in got] == [1, 0]
