"""The port's copy of the native single-thread f64-FFT PBS
(``fhe_regex_tpu_torch/crypto/native_fft.py`` over native/pbs_fft.cpp)
against the port's own golden model and keys: the twin of
tests/test_native_fft.py.

The f64 transform carries the reference's concrete-fft rounding floor, so
the contract is the decryption (every LUT output) and a phase within
delta / 64 of the exact golden pipeline's, as for the JAX package's
module.  Skipped, as there, unless ``native/libpbsfft.so`` is built
(``make -C native libpbsfft.so``)."""

import dataclasses

import numpy as np
import pytest

from fhe_regex_tpu_torch.crypto import golden, lwe as L
from fhe_regex_tpu_torch.crypto.keys import gen_keys
from fhe_regex_tpu_torch.crypto.native_fft import NativeFftPbs, available
from fhe_regex_tpu_torch.params import TEST_PARAMS, TEST_PARAMS_64

pytestmark = pytest.mark.skipif(not available(),
                                reason="native/libpbsfft.so not built")

# noisy small 64-bit set: real noise, fast keygen (l=3 exercises the
# generic multi-level decompose path too)
P = dataclasses.replace(TEST_PARAMS_64, name="T64_FFT",
                        lwe_noise_std=float(1 << 18),
                        glwe_noise_std=float(1 << 16))


@pytest.fixture(scope="module")
def keys():
    return gen_keys(P, seed=31)


def test_fft_pbs_decrypts_all_slots(keys):
    ck, sk = keys
    eng = NativeFftPbs(P, sk.bsk, sk.ksk)
    f = lambda m: (3 * m + 1) % 16
    lut = golden.make_lut_poly(P, f)
    for m in range(16):
        ct = L.encrypt_lwe(P, ck.lwe_key, m, ck.rng)
        assert L.decrypt_lwe(P, ck.lwe_key, eng.pbs(ct, lut)) == f(m), m


def test_fft_pbs_output_close_to_golden(keys):
    """One ciphertext through the port's golden (exact) pipeline and the
    FFT engine: the phases agree far inside the LUT's decision margin."""
    ck, sk = keys
    eng = NativeFftPbs(P, sk.bsk, sk.ksk)
    lut = golden.make_lut_poly(P, lambda m: int(m == 3))
    ct = L.encrypt_lwe(P, ck.lwe_key, 3, ck.rng)
    a = golden.pbs(P, sk.bsk, sk.ksk, ct, lut)
    b = eng.pbs(ct, lut)
    n = P.lwe_dimension
    with np.errstate(over="ignore"):
        pa = (a[n] - (a[:n] * ck.lwe_key.astype(np.uint64)).sum()).astype(
            np.uint64)
        pb = (b[n] - (b[:n] * ck.lwe_key.astype(np.uint64)).sum()).astype(
            np.uint64)
        d = np.int64(pa - pb)
    assert abs(int(d)) < P.delta // 64


def test_fft_pbs_rejects_32bit():
    with pytest.raises(ValueError, match="64-bit"):
        NativeFftPbs(TEST_PARAMS, np.zeros(1), np.zeros(1))
