"""ctypes binding for the native single-thread f64-FFT PBS
(native/pbs_fft.cpp) — the measured CPU baseline denominator.

This is NOT a serving backend: it exists so BASELINE.md's denominator can be
a number *measured on this machine* for the reference's own compute recipe
(tfhe-rs 0.2 + concrete-fft: split-complex f64 negacyclic FFT external
products; reference Cargo.lock, reference/README.md:18-20), instead of
only the citable 100 bootstraps/s figure.  Driven by
benchmarks/cpu_baseline.py; correctness is decrypt-gated against the golden
model's keys (tests/test_native_fft.py).
"""

from __future__ import annotations

import ctypes
from pathlib import Path

import numpy as np

from fhe_regex_tpu_torch.params import Params

_LIB_PATH = Path(__file__).resolve().parents[2] / "native" / "libpbsfft.so"
_lib = None


def available() -> bool:
    return _load() is not None


def _load():
    global _lib
    if _lib is None and _LIB_PATH.exists():
        lib = ctypes.CDLL(str(_LIB_PATH))
        lib.pbsfft_prepare.restype = ctypes.c_void_p
        lib.pbsfft_prepare.argtypes = [
            ctypes.POINTER(ctypes.c_uint64), ctypes.c_int, ctypes.c_int,
            ctypes.c_int, ctypes.c_int, ctypes.c_int]
        lib.pbsfft_free.argtypes = [ctypes.c_void_p]
        lib.pbsfft_pbs.argtypes = [
            ctypes.c_void_p, ctypes.POINTER(ctypes.c_uint64), ctypes.c_int,
            ctypes.c_int, ctypes.POINTER(ctypes.c_uint64),
            ctypes.POINTER(ctypes.c_uint64), ctypes.POINTER(ctypes.c_uint64)]
        _lib = lib
    return _lib


def _u64ptr(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_uint64))


class NativeFftPbs:
    """One prepared bootstrap context (FFT'd bsk held native-side)."""

    def __init__(self, params: Params, bsk: np.ndarray, ksk: np.ndarray):
        if params.torus_bits != 64:
            raise ValueError("native FFT PBS is 64-bit-torus only")
        lib = _load()
        if lib is None:
            raise RuntimeError("native/libpbsfft.so not built (make -C native)")
        self.params = params
        self._lib = lib
        self._bsk = np.ascontiguousarray(bsk, dtype=np.uint64)
        self._ksk = np.ascontiguousarray(ksk, dtype=np.uint64)
        self._h = lib.pbsfft_prepare(
            _u64ptr(self._bsk), params.lwe_dimension, params.glwe_dimension,
            params.polynomial_size, params.pbs_level, params.pbs_base_log)

    def pbs(self, ct: np.ndarray, lut_poly: np.ndarray) -> np.ndarray:
        p = self.params
        ct = np.ascontiguousarray(ct, dtype=np.uint64)
        lut = np.ascontiguousarray(lut_poly, dtype=np.uint64)
        out = np.empty(p.lwe_dimension + 1, dtype=np.uint64)
        self._lib.pbsfft_pbs(self._h, _u64ptr(self._ksk), p.ks_base_log,
                             p.ks_level, _u64ptr(ct), _u64ptr(lut),
                             _u64ptr(out))
        return out

    def close(self):
        if self._h is not None:
            self._lib.pbsfft_free(self._h)
            self._h = None

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass
