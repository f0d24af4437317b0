"""Client-side randomness.

The reference's crypto stack uses concrete-csprng (AES-128-CTR) for secret
keys, mask sampling and Gaussian noise (SURVEY.md N11).  Bit-exactness is
defined on decrypted results, not on random streams, so the contract is the
*distributions*, with a cryptographically strong generator.

Primary backend: the native AES-128-CTR keystream (native/aes_ctr.cpp,
FIPS-197-validated, loaded via ctypes) — key/nonce derived from the seed by
SHA-256.  Gaussian noise via Box-Muller over the AES uniforms.  If the
shared library has not been built (``make -C native``), falls back to NumPy
PCG64 with the same API.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
from pathlib import Path
from typing import Optional

import numpy as np

_LIB_PATH = Path(__file__).resolve().parents[2] / "native" / "libfheregex.so"
_lib = None


def _load_lib():
    global _lib
    if _lib is None and _LIB_PATH.exists():
        lib = ctypes.CDLL(str(_LIB_PATH))
        lib.aes128_ctr_keystream.argtypes = [
            ctypes.c_char_p, ctypes.c_char_p, ctypes.c_uint64,
            ctypes.c_void_p, ctypes.c_size_t,
        ]
        _lib = lib
    return _lib


class _AesStream:
    """uint32 stream from AES-128-CTR."""

    def __init__(self, seed: int):
        d = hashlib.sha256(str(seed).encode() + b"/fhe-regex-tpu").digest()
        self.key, self.nonce = d[:16], d[16:24]
        self.block = 0
        self._buf = np.empty(0, np.uint32)

    def uint32(self, count: int) -> np.ndarray:
        if self._buf.size < count:
            need_blocks = (count - self._buf.size + 3) // 4 + 1024
            out = np.empty(need_blocks * 16, np.uint8)
            _lib.aes128_ctr_keystream(
                self.key, self.nonce, self.block,
                out.ctypes.data_as(ctypes.c_void_p), need_blocks)
            self.block += need_blocks
            self._buf = np.concatenate([self._buf, out.view(np.uint32)])
        res, self._buf = self._buf[:count], self._buf[count:]
        return res.copy()


class Csprng:
    def __init__(self, seed: Optional[int] = None, backend: Optional[str] = None):
        if seed is None:
            seed = int.from_bytes(os.urandom(16), "little")
        self.seed = seed
        if backend is None:
            backend = "aes" if _load_lib() is not None else "pcg64"
        self.backend = backend
        if backend == "aes":
            if _load_lib() is None:
                raise RuntimeError("native/libfheregex.so not built (make -C native)")
            self._aes = _AesStream(seed)
        else:
            self._rng = np.random.Generator(np.random.PCG64(seed))

    # ---- raw draws ----

    def _u32(self, count: int) -> np.ndarray:
        if self.backend == "aes":
            return self._aes.uint32(count)
        return self._rng.integers(0, 1 << 32, size=count, dtype=np.uint32)

    # ---- distributions ----

    def uniform_torus(self, shape, torus_bits: int = 32) -> np.ndarray:
        n = int(np.prod(shape)) if shape != () else 1
        if torus_bits == 32:
            v = self._u32(n)
        elif torus_bits == 64:
            w = self._u32(2 * n)
            v = w[0::2].astype(np.uint64) | (w[1::2].astype(np.uint64) << 32)
        else:
            raise ValueError(torus_bits)
        return v.reshape(shape)

    def binary(self, shape) -> np.ndarray:
        n = int(np.prod(shape)) if shape != () else 1
        return (self._u32(n) & 1).reshape(shape)

    def gaussian_torus(self, shape, std: float, torus_bits: int = 32) -> np.ndarray:
        """Rounded-Gaussian torus noise with absolute std (torus units)."""
        dtype = np.uint32 if torus_bits == 32 else np.uint64
        if std == 0.0:
            return np.zeros(shape, dtype=dtype)
        n = int(np.prod(shape)) if shape != () else 1
        if self.backend == "aes":
            # Box-Muller over AES uniforms
            m = (n + 1) // 2
            u = self._u32(2 * m).astype(np.float64)
            u1 = (u[:m] + 1.0) / 4294967296.0       # (0, 1]
            u2 = u[m:] / 4294967296.0               # [0, 1)
            r = np.sqrt(-2.0 * np.log(u1))
            z = np.concatenate([r * np.cos(2 * np.pi * u2),
                                r * np.sin(2 * np.pi * u2)])[:n]
            noise = np.rint(z * std)
        else:
            noise = np.rint(self._rng.normal(0.0, std, size=n))
        return noise.astype(np.int64).astype(dtype).reshape(shape)
