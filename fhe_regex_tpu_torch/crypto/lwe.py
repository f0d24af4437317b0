"""LWE encode/encrypt/decrypt and trivial ciphertexts (client-side, NumPy).

Mirrors the role of the reference's ciphertext helpers
(src/regex/ciphertext.rs:8-45): per-ASCII-byte radix encryption as
``num_blocks`` little-endian 2-bit blocks, each block one LWE ciphertext, and
noiseless "trivial" ciphertexts (zero mask + encoded body) used for constants
and the fast test path.

Representation: an LWE ciphertext is a uint32 vector of length n+1,
layout ``[a_0 .. a_{n-1}, b]`` with decryption phase ``b - <a, s>`` (mod q).
A radix ("string char") ciphertext is ``[num_blocks, n+1]``; encrypted
content is ``[len, num_blocks, n+1]``.
"""

from __future__ import annotations

import numpy as np

from fhe_regex_tpu_torch.params import Params

U32 = np.uint32


def torus_dtype(params: Params):
    return np.uint32 if params.torus_bits == 32 else np.uint64


def encode(params: Params, m: int):
    """Plaintext block value -> torus (padding bit stays 0 for m < slots/2)."""
    return torus_dtype(params)((m % params.plaintext_slots) * params.delta)


def decode(params: Params, phase: np.uint32) -> int:
    """Torus -> plaintext block value, rounding to the nearest slot."""
    slots = params.plaintext_slots
    # round(phase / delta) mod slots, careful with wraparound
    half = params.delta // 2
    return int(((int(phase) + half) // params.delta) % slots)


def encrypt_lwe(params: Params, s: np.ndarray, m: int, rng) -> np.ndarray:
    """Encrypt one block value under LWE secret key s (binary, length n)."""
    n = params.lwe_dimension
    dt = torus_dtype(params)
    a = rng.uniform_torus(n, params.torus_bits)
    e = rng.gaussian_torus((), params.lwe_noise_std, params.torus_bits)
    with np.errstate(over="ignore"):
        b = (np.sum(a * s.astype(dt), dtype=dt) + encode(params, m) + e).astype(dt)
    ct = np.empty(n + 1, dtype=dt)
    ct[:n] = a
    ct[n] = b
    return ct


def decrypt_lwe(params: Params, s: np.ndarray, ct: np.ndarray) -> int:
    n = params.lwe_dimension
    dt = torus_dtype(params)
    with np.errstate(over="ignore"):
        phase = (ct[n] - np.sum(ct[:n] * s.astype(dt), dtype=dt)).astype(dt)
    return decode(params, phase)


def trivial_lwe(params: Params, m: int) -> np.ndarray:
    """Noiseless ciphertext of a known block value: zero mask, encoded body.

    Equivalent of shortint ``create_trivial`` (reference ciphertext.rs:15-26):
    decrypts correctly under any key.
    """
    ct = np.zeros(params.lwe_dimension + 1, dtype=torus_dtype(params))
    ct[-1] = encode(params, m)
    return ct


# ---------------- radix (byte) layer ----------------


def byte_to_blocks(params: Params, byte: int):
    """Little-endian 2-bit block values of a byte (ciphertext.rs:17-26)."""
    mask = params.message_modulus - 1
    return [
        (byte >> (i * params.message_bits)) & mask for i in range(params.num_blocks)
    ]


def blocks_to_byte(params: Params, blocks) -> int:
    v = 0
    for i, b in enumerate(blocks):
        v |= (b % params.message_modulus) << (i * params.message_bits)
    return v


def encrypt_byte(params: Params, s: np.ndarray, byte: int, rng) -> np.ndarray:
    return np.stack(
        [encrypt_lwe(params, s, bv, rng) for bv in byte_to_blocks(params, byte)]
    )


def decrypt_byte(params: Params, s: np.ndarray, ct_blocks: np.ndarray) -> int:
    return blocks_to_byte(
        params, [decrypt_lwe(params, s, ct_blocks[i]) for i in range(ct_blocks.shape[0])]
    )


def trivial_byte(params: Params, byte: int) -> np.ndarray:
    return np.stack([trivial_lwe(params, bv) for bv in byte_to_blocks(params, byte)])
