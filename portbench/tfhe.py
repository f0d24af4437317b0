"""The client's side of TFHE for the benchmark, independent of the program.

Keys are made on the device from the run's seed (``gen_keys``: one
``torch.Generator``, a few large calls), as the TFHE definitions fix them:

  bootstrap key  [n, (k+1)l, k+1, N]  GGSW of each LWE key bit; row
                 (component c, level j) is a GLWE encryption of zero with
                 bit * q/B^(j+1) added to component c's constant term
  keyswitch key  [kN, ks_level, n+1]  LWE encryptions of zero with
                 big_key[t] * q/Bks^(j+1) added to the body

A GLWE body is sum_j A_j (*) S_j + E (negacyclic products mod X^N + 1), an
LWE body <a, s> + m * delta + e; decryption reads the phase b - <a, s>.
The server gets numpy arrays of the key's words (uint32 or uint64), the
client keeps the two binary keys.  Contents are encrypted and replies
decrypted on the host, in numpy (``encrypt_contents``, ``phases``), so
the client never touches the card the server measures.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

PARAM_FIELDS = ("torus_bits", "lwe_dimension", "lwe_noise_std",
                "glwe_dimension", "polynomial_size", "glwe_noise_std",
                "pbs_base_log", "pbs_level", "ks_base_log", "ks_level",
                "message_bits", "carry_bits", "num_blocks")


@dataclasses.dataclass(frozen=True)
class Params:
    """A TFHE parameter set as a configuration file states it."""

    name: str
    torus_bits: int
    lwe_dimension: int
    lwe_noise_std: float
    glwe_dimension: int
    polynomial_size: int
    glwe_noise_std: float
    pbs_base_log: int
    pbs_level: int
    ks_base_log: int
    ks_level: int
    message_bits: int
    carry_bits: int
    num_blocks: int

    @classmethod
    def from_config(cls, cfg: dict) -> "Params":
        p = cfg["params"]
        return cls(name=p["name"], **{f: p[f] for f in PARAM_FIELDS})

    @property
    def q(self) -> int:
        return 1 << self.torus_bits

    @property
    def slots(self) -> int:
        """Plaintext values: message and carry bits and the padding bit."""
        return 1 << (self.message_bits + self.carry_bits + 1)

    @property
    def delta(self) -> int:
        return self.q // self.slots

    @property
    def word(self):
        return np.uint32 if self.torus_bits == 32 else np.uint64


@dataclasses.dataclass
class ClientKey:
    params: Params
    lwe_key: np.ndarray        # [n] 0/1
    glwe_key: np.ndarray       # [k, N] 0/1


_MASK32 = (1 << 32) - 1


def _uniform(g: torch.Generator, shape, bits: int, device) -> torch.Tensor:
    """Uniform torus words as int64 bits: [0, 2^32) at 32 bits, every
    int64 at 64 bits."""
    lo = torch.randint(0, 1 << 32, shape, generator=g, device=device,
                       dtype=torch.int64)
    if bits == 32:
        return lo
    hi = torch.randint(0, 1 << 32, shape, generator=g, device=device,
                       dtype=torch.int64)
    return lo + hi * (1 << 32)          # wraps mod 2^64


def _gaussian(g: torch.Generator, shape, std: float, device) -> torch.Tensor:
    z = torch.randn(shape, generator=g, device=device, dtype=torch.float64)
    return torch.round(z * std).to(torch.int64)


def _wrap(v: torch.Tensor, bits: int) -> torch.Tensor:
    return v & _MASK32 if bits == 32 else v


def _negacyclic_matrix(s: torch.Tensor) -> torch.Tensor:
    """[N] 0/1 key -> [N, N] float64 T with (a @ T)[i] = (a (*) s)[i]
    mod X^N + 1: T[j, i] = s[i - j] for i >= j, -s[N + i - j] below."""
    N = s.shape[0]
    i = torch.arange(N, device=s.device)
    d = i[None, :] - i[:, None]
    return s.to(torch.float64)[d % N] * torch.where(d >= 0, 1.0, -1.0).to(
        torch.float64)


def _times_binary(a: torch.Tensor, T: torch.Tensor, bits: int) -> torch.Tensor:
    """a [..., N] torus words times a binary key's matrix T, exact: float64
    sums of at most N words below 2^32 (or of 16-bit limbs at 64 bits)
    stay below 2^53."""
    if bits == 32:
        return torch.matmul(a.to(torch.float64), T).to(torch.int64) & _MASK32
    out = torch.zeros_like(a)
    for j in range(4):
        limb = ((a >> (16 * j)) & 0xFFFF).to(torch.float64)
        out = out + torch.matmul(limb, T).to(torch.int64) * (1 << (16 * j))
    return out


def gen_keys(params: Params, seed: int, device) -> tuple:
    """(client key, bootstrap key, keyswitch key) from ``seed``, made on
    ``device``; the server's two keys come back as numpy word arrays."""
    p = params
    bits, n, k, N, l = (p.torus_bits, p.lwe_dimension, p.glwe_dimension,
                        p.polynomial_size, p.pbs_level)
    g = torch.Generator(device=device)
    g.manual_seed(seed)
    lwe_key = torch.randint(0, 2, (n,), generator=g, device=device)
    glwe_key = torch.randint(0, 2, (k, N), generator=g, device=device)

    # bootstrap key: n * (k+1) * l GLWE encryptions of zero
    rows = n * (k + 1) * l
    A = _uniform(g, (rows, k, N), bits, device)
    body = _gaussian(g, (rows, N), p.glwe_noise_std, device)
    for j in range(k):
        body = body + _times_binary(A[:, j], _negacyclic_matrix(glwe_key[j]),
                                    bits)
    bsk = torch.cat([A, _wrap(body, bits)[:, None]], dim=1).view(
        n, k + 1, l, k + 1, N)
    for c in range(k + 1):
        for j in range(l):
            gj = (1 << (bits - p.pbs_base_log * (j + 1))) % (1 << bits)
            if gj >= 1 << 63:
                gj -= 1 << 64
            bsk[:, c, j, c, 0] = _wrap(bsk[:, c, j, c, 0] + lwe_key * gj, bits)
    bsk = bsk.reshape(n, (k + 1) * l, k + 1, N)

    # keyswitch key: kN * ks_level LWE encryptions of zero
    big = glwe_key.reshape(-1)
    L = p.ks_level
    a = _uniform(g, (k * N, L, n), bits, device)
    s = lwe_key.to(torch.float64)
    if bits == 32:
        dot = torch.matmul(a.to(torch.float64), s).to(torch.int64)
    else:
        dot = torch.zeros(a.shape[:2], dtype=torch.int64, device=device)
        for j in range(4):
            limb = ((a >> (16 * j)) & 0xFFFF).to(torch.float64)
            dot = dot + torch.matmul(limb, s).to(torch.int64) * (1 << (16 * j))
    gks = torch.tensor([(1 << (bits - p.ks_base_log * (j + 1))) for j in
                        range(L)], dtype=torch.int64, device=device)
    b = dot + _gaussian(g, (k * N, L), p.lwe_noise_std, device) \
        + big[:, None] * gks[None, :]
    ksk = torch.cat([a, _wrap(b, bits)[..., None]], dim=-1)

    client = ClientKey(p, lwe_key.cpu().numpy().astype(np.int64),
                       glwe_key.cpu().numpy().astype(np.int64))
    return client, _words(bsk, p), _words(ksk, p)


def _words(t: torch.Tensor, p: Params) -> np.ndarray:
    a = t.cpu().numpy()
    return a.astype(np.uint32) if p.torus_bits == 32 else a.view(np.uint64)


def byte_blocks(params: Params, contents) -> np.ndarray:
    """[C] equal-length ASCII strings -> [C, L, num_blocks] block values,
    little-endian message_bits each."""
    raw = np.array([list(c.encode("ascii")) for c in contents], np.int64)
    shifts = params.message_bits * np.arange(params.num_blocks)
    return (raw[..., None] >> shifts) & ((1 << params.message_bits) - 1)


def encrypt_contents(key: ClientKey, contents, rng: np.random.Generator
                     ) -> np.ndarray:
    """[C] strings of one length -> fresh ciphertexts [C, L, num_blocks,
    n+1] in the torus word type."""
    p = key.params
    m = byte_blocks(p, contents)
    shape = m.shape
    m = m.reshape(-1)
    R, n = m.size, p.lwe_dimension
    a = rng.integers(0, 1 << p.torus_bits, size=(R, n), dtype=np.uint64,
                     endpoint=False) if p.torus_bits == 32 else rng.integers(
        0, np.iinfo(np.uint64).max, size=(R, n), dtype=np.uint64,
        endpoint=True)
    e = np.rint(rng.standard_normal(R) * p.lwe_noise_std).astype(np.int64)
    with np.errstate(over="ignore"):
        b = (_dot(a, key.lwe_key, p) + m.astype(np.uint64) * np.uint64(p.delta)
             + e.view(np.uint64))
    ct = np.concatenate([a, b[:, None]], axis=1)
    if p.torus_bits == 32:
        ct = (ct & np.uint64(_MASK32)).astype(np.uint32)
    return ct.reshape(shape + (n + 1,))


def _dot(a: np.ndarray, s: np.ndarray, p: Params) -> np.ndarray:
    """<a, s> mod 2^64 over the last axis of uint64 words (exact: numpy's
    uint64 sums wrap mod 2^64, which the 32-bit torus divides)."""
    with np.errstate(over="ignore"):
        return (a * s.astype(np.uint64)).sum(axis=-1, dtype=np.uint64)


def phases(key: ClientKey, cts: np.ndarray) -> np.ndarray:
    """Decryption phases b - <a, s> of [..., n+1] ciphertexts, as signed
    multiples of delta: each value's distance from the plaintext grid is
    its noise."""
    p = key.params
    w = np.asarray(cts).astype(np.uint64)
    with np.errstate(over="ignore"):
        ph = w[..., -1] - _dot(w[..., :-1], key.lwe_key, p)
    if p.torus_bits == 32:
        ph = (ph & np.uint64(_MASK32)).astype(np.float64) / p.delta
        return np.where(ph >= p.slots / 2, ph - p.slots, ph)
    # uint64 -> signed, then to float64 (the noise's low bits do not matter
    # at this scale: delta is 2^59 at 64 bits)
    return ph.view(np.int64).astype(np.float64) / p.delta


def trivial_contents(params: Params, contents) -> np.ndarray:
    """Noiseless ciphertexts (zero mask) of equal-length strings."""
    m = byte_blocks(params, contents)
    ct = np.zeros(m.shape + (params.lwe_dimension + 1,), params.word)
    ct[..., -1] = (m * params.delta).astype(params.word)
    return ct


def round_bsk(params: Params, bsk: np.ndarray, bits) -> np.ndarray:
    """The bootstrap key with its mask (component < k) and body words
    rounded to the nearest multiple of 2^b, b = bits[0] / bits[1]: the
    low bits of every key word dropped.  The controls of ``correct`` run
    the program on such a key, at a precision below the one its
    configuration states."""
    g = np.array(bsk, dtype=np.uint64, copy=True)
    k = params.glwe_dimension
    for c in range(k + 1):
        b = bits[0] if c < k else bits[1]
        if b:
            unit = np.uint64(1) << np.uint64(b)
            with np.errstate(over="ignore"):
                g[:, :, c, :] = (g[:, :, c, :] + (unit >> np.uint64(1))) \
                    // unit * unit
    return g.astype(params.word)
