"""Parser for the reference's ground-truth key fixture.

The reference repo ships exactly one tfhe-rs artifact:
``test_data/client_key`` — a bincode-1.3 serialized ``RadixClientKey``
written by ``gen_keys`` (reference src/regex/engine.rs:238-254; the fixture
is (re)generated by ``generate_test_keys`` at engine.rs:236-246 and loaded by
``setup_test`` at engine.rs:248-254).  Until round 4 our
``REF_MESSAGE_2_CARRY_2_64`` parameter pins (params.py) were taken from
public tfhe-rs 0.2 documentation-era tables; this module closes SURVEY.md
N1's "re-verify against the pin 13ad7d5…" promise by extracting the values
from the fixture itself, and recovers the reference's actual secret keys so
the conformance vectors can run under them end-to-end.

Bincode 1.3 default layout (little-endian, fixed-width integers, u64 length
prefixes on Vec/String) makes the file fully recoverable from the struct
shape.  tfhe-rs 0.2's nesting is::

    RadixClientKey {
        key: integer::ClientKey {
            key: shortint::ClientKey {
                lwe_secret_key:          LweSecretKey  { data: Vec<u64> },  # big key, k*N
                glwe_secret_key:         GlweSecretKey { data: Vec<u64>,
                                                         polynomial_size: u64 },
                lwe_secret_key_after_ks: LweSecretKey  { data: Vec<u64> },  # small key, n
                parameters: Parameters {                      # 16 x 8 bytes
                    lwe_dimension, glwe_dimension, polynomial_size: u64,
                    lwe_modular_std_dev, glwe_modular_std_dev: f64,
                    pbs_base_log, pbs_level, ks_base_log, ks_level,
                    pfks_level, pfks_base_log: u64,
                    pfks_modular_std_dev: f64,
                    cbs_level, cbs_base_log,
                    message_modulus, carry_modulus: u64,
                },
            },
        },
        num_blocks: u64,
    }

Size check (our fixture): (8 + 2048*8) + (8 + 2048*8 + 8) + (8 + 742*8)
+ 16*8 + 8 = 38,872 bytes — exactly the file's length, so the layout above
is pinned by construction (any misparse would misalign the trailing
parameter block, whose values are independently known).

Byte-offset map for the shipped fixture (verified by tests):
  [0:8]           u64 = 2048           big-key length
  [8:16392]       2048 x u64 in {0,1}  big LWE secret key (== flattened GLWE key)
  [16392:16400]   u64 = 2048           GLWE data length (k*N)
  [16400:32784]   2048 x u64 in {0,1}  GLWE secret key
  [32784:32792]   u64 = 2048           polynomial_size
  [32792:32800]   u64 = 742            small-key length
  [32800:38736]   742 x u64 in {0,1}   small (post-keyswitch) LWE secret key
  [38736:38864]   Parameters           16 little-endian 8-byte fields
  [38864:38872]   u64 = 4              RadixClientKey.num_blocks
"""

from __future__ import annotations

import dataclasses
import struct
from pathlib import Path

import numpy as np

from fhe_regex_tpu_torch.params import Params, REF_MESSAGE_2_CARRY_2_64

#: Default location of the reference fixture in this environment.
REFERENCE_FIXTURE = Path("reference/test_data/client_key")


@dataclasses.dataclass(frozen=True)
class RefParameters:
    """tfhe-rs 0.2 ``shortint::Parameters``, verbatim from the fixture."""

    lwe_dimension: int
    glwe_dimension: int
    polynomial_size: int
    lwe_modular_std_dev: float     # relative: sigma / q
    glwe_modular_std_dev: float    # relative: sigma / q
    pbs_base_log: int
    pbs_level: int
    ks_base_log: int
    ks_level: int
    pfks_level: int
    pfks_base_log: int
    pfks_modular_std_dev: float
    cbs_level: int
    cbs_base_log: int
    message_modulus: int           # NB: tfhe-rs stores the modulus (4), not bits
    carry_modulus: int


@dataclasses.dataclass(frozen=True)
class RefClientKey:
    """Everything in the reference's ``RadixClientKey`` fixture."""

    big_lwe_key: np.ndarray        # [k*N] uint64 binary (pre-keyswitch key)
    glwe_key: np.ndarray           # [k, N] uint64 binary
    small_lwe_key: np.ndarray      # [n] uint64 binary (post-keyswitch key)
    parameters: RefParameters
    num_blocks: int


class _Reader:
    def __init__(self, buf: bytes):
        self.buf = buf
        self.pos = 0

    def u64(self) -> int:
        (v,) = struct.unpack_from("<Q", self.buf, self.pos)
        self.pos += 8
        return v

    def f64(self) -> float:
        (v,) = struct.unpack_from("<d", self.buf, self.pos)
        self.pos += 8
        return v

    def vec_u64(self) -> np.ndarray:
        n = self.u64()
        if self.pos + 8 * n > len(self.buf):
            raise ValueError(
                f"bincode Vec<u64> length {n} at offset {self.pos - 8} "
                f"overruns the {len(self.buf)}-byte buffer")
        out = np.frombuffer(self.buf, dtype="<u8", count=n, offset=self.pos)
        self.pos += 8 * n
        return out.copy()


def parse_radix_client_key(path=REFERENCE_FIXTURE) -> RefClientKey:
    """Parse a tfhe-rs 0.2 bincode ``RadixClientKey`` (engine.rs:250)."""
    buf = Path(path).read_bytes()
    r = _Reader(buf)

    big = r.vec_u64()
    glwe_data = r.vec_u64()
    poly_size = r.u64()
    if poly_size == 0 or len(glwe_data) % poly_size:
        raise ValueError(
            f"GLWE data length {len(glwe_data)} not a multiple of "
            f"polynomial_size {poly_size}")
    glwe = glwe_data.reshape(len(glwe_data) // poly_size, poly_size)
    small = r.vec_u64()

    p = RefParameters(
        lwe_dimension=r.u64(),
        glwe_dimension=r.u64(),
        polynomial_size=r.u64(),
        lwe_modular_std_dev=r.f64(),
        glwe_modular_std_dev=r.f64(),
        pbs_base_log=r.u64(),
        pbs_level=r.u64(),
        ks_base_log=r.u64(),
        ks_level=r.u64(),
        pfks_level=r.u64(),
        pfks_base_log=r.u64(),
        pfks_modular_std_dev=r.f64(),
        cbs_level=r.u64(),
        cbs_base_log=r.u64(),
        message_modulus=r.u64(),
        carry_modulus=r.u64(),
    )
    num_blocks = r.u64()
    if r.pos != len(buf):
        raise ValueError(
            f"trailing bytes after RadixClientKey: parsed {r.pos} of {len(buf)}")

    # structural sanity — all three keys binary, dims consistent with params
    for name, key in (("big", big), ("glwe", glwe), ("small", small)):
        bad = np.setdiff1d(np.unique(key), [0, 1])
        if bad.size:
            raise ValueError(f"{name} secret key not binary: values {bad[:8]}")
    if len(small) != p.lwe_dimension:
        raise ValueError(
            f"small key length {len(small)} != lwe_dimension {p.lwe_dimension}")
    if glwe.shape != (p.glwe_dimension, p.polynomial_size):
        raise ValueError(
            f"GLWE key shape {glwe.shape} != "
            f"({p.glwe_dimension}, {p.polynomial_size})")

    return RefClientKey(big_lwe_key=big, glwe_key=glwe, small_lwe_key=small,
                        parameters=p, num_blocks=num_blocks)


def params_from_fixture(ref: RefClientKey) -> Params:
    """Build a ``Params`` carrying the fixture's exact values (64-bit torus).

    By construction this should equal ``REF_MESSAGE_2_CARRY_2_64`` in every
    field (asserted by tests/test_refkey.py — the N1 re-verification).
    """
    p = ref.parameters
    q = 1 << 64
    return dataclasses.replace(
        REF_MESSAGE_2_CARRY_2_64,
        lwe_dimension=p.lwe_dimension,
        glwe_dimension=p.glwe_dimension,
        polynomial_size=p.polynomial_size,
        lwe_noise_std=p.lwe_modular_std_dev * q,
        glwe_noise_std=p.glwe_modular_std_dev * q,
        pbs_base_log=p.pbs_base_log,
        pbs_level=p.pbs_level,
        ks_base_log=p.ks_base_log,
        ks_level=p.ks_level,
        message_bits=int(p.message_modulus).bit_length() - 1,
        carry_bits=int(p.carry_modulus).bit_length() - 1,
        num_blocks=ref.num_blocks,
    )


def client_key_from_fixture(path=REFERENCE_FIXTURE, seed: "int | None" = 0):
    """Reconstruct our ``ClientKey`` around the reference's actual secrets.

    The secret keys (and therefore every encryption/decryption) are the
    reference's own; only the *server-side* evaluation material (bsk/ksk)
    is re-derived in our format — exactly what ``ServerKey::new(&client_key)``
    does in the reference (engine.rs:252).  ``seed`` feeds the CSPRNG used
    for fresh encryption randomness and server-key randomness.
    """
    from fhe_regex_tpu_torch.crypto.csprng import Csprng
    from fhe_regex_tpu_torch.crypto.keys import ClientKey

    ref = parse_radix_client_key(path)
    params = params_from_fixture(ref)
    return ClientKey(
        params=params,
        lwe_key=ref.small_lwe_key.astype(np.uint64),
        glwe_key=ref.glwe_key.astype(np.uint64),
        rng=Csprng(seed),
    ), ref
