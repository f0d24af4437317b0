"""Key structures, keygen, and serialization.

TPU-native equivalent of ``gen_keys`` (reference src/regex/ciphertext.rs:42-45
-> tfhe ``gen_keys_radix``, SURVEY.md N2): returns a client key (secret; used
host-side for encrypt/decrypt) and a server key (public evaluation material:
bootstrap + keyswitch keys, shipped to device HBM).

Serialization mirrors the reference's bincode key fixture
(src/regex/engine.rs:238-254, test_data/client_key): NumPy ``.npz`` with the
same role — generate once, reuse across test processes.
"""

from __future__ import annotations

import dataclasses
from pathlib import Path
from typing import Optional, Tuple

import numpy as np

from fhe_regex_tpu_torch.crypto.csprng import Csprng
from fhe_regex_tpu_torch.crypto.glwe import (
    flatten_glwe_key,
    gen_bootstrap_key,
    gen_keyswitch_key,
)
from fhe_regex_tpu_torch.params import Params, get_params


@dataclasses.dataclass
class ClientKey:
    params: Params
    lwe_key: np.ndarray           # [n] binary
    glwe_key: np.ndarray          # [k, N] binary
    rng: Csprng                   # encryption randomness

    @property
    def big_key(self) -> np.ndarray:
        return flatten_glwe_key(self.glwe_key)


@dataclasses.dataclass
class ServerKey:
    params: Params
    bsk: np.ndarray               # [n, (k+1)*l, k+1, N] uint32
    ksk: np.ndarray               # [kN, ks_level, n+1] uint32


def gen_keys(params: Optional[Params] = None,
             seed: Optional[int] = None) -> Tuple[ClientKey, ServerKey]:
    from fhe_regex_tpu_torch.params import warn_if_unsafe

    params = params or get_params()
    warn_if_unsafe(params, "gen_keys")
    rng = Csprng(seed)
    lwe_key = rng.binary(params.lwe_dimension)
    glwe_key = rng.binary((params.glwe_dimension, params.polynomial_size))
    client = ClientKey(params=params, lwe_key=lwe_key, glwe_key=glwe_key, rng=rng)
    bsk = gen_bootstrap_key(params, lwe_key, glwe_key, rng)
    ksk = gen_keyswitch_key(params, client.big_key, lwe_key, rng)
    server = ServerKey(params=params, bsk=bsk, ksk=ksk)
    return client, server


def server_key_from_client(client: ClientKey) -> ServerKey:
    """Derive the server key from a client key (reference engine.rs:252)."""
    params = client.params
    bsk = gen_bootstrap_key(params, client.lwe_key, client.glwe_key, client.rng)
    ksk = gen_keyswitch_key(params, client.big_key, client.lwe_key, client.rng)
    return ServerKey(params=params, bsk=bsk, ksk=ksk)


def save_client_key(path, client: ClientKey) -> None:
    np.savez_compressed(
        Path(path),
        params_name=np.array(client.params.name),
        lwe_key=client.lwe_key,
        glwe_key=client.glwe_key,
        seed=np.array(str(client.rng.seed)),
    )


def load_client_key(path) -> ClientKey:
    with np.load(Path(path), allow_pickle=False) as z:
        params = get_params(str(z["params_name"]))
        return ClientKey(
            params=params,
            lwe_key=z["lwe_key"],
            glwe_key=z["glwe_key"],
            rng=Csprng(int(str(z["seed"]))),
        )
