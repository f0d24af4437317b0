"""Carry keys from the JAX package (``fhe_regex_tpu``) into this one.

Both packages keep keys and ciphertexts as the same numpy arrays
(ciphertexts: uint32 [len, num_blocks, n+1], uint64 on a 64-bit torus), so
a conversion checks the parameter set and copies arrays.  Only ``.params`` (its name and fields),
the numpy arrays and the client key's generator seed are read, so this
module needs no import of jax or of the JAX package.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from fhe_regex_tpu_torch.crypto.csprng import Csprng
from fhe_regex_tpu_torch.crypto.keys import ClientKey, ServerKey
from fhe_regex_tpu_torch.params import Params, get_params


def _params_of(other) -> Params:
    """This package's parameter set of the same name, checked field by
    field against ``other``."""
    params = get_params(other.name)
    for f in dataclasses.fields(Params):
        mine, theirs = getattr(params, f.name), getattr(other, f.name)
        if mine != theirs:
            raise ValueError(f"parameter set {other.name!r} differs in "
                             f"{f.name}: {theirs!r} vs {mine!r} here")
    return params


def client_key_from_jax(ck) -> ClientKey:
    """JAX-package ClientKey -> this package's ClientKey.

    The encryption generator restarts from the source key's seed with the
    same backend, as ``crypto.keys.load_client_key`` does."""
    return ClientKey(params=_params_of(ck.params),
                     lwe_key=np.array(ck.lwe_key, copy=True),
                     glwe_key=np.array(ck.glwe_key, copy=True),
                     rng=Csprng(ck.rng.seed, backend=ck.rng.backend))


def server_key_from_jax(sk) -> ServerKey:
    """JAX-package ServerKey -> this package's ServerKey (bsk
    [n, (k+1)l, k+1, N] and ksk [kN, L, n+1], uint32 on a 32-bit torus and
    uint64 on a 64-bit one).  The arrays keep their bits: a key whose dtype
    does not match ``params.torus_bits`` raises instead of being cast."""
    params = _params_of(sk.params)
    k1 = params.glwe_dimension + 1
    N, n, l = params.polynomial_size, params.lwe_dimension, params.pbs_level
    dt = np.dtype(np.uint32 if params.torus_bits == 32 else np.uint64)
    for name in ("bsk", "ksk"):
        got = np.asarray(getattr(sk, name)).dtype
        if got != dt:
            raise ValueError(f"{name} is {got}, but {params.name} has a "
                             f"{params.torus_bits}-bit torus ({dt})")
    bsk = np.array(sk.bsk, copy=True)
    ksk = np.array(sk.ksk, copy=True)
    if bsk.shape != (n, k1 * l, k1, N):
        raise ValueError(f"bsk shape {bsk.shape} does not fit {params.name}")
    if ksk.shape != (params.glwe_key_dim, params.ks_level, n + 1):
        raise ValueError(f"ksk shape {ksk.shape} does not fit {params.name}")
    return ServerKey(params=params, bsk=bsk, ksk=ksk)
