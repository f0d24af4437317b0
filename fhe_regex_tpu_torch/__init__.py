"""fhe-regex-tpu-torch: encrypted regex matching on PyTorch and CUDA.

The PyTorch port of ``fhe_regex_tpu``, with the same public surface for the
main path: ``gen_keys -> encrypt_str -> has_match -> decrypt``.  The result
of ``has_match`` is an encrypted 0/1 only the client key opens.  Device
work runs on the ``device`` given (default: CUDA when present, else CPU);
on CUDA the blind rotation is a hand-written kernel of ``ops/pbs_cuda.py``.
Both torus widths run: 32 bits (``TPU_MESSAGE_2_CARRY_2``, the default) and
64 bits (``TPU64_MESSAGE_2_CARRY_2``), where ciphertexts are uint64.
"""

from __future__ import annotations

import logging
from typing import Optional

import numpy as np
import torch

from fhe_regex_tpu_torch.params import Params, get_params
from fhe_regex_tpu_torch.crypto.keys import (
    ClientKey,
    ServerKey,
    gen_keys,
    load_client_key,
    save_client_key,
    server_key_from_client,
)
from fhe_regex_tpu_torch.crypto import lwe as _lwe
from fhe_regex_tpu_torch.regex.circuit import CircuitBuilder, Node
from fhe_regex_tpu_torch.regex.engine import BranchBudgetExceeded, compile_match
from fhe_regex_tpu_torch.regex.executor import (CompiledCircuit, Executor,
                                                compile_circuit,
                                                default_min_bucket)
from fhe_regex_tpu_torch.ops.pbs import prepare_server_key, resolve_backend

__all__ = [
    "Params",
    "get_params",
    "ClientKey",
    "ServerKey",
    "gen_keys",
    "server_key_from_client",
    "save_client_key",
    "load_client_key",
    "encrypt_str",
    "trivial_encrypt_str",
    "has_match",
    "decrypt",
    "compile_match",
    "BranchBudgetExceeded",
    "compile_circuit",
    "CompiledCircuit",
    "Executor",
    "CircuitBuilder",
    "Node",
    "executor_for",
]

logger = logging.getLogger("fhe_regex_tpu_torch")


def _default_device() -> torch.device:
    return torch.device("cuda" if torch.cuda.is_available() else "cpu")


def encrypt_str(client_key: ClientKey, s: str) -> np.ndarray:
    """ASCII string -> [len, num_blocks, n+1] uint32 (ciphertext.rs:32-40)."""
    if not s.isascii():
        raise ValueError("content contains non-ascii characters")
    p = client_key.params
    if not s:
        return np.zeros((0, p.num_blocks, p.lwe_dimension + 1), np.uint32)
    return np.stack(
        [_lwe.encrypt_byte(p, client_key.lwe_key, b, client_key.rng)
         for b in s.encode("ascii")]
    )


def trivial_encrypt_str(params: Params, s: str) -> np.ndarray:
    """Noiseless content encoding — the reference's test fast path
    (create_trivial_radix per byte, engine.rs:282-286)."""
    if not s.isascii():
        raise ValueError("content contains non-ascii characters")
    if not s:
        return np.zeros((0, params.num_blocks, params.lwe_dimension + 1), np.uint32)
    return np.stack([_lwe.trivial_byte(params, b) for b in s.encode("ascii")])


def executor_for(server_key: ServerKey, backend: Optional[str] = None,
                 device: "torch.device | str | None" = None) -> Executor:
    """A (cached) Executor bound to this server key's material on `device`.

    Executors are cached on the key per (backend, device), so repeated
    calls reuse the device upload.  Run a custom circuit with
    ``executor.run(compile_circuit(params, builder, root), ct_content)``.
    """
    from fhe_regex_tpu_torch.params import warn_if_unsafe

    warn_if_unsafe(server_key.params, "executor_for")
    device = torch.device(device) if device is not None else _default_device()
    backend = resolve_backend(backend, device, server_key.params)
    cache = server_key.__dict__.setdefault("_torch_executors", {})
    key = (backend, str(device))
    if key not in cache:
        dev_key = prepare_server_key(server_key.params, server_key, device,
                                     backend)
        cache[key] = Executor(server_key.params, dev_key)
    return cache[key]


def has_match(server_key: ServerKey, ct_content: np.ndarray, pattern: str,
              backend: Optional[str] = None,
              fold: str = "reference",
              branch_budget: Optional[int] = None,
              device: "torch.device | str | None" = None) -> np.ndarray:
    """Encrypted match: does `pattern` match the encrypted content?

    Mirrors ``engine::has_match`` (engine.rs:8-42): returns a radix
    ciphertext encrypting 1 (match) or 0 (no match), uint32 or uint64 by
    the torus width.  ``backend`` selects the blind rotation ('torch' /
    'torch64' plain paths, 'cuda-fused' / 'cuda64' / 'cuda64-bg' kernels,
    None = the width's default kernel on CUDA devices, see
    ``ops.pbs.resolve_backend``); ``fold='tree'`` replaces the reference's
    sequential OR fold with a log-depth tree (same decrypted result, far
    lower latency); ``branch_budget`` bounds variant expansion with a clean
    BranchBudgetExceeded.
    """
    params = server_key.params
    builder, root = compile_match(len(ct_content), pattern,
                                  num_blocks=params.num_blocks, fold=fold,
                                  branch_budget=branch_budget)
    circuit = compile_circuit(params, builder, root,
                              min_bucket=default_min_bucket())
    executor = executor_for(server_key, backend, device)
    result = executor.run(circuit, np.ascontiguousarray(ct_content))
    logger.info(
        "%d ciphertext operations, %d cache hits (%d bootstraps in %d levels)",
        circuit.ct_ops, circuit.cache_hits, circuit.pbs_count, len(circuit.levels),
    )
    return result


def decrypt(client_key: ClientKey, ct_res: np.ndarray) -> int:
    """Radix decrypt of the match result (mod.rs:17)."""
    return _lwe.decrypt_byte(client_key.params, client_key.lwe_key, ct_res)
