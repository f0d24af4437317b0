"""Batched programmable bootstrapping in PyTorch (exact 32-bit torus).

The PyTorch twin of ``fhe_regex_tpu/ops/pbs.py``: the executor batches every
PBS instance of a circuit level into one call, and each call runs

    mod switch -> blind rotation -> sample extract -> keyswitch.

Every function takes and returns ``int32`` tensors whose bits are the uint32
torus values, in the JAX package's shapes:

  cts      [B, n+1]               batch of LWE ciphertexts [a_0..a_{n-1}, b]
  bsk      [n, (k+1)*l, k+1, N]   bootstrap key (GGSW per secret bit)
  ksk      [kN, ks_level, n+1]    keyswitch key
  luts     [L, N]                 stacked test polynomials
  lut_idx  [B]                    which LUT each instance applies

PyTorch defines neither a logical right shift on int32 nor wraparound on
signed overflow, and has no integer matmul on CUDA.  So torus values are
widened to int64 for shifts and sums (``wrap_i32`` narrows them back mod
2^32), and the two contractions run as float64 matmuls, which are exact
here: every partial sum stays below 2^53 (bounds at ``blind_rotate`` and
``key_switch``).  The same code runs on CPU and GPU.

Two backends: ``torch`` is this plain path, on any device; ``cuda-fused``
runs the blind rotation as the hand-written CUDA kernel of
``ops/pbs_cuda.py`` and keeps the rest of the pipeline here.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from fhe_regex_tpu_torch.params import Params

I32 = torch.int32
I64 = torch.int64
F64 = torch.float64

_MASK32 = 0xFFFFFFFF
_HALF32 = 1 << 31


def wrap_i32(v: torch.Tensor) -> torch.Tensor:
    """int64 -> int32 with wraparound mod 2^32 (two's complement)."""
    return (((v + _HALF32) & _MASK32) - _HALF32).to(I32)


def _u32(v: torch.Tensor) -> torch.Tensor:
    """int32 torus bits -> int64 holding the uint32 value in [0, 2^32)."""
    return v.to(I64) & _MASK32


# ---------------- small exact helpers ----------------


def mod_switch(params: Params, cts: torch.Tensor) -> torch.Tensor:
    """[B, n+1] torus -> [B, n+1] values in [0, 2N).  Wraparound in the +half
    add contributes a multiple of 2N, so it vanishes mod 2N."""
    N = params.polynomial_size
    shift = params.torus_bits - (N.bit_length() - 1) - 1
    u = (_u32(cts) + (1 << (shift - 1))) & _MASK32
    return ((u >> shift) & (2 * N - 1)).to(I32)


def decompose(v: torch.Tensor, base_log: int, level: int,
              torus_bits: int = 32) -> torch.Tensor:
    """Balanced signed gadget decomposition of int32 torus values.

    Returns [level, ...] int32 digits in [-B/2, B/2]; digit j has weight
    q / B^(j+1) (most significant first).
    """
    B = 1 << base_log
    half = B // 2
    shift = torus_bits - base_log * level
    state = ((_u32(v) + (1 << (shift - 1))) & _MASK32) >> shift
    digits = []
    for _ in range(level):
        d = state & (B - 1)
        d = torch.where(d >= half, d - B, d)
        state = (state - d) >> base_log
        digits.append(d.to(I32))
    return torch.stack(digits[::-1])  # most significant first


def negacyclic_rotate_batch(polys: torch.Tensor, r: torch.Tensor) -> torch.Tensor:
    """X^{r_b} * polys[b] for each batch element.

    polys: [B, C, N] int32; r: [B] int32 in [0, 2N).  Returns [B, C, N].
    Coefficient m of X^r * p is p[(m - r) mod 2N] read from the doubled
    polynomial [p, -p].
    """
    B, C, N = polys.shape
    m = torch.arange(N, device=polys.device)
    s = (m[None, :] - r.to(I64)[:, None]) & (2 * N - 1)            # [B, N]
    vals = torch.gather(polys, 2, (s & (N - 1))[:, None, :].expand(B, C, N))
    return torch.where((s >= N)[:, None, :], wrap_i32(-vals.to(I64)), vals)


def _ext_product_matrix(ggsw: torch.Tensor) -> torch.Tensor:
    """GGSW [rows, k+1, N] int32 -> [rows*N, (k+1)*N] float64 matrix W with
    (d @ W)[c*N + m] = sum_r (d_r (*) ggsw[r, c])[m] mod X^N + 1:
    W[r*N + t, c*N + m] = [g, -g][(m - t) mod 2N] for g = ggsw[r, c]."""
    rows, k1, N = ggsw.shape
    gd = ggsw.to(F64)
    doubled = torch.cat([gd, -gd], dim=-1)                          # [rows, k1, 2N]
    ar = torch.arange(N, device=ggsw.device)
    idx = (ar[None, :] - ar[:, None]) & (2 * N - 1)                 # [t, m]
    r_i = torch.arange(rows, device=ggsw.device)[:, None, None, None]
    c_i = torch.arange(k1, device=ggsw.device)[None, None, :, None]
    return doubled[r_i, c_i, idx[None, :, None, :]].reshape(rows * N, k1 * N)


# ---------------- blind rotation (plain path) ----------------


def blind_rotate(params: Params, bsk: torch.Tensor, luts: torch.Tensor,
                 lut_idx: torch.Tensor, cts_ms: torch.Tensor) -> torch.Tensor:
    """[B, n+1] mod-switched cts -> [B, k+1, N] int32 accumulators.

    Each CMUX step's external product is one float64 matmul
    [B, (k+1)l*N] x [(k+1)l*N, (k+1)*N].  Digits are at most B/2 = 64 and
    the key entries are signed int32, so every sum is bounded by
    (k+1)*l*N * 64 * 2^31 = 12288 * 2^6 * 2^31 < 2^51 at the production set:
    exact in float64.
    """
    k, N, n, l = (params.glwe_dimension, params.polynomial_size,
                  params.lwe_dimension, params.pbs_level)
    k1 = k + 1
    B = cts_ms.shape[0]
    rows = k1 * l

    acc = torch.zeros((B, k1, N), dtype=I32, device=cts_ms.device)
    acc[:, k, :] = luts[lut_idx.to(I64)]
    # X^{-b~} * v
    acc = negacyclic_rotate_batch(acc, (2 * N - cts_ms[:, n]) & (2 * N - 1))
    for i in range(n):
        rotated = negacyclic_rotate_batch(acc, cts_ms[:, i])
        diff = rotated.to(I64) - acc.to(I64)
        digits = decompose(diff, params.pbs_base_log, l)           # [l, B, k1, N]
        d = digits.permute(1, 2, 0, 3).reshape(B, rows * N).to(F64)
        # out[b, c, :] = sum_r d[b, r, :] (*) bsk[i, r, c]
        out = torch.matmul(d, _ext_product_matrix(bsk[i]))
        acc = wrap_i32(acc.to(I64) + out.to(I64).reshape(B, k1, N))
    return acc


def sample_extract(params: Params, accs: torch.Tensor) -> torch.Tensor:
    """[B, k+1, N] -> [B, kN+1] big-LWE ciphertexts (coefficient 0)."""
    k = params.glwe_dimension
    mask = accs[:, :k, :]                                          # [B, k, N]
    first = mask[:, :, :1]
    rest = wrap_i32(-torch.flip(mask[:, :, 1:], dims=[-1]).to(I64))
    ext = torch.cat([first, rest], dim=-1).reshape(accs.shape[0], -1)
    body = accs[:, k, :1]
    return torch.cat([ext, body], dim=-1)


def prepare_ksk(ksk: torch.Tensor) -> torch.Tensor:
    """[kN, L, n+1] int32 -> [kN*L, n+1] float64 signed values, rows
    ordered (t, j) to match the keyswitch digit layout."""
    kN, L, n1 = ksk.shape
    return ksk.reshape(kN * L, n1).to(F64)


def key_switch(params: Params, ksk_f64: torch.Tensor,
               big: torch.Tensor) -> torch.Tensor:
    """[B, kN+1] -> [B, n+1] under the small LWE key.

    One float64 matmul [B, kN*L] x [kN*L, n+1] (``prepare_ksk``): digits
    are at most 4 and key entries signed int32, so every sum is bounded by
    kN*L * 4 * 2^31 < 2^47 at the production set: exact.
    """
    kN, n, L = params.glwe_key_dim, params.lwe_dimension, params.ks_level
    digits = decompose(big[:, :kN], params.ks_base_log, L)         # [L, B, kN]
    D = digits.permute(1, 2, 0).reshape(big.shape[0], kN * L).to(F64)
    acc = -torch.matmul(D, ksk_f64).to(I64)
    acc[:, n] += big[:, kN].to(I64)
    return wrap_i32(acc)


def pbs_batch(params: Params, bsk: torch.Tensor, ksk_f64: torch.Tensor,
              luts: torch.Tensor, lut_idx: torch.Tensor,
              cts: torch.Tensor) -> torch.Tensor:
    """Full batched PBS: [B, n+1] -> [B, n+1] (plain path)."""
    ms = mod_switch(params, cts)
    acc = blind_rotate(params, bsk, luts, lut_idx, ms)
    big = sample_extract(params, acc)
    return key_switch(params, ksk_f64, big)


# ---------------- backend selection ----------------


BACKENDS = ("torch", "cuda-fused")


class DeviceServerKey:
    """Server-key material uploaded to one device.

    ``bsk`` is the int32 bootstrap key [n, (k+1)l, k+1, N] (both backends
    read it as is); ``ksk`` the float64 keyswitch matrix of ``prepare_ksk``.
    """

    def __init__(self, params: Params, backend: str, device: torch.device,
                 bsk: torch.Tensor, ksk: torch.Tensor):
        self.params = params
        self.backend = backend
        self.device = device
        self.bsk = bsk
        self.ksk = ksk


def resolve_backend(backend: Optional[str],
                    device: "torch.device | str") -> str:
    """None -> ``cuda-fused`` on a CUDA device, ``torch`` elsewhere."""
    if backend is None:
        return "cuda-fused" if torch.device(device).type == "cuda" else "torch"
    if backend not in BACKENDS:
        raise ValueError(f"unknown backend {backend!r}; have {BACKENDS}")
    return backend


def prepare_server_key(params: Params, server_key,
                       device: "torch.device | str" = "cpu",
                       backend: Optional[str] = None) -> DeviceServerKey:
    if params.torus_bits != 32:
        raise ValueError("the PyTorch port supports 32-bit torus sets only")
    device = torch.device(device)
    backend = resolve_backend(backend, device)
    if backend == "cuda-fused" and device.type != "cuda":
        raise ValueError("backend 'cuda-fused' needs a CUDA device")
    bsk = torch.from_numpy(
        np.ascontiguousarray(server_key.bsk).view(np.int32)).to(device)
    ksk = torch.from_numpy(
        np.ascontiguousarray(server_key.ksk).view(np.int32)).to(device)
    return DeviceServerKey(params, backend, device, bsk, prepare_ksk(ksk))


def make_pbs_core(dev_key: DeviceServerKey):
    """Callable (luts, lut_idx, cts) -> cts_out for the prepared key."""
    params = dev_key.params
    if dev_key.backend == "torch":
        def core(luts, lut_idx, cts):
            return pbs_batch(params, dev_key.bsk, dev_key.ksk, luts, lut_idx,
                             cts)
        return core
    if dev_key.backend == "cuda-fused":
        from fhe_regex_tpu_torch.ops.pbs_cuda import blind_rotate_fused

        def core(luts, lut_idx, cts):
            ms = mod_switch(params, cts)
            acc = blind_rotate_fused(params, dev_key.bsk, luts, lut_idx, ms)
            return key_switch(params, dev_key.ksk,
                              sample_extract(params, acc))
        return core
    raise ValueError(dev_key.backend)
