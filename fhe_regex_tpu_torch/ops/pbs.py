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

Backends, named after the JAX package's:

  32-bit torus  ``torch``      this plain path, on any device (JAX ``jnp``)
                ``cuda-fused`` the CUDA blind rotation of ``ops/pbs_cuda.py``
                               (JAX ``pallas-fused``)
                ``cuda-bg``    the same over batch blocks (``pallas-bg``)
                ``cuda``       one CUDA launch per CMUX stage, the step
                               loop in Python (``pallas``)
                ``fft``        the float64 FFT formulation of
                               ``ops/pbs_fft.py``, on any device (``fft``;
                               classic plan only, no multi-value rotation)
  64-bit torus  ``torch64``    the plain path of ``ops/pbs64.py`` (``jnp64``)
                ``cuda64``     the CUDA 64-bit blind rotation (``pallas64``)
                ``cuda64-bg``  the same over batch blocks, on the key rounded
                               by ``default_drop64`` (``pallas64-bg``)

The CUDA backends run only the blind rotation as a kernel and keep the
rest of the pipeline in PyTorch; ``fft`` keeps the exact keyswitch.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from fhe_regex_tpu_torch.ops import pbs64
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


def stage1_digits(params: Params, acc: torch.Tensor,
                  a: torch.Tensor) -> torch.Tensor:
    """One CMUX step's digits: acc [B, k+1, N] int32, a [B] int32 in
    [0, 2N) -> [B, (k+1)l, N] int8, the balanced digits of
    X^{a_b} * acc[b] - acc[b], rows in (component, level) order with the
    most significant digit first (the plain ``_stage1_kernel``)."""
    B, k1, N = acc.shape
    l = params.pbs_level
    rotated = negacyclic_rotate_batch(acc, a)
    diff = rotated.to(I64) - acc.to(I64)
    digits = decompose(diff, params.pbs_base_log, l)               # [l, B, k1, N]
    return digits.permute(1, 2, 0, 3).reshape(B, k1 * l, N).to(torch.int8)


def external_product_step(params: Params, digits: torch.Tensor,
                          ggsw_i: torch.Tensor,
                          acc: torch.Tensor) -> torch.Tensor:
    """acc + sum_r digits[:, r] (*) ggsw_i[r, c] mod X^N + 1, mod 2^32:
    digits [B, (k+1)l, N] int8, ggsw_i [(k+1)l, k+1, N] int32, acc
    [B, k+1, N] int32 -> [B, k+1, N] int32 (the plain
    ``_ext_product_kernel``).

    One float64 matmul [B, (k+1)l*N] x [(k+1)l*N, (k+1)*N].  Digits are at
    most B/2 = 64 and the key entries are signed int32, so every sum is
    bounded by (k+1)*l*N * 64 * 2^31 = 12288 * 2^6 * 2^31 < 2^51 at the
    production set: exact in float64.
    """
    B, k1, N = acc.shape
    d = digits.reshape(B, -1).to(F64)
    out = torch.matmul(d, _ext_product_matrix(ggsw_i))
    return wrap_i32(acc.to(I64) + out.to(I64).reshape(B, k1, N))


def init_accumulator(params: Params, luts: torch.Tensor,
                     lut_idx: torch.Tensor,
                     cts_ms: torch.Tensor) -> torch.Tensor:
    """acc0 [B, k+1, N] = (0, X^{-b~} * luts[lut_idx]) for [B, n+1]
    mod-switched cts."""
    k, N, n = (params.glwe_dimension, params.polynomial_size,
               params.lwe_dimension)
    acc = torch.zeros((cts_ms.shape[0], k + 1, N), dtype=I32,
                      device=cts_ms.device)
    acc[:, k, :] = luts[lut_idx.to(I64)]
    return negacyclic_rotate_batch(acc, (2 * N - cts_ms[:, n]) & (2 * N - 1))


def blind_rotate(params: Params, bsk: torch.Tensor, luts: torch.Tensor,
                 lut_idx: torch.Tensor, cts_ms: torch.Tensor) -> torch.Tensor:
    """[B, n+1] mod-switched cts -> [B, k+1, N] int32 accumulators: n CMUX
    steps of ``stage1_digits`` then ``external_product_step``."""
    acc = init_accumulator(params, luts, lut_idx, cts_ms)
    for i in range(params.lwe_dimension):
        digits = stage1_digits(params, acc, cts_ms[:, i])
        acc = external_product_step(params, digits, bsk[i], acc)
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


# ---------------- backend selection ----------------


BACKENDS32 = ("torch", "cuda-fused", "cuda-bg", "cuda", "fft")
BACKENDS64 = ("torch64", "cuda64", "cuda64-bg")
BACKENDS = BACKENDS32 + BACKENDS64
CUDA_BACKENDS = ("cuda-fused", "cuda-bg", "cuda", "cuda64", "cuda64-bg")


class DeviceServerKey:
    """Server-key material uploaded to one device.

    ``bsk`` is the bootstrap key [n, (k+1)l, k+1, N], int32 at 32 bits and
    int64 at 64 bits (for ``cuda64-bg`` rounded by ``drop64``, see
    ``pbs64.round_bsk64``); ``ksk`` the float64 keyswitch matrix of
    ``prepare_ksk`` / ``pbs64.prepare_ksk64``.  For ``fft``, ``bsk`` is
    the key's complex128 spectrum (``pbs_fft.prepare_bsk_fft``).  ``spec``
    is the key's spectrum on ``pbs_fft.SPECTRAL_PLAN``, beside the key, for
    ``cuda-fused`` and ``cuda-bg`` where their spectral rotation takes the
    set (``pbs_cuda.spectral_supported``), else None.
    """

    def __init__(self, params: Params, backend: str, device: torch.device,
                 bsk: torch.Tensor, ksk: torch.Tensor,
                 drop64: tuple = (0, 0), spec: "torch.Tensor | None" = None):
        self.params = params
        self.backend = backend
        self.device = device
        self.bsk = bsk
        self.ksk = ksk
        self.drop64 = drop64
        self.spec = spec


def resolve_backend(backend: Optional[str],
                    device: "torch.device | str",
                    params: Optional[Params] = None) -> str:
    """None -> the kernel backend on a CUDA device (``cuda64-bg`` at 64
    bits, ``cuda-fused`` at 32), the plain one elsewhere.  With ``params``,
    a backend of the other torus width raises ValueError."""
    wide = params is not None and params.torus_bits == 64
    if backend is None:
        on_cuda = torch.device(device).type == "cuda"
        if wide:
            return "cuda64-bg" if on_cuda else "torch64"
        return "cuda-fused" if on_cuda else "torch"
    if backend not in BACKENDS:
        raise ValueError(f"unknown backend {backend!r}; have {BACKENDS}")
    if params is not None and wide != (backend in BACKENDS64):
        raise ValueError(f"backend {backend!r} needs a "
                         f"{64 if backend in BACKENDS64 else 32}-bit "
                         f"parameter set, not {params.name}")
    return backend


def prepare_server_key(params: Params, server_key,
                       device: "torch.device | str" = "cpu",
                       backend: Optional[str] = None) -> DeviceServerKey:
    device = torch.device(device)
    backend = resolve_backend(backend, device, params)
    if backend in CUDA_BACKENDS and device.type != "cuda":
        raise ValueError(f"backend {backend!r} needs a CUDA device")
    want = np.uint32 if params.torus_bits == 32 else np.uint64
    for name in ("bsk", "ksk"):
        got = np.asarray(getattr(server_key, name)).dtype
        if got != want:
            raise TypeError(f"{name} is {got}, expected {np.dtype(want)} "
                            f"for {params.name}")
    if params.torus_bits == 32:
        ksk = torch.from_numpy(
            np.ascontiguousarray(server_key.ksk).view(np.int32)).to(device)
        from fhe_regex_tpu_torch.ops import pbs_cuda, pbs_fft

        bsk = torch.from_numpy(
            np.ascontiguousarray(server_key.bsk).view(np.int32)).to(device)
        spec = None
        if backend == "fft":
            bsk = pbs_fft.prepare_bsk_fft(params, bsk)
        elif (backend in ("cuda-fused", "cuda-bg")
              and pbs_cuda.spectral_supported(params)):
            spec = pbs_fft.prepare_bsk_fft(params, bsk,
                                           plan=pbs_fft.SPECTRAL_PLAN)
        return DeviceServerKey(params, backend, device, bsk, prepare_ksk(ksk),
                               spec=spec)
    drop = (0, 0)
    bsk = server_key.bsk
    if backend == "cuda64-bg":
        drop = pbs64.default_drop64(params)
        pbs64._gate_drop64(params, drop)
        bsk = pbs64.round_bsk64(params, bsk, drop)
    return DeviceServerKey(
        params, backend, device, pbs64.to_torch64(bsk).to(device),
        pbs64.prepare_ksk64(pbs64.to_torch64(server_key.ksk).to(device)),
        tuple(drop))


def rotation_fn(dev_key: DeviceServerKey):
    """The blind rotation of the key's backend on its bootstrap key,
    (luts, lut_idx, cts_ms) -> accumulators: the plain one, or a kernel
    wrapper of ``ops/pbs_cuda.py``.  ``cuda64-bg`` gets the key's
    ``drop64``, the drop its key was rounded by; ``fft`` runs on its
    spectral key; ``cuda-fused`` and ``cuda-bg`` get the key's ``spec``."""
    from fhe_regex_tpu_torch.ops import pbs_cuda, pbs_fft

    rotations = {
        "torch": blind_rotate,
        "fft": pbs_fft.blind_rotate_fft,
        "cuda-fused": pbs_cuda.blind_rotate_fused,
        "cuda-bg": pbs_cuda.blind_rotate_fused_bg,
        "cuda": pbs_cuda.blind_rotate_steps,
        "torch64": pbs64.blind_rotate64,
        "cuda64": pbs_cuda.blind_rotate_fused64,
        "cuda64-bg": pbs_cuda.blind_rotate_fused64_bg,
    }
    backend, params, bsk = dev_key.backend, dev_key.params, dev_key.bsk
    if backend not in rotations:
        raise ValueError(backend)
    rotate = rotations[backend]
    kw = {}
    if backend == "cuda64-bg":
        kw = {"drop": tuple(dev_key.drop64)}
    elif backend in ("cuda-fused", "cuda-bg"):
        kw = {"spec": dev_key.spec}
    return lambda luts, lut_idx, cts_ms: rotate(params, bsk, luts, lut_idx,
                                                cts_ms, **kw)


def make_pbs_core(dev_key: DeviceServerKey):
    """Callable (luts, lut_idx, cts) -> cts_out for the prepared key: mod
    switch, the backend's blind rotation, sample extract, keyswitch."""
    params = dev_key.params
    rotate = rotation_fn(dev_key)
    if params.torus_bits == 32:
        def core(luts, lut_idx, cts):
            acc = rotate(luts, lut_idx, mod_switch(params, cts))
            return key_switch(params, dev_key.ksk,
                              sample_extract(params, acc))
        return core

    def core64(luts, lut_idx, cts):
        acc = rotate(luts, lut_idx, pbs64.mod_switch64(params, cts))
        return pbs64.key_switch64(params, dev_key.ksk,
                                  pbs64.sample_extract64(params, acc))
    return core64
