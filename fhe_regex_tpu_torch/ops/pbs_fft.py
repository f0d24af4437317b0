"""FFT-formulation blind rotation in PyTorch: float64 negacyclic FFTs.

The twin of ``fhe_regex_tpu/ops/pbs_fft.py`` (backend ``fft``).  Each
CMUX step's external product runs in the spectral domain:

  R[X]/(X^N+1)  ~=  C[X]/(X^M - i),   M = N/2,
  a  ->  u_j = (a_j + i a_{j+M}) * t_j,   t_j = e^{+i pi j / N},

so one length-M complex FFT evaluates a polynomial at the M roots of
X^M = i, a negacyclic product is a pointwise product of spectra, and one
inverse FFT (times conj(t)) gives the coefficients back.

The GGSW key polynomials are split into signed balanced limbs of widths
``PLAN`` = (16, 8, 8), low to high (the JAX package's limb plan "mixed"),
and their spectra are computed once in float64 on the key's device,
where the JAX package rounds them to float32.  The rotation runs in
float64 (complex128) too: the largest per-limb value, 64 * 2^15 * N *
(k+1)l ~= 2^34.6 for a 16-bit limb at N = 2048, lies far inside the
53-bit mantissa, so every limb rounds to its exact integer.  The spectral
rotation of ``cuda-fused`` and ``cuda-bg`` (``csrc/blind_rotate.cu``)
reads a spectrum of its own plan, ``SPECTRAL_PLAN`` = (16, 16): in
float64 a 16-bit limb at weight 2^16 has the bound of one at 2^0, and two
limbs take two thirds of the inverse transforms and key reads of three.
Each limb is rounded to int64, scaled by its weight and the sum wrapped
mod 2^32: the backend is bit-identical to the exact ones (``torch``,
``cuda-fused``) and to the JAX ``fft`` on any limb plan that is exact in
float32 there ("8").  So the backend has one plan and one transform and
reads neither ``FHE_REGEX_FFT_LIMBS`` nor
``FHE_REGEX_FFT_TRANSFORM``; the JAX package's fold mod 2^32 before the
f32 rounding (``_round_mod32``), its limb-plan noise model and its
four-step ``matmul`` transform have no counterpart.

The transform is ``torch.fft.fft`` / ``ifft`` in natural order (the JAX
``xla`` transform): cuFFT on a CUDA device, pocketfft on the CPU.  The
backend has no kernel of its own: the contraction over the (k+1)l digit
rows is one batched complex128 matmul over the M frequencies, and the
rest are torch elementwise ops, run eagerly one CMUX step at a time.  It
has no multi-value rotation (``ops/mv.py``), as in the JAX package.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from fhe_regex_tpu_torch.ops.pbs import (F64, I64, init_accumulator,
                                         stage1_digits, wrap_i32)
from fhe_regex_tpu_torch.params import Params

C128 = torch.complex128

#: the limb widths of the key spectrum, low to high (JAX plan "mixed")
PLAN = (16, 8, 8)
#: the limb widths of the spectral rotation's key spectrum, low to high
SPECTRAL_PLAN = (16, 16)


# ---------------- key preparation ----------------


def plan_weights(plan: tuple) -> tuple:
    """Cumulative bit weights of each limb in the plan."""
    w, out = 0, []
    for bits in plan:
        out.append(w)
        w += bits
    assert w == 32, f"limb plan {plan} must sum to 32 bits"
    return tuple(out)


def _limbs_signed(x: torch.Tensor, plan: tuple) -> torch.Tensor:
    """int32 torus values -> len(plan) balanced signed int64 limbs (new
    leading axis), limb lb holding `plan[lb]` bits at weight
    2^plan_weights[lb].

    Limbs lie in [-2^(bits-1), 2^(bits-1)]; the final +-1 carry has weight
    2^32 and vanishes mod 2^32.
    """
    v = x.to(I64)
    out = []
    for bits in plan:
        half = 1 << (bits - 1)
        mask = (1 << bits) - 1
        d = ((v + half) & mask) - half
        out.append(d)
        v = (v - d) >> bits
    assert bool((v.abs() <= 1).all()), "limb decomposition out of range"
    return torch.stack(out)


def _twist(N: int) -> np.ndarray:
    M = N // 2
    return np.exp(1j * np.pi * np.arange(M) / N)


def negacyclic_fft(a: torch.Tensor) -> torch.Tensor:
    """[..., N] float64 -> [..., M] complex128 negacyclic spectrum, by
    ``torch.fft`` on a's device."""
    N = a.shape[-1]
    M = N // 2
    t = torch.from_numpy(_twist(N)).to(a.device)
    return torch.fft.fft(torch.complex(a[..., :M], a[..., M:]) * t, dim=-1)


def prepare_bsk_fft(params: Params, bsk, device=None, chunk: int = 128,
                    plan: tuple = PLAN) -> torch.Tensor:
    """bsk [n, (k+1)l, k+1, N] (a uint32 array or an int32 tensor) ->
    spectral key [n, (k+1)l, k+1, L, M] complex128, L = len(plan), on
    ``device`` (default: the tensor's own, a host array's the CPU).

    The limbs of ``plan`` and their float64 spectra (cuFFT on a card), not
    rounded to float32 as the JAX package rounds them, ``chunk`` steps at a
    time.  With ``PLAN``, the spectrum of ``fft``'s key; with
    ``SPECTRAL_PLAN``, that of ``cuda-fused``'s and ``cuda-bg``'s spectral
    rotation.  Row order along axis 1 is (component, level), the most
    significant gadget digit first, as ``stage1_digits`` gives the digits.
    """
    if not isinstance(bsk, torch.Tensor):
        bsk = torch.from_numpy(np.ascontiguousarray(bsk).view(np.int32))
    if device is not None:
        bsk = bsk.to(device)
    n, rows, k1, N = bsk.shape
    out = torch.empty((n, rows, k1, len(plan), N // 2), dtype=C128,
                      device=bsk.device)
    for i0 in range(0, n, chunk):
        limbs = _limbs_signed(bsk[i0:i0 + chunk], plan).to(F64)
        out[i0:i0 + chunk] = negacyclic_fft(limbs).movedim(0, 3)
    return out


# ---------------- blind rotation ----------------


@functools.lru_cache(maxsize=None)
def _device_consts(N: int, device: torch.device):
    """(twist, its conjugate, [L, 1] limb weights) on ``device``, made once:
    a host-to-device copy inside a CUDA graph capture would break it."""
    tw = torch.from_numpy(_twist(N)).to(device)
    tw_conj = torch.conj(tw).resolve_conj()     # not a lazy view each step
    weights = torch.tensor([1 << w for w in plan_weights(PLAN)], dtype=I64,
                           device=device)[:, None]
    return tw, tw_conj, weights


def blind_rotate_fft(params: Params, bsk_spec: torch.Tensor,
                     luts: torch.Tensor, lut_idx: torch.Tensor,
                     cts_ms: torch.Tensor) -> torch.Tensor:
    """[B, n+1] mod-switched cts -> [B, k+1, N] int32 accumulators through
    the spectral key ``bsk_spec`` of ``prepare_bsk_fft``, one Python loop
    over the n CMUX steps.  Each step: the digits of ``stage1_digits``,
    twisted and forward transformed; their spectra contracted with the
    key's as one batched matmul [M, B, rows] x [M, rows, (k+1)L]; inverse
    transform and untwist; each limb rounded to int64, scaled by 2^weight,
    summed and added to the accumulator mod 2^32."""
    k1, N, n = (params.glwe_dimension + 1, params.polynomial_size,
                params.lwe_dimension)
    M, L = N // 2, len(PLAN)
    B = cts_ms.shape[0]
    rows = k1 * params.pbs_level
    expect = (n, rows, k1, L, M)
    if tuple(bsk_spec.shape) != expect or bsk_spec.dtype != C128:
        raise ValueError(f"spectral key {tuple(bsk_spec.shape)} "
                         f"{bsk_spec.dtype}, want {expect} complex128 for "
                         f"{params.name}")
    tw, tw_conj, weights = _device_consts(N, cts_ms.device)
    acc = init_accumulator(params, luts, lut_idx, cts_ms)
    for i in range(n):
        d = stage1_digits(params, acc, cts_ms[:, i])            # [B, rows, N]
        u = torch.complex(d[..., :M].to(F64), d[..., M:].to(F64)) * tw
        spec = torch.fft.fft(u, dim=-1).permute(2, 0, 1)        # [M, B, rows]
        key = bsk_spec[i].reshape(rows, k1 * L, M).permute(2, 0, 1)
        prod = torch.matmul(spec, key).permute(1, 2, 0)         # [B, k1 L, M]
        v = torch.fft.ifft(prod, dim=-1) * tw_conj
        vals = torch.cat([v.real, v.imag], dim=-1).reshape(B, k1, L, N)
        out = (torch.round(vals).to(I64) * weights).sum(dim=2)  # [B, k1, N]
        acc = wrap_i32(acc.to(I64) + out)
    return acc


# ---------------- the spectral rotation's tables ----------------


def spectral_tables(N: int, device="cpu") -> torch.Tensor:
    """[2, M] complex128: the twist t_j = e^{i pi j / N} and the transform's
    twiddles w_k = e^{-2 pi i k / M}, the two tables that ``cuda-fused``'s
    spectral rotation (``csrc/blind_rotate.cu``) reads."""
    M = N // 2
    w = np.exp(-2j * np.pi * np.arange(M) / M)
    return torch.from_numpy(np.stack([_twist(N), w])).to(device)
