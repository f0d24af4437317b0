"""Batched programmable bootstrapping on the 64-bit torus (PyTorch).

The PyTorch twin of ``fhe_regex_tpu/ops/pbs64.py``: the reference's own
torus width, run as

    mod switch -> blind rotation -> sample extract -> keyswitch.

A 64-bit torus value is an ``int64`` tensor holding the uint64 bits.  int64
``+``, ``-``, ``*`` and negation wrap mod 2^64 on CPU and CUDA, so the JAX
package's (lo, hi) int32 limb pairs and their carry arithmetic are not
needed here.  ``>>`` on int64 is arithmetic: a logical shift masks after
shifting (``_rounded_top``).  Shapes are the JAX package's:

  cts      [B, n+1]               int64 LWE ciphertexts [a_0..a_{n-1}, b]
  bsk      [n, (k+1)l, k+1, N]    int64 bootstrap key (GGSW per secret bit)
  ksk      [kN, ks_level, n+1]    int64 keyswitch key
  luts     [L, N]                 int64 test polynomials
  lut_idx  [B]                    int32, which LUT each instance applies

CUDA has no int64 matmul, so both contractions are float64 matmuls over
balanced limbs of the key, recombined in int64; the bounds that make them
exact are at ``blind_rotate64`` and ``key_switch64``.  The same code runs on
CPU and GPU.

Host helpers: the JAX package keeps 64-bit values on device as int32 limb
pairs; ``np_to_limbs`` / ``limbs_to_np`` (and ``split64_np`` /
``join64_np``) convert between those and uint64 numpy arrays.  The
bootstrap-key limb drop of the JAX ``pallas64-bg`` backend is host code
too: ``default_drop64``, ``_gate_drop64`` and ``round_bsk64``.
"""

from __future__ import annotations

import os
from typing import Tuple

import numpy as np
import torch

from fhe_regex_tpu_torch.params import MIN_SIGMA_MARGIN, Params

I32 = torch.int32
I64 = torch.int64
F64 = torch.float64


# ---------------- host conversions ----------------


def split64_np(x: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """uint64 host array -> (lo, hi) int32 arrays."""
    v = np.ascontiguousarray(x.astype(np.uint64))
    return ((v & 0xFFFFFFFF).astype(np.uint32).view(np.int32),
            (v >> np.uint64(32)).astype(np.uint32).view(np.int32))


def join64_np(lo: np.ndarray, hi: np.ndarray) -> np.ndarray:
    """(lo, hi) int32 host arrays -> uint64."""
    return (np.asarray(lo).view(np.uint32).astype(np.uint64)
            | (np.asarray(hi).view(np.uint32).astype(np.uint64) << np.uint64(32)))


def np_to_limbs(a: np.ndarray) -> np.ndarray:
    """uint64 -> int32 limb pairs [..., 2] (lo, hi), the JAX slab layout."""
    v = np.ascontiguousarray(a.astype(np.uint64))
    return v.view(np.int32).reshape(a.shape + (2,))


def limbs_to_np(a: np.ndarray) -> np.ndarray:
    """Inverse of ``np_to_limbs``."""
    return np.ascontiguousarray(a).view(np.uint64).reshape(a.shape[:-1])


def to_torch64(a: np.ndarray) -> torch.Tensor:
    """uint64 numpy -> int64 tensor with the same bits."""
    return torch.from_numpy(
        np.ascontiguousarray(a, dtype=np.uint64).view(np.int64))


# ---------------- small exact helpers ----------------


def _rounded_top(v: torch.Tensor, shift: int) -> torch.Tensor:
    """(V + 2^(shift-1)) >> shift as a logical shift of the uint64 bits V,
    for shift >= 33, so the result fits int32."""
    assert shift >= 33, "top-bit helpers need base_log*level <= 31"
    return ((v + (1 << (shift - 1))) >> shift) & ((1 << (64 - shift)) - 1)


def mod_switch64(params: Params, cts: torch.Tensor) -> torch.Tensor:
    """[B, n+1] int64 torus -> [B, n+1] int32 values in [0, 2N)."""
    N = params.polynomial_size
    shift = params.torus_bits - (N.bit_length() - 1) - 1
    return (_rounded_top(cts, shift) & (2 * N - 1)).to(I32)


def decompose64(v: torch.Tensor, base_log: int, level: int,
                torus_bits: int = 64) -> torch.Tensor:
    """Balanced gadget digits of int64 torus values, most significant first.

    Returns [level, ...] int32 digits in [-B/2, B/2]; needs
    base_log * level <= 31 (true for the PBS 23x1 and the keyswitch 3x5).
    """
    B = 1 << base_log
    half = B // 2
    state = _rounded_top(v, torus_bits - base_log * level)
    digits = []
    for _ in range(level):
        d = state & (B - 1)
        d = torch.where(d >= half, d - B, d)
        state = (state - d) >> base_log
        digits.append(d.to(I32))
    return torch.stack(digits[::-1])


def n_digit_limbs(base_log: int) -> int:
    """int8 limbs of a balanced base-2^base_log digit, as the JAX package
    splits it for its tensor-core kernels (3 at base_log = 23, 1 at 7)."""
    return (base_log + 7) // 8


def negacyclic_rotate_batch64(polys: torch.Tensor,
                              r: torch.Tensor) -> torch.Tensor:
    """X^{r_b} * polys[b]: polys [B, C, N] int64, r [B] in [0, 2N).

    Coefficient m of X^r * p is p[(m - r) mod 2N] read from [p, -p]."""
    B, C, N = polys.shape
    m = torch.arange(N, device=polys.device)
    s = (m[None, :] - r.to(I64)[:, None]) & (2 * N - 1)            # [B, N]
    vals = torch.gather(polys, 2, (s & (N - 1))[:, None, :].expand(B, C, N))
    return torch.where((s >= N)[:, None, :], -vals, vals)


def digit_limb_planes(digits: torch.Tensor, nd: int) -> torch.Tensor:
    """[B, rows, N] balanced digits -> [B, rows*nd, N] int8 planes, row r's
    limb dl at plane r*nd + dl, d = sum_dl 2^(8 dl) limb_dl: each limb is
    ((v + 128) & 255) - 128 (the low byte read as int8), then v = (v -
    limb) >> 8, as the kernels' ``stage1_64`` splits a digit and the JAX
    package's ``digit_limbs_i8`` does (3 limbs at base 2^23, the top one
    in [-64, 64])."""
    B, rows, N = digits.shape
    v, out = digits.to(I64), []
    for _ in range(nd):
        limb = ((v + 128) & 255) - 128
        out.append(limb)
        v = (v - limb) >> 8
    return torch.stack(out, 2).reshape(B, rows * nd, N).to(torch.int8)


def stage1_digits64(params: Params, acc: torch.Tensor,
                    a: torch.Tensor) -> torch.Tensor:
    """One CMUX step's digit limbs at 64 bits: acc [B, k+1, N] int64, a [B]
    int32 in [0, 2N) -> [B, (k+1)l * nd, N] int8 (nd = ``n_digit_limbs``),
    the balanced digits of X^{a_b} * acc[b] - acc[b] in (component, level)
    rows, most significant first, each split by ``digit_limb_planes`` (the
    plain ``stage1_64``)."""
    B, k1, N = acc.shape
    l = params.pbs_level
    diff = negacyclic_rotate_batch64(acc, a) - acc
    digits = decompose64(diff, params.pbs_base_log, l)             # [l, B, k1, N]
    digits = digits.permute(1, 2, 0, 3).reshape(B, k1 * l, N)
    return digit_limb_planes(digits, n_digit_limbs(params.pbs_base_log))


def _limbs16(g: torch.Tensor) -> torch.Tensor:
    """int64 -> [4, ...] float64 balanced 16-bit limbs in [-2^15, 2^15):
    g = sum_j limb_j * 2^(16j) mod 2^64."""
    limbs = []
    v = g
    for _ in range(4):
        d = ((v + (1 << 15)) & 0xFFFF) - (1 << 15)
        limbs.append(d)
        v = (v - d) >> 16
    return torch.stack(limbs).to(F64)


def _toeplitz(polys: torch.Tensor) -> torch.Tensor:
    """[P, N] float64 -> [P, N, N] with T[p, t, m] = [p, -p][(m - t) mod 2N],
    the negacyclic product matrix: (d @ T[p])[m] = (d (*) p)[m]."""
    N = polys.shape[-1]
    tripled = torch.cat([polys, -polys, polys], dim=-1)            # [P, 3N]
    win = tripled.unfold(-1, N, 1)          # win[p, s, m] = tripled[p, s + m]
    return win[:, N + 1:2 * N + 1].flip(1)  # row t is s = 2N - t


def _ext_product64(d: torch.Tensor, ggsw: torch.Tensor) -> torch.Tensor:
    """d [B, rows, N] float64 digits, ggsw [rows, k+1, N] int64 ->
    [B, k+1, N] int64 = sum_r d_r (*) ggsw[r, c] mod 2^64."""
    rows, k1, N = ggsw.shape
    B = d.shape[0]
    limbs = _limbs16(ggsw).transpose(0, 1)                     # [rows, 4, k1, N]
    T = _toeplitz(limbs.reshape(rows * 4 * k1, N)).view(rows, 4 * k1, N, N)
    p = torch.matmul(d[:, 0], T[0])                            # [4*k1, B, N]
    for r in range(1, rows):
        p = p + torch.matmul(d[:, r], T[r])
    p = p.to(I64).view(4, k1, B, N)
    out = p[0] + p[1] * (1 << 16) + p[2] * (1 << 32) + p[3] * (1 << 48)
    return out.transpose(0, 1)


# ---------------- blind rotation (plain path) ----------------


def blind_rotate64(params: Params, bsk: torch.Tensor, luts: torch.Tensor,
                   lut_idx: torch.Tensor, cts_ms: torch.Tensor) -> torch.Tensor:
    """[B, n+1] mod-switched cts -> [B, k+1, N] int64 accumulators.

    Each CMUX step's external product is float64 matmuls of the digits
    against the negacyclic matrices of four balanced 16-bit limbs of the
    GGSW, recombined in int64 at weights 2^(16j).  Digits satisfy
    |d| <= 2^(base_log-1) = 2^22 and limbs |l| <= 2^15, over (k+1)l*N =
    2*2048 = 2^12 terms at the production set, so every sum is at most
    2^12 * 2^22 * 2^15 = 2^49 < 2^53: exact in float64.
    """
    k, N, n, l = (params.glwe_dimension, params.polynomial_size,
                  params.lwe_dimension, params.pbs_level)
    k1 = k + 1
    B = cts_ms.shape[0]

    acc = torch.zeros((B, k1, N), dtype=I64, device=cts_ms.device)
    acc[:, k, :] = luts[lut_idx.to(I64)]
    acc = negacyclic_rotate_batch64(acc, (2 * N - cts_ms[:, n]) & (2 * N - 1))
    for i in range(n):
        rotated = negacyclic_rotate_batch64(acc, cts_ms[:, i])
        digits = decompose64(rotated - acc, params.pbs_base_log, l)  # [l, B, k1, N]
        d = digits.permute(1, 2, 0, 3).reshape(B, k1 * l, N).to(F64)
        acc = acc + _ext_product64(d, bsk[i])
    return acc


def sample_extract64(params: Params, accs: torch.Tensor) -> torch.Tensor:
    """[B, k+1, N] -> [B, kN+1] big-LWE ciphertexts (coefficient 0)."""
    k = params.glwe_dimension
    mask = accs[:, :k, :]
    rest = -torch.flip(mask[:, :, 1:], dims=[-1])
    ext = torch.cat([mask[:, :, :1], rest], dim=-1).reshape(accs.shape[0], -1)
    return torch.cat([ext, accs[:, k, :1]], dim=-1)


def prepare_ksk64(ksk: torch.Tensor) -> torch.Tensor:
    """[kN, L, n+1] int64 -> [kN*L, 2(n+1)] float64: the balanced low and
    high 32-bit limbs side by side, rows ordered (t, j) as the digits."""
    kN, L, n1 = ksk.shape
    v = ksk.reshape(kN * L, n1)
    lo = ((v + (1 << 31)) & 0xFFFFFFFF) - (1 << 31)
    return torch.cat([lo, (v - lo) >> 32], dim=1).to(F64)


def key_switch64(params: Params, ksk_f64: torch.Tensor,
                 big: torch.Tensor) -> torch.Tensor:
    """[B, kN+1] -> [B, n+1] under the small LWE key.

    One float64 matmul [B, kN*L] x [kN*L, 2(n+1)] (``prepare_ksk64``):
    digits |d| <= 4 and limbs |l| <= 2^31 over kN*L = 10240 terms at the
    production set, so every sum is below 2^13.4 * 2^2 * 2^31 < 2^47: exact.
    """
    kN, n, L = params.glwe_key_dim, params.lwe_dimension, params.ks_level
    digits = decompose64(big[:, :kN], params.ks_base_log, L)       # [L, B, kN]
    D = digits.permute(1, 2, 0).reshape(big.shape[0], kN * L).to(F64)
    p = torch.matmul(D, ksk_f64).to(I64)
    out = -(p[:, :n + 1] + p[:, n + 1:] * (1 << 32))
    out[:, n] += big[:, kN]
    return out


# ---------------- bootstrap-key limb drop (host) ----------------


# Largest ||u||^2 over the production LUT factors (the JAX package's
# ops/mv.py mv_weights; the gt/le combine factor): the default drop keeps
# this margin >= 5 sigma too, so one prepared key serves every engine path.
WORST_PRODUCTION_MV_NORM2 = 12


def default_drop64(params: Params) -> tuple:
    """Largest key-limb drop keeping (a) the classic >=5-sigma LUT margin
    AND p_fail <= 2^-40, and (b) >=5 sigma at the worst production
    multivalue factor norm.  (1, 2) at TPU64_MESSAGE_2_CARRY_2, (0, 0) on
    zero-noise sets; FHE_REGEX_DROP64=m,b overrides, as in the JAX
    package."""
    env = os.environ.get("FHE_REGEX_DROP64")
    if env is not None:
        m, b = env.split(",")
        return (int(m), int(b))
    if params.lwe_noise_std == 0.0 and params.glwe_noise_std == 0.0:
        return (0, 0)       # zero-noise test sets: keep bit-exactness
    for cand in ((2, 2), (1, 2), (1, 1)):
        rep = params.noise_budget_report(bsk_drop=cand)
        mv = params.noise_budget_report(
            bsk_drop=cand, mv_norm2=WORST_PRODUCTION_MV_NORM2)
        if (rep["sigma_margin"] >= MIN_SIGMA_MARGIN
                and rep["log2_p_fail_per_pbs"] <= -40.0
                and mv["sigma_margin"] >= MIN_SIGMA_MARGIN):
            return cand
    return (0, 0)


def _gate_drop64(params: Params, drop) -> None:
    """Refuse a limb drop that would break the noise contract on a set
    that otherwise meets it, or that leaves under 1 sigma on any set."""
    if tuple(drop) == (0, 0):
        return
    if params.lwe_noise_std == 0.0 and params.glwe_noise_std == 0.0:
        return              # deterministic test sets: error << delta/2
    base = params.noise_budget_report()["sigma_margin"]
    dropped = params.noise_budget_report(bsk_drop=tuple(drop))["sigma_margin"]
    if base >= MIN_SIGMA_MARGIN and dropped < MIN_SIGMA_MARGIN:
        raise ValueError(
            f"bsk limb drop {tuple(drop)} leaves {dropped:.2f} sigma "
            f"(< {MIN_SIGMA_MARGIN}) at {params.name}; see "
            f"Params.bsk_round_var")
    if dropped < 1.0:
        raise ValueError(
            f"bsk limb drop {tuple(drop)} leaves {dropped:.2f} sigma at "
            f"{params.name} — results would be garbage, refusing")


def round_bsk64(params: Params, bsk: np.ndarray, drop) -> np.ndarray:
    """bsk [n, (k+1)l, k+1, N] uint64 with the mask (c < k) and body GGSW
    polynomials rounded to multiples of 256^m, m = drop[0] / drop[1].

    The key the JAX ``pallas64-bg`` backend multiplies by
    (``prepare_bsk_fused64_raw(drop)``); its low bytes are zero, and
    -g mod 2^64 of a rounded g is a multiple of 256^m too.  The extra
    noise is ``Params.bsk_round_var``; gate it with ``_gate_drop64``."""
    g = np.array(bsk, dtype=np.uint64, copy=True)
    k = params.glwe_dimension
    for c in range(k + 1):
        m = drop[0] if c < k else drop[1]
        if m:
            unit = np.uint64(1) << np.uint64(8 * m)
            half = unit >> np.uint64(1)
            with np.errstate(over="ignore"):
                g[:, :, c, :] = ((g[:, :, c, :] + half) // unit) * unit
    return g
