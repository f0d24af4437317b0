"""Least times of blind rotations at the published peaks of one H100.

Frozen copies of the bound arithmetic of ``chip_smoke.py``
(``limb_pairs``, ``rotation_bound``, ``fft_rotation_bound``)
with their constants, so that a later change to the program cannot move
the yardstick.  Two formulations of the same work:

  limb   the int8 tensor-core formulation: each torus word split into
         int8 limbs, every (digit limb, key limb) product of weight below
         2^torus_bits counted, at the int8 rate;
  fft    the float64 FFT formulation (limb plan ``FFT_PLAN``, 32 bits
         only): forward and inverse FFTs outside the tensor cores, the
         spectral contraction on the float64 tensor cores.

Each formulation's time is the larger of its operations term and its
bytes term; ``least_seconds`` takes the lesser formulation.
"""

from __future__ import annotations

import math

HBM_BYTES_PER_S = 3.35e12      # H100 SXM device memory
INT8_OPS_PER_S = 1.979e15      # H100 SXM dense int8 tensor cores
FP64_FLOPS_PER_S = 3.4e13      # H100 SXM float64 outside the tensor cores
FP64_TC_FLOPS_PER_S = 6.7e13   # H100 SXM float64 tensor cores
FFT_PLAN = (16, 8, 8)          # the FFT formulation's key limb widths


def n_digit_limbs(base_log: int) -> int:
    """int8 limbs of a balanced base-2^base_log digit."""
    return (base_log + 7) // 8


def limb_pairs(params, drop=(0, 0)) -> float:
    """int8 limb products per multiply-add of the limb formulation: four
    key limbs at 32 bits; at 64 bits each (digit limb, key limb) pair of
    weight below 2^64, without the key limbs a drop zeroes, averaged over
    the mask and body columns."""
    if params.torus_bits == 32:
        return 4.0
    nd = n_digit_limbs(params.pbs_base_log)
    k = params.glwe_dimension
    per_c = [sum(1 for dl in range(nd)
                 for j in range(drop[0] if c < k else drop[1], 8)
                 if dl + j < 8) for c in range(k + 1)]
    return sum(per_c) / len(per_c)


def limb_terms(params, B: int, L: int, drop=(0, 0)):
    """(operations seconds, bytes seconds) of one limb-formulation rotation
    of B instances with L LUTs: n steps of B x rows x (k+1) x N^2
    multiply-adds; the key, inputs and output each moved once."""
    k1, N = params.glwe_dimension + 1, params.polynomial_size
    n, rows = params.lwe_dimension, k1 * params.pbs_level
    word = params.torus_bits // 8
    macs = B * n * rows * k1 * N * N
    nbytes = (n * rows * k1 * N * word + B * (n + 2) * 4 + L * N * word
              + B * k1 * N * word)
    return (2 * macs * limb_pairs(params, drop) / INT8_OPS_PER_S,
            nbytes / HBM_BYTES_PER_S)


def fft_terms(params, B: int, L: int):
    """(operations seconds, bytes seconds) of one FFT-formulation rotation:
    per step (k+1)l B forward and (k+1) Lp B inverse complex FFTs of length
    M = N/2 (5 M log2 M flops each) outside the tensor cores, and (k+1)l
    (k+1) Lp M B complex multiply-adds (8 flops each) on them, n steps; or
    the spectral key (complex128), the inputs and the output each moved
    once."""
    k1, N = params.glwe_dimension + 1, params.polynomial_size
    n, rows, M = params.lwe_dimension, k1 * params.pbs_level, N // 2
    Lp = len(FFT_PLAN)
    t_fft = n * (rows + k1 * Lp) * B * 5 * M * math.log2(M) / FP64_FLOPS_PER_S
    t_mm = n * 8 * rows * k1 * Lp * M * B / FP64_TC_FLOPS_PER_S
    nbytes = (n * rows * k1 * Lp * M * 16 + B * (n + 2) * 4 + L * N * 4
              + B * k1 * N * 4)
    return t_fft + t_mm, nbytes / HBM_BYTES_PER_S


def rotation_bound(params, B: int, L: int, drop=(0, 0)):
    """(least ms, what sets it) of one limb-formulation rotation, as
    ``chip_smoke.rotation_bound``."""
    t_ops, t_bytes = limb_terms(params, B, L, drop)
    return max(t_ops, t_bytes) * 1e3, ("operations" if t_ops >= t_bytes
                                       else "bytes")


def fft_rotation_bound(params, B: int, L: int):
    """(least ms, what sets it) of one FFT-formulation rotation, as
    ``chip_smoke.fft_rotation_bound``."""
    t_ops, t_bytes = fft_terms(params, B, L)
    return max(t_ops, t_bytes) * 1e3, ("operations" if t_ops >= t_bytes
                                       else "bytes")


def least_seconds(params, rows: int, levels: int) -> float:
    """Least time of ``rows`` needed rotations run in ``levels`` dependent
    levels (one LUT each): per formulation, the larger of the operations
    of all rows and the bytes of ``levels`` passes (the key once a level,
    every row's input and output once); the lesser formulation.  Without
    the split of rows between levels, this is at most the sum of the
    levels' own bounds."""
    if rows <= 0:
        return 0.0
    forms = [limb_terms] + ([fft_terms] if params.torus_bits == 32 else [])
    best = None
    for terms in forms:
        ops_s, all_s = terms(params, rows, 1)
        _, key_s = terms(params, 0, 1)          # one pass: the key, the LUT
        bytes_s = levels * key_s + (all_s - key_s)
        t = max(ops_s, bytes_s)
        best = t if best is None else min(best, t)
    return best
