"""LUT definitions for the regex engine's micro-ops.

Each logical radix op (eq/gt/le/and/or; SURVEY.md N5-N8) lowers to bootstraps
whose LUTs live here.  A ``LutKey`` is a hashable identity; ``lut_fn`` maps it
to the plaintext function evaluated over the padded 4-bit message+carry
domain (values 0..15).  Device test polynomials are built per parameter set
with ``crypto.golden.make_lut_poly``.

Input conventions (affine combines produced by regex/circuit.py):
  nibble LUTs:  x = b_lo + 4*b_hi            in 0..15 (one content nibble)
  AND2 / OR2:   w = a + 2*b                  in 0..3  (two bits)
  OR_AND3:      z = p + 2*q + 4*r            in 0..7  -> p | (q & r)
                (lexicographic byte compare combine: gt = gt_hi | (eq_hi &
                gt_lo); le = lt_hi | (eq_hi & le_lo) — same table, shared)
"""

from __future__ import annotations

from typing import Callable, Tuple

import numpy as np

LutKey = Tuple


def LUT_EQ(c: int) -> LutKey:
    return ("eq", c)


def LUT_GT(c: int) -> LutKey:
    return ("gt", c)


def LUT_LT(c: int) -> LutKey:
    return ("lt", c)


def LUT_LE(c: int) -> LutKey:
    return ("le", c)


LUT_AND2: LutKey = ("and2",)
LUT_OR2: LutKey = ("or2",)
LUT_AND3: LutKey = ("and3",)   # w = x + 2y + 4z -> x & y & z
LUT_OR3: LutKey = ("or3",)     # w = x + 2y + 4z -> x | y | z
# gt-combine and le-combine share one table: p | (q & r)
LUT_GT_COMBINE: LutKey = ("or_and3",)
LUT_LE_COMBINE: LutKey = ("or_and3",)
# counting (base-4 digit arithmetic over w = a + b + c affine sums):
LUT_IDENT: LutKey = ("ident",)   # w -> w       (re-bootstrap a 0..3 sum)
LUT_MOD4: LutKey = ("mod4",)     # w -> w % 4   (digit of a 0..7 sum)
LUT_GE4: LutKey = ("ge4",)       # w -> w >= 4  (carry of a 0..7 sum)


# ---------------- multi-value bootstrap factorization ----------------
#
# Every test polynomial built by crypto.golden.make_lut_poly is piecewise
# constant over `slots/2` windows of r = 2N/slots coefficients (offset by
# r/2), so it factors EXACTLY over the negacyclic ring as
#
#     t  =  u (*) v,     v = (delta/2) * (1 + X + ... + X^{N-1})
#
# with u supported only on the slots/2 static window-boundary positions
# p_m = m*r - r/2 and integer weights u[p_m] = f(m) - f(m-1) (wrap weight
# -f(0) - f(slots/2-1)).  Since blind rotation commutes with multiplication
# by a fixed poly, rotating the COMMON v once serves every LUT on the same
# input: each op's output is the cheap plaintext combination u_j applied at
# sample-extract time (the CIM19 multi-value bootstrap, re-based onto this
# engine's window layout).  Output noise is amplified by ||u||_2 on the
# blind-rotation component only — params.noise_budget_report asserts the
# margin (keyswitch+modswitch dominate at our parameters, so sparse boolean
# factors keep >= 5 sigma; see tests/test_multivalue.py).


def mv_support_positions(params) -> np.ndarray:
    """The slots/2 static coefficient positions where LUT factors live."""
    N, slots = params.polynomial_size, params.plaintext_slots
    r = 2 * N // slots
    return np.asarray([m * r - r // 2 for m in range(1, slots // 2 + 1)],
                      np.int32)


def mv_weights(params, key: LutKey) -> np.ndarray:
    """Integer factor weights of `key`'s test polynomial (one per support
    position).  mv_weights[m-1] multiplies X^{p_m}."""
    f = lut_fn(key)
    slots = params.plaintext_slots
    s = slots // 2
    fv = [f(m) % slots for m in range(s)]
    w = np.zeros(s, np.int64)
    for m in range(1, s):
        w[m - 1] = fv[m] - fv[m - 1]
    w[s - 1] = -fv[0] - fv[s - 1]
    return w.astype(np.int32)


def mv_norm2(params, key: LutKey) -> int:
    """||u||_2^2 of the factor — the blind-rotation noise amplification."""
    w = mv_weights(params, key).astype(np.int64)
    return int((w * w).sum())


def lut_fn(key: LutKey) -> Callable[[int], int]:
    kind = key[0]
    if kind == "eq":
        return lambda x, c=key[1]: 1 if x == c else 0
    if kind == "gt":
        return lambda x, c=key[1]: 1 if x > c else 0
    if kind == "lt":
        return lambda x, c=key[1]: 1 if x < c else 0
    if kind == "le":
        return lambda x, c=key[1]: 1 if x <= c else 0
    if kind == "and2":
        return lambda w: 1 if w == 3 else 0
    if kind == "or2":
        return lambda w: 1 if w in (1, 2, 3) else 0
    if kind == "and3":
        return lambda w: 1 if w == 7 else 0
    if kind == "or3":
        return lambda w: 1 if 1 <= w <= 7 else 0
    if kind == "or_and3":
        return lambda z: 1 if (z & 1) or ((z >> 1) & 1 and (z >> 2) & 1) else 0
    if kind == "ident":
        return lambda w: w
    if kind == "mod4":
        return lambda w: w % 4
    if kind == "ge4":
        return lambda w: 1 if w >= 4 else 0
    raise KeyError(key)
