"""Golden-model programmable bootstrapping (NumPy, slow, exact).

This is the executable specification of the PBS pipeline the Pallas/JAX
kernels are tested against (SURVEY.md §4 "kernel-level unit tests against a
slow NumPy reference").  Pipeline (SURVEY.md N9):

    mod-switch (q -> 2N)  ->  blind rotation (n CMUX external products)
    ->  sample extract (coeff 0)  ->  keyswitch (kN -> n)
"""

from __future__ import annotations

import numpy as np

from fhe_regex_tpu_torch.crypto.glwe import decompose_balanced, external_product
from fhe_regex_tpu_torch.params import Params

U32 = np.uint32


def _dt(params: Params):
    return np.uint32 if params.torus_bits == 32 else np.uint64


def mod_switch(params: Params, ct: np.ndarray) -> np.ndarray:
    """Round an LWE ct from q to Z_{2N}: a~ = round(a * 2N / q)."""
    N = params.polynomial_size
    shift = params.torus_bits - (N.bit_length() - 1) - 1  # q / 2N = 2^shift
    v = ct.astype(np.uint64)
    with np.errstate(over="ignore"):
        return (((v + (np.uint64(1) << np.uint64(shift - 1))) >> np.uint64(shift))
                % np.uint64(2 * N)).astype(np.int64)


def negacyclic_rotate(p: np.ndarray, r: int) -> np.ndarray:
    """X^r * p mod (X^N + 1): a shift with sign flips on wraparound."""
    N = p.shape[-1]
    r = int(r) % (2 * N)
    with np.errstate(over="ignore"):
        doubled = np.concatenate([p, (p.dtype.type(0) - p)])
    idx = (np.arange(N) - r) % (2 * N)
    return doubled[idx]


def make_lut_poly(params: Params, f) -> np.ndarray:
    """Redundant test polynomial for f: plaintext slot -> plaintext slot.

    Slots live in the padded plaintext space [0, slots/2) (padding bit 0);
    window edges use the standard half-slot offset so noise around slot
    boundaries resolves correctly, including the negacyclic wrap at slot 0.
    """
    N = params.polynomial_size
    slots = params.plaintext_slots
    r = 2 * N // slots
    delta = params.delta
    q = params.q
    v = np.zeros(N, dtype=np.uint64)
    for t in range(N):
        m = (t + r // 2) // r
        if m < slots // 2:
            v[t] = ((f(m) % slots) * delta) % q
        else:  # wrap region: phases just below 0 land at -v[t - N] = +f(0)
            v[t] = (-((f(0) % slots) * delta)) % q
    return v.astype(_dt(params))


def blind_rotate(params: Params, bsk: np.ndarray, lut_poly: np.ndarray,
                 ct_ms: np.ndarray) -> np.ndarray:
    """Compute GLWE(X^{-phase~} * v) via the CMUX ladder."""
    k, N, n = params.glwe_dimension, params.polynomial_size, params.lwe_dimension
    dt = _dt(params)
    acc = np.zeros((k + 1, N), dtype=dt)
    acc[k] = negacyclic_rotate(lut_poly, -int(ct_ms[n]))
    with np.errstate(over="ignore"):
        for i in range(n):
            a_i = int(ct_ms[i])
            if a_i == 0:
                continue
            diff = np.stack([
                (negacyclic_rotate(acc[c], a_i) - acc[c]).astype(dt)
                for c in range(k + 1)
            ])
            acc = (acc + external_product(params, bsk[i], diff)).astype(dt)
    return acc


def sample_extract(params: Params, acc: np.ndarray) -> np.ndarray:
    """GLWE -> big LWE (dim kN) extracting coefficient 0."""
    k, N = params.glwe_dimension, params.polynomial_size
    dt = _dt(params)
    out = np.empty(params.glwe_key_dim + 1, dtype=dt)
    with np.errstate(over="ignore"):
        for c in range(k):
            a = acc[c]
            ext = np.empty(N, dtype=dt)
            ext[0] = a[0]
            ext[1:] = (dt(0) - a[:0:-1]).astype(dt)
            out[c * N:(c + 1) * N] = ext
    out[-1] = acc[k][0]
    return out


def key_switch(params: Params, ksk: np.ndarray, big_ct: np.ndarray) -> np.ndarray:
    """Big LWE (dim kN) -> small LWE (dim n) via the keyswitch key."""
    kN, n = params.glwe_key_dim, params.lwe_dimension
    dt = _dt(params)
    out = np.zeros(n + 1, dtype=np.uint64)
    out[n] = np.uint64(big_ct[kN])
    digits = decompose_balanced(big_ct[:kN], params.ks_base_log,
                                params.ks_level, params.torus_bits)
    with np.errstate(over="ignore"):
        for j in range(params.ks_level):
            # out -= sum_t digits[j, t] * ksk[t, j]  (mod 2^torus_bits)
            prod = (digits[j].astype(np.int64).astype(np.uint64)[:, None]
                    * ksk[:, j, :].astype(np.uint64)).sum(axis=0, dtype=np.uint64)
            out = out - prod
    return out.astype(dt)


def pbs(params: Params, bsk: np.ndarray, ksk: np.ndarray, ct: np.ndarray,
        lut_poly: np.ndarray) -> np.ndarray:
    """Full programmable bootstrap of one LWE ciphertext (dim n -> dim n)."""
    ct_ms = mod_switch(params, ct)
    acc = blind_rotate(params, bsk, lut_poly, ct_ms)
    big = sample_extract(params, acc)
    return key_switch(params, ksk, big)


# ---------------- multi-value bootstrap (spec) ----------------


def mv_testpoly(params: Params) -> np.ndarray:
    """The common test polynomial v = (delta/2)*(1 + X + ... + X^{N-1}).

    Every make_lut_poly output factors exactly as u (*) v with u the sparse
    integer factor from ops.luts.mv_weights (see the derivation there)."""
    return np.full(params.polynomial_size, params.delta // 2, dtype=_dt(params))


def mv_derived_extract(params: Params, acc_v: np.ndarray,
                       weights: np.ndarray) -> np.ndarray:
    """Big-LWE of ONE derived LUT from the common rotated accumulator.

    acc_v: blind_rotate(..., mv_testpoly(params), ct_ms) — shared by every
    LUT on the same input.  weights: ops.luts.mv_weights of the LUT.
    Computes sample_extract(u (*) acc_v) via the linearity of extraction
    over the static support rotations."""
    from fhe_regex_tpu_torch.ops.luts import mv_support_positions

    pos = mv_support_positions(params)
    dt = _dt(params)
    out = np.zeros(params.glwe_key_dim + 1, dtype=dt)
    with np.errstate(over="ignore"):
        for p, w in zip(pos, weights):
            if w == 0:
                continue
            rolled = np.stack([negacyclic_rotate(acc_v[c], int(p))
                               for c in range(acc_v.shape[0])])
            out = (out + dt(np.int64(w) & ((1 << params.torus_bits) - 1))
                   * sample_extract(params, rolled)).astype(dt)
    return out


def mv_pbs(params: Params, bsk: np.ndarray, ksk: np.ndarray, ct: np.ndarray,
           weights_list) -> list:
    """Multi-value bootstrap: ONE blind rotation of v, one derived output
    per factor in weights_list (each keyswitched as usual)."""
    ct_ms = mod_switch(params, ct)
    acc_v = blind_rotate(params, bsk, mv_testpoly(params), ct_ms)
    return [key_switch(params, ksk, mv_derived_extract(params, acc_v, w))
            for w in weights_list]
