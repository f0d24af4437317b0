"""Lattice security estimation for the LWE/GLWE parameter sets.

Replaces the round-1 "constant-security line n / log2(q/sigma) ~= 43.4"
heuristic (params.py) with a real estimate: the **primal uSVP attack under
the core-SVP cost model** — the methodology of the Homomorphic Encryption
Security Standard (Albrecht et al., homomorphicencryption.org 2018) and the
binding attack in the lattice-estimator for TFHE-shaped parameters
(binary secrets, discrete-Gaussian errors).  See docs/SECURITY.md for the
write-up and the anchor-point cross-checks.

Model
-----
The attacker builds the Bai-Galbraith embedding lattice from m LWE samples
(secret coordinates rescaled by xi = sigma/sigma_s to balance the binary
secret against the Gaussian error), dimension d = m + n + 1 and volume
q^m * xi^n, and runs BKZ with block size beta.  BKZ-beta finds the planted
short vector when the projected error defeats the Geometric Series
Assumption estimate (Alkim-Ducas-Poppelmann-Schwabe 2016 "2016 estimate"):

    sigma * sqrt(beta)  <=  delta(beta)^(2*beta - d - 1) * vol^(1/d)

with the root-Hermite factor  delta(beta) = ((pi*beta)^(1/beta) * beta /
(2*pi*e))^(1 / (2*(beta - 1))).  The attack cost is core-SVP: one SVP call
in dimension beta, 2^(0.292*beta) classically (BDGL16 sieving) and
2^(0.265*beta) quantumly (Laarhoven) — deliberately conservative (ignores
the ~2^16 sieve overhead and the BKZ call factor, so real attacks are
strictly more expensive than reported here).

The reference's own security contract is tfhe-rs 0.2's parameter pin
(SURVEY.md N1); this module lets tests assert our rescaled sets sit at or
above that pin's security level and above the 128-bit floor.
"""

from __future__ import annotations

import dataclasses
import math

from fhe_regex_tpu_torch.params import Params

_LOG2E = math.log2(math.e)


def _log2_delta(beta: int) -> float:
    """log2 of the BKZ-beta root-Hermite factor (GSA slope parameter)."""
    if beta <= 50:
        # the delta(beta) model is only meaningful for beta >~ 50; clamp so
        # the search below never reports a sub-50 block size as "secure"
        beta = 50
    return (math.log2(math.pi * beta) / beta
            + math.log2(beta / (2 * math.pi * math.e))) / (2 * (beta - 1))


def _usvp_succeeds(n: int, log2_q: float, log2_sigma: float,
                   secret_var: float, beta: int, m: int) -> bool:
    """2016-estimate success condition for primal uSVP at (beta, m)."""
    # Bai-Galbraith rescale: secret columns scaled by xi = sigma / sigma_s
    log2_xi = max(0.0, log2_sigma - 0.5 * math.log2(secret_var))
    d = m + n + 1
    log2_vol = m * log2_q + n * log2_xi
    lhs = log2_sigma + 0.5 * math.log2(beta)
    rhs = (2 * beta - d - 1) * _log2_delta(beta) + log2_vol / d
    return lhs <= rhs


def _usvp_beta(n: int, log2_q: float, log2_sigma: float,
               secret_var: float = 0.25, max_beta: int = 2048
               ) -> "tuple[int, int]":
    """Smallest BKZ block size whose uSVP attack succeeds (optimizing the
    sample count m per beta) and the attack's lattice dimension d at that
    optimum; (max_beta+1, 0) if no attack fits the model."""
    lo, hi = 50, max_beta
    # the success region is monotone in beta (larger beta => stronger BKZ),
    # so binary-search the threshold; per beta, scan m coarsely

    def succeeds(beta: int) -> int:
        """0 if the attack fails at every m, else the smallest working d."""
        step = max(1, n // 16)
        for m in range(step, 4 * n + 1, step):
            if _usvp_succeeds(n, log2_q, log2_sigma, secret_var, beta, m):
                return m + n + 1
        return 0

    if not succeeds(hi):
        return max_beta + 1, 0
    while lo < hi:
        mid = (lo + hi) // 2
        if succeeds(mid):
            hi = mid
        else:
            lo = mid + 1
    return lo, succeeds(lo)


def _dual_cost_bits(n: int, log2_q: float, log2_sigma: float,
                    secret_var: float, beta: int, m: int) -> "float | None":
    """Classical core-SVP cost (bits) of the scaled-dual distinguishing
    attack at (beta, m); None when the advantage is hopeless.

    Scaled dual of the Bai-Galbraith lattice: L = {(v, w/xi) : A^T v = w
    mod q}, dim d = m + n, vol = (q/xi)^n, xi = sigma/sigma_s.  BKZ-beta
    finds a vector of norm ell = delta^(d-1) vol^(1/d); the statistic
    <v, b> mod q is then (balanced rescale) Gaussian of std ~ ell*sigma,
    distinguishable from uniform with advantage eps = exp(-2 pi^2
    (ell sigma/q)^2) (Albrecht 2017 "dual lattice attacks"; HE-standard
    appendix B).  R = 1/(4 eps^2) repetitions boost to constant advantage;
    one dim-beta sieve emits 2^(0.2075 beta) usable short vectors, so the
    repetitions are amortized against the sieve batch (MATZOV-style)."""
    log2_xi = max(0.0, log2_sigma - 0.5 * math.log2(secret_var))
    d = m + n
    log2_vol = n * (log2_q - log2_xi)
    log2_ell = (d - 1) * _log2_delta(beta) + log2_vol / d
    log2_ratio = log2_ell + log2_sigma - log2_q
    if log2_ratio > 1.0:
        return None           # ell*sigma >> q: no distinguishing signal
    log2_eps = -2.0 * math.pi ** 2 * (2.0 ** (2 * log2_ratio)) * _LOG2E
    log2_R = max(0.0, -2.0 * log2_eps - 2.0)
    return 0.292 * beta + max(0.0, log2_R - 0.2075 * beta)


def _dual_bits(n: int, log2_q: float, log2_sigma: float,
               secret_var: float = 0.25, max_beta: int = 2048
               ) -> "tuple[float, int, int]":
    """(classical core-SVP bits, beta, d) of the cheapest scaled-dual
    attack over (beta, m)."""
    best = (float("inf"), max_beta + 1, 0)
    step_m = max(1, n // 8)
    for beta in range(50, max_beta + 1, 8):
        for m in range(step_m, 4 * n + 1, step_m):
            c = _dual_cost_bits(n, log2_q, log2_sigma, secret_var, beta, m)
            if c is not None and c < best[0]:
                best = (c, beta, m + n)
    return best


@dataclasses.dataclass(frozen=True)
class SecurityEstimate:
    n: int
    log2_q: float
    log2_rel_sigma: float       # log2(sigma / q), the scale-free noise rate
    beta: int                   # minimal successful BKZ block size
    dim: int                    # attack lattice dimension at the optimum
    classical_bits: float       # bare core-SVP classical: 0.292 * beta
    quantum_bits: float         # bare core-SVP quantum: 0.265 * beta

    dual_bits: float = float("inf")   # scaled-dual core-SVP classical bits
    dual_beta: int = 0
    dual_dim: int = 0

    @property
    def dual_bits_bkz(self) -> float:
        """Scaled-dual cost under the same full-BKZ constants as
        classical_bits_bkz (sieve constant + SVP calls per tour)."""
        return self.dual_bits + 16.4 + math.log2(8 * max(self.dual_dim, 1))

    @property
    def classical_bits_bkz(self) -> float:
        """Full-BKZ classical cost: 0.292*beta + 16.4 (BDGL16 sieve
        constant) + log2(8d) SVP calls per BKZ tour — the cost model under
        which the tfhe-rs-0.2-era "128-bit" parameter claims were made
        (docs/SECURITY.md).  Bare core-SVP (`classical_bits`) is the
        conservative floor: Kyber-512's core-SVP is 2^118 and is certified
        NIST level 1 (AES-128)."""
        return 0.292 * self.beta + 16.4 + math.log2(8 * max(self.dim, 1))


def estimate_lwe(n: int, q: float, sigma: float,
                 secret_var: float = 0.25) -> SecurityEstimate:
    """Core-SVP primal-uSVP estimate for LWE(n, q, sigma), binary secret.

    sigma is the absolute error std in torus units (same convention as
    Params.lwe_noise_std / glwe_noise_std).  A sub-discretization sigma is
    floored at ~0.5 discretization units: errors below half a unit carry no
    entropy beyond rounding, so claiming extra security from them would be
    wrong (matters for the 32-bit GLWE point, whose absolute noise is small
    but still > 1 unit).
    """
    sigma = max(sigma, 0.5)
    log2_q = math.log2(q)
    log2_sigma = math.log2(sigma)
    beta, dim = _usvp_beta(n, log2_q, log2_sigma, secret_var)
    dual_bits, dual_beta, dual_dim = _dual_bits(n, log2_q, log2_sigma,
                                                secret_var)
    return SecurityEstimate(
        n=n, log2_q=log2_q, log2_rel_sigma=log2_sigma - log2_q, beta=beta,
        dim=dim, classical_bits=0.292 * beta, quantum_bits=0.265 * beta,
        dual_bits=dual_bits, dual_beta=dual_beta, dual_dim=dual_dim)


def estimate_params(params: Params) -> dict:
    """Security of a parameter set's two secrets.

    - 'lwe': the n-dimensional key the regex ciphertexts live under (also
      the keyswitch-key output side).
    - 'glwe': the k*N-dimensional flattened GLWE key (bootstrap-key GGSW
      encryptions and the post-sample-extract big-LWE ciphertexts); RLWE
      security is estimated via its LWE embedding, standard practice.

    The set's security level is the minimum of the two.
    """
    lwe = estimate_lwe(params.lwe_dimension, float(params.q),
                       float(params.lwe_noise_std))
    glwe = estimate_lwe(params.glwe_dimension * params.polynomial_size,
                        float(params.q), float(params.glwe_noise_std))
    return {
        "lwe": lwe,
        "glwe": glwe,
        "classical_bits": min(lwe.classical_bits, glwe.classical_bits),
        "classical_bits_bkz": min(lwe.classical_bits_bkz,
                                  glwe.classical_bits_bkz),
        "quantum_bits": min(lwe.quantum_bits, glwe.quantum_bits),
        "dual_bits": min(lwe.dual_bits, glwe.dual_bits),
        "dual_bits_bkz": min(lwe.dual_bits_bkz, glwe.dual_bits_bkz),
    }
