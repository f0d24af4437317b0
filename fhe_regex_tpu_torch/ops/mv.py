"""Multi-value bootstrap runtime (PyTorch): one blind rotation, many LUTs.

The twin of ``fhe_regex_tpu/ops/mv.py``.  Every test polynomial factors
exactly as u (*) v over the negacyclic ring (``ops/luts.py``
``mv_weights``; spec in ``crypto/golden.py``), and blind rotation commutes
with multiplication by a fixed polynomial, so ops that share an input share
ONE rotation of the common v, and each op's LUT is applied at
sample-extract time as a static-roll combination:

    big_j = sum_m  u_j[m] * sample_extract(X^{p_m} * acc_v)

The support positions p_m are static (window boundaries): the combine is
at most 16 negacyclic rolls and a weighted sum in torch ops around the
same blind rotations (the backend's, ``ops.pbs.rotation_fn``) and
keyswitch the classic path uses.  No kernel of its own.

Torus values are int32 tensors at 32 bits and int64 at 64 bits, as in
``ops/pbs.py`` and ``ops/pbs64.py``; the weighted sums are taken in int64
and wrap mod 2^32 / 2^64.
"""

from __future__ import annotations

import numpy as np
import torch

from fhe_regex_tpu_torch.crypto.golden import mv_testpoly
from fhe_regex_tpu_torch.ops import pbs64
from fhe_regex_tpu_torch.ops.luts import mv_support_positions
from fhe_regex_tpu_torch.ops.pbs import (DeviceServerKey, I32, I64,
                                         blind_rotate, key_switch, mod_switch,
                                         rotation_fn, sample_extract,
                                         wrap_i32)
from fhe_regex_tpu_torch.params import Params

# The JAX package's multi-value backends and their counterparts here (the
# port runs multi-value on every backend it has but `fft`, as JAX does not
# on its `fft`; `cuda-bg` included).
MV_BACKENDS = {
    "jnp": "torch",
    "pallas": "cuda",
    "pallas-fused": "cuda-fused",
    "pallas-bg": "cuda-bg",
    "jnp64": "torch64",
    "pallas64": "cuda64",
    "pallas64-bg": "cuda64-bg",
}


def mv_lut_table(params: Params, device="cpu") -> torch.Tensor:
    """The 1-row LUT table every multi-value rotation uses (v): [1, N]
    int32 bits at 32 bits, int64 bits at 64 bits."""
    v = mv_testpoly(params)[None]
    signed = np.int32 if params.torus_bits == 32 else np.int64
    return torch.from_numpy(v.view(signed)).to(device)


def _rotate_acc(dev_key: DeviceServerKey, vlut: torch.Tensor,
                cts: torch.Tensor) -> torch.Tensor:
    """Affine-combined cts [R, n+1] -> accumulators [R, k+1, N] through the
    backend's blind rotation, every row on LUT row 0."""
    params = dev_key.params
    idx = torch.zeros(cts.shape[0], dtype=I32, device=cts.device)
    switch = mod_switch if params.torus_bits == 32 else pbs64.mod_switch64
    return rotation_fn(dev_key)(vlut, idx, switch(params, cts))


def _key_switch(dev_key: DeviceServerKey, big: torch.Tensor) -> torch.Tensor:
    if dev_key.params.torus_bits == 32:
        return key_switch(dev_key.params, dev_key.ksk, big)
    return pbs64.key_switch64(dev_key.params, dev_key.ksk, big)


def _negacyclic_roll(accs: torch.Tensor, p: int) -> torch.Tensor:
    """X^p * accs for a static 0 <= p < N: a roll along the coefficients
    with the p wrapped ones negated (mod 2^32 for int32)."""
    rolled = torch.roll(accs, p, dims=-1)
    head = -rolled[..., :p].to(I64)
    rolled[..., :p] = wrap_i32(head) if accs.dtype == I32 else head
    return rolled


def _weighted(params: Params, accs, weights, leader, positions,
              extract) -> torch.Tensor:
    """sum_m weights[:, m] * extract(X^{p_m} * accs)[leader] in int64."""
    pos = mv_support_positions(params) if positions is None else positions
    w = torch.as_tensor(weights, device=accs.device).to(I64)
    ld = torch.as_tensor(leader, device=accs.device).to(I64)
    big = None
    for m, p in enumerate(pos):
        se = extract(params, _negacyclic_roll(accs, int(p)))[ld].to(I64)
        term = w[:, m:m + 1] * se                                  # [W, kN+1]
        big = term if big is None else big + term
    return big


def mv_extract(params: Params, accs, weights, leader, positions=None):
    """Derived big-LWEs from shared accumulators.

    accs [R, k+1, N] int32; weights [W, S] (S support positions); leader
    [W], the rotation row of each op.  -> [W, kN+1] int32.  ``positions``:
    the static support positions matching weights' columns (default: the
    full support); level plans pass only the columns with any nonzero
    weight."""
    return wrap_i32(_weighted(params, accs, weights, leader, positions,
                              sample_extract))


def mv_extract64(params: Params, accs, weights, leader, positions=None):
    """64-bit derived big-LWEs: accs [R, k+1, N] int64 -> [W, kN+1] int64,
    the weighted sums wrapping mod 2^64.  Numpy weights must satisfy
    |w| < 32, the bound of the JAX package's shift-add (asserted as there,
    so both packages reject the same inputs)."""
    if isinstance(weights, np.ndarray):
        assert np.abs(weights).max(initial=0) < 32, (
            "mv_extract64 supports |weights| < 32 (5-bit shift-add); got "
            f"max |w| = {np.abs(weights).max()}")
    return _weighted(params, accs, weights, leader, positions,
                     pbs64.sample_extract64)


def has_mv_rotation(backend: str) -> bool:
    """Whether ``backend`` runs the multi-value plan; the packed paths'
    auto choice takes the classic plan on one that does not."""
    return backend in MV_BACKENDS.values()


def _check_mv(dev_key: DeviceServerKey) -> None:
    if not has_mv_rotation(dev_key.backend):
        raise ValueError(
            f"multi-value bootstrap not supported on {dev_key.backend!r}")


def make_mv_rotate_core(dev_key: DeviceServerKey):
    """(vlut, rot_cts [R, n+1]) -> accumulators [R, k+1, N]."""
    _check_mv(dev_key)

    def core(vlut, rot_cts):
        return _rotate_acc(dev_key, vlut, rot_cts)

    return core


def make_mv_finish_core(dev_key: DeviceServerKey):
    """(accs, weights, leader, positions=None) -> [W, n+1] derived,
    keyswitched outputs."""
    _check_mv(dev_key)
    params = dev_key.params
    extract = mv_extract if params.torus_bits == 32 else mv_extract64

    def core(accs, weights, leader, positions=None):
        return _key_switch(dev_key,
                           extract(params, accs, weights, leader, positions))

    return core


def make_mv_core(dev_key: DeviceServerKey):
    """(vlut, weights, leader, rot_cts, positions=None) -> [W, n+1].

    rot_cts [R, n+1]: the DEDUPED affine-combined inputs (one per unique
    rotation); every op's output is derived from its leader's accumulator.
    """
    rotate = make_mv_rotate_core(dev_key)
    finish = make_mv_finish_core(dev_key)

    def core(vlut, weights, leader, rot_cts, positions=None):
        return finish(rotate(vlut, rot_cts), weights, leader, positions)

    return core


def mv_pbs_batch(params: Params, bsk, ksk, weights, leader, rot_cts):
    """Plain multi-value PBS at 32 bits (tests / reference): ksk is the
    float64 matrix of ``ops.pbs.prepare_ksk``."""
    ms = mod_switch(params, rot_cts)
    idx = torch.zeros(rot_cts.shape[0], dtype=I32, device=rot_cts.device)
    accs = blind_rotate(params, bsk, mv_lut_table(params, rot_cts.device),
                        idx, ms)
    return key_switch(params, ksk, mv_extract(params, accs, weights, leader))
