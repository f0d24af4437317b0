"""Collective homomorphic OR-tree reduction across the ranks of a mesh.

The PyTorch twin of ``fhe_regex_tpu/parallel/collective.py``: each rank
holds one partial-OR ciphertext; ceil(log2 D) rounds (at least one) each
shift every rank's accumulator to rank (i + 2^r) mod D (a
``batch_isend_irecv`` pair) and bootstrap ``acc + 2 * recv`` through the OR
LUT, after which every rank holds the OR of all D bits.  At D = 1 the
shift is the JAX permutation [(0, 0)]: the received row is a copy of the
accumulator (no self-send), and one OR bootstrap still runs.

The decrypted result equals the reference's sequential fold (OR is
associative and every op re-encrypts through a bootstrap); only the order
of the ops differs.
"""

from __future__ import annotations

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh

from fhe_regex_tpu_torch.ops.pbs import DeviceServerKey, make_pbs_core, wrap_i32
from fhe_regex_tpu_torch.parallel.mesh import check_key_device, mesh_rank


def ring_shift(x: torch.Tensor, shift: int, mesh: DeviceMesh) -> torch.Tensor:
    """The ``x`` of rank (i - shift) mod D, on rank i of the mesh."""
    D = mesh.size()
    if shift % D == 0:
        return x.clone()
    group, r = mesh.get_group(), mesh_rank(mesh)
    recv = torch.empty_like(x)
    ops = [dist.P2POp(dist.isend, x.contiguous(),
                      dist.get_global_rank(group, (r + shift) % D), group),
           dist.P2POp(dist.irecv, recv,
                      dist.get_global_rank(group, (r - shift) % D), group)]
    for req in dist.batch_isend_irecv(ops):
        req.wait()
    return recv


def or_tree_across_devices(dev_key: DeviceServerKey, mesh: DeviceMesh):
    """Build fn(luts, or_lut_idx, bits) -> the OR of every rank's bits.

    ``bits``: this rank's [1, n+1] partial-OR ciphertext (int32 bits at 32
    bits, int64 at 64), on its device; ``or_lut_idx`` the row of ``luts``
    holding the OR2 test polynomial.  Returns [1, n+1], the full OR, on
    every rank.
    """
    check_key_device(dev_key, mesh)
    pbs = make_pbs_core(dev_key)
    wide = dev_key.params.torus_bits == 64
    D = mesh.size()

    def reduce_fn(luts, or_lut_idx, bits):
        idx = torch.full((bits.shape[0],), int(or_lut_idx), dtype=torch.int32,
                         device=bits.device)
        acc = bits
        for r in range(max(1, (D - 1).bit_length())):
            recv = ring_shift(acc, 1 << r, mesh)
            x = acc.to(torch.int64) + 2 * recv.to(torch.int64)  # LUT(a + 2b)
            acc = pbs(luts, idx, x if wide else wrap_i32(x))
        return acc

    return reduce_fn
