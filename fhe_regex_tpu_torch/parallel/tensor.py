"""Tensor parallelism INSIDE one bootstrap: the GGSW rows sharded.

The PyTorch twin of ``fhe_regex_tpu/parallel/tensor.py``.  Each CMUX step's
external product contracts (k+1)*l digit rows with the step's GGSW; under
a mesh of D ranks each rank keeps only its rows/D rows of every GGSW (the
bootstrap key's memory divides by D), contracts its row block of the
(replicated) digits into a zero accumulator, and an all-reduce of the
partial sums rebuilds the step's update on every rank.  The accumulator,
its rotation and decomposition (the digit pass), the sample extract and
the keyswitch are replicated.

On CUDA a step is the digit pass ``pbs_cuda.stage1_digits`` (#2) and the
external product over the rank's rows, ``pbs_cuda.external_product_rows``
(#1's device code); on the CPU their plain versions.  The partials are
summed as int64 and wrapped mod 2^32, which is exact in any order, so the
bits equal one card's.  32-bit torus only, as in the JAX package.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh

from fhe_regex_tpu_torch.ops import pbs_cuda
from fhe_regex_tpu_torch.ops.pbs import (I64, init_accumulator, key_switch,
                                         mod_switch, prepare_ksk,
                                         sample_extract, wrap_i32)
from fhe_regex_tpu_torch.params import Params
from fhe_regex_tpu_torch.parallel.mesh import (make_1d_mesh, mesh_device,
                                               mesh_rank)

TP_AXIS = "tp"


def make_tp_mesh(n_devices: Optional[int] = None) -> DeviceMesh:
    """The row mesh over the first ``n_devices`` ranks (``make_1d_mesh``)."""
    return make_1d_mesh(n_devices, TP_AXIS)


def _blind_rotate_rowsharded(params: Params, bsk_local, luts, lut_idx,
                             cts_ms, mesh: DeviceMesh) -> torch.Tensor:
    """Blind rotation with this rank's row block of every GGSW.

    bsk_local [n, rows/D, k+1, N]; the accumulator and the digits are
    replicated; each step ends in an all-reduce of the [B, k+1, N] partial
    updates."""
    n = params.lwe_dimension
    R = bsk_local.shape[1]
    r0 = mesh_rank(mesh) * R
    group = mesh.get_group()
    acc = init_accumulator(params, luts, lut_idx, cts_ms)
    zero = torch.zeros_like(acc)
    a_steps = cts_ms[:, :n].T.contiguous()                        # [n, B]
    for i in range(n):
        digits = pbs_cuda.stage1_digits(params, acc, a_steps[i])
        part = pbs_cuda.external_product_rows(
            params, digits[:, r0:r0 + R].contiguous(), bsk_local[i], zero)
        total = part.to(I64)
        dist.all_reduce(total, group=group)                 # exact in int64
        acc = wrap_i32(acc.to(I64) + total)
    return acc


def make_tp_pbs_fn(params: Params, server_key, mesh: DeviceMesh):
    """(luts, lut_idx, cts) -> cts_out with the external product's row axis
    sharded over ``mesh`` (32-bit torus).  ``server_key`` is the host key;
    this rank uploads only its row block of the bootstrap key, to its
    device.  Inputs may be tensors anywhere or numpy arrays (int32 bits);
    the output is on the rank's device, the same on every rank.

    Requires (k+1)*pbs_level % mesh size == 0 (6 rows at the production
    set: meshes of 1, 2, 3 or 6 ranks)."""
    rows = (params.glwe_dimension + 1) * params.pbs_level
    D = mesh.size()
    if rows % D != 0:
        raise ValueError(f"rows={rows} not divisible by mesh size {D}")
    if params.torus_bits != 32:
        raise ValueError("tensor parallelism runs at 32 bits only")
    device = mesh_device(mesh)
    R = rows // D
    r0 = mesh_rank(mesh) * R
    bsk = torch.from_numpy(np.ascontiguousarray(
        np.asarray(server_key.bsk)[:, r0:r0 + R]).view(np.int32)).to(device)
    ksk = prepare_ksk(torch.from_numpy(np.ascontiguousarray(
        server_key.ksk).view(np.int32)).to(device))

    def fn(luts, lut_idx, cts):
        luts, lut_idx, cts = (torch.as_tensor(x).to(device, torch.int32)
                              for x in (luts, lut_idx, cts))
        acc = _blind_rotate_rowsharded(params, bsk, luts, lut_idx,
                                       mod_switch(params, cts), mesh)
        return key_switch(params, ksk, sample_extract(params, acc))

    return fn
