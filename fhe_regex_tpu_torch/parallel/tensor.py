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

The JAX package compiles the bootstrap (mod switch, the n steps with their
all-reduces, sample extract, keyswitch) into one program.  Here, on a
CUDA device, it is captured once per input shape as one CUDA graph and
replayed (``default_tp_graph``), so the host enqueues no step.
"""

from __future__ import annotations

import collections
import threading
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
from fhe_regex_tpu_torch.utils.cuda_graph import CapturedBody, forced_fuse

TP_AXIS = "tp"


def make_tp_mesh(n_devices: Optional[int] = None) -> DeviceMesh:
    """The row mesh over the first ``n_devices`` ranks (``make_1d_mesh``)."""
    return make_1d_mesh(n_devices, TP_AXIS)


# Input shapes whose captured bootstrap one ``make_tp_pbs_fn`` function
# keeps, least recently called dropped first (each holds its static
# inputs and output and the graph's private pool).  Six holds every batch
# width the executor launches, the powers of two from its smallest level
# bucket, 8, to MAX_LEVEL_BATCH, 256, under one LUT table.
MAX_TP_GRAPHS = 6


def default_tp_graph(device: "torch.device | str", world: int) -> bool:
    """Whether ``make_tp_pbs_fn``'s function runs its bootstrap as one CUDA
    graph: on a CUDA device at a mesh of one rank (``world``; no graph with
    collectives across cards has run yet, the rule of
    ``regex.executor.default_fuse``), FHE_REGEX_FUSE_LEVELS=0|1 forcing it
    either way there; never on the CPU, which runs the step loop."""
    if torch.device(device).type != "cuda":
        return False
    forced = forced_fuse()
    return world <= 1 if forced is None else forced


def _blind_rotate_rowsharded(params: Params, bsk_local, luts, lut_idx,
                             cts_ms, mesh: DeviceMesh) -> torch.Tensor:
    """Blind rotation with this rank's row block of every GGSW.

    bsk_local [n, rows/D, k+1, N]; the accumulator and the digits are
    replicated; each step ends in an all-reduce of the [B, k+1, N] partial
    updates.  Every buffer the steps reuse is made before the loop, and no
    step reads a value back to the host, so the loop can be captured."""
    n, R = params.lwe_dimension, bsk_local.shape[1]
    rows = (params.glwe_dimension + 1) * params.pbs_level
    r0 = mesh_rank(mesh) * R
    group = mesh.get_group()
    acc = init_accumulator(params, luts, lut_idx, cts_ms)
    zero = torch.zeros_like(acc)
    total = torch.empty(acc.shape, dtype=I64, device=acc.device)
    block = (None if R == rows else torch.empty(
        (acc.shape[0], R, acc.shape[2]), dtype=torch.int8, device=acc.device))
    a_steps = cts_ms[:, :n].T.contiguous()                        # [n, B]
    for i in range(n):
        digits = pbs_cuda.stage1_digits(params, acc, a_steps[i])
        if block is not None:
            digits = block.copy_(digits[:, r0:r0 + R])
        total.copy_(pbs_cuda.external_product_rows(params, digits,
                                                   bsk_local[i], zero))
        dist.all_reduce(total, group=group)                 # exact in int64
        acc = wrap_i32(total.add_(acc))
    return acc


class _TpGraph(CapturedBody):
    """One input shape's bootstrap as a ``CapturedBody`` over static
    inputs (copies of the first call's) and a static output, [B, n+1] as
    the ciphertexts in."""

    def __init__(self, bootstrap, inputs):
        self.inputs = tuple(x.clone() for x in inputs)
        self.out = torch.empty_like(self.inputs[2])
        self.bootstrap = bootstrap
        super().__init__(self._body, self.out.device)

    def _body(self) -> None:
        self.out.copy_(self.bootstrap(*self.inputs))


def make_tp_pbs_fn(params: Params, server_key, mesh: DeviceMesh):
    """(luts, lut_idx, cts) -> cts_out with the external product's row axis
    sharded over ``mesh`` (32-bit torus).  ``server_key`` is the host key;
    this rank uploads only its row block of the bootstrap key, to its
    device.  Inputs may be tensors anywhere or numpy arrays (int32 bits);
    the output is on the rank's device, the same on every rank.

    On the CPU the function runs mod switch, the n-step loop, sample
    extract and keyswitch eagerly.  On a CUDA device, by default at a mesh
    of one rank (``default_tp_graph``; FHE_REGEX_FUSE_LEVELS=0|1 forces it
    either way), it runs them as one CUDA graph, the counterpart of the
    JAX package's one ``shard_map`` program: the first call with an input
    shape copies its inputs into static buffers, makes the warm-up pass
    that gives its result and captures (``utils.cuda_graph``); later calls
    of that shape copy their inputs in and replay.  The graphs of the last
    ``MAX_TP_GRAPHS`` shapes are kept, by shape, in ``fn.graphs``; calls
    that take the graph take turns on its static buffers under one lock.

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

    def bootstrap(luts, lut_idx, cts):
        acc = _blind_rotate_rowsharded(params, bsk, luts, lut_idx,
                                       mod_switch(params, cts), mesh)
        return key_switch(params, ksk, sample_extract(params, acc))

    graphs: "collections.OrderedDict[tuple, _TpGraph]" = (
        collections.OrderedDict())
    lock = threading.Lock()

    def fn(luts, lut_idx, cts):
        x = tuple(torch.as_tensor(a).to(device, torch.int32)
                  for a in (luts, lut_idx, cts))
        if not default_tp_graph(device, D):
            return bootstrap(*x)
        shape = tuple(tuple(a.shape) for a in x)
        with lock:
            entry = graphs.get(shape)
            if entry is None:
                entry = graphs[shape] = _TpGraph(bootstrap, x)
                while len(graphs) > MAX_TP_GRAPHS:
                    graphs.popitem(last=False)
            else:
                for static, a in zip(entry.inputs, x):
                    static.copy_(a)
            graphs.move_to_end(shape)
            entry.launch()
            return entry.out.clone()

    fn.graphs = graphs
    return fn
