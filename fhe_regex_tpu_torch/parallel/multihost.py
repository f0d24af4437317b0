"""Multi-process launch: one process per card, on one host or many.

The PyTorch twin of ``fhe_regex_tpu/parallel/multihost.py``.  Every
process runs the same script: open the process group, build one mesh over
all of its ranks, and run the identical ``has_match(..., mesh=mesh)``;
each level's bootstraps split over the ranks (``parallel/mesh.py``).

    torchrun --nproc-per-node=<cards> script.py

    from fhe_regex_tpu_torch.parallel.multihost import initialize, global_mesh
    initialize()                 # env:// as torchrun sets it, or explicit
                                 # coordinator/num_processes/process_id
    mesh = global_mesh()
    res = has_match(server_key, ct_content, pattern, mesh=mesh)

The group is NCCL when CUDA is present (each rank on the card its
``LOCAL_RANK`` names) and gloo on a machine without it, where the entry
points take ``device="cpu"``.
"""

from __future__ import annotations

import os
from typing import Optional

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh

from fhe_regex_tpu_torch.parallel.mesh import make_mesh


def initialize(coordinator_address: Optional[str] = None,
               num_processes: Optional[int] = None,
               process_id: Optional[int] = None) -> None:
    """``dist.init_process_group`` for this process: NCCL with CUDA, gloo
    without.  No arguments: ``env://`` (MASTER_ADDR, MASTER_PORT,
    WORLD_SIZE, RANK, as torchrun sets them); ``coordinator_address``
    ("host:port", rank 0's): ``tcp://`` with ``num_processes`` ranks, this
    one ``process_id``.  With CUDA the rank's card is ``LOCAL_RANK`` (else
    ``process_id`` modulo the cards of the host)."""
    cuda = torch.cuda.is_available()
    if cuda:
        local = os.environ.get("LOCAL_RANK")
        card = (int(local) if local is not None
                else (process_id or 0) % torch.cuda.device_count())
        torch.cuda.set_device(card)
    backend = "nccl" if cuda else "gloo"
    if coordinator_address is None:
        dist.init_process_group(backend, init_method="env://")
    else:
        dist.init_process_group(backend,
                                init_method=f"tcp://{coordinator_address}",
                                world_size=num_processes, rank=process_id)


def global_mesh() -> DeviceMesh:
    """One batch mesh over every rank of every host."""
    return make_mesh(None)
