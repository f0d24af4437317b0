"""Device mesh + sharded PBS execution (SPMD, one process per card).

The PyTorch twin of ``fhe_regex_tpu/parallel/mesh.py``.  Where the JAX
package shards a level's PBS batch with ``shard_map`` over one process's
devices, here every rank of a process group runs the same program on the
same inputs, with the same keys from the same seed and the same
(replicated) slab.  A level's batch of W rows, W a multiple of the mesh
size D, is cut into D contiguous row blocks; rank r bootstraps block r,
and an all-gather in rank order (JAX's ``tiled=True`` concatenation)
rebuilds the level's outputs on every rank.  The sharding only splits
exact integer work, so the bits are those of one card.

The mesh is a 1-D ``torch.distributed.device_mesh.DeviceMesh`` named
``BATCH_AXIS`` over the first D ranks of the initialised process group:
NCCL on CUDA (each rank on its own card), gloo on the CPU.  Every rank
builds the same meshes in the same order (``DeviceMesh`` creates its
process groups collectively).
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh

from fhe_regex_tpu_torch.ops.mv import make_mv_finish_core, make_mv_rotate_core
from fhe_regex_tpu_torch.ops.pbs import DeviceServerKey, make_pbs_core

BATCH_AXIS = "batch"


def make_1d_mesh(n_devices: Optional[int], axis: str) -> DeviceMesh:
    """A 1-D mesh named ``axis`` over the first ``n_devices`` ranks (None:
    all of them) of the initialised process group, on CUDA under NCCL and
    on the CPU otherwise.  Asking for more ranks than the group holds
    raises ValueError: a silently smaller mesh changes what the
    collectives compute (an OR-tree over one rank is the identity)."""
    if not (dist.is_available() and dist.is_initialized()):
        raise RuntimeError(
            "no process group: call fhe_regex_tpu_torch.parallel.multihost"
            ".initialize() (or torch.distributed.init_process_group) on "
            "every rank before building a mesh")
    world = dist.get_world_size()
    n = world if n_devices is None else int(n_devices)
    if not 1 <= n <= world:
        raise ValueError(
            f"requested a {n}-device mesh but the process group has "
            f"{world} rank(s) (start one process per card, e.g. torchrun "
            f"--nproc-per-node=N)")
    device_type = "cuda" if dist.get_backend() == "nccl" else "cpu"
    return DeviceMesh(device_type, list(range(n)), mesh_dim_names=(axis,))


def make_mesh(n_devices: Optional[int] = None) -> DeviceMesh:
    """The batch mesh over the first ``n_devices`` ranks (``make_1d_mesh``)."""
    return make_1d_mesh(n_devices, BATCH_AXIS)


def mesh_rank(mesh: DeviceMesh) -> int:
    """This rank's index on the 1-D mesh; a rank outside it raises."""
    coord = mesh.get_coordinate()
    if coord is None:
        raise ValueError(f"rank {dist.get_rank()} is not in the mesh "
                         f"{mesh.mesh.tolist()}")
    return int(coord[0])


def mesh_device(mesh: DeviceMesh) -> torch.device:
    """The device this rank computes on under ``mesh``: its card (the
    current CUDA device) under NCCL, the CPU under gloo."""
    return indexed(mesh.device_type)


def indexed(device: "torch.device | str") -> torch.device:
    """``device`` with a bare "cuda" read as the current card."""
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        return torch.device("cuda", torch.cuda.current_device())
    return device


def check_key_device(dev_key: DeviceServerKey, mesh: DeviceMesh) -> None:
    want = mesh_device(mesh)
    if indexed(dev_key.device) != want:
        raise ValueError(f"the server key is on {dev_key.device}, but this "
                         f"rank computes on {want} under the mesh")


def local_block(x: torch.Tensor, mesh: DeviceMesh) -> torch.Tensor:
    """This rank's contiguous block of the rows of ``x``."""
    D, W = mesh.size(), x.shape[0]
    if W % D:
        raise ValueError(
            f"a batch of {W} rows does not split over a {D}-rank mesh: "
            f"level widths and run_many launches must be multiples of the "
            f"mesh size (compile with min_bucket >= {D})")
    w = W // D
    r = mesh_rank(mesh)
    return x[r * w:(r + 1) * w]


def all_gather_rows(local: torch.Tensor, mesh: DeviceMesh) -> torch.Tensor:
    """Every rank's block, concatenated in rank order, on every rank."""
    out = torch.empty((mesh.size() * local.shape[0],) + tuple(local.shape[1:]),
                      dtype=local.dtype, device=local.device)
    dist.all_gather_into_tensor(out, local.contiguous(),
                                group=mesh.get_group())
    return out


def make_sharded_pbs_core(dev_key: DeviceServerKey, mesh: DeviceMesh):
    """(luts, lut_idx, cts) -> cts_out, the contract of
    ``ops.pbs.make_pbs_core`` with the batch sharded over ``mesh``: this
    rank bootstraps its row block of cts (on the LUTs its block of lut_idx
    selects), and the blocks are all-gathered.  The key is replicated: the
    one the rank prepared on its own device."""
    check_key_device(dev_key, mesh)
    core = make_pbs_core(dev_key)

    def sharded(luts, lut_idx, cts):
        idx, x = local_block(lut_idx, mesh), local_block(cts, mesh)
        return all_gather_rows(core(luts, idx, x), mesh)

    return sharded


# the JAX package's name for the same function (its core form takes the
# key as jit arguments; here the key is never an argument)
make_sharded_pbs_fn = make_sharded_pbs_core


def make_sharded_mv_rotate_core(dev_key: DeviceServerKey, mesh: DeviceMesh):
    """(vlut, rot_cts) -> accumulators, the multi-value rotations with the
    rotation batch sharded and the accumulators all-gathered (a leader may
    name any rotation row)."""
    check_key_device(dev_key, mesh)
    rotate = make_mv_rotate_core(dev_key)

    def sharded(vlut, rot_cts):
        return all_gather_rows(rotate(vlut, local_block(rot_cts, mesh)), mesh)

    return sharded


def make_sharded_mv_finish_core(dev_key: DeviceServerKey, mesh: DeviceMesh):
    """(accs, weights, leader, positions=None) -> outputs: the op batch
    sharded, the accumulators replicated; leaders index the GLOBAL rotation
    rows."""
    check_key_device(dev_key, mesh)
    finish = make_mv_finish_core(dev_key)

    def sharded(accs, weights, leader, positions=None):
        out = finish(accs, local_block(weights, mesh),
                     local_block(leader, mesh), positions)
        return all_gather_rows(out, mesh)

    return sharded


def make_sharded_mv_core(dev_key: DeviceServerKey, mesh: DeviceMesh):
    """(vlut, weights, leader, rot_cts, positions=None) -> outputs, the
    contract of ``ops.mv.make_mv_core`` with both batches sharded: each
    rank rotates its block of the deduped rotations, the accumulators are
    all-gathered, and each rank derives its block of the op outputs from
    them, which are all-gathered in turn."""
    rotate = make_sharded_mv_rotate_core(dev_key, mesh)
    finish = make_sharded_mv_finish_core(dev_key, mesh)

    def sharded(vlut, weights, leader, rot_cts, positions=None):
        return finish(rotate(vlut, rot_cts), weights, leader, positions)

    return sharded
