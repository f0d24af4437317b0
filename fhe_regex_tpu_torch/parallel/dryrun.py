"""One sharded step of every multi-GPU path, decrypt-checked.

The counterpart of the JAX package's ``__graft_entry__.dryrun_multichip``:
every rank of an initialised process group calls ``dryrun_multichip(D)``
with the same arguments, and over a mesh of the first D ranks it runs

  * a batched PBS with the batch sharded (``make_sharded_pbs_fn``);
  * the homomorphic OR-tree across the ranks, one 1-bit on the last rank;
  * tensor parallelism inside one bootstrap on the largest divisor of the
    (k+1)*l GGSW rows that is at most D;
  * a multi-value ``has_match`` with the mesh (rotations and derived
    extracts sharded),

each checked by decryption, on this rank's device (its card under NCCL,
the CPU under gloo) and that device's default backend.
"""

from __future__ import annotations

import numpy as np
import torch


def _expect(what: str, got, want) -> None:
    if got != want:
        raise AssertionError(f"dryrun_multichip {what}: decrypted {got}, "
                             f"want {want}")


def dryrun_multichip(n_devices: int, keys=None) -> str:
    """Run the dryrun over the first ``n_devices`` ranks; returns its
    summary line.  ``keys`` (client key, server key) of any 32-bit set;
    default: TEST_PARAMS_NOISY keys from seed 5."""
    import fhe_regex_tpu_torch as port
    from fhe_regex_tpu_torch.crypto import lwe
    from fhe_regex_tpu_torch.crypto.csprng import Csprng
    from fhe_regex_tpu_torch.crypto.golden import make_lut_poly
    from fhe_regex_tpu_torch.ops.luts import LUT_OR2, lut_fn
    from fhe_regex_tpu_torch.ops.pbs import prepare_server_key
    from fhe_regex_tpu_torch.params import TEST_PARAMS_NOISY
    from fhe_regex_tpu_torch.parallel.collective import or_tree_across_devices
    from fhe_regex_tpu_torch.parallel.mesh import (make_mesh,
                                                   make_sharded_pbs_fn,
                                                   mesh_device, mesh_rank)
    from fhe_regex_tpu_torch.parallel.tensor import (make_tp_mesh,
                                                     make_tp_pbs_fn)

    mesh = make_mesh(n_devices)
    D, rank, device = mesh.size(), mesh_rank(mesh), mesh_device(mesh)
    ck, sk = keys if keys is not None else port.gen_keys(TEST_PARAMS_NOISY,
                                                         seed=5)
    P = sk.params
    dev_key = prepare_server_key(P, sk, device)

    def up(a):
        return torch.from_numpy(np.ascontiguousarray(a).view(np.int32)
                                ).to(device)

    def dec(t):
        o = t.cpu().numpy().view(np.uint32)
        return [lwe.decrypt_lwe(P, ck.lwe_key, o[i]) for i in range(len(o))]

    luts = up(np.stack([make_lut_poly(P, lambda x: x),
                        make_lut_poly(P, lut_fn(LUT_OR2))]))
    B = 4 * D
    # the same ciphertexts on every rank: the encryption stream of a seed
    rng = Csprng(11)
    cts = np.stack([lwe.encrypt_lwe(P, ck.lwe_key, i % 2, rng)
                    for i in range(B)])
    out = make_sharded_pbs_fn(dev_key, mesh)(
        luts, torch.zeros(B, dtype=torch.int32, device=device), up(cts))
    _expect("sharded PBS", dec(out), [i % 2 for i in range(B)])

    bits = up(lwe.trivial_lwe(P, 1 if rank == D - 1 else 0)[None])
    reduced = or_tree_across_devices(dev_key, mesh)(luts, 1, bits)
    ors = dec(reduced)
    _expect("OR-tree", ors, [1])

    rows = (P.glwe_dimension + 1) * P.pbs_level
    tp_n = max(d for d in range(1, D + 1) if rows % d == 0)
    tp_mesh = make_tp_mesh(tp_n)
    if rank < tp_n:
        tp_out = make_tp_pbs_fn(P, sk, tp_mesh)(
            luts, torch.zeros(4, dtype=torch.int32), up(cts[:4]))
        _expect(f"TP over {tp_n}", dec(tp_out), [i % 2 for i in range(4)])

    res = port.has_match(sk, port.trivial_encrypt_str(P, "bd"), "/^[a-d]d$/",
                         device=device, mesh=mesh, multivalue=True)
    _expect("multi-value has_match", port.decrypt(ck, res), 1)
    line = (f"dryrun_multichip OK: {D} rank(s) on {device}, {P.name}, "
            f"batch {B} sharded, or-tree -> {ors}, tp@{tp_n} ok, sharded "
            f"multi-value has_match ok")
    print(line, flush=True)
    return line


if __name__ == "__main__":
    # torchrun --nproc-per-node=N -m fhe_regex_tpu_torch.parallel.dryrun
    import torch.distributed as dist

    from fhe_regex_tpu_torch.parallel.multihost import initialize

    initialize()
    try:
        dryrun_multichip(dist.get_world_size())
    finally:
        dist.destroy_process_group()
