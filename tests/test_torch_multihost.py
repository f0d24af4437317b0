"""Multi-process launch of the PyTorch port (``parallel/multihost.py``): the
counterpart of ``tests/test_multihost.py``.

Two OS processes run this file as a script, open one gloo process group
through ``multihost.initialize`` (``env://`` as torchrun sets it, or an
explicit ``tcp://`` coordinator), build ``global_mesh()`` over both, and
run the executor pipeline in SPMD: ``has_match`` (multi-value, rotations
and derived extracts sharded) and ``Executor.run_many``, then the OR-tree
across the two ranks.  Every rank decrypts and checks every result, and
both ranks must hold the same ciphertexts.  The ranks never import jax.
"""

import os
import socket
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

ROOT = Path(__file__).resolve().parents[1]
NPROC = 2
LAUNCHES = ("env", "tcp")


def _rank_main(launch: str, rank: int, port: str, output: str) -> None:
    import torch

    torch.set_num_threads(1)
    import fhe_regex_tpu_torch as port_
    from fhe_regex_tpu_torch.crypto import lwe
    from fhe_regex_tpu_torch.crypto.golden import make_lut_poly
    from fhe_regex_tpu_torch.ops.luts import LUT_OR2, lut_fn
    from fhe_regex_tpu_torch.ops.pbs import prepare_server_key
    from fhe_regex_tpu_torch.params import get_params
    from fhe_regex_tpu_torch.parallel.collective import or_tree_across_devices
    from fhe_regex_tpu_torch.parallel.multihost import global_mesh, initialize
    from fhe_regex_tpu_torch.regex.engine import compile_match
    from fhe_regex_tpu_torch.regex.executor import Executor, compile_circuit

    if launch == "env":
        os.environ.update(MASTER_ADDR="127.0.0.1", MASTER_PORT=port,
                          WORLD_SIZE=str(NPROC), RANK=str(rank),
                          LOCAL_RANK=str(rank))
        initialize()
    else:
        initialize(coordinator_address=f"127.0.0.1:{port}",
                   num_processes=NPROC, process_id=rank)
    import torch.distributed as dist

    mesh = global_mesh()
    ok = mesh.size() == NPROC
    P = get_params("TEST_PARAMS_NOISY")
    ck, sk = port_.gen_keys(P, seed=11)    # the same keys on every rank
    out = {}
    for i, (content, want) in enumerate((("bd", 1), ("ad", 0))):
        res = port_.has_match(sk, port_.trivial_encrypt_str(P, content),
                              "/^[a-d]d$/", device="cpu", mesh=mesh,
                              multivalue=True)
        out[f"has_match{i}"] = res
        ok &= port_.decrypt(ck, res) == want   # "ad": Q1, [a-d] excludes a

    contents = ["xabc", "abcd", "xxxx", "abca"]
    cts = np.stack([port_.trivial_encrypt_str(P, c) for c in contents])
    builder, root = compile_match(4, "/ab?c/", P.num_blocks, fold="tree")
    circuit = compile_circuit(P, builder, root, min_bucket=mesh.size())
    dk = prepare_server_key(P, sk, "cpu")
    out["run_many"] = Executor(P, dk, mesh=mesh).run_many(circuit, cts)
    ok &= [port_.decrypt(ck, r) for r in out["run_many"]] == [1, 1, 0, 1]

    luts = np.stack([make_lut_poly(P, lambda x: x),
                     make_lut_poly(P, lut_fn(LUT_OR2))]).view(np.int32)
    bit = lwe.trivial_lwe(P, 1 if rank == NPROC - 1 else 0)[None]
    reduced = or_tree_across_devices(dk, mesh)(
        torch.from_numpy(luts), 1, torch.from_numpy(bit.view(np.int32)))
    ok &= lwe.decrypt_lwe(P, ck.lwe_key,
                          reduced.numpy().view(np.uint32)[0]) == 1
    dist.barrier()
    dist.destroy_process_group()
    out["ok"] = np.array(ok)
    out["jax_loaded"] = np.array(any(m == "jax" or m.startswith(
        ("jax.", "fhe_regex_tpu.")) or m == "fhe_regex_tpu"
        for m in sys.modules))
    np.savez(output, **out)
    print(f"MULTIHOST_OK launch={launch} rank={rank} ranks={mesh.size()} "
          f"ok={ok} pipeline=has_match+run_many+or_tree", flush=True)


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


@pytest.fixture(scope="module")
def launched(tmp_path_factory):
    """Both launches' worlds, started at once: {launch: (procs, outputs)}."""
    tmp = tmp_path_factory.mktemp("multihost")
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="", OMP_NUM_THREADS="1",
               PYTHONPATH=str(ROOT))
    worlds = {}
    for launch in LAUNCHES:
        port = str(_free_port())
        outs = [tmp / f"{launch}{r}.npz" for r in range(NPROC)]
        procs = [subprocess.Popen(
            [sys.executable, __file__, launch, str(r), port, str(outs[r])],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
            env=env, cwd=str(tmp)) for r in range(NPROC)]
        worlds[launch] = (procs, outs)
    yield worlds
    for procs, _ in worlds.values():
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()


@pytest.mark.parametrize("launch", LAUNCHES)
def test_two_process_has_match_run_many_and_or_tree(launch, launched):
    procs, outs = launched[launch]
    logs = [p.communicate(timeout=300)[0] for p in procs]
    for r, (p, log) in enumerate(zip(procs, logs)):
        assert p.returncode == 0, f"rank {r} failed:\n{log}"
        assert (f"MULTIHOST_OK launch={launch} rank={r} ranks={NPROC} "
                f"ok=True pipeline=has_match+run_many+or_tree") in log, log
    got = [dict(np.load(o)) for o in outs]
    for name in ("has_match0", "has_match1", "run_many"):
        assert np.array_equal(got[0][name], got[1][name]), name
    assert not any(bool(g["jax_loaded"]) for g in got)


if __name__ == "__main__":
    sys.path.insert(0, str(ROOT))
    _rank_main(sys.argv[1], int(sys.argv[2]), sys.argv[3], sys.argv[4])
