"""Multi-GPU execution of the PyTorch port (``fhe_regex_tpu_torch.parallel``)
against the JAX package's mesh, on the CPU over gloo.

Each world is D processes that run this file as a script, meet through a
``file://`` rendezvous in the test's temporary directory (parallel test
workers never race for a port), build the port's keys from the seeds the
JAX side uses, read the same inputs (made here with numpy and the JAX
package's encryption), and write their outputs to an ``.npz``.  The
parent computes the same thing with the JAX package on the conftest's
8-device virtual mesh and asserts bit equality (tolerance zero: every path
is exact integer arithmetic) for

* the sharded PBS on ``torch`` and on ``fft``, and one multi-value level
  through the sharded multi-value core (D = 2, 4);
* ``has_match`` on the mesh, and ``Executor.run_many`` on the mesh in both
  launch plans and both PBS plans, at 32 and at 64 bits (D = 2, 4);
* the OR-tree across the ranks (D = 2, 4);
* tensor parallelism inside one bootstrap (D = 2, 3, 6);

and that the port refuses what the JAX package refuses: a mesh larger than
the world, TP over a mesh that does not divide the GGSW rows, a batch that
does not split over the mesh.  The ranks never import jax.
"""

import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]

BATCH_WORLDS = (2, 4)      # the batch mesh
TP_WORLDS = (2, 3, 6)      # tensor parallelism (the 6 GGSW rows divide)
WORLDS = (2, 3, 4, 6)
RANK_TIMEOUT = 240

HAS_MATCH = [("cdaabc", "/a*bc/", 1), ("abcd", "/^ab|cd$/", 0),
             ("Ab", "/ab/i", 1)]
MANY = (["xxabcxxx", "xxaqcxxx", "abcabcab", "xxxxxxxx"], "/abc/",
        [1, 0, 1, 0])
MANY64 = (["bq", "xq", "dd", "ab"], "/^[a-d][^xyz]$/i", [1, 0, 1, 0])
TP_MSGS = [0, 1, 7, 15, 9, 4, 2, 11]
RUN_MANY_CASES = [(mv, wide) for mv in (False, True) for wide in (False, True)]


def _pbs_fn(x):
    return (x + 5) % 16


def _tp_fn(x):
    return (x * 5 + 3) % 16


# ---------------- the ranks (this file run as a script) ----------------


def _refused(fn) -> str:
    """The ValueError message ``fn`` raises, or "" if it runs."""
    try:
        fn()
    except ValueError as e:
        return str(e) or "ValueError"
    return ""


def _rank_work(rank: int, D: int, inp) -> dict:
    import torch.distributed as dist

    import fhe_regex_tpu_torch as port
    from fhe_regex_tpu_torch.ops.mv import mv_lut_table
    from fhe_regex_tpu_torch.ops.pbs import prepare_server_key
    from fhe_regex_tpu_torch.params import get_params
    from fhe_regex_tpu_torch.parallel.collective import or_tree_across_devices
    from fhe_regex_tpu_torch.parallel.mesh import (make_mesh,
                                                   make_sharded_mv_core,
                                                   make_sharded_pbs_fn)
    from fhe_regex_tpu_torch.parallel.tensor import (make_tp_mesh,
                                                     make_tp_pbs_fn)
    from fhe_regex_tpu_torch.regex.engine import compile_match
    from fhe_regex_tpu_torch.regex.executor import Executor, compile_circuit

    def t(name):
        return torch.from_numpy(np.ascontiguousarray(inp[name]))

    P, PN, P64 = (get_params(n) for n in ("TEST_PARAMS", "TEST_PARAMS_NOISY",
                                          "TEST_PARAMS_64"))
    ck, sk = port.gen_keys(P, seed=42)
    out = {"rank": np.array(rank)}
    tp_mesh = make_tp_mesh(D)        # every rank builds every mesh
    if D in TP_WORLDS:
        out["tp"] = make_tp_pbs_fn(P, sk, tp_mesh)(
            t("tp_luts"), t("tp_idx"), t("tp_cts")).numpy()
    else:
        out["tp_refused"] = np.array(_refused(
            lambda: make_tp_pbs_fn(P, sk, tp_mesh)))
    if D not in BATCH_WORLDS:
        return out

    mesh = make_mesh(D)
    out["oversize_refused"] = np.array(_refused(lambda: make_mesh(D + 1)))
    dk = prepare_server_key(P, sk, "cpu", "torch")
    pbs = make_sharded_pbs_fn(dk, mesh)
    out["pbs"] = pbs(t("luts"), t("idx"), t("cts")).numpy()
    ragged = 2 * D - 1
    out["ragged_refused"] = np.array(_refused(lambda: pbs(
        t("luts"), t("idx")[:ragged], t("cts")[:ragged])))
    _, nsk = port.gen_keys(PN, seed=43)
    out["pbs_fft"] = make_sharded_pbs_fn(
        prepare_server_key(PN, nsk, "cpu", "fft"), mesh)(
            t("fft_luts"), t("idx"), t("fft_cts")).numpy()
    out["mv_core"] = make_sharded_mv_core(dk, mesh)(
        mv_lut_table(P), t("mv_weights"), t("mv_leader"), t("mv_rot_cts"),
        tuple(int(v) for v in inp["mv_positions"])).numpy()
    for i, (content, pattern, _) in enumerate(HAS_MATCH):
        out[f"has_match{i}"] = port.has_match(
            sk, port.trivial_encrypt_str(P, content), pattern, engine="python",
            device="cpu", mesh=mesh)
    # the device is the mesh's: another one, or the CUDA default, raises
    out["device_refused"] = np.array(_refused(
        lambda: port.executor_for(sk, device="cuda", mesh=mesh)))
    try:
        port.executor_for(sk, mesh=mesh)
        out["default_device_refused"] = np.array("")
    except RuntimeError as e:
        out["default_device_refused"] = np.array(str(e))
    ex = port.executor_for(sk, device="cpu", mesh=mesh)
    out["executor_cached"] = np.array(
        ex is port.executor_for(sk, device="cpu", mesh=mesh)
        and ex is not port.executor_for(sk, device="cpu")
        and ex.mesh is mesh)

    contents, pattern, _ = MANY
    builder, root = compile_match(len(contents[0]), pattern, P.num_blocks,
                                  fold="tree")
    cts = np.stack([port.trivial_encrypt_str(P, c) for c in contents])
    mesh_ex = Executor(P, dk, mesh=mesh)
    for mv, wide in RUN_MANY_CASES:
        circuit = compile_circuit(P, builder, root, min_bucket=64,
                                  multivalue=mv)
        out[f"run_many_{mv}_{wide}"] = mesh_ex.run_many(circuit, cts,
                                                        wide_batch=wide)
    # a circuit whose levels are narrower than the mesh is refused
    narrow = compile_circuit(P, *compile_match(2, "/b/", P.num_blocks), 2)
    out["narrow_widths"] = np.array([lv.lut_idx.shape[0]
                                     for lv in narrow.levels])
    out["narrow_refused"] = np.array(_refused(lambda: mesh_ex.run(
        narrow, port.trivial_encrypt_str(P, "ab"))))

    _, sk64 = port.gen_keys(P64, seed=11)
    ex64 = Executor(P64, prepare_server_key(P64, sk64, "cpu", "torch64"),
                    mesh=mesh)
    contents, pattern, _ = MANY64
    cts64 = np.stack([port.trivial_encrypt_str(P64, c) for c in contents])
    for mv in (False, True):
        circuit = compile_circuit(P64, *compile_match(
            2, pattern, P64.num_blocks, fold="tree"), min_bucket=8,
            multivalue=mv)
        out[f"run_many64_{mv}"] = ex64.run_many(circuit, cts64,
                                                wide_batch=False)

    out["or_tree"] = or_tree_across_devices(dk, mesh)(
        t("or_luts"), 1, t(f"or_bits{D}")[rank:rank + 1]).numpy()
    dist.barrier()
    return out


def _rank_main(rank: int, D: int, rendezvous: str, inputs: str,
               output: str) -> None:
    import torch.distributed as dist

    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{rendezvous}",
                            world_size=D, rank=rank)
    try:
        with np.load(inputs) as inp:
            out = _rank_work(rank, D, inp)
    finally:
        dist.destroy_process_group()
    out["jax_loaded"] = np.array(any(m == "jax" or m.startswith(
        ("jax.", "fhe_regex_tpu.")) or m == "fhe_regex_tpu"
        for m in sys.modules))
    np.savez(output, **out)


# ---------------- the parent (pytest) ----------------


def _inputs(keys, noisy_keys) -> dict:
    """Every array the ranks read, from seeds: real encryptions through
    the JAX package's client keys, LUTs and LUT selections."""
    from fhe_regex_tpu.crypto import lwe
    from fhe_regex_tpu.crypto.csprng import Csprng
    from fhe_regex_tpu.crypto.golden import make_lut_poly
    from fhe_regex_tpu.ops.luts import LUT_OR2, lut_fn
    from fhe_regex_tpu.params import TEST_PARAMS, TEST_PARAMS_NOISY
    from fhe_regex_tpu.regex.engine import compile_match
    from fhe_regex_tpu.regex.executor import compile_circuit

    (ck, _), (nck, _) = keys, noisy_keys
    rng = Csprng(2024)

    def enc(P, key, msgs):
        return np.stack([lwe.encrypt_lwe(P, key, m, rng) for m in msgs]
                        ).view(np.int32)

    P, PN = TEST_PARAMS, TEST_PARAMS_NOISY
    B = 16
    # one multi-value level: its op weights, leaders and support positions
    contents, pattern, _ = MANY
    lv = next(lv for lv in compile_circuit(P, *compile_match(
        len(contents[0]), pattern, P.num_blocks, fold="tree"),
        multivalue=True).levels if lv.mv_rot_count > 1)
    R = lv.rot_slots.shape[0]
    return {
        "mv_weights": lv.mv_weights, "mv_leader": lv.mv_leader,
        "mv_positions": np.asarray(lv.mv_positions, np.int64),
        "mv_rot_cts": enc(P, ck.lwe_key, [i % 4 for i in range(R)]),
        "cts": enc(P, ck.lwe_key, [i % 16 for i in range(B)]),
        "luts": make_lut_poly(P, _pbs_fn)[None].view(np.int32),
        "idx": np.zeros(B, np.int32),
        "fft_cts": enc(PN, nck.lwe_key, [i % 16 for i in range(B)]),
        "fft_luts": make_lut_poly(PN, lambda x: (x * 3) % 16)[None].view(
            np.int32),
        "tp_cts": enc(P, ck.lwe_key, TP_MSGS),
        "tp_luts": make_lut_poly(P, _tp_fn)[None].view(np.int32),
        "tp_idx": np.zeros(len(TP_MSGS), np.int32),
        "or_luts": np.stack([make_lut_poly(P, lambda x: x),
                             make_lut_poly(P, lut_fn(LUT_OR2))]).view(
                                 np.int32),
        # per world, one encrypted 1, on its last rank
        **{f"or_bits{D}": enc(P, ck.lwe_key, [0] * (D - 1) + [1])
           for D in BATCH_WORLDS},
    }


class _Worlds:
    """The gloo worlds, all started at once; ``outputs(D)`` waits for
    world D and returns its ranks' outputs in rank order."""

    def __init__(self, tmp: Path, inputs: Path):
        env = dict(os.environ, CUDA_VISIBLE_DEVICES="", OMP_NUM_THREADS="1",
                   PYTHONPATH=str(ROOT))
        self.tmp = tmp
        self.procs = {D: [subprocess.Popen(
            [sys.executable, __file__, str(r), str(D),
             str(tmp / f"rendezvous{D}"), str(inputs),
             str(tmp / f"world{D}_rank{r}.npz")],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
            env=env, cwd=str(tmp)) for r in range(D)] for D in WORLDS}
        self.done = {}

    def outputs(self, D: int) -> list:
        if D not in self.done:
            logs = [p.communicate(timeout=RANK_TIMEOUT)[0]
                    for p in self.procs[D]]
            for r, (p, log) in enumerate(zip(self.procs[D], logs)):
                assert p.returncode == 0, f"world {D} rank {r}:\n{log}"
            self.done[D] = [dict(np.load(self.tmp / f"world{D}_rank{r}.npz"))
                            for r in range(D)]
        return self.done[D]

    def close(self) -> None:
        for procs in self.procs.values():
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.communicate()


@pytest.fixture(scope="module")
def worlds(tmp_path_factory, keys, noisy_keys):
    tmp = tmp_path_factory.mktemp("gloo")
    inp = _inputs(keys, noisy_keys)
    np.savez(tmp / "inputs.npz", **inp)
    w = _Worlds(tmp, tmp / "inputs.npz")
    w.inputs = inp
    yield w
    w.close()


def _replicated(outs, name):
    """The output ``name``, which every rank must hold the same."""
    first = outs[0][name]
    for o in outs[1:]:
        assert np.array_equal(o[name], first), (name, int(o["rank"]))
    return first


@pytest.fixture(scope="module")
def keys64():
    from fhe_regex_tpu.crypto.keys import gen_keys
    from fhe_regex_tpu.params import TEST_PARAMS_64

    return gen_keys(TEST_PARAMS_64, seed=11)


@pytest.fixture(scope="module")
def jax_executor():
    """One JAX Executor per (key, backend, mesh size), so the cases of one
    mesh share its compiled levels."""
    from fhe_regex_tpu.ops.pbs import prepare_server_key
    from fhe_regex_tpu.regex.executor import Executor

    cache = {}

    def get(sk, backend, D):
        key = (id(sk), backend, D)
        if key not in cache:
            cache[key] = Executor(sk.params, prepare_server_key(
                sk.params, sk, backend), mesh=_jax_mesh(D))
        return cache[key]

    return get


def _jax_mesh(D):
    from fhe_regex_tpu.parallel.mesh import make_mesh

    return make_mesh(D)


# the cases with the most JAX work first: the worlds run meanwhile


@pytest.mark.parametrize("D", BATCH_WORLDS)
@pytest.mark.parametrize("mv", (False, True))
def test_run_many_64bit_on_mesh_equals_jax(D, mv, worlds, keys64,
                                           jax_executor):
    import fhe_regex_tpu as J
    from fhe_regex_tpu.regex.engine import compile_match
    from fhe_regex_tpu.regex.executor import compile_circuit

    ck, sk = keys64
    P = sk.params
    contents, pattern, bits = MANY64
    cts = np.stack([J.trivial_encrypt_str(P, c) for c in contents])
    circuit = compile_circuit(P, *compile_match(2, pattern, P.num_blocks,
                                                fold="tree"),
                              min_bucket=8, multivalue=mv)
    want = jax_executor(sk, "jnp64", D).run_many(circuit, cts,
                                                 wide_batch=False)
    got = _replicated(worlds.outputs(D), f"run_many64_{mv}")
    assert got.dtype == np.uint64 and np.array_equal(got, want)
    assert [J.decrypt(ck, r) for r in got] == bits


@pytest.mark.parametrize("mv,wide", RUN_MANY_CASES)
@pytest.mark.parametrize("D", BATCH_WORLDS)
def test_run_many_on_mesh_equals_jax(D, mv, wide, worlds, keys,
                                    jax_executor):
    """Executor.run_many on the mesh: both chunk plans (wide_batch) and
    both PBS plans (classic, multi-value)."""
    import fhe_regex_tpu as J
    from fhe_regex_tpu.regex.engine import compile_match
    from fhe_regex_tpu.regex.executor import compile_circuit

    ck, sk = keys
    P = sk.params
    contents, pattern, bits = MANY
    circuit = compile_circuit(P, *compile_match(len(contents[0]), pattern,
                                                P.num_blocks, fold="tree"),
                              min_bucket=64, multivalue=mv)
    cts = np.stack([J.trivial_encrypt_str(P, c) for c in contents])
    want = jax_executor(sk, "jnp", D).run_many(circuit, cts, wide_batch=wide)
    got = _replicated(worlds.outputs(D), f"run_many_{mv}_{wide}")
    assert np.array_equal(got, want)
    assert [J.decrypt(ck, r) for r in got] == bits


@pytest.mark.parametrize("D", BATCH_WORLDS)
def test_sharded_pbs_equals_jax(D, worlds, keys):
    import jax.numpy as jnp
    from fhe_regex_tpu.ops.pbs import prepare_server_key
    from fhe_regex_tpu.parallel.mesh import make_sharded_pbs_fn
    from fhe_regex_tpu.params import TEST_PARAMS

    inp = worlds.inputs
    want = make_sharded_pbs_fn(prepare_server_key(TEST_PARAMS, keys[1], "jnp"),
                               _jax_mesh(D))(
        jnp.asarray(inp["luts"]), jnp.asarray(inp["idx"]),
        jnp.asarray(inp["cts"]))
    got = _replicated(worlds.outputs(D), "pbs")
    assert np.array_equal(got, np.asarray(want))


@pytest.mark.parametrize("D", BATCH_WORLDS)
def test_sharded_pbs_fft_backend_equals_jax(D, worlds, noisy_keys):
    """The port's ``fft`` under the mesh against the JAX ``fft`` on its
    exact limb plan "8" under shard_map."""
    import jax.numpy as jnp
    from fhe_regex_tpu.crypto import lwe
    from fhe_regex_tpu.ops.pbs import prepare_server_key
    from fhe_regex_tpu.parallel.mesh import make_sharded_pbs_fn
    from fhe_regex_tpu.params import TEST_PARAMS_NOISY

    inp = worlds.inputs
    dev = prepare_server_key(TEST_PARAMS_NOISY, noisy_keys[1], "fft",
                             fft_plan="8")
    want = make_sharded_pbs_fn(dev, _jax_mesh(D))(
        jnp.asarray(inp["fft_luts"]), jnp.asarray(inp["idx"]),
        jnp.asarray(inp["fft_cts"]))
    got = _replicated(worlds.outputs(D), "pbs_fft")
    assert np.array_equal(got, np.asarray(want))
    o = got.view(np.uint32)
    assert [lwe.decrypt_lwe(TEST_PARAMS_NOISY, noisy_keys[0].lwe_key, row)
            for row in o] == [(i % 16) * 3 % 16 for i in range(len(o))]


@pytest.mark.parametrize("D", BATCH_WORLDS)
def test_sharded_mv_core_equals_jax(D, worlds, keys):
    """One multi-value level through ``make_sharded_mv_core``: rotations
    sharded, accumulators all-gathered, derived extracts sharded."""
    import jax
    import jax.numpy as jnp
    from fhe_regex_tpu.ops.mv import mv_lut_table
    from fhe_regex_tpu.ops.pbs import key_arrays, prepare_server_key
    from fhe_regex_tpu.parallel.mesh import make_sharded_mv_core
    from fhe_regex_tpu.params import TEST_PARAMS

    inp = worlds.inputs
    dk = prepare_server_key(TEST_PARAMS, keys[1], "jnp")
    positions = tuple(int(v) for v in inp["mv_positions"])
    want = jax.jit(make_sharded_mv_core(dk, _jax_mesh(D), positions))(
        key_arrays(dk), jnp.asarray(mv_lut_table(TEST_PARAMS).view(np.int32)),
        jnp.asarray(inp["mv_weights"]), jnp.asarray(inp["mv_leader"]),
        jnp.asarray(inp["mv_rot_cts"]))
    got = _replicated(worlds.outputs(D), "mv_core")
    assert np.array_equal(got, np.asarray(want))


@pytest.mark.parametrize("D", BATCH_WORLDS)
def test_has_match_on_mesh_equals_jax(D, worlds, keys):
    import fhe_regex_tpu as J

    ck, sk = keys
    wants = [J.has_match(sk, J.trivial_encrypt_str(sk.params, content),
                         pattern, mesh=_jax_mesh(D), engine="python")
             for content, pattern, _ in HAS_MATCH]
    outs = worlds.outputs(D)
    for i, (content, pattern, bit) in enumerate(HAS_MATCH):
        got, want = _replicated(outs, f"has_match{i}"), wants[i]
        assert np.array_equal(got, want), (content, pattern)
        assert J.decrypt(ck, got) == bit, (content, pattern)


@pytest.mark.parametrize("D", BATCH_WORLDS)
def test_or_tree_equals_jax(D, worlds, keys):
    """One encrypted 1 on the last rank: every rank ends with the OR, the
    rows JAX's ppermute OR-tree gives on the same bits."""
    import jax.numpy as jnp
    from fhe_regex_tpu.crypto import lwe
    from fhe_regex_tpu.ops.pbs import prepare_server_key
    from fhe_regex_tpu.parallel.collective import or_tree_across_devices
    from fhe_regex_tpu.params import TEST_PARAMS

    inp = worlds.inputs
    bits = inp[f"or_bits{D}"]
    fn = or_tree_across_devices(prepare_server_key(TEST_PARAMS, keys[1],
                                                   "jnp"), _jax_mesh(D))
    want = fn(jnp.asarray(inp["or_luts"]), jnp.ones((), jnp.int32),
              jnp.asarray(bits))
    got = np.concatenate([o["or_tree"] for o in worlds.outputs(D)])
    assert np.array_equal(got, np.asarray(want))

    def dec(rows):
        return [lwe.decrypt_lwe(TEST_PARAMS, keys[0].lwe_key, r)
                for r in rows.view(np.uint32)]
    assert dec(bits) == [0] * (D - 1) + [1]
    assert dec(got) == [1] * D


@pytest.mark.parametrize("D", TP_WORLDS)
def test_tensor_parallel_bootstrap_equals_jax(D, worlds, keys):
    """TP inside one bootstrap: each rank holds rows/D of every GGSW; the
    bits equal the JAX row-sharded bootstrap's (and its single-device
    one's), and decrypt to f(m)."""
    import jax
    import jax.numpy as jnp
    from fhe_regex_tpu.crypto import lwe
    from fhe_regex_tpu.parallel.tensor import make_tp_mesh, make_tp_pbs_fn
    from fhe_regex_tpu.params import TEST_PARAMS

    inp = worlds.inputs
    fn = jax.jit(make_tp_pbs_fn(TEST_PARAMS, keys[1], make_tp_mesh(D)))
    want = fn(jnp.asarray(inp["tp_luts"]), jnp.asarray(inp["tp_idx"]),
              jnp.asarray(inp["tp_cts"]))
    got = _replicated(worlds.outputs(D), "tp")
    assert np.array_equal(got, np.asarray(want))
    assert [lwe.decrypt_lwe(TEST_PARAMS, keys[0].lwe_key, r)
            for r in got.view(np.uint32)] == [_tp_fn(m) for m in TP_MSGS]


def test_tensor_parallel_rejects_bad_mesh(worlds, keys):
    """6 GGSW rows do not split over 4 ranks: both packages refuse."""
    from fhe_regex_tpu.parallel.tensor import make_tp_mesh, make_tp_pbs_fn
    from fhe_regex_tpu.params import TEST_PARAMS

    for o in worlds.outputs(4):
        assert "not divisible by mesh size 4" in str(o["tp_refused"])
    with pytest.raises(ValueError):
        make_tp_pbs_fn(TEST_PARAMS, keys[1], make_tp_mesh(4))


@pytest.mark.parametrize("D", BATCH_WORLDS)
def test_make_mesh_rejects_oversized_request(D, worlds):
    """A mesh larger than the world fails loudly, as a JAX mesh larger than
    the visible devices does."""
    import jax

    for o in worlds.outputs(D):
        assert f"requested a {D + 1}-device mesh" in str(o["oversize_refused"])
    with pytest.raises(ValueError, match="device"):
        _jax_mesh(len(jax.devices()) + 1)


@pytest.mark.parametrize("D", BATCH_WORLDS)
def test_width_not_divisible_refused(D, worlds, keys):
    """A batch of 2D - 1 rows, and a circuit compiled with levels narrower
    than the mesh, are refused by both packages."""
    import jax.numpy as jnp
    from fhe_regex_tpu import trivial_encrypt_str
    from fhe_regex_tpu.ops.pbs import prepare_server_key
    from fhe_regex_tpu.parallel.mesh import make_sharded_pbs_fn
    from fhe_regex_tpu.regex.engine import compile_match
    from fhe_regex_tpu.regex.executor import Executor, compile_circuit

    inp = worlds.inputs
    P = keys[1].params
    outs = worlds.outputs(D)
    for o in outs:
        assert "does not split over" in str(o["ragged_refused"])
    dk = prepare_server_key(P, keys[1], "jnp")
    ragged = 2 * D - 1
    with pytest.raises(ValueError):
        make_sharded_pbs_fn(dk, _jax_mesh(D))(
            jnp.asarray(inp["luts"]), jnp.asarray(inp["idx"][:ragged]),
            jnp.asarray(inp["cts"][:ragged]))
    narrow = compile_circuit(P, *compile_match(2, "/b/", P.num_blocks), 2)
    widths = [lv.lut_idx.shape[0] for lv in narrow.levels]
    assert list(outs[0]["narrow_widths"]) == widths
    if all(w % D == 0 for w in widths):
        assert all(str(o["narrow_refused"]) == "" for o in outs)
        return
    for o in outs:
        assert "min_bucket >= " in str(o["narrow_refused"])
    with pytest.raises(ValueError):
        Executor(P, dk, mesh=_jax_mesh(D)).run(narrow,
                                               trivial_encrypt_str(P, "ab"))


@pytest.mark.parametrize("D", BATCH_WORLDS)
def test_mesh_device_and_executor_cache(D, worlds):
    """Under a mesh the device is the rank's: "cuda" on a gloo (CPU) mesh
    raises ValueError, and the CUDA default RuntimeError on this card-less
    machine; executors are cached per (backend, device, mesh)."""
    for o in worlds.outputs(D):
        assert "is not this rank's device" in str(o["device_refused"])
        assert "no CUDA device" in str(o["default_device_refused"])
        assert bool(o["executor_cached"])


@pytest.mark.parametrize("D", WORLDS)
def test_ranks_import_no_jax(D, worlds):
    outs = worlds.outputs(D)
    assert [int(o["rank"]) for o in outs] == list(range(D))
    assert not any(bool(o["jax_loaded"]) for o in outs)


@pytest.mark.parametrize("D", (1, 2, 3, 6))
def test_row_block_external_product_sums_to_the_step(D):
    """The TP step's contraction, ``pbs_cuda.external_product_rows`` on its
    CPU route (the plain version, launching nothing): the D row blocks of
    one step's digits and GGSW, each on a zero accumulator, sum mod 2^32
    with acc to the Pallas ``_ext_product_kernel`` of the whole step
    (interpret mode)."""
    import jax.numpy as jnp
    from fhe_regex_tpu.ops import pbs_pallas
    from fhe_regex_tpu.params import TEST_PARAMS_NOISY

    from fhe_regex_tpu_torch.ops import pbs_cuda
    from fhe_regex_tpu_torch.ops.pbs import wrap_i32
    from fhe_regex_tpu_torch.params import get_params

    P = TEST_PARAMS_NOISY
    N, k1 = P.polynomial_size, P.glwe_dimension + 1
    rows, B = k1 * P.pbs_level, 8
    rng = np.random.default_rng(60 + D)
    half = 1 << (P.pbs_base_log - 1)
    digits = rng.integers(-half, half + 1, size=(B, rows, N)).astype(np.int8)
    ggsw = rng.integers(0, 1 << 32, size=(1, rows, k1, N),
                        dtype=np.uint64).astype(np.uint32)
    acc = rng.integers(0, 1 << 32, size=(B, k1, N),
                       dtype=np.uint64).astype(np.uint32).view(np.int32)
    quad = pbs_pallas.prepare_bsk_pallas(P, ggsw)[0]
    want = pbs_pallas.external_product_step(
        P, jnp.asarray(digits.reshape(B, rows * N).astype(np.int32)),
        pbs_pallas._group_quad(P, jnp.asarray(quad)), jnp.asarray(acc),
        jnp.int8, flat_digits=True)
    tp, R = get_params(P.name), rows // D
    g = torch.from_numpy(ggsw[0].view(np.int32))
    d = torch.from_numpy(digits)
    zero = torch.zeros((B, k1, N), dtype=torch.int32)
    before = pbs_cuda.external_product_rows.launches
    total = torch.from_numpy(acc).to(torch.int64)
    for r0 in range(0, rows, R):
        part = pbs_cuda.external_product_rows(
            tp, d[:, r0:r0 + R].contiguous(), g[r0:r0 + R], zero)
        total += part.to(torch.int64)
    assert np.array_equal(wrap_i32(total).numpy(), np.asarray(want))
    assert pbs_cuda.external_product_rows.launches == before
    assert not zero.any()


def test_row_block_external_product_rejects_other_devices():
    from fhe_regex_tpu_torch.ops import pbs_cuda
    from fhe_regex_tpu_torch.params import get_params

    p = get_params("TEST_PARAMS")
    meta = torch.empty((2, 2, p.polynomial_size), dtype=torch.int32,
                       device="meta")
    with pytest.raises(ValueError, match="no external product kernel"):
        pbs_cuda.external_product_rows(p, meta, meta, meta)


def test_mesh_needs_a_process_group():
    """No silent single-process mesh: without an initialised group, every
    mesh constructor raises."""
    import torch.distributed as dist

    from fhe_regex_tpu_torch.parallel.mesh import make_mesh
    from fhe_regex_tpu_torch.parallel.tensor import make_tp_mesh

    assert not dist.is_initialized()
    for make in (make_mesh, make_tp_mesh):
        with pytest.raises(RuntimeError, match="no process group"):
            make(1)


if __name__ == "__main__":
    sys.path.insert(0, str(ROOT))
    _rank_main(int(sys.argv[1]), int(sys.argv[2]), *sys.argv[3:6])
