"""``Executor.run(fuse=)`` of the PyTorch port against the JAX package.

* A fused run (the whole level loop as one unit: one CUDA graph on the
  card, one call here) gives the same ciphertext as the port's per-level
  run and as the JAX package's fused run, bit for bit (tolerance zero:
  the arithmetic is exact integer arithmetic mod 2^32 / 2^64), on the
  classic and the multi-value plan, at 32 and 64 bits.
* ``default_fuse`` follows the JAX package's contract (the size cap and
  FHE_REGEX_FUSE_LEVELS), with the device in place of its TPU check, and
  is on only for the backends the card showed a graph to pay off on and
  for one rank.
* ``profile``, checkpointing and ``resume`` keep the per-level loop (the
  watchdog's "levels" key); a fused run is observed under "fused".
* Every executor keeps its own fused loops, keyed by the plan: two
  executors never share one, a recompiled circuit finds its plan's again,
  and at most ``MAX_FUSED_GRAPHS`` are kept.
* A capture takes back the launch counts its wrappers added, and a replay
  adds them (``pbs_cuda.launch_delta`` / ``add_launches``); a first run's
  result is its warm-up pass, with no replay; a capture that fails raises.
* Fused runs of one executor from two threads take turns on its slab.

Contents are real (noisy) encryptions at ``TEST_PARAMS_NOISY``, keys from
a seed; ``TEST_PARAMS_64`` at 64 bits.
"""

import contextlib
import threading

import numpy as np
import pytest
import torch

import fhe_regex_tpu as J
from fhe_regex_tpu.crypto.keys import gen_keys as jax_gen_keys
from fhe_regex_tpu.params import TEST_PARAMS_64

import fhe_regex_tpu_torch as port
from fhe_regex_tpu_torch.convert import server_key_from_jax
from fhe_regex_tpu_torch.ops import pbs_cuda
from fhe_regex_tpu_torch.ops.pbs import prepare_server_key
from fhe_regex_tpu_torch.regex import executor as tex

torch.set_num_threads(2)


def _predicate(b):
    """(content[0] in {'a','b'}) AND NOT (content[1] == 'z')"""
    first = b.ct_or(b.ct_eq(0, ord("a")), b.ct_eq(0, ord("b")))
    return b.ct_and(first, b.ct_not(b.ct_eq(1, ord("z"))))


def _plain(s: str) -> int:
    return int(s[0] in "ab" and s[1] != "z")


def _both(sk, multivalue=False):
    """(JAX circuit, port circuit) of the predicate, compiled alike."""
    jb, tb = J.CircuitBuilder(2), port.CircuitBuilder(2)
    return (J.compile_circuit(sk.params, jb, _predicate(jb),
                              multivalue=multivalue),
            tex.compile_circuit(sk.params, tb, _predicate(tb),
                                multivalue=multivalue))


@pytest.fixture(scope="module")
def noisy(noisy_keys):
    ck, sk = noisy_keys
    return ck, sk, server_key_from_jax(sk)


@pytest.fixture(scope="module")
def keys64():
    ck, sk = jax_gen_keys(TEST_PARAMS_64, seed=5)
    return ck, sk, server_key_from_jax(sk)


def _fresh(tsk):
    return tex.Executor(tsk.params, prepare_server_key(tsk.params, tsk, "cpu"))


@pytest.mark.parametrize("content", ["ab", "az", "xy"])
def test_fused_levels_matches_per_level(content, noisy):
    ck, sk, tsk = noisy
    jc, tc = _both(sk)
    ct = J.encrypt_str(ck, content)
    want = J.executor_for(sk).run(jc, ct, fuse=True)
    ex = _fresh(tsk)
    fused, steps = ex.run(tc, ct, fuse=True), ex.run(tc, ct, fuse=False)
    assert np.array_equal(fused, want) and np.array_equal(steps, want)
    assert J.decrypt(ck, want) == _plain(content)


def test_fused_levels_matches_per_level_mv(noisy):
    ck, sk, tsk = noisy
    jc, tc = _both(sk, multivalue=True)
    assert tc.rotation_count < tc.pbs_count
    jx, ex = J.executor_for(sk), _fresh(tsk)
    for content in ("ab", "xy"):
        ct = J.encrypt_str(ck, content)
        want = jx.run(jc, ct, fuse=True)
        assert np.array_equal(ex.run(tc, ct, fuse=True), want)
        assert np.array_equal(ex.run(tc, ct, fuse=False), want)
        assert J.decrypt(ck, want) == _plain(content)


@pytest.mark.parametrize("multivalue", [False, True])
def test_fused_levels_matches_per_level_64(multivalue, keys64):
    ck, sk, tsk = keys64
    jc, tc = _both(sk, multivalue=multivalue)
    ct = J.encrypt_str(ck, "ab")
    want = J.executor_for(sk, "jnp64").run(jc, ct, fuse=True)
    ex = _fresh(tsk)
    fused = ex.run(tc, ct, fuse=True)
    assert fused.dtype == np.uint64 and np.array_equal(fused, want)
    assert np.array_equal(ex.run(tc, ct, fuse=False), want)
    assert J.decrypt(ck, want) == 1


def test_default_fuse_size_cap(monkeypatch):
    """On for a CUDA device and a backend of FUSE_BACKENDS (the per-step
    ``cuda`` one) up to FUSE_MAX_PBS rotations, off above it, on the CPU,
    for the device's default and every other backend, and under a mesh of
    more than one rank; FHE_REGEX_FUSE_LEVELS forces either way (no card
    needed to name a CUDA device)."""

    class FakeCircuit:
        def __init__(self, pbs_count):
            self.pbs_count = self.rotation_count = pbs_count

    small = FakeCircuit(tex.FUSE_MAX_PBS)
    big = FakeCircuit(tex.FUSE_MAX_PBS + 1)
    cuda = torch.device("cuda")
    monkeypatch.delenv("FHE_REGEX_FUSE_LEVELS", raising=False)
    assert tex.FUSE_BACKENDS == ("cuda",)
    assert tex.default_fuse(small, cuda, "cuda") is True
    assert tex.default_fuse(small, "cuda:0", "cuda", 1) is True
    assert tex.default_fuse(big, cuda, "cuda") is False
    assert tex.default_fuse(small, cuda, "cuda", 2) is False
    assert tex.default_fuse(small, torch.device("cpu"), "cuda") is False
    assert tex.default_fuse(small, cuda) is False
    for backend in ("cuda-fused", "cuda-bg", "cuda64", "cuda64-bg", "torch",
                    "torch64", "fft"):
        assert tex.default_fuse(small, cuda, backend) is False
    monkeypatch.setenv("FHE_REGEX_FUSE_LEVELS", "1")
    assert tex.default_fuse(big, "cpu") is True
    assert tex.default_fuse(small, cuda, "fft", 4) is True
    monkeypatch.setenv("FHE_REGEX_FUSE_LEVELS", "0")
    assert tex.default_fuse(small, cuda, "cuda") is False


def test_profile_checkpoint_resume_keep_per_level(noisy, tmp_path,
                                                  monkeypatch):
    """With fuse=True (and with the default forced on), profile, a
    checkpoint and a resume still run level by level; a plain fused run is
    observed under "fused".  The CPU default is per-level."""
    ck, sk, tsk = noisy
    _, tc = _both(sk)
    ct = J.encrypt_str(ck, "ab")
    shape = (tc.pbs_count, tc.num_slots, False)
    ex = _fresh(tsk)
    want = ex.run(tc, ct)
    assert ex.watchdog._seen == {("levels",) + shape: 1} and not ex._fused
    assert np.array_equal(ex.run(tc, ct, profile=True, fuse=True), want)
    assert len(ex.last_run_stats) == len(tc.levels)
    cp = tmp_path / "run.npz"
    monkeypatch.setenv("FHE_REGEX_FUSE_LEVELS", "1")
    assert np.array_equal(ex.run(tc, ct, checkpoint=str(cp),
                                 checkpoint_every=1), want)
    assert np.array_equal(ex.run(tc, None, resume=str(cp)), want)
    assert ex.watchdog._seen == {("levels",) + shape: 4} and not ex._fused
    assert np.array_equal(ex.run(tc, ct), want)
    assert ex.last_run_stats == []
    assert ex.watchdog._seen == {("levels",) + shape: 4,
                                 ("fused",) + shape: 1}


def test_executors_keep_their_own_fused_loops(noisy, monkeypatch):
    """Two executors of two keys on one circuit: an entry each, with slabs
    of their own.  A second compile of the same plan finds the entry; a
    plan beyond MAX_FUSED_GRAPHS drops the least recently run."""
    ck, sk, tsk = noisy
    other = server_key_from_jax(jax_gen_keys(sk.params, seed=44)[1])
    _, tc = _both(sk)
    ct = J.encrypt_str(ck, "ab")
    ex1, ex2 = _fresh(tsk), _fresh(other)
    ex1.run(tc, ct, fuse=True)
    ex2.run(tc, ct, fuse=True)
    (fp, e1), = ex1._fused.items()
    (fp2, e2), = ex2._fused.items()
    assert fp == fp2 == tex.circuit_fingerprint(tc)
    assert e1 is not e2 and e1.slab.data_ptr() != e2.slab.data_ptr()
    assert ex1.fused_levels(_both(sk)[1]) is e1
    monkeypatch.setattr(tex, "MAX_FUSED_GRAPHS", 2)
    b = port.CircuitBuilder(2)
    tc2 = tex.compile_circuit(sk.params, b, b.force_node(b.ct_eq(0, 97)))
    b = port.CircuitBuilder(2)
    tc3 = tex.compile_circuit(sk.params, b, b.force_node(b.ct_eq(1, 97)))
    ex1.run(tc2, ct, fuse=True)
    ex1.run(tc, ct, fuse=True)             # tc2 is now the oldest
    ex1.run(tc3, ct, fuse=True)
    assert list(ex1._fused) == [fp, tex.circuit_fingerprint(tc3)]


def test_launch_delta_and_add_launches(monkeypatch):
    for k in pbs_cuda.KERNELS:
        monkeypatch.setattr(k, "launches", 0)
    before = pbs_cuda.launch_counts()
    pbs_cuda.stage1_digits.launches += 866
    pbs_cuda.external_product_step.launches += 866
    delta = pbs_cuda.launch_delta(before, pbs_cuda.launch_counts())
    assert delta == {"stage1_digits": 866, "external_product_step": 866}
    pbs_cuda.add_launches(delta, -1)
    assert pbs_cuda.launch_counts() == before
    pbs_cuda.add_launches(delta)
    pbs_cuda.add_launches(delta)
    assert pbs_cuda.stage1_digits.launches == 2 * 866
    assert pbs_cuda.blind_rotate_fused.launches == 0


class _FakeCuda:
    """The parts of ``torch.cuda`` a capture touches, on the CPU: the
    graph context runs its body once, as a capture records it."""

    def __init__(self):
        self.reserved = 1000
        self.replays = 0

    def install(self, monkeypatch):
        stream = type("S", (), {"wait_stream": lambda self, other: None})
        fake = self

        class graph:
            def replay(self):
                fake.replays += 1

        @contextlib.contextmanager
        def capture(g, **kw):
            yield
            self.reserved += 4096          # the graph's private pool

        for name, value in dict(
                Stream=lambda *a: stream(),
                stream=lambda s: contextlib.nullcontext(),
                current_stream=lambda *a: stream(),
                synchronize=lambda *a: None, empty_cache=lambda: None,
                memory_reserved=lambda *a: self.reserved,
                CUDAGraph=graph, graph=capture).items():
            monkeypatch.setattr(torch.cuda, name, value, raising=False)


def test_capture_takes_back_its_launch_counts(monkeypatch):
    """The warm-up pass launches for real; the capture's wrapper calls are
    taken back and recorded as the launches of one replay."""
    for k in pbs_cuda.KERNELS:
        monkeypatch.setattr(k, "launches", 0)
    _FakeCuda().install(monkeypatch)

    def body():
        pbs_cuda.blind_rotate_fused.launches += 3

    entry = tex.FusedLevels(body, torch.zeros(4, 3, dtype=torch.int32))
    entry._capture()
    assert entry.graph is not None and entry.pool_bytes == 4096
    assert entry.launches == {"blind_rotate_fused": 3}
    assert pbs_cuda.blind_rotate_fused.launches == 3      # the warm-up's


def test_failed_capture_raises(monkeypatch):
    """A capture that fails raises, leaves no graph and no counts behind."""
    for k in pbs_cuda.KERNELS:
        monkeypatch.setattr(k, "launches", 0)
    _FakeCuda().install(monkeypatch)
    calls = []

    def body():
        calls.append(1)
        pbs_cuda.blind_rotate_fused.launches += 3
        if len(calls) == 2:
            raise RuntimeError("operation not permitted when stream is "
                               "capturing")

    entry = tex.FusedLevels(body, torch.zeros(4, 3, dtype=torch.int32))
    with pytest.raises(RuntimeError, match="capturing"):
        entry._capture()
    assert entry.graph is None
    assert pbs_cuda.blind_rotate_fused.launches == 3


def test_first_run_is_the_warm_up_and_later_runs_replay(monkeypatch):
    """On CUDA a plan's first fused run fills the slab, and its warm-up pass
    computes the result before the capture: no replay, one run's launches.
    Every later run refills and replays, adding the recorded launches."""
    for k in pbs_cuda.KERNELS:
        monkeypatch.setattr(k, "launches", 0)
    fake = _FakeCuda()
    fake.install(monkeypatch)

    class Slab:                        # stands for a tensor on the card
        device = torch.device("cuda")
        zeroed = 0

        def zero_(self):
            self.zeroed += 1

    def body():
        pbs_cuda.blind_rotate_fused.launches += 3

    fills = []
    entry = tex.FusedLevels(body, Slab())
    assert entry.run(fills.append) is entry.slab
    assert fake.replays == 0 and entry.graph is not None
    assert pbs_cuda.blind_rotate_fused.launches == 3
    entry.run(fills.append)
    entry.run(fills.append)
    assert fake.replays == 2 and len(fills) == entry.slab.zeroed == 3
    assert pbs_cuda.blind_rotate_fused.launches == 9


def test_fused_runs_of_one_executor_take_turns(noisy):
    """Two threads run one plan on one executor with different contents:
    each gets its own content's ciphertext, since a fused run holds the
    executor's lock from the slab's fill to the root download."""
    ck, sk, tsk = noisy
    _, tc = _both(sk)
    ex = _fresh(tsk)
    cts = {c: J.encrypt_str(ck, c) for c in ("ab", "az")}
    want = {c: ex.run(tc, ct, fuse=False) for c, ct in cts.items()}
    assert not np.array_equal(want["ab"], want["az"])
    wrong = []

    def client(c):
        for _ in range(3):
            if not np.array_equal(ex.run(tc, cts[c], fuse=True), want[c]):
                wrong.append(c)

    threads = [threading.Thread(target=client, args=(c,)) for c in cts]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert wrong == [] and len(ex._fused) == 1
