"""The tensor-parallel bootstrap of the PyTorch port as one CUDA graph
(``parallel/tensor.py``), on the CPU through a stand-in for ``torch.cuda``.

* ``default_tp_graph``: the graph on a CUDA device at a mesh of one rank,
  the step loop at more ranks and on the CPU; FHE_REGEX_FUSE_LEVELS=0|1
  forces it either way on a CUDA device.
* The first call with an input shape is the warm-up pass, which gives
  its result, then the capture; later calls of that shape copy their
  inputs into the static buffers and replay; a new shape captures anew;
  at most ``MAX_TP_GRAPHS`` shapes are kept.
* The capture takes back the launch counts its wrapper calls added, and
  each replay adds n of ``stage1_digits`` and n of
  ``external_product_rows``; a capture that fails raises, and the call
  does not fall back to the step loop.

The graph's outputs equal the step loop's bit for bit (tolerance zero:
exact integer arithmetic mod 2^32); ``tests/test_torch_parallel.py`` holds
the step loop against the JAX package.  Keys from a seed at
``TEST_PARAMS`` (n = 16), real encryptions, a world of one gloo rank in
this process.
"""

import contextlib

import numpy as np
import pytest
import torch
import torch.distributed as dist

from fhe_regex_tpu_torch import gen_keys
from fhe_regex_tpu_torch.crypto import lwe
from fhe_regex_tpu_torch.crypto.golden import make_lut_poly
from fhe_regex_tpu_torch.ops import pbs_cuda
from fhe_regex_tpu_torch.params import TEST_PARAMS
from fhe_regex_tpu_torch.parallel import tensor

torch.set_num_threads(2)

N_STEPS = TEST_PARAMS.lwe_dimension


@pytest.fixture(scope="module")
def tp_module():
    """(client key, TP function) on a mesh of this process's one rank."""
    ck, sk = gen_keys(TEST_PARAMS, seed=5)
    dist.init_process_group("gloo", store=dist.HashStore(), rank=0,
                            world_size=1)
    try:
        yield ck, tensor.make_tp_pbs_fn(TEST_PARAMS, sk,
                                        tensor.make_tp_mesh(1))
    finally:
        dist.destroy_process_group()


@pytest.fixture
def tp(tp_module):
    """``tp_module`` with no captured graph left from another test."""
    tp_module[1].graphs.clear()
    return tp_module


def _inputs(ck, msgs, seed):
    """(luts, lut_idx, cts) of real encryptions of ``msgs``; the LUT of
    row i is x -> (x + i + 1) mod 16 for lut_idx i."""
    rng = np.random.default_rng(seed)
    luts = np.stack([make_lut_poly(TEST_PARAMS, lambda x, i=i: (x + i + 1)
                                   % 16) for i in range(2)])
    idx = rng.integers(0, 2, len(msgs)).astype(np.int32)
    cts = np.stack([lwe.encrypt_lwe(TEST_PARAMS, ck.lwe_key, int(m), ck.rng)
                    for m in msgs])
    return luts.view(np.int32), idx, cts.view(np.int32)


def _decrypt(ck, out):
    return [lwe.decrypt_lwe(TEST_PARAMS, ck.lwe_key, r)
            for r in out.numpy().view(np.uint32)]


class _FakeCuda:
    """The parts of ``torch.cuda`` a capture touches, on the CPU: the
    capture context runs its body once, as a capture records it; a replay
    runs the body its test gives the graph (``graph.body``), its wrapper
    calls taken back, as a replay calls no wrapper."""

    def __init__(self, fail_capture=False):
        self.replays = 0
        self.fail_capture = fail_capture
        self.capturing = False

    def install(self, monkeypatch):
        stream = type("S", (), {"wait_stream": lambda self, other: None})
        fake = self

        class graph:
            body = None

            def replay(self):
                fake.replays += 1
                before = pbs_cuda.launch_counts()
                self.body()
                pbs_cuda.add_launches(pbs_cuda.launch_delta(
                    before, pbs_cuda.launch_counts()), -1)

        @contextlib.contextmanager
        def capture(g, **kw):
            fake.capturing = True
            try:
                yield
            finally:
                fake.capturing = False

        for name, value in dict(
                Stream=lambda *a: stream(),
                stream=lambda s: contextlib.nullcontext(),
                current_stream=lambda *a: stream(),
                synchronize=lambda *a: None, empty_cache=lambda: None,
                memory_reserved=lambda *a: 0,
                CUDAGraph=graph, graph=capture).items():
            monkeypatch.setattr(torch.cuda, name, value, raising=False)
        # the graph branch on the CPU; the wrappers count as on the card
        monkeypatch.setattr(tensor, "default_tp_graph", lambda *a: True)
        for k in pbs_cuda.KERNELS:
            monkeypatch.setattr(k, "launches", 0)
        for k in (pbs_cuda.stage1_digits, pbs_cuda.external_product_rows):
            monkeypatch.setattr(pbs_cuda, k.__name__, self._counting(k))

    def _counting(self, kernel):
        def wrapper(*args):
            if self.fail_capture and self.capturing:
                raise RuntimeError("operation not permitted when stream is "
                                   "capturing")
            kernel.launches += 1
            return kernel(*args)
        return wrapper


def _counts():
    c = pbs_cuda.launch_counts()
    return c["stage1_digits"], c["external_product_rows"]


@pytest.mark.parametrize("device,world,env,want", [
    ("cuda", 1, None, True), ("cuda", 2, None, False),
    ("cuda", 1, "0", False), ("cuda", 2, "1", True),
    ("cpu", 1, None, False), ("cpu", 1, "1", False)])
def test_default_follows_world_and_env(monkeypatch, device, world, env,
                                       want):
    if env is None:
        monkeypatch.delenv("FHE_REGEX_FUSE_LEVELS", raising=False)
    else:
        monkeypatch.setenv("FHE_REGEX_FUSE_LEVELS", env)
    assert tensor.default_tp_graph(device, world) is want


def test_first_call_warms_up_and_later_calls_replay(monkeypatch, tp):
    ck, fn = tp
    first = _inputs(ck, [0, 5, 9, 15], seed=1)
    second = _inputs(ck, [3, 4, 7, 12], seed=2)
    narrow = _inputs(ck, [1, 14], seed=3)
    want = {k: fn(*x) for k, x in (("first", first), ("second", second),
                                   ("narrow", narrow))}   # the step loop
    assert _decrypt(ck, want["first"]) != _decrypt(ck, want["second"])
    fake = _FakeCuda()
    fake.install(monkeypatch)

    out = fn(*first)                           # warm-up pass, then capture
    (shape, entry), = fn.graphs.items()
    assert fake.replays == 0 and entry.graph is not None
    assert torch.equal(out, want["first"])
    assert _counts() == (N_STEPS, N_STEPS)     # the warm-up's; capture's back
    assert entry.launches == {"stage1_digits": N_STEPS,
                              "external_product_rows": N_STEPS}
    entry.graph.body = entry.body

    for k, x in (("second", second), ("first", first)):
        assert torch.equal(fn(*x), want[k])    # inputs copied in, replayed
    assert fake.replays == 2 and list(fn.graphs) == [shape]
    assert _counts() == (3 * N_STEPS, 3 * N_STEPS)

    out = fn(*narrow)                          # a new shape captures anew
    assert torch.equal(out, want["narrow"])
    assert fake.replays == 2 and len(fn.graphs) == 2
    assert list(fn.graphs)[-1] != shape
    assert _counts() == (4 * N_STEPS, 4 * N_STEPS)

    monkeypatch.setattr(tensor, "MAX_TP_GRAPHS", 2)
    fn(*_inputs(ck, [2], seed=4))
    assert len(fn.graphs) == 2 and shape not in fn.graphs


def test_failed_capture_raises(monkeypatch, tp):
    """A capture that fails raises out of the call, which does not fall
    back to the step loop; only the warm-up pass's launches stay counted."""
    ck, fn = tp
    fake = _FakeCuda(fail_capture=True)
    fake.install(monkeypatch)
    with pytest.raises(RuntimeError, match="capturing"):
        fn(*_inputs(ck, [6, 8], seed=6))
    (entry,) = fn.graphs.values()
    assert entry.graph is None and _counts() == (N_STEPS, N_STEPS)
