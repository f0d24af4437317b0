"""Checkpoint, resume and the launch watchdog of the PyTorch port's executor
against the JAX package.

* ``Executor.run`` saves its slab every k levels and resumes from it
  (``content_blocks=None`` too), single- and multi-root, at both torus
  widths; ``run_many`` is killed mid-plan and resumed, on the classic and
  the multi-value plan.  Every resumed result equals the JAX package's
  uninterrupted run, bit for bit.
* A checkpoint carries the circuit's fingerprint: a resume of a different
  circuit with the same step count and C, which the JAX package accepts,
  is refused, and so is a checkpoint without one.
* Without a fingerprint, ``utils/checkpoint.py`` writes the JAX module's
  keys and arrays; the 64-bit slab is the JAX package's limb-pair slab.
* ``run`` and ``run_many`` feed the executor's ``LaunchWatchdog``.

Tolerance is zero.  Contents are real (noisy) encryptions from the JAX
package at ``TEST_PARAMS_NOISY``, and at ``TEST_PARAMS_64`` for one case.
"""

import numpy as np
import pytest
import torch

import fhe_regex_tpu as J
from fhe_regex_tpu.params import TEST_PARAMS_64
from fhe_regex_tpu.regex import executor as jex
from fhe_regex_tpu.regex.engine import compile_match_multi as jax_multi
from fhe_regex_tpu.utils import checkpoint as jck

import fhe_regex_tpu_torch as port
from fhe_regex_tpu_torch.convert import client_key_from_jax, server_key_from_jax
from fhe_regex_tpu_torch.ops.pbs import prepare_server_key
from fhe_regex_tpu_torch.regex import executor as tex
from fhe_regex_tpu_torch.regex.engine import compile_match, compile_match_multi
from fhe_regex_tpu_torch.utils import checkpoint as tck

torch.set_num_threads(2)


@pytest.fixture(scope="module")
def both(noisy_keys):
    """(JAX keys, port keys) for TEST_PARAMS_NOISY."""
    ck, sk = noisy_keys
    return (ck, sk), (client_key_from_jax(ck), server_key_from_jax(sk))


def _enc(ck, strings):
    return np.stack([J.encrypt_str(ck, s) for s in strings])


def _circuits(params, jparams, build, jbuild, n, pattern, **kw):
    """The same circuit compiled by both packages (Python builders)."""
    return (tex.compile_circuit(params, *build(n, pattern, fold="tree"), **kw),
            jex.compile_circuit(jparams, *jbuild(n, pattern, fold="tree"),
                                **kw))


def _executors(sk, tsk):
    return J.executor_for(sk, "jnp"), port.executor_for(tsk, device="cpu")


def test_run_checkpoint_resume_equals_jax(both, tmp_path):
    """run() saves every 2 levels; the resumed run equals the JAX
    package's uninterrupted one."""
    (ck, sk), (tck_, tsk) = both
    content = "xxabcxxx"
    circuit, jc = _circuits(tsk.params, sk.params, compile_match,
                            J.compile_match, len(content), "/ab?c/")
    assert len(circuit.levels) >= 3
    jx, ex = _executors(sk, tsk)
    ct = J.encrypt_str(ck, content)
    want = jx.run(jc, ct)
    cp = tmp_path / "run.npz"
    assert np.array_equal(ex.run(circuit, ct, checkpoint=str(cp),
                                 checkpoint_every=2), want)
    _, lvl = tck.load_slab(cp)
    assert 0 < lvl < len(circuit.levels) and lvl % 2 == 0
    resumed = ex.run(circuit, None, resume=str(cp))
    assert np.array_equal(resumed, want) and port.decrypt(tck_, resumed) == 1


def test_run_many_kill_and_resume_equals_jax(both, tmp_path, monkeypatch):
    """run_many killed after 2 launch steps (the level launch raises)
    resumes from the last checkpoint to the JAX package's result for every
    content; a wrong C is refused as in the JAX package."""
    (ck, sk), (tck_, tsk) = both
    contents = ["xxabcxxx", "xabcxxxx", "xxxxxxxx", "abcabcab"]
    circuit, jc = _circuits(tsk.params, sk.params, compile_match,
                            J.compile_match, 8, "/ab?c/")
    jx, ex = _executors(sk, tsk)
    cts = _enc(ck, contents)
    want = jx.run_many(jc, cts)
    cp = tmp_path / "many.npz"
    real, calls = ex._run_level, []

    def dying(*a, **k):
        if len(calls) >= 2:
            raise RuntimeError("simulated crash")
        calls.append(1)
        return real(*a, **k)

    monkeypatch.setattr(ex, "_run_level", dying)
    with pytest.raises(RuntimeError, match="simulated crash"):
        ex.run_many(circuit, cts, checkpoint=str(cp), checkpoint_every=1)
    monkeypatch.undo()
    _, step, ck_C, total = tck.load_many_slab(cp)
    assert step == 2 and ck_C == len(contents) and total > step
    resumed = ex.run_many(circuit, cts, resume=str(cp))
    assert np.array_equal(resumed, want)
    assert [port.decrypt(tck_, r) for r in resumed] == [1, 1, 0, 1]
    with pytest.raises(ValueError, match="C="):
        ex.run_many(circuit, cts[:2], resume=str(cp))


def test_run_many_multivalue_kill_and_resume_equals_jax(both, tmp_path,
                                                        monkeypatch):
    """The multi-value plan checkpoints per (rotations + finish) step: a
    run killed in its second step's rotations resumes to the JAX result."""
    (ck, sk), (tck_, tsk) = both
    circuit, jc = _circuits(tsk.params, sk.params, compile_match,
                            J.compile_match, 3, "/ab[c-e]/", multivalue=True)
    jx, ex = _executors(sk, tsk)
    cts = _enc(ck, ["abq", "abd", "xyz"])
    want = jx.run_many(jc, cts)
    cp = tmp_path / "many_mv.npz"
    assert np.array_equal(ex.run_many(circuit, cts, checkpoint=str(cp),
                                      checkpoint_every=1), want)
    steps = ex._device_chunks_many_mv(circuit, 3, False)
    assert len(steps) >= 2
    real, calls = ex._mv_rotate, []

    def dying(*a, **k):
        if len(calls) >= len(steps[0][0]):       # the first step's chunks
            raise RuntimeError("simulated crash")
        calls.append(1)
        return real(*a, **k)

    cp.unlink()
    monkeypatch.setattr(ex, "_mv_rotate", dying)
    with pytest.raises(RuntimeError, match="simulated crash"):
        ex.run_many(circuit, cts, checkpoint=str(cp), checkpoint_every=1)
    monkeypatch.undo()
    _, step, ck_C, total = tck.load_many_slab(cp)
    assert step == 1 and ck_C == 3 and total == len(steps)
    resumed = ex.run_many(circuit, cts, resume=str(cp))
    assert np.array_equal(resumed, want)
    assert [port.decrypt(tck_, r) for r in resumed] == [0, 1, 0]
    tck.save_slab(tmp_path / "plain.npz", np.zeros((4, 17), np.int32), 1)
    with pytest.raises(ValueError, match="not a run_many checkpoint"):
        tck.load_many_slab(tmp_path / "plain.npz")


def test_checkpoint_resume_multiroot_equals_jax(both, tmp_path):
    """Mid-circuit checkpoint and resume (``content_blocks=None``) of a
    multi-root (pattern-set) run."""
    (ck, sk), (tck_, tsk) = both
    pats = ["/ab/", "/bc$/", "/zz/"]
    circuit = tex.compile_circuit(tsk.params, *compile_match_multi(3, pats))
    jc = jex.compile_circuit(sk.params, *jax_multi(3, pats))
    assert len(circuit.levels) >= 2
    jx, ex = _executors(sk, tsk)
    ct = J.encrypt_str(ck, "abc")
    want = jx.run(jc, ct)
    cp = tmp_path / "multi.npz"
    assert np.array_equal(ex.run(circuit, ct, checkpoint=str(cp),
                                 checkpoint_every=1), want)
    resumed = ex.run(circuit, None, resume=str(cp))
    assert np.array_equal(resumed, want)
    assert [port.decrypt(tck_, r) for r in resumed] == [1, 1, 0]


def test_checkpoint_resume_64bit_equals_jax(tmp_path):
    """At TEST_PARAMS_64 the port's checkpoint holds the JAX package's
    limb-pair slab of the same level, and its resume gives the JAX result;
    the JAX file, which has no fingerprint, is refused."""
    from fhe_regex_tpu.crypto.keys import gen_keys

    ck, sk = gen_keys(TEST_PARAMS_64, seed=5)
    tck_, tsk = client_key_from_jax(ck), server_key_from_jax(sk)
    circuit, jc = _circuits(tsk.params, sk.params, compile_match,
                            J.compile_match, 4, "/ab?c/")
    jx = J.executor_for(sk, "jnp64")
    ex = port.executor_for(tsk, device="cpu")
    ct = J.encrypt_str(ck, "xabc")
    jcp, cp = tmp_path / "jax64.npz", tmp_path / "port64.npz"
    want = jx.run(jc, ct, checkpoint=str(jcp), checkpoint_every=1)
    got = ex.run(circuit, ct, checkpoint=str(cp), checkpoint_every=1)
    assert got.dtype == np.uint64 and np.array_equal(got, want)
    with np.load(jcp) as z, np.load(cp) as t:
        assert set(t.files) == set(z.files) | {"fingerprint"}
        for k in z.files:
            assert t[k].dtype == z[k].dtype and np.array_equal(t[k], z[k])
    assert tck.load_slab(cp)[0].shape[-1] == 2          # [S, n+1, 2] words
    resumed = ex.run(circuit, None, resume=str(cp))
    assert np.array_equal(resumed, want) and port.decrypt(tck_, resumed) == 1
    with pytest.raises(ValueError, match="fingerprint None"):
        ex.run(circuit, None, resume=str(jcp))


def test_resume_refuses_another_circuit(both, tmp_path):
    """/abc/ and /abd/ over 4 characters have the same launch steps and C,
    so the JAX package resumes one from the other's checkpoint; the port
    refuses, naming both fingerprints (run_many and run)."""
    (ck, sk), (_, tsk) = both
    P, JP = tsk.params, sk.params
    ca, ja = _circuits(P, JP, compile_match, J.compile_match, 4, "/abc/")
    cb, jb = _circuits(P, JP, compile_match, J.compile_match, 4, "/abd/")
    jx, ex = _executors(sk, tsk)
    cts = _enc(ck, ["xabc", "abdx"])
    assert (len(ex._device_chunks_many(ca, 2, False))
            == len(ex._device_chunks_many(cb, 2, False)))
    jcp, cp = tmp_path / "jax.npz", tmp_path / "port.npz"
    jx.run_many(ja, cts, checkpoint=str(jcp), checkpoint_every=1)
    jx.run_many(jb, cts, resume=str(jcp))                 # accepted
    ex.run_many(ca, cts, checkpoint=str(cp), checkpoint_every=1)
    fa = tex.circuit_fingerprint(ca, 2, False,
                                 len(ex._device_chunks_many(ca, 2, False)))
    fb = tex.circuit_fingerprint(cb, 2, False,
                                 len(ex._device_chunks_many(cb, 2, False)))
    assert fa != fb and tck.load_fingerprint(cp) == fa
    with pytest.raises(ValueError, match="fingerprint") as ei:
        ex.run_many(cb, cts, resume=str(cp))
    assert fa in str(ei.value) and fb in str(ei.value)
    assert np.array_equal(ex.run_many(ca, cts, resume=str(cp)),
                          jx.run_many(ja, cts))
    lcp = tmp_path / "levels.npz"
    ex.run(ca, cts[0], checkpoint=str(lcp), checkpoint_every=1)
    with pytest.raises(ValueError, match="fingerprint"):
        ex.run(cb, None, resume=str(lcp))


def test_fingerprint_is_stable():
    """The fingerprint is a sha256 of the plan, the same for the same
    circuit compiled twice (no salted hash)."""
    P = port.get_params("TEST_PARAMS")
    a = tex.compile_circuit(P, *compile_match(4, "/abc/", fold="tree"))
    b = tex.compile_circuit(P, *compile_match(4, "/abc/", fold="tree"))
    m = tex.compile_circuit(P, *compile_match(4, "/abc/", fold="tree"),
                            multivalue=True)
    fp = tex.circuit_fingerprint(a)
    assert len(fp) == 64 and fp == tex.circuit_fingerprint(b)
    assert tex.circuit_fingerprint(a, 2, False, 3) != fp
    assert tex.circuit_fingerprint(m) != fp


@pytest.mark.parametrize("dtype", [np.int32, np.int64])
def test_files_without_fingerprint_match_jax(tmp_path, dtype):
    """fingerprint=None writes the JAX module's keys and arrays (a 64-bit
    slab as its int32 limb pairs), and each package loads the other's."""
    rng = np.random.default_rng(3)
    slab = rng.integers(np.iinfo(dtype).min, np.iinfo(dtype).max,
                        size=(16, 17), dtype=dtype)
    jslab = (slab if dtype == np.int32
             else slab.view(np.int32).reshape(16, 17, 2))
    for save, jsave, args in [
            (tck.save_slab, jck.save_slab, (3,)),
            (tck.save_many_slab, jck.save_many_slab, (2, 4, 7))]:
        t, j = tmp_path / "t.npz", tmp_path / "j.npz"
        save(t, slab, *args)
        jsave(j, jslab, *args)
        with np.load(t) as a, np.load(j) as b:
            assert sorted(a.files) == sorted(b.files)
            for k in b.files:
                assert a[k].dtype == b[k].dtype and np.array_equal(a[k], b[k])
        assert tck.load_fingerprint(t) is None
        save(t, slab, *args, fingerprint="f" * 64)
        assert tck.load_fingerprint(t) == "f" * 64
        load, jload = ((tck.load_slab, jck.load_slab) if save is tck.save_slab
                       else (tck.load_many_slab, jck.load_many_slab))
        for x, y in zip(jload(t), load(j)):
            assert np.array_equal(x, y)


def test_ciphertext_roundtrip_64():
    """save/load_ciphertext keep the uint64 words (the JAX module's)."""
    import tempfile

    ct = port.trivial_encrypt_str(port.get_params("TEST_PARAMS_64"), "abc")
    with tempfile.TemporaryDirectory() as d:
        tck.save_ciphertext(d + "/ct.npz", ct)
        back = jck.load_ciphertext(d + "/ct.npz")
    assert back.dtype == np.uint64 and np.array_equal(back, ct)


def _fresh_executor(tsk):
    P = tsk.params
    return tex.Executor(P, prepare_server_key(P, tsk, "cpu", "torch"))


def test_run_feeds_the_watchdog(both):
    """Executor.run observes each run under ("levels", pbs_count,
    num_slots, multivalue), as the JAX package's does."""
    (ck, _), (_, tsk) = both
    ex = _fresh_executor(tsk)
    circ = tex.compile_circuit(tsk.params, *compile_match(3, "/ab/"))
    ct = J.encrypt_str(ck, "abc")
    ex.run(circ, ct)
    ex.run(circ, ct)
    assert ex.watchdog._seen == {
        ("levels", circ.pbs_count, circ.num_slots, False): 2}


def test_run_many_feeds_the_watchdog(both):
    """run_many observes each call under ("many", C, pbs_count, num_slots,
    multivalue, wide_batch) (the JAX package's run_many has no watchdog);
    after the discarded first and the two seeding calls, /stats' snapshot
    shows its EMA."""
    (ck, _), (_, tsk) = both
    ex = _fresh_executor(tsk)
    circ = tex.compile_circuit(tsk.params, *compile_match(3, "/ab/"))
    cts = _enc(ck, ["abc", "xyz"])
    for _ in range(3):
        ex.run_many(circ, cts)
    key = ("many", 2, circ.pbs_count, circ.num_slots, False, False)
    assert ex.watchdog._seen == {key: 3}
    assert list(ex.watchdog.snapshot()) == [str(key)]
