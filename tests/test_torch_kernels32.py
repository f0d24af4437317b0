"""The per-step and batch-grid 32-bit blind rotations of the PyTorch port
against the JAX package's Pallas kernels #1, #2 and #4, bit for bit.

* The plain ``stage1_digits`` / ``external_product_step`` of
  ``fhe_regex_tpu_torch.ops.pbs`` equal the Pallas ``_stage1_kernel`` /
  ``_ext_product_kernel`` (interpret mode, as the JAX package's own tests
  run them on the CPU).
* The ``cuda`` backend's rotation (``pbs_cuda.blind_rotate_steps``) and the
  ``cuda-bg`` rotation (``pbs_cuda.blind_rotate_fused_bg``), on their CPU
  routes, equal JAX ``pallas`` and ``pallas-bg`` (two batch blocks and one).
* The kernel wrappers take the plain version on CPU tensors, launch
  nothing there, and validate batch blocks as the JAX package does.
* The layout of the tensor-core ``ext_product`` of ``csrc/blind_rotate.cu``
  (balanced int8 limbs of [g, -g], byte-shifted reversed windows read at
  the m16n8k32 fragment addresses, four int8 products combined mod 2^32)
  is replayed by a plain int64 twin and equals ``external_product_step``.
* So is the redesigned digit pass ``stage1`` (segments staged in padded
  shared memory by 16-byte groups, 16 coefficients a thread, 16-byte plane
  stores): its twin equals ``stage1_digits`` at edge rotations, N = 256
  and 2048; its segment rule fills the card at B = 8; the wrappers refuse
  an acc that is not 16-byte aligned.

Inputs come from numpy seeds and the shared ``keys`` / ``noisy_keys``
fixtures; tolerance is zero (integer arithmetic mod 2^32).  The CUDA
kernels themselves are held against these plain versions on the card by
``chip_smoke.py``.
"""

import dataclasses
import shutil

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fhe_regex_tpu.crypto import lwe as jlwe
from fhe_regex_tpu.crypto.golden import make_lut_poly
from fhe_regex_tpu.ops import pbs as jpbs
from fhe_regex_tpu.ops import pbs_pallas
from fhe_regex_tpu.params import TEST_PARAMS, TEST_PARAMS_NOISY

from fhe_regex_tpu_torch.convert import server_key_from_jax
from fhe_regex_tpu_torch.ops import pbs as tpbs
from fhe_regex_tpu_torch.ops import pbs_cuda

torch.set_num_threads(2)


@pytest.fixture(autouse=True)
def _keep_launch_counts():
    """The tests that stand in for the card count launches and rotation
    steps; give the process-wide counts back, so that a later test in the
    same process (``/stats`` ``kernel_launches``) sees only its own."""
    counts = {k: k.launches for k in pbs_cuda.KERNELS}
    rotations = dict(pbs_cuda._ROTATION_LAUNCHES)
    steps = dict(pbs_cuda._ROTATION_STEPS)
    yield
    for k, n in counts.items():
        k.launches = n
    pbs_cuda._ROTATION_LAUNCHES.update(rotations)
    pbs_cuda._ROTATION_STEPS.update(steps)


def _t(a: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(a).view(np.int32))


def _j(a: np.ndarray):
    return jnp.asarray(np.ascontiguousarray(a).view(np.int32))


def _random_u32(rng, shape) -> np.ndarray:
    return rng.integers(0, 1 << 32, size=shape, dtype=np.uint64).astype(np.uint32)


def _port_params(params):
    from fhe_regex_tpu_torch.params import get_params
    return get_params(params.name)


def _rotations(rng, B, N):
    """Rotation amounts in [0, 2N), edges first."""
    edges = np.array([0, 1, N - 1, N, N + 1, 2 * N - 1], np.int32)
    return np.concatenate([edges, rng.integers(0, 2 * N, size=B)])[:B].astype(
        np.int32)


@pytest.mark.parametrize("B", [8, 32, 5])
def test_stage1_digits_matches_pallas(B):
    """B = 32 takes the kernel's int8 output, 8 and 5 its int32 one: the
    values agree either way, rows (component, level), MSD first."""
    P = TEST_PARAMS_NOISY
    N = P.polynomial_size
    rng = np.random.default_rng(B)
    acc = _random_u32(rng, (B, P.glwe_dimension + 1, N))
    acc[0, 0, :4] = [0, 0x7FFFFFFF, 0x80000000, 0xFFFFFFFF]
    a = _rotations(rng, B, N)
    want = np.asarray(pbs_pallas.stage1_digits(P, _j(acc), jnp.asarray(a)))
    got = tpbs.stage1_digits(_port_params(P), _t(acc), torch.from_numpy(a))
    rows = (P.glwe_dimension + 1) * P.pbs_level
    assert got.dtype == torch.int8 and got.shape == (B, rows, N)
    assert np.array_equal(got.numpy().astype(np.int32).reshape(B, rows * N),
                          want.astype(np.int32))


@pytest.mark.parametrize("B", [8, 32])
def test_external_product_step_matches_pallas(B):
    P = TEST_PARAMS_NOISY
    N, k1 = P.polynomial_size, P.glwe_dimension + 1
    rows = k1 * P.pbs_level
    rng = np.random.default_rng(100 + B)
    half = 1 << (P.pbs_base_log - 1)
    digits = rng.integers(-half, half + 1, size=(B, rows, N)).astype(np.int8)
    digits[0, 0, :2] = [-half, half]
    ggsw = _random_u32(rng, (1, rows, k1, N))
    acc = _random_u32(rng, (B, k1, N))
    quad = pbs_pallas.prepare_bsk_pallas(P, ggsw)[0]
    want = pbs_pallas.external_product_step(
        P, jnp.asarray(digits.reshape(B, rows * N).astype(np.int32)),
        pbs_pallas._group_quad(P, jnp.asarray(quad)), _j(acc), jnp.int8,
        flat_digits=True)
    acc_t = _t(acc)
    got = tpbs.external_product_step(_port_params(P),
                                     torch.from_numpy(digits), _t(ggsw[0]),
                                     acc_t)
    assert np.array_equal(got.numpy(), np.asarray(want))
    assert np.array_equal(acc_t.numpy(), acc.view(np.int32))   # untouched


# ---- the layout of csrc/blind_rotate.cu's ext_product, replayed ----
EXT_TN, EXT_NT = 64, 2      # coefficients per block; n8 tiles per warp
M32 = 0xFFFFFFFF


def _limbs8(w: torch.Tensor) -> torch.Tensor:
    """[...] uint32 values in int64 -> [4, ...] balanced int8 limbs with
    w = sum_l 2^(8l) limb_l mod 2^32 (the kernel's ``limbs8``)."""
    w = w & M32
    out = []
    for _ in range(4):
        v = ((w + 128) & 0xFF) - 128
        out.append(v)
        w = ((w - v) & M32) >> 8
    return torch.stack(out)


def _ext_product_twin(digits, ggsw, acc):
    """The kernel's arithmetic in int64 on the CPU.  Column m of block
    M0 = m - m % 64 and row t come from lane groupID g = m % 8, n8 tile
    (m % 64) // 8, thread-in-group (t % 16) // 4 and half t % 32 // 16 of
    a 32-deep k-step; the B-fragment word is read from byte-shifted copy
    s = (3 - g) & 3 at byte (yb - s) + 16 * half + t % 4, copy s byte i
    holding rev[i + s], rev[y] = limbs of dbl[(M0 + 63 - y) mod 2N]."""
    B, rows, N = digits.shape
    k1 = ggsw.shape[1]
    g64 = ggsw.to(torch.int64) & M32
    dbl = torch.cat([g64, (-g64) & M32], -1)                  # [rows, k1, 2N]
    m, t = torch.arange(N), torch.arange(N)
    M0 = m - m % EXT_TN
    g = (m - M0) % 8
    s = (3 - g) & 3
    half, tig, j = (t % 32) // 16, (t % 16) // 4, t % 4
    yb = (t - t % 32 + tig * 4)[:, None] + EXT_TN - 1 - (m - M0)[None, :]
    assert ((yb - s) % 4 == 0).all()                    # aligned word loads
    byte = (yb - s) + 16 * half[:, None] + j[:, None]
    assert (byte >= 0).all() and (byte < N + EXT_TN).all()   # inside a copy
    z = (M0[None, :] + EXT_TN - 1 - (byte + s)) % (2 * N)
    L = _limbs8(dbl[:, :, z])                        # [4, rows, k1, t, m]
    Bm = L.permute(0, 1, 3, 2, 4).reshape(4, rows * N, k1 * N)
    assert Bm.abs().max() <= 128
    d = digits.reshape(B, rows * N).to(torch.int64)
    out = acc.to(torch.int64).reshape(B, -1)
    for l in range(4):
        p = d @ Bm[l]
        assert p.abs().max() < 2 ** 31                  # exact in int32
        out = out + p * (1 << (8 * l))
    return tpbs.wrap_i32(out & M32).reshape(B, k1, N)


def test_limbs8_are_balanced():
    words = torch.tensor([0, 0x7F, 0x80, 0xFF, 0x80000000, 0xFFFFFFFF,
                          0x7F7F7F80, 0x80808080, 0x807F80FF],
                         dtype=torch.int64)
    L = _limbs8(words)
    assert L.min() >= -128 and L.max() <= 127
    assert (L[:, 6] == -128).all()            # every limb of 0x7F7F7F80
    back = sum(L[l] * (1 << (8 * l)) for l in range(4)) & M32
    assert torch.equal(back, words)


@pytest.mark.parametrize("B", [1, 8, 37])
def test_ext_product_limb_layout_matches_plain(B):
    """Keys with the words 0x80000000, 0xFFFFFFFF and words whose limbs
    are -128; digits at both ends of [-64, 64)."""
    P = _port_params(TEST_PARAMS)
    N, k1 = P.polynomial_size, P.glwe_dimension + 1
    rows = k1 * P.pbs_level
    rng = np.random.default_rng(500 + B)
    ggsw = _random_u32(rng, (rows, k1, N))
    ggsw.reshape(-1)[:8] = [0x80000000, 0xFFFFFFFF, 0x7F7F7F80, 0x80808080,
                            0x80000080, 0, 1, 0x7FFFFFFF]
    ggsw[2, 1, -4:] = [0x7F7F7F80, 0xFFFFFFFF, 0x80000000, 0x80]
    digits = rng.integers(-64, 64, size=(B, rows, N)).astype(np.int8)
    digits[0, 0, :3] = [-64, 63, -64]
    acc = _random_u32(rng, (B, k1, N))
    want = tpbs.external_product_step(P, torch.from_numpy(digits),
                                      _t(ggsw), _t(acc))
    got = _ext_product_twin(torch.from_numpy(digits), _t(ggsw), _t(acc))
    assert torch.equal(got, want)


def _msgs_and_luts(params, keys, B, seed):
    ck, sk = keys
    rng = np.random.default_rng(seed)
    msgs = rng.integers(0, 16, size=B)
    cts = np.stack([jlwe.encrypt_lwe(params, ck.lwe_key, int(m), ck.rng)
                    for m in msgs])
    fs = [lambda x: (3 * x + 1) % 16, lambda x: (x * 7 + 2) % 16]
    luts = np.stack([make_lut_poly(params, f) for f in fs])
    idx = (np.arange(B) % 2).astype(np.int32)
    return msgs, fs, cts, luts, idx


def _port_pbs(params, sk, rotate, luts, idx, cts):
    """The port's PBS on the CPU with `rotate` as its blind rotation."""
    tsk = server_key_from_jax(sk)
    dev = tpbs.prepare_server_key(tsk.params, tsk, "cpu", "torch")
    ms = tpbs.mod_switch(tsk.params, _t(cts))
    acc = rotate(tsk.params, dev.bsk, _t(luts), torch.from_numpy(idx), ms)
    return tpbs.key_switch(tsk.params, dev.ksk,
                           tpbs.sample_extract(tsk.params, acc))


@pytest.mark.parametrize("fixture,params", [("keys", TEST_PARAMS),
                                            ("noisy_keys", TEST_PARAMS_NOISY)])
def test_blind_rotate_steps_matches_pallas_backend(request, fixture, params):
    """The ``cuda`` backend's rotation == JAX ``pbs_batch_pallas``."""
    keys = request.getfixturevalue(fixture)
    ck, sk = keys
    msgs, fs, cts, luts, idx = _msgs_and_luts(params, keys, 8, seed=3)
    want = jpbs.make_pbs_fn(jpbs.prepare_server_key(params, sk, "pallas"))(
        _j(luts), jnp.asarray(idx), _j(cts))
    got = _port_pbs(params, sk, pbs_cuda.blind_rotate_steps, luts, idx, cts)
    assert np.array_equal(got.numpy(), np.asarray(want))
    out = got.numpy().view(np.uint32)
    dec = [jlwe.decrypt_lwe(params, ck.lwe_key, out[i]) for i in range(8)]
    assert dec == [fs[idx[i]](int(m)) for i, m in enumerate(msgs)]


@pytest.mark.parametrize("tb", [16, 8])
def test_blind_rotate_bg_matches_pallas_bg(noisy_keys, monkeypatch, tb):
    """The ``cuda-bg`` rotation == JAX ``pallas-bg`` at B = 16, in one
    batch block (tb = 16, the default) and in two (tb = 8)."""
    P = TEST_PARAMS_NOISY
    ck, sk = noisy_keys
    msgs, fs, cts, luts, idx = _msgs_and_luts(P, noisy_keys, 16, seed=tb)
    monkeypatch.setenv("FHE_REGEX_BG_TB", str(tb))
    want = jpbs.make_pbs_fn(jpbs.prepare_server_key(P, sk, "pallas-bg"))(
        _j(luts), jnp.asarray(idx), _j(cts))

    def rotate(*args):
        return pbs_cuda.blind_rotate_fused_bg(*args, tb=tb)

    got = _port_pbs(P, sk, rotate, luts, idx, cts)
    assert np.array_equal(got.numpy(), np.asarray(want))
    out = got.numpy().view(np.uint32)
    dec = [jlwe.decrypt_lwe(P, ck.lwe_key, out[i]) for i in range(16)]
    assert dec == [fs[idx[i]](int(m)) for i, m in enumerate(msgs)]


@pytest.mark.parametrize("B", [8, 16, 24, 40, 96, 896, 1024, 1792, 3584,
                               1000, 12, 4, 7])
@pytest.mark.parametrize("cap", [pbs_cuda.BG_CAP, pbs_cuda.BG64_CAP])
def test_bg_block_matches_jax(B, cap):
    assert pbs_cuda._bg_block(B, cap) == pbs_pallas._bg_block(B, cap)


@pytest.mark.parametrize("B,tb", [(16, 8), (16, 16), (16, 12), (16, 32),
                                  (24, 16), (24, 0), (24, -8), (1024, 512)])
def test_check_bg_tb_matches_jax(B, tb):
    def raises(fn):
        try:
            fn(B, tb)
        except ValueError:
            return True
        return False

    assert (raises(pbs_cuda._check_bg_tb)
            == raises(pbs_pallas._check_bg_tb))


def _rotation_args(noisy_keys, B, seed):
    P = TEST_PARAMS_NOISY
    _, sk = noisy_keys
    _, _, cts, luts, idx = _msgs_and_luts(P, noisy_keys, B, seed)
    tsk = server_key_from_jax(sk)
    ms = tpbs.mod_switch(tsk.params, _t(cts))
    return (tsk.params, _t(tsk.bsk), _t(luts), torch.from_numpy(idx), ms)


def test_bg_wrapper_blocks(noisy_keys):
    """Default tb at 32 bits is the JAX package's (cap 896); a batch with
    no 8-aligned block, or a bad explicit tb, raises as in JAX."""
    args = _rotation_args(noisy_keys, 16, seed=7)
    before = pbs_cuda.blind_rotate_fused_bg.launches
    want = tpbs.blind_rotate(*args)
    for tb in (None, 16, 8):
        assert torch.equal(pbs_cuda.blind_rotate_fused_bg(*args, tb=tb), want)
    assert pbs_cuda.blind_rotate_fused_bg.launches == before
    with pytest.raises(ValueError, match="invalid for B=16"):
        pbs_cuda.blind_rotate_fused_bg(*args, tb=12)
    # B = 4 has no 8-aligned block; at B = 12 both packages pick tb = 12
    # and then refuse it
    for B, msg in ((4, "8-aligned blocks"), (12, "invalid for B=12")):
        odd = _rotation_args(noisy_keys, B, seed=B)
        with pytest.raises(ValueError, match=msg):
            pbs_cuda.blind_rotate_fused_bg(*odd)
        with pytest.raises(ValueError, match=msg):
            pbs_pallas.blind_rotate_fused_bg(
                TEST_PARAMS_NOISY, jnp.zeros((1, 1), jnp.int32), None, None,
                jnp.zeros((B, TEST_PARAMS_NOISY.lwe_dimension + 1),
                          jnp.int32))


def test_step_wrappers_take_plain_path_on_cpu(noisy_keys):
    """On CPU tensors the per-step wrappers are the plain versions and
    launch nothing; the rotation built from them equals ``blind_rotate``."""
    args = _rotation_args(noisy_keys, 5, seed=9)
    params, bsk, luts, idx, ms = args
    counts = (pbs_cuda.stage1_digits.launches,
              pbs_cuda.external_product_step.launches)
    acc = tpbs.init_accumulator(params, luts, idx, ms)
    a = ms[:, 0].contiguous()
    d = pbs_cuda.stage1_digits(params, acc, a)
    assert torch.equal(d, tpbs.stage1_digits(params, acc, a))
    nxt = pbs_cuda.external_product_step(params, d, bsk[0], acc)
    assert torch.equal(nxt, tpbs.external_product_step(params, d, bsk[0],
                                                       acc))
    assert torch.equal(pbs_cuda.blind_rotate_steps(*args),
                       tpbs.blind_rotate(*args))
    assert (pbs_cuda.stage1_digits.launches,
            pbs_cuda.external_product_step.launches) == counts


def test_step_wrappers_reject_other_devices():
    from fhe_regex_tpu_torch.params import get_params

    p = get_params("TEST_PARAMS")
    meta = torch.empty((2, 2, p.polynomial_size), dtype=torch.int32,
                       device="meta")
    with pytest.raises(ValueError, match="no stage1 kernel"):
        pbs_cuda.stage1_digits(p, meta, meta)
    with pytest.raises(ValueError, match="no external product kernel"):
        pbs_cuda.external_product_step(p, meta, meta, meta)
    ms = torch.empty((8, p.lwe_dimension + 1), dtype=torch.int32,
                     device="meta")
    with pytest.raises(ValueError, match="no blind rotation kernel"):
        pbs_cuda.blind_rotate_fused_bg(p, ms, ms, ms, ms)


@pytest.mark.parametrize("backend,device,want", [
    ("cuda", "cuda", "cuda"),
    ("cuda-bg", "cuda:0", "cuda-bg"),
    (None, "cuda", "cuda-fused"),
])
def test_resolve_new_backends(backend, device, want):
    from fhe_regex_tpu_torch.params import get_params

    p = get_params("TPU_MESSAGE_2_CARRY_2")
    assert tpbs.resolve_backend(backend, device, p) == want


@pytest.mark.parametrize("backend", ["cuda", "cuda-bg"])
def test_new_backends_need_cuda_and_32_bits(keys, backend):
    from fhe_regex_tpu_torch.params import get_params

    tsk = server_key_from_jax(keys[1])
    with pytest.raises(ValueError, match="needs a CUDA device"):
        tpbs.prepare_server_key(tsk.params, tsk, "cpu", backend)
    with pytest.raises(ValueError, match="needs a 32-bit"):
        tpbs.resolve_backend(backend, "cuda",
                             get_params("TPU64_MESSAGE_2_CARRY_2"))


# ---- the index arithmetic of csrc/blind_rotate.cu's stage1, replayed ----
SEG_MIN, SEG_MAX, PER_THREAD, WAVE = 128, 1024, 16, 132


def _segment(B, k1, N):
    """``stage1_segment`` of csrc/hopper.cuh: the longest power of two in
    [128, min(N, 1024)] still giving B * k1 * N / S >= 132 blocks."""
    S = min(N, SEG_MAX)
    while S > SEG_MIN and B * k1 * (N // S) < WAVE:
        S //= 2
    return S


def _spad(w):
    return w + (w >> 4)


def _stage1_twin(acc, a, level, base_log, S):
    """``stage1``'s arithmetic in int64 on the CPU, block by block: acc
    [B, k1, N] uint32 values (numpy int64), a [B] -> [B, k1*level, N] int8.

    Block (b, segment, c) stages acc[b, c, m0 : m0+S) and the source run
    from q0 = u0 - off, u0 = (m0 - a) mod N, in 16-byte groups at padded
    shared positions w + w // 16, thread t loading groups t + kT of each
    (k < 4; thread 0 also the source run's last); thread t takes
    coefficients 16t + q,
    reads source word off + i, flips its sign when (s0 + i) & N, and
    writes each digit plane with one 16-byte store.  Every shared read must
    hit a staged word, a warp's reads 32 banks, every group and store 16
    bytes aligned, and every output byte be written once."""
    B, k1, N = acc.shape
    M = 0xFFFFFFFF
    T, G = S // PER_THREAD, 4                  # threads; words per group
    assert S // G == T * (PER_THREAD // G)   # thread t: groups t + kT
    R = _spad(S - 1) + 1                       # the source run's offset
    words = R + _spad(S + G - 1) + 1
    out = np.zeros(B * k1 * level * N, np.int64)
    written = np.zeros(out.shape, np.int64)
    g_acc, g_src = np.arange(S // G), np.arange((S + G) // G)
    e = np.arange(G)
    t, q = np.arange(T)[:, None], np.arange(PER_THREAD)[None, :]
    i = t * PER_THREAD + q                                        # [T, 16]
    shift = 32 - base_log * level
    mask, half = (1 << base_log) - 1, 1 << (base_log - 1)
    for b in range(B):
        for sg in range(N // S):
            m0 = sg * S
            s0 = (m0 - int(a[b])) & (2 * N - 1)
            u0 = s0 & (N - 1)
            off = u0 & 3
            for c in range(k1):
                p = acc[b, c]
                sm = np.full(words, -1, np.int64)             # -1: not staged
                for start, gs, base_w in ((m0, g_acc, 0),
                                          (u0 - off, g_src, R)):
                    first = (start + gs * G) & (N - 1)
                    assert (first % G == 0).all() and (first + G <= N).all()
                    pos = base_w + _spad(gs[:, None] * G + e[None, :])
                    assert len(np.unique(pos)) == pos.size
                    sm[pos] = p[first[:, None] + e[None, :]]
                src_pos = R + _spad(off + i)
                for w0 in range(0, T, 32):                    # one warp
                    for qq in range(PER_THREAD):
                        banks = src_pos[w0:w0 + 32, qq] % 32
                        assert len(set(banks)) == banks.size
                        banks = _spad(i[w0:w0 + 32, qq]) % 32
                        assert len(set(banks)) == banks.size
                v, own = sm[src_pos], sm[_spad(i)]
                assert (v >= 0).all() and (own >= 0).all()
                rot = np.where((s0 + i) & N, (-v) & M, v)
                st = (((rot - own) & M) + (1 << (shift - 1))) & M
                st >>= shift
                row = (b * k1 + c) * level
                for j in range(level - 1, -1, -1):
                    d = st & mask
                    sd = np.where(d >= half, d - mask - 1, d)
                    st = ((st - sd) & M) >> base_log
                    store = (row + j) * N + m0 + t[:, 0] * PER_THREAD
                    assert (store % 16 == 0).all()
                    at = store[:, None] + q
                    out[at] = ((sd + 128) & 255) - 128
                    written[at] += 1
    assert (written == 1).all()
    return torch.from_numpy(out.reshape(B, k1 * level, N).astype(np.int8))


def _edge_rotations(N, rng, extra):
    edges = [0, 1, 15, 16, 17, N - 16, N - 1, N, N + 1, 2 * N - 16, 2 * N - 1]
    return np.array(edges + list(rng.integers(0, 2 * N, size=extra)),
                    np.int32)


def _edge_acc(rng, B, k1, N):
    """Random uint32 rows with the torus edge words planted at both ends
    of a row and around N/2."""
    acc = _random_u32(rng, (B, k1, N)).astype(np.int64)
    words = [0, 1, 0x7FFFFFFF, 0x80000000, 0x80000001, 0xFFFFFFFF]
    acc[:, 0, :6] = words
    acc[:, -1, -6:] = words
    acc[::2, :, N // 2 - 3:N // 2 + 3] = words
    return acc


@pytest.mark.parametrize("N,S", [(256, 128), (256, 256), (2048, 128),
                                 (2048, 512), (2048, 1024)])
def test_stage1_twin_matches_plain(N, S):
    """The replay of the redesigned ``stage1`` equals the plain
    ``stage1_digits`` for the edge rotations (0, 1, 15, 16, 17, N-16, N-1,
    N, N+1, 2N-16, 2N-1) and random ones, at segments of 128 to 1024."""
    P = dataclasses.replace(_port_params(TEST_PARAMS), polynomial_size=N)
    k1 = P.glwe_dimension + 1
    rng = np.random.default_rng(N + S)
    a = _edge_rotations(N, rng, 3)
    acc = _edge_acc(rng, a.size, k1, N)
    want = tpbs.stage1_digits(P, _t(acc.astype(np.uint32)),
                              torch.from_numpy(a))
    got = _stage1_twin(acc, a, P.pbs_level, P.pbs_base_log, S)
    assert torch.equal(got, want)


@pytest.mark.parametrize("base_log,level", [(1, 31), (4, 7), (7, 4)])
def test_stage1_twin_other_gadgets(base_log, level):
    """Gadgets the wrapper admits beyond base 2^7 x 3: one bit of rounding
    left (31 x 1) and planes past the third."""
    P = dataclasses.replace(_port_params(TEST_PARAMS), pbs_base_log=base_log,
                            pbs_level=level)
    N, k1 = P.polynomial_size, P.glwe_dimension + 1
    rng = np.random.default_rng(base_log)
    a = _edge_rotations(N, rng, 1)
    acc = _edge_acc(rng, a.size, k1, N)
    want = tpbs.stage1_digits(P, _t(acc.astype(np.uint32)),
                              torch.from_numpy(a))
    got = _stage1_twin(acc, a, level, base_log, _segment(a.size, k1, N))
    assert torch.equal(got, want)


@pytest.mark.parametrize("B,N,S", [(8, 2048, 128), (16, 2048, 256),
                                   (37, 2048, 1024), (256, 2048, 1024),
                                   (512, 2048, 1024), (8, 256, 128),
                                   (256, 256, 256), (1, 4096, 128)])
def test_stage1_segment_fills_the_card(B, N, S):
    """Segments: a full wave of blocks (132 SMs) at B = 8 on the production
    N, the longest segment that keeps one at wider levels."""
    assert _segment(B, 2, N) == S
    assert B * 2 * (N // S) >= WAVE or S == SEG_MIN


def _misaligned(shape, dtype):
    flat = torch.zeros(int(np.prod(shape)) + 1, dtype=dtype)
    return flat[1:].view(shape)


def test_stage1_wrappers_refuse_misaligned_acc(monkeypatch):
    """On the CUDA route, an acc that does not start on 16 bytes raises
    before anything is launched (the device is faked as CUDA here)."""
    from fhe_regex_tpu_torch.params import get_params

    monkeypatch.setattr(pbs_cuda, "_on_cuda", lambda what, t: True)
    monkeypatch.setattr(pbs_cuda, "_call", None)          # never reached
    p = get_params("TEST_PARAMS")
    k1, N = p.glwe_dimension + 1, p.polynomial_size
    a = torch.zeros(4, dtype=torch.int32)
    acc = _misaligned((4, k1, N), torch.int32)
    assert acc.data_ptr() % 16
    with pytest.raises(ValueError, match="16-byte boundary"):
        pbs_cuda.stage1_digits(p, acc, a)
    p64 = get_params("TEST_PARAMS_64")
    with pytest.raises(ValueError, match="16-byte boundary"):
        pbs_cuda.stage1_digits64(p64, _misaligned((4, k1, N), torch.int64),
                                 a)


def test_library_path_hashes_the_shared_header(tmp_path, monkeypatch):
    """An edit of csrc/hopper.cuh, which both sources include, names a new
    build: no stale library is loaded."""
    src = tmp_path / "csrc"
    shutil.copytree(pbs_cuda.CSRC, src)
    monkeypatch.setattr(pbs_cuda, "CSRC", src)
    before = pbs_cuda.library_path()
    header = src / "hopper.cuh"
    header.write_text(header.read_text() + "\n")
    assert pbs_cuda.library_path() != before


# ---- the spectral rotation of cuda-fused / cuda-bg, its arithmetic ----
# csrc/blind_rotate.cu's spectral::ext_product runs each CMUX step as
# _spectral_step below computes it: fold and twist, Stockham transforms of
# radix 16, 16, 4 on slots stored at swz(k), contraction with the key's
# limb spectra (SPECTRAL_PLAN (16, 16), the kernel's; PLAN (16, 8, 8), the
# ``fft`` backend's, is held too), inverse, per-limb rounding,
# recombination mod 2^32.  The twin must equal the exact step bit for bit.
# _pair_step is the twin of the cluster pair (spectral::pair), which
# narrow batches run: a component's rows a block, radix 8, 8, 16 on pswz
# slots, partial sums of every output exchanged between the two blocks.

#: (kernel's plan, fft backend's plan), the limb plans the twin is run on
PLANS = [(16, 16), (16, 8, 8)]
#: the twins a step is held with: the one-block kernel's on either plan,
#: and the cluster pair's (on SPECTRAL_PLAN, the only plan it runs)
TWINS = PLANS + ["pair"]


def _twin_plan(twin) -> tuple:
    return (16, 16) if twin == "pair" else twin


def _swz(k: torch.Tensor) -> torch.Tensor:
    """The kernel's shared-memory slot of point k (bank-conflict swizzle)."""
    return k ^ ((k >> 4) & 7)


def _pswz(k: torch.Tensor) -> torch.Tensor:
    """The cluster pair's slot of point k (``pair::pswz``)."""
    return k ^ ((k >> 3) & 7) ^ ((k >> 6) & 1)


def _pair_radices(M: int) -> tuple:
    """The cluster pair's forward radices: 8 while more than 16 points are
    left, then 16 ((8, 8, 16) at M = 1024); its inverse runs them
    backwards."""
    out = []
    while M > 16:
        out.append(8)
        M //= 8
    assert M == 16, "the pair's transforms end in radix 16"
    return tuple(out) + (16,)


def _radices(M: int) -> tuple:
    """The radices of the length-M transform: 16 while 16 divides what is
    left, then the rest ((16, 16, 4) at M = 1024, the kernel's)."""
    out = []
    while M % 16 == 0 and M > 16:
        out.append(16)
        M //= 16
    return tuple(out) + ((M,) if M > 1 else ())


def _dft_matrix(R: int, inverse: bool) -> torch.Tensor:
    r = torch.arange(R)
    sign = 1.0 if inverse else -1.0
    return torch.exp(sign * 2j * np.pi * torch.outer(r, r).to(torch.float64)
                     / R)


def _dft16_pair(v: torch.Tensor, inverse: bool) -> torch.Tensor:
    """The 16-point DFTs over axis -2 of v [..., 16, T] as the cluster
    pair's lane pair computes them: lane h the 8-point DFT Y_h of inputs
    h + 2 u, then X[k + 8 k1] = Y_0[k] + (-1)^k1 W16^k Y_1[k]."""
    Y0 = _dft(v[..., 0::2, :], inverse)
    Y1 = _dft(v[..., 1::2, :], inverse) * _dft_matrix(16, inverse)[1, :8,
                                                                   None]
    return torch.cat([Y0 + Y1, Y0 - Y1], dim=-2)


def _dft(v: torch.Tensor, inverse: bool, pair: bool = False) -> torch.Tensor:
    """The R-point DFTs over axis -2 of v [..., R, T].  At R = 16 as the
    kernel's dft16: a 4 x 4, point n1 + 4 n2, whose output q lands in
    register 4 (q mod 4) + q div 4 (at16) and is read back from there; on
    the cluster pair (``pair``) as its lane pair's 2 x 8."""
    R = v.shape[-2]
    if R == 16 and pair:
        return _dft16_pair(v, inverse)
    if R != 16:
        return torch.einsum("qr,...rt->...qt", _dft_matrix(R, inverse), v)
    F4 = _dft_matrix(4, inverse)
    x = v.reshape(*v.shape[:-2], 4, 4, v.shape[-1])            # [n2, n1]
    x = torch.einsum("kn,...nit->...kit", F4, x)                # [k2, n1]
    x = x * _dft_matrix(16, inverse)[:4, :4, None]              # w^(k2 n1)
    regs = torch.einsum("kn,...jnt->...jkt", F4, x).reshape(v.shape)
    q = torch.arange(16)
    return regs[..., 4 * (q & 3) + (q >> 2), :]


def _stockham(buf: torch.Tensor, w: torch.Tensor, inverse: bool = False,
              pair: bool = False) -> torch.Tensor:
    """The kernel's unnormalised transform of every slot of buf [..., M],
    point k stored at _swz(k), natural order in and out: pass p of radix R
    reads x[j + r M/R] for j < M/R, multiplies it by v^r, v = w[(j mod Ns)
    M/(Ns R)] (Ns the product of the earlier radices; v^r by repeated
    multiplication, as the kernel takes it, conjugated for the inverse),
    and writes output q to (j div Ns) Ns R + (j mod Ns) + q Ns.  On the
    cluster pair (``pair``): its radices (``_pair_radices``, backwards for
    the inverse), its slots (``_pswz``) and its radix-16 pass."""
    M = buf.shape[-1]
    tw = torch.conj(w) if inverse else w
    if pair:
        swz, radices = _pswz, _pair_radices(M)[::-1 if inverse else 1]
    else:
        swz, radices = _swz, _radices(M)
    Ns = 1
    for R in radices:
        T = M // R
        j, r = torch.arange(T), torch.arange(R)
        v = buf[..., swz(j[None, :] + r[:, None] * T)]         # [..., R, T]
        base = tw[(j % Ns) * (M // (Ns * R))]
        powers = torch.cumprod(base.expand(R - 1, T), dim=0)   # v^1 .. v^(R-1)
        v = torch.cat([v[..., :1, :], v[..., 1:, :] * powers], dim=-2)
        buf = torch.empty_like(buf)
        dest = ((j // Ns) * Ns * R + j % Ns)[None, :] + r[:, None] * Ns
        buf[..., swz(dest)] = _dft(v, inverse, pair)
        Ns *= R
    return buf


def _spectral_step(digits: torch.Tensor, spec_i: torch.Tensor,
                   acc: torch.Tensor, plan: tuple = (16, 16)):
    """One CMUX step's external product as the spectral kernel computes it:
    digits [B, (k+1)l, N] int8, spec_i [(k+1)l, k+1, L, M] complex128 (one
    step of the spectral key on the limb plan ``plan``, L = len(plan)), acc
    [B, k+1, N] int32 -> (the new acc, the largest distance of any limb's
    value from its integer).

    Fold and twist each digit row, u_j = (d_j + i d_{j+M}) t_j, into its
    swizzled slot; transform; contract each frequency over the rows with
    the key's spectra; inverse transform, untwist, divide by M; round each
    limb to its integer, scale it by 2^weight and add it to acc mod 2^32."""
    from fhe_regex_tpu_torch.ops import pbs_fft

    tw, w = pbs_fft.spectral_tables(digits.shape[-1])
    D = _forward(digits, w, tw, pair=False)                   # [B, rows, M]
    P = torch.einsum("brm,rclm->bclm", D, spec_i)             # [B, k1, L, M]
    return _inverse_into(P, acc, w, tw, plan, pair=False)


def _forward(digits: torch.Tensor, w, tw, pair: bool) -> torch.Tensor:
    """Each digit row [..., N] folded, twisted and transformed by the
    one-block kernel's passes or the pair's, in natural order [..., M]."""
    M = digits.shape[-1] // 2
    slot = (_pswz if pair else _swz)(torch.arange(M))
    d = digits.to(torch.float64)
    buf = torch.empty(d.shape[:-1] + (M,), dtype=torch.complex128)
    buf[..., slot] = torch.complex(d[..., :M], d[..., M:]) * tw
    return _stockham(buf, w, pair=pair)[..., slot]


def _inverse_into(P: torch.Tensor, acc: torch.Tensor, w, tw, plan: tuple,
                  pair: bool):
    """The output spectra P [B, k1, L, M] inverted, untwisted and divided
    by M; each limb rounded to its integer, scaled by 2^weight and added to
    acc mod 2^32 -> (the new acc, the largest distance of a limb's value
    from its integer)."""
    from fhe_regex_tpu_torch.ops import pbs_fft

    M = P.shape[-1]
    slot = (_pswz if pair else _swz)(torch.arange(M))
    buf = torch.empty_like(P)
    buf[..., slot] = P
    y = (_stockham(buf, w, inverse=True, pair=pair)[..., slot]
         * torch.conj(tw) * (1 / M))
    vals = torch.cat([y.real, y.imag], dim=-1)                # [B, k1, L, N]
    r = torch.round(vals)
    weights = torch.tensor([1 << s for s in pbs_fft.plan_weights(plan)],
                           dtype=torch.int64)[:, None]
    out = (r.to(torch.int64) * weights).sum(dim=2)
    return (tpbs.wrap_i32(acc.to(torch.int64) + out),
            float((vals - r).abs().max()))


def _pair_step(digits: torch.Tensor, spec_i: torch.Tensor,
               acc: torch.Tensor):
    """One CMUX step as the cluster pair computes it (``spectral::pair``,
    k + 1 = 2 components, the key on SPECTRAL_PLAN): block c transforms
    the l digit rows of its component, contracts them with those rows of
    the key into partial spectra of every output (component, limb), and
    inverts, for its own component, its own partial plus the peer's, in
    that order -> (the new acc, the largest distance of a limb's value
    from its integer)."""
    from fhe_regex_tpu_torch.ops import pbs_fft

    k1 = acc.shape[1]
    assert k1 == 2, "a component a block of the pair"
    l = digits.shape[1] // k1
    tw, w = pbs_fft.spectral_tables(digits.shape[-1])
    D = _forward(digits, w, tw, pair=True)                    # [B, rows, M]
    part = [torch.einsum("brm,rclm->bclm", D[:, c * l:(c + 1) * l],
                         spec_i[c * l:(c + 1) * l]) for c in range(k1)]
    P = torch.stack([part[c][:, c] + part[1 - c][:, c] for c in range(k1)],
                    dim=1)                                    # [B, k1, L, M]
    return _inverse_into(P, acc, w, tw, pbs_fft.SPECTRAL_PLAN, pair=True)


def _jax_step(digits: np.ndarray, ggsw: np.ndarray, acc: np.ndarray):
    """The JAX reference's external product (ops/pbs.py's blind_rotate
    step): acc + sum_r d_r @ M(ggsw[r, c]), int32 wraparound."""
    M = jpbs._negacyclic_matrix(_j(ggsw))
    out = jnp.einsum("brn,rcnm->bcm", jnp.asarray(digits.astype(np.int32)),
                     M, preferred_element_type=jnp.int32)
    return np.asarray(_j(acc) + out)


def _spectral_case(P, ggsw: np.ndarray, digits: np.ndarray,
                   acc: np.ndarray, twin, jax_too: bool = True) -> float:
    """The twin ``twin`` (a limb plan of the one-block kernel, or "pair")
    against the port's exact step (and the JAX reference); returns the
    largest distance of a limb from its integer."""
    from fhe_regex_tpu_torch.ops import pbs_fft

    tp = _port_params(P) if hasattr(P, "name") else P
    plan = _twin_plan(twin)
    spec = pbs_fft.prepare_bsk_fft(tp, ggsw[None], plan=plan)[0]
    if twin == "pair":
        got, dist = _pair_step(torch.from_numpy(digits), spec, _t(acc))
    else:
        got, dist = _spectral_step(torch.from_numpy(digits), spec, _t(acc),
                                   plan)
    want = tpbs.external_product_step(tp, torch.from_numpy(digits),
                                      _t(ggsw), _t(acc))
    assert torch.equal(got, want)
    if jax_too:
        assert np.array_equal(got.numpy(), _jax_step(digits, ggsw, acc))
    return dist


def _digits(rng, B, rows, N, half=64):
    d = rng.integers(-half, half + 1, size=(B, rows, N)).astype(np.int8)
    d[0, 0, :2] = [-half, half]
    return d


@pytest.mark.parametrize("plan", TWINS)
@pytest.mark.parametrize("which", ["keys", "noisy_keys"])
def test_spectral_twin_equals_exact_step(request, which, plan):
    """At TEST_PARAMS / TEST_PARAMS_NOISY, on the first GGSW of the real
    bootstrap key, random digits and accumulators, on either limb plan and
    on the cluster pair: bit-equal to ``ops.pbs.external_product_step`` and
    to the JAX reference."""
    P = TEST_PARAMS if which == "keys" else TEST_PARAMS_NOISY
    sk = request.getfixturevalue(which)[1]
    N, k1 = P.polynomial_size, P.glwe_dimension + 1
    rows = k1 * P.pbs_level
    rng = np.random.default_rng(17)
    ggsw = np.asarray(sk.bsk)[0].astype(np.uint32)
    dist = _spectral_case(P, ggsw, _digits(rng, 5, rows, N),
                          _random_u32(rng, (5, k1, N)), plan)
    print(f"{P.name} {plan}: largest distance of a limb from its integer "
          f"{dist:.3g}")
    assert dist < 1 / 8


@pytest.mark.parametrize("plan", TWINS)
def test_spectral_twin_production_step(plan):
    """One step at the production set (N = 2048, l = 3, base 2^7) on
    either limb plan and on the cluster pair: random key words, digits and
    accumulators; bit-equal to both references."""
    from fhe_regex_tpu_torch.params import get_params

    P = get_params("TPU_MESSAGE_2_CARRY_2")
    N, k1 = P.polynomial_size, P.glwe_dimension + 1
    rows = k1 * P.pbs_level
    rng = np.random.default_rng(2048)
    dist = _spectral_case(P, _random_u32(rng, (rows, k1, N)),
                          _digits(rng, 2, rows, N),
                          _random_u32(rng, (2, k1, N)), plan)
    print(f"production step {plan}: largest distance of a limb from its "
          f"integer {dist:.3g}")
    assert dist < 1 / 8


#: each plan's word with every limb at its extreme, and those limbs; the
#: top limb is negative by a carry of +1 out of bit 32
WORST_WORDS = {
    (16, 16): ((-(1 << 15) - (1 << 15 << 16)) & 0xFFFFFFFF,
               [-(1 << 15), -(1 << 15)]),
    (16, 8, 8): ((-(1 << 15) - (1 << 7 << 16) - (1 << 7 << 24)) & 0xFFFFFFFF,
                 [-(1 << 15), -(1 << 7), -(1 << 7)]),
}


@pytest.mark.parametrize("plan", TWINS)
@pytest.mark.parametrize("sign", [-1, 1])
def test_spectral_twin_worst_case_margin(sign, plan):
    """The largest limb values the production set can give: every digit at
    -64 (or 64), every key word with each limb of the plan at its extreme
    ((16, 16), the one-block kernel's and the pair's: -2^15 and -2^15, the
    word 0x7FFF8000; (16, 8, 8): -2^15, -2^7, -2^7; the top limb's carry of
    +1 out of bit 32 checked), so that coefficient N-1 of every limb sums
    64 * 2^b * N * (k+1)l with one sign.  Exact still, and each limb's
    value lies within 1/8 of its integer (printed), the pair's, whose sums
    run in another order, within 1e-4."""
    from fhe_regex_tpu_torch.ops import pbs_fft
    from fhe_regex_tpu_torch.params import get_params

    P = get_params("TPU_MESSAGE_2_CARRY_2")
    N, k1 = P.polynomial_size, P.glwe_dimension + 1
    rows = k1 * P.pbs_level
    word, extremes = WORST_WORDS[_twin_plan(plan)]
    as_i32 = torch.from_numpy(np.array([word], np.uint32).view(np.int32))
    limbs = pbs_fft._limbs_signed(as_i32, _twin_plan(plan))
    assert limbs.ravel().tolist() == extremes
    weights = torch.tensor([1 << w for w in
                            pbs_fft.plan_weights(_twin_plan(plan))])
    carry = (as_i32.to(torch.int64) - (limbs[:, 0] * weights).sum()) >> 32
    assert carry.item() == 1
    ggsw = np.full((rows, k1, N), word, np.uint32)
    digits = np.full((2, rows, N), 64 * sign, np.int8)
    acc = _random_u32(np.random.default_rng(5), (2, k1, N))
    dist = _spectral_case(P, ggsw, digits, acc, plan, jax_too=False)
    print(f"worst case {plan}, digits {64 * sign}: largest distance of a "
          f"limb from its integer {dist:.3g}")
    assert dist < (1e-4 if plan == "pair" else 1 / 8)


@pytest.mark.parametrize("M", [128, 1024])
def test_stockham_transform_is_the_dft(M):
    """The kernel's transform (radices (16, 8) at M = 128, (16, 16, 4) at
    1024, twiddles as powers of one table entry, slots at swz(k), dft16
    read back through at16) is the DFT in natural order, forward and
    (unnormalised) inverse; swz is a permutation of every slot."""
    from fhe_regex_tpu_torch.ops import pbs_fft

    assert _radices(1024) == (16, 16, 4)
    slot = _swz(torch.arange(M))
    assert sorted(slot.tolist()) == list(range(M))
    rng = np.random.default_rng(M)
    x = torch.from_numpy(rng.standard_normal((3, M))
                         + 1j * rng.standard_normal((3, M)))
    w = pbs_fft.spectral_tables(2 * M)[1]
    buf = torch.empty_like(x)
    buf[..., slot] = x
    fwd = _stockham(buf, w)[..., slot]
    inv = _stockham(buf, w, inverse=True)[..., slot]
    assert float((fwd - torch.fft.fft(x)).abs().max()) < 1e-10
    assert float((inv - torch.fft.ifft(x) * M).abs().max()) < 1e-10


@pytest.mark.parametrize("M", [128, 1024])
def test_pair_transform_is_the_dft(M):
    """The cluster pair's transform (radices (8, 16) at M = 128, (8, 8,
    16) at 1024, backwards for the inverse, the radix-16 pass as its lane
    pair's 2 x 8, slots at pswz(k)) is the DFT in natural order, forward
    and (unnormalised) inverse; pswz is a permutation of every slot."""
    from fhe_regex_tpu_torch.ops import pbs_fft

    assert _pair_radices(1024) == (8, 8, 16)
    assert sorted(_pswz(torch.arange(M)).tolist()) == list(range(M))
    rng = np.random.default_rng(M + 1)
    x = torch.from_numpy(rng.standard_normal((3, M))
                         + 1j * rng.standard_normal((3, M)))
    w = pbs_fft.spectral_tables(2 * M)[1]
    slot = _pswz(torch.arange(M))
    buf = torch.empty_like(x)
    buf[..., slot] = x
    fwd = _stockham(buf, w, pair=True)[..., slot]
    inv = _stockham(buf, w, inverse=True, pair=True)[..., slot]
    assert float((fwd - torch.fft.fft(x)).abs().max()) < 1e-10
    assert float((inv - torch.fft.ifft(x) * M).abs().max()) < 1e-10


def _pair_accesses():
    """{access: [instruction][thread] point} of every shared-memory access
    of a step of ``pair::ext_product`` on a transform's slot, for the 128
    threads j of a group (the radix-16 passes' lane pair: butterfly jb =
    16 (j div 32) + j mod 16, half h = bit 4 of j) and the contraction's
    first 384 frequencies."""
    M, PT = 1024, 128
    j = np.arange(PT)
    jb, h = (j >> 5) * 16 + (j & 15), (j >> 4) & 1

    def p8_store(NS):
        return [(j // NS) * NS * 8 + j % NS + NS * q for q in range(8)]

    def p16_store(NS):
        return [(jb // NS) * NS * 16 + jb % NS
                + NS * ((i & 3) + 4 * h + 8 * (i >> 2)) for i in range(8)]

    p8_load = [j + PT * r for r in range(8)]
    return {"pass 1 store": p8_store(1), "radix-8 load": p8_load,
            "forward pass 2 store": p8_store(8),
            "radix-16 load": [jb + 64 * (h + 2 * u) for u in range(8)],
            "forward pass 3 store": p16_store(64),
            "inverse pass 1 store": p16_store(1),
            "inverse pass 2 store": p8_store(16),
            "contraction": [np.arange(3 * PT) % M]}


@pytest.mark.parametrize("access", list(_pair_accesses()))
def test_pair_slots_are_free_of_bank_conflicts(access):
    """Every 16-byte access of the pair's passes and contraction, read at
    pswz(k): each quarter-warp's 8 lanes hit 8 distinct 16-byte bank groups
    (slot mod 8), so no access is replayed."""
    for pts in _pair_accesses()[access]:
        slots = _pswz(torch.from_numpy(np.asarray(pts))).numpy()
        assert sorted(set(pts.tolist())) == sorted(pts.tolist())
        for q in range(0, len(slots), 8):
            assert len(set((slots[q:q + 8] % 8).tolist())) == 8, (access, q)


@pytest.mark.parametrize("plan", TWINS)
def test_spectral_twin_rotation_equals_blind_rotate(noisy_keys, plan):
    """A whole rotation of twin steps (``stage1_digits``, then the spectral
    step on the key's spectrum, on either limb plan or on the cluster
    pair) equals the plain ``blind_rotate``."""
    from fhe_regex_tpu_torch.ops import pbs_fft

    params, bsk, luts, idx, ms = _rotation_args(noisy_keys, 6, seed=3)
    spec = pbs_fft.prepare_bsk_fft(params, bsk, plan=_twin_plan(plan))
    acc = tpbs.init_accumulator(params, luts, idx, ms)
    for i in range(params.lwe_dimension):
        d = tpbs.stage1_digits(params, acc, ms[:, i])
        if plan == "pair":
            acc, dist = _pair_step(d, spec[i], acc)
        else:
            acc, dist = _spectral_step(d, spec[i], acc, plan)
        assert dist < 1 / 8
    assert torch.equal(acc, tpbs.blind_rotate(params, bsk, luts, idx, ms))


@pytest.mark.parametrize("plan", PLANS)
def test_device_spectrum_equals_host_spectrum(noisy_keys, plan):
    """``prepare_bsk_fft`` of the key as a tensor, where cuda-fused has it
    (on the card), in chunks of 5 steps, is its spectrum of the host
    array, bit for bit, on either limb plan."""
    from fhe_regex_tpu_torch.ops import pbs_fft

    tsk = server_key_from_jax(noisy_keys[1])
    got = pbs_fft.prepare_bsk_fft(tsk.params, _t(tsk.bsk), chunk=5,
                                  plan=plan)
    want = pbs_fft.prepare_bsk_fft(tsk.params, tsk.bsk, plan=plan)
    assert got.shape == want.shape == (16, 6, 2, len(plan), 128)
    assert torch.equal(got, want)


def test_spectral_key_follows_the_kernels_plan(monkeypatch, noisy_keys):
    """The spectral rotation's key is built on ``SPECTRAL_PLAN`` (16, 16),
    the limbs of ``csrc/blind_rotate.cu``'s ``spectral`` namespace (NL = 2,
    limb 1 at weight 2^LIMB_BITS = 2^16), and its limbs give the key back
    mod 2^32; the ``fft`` backend's key keeps ``PLAN`` (16, 8, 8).
    ``_rotate_spectral`` takes the two-limb shape only."""
    import re

    from fhe_regex_tpu_torch.ops import pbs_fft
    from fhe_regex_tpu_torch.params import get_params

    assert pbs_fft.PLAN == (16, 8, 8)
    assert pbs_fft.SPECTRAL_PLAN == (16, 16)
    assert pbs_fft.plan_weights(pbs_fft.SPECTRAL_PLAN) == (0, 16)
    src = (pbs_cuda.CSRC / "blind_rotate.cu").read_text()
    spectral = src[src.index("namespace spectral {"):]
    assert re.search(r"constexpr int NL = (\d+);", spectral)[1] == "2"
    assert re.search(r"constexpr int LIMB_BITS = (\d+);", spectral)[1] == "16"

    tsk = server_key_from_jax(noisy_keys[1])
    bsk = _t(tsk.bsk)
    limbs = pbs_fft._limbs_signed(bsk, pbs_fft.SPECTRAL_PLAN)
    assert int(limbs.abs().max()) <= 1 << 15
    assert torch.equal(tpbs.wrap_i32(limbs[0] + (limbs[1] << 16)), bsk)

    # prepare_server_key gives cuda-fused / cuda-bg the two-limb spectrum
    # and fft the three-limb key (the CUDA device check stood in for)
    monkeypatch.setattr(tpbs, "CUDA_BACKENDS", ())
    monkeypatch.setattr(pbs_cuda, "spectral_supported", lambda p: True)
    n, rows, k1, N = bsk.shape
    for backend, L in (("cuda-fused", 2), ("cuda-bg", 2)):
        dk = tpbs.prepare_server_key(tsk.params, tsk, "cpu", backend)
        assert dk.spec.shape == (n, rows, k1, L, N // 2)
        assert torch.equal(dk.spec, pbs_fft.prepare_bsk_fft(
            tsk.params, bsk, plan=pbs_fft.SPECTRAL_PLAN))
    dk = tpbs.prepare_server_key(tsk.params, tsk, "cpu", "fft")
    assert dk.spec is None and dk.bsk.shape == (n, rows, k1, 3, N // 2)
    monkeypatch.undo()

    # the kernel's wrapper refuses the three-limb shape before anything
    # else, and takes the two-limb one (then stops at its contiguity check:
    # a stand-in without 510 MB of memory)
    P = get_params("TPU_MESSAGE_2_CARRY_2")
    n, rows, k1, M = (P.lwe_dimension, 6, 2, P.polynomial_size // 2)
    ms = torch.zeros((8, n + 1), dtype=torch.int32)
    for L, match in ((3, "has shape"), (2, "must be contiguous")):
        spec = torch.zeros(1, dtype=torch.complex128).expand(n, rows, k1, L, M)
        with pytest.raises(ValueError, match=match):
            pbs_cuda._rotate_spectral(P, spec, None, None, ms)


def test_spectral_kernels_carry_rotation_names():
    """Every __global__ function of csrc/blind_rotate.cu, the spectral one
    in its namespace too, is counted by the benchmark's trace reader as a
    rotation kernel (``portbench.tracing.ROTATION_KERNELS``)."""
    import re

    from portbench.tracing import ROTATION_KERNELS

    src = (pbs_cuda.CSRC / "blind_rotate.cu").read_text()
    names = re.findall(r"__global__\s+void\s+(?:__launch_bounds__\([^)]*\)"
                       r"\s*)?(\w+)\s*\(", src)
    assert {"acc_init", "stage1", "ext_product"} <= set(names)
    assert names.count("ext_product") == 3    # limb GEMM, spectral, the pair
    for name in names:
        assert ROTATION_KERNELS.search(name), name
    for traced in ("void (anonymous namespace)::spectral::ext_product<2>("
                   "int const*, int const*, int const*, double2 const*, "
                   "double2 const*, int*, int, int, int)",
                   "(anonymous namespace)::spectral::ext_product<1>",
                   "void (anonymous namespace)::spectral::pair::ext_product("
                   "int const*, int const*, int const*, double2 const*, "
                   "double2 const*, int*, int, int, int)"):
        assert ROTATION_KERNELS.search(traced)


def test_fused_rotations_count_steps_by_path(monkeypatch, noisy_keys):
    """On the CUDA route (faked here) a rotation given the key's spectrum
    takes the spectral kernel, one without the limb GEMM;
    ``rotation_steps`` counts n x B steps on the path taken and
    ``rotation_launches`` one launch of the kernel taken, for
    ``blind_rotate_fused`` and ``blind_rotate_fused_bg`` alike."""
    args = _rotation_args(noisy_keys, 8, seed=4)
    params, B = args[0], 8
    calls = []
    monkeypatch.setattr(pbs_cuda, "_on_cuda", lambda what, t: True)
    monkeypatch.setattr(pbs_cuda, "_check32", lambda *a: None)
    monkeypatch.setattr(pbs_cuda, "_sm_count", lambda dev: 132)
    monkeypatch.setattr(pbs_cuda, "_rotate_spectral",
                        lambda *a: calls.append("spectral") or "s")
    monkeypatch.setattr(pbs_cuda, "_launch",
                        lambda entry, *a: calls.append(entry) or "l")
    spec = torch.zeros(1)
    steps = params.lwe_dimension * B
    for fn, limb in ((pbs_cuda.blind_rotate_fused, "fhe_blind_rotate"),
                     (pbs_cuda.blind_rotate_fused_bg, "fhe_blind_rotate_bg")):
        before = pbs_cuda.rotation_steps()
        launches = pbs_cuda.rotation_launches()
        assert fn(*args, spec=spec) == "s"
        assert fn(*args) == "l"
        after = pbs_cuda.rotation_steps()
        assert after == {"spectral": before["spectral"] + steps,
                         "spectral_pair": before["spectral_pair"] + steps,
                         "limb": before["limb"] + steps}
        launches[limb] += 1
        launches["fhe_blind_rotate_spectral"] += 1
        launches["spectral_pair"] += 1            # B = 8: on the pair
        assert pbs_cuda.rotation_launches() == launches
    assert calls == ["spectral", "fhe_blind_rotate", "spectral",
                     "fhe_blind_rotate_bg"]
    assert set(pbs_cuda.rotation_launches()).isdisjoint(
        pbs_cuda.launch_counts())


@pytest.mark.parametrize("sms, pair, one", [
    (132, (1, 8, 16, 32, 64, 66), (67, 132, 133, 256, 1024)),   # H100 SXM
    (114, (1, 8, 56, 57), (58, 64, 66, 114))])                  # H100 PCIe
def test_spectral_cluster_rule(sms, pair, one):
    """``spectral_cluster`` gives a batch the cluster pair (2 blocks an
    instance) while its pairs fit one wave of the card's SMs, 2 B <= SMs,
    and one block an instance above."""
    assert [pbs_cuda.spectral_cluster(B, sms) for B in pair] == [2] * len(pair)
    assert [pbs_cuda.spectral_cluster(B, sms) for B in one] == [1] * len(one)


def test_pair_rotations_count_under_their_own_keys(monkeypatch, noisy_keys):
    """On the CUDA route (faked here, 132 SMs) a spectral rotation of B =
    66 rows is launched on the cluster pair and one of 67 on one block an
    instance, both by ``blind_rotate_fused`` and ``blind_rotate_fused_bg``;
    ``rotation_steps`` counts the pair's n x B steps under
    ``spectral_pair`` as well as ``spectral``, and ``rotation_launches``
    its launch under ``spectral_pair`` as well as the entry's."""
    seen = []
    monkeypatch.setattr(pbs_cuda, "_on_cuda", lambda what, t: True)
    monkeypatch.setattr(pbs_cuda, "_check32", lambda *a: None)
    monkeypatch.setattr(pbs_cuda, "_sm_count", lambda dev: 132)
    monkeypatch.setattr(pbs_cuda, "_rotate_spectral",
                        lambda *a: seen.append(a[-1]) or "s")
    spec = torch.zeros(1)
    params, bsk, luts, _, _ = _rotation_args(noisy_keys, 1, seed=6)
    for fn in (pbs_cuda.blind_rotate_fused, pbs_cuda.blind_rotate_fused_bg):
        for B, cluster in ((66, 2), (67, 1)):
            args = (params, bsk, luts, torch.zeros(B, dtype=torch.int32),
                    torch.zeros((B, params.lwe_dimension + 1),
                                dtype=torch.int32))
            steps = params.lwe_dimension * B
            before = pbs_cuda.rotation_steps()
            launches = pbs_cuda.rotation_launches()
            assert fn(*args, spec=spec) == "s"
            assert seen[-1] == cluster
            pair = steps if cluster == 2 else 0
            assert pbs_cuda.rotation_steps() == {
                "spectral": before["spectral"] + steps,
                "spectral_pair": before["spectral_pair"] + pair,
                "limb": before["limb"]}
            launches["fhe_blind_rotate_spectral"] += 1
            launches["spectral_pair"] += cluster == 2
            assert pbs_cuda.rotation_launches() == launches


def test_spectral_bg_takes_no_batch_block(monkeypatch, noisy_keys):
    """With the key's spectrum ``blind_rotate_fused_bg`` rotates the whole
    batch of any B, one with no 8-aligned block too, and refuses an
    explicit ``tb``; without it the block rules stand."""
    monkeypatch.setattr(pbs_cuda, "_on_cuda", lambda what, t: True)
    monkeypatch.setattr(pbs_cuda, "_check32", lambda *a: None)
    monkeypatch.setattr(pbs_cuda, "_sm_count", lambda dev: 132)
    monkeypatch.setattr(pbs_cuda, "_rotate_spectral", lambda *a: "s")
    args = _rotation_args(noisy_keys, 4, seed=5)
    spec = torch.zeros(1)
    assert pbs_cuda.blind_rotate_fused_bg(*args, spec=spec) == "s"
    with pytest.raises(ValueError, match="takes the whole batch"):
        pbs_cuda.blind_rotate_fused_bg(*args, tb=8, spec=spec)
    with pytest.raises(ValueError, match="8-aligned blocks"):
        pbs_cuda.blind_rotate_fused_bg(*args)


def test_rotation_fn_hands_the_spectrum_on(monkeypatch, noisy_keys):
    """``rotation_fn`` gives ``cuda-fused`` and ``cuda-bg`` the key's
    ``spec``; only the production set's shapes have one."""
    from fhe_regex_tpu_torch.params import get_params

    tsk = server_key_from_jax(noisy_keys[1])
    seen = {}
    for backend, name in (("cuda-fused", "blind_rotate_fused"),
                          ("cuda-bg", "blind_rotate_fused_bg")):
        monkeypatch.setattr(pbs_cuda, name,
                            lambda *a, **kw: seen.update({backend: kw}))
        spec = torch.zeros(1)
        dk = tpbs.DeviceServerKey(tsk.params, backend, torch.device("cpu"),
                                  None, None, spec=spec)
        tpbs.rotation_fn(dk)(None, None, None)
        assert seen[backend]["spec"] is spec
    assert pbs_cuda.spectral_supported(get_params("TPU_MESSAGE_2_CARRY_2"))
    for name in ("TEST_PARAMS", "TEST_PARAMS_NOISY", "TPU64_MESSAGE_2_CARRY_2"):
        assert not pbs_cuda.spectral_supported(get_params(name))
