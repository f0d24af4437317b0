"""The layout of the 64-bit tensor-core blind rotation (``csrc/
blind_rotate64.cu``, kernels #5 and #6) against the port's plain version and
the JAX package, bit for bit.

* ``stage1_64`` writes each balanced digit as ``n_digit_limbs`` int8 limbs
  in planes (c*l + j)*nd + dl: replayed here and held against the JAX
  package's ``decompose64`` and ``digit_limbs_i8``.
* ``ext_product64`` is a limb GEMM: 8 balanced int8 limbs of each key word
  of [g, -g] (split by adding 0x80 to every byte), read from byte-shifted
  reversed windows at the m16n8k32 fragment addresses, int8 products summed
  in int32 per weight class cw = dl + j <= 7, the key limbs below the drop
  of a component skipped, the classes combined mod 2^64.  An int64 twin
  replays it and equals ``ops/pbs64.py::_ext_product64``, which equals the
  JAX ``external_product64`` at the production digit shape.
* The drop reaches ``cuda64-bg`` from the key: ``rotation_fn`` and
  ``mv._rotate_acc`` hand the wrapper ``DeviceServerKey.drop64``.
* The redesigned ``stage1_64`` (segments of the uint64 row staged in
  padded shared memory by 16-byte groups, 16 coefficients a thread, each
  limb plane written with 16-byte stores) is replayed by an int64 twin
  that equals the plain ``pbs64.stage1_digits64`` at edge rotations,
  N = 256 and 2048; that plain pass equals JAX ``decompose64`` +
  ``digit_limbs_i8``; its wrapper ``pbs_cuda.stage1_digits64`` is the
  plain pass on the CPU, counts no launch there and refuses other devices.

Sets: TEST_PARAMS_64 (one int8 limb per digit, 6 digit rows) and the same
set with the production digit, base 2^23 at one level (three limbs, two
rows), both at N = 256.  Inputs come from numpy seeds; tolerance is zero
(integer arithmetic mod 2^64).  The CUDA kernels themselves are held
against the plain rotation on the card by ``chip_smoke.py``.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fhe_regex_tpu.ops import pbs64 as j64
from fhe_regex_tpu.params import TEST_PARAMS_64 as J_TEST_PARAMS_64

import fhe_regex_tpu_torch as port
from fhe_regex_tpu_torch.crypto import lwe
from fhe_regex_tpu_torch.crypto.golden import make_lut_poly
from fhe_regex_tpu_torch.ops import mv
from fhe_regex_tpu_torch.ops import pbs as tpbs
from fhe_regex_tpu_torch.ops import pbs64 as t64
from fhe_regex_tpu_torch.ops import pbs_cuda

torch.set_num_threads(2)

P64 = port.get_params("TEST_PARAMS_64")
P64_B23 = dataclasses.replace(P64, name="TEST_PARAMS_64_B23",
                              pbs_base_log=23, pbs_level=1)
J_B23 = dataclasses.replace(J_TEST_PARAMS_64, name="TEST_PARAMS_64_B23",
                            pbs_base_log=23, pbs_level=1)
SETS = {"nd1": P64, "nd3": P64_B23}
EXT_TN = 64                         # coefficients per ext_product64 block
BIAS = 0x8080808080808080

# key words: 0, 2^63, 2^64 - 1, all limbs -128 (and its negation), 1
ALL_M128 = 0x7F7F7F7F7F7F7F80
EDGE_WORDS = np.array([0, 1 << 63, (1 << 64) - 1, ALL_M128,
                       (1 << 64) - ALL_M128, 1, (1 << 63) - 1, 0x80],
                      np.uint64)


def _i64(a: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(a, np.uint64).view(np.int64))


def _limbs8(w: torch.Tensor) -> torch.Tensor:
    """int64 (uint64 bits) -> [8, ...] balanced int8 limbs, peeled as the
    JAX package's ``_limbs_i8_64``: w = sum_l 2^(8l) limb_l mod 2^64."""
    out, v = [], w
    for _ in range(8):
        d = ((v + 128) & 255) - 128
        out.append(d)
        v = (v - d) >> 8
    return torch.stack(out)


def _digit_planes(digits: torch.Tensor, nd: int) -> torch.Tensor:
    """[B, rows, N] digits -> [B, rows*nd, N] int8 planes, row r limb dl at
    r*nd + dl (the port's ``digit_limb_planes``); the nd limbs must hold
    each digit."""
    B, rows, N = digits.shape
    planes = t64.digit_limb_planes(digits, nd)
    limbs = planes.view(B, rows, nd, N).to(torch.int64)
    back = sum(limbs[:, :, dl] << (8 * dl) for dl in range(nd))
    assert torch.equal(back, digits.to(torch.int64))
    return planes


def _ext_product64_twin(planes, ggsw, nd, drop):
    """The arithmetic of ``ext_product64`` in int64 on the CPU: planes
    [B, rows*nd, N] int8, ggsw [rows, k1, N] int64 -> [B, k1, N] int64,
    sum_r digit_r (*) ggsw[r, c] mod 2^64.

    Column m of block M0 = m - m % 64 and row t come from lane groupID
    g = m % 8, thread-in-group (t % 16) // 4 and half t % 32 // 16 of a
    32-deep k-step; the B-fragment word is read from byte-shifted copy
    s = (3 - g) & 3 at byte (yb - s) + 16 * half + t % 4, copy s byte i
    holding rev[i + s], rev[y] = dbl[(M0 + 63 - y) mod 2N].  One block is
    one digit row: its class sums must stay below 2^31."""
    B, _, N = planes.shape
    rows, k1, _ = ggsw.shape
    dbl = torch.cat([ggsw, -ggsw], -1)                         # [rows, k1, 2N]
    m, t = torch.arange(N), torch.arange(N)
    M0 = m - m % EXT_TN
    g = (m - M0) % 8
    s = (3 - g) & 3
    half, tig, j4 = (t % 32) // 16, (t % 16) // 4, t % 4
    yb = (t - t % 32 + tig * 4)[:, None] + EXT_TN - 1 - (m - M0)[None, :]
    assert ((yb - s) % 4 == 0).all()                   # aligned word loads
    byte = (yb - s) + 16 * half[:, None] + j4[:, None]
    assert (byte >= 0).all() and (byte < N + EXT_TN).all()  # inside a copy
    z = (M0[None, :] + EXT_TN - 1 - (byte + s)) % (2 * N)
    L = _limbs8(dbl[:, :, z])                          # [8, rows, k1, t, m]
    assert L.min() >= -128 and L.max() <= 127
    d = planes.to(torch.int64).view(B, rows, nd, N)
    out = torch.zeros((B, k1, N), dtype=torch.int64)
    for r in range(rows):
        for c in range(k1):
            jlo = drop[0] if c < k1 - 1 else drop[1]
            for cw in range(8):
                pairs = [(dl, cw - dl) for dl in range(nd)
                         if jlo <= cw - dl < 8]
                if not pairs:
                    continue
                p = sum(d[:, r, dl] @ L[j, r, c] for dl, j in pairs)
                assert p.abs().max() < 2 ** 31           # exact in int32
                out[:, c] += p * (1 << (8 * cw))          # wraps mod 2^64
    return out


def _digits(rng, params, B):
    """Balanced digits [B, rows, N] of the set, both ends planted."""
    rows = (params.glwe_dimension + 1) * params.pbs_level
    half = 1 << (params.pbs_base_log - 1)
    d = rng.integers(-half, half, size=(B, rows, params.polynomial_size))
    d[0, 0, :4] = [-half, half - 1, -half, half - 1]
    d[-1, -1, -2:] = [half - 1, -half]
    return torch.from_numpy(d.astype(np.int32))


def _ggsw(rng, params, drop):
    """One step's GGSW [rows, k1, N]: random words with the edge words
    planted, rounded by the drop, then words whose limbs above the drop
    are all -128."""
    k1, N = params.glwe_dimension + 1, params.polynomial_size
    rows = k1 * params.pbs_level
    g = rng.integers(0, 1 << 64, size=(1, rows, k1, N), dtype=np.uint64)
    g[0, 0, 0, :len(EDGE_WORDS)] = EDGE_WORDS
    g[0, -1, -1, -len(EDGE_WORDS):] = EDGE_WORDS
    g = t64.round_bsk64(params, g, drop)[0]
    for c, mlo in enumerate((drop[0],) * (k1 - 1) + (drop[1],)):
        g[0, c, 8 + c] = np.uint64(sum(-128 << (8 * l)
                                       for l in range(mlo, 8)) % (1 << 64))
    return _i64(g)


def test_limbs8_bias_split_matches_jax():
    """The kernel's (w + 0x80..80) ^ 0x80..80 gives, byte for byte, the
    JAX package's peeled balanced limbs, and they recombine to w."""
    rng = np.random.default_rng(0)
    words = np.concatenate([EDGE_WORDS, rng.integers(0, 1 << 64, size=500,
                                                     dtype=np.uint64)])
    want = j64._limbs_i8_64(words)                       # [W, 8] int8
    with np.errstate(over="ignore"):
        biased = (words + np.uint64(BIAS)) ^ np.uint64(BIAS)
    assert np.array_equal(biased.view(np.uint8).reshape(-1, 8).view(np.int8),
                          want)
    got = _limbs8(_i64(words))
    assert np.array_equal(got.numpy().T, want.astype(np.int64))
    assert (got[:, 3] == -128).all()                   # ALL_M128
    back = sum(got[l] * (1 << (8 * l)) for l in range(8))
    assert torch.equal(back, _i64(words))


@pytest.mark.parametrize("name", list(SETS))
def test_stage1_digit_planes_match_jax(name):
    """stage1_64's planes: the digits of X^a * acc - acc (decompose64),
    each split into nd int8 limbs as JAX ``digit_limbs_i8`` splits it, the
    top limb of a base-2^23 digit in [-64, 64]."""
    params = SETS[name]
    jp = J_B23 if name == "nd3" else J_TEST_PARAMS_64
    k1, N, l = params.glwe_dimension + 1, params.polynomial_size, params.pbs_level
    bl, nd = params.pbs_base_log, t64.n_digit_limbs(params.pbs_base_log)
    assert nd == j64.n_digit_limbs(bl) == (3 if name == "nd3" else 1)
    rng = np.random.default_rng(1)
    B = 6
    acc = rng.integers(0, 1 << 64, size=(B, k1, N), dtype=np.uint64)
    a = np.array([0, 1, N - 1, N, 2 * N - 1, 77], np.int32)
    acc_t = _i64(acc)
    diff = t64.negacyclic_rotate_batch64(acc_t, torch.from_numpy(a)) - acc_t
    # at base 2^23, one level: the digits -2^22 and 2^22 - 1
    diff[0, 0, :2] = _i64(np.array([1 << 63, (1 << 63) - (1 << 41)],
                                   np.uint64))
    digits = t64.decompose64(diff, bl, l).permute(1, 2, 0, 3).reshape(
        B, k1 * l, N)
    planes = _digit_planes(digits, nd)
    lo, hi = t64.split64_np(diff.numpy().view(np.uint64))
    jd = j64.decompose64(jnp.asarray(lo), jnp.asarray(hi), bl, l)
    jd = jnp.transpose(jd, (1, 2, 0, 3)).reshape(B, k1 * l, N)
    want = np.stack([np.asarray(x) for x in j64.digit_limbs_i8(jd, nd)], 2)
    assert np.array_equal(planes.numpy(), want.reshape(B, k1 * l * nd, N))
    top = planes.view(B, k1 * l, nd, N)[:, :, -1]
    if nd == 3:
        assert digits[0, 0, :2].tolist() == [-(1 << 22), (1 << 22) - 1]
        assert int(top.min()) >= -64 and int(top.max()) <= 64


@pytest.mark.parametrize("d", [-(1 << 22), (1 << 22) - 1, -1, 0, 255, -129])
def test_digit_planes_edges(d):
    """Digits at both ends of [-2^22, 2^22): three limbs, top in [-64, 64]."""
    planes = _digit_planes(torch.tensor([[[d]]], dtype=torch.int32), 3)
    limbs = [int(x) for x in planes.reshape(3)]
    assert sum(x << (8 * i) for i, x in enumerate(limbs)) == d
    assert -64 <= limbs[2] <= 64
    want = [int(x[0]) for x in j64.digit_limbs_i8(jnp.array([d]), 3)]
    assert limbs == want


@pytest.mark.parametrize("drop", [(0, 0), (1, 2), (2, 2)])
@pytest.mark.parametrize("name,B", [("nd1", 8), ("nd3", 8), ("nd3", 37)])
def test_ext_product64_limb_layout_matches_plain(name, B, drop):
    """The twin on a key rounded by the drop equals ``_ext_product64``;
    on the unrounded key a nonzero drop changes the bits (the skip is
    real)."""
    params = SETS[name]
    nd = t64.n_digit_limbs(params.pbs_base_log)
    rng = np.random.default_rng(100 * B + 10 * drop[0] + drop[1])
    digits = _digits(rng, params, B)
    ggsw = _ggsw(rng, params, drop)
    planes = _digit_planes(digits, nd)
    want = t64._ext_product64(digits.to(torch.float64), ggsw)
    assert torch.equal(_ext_product64_twin(planes, ggsw, nd, drop), want)
    if drop != (0, 0):
        raw = _ggsw(np.random.default_rng(7), params, (0, 0))
        assert not torch.equal(
            _ext_product64_twin(planes, raw, nd, drop),
            t64._ext_product64(digits.to(torch.float64), raw))


def test_plain_ext_product64_matches_jax_at_base_2_23():
    """The plain external product at the production digit shape (three
    limbs, two rows) equals the JAX ``external_product64`` on the same
    accumulator difference and key."""
    params, jp = P64_B23, J_B23
    k1, N = params.glwe_dimension + 1, params.polynomial_size
    rng = np.random.default_rng(3)
    B = 5
    bsk = rng.integers(0, 1 << 64, size=(1, 2, k1, N), dtype=np.uint64)
    bsk[0, 0, 0, :len(EDGE_WORDS)] = EDGE_WORDS
    acc = rng.integers(0, 1 << 64, size=(B, k1, N), dtype=np.uint64)
    diff = rng.integers(0, 1 << 64, size=(B, k1, N), dtype=np.uint64)
    quad = jnp.asarray(j64.prepare_bsk64(jp, bsk)[0])
    want = j64.external_product64(
        jp, *map(jnp.asarray, t64.split64_np(diff)), quad,
        *map(jnp.asarray, t64.split64_np(acc)))
    want = t64.join64_np(np.asarray(want[0]), np.asarray(want[1]))
    d = t64.decompose64(_i64(diff), 23, 1).permute(1, 2, 0, 3).reshape(
        B, k1, N)
    got = _i64(acc) + t64._ext_product64(d.to(torch.float64), _i64(bsk[0]))
    assert np.array_equal(got.numpy().view(np.uint64), want)


@pytest.mark.parametrize("base_log,level,N,drop,ok", [
    (23, 1, 2048, (1, 2), True),
    (7, 3, 256, (0, 0), True),
    (8, 3, 256, (0, 0), True),
    (16, 1, 2048, (0, 0), False),     # the top limb would reach 128
    (24, 1, 2048, (0, 0), False),
    (31, 1, 2048, (0, 0), False),     # four limbs: no template
    (10, 4, 2048, (0, 0), False),     # base_log * level > 31
    (23, 1, 8192, (0, 0), False),     # windows past shared memory
    (23, 1, 128, (0, 0), False),
    (23, 1, 2048, (8, 0), False),
])
def test_check64_refuses_what_the_templates_do_not_cover(base_log, level, N,
                                                         drop, ok):
    params = dataclasses.replace(P64, pbs_base_log=base_log, pbs_level=level,
                                 polynomial_size=N, lwe_dimension=2)
    k1 = params.glwe_dimension + 1
    B = 8
    args = (torch.zeros((2, k1 * level, k1, N), dtype=torch.int64),
            torch.zeros((1, N), dtype=torch.int64),
            torch.zeros(B, dtype=torch.int32),
            torch.zeros((B, 3), dtype=torch.int32))
    if ok:
        pbs_cuda._check64(params, *args, drop=drop)
    else:
        with pytest.raises(ValueError):
            pbs_cuda._check64(params, *args, drop=drop)


def test_rotation_fn_and_mv_hand_cuda64_bg_the_key_drop(monkeypatch):
    """``make_pbs_core`` (through ``rotation_fn``) and ``mv._rotate_acc``
    call the ``cuda64-bg`` wrapper with the key's ``drop64``; on the CPU
    the wrapper is the plain rotation on the rounded key, so both equal
    ``torch64`` on that key."""
    ck, sk = port.gen_keys(P64, seed=3)
    drop = (1, 2)
    bsk = t64.to_torch64(t64.round_bsk64(P64, sk.bsk, drop))
    ksk = t64.prepare_ksk64(t64.to_torch64(sk.ksk))
    cpu = torch.device("cpu")
    bg = tpbs.DeviceServerKey(P64, "cuda64-bg", cpu, bsk, ksk, drop)
    plain = tpbs.DeviceServerKey(P64, "torch64", cpu, bsk, ksk)
    seen = []
    real = pbs_cuda.blind_rotate_fused64_bg

    def spy(*args, drop=(0, 0), **kw):
        seen.append(drop)
        return real(*args, drop=drop, **kw)

    monkeypatch.setattr(pbs_cuda, "blind_rotate_fused64_bg", spy)
    rng = np.random.default_rng(4)
    msgs = rng.integers(0, 8, size=8)
    cts = t64.to_torch64(np.stack([lwe.encrypt_lwe(P64, ck.lwe_key, int(m),
                                                   ck.rng) for m in msgs]))
    luts = t64.to_torch64(np.stack([make_lut_poly(P64, lambda x: x)]))
    idx = torch.zeros(8, dtype=torch.int32)
    got = tpbs.make_pbs_core(bg)(luts, idx, cts)
    assert torch.equal(got, tpbs.make_pbs_core(plain)(luts, idx, cts))
    vlut = mv.mv_lut_table(P64)
    accs = mv._rotate_acc(bg, vlut, cts)
    assert torch.equal(accs, mv._rotate_acc(plain, vlut, cts))
    assert seen == [drop, drop]


# ---- the index arithmetic of csrc/blind_rotate64.cu's stage1_64 ----
SEG_MIN, SEG_MAX, PER_THREAD, WAVE = 128, 1024, 16, 132
M64 = (1 << 64) - 1


def _segment(B, k1, N):
    """``stage1_segment`` of csrc/hopper.cuh."""
    S = min(N, SEG_MAX)
    while S > SEG_MIN and B * k1 * (N // S) < WAVE:
        S //= 2
    return S


def _spad(w):
    return w + (w >> 4)


def _stage1_64_twin(acc, a, level, base_log, nd, S):
    """``stage1_64``'s arithmetic on the CPU in Python ints (uint64 words),
    block by block: acc [B, k1, N] uint64, a [B] -> [B, k1*level*nd, N]
    int8.  As the 32-bit twin (tests/test_torch_kernels32.py), with 2-word
    16-byte groups (source run from u0 - (u0 & 1), S + 2 words), reads
    through 64-bit banks (16 threads, 32 banks), and limb plane
    (c*l + j)*nd + dl written by one 16-byte store per thread."""
    B, k1, N = acc.shape
    T, G = S // PER_THREAD, 2
    assert S // G == T * (PER_THREAD // G)   # thread t: groups t + kT
    R = _spad(S - 1) + 1
    words = R + _spad(S + G - 1) + 1
    out = np.zeros(B * k1 * level * nd * N, np.int64)
    written = np.zeros(out.shape, np.int64)
    shift = 64 - base_log * level
    mask, half = (1 << base_log) - 1, 1 << (base_log - 1)
    i_all = np.arange(S)
    for b in range(B):
        for sg in range(N // S):
            m0 = sg * S
            s0 = (m0 - int(a[b])) & (2 * N - 1)
            u0 = s0 & (N - 1)
            off = u0 & 1
            src_pos = R + _spad(off + i_all)
            for t0 in range(0, T, 16):                    # a half-warp
                for qq in range(PER_THREAD):
                    for pos in (src_pos, _spad(i_all)):
                        w = pos[(np.arange(t0, min(t0 + 16, T)) * PER_THREAD
                                 + qq)]
                        banks = np.concatenate([2 * w % 32, (2 * w + 1) % 32])
                        assert len(set(banks)) == banks.size
            for c in range(k1):
                p = [int(x) for x in acc[b, c]]
                sm = [None] * words
                for start, n, base_w in ((m0, S, 0), (u0 - off, S + G, R)):
                    for g in range(n // G):
                        first = (start + g * G) & (N - 1)
                        assert first % G == 0 and first + G <= N
                        for e in range(G):
                            pos = base_w + _spad(g * G + e)
                            assert sm[pos] is None
                            sm[pos] = p[first + e]
                row = (b * k1 + c) * level
                for t in range(T):
                    st = []
                    for q in range(PER_THREAD):
                        i = t * PER_THREAD + q
                        v, own = sm[R + _spad(off + i)], sm[_spad(i)]
                        rot = (-v) & M64 if (s0 + i) & N else v
                        st.append(((rot - own + (1 << (shift - 1))) & M64)
                                  >> shift)
                    for j in range(level - 1, -1, -1):
                        sd = []
                        for q in range(PER_THREAD):
                            d = st[q] & mask
                            sd.append(d - mask - 1 if d >= half else d)
                            st[q] = ((st[q] - sd[q]) & M64) >> base_log
                        for dl in range(nd):
                            store = ((row + j) * nd + dl) * N + m0 + 16 * t
                            assert store % 16 == 0
                            for q in range(PER_THREAD):
                                limb = ((sd[q] + 128) & 255) - 128
                                out[store + q] = limb
                                written[store + q] += 1
                                sd[q] = (sd[q] - limb) >> 8
    assert (written == 1).all()
    return torch.from_numpy(out.reshape(B, k1 * level * nd, N)
                            .astype(np.int8))


def _edge_acc64(rng, B, k1, N):
    acc = rng.integers(0, 1 << 64, size=(B, k1, N), dtype=np.uint64)
    words = np.array([0, 1, (1 << 63) - 1, 1 << 63, (1 << 63) + 1,
                      (1 << 64) - 1], np.uint64)
    acc[:, 0, :6] = words
    acc[:, -1, -6:] = words
    acc[::2, :, N // 2 - 3:N // 2 + 3] = words
    return acc


def _edge_rotations(N, rng, extra):
    edges = [0, 1, 15, 16, 17, N - 16, N - 1, N, N + 1, 2 * N - 16, 2 * N - 1]
    return np.array(edges + list(rng.integers(0, 2 * N, size=extra)),
                    np.int32)


@pytest.mark.parametrize("name,N,S", [("nd1", 256, 128), ("nd3", 256, 256),
                                      ("nd3", 2048, 1024), ("nd1", 2048, 128)])
def test_stage1_64_twin_matches_plain(name, N, S):
    """The replay of the redesigned ``stage1_64`` equals the plain
    ``stage1_digits64`` at the edge rotations and random ones."""
    params = dataclasses.replace(SETS[name], polynomial_size=N)
    k1, l = params.glwe_dimension + 1, params.pbs_level
    nd = t64.n_digit_limbs(params.pbs_base_log)
    rng = np.random.default_rng(N + S)
    a = _edge_rotations(N, rng, 1 if N > 256 else 3)
    acc = _edge_acc64(rng, a.size, k1, N)
    want = t64.stage1_digits64(params, _i64(acc), torch.from_numpy(a))
    assert want.shape == (a.size, k1 * l * nd, N)
    got = _stage1_64_twin(acc, a, l, params.pbs_base_log, nd, S)
    assert torch.equal(got, want)


@pytest.mark.parametrize("name", list(SETS))
def test_plain_stage1_digits64_matches_jax(name):
    """``pbs64.stage1_digits64`` equals JAX ``decompose64`` of X^a * acc -
    acc, split by ``digit_limbs_i8``, at TEST_PARAMS_64 and base 2^23."""
    params = SETS[name]
    k1, N, l = params.glwe_dimension + 1, params.polynomial_size, params.pbs_level
    bl, nd = params.pbs_base_log, t64.n_digit_limbs(params.pbs_base_log)
    rng = np.random.default_rng(11)
    a = _edge_rotations(N, rng, 2)
    B = a.size
    acc = _edge_acc64(rng, B, k1, N)
    got = t64.stage1_digits64(params, _i64(acc), torch.from_numpy(a))
    acc_t = _i64(acc)
    diff = t64.negacyclic_rotate_batch64(acc_t, torch.from_numpy(a)) - acc_t
    lo, hi = t64.split64_np(diff.numpy().view(np.uint64))
    jd = j64.decompose64(jnp.asarray(lo), jnp.asarray(hi), bl, l)
    jd = jnp.transpose(jd, (1, 2, 0, 3)).reshape(B, k1 * l, N)
    want = np.stack([np.asarray(x) for x in j64.digit_limbs_i8(jd, nd)], 2)
    assert np.array_equal(got.numpy(), want.reshape(B, k1 * l * nd, N))


def test_stage1_digits64_wrapper_plain_on_cpu():
    """On CPU tensors the wrapper is the plain pass and counts no launch;
    another device raises."""
    params = SETS["nd3"]
    k1, N = params.glwe_dimension + 1, params.polynomial_size
    rng = np.random.default_rng(5)
    a = torch.from_numpy(_edge_rotations(N, rng, 0))
    acc = _i64(_edge_acc64(rng, a.numel(), k1, N))
    before = pbs_cuda.stage1_digits64.launches
    got = pbs_cuda.stage1_digits64(params, acc, a)
    assert torch.equal(got, t64.stage1_digits64(params, acc, a))
    assert pbs_cuda.stage1_digits64.launches == before
    meta = torch.empty((2, k1, N), dtype=torch.int64, device="meta")
    with pytest.raises(ValueError, match="no stage1_64 kernel"):
        pbs_cuda.stage1_digits64(params, meta, meta)
