#!/usr/bin/env python3
"""On-card smoke run of the PyTorch port (``fhe_regex_tpu_torch``).

    python3 chip_smoke.py

Needs one CUDA device, ``nvcc`` and ``nvidia-smi``; builds the kernels from
``fhe_regex_tpu_torch/csrc`` and imports nothing of JAX.  Phases:

1. device: a CUDA device must be present (else exit non-zero, no result);
2. 32-bit kernel vs plain: the CUDA blind rotation against the plain
   PyTorch version on the card, bit for bit (tolerance zero: both are exact
   integer arithmetic mod 2^32), at TEST_PARAMS_NOISY (B = 8, 37) and at
   TPU_MESSAGE_2_CARRY_2 (B = 8, 256), with both times;
3. 32-bit main path: keys for TPU_MESSAGE_2_CARRY_2 (cached in ``.cache/``),
   then six requests with real ``encrypt_str`` -> ``has_match(fold="tree",
   device="cuda")`` -> ``decrypt``, each against its expected bit, with the
   kernel's launch count; one request is also checked bit for bit against
   the plain backend, and one small request against the CPU;
4. 32-bit throughput: one decrypt-checked PBS batch at B = 256;
5. 64-bit kernels vs plain, tolerance zero (mod 2^64): ``cuda64`` against
   ``blind_rotate64`` at TEST_PARAMS_64 (B = 8, 37) and
   TPU64_MESSAGE_2_CARRY_2 (B = 8, 256); ``cuda64-bg`` against the plain
   rotation on its rounded key at TPU64_MESSAGE_2_CARRY_2 (B = 8, 256), and
   at B = 256 in one block and in two (tb = 256, 128);
6. 64-bit main path: the six requests at TPU64_MESSAGE_2_CARRY_2 on the
   default backend (``cuda64-bg``), then one request on ``cuda64``, checked
   bit for bit against ``torch64`` on the card, and one small request
   against the CPU;
7. 64-bit throughput: one decrypt-checked PBS batch at B = 256 on
   ``cuda64-bg``.

Before each main path every launch count is set to 0; just after, the
path's kernel must show launches.  Any failure raises.  The line before
the last is a JSON object describing each kernel; the last line is
``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
CACHE = ROOT / ".cache"
KEY_SEED = 0xBE7C4
DEVICE = "cuda"
FULL = "TPU_MESSAGE_2_CARRY_2"
SMALL = "TEST_PARAMS_NOISY"
FULL64 = "TPU64_MESSAGE_2_CARRY_2"
SMALL64 = "TEST_PARAMS_64"

# the five benchmark configurations of fhe_regex_tpu/models/patterns.py
# (contents and expected bits from benchmarks/e2e.py) plus the north star
REQUESTS = [
    ("exact_literal", "/^abc$/", "abc", 1),
    ("contains_anchors", "/abc/", "xxxxxabcxxxxxxxx", 1),
    ("case_insensitive_classes", "/^[a-d][^xyz]$/i", "bq", 1),
    ("quantifiers", "/^ab{2,4}c+d*$/", "xabbcccddddd" + "x" * 20, 0),
    ("alternation_combo", "/^(ab|cd)[a-z]{3,}e?$/i",
     "cdqrstuv" + "x" * 55 + "e", 1),
    ("north_star_hit", "/^a[b-d]{2,4}e$/i", "Acdde", 1),
]


def _timed(fn):
    """(result, seconds) of fn() on the card, synchronised on both ends."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def _keys(params):
    """Client/server keys, generated once and cached like bench.py does."""
    from fhe_regex_tpu_torch.crypto.csprng import Csprng
    from fhe_regex_tpu_torch.crypto.keys import ClientKey, ServerKey, gen_keys

    CACHE.mkdir(exist_ok=True)
    path = CACHE / f"torch_smoke_keys_{params.name}.npz"
    if path.exists():
        with np.load(path) as z:
            ck = ClientKey(params=params, lwe_key=z["lwe_key"],
                           glwe_key=z["glwe_key"], rng=Csprng(KEY_SEED + 1))
            sk = ServerKey(params=params, bsk=z["bsk"], ksk=z["ksk"])
        return ck, sk, 0.0
    t0 = time.perf_counter()
    ck, sk = gen_keys(params, seed=KEY_SEED)
    secs = time.perf_counter() - t0
    np.savez(path, lwe_key=ck.lwe_key, glwe_key=ck.glwe_key, bsk=sk.bsk,
             ksk=sk.ksk)
    ck.rng = Csprng(KEY_SEED + 1)      # encryption stream apart from keygen's
    return ck, sk, secs


def _bits(a: np.ndarray) -> torch.Tensor:
    """uint32 / uint64 numpy -> int32 / int64 tensor on the card, same bits."""
    signed = np.int32 if a.dtype == np.uint32 else np.int64
    return torch.from_numpy(np.ascontiguousarray(a).view(signed)).to(DEVICE)


def _rotation_inputs(params, ck, B, seed):
    """Real encryptions, LUTs, a LUT selection and the mod switch, on the
    card, at either torus width."""
    from fhe_regex_tpu_torch.crypto import lwe
    from fhe_regex_tpu_torch.crypto.golden import make_lut_poly
    from fhe_regex_tpu_torch.ops.pbs import mod_switch
    from fhe_regex_tpu_torch.ops.pbs64 import mod_switch64

    rng = np.random.default_rng(seed)
    msgs = rng.integers(0, 8, size=B)
    cts = np.stack([lwe.encrypt_lwe(params, ck.lwe_key, int(m), ck.rng)
                    for m in msgs])
    fs = [lambda x: (3 * x + 1) % 8, lambda x: (x * x) % 8]
    luts = np.stack([make_lut_poly(params, f) for f in fs])
    idx = rng.integers(0, 2, size=B).astype(np.int32)
    cts_t = _bits(cts)
    ms = (mod_switch if params.torus_bits == 32 else mod_switch64)(params,
                                                                  cts_t)
    return dict(msgs=msgs, fs=fs, idx=idx, cts=cts_t, luts=_bits(luts),
                lut_idx=torch.from_numpy(idx).to(DEVICE), ms=ms)


def _max_abs_err(got: torch.Tensor, want: torch.Tensor) -> int:
    """Largest distance mod 2^32 / 2^64 between two torus tensors."""
    u = np.uint32 if got.dtype == torch.int32 else np.uint64
    d = got.cpu().numpy().view(u) - want.cpu().numpy().view(u)    # wraps
    return int(np.minimum(d, u(0) - d).max())


def kernel_vs_plain(label, params, kernel, plain, bsk, x, timed):
    """Kernel and plain blind rotation on the same card inputs; returns
    (max |difference|, kernel seconds, plain seconds)."""
    args = (params, bsk, x["luts"], x["lut_idx"], x["ms"])
    B = x["ms"].shape[0]
    got, k_s = _timed(lambda: kernel(*args))
    want, p_s = _timed(lambda: plain(*args))
    if timed:                                    # second, warm pass of each
        got, k_s = _timed(lambda: kernel(*args))
        want, p_s = _timed(lambda: plain(*args))
    if got.shape != (B, params.glwe_dimension + 1, params.polynomial_size):
        raise AssertionError(f"{label} output shape {tuple(got.shape)}")
    err = _max_abs_err(got, want)
    if not torch.equal(got, want):
        bad = (got != want).nonzero()[0].tolist()
        raise AssertionError(
            f"{label} {params.name} B={B}: kernel != plain (max |diff| "
            f"{err}, first at {bad})")
    print(f"{label} vs plain {params.name} B={B}: equal; kernel "
          f"{k_s * 1e3:.3f} ms, plain {p_s * 1e3:.3f} ms", flush=True)
    return err, k_s, p_s


def _reset_counts(pbs_cuda) -> None:
    for k in (pbs_cuda.blind_rotate_fused, pbs_cuda.blind_rotate_fused64,
              pbs_cuda.blind_rotate_fused64_bg):
        k.launches = 0


def main_path(port, pbs_cuda, params, ck, sk, kernel, requests,
              backend=None):
    """The requests through ``has_match`` on the card, each decrypting to
    its expected bit, cold and warm; every launch count is 0 just before.
    Returns (launches of ``kernel`` in this run, {name: (ct, result)})."""
    from fhe_regex_tpu_torch.regex.engine import compile_match
    from fhe_regex_tpu_torch.regex.executor import compile_circuit

    _reset_counts(pbs_cuda)
    results = {}
    for name, pattern, content, want in requests:
        circuit = compile_circuit(params, *compile_match(
            len(content), pattern, num_blocks=params.num_blocks, fold="tree"))
        ct = port.encrypt_str(ck, content)
        before = kernel.launches
        res, cold = _timed(lambda: port.has_match(
            sk, ct, pattern, fold="tree", device=DEVICE, backend=backend))
        launches = kernel.launches - before
        res2, warm = _timed(lambda: port.has_match(
            sk, ct, pattern, fold="tree", device=DEVICE, backend=backend))
        got, got2 = port.decrypt(ck, res), port.decrypt(ck, res2)
        print(f"request {params.name} {name}: {len(content)} chars, "
              f"{circuit.pbs_count} bootstraps in {len(circuit.levels)} "
              f"levels, cold {cold:.3f} s, warm {warm:.3f} s, "
              f"{kernel.__name__} launches {launches}, result {got} "
              f"(want {want})", flush=True)
        if (got, got2) != (want, want):
            raise AssertionError(f"{name}: decrypted {got}/{got2}, want {want}")
        if launches <= 0:
            raise AssertionError(f"{name}: {kernel.__name__} was not launched")
        dt = np.uint32 if params.torus_bits == 32 else np.uint64
        if res.dtype != dt:
            raise AssertionError(f"{name}: result dtype {res.dtype}")
        results[name] = (ct, res)
    return kernel.launches, results


def throughput(params, ck, sk, backend):
    """One decrypt-checked PBS batch of 256 real ciphertexts; PBS/s."""
    from fhe_regex_tpu_torch.crypto import lwe
    from fhe_regex_tpu_torch.ops.pbs import make_pbs_core, prepare_server_key

    core = make_pbs_core(prepare_server_key(params, sk, DEVICE, backend))
    x = _rotation_inputs(params, ck, 256, seed=4)
    core(x["luts"], x["lut_idx"], x["cts"])                      # warm
    out, secs = _timed(lambda: core(x["luts"], x["lut_idx"], x["cts"]))
    o = out.cpu().numpy().view(np.uint32 if params.torus_bits == 32
                               else np.uint64)
    dec = [lwe.decrypt_lwe(params, ck.lwe_key, o[i]) for i in range(256)]
    exp = [x["fs"][x["idx"][i]](int(m)) for i, m in enumerate(x["msgs"])]
    if dec != exp:
        bad = sum(d != e for d, e in zip(dec, exp))
        raise AssertionError(f"{params.name} {backend} B=256: {bad} of 256 "
                             f"decrypt wrong")
    print(f"PBS batch {params.name} {backend} B=256: {secs:.3f} s, "
          f"{256 / secs:.1f} PBS/s, all decrypt", flush=True)


def same_on_cpu(port, params, ck, sk):
    """One small request gives the same ciphertext on the card and the CPU."""
    ct = port.encrypt_str(ck, "Acdde")
    a = port.has_match(sk, ct, "/^a[b-d]{2,4}e$/i", fold="tree",
                       device=DEVICE)
    b = port.has_match(sk, ct, "/^a[b-d]{2,4}e$/i", fold="tree", device="cpu")
    if not np.array_equal(a, b) or port.decrypt(ck, a) != 1:
        raise AssertionError(f"{params.name}: card and CPU results differ")


def main() -> int:
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device; this script runs only "
                         "on the card")
    t_start = time.perf_counter()
    sys.path.insert(0, str(ROOT))
    import fhe_regex_tpu_torch as port
    if ROOT not in Path(port.__file__).resolve().parents:
        raise SystemExit(f"chip_smoke: imported {port.__file__}, not the "
                         f"package beside this script")
    from fhe_regex_tpu_torch.ops import pbs_cuda
    from fhe_regex_tpu_torch.ops.pbs import blind_rotate, prepare_server_key
    from fhe_regex_tpu_torch.ops.pbs64 import blind_rotate64
    from fhe_regex_tpu_torch.params import get_params

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True,
        timeout=60).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    kind = torch.cuda.get_device_name(0)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} on {kind}",
          flush=True)

    _, build_s = _timed(pbs_cuda.build)
    print(f"kernel build {build_s:.1f} s ({pbs_cuda.library_path().name})",
          flush=True)

    # ---- phase 2: the 32-bit kernel against its plain version ----
    errs = []
    small = get_params(SMALL)
    ck_s, sk_s = port.gen_keys(small, seed=7)
    dk_s = prepare_server_key(small, sk_s, DEVICE, "cuda-fused")
    for B in (8, 37):
        errs.append(kernel_vs_plain(
            "blind_rotate_fused", small, pbs_cuda.blind_rotate_fused,
            blind_rotate, dk_s.bsk, _rotation_inputs(small, ck_s, B, seed=B),
            timed=False)[0])
    full = get_params(FULL)
    ck, sk, keygen_s = _keys(full)
    print(f"keys {full.name}: keygen {keygen_s:.1f} s (0 = cached)",
          flush=True)
    dk = prepare_server_key(full, sk, DEVICE, "cuda-fused")
    times = {}
    for B in (8, 256):
        err, k_s, p_s = kernel_vs_plain(
            "blind_rotate_fused", full, pbs_cuda.blind_rotate_fused,
            blind_rotate, dk.bsk, _rotation_inputs(full, ck, B, seed=100 + B),
            timed=True)
        errs.append(err)
        times[B] = (k_s, p_s)

    # ---- phase 3: the 32-bit main path, six requests ----
    main_launches, results = main_path(port, pbs_cuda, full, ck, sk,
                                       pbs_cuda.blind_rotate_fused, REQUESTS)

    # the result is right by the repo's own means: the same ciphertext as
    # the plain backend on the card, and as the CPU on a small set
    name, pattern, _, _ = REQUESTS[0]
    ct = results[name][0]
    a = port.has_match(sk, ct, pattern, fold="tree", device=DEVICE)
    b = port.has_match(sk, ct, pattern, fold="tree", device=DEVICE,
                       backend="torch")
    if not np.array_equal(a, b):
        raise AssertionError(f"{name}: cuda-fused and torch results differ")
    same_on_cpu(port, small, ck_s, sk_s)
    print("results equal the plain backend (card) and the CPU (small set)",
          flush=True)

    # ---- phase 4: 32-bit throughput ----
    throughput(full, ck, sk, "cuda-fused")

    # ---- phase 5: the 64-bit kernels against their plain version ----
    errs64, errs64_bg = [], []
    small64 = get_params(SMALL64)
    ck_s64, sk_s64 = port.gen_keys(small64, seed=9)
    dk_s64 = prepare_server_key(small64, sk_s64, DEVICE, "cuda64")
    for B in (8, 37):
        errs64.append(kernel_vs_plain(
            "blind_rotate_fused64", small64, pbs_cuda.blind_rotate_fused64,
            blind_rotate64, dk_s64.bsk,
            _rotation_inputs(small64, ck_s64, B, seed=B), timed=False)[0])
    full64 = get_params(FULL64)
    ck64, sk64, keygen64_s = _keys(full64)
    print(f"keys {full64.name}: keygen {keygen64_s:.1f} s (0 = cached)",
          flush=True)
    dk64 = prepare_server_key(full64, sk64, DEVICE, "cuda64")
    dk64_bg = prepare_server_key(full64, sk64, DEVICE, "cuda64-bg")
    if dk64_bg.drop64 != (1, 2):
        raise AssertionError(f"cuda64-bg key drop {dk64_bg.drop64}, want "
                             f"(1, 2) at {full64.name}")
    times64, times64_bg = {}, {}
    for B in (8, 256):
        x = _rotation_inputs(full64, ck64, B, seed=200 + B)
        err, k_s, p_s = kernel_vs_plain(
            "blind_rotate_fused64", full64, pbs_cuda.blind_rotate_fused64,
            blind_rotate64, dk64.bsk, x, timed=True)
        errs64.append(err)
        times64[B] = (k_s, p_s)
        err, k_s, p_s = kernel_vs_plain(
            "blind_rotate_fused64_bg", full64,
            pbs_cuda.blind_rotate_fused64_bg, blind_rotate64, dk64_bg.bsk, x,
            timed=True)
        errs64_bg.append(err)
        times64_bg[B] = (k_s, p_s)
    args = (full64, dk64_bg.bsk, x["luts"], x["lut_idx"], x["ms"])
    one, one_s = _timed(lambda: pbs_cuda.blind_rotate_fused64_bg(*args,
                                                                 tb=256))
    two, two_s = _timed(lambda: pbs_cuda.blind_rotate_fused64_bg(*args,
                                                                 tb=128))
    if not torch.equal(one, two):
        raise AssertionError("blind_rotate_fused64_bg: tb=256 and tb=128 "
                             "outputs differ")
    print(f"blind_rotate_fused64_bg B=256: tb=256 {one_s * 1e3:.3f} ms, "
          f"tb=128 {two_s * 1e3:.3f} ms, equal", flush=True)

    # ---- phase 6: the 64-bit main path, six requests on cuda64-bg ----
    main64_bg, results64 = main_path(port, pbs_cuda, full64, ck64, sk64,
                                     pbs_cuda.blind_rotate_fused64_bg,
                                     REQUESTS)
    # kernel #5's path: one request through has_match on cuda64, bit for
    # bit against the plain backend on the card
    main64, res_cuda64 = main_path(port, pbs_cuda, full64, ck64, sk64,
                                   pbs_cuda.blind_rotate_fused64,
                                   REQUESTS[:1], backend="cuda64")
    name, pattern, _, _ = REQUESTS[0]
    ct, a = res_cuda64[name]
    b = port.has_match(sk64, ct, pattern, fold="tree", device=DEVICE,
                       backend="torch64")
    if a.dtype != np.uint64 or not np.array_equal(a, b):
        raise AssertionError(f"{name}: cuda64 and torch64 results differ")
    same_on_cpu(port, small64, ck_s64, sk_s64)
    print("64-bit results: cuda64 equals torch64 (card), card equals CPU "
          "(small set)", flush=True)

    # ---- phase 7: 64-bit throughput ----
    throughput(full64, ck64, sk64, "cuda64-bg")

    def entry(name, source, replaces, launches, err, t):
        return {"name": name, "route": "cuda",
                "source": f"fhe_regex_tpu_torch/csrc/{source}",
                "replaces": f"fhe_regex_tpu/ops/pbs_pallas.py:{replaces}",
                "launches": launches, "max_abs_err": err,
                "ms": t[256][0] * 1e3, "plain_ms": t[256][1] * 1e3}

    print(f"chip_smoke {time.perf_counter() - t_start:.1f} s", flush=True)
    print(json.dumps({"kernels": [
        entry("blind_rotate_fused", "blind_rotate.cu", 358, main_launches,
              max(errs), times),
        entry("blind_rotate_fused64", "blind_rotate64.cu", 1196, main64,
              max(errs64), times64),
        entry("blind_rotate_fused64_bg", "blind_rotate64.cu", 1662,
              main64_bg, max(errs64_bg), times64_bg),
    ]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
