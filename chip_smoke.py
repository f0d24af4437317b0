#!/usr/bin/env python3
"""On-card smoke run of the PyTorch port (``fhe_regex_tpu_torch``).

    python3 chip_smoke.py

Needs one CUDA device, ``nvcc`` and ``nvidia-smi``; builds the kernels from
``fhe_regex_tpu_torch/csrc`` and imports nothing of JAX.  Phases:

1. device: a CUDA device must be present (else exit non-zero, no result);
2. kernel vs plain: the CUDA blind rotation against the plain PyTorch
   version on the card, bit for bit (tolerance zero: both are exact
   integer arithmetic mod 2^32), at TEST_PARAMS_NOISY (B = 8, 37) and at
   TPU_MESSAGE_2_CARRY_2 (B = 8, 256), with both times;
3. main path: keys for TPU_MESSAGE_2_CARRY_2 (cached in ``.cache/``), then
   six requests with real ``encrypt_str`` -> ``has_match(fold="tree",
   device="cuda")`` -> ``decrypt``, each against its expected bit, with the
   kernel's launch count; one request is also checked bit for bit against
   the plain backend, and one small request against the CPU;
4. throughput: one decrypt-checked ``pbs_batch`` at B = 256.

Any failure raises.  The line before the last is a JSON object describing
each kernel; the last line is ``{"ok": true, "device": {...}}``.
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


def _rotation_inputs(params, ck, B, seed):
    """Mod-switched real encryptions, LUTs and a LUT selection on the card."""
    from fhe_regex_tpu_torch.crypto import lwe
    from fhe_regex_tpu_torch.crypto.golden import make_lut_poly
    from fhe_regex_tpu_torch.ops.pbs import mod_switch

    rng = np.random.default_rng(seed)
    msgs = rng.integers(0, 8, size=B)
    cts = np.stack([lwe.encrypt_lwe(params, ck.lwe_key, int(m), ck.rng)
                    for m in msgs])
    fs = [lambda x: (3 * x + 1) % 8, lambda x: (x * x) % 8]
    luts = np.stack([make_lut_poly(params, f) for f in fs])
    idx = rng.integers(0, 2, size=B).astype(np.int32)
    dev = torch.device(DEVICE)
    cts_t = torch.from_numpy(cts.view(np.int32)).to(dev)
    return dict(msgs=msgs, fs=fs, idx=idx, cts=cts_t,
                luts=torch.from_numpy(luts.view(np.int32)).to(dev),
                lut_idx=torch.from_numpy(idx).to(dev),
                ms=mod_switch(params, cts_t))


def kernel_vs_plain(params, ck, sk, B, seed, timed):
    """Kernel and plain blind rotation on the same card inputs; returns
    (max |difference|, kernel seconds, plain seconds)."""
    from fhe_regex_tpu_torch.ops.pbs import blind_rotate, prepare_server_key
    from fhe_regex_tpu_torch.ops.pbs_cuda import blind_rotate_fused

    dk = prepare_server_key(params, sk, DEVICE, "cuda-fused")
    x = _rotation_inputs(params, ck, B, seed)
    args = (params, dk.bsk, x["luts"], x["lut_idx"], x["ms"])
    got, k_s = _timed(lambda: blind_rotate_fused(*args))
    want, p_s = _timed(lambda: blind_rotate(*args))
    if timed:                                    # second, warm pass of each
        got, k_s = _timed(lambda: blind_rotate_fused(*args))
        want, p_s = _timed(lambda: blind_rotate(*args))
    if got.shape != (B, params.glwe_dimension + 1, params.polynomial_size):
        raise AssertionError(f"kernel output shape {tuple(got.shape)}")
    err = int((got.to(torch.int64) - want.to(torch.int64)).abs().max())
    if not torch.equal(got, want):
        bad = (got != want).nonzero()[0].tolist()
        raise AssertionError(
            f"{params.name} B={B}: kernel != plain (max |diff| {err}, first "
            f"at {bad})")
    print(f"kernel vs plain {params.name} B={B}: equal; kernel "
          f"{k_s * 1e3:.3f} ms, plain {p_s * 1e3:.3f} ms", flush=True)
    return err, k_s, p_s


def main() -> int:
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device; this script runs only "
                         "on the card")
    sys.path.insert(0, str(ROOT))
    import fhe_regex_tpu_torch as port
    if ROOT not in Path(port.__file__).resolve().parents:
        raise SystemExit(f"chip_smoke: imported {port.__file__}, not the "
                         f"package beside this script")
    from fhe_regex_tpu_torch.ops import pbs_cuda
    from fhe_regex_tpu_torch.ops.pbs import make_pbs_core, prepare_server_key
    from fhe_regex_tpu_torch.params import get_params
    from fhe_regex_tpu_torch.regex.engine import compile_match
    from fhe_regex_tpu_torch.regex.executor import compile_circuit

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

    # ---- phase 2: the kernel against its plain version on the card ----
    errs = []
    small = get_params(SMALL)
    ck_s, sk_s = port.gen_keys(small, seed=7)
    for B in (8, 37):
        errs.append(kernel_vs_plain(small, ck_s, sk_s, B, seed=B,
                                    timed=False)[0])
    full = get_params(FULL)
    ck, sk, keygen_s = _keys(full)
    print(f"keys {full.name}: keygen {keygen_s:.1f} s (0 = cached)",
          flush=True)
    times = {}
    for B in (8, 256):
        err, k_s, p_s = kernel_vs_plain(full, ck, sk, B, seed=100 + B,
                                        timed=True)
        errs.append(err)
        times[B] = (k_s, p_s)

    # ---- phase 3: the main path, six requests ----
    pbs_cuda.blind_rotate_fused.launches = 0
    results = {}
    for name, pattern, content, want in REQUESTS:
        circuit = compile_circuit(full, *compile_match(
            len(content), pattern, num_blocks=full.num_blocks, fold="tree"))
        ct = port.encrypt_str(ck, content)
        before = pbs_cuda.blind_rotate_fused.launches
        res, cold = _timed(lambda: port.has_match(sk, ct, pattern,
                                                  fold="tree", device=DEVICE))
        launches = pbs_cuda.blind_rotate_fused.launches - before
        res2, warm = _timed(lambda: port.has_match(sk, ct, pattern,
                                                   fold="tree", device=DEVICE))
        got, got2 = port.decrypt(ck, res), port.decrypt(ck, res2)
        print(f"request {name}: {len(content)} chars, {circuit.pbs_count} "
              f"bootstraps in {len(circuit.levels)} levels, cold "
              f"{cold:.3f} s, warm {warm:.3f} s, kernel launches {launches}, "
              f"result {got} (want {want})", flush=True)
        if (got, got2) != (want, want):
            raise AssertionError(f"{name}: decrypted {got}/{got2}, want {want}")
        if launches <= 0:
            raise AssertionError(f"{name}: the kernel was not launched")
        results[name] = res
    main_launches = pbs_cuda.blind_rotate_fused.launches

    # the result is right by the repo's own means: the same ciphertext as
    # the plain backend on the card, and as the CPU on a small set
    name, pattern, content, _ = REQUESTS[0]
    ct = port.encrypt_str(ck, content)
    a = port.has_match(sk, ct, pattern, fold="tree", device=DEVICE)
    b = port.has_match(sk, ct, pattern, fold="tree", device=DEVICE,
                       backend="torch")
    if not np.array_equal(a, b):
        raise AssertionError(f"{name}: cuda-fused and torch results differ")
    ct_s = port.encrypt_str(ck_s, "Acdde")
    a = port.has_match(sk_s, ct_s, "/^a[b-d]{2,4}e$/i", fold="tree",
                       device=DEVICE)
    b = port.has_match(sk_s, ct_s, "/^a[b-d]{2,4}e$/i", fold="tree",
                       device="cpu")
    if not np.array_equal(a, b) or port.decrypt(ck_s, a) != 1:
        raise AssertionError("TEST_PARAMS_NOISY: card and CPU results differ")
    print("results equal the plain backend (card) and the CPU (small set)",
          flush=True)

    # ---- phase 4: throughput, one pbs_batch at B = 256 ----
    from fhe_regex_tpu_torch.crypto import lwe
    core = make_pbs_core(prepare_server_key(full, sk, DEVICE, "cuda-fused"))
    x = _rotation_inputs(full, ck, 256, seed=4)
    core(x["luts"], x["lut_idx"], x["cts"])                      # warm
    out, secs = _timed(lambda: core(x["luts"], x["lut_idx"], x["cts"]))
    o = out.cpu().numpy().view(np.uint32)
    dec = [lwe.decrypt_lwe(full, ck.lwe_key, o[i]) for i in range(256)]
    exp = [x["fs"][x["idx"][i]](int(m)) for i, m in enumerate(x["msgs"])]
    if dec != exp:
        bad = sum(d != e for d, e in zip(dec, exp))
        raise AssertionError(f"pbs_batch B=256: {bad} of 256 decrypt wrong")
    print(f"pbs_batch B=256: {secs:.3f} s, {256 / secs:.1f} PBS/s, all "
          f"decrypt", flush=True)

    print(json.dumps({"kernels": [{
        "name": "blind_rotate_fused",
        "route": "cuda",
        "source": "fhe_regex_tpu_torch/csrc/blind_rotate.cu",
        "replaces": "fhe_regex_tpu/ops/pbs_pallas.py:358",
        "launches": main_launches,
        "max_abs_err": max(errs),
        "ms": times[256][0] * 1e3,
        "plain_ms": times[256][1] * 1e3,
    }]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
