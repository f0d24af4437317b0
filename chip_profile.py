#!/usr/bin/env python3
"""Device idle share of the PyTorch port's serving paths on the card.

    python3 chip_profile.py

Needs one CUDA device; reuses the keys that ``chip_smoke.py`` caches in
``.cache/`` (makes them otherwise).  Three runs, each once warm and then
once under ``torch.profiler``:

1. ``exact_literal`` of ``chip_smoke.REQUESTS`` through ``has_match`` on
   the per-step backend ``cuda`` (two launches per CMUX step, enqueued
   from Python);
2. ``has_match_many`` on the configuration of ``benchmarks/serving.py``
   (32 contents of 16 characters, ``/abc/``) on ``cuda-bg``, on its
   default (multi-value) plan;
3. ``has_match_many`` on the first 8 of those contents at
   TPU64_MESSAGE_2_CARRY_2 on ``cuda64-bg`` (``ext_product64`` and
   ``stage1_64``), on its default (multi-value) plan.

For each it prints the wall time of the profiled call, the device's busy
time (the union of its kernel and copy intervals), the idle share
1 - busy / wall, and the device time by kernel name with its share of the
busy time.  The profiler's own
cost lengthens the wall time a little, so the idle share is an upper
bound.  Then the blind rotation's time by batch width (B = 8 ... 512,
CUDA events, 2 samples after a warm call) on the default backend of each
torus width (``cuda-fused``, ``cuda64-bg``), on the production keys and
random mod-switched inputs, and the registers and spills of each kernel
of ``csrc/blind_rotate64.cu`` as ``nvcc -Xptxas -v`` reports them (one
more compile of that source).  The last line is a JSON object with these
numbers.
"""

from __future__ import annotations

import json
import re
import subprocess
import sys
import tempfile
import time
from collections import defaultdict
from pathlib import Path

import numpy as np
import torch


def busy_us(events) -> float:
    """Length of the union of the events' [start, end) intervals (us)."""
    total, end = 0.0, None
    for s, e in sorted((ev.time_range.start, ev.time_range.end)
                       for ev in events):
        if end is None or s > end:
            total += e - s
            end = e
        elif e > end:
            total += e - end
            end = e
    return total


def profiled(label: str, fn) -> dict:
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()                                   # warm
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    dev = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    if not dev:
        raise SystemExit(f"chip_profile: {label}: the profiler recorded no "
                         f"device events")
    busy = busy_us(dev) / 1e6
    by_name = defaultdict(lambda: [0.0, 0])
    for e in dev:
        by_name[e.name][0] += (e.time_range.end - e.time_range.start) / 1e3
        by_name[e.name][1] += 1
    top = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:6]
    print(f"{label}: wall {wall:.3f} s, device busy {busy:.3f} s, idle "
          f"share {1 - busy / wall:.3f}", flush=True)
    for name, (ms, count) in top:
        print(f"  {name[:60]:60s} {ms:10.1f} ms {ms / 1e3 / busy:6.1%} "
              f"{count:6d} launches", flush=True)
    return {"label": label, "wall_s": wall, "busy_s": busy,
            "idle_share": 1 - busy / wall,
            "top": [[n, ms, c] for n, (ms, c) in top]}


WIDTHS = (8, 16, 32, 64, 128, 256, 512)


def widths(params, sk) -> dict:
    """ms per blind rotation on the width's default CUDA backend, by B."""
    from fhe_regex_tpu_torch.ops.pbs import prepare_server_key, rotation_fn

    dk = prepare_server_key(params, sk, "cuda")
    rotate = rotation_fn(dk)
    N, n = params.polynomial_size, params.lwe_dimension
    gen = torch.Generator().manual_seed(5)
    luts = torch.randint(-2**31, 2**31, (1, N), generator=gen,
                         dtype=torch.int64)
    luts = luts.to("cuda", dk.bsk.dtype)
    out = {}
    for B in WIDTHS:
        ms = torch.randint(0, 2 * N, (B, n + 1), generator=gen,
                           dtype=torch.int32).to("cuda")
        idx = torch.zeros(B, dtype=torch.int32, device="cuda")
        rotate(luts, idx, ms)                          # warm
        times = []
        for _ in range(2):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            rotate(luts, idx, ms)
            end.record()
            end.synchronize()
            times.append(start.elapsed_time(end))
        out[B] = times
    print(f"rotation ms by width, {params.name} on {dk.backend}: "
          + ", ".join(f"B={B} {' / '.join(f'{t:.3f}' for t in v)}"
                      for B, v in out.items()), flush=True)
    return out


def ptxas_report() -> list:
    """[{kernel, registers, spill_stores, spill_loads}] of the 64-bit
    source, from ``nvcc -Xptxas -v``."""
    from fhe_regex_tpu_torch.ops import pbs_cuda

    pbs_cuda.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=pbs_cuda.BUILD_DIR) as tmp:
        res = subprocess.run(
            [pbs_cuda._nvcc(), *pbs_cuda.NVCC_FLAGS, "-Xptxas", "-v", "-c",
             "-o", str(Path(tmp) / "k.o"),
             str(pbs_cuda.CSRC / "blind_rotate64.cu")],
            capture_output=True, text=True, check=True)
    out = []
    for line in (res.stdout + res.stderr).splitlines():
        entry = re.search(r"Compiling entry function '.*?\d+"
                          r"(ext_product64|stage1_64|acc_init64)"
                          r"(?:ILi(\d)ELi(\d)E)?", line)
        if entry:
            name, nd, mt = entry.groups()
            out.append({"kernel": name + (f"<{nd}, {mt}>" if nd else "")})
        spill = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill "
                          r"loads", line)
        if spill and out:
            out[-1].update(spill_stores=int(spill[1]),
                           spill_loads=int(spill[2]))
        regs = re.search(r"Used (\d+) registers", line)
        if regs and out:
            out[-1]["registers"] = int(regs[1])
    for k in out:
        print(f"ptxas {k}", flush=True)
    return out


def main() -> int:
    if not torch.cuda.is_available():
        raise SystemExit("chip_profile: no CUDA device; this script runs "
                         "only on the card")
    import chip_smoke as smoke
    import fhe_regex_tpu_torch as port
    from fhe_regex_tpu_torch.params import get_params

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True,
        timeout=60).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    params = get_params(smoke.FULL)
    ck, sk, _ = smoke._keys(params)
    name, pattern, content, bit = smoke.REQUESTS[0]
    ct = port.encrypt_str(ck, content)
    runs = []

    def literal():
        res = port.has_match(sk, ct, pattern, fold="tree",
                             device=smoke.DEVICE, backend="cuda")
        if port.decrypt(ck, res) != bit:
            raise AssertionError(f"{name}: wrong bit on cuda")

    runs.append(profiled(f"has_match {name} on cuda", literal))
    cts = np.stack([port.encrypt_str(ck, c) for c in smoke.SERVE])
    want = [1 - i % 2 for i in range(len(smoke.SERVE))]

    def serve():
        res = port.has_match_many(sk, cts, smoke.SERVE_PATTERN,
                                  backend="cuda-bg", device=smoke.DEVICE)
        if [port.decrypt(ck, r) for r in res] != want:
            raise AssertionError("has_match_many: wrong bits on cuda-bg")

    runs.append(profiled(f"has_match_many C={len(cts)} on cuda-bg", serve))
    params64 = get_params(smoke.FULL64)
    ck64, sk64, _ = smoke._keys(params64)
    cts64 = np.stack([port.encrypt_str(ck64, c) for c in smoke.SERVE[:8]])

    def serve64():
        res = port.has_match_many(sk64, cts64, smoke.SERVE_PATTERN,
                                  backend="cuda64-bg", device=smoke.DEVICE)
        if [port.decrypt(ck64, r) for r in res] != want[:8]:
            raise AssertionError("has_match_many: wrong bits on cuda64-bg")

    runs.append(profiled(f"has_match_many C={len(cts64)} on cuda64-bg",
                         serve64))
    table = {name: widths(get_params(name), smoke._keys(get_params(name))[1])
             for name in (smoke.FULL, smoke.FULL64)}
    print(json.dumps({"device": smi, "runs": runs, "widths": table,
                      "ptxas64": ptxas_report()}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
