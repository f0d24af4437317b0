#!/usr/bin/env python3
"""Device idle share of the PyTorch port's serving paths on the card.

    python3 chip_profile.py

Needs one CUDA device; reuses the keys that ``chip_smoke.py`` caches in
``.cache/`` (makes them otherwise).  Three runs, each once warm and then
once under ``torch.profiler``:

1. ``exact_literal`` of ``chip_smoke.REQUESTS`` through ``has_match`` on
   the per-step backend ``cuda`` (two launches per CMUX step, enqueued
   from Python), level by level (FHE_REGEX_FUSE_LEVELS=0: the graph of
   the level loop is profiled in ``chip_smoke.py`` phase 16);
2. ``has_match_many`` on the configuration of ``benchmarks/serving.py``
   (32 contents of 16 characters, ``/abc/``) on ``cuda-bg``, on its
   default (multi-value) plan;
3. ``has_match_many`` on the first 8 of those contents at
   TPU64_MESSAGE_2_CARRY_2 on ``cuda64-bg`` (``ext_product64`` and
   ``stage1_64``), on its default (multi-value) plan.

For each it prints the wall time of the profiled call, the device's busy
time (the union of its kernel and copy intervals), the idle share
1 - busy / wall, and the device time by kernel name with its share of the
busy time, its launches and its mean time per launch (the digit passes
``stage1`` / ``stage1_64`` on a line of their own).  The profiler's own
cost lengthens the wall time a little, so the idle share is an upper
bound.  A kernel launched as a programmatic dependent launch (each step
of a rotation since the digit pass was redesigned) may start before the
kernel ahead of it ends and wait there: its interval then holds that
wait, and the intervals of one step overlap.

Then the blind rotation's time by batch width (B = 8 ... 512, CUDA
events, 2 samples after a warm call) on the default backend of each torus
width (``cuda-fused``, ``cuda64-bg``), on the production keys and random
mod-switched inputs; the digit pass at B = 8, 256 and 512: the 32-bit
``stage1_digits`` alone, per launch from a CUDA graph of 20 launches
(``chip_smoke._graph_ms``), the mean interval per launch of each kernel
inside one rotation of each width (``torch.profiler``), and that
rotation's step timeline (``step_timeline``); and the
registers and spills of each kernel of ``csrc/blind_rotate.cu`` and
``csrc/blind_rotate64.cu`` as ``nvcc -Xptxas -v`` reports them (one more
compile of each source).

Then one warm ``fft`` blind rotation (``ops/pbs_fft.py``) at B = 8 and
256 under ``torch.profiler``: wall and device-busy time, the idle share, the device
ops per CMUX step by name (cuFFT kernels, the batched complex GEMM,
elementwise kernels, copies) and the launches per step.  The idle share
separates the host's dispatch of the eager step loop from device time.

Last, the tensor-parallel split (``tp_split``): one warm ``cuda-fused``
bootstrap batch at B = 256 under ``torch.profiler``, its device time
divided between the external product (which tensor parallelism divides
over the ranks) and the rest (replicated on every rank);
``utils/metrics.TP_PROFILE`` records one run of it.
The last line is a JSON object with these numbers.
"""

from __future__ import annotations

import json
import os
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


DIGIT_KERNELS = re.compile(r"\b(stage1|stage1_64)\(")


def _traced(label: str, fn):
    """(wall seconds, device events) of one warm call of fn under
    torch.profiler."""
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
    return wall, dev


def by_kernel(dev) -> dict:
    """{kernel name: [device ms, launches]} of the events."""
    out = defaultdict(lambda: [0.0, 0])
    for e in dev:
        out[e.name][0] += (e.time_range.end - e.time_range.start) / 1e3
        out[e.name][1] += 1
    return out


def digit_means(names: dict) -> dict:
    """{stage1 | stage1_64: mean us per launch} of a by_kernel table."""
    out = {}
    for name, (ms, count) in names.items():
        hit = DIGIT_KERNELS.search(name)
        if hit:
            out[hit[1]] = ms * 1e3 / count
    return out


def profiled(label: str, fn) -> dict:
    wall, dev = _traced(label, fn)
    busy = busy_us(dev) / 1e6
    names = by_kernel(dev)
    top = sorted(names.items(), key=lambda kv: -kv[1][0])[:6]
    print(f"{label}: wall {wall:.3f} s, device busy {busy:.3f} s, idle "
          f"share {1 - busy / wall:.3f}", flush=True)
    for name, (ms, count) in top:
        print(f"  {name[:60]:60s} {ms:10.1f} ms {ms / 1e3 / busy:6.1%} "
              f"{count:6d} launches {ms * 1e3 / count:9.2f} us each",
              flush=True)
    digits = digit_means(names)
    print(f"  digit pass, mean device us per launch: {digits}", flush=True)
    return {"label": label, "wall_s": wall, "busy_s": busy,
            "idle_share": 1 - busy / wall, "digit_us": digits,
            "top": [[n, ms, c] for n, (ms, c) in top]}


WIDTHS = (8, 16, 32, 64, 128, 256, 512)


def widths(params, sk) -> dict:
    """ms per blind rotation on the width's default CUDA backend, by B."""
    import chip_smoke as smoke
    from fhe_regex_tpu_torch.ops.pbs import prepare_server_key, rotation_fn

    dev = smoke.DEVICE
    dk = prepare_server_key(params, sk, dev)
    rotate = rotation_fn(dk)
    N, n = params.polynomial_size, params.lwe_dimension
    gen = torch.Generator().manual_seed(5)
    luts = torch.randint(-2**31, 2**31, (1, N), generator=gen,
                         dtype=torch.int64)
    luts = luts.to(dev, dk.bsk.dtype)
    out = {}
    for B in WIDTHS:
        ms = torch.randint(0, 2 * N, (B, n + 1), generator=gen,
                           dtype=torch.int32).to(dev)
        idx = torch.zeros(B, dtype=torch.int32, device=dev)
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


DIGIT_WIDTHS = (8, 256, 512)


def short_name(name: str) -> str:
    """``ext_product<4>`` of ``void (anonymous namespace)::ext_product<4>(
    signed char const*, ...)``."""
    hit = re.search(r"(\w+(?:<[^()]*>)?)\(", name)
    return hit[1] if hit else name[:40]


def step_timeline(events) -> dict:
    """Means over the middle steps of one rotation's trace (us): the step
    (from one external product's end to the next), the intervals of the
    digit pass and the external product, and the gaps between them (a
    kernel that starts before the one ahead of it ends gives a negative
    gap)."""
    ev = sorted(events, key=lambda e: e.time_range.start)
    dig = [e.time_range for e in ev if DIGIT_KERNELS.search(e.name)]
    ext = [e.time_range for e in ev if "ext_product" in e.name]
    lo, hi = len(dig) // 8, len(dig) * 7 // 8
    span = range(lo, hi)

    def mean(xs):
        xs = list(xs)
        return sum(xs) / len(xs)
    return {"step": (ext[hi].end - ext[lo].end) / (hi - lo),
            "digit": mean(dig[i].end - dig[i].start for i in span),
            "ext": mean(ext[i].end - ext[i].start for i in span),
            "ext_after_digit": mean(ext[i].start - dig[i].end for i in span),
            "digit_after_ext": mean(dig[i + 1].start - ext[i].end
                                    for i in span)}


def digit_pass(params, sk) -> dict:
    """The digit pass at B = 8, 256, 512 on the width's default CUDA
    backend: the mean device interval per launch of each kernel inside one
    rotation (torch.profiler, random mod-switched inputs), and at 32 bits
    ``stage1_digits`` alone, per launch from a CUDA graph; beside the digit
    pass's byte bound (``chip_smoke.digit_bytes``)."""
    import chip_smoke as smoke
    from fhe_regex_tpu_torch.ops import pbs_cuda
    from fhe_regex_tpu_torch.ops.pbs import prepare_server_key, rotation_fn

    dev = smoke.DEVICE
    dk = prepare_server_key(params, sk, dev)
    rotate = rotation_fn(dk)
    N, n = params.polynomial_size, params.lwe_dimension
    gen = torch.Generator().manual_seed(6)
    luts = torch.randint(-2**31, 2**31, (1, N), generator=gen,
                         dtype=torch.int64).to(dev, dk.bsk.dtype)
    out = {}
    for B in DIGIT_WIDTHS:
        ms = torch.randint(0, 2 * N, (B, n + 1), generator=gen,
                           dtype=torch.int32).to(dev)
        idx = torch.zeros(B, dtype=torch.int32, device=dev)
        _, events = _traced(f"rotation B={B}",
                            lambda: rotate(luts, idx, ms))
        per = {short_name(k): v[0] * 1e3 / v[1]
               for k, v in by_kernel(events).items()}
        row = {"in_rotation_us": per, "steps_us": step_timeline(events),
               "bound_ms": smoke._bound(0, smoke.digit_bytes(params, B))[0]}
        if params.torus_bits == 32:
            acc, a = smoke._digit_inputs(params, B, 800 + B)
            row["alone_ms"] = smoke._graph_ms(
                lambda: pbs_cuda.stage1_digits(params, acc, a))
        print(f"digit pass {params.name} on {dk.backend} B={B}: in the "
              f"rotation, mean us per launch "
              + ", ".join(f"{k} {v:.2f}" for k, v in per.items())
              + "; steps (us) " + ", ".join(
                  f"{k} {v:.2f}" for k, v in row["steps_us"].items())
              + (f"; stage1_digits alone (CUDA graph) "
                 f"{smoke._fmt(row['alone_ms'])} ms"
                 if "alone_ms" in row else "")
              + f"; bound {row['bound_ms']:.5f} ms", flush=True)
        out[B] = row
    return out


def ptxas_report() -> list:
    """[{kernel, registers, spill_stores, spill_loads}] of both sources,
    from ``nvcc -Xptxas -v``."""
    from fhe_regex_tpu_torch.ops import pbs_cuda

    pbs_cuda.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    out = []
    for source in pbs_cuda.SOURCES:
        with tempfile.TemporaryDirectory(dir=pbs_cuda.BUILD_DIR) as tmp:
            res = subprocess.run(
                [pbs_cuda._nvcc(), *pbs_cuda.NVCC_FLAGS, "-Xptxas", "-v",
                 "-c", "-o", str(Path(tmp) / "k.o"),
                 str(pbs_cuda.CSRC / source)],
                capture_output=True, text=True, check=True)
        for line in (res.stdout + res.stderr).splitlines():
            entry = re.search(r"Compiling entry function '.*?\d+"
                              r"(ext_product64|ext_product|stage1_64|stage1"
                              r"|acc_init64|acc_init)(I(?:Li\d+E)+E)?", line)
            if entry:
                args = re.findall(r"Li(\d+)E", entry[2] or "")
                out.append({"kernel": entry[1] + (f"<{', '.join(args)}>"
                                                  if args else ""),
                            "source": source})
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


def fft_rotation(params, sk) -> dict:
    """One warm ``fft`` rotation at B = 8 and 256 under torch.profiler, on
    random mod-switched inputs: wall, busy, idle share, device ops per
    step by name and launches per step."""
    import chip_smoke as smoke
    from fhe_regex_tpu_torch.ops.pbs import prepare_server_key, rotation_fn

    dev = smoke.DEVICE
    dk = prepare_server_key(params, sk, dev, "fft")
    rotate = rotation_fn(dk)
    N, n = params.polynomial_size, params.lwe_dimension
    gen = torch.Generator().manual_seed(7)
    luts = torch.randint(-2**31, 2**31, (1, N), generator=gen,
                         dtype=torch.int64).to(dev, torch.int32)
    out = {}
    for B in (8, 256):
        ms = torch.randint(0, 2 * N, (B, n + 1), generator=gen,
                           dtype=torch.int32).to(dev)
        idx = torch.zeros(B, dtype=torch.int32, device=dev)
        wall, events = _traced(f"fft rotation B={B}",
                               lambda: rotate(luts, idx, ms))
        busy = busy_us(events) / 1e6
        per_step = defaultdict(lambda: {"launches": 0.0, "us": 0.0})
        for k, (t, c) in sorted(by_kernel(events).items(),
                                key=lambda kv: -kv[1][0]):
            per_step[short_name(k)]["launches"] += c / n
            per_step[short_name(k)]["us"] += t * 1e3 / n
        launches = sum(row["launches"] for row in per_step.values())
        out[B] = {"wall_s": wall, "busy_s": busy,
                  "idle_share": 1 - busy / wall,
                  "launches_per_step": launches, "per_step": per_step}
        print(f"fft rotation {params.name} B={B}: wall {wall:.3f} s, device busy {busy:.3f} s, idle "
              f"share {1 - busy / wall:.3f}, {launches:.1f} device ops a "
              f"step", flush=True)
        for name, row in per_step.items():
            print(f"  {name[:60]:60s} {row['launches']:5.2f} a step "
                  f"{row['us']:9.2f} us a step", flush=True)
    return out


def tp_split(params, sk, B: int = 256) -> dict:
    """Device seconds of one warm ``cuda-fused`` bootstrap batch of B
    random ciphertexts (``make_pbs_core``: mod switch, rotation, sample
    extract, keyswitch) under torch.profiler: the ``ext_product`` launches
    (divided over the ranks under tensor parallelism), and the rest of the
    busy time (digit passes, accumulator set-up, extract, keyswitch:
    replicated on every rank)."""
    import chip_smoke as smoke
    from fhe_regex_tpu_torch.ops.pbs import make_pbs_core, prepare_server_key

    dev = smoke.DEVICE
    core = make_pbs_core(prepare_server_key(params, sk, dev, "cuda-fused"))
    N, n = params.polynomial_size, params.lwe_dimension
    gen = torch.Generator().manual_seed(8)
    luts = torch.randint(-2**31, 2**31, (1, N), generator=gen,
                         dtype=torch.int64).to(dev, torch.int32)
    cts = torch.randint(-2**31, 2**31, (B, n + 1), generator=gen,
                        dtype=torch.int64).to(dev, torch.int32)
    idx = torch.zeros(B, dtype=torch.int32, device=dev)
    wall, events = _traced(f"tp split B={B}", lambda: core(luts, idx, cts))
    busy = busy_us(events) / 1e6
    ext = sum(e.time_range.end - e.time_range.start for e in events
              if "ext_product" in e.name) / 1e6
    out = {"B": B, "wall_s": wall, "ext_product_s": ext,
           "glue_s": busy - ext, "total_s": busy,
           "glue_fraction": (busy - ext) / busy}
    print(f"tp split {params.name} cuda-fused B={B}: device busy {busy:.4f} "
          f"s, ext_product {ext:.4f} s, the rest {busy - ext:.4f} s (glue "
          f"fraction {(busy - ext) / busy:.4f}); wall {wall:.4f} s",
          flush=True)
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
    os.environ["FHE_REGEX_FUSE_LEVELS"] = "0"     # the per-level loop
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
    table, digits = {}, {}
    for name in (smoke.FULL, smoke.FULL64):
        sk_w = smoke._keys(get_params(name))[1]
        table[name] = widths(get_params(name), sk_w)
        digits[name] = digit_pass(get_params(name), sk_w)
    ptxas = ptxas_report()
    fft = fft_rotation(params, sk)
    tp = tp_split(params, sk)
    print(json.dumps({"device": smi, "runs": runs, "widths": table,
                      "digit_pass": digits, "ptxas": ptxas, "fft": fft,
                      "tp_split": tp}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
