#!/usr/bin/env python3
"""On-card smoke run of the PyTorch port (``fhe_regex_tpu_torch``).

    python3 chip_smoke.py

Needs one CUDA device, ``nvcc`` and ``nvidia-smi``; builds the kernels from
``fhe_regex_tpu_torch/csrc`` and imports nothing of JAX.  Phases:

1. device: a CUDA device must be present (else exit non-zero, no result);
2. 32-bit kernel vs plain: the CUDA blind rotation against the plain
   PyTorch version on the card, bit for bit (tolerance zero: both are exact
   integer arithmetic mod 2^32), at TEST_PARAMS_NOISY (B = 8, 37) and at
   TPU_MESSAGE_2_CARRY_2 (B = 8, 256), with both times; then three B = 8
   rotations enqueued back to back, each equal to plain (each step's two
   kernels are chained by programmatic dependent launch: a missing wait
   would race);
3. 32-bit main path: keys for TPU_MESSAGE_2_CARRY_2 (cached in ``.cache/``),
   then six requests with real ``encrypt_str`` -> ``has_match(fold="tree",
   device="cuda")`` -> ``decrypt``, each against its expected bit, with the
   kernel's launch count; one request is also checked bit for bit against
   the plain backend, and one small request against the CPU;
4. 32-bit throughput: one decrypt-checked PBS batch at B = 256;
5. 64-bit kernels vs plain, tolerance zero (mod 2^64): ``cuda64`` against
   ``blind_rotate64`` at TEST_PARAMS_64 (B = 8, 37: one int8 limb per
   digit); at TEST_PARAMS_64 with the production digit (base 2^23, one
   level: three limbs), ``cuda64`` at B = 8, 37 and ``cuda64-bg`` at B = 8,
   40 on keys rounded by the drops (1, 2) and (2, 2); at
   TPU64_MESSAGE_2_CARRY_2 ``cuda64`` at B = 8, 37, 256 and ``cuda64-bg``
   on its rounded key with its drop (1, 2) at B = 8, 256, and at B = 256
   in one block and in two (tb = 256, 128) and with the drop (0, 0), all
   equal;
6. 64-bit main path: the six requests at TPU64_MESSAGE_2_CARRY_2 on the
   default backend (``cuda64-bg``), then one request on ``cuda64``, checked
   bit for bit against ``torch64`` on the card, and one small request
   against the CPU;
7. 64-bit throughput: one decrypt-checked PBS batch at B = 256 on
   ``cuda64-bg``;
8. the per-launch kernels vs plain, tolerance zero: the digit pass
   ``stage1_digits`` (#2, the ``stage1`` that #3 and #4 run each step) at
   TEST_PARAMS_NOISY (N = 256) and TPU_MESSAGE_2_CARRY_2, and
   ``stage1_digits64`` (the ``stage1_64`` of #5 and #6) at the N = 256
   base-2^23 set and TPU64_MESSAGE_2_CARRY_2, each at B = 8, 37 and 256
   with the edge rotations and torus edge words planted, timed at the
   production set at B = 8, 256 and 512 beside its byte bound; one
   ``external_product_step`` launch (#1, the int8 tensor-core external
   product that #3 and #4 run too) at B = 8, 37 and 256, timed at 8 and
   256 beside one float64 ``torch.matmul`` with the Toeplitz matrix
   prebuilt (the library call that computes the same product); then a
   whole ``blind_rotate_steps`` rotation at B = 8 and 256, bit-equal to
   ``blind_rotate_fused``.  These per-launch times are device times: a
   CUDA graph of 20 launches (3 for the plain versions and the matmul),
   replayed between two CUDA events (``_graph_ms``);
9. the batch-grid kernel (``cuda-bg``): B = 256 in one block and in two
   (tb = 256, 128), equal to ``cuda-fused``; B = 1024 at the default tb,
   bit-equal to the plain rotation, timed beside ``cuda-fused``;
10. the serving path at TPU_MESSAGE_2_CARRY_2: ``has_match_many`` on the
   configuration of ``benchmarks/serving.py`` (32 contents of 16
   characters, ``/abc/``, the odd ones not matching), whose default plan
   is multi-value (fewer rotations than bootstraps, asserted), on
   ``cuda-bg`` cold and warm and on ``cuda-fused`` once, equal
   ciphertexts, every bit decrypted, then once on the classic plan
   (``multivalue=False``); one multi-value ``has_match`` request on
   ``cuda-fused`` equal to the plain backend on the card; then
   ``has_match_many_patterns``, ``has_match_many_positions``,
   ``has_match_long`` (256 characters, five windows) and ``count_matches``
   on the default backend, each decrypt-checked; then one request through
   ``has_match(backend="cuda")``, equal to its ``cuda-fused`` result (its
   level loop captured as a CUDA graph, the default on ``cuda``: the
   launches counted are the warm-up pass's);
11. 64-bit serving: ``has_match_many`` at TPU64_MESSAGE_2_CARRY_2 on
   ``cuda64-bg`` (multi-value plan), 8 contents, decrypt-checked; one
   multi-value ``has_match`` request on ``cuda64`` equal to ``torch64`` on
   the card, and on ``cuda64-bg`` decrypt-checked;
12. the serving daemon at TPU_MESSAGE_2_CARRY_2 as its own process
   (``python -m fhe_regex_tpu_torch.serve`` on the cached key's bsk and
   ksk, log in ``.cache/serve_daemon.log``), warmed with the five
   DRIVER_CONFIGS, north_star_hit and the serving configuration at
   "many": 32; ``/health`` must name ``cuda-fused``; the six requests over
   ``/match``, each bit-equal to in-process ``has_match`` on the plan the
   daemon compiled; ``/match_many`` of the serving configuration three
   times, bit-equal to ``has_match_many``; one patterns, positions,
   ``/count`` and ``/match_long`` request; then ``/stats`` must count every
   request and show watchdog EMAs of a "levels" shape (``/match`` on
   ``cuda-fused`` keeps the per-level loop by default) and a "many" shape;
   latencies over HTTP beside in-process ones; the daemon's own launch
   counts (``/stats`` "kernel_launches", read just before and just after)
   must show #3 launched by the six /match and by the /match_many;
13. checkpoint and resume on the card: the serving configuration's
   ``run_many`` (multi-value plan) checkpointed every step, killed in step
   4, resumed; ``run`` on quantifiers checkpointed every 2 levels, killed
   in level 6, resumed; both bit-equal to an uninterrupted run, and a
   resume of another circuit refused by its fingerprint; one save's
   seconds beside one launch step's; then the 64-bit daemon in this
   process (``make_server(MatchService(sk64), port=0)`` on
   ``cuda64-bg``): one ``/match`` bit-equal to ``has_match``, launching
   #6;
14. the FFT backend (``fft``, ``ops/pbs_fft.py``: cuFFT through
   ``torch.fft`` and a batched complex128 ``torch.matmul``, no kernel of
   its own) at TPU_MESSAGE_2_CARRY_2: the spectral key (seconds and bytes
   on the card); ``blind_rotate_fft`` at B = 8 and 256, cold and in three
   warm calls, each bit-equal (tolerance zero: float64 rounds every limb
   exactly) to ``cuda-fused`` on the same inputs, the warm calls timed
   with CUDA events beside three of ``cuda-fused`` and beside
   ``fft_rotation_bound``; the six requests through
   ``has_match(backend="fft")``, each bit-equal to its phase-3
   ``cuda-fused`` result; one decrypt-checked PBS batch at B = 256; the
   serving configuration through ``has_match_many(backend="fft")``, on the
   classic plan (asserted) and bit-equal to phase 10's classic
   ``cuda-fused`` run; ``multivalue=True`` refused; no kernel of
   ``ops/pbs_cuda.py`` launched by any of it.  A JSON line ``{"fft":
   ...}`` precedes the kernels line;
15. ``native/libfheregex.so`` (``make -C native`` if absent, and
   removed again at the end, so the earlier phases of every run take the
   compiler the checkout had: the engine is printed beside the latencies)
   builds the Python builder's circuits, op for op, for the DRIVER_CONFIGS
   and the serving configuration;
16. the whole level loop as one CUDA graph (``Executor.run(fuse=True)``,
   captured at a plan's first run on an executor, then replayed), on fresh
   executors against the per-level loop: each circuit compiled twice, a
   per-level cold run of one and a fused cold run (its warm-up pass gives
   the result, then capture and instantiation) of the other, then warm
   runs of each (wall and CUDA events), every result bit-equal to the
   per-level one and to its earlier phase; the per-level loop must launch
   the backend's kernel, and it, the fused cold run and every replay must
   count the launches the capture recorded; the graph's private pool
   bytes.  (a) The six requests on ``cuda-fused`` (== phase 3); (b)
   ``exact_literal`` and ``north_star_hit`` at TPU64_MESSAGE_2_CARRY_2 on
   ``cuda64-bg`` (== phase 6); (c) ``contains_anchors`` on its
   multi-value plan; (d) ``exact_literal`` on ``cuda-fused``, on the
   per-step ``cuda`` backend and on ``fft``, one warm run of each loop
   profiled (wall, device busy as ``chip_profile`` sums it, idle share;
   the ``acc_init``, ``stage1`` and ``ext_product`` kernels in the trace
   must be those the recorded launches run, per-level and replayed), the
   graph's nodes and instantiation seconds from a second capture kept as
   a graph, and the host memory over the capture; then the request of the
   most rotations on ``cuda``; (e) with FHE_REGEX_FUSE_LEVELS unset,
   ``has_match`` keeps the per-level loop on ``cuda-fused`` (the
   watchdog's "levels" key) and takes the graph on ``cuda`` ("fused"), a
   warm replay counting #1 and #2.  A JSON line ``{"fuse": ...}``
   precedes the kernels line;
17. the mesh on the card (``fhe_regex_tpu_torch.parallel``): a NCCL
   process group of world 1 in this process (``multihost.initialize`` on
   a free local port; one card holds one rank) and ``make_mesh(1)``:
   (a) the six 32-bit requests through ``has_match(mesh=)``, each
   bit-equal to its phase-3 result, warm latency beside phase 3's (level
   by level, each all-gather issued eagerly, as the watchdog must show),
   then ``alternation_combo`` through ``run(fuse=True)`` on the mesh
   executor, its all-gathers captured in the graph; (b)
   the serving configuration through ``executor_for(mesh=).run_many`` on
   the multi-value plan (``cuda-bg``) and the classic plan
   (``cuda-fused``), bit-equal to phase 10, contents/s beside phase 10's;
   (c) one 64-bit request on ``cuda64-bg``, bit-equal to phase 6; (d)
   ``make_tp_pbs_fn`` on ``make_tp_mesh(1)`` at B = 8 and 256, as one CUDA
   graph (the default at world 1: a first call's warm-up pass, then the
   capture; replays) and as the eager step loop (FHE_REGEX_FUSE_LEVELS=0),
   both bit-equal to ``cuda-fused``'s bootstrap of the same batch, 866
   launches each of ``stage1_digits`` (#2) and ``external_product_rows``
   (#1's device code over a block of the digit rows) a call, counted and
   traced, ms per batch of both beside ``cuda-fused``'s, device busy time
   and idle share profiled, cold seconds, the graph's nodes and pool; the
   row-block entry against its plain version, tolerance zero, at B = 8 and
   256 and R = 6, 3, 2, 1 rows (the blocks of D = 1, 2, 3, 6, cut by
   slicing), its blocks summing to the whole step, timed at R = 6 and 3;
   (e) ``or_tree_across_devices`` at world 1 on an encrypted 1 and an
   encrypted 0, each decrypting to itself; (f) ``dryrun_multichip(1)`` on
   phase 2's keys.  A JSON line ``{"mesh": ...}`` precedes the kernels
   line.
18. the spectral rotation (``spectral::ext_product`` of
   ``csrc/blind_rotate.cu``, which ``cuda-fused`` and ``cuda-bg`` run on
   the key spectrum of ``pbs_fft.SPECTRAL_PLAN`` that
   ``prepare_server_key`` makes, its seconds and bytes printed):
   bit-equal to the plain rotation, the ``cuda`` backend, the limb GEMM
   and the wrapper at B = 8, 16, 64, 256 and 1024; both paths timed at B
   = 8 ... 1024 beside the limb and FFT bounds of ``portbench/roofline.py``
   and the FFT bound of the kernel's plan (the crossover sweep); the
   cluster pair (``spectral::pair``, which ``pbs_cuda.spectral_cluster``
   chooses while 2 B <= the SM count) at B = 1, 8, 16, 32, 64, 66 and the
   one-block kernel at 67, each bit-equal to ``ext_product<1>`` on the
   same rows and to the plain rotation, the pair timed beside the
   one-block kernel at B = 8 ... 64 and counted as ``spectral_pair``; the
   clock64 phase split of a step at T = 1, T = 2 and on the pair (its
   exchange too) from a build with -DFHE_SPECTRAL_CLOCKS; a JSON line
   ``{"spectral": ...}``.

Before each main path every launch count is set to 0; just after, the
path's kernel must show launches (on the ``fft`` path: none).  Any failure
raises.  The line before
the last is a JSON object describing each kernel: its launches on its main
path, its largest difference from the plain version, its time and the
plain version's (and the library call's, where one computes the same
function) at one shape of the run (B = 256; #1, its row-block entry at
R = 6 and #2 per launch, from ``_graph_ms``), and the least time the card
could take
for that work (``bound_ms``: the int8 tensor-core operations of the limb
formulation at 1,979 TOP/s, or the bytes at 3.35 TB/s, whichever is
larger; the H100 SXM data sheet's peaks).  The last line is
``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import collections
import dataclasses
import gc
import json
import math
import re
import socket
import subprocess
import sys
import threading
import time
import urllib.request
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
HBM_BYTES_PER_S = 3.35e12      # H100 SXM device memory
INT8_OPS_PER_S = 1.979e15      # H100 SXM dense int8 tensor cores
FP64_FLOPS_PER_S = 3.4e13      # H100 SXM float64 outside the tensor cores
FP64_TC_FLOPS_PER_S = 6.7e13   # H100 SXM float64 tensor cores

# benchmarks/serving.py: 32 contents of 16 characters, the odd ones with a
# 'q' where the match needs its 'b'
SERVE_PATTERN = "/abc/"
SERVE = ["xxxxxabcxxxxxxxx" if i % 2 == 0 else "xxxxxaqcxxxxxxxx"
         for i in range(32)]

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


def _graph_ms(fn, reps: int = 20, samples: int = 3) -> list:
    """Device ms per call of fn, `samples` times: `reps` calls captured in
    one CUDA graph (the wrappers launch on the current stream, which is
    the capture stream), replayed between two CUDA events, the interval
    over reps.  One Python call between two events would time mostly the
    host's launch path (tens of microseconds), longer than these kernels.
    Warmed first on a side stream; the inputs stay in L2 from one call to
    the next, as the accumulators do between the steps of a rotation."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
        fn()
    torch.cuda.current_stream().wait_stream(side)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    graph.replay()
    times = []
    for _ in range(samples):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        graph.replay()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / reps)
    del graph
    torch.cuda.synchronize()
    return times


def _bound(ops: float, nbytes: float, ops_per_s: float = INT8_OPS_PER_S):
    """(least ms for the work, what sets it) at the card's peaks."""
    t_ops, t_bytes = ops / ops_per_s, nbytes / HBM_BYTES_PER_S
    return max(t_ops, t_bytes) * 1e3, ("operations" if t_ops >= t_bytes
                                       else "bytes")


def limb_pairs(params, drop=(0, 0)) -> float:
    """int8 limb products per multiply-add of the limb formulation: four
    key limbs at 32 bits; at 64 bits each (digit limb, key limb) pair of
    weight below 2^64, without the key limbs a drop zeroes, averaged over
    the mask and body columns."""
    from fhe_regex_tpu_torch.ops.pbs64 import n_digit_limbs

    if params.torus_bits == 32:
        return 4.0
    nd = n_digit_limbs(params.pbs_base_log)
    k = params.glwe_dimension
    per_c = [sum(1 for dl in range(nd)
                 for j in range(drop[0] if c < k else drop[1], 8)
                 if dl + j < 8) for c in range(k + 1)]
    return sum(per_c) / len(per_c)


def rotation_bound(params, B: int, L: int, drop=(0, 0)):
    """Bound of one blind rotation of B instances with L LUTs: n steps of
    B x rows x (k+1) x N^2 multiply-adds; the key, inputs and output each
    moved once."""
    k1, N = params.glwe_dimension + 1, params.polynomial_size
    n, rows = params.lwe_dimension, k1 * params.pbs_level
    word = params.torus_bits // 8
    macs = B * n * rows * k1 * N * N
    nbytes = (n * rows * k1 * N * word + B * (n + 2) * 4 + L * N * word
              + B * k1 * N * word)
    return _bound(2 * macs * limb_pairs(params, drop), nbytes)


def fft_rotation_bound(params, B: int, L: int, plan: tuple = None):
    """Bound of one FFT blind rotation of B instances with L LUTs on the
    limb plan ``plan`` (Lp limbs; default ``pbs_fft.PLAN``, the ``fft``
    backend's; the spectral rotation's is ``pbs_fft.SPECTRAL_PLAN``), in
    float64: per step (k+1)l B forward and (k+1) Lp B inverse complex FFTs
    of length M = N/2 (5 M log2 M flops each) at the FP64 rate outside the
    tensor cores, and the contraction, (k+1)l (k+1) Lp M B complex
    multiply-adds (8 flops each, a batched ZGEMM), at the FP64 tensor-core
    rate, n steps; or the spectral key (complex128), the inputs and the
    output each moved once, whichever takes longer."""
    from fhe_regex_tpu_torch.ops.pbs_fft import PLAN

    k1, N = params.glwe_dimension + 1, params.polynomial_size
    n, rows, M = params.lwe_dimension, k1 * params.pbs_level, N // 2
    Lp = len(plan or PLAN)
    t_fft = n * (rows + k1 * Lp) * B * 5 * M * math.log2(M) / FP64_FLOPS_PER_S
    t_mm = n * 8 * rows * k1 * Lp * M * B / FP64_TC_FLOPS_PER_S
    nbytes = (n * rows * k1 * Lp * M * 16 + B * (n + 2) * 4 + L * N * 4
              + B * k1 * N * 4)
    t_bytes = nbytes / HBM_BYTES_PER_S
    return max(t_fft + t_mm, t_bytes) * 1e3, ("operations"
                                              if t_fft + t_mm >= t_bytes
                                              else "bytes")


def digits3(port, pbs_cuda, small64):
    """Phase 5 at TEST_PARAMS_64 with the production digit (base 2^23, one
    level, so three int8 limbs per digit and two digit rows): #5 at B = 8
    and 37, #6 at B = 8 and 40 (one block, a ragged 32-row tile) on the
    key rounded by the drops (1, 2) and (2, 2), each bit-equal to the
    plain rotation on the same key.  Returns the largest errors of #5 and
    #6."""
    from fhe_regex_tpu_torch.ops.pbs64 import (blind_rotate64, round_bsk64,
                                               to_torch64)

    params = dataclasses.replace(small64, name="TEST_PARAMS_64_B23",
                                 pbs_base_log=23, pbs_level=1)
    ck, sk = port.gen_keys(params, seed=13)
    bsk = to_torch64(sk.bsk).to(DEVICE)
    e5 = [kernel_vs_plain("blind_rotate_fused64", params,
                          pbs_cuda.blind_rotate_fused64, blind_rotate64, bsk,
                          _rotation_inputs(params, ck, B, seed=B),
                          timed=False)[0] for B in (8, 37)]
    e6 = []
    for drop in ((1, 2), (2, 2)):
        rounded = to_torch64(round_bsk64(params, sk.bsk, drop)).to(DEVICE)
        for B in (8, 40):
            e6.append(kernel_vs_plain(
                f"blind_rotate_fused64_bg drop {drop}", params,
                lambda *a: pbs_cuda.blind_rotate_fused64_bg(*a, drop=drop),
                blind_rotate64, rounded,
                _rotation_inputs(params, ck, B, seed=B + 1), timed=False)[0])
    return max(e5), max(e6)


def _reset_counts(pbs_cuda) -> None:
    for k in pbs_cuda.KERNELS:
        k.launches = 0


def _engine() -> str:
    """The circuit compiler the entry points take by default here (the
    native one once ``native/libfheregex.so`` is built)."""
    from fhe_regex_tpu_torch.regex.native import default_engine

    return default_engine()


def main_path(port, pbs_cuda, params, ck, sk, kernel, requests,
              backend=None, warm=True, times=None):
    """The requests through ``has_match`` on the card, each decrypting to
    its expected bit, cold and (with ``warm``) warm; every launch count is
    0 just before.  Returns (launches of ``kernel`` in this run,
    {name: (ct, result)}); ``times`` gets {name: warm seconds}."""
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
        res2, warm_s = res, None
        if warm:
            res2, warm_s = _timed(lambda: port.has_match(
                sk, ct, pattern, fold="tree", device=DEVICE,
                backend=backend))
        got, got2 = port.decrypt(ck, res), port.decrypt(ck, res2)
        print(f"request {params.name} {name}: {len(content)} chars, "
              f"{circuit.pbs_count} bootstraps in {len(circuit.levels)} "
              f"levels (engine {_engine()}), cold {cold:.3f} s, warm "
              f"{'not run' if warm_s is None else f'{warm_s:.3f} s'}, "
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
        if times is not None:
            times[name] = warm_s
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
    return 256 / secs


def same_on_cpu(port, params, ck, sk):
    """One small request gives the same ciphertext on the card and the CPU."""
    ct = port.encrypt_str(ck, "Acdde")
    a = port.has_match(sk, ct, "/^a[b-d]{2,4}e$/i", fold="tree",
                       device=DEVICE)
    b = port.has_match(sk, ct, "/^a[b-d]{2,4}e$/i", fold="tree", device="cpu")
    if not np.array_equal(a, b) or port.decrypt(ck, a) != 1:
        raise AssertionError(f"{params.name}: card and CPU results differ")


def _digit_inputs(params, B: int, seed: int):
    """A digit pass's inputs on the card: acc [B, k+1, N] of random torus
    words with the edge words (0, 1, 2^(w-1) - 1, 2^(w-1), 2^(w-1) + 1,
    2^w - 1) planted at both ends, and rotations a [B], the edge values 0,
    1, 15, 16, 17, N-16, N-1, N, N+1, 2N-16, 2N-1 first."""
    k1, N, w = (params.glwe_dimension + 1, params.polynomial_size,
                params.torus_bits)
    rng = np.random.default_rng(seed)
    acc = rng.integers(0, 1 << w, size=(B, k1, N), dtype=np.uint64)
    words = np.array([0, 1, (1 << (w - 1)) - 1, 1 << (w - 1),
                      (1 << (w - 1)) + 1, (1 << w) - 1], np.uint64)
    acc[:, 0, :6] = words
    acc[:, -1, -6:] = words
    edges = [0, 1, 15, 16, 17, N - 16, N - 1, N, N + 1, 2 * N - 16,
             2 * N - 1]
    a = np.array(edges + list(rng.integers(0, 2 * N, size=B)))[:B]
    acc = acc.astype(np.uint32) if w == 32 else acc
    return _bits(acc), torch.from_numpy(a.astype(np.int32)).to(DEVICE)


def digit_bytes(params, B: int) -> int:
    """Bytes a digit pass must move: acc read once, a read once, the int8
    digit (limb) planes written once."""
    from fhe_regex_tpu_torch.ops.pbs64 import n_digit_limbs

    k1, N = params.glwe_dimension + 1, params.polynomial_size
    word = params.torus_bits // 8
    nd = n_digit_limbs(params.pbs_base_log) if word == 8 else 1
    return B * k1 * N * word + B * 4 + B * k1 * params.pbs_level * nd * N


def digit_pass(label, kernel, plain_fn, sets, widths, timed, seed):
    """One digit pass (``stage1_digits`` or ``stage1_digits64``) against its
    plain version on the same card inputs, tolerance zero, for each set
    and B in `widths`; then, at the last set and each B of `timed`, both
    timed per launch (``_graph_ms``) beside the byte bound.  Returns
    (largest difference, {B: numbers})."""
    err = 0
    for params in sets:
        for B in widths:
            acc, a = _digit_inputs(params, B, seed + B)
            got, want = kernel(params, acc, a), plain_fn(params, acc, a)
            diff = int((got.to(torch.int32) - want.to(torch.int32)).abs()
                       .max())
            err = max(err, diff)
            if got.shape != want.shape or not torch.equal(got, want):
                raise AssertionError(f"{label} {params.name} B={B}: kernel "
                                     f"!= plain (max |diff| {diff})")
        print(f"{label} {params.name}: equal to plain at B={widths}, edge "
              f"rotations planted", flush=True)
    out = {}
    for B in timed:
        acc, a = _digit_inputs(params, B, seed + B)
        t = dict(ms=_graph_ms(lambda: kernel(params, acc, a)),
                 plain=_graph_ms(lambda: plain_fn(params, acc, a), reps=3))
        bound = _bound(0, digit_bytes(params, B))
        print(f"{label} {params.name} B={B}: device ms per launch (CUDA "
              f"graph) {_fmt(t['ms'])}, plain {_fmt(t['plain'])}; bound "
              f"{bound[0]:.5f} ({bound[1]})", flush=True)
        out[B] = {k: float(np.median(v)) for k, v in t.items()}
        out[B]["bound"] = bound
    return err, out


def step_kernels(params, bsk, pbs_cuda, plain):
    """Phase 8, external product: one launch of #1
    (``external_product_step``) against the plain version on the same card
    inputs, tolerance zero, at B = 8, 37 (a ragged batch tile) and 256,
    timed per launch at 8 and 256 (``_graph_ms``) beside the plain version
    and one float64 ``torch.matmul`` with the Toeplitz matrix prebuilt.
    Returns {B: numbers}."""
    k1, N = params.glwe_dimension + 1, params.polynomial_size
    rows = k1 * params.pbs_level
    out, errs = {}, []
    for B in (8, 37, 256):
        acc, a = _digit_inputs(params, B, 300 + B)
        d = pbs_cuda.stage1_digits(params, acc, a)
        before = acc.clone()
        got = pbs_cuda.external_product_step(params, d, bsk[0], acc)
        want = plain.external_product_step(params, d, bsk[0], acc)
        ep_err = _max_abs_err(got, want)
        errs.append(ep_err)
        if not torch.equal(got, want) or not torch.equal(acc, before):
            raise AssertionError(f"external_product_step B={B}: kernel != "
                                 f"plain (max |diff| {ep_err}) or acc "
                                 f"changed")
        W = plain._ext_product_matrix(bsk[0])
        df = d.reshape(B, rows * N).to(torch.float64)
        lib = plain.wrap_i32(acc.to(torch.int64) + torch.matmul(df, W)
                             .to(torch.int64).reshape(B, k1, N))
        if not torch.equal(lib, want):
            raise AssertionError("the float64 matmul does not compute #1")
        if B == 37:
            print(f"external_product_step {params.name} B={B}: equal plain",
                  flush=True)
            continue
        t = dict(
            ep=_graph_ms(lambda: pbs_cuda.external_product_step(
                params, d, bsk[0], acc)),
            ep_plain=_graph_ms(lambda: plain.external_product_step(
                params, d, bsk[0], acc), reps=3),
            ep_lib=_graph_ms(lambda: torch.matmul(df, W), reps=3))
        print(f"external_product_step {params.name} B={B}: equal plain; "
              f"device ms per launch (CUDA graph) {_fmt(t['ep'])}, plain "
              f"{_fmt(t['ep_plain'])}, float64 matmul {_fmt(t['ep_lib'])}",
              flush=True)
        out[B] = {k: float(np.median(v)) for k, v in t.items()}
    return max(errs), out


def _fmt(ms) -> str:
    return " / ".join(f"{t:.4f}" for t in ms)


def steps_vs_fused(params, ck, bsk, pbs_cuda):
    """Phase 8, second half: the whole ``cuda`` rotation (2n launches from
    Python) equals ``cuda-fused`` bit for bit.  Returns {B: seconds}."""
    out = {}
    for B in (8, 256):
        x = _rotation_inputs(params, ck, B, seed=400 + B)
        args = (params, bsk, x["luts"], x["lut_idx"], x["ms"])
        got, steps_s = _timed(lambda: pbs_cuda.blind_rotate_steps(*args))
        want, fused_s = _timed(lambda: pbs_cuda.blind_rotate_fused(*args))
        if not torch.equal(got, want):
            raise AssertionError(f"blind_rotate_steps B={B} != "
                                 f"blind_rotate_fused")
        print(f"blind_rotate_steps {params.name} B={B}: equal to "
              f"cuda-fused; {steps_s * 1e3:.3f} ms (cuda-fused "
              f"{fused_s * 1e3:.3f} ms)", flush=True)
        out[B] = steps_s
    return out


def batch_grid(params, ck, bsk, pbs_cuda, blind_rotate):
    """Phase 9: #4 in one block and in two at B = 256, equal to
    ``cuda-fused``; at B = 1024 and the default tb, bit-equal to the plain
    rotation, timed beside ``cuda-fused``.  Returns the B = 1024 numbers."""
    bg = pbs_cuda.blind_rotate_fused_bg
    x = _rotation_inputs(params, ck, 256, seed=456)
    args = (params, bsk, x["luts"], x["lut_idx"], x["ms"])
    one, one_s = _timed(lambda: bg(*args, tb=256))
    two, two_s = _timed(lambda: bg(*args, tb=128))
    fused = pbs_cuda.blind_rotate_fused(*args)
    if not (torch.equal(one, two) and torch.equal(one, fused)):
        raise AssertionError("blind_rotate_fused_bg B=256: tb=256, tb=128 "
                             "and cuda-fused differ")
    print(f"blind_rotate_fused_bg B=256: tb=256 {one_s * 1e3:.3f} ms, "
          f"tb=128 {two_s * 1e3:.3f} ms, equal to cuda-fused", flush=True)
    B = 1024
    x = _rotation_inputs(params, ck, B, seed=1024)
    args = (params, bsk, x["luts"], x["lut_idx"], x["ms"])
    got, bg_s = _timed(lambda: bg(*args))
    fused, fused_s = _timed(lambda: pbs_cuda.blind_rotate_fused(*args))
    want, plain_s = _timed(lambda: blind_rotate(*args))
    err = _max_abs_err(got, want)
    if not (torch.equal(got, want) and torch.equal(fused, want)):
        raise AssertionError(f"blind_rotate_fused_bg B={B}: kernel != plain "
                             f"(max |diff| {err})")
    tb = pbs_cuda._bg_block(B, pbs_cuda.BG_CAP)
    print(f"blind_rotate_fused_bg {params.name} B={B} tb={tb}: equal to "
          f"plain; {bg_s * 1e3:.3f} ms (cuda-fused {fused_s * 1e3:.3f} ms, "
          f"plain {plain_s * 1e3:.3f} ms)", flush=True)
    return dict(err=err, B=B, L=x["luts"].shape[0], ms=bg_s * 1e3,
                plain_ms=plain_s * 1e3, fused_ms=fused_s * 1e3)


def _want_bits(got, want, what):
    if got != want:
        raise AssertionError(f"{what}: decrypted {got}, want {want}")


def _serve_plan(port, params, sk, C):
    """The circuit ``has_match_many`` compiles for the serving
    configuration (the packed paths' auto rule), which must be the
    multi-value plan, and the rotation rows its C-content run launches."""
    from fhe_regex_tpu_torch.regex.engine import compile_match

    circuit = port._compile_auto_mv(params, *compile_match(
        len(SERVE[0]), SERVE_PATTERN, fold="tree"), None)
    if not (circuit.multivalue
            and circuit.rotation_count < circuit.pbs_count):
        raise AssertionError(f"has_match_many {params.name}: the default "
                             f"plan is not multi-value ({circuit.pbs_count} "
                             f"bootstraps, {circuit.rotation_count} "
                             f"rotations)")
    plan = port.executor_for(sk, device=DEVICE)._device_chunks_many_mv(
        circuit, C, True)
    return circuit, sum(ch[0].shape[0] for rot, _ in plan for ch in rot)


def mv_request(port, pbs_cuda, params, ck, sk, backend, plain_backend,
               kernel, also=None):
    """One multi-value ``has_match`` request (``case_insensitive_classes``)
    on a kernel backend, bit-equal to the plain backend on the card, with
    the kernel's launches; ``also``: one more kernel backend,
    decrypt-checked."""
    name, pattern, content, bit = REQUESTS[2]
    ct = port.encrypt_str(ck, content)
    _reset_counts(pbs_cuda)
    got, secs = _timed(lambda: port.has_match(
        sk, ct, pattern, fold="tree", device=DEVICE, backend=backend,
        multivalue=True))
    launches = kernel.launches
    want = port.has_match(sk, ct, pattern, fold="tree", device=DEVICE,
                          backend=plain_backend, multivalue=True)
    _want_bits(port.decrypt(ck, got), bit, f"{name} multivalue")
    if not np.array_equal(got, want) or launches <= 0:
        raise AssertionError(f"{name} multivalue {params.name}: {backend} "
                             f"!= {plain_backend}, or {kernel.__name__} "
                             f"launches {launches}")
    extra = ""
    if also is not None:
        r = port.has_match(sk, ct, pattern, fold="tree", device=DEVICE,
                           backend=also, multivalue=True)
        _want_bits(port.decrypt(ck, r), bit, f"{name} multivalue {also}")
        extra = f"; on {also} right"
    print(f"multi-value request {params.name} {name} on {backend}: "
          f"{secs:.3f} s, equal to {plain_backend}, {kernel.__name__} "
          f"launches {launches}{extra}", flush=True)


def serving(port, pbs_cuda, params, ck, sk, literal):
    """Phase 10: the packed serving paths at the 32-bit production set;
    ``literal`` is (name, pattern, content, bit, ciphertext, cuda-fused
    result) of one request of phase 3.  Returns the launches of #4, #2 and
    #1 on their main paths, the classic-plan run on ``cuda-fused``
    (contents, results, seconds) and the warm multi-value run on
    ``cuda-bg`` (results, seconds)."""
    C = len(SERVE)
    cts = np.stack([port.encrypt_str(ck, c) for c in SERVE])
    want = [1 - i % 2 for i in range(C)]
    circuit, rot_rows = _serve_plan(port, params, sk, C)
    _reset_counts(pbs_cuda)
    res, cold = _timed(lambda: port.has_match_many(
        sk, cts, SERVE_PATTERN, backend="cuda-bg", device=DEVICE))
    bg_launches = pbs_cuda.blind_rotate_fused_bg.launches
    res2, warm = _timed(lambda: port.has_match_many(
        sk, cts, SERVE_PATTERN, backend="cuda-bg", device=DEVICE))
    res3, fused_s = _timed(lambda: port.has_match_many(
        sk, cts, SERVE_PATTERN, backend="cuda-fused", device=DEVICE))
    for r in (res, res2, res3):
        _want_bits([port.decrypt(ck, x) for x in r], want, "has_match_many")
    if not (np.array_equal(res, res2) and np.array_equal(res, res3)):
        raise AssertionError("has_match_many: cuda-bg and cuda-fused "
                             "ciphertexts differ")
    if bg_launches <= 0:
        raise AssertionError("has_match_many: blind_rotate_fused_bg was not "
                             "launched")
    res4, classic_s = _timed(lambda: port.has_match_many(
        sk, cts, SERVE_PATTERN, backend="cuda-fused", device=DEVICE,
        multivalue=False))
    _want_bits([port.decrypt(ck, x) for x in res4], want,
               "has_match_many classic")
    print(f"serving {params.name}: has_match_many C={C} x "
          f"{len(SERVE[0])} chars {SERVE_PATTERN}, multi-value plan "
          f"({circuit.pbs_count} bootstraps, {circuit.rotation_count} "
          f"rotations per content; {rot_rows} rotation rows): cuda-bg cold "
          f"{cold:.3f} s, warm {warm:.3f} s ({C / warm:.2f} contents/s), "
          f"cuda-fused {fused_s:.3f} s ({C / fused_s:.2f} contents/s); "
          f"blind_rotate_fused_bg launches {bg_launches}; all {C} bits "
          f"right, ciphertexts equal; classic plan on cuda-fused "
          f"{classic_s:.3f} s ({C / classic_s:.2f} contents/s), right",
          flush=True)
    mv_request(port, pbs_cuda, params, ck, sk, "cuda-fused", "torch",
               pbs_cuda.blind_rotate_fused, also="cuda-bg")

    four = cts[:4]
    pats = ["/abc/", "/aqc/", "/^x{5}a/"]
    r, secs = _timed(lambda: port.has_match_many_patterns(
        sk, four, pats, device=DEVICE))
    _want_bits([[port.decrypt(ck, x) for x in row] for row in r],
               [[1, 0, 1], [0, 1, 1], [1, 0, 1], [0, 1, 1]],
               "has_match_many_patterns")
    print(f"has_match_many_patterns C=4 x {pats}: {secs:.3f} s, right",
          flush=True)
    r, secs = _timed(lambda: port.has_match_many_positions(
        sk, four, SERVE_PATTERN, device=DEVICE))
    _want_bits([[port.decrypt(ck, x) for x in row] for row in r],
               [[int(j == 5 and i % 2 == 0) for j in range(16)]
                for i in range(4)], "has_match_many_positions")
    print(f"has_match_many_positions C=4: {secs:.3f} s, right", flush=True)
    long_ct = port.encrypt_str(ck, "x" * 200 + "abc" + "x" * 53)
    r, secs = _timed(lambda: port.has_match_long(
        sk, long_ct, SERVE_PATTERN, device=DEVICE))
    _want_bits(port.decrypt(ck, r), 1, "has_match_long")
    print(f"has_match_long 256 chars (5 windows of 64): {secs:.3f} s, "
          f"right", flush=True)
    ct = port.encrypt_str(ck, "xxabcxxabcxxxabc")
    r, secs = _timed(lambda: port.count_matches(sk, ct, SERVE_PATTERN,
                                                device=DEVICE))
    _want_bits(port.decrypt_count(ck, r), 3, "count_matches")
    print(f"count_matches 16 chars: {secs:.3f} s, count 3 right", flush=True)

    # kernels #2 and #1's path: one request through the per-step backend
    name, pattern, _, bit, ct, fused = literal
    _reset_counts(pbs_cuda)
    r, secs = _timed(lambda: port.has_match(sk, ct, pattern, fold="tree",
                                            device=DEVICE, backend="cuda"))
    s1 = pbs_cuda.stage1_digits.launches
    ep = pbs_cuda.external_product_step.launches
    _want_bits(port.decrypt(ck, r), bit, name)
    if not np.array_equal(r, fused):
        raise AssertionError(f"{name}: cuda and cuda-fused results differ")
    if s1 <= 0 or ep <= 0:
        raise AssertionError(f"{name}: the per-step kernels were not "
                             f"launched ({s1}, {ep})")
    print(f"request {params.name} {name} on cuda: {secs:.3f} s, equal to "
          f"cuda-fused; stage1_digits launches {s1}, external_product_step "
          f"launches {ep}", flush=True)
    return bg_launches, s1, ep, (cts, res4, classic_s), (res2, warm)


def serving64(port, pbs_cuda, params, ck, sk):
    """Phase 11: has_match_many at the 64-bit production set on the default
    backend (``cuda64-bg``, the multi-value plan), 8 contents,
    decrypt-checked; one multi-value request on ``cuda64`` against
    ``torch64`` and on ``cuda64-bg``."""
    C = 8
    cts = np.stack([port.encrypt_str(ck, c) for c in SERVE[:C]])
    circuit, _ = _serve_plan(port, params, sk, C)
    _reset_counts(pbs_cuda)
    res, secs = _timed(lambda: port.has_match_many(sk, cts, SERVE_PATTERN,
                                                   device=DEVICE))
    launches = pbs_cuda.blind_rotate_fused64_bg.launches
    _want_bits([port.decrypt(ck, x) for x in res],
               [1 - i % 2 for i in range(C)], "has_match_many 64-bit")
    if res.dtype != np.uint64 or launches <= 0:
        raise AssertionError(f"has_match_many 64-bit: dtype {res.dtype}, "
                             f"blind_rotate_fused64_bg launches {launches}")
    print(f"serving {params.name}: has_match_many C={C} on cuda64-bg, "
          f"multi-value plan ({circuit.rotation_count} rotations for "
          f"{circuit.pbs_count} bootstraps per content): {secs:.3f} s "
          f"({C / secs:.2f} contents/s), blind_rotate_fused64_bg launches "
          f"{launches}, right", flush=True)
    mv_request(port, pbs_cuda, params, ck, sk, "cuda64", "torch64",
               pbs_cuda.blind_rotate_fused64, also="cuda64-bg")


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _http(url, path, obj=None):
    """(reply, seconds) of one GET (``obj`` None) or JSON POST to a daemon
    on this host."""
    data = None if obj is None else json.dumps(obj).encode()
    req = urllib.request.Request(url + path, data,
                                 {"Content-Type": "application/json"})
    t0 = time.perf_counter()
    with urllib.request.urlopen(req, timeout=600) as r:
        out = json.loads(r.read())
    return out, time.perf_counter() - t0


def _serve_request(port, url, ck, sk, request, kernel=None):
    """One request of REQUESTS through the daemon's /match (fold "tree",
    the client's encryption), decrypt-checked and bit-equal to in-process
    ``has_match`` on the plan the daemon compiled (/compile: fewer
    rotations than bootstraps is the multi-value plan).  Returns (HTTP
    seconds, in-process seconds, multi-value, launches of ``kernel`` by
    the /match of a daemon in this process)."""
    from fhe_regex_tpu_torch.serve import decode_array, encode_array

    name, pattern, content, want = request
    ct = port.encrypt_str(ck, content)
    stats, _ = _http(url, "/compile", {"pattern": pattern,
                                       "content_len": len(content)})
    mv = stats["rotations"] < stats["bootstraps"]
    before = kernel.launches if kernel is not None else 0
    out, http_s = _http(url, "/match", {"pattern": pattern, "fold": "tree",
                                        "ct": encode_array(ct)})
    launches = kernel.launches - before if kernel is not None else None
    got = decode_array(out["ct"])
    ref, local_s = _timed(lambda: port.has_match(
        sk, ct, pattern, fold="tree", device=DEVICE, multivalue=mv))
    _want_bits(port.decrypt(ck, got), want, f"daemon /match {name}")
    if got.dtype != ref.dtype or not np.array_equal(got, ref):
        raise AssertionError(f"daemon /match {name}: ciphertext differs "
                             f"from in-process has_match")
    return http_s, local_s, mv, launches


def daemon(port, params, ck, sk):
    """Phase 12: ``python -m fhe_regex_tpu_torch.serve`` as its own process
    on the 32-bit production key (bsk and ksk of the key cache; the client
    key stays here), warmed with the five DRIVER_CONFIGS, north_star_hit
    and the serving configuration at "many": 32.  Every answer is
    decrypt-checked and the /match ciphertexts are bit-equal to in-process
    ``has_match``, /match_many's to ``has_match_many``."""
    from fhe_regex_tpu_torch.models.patterns import DRIVER_CONFIGS
    from fhe_regex_tpu_torch.ops.pbs import resolve_backend
    from fhe_regex_tpu_torch.serve import decode_array, encode_array

    manifest = ([{"pattern": c["pattern"], "content_len": c["content_len"]}
                 for c in DRIVER_CONFIGS]
                + [{"pattern": REQUESTS[5][1],
                    "content_len": len(REQUESTS[5][2])},
                   {"pattern": SERVE_PATTERN, "content_len": len(SERVE[0]),
                    "many": len(SERVE)}])
    man_path = CACHE / "serve_manifest.json"
    man_path.write_text(json.dumps(manifest))
    log_path = CACHE / "serve_daemon.log"
    port_no = _free_port()
    url = f"http://127.0.0.1:{port_no}"
    t0 = time.perf_counter()
    with open(log_path, "w") as log:
        proc = subprocess.Popen(
            [sys.executable, "-m", "fhe_regex_tpu_torch.serve", "--params",
             params.name, "--key",
             str(CACHE / f"torch_smoke_keys_{params.name}.npz"), "--device",
             DEVICE, "--port", str(port_no), "--warmup", str(man_path)],
            cwd=ROOT, stdout=log, stderr=subprocess.STDOUT)
    try:
        while True:
            if proc.poll() is not None:
                raise AssertionError(f"daemon exited ({proc.returncode}) "
                                     f"before serving")
            try:
                health, _ = _http(url, "/health")
                break
            except OSError:
                if time.perf_counter() - t0 > 600:
                    raise AssertionError("daemon not up after 600 s")
                time.sleep(0.5)
        up_s = time.perf_counter() - t0
        want_backend = resolve_backend(None, DEVICE, params)
        if health != {"status": "ok", "params": params.name,
                      "backend": want_backend}:
            raise AssertionError(f"daemon /health {health}")
        warm = [ln.split("INFO:fhe_regex_tpu_torch.serve:")[-1] for ln in
                log_path.read_text().splitlines() if "warm" in ln]
        print(f"daemon {params.name}: up in {up_s:.3f} s (process start, "
              f"key load, warmup of {len(manifest)} shapes), /health "
              f"backend {health['backend']}, engine {_engine()}; "
              f"{'; '.join(warm)}", flush=True)

        # the daemon's own launch counts (/stats), read just before and
        # just after each part of its run: the 32-bit default is #3
        def launched(before, what):
            now = _http(url, "/stats")[0]["kernel_launches"]
            diff = {k: now[k] - before[k] for k in now if now[k] > before[k]}
            if diff.get("blind_rotate_fused", 0) <= 0:
                raise AssertionError(f"daemon {what}: blind_rotate_fused was "
                                     f"not launched (launches {diff})")
            print(f"daemon {what}: launches {diff}", flush=True)
            return now

        counts0 = _http(url, "/stats")[0]["kernel_launches"]
        for request in REQUESTS:
            http_s, local_s, mv, _ = _serve_request(port, url, ck, sk,
                                                    request)
            print(f"daemon /match {request[0]}: {http_s:.4f} s over HTTP, "
                  f"in-process has_match {local_s:.4f} s "
                  f"({'multi-value' if mv else 'classic'} plan), equal "
                  f"ciphertexts, right", flush=True)
        counts0 = launched(counts0, f"/match x {len(REQUESTS)}")

        C = len(SERVE)
        cts = np.stack([port.encrypt_str(ck, c) for c in SERVE])
        req = {"pattern": SERVE_PATTERN, "ct": encode_array(cts)}
        body_mb = len(json.dumps(req)) / 1e6
        many_s = []
        for _ in range(3):
            out, secs = _http(url, "/match_many", req)
            many_s.append(secs)
            got = decode_array(out["ct"])
            _want_bits([port.decrypt(ck, x) for x in got],
                       [1 - i % 2 for i in range(C)], "daemon /match_many")
        counts0 = launched(counts0, "/match_many x 3")
        local = [_timed(lambda: port.has_match_many(sk, cts, SERVE_PATTERN,
                                                    device=DEVICE))
                 for _ in range(2)]
        if not np.array_equal(got, local[-1][0]):
            raise AssertionError("daemon /match_many: ciphertexts differ "
                                 "from in-process has_match_many")
        warm_s = float(np.median(many_s[1:]))
        print(f"daemon /match_many C={C} x {len(SERVE[0])} chars "
              f"{SERVE_PATTERN}: request {body_mb:.2f} MB of JSON; "
              f"{', '.join(f'{s:.4f}' for s in many_s)} s over HTTP, warm "
              f"{C / warm_s:.2f} contents/s; in-process has_match_many "
              f"{', '.join(f'{s:.4f}' for _, s in local)} s "
              f"({C / local[-1][1]:.2f} contents/s); equal ciphertexts, all "
              f"{C} bits right", flush=True)

        checks = [
            ("/match", {"patterns": ["/abc/", "/aqc/", "/^x{5}a/"],
                        "ct": encode_array(cts[0])}, [1, 0, 1]),
            ("/match", {"pattern": SERVE_PATTERN, "positions": True,
                        "ct": encode_array(cts[0])},
             [int(j == 5) for j in range(16)]),
            ("/count", {"pattern": SERVE_PATTERN, "ct": encode_array(
                port.encrypt_str(ck, "xxabcxxabcxxxabc"))}, 3),
            ("/match_long", {"pattern": SERVE_PATTERN, "ct": encode_array(
                port.encrypt_str(ck, "x" * 200 + "abc" + "x" * 53))}, 1)]
        for path, body, want in checks:
            out, secs = _http(url, path, body)
            got = decode_array(out["ct"])
            bits = (port.decrypt_count(ck, got) if path == "/count"
                    else port.decrypt(ck, got) if got.ndim == 2
                    else [port.decrypt(ck, x) for x in got])
            _want_bits(bits, want, f"daemon {path} {sorted(body)}")
            print(f"daemon {path} ({', '.join(k for k in body if k != 'ct')})"
                  f": {secs:.4f} s, right", flush=True)

        again = _serve_request(port, url, ck, sk, REQUESTS[0])[0]
        stats, _ = _http(url, "/stats")
        counts = {k: v["count"] for k, v in stats["requests"].items()}
        want_counts = {"/compile": 7, "/match": 9, "/match_many": 3,
                       "/count": 1, "/match_long": 1}
        ema = stats["launch_ema_s"]
        # /match runs the per-level loop (no graph by default on
        # cuda-fused), /match_many the packed plan
        if counts != want_counts or not (
                any(k.startswith("('levels'") for k in ema)
                and any(k.startswith("('many'") for k in ema)):
            raise AssertionError(f"daemon /stats: requests {counts} (want "
                                 f"{want_counts}), launch_ema_s {ema}")
        print(f"daemon /stats: requests {counts}; launch_ema_s {ema}; "
              f"{REQUESTS[0][0]} again {again:.4f} s", flush=True)
        if proc.poll() is not None:
            raise AssertionError(f"daemon died ({proc.returncode})")
    except BaseException:
        sys.stderr.write(log_path.read_text()[-4000:])
        raise
    finally:
        proc.terminate()
        try:
            proc.wait(timeout=30)
        except subprocess.TimeoutExpired:
            proc.kill()
            proc.wait(timeout=30)


def checkpoint_resume(port, params, ck, sk):
    """Phase 13: the serving configuration's run_many (multi-value plan,
    default backend) checkpointed every step and killed in step 4 (its
    rotate core raises), resumed; ``run`` on quantifiers checkpointed every
    2 levels and killed in level 6, resumed; both bit-equal to an
    uninterrupted run.  A resume of another circuit must be refused by its
    fingerprint.  Prints one save's seconds beside one launch step's."""
    from fhe_regex_tpu_torch.regex.engine import compile_match
    from fhe_regex_tpu_torch.regex.executor import (circuit_fingerprint,
                                                    compile_circuit)
    from fhe_regex_tpu_torch.utils import checkpoint as ckpt

    ex = port.executor_for(sk, device=DEVICE)
    wide = ex.device.type == "cuda"          # run_many's default
    C = len(SERVE)
    cts = np.stack([port.encrypt_str(ck, c) for c in SERVE])
    circuit, _ = _serve_plan(port, params, sk, C)
    steps = ex._device_chunks_many_mv(circuit, C, wide)
    whole, whole_s = _timed(lambda: ex.run_many(circuit, cts))
    path = CACHE / "ckpt_many.npz"
    path.unlink(missing_ok=True)

    def kill_after(attr, n):
        """ex.<attr> raises RuntimeError("killed") from its (n+1)-th call
        on; returns the undo."""
        own, real, calls = attr in vars(ex), getattr(ex, attr), [0]

        def dying(*a, **kw):
            if calls[0] >= n:
                raise RuntimeError("killed")
            calls[0] += 1
            return real(*a, **kw)
        setattr(ex, attr, dying)
        return ((lambda: setattr(ex, attr, real)) if own
                else (lambda: delattr(ex, attr)))

    undo = kill_after("_mv_rotate", sum(len(steps[i][0]) for i in range(3)))
    try:
        ex.run_many(circuit, cts, checkpoint=str(path), checkpoint_every=1)
        raise AssertionError("run_many was not killed")
    except RuntimeError as e:
        if str(e) != "killed":
            raise
    finally:
        undo()
    words, step, ck_C, total = ckpt.load_many_slab(path)
    if (step, ck_C, total) != (3, C, len(steps)):
        raise AssertionError(f"run_many checkpoint at step {step} of {total}"
                             f" (C={ck_C})")
    resumed, resume_s = _timed(lambda: ex.run_many(circuit, cts,
                                                   resume=str(path)))
    if not np.array_equal(resumed, whole):
        raise AssertionError("run_many resumed != uninterrupted")
    # one save of this slab, timed from the device tensor as run_many
    # saves it, and the other npz format of the same words
    slab = ex._restore(words, C * circuit.num_slots)
    fp = circuit_fingerprint(circuit, C, wide, len(steps))
    _, save_s = _timed(lambda: ckpt.save_many_slab(
        CACHE / "ckpt_save.npz", slab.cpu().numpy(), 3, C, total,
        fingerprint=fp))
    t0 = time.perf_counter()
    np.savez(CACHE / "ckpt_plain.npz", slab=words)
    plain_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    np.savez_compressed(CACHE / "ckpt_zip.npz", slab=words)
    zip_s = time.perf_counter() - t0
    other = port._compile_auto_mv(params, *compile_match(
        len(SERVE[0]), "/abd/", fold="tree"), None)
    if len(ex._device_chunks_many_mv(other, C, wide)) != len(steps):
        raise AssertionError("/abd/ has another step count than /abc/")
    try:
        ex.run_many(other, cts, resume=str(path))
        raise AssertionError("run_many resumed another circuit")
    except ValueError as e:
        if "fingerprint" not in str(e):
            raise
    print(f"checkpoint run_many C={C} (multi-value plan, {len(steps)} "
          f"steps): killed in step 4, resumed from step {step}: equal to "
          f"the uninterrupted run ({whole_s:.3f} s, {whole_s / len(steps):.3f}"
          f" s a step; resume {resume_s:.3f} s); one save "
          f"{save_s:.3f} s (save_many_slab from the device tensor, "
          f"{words.nbytes / 1e6:.1f} MB slab; of its words np.savez "
          f"{plain_s:.3f} s, np.savez_compressed, the JAX module's format, "
          f"{zip_s:.3f} s); /abd/ "
          f"({len(steps)} steps) refused by its fingerprint", flush=True)

    name, pattern, content, want = REQUESTS[3]
    ct = port.encrypt_str(ck, content)
    circuit = compile_circuit(params, *compile_match(len(content), pattern,
                                                     fold="tree"))
    whole, whole_s = _timed(lambda: ex.run(circuit, ct))
    path = CACHE / "ckpt_run.npz"
    path.unlink(missing_ok=True)
    undo = kill_after("_run_level", 5)
    try:
        ex.run(circuit, ct, checkpoint=str(path), checkpoint_every=2)
        raise AssertionError("run was not killed")
    except RuntimeError as e:
        if str(e) != "killed":
            raise
    finally:
        undo()
    level = ckpt.load_slab(path)[1]
    resumed, resume_s = _timed(lambda: ex.run(circuit, None,
                                              resume=str(path)))
    _want_bits(port.decrypt(ck, resumed), want, f"{name} resumed")
    if level != 4 or not np.array_equal(resumed, whole):
        raise AssertionError(f"{name}: resumed from level {level} != "
                             f"uninterrupted")
    other = compile_circuit(params, *compile_match(len(content),
                                                   "/^ab{2,4}c+e*$/",
                                                   fold="tree"))
    try:
        ex.run(other, None, resume=str(path))
        raise AssertionError("run resumed another circuit")
    except ValueError as e:
        if "fingerprint" not in str(e):
            raise
    print(f"checkpoint run {name} ({len(circuit.levels)} levels, every 2): "
          f"killed in level 6, resumed from level {level}: equal to the "
          f"uninterrupted run ({whole_s:.3f} s; resume {resume_s:.3f} s), "
          f"right; another circuit refused by its fingerprint", flush=True)


def _event_ms(fn):
    """(result, device ms) of one call of fn between two CUDA events."""
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    out = fn()
    end.record()
    end.synchronize()
    return out, start.elapsed_time(end)


def fft_backend(port, pbs_cuda, params, ck, sk, dk, results, classic):
    """Phase 14: the FFT backend at the 32-bit production set.  ``dk`` is
    the ``cuda-fused`` key, ``results`` phase 3's {name: (ct, result)},
    ``classic`` phase 10's classic-plan run (contents, results, seconds).
    Returns the numbers of the ``{"fft": ...}`` line."""
    from fhe_regex_tpu_torch.ops.pbs_fft import (blind_rotate_fft,
                                                 prepare_bsk_fft)
    from fhe_regex_tpu_torch.regex.engine import compile_match

    spec, prep_s = _timed(lambda: prepare_bsk_fft(params, sk.bsk, DEVICE))
    if spec.device.type != torch.device(DEVICE).type:
        raise AssertionError(f"spectral key on {spec.device}")
    prep = {"s": prep_s, "bytes": spec.numel() * 16}
    print(f"fft key {params.name}: {prep_s:.3f} s (upload, limbs and "
          f"torch.fft on the card), {spec.numel() * 16 / 1e6:.1f} MB",
          flush=True)
    rotations = []
    _reset_counts(pbs_cuda)
    for B in (8, 256):
        x = _rotation_inputs(params, ck, B, seed=900 + B)
        args = (x["luts"], x["lut_idx"], x["ms"])
        want = pbs_cuda.blind_rotate_fused(params, dk.bsk, *args)    # warm
        fused_ms = [_event_ms(lambda: pbs_cuda.blind_rotate_fused(
            params, dk.bsk, *args))[1] for _ in range(3)]
        got, cold_s = _timed(lambda: blind_rotate_fft(params, spec, *args))
        outs, ms = [got], []
        for _ in range(3):
            out, t = _event_ms(lambda: blind_rotate_fft(params, spec, *args))
            outs.append(out)
            ms.append(t)
        err = max(_max_abs_err(o, want) for o in outs)
        if not all(torch.equal(o, want) for o in outs):
            raise AssertionError(f"blind_rotate_fft B={B} != cuda-fused "
                                 f"(max |diff| {err})")
        bound = fft_rotation_bound(params, B, x["luts"].shape[0])
        rotations.append({"B": B, "ms": ms, "median_ms": float(np.median(ms)),
                          "cold_ms": cold_s * 1e3, "bound_ms": bound[0],
                          "bound_by": bound[1], "cuda_fused_ms": fused_ms,
                          "max_abs_err": err})
        print(f"blind_rotate_fft {params.name} B={B}: equal to cuda-fused "
              f"(cold and 3 warm); warm ms {_fmt(ms)} (cuda-fused "
              f"{_fmt(fused_ms)}); cold {cold_s * 1e3:.1f} ms; bound "
              f"{bound[0]:.3f} ms ({bound[1]})", flush=True)
    fused_launches = pbs_cuda.blind_rotate_fused.launches

    _reset_counts(pbs_cuda)
    for name, pattern, content, want_bit in REQUESTS:
        ct, fused = results[name]
        res, secs = _timed(lambda: port.has_match(
            sk, ct, pattern, fold="tree", device=DEVICE, backend="fft"))
        _want_bits(port.decrypt(ck, res), want_bit, f"{name} on fft")
        if not np.array_equal(res, fused):
            raise AssertionError(f"{name}: fft and cuda-fused results differ")
        print(f"request {params.name} {name} on fft: {secs:.3f} s (the "
              f"first includes the key's preparation), equal to cuda-fused",
              flush=True)
    pbs_s = throughput(params, ck, sk, "fft")

    cts, classic_res, classic_s = classic
    C = len(cts)
    circuit = port._compile(sk, *compile_match(len(SERVE[0]), SERVE_PATTERN,
                                               fold="tree"),
                            "fft", DEVICE, None, packed=True)
    if circuit.multivalue:
        raise AssertionError("has_match_many on fft: the auto plan is "
                             "multi-value")
    res, serve_s = _timed(lambda: port.has_match_many(
        sk, cts, SERVE_PATTERN, backend="fft", device=DEVICE))
    _want_bits([port.decrypt(ck, r) for r in res],
               [1 - i % 2 for i in range(C)], "has_match_many on fft")
    if not np.array_equal(res, classic_res):
        raise AssertionError("has_match_many on fft != classic cuda-fused")
    try:
        port.has_match_many(sk, cts[:2], SERVE_PATTERN, backend="fft",
                            device=DEVICE, multivalue=True)
        raise AssertionError("has_match_many(fft, multivalue=True) ran")
    except ValueError as e:
        if "not supported on 'fft'" not in str(e):
            raise
    launched = {k: v for k, v in pbs_cuda.launch_counts().items() if v}
    if launched:
        raise AssertionError(f"the fft path launched kernels {launched}")
    print(f"serving {params.name} on fft: has_match_many C={C}, classic plan "
          f"({circuit.pbs_count} bootstraps per content): {serve_s:.3f} s "
          f"({C / serve_s:.2f} contents/s; classic cuda-fused "
          f"{C / classic_s:.2f}), equal to cuda-fused, all bits right; "
          f"multivalue=True refused; no kernel of ops/pbs_cuda.py launched "
          f"(cuda-fused beside the rotations: {fused_launches})", flush=True)
    return {"rotations": rotations, "key_prep": prep, "pbs_per_s": pbs_s,
            "serving_contents_per_s": C / serve_s,
            "serving_cuda_fused_classic_contents_per_s": C / classic_s}


SPECTRAL_EQUAL = (8, 16, 64, 256, 1024)            # checked bit for bit
SPECTRAL_SWEEP = (8, 16, 32, 64, 128, 256, 512, 1024)   # timed on both paths


def spectral_phase(pbs_cuda, params, ck, sk, blind_rotate):
    """Phase 18: the spectral rotation of ``cuda-fused`` / ``cuda-bg``
    (``spectral::ext_product``, float64 FFTs on the key spectrum that
    ``prepare_server_key`` makes on the card, its seconds printed).  At
    each B of ``SPECTRAL_EQUAL``, bit-equal to the plain rotation, to the
    per-step ``cuda`` backend and to the limb GEMM, and the wrapper's
    rotation with the key's spectrum (its steps counted as spectral); at
    each B of ``SPECTRAL_SWEEP``, device ms
    a rotation of both paths (3 warm calls each between CUDA events),
    bit-equal, beside the limb and float64 FFT bounds of
    ``portbench/roofline.py`` (whose FFT plan is (16, 8, 8)) and the FFT
    bound of the kernel's own plan, ``SPECTRAL_PLAN``: the crossover sweep;
    then the phase split of a step at T = 1 and 2 (``spectral_clocks``).
    Returns the numbers of the ``{"spectral": ...}`` line."""
    from fhe_regex_tpu_torch.ops.pbs import prepare_server_key
    from fhe_regex_tpu_torch.ops.pbs_fft import SPECTRAL_PLAN
    from portbench.roofline import fft_rotation_bound as fft_bound
    from portbench.roofline import rotation_bound as limb_bound

    dk, prep_s = _timed(lambda: prepare_server_key(params, sk, DEVICE,
                                                   "cuda-fused"))
    if dk.spec is None:
        raise AssertionError("cuda-fused key without its spectrum")
    print(f"spectral key {params.name}: prepare_server_key {prep_s:.3f} s "
          f"(upload, limbs and torch.fft on the card), "
          f"{dk.spec.numel() * 16 / 1e6:.1f} MB", flush=True)
    out = {"key_prep_s": prep_s, "key_bytes": dk.spec.numel() * 16,
           "max_abs_err": 0, "widths": []}
    for B in sorted(set(SPECTRAL_EQUAL) | set(SPECTRAL_SWEEP)):
        x = _rotation_inputs(params, ck, B, seed=1800 + B)
        args = (params, dk.bsk, x["luts"], x["lut_idx"], x["ms"])

        def spectral():
            return pbs_cuda._rotate_spectral(params, dk.spec, *args[2:])

        def limb():
            return pbs_cuda.blind_rotate_fused(*args)

        got, want_limb = spectral(), limb()
        row = {"B": B}
        if B in SPECTRAL_EQUAL:
            steps0 = pbs_cuda.rotation_steps()
            main = pbs_cuda.blind_rotate_fused(*args, spec=dk.spec)
            steps1 = pbs_cuda.rotation_steps()
            pair = pbs_cuda.spectral_cluster(B, _sm_count()) == 2
            if (steps1["spectral"] - steps0["spectral"]
                    != params.lwe_dimension * B
                    or steps1["spectral_pair"] - steps0["spectral_pair"]
                    != pair * params.lwe_dimension * B
                    or steps1["limb"] != steps0["limb"]):
                raise AssertionError(f"B={B}: rotation_steps {steps0} -> "
                                     f"{steps1}")
            want = blind_rotate(*args)
            out["max_abs_err"] = max(out["max_abs_err"],
                                     _max_abs_err(got, want))
            per_step = pbs_cuda.blind_rotate_steps(*args)
            for name, other in (("plain", want), ("cuda", per_step),
                                ("limb", want_limb), ("wrapper", main)):
                if not torch.equal(got, other):
                    raise AssertionError(
                        f"spectral rotation B={B} != {name} (max |diff| "
                        f"{_max_abs_err(got, other)})")
            row["equal"] = ["plain", "cuda", "limb", "wrapper"]
        elif not torch.equal(got, want_limb):
            raise AssertionError(f"spectral rotation B={B} != limb")
        row["spectral_ms"] = [_event_ms(spectral)[1] for _ in range(3)]
        row["limb_ms"] = [_event_ms(limb)[1] for _ in range(3)]
        L = x["luts"].shape[0]
        row["limb_bound_ms"], _ = limb_bound(params, B, L)
        row["fft_bound_ms"], _ = fft_bound(params, B, L)
        row["plan_bound_ms"], _ = fft_rotation_bound(params, B, L,
                                                     SPECTRAL_PLAN)
        out["widths"].append(row)
        print(f"spectral rotation {params.name} B={B}: equal to "
              f"{row.get('equal', ['limb'])}; device ms {_fmt(row['spectral_ms'])}"
              f" (limb GEMM {_fmt(row['limb_ms'])}); bounds: limb "
              f"{row['limb_bound_ms']:.3f}, fft {row['fft_bound_ms']:.3f} "
              f"(16, 8, 8), {row['plan_bound_ms']:.3f} {SPECTRAL_PLAN} ms",
              flush=True)
    out["pair"] = pair_phase(pbs_cuda, params, ck, dk, blind_rotate)
    out["phase_clocks"] = spectral_clocks(pbs_cuda, params, ck, dk)
    return out


def _sm_count() -> int:
    return torch.cuda.get_device_properties(DEVICE).multi_processor_count


PAIR_EQUAL = (1, 8, 16, 32, 64, 66, 67)     # checked bit for bit
PAIR_TIMED = (8, 16, 32, 64)                # timed beside ext_product<1>


def pair_phase(pbs_cuda, params, ck, dk, blind_rotate):
    """The cluster pair of the spectral rotation (``spectral::pair``): at
    each B of ``PAIR_EQUAL`` the rotation ``spectral_cluster`` chooses
    (the pair while 2 B <= the SM count, one block an instance above),
    bit-equal, tolerance zero, to ``ext_product<1>`` on the same rows
    (``cluster`` 1) and to the plain rotation; at each B of ``PAIR_TIMED``
    device ms of both (3 warm calls each between CUDA events); the
    wrapper's launch counted under ``spectral_pair``.  Returns the rows of
    the ``pair`` entry of the ``{"spectral": ...}`` line."""
    sms = _sm_count()
    rows = []
    for B in PAIR_EQUAL:
        x = _rotation_inputs(params, ck, B, seed=2200 + B)
        args = (x["luts"], x["lut_idx"], x["ms"])
        cluster = pbs_cuda.spectral_cluster(B, sms)

        def chosen():
            return pbs_cuda._rotate_spectral(params, dk.spec, *args)

        def one_block():
            return pbs_cuda._rotate_spectral(params, dk.spec, *args, 1)

        got, one = chosen(), one_block()
        want = blind_rotate(params, dk.bsk, *args)
        for name, other in (("ext_product<1>", one), ("plain", want)):
            if not torch.equal(got, other):
                raise AssertionError(
                    f"spectral rotation B={B} (cluster {cluster}) != {name} "
                    f"(max |diff| {_max_abs_err(got, other)})")
        row = {"B": B, "cluster": cluster,
               "equal": ["ext_product<1>", "plain"]}
        if B in PAIR_TIMED:
            row["ms"] = [_event_ms(chosen)[1] for _ in range(3)]
            row["one_block_ms"] = [_event_ms(one_block)[1] for _ in range(3)]
        rows.append(row)
        print(f"spectral rotation {params.name} B={B} on {cluster} block(s) "
              f"an instance ({sms} SMs): equal to ext_product<1> and plain"
              + (f"; device ms {_fmt(row['ms'])} (one block "
                 f"{_fmt(row['one_block_ms'])})" if "ms" in row else ""),
              flush=True)
    B = 8
    x = _rotation_inputs(params, ck, B, seed=2300)
    steps0, launches0 = pbs_cuda.rotation_steps(), pbs_cuda.rotation_launches()
    pbs_cuda.blind_rotate_fused(params, dk.bsk, x["luts"], x["lut_idx"],
                                x["ms"], spec=dk.spec)
    steps1, launches1 = pbs_cuda.rotation_steps(), pbs_cuda.rotation_launches()
    if (steps1["spectral_pair"] - steps0["spectral_pair"]
            != params.lwe_dimension * B
            or launches1["spectral_pair"] - launches0["spectral_pair"] != 1):
        raise AssertionError(f"B={B}: spectral_pair not counted ({steps0} -> "
                             f"{steps1}, {launches0} -> {launches1})")
    return rows


SPECTRAL_PHASES = ("digits and pass 1", "forward passes 2 and 3",
                   "contraction", "inverse", "exchange")


def spectral_clocks(pbs_cuda, params, ck, dk):
    """The phase split of the spectral rotation's step: ``csrc/
    blind_rotate.cu`` built again with -DFHE_SPECTRAL_CLOCKS (into
    ``build/`` beside the library), one rotation at B = 8 on one block an
    instance (T = 1), one at B = 1024 (T = 2) and one at B = 8 on the
    cluster pair, on the key's spectrum, each equal to the library's; block
    0's clock64() ticks a step by phase (``SPECTRAL_PHASES``; the exchange,
    the pair's alone, is part of its contraction).  Returns {"T=1": {phase:
    ticks}, "T=2": ..., "pair": ...}."""
    import ctypes

    lib_path = pbs_cuda.build()
    so = lib_path.with_name(f"{lib_path.stem}-clocks.so")
    if not so.exists():
        res = subprocess.run(
            [pbs_cuda._nvcc(), *pbs_cuda.NVCC_FLAGS, "-DFHE_SPECTRAL_CLOCKS",
             "-shared", "-o", str(so), str(pbs_cuda.CSRC / "blind_rotate.cu")],
            capture_output=True, text=True)
        if res.returncode != 0:
            raise RuntimeError(f"nvcc -DFHE_SPECTRAL_CLOCKS failed:\n"
                               f"{res.stderr}")
    lib = ctypes.CDLL(str(so))
    rotate = lib.fhe_blind_rotate_spectral
    rotate.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 7 + [
        ctypes.c_void_p]
    rotate.restype = ctypes.c_int
    lib.fhe_spectral_phase_clocks.argtypes = [ctypes.c_void_p]
    lib.fhe_spectral_phase_clocks.restype = ctypes.c_int
    k1, N, n = (params.glwe_dimension + 1, params.polynomial_size,
                params.lwe_dimension)
    tables = pbs_cuda._spectral_tables(N, torch.device(DEVICE))
    out = {}
    cols = len(SPECTRAL_PHASES)
    for B, cluster, row, name in ((8, 1, 0, "T=1"), (1024, 1, 1, "T=2"),
                                  (8, 2, 2, "pair")):
        x = _rotation_inputs(params, ck, B, seed=1900 + B)
        acc = torch.empty((B, k1, N), dtype=torch.int32, device=DEVICE)
        ticks = (ctypes.c_ulonglong * (3 * cols))()

        def call():
            err = rotate(x["ms"].data_ptr(), x["luts"].data_ptr(),
                         x["lut_idx"].data_ptr(), dk.spec.data_ptr(),
                         tables.data_ptr(), acc.data_ptr(), B, n, k1, N,
                         params.pbs_level, params.pbs_base_log, cluster,
                         torch.cuda.current_stream().cuda_stream)
            if err != 0:
                raise RuntimeError(f"clocked spectral rotation: {err}")

        call()                                   # warm, then clocks to 0
        if lib.fhe_spectral_phase_clocks(ticks) != 0:
            raise RuntimeError("fhe_spectral_phase_clocks failed")
        call()
        torch.cuda.synchronize()
        if lib.fhe_spectral_phase_clocks(ticks) != 0:
            raise RuntimeError("fhe_spectral_phase_clocks failed")
        want = pbs_cuda._rotate_spectral(params, dk.spec, x["luts"],
                                         x["lut_idx"], x["ms"], cluster)
        if not torch.equal(acc, want):
            raise AssertionError(f"clocked spectral rotation B={B} != the "
                                 f"library's")
        per = [ticks[cols * row + p] / n for p in range(cols)]
        phases = SPECTRAL_PHASES if cluster == 2 else SPECTRAL_PHASES[:-1]
        per = per[:len(phases)]
        if min(per) <= 0:
            raise AssertionError(f"phase clocks {name}: {per}")
        total = sum(per[:4])                   # the exchange lies inside
        out[name] = dict(zip(phases, per))
        print(f"spectral step {name} (B={B}): {total:.0f} clocks; "
              + ", ".join(f"{p} {t:.0f} ({100 * t / total:.1f} %)"
                          for p, t in zip(phases, per)),
              flush=True)
    return out


def _run_timed(fn):
    """(result, wall seconds, device-stream seconds) of one call of fn:
    a host clock and two CUDA events around it, synchronised."""
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    start.record()
    out = fn()
    end.record()
    end.synchronize()
    return out, time.perf_counter() - t0, start.elapsed_time(end) / 1e3


def _rss_bytes() -> int:
    """This process's resident memory now (Linux)."""
    import os

    with open("/proc/self/statm") as f:
        return int(f.read().split()[1]) * os.sysconf("SC_PAGE_SIZE")


def _busy(fn):
    """(wall seconds, device busy seconds, {kernel name: count}) of one
    warm call of fn under ``torch.profiler`` with device activity only;
    busy is the union of the device intervals (``chip_profile.busy_us``'s
    method), read from the profiler's raw events: building its Python event
    tree for the ~175k kernels of an ``fft`` request takes longer than the
    run.  A kernel's name is its function's, without namespace, template
    arguments or signature."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    events = [e for e in prof.profiler.kineto_results.events()
              if e.device_type() == DeviceType.CUDA]
    spans = sorted((e.start_ns(), e.start_ns() + e.duration_ns())
                   for e in events)
    if not spans:
        raise AssertionError("the profiler recorded no device events")
    names = collections.Counter()
    for e in events:
        m = re.search(r"(\w+)[<(]", e.name())
        names[m.group(1) if m else e.name()] += 1
    busy, end = 0, None
    for a, b in spans:
        if end is None or a > end:
            busy, end = busy + b - a, b
        elif b > end:
            busy, end = busy + b - end, b
    return wall, busy / 1e9, names


def _our_kernels(launches: dict, n: int, spectral: bool = False) -> dict:
    """{device function: kernels run} for ``launches`` ({wrapper name:
    launches}) of ``ops/pbs_cuda.py``'s 32-bit wrappers: a whole rotation
    is one ``acc_init`` and n (``stage1``, ``ext_product``) pairs, or, on
    the key's spectrum (``spectral``), one ``spectral::ext_product``; the
    row-block entry runs ``ext_product`` too."""
    rot = launches.get("blind_rotate_fused", 0)
    steps = 0 if spectral else n
    return {"acc_init": 0 if spectral else rot,
            "stage1": steps * rot + launches.get("stage1_digits", 0),
            "ext_product": (rot if spectral else n * rot)
            + launches.get("external_product_step", 0)
            + launches.get("external_product_rows", 0)}


def _graph_nodes(entry, pbs_cuda):
    """(nodes, instantiate seconds) of a second capture of ``entry``'s
    level loop, kept as a graph (``keep_graph=True``) and instantiated on
    its own; nodes from libcuda's ``cuGraphGetNodes``.  (None, None)
    where this PyTorch cannot keep a captured graph."""
    import ctypes

    try:
        graph = torch.cuda.CUDAGraph(keep_graph=True)
    except TypeError:
        return None, None
    before = pbs_cuda.launch_counts()
    try:
        with torch.cuda.graph(graph):
            entry.body()
    finally:
        pbs_cuda.add_launches(pbs_cuda.launch_delta(
            before, pbs_cuda.launch_counts()), -1)
    t0 = time.perf_counter()
    graph.instantiate()
    inst_s = time.perf_counter() - t0
    cuda = ctypes.CDLL("libcuda.so.1")
    cuda.cuGraphGetNodes.argtypes = [ctypes.c_void_p, ctypes.c_void_p,
                                     ctypes.POINTER(ctypes.c_size_t)]
    n = ctypes.c_size_t(0)
    err = cuda.cuGraphGetNodes(ctypes.c_void_p(graph.raw_cuda_graph()), None,
                               ctypes.byref(n))
    if err != 0:
        raise AssertionError(f"cuGraphGetNodes: CUresult {err}")
    del graph
    torch.cuda.synchronize()
    return n.value, inst_s


def _fused_vs_levels(label, ex, make, ct, want, pbs_cuda, kernel=None,
                     reps=3):
    """One circuit on a fresh executor: a per-level cold run of one compile
    (plan upload included), a fused cold run of another compile of the
    same plan (its warm-up pass computes the result, then the capture),
    then ``reps`` warm runs of each; every result equal to ``want`` (None:
    to the first per-level one).  ``make()`` compiles the circuit.  The
    per-level run must launch ``kernel`` (a wrapper; None: no check), and
    the per-level run, the fused cold run and every replay must each count
    the launches the capture recorded.  Returns the numbers."""
    circuit, twin = make(), make()
    before = pbs_cuda.launch_counts()
    lv_cold, lv_cold_s, _ = _run_timed(lambda: ex.run(circuit, ct,
                                                      fuse=False))
    lv_launches = pbs_cuda.launch_delta(before, pbs_cuda.launch_counts())
    if kernel is not None and lv_launches.get(kernel.__name__, 0) <= 0:
        raise AssertionError(f"{label}: the per-level loop launched no "
                             f"{kernel.__name__} ({lv_launches})")
    before = pbs_cuda.launch_counts()
    rss0 = _rss_bytes()
    fz_cold, fz_cold_s, _ = _run_timed(lambda: ex.run(twin, ct, fuse=True))
    rss = _rss_bytes() - rss0
    cold_launches = pbs_cuda.launch_delta(before, pbs_cuda.launch_counts())
    entry = ex.fused_levels(twin)
    if entry.graph is None:
        raise AssertionError(f"{label}: the fused run captured no graph")
    if not lv_launches == cold_launches == entry.launches:
        raise AssertionError(f"{label}: launches per-level {lv_launches}, "
                             f"fused cold {cold_launches}, recorded "
                             f"{entry.launches}")
    want = lv_cold if want is None else want
    warm = {"levels": [], "fused": []}
    outs = [lv_cold, fz_cold]
    for _ in range(reps):
        for kind, fuse in (("levels", False), ("fused", True)):
            before = pbs_cuda.launch_counts()
            out, wall, dev = _run_timed(lambda: ex.run(circuit, ct,
                                                       fuse=fuse))
            got = pbs_cuda.launch_delta(before, pbs_cuda.launch_counts())
            if got != lv_launches:
                raise AssertionError(f"{label}: a warm {kind} run counted "
                                     f"{got}, the per-level cold run "
                                     f"{lv_launches}")
            outs.append(out)
            warm[kind].append((wall, dev))
    if not all(np.array_equal(o, want) for o in outs):
        raise AssertionError(f"{label}: fused and per-level results differ, "
                             f"or differ from the earlier phase")
    row = {"levels": len(circuit.levels), "pbs": circuit.pbs_count,
           "rotations": circuit.rotation_count,
           "levels_cold_s": lv_cold_s, "fused_cold_s": fz_cold_s,
           "warmup_s": entry.warmup_s, "capture_s": entry.capture_s,
           "levels_warm_s": [w for w, _ in warm["levels"]],
           "levels_warm_event_s": [d for _, d in warm["levels"]],
           "fused_warm_s": [w for w, _ in warm["fused"]],
           "fused_warm_event_s": [d for _, d in warm["fused"]],
           "launches_per_replay": entry.launches,
           "pool_bytes": entry.pool_bytes, "capture_rss_bytes": rss}
    print(f"fused {label}: {row['pbs']} bootstraps ({row['rotations']} "
          f"rotations) in {row['levels']} levels; equal fused, per-level and "
          f"the earlier phase; cold per-level {lv_cold_s:.3f} s, fused "
          f"{fz_cold_s:.3f} s (warm-up {entry.warmup_s:.3f} + capture and "
          f"instantiate {entry.capture_s:.3f}); warm per-level "
          f"{_fmt(row['levels_warm_s'])} s (events "
          f"{_fmt(row['levels_warm_event_s'])}), fused "
          f"{_fmt(row['fused_warm_s'])} s (events "
          f"{_fmt(row['fused_warm_event_s'])}); launches {entry.launches} "
          f"per run, per-level, cold and replayed alike; pool "
          f"{entry.pool_bytes / 1e6:.1f} MB; host memory {rss / 1e6:+.1f} "
          f"MB over the fused cold run", flush=True)
    return row


def fused_phase(port, pbs_cuda, full, ck, sk, dk, results, full64, dk64_bg,
                results64):
    """Phase 16: ``Executor.run(fuse=True)``, the whole level loop of a
    request as one CUDA graph, against the per-level loop on fresh
    executors (no graph cached), at the full production widths: (a) the
    six 32-bit requests on ``cuda-fused`` (``dk``), each equal to its
    phase-3 result; (b) two 64-bit requests on ``cuda64-bg`` (``dk64_bg``)
    equal to phase 6; (c) one multi-value circuit; (d) ``exact_literal``
    on ``cuda-fused``, the per-step ``cuda`` backend and ``fft``, profiled
    warm (wall, device busy, idle share, and the kernels the trace shows,
    held against the launches the capture recorded), with each graph's
    nodes and instantiation seconds; then the request of the most
    rotations on ``cuda``; (e) the default with FHE_REGEX_FUSE_LEVELS
    unset: ``has_match`` on ``cuda-fused`` keeps the per-level loop (the
    watchdog's "levels" key), on ``cuda`` it takes the graph ("fused") and
    a warm replay counts #1's launches.  Every per-level run must launch
    the backend's kernel.  Returns the numbers of the ``{"fuse": ...}``
    line."""
    import os

    from fhe_regex_tpu_torch.ops.pbs import prepare_server_key
    from fhe_regex_tpu_torch.regex.engine import compile_match
    from fhe_regex_tpu_torch.regex.executor import Executor, compile_circuit

    t_phase = time.perf_counter()
    if "FHE_REGEX_FUSE_LEVELS" in os.environ:
        raise AssertionError("FHE_REGEX_FUSE_LEVELS is set: phase 16 needs "
                             "the default")

    def circ(params, pattern, content, **kw):
        return compile_circuit(params, *compile_match(
            len(content), pattern, num_blocks=params.num_blocks,
            fold="tree"), **kw)

    out = {"a": {}, "b": {}}
    # (a) the six 32-bit requests on cuda-fused
    ex = Executor(full, dk)
    for name, pattern, content, _ in REQUESTS:
        ct, want = results[name]
        out["a"][name] = _fused_vs_levels(
            f"{full.name} {name} cuda-fused", ex,
            lambda: circ(full, pattern, content), ct, want, pbs_cuda,
            pbs_cuda.blind_rotate_fused)
    # (b) two 64-bit requests on cuda64-bg
    ex64 = Executor(full64, dk64_bg)
    for name, pattern, content, _ in (REQUESTS[0], REQUESTS[5]):
        ct, want = results64[name]
        out["b"][name] = _fused_vs_levels(
            f"{full64.name} {name} cuda64-bg", ex64,
            lambda: circ(full64, pattern, content), ct, want, pbs_cuda,
            pbs_cuda.blind_rotate_fused64_bg, reps=2)
    # (c) one multi-value circuit
    name, pattern, content, bit = REQUESTS[1]
    mv = circ(full, pattern, content, multivalue=True)
    if mv.rotation_count >= mv.pbs_count:
        raise AssertionError(f"{name}: the multi-value plan shares nothing")
    out["c"] = _fused_vs_levels(
        f"{full.name} {name} multi-value cuda-fused", ex,
        lambda: circ(full, pattern, content, multivalue=True),
        results[name][0], None, pbs_cuda, pbs_cuda.blind_rotate_fused,
        reps=2)
    _want_bits(port.decrypt(ck, ex.run(mv, results[name][0], fuse=True)),
               bit, f"{name} multi-value fused")
    # (d) the host-bound backends, exact_literal, then the request of the
    # most rotations on cuda
    name, pattern, content, _ = REQUESTS[0]
    ct, want = results[name]
    out["d"] = {}
    n = full.lwe_dimension
    keys = {}
    for backend, kernel in (("cuda-fused", pbs_cuda.blind_rotate_fused),
                            ("cuda", pbs_cuda.external_product_step),
                            ("fft", None)):
        key = keys[backend] = (
            dk if backend == "cuda-fused" else
            port.executor_for(sk, backend, device=DEVICE)._dev_key
            if backend == "fft" else
            prepare_server_key(full, sk, DEVICE, backend))
        exb = Executor(full, key)
        c = circ(full, pattern, content)
        row = _fused_vs_levels(f"{full.name} {name} {backend}", exb,
                               lambda: circ(full, pattern, content), ct,
                               want, pbs_cuda, kernel, reps=1)
        traced = {}
        for kind, fuse in (("levels", False), ("fused", True)):
            wall, busy, names = _busy(lambda: exb.run(c, ct, fuse=fuse))
            row[f"{kind}_profiled"] = {"wall_s": wall, "busy_s": busy,
                                       "idle_share": 1 - busy / wall}
            traced[kind] = {k: names.get(k, 0) for k in
                            ("acc_init", "stage1", "ext_product")}
        recorded = _our_kernels(row["launches_per_replay"], n,
                                spectral=key.spec is not None)
        if not traced["levels"] == traced["fused"] == recorded:
            raise AssertionError(f"{name} {backend}: the trace shows kernels "
                                 f"{traced}, the capture recorded launches "
                                 f"for {recorded}")
        row["traced_kernels"] = traced["fused"]
        row["nodes"], row["instantiate_s"] = _graph_nodes(
            exb.fused_levels(c), pbs_cuda)
        lv, fz = row["levels_profiled"], row["fused_profiled"]
        print(f"fused {name} {backend} profiled: per-level wall "
              f"{lv['wall_s']:.4f} s, busy {lv['busy_s']:.4f} s, idle share "
              f"{lv['idle_share']:.3f}; fused wall {fz['wall_s']:.4f} s, busy "
              f"{fz['busy_s']:.4f} s, idle share {fz['idle_share']:.3f}; "
              f"traced kernels {traced['fused']} per run, per-level and "
              f"replayed alike, as the recorded launches give; graph of "
              f"{row['nodes']} nodes, instantiated alone in "
              f"{row['instantiate_s']} s", flush=True)
        out["d"][backend] = row
        del exb
    big = max(REQUESTS, key=lambda r: circ(full, r[1], r[2]).rotation_count)
    exb = Executor(full, keys["cuda"])
    row = _fused_vs_levels(f"{full.name} {big[0]} cuda", exb,
                           lambda: circ(full, big[1], big[2]),
                           *results[big[0]], pbs_cuda,
                           pbs_cuda.external_product_step, reps=2)
    row["nodes"], row["instantiate_s"] = _graph_nodes(
        exb.fused_levels(circ(full, big[1], big[2])), pbs_cuda)
    print(f"fused {big[0]} cuda: graph of {row['nodes']} nodes, "
          f"instantiated alone in {row['instantiate_s']} s", flush=True)
    out["d"][f"cuda {big[0]}"] = row
    del exb, keys
    # (e) the default: the per-level loop on cuda-fused, the graph on cuda
    c = circ(full, pattern, content)
    shape = (c.pbs_count, c.num_slots, False)
    out["e"] = {}
    for backend, kind in (("cuda-fused", "levels"), ("cuda", "fused")):
        exd = port.executor_for(sk, backend, device=DEVICE)
        for warm in (False, True):
            seen = dict(exd.watchdog._seen)
            before = pbs_cuda.launch_counts()
            res = port.has_match(sk, ct, pattern, fold="tree", device=DEVICE,
                                 backend=backend)
            launched = pbs_cuda.launch_delta(before,
                                             pbs_cuda.launch_counts())
            grew = {k: v - seen.get(k, 0) for k, v in exd.watchdog._seen.items()
                    if v != seen.get(k, 0)}
            graphs = len(exd._fused)
            if (grew != {(kind,) + shape: 1} or not np.array_equal(res, want)
                    or not launched or (kind == "levels") != (graphs == 0)
                    or (warm and kind == "fused" and launched
                        != exd.fused_levels(c).launches)):
                raise AssertionError(f"default has_match {name} on {backend}:"
                                     f" watchdog {grew}, launched "
                                     f"{launched}, graphs {graphs}")
        out["e"][backend] = {"watchdog_key": str((kind,) + shape),
                             "warm_launches": launched}
        print(f"default has_match {name} on {backend} "
              f"(FHE_REGEX_FUSE_LEVELS unset): watchdog {(kind,) + shape}, "
              f"a warm run launched {launched}, equal to phase 3", flush=True)
    del ex, ex64
    gc.collect()                   # the graphs of the fresh executors
    torch.cuda.empty_cache()
    out["phase_s"] = time.perf_counter() - t_phase
    print(f"phase 16 {out['phase_s']:.1f} s", flush=True)
    return out


def native_equals_python():
    """Phase 15, the last: ``native/libfheregex.so`` (built with ``make -C
    native`` if absent, and then removed at the end, so that a later run's
    entry points take the compiler this one's did) gives the Python
    builder's circuit, op for op, for the five DRIVER_CONFIGS and the
    serving configuration, in both folds."""
    from fhe_regex_tpu_torch.models.patterns import DRIVER_CONFIGS
    from fhe_regex_tpu_torch.regex import native
    from fhe_regex_tpu_torch.regex.engine import compile_match

    lib = ROOT / "native" / "libfheregex.so"
    built = not lib.exists()
    try:
        _native_vs_python(native, compile_match, DRIVER_CONFIGS, built)
    finally:
        if built:
            lib.unlink(missing_ok=True)


def _native_vs_python(native, compile_match, configs, build):
    build_s = 0.0
    if build:
        t0 = time.perf_counter()
        subprocess.run(["make", "-C", str(ROOT / "native"), "libfheregex.so"],
                       check=True, capture_output=True, timeout=600)
        build_s = time.perf_counter() - t0
    if not native.available():
        raise AssertionError("native/libfheregex.so does not load")
    cfgs = [(c["content_len"], c["pattern"]) for c in configs]
    cfgs.append((len(SERVE[0]), SERVE_PATTERN))
    py_s = nat_s = 0.0
    for n, pattern in cfgs:
        for fold in ("reference", "tree"):
            t0 = time.perf_counter()
            pb, proot = compile_match(n, pattern, fold=fold)
            t1 = time.perf_counter()
            nb, nroot = native.compile_match_native(n, pattern, fold=fold)
            t2 = time.perf_counter()
            py_s, nat_s = py_s + t1 - t0, nat_s + t2 - t1
            if ((nb.ct_ops, nb.cache_hits, nb.num_content_slots)
                    != (pb.ct_ops, pb.cache_hits, pb.num_content_slots)
                    or nroot.val != proot.val or nb.ops != pb.ops):
                raise AssertionError(f"native != python: {pattern} over {n} "
                                     f"chars, fold {fold}")
    print(f"native circuit compiler (make {build_s:.1f} s; 0 = built "
          f"already{', removed after' if build else ''}): {len(cfgs)} "
          f"configurations x 2 folds op for op equal to the Python builder; "
          f"compile {nat_s:.4f} s native, {py_s:.4f} s python", flush=True)


def daemon64(port, pbs_cuda, params, ck, sk):
    """The 64-bit daemon in this process: ``make_server(MatchService(sk))``
    in a thread, on the default backend ``cuda64-bg`` (#6); one /match of
    exact_literal, bit-equal to in-process ``has_match``, launching #6."""
    from fhe_regex_tpu_torch.serve import MatchService, make_server

    srv = make_server(MatchService(sk), port=0)
    th = threading.Thread(target=srv.serve_forever, daemon=True)
    th.start()
    try:
        url = f"http://127.0.0.1:{srv.server_address[1]}"
        health, _ = _http(url, "/health")
        if health["backend"] != "cuda64-bg":
            raise AssertionError(f"64-bit daemon /health {health}")
        _reset_counts(pbs_cuda)
        http_s, local_s, _, launches = _serve_request(
            port, url, ck, sk, REQUESTS[0],
            kernel=pbs_cuda.blind_rotate_fused64_bg)
        if launches <= 0:
            raise AssertionError("64-bit daemon: blind_rotate_fused64_bg was "
                                 "not launched")
        print(f"daemon {params.name} (in process, cuda64-bg) /match "
              f"{REQUESTS[0][0]}: {http_s:.4f} s over HTTP (cold), in-process"
              f" {local_s:.4f} s, equal ciphertexts, right; "
              f"blind_rotate_fused64_bg launches {launches}", flush=True)
    finally:
        srv.shutdown()
        srv.server_close()
        th.join(timeout=30)


def rows_vs_plain(params, bsk, pbs_cuda, plain):
    """Phase 17, the row-block entry of #1 (``external_product_rows``, the
    step of tensor parallelism) against its plain version on the same card
    inputs, tolerance zero: at B = 8 and 256, every block of R = 6, 3, 2
    and 1 of the 6 digit rows (what a rank holds at D = 1, 2, 3, 6, cut
    here by slicing at D = 1), on a zero and on a random accumulator; the
    blocks of each R sum mod 2^32 to the whole step.  Timed per launch at
    R = 6 (the TP path at D = 1) and 3, B = 8 and 256 (``_graph_ms``),
    beside the plain version and one float64 ``torch.matmul`` on the
    block's Toeplitz matrix.  Returns (largest difference, {(B, R): ms})."""
    k1, N = params.glwe_dimension + 1, params.polynomial_size
    rows = k1 * params.pbs_level
    err, out = 0, {}
    for B in (8, 256):
        acc, a = _digit_inputs(params, B, 1700 + B)
        d = pbs_cuda.stage1_digits(params, acc, a)
        zero = torch.zeros_like(acc)
        whole = plain.external_product_step(params, d, bsk[0], acc)
        for R in (6, 3, 2, 1):
            total = acc.to(torch.int64)
            for r0 in range(0, rows, R):
                blk, g = d[:, r0:r0 + R].contiguous(), bsk[0][r0:r0 + R]
                for base in (zero, acc):
                    got = pbs_cuda.external_product_rows(params, blk, g, base)
                    want = plain.external_product_step(params, blk, g, base)
                    err = max(err, _max_abs_err(got, want))
                    if not torch.equal(got, want):
                        raise AssertionError(
                            f"external_product_rows B={B} R={R} r0={r0}: "
                            f"kernel != plain (max |diff| {err})")
                    if base is zero:
                        total += got.to(torch.int64)
            if not torch.equal(plain.wrap_i32(total), whole):
                raise AssertionError(f"external_product_rows B={B} R={R}: "
                                     f"the blocks do not sum to the step")
        for R in (6, 3):
            blk, g = d[:, :R].contiguous(), bsk[0][:R]
            W = plain._ext_product_matrix(g)
            df = blk.reshape(B, R * N).to(torch.float64)
            t = dict(
                ms=_graph_ms(lambda: pbs_cuda.external_product_rows(
                    params, blk, g, zero)),
                plain=_graph_ms(lambda: plain.external_product_step(
                    params, blk, g, zero), reps=3),
                lib=_graph_ms(lambda: torch.matmul(df, W), reps=3))
            print(f"external_product_rows {params.name} B={B} R={R}: device "
                  f"ms per launch (CUDA graph) {_fmt(t['ms'])}, plain "
                  f"{_fmt(t['plain'])}, float64 matmul {_fmt(t['lib'])}",
                  flush=True)
            out[B, R] = {k: float(np.median(v)) for k, v in t.items()}
    print(f"external_product_rows {params.name}: equal to plain at B=8, 256, "
          f"R=6, 3, 2, 1 on zero and random accumulators; blocks sum to the "
          f"step", flush=True)
    return err, out


def tp_phase(port, pbs_cuda, params, ck, sk, dk):
    """Phase 17 (d): ``make_tp_pbs_fn`` on ``make_tp_mesh(1)`` at B = 8 and
    256, as one CUDA graph (the default at world 1) and as the eager step
    loop (FHE_REGEX_FUSE_LEVELS=0).  The main path is the graph's first
    call at each B (its warm-up pass gives the result, then the capture),
    counts set to 0 just before the two calls and read just after.  Every
    call, eager, first or replayed, must count 866 launches each of #2 and
    the row-block #1 (a replay adds those its capture recorded).  Then, at
    each B, an eager cold call; the outputs bit-equal to each other and to
    ``cuda-fused``'s bootstrap of the same batch, and decrypt-checked; two
    warm calls of each (eager, graph, graph, eager) and of ``cuda-fused``
    timed; one warm call of each profiled (wall, device busy, idle share),
    the kernels traced in both equal to those the capture recorded; the
    graph's nodes and instantiation seconds (a second capture), its pool
    bytes, warm-up and capture seconds."""
    import os

    from fhe_regex_tpu_torch.crypto import lwe
    from fhe_regex_tpu_torch.ops.pbs import make_pbs_core
    from fhe_regex_tpu_torch.parallel.tensor import (make_tp_mesh,
                                                     make_tp_pbs_fn)

    if "FHE_REGEX_FUSE_LEVELS" in os.environ:
        raise AssertionError("FHE_REGEX_FUSE_LEVELS is set: phase 17 (d) "
                             "needs the default")
    n = params.lwe_dimension
    tp = make_tp_pbs_fn(params, sk, make_tp_mesh(1))

    def tp_eager(*args):
        os.environ["FHE_REGEX_FUSE_LEVELS"] = "0"
        try:
            return tp(*args)
        finally:
            del os.environ["FHE_REGEX_FUSE_LEVELS"]

    per_call = {"stage1_digits": n, "external_product_rows": n}

    def call(fn, args, label):
        before = pbs_cuda.launch_counts()
        out, secs = _timed(lambda: fn(*args))
        got = pbs_cuda.launch_delta(before, pbs_cuda.launch_counts())
        if got != per_call:
            raise AssertionError(f"TP {label}: launches {got}, want "
                                 f"{per_call}")
        return out, secs

    core = make_pbs_core(dk)
    inputs = {B: _rotation_inputs(params, ck, B, seed=1600 + B)
              for B in (8, 256)}
    args = {B: (x["luts"], x["lut_idx"], x["cts"]) for B, x in inputs.items()}
    _reset_counts(pbs_cuda)
    cold = {B: call(tp, args[B], f"B={B} graph, first call")
            for B in inputs}
    launches = {k: pbs_cuda.launch_counts()[k] for k in per_call}
    entries = {shape[2][0]: e for shape, e in tp.graphs.items()}
    if sorted(entries) != [8, 256] or any(
            e.graph is None or e.launches != per_call
            for e in entries.values()):
        raise AssertionError(f"TP: graphs {list(tp.graphs)}, want one "
                             f"captured at B = 8 and at 256 recording "
                             f"{per_call}")
    numbers = {}
    for B, x in inputs.items():
        want = core(*args[B])
        entry = entries[B]
        outs = [cold[B][0]]
        eager_out, eager_cold = call(tp_eager, args[B], f"B={B} eager")
        outs.append(eager_out)
        warm = {"eager": [], "graph": []}
        for kind in ("eager", "graph", "graph", "eager"):
            out, secs = call(tp_eager if kind == "eager" else tp, args[B],
                             f"B={B} {kind}, warm")
            outs.append(out)
            warm[kind].append(secs)
        if not all(torch.equal(o, want) for o in outs):
            raise AssertionError(f"TP B={B}: the graph, the eager loop and "
                                 f"cuda-fused differ")
        o = want.cpu().numpy().view(np.uint32)
        dec = [lwe.decrypt_lwe(params, ck.lwe_key, o[i]) for i in range(B)]
        exp = [x["fs"][x["idx"][i]](int(m)) for i, m in enumerate(x["msgs"])]
        if dec != exp:
            raise AssertionError(f"TP B={B}: wrong decryptions")
        fused_s = [_timed(lambda: core(*args[B]))[1] for _ in range(2)]
        prof, traced = {}, {}
        for kind, fn in (("eager", tp_eager), ("graph", tp)):
            wall, busy, names = _busy(lambda: fn(*args[B]))
            prof[kind] = (wall, busy, 1 - busy / wall)
            traced[kind] = {k: names.get(k, 0) for k in
                            ("acc_init", "stage1", "ext_product")}
        recorded = _our_kernels(entry.launches, n)
        if not traced["eager"] == traced["graph"] == recorded:
            raise AssertionError(f"TP B={B}: the trace shows kernels "
                                 f"{traced}, the capture recorded launches "
                                 f"for {recorded}")
        nodes, inst_s = _graph_nodes(entry, pbs_cuda)
        numbers[B] = {"tp_ms": [t * 1e3 for t in warm["graph"]],
                      "cuda_fused_ms": [t * 1e3 for t in fused_s],
                      "profiled_wall_s": prof["graph"][0],
                      "busy_s": prof["graph"][1],
                      "idle_share": prof["graph"][2],
                      "eager_ms": [t * 1e3 for t in warm["eager"]],
                      "eager_profiled_wall_s": prof["eager"][0],
                      "eager_busy_s": prof["eager"][1],
                      "eager_idle_share": prof["eager"][2],
                      "cold_s": cold[B][1], "eager_cold_s": eager_cold,
                      "warmup_s": entry.warmup_s,
                      "capture_s": entry.capture_s,
                      "nodes": nodes, "instantiate_s": inst_s,
                      "pool_bytes": entry.pool_bytes,
                      "traced_kernels": traced["graph"],
                      # the profiler slows a replay; the warm calls above
                      # ran untraced
                      "warm_over_busy": min(warm["graph"]) / prof["graph"][1]}
        r = numbers[B]
        print(f"TP {params.name} D=1 B={B}: graph, eager loop and cuda-fused "
              f"equal, all decrypt; {n} launches each of stage1_digits and "
              f"external_product_rows a call, eager, first and replayed, "
              f"and traced {traced['graph']}; warm ms per batch: graph "
              f"{_fmt(r['tp_ms'])}, eager {_fmt(r['eager_ms'])}, "
              f"cuda-fused {_fmt(r['cuda_fused_ms'])}; profiled graph wall "
              f"{prof['graph'][0]:.4f} s, busy {prof['graph'][1]:.4f} s, "
              f"idle share {prof['graph'][2]:.3f} (warm call "
              f"{r['warm_over_busy']:.3f}x busy); eager wall "
              f"{prof['eager'][0]:.4f} s, busy {prof['eager'][1]:.4f} s, "
              f"idle share {prof['eager'][2]:.3f}; cold: graph "
              f"{cold[B][1]:.3f} s (warm-up {entry.warmup_s:.3f} + capture "
              f"and instantiate {entry.capture_s:.3f}), eager "
              f"{eager_cold:.3f} s; graph of {nodes} nodes, instantiated "
              f"alone in {inst_s} s, pool {entry.pool_bytes / 1e6:.1f} MB",
              flush=True)
    return launches, numbers


def mesh_phase(port, pbs_cuda, plain, full, ck, sk, dk, sk64, ck64,
               results, warm3, results64, classic, served, small_keys):
    """Phase 17: the mesh on the card, in this process: a NCCL group of
    world 1 (``multihost.initialize`` on a free local port), ``make_mesh(1)``
    and every multi-GPU path of ``fhe_regex_tpu_torch.parallel`` on phase
    1's keys, each bit-equal to its single-card phase; the group is
    destroyed at the end.  Returns (the ``{"mesh": ...}`` numbers, the
    row-block entry's numbers)."""
    import torch.distributed as dist

    from fhe_regex_tpu_torch.crypto import lwe
    from fhe_regex_tpu_torch.crypto.golden import make_lut_poly
    from fhe_regex_tpu_torch.ops.luts import LUT_OR2, lut_fn
    from fhe_regex_tpu_torch.parallel.collective import or_tree_across_devices
    from fhe_regex_tpu_torch.parallel.dryrun import dryrun_multichip
    from fhe_regex_tpu_torch.parallel.mesh import make_mesh
    from fhe_regex_tpu_torch.parallel.multihost import initialize
    from fhe_regex_tpu_torch.regex.engine import compile_match
    from fhe_regex_tpu_torch.regex.executor import compile_circuit

    t0 = time.perf_counter()
    initialize(coordinator_address=f"127.0.0.1:{_free_port()}",
               num_processes=1, process_id=0)
    try:
        if dist.get_backend() != "nccl":
            raise AssertionError(f"the group on the card is "
                                 f"{dist.get_backend()}, not nccl")
        mesh = make_mesh(1)
        nccl = ".".join(str(v) for v in torch.cuda.nccl.version())
        print(f"mesh: {dist.get_backend()} (NCCL {nccl}), world "
              f"{dist.get_world_size()}, make_mesh(1) on "
              f"{mesh.device_type}; torch.cuda.device_count() "
              f"{torch.cuda.device_count()}", flush=True)
        out = {"nccl": nccl, "device_count": torch.cuda.device_count(),
               "world": dist.get_world_size()}

        # (a) the six requests of phase 3 with the mesh
        _reset_counts(pbs_cuda)
        lat = {}
        for name, pattern, _, bit in REQUESTS:
            ct, want = results[name]
            res, cold = _timed(lambda: port.has_match(
                sk, ct, pattern, fold="tree", device=DEVICE, mesh=mesh))
            res2, warm = _timed(lambda: port.has_match(
                sk, ct, pattern, fold="tree", device=DEVICE, mesh=mesh))
            if not (np.array_equal(res, want) and np.array_equal(res2, want)):
                raise AssertionError(f"{name} with the mesh != phase 3")
            _want_bits(port.decrypt(ck, res), bit, f"{name} with the mesh")
            lat[name] = {"cold_s": cold, "warm_s": warm,
                         "phase3_warm_s": warm3[name]}
            print(f"request {full.name} {name} with the mesh: equal to phase "
                  f"3; warm {warm:.3f} s (phase 3 {warm3[name]:.3f} s), cold "
                  f"{cold:.3f} s", flush=True)
        launches = pbs_cuda.blind_rotate_fused.launches
        if launches <= 0:
            raise AssertionError("the mesh requests launched no "
                                 "blind_rotate_fused")
        out["requests"] = {"latency": lat, "blind_rotate_fused": launches}
        # those ran the per-level loop (the default on cuda-fused), each
        # level's all-gather issued eagerly; one more, fused by request,
        # its all-gathers captured with the rotations
        exm = port.executor_for(sk, device=DEVICE, mesh=mesh)
        if exm._fused or {k[0] for k in exm.watchdog._seen} != {"levels"}:
            raise AssertionError(f"the mesh requests did not all run the "
                                 f"per-level loop: {exm.watchdog._seen}")
        name, pattern, content, _ = REQUESTS[4]
        ct, want = results[name]
        circuit = compile_circuit(full, *compile_match(
            len(content), pattern, num_blocks=full.num_blocks, fold="tree"))
        res, secs = _timed(lambda: exm.run(circuit, ct, fuse=True))
        if (not np.array_equal(res, want)
                or exm.fused_levels(circuit).graph is None
                or exm.watchdog._seen.get(("fused", circuit.pbs_count,
                                           circuit.num_slots, False)) != 1):
            raise AssertionError(f"{name} fused with the mesh != phase 3, "
                                 f"or not through a graph")
        out["fused"] = {"request": name, "s": secs,
                        "graphs": len(exm._fused)}
        print(f"request {full.name} {name} with the mesh, fuse=True: equal "
              f"to phase 3, {secs:.3f} s; the mesh executor holds "
              f"{len(exm._fused)} captured level loops", flush=True)

        # (b) the serving configuration through run_many with the mesh
        cts, classic_res, classic_s = classic
        mv_res, mv_warm = served
        C = len(cts)
        builder, root = compile_match(len(SERVE[0]), SERVE_PATTERN,
                                      fold="tree")
        mv = port._compile(sk, builder, root, "cuda-bg", DEVICE, None,
                           packed=True, mesh=mesh)
        cl = port._compile(sk, builder, root, "cuda-fused", DEVICE, False,
                           packed=True, mesh=mesh)
        if not mv.multivalue or cl.multivalue:
            raise AssertionError("serving plans with the mesh: want "
                                 "multi-value and classic")
        _reset_counts(pbs_cuda)
        ex_bg = port.executor_for(sk, "cuda-bg", device=DEVICE, mesh=mesh)
        r, cold = _timed(lambda: ex_bg.run_many(mv, cts))
        r2, warm = _timed(lambda: ex_bg.run_many(mv, cts))
        bg = pbs_cuda.blind_rotate_fused_bg.launches
        ex_f = port.executor_for(sk, "cuda-fused", device=DEVICE, mesh=mesh)
        r3, cl_s = _timed(lambda: ex_f.run_many(cl, cts))
        if not (np.array_equal(r, mv_res) and np.array_equal(r2, mv_res)
                and np.array_equal(r3, classic_res)) or bg <= 0:
            raise AssertionError(f"serving with the mesh != phase 10, or "
                                 f"blind_rotate_fused_bg launches {bg}")
        _want_bits([port.decrypt(ck, x) for x in r2],
                   [1 - i % 2 for i in range(C)], "run_many with the mesh")
        out["serving"] = {"mv_contents_per_s": C / warm,
                          "phase10_mv_contents_per_s": C / mv_warm,
                          "classic_contents_per_s": C / cl_s,
                          "phase10_classic_contents_per_s": C / classic_s,
                          "cold_s": cold, "blind_rotate_fused_bg": bg}
        print(f"serving {full.name} with the mesh: run_many C={C}, "
              f"multi-value on cuda-bg warm {warm:.3f} s ({C / warm:.2f} "
              f"contents/s; phase 10 {C / mv_warm:.2f}), classic on "
              f"cuda-fused {cl_s:.3f} s ({C / cl_s:.2f}; phase 10 "
              f"{C / classic_s:.2f}); equal to phase 10; "
              f"blind_rotate_fused_bg launches {bg}", flush=True)

        # (c) one 64-bit request on cuda64-bg with the mesh
        name, pattern, _, bit = REQUESTS[0]
        ct64, want64 = results64[name]
        _reset_counts(pbs_cuda)
        res, secs = _timed(lambda: port.has_match(
            sk64, ct64, pattern, fold="tree", device=DEVICE, mesh=mesh))
        bg64 = pbs_cuda.blind_rotate_fused64_bg.launches
        seen64 = port.executor_for(sk64, device=DEVICE,
                                   mesh=mesh).watchdog._seen
        if (not np.array_equal(res, want64) or bg64 <= 0
                or {k[0] for k in seen64} != {"levels"}):
            raise AssertionError(f"64-bit {name} with the mesh != phase 6, "
                                 f"or blind_rotate_fused64_bg launches "
                                 f"{bg64}, or not level by level: {seen64}")
        _want_bits(port.decrypt(ck64, res), bit, f"64-bit {name} with mesh")
        out["request64"] = {"s": secs, "blind_rotate_fused64_bg": bg64}
        print(f"request 64-bit {name} with the mesh on cuda64-bg: {secs:.3f} "
              f"s, equal to phase 6; blind_rotate_fused64_bg launches {bg64}",
              flush=True)

        # (d) tensor parallelism inside one bootstrap
        tp_launches, tp = tp_phase(port, pbs_cuda, full, ck, sk, dk)
        out["tp"] = {"launches": tp_launches, "by_B": tp}
        rows_err, rows = rows_vs_plain(full, dk.bsk, pbs_cuda, plain)

        # (e) the OR-tree at world 1: an encrypted 1 and an encrypted 0
        luts = _bits(np.stack([make_lut_poly(full, lambda v: v),
                               make_lut_poly(full, lut_fn(LUT_OR2))]))
        tree = or_tree_across_devices(dk, mesh)
        _reset_counts(pbs_cuda)
        for b in (1, 0):
            bits = _bits(lwe.encrypt_lwe(full, ck.lwe_key, b, ck.rng)[None])
            got = tree(luts, 1, bits).cpu().numpy().view(np.uint32)[0]
            _want_bits(lwe.decrypt_lwe(full, ck.lwe_key, got), b,
                       f"OR-tree of an encrypted {b}")
        if pbs_cuda.blind_rotate_fused.launches != 2:
            raise AssertionError("the OR-tree at world 1 is one bootstrap")
        print("OR-tree at world 1: an encrypted 1 and an encrypted 0 each "
              "decrypt to themselves (one bootstrap each)", flush=True)

        # (f) the dryrun on phase 2's small keys
        out["dryrun"] = dryrun_multichip(1, keys=small_keys)
    finally:
        dist.destroy_process_group()
    out["phase_s"] = time.perf_counter() - t0
    print(f"phase 17 {out['phase_s']:.1f} s", flush=True)
    return out, (rows_err, rows, tp_launches["external_product_rows"])


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
    from fhe_regex_tpu_torch.ops import pbs as plain
    from fhe_regex_tpu_torch.ops import pbs_cuda
    from fhe_regex_tpu_torch.ops.pbs import blind_rotate, prepare_server_key
    from fhe_regex_tpu_torch.ops.pbs64 import blind_rotate64, stage1_digits64
    from fhe_regex_tpu_torch.ops.pbs_fft import SPECTRAL_PLAN
    from fhe_regex_tpu_torch.params import get_params

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True,
        timeout=60).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    kind = torch.cuda.get_device_name(0)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} on {kind}; "
          f"circuit compiler {_engine()}", flush=True)

    _, build_s = _timed(pbs_cuda.build)
    print(f"kernel build {build_s:.1f} s ({pbs_cuda.library_path().name})",
          flush=True)

    # ---- phase 2: the 32-bit kernel against its plain version ----
    rot0 = pbs_cuda.rotation_launches()
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
    # three rotations enqueued back to back, each step's two kernels
    # chained by programmatic dependent launch: a missing wait would race
    x = _rotation_inputs(full, ck, 8, seed=308)
    args = (full, dk.bsk, x["luts"], x["lut_idx"], x["ms"])
    want = blind_rotate(*args)
    runs = [pbs_cuda.blind_rotate_fused(*args) for _ in range(3)]
    torch.cuda.synchronize()
    for i, got in enumerate(runs):
        errs.append(_max_abs_err(got, want))
        if not torch.equal(got, want):
            raise AssertionError(f"blind_rotate_fused B=8, run {i} of 3 "
                                 f"back to back: kernel != plain")
    print("blind_rotate_fused B=8 three times back to back: each equal to "
          "plain", flush=True)

    # the limb GEMM's launches (phase 2 gives the rotation no spectrum)
    rot1 = pbs_cuda.rotation_launches()
    limb_launches = rot1["fhe_blind_rotate"] - rot0["fhe_blind_rotate"]

    # ---- phase 3: the 32-bit main path, six requests ----
    warm3 = {}
    main_launches, results = main_path(port, pbs_cuda, full, ck, sk,
                                       pbs_cuda.blind_rotate_fused, REQUESTS,
                                       times=warm3)
    rot3 = pbs_cuda.launch_delta(rot1, pbs_cuda.rotation_launches())
    spectral_launches = rot3.pop("fhe_blind_rotate_spectral", 0)
    pair_launches = rot3.pop("spectral_pair", 0)
    if rot3 or spectral_launches != main_launches:
        raise AssertionError(f"main path: blind_rotate_fused launches "
                             f"{main_launches}, spectral {spectral_launches}, "
                             f"limb {rot3}: not every rotation spectral")
    print(f"main path: {spectral_launches} spectral rotations, "
          f"{pair_launches} of them on the cluster pair", flush=True)

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
    e5, e6 = digits3(port, pbs_cuda, small64)
    errs64.append(e5)
    errs64_bg.append(e6)
    full64 = get_params(FULL64)
    ck64, sk64, keygen64_s = _keys(full64)
    print(f"keys {full64.name}: keygen {keygen64_s:.1f} s (0 = cached)",
          flush=True)
    dk64 = prepare_server_key(full64, sk64, DEVICE, "cuda64")
    dk64_bg = prepare_server_key(full64, sk64, DEVICE, "cuda64-bg")
    if dk64_bg.drop64 != (1, 2):
        raise AssertionError(f"cuda64-bg key drop {dk64_bg.drop64}, want "
                             f"(1, 2) at {full64.name}")
    drop = dk64_bg.drop64

    def bg64(*a, **kw):
        return pbs_cuda.blind_rotate_fused64_bg(*a, drop=drop, **kw)

    times64, times64_bg = {}, {}
    errs64.append(kernel_vs_plain(
        "blind_rotate_fused64", full64, pbs_cuda.blind_rotate_fused64,
        blind_rotate64, dk64.bsk, _rotation_inputs(full64, ck64, 37,
                                                   seed=237),
        timed=False)[0])
    for B in (8, 256):
        x = _rotation_inputs(full64, ck64, B, seed=200 + B)
        err, k_s, p_s = kernel_vs_plain(
            "blind_rotate_fused64", full64, pbs_cuda.blind_rotate_fused64,
            blind_rotate64, dk64.bsk, x, timed=True)
        errs64.append(err)
        times64[B] = (k_s, p_s)
        err, k_s, p_s = kernel_vs_plain(
            "blind_rotate_fused64_bg", full64, bg64, blind_rotate64,
            dk64_bg.bsk, x, timed=True)
        errs64_bg.append(err)
        times64_bg[B] = (k_s, p_s)
    args = (full64, dk64_bg.bsk, x["luts"], x["lut_idx"], x["ms"])
    one, one_s = _timed(lambda: bg64(*args, tb=256))
    two, two_s = _timed(lambda: bg64(*args, tb=128))
    whole, whole_s = _timed(lambda: pbs_cuda.blind_rotate_fused64_bg(
        *args, drop=(0, 0)))
    if not (torch.equal(one, two) and torch.equal(one, whole)):
        raise AssertionError("blind_rotate_fused64_bg: tb=256, tb=128 and "
                             "drop (0, 0) outputs differ")
    print(f"blind_rotate_fused64_bg B=256: tb=256 {one_s * 1e3:.3f} ms, "
          f"tb=128 {two_s * 1e3:.3f} ms, drop (0, 0) {whole_s * 1e3:.3f} ms "
          f"(all limb pairs), equal", flush=True)

    # ---- phase 6: the 64-bit main path, six requests on cuda64-bg ----
    main64_bg, results64 = main_path(port, pbs_cuda, full64, ck64, sk64,
                                     pbs_cuda.blind_rotate_fused64_bg,
                                     REQUESTS, warm=False)
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

    # ---- phase 8: the per-step kernels #2 and #1, and the 64-bit digit
    # pass, against plain ----
    s1_err, s1 = digit_pass("stage1_digits", pbs_cuda.stage1_digits,
                            plain.stage1_digits, (small, full), (8, 37, 256),
                            (8, 256, 512), seed=600)
    b23 = dataclasses.replace(small64, name="TEST_PARAMS_64_B23",
                              pbs_base_log=23, pbs_level=1)
    digit_pass("stage1_digits64", pbs_cuda.stage1_digits64, stage1_digits64,
               (b23, full64), (8, 37, 256), (8, 256, 512), seed=700)
    ep_err, steps = step_kernels(full, dk.bsk, pbs_cuda, plain)
    steps_vs_fused(full, ck, dk.bsk, pbs_cuda)

    # ---- phase 9: the batch-grid kernel #4 against plain ----
    rot9 = pbs_cuda.rotation_launches()
    bg = batch_grid(full, ck, dk.bsk, pbs_cuda, blind_rotate)
    bg_launches = (pbs_cuda.rotation_launches()["fhe_blind_rotate_bg"]
                   - rot9["fhe_blind_rotate_bg"])

    # ---- phase 10: the serving path, 32 bits ----
    name, pattern, content, bit = REQUESTS[0]
    _, s1_launches, ep_launches, classic, served = serving(
        port, pbs_cuda, full, ck, sk,
        (name, pattern, content, bit) + results[name])

    # ---- phase 11: the serving path, 64 bits ----
    serving64(port, pbs_cuda, full64, ck64, sk64)

    # ---- phase 12: the daemon, 32 bits, as its own process ----
    daemon(port, full, ck, sk)

    # ---- phase 13: checkpoint and resume on the card ----
    checkpoint_resume(port, full, ck, sk)

    # ---- the 64-bit daemon, in this process ----
    daemon64(port, pbs_cuda, full64, ck64, sk64)

    # ---- phase 14: the FFT backend ----
    fft = fft_backend(port, pbs_cuda, full, ck, sk, dk, results, classic)

    # ---- phase 15: the native circuit compiler == the Python builder ----
    native_equals_python()

    # ---- phase 16: the whole level loop as one CUDA graph ----
    fuse = fused_phase(port, pbs_cuda, full, ck, sk, dk, results, full64,
                       dk64_bg, results64)

    # ---- phase 17: the mesh on the card (NCCL, world 1) ----
    mesh, (rows_err, rows_ms, rows_launches) = mesh_phase(
        port, pbs_cuda, plain, full, ck, sk, dk, sk64, ck64, results, warm3,
        results64, classic, served, (ck_s, sk_s))

    # ---- phase 18: the spectral rotation, its crossover sweep ----
    spectral = spectral_phase(pbs_cuda, full, ck, sk, blind_rotate)
    spec256 = next(r for r in spectral["widths"] if r["B"] == 256)

    def entry(name, source, replaces, launches, err, ms, plain_ms, bound,
              library_ms=None):
        return {"name": name, "route": "cuda",
                "source": f"fhe_regex_tpu_torch/csrc/{source}",
                "replaces": f"fhe_regex_tpu/ops/pbs_pallas.py:{replaces}",
                "launches": launches, "max_abs_err": err, "ms": ms,
                "plain_ms": plain_ms, "bound_ms": bound[0],
                "bound_by": bound[1], "library_ms": library_ms}

    k1, N = full.glwe_dimension + 1, full.polynomial_size
    rows = k1 * full.pbs_level
    B = 256
    L = 2                                  # LUTs of _rotation_inputs
    step_macs = B * rows * k1 * N * N
    kernels = [
        entry("external_product_step", "blind_rotate.cu", 114, ep_launches,
              ep_err, steps[B]["ep"], steps[B]["ep_plain"],
              _bound(2 * step_macs * limb_pairs(full),
                     B * rows * N + rows * k1 * N * 4 + 2 * B * k1 * N * 4),
              library_ms=steps[B]["ep_lib"]),
        entry("external_product_rows", "blind_rotate.cu", 114, rows_launches,
              rows_err, rows_ms[B, rows]["ms"], rows_ms[B, rows]["plain"],
              _bound(2 * step_macs * limb_pairs(full),
                     B * rows * N + rows * k1 * N * 4 + 2 * B * k1 * N * 4),
              library_ms=rows_ms[B, rows]["lib"]),
        entry("stage1_digits", "blind_rotate.cu", 235, s1_launches, s1_err,
              s1[B]["ms"], s1[B]["plain"], s1[B]["bound"]),
        entry("blind_rotate_fused", "blind_rotate.cu", 358, limb_launches,
              max(errs), times[B][0] * 1e3, times[B][1] * 1e3,
              rotation_bound(full, B, L)),
        entry("blind_rotate_fused_bg", "blind_rotate.cu", 713, bg_launches,
              bg["err"], bg["ms"], bg["plain_ms"],
              rotation_bound(full, bg["B"], bg["L"])),
        entry("spectral rotation (cuda-fused, cuda-bg)", "blind_rotate.cu",
              "358,713", spectral_launches, spectral["max_abs_err"],
              float(np.median(spec256["spectral_ms"])), times[B][1] * 1e3,
              fft_rotation_bound(full, B, L, SPECTRAL_PLAN)),
        entry("blind_rotate_fused64", "blind_rotate64.cu", 1196, main64,
              max(errs64), times64[B][0] * 1e3, times64[B][1] * 1e3,
              rotation_bound(full64, B, L)),
        entry("blind_rotate_fused64_bg", "blind_rotate64.cu", 1662,
              main64_bg, max(errs64_bg), times64_bg[B][0] * 1e3,
              times64_bg[B][1] * 1e3, rotation_bound(full64, B, L, drop)),
    ]
    narrow = {name: rotation_bound(p, 8, L, d) for name, p, d in (
        ("blind_rotate_fused", full, (0, 0)),
        ("blind_rotate_fused64", full64, (0, 0)),
        ("blind_rotate_fused64_bg", full64, drop))}
    print(f"bounds at B=8 (ms, by): {narrow}", flush=True)
    print(f"chip_smoke {time.perf_counter() - t_start:.1f} s", flush=True)
    print(json.dumps({"fft": fft}))
    print(json.dumps({"spectral": spectral}))
    print(json.dumps({"mesh": mesh}))
    print(json.dumps({"fuse": fuse}))
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
