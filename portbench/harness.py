"""One run of one cell: keys, the daemon, the window, the check, metrics.

Everything that belongs to one configuration, traffic mix or metric is a
file found by its name in ``BENCHMARK.json``: ``configs/<config>.json``,
``mixes/<traffic>.json`` and ``metrics/<metric>.py`` (a reader with
``read(rec) -> float | None``; a metric ``<name>.<variant>`` without a
file of its own is read by ``metrics/<name>.py``).  This module names
none of them.
"""

from __future__ import annotations

import importlib.util
import json
import sys
import time
from pathlib import Path

import numpy as np

HERE = Path(__file__).resolve().parent
CHECKOUT = HERE.parent
FORBIDDEN = frozenset({"jax", "jaxlib", "flax", "fhe_regex_tpu"})
# A traced run traces the last TRACE_SECONDS of its window, which it
# extends until that much has been traced: stopping the profiler takes
# about 3 s per second traced on the narrow levels of /match (two kernels
# a CMUX step), starting it up to 10 s, and a run must end within 360 s.
TRACE_SECONDS = 12


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def workload(spec: dict, name: str) -> dict:
    for w in spec["workloads"]:
        if w["name"] == name:
            return w
    raise KeyError(f"no workload {name!r} in BENCHMARK.json")


def cell_metrics(spec: dict, cell: str, trace: bool) -> list:
    """The metrics a run of ``cell`` reports: the end-to-end ones untraced,
    the per-layer ones traced; a metric with a "workloads" list only in
    those cells."""
    group = spec["per_layer"] if trace else spec["end_to_end"]
    return [m for m in group if cell in m.get("workloads", [cell])]


def reader(name: str):
    path = HERE / "metrics" / f"{name}.py"
    if not path.exists() and "." in name:
        path = HERE / "metrics" / f"{name.rsplit('.', 1)[0]}.py"
    spec = importlib.util.spec_from_file_location(
        f"portbench.metrics.{name}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def forbidden_modules() -> list:
    """Top-level names of loaded modules that the run must not load."""
    return sorted({m.split(".")[0] for m in list(sys.modules)} & FORBIDDEN)


def port_params(cfg: dict):
    """The program's parameter set of the configuration's name, checked
    field by field against the configuration file."""
    from fhe_regex_tpu_torch.params import get_params

    from portbench.tfhe import PARAM_FIELDS

    pp = get_params(cfg["params"]["name"])
    for f in PARAM_FIELDS:
        if getattr(pp, f) != cfg["params"][f]:
            raise ValueError(f"{pp.name}.{f} is {getattr(pp, f)}, the "
                             f"configuration states {cfg['params'][f]}")
    return pp


def run_cell(spec: dict, cell: str, seed: int, seconds: float, trace: bool,
             device: str, t_start: float, data_dir: Path = HERE,
             key_transform=None) -> dict:
    """Run ``cell`` once; -> the result object (without the import check,
    which the caller makes once everything is closed)."""
    import torch

    from fhe_regex_tpu_torch.crypto.keys import ServerKey

    from portbench import reference, tfhe
    from portbench.client import Client
    from portbench.daemon import Daemon
    from portbench.traffic import Traffic

    w = workload(spec, cell)
    cfg = load_json(data_dir / "configs" / f"{w['config']}.json")
    mix = load_json(data_dir / "mixes" / f"{w['traffic']}.json")
    params = tfhe.Params.from_config(cfg)
    seed = seed % (1 << 63)

    marks = [("start", t_start), ("imports", time.time())]
    # the client's keys: made from the seed on the device, handed to the
    # server as numpy words; client work, so neither in setup_s nor in the
    # device's peak, which starts from what the server holds
    client_key, bsk, ksk = tfhe.gen_keys(params, seed, device)
    if key_transform is not None:
        bsk = key_transform(params, bsk)
    keygen_s = time.time() - marks[-1][1]
    marks.append(("keys", time.time()))
    if torch.device(device).type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    print(f"keygen {params.name} seed {seed}: {keygen_s:.3f} s on {device} "
          f"(client work, not in setup_s)", flush=True)
    daemon = Daemon(ServerKey(params=port_params(cfg), bsk=bsk, ksk=ksk),
                    cfg["backend"], device)
    marks.append(("service", time.time()))
    daemon.warm(mix, params)
    marks.append(("warm-up", time.time()))
    port = daemon.open()
    marks.append(("port", time.time()))
    print(f"set-up of {cell} at seed {seed}: " + ", ".join(
        f"{b[0]} {b[1] - a[1]:.3f} s" for a, b in zip(marks, marks[1:])),
        flush=True)
    client = Client(port)
    traffic = Traffic(mix, seed)
    requests, spans, replies = [], [], []
    dev = None
    try:
        health = client.call("GET", "/health")
        stats_before = client.call("GET", "/stats") if trace else None
        enc_rng = np.random.default_rng([seed, 2])
        setup_s, lo, traced_from = None, None, None
        while True:
            elapsed = 0 if lo is None else time.time_ns() - lo
            if trace and dev is None and \
                    elapsed >= (seconds - TRACE_SECONDS) * 1e9:
                from portbench.tracing import DeviceTrace
                dev = DeviceTrace(device).__enter__()
                traced_from = len(requests)
            req = traffic.next()
            e0 = time.time_ns()
            cts = tfhe.encrypt_contents(client_key, req.contents, enc_rng)
            spans.append(("client.encrypt", e0, time.time_ns()))
            if setup_s is None:
                setup_s = time.time() - t_start - keygen_s
            n_service = len(daemon.service.spans)
            out, a, b = client.match(req, cts, spans)
            lo = a if lo is None else lo
            served = daemon.service.spans[n_service:]
            requests.append({
                "shape": req.shape, "pattern": req.pattern, "fold": req.fold,
                "content_len": len(req.contents[0]),
                "contents": req.contents, "start_ns": a,
                "seconds": (b - a) / 1e9,
                "service_s": (sum(e - s for _, s, e in served) / 1e9
                              if out is not None else None)})
            replies.append(out)
            if b - lo >= seconds * 1e9 and (dev is None or (
                    b - requests[traced_from]["start_ns"]
                    >= min(seconds, TRACE_SECONDS) * 1e9)):
                hi = b
                break
        if dev is not None:
            dev.__exit__(None, None, None)
        stats_after = client.call("GET", "/stats") if trace else None
    finally:
        daemon.close()
    peak = (torch.cuda.max_memory_allocated(device)
            if torch.device(device).type == "cuda" else 0)
    spans += daemon.service.spans

    # the check: every reply against the reference, after the window
    failed = sum(r is None for r in replies)
    cts, want, malformed = [], [], 0
    C = int(mix["batch"])
    for req, out in zip(requests, replies):
        if out is None:
            continue
        shape = ((C,) if mix["endpoint"] == "/match_many" else ()) + (
            params.num_blocks, params.lwe_dimension + 1)
        if out.shape != shape or out.dtype != params.word:
            malformed += len(req["contents"])
            continue
        cts.append(out.reshape(-1, params.num_blocks,
                               params.lwe_dimension + 1))
        want += [reference.expected_bit(req["pattern"], c)
                 for c in req["contents"]]
    cts = (np.concatenate(cts) if cts else
           np.zeros((0, params.num_blocks, params.lwe_dimension + 1)))
    got = reference.check(tfhe.phases(client_key, cts), np.asarray(want),
                          cts)
    got["wrong_answers"] += malformed
    limits = cfg["checks"]
    checks = {"failed_requests": {"value": failed, "limit": 0}}
    for name in ("wrong_answers", "duplicate_replies", "phase_gap",
                 "phase_var"):
        checks[name] = {"value": got[name], "limit": limits[name]}
    correct = bool(requests) and all(c["value"] <= c["limit"]
                                     for c in checks.values())
    hits = sum(want)

    rec = {"params": params, "setup_seconds": setup_s,
           "window_s": (hi - lo) / 1e9, "requests": requests,
           "stats_before": stats_before, "stats_after": stats_after,
           "trace": None}
    result = {"correct": correct, "attempted": len(requests),
              "failed": failed, "metrics": {}, "device": device_info(
                  device, peak)}
    if dev is not None:
        from portbench.tracing import summarize
        rec["trace"] = summarize(dev.device_events(),
                                 requests[traced_from]["start_ns"], hi, spans)
        rec["trace"]["first"] = traced_from
        result["device"]["busy_s"] = rec["trace"]["busy_s"]
        result["device"]["window_s"] = rec["trace"]["window_s"]
        result["breakdown"] = {k: rec["trace"][k]
                               for k in ("device_ops", "idle_gaps")}
    for m in cell_metrics(spec, cell, trace):
        v = reader(m["name"])(rec)
        if v is not None:
            result["metrics"][m["name"]] = {"value": v, "unit": m["unit"]}
    result["checks"] = checks
    print(f"served {health.get('backend')} at {health.get('params')}: "
          f"{len(requests)} requests, {sum(len(r['contents']) for r in requests)}"
          f" contents ({hits} matching) in {rec['window_s']:.3f} s; "
          + "; ".join(f"{s} {_median(requests, s):.4f} s"
                      for s in traffic.shapes()), flush=True)
    return result


def _median(requests, shape) -> float:
    xs = sorted(r["seconds"] for r in requests if r["shape"] == shape)
    return xs[len(xs) // 2] if xs else float("nan")


def device_info(device: str, peak: int) -> dict:
    import torch

    if torch.device(device).type != "cuda":
        return {"platform": "cpu", "kind": "cpu", "count": 0,
                "memory_peak_bytes": 0}
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(device),
            "count": 1, "memory_peak_bytes": int(peak)}
