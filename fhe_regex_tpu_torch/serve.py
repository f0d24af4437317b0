"""Serving daemon: keep one warm process, match encrypted content over HTTP.

The port of ``fhe_regex_tpu/serve.py``: the expensive state (the server
key uploaded to the CUDA device, the kernels loaded, the compiled pattern
circuits and their device-side level plans) lives in one long-running
process; clients send encrypted content and get the encrypted match bit
back.  The server never holds a client (secret) key: requests carry
ciphertexts only, mirroring the reference's client/server trust split
(SURVEY.md §3.1).

Endpoints (JSON; ciphertext arrays as base64 of the raw little-endian
buffer + shape/dtype), the same as the JAX package's:

  GET  /health            -> {"status": "ok", "params": ..., "backend": ...}
  GET  /stats             -> request counters, per-program circuit stats
                          (bootstraps / rotations / levels per content
                          length), the launch watchdog's per-shape EMA
                          seconds, the per-level timings of the last
                          profiled match ("profile": true on /match), and
                          (the port's own) each CUDA kernel's launches and
                          the counters of the spans below
  POST /compile           {"pattern", "content_len"} -> circuit stats
                          (compiles and caches the circuit for that shape)
  POST /match             {"pattern", "ct": {"b64", "shape", "dtype"},
                           "fold"?, "branch_budget"?}
                          -> {"ct": {...}} encrypted 0/1 radix result
  POST /match_many        same with ct shape [C, len, blocks, n+1]
                          -> {"ct": {...}} with leading C axis
  POST /match_long        {"pattern", "ct", "window"?} — long contents via
                          overlapping windows (has_match_long's answer; the
                          window circuit is a cached program, the OR of
                          the windows' bits runs on the device)
  POST /count             {"pattern", "ct"} — encrypted match count as
                          base-4 digit rows (decrypt with decrypt_count)

Every POST endpoint also accepts "patterns": [...] instead of "pattern" —
the set compiles to ONE shared multi-root circuit (cross-pattern
subexpressions bootstrap once) and the result gains a leading P axis.

Each POST is one request of ``MatchService.recorder`` (``utils/trace.py``)
and opens these spans, outermost first: ``serve.request`` (the handler,
entry to reply written) over ``serve.read`` (the body off the socket),
``serve.decode`` (JSON and base64), ``serve.service`` (the
``MatchService`` call: ``service.lookup``, the program and its circuit,
compiled on a miss; ``service.wait`` for the device lock; the executor's
``executor.*`` spans; on /match_long ``long.or_reduce``, from the first OR
launch to the answer on the host), ``serve.encode`` (base64 and JSON) and
``serve.write`` (headers and body to the socket).  Their seconds are
counters of /stats whether or not the recorder records:

  requests[endpoint]  count, seconds (the whole request, codec included,
                      as the JAX daemon counts it), read_s, decode_s,
                      service_s, encode_s, write_s, bytes_in, bytes_out
  lookup_s, plan_misses   the service's lookups and those that compiled
  wait_s              seconds requests waited for the device lock
  launches_by_width   the executor's steps by the widths of their rotation
                      launches: steps, rows_launched, rows_needed, device_s
                      (``Executor.launches_by_width``; the OR rounds of
                      /match_long under "or")
  long[pattern]       the windowed /match_long requests: requests, chars,
                      windows, window_rows and window_levels (the window
                      plan's rotation rows times the windows, and its
                      levels once a request: the windows run side by
                      side), or_rounds, or_rows (the OR tree's
                      bootstraps) and or_s (the ``long.or_reduce`` span)

All but write_s and seconds are counted before the reply is written.

Run:  python -m fhe_regex_tpu_torch.serve --key server_key.npz --port 8471
(``--device cpu`` for the plain PyTorch path; the default is the CUDA
device, and without one the daemon refuses to start.)
"""

from __future__ import annotations

import argparse
import base64
import contextlib
import json
import logging
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Optional

import numpy as np

from fhe_regex_tpu_torch.utils import trace

logger = logging.getLogger("fhe_regex_tpu_torch.serve")


def encode_array(a: np.ndarray) -> dict:
    a = np.ascontiguousarray(a)
    return {"b64": base64.b64encode(a.tobytes()).decode(),
            "shape": list(a.shape), "dtype": str(a.dtype)}


def decode_array(d: dict) -> np.ndarray:
    raw = base64.b64decode(d["b64"])
    return np.frombuffer(raw, dtype=np.dtype(d["dtype"])).reshape(d["shape"]).copy()


class MatchService:
    """The warm state: key material on the device + compiled circuits.

    ``device`` None means CUDA (a RuntimeError without a card, as at every
    entry point); ``backend`` None is that device's default blind
    rotation (``ops.pbs.resolve_backend``)."""

    def __init__(self, server_key, backend: Optional[str] = None,
                 device=None):
        from fhe_regex_tpu_torch import executor_for
        from fhe_regex_tpu_torch.ops.mv import has_mv_rotation
        from fhe_regex_tpu_torch.ops.pbs import resolve_backend

        self.server_key = server_key
        self.params = server_key.params
        self.backend = backend
        self.executor = executor_for(server_key, backend, device=device)
        self.device = self.executor.device
        # a backend without a multi-value rotation (fft) serves the
        # classic plan where a request leaves the plan to the daemon
        self._auto_mv = has_mv_rotation(
            resolve_backend(backend, self.device, self.params))
        self._lock = threading.Lock()      # one device, serialized matches
        self._programs: dict = {}
        # program construction/compilation is check-then-set on shared
        # dicts — serialize it separately from the device lock so two
        # concurrent requests for a new pattern can't both compile it
        self._compile_lock = threading.Lock()
        # observability (/stats): per-endpoint request counters, the
        # service's own counters, the per-level timing of the last profiled
        # /match (profile: true) and the spans of the requests served
        self._stats_lock = threading.Lock()
        self._requests: dict = {}
        self._counters = {"lookup_s": 0.0, "plan_misses": 0, "wait_s": 0.0}
        self._long: dict = {}
        self._last_profile: Optional[dict] = None
        self.recorder = trace.Recorder()

    def _count_request(self, endpoint: str, counts: dict) -> None:
        """Add ``counts`` (count, seconds, the phases' seconds and bytes)
        to the endpoint's row."""
        with self._stats_lock:
            row = self._requests.setdefault(endpoint, dict.fromkeys(
                ("count", "seconds", "read_s", "decode_s", "service_s",
                 "encode_s", "write_s", "bytes_in", "bytes_out"), 0))
            for k, v in counts.items():
                row[k] += v

    def _circuit(self, pattern, fold, branch_budget, multivalue, positions,
                 content_len: int):
        """The compiled circuit of a request (``service.lookup``)."""
        with trace.Span("service.lookup") as sp:
            prog = self._program(pattern, fold, branch_budget, multivalue,
                                 positions)
            with self._compile_lock:  # per-length circuit cache is shared
                miss = content_len not in prog._circuits
                circuit = prog.circuit(content_len)
        with self._stats_lock:
            self._counters["lookup_s"] += sp.seconds
            self._counters["plan_misses"] += miss
        return circuit

    @contextlib.contextmanager
    def _device(self):
        """The device lock, its wait a ``service.wait`` span."""
        with trace.Span("service.wait") as sp:
            self._lock.acquire()
        try:
            with self._stats_lock:
                self._counters["wait_s"] += sp.seconds
            yield
        finally:
            self._lock.release()

    def stats(self) -> dict:
        """Daemon observability: request counters, every compiled program's
        circuit stats per content length (bootstraps / blind-rotation counts
        / levels), the watchdog's EMA seconds per launch shape, and the
        per-level timings of the last profiled match; beyond the JAX
        daemon's, the counters of the spans (module docstring), the
        launches of each CUDA kernel wrapper in this process
        (``ops.pbs_cuda.launch_counts``: zero on the CPU path), and the CMUX
        steps x rows of the 32-bit fused rotations by path
        (``ops.pbs_cuda.rotation_steps``: spectral or limb)."""
        from fhe_regex_tpu_torch.ops import pbs_cuda

        programs = []
        with self._compile_lock:
            progs = list(self._programs.items())
            for key, prog in progs:
                pat, fold, budget, mv, pos = key
                lengths = {str(L): prog.stats(L)
                           for L in sorted(prog._circuits)}
                programs.append({
                    "pattern": list(pat) if isinstance(pat, tuple) else pat,
                    "fold": fold, "multivalue": mv, "positions": pos,
                    "lengths": lengths,
                })
        with self._stats_lock:
            return {
                "requests": {k: dict(v) for k, v in self._requests.items()},
                **self._counters,
                "launches_by_width": self.executor.launches_by_width(),
                "programs": programs,
                "long": {k: dict(v) for k, v in self._long.items()},
                # per-launch-shape EMA seconds of Executor.run ("levels",
                # or "fused" for a level loop run as one CUDA graph) and
                # run_many ("many"); anomalies are logged as warnings
                "launch_ema_s": self.executor.watchdog.snapshot(),
                "last_profile": self._last_profile,
                "kernel_launches": pbs_cuda.launch_counts(),
                "rotation_steps": pbs_cuda.rotation_steps(),
            }

    def _program(self, pattern, fold: str, branch_budget,
                 multivalue=None, positions: bool = False):
        """pattern: one str -> CompiledPattern; list of str ->
        CompiledPatternSet (one shared multi-root circuit); positions=True
        -> CompiledPositions (one encrypted bit per start offset)."""
        from fhe_regex_tpu_torch.models.patterns import (CompiledPattern,
                                                         CompiledPatternSet,
                                                         CompiledPositions)

        multi = isinstance(pattern, (list, tuple))
        if multi and positions:
            raise ValueError("positions mode takes a single pattern")
        if multivalue is None and not self._auto_mv:
            multivalue = False
        key = (tuple(pattern) if multi else pattern, fold, branch_budget,
               multivalue, positions)
        with self._compile_lock:
            if key not in self._programs:
                cls = (CompiledPositions if positions
                       else CompiledPatternSet if multi else CompiledPattern)
                self._programs[key] = cls(
                    pattern, params=self.params, fold=fold,
                    branch_budget=branch_budget, multivalue=multivalue)
            return self._programs[key]

    def compile(self, pattern, content_len: int, fold: str = "tree",
                branch_budget=None, multivalue=None,
                positions: bool = False) -> dict:
        prog = self._program(pattern, fold, branch_budget, multivalue,
                             positions)
        with self._compile_lock:      # per-length circuit cache is shared
            return prog.stats(content_len)

    def warmup(self, manifest) -> list:
        """Compile and run the production shapes before the port opens.

        manifest: list of entries {"pattern": str | "patterns": [str],
        "content_len": int, "fold"?, "branch_budget"?, "multivalue"?,
        "positions"?, "many"?: int, "long"?: bool, "window"?: int}.  For
        each entry the program is compiled AND one trivial-ciphertext match
        is executed: the first run of a circuit uploads its level plans to
        the device (and the first run in the process loads the kernels),
        which a client's first request would otherwise pay.  "many": C also
        runs the packed run_many plan at batch C.  "long": true runs
        /match_long's path instead of /match: the window circuit, its
        packed plan at the batch of one content's windows and the OR tree
        of that many bits.  Returns per-entry timings."""
        from fhe_regex_tpu_torch import trivial_encrypt_str

        report = []
        for entry in manifest:
            t0 = time.time()
            pat = entry.get("patterns", entry.get("pattern"))
            L = int(entry["content_len"])
            fold = entry.get("fold", "tree")
            budget = entry.get("branch_budget")
            mv = entry.get("multivalue")
            mv = None if mv is None else bool(mv)
            pos = bool(entry.get("positions", False))
            ct = trivial_encrypt_str(self.params, "a" * L)
            if entry.get("long"):
                self.match_long(pat, ct, entry.get("window"), fold, budget,
                                mv)
            else:
                self.match(pat, ct, fold, budget, mv, pos)
            row = {"pattern": pat, "content_len": L, "seconds":
                   round(time.time() - t0, 2)}
            if entry.get("long"):
                row["long"] = True
            C = int(entry.get("many", 0))
            if C > 0:
                t1 = time.time()
                cts = np.broadcast_to(ct, (C,) + ct.shape)
                self.match_many(pat, cts, fold, budget, mv, pos)
                row["many"] = C
                row["many_seconds"] = round(time.time() - t1, 2)
            logger.info("warmup %r len=%d: %.1fs%s", pat, L, row["seconds"],
                        f" (+many[{C}] {row.get('many_seconds')}s)"
                        if C else "")
            report.append(row)
        return report

    def match(self, pattern, ct: np.ndarray, fold: str = "tree",
              branch_budget=None, multivalue=None,
              positions: bool = False, profile: bool = False) -> np.ndarray:
        circuit = self._circuit(pattern, fold, branch_budget, multivalue,
                                positions, len(ct))
        with self._device():
            out = self.executor.run(circuit, np.ascontiguousarray(ct),
                                    profile=profile)
        if profile:
            with self._stats_lock:
                self._last_profile = {
                    "pattern": pattern if isinstance(pattern, str)
                    else list(pattern),
                    "content_len": int(len(ct)),
                    "levels": self.executor.last_run_stats,
                    "p_fail": self.executor.last_run_pfail,
                }
        return out

    def match_many(self, pattern, cts: np.ndarray, fold: str = "tree",
                   branch_budget=None, multivalue=None,
                   positions: bool = False) -> np.ndarray:
        circuit = self._circuit(pattern, fold, branch_budget, multivalue,
                                positions, cts.shape[1])
        with self._device():
            return self.executor.run_many(circuit, np.ascontiguousarray(cts))

    def count(self, pattern: str, ct: np.ndarray, fold: str = "tree",
              branch_budget=None) -> np.ndarray:
        """Encrypted match count (count_matches): base-4 digit rows."""
        from fhe_regex_tpu_torch import count_matches

        if isinstance(pattern, (list, tuple)):
            raise ValueError("/count takes a single \"pattern\"")
        with self._device():
            return count_matches(self.server_key, ct, pattern, fold=fold,
                                 branch_budget=branch_budget,
                                 backend=self.backend, device=self.device)

    def match_long(self, pattern: str, ct: np.ndarray, window=None,
                   fold: str = "tree", branch_budget=None,
                   multivalue=None) -> np.ndarray:
        """Windowed long-content match: ``has_match_long``'s answer, bit for
        bit.  The window circuit is the pattern's program at the window's
        length (``service.lookup``: compiled once, its plans uploaded at
        its first run); the windows run packed and their bits OR-reduce on
        the device (``_match_windows``), and the request adds to /stats
        ``long``.  A content the windows cannot help takes the program of
        the direct circuit, as ``match``."""
        from fhe_regex_tpu_torch import (_long_layout, _match_windows,
                                         _no_match, _resolve_multivalue)

        if isinstance(pattern, (list, tuple)):
            raise ValueError("/match_long takes a single \"pattern\" "
                             "(pattern sets are not windowed)")
        ct = np.ascontiguousarray(ct)
        layout = _long_layout(pattern, ct.shape[0], window)
        if layout[0] == "false":
            return _no_match(self.params, 1)[0]
        if layout[0] == "direct":
            return self.match(pattern, ct[layout[1]:layout[2]], fold,
                              branch_budget, _resolve_multivalue(multivalue))
        _, W, starts = layout
        circuit = self._circuit(pattern, fold, branch_budget,
                                _resolve_multivalue(multivalue, packed=True),
                                False, W)
        with self._device():
            out, or_s = _match_windows(self.executor, circuit, ct[None], W,
                                       starts)
        tree = self.executor.or_tree(len(starts))
        with self._stats_lock:
            row = self._long.setdefault(pattern, dict.fromkeys(
                ("requests", "chars", "windows", "window_rows",
                 "window_levels", "or_rounds", "or_rows", "or_s"), 0))
            row["requests"] += 1
            row["chars"] += int(ct.shape[0])
            row["windows"] += len(starts)
            row["window_rows"] += circuit.rotation_count * len(starts)
            row["window_levels"] += len(circuit.levels)
            row["or_rounds"] += len(tree.rounds)
            row["or_rows"] += tree.rows
            row["or_s"] += or_s
        return out[0]


# the POST endpoints whose request carries a ciphertext array "ct"
CT_ENDPOINTS = ("/match", "/match_many", "/match_long", "/count")


def make_handler(service: MatchService):
    class Handler(BaseHTTPRequestHandler):
        def _send(self, code: int, body: bytes):
            self.send_response(code)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def _reply(self, code: int, obj: dict):
            self._send(code, json.dumps(obj).encode())

        def log_message(self, fmt, *args):
            logger.debug("%s " + fmt, self.client_address[0], *args)

        def do_GET(self):
            if self.path == "/health":
                from fhe_regex_tpu_torch.ops.pbs import resolve_backend
                self._reply(200, {
                    "status": "ok",
                    "params": service.params.name,
                    "backend": resolve_backend(service.backend,
                                               service.device,
                                               service.params),
                })
            elif self.path == "/stats":
                self._reply(200, service.stats())
            else:
                self._reply(404, {"error": "unknown path"})

        def do_POST(self):
            with service.recorder.request() as rq:
                try:
                    self._post(rq)
                except Exception as e:   # surface as a clean client error
                    logger.warning("%s failed", self.path, exc_info=True)
                    self._reply(400, {"error": f"{type(e).__name__}: {e}"})

        def _post(self, rq: trace.Span):
            n = int(self.headers.get("Content-Length", "0"))
            with trace.Span("serve.read") as read:
                raw = self.rfile.read(n)
            with trace.Span("serve.decode") as decode:
                req = json.loads(raw or b"{}")
                fold = req.get("fold", "tree")
                budget = req.get("branch_budget")
                # multivalue: true/false forces the plan; absent/null = auto
                # (keep the shared-rotation plan when its rotation savings
                # clear MV_AUTO_MIN_SAVINGS)
                mv = req.get("multivalue")
                mv = None if mv is None else bool(mv)
                pos = bool(req.get("positions", False))
                # "pattern": one str; "patterns": list -> one shared
                # multi-root circuit, result gains a leading P axis;
                # "positions": true -> one bit per start offset instead
                pat = (req["patterns"] if "patterns" in req
                       else req["pattern"])
                ct = (decode_array(req["ct"]) if self.path in CT_ENDPOINTS
                      else None)
            with trace.Span("serve.service") as served:
                if self.path == "/compile":
                    out = service.compile(pat, int(req["content_len"]),
                                          fold, budget, mv, pos)
                elif self.path == "/match":
                    out = service.match(pat, ct, fold, budget, mv, pos,
                                        profile=bool(req.get("profile",
                                                             False)))
                elif self.path == "/match_many":
                    out = service.match_many(pat, ct, fold, budget, mv, pos)
                elif self.path == "/match_long":
                    if pos:
                        raise ValueError(
                            "positions is not supported on /match_long")
                    out = service.match_long(pat, ct, req.get("window"),
                                             fold, budget, mv)
                elif self.path == "/count":
                    out = service.count(pat, ct, fold, budget)
                else:
                    out = None
            code = 404 if out is None else 200
            with trace.Span("serve.encode") as encode:
                body = json.dumps(
                    {"error": "unknown path"} if out is None
                    else out if self.path == "/compile"
                    else {"ct": encode_array(out)}).encode()
            service._count_request(self.path, {
                "count": 1, "read_s": read.seconds, "bytes_in": len(raw),
                "decode_s": decode.seconds, "service_s": served.seconds,
                "encode_s": encode.seconds, "bytes_out": len(body)})
            with trace.Span("serve.write") as write:
                self._send(code, body)
            service._count_request(self.path, {
                "write_s": write.seconds,
                "seconds": (time.time_ns() - rq.start_ns) / 1e9})

    return Handler


def make_server(service: MatchService, host: str = "127.0.0.1",
                port: int = 8471) -> ThreadingHTTPServer:
    return ThreadingHTTPServer((host, port), make_handler(service))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="fhe-regex-tpu-torch-serve")
    ap.add_argument("--params", default=None)
    ap.add_argument("--key", default=None,
                    help=".npz with bsk/ksk arrays (the key-cache format); "
                         "default: generate from --seed")
    ap.add_argument("--seed", type=int, default=None)
    ap.add_argument("--backend", default=None)
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda; the daemon refuses "
                         "to start without a CUDA device unless given "
                         "--device cpu)")
    ap.add_argument("--host", default="127.0.0.1")
    ap.add_argument("--port", type=int, default=8471)
    ap.add_argument("--warmup", default=None, metavar="MANIFEST.json",
                    help="compile and run these shapes before the port "
                         "opens: JSON list of {pattern|patterns, "
                         "content_len, fold?, multivalue?, many?}")
    ap.add_argument("--warmup-pattern", default=None,
                    help="shorthand: warm ONE pattern at --warmup-len "
                         "before serving")
    ap.add_argument("--warmup-len", type=int, default=64)
    args = ap.parse_args(argv)

    logging.basicConfig(level="INFO")
    from fhe_regex_tpu_torch import gen_keys, get_params
    from fhe_regex_tpu_torch.crypto.keys import ServerKey

    params = get_params(args.params)
    if args.key:
        with np.load(args.key) as z:
            sk = ServerKey(params=params, bsk=z["bsk"], ksk=z["ksk"])
    else:
        logger.info("generating keys (%s)...", params.name)
        _, sk = gen_keys(params, seed=args.seed)
    service = MatchService(sk, backend=args.backend, device=args.device)
    manifest = []
    if args.warmup:
        with open(args.warmup) as f:
            manifest = json.load(f)
    if args.warmup_pattern:
        manifest.append({"pattern": args.warmup_pattern,
                         "content_len": args.warmup_len})
    if manifest:
        t0 = time.time()
        logger.info("warming %d shapes before opening the port..",
                    len(manifest))
        service.warmup(manifest)
        logger.info("warmup done in %.1fs", time.time() - t0)
    srv = make_server(service, args.host, args.port)
    logger.info("serving %s on %s:%d (%s)", params.name, args.host, args.port,
                service.device)
    srv.serve_forever()
    return 0


if __name__ == "__main__":
    import sys
    sys.exit(main())
