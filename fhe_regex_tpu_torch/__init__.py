"""fhe-regex-tpu-torch: encrypted regex matching on PyTorch and CUDA.

The PyTorch port of ``fhe_regex_tpu``, with the same public surface for the
main path, ``gen_keys -> encrypt_str -> has_match -> decrypt``, and the
serving paths: many contents (``has_match_many``), many patterns, match
positions, long contents in windows, and match counts.  The result of
``has_match`` is an encrypted 0/1 only the client key opens.  Device work
runs on the ``device`` given: CUDA by default (a RuntimeError if there is
none), or ``device="cpu"`` for the plain PyTorch path.  On CUDA the blind
rotation is a hand-written kernel of ``ops/pbs_cuda.py``.  Both torus widths
run: 32 bits (``TPU_MESSAGE_2_CARRY_2``, the default) and 64 bits
(``TPU64_MESSAGE_2_CARRY_2``), where ciphertexts are uint64.

Multi-value bootstrapping (``ops/mv.py``: ops sharing an input share one
blind rotation) follows the JAX package's defaults: ``multivalue=None``
picks it automatically on the packed paths when it saves enough rotations
(``_compile_auto_mv``) and means the classic plan elsewhere;
``multivalue=True`` / ``False`` force either plan.

``mesh=`` (a ``parallel.mesh.make_mesh`` mesh, one process per card) on
``executor_for``, ``has_match``, ``run_circuit``, ``has_match_patterns`` and
``has_match_positions`` shards each level's bootstraps over the mesh's
ranks, as the JAX package's ``mesh=`` does; every rank calls the entry
point with the same arguments and gets the same result.
"""

from __future__ import annotations

import logging
from typing import Optional

import numpy as np
import torch

from fhe_regex_tpu_torch.params import Params, get_params
from fhe_regex_tpu_torch.crypto.keys import (
    ClientKey,
    ServerKey,
    gen_keys,
    load_client_key,
    save_client_key,
    server_key_from_client,
)
from fhe_regex_tpu_torch.crypto import lwe as _lwe
from fhe_regex_tpu_torch.regex.circuit import CircuitBuilder, Node
from fhe_regex_tpu_torch.regex.engine import BranchBudgetExceeded, compile_match
from fhe_regex_tpu_torch.regex.executor import (CompiledCircuit, Executor,
                                                MvMarginError,
                                                active_bsk_drop,
                                                compile_circuit,
                                                default_min_bucket)
from fhe_regex_tpu_torch.ops.mv import has_mv_rotation
from fhe_regex_tpu_torch.ops.pbs import prepare_server_key, resolve_backend
from fhe_regex_tpu_torch.utils import trace

__all__ = [
    "Params",
    "get_params",
    "ClientKey",
    "ServerKey",
    "gen_keys",
    "server_key_from_client",
    "save_client_key",
    "load_client_key",
    "encrypt_str",
    "trivial_encrypt_str",
    "has_match",
    "has_match_many",
    "has_match_patterns",
    "has_match_many_patterns",
    "has_match_positions",
    "has_match_many_positions",
    "has_match_long",
    "has_match_many_long",
    "count_matches",
    "decrypt_count",
    "decrypt",
    "compile_match",
    "BranchBudgetExceeded",
    "compile_circuit",
    "CompiledCircuit",
    "Executor",
    "CircuitBuilder",
    "Node",
    "executor_for",
    "run_circuit",
]

logger = logging.getLogger("fhe_regex_tpu_torch")


def _resolve_device(device: "torch.device | str | None",
                    mesh=None) -> torch.device:
    """``device=None`` means CUDA; without a CUDA device that raises, so the
    plain CPU path runs only when asked for.  With a mesh the device is
    this rank's (its card under NCCL, the CPU under gloo), and a device
    that names another raises ValueError."""
    if device is not None:
        dev = torch.device(device)
    elif not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: the port runs on CUDA by default; "
                           "pass device=\"cpu\" to run its plain PyTorch "
                           "path on the CPU")
    else:
        dev = torch.device("cuda")
    if mesh is None:
        return dev
    from fhe_regex_tpu_torch.parallel.mesh import indexed, mesh_device

    want = mesh_device(mesh)
    if dev.type == want.type == "cuda":
        dev = indexed(dev)
    if dev != want:
        raise ValueError(f"device {dev} is not this rank's device under the "
                         f"mesh ({want})")
    return want


def _min_bucket(mesh) -> int:
    """Smallest level width: at least the mesh size, so every level
    splits into one row block per rank (as in the JAX package)."""
    b = default_min_bucket()
    return b if mesh is None else max(b, mesh.size())


def _resolve_multivalue(multivalue: Optional[bool],
                        packed: bool = False) -> Optional[bool]:
    """multivalue default: explicit arg > FHE_REGEX_MULTIVALUE env > auto,
    as the JAX package resolves it.

    The multi-value plan shares blind rotations between ops with identical
    inputs: fewer rotations, identical decrypted results.  On the PACKED
    serving paths (levels packed across contents) time follows the
    rotation count, so there it is chosen automatically (None: decide
    from the compiled circuit, ``_compile_auto_mv``); elsewhere the default
    is the classic plan."""
    import os

    if multivalue is not None:
        return bool(multivalue)
    env = os.environ.get("FHE_REGEX_MULTIVALUE")
    if env == "1":
        return True
    if env == "0":
        return False
    return None if packed else False


# Minimum fraction of blind rotations a compiled circuit must save for the
# packed serving paths to choose the multi-value plan (the JAX package's
# value).  Env override: FHE_REGEX_MV_MIN_SAVINGS.
MV_AUTO_MIN_SAVINGS = 0.15


def _compile_auto_mv(params: Params, builder, roots, multivalue, **kw):
    """compile_circuit with the packed-path multivalue auto-default.

    multivalue True/False compiles that plan directly.  None ("auto")
    compiles the multi-value plan first and keeps it when the rotation
    savings clear MV_AUTO_MIN_SAVINGS; otherwise (also when a LUT factor
    fails the >=5 sigma margin check) compiles classic."""
    import os

    if multivalue is not None:
        return compile_circuit(params, builder, roots, multivalue=multivalue,
                               **kw)
    try:
        mv_c = compile_circuit(params, builder, roots, multivalue=True, **kw)
    except MvMarginError as e:
        logger.info("mv auto: falling back to classic plan (%s)", e)
        return compile_circuit(params, builder, roots, multivalue=False, **kw)
    raw = os.environ.get("FHE_REGEX_MV_MIN_SAVINGS")
    try:
        threshold = (float(raw) if raw is not None
                     else MV_AUTO_MIN_SAVINGS)
    except ValueError:
        logger.warning("bad FHE_REGEX_MV_MIN_SAVINGS=%r; using default %.2f",
                       raw, MV_AUTO_MIN_SAVINGS)
        threshold = MV_AUTO_MIN_SAVINGS
    pbs = mv_c.pbs_count
    if pbs and (1.0 - mv_c.rotation_count / pbs) >= threshold:
        return mv_c
    return compile_circuit(params, builder, roots, multivalue=False, **kw)


def _compile(server_key: ServerKey, builder, roots, backend, device,
             multivalue: Optional[bool], packed: bool,
             mesh=None) -> CompiledCircuit:
    """An entry point's circuit: the plan ``multivalue`` resolves to (auto
    on the packed paths, classic where the backend has no multi-value
    rotation), its noise margin checked at the key drop of the backend
    that will run it, its levels at least the mesh size wide."""
    params = server_key.params
    device = _resolve_device(device, mesh)
    kw = dict(min_bucket=_min_bucket(mesh),
              bsk_drop=active_bsk_drop(params, backend, device))
    mv = _resolve_multivalue(multivalue, packed)
    if packed:
        # auto on a backend without a multi-value rotation (fft) is the
        # classic plan; the JAX package compiles multi-value and then
        # refuses to run it
        if mv is None and not has_mv_rotation(
                resolve_backend(backend, device, params)):
            mv = False
        return _compile_auto_mv(params, builder, roots, mv, **kw)
    return compile_circuit(params, builder, roots, multivalue=mv, **kw)


def encrypt_str(client_key: ClientKey, s: str) -> np.ndarray:
    """ASCII string -> [len, num_blocks, n+1] uint32 (ciphertext.rs:32-40)."""
    if not s.isascii():
        raise ValueError("content contains non-ascii characters")
    p = client_key.params
    if not s:
        return np.zeros((0, p.num_blocks, p.lwe_dimension + 1), np.uint32)
    return np.stack(
        [_lwe.encrypt_byte(p, client_key.lwe_key, b, client_key.rng)
         for b in s.encode("ascii")]
    )


def trivial_encrypt_str(params: Params, s: str) -> np.ndarray:
    """Noiseless content encoding — the reference's test fast path
    (create_trivial_radix per byte, engine.rs:282-286)."""
    if not s.isascii():
        raise ValueError("content contains non-ascii characters")
    if not s:
        return np.zeros((0, params.num_blocks, params.lwe_dimension + 1), np.uint32)
    return np.stack([_lwe.trivial_byte(params, b) for b in s.encode("ascii")])


def executor_for(server_key: ServerKey, backend: Optional[str] = None,
                 mesh=None,
                 device: "torch.device | str | None" = None) -> Executor:
    """A (cached) Executor bound to this server key's material on `device`
    (None: CUDA, a RuntimeError without one; "cpu" for the plain path).
    With ``mesh`` it shards each level over the mesh's ranks, on this
    rank's device.

    Executors are cached on the key per (backend, device, mesh), so
    repeated calls reuse the device upload.  Run a custom circuit with
    ``executor.run(compile_circuit(params, builder, root), ct_content)``
    (under a mesh, with ``min_bucket`` at least the mesh size).
    """
    from fhe_regex_tpu_torch.params import warn_if_unsafe

    warn_if_unsafe(server_key.params, "executor_for")
    device = _resolve_device(device, mesh)
    backend = resolve_backend(backend, device, server_key.params)
    cache = server_key.__dict__.setdefault("_torch_executors", {})
    # the cached Executor holds the mesh, so its id stays this mesh's
    key = (backend, str(device), None if mesh is None else id(mesh))
    if key not in cache:
        dev_key = prepare_server_key(server_key.params, server_key, device,
                                     backend)
        cache[key] = Executor(server_key.params, dev_key, mesh=mesh)
    return cache[key]


def _native(engine: Optional[str]) -> bool:
    """Whether ``engine`` selects the C++ circuit compiler
    (native/circuit.cpp): 'native', or None when its library is built
    (``regex.native.default_engine``); 'python' is regex/engine.py.  Both
    give the same circuit, op for op."""
    from fhe_regex_tpu_torch.regex.native import default_engine

    return (engine or default_engine()) == "native"


def _compile_single(params: Params, content_len: int, pattern: str,
                    fold: str, engine: Optional[str],
                    branch_budget: Optional[int]):
    """(builder, root) of one pattern from the compiler ``engine`` picks."""
    from fhe_regex_tpu_torch.regex.native import compile_match_native

    compile_fn = compile_match_native if _native(engine) else compile_match
    return compile_fn(content_len, pattern, num_blocks=params.num_blocks,
                      fold=fold, branch_budget=branch_budget)


def has_match(server_key: ServerKey, ct_content: np.ndarray, pattern: str,
              backend: Optional[str] = None, mesh=None,
              fold: str = "reference",
              engine: Optional[str] = None,
              branch_budget: Optional[int] = None,
              multivalue: Optional[bool] = None,
              device: "torch.device | str | None" = None) -> np.ndarray:
    """Encrypted match: does `pattern` match the encrypted content?

    Mirrors ``engine::has_match`` (engine.rs:8-42): returns a radix
    ciphertext encrypting 1 (match) or 0 (no match), uint32 or uint64 by
    the torus width.  ``backend`` selects the blind rotation ('torch' /
    'torch64' plain paths, 'cuda-fused' / 'cuda-bg' / 'cuda' / 'cuda64' /
    'cuda64-bg' kernels, None = the width's default kernel on CUDA
    devices, see ``ops.pbs.resolve_backend``); ``fold='tree'`` replaces the
    reference's sequential OR fold with a log-depth tree (same decrypted
    result, far lower latency); ``engine`` selects the circuit compiler
    ('python' / 'native' C++ / None = native if built; both give the same
    circuit); ``branch_budget`` bounds variant expansion with a clean
    BranchBudgetExceeded; ``multivalue=True`` shares blind rotations
    between ops with the same input (default: the classic plan, or
    FHE_REGEX_MULTIVALUE=1); ``mesh`` shards each level's bootstraps
    across the mesh's ranks (``parallel/mesh.py``).
    """
    builder, root = _compile_single(server_key.params, len(ct_content),
                                    pattern, fold, engine, branch_budget)
    circuit = _compile(server_key, builder, root, backend, device,
                       multivalue, packed=False, mesh=mesh)
    executor = executor_for(server_key, backend, mesh, device=device)
    result = executor.run(circuit, np.ascontiguousarray(ct_content))
    logger.info(
        "%d ciphertext operations, %d cache hits (%d bootstraps in %d levels)",
        circuit.ct_ops, circuit.cache_hits, circuit.pbs_count, len(circuit.levels),
    )
    return result


def _contents4(ct_contents) -> np.ndarray:
    contents = np.ascontiguousarray(ct_contents)
    if contents.ndim != 4:
        raise ValueError("expected [C, len, num_blocks, n+1] contents")
    return contents


def has_match_many(server_key: ServerKey, ct_contents, pattern: str,
                   backend: Optional[str] = None, fold: str = "tree",
                   engine: Optional[str] = None,
                   branch_budget: Optional[int] = None,
                   wide_batch: Optional[bool] = None,
                   multivalue: Optional[bool] = None,
                   device: "torch.device | str | None" = None) -> np.ndarray:
    """Match one pattern against many equal-length encrypted contents.

    The serving path: the compiled circuit is shared and every level's
    bootstrap batch spans all contents (``Executor.run_many``).  Returns
    [C, num_blocks, n+1].  ``wide_batch`` enables the WIDE_LEVEL_BATCH
    launch width for big packed levels (default: on for CUDA).
    ``multivalue=None`` takes the multi-value plan when it saves at least
    ``MV_AUTO_MIN_SAVINGS`` of the rotations (``_compile_auto_mv``).
    ``engine`` as in ``has_match``.
    """
    contents = _contents4(ct_contents)
    builder, root = _compile_single(server_key.params, contents.shape[1],
                                    pattern, fold, engine, branch_budget)
    circuit = _compile(server_key, builder, root, backend, device,
                       multivalue, packed=True)
    executor = executor_for(server_key, backend, device=device)
    result = executor.run_many(circuit, contents, wide_batch=wide_batch)
    logger.info(
        "%d contents x (%d ops, %d bootstraps, %d rotations in %d levels)",
        contents.shape[0], circuit.ct_ops, circuit.pbs_count,
        circuit.rotation_count, len(circuit.levels),
    )
    return result


def run_circuit(server_key: ServerKey, builder: CircuitBuilder, root,
                ct_content: np.ndarray, backend: Optional[str] = None,
                mesh=None,
                device: "torch.device | str | None" = None) -> np.ndarray:
    """One-shot compile + execute of a custom CircuitBuilder DAG.

    ``root`` is one Node (result ``[num_blocks, n+1]``) or a list of Nodes
    (result ``[R, num_blocks, n+1]``); pending gate nodes are forced
    automatically.  For repeated serving of the same circuit, compile once
    with ``compile_circuit`` and reuse an ``executor_for`` instead.
    """
    params = server_key.params
    if isinstance(root, (list, tuple)):
        root = [builder.force_node(r) for r in root]
    else:
        root = builder.force_node(root)
    circuit = compile_circuit(params, builder, root,
                              min_bucket=_min_bucket(mesh))
    executor = executor_for(server_key, backend, mesh, device=device)
    return executor.run(circuit, np.ascontiguousarray(ct_content))


def _compile_multi(params: Params, content_len: int, patterns, fold: str,
                   engine: Optional[str], branch_budget: Optional[int]):
    from fhe_regex_tpu_torch.regex.engine import compile_match_multi
    from fhe_regex_tpu_torch.regex.native import compile_match_native_multi

    patterns = list(patterns)
    if not patterns:
        raise ValueError("need at least one pattern")
    compile_fn = (compile_match_native_multi if _native(engine)
                  else compile_match_multi)
    return compile_fn(content_len, patterns, num_blocks=params.num_blocks,
                      fold=fold, branch_budget=branch_budget)


def _compile_positions(params: Params, content_len: int, pattern: str,
                       fold: str, engine: Optional[str],
                       branch_budget: Optional[int]):
    from fhe_regex_tpu_torch.regex.engine import compile_match_positions
    from fhe_regex_tpu_torch.regex.native import (
        compile_match_native_positions)

    compile_fn = (compile_match_native_positions if _native(engine)
                  else compile_match_positions)
    return compile_fn(content_len, pattern, num_blocks=params.num_blocks,
                      fold=fold, branch_budget=branch_budget)


def _run_roots(server_key, backend, device, multivalue, builder, roots,
               ct_content, what: str, mesh=None) -> np.ndarray:
    """One content through a multi-root circuit: [R, num_blocks, n+1]."""
    circuit = _compile(server_key, builder, roots, backend, device,
                       multivalue, packed=False, mesh=mesh)
    executor = executor_for(server_key, backend, mesh, device=device)
    result = executor.run(circuit, np.ascontiguousarray(ct_content))
    logger.info(
        "%d %s: %d ciphertext operations, %d cache hits "
        "(%d bootstraps in %d levels)",
        len(roots), what, circuit.ct_ops, circuit.cache_hits,
        circuit.pbs_count, len(circuit.levels),
    )
    return result


def _run_roots_many(server_key, backend, device, multivalue, builder, roots,
                    contents, wide_batch, what: str) -> np.ndarray:
    """Many contents through a multi-root circuit: [C, R, num_blocks, n+1];
    the multi-value plan by the packed paths' auto rule."""
    circuit = _compile(server_key, builder, roots, backend, device,
                       multivalue, packed=True)
    executor = executor_for(server_key, backend, device=device)
    result = executor.run_many(circuit, contents, wide_batch=wide_batch)
    logger.info(
        "%d contents x %d %s (%d ops, %d bootstraps in %d levels)",
        contents.shape[0], len(roots), what, circuit.ct_ops,
        circuit.pbs_count, len(circuit.levels),
    )
    return result


def has_match_patterns(server_key: ServerKey, ct_content: np.ndarray,
                       patterns, backend: Optional[str] = None, mesh=None,
                       fold: str = "tree", engine: Optional[str] = None,
                       branch_budget: Optional[int] = None,
                       multivalue: Optional[bool] = None,
                       device: "torch.device | str | None" = None
                       ) -> np.ndarray:
    """Match MANY patterns against one encrypted content in one circuit.

    All patterns share a single hash-consed op DAG, so subexpressions common
    across patterns are bootstrapped once.  Returns one radix ciphertext
    per pattern, `[P, num_blocks, n+1]`, in pattern order; decrypt each with
    ``decrypt``.  ``engine``, ``multivalue`` and ``mesh`` as in
    ``has_match``.
    """
    builder, roots = _compile_multi(server_key.params, len(ct_content),
                                    patterns, fold, engine, branch_budget)
    return _run_roots(server_key, backend, device, multivalue, builder,
                      roots, ct_content, "patterns", mesh)


def has_match_positions(server_key: ServerKey, ct_content: np.ndarray,
                        pattern: str, backend: Optional[str] = None,
                        mesh=None, fold: str = "tree",
                        engine: Optional[str] = None,
                        branch_budget: Optional[int] = None,
                        multivalue: Optional[bool] = None,
                        device: "torch.device | str | None" = None
                        ) -> np.ndarray:
    """Per-offset encrypted match bits: result[i] encrypts 1 iff the pattern
    matches starting at content position i (``has_match``'s bit is their
    OR).  Returns `[len, num_blocks, n+1]`; decrypt each row with
    ``decrypt``.  ``engine``, ``multivalue`` and ``mesh`` as in
    ``has_match``.
    """
    builder, roots = _compile_positions(server_key.params, len(ct_content),
                                        pattern, fold, engine, branch_budget)
    return _run_roots(server_key, backend, device, multivalue, builder,
                      roots, ct_content, "positions", mesh)


def has_match_many_patterns(server_key: ServerKey, ct_contents, patterns,
                            backend: Optional[str] = None, fold: str = "tree",
                            engine: Optional[str] = None,
                            branch_budget: Optional[int] = None,
                            wide_batch: Optional[bool] = None,
                            multivalue: Optional[bool] = None,
                            device: "torch.device | str | None" = None
                            ) -> np.ndarray:
    """Match MANY patterns against MANY equal-length encrypted contents:
    one compiled circuit, levels packed across contents.  Returns
    `[C, P, num_blocks, n+1]`.  ``engine`` and ``multivalue`` as in
    ``has_match_many``.
    """
    contents = _contents4(ct_contents)
    builder, roots = _compile_multi(server_key.params, contents.shape[1],
                                    patterns, fold, engine, branch_budget)
    return _run_roots_many(server_key, backend, device, multivalue, builder,
                           roots, contents, wide_batch, "patterns")


def has_match_many_positions(server_key: ServerKey, ct_contents,
                             pattern: str, backend: Optional[str] = None,
                             fold: str = "tree",
                             engine: Optional[str] = None,
                             branch_budget: Optional[int] = None,
                             wide_batch: Optional[bool] = None,
                             multivalue: Optional[bool] = None,
                             device: "torch.device | str | None" = None
                             ) -> np.ndarray:
    """Per-offset match bits for MANY equal-length encrypted contents: one
    compiled multi-root circuit, levels packed across contents.  Returns
    ``[C, len, num_blocks, n+1]``.  ``engine`` and ``multivalue`` as in
    ``has_match_many``.
    """
    contents = _contents4(ct_contents)
    builder, roots = _compile_positions(server_key.params, contents.shape[1],
                                        pattern, fold, engine, branch_budget)
    return _run_roots_many(server_key, backend, device, multivalue, builder,
                           roots, contents, wide_batch, "positions")


def _window_plan(span: int, L: int, window: Optional[int]):
    """Shared window layout for long-content matching: (W, starts).

    Default W is at least 2*span so the stride (W - span) stays >= span;
    the final window is flush with the content end.  Returns W >= L (and
    no starts) when windowing cannot help."""
    W = window if window is not None else max(2 * span, span + 1,
                                              min(64, L))
    W = min(max(W, span + 1), L)
    if W >= L:
        return W, []
    S = W - span
    return W, sorted({*range(0, L - W, S), L - W})


def _long_plan(pattern: str, L: int):
    """(span, sof, eof) of `pattern` for windowed matching; span None when
    the pattern's match span is unbounded."""
    from fhe_regex_tpu_torch.regex import parser as _P
    from fhe_regex_tpu_torch.regex.engine import has_anchor, max_match_span

    re = _P.parse(pattern)
    return max_match_span(re), has_anchor(re, _P.SOF), has_anchor(re, _P.EOF)


def _long_layout(pattern: str, L: int, window: Optional[int]) -> tuple:
    """How long-content matching covers L characters: ("windows", W,
    starts), overlapping windows of W characters at ``starts``;
    ("direct", lo, hi), the direct circuit over characters [lo, hi); or
    ("false",), no match is possible.

    When the pattern's maximum match span is bounded, any match fits
    inside a window (stride = window - span).  Anchored patterns reduce to
    single flush windows (`^`: the first span+1 chars; `$`: the last span
    chars; both: FALSE beyond the span, where the anchored pattern must
    span all L chars but can consume at most `span`, as every branch of
    the direct circuit is pruned); unbounded-span patterns, empty content
    and contents no longer than a window take the direct circuit."""
    span, sof, eof = _long_plan(pattern, L)
    if span is None or L == 0:
        return "direct", 0, L
    if sof and eof:
        return ("direct", 0, L) if L <= span else ("false",)
    if sof:
        return "direct", 0, min(L, span + 1)
    if eof:
        return "direct", L - min(L, max(span, 1)), L
    W, starts = _window_plan(span, L, window)
    return ("windows", W, starts) if starts else ("direct", 0, L)


def _no_match(params: Params, C: int) -> np.ndarray:
    """[C, num_blocks, n+1] trivial encryptions of 0."""
    dt = np.uint32 if params.torus_bits == 32 else np.uint64
    return np.zeros((C, params.num_blocks, params.lwe_dimension + 1), dt)


def _match_windows(executor: Executor, circuit: CompiledCircuit,
                   contents: np.ndarray, W: int, starts,
                   wide_batch: Optional[bool] = None) -> tuple:
    """Windowed matching of C long contents with a compiled window circuit
    (the pattern at length W) on ``executor``: the windows of every
    content go through ONE ``run_many``, whose root rows stay on the
    device, then each content's window bits OR-reduce there
    (``Executor.or_reduce``, one download a content).

    -> ([C, num_blocks, n+1], OR seconds: the ``long.or_reduce`` span,
    from the first OR launch to the last answer on the host)."""
    C, M = contents.shape[0], len(starts)
    wins = np.stack([contents[c, a:a + W] for c in range(C) for a in starts])
    bits = executor.run_many(circuit, wins, wide_batch=wide_batch,
                             roots_on_device=True)
    with trace.Span("long.or_reduce") as sp:
        out = np.stack([executor.or_reduce(bits[c * M:(c + 1) * M])
                        for c in range(C)])
    return out, sp.seconds


def _long_windows(server_key: ServerKey, contents: np.ndarray, pattern: str,
                  W: int, starts, backend, fold, engine, branch_budget,
                  wide_batch, multivalue, device) -> np.ndarray:
    """``_match_windows`` with the window circuit ``has_match_many``
    compiles (packed: multi-value by the auto rule)."""
    params = server_key.params
    builder, root = _compile_single(params, W, pattern, fold, engine,
                                    branch_budget)
    circuit = _compile(server_key, builder, root, backend, device,
                       multivalue, packed=True)
    executor = executor_for(server_key, backend, device=device)
    out, _ = _match_windows(executor, circuit, contents, W, starts,
                            wide_batch)
    logger.info("%d long contents: %d chars -> %d windows of %d each",
                contents.shape[0], contents.shape[1], len(starts), W)
    return out


def has_match_long(server_key: ServerKey, ct_content: np.ndarray,
                   pattern: str, window: Optional[int] = None,
                   backend: Optional[str] = None, fold: str = "tree",
                   engine: Optional[str] = None,
                   branch_budget: Optional[int] = None,
                   wide_batch: Optional[bool] = None,
                   multivalue: Optional[bool] = None,
                   device: "torch.device | str | None" = None) -> np.ndarray:
    """Match over LONG encrypted content via overlapping windows.

    When the pattern's maximum match span is bounded, any match fits inside
    a fixed-size window, so the content is scanned as overlapping windows
    (stride = window - span) batched through ``run_many`` and the window
    bits are OR-reduced homomorphically on the device.  Decrypts
    identically to ``has_match`` on the full content.  Anchored patterns
    reduce to single flush windows and unbounded-span patterns fall back
    to the direct circuit (``_long_layout``).  ``engine`` and
    ``multivalue`` go to ``has_match`` and the windows' packed run as
    given (multivalue: auto on the windows' packed run).
    """
    content = np.ascontiguousarray(ct_content)
    layout = _long_layout(pattern, content.shape[0], window)
    if layout[0] == "false":
        return _no_match(server_key.params, 1)[0]
    if layout[0] == "direct":
        return has_match(server_key, content[layout[1]:layout[2]], pattern,
                         backend=backend, fold=fold, engine=engine,
                         branch_budget=branch_budget, device=device,
                         multivalue=multivalue)
    return _long_windows(server_key, content[None], pattern, *layout[1:],
                         backend, fold, engine, branch_budget, wide_batch,
                         multivalue, device)[0]


def has_match_many_long(server_key: ServerKey, ct_contents,
                        pattern: str, window: Optional[int] = None,
                        backend: Optional[str] = None, fold: str = "tree",
                        engine: Optional[str] = None,
                        branch_budget: Optional[int] = None,
                        wide_batch: Optional[bool] = None,
                        multivalue: Optional[bool] = None,
                        device: "torch.device | str | None" = None
                        ) -> np.ndarray:
    """Windowed matching over MANY equal-length long encrypted contents.

    The batched form of ``has_match_long``: the windows of every document
    pack into ONE ``run_many`` batch, then each document's window bits
    OR-reduce.  Returns ``[C, num_blocks, n+1]``.  Anchored / unbounded-span
    patterns reduce to one batched ``has_match_many`` over the (possibly
    trimmed) documents.  ``engine`` and ``multivalue`` as in
    ``has_match_many``.
    """
    contents = _contents4(ct_contents)
    layout = _long_layout(pattern, contents.shape[1], window)
    if layout[0] == "false":
        return _no_match(server_key.params, contents.shape[0])
    if layout[0] == "direct":
        return has_match_many(server_key, contents[:, layout[1]:layout[2]],
                              pattern, backend=backend, fold=fold,
                              engine=engine, branch_budget=branch_budget,
                              wide_batch=wide_batch, multivalue=multivalue,
                              device=device)
    return _long_windows(server_key, contents, pattern, *layout[1:],
                         backend, fold, engine, branch_budget, wide_batch,
                         multivalue, device)


def count_matches(server_key: ServerKey, ct_content: np.ndarray,
                  pattern: str, backend: Optional[str] = None,
                  fold: str = "tree",
                  branch_budget: Optional[int] = None,
                  device: "torch.device | str | None" = None) -> np.ndarray:
    """Encrypted NUMBER of matching start offsets.

    Builds the per-position match bits (``has_match_positions``' circuit)
    and sums them homomorphically into little-endian base-4 digits
    (``circuit.count_bits``).  Returns ``[D, num_blocks, n+1]``; decrypt
    with ``decrypt_count``.  The match bit is `count > 0`.
    """
    from fhe_regex_tpu_torch.regex.circuit import count_bits

    params = server_key.params
    # the Python builder: count_bits appends its adder ops to it
    builder, roots = _compile_positions(params, len(ct_content), pattern,
                                        fold, "python", branch_budget)
    digits = count_bits(builder, roots)
    digit_roots = [Node(("count", i), d) for i, d in enumerate(digits)]
    circuit = compile_circuit(params, builder, digit_roots,
                              min_bucket=default_min_bucket())
    executor = executor_for(server_key, backend, device=device)
    result = executor.run(circuit, np.ascontiguousarray(ct_content))
    logger.info(
        "count over %d positions: %d digits (%d bootstraps in %d levels)",
        len(roots), len(digits), circuit.pbs_count, len(circuit.levels),
    )
    return result


def decrypt_count(client_key: ClientKey, ct_count: np.ndarray) -> int:
    """Decrypt ``count_matches``' little-endian base-4 digit rows."""
    return sum(decrypt(client_key, ct_count[i]) * 4 ** i
               for i in range(ct_count.shape[0]))


def decrypt(client_key: ClientKey, ct_res: np.ndarray) -> int:
    """Radix decrypt of the match result (mod.rs:17)."""
    return _lwe.decrypt_byte(client_key.params, client_key.lwe_key, ct_res)
