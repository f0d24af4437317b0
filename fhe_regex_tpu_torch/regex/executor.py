"""Level-scheduled batched executor (PyTorch).

The twin of ``fhe_regex_tpu/regex/executor.py``: the hash-consed micro-op
DAG (regex/circuit.py) is level-scheduled ahead of time, and every level
is ONE batched PBS call over all bootstraps whose inputs are ready.  Each
level executes:
  1. affine gather:  x_i = sum_k coef_ik * slab[slot_ik] + const_i * delta
  2. batched PBS with per-instance LUT selection
  3. scatter of outputs into the ciphertext slab

``compile_circuit`` produces the same level plans as the JAX package's
(same buckets, same slot numbering), so slabs compare level by level.
Level batch widths are padded to power-of-two buckets; padded instances
write to a trash slot.

With ``multivalue=True`` a level's ops that share an affine input share
ONE blind rotation of the common test polynomial, and each op derives its
LUT at extract time (``ops/mv.py``): step 2 becomes a rotation batch over
the deduped inputs plus a derived extract and keyswitch per op.

The slab holds torus values as int32 bits at 32 bits and int64 bits at 64
bits; ciphertexts cross the API as uint32 / uint64 numpy arrays.

``Executor.run_many`` is the serving path: one compiled circuit against C
contents, every level's active bootstraps (or rotations) packed across the
contents and cut into launches of the three widths of ``_chunk_sizes``.

Both can checkpoint their slab (``utils/checkpoint.py``) and resume from
it; a checkpoint carries the ``circuit_fingerprint`` of the plan that saved
it, and a resume under any other plan is refused.  Every run feeds the
executor's ``LaunchWatchdog`` (``utils/watchdog.py``).

Every run opens the spans of ``utils/trace.py``: ``executor.run`` /
``executor.run_many`` over the call, ``executor.fill`` (slab and content
upload), one ``executor.level`` a level, packed step or graph replay
(``_Steps``), and ``executor.finalize`` (the root download, which waits
for the device, and the result's assembly).  Each step's rows go to the
executor's ``launches_by_width`` counters.

With a ``mesh`` (``parallel/mesh.py``) every rank runs the same executor on
the same inputs: each level's bootstraps (or rotations and derived
extracts) split into one contiguous row block per rank, and the blocks are
all-gathered into every rank's slab.  Level widths and launch widths must
then be multiples of the mesh size (compile with min_bucket >= D).
"""

from __future__ import annotations

import collections
import contextlib
import dataclasses
import functools
import hashlib
import math
import os
import threading
import time
from typing import Dict, List, Tuple

import numpy as np
import torch

from fhe_regex_tpu_torch.crypto.golden import make_lut_poly
from fhe_regex_tpu_torch.ops.luts import (LUT_OR2, LUT_OR3, LutKey, lut_fn,
                                          mv_support_positions, mv_weights)
from fhe_regex_tpu_torch.ops.mv import (make_mv_finish_core,
                                        make_mv_rotate_core, mv_lut_table)
from fhe_regex_tpu_torch.ops.pbs import I64, make_pbs_core, wrap_i32
from fhe_regex_tpu_torch.params import Params
from fhe_regex_tpu_torch.regex.circuit import BitVal, CircuitBuilder, Node, PbsOp
from fhe_regex_tpu_torch.utils import checkpoint as _ckpt
from fhe_regex_tpu_torch.utils import trace
from fhe_regex_tpu_torch.utils.cuda_graph import CapturedBody, forced_fuse
from fhe_regex_tpu_torch.utils.watchdog import LaunchWatchdog

U32 = np.uint32


class MvMarginError(ValueError):
    """A multi-value LUT factor fails the >=5 sigma noise-margin check.

    Distinct from other compile ValueErrors so the packed-path auto-mv
    fallback (``_compile_auto_mv``) catches exactly this rejection."""


@dataclasses.dataclass
class LevelPlan:
    in_slots: np.ndarray   # [W, 3] int32
    in_coefs: np.ndarray   # [W, 3] int32
    consts: np.ndarray     # [W] int32 (plaintext units)
    lut_idx: np.ndarray    # [W] int32
    out_idx: np.ndarray    # [W] int32
    # multi-value plan (compile_circuit(multivalue=True); None on the
    # classic path): rot_* are the [R, ...] deduped rotation inputs,
    # mv_leader maps each op to its rotation row, mv_weights are the ops'
    # LUT factor weights over the support positions mv_positions.
    rot_slots: "np.ndarray | None" = None
    rot_coefs: "np.ndarray | None" = None
    rot_consts: "np.ndarray | None" = None
    mv_weights: "np.ndarray | None" = None   # columns = mv_positions only
    mv_leader: "np.ndarray | None" = None
    mv_rot_count: int = 0          # active rotations (R before padding)
    # the static support positions this level's LUT factors use (a dead
    # column would cost a negacyclic roll of every accumulator)
    mv_positions: "tuple | None" = None


@dataclasses.dataclass
class CompiledCircuit:
    params: Params
    num_slots: int         # content slots + op outputs (+1 trash at the end)
    levels: List[LevelPlan]
    luts: np.ndarray       # [L, N] uint32
    root: Node
    ct_ops: int
    cache_hits: int
    # multi-root circuits: roots[i] is pattern i's result bit; None for
    # single-root circuits.
    roots: "List[Node] | None" = None
    # multi-value bootstrap circuit (shared rotations; ops/mv.py)
    multivalue: bool = False

    @property
    def pbs_count(self) -> int:
        return sum(int((lv.lut_idx >= 0).sum()) for lv in self.levels)

    @property
    def rotation_count(self) -> int:
        """Blind rotations actually executed (== pbs_count on the classic
        path; smaller under multivalue when ops share inputs)."""
        if not self.multivalue:
            return self.pbs_count
        return sum(lv.mv_rot_count for lv in self.levels)

    @property
    def all_roots(self) -> List[Node]:
        return self.roots if self.roots is not None else [self.root]


MAX_LEVEL_BATCH = 256   # largest PBS batch one compiled-circuit level uses
WIDE_LEVEL_BATCH = 1024  # run_many's wide launch for big packed levels
SMALL_LEVEL_BATCH = 64   # run_many's launch for narrow packed levels


def _assemble_root(params: Params, val: BitVal,
                   ct_u: "np.ndarray | None") -> np.ndarray:
    """Radix result ciphertext from the root bit value.

    A compile-time-constant root yields a *trivial* ciphertext, matching
    Q10 (e.g. /./ returns a noiseless ct in the reference)."""
    n1 = params.lwe_dimension + 1
    dt = U32 if params.torus_bits == 32 else np.uint64
    out = np.zeros((params.num_blocks, n1), dt)
    if val.sign == 0:
        out[0, -1] = dt(val.const * params.delta)
        return out
    with np.errstate(over="ignore"):
        blk = ct_u.astype(dt) if val.sign == 1 else (dt(0) - ct_u.astype(dt))
        blk = blk.copy()
        blk[-1] = dt(blk[-1] + dt(val.const * params.delta))
    out[0] = blk
    return out


def default_min_bucket() -> int:
    """Smallest level width.  8 on every device, which is also the JAX
    package's CPU value, so both packages compile identical level plans."""
    return 8


# The backends whose level loop ``run`` takes as one CUDA graph by default,
# from chip_smoke.py phase 16 on an NVIDIA H100 80GB HBM3 at 700 W
# (PERF.md §6).  The per-step ``cuda`` backend, which enqueues two kernels
# a CMUX step from Python, ran a warm exact_literal 2.1-3.6x faster as a
# graph.  On the whole-rotation kernel backends (cuda-fused, cuda-bg,
# cuda64, cuda64-bg) a warm replay ran from 0.5 % faster to 2.5 % slower
# than the per-level loop and a first run cost a capture more, so they keep
# the loop.  ``fft`` won 5-9x warm, but its three-level graph took 6.1-7.3 s
# to capture and instantiate and held 1.4-1.5 GB of host memory; it and
# the plain backends (``torch``, ``torch64``) keep the loop too.
FUSE_BACKENDS = ("cuda",)

# Above this many blind rotations ``run`` keeps the per-level loop by
# default, as in the JAX package (1500, set there for its fused program's
# compile time on a TPU).  On the H100 above, the ``cuda`` backend's graph
# of a 680-rotation request (quantifiers: 10 levels, 27,020 nodes) still
# ran 1.27-1.34x faster warm than its loop (PERF.md §6); beyond that
# nothing was measured.
FUSE_MAX_PBS = 1500

# Captured level loops one executor keeps, least recently run dropped
# first (each holds its static slab, the graph's private memory pool and
# the graph's host memory).  Eight holds the plan mix the repo serves and
# measures, the daemon's warm set of chip_smoke.py phase 12 (the five
# DRIVER_CONFIGS and north_star_hit: six plans), with two to spare.  At
# the largest pool phase 16 measured, 83.9 MB, eight hold 0.67 GB of card
# memory; a graph's host memory measured 3-133 MB on the kernel backends
# (PERF.md §6).
MAX_FUSED_GRAPHS = 8


def default_fuse(circuit, device: "torch.device | str",
                 backend: "str | None" = None, world: int = 1) -> bool:
    """Default of ``Executor.run(fuse=None)``: the whole level loop as one
    CUDA graph on a CUDA device, for a backend of FUSE_BACKENDS (``backend``
    None, the device's default, is not one), at most FUSE_MAX_PBS blind
    rotations and a mesh of at most one rank (``world``: no graph with
    collectives across cards has run yet); never on the CPU.
    FHE_REGEX_FUSE_LEVELS=0|1 forces either way (``forced_fuse``; the
    same variable forces the tensor-parallel bootstrap's graph,
    ``parallel.tensor.default_tp_graph``).  The cap is on
    ``rotation_count``: capture and replay cost scale with the rotations
    run, and a multi-value circuit runs fewer rotations than bootstraps."""
    forced = forced_fuse()
    if forced is not None:
        return forced
    return (torch.device(device).type == "cuda" and backend in FUSE_BACKENDS
            and world <= 1 and circuit.rotation_count <= FUSE_MAX_PBS)


class FusedLevels(CapturedBody):
    """One circuit's whole level loop on one executor, run as one unit over
    a static slab that every run zeroes, fills and reads back.

    On CUDA the loop is a ``CapturedBody``: the first ``run`` makes its
    warm-up pass over the filled slab, which computes that run's result,
    then captures it; every later run replays.  The graph holds the
    addresses of the key, the LUT table, the level plans and the slab, so
    this object keeps the plan tensors alive (``body`` closes over them)
    and the executor the key.  A capture that fails raises: nothing falls
    back to the per-level loop.  On the CPU ``run`` calls the loop
    itself."""

    def __init__(self, body, slab: torch.Tensor):
        super().__init__(body, slab.device)
        self.slab = slab

    def run(self, fill, step=contextlib.nullcontext()) -> torch.Tensor:
        """``fill(slab)`` writes this run's input rows into the zeroed slab;
        the loop runs over it (on a first CUDA run, as the warm-up pass
        before the capture) inside the context ``step``, and the slab is
        returned."""
        with trace.Span("executor.fill"):
            self.slab.zero_()
            fill(self.slab)
        with step:
            if self.slab.device.type != "cuda":
                self.body()
            else:
                self.launch()
        return self.slab


def _chunk_sizes(total: int, use_wide: bool) -> List[int]:
    """Launch widths for a packed run_many level of `total` active ops, as
    in the JAX package: full wide launches first, one more padded wide
    launch if over 3 * MAX_LEVEL_BATCH remain, then MAX_LEVEL_BATCH
    launches with a SMALL_LEVEL_BATCH or MAX_LEVEL_BATCH tail."""
    sizes: List[int] = []
    rem = total
    if use_wide:
        sizes += [WIDE_LEVEL_BATCH] * (rem // WIDE_LEVEL_BATCH)
        rem -= WIDE_LEVEL_BATCH * (rem // WIDE_LEVEL_BATCH)
        if rem > 3 * MAX_LEVEL_BATCH:
            sizes.append(WIDE_LEVEL_BATCH)
            rem = 0
    if rem:
        if rem <= SMALL_LEVEL_BATCH:
            sizes.append(SMALL_LEVEL_BATCH)
        else:
            sizes += [MAX_LEVEL_BATCH] * (rem // MAX_LEVEL_BATCH)
            tail = rem % MAX_LEVEL_BATCH
            if tail:
                sizes.append(SMALL_LEVEL_BATCH if tail <= SMALL_LEVEL_BATCH
                             else MAX_LEVEL_BATCH)
    return sizes


def _bucket(w: int, min_bucket: int = 8) -> int:
    b = min_bucket
    while b < w:
        b *= 2
    return b


def _level_rows(circuit: "CompiledCircuit") -> List[Tuple[int, int]]:
    """(rows launched, rows needed) of each level of ``run``: the batch the
    level hands the blind rotation (the multi-value rotation batch on that
    plan) and its active rows.  Cached on the circuit."""
    rows = circuit.__dict__.get("_torch_level_rows")
    if rows is None:
        rows = circuit.__dict__["_torch_level_rows"] = [
            (int(lv.rot_slots.shape[0]), int(lv.mv_rot_count))
            if circuit.multivalue else
            (int(lv.lut_idx.shape[0]), int((lv.lut_idx >= 0).sum()))
            for lv in circuit.levels]
    return rows


class _Steps:
    """The ``executor.level`` spans of one run: one a level (``run``), a
    packed step (``run_many``) or a graph replay.  Each step's rows go to
    the executor's ``launches_by_width`` under its key, the widths of its
    rotation launches joined by "+".

    With ``timed`` (the request's recorder records, or ``profile=True``)
    each step also gets its device seconds, in its span and its counters:
    on CUDA from a pair of events around it on the current stream, read
    by ``close`` after the run's root download; on the CPU, whose plain
    path is synchronous, its host seconds.  Untimed, no event is made and
    nothing waits."""

    def __init__(self, executor: "Executor", timed: bool):
        self._ex = executor
        self._timed = timed
        self._events = timed and executor.device.type == "cuda"
        self._pending: list = []

    @contextlib.contextmanager
    def step(self, key: str, launched: int, needed: int):
        ev = None
        if self._events:
            stream = torch.cuda.current_stream(self._ex.device)
            ev = (torch.cuda.Event(enable_timing=True),
                  torch.cuda.Event(enable_timing=True))
            ev[0].record(stream)
        with trace.Span("executor.level", width=key, rows_launched=launched,
                        rows_needed=needed) as sp:
            yield
        if ev is not None:
            ev[1].record(stream)
        if self._timed:
            self._pending.append((sp, ev))
        else:
            self._ex._count_step(key, launched, needed, None)

    def close(self) -> List[float]:
        """The timed steps' device seconds, in order, once the run's
        download has waited for the device."""
        if self._pending and self._pending[-1][1] is not None:
            self._pending[-1][1][1].synchronize()   # a run with no download
        out = []
        for sp, ev in self._pending:
            s = ev[0].elapsed_time(ev[1]) / 1e3 if ev else sp.seconds
            sp.attrs["device_s"] = s
            self._ex._count_step(sp.attrs["width"], sp.attrs["rows_launched"],
                                 sp.attrs["rows_needed"], s)
            out.append(s)
        self._pending = []
        return out


def active_bsk_drop(params: Params, backend: "str | None" = None,
                    device: "torch.device | str | None" = None
                    ) -> "tuple | None":
    """The key-limb drop the selected backend applies to these params.

    Only ``cuda64-bg`` (the 64-bit default on CUDA) rounds the bootstrap
    key; every other backend keeps it whole.  ``backend=None`` assumes the
    default resolution on ``device`` (None: CUDA, the port's default
    device).  Noise gates and p_fail reports use it, so they reflect the
    real operating point."""
    if params.torus_bits != 64:
        return None
    from fhe_regex_tpu_torch.ops.pbs import resolve_backend
    from fhe_regex_tpu_torch.ops.pbs64 import default_drop64
    if resolve_backend(backend, device or "cuda", params) != "cuda64-bg":
        return None
    drop = default_drop64(params)
    return drop if drop != (0, 0) else None


def _dev_key_drop(dev_key) -> "tuple | None":
    """The key-limb drop a prepared key carries (None if (0, 0))."""
    drop = tuple(dev_key.drop64)
    return drop if drop != (0, 0) else None


def worst_mv_norm2(circuit) -> "int | None":
    """Largest ||u||^2 over the circuit's multivalue LUT factors (the
    blind-rotation variance amplifier), or None for classic circuits."""
    if not circuit.multivalue:
        return None
    worst = 0
    for lv in circuit.levels:
        if lv.mv_weights is not None and lv.mv_weights.size:
            worst = max(worst, int(
                (lv.mv_weights.astype(np.int64) ** 2).sum(axis=1).max()))
    return worst or None


_DROP_DEFAULT = object()   # sentinel: "assume the default backend's drop"


def circuit_pfail(params: Params, circuit, bsk_drop=_DROP_DEFAULT) -> dict:
    """The failure-probability contract at the engine's operating point:
    the backend's key-limb drop and the circuit's worst mv factor norm.
    ``bsk_drop`` (a tuple or None) reports for a specific prepared key.
    Non-finite log2 values (zero-noise test sets) are reported as None."""
    drop = active_bsk_drop(params) if bsk_drop is _DROP_DEFAULT else bsk_drop
    mvn = worst_mv_norm2(circuit)
    rep = params.noise_budget_report(mv_norm2=mvn, bsk_drop=drop)
    lp = rep["log2_p_fail_per_pbs"]
    return {
        "pbs_count": circuit.pbs_count,
        "mv_norm2": mvn,
        "bsk_drop": list(drop) if drop else None,
        "log2_p_fail_per_pbs": lp if math.isfinite(lp) else None,
        "p_fail_circuit": params.p_fail_circuit(
            circuit.pbs_count, mv_norm2=mvn, bsk_drop=drop),
    }


def compile_circuit(params: Params, builder: CircuitBuilder,
                    root: "Node | List[Node]",
                    min_bucket: int = 8,
                    max_batch: int = MAX_LEVEL_BATCH,
                    multivalue: bool = False,
                    bsk_drop=_DROP_DEFAULT) -> CompiledCircuit:
    """Level-schedule a builder's op DAG.  `root` may be one Node or a list
    of them (multi-pattern circuits); `run` then returns one result row per
    root.

    multivalue=True compiles the shared-rotation plan (ops/mv.py): ops in a
    level that share an affine input share ONE blind rotation.  Same
    decrypted results; the noise margin of every LUT factor is checked at
    the backend's key drop ``bsk_drop`` (default: ``active_bsk_drop``), and
    a factor under 5 sigma raises MvMarginError."""
    roots: "List[Node] | None" = None
    if isinstance(root, (list, tuple)):
        roots = list(root)
        if not roots:
            raise ValueError("need at least one root")
        root = roots[0]
    lut_ids: Dict[LutKey, int] = {}
    for op in builder.ops:
        if op.lut not in lut_ids:
            lut_ids[op.lut] = len(lut_ids)
    luts = (np.stack([make_lut_poly(params, lut_fn(k)) for k in lut_ids])
            if lut_ids else np.zeros((1, params.polynomial_size),
                                     U32 if params.torus_bits == 32
                                     else np.uint64))
    # a fixed LUT row count and a slab padded to a multiple of 1024, as in
    # the JAX package, so the plans of both packages are identical
    lut_rows = 128 if luts.shape[0] <= 128 else _bucket(luts.shape[0], 128)
    luts = np.concatenate(
        [luts, np.zeros((lut_rows - luts.shape[0], luts.shape[1]), luts.dtype)])

    by_level: Dict[int, List[PbsOp]] = {}
    for op in builder.ops:
        by_level.setdefault(op.level, []).append(op)

    num_slots = builder.num_content_slots + len(builder.ops) + 1
    num_slots = ((num_slots + 1023) // 1024) * 1024
    trash = num_slots - 1
    levels = []
    for lvl in sorted(by_level):
        ops = by_level[lvl]
        # split oversized levels into <= max_batch kernel launches
        for c0 in range(0, len(ops), max_batch):
            chunk = ops[c0:c0 + max_batch]
            w = min(_bucket(len(chunk), min_bucket), max_batch)
            in_slots = np.zeros((w, 3), np.int32)
            in_coefs = np.zeros((w, 3), np.int32)
            consts = np.zeros(w, np.int32)
            lut_idx = np.full(w, -1, np.int32)
            out_idx = np.full(w, trash, np.int32)
            for i, op in enumerate(chunk):
                in_slots[i] = op.in_slots
                in_coefs[i] = op.in_coefs
                consts[i] = op.const
                lut_idx[i] = lut_ids[op.lut]
                out_idx[i] = op.out_slot
            plan = LevelPlan(in_slots, in_coefs, consts, lut_idx, out_idx)
            if multivalue:
                _attach_mv_plan(params, plan, chunk, w, min_bucket, bsk_drop)
            levels.append(plan)

    return CompiledCircuit(
        params=params,
        num_slots=num_slots,
        levels=levels,
        luts=luts,
        root=root,
        ct_ops=builder.ct_ops,
        cache_hits=builder.cache_hits,
        roots=roots,
        multivalue=multivalue,
    )


def _attach_mv_plan(params: Params, plan: LevelPlan, chunk, w: int,
                    min_bucket: int, bsk_drop) -> None:
    """Dedup a level chunk's affine inputs into a rotation batch and record
    each op's (leader, LUT factor weights), as the JAX package does."""
    S = len(mv_support_positions(params))
    drop = active_bsk_drop(params) if bsk_drop is _DROP_DEFAULT else bsk_drop
    groups: Dict[Tuple, int] = {}
    leaders: List[Tuple] = []
    leader = np.zeros(w, np.int32)
    weights = np.zeros((w, S), np.int32)
    wcache: Dict[Tuple, np.ndarray] = {}
    for i, op in enumerate(chunk):
        key = (op.in_slots, op.in_coefs, op.const)
        r = groups.get(key)
        if r is None:
            r = groups[key] = len(leaders)
            leaders.append(key)
        leader[i] = r
        wv = wcache.get(op.lut)
        if wv is None:
            wv = wcache[op.lut] = mv_weights(params, op.lut)
            u2 = int((wv.astype(np.int64) ** 2).sum())
            rep = params.noise_budget_report(mv_norm2=u2, bsk_drop=drop)
            if rep["sigma_margin"] < 5.0:
                raise MvMarginError(
                    f"multivalue factor of LUT {op.lut!r} has ||u||^2={u2}, "
                    f"leaving only {rep['sigma_margin']:.2f} sigma (< 5) — "
                    f"compile this circuit with multivalue=False")
        weights[i] = wv
    R = len(leaders)
    rb = min(_bucket(R, min_bucket), w)      # rotation batch, padded
    rot_slots = np.zeros((rb, 3), np.int32)
    rot_coefs = np.zeros((rb, 3), np.int32)
    rot_consts = np.zeros(rb, np.int32)
    for r, (slots, coefs, const) in enumerate(leaders):
        rot_slots[r] = slots
        rot_coefs[r] = coefs
        rot_consts[r] = const
    # keep only the support columns some weight uses
    pos = mv_support_positions(params)
    active_cols = np.flatnonzero(weights.any(axis=0))
    if active_cols.size == 0:
        active_cols = np.asarray([0])
    plan.rot_slots = rot_slots
    plan.rot_coefs = rot_coefs
    plan.rot_consts = rot_consts
    plan.mv_weights = np.ascontiguousarray(weights[:, active_cols])
    plan.mv_leader = leader
    plan.mv_rot_count = R
    plan.mv_positions = tuple(int(pos[c]) for c in active_cols)


def circuit_fingerprint(circuit: CompiledCircuit, *extra) -> str:
    """sha256 (hex) of everything a slab's next levels depend on: the
    params name, slot count, bootstrap and rotation counts, plan kind,
    every level plan's arrays (the multi-value fields too), the LUT table
    and the roots; ``extra`` appends more (``run_many``: C, wide_batch and
    its step count).  Stable across processes (no salted ``hash()``)."""
    h = hashlib.sha256()
    h.update(repr((circuit.params.name, circuit.num_slots,
                   circuit.pbs_count, circuit.rotation_count,
                   circuit.multivalue,
                   [(r.val.const, r.val.sign, r.val.slot)
                    for r in circuit.all_roots]) + extra).encode())

    def arr(a: np.ndarray) -> None:
        a = np.ascontiguousarray(a)
        h.update(f"{a.dtype}{a.shape}".encode())
        h.update(a.tobytes())

    arr(circuit.luts)
    for lv in circuit.levels:
        for f in dataclasses.fields(lv):
            v = getattr(lv, f.name)
            if isinstance(v, np.ndarray):
                arr(v)
            else:
                h.update(f"{f.name}={v!r}".encode())
    return h.hexdigest()


def _check_fingerprint(path, want: str) -> None:
    got = _ckpt.load_fingerprint(path)
    if got != want:
        raise ValueError(f"{path}: checkpoint fingerprint {got} does not "
                         f"match this plan's {want}: the slab was saved by "
                         f"another circuit or plan, or without a fingerprint")


@dataclasses.dataclass
class OrTree:
    """The OR tree of M encrypted bits as rounds over a slab whose rows
    0..M-1 hold the bits (``_or_tree``)."""
    rounds: list        # [(rows needed, [level launch tuple])]
    answer: int         # the slab row of the answer
    slab_rows: int

    @property
    def rows(self) -> int:
        """Bootstraps the tree needs (padding rows not counted)."""
        return sum(needed for needed, _ in self.rounds)


def _or_tree(M: int, upload) -> OrTree:
    """Each round ORs consecutive triples of the current rows (OR3 of
    x + 2y + 4z, LUT 1) and a trailing pair (OR2 of x + 2y, LUT 0), carries
    a lone trailing row, and writes its outputs to fresh slab rows; the
    next round's rows are the outputs, then the carried row.  A round's
    launches are MAX_LEVEL_BATCH wide with a power-of-two tail of at least
    ``default_min_bucket``; padding rows combine nothing and write row M,
    the trash row.  ``upload`` puts a launch's arrays on the device (the
    dtypes of a classic level: int64 slots, int32 coefficients, constants
    and LUT indices)."""
    cur, nxt, rounds = list(range(M)), M + 1, []
    while len(cur) > 1:
        groups = [cur[i:i + 3] for i in range(0, len(cur), 3)]
        work = [g for g in groups if len(g) > 1]
        carry = [g[0] for g in groups if len(g) == 1]
        B = len(work)
        sizes = [MAX_LEVEL_BATCH] * (B // MAX_LEVEL_BATCH)
        if B % MAX_LEVEL_BATCH:
            sizes.append(_bucket(B % MAX_LEVEL_BATCH, default_min_bucket()))
        slots = np.zeros((sum(sizes), 3), np.int32)
        coefs = np.zeros((sum(sizes), 3), np.int32)
        lut = np.zeros(sum(sizes), np.int32)
        out = np.full(sum(sizes), M, np.int32)
        for j, g in enumerate(work):
            slots[j, :len(g)] = g
            coefs[j, :len(g)] = (1, 2, 4)[:len(g)]
            lut[j] = len(g) - 2
            out[j] = nxt + j
        launches, c0 = [], 0
        for w in sizes:
            sl = slice(c0, c0 + w)
            c0 += w
            launches.append((upload(slots[sl], I64), upload(coefs[sl]),
                             upload(np.zeros(w, np.int32)), upload(lut[sl]),
                             upload(out[sl], I64)))
        rounds.append((B, launches))
        cur = list(range(nxt, nxt + B)) + carry
        nxt += B
    return OrTree(rounds, cur[0], nxt)


class Executor:
    """Runs compiled circuits against one server key's device material.

    With a mesh, each level's PBS batch is sharded across the mesh's ranks
    (``parallel/mesh.py``); the key must be on this rank's device, and
    circuits must be compiled with min_bucket >= mesh size.
    """

    def __init__(self, params: Params, dev_key, mesh=None):
        self.params = params
        self.device = dev_key.device
        self.mesh = mesh
        self.watchdog = LaunchWatchdog()
        self._dev_key = dev_key
        if mesh is None:
            self._core = make_pbs_core(dev_key)
        else:
            from fhe_regex_tpu_torch.parallel.mesh import make_sharded_pbs_core
            self._core = make_sharded_pbs_core(dev_key, mesh)
        self._vlut = mv_lut_table(params, self.device)
        # {circuit_fingerprint: FusedLevels}, least recently run first;
        # the lock is held over a fused run, from the cache to the download
        self._fused: "collections.OrderedDict[str, FusedLevels]" = (
            collections.OrderedDict())
        self._fused_lock = threading.Lock()
        self.last_run_stats: List[dict] = []
        self.last_run_pfail: "dict | None" = None
        # {step key: {"steps", "rows_launched", "rows_needed", "device_s"}}
        # over every run; device_s only of timed steps (``_Steps``)
        self._by_width: Dict[str, dict] = {}
        self._by_width_lock = threading.Lock()
        # {M: OrTree} of or_reduce, on this executor's device
        self._or_trees: Dict[int, OrTree] = {}
        self._or_lock = threading.Lock()
        wide = params.torus_bits == 64
        self._dtype = I64 if wide else torch.int32
        self._np_u = np.uint64 if wide else U32       # the bits at the API
        self._np_s = np.int64 if wide else np.int32   # the same, as tensors

    def _count_step(self, key: str, launched: int, needed: int,
                    device_s: "float | None") -> None:
        with self._by_width_lock:
            row = self._by_width.setdefault(key, {
                "steps": 0, "rows_launched": 0, "rows_needed": 0,
                "device_s": 0.0})
            row["steps"] += 1
            row["rows_launched"] += launched
            row["rows_needed"] += needed
            if device_s is not None:
                row["device_s"] += device_s

    def launches_by_width(self) -> Dict[str, dict]:
        """The rows of every step run so far by step key (the widths of its
        rotation launches, joined by "+"): ``steps``, ``rows_launched``
        (the batches handed to the blind rotation), ``rows_needed`` (their
        active rows) and ``device_s`` (the device seconds of the steps that
        were timed: recording on, or ``profile=True``)."""
        with self._by_width_lock:
            return {k: dict(v) for k, v in self._by_width.items()}

    @functools.cached_property
    def _mv_rotate(self):
        """The multi-value rotate core, made at first use: on a backend
        without a multi-value rotation (``fft``) a multi-value circuit
        raises ValueError here, and the classic plan runs.  Under a mesh
        the rotation batch is sharded and the accumulators all-gathered."""
        if self.mesh is not None:
            from fhe_regex_tpu_torch.parallel.mesh import (
                make_sharded_mv_rotate_core)
            return make_sharded_mv_rotate_core(self._dev_key, self.mesh)
        return make_mv_rotate_core(self._dev_key)

    @functools.cached_property
    def _mv_finish(self):
        """The derived extracts and keyswitch; under a mesh the op batch is
        sharded and the outputs all-gathered."""
        if self.mesh is not None:
            from fhe_regex_tpu_torch.parallel.mesh import (
                make_sharded_mv_finish_core)
            return make_sharded_mv_finish_core(self._dev_key, self.mesh)
        return make_mv_finish_core(self._dev_key)

    def _affine_combine(self, gathered, in_coefs, consts):
        """sum_k coef_k * slab[slot_k] + const * delta over [W, 3, n+1].

        One int64 expression at both widths: int64 products and sums wrap
        mod 2^64, which is the 64-bit torus itself, and narrow to the
        32-bit torus with ``wrap_i32``."""
        x = (in_coefs[:, :, None].to(I64) * gathered.to(I64)).sum(dim=1)
        x[:, -1] += consts.to(I64) * self.params.delta
        return x if self.params.torus_bits == 64 else wrap_i32(x)

    def _run_level(self, slab, luts, in_slots, in_coefs, consts, lut_idx,
                   out_idx) -> None:
        """One level, updating ``slab`` in place."""
        x = self._affine_combine(slab[in_slots], in_coefs, consts)
        outs = self._core(luts, lut_idx.clamp(min=0), x)
        # padded rows all write the trash slot; which duplicate lands there
        # is unspecified on CUDA, and the trash slot is never read
        slab[out_idx] = outs

    def _run_level_mv(self, slab, rot_slots, rot_coefs, rot_consts,
                      weights, leader, out_idx, positions) -> None:
        """One multi-value level, in place: the deduped rotations of the
        common test polynomial, then every op's derived extract."""
        x = self._affine_combine(slab[rot_slots], rot_coefs, rot_consts)
        accs = self._mv_rotate(self._vlut, x)
        slab[out_idx] = self._mv_finish(accs, weights, leader, positions)

    def _run_levels_fused(self, slab, luts, levels) -> None:
        """The whole classic level loop, in place: the body ``run(fuse=)``
        captures."""
        for dev in levels:
            self._run_level(slab, luts, *dev)

    def _run_levels_fused_mv(self, slab, levels) -> None:
        """The whole multi-value level loop, in place (each level's support
        positions are a host tuple fixed by the plan)."""
        for dev in levels:
            self._run_level_mv(slab, *dev)

    def fused_levels(self, circuit: CompiledCircuit) -> FusedLevels:
        """This executor's ``FusedLevels`` of ``circuit``, made at first use.

        Kept per executor (two executors never share one) and keyed by the
        ``circuit_fingerprint``: an entry point that compiles its circuit
        anew on every call (``has_match``) finds the graph of the same plan
        again.  The entry holds its own plan tensors, uploaded from the
        circuit that made it.  At most ``MAX_FUSED_GRAPHS`` are kept."""
        fp = circuit.__dict__.get("_torch_fingerprint")
        if fp is None:
            fp = circuit.__dict__["_torch_fingerprint"] = (
                circuit_fingerprint(circuit))
        entry = self._fused.get(fp)
        if entry is None:
            luts, levels = self._device_plan(circuit)
            slab = torch.zeros((circuit.num_slots,
                                self.params.lwe_dimension + 1),
                               dtype=self._dtype, device=self.device)
            if circuit.multivalue:
                body = functools.partial(self._run_levels_fused_mv, slab,
                                         levels)
            else:
                body = functools.partial(self._run_levels_fused, slab, luts,
                                         levels)
            entry = self._fused[fp] = FusedLevels(body, slab)
            while len(self._fused) > MAX_FUSED_GRAPHS:
                self._fused.popitem(last=False)
        self._fused.move_to_end(fp)
        return entry

    @staticmethod
    def _check_plan(circuit: CompiledCircuit) -> None:
        if circuit.multivalue and any(lv.mv_leader is None
                                      for lv in circuit.levels):
            raise ValueError("a multivalue circuit needs its multi-value "
                             "plan: compile it with "
                             "compile_circuit(multivalue=True)")

    def _device_plan(self, circuit: CompiledCircuit):
        """LUT table and level plan arrays on this executor's device, cached
        on the circuit (the plans are immutable once compiled).  A
        multi-value level is (rot_slots, rot_coefs, rot_consts, weights,
        leader, out_idx, positions), positions staying a host tuple."""
        cache = circuit.__dict__.setdefault("_torch_plans", {})
        key = str(self.device)
        if key not in cache:
            dev = self._upload
            luts = dev(circuit.luts.view(self._np_s), self._dtype)
            # slot indices are int64, the index type of torch's gathers
            if circuit.multivalue:
                levels = [(dev(lv.rot_slots, I64), dev(lv.rot_coefs),
                           dev(lv.rot_consts), dev(lv.mv_weights),
                           dev(lv.mv_leader, I64), dev(lv.out_idx, I64),
                           lv.mv_positions)
                          for lv in circuit.levels]
            else:
                levels = [(dev(lv.in_slots, I64), dev(lv.in_coefs),
                           dev(lv.consts), dev(lv.lut_idx),
                           dev(lv.out_idx, I64))
                          for lv in circuit.levels]
            cache[key] = (luts, levels)
        return cache[key]

    def _upload(self, a: np.ndarray, dtype=torch.int32) -> torch.Tensor:
        return torch.from_numpy(np.ascontiguousarray(a)).to(self.device,
                                                            dtype)

    def _device_chunks_many(self, circuit: CompiledCircuit, C: int,
                            wide_batch: bool):
        """The packed run_many launch plan on this executor's device,
        cached on the circuit per (C, wide_batch, device).

        Only the ACTIVE ops of each level are packed, content after
        content; a content's slot s lives at c * S + s in the packed slab
        (S = circuit.num_slots), and inputs with coefficient 0 keep
        gathering slot 0.  Padded rows gather slot 0 and write the trash
        slot S - 1."""
        cache = circuit.__dict__.setdefault("_torch_chunks_many", {})
        key = (C, bool(wide_batch), str(self.device))
        if key in cache:
            return cache[key]
        S = circuit.num_slots
        offs = (np.arange(C, dtype=np.int32) * S)[:, None]
        chunks, rows = [], []
        for lv in circuit.levels:
            act = lv.lut_idx >= 0
            a_slots, a_coefs = lv.in_slots[act], lv.in_coefs[act]
            t_slots = np.where(a_coefs[None] != 0,
                               a_slots[None] + offs[:, None], 0).reshape(-1, 3)
            t_coefs = np.tile(a_coefs, (C, 1))
            t_consts = np.tile(lv.consts[act], C)
            t_lut = np.tile(lv.lut_idx[act], C)
            t_out = (lv.out_idx[act][None] + offs).reshape(-1)
            total = t_out.shape[0]
            sizes = _chunk_sizes(total, wide_batch)
            pad = sum(sizes) - total
            t_slots = np.concatenate([t_slots, np.zeros((pad, 3), np.int32)])
            t_coefs = np.concatenate([t_coefs, np.zeros((pad, 3), np.int32)])
            t_consts = np.concatenate([t_consts, np.zeros(pad, np.int32)])
            t_lut = np.concatenate([t_lut, np.full(pad, -1, np.int32)])
            t_out = np.concatenate([t_out, np.full(pad, S - 1, np.int32)])
            c0 = 0
            for w in sizes:
                sl = slice(c0, c0 + w)
                c0 += w
                rows.append((str(w), w, int((t_lut[sl] >= 0).sum())))
                chunks.append((self._upload(t_slots[sl], I64),
                               self._upload(t_coefs[sl]),
                               self._upload(t_consts[sl]),
                               self._upload(t_lut[sl]),
                               self._upload(t_out[sl], I64)))
        cache[key] = chunks
        circuit.__dict__.setdefault("_torch_rows_many", {})[key] = rows
        return chunks

    @staticmethod
    def _mv_pad_rows(n: int) -> int:
        """Packed multi-value op batches pad to {64, 256, multiples of
        1024}, as in the JAX package."""
        for b in (64, 256, 1024):
            if n <= b:
                return b
        return -(-n // 1024) * 1024

    # accumulator rows of one packed multi-value step: 4096 rows of
    # (k+1)*N int32 = 64 MB (half as many at 64 bits, where a row is twice
    # as wide).  Compiled level plans hold <= MAX_LEVEL_BATCH rotations,
    # so a content group spans >= 8 contents.
    MAX_MV_ACC_ROWS = 4096

    @property
    def _mv_acc_rows_cap(self) -> int:
        return (self.MAX_MV_ACC_ROWS if self.params.torus_bits == 32
                else self.MAX_MV_ACC_ROWS // 2)

    def _device_chunks_many_mv(self, circuit: CompiledCircuit, C: int,
                               wide_batch: bool):
        """The packed run_many plan of a multi-value circuit, cached on the
        circuit per (C, wide_batch, device): one step per (level, content
        group) of at most ``_mv_acc_rows_cap`` rotations, each step a list
        of rotation chunks (rot_slots, rot_coefs, rot_consts) of the widths
        of ``_chunk_sizes`` and one finish (weights, leader, out_idx,
        positions) over the group's packed ops.  A leader indexes the
        concatenation of the step's chunk outputs: content c's rotation r
        is row (c - g0) * R + r, actives before the tail padding."""
        cache = circuit.__dict__.setdefault("_torch_chunks_many_mv", {})
        key = (C, bool(wide_batch), str(self.device))
        if key in cache:
            return cache[key]
        S = circuit.num_slots
        dev = self._upload
        steps, rows = [], []
        for lv in circuit.levels:
            act = lv.lut_idx >= 0
            R = lv.mv_rot_count
            group = max(1, min(C, self._mv_acc_rows_cap // max(1, R)))
            a_w, a_ld, a_out = (lv.mv_weights[act], lv.mv_leader[act],
                                lv.out_idx[act])
            r_slots, r_coefs, r_consts = (lv.rot_slots[:R], lv.rot_coefs[:R],
                                          lv.rot_consts[:R])
            for g0 in range(0, C, group):
                g = min(group, C - g0)
                offs = (np.arange(g0, g0 + g, dtype=np.int32) * S)[:, None]
                t_rs = np.where(r_coefs[None] != 0,
                                r_slots[None] + offs[:, None], 0).reshape(-1, 3)
                t_rc = np.tile(r_coefs, (g, 1))
                t_rk = np.tile(r_consts, g)
                sizes = _chunk_sizes(g * R, wide_batch)
                pad = sum(sizes) - g * R
                rows.append(("+".join(map(str, sizes)), sum(sizes), g * R))
                t_rs = np.concatenate([t_rs, np.zeros((pad, 3), np.int32)])
                t_rc = np.concatenate([t_rc, np.zeros((pad, 3), np.int32)])
                t_rk = np.concatenate([t_rk, np.zeros(pad, np.int32)])
                rot_chunks, c0 = [], 0
                for w in sizes:
                    sl = slice(c0, c0 + w)
                    c0 += w
                    rot_chunks.append((dev(t_rs[sl], I64), dev(t_rc[sl]),
                                       dev(t_rk[sl])))
                t_w = np.tile(a_w, (g, 1))
                t_ld = (a_ld[None] + (np.arange(g, dtype=np.int32) * R)[:, None]
                        ).reshape(-1)
                t_out = (a_out[None] + offs).reshape(-1)
                padb = self._mv_pad_rows(t_out.shape[0]) - t_out.shape[0]
                t_w = np.concatenate([t_w, np.zeros((padb, t_w.shape[1]),
                                                    np.int32)])
                t_ld = np.concatenate([t_ld, np.zeros(padb, np.int32)])
                t_out = np.concatenate([t_out, np.full(padb, S * C - 1,
                                                       np.int32)])
                steps.append((rot_chunks, (dev(t_w), dev(t_ld, I64),
                                           dev(t_out, I64), lv.mv_positions)))
        cache[key] = steps
        circuit.__dict__.setdefault("_torch_rows_many", {})[key] = rows
        return steps

    def _restore(self, words: np.ndarray, rows: int) -> torch.Tensor:
        """A checkpointed slab (uint32 words; 64-bit words as limb pairs)
        back on the device as this executor's [rows, n+1] slab."""
        n1 = self.params.lwe_dimension + 1
        a = np.ascontiguousarray(words).view(self._np_s).reshape(-1, n1)
        if a.shape[0] != rows:
            raise ValueError(f"checkpointed slab has {a.shape[0]} rows, this "
                             f"plan needs {rows}")
        return self._upload(a, self._dtype)

    def run_many(self, circuit: CompiledCircuit, contents: np.ndarray,
                 wide_batch: "bool | None" = None,
                 checkpoint: "str | None" = None,
                 checkpoint_every: int = 0,
                 resume: "str | None" = None,
                 roots_on_device: bool = False
                 ) -> "np.ndarray | torch.Tensor":
        """Match ONE compiled circuit against MANY encrypted contents.

        contents: [C, len, num_blocks, n+1] uint32 (uint64 at 64 bits) ->
        [C, num_blocks, n+1] ([C, R, num_blocks, n+1] for R roots); with
        ``roots_on_device`` the results' block-0 rows stay on the device
        as this executor's slab words, [C, n+1] ([C, R, n+1]), nothing is
        downloaded, and the call waits for the device before it returns
        (``or_reduce`` takes such rows).  Every
        level's bootstrap batch spans all C contents (``_device_chunks_many``;
        ``_device_chunks_many_mv`` for a multi-value circuit, whose
        rotations of a step all read the slab before its finish writes).
        ``wide_batch`` adds the WIDE_LEVEL_BATCH launch width for big packed
        levels (default: on for a CUDA device, off elsewhere;
        FHE_REGEX_WIDE_BATCH=0|1 overrides).

        checkpoint/resume: with ``checkpoint`` + ``checkpoint_every=k`` the
        packed slab is saved every k launch steps while steps remain (a
        step = one classic chunk launch, or one multi-value rotations +
        finish plan entry).  ``resume=path`` restores a saved slab and
        replays only the remaining steps; ``contents`` then counts only for
        its C.  The resume must use the same circuit, C and wide_batch: a
        wrong C or step count is refused as in the JAX package, and so is
        any other plan, by the ``circuit_fingerprint`` the checkpoint
        carries.  The elapsed time of the whole call feeds
        ``self.watchdog`` under ("many", C, pbs_count, num_slots,
        multivalue, wide_batch).
        """
        self._check_plan(circuit)
        with trace.Span("executor.run_many") as run_span:
            out = self._run_many(circuit, contents, wide_batch, checkpoint,
                                 checkpoint_every, resume, roots_on_device,
                                 run_span.start_ns)
        return out

    def _run_many(self, circuit, contents, wide_batch, checkpoint,
                  checkpoint_every, resume, roots_on_device: bool,
                  t_run0: int) -> "np.ndarray | torch.Tensor":
        if wide_batch is None:
            env = os.environ.get("FHE_REGEX_WIDE_BATCH")
            wide_batch = (env == "1" if env is not None
                          else self.device.type == "cuda")
        wide_batch = bool(wide_batch)
        params = self.params
        C = contents.shape[0]
        n1 = params.lwe_dimension + 1
        S = circuit.num_slots
        mv = circuit.multivalue
        steps = (self._device_chunks_many_mv(circuit, C, wide_batch) if mv
                 else self._device_chunks_many(circuit, C, wide_batch))
        rows = circuit.__dict__["_torch_rows_many"][
            (C, wide_batch, str(self.device))]
        saving = checkpoint is not None and checkpoint_every > 0
        fp = (circuit_fingerprint(circuit, C, wide_batch, len(steps))
              if saving or resume is not None else None)
        start = 0
        if resume is not None:
            words, start, ck_C, ck_total = _ckpt.load_many_slab(resume)
            if ck_C != C:
                raise ValueError(
                    f"resume checkpoint was taken at C={ck_C} contents, "
                    f"got C={C} — the packed plan does not match")
            if ck_total != len(steps):
                raise ValueError(
                    f"resume checkpoint recorded {ck_total} steps, this "
                    f"plan has {len(steps)} — circuit/wide_batch mismatch")
            _check_fingerprint(resume, fp)
            slab = self._restore(words, C * S)
        else:
            with trace.Span("executor.fill"):
                slab = torch.zeros((C * S, n1), dtype=self._dtype,
                                   device=self.device)
                if contents.size:
                    flat = np.ascontiguousarray(contents.reshape(C, -1, n1),
                                                dtype=self._np_u)
                    L = flat.shape[1]
                    ridx = (np.arange(C)[:, None] * S + 1
                            + np.arange(L)[None, :]).reshape(-1)
                    slab[self._upload(ridx, I64)] = self._upload(
                        flat.reshape(C * L, n1).view(self._np_s),
                        self._dtype)
        luts = None if mv else self._device_plan(circuit)[0]
        timer = _Steps(self, trace.recording())
        for si in range(start, len(steps)):
            with timer.step(*rows[si]):
                if mv:
                    rot_chunks, fin = steps[si]
                    accs = [self._mv_rotate(self._vlut, self._affine_combine(
                        slab[s], coefs, consts))
                        for s, coefs, consts in rot_chunks]
                    weights, leader, out_idx, positions = fin
                    slab[out_idx] = self._mv_finish(torch.cat(accs), weights,
                                                    leader, positions)
                else:
                    self._run_level(slab, luts, *steps[si])
            if (saving and (si + 1) % checkpoint_every == 0
                    and si + 1 < len(steps)):
                _ckpt.save_many_slab(checkpoint, slab.cpu().numpy(), si + 1,
                                     C, len(steps), fingerprint=fp)
        with trace.Span("executor.finalize"):
            out = self._root_rows(circuit, slab, C)
            if not roots_on_device:
                rows = out.cpu().numpy().view(self._np_u)
                out = np.zeros((C, rows.shape[1], params.num_blocks, n1),
                               self._np_u)
                out[:, :, 0] = rows
            elif self.device.type == "cuda":
                # as a download would, so the time below is the run's
                torch.cuda.current_stream(self.device).synchronize()
        timer.close()
        # the root download above waited for the device, so the time is
        # the run's own (the JAX package's run_many feeds no watchdog)
        self.watchdog.observe(("many", C, circuit.pbs_count, S, mv,
                               wide_batch), (time.time_ns() - t_run0) / 1e9)
        return out[:, 0] if circuit.roots is None else out

    def _root_rows(self, circuit: CompiledCircuit, slab,
                   C: int) -> torch.Tensor:
        """Block 0 of every content's root ciphertexts on the device, [C,
        R, n+1] slab words, from one gather of the root rows: the rows
        ``_assemble_root`` makes (the root's sign and constant applied; a
        constant root's row trivial).  The other blocks are zero."""
        S, vals = circuit.num_slots, [r.val for r in circuit.all_roots]
        ridx = (np.arange(C)[:, None] * S
                + np.asarray([v.slot if v.sign else 0 for v in vals])[None])
        sign = self._upload(np.asarray([v.sign for v in vals]), I64)
        rows = slab[self._upload(ridx, I64)].to(I64) * sign[:, None]
        rows[..., -1] += self._upload(
            np.asarray([v.const * self.params.delta for v in vals]), I64)
        return rows if self.params.torus_bits == 64 else wrap_i32(rows)

    @functools.cached_property
    def _or_luts(self) -> torch.Tensor:
        """The OR2 and OR3 test polynomials on the device, LUTs 0 and 1 of
        ``or_reduce``'s launches."""
        luts = np.stack([make_lut_poly(self.params, lut_fn(LUT_OR2)),
                         make_lut_poly(self.params, lut_fn(LUT_OR3))])
        return self._upload(luts.view(self._np_s), self._dtype)

    def or_tree(self, M: int) -> OrTree:
        """The OR tree of M bits on this executor's device, made at its
        first use and kept per M (``_or_tree``)."""
        with self._or_lock:
            tree = self._or_trees.get(M)
            if tree is None:
                tree = self._or_trees[M] = _or_tree(M, self._upload)
            return tree

    def or_reduce(self, bits: torch.Tensor) -> np.ndarray:
        """Homomorphic OR of M encrypted bits -> one radix ciphertext
        [num_blocks, n+1] (uint32 / uint64), the bit in block 0.

        ``bits`` [M, n+1]: block-0 rows on this executor's device, as
        ``run_many(roots_on_device=True)`` hands them over.  The rounds of
        ``or_tree(M)`` run over a slab on the device, each an
        ``executor.level`` step under the key "or"; the answer row is the
        one download."""
        M = bits.shape[0]
        tree = self.or_tree(M)
        n1 = self.params.lwe_dimension + 1
        slab = torch.zeros((tree.slab_rows, n1), dtype=self._dtype,
                           device=self.device)
        slab[:M] = bits
        timer = _Steps(self, trace.recording())
        for needed, launches in tree.rounds:
            with timer.step("or", sum(lv[0].shape[0] for lv in launches),
                            needed):
                for lv in launches:
                    self._run_level(slab, self._or_luts, *lv)
        row = slab[tree.answer].cpu().numpy()
        timer.close()
        out = np.zeros((self.params.num_blocks, n1), self._np_u)
        out[0] = row.view(self._np_u)
        return out

    def run(self, circuit: CompiledCircuit,
            content_blocks: "np.ndarray | None",
            profile: bool = False, checkpoint: "str | None" = None,
            checkpoint_every: int = 0,
            resume: "str | None" = None,
            fuse: "bool | None" = None) -> np.ndarray:
        """content_blocks: [len, num_blocks, n+1] uint32 (uint64 at 64
        bits) -> radix result [num_blocks, n+1] of the same type
        ([R, num_blocks, n+1] for R roots).

        With profile=True each level's device seconds are timed (``_Steps``:
        CUDA events read after the root download, nothing synchronised per
        level); per-level stats land in ``self.last_run_stats`` (with the
        rotation batch of a multi-value level), and the
        failure-probability contract at this key's operating point in
        ``self.last_run_pfail``.

        checkpoint/resume: with ``checkpoint`` + ``checkpoint_every=k`` the
        slab is saved every k levels while levels remain; ``resume=path``
        restores a saved slab and continues from its level
        (``content_blocks`` is then ignored and may be None).  A checkpoint
        carries the ``circuit_fingerprint`` of its circuit, and a resume of
        any other circuit raises ValueError.

        ``fuse`` runs the whole level loop as one unit (``fused_levels``):
        on CUDA one CUDA graph, captured at the first such run of the plan
        on this executor and replayed after; on the CPU the same loop in one
        call.  None takes ``default_fuse`` (FHE_REGEX_FUSE_LEVELS=0|1
        forces it).  ``profile``, ``resume`` and checkpointing need level
        boundaries and keep the per-level loop.  Fused runs of one executor
        share its static slabs and take turns under one lock.

        The elapsed time of the whole call feeds ``self.watchdog`` under
        ("levels", pbs_count, num_slots, multivalue), or ("fused", ...) for
        a fused run."""
        self._check_plan(circuit)
        with trace.Span("executor.run") as run_span:
            out = self._run(circuit, content_blocks, profile, checkpoint,
                            checkpoint_every, resume, fuse, run_span.start_ns)
        return out

    def _run(self, circuit, content_blocks, profile, checkpoint,
             checkpoint_every, resume, fuse, t_run0: int) -> np.ndarray:
        saving = checkpoint is not None and checkpoint_every > 0
        if fuse is None:
            fuse = default_fuse(circuit, self.device, self._dev_key.backend,
                                1 if self.mesh is None else self.mesh.size())
        rows = _level_rows(circuit)
        if fuse and resume is None and not profile and not saving:
            timer = _Steps(self, trace.recording())
            with self._fused_lock:
                slab = self.fused_levels(circuit).run(
                    lambda s: self._fill(s, content_blocks),
                    timer.step("+".join(str(w) for w, _ in rows),
                               sum(w for w, _ in rows),
                               sum(n for _, n in rows)))
                out = self._finalize(circuit, slab)
            timer.close()
            self.last_run_stats = []
            # the root download waited for the whole loop
            self.watchdog.observe(("fused", circuit.pbs_count,
                                   circuit.num_slots, circuit.multivalue),
                                  (time.time_ns() - t_run0) / 1e9)
            return out
        fp = (circuit_fingerprint(circuit)
              if saving or resume is not None else None)
        start = 0
        if resume is not None:
            _check_fingerprint(resume, fp)
            words, start = _ckpt.load_slab(resume)
            slab = self._restore(words, circuit.num_slots)
        else:
            with trace.Span("executor.fill"):
                slab = torch.zeros((circuit.num_slots,
                                    self.params.lwe_dimension + 1),
                                   dtype=self._dtype, device=self.device)
                self._fill(slab, content_blocks)
        luts, levels = self._device_plan(circuit)
        timer = _Steps(self, profile or trace.recording())
        for li in range(start, len(levels)):
            w, n = rows[li]
            with timer.step(str(w), w, n):
                if circuit.multivalue:
                    self._run_level_mv(slab, *levels[li])
                else:
                    self._run_level(slab, luts, *levels[li])
            if (saving and (li + 1) % checkpoint_every == 0
                    and li + 1 < len(levels)):
                _ckpt.save_slab(checkpoint, slab.cpu().numpy(), li + 1,
                                fingerprint=fp)
        out = self._finalize(circuit, slab)
        seconds = timer.close()
        stats = []
        if profile:
            for li, secs in zip(range(start, len(levels)), seconds):
                lv = circuit.levels[li]
                stat = {"width": int(lv.lut_idx.shape[0]),
                        "active": int((lv.lut_idx >= 0).sum()),
                        "seconds": secs}
                if circuit.multivalue:
                    stat["rotations"] = int(lv.rot_slots.shape[0])
                stats.append(stat)
            self.last_run_pfail = circuit_pfail(
                self.params, circuit, bsk_drop=_dev_key_drop(self._dev_key))
        self.last_run_stats = stats
        # _finalize's download waited for the device: the time is real
        self.watchdog.observe(("levels", circuit.pbs_count, circuit.num_slots,
                               circuit.multivalue),
                              (time.time_ns() - t_run0) / 1e9)
        return out

    def _fill(self, slab: torch.Tensor, content_blocks: np.ndarray) -> None:
        """The content ciphertexts into slab rows 1.. (a zeroed slab)."""
        if content_blocks.size:
            n1 = self.params.lwe_dimension + 1
            flat = np.ascontiguousarray(content_blocks.reshape(-1, n1),
                                        dtype=self._np_u)
            slab[1:1 + flat.shape[0]] = torch.from_numpy(
                flat.view(self._np_s)).to(self.device)

    def _finalize(self, circuit: CompiledCircuit, slab) -> np.ndarray:
        """Single root -> [num_blocks, n+1]; multi-root -> [R, num_blocks, n+1].

        Only the root rows are downloaded (one gather), never the slab."""
        with trace.Span("executor.finalize"):
            params = self.params
            roots = circuit.all_roots
            slots = [r.val.slot for r in roots if r.val.sign != 0]
            rows = (slab[torch.tensor(slots, device=self.device)].cpu()
                    .numpy() if slots else None)
            outs, ri = [], 0
            for r in roots:
                val: BitVal = r.val
                if val.sign == 0:
                    outs.append(_assemble_root(params, val, None))
                else:
                    ct_u = rows[ri].view(self._np_u)
                    ri += 1
                    outs.append(_assemble_root(params, val, ct_u))
            return outs[0] if circuit.roots is None else np.stack(outs)
