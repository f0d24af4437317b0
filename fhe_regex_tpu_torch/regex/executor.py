"""Level-scheduled batched executor (PyTorch).

The twin of ``fhe_regex_tpu/regex/executor.py`` for the classic plan: the
hash-consed micro-op DAG (regex/circuit.py) is level-scheduled ahead of
time, and every level is ONE batched PBS call over all bootstraps whose
inputs are ready.  Each level executes:
  1. affine gather:  x_i = sum_k coef_ik * slab[slot_ik] + const_i * delta
  2. batched PBS with per-instance LUT selection
  3. scatter of outputs into the ciphertext slab

``compile_circuit`` produces the same level plans as the JAX package's
(same buckets, same slot numbering), so slabs compare level by level.
Level batch widths are padded to power-of-two buckets; padded instances
write to a trash slot.

The slab holds torus values as int32 bits at 32 bits and int64 bits at 64
bits; ciphertexts cross the API as uint32 / uint64 numpy arrays.

``Executor.run_many`` is the serving path: one compiled circuit against C
contents, every level's active bootstraps packed across the contents and
cut into launches of the three widths of ``_chunk_sizes``.
"""

from __future__ import annotations

import dataclasses
import os
import time
from typing import Dict, List

import numpy as np
import torch

from fhe_regex_tpu_torch.crypto.golden import make_lut_poly
from fhe_regex_tpu_torch.ops.luts import LutKey, lut_fn
from fhe_regex_tpu_torch.ops.pbs import I64, make_pbs_core, wrap_i32
from fhe_regex_tpu_torch.params import Params
from fhe_regex_tpu_torch.regex.circuit import BitVal, CircuitBuilder, Node, PbsOp

U32 = np.uint32


@dataclasses.dataclass
class LevelPlan:
    in_slots: np.ndarray   # [W, 3] int32
    in_coefs: np.ndarray   # [W, 3] int32
    consts: np.ndarray     # [W] int32 (plaintext units)
    lut_idx: np.ndarray    # [W] int32
    out_idx: np.ndarray    # [W] int32


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

    @property
    def pbs_count(self) -> int:
        return sum(int((lv.lut_idx >= 0).sum()) for lv in self.levels)

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


def compile_circuit(params: Params, builder: CircuitBuilder,
                    root: "Node | List[Node]",
                    min_bucket: int = 8,
                    max_batch: int = MAX_LEVEL_BATCH) -> CompiledCircuit:
    """Level-schedule a builder's op DAG.  `root` may be one Node or a list
    of them (multi-pattern circuits); `run` then returns one result row per
    root."""
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
            levels.append(LevelPlan(in_slots, in_coefs, consts, lut_idx,
                                    out_idx))

    return CompiledCircuit(
        params=params,
        num_slots=num_slots,
        levels=levels,
        luts=luts,
        root=root,
        ct_ops=builder.ct_ops,
        cache_hits=builder.cache_hits,
        roots=roots,
    )


class Executor:
    """Runs compiled circuits against one server key's device material."""

    def __init__(self, params: Params, dev_key):
        self.params = params
        self.device = dev_key.device
        self._core = make_pbs_core(dev_key)
        self.last_run_stats: List[dict] = []
        wide = params.torus_bits == 64
        self._dtype = I64 if wide else torch.int32
        self._np_u = np.uint64 if wide else U32       # the bits at the API
        self._np_s = np.int64 if wide else np.int32   # the same, as tensors

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

    def _device_plan(self, circuit: CompiledCircuit):
        """LUT table and level plan arrays on this executor's device, cached
        on the circuit (the plans are immutable once compiled)."""
        cache = circuit.__dict__.setdefault("_torch_plans", {})
        key = str(self.device)
        if key not in cache:
            dev = self._upload
            luts = dev(circuit.luts.view(self._np_s), self._dtype)
            # slot indices are int64, the index type of torch's gathers
            levels = [(dev(lv.in_slots, I64), dev(lv.in_coefs),
                       dev(lv.consts), dev(lv.lut_idx), dev(lv.out_idx, I64))
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
        chunks = []
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
                chunks.append((self._upload(t_slots[sl], I64),
                               self._upload(t_coefs[sl]),
                               self._upload(t_consts[sl]),
                               self._upload(t_lut[sl]),
                               self._upload(t_out[sl], I64)))
        cache[key] = chunks
        return chunks

    def run_many(self, circuit: CompiledCircuit, contents: np.ndarray,
                 wide_batch: "bool | None" = None) -> np.ndarray:
        """Match ONE compiled circuit against MANY encrypted contents.

        contents: [C, len, num_blocks, n+1] uint32 (uint64 at 64 bits) ->
        [C, num_blocks, n+1] ([C, R, num_blocks, n+1] for R roots).  Every
        level's bootstrap batch spans all C contents (``_device_chunks_many``).
        ``wide_batch`` adds the WIDE_LEVEL_BATCH launch width for big packed
        levels (default: on for a CUDA device, off elsewhere;
        FHE_REGEX_WIDE_BATCH=0|1 overrides).
        """
        if getattr(circuit, "multivalue", False):
            raise NotImplementedError(
                "multi-value circuits are not ported yet (ROADMAP.md, "
                "queue 1 item 4)")
        if wide_batch is None:
            env = os.environ.get("FHE_REGEX_WIDE_BATCH")
            wide_batch = (env == "1" if env is not None
                          else self.device.type == "cuda")
        params = self.params
        C = contents.shape[0]
        n1 = params.lwe_dimension + 1
        S = circuit.num_slots
        slab = torch.zeros((C * S, n1), dtype=self._dtype, device=self.device)
        if contents.size:
            flat = np.ascontiguousarray(contents.reshape(C, -1, n1),
                                        dtype=self._np_u)
            L = flat.shape[1]
            rows = (np.arange(C)[:, None] * S + 1
                    + np.arange(L)[None, :]).reshape(-1)
            slab[self._upload(rows, I64)] = self._upload(
                flat.reshape(C * L, n1).view(self._np_s), self._dtype)
        luts, _ = self._device_plan(circuit)
        for chunk in self._device_chunks_many(circuit, C, wide_batch):
            self._run_level(slab, luts, *chunk)
        roots = circuit.all_roots
        slots = [r.val.slot for r in roots if r.val.sign != 0]
        if slots:
            ridx = (np.arange(C)[:, None] * S
                    + np.asarray(slots)[None, :]).reshape(-1)
            got = slab[self._upload(ridx, I64)].cpu().numpy().reshape(
                C, len(slots), n1)
        out = np.zeros((C, len(roots), params.num_blocks, n1), self._np_u)
        for ci in range(C):
            ri = 0
            for pi, r in enumerate(roots):
                ct_u = None
                if r.val.sign != 0:
                    ct_u = got[ci, ri].view(self._np_u)
                    ri += 1
                out[ci, pi] = _assemble_root(params, r.val, ct_u)
        return out[:, 0] if circuit.roots is None else out

    def run(self, circuit: CompiledCircuit, content_blocks: np.ndarray,
            profile: bool = False) -> np.ndarray:
        """content_blocks: [len, num_blocks, n+1] uint32 (uint64 at 64
        bits) -> radix result [num_blocks, n+1] of the same type
        ([R, num_blocks, n+1] for R roots).

        With profile=True each level is synchronized and timed; per-level
        stats land in ``self.last_run_stats``."""
        n1 = self.params.lwe_dimension + 1
        slab = torch.zeros((circuit.num_slots, n1), dtype=self._dtype,
                           device=self.device)
        if content_blocks.size:
            flat = np.ascontiguousarray(content_blocks.reshape(-1, n1),
                                        dtype=self._np_u)
            slab[1:1 + flat.shape[0]] = torch.from_numpy(
                flat.view(self._np_s)).to(self.device)
        luts, levels = self._device_plan(circuit)
        stats = []
        for lv, dev in zip(circuit.levels, levels):
            t0 = time.perf_counter()
            self._run_level(slab, luts, *dev)
            if profile:
                if self.device.type == "cuda":
                    torch.cuda.synchronize(self.device)
                stats.append({"width": int(lv.lut_idx.shape[0]),
                              "active": int((lv.lut_idx >= 0).sum()),
                              "seconds": time.perf_counter() - t0})
        self.last_run_stats = stats
        return self._finalize(circuit, slab)

    def _finalize(self, circuit: CompiledCircuit, slab) -> np.ndarray:
        """Single root -> [num_blocks, n+1]; multi-root -> [R, num_blocks, n+1].

        Only the root rows are downloaded (one gather), never the slab."""
        params = self.params
        roots = circuit.all_roots
        slots = [r.val.slot for r in roots if r.val.sign != 0]
        rows = (slab[torch.tensor(slots, device=self.device)].cpu().numpy()
                if slots else None)
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
