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
"""

from __future__ import annotations

import dataclasses
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

    def _run_level(self, slab, luts, in_slots, in_coefs, consts, lut_idx,
                   out_idx) -> None:
        """One level, updating ``slab`` in place."""
        gathered = slab[in_slots].to(I64)                  # [W, 3, n+1]
        x = (in_coefs[:, :, None].to(I64) * gathered).sum(dim=1)
        x[:, -1] += consts.to(I64) * self.params.delta
        outs = self._core(luts, lut_idx.clamp(min=0), wrap_i32(x))
        # padded rows all write the trash slot; which duplicate lands there
        # is unspecified on CUDA, and the trash slot is never read
        slab[out_idx] = outs

    def _device_plan(self, circuit: CompiledCircuit):
        """LUT table and level plan arrays on this executor's device, cached
        on the circuit (the plans are immutable once compiled)."""
        cache = circuit.__dict__.setdefault("_torch_plans", {})
        key = str(self.device)
        if key not in cache:
            def dev(a, dtype=torch.int32):
                return torch.from_numpy(np.ascontiguousarray(a)).to(
                    self.device, dtype)
            luts = dev(circuit.luts.view(np.int32))
            # slot indices are int64, the index type of torch's gathers
            levels = [(dev(lv.in_slots, I64), dev(lv.in_coefs),
                       dev(lv.consts), dev(lv.lut_idx), dev(lv.out_idx, I64))
                      for lv in circuit.levels]
            cache[key] = (luts, levels)
        return cache[key]

    def run(self, circuit: CompiledCircuit, content_blocks: np.ndarray,
            profile: bool = False) -> np.ndarray:
        """content_blocks: [len, num_blocks, n+1] uint32 -> radix result
        [num_blocks, n+1] uint32 ([R, num_blocks, n+1] for R roots).

        With profile=True each level is synchronized and timed; per-level
        stats land in ``self.last_run_stats``."""
        n1 = self.params.lwe_dimension + 1
        slab = torch.zeros((circuit.num_slots, n1), dtype=torch.int32,
                           device=self.device)
        if content_blocks.size:
            flat = np.ascontiguousarray(content_blocks.reshape(-1, n1))
            slab[1:1 + flat.shape[0]] = torch.from_numpy(
                flat.view(np.int32)).to(self.device)
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
                ct_u = rows[ri].view(U32)
                ri += 1
                outs.append(_assemble_root(params, val, ct_u))
        return outs[0] if circuit.roots is None else np.stack(outs)
