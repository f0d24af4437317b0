"""Hash-consed circuit builder — the AOT replacement for the reference's
memoizing execution context (src/regex/execution.rs).

Core architectural move (SURVEY.md §7): the reference interleaves DAG
construction and FHE execution through ``Execution``'s runtime HashMap cache.
But the op DAG depends only on (pattern, content length) — no ciphertext data
dependence — so we build the whole deduplicated DAG ahead of time and execute
it later in batched levels.  This module replicates ``Execution``'s exact
semantics symbolically:

  - structural ``Executed`` expression identity as the cache key (Q11;
    execution.rs:8-19, :212-222)
  - trivial-constant short-circuits in ct_and/ct_or that bypass both the
    cache and the op counters (Q10; execution.rs:121-134, :154-164) —
    note the short-circuit returns the *other operand's value* under the
    *full And/Or expression identity*, which we reproduce
  - ct_not is XOR with trivial 1 and always runs as an op (Q9;
    execution.rs:178-195)
  - the same ``ct_ops`` / ``cache_hits`` counters (execution.rs:56-62), so
    counts are comparable 1:1 with the reference's logs (engine.rs:36-40)

Lowering: every logical op becomes micro-ops of one uniform shape — a cheap
affine combine of up to 3 ciphertext slots plus a constant, feeding one PBS
with a LUT (ops/luts.py).  NOT is affine (1 - x) and costs zero bootstraps
(the reference spends a full smart_bitxor on it).  eq/gt/le on a byte split
into per-nibble LUTs + one combine LUT: 3-4 bootstraps instead of tfhe-rs's
carry-managed radix smart ops.
"""

from __future__ import annotations

import dataclasses
import logging
from typing import Dict, List, Optional, Tuple

from fhe_regex_tpu_torch.ops.luts import (
    LUT_AND2,
    LUT_AND3,
    LUT_EQ,
    LUT_GE4,
    LUT_GT,
    LUT_GT_COMBINE,
    LUT_IDENT,
    LUT_LE,
    LUT_LE_COMBINE,
    LUT_LT,
    LUT_MOD4,
    LUT_OR2,
    LUT_OR3,
    LutKey,
)

# ---------------- Executed expression identity (cache keys) ----------------
# Tuples: ("const", c) | ("ctpos", at) | (op, a, b) | ("not", a)

Expr = Tuple

logger = logging.getLogger("fhe_regex_tpu_torch.circuit")

# The reference logs cache hits at trace! (execution.rs:214) — Python
# logging has no TRACE, so register level 5 (enable via FHE_REGEX_LOG=TRACE)
TRACE = 5
logging.addLevelName(TRACE, "TRACE")

_EXPR_OP = {"and": "/\\", "or": "\\/", "eq": "==", "ge": ">=", "le": "<="}


def format_expr(e: Expr) -> str:
    """Pretty-print an ``Executed`` expression in the reference's Debug
    format (execution.rs:225-276): constants 0/1 as ``f``/``t``, other
    constants as their character, ``ct_<at>`` for content positions, and
    parenthesized infix ``/\\ \\/ == >= <=`` plus prefix ``(!...)``.

    Iterative (explicit stack): strict-fold exprs nest one level per OR'd
    branch, which would overflow Python's recursion limit on long contents.
    """
    out: List[str] = []
    stack: List[object] = [e]
    while stack:
        x = stack.pop()
        if isinstance(x, str):
            out.append(x)
            continue
        kind = x[0]
        if kind == "const":
            c = x[1]
            out.append("f" if c == 0 else "t" if c == 1 else chr(c))
        elif kind == "ctpos":
            out.append(f"ct_{x[1]}")
        elif kind == "not":
            out.append("(!")
            stack.extend([")", x[1]])
        else:
            out.append("(")
            stack.extend([")", x[2], _EXPR_OP[kind], x[1]])
    return "".join(out)


def expr_const(c: int) -> Expr:
    return ("const", c)


def expr_ctpos(at: int) -> Expr:
    return ("ctpos", at)


def _const_of(e: Expr) -> Optional[int]:
    return e[1] if e[0] == "const" else None


CT_FALSE = 0
CT_TRUE = 1


# ---------------- values ----------------


@dataclasses.dataclass(frozen=True)
class BitVal:
    """Runtime value of a boolean node: an affine view of a slot or a const.

    value = const + sign * slot   (sign in {0, +1, -1}; slot None iff sign 0)
    """
    const: int
    sign: int
    slot: Optional[int]

    @staticmethod
    def constant(c: int) -> "BitVal":
        return BitVal(const=c, sign=0, slot=None)

    @staticmethod
    def of_slot(s: int) -> "BitVal":
        return BitVal(const=0, sign=1, slot=s)

    def negated(self) -> "BitVal":
        return BitVal(const=1 - self.const, sign=-self.sign, slot=self.slot)


@dataclasses.dataclass(frozen=True)
class Pending:
    """A not-yet-materialized flat associative gate (optimizing mode).

    Chains of the reference's binary and/or gates (Seq/Repeated AND chains,
    Range OR chains, the branch OR fold) are collected into flat sets and
    later materialized as balanced 3-ary LUT trees — same decrypted result
    (associativity + re-bootstrap per gate), log-depth, and ~2x fewer
    bootstraps than the reference's binary chains.
    """
    kind: str                 # 'and' | 'or'
    elems: Tuple[BitVal, ...]


@dataclasses.dataclass(frozen=True)
class Node:
    expr: Expr
    val: object               # BitVal | Pending


# ---------------- micro-ops ----------------


@dataclasses.dataclass(frozen=True)
class PbsOp:
    """One bootstrap: LUT applied to an affine combine of <=3 slots.

    in_slots/in_coefs are parallel, zero-padded to length 3; const is in
    plaintext units (added at delta scale to the body).
    """
    in_slots: Tuple[int, int, int]
    in_coefs: Tuple[int, int, int]
    const: int
    lut: LutKey
    out_slot: int
    level: int


class CircuitBuilder:
    """Symbolic twin of the reference's ``Execution`` (execution.rs:37-222).

    mode='strict': byte-identical cache/short-circuit/counter semantics.
    mode='opt':    flat associative gate collection + balanced 3-ary
                   materialization (Pending) — same decrypted results,
                   log-depth circuits; counters then reflect *our* gate
                   count, not the reference's.
    """

    def __init__(self, content_len: int, num_blocks: int = 4,
                 mode: str = "strict"):
        self.content_len = content_len
        self.num_blocks = num_blocks
        self.mode = mode
        # slot 0 is a reserved zero ciphertext (combine padding target)
        self.num_content_slots = 1 + content_len * num_blocks
        self.ops: List[PbsOp] = []
        self._cache: Dict[Expr, object] = {}
        self._microcache: Dict[Tuple, Tuple[int, int]] = {}  # key -> (slot, level)
        self._pendcache: Dict[Tuple, BitVal] = {}
        self._slot_level: Dict[int, int] = {}
        self.ct_ops = 0
        self.cache_hits = 0

    # ----- slot helpers -----

    def content_slot(self, at: int, block: int) -> int:
        return 1 + at * self.num_blocks + block

    def _level_of_slot(self, s: int) -> int:
        return self._slot_level.get(s, 0)   # content/zero slots are level 0

    def _emit_pbs(self, ins: List[Tuple[int, int]], const: int, lut: LutKey) -> int:
        """Hash-consed micro-op emission; returns the output slot."""
        ins = sorted(ins)
        key = (tuple(ins), const, lut)
        hit = self._microcache.get(key)
        if hit is not None:
            return hit[0]
        slots = [s for s, _ in ins]
        coefs = [c for _, c in ins]
        while len(slots) < 3:
            slots.append(0)
            coefs.append(0)
        level = 1 + max((self._level_of_slot(s) for s, _ in ins), default=0)
        out = self.num_content_slots + len(self.ops)
        self.ops.append(PbsOp(tuple(slots), tuple(coefs), const, lut, out, level))
        self._slot_level[out] = level
        self._microcache[key] = (out, level)
        return out

    def _bit_ins(self, bits: List[Tuple[BitVal, int]]) -> Tuple[List[Tuple[int, int]], int]:
        """Affine-combine spec for sum_i scale_i * bit_i."""
        ins: List[Tuple[int, int]] = []
        const = 0
        for bv, scale in bits:
            const += scale * bv.const
            if bv.sign != 0:
                ins.append((bv.slot, scale * bv.sign))
        return ins, const

    # ----- the reference cache protocol -----

    def _with_cache(self, expr: Expr, run) -> Node:
        hit = self._cache.get(expr)
        if hit is not None:
            if logger.isEnabledFor(TRACE):          # execution.rs:214
                logger.log(TRACE, "cache hit: %s", format_expr(expr))
            self.cache_hits += 1
            return Node(expr, hit)
        if logger.isEnabledFor(logging.DEBUG):      # execution.rs:218
            logger.debug("evaluation for: %s", format_expr(expr))
        self.ct_ops += 1
        val = run()
        self._cache[expr] = val
        return Node(expr, val)

    # ----- logical ops (execution.rs:64-222 semantics) -----

    def ct_constant(self, c: int) -> Node:
        return Node(expr_const(c), BitVal.constant(c))

    def ct_true(self) -> Node:
        return self.ct_constant(CT_TRUE)

    def ct_false(self) -> Node:
        return self.ct_constant(CT_FALSE)

    def _pair_vals(self, at: int):
        """Low/high nibble affine views of content[at] (values 0..15)."""
        lo = [(BitVal.of_slot(self.content_slot(at, 0)), 1),
              (BitVal.of_slot(self.content_slot(at, 1)), 4)]
        hi = [(BitVal.of_slot(self.content_slot(at, 2)), 1),
              (BitVal.of_slot(self.content_slot(at, 3)), 4)]
        return lo, hi

    def ct_eq(self, at: int, c: int) -> Node:
        """content[at] == c  (reference ct_eq -> smart_eq, execution.rs:64-79)."""
        expr = ("eq", expr_ctpos(at), expr_const(c))

        def run():
            lo, hi = self._pair_vals(at)
            ins_lo, k_lo = self._bit_ins(lo)
            ins_hi, k_hi = self._bit_ins(hi)
            s_lo = self._emit_pbs(ins_lo, k_lo, LUT_EQ(c & 0xF))
            s_hi = self._emit_pbs(ins_hi, k_hi, LUT_EQ((c >> 4) & 0xF))
            s = self._emit_pbs([(s_lo, 1), (s_hi, 2)], 0, LUT_AND2)
            return BitVal.of_slot(s)

        return self._with_cache(expr, run)

    def ct_ge(self, at: int, c: int) -> Node:
        """Named ct_ge for reference parity but STRICT greater-than (Q1:
        execution.rs:93 calls smart_gt)."""
        expr = ("ge", expr_ctpos(at), expr_const(c))

        def run():
            lo, hi = self._pair_vals(at)
            ins_lo, k_lo = self._bit_ins(lo)
            ins_hi, k_hi = self._bit_ins(hi)
            gt_hi = self._emit_pbs(ins_hi, k_hi, LUT_GT((c >> 4) & 0xF))
            eq_hi = self._emit_pbs(ins_hi, k_hi, LUT_EQ((c >> 4) & 0xF))
            gt_lo = self._emit_pbs(ins_lo, k_lo, LUT_GT(c & 0xF))
            s = self._emit_pbs([(gt_hi, 1), (eq_hi, 2), (gt_lo, 4)], 0,
                               LUT_GT_COMBINE)
            return BitVal.of_slot(s)

        return self._with_cache(expr, run)

    def ct_le(self, at: int, c: int) -> Node:
        """content[at] <= c (execution.rs:98-113)."""
        expr = ("le", expr_ctpos(at), expr_const(c))

        def run():
            lo, hi = self._pair_vals(at)
            ins_lo, k_lo = self._bit_ins(lo)
            ins_hi, k_hi = self._bit_ins(hi)
            lt_hi = self._emit_pbs(ins_hi, k_hi, LUT_LT((c >> 4) & 0xF))
            eq_hi = self._emit_pbs(ins_hi, k_hi, LUT_EQ((c >> 4) & 0xF))
            le_lo = self._emit_pbs(ins_lo, k_lo, LUT_LE(c & 0xF))
            s = self._emit_pbs([(lt_hi, 1), (eq_hi, 2), (le_lo, 4)], 0,
                               LUT_LE_COMBINE)
            return BitVal.of_slot(s)

        return self._with_cache(expr, run)

    # ----- optimizing mode: flat associative gates -----

    def _force(self, v) -> BitVal:
        return self._materialize(v.kind, v.elems) if isinstance(v, Pending) else v

    def force_node(self, node: Node) -> Node:
        """Materialize any pending gate so node.val is a concrete BitVal."""
        return Node(node.expr, self._force(node.val))

    @staticmethod
    def _bit_key(e: BitVal):
        return (e.slot if e.slot is not None else -1, e.sign, e.const)

    def _merge_gate(self, kind: str, a_val, b_val):
        """Flat-merge two operand values into one and/or gate value.

        Applies constant absorption, idempotent dedup and x-op-not(x)
        annihilation; returns a BitVal (decided) or a Pending set.
        """
        elems = []
        for v in (a_val, b_val):
            if isinstance(v, Pending):
                if v.kind == kind:
                    elems.extend(v.elems)
                else:
                    elems.append(self._materialize(v.kind, v.elems))
            else:
                elems.append(v)
        dominant = 0 if kind == "and" else 1   # absorbing constant
        out, seen = [], set()
        for e in elems:
            if e.sign == 0:
                if e.const == dominant:
                    return BitVal.constant(dominant)
                continue                        # neutral element dropped
            k = (e.slot, e.sign, e.const)
            if (e.slot, -e.sign, 1 - e.const) in seen:
                return BitVal.constant(dominant)   # x op not(x)
            if k in seen:
                continue
            seen.add(k)
            out.append(e)
        if not out:
            return BitVal.constant(1 - dominant)
        if len(out) == 1:
            return out[0]
        return Pending(kind, tuple(sorted(out, key=self._bit_key)))

    def _materialize(self, kind: str, elems) -> BitVal:
        """Balanced 3-ary LUT tree over a flat gate set (shallow-first)."""
        key = (kind,) + tuple(self._bit_key(e) for e in elems)
        hit = self._pendcache.get(key)
        if hit is not None:
            return hit
        lut3 = LUT_AND3 if kind == "and" else LUT_OR3
        lut2 = LUT_AND2 if kind == "and" else LUT_OR2
        lst = list(elems)
        while len(lst) > 1:
            lst.sort(key=lambda e: self._level_of_slot(e.slot) if e.slot else 0)
            nxt = []
            for i in range(0, len(lst), 3):
                chunk = lst[i:i + 3]
                if len(chunk) == 1:
                    nxt.append(chunk[0])
                    continue
                ins, k = self._bit_ins(list(zip(chunk, (1, 2, 4)[:len(chunk)])))
                self.ct_ops += 1
                s = self._emit_pbs(ins, k, lut3 if len(chunk) == 3 else lut2)
                nxt.append(BitVal.of_slot(s))
            lst = nxt
        self._pendcache[key] = lst[0]
        return lst[0]

    # ----- and / or / not -----

    def ct_and(self, a: Node, b: Node) -> Node:
        expr = ("and", a.expr, b.expr)
        if self.mode == "opt":
            return Node(expr, self._merge_gate("and", a.val, b.val))
        # Q10 short-circuits: value aliasing under the And identity,
        # bypassing cache and counters (execution.rs:121-134)
        ca, cb = _const_of(a.expr), _const_of(b.expr)
        if ca == CT_TRUE:
            return Node(expr, b.val)
        if ca == CT_FALSE:
            return Node(expr, a.val)
        if cb == CT_TRUE:
            return Node(expr, a.val)
        if cb == CT_FALSE:
            return Node(expr, b.val)

        def run():
            ins, k = self._bit_ins([(a.val, 1), (b.val, 2)])
            return BitVal.of_slot(self._emit_pbs(ins, k, LUT_AND2))

        return self._with_cache(expr, run)

    def ct_or(self, a: Node, b: Node) -> Node:
        expr = ("or", a.expr, b.expr)
        if self.mode == "opt":
            return Node(expr, self._merge_gate("or", a.val, b.val))
        ca, cb = _const_of(a.expr), _const_of(b.expr)
        if ca == CT_TRUE:
            return Node(expr, a.val)
        if cb == CT_TRUE:
            return Node(expr, b.val)
        if ca == CT_FALSE and cb == CT_FALSE:
            return Node(expr, a.val)

        def run():
            ins, k = self._bit_ins([(a.val, 1), (b.val, 2)])
            return BitVal.of_slot(self._emit_pbs(ins, k, LUT_OR2))

        return self._with_cache(expr, run)

    def ct_not(self, a: Node) -> Node:
        """Always an op in the reference (smart_bitxor with trivial 1,
        execution.rs:178-195) — counted, cached, but affine here (0 PBS)."""
        expr = ("not", a.expr)
        return self._with_cache(expr, lambda: self._force(a.val).negated())


def count_bits(builder: CircuitBuilder, bits: List[Node]) -> List[BitVal]:
    """Homomorphic popcount: encrypted 0/1 bits -> little-endian base-4
    count digits (each digit one LWE slot, value 0..3).

    Stage 1 sums bits three at a time (affine combine with UNIT scales, so
    the input stays in 0..3 — re-bootstrapped through the identity LUT into
    clean digits); the partial one-digit numbers then reduce pairwise with
    a ripple-carry base-4 adder (per digit: one mod-4 LUT + one carry LUT
    on the same 0..7 sum).  Compile-time-constant bits fold into the affine
    constants for free.  All sums stay within the 16-slot padded plaintext
    space and the 3-input noise envelope (unit scales sum <= 3 < the 1+2+4
    gate combine the noise model bounds).

    NOTE: the identity/mod4 LUTs are not boolean, so their multi-value
    factors are dense — compile count circuits with multivalue=False
    (compile_circuit enforces the margin).
    """
    vals = [builder.force_node(b).val for b in bits]
    # stage 1: groups of 3 bits -> one digit each (value 0..3)
    numbers: List[List[BitVal]] = []
    for i in range(0, len(vals), 3):
        grp = vals[i:i + 3]
        ins, k = builder._bit_ins([(v, 1) for v in grp])
        if not ins:                       # all-constant group
            numbers.append([BitVal.constant(k)])
            continue
        s = builder._emit_pbs(ins, k, LUT_IDENT)
        numbers.append([BitVal.of_slot(s)])
    if not numbers:
        return [BitVal.constant(0)]

    def add(a: List[BitVal], b: List[BitVal]) -> List[BitVal]:
        """Ripple-carry base-4 addition of two digit vectors."""
        out: List[BitVal] = []
        carry = BitVal.constant(0)
        for i in range(max(len(a), len(b))):
            da = a[i] if i < len(a) else BitVal.constant(0)
            db = b[i] if i < len(b) else BitVal.constant(0)
            terms = [(da, 1), (db, 1), (carry, 1)]
            ins, k = builder._bit_ins(terms)
            if not ins:                  # constant digit sum
                out.append(BitVal.constant(k % 4))
                carry = BitVal.constant(k // 4)
                continue
            out.append(BitVal.of_slot(builder._emit_pbs(ins, k, LUT_MOD4)))
            carry = BitVal.of_slot(builder._emit_pbs(ins, k, LUT_GE4))
        out.append(carry)
        return out

    # balanced pairwise reduction keeps the adder tree log-depth
    while len(numbers) > 1:
        nxt = []
        for i in range(0, len(numbers), 2):
            if i + 1 < len(numbers):
                nxt.append(add(numbers[i], numbers[i + 1]))
            else:
                nxt.append(numbers[i])
        numbers = nxt
    # trim leading constant-zero digits (carries that can never fire)
    digits = numbers[0]
    while len(digits) > 1 and digits[-1].sign == 0 and digits[-1].const == 0:
        digits.pop()
    return digits
