"""Variant compiler: AST x content-position -> lazy circuit branches.

Faithful port of the reference's "list monad procedure"
(src/regex/engine.rs:45-214) with identical branch generation, pruning and
ordering semantics (SURVEY.md Q6-Q9, Q12):

  - start positions 0..content_len, empty content -> trivial FALSE (Q8)
  - SOF/EOF and out-of-content pruning happen *before* any FHE op
    (engine.rs:52-71)
  - AnyChar consumes a position and yields trivial TRUE (Q6)
  - unbounded repetition capped by remaining content; at_least > at_most
    yields no variants; at_least == 0 adds an epsilon variant (Q7)
  - OR-fold is a left fold in branch order (Q12, engine.rs:22-35)

The closures operate on a symbolic CircuitBuilder rather than a live
ciphertext context — execution is deferred to the level-scheduled batched
executor, but construction order (and therefore cache/counter behavior) is
identical to the reference.
"""

from __future__ import annotations

import logging
from typing import Callable, List, Optional, Tuple

from fhe_regex_tpu_torch.regex import parser as P
from fhe_regex_tpu_torch.regex.circuit import TRACE, CircuitBuilder, Node
from fhe_regex_tpu_torch.regex.parser import parse

logger = logging.getLogger("fhe_regex_tpu_torch.engine")

LazyExecution = Callable[[CircuitBuilder], Node]
Branch = Tuple[LazyExecution, int]


class BranchBudgetExceeded(ValueError):
    """Branch enumeration exceeded the configured budget.

    The reference's variant expansion (engine.rs:45-214, inherited here) is
    exponential for nested quantifiers (e.g. ``(a|b)*`` shapes); a budget
    turns unbounded compile time into a clean, early error for serving.
    """


class BranchBudget:
    """Counts lazy-branch constructions during enumeration.

    One unit per lazy closure created (leaves, epsilon variants, NOT wraps
    and AND-chained pairs) — the same metric the native C++ compiler charges
    per ``Lazy`` node, so both engines accept/reject identically.
    """

    __slots__ = ("limit", "used")

    def __init__(self, limit: Optional[int]):
        self.limit = limit
        self.used = 0

    def charge(self, n: int = 1) -> None:
        if self.limit is None:
            return
        self.used += n
        if self.used > self.limit:
            raise BranchBudgetExceeded(
                f"pattern expands to more than {self.limit} circuit branch "
                f"nodes; raise branch_budget or simplify the pattern")


_NO_BUDGET = BranchBudget(None)


def build_branches(content_len: int, re: P.RegExpr, c_pos: int,
                   budget: BranchBudget = _NO_BUDGET) -> List[Branch]:
    if logger.isEnabledFor(TRACE):                    # engine.rs:50
        logger.log(TRACE, "program pointer: regex=%r, content pos=%d",
                   re, c_pos)
    if isinstance(re, P.SOF):
        if c_pos != 0:
            return []
        budget.charge()
        return [(lambda b: b.ct_true(), c_pos)]
    if isinstance(re, P.EOF):
        if c_pos != content_len:
            return []
        budget.charge()
        return [(lambda b: b.ct_true(), c_pos)]

    if c_pos >= content_len:
        return []

    if isinstance(re, P.Char):
        c = re.c
        budget.charge()
        return [(lambda b, at=c_pos, c=c: b.ct_eq(at, c), c_pos + 1)]

    if isinstance(re, P.AnyChar):
        budget.charge()
        return [(lambda b: b.ct_true(), c_pos + 1)]

    if isinstance(re, P.Not):
        sub = build_branches(content_len, re.not_re, c_pos, budget)
        budget.charge(len(sub))
        return [
            (lambda b, br=branch: b.ct_not(br(b)), pos)
            for branch, pos in sub
        ]

    if isinstance(re, P.Either):
        res = build_branches(content_len, re.l_re, c_pos, budget)
        res.extend(build_branches(content_len, re.r_re, c_pos, budget))
        return res

    if isinstance(re, P.Between):
        frm, to = re.frm, re.to
        def between(b, at=c_pos, frm=frm, to=to):
            ge = b.ct_ge(at, frm)     # strict > (Q1)
            le = b.ct_le(at, to)
            return b.ct_and(ge, le)
        budget.charge()
        return [(between, c_pos + 1)]

    if isinstance(re, P.Range):
        cs = re.cs
        def range_(b, at=c_pos, cs=cs):
            res = b.ct_eq(at, cs[0])
            for c in cs[1:]:
                res = b.ct_or(res, b.ct_eq(at, c))
            return res
        budget.charge()
        return [(range_, c_pos + 1)]

    if isinstance(re, P.Repeated):
        at_least = re.at_least if re.at_least is not None else 0
        at_most = re.at_most if re.at_most is not None else content_len - c_pos
        if at_least > at_most:
            return []
        if at_least == 0:
            budget.charge()
        groups: List[List[Branch]] = [
            [(lambda b: b.ct_true(), c_pos)] if at_least == 0 else [],
            build_branches(
                content_len,
                P.Seq(tuple([re.repeat_re] * max(1, at_least))),
                c_pos,
                budget,
            ),
        ]
        for _ in range(at_least + 1, at_most + 1):
            nxt: List[Branch] = []
            for branch_prev, prev_pos in groups[-1]:
                for branch_x, x_pos in build_branches(content_len, re.repeat_re,
                                                      prev_pos, budget):
                    def chained(b, bp=branch_prev, bx=branch_x):
                        res_prev = bp(b)
                        res_x = bx(b)
                        return b.ct_and(res_prev, res_x)
                    budget.charge()
                    nxt.append((chained, x_pos))
            groups.append(nxt)
        return [br for grp in groups for br in grp]

    if isinstance(re, P.Optional_):
        res = build_branches(content_len, re.opt_re, c_pos, budget)
        budget.charge()
        res.append((lambda b: b.ct_true(), c_pos))
        return res

    if isinstance(re, P.Seq):
        if not re.re_xs:
            # the reference indexes re_xs[0] unconditionally and panics on an
            # empty Seq (Q13, engine.rs:189) — surface it as a clear error
            raise ValueError("empty sequence in pattern (e.g. bare /^/) is not executable")
        continuations = build_branches(content_len, re.re_xs[0], c_pos, budget)
        for re_x in re.re_xs[1:]:
            nxt: List[Branch] = []
            for branch_prev, prev_pos in continuations:
                for branch_x, x_pos in build_branches(content_len, re_x,
                                                      prev_pos, budget):
                    def chained(b, bp=branch_prev, bx=branch_x):
                        res_prev = bp(b)
                        res_x = bx(b)
                        return b.ct_and(res_prev, res_x)
                    budget.charge()
                    nxt.append((chained, x_pos))
            continuations = nxt
        return continuations

    raise ValueError(f"unmatched regex variant: {re!r}")


def _fold_branches(builder: CircuitBuilder,
                   branches: List[LazyExecution]) -> Node:
    """Force branches in order and OR-fold left (engine.rs:22-35); empty
    list -> trivial FALSE (Q8).  Returns the forced root bit."""
    if not branches:
        return builder.force_node(builder.ct_false())
    res = branches[0](builder)
    for branch in branches[1:]:
        branch_res = branch(builder)
        res = builder.ct_or(res, branch_res)
    return builder.force_node(res)


def _fold_pattern(builder: CircuitBuilder, content_len: int, pattern: str,
                  budget: BranchBudget) -> Node:
    """Enumerate one pattern's branches onto `builder` and OR-fold them
    (engine.rs:15-35); returns the forced root bit."""
    re = parse(pattern)
    branches: List[LazyExecution] = []
    for i in range(content_len):
        branches.extend(b for b, _ in build_branches(content_len, re, i, budget))
    return _fold_branches(builder, branches)


def compile_match(content_len: int, pattern: str, num_blocks: int = 4,
                  fold: str = "reference",
                  branch_budget: Optional[int] = None) -> Tuple[CircuitBuilder, Node]:
    """Parse + enumerate + OR-fold into one symbolic result bit
    (mirrors has_match's compile+execute structure, engine.rs:8-42).

    fold='reference': the reference's sequential left fold (engine.rs:22-35)
    — exact op-order/counter parity, but a depth-O(branches) circuit.
    fold='tree': log-depth pairwise OR tree — identical decrypted result
    (OR is associative and every op re-bootstraps) and far fewer levels,
    the right choice for latency (SURVEY.md §7).

    branch_budget bounds the variant expansion (which is exponential for
    nested quantifiers) — BranchBudgetExceeded instead of unbounded compile
    time; None (default) keeps the reference's unbounded semantics.
    """
    if fold not in ("reference", "tree"):
        raise ValueError(f"unknown fold mode {fold!r}")
    # 'tree' uses the optimizing builder: associative and/or chains are
    # collected flat and materialized as balanced 3-ary LUT trees —
    # log-depth circuits, ~2x fewer bootstraps, identical decrypted bits.
    builder = CircuitBuilder(content_len, num_blocks=num_blocks,
                             mode="opt" if fold == "tree" else "strict")
    root = _fold_pattern(builder, content_len, pattern,
                         BranchBudget(branch_budget))
    return builder, root


def max_match_span(re: P.RegExpr) -> Optional[int]:
    """Maximum content characters any variant of `re` can consume, or None
    if unbounded (an unquantified-max repetition — those are capped by the
    remaining content, Q7, so their span grows with content length).

    Drives windowed long-content matching (has_match_long): any match fits
    inside a window of this many characters.
    """
    if isinstance(re, (P.SOF, P.EOF)):
        return 0
    if isinstance(re, (P.Char, P.AnyChar, P.Between, P.Range)):
        return 1
    if isinstance(re, P.Not):
        return max_match_span(re.not_re)
    if isinstance(re, P.Either):
        l = max_match_span(re.l_re)
        r = max_match_span(re.r_re)
        return None if l is None or r is None else max(l, r)
    if isinstance(re, P.Optional_):
        return max_match_span(re.opt_re)
    if isinstance(re, P.Repeated):
        if re.at_most is None:
            return None
        sub = max_match_span(re.repeat_re)
        return None if sub is None else re.at_most * sub
    if isinstance(re, P.Seq):
        total = 0
        for x in re.re_xs:
            s = max_match_span(x)
            if s is None:
                return None
            total += s
        return total
    raise ValueError(f"unmatched regex variant: {re!r}")


def has_anchor(re: P.RegExpr, kind) -> bool:
    """Does the AST contain a SOF/EOF node?  (Anchors scope over the whole
    alternation, Q2, so presence anywhere means the pattern is anchored.)"""
    if isinstance(re, kind):
        return True
    if isinstance(re, P.Not):
        return has_anchor(re.not_re, kind)
    if isinstance(re, P.Either):
        return has_anchor(re.l_re, kind) or has_anchor(re.r_re, kind)
    if isinstance(re, P.Optional_):
        return has_anchor(re.opt_re, kind)
    if isinstance(re, P.Repeated):
        return has_anchor(re.repeat_re, kind)
    if isinstance(re, P.Seq):
        return any(has_anchor(x, kind) for x in re.re_xs)
    return False


def compile_match_positions(content_len: int, pattern: str,
                            num_blocks: int = 4, fold: str = "tree",
                            branch_budget: Optional[int] = None
                            ) -> Tuple[CircuitBuilder, List[Node]]:
    """Per-start-position match bits: roots[i] = OR over the variants that
    start at content position i (the addends of the reference's global OR,
    engine.rs:15-35, kept separate instead of folded).

    The global `has_match` bit is the OR of these roots; returning them
    individually gives an encrypted "match at offset i" vector.  All
    positions share one hash-consed builder, so the circuit is barely
    larger than the single-bit one (the fold tree is what differs).
    `branch_budget` is charged once across all positions, exactly like
    `compile_match`.
    """
    if fold not in ("reference", "tree"):
        raise ValueError(f"unknown fold mode {fold!r}")
    re = parse(pattern)
    budget = BranchBudget(branch_budget)
    builder = CircuitBuilder(content_len, num_blocks=num_blocks,
                             mode="opt" if fold == "tree" else "strict")
    roots: List[Node] = []
    for i in range(content_len):
        branches = [b for b, _ in build_branches(content_len, re, i, budget)]
        roots.append(_fold_branches(builder, branches))
    return builder, roots


def compile_match_multi(content_len: int, patterns: List[str],
                        num_blocks: int = 4, fold: str = "tree",
                        branch_budget: Optional[int] = None
                        ) -> Tuple[CircuitBuilder, List[Node]]:
    """Compile MANY patterns against one content length into ONE circuit.

    All patterns share a single hash-consed builder, so identical
    subexpressions (per-position char comparisons, shared prefixes,
    materialized gate trees) are computed once and reused across patterns —
    the cross-pattern generalization of the reference's memo cache (Q11),
    which only ever spans one `has_match` call (execution.rs:37-43).

    Returns the shared builder and one forced root Node per pattern, in
    pattern order.  `branch_budget` is charged per pattern (same
    accept/reject threshold as compiling each pattern alone).
    """
    if fold not in ("reference", "tree"):
        raise ValueError(f"unknown fold mode {fold!r}")
    builder = CircuitBuilder(content_len, num_blocks=num_blocks,
                             mode="opt" if fold == "tree" else "strict")
    roots = [_fold_pattern(builder, content_len, p, BranchBudget(branch_budget))
             for p in patterns]
    return builder, roots
