"""Pattern programs — ahead-of-time-compiled, reusable match circuits.

The framework's "model" artifact is a compiled pattern: since the op DAG
depends only on (pattern, content length) (SURVEY.md §3.2), a pattern can be
compiled once and served against any number of encrypted contents of the
same length — the serving-oriented counterpart of the reference's per-call
interpreter.  ``CompiledPattern`` caches circuits per content length;
``CompiledPatternSet`` (many patterns, one shared multi-root circuit) and
``CompiledPositions`` (one root per start offset) override only the
compile step.

``DRIVER_CONFIGS`` enumerates the five benchmark configurations from
BASELINE.json.
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np

from fhe_regex_tpu_torch.params import Params, get_params
from fhe_regex_tpu_torch.regex.executor import CompiledCircuit, compile_circuit
from fhe_regex_tpu_torch.regex.parser import parse


class CompiledPattern:
    """AOT-compiled regex match program, cached per content length."""

    def __init__(self, pattern: str, params: Optional[Params] = None,
                 min_bucket: Optional[int] = None, fold: str = "tree",
                 engine: Optional[str] = None,
                 branch_budget: Optional[int] = None,
                 multivalue: Optional[bool] = False):
        self.pattern = pattern
        self.params = params or get_params()
        self.min_bucket = min_bucket
        self.fold = fold
        self.engine = engine
        self.branch_budget = branch_budget
        self.multivalue = multivalue
        self._validate()
        self._circuits: Dict[int, CompiledCircuit] = {}

    def _validate(self) -> None:
        parse(self.pattern)  # early validation (mirrors main.rs:17-20)

    def _compile(self, content_len: int):
        """-> (builder, root_or_roots); subclasses override this hook."""
        from fhe_regex_tpu_torch.regex.engine import compile_match
        from fhe_regex_tpu_torch.regex.native import default_engine

        engine = self.engine
        if engine is None:
            engine = default_engine()
        if engine == "native":
            from fhe_regex_tpu_torch.regex.native import compile_match_native
            return compile_match_native(
                content_len, self.pattern, num_blocks=self.params.num_blocks,
                fold=self.fold, branch_budget=self.branch_budget)
        return compile_match(
            content_len, self.pattern, num_blocks=self.params.num_blocks,
            fold=self.fold, branch_budget=self.branch_budget)

    def circuit(self, content_len: int) -> CompiledCircuit:
        if content_len not in self._circuits:
            from fhe_regex_tpu_torch import _compile_auto_mv
            from fhe_regex_tpu_torch.regex.executor import default_min_bucket

            builder, root = self._compile(content_len)
            # multivalue None = auto: keep the shared-rotation plan when
            # its rotation savings clear the serving threshold (served
            # programs are long-lived, so the mv executable loads amortize)
            self._circuits[content_len] = _compile_auto_mv(
                self.params, builder, root, self.multivalue,
                min_bucket=self.min_bucket or default_min_bucket())
        return self._circuits[content_len]

    def match(self, executor, ct_content: np.ndarray) -> np.ndarray:
        """Run against one encrypted content with a prepared Executor."""
        return executor.run(self.circuit(len(ct_content)),
                            np.ascontiguousarray(ct_content))

    def match_many(self, executor, ct_contents: np.ndarray) -> np.ndarray:
        """Run against a batch of equal-length encrypted contents."""
        return executor.run_many(self.circuit(ct_contents.shape[1]),
                                 np.ascontiguousarray(ct_contents))

    def stats(self, content_len: int) -> dict:
        from fhe_regex_tpu_torch.regex.executor import circuit_pfail

        c = self.circuit(content_len)
        # failure-probability contract at the engine's actual operating
        # point (mv norm + active key-limb drop; non-finite log2 -> None
        # so serve.py responses stay strict JSON)
        pf = circuit_pfail(self.params, c)
        return {
            "ct_ops": c.ct_ops,
            "cache_hits": c.cache_hits,
            "bootstraps": c.pbs_count,
            "rotations": c.rotation_count,
            "levels": len(c.levels),
            "log2_p_fail_per_pbs": pf["log2_p_fail_per_pbs"],
            "p_fail_circuit": pf["p_fail_circuit"],
        }


class CompiledPatternSet(CompiledPattern):
    """Many patterns AOT-compiled onto ONE shared circuit, cached per
    content length (the multi-root counterpart of CompiledPattern).

    Cross-pattern hash-consing means shared subexpressions bootstrap once;
    `match` returns one radix ciphertext per pattern (`[P, ...]`), in
    order; `match_many` returns `[C, P, ...]`."""

    def __init__(self, patterns, **kwargs):
        self.patterns = list(patterns)
        if not self.patterns:
            raise ValueError("need at least one pattern")
        super().__init__(self.patterns, **kwargs)

    def _validate(self) -> None:
        for p in self.patterns:
            parse(p)

    def _compile(self, content_len: int):
        from fhe_regex_tpu_torch import _compile_multi
        return _compile_multi(self.params, content_len, self.patterns,
                              self.fold, self.engine, self.branch_budget)

    def stats(self, content_len: int) -> dict:
        return {"patterns": len(self.patterns),
                **super().stats(content_len)}


class CompiledPositions(CompiledPattern):
    """Per-offset match program: one multi-root circuit per content length
    whose roots are the start-position bits (has_match_positions' AOT
    artifact; result rows `[len, ...]` or `[C, len, ...]` under
    match_many)."""

    def _compile(self, content_len: int):
        from fhe_regex_tpu_torch import _compile_positions
        return _compile_positions(self.params, content_len, self.pattern,
                                  self.fold, self.engine, self.branch_budget)

    def stats(self, content_len: int) -> dict:
        return {"positions": content_len, **super().stats(content_len)}


# The 5 driver benchmark configurations (BASELINE.json "configs")
DRIVER_CONFIGS = [
    {"name": "exact_literal", "pattern": "/^abc$/", "content_len": 3},
    {"name": "contains_anchors", "pattern": "/abc/", "content_len": 16},
    {"name": "case_insensitive_classes", "pattern": "/^[a-d][^xyz]$/i", "content_len": 2},
    {"name": "quantifiers", "pattern": "/^ab{2,4}c+d*$/", "content_len": 32},
    {"name": "alternation_combo", "pattern": "/^(ab|cd)[a-z]{3,}e?$/i", "content_len": 64},
]
