"""ctypes binding for the native C++ circuit compiler (native/circuit.cpp).

The C++ runtime is the hot-host-path twin of regex/engine.py +
regex/circuit.py: branch enumeration, hash-consed micro-op DAG, counters and
level assignment — byte-exact against the Python builder (enforced by
tests/test_native_circuit.py), but orders of magnitude faster on
combinatorially large patterns.
"""

from __future__ import annotations

import ctypes
import dataclasses
from typing import List, Optional, Tuple

import numpy as np

from fhe_regex_tpu_torch.crypto.csprng import _LIB_PATH
from fhe_regex_tpu_torch.ops.luts import (
    LUT_AND2, LUT_AND3, LUT_EQ, LUT_GT, LUT_GT_COMBINE, LUT_LE, LUT_LT,
    LUT_OR2, LUT_OR3,
)
from fhe_regex_tpu_torch.regex import parser as P
from fhe_regex_tpu_torch.regex.circuit import BitVal, Node, PbsOp
from fhe_regex_tpu_torch.regex.parser import parse

_lib = None


def available() -> bool:
    return _load() is not None


def default_engine() -> str:
    """'native' if the C++ compiler is built — except when per-op debug
    logging is enabled (FHE_REGEX_LOG=DEBUG/TRACE): the reference-parity
    cache-hit / "evaluation for" logs (execution.rs:214-218) are emitted by
    the Python builder, so debug runs route through it (both builders are
    byte-exact, tests/test_native_circuit.py)."""
    import logging

    from fhe_regex_tpu_torch.regex.circuit import logger as _circuit_logger
    if _circuit_logger.isEnabledFor(logging.DEBUG):
        return "python"
    return "native" if available() else "python"


def _load():
    global _lib
    if _lib is None and _LIB_PATH.exists():
        lib = ctypes.CDLL(str(_LIB_PATH))
        lib.circuit_compile.restype = ctypes.POINTER(ctypes.c_int64)
        lib.circuit_compile.argtypes = [
            ctypes.POINTER(ctypes.c_int32), ctypes.c_int32, ctypes.c_int32,
            ctypes.c_int32, ctypes.c_int32, ctypes.c_int64,
        ]
        lib.circuit_compile_multi.restype = ctypes.POINTER(ctypes.c_int64)
        lib.circuit_compile_multi.argtypes = [
            ctypes.POINTER(ctypes.c_int32), ctypes.POINTER(ctypes.c_int32),
            ctypes.c_int32, ctypes.c_int32, ctypes.c_int32, ctypes.c_int32,
            ctypes.c_int64,
        ]
        lib.circuit_compile_positions.restype = ctypes.POINTER(ctypes.c_int64)
        lib.circuit_compile_positions.argtypes = [
            ctypes.POINTER(ctypes.c_int32), ctypes.c_int32, ctypes.c_int32,
            ctypes.c_int32, ctypes.c_int32, ctypes.c_int64,
        ]
        lib.circuit_free.argtypes = [ctypes.POINTER(ctypes.c_int64)]
        _lib = lib
    return _lib


def serialize_ast(re: P.RegExpr, out: Optional[List[int]] = None) -> np.ndarray:
    """Pre-order int32 encoding matching circuit.cpp's wire format."""
    first = out is None
    if first:
        out = []
    if isinstance(re, P.SOF):
        out.append(0)
    elif isinstance(re, P.EOF):
        out.append(1)
    elif isinstance(re, P.Char):
        out.extend([2, re.c])
    elif isinstance(re, P.AnyChar):
        out.append(3)
    elif isinstance(re, P.Between):
        out.extend([4, re.frm, re.to])
    elif isinstance(re, P.Range):
        out.extend([5, len(re.cs), *re.cs])
    elif isinstance(re, P.Not):
        out.append(6)
        serialize_ast(re.not_re, out)
    elif isinstance(re, P.Either):
        out.append(7)
        serialize_ast(re.l_re, out)
        serialize_ast(re.r_re, out)
    elif isinstance(re, P.Optional_):
        out.append(8)
        serialize_ast(re.opt_re, out)
    elif isinstance(re, P.Repeated):
        out.extend([9,
                    0 if re.at_least is None else re.at_least + 1,
                    0 if re.at_most is None else re.at_most + 1])
        serialize_ast(re.repeat_re, out)
    elif isinstance(re, P.Seq):
        if not re.re_xs:
            raise ValueError(
                "empty sequence in pattern (e.g. bare /^/) is not executable")
        out.extend([10, len(re.re_xs)])
        for x in re.re_xs:
            serialize_ast(x, out)
    else:
        raise ValueError(f"unknown AST node {re!r}")
    if first:
        return np.asarray(out, np.int32)
    return out  # type: ignore[return-value]


_LUT_BY_KIND = {4: LUT_AND2, 5: LUT_OR2, 6: LUT_AND3, 7: LUT_OR3,
                8: LUT_GT_COMBINE}


def _lut_key(kind: int, c: int):
    if kind == 0:
        return LUT_EQ(c)
    if kind == 1:
        return LUT_GT(c)
    if kind == 2:
        return LUT_LT(c)
    if kind == 3:
        return LUT_LE(c)
    return _LUT_BY_KIND[kind]


@dataclasses.dataclass
class NativeCompiled:
    """CircuitBuilder-compatible result of the C++ compiler."""
    content_len: int
    num_blocks: int
    num_content_slots: int
    ops: List[PbsOp]
    ct_ops: int
    cache_hits: int


def compile_match_native(content_len: int, pattern: str, num_blocks: int = 4,
                         fold: str = "reference",
                         branch_budget: Optional[int] = None
                         ) -> Tuple[NativeCompiled, Node]:
    """Native counterpart of engine.compile_match (same return shape).

    branch_budget: same metric and accept/reject behavior as the Python
    engine (one unit per lazy branch node); None = unlimited.
    """
    lib = _load()
    if lib is None:
        raise RuntimeError("native/libfheregex.so not built (make -C native)")
    ast = serialize_ast(parse(pattern))
    mode = 1 if fold == "tree" else 0
    blob = lib.circuit_compile(
        ast.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        len(ast), content_len, num_blocks, mode,
        -1 if branch_budget is None else branch_budget)
    try:
        n_ops = int(blob[0])
        if n_ops < 0:
            from fhe_regex_tpu_torch.regex.engine import BranchBudgetExceeded
            raise BranchBudgetExceeded(
                f"pattern expands to more than {branch_budget} circuit branch "
                f"nodes; raise branch_budget or simplify the pattern")
        ct_ops, cache_hits = int(blob[1]), int(blob[2])
        root = BitVal(const=int(blob[3]), sign=int(blob[4]),
                      slot=(None if int(blob[4]) == 0 else int(blob[5])))
        num_content_slots = int(blob[6])
        rec = np.ctypeslib.as_array(
            ctypes.cast(ctypes.addressof(blob.contents) + 7 * 8,
                        ctypes.POINTER(ctypes.c_int64)),
            shape=(n_ops, 11)).copy() if n_ops else np.zeros((0, 11), np.int64)
    finally:
        lib.circuit_free(blob)

    builder = NativeCompiled(
        content_len=content_len, num_blocks=num_blocks,
        num_content_slots=num_content_slots, ops=_ops_from_records(rec),
        ct_ops=ct_ops, cache_hits=cache_hits,
    )
    return builder, Node(expr=("native",), val=root)


def _ops_from_records(rec: np.ndarray) -> List[PbsOp]:
    return [
        PbsOp(
            in_slots=(int(r[0]), int(r[1]), int(r[2])),
            in_coefs=(int(r[3]), int(r[4]), int(r[5])),
            const=int(r[6]),
            lut=_lut_key(int(r[7]), int(r[8])),
            out_slot=int(r[9]),
            level=int(r[10]),
        )
        for r in rec
    ]


def _read_i64(blob, off: int, n: int) -> np.ndarray:
    if n == 0:
        return np.zeros((0,), np.int64)
    return np.ctypeslib.as_array(
        ctypes.cast(ctypes.addressof(blob.contents) + off * 8,
                    ctypes.POINTER(ctypes.c_int64)),
        shape=(n,)).copy()


def compile_match_native_multi(content_len: int, patterns: List[str],
                               num_blocks: int = 4, fold: str = "tree",
                               branch_budget: Optional[int] = None
                               ) -> Tuple[NativeCompiled, List[Node]]:
    """Native counterpart of engine.compile_match_multi: many patterns on one
    shared hash-consed circuit (byte-exact vs the Python builder, enforced by
    tests/test_native_circuit.py).  Budget is charged per pattern."""
    lib = _load()
    if lib is None:
        raise RuntimeError("native/libfheregex.so not built (make -C native)")
    asts = [serialize_ast(parse(p)) for p in patterns]
    lens = np.asarray([len(a) for a in asts], np.int32)
    cat = (np.concatenate(asts) if asts else np.zeros((0,), np.int32))
    mode = 1 if fold == "tree" else 0
    blob = lib.circuit_compile_multi(
        cat.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        lens.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        len(patterns), content_len, num_blocks, mode,
        -1 if branch_budget is None else branch_budget)
    return _multiroot_from_blob(lib, blob, content_len, num_blocks,
                                branch_budget)


def _multiroot_from_blob(lib, blob, content_len: int, num_blocks: int,
                         branch_budget) -> Tuple[NativeCompiled, List[Node]]:
    """Decode the shared multi-root blob layout (header [n_ops, ct_ops,
    cache_hits, n_roots, num_content_slots] + root triples + op records)."""
    try:
        n_ops = int(blob[0])
        if n_ops < 0:
            from fhe_regex_tpu_torch.regex.engine import BranchBudgetExceeded
            raise BranchBudgetExceeded(
                f"the pattern expands to more than {branch_budget} circuit "
                f"branch nodes; raise branch_budget or simplify the pattern")
        ct_ops, cache_hits = int(blob[1]), int(blob[2])
        n_roots = int(blob[3])
        num_content_slots = int(blob[4])
        rvals = _read_i64(blob, 5, n_roots * 3).reshape(n_roots, 3)
        rec = _read_i64(blob, 5 + n_roots * 3, n_ops * 11).reshape(n_ops, 11)
    finally:
        lib.circuit_free(blob)
    roots = [
        Node(expr=("native", i),
             val=BitVal(const=int(c), sign=int(s),
                        slot=(None if int(s) == 0 else int(sl))))
        for i, (c, s, sl) in enumerate(rvals)
    ]
    builder = NativeCompiled(
        content_len=content_len, num_blocks=num_blocks,
        num_content_slots=num_content_slots, ops=_ops_from_records(rec),
        ct_ops=ct_ops, cache_hits=cache_hits,
    )
    return builder, roots


def compile_match_native_positions(content_len: int, pattern: str,
                                   num_blocks: int = 4, fold: str = "tree",
                                   branch_budget: Optional[int] = None
                                   ) -> Tuple[NativeCompiled, List[Node]]:
    """Native counterpart of engine.compile_match_positions: one root per
    content start position (byte-exact vs the Python builder)."""
    lib = _load()
    if lib is None:
        raise RuntimeError("native/libfheregex.so not built (make -C native)")
    ast = serialize_ast(parse(pattern))
    mode = 1 if fold == "tree" else 0
    blob = lib.circuit_compile_positions(
        ast.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        len(ast), content_len, num_blocks, mode,
        -1 if branch_budget is None else branch_budget)
    return _multiroot_from_blob(lib, blob, content_len, num_blocks,
                                branch_budget)
