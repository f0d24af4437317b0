"""The plain reference: does a pattern of the upstream dialect match a
content, and how far does each reply's decryption lie from that answer.

The dialect is that of RKlompUU/fhe-regex (``/body/`` or ``/body/i``),
with the quirks its own parser and engine define, written here as a
translation to Python's ``re`` (this module imports nothing of the
program):

  - ``^`` and ``$`` bind to the whole pattern, around every alternative;
  - ``[x-y]`` holds the letters after x up to y: x itself is left out
    (the engine's "greater than" compare);
  - ``/i`` makes single characters match either case and leaves
    bracket expressions as written;
  - a bracket expression holds letters only; ``.`` is any character;
  - no part of the pattern but an anchor starts at the end of the
    content: there an optional or repeated part, a group or an
    alternative matches nothing, not the empty string (each part below is
    prefixed with a look-ahead for one more character); so empty content
    never matches;
  - ``{,m}`` and ``{0,m}`` allow m + 1 repetitions.

``check`` judges the reply ciphertexts of a run: every content's
decrypted block values against the answer, the widest distance of any
block's phase from the plaintext the answer encodes, in units of delta,
and the mean square of that distance over the bootstrapped blocks, the
replies' noise variance: a kernel of lower precision that still decrypts
right raises the variance before it moves the widest distance.
"""

from __future__ import annotations

import functools
import re

import numpy as np

_LETTERS = {chr(c) for c in range(ord("a"), ord("z") + 1)} | {
    chr(c) for c in range(ord("A"), ord("Z") + 1)}
_SYMBOLS = set("&;:,`~-_!@#%'\"")
_ALL = [chr(c) for c in range(128)]


class PatternError(ValueError):
    pass


class _Translator:
    def __init__(self, body: str, ci: bool):
        self.s, self.i, self.ci = body, 0, ci

    def peek(self) -> str:
        return self.s[self.i] if self.i < len(self.s) else ""

    def take(self) -> str:
        c = self.peek()
        if not c:
            raise PatternError("unexpected end of pattern")
        self.i += 1
        return c

    def regex(self) -> str:
        left = self.term()
        if self.peek() == "|":
            self.take()
            return _part(f"{left}|{self.regex()}")
        return left

    def term(self) -> str:
        out = []
        while self.peek() and self.peek() not in "|)$":
            out.append(self.factor())
        return _part("".join(out)) if len(out) > 1 else "".join(out)

    def factor(self) -> str:
        atom = f"(?:{self.atom()})"
        c = self.peek()
        if c == "?":
            self.take()
            return _part(atom + "?")
        if c in ("*", "+"):
            self.take()
            return _part(atom + c)
        if c == "{":
            self.take()
            lo = self.digits()
            if self.peek() == "}":
                self.take()
                if lo is None:
                    raise PatternError("empty repetition count")
                return _part(f"{atom}{{{lo}}}")
            if self.take() != ",":
                raise PatternError("expected ',' in a repetition")
            hi = self.digits()
            if self.take() != "}":
                raise PatternError("expected '}' after a repetition")
            lo = lo or 0
            if hi is not None and lo == 0:
                hi += 1
            if hi is not None and lo > hi:
                return "(?!)"
            return _part(f"{atom}{{{lo},{'' if hi is None else hi}}}")
        return atom

    def digits(self):
        start = self.i
        while self.peek().isdigit():
            self.i += 1
        return int(self.s[start:self.i]) if self.i > start else None

    def atom(self) -> str:
        c = self.peek()
        if c == ".":
            self.take()
            return "[\\s\\S]"
        if c == "\\":
            self.take()
            return self.char(self.take())
        if c in _LETTERS or c in _SYMBOLS:
            return self.char(self.take())
        if c == "[":
            self.take()
            chars = self.bracket()
            if self.take() != "]":
                raise PatternError("expected ']'")
            return _class(chars)
        if c == "(":
            self.take()
            inner = self.regex()
            if self.take() != ")":
                raise PatternError("expected ')'")
            return inner
        raise PatternError(f"no atom at position {self.i} of {self.s!r}")

    def char(self, c: str) -> str:
        if self.ci and c in _LETTERS:
            return _class({c.lower(), c.upper()})
        return re.escape(c)

    def bracket(self) -> set:
        if self.peek() == "^":
            self.take()
            return set(_ALL) - self.bracket()
        a = self.peek()
        if a in _LETTERS and self.s[self.i + 1:self.i + 2] == "-" \
                and self.s[self.i + 2:self.i + 3] in _LETTERS:
            b = self.s[self.i + 2]
            self.i += 3
            return {chr(x) for x in range(ord(a) + 1, ord(b) + 1)}
        out = set()
        while self.peek() in _LETTERS and self.peek():
            out.add(self.take())
        if not out:
            raise PatternError(f"empty bracket expression in {self.s!r}")
        return out


def _part(rx: str) -> str:
    """A part that, like every part of the dialect but an anchor, does not
    start at the end of the content."""
    return f"(?=[\\s\\S])(?:{rx})"


def _class(chars) -> str:
    if not chars:
        return "(?!)"
    return "[" + "".join(re.escape(c) for c in sorted(chars)) + "]"


@functools.lru_cache(maxsize=None)
def compile_pattern(pattern: str) -> "re.Pattern":
    """``/body/`` or ``/body/i`` -> a Python regular expression with the
    dialect's meaning (search semantics)."""
    m = re.fullmatch(r"/(.*)/(i?)", pattern, re.S)
    if not m:
        raise PatternError(f"not a /pattern/: {pattern!r}")
    body, ci = m.group(1), bool(m.group(2))
    sof = body.startswith("^")
    t = _Translator(body[1:] if sof else body, ci)
    inner = t.regex()
    eof = t.peek() == "$"
    if eof:
        t.take()
    if t.peek():
        raise PatternError(f"unexpected {t.s[t.i:]!r} in {pattern!r}")
    return re.compile(("\\A" if sof else "") + f"(?:{inner})"
                      + ("\\Z" if eof else ""))


def expected_bit(pattern: str, content: str) -> int:
    """1 if the pattern matches somewhere in the content, else 0."""
    if not content:
        return 0
    return int(compile_pattern(pattern).search(content) is not None)


def check(phases: np.ndarray, want: np.ndarray, cts: np.ndarray) -> dict:
    """Judge replies: ``phases`` [R, num_blocks] decryption phases in units
    of delta (``tfhe.phases``) of the reply ciphertexts ``cts`` [R,
    num_blocks, n+1], ``want`` [R] the reference's answers.  A reply
    encodes its answer in block 0 and zero in the others.

    -> {"wrong_answers": contents whose decrypted blocks differ from the
    answer, "duplicate_replies": contents whose block 0 repeats another's
    (a bootstrap's output never repeats; a trivial ciphertext, zero mask,
    is not counted), "phase_gap": the widest |phase - encoded answer| in
    delta, "phase_var": the mean of (phase - encoded answer)^2 over the
    blocks with a mask (bootstrapped, not trivial), in delta^2}."""
    phases = np.asarray(phases, np.float64).reshape(len(want), -1)
    target = np.zeros_like(phases)
    target[:, 0] = want
    gap = np.abs(phases - target)
    wrong = np.any(np.rint(phases) != target, axis=1)
    cts = np.asarray(cts)
    first = cts[:, 0]
    live = first[first[:, :-1].any(axis=1)]
    dup = len(live) - len(np.unique(live, axis=0))
    masked = cts[..., :-1].any(axis=-1).reshape(gap.shape)
    return {"wrong_answers": int(wrong.sum()), "duplicate_replies": int(dup),
            "phase_gap": float(gap.max()) if gap.size else 0.0,
            "phase_var": (float(np.mean(gap[masked] ** 2)) if masked.any()
                          else 0.0)}
