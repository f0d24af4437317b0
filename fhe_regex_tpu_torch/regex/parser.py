"""Regex-dialect parser -> AST.

Re-implements the reference grammar exactly (reference src/regex/parser.rs,
based on Matt Might's recursive-descent regex grammar, parser.rs:187-198),
including every dialect quirk that is part of the behavioral spec
(SURVEY.md §2.4):

  Q2  anchors scope over the whole alternation: /^ab|cd$/ == ^(ab|cd)$
      (parser.rs:147-166)
  Q3  /i only rewrites Char (-> Range) and recurses through
      Not/Either/Optional/Repeated/Seq; Between/Range/AnyChar unchanged
      (parser.rs:44-81)
  Q4  [...] accepts ASCII letters only (byte::letter, parser.rs:284-293)
  Q5  bare digits are not atoms; the 14 NON_ESCAPABLE_SYMBOLS are
      (parser.rs:252-269)
  Q14 repetition forms * + {n} {n,} {,m} {n,m}; ? optional; alternation
      right-nested (parser.rs:213-222, :244-246, :301-345)

The AST is pure data; repr() mirrors the reference's Debug pretty-printer
(parser.rs:87-144) so logs are comparable.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple


class ParseError(ValueError):
    pass


# ---------------- AST ----------------


@dataclasses.dataclass(frozen=True)
class RegExpr:
    pass


@dataclasses.dataclass(frozen=True, repr=False)
class SOF(RegExpr):
    def __repr__(self):
        return "^"


@dataclasses.dataclass(frozen=True, repr=False)
class EOF(RegExpr):
    def __repr__(self):
        return "$"


@dataclasses.dataclass(frozen=True, repr=False)
class Char(RegExpr):
    c: int

    def __repr__(self):
        return chr(self.c)


@dataclasses.dataclass(frozen=True, repr=False)
class AnyChar(RegExpr):
    def __repr__(self):
        return "."


@dataclasses.dataclass(frozen=True, repr=False)
class Between(RegExpr):
    frm: int
    to: int

    def __repr__(self):
        return f"[{chr(self.frm)}->{chr(self.to)}]"


@dataclasses.dataclass(frozen=True, repr=False)
class Range(RegExpr):
    cs: Tuple[int, ...]

    def __repr__(self):
        return "[" + "".join(chr(c) for c in self.cs) + "]"


@dataclasses.dataclass(frozen=True, repr=False)
class Not(RegExpr):
    not_re: RegExpr

    def __repr__(self):
        return f"[^{self.not_re!r}]"


@dataclasses.dataclass(frozen=True, repr=False)
class Either(RegExpr):
    l_re: RegExpr
    r_re: RegExpr

    def __repr__(self):
        return f"({self.l_re!r}|{self.r_re!r})"


@dataclasses.dataclass(frozen=True, repr=False)
class Optional_(RegExpr):
    opt_re: RegExpr

    def __repr__(self):
        return f"{self.opt_re!r}?"


@dataclasses.dataclass(frozen=True, repr=False)
class Repeated(RegExpr):
    repeat_re: RegExpr
    at_least: Optional[int]   # None: no lower limit (0 times)
    at_most: Optional[int]    # None: no upper limit

    def __repr__(self):
        s = lambda v: "*" if v is None else str(v)  # noqa: E731
        return f"{self.repeat_re!r}{{{s(self.at_least)},{s(self.at_most)}}}"


@dataclasses.dataclass(frozen=True, repr=False)
class Seq(RegExpr):
    re_xs: Tuple[RegExpr, ...]

    def __repr__(self):
        return "<" + "".join(repr(x) for x in self.re_xs) + ">"


NON_ESCAPABLE_SYMBOLS = frozenset(b"&;:,`~-_!@#%'\"")


def case_insensitive_chars(c: int) -> Tuple[int, ...]:
    ch = chr(c)
    if ch.isascii() and ch.islower():
        return (c, ord(ch.upper()))
    if ch.isascii() and ch.isupper():
        return (c, ord(ch.lower()))
    return (c,)


def case_insensitive(re: RegExpr) -> RegExpr:
    """The /i rewrite (parser.rs:44-81): Char -> Range; recurse through
    Not/Either/Optional/Repeated/Seq; everything else unchanged (Q3)."""
    if isinstance(re, Char):
        return Range(case_insensitive_chars(re.c))
    if isinstance(re, Not):
        return Not(case_insensitive(re.not_re))
    if isinstance(re, Either):
        return Either(case_insensitive(re.l_re), case_insensitive(re.r_re))
    if isinstance(re, Optional_):
        return Optional_(case_insensitive(re.opt_re))
    if isinstance(re, Repeated):
        return Repeated(case_insensitive(re.repeat_re), re.at_least, re.at_most)
    if isinstance(re, Seq):
        return Seq(tuple(case_insensitive(x) for x in re.re_xs))
    return re


# ---------------- recursive-descent parser ----------------


class _P:
    def __init__(self, data: bytes):
        self.data = data
        self.pos = 0

    def peek(self) -> int:
        return self.data[self.pos] if self.pos < len(self.data) else -1

    def take(self) -> int:
        c = self.peek()
        if c < 0:
            raise ParseError("unexpected end of pattern")
        self.pos += 1
        return c

    def eat(self, c: int) -> bool:
        if self.peek() == c:
            self.pos += 1
            return True
        return False

    def expect(self, c: int):
        if not self.eat(c):
            raise ParseError(
                f"expected {chr(c)!r} at position {self.pos} in "
                f"{self.data.decode('latin1')!r}"
            )

    # regex := term ('|' regex)?        right-nested (Q14)
    def regex(self) -> RegExpr:
        l = self.term()
        if self.eat(ord("|")):
            return Either(l, self.regex())
        return l

    # term := factor* ; single factor stays unwrapped (parser.rs:232-241)
    def term(self) -> RegExpr:
        xs = []
        while True:
            save = self.pos
            try:
                xs.append(self.factor())
            except ParseError:
                self.pos = save
                break
        if len(xs) == 1:
            return xs[0]
        return Seq(tuple(xs))

    # factor := atom '?' | repeated | atom
    def factor(self) -> RegExpr:
        atom = self.atom()
        if self.eat(ord("?")):
            return Optional_(atom)
        c = self.peek()
        if c == ord("*"):
            self.take()
            return Repeated(atom, None, None)
        if c == ord("+"):
            self.take()
            return Repeated(atom, 1, None)
        if c == ord("{"):
            self.take()
            at_least_digits = self._digits()
            if self.eat(ord("}")):
                # {n} exact; empty digits is an error, mirroring the
                # reference's parse_digits panic (parser.rs:349-351, Q13)
                if at_least_digits is None:
                    raise ParseError("empty repetition {} has no count")
                return Repeated(atom, at_least_digits, at_least_digits)
            self.expect(ord(","))
            at_most_digits = self._digits()
            self.expect(ord("}"))
            return Repeated(atom, at_least_digits, at_most_digits)
        return atom

    def _digits(self) -> Optional[int]:
        start = self.pos
        while ord("0") <= self.peek() <= ord("9"):
            self.pos += 1
        if self.pos == start:
            return None
        return int(self.data[start:self.pos])

    # atom := '.' | '\' any | letter | no-escape symbol | '[' range ']'
    #       | '(' regex ')'                    (parser.rs:256-269, Q5)
    def atom(self) -> RegExpr:
        c = self.peek()
        if c == ord("."):
            self.take()
            return AnyChar()
        if c == ord("\\"):
            self.take()
            return Char(self.take())
        if _is_letter(c) or c in NON_ESCAPABLE_SYMBOLS:
            self.take()
            return Char(c)
        if c == ord("["):
            self.take()
            r = self.range_()
            self.expect(ord("]"))
            return r
        if c == ord("("):
            self.take()
            r = self.regex()
            self.expect(ord(")"))
            return r
        raise ParseError(f"no atom at position {self.pos}")

    # range := '^' range | letter '-' letter | letter+   (parser.rs:284-293, Q4)
    def range_(self) -> RegExpr:
        if self.eat(ord("^")):
            return Not(self.range_())
        save = self.pos
        if _is_letter(self.peek()):
            frm = self.take()
            if self.eat(ord("-")) and _is_letter(self.peek()):
                return Between(frm, self.take())
            self.pos = save
        cs = []
        while _is_letter(self.peek()):
            cs.append(self.take())
        if not cs:
            raise ParseError(f"invalid range at position {self.pos}")
        return Range(tuple(cs))


def _is_letter(c: int) -> bool:
    return (ord("a") <= c <= ord("z")) or (ord("A") <= c <= ord("Z"))


def parse(pattern: str) -> RegExpr:
    """Parse ``/.../``(+``i``) into an AST (reference parser.rs:146-185).

    Anchors are consumed at the outer level only, so they scope over the
    whole alternation (Q2); a trailing unparsed suffix is an error.
    """
    data = pattern.encode("latin1")
    p = _P(data)
    p.expect(ord("/"))
    sof = p.eat(ord("^"))
    re = p.regex()
    eof = p.eat(ord("$"))
    p.expect(ord("/"))
    ci = p.eat(ord("i"))
    if p.pos != len(data):
        raise ParseError(
            "failed to parse regular expression, unexpected token at start of: "
            + data[p.pos:].decode("latin1")
        )
    if sof or eof:
        xs = []
        if sof:
            xs.append(SOF())
        xs.append(re)
        if eof:
            xs.append(EOF())
        re = Seq(tuple(xs))
    if ci:
        re = case_insensitive(re)
    return re
