"""The general traffic generator: one mix file of parameters -> requests.

A mix (``mixes/<name>.json``) holds:

  endpoint   the daemon's endpoint, "/match" or "/match_many"
  batch      contents per request (1 on /match)
  fold       the OR fold the request asks for
  hit_share  the share of contents drawn from a shape's "hit" template
  cycle      shape names; the requests run through the cycle over and over,
             each pass in an order drawn from the seed, so every seed sends
             the same shapes in the same proportions
  shapes     {name: {"pattern", "content_len", "hit", "miss"}}

A template is a list of segments, each {"chars": "a-z", "min": m, "max": M}
(a run of characters drawn from the set, of a length in [m, M]) or
{"words": [...]} (one of the words).  Run lengths are drawn so that the
content has the shape's length.  The reference, not the template, decides
whether a content matches.
"""

from __future__ import annotations

import dataclasses
from typing import List

import numpy as np


@dataclasses.dataclass
class Request:
    index: int
    shape: str
    endpoint: str
    pattern: str
    fold: str
    contents: List[str]


def charset(spec: str) -> List[str]:
    """"a-dXY" -> ["a", "b", "c", "d", "X", "Y"]."""
    out, i = [], 0
    while i < len(spec):
        if i + 2 < len(spec) and spec[i + 1] == "-":
            out += [chr(c) for c in range(ord(spec[i]), ord(spec[i + 2]) + 1)]
            i += 3
        else:
            out.append(spec[i])
            i += 1
    return out


def _lengths(segments, total: int, rng) -> List[int]:
    """A length for every segment, each in its [min, max], summing to
    ``total`` (word segments have their word's length, fixed by the
    caller)."""
    lo = [s["min"] for s in segments]
    hi = [s["max"] for s in segments]
    if not sum(lo) <= total <= sum(hi):
        raise ValueError(f"template cannot make {total} characters")
    out, rem = [], total
    for i in range(len(segments)):
        rest_lo, rest_hi = sum(lo[i + 1:]), sum(hi[i + 1:])
        a, b = max(lo[i], rem - rest_hi), min(hi[i], rem - rest_lo)
        n = int(rng.integers(a, b + 1))
        out.append(n)
        rem -= n
    return out


def render(template, length: int, rng) -> str:
    """One content of ``length`` characters from a template."""
    segs = []
    for s in template:
        if "words" in s:
            w = s["words"][int(rng.integers(len(s["words"])))]
            segs.append({"min": len(w), "max": len(w), "fixed": w})
        else:
            segs.append(s)
    parts = []
    for s, n in zip(segs, _lengths(segs, length, rng)):
        if "fixed" in s:
            parts.append(s["fixed"])
        else:
            cs = charset(s["chars"])
            parts.append("".join(cs[i] for i in rng.integers(len(cs),
                                                             size=n)))
    return "".join(parts)


class Traffic:
    """The requests of one mix for one seed, generated as they are taken."""

    def __init__(self, mix: dict, seed: int):
        self.mix = mix
        self.rng = np.random.default_rng([seed, 1])
        self.cycle = list(mix["cycle"])
        unknown = set(self.cycle) - set(mix["shapes"])
        if unknown:
            raise ValueError(f"cycle names unknown shapes {sorted(unknown)}")
        self._order: List[str] = []
        self._next = 0

    def shapes(self) -> List[str]:
        """The distinct shapes this mix sends."""
        return sorted(set(self.cycle))

    def next(self) -> Request:
        if not self._order:
            self._order = [self.cycle[i]
                           for i in self.rng.permutation(len(self.cycle))]
        name = self._order.pop(0)
        shape = self.mix["shapes"][name]
        contents = []
        for _ in range(int(self.mix["batch"])):
            kind = "hit" if self.rng.random() < self.mix["hit_share"] else "miss"
            contents.append(render(shape[kind], shape["content_len"],
                                   self.rng))
        req = Request(self._next, name, self.mix["endpoint"],
                      shape["pattern"], self.mix["fold"], contents)
        self._next += 1
        return req
