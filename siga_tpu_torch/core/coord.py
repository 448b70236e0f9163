"""Sequence-coordinate geometry: SeqCoord, Match, Overlap.

Mirrors reference src/coord.h-cpp semantics exactly (closed intervals,
flip/complement/translate10); these objects round-trip through ASQG edge
records so their arithmetic feeds byte-compat surfaces.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Tuple


@dataclass
class SeqCoord:
    start: int = 0
    end: int = -1
    seqlen: int = 0

    def is_left_extreme(self) -> bool:
        return self.start == 0

    def is_right_extreme(self) -> bool:
        return self.end + 1 == self.seqlen

    def is_extreme(self) -> bool:
        return self.is_left_extreme() or self.is_right_extreme()

    def is_contained(self) -> bool:
        return self.is_left_extreme() and self.is_right_extreme()

    def is_full(self) -> bool:
        return self.length() == self.seqlen

    def is_empty(self) -> bool:
        return self.start == 0 and self.end == -1

    def length(self) -> int:
        return self.end + 1 - self.start

    def flip(self) -> None:
        s, e = self.start, self.end
        self.start = self.seqlen - e - 1
        self.end = self.seqlen - s - 1

    def flipped(self) -> "SeqCoord":
        c = SeqCoord(self.start, self.end, self.seqlen)
        c.flip()
        return c

    def extend(self, length: int) -> None:
        if self.is_left_extreme():
            self.end += length
        else:
            assert self.is_right_extreme() and self.start >= length
            self.start -= length

    def stretch(self, length: int) -> None:
        self.seqlen += length
        self.end += length

    def offset(self, delta: int) -> None:
        self.start += delta
        self.end += delta

    def complement(self) -> "SeqCoord":
        """The unmatched part of the sequence (src/coord.cpp:15-28)."""
        s, e = 0, -1
        if self.is_full():
            e = self.seqlen - 1
        elif self.is_empty():
            pass
        elif self.is_left_extreme():
            s = self.end + 1
            e = self.seqlen - 1
        else:
            assert self.is_right_extreme()
            e = self.start - 1
        return SeqCoord(s, e, self.seqlen)

    def copy(self) -> "SeqCoord":
        return SeqCoord(self.start, self.end, self.seqlen)

    def __str__(self) -> str:
        return f"{self.start} {self.end} {self.seqlen}"


@dataclass
class Match:
    coord1: SeqCoord = field(default_factory=SeqCoord)
    coord2: SeqCoord = field(default_factory=SeqCoord)
    is_rc: bool = False
    num_diff: int = 0

    def length(self) -> int:
        return self.coord1.length()

    def is_containment(self) -> bool:
        return self.coord1.is_contained() or self.coord2.is_contained()

    def translate10(self) -> int:
        if self.is_rc:
            c = self.coord1.flipped()
            return c.start - self.coord2.start
        return self.coord1.start - self.coord2.start

    def translate10_coord(self, c: SeqCoord) -> SeqCoord:
        t = self.translate10()
        r = SeqCoord(c.start + t, c.end + t, self.coord1.seqlen)
        if self.is_rc:
            r.flip()
        return r

    def __str__(self) -> str:
        return f"{self.coord1} {self.coord2} {int(self.is_rc)} {self.num_diff}"


@dataclass
class Overlap:
    id1: str = ""
    id2: str = ""
    match: Match = field(default_factory=Match)

    @classmethod
    def make(
        cls, id1: str, c1: SeqCoord, id2: str, c2: SeqCoord, is_rc: bool, nd: int
    ) -> "Overlap":
        return cls(id1, id2, Match(c1, c2, is_rc, nd))

    def is_containment(self) -> bool:
        return self.match.is_containment()

    def contained_idx(self) -> int:
        if self.match.coord1.is_contained() and self.match.coord2.is_contained():
            return 1 if self.id1 < self.id2 else 0
        if self.match.coord1.is_contained():
            return 0
        assert self.match.coord2.is_contained()
        return 1

    def __str__(self) -> str:
        return f"{self.id1} {self.id2} {self.match}"

    @classmethod
    def parse(cls, text: str) -> "Overlap":
        t = text.split()
        return cls(
            t[0],
            t[1],
            Match(
                SeqCoord(int(t[2]), int(t[3]), int(t[4])),
                SeqCoord(int(t[5]), int(t[6]), int(t[7])),
                bool(int(t[8])),
                int(t[9]),
            ),
        )
