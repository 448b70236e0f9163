"""DNA alphabet: rank maps, complements, and vectorized sequence codecs.

Semantics follow the reference 5-symbol alphabet `$ACGT` with ranks
$=0 A=1 C=2 G=3 T=4 (reference src/alphabet.h:13-43); everything here is
table-driven numpy so whole read batches encode/decode in one shot.
"""
from __future__ import annotations

import numpy as np

ALL_SIZE = 5
DNA_ALL = "$ACGT"
DNA = "ACGT"

# 256-entry char->rank LUT; unknown chars map to 0 like the reference.
RANK_LUT = np.zeros(256, dtype=np.uint8)
for _i, _c in enumerate(DNA_ALL):
    RANK_LUT[ord(_c)] = _i

CHAR_LUT = np.frombuffer(DNA_ALL.encode(), dtype=np.uint8).copy()

# char -> complement char (A<->T, C<->G, N->N); other bytes map to themselves
COMP_LUT = np.arange(256, dtype=np.uint8)
for _a, _b in [("A", "T"), ("C", "G"), ("G", "C"), ("T", "A"), ("N", "N")]:
    COMP_LUT[ord(_a)] = ord(_b)

# rank -> complement rank ($->$, A<->T, C<->G)
COMP_RANK = np.array([0, 4, 3, 2, 1], dtype=np.uint8)


def torank(c: str) -> int:
    return int(RANK_LUT[ord(c)])


def tochar(rank: int) -> str:
    return DNA_ALL[rank]


def encode(seq: str) -> np.ndarray:
    """String -> rank codes (uint8)."""
    return RANK_LUT[np.frombuffer(seq.encode(), dtype=np.uint8)]


def decode(ranks: np.ndarray) -> str:
    """Rank codes -> string."""
    return CHAR_LUT[np.asarray(ranks, dtype=np.uint8)].tobytes().decode()


def complement(seq: str) -> str:
    return COMP_LUT[np.frombuffer(seq.encode(), dtype=np.uint8)].tobytes().decode()


def reverse(seq: str) -> str:
    return seq[::-1]


def reverse_complement(seq: str) -> str:
    return complement(seq)[::-1]


def complement_char(c: str) -> str:
    return chr(COMP_LUT[ord(c)])
