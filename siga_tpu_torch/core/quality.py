"""Phred quality transforms (reference: reference src/quality.h:13-41)."""

DEFAULT_SCORE = 15
PHRED64_DIFF = 31


def phred64to33(c: str) -> str:
    return chr(ord(c) - PHRED64_DIFF)


def is_valid(c: str) -> bool:
    p = ord(c) - 33
    return 0 <= p <= 93


def fromchar(b: str) -> int:
    v = ord(b)
    assert v >= 33
    return v - 33


def tochar(p: int) -> str:
    return chr(min(p, 93) + 33)
