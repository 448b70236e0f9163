"""The least bytes of the work a cell's kernels do, from its shapes alone.

Each input byte is counted read once and each output byte written once,
whatever a kernel reads again, and in the units the algorithm's inputs and
outputs have, not those of the port's own layouts (planes, packed words), so
that a redesign does not change what is counted.  A roofline share is the
least time at the card's memory rate (`least_ms`) over the measured device
time.
"""
from __future__ import annotations

import json
import os

PEAKS = os.path.join(os.path.dirname(os.path.abspath(__file__)), "peaks.json")


def index_build(text_chars: int, reads: int) -> int:
    """One direction of an index build: the rank text read once (1 B a
    character), the BWT written once (1 B a character) and the `.sai`
    permutation written once (an 8-byte read id a read)."""
    return 2 * text_chars + 8 * reads


def least_ms(kind: str, nbytes: int) -> float | None:
    """The least time (ms) to move `nbytes` at the memory rate of the card
    `kind` (the table in peaks.json), or None for a card not in it."""
    with open(PEAKS) as f:
        peak = json.load(f).get(kind)
    return None if peak is None else 1e3 * nbytes / peak["hbm_bytes_per_s"]
