"""FM-index: occ/rank tables and backward-search intervals.

Semantics mirror the reference FMIndex (reference src/fmindex.h:57-155,
src/fmindex.cpp:124-231): C(a) predecessor counts, occ(c, i) inclusive symbol
counts with occ(c, -1) == 0 (the reference reaches this via size_t wraparound,
src/fmindex.h:94-97), Interval init/update backward-search steps and ext()
extension counts.

Layout is ours, not the reference's: the on-disk `.bwt` RLE is decoded into a
flat rank-code array plus cumulative checkpoint counts every SAMPLE symbols.
A batched occ query is a checkpoint gather + masked tail reduce — the same
data layout the device path uses (ops/search.py), so host and device answers
are bit-identical.
"""
from __future__ import annotations

from typing import Tuple

import numpy as np

from ..core import dna
from ..io import bwtio

SAMPLE = 128


class FMIndex:
    """Host FM-index over decoded BWT rank codes."""

    def __init__(self, codes: np.ndarray, num_strings: int):
        self.codes = np.ascontiguousarray(codes, dtype=np.uint8)
        self.num_strings = int(num_strings)
        n = self.codes.size
        self.length = n
        nblocks = n // SAMPLE + 1
        # checkpoints[j, c] = count of symbol c in codes[: j*SAMPLE]; five
        # per-symbol block sums over the reshaped codes + a cumsum over
        # blocks.  (The previous int64-keyed bincount cost 3.8 s at 25 Mchar
        # — 90% of `siga overlap`'s FMIndex.load wall.)
        onehot = np.zeros((nblocks, dna.ALL_SIZE), dtype=np.int64)
        totals = np.zeros(dna.ALL_SIZE, dtype=np.int64)
        if n:
            nb_full = n // SAMPLE
            rows = self.codes[: nb_full * SAMPLE].reshape(nb_full, SAMPLE)
            tail = self.codes[nb_full * SAMPLE :]
            per_block = np.zeros((nblocks, dna.ALL_SIZE), dtype=np.int64)
            for c in range(dna.ALL_SIZE):
                per_block[:nb_full, c] = (rows == c).sum(
                    axis=1, dtype=np.int64
                )
                if tail.size:
                    per_block[nb_full, c] = int((tail == c).sum())
            onehot[1:] = np.cumsum(per_block[:-1], axis=0, dtype=np.int64)
            totals = per_block.sum(axis=0, dtype=np.int64)
        self.checkpoints = onehot
        self.totals = totals
        # C(a): number of symbols strictly smaller than a
        self.pred = np.concatenate(([0], np.cumsum(totals)[:-1]))
        self._positions = None

    @property
    def positions(self):
        """Per-symbol sorted position lists (host occ = 5 binary searches).

        Built lazily: the device engine + native stage B/C never touch them,
        and the eager 5-pass flatnonzero was a measurable share of `siga
        overlap`'s FM-load time at scale."""
        if self._positions is None:
            self._positions = [
                np.flatnonzero(self.codes == c) for c in range(dna.ALL_SIZE)
            ]
        return self._positions

    @classmethod
    def load(cls, path: str) -> "FMIndex":
        codes, num_strings, _num_suffixes = bwtio.load_bwt(path)
        return cls(codes, num_strings)

    def info(self) -> None:
        """Memory/shape dump (reference FMIndex::info,
        src/fmindex.cpp:163-173); RLE run count derived from the codes."""
        from ..core.logconf import get_logger

        log = get_logger("FMIndex")
        n = self.length
        runs = 1 + int(np.count_nonzero(self.codes[1:] != self.codes[:-1])) if n else 0
        # our runs are unbounded; the on-disk RLE splits at 31 (RLUnit)
        log.info("fm-index info:")
        log.info("occ sample rate: %d", SAMPLE)
        log.info(
            "contains %d symbols in %d runs (%.4f symbols per run)",
            n, runs, (n / runs) if runs else 0.0,
        )
        log.info(
            "checkpoint memory: %d blocks x %d counts (%.1f KB)",
            self.checkpoints.shape[0], self.checkpoints.shape[1],
            self.checkpoints.nbytes / 1024.0,
        )

    # ---- occ primitives (batched over arrays of positions) ----

    def occ_all(self, i) -> np.ndarray:
        """Inclusive counts of all 5 symbols up to position i; i may be -1.

        i: int or int array; returns (..., 5) int64.
        """
        i = np.asarray(i, dtype=np.int64)
        scalar = i.ndim == 0
        i = np.atleast_1d(i)
        # clamp to the valid query range [-1, n-1]; garbage lanes (padding)
        # may carry wild values whose answers are never read
        pos = np.clip(i, -1, self.length - 1) + 1  # number of symbols counted
        out = np.empty(i.shape + (dna.ALL_SIZE,), dtype=np.int64)
        for c in range(dna.ALL_SIZE):
            out[..., c] = np.searchsorted(self.positions[c], pos, side="left")
        return out[0] if scalar else out

    def occ(self, c_rank: int, i) -> np.ndarray:
        return self.occ_all(i)[..., c_rank]

    def pc(self, c_rank: int) -> int:
        return int(self.pred[c_rank])

    def get_char(self, i: int) -> int:
        """BWT symbol rank at position i."""
        return int(self.codes[i])

    def get_string(self, i: int) -> str:
        """Reconstruct the read whose '$' sits at BWT position i by LF-walk
        (reference FMIndex::getString, src/fmindex.cpp:292-313)."""
        out = []
        lo = i
        while True:
            c = int(self.codes[lo])
            if c == 0:
                break
            out.append(dna.DNA_ALL[c])
            lo = self.pc(c) + int(self.occ(c, lo - 1))
        return "".join(reversed(out))

    # ---- Interval ops ----

    def interval_init(self, c_rank: int) -> Tuple[int, int]:
        lo = self.pc(c_rank)
        hi = lo + int(self.totals[c_rank]) - 1
        return lo, hi

    def interval_update(self, c_rank: int, lo: int, hi: int) -> Tuple[int, int]:
        pb = self.pc(c_rank)
        nlo = pb + int(self.occ(c_rank, lo - 1))
        nhi = pb + int(self.occ(c_rank, hi)) - 1
        return nlo, nhi

    def interval_ext(self, lo: int, hi: int) -> np.ndarray:
        """AlphaCount of left extensions of the interval (occ(hi)-occ(lo-1))."""
        return self.occ_all(hi) - self.occ_all(lo - 1)

    def occurrences(self, w: str) -> int:
        """Count exact matches of w (reference Interval::occurrences)."""
        if not w:
            return 0
        ranks = dna.encode(w)
        lo, hi = self.interval_init(int(ranks[-1]))
        j = len(w) - 1
        while j > 0 and lo <= hi:
            j -= 1
            lo, hi = self.interval_update(int(ranks[j]), lo, hi)
        return hi - lo + 1 if lo <= hi else 0


def valid(lo: int, hi: int) -> bool:
    return hi >= lo and hi != -1


class IntervalPair:
    """Synchronized intervals in a forward+reverse FM-index pair enabling left
    and right extension (reference IntervalPair,
    src/overlap_builder.cpp:70-136).  Index 0 tracks the `index` argument,
    index 1 its reverse-text twin."""

    __slots__ = ("lo", "hi", "rlo", "rhi")

    def __init__(self, lo=0, hi=-1, rlo=0, rhi=-1):
        self.lo, self.hi, self.rlo, self.rhi = lo, hi, rlo, rhi

    def copy(self) -> "IntervalPair":
        return IntervalPair(self.lo, self.hi, self.rlo, self.rhi)

    def valid(self) -> bool:
        return valid(self.lo, self.hi) and valid(self.rlo, self.rhi)

    def init(self, c_rank: int, index: FMIndex, rindex: FMIndex) -> None:
        self.lo, self.hi = index.interval_init(c_rank)
        self.rlo, self.rhi = rindex.interval_init(c_rank)

    def update_left(self, c_rank: int, index: FMIndex) -> None:
        l = index.occ_all(self.lo - 1)
        u = index.occ_all(self.hi)
        diff = u - l
        self.rlo = self.rlo + int(diff[:c_rank].sum())
        self.rhi = self.rlo + int(diff[c_rank]) - 1
        pb = index.pc(c_rank)
        self.lo = pb + int(l[c_rank])
        self.hi = pb + int(u[c_rank]) - 1

    def update_right(self, c_rank: int, rindex: FMIndex) -> None:
        l = rindex.occ_all(self.rlo - 1)
        u = rindex.occ_all(self.rhi)
        diff = u - l
        self.lo = self.lo + int(diff[:c_rank].sum())
        self.hi = self.lo + int(diff[c_rank]) - 1
        pb = rindex.pc(c_rank)
        self.rlo = pb + int(l[c_rank])
        self.rhi = pb + int(u[c_rank]) - 1

    def ext_right(self, rindex: FMIndex) -> np.ndarray:
        return rindex.interval_ext(self.rlo, self.rhi)
