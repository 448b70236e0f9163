"""Striped-Smith-Waterman-compatible local alignment.

Drop-in equivalent of the reference's vendored SSW
(reference 3rdparty/ssw_cpp.h:82-83: match=2 mismatch=2 gap_open=3
gap_extend=1; a gap of length L costs open + (L-1)*extend) with '='/'X' cigar
ops and soft clips for unaligned query ends, validated against the reference
test fixture (test/index_test.cpp:95-123, cigar "4=1X4=1I5=").

The host path is a full affine-gap DP with traceback.  The device path
(ops/sw_device.py) scores batches of (query, ref) pairs by anti-diagonal
wavefront — scores and end positions on device, traceback for reported
alignments on host.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import List, Tuple

import numpy as np


@dataclass
class Alignment:
    sw_score: int = 0
    sw_score_next_best: int = 0
    ref_begin: int = 0
    ref_end: int = 0
    query_begin: int = 0
    query_end: int = 0
    ref_end_next_best: int = 0
    mismatches: int = 0
    cigar_string: str = ""
    cigar: List[int] = field(default_factory=list)


# BAM cigar op codes used by SSW: M/I/D/S/X = 0/1/2/4/8
_OP_CODE = {"M": 0, "I": 1, "D": 2, "S": 4, "=": 7, "X": 8}


def _bam_cigar(ops: List[Tuple[int, str]]) -> List[int]:
    return [(length << 4) | _OP_CODE[op] for length, op in ops]


class Aligner:
    def __init__(
        self,
        query: str,
        match_score: int = 2,
        mismatch_penalty: int = 2,
        gap_opening_penalty: int = 3,
        gap_extending_penalty: int = 1,
    ):
        self.query = query
        self.match = match_score
        self.mismatch = mismatch_penalty
        self.gap_open = gap_opening_penalty
        self.gap_extend = gap_extending_penalty

    def align(self, ref: str) -> Alignment:
        q, r = self.query, ref
        m, n = len(q), len(r)
        NEG = -(10**9)
        # H: best score ending at (i, j); E: gap in ref (insertion to query?);
        # ssw convention: E = gap in query dimension (deletion from ref read
        # consumes ref), F = gap consuming query (insertion)
        H = np.zeros((m + 1, n + 1), dtype=np.int64)
        E = np.full((m + 1, n + 1), NEG, dtype=np.int64)  # gap consuming query (I)
        F = np.full((m + 1, n + 1), NEG, dtype=np.int64)  # gap consuming ref (D)
        for i in range(1, m + 1):
            for j in range(1, n + 1):
                E[i, j] = max(H[i - 1, j] - self.gap_open, E[i - 1, j] - self.gap_extend)
                F[i, j] = max(H[i, j - 1] - self.gap_open, F[i, j - 1] - self.gap_extend)
                sub = self.match if q[i - 1] == r[j - 1] else -self.mismatch
                H[i, j] = max(0, H[i - 1, j - 1] + sub, E[i, j], F[i, j])

        best = int(H.max())
        bi, bj = np.unravel_index(int(H.argmax()), H.shape)
        result = Alignment(sw_score=best, ref_end=int(bj) - 1, query_end=int(bi) - 1)

        # next best: max H over columns (ref end positions) != best column
        col_max = H.max(axis=0)
        col_max[bj] = 0
        result.sw_score_next_best = int(col_max.max())
        result.ref_end_next_best = int(col_max.argmax()) - 1 if col_max.max() > 0 else 0

        # traceback
        ops: List[Tuple[int, str]] = []
        i, j = int(bi), int(bj)
        mismatches = 0

        def push(op: str):
            if ops and ops[-1][1] == op:
                ops[-1] = (ops[-1][0] + 1, op)
            else:
                ops.append((1, op))

        while i > 0 and j > 0 and H[i, j] > 0:
            sub = self.match if q[i - 1] == r[j - 1] else -self.mismatch
            if H[i, j] == H[i - 1, j - 1] + sub:
                push("=" if q[i - 1] == r[j - 1] else "X")
                if q[i - 1] != r[j - 1]:
                    mismatches += 1
                i -= 1
                j -= 1
            elif H[i, j] == E[i, j]:
                # walk the E-gap (consumes query rows)
                while i > 0:
                    push("I")
                    mismatches += 1
                    ei = E[i, j]
                    i -= 1
                    if ei == H[i, j] - self.gap_open:
                        break
            elif H[i, j] == F[i, j]:
                while j > 0:
                    push("D")
                    mismatches += 1
                    fj = F[i, j]
                    j -= 1
                    if fj == H[i, j] - self.gap_open:
                        break
            else:  # pragma: no cover - H==0 handled by loop condition
                break

        result.ref_begin = j
        result.query_begin = i
        ops.reverse()

        # soft clips for unaligned query ends (SSW semantics)
        full = []
        if result.query_begin > 0:
            full.append((result.query_begin, "S"))
        full.extend(ops)
        tail = m - 1 - result.query_end
        if tail > 0:
            full.append((tail, "S"))

        result.cigar_string = "".join(f"{l}{op}" for l, op in full)
        result.cigar = _bam_cigar(full)
        result.mismatches = mismatches
        return result
