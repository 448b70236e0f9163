"""k-mer frequency error correction.

Mirrors the reference KmerCorrector
(reference src/correct_processor.cpp:72-229) exactly, including its
quirk: `countVector` is allocated per round but never populated, so the
min-count passed to try2Correct is max(0 + count_offset, threshold) — i.e. the
phred-dependent threshold dominates.  Defaults k=31, threshold=3, rounds=10,
count-offset=1 (src/correct_processor.h:15-20); bases covered by a k-mer with
count >= threshold(phred) are solid; the leftmost weak base is corrected by
trying the 3 substitutions in the leftmost then rightmost covering k-mer,
requiring a unique candidate.

The device path batches the per-round k-mer counting: all (n-k+1) k-mers of a
read batch are counted in one backward-search scan (ops/kmer_count.py); the
correction decision loop stays host-side (<=10 rounds, rare).
"""
from __future__ import annotations

from typing import Dict, List, Optional, Tuple

from ..core import dna
from ..index.fm import FMIndex
from ..io.fastx import DNASeq

DEFAULT_KMER_SIZE = 31
DEFAULT_THRESHOLD = 3
DEFAULT_ROUNDS = 10
DEFAULT_COUNT_OFFSET = 1
PHRED_CUTOFF = 20


class CorrectThreshold:
    def __init__(self, min_support: int = DEFAULT_THRESHOLD):
        self.low = min_support
        self.high = min_support + 1

    def required(self, phred: int) -> int:
        return self.high if phred >= PHRED_CUTOFF else self.low


class KmerCorrector:
    def __init__(
        self,
        index: FMIndex,
        kmer_size: int = DEFAULT_KMER_SIZE,
        rounds: int = DEFAULT_ROUNDS,
        count_offset: int = DEFAULT_COUNT_OFFSET,
        threshold: int = DEFAULT_THRESHOLD,
        counter=None,
    ):
        self.index = index
        self.k = kmer_size
        self.rounds = rounds
        self.count_offset = count_offset
        self.thresholds = CorrectThreshold(threshold)
        # pluggable batched counter: fn(list[str]) -> list[int]
        self._counter = counter
        self._cache: Dict[str, int] = {}

    def _count(self, kmer: str) -> int:
        c = self._cache.get(kmer)
        if c is None:
            c = self.index.occurrences(kmer)
            self._cache[kmer] = c
        return c

    def _count_many(self, kmers: List[str]) -> List[int]:
        missing = [w for w in kmers if w not in self._cache]
        if missing and self._counter is not None:
            for w, c in zip(missing, self._counter(missing)):
                self._cache[w] = c
        return [self._count(w) for w in kmers]

    def process(self, read: DNASeq) -> Tuple[str, bool]:
        """Returns (sequence, validQC)."""
        seq = read.seq
        k = self.k
        n = len(seq)
        if n < k:
            return seq, False

        # min phred score within each k-mer window
        scores = [read.score(j) for j in range(n)]
        min_phred = [min(scores[i : i + k]) for i in range(n - k + 1)]

        all_solid = False
        rounds = 0
        done = False
        while not done:
            kmers = [seq[i : i + k] for i in range(n - k + 1)]
            counts = self._count_many(kmers)
            solid = [False] * n
            for i, count in enumerate(counts):
                if count >= self.thresholds.required(min_phred[i]):
                    for j in range(k):
                        solid[i + j] = True

            all_solid = all(solid)
            rounds += 1
            if all_solid or rounds > self.rounds:
                break

            corrected = False
            for i in range(n):
                if not solid[i]:
                    phred = read.score(i)
                    threshold = self.thresholds.required(phred)
                    # countVector quirk: the reference's countVector is never
                    # filled, so min_count = max(count_offset, threshold)
                    min_count = max(self.count_offset, threshold)
                    left_idx = i + 1 - k if i + 1 >= k else 0
                    seq, corrected = self._try_correct(i, left_idx, min_count, seq)
                    if corrected:
                        break
                    right_idx = min(i, n - k)
                    seq, corrected = self._try_correct(i, right_idx, min_count, seq)
                    if corrected:
                        break
            if not corrected:
                done = True

        if all_solid:
            return seq, True
        return read.seq, False

    def _try_correct(
        self, base_idx: int, kmer_idx: int, min_count: int, seq: str
    ) -> Tuple[str, bool]:
        assert kmer_idx <= base_idx < kmer_idx + self.k
        delta = base_idx - kmer_idx
        curr = seq[base_idx]
        kmer = list(seq[kmer_idx : kmer_idx + self.k])
        best_count = 0
        best_base = "$"
        candidates = []
        for c in dna.DNA:
            if c != curr:
                kmer[delta] = c
                candidates.append((c, "".join(kmer)))
        counts = self._count_many([w for _c, w in candidates])
        for (c, _w), count in zip(candidates, counts):
            if count >= min_count:
                if best_base != "$":
                    return seq, False  # ambiguous
                best_base = c
                best_count = count
        if best_count >= min_count:
            assert best_base != "$"
            out = seq[:base_idx] + best_base + seq[base_idx + 1 :]
            return out, True
        return seq, False


def correct_reads(
    index: FMIndex,
    reads: List[DNASeq],
    kmer_size: int = DEFAULT_KMER_SIZE,
    rounds: int = DEFAULT_ROUNDS,
    count_offset: int = DEFAULT_COUNT_OFFSET,
    threshold: int = DEFAULT_THRESHOLD,
    counter=None,
):
    """Yield corrected DNASeq for reads that pass QC (reference PostCorrector
    drops validQC=false reads, src/correct_processor.cpp:252-268)."""
    corrector = KmerCorrector(
        index, kmer_size, rounds, count_offset, threshold, counter=counter
    )
    if counter is not None:
        # prefill the cache with every k-mer of the read set in one batched
        # device call; correction rounds then only count novel candidates
        all_kmers = set()
        for read in reads:
            s = read.seq
            for i in range(len(s) - kmer_size + 1):
                all_kmers.add(s[i : i + kmer_size])
        corrector._count_many(list(all_kmers))
    for read in reads:
        seq, valid = corrector.process(read)
        if valid:
            out = DNASeq(read.name, seq, read.quality, read.comment)
            yield out
