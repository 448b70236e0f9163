"""k-mer occurrence distribution sampling (reference KmerDistribution,
reference src/kmerdistr.cpp:7-36): sample random BWT rows, reconstruct
their reads by LF-walk, count every k-mer (forward + reversed) — the genome
size estimator's input.  The device k-mer counter batches the counting."""
from __future__ import annotations

import random
from typing import Dict, Optional

from ..index.fm import FMIndex


class KmerDistribution:
    def __init__(self):
        self.data: Dict[int, int] = {}

    def add(self, count: int) -> None:
        self.data[count] = self.data.get(count, 0) + 1

    @staticmethod
    def sample(
        index: FMIndex,
        k: int,
        n: int,
        distr: Optional["KmerDistribution"] = None,
        rng: Optional[random.Random] = None,
        counter=None,
    ) -> int:
        rng = rng or random.Random(0)
        total_len = 0
        kmers = []
        for _ in range(n):
            idx = rng.randrange(index.length)
            s = index.get_string(idx)
            if len(s) < k:
                continue
            for j in range(k, len(s)):
                kmers.append(s[j - k : j])
            total_len += len(s)
        if distr is not None and kmers:
            forward = kmers
            reverse = [w[::-1] for w in kmers]
            if counter is not None:
                fcounts = counter(forward)
                rcounts = counter(reverse)
            else:
                fcounts = [index.occurrences(w) for w in forward]
                rcounts = [index.occurrences(w) for w in reverse]
            for fc, rc in zip(fcounts, rcounts):
                distr.add(fc + rc)
        return total_len
