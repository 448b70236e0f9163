"""`siga preqc` — pre-assembly QC report (JSON)
(reference src/preqc.cpp): per-position mean quality and fraction-Q30 on
sampled reads; genome-size estimator skeleton via k-mer distribution sampling.
"""
from __future__ import annotations

import json
import random
import sys
from typing import List

from ..constants import BWT_EXT
from ..index.fm import FMIndex
from ..io import fastx


def run(opts: dict, arguments: List[str]) -> int:
    if not arguments:
        print("usage: siga preqc [OPTION] READSFILE", file=sys.stderr)
        return 256
    input_path = arguments[0]
    sample_rate = float(opts.get("sample-rate", 0.05))
    rng = random.Random(opts.get("seed", 0))

    counts: List[int] = []
    qsums: List[int] = []
    q30s: List[int] = []
    for read in fastx.open_reader(input_path):
        if rng.random() < sample_rate and len(read.seq) == len(read.quality):
            l = len(read.seq)
            while len(counts) < l:
                counts.append(0)
                qsums.append(0)
                q30s.append(0)
            for i in range(l):
                q = ord(read.quality[i]) - 33
                counts[i] += 1
                qsums[i] += q
                q30s[i] += 1 if q >= 30 else 0

    doc = {
        "QualityScores": {
            "mean_quality": [
                (qsums[i] / counts[i]) if counts[i] else 0.0
                for i in range(len(counts))
            ],
            "fraction_q30": [
                (q30s[i] / counts[i]) if counts[i] else 0.0
                for i in range(len(counts))
            ],
        }
    }

    if not opts.get("simple"):
        k = int(opts.get("kmer", 31))
        # sample the k-mer occurrence distribution from the FM-index when one
        # exists (reference GenomeEstimator skeleton reports size 0,
        # src/preqc.cpp:164-198)
        size = 0
        try:
            from ..constants import BWT_EXT
            from ..index.fm import FMIndex
            from ..index.kmerdistr import KmerDistribution

            prefix = opts.get("prefix") or fastx.stem(input_path)
            index = FMIndex.load(prefix + BWT_EXT)
            distr = KmerDistribution()
            KmerDistribution.sample(
                index, k, min(1000, int(opts.get("samples", 1000))), distr, rng
            )
        except (FileNotFoundError, OSError):
            pass
        doc["GenomeSize"] = {"k": k, "size": size}

    print(json.dumps(doc))
    return 0
