"""`correct` — k-mer error correction.

Port of `siga_tpu/commands/correct_cmd.py` with the same routing.  When the
index was built from these reads (same read count and text length, k <= 64)
the count oracle is the read set itself: the shared host correctors
`correct_reads_streaming` (`--engine=stream`, or above 300,000 reads) or
`correct_reads_batch`.  Otherwise the shared `correct_reads` counts k-mers
through K7 (`ops/kmer_count.py`) on the pair plane of the index on
`--device` (`--engine=auto|tpu`), or through `FMIndex.occurrences` on the
host (any other engine).  Only validQC reads are written to <prefix>.ec.fa.
"""
from __future__ import annotations

import sys
import time
from typing import List

from siga_tpu.constants import BWT_EXT, EC_EXT, FA_EXT
from siga_tpu.correct.batch import correct_reads_batch, correct_reads_streaming
from siga_tpu.correct.kmer import correct_reads
from siga_tpu.index.fm import FMIndex
from siga_tpu.io import fastx

from ..device import resolve_device

STREAM_ABOVE_READS = 300_000


def run(opts: dict, arguments: List[str]) -> int:
    if len(arguments) != 1:
        print("usage: correct [OPTION] ... READSFILE", file=sys.stderr)
        return 256
    input_path = arguments[0]
    prefix = opts.get("prefix") or fastx.stem(input_path)
    output = opts.get("out") or (prefix + EC_EXT + FA_EXT)

    algorithm = str(opts.get("algorithm", "kmer"))
    if algorithm != "kmer":
        print(f"correct algorithm {algorithm} is not supported", file=sys.stderr)
        return 255

    t0 = time.time()
    index = FMIndex.load(prefix + BWT_EXT)
    reads = fastx.read_sequences(input_path)
    params = dict(
        kmer_size=int(opts.get("kmer-size", 31)),
        rounds=int(opts.get("kmer-rounds", 10)),
        count_offset=int(opts.get("kmer-count-offset", 1)),
        threshold=int(opts.get("kmer-threshold", 3)),
    )
    consistent = (
        index.num_strings == len(reads)
        and index.length == sum(len(r.seq) + 1 for r in reads)
        and params["kmer_size"] <= 64
    )
    engine = str(opts.get("engine", "auto"))
    stream = engine == "stream" or (
        engine in ("auto", "tpu") and len(reads) > STREAM_ABOVE_READS
    )
    if consistent and stream:
        route = "streaming window table (host)"
        corrected = correct_reads_streaming(reads, **params)
    elif consistent and engine in ("auto", "tpu", "batch"):
        route = "batch window table (host)"
        corrected = correct_reads_batch(reads, **params)
    elif engine in ("auto", "tpu"):
        # imported here: the host routes start without torch
        from ..ops.fm_device import DeviceFM
        from ..ops.kmer_count import KmerCounter

        device = resolve_device(opts.get("device", "cuda"))
        route = f"k-mer counter K7 on {device}"
        counter = KmerCounter(DeviceFM(index, device))
        corrected = correct_reads(index, reads, counter=counter, **params)
    else:
        route = "FMIndex.occurrences (host)"
        corrected = correct_reads(index, reads, **params)

    with fastx.xopen(output, "wt") as out:
        for rec in corrected:
            out.write(rec.format())
    print(
        f"[correct] wall: {time.time() - t0:.3f} sec, {len(reads)} reads, {route}",
        file=sys.stderr,
    )
    return 0
