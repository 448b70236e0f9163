"""`siga preprocess` — read QC/filtering.

Filter order and semantics mirror the reference exactly
(reference src/preprocess.cpp:392-529): barcode index tagging, uppercase,
pure-ACGT check, phred64 shift + validation, hard clip, BWA-style quality soft
clip, low-quality-count filter, primer screen, min-length (default 40),
sample-rate subsampling; pe-mode 0/1/2 pairing with /1 /2 name fixup and
fr/rf/ff orientation normalization.
"""
from __future__ import annotations

import random
import sys
from typing import List, Optional

from ..core import quality as Q
from ..io import fastx

LOW_QUALITY_PHRED_SCORE = 3

# Sanger PCR-free primer prefixes (reference src/primer_screen.cpp)
PRIMER_DB = [
    "AATGATACGGCGACCACCGAGATCTACA",
    "GATCGGAAGAGCGGTTCAGCAGGAATGC",
]


def contains_primer(seq: str) -> bool:
    check = seq[:14]
    return any(check in p for p in PRIMER_DB)


class Stats:
    def __init__(self):
        self.reads_read = 0
        self.reads_kept = 0
        self.bases_read = 0
        self.bases_kept = 0
        self.reads_primer = 0
        self.invalid_pe = 0


def hard_clip(endpoint: int, rec: fastx.DNASeq) -> None:
    if len(rec.seq) > endpoint:
        rec.seq = rec.seq[:endpoint]
    if len(rec.quality) > endpoint:
        rec.quality = rec.quality[:endpoint]


def soft_clip(quality_trim: int, rec: fastx.DNASeq) -> None:
    """Heng Li's BWA 3'-end quality trim (src/preprocess.cpp:494-519)."""
    assert len(rec.seq) == len(rec.quality)
    i = len(rec.seq)
    terminal = Q.fromchar(rec.quality[i - 1])
    if terminal < quality_trim:
        endpoint = 0
        best = 0
        subsum = 0
        while i > 0:
            ps = Q.fromchar(rec.quality[i - 1])
            subsum += quality_trim - ps
            if subsum > best:
                best = subsum
                endpoint = i
            i -= 1
        hard_clip(endpoint, rec)


def process_read(
    opts: dict, rec: fastx.DNASeq, index: Optional[fastx.DNASeq], stats: Stats
) -> bool:
    stats.reads_read += 1
    stats.bases_read += len(rec.seq)

    if index is not None:
        prefixed = " " if rec.comment else ""
        rec.comment = f"{prefixed}BX:Z:{index.seq}" if not rec.comment else (
            rec.comment + f" BX:Z:{index.seq}"
        )

    rec.seq = rec.seq.upper()

    if any(c not in "ACGT" for c in rec.seq):
        return False

    if rec.quality:
        if opts.get("phred64"):
            rec.quality = "".join(Q.phred64to33(c) for c in rec.quality)
        # out-of-range qualities are reported but not fatal in the reference

    max_length = int(opts.get("hard-clip", 0))
    if max_length > 0:
        hard_clip(max_length, rec)

    quality_trim = int(opts.get("quality-trim", 0))
    if quality_trim > 0 and rec.quality:
        soft_clip(quality_trim, rec)

    quality_filter = int(opts.get("quality-filter", -1))
    if quality_filter >= 0 and rec.quality:
        low = sum(1 for q in rec.quality if Q.fromchar(q) <= LOW_QUALITY_PHRED_SCORE)
        if low >= quality_filter:
            return False

    if not opts.get("no-primer-check"):
        if contains_primer(rec.seq):
            stats.reads_primer += 1
            return False

    if len(rec.seq) < int(opts.get("min-length", 40)):
        return False
    return True


def sample_pass(opts: dict, rng: random.Random) -> bool:
    rate = opts.get("sample-rate")
    if rate is None:
        return True
    return rng.random() < float(rate)


def run(opts: dict, arguments: List[str]) -> int:
    pe_mode = int(opts.get("pe-mode", 0))
    orientation = str(opts.get("pe-orientation", "fr"))
    if orientation not in ("fr", "rf", "ff"):
        print("invalid pe-orientation", file=sys.stderr)
        return 256
    if not arguments:
        print("usage: siga preprocess [OPTION] READS1 READS2 ...", file=sys.stderr)
        return 256

    out_path = opts.get("out")
    out = fastx.xopen(out_path, "wt") if out_path else sys.stdout
    stats = Stats()
    rng = random.Random(opts.get("seed", 0))
    with_index = bool(opts.get("with-index"))

    try:
        if pe_mode == 0:
            multiples = 1 + (1 if with_index else 0)
            if len(arguments) % multiples != 0:
                return 255
            i = 0
            while i < len(arguments):
                idx_reader = None
                if with_index:
                    idx_reader = fastx.open_reader(arguments[i])
                    i += 1
                reader = fastx.open_reader(arguments[i])
                i += 1
                for rec in reader:
                    index = idx_reader.read() if idx_reader else None
                    if process_read(opts, rec, index, stats) and sample_pass(opts, rng):
                        out.write(rec.format())
                        stats.reads_kept += 1
                        stats.bases_kept += len(rec.seq)
        elif pe_mode in (1, 2):
            multiples = (2 if pe_mode == 1 else 1) + (1 if with_index else 0)
            if len(arguments) % multiples != 0:
                return 255
            i = 0
            while i < len(arguments):
                idx_reader = None
                if with_index:
                    idx_reader = fastx.open_reader(arguments[i])
                    i += 1
                if pe_mode == 1:
                    reader1 = fastx.open_reader(arguments[i])
                    reader2 = fastx.open_reader(arguments[i + 1])
                    i += 2
                else:
                    reader1 = reader2 = fastx.open_reader(arguments[i])
                    i += 1
                while True:
                    r1 = reader1.read()
                    if r1 is None:
                        break
                    r2 = reader2.read()
                    if r2 is None:
                        break
                    index = idx_reader.read() if idx_reader else None
                    if r1.name == r2.name:
                        r1.name += "/1"
                        r2.name += "/2"
                    expected2 = fastx.pairend_id(r1.name)
                    expected1 = fastx.pairend_id(r2.name)
                    if expected1 != r1.name or expected2 != r2.name:
                        stats.invalid_pe += 2
                    p1 = process_read(opts, r1, index, stats)
                    p2 = process_read(opts, r2, index, stats)
                    if p1 and p2 and sample_pass(opts, rng):
                        if orientation == "fr":
                            r2.make_reverse_complement()
                        elif orientation == "rf":
                            r1.make_reverse_complement()
                        out.write(r1.format())
                        out.write(r2.format())
                        stats.reads_kept += 2
                        stats.bases_kept += len(r1.seq) + len(r2.seq)
        else:
            print(f"Invalid pe mode parameter: {pe_mode}", file=sys.stderr)
            return 255
    finally:
        if out is not sys.stdout:
            out.close()

    print(
        f"[preprocess] reads parsed: {stats.reads_read}, kept: {stats.reads_kept}, "
        f"bases parsed: {stats.bases_read}, kept: {stats.bases_kept}, "
        f"primer-failed: {stats.reads_primer}",
        file=sys.stderr,
    )
    return 0
