"""`siga match` — per-read FM-index occurrence counts
(reference src/match.cpp:53-63)."""
from __future__ import annotations

import sys
from typing import List

from ..constants import BWT_EXT
from ..core import dna
from ..index.fm import FMIndex
from ..io import fastx


def run(opts: dict, arguments: List[str]) -> int:
    if not arguments:
        print("usage: siga match [OPTION] ... READSFILE", file=sys.stderr)
        return 256
    prefix = opts.get("prefix") or fastx.stem(arguments[0])
    index = FMIndex.load(prefix + BWT_EXT)
    rc = not opts.get("no-opposite-strand")
    max_length = int(opts.get("max-length", -1)) & ((1 << 62) - 1)

    def occ(w: str) -> int:
        n = index.occurrences(w)
        if rc:
            n += index.occurrences(dna.reverse_complement(w))
        return n

    for input_path in arguments:
        for read in fastx.open_reader(input_path):
            if len(read.seq) > max_length:
                start = read.seq[:max_length]
                end = read.seq[len(read.seq) - max_length :]
                sys.stdout.write(f"VT\t0\t{read.name}\t{read.seq}\t{occ(start)}\n")
                sys.stdout.write(f"VT\t1\t{read.name}\t{read.seq}\t{occ(end)}\n")
            else:
                sys.stdout.write(f"VT\t0\t{read.name}\t{read.seq}\t{occ(read.seq)}\n")
    return 0
