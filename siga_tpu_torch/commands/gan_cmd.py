"""`siga gan` — emit labeled ML training rows for graph edges.

Mirrors reference src/gan.cpp: load the graph, optional reference
FM-index for ground truth, run GANVisitor rounds (each followed by simplify)
until no modification, write <prefix>-gan.fa and <prefix>-gan.asqg.gz.
Hidden from help like the reference (rank kUnknown, src/gan.cpp:107).
"""
from __future__ import annotations

import sys
from typing import List

from ..constants import ASQG_EXT, BWT_EXT, GZIP_EXT
from ..graph.bigraph import Bigraph
from ..graph.visitors import FastaVisitor, GANVisitor, StatisticsVisitor
from ..io import fastx


def run(opts: dict, arguments: List[str]) -> int:
    if len(arguments) != 1:
        print("usage: siga gan [OPTION] ... ASQGFILE", file=sys.stderr)
        return 256
    input_path = arguments[0]
    output = opts.get("prefix", "default")

    with fastx.xopen(input_path, "rt") as stream:
        g = Bigraph.load(
            stream, int(opts.get("min-overlap", 0)), True, int(opts.get("max-edges", 128))
        )
    g.validate()

    ref_index = None
    if opts.get("ref"):
        from ..index.fm import FMIndex

        ref_index = FMIndex.load(str(opts["ref"]) + BWT_EXT)

    stats = StatisticsVisitor()
    gan = GANVisitor(sys.stdout, ref_index)
    g.visit(stats)

    num_rounds = int(opts.get("cut-terminal", 10))
    for _round in range(num_rounds):
        if not g.visit(gan):
            break
        g.simplify()
        g.visit(stats)

    g.visit(stats)
    with open(output + "-gan.fa", "w") as stream:
        g.visit(FastaVisitor(stream))
    with fastx.xopen(output + "-gan" + ASQG_EXT + GZIP_EXT, "wt") as stream:
        g.save(stream)
    return 0
