"""`siga assemble` — generate contigs from an assembly graph.

Visitor schedule mirrors reference src/assembler.cpp:49-241:
load -> validate -> stats -> (pe-mode=1: insert-size estimate + paired-read)
-> simplify -> (10x linked-read) -> trim rounds {loop, maximum-overlap, trim,
linked-read?, chimeric?} each followed by simplify -> contigs.fa + graph
ASQG.
"""
from __future__ import annotations

import sys
from typing import List

from ..constants import ASQG_EXT, GZIP_EXT
from ..graph.bigraph import Bigraph
from ..graph.visitors import (
    ChimericVisitor,
    FastaVisitor,
    InsertSizeEstimateVisitor,
    LinkedReadVisitor,
    LoopRemoveVisitor,
    MaximumOverlapVisitor,
    PairedReadVisitor,
    StatisticsVisitor,
    TrimVisitor,
)
from ..io import fastx


def run(opts: dict, arguments: List[str]) -> int:
    if len(arguments) != 1:
        print("usage: siga assemble [OPTION] ... ASQGFILE", file=sys.stderr)
        return 256
    input_path = arguments[0]
    output = opts.get("prefix", "default")
    min_overlap = int(opts.get("min-overlap", 40))
    pe_mode = int(opts.get("pe-mode", 0))

    with fastx.xopen(input_path, "rt") as stream:
        g = Bigraph.load(
            stream, min_overlap, True, int(opts.get("max-edges", -1))
        )
    g.validate()

    stats = StatisticsVisitor()
    trim = TrimVisitor(
        int(opts.get("min-branch-length", 150)),
        int(opts.get("min-branch-coverage", -1)),
    )
    loop = LoopRemoveVisitor()
    mo = MaximumOverlapVisitor(
        int(opts.get("max-overlap-delta", 0)),
        bool(opts.get("max-overlap-carefully")),
        int(opts.get("num-reads", 0)),
        int(opts.get("genome-size", 0)),
        float(opts.get("uniq-threshold", 13.0)),
    )
    chimeric = ChimericVisitor(
        int(opts.get("min-chimeric-length", 0)),
        int(opts.get("max-chimeric-coverage", -1)),
        int(opts.get("max-chimeric-delta", -1)),
        int(opts.get("num-reads", 0)),
        int(opts.get("genome-size", 0)),
        float(opts.get("uniq-threshold", 0.0)),
    )

    g.visit(stats)

    if pe_mode == 1:
        average = int(opts.get("insert-size", 500))
        delta = int(opts.get("insert-size-delta", 100))
        if "insert-size" not in opts or "insert-size-delta" not in opts:
            ise = InsertSizeEstimateVisitor()
            g.visit(ise)
            if ise.samples:
                if "insert-size" not in opts:
                    average = ise.average
                if "insert-size-delta" not in opts:
                    delta = int(ise.delta)
        pr = PairedReadVisitor(
            int(opts.get("max-distance", 100)),
            average,
            delta,
            int(opts.get("max-search-nodes", 100)),
        )
        g.visit(pr)

    g.simplify()

    ai_visit = None
    if opts.get("ai-model"):
        from ..graph.visitors import AIVisitor
        from ..ml.model import BaggingModel

        try:
            model = BaggingModel.load(str(opts["ai-model"]))
            ai_visit = AIVisitor(
                model,
                int(opts.get("num-reads", 0)),
                int(opts.get("genome-size", 0)),
            )
        except (OSError, ValueError, KeyError):
            print("load ai model failed", file=sys.stderr)

    if opts.get("with-index"):
        g.visit(LinkedReadVisitor())
        g.simplify()

    num_rounds = int(opts.get("cut-terminal", 10))
    if pe_mode == 1:
        for _round in range(num_rounds):
            modified = False
            if g.visit(trim):
                modified = True
                g.simplify()
            if not modified:
                break
            g.visit(stats)
    else:
        g.visit(stats)
        lr = LinkedReadVisitor(
            int(opts.get("min-linkedread-length", -1)) & ((1 << 62) - 1),
            int(opts.get("min-linkedread-coverage", -1)) & ((1 << 62) - 1),
        )
        for _round in range(num_rounds):
            modified = False
            if ai_visit is not None:
                if g.visit(ai_visit):
                    modified = True
                    g.simplify()
            if g.visit(loop):
                modified = True
                g.simplify()
            if g.visit(mo):
                modified = True
                g.simplify()
            if g.visit(trim):
                modified = True
                g.simplify()
            if opts.get("with-index"):
                if g.visit(lr):
                    modified = True
                    g.simplify()
            if int(opts.get("min-chimeric-length", 0)) > 0:
                if g.visit(chimeric):
                    modified = True
                    g.simplify()
            if not modified:
                break
            g.visit(stats)

    g.visit(stats)

    with open(output + "-contigs.fa", "w") as stream:
        g.visit(FastaVisitor(stream))
    with fastx.xopen(output + "-graph" + ASQG_EXT + GZIP_EXT, "wt") as stream:
        g.save(stream)
    return 0
