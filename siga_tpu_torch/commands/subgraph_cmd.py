"""`siga subgraph` — neighborhood extraction around a vertex
(reference src/subgraph.cpp)."""
from __future__ import annotations

import sys
from typing import List

from ..core.coord import Overlap
from ..graph.bigraph import GC_BLACK, Bigraph, EdgeCreator, Vertex
from ..io import fastx


def _add_vertex(vertex: Vertex, sub: Bigraph) -> None:
    if sub.get_vertex(vertex.id) is None:
        sub.add_vertex(
            Vertex(vertex.id, vertex.seq, vertex.contained, vertex.index_str())
        )


def _extract(root: Vertex, span: int, sub: Bigraph) -> None:
    _add_vertex(root, sub)
    if span > 0:
        creator = EdgeCreator(sub, True, -1)
        for edge in list(root.edges):
            if edge.color != GC_BLACK:
                child = edge.end
                _add_vertex(child, sub)
                overlap = Overlap(root.id, child.id, edge.match())
                creator.create(overlap)
                edge.color = GC_BLACK
                edge.twin.color = GC_BLACK
                _extract(child, span - 1, sub)


def run(opts: dict, arguments: List[str]) -> int:
    if len(arguments) != 2:
        print("usage: siga subgraph [OPTION] ... ID ASQGFILE", file=sys.stderr)
        return 256
    root_id, input_path = arguments
    output = opts.get("out", "subgraph.asqg.gz")

    with fastx.xopen(input_path, "rt") as stream:
        g = Bigraph.load(
            stream, int(opts.get("min-overlap", 0)), True, int(opts.get("max-edges", 128))
        )
    root = g.get_vertex(root_id)
    if root is None:
        print(f"Vertex {root_id} not found in the graph.", file=sys.stderr)
        return 255
    sub = Bigraph()
    sub.containment = g.containment
    _extract(root, int(opts.get("size", 5)), sub)
    with fastx.xopen(output, "wt") as stream:
        sub.save(stream)
    return 0
