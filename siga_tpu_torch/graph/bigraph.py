"""Bidirected string graph (the assembly graph).

Semantics mirror the reference Bigraph (reference src/bigraph.h/.cpp):
edges carry a direction (SENSE/ANTISENSE), a strand comp (SAME/REVERSE), the
SeqCoord of the matched region, and a twin pointer; `Vertex.merge` extends the
sequence by the edge label and restretches every incident coordinate;
`simplify` compacts unbranched chains to a fixpoint; `EdgeCreator` builds twin
pairs (4 edges for containments).  ASQG load/save is staged HT -> VT -> ED with
canonical id1 <= id2 edge emission.

Divergence from the reference by design: vertices live in an insertion-ordered
dict, so every pass is deterministic (the reference iterates an unordered_map,
src/bigraph.h:240).
"""
from __future__ import annotations

from typing import Callable, Dict, Iterable, List, Optional, Tuple

from ..core import dna
from ..core.coord import Match, Overlap, SeqCoord
from ..io import asqg

# GraphColor
GC_NONE = -1
GC_WHITE = 0
GC_GRAY = 1
GC_BLACK = 2
GC_RED = 3
GC_GREEN = 4
GC_BLUE = 5

# Edge::Dir
ED_SENSE = 0
ED_ANTISENSE = 1
ED_COUNT = 2

# Edge::Comp
EC_SAME = 0
EC_REVERSE = 1


class Edge:
    __slots__ = ("end", "dir", "comp", "coord", "color", "twin")

    def __init__(self, end: "Vertex", dir: int, comp: int, coord: SeqCoord):
        self.end = end
        self.dir = dir
        self.comp = comp
        self.coord = coord
        self.color = GC_NONE
        self.twin: Optional["Edge"] = None

    def start(self) -> "Vertex":
        assert self.twin is not None
        return self.twin.end

    def match(self) -> Match:
        return Match(self.coord, self.twin.coord, self.comp == EC_REVERSE, 0)

    def is_self(self) -> bool:
        return self.start() is self.end

    def label(self) -> str:
        """Unmatched part of the end vertex, rc'd when comp is REVERSE
        (src/bigraph.cpp:23-33)."""
        unmatched = self.twin.coord.complement()
        seq = self.end.seq
        label = seq[unmatched.start : unmatched.start + unmatched.length()]
        if self.comp == EC_REVERSE:
            label = dna.reverse_complement(label)
        return label

    def join(self, edge: "Edge") -> None:
        """Rewire this edge across a merge (src/bigraph.cpp:35-46)."""
        m = edge.match()
        self.coord = m.translate10_coord(self.coord)
        if edge.comp == EC_REVERSE:
            self.comp = EC_REVERSE - self.comp
            self.dir = ED_COUNT - self.dir - 1
        self.twin.extend(edge.twin)

    def extend(self, edge: "Edge") -> None:
        if edge.comp == EC_REVERSE:
            self.comp = EC_REVERSE - self.comp
        self.end = edge.end

    def same_as(self, other: "Edge") -> bool:
        return (
            self.end.id == other.end.id
            and self.dir == other.dir
            and self.comp == other.comp
        )

    def validate(self) -> None:
        v1, v2 = self.start().seq, self.end.seq
        m1 = v1[self.coord.start : self.coord.start + self.coord.length()]
        c2 = self.twin.coord
        m2 = v2[c2.start : c2.start + c2.length()]
        if self.comp == EC_REVERSE:
            m2 = dna.reverse_complement(m2)
        assert m1 == m2, (
            f"matched substrings differ: {self.start().id}:{m1} vs {self.end.id}:{m2}"
        )


class Vertex:
    __slots__ = (
        "id", "_parts", "_len", "color", "contained", "coverage",
        "index_tbl", "ext", "edges",
    )

    def __init__(
        self,
        vid: str,
        seq: str,
        contained: bool = False,
        index: str = "",
        coverage: int = 1,
        ext: str = "",
    ):
        self.id = vid
        self.seq = seq
        self.color = GC_NONE
        self.contained = contained
        self.coverage = coverage
        # barcode multimap: list of (barcode, count) preserving insertion order
        self.index_tbl: List[Tuple[str, int]] = []
        if index:
            for item in index.split(","):
                c = 1
                barcode = item
                k = item.rfind("!")
                if k != -1:
                    barcode = item[:k]
                    c = int(item[k + 1 :])
                self.index_tbl.append((barcode, c))
        self.ext: List[str] = [e for e in ext.split(",") if e] if ext else []
        self.edges: List[Edge] = []

    # The sequence is a lazily-joined rope: `merge` appends/prepends label
    # parts without materializing, so an n-merge chain costs O(final length)
    # instead of the O(length^2) of repeated str concatenation — the main
    # scaling wall of the reference's simplify (src/bigraph.cpp:341-414).
    @property
    def seq(self) -> str:
        if len(self._parts) > 1:
            self._parts = ["".join(self._parts)]
        return self._parts[0] if self._parts else ""

    @seq.setter
    def seq(self, value: str) -> None:
        self._parts = [value]
        self._len = len(value)

    def seqlen(self) -> int:
        return self._len

    def index_str(self) -> str:
        # multimap iteration order: sorted by barcode, insertion order within
        return ",".join(
            f"{b}!{c}" for b, c in sorted(self.index_tbl, key=lambda x: x[0])
        )

    def ext_str(self) -> str:
        return ",".join(self.ext)

    def edges_dir(self, dir: int) -> List[Edge]:
        return [e for e in self.edges if e.dir == dir]

    def degrees(self, dir: Optional[int] = None) -> int:
        if dir is None:
            return len(self.edges)
        return sum(1 for e in self.edges if e.dir == dir)

    def add_edge(self, edge: Edge) -> None:
        assert edge.start() is self
        self.edges.append(edge)

    def remove_edge(self, edge: Edge) -> None:
        self.edges.remove(edge)

    def has_edge(self, edge: Edge) -> bool:
        return any(e.same_as(edge) for e in self.edges)

    def sweep_edges(self, color: int) -> int:
        before = len(self.edges)
        self.edges = [e for e in self.edges if e.color != color]
        return before - len(self.edges)

    def merge(self, edge: Edge) -> None:
        """Concatenate the edge label into this vertex and restretch incident
        edge coordinates (src/bigraph.cpp:131-202).  The label lands in the
        rope parts list — no quadratic re-concatenation along chains."""
        twin = edge.twin
        label = edge.label()
        prepend = False
        if edge.dir == ED_SENSE:
            self._parts.append(label)
        else:
            self._parts.insert(0, label)
            prepend = True
        self._len += len(label)

        self.coverage += edge.end.coverage
        self.index_tbl.extend(edge.end.index_tbl)
        if prepend:
            self.ext = list(edge.end.ext) + self.ext
        else:
            self.ext = self.ext + list(edge.end.ext)

        edge.coord.stretch(len(label))
        twin.coord.extend(len(label))

        for e in self.edges:
            e.coord.seqlen = self._len
            if prepend and e.dir == ED_SENSE and e is not edge:
                e.coord.offset(len(label))

    def delete_edges(self) -> None:
        for edge in list(self.edges):
            partner = edge.end
            if edge.twin in partner.edges:
                partner.edges.remove(edge.twin)
        self.edges = []

    def validate(self) -> None:
        for e in self.edges:
            e.validate()


class Bigraph:
    def __init__(self):
        self.vertices: Dict[str, Vertex] = {}
        self.containment = False

    def add_vertex(self, vertex: Vertex) -> bool:
        if vertex.id in self.vertices:
            return False
        self.vertices[vertex.id] = vertex
        return True

    def get_vertex(self, vid: str) -> Optional[Vertex]:
        return self.vertices.get(vid)

    def remove_vertex(self, vertex: Vertex) -> None:
        del self.vertices[vertex.id]

    def sweep_vertices(self, color: int) -> int:
        doomed = [v for v in self.vertices.values() if v.color == color]
        for v in doomed:
            v.delete_edges()
            self.remove_vertex(v)
        return len(doomed)

    def sweep_edges(self, color: int) -> int:
        return sum(v.sweep_edges(color) for v in self.vertices.values())

    def color(self, c: int) -> None:
        for v in self.vertices.values():
            v.color = c

    def visit(self, visitor) -> bool:
        modified = False
        visitor.previsit(self)
        for v in list(self.vertices.values()):
            if v.id in self.vertices:  # visitors may remove vertices mid-pass
                modified |= bool(visitor.visit(self, v))
        visitor.postvisit(self)
        return modified

    def merge(self, v1: Vertex, edge: Edge) -> None:
        """Merge edge.end into v1 along edge (src/bigraph.cpp:377-414)."""
        v2 = edge.end
        v1.merge(edge)
        twin = edge.twin
        assert v2.has_edge(twin)
        trans_edges = v2.edges_dir(ED_COUNT - twin.dir - 1)
        for trans in trans_edges:
            v2.remove_edge(trans)
            trans.join(edge)
            assert trans.dir == edge.dir
            v1.add_edge(trans)
        v1.remove_edge(edge)
        v2.remove_edge(twin)

    def simplify(self) -> None:
        self._simplify(ED_SENSE)
        self._simplify(ED_ANTISENSE)

    def _simplify(self, dir: int) -> None:
        changed = True
        while changed:
            changed = False
            for v in list(self.vertices.values()):
                if v.id not in self.vertices:
                    continue
                # absorb the whole dir-ward unbranched chain from v in one
                # inner walk: the chain head absorbs everything either way
                # (the sweep version pairs in O(log k) rounds, same final
                # graph), but walking here keeps each label O(1) work
                while True:
                    edges = v.edges_dir(dir)
                    if len(edges) != 1 or edges[0].is_self():
                        break
                    single = edges[0]
                    twin = single.twin
                    end = single.end
                    if end.degrees(twin.dir) != 1:
                        break
                    if (
                        single.coord.is_contained()
                        or twin.coord.is_contained()
                    ):
                        break
                    self.merge(v, single)
                    self.remove_vertex(end)
                    changed = True

    def validate(self) -> None:
        for v in self.vertices.values():
            v.validate()

    # ---- ASQG I/O ----

    @classmethod
    def load(
        cls,
        stream: Iterable[str],
        min_overlap: int,
        allow_containments: bool,
        max_edges: int,
    ) -> "Bigraph":
        g = cls()
        creator = EdgeCreator(g, allow_containments, max_edges)
        stage = 0  # 0 head, 1 vertex, 2 edge
        for line in stream:
            line = line.rstrip("\n")
            if not line:
                continue
            rt = asqg.record_type(line)
            if rt == "header":
                assert stage == 0, "unexpected header record"
            elif rt == "vertex":
                if stage == 0:
                    stage = 1
                assert stage == 1, "unexpected vertex record"
                rec = asqg.VertexRecord.parse(line)
                vertex = Vertex(
                    rec.id,
                    rec.seq,
                    bool(rec.substring) if rec.substring is not None else False,
                    rec.barcode or "",
                    rec.coverage if rec.coverage is not None else 1,
                    rec.ext or "",
                )
                if not g.add_vertex(vertex):
                    raise ValueError(f"duplicate vertex id: {vertex.id}")
                if vertex.contained:
                    g.containment = True
            elif rt == "edge":
                if stage == 1:
                    stage = 2
                assert stage == 2, "unexpected edge record"
                rec = asqg.EdgeRecord.parse(line)
                ovr = rec.overlap
                if ovr.match.length() >= min_overlap:
                    creator.create(ovr)
        return g

    def save(self, stream) -> None:
        stream.write(asqg.HeaderRecord().format() + "\n")
        for v in self.vertices.values():
            rec = asqg.VertexRecord(id=v.id, seq=v.seq)
            barcode = v.index_str()
            if barcode:
                rec.barcode = barcode
            rec.coverage = v.coverage
            ext = v.ext_str()
            if ext:
                rec.ext = ext
            stream.write(rec.format() + "\n")
        for v in self.vertices.values():
            for edge in v.edges:
                twin = edge.twin
                ovr = Overlap.make(
                    edge.start().id,
                    edge.coord.copy(),
                    edge.end.id,
                    twin.coord.copy(),
                    edge.comp == EC_REVERSE,
                    0,
                )
                if ovr.id1 <= ovr.id2:
                    if not ovr.match.is_containment() or edge.dir == ED_SENSE:
                        stream.write(asqg.EdgeRecord(overlap=ovr).format() + "\n")


class EdgeCreator:
    """Create graph edges from Overlap records (src/bigraph.cpp:440-530)."""

    def __init__(self, g: Bigraph, allow_containments: bool, max_edges: int):
        self.graph = g
        self.allow_containments = allow_containments
        self.max_edges = max_edges if max_edges >= 0 else float("inf")

    def create(self, overlap: Overlap, color: int = GC_NONE) -> bool:
        comp = EC_REVERSE if overlap.match.is_rc else EC_SAME
        is_containment = overlap.match.is_containment()
        if not self.allow_containments and is_containment:
            return False

        verts = [
            self.graph.get_vertex(overlap.id1),
            self.graph.get_vertex(overlap.id2),
        ]
        if verts[0] is None or verts[1] is None:
            return False

        coords = [overlap.match.coord1, overlap.match.coord2]
        for c in coords:
            if not c.is_extreme():
                return False

        d0, d1 = verts[0].degrees(), verts[1].degrees()
        if (d0 >= self.max_edges and d1 > 0) or (d0 > 0 and d1 >= self.max_edges):
            return True

        if not is_containment:
            edges = []
            for i in range(2):
                coord = coords[i]
                dir = ED_ANTISENSE if coord.is_left_extreme() else ED_SENSE
                e = Edge(verts[1 - i], dir, comp, coord.copy())
                e.color = color
                edges.append(e)
            edges[0].twin = edges[1]
            edges[1].twin = edges[0]
            verts[0].add_edge(edges[0])
            verts[1].add_edge(edges[1])
        else:
            edges = []
            for i in range(2):
                coord = coords[i]
                e1 = Edge(verts[1 - i], ED_SENSE, comp, coord.copy())
                e2 = Edge(verts[1 - i], ED_ANTISENSE, comp, coord.copy())
                e1.color = color
                e2.color = color
                edges.append((e1, e2))
            edges[0][0].twin = edges[1][0]
            edges[1][0].twin = edges[0][0]
            edges[0][1].twin = edges[1][1]
            edges[1][1].twin = edges[0][1]
            verts[0].add_edge(edges[0][0])
            verts[1].add_edge(edges[1][0])
            verts[0].add_edge(edges[0][1])
            verts[1].add_edge(edges[1][1])
            verts[overlap.contained_idx()].contained = True
            self.graph.containment = True
        return True
