"""Graph cleaning passes (reference bigraph_visitors,
reference src/bigraph_visitors.h/.cpp).

Implemented: EdgeColor, Chimeric, ContainRemove, Fasta, IdenticalRemove,
LoopRemove, MaximumOverlap, InsertSizeEstimate, PairedRead, LinkedRead,
Statistics, Trim; Smoothing and TransitiveReduction remain stubs exactly like
the reference (src/bigraph_visitors.cpp:1023-1036, 1084-1093).
"""
from __future__ import annotations

import math
from typing import Callable, Dict, List, Optional, Tuple

from ..core.coord import Overlap, SeqCoord
from ..io import asqg, fastx
from . import search
from .bigraph import (
    EC_REVERSE,
    EC_SAME,
    ED_ANTISENSE,
    ED_COUNT,
    ED_SENSE,
    GC_BLACK,
    GC_GRAY,
    GC_GREEN,
    GC_NONE,
    GC_RED,
    GC_WHITE,
    Bigraph,
    Edge,
    EdgeCreator,
    Vertex,
)


def repeatness(vertex: Vertex, n: int, g: int) -> float:
    delta = float(len(vertex.seq))
    k = float(vertex.coverage)
    # C++ double semantics: x/0.0 is +-inf (nan for 0/0), no exception
    if g == 0:
        ratio = math.inf if delta * n > 0 else (math.nan if delta * n == 0 else -math.inf)
    else:
        ratio = delta * n / g
    return ratio - k * math.log(2.0)


def point_avg(c: int, l: int) -> float:
    return float(max(c, 1) - 1) / max(l, 1)


def vertex_avg(vertex: Vertex) -> float:
    return point_avg(vertex.coverage, len(vertex.seq))


class BigraphVisitor:
    def previsit(self, graph: Bigraph) -> None:
        pass

    def visit(self, graph: Bigraph, vertex: Vertex) -> bool:
        return False

    def postvisit(self, graph: Bigraph) -> None:
        pass


class EdgeColorVisitor(BigraphVisitor):
    def __init__(
        self,
        color: int,
        edge_filter: Optional[Callable[[Vertex, Edge], bool]] = None,
        twin: bool = False,
    ):
        self.color = color
        self.filter = edge_filter
        self.twin = twin

    def visit(self, graph, vertex):
        modified = False
        for edge in vertex.edges:
            if self.filter is None or self.filter(vertex, edge):
                edge.color = self.color
                if self.twin:
                    edge.twin.color = self.color
                modified = True
        return modified


class StatisticsVisitor(BigraphVisitor):
    def previsit(self, graph):
        self.terminal = self.island = self.monobranch = 0
        self.dibranch = self.simple = self.edges = self.vertices = 0

    def visit(self, graph, vertex):
        f = vertex.degrees(ED_SENSE)
        r = vertex.degrees(ED_ANTISENSE)
        if f == 0 and r == 0:
            self.island += 1
        elif f == 0 or r == 0:
            self.terminal += 1
        if f > 1 and r > 1:
            self.dibranch += 1
        elif f > 1 or r > 1:
            self.monobranch += 1
        if f == 1 or r == 1:
            self.simple += 1
        self.edges += f + r
        self.vertices += 1
        return False

    def postvisit(self, graph):
        import sys

        print(
            f"[StatisticsVisitor] Vertices: {self.vertices} Edges: {self.edges} "
            f"Islands: {self.island} Tips: {self.terminal} "
            f"Monobranch: {self.monobranch} Dibranch: {self.dibranch} "
            f"Simple: {self.simple}",
            file=sys.stderr,
        )


class TrimVisitor(BigraphVisitor):
    """Remove short islands and dead-end tips with low coverage-per-base
    (src/bigraph_visitors.cpp:1119-1161)."""

    def __init__(self, min_length: int = 150, min_coverage: int = -1):
        self.min_length = min_length
        self.min_coverage = min_coverage if min_coverage >= 0 else (1 << 62)

    def previsit(self, graph):
        self.island = 0
        self.terminal = 0
        graph.color(GC_WHITE)

    def visit(self, graph, vertex):
        modified = False
        seq = vertex.seq
        threshold = point_avg(self.min_coverage, self.min_length)
        if vertex.degrees() == 0:
            if len(seq) <= self.min_length and vertex_avg(vertex) <= threshold:
                vertex.color = GC_BLACK
                self.island += 1
                modified = True
        else:
            for dir in (ED_SENSE, ED_ANTISENSE):
                if (
                    vertex.degrees(dir) == 0
                    and len(seq) <= self.min_length
                    and vertex_avg(vertex) <= threshold
                ):
                    vertex.color = GC_BLACK
                    self.terminal += 1
                    modified = True
                    break
        return modified

    def postvisit(self, graph):
        graph.sweep_vertices(GC_BLACK)


class ContainRemoveVisitor(BigraphVisitor):
    def previsit(self, graph):
        graph.color(GC_WHITE)
        graph.containment = False
        self.contained = 0

    def visit(self, graph, vertex):
        if vertex.contained:
            for edge in list(vertex.edges):
                edge.color = GC_NONE
                end = edge.end
                if edge.twin in end.edges:
                    end.remove_edge(edge.twin)
                vertex.remove_edge(edge)
            vertex.color = GC_BLACK
            self.contained += 1
            return True
        return False

    def postvisit(self, graph):
        graph.sweep_vertices(GC_BLACK)


class IdenticalRemoveVisitor(BigraphVisitor):
    def previsit(self, graph):
        graph.color(GC_WHITE)
        self.count = 0

    def visit(self, graph, vertex):
        if vertex.contained:
            for edge in vertex.edges:
                other = edge.end
                if len(vertex.seq) != len(other.seq):
                    continue
                ovr = Overlap(edge.start().id, edge.end.id, edge.match())
                if not ovr.is_containment() or ovr.contained_idx() != 0:
                    continue
                if vertex.seq == other.seq:
                    vertex.color = GC_BLACK
                    self.count += 1
                    break
        return False

    def postvisit(self, graph):
        graph.sweep_vertices(GC_BLACK)


class FastaVisitor(BigraphVisitor):
    def __init__(self, stream):
        self.stream = stream

    def visit(self, graph, vertex):
        rec = fastx.DNASeq(name=vertex.id, seq=vertex.seq)
        comment = []
        if vertex.coverage > 1:
            comment.append(f"{asqg.COVERAGE_TAG}:i:{vertex.coverage}")
        index = vertex.index_str()
        if index:
            comment.append(f"{asqg.BARCODE_TAG}:Z:{index}")
        ext = vertex.ext_str()
        if ext:
            comment.append(f"{asqg.EXTENSION_TAG}:Z:{ext}")
        rec.comment = " ".join(comment)
        self.stream.write(rec.format())
        return False


class LoopRemoveVisitor(BigraphVisitor):
    """Unroll R2->R4->R2 loops by double merge
    (src/bigraph_visitors.cpp:318-405)."""

    def previsit(self, graph):
        self.loops: List[Vertex] = []

    def visit(self, graph, vertex):
        if vertex.degrees(ED_SENSE) == 1 and vertex.degrees(ED_ANTISENSE) == 1:
            prev_edge = vertex.edges_dir(ED_ANTISENSE)[0]
            next_edge = vertex.edges_dir(ED_SENSE)[0]
            if (
                not prev_edge.is_self()
                and not next_edge.is_self()
                and prev_edge.end is next_edge.end
            ):
                self.loops.append(vertex)
                return True
        return False

    def postvisit(self, graph):
        for vertex in self.loops:
            assert vertex.degrees(ED_SENSE) == 1 and vertex.degrees(ED_ANTISENSE) == 1
            prev_edge = vertex.edges_dir(ED_ANTISENSE)[0]
            next_edge = vertex.edges_dir(ED_SENSE)[0]
            prev_vert = prev_edge.end
            next_vert = next_edge.end
            assert prev_vert is next_vert

            next_twin = next_edge.twin
            vertex.merge(next_edge)
            vertex.remove_edge(next_edge)
            next_vert.remove_edge(next_twin)

            prev_twin = prev_edge.twin
            label = prev_twin.label()
            prepend = prev_twin.dir == ED_ANTISENSE
            prev_vert.merge(prev_twin)
            for trans in prev_vert.edges_dir(ED_COUNT - prev_edge.dir - 1):
                if trans is not prev_twin and not prepend:
                    trans.coord.offset(len(label))
            prev_vert.remove_edge(prev_twin)
            vertex.remove_edge(prev_edge)
            graph.remove_vertex(vertex)


def _warn_repeat_score_defaults(who: str, n: int, g: int) -> None:
    """Surface the reference's hardcoded repeat-score constants: when -n/-g
    are unset, MaximumOverlap/Chimeric score repeats with n=1751447 reads
    over a g=59128983bp genome (E. coli-ish magic numbers baked into
    src/bigraph_visitors.cpp:441-450, :107) — silently wrong for other
    genomes.  Warned once per process per visitor."""
    if n > 0 and g > 0:
        return
    key = f"_warned_{who}"
    if getattr(_warn_repeat_score_defaults, key, False):
        return
    setattr(_warn_repeat_score_defaults, key, True)
    from ..core.logconf import get_logger

    get_logger(who).warning(
        "repeat-score constants not set (-n reads / -g genome size): "
        "falling back to the reference's hardcoded n=1751447, g=59128983 "
        "(src/bigraph_visitors.cpp:441-450); set them for your genome"
    )


class MaximumOverlapVisitor(BigraphVisitor):
    """Yu Lin's maximum-overlap-graph reduction
    (src/bigraph_visitors.cpp:410-512)."""

    def __init__(
        self,
        delta: int = 0,
        carefully: bool = False,
        n: int = 0,
        g: int = 0,
        t: float = 13.0,
    ):
        self.delta = delta
        self.carefully = carefully
        self.n = n
        self.g = g
        self.t = t

    def previsit(self, graph):
        # The reference asserts !containment here
        # (src/bigraph_visitors.cpp:412) but ships release (NDEBUG) builds
        # where the assert is compiled out, and its own example recipe
        # (examples/siga-ecoli-miseq.sh) reaches this visitor with
        # containment graphs.  Mirror the release behavior: warn, proceed.
        if graph.containment:
            from ..core.logconf import get_logger

            get_logger("MaximumOverlapVisitor").warning(
                "graph has containments (reference asserts in debug "
                "builds only); proceeding"
            )
        _warn_repeat_score_defaults("MaximumOverlapVisitor", self.n, self.g)
        graph.visit(EdgeColorVisitor(GC_WHITE, twin=True))
        self.dummys = 0

    def visit(self, graph, vertex):
        n = self.n if self.n > 0 else 1751447
        g = self.g if self.g > 0 else 59128983
        k = vertex.coverage
        delta = len(vertex.seq)
        score = (n - k) * (
            math.log(g - delta) - math.log(g - 2 * delta if g > 2 * delta else 0.001)
        ) - k * math.log(2.0)
        if score < self.t:
            return False

        modified = False
        for dir in (ED_SENSE, ED_ANTISENSE):
            fwdlist = sorted(
                vertex.edges_dir(dir), key=lambda e: -e.coord.length()
            )
            for j in range(1, len(fwdlist)):
                if fwdlist[j].color == GC_BLACK:
                    continue
                if fwdlist[0].coord.length() - fwdlist[j].coord.length() < self.delta:
                    continue
                if self.carefully:
                    if not fwdlist[j].is_self():
                        # keep edges that are reciprocally maximal
                        twin_dir = fwdlist[j].twin.dir
                        revlist = [
                            e
                            for e in fwdlist[j].end.edges
                            if twin_dir != (e.dir + 1) % ED_COUNT
                        ]
                        assert revlist
                        revlist.sort(key=lambda e: -e.coord.length())
                        largest = revlist[0].end is vertex
                        for kk in range(1, len(revlist)):
                            if largest:
                                break
                            if (
                                revlist[0].coord.length() - revlist[kk].coord.length()
                                < self.delta
                            ):
                                largest = revlist[kk].end is vertex
                        if largest:
                            continue
                    elif fwdlist[0].is_self():
                        continue
                fwdlist[j].color = GC_BLACK
                fwdlist[j].twin.color = GC_BLACK
                self.dummys += 1
                modified = True
        return modified

    def postvisit(self, graph):
        graph.sweep_edges(GC_BLACK)


class ChimericVisitor(BigraphVisitor):
    """Remove short 1-in/1-out chimeric vertices
    (src/bigraph_visitors.cpp:83-198)."""

    def __init__(
        self,
        min_length: int = 0,
        min_coverage: int = -1,
        delta: int = -1,
        n: int = 0,
        g: int = 0,
        t: float = 0.0,
    ):
        self.min_length = min_length
        self.min_coverage = min_coverage if min_coverage >= 0 else (1 << 62)
        self.delta = delta if delta >= 0 else (1 << 62)
        self.n = n
        self.g = g
        self.t = t

    def previsit(self, graph):
        _warn_repeat_score_defaults("ChimericVisitor", self.n, self.g)
        self.chimeric = 0
        graph.color(GC_WHITE)

    def visit(self, graph, vertex):
        seq = vertex.seq
        if not (
            vertex.degrees(ED_SENSE) == 1
            and vertex.degrees(ED_ANTISENSE) == 1
            and len(seq) <= self.min_length
            and vertex_avg(vertex) <= point_avg(self.min_coverage, self.min_length)
        ):
            return False
        prev_edge = vertex.edges_dir(ED_ANTISENSE)[0]
        next_edge = vertex.edges_dir(ED_SENSE)[0]
        prev_vert = prev_edge.end
        next_vert = next_edge.end

        n = self.n if self.n > 0 else 1751447
        g = self.g if self.g > 0 else 59128983

        chimeric = prev_vert.degrees(ED_SENSE) >= 2
        if chimeric:
            chimeric &= next_vert.degrees(ED_ANTISENSE) >= 2

        if chimeric:

            def score_of(link_vert: Vertex) -> float:
                k = link_vert.coverage
                delta = len(link_vert.seq)
                return (n - k) * (
                    math.log(g - delta)
                    - math.log(g - 2 * delta if g > 2 * delta else 0.001)
                ) - k * math.log(2.0)

            def smallest_length(edges: List[Edge]) -> bool:
                for e in edges:
                    if e.end.id == vertex.id:
                        continue
                    if len(e.end.seq) <= len(seq) + self.delta:
                        return False
                return True

            def smallest_coverage(edges: List[Edge]) -> bool:
                for e in edges:
                    if e.end.id == vertex.id:
                        continue
                    if e.end.coverage <= vertex.coverage + 3:
                        return False
                return True

            def smallest_new(edges: List[Edge], edge: Edge) -> bool:
                if score_of(edge.end) < self.t:
                    return False
                return smallest_length(edges) or smallest_coverage(edges)

            chimeric &= smallest_new(
                prev_vert.edges_dir(ED_SENSE), prev_edge
            ) or smallest_new(next_vert.edges_dir(ED_ANTISENSE), next_edge)

        if chimeric:
            vertex.color = GC_BLACK
            self.chimeric += 1
            return True
        return False

    def postvisit(self, graph):
        graph.sweep_vertices(GC_BLACK)


class SmoothingVisitor(BigraphVisitor):
    """Bubble smoothing — stub, matching the reference
    (src/bigraph_visitors.cpp:1023-1036)."""

    def previsit(self, graph):
        graph.color(GC_WHITE)

    def postvisit(self, graph):
        graph.sweep_vertices(GC_RED)


class TransitiveReductionVisitor(BigraphVisitor):
    """Myers transitive reduction — stub like the reference; irreducible
    filtering is done FM-index-side in overlap
    (src/bigraph_visitors.cpp:1084-1093)."""


class LinkedReadVisitor(BigraphVisitor):
    """10x linked reads: drop edges whose endpoint barcode sets share <= 1
    fragment (src/bigraph_visitors.cpp:975-1018)."""

    def __init__(self, min_length: int = 0, min_coverage: int = 0):
        self.min_length = min_length
        self.min_coverage = min_coverage

    def previsit(self, graph):
        graph.visit(EdgeColorVisitor(GC_WHITE))
        self.dummys = 0

    def visit(self, graph, vertex):
        if len(vertex.seq) < self.min_length or vertex.coverage < self.min_coverage:
            return False
        barcodes1 = {b for b, _c in vertex.index_tbl}
        for edge in vertex.edges:
            fragment = sum(
                1 for b, _c in edge.end.index_tbl if b in barcodes1
            )
            if fragment <= 1:
                edge.color = GC_BLACK
                edge.twin.color = GC_BLACK
                self.dummys += 1
        return False

    def postvisit(self, graph):
        graph.sweep_edges(GC_BLACK)


class InsertSizeEstimateVisitor(BigraphVisitor):
    """Walk unbranched chains tracking signed distances; sample per-pair
    |pos1-pos2| (src/bigraph_visitors.cpp:517-663)."""

    def __init__(self):
        self.average = 0
        self.delta = 0

    def previsit(self, graph):
        graph.color(GC_GREEN)
        self.samples: List[int] = []

    @staticmethod
    def _reduced_edges(vertex: Vertex, dir: int) -> List[Edge]:
        edges = sorted(vertex.edges_dir(dir), key=lambda e: -e.coord.length())
        edges = [
            e
            for e in edges
            if not e.coord.is_contained() or not e.coord.is_extreme()
        ]
        out: List[Edge] = []
        for e in edges:
            if out and (
                e.coord.length() == out[-1].coord.length()
                and e.label() == out[-1].label()
            ):
                continue
            out.append(e)
        return out

    def visit(self, graph, vertex):
        if vertex.color != GC_GREEN:
            return False
        distancelist: Dict[str, int] = {vertex.id: 0}
        vertex.color = GC_RED

        for search_dir0 in (ED_SENSE, ED_ANTISENSE):
            search_dir = search_dir0
            distance = 0
            flag = 1 if search_dir == ED_SENSE else -1
            p = vertex
            while True:
                straight = self._reduced_edges(p, search_dir)
                if (
                    len(straight) != 1
                    or straight[0].is_self()
                    or straight[0].end.color == GC_RED
                ):
                    break
                single = straight[0]
                twin = single.twin
                end = single.end
                opposite = self._reduced_edges(end, twin.dir)
                if len(opposite) != 1:
                    break
                p = end
                if search_dir == ED_SENSE:
                    coord = single.coord
                else:
                    coord = twin.coord
                distance += flag * (coord.seqlen - coord.length())
                if single.comp == EC_REVERSE:
                    search_dir = ED_COUNT - search_dir - 1
                distancelist[p.id] = distance
                p.color = GC_RED

        for vid, d in distancelist.items():
            pair_id = fastx.pairend_id(vid)
            if vid < pair_id:
                if pair_id in distancelist:
                    self.samples.append(abs(distancelist[pair_id] - d))
        return False

    def postvisit(self, graph):
        if self.samples:
            mean = sum(self.samples) / len(self.samples)
            self.average = int(mean)
            var = sum(s * s for s in self.samples) / len(self.samples) - mean * mean
            self.delta = math.sqrt(max(var, 0.0))
        graph.color(GC_GREEN)


class PairedReadVisitor(BigraphVisitor):
    """pe-mode=1 core: confirm edges using read-pair consistency
    (src/bigraph_visitors.cpp:669-969)."""

    def __init__(
        self,
        max_distance: int = 100,
        insert_size: int = 500,
        insert_delta: int = 100,
        max_nodes: int = 100,
    ):
        self.max_distance = max_distance
        self.insert_size = insert_size
        self.insert_delta = insert_delta
        self.max_nodes = max_nodes

    def previsit(self, graph):
        self._vertices: List[Vertex] = []

    def visit(self, graph, vertex):
        # the reference asserts the mate exists (and would crash in a release
        # build); skipping unpaired vertices is strictly more robust when
        # rmdup or trimming removed one mate
        paired = graph.get_vertex(fastx.pairend_id(vertex.id))
        if paired is None:
            return False
        self._vertices.append(vertex)
        return False

    def _process(self, graph: Bigraph, vertex1: Vertex) -> List[search.Node]:
        linklist: List[search.Node] = []
        paired_v1 = graph.get_vertex(fastx.pairend_id(vertex1.id))
        if paired_v1 is None:
            return linklist

        adjacents: List[search.Node] = []
        if len(vertex1.seq) > self.max_distance:

            def edge_filter(edge: Edge) -> bool:
                if edge.dir == ED_SENSE or edge.comp == EC_REVERSE:
                    e = edge if edge.dir == ED_SENSE else edge.twin
                    return e.coord.seqlen > e.coord.length()
                return False

            search.build(
                vertex1,
                edge_filter,
                None,
                0,
                self.max_distance,
                self.max_nodes,
                adjacents,
            )
        adjacents.sort(key=lambda n: abs(n.attr.distance))

        for node1 in adjacents:
            paired_v2 = graph.get_vertex(fastx.pairend_id(node1.vertex.id))
            if paired_v2 is None:
                continue
            faraways: List[search.Node] = []
            for dir in (ED_SENSE, ED_ANTISENSE):
                if faraways:
                    break
                search.build(
                    paired_v1,
                    lambda e, d=dir: e.dir == d,
                    paired_v2,
                    0,
                    abs(node1.attr.distance) + self.insert_delta * 4,
                    1,
                    faraways,
                )
            for _node2 in faraways:
                linklist.append(node1)
        return linklist

    def postvisit(self, graph):
        import os

        if os.environ.get("SIGA_PAIRED_NATIVE", "1") != "0":
            from .. import native as native_mod

            if native_mod.available():
                self._postvisit_native(graph)
                return
        self._postvisit_python(graph)

    def _postvisit_native(self, graph):
        """Native (C++) BFS + link table + confirmation (native/paired.cpp),
        then the same edge creation / blacken / sweep as the Python path.
        The Python implementation below is the differential oracle; both
        produce identical create-edge sequences (tests/test_paired_native)."""
        import numpy as np

        from .. import native as native_mod

        ids = list(graph.vertices.keys())
        index = {vid: i for i, vid in enumerate(ids)}
        nv = len(ids)
        seqs = [graph.vertices[vid].seq for vid in ids]
        seq_off = np.zeros(nv + 1, dtype=np.int64)
        for i, s in enumerate(seqs):
            seq_off[i + 1] = seq_off[i] + len(s)
        seq_bytes = np.frombuffer("".join(seqs).encode(), dtype=np.uint8)
        mate = np.full(nv, -1, dtype=np.int32)
        for i, vid in enumerate(ids):
            m = index.get(fastx.pairend_id(vid))
            if m is not None:
                mate[i] = m
        eptr = np.zeros(nv + 1, dtype=np.int64)
        e_end: List[int] = []
        e_dir: List[int] = []
        e_comp: List[int] = []
        e_dist: List[int] = []
        e_ext: List[int] = []
        for i, vid in enumerate(ids):
            v = graph.vertices[vid]
            for edge in v.edges:
                e_end.append(index[edge.end.id])
                e_dir.append(edge.dir)
                e_comp.append(edge.comp)
                coord = edge.coord if edge.dir == ED_SENSE else edge.twin.coord
                e_dist.append(coord.seqlen - coord.length())
                if edge.dir == ED_SENSE or edge.comp == EC_REVERSE:
                    e = edge if edge.dir == ED_SENSE else edge.twin
                    e_ext.append(1 if e.coord.seqlen > e.coord.length() else 0)
                else:
                    e_ext.append(0)
            eptr[i + 1] = len(e_end)
        order = np.fromiter(
            (index[v.id] for v in self._vertices), dtype=np.int32,
            count=len(self._vertices),
        )
        rows = native_mod.paired_links(
            seq_bytes, seq_off, eptr,
            np.asarray(e_end, dtype=np.int32),
            np.asarray(e_dir, dtype=np.uint8),
            np.asarray(e_comp, dtype=np.uint8),
            np.asarray(e_dist, dtype=np.int32),
            np.asarray(e_ext, dtype=np.uint8),
            mate, order,
            self.max_distance, self.max_nodes, self.insert_delta,
        )
        graph.visit(EdgeColorVisitor(GC_GRAY))
        for v1, v2, d, dir_, comp in rows.tolist():
            self._create_edge(
                graph, ids[v1], ids[v2],
                search.DistanceAttr(d, dir_, comp), GC_WHITE,
            )
        self._blacken_and_sweep(graph)

    def _postvisit_python(self, graph):
        links: Dict[str, Dict[str, search.DistanceAttr]] = {}

        def add_link(v1: str, v2: str, e: search.DistanceAttr):
            if e.distance < 0:
                t = e.twin()
                t.distance = -t.distance
                add_link(v2, v1, t)
                return
            tbl = links.setdefault(v1, {})
            old = tbl.get(v2)
            if old is None or old.distance > e.distance:
                tbl[v2] = e

        for vertex1 in self._vertices:
            linklist = self._process(graph, vertex1)
            linklist.sort(key=lambda n: abs(n.attr.distance))
            for i, xi in enumerate(linklist):
                add_link(vertex1.id, xi.vertex.id, search.attr_link1(xi.attr))
                for j in range(i + 1, len(linklist)):
                    xj = linklist[j]
                    if (
                        search.diff_dir(xi.attr, xj.attr)
                        or xi.attr.distance == xj.attr.distance
                    ):
                        continue
                    e = search.attr_link2(xi.attr, xj.attr)
                    if search.has_link_attr(xi.vertex, xj.vertex, e):
                        add_link(xi.vertex.id, xj.vertex.id, e)

        graph.visit(EdgeColorVisitor(GC_GRAY))

        for v1, tbl in links.items():
            nodelist = sorted(tbl.items(), key=lambda kv: kv[1].distance)
            for j, (vid_j, attr_j) in enumerate(nodelist):
                confirmed = False
                for k in range(j):
                    vid_k, attr_k = nodelist[k]
                    if attr_k.dir == attr_j.dir and search.has_link_pair(
                        graph.get_vertex(vid_k),
                        attr_k,
                        graph.get_vertex(vid_j),
                        attr_j,
                    ):
                        confirmed = True
                        break
                if not confirmed:
                    self._create_edge(graph, v1, vid_j, attr_j, GC_WHITE)

        self._blacken_and_sweep(graph)

    def _blacken_and_sweep(self, graph):
        # blacken non-confirmed edges in directions that have confirmed ones
        class PairedEdgeFilter:
            def __init__(self, color):
                self.color = color
                self.vertex = None
                self.has_color = [False, False]

            def __call__(self, vertex, edge):
                if vertex is not self.vertex:
                    self.vertex = vertex
                    self.has_color = [False, False]
                    for e in vertex.edges:
                        if e.color == self.color:
                            self.has_color[e.dir] = True
                return (
                    self.has_color[edge.dir] and edge.color != self.color
                ) or edge.coord.is_full()

        graph.visit(EdgeColorVisitor(GC_BLACK, PairedEdgeFilter(GC_WHITE), twin=True))
        graph.sweep_edges(GC_BLACK)

    def _create_edge(
        self, graph: Bigraph, v1: str, v2: str, attr: search.DistanceAttr, color: int
    ):
        """PairedEdgeCreator::create (src/bigraph_visitors.cpp:815-859)."""
        assert attr.distance > 0
        verts = [graph.get_vertex(v1), graph.get_vertex(v2)]
        for edge in verts[0].edges:
            if edge.dir == attr.dir and edge.end is verts[1]:
                if (
                    edge.comp == attr.comp
                    and edge.coord.complement().length() == attr.distance
                ):
                    edge.color = color
                    edge.twin.color = color
                    return
        seq1, seq2 = verts[0].seq, verts[1].seq
        if attr.dir == ED_ANTISENSE:
            coord = [
                SeqCoord(0, len(seq2) - attr.distance - 1, len(seq1)),
                SeqCoord(attr.distance, len(seq2) - 1, len(seq2)),
            ]
        else:
            coord = [
                SeqCoord(attr.distance, len(seq1) - 1, len(seq1)),
                SeqCoord(0, len(seq1) - attr.distance - 1, len(seq2)),
            ]
        if attr.comp == EC_REVERSE:
            coord[1].flip()
        creator = EdgeCreator(graph, True, -1)
        ovr = Overlap.make(v1, coord[0], v2, coord[1], attr.comp == EC_REVERSE, 0)
        creator.create(ovr, color)


def _edge_features(vertex: Vertex, edge: Edge, orank: int, n: int, g: int):
    """The AIVisitor 46-feature vector (src/bigraph_visitors.cpp:1366-1413)."""
    from . import hifi

    end = edge.end
    j = k = 0
    for e in end.edges_dir(ED_ANTISENSE):
        if e is not edge.twin:
            if e.coord.length() >= edge.coord.length():
                j += 1
            if len(e.start().seq) >= len(vertex.seq):
                k += 1
    v2x = hifi.parse_dir(vertex, ED_ANTISENSE)
    x2y = hifi.parse_pair(vertex.index_tbl, end.index_tbl)
    y2w = hifi.parse_dir(end, ED_SENSE)

    def block(c):
        return [
            float(c[hifi.K_LINK_ALL_X]),
            float(c[hifi.K_LINK_ALL_Y]),
            float(c[hifi.K_LINK_COMMON_X]),
            float(c[hifi.K_LINK_COMMON_Y]),
            float(c[hifi.K_LINK_MIN]),
            float(c[hifi.K_LINK_MAX]),
            float(c[hifi.K_LINK_MID]),
            hifi.linkr(c[hifi.K_LINK_MIN], c[hifi.K_LINK_COMMON_X], c[hifi.K_LINK_COMMON_Y]),
            hifi.linkr(c[hifi.K_LINK_MAX], c[hifi.K_LINK_COMMON_X], c[hifi.K_LINK_COMMON_Y]),
            hifi.linkr(c[hifi.K_LINK_MID], c[hifi.K_LINK_COMMON_X], c[hifi.K_LINK_COMMON_Y]),
        ]

    return (
        [
            float(len(vertex.seq)),
            float(vertex.coverage),
            repeatness(vertex, n, g),
            float(vertex.degrees(ED_ANTISENSE)),
            float(vertex.degrees(ED_SENSE)),
            float(orank),
            float(len(end.seq)),
            float(end.coverage),
            repeatness(end, n, g),
            float(end.degrees(ED_ANTISENSE)),
            float(end.degrees(ED_SENSE)),
            float(j),
        ]
        + block(v2x)
        + block(x2y)
        + block(y2w)
        + [
            float(k),
            float(edge.coord.length()),
            vertex_avg(vertex),
            vertex_avg(end),
        ]
    )


class AIVisitor(BigraphVisitor):
    """ML edge classifier (reference AIVisitor, HAVE_MLPACK build,
    src/bigraph_visitors.cpp:1328-1438): per SENSE edge, build the 46-feature
    vector and ask a bagged model for votes — 0 votes removes the edge,
    a majority keeps it white."""

    def __init__(self, model, n: int = 0, g: int = 0):
        self.model = model  # ml.model.BaggingModel-like: classify(vec), size
        self.n = n
        self.g = g

    def previsit(self, graph):
        graph.visit(EdgeColorVisitor(GC_GRAY, twin=True))
        self.blacks = self.whites = self.grays = 0

    def visit(self, graph, vertex):
        modified = False
        edges = sorted(vertex.edges_dir(ED_SENSE), key=lambda e: -e.coord.length())
        for i, edge in enumerate(edges):
            vec = _edge_features(vertex, edge, i, self.n, self.g)
            votes = self.model.classify(vec)
            if votes < 1:
                self.blacks += 1
                edge.color = GC_BLACK
                edge.twin.color = GC_BLACK
                modified = True
            elif votes > self.model.size // 2:
                self.whites += 1
                edge.color = GC_WHITE
                edge.twin.color = GC_WHITE
            else:
                self.grays += 1
        return modified

    def postvisit(self, graph):
        graph.sweep_edges(GC_BLACK)


class UnitigVisitor(BigraphVisitor):
    """Duplicate a repeat vertex so a unique neighbor can merge through it
    (src/bigraph_visitors.cpp:1443-1512)."""

    def __init__(self, n: int = 0, g: int = 0, t: float = 0.0):
        self.n = n
        self.g = g
        self.t = t

    def previsit(self, graph):
        self.unitigs = 0

    def visit(self, graph, vertex):
        modified = False
        if repeatness(vertex, self.n, self.g) < self.t:
            return False
        for dir in (ED_SENSE, ED_ANTISENSE):
            edges = vertex.edges_dir(dir)
            if len(edges) == 1 and repeatness(
                edges[0].end, self.n, self.g
            ) < repeatness(vertex, self.n, self.g):
                end = edges[0].end
                if end.degrees(ED_SENSE) <= 1 and end.degrees(ED_ANTISENSE) <= 1:
                    continue
                tmp = Vertex(
                    end.id + "_copy",
                    end.seq,
                    end.contained,
                    end.index_str(),
                    end.coverage,
                    end.ext_str(),
                )
                for edge in end.edges_dir(dir):
                    e0 = Edge(edge.end, edge.dir, edge.comp, edge.coord.copy())
                    e1 = Edge(tmp, edge.twin.dir, edge.twin.comp, edge.twin.coord.copy())
                    e0.color = edge.color
                    e1.color = edge.twin.color
                    e0.twin = e1
                    e1.twin = e0
                    tmp.add_edge(e0)
                    edge.end.add_edge(e1)
                single = edges[0]
                v0 = Edge(tmp, single.dir, single.comp, single.coord.copy())
                v1 = Edge(vertex, single.twin.dir, single.twin.comp, single.twin.coord.copy())
                v0.color = single.color
                v1.color = single.twin.color
                v0.twin = v1
                v1.twin = v0
                vertex.add_edge(v0)
                tmp.add_edge(v1)

                vertex.remove_edge(single)
                end.remove_edge(single.twin)

                assert vertex.degrees(dir) == 1
                graph.merge(vertex, v0)
                self.unitigs += 1
                modified = True
        return modified


class GANVisitor(BigraphVisitor):
    """Emit labeled training rows for SENSE edges; true positives are found by
    a reference FM-index lookup of the merged sequence or by matched EX-tag
    alignments (src/bigraph_visitors.cpp:1517-1698)."""

    def __init__(self, stream, ref_index=None):
        self.stream = stream
        self.ref = ref_index

    def previsit(self, graph):
        graph.visit(EdgeColorVisitor(GC_GRAY, twin=True))
        self.blacks = self.whites = self.grays = 0

    @staticmethod
    def _parse_ext(text):
        out = []
        for item in text.split(","):
            if not item:
                continue
            vec = item.split("|")
            if len(vec) < 4:
                return None
            out.append((vec[0], vec[1], int(vec[2]), int(vec[3])))
        return out

    def visit(self, graph, vertex):
        import re

        from ..core import dna as dna_mod
        from . import hifi

        cigar_re = re.compile(r"^(\d*)=$")
        modified = False

        curr = self._parse_ext(vertex.ext_str())
        if curr is None:
            return False
        curr.sort(key=lambda a: (a[1], a[2]))

        edges = sorted(vertex.edges_dir(ED_SENSE), key=lambda e: -e.coord.length())
        i = 0
        for p, edge in enumerate(edges):
            end = edge.end
            if p > 0 and edge.coord.length() < edges[p - 1].coord.length():
                i += 1
            nxt = self._parse_ext(end.ext_str())
            if nxt is None:
                continue
            nxt.sort(key=lambda a: (a[1], a[2]))

            # match alignments offset by the merge geometry
            x, y = len(vertex.seq), edge.coord.length()
            pairs = []
            ii = jj = 0
            while ii < len(curr) and jj < len(nxt):
                a, b = curr[ii], nxt[jj]
                ka = (a[1], a[2] + x)
                kb = (b[1], b[2] + y)
                if ka < kb:
                    ii += 1
                elif kb < ka:
                    jj += 1
                else:
                    pairs.append((a, b))
                    ii += 1
                    jj += 1

            seq = vertex.seq + end.seq[edge.coord.length() :]
            label = 0
            if any(
                cigar_re.match(m[0][0]) and cigar_re.match(m[1][0]) for m in pairs
            ):
                label = 1
            elif self.ref is not None and self.ref.occurrences(seq) > 0:
                label = 1
            if label == 0:
                self.blacks += 1
                edge.color = GC_BLACK
                edge.twin.color = GC_BLACK
                modified = True
            else:
                self.whites += 1
                edge.color = GC_WHITE
                edge.twin.color = GC_WHITE

            v2x = hifi.parse_dir(vertex, ED_ANTISENSE)
            x2y = hifi.parse_pair(vertex.index_tbl, end.index_tbl)
            y2w = hifi.parse_dir(end, ED_SENSE)
            row = [
                label,
                vertex.id,
                end.id,
                len(vertex.seq),
                vertex.coverage,
                vertex.degrees(ED_ANTISENSE),
                vertex.degrees(ED_SENSE),
                i,
                len(end.seq),
                end.coverage,
                end.degrees(ED_ANTISENSE),
                end.degrees(ED_SENSE),
                int(edge.is_self()),
                edge.coord.length(),
            ] + v2x + x2y + y2w
            self.stream.write("\t".join(str(v) for v in row) + "\n")
        return modified

    def postvisit(self, graph):
        graph.sweep_edges(GC_BLACK)
