"""Bounded BFS over the bidirected graph (reference BigraphWalk,
reference src/bigraph_search.h/.cpp): per-node DistanceAttr
(signed distance, direction, comp) with direction flipping on EC_REVERSE,
`has_link` verification by direct string prefix comparison, and the attr
composition algebra."""
from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, List, Optional, Tuple

from ..core import dna
from .bigraph import EC_REVERSE, EC_SAME, ED_ANTISENSE, ED_COUNT, ED_SENSE, Edge, Vertex


@dataclass
class DistanceAttr:
    distance: int = 0
    dir: int = ED_SENSE
    comp: int = EC_SAME

    def twin(self) -> "DistanceAttr":
        o = DistanceAttr(self.distance, self.dir, self.comp)
        if self.comp == EC_SAME:
            o.dir = ED_COUNT - self.dir - 1
        return o


@dataclass
class Node:
    vertex: Vertex
    attr: DistanceAttr


def attr_link2(e1: DistanceAttr, e2: DistanceAttr) -> DistanceAttr:
    e = DistanceAttr()
    e.distance = e2.distance - e1.distance
    if e1.comp == EC_SAME:
        e.dir = e1.dir
    else:
        e.dir = ED_COUNT - e1.dir - 1
    t1, t2 = e1.twin(), e2.twin()
    e.comp = EC_SAME if t1.dir == t2.dir else EC_REVERSE
    return e


def attr_link1(e1: DistanceAttr) -> DistanceAttr:
    e0 = DistanceAttr(0, ED_ANTISENSE if e1.distance < 0 else ED_SENSE, EC_SAME)
    return attr_link2(e0, e1)


def diff_dir(e1: DistanceAttr, e2: DistanceAttr) -> bool:
    return (e1.distance < 0 or e2.distance < 0) and (
        e1.distance >= 0 or e2.distance >= 0
    )


def has_link(v1: Vertex, v2: Vertex, distance: int, dir: int, comp: int) -> bool:
    if distance < 0:
        if comp == EC_SAME:
            return has_link(v2, v1, -distance, ED_COUNT - dir - 1, comp)
        return has_link(v2, v1, -distance, dir, comp)
    seq1, seq2 = v1.seq, v2.seq
    if comp == EC_REVERSE:
        seq2 = dna.reverse_complement(seq2)
    return (
        dir == ED_SENSE and distance < len(seq1) and seq2.startswith(seq1[distance:])
    ) or (
        dir == ED_ANTISENSE
        and distance < len(seq2)
        and seq1.startswith(seq2[distance:])
    )


def has_link_attr(v1: Vertex, v2: Vertex, e: DistanceAttr) -> bool:
    return has_link(v1, v2, e.distance, e.dir, e.comp)


def has_link_pair(v1: Vertex, e1: DistanceAttr, v2: Vertex, e2: DistanceAttr) -> bool:
    assert not diff_dir(e1, e2)
    if abs(e1.distance) > abs(e2.distance):
        return has_link_pair(v2, e2, v1, e1)
    e = attr_link2(e1, e2)
    return has_link_attr(v1, v2, e)


def has_link_dist(v1: Vertex, v2: Vertex, distance: int) -> bool:
    assert distance >= 0
    if distance > 0:
        return (
            has_link(v1, v2, distance, ED_SENSE, EC_SAME)
            or has_link(v1, v2, distance, ED_SENSE, EC_REVERSE)
            or has_link(v1, v2, distance, ED_ANTISENSE, EC_SAME)
            or has_link(v1, v2, distance, ED_ANTISENSE, EC_REVERSE)
        )
    return False


def _edge_distance(edge: Edge) -> int:
    if edge.dir == ED_SENSE:
        coord = edge.coord
    else:
        coord = edge.twin.coord
    return coord.seqlen - coord.length()


def build(
    start: Vertex,
    edge_filter: Optional[Callable[[Edge], bool]],
    end: Optional[Vertex],
    min_distance: int,
    max_distance: int,
    max_nodes: int,
    leaves: List[Node],
) -> int:
    """BFS from start along consistent directions (src/bigraph_search.cpp)."""
    queue: List[Tuple[Node, int]] = []
    for edge in start.edges:
        flag = 1 if edge.dir == ED_SENSE else -1
        distance = _edge_distance(edge)
        if edge_filter is None or edge_filter(edge):
            queue.append(
                (Node(edge.end, DistanceAttr(flag * distance, edge.dir, edge.comp)), flag)
            )

    num = 0
    visited = set()
    qi = 0
    while qi < len(queue) and num < max_nodes and (len(queue) - qi) < 5 * max_distance:
        node, flag = queue[qi]
        qi += 1
        key = (node.vertex.id, node.attr.distance)
        if key in visited:
            continue
        visited.add(key)

        if abs(node.attr.distance) < max_distance:
            if abs(node.attr.distance) >= min_distance:
                if end is None:
                    if node.attr.distance != 0:
                        num += 1
                        leaves.append(node)
                elif end.id == node.vertex.id:
                    num += 1
                    leaves.append(node)
                    break

            dir = node.attr.dir
            if node.attr.comp == EC_REVERSE:
                dir = ED_COUNT - dir - 1
            for edge in node.vertex.edges:
                if edge.dir == dir:
                    distance = _edge_distance(edge)
                    distance = node.attr.distance + flag * distance
                    queue.append(
                        (Node(edge.end, DistanceAttr(distance, dir, edge.comp)), flag)
                    )
    return num
