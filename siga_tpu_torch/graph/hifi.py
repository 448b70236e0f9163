"""Barcode-link feature counting for linked-read (10x/HiFi) data.

Mirrors the reference HiFiParser (src/bigraph_visitors.cpp:1240-1322):
merge-walk two sorted barcode multimaps counting all/common/min/mid/max link
categories.  The reference's inner loops advance the iterator before reading
the value (an out-of-bounds read at the end of a run); we implement the
intended semantics (read the current element), which only affects feature
values for ML visitors.
"""
from __future__ import annotations

from typing import List, Tuple

K_LINK_ALL_X = 0
K_LINK_ALL_Y = 1
K_LINK_COMMON_X = 2
K_LINK_COMMON_Y = 3
K_LINK_MIN = 4
K_LINK_MAX = 5
K_LINK_MID = 6
K_FIELDS = 7


def parse_pair(x_tbl: List[Tuple[str, int]], y_tbl: List[Tuple[str, int]]) -> List[int]:
    """Count link categories between two barcode tables."""
    x = sorted(x_tbl, key=lambda kv: kv[0])
    y = sorted(y_tbl, key=lambda kv: kv[0])
    cnt = [0] * K_FIELDS
    i = j = 0
    while i < len(x) and j < len(y):
        if x[i][0] < y[j][0]:
            i += 1
            cnt[K_LINK_ALL_X] += 1
        elif x[i][0] > y[j][0]:
            j += 1
            cnt[K_LINK_ALL_Y] += 1
        else:
            key = x[i][0]
            vmin = vmax = x[i][1]
            while i < len(x) and x[i][0] == key:
                vmin = min(vmin, x[i][1])
                vmax = max(vmax, x[i][1])
                i += 1
                cnt[K_LINK_ALL_X] += 1
                cnt[K_LINK_COMMON_X] += 1
            while j < len(y) and y[j][0] == key:
                v = y[j][1]
                j += 1
                cnt[K_LINK_ALL_Y] += 1
                cnt[K_LINK_COMMON_Y] += 1
                if v < vmin:
                    cnt[K_LINK_MIN] += 1
                elif vmax < v:
                    cnt[K_LINK_MAX] += 1
                else:
                    cnt[K_LINK_MID] += 1
    cnt[K_LINK_ALL_X] += len(x) - i
    cnt[K_LINK_ALL_Y] += len(y) - j
    return cnt


def parse_dir(vertex, direction: int) -> List[int]:
    """Best-linked edge counts in a direction
    (src/bigraph_visitors.cpp:1302-1313)."""

    def sequenced(cnt):
        return cnt[K_LINK_MIN] + cnt[K_LINK_MID] + cnt[K_LINK_MAX]

    cnt = [0] * K_FIELDS
    for edge in vertex.edges_dir(direction):
        tmp = parse_pair(vertex.index_tbl, edge.end.index_tbl)
        if sequenced(tmp) >= sequenced(cnt):
            cnt = tmp
    return cnt


def linkr(c: int, x: int, y: int) -> float:
    if x == 0 or y == 0:
        return 0.0
    return float(c) / min(x, y)
