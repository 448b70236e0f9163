"""Data-parallel stage A over this process's local devices.

Counterpart of `siga_tpu/parallel/dist.py::data_mesh`: a chunk's reads are
split into contiguous shards, one for each entry of a device list; the
FM-index planes are replicated, one `DualScanner` for each distinct device
(a list that repeats a device shares that device's planes); each shard is
dispatched to its device in turn from one host thread (a dispatch only
enqueues, so the cards run at the same time); and the host collects the
shards and joins their views in list order into the views one device gives
for the whole chunk.  One process drives every local
card; the multi-process regime (a process per read slice, merged through
hit files) is `parallel/multihost.py`.
"""
from __future__ import annotations

from typing import Sequence

import numpy as np
import torch

from ..device import resolve_device


def data_devices() -> list:
    """cuda:0 .. cuda:k-1 for this process's k local cards; raises when
    there is no card."""
    count = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if count == 0:
        raise RuntimeError("data_devices: CUDA is not available")
    return [torch.device("cuda", k) for k in range(count)]


def command_devices(name: str) -> list:
    """The devices of `overlap --device NAME` and `rmdup --device NAME`:
    "cuda" is every local card (`data_devices()`), as the JAX package scans
    over every local device; "cuda:N" is that card and "cpu" the CPU.
    Raises when CUDA is asked for and absent."""
    device = resolve_device(name)
    if device.type == "cuda" and device.index is None:
        return data_devices()
    return [device]


def device_list(device) -> list:
    """One device or a sequence of them as a non-empty list of
    `torch.device`s ("cuda" without an index is the current card); a list
    that mixes device types raises."""
    if isinstance(device, (str, torch.device)):
        device = [device]
    devices = [torch.device(d) for d in device]
    if not devices:
        raise ValueError("no device given")
    kinds = sorted({d.type for d in devices})
    if len(kinds) > 1:
        raise ValueError(f"a device list mixes {' and '.join(kinds)}")
    return [
        torch.device("cuda", torch.cuda.current_device())
        if d.type == "cuda" and d.index is None else d
        for d in devices
    ]


def shard_bounds(n: int, d: int) -> list:
    """[start, end) of d contiguous shards of n reads, the first n % d of
    them one read longer (empty shards when n < d)."""
    base, extra = divmod(n, d)
    bounds, start = [], 0
    for k in range(d):
        end = start + base + (k < extra)
        bounds.append((start, end))
        start = end
    return bounds


def join_views(views: Sequence, sizes: Sequence[int], n_groups: int):
    """One direction's view of a chunk (`DualScanner.collect`) from the views
    of its shards, in shard order; shard k holds sizes[k] reads from s_k on,
    and the direction n_groups lane groups.  Shard k's lane g * n_k + j is
    lane g * n + s_k + j of the chunk (n reads); its emitted blocks,
    candidates and substring bits move with their lanes, and the blocks stay
    lane-major with t ascending, the candidates ascending."""
    n = int(sum(sizes))
    starts = np.cumsum([0, *sizes[:-1]])
    lanes, cands = [], []
    substr = np.zeros((n_groups, n), dtype=np.uint8)
    for (lane, _t, _data, cand_lanes, _rows, sub), nk, sk in zip(views, sizes, starts):
        lanes.append(lane // nk * n + sk + lane % nk)
        cands.append(cand_lanes // nk * n + sk + cand_lanes % nk)
        substr[:, sk : sk + nk] = sub.reshape(n_groups, nk)
    lane, cand_lanes = np.concatenate(lanes), np.concatenate(cands)
    # a shard's lanes ascend and no two shards share a lane, so a stable
    # sort by lane keeps each lane's blocks in t order
    order = np.argsort(lane, kind="stable")
    corder = np.argsort(cand_lanes, kind="stable")
    t, data, rows = (np.concatenate([v[k] for v in views]) for k in (1, 2, 4))
    return lane[order], t[order], data[order], cand_lanes[corder], rows[corder], substr.reshape(-1)


def dispatch(scanners: Sequence, seqs: Sequence[str], maxlen: int, min_overlap: int) -> list:
    """Enqueue the scan of one chunk of reads: with one scanner, its own
    dispatch; else the reads split by `shard_bounds` over the scanners (the
    entries of a device list, in order), each non-empty shard dispatched in
    turn from this thread (a dispatch waits on no card, so the cards scan
    at the same time).  Returns [(scanner, reads, handle)] for `collect`."""
    if len(scanners) == 1:
        sc = scanners[0]
        return [(sc, len(seqs), sc.dispatch(seqs, len(seqs), maxlen, min_overlap))]
    return [
        (sc, e - s, sc.dispatch(seqs[s:e], e - s, maxlen, min_overlap))
        for sc, (s, e) in zip(scanners, shard_bounds(len(seqs), len(scanners))) if e > s
    ]


def collect(shards: list):
    """The (f_view, r_view) of a chunk `dispatch` enqueued: each shard's
    views collected in order and joined by `join_views`."""
    if len(shards) == 1:
        sc, _n, handle = shards[0]
        return sc.collect(handle)
    views = [sc.collect(handle) for sc, _n, handle in shards]
    sizes = [n for _sc, n, _h in shards]
    first = shards[0][0]
    return (
        join_views([v[0] for v in views], sizes, len(first.fwd_groups)),
        join_views([v[1] for v in views], sizes, len(first.rev_groups)),
    )


def scan_views(scanners: Sequence, seqs: Sequence[str], maxlen: int, min_overlap: int):
    """The (f_view, r_view) of one chunk of reads: `collect(dispatch(...))`."""
    return collect(dispatch(scanners, seqs, maxlen, min_overlap))
