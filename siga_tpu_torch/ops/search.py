"""Batched overlap detection: device stage-A scan + native stage B/C.

Port of `siga_tpu/ops/search.py`.  Stage A (the backward search with
'$'-probes over every read in four orientations) runs as the scan of
`fm_device.DualScanner` (the pair scan K1, or the single-step scan K3 with
SIGA_PAIR_STEP=0) on one device, or on each entry of a device list with a
chunk's reads split over them (`parallel/dist.py`), LOOKAHEAD chunks
dispatched ahead of the one collected; stages B/C (submaximal filtering,
irreducible extraction) run in the shared C++ runtime, in
SIGA_NATIVE_WORKERS worker threads (default 1) drained oldest first, or in
the calling thread with SIGA_NATIVE_PIPELINE=0.  SIGA_CHUNK_READS (read at
import, default 16384) caps the reads of a chunk.
There is no Python stage B/C here: the runtime is required.  rmdup
(`batch_duplicate_hits`) needs only the scan's finals.
"""
from __future__ import annotations

import os
from collections import deque
from concurrent.futures import ThreadPoolExecutor
from typing import Iterator

import numpy as np

from .. import native
from ..index.fm import FMIndex, IntervalPair
from ..overlap.builder import (
    AF_SUFFIX_PREFIX,
    AF_SUFFIX_SUFFIX,
    Hit,
    OverlapBlock,
    OverlapBuilder,
    OverlapResult,
)

from ..device import native_lib
from ..parallel import dist
from .fm_device import (
    GROUP_COMP,
    GROUP_ID,
    GROUP_RC,
    GROUP_REV,
    DeviceFM,
    DualScanner,
    pair_step_default,
)

CHUNK_READS = int(os.environ.get("SIGA_CHUNK_READS", "16384"))
LOOKAHEAD = 8  # chunks dispatched ahead of the one collected


def _bucket_len(n_chars: int) -> int:
    """Packed read width: the longest read rounded up to the 16-symbol word."""
    return -(-n_chars // 16) * 16


def chunk_size(n_rec: int) -> int:
    """Engine chunking: at most CHUNK_READS reads a chunk and, above 2048
    reads, at least min(8, n_rec/1024) equal chunks, so the native stage
    B/C of one chunk overlaps the scan of the next."""
    chunk_reads = min(CHUNK_READS, max(64, n_rec))
    if n_rec > 2048:
        n_chunks = max(-(-n_rec // CHUNK_READS), min(8, -(-n_rec // 1024)))
        chunk_reads = -(-n_rec // n_chunks)
    return chunk_reads


def _final8_from_cands(
    num_lanes: int, cand_lanes: np.ndarray, cand_rows: np.ndarray
) -> np.ndarray:
    """Per-lane [flo,fhi,frlo,frhi, plo,phi,prlo,prhi] for the native chunk
    processor, filled from the scan's compacted containment candidates.
    Non-candidate lanes get invalid sentinel pairs (lo=0, hi=-1) so the
    native pair_valid check rejects them without occ work."""
    out = np.empty((num_lanes, 8), dtype=np.int64)
    out[:, 0::2] = 0
    out[:, 1::2] = -1
    if len(cand_lanes):
        flo, fhi, frlo, frhi, l0, u0 = cand_rows.T
        out[cand_lanes] = np.stack(
            [flo, fhi, frlo, frhi, l0, u0 - 1, frlo, frlo + (u0 - l0) - 1],
            axis=1,
        )
    return out


def batch_overlap_hits(
    builder: OverlapBuilder, records, min_overlap: int, device
) -> Iterator[Hit]:
    """Yield one Hit per read, in input order, with stage A on `device`: one
    device or a sequence of them (the reads of each chunk split over its
    entries, `parallel/dist.py`).

    Inputs of mixed lengths (contig re-overlap) run in length-sorted chunks
    so short chunks do not pay the longest read's scan depth; their results
    are buffered and re-emitted in input order."""
    lens = [len(r.seq) for r in records]
    lens_sorted = sorted(lens)
    median = lens_sorted[len(lens) // 2]
    if lens_sorted[-1] > 2 * max(median, 1) and len(records) > 1:
        order = sorted(range(len(records)), key=lambda i: lens[i])
        permuted = [records[i] for i in order]
        results = [None] * len(records)
        for pos, hit in zip(
            order, _batch_overlap_ordered(builder, permuted, min_overlap, device)
        ):
            hit.idx = pos
            results[pos] = hit
        yield from results
        return
    yield from _batch_overlap_ordered(builder, records, min_overlap, device)


def _batch_overlap_ordered(
    builder: OverlapBuilder, records, min_overlap: int, device
) -> Iterator[Hit]:
    if builder.rc:
        fwd_groups, rev_groups = (GROUP_ID, GROUP_RC), (GROUP_REV, GROUP_COMP)
    else:
        fwd_groups, rev_groups = (GROUP_ID,), (GROUP_REV,)
    scanners = _scanners(builder, device, fwd_groups, rev_groups)
    proc = _native_chunk_processor(builder)
    chunk_reads = chunk_size(len(records))

    def native_args(chunk, f_view, r_view):
        f_lane, f_t, f_data, f_cl, f_cr, f_sub = f_view
        r_lane, r_t, r_data, r_cl, r_cr, r_sub = r_view
        n = len(chunk)
        num_lanes = 2 * n if builder.rc else n
        lens_chunk = np.array([len(r.seq) for r in chunk], dtype=np.int64)
        f_starts = np.searchsorted(f_lane, np.arange(num_lanes + 1))
        r_starts = np.searchsorted(r_lane, np.arange(num_lanes + 1))
        return (
            lens_chunk, builder.rc, builder.irreducible, n,
            (f_starts, f_t, f_data, _final8_from_cands(num_lanes, f_cl, f_cr), f_sub),
            (r_starts, r_t, r_data, _final8_from_cands(num_lanes, r_cl, r_cr), r_sub),
        )

    def hits(start, result):
        outs, substr, _failed = result
        for k in range(len(outs)):
            yield _LazyHit(start + k, bool(substr[k]), outs[k])

    # Stage B/C runs in worker threads behind the collect loop: ctypes
    # releases the interpreter lock, so the next chunks' collects overlap
    # it.  The drain always waits on the oldest chunk, so the hits stay in
    # order whatever the number of workers; at most 1 + n_workers chunks
    # are pending.
    n_workers = int(os.environ.get("SIGA_NATIVE_WORKERS", "1"))
    pipeline = (len(records) > chunk_reads
                and os.environ.get("SIGA_NATIVE_PIPELINE", "1") != "0")
    executor = ThreadPoolExecutor(max_workers=n_workers) if pipeline else None
    pending = deque()  # (start, future), oldest first
    try:
        for start, chunk, f_view, r_view in _in_flight(scanners, records, chunk_reads, min_overlap):
            args = native_args(chunk, f_view, r_view)
            if executor is None:
                yield from hits(start, proc.run(*args))
                continue
            while len(pending) >= 1 + n_workers:
                s0, future = pending.popleft()
                yield from hits(s0, future.result())
            pending.append((start, executor.submit(proc.run, *args)))
        while pending:
            s0, future = pending.popleft()
            yield from hits(s0, future.result())
    finally:
        if executor is not None:
            executor.shutdown(wait=True)


def _in_flight(scanners, records, chunk_reads: int, min_overlap: int | None):
    """(start, chunk, f_view, r_view) of each chunk of `records`, in order,
    with LOOKAHEAD chunks dispatched ahead of the one collected, as the JAX
    package keeps them in flight.  min_overlap None scans each chunk with
    min_overlap above its longest read (only the finals)."""
    starts = iter(range(0, len(records), chunk_reads))

    def dispatch(start):
        chunk = records[start : start + chunk_reads]
        seqs = [r.seq for r in chunk]
        maxlen = _bucket_len(max(len(s) for s in seqs))
        mo = maxlen + 1 if min_overlap is None else min_overlap
        return start, chunk, dist.dispatch(scanners, seqs, maxlen, mo)

    inflight = deque(dispatch(start) for _, start in zip(range(LOOKAHEAD), starts))
    while inflight:
        start, chunk, shards = inflight.popleft()
        following = next(starts, None)
        if following is not None:
            inflight.append(dispatch(following))
        yield (start, chunk, *dist.collect(shards))


class _Containments:
    """Containment/substring classification from the scan's compacted
    candidates: substring flags (lext|rext) and probe-valid finals come from
    the scan; only the final updateR('$') counts need one host occ pair over
    the (few) candidates.  Port of `siga_tpu/ops/search.py::_Containments`."""

    def __init__(
        self,
        cand_lanes: np.ndarray,
        cand_rows: np.ndarray,
        substr_flags: np.ndarray,
        rindex: FMIndex,
    ):
        self.substring = substr_flags
        self.cand_lanes = cand_lanes
        self.rows = cand_rows
        if len(cand_lanes):
            frlo = cand_rows[:, 2]
            psize = cand_rows[:, 5] - cand_rows[:, 4]
            self.p_l = rindex.occ_all(frlo - 1)
            self.p_u = rindex.occ_all(frlo + psize - 1)

    def get(self, lane: int, seqlen: int, af: int, result: OverlapResult):
        if self.substring[lane]:
            result.substring = True
            return None
        i = int(np.searchsorted(self.cand_lanes, lane))
        if i >= len(self.cand_lanes) or self.cand_lanes[i] != lane:
            return None
        flo, fhi, frlo, frhi, l0, u0 = (int(v) for v in self.rows[i])
        raw = IntervalPair(flo, fhi, frlo, frhi)
        # closed-form '$' probe of the full-length interval, then
        # updateR('$') from the cached counts (pred['$'] == 0)
        probe = IntervalPair(l0, u0 - 1, frlo, frlo + (u0 - l0) - 1)
        if not probe.valid():
            raise AssertionError(f"lane {lane}: invalid '$' probe {probe}")
        diff0 = int(self.p_u[i, 0] - self.p_l[i, 0])
        probe.hi = probe.lo + diff0 - 1
        probe.rlo = int(self.p_l[i, 0])
        probe.rhi = int(self.p_u[i, 0]) - 1
        if not probe.valid():
            raise AssertionError(f"lane {lane}: invalid updated probe {probe}")
        return OverlapBlock(probe, raw, seqlen, af)


def batch_duplicate_hits(builder: OverlapBuilder, records, device) -> Iterator[Hit]:
    """rmdup's search, one Hit per read in input order: `duplicate()` is the
    containment-only search (min_overlap = read length), i.e. only the
    finals of the stage-A scan over lanes [seq] (forward index) and
    [complement(seq)] (reverse index), on `device` as `batch_overlap_hits`
    takes it, LOOKAHEAD chunks in flight.  Port of
    `siga_tpu/ops/search.py::batch_duplicate_hits`."""
    scanners = _scanners(builder, device, (GROUP_ID,), (GROUP_COMP,))
    chunk_reads = chunk_size(len(records))
    # min_overlap above every read: no overlap blocks, only the finals
    for start, chunk, f_view, r_view in _in_flight(scanners, records, chunk_reads, None):
        f_contain = _Containments(*f_view[3:], builder.rfmi)
        r_contain = _Containments(*r_view[3:], builder.fmi)
        for k, rec in enumerate(chunk):
            seqlen = len(rec.seq)
            result = OverlapResult()
            hit = Hit(idx=start + k)
            for contain, af in ((f_contain, AF_SUFFIX_PREFIX), (r_contain, AF_SUFFIX_SUFFIX)):
                block = contain.get(k, seqlen, af, result)
                if block is not None:
                    hit.blocks.append(block)
            hit.substring = result.substring
            yield hit


class _LazyHit(Hit):
    """Hit backed by a raw (n, 10) block array: the hits writer formats the
    array directly; `blocks` builds OverlapBlock objects on access."""

    def __init__(self, idx, substring, array):
        self.idx = idx
        self.substring = substring
        self._array = array
        self._blocks = None

    @property
    def blocks(self):
        if self._blocks is None:
            self._blocks = _array_to_blocks(self._array)
        return self._blocks


def _scanners(builder, device, fwd_groups, rev_groups) -> list:
    """A scanner for each entry of `device` (one device or a sequence)."""
    return [
        _cached_scanner(builder, d, fwd_groups, rev_groups) for d in dist.device_list(device)
    ]


def _cached_scanner(builder, device, fwd_groups, rev_groups, pair_step=None) -> DualScanner:
    """DualScanner cached on the builder, its planes shared by every lane-group
    layout and route on one device, so repeated engine passes build the
    planes once.  The route (`DualScanner`'s pair_step) defaults to
    SIGA_PAIR_STEP's."""
    (device,) = dist.device_list(device)  # "cuda" is the current card's index
    scanners = builder.__dict__.setdefault("_scanners", {})
    pair = pair_step_default() if pair_step is None else bool(pair_step)
    key = (str(device), fwd_groups, rev_groups, pair)
    if key not in scanners:
        planes = builder.__dict__.setdefault("_dfms", {})
        if str(device) not in planes:
            planes[str(device)] = (
                DeviceFM(builder.fmi, device), DeviceFM(builder.rfmi, device)
            )
        scanners[key] = DualScanner(*planes[str(device)], fwd_groups, rev_groups, pair)
    return scanners[key]


def _native_chunk_processor(builder):
    if getattr(builder, "_native_chunk", None) is None:
        native_lib()
        builder._native_chunk = native.NativeChunkProcessor(builder.fmi, builder.rfmi)
    return builder._native_chunk


def _blocks_to_array(blocks) -> np.ndarray:
    a = np.empty((len(blocks), 10), dtype=np.int64)
    for i, b in enumerate(blocks):
        c, r = b.capped, b.raw
        a[i] = (c.lo, c.hi, c.rlo, c.rhi, r.lo, r.hi, r.rlo, r.rhi, b.length, b.af)
    return a


def _array_to_blocks(a: np.ndarray):
    return [
        OverlapBlock(
            IntervalPair(v[0], v[1], v[2], v[3]),
            IntervalPair(v[4], v[5], v[6], v[7]),
            v[8],
            v[9],
        )
        for v in a.tolist()
    ]
