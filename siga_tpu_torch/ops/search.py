"""Batched overlap detection: device stage-A scan + native stage B/C.

Port of `siga_tpu/ops/search.py` for one GPU.  Stage A (the backward search
with '$'-probes over every read in four orientations) runs as the pair scan
of `fm_device.py`; stages B/C (submaximal filtering, irreducible extraction)
run in the shared C++ runtime, one chunk behind the scan in a worker thread.
There is no Python stage B/C here: the runtime is required.
"""
from __future__ import annotations

from concurrent.futures import ThreadPoolExecutor
from typing import Iterator

import numpy as np

from siga_tpu import native
from siga_tpu.index.fm import IntervalPair
from siga_tpu.overlap.builder import Hit, OverlapBlock, OverlapBuilder

from ..device import native_lib
from .fm_device import (
    GROUP_COMP,
    GROUP_ID,
    GROUP_RC,
    GROUP_REV,
    DeviceFM,
    DualScanner,
)

CHUNK_READS = 16384


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
    """Yield one Hit per read, in input order.

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
    scanner = _cached_scanner(builder, device, fwd_groups, rev_groups)
    proc = _native_chunk_processor(builder)
    chunk_reads = chunk_size(len(records))

    def scan(start):
        chunk = records[start : start + chunk_reads]
        seqs = [r.seq for r in chunk]
        maxlen = _bucket_len(max(len(s) for s in seqs))
        f_view, r_view = scanner.collect(
            scanner.dispatch(seqs, len(chunk), maxlen, min_overlap)
        )
        return native_args(chunk, f_view, r_view)

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

    def hits(start, future):
        outs, substr, _failed = future.result()
        for k in range(len(outs)):
            yield _LazyHit(start + k, bool(substr[k]), outs[k])

    # Stage B/C runs in one worker thread one chunk behind the scan: ctypes
    # releases the interpreter lock, so the next chunk's scan overlaps it,
    # and one worker keeps the chunk results in order.
    with ThreadPoolExecutor(max_workers=1) as executor:
        pending = None
        for start in range(0, len(records), chunk_reads):
            future = executor.submit(proc.run, *scan(start))
            if pending is not None:
                yield from hits(*pending)
            pending = (start, future)
        if pending is not None:
            yield from hits(*pending)


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


def _cached_scanner(builder, device, fwd_groups, rev_groups) -> DualScanner:
    """DualScanner cached on the builder, its planes shared by every lane-group
    layout on one device, so repeated engine passes build the planes once."""
    scanners = builder.__dict__.setdefault("_scanners", {})
    key = (str(device), fwd_groups, rev_groups)
    if key not in scanners:
        planes = builder.__dict__.setdefault("_dfms", {})
        if str(device) not in planes:
            planes[str(device)] = (
                DeviceFM(builder.fmi, device), DeviceFM(builder.rfmi, device)
            )
        scanners[key] = DualScanner(*planes[str(device)], fwd_groups, rev_groups)
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
