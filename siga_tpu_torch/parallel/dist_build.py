"""Suffix sort of a rank text split over a device list: the index build for a
text whose sort state no single device holds.

Counterpart of `siga_tpu/parallel/dist_build.py` (`distributed_sa`,
`distributed_bwt_perm`, `distributed_index_arrays`), with `devices` in place
of `(mesh, axis)`: "cuda" is every local card, a list of devices of one type
is used as given (`[cpu] * D` on the CPU; a repeated entry puts several
segments on one card).  D must be a power of two, as the JAX package
asserts.  The suffix order is `index/sa.py::suffix_array_device`'s.

Segment k of the rank text lives on devices[k]: S characters, S the JAX
package's (ceil(n / D) rounded up to a multiple of 128), the text padded at
its end with suffixes that sort after every real one.
  1. Seed: each segment builds K6's seed keys (`sa.seed_keys`) from its own
     codes and the next 80 (copied from the host with the segment) and sorts
     them by (key_a, key_b, sentpos, position).
  2. A global sort is one PSRS exchange (parallel sorting by regular
     sampling) of segments already sorted: each gives D - 1 evenly spaced
     samples, the D (D - 1) samples sorted on devices[0] give D - 1
     splitters, each row's bucket comes from D - 1 lexicographic compares
     with them, bucket b of every segment is copied to devices[b], and the
     pieces, concatenated in source order, are sorted again, stably, so that
     ties keep their text order without a position key.  With regular
     sampling no bucket holds more than about 2 S rows.  The D x D piece
     sizes go to the host once an exchange.  The memory check counts every
     segment that shares a device.
  3. Run numbering: a row starts a run where it differs from the row before
     it, the first row of a bucket compared with the last row of the
     previous non-empty bucket; a bucket's ranks start at the exclusive
     prefix of the earlier buckets' run counts (D integers to the host).
  4. Back to text order: bucket b's ranks return to each source segment as
     the piece it sent, and the segment scatters them through its own sort
     permutation (no sort by position, as the JAX package's `unsort` is).
  5. Doubling rounds, as `suffix_array_device`'s: the key is (rank,
     rank[i + h] + 1), rank[i + h] read from the next segment's first h ranks
     (0 past the last segment; a suffix still tied with another has no '$'
     in its first h symbols, so it never reads a pad), globally sorted by
     step 2.
  6. The last sort carries the output: the position (the suffix array) or
     `(rid << 3) | codes[i - 1]` (the BWT symbol and the read id, so that the
     host only unpacks), and the host concatenates the buckets in order.
"""
from __future__ import annotations

from collections import Counter

import numpy as np
import torch

from ..device import resolve_device
from ..index.sa import (
    GRAM3,
    _check_fits,
    _max_span,
    _sa_rounds_v3,
    _sort_by,
    concat_reads,
    pack64,
    seed_keys,
)
from . import dist

__all__ = ["distributed_sa", "distributed_index_arrays", "distributed_bwt_perm"]

SEED_HALO = GRAM3 + 16  # codes of the next segment that a segment's seed keys read
_TILE = 128  # a segment is a multiple of this many characters, as in the JAX package
_PAD = 4  # the pads' code: any but '$' (their keys are set apart below)
_PAD_KEY = pack64(2**32 - 1, 2**32 - 1)  # a pad's key words: all ones
_PAD_SENTPOS = GRAM3 + 1  # after every real suffix's sentpos


def build_devices(devices) -> list:
    """The entries of a distributed build: "cuda" is every local card
    (`dist.data_devices`), else `dist.device_list(devices)`, each entry
    resolved (CUDA absent raises).  Their count must be a power of two."""
    if isinstance(devices, str) and devices == "cuda":
        devices = dist.data_devices()
    devices = [resolve_device(d) for d in dist.device_list(devices)]
    d = len(devices)
    if d & (d - 1):
        raise ValueError(f"{d} devices: the distributed build takes a power of two")
    return devices


def segment_length(n: int, d: int) -> int:
    """Characters of each of d segments of an n-character text: the JAX
    package's ceil(n / d) rounded up to a multiple of 128, at least 128."""
    return max(-(-(-(-n // d)) // _TILE) * _TILE, _TILE)


def segment_sizes(n: int, d: int) -> list:
    """The text's characters on each entry (the rest of a segment is pads)."""
    s = segment_length(n, d)
    return [min(s, max(0, n - k * s)) for k in range(d)]


def _segment_codes(codes: np.ndarray, k: int, s: int) -> np.ndarray:
    """codes[k s - 1 : (k + 1) s + SEED_HALO] with 0 before the text and pads
    after it, then one sentinel: the previous code, the segment, its halo."""
    lo, hi = k * s - 1, (k + 1) * s + SEED_HALO
    out = np.full(hi - lo + 1, _PAD, dtype=np.uint8)
    a, b = max(lo, 0), min(hi, codes.size)
    if b > a:
        out[a - lo : b - lo] = codes[a:b]
    if lo < 0:
        out[0] = 0
    out[-1] = 0  # more than 64 past the segment: caps no sentpos
    return out


def _to_host(tensors, stats) -> list:
    """The tensors' values as one list on the host: one synchronisation."""
    stats["host_syncs"] += 1
    dev = tensors[0].device
    return torch.stack([t.to(dev) for t in tensors]).cpu().tolist()


def _lex_gt(levels, split) -> torch.Tensor:
    """Rows of `levels` (int64 [m] each, most significant first) that are
    greater than the row `split` (0-d tensors)."""
    gt = levels[-1] > split[-1]
    for x, v in zip(levels[-2::-1], split[-2::-1]):
        gt = (x > v) | ((x == v) & gt)
    return gt


def _splitters(devices, levels) -> list:
    """D - 1 splitters (one [D - 1] tensor a level, on devices[0]) from D - 1
    evenly spaced samples of each sorted segment."""
    d = len(devices)
    samples = []
    for lv in levels:
        at = torch.arange(1, d, device=lv[0].device) * lv[0].numel() // d
        samples.append([x[at].to(devices[0]) for x in lv])
    cols = [torch.cat(col) for col in zip(*samples)]
    pick = _sort_by(cols[::-1])[torch.arange(1, d, device=devices[0]) * (d - 1)]
    return [c[pick] for c in cols]


def _exchange(devices, levels, carried, stats, phase) -> tuple:
    """One PSRS exchange.  levels[k]: segment k's sort levels (most
    significant first; its rows sorted by them, the last level unique);
    carried[k]: the tensors it sends, row-aligned with them.  Returns
    (buckets, sizes): buckets[b][i] is carried tensor i of every source's
    piece for bucket b, concatenated in source order on devices[b]; sizes[s][b]
    is the rows source s sent to bucket b."""
    d = len(devices)
    if d == 1:
        sizes = [[levels[0][0].numel()]]
    else:
        split = _splitters(devices, levels)
        below = []
        for dev, lv in zip(devices, levels):
            sp = [x.to(dev) for x in split]
            below.append(torch.stack([(~_lex_gt(lv, [x[j] for x in sp])).sum()
                                      for j in range(d - 1)]))
        sizes = [np.diff([0, *row, lv[0].numel()]).tolist()
                 for row, lv in zip(_to_host(below, stats), levels)]
    buckets, moved = [], 0
    for b, dev in enumerate(devices):
        pieces = []
        for s in range(d):
            lo = sum(sizes[s][:b])
            piece = [t[lo : lo + sizes[s][b]] for t in carried[s]]
            moved += sum(t.nbytes for t in piece) if s != b else 0
            pieces.append([t.to(dev) for t in piece])
        buckets.append([torch.cat(col) for col in zip(*pieces)])
    stats["phases"].append({"phase": phase, "moved_bytes": moved,
                            "buckets": [sum(col) for col in zip(*sizes)]})
    return buckets, sizes


def _number_runs(levels, stats, resolved=None) -> list:
    """Dense ranks of the rows of every bucket in bucket order: levels[b] is
    bucket b's sorted levels (int64 [m_b] each), a row starts a run where any
    level differs from the row before it (the last row of the previous
    non-empty bucket for a bucket's first), and with `resolved` (one bool
    [m_b] a bucket) where that is true."""
    starts, last = [], None
    for b, lv in enumerate(levels):
        m = lv[0].numel()
        new = torch.zeros(m, dtype=torch.bool, device=lv[0].device)
        if m:
            for x in lv:
                new[1:] |= x[1:] != x[:-1]
            if last is None:
                new[0] = True
            else:
                for x, p in zip(lv, last):
                    new[:1] |= x[:1] != p.to(x.device)
            last = [x[-1:] for x in lv]
            if resolved is not None:
                new |= resolved[b]
        starts.append(new)
    counts = _to_host([s.sum() for s in starts], stats)
    offsets = np.cumsum([0, *counts[:-1]]).tolist()
    return [torch.cumsum(s, 0) + (o - 1) for s, o in zip(starts, offsets)]


def _to_text_order(devices, ranks, orders, sizes, perms, s_len, stats) -> list:
    """Each segment's ranks in text order: bucket b's ranks (in its sorted
    order; `orders[b]` sorted its concatenated pieces) go back to each
    source as the piece it sent, and source s scatters them through its
    local sort permutation perms[s]."""
    d = len(devices)
    back = []
    for b in range(d):
        cat = torch.empty_like(ranks[b])
        cat[orders[b]] = ranks[b]
        back.append(cat.split([sizes[s][b] for s in range(d)]))
    out, moved = [], 0
    for s, dev in enumerate(devices):
        moved += sum(back[b][s].nbytes for b in range(d) if b != s)
        rank = torch.empty(s_len, dtype=torch.int64, device=dev)
        rank[perms[s]] = torch.cat([back[b][s].to(dev) for b in range(d)])
        out.append(rank)
    stats["phases"][-1]["moved_bytes"] += moved
    return out


def run_distributed(codes: np.ndarray, devices, emit_bwt: bool) -> tuple:
    """(outs, stats): outs[b] (int64, on devices[b]) is bucket b's part of the
    suffix array of the rank text `codes` (uint8 [n] ending in '$'), or with
    `emit_bwt` of each suffix's `(rid << 3) | bwt symbol` in suffix order;
    the parts in order are the whole.  stats holds the segment length, each
    global sort's bucket sizes and bytes moved between entries, and the host
    synchronisations before the output's copy to the host.  Raises where the JAX package
    asserts: n >= 2**31, or a segment shorter than the last doubling halo."""
    devices = build_devices(devices)
    d, n = len(devices), int(codes.size)
    rounds = _sa_rounds_v3(_max_span(codes))
    s_len = segment_length(n, d)
    if s_len < GRAM3 << max(rounds - 1, 0):
        raise ValueError(f"segments of {s_len} characters are shorter than the doubling halo "
                         f"of {GRAM3 << (rounds - 1)}; use fewer devices")
    for dev, count in Counter(devices).items():
        _check_fits(n, dev, held=count * (2 * s_len + SEED_HALO))
    stats = {"segment": s_len, "sizes": segment_sizes(n, d), "rounds": rounds, "phases": [],
             "host_syncs": 0}

    # 1. seed keys, the payload, and the local sort of each segment
    seg_levels, carried, perms, payloads, sent_total = [], [], [], [], []
    for k, dev in enumerate(devices):
        ext = torch.from_numpy(_segment_codes(codes, k, s_len)).to(dev)
        sentpos, key_a, key_b, _ = seed_keys(ext[1:], s_len)
        sentpos = sentpos.to(torch.int64)
        pos = torch.arange(s_len, device=dev)
        if (k + 1) * s_len > n:
            pad = pos >= n - k * s_len
            key_a.masked_fill_(pad, _PAD_KEY)
            key_b.masked_fill_(pad, _PAD_KEY)
            sentpos.masked_fill_(pad, _PAD_SENTPOS)
        if emit_bwt:
            is_sent = ext[1 : s_len + 1] == 0
            rid = torch.cumsum(is_sent, 0)
            sent_total.append(rid[-1:].clone())
            rid -= is_sent.to(torch.int64)
            for total in sent_total[:-1]:
                rid += total.to(dev)
            payloads.append((rid << 3) | ext[:s_len].to(torch.int64))
            del is_sent, rid
        order = _sort_by([pack64(sentpos, pos), key_b, key_a])
        del pos, ext
        lv = [key_a[order], key_b[order], sentpos[order], order + k * s_len]
        del key_a, key_b, sentpos
        seg_levels.append(lv)
        perms.append(order)
        if rounds == 0:
            carried.append(lv[:3] + [payloads[k][order] if emit_bwt else lv[3]])
        else:
            carried.append(lv[:3])
    del sent_total
    buckets, sizes = _exchange(devices, seg_levels, carried, stats, "seed")
    del seg_levels, carried
    levels, orders = [], []
    for bucket in buckets:
        order = _sort_by(bucket[2::-1])
        if rounds == 0:
            levels.append(bucket[3][order])
        else:
            levels.append([x[order] for x in bucket[:3]])
            orders.append(order)
        del bucket[:]
    del buckets
    if rounds == 0:
        return _drop_pads(levels, n), stats
    ranks = _number_runs(levels, stats, [lv[2] != GRAM3 for lv in levels])
    del levels
    ranks = _to_text_order(devices, ranks, orders, sizes, perms, s_len, stats)

    # 5. doubling rounds; the last one carries the output
    for r in range(rounds):
        h, final = GRAM3 << r, r == rounds - 1
        seg_levels, carried, perms = [], [], []
        for k, dev in enumerate(devices):
            ahead = torch.zeros(s_len, dtype=torch.int64, device=dev)  # rank + 1; 0 past the end
            ahead[: s_len - h] = ranks[k][h:] + 1
            if k + 1 < d:
                ahead[s_len - h :] = ranks[k + 1][:h].to(dev) + 1
            key, perm = torch.sort(pack64(ranks[k], ahead), stable=True)
            del ahead
            gidx = perm + k * s_len
            seg_levels.append([key, gidx])
            perms.append(perm)
            out = [payloads[k][perm] if emit_bwt else gidx] if final else []
            carried.append([key] + out)
        del ranks
        buckets, sizes = _exchange(devices, seg_levels, carried, stats, f"round {r}")
        del seg_levels, carried
        levels, orders = [], []
        for bucket in buckets:
            key, order = torch.sort(bucket[0], stable=True)
            if final:
                levels.append(bucket[1][order])
            else:
                levels.append([key])
                orders.append(order)
            del bucket[:]
        del buckets
        if final:
            return _drop_pads(levels, n), stats
        ranks = _number_runs(levels, stats)
        del levels
        ranks = _to_text_order(devices, ranks, orders, sizes, perms, s_len, stats)
    raise AssertionError("unreachable")


def _drop_pads(outs, n: int) -> list:
    """The buckets' outputs without the pads, which are the last rows."""
    kept, start = [], 0
    for o in outs:
        kept.append(o[: max(0, min(o.numel(), n - start))])
        start += o.numel()
    return kept


def distributed_sa(codes: np.ndarray, devices="cuda") -> np.ndarray:
    """Suffix array (int64 [n]) of the sentinel-separated rank text `codes`,
    built with the text and its sort state split over `devices`; the order of
    `index/sa.py::suffix_array_device`."""
    devices = build_devices(devices)
    if codes.size <= 1:
        return np.arange(codes.size, dtype=np.int64)
    outs, _stats = run_distributed(codes, devices, emit_bwt=False)
    return np.concatenate([o.cpu().numpy() for o in outs])


def distributed_bwt_perm(codes: np.ndarray, devices="cuda"):
    """(bwt codes uint8 [n], .sai permutation int64 [reads]), derived on the
    devices: the last sort carries each suffix's BWT symbol and read id, each
    bucket unpacks its rows, and the host concatenates them.  A whole-read
    suffix is one whose BWT symbol is '$', so the permutation is the read
    ids of those rows."""
    devices = build_devices(devices)
    if codes.size == 0:
        return np.zeros(0, dtype=np.uint8), np.zeros(0, dtype=np.int64)
    bwt, perm = [], []
    for packed in run_distributed(codes, devices, emit_bwt=True)[0]:
        sym = (packed & 7).to(torch.uint8)
        perm.append((packed[sym == 0] >> 3).cpu().numpy())
        bwt.append(sym.cpu().numpy())
    return np.concatenate(bwt), np.concatenate(perm)


def distributed_index_arrays(seqs, devices="cuda"):
    """(bwt codes, .sai permutation, number of reads) of a read set, built
    over `devices`: the distributed counterpart of
    `index/sa.py::build_index_arrays`."""
    codes, _starts, _lengths = concat_reads(seqs)
    bwt, perm = distributed_bwt_perm(codes, devices)
    return bwt, perm, len(seqs)
