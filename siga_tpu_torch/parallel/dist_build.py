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
its end with suffixes that sort after every real one.  The text may pass
2**31 characters, up to MAX_CHARS = 2**32 - 2: a segment's own positions
stay below S, and the global slots and ranks are unsigned 32-bit words.
Each card must have DIST_BYTES_PER_CHAR free a character of the segments it
holds (`check_fits`), and room for what each exchange brings it once the
bucket sizes are known (`check_room`).  The radix passes are
stable `torch.sort`s; every step around them is a hand-written CUDA kernel
on a card (K6's `seed_keys`, `gather_keys` and `round_keys` of
`index/sa.py`, and the four of `csrc/dist_sort.cu`, each wrapper here
launching it on a CUDA tensor, counted in `kernels.launches`, and running
its plain PyTorch version, `<step>_plain`, on a CPU tensor):
  1. Seed, K6's way: each segment goes to its device with the next 80
     codes (written into pinned host memory and copied on the card's side
     stream, where a compaction of its sentinels runs: the host waits for
     its size, not for the card's sorts), then builds K6's seed keys, sorts
     them by sentpos (one byte: the sort's stability keeps text order),
     key_b and key_a, with K6's `gather_keys` between the passes.  From the
     sentinels the host works out the doubling rounds, and `levels` gathers
     the sorted key_b, sentpos and the local order (and, where the seed is
     the last sort, the output).
  2. A global sort is one PSRS exchange (parallel sorting by regular
     sampling) of segments already sorted: each gives D - 1 evenly spaced
     samples, the D (D - 1) samples sorted on devices[0] give D - 1
     splitters (`_splitters`, torch: D (D - 1) rows), `bucket_bounds`
     binary-searches each segment for its rows at or below each splitter
     (the D x D piece sizes go to the host once an exchange: the build's
     only host waits), and bucket b takes piece b of every segment.  With
     regular sampling no bucket holds more than about 2 S rows.
  3. The D pieces of a bucket arrive sorted, so `merge_runs` merges them
     (a tree of stable two-way merges, ties to the earlier source), which
     gives the order a stable sort of the pieces concatenated in source
     order gives, without sorting them again.  The memory check counts
     every segment that shares a device.
  4. Run numbering: `number_runs` gives each row of a bucket the global
     slot of the first row of its run (a row starts a run where it differs
     from the row before it, the first row of a bucket compared with the
     last row of the previous non-empty bucket, or where it is resolved),
     and stores it straight into its segment's rank table at its text
     position.  The bucket's first slot is known from the piece sizes, and
     a run that starts in an earlier bucket takes that bucket's last rank,
     so no run count goes to the host.
  5. Doubling rounds, as `suffix_array_device`'s: the key is (rank,
     rank[i + h] + 1) by K6's `round_keys`, rank[i + h] read from the next
     segment's first h ranks copied behind the segment's own (-1 past the
     last segment: a suffix still tied with another has no '$' in its first
     h symbols, so it never reads a pad), globally sorted by steps 2-3.
  6. The last sort carries the output: the position (the suffix array) or,
     from `levels`, the BWT symbol and, on a '$' row, the read id
     (`(rid << 3) | symbol`), so that the host only unpacks; the host
     concatenates the buckets in order.
On a list of several cards a numbering writes the rank tables of the other
cards through peer access, which each pair must have.
Spans (`spans.py`): `siga.dist.build` around a build and its fetch;
inside it `siga.dist.seed` (with `siga.dist.pin`, each segment staged and
sent, and `siga.dist.plan`, the wait for its sentinels), each global sort's
`siga.dist.exchange` (splitters, bounds, the wait for the D x D piece sizes,
the pieces' copies) and `siga.dist.merge`, each numbering's
`siga.dist.number`, each doubling round's `siga.dist.round`, and
`siga.dist.fetch` (the outputs' compaction and copy to the host, its waits
in `siga.dist.wait`).  `build_stats` counts builds, bytes moved between
cards and host waits.
"""
from __future__ import annotations

import ctypes
from collections import Counter

import numpy as np
import torch

from .. import kernels
from ..device import resolve_device
from ..index.sa import (
    GRAM3,
    _free_bytes,
    _on_card,
    _ptr,
    _sa_rounds_v3,
    _scratch,
    _sort_by,
    concat_reads,
    gather_keys,
    gather_keys_plain,
    pack64,
    round_keys,
    round_keys_plain,
    seed_keys,
    seed_keys_plain,
)
from ..ops.fm_device import _enable_peers
from ..spans import span
from . import dist

__all__ = ["distributed_sa", "distributed_index_arrays", "distributed_bwt_perm"]

SEED_HALO = GRAM3 + 16  # codes of the next segment that a segment's seed keys read
# Upper bound of the build's peak allocation on an entry, in bytes a character
# of the segments it holds: the seed's exchange holds a segment's sorted
# columns (26 B a row with its codes), the pieces other entries send it and
# both levels of its merge tree (25 B a row each).  94.8 measured on each of
# four H100s at S = 633,057,920 (PERF.md), with a margin of about 10%;
# chip_smoke.py checks it against the measured peak on each card.  It holds
# for buckets of about S rows; a bucket's size depends on the text (regular
# sampling bounds it by about 2 S), so `check_room` checks each card again
# once an exchange's sizes are known.  K6's SORT_BYTES_PER_CHAR is its own.
DIST_BYTES_PER_CHAR = 104
MAX_CHARS = 2**32 - 2  # slots and ranks are read as unsigned 32-bit words
MAX_SEGMENTS = 16  # rank tables a numbering launch takes (csrc/dist_sort.cu)
_TILE = 128  # a segment is a multiple of this many characters, as in the JAX package
_PAD = 4  # the pads' code: any but '$' (their keys are set apart below)
_PAD_KEY = pack64(2**32 - 1, 2**32 - 1)  # a pad's key words: all ones
_PAD_SENTPOS = GRAM3 + 1  # after every real suffix's sentpos
# A row's columns, in this order: its keys (most significant first; key_b
# and sentpos only in the seed), its position (in a segment, its local
# order, with the segment's first position as a base; in a bucket, global)
# and the BWT payload; None where absent.
K1, K2, SP, POS, PAY = range(5)
KEYS = (K1, K2, SP)


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


def _segment_codes(codes: np.ndarray, k: int, s: int, out=None) -> np.ndarray:
    """codes[k s - 1 : (k + 1) s + SEED_HALO] with 0 before the text and pads
    after it, then one sentinel: the previous code, the segment, its halo;
    written into `out` (uint8 [s + SEED_HALO + 2]) where given."""
    lo, hi = k * s - 1, (k + 1) * s + SEED_HALO
    if out is None:
        out = np.empty(hi - lo + 1, dtype=np.uint8)
    a, b = max(lo, 0), min(hi, codes.size)
    if b > a:
        out[a - lo : b - lo] = codes[a:b]
    out[max(b - lo, 0) :] = _PAD
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
    """Rows of `levels` (most significant first) that are greater than the
    row `split` (0-d tensors)."""
    gt = levels[-1] > split[-1]
    for x, v in zip(levels[-2::-1], split[-2::-1]):
        gt = (x > v) | ((x == v) & gt)
    return gt


def _present(cols) -> list:
    return [c for c in cols if c is not None]


# --- the steps: a wrapper (the kernel on a CUDA tensor) and its plain version


def levels(idx, order=None, key=None, sentpos=None, codes=None, sents=None, rid_base: int = 0):
    """(pos, key, sentpos, payload) of a segment's rows in a sort order: row j
    is the local position o = order[idx[j]] (idx[j] without `order`; pos is
    then None); with `key` (int64) and `sentpos` (uint8) their values at o;
    with `codes` (the segment's codes from the one before it, uint8: codes[o]
    precedes position o) the BWT payload of o: that code where it is not '$',
    else (rid << 3), rid the read that starts at o (rid_base, the sentinels
    before the segment, plus those of the segment's sorted local sentinel
    positions `sents` (int32) below o).  Kernel `dist_levels` on a CUDA
    tensor, `levels_plain` on a CPU one."""
    if idx.device.type == "cpu" or idx.numel() == 0:
        return levels_plain(idx, order, key, sentpos, codes, sents, rid_base)
    dev = _on_card(idx, "levels")
    m = idx.numel()

    def out(given, dtype):
        return None if given is None else torch.empty(m, dtype=dtype, device=dev)

    pos, key_g, sp_g, pay = (out(order, torch.int64), out(key, torch.int64),
                             out(sentpos, torch.uint8), out(codes, torch.int64))
    kernels.launch("dist_levels", dev, kernels.lib().siga_dist_levels, idx.data_ptr(),
                   _ptr(order), _ptr(key), _ptr(sentpos), _ptr(codes), _ptr(sents),
                   0 if sents is None else sents.numel(), rid_base, m, _ptr(pos), _ptr(key_g),
                   _ptr(sp_g), _ptr(pay))
    return pos, key_g, sp_g, pay


def levels_plain(idx, order=None, key=None, sentpos=None, codes=None, sents=None,
                 rid_base: int = 0):
    """`levels` in torch ops."""
    o = idx if order is None else order[idx]
    pay = None
    if codes is not None:
        c = codes[o].to(torch.int64)
        rid = rid_base + torch.searchsorted(sents.to(torch.int64), o)
        pay = torch.where(c != 0, c, rid << 3)
    return (None if order is None else o, None if key is None else key[o],
            None if sentpos is None else sentpos[o], pay)


def bucket_bounds(cols, base: int, split):
    """int64 [D - 1]: the rows of a sorted segment at or below each splitter.
    cols: its (key_a or key, key_b, sentpos, local order) columns (key_b and
    sentpos None outside the seed), ordered by them with `base` added to the
    order; split: the splitters' columns, the same ones with global
    positions, on the segment's device.  Kernel `dist_bounds` on a CUDA
    tensor, `bucket_bounds_plain` on a CPU one."""
    m = cols[K1].numel()
    if cols[K1].device.type == "cpu" or m == 0:
        return bucket_bounds_plain(cols, base, split)
    dev = _on_card(cols[K1], "bucket_bounds")
    out = torch.empty(split[K1].numel(), dtype=torch.int64, device=dev)
    kernels.launch("dist_bounds", dev, kernels.lib().siga_dist_bounds,
                   *(_ptr(c) for c in cols[:4]), m, base, *(_ptr(x) for x in split[:4]),
                   split[K1].numel(), out.data_ptr())
    return out


def bucket_bounds_plain(cols, base: int, split):
    """`bucket_bounds` in torch ops."""
    rows = _present(cols[:3]) + [cols[POS] + base]
    split = _present(split[:4])
    return torch.stack([(~_lex_gt(rows, [x[j] for x in split])).sum()
                        for j in range(split[0].numel())]).to(torch.int64)


def merge_runs(a, a_base: int, b, b_base: int, out) -> None:
    """Merges the sorted runs a and b (their columns, each a view of equal
    length; positions with a_base and b_base added) into `out` (views of
    length len(a) + len(b)), stably: a row of a before a row of b with the
    same keys.  A column of out that is None is not written, and its
    counterparts in a and b are not read.  Kernel `dist_merge` on a CUDA
    tensor, `merge_runs_plain` on a CPU one."""
    na, nb = a[K1].numel(), b[K1].numel()
    if a[K1].device.type == "cpu" or na + nb == 0:
        return merge_runs_plain(a, a_base, b, b_base, out)
    dev = _on_card(a[K1], "merge_runs")
    kernels.launch("dist_merge", dev, kernels.lib().siga_dist_merge,
                   *(_ptr(x) for x in a), na, a_base, *(_ptr(x) for x in b), nb, b_base,
                   *(_ptr(x) for x in out))
    return None


def merge_runs_plain(a, a_base: int, b, b_base: int, out) -> None:
    """`merge_runs` in torch ops: a stable sort of a's rows, then b's."""
    order = _sort_by([torch.cat([a[i], b[i]]) for i in KEYS[::-1] if a[i] is not None])
    for i, o in enumerate(out):
        if o is not None:
            x, y = (a[i] + a_base, b[i] + b_base) if i == POS else (a[i], b[i])
            o.copy_(torch.cat([x, y])[order])
    return None


def number_runs(cols, prev, off: int, tabs, seg: int) -> None:
    """Ranks a bucket's sorted rows into the rank tables, in place: cols, its
    (key_a or key, key_b, sentpos, global position) columns (key_b and
    sentpos None outside the seed); prev, the last row of the previous
    non-empty bucket (one-row views of the same columns) or None; off, the
    slot of the bucket's first row in the global order.  A row starts a run
    where a key differs from the row before it, or where its sentpos is
    not 64; its rank, the slot of its run's first row (the rank of prev
    where the run starts before the bucket), goes to tabs[p // seg][p %
    seg], p its position (tabs: int32, one a segment, holding each rank as
    an unsigned 32-bit word, so off + m may reach 2**32; a table on another
    card is written through peer access, which the pair must have).
    Kernel `dist_number` on a CUDA tensor, `number_runs_plain` on a CPU
    one."""
    m = cols[POS].numel()
    if cols[POS].device.type == "cpu" or m == 0:
        return number_runs_plain(cols, prev, off, tabs, seg)
    dev = _on_card(cols[POS], "number_runs")
    if len(tabs) > MAX_SEGMENTS:
        raise ValueError(f"{len(tabs)} segments: a numbering takes at most {MAX_SEGMENTS}")
    _enable_peers(dev, tabs)  # the tables on other cards are peer writes
    table = (ctypes.c_void_p * len(tabs))(*(t.data_ptr() for t in tabs))
    kernels.launch("dist_number", dev, kernels.lib().siga_dist_number,
                   *(_ptr(c) for c in cols[:4]), m,
                   *(_ptr(p) for p in (prev[:4] if prev is not None else [None] * 4)), off,
                   table, len(tabs), seg, _scratch(m, dev).data_ptr())
    return None


def number_runs_plain(cols, prev, off: int, tabs, seg: int) -> None:
    """`number_runs` in torch ops."""
    keys, pos = _present(cols[:3]), cols[POS]
    m = pos.numel()
    if m == 0:
        return None
    new = torch.zeros(m, dtype=torch.bool, device=pos.device)
    for x in keys:
        new[1:] |= x[1:] != x[:-1]
    carry = 0
    if prev is None:
        new[0] = True
    else:
        for x, p in zip(keys, _present(prev[:3])):
            new[:1] |= x[:1] != p
        p = int(prev[POS])
        carry = int(tabs[p // seg][p % seg]) & 0xFFFFFFFF
    if cols[SP] is not None:
        new |= cols[SP] != GRAM3
    slot = torch.arange(off, off + m, device=pos.device)
    rank = torch.cummax(torch.where(new, slot, 0), 0).values.clamp_(min=carry)
    rank = torch.where(rank >= 2**31, rank - 2**32, rank).to(torch.int32)  # the word's bits
    at = pos // seg
    for k, tab in enumerate(tabs):
        mine = at == k
        tab[(pos[mine] - k * seg).to(tab.device)] = rank[mine].to(tab.device)
    return None


# Each step's kernel name (its launch count's), wrapper and plain version:
# this file's, then K6's that the route runs.
STEPS = {
    "dist_levels": (levels, levels_plain),
    "dist_bounds": (bucket_bounds, bucket_bounds_plain),
    "dist_merge": (merge_runs, merge_runs_plain),
    "dist_number": (number_runs, number_runs_plain),
    "sa_seed_keys": (seed_keys, seed_keys_plain),
    "sa_gather": (gather_keys, gather_keys_plain),
    "sa_round_keys": (round_keys, round_keys_plain),
}


def step_outputs(name: str, args, ret) -> list:
    """A step's outputs: its result's tensors, or what it writes in place
    (the merge's output columns, the numbering's rank tables)."""
    if name == "dist_merge":
        return _present(args[4])
    if name == "dist_number":
        return list(args[3])
    return _present(ret if isinstance(ret, tuple) else (ret,))


def _copy(x):
    if isinstance(x, torch.Tensor):
        return x.clone()
    if isinstance(x, (list, tuple)):
        return type(x)(_copy(y) for y in x)
    return x


def _step(record, label: str, name: str, *args):
    """STEPS[name]'s wrapper on args; with `record` (a dict) its first call
    under `label` keeps (name, copies of the args) there."""
    if record is not None and label not in record:
        record[label] = (name, _copy(args))
    return STEPS[name][0](*args)


# --- the route


def _splitters(devices, cols, bases) -> list:
    """D - 1 splitters (a [D - 1] tensor for each present column of K1, K2,
    SP, POS, global positions; None for an absent one; on devices[0]) from
    D - 1 evenly spaced samples of each sorted segment (cols[k]: its
    columns, `bases[k]` added to its positions)."""
    d = len(devices)
    samples = []
    for col, base in zip(cols, bases):
        at = torch.arange(1, d, device=col[K1].device) * col[K1].numel() // d
        row = [None if x is None else x[at] for x in col[:4]]
        row[POS] = row[POS] + base
        samples.append([None if x is None else x.to(devices[0]) for x in row])
    cat = [None if col[0] is None else torch.cat(col) for col in zip(*samples)]
    pick = _sort_by(_present(cat)[::-1])[torch.arange(1, d, device=devices[0]) * (d - 1)]
    return [None if c is None else c[pick] for c in cat]


def _join(devices) -> None:
    """Makes the current stream of each card of the list wait for every
    other's (no host wait): the numbering writes other cards' rank tables."""
    cards = list(dict.fromkeys(d for d in devices if d.type == "cuda"))
    for a in cards:
        for b in cards:
            if a != b:
                torch.cuda.current_stream(a).wait_stream(torch.cuda.current_stream(b))


def _merge_bucket(runs, keep, dev, record) -> list:
    """The rows of `runs` ((columns, base) each, sorted; in source order)
    merged by a tree of stable two-way merges on `dev`: the columns `keep`
    (the keys too below the last level)."""
    while len(runs) > 1:
        last = len(runs) == 2
        total = sum(c[K1].numel() for c, _base in runs)
        full = [None if x is None or (last and i not in keep) else
                torch.empty(total, dtype=x.dtype, device=dev)
                for i, x in enumerate(runs[0][0])]
        merged, at = [], 0
        for (a, a_base), (b, b_base) in zip(runs[::2], runs[1::2]):
            m = a[K1].numel() + b[K1].numel()
            out = [None if o is None else o[at : at + m] for o in full]
            _step(record, "dist_merge", "dist_merge", a, a_base, b, b_base, out)
            merged.append((out, 0))
            at += m
        runs = merged
    return runs[0][0]


def _exchange(devices, segs, bases, keep, stats, phase, record, rooms) -> tuple:
    """One PSRS exchange of the sorted segments segs[k] (their columns; the
    positions local, bases[k] added).  Returns (buckets, sizes): buckets[b],
    on devices[b], holds the columns `keep` of the rows of bucket b in
    order; sizes[s][b] is the rows source s sent to bucket b.  Raises before
    any piece moves where a card has no room for them (`check_room`)."""
    d = len(devices)
    if d == 1:
        stats["phases"].append({"phase": phase, "moved_bytes": 0, "peer_bytes": 0,
                                "buckets": [segs[0][K1].numel()]})
        return [[x if i in keep else None for i, x in enumerate(segs[0])]], [[segs[0][K1].numel()]]
    with span("siga.dist.exchange"):
        split = _splitters(devices, segs, bases)
        below = []
        for dev, col, base in zip(devices, segs, bases):
            sp = [None if x is None else x.to(dev) for x in split]
            below.append(_step(record, "dist_bounds", "dist_bounds", col[:4], base, sp))
        sizes = [np.diff([0, *row, col[K1].numel()]).tolist()
                 for row, col in zip(_to_host(below, stats), segs)]
        sent = [i for i in range(5) if i in KEYS or i in keep]
        row_bytes = sum(segs[0][i].element_size() for i in sent if segs[0][i] is not None)
        check_room(devices, sizes, row_bytes, rooms)
        pieces, moved, peer = [], 0, 0
        for b, dev in enumerate(devices):
            runs = []
            for s in range(d):
                lo, m = sum(sizes[s][:b]), sizes[s][b]
                piece = [x[lo : lo + m] if x is not None and i in sent else None
                         for i, x in enumerate(segs[s])]
                if devices[s] != dev:
                    piece = [None if x is None else x.to(dev) for x in piece]
                    peer += row_bytes * m
                moved += row_bytes * m if s != b else 0
                runs.append((piece, bases[s]))
            pieces.append(runs)
    with span("siga.dist.merge"):
        buckets = [_merge_bucket(runs, keep, dev, record) for runs, dev in zip(pieces, devices)]
    stats["phases"].append({"phase": phase, "moved_bytes": moved, "peer_bytes": peer,
                            "buckets": [sum(col) for col in zip(*sizes)]})
    return buckets, sizes


def _number(devices, buckets, sizes, tabs, s_len, stats, record, slot_base: int = 0) -> None:
    """Each bucket's rows ranked into the segments' rank tables, in bucket
    order (a bucket's first row is compared with the last row of the
    previous non-empty bucket); the global order's first slot is
    `slot_base`."""
    with span("siga.dist.number"):
        _join(devices)
        prev, off = None, slot_base
        for b, (dev, cols) in enumerate(zip(devices, buckets)):
            m = cols[K1].numel()
            if m:
                p = None if prev is None else [None if x is None else x.to(dev) for x in prev]
                _step(record, "dist_number", "dist_number", cols[:4], p, off, tabs, s_len)
                prev = [None if x is None else x[m - 1 :] for x in cols[:4]]
            off += m
        _join(devices)
    d = len(devices)
    phase = stats["phases"][-1]
    phase["moved_bytes"] += 4 * sum(sizes[s][b] for s in range(d) for b in range(d) if s != b)
    phase["peer_bytes"] = phase.get("peer_bytes", 0) + 4 * sum(
        sizes[s][b] for s in range(d) for b in range(d) if devices[s] != devices[b])


def _halo(tabs, s_len: int, h: int) -> None:
    """Each segment's rank table but the last gets the next segment's first
    h ranks behind its own (the last one's halo stays -1)."""
    for here, after in zip(tabs, tabs[1:]):
        here[s_len : s_len + h].copy_(after[:h])


def _allocated(dev) -> int:
    return torch.cuda.memory_allocated(dev)


def check_fits(n: int, devices, s_len: int, free=_free_bytes) -> dict:
    """Raises unless a text of n characters is at most MAX_CHARS and each
    card of `devices` has room for the sort state of the segments of s_len
    characters it holds (DIST_BYTES_PER_CHAR a character).  free(device):
    the bytes free on a card (None for the CPU, which is not checked).
    Returns {card: (its free bytes, the bytes allocated on it then)} for
    `check_room`."""
    if n > MAX_CHARS:
        raise ValueError(f"text of {n} characters: the distributed sort takes at most "
                         f"{MAX_CHARS}")
    rooms = {}
    with span("siga.dist.check_fits"):
        for dev, count in Counter(devices).items():
            room = free(dev)
            if room is None:
                continue
            need = DIST_BYTES_PER_CHAR * count * s_len
            if need > room[0]:
                raise RuntimeError(
                    f"distributed sort of {count} segment(s) of {s_len} characters needs about "
                    f"{need} bytes on {dev}; {room[0]} of {room[1]} are free")
            rooms[dev] = (room[0], _allocated(dev))
    return rooms


def check_room(devices, sizes, row_bytes: int, rooms) -> None:
    """Raises unless each card of `rooms` (`check_fits`' reading, less what
    was allocated on it since) has room for what an exchange brings it, now
    that its D x D piece sizes are known: the pieces other cards send to
    its buckets and two levels of their merge trees at once, row_bytes a
    row.  check_fits assumed buckets of about S rows; a skewed text makes
    larger ones."""
    need = Counter()
    for b, dev in enumerate(devices):
        rows = [row[b] for row in sizes]
        sent = sum(m for s, m in enumerate(rows) if devices[s] != dev)
        need[dev] += row_bytes * (sent + 2 * sum(rows))
    for dev, (free, then) in rooms.items():
        left = free - (_allocated(dev) - then)
        if need[dev] > left:
            largest = max(sum(row[b] for row in sizes) for b, d in enumerate(devices) if d == dev)
            raise RuntimeError(
                f"distributed sort: an exchange brings about {need[dev]} bytes to {dev} (its "
                f"largest bucket {largest} rows); {left} are free")


_SIDE = {}  # a card's side stream: its segments' copies in and sentinel compactions


def _send_segment(codes: np.ndarray, k: int, s: int, size: int, dev) -> tuple:
    """(segment k's codes `_segment_codes(codes, k, s)` on `dev`, the local
    positions of its `size` text characters' sentinels there (int32), the
    same on the host (int64)).  To a card the codes are written straight
    into pinned host memory and copied on the card's side stream, where the
    compaction of its sentinels runs: its size is the host's one wait, which
    the sorts of the card's other segments do not hold up; the current
    stream then waits for the side stream."""
    with span("siga.dist.pin"):
        if dev.type != "cuda":
            ext = torch.from_numpy(_segment_codes(codes, k, s))
        else:
            host = torch.empty(s + SEED_HALO + 2, dtype=torch.uint8, pin_memory=True)
            _segment_codes(codes, k, s, host.numpy())
            side = _SIDE.setdefault(dev, torch.cuda.Stream(dev))
            with torch.cuda.stream(side):
                ext = host.to(dev, non_blocking=True)
    with span("siga.dist.plan"):
        if dev.type != "cuda":
            local = torch.nonzero(ext[1 : 1 + size] == 0).flatten()
            return ext, local.to(torch.int32), local.numpy()
        with torch.cuda.stream(side):
            local = torch.nonzero(ext[1 : 1 + size] == 0).flatten()
            found = local.cpu().numpy()
            local = local.to(torch.int32)
        main = torch.cuda.current_stream(dev)
        main.wait_stream(side)
        ext.record_stream(main)
        local.record_stream(main)
        return ext, local, found


def _plan(sent: np.ndarray, s_len: int) -> int:
    """The doubling rounds after the seed of a text whose sentinels are at
    `sent` (global, ascending).  Raises where the JAX package asserts: a
    segment shorter than the last doubling halo."""
    rounds = _sa_rounds_v3(int(np.diff(sent, prepend=-1).max()))
    if s_len < GRAM3 << max(rounds - 1, 0):
        raise ValueError(f"segments of {s_len} characters are shorter than the doubling halo "
                         f"of {GRAM3 << (rounds - 1)}; use fewer devices")
    return rounds


# Counts of the builds run in this process: builds, bytes moved between
# cards (pieces and rank-table writes) and host waits on a card (piece sizes,
# sentinel compactions, output compactions and copies).
build_stats = {"builds": 0, "peer_bytes": 0, "host_waits": 0}


def _count(stats) -> None:
    build_stats["builds"] += 1
    build_stats["peer_bytes"] += sum(p.get("peer_bytes", 0) for p in stats["phases"])
    build_stats["host_waits"] += (stats["host_syncs"] + stats["plan_waits"]
                                  + stats.get("fetch_waits", 0))


def run_distributed(codes: np.ndarray, devices, emit_bwt: bool, record=None,
                    slot_base: int = 0) -> tuple:
    """(outs, stats): outs[b] (int64, on devices[b]) is bucket b's part of the
    suffix array of the rank text `codes` (uint8 [n] ending in '$'), or with
    `emit_bwt` of each suffix's BWT symbol with, on a '$' row, its read id
    (`(rid << 3) | symbol`), in suffix order; the parts in order are the
    whole.  stats holds the segment length, the rounds, each global sort's
    bucket sizes and bytes moved between entries and between cards, and the
    host's waits before the output's copy to the host (a global sort's
    piece sizes: `host_syncs`; a segment's sentinels: `plan_waits`).
    `record` as `_step`'s.  The global order's slots, and so the ranks,
    start at `slot_base` (0; a test sets it near 2**31 to run the ranks
    past it): they are read as unsigned 32-bit words, up to 2**32 - 1.
    Raises for n above MAX_CHARS, for a card without room (`check_fits`;
    `check_room` at each exchange),
    and where the JAX package asserts: a segment shorter than
    the last doubling halo."""
    devices = build_devices(devices)
    d, n = len(devices), int(codes.size)
    s_len = segment_length(n, d)
    rooms = check_fits(n, devices, s_len)
    if slot_base < 0 or slot_base + d * s_len > 2**32:
        raise ValueError(f"slots from {slot_base} to {slot_base + d * s_len} pass 2**32")
    stats = {"segment": s_len, "sizes": segment_sizes(n, d), "phases": [], "host_syncs": 0,
             "plan_waits": 0}
    bases = [k * s_len for k in range(d)]

    # 1. each segment sent, its sentinels counted, its seed keys and local
    # sort enqueued; the host sends the next segment while the card sorts
    segs, exts, sents, found = [], [], [], []
    with span("siga.dist.seed"):
        for k, dev in enumerate(devices):
            ext, local, host = _send_segment(codes, k, s_len, stats["sizes"][k], dev)
            stats["plan_waits"] += dev.type == "cuda"
            sents.append((local, sum(x.size for x in found)))
            found.append(host + k * s_len)
            sentpos, key_a, key_b, _ = _step(record, "sa_seed_keys", "sa_seed_keys", ext[1:],
                                             s_len, None)
            if (k + 1) * s_len > n:
                pad = max(n - k * s_len, 0)
                key_a[pad:] = _PAD_KEY
                key_b[pad:] = _PAD_KEY
                sentpos[pad:] = _PAD_SENTPOS
            idx = torch.sort(sentpos, stable=True).indices  # one byte; ties stay in text order
            order, key = _step(record, "sa_gather, key_b", "sa_gather", None, idx, key_b)
            idx = torch.sort(key, stable=True).indices
            order, key = _step(record, "sa_gather, key_a", "sa_gather", order, idx, key_a)
            del key_a, idx
            key_s, idx = torch.sort(key, stable=True)
            del key
            segs.append([key_s, idx, order, key_b, sentpos])
            exts.append(ext)
            del sentpos, key_b, order, idx
        rounds = stats["rounds"] = _plan(np.concatenate(found), s_len)
        del found
        out = emit_bwt and rounds == 0
        for k, (key_s, idx, order, key_b, sentpos) in enumerate(segs):
            pay_args = (exts[k], *sents[k]) if out else ()
            pos, kb_s, sp_s, pay = _step(record, "dist_levels, seed", "dist_levels", idx, order,
                                         key_b, sentpos, *pay_args)
            segs[k] = [key_s, kb_s, sp_s, pos, pay]
            del key_s, idx, order, key_b, sentpos
        if not emit_bwt:
            exts = sents = None
    if rounds == 0:
        buckets, _sizes = _exchange(devices, segs, bases, (PAY if emit_bwt else POS,), stats,
                                    "seed", record, rooms)
        return _drop_pads([c[PAY if emit_bwt else POS] for c in buckets], n), stats
    buckets, sizes = _exchange(devices, segs, bases, (K1, K2, SP, POS), stats, "seed", record,
                               rooms)
    del segs
    halo = GRAM3 << (rounds - 1)
    tabs = [torch.empty(s_len + halo, dtype=torch.int32, device=dev) for dev in devices]
    tabs[-1][s_len:] = -1  # rank + 1 = 0 past the text's last segment
    _number(devices, buckets, sizes, tabs, s_len, stats, record, slot_base)
    del buckets
    upos = {dev: torch.arange(s_len, dtype=torch.int32, device=dev) for dev in set(devices)}

    # 5. doubling rounds; the last one carries the output
    for r in range(rounds):
        with span("siga.dist.round"):
            h, final = GRAM3 << r, r == rounds - 1
            _halo(tabs, s_len, h)
            segs = []
            for k, dev in enumerate(devices):
                key = _step(record, "sa_round_keys", "sa_round_keys", upos[dev], tabs[k], h,
                            s_len + h)
                key_s, perm = torch.sort(key, stable=True)
                del key
                pay = None
                if final and emit_bwt:
                    *_, pay = _step(record, "dist_levels, payload", "dist_levels", perm, None,
                                    None, None, exts[k], *sents[k])
                segs.append([key_s, None, None, perm, pay])
            if final:
                del tabs, upos, exts
            keep = (PAY if emit_bwt else POS,) if final else (K1, POS)
            buckets, sizes = _exchange(devices, segs, bases, keep, stats, f"round {r}", record,
                                       rooms)
            del segs
            if final:
                return _drop_pads([c[keep[0]] for c in buckets], n), stats
            _number(devices, buckets, sizes, tabs, s_len, stats, record, slot_base)
            del buckets
    raise AssertionError("unreachable")


def _drop_pads(outs, n: int) -> list:
    """The buckets' outputs without the pads, which are the last rows."""
    kept, start = [], 0
    for o in outs:
        kept.append(o[: max(0, min(o.numel(), n - start))])
        start += o.numel()
    return kept


def _fetch(tensors, stats=None) -> np.ndarray:
    """The tensors concatenated in one numpy array: from the cards straight
    into one pinned buffer, one wait a card (counted in stats["fetch_waits"]
    where given)."""
    if tensors[0].device.type != "cuda":
        return torch.cat(tensors).numpy()
    out = torch.empty(sum(t.numel() for t in tensors), dtype=tensors[0].dtype, pin_memory=True)
    at = 0
    for t in tensors:
        out[at : at + t.numel()].copy_(t, non_blocking=True)
        at += t.numel()
    with span("siga.dist.wait"):
        cards = dict.fromkeys(t.device for t in tensors)
        for dev in cards:
            torch.cuda.current_stream(dev).synchronize()
    if stats is not None:
        stats["fetch_waits"] = stats.get("fetch_waits", 0) + len(cards)
    return out.numpy()


def distributed_sa(codes: np.ndarray, devices="cuda") -> np.ndarray:
    """Suffix array (int64 [n]) of the sentinel-separated rank text `codes`,
    built with the text and its sort state split over `devices`; the order of
    `index/sa.py::suffix_array_device`."""
    devices = build_devices(devices)
    if codes.size <= 1:
        return np.arange(codes.size, dtype=np.int64)
    with span("siga.dist.build"):
        outs, stats = run_distributed(codes, devices, emit_bwt=False)
        with span("siga.dist.fetch"):
            sa = _fetch(outs, stats)
        _count(stats)
        return sa


def distributed_bwt_perm(codes: np.ndarray, devices="cuda"):
    """(bwt codes uint8 [n], .sai permutation int64 [reads]), derived on the
    devices: the last sort carries each suffix's BWT symbol and, on a '$'
    row, its read id; each bucket unpacks its rows (a compaction, whose size
    the host waits for), and the host copies them straight into one pinned
    buffer each.  A whole-read suffix is one whose BWT symbol is '$', so the
    permutation is the read ids of those rows."""
    devices = build_devices(devices)
    if codes.size == 0:
        return np.zeros(0, dtype=np.uint8), np.zeros(0, dtype=np.int64)
    with span("siga.dist.build"):
        outs, stats = run_distributed(codes, devices, emit_bwt=True)
        with span("siga.dist.fetch"):
            bwt, perm = [], []
            for packed in outs:
                sym = (packed & 7).to(torch.uint8)
                with span("siga.dist.wait"):
                    perm.append(packed[sym == 0] >> 3)
                bwt.append(sym)
            del outs
            stats["fetch_waits"] = sum(p.device.type == "cuda" for p in perm)
            out = _fetch(bwt, stats), _fetch(perm, stats)
        _count(stats)
        return out


def distributed_index_arrays(seqs, devices="cuda"):
    """(bwt codes, .sai permutation, number of reads) of a read set, built
    over `devices`: the distributed counterpart of
    `index/sa.py::build_index_arrays`."""
    codes, _starts, _lengths = concat_reads(seqs)
    bwt, perm = distributed_bwt_perm(codes, devices)
    return bwt, perm, len(seqs)
