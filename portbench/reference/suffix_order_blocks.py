"""Plain reference of the index build for a text too long for
`suffix_order.py` on one card: the same order, BWT and `.sai` permutation,
made in blocks, in PyTorch alone.

`suffix_order.py` sorts every position at once through int64 arrays of the
text's length (20 GB each at 2.5 G characters).  Here the suffixes are
bucketed by their first PREFIX symbols (each symbol from the sentinel on
counted as 0, as the reference's keys count it), a uint8 code a position;
the buckets, in ascending code, are the reference's order cut into
contiguous pieces, since those symbols are the most significant of its
first key.  Each bucket's positions, gathered in text order, are ordered by
the reference's radix sort (27 symbols a key, least significant key first,
stable passes; written out again here, as a reference imports nothing),
with the sentinels' positions (an int64 a read) standing in for its
per-position distance to the next sentinel.  No int64 array of the text's
length is made: the largest arrays are the text and the bucket codes, a
byte a character each.

`cap` compares only the first `cap` symbols: the control, a sort that stops
at its seed.
"""
from __future__ import annotations

import torch

SYMBOLS_PER_KEY = 27  # suffix_order.py's: 5 ** 27 < 2 ** 63
PREFIX = 3  # symbols a bucket shares: 5 ** 3 codes, each a byte
CHUNK = 1 << 27  # positions of the text handled at once


def _chunks(n: int):
    for a in range(0, n, CHUNK):
        yield a, min(a + CHUNK, n)


def sentinels(codes: torch.Tensor) -> torch.Tensor:
    """The positions of the text's sentinels (int64 [reads]), ascending."""
    return torch.cat([torch.nonzero(codes[a:b] == 0).flatten() + a
                      for a, b in _chunks(codes.numel())])


def bucket_codes(codes: torch.Tensor, prefix: int) -> torch.Tensor:
    """uint8 [n]: each position's first `prefix` symbols in base 5, a symbol
    from the sentinel on, or past the text, counted as 0."""
    n = codes.numel()
    out = torch.empty(n, dtype=torch.uint8, device=codes.device)
    for a, b in _chunks(n):
        code = torch.zeros(b - a, dtype=torch.uint8, device=codes.device)
        live = torch.ones(b - a, dtype=torch.bool, device=codes.device)
        for j in range(prefix):
            sym = torch.zeros(b - a, dtype=torch.uint8, device=codes.device)
            hi = min(b + j, n)
            sym[: hi - a - j] = codes[a + j : hi]
            sym *= live
            code.mul_(5).add_(sym)
            live &= sym != 0
            del sym
        out[a:b] = code
        del code, live
    return out


def _order(codes: torch.Tensor, pos: torch.Tensor, sent: torch.Tensor, width: int) -> torch.Tensor:
    """`pos` (int64, ascending) in the reference's order: its radix sort over
    `width` symbols, starting from text order."""
    n = codes.numel()
    rest = sent[torch.searchsorted(sent, pos)] - pos  # symbols before each sentinel
    order = pos
    keys = -(-width // SYMBOLS_PER_KEY)
    for k in reversed(range(keys)):
        p, left = order, rest
        key = torch.zeros(p.numel(), dtype=torch.int64, device=codes.device)
        for t in range(SYMBOLS_PER_KEY):
            j = k * SYMBOLS_PER_KEY + t
            sym = codes[(p + j).clamp_(max=n - 1)].to(torch.int64)
            sym *= (left > j) & (j < width)
            key.mul_(5).add_(sym)
            del sym
        idx = torch.sort(key, stable=True).indices
        order, rest = order[idx], rest[idx]
        del key, idx
    return order


def plan(codes: torch.Tensor, cap: int | None = None) -> dict:
    """What the blocks of the rank text `codes` (uint8 [n], ending in '$', on
    the device that sorts) need: its sentinels, the width compared (the
    longest read, or `cap`), each position's bucket code, and each bucket's
    positions and read starts (the rows of its BWT that are '$'), counted."""
    n = codes.numel()
    sent = sentinels(codes)
    width = int(torch.diff(sent, prepend=sent.new_tensor([-1])).max()) - 1  # the longest read
    if cap is not None:
        width = min(width, cap)
    bucket = bucket_codes(codes, min(PREFIX, width))
    counts = sum(torch.bincount(bucket[a:b], minlength=5**PREFIX) for a, b in _chunks(n))
    starts = torch.cat([sent.new_zeros(1), sent[:-1] + 1])  # position 0, and after each '$'
    reads = torch.bincount(bucket[starts], minlength=5**PREFIX)
    return {"sent": sent, "width": width, "bucket": bucket, "counts": counts.tolist(),
            "reads": reads.tolist()}


def block(codes: torch.Tensor, p: dict, v: int) -> tuple:
    """(BWT uint8 [m], .sai permutation int64 [r]) of the bucket of code v,
    `p` the text's `plan`."""
    n = codes.numel()
    pos = torch.cat([torch.nonzero(p["bucket"][a:b] == v).flatten() + a for a, b in _chunks(n)])
    order = _order(codes, pos, p["sent"], p["width"])
    del pos
    before = codes[(order - 1).clamp(min=0)]
    bwt = torch.where(order == 0, torch.zeros_like(before), before)
    return bwt, torch.searchsorted(p["sent"], order[bwt == 0])  # sentinels before each read


def index_blocks(codes: torch.Tensor, cap: int | None = None):
    """Yields (BWT uint8 [m], .sai permutation int64 [r]) of each bucket in
    order: concatenated, `suffix_order.index_arrays(codes, cap)`.  `codes`:
    the rank text (uint8 [n], ending in '$'), on the device that sorts.  The
    buckets are independent: `block` makes any one of them from the `plan`."""
    if codes.numel() == 0:
        return
    p = plan(codes, cap)
    for v, m in enumerate(p["counts"]):
        if m:
            yield block(codes, p, v)


def index_arrays(codes: torch.Tensor, cap: int | None = None) -> tuple:
    """(BWT, permutation) of `codes`, the blocks joined: for small texts."""
    blocks = list(index_blocks(codes, cap))
    if not blocks:
        return (torch.zeros(0, dtype=torch.uint8, device=codes.device),
                torch.zeros(0, dtype=torch.int64, device=codes.device))
    return torch.cat([b for b, _p in blocks]), torch.cat([p for _b, p in blocks])
