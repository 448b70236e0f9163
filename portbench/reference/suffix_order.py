"""Plain reference of the index build: the multi-string suffix order of a
read text, its BWT and its `.sai` permutation, in PyTorch alone.

The text is reads, each followed by a sentinel '$' (rank 0; bases 1-4).
A suffix reads up to its read's sentinel.  Two suffixes compare by their
symbols, a shorter one first where it is a prefix of the other ('$' sorts
below every base), and equal ones by the position of their sentinel, that
is by text position.  The order is a least-significant-first radix sort
over keys of 27 symbols each in base 5 (a symbol past the sentinel counts
as 0), starting from text order so that the stable passes keep equal
suffixes in text order.

`cap` compares only the first `cap` symbols: the control, a sort that stops
at its seed.
"""
from __future__ import annotations

import torch

SYMBOLS_PER_KEY = 27  # 5 ** 27 < 2 ** 63


def suffix_order(codes: torch.Tensor, cap: int | None = None) -> torch.Tensor:
    """Suffix order (int64 [n]) of the rank text `codes` (uint8 [n], ending
    in '$'), on its device."""
    n = codes.numel()
    dev = codes.device
    pos = torch.arange(n, device=dev)
    sent = torch.where(codes == 0, pos, torch.full_like(pos, n))
    # symbols before each position's sentinel
    rest = torch.flip(torch.cummin(torch.flip(sent, [0]), 0).values, [0]) - pos
    del sent
    width = int(rest.max()) if n else 0
    if cap is not None:
        width = min(width, cap)
    order = pos
    keys = -(-width // SYMBOLS_PER_KEY)
    for k in reversed(range(keys)):
        p, left = order, rest[order]
        key = torch.zeros(n, dtype=torch.int64, device=dev)
        for t in range(SYMBOLS_PER_KEY):
            j = k * SYMBOLS_PER_KEY + t
            sym = codes[(p + j).clamp_(max=n - 1)].to(torch.int64)
            sym *= (left > j) & (j < width)
            key.mul_(5).add_(sym)
            del sym
        del left
        order = order[torch.sort(key, stable=True).indices]
        del key
    return order


def bwt_perm(codes: torch.Tensor, order: torch.Tensor) -> tuple:
    """(BWT uint8 [n], .sai permutation int64 [reads]) of the text in the
    suffix order `order`: the symbol before each suffix ('$' before the
    text's first), and the read of each suffix that starts a read, in
    order."""
    before = codes[(order - 1).clamp(min=0)]
    bwt = torch.where(order == 0, torch.zeros_like(before), before)
    is_sent = (codes == 0).to(torch.int64)
    read_of = torch.cumsum(is_sent, 0) - is_sent  # sentinels before each position
    return bwt, read_of[order[bwt == 0]]


def index_arrays(codes: torch.Tensor, cap: int | None = None) -> tuple:
    """(BWT, permutation) of `codes` by the reference order."""
    return bwt_perm(codes, suffix_order(codes, cap))
