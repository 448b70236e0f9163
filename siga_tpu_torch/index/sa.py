"""Suffix-array build of the read set: the device sort (`-a sais2`, the
default) and the host seed-sort (`-a host`).

Port of `siga_tpu/index/sa.py`, whose module imports jax when it loads.  The
order is the reference's multi-string suffix order ('$' sentinels ranked by
text position, `siga_tpu/index/sa.py:1-23`); the BWT and the `.sai`
permutation derive from it.

`suffix_array_device` is the JAX package's `_sa_build_v3` in torch ops on an
explicit device: one seed sort ranks every suffix by its first 64 symbols,
then `rounds` prefix-doubling sorts resolve the rest.  torch has no
multi-key sort, so a multi-key sort is stable `torch.sort` passes over
order-preserving int64 packings of two 32-bit keys, least significant
first.  The 2-bit words work in int64 with explicit 32-bit masks (torch on
the CPU has no shifts on uint32).  Nothing pads the text: it ends in '$', so
the sentinel mask zeroes every symbol past it, and the word array is padded
with zeros.
"""
from __future__ import annotations

from typing import Sequence, Tuple

import numpy as np
import torch

from .. import native
from ..core import dna

from ..device import native_lib, resolve_device

GRAM3 = 64  # seed width: 4 x 16-symbol 2-bit words, plus the sentinel distance
_U32 = 0xFFFFFFFF
# Upper bound of the device build's peak allocation per text character
# (int64 position, rank and key arrays, and torch.sort's buffers);
# chip_smoke.py checks it against the measured peak.
SORT_BYTES_PER_CHAR = 128


def concat_reads(seqs: Sequence[str]) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Concatenate reads with one sentinel (rank 0) after each.

    Returns (codes, starts, lengths): codes is the rank text (uint8),
    starts[i] the text offset of read i, lengths[i] its length."""
    lengths = np.array([len(s) for s in seqs], dtype=np.int64)
    starts = np.concatenate(([0], np.cumsum(lengths + 1)[:-1]))
    joined = "$".join(seqs) + "$"
    codes = dna.RANK_LUT[np.frombuffer(joined.encode(), dtype=np.uint8)].copy()
    if codes.size != int((lengths + 1).sum()):
        raise ValueError("read text contains multi-byte characters")
    return codes, starts, lengths


def suffix_array_host(codes: np.ndarray) -> np.ndarray:
    """Suffix array by the C++ seed-sort (`siga_build_sa`)."""
    native_lib()
    return native.build_sa(codes)


def bwt_from_sa(codes: np.ndarray, sa: np.ndarray) -> np.ndarray:
    """BWT rank codes in SA order (sentinels collapse to rank 0)."""
    prev = codes[np.maximum(sa - 1, 0)]
    return np.where(sa == 0, 0, prev).astype(np.uint8)


def sai_perm_from_sa(sa: np.ndarray, starts: np.ndarray) -> np.ndarray:
    """Read ids of whole-read suffixes, in SA order (the .sai permutation)."""
    n = sa.size
    is_start = np.zeros(n, dtype=bool)
    is_start[starts] = True
    read_of_start = np.zeros(n, dtype=np.int64)
    read_of_start[starts] = np.arange(starts.size)
    return read_of_start[sa[is_start[sa]]]


def _max_span(codes: np.ndarray) -> int:
    """Longest read plus its sentinel."""
    sent_pos = np.flatnonzero(codes == 0)
    prev = np.concatenate(([-1], sent_pos[:-1]))
    return int((sent_pos - prev).max())


def _sa_rounds_v3(max_span: int) -> int:
    """Prefix-doubling rounds after the 64-symbol seed."""
    r = 0
    while (GRAM3 << r) < max_span:
        r += 1
    return r


def pack64(hi: torch.Tensor, lo: torch.Tensor) -> torch.Tensor:
    """One int64 key ordered as the pairs (hi, lo), both in [0, 2**32)."""
    return (hi - 2**31) * 2**32 + lo


def _sort_by(keys) -> torch.Tensor:
    """Stable multi-key argsort: keys least significant first; each pass is
    a stable torch.sort over the keys gathered in the current order."""
    order = None
    for key in keys:
        k = key if order is None else key[order]
        idx = torch.sort(k, stable=True).indices
        order = idx if order is None else order[idx]
        del k, idx
    return order


def _check_fits(n: int, device: torch.device) -> None:
    if n >= 2**31:
        raise ValueError(f"text of {n} characters: the device sort takes below 2**31")
    if device.type == "cuda":
        free, total = torch.cuda.mem_get_info(device)
        # blocks the caching allocator holds but no tensor uses are free too
        free += torch.cuda.memory_reserved(device) - torch.cuda.memory_allocated(device)
        need = SORT_BYTES_PER_CHAR * n
        if need > free:
            raise RuntimeError(
                f"suffix sort of {n} characters needs about {need} bytes on {device}; "
                f"{free} of {total} are free"
            )


def suffix_array_device(codes: np.ndarray, device) -> torch.Tensor:
    """Suffix order (int64 [n], on `device`) of the rank text `codes` (uint8
    [n], ranks $=0 < A < C < G < T, ending in '$').

    Port of `siga_tpu/index/sa.py::_sa_build_v3` (B=1).  The seed sorts by
    four masked 32-bit words of 16 symbols each, then by the distance to
    the suffix's first sentinel capped at 64 (`sentpos`: the suffix whose
    sentinel comes first is smaller, '$' < A), then by position (sentinels
    rank by text position).  A suffix with a sentinel inside its 64-gram is
    resolved and takes a rank of its own; the others go on into
    prefix-doubling rounds over (rank, rank 64 << r ahead)."""
    device = resolve_device(device)
    n = int(codes.size)
    if n <= 1:
        return torch.arange(n, device=device)
    _check_fits(n, device)
    rounds = _sa_rounds_v3(_max_span(codes))
    c = torch.from_numpy(np.ascontiguousarray(codes)).to(device)
    pos = torch.arange(n, device=device)

    # distance to the first sentinel at or after each position, capped at 64
    is_sent = c == 0
    sent_at = torch.nonzero(is_sent).flatten()
    rid = torch.cumsum(is_sent, 0) - is_sent.to(torch.int64)
    sentpos = (sent_at[rid] - pos).clamp_(max=GRAM3)
    del sent_at, rid, is_sent

    # 2-bit symbols ($ and A both 0), 16 to a big-endian word, zero-padded
    n16 = -(-n // 16)
    two = torch.zeros((n16 + 5) * 16, dtype=torch.int64, device=device)
    two[:n] = (c.to(torch.int64) - 1).clamp_(min=0)
    shifts = 30 - 2 * torch.arange(16, device=device)
    w16 = (two.view(-1, 16) << shifts).sum(dim=1)
    del two

    blk = pos >> 4
    o2 = (pos & 15) * 2
    keys = []
    for j in range(4):
        wa = w16[blk + j]
        wb = w16[blk + (j + 1)]
        w = ((wa << o2) & _U32) | (wb >> (32 - o2))
        del wa, wb
        valid = (sentpos - 16 * j).clamp_(0, 16)
        w &= (_U32 << (32 - 2 * valid)) & _U32
        keys.append(w)
        del valid
    del blk, o2, w16

    key_a = pack64(keys[0], keys[1])
    key_b = pack64(keys[2], keys[3])
    del keys
    order = _sort_by([pack64(sentpos, pos), key_b, key_a])
    del pos
    a_s, b_s, sp_s = key_a[order], key_b[order], sentpos[order]
    del key_a, key_b, sentpos
    boundary = (
        (a_s[1:] != a_s[:-1]) | (b_s[1:] != b_s[:-1]) | (sp_s[1:] != sp_s[:-1])
        | (sp_s[1:] != GRAM3)
    )
    del a_s, b_s, sp_s
    if rounds == 0:
        return order
    rank = torch.empty(n, dtype=torch.int64, device=device)
    rank[order] = _ranks(boundary)
    del boundary, order

    for r in range(rounds):
        h = GRAM3 << r
        ahead = torch.zeros(n, dtype=torch.int64, device=device)  # rank + 1; 0 past the end
        if h < n:
            ahead[: n - h] = rank[h:] + 1
        key, order = torch.sort(pack64(rank, ahead), stable=True)
        del ahead
        if r == rounds - 1:
            return order
        rank[order] = _ranks(key[1:] != key[:-1])
        del key, order
    raise AssertionError("unreachable")


def _ranks(boundary: torch.Tensor) -> torch.Tensor:
    """Dense ranks in sorted order from the 'differs from the previous' flags."""
    out = torch.zeros(boundary.numel() + 1, dtype=torch.int64, device=boundary.device)
    out[1:] = torch.cumsum(boundary, 0)
    return out


def bwt_perm_device(codes: np.ndarray, device) -> Tuple[np.ndarray, np.ndarray]:
    """(bwt codes uint8 [n], .sai permutation int64 [reads]) by the device
    suffix sort; port of `siga_tpu/index/sa.py::_sa_bwt_perm_v3`.

    A whole-read suffix is exactly a row whose BWT symbol is '$' (sa == 0
    or codes[sa-1] == 0), and the read id of text position p is the number
    of sentinels before p."""
    device = resolve_device(device)
    sa = suffix_array_device(codes, device)
    c = torch.from_numpy(np.ascontiguousarray(codes)).to(device)
    bwt = torch.where(sa == 0, 0, c[(sa - 1).clamp_(min=0)])
    is_sent = c == 0
    rid = torch.cumsum(is_sent, 0) - is_sent.to(torch.int64)
    perm = rid[sa[bwt == 0]]
    return bwt.to(torch.uint8).cpu().numpy(), perm.cpu().numpy()


def build_index_arrays(
    seqs: Sequence[str], algorithm: str, device=None
) -> Tuple[np.ndarray, np.ndarray, int]:
    """(bwt_codes, sai_perm, num_strings) for one read set: `sais2` sorts on
    `device`, `host` with the C++ seed-sort (and ignores `device`)."""
    codes, starts, _lengths = concat_reads(seqs)
    if algorithm == "sais2":
        bwt, perm = bwt_perm_device(codes, device)
        return bwt, perm, len(seqs)
    if algorithm == "host":
        sa = suffix_array_host(codes)
        return bwt_from_sa(codes, sa), sai_perm_from_sa(sa, starts), len(seqs)
    raise ValueError(f"unknown index algorithm {algorithm!r} (sais2 or host)")

