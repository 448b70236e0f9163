"""Suffix-array build of the read set: the device sort (`-a sais2`, the
default) and the host seed-sort (`-a host`).

Port of `siga_tpu/index/sa.py`, whose module imports jax when it loads.  The
order is the reference's multi-string suffix order ('$' sentinels ranked by
text position, `siga_tpu/index/sa.py:1-23`); the BWT and the `.sai`
permutation derive from it.

`suffix_array_device` is the JAX package's `_sa_build_v3` (K6) on an
explicit device, and `index_arrays_device` its `_sa_bwt_perm_v3`.  One seed
sort ranks every suffix by its first 64 symbols, then `rounds`
prefix-doubling sorts resolve the rest.  The radix passes are stable
`torch.sort`s; every step around them is a hand-written CUDA kernel of
`csrc/suffix_sort.cu` on a card (each wrapper here launches it on a CUDA
tensor, counted in `kernels.launches`, and runs its plain PyTorch version,
`<step>_plain`, on a CPU tensor):
  1. `seed_keys`: sentpos (the distance to the first '$', capped at 64;
     uint8) and the 64 symbols as four masked 32-bit words in two int64
     keys (`pack64`); `upos`: the positions whose sentpos is 64, in text
     order;
  2. stable sorts by sentpos (one byte: the sort's stability keeps text
     order, the position key of the JAX package), then key_b, then key_a,
     each key gathered in the order so far by `gather_keys`;
  3. `seed_ranks`: the seed order, each position's rank (the slot of the
     first row of its group of equal seeds: a row whose sentpos is not 64
     is a group of its own), and `uslot`: the slots of the rows whose
     sentpos is 64;
  4. each round: `round_keys` packs (rank, rank 64 << r ahead + 1) of the
     upos positions alone, one sort orders them, and `round_scatter` puts
     the k-th into slot uslot[k] of the order and gives it its new group's
     first slot as its rank (the tied groups are whole, contiguous and in
     rank order among both);
  5. `bwt_perm`: the BWT and the read ids of its '$' rows, in SA order.
No step waits on the card: the seed's compactions are sized n, and the
host works out the rounds and the tied count (`sort_plan`) while the card
sorts the seed.  The text goes to the card once (pinned) and the BWT and
permutation come back once.  `suffix_array_plain` / `bwt_perm_plain` keep the all-torch
route that preceded the kernels (a multi-key sort as stable passes over
packed int64 keys, least significant first, full doubling sorts); the card
route is held to them bit for bit.  The 2-bit words work in int64 with
explicit 32-bit masks (torch on the CPU has no shifts on uint32).
"""
from __future__ import annotations

from typing import NamedTuple, Sequence, Tuple

import numpy as np
import torch

from .. import kernels, native
from ..core import dna
from ..spans import span

from ..device import native_lib, resolve_device

GRAM3 = 64  # seed width: 4 x 16-symbol 2-bit words, plus the sentinel distance
SEED_READ = GRAM3 + 16  # codes past a position that its seed keys may read
_U32 = 0xFFFFFFFF
# Upper bound of the device build's peak allocation per text character
# (the int64 keys, orders and torch.sort's buffers); chip_smoke.py checks it
# against the measured peak (76.6 on the H100 at 25.2 Mchar, PERF.md).
SORT_BYTES_PER_CHAR = 96


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


class SortPlan(NamedTuple):
    """What the host knows of a rank text's sort before it starts."""

    rounds: int  # prefix-doubling rounds after the seed
    tied: int  # positions whose sentpos is 64: the only ones a round sorts
    reads: int  # sentinels: the reads, and the BWT's '$' rows


def sort_plan(codes: np.ndarray) -> SortPlan:
    """The plan of a rank text that ends in '$'.  A read of L symbols has
    max(0, L - 63) positions with no '$' among their next 64 codes."""
    if codes.size == 0 or codes[-1] != 0:
        raise ValueError("the rank text must end in '$' (rank 0)")
    with span("siga.sa.sort_plan"):
        sent = np.flatnonzero(codes == 0)
        lengths = np.diff(sent, prepend=-1)  # each read plus its sentinel
        return SortPlan(_sa_rounds_v3(int(lengths.max())),
                        int(np.maximum(lengths - GRAM3, 0).sum()), int(sent.size))


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


def _check_fits(n: int, device: torch.device, held: int | None = None) -> None:
    """Raises unless a text of n characters is below 2**31 and `device` has
    room for the sort state of `held` characters (default n) at once."""
    if n >= 2**31:
        raise ValueError(f"text of {n} characters: the device sort takes below 2**31")
    with span("siga.sa.check_fits"):
        if device.type == "cuda":
            held = n if held is None else held
            free, total = torch.cuda.mem_get_info(device)
            # blocks the caching allocator holds but no tensor uses are free too
            free += torch.cuda.memory_reserved(device) - torch.cuda.memory_allocated(device)
            need = SORT_BYTES_PER_CHAR * held
            if need > free:
                raise RuntimeError(
                    f"suffix sort of {held} characters needs about {need} bytes on {device}; "
                    f"{free} of {total} are free"
                )


def text_to_device(codes: np.ndarray, device) -> torch.Tensor:
    """The rank text on `device`: to a card from pinned host memory, without
    waiting for the copy."""
    device = resolve_device(device)
    with span("siga.sa.pin_text"):
        host = torch.from_numpy(np.ascontiguousarray(codes))
        if device.type == "cuda":
            return host.pin_memory().to(device, non_blocking=True)
        return host


def _on_card(t: torch.Tensor, step: str) -> torch.device:
    if t.device.type != "cuda":
        raise ValueError(f"{step}: unsupported device {t.device}")
    return t.device


def _ptr(t) -> int | None:
    return None if t is None else t.data_ptr()


def _scratch(items: int, device) -> torch.Tensor:
    """A scan's look-back words and ticket (the kernel zeroes them)."""
    return torch.empty(kernels.lib().siga_sa_scan_scratch(items), dtype=torch.int64, device=device)


# --- the steps: a wrapper (the kernel on a CUDA tensor) and its plain version


def seed_keys(c: torch.Tensor, n: int, ucap: int | None = None):
    """(sentpos uint8 [n], key_a int64 [n], key_b int64 [n], upos): the seed
    sort's keys of the first n positions of the rank text `c` (uint8 [>= n],
    on its device), and with `ucap` the positions whose sentpos is 64 in text
    order, zero-padded to int32 [ucap] (else None).

    sentpos is the distance to the first sentinel at or after a position,
    capped at 64; key_a and key_b pack the four 32-bit words of its first 64
    symbols, each symbol from the sentinel on masked to 0.  Symbols past
    position n - 1 + 80 are never read, and every position must have a
    sentinel after it in `c`: the whole text ends in one, and a segment of it
    (`parallel/dist_build.py`) carries the next 80 symbols and one more.
    Kernel `sa_seed_keys` on a CUDA tensor, `seed_keys_plain` on a CPU one."""
    if c.dtype != torch.uint8 or c.dim() != 1 or not c.is_contiguous() or not 0 <= n <= c.numel():
        raise ValueError(f"seed_keys: want a contiguous 1-d uint8 text of at least n = {n} codes")
    if c.device.type == "cpu" or n == 0:
        return seed_keys_plain(c, n, ucap)
    dev = _on_card(c, "seed_keys")
    lib = kernels.lib()
    sentpos = torch.empty(n, dtype=torch.uint8, device=dev)
    key_a = torch.empty(n, dtype=torch.int64, device=dev)
    key_b = torch.empty(n, dtype=torch.int64, device=dev)
    upos = None if ucap is None else torch.zeros(ucap, dtype=torch.int32, device=dev)
    scratch = None if ucap is None else _scratch(n, dev)
    kernels.launch("sa_seed_keys", dev, lib.siga_sa_seed_keys, c.data_ptr(),
                   min(c.numel(), n + SEED_READ), n, sentpos.data_ptr(), key_a.data_ptr(),
                   key_b.data_ptr(), _ptr(upos), ucap or 0, _ptr(scratch))
    return sentpos, key_a, key_b, upos


def _compact(flags: torch.Tensor, cap: int) -> torch.Tensor:
    """The indices of `flags` in order, zero-padded to int32 [cap]."""
    found = torch.nonzero(flags).flatten()
    if found.numel() > cap:
        raise ValueError(f"{found.numel()} indices do not fit in {cap}")
    out = torch.zeros(cap, dtype=torch.int32, device=flags.device)
    out[: found.numel()] = found
    return out


def seed_keys_plain(c: torch.Tensor, n: int, ucap: int | None = None):
    """`seed_keys` in torch ops."""
    m_all = c.numel()
    pos = torch.arange(n, device=c.device)
    # distance to the first sentinel at or after each position, capped at 64
    is_sent = c == 0
    sent_at = torch.nonzero(is_sent).flatten()
    is_sent = is_sent[:n]
    rid = torch.cumsum(is_sent, 0) - is_sent.to(torch.int64)
    sentpos = (sent_at[rid] - pos).clamp_(max=GRAM3)
    del sent_at, rid, is_sent

    # 2-bit symbols ($ and A both 0), 16 to a big-endian word, zero-padded
    m16 = -(-m_all // 16)
    two = torch.zeros((m16 + 5) * 16, dtype=torch.int64, device=c.device)
    two[:m_all] = (c.to(torch.int64) - 1).clamp_(min=0)
    shifts = 30 - 2 * torch.arange(16, device=c.device)
    w16 = (two.view(-1, 16) << shifts).sum(dim=1)
    del two

    blk = pos >> 4
    o2 = (pos & 15) * 2
    del pos
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
    upos = None if ucap is None else _compact(sentpos == GRAM3, ucap)
    return sentpos.to(torch.uint8), pack64(keys[0], keys[1]), pack64(keys[2], keys[3]), upos


def gather_keys(order, idx: torch.Tensor, key: torch.Tensor):
    """(order[idx], key[order[idx]]) between two sort passes (order None:
    idx itself): the order so far composed with a pass's sort indices, and
    the next pass's key in it.  Kernel `sa_gather` on a CUDA tensor,
    `gather_keys_plain` on a CPU one."""
    if idx.device.type == "cpu" or idx.numel() == 0:
        return gather_keys_plain(order, idx, key)
    dev = _on_card(idx, "gather_keys")
    n = idx.numel()
    out_order = idx if order is None else torch.empty(n, dtype=torch.int64, device=dev)
    out_key = torch.empty(n, dtype=torch.int64, device=dev)
    kernels.launch("sa_gather", dev, kernels.lib().siga_sa_gather, _ptr(order), idx.data_ptr(),
                   key.data_ptr(), n, None if order is None else out_order.data_ptr(),
                   out_key.data_ptr())
    return out_order, out_key


def gather_keys_plain(order, idx: torch.Tensor, key: torch.Tensor):
    """`gather_keys` in torch ops."""
    out = idx if order is None else order[idx]
    return out, key[out]


def seed_ranks(order2, idx3, ka_s, key_b, sentpos, ucap: int):
    """(order int64 [n], rank int32 [n], uslot int32 [ucap]) after the
    seed's last pass: the seed order (order2[idx3]); by position, the slot
    of the first row of its group (rows of equal key_a, key_b and sentpos
    64; any other row is a group of its own); the slots whose row has
    sentpos 64, zero-padded.  ka_s is the last pass's sorted key_a.  Kernel
    `sa_seed_ranks` on a CUDA tensor, `seed_ranks_plain` on a CPU one."""
    if idx3.device.type == "cpu" or idx3.numel() == 0:
        return seed_ranks_plain(order2, idx3, ka_s, key_b, sentpos, ucap)
    dev = _on_card(idx3, "seed_ranks")
    n = idx3.numel()
    order = torch.empty(n, dtype=torch.int64, device=dev)
    rank = torch.empty(n, dtype=torch.int32, device=dev)
    uslot = torch.zeros(ucap, dtype=torch.int32, device=dev)
    kernels.launch("sa_seed_ranks", dev, kernels.lib().siga_sa_seed_ranks, order2.data_ptr(),
                   idx3.data_ptr(), ka_s.data_ptr(), key_b.data_ptr(), sentpos.data_ptr(), n,
                   order.data_ptr(), rank.data_ptr(), uslot.data_ptr(), ucap,
                   _scratch(n, dev).data_ptr())
    return order, rank, uslot


def seed_ranks_plain(order2, idx3, ka_s, key_b, sentpos, ucap: int):
    """`seed_ranks` in torch ops."""
    order = order2[idx3]
    kb, sp = key_b[order], sentpos[order]
    n = order.numel()
    first = torch.ones(n, dtype=torch.bool, device=order.device)
    first[1:] = ((ka_s[1:] != ka_s[:-1]) | (kb[1:] != kb[:-1]) | (sp[1:] != sp[:-1])
                 | (sp[1:] != GRAM3))
    slot = torch.arange(n, device=order.device)
    rank = torch.empty(n, dtype=torch.int32, device=order.device)
    rank[order] = torch.cummax(torch.where(first, slot, 0), 0).values.to(torch.int32)
    return order, rank, _compact(sp == GRAM3, ucap)


def round_keys(upos, rank, h: int, n: int):
    """pack64(rank[p], rank[p + h] + 1, or 0 past the end) of each upos
    position p: a doubling round's keys (int64 [m]).  Kernel `sa_round_keys`
    on a CUDA tensor, `round_keys_plain` on a CPU one."""
    if upos.device.type == "cpu" or upos.numel() == 0:
        return round_keys_plain(upos, rank, h, n)
    dev = _on_card(upos, "round_keys")
    key = torch.empty(upos.numel(), dtype=torch.int64, device=dev)
    kernels.launch("sa_round_keys", dev, kernels.lib().siga_sa_round_keys, upos.data_ptr(),
                   rank.data_ptr(), h, n, upos.numel(), key.data_ptr())
    return key


def round_keys_plain(upos, rank, h: int, n: int):
    """`round_keys` in torch ops."""
    p = upos.to(torch.int64)
    ahead = p + h
    inside = ahead < n
    lo = torch.where(inside, rank[ahead.clamp_(max=n - 1)].to(torch.int64) + 1, 0)
    return pack64(rank[p].to(torch.int64), lo)


def round_scatter(idx, skey, upos, uslot, order, rank=None):
    """A doubling round's sort into the order, in place: the position
    upos[idx[k]] to slot uslot[k], and (before the last round, `rank` given)
    its new rank, the first slot of its run of equal sorted keys `skey`.
    Returns (order, rank).  Kernel `sa_round_scatter` on a CUDA tensor,
    `round_scatter_plain` on a CPU one."""
    if idx.device.type == "cpu" or idx.numel() == 0:
        return round_scatter_plain(idx, skey, upos, uslot, order, rank)
    dev = _on_card(idx, "round_scatter")
    m = idx.numel()
    kernels.launch("sa_round_scatter", dev, kernels.lib().siga_sa_round_scatter, idx.data_ptr(),
                   skey.data_ptr(), upos.data_ptr(), uslot.data_ptr(), m, order.data_ptr(),
                   _ptr(rank), None if rank is None else _scratch(m, dev).data_ptr())
    return order, rank


def round_scatter_plain(idx, skey, upos, uslot, order, rank=None):
    """`round_scatter` in torch ops."""
    p = upos[idx].to(torch.int64)
    slot = uslot.to(torch.int64)
    order[slot] = p
    if rank is not None:
        first = torch.ones(idx.numel(), dtype=torch.bool, device=idx.device)
        first[1:] = skey[1:] != skey[:-1]
        rank[p] = torch.cummax(torch.where(first, slot, 0), 0).values.to(torch.int32)
    return order, rank


def bwt_perm(sa, c, reads: int):
    """(bwt uint8 [n], perm int64 [reads]) of the suffix array `sa` of the
    rank text `c` of `reads` reads: bwt[i] = c[sa[i] - 1] ('$' where sa[i] =
    0), and the read ids of the '$' rows in SA order.  A read starting at p
    > 0 follows the sentinel at p - 1; the first `reads` rows of the SA are
    the sentinels in text order, so its id is one more than that sentinel's
    row.  Kernel `sa_bwt_perm` on a CUDA tensor, `bwt_perm_plain_step` on a
    CPU one."""
    if sa.device.type == "cpu" or sa.numel() == 0:
        return bwt_perm_plain_step(sa, c, reads)
    dev = _on_card(sa, "bwt_perm")
    n = sa.numel()
    bwt = torch.empty(n, dtype=torch.uint8, device=dev)
    perm = torch.empty(reads, dtype=torch.int64, device=dev)
    kernels.launch("sa_bwt_perm", dev, kernels.lib().siga_sa_bwt_perm, sa.data_ptr(),
                   c.data_ptr(), n, reads, bwt.data_ptr(), perm.data_ptr(),
                   _scratch(n, dev).data_ptr())
    return bwt, perm


def bwt_perm_plain_step(sa, c, reads: int):
    """`bwt_perm` in torch ops: the '$' rows compacted by their exclusive
    count, as the kernel's scan does."""
    bwt = torch.where(sa == 0, 0, c[(sa - 1).clamp(min=0)])
    dollar = bwt == 0
    at = torch.cumsum(dollar, 0) - dollar.to(torch.int64)
    rid = torch.where(sa == 0, 0, torch.searchsorted(sa[:reads], sa - 1) + 1)
    perm = torch.empty(reads + 1, dtype=torch.int64, device=sa.device)
    perm[torch.where(dollar, at, reads)] = rid  # rows that are not '$' to the spare slot
    return bwt.to(torch.uint8), perm[:reads]


# Each step's kernel name (its launch count's), wrapper and plain version.
STEPS = {
    "sa_seed_keys": (seed_keys, seed_keys_plain),
    "sa_gather": (gather_keys, gather_keys_plain),
    "sa_seed_ranks": (seed_ranks, seed_ranks_plain),
    "sa_round_keys": (round_keys, round_keys_plain),
    "sa_round_scatter": (round_scatter, round_scatter_plain),
    "sa_bwt_perm": (bwt_perm, bwt_perm_plain_step),
}


def _step(record, label: str, name: str, *args):
    """STEPS[name]'s wrapper on args; with `record` (a dict) its first call
    under `label` keeps (name, copies of the args) there."""
    if record is not None and label not in record:
        record[label] = (name, tuple(a.clone() if isinstance(a, torch.Tensor) else a
                                     for a in args))
    return STEPS[name][0](*args)


# --- the route


def _seed(codes: np.ndarray, c: torch.Tensor, n: int, record=None) -> tuple:
    """(order, rank, uslot, upos) after the seed of the rank text `codes` (n
    > 1 characters), `c` its copy on the device: enqueued with its
    compactions sized n, so that the host works out `sort_plan` while the
    card sorts it; `record` as `_step`'s."""
    if codes[-1] != 0:
        raise ValueError("the rank text must end in '$' (rank 0)")
    with span("siga.sa.seed"):
        sentpos, key_a, key_b, upos = _step(record, "sa_seed_keys", "sa_seed_keys", c, n, n)
        idx = torch.sort(sentpos, stable=True).indices  # one byte; ties stay in text order
        order, key = _step(record, "sa_gather, key_b", "sa_gather", None, idx, key_b)
        idx = torch.sort(key, stable=True).indices
        del key
        order, key = _step(record, "sa_gather, key_a", "sa_gather", order, idx, key_a)
        del key_a, idx
        key_s, idx = torch.sort(key, stable=True)
        del key
        order, rank, uslot = _step(record, "sa_seed_ranks", "sa_seed_ranks", order, idx, key_s,
                                   key_b, sentpos, n)
        return order, rank, uslot, upos


def _rounds(seeded: tuple, plan: SortPlan, n: int, record=None) -> torch.Tensor:
    """The suffix order: `_seed`'s order after `plan.rounds` doubling
    rounds over its tied positions."""
    order, rank, uslot, upos = seeded
    upos, uslot = upos[: plan.tied], uslot[: plan.tied]
    for r in range(plan.rounds):
        key = _step(record, "sa_round_keys", "sa_round_keys", upos, rank, GRAM3 << r, n)
        key_s, idx = torch.sort(key, stable=True)
        del key
        last = r == plan.rounds - 1
        _step(record, "sa_round_scatter" + (", last round" if last else ""), "sa_round_scatter",
              idx, key_s, upos, uslot, order, None if last else rank)
        del key_s, idx
    return order


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
    seeded = _seed(codes, text_to_device(codes, device), n)
    plan = sort_plan(codes)
    with span("siga.sa.rounds"):
        return _rounds(seeded, plan, n)


def index_arrays_device(codes: np.ndarray, device, record=None):
    """(bwt uint8 [n], .sai permutation int64 [reads]) of the rank text
    `codes`, on `device`: port of `siga_tpu/index/sa.py::_sa_bwt_perm_v3`.
    The text goes to the device once; nothing waits on the device."""
    device = resolve_device(device)
    n = int(codes.size)
    if n == 0:
        return (torch.zeros(0, dtype=torch.uint8, device=device),
                torch.zeros(0, dtype=torch.int64, device=device))
    _check_fits(n, device)
    c = text_to_device(codes, device)
    seeded = _seed(codes, c, n, record) if n > 1 else None
    plan = sort_plan(codes)
    with span("siga.sa.rounds"):
        sa = torch.arange(n, device=device) if seeded is None else _rounds(seeded, plan, n, record)
        del seeded  # the seed's ranks and slots are freed before the outputs are made
        return _step(record, "sa_bwt_perm", "sa_bwt_perm", sa, c, plan.reads)


def _to_host(tensors) -> list:
    """The tensors as numpy arrays: from a card through pinned memory, one
    wait for all."""
    with span("siga.sa.to_host"):
        dev = tensors[0].device
        if dev.type != "cuda":
            return [t.numpy() for t in tensors]
        out = [torch.empty(t.shape, dtype=t.dtype, pin_memory=True) for t in tensors]
        for o, t in zip(out, tensors):
            o.copy_(t, non_blocking=True)
        with span("siga.sa.wait"):
            torch.cuda.current_stream(dev).synchronize()
        return [o.numpy() for o in out]


def bwt_perm_device(codes: np.ndarray, device) -> Tuple[np.ndarray, np.ndarray]:
    """(bwt codes uint8 [n], .sai permutation int64 [reads]) by the device
    suffix sort (`index_arrays_device`), on the host."""
    with span("siga.sa.build"):
        bwt, perm = _to_host(index_arrays_device(codes, device))
        return bwt, perm


# --- the all-torch route that preceded the kernels: the card route's reference


def suffix_array_plain(codes: np.ndarray, device) -> torch.Tensor:
    """`suffix_array_device`'s order in torch ops alone: the seed as three
    stable passes over packed int64 keys (pack64(sentpos, pos), key_b,
    key_a), dense ranks by a cumsum, and each round a sort of every
    position by pack64(rank, rank ahead + 1)."""
    device = resolve_device(device)
    n = int(codes.size)
    if n <= 1:
        return torch.arange(n, device=device)
    rounds = _sa_rounds_v3(_max_span(codes))
    c = torch.from_numpy(np.ascontiguousarray(codes)).to(device)
    sentpos, key_a, key_b, _ = seed_keys_plain(c, n)
    sentpos = sentpos.to(torch.int64)
    del c
    pos = torch.arange(n, device=device)
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


def bwt_perm_plain(codes: np.ndarray, device) -> Tuple[np.ndarray, np.ndarray]:
    """`bwt_perm_device`'s arrays from `suffix_array_plain`, in torch ops: a
    whole-read suffix is a row whose BWT symbol is '$' (sa == 0 or
    codes[sa-1] == 0), and the read id of text position p is the number of
    sentinels before p."""
    device = resolve_device(device)
    sa = suffix_array_plain(codes, device)
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
