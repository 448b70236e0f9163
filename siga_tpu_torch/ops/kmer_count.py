"""Batched k-mer counting: one backward search per k-mer on the pair plane.

Port of `siga_tpu/ops/kmer_count.py`, the device analog of
`FMIndex.occurrences`.  `count_kmers` is the hand-written CUDA kernel K7
(`csrc/kmer_count.cu`) on a CUDA index and its plain PyTorch version
`count_kmers_plain` on a CPU index.  Both read the port's one device index,
the pair plane of `DeviceFM`; there is no second, single-step plane.  The
corrector (`siga_tpu.correct.kmer.KmerCorrector`) takes a `KmerCounter` as
its batched counter.
"""
from __future__ import annotations

import functools
from typing import List, Sequence

import numpy as np
import torch

from siga_tpu.core import dna
from siga_tpu.index.fm import SAMPLE

from .. import kernels
from .fm_device import DeviceFM


def count_kmers_plain(dfm: DeviceFM, kmers: torch.Tensor) -> torch.Tensor:
    """Occurrences of each k-mer in the index: kmers uint8/int64 ranks
    [Q, k] (0 = '$', also what N encodes to; 1..4 = ACGT) -> int32 [Q].

    One symbol a step, in lockstep over the batch, as the JAX package's
    `_count_scan`: the last symbol opens the interval, each step prepends
    the next one to the left, and an interval that empties stays as it is."""
    _check_kmers(dfm, kmers)
    codes = kmers.to(torch.int64)
    if codes.numel() and int(codes.max()) > 4:
        raise ValueError("k-mer ranks must lie in 0..4")
    q, k = codes.shape
    dev = codes.device
    pred = torch.as_tensor(dfm.pred, dtype=torch.int64, device=dev)
    tables = _occ_tables(dev)

    c = codes[:, k - 1]
    lo = pred[c]
    hi = lo + _occ_sym(dfm, tables, torch.full((q,), dfm.length - 1, device=dev), c) - 1
    for j in range(k - 2, -1, -1):
        live = lo <= hi
        if not bool(live.any()):
            break  # every interval is empty and stays so
        c = codes[:, j]
        both = _occ_sym(dfm, tables, torch.cat([lo - 1, hi]), torch.cat([c, c]))
        lo = torch.where(live, pred[c] + both[:q], lo)
        hi = torch.where(live, pred[c] + both[q:] - 1, hi)
    return (hi - lo + 1).clamp(min=0).to(torch.int32)


@functools.lru_cache(maxsize=None)
def _occ_tables(device: torch.device):
    """(patterns, wmask, pop8) on `device`: the match2 pattern of each rank's
    2-bit code as int32 ('$' and A both read as code 0 and are told apart by
    the '$' mask), the int32 masks of the first `tail` symbols of a block's 8
    words for tail 0..128, and the popcount of each byte."""
    patterns = np.array([0, 0, 0x55555555, 0xAAAAAAAA, 0xFFFFFFFF], dtype=np.uint32)
    valid = np.clip(np.arange(SAMPLE + 1)[:, None] - 16 * np.arange(8), 0, 16)
    wmask = np.where(valid == 16, 0xFFFFFFFF, (1 << (2 * valid)) - 1).astype(np.uint32)
    pop8 = np.array([bin(b).count("1") for b in range(256)], dtype=np.int64)
    return tuple(
        torch.from_numpy(a.view(np.int32) if a.dtype == np.uint32 else a).to(device)
        for a in (patterns, wmask, pop8)
    )


def _occ_sym(dfm: DeviceFM, tables, i: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """Inclusive occ_c(i) from the pair plane, one symbol c per lane: the
    checkpoints of c summed over the previous symbol, plus the matches of c
    among the block's first symbols up to i.  The words stay int32: the
    arithmetic shift differs from a logical one only in bit 31, which the
    even-bit mask drops."""
    patterns, wmask, pop8 = tables
    pos = i + 1
    block = torch.div(pos, SAMPLE, rounding_mode="floor")
    rows = dfm.plane[block.clamp(0, dfm.nblocks - 1)]  # int32 [R, 57]
    ckpt = rows[:, 32:57].reshape(-1, 5, 5)  # [R, prev, cur]
    base = ckpt.gather(2, c[:, None, None].expand(-1, 5, 1)).sum(dim=(1, 2))
    words, dollar = rows[:, 0:8], rows[:, 16:24]
    x = words ^ patterns[c][:, None]
    m = ~(x | (x >> 1)) & 0x55555555
    m = torch.where((c == 0)[:, None], dollar, torch.where((c == 1)[:, None], m & ~dollar, m))
    m = (m & wmask[pos - block * SAMPLE]).contiguous()
    return base + pop8[m.view(torch.uint8).to(torch.int64)].sum(dim=1)


def _check_kmers(dfm: DeviceFM, kmers: torch.Tensor) -> None:
    if kmers.device != dfm.plane.device:
        raise ValueError(f"k-mers on {kmers.device}, index on {dfm.plane.device}")
    if kmers.dim() != 2 or kmers.shape[1] < 1:
        raise ValueError(f"k-mers: want [Q, k] with k >= 1, got {tuple(kmers.shape)}")
    if kmers.dtype not in (torch.uint8, torch.int64):
        raise ValueError(f"k-mers: want uint8 or int64 ranks, got {kmers.dtype}")


def count_kmers(dfm: DeviceFM, kmers: torch.Tensor) -> torch.Tensor:
    """Occurrences of each k-mer: the CUDA kernel K7 on a CUDA index,
    `count_kmers_plain` on a CPU index; same arguments and output.  On CUDA
    a rank above 4 stops the kernel with a device-side assert."""
    dev = dfm.plane.device
    if dev.type == "cpu":
        return count_kmers_plain(dfm, kmers)
    if dev.type != "cuda":
        raise ValueError(f"count_kmers: unsupported device {dev}")
    _check_kmers(dfm, kmers)
    codes = kmers.to(torch.uint8).contiguous()
    q, k = codes.shape
    out = torch.empty(q, dtype=torch.int32, device=dev)
    if q == 0:
        return out
    kernels.check(
        kernels.lib().siga_kmer_count(
            dfm.plane.data_ptr(), dfm.K.data_ptr(), dfm.pred_dev.data_ptr(),
            dfm.length, dfm.nblocks, codes.data_ptr(), q, k, out.data_ptr(),
            kernels.stream_ptr(dev),
        ),
        "kmer_count",
    )
    kernels.launches["kmer_count"] += 1
    return out


def encode_kmers(kmers: Sequence[str]) -> np.ndarray:
    """Equal-length k-mer strings -> uint8 ranks [Q, k] (the codes of
    `dna.encode`, in one pass over the joined text)."""
    k = len(kmers[0])
    if any(len(w) != k for w in kmers):
        raise ValueError("k-mers differ in length")
    text = np.frombuffer("".join(kmers).encode(), dtype=np.uint8)
    if text.size != k * len(kmers):
        raise ValueError("k-mers must be ASCII")
    return dna.RANK_LUT[text].reshape(len(kmers), k)


class KmerCounter:
    """Callable batching counter, list[str] -> list[int], on the device of
    `dfm`: at most `batch` k-mers a launch, one copy back per call."""

    def __init__(self, dfm: DeviceFM, batch: int = 8192):
        self.dfm = dfm
        self.batch = batch

    def __call__(self, kmers: Sequence[str]) -> List[int]:
        if not kmers:
            return []
        codes = torch.from_numpy(encode_kmers(kmers)).to(self.dfm.device)
        counts = [
            count_kmers(self.dfm, codes[s : s + self.batch])
            for s in range(0, codes.shape[0], self.batch)
        ]
        return torch.cat(counts).cpu().tolist()
