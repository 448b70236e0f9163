"""Batched Smith-Waterman scoring by anti-diagonal wavefront.

Port of `siga_tpu/ops/sw_device.py` (the XLA wavefront) and
`siga_tpu/ops/sw_pallas.py` (its Pallas TPU kernel): affine-gap local
alignment of many (query, ref) pairs, returning the best score and its end
positions.  `sw_wavefront` is the CUDA kernel K5 (`csrc/sw.cu`) on CUDA
tensors and `sw_wavefront_plain` on CPU tensors.
"""
from __future__ import annotations

from typing import Sequence, Tuple

import numpy as np
import torch

from siga_tpu.core import dna

from .. import kernels
from ..device import resolve_device

NEG = -(2**20)


def sw_wavefront_plain(queries, refs, match, mismatch, gap_open, gap_extend):
    """queries int32 [B, M] rank codes (0 = padding); refs int32 [B, N].

    Returns (best, qend, rend) int32 [B]: the best local score and its end
    positions (0-based, -1 when no cell scores above 0).  Ties go to the
    first anti-diagonal d = i + j reaching the maximum, then the smallest
    query row on it.  Mirrors `siga_tpu/ops/sw_device.py::_sw_wavefront`."""
    B, M = queries.shape
    N = refs.shape[1]
    dev = queries.device
    q = queries.to(torch.int64)
    r = refs.to(torch.int64)
    ii = torch.arange(M + 1, device=dev)
    q_sym = q[:, (ii - 1).clamp(0, M - 1)]  # [B, M+1]

    def shift_down(x):  # index i reads the value at i - 1
        return torch.cat([torch.full((B, 1), NEG, dtype=x.dtype, device=dev), x[:, :-1]], 1)

    h_prev = h_prev2 = e_prev = f_prev = torch.full((B, M + 1), NEG, dtype=torch.int64, device=dev)
    diag_best, diag_arg = [], []
    for d in range(2, M + N + 1):
        j = d - ii
        valid = ((ii >= 1) & (j >= 1) & (j <= N))[None, :]
        r_sym = r[:, (j - 1).clamp(0, N - 1)]
        sub = torch.where((q_sym == r_sym) & (q_sym > 0), match, -mismatch)
        e = torch.maximum(shift_down(h_prev) - gap_open, shift_down(e_prev) - gap_extend)
        f = torch.maximum(h_prev - gap_open, f_prev - gap_extend)
        h_diag = shift_down(h_prev2)
        h_diag = torch.where((ii == 1)[None, :], 0, h_diag)  # H[0][j-1] = 0
        h_diag = torch.where(((j == 1) & (ii >= 1))[None, :], 0, h_diag)  # H[i][0] = 0
        h = torch.maximum(torch.maximum(h_diag + sub, e), f).clamp(min=0)
        h = torch.where(valid, h, NEG)
        e = torch.where(valid, e, NEG)
        f = torch.where(valid, f, NEG)
        best_d, arg_d = h.max(dim=1)  # first index on ties
        diag_best.append(best_d)
        diag_arg.append(arg_d)
        h_prev2, h_prev, e_prev, f_prev = h_prev, h, e, f

    diag_best = torch.stack(diag_best)  # [D, B]
    diag_arg = torch.stack(diag_arg)
    best, bd = diag_best.max(dim=0)
    bi = diag_arg.gather(0, bd[None, :])[0]
    qend = bi - 1
    rend = bd + 2 - bi - 1
    none = best <= 0
    i32 = torch.int32
    return (
        best.clamp(min=0).to(i32),
        torch.where(none, -1, qend).to(i32),
        torch.where(none, -1, rend).to(i32),
    )


def sw_wavefront(queries, refs, match, mismatch, gap_open, gap_extend):
    """Same arguments and outputs as `sw_wavefront_plain`: the CUDA kernel K5
    on CUDA tensors, the plain version on CPU tensors."""
    dev = queries.device
    if dev.type == "cpu":
        return sw_wavefront_plain(queries, refs, match, mismatch, gap_open, gap_extend)
    if dev.type != "cuda":
        raise ValueError(f"sw_wavefront: unsupported device {dev}")
    for name, x in (("queries", queries), ("refs", refs)):
        if x.device != dev or x.dtype != torch.int32 or not x.is_contiguous() or x.dim() != 2:
            raise ValueError(f"{name}: want a contiguous 2-d int32 tensor on {dev}")
    B, M = queries.shape
    N = refs.shape[1]
    if refs.shape[0] != B or B == 0 or M == 0 or N == 0:
        raise ValueError(f"sw_wavefront: shapes {tuple(queries.shape)}, {tuple(refs.shape)}")
    if M + 1 > 1024:
        raise ValueError(f"sw_wavefront: query length {M} above the kernel's 1023")
    best, qend, rend = (torch.empty(B, dtype=torch.int32, device=dev) for _ in range(3))
    kernels.check(
        kernels.lib().siga_sw_wavefront(
            queries.data_ptr(), refs.data_ptr(), B, M, N,
            match, mismatch, gap_open, gap_extend,
            best.data_ptr(), qend.data_ptr(), rend.data_ptr(),
            kernels.stream_ptr(dev),
        ),
        "sw_wavefront",
    )
    kernels.launches["sw_wavefront"] += 1
    return best, qend, rend


class BatchAligner:
    """Score many (query, ref) pairs on `device`."""

    def __init__(self, match=2, mismatch=2, gap_open=3, gap_extend=1, device="cuda"):
        self.params = (match, mismatch, gap_open, gap_extend)
        self.device = resolve_device(device)

    def best_scores(self, queries: Sequence[str], refs: Sequence[str]) -> np.ndarray:
        return self.scores(queries, refs)[0]

    def scores(
        self, queries: Sequence[str], refs: Sequence[str]
    ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        if len(queries) != len(refs):
            raise ValueError("queries and refs differ in number")
        B = len(queries)
        qm = np.zeros((B, max(len(q) for q in queries)), dtype=np.int32)
        rm = np.zeros((B, max(len(r) for r in refs)), dtype=np.int32)
        for i, (q, r) in enumerate(zip(queries, refs)):
            qm[i, : len(q)] = dna.encode(q)
            rm[i, : len(r)] = dna.encode(r)
        out = sw_wavefront(
            torch.from_numpy(qm).to(self.device),
            torch.from_numpy(rm).to(self.device),
            *self.params,
        )
        return tuple(x.cpu().numpy() for x in out)
