"""Batched Smith-Waterman scoring by anti-diagonal wavefront.

Port of `siga_tpu/ops/sw_device.py` (the XLA wavefront) and
`siga_tpu/ops/sw_pallas.py` (its Pallas TPU kernel): affine-gap local
alignment of many (query, ref) pairs, returning the best score and its end
positions.  `sw_wavefront` is the CUDA kernel K5 (`csrc/sw.cu`) on CUDA
tensors, at any query length (a query longer than 1,023 runs as strips),
and `sw_wavefront_plain` on CPU tensors.
"""
from __future__ import annotations

from typing import Sequence, Tuple

import numpy as np
import torch

from ..core import dna

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


EDGE_PARAMS = ((2, 2, 3, 1), (1, 3, 5, 2), (5, 4, 10, 1))


def sw_edge_cases(seed: int = 0):
    """K5's edge shapes: [(label, queries int32 [B, M], refs int32 [B, N],
    (match, mismatch, gap_open, gap_extend))] as numpy arrays.  M in {1, 31,
    32, 33, 150, 1023} (one lane row a lane up to the kernel's widest lane,
    the lane count's edges), N in {1, M - 1, 400}, B 1 or 5, the parameter
    sets of EDGE_PARAMS in turn; then queries padded with 0, pairs with no
    match (best 0, ends -1), a tie across diagonals, a tie on one diagonal,
    two-letter pairs full of ties, and `long_query_cases`."""
    rng = np.random.default_rng(seed)

    def codes(shape, letters=4):
        return rng.integers(1, letters + 1, shape).astype(np.int32)

    cases = []
    for M in (1, 31, 32, 33, 150, 1023):
        for N in sorted({1, M - 1, 400} - {0}):
            k = len(cases)
            B = 5 if k % 2 == 0 else 1
            params = EDGE_PARAMS[k % len(EDGE_PARAMS)]
            cases.append((f"M={M} N={N} B={B} params={params}", codes((B, M)), codes((B, N)),
                          params))
    padded = codes((5, 150))
    for b, n in enumerate((150, 149, 90, 45, 1)):
        padded[b, n:] = 0
    cases.append(("queries padded with 0", padded, codes((5, 400)), EDGE_PARAMS[0]))
    cases.append(("no match: best 0, ends -1", np.full((5, 33), 1, np.int32),
                  np.full((5, 40), 2, np.int32), EDGE_PARAMS[1]))
    cases.append(("padding only: best 0, ends -1", np.zeros((1, 32), np.int32),
                  codes((1, 400)), EDGE_PARAMS[0]))
    # ACGT twice in the ref: equal scores on diagonals 8 and 14, the first wins
    cases.append(("tie across diagonals", np.array([[1, 2, 3, 4]], np.int32),
                  np.array([[1, 2, 3, 4, 4, 4, 1, 2, 3, 4]], np.int32), EDGE_PARAMS[0]))
    # AC against CA: 2 at (1, 2) and at (2, 1), both on diagonal 3; row 1 wins
    cases.append(("tie on one diagonal", np.array([[1, 2]], np.int32),
                  np.array([[2, 1]], np.int32), EDGE_PARAMS[0]))
    for M, N, params in ((33, 400, EDGE_PARAMS[2]), (150, 150, EDGE_PARAMS[1]),
                         (1023, 64, EDGE_PARAMS[0])):
        cases.append((f"two letters M={M} N={N} params={params}", codes((5, M), 2),
                      codes((5, N), 2), params))
    return cases + long_query_cases(rng)


def long_query_cases(rng):
    """K5's cases past one launch's 1,023 rows (the tail of `sw_edge_cases`): M in
    {1024, 1025, 2047, 3000} with N in {1, M - 1, 400}; one alignment of 298
    symbols across the strips, with a gap down rows 992-993 (the first
    strip's last row and the second's first); and equal bests in two strips
    at rows 992/993 and 1023/1024: G x 8 in the query ending at row b, T x 8
    starting at row b + 1, the ref C but for T x 8 ending at column 100 and G
    x 8 ending at column 300 (the later rows' diagonal is the smaller, so
    they win) or 108 (one diagonal: row b wins)."""
    def codes(shape):
        return rng.integers(1, 5, shape).astype(np.int32)

    cases = []
    for M in (1024, 1025, 2047, 3000):
        for N in (1, M - 1, 400):
            k = len(cases)
            B = 5 if k % 2 == 0 else 1
            params = EDGE_PARAMS[k % len(EDGE_PARAMS)]
            cases.append((f"M={M} N={N} B={B} params={params}", codes((B, M)), codes((B, N)),
                          params))
    query = codes((1, 2047))
    seg = query[0, 850:1150]
    ref = codes((1, 400))
    ref[0, 50:348] = np.concatenate([seg[:141], seg[143:]])  # query rows 992-993 left out
    cases.append(("one alignment across the strips, a gap down rows 992-993", query, ref,
                  EDGE_PARAMS[0]))
    for b in (992, 1023):
        for label, x_end in (("the later strip's diagonal first", 300), ("one diagonal", 108)):
            q = np.ones((1, 1100), np.int32)
            q[0, b - 8 : b] = 3
            q[0, b : b + 8] = 4
            r = np.full((1, 400), 2, np.int32)
            r[0, 92:100] = 4
            r[0, x_end - 8 : x_end] = 3
            cases.append((f"tie across rows {b}/{b + 1}: {label}", q, r, EDGE_PARAMS[0]))
    return cases


MAX_ROWS = 1023  # query rows one launch of K5 takes (csrc/sw.cu kMaxRows)
STRIP_ROWS = 992  # rows of each strip but the last of a longer query (kStripRows)


def sw_strips(M: int):
    """The (first row, rows) of each launch of K5 for a query of M rows: one
    for M <= MAX_ROWS, else strips of STRIP_ROWS and the rest last."""
    if M <= MAX_ROWS:
        return [(0, M)]
    return [(i0, min(STRIP_ROWS, M - i0)) for i0 in range(0, M, STRIP_ROWS)]


def sw_wavefront(queries, refs, match, mismatch, gap_open, gap_extend):
    """Same arguments and outputs as `sw_wavefront_plain`: the CUDA kernel K5
    on CUDA tensors, the plain version on CPU tensors.  On CUDA a query of M
    rows runs as the launches of `sw_strips(M)`, in order, each strip taking
    the H and E of the row above it from the one before through a carry
    buffer (two [2, B, N] int32 buffers in turn)."""
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
    best, qend, rend = (torch.empty(B, dtype=torch.int32, device=dev) for _ in range(3))
    strips = sw_strips(M)
    carry = torch.empty((2, 2, B, N), dtype=torch.int32, device=dev) if len(strips) > 1 else None
    for k, (i0, rows) in enumerate(strips):
        kernels.launch(
            "sw_wavefront", dev, kernels.lib().siga_sw_wavefront,
            queries.data_ptr(), refs.data_ptr(), B, M, N,
            match, mismatch, gap_open, gap_extend, i0, rows,
            carry[(k - 1) % 2].data_ptr() if k > 0 else None,
            carry[k % 2].data_ptr() if k < len(strips) - 1 else None,
            best.data_ptr(), qend.data_ptr(), rend.data_ptr(),
        )
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
