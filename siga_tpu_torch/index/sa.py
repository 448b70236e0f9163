"""Host suffix-array build of the read set (the `-a host` index builder).

Re-homed from `siga_tpu/index/sa.py`, whose module imports jax when it
loads.  The order is the reference's multi-string suffix order ('$'
sentinels ranked by text position, `siga_tpu/index/sa.py:1-23`); the BWT and
the `.sai` permutation derive from it.  The suffix sort itself is the shared
C++ seed-sort; the device suffix sort of the JAX package (`_sa_build_v3`) is
not ported yet.
"""
from __future__ import annotations

from typing import Sequence, Tuple

import numpy as np

from siga_tpu import native
from siga_tpu.core import dna

from ..device import native_lib


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


def build_index_arrays(seqs: Sequence[str]) -> Tuple[np.ndarray, np.ndarray, int]:
    """(bwt_codes, sai_perm, num_strings) for one read set."""
    codes, starts, _lengths = concat_reads(seqs)
    sa = suffix_array_host(codes)
    return bwt_from_sa(codes, sa), sai_perm_from_sa(sa, starts), len(seqs)
