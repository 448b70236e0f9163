"""`.bwt` run-length-encoded binary BWT file.

Byte-compatible with the reference BWTWriter/BWTReader
(reference src/bwt.cpp:59-178): little-endian u16 magic 0xCACA,
u64 num_strings, u64 num_suffixes, u64 num_runs, u32 flag (BWF_NOFMI=0), then
one byte per run.  Run byte layout (src/rlstring.h:10-13):
bits 0-4 count (1..31), bits 5-7 symbol rank ($=0 A=1 C=2 G=3 T=4).
"""
from __future__ import annotations

import struct
from typing import Tuple

import numpy as np

BWT_FILE_MAGIC = 0xCACA
BWF_NOFMI = 0
RL_FULL_COUNT = 31

_HEADER = struct.Struct("<HQQQI")


def rle_encode(codes: np.ndarray) -> np.ndarray:
    """Rank codes (uint8, values 0..4) -> RLE unit bytes, runs capped at 31."""
    codes = np.asarray(codes, dtype=np.uint8)
    n = codes.size
    if n == 0:
        return np.zeros(0, dtype=np.uint8)
    # boundaries of equal-symbol runs
    change = np.flatnonzero(codes[1:] != codes[:-1]) + 1
    starts = np.concatenate(([0], change))
    ends = np.concatenate((change, [n]))
    lengths = ends - starts
    symbols = codes[starts]
    # split runs longer than 31 into ceil(L/31) units
    nunits = (lengths + RL_FULL_COUNT - 1) // RL_FULL_COUNT
    total = int(nunits.sum())
    unit_sym = np.repeat(symbols, nunits)
    # per-unit count: 31 for all but the last unit of each run
    unit_count = np.full(total, RL_FULL_COUNT, dtype=np.int64)
    last_idx = np.cumsum(nunits) - 1
    rem = lengths - (nunits - 1) * RL_FULL_COUNT
    unit_count[last_idx] = rem
    return ((unit_sym.astype(np.uint8) << 5) | unit_count.astype(np.uint8)).astype(
        np.uint8
    )


def rle_decode(units: np.ndarray) -> np.ndarray:
    """RLE unit bytes -> rank codes (uint8)."""
    units = np.asarray(units, dtype=np.uint8)
    counts = (units & 0x1F).astype(np.int64)
    symbols = (units >> 5).astype(np.uint8)
    return np.repeat(symbols, counts)


def save_bwt(path: str, codes: np.ndarray, num_strings: int) -> None:
    """Write rank codes of the full BWT to a `.bwt` file."""
    runs = rle_encode(codes)
    with open(path, "wb") as out:
        out.write(
            _HEADER.pack(
                BWT_FILE_MAGIC, num_strings, int(codes.size), int(runs.size), BWF_NOFMI
            )
        )
        out.write(runs.tobytes())


def load_bwt(path: str) -> Tuple[np.ndarray, int, int]:
    """Read a `.bwt` file -> (rank codes, num_strings, num_suffixes)."""
    with open(path, "rb") as stream:
        hdr = stream.read(_HEADER.size)
        magic, num_strings, num_suffixes, num_runs, _flag = _HEADER.unpack(hdr)
        if magic != BWT_FILE_MAGIC:
            raise ValueError("bad .bwt magic")
        runs = np.frombuffer(stream.read(num_runs), dtype=np.uint8)
    codes = rle_decode(runs)
    if codes.size != num_suffixes:
        raise ValueError("corrupt .bwt: run lengths do not sum to num_suffixes")
    return codes, int(num_strings), int(num_suffixes)
