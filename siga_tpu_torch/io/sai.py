"""`.sai` suffix-array index file (text).

Byte-compatible with the reference SAWriter/SAReader
(reference src/suffix_array.cpp:7-101): magic 0xCACA streamed in decimal
("51914"), then the header writes the *string count twice* (the reference
passes sa.strings() for both the strings and elems slots,
src/suffix_array.cpp:17), then one "i j" line per full elem (j is always 0).
The elems are the lexicographic-rank -> read-id permutation of whole-read
suffixes.
"""
from __future__ import annotations

from typing import IO, Tuple

import numpy as np

FILE_MAGIC = 0xCACA  # printed as decimal 51914


def write_sai(stream: IO, perm: np.ndarray, num_strings: int) -> None:
    stream.write(f"{FILE_MAGIC}\n")
    stream.write(f"{num_strings}\n{num_strings}\n")
    # one line per full elem, offset always 0
    out = "\n".join(f"{int(i)} 0" for i in perm)
    if len(perm):
        stream.write(out + "\n")


def save_sai(path: str, perm: np.ndarray, num_strings: int) -> None:
    with open(path, "w") as stream:
        write_sai(stream, perm, num_strings)


def read_sai(stream: IO) -> Tuple[np.ndarray, int]:
    """Returns (perm, num_strings)."""
    tokens = stream.read().split()
    if not tokens or int(tokens[0]) != FILE_MAGIC:
        raise ValueError("bad .sai magic")
    num_strings = int(tokens[1])
    num_elems = int(tokens[2])
    vals = np.array(tokens[3 : 3 + 2 * num_elems], dtype=np.int64).reshape(-1, 2)
    return vals[:, 0].copy(), num_strings


def load_sai(path: str) -> Tuple[np.ndarray, int]:
    with open(path, "r") as stream:
        return read_sai(stream)
