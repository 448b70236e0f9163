"""Inputs of every cell, made from a configuration's sizes and the run's seed.

One general generator: a genome drawn uniformly at random, then a read set
(reads of one length at uniform positions, half of them
reverse-complemented).  Sequences are rank codes (uint8, A=1, C=2, G=3,
T=4; '$' = 0 in a text), the alphabet of the port's index.

Every seed gives the same sizes: the read count and length are functions
of the configuration alone; the seed only draws the genome, the positions
and the strands.  So two seeds differ in what is computed, never in how
much.
"""
from __future__ import annotations

import numpy as np


def rng(seed: int, stream: int) -> np.random.Generator:
    """The generator of one stream of a run's seed (any integer >= 0)."""
    return np.random.default_rng([int(seed), int(stream)])


def genome(config: dict, seed: int) -> np.ndarray:
    """The genome (ranks 1-4, uint8 [genome_bp])."""
    return rng(seed, 0).integers(1, 5, int(config["genome_bp"]), dtype=np.uint8)


def read_count(config: dict) -> int:
    """Reads of the configuration: genome x depth / read length, rounded."""
    return int(round(config["genome_bp"] * config["depth"] / config["read_length"]))


def reads(config: dict, seed: int) -> np.ndarray:
    """Error-free reads (uint8 [reads, read_length], ranks 1-4) at uniform
    positions of the seed's genome, half of them reverse-complemented."""
    g = genome(config, seed)
    n, length = read_count(config), int(config["read_length"])
    r = rng(seed, 1)
    starts = r.integers(0, g.size - length + 1, n)
    out = g[starts[:, None] + np.arange(length)]
    flip = r.permutation(n)[: n // 2]
    out[flip] = 5 - out[flip, ::-1]
    return out


def text(rows: np.ndarray, reverse: bool = False) -> np.ndarray:
    """The rank text of equal-length reads: each read (reversed, plainly,
    for the reverse index) followed by '$' (0)."""
    n, length = rows.shape
    out = np.zeros((n, length + 1), dtype=np.uint8)
    out[:, :length] = rows[:, ::-1] if reverse else rows
    return out.reshape(-1)

