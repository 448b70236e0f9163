#!/usr/bin/env python3
"""Run the PyTorch/CUDA port's main path once on one NVIDIA GPU and check it.

    python3 chip_smoke.py [--keep-pipeline DIR]

Every `DualScanner.dispatch` of this process (the engine's, rmdup's, the
sharded scan's) runs under torch.cuda.set_sync_debug_mode("error"): a
dispatch that waits on the card fails the run (`ScanWatch`).

Phases (any failure raises and exits non-zero; nothing is caught):
  1. the card: nvidia-smi name and power limit; CUDA must be available;
  2. build the hand-written kernels (csrc/*.cu, one nvcc per source for
     sm_90a, all started together; each kernel's registers, stack frame and
     spills as `-Xptxas -v` reports them) and the shared C++ runtime for
     this host;
  3. simulate the 1 Mb x 25x read set (166,667 error-free 150 bp reads from
     both strands of a random genome, fixed seed);
  4. the main path, with the kernels' launch counts reset just before it:
     `index` (the device suffix sort, -a sais2 on cuda, the default: every
     K6 kernel must launch in both directions; its peak device memory
     against the sort's estimate) -> `overlap -m 45`
     through siga_tpu_torch.cli (the plane build K2 must launch once a
     direction; one host wait and one copy back a chunk, and the ASQG's
     digest that of the engine of commit c761036, which scanned one chunk
     at a time), then the found edges scored with Smith-Waterman through
     BatchAligner (an exact overlap of length k must score 2k); every read
     must have its VT record;
  5. the overlap engine alone, warm (its wall and the process's user and
     system CPU time), and the stacked pair plane and K of both directions
     (built by K2) against the C++ host packing; the cost of
     `pack_reads_2bit`'s ACGT guard on one chunk; the engine with chunks in
     flight at each of ENGINE_SETTINGS in turn (LOOKAHEAD 8 and 1, 1 and 2
     B/C workers), a warm-up pass and a timed one each: wall, reads/s, user
     and system CPU, peak device memory, host waits and copies back a
     chunk (one, where no budget overflowed), every hit equal; the first
     chunk through dispatch/collect in three lane parts, with budgets that
     fit and with a row budget that overflows, its views equal one
     launch's; then the engine with each chunk's reads split over the
     device list [cuda:0, cuda:0] (`parallel/dist.py`, two shards on one
     card): every hit equal;
  6. `overlap -m 45` with SIGA_PAIR_STEP=0, counts reset just before it: the
     single-step scan K3 launches once a chunk, K1 and K2 never (each plane
     is built at its first use), and the ASQG equals the default route's;
  7. each kernel against its plain PyTorch version on the card, bit for bit:
     the K1 scan on the first full 15,152-read chunk (odd lim_t; timed,
     with its bound; and split over several launches by a small slab
     budget), on a
     chunk of 149 bp reads (even lim_t) and on the rmdup lane groups; K5 at
     B=4096, query 150, ref 400 (timed, with its bound), 16 of those pairs
     against a naive DP, on the main path's 4,096 sampled edges (timed), on
     every case of `sw.sw_edge_cases` (queries up to 3,000, in strips past
     1,023) and at 4,096 x 1,500 x 400 (two strips; timed);
     K2's plane and K on both directions of the main path's index and of
     every read set of `plane_edge_reads` (the CPU tests' texts, indexed
     on the card), each also built 3 times in a row and once on a second
     stream beside one on the first, all equal to the first build;
  8. the hits of 256 sampled reads, from the command's hits file and from
     the engine, against the shared host engine (OverlapBuilder.overlap);
  9. `index -a host` (the C++ seed-sort) on the same reads: all four files
     byte-equal to the device build's; then K6 (`index/sa.py`, the kernels
     of `csrc/suffix_sort.cu` around torch.sort) on the main path's forward
     text and on every text of `sa_edge_reads`: its SA, BWT and permutation
     equal to the all-torch route's (`suffix_array_plain`,
     `bwt_perm_plain`) bit for bit, and each step's kernel equal to its
     plain version on the same inputs (timed at the main path's shape
     beside its bytes bound and its plain version); the device index's
     layers timed alone for one direction (text build, sort, sort + BWT +
     perm) beside K6's loose bound, the launches of each K6 wrapper and the
     host synchronisations of one build (none), and in a process of its own
     (`trace_index`) K6's warm walls, a torch.profiler trace of the sort
     (device time, operations, torch.sort's share and the digit passes of
     each of its calls) beside the bound of the passes this design runs,
     and its peak memory against `SORT_BYTES_PER_CHAR`; then the
     distributed index build (K8, `parallel/dist_build.py`: torch.sort
     passes, around them K6's kernels and the four of `csrc/dist_sort.cu`)
     of the same forward text split into D = 2 and 4 segments on [cuda:0] *
     D, counts reset just before (each kernel of its route must launch):
     its suffix array equal to K6's, its BWT and permutation equal to K6's
     and to reads.bwt / reads.sai; its warm wall (3 builds in turn with
     K6's); each of its steps' kernels against its plain version on the same
     inputs (timed at D = 2 beside its bytes bound), there and on every text
     of `sa_edge_reads` at D = 2, 4 and 8 (the route equal to K6's); and in
     a process of its own (`trace_dist`) its device time beside K6's,
     operations, torch.sort's share and full-length digit passes, the bound
     of this design (passes, kernels, bytes moved between entries), its host
     synchronisations (`sync_sites`, equal to the build's own count) and
     its peak memory against the memory check's estimate;
 10. `rmdup` on the card, counts reset just before it: K1 must launch (and
     K2 once a direction), the
     hits of 256 sampled reads equal the host engine's
     (OverlapBuilder.duplicate), and kept + duplicates = reads, one host
     wait and one copy back a chunk, its three files' digests those of the
     engine of commit c761036; then `rmdup`
     with SIGA_PAIR_STEP=0, counts reset just before it: K3 once a chunk,
     K1 and K2 never, its three files equal the default route's;
 11. the gather probes' CLI on the stacked pair plane, counts reset just
     before it (G1-G4 must launch, K2 once a direction), then each probe
     kernel against its plain
     version bit for bit at every Pallas probe's own shape and on the pair
     plane (60,608 random rows, one overlap chunk's lanes), each with its
     bound and, for G1, G2 and G4, the one PyTorch call that computes the
     same (index_select, gather, x * 2), G2 and G4 timed in turn with it
     over 5 rounds (median, min-max, share of the bound); G1, G2 and G4 at
     the edge shapes of `gather.edge_cases` (tails, x[1:], one row or output,
     rows of 1, 57 and 128 words, planes off the 16-byte boundary, rows
     wider than shared memory, every form, broadcast indexes) and G3's
     mode sum at those of its rows (both forms, lane counts no group
     divides; every group G); G3's mode sum with each G at k_scan's shape
     and on the pair plane, beside the G `gather.chain_plan` picks and the
     plane's row traffic; G3 with
     32 chains of single-word gathers gives the L2 round trip of one
     dependent step, and over a 4 KB table the L1's (k_d's chain bound at
     both); the launch floor (an empty kernel, timed as the kernels are);
     and G1's device-side range assert in a child process;
     then K9 (the stage-A scan with '$'-probes) against its plain version,
     bit for bit in all four outputs, at 60,608 ID lanes x 149 steps of the
     main path's reads (timed beside its bytes and chain bounds) and on
     every case of `stage_a_edge_cases`;
 12. K3 against its plain version, bit for bit, on the first full chunk
     (60,608 lanes; timed, with its bounds; split over several launches by
     a small slab budget), on the rmdup lane groups and on every case of
     `scan_edge_cases` (the indexes of `plane_edge_reads`: odd lane counts,
     reads of 1 and 2 symbols and of the bucket's width, padding lanes, -m
     above the reads, intervals at the plane's first and last rows, a slab
     split); the chunk's views
     through K3 equal K1's; then the index-sharded scan (K3 reading its rows
     through a table of D row shards of the 25.2 MB stacked single-step
     plane, D = 2 and 4 separate allocations on [cuda:0] * D): against its
     plain version bit for bit on the rmdup lane groups and every case of
     `scan_edge_cases` (and for D = 2 at the first chunk), its views at the
     first chunk equal K3's, its wrapper
     timed in turn with K3's beside the bounds; then the compile-check
     entry (`dryrun.entry`) on cuda:0 and the dry run
     (`siga_tpu_torch/dryrun.py`) over [cuda:0] * 4, counts reset just
     before them (K9 and the sharded scan must launch); then K1, K3 and the
     sharded scan (D = 2, 4) at that chunk in a process of their own, each
     wrapper call split by a torch.profiler trace into the scan kernel's
     device time and the compaction's, beside its wall by CUDA events (5
     calls in turn with the others), and K3's device time as a share of its
     chain bound (151 dependent row reads at G3's step), and in that
     process K9's kernel device time at its 60,608 lanes by torch.profiler;
 13. the pipeline: the `benchmark/ecoli_scale.py 1.0 25 0.005` read set
     (its genome and generator), its eleven stages (PIPE_STAGES) through
     `python -m siga_tpu_torch ... --device cuda`, each in a fresh process
     with a time limit, then `benchmark/contigs_mapping.py`: the corrected
     read count and the contig facts must equal BASELINE.md's; each stage's
     wall and kernel launches are printed (K1 must launch in every overlap
     and rmdup stage, and K2 at least twice);
 14. K1 against its plain version, bit for bit, at the pipeline's shapes
     with the `--no-opposite-strand` lane groups: the first chunk of
     `reads.ec.fa` at -m 85, and all contigs in one length-sorted chunk at
     -m 10; each timed beside its bounds; at the contigs K3's views equal
     K1's and K3 is timed beside its bounds, and the sharded scan's views
     (D = 2, 4 on [cuda:0] * D) equal K3's, its time per step beside K3's;
 15. `correct` of every 8th preprocessed read against the whole read set's
     index (K7 and K2 must launch): its records must equal those reads' records in
     the pipeline's `reads.ec.fa`; the k-mers a launch held on average;
 16. K7 against its plain version on that index's forward plane, bit for
     bit, on 262,144 41-mers (drawn from the reads, one
     base substituted, an N), 300 of them also against
     `FMIndex.occurrences`, timed with its bound; then at the `correct`
     route's sizes, 3 and 110 41-mers: equal to plain, timed per launch on
     the card and per `KmerCounter` call on the wall clock;
 17. the plane build (K2) for one direction of the main path's index, in a
     process of its own, the kernel against its plain version: each one's
     device time and operations
     from a torch.profiler trace of one build (device spans summed), its wall
     by CUDA events over 5 builds in turn with the other (median, min-max),
     its peak device memory, and the bound; beside it the codes' copy to the
     card and DualScanner's stacking copy; last of the timings, so that the
     traces touch no other;
 18. `overlap` as two `--process-id` workers at once on the card plus
     `--merge-only -t 2` (the port's launcher) against one `-t 2` process:
     the ASQG must be equal;
 19. the whole script's seconds, the kernels' JSON line (each kernel's
     launches summed over the paths above, each path's counts read from its
     own run; its time at the shape named above; `bound_ms` from this run's
     inputs, by bytes at 3.35 TB/s or operations at 67e12/s), after the
     dispatches made under the sync check, by scan kernel (K1, K3 and the
     sharded K3 must each have some), then the device line last.
With --keep-pipeline DIR the pipeline runs in DIR (a new directory) and
stays there, for `python3 -m siga_tpu_torch.probes.kernel_ab`.
Imports nothing of JAX and nothing of the JAX package `siga_tpu`.
"""
import argparse
import functools
import gzip
import hashlib
import json
import os
import re
import resource
import shutil
import subprocess
import sys
import tempfile
import time
import warnings

import numpy as np
import torch

from siga_tpu_torch import cli, dryrun, kernels
from siga_tpu_torch.device import native_lib
from siga_tpu_torch.index import sa as sa_mod
from siga_tpu_torch.index.fm import FMIndex
from siga_tpu_torch.io import fastx
from siga_tpu_torch.io.bwtio import load_bwt
from siga_tpu_torch.io.sai import load_sai
from siga_tpu_torch.io.fastx import DNASeq
from siga_tpu_torch.ops import fm_device, kmer_count, search, sw
from siga_tpu_torch.overlap.builder import Hit, OverlapBuilder
from siga_tpu_torch.parallel import dist, dist_build, multihost
from siga_tpu_torch.probes import gather
from siga_tpu_torch.probes.kernel_ab import SA_REPS as SA_WALLS
from siga_tpu_torch.probes.kernel_ab import (dist_readings, host_walls, kernel_spans, library_call,
                                             sa_readings, single_scan_args, sort_readings,
                                             sw_edge_pairs, sw_synthetic_pairs, sw_tensors,
                                             trace_device)

SEED = 1
GENOME = 1_000_000
COVERAGE = 25
READ_LEN = 150
MIN_OVERLAP = 45
SW_PARAMS = (2, 2, 3, 1)
FWD_REV = ((fm_device.GROUP_ID, fm_device.GROUP_RC), (fm_device.GROUP_REV, fm_device.GROUP_COMP))
RMDUP = ((fm_device.GROUP_ID,), (fm_device.GROUP_COMP,))
INDEX_FILES = ("sai", "bwt", "rsai", "rbwt")
PROBE_LANES = 60608  # lanes of one overlap chunk (15,152 reads x 4 orientations)
PROBE_STEPS = 150
PROBE_ROUNDS = 5  # G2 and G4 timed in turn with their library call, this many rounds
ELEM_TILES = (256, 512, 1024)  # G3 mode elem's shared tiles timed at k_d's shape
PLANE_ROUNDS = 5  # K2 and its plain version timed in turn, this many builds each
PLANE_REPEATS = 3  # K2 rebuilt this many times in a row, each equal to the first
SCAN_ROUNDS = 5  # K1, K3 and the sharded scan timed in turn and traced, this many calls each
SHARDS = (2, 4)  # the index-sharded scan's shard counts, D allocations on cuda:0 each
SEGMENTS = (2, 4)  # the distributed index build's entries, [cuda:0] * D each
DIST_ROUNDS = 3  # distributed builds timed in turn with K6's bwt_perm_device
SA_REPS, SA_PLAIN_REPS = 20, 3  # calls of a K6 or K8 kernel, of its plain version, a timing
# the step each K6 kernel's JSON row times at the main path's shape
SA_TIMED = {"sa_seed_keys": "sa_seed_keys", "sa_gather": "sa_gather, key_a",
            "sa_seed_ranks": "sa_seed_ranks", "sa_round_keys": "sa_round_keys",
            "sa_round_scatter": "sa_round_scatter", "sa_bwt_perm": "sa_bwt_perm"}
# the step each K8 kernel's JSON row times at the main path's shape (D = 2)
DIST_TIMED = {"dist_levels": "dist_levels, seed", "dist_bounds": "dist_bounds",
              "dist_merge": "dist_merge", "dist_number": "dist_number"}
DIST_K6 = ("sa_seed_keys", "sa_gather", "sa_round_keys")  # K6's kernels that K8 runs
REPO = os.path.dirname(os.path.abspath(__file__))
CHILD_ENV = {**os.environ, "PYTHONPATH": os.pathsep.join(
    p for p in (REPO, os.environ.get("PYTHONPATH")) if p)}
STAGE_TIMEOUT = 600  # seconds; a stage that runs longer fails the run
# benchmark/ecoli_scale.py 1.0 25 0.005 and its result (BASELINE.md:66-73)
PIPE_GENOME = 1_000_000
PIPE_COVERAGE = 25
PIPE_ERR = 0.005
PIPE_FACTS = {
    "reads_corrected": 166_638, "contig_number": 213, "matched_contig": 213,
    "unmatched_contig": 0, "N50": 8505, "N90": 2085, "MAX_contig": 39_173,
    "genome_covered": 999_189,
}
# The stages of benchmark/ecoli_scale.py (the MiSeq recipe's parameters:
# correction k = 41, minimum overlap 85, assembly overlap 111, branch trim
# 150), each the argument list of one command, run where the reads lie.
PIPE_STAGES = (
    ("preprocess", ["preprocess", "--pe-mode=1", "--pe-orientation=ff", "--no-primer-check",
                    "-o", "reads.pp.fastq", "{r1}", "{r2}"]),
    ("index_pp", ["index", "--no-reverse", "-p", "reads.pp", "reads.pp.fastq"]),
    ("correct", ["correct", "-k", "41", "-p", "reads.pp", "-o", "reads.ec.fa", "reads.pp.fastq"]),
    ("index_ec", ["index", "-p", "reads.ec", "reads.ec.fa"]),
    ("overlap", ["overlap", "-m", "85", "--no-opposite-strand", "-p", "reads.ec", "reads.ec.fa"]),
    ("assemble_pe", ["assemble", "-m", "111", "--pe-mode=1", "--max-distance=100",
                     "--min-branch-length", "150", "-p", "primary", "reads.ec.asqg.gz"]),
    ("index_ctg", ["index", "-p", "primary-contigs", "primary-contigs.fa"]),
    ("rmdup", ["rmdup", "-p", "primary-contigs", "primary-contigs.fa"]),
    ("index_rmdup", ["index", "-p", "primary-contigs.rmdup", "primary-contigs.rmdup.fa"]),
    ("overlap_ctg", ["overlap", "-m", "10", "--no-opposite-strand", "-p", "primary-contigs.rmdup",
                     "primary-contigs.rmdup.fa"]),
    ("assemble_final", ["assemble", "-m", "111", "--pe-mode=0", "--min-branch-length", "150",
                        "-p", "final", "primary-contigs.rmdup.asqg.gz"]),
)
READS_MIN_OVERLAP = 85  # the overlap stage's -m
CTG_MIN_OVERLAP = 10  # the overlap_ctg stage's -m
K7_K = 41
K7_QUERIES = 262_144
K7_ROUTE_SIZES = (3, 110)  # k-mers a call of `correct`'s K7 route holds: a weak base, a read
# The bounds (H100 SXM datasheet peaks): device memory
# rate, and the float32 rate outside the tensor cores as the rate of the
# scalar integer operations of K5.
HBM_BYTES_PER_S = 3.35e12
SCALAR_OPS_PER_S = 67e12
SW_OPS_PER_CELL = 11  # E and F: 2 subtractions + 1 max each; H: 1 add + 3 max; best: 1 max
ROW_BYTES = fm_device.PAIR_COLS * 4
# the bytes of a pair-plane row that an occ query at a uniformly random
# position needs: 25 checkpoints (100 B) + 4 bit planes x 4.44 words
ROW_NEED_BYTES = 171
# a single-step row: its two 32-byte halves (symbols; '$' masks and
# checkpoints) are both needed by almost every query
SINGLE_ROW_BYTES = fm_device.SINGLE_COLS * 4
EDGE_SCAN_LEN = 100  # an edge index's reads are scanned this far, so the plain scans stay quick
SPLIT_SLAB_BYTES = 64 * 1024  # splits the 2,049-lane edge case over several launches


def bytes_ms(n_bytes) -> float:
    return n_bytes / HBM_BYTES_PER_S * 1e3


def live_supersteps(lens, lim_t, n_groups):
    """Per lane (group-major, as K1 lays lanes out) the supersteps a read of
    each length runs: those with t <= len - 2, at most (lim_t + 1) // 2."""
    lens = np.asarray(lens, dtype=np.int64)
    live = np.where(lens >= 2, (lens - 2) // 2 + 1, 0)
    return np.tile(np.minimum(live, (lim_t + 1) // 2), n_groups)


def live_steps(lens, lim_t, n_groups):
    """Per lane (group-major, as K3 lays lanes out) the single steps a read
    of each length runs: those with t <= len - 2, at most lim_t."""
    lens = np.asarray(lens, dtype=np.int64)
    return np.tile(np.minimum(np.maximum(lens - 1, 0), lim_t), n_groups)


def scan_bound(lens, lim_t, n_groups, nblocks, wpr, emitted, single=False):
    """The bound in bytes of one scan of these reads, K1's (pair steps) or
    with `single` K3's: the plane rows it needs (two a live step, five a
    lane to open and close; each row counted at most once, so at most the
    stacked plane), the packed reads in, the emitted rows, counts and finals
    out.  Also returns the row reads the scan needs with re-reads counted
    (the L2 traffic), in bytes."""
    if single:
        live, need, row = live_steps(lens, lim_t, n_groups), SINGLE_ROW_BYTES, SINGLE_ROW_BYTES
    else:
        live, need, row = live_supersteps(lens, lim_t, n_groups), ROW_NEED_BYTES, ROW_BYTES
    lanes = live.size
    row_reads = 2 * int(live.sum()) + 5 * lanes
    plane = min(row_reads * need, 2 * nblocks * row)
    io = len(lens) * (wpr + 1) * 4 + emitted * 16 + lanes * 24 + 2 * (-(-lanes // 32)) * 4
    return bytes_ms(plane + io), row_reads * need


def stage_a_bound(nblocks, step_ns, lanes=PROBE_LANES, steps=READ_LEN - 1):
    """The bound of the stage-A scan with '$'-probes (K9, port of
    `siga_tpu/ops/fm_device.py::_scan_stage_a`) at one overlap chunk's
    shape, from its code: bytes (the int32
    chars [lanes, steps + 1] and lens read, the [steps, lanes, 3] int32
    emissions and [steps, lanes] validity written, the final [lanes, 8] and
    lext [lanes, 5] int32 written, each single-step plane row of 64 B read
    at most once) and the chain of its steps + 2 dependent occ row reads a
    lane at this run's L2 round trip.  Returns (bytes ms, chain ms)."""
    n_bytes = (lanes * (steps + 1) * 4 + lanes * 4 + steps * lanes * (12 + 1)
               + lanes * (8 + 5) * 4 + nblocks * 16 * 4)
    return bytes_ms(n_bytes), (steps + 2) * step_ns / 1e6


def plane_edge_reads(seed: int = 0) -> dict:
    """Read sets whose BWT texts (n = the reads' lengths + one '$' each) meet
    the plane build's edges: one block, n = 0, 1 and 127 (mod 128), one
    read, a homopolymer and a text with no T (C[c] = n for the absent
    symbols, so K reads the last, partial block), mixed lengths, and texts
    over several of K2's tiles (64 plane rows; 128 for the labels' counts):
    one ending on a tile's edge, a
    homopolymer and a text with no T (empty runs in every tile), one whose
    C[3] is a tile's first row, and one whose first tile's four runs start
    at odd bytes and whose last run ends at n (n not a multiple of 16).
    {label: reads}, from `seed`; the CPU tests and `chip_smoke.py` build
    both from them."""
    rng = np.random.default_rng(seed)
    genome = np.frombuffer(b"ACGT", dtype=np.uint8)[rng.integers(0, 4, 60_000)]

    def reads(lengths, alphabet=4):
        out = []
        for length in lengths:
            s = int(rng.integers(0, genome.size - length))
            read = genome[s : s + length]
            if alphabet < 4:
                read = np.frombuffer(b"ACGT", dtype=np.uint8)[rng.integers(0, alphabet, length)]
            out.append(read.tobytes().decode())
        return out

    def recount(rs, base, other, target):
        """rs with bases turned into `base` (or `base` into `other`), first
        read first, until #reads + #bases in "ACGT" up to `base` == target:
        then C of the next symbol is target."""
        low = "ACGT"[: "ACGT".index(base) + 1]
        chars = [list(r) for r in rs]
        have = len(rs) + sum(ch in low for r in chars for ch in r)
        for r in chars:
            for i, ch in enumerate(r):
                if have < target and ch not in low:
                    r[i], have = base, have + 1
                elif have > target and ch == base:
                    r[i], have = other, have - 1
        assert have == target
        return ["".join(r) for r in chars]

    def odd_starts(rs):
        """rs (an odd number of reads) with #A, #C and #G made even, so that
        C[1..4], the first tile's run starts, are all odd."""
        chars = [list(r) for r in rs]
        for base in "ACG":
            if sum(r.count(base) for r in chars) % 2:
                r = next(r for r in chars if base in r)
                r[r.index(base)] = "T"
        return ["".join(r) for r in chars]

    return {
        "one block (n 73)": reads([30, 41]),
        "n 384 (0 mod 128)": reads([100, 120, 161]),
        "n 385 (1 mod 128)": reads([100, 120, 162]),
        "n 383 (127 mod 128)": reads([100, 120, 160]),
        "one read (n 701)": reads([700]),
        "homopolymer (n 301)": ["A" * 300],
        "no T (n 455)": reads([90] * 5, alphabet=3),
        "mixed lengths": reads(rng.integers(20, 300, 40).tolist()),
        "one tile exactly (n 16,384)": reads([127] * 128),
        "three tiles (n 45,300)": reads([150] * 300),
        "homopolymer over several tiles (n 40,004)": ["A" * 10_000] * 4,
        "no T over several tiles (n 40,400)": reads([100] * 400, alphabet=3),
        "C[3] on a tile's first row (n 30,200)": recount(reads([150] * 200), "C", "G", 16_384),
        "odd run starts, a run ends at n (n 36,421)": odd_starts(reads([120] * 301)),
    }


def scan_edge_cases() -> list:
    """K3's and the sharded K3's edge cases over the indexes of
    `plane_edge_reads()`: (label, index label, reads, n, (forward, reverse)
    lane groups, min_overlap, slab_bytes or None), n >= len(reads) the lane
    bucket (rows past the reads are padding lanes).  Every index's own
    reads, cut to EDGE_SCAN_LEN symbols, with the overlap groups at -m 5 and
    with the rmdup groups at a -m above every read: among them the
    homopolymers (intervals from the first rows of a table) and "n 384 (0
    mod 128)", whose full intervals reach the plane's last row with an
    empty block prefix.  On the 300 reads of "three tiles": 1, 31 and 33
    lanes (one group), 2,049 (683 reads x ID, RC | REV; neither a multiple
    of a warp's lanes nor of a block's), the same split over launches by a
    slab budget of SPLIT_SLAB_BYTES, and reads of 1 and 2 symbols and of the
    bucket's 160 beside 5 padding lanes.  The CPU tests hold the plain
    versions to the JAX package on these cases; `chip_smoke.py` holds the
    kernels to the plain versions."""
    edges = plane_edge_reads()
    cases = []
    for label, reads in edges.items():
        cut = [r[:EDGE_SCAN_LEN] for r in reads]
        longest = max(map(len, cut))
        cases.append((f"{label}, overlap groups, -m 5", label, cut, len(cut), FWD_REV, 5, None))
        cases.append((f"{label}, rmdup groups, -m {longest + 3}", label, cut, len(cut), RMDUP,
                      longest + 3, None))
    three_label = "three tiles (n 45,300)"
    three = edges[three_label]
    for nl in (1, 31, 33):
        cases.append((f"{nl} lanes", three_label, three[:nl], nl, ((fm_device.GROUP_ID,), ()),
                      20, None))
    pick = [three[i] for i in np.random.default_rng(0).integers(0, len(three), 683)]
    mixed = ((fm_device.GROUP_ID, fm_device.GROUP_RC), (fm_device.GROUP_REV,))
    cases.append(("2,049 lanes", three_label, pick, len(pick), mixed, 30, None))
    cases.append(("2,049 lanes, slabs split over launches", three_label, pick, len(pick), mixed,
                  30, SPLIT_SLAB_BYTES))
    short = ["A", "CG", three[0] + three[1][:10]] + three[2:40]
    cases.append(("reads of 1, 2 and 160 symbols, 5 padding lanes", three_label, short,
                  len(short) + 5, FWD_REV, 10, None))
    return cases


GOLDEN_READS = ["ACGTACGTAC", "CGTACGTACC", "TTACGGACGT", "ACGTACGTAC", "GGGTTTACAC"]
STAGE_A_LANES = PROBE_LANES  # K9 at one overlap chunk's lanes (ID lanes of the main path's reads)


def genome_reads(n, lengths, genome_len, seed=0):
    """n reads of the given lengths (cycled) from one random genome of
    genome_len (seed): reads that overlap, so that a scan emits blocks."""
    rng = np.random.default_rng(seed)
    genome = "".join("ACGT"[c] for c in rng.integers(0, 4, genome_len))
    out = []
    for k in range(n):
        length = lengths[k % len(lengths)]
        start = int(rng.integers(0, genome_len - length + 1))
        out.append(genome[start : start + length])
    return out


def stage_a_index_reads() -> dict:
    """{label: reads} of the indexes K9's edge cases scan: the dry run's tiny
    problems (8 and 16 random reads of 24 bp), the five 10 bp golden reads
    (tests/golden/fixed.*), 64 reads of 100 bp from a 2 kb genome, and 40
    reads of 1-60 bp from a 600 bp genome."""
    return {
        "tiny 8 reads": dryrun.tiny_reads(8),
        "tiny 16 reads": dryrun.tiny_reads(16),
        "golden 5 reads": GOLDEN_READS,
        "64 reads of 100 bp": genome_reads(64, [100], 2000),
        "40 reads of 1-60 bp": genome_reads(40, [1, 2, 60, 17, 3, 45, 59, 30], 600, seed=1),
    }


def stage_a_edge_cases() -> list:
    """K9's edge cases: (label, index label, lanes, tab, max_t or None,
    min_overlap, garbage).  Every index's reads through its forward
    single-step plane (tab "one index") and through the stacked forward and
    reverse planes with the reversed reads as the lanes of the second half
    (tab "stacked": lane_tab 0, then nblocks; a full interval there reaches
    the plane's last row); then on the 1-60 bp reads: random symbols in 0..4
    past l - 2 (`garbage`, with lanes of 1 and 2 symbols), max_t = 0,
    min_overlap 0 and 1, L = 1 and 33, lane_tab nblocks over one index's
    plane (every row index past it, clamped), and an N (rank 0) in every
    lane's live steps; then the edges of K9's warps and blocks (two
    threads a lane: 16 lanes a warp, 32 a block; the tiled design of the
    history had 32 and 64, and steps in tiles of 8) and of its steps: max_t
    of 1, 7, 8 and 9, L of 15, 16, 17, 31, 32, 63, 64 and 65 (warps of
    fewer lanes than the warp holds, runs of `emitted` and `valid` off the
    16-byte boundary), lanes whose last live step (len - 2) falls in each
    of seven spans of 8 steps (one warp's lanes leave its steps at seven
    places), and lanes of 1 symbol beside lanes of 60 across warps.  The
    CPU tests hold the plain version to the JAX package on these;
    `chip_smoke.py` holds K9 to the plain version."""
    index = stage_a_index_reads()
    cases = []
    for label, reads in index.items():
        mo = 5 if label.startswith("golden") else 8
        for tab in ("one index", "stacked"):
            cases.append((f"{label}, {tab}", label, reads, tab, None, mo, False))
    mixed_label = "40 reads of 1-60 bp"
    mixed = index[mixed_label]
    with_n = [r[:1] + "N" + r[2:] if len(r) > 2 else r for r in mixed]
    cases += [
        ("garbage past l - 2, lanes of 1 and 2 symbols", mixed_label, mixed, "stacked", None, 10,
         True),
        ("max_t = 0", mixed_label, mixed, "stacked", 0, 10, False),
        ("min_overlap 0", mixed_label, mixed, "one index", None, 0, False),
        ("min_overlap 1", mixed_label, mixed, "stacked", None, 1, False),
        ("L = 1", mixed_label, mixed[2:3], "one index", None, 5, False),
        ("L = 33", mixed_label, mixed[:33], "one index", None, 5, True),
        ("lane_tab past the plane's last row", mixed_label, mixed, "past", None, 5, False),
        ("an N in the live steps", mixed_label, with_n, "stacked", None, 5, False),
    ]
    long_reads = [r for r in mixed if len(r) == 60]
    cases += [(f"max_t = {t}", mixed_label, mixed, "stacked", t, 1, False) for t in (1, 7, 8, 9)]
    cases += [(f"L = {n}", mixed_label, (mixed * 2)[:n], "one index", None, 3, False)
              for n in (15, 16, 17, 31, 32, 63, 64, 65)]
    cases += [
        ("last live steps in seven spans of 8 steps", mixed_label,
         [r[: 2 + 9 * j] for j in range(7) for r in long_reads[:3]], "stacked", None, 2, False),
        ("lanes of 1 symbol beside lanes of 60", mixed_label,
         [r if k % 3 else r[:1] for k, r in enumerate(long_reads * 14)], "one index", None, 4,
         True),
    ]
    return cases


def stage_a_args(case, fms, dev):
    """The arguments of `fm_device.scan_stage_a` for a case of
    `stage_a_edge_cases` over the DeviceFM pair `fms` (forward, reverse) of
    its index: (max_t, min_overlap, plane, pred, length, chars, lens,
    lane_tab), the tensors on `dev`."""
    _label, _index, lanes, tab, max_t, mo, garbage = case
    n = len(lanes)
    if tab == "stacked":
        lanes = list(lanes) + [s[::-1] for s in lanes]
    chars, lens = dryrun.stage_a_chars(lanes, max_t)
    max_t = chars.shape[1] - 1
    if garbage:
        rng = np.random.default_rng(7)
        past = np.arange(max_t)[None, :] >= np.maximum(lens - 1, 0)[:, None]
        chars[:, :max_t] = np.where(past, rng.integers(0, 5, (len(lanes), max_t)),
                                    chars[:, :max_t])
    nblocks = fms[0].nblocks
    if tab == "stacked":
        plane = torch.cat([fms[0].occ_plane, fms[1].occ_plane]).contiguous()
        lane_tab = torch.tensor([0] * n + [nblocks] * n, dtype=torch.int32, device=dev)
    else:
        plane = fms[0].occ_plane
        lane_tab = (torch.full((n,), nblocks, dtype=torch.int32, device=dev)
                    if tab == "past" else None)
    return (max_t, mo, plane, fms[0].pred_dev, fms[0].length,
            torch.from_numpy(chars).to(dev), torch.from_numpy(lens).to(dev), lane_tab)


def pipeline_stages(r1, r2, device=None):
    """(stage name, argv) of every stage, in order, for the paired read files
    r1 and r2.  With `device`, the port's device commands get `--device`."""
    out = []
    for name, argv in PIPE_STAGES:
        argv = [a.format(r1=r1, r2=r2) for a in argv]
        if device is not None and argv[0] in cli.ON_DEVICE:
            argv[1:1] = ["--device", device]
        out.append((name, argv))
    return out


def phase(name):
    print(f"== {name}", flush=True)


def ptxas_summary(report: str) -> list:
    """One line a kernel from nvcc's `-Xptxas -v` report: its name (for a
    mangled name in a namespace, the name after the namespace), registers,
    stack frame and spills."""
    out, name = [], None
    for line in report.splitlines():
        entry = re.search(r"Compiling entry function '(\w+)'", line)
        if entry:
            name, frame = entry.group(1), "stack frame not reported"
            outer = re.match(r"_ZN(\d+)", name)
            if outer:  # _ZN <namespace> <name> ...: skip the namespace
                rest = name[outer.end() + int(outer.group(1)):]
                inner = re.match(r"(\d+)", rest)
                if inner:
                    name = rest[inner.end() : inner.end() + int(inner.group(1))]
                    args = re.match(r"I((?:L[ib]\d+E)+)E", rest[inner.end() + int(inner.group(1)):])
                    if args:  # template arguments: int (Li) and bool (Lb) literals
                        name += f"<{', '.join(re.findall(r'L[ib](\d+)E', args.group(1)))}>"
        elif name and "stack frame" in line:
            frame = line.split(":", 1)[-1].strip()
        elif name and "Used" in line and "registers" in line:
            used = line.split(":", 1)[-1].strip()
            out.append(f"{name}: {used}; {frame}")
            name = None
    return out


def card_line() -> str:
    proc = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    )
    return proc.stdout.strip().splitlines()[0]


def simulate_reads(rng, genome_len):
    """Error-free reads at uniform positions, half of them reverse-complemented."""
    n = -(-genome_len * COVERAGE // READ_LEN)
    genome = rng.integers(0, 4, genome_len, dtype=np.uint8)
    starts = rng.integers(0, genome_len - READ_LEN + 1, n)
    codes = genome[starts[:, None] + np.arange(READ_LEN)]
    flip = rng.random(n) < 0.5
    codes[flip] = 3 - codes[flip, ::-1]
    letters = np.frombuffer(b"ACGT", dtype=np.uint8)[codes]
    return [row.tobytes().decode() for row in letters]


cuda_ms = gather.cuda_ms


def max_abs_err(a, b) -> int:
    """Largest |a - b| over paired integer outputs; raises if shapes differ."""
    err = 0
    for x, y in zip(a, b, strict=True):
        if x.shape != y.shape:
            raise AssertionError(f"output shapes differ: {tuple(x.shape)} vs {tuple(y.shape)}")
        if x.numel():
            err = max(err, int((x.to(torch.int64) - y.to(torch.int64)).abs().max()))
    return err


def naive_sw(q, r, match=2, mis=2, go=3, ge=1):
    m, n = len(q), len(r)
    neg = -(10**9)
    H = [[0] * (n + 1) for _ in range(m + 1)]
    E = [[neg] * (n + 1) for _ in range(m + 1)]
    F = [[neg] * (n + 1) for _ in range(m + 1)]
    best = 0
    for i in range(1, m + 1):
        for j in range(1, n + 1):
            E[i][j] = max(H[i - 1][j] - go, E[i - 1][j] - ge)
            F[i][j] = max(H[i][j - 1] - go, F[i][j - 1] - ge)
            s = match if q[i - 1] == r[j - 1] else -mis
            H[i][j] = max(0, H[i - 1][j - 1] + s, E[i][j], F[i][j])
            best = max(best, H[i][j])
    return best


def run_main_path(dev, seqs, rng):
    """index -> overlap -> SW scoring of the edges, in the current directory."""
    with open("reads.fa", "w") as f:
        f.write("".join(f">r{i}\n{s}\n" for i, s in enumerate(seqs)))
    kernels.reset_launches()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.time()
    assert cli.main(["index", "-p", "reads", "reads.fa"]) == 0
    index_s = time.time() - t0
    n_chars = sum(len(s) + 1 for s in seqs)
    peak = torch.cuda.max_memory_allocated()
    print(f"index (-a sais2 on {dev}): {n_chars} chars per direction, peak device memory "
          f"{peak} bytes = {peak / n_chars:.1f} per char (estimate {sa_mod.SORT_BYTES_PER_CHAR})")
    assert peak <= sa_mod.SORT_BYTES_PER_CHAR * n_chars, "the sort's memory estimate is too low"
    WATCH.reset()
    t0 = time.time()
    assert cli.main(
        ["overlap", "--device", dev.type, "-m", str(MIN_OVERLAP), "-p", "reads", "reads.fa"]
    ) == 0
    overlap_s = time.time() - t0
    print(WATCH.one_copy_a_chunk("overlap", -(-len(seqs) // search.chunk_size(len(seqs)))))
    check_outputs(["reads.asqg.gz"])
    n_vt, n_ed, queries, refs = sw_edge_pairs(
        "reads.asqg.gz", {f"r{i}": s for i, s in enumerate(seqs)}, 4096, rng)
    t0 = time.time()
    best, qend, _rend = sw.BatchAligner(*SW_PARAMS, device=dev).scores(queries, refs)
    sw_s = time.time() - t0
    launches = dict(kernels.launches)
    print(f"index_s {index_s:.3f} overlap_s {overlap_s:.3f} sw_edges_s {sw_s:.3f}")
    print(f"asqg: {n_vt} VT, {n_ed} ED; launches {launches}")
    assert n_vt == len(seqs) and n_ed > 0, (n_vt, n_ed)
    qlen = np.array([len(q) for q in queries])
    assert (best == 2 * qlen).all() and (qend == qlen - 1).all(), "an edge is not an exact overlap"
    print(f"{len(queries)} sampled edges score 2 x their overlap length")
    return launches, index_s, (queries, refs)


def check_host_index(index_s):
    """`index -a host` on the same reads: the four files equal the device
    build's byte for byte."""
    t0 = time.time()
    assert cli.main(["index", "-a", "host", "-p", "host", "reads.fa"]) == 0
    host_s = time.time() - t0
    for ext in INDEX_FILES:
        with open(f"reads.{ext}", "rb") as a, open(f"host.{ext}", "rb") as b:
            assert a.read() == b.read(), f"reads.{ext} (sais2) differs from host.{ext}"
    print(f"index walls: -a sais2 (cuda) {index_s:.3f} s, -a host {host_s:.3f} s; "
          f".sai/.bwt/.rsai/.rbwt byte-equal")


def time_index_layers(dev, seqs):
    """The device index's layers for one direction, warm: the text build, the
    suffix sort alone, and sort + BWT + permutation copied to the host; the
    launches of each K6 wrapper in one `bwt_perm_device` and its host
    synchronisations; then K6 traced in a process of its own
    (`trace_index`)."""
    t0 = time.time()
    codes, _starts, _lengths = sa_mod.concat_reads(seqs)
    concat_s = time.time() - t0
    torch.cuda.synchronize()
    t0 = time.time()
    order = sa_mod.suffix_array_device(codes, dev)
    torch.cuda.synchronize()
    sort_s = time.time() - t0
    del order
    t0 = time.time()
    _bwt, perm = sa_mod.bwt_perm_device(codes, dev)
    bwt_perm_s = time.time() - t0
    # K6's loose bound: the rank text read once; the suffix array (int32
    # suffices below 2**31 characters), the BWT codes and the .sai
    # permutation written once.  A sort moves its keys more than once:
    # `trace_index` gives the bound of the passes this design runs.
    k6_bytes = codes.size * (1 + 4 + 1) + perm.size * 4
    print(f"index layers, one direction of {codes.size} chars, warm: concat_reads {concat_s:.3f} s, "
          f"suffix_array_device {sort_s:.3f} s, bwt_perm_device (sort + BWT + perm to the host) "
          f"{bwt_perm_s:.3f} s; K6 loose bound {bytes_ms(k6_bytes):.4f} ms ({k6_bytes} B, bytes)")
    kernels.reset_launches()
    sites, _out = sync_sites(lambda: sa_mod.index_arrays_device(codes, dev))
    del _out
    ran = {name: n for name, n in kernels.launches.items() if n}
    print(f"K6 index_arrays_device, one direction: launches {ran}; host synchronisations "
          f"(torch.cuda.set_sync_debug_mode) {len(sites)} {sites} [{card_line()}]")
    assert not sites, "K6 waits on the card between the text's copy and the outputs'"
    assert set(ran) == set(SA_TIMED), ran
    in_child("trace_index")


def k6_route_bytes(n: int, plan, passes) -> tuple:
    """(bytes of the sort passes, bytes of the hand kernels) of one
    `suffix_array_device` of n characters with `sort_plan`'s plan: each
    torch.sort call moves its key and its int64 index, read and written
    once, in each digit pass (`passes`: the trace's count a call, or where
    the trace lost them one pass a key byte); each kernel its
    `sa_step_bytes`."""
    m, rounds = plan.tied, plan.rounds
    calls = [(n, 1), (n, 8), (n, 8)] + [(m, 8)] * rounds
    digits = [p[0] for p in passes] if len(passes) == len(calls) and all(
        p[0] for p in passes) else [key for _, key in calls]
    sort_bytes = sum(d * 2 * (key + 8) * items for d, (items, key) in zip(digits, calls))
    seed = n + 17 * n + 4 * n  # the text, the keys, upos (sized n)
    gathers = (8 + 16) * n + (8 + 32) * n
    ranks = (33 + 12) * n + 4 * n
    round_keys = rounds * (12 * m + min(8 * m, 4 * n))
    scatter = rounds * 24 * m + max(rounds - 1, 0) * 12 * m
    return sort_bytes, seed + gathers + ranks + round_keys + scatter


def trace_index(dev):
    """K6 on the forward text of the main path's reads (reads.fa) in a
    process of its own: `kernel_ab.sa_readings` (warm walls, device time and
    operations, torch.sort's share and its digit passes, peak bytes a
    character) beside the loose bound and the bound of this design's passes
    (`k6_route_bytes`).  Returns {"device_ms": ...}."""
    seqs = [r.seq for r in fastx.read_sequences("reads.fa")]
    codes = sa_mod.concat_reads(seqs)[0]
    plan = sa_mod.sort_plan(codes)
    kernels.lib()
    times, counts, _digest = sa_readings(codes, dev)
    card = card_line()
    dev_ms, sort_ms = times["suffix_array_device device time"], times["torch.sort device time"]
    sort_bytes, kernel_bytes = k6_route_bytes(codes.size, plan, counts["sort passes"])
    bound = bytes_ms(sort_bytes + kernel_bytes)
    walls = "; ".join(f"{name} median {times[name + ' wall median']:.4f} ms (min-max "
                      f"{times[name + ' wall min']:.4f}-{times[name + ' wall max']:.4f})"
                      for name in ("suffix_array_device", "bwt_perm_device"))
    print(f"K6 one direction, {codes.size} chars, plan {tuple(plan)}: warm walls ({SA_WALLS} each, "
          f"in turn, host clock) {walls} [{card}]")
    if counts["device operations"]:
        print(f"K6 suffix_array_device device time (torch.profiler) {dev_ms:.4f} ms in "
              f"{counts['device operations']} device operations; torch.sort {sort_ms:.4f} ms = "
              f"{sort_ms / dev_ms:.1%}; digit passes (onesweep kernels, all kernels) of each "
              f"torch.sort {counts['sort passes']}; {bound / dev_ms:.1%} of the passes' bound "
              f"[{card}]")
    else:
        print("K6 suffix_array_device device time: not measured (the trace holds no device "
              "operation)")
    print(f"K6 bound of this design's passes {bound:.4f} ms (bytes: the sorts' digit passes "
          f"{sort_bytes} B, the hand kernels {kernel_bytes} B); peak device memory of "
          f"bwt_perm_device {counts['peak bytes a char']:.1f} B a char (estimate "
          f"{sa_mod.SORT_BYTES_PER_CHAR})")
    assert counts["peak bytes a char"] <= sa_mod.SORT_BYTES_PER_CHAR
    return {"device_ms": dev_ms if counts["device operations"] else None}


def sa_edge_reads(seed: int = 0) -> dict:
    """{label: reads} whose texts meet the device suffix sort's edges: the
    seed alone and one, two and three doubling rounds; one tied group of
    5,480 suffixes (more than a scan tile) and identical reads; reads of 63,
    64 and 65 symbols (sentpos at its cap); an N (a '$' in the rank text)
    and an empty read; one read of one symbol; reads of a small genome over
    many scan tiles.  The CPU tests hold the route's plain steps to the JAX
    package on them; `chip_smoke.py` holds the kernels to the plain steps."""
    rng = np.random.default_rng(seed)

    def reads(n, lengths):
        return ["".join("ACGT"[c] for c in rng.integers(0, 4, int(rng.choice(lengths))))
                for _ in range(n)]

    return {
        "rounds 0 (reads of 1-63)": reads(120, list(range(1, 64))),
        "rounds 1 (100 bp)": reads(60, [100]),
        "rounds 2 (37 and 200)": reads(40, [37, 200]),
        "rounds 3 (300 and 50)": reads(12, [300, 50]),
        "one tied group of 5,480 (40 x 200 A)": ["A" * 200] * 40,
        "identical": ["ACGTTGCAAC" * 9] * 6,
        "63, 64 and 65 symbols": reads(30, [63, 64, 65]) + ["A" * 63, "A" * 64, "A" * 65],
        "an N and an empty read": ["ACGTNACGT" * 10, "", "ACGT" * 30, "N" * 70],
        "one symbol": ["A"],
        "many tiles (600 x 150 bp of a 6 kb genome)": genome_reads(600, [150], 6000, seed),
    }


def _copies(args) -> tuple:
    return tuple(a.clone() if isinstance(a, torch.Tensor) else a for a in args)


def _outputs(out) -> list:
    return [t for t in (out if isinstance(out, tuple) else (out,)) if t is not None]


def sa_step_bytes(name: str, args) -> int:
    """The bytes a K6 step must move with `args`: each input read once (a
    gathered array at most whole), each output written once."""
    if name == "sa_seed_keys":
        c, n, ucap = args
        return min(c.numel(), n + sa_mod.SEED_READ) + 17 * n + 4 * (ucap or 0)
    if name == "sa_gather":
        order, idx, _key = args
        return 8 * idx.numel() * (3 + 2 * (order is not None))
    if name == "sa_seed_ranks":
        idx3, m = args[1], args[5]
        return 45 * idx3.numel() + 4 * m
    if name == "sa_round_keys":
        upos, rank = args[:2]
        return 12 * upos.numel() + min(8 * upos.numel(), 4 * rank.numel())
    if name == "sa_round_scatter":
        m = args[0].numel()
        return 24 * m + (12 * m if args[5] is not None else 0)
    if name == "sa_bwt_perm":
        sa, _c, reads = args
        return 10 * sa.numel() + 8 * reads
    raise ValueError(name)


def check_sa_steps(record, text: str, timed: bool) -> dict:
    """Each K6 step `record` holds (`index/sa.py::_step`): its kernel against
    its plain version on copies of the same inputs, bit for bit; with
    `timed` each also timed by CUDA events (SA_REPS calls; the plain version
    SA_PLAIN_REPS) beside its bytes bound.  Returns {kernel: JSON row} of
    the steps SA_TIMED names (when timed)."""
    rows = {}
    for label, (name, args) in record.items():
        wrapper, plain = sa_mod.STEPS[name]
        err = max_abs_err(_outputs(wrapper(*_copies(args))), _outputs(plain(*_copies(args))))
        assert err == 0, f"K6 {label} on {text}: the kernel differs from its plain version ({err})"
        line = f"K6 {label} on {text}: equal to its plain version"
        if timed:
            bound = bytes_ms(sa_step_bytes(name, args))
            ms = cuda_ms(lambda: wrapper(*args), SA_REPS)
            plain_ms = cuda_ms(lambda: plain(*args), SA_PLAIN_REPS)
            line += (f"; {ms:.4f} ms by CUDA events, {bound / ms:.1%} of its {bound:.4f} ms bytes "
                     f"bound; plain {plain_ms:.4f} ms [{card_line()}]")
            if SA_TIMED[name] == label:
                rows[name] = kernel_row(err, ms, plain_ms, bound, "bytes", None)
        print(line)
    return rows


def check_sa_kernels(dev, seqs) -> dict:
    """K6 on the card: `index_arrays_device` (the route) on the main path's
    forward text and on every text of `sa_edge_reads`, its SA equal to
    `suffix_array_plain`'s and its BWT and permutation to `bwt_perm_plain`'s
    bit for bit, and each step it ran against its plain version on the same
    inputs (timed at the main path's shape, `check_sa_steps`).  Returns each
    K6 kernel's JSON row."""
    rows, seen = {}, set()
    for text, reads in {"the main path's forward text": seqs, **sa_edge_reads()}.items():
        codes = sa_mod.concat_reads(reads)[0]
        record = {}
        bwt, perm = sa_mod.index_arrays_device(codes, dev, record)
        want_bwt, want_perm = sa_mod.bwt_perm_plain(codes, dev)
        assert np.array_equal(bwt.cpu().numpy(), want_bwt), f"{text}: the BWT differs"
        assert np.array_equal(perm.cpu().numpy(), want_perm), f"{text}: the permutation differs"
        del bwt, perm
        assert torch.equal(sa_mod.suffix_array_device(codes, dev),
                           sa_mod.suffix_array_plain(codes, dev)), f"{text}: the SA differs"
        print(f"K6 on {text} ({codes.size} chars, plan {tuple(sa_mod.sort_plan(codes))}): SA "
              f"equal to suffix_array_plain, BWT and permutation to bwt_perm_plain")
        timed = not rows
        rows.update(check_sa_steps(record, text, timed))
        seen |= {name for name, _args in record.values()}
        del record
        torch.cuda.empty_cache()
    assert seen == set(SA_TIMED) and set(rows) == set(SA_TIMED), (seen, rows)
    return rows


def dist_step_bytes(name: str, args) -> int:
    """The bytes a K8 step must move with `args`: each input read once (a
    gathered array at most whole), each output written once; a binary
    search its rows' reads."""
    if name == "dist_levels":
        idx, order, key, sentpos, codes, sents = (*args, None, None, None)[:6]
        m = idx.numel()
        given = [x for x in (order, key, sentpos, codes) if x is not None]
        # outputs: the position, the key, sentpos, the payload
        out = 8 * (order is not None) + 8 * (key is not None) + (sentpos is not None) + 8 * (
            codes is not None)
        return (8 + out) * m + sum(min(x.numel(), m) * x.element_size() for x in given) + (
            0 if sents is None else sents.nbytes)
    if name == "dist_bounds":
        cols, _base, split = args
        row = sum(c.element_size() for c in cols if c is not None)
        return split[0].numel() * (2 * row + 8 + cols[0].numel().bit_length() * row)
    if name == "dist_merge":
        a, _a_base, b, _b_base, out = args
        m = a[0].numel() + b[0].numel()
        read = sum(x.element_size() for i, x in enumerate(a)
                   if x is not None and (i in dist_build.KEYS or out[i] is not None))
        return m * (read + sum(o.element_size() for o in out if o is not None))
    if name == "dist_number":
        cols = args[0]
        return cols[dist_build.POS].numel() * (sum(c.element_size() for c in cols if c is not None)
                                               + 4)
    raise ValueError(name)


def check_dist_steps(record, text: str, timed: bool) -> dict:
    """Each K8 step `record` holds (`parallel/dist_build.py::_step`): its
    kernel against its plain version on copies of the same inputs, bit for
    bit; with `timed` each also timed by CUDA events (SA_REPS calls; the
    plain version SA_PLAIN_REPS) beside its bytes bound.  Returns {kernel:
    JSON row} of the steps DIST_TIMED names (when timed)."""
    rows = {}
    for label, (name, args) in record.items():
        wrapper, plain = dist_build.STEPS[name]
        got, want = dist_build._copy(args), dist_build._copy(args)
        err = max_abs_err(dist_build.step_outputs(name, got, wrapper(*got)),
                          dist_build.step_outputs(name, want, plain(*want)))
        assert err == 0, f"K8 {label} on {text}: the kernel differs from its plain version ({err})"
        line = f"K8 {label} on {text}: equal to its plain version"
        if timed:
            bound = bytes_ms(dist_step_bytes(name, args))
            ms = cuda_ms(lambda: wrapper(*got), SA_REPS)
            plain_ms = cuda_ms(lambda: plain(*want), SA_PLAIN_REPS)
            line += (f"; {ms:.4f} ms by CUDA events, {bound / ms:.1%} of its {bound:.4f} ms bytes "
                     f"bound; plain {plain_ms:.4f} ms [{card_line()}]")
            if DIST_TIMED[name] == label:
                rows[name] = kernel_row(err, ms, plain_ms, bound, "bytes", None)
        print(line)
        del got, want
    return rows


def time_dist_build(dev, seqs) -> tuple:
    """The distributed index build (K8, `parallel/dist_build.py`: torch.sort
    passes, around them K6's kernels and those of `csrc/dist_sort.cu`) on
    the main path's forward text split into D = 2 and 4 segments on
    [cuda:0] * D, counts reset just before: its suffix array equals K6's
    `suffix_array_device` order, and its BWT and permutation equal
    `bwt_perm_device`'s and the reads.bwt / reads.sai that `index` wrote,
    exactly; each K8 and K6 kernel of the route must launch.  Then its warm
    wall (DIST_ROUNDS builds in turn with K6's `bwt_perm_device`, host
    clock); each K8 step against its plain version (`check_dist_steps`,
    timed at D = 2) there and on every text of `sa_edge_reads` at D = 2, 4
    and 8, the route's output equal to K6's; and its device time, digit
    passes, host synchronisations and peak memory in a process of its own
    (`trace_dist`).  Returns (the K8 path's launches, each new kernel's
    JSON row)."""
    card = card_line()
    codes, _starts, _lengths = sa_mod.concat_reads(seqs)
    want_sa = sa_mod.suffix_array_device(codes, dev).cpu().numpy()
    k6 = functools.partial(sa_mod.bwt_perm_device, codes, dev)
    want_bwt, want_perm = k6()
    file_bwt, file_ns, _ = load_bwt("reads.bwt")
    file_perm, _ = load_sai("reads.sai")
    assert file_ns == len(seqs) and np.array_equal(want_bwt, file_bwt), "reads.bwt differs"
    assert np.array_equal(want_perm, file_perm), "reads.sai differs"
    kernels.reset_launches()
    for d in SEGMENTS:
        devs = dist.device_list([dev] * d)
        got_sa = dist_build.distributed_sa(codes, devs)
        assert np.array_equal(got_sa, want_sa), f"D = {d}: the suffix array differs from K6's"
        del got_sa
        bwt, perm = dist_build.distributed_bwt_perm(codes, devs)
        assert np.array_equal(bwt, want_bwt) and np.array_equal(perm, want_perm), \
            f"D = {d}: the BWT or permutation differs from K6's and the index files"
        del bwt, perm
    launches = {name: n for name, n in kernels.launches.items() if n}
    print(f"K8 distributed_sa and distributed_bwt_perm at D = {SEGMENTS} on [cuda:0] x D, "
          f"{codes.size} chars: SA equal to suffix_array_device, BWT + perm equal to "
          f"bwt_perm_device and reads.bwt / reads.sai; launches {launches}")
    assert set(launches) == set(DIST_TIMED) | set(DIST_K6), launches
    for d in SEGMENTS:
        build = functools.partial(dist_build.distributed_bwt_perm, codes, [dev] * d)
        walls = host_walls([build, k6], DIST_ROUNDS)
        print(f"K8 distributed_bwt_perm on [cuda:0] x {d}: warm wall ({DIST_ROUNDS} builds in "
              f"turn, host clock) median {np.median(walls[0]):.4f} s (min-max "
              f"{min(walls[0]):.4f}-{max(walls[0]):.4f}), K6 bwt_perm_device in turn median "
              f"{np.median(walls[1]):.4f} s (min-max {min(walls[1]):.4f}-{max(walls[1]):.4f}) "
              f"[{card}]")
    rows = {}
    texts = {"the main path's forward text": seqs, **sa_edge_reads()}
    for text, reads in texts.items():
        codes = sa_mod.concat_reads(reads)[0]
        if codes.size <= 1:
            continue
        want_sa = sa_mod.suffix_array_device(codes, dev).cpu().numpy()
        want_bwt, want_perm = sa_mod.bwt_perm_device(codes, dev)
        for d in (SEGMENTS if not rows else (2, 4, 8)):
            try:
                record = {}
                outs, _stats = dist_build.run_distributed(codes, [dev] * d, True, record)
            except ValueError as exc:  # segments shorter than the doubling halo
                print(f"K8 on {text} at D = {d}: refused ({exc})")
                continue
            packed = torch.cat(outs).cpu()
            sym = (packed & 7).to(torch.uint8)
            assert np.array_equal(sym.numpy(), want_bwt), f"K8 {text} D = {d}: the BWT differs"
            assert np.array_equal((packed[sym == 0] >> 3).numpy(), want_perm), \
                f"K8 {text} D = {d}: the permutation differs"
            assert np.array_equal(dist_build.distributed_sa(codes, [dev] * d), want_sa), \
                f"K8 {text} D = {d}: the SA differs"
            print(f"K8 on {text} ({codes.size} chars) at D = {d}: SA, BWT and permutation equal "
                  f"to K6's")
            timed = not rows and d == SEGMENTS[0]
            rows.update(check_dist_steps(record, f"{text} at D = {d}", timed))
            del record, outs
        torch.cuda.empty_cache()
    assert set(rows) == set(DIST_TIMED), rows
    in_child("trace_dist")
    return {name: n for name, n in launches.items() if name in DIST_TIMED}, rows


def k8_route_bytes(n: int, s: int, d: int, rounds: int, passes, moved: int) -> tuple:
    """(bytes of the sort passes, bytes of the hand kernels, bytes moved
    between entries) of one `distributed_bwt_perm` of n characters in d
    segments of s: each torch.sort call of s rows moves its key and its
    int64 index, read and written once, in each digit pass (`passes`: the
    trace's onesweep count of each full-length call; a one-pass call sorts
    the one-byte sentpos); each kernel each input read once and each output
    written once (K6's seed keys and gathers as `sa_step_bytes` counts
    them; `levels`, a tree level of merges and a numbering as
    `dist_step_bytes`); `moved`, the build's own count of the pieces out
    and the ranks back."""
    sort_bytes = sum(p * 2 * ((1 if p == 1 else 8) + 8) * s for p in passes)
    seed = d * ((s + 82 + 17 * s) + 8 * s * 3 + 8 * s * 5 + 42 * s)
    levels_tree = max(d.bit_length() - 1, 1) if d > 1 else 0
    seed_merge = levels_tree * n * 50 + d * s * 29
    rounds_bytes = rounds * d * (12 * s + 4 * s + 8)  # round_keys, the halo copy
    round_merges = max(rounds - 1, 0) * (levels_tree * n * 32 + d * s * 20)
    last = d * s * 17 + levels_tree * n * 32  # the payload's levels, the last merge
    return sort_bytes, seed + seed_merge + rounds_bytes + round_merges + last, moved


def trace_dist(dev):
    """K8 on the forward text of the main path's reads (reads.fa) in a process
    of its own, at D = 2 and 4 on [cuda:0] * D: `kernel_ab.dist_readings`
    (warm walls, device time and operations, torch.sort's share and its
    digit passes, peak bytes a character) beside K6's device time in the
    same process, the host synchronisations (`sync_sites`, equal to the
    build's own count) and the bound of this design's passes, kernels and
    exchanges (`k8_route_bytes`).  Returns {D: device ms}."""
    seqs = [r.seq for r in fastx.read_sequences("reads.fa")]
    codes = sa_mod.concat_reads(seqs)[0]
    kernels.lib()
    card = card_line()
    loose = bytes_ms(codes.size * (1 + 4))
    k6_times, _k6_counts, _ = sa_readings(codes, dev, reps=3)
    k6_ms = k6_times["suffix_array_device device time"]
    out = {}
    for d in SEGMENTS:
        times, counts, _digest = dist_readings(codes, dev, d)
        sites, (_outs, stats) = sync_sites(
            functools.partial(dist_build.run_distributed, codes, [dev] * d, emit_bwt=True))
        del _outs
        assert len(sites) == stats["host_syncs"], (sites, stats["host_syncs"])
        full = [p[0] for p in counts["sort passes"] if p[0]]
        moved = sum(p["moved_bytes"] for p in stats["phases"])
        sort_bytes, kernel_bytes, moved = k8_route_bytes(codes.size, stats["segment"], d,
                                                         stats["rounds"], full, moved)
        bound = bytes_ms(sort_bytes + kernel_bytes + moved)
        dev_ms, sort_ms = times["device time"], times["torch.sort device time"]
        n_ops = counts["device operations"]
        print(f"K8 D = {d}, {codes.size} chars (S = {stats['segment']}, {stats['rounds']} "
              f"rounds): warm wall of distributed_bwt_perm median {times['wall median']:.4f} ms "
              f"(min-max {times['wall min']:.4f}-{times['wall max']:.4f}) [{card}]")
        if n_ops:
            print(f"K8 D = {d} device time (torch.profiler) {dev_ms:.4f} ms in {n_ops} device "
                  f"operations ({dev_ms / k6_ms:.2f}x K6's suffix_array_device {k6_ms:.4f} ms in "
                  f"this process), {loose / dev_ms:.2%} of the loose bound {loose:.4f} ms; "
                  f"torch.sort {sort_ms:.4f} ms = {sort_ms / dev_ms:.1%}; full-length digit "
                  f"passes (onesweep kernels of each torch.sort) {full}: {sum(full)} in all, "
                  f"{sum(full) / d:g} an entry; {bound / dev_ms:.1%} of this design's bound; "
                  f"costliest: " + "; ".join(f"{name} {ms:.4f} ms x{k}"
                                              for name, ms, k in counts["costliest"])
                  + f" [{card}]")
        else:
            print(f"K8 D = {d} device time: not measured (the trace holds no device operation)")
        held = d * (2 * stats["segment"] + dist_build.SEED_HALO)
        peak = counts["peak bytes a char"]
        print(f"K8 D = {d} bound of this design {bound:.4f} ms (bytes: the digit passes "
              f"{sort_bytes} B, the hand kernels {kernel_bytes} B, moved between entries {moved} "
              f"B); host synchronisations {len(sites)} by torch.cuda.set_sync_debug_mode {sites}, "
              f"{stats['host_syncs']} by the build's count (one a global sort's sizes); peak "
              f"device memory {peak:.1f} B a char (the memory check's estimate "
              f"{sa_mod.SORT_BYTES_PER_CHAR * held / codes.size:.1f}); per global sort: "
              + ", ".join(f"{p['phase']} moved {p['moved_bytes']} B (largest bucket "
                          f"{max(p['buckets'])})" for p in stats["phases"]) + f" [{card}]")
        assert peak * codes.size <= sa_mod.SORT_BYTES_PER_CHAR * held, \
            "the build's memory estimate is too low"
        out[str(d)] = dev_ms if n_ops else None
    return out


def sync_sites(fn):
    """(the file:line of each synchronising CUDA call fn() made, by torch's
    sync debug mode, which warns at each; fn's result).  The mode's own
    first warning (that it is a prototype) is not one of them."""
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            out = fn()
        finally:
            torch.cuda.set_sync_debug_mode("default")
    return [f"{os.path.relpath(w.filename, REPO)}:{w.lineno}" for w in caught
            if "called a synchronizing" in str(w.message)], out


def run_rmdup(builder, seqs, rng):
    """rmdup through the CLI on the card, then 256 sampled reads' hits against
    the host engine."""
    kernels.reset_launches()
    WATCH.reset()
    t0 = time.time()
    assert cli.main(["rmdup", "-p", "reads", "reads.fa"]) == 0
    rmdup_s = time.time() - t0
    launches = dict(kernels.launches)
    n_chunks = -(-len(seqs) // search.chunk_size(len(seqs)))
    print(WATCH.one_copy_a_chunk(f"rmdup ({rmdup_s:.3f} s) [{card_line()}]", n_chunks))
    check_outputs(RMDUP_FILES)
    assert launches["scan_pair"] == n_chunks, (launches, n_chunks)  # one scan launch a chunk
    assert launches["pair_plane"] == 2, launches  # one plane build a direction
    with open("reads.rmdup.fa") as f:
        kept = sum(line.startswith(">") for line in f)
    with open("reads.rmdup.dups.fa") as f:
        dups = sum(line.startswith(">") for line in f)
    print(f"rmdup_s {rmdup_s:.3f}: kept {kept}, duplicates {dups}; launches {launches}")
    assert kept + dups == len(seqs), (kept, dups)
    sample = set(rng.choice(len(seqs), size=256, replace=False).tolist())
    n_blocks = 0
    with gzip.open("reads-thread0.rmdup.hits.gz", "rt") as f:
        for idx, line in enumerate(f):
            if idx in sample:
                name, seq, hit_text = line.rstrip("\n").split("\t", 2)
                hit = Hit(idx=idx)
                hit.substring = builder.duplicate(seqs[idx], hit.blocks).substring
                assert name == f"r{idx}" and seq == seqs[idx], idx
                assert hit_text == hit.serialize(), idx
                n_blocks += len(hit.blocks)
                sample.discard(idx)
    assert not sample, "sampled reads missing from the rmdup hits file"
    print(f"256 sampled reads: rmdup hits == host engine (OverlapBuilder.duplicate), "
          f"{n_blocks} containment blocks among them")
    return run_single_step_rmdup(n_chunks)


RMDUP_FILES = ("reads.rmdup.fa", "reads.rmdup.dups.fa", "reads-thread0.rmdup.hits.gz")
# sha256 of the main path's `overlap` ASQG and `rmdup` files (uncompressed),
# as the engine of commit c761036, one chunk at a time, wrote them
OUTPUT_SHA256 = {
    "reads.asqg.gz": "1f0ad594b05261ff5495f5eba30ca0f475e70abb7b9c645ca1b61e1022289900",
    "reads.rmdup.fa": "f0332439eff40757c0e0e8bb0b8c43536a459a9e6667c086b426ba499e7785fb",
    "reads.rmdup.dups.fa": "3b195d758bf85ea70a336fa670c76de6a7a89cae64088fc6a5fdcc81234570dd",
    "reads-thread0.rmdup.hits.gz": "744be336a85fb425df565262ffada913e62322a53504e13dcb1b4cb54bab4472",
}


def check_outputs(paths) -> None:
    """Raise unless each file's content has its digest in OUTPUT_SHA256."""
    for path in paths:
        digest = hashlib.sha256(read_maybe_gz(path)).hexdigest()
        print(f"{path}: sha256 {digest}")
        assert digest == OUTPUT_SHA256[path], f"{path} differs from the one-chunk engine's"


def run_single_step_rmdup(n_chunks: int):
    """`rmdup` again with SIGA_PAIR_STEP=0, counts reset just before it: K3
    must launch once a chunk, K1 and K2 never, and its kept reads,
    duplicates and hits must equal the default route's, which `run_rmdup`
    just wrote.  Returns its launch counts."""
    want = [read_maybe_gz(path) for path in RMDUP_FILES]
    kernels.reset_launches()
    os.environ["SIGA_PAIR_STEP"] = "0"
    try:
        t0 = time.time()
        assert cli.main(["rmdup", "-p", "reads", "reads.fa"]) == 0
        rmdup_s = time.time() - t0
    finally:
        del os.environ["SIGA_PAIR_STEP"]
    launches = dict(kernels.launches)
    assert launches["scan_single"] == n_chunks, (launches, n_chunks)
    assert launches["scan_pair"] == 0 and launches["pair_plane"] == 0, launches
    for path, data in zip(RMDUP_FILES, want):
        assert read_maybe_gz(path) == data, f"rmdup with SIGA_PAIR_STEP=0: {path} differs"
    print(f"rmdup with SIGA_PAIR_STEP=0: {rmdup_s:.3f} s, launches {launches}; kept reads, "
          f"duplicates and hits equal to the default route's")
    return launches


def read_maybe_gz(path) -> bytes:
    opener = gzip.open if path.endswith(".gz") else open
    with opener(path, "rb") as f:
        return f.read()


def run_probe_path():
    """The gather probes' CLI on the index's stacked pair plane."""
    kernels.reset_launches()
    t0 = time.time()
    assert gather.main(["--plane", "reads", "--lanes", str(PROBE_LANES),
                        "--steps", str(PROBE_STEPS)]) == 0
    launches = dict(kernels.launches)
    print(f"probe CLI {time.time() - t0:.3f} s; launches {launches}")
    for name in ("gather_rows", "take_along", "gather_chain", "scale2"):
        assert launches[name] >= 1, (name, launches)
    assert launches["pair_plane"] == 2, launches  # the plane of each direction
    return launches


def probe_bytes(name, args) -> int:
    """The bytes a probe call must move: each input element it needs read
    once (a gather needs only the elements it gathers, at most the whole
    table), each output written once."""
    if name == "scale2":
        return 2 * args[0].numel() * 4
    if name == "gather_rows":
        table, idx = args
        out = idx.numel() * table.shape[1]
        return (min(out, table.numel()) + idx.numel() + out) * 4
    if name == "take_along":
        table, index, axis = args
        out = int(np.prod(gather._take_shape(table, index, axis)))
        return (min(out, table.numel()) + index.numel() + out) * 4
    table, init, c, steps, mode = args  # gather_chain
    reads = steps * init.numel() * (table.shape[0] if mode == "sum" else 1)
    return (min(reads, table.numel()) + 2 * init.numel() + (c.numel() if c is not None else 0)) * 4


def spread(times) -> str:
    return f"median {np.median(times):.4f} ms (min-max {min(times):.4f}-{max(times):.4f})"


def alternate(fns, reps, rounds=PROBE_ROUNDS):
    """ms of each fn in `rounds` rounds, the fns timed in turn within each."""
    times = [[] for _ in fns]
    for _ in range(rounds):
        for t, fn in zip(times, fns):
            t.append(cuda_ms(fn, reps))
    return times


def check_probes(dev, plane):
    """Each probe kernel against its plain version, with its bound and the
    library call that computes the same: at every Pallas probe's own shape,
    and on the pair plane.  G2 and G4 are timed in turn with their library
    call (PROBE_ROUNDS rounds; medians).  Returns ({kernel: (JSON row fields
    on the pair plane, replaces)}, ns of one dependent step of few G3
    chains on the plane)."""
    rng = np.random.default_rng(SEED)
    errs, replaces = {}, {}

    def compare(name, args, reps, where):
        fn, plain = gather.WRAPPERS[name]
        err = max_abs_err([fn(*args)], [plain(*args)])
        bound = bytes_ms(probe_bytes(name, args))
        library = library_call(name, args)
        if name in ("take_along", "scale2"):
            k_ms, l_ms = alternate([lambda: fn(*args), library], reps)
            ms, lib_ms = float(np.median(k_ms)), float(np.median(l_ms))
            timing = (f"kernel {spread(k_ms)}, {bound / ms:.1%} of the bound; library call "
                      f"{spread(l_ms)}; kernel/library {ms / lib_ms:.3f}")
        else:
            ms = cuda_ms(lambda: fn(*args), reps)
            lib_ms = cuda_ms(library, 10) if library is not None else None
            timing = (f"kernel {ms:.4f} ms, library call "
                      f"{'none' if lib_ms is None else f'{lib_ms:.4f} ms'}")
        plain_ms = cuda_ms(lambda: plain(*args), 2)
        errs[name] = max(errs.get(name, 0), err)
        print(f"{name} {where}: max_abs_err {err}, {timing}, plain {plain_ms:.4f} ms, "
              f"bound {bound:.5f} ms (bytes)")
        return kernel_row(err, ms, plain_ms, bound, "bytes", lib_ms)

    for tpu_name, where, name, args in gather.probe_cases(rng):
        args = gather.to_device(args, dev)
        form = (f", {take_form(*args)}" if name == "take_along"
                else f", {elem_form(*args)}" if name == "gather_chain" and args[4] == "elem"
                else "")
        row = compare(name, args, 10, f"as {tpu_name} ({where}{form})")
        replaces.setdefault(name, []).append(where)
        if tpu_name == "k_d":
            k_d, k_d_ms = args, row["ms"]
    for name, e in check_probe_edges(dev).items():
        errs[name] = max(errs[name], e)
    R, _C = plane.shape
    out = {}
    for name, args in gather.plane_args(plane, PROBE_LANES, PROBE_STEPS, SEED).items():
        form = f", {take_form(*args)}" if name == "take_along" else ""
        row = compare(name, args, 3 if name == "gather_chain" else 10,
                      f"on the pair plane {tuple(plane.shape)}, {PROBE_LANES} lanes{form}")
        row["max_abs_err"] = errs[name]
        out[name] = (row, ", ".join(replaces[name]))
    assert all(v[0]["max_abs_err"] == 0 for v in out.values()), out
    sweep_chain_groups(dev, plane)
    # the L2 round trip a lane's chain pays a step: 32 chains of dependent
    # single-word gathers (G3 mode elem, read in place) over one direction's plane
    fwd = plane[: R // 2].reshape(1, -1)
    init = torch.randint(0, fwd.shape[1], (1, 32), dtype=torch.int32, device=dev,
                         generator=torch.Generator(device=dev).manual_seed(SEED))
    steps = 2000
    steps_ms = cuda_ms(lambda: gather.chain_elem(fwd, init, steps, gather.DIRECT), 3)
    step_ns = steps_ms * 1e6 / steps
    print(f"gather_chain (elem, direct), 32 chains x {steps} dependent steps over the forward "
          f"plane ({fwd.numel() * 4} B): {steps_ms:.4f} ms, {step_ns:.1f} ns a step (the L2 "
          f"round trip)")
    # the L1 round trip: the same chains over a 4 KB table, which L1 holds
    small, small_init = fwd[:, :1024].contiguous(), init % 1024
    l1_ms = cuda_ms(lambda: gather.chain_elem(small, small_init, steps, gather.DIRECT), 3)
    l1_ns = l1_ms * 1e6 / steps
    # the shared-memory round trip: the same chains over the table staged in
    # shared memory (G3 mode elem's shared form)
    want = gather.gather_chain_plain(small, small_init, None, steps, "elem")
    assert torch.equal(gather.chain_elem(small, small_init, steps, gather.SHARED), want)
    sh_ms = cuda_ms(lambda: gather.chain_elem(small, small_init, steps, gather.SHARED), 3)
    sh_ns = sh_ms * 1e6 / steps
    k_d_steps = k_d[3]
    print(f"gather_chain (elem, direct), 32 chains x {steps} dependent steps over a 4 KB table: "
          f"{l1_ms:.4f} ms, {l1_ns:.1f} ns a step (the L1 round trip); k_d's chain bound in the "
          f"direct form ({k_d_steps} dependent loads a chain): {k_d_steps * l1_ns / 1e6:.5f} ms "
          f"at the L1 round trip, {k_d_steps * step_ns / 1e6:.5f} ms at the L2's [{card_line()}]")
    print(f"gather_chain (elem, shared), 32 chains x {steps} dependent steps over a 4 KB table, "
          f"equal to plain: {sh_ms:.4f} ms, {sh_ns:.1f} ns a step (the shared-memory round "
          f"trip) [{card_line()}]")
    # the launch floor: an empty kernel, timed as the kernels above
    floor_ms = [cuda_ms(lambda: gather.launch_floor(dev), 100) for _ in range(PROBE_ROUNDS)]
    print(f"launch floor (an empty kernel, CUDA events, 100 launches a timing): "
          f"{spread(floor_ms)} [{card_line()}]")
    floor = float(np.median(floor_ms))
    print(f"launch-and-latency bounds (the launch floor and each dependent L2 round trip): "
          f"G4 at [8, 128] (a load, then its store) {floor + step_ns / 1e6:.5f} ms; G2's k_a "
          f"and k_b at [8, 128] (the index, then the table word) {floor + 2 * step_ns / 1e6:.5f} "
          f"ms [{card_line()}]")
    sweep_elem_tiles(dev, k_d)
    # k_d's bounds: its bytes; its chain at the shared round trip; the design's
    # (the launch floor, one row staged at HBM rate, the chain)
    table, init = k_d[0], k_d[1]
    chain = k_d_steps * sh_ns / 1e6
    design = floor + bytes_ms(table.shape[1] * 4) + chain
    wavefronts, banks_ms = elem_bank_bound(table, init, k_d_steps,
                                           gather.chain_elem_tile(init.shape[1]))
    print(f"k_d {tuple(table.shape)} x {k_d_steps} ({elem_form(*k_d)}): {k_d_ms:.4f} ms; bytes "
          f"bound {bytes_ms(probe_bytes('gather_chain', k_d)):.5f} ms; chain bound at the shared "
          f"round trip {chain:.5f} ms ({chain / k_d_ms:.1%}); design bound {design:.5f} ms "
          f"(launch floor, a row's {table.shape[1] * 4} B, the chain), k_d at "
          f"{design / k_d_ms:.1%} of it; its loads' bank conflicts: {wavefronts:.3f} wavefronts a warp's load, "
          f"{banks_ms:.5f} ms on the busiest SM at the highest SM clock, with the launch floor "
          f"{floor + banks_ms:.5f} ms (k_d at {(floor + banks_ms) / k_d_ms:.1%}) [{card_line()}]")
    return out, step_ns


def sweep_chain_groups(dev, plane):
    """G3's mode sum with each group G of `gather.CHAIN_GROUPS` at k_scan's
    shape and on the pair plane (each equal to the plain version), beside
    the G `gather.chain_plan` picks; then, timed only, at the lane counts
    and row widths its rule rests on (strided and contiguous rows, few and
    many random lanes); on the plane also the traffic of its rows with
    every read fetched again (the 32-byte sectors each row spans, at HBM
    rate), beside the byte bound."""
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    k_scan = next(args for tpu, _w, _n, args in gather.probe_cases(np.random.default_rng(SEED))
                  if tpu == "k_scan")
    on_plane = gather.plane_args(plane, PROBE_LANES, PROBE_STEPS, SEED)["gather_chain"]
    cases = {"k_scan [24, 8192] x 112": gather.to_device(k_scan, dev),
             f"the pair plane {tuple(plane.shape)} x {PROBE_STEPS}": on_plane}
    for label, (table, init, c, steps, mode) in cases.items():
        want = gather.gather_chain_plain(table, init, c, steps, mode)
        times = []
        for G in gather.CHAIN_GROUPS:
            assert torch.equal(gather.chain_sum(table, init, c, steps, G), want), (label, G)
            times.append(cuda_ms(lambda: gather.chain_sum(table, init, c, steps, G), 5))
        plan = gather.chain_plan(table.shape[0], table.stride(0) == 1, init.numel(), sms)
        print(f"gather_chain (sum) {label}, {init.numel()} lanes, each G equal to plain: "
              + ", ".join(f"G={G} {ms:.4f} ms" for G, ms in zip(gather.CHAIN_GROUPS, times))
              + f"; chain_plan picks G={plan} [{card_line()}]")
    # the lane counts and widths behind chain_plan's rule (timed only)
    gen = torch.Generator(device=dev).manual_seed(SEED)
    k_table, _init, k_c, k_steps, _mode = cases["k_scan [24, 8192] x 112"]
    rule = [("strided W=24 (k_scan's table)", k_table, k_steps, (2048, 16384, 60608)),
            ("strided W=4", k_table[:4], k_steps, (8192, 60608)),
            ("strided W=57", torch.randint(-2**31, 2**31 - 1, (57, 8192), dtype=torch.int32,
                                           device=dev, generator=gen), k_steps, (8192,)),
            ("the pair plane's rows, W=57", plane.T, PROBE_STEPS, (1170, 16384, 32768, 45056)),
            ("the pair plane's first words, W=1", plane[:, :1].T, PROBE_STEPS, (8192, 60608))]
    for label, table, steps, lane_counts in rule:
        for lanes in lane_counts:
            init = torch.randint(0, table.shape[1], (lanes,), dtype=torch.int32, device=dev,
                                 generator=gen)
            times = [cuda_ms(lambda: gather.chain_sum(table, init, k_c, steps, G), 5)
                     for G in gather.CHAIN_GROUPS]
            plan = gather.chain_plan(table.shape[0], table.stride(0) == 1, lanes, sms)
            print(f"gather_chain (sum) sweep, {label} x {steps}, {lanes} random lanes: "
                  + ", ".join(f"G={G} {ms:.4f} ms" for G, ms in zip(gather.CHAIN_GROUPS, times))
                  + f"; chain_plan picks G={plan}")
    table, init, _c, steps, _mode = on_plane
    W, R = table.shape
    starts = plane.data_ptr() % 32 + np.arange(R, dtype=np.int64) * table.stride(1) * 4
    sectors = float(np.mean((starts % 32 + 4 * W + 31) // 32))
    traffic = init.numel() * steps * sectors * 32
    print(f"gather_chain (sum) on the pair plane: {sectors:.3f} sectors a row, row traffic "
          f"{traffic / 1e9:.3f} GB = {bytes_ms(traffic):.4f} ms at HBM rate (with re-reads), "
          f"byte bound {bytes_ms(probe_bytes('gather_chain', on_plane)):.4f} ms")


def sweep_elem_tiles(dev, k_d):
    """G3 mode elem's shared form at k_d's shape with each tile of lanes a
    block, and at no steps (the launch and the row's staging), beside the
    direct form and the tile `gather.chain_elem_tile` takes; then the same
    on the table cut to 8,184 words a row, whose modulo is no power of two
    (the general reduction; its rows still 16-byte aligned).  Every call
    equal to the plain version."""
    table, init, _c, steps, mode = k_d
    N = table.shape[1]
    cases = [(f"k_d {tuple(table.shape)}", table, init),
             (f"k_d's table cut to N = {N - 8}", table[:, : N - 8].contiguous(), init % (N - 8))]
    for label, t, i in cases:
        times = {}
        for tile in ELEM_TILES:
            for n in (steps, 0):
                want = gather.gather_chain_plain(t, i, None, n, mode)
                assert torch.equal(gather.chain_elem(t, i, n, gather.SHARED, tile), want), tile
                times[tile, n] = cuda_ms(lambda: gather.chain_elem(t, i, n, gather.SHARED, tile),
                                         10)
        direct_ms = cuda_ms(lambda: gather.chain_elem(t, i, steps, gather.DIRECT), 10)
        print(f"gather_chain (elem) {label} x {steps}, shared form, equal to plain: "
              + ", ".join(f"tile {tile} {times[tile, steps]:.4f} ms (no steps "
                          f"{times[tile, 0]:.4f})" for tile in ELEM_TILES)
              + f"; direct form {direct_ms:.4f} ms; chain_elem_tile takes "
              f"{gather.chain_elem_tile(i.shape[1])} [{card_line()}]")


def elem_bank_bound(table, init, steps, tile):
    """The least time G3 mode elem's shared form can spend on its chains'
    shared-memory loads: at each step a warp's 32 lanes load in as many
    wavefronts as the most distinct words any one of the 32 banks holds
    among them (a bank serves one word a cycle; equal words broadcast).  The
    states are the plain version's, step by step; block b runs on SM b mod
    the SM count; the bound is the busiest SM's wavefronts at the card's
    highest SM clock.  Returns (mean wavefronts a warp's load, ms)."""
    (W, N), M, dev = table.shape, init.shape[1], table.device
    tiles, per_block = -(-M // tile), tile // 32
    warps = W * tiles * per_block
    lane_warp = (torch.arange(W, device=dev)[:, None] * (tiles * per_block)
                 + torch.arange(M, device=dev)[None, :] // 32)
    busy = torch.zeros(warps, dtype=torch.int64, device=dev)
    t64, state = table.to(torch.int64), init.to(torch.int64)
    for s in range(steps):
        words = torch.unique(lane_warp * N + state)  # distinct (warp, word) pairs
        banks = words // N * 32 + words % N % 32
        busy += torch.bincount(banks, minlength=warps * 32).view(warps, 32).amax(dim=1)
        state = gather._wrap32(state + t64.gather(1, state) + s) % N
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    blocks = busy.view(W * tiles, per_block).sum(dim=1)
    per_sm = torch.zeros(sms, dtype=torch.int64, device=dev).index_add_(
        0, torch.arange(W * tiles, device=dev) % sms, blocks)
    clock_mhz = float(subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm", "--format=csv,noheader,nounits"],
        capture_output=True, text=True, check=True).stdout.split()[0])
    live = int((torch.bincount(lane_warp.flatten(), minlength=warps) > 0).sum())
    return float(busy.sum()) / (live * steps), float(per_sm.max()) / (clock_mhz * 1e3)


def elem_form(table, init, _c, _steps, _mode) -> str:
    """G3 mode elem's form (and tile) for these arguments on this card."""
    (W, N), M = table.shape, init.shape[1]
    sms = torch.cuda.get_device_properties(table.device).multi_processor_count
    form = gather.chain_elem_plan(W, N, table.stride(1), M, sms)
    tile = f", tile {gather.chain_elem_tile(M)}" if form == gather.SHARED else ""
    return f"form {gather.FORMS[form]}{tile}"


def take_form(table, index, axis) -> str:
    """G2's form and block shape for these arguments on this card."""
    A, B, Q, _si0, _si1 = gather.take_along_geometry(table, index, axis)
    sms = torch.cuda.get_device_properties(table.device).multi_processor_count
    form, tile = gather.take_along_plan(A, B, Q, axis, sms)
    return f"form {gather.FORMS[form]}, tile {tile}"


def check_probe_edges(dev):
    """G1, G2, G4 and G3 against their plain versions at the edge shapes of
    `gather.edge_cases`, bit for bit: G3's mode sum with every group G, its
    mode elem in the plan's form and in both forms wherever the row fits in
    shared memory (past it, the shared form must be refused and raise).
    Returns {kernel: largest error}."""
    errs = {"gather_rows": 0, "take_along": 0, "scale2": 0, "gather_chain": 0}
    for label, name, args in gather.edge_cases(np.random.default_rng(SEED), dev):
        fn, plain = gather.WRAPPERS[name]
        want = plain(*args)
        e = max_abs_err([fn(*args)], [want])
        extra = f", {take_form(*args)}" if name == "take_along" else ""
        if name == "gather_chain" and args[4] == "sum":  # and every group, not only the plan's
            e = max([e] + [max_abs_err([gather.chain_sum(*args[:4], G)], [want])
                           for G in gather.CHAIN_GROUPS])
            extra = ", every G"
        elif name == "gather_chain":  # mode elem: and each form the row allows
            table, init, _c, steps, _mode = args
            forms = [gather.DIRECT]
            if 4 * table.shape[1] <= gather.SMEM_MAX:
                forms.append(gather.SHARED)
            else:
                try:
                    gather.chain_elem(table, init, steps, gather.SHARED)
                except RuntimeError as exc:
                    refused = str(exc)
                else:
                    raise AssertionError(f"{label}: the shared form launched past shared memory")
            e = max([e] + [max_abs_err([gather.chain_elem(table, init, steps, f)], [want])
                           for f in forms])
            extra = (f", {elem_form(*args)}; "
                     + ("shared and direct" if len(forms) == 2
                        else f"direct; shared refused ({refused})"))
        print(f"edge {label}{extra}: max_abs_err {e}")
        errs[name] = max(errs[name], e)
    assert not any(errs.values()), errs
    return errs


def check_probe_range_assert():
    """A row index past the plane stops G1 with its device-side assert.  The
    assert leaves the CUDA context unusable, so it runs in a child process."""
    code = (
        "import torch\n"
        "from siga_tpu_torch.probes import gather\n"
        "plane = torch.zeros((8, 57), dtype=torch.int32, device='cuda')\n"
        "gather.gather_rows(plane, torch.tensor([0, 8], dtype=torch.int32, device='cuda'))\n"
        "torch.cuda.synchronize()\n"
    )
    proc = subprocess.run(
        [sys.executable, "-c", code], cwd=os.path.dirname(os.path.abspath(__file__)),
        capture_output=True, text=True, timeout=300,
    )
    assert proc.returncode != 0 and "device-side assert" in proc.stderr, proc.stderr[-2000:]
    print("gather_rows with a row index past the plane: the device-side assert raised "
          "in a child process")


def run_engine(dev, seqs):
    """The engine alone on the index the main path built (warm planes)."""
    fmi, rfmi = FMIndex.load("reads.bwt"), FMIndex.load("reads.rbwt")
    builder = OverlapBuilder(fmi, rfmi, "reads")
    t0 = time.time()
    scanner = search._cached_scanner(builder, dev, *FWD_REV)
    plane_s = time.time() - t0
    for d, host in enumerate((fmi, rfmi)):  # the stacked plane, built by K2
        plane, K = fm_device.pair_plane_host(host)
        rows = scanner.plane[d * scanner.nblocks : (d + 1) * scanner.nblocks]
        assert np.array_equal(rows.cpu().numpy(), plane), f"direction {d}: plane differs"
        assert np.array_equal(scanner.K2[d].cpu().numpy(), K), f"direction {d}: K differs"
    records = [DNASeq(name=f"r{i}", seq=s) for i, s in enumerate(seqs)]
    ru0 = resource.getrusage(resource.RUSAGE_SELF)
    t0 = time.time()
    hits = list(search.batch_overlap_hits(builder, records, MIN_OVERLAP, dev))
    engine_s = time.time() - t0
    ru1 = resource.getrusage(resource.RUSAGE_SELF)
    print(f"plane_build_s {plane_s:.3f} (both directions; the stacked plane and K equal the "
          f"C++ host packing)")
    time_read_guard(seqs)
    print(f"engine_s {engine_s:.3f} engine_reads_per_s {len(seqs) / engine_s:.1f}; process cpu "
          f"user {ru1.ru_utime - ru0.ru_utime:.3f} s, system {ru1.ru_stime - ru0.ru_stime:.3f} s")
    return builder, hits


def run_single_step_overlap():
    """`overlap -m 45` with SIGA_PAIR_STEP=0 on the main path's index, counts
    reset just before it: K3 must launch once a chunk and K1 never, and the
    ASQG must equal the default (pair) route's, which the main path wrote."""
    shutil.copy("reads.asqg.gz", "pairs.asqg.gz")
    kernels.reset_launches()
    os.environ["SIGA_PAIR_STEP"] = "0"
    try:
        t0 = time.time()
        assert cli.main(["overlap", "-m", str(MIN_OVERLAP), "-p", "reads", "reads.fa"]) == 0
        overlap_s = time.time() - t0
    finally:
        del os.environ["SIGA_PAIR_STEP"]
    launches = dict(kernels.launches)
    n_reads = count_records("reads.fa")
    n_chunks = -(-n_reads // search.chunk_size(n_reads))
    # the pair plane is built at its first use: this route reads none
    assert launches["scan_single"] == n_chunks and launches["scan_pair"] == 0, launches
    assert launches["pair_plane"] == 0, launches
    asqg = []
    for path in ("pairs.asqg.gz", "reads.asqg.gz"):
        with gzip.open(path) as f:
            asqg.append(f.read())
    assert asqg[0] == asqg[1], "the SIGA_PAIR_STEP=0 ASQG differs from the default route's"
    print(f"overlap with SIGA_PAIR_STEP=0: {overlap_s:.3f} s, launches {launches}; ASQG equal to "
          f"the default route's ({asqg[0].count(b'\nED\t')} ED records)")
    return launches


def check_engine_split(builder, seqs, hits):
    """The engine with each chunk's reads split over the device list [cuda:0,
    cuda:0] (two shards dispatched in turn from one host thread, sharing one
    card's planes; the same code path as one shard on each of two cards)
    against the one-device hits."""
    devices = [torch.device("cuda", 0)] * 2
    records = [DNASeq(name=f"r{i}", seq=s) for i, s in enumerate(seqs)]
    t0 = time.time()
    split = list(search.batch_overlap_hits(builder, records, MIN_OVERLAP, devices))
    split_s = time.time() - t0
    assert len(split) == len(hits)
    for a, b in zip(split, hits):
        assert a.idx == b.idx and a.substring == b.substring, a.idx
        assert np.array_equal(a._array, b._array), a.idx
    print(f"engine over [cuda:0, cuda:0]: {split_s:.3f} s, {len(split) / split_s:.1f} reads/s; "
          f"every hit equals the one-device engine's (local cards: "
          f"{[str(d) for d in dist.data_devices()]})")


def views_equal(a, b) -> bool:
    """Two scanners' (f_view, r_view) equal, array for array."""
    return all(np.array_equal(x, y) for va, vb in zip(a, b, strict=True)
               for x, y in zip(va, vb, strict=True))


class ScanWatch:
    """Every `DualScanner.dispatch` of this process runs under
    `torch.cuda.set_sync_debug_mode("error")`, so a dispatch that waits on
    the card raises (and fails the run); `dispatches` counts them by scan
    kernel.  `totals` sums the scanners' counts (`DualScanner.stats`:
    chunks, host waits, copies back, overflowed budgets) since `reset()`."""

    def __init__(self):
        self.dispatches = {}
        self.totals = {}
        dispatch, collect = fm_device.DualScanner.dispatch, fm_device.DualScanner.collect

        def counted(method, scanner, *args):
            before = dict(scanner.stats)
            try:
                return method(scanner, *args)
            finally:
                for key, n in scanner.stats.items():
                    self.totals[key] = self.totals.get(key, 0) + n - before[key]

        @functools.wraps(dispatch)
        def strict_dispatch(scanner, *args):
            mode = torch.cuda.get_sync_debug_mode()
            torch.cuda.set_sync_debug_mode("error")
            try:
                handle = counted(dispatch, scanner, *args)
            finally:
                torch.cuda.set_sync_debug_mode(mode)
            name = getattr(handle.scan, "name", "plain")
            self.dispatches[name] = self.dispatches.get(name, 0) + 1
            return handle

        @functools.wraps(collect)
        def counted_collect(scanner, handle):
            return counted(collect, scanner, handle)

        fm_device.DualScanner.dispatch = strict_dispatch
        fm_device.DualScanner.collect = counted_collect

    def reset(self):
        self.totals = {key: 0 for key in ("chunks", "host_waits", "copies", "overflows")}

    def one_copy_a_chunk(self, label: str, n_chunks: int) -> str:
        """Raise unless `n_chunks` chunks were collected since `reset()`, with
        one host wait and one copy back a chunk besides one more for each
        overflowed budget; the counts as a line of text."""
        t = self.totals
        assert t["chunks"] == n_chunks, (label, t, n_chunks)
        assert t["host_waits"] == t["copies"] == t["chunks"] + t["overflows"], (label, t)
        return (f"{label}: {t['chunks']} chunks, {t['host_waits']} host waits and {t['copies']} "
                f"copies back ({t['host_waits'] / t['chunks']:.3f} a chunk), {t['overflows']} "
                f"overflowed budgets")


WATCH = None  # the process's ScanWatch, made in main()

# (label, search.LOOKAHEAD, SIGA_NATIVE_WORKERS) of the engine's settings,
# each timed after a warm-up pass of its own, their hits equal
ENGINE_SETTINGS = (("LOOKAHEAD 8, 1 B/C worker", 8, "1"), ("LOOKAHEAD 1, 1 B/C worker", 1, "1"),
                   ("LOOKAHEAD 8, SIGA_NATIVE_WORKERS=2", 8, "2"))


def same_hits(got, want, label: str) -> None:
    assert len(got) == len(want), label
    for a, b in zip(got, want):
        assert a.idx == b.idx and a.substring == b.substring, (label, a.idx)
        assert np.array_equal(a._array, b._array), (label, a.idx)


def check_engine_in_flight(dev, builder, seqs, hits):
    """The engine with chunks in flight at each of ENGINE_SETTINGS in turn: a
    warm-up pass, then a timed pass (wall, reads/s, the process's user and
    system CPU, peak device memory); every pass's hits equal the warm
    engine's, every dispatch ran under the sync check (`ScanWatch`), and
    each chunk made one host wait and one copy back unless a budget
    overflowed (none may in a timed pass: the budgets are sticky)."""
    records = [DNASeq(name=f"r{i}", seq=s) for i, s in enumerate(seqs)]
    n_chunks = -(-len(seqs) // search.chunk_size(len(seqs)))
    lookahead, workers = search.LOOKAHEAD, os.environ.get("SIGA_NATIVE_WORKERS")
    try:
        for label, depth, n_workers in ENGINE_SETTINGS:
            search.LOOKAHEAD = depth
            os.environ["SIGA_NATIVE_WORKERS"] = n_workers
            for timed in (False, True):
                WATCH.reset()
                torch.cuda.reset_peak_memory_stats(dev)
                ru0 = resource.getrusage(resource.RUSAGE_SELF)
                t0 = time.time()
                got = list(search.batch_overlap_hits(builder, records, MIN_OVERLAP, dev))
                wall = time.time() - t0
                ru1 = resource.getrusage(resource.RUSAGE_SELF)
                same_hits(got, hits, label)
                counts = WATCH.one_copy_a_chunk(label, n_chunks)
                if not timed:
                    continue
                assert WATCH.totals["overflows"] == 0, (label, WATCH.totals)
                print(f"engine {label}: {wall:.3f} s, {len(seqs) / wall:.1f} reads/s; process "
                      f"cpu user {ru1.ru_utime - ru0.ru_utime:.3f} s, system "
                      f"{ru1.ru_stime - ru0.ru_stime:.3f} s; peak device memory "
                      f"{torch.cuda.max_memory_allocated(dev)} B; {counts}; hits equal "
                      f"[{card_line()}]")
    finally:
        search.LOOKAHEAD = lookahead
        if workers is None:
            del os.environ["SIGA_NATIVE_WORKERS"]
        else:
            os.environ["SIGA_NATIVE_WORKERS"] = workers


def check_split_pack(dev, builder, seqs):
    """`dispatch`/`collect` with a slab budget that splits the first chunk
    over three launches (each part compacted into the budget on the stream,
    its slab dropped), and again with a row budget that overflows (the
    parts launched again): the views equal the one-launch scan's."""
    chunk = seqs[: search.chunk_size(len(seqs))]
    maxlen = search._bucket_len(READ_LEN)
    want_sc = search._cached_scanner(builder, dev, *FWD_REV)
    want = want_sc.collect(want_sc.dispatch(chunk, len(chunk), maxlen, MIN_OVERLAP))
    (card,) = dist.device_list(dev)
    sc = fm_device.DualScanner(*builder._dfms[str(card)], *FWD_REV)
    lanes, cap = 4 * len(chunk), fm_device.emit_cap(READ_LEN - 1, MIN_OVERLAP)
    sc.slab_bytes = -(-lanes // 3 // 32) * 32 * cap * fm_device.SLAB_ROW_BYTES
    parts = len(fm_device.lane_parts(lanes, cap, sc.slab_bytes))
    for label, rows in (("budgets that fit", None), ("a row budget that overflows", 8192)):
        if rows is not None:
            sc._rows = rows
        before = kernels.launches["scan_pair"]
        WATCH.reset()
        got = sc.collect(sc.dispatch(chunk, len(chunk), maxlen, MIN_OVERLAP))
        launched = kernels.launches["scan_pair"] - before
        assert views_equal(got, want), label
        assert launched == parts * (1 + WATCH.totals["overflows"]) and parts == 3, (label, launched)
        assert (WATCH.totals["overflows"] == 1) == (rows is not None), (label, WATCH.totals)
        print(f"dispatch/collect of the first chunk in {parts} lane parts, {label}: {launched} "
              f"launches, {WATCH.totals['host_waits']} host waits; views equal one launch's")


def top_ops(by_name, k=5) -> str:
    top = sorted(by_name.items(), key=lambda item: -item[1][0])[:k]
    return "; ".join(f"{name[:90]} {ms:.4f} ms x{count}" for name, (ms, count) in top)


def peak_bytes(fn) -> int:
    """Device memory fn() takes at its peak beyond what was allocated before."""
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    before = torch.cuda.memory_allocated()
    out = fn()
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated() - before
    del out
    return peak


def edge_indexes(dev, read_sets=None) -> dict:
    """{label: (forward FMIndex, reverse FMIndex)} of every read set of
    `read_sets` (default `plane_edge_reads`, the CPU tests' texts), indexed
    on the card."""
    out = {}
    for label, reads in (read_sets or plane_edge_reads()).items():
        out[label] = tuple(
            FMIndex(bwt, ns) for bwt, _perm, ns in (
                sa_mod.build_index_arrays(texts, "sais2", dev)
                for texts in (reads, [r[::-1] for r in reads])))
    return out


def check_plane_kernel(dev, edges):
    """K2 against its plain version, bit for bit, plane and K: both directions
    of the main path's index, and both directions of every read set of
    `plane_edge_reads` (`edges`, indexed on the card).  Each
    case is built PLANE_REPEATS more times in a row on the current stream,
    and once on a second stream while the current stream builds it too: all
    equal to the first (the look-back's flags and ticket are reset for
    every build, and two builds at once keep to their own scratch).
    Returns the largest error."""
    cases = [(f"main path {ext}", FMIndex.load(f"reads.{ext}")) for ext in ("bwt", "rbwt")]
    for label, hosts in edges.items():
        cases += [(f"{label} {d}", fmi) for d, fmi in zip(("forward", "reverse"), hosts)]
    side = torch.cuda.Stream(dev)
    err_all = 0
    for label, fmi in cases:
        codes = torch.from_numpy(np.ascontiguousarray(fmi.codes)).to(dev)
        args = (codes, np.asarray(fmi.pred, dtype=np.int64), fmi.length // fm_device.SAMPLE + 1)
        first = fm_device.build_pair_plane(*args)
        err = max_abs_err(first, fm_device.build_pair_plane_plain(*args))
        again = [fm_device.build_pair_plane(*args) for _ in range(PLANE_REPEATS)]
        side.wait_stream(torch.cuda.current_stream(dev))
        with torch.cuda.stream(side):
            on_side = fm_device.build_pair_plane(*args)
        alongside = fm_device.build_pair_plane(*args)
        torch.cuda.current_stream(dev).wait_stream(side)
        repeat_err = max(max_abs_err(first, out) for out in again + [on_side, alongside])
        err_all = max(err_all, err, repeat_err)
        print(f"K2 {label}: {fmi.length} codes, {args[2]} rows, max_abs_err {err}; "
              f"{PLANE_REPEATS} builds in a row, one on a second stream beside one on this "
              f"stream: max_abs_err {repeat_err} against the first")
    assert err_all == 0
    return err_all


def time_plane_build(dev):
    """K2 (`build_pair_plane`) for the forward index of the main path's reads,
    its BWT codes already on the card, against its plain version: each one's
    device time and operations from a torch.profiler trace of its first
    build in this process (cold) and of its second (warm, as the walls here
    and `kernel_ab --plane` take it: each times builds after a first one),
    its wall by CUDA events over PLANE_ROUNDS builds in turn with the other, and
    its peak device memory; the bound (the codes read once, the plane and K
    written once).  Beside it, the rest of what `plane_build_s` holds: the
    codes' copy to the card and DualScanner's stacking of the two planes.
    Returns the kernel's row of the JSON line (walls are medians)."""
    fmi = FMIndex.load("reads.bwt")
    host_codes = np.ascontiguousarray(fmi.codes)
    torch.from_numpy(host_codes).to(dev)  # the process's first copy sets up the context
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(PLANE_ROUNDS):
        codes = torch.from_numpy(host_codes).to(dev)
        torch.cuda.synchronize()
    h2d_ms = (time.perf_counter() - t0) / PLANE_ROUNDS * 1e3
    pred = np.asarray(fmi.pred, dtype=np.int64)
    nblocks = fmi.length // fm_device.SAMPLE + 1
    versions = {
        "kernel": lambda: fm_device.build_pair_plane(codes, pred, nblocks),
        "plain": lambda: fm_device.build_pair_plane_plain(codes, pred, nblocks),
    }
    k2_bytes = codes.numel() * codes.element_size() + nblocks * ROW_BYTES + 25 * 4
    bound = bytes_ms(k2_bytes)
    cold = {name: trace_device(fn) for name, fn in versions.items()}
    traces = {name: trace_device(fn) for name, fn in versions.items()}
    walls = dict(zip(versions, alternate(list(versions.values()), 1, PLANE_ROUNDS)))
    for name, fn in versions.items():
        dev_ms, n_ops, by_name, _prof = traces[name]
        peak = peak_bytes(fn)
        cold_ms, cold_ops = cold[name][:2]
        device = (f"{dev_ms:.4f} ms in {n_ops} device operations ({bound / dev_ms:.1%} of the "
                  f"bound; the first build {cold_ms:.4f} ms in {cold_ops})" if n_ops
                  else "not measured (the trace holds no device operation)")
        print(f"K2 {name}, one direction ({codes.numel()} codes, {nblocks} rows): device time "
              f"(torch.profiler) {device}; wall (CUDA events, "
              f"{PLANE_ROUNDS} builds in turn) {spread(walls[name])}, "
              f"{bound / np.median(walls[name]):.1%} of the bound; peak device memory {peak} B")
        print(f"  K2 {name} device operations: {top_ops(by_name, 6)}")
    stack = [versions["kernel"]()[0] for _ in range(2)]
    cat_ms = cuda_ms(lambda: torch.cat(stack).contiguous(), PLANE_ROUNDS)
    print(f"K2 bound {bound:.4f} ms ({k2_bytes} B, bytes); around it in plane_build_s: codes to "
          f"the card (host clock, pageable) {h2d_ms:.3f} ms a direction, DualScanner's stacking "
          f"copy of both planes ({2 * nblocks * ROW_BYTES} B) {cat_ms:.4f} ms (bound "
          f"{bytes_ms(4 * nblocks * ROW_BYTES):.4f} ms)")
    return kernel_row(0, float(np.median(walls["kernel"])), float(np.median(walls["plain"])),
                      bound, "bytes", None)


def in_child(fn_name: str):
    """`fn_name`(the card) of this module in a fresh process in the current
    directory: a torch.profiler trace late in this process held none of
    K2's kernels (the plain version's were there), while in a process of
    its own the trace holds them.  Relays its lines and returns what it
    returned (JSON)."""
    code = ("import json, torch, chip_smoke\n"
            f"print(json.dumps(chip_smoke.{fn_name}(torch.device('cuda'))))\n")
    proc = subprocess.run([sys.executable, "-c", code], env=CHILD_ENV, capture_output=True,
                          text=True, timeout=STAGE_TIMEOUT)
    if proc.returncode != 0:
        raise RuntimeError(f"{fn_name} exited {proc.returncode}:\n{proc.stderr[-4000:]}")
    *lines, row = proc.stdout.strip().splitlines()
    print("\n".join(lines), flush=True)
    return json.loads(row)


def sharded_scanner(fms, groups, d: int):
    """The index-sharded scanner over [cuda:0] * d: the stacked single-step
    plane of `fms` packed on the host and split into d allocations."""
    return fm_device.DualScanner(*fms, *groups, devices=[torch.device("cuda", 0)] * d)


def time_scans(dev):
    """K1, K3 and the index-sharded scan (D in SHARDS) through their
    wrappers (`scan_pair`, `scan_single`, `scan_single_sharded`) on the
    first full chunk of the main path's reads, in a process of its own: a
    wrapper call is the scan kernel, the slab compaction (torch operations)
    and one synchronisation.  A torch.profiler trace of SCAN_ROUNDS calls
    of each gives every call's kernel device time and the device time of
    the rest; CUDA events give each wrapper's wall over SCAN_ROUNDS calls in
    turn with the others.  Then K9 at `stage_a_chunk_args` (`trace_stage_a`).
    Returns {label: median kernel device ms}."""
    seqs = [r.seq for r in fastx.read_sequences("reads.fa")]
    chunk = seqs[: search.chunk_size(len(seqs))]
    maxlen = search._bucket_len(max(map(len, chunk)))
    la_w, lens = fm_device.pack_reads_2bit(chunk, len(chunk), maxlen)
    lim_t = min(maxlen - 1, int(lens.max()) - 1)
    reads = (torch.from_numpy(la_w).to(dev), torch.from_numpy(lens).to(dev))
    fms = [fm_device.DeviceFM(FMIndex.load(f"reads.{ext}"), dev) for ext in ("bwt", "rbwt")]
    calls = {}  # label: (kernel name, wrapper call)
    for name, pair in (("scan_pair", True), ("scan_single", False)):
        sc = fm_device.DualScanner(*fms, *FWD_REV, pair_step=pair)
        args = ((sc.plane, sc.K2) if pair else (sc.plane,)) + (
            sc.pred, sc.length, sc.nblocks, *reads, lim_t, MIN_OVERLAP, sc.fwd_groups,
            sc.rev_groups)
        calls[name] = (name, functools.partial(getattr(fm_device, name), *args))
    for d in SHARDS:
        sc = sharded_scanner(fms, FWD_REV, d)
        args = (sc.shards, sc.pred, sc.length, sc.nblocks, *reads, lim_t, MIN_OVERLAP, *FWD_REV)
        calls[f"scan_single_sharded D={d}"] = (
            "scan_single_sharded", functools.partial(fm_device.scan_single_sharded, *args))
    walls = dict(zip(calls, alternate([fn for _name, fn in calls.values()], 1, SCAN_ROUNDS)))
    kernel_ms = {}
    card = card_line()
    for label, (name, fn) in calls.items():

        def rounds(fn=fn):
            for _ in range(SCAN_ROUNDS):
                fn()

        dev_ms, n_ops, by_name, prof = trace_device(rounds)
        mine = kernel_spans(prof, name)
        if len(mine) != SCAN_ROUNDS:
            print(f"{label}: the trace holds {len(mine)} kernel spans for {SCAN_ROUNDS} calls: "
                  f"kernel device time not measured")
            kernel_ms[label] = None
            continue
        rest = (dev_ms - sum(mine)) / SCAN_ROUNDS
        kernel_ms[label] = float(np.median(mine))
        print(f"{label} first chunk ({len(chunk)} reads, {4 * len(chunk)} lanes), a process of "
              f"its own: kernel device time (torch.profiler, {SCAN_ROUNDS} calls) "
              f"{spread(mine)}; the rest of a call's device time {rest:.4f} ms in "
              f"{(n_ops - len(mine)) / SCAN_ROUNDS:.0f} operations ({top_ops(by_name, 4)}); "
              f"the wrapper's wall (CUDA events, {SCAN_ROUNDS} calls in turn with the others) "
              f"{spread(walls[label])}, the card idle for "
              f"{np.median(walls[label]) - kernel_ms[label] - rest:.4f} ms of it [{card}]")
    kernel_ms["scan_stage_a"] = trace_stage_a(stage_a_chunk_args(seqs, fms[0], dev))
    return kernel_ms


def time_read_guard(seqs):
    """The cost on the host CPU of `pack_reads_2bit`'s ACGT guard on one
    overlap chunk of reads, beside the whole packing."""
    chunk = seqs[: search.chunk_size(len(seqs))]
    joined = "".join(chunk).encode()
    maxlen = search._bucket_len(max(map(len, chunk)))
    reps = 20
    t0 = time.perf_counter()
    for _ in range(reps):
        fm_device.require_acgt(joined)
    guard_ms = (time.perf_counter() - t0) / reps * 1e3
    t0 = time.perf_counter()
    for _ in range(reps):
        fm_device.pack_reads_2bit(chunk, len(chunk), maxlen)
    pack_ms = (time.perf_counter() - t0) / reps * 1e3
    print(f"read guard on one chunk of {len(chunk)} reads ({len(joined)} B), host CPU: "
          f"require_acgt {guard_ms:.3f} ms of pack_reads_2bit's {pack_ms:.3f} ms")


def check_hits(builder, hits, seqs, rng):
    sample = sorted(rng.choice(len(seqs), size=min(256, len(seqs)), replace=False).tolist())
    for idx in sample:
        blocks = []
        result = builder.overlap(seqs[idx], MIN_OVERLAP, blocks)
        assert hits[idx].idx == idx and hits[idx].substring == result.substring, idx
        assert np.array_equal(hits[idx]._array, search._blocks_to_array(blocks)), idx
    want = set(sample)
    with gzip.open("reads-thread0.hits.gz", "rt") as f:
        for line in f:
            idx = int(line.split(" ", 1)[0])
            if idx in want:
                _i, sub, arr = Hit.parse_array(line)
                assert sub == hits[idx].substring and np.array_equal(arr, hits[idx]._array), idx
                want.discard(idx)
    assert not want, "sampled reads missing from the hits file"
    print(f"{len(sample)} sampled reads: command hits == engine hits == host engine")


def check_scan_kernel(dev, builder, seqs):
    """K1 against its plain version, bit for bit, on three chunks; the first
    one timed, with its bound.  Returns the kernel's row of the JSON line
    (the first chunk)."""
    chunk = search.chunk_size(len(seqs))
    cases = [
        ("first chunk", seqs[:chunk], FWD_REV, MIN_OVERLAP),
        ("149 bp chunk", [s[:149] for s in seqs[chunk : chunk + 2048]], FWD_REV, MIN_OVERLAP),
        ("rmdup groups", seqs[:2048], RMDUP, READ_LEN + 17),
    ]
    err_all = 0
    for name, chunk_seqs, groups, mo in cases:
        sc = search._cached_scanner(builder, dev, *groups)
        maxlen = search._bucket_len(max(map(len, chunk_seqs)))
        la_w, lens = fm_device.pack_reads_2bit(chunk_seqs, len(chunk_seqs), maxlen)
        lim_t = min(maxlen - 1, int(lens.max()) - 1)
        args = (
            sc.plane, sc.K2, sc.pred, sc.length, sc.nblocks,
            torch.from_numpy(la_w).to(dev), torch.from_numpy(lens).to(dev),
            lim_t, mo, sc.fwd_groups, sc.rev_groups,
        )
        plain = fm_device.scan_pair_plain(*args)
        err = max_abs_err(fm_device.scan_pair(*args), plain)
        err_all = max(err_all, err)
        print(f"K1 {name}: lim_t {lim_t}, blocks {int(plain[0][0])}, "
              f"candidates {int(plain[0][1])}, max_abs_err {err}")
        if name == "first chunk":
            # slabs that do not fit: the lanes split over several launches
            lanes, cap = 4 * len(chunk_seqs), fm_device.emit_cap(lim_t, mo)
            budget = lanes * cap * fm_device.SLAB_ROW_BYTES // 3
            before = kernels.launches["scan_pair"]
            err_split = max_abs_err(fm_device.scan_pair(*args, slab_bytes=budget), plain)
            parts = kernels.launches["scan_pair"] - before
            print(f"K1 first chunk with a slab budget of {budget} B: {parts} launches, "
                  f"max_abs_err {err_split}")
            assert parts == len(fm_device.lane_parts(lanes, cap, budget)) > 1 and err_split == 0
            ms = cuda_ms(lambda: fm_device.scan_pair(*args), 5)
            plain_ms = cuda_ms(lambda: fm_device.scan_pair_plain(*args), 2)
            bound, traffic = scan_bound(lens, lim_t, len(groups[0]) + len(groups[1]), sc.nblocks,
                                        la_w.shape[1], int(plain[0][0]))
            print(f"K1 first chunk ({len(chunk_seqs)} reads, {4 * len(chunk_seqs)} lanes): kernel "
                  f"{ms:.4f} ms; plain {plain_ms:.3f} ms; bound {bound:.4f} ms (bytes, each row "
                  f"once), row reads with re-reads {traffic} B = {bytes_ms(traffic):.4f} ms at HBM "
                  f"rate")
            row = kernel_row(err, ms, plain_ms, bound, "bytes", None)
    assert err_all == 0
    row["max_abs_err"] = err_all
    return row


def check_single_kernel(dev, builder, seqs, step_ns, edges):
    """K3 against its plain version, bit for bit: the first full chunk (timed,
    with its bounds; and split over several launches by a small slab budget),
    the rmdup lane groups and every case of `scan_edge_cases` over `edges`;
    then the chunk's views through K3 against K1's.  Returns the kernel's
    row of the JSON line (the first chunk)."""
    chunk = search.chunk_size(len(seqs))
    err_all = 0
    for name, chunk_seqs, groups, mo in (
        ("first chunk", seqs[:chunk], FWD_REV, MIN_OVERLAP),
        ("rmdup groups", seqs[:2048], RMDUP, READ_LEN + 17),
    ):
        sc = search._cached_scanner(builder, dev, *groups, pair_step=False)
        maxlen = search._bucket_len(max(map(len, chunk_seqs)))
        la_w, lens = fm_device.pack_reads_2bit(chunk_seqs, len(chunk_seqs), maxlen)
        lim_t = min(maxlen - 1, int(lens.max()) - 1)
        args = (
            sc.plane, sc.pred, sc.length, sc.nblocks,
            torch.from_numpy(la_w).to(dev), torch.from_numpy(lens).to(dev),
            lim_t, mo, sc.fwd_groups, sc.rev_groups,
        )
        plain = fm_device.scan_single_plain(*args)
        err = max_abs_err(fm_device.scan_single(*args), plain)
        err_all = max(err_all, err)
        print(f"K3 {name}: lim_t {lim_t}, blocks {int(plain[0][0])}, "
              f"candidates {int(plain[0][1])}, max_abs_err {err}")
        if name != "first chunk":
            continue
        lanes, cap = 4 * len(chunk_seqs), fm_device.emit_cap(lim_t, mo)
        budget = lanes * cap * fm_device.SLAB_ROW_BYTES // 3
        before = kernels.launches["scan_single"]
        err_split = max_abs_err(fm_device.scan_single(*args, slab_bytes=budget), plain)
        parts = kernels.launches["scan_single"] - before
        print(f"K3 first chunk with a slab budget of {budget} B: {parts} launches, "
              f"max_abs_err {err_split}")
        assert parts == len(fm_device.lane_parts(lanes, cap, budget)) > 1 and err_split == 0
        pair = search._cached_scanner(builder, dev, *groups, pair_step=True)
        assert views_equal(sc.collect(sc.dispatch(chunk_seqs, len(chunk_seqs), maxlen, mo)),
                           pair.collect(pair.dispatch(chunk_seqs, len(chunk_seqs), maxlen, mo))), \
            "K3's views differ from K1's at the first chunk"
        ms = cuda_ms(lambda: fm_device.scan_single(*args), 5)
        plain_ms = cuda_ms(lambda: fm_device.scan_single_plain(*args), 2)
        bound, traffic = scan_bound(lens, lim_t, 4, sc.nblocks, la_w.shape[1], int(plain[0][0]),
                                    single=True)
        live = live_steps(lens, lim_t, 4)
        print(f"K3 first chunk ({len(chunk_seqs)} reads, {lanes} lanes): views equal K1's; kernel "
              f"{ms:.4f} ms; plain {plain_ms:.3f} ms; bound {bound:.4f} ms (bytes, each row "
              f"once), row reads with re-reads {traffic} B = {bytes_ms(traffic):.4f} ms at HBM "
              f"rate, chain of {int(live.max()) + 2} dependent row reads at G3's {step_ns:.1f} "
              f"ns {(live.max() + 2) * step_ns / 1e6:.4f} ms")
        row = kernel_row(err, ms, plain_ms, bound, "bytes", None)
    for label, index, reads, n, groups, mo, slab in scan_edge_cases():
        fms = [fm_device.DeviceFM(h, dev) for h in edges[index]]
        plane, tail = single_scan_args(fms, groups, reads, n, mo, dev)
        before = kernels.launches["scan_single"]
        got = fm_device.scan_single(plane, *tail, slab_bytes=slab)
        parts = kernels.launches["scan_single"] - before
        plain = fm_device.scan_single_plain(plane, *tail)
        err = max_abs_err(got, plain)
        err_all = max(err_all, err)
        lanes = n * (len(groups[0]) + len(groups[1]))
        print(f"K3 edge case {index}: {label}: {lanes} lanes, lim_t {tail[5]}, {parts} "
              f"launches, blocks {int(plain[0][0])}, candidates {int(plain[0][1])}, "
              f"max_abs_err {err}")
        assert slab is None or parts > 1, parts
    assert err_all == 0
    row["max_abs_err"] = err_all
    return row


def check_sharded_kernel(dev, builder, seqs, step_ns, edges):
    """The index-sharded scan on the main path's index, for D in SHARDS on
    [cuda:0] * D (D separate allocations, so the shard table routes every
    row read): the kernel against its plain version, bit for bit, on the
    rmdup lane groups and, for D = 2, on the first full chunk (timed beside
    its plain version there); the first chunk's views against the
    replicated K3's; its wrapper and K3's in turn (3 rounds of 5 calls),
    beside the bounds, which are K3's (the same bytes move); then against its
    plain version on every case of `scan_edge_cases` over `edges`.  Returns
    the kernel's row of the JSON line (D = 2, the first chunk)."""
    fms = (fm_device.DeviceFM(builder.fmi, dev), fm_device.DeviceFM(builder.rfmi, dev))
    k3 = search._cached_scanner(builder, dev, *FWD_REV, pair_step=False)
    card = card_line()

    def packed(chunk_seqs):
        maxlen = search._bucket_len(max(map(len, chunk_seqs)))
        la_w, lens = fm_device.pack_reads_2bit(chunk_seqs, len(chunk_seqs), maxlen)
        lim_t = min(maxlen - 1, int(lens.max()) - 1)
        return maxlen, la_w, lens, (torch.from_numpy(la_w).to(dev), torch.from_numpy(lens).to(dev),
                                    lim_t)

    first = seqs[: search.chunk_size(len(seqs))]
    maxlen, la_w, lens, reads = packed(first)
    lim_t = reads[2]
    _rm_maxlen, _rm_la, _rm_lens, rm_reads = packed(seqs[:2048])
    want = k3.collect(k3.dispatch(first, len(first), maxlen, MIN_OVERLAP))
    k3_args = (k3.plane, k3.pred, k3.length, k3.nblocks, *reads, MIN_OVERLAP, *FWD_REV)
    err_all, row = 0, None
    for d in SHARDS:
        sc = sharded_scanner(fms, FWD_REV, d)
        rows = [int(s.shape[0]) for s in sc.shards]
        head = (sc.shards, sc.pred, sc.length, sc.nblocks)
        rm_args = (*head, *rm_reads, READ_LEN + 17, *RMDUP)
        err = max_abs_err(fm_device.scan_single_sharded(*rm_args),
                          fm_device.scan_single_sharded_plain(*rm_args))
        assert views_equal(sc.collect(sc.dispatch(first, len(first), maxlen, MIN_OVERLAP)), want), \
            f"the sharded scan's views (D = {d}) differ from K3's at the first chunk"
        args = (*head, *reads, MIN_OVERLAP, *FWD_REV)
        plain_ms = None
        if d == SHARDS[0]:
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            torch.cuda.synchronize()
            start.record()
            plain = fm_device.scan_single_sharded_plain(*args)
            end.record()
            torch.cuda.synchronize()
            plain_ms = start.elapsed_time(end)
            err = max(err, max_abs_err(fm_device.scan_single_sharded(*args), plain))
        err_all = max(err_all, err)
        ms, k3_ms = alternate([lambda: fm_device.scan_single_sharded(*args),
                               lambda: fm_device.scan_single(*k3_args)], 5, 3)
        out = fm_device.scan_single_sharded(*args)
        bound, traffic = scan_bound(lens, lim_t, 4, sc.nblocks, la_w.shape[1], int(out[0][0]),
                                    single=True)
        live = live_steps(lens, lim_t, 4)
        chain = (live.max() + 2) * step_ns / 1e6
        plain_text = f"; plain {plain_ms:.3f} ms (CUDA events, one call)" if plain_ms else ""
        print(f"sharded K3, D = {d} on [cuda:0] x {d} (shard rows {rows}): max_abs_err {err} "
              f"(rmdup groups{', first chunk' if plain_ms else ''}); first chunk "
              f"({len(first)} reads, {4 * len(first)} lanes) views equal K3's; wrapper "
              f"{spread(ms)}, K3's {spread(k3_ms)} (CUDA events, 3 rounds of 5 calls in turn)"
              f"{plain_text}; bound {bound:.4f} ms (bytes, as K3's), row reads with re-reads "
              f"{bytes_ms(traffic):.4f} ms at HBM rate, chain of {int(live.max()) + 2} dependent "
              f"row reads at G3's {step_ns:.1f} ns {chain:.4f} ms [{card}]", flush=True)
        if d == SHARDS[0]:
            row = kernel_row(0, float(np.median(ms)), plain_ms, bound, "bytes", None)
    cases = scan_edge_cases()
    for d in SHARDS:
        err_d = 0
        for _label, index, reads, n, groups, mo, slab in cases:
            fms = [fm_device.DeviceFM(h, dev) for h in edges[index]]
            shards, tail = single_scan_args(fms, groups, reads, n, mo, dev,
                                            devices=[torch.device("cuda", 0)] * d)
            got = fm_device.scan_single_sharded(shards, *tail, slab_bytes=slab)
            err_d = max(err_d, max_abs_err(got, fm_device.scan_single_sharded_plain(shards, *tail)))
        print(f"sharded K3, D = {d} on [cuda:0] x {d}: {len(cases)} edge cases "
              f"(scan_edge_cases), max_abs_err {err_d}", flush=True)
        err_all = max(err_all, err_d)
    assert err_all == 0
    row["max_abs_err"] = err_all
    return row


def stage_a_chunk_args(seqs, fm, dev):
    """K9's arguments at one overlap chunk's shape: the first STAGE_A_LANES
    of the main path's reads `seqs` as lanes (the reads as they are: ID
    lanes; 149 steps) over the forward single-step plane of `fm` (the main
    path's forward DeviceFM), at -m MIN_OVERLAP."""
    chars, lens = dryrun.stage_a_chars(seqs[:STAGE_A_LANES])
    return (chars.shape[1] - 1, MIN_OVERLAP, fm.occ_plane, fm.pred_dev, fm.length,
            torch.from_numpy(chars).to(dev), torch.from_numpy(lens).to(dev), None)


def once_ms(fn):
    """(fn(), its ms by CUDA events): one call, the card synchronised first."""
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    out = fn()
    end.record()
    torch.cuda.synchronize()
    return out, start.elapsed_time(end)


def stage_a_err(got, want) -> int:
    """Largest difference of K9's four outputs from the plain version's;
    shapes and types must be equal."""
    for a, b in zip(got, want, strict=True):
        assert a.dtype == b.dtype, (a.dtype, b.dtype)
    return max_abs_err(got, want)


def check_stage_a_kernel(dev, builder, seqs, step_ns):
    """K9 against its plain version, bit for bit in all four outputs: at one
    overlap chunk's shape (`stage_a_chunk_args`; timed beside its bounds,
    the plain version by the one call compared), then on every case of
    `stage_a_edge_cases` (their indexes built on the card).  Returns the
    kernel's row of the JSON line (the chunk)."""
    args = stage_a_chunk_args(seqs, fm_device.DeviceFM(builder.fmi, dev), dev)
    max_t, L, nblocks = args[0], args[5].shape[0], args[2].shape[0]
    plain, plain_ms = once_ms(lambda: fm_device.scan_stage_a_plain(*args))
    err = stage_a_err(fm_device.scan_stage_a(*args), plain)
    ms = cuda_ms(lambda: fm_device.scan_stage_a(*args), 10)
    by_bytes, by_chain = stage_a_bound(nblocks, step_ns, L, max_t)
    print(f"K9 scan_stage_a at {L} lanes x {max_t} steps (-m {MIN_OVERLAP}): valid "
          f"{int(plain[1].sum())}, max_abs_err {err}; kernel {ms:.4f} ms (CUDA events, 10 calls); "
          f"plain {plain_ms:.3f} ms (one call); bound {by_bytes:.4f} ms by bytes, "
          f"{by_bytes / ms:.1%} of it; "
          f"chain of {max_t + 2} dependent row reads at G3's {step_ns:.1f} ns "
          f"{by_chain:.4f} ms [{card_line()}]", flush=True)
    indexes = edge_indexes(dev, stage_a_index_reads())
    fms = {label: [fm_device.DeviceFM(h, dev) for h in pair] for label, pair in indexes.items()}
    err_all = err
    for case in stage_a_edge_cases():
        case_args = stage_a_args(case, fms[case[1]], dev)
        e = stage_a_err(fm_device.scan_stage_a(*case_args),
                        fm_device.scan_stage_a_plain(*case_args))
        print(f"K9 edge case {case[0]}: {case_args[5].shape[0]} lanes, max_t {case_args[0]}, "
              f"-m {case_args[1]}, max_abs_err {e}")
        err_all = max(err_all, e)
    assert err_all == 0, err_all
    return kernel_row(err_all, ms, plain_ms, by_bytes, "bytes", None)


def trace_stage_a(args) -> float | None:
    """K9 at `args` (`stage_a_chunk_args`): the kernel's device span of
    SCAN_ROUNDS calls by a torch.profiler trace, beside the wrapper's wall by
    CUDA events.  Returns the median device ms, or None when the trace holds
    another number of K9 spans."""
    wall = [cuda_ms(lambda: fm_device.scan_stage_a(*args), 1) for _ in range(SCAN_ROUNDS)]

    def rounds():
        for _ in range(SCAN_ROUNDS):
            fm_device.scan_stage_a(*args)

    dev_ms, n_ops, by_name, prof = trace_device(rounds)
    mine = kernel_spans(prof, "scan_stage_a")
    if len(mine) != SCAN_ROUNDS:
        print(f"K9: the trace holds {len(mine)} kernel spans for {SCAN_ROUNDS} calls: kernel "
              f"device time not measured")
        return None
    rest = (dev_ms - sum(mine)) / SCAN_ROUNDS
    print(f"K9 scan_stage_a at {args[5].shape[0]} lanes x {args[0]} steps, in time_scans' "
          f"process: kernel device time (torch.profiler, {SCAN_ROUNDS} calls) {spread(mine)}; the rest of "
          f"a call's device time {rest:.4f} ms in {(n_ops - len(mine)) / SCAN_ROUNDS:.0f} "
          f"operations; the wrapper's wall (CUDA events, one call each) {spread(wall)} "
          f"[{card_line()}]")
    return float(np.median(mine))


def time_sw_long(dev):
    """K5 at B = 4,096 pairs of a 1,500-symbol query and a 400-symbol ref
    (random codes, seed SEED): two strips a pair; bit for bit against its
    plain version, each timed by CUDA events (the plain version by the one
    call compared) beside the operations bound."""
    rng = np.random.default_rng(SEED)
    B, M, N = 4096, 1500, 400
    q = torch.from_numpy(rng.integers(1, 5, (B, M)).astype(np.int32)).to(dev)
    r = torch.from_numpy(rng.integers(1, 5, (B, N)).astype(np.int32)).to(dev)
    before = kernels.launches["sw_wavefront"]
    got = sw.sw_wavefront(q, r, *SW_PARAMS)
    strips = kernels.launches["sw_wavefront"] - before
    plain, plain_ms = once_ms(lambda: sw.sw_wavefront_plain(q, r, *SW_PARAMS))
    err = max_abs_err(got, plain)
    ms = cuda_ms(lambda: sw.sw_wavefront(q, r, *SW_PARAMS), 5)
    bound = SW_OPS_PER_CELL * B * M * N / SCALAR_OPS_PER_S * 1e3
    print(f"K5 B={B} q={M} r={N} ({strips} strips, {len(sw.sw_strips(M))} expected): max_abs_err "
          f"{err}, kernel {ms:.4f} ms, plain {plain_ms:.3f} ms (one call), bound {bound:.4f} ms "
          f"(operations), {bound / ms:.1%} of it [{card_line()}]", flush=True)
    assert err == 0 and strips == len(sw.sw_strips(M)) == 2, (err, strips)
    return err


def run_dryrun():
    """The port's compile-check entry on cuda:0 and its multi-device dry run
    over [cuda:0] * 4, counts reset just before them: K9 (the entry and the
    dry run's stage-A step, 4 parts and the whole batch) and the
    index-sharded scan must launch.  Returns their counts."""
    kernels.reset_launches()
    t0 = time.time()
    fn, example = dryrun.entry(torch.device("cuda", 0))
    emitted, valid, final, lext = fn(*example)
    torch.cuda.synchronize()
    out = dryrun.dryrun_multidevice([torch.device("cuda", 0)] * 4)
    ran = dict(kernels.launches)
    print(f"dryrun.entry(cuda:0): emitted {tuple(emitted.shape)}, valid {int(valid.sum())}, "
          f"final {tuple(final.shape)}, lext {tuple(lext.shape)}; "
          f"dryrun_multidevice([cuda:0] x 4): {time.time() - t0:.3f} s, {out}; launches {ran}")
    assert ran["scan_single_sharded"] >= 1 and ran["scan_stage_a"] >= 6, ran
    return ran


def kernel_row(err, ms, plain_ms, bound, bound_by, library_ms):
    return {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms, "bound_ms": bound,
            "bound_by": bound_by, "library_ms": library_ms}


def check_scan_pipeline(dev, workdir, step_ns):
    """K1 against its plain version at the pipeline's own shapes, with the
    lane groups of `overlap --no-opposite-strand` (ID and REV): the first
    chunk of reads.ec.fa at -m 85, and the one length-sorted chunk of all of
    primary-contigs.rmdup.fa at -m 10 (lanes up to the longest contig).  The
    chunks are cut as `search.batch_overlap_hits` cuts them.  The plain
    version runs once a case, timed by CUDA events; the kernel is timed
    beside its bounds (`step_ns`: one dependent step of G3
    on the pair plane).  At the contigs, K3's views equal K1's (no plain
    version there: K1's took 91-118 s), K3 timed beside its bounds.
    Returns the largest error."""
    err_all = 0
    for name, prefix, mo in (("reads.ec.fa first chunk", "reads.ec", READS_MIN_OVERLAP),
                             ("contigs", "primary-contigs.rmdup", CTG_MIN_OVERLAP)):
        path = os.path.join(workdir, prefix)
        fms = (fm_device.DeviceFM(FMIndex.load(path + ".bwt"), dev),
               fm_device.DeviceFM(FMIndex.load(path + ".rbwt"), dev))
        id_rev = ((fm_device.GROUP_ID,), (fm_device.GROUP_REV,))
        sc = fm_device.DualScanner(*fms, *id_rev, pair_step=True)
        seqs = [r.seq for r in fastx.read_sequences(path + ".fa")]
        lens = sorted(map(len, seqs))
        if lens[-1] > 2 * max(lens[len(lens) // 2], 1):
            seqs.sort(key=len)
        chunk = seqs[: search.chunk_size(len(seqs))]
        maxlen = search._bucket_len(max(map(len, chunk)))
        la_w, lens_t = fm_device.pack_reads_2bit(chunk, len(chunk), maxlen)
        lim_t = min(maxlen - 1, int(lens_t.max()) - 1)
        args = (
            sc.plane, sc.K2, sc.pred, sc.length, sc.nblocks,
            torch.from_numpy(la_w).to(dev), torch.from_numpy(lens_t).to(dev),
            lim_t, mo, sc.fwd_groups, sc.rev_groups,
        )
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        start.record()
        plain = fm_device.scan_pair_plain(*args)
        end.record()
        torch.cuda.synchronize()
        err = max_abs_err(fm_device.scan_pair(*args), plain)
        err_all = max(err_all, err)
        ms = cuda_ms(lambda: fm_device.scan_pair(*args), 3)
        live = live_supersteps(lens_t, lim_t, 2)
        bound, traffic = scan_bound(lens_t, lim_t, 2, sc.nblocks, la_w.shape[1], int(plain[0][0]))
        print(f"K1 {name} (-m {mo}, groups ID/REV): {len(chunk)} of {len(seqs)} sequences, "
              f"{2 * len(chunk)} lanes of {maxlen} symbols, lim_t {lim_t}, "
              f"blocks {int(plain[0][0])}, candidates {int(plain[0][1])}, max_abs_err {err}; kernel "
              f"{ms:.4f} ms, plain {start.elapsed_time(end):.3f} ms; bound {bound:.4f} ms (bytes, each row "
              f"once), row reads with re-reads {bytes_ms(traffic):.4f} ms at HBM rate, longest lane "
              f"{int(live.max())} supersteps = {live.max() * step_ns / 1e6:.4f} ms of dependent "
              f"steps at G3's {step_ns:.1f} ns", flush=True)
        if name == "contigs":
            check_single_contigs(fms, id_rev, chunk, maxlen, mo, args, step_ns)
        del sc, fms, args, plain
    assert err_all == 0
    return err_all


def check_single_contigs(fms, groups, chunk, maxlen, mo, pair_args, step_ns):
    """K3 at the contigs' chunk: its views equal K1's (`pair_args`, K1's
    arguments there), and its time beside its bounds."""
    sc = fm_device.DualScanner(*fms, *groups, pair_step=False)
    pair = fm_device.DualScanner(*fms, *groups, pair_step=True)
    assert views_equal(sc.collect(sc.dispatch(chunk, len(chunk), maxlen, mo)),
                       pair.collect(pair.dispatch(chunk, len(chunk), maxlen, mo))), \
        "K3's views differ from K1's at the contigs"
    _plane, _K2, pred, length, nblocks, la_w, lens, lim_t, *_rest = pair_args
    args = (sc.plane, pred, length, nblocks, la_w, lens, lim_t, mo, *groups)
    out = fm_device.scan_single(*args)
    ms = cuda_ms(lambda: fm_device.scan_single(*args), 3)
    lens_h = lens.cpu().numpy()
    bound, traffic = scan_bound(lens_h, lim_t, 2, nblocks, la_w.shape[1], int(out[0][0]),
                                single=True)
    live = live_steps(lens_h, lim_t, 2)
    print(f"K3 contigs (-m {mo}, groups ID/REV): views equal K1's; {len(chunk)} sequences, "
          f"blocks {int(out[0][0])}; kernel {ms:.4f} ms; bound {bound:.4f} ms (bytes, each row "
          f"once), row reads with re-reads {bytes_ms(traffic):.4f} ms at HBM rate, longest lane "
          f"{int(live.max())} steps = {live.max() * step_ns / 1e6:.4f} ms of dependent steps at "
          f"G3's {step_ns:.1f} ns", flush=True)
    views = sc.collect(sc.dispatch(chunk, len(chunk), maxlen, mo))
    card = card_line()
    per_step = {}
    for d in SHARDS:
        sh = sharded_scanner(fms, groups, d)
        assert views_equal(sh.collect(sh.dispatch(chunk, len(chunk), maxlen, mo)), views), \
            f"the sharded scan's views (D = {d}) differ from K3's at the contigs"
        sargs = (sh.shards, pred, length, nblocks, la_w, lens, lim_t, mo, *groups)
        ms_d = cuda_ms(lambda: fm_device.scan_single_sharded(*sargs), 3)
        per_step[d] = ms_d * 1e3 / live.max()
        print(f"sharded K3 contigs, D = {d} on [cuda:0] x {d}: views equal K3's; {ms_d:.4f} ms, "
              f"{per_step[d]:.4f} us a step of the longest lane (K3 {ms:.4f} ms, "
              f"{ms * 1e3 / live.max():.4f} us a step) [{card}]", flush=True)


def check_sw_kernel(dev, edges):
    """K5 against its plain version, bit for bit: at B = 4,096, 150 x 400
    (`kernel_ab.sw_synthetic_pairs`; 16 pairs also against a naive DP), on
    the main path's edges (`edges`: its sampled (query, ref) strings) and on
    every case of `sw.sw_edge_cases`; timed at the first two shapes."""
    qs, rs = sw_synthetic_pairs(SEED)
    qt, rt = sw_tensors(qs, rs, dev)
    got = sw.sw_wavefront(qt, rt, *SW_PARAMS)
    err = max_abs_err(got, sw.sw_wavefront_plain(qt, rt, *SW_PARAMS))
    assert got[0][:16].cpu().tolist() == [naive_sw(q, r) for q, r in zip(qs[:16], rs[:16])], \
        "K5 disagrees with the naive DP"
    ms = cuda_ms(lambda: sw.sw_wavefront(qt, rt, *SW_PARAMS), 10)
    plain_ms = cuda_ms(lambda: sw.sw_wavefront_plain(qt, rt, *SW_PARAMS), 2)
    (B, M), N = qt.shape, rt.shape[1]
    bound = max(SW_OPS_PER_CELL * B * M * N / SCALAR_OPS_PER_S * 1e3,
                bytes_ms((B * M + B * N) * 4 + 3 * B * 4))
    print(f"K5 B=4096 q=150 r=400: max_abs_err {err}, kernel {ms:.4f} ms, "
          f"plain {plain_ms:.3f} ms, bound {bound:.4f} ms (operations: {SW_OPS_PER_CELL} a cell "
          f"at {SCALAR_OPS_PER_S:.3g}/s), {bound / ms:.1%} of it; 16 pairs equal the naive DP "
          f"[{card_line()}]")
    eq, er = sw_tensors(*edges, dev)
    e_err = max_abs_err(sw.sw_wavefront(eq, er, *SW_PARAMS), sw.sw_wavefront_plain(eq, er, *SW_PARAMS))
    e_ms = cuda_ms(lambda: sw.sw_wavefront(eq, er, *SW_PARAMS), 10)
    (eB, eM), eN = eq.shape, er.shape[1]
    e_bound = SW_OPS_PER_CELL * eB * eM * eN / SCALAR_OPS_PER_S * 1e3
    print(f"K5 on the main path's {eB} edges ({eM} x {eN}, queries of "
          f"{min(map(len, edges[0]))}-{max(map(len, edges[0]))} zero-padded): max_abs_err "
          f"{e_err}, kernel {e_ms:.4f} ms, bound {e_bound:.4f} ms (operations)")
    for label, q, r, params in sw.sw_edge_cases():
        a, b = torch.from_numpy(q).to(dev), torch.from_numpy(r).to(dev)
        e = max_abs_err(sw.sw_wavefront(a, b, *params), sw.sw_wavefront_plain(a, b, *params))
        print(f"K5 edge {label}: max_abs_err {e}")
        err = max(err, e)
    err = max(err, e_err)
    assert err == 0, err
    return kernel_row(err, ms, plain_ms, bound, "operations", None)


def port_cmd(argv, cwd, timeout=STAGE_TIMEOUT):
    """`python -m siga_tpu_torch ARGV` in a fresh process in `cwd`: returns its
    wall, the kernel launches it reports and its own `[cmd] wall:` line;
    raises when it fails or runs
    past `timeout` seconds (the child is killed then)."""
    t0 = time.time()
    proc = subprocess.run(
        [sys.executable, "-m", "siga_tpu_torch", *argv], cwd=cwd, env=CHILD_ENV,
        capture_output=True, text=True, timeout=timeout,
    )
    wall = time.time() - t0
    if proc.returncode != 0:
        raise RuntimeError(f"{' '.join(argv)} exited {proc.returncode}:\n{proc.stderr[-4000:]}")
    ran, own = {}, ""
    for line in proc.stderr.splitlines():
        if "] kernel launches: " in line:
            ran = json.loads(line.split("] kernel launches: ", 1)[1])
        elif line.startswith(f"[{argv[0]}] wall: "):
            own = line
    if own:  # the command's own wall, from its start to its end
        print(f"  {argv[0]}: process {wall:.3f} s; {own}", flush=True)
    return wall, ran, own


def count_records(path) -> int:
    with open(path) as f:
        return sum(line.startswith(">") for line in f)


def run_pipeline(workdir):
    """The ecoli_scale.py 1.0 25 0.005 read set, then its eleven stages
    through the port's CLI on the card, each in a fresh process; the contig
    facts against BASELINE.md.  Returns the launches of its device stages."""
    n = PIPE_GENOME
    genome = np.frombuffer(b"ACGT", dtype=np.uint8)[
        np.random.default_rng(42).integers(0, 4, n)
    ].tobytes().decode()
    with open(os.path.join(workdir, "ref.fa"), "w") as f:
        f.write(">ref\n")
        for i in range(0, n, 80):
            f.write(genome[i : i + 80] + "\n")
    t0 = time.time()
    out = subprocess.run(
        [sys.executable, os.path.join(REPO, "benchmark", "paired_read_gen.py"), "ref.fa",
         "150", str(PIPE_COVERAGE), "400", "20", "1", str(PIPE_ERR)],
        cwd=workdir, check=True, capture_output=True, text=True, timeout=STAGE_TIMEOUT,
    )
    prefix = out.stdout.strip().splitlines()[-1]
    print(f"generate {time.time() - t0:.3f} s: {prefix}_R1/_R2.fasta", flush=True)
    launches = {name: 0 for name in kernels.launches}
    walls = {}
    for name, argv in pipeline_stages(f"{prefix}_R1.fasta", f"{prefix}_R2.fasta", "cuda"):
        walls[name], ran, _own = port_cmd(argv, workdir)
        print(f"stage {name}: {walls[name]:.3f} s, launches {ran}   ({' '.join(argv)})", flush=True)
        if name.startswith(("overlap", "rmdup")):
            assert ran.get("scan_pair", 0) >= 1, (name, ran)
            assert ran.get("pair_plane", 0) >= 2, (name, ran)
        for k, v in ran.items():
            launches[k] += v
    print(f"pipeline wall {sum(walls.values()):.3f} s over {len(walls)} stages")
    n_reads = count_records(os.path.join(workdir, "reads.ec.fa"))
    with open(os.path.join(workdir, "final-contigs.fa")) as f:
        stats = subprocess.run(
            [sys.executable, os.path.join(REPO, "benchmark", "contigs_mapping.py"), "300", "ref.fa",
             "fasta", "unmatched.fa"],
            stdin=f, cwd=workdir, check=True, capture_output=True, text=True, timeout=STAGE_TIMEOUT,
        ).stdout
    facts = {"reads_corrected": n_reads}
    for line in stats.splitlines():
        key, _, value = line.partition(":")
        if key in PIPE_FACTS and value.strip():
            facts[key] = int(value.split()[0])
    print(f"pipeline facts {json.dumps(facts)}")
    assert facts == PIPE_FACTS, f"pipeline facts differ from BASELINE.md: {facts} vs {PIPE_FACTS}"
    print("pipeline facts equal BASELINE.md (166,638 reads; 213/213/0; N50 8,505; N90 2,085; "
          "MAX 39,173; 999,189 bp covered)")
    return launches


def check_correct_subset(workdir):
    """`correct` of every 8th preprocessed read against the whole read set's
    index: the read count differs from the index's, so the k-mers are counted
    by K7 on the card.  Each read is corrected alone, and the index's counts
    equal the read set's window counts, so the output must equal those reads'
    records in the pipeline's reads.ec.fa."""
    reads = fastx.read_sequences(os.path.join(workdir, "reads.pp.fastq"))
    sub = reads[::8]
    fastx.write_sequences(os.path.join(workdir, "reads.sub.fastq"), sub)
    wall, ran, own = port_cmd(
        ["correct", "--device", "cuda", "-k", "41", "-p", "reads.pp", "-o", "sub.ec.fa",
         "reads.sub.fastq"], workdir)
    print(f"correct of {len(sub)} reads against the {len(reads)}-read index (K7 on cuda): "
          f"{wall:.3f} s, launches {ran}")
    assert ran.get("kmer_count", 0) >= 1 and ran.get("pair_plane", 0) >= 1, ran
    n_kmers = int(own.split(" k-mers in ")[0].rsplit(" ", 1)[1])
    print(f"K7 route: {n_kmers} k-mers in {ran['kmer_count']} launches, "
          f"{n_kmers / ran['kmer_count']:.2f} k-mers a launch ({own.split(', ', 3)[-1]})")
    names = {r.name for r in sub}
    assert len(names) == len(sub), "read names are not unique"
    want = [r.format() for r in fastx.read_sequences(os.path.join(workdir, "reads.ec.fa"))
            if r.name in names]
    got = [r.format() for r in fastx.read_sequences(os.path.join(workdir, "sub.ec.fa"))]
    assert got == want, f"sub.ec.fa ({len(got)} records) differs from reads.ec.fa's ({len(want)})"
    print(f"sub.ec.fa: {len(got)} records, equal to those reads' records in reads.ec.fa")
    return ran, reads


def check_k7(dev, reads, rng, workdir, step_ns):
    """K7 against its plain version on the forward plane of the whole read
    set's index: 41-mers drawn from the reads, the same with one base
    substituted, and the same with an N."""
    fmi = FMIndex.load(os.path.join(workdir, "reads.pp.bwt"))
    dfm = fm_device.DeviceFM(fmi, dev)
    k, third = K7_K, K7_QUERIES // 3
    seqs = [r.seq for r in reads if len(r.seq) >= k]
    kmers = []
    for i in rng.integers(0, len(seqs), K7_QUERIES):
        s = seqs[i]
        j = int(rng.integers(0, len(s) - k + 1))
        kmers.append(s[j : j + k])
    for q in range(third, K7_QUERIES):
        w, p = kmers[q], int(rng.integers(0, k))
        c = "N" if q >= 2 * third else "ACGT"[("ACGT".index(w[p]) + int(rng.integers(1, 4))) % 4]
        kmers[q] = w[:p] + c + w[p + 1 :]
    codes = torch.from_numpy(kmer_count.encode_kmers(kmers)).to(dev)
    plain = kmer_count.count_kmers_plain(dfm, codes)
    got = kmer_count.count_kmers(dfm, codes)
    err = max_abs_err([got], [plain])
    sample = rng.integers(0, K7_QUERIES, 300)
    host = [fmi.occurrences(kmers[q]) for q in sample]
    assert got[torch.from_numpy(sample).to(dev)].cpu().tolist() == host, "K7 differs from FMIndex"
    counts = got.cpu().numpy()
    ms = cuda_ms(lambda: kmer_count.count_kmers(dfm, codes), 10)
    plain_ms = cuda_ms(lambda: kmer_count.count_kmers_plain(dfm, codes), 2)
    # bound: a present k-mer takes all (k - 1) / 2 pair steps, an absent one
    # at least one; two rows a step, each row counted at most once
    present = int((counts > 0).sum())
    row_reads = 2 * (present * -(-(k - 1) // 2) + (K7_QUERIES - present)) + 1
    bound = bytes_ms(min(row_reads * ROW_NEED_BYTES, dfm.nblocks * ROW_BYTES)
                     + K7_QUERIES * (k + 4))
    print(f"K7 {K7_QUERIES} {k}-mers on the forward plane ({dfm.length} chars): max_abs_err {err} "
          f"present {int((counts[:third] > 0).sum())}/{third}, "
          f"substituted "
          f"present {int((counts[third:2 * third] > 0).sum())}, with N present "
          f"{int((counts[2 * third:] > 0).sum())}; 300 sampled equal FMIndex.occurrences; kernel "
          f"{ms:.4f} ms, plain {plain_ms:.4f} ms; bound {bound:.4f} ms (bytes, each row once), row reads "
          f"with re-reads {bytes_ms(row_reads * ROW_NEED_BYTES):.4f} ms at HBM rate")
    assert err == 0 and (counts[:third] > 0).all()
    # the `correct` route's own sizes: the device time of one launch, and the
    # wall of one KmerCounter call (encode, copy in, launch, copy back)
    counter = kmer_count.KmerCounter(dfm)
    for size in K7_ROUTE_SIZES:
        sub = codes[:size]
        err_s = max_abs_err([kmer_count.count_kmers(dfm, sub)],
                            [kmer_count.count_kmers_plain(dfm, sub)])
        assert err_s == 0, size
        t_small = cuda_ms(lambda: kmer_count.count_kmers(dfm, sub), 50)
        counter(kmers[:size])
        t0 = time.time()
        for _ in range(200):
            counter(kmers[:size])
        wall_ms = (time.time() - t0) / 200 * 1e3
        print(f"K7 {size} {k}-mers (the correct route's size): max_abs_err {err_s}; device "
              f"{t_small:.4f} ms; KmerCounter call wall {wall_ms:.4f} ms; bound "
              f"{-(-(k - 1) // 2) * step_ns / 1e6:.4f} ms ({-(-(k - 1) // 2)} dependent steps at "
              f"G3's {step_ns:.1f} ns)")
    return kernel_row(err, ms, plain_ms, bound, "bytes", None)


def check_overlap_workers(workdir):
    """Two `--process-id` workers at once on the card over reads.ec.fa (the
    port's launcher), then `--merge-only -t 2`, against one process's
    `overlap -t 2`: the ASQG must be equal."""
    args = ["-m", "85", "--no-opposite-strand", "-p", "reads.ec"]
    dirs = {}
    for mode in ("workers", "single"):
        d = dirs[mode] = os.path.join(workdir, mode)
        os.mkdir(d)
        for ext in ("fa", "bwt", "rbwt", "sai", "rsai"):
            os.symlink(os.path.join(workdir, f"reads.ec.{ext}"), os.path.join(d, f"reads.ec.{ext}"))
    t0 = time.time()
    home = os.getcwd()
    os.chdir(dirs["workers"])
    try:
        multihost.launch_overlap_2proc(
            "reads.ec.fa", "reads.ec", 85, extra_args=["--no-opposite-strand", "--device", "cuda"])
    finally:
        os.chdir(home)
    workers_s = time.time() - t0
    single_s, ran, _own = port_cmd(["overlap", "--device", "cuda", *args, "-t", "2", "reads.ec.fa"],
                             dirs["single"])
    assert ran.get("scan_pair", 0) >= 1, ran
    asqg = []
    for d in dirs.values():
        with gzip.open(os.path.join(d, "reads.ec.asqg.gz")) as f:
            asqg.append(f.read())
    assert asqg[0] == asqg[1], "the workers' merged ASQG differs from the single process's"
    print(f"overlap: 2 workers + merge {workers_s:.3f} s, one process -t 2 {single_s:.3f} s; "
          f"ASQG equal ({asqg[0].count(b'\nED\t')} ED records)")


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--keep-pipeline", metavar="DIR",
                        help="run the pipeline in DIR (a new directory) and keep it")
    args = parser.parse_args(argv)
    keep = os.path.abspath(args.keep_pipeline) if args.keep_pipeline else None
    t_start = time.time()
    phase("card")
    print(card_line(), flush=True)
    if not torch.cuda.is_available():
        raise SystemExit("CUDA is not available")
    dev = torch.device("cuda")

    global WATCH
    WATCH = ScanWatch()
    phase("build the kernels and the host runtime")
    t0 = time.time()
    report = kernels.build()
    kernels.lib()
    print(f"nvcc_build_s {time.time() - t0:.3f}")
    print(f"lane group: K1 and K7 run G = {kernels.lib().siga_lane_group()} threads a lane "
          f"(csrc/pair_occ.cuh)")
    for line in ptxas_summary(report):
        print("  ptxas:", line)
    t0 = time.time()
    native_lib()
    print(f"native_build_s {time.time() - t0:.3f}")

    phase("simulate")
    rng = np.random.default_rng(SEED)
    seqs = simulate_reads(rng, GENOME)
    print(f"reads {len(seqs)} x {READ_LEN} bp, genome {GENOME} bp, coverage {COVERAGE}")

    workdir = tempfile.mkdtemp(prefix="siga_chip_smoke_")
    home = os.getcwd()
    os.chdir(workdir)
    try:
        phase("main path: index (-a sais2 on cuda) -> overlap -> SW scoring of the edges")
        launches, index_s, sw_edges = run_main_path(dev, seqs, rng)
        n_chunks = -(-len(seqs) // search.chunk_size(len(seqs)))
        assert launches["scan_pair"] == n_chunks, (launches, n_chunks)  # one scan launch a chunk
        assert launches["sw_wavefront"] >= 1, launches
        assert launches["pair_plane"] == 2, launches  # overlap's plane of each direction
        assert all(launches[name] >= 2 for name in SA_TIMED), launches  # K6, both directions
        phase("engine, warm")
        builder, hits = run_engine(dev, seqs)
        phase("engine with chunks in flight: each setting in turn, the sync check, one copy a "
              "chunk")
        check_engine_in_flight(dev, builder, seqs, hits)
        check_split_pack(dev, builder, seqs)
        phase("engine with each chunk split over the device list [cuda:0, cuda:0]")
        check_engine_split(builder, seqs, hits)
        phase("overlap with SIGA_PAIR_STEP=0: the single-step scan K3")
        launches["scan_single"] += run_single_step_overlap()["scan_single"]
        phase("kernels against their plain versions")
        k1 = check_scan_kernel(dev, builder, seqs)
        k5 = check_sw_kernel(dev, sw_edges)
        k5["max_abs_err"] = max(k5["max_abs_err"], time_sw_long(dev))
        edges = edge_indexes(dev)
        k2_err = check_plane_kernel(dev, edges)
        phase("hits of sampled reads against the host engine")
        check_hits(builder, hits, seqs, rng)
        phase("index -a host against -a sais2")
        check_host_index(index_s)
        phase("K6 (the device suffix sort) against its plain steps and the all-torch route")
        k6 = check_sa_kernels(dev, seqs)
        time_index_layers(dev, seqs)
        phase("the distributed index build (K8) on [cuda:0] x D against K6 and the index files")
        k8_launches, k8 = time_dist_build(dev, seqs)
        launches.update(k8_launches)
        phase("rmdup on the card, then with SIGA_PAIR_STEP=0 (K3)")
        launches["scan_single"] += run_rmdup(builder, seqs, rng)["scan_single"]
        phase("gather probes: the probe CLI on the pair plane")
        for name, n in run_probe_path().items():
            launches[name] += n
        phase("gather probes against their plain versions")
        probes, step_ns = check_probes(dev, search._cached_scanner(builder, dev, *FWD_REV).plane)
        check_probe_range_assert()
        phase("K9 (the stage-A scan with '$'-probes) against its plain version")
        k9 = check_stage_a_kernel(dev, builder, seqs, step_ns)
        phase("K3 against its plain version, and its views against K1's")
        k3 = check_single_kernel(dev, builder, seqs, step_ns, edges)
        phase("the index-sharded scan on [cuda:0] x D against its plain version and K3")
        ks = check_sharded_kernel(dev, builder, seqs, step_ns, edges)
        phase("the port's multi-device dry run over [cuda:0] x 4")
        for name, n in run_dryrun().items():
            launches[name] += n
        phase("K1, K3 and the sharded scan at the first chunk, kernel and compaction apart "
              "(torch.profiler)")
        scan_device_ms = in_child("time_scans")
        k1["device_ms"], k3["device_ms"] = scan_device_ms["scan_pair"], scan_device_ms["scan_single"]
        ks["device_ms"] = scan_device_ms[f"scan_single_sharded D={SHARDS[0]}"]
        k9["device_ms"] = scan_device_ms.pop("scan_stage_a")
        chain = (READ_LEN + 1) * step_ns / 1e6
        for label, ms in scan_device_ms.items():
            if not label.startswith("scan_single"):
                continue  # K1's chain is its supersteps'
            share = f"{chain / ms:.1%}" if ms else "not measured"
            print(f"{label} at {PROBE_LANES} lanes: kernel device time {ms} ms, {share} of the "
                  f"chain bound {chain:.4f} ms ({READ_LEN + 1} dependent row reads at G3's "
                  f"{step_ns:.1f} ns) [{card_line()}]")
        del builder, hits
        torch.cuda.empty_cache()
        pipe_dir = keep or os.path.join(workdir, "pipeline")
        os.makedirs(pipe_dir)
        phase("pipeline: benchmark/ecoli_scale.py 1.0 25 0.005 through the port's CLI on the card")
        for name, n in run_pipeline(pipe_dir).items():
            launches[name] += n
        phase("K1 against its plain version at the pipeline's shapes")
        k1["max_abs_err"] = max(k1["max_abs_err"], check_scan_pipeline(dev, pipe_dir, step_ns))
        torch.cuda.empty_cache()
        phase("correct of every 8th read through K7, against the whole read set's index")
        ran, pp_reads = check_correct_subset(pipe_dir)
        for name, n in ran.items():
            launches[name] += n
        phase("K7 against its plain version")
        k7 = check_k7(dev, pp_reads, np.random.default_rng(SEED), pipe_dir, step_ns)
        phase("K2: the plane build against its plain version, by torch.profiler and CUDA events")
        k2 = in_child("time_plane_build")
        k2["max_abs_err"] = k2_err
        phase("overlap: two worker processes on the card + --merge-only, against one process")
        check_overlap_workers(pipe_dir)
    finally:
        os.chdir(home)
        shutil.rmtree(workdir)

    kernel_rows = []
    rows = [
        ("pair_plane", "siga_tpu_torch/csrc/pair_plane.cu", "siga_tpu/ops/fm_device.py:702", k2),
        ("scan_pair", "siga_tpu_torch/csrc/scan_pair.cu", "siga_tpu/ops/fm_device.py:858", k1),
        ("scan_single", "siga_tpu_torch/csrc/scan_single.cu", "siga_tpu/ops/fm_device.py:504", k3),
        ("scan_single_sharded", "siga_tpu_torch/csrc/scan_single.cu",
         "siga_tpu/ops/fm_device.py:1165", ks),
        ("scan_stage_a", "siga_tpu_torch/csrc/stage_a.cu", "siga_tpu/ops/fm_device.py:1210", k9),
        ("sw_wavefront", "siga_tpu_torch/csrc/sw.cu", "siga_tpu/ops/sw_pallas.py:32", k5),
        ("kmer_count", "siga_tpu_torch/csrc/kmer_count.cu", "siga_tpu/ops/kmer_count.py:23", k7),
    ] + [
        (name, "siga_tpu_torch/csrc/suffix_sort.cu",
         "siga_tpu/index/sa.py:" + ("361" if name == "sa_bwt_perm" else "221"), row)
        for name, row in k6.items()
    ] + [
        (name, "siga_tpu_torch/csrc/dist_sort.cu", "siga_tpu/parallel/dist_build.py:123", row)
        for name, row in k8.items()
    ] + [
        (name, "siga_tpu_torch/csrc/gather_probe.cu", replaces, row)
        for name, (row, replaces) in probes.items()
    ]
    for name, source, replaces, row in rows:
        kernel_rows.append({
            "name": name, "route": "cuda", "source": source, "replaces": replaces,
            "launches": launches[name], **row,
        })
    print(f"dispatches under torch.cuda.set_sync_debug_mode('error'), by scan kernel: "
          f"{WATCH.dispatches} (none waited on the card)")
    assert all(WATCH.dispatches.get(name) for name in ("scan_pair", "scan_single",
                                                       "scan_single_sharded")), WATCH.dispatches
    print(f"chip_smoke_s {time.time() - t_start:.3f} (the whole script, the kernels' build "
          f"included)")
    print(json.dumps({"kernels": kernel_rows}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
