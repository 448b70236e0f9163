#!/usr/bin/env python3
"""Run the PyTorch/CUDA port's main path once on one NVIDIA GPU and check it.

    python3 chip_smoke.py

Phases (any failure raises and exits non-zero; nothing is caught):
  1. the card: nvidia-smi name and power limit; CUDA must be available;
  2. build the hand-written kernels (csrc/*.cu, one nvcc per source for
     sm_90a, all started together) and the shared C++ runtime for this host;
  3. simulate the 1 Mb x 25x read set (166,667 error-free 150 bp reads from
     both strands of a random genome, fixed seed);
  4. the main path, with the kernels' launch counts reset just before it:
     `index` (the device suffix sort, -a sais2 on cuda, the default; its
     peak device memory against the sort's estimate) -> `overlap -m 45`
     through siga_tpu_torch.cli, then the found edges scored with
     Smith-Waterman through BatchAligner (an exact overlap of length k must
     score 2k); every read must have its VT record;
  5. the overlap engine alone, warm (its wall and the process's user and
     system CPU time), and the device pair plane against the C++ host
     packing;
  6. each kernel against its plain PyTorch version on the card, bit for bit:
     the K1 scan on the first full 15,152-read chunk (odd lim_t), on a chunk
     of 149 bp reads (even lim_t) and on the rmdup lane groups; K5 at
     B=4096, query 150, ref 400, and 16 of those pairs against a naive DP;
  7. the hits of 256 sampled reads, from the command's hits file and from
     the engine, against the shared host engine (OverlapBuilder.overlap);
  8. `index -a host` (the C++ seed-sort) on the same reads: all four files
     byte-equal to the device build's; then the device index's layers
     timed alone for one direction (text build, sort, sort + BWT + perm);
  9. `rmdup` on the card, counts reset just before it: K1 must launch, the
     hits of 256 sampled reads equal the host engine's
     (OverlapBuilder.duplicate), and kept + duplicates = reads;
 10. the gather probes' CLI on the stacked pair plane, counts reset just
     before it (G1-G4 must launch), then each probe kernel against its plain
     version bit for bit at every Pallas probe's own shape and on the pair
     plane (60,608 random rows, one overlap chunk's lanes), and G1's
     device-side range assert in a child process;
 11. the pipeline: the `benchmark/ecoli_scale.py 1.0 25 0.005` read set
     (its genome and generator), its eleven stages (PIPE_STAGES) through
     `python -m siga_tpu_torch ... --device cuda`, each in a fresh process
     with a time limit, then `benchmark/contigs_mapping.py`: the corrected
     read count and the contig facts must equal BASELINE.md's; each stage's
     wall and kernel launches are printed;
 12. K1 against its plain version, bit for bit, at the pipeline's shapes
     with the `--no-opposite-strand` lane groups: the first chunk of
     `reads.ec.fa` at -m 85, and all contigs in one length-sorted chunk at
     -m 10;
 13. `correct` of every 8th preprocessed read against the whole read set's
     index (K7 must launch): its records must equal those reads' records in
     the pipeline's `reads.ec.fa`;
 14. K7 against its plain version on that index's forward plane, bit for
     bit, on 262,144 41-mers (drawn from the reads, one base substituted, an
     N), 300 of them also against `FMIndex.occurrences`;
 15. `overlap` as two `--process-id` workers at once on the card plus
     `--merge-only -t 2` (the port's launcher) against one `-t 2` process:
     the ASQG must be equal;
 16. the kernels' JSON line (each kernel's launches summed over the paths
     above, each path's counts read from its own run), then the device
     line last.
Imports nothing of JAX.
"""
import gzip
import json
import os
import random
import resource
import shutil
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

from siga_tpu.core import dna
from siga_tpu.index.fm import FMIndex
from siga_tpu.io import fastx
from siga_tpu.io.fastx import DNASeq
from siga_tpu.overlap.builder import Hit, OverlapBuilder
from siga_tpu_torch import cli, kernels
from siga_tpu_torch.device import native_lib
from siga_tpu_torch.index import sa as sa_mod
from siga_tpu_torch.ops import fm_device, kmer_count, search, sw
from siga_tpu_torch.parallel import multihost
from siga_tpu_torch.probes import gather

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


def edge_pairs(asqg_path, seqs, limit, rng):
    """(query, ref) pairs from sampled ED records: the overlap substring of
    the first read, and the second read in the first one's orientation."""
    edges = []
    n_vt = 0
    with gzip.open(asqg_path, "rt") as f:
        for line in f:
            if line.startswith("ED\t"):
                edges.append(line.split("\t")[1].split())
            elif line.startswith("VT\t"):
                n_vt += 1
    picks = rng.choice(len(edges), size=min(limit, len(edges)), replace=False)
    queries, refs = [], []
    for k in picks:
        id1, id2, s1, e1, _l1, _s2, _e2, _l2, comp = edges[k][:9]
        queries.append(seqs[int(id1[1:])][int(s1) : int(e1) + 1])
        r = seqs[int(id2[1:])]
        refs.append(dna.reverse_complement(r) if comp == "1" else r)
    return n_vt, len(edges), queries, refs


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
    t0 = time.time()
    assert cli.main(
        ["overlap", "--device", dev.type, "-m", str(MIN_OVERLAP), "-p", "reads", "reads.fa"]
    ) == 0
    overlap_s = time.time() - t0
    n_vt, n_ed, queries, refs = edge_pairs("reads.asqg.gz", seqs, 4096, rng)
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
    return launches, index_s


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
    suffix sort alone, and sort + BWT + permutation copied to the host."""
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
    sa_mod.bwt_perm_device(codes, dev)
    bwt_perm_s = time.time() - t0
    print(f"index layers, one direction of {codes.size} chars, warm: concat_reads {concat_s:.3f} s, "
          f"suffix_array_device {sort_s:.3f} s, bwt_perm_device (sort + BWT + perm to the host) "
          f"{bwt_perm_s:.3f} s")


def run_rmdup(builder, seqs, rng):
    """rmdup through the CLI on the card, then 256 sampled reads' hits against
    the host engine."""
    kernels.reset_launches()
    t0 = time.time()
    assert cli.main(["rmdup", "-p", "reads", "reads.fa"]) == 0
    rmdup_s = time.time() - t0
    launches = dict(kernels.launches)
    n_chunks = -(-len(seqs) // search.chunk_size(len(seqs)))
    assert launches["scan_pair"] >= n_chunks, (launches, n_chunks)
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
    return launches


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
    return launches


def check_probes(dev, plane):
    """Each probe kernel against its plain version: at every Pallas probe's
    own shape, and on the pair plane.  Returns {kernel: (err, ms, plain_ms,
    replaces)} with the wrappers' times on the pair plane."""
    rng = np.random.default_rng(SEED)
    errs, replaces = {}, {}

    def compare(name, args, reps):
        fn, plain = gather.WRAPPERS[name]
        err = max_abs_err([fn(*args)], [plain(*args)])
        ms = cuda_ms(lambda: fn(*args), reps)
        plain_ms = cuda_ms(lambda: plain(*args), 2)
        errs[name] = max(errs.get(name, 0), err)
        return err, ms, plain_ms

    for tpu_name, where, name, args in gather.probe_cases(rng):
        err, ms, plain_ms = compare(name, gather.to_device(args, dev), 10)
        print(f"{name} as {tpu_name} ({where}): max_abs_err {err}, "
              f"kernel {ms:.4f} ms, plain {plain_ms:.4f} ms")
        replaces.setdefault(name, []).append(where)
    out = {}
    for name, args in gather.plane_args(plane, PROBE_LANES, PROBE_STEPS, SEED).items():
        err, ms, plain_ms = compare(name, args, 3 if name == "gather_chain" else 10)
        print(f"{name} on the pair plane {tuple(plane.shape)}, {PROBE_LANES} lanes: "
              f"max_abs_err {err}, kernel {ms:.4f} ms, plain {plain_ms:.4f} ms")
        out[name] = (errs[name], ms, plain_ms, ", ".join(replaces[name]))
    assert all(v[0] == 0 for v in out.values()), out
    return out


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
    plane, K = fm_device.pair_plane_host(fmi)
    assert np.array_equal(scanner.plane[: scanner.nblocks].cpu().numpy(), plane)
    assert np.array_equal(scanner.K2[0].cpu().numpy(), K)
    records = [DNASeq(name=f"r{i}", seq=s) for i, s in enumerate(seqs)]
    ru0 = resource.getrusage(resource.RUSAGE_SELF)
    t0 = time.time()
    hits = list(search.batch_overlap_hits(builder, records, MIN_OVERLAP, dev))
    engine_s = time.time() - t0
    ru1 = resource.getrusage(resource.RUSAGE_SELF)
    print(f"plane_build_s {plane_s:.3f} (forward plane equals the C++ host packing)")
    print(f"engine_s {engine_s:.3f} engine_reads_per_s {len(seqs) / engine_s:.1f}; process cpu "
          f"user {ru1.ru_utime - ru0.ru_utime:.3f} s, system {ru1.ru_stime - ru0.ru_stime:.3f} s")
    return builder, hits


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
        got = fm_device.scan_pair(*args)
        err = max_abs_err(got, fm_device.scan_pair_plain(*args))
        err_all = max(err_all, err)
        print(f"K1 {name}: lim_t {lim_t}, blocks {int(got[0][0])}, "
              f"candidates {int(got[0][1])}, max_abs_err {err}")
        if name == "first chunk":
            ms = cuda_ms(lambda: fm_device.scan_pair(*args), 5)
            plain_ms = cuda_ms(lambda: fm_device.scan_pair_plain(*args), 2)
            print(f"K1 first chunk ({len(chunk_seqs)} reads, {4 * len(chunk_seqs)} lanes): "
                  f"kernel {ms:.3f} ms, plain {plain_ms:.3f} ms")
    assert err_all == 0
    return err_all, ms, plain_ms


def check_scan_pipeline(dev, workdir):
    """K1 against its plain version at the pipeline's own shapes, with the
    lane groups of `overlap --no-opposite-strand` (ID and REV): the first
    chunk of reads.ec.fa at -m 85, and the one length-sorted chunk of all of
    primary-contigs.rmdup.fa at -m 10 (lanes up to the longest contig).  The
    chunks are cut as `search.batch_overlap_hits` cuts them.  The plain
    version runs once a case, timed by CUDA events.  Returns the largest
    error."""
    err_all = 0
    for name, prefix, mo in (("reads.ec.fa first chunk", "reads.ec", READS_MIN_OVERLAP),
                             ("contigs", "primary-contigs.rmdup", CTG_MIN_OVERLAP)):
        path = os.path.join(workdir, prefix)
        sc = fm_device.DualScanner(
            fm_device.DeviceFM(FMIndex.load(path + ".bwt"), dev),
            fm_device.DeviceFM(FMIndex.load(path + ".rbwt"), dev),
            (fm_device.GROUP_ID,), (fm_device.GROUP_REV,),
        )
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
        got = fm_device.scan_pair(*args)
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        start.record()
        plain = fm_device.scan_pair_plain(*args)
        end.record()
        torch.cuda.synchronize()
        err = max_abs_err(got, plain)
        err_all = max(err_all, err)
        ms = cuda_ms(lambda: fm_device.scan_pair(*args), 3)
        print(f"K1 {name} (-m {mo}, groups ID/REV): {len(chunk)} of {len(seqs)} sequences, "
              f"{2 * len(chunk)} lanes of {maxlen} symbols, lim_t {lim_t}, "
              f"blocks {int(got[0][0])}, candidates {int(got[0][1])}, max_abs_err {err}; "
              f"kernel {ms:.3f} ms, plain {start.elapsed_time(end):.3f} ms", flush=True)
        del sc, args, got, plain
    assert err_all == 0
    return err_all


def check_sw_kernel(dev):
    rng = random.Random(SEED)
    qs, rs = [], []
    for _ in range(4096):
        q = "".join(rng.choice("ACGT") for _ in range(150))
        r = "".join(rng.choice("ACGT") for _ in range(400))
        if rng.random() < 0.5:  # a mutated copy of q inside r
            mq = list(q)
            for _ in range(rng.randint(0, 8)):
                mq[rng.randrange(150)] = rng.choice("ACGT")
            pos = rng.randint(0, 250)
            r = r[:pos] + "".join(mq) + r[pos + 150 :]
        qs.append(q)
        rs.append(r)
    qt = torch.from_numpy(np.stack([dna.encode(q) for q in qs]).astype(np.int32)).to(dev)
    rt = torch.from_numpy(np.stack([dna.encode(r) for r in rs]).astype(np.int32)).to(dev)
    got = sw.sw_wavefront(qt, rt, *SW_PARAMS)
    err = max_abs_err(got, sw.sw_wavefront_plain(qt, rt, *SW_PARAMS))
    assert got[0][:16].cpu().tolist() == [naive_sw(q, r) for q, r in zip(qs[:16], rs[:16])], \
        "K5 disagrees with the naive DP"
    ms = cuda_ms(lambda: sw.sw_wavefront(qt, rt, *SW_PARAMS), 10)
    plain_ms = cuda_ms(lambda: sw.sw_wavefront_plain(qt, rt, *SW_PARAMS), 2)
    print(f"K5 B=4096 q=150 r=400: max_abs_err {err}, kernel {ms:.3f} ms, "
          f"plain {plain_ms:.3f} ms; 16 pairs equal the naive DP")
    assert err == 0
    return err, ms, plain_ms



def port_cmd(argv, cwd, timeout=STAGE_TIMEOUT):
    """`python -m siga_tpu_torch ARGV` in a fresh process in `cwd`: returns its
    wall and the kernel launches it reports; raises when it fails or runs
    past `timeout` seconds (the child is killed then)."""
    t0 = time.time()
    proc = subprocess.run(
        [sys.executable, "-m", "siga_tpu_torch", *argv], cwd=cwd, env=CHILD_ENV,
        capture_output=True, text=True, timeout=timeout,
    )
    wall = time.time() - t0
    if proc.returncode != 0:
        raise RuntimeError(f"{' '.join(argv)} exited {proc.returncode}:\n{proc.stderr[-4000:]}")
    ran, own = {}, None
    for line in proc.stderr.splitlines():
        if "] kernel launches: " in line:
            ran = json.loads(line.split("] kernel launches: ", 1)[1])
        elif line.startswith(f"[{argv[0]}] wall: "):
            own = float(line.split()[2])
    if own is not None:  # the command's own wall, from its start to its end
        print(f"  {argv[0]}: process {wall:.3f} s, command {own:.3f} s", flush=True)
    return wall, ran


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
        walls[name], ran = port_cmd(argv, workdir)
        print(f"stage {name}: {walls[name]:.3f} s, launches {ran}   ({' '.join(argv)})", flush=True)
        if name.startswith(("overlap", "rmdup")):
            assert ran.get("scan_pair", 0) >= 1, (name, ran)
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
    wall, ran = port_cmd(
        ["correct", "--device", "cuda", "-k", "41", "-p", "reads.pp", "-o", "sub.ec.fa",
         "reads.sub.fastq"], workdir)
    print(f"correct of {len(sub)} reads against the {len(reads)}-read index (K7 on cuda): "
          f"{wall:.3f} s, launches {ran}")
    assert ran.get("kmer_count", 0) >= 1, ran
    names = {r.name for r in sub}
    assert len(names) == len(sub), "read names are not unique"
    want = [r.format() for r in fastx.read_sequences(os.path.join(workdir, "reads.ec.fa"))
            if r.name in names]
    got = [r.format() for r in fastx.read_sequences(os.path.join(workdir, "sub.ec.fa"))]
    assert got == want, f"sub.ec.fa ({len(got)} records) differs from reads.ec.fa's ({len(want)})"
    print(f"sub.ec.fa: {len(got)} records, equal to those reads' records in reads.ec.fa")
    return ran, reads


def check_k7(dev, reads, rng, workdir):
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
    got = kmer_count.count_kmers(dfm, codes)
    plain = kmer_count.count_kmers_plain(dfm, codes)
    err = max_abs_err([got], [plain])
    sample = rng.integers(0, K7_QUERIES, 300)
    host = [fmi.occurrences(kmers[q]) for q in sample]
    assert got[torch.from_numpy(sample).to(dev)].cpu().tolist() == host, "K7 differs from FMIndex"
    counts = got.cpu().numpy()
    ms = cuda_ms(lambda: kmer_count.count_kmers(dfm, codes), 10)
    plain_ms = cuda_ms(lambda: kmer_count.count_kmers_plain(dfm, codes), 2)
    print(f"K7 {K7_QUERIES} {k}-mers on the forward plane ({dfm.length} chars): max_abs_err {err}; "
          f"present {int((counts[:third] > 0).sum())}/{third}, substituted present "
          f"{int((counts[third:2 * third] > 0).sum())}, with N present "
          f"{int((counts[2 * third:] > 0).sum())}; 300 sampled equal FMIndex.occurrences; "
          f"kernel {ms:.4f} ms, plain {plain_ms:.4f} ms")
    assert err == 0 and (counts[:third] > 0).all()
    return err, ms, plain_ms


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
    single_s, ran = port_cmd(["overlap", "--device", "cuda", *args, "-t", "2", "reads.ec.fa"],
                             dirs["single"])
    assert ran.get("scan_pair", 0) >= 1, ran
    asqg = []
    for d in dirs.values():
        with gzip.open(os.path.join(d, "reads.ec.asqg.gz")) as f:
            asqg.append(f.read())
    assert asqg[0] == asqg[1], "the workers' merged ASQG differs from the single process's"
    print(f"overlap: 2 workers + merge {workers_s:.3f} s, one process -t 2 {single_s:.3f} s; "
          f"ASQG equal ({asqg[0].count(b'\nED\t')} ED records)")


def main() -> int:
    phase("card")
    print(card_line(), flush=True)
    if not torch.cuda.is_available():
        raise SystemExit("CUDA is not available")
    dev = torch.device("cuda")

    phase("build the kernels and the host runtime")
    t0 = time.time()
    report = kernels.build()
    kernels.lib()
    print(f"nvcc_build_s {time.time() - t0:.3f}")
    for line in report.splitlines():
        if "registers" in line or "spill" in line:
            print("  ptxas:", line.strip())
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
        launches, index_s = run_main_path(dev, seqs, rng)
        n_chunks = -(-len(seqs) // search.chunk_size(len(seqs)))
        assert launches["scan_pair"] >= n_chunks, (launches, n_chunks)
        assert launches["sw_wavefront"] >= 1, launches
        phase("engine, warm")
        builder, hits = run_engine(dev, seqs)
        phase("kernels against their plain versions")
        k1 = check_scan_kernel(dev, builder, seqs)
        k5 = check_sw_kernel(dev)
        phase("hits of sampled reads against the host engine")
        check_hits(builder, hits, seqs, rng)
        phase("index -a host against -a sais2")
        check_host_index(index_s)
        time_index_layers(dev, seqs)
        phase("rmdup on the card")
        run_rmdup(builder, seqs, rng)
        phase("gather probes: the probe CLI on the pair plane")
        launches.update(
            (k, v) for k, v in run_probe_path().items() if k not in ("scan_pair", "sw_wavefront")
        )
        phase("gather probes against their plain versions")
        probes = check_probes(dev, search._cached_scanner(builder, dev, *FWD_REV).plane)
        check_probe_range_assert()
        del builder, hits
        torch.cuda.empty_cache()
        pipe_dir = os.path.join(workdir, "pipeline")
        os.mkdir(pipe_dir)
        phase("pipeline: benchmark/ecoli_scale.py 1.0 25 0.005 through the port's CLI on the card")
        for name, n in run_pipeline(pipe_dir).items():
            launches[name] += n
        phase("K1 against its plain version at the pipeline's shapes")
        k1 = (max(k1[0], check_scan_pipeline(dev, pipe_dir)), *k1[1:])
        torch.cuda.empty_cache()
        phase("correct of every 8th read through K7, against the whole read set's index")
        ran, pp_reads = check_correct_subset(pipe_dir)
        for name, n in ran.items():
            launches[name] += n
        phase("K7 against its plain version")
        k7 = check_k7(dev, pp_reads, np.random.default_rng(SEED), pipe_dir)
        phase("overlap: two worker processes on the card + --merge-only, against one process")
        check_overlap_workers(pipe_dir)
    finally:
        os.chdir(home)
        shutil.rmtree(workdir)

    kernel_rows = []
    rows = [
        ("scan_pair", "siga_tpu_torch/csrc/scan_pair.cu", "siga_tpu/ops/fm_device.py:858", k1),
        ("sw_wavefront", "siga_tpu_torch/csrc/sw.cu", "siga_tpu/ops/sw_pallas.py:32", k5),
        ("kmer_count", "siga_tpu_torch/csrc/kmer_count.cu", "siga_tpu/ops/kmer_count.py:22", k7),
    ] + [
        (name, "siga_tpu_torch/csrc/gather_probe.cu", replaces, (err, ms, plain_ms))
        for name, (err, ms, plain_ms, replaces) in probes.items()
    ]
    for name, source, replaces, (err, ms, plain_ms) in rows:
        kernel_rows.append({
            "name": name, "route": "cuda", "source": source, "replaces": replaces,
            "launches": launches[name], "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
        })
    print(json.dumps({"kernels": kernel_rows}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
