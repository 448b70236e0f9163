"""Time K1 and K7, the gather probes G2, G3 and G4, the plane build K2, the
single-step scan K3, Smith-Waterman K5, the device suffix sort K6, the
distributed index build K8 or the stage-A scan K9 with the row gather G1, of two
checkouts of the repo against each other on one card, at the error
pipeline's own shapes.

    python3 chip_smoke.py --keep-pipeline DIR
    python3 -m siga_tpu_torch.probes.kernel_ab --trees OTHER,. --pipeline DIR \
        [--probes | --plane | --scan | --sw | --sa | --dist | --stage-a] [--order 0,1,1,0] \
        [--out FILE]

DIR holds the `benchmark/ecoli_scale.py 1.0 25 0.005` pipeline as
`chip_smoke.py --keep-pipeline` leaves it.  This process takes the cases'
inputs from it, with this checkout's readers and chunking, and writes them
into DIR/kernel_ab/ as plain text, one sequence a line:
  - K1 (`fm_device.scan_pair`) on the first chunk of reads.ec.fa with the
    ID/REV groups at -m 85 (the pipeline's `overlap` stage);
  - K1 on all of primary-contigs.rmdup.fa in its length-sorted chunk, ID/REV
    at -m 10 (the `overlap_ctg` stage);
  - K7 (`kmer_count.count_kmers`) on reads.pp's index at 262,144, 110 and 3
    41-mers drawn from reads.pp.fastq, half of them with one base
    substituted, and the wall of one `KmerCounter` call of 110 and of 3
    k-mers (the `correct` route's sizes).
With --probes the cases are instead G2 (`gather.take_along`), G4
(`gather.scale2`) and G3's mode sum (`gather.gather_chain`) at every Pallas
probe shape of `gather.probe_cases` and on the stacked pair plane of
DIR/reads.ec (the `overlap` stage's index, with `gather.plane_args`' 60,608
random rows, G3 over 150 steps), each timed beside its library call
(`torch.gather`, `x * 2`; G3 has none) in the same worker, and G3's mode
elem over 32 chains of 2,000 steps on one direction's plane and on a 4 KB
table (`chip_smoke.py`'s L2 and L1 round trips; both read in place).
With --plane the cases are K2 (`fm_device.build_pair_plane`) on both
directions of DIR/reads.ec's index (the `overlap` stage's), its BWT codes
already on the card: the wall of a build by CUDA events (PLANE_REPS builds
in turn, the card held busy while they are enqueued) and, from a
torch.profiler trace of one build, its device time and device operations.
With --sw the cases are K5 (`sw.sw_wavefront`) on the 4,096 synthetic pairs
of `sw_synthetic_pairs` (chip_smoke.py's K5 check: 150 x 400, half of them
with a mutated copy of the query in the ref) and on 4,096 edges drawn from
DIR/reads.ec.asqg.gz (the `overlap` stage's; the overlap substring of the
first read against the second read, as chip_smoke.py scores the main
path's edges): per case the wall by CUDA events and, from a torch.profiler
trace, the kernel's median device span, SW_REPS calls each.
With --scan the cases are K3 (`fm_device.scan_single`) and the index-sharded
K3 (`fm_device.scan_single_sharded`, D in SCAN_SHARDS allocations on
cuda:0) on K1's two inputs (the reads.ec.fa chunk at -m 85, the contigs at
-m 10, ID/REV) through the single-step plane: per case the wrapper's wall by
CUDA events and, from a torch.profiler trace, the median device span of
the scan kernel alone (the compaction's operations left out), SCAN_REPS
calls each.
With --sa the cases are K6, the device suffix sort (`index/sa.py`), on the
rank texts of DIR/reads.ec.fa (the `index_ec` stage's forward direction)
and DIR/primary-contigs.fa (the `index_ctg` stage's): per case the warm
walls of `suffix_array_device` and `bwt_perm_device` (SA_REPS of each in
turn, host clock from a synchronised card to a synchronised card), from a
torch.profiler trace of one `suffix_array_device` its device time and
device operations, torch.sort's device time and, for each of its calls,
the onesweep digit-pass kernels it ran, and the peak device memory of one
`bwt_perm_device` a character; the digests cover the SA, the BWT and the
permutation.
With --dist the cases are K8, the distributed index build
(`parallel/dist_build.py`), on the same two texts split into D = 2 and 4
segments on [cuda:0] * D: per case the warm wall of `distributed_bwt_perm`
(SA_REPS builds, host clock from a synchronised card to a synchronised
card), from a torch.profiler trace of one build its device time, device
operations and costliest operations, torch.sort's device time and the
onesweep digit passes of each of its calls, and its peak device memory a
character; the digests cover the SA, the BWT and the permutation.
With --stage-a the cases are K9 (`fm_device.scan_stage_a`) on the first
60,608 reads of DIR/reads.ec.fa as ID lanes (one overlap chunk's lanes; the
`overlap` stage's -m 85) over the forward single-step plane of DIR/reads.ec,
and at `dryrun.entry`'s tiny problem (8 lanes x 23 steps); and G1
(`gather.gather_rows`) at each of its Pallas probes' shapes and on the
stacked pair plane of DIR/reads.ec (60,608 random rows): per case the wall
by CUDA events and, from a torch.profiler trace, the kernel's median device
span, STAGE_A_REPS calls each; for G1 also its library call
(`index_select`).
Each entry of --order runs a fresh worker process on the checkout it names
(this file is run as a script with that checkout first on sys.path, so an
older checkout needs no copy of it).  The worker builds that checkout's
kernels, loads the pipeline's indexes with that checkout's FM-index class
and times through that checkout's wrappers by CUDA events
(`probes.gather.cuda_ms`).  The parent requires every worker's outputs to be
equal (a digest per case, so the checkouts' kernels agree bit for bit) and
prints one JSON line of all the times.  Needs a card.
"""
from __future__ import annotations

import argparse
import functools
import gzip
import hashlib
import json
import os
import random
import subprocess
import sys
import time

import numpy as np

KMER_SEED = 3
PROBE_SEED = 1
PROBE_LANES = 60608  # one overlap chunk's lanes
PROBE_KERNELS = ("take_along", "scale2", "gather_chain")
PROBE_STEPS = 150  # G3's chain on the pair plane, as chip_smoke.py runs it
ROUND_TRIP_STEPS = 2000  # G3 mode elem's round-trip chains, as chip_smoke.py runs them
PLANE_REPS = 20  # K2 builds a timing
SCAN_REPS = 10  # K3 calls a wall and a trace
SCAN_TRACES = 3  # traces of a case at most, while one loses kernel spans
SCAN_SHARDS = (2, 4)  # the sharded K3's shard counts, D allocations on the card each
SW_SEED, SW_PAIRS, SW_REPS = 1, 4096, 20  # K5's cases: pairs drawn, calls a wall and a trace
SW_PARAMS = (2, 2, 3, 1)
K, KMERS, ROUTE_SIZES = 41, 262_144, (110, 3)
SA_REPS = 5  # warm walls of each K6 entry a case
STAGE_A_LANES, STAGE_A_MIN_OVERLAP = 60_608, 85  # K9 at one chunk's lanes, the overlap stage's -m
STAGE_A_REPS = 20  # K9 and G1 calls a wall and a trace
SA_CASES = {"K6 reads.ec.fa": "reads.ec.fa", "K6 primary-contigs.fa": "primary-contigs.fa"}
DIST_SEGMENTS = (2, 4)  # K8's entries, [cuda:0] * D
# K1 case: (pipeline prefix, -m), each with the ID/REV groups
K1_CASES = {"K1 reads.ec.fa chunk": ("reads.ec", 85), "K1 contigs": ("primary-contigs.rmdup", 10)}


def _lines(path):
    with open(path) as f:
        return f.read().split()


def make_inputs(pipeline: str) -> str:
    """The cases' sequences from the pipeline in `pipeline`, into its
    kernel_ab/ directory (once); returns that directory."""
    from ..io import fastx
    from ..ops import search

    out = os.path.join(pipeline, "kernel_ab")
    if os.path.exists(os.path.join(out, "kmers.txt")):
        return out
    os.makedirs(out, exist_ok=True)
    for name, (prefix, _mo) in K1_CASES.items():
        seqs = [r.seq for r in fastx.read_sequences(os.path.join(pipeline, prefix + ".fa"))]
        lens = sorted(map(len, seqs))
        if lens[-1] > 2 * max(lens[len(lens) // 2], 1):  # as search.batch_overlap_hits
            seqs.sort(key=len)
        with open(os.path.join(out, prefix + ".txt"), "w") as f:
            f.write("\n".join(seqs[: search.chunk_size(len(seqs))]) + "\n")
    reads = [r.seq for r in fastx.read_sequences(os.path.join(pipeline, "reads.pp.fastq"))
             if len(r.seq) >= K]
    rng = np.random.default_rng(KMER_SEED)
    kmers = []
    for i in rng.integers(0, len(reads), KMERS):
        j = int(rng.integers(0, len(reads[i]) - K + 1))
        w = reads[i][j : j + K]
        if len(kmers) % 2:  # one base substituted
            p = int(rng.integers(0, K))
            w = w[:p] + "ACGT"[("ACGT".index(w[p]) + int(rng.integers(1, 4))) % 4] + w[p + 1 :]
        kmers.append(w)
    with open(os.path.join(out, "kmers.txt"), "w") as f:
        f.write("\n".join(kmers) + "\n")
    return out


def sw_synthetic_pairs(seed: int = SW_SEED, n: int = SW_PAIRS):
    """K5's synthetic (query, ref) strings: n random 150-symbol queries and
    400-symbol refs, half of the refs holding a copy of the query with up to
    8 substitutions."""
    rng = random.Random(seed)
    qs, rs = [], []
    for _ in range(n):
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
    return qs, rs


def sw_edge_pairs(asqg_path, seq_of, limit, rng):
    """(number of VT records, number of ED records, queries, refs) of up to
    `limit` ED records of the ASQG drawn by `rng` (a numpy Generator): the
    overlap substring of the first read, and the second read in the first
    one's orientation; `seq_of` maps a read's name to its sequence."""
    from ..core import dna

    edges, n_vt = [], 0
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
        queries.append(seq_of[id1][int(s1) : int(e1) + 1])
        r = seq_of[id2]
        refs.append(dna.reverse_complement(r) if comp == "1" else r)
    return n_vt, len(edges), queries, refs


def make_sw_inputs(pipeline: str) -> str:
    """K5's edge pairs of the pipeline's `overlap` stage into its kernel_ab/
    directory (once), a tab-separated (query, ref) a line; returns the file."""
    from ..io import fastx

    out = os.path.join(pipeline, "kernel_ab", "sw_edges.txt")
    if not os.path.exists(out):
        os.makedirs(os.path.dirname(out), exist_ok=True)
        seq_of = {r.name: r.seq for r in fastx.read_sequences(os.path.join(pipeline, "reads.ec.fa"))}
        _vt, _ed, qs, rs = sw_edge_pairs(os.path.join(pipeline, "reads.ec.asqg.gz"), seq_of,
                                         SW_PAIRS, np.random.default_rng(SW_SEED))
        with open(out, "w") as f:
            f.write("".join(f"{q}\t{r}\n" for q, r in zip(qs, rs)))
    return out


def sw_tensors(queries, refs, dev):
    """Queries and refs as int32 rank codes, zero-padded to the longest, on
    `dev` (as `sw.BatchAligner` lays them out)."""
    import torch

    from siga_tpu_torch.core import dna

    out = []
    for seqs in (queries, refs):
        m = np.zeros((len(seqs), max(map(len, seqs))), dtype=np.int32)
        for i, x in enumerate(seqs):
            m[i, : len(x)] = dna.encode(x)
        out.append(torch.from_numpy(m).to(dev))
    return out


def _digest(outputs) -> str:
    h = hashlib.sha256()
    for x in outputs:
        h.update(x.detach().cpu().contiguous().numpy().tobytes())
    return h.hexdigest()[:16]


def library_call(name, args):
    """One PyTorch call that computes the same as the gather probe `name` on
    `args`, or None; a yardstick only (no path of the port calls it)."""
    import torch

    if name == "scale2":
        return lambda: args[0] * 2
    if name == "gather_rows":
        return lambda: torch.index_select(args[0], 0, args[1])
    if name == "take_along":
        table, index, axis = args
        shape = list(index.shape)
        shape[1 - axis] = table.shape[1 - axis]
        index64 = index.to(torch.int64).expand(shape)
        return lambda: torch.gather(table, axis, index64)
    return None


def _start(tree: str):
    """Build the checkout's kernels; the worker's result record."""
    from siga_tpu_torch import kernels

    pkg = os.path.dirname(os.path.abspath(kernels.__file__))
    assert os.path.samefile(os.path.dirname(pkg), tree), (pkg, tree)
    t0 = time.time()
    report = kernels.build()
    kernels.lib()
    return {"tree": tree, "build_s": time.time() - t0, "times": {}, "digests": {},
            "ptxas": [l.strip() for l in report.splitlines() if "registers" in l or "spill" in l]}


def probe_worker(tree: str, pipeline: str) -> dict:
    """Times of G2, G3 and G4 through the wrappers of the checkout at
    `tree`, and of their library calls."""
    import torch

    from siga_tpu_torch.probes import gather

    dev = torch.device("cuda")
    out = _start(tree)
    rng = np.random.default_rng(PROBE_SEED)
    cases = [(f"{name} as {tpu}", name, gather.to_device(args, dev))
             for tpu, _where, name, args in gather.probe_cases(rng) if name in PROBE_KERNELS]
    plane = gather.stacked_plane(os.path.join(pipeline, "reads.ec"), dev)
    plane_args = gather.plane_args(plane, PROBE_LANES, PROBE_STEPS, PROBE_SEED)
    cases += [(f"{name} on the pair plane", name, plane_args[name]) for name in PROBE_KERNELS]
    # chip_smoke.py's round-trip yardsticks: 32 chains of G3 mode elem over
    # one direction's plane (L2) and over a 4 KB table (L1), read in place
    fwd = plane[: plane.shape[0] // 2].reshape(1, -1)
    init = torch.randint(0, fwd.shape[1], (1, 32), dtype=torch.int32, device=dev,
                         generator=torch.Generator(device=dev).manual_seed(PROBE_SEED))
    cases += [(f"gather_chain elem, 32 chains x {ROUND_TRIP_STEPS} {where}", "gather_chain",
               (table, start, None, ROUND_TRIP_STEPS, "elem"))
              for where, table, start in (("over the forward plane", fwd, init),
                                          ("over a 4 KB table", fwd[:, :1024].contiguous(),
                                           init % 1024))]
    for label, name, args in cases:
        fn = gather.WRAPPERS[name][0]
        out["digests"][label] = _digest([fn(*args)])
        out["times"][label] = gather.cuda_ms(lambda: fn(*args), 20)
        library = library_call(name, args)
        if library is not None:
            out["times"][label + ", library call"] = gather.cuda_ms(library, 20)
    return out


def trace_device(fn):
    """fn() under torch.profiler: (device ms, device operations, {name: (ms,
    count)}, the profile).  The device time is the sum of the device spans
    of the kernels and copies fn ran.  (Here, and not in the package, so
    that a worker on an older checkout has it too; chip_smoke.py uses it.)"""
    import torch

    activities = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=activities) as prof:
        fn()
        torch.cuda.synchronize()
    on_card = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
    by_name = {}
    for e in on_card:
        ms, count = by_name.get(e.name, (0.0, 0))
        by_name[e.name] = (ms + e.time_range.elapsed_us() / 1e3, count + 1)
    return sum(ms for ms, _ in by_name.values()), len(on_card), by_name, prof


def ancestors(event):
    parent = event.cpu_parent
    while parent is not None:
        yield parent
        parent = parent.cpu_parent


def device_us(event) -> float:
    """Device microseconds of a CPU-side op in a trace, its children's
    kernels included."""
    total = getattr(event, "device_time_total", None)
    return event.cuda_time_total if total is None else total


def _kernels_below(event) -> list:
    """Names of the device kernels a CPU-side op launched, its children's
    included."""
    names = [k.name for k in event.kernels]
    for child in event.cpu_children:
        names += _kernels_below(child)
    return names


def sort_readings(prof) -> tuple:
    """(device ms of the torch.sort calls in the trace `prof`, for each call
    [onesweep digit-pass kernels, all its kernels])."""
    calls = [e for e in prof.events() if e.name == "aten::sort"
             and not any(a.name == "aten::sort" for a in ancestors(e))]
    passes = []
    for e in calls:
        names = _kernels_below(e)
        passes.append([sum("Onesweep" in k for k in names), len(names)])
    return sum(device_us(e) for e in calls) / 1e3, passes


def host_walls(fns, rounds):
    """Seconds of each fn() in `rounds` rounds, the fns in turn within each,
    each from a synchronised card to a synchronised card."""
    import torch

    times = [[] for _ in fns]
    for _ in range(rounds):
        for t, fn in zip(times, fns):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            t.append(time.perf_counter() - t0)
    return times


def sa_readings(codes, dev, reps: int = SA_REPS) -> tuple:
    """K6 on the rank text `codes` through `index/sa.py`'s two entry points
    (those of any checkout of the port): (times, counts, digest).  times:
    the warm walls (ms: median, min, max of `reps`, the two in turn), the
    device time and torch.sort's of one `suffix_array_device` by
    torch.profiler; counts: its device operations, torch.sort's calls and
    onesweep digit passes of each, the peak device bytes of one
    `bwt_perm_device` a character."""
    import torch

    from siga_tpu_torch.index import sa

    def sort():
        return sa.suffix_array_device(codes, dev)

    def bwt_perm():
        return sa.bwt_perm_device(codes, dev)

    order = sort()
    bwt, perm = bwt_perm()
    digest = _digest([order, torch.from_numpy(bwt), torch.from_numpy(perm)])
    del order, bwt, perm
    walls = host_walls([sort, bwt_perm], reps)
    times = {}
    for name, wall in zip(("suffix_array_device", "bwt_perm_device"), walls):
        ms = sorted(w * 1e3 for w in wall)
        times[f"{name} wall median"] = float(np.median(ms))
        times[f"{name} wall min"], times[f"{name} wall max"] = ms[0], ms[-1]
    dev_ms, n_ops, _by_name, prof = trace_device(sort)
    sort_ms, passes = sort_readings(prof)
    times["suffix_array_device device time"] = dev_ms
    times["torch.sort device time"] = sort_ms
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    before = torch.cuda.memory_allocated()
    bwt_perm()
    counts = {"device operations": n_ops, "sort passes": passes,
              "peak bytes a char": (torch.cuda.max_memory_allocated() - before) / codes.size}
    return times, counts, digest


def sa_worker(tree: str, pipeline: str) -> dict:
    """K6 of the checkout at `tree` on SA_CASES' texts."""
    import torch

    from siga_tpu_torch.index import sa
    from siga_tpu_torch.io import fastx

    out = _start(tree)
    out["counts"] = {}
    for label, name in SA_CASES.items():
        seqs = [r.seq for r in fastx.read_sequences(os.path.join(pipeline, name))]
        codes = sa.concat_reads(seqs)[0]
        label = f"{label} ({codes.size} chars)"
        times, counts, digest = sa_readings(codes, torch.device("cuda", 0))
        out["digests"][label] = digest
        out["times"].update({f"{label}, {k}": v for k, v in times.items()})
        out["counts"][label] = counts
    return out


def dist_readings(codes, dev, d: int, reps: int = SA_REPS) -> tuple:
    """K8 on the rank text `codes` over [dev] * d through
    `parallel/dist_build.py`'s entry points (those of any checkout of the
    port): (times, counts, digest).  times: the warm wall of
    `distributed_bwt_perm` (ms: median, min, max of `reps`), its device time
    and torch.sort's by torch.profiler; counts: its device operations,
    torch.sort's calls and onesweep digit passes of each, its peak device
    bytes a character, its costliest device operations ([name, ms, count])."""
    import torch

    from siga_tpu_torch.parallel import dist_build

    devs = [dev] * d

    def bwt_perm():
        return dist_build.distributed_bwt_perm(codes, devs)

    bwt, perm = bwt_perm()
    digest = _digest([torch.from_numpy(dist_build.distributed_sa(codes, devs)),
                      torch.from_numpy(bwt), torch.from_numpy(perm)])
    del bwt, perm
    ms = sorted(w * 1e3 for w in host_walls([bwt_perm], reps)[0])
    times = {"wall median": float(np.median(ms)), "wall min": ms[0], "wall max": ms[-1]}
    dev_ms, n_ops, by_name, prof = trace_device(bwt_perm)
    sort_ms, passes = sort_readings(prof)
    times["device time"], times["torch.sort device time"] = dev_ms, sort_ms
    costliest = sorted(by_name.items(), key=lambda item: -item[1][0])[:6]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    before = torch.cuda.memory_allocated()
    bwt_perm()
    counts = {"device operations": n_ops, "sort passes": passes,
              "peak bytes a char": (torch.cuda.max_memory_allocated() - before) / codes.size,
              "costliest": [[name[:90], ms, k] for name, (ms, k) in costliest]}
    return times, counts, digest


def dist_worker(tree: str, pipeline: str) -> dict:
    """K8 of the checkout at `tree` on SA_CASES' texts at each of
    DIST_SEGMENTS."""
    import torch

    from siga_tpu_torch.index import sa
    from siga_tpu_torch.io import fastx

    out = _start(tree)
    out["counts"] = {}
    for label, name in SA_CASES.items():
        seqs = [r.seq for r in fastx.read_sequences(os.path.join(pipeline, name))]
        codes = sa.concat_reads(seqs)[0]
        for d in DIST_SEGMENTS:
            case = f"K8 {name} ({codes.size} chars), D = {d}"
            times, counts, digest = dist_readings(codes, torch.device("cuda", 0), d)
            out["digests"][case] = digest
            out["times"].update({f"{case}, {k}": v for k, v in times.items()})
            out["counts"][case] = counts
    return out


def plane_worker(tree: str, pipeline: str) -> dict:
    """Times of K2 through the wrapper of the checkout at `tree`, on both
    directions of the pipeline's reads.ec index."""
    import torch

    from siga_tpu_torch.ops import fm_device
    from siga_tpu_torch.probes.gather import cuda_ms

    dev = torch.device("cuda")
    out = _start(tree)
    out["device_ops"] = {}
    for ext in ("bwt", "rbwt"):
        fmi = fm_device.FMIndex.load(os.path.join(pipeline, f"reads.ec.{ext}"))
        codes = torch.from_numpy(np.ascontiguousarray(fmi.codes)).to(dev)
        args = (codes, np.asarray(fmi.pred, dtype=np.int64), fmi.length // fm_device.SAMPLE + 1)
        name = f"K2 reads.ec.{ext} ({fmi.length} codes)"
        out["digests"][name] = _digest(fm_device.build_pair_plane(*args))
        out["times"][name] = cuda_ms(lambda: fm_device.build_pair_plane(*args), PLANE_REPS)
        dev_ms, n_ops, _by_name, _prof = trace_device(lambda: fm_device.build_pair_plane(*args))
        out["times"][name + ", device time"] = dev_ms
        out["device_ops"][name] = n_ops
    return out


def single_scan_args(fms, groups, reads, n, mo, dev, devices=None):
    """The arguments of a single-step scan of `reads` (n of them, packed to
    the 16-symbol bucket) over the DeviceFM pair `fms` with the lane groups
    `groups` (forward, reverse) at -m `mo`: the stacked single-step plane on
    `dev`, or with `devices` its row shards, and the arguments of
    `scan_single` (`scan_single_sharded` with `devices`) after it."""
    import torch

    from siga_tpu_torch.ops import fm_device, search

    sc = fm_device.DualScanner(*fms, *groups, pair_step=False, devices=devices)
    maxlen = search._bucket_len(max(map(len, reads)))
    la_w, lens = fm_device.pack_reads_2bit(reads, n, maxlen)
    lim_t = min(maxlen - 1, int(lens.max()) - 1)
    tail = (sc.pred, sc.length, sc.nblocks, torch.from_numpy(la_w).to(dev),
            torch.from_numpy(lens).to(dev), lim_t, mo, *groups)
    return (sc.plane if devices is None else sc.shards), tail


def scan_calls(pipeline: str, dev) -> dict:
    """{label: (kernel name, call)}: at each of K1_CASES' inputs (read from
    DIR/kernel_ab/, as `make_inputs` wrote them) through the single-step
    plane of the case's index with the ID/REV groups, K3 and the sharded K3
    at each D of SCAN_SHARDS (D allocations on `dev`), each a call of its
    wrapper.  On CPU tensors the calls run the plain versions."""
    from siga_tpu_torch.ops import fm_device

    groups = ((fm_device.GROUP_ID,), (fm_device.GROUP_REV,))
    calls = {}
    for name, (prefix, mo) in K1_CASES.items():
        case = name.split(" ", 1)[1]
        chunk = _lines(os.path.join(pipeline, "kernel_ab", prefix + ".txt"))
        path = os.path.join(pipeline, prefix)
        fms = [fm_device.DeviceFM(fm_device.FMIndex.load(path + ext), dev)
               for ext in (".bwt", ".rbwt")]
        plane, tail = single_scan_args(fms, groups, chunk, len(chunk), mo, dev)
        calls[f"K3 {case}"] = ("scan_single", functools.partial(
            fm_device.scan_single, plane, *tail))
        for d in SCAN_SHARDS:
            shards, tail = single_scan_args(fms, groups, chunk, len(chunk), mo, dev,
                                            devices=[dev] * d)
            calls[f"sharded K3 D={d} {case}"] = ("scan_single_sharded", functools.partial(
                fm_device.scan_single_sharded, shards, *tail))
    return calls


def kernel_spans(prof, name: str) -> list:
    """The device spans (ms) of the kernel `name`_kernel in the torch.profiler
    trace `prof`."""
    import torch

    return [e.time_range.elapsed_us() / 1e3 for e in prof.events()
            if e.device_type == torch.autograd.DeviceType.CUDA and f"{name}_kernel" in e.name]


def median_span(label, name, fn, reps) -> float:
    """The median device span of the kernel `name`_kernel over `reps` calls
    of fn, from a torch.profiler trace.  A trace can lose a kernel's span
    (the profiler drops events): it is taken again, SCAN_TRACES times at
    most."""
    for _attempt in range(SCAN_TRACES):
        spans = kernel_spans(trace_device(lambda: [fn() for _ in range(reps)])[3], name)
        if len(spans) == reps:
            return float(np.median(spans))
    raise RuntimeError(f"{label}: each of {SCAN_TRACES} traces lost kernel spans, the "
                       f"last holds {len(spans)} for {reps} calls")


def scan_worker(tree: str, pipeline: str) -> dict:
    """Times of K3 and the sharded K3 through the wrappers of the checkout
    at `tree`: each case's wall and its kernel's median device span."""
    import torch

    from siga_tpu_torch.probes.gather import cuda_ms

    out = _start(tree)
    for label, (name, fn) in scan_calls(pipeline, torch.device("cuda", 0)).items():
        out["digests"][label] = _digest(fn())
        out["times"][label + ", wall"] = cuda_ms(fn, SCAN_REPS)
        out["times"][label + ", kernel device time"] = median_span(label, name, fn, SCAN_REPS)
    return out


def make_stage_a_inputs(pipeline: str) -> str:
    """K9's lanes, the first STAGE_A_LANES reads of DIR/reads.ec.fa, into
    DIR/kernel_ab/stage_a_reads.txt (once); returns the directory."""
    from ..io import fastx

    out = os.path.join(pipeline, "kernel_ab")
    path = os.path.join(out, "stage_a_reads.txt")
    if not os.path.exists(path):
        os.makedirs(out, exist_ok=True)
        seqs = []
        for r in fastx.read_sequences(os.path.join(pipeline, "reads.ec.fa")):
            seqs.append(r.seq)
            if len(seqs) == STAGE_A_LANES:
                break
        with open(path, "w") as f:
            f.write("\n".join(seqs) + "\n")
    return out


def stage_a_calls(pipeline: str, dev) -> dict:
    """{label: (kernel name, call)}: K9 (`fm_device.scan_stage_a`) on the lanes
    of DIR/kernel_ab/stage_a_reads.txt over the forward single-step plane of
    DIR/reads.ec at -m STAGE_A_MIN_OVERLAP, and at `dryrun.entry`'s tiny
    problem; G1 (`gather.gather_rows`) at each of its Pallas probes' shapes
    and on the stacked pair plane of DIR/reads.ec (`gather.plane_args`' rows).
    On CPU tensors the calls run the plain versions."""
    import torch

    from siga_tpu_torch import dryrun
    from siga_tpu_torch.ops import fm_device
    from siga_tpu_torch.probes import gather

    seqs = _lines(os.path.join(pipeline, "kernel_ab", "stage_a_reads.txt"))
    fm = fm_device.DeviceFM(fm_device.FMIndex.load(os.path.join(pipeline, "reads.ec.bwt")), dev)
    chars, lens = dryrun.stage_a_chars(seqs)
    args = (chars.shape[1] - 1, STAGE_A_MIN_OVERLAP, fm.occ_plane, fm.pred_dev, fm.length,
            torch.from_numpy(chars).to(dev), torch.from_numpy(lens).to(dev), None)
    calls = {f"K9 reads.ec.fa {len(seqs)} lanes x {args[0]} steps": (
        "scan_stage_a", functools.partial(fm_device.scan_stage_a, *args))}
    fn, example = dryrun.entry(dev)
    calls[f"K9 dryrun.entry {example[2].shape[0]} lanes x {example[2].shape[1] - 1} steps"] = (
        "scan_stage_a", functools.partial(fn, *example))
    rng = np.random.default_rng(PROBE_SEED)
    for tpu, _where, name, case in gather.probe_cases(rng):
        if name == "gather_rows":
            calls[f"G1 as {tpu}"] = ("gather_rows", functools.partial(
                gather.gather_rows, *gather.to_device(case, dev)))
    plane = gather.stacked_plane(os.path.join(pipeline, "reads.ec"), dev)
    rows = gather.plane_args(plane, PROBE_LANES, PROBE_STEPS, PROBE_SEED)["gather_rows"]
    calls["G1 on the pair plane"] = ("gather_rows", functools.partial(gather.gather_rows, *rows))
    return calls


def stage_a_worker(tree: str, pipeline: str) -> dict:
    """Times of K9 and G1 through the wrappers of the checkout at `tree`:
    each case's wall and its kernel's median device span, and G1's library
    call (`index_select`) beside it."""
    import torch

    from siga_tpu_torch.probes.gather import cuda_ms

    out = _start(tree)
    for label, (name, fn) in stage_a_calls(pipeline, torch.device("cuda", 0)).items():
        got = fn()
        out["digests"][label] = _digest(got if isinstance(got, tuple) else [got])
        out["times"][label + ", wall"] = cuda_ms(fn, STAGE_A_REPS)
        out["times"][label + ", kernel device time"] = median_span(label, name, fn, STAGE_A_REPS)
        if name == "gather_rows":
            out["times"][label + ", library call"] = cuda_ms(
                library_call(name, fn.args), STAGE_A_REPS)
    return out


def sw_cases(pipeline: str, dev) -> dict:
    """{label: (queries, refs)} of K5's cases as tensors on `dev`: the
    synthetic pairs and the pipeline's edges (DIR/kernel_ab/sw_edges.txt,
    as `make_sw_inputs` wrote it)."""
    with open(os.path.join(pipeline, "kernel_ab", "sw_edges.txt")) as f:
        edges = [line.rstrip("\n").split("\t") for line in f]
    return {
        f"K5 synthetic {SW_PAIRS} x 150 x 400": sw_tensors(*sw_synthetic_pairs(), dev),
        f"K5 {len(edges)} reads.ec edges": sw_tensors(*zip(*edges), dev),
    }


def sw_worker(tree: str, pipeline: str) -> dict:
    """Times of K5 through the wrapper of the checkout at `tree`: each
    case's wall and its kernel's median device span."""
    import torch

    from siga_tpu_torch.ops import sw
    from siga_tpu_torch.probes.gather import cuda_ms

    out = _start(tree)
    for label, (queries, refs) in sw_cases(pipeline, torch.device("cuda", 0)).items():
        label = f"{label} ({tuple(queries.shape)}, {tuple(refs.shape)})"
        fn = functools.partial(sw.sw_wavefront, queries, refs, *SW_PARAMS)
        out["digests"][label] = _digest(fn())
        out["times"][label + ", wall"] = cuda_ms(fn, SW_REPS)
        out["times"][label + ", kernel device time"] = median_span(label, "sw", fn, SW_REPS)
    return out


def worker(tree: str, pipeline: str) -> dict:
    """Times of K1 and K7 through the wrappers of the checkout at `tree`."""
    import torch

    from siga_tpu_torch.ops import fm_device, kmer_count, search
    from siga_tpu_torch.probes.gather import cuda_ms

    dev = torch.device("cuda")
    out = _start(tree)
    inputs = os.path.join(pipeline, "kernel_ab")
    FMIndex = fm_device.FMIndex  # the checkout's own FM-index class

    def timed(name, fn, reps):
        out["digests"][name] = _digest(fn())
        out["times"][name] = cuda_ms(fn, reps)

    groups = ((fm_device.GROUP_ID,), (fm_device.GROUP_REV,))
    for name, (prefix, mo) in K1_CASES.items():
        chunk = _lines(os.path.join(inputs, prefix + ".txt"))
        path = os.path.join(pipeline, prefix)
        sc = fm_device.DualScanner(fm_device.DeviceFM(FMIndex.load(path + ".bwt"), dev),
                                   fm_device.DeviceFM(FMIndex.load(path + ".rbwt"), dev), *groups)
        maxlen = search._bucket_len(max(map(len, chunk)))
        la_w, lens = fm_device.pack_reads_2bit(chunk, len(chunk), maxlen)
        args = (sc.plane, sc.K2, sc.pred, sc.length, sc.nblocks, torch.from_numpy(la_w).to(dev),
                torch.from_numpy(lens).to(dev), min(maxlen - 1, int(lens.max()) - 1), mo,
                sc.fwd_groups, sc.rev_groups)
        timed(name, lambda: fm_device.scan_pair(*args), 10 if prefix == "reads.ec" else 3)
        del sc, args
        torch.cuda.empty_cache()

    dfm = fm_device.DeviceFM(FMIndex.load(os.path.join(pipeline, "reads.pp.bwt")), dev)
    kmers = _lines(os.path.join(inputs, "kmers.txt"))
    codes = torch.from_numpy(kmer_count.encode_kmers(kmers)).to(dev)
    for size in (KMERS, *ROUTE_SIZES):
        sub = codes[:size]
        timed(f"K7 {size}", lambda: [kmer_count.count_kmers(dfm, sub)], 10 if size == KMERS else 50)
    counter = kmer_count.KmerCounter(dfm)
    for size in ROUTE_SIZES:
        counter(kmers[:size])
        t0 = time.time()
        for _ in range(200):
            counter(kmers[:size])
        out["times"][f"KmerCounter call {size} wall"] = (time.time() - t0) / 200 * 1e3
    return out


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(prog="python3 -m siga_tpu_torch.probes.kernel_ab",
                                     description=__doc__.split("\n\n")[0])
    parser.add_argument("--trees", required=True, help="comma-separated checkouts")
    parser.add_argument("--order", default="0,1,1,0", help="indices into --trees, one worker each")
    parser.add_argument("--pipeline", required=True,
                        help="a pipeline directory left by chip_smoke.py --keep-pipeline")
    mode = parser.add_mutually_exclusive_group()
    mode.add_argument("--probes", action="store_true",
                      help="time the gather probes G2 and G4 instead of K1 and K7")
    mode.add_argument("--plane", action="store_true",
                      help="time the plane build K2 instead of K1 and K7")
    mode.add_argument("--scan", action="store_true",
                      help="time K3 and the sharded K3 instead of K1 and K7")
    mode.add_argument("--sw", action="store_true",
                      help="time Smith-Waterman K5 instead of K1 and K7")
    mode.add_argument("--sa", action="store_true",
                      help="time the device suffix sort K6 instead of K1 and K7")
    mode.add_argument("--dist", action="store_true",
                      help="time the distributed index build K8 instead of K1 and K7")
    mode.add_argument("--stage-a", action="store_true",
                      help="time the stage-A scan K9 and the row gather G1 instead of K1 and K7")
    parser.add_argument("--out", help="also write the JSON line here")
    parser.add_argument("--worker", help=argparse.SUPPRESS)
    args = parser.parse_args(argv)
    pipeline = os.path.abspath(args.pipeline)
    if args.worker:
        fn = (probe_worker if args.probes else plane_worker if args.plane
              else scan_worker if args.scan else sw_worker if args.sw
              else sa_worker if args.sa else dist_worker if args.dist
              else stage_a_worker if args.stage_a else worker)
        run = fn(args.worker, pipeline)
        print("KERNEL_AB " + json.dumps(run), flush=True)
        return 0
    trees = [os.path.abspath(t) for t in args.trees.split(",")]
    if args.sw:
        make_sw_inputs(pipeline)
    elif args.stage_a:
        make_stage_a_inputs(pipeline)
    elif not (args.probes or args.plane or args.sa or args.dist):
        make_inputs(pipeline)
    modes = ("probes", "plane", "scan", "sw", "sa", "dist", "stage_a")
    mode_args = [f"--{m.replace('_', '-')}" for m in modes if getattr(args, m)]
    runs = []
    for k in (int(i) for i in args.order.split(",")):
        env = {**os.environ, "PYTHONPATH": trees[k]}
        proc = subprocess.run(
            [sys.executable, os.path.abspath(__file__), "--worker", trees[k],
             "--trees", args.trees, "--pipeline", pipeline, *mode_args],
            cwd=trees[k], env=env, capture_output=True, text=True, timeout=1800,
        )
        if proc.returncode != 0:
            raise RuntimeError(f"worker on {trees[k]} exited {proc.returncode}:\n{proc.stderr[-4000:]}")
        line = next(l for l in proc.stdout.splitlines() if l.startswith("KERNEL_AB "))
        run = json.loads(line[len("KERNEL_AB "):])
        runs.append(run)
        print(f"{run['tree']}: build {run['build_s']:.1f} s; "
              + "; ".join(f"{k} {v:.4f} ms" for k, v in run["times"].items())
              + "".join(f"; {k}: {v}" for k, v in run.get("counts", {}).items()), flush=True)
    digests = {json.dumps(r["digests"], sort_keys=True) for r in runs}
    assert len(digests) == 1, f"the checkouts' outputs differ: {digests}"
    result = {"runs": runs, "outputs_equal": True}
    print(json.dumps(result))
    if args.out:
        with open(args.out, "w") as f:
            json.dump(result, f, indent=1)
    return 0


if __name__ == "__main__":
    if "--worker" in sys.argv:
        # run as a script on another checkout: import that checkout's package
        sys.path.insert(0, sys.argv[sys.argv.index("--worker") + 1])
    sys.exit(main())
