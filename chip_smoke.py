#!/usr/bin/env python3
"""Run the PyTorch/CUDA port's main path once on one NVIDIA GPU and check it.

    python3 chip_smoke.py

Phases (any failure raises and exits non-zero; nothing is caught):
  1. the card: nvidia-smi name and power limit; CUDA must be available;
  2. build the hand-written kernels (csrc/*.cu, nvcc for sm_90a) and the
     shared C++ runtime for this host;
  3. simulate the 1 Mb x 25x read set (166,667 error-free 150 bp reads from
     both strands of a random genome, fixed seed);
  4. the main path, with the kernels' launch counts reset just before it:
     `index` -> `overlap -m 45` through siga_tpu_torch.cli, then the found
     edges scored with Smith-Waterman through BatchAligner (an exact overlap
     of length k must score 2k); every read must have its VT record;
  5. the overlap engine alone, warm, and the device pair plane against the
     C++ host packing;
  6. each kernel against its plain PyTorch version on the card, bit for bit:
     the K1 scan on the first full 15,152-read chunk (odd lim_t), on a chunk
     of 149 bp reads (even lim_t) and on the rmdup lane groups; K5 at
     B=4096, query 150, ref 400, and 16 of those pairs against a naive DP;
  7. the hits of 256 sampled reads, from the command's hits file and from
     the engine, against the shared host engine (OverlapBuilder.overlap);
  8. the kernels' JSON line, then the device line last.
Imports nothing of JAX.
"""
import gzip
import json
import os
import random
import shutil
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

from siga_tpu.core import dna
from siga_tpu.index.fm import FMIndex
from siga_tpu.io.fastx import DNASeq
from siga_tpu.overlap.builder import Hit, OverlapBuilder
from siga_tpu_torch import cli, kernels
from siga_tpu_torch.device import native_lib
from siga_tpu_torch.ops import fm_device, search, sw

SEED = 1
GENOME = 1_000_000
COVERAGE = 25
READ_LEN = 150
MIN_OVERLAP = 45
SW_PARAMS = (2, 2, 3, 1)
FWD_REV = ((fm_device.GROUP_ID, fm_device.GROUP_RC), (fm_device.GROUP_REV, fm_device.GROUP_COMP))
RMDUP = ((fm_device.GROUP_ID,), (fm_device.GROUP_COMP,))


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


def cuda_ms(fn, reps):
    """Mean ms of fn() over reps runs after one warm-up, timed with CUDA events."""
    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


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
    t0 = time.time()
    assert cli.main(["index", "-p", "reads", "reads.fa"]) == 0
    index_s = time.time() - t0
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
    return launches


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
    t0 = time.time()
    hits = list(search.batch_overlap_hits(builder, records, MIN_OVERLAP, dev))
    engine_s = time.time() - t0
    print(f"plane_build_s {plane_s:.3f} (forward plane equals the C++ host packing)")
    print(f"engine_s {engine_s:.3f} engine_reads_per_s {len(seqs) / engine_s:.1f}")
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
        phase("main path: index -> overlap -> SW scoring of the edges")
        launches = run_main_path(dev, seqs, rng)
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
    finally:
        os.chdir(home)
        shutil.rmtree(workdir)

    kernel_rows = []
    for name, source, replaces, (err, ms, plain_ms) in (
        ("scan_pair", "siga_tpu_torch/csrc/scan_pair.cu", "siga_tpu/ops/fm_device.py:858", k1),
        ("sw_wavefront", "siga_tpu_torch/csrc/sw.cu", "siga_tpu/ops/sw_pallas.py:32", k5),
    ):
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
