"""Time K1 and K7 of two checkouts of the repo against each other on one
card, at the error pipeline's own shapes.

    python3 chip_smoke.py --keep-pipeline DIR
    python3 -m siga_tpu_torch.probes.kernel_ab --trees OTHER,. --pipeline DIR \
        [--order 0,1,1,0] [--out FILE]

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
import hashlib
import json
import os
import subprocess
import sys
import time

import numpy as np

KMER_SEED = 3
K, KMERS, ROUTE_SIZES = 41, 262_144, (110, 3)
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


def _digest(outputs) -> str:
    h = hashlib.sha256()
    for x in outputs:
        h.update(x.detach().cpu().contiguous().numpy().tobytes())
    return h.hexdigest()[:16]


def worker(tree: str, pipeline: str) -> dict:
    """Times of K1 and K7 through the wrappers of the checkout at `tree`."""
    import torch

    from siga_tpu_torch import kernels
    from siga_tpu_torch.ops import fm_device, kmer_count, search
    from siga_tpu_torch.probes.gather import cuda_ms

    pkg = os.path.dirname(os.path.abspath(kernels.__file__))
    assert os.path.samefile(os.path.dirname(pkg), tree), (pkg, tree)
    dev = torch.device("cuda")
    t0 = time.time()
    report = kernels.build()
    kernels.lib()
    out = {"tree": tree, "build_s": time.time() - t0, "times": {}, "digests": {},
           "ptxas": [l.strip() for l in report.splitlines() if "registers" in l or "spill" in l]}
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
    parser.add_argument("--out", help="also write the JSON line here")
    parser.add_argument("--worker", help=argparse.SUPPRESS)
    args = parser.parse_args(argv)
    pipeline = os.path.abspath(args.pipeline)
    if args.worker:
        print("KERNEL_AB " + json.dumps(worker(args.worker, pipeline)), flush=True)
        return 0
    trees = [os.path.abspath(t) for t in args.trees.split(",")]
    make_inputs(pipeline)
    runs = []
    for k in (int(i) for i in args.order.split(",")):
        env = {**os.environ, "PYTHONPATH": trees[k]}
        proc = subprocess.run(
            [sys.executable, os.path.abspath(__file__), "--worker", trees[k],
             "--trees", args.trees, "--pipeline", pipeline],
            cwd=trees[k], env=env, capture_output=True, text=True, timeout=1800,
        )
        if proc.returncode != 0:
            raise RuntimeError(f"worker on {trees[k]} exited {proc.returncode}:\n{proc.stderr[-4000:]}")
        line = next(l for l in proc.stdout.splitlines() if l.startswith("KERNEL_AB "))
        run = json.loads(line[len("KERNEL_AB "):])
        runs.append(run)
        print(f"{run['tree']}: build {run['build_s']:.1f} s; "
              + "; ".join(f"{k} {v:.4f} ms" for k, v in run["times"].items()), flush=True)
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
