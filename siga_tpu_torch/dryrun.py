"""Multi-device dry run of the port's stage A on a tiny problem.

    python -m siga_tpu_torch.dryrun [--devices cuda | cuda:0,cuda:1,... | cpu,cpu]

Counterpart of the JAX package's `__graft_entry__.py::dryrun_multichip`:
on 8 (or 2 x D) random reads of 24 bp (seed 0) it indexes the reads on
the first device, then requires

  1. `ops/search.py::batch_overlap_hits` over the device list (each
     chunk's reads split over its entries, `parallel/dist.py`) to give the
     serialized hits of the exact host path (`OverlapBuilder.overlap`);
  2. the index-sharded scanner (`DualScanner(devices=...)`,
     the stacked single-step plane split by rows over the devices) to give
     the views of the replicated single-step scanner on the first device,
     for a lane bucket padded to a multiple of D;
  3. for D >= 2, the index built over the device list
     (`parallel/dist_build.py::distributed_index_arrays`, the suffix sort
     split into D segments) to give the BWT and `.sai` permutation of the
     index built on the first device.

The tiny problem's random reads emit no overlap blocks, so step 2
compares the containment candidates and the finals; emitted blocks are
held to the replicated scan by `tests/test_torch_scan_sharded.py` on the
CPU and by `chip_smoke.py` at full size on the card.

Any difference raises.  `--devices cuda` (the default) is every local
card; a repeated entry (`cuda:0,cuda:0`) puts several shards on one card.

One step of the JAX dry run is not here: its run of `_scan_stage_a` (an
XLA program that only that dry run calls; the port's stage A is K1 or K3).
"""
from __future__ import annotations

import argparse
import sys

import numpy as np
import torch

from .index import sa
from .index.fm import FMIndex
from .io.fastx import DNASeq
from .ops.fm_device import DeviceFM, DualScanner
from .ops.search import batch_overlap_hits
from .overlap.builder import Hit, OverlapBuilder
from .parallel import dist
from .parallel.dist_build import distributed_index_arrays, segment_sizes

MIN_OVERLAP = 8


def tiny_reads(num_reads: int = 8, readlen: int = 24, seed: int = 0) -> list:
    """The JAX dry run's reads (`__graft_entry__.py::_tiny_problem`)."""
    rng = np.random.default_rng(seed)
    return ["".join("ACGT"[c] for c in rng.integers(0, 4, readlen)) for _ in range(num_reads)]


def dryrun_multidevice(devices) -> dict:
    """Run the checks over `devices` (a list of devices of one type; see
    the module's docstring) and return what they compared."""
    devices = dist.device_list(devices)
    d = len(devices)
    seqs = tiny_reads(num_reads=max(2 * d, 8))
    bwt, perm, ns = sa.build_index_arrays(seqs, "sais2", devices[0])
    rbwt, _rperm, _ = sa.build_index_arrays([s[::-1] for s in seqs], "sais2", devices[0])
    fmi, rfmi = FMIndex(bwt, ns), FMIndex(rbwt, ns)
    builder = OverlapBuilder(fmi, rfmi)
    records = [DNASeq(name=f"r{i}", seq=s) for i, s in enumerate(seqs)]

    dev_hits = [h.serialize() for h in batch_overlap_hits(builder, records, MIN_OVERLAP, devices)]
    host_hits = []
    for i, rec in enumerate(records):
        hit = Hit(idx=i)
        hit.substring = builder.overlap(rec.seq, MIN_OVERLAP, hit.blocks).substring
        host_hits.append(hit.serialize())
    if dev_hits != host_hits:
        raise RuntimeError(f"the hits over {[str(x) for x in devices]} differ from the host path's")

    sharded = DualScanner(DeviceFM(fmi, devices[0]), DeviceFM(rfmi, devices[0]),
                          devices=devices)
    repl = DualScanner(DeviceFM(fmi, devices[0]), DeviceFM(rfmi, devices[0]), pair_step=False)
    n_bucket = -(-len(seqs) // d) * d
    maxlen = -(-max(map(len, seqs)) // 16) * 16
    views = [sc.collect(sc.dispatch(seqs, n_bucket, maxlen, MIN_OVERLAP)) for sc in (sharded, repl)]
    for a, b in zip(*views, strict=True):
        for x, y in zip(a, b, strict=True):
            if not np.array_equal(x, y):
                raise RuntimeError(f"the index-sharded views over {d} shards differ from the "
                                   f"replicated scan's")
    segments = []
    if d >= 2:
        dbwt, dperm, _ = distributed_index_arrays(seqs, devices)
        if not (np.array_equal(dbwt, bwt) and np.array_equal(dperm, perm)):
            raise RuntimeError(f"the index built over {d} segments differs from the one built "
                               f"on {devices[0]}")
        segments = segment_sizes(sum(len(s) + 1 for s in seqs), d)
    return {
        "devices": [str(x) for x in devices], "reads": len(seqs), "hits": len(dev_hits),
        "blocks": int(sum(len(v[0]) for v in views[0])),
        "shard_rows": [int(s.shape[0]) for s in sharded.shards], "segments": segments,
    }


def parse_devices(text: str) -> list:
    """`cuda` is every local card; else a comma-separated list of devices."""
    if text == "cuda":
        return dist.data_devices()
    return dist.device_list(text.split(","))


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--devices", default="cuda",
                        help="cuda (every local card, the default) or a comma-separated list")
    args = parser.parse_args(argv)
    out = dryrun_multidevice(parse_devices(args.devices))
    print(f"dryrun_multidevice: OK {out}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
