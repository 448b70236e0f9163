"""Single-device compile check and multi-device dry run of the port's stage A
on a tiny problem.

    python -m siga_tpu_torch.dryrun [--devices cuda | cuda:0,cuda:1,... | cpu,cpu]

Counterpart of the JAX package's `__graft_entry__.py`.  `entry(device)` is
its `entry`: the stage-A scan with '$'-probes (`ops/fm_device.py::
scan_stage_a`, the CUDA kernel K9 on a card) over the 8 random reads of
24 bp (seed 0), returned as (fn, example_args).  `dryrun_multidevice` is
its `dryrun_multichip`: on 8 (or 2 x D) such reads it indexes the reads on
the first device, then requires

  1. `scan_stage_a` over the lanes split into D parts, one a device (L
     padded to a multiple of D with lanes of length 1), each device with a
     copy of the plane, the parts joined in device order, to equal one run
     of the whole batch on the first device; it returns the sums JAX's
     step reduces (valid, final, emitted, lext);
  2. `ops/search.py::batch_overlap_hits` over the device list (each
     chunk's reads split over its entries, `parallel/dist.py`) to give the
     serialized hits of the exact host path (`OverlapBuilder.overlap`);
  3. the index-sharded scanner (`DualScanner(devices=...)`,
     the stacked single-step plane split by rows over the devices) to give
     the views of the replicated single-step scanner on the first device,
     for a lane bucket padded to a multiple of D;
  4. for D >= 2, the index built over the device list
     (`parallel/dist_build.py::distributed_index_arrays`, the suffix sort
     split into D segments) to give the BWT and `.sai` permutation of the
     index built on the first device.

The tiny problem's random reads emit no overlap blocks, so step 3
compares the containment candidates and the finals; emitted blocks are
held to the replicated scan by `tests/test_torch_scan_sharded.py` on the
CPU and by `chip_smoke.py` at full size on the card.

Any difference raises.  `--devices cuda` (the default) is every local
card; a repeated entry (`cuda:0,cuda:0`) puts several shards on one card.
The command runs `entry` once on the first device, then the dry run.
"""
from __future__ import annotations

import argparse
import sys

import numpy as np
import torch

from .index import sa
from .index.fm import FMIndex
from .io.fastx import DNASeq
from .core import dna
from .ops.fm_device import DeviceFM, DualScanner, scan_stage_a
from .ops.search import batch_overlap_hits
from .overlap.builder import Hit, OverlapBuilder
from .parallel import dist
from .parallel.dist_build import distributed_index_arrays, segment_sizes

MIN_OVERLAP = 8


def tiny_reads(num_reads: int = 8, readlen: int = 24, seed: int = 0) -> list:
    """The JAX dry run's reads (`__graft_entry__.py::_tiny_problem`)."""
    rng = np.random.default_rng(seed)
    return ["".join("ACGT"[c] for c in rng.integers(0, 4, readlen)) for _ in range(num_reads)]


def stage_a_chars(seqs, max_t: int | None = None):
    """The stage-A scan's lanes of `seqs` (one read a lane, as they are):
    chars int32 [n, max_t + 1] with chars[i, t] the rank of seq[l - 2 - t]
    for t < l - 1 and 0 after it, chars[i, max_t] the rank of seq[l - 1];
    lens int32 [n].  max_t defaults to the longest read's length - 1.  As
    `__graft_entry__.py::entry` builds them."""
    lens = np.fromiter(map(len, seqs), dtype=np.int32, count=len(seqs))
    if max_t is None:
        max_t = int(lens.max()) - 1
    ranks = np.zeros((len(seqs), max(int(lens.max()), 1)), dtype=np.int32)
    for i, s in enumerate(seqs):
        ranks[i, : len(s)] = dna.encode(s)
    rows = np.arange(len(seqs))[:, None]
    src = lens[:, None] - 2 - np.arange(max_t)[None, :]
    chars = np.zeros((len(seqs), max_t + 1), dtype=np.int32)
    chars[:, :max_t] = np.where(src >= 0, ranks[rows, np.maximum(src, 0)], 0)
    chars[:, max_t] = ranks[np.arange(len(seqs)), np.maximum(lens - 1, 0)]
    return chars, lens


def entry(device):
    """(fn, example_args) on `device`: fn(*example_args) runs the stage-A
    scan (`scan_stage_a`, min_overlap 8) of the 8-read, 24 bp tiny problem
    over its index's single-step plane; example_args = (plane, pred, chars,
    lens).  Counterpart of `__graft_entry__.py::entry`."""
    device = torch.device(device)
    seqs = tiny_reads()
    bwt, _perm, ns = sa.build_index_arrays(seqs, "sais2", device)
    fm = DeviceFM(FMIndex(bwt, ns), device)
    chars, lens = stage_a_chars(seqs)
    max_t, length = chars.shape[1] - 1, fm.length

    def fn(plane, pred, chars, lens):
        return scan_stage_a(max_t, MIN_OVERLAP, plane, pred, length, chars, lens)

    return fn, (fm.occ_plane, fm.pred_dev, torch.from_numpy(chars).to(device),
                torch.from_numpy(lens).to(device))


def stage_a_step(seqs, fmi: FMIndex, devices) -> dict:
    """The dry run's stage-A step: `scan_stage_a` over the lanes of `seqs`
    split into len(devices) parts (padded with lanes of length 1 to a
    multiple of it, as JAX's `pad_to_multiple` pads), part k on devices[k]
    with a copy of the plane of its own, joined in device order, against
    one run of the whole batch on devices[0].  Returns the sums of JAX's
    step: valid, final, emitted, lext."""
    d = len(devices)
    chars, lens = stage_a_chars(seqs)
    max_t = chars.shape[1] - 1
    pad = -len(seqs) % d
    chars = np.concatenate([chars, np.zeros((pad, max_t + 1), np.int32)])
    lens = np.concatenate([np.maximum(lens, 1), np.ones(pad, np.int32)])

    def run(device, rows):
        fm = DeviceFM(fmi, device)
        return scan_stage_a(max_t, MIN_OVERLAP, fm.occ_plane, fm.pred_dev, fm.length,
                            torch.from_numpy(chars[rows]).to(device),
                            torch.from_numpy(lens[rows]).to(device))

    per = len(lens) // d
    parts = [run(device, slice(k * per, (k + 1) * per)) for k, device in enumerate(devices)]
    first = devices[0]
    joined = [torch.cat([p[i].to(first) for p in parts], dim=1 if i < 2 else 0)
              for i in range(4)]
    whole = run(first, slice(None))
    for name, a, b in zip(("emitted", "valid", "final", "lext"), joined, whole):
        if not torch.equal(a, b):
            raise RuntimeError(f"the stage-A scan's {name} over {d} devices differs from one "
                               f"run on {first}")
    emitted, valid, final, lext = whole
    return {"valid": int(valid.sum()), "final": int(final.to(torch.int64).sum()),
            "emitted": int(emitted.to(torch.int64).sum()), "lext": int(lext.to(torch.int64).sum())}


def dryrun_multidevice(devices) -> dict:
    """Run the checks over `devices` (a list of devices of one type; see
    the module's docstring) and return what they compared."""
    devices = dist.device_list(devices)
    d = len(devices)
    seqs = tiny_reads(num_reads=max(2 * d, 8))
    bwt, perm, ns = sa.build_index_arrays(seqs, "sais2", devices[0])
    rbwt, _rperm, _ = sa.build_index_arrays([s[::-1] for s in seqs], "sais2", devices[0])
    fmi, rfmi = FMIndex(bwt, ns), FMIndex(rbwt, ns)
    stage_a = stage_a_step(seqs, fmi, devices)
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
        "devices": [str(x) for x in devices], "reads": len(seqs), "stage_a": stage_a,
        "hits": len(dev_hits),
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
    devices = parse_devices(args.devices)
    fn, example = entry(devices[0])
    emitted, valid, final, lext = fn(*example)
    print(f"entry on {devices[0]}: emitted {tuple(emitted.shape)}, valid {int(valid.sum())} of "
          f"{valid.numel()}, final {tuple(final.shape)}, lext {tuple(lext.shape)}")
    out = dryrun_multidevice(devices)
    print(f"dryrun_multidevice: OK {out}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
