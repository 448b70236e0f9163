"""Every kernel wrapper on a second card, held to the first card's outputs.

    python -m siga_tpu_torch.probes.second_card [--devices cuda:0,cuda:1]

Each wrapper runs on tensors of the second device while the first stays
the calling thread's current device, so a launch that took the current
device in place of its tensors' (`kernels.launch` sets it) would run on the
wrong card: K2 (`build_pair_plane`), K1
(`scan_pair`), K3 (`scan_single`), K5 (`sw_wavefront`), K7 (`count_kmers`)
and G1-G4 (`probes/gather.py`).  Every output must lie on its inputs'
device and equal the first device's bit for bit, and on a card each
wrapper's launch count must rise.  The inputs are made from a seed: a read
set from both strands of a random genome, its index sorted on each device
(`index/sa.py`, sais2).  On a host with fewer than two cards it raises.
Prints one JSON line: the devices, their names, and each wrapper's result.
"""
from __future__ import annotations

import argparse
import contextlib
import json
import sys

import numpy as np
import torch

from .. import kernels
from ..index import sa
from ..index.fm import FMIndex
from ..ops import fm_device, kmer_count, search, sw
from . import gather

SEED = 1
GENOME, READS, READ_LEN = 4000, 240, 80
MIN_OVERLAP = 30
K = 21


def read_set(seed: int = SEED):
    """READS reads of READ_LEN from both strands of a random genome."""
    rng = np.random.default_rng(seed)
    genome = rng.integers(0, 4, GENOME)
    starts = rng.integers(0, GENOME - READ_LEN + 1, READS)
    codes = genome[starts[:, None] + np.arange(READ_LEN)]
    flip = rng.random(READS) < 0.5
    codes[flip] = 3 - codes[flip, ::-1]
    return ["".join("ACGT"[c] for c in row) for row in codes]


def wrapper_calls(dev, seed: int = SEED) -> dict:
    """{label: (kernel name, call)}: each call runs one wrapper on inputs
    made from `seed` on `dev` and returns its outputs (a tuple of tensors)."""
    from .kernel_ab import single_scan_args, sw_synthetic_pairs, sw_tensors

    dev = torch.device(dev)
    reads = read_set(seed)
    fms = [FMIndex(bwt, ns) for bwt, _perm, ns in (
        sa.build_index_arrays(texts, "sais2", dev) for texts in (reads, [r[::-1] for r in reads]))]
    dfw, drev = (fm_device.DeviceFM(f, dev) for f in fms)
    codes = torch.from_numpy(np.ascontiguousarray(fms[0].codes)).to(dev)
    nblocks = fms[0].length // fm_device.SAMPLE + 1
    pair = fm_device.DualScanner(dfw, drev, pair_step=True)
    maxlen = search._bucket_len(READ_LEN)
    la_w, lens = fm_device.pack_reads_2bit(reads, len(reads), maxlen)
    lim_t = min(maxlen - 1, int(lens.max()) - 1)
    pair_args = (pair.plane, pair.K2, pair.pred, pair.length, pair.nblocks,
                 torch.from_numpy(la_w).to(dev), torch.from_numpy(lens).to(dev), lim_t,
                 MIN_OVERLAP, pair.fwd_groups, pair.rev_groups)
    plane1, tail = single_scan_args((dfw, drev), (pair.fwd_groups, pair.rev_groups), reads,
                                    len(reads), MIN_OVERLAP, dev)
    rng = np.random.default_rng(seed)
    kmers = [reads[i][j : j + K] for i, j in zip(rng.integers(0, READS, 500),
                                                rng.integers(0, READ_LEN - K + 1, 500))]
    kmer_codes = torch.from_numpy(kmer_count.encode_kmers(kmers)).to(dev)
    queries, refs = sw_tensors(*sw_synthetic_pairs(seed, 64), dev)
    probe_args = {tpu: (name, gather.to_device(args, dev))
                  for tpu, _where, name, args in gather.probe_cases(rng, 16)}
    return {
        "K2 build_pair_plane": ("pair_plane", lambda: fm_device.build_pair_plane(
            codes, fms[0].pred, nblocks)),
        "K1 scan_pair": ("scan_pair", lambda: fm_device.scan_pair(*pair_args)),
        "K3 scan_single": ("scan_single", lambda: fm_device.scan_single(plane1, *tail)),
        "K5 sw_wavefront": ("sw_wavefront", lambda: sw.sw_wavefront(queries, refs, 2, 2, 3, 1)),
        "K7 count_kmers": ("kmer_count", lambda: (kmer_count.count_kmers(dfw, kmer_codes),)),
        **{f"G {name} as {tpu}": (name, lambda name=name, args=args: (
            gather.WRAPPERS[name][0](*args),))
           for tpu, (name, args) in probe_args.items()
           if tpu in ("k_sub", "k_c", "k_scan", "k_d", "main.g kernel k")},
    }


def _flat(outputs) -> list:
    return [x for x in outputs if isinstance(x, torch.Tensor)]


def compare(first, second, seed: int = SEED) -> dict:
    """Each wrapper on `first`'s inputs and on `second`'s, with `first` the
    current device: {label: number of output tensors}; raises where an
    output leaves its device, the outputs differ, or a card's wrapper did
    not launch its kernel."""
    first, second = torch.device(first), torch.device(second)
    results = {}
    with torch.cuda.device(first) if first.type == "cuda" else contextlib.nullcontext():
        calls = [wrapper_calls(d, seed) for d in (first, second)]
        for label, (kernel, call_a) in calls[0].items():
            outs = []
            for dev, call in zip((first, second), (call_a, calls[1][label][1])):
                before = kernels.launches[kernel]
                got = _flat(call())
                if dev.type == "cuda":
                    torch.cuda.synchronize(dev)
                    if kernels.launches[kernel] <= before:
                        raise AssertionError(f"{label} on {dev}: no launch of {kernel}")
                for x in got:
                    if x.device != dev:
                        raise AssertionError(f"{label}: an output on {x.device}, inputs on {dev}")
                outs.append([x.cpu() for x in got])
            a, b = outs
            if len(a) != len(b) or not all(torch.equal(x, y) for x, y in zip(a, b)):
                raise AssertionError(f"{label}: outputs on {first} and {second} differ")
            results[label] = len(a)
    return results


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(prog="python -m siga_tpu_torch.probes.second_card",
                                     description=__doc__.split("\n\n")[0])
    parser.add_argument("--devices", default="cuda:0,cuda:1",
                        help="the first and the second device (default cuda:0,cuda:1)")
    args = parser.parse_args(argv)
    first, second = (torch.device(d) for d in args.devices.split(","))
    cards = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if cards < 2:
        raise RuntimeError(f"the second-card check needs two cards; this host has {cards}")
    results = compare(first, second)
    print(json.dumps({"devices": [str(first), str(second)],
                      "names": [torch.cuda.get_device_name(d) for d in (first, second)],
                      "equal": results}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
