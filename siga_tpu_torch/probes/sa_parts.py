"""Where the time of K6's two scans that scatter ranks goes, on one card.

    python3 -m siga_tpu_torch.probes.sa_parts --reads FASTA

Runs K6's route (`index/sa.py::index_arrays_device`) on the rank text of
FASTA's reads with its steps recorded, then times `sa_seed_ranks` and the
`sa_round_scatter` of a round before the last (`csrc/suffix_sort.cu`) on
the recorded inputs beside copies of the source compiled with one change
each (the outputs of the changed copies are wrong; every address stays
inside its array):
  - `no_wait`: every tile takes its own scan as the whole array's, so no
    look-back waits on the tiles before it;
  - `slot_order`: each rank is written to its slot, in the order the
    kernel reads its rows, in place of its position: a coalesced store in
    place of a random one;
  - both changes at once;
and beside single PyTorch calls on the same inputs: the random reads
order2[idx3], key_b[order], sentpos[order] and the random store rank[order]
= value.  Prints one JSON line of the times (CUDA events, REPS calls, ROUNDS
timings of each in turn, the median).  Needs a card and nvcc; a source
that no longer has the anchors the changes need makes it fail.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import os
import subprocess

import numpy as np
import torch

from .. import kernels
from ..device import BUILD_DIR
from ..index import sa
from ..io import fastx
from .gather import cuda_ms

SOURCE = os.path.join(kernels.CSRC, "suffix_sort.cu")
REPS = 20  # calls a timing
ROUNDS = 3  # timings of each, in turn
_NO_WAIT = [("  if (tile == 0) {\n    if (lane == 0) store_word(state, word(agg, kInclusive));",
             "  if (true) {\n    if (lane == 0) store_word(state, word(agg, kInclusive));")]
_SLOT_ORDER = [
    ("    rank[pos[j]] = static_cast<int>(max(wb.head, head[j]));",
     "    rank[i] = static_cast<int>(max(wb.head, head[j]));"),
    ("    if (base + first + 32 * j < m) rank[pos[j]] = static_cast<int>(max(wb.head, head[j]));",
     "    if (base + first + 32 * j < m) {\n"
     "      rank[base + first + 32 * j] = static_cast<int>(max(wb.head, head[j]));\n    }"),
]
CHANGES = {"no_wait": _NO_WAIT, "slot_order": _SLOT_ORDER, "no_wait+slot_order": _NO_WAIT + _SLOT_ORDER}


def changed(text: str, name: str) -> str:
    """The source with CHANGES[name] made, each anchor found exactly once."""
    for old, new in CHANGES[name]:
        if text.count(old) != 1:
            raise RuntimeError(f"suffix_sort.cu: want one {old!r} to change, found {text.count(old)}")
        text = text.replace(old, new)
    return text


def build(name: str) -> ctypes.CDLL:
    """The source with CHANGES[name], compiled alone."""
    out_dir = os.path.join(BUILD_DIR, "sa_parts")
    os.makedirs(out_dir, exist_ok=True)
    src, lib = os.path.join(out_dir, f"{name}.cu"), os.path.join(out_dir, f"{name}.so")
    with open(SOURCE) as f, open(src, "w") as g:
        g.write(changed(f.read(), name))
    proc = subprocess.run([kernels.nvcc(), *kernels.NVCC_FLAGS, "-shared", "-o", lib, src],
                          capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc {name} failed ({proc.returncode}):\n{proc.stderr}")
    handle = ctypes.CDLL(lib)
    for fn in ("siga_sa_seed_ranks", "siga_sa_round_scatter", "siga_sa_scan_scratch"):
        getattr(handle, fn).argtypes = kernels._SIGNATURES[fn]
        getattr(handle, fn).restype = ctypes.c_int
    return handle


def calls(lib, ranks_args, scatter_args) -> dict:
    """{label: fn} of one seed_ranks and one round_scatter through `lib`'s C
    entries on the recorded inputs (outputs into scratch tensors)."""
    order2, idx3, ka_s, key_b, sentpos, m = ranks_args
    idx, skey, upos, uslot, order, rank = scatter_args
    dev, n = idx3.device, idx3.numel()
    out = [torch.empty(n, dtype=torch.int64, device=dev), torch.empty(n, dtype=torch.int32, device=dev),
           torch.empty(m, dtype=torch.int32, device=dev)]
    order, rank = order.clone(), rank.clone()
    scratch = torch.empty(lib.siga_sa_scan_scratch(n), dtype=torch.int64, device=dev)

    def seed_ranks():
        kernels.launch("sa_seed_ranks", dev, lib.siga_sa_seed_ranks, order2.data_ptr(),
                       idx3.data_ptr(), ka_s.data_ptr(), key_b.data_ptr(), sentpos.data_ptr(), n,
                       *(t.data_ptr() for t in out[:2]), out[2].data_ptr(), m, scratch.data_ptr())

    def round_scatter():
        kernels.launch("sa_round_scatter", dev, lib.siga_sa_round_scatter, idx.data_ptr(),
                       skey.data_ptr(), upos.data_ptr(), uslot.data_ptr(), idx.numel(),
                       order.data_ptr(), rank.data_ptr(), scratch.data_ptr())

    return {"seed_ranks": seed_ranks, "round_scatter": round_scatter}


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(prog="python3 -m siga_tpu_torch.probes.sa_parts",
                                     description=__doc__.split("\n\n")[0])
    parser.add_argument("--reads", required=True, help="a FASTA/FASTQ of reads")
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("sa_parts needs a card")
    dev = torch.device("cuda")
    codes = sa.concat_reads([r.seq for r in fastx.read_sequences(args.reads)])[0]
    record = {}
    sa.index_arrays_device(codes, dev, record)
    if "sa_round_scatter" not in record:
        raise SystemExit(f"{args.reads}: fewer than two doubling rounds, no round scatters ranks")
    ranks_args, scatter_args = record["sa_seed_ranks"][1], record["sa_round_scatter"][1]
    runs = {}
    for name in ("kernel", *CHANGES):
        lib = kernels.lib() if name == "kernel" else build(name)
        for step, fn in calls(lib, ranks_args, scatter_args).items():
            runs[f"{step} {name}"] = fn
    order2, idx3, _ka, key_b, sentpos, _m = ranks_args
    order = order2[idx3]
    value = torch.zeros(order.numel(), dtype=torch.int32, device=dev)
    rank = torch.empty_like(value)
    runs.update({
        "torch order2[idx3]": lambda: order2[idx3],
        "torch key_b[order]": lambda: key_b[order],
        "torch sentpos[order]": lambda: sentpos[order],
        "torch rank[order] = value": lambda: rank.index_put_((order,), value),
    })
    times = {label: [] for label in runs}
    for _ in range(ROUNDS):
        for label, fn in runs.items():
            times[label].append(cuda_ms(fn, REPS))
    print(json.dumps({"chars": int(codes.size), "plan": list(sa.sort_plan(codes)),
                      "card": torch.cuda.get_device_name(0),
                      "ms": {k: float(np.median(v)) for k, v in times.items()},
                      "ms_spread": {k: [float(min(v)), float(max(v))] for k, v in times.items()}}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
