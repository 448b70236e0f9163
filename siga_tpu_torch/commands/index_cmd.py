"""`index` — build the BWT/FM-index of a read set (.sai/.bwt/.rsai/.rbwt).

Port of `siga_tpu/commands/index_cmd.py`: reads stripped of quality and
comment, the forward index -> .sai/.bwt, then each read reversed (plain
reversal, not rc) -> .rsai/.rbwt.  `-a sais2` (the default) runs the suffix
sort on `--device` (default cuda: every local card, K6 on the first where it
takes the text alone, else K8 over them; `sa.bwt_perm_route`); `-a host`
runs the shared C++ seed-sort.
"""
from __future__ import annotations

import resource
import sys
import time
from typing import List

from ..constants import BWT_EXT, RBWT_EXT, RSAI_EXT, SAI_EXT
from ..io import bwtio, fastx, sai as sai_mod

from ..index import sa as sa_mod

ALGORITHMS = ("sais2", "host")


def _save(prefix_sai: str, prefix_bwt: str, bwt, perm, ns) -> None:
    sai_mod.save_sai(prefix_sai, perm, ns)
    bwtio.save_bwt(prefix_bwt, bwt, ns)


def run(opts: dict, arguments: List[str]) -> int:
    if len(arguments) != 1:
        print("usage: index [OPTION] ... READSFILE", file=sys.stderr)
        return 256
    algorithm = str(opts.get("algorithm", "sais2"))
    if algorithm not in ALGORITHMS:
        print(
            f"index: unknown algorithm {algorithm!r} (sais2 or host)", file=sys.stderr
        )
        return 1
    devices = sa_mod.index_devices(opts.get("device", "cuda")) if algorithm == "sais2" else None
    input_path = arguments[0]
    output = opts.get("prefix") or fastx.stem(input_path)
    records = fastx.read_sequences(input_path, with_quality=False, with_comment=False)
    seqs = [r.seq for r in records]

    t0 = time.time()
    if not opts.get("no-forward"):
        bwt, perm, ns = sa_mod.build_index_arrays(seqs, algorithm, devices)
        _save(output + SAI_EXT, output + BWT_EXT, bwt, perm, ns)
    if not opts.get("no-reverse"):
        bwt, perm, ns = sa_mod.build_index_arrays([s[::-1] for s in seqs], algorithm, devices)
        _save(output + RSAI_EXT, output + RBWT_EXT, bwt, perm, ns)
    maxrss = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss * 1024 / 1073741824.0
    where = f"-a {algorithm}" + (f" on {', '.join(map(str, devices))}" if devices else "")
    print(
        f"[index] wall: {time.time()-t0:.3f} sec, max rss: {maxrss:.3f} GB ({where})",
        file=sys.stderr,
    )
    return 0
