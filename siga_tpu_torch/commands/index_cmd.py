"""`index` — build the BWT/FM-index of a read set (.sai/.bwt/.rsai/.rbwt).

Port of `siga_tpu/commands/index_cmd.py` with one algorithm, `host` (the
C++ seed-sort).  The device suffix sort (`-a sais2` in the JAX package) is
ROADMAP item K6 and not ported yet; asking for it is an error.
"""
from __future__ import annotations

import resource
import sys
import time
from typing import List

from siga_tpu.constants import BWT_EXT, RBWT_EXT, RSAI_EXT, SAI_EXT
from siga_tpu.io import bwtio, fastx, sai as sai_mod

from ..index import sa as sa_mod


def _save(prefix_sai: str, prefix_bwt: str, bwt, perm, ns) -> None:
    sai_mod.save_sai(prefix_sai, perm, ns)
    bwtio.save_bwt(prefix_bwt, bwt, ns)


def run(opts: dict, arguments: List[str]) -> int:
    if len(arguments) != 1:
        print("usage: index [OPTION] ... READSFILE", file=sys.stderr)
        return 256
    algorithm = str(opts.get("algorithm", "host"))
    if algorithm != "host":
        print(
            f"index: algorithm {algorithm!r} is not ported yet (ROADMAP K6, "
            "the device suffix sort); use -a host",
            file=sys.stderr,
        )
        return 1
    input_path = arguments[0]
    output = opts.get("prefix") or fastx.stem(input_path)
    records = fastx.read_sequences(input_path, with_quality=False, with_comment=False)
    seqs = [r.seq for r in records]

    t0 = time.time()
    if not opts.get("no-forward"):
        bwt, perm, ns = sa_mod.build_index_arrays(seqs)
        _save(output + SAI_EXT, output + BWT_EXT, bwt, perm, ns)
    if not opts.get("no-reverse"):
        bwt, perm, ns = sa_mod.build_index_arrays([s[::-1] for s in seqs])
        _save(output + RSAI_EXT, output + RBWT_EXT, bwt, perm, ns)
    maxrss = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss * 1024 / 1073741824.0
    print(
        f"[index] wall: {time.time()-t0:.3f} sec, max rss: {maxrss:.3f} GB",
        file=sys.stderr,
    )
    return 0
