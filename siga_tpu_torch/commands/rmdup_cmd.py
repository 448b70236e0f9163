"""`rmdup` — duplicate and contained read removal.

Port of `siga_tpu/commands/rmdup_cmd.py` with the stage-A scan on
`--device` (default cuda): per read, the containment-only search
(min_overlap = read length); reads flagged substring or contained
(containment with containedIdx == 0) go to <prefix>.rmdup.dups.fa annotated
with seqrank, the rest to <prefix>.rmdup.fa; every read gets a
NumDuplicates count.  The hits go through one shard file,
<prefix>-thread0.rmdup.hits.gz, as in the JAX package, written through the
shared `fastx.xopen` (gzip level 1, as every other hits and ASQG file).  The
JAX package's rmdup writes the same content at level 9, whose deflate is
most of the time of its hits pass.
"""
from __future__ import annotations

import sys
import time
from typing import List

from ..constants import BWT_EXT, GZIP_EXT, HITS_EXT, RBWT_EXT, RMDUP_EXT, RSAI_EXT, SAI_EXT
from ..index.fm import FMIndex
from ..io import fastx, sai as sai_mod
from ..overlap.builder import Hit, HitConverter, OverlapBuilder

from ..device import native_lib, resolve_device
from ..ops.search import batch_duplicate_hits


def run(opts: dict, arguments: List[str]) -> int:
    if len(arguments) != 1:
        print("usage: rmdup [OPTION] ... READSFILE", file=sys.stderr)
        return 256
    device = resolve_device(opts.get("device", "cuda"))
    native_lib()
    t0 = time.time()
    input_path = arguments[0]
    prefix = opts.get("prefix") or fastx.stem(input_path)

    fmi = FMIndex.load(prefix + BWT_EXT)
    rfmi = FMIndex.load(prefix + RBWT_EXT)
    builder = OverlapBuilder(fmi, rfmi, prefix)

    records = fastx.read_sequences(input_path)
    names = [r.name for r in records]
    lengths = [len(r.seq) for r in records]

    hits_path = f"{prefix}-thread0{RMDUP_EXT}{HITS_EXT}{GZIP_EXT}"
    with fastx.xopen(hits_path, "wt") as hf:
        for rec, hit in zip(records, batch_duplicate_hits(builder, records, device)):
            hf.write(f"{rec.name}\t{rec.seq}\t{hit.serialize()}\n")
    t_hits = time.time()

    sa_perm, _ = sai_mod.load_sai(prefix + SAI_EXT)
    rsa_perm, _ = sai_mod.load_sai(prefix + RSAI_EXT)
    converter = HitConverter(sa_perm, rsa_perm, names, lengths)

    kept_path = prefix + RMDUP_EXT + ".fa"
    dups_path = prefix + RMDUP_EXT + ".dups.fa"
    with open(kept_path, "w") as kept, open(dups_path, "w") as dups, fastx.xopen(
        hits_path, "rt"
    ) as hf:
        for line in hf:
            line = line.strip()
            if not line:
                continue
            name, seq, hit_text = line.split("\t", 2)
            hit = Hit.deserialize(hit_text)
            overlaps, num_copies = converter.convert(hit)
            is_contained = hit.substring or any(
                o.is_containment() and o.contained_idx() == 0 for o in overlaps
            )
            # the reference's meta repeats the read name
            meta = f"{name} NumDuplicates={num_copies}"
            rec = fastx.DNASeq(seq=seq)
            if is_contained:
                rec.name = f"{name},seqrank={hit.idx} {meta}"
                dups.write(rec.format())
            else:
                rec.name = f"{name} {meta}"
                kept.write(rec.format())
    t_end = time.time()
    print(
        f"[rmdup] wall: {t_end - t0:.3f} sec (hits {t_hits - t0:.3f}, "
        f"classify {t_end - t_hits:.3f}) on {device}",
        file=sys.stderr,
    )
    return 0
