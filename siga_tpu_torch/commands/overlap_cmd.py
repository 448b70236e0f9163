"""`overlap` — compute pairwise overlaps on the device, emit ASQG.

Port of the single-process path of `siga_tpu/commands/overlap_cmd.py`: ASQG
header, per-read overlap blocks streamed to hits shard files
({prefix}-thread{i}.hits.gz), VT records in read order, then hits -> ED
records through the .sai/.rsai permutations.  The multi-process worker and
merge modes are not ported yet.
"""
from __future__ import annotations

import sys
import time
from typing import List

from siga_tpu import native
from siga_tpu.commands.overlap_cmd import format_vertex_record
from siga_tpu.constants import ASQG_EXT, BWT_EXT, GZIP_EXT, HITS_EXT, RBWT_EXT, RSAI_EXT, SAI_EXT
from siga_tpu.index.fm import FMIndex
from siga_tpu.io import asqg, fastx, sai as sai_mod
from siga_tpu.overlap.builder import BatchHitConverter, Hit, OverlapBuilder

from ..device import native_lib, resolve_device
from ..ops.search import batch_overlap_hits

ED_BATCH = 4096
# hit arrays kept in memory for the ED pass while their blocks fit; above it
# the pass re-reads the hits files (which stay the stage checkpoint either way)
MEM_BLOCK_BUDGET = 4_000_000


def build_overlaps(
    input_path: str,
    prefix: str,
    output_path: str,
    min_overlap: int,
    device,
    irreducible: bool = True,
    rc: bool = True,
    shards: int = 1,
) -> None:
    device = resolve_device(device)
    native_lib()
    t_start = time.time()
    records = fastx.read_sequences(input_path)
    names = [r.name for r in records]
    lengths = [len(r.seq) for r in records]

    fmi = FMIndex.load(prefix + BWT_EXT)
    rfmi = FMIndex.load(prefix + RBWT_EXT)
    builder = OverlapBuilder(fmi, rfmi, prefix, irreducible=irreducible, rc=rc)
    t_loaded = time.time()

    hit_paths = [
        f"{prefix}-thread{i}{HITS_EXT}{GZIP_EXT}" for i in range(max(1, shards))
    ]
    in_mem: list = []
    mem_blocks = 0
    pend: list = []  # (idx, substring, block array) awaiting the formatter
    vt_buf: list = []

    with fastx.xopen(output_path, "wt") as out:
        header = asqg.HeaderRecord(overlap=min_overlap, containment=1, infile=input_path)
        out.write(header.format() + "\n")
        hit_files = [fastx.xopen(p, "wb") for p in hit_paths]

        def flush_hits():
            if not pend:
                return
            blob, offs = native.format_hits(
                [p[0] for p in pend], [p[1] for p in pend], [p[2] for p in pend]
            )
            if len(hit_files) == 1:
                hit_files[0].write(blob)
            else:
                for i, (idx, _s, _a) in enumerate(pend):
                    hit_files[idx % len(hit_files)].write(blob[offs[i] : offs[i + 1]])
            pend.clear()

        try:
            hits = batch_overlap_hits(builder, records, min_overlap, device)
            for rec, hit in zip(records, hits):
                arr = hit._array
                pend.append((hit.idx, hit.substring, arr))
                if len(pend) >= ED_BATCH:
                    flush_hits()
                vt_buf.append(format_vertex_record(rec, hit.substring))
                if len(vt_buf) >= ED_BATCH:
                    out.write("\n".join(vt_buf) + "\n")
                    vt_buf.clear()
                if in_mem is not None:
                    in_mem.append((hit.idx, arr))
                    mem_blocks += len(arr)
                    if mem_blocks > MEM_BLOCK_BUDGET:
                        in_mem = None
            flush_hits()
            if vt_buf:
                out.write("\n".join(vt_buf) + "\n")
        finally:
            for f in hit_files:
                f.close()
        t_hits = time.time()

        sa_perm, _ = sai_mod.load_sai(prefix + SAI_EXT)
        rsa_perm, _ = sai_mod.load_sai(prefix + RSAI_EXT)
        converter = BatchHitConverter(sa_perm, rsa_perm, names, lengths)

        def hit_arrays():
            if in_mem is not None:
                # hits were written shard-round-robin; ED order follows the
                # shard-sequential re-read order
                for shard in range(len(hit_paths)):
                    yield from in_mem[shard :: len(hit_paths)]
                return
            for path in hit_paths:
                with fastx.xopen(path, "rt") as f:
                    for line in f:
                        line = line.strip()
                        if line:
                            idx, _sub, arr = Hit.parse_array(line)
                            yield idx, arr

        batch = []
        for item in hit_arrays():
            batch.append(item)
            if len(batch) >= ED_BATCH:
                eds = converter.convert_lines(batch)
                if eds:
                    out.write("\n".join(eds) + "\n")
                batch = []
        eds = converter.convert_lines(batch)
        if eds:
            out.write("\n".join(eds) + "\n")
    t_end = time.time()
    print(
        f"[overlap] wall: {t_end - t_start:.3f} sec (load {t_loaded - t_start:.3f}, "
        f"hits {t_hits - t_loaded:.3f}, edges {t_end - t_hits:.3f}) on {device}",
        file=sys.stderr,
    )


def run(opts: dict, arguments: List[str]) -> int:
    if len(arguments) != 1:
        print("usage: overlap [OPTION] ... READSFILE", file=sys.stderr)
        return 256
    for name in ("engine", "process-id", "num-processes", "merge-only"):
        if name in opts:
            print(
                f"overlap: --{name} is not ported yet (the stage-A engine is "
                "chosen with --device)",
                file=sys.stderr,
            )
            return 1
    input_path = arguments[0]
    prefix = opts.get("prefix") or fastx.stem(input_path)
    build_overlaps(
        input_path,
        prefix,
        prefix + ASQG_EXT + GZIP_EXT,
        min_overlap=int(opts.get("min-overlap", 10)),
        device=opts.get("device", "cuda"),
        irreducible=not opts.get("exhaustive"),
        rc=not opts.get("no-opposite-strand"),
        shards=int(opts.get("threads", 1)),
    )
    return 0
