"""`overlap` — compute pairwise overlaps, emit ASQG.

Port of `siga_tpu/commands/overlap_cmd.py`: ASQG header, per-read overlap
blocks streamed to hits shard files ({prefix}-thread{i}.hits.gz), VT records
in read order, then hits -> ED records through the .sai/.rsai permutations.
`--engine=auto|tpu` runs stage A on `--device` (`ops/search.py`), any other
engine the host engine (`OverlapBuilder.overlap`).  The multi-process
modes: `--process-id I --num-processes N` writes only hits shard I, for the
reads I mod N, and waits at a barrier (`parallel/multihost.py`);
`--merge-only -t N` emits the ASQG from N shards (`_merge_hits`).
`format_vertex_record`, `write_vertex_record`, `_merge_hits` and
`_host_hits` are copies of the JAX package's, which must write the same
bytes.
"""
from __future__ import annotations

import sys
import time
from typing import List

from .. import native
from ..constants import ASQG_EXT, BWT_EXT, GZIP_EXT, HITS_EXT, RBWT_EXT, RSAI_EXT, SAI_EXT
from ..index.fm import FMIndex
from ..io import asqg, fastx, sai as sai_mod
from ..overlap.builder import BatchHitConverter, Hit, OverlapBuilder
from ..device import native_lib, resolve_device
from ..ops.search import _blocks_to_array, batch_overlap_hits
from ..parallel import multihost

ED_BATCH = 4096
# hit arrays kept in memory for the ED pass while their blocks fit; above it
# the pass re-reads the hits files (which stay the stage checkpoint either way)
MEM_BLOCK_BUDGET = 4_000_000


def format_vertex_record(rec: fastx.DNASeq, substring: bool) -> str:
    """Fast path of write_vertex_record for comment-less reads (the common
    case); byte-identical to VertexRecord.format."""
    if rec.comment:
        record = asqg.VertexRecord(
            id=rec.name, seq=rec.seq, substring=1 if substring else 0
        )
        for token in rec.comment.split(" "):
            for tag, attr in (
                (asqg.BARCODE_TAG, "barcode"),
                (asqg.COVERAGE_TAG, "coverage"),
                (asqg.EXTENSION_TAG, "ext"),
            ):
                if token.startswith(tag):
                    kv = asqg.parse_tag(token)
                    if kv:
                        setattr(record, attr, kv[1])
        return record.format()
    return f"VT\t{rec.name}\t{rec.seq}\tSS:i:{1 if substring else 0}"


def write_vertex_record(out, rec: fastx.DNASeq, substring: bool) -> None:
    record = asqg.VertexRecord(id=rec.name, seq=rec.seq, substring=1 if substring else 0)
    if rec.comment:
        for token in rec.comment.split(" "):
            if token.startswith(asqg.BARCODE_TAG):
                kv = asqg.parse_tag(token)
                if kv:
                    record.barcode = kv[1]
            elif token.startswith(asqg.COVERAGE_TAG):
                kv = asqg.parse_tag(token)
                if kv:
                    record.coverage = kv[1]
            elif token.startswith(asqg.EXTENSION_TAG):
                kv = asqg.parse_tag(token)
                if kv:
                    record.ext = kv[1]
    out.write(record.format() + "\n")


def _merge_hits(
    input_path, prefix, output_path, min_overlap, shards,
) -> bool:
    """Merge step of the multi-process overlap: re-read the N hits shard
    files and emit the ASQG (header + VT in read order + ED shard-sequential)
    — byte-identical to a single-process `-t N` run.

    Streaming (BASELINE config 5 data plane): shards are traversed twice —
    once for the per-read substring flags (idx + flag only), once batched
    through the ED converter — and the read set streams through the VT pass
    (only names/lengths are retained), so merge RSS stays flat in shard
    count, shard size, and read-set size."""
    hit_paths = [
        f"{prefix}-thread{i}{HITS_EXT}{GZIP_EXT}" for i in range(max(1, shards))
    ]
    substring = bytearray()
    for path in hit_paths:
        with fastx.xopen(path, "rt") as f:
            for line in f:
                # flags pass: only the first two tokens matter
                parts = line.split(" ", 2)
                if len(parts) >= 2:
                    idx = int(parts[0])
                    if idx >= len(substring):
                        substring.extend(b"\0" * (idx + 1 - len(substring)))
                    substring[idx] = 1 if parts[1] == "1" else 0

    out = fastx.xopen(output_path, "wt")
    header = asqg.HeaderRecord(overlap=min_overlap, containment=1, infile=input_path)
    out.write(header.format() + "\n")
    names: List[str] = []
    lengths: List[int] = []
    for idx, rec in enumerate(fastx.iter_sequences(input_path)):
        sub = bool(substring[idx]) if idx < len(substring) else False
        write_vertex_record(out, rec, sub)
        names.append(rec.name)
        lengths.append(len(rec.seq))

    sa_perm, _ = sai_mod.load_sai(prefix + SAI_EXT)
    rsa_perm, _ = sai_mod.load_sai(prefix + RSAI_EXT)
    converter = BatchHitConverter(sa_perm, rsa_perm, names, lengths)
    batch = []
    for path in hit_paths:
        with fastx.xopen(path, "rt") as f:
            for line in f:
                line = line.strip()
                if not line:
                    continue
                idx, _sub, arr = Hit.parse_array(line)
                batch.append((idx, arr))
                if len(batch) >= 4096:
                    eds = converter.convert_lines(batch)
                    if eds:
                        out.write("\n".join(eds) + "\n")
                    batch = []
    eds = converter.convert_lines(batch)
    if eds:
        out.write("\n".join(eds) + "\n")
    out.close()
    return True


def _host_hits(builder: OverlapBuilder, records, min_overlap: int):
    for idx, rec in enumerate(records):
        hit = Hit(idx=idx)
        result = builder.overlap(rec.seq, min_overlap, hit.blocks)
        hit.substring = result.substring
        yield hit


def _load_builder(prefix: str, irreducible: bool, rc: bool) -> OverlapBuilder:
    fmi = FMIndex.load(prefix + BWT_EXT)
    rfmi = FMIndex.load(prefix + RBWT_EXT)
    return OverlapBuilder(fmi, rfmi, prefix, irreducible=irreducible, rc=rc)


def _hits(builder, records, min_overlap: int, engine: str, device):
    """One Hit per read, in input order: stage A on the device for
    `--engine=auto|tpu`, the shared host engine otherwise."""
    if engine in ("auto", "tpu"):
        return batch_overlap_hits(builder, records, min_overlap, resolve_device(device))
    return _host_hits(builder, records, min_overlap)


def _hit_array(hit):
    """The hit's (n, 10) block array (the device engine's hits carry it)."""
    arr = getattr(hit, "_array", None)
    return _blocks_to_array(hit.blocks) if arr is None else arr


def _flush_hits(pend: list, files: list) -> None:
    """Format the pending (read index, substring, block array) hits in one
    native call and write each to shard file `index mod len(files)`."""
    if not pend:
        return
    blob, offs = native.format_hits([p[0] for p in pend], [p[1] for p in pend], [p[2] for p in pend])
    if len(files) == 1:
        files[0].write(blob)
    else:
        for i, (idx, _s, _a) in enumerate(pend):
            files[idx % len(files)].write(blob[offs[i] : offs[i + 1]])
    pend.clear()


def write_hits_shard(
    input_path: str,
    prefix: str,
    min_overlap: int,
    device,
    process_id: int,
    num_processes: int,
    irreducible: bool = True,
    rc: bool = True,
    engine: str = "auto",
) -> None:
    """Worker mode: the hits of reads process_id mod num_processes, with their
    global read indices, into shard {prefix}-thread{process_id}.hits.gz (the
    file a single-process `-t num_processes` run writes), then the barrier."""
    native_lib()
    t_start = time.time()
    builder = _load_builder(prefix, irreducible, rc)
    subset, gidx = fastx.read_sequences_strided(input_path, process_id, num_processes)
    pend: list = []  # (global idx, substring, block array) awaiting the formatter
    with fastx.xopen(f"{prefix}-thread{process_id}{HITS_EXT}{GZIP_EXT}", "wb") as f:
        for local, hit in enumerate(_hits(builder, subset, min_overlap, engine, device)):
            pend.append((gidx[local], hit.substring, _hit_array(hit)))
            if len(pend) >= ED_BATCH:
                _flush_hits(pend, [f])
        _flush_hits(pend, [f])
    t_hits = time.time()
    multihost.barrier("overlap-hits")
    print(
        f"[overlap] worker {process_id}/{num_processes}: {len(subset)} reads, hits "
        f"{t_hits - t_start:.3f} sec, barrier {time.time() - t_hits:.3f} sec",
        file=sys.stderr,
    )


def build_overlaps(
    input_path: str,
    prefix: str,
    output_path: str,
    min_overlap: int,
    device,
    irreducible: bool = True,
    rc: bool = True,
    shards: int = 1,
    engine: str = "auto",
) -> None:
    native_lib()
    t_start = time.time()
    records = fastx.read_sequences(input_path)
    names = [r.name for r in records]
    lengths = [len(r.seq) for r in records]
    builder = _load_builder(prefix, irreducible, rc)
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
        try:
            hits = _hits(builder, records, min_overlap, engine, device)
            for rec, hit in zip(records, hits):
                arr = _hit_array(hit)
                pend.append((hit.idx, hit.substring, arr))
                if len(pend) >= ED_BATCH:
                    _flush_hits(pend, hit_files)
                vt_buf.append(format_vertex_record(rec, hit.substring))
                if len(vt_buf) >= ED_BATCH:
                    out.write("\n".join(vt_buf) + "\n")
                    vt_buf.clear()
                if in_mem is not None:
                    in_mem.append((hit.idx, arr))
                    mem_blocks += len(arr)
                    if mem_blocks > MEM_BLOCK_BUDGET:
                        in_mem = None
            _flush_hits(pend, hit_files)
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
        f"hits {t_hits - t_loaded:.3f}, edges {t_end - t_hits:.3f}), engine {engine} "
        f"on {device}",
        file=sys.stderr,
    )


def run(opts: dict, arguments: List[str]) -> int:
    if len(arguments) != 1:
        print("usage: overlap [OPTION] ... READSFILE", file=sys.stderr)
        return 256
    input_path = arguments[0]
    prefix = opts.get("prefix") or fastx.stem(input_path)
    output = prefix + ASQG_EXT + GZIP_EXT
    min_overlap = int(opts.get("min-overlap", 10))
    shards = int(opts.get("threads", 1))
    search = dict(
        device=opts.get("device", "cuda"),
        irreducible=not opts.get("exhaustive"),
        rc=not opts.get("no-opposite-strand"),
        engine=str(opts.get("engine", "auto")),
    )
    if opts.get("merge-only"):
        _merge_hits(input_path, prefix, output, min_overlap, shards)
    elif opts.get("process-id") is not None:
        multihost.init_distributed()
        try:
            write_hits_shard(
                input_path, prefix, min_overlap,
                process_id=int(opts["process-id"]),
                num_processes=int(opts.get("num-processes", 1)),
                **search,
            )
        finally:
            multihost.shutdown()
    else:
        build_overlaps(input_path, prefix, output, min_overlap, shards=shards, **search)
    return 0
