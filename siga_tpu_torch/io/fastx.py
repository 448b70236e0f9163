"""FASTA/FASTQ sequences and readers/writers.

Byte-compatible with the reference reader/writer semantics
(reference src/kseq.cpp): format sniffed from the first byte (`@` FASTQ,
`>` FASTA), strict 4-line FASTQ with `+[name]` separator validation, multi-line
FASTA accumulation, and the exact output layout of `operator<<(DNASeq)`
(FASTA when no quality, 4-line FASTQ with a bare `+` otherwise).  Transparent
.gz/.bz2 streams chosen by filename extension (src/utils.cpp:97-126).
"""
from __future__ import annotations

import bz2
import gzip
import io
import os
from dataclasses import dataclass, field
from typing import IO, Iterable, Iterator, List, Optional, Tuple

from ..constants import BZIP_EXT, GZIP_EXT
from ..core import dna


def xopen(path: str, mode: str = "rt") -> IO:
    """Open a file with transparent gzip/bzip2 (by extension).  Writes use
    zlib level 1: deflate speed dominates the pipeline-stage wall for big
    ASQG/hits outputs, and the (content-level) format contract is unaffected
    by the container's compression level."""
    if path.endswith(GZIP_EXT):
        if "w" in mode or "a" in mode:
            return gzip.open(path, mode, compresslevel=1)
        return gzip.open(path, mode)
    if path.endswith(BZIP_EXT):
        return bz2.open(path, mode)
    return open(path, mode)


def stem(path: str) -> str:
    """Strip .gz/.bz2 then one extension (reference Utils::stem)."""
    if path.endswith(GZIP_EXT):
        return stem(path[: -len(GZIP_EXT)])
    if path.endswith(BZIP_EXT):
        return stem(path[: -len(BZIP_EXT)])
    base = os.path.basename(path)
    root, _ext = os.path.splitext(base)
    return root


def split_name(raw: str) -> Tuple[str, str]:
    """Split a header at the first space/tab into (name, comment)."""
    for i, ch in enumerate(raw):
        if ch in " \t":
            return raw[:i], raw[i + 1 :]
    return raw, ""


@dataclass
class DNASeq:
    name: str = ""
    seq: str = ""
    quality: str = ""
    comment: str = ""

    @classmethod
    def make(cls, header: str, seq: str, quality: str = "") -> "DNASeq":
        name, comment = split_name(header)
        return cls(name=name, seq=seq, quality=quality, comment=comment)

    def score(self, i: int) -> int:
        if self.quality:
            return ord(self.quality[i]) - 33
        return 15  # Quality::Phred::DEFAULT_SCORE

    def make_reverse(self) -> None:
        self.seq = self.seq[::-1]
        if self.quality:
            self.quality = self.quality[::-1]

    def make_complement(self) -> None:
        self.seq = dna.complement(self.seq)

    def make_reverse_complement(self) -> None:
        self.make_complement()
        self.make_reverse()

    def format(self) -> str:
        """Exact output layout of the reference operator<<(DNASeq)."""
        header = self.name if not self.comment else f"{self.name} {self.comment}"
        if not self.quality:
            return f">{header}\n{self.seq}\n"
        return f"@{header}\n{self.seq}\n+\n{self.quality}\n"


class FASTQReader:
    def __init__(self, stream: IO):
        self._stream = stream

    def __iter__(self) -> Iterator[DNASeq]:
        return self

    def __next__(self) -> DNASeq:
        rec = self.read()
        if rec is None:
            raise StopIteration
        return rec

    def read(self) -> Optional[DNASeq]:
        K_NAME, K_SEQ, K_NAME2, K_QUAL = range(4)
        state = K_NAME
        name = seq = ""
        for line in self._stream:
            buf = line.strip()
            if not buf:
                continue
            if state == K_NAME:
                if not buf.startswith("@"):
                    return None
                name = buf[1:]
                state = K_SEQ
            elif state == K_SEQ:
                seq = buf
                state = K_NAME2
            elif state == K_NAME2:
                if buf.startswith("+") and (len(buf) == 1 or buf.endswith(name)):
                    state = K_QUAL
                else:
                    return None
            elif state == K_QUAL:
                if len(buf) != len(seq):
                    return None
                rec = DNASeq()
                rec.name, rec.comment = split_name(name)
                rec.seq = seq
                rec.quality = buf
                return rec
        return None


class FASTAReader:
    def __init__(self, stream: IO):
        self._stream = stream
        self._name: Optional[str] = None

    def __iter__(self) -> Iterator[DNASeq]:
        return self

    def __next__(self) -> DNASeq:
        rec = self.read()
        if rec is None:
            raise StopIteration
        return rec

    def read(self) -> Optional[DNASeq]:
        seq_parts: List[str] = []
        for line in self._stream:
            buf = line.strip()
            if not buf:
                continue
            if buf.startswith(">"):
                if seq_parts and self._name is not None:
                    rec = DNASeq()
                    rec.name, rec.comment = split_name(self._name)
                    rec.seq = "".join(seq_parts)
                    self._name = buf[1:]
                    return rec
                if self._name is not None:
                    return None  # two headers with no sequence between
                self._name = buf[1:]
            else:
                seq_parts.append(buf)
        if seq_parts and self._name is not None:
            rec = DNASeq()
            rec.name, rec.comment = split_name(self._name)
            rec.seq = "".join(seq_parts)
            self._name = None
            return rec
        return None


def make_reader(stream: IO):
    """Sniff the format from the first byte (reference DNASeqReaderFactory)."""
    pos = stream.tell()
    first = stream.read(1)
    stream.seek(pos)
    if first == "@":
        return FASTQReader(stream)
    if first == ">":
        return FASTAReader(stream)
    return None


def open_reader(path: str):
    stream = xopen(path, "rt")
    reader = make_reader(stream)
    if reader is None:
        stream.close()
        raise ValueError(f"cannot determine sequence format of {path}")
    return reader


def _fast_fastq_bulk(text: str, with_quality: bool, with_comment: bool):
    """Bulk 4-line FASTQ parse; returns None when the file needs the strict
    state machine (blank lines, multi-line records, '+name' mismatches)."""
    lines = text.split("\n")
    while lines and not lines[-1]:
        lines.pop()
    if len(lines) % 4 != 0:
        return None
    out = []
    for i in range(0, len(lines), 4):
        h, seq, sep, qual = lines[i : i + 4]
        if not h.startswith("@") or not sep.startswith("+") or len(qual) != len(seq):
            return None
        if sep != "+" and not sep.endswith(h[1:].split(" ")[0].split("\t")[0]):
            return None
        rec = DNASeq()
        if with_comment:
            rec.name, rec.comment = split_name(h[1:])
        else:
            rec.name = split_name(h[1:])[0]
        rec.seq = seq
        if with_quality:
            rec.quality = qual
        out.append(rec)
    return out


def _fast_fasta_bulk(text: str, with_comment: bool):
    """Bulk 2-line FASTA parse; None when the file needs the general reader
    (multi-line sequences, CR line ends, padded lines)."""
    if "\r" in text[:4096]:
        return None
    lines = text.split("\n")
    while lines and not lines[-1]:
        lines.pop()
    if len(lines) % 2 != 0:
        return None
    out = []
    for i in range(0, len(lines), 2):
        h, seq = lines[i], lines[i + 1]
        if (
            not h.startswith(">")
            or not seq
            or seq.startswith(">")
            or seq[-1].isspace()
            or h[-1].isspace()
        ):
            return None
        rec = DNASeq()
        if with_comment:
            rec.name, rec.comment = split_name(h[1:])
        else:
            rec.name = split_name(h[1:])[0]
        rec.seq = seq
        out.append(rec)
    return out


def read_sequences_strided(
    path: str, offset: int, stride: int
) -> Tuple[List[DNASeq], List[int]]:
    """Parse only records offset, offset+stride, ... of a FASTA/FASTQ file.

    The multi-host worker path (BASELINE config 5): each process materializes
    just its residue class instead of every record.  Returns (records,
    global_indices).  Falls back to full parse + slice when the fast bulk
    layout does not hold."""
    with xopen(path, "rt") as stream:
        first = stream.read(1)
        stream.seek(0)
        text = stream.read()
    lines = text.split("\n")
    while lines and not lines[-1]:
        lines.pop()
    per = 4 if first == "@" else 2
    # Validate EVERY record boundary before taking the fast path: a
    # line-count-preserving misalignment (e.g. wrapped sequences) could
    # otherwise make workers silently disagree on global record indices.
    # O(lines) and trivial next to parsing cost.
    hdr = "@" if per == 4 else ">"
    ok = (
        "\r" not in text[:4096]
        and len(lines) % per == 0
        and all(lines[i].startswith(hdr) for i in range(0, len(lines), per))
    )
    if ok:
        out: List[DNASeq] = []
        gidx: List[int] = []
        n_rec = len(lines) // per
        for r in range(offset, n_rec, stride):
            h = lines[r * per]
            seq = lines[r * per + 1]
            if not h.startswith("@" if per == 4 else ">") or seq.startswith(
                (">", "@")
            ):
                ok = False
                break
            rec = DNASeq()
            rec.name, rec.comment = split_name(h[1:])
            rec.seq = seq
            if per == 4:
                rec.quality = lines[r * per + 3]
            out.append(rec)
            gidx.append(r)
        if ok:
            return out, gidx
    records = read_sequences(path)
    return records[offset::stride], list(range(offset, len(records), stride))


def read_sequences(
    path_or_stream,
    with_quality: bool = True,
    with_comment: bool = True,
) -> List[DNASeq]:
    """Bulk loader (reference ReadDNASequences, src/kseq.cpp:230-257)."""
    if isinstance(path_or_stream, str):
        stream = xopen(path_or_stream, "rt")
    else:
        stream = path_or_stream
    pos = stream.tell()
    first = stream.read(1)
    stream.seek(pos)
    if first in ("@", ">"):
        # fast path: read everything, split on record boundaries
        text = stream.read()
        if first == "@":
            out = _fast_fastq_bulk(text, with_quality, with_comment)
        else:
            out = _fast_fasta_bulk(text, with_comment)
        if out is not None:
            return out
        import io as _io

        stream = _io.StringIO(text)
    reader = make_reader(stream)
    if reader is None:
        raise ValueError("cannot determine sequence format")
    out = []
    for rec in reader:
        if not with_quality:
            rec.quality = ""
        if not with_comment:
            rec.comment = ""
        out.append(rec)
    return out


def iter_sequences(path: str) -> Iterator[DNASeq]:
    """Streaming record iterator (constant memory; the bulk loader's
    counterpart for passes that never need the whole read set at once)."""
    reader = open_reader(path)
    try:
        yield from reader
    finally:
        reader._stream.close()


def write_sequences(path_or_stream, records: Iterable[DNASeq]) -> None:
    if isinstance(path_or_stream, str):
        with xopen(path_or_stream, "wt") as out:
            for rec in records:
                out.write(rec.format())
    else:
        for rec in records:
            path_or_stream.write(rec.format())


def pairend_id(name: str) -> str:
    """Flip a /1<->/2, /A<->/B, /f<->/r pair suffix (src/reads.cpp:19-41)."""
    assert name
    last = name[-1]
    flip = {"A": "B", "B": "A", "1": "2", "2": "1", "f": "r", "r": "f"}
    if last in flip:
        return name[:-1] + flip[last]
    return ""
