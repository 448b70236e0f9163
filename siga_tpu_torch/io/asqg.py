"""ASQG assembly/sequence graph records.

Byte-compatible with the reference (reference src/asqg.cpp): `HT`/`VT`/
`ED` tab-separated records with SAM-style KEY:TYPE:VAL tags; the tag emission
order matches the reference writers (header: VN ER OL IN CN TE; vertex: SS CR
BX EX; edge: CG PI).  Floats format with %g to match std::ostream's default
6-significant-digit precision.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import List, Optional

from ..core.coord import Overlap

FIELD_SEP = "\t"
TAG_SEP = ":"

HEAD_TAG = "HT"
VERTEX_TAG = "VT"
EDGE_TAG = "ED"

VERSION_TAG = "VN"
OVERLAP_TAG = "OL"
INFILE_TAG = "IN"
ERRRATE_TAG = "ER"
CONTAINMENT_TAG = "CN"
TRANSITIVE_TAG = "TE"

SUBSTRING_TAG = "SS"
BARCODE_TAG = "BX"
COVERAGE_TAG = "CR"
EXTENSION_TAG = "EX"

CIGAR_TAG = "CG"
PERCENT_IDENTITY_TAG = "PI"

HEADER_VERSION = 1


def int_tag(key: str, v: int) -> str:
    return f"{key}:i:{v}"


def float_tag(key: str, v: float) -> str:
    return f"{key}:f:{v:g}"


def str_tag(key: str, v: str) -> str:
    return f"{key}:Z:{v}"


def parse_tag(text: str):
    """KEY:TYPE:VAL -> (key, value) with python typing; None on malformed."""
    parts = text.split(TAG_SEP, 2)
    if len(parts) != 3 or len(parts[1]) != 1:
        return None
    key, tc, raw = parts
    if tc == "i":
        return key, int(raw)
    if tc == "f":
        return key, float(raw)
    if tc in ("Z", "A"):
        return key, raw
    return None


@dataclass
class HeaderRecord:
    version: int = HEADER_VERSION
    error_rate: Optional[float] = None
    infile: Optional[str] = None
    overlap: Optional[int] = None
    containment: Optional[int] = None
    transitive: Optional[int] = None

    def format(self) -> str:
        fields = [int_tag(VERSION_TAG, self.version)]
        if self.error_rate is not None:
            fields.append(float_tag(ERRRATE_TAG, self.error_rate))
        if self.overlap is not None:
            fields.append(int_tag(OVERLAP_TAG, self.overlap))
        if self.infile is not None:
            fields.append(str_tag(INFILE_TAG, self.infile))
        if self.containment is not None:
            fields.append(int_tag(CONTAINMENT_TAG, self.containment))
        if self.transitive is not None:
            fields.append(int_tag(TRANSITIVE_TAG, self.transitive))
        return FIELD_SEP.join([HEAD_TAG] + fields)

    @classmethod
    def parse(cls, text: str) -> "HeaderRecord":
        fields = text.split(FIELD_SEP)
        assert fields[0] == HEAD_TAG
        rec = cls()
        for f in fields[1:]:
            kv = parse_tag(f)
            if kv is None:
                continue
            key, val = kv
            if key == VERSION_TAG:
                rec.version = val
            elif key == OVERLAP_TAG:
                rec.overlap = val
            elif key == INFILE_TAG:
                rec.infile = val
            elif key == ERRRATE_TAG:
                rec.error_rate = val
            elif key == CONTAINMENT_TAG:
                rec.containment = val
            elif key == TRANSITIVE_TAG:
                rec.transitive = val
        return rec


@dataclass
class VertexRecord:
    id: str = ""
    seq: str = ""
    substring: Optional[int] = None
    coverage: Optional[int] = None
    barcode: Optional[str] = None
    ext: Optional[str] = None

    def format(self) -> str:
        out = [VERTEX_TAG, self.id, self.seq]
        if self.substring is not None:
            out.append(int_tag(SUBSTRING_TAG, self.substring))
        if self.coverage is not None:
            out.append(int_tag(COVERAGE_TAG, self.coverage))
        if self.barcode is not None:
            out.append(str_tag(BARCODE_TAG, self.barcode))
        if self.ext is not None:
            out.append(str_tag(EXTENSION_TAG, self.ext))
        return FIELD_SEP.join(out)

    @classmethod
    def parse(cls, text: str) -> "VertexRecord":
        fields = text.split(FIELD_SEP)
        assert fields[0] == VERTEX_TAG and len(fields) >= 3
        rec = cls(id=fields[1], seq=fields[2])
        for f in fields[3:]:
            kv = parse_tag(f)
            if kv is None:
                continue
            key, val = kv
            if key == SUBSTRING_TAG:
                rec.substring = val
            elif key == COVERAGE_TAG:
                rec.coverage = val
            elif key == BARCODE_TAG:
                rec.barcode = val
            elif key == EXTENSION_TAG:
                rec.ext = val
        return rec


@dataclass
class EdgeRecord:
    overlap: Overlap = field(default_factory=Overlap)
    cigar: Optional[str] = None
    identity: Optional[float] = None

    def format(self) -> str:
        out = [EDGE_TAG, str(self.overlap)]
        if self.cigar is not None:
            out.append(str_tag(CIGAR_TAG, self.cigar))
        if self.identity is not None:
            out.append(float_tag(PERCENT_IDENTITY_TAG, self.identity))
        return FIELD_SEP.join(out)

    @classmethod
    def parse(cls, text: str) -> "EdgeRecord":
        fields = text.split(FIELD_SEP)
        assert fields[0] == EDGE_TAG and len(fields) >= 2
        rec = cls(overlap=Overlap.parse(fields[1]))
        for f in fields[2:]:
            kv = parse_tag(f)
            if kv is None:
                continue
            key, val = kv
            if key == CIGAR_TAG:
                rec.cigar = val
            elif key == PERCENT_IDENTITY_TAG:
                rec.identity = val
        return rec


def record_type(line: str) -> str:
    if line.startswith(HEAD_TAG):
        return "header"
    if line.startswith(VERTEX_TAG):
        return "vertex"
    if line.startswith(EDGE_TAG):
        return "edge"
    return "none"
