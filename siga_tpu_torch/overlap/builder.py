"""The overlap engine: FM-index suffix-prefix overlap detection.

Exact host implementation of the reference algorithm
(reference src/overlap_builder.cpp):

* 4 canonical orientations via AlignFlags (query-rev / target-rev /
  query-comp, src/overlap_builder.cpp:29-55);
* `BlockFinder.find` — one backward search over the read, probing
  `updateL('$')` at every position with overlap >= min_overlap to select
  targets whose whole prefix matches (src/overlap_builder.cpp:846-906);
* `submaximal_filter` — resolves overlapping SA intervals keeping the longest
  (src/overlap_builder.cpp:914-1092), including the rare remap path that walks
  the reverse index;
* `irreducible_extract` — lockstep right-extension of block groups; a '$'
  extension on the longest block emits an irreducible overlap, a unique
  extension continues, a branch splits the group
  (src/overlap_builder.cpp:706-836).

The batched TPU path (ops/search.py) accelerates the backward-search scan
(stage A) and the grouped ext() lookups; this module is the semantic anchor
both paths must agree with.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from ..core import dna
from ..core.coord import Overlap, SeqCoord
from ..index.fm import FMIndex, IntervalPair

# AlignFlags bit positions (value layout matches the reference bitset)
QUERYREV_BIT = 0
TARGETREV_BIT = 1
QUERYCOMP_BIT = 2

AF_SUFFIX_PREFIX = 0b000  # qr=0 tr=0 qc=0
AF_SUFFIX_SUFFIX = 0b110  # qr=0 tr=1 qc=1
AF_PREFIX_PREFIX = 0b101  # qr=1 tr=0 qc=1
AF_PREFIX_SUFFIX = 0b011  # qr=1 tr=1 qc=0


def af_test(af: int, bit: int) -> bool:
    return bool((af >> bit) & 1)


def af_str(af: int) -> str:
    """std::bitset<3> text (MSB first: qc tr qr)."""
    return format(af, "03b")


def af_parse(s: str) -> int:
    return int(s, 2)


@dataclass
class OverlapBlock:
    capped: IntervalPair
    raw: IntervalPair
    length: int
    af: int

    def copy(self) -> "OverlapBlock":
        return OverlapBlock(self.capped.copy(), self.raw.copy(), self.length, self.af)

    def right_index(self, fmi: FMIndex, rfmi: FMIndex) -> FMIndex:
        """Index used for right extension of capped[1]
        (reference OverlapBlock::index, src/overlap_builder.cpp:177-179)."""
        return fmi if af_test(self.af, TARGETREV_BIT) else rfmi

    def ext(self, fmi: FMIndex, rfmi: FMIndex) -> np.ndarray:
        count = self.capped.ext_right(self.right_index(fmi, rfmi)).copy()
        if af_test(self.af, QUERYCOMP_BIT):
            count[1], count[4] = count[4], count[1]  # A<->T
            count[2], count[3] = count[3], count[2]  # C<->G
        return count

    def overlap(self, query_name: str, query_len: int, target_name: str, target_len: int) -> Overlap:
        c1 = SeqCoord(query_len - self.length, query_len - 1, query_len)
        c2 = SeqCoord(0, self.length - 1, target_len)
        if af_test(self.af, QUERYREV_BIT):
            c1.flip()
        if af_test(self.af, TARGETREV_BIT):
            c2.flip()
        return Overlap.make(
            query_name, c1, target_name, c2, af_test(self.af, QUERYCOMP_BIT), 0
        )

    def serialize(self) -> str:
        c, r = self.capped, self.raw
        return (
            f"{c.lo} {c.hi} {c.rlo} {c.rhi} "
            f"{r.lo} {r.hi} {r.rlo} {r.rhi} {self.length} {af_str(self.af)}"
        )

    @classmethod
    def deserialize(cls, tokens: List[str], pos: int) -> Tuple["OverlapBlock", int]:
        vals = [int(t) for t in tokens[pos : pos + 9]]
        af = af_parse(tokens[pos + 9])
        return (
            cls(
                IntervalPair(*vals[0:4]),
                IntervalPair(*vals[4:8]),
                vals[8],
                af,
            ),
            pos + 10,
        )


@dataclass
class OverlapResult:
    substring: bool = False
    aborted: bool = False


@dataclass
class Hit:
    idx: int = 0
    substring: bool = False
    blocks: List[OverlapBlock] = field(default_factory=list)

    def serialize(self) -> str:
        parts = [f"{self.idx} {int(self.substring)} {len(self.blocks)} "]
        for b in self.blocks:
            parts.append(b.serialize() + " ")
        return "".join(parts)

    @staticmethod
    def parse_array(line: str):
        """Fast parse -> (idx, substring, (n, 10) int64 array); af decoded
        from its binary text form."""
        tokens = line.split()
        idx = int(tokens[0])
        substring = bool(int(tokens[1]))
        n = int(tokens[2])
        arr = np.empty((n, 10), dtype=np.int64)
        p = 3
        for i in range(n):
            row = tokens[p : p + 10]
            for j in range(9):
                arr[i, j] = int(row[j])
            arr[i, 9] = int(row[9], 2)
            p += 10
        return idx, substring, arr

    @classmethod
    def deserialize(cls, line: str) -> "Hit":
        tokens = line.split()
        hit = cls(idx=int(tokens[0]), substring=bool(int(tokens[1])))
        count = int(tokens[2])
        pos = 3
        for _ in range(count):
            block, pos = OverlapBlock.deserialize(tokens, pos)
            hit.blocks.append(block)
        return hit


class BlockFinder:
    """Backward-search block finder over one (index, rindex) orientation."""

    def __init__(self, fmi: FMIndex, rfmi: FMIndex, min_overlap: int):
        self.fmi = fmi
        self.rfmi = rfmi
        self.min_overlap = min_overlap

    def find(
        self,
        seq: str,
        af: int,
        overlaps: Optional[List[OverlapBlock]],
        contains: Optional[List[OverlapBlock]],
        result: OverlapResult,
    ) -> None:
        assert seq
        fmi, rfmi = self.fmi, self.rfmi
        ranks = dna.encode(seq)
        l = len(seq)
        ranges = IntervalPair()
        ranges.init(int(ranks[l - 1]), fmi, rfmi)

        for i in range(l - 1, 0, -1):
            if l - i >= self.min_overlap:
                probe = ranges.copy()
                probe.update_left(0, fmi)  # '$'
                if probe.rhi >= probe.rlo and probe.rhi >= 0:
                    assert probe.rlo > 0 or probe.rhi >= probe.rlo
                    if overlaps is not None:
                        overlaps.append(
                            OverlapBlock(probe, ranges.copy(), l - i, af)
                        )
            ranges.update_left(int(ranks[i - 1]), fmi)

        # containment / substring classification on the full-length interval
        lext = fmi.interval_ext(ranges.lo, ranges.hi)
        rext = rfmi.interval_ext(ranges.rlo, ranges.rhi)
        if lext[1:].sum() > 0 or rext[1:].sum() > 0:
            result.substring = True
        else:
            probe = ranges.copy()
            probe.update_left(0, fmi)
            if probe.valid():
                probe.update_right(0, rfmi)
                assert probe.valid()
                if contains is not None:
                    contains.append(OverlapBlock(probe, ranges.copy(), l, af))


def _intersecting(s1: int, e1: int, s2: int, e2: int) -> bool:
    return not (s1 > e2 or s2 > e1)


class SubMaximalBlockFilter:
    """Remove sub-maximal blocks whose SA intervals overlap
    (src/overlap_builder.cpp:914-1092)."""

    def __init__(self, fmi: FMIndex, rfmi: FMIndex):
        self.fmi = fmi
        self.rfmi = rfmi

    def filter(self, blocks: List[OverlapBlock]) -> None:
        if not blocks:
            return
        blocks.sort(key=lambda b: b.capped.lo)
        prev = 0
        while prev + 1 < len(blocks):
            curr = prev + 1
            x, y = blocks[prev], blocks[curr]
            if _intersecting(x.capped.lo, x.capped.hi, y.capped.lo, y.capped.hi):
                resolved = self._resolve(x, y)
                resolved.sort(key=lambda b: b.capped.lo)
                del blocks[curr]
                del blocks[prev]
                # stable merge keeps sorted order like std::list::merge
                merged: List[OverlapBlock] = []
                i = j = 0
                while i < len(blocks) and j < len(resolved):
                    if resolved[j].capped.lo < blocks[i].capped.lo:
                        merged.append(resolved[j])
                        j += 1
                    else:
                        merged.append(blocks[i])
                        i += 1
                merged.extend(blocks[i:])
                merged.extend(resolved[j:])
                blocks[:] = merged
                prev = 0
            else:
                prev += 1

    def _resolve(self, x: OverlapBlock, y: OverlapBlock) -> List[OverlapBlock]:
        higher, lower = (x, y) if x.length >= y.length else (y, x)
        resolved = [higher]
        if higher.length == lower.length:
            assert (
                higher.capped.lo == lower.capped.lo
                and higher.capped.hi == lower.capped.hi
            ), "overlap blocks with the same length must share coordinates"
            return resolved
        if (
            lower.capped.lo < higher.capped.lo
            or lower.capped.hi > higher.capped.hi
        ):
            # Rare remap path: map each reverse position of the lower block to
            # its forward position by walking the reverse index until '$'.
            usedmapping: Dict[int, int] = {}
            tracing_list = []
            for j in range(lower.capped.rlo, lower.capped.rhi + 1):
                ranges = lower.raw.copy()
                lo = j
                while True:
                    c = self.rfmi.get_char(lo)
                    done = c == 0
                    if done:
                        ranges.update_left(0, self.fmi)
                    nlo, _nhi = self.rfmi.interval_update(c, lo, lo)
                    lo = nlo
                    ranges.update_right(c, self.rfmi)
                    if done:
                        break
                if ranges.lo == ranges.hi:
                    forward = ranges.lo
                else:
                    k = ranges.lo
                    idx = usedmapping.get(k, k)
                    forward = idx
                    usedmapping[k] = idx + 1
                tracing_list.append((forward, j))
            for forward, rev in tracing_list:
                if not _intersecting(
                    forward, forward, higher.capped.lo, higher.capped.hi
                ):
                    split = lower.copy()
                    split.capped.lo = forward
                    split.capped.hi = forward
                    split.capped.rlo = rev
                    split.capped.rhi = rev
                    resolved.append(split)
        return resolved


def remove_containment_blocks(blocks: List[OverlapBlock], seqlen: int) -> None:
    blocks[:] = [b for b in blocks if b.length != seqlen]


class IrreducibleBlockListExtractor:
    """Right-extend block groups in lockstep; emit only irreducible overlaps
    (src/overlap_builder.cpp:706-836)."""

    def __init__(self, fmi: FMIndex, rfmi: FMIndex):
        self.fmi = fmi
        self.rfmi = rfmi

    def extract(
        self, inblocks: List[OverlapBlock], outblocks: List[OverlapBlock]
    ) -> bool:
        """Returns False when a substring read is detected (caller should have
        run rmdup); True otherwise."""
        # stable sort by descending length (std::list::sort is stable)
        inblocks.sort(key=lambda b: -b.length)
        groups: List[List[OverlapBlock]] = [list(inblocks)]
        while groups:
            incomings: List[List[OverlapBlock]] = []
            gi = 0
            while gi < len(groups):
                blocklist = groups[gi]
                erase_group = True
                if blocklist:
                    top_length = blocklist[0].length
                    exts = np.zeros(dna.ALL_SIZE, dtype=np.int64)
                    for b in blocklist:
                        if b.length != top_length:
                            break
                        exts += b.ext(self.fmi, self.rfmi)
                    if exts[0] > 0:
                        # the top-level block has ended: emit terminal blocks
                        for b in blocklist:
                            if b.length != top_length:
                                break
                            test = b.ext(self.fmi, self.rfmi)
                            if test[0] == 0:
                                # substring read found during overlap
                                return False
                            branched = b.copy()
                            branched.capped.update_right(
                                0, branched.right_index(self.fmi, self.rfmi)
                            )
                            outblocks.append(branched)
                    else:
                        for b in blocklist:
                            if b.length < top_length:
                                exts += b.ext(self.fmi, self.rfmi)
                        nonzero = np.flatnonzero(exts > 0)
                        if len(nonzero) == 1:
                            self._update_right(int(nonzero[0]), blocklist)
                            erase_group = False
                        else:
                            for c in nonzero:
                                branched = [b.copy() for b in blocklist]
                                self._update_right(int(c), branched)
                                incomings.append(branched)
                if erase_group:
                    del groups[gi]
                    gi += 1  # reference loop skips the next group after erase
                else:
                    gi += 2  # reference loop double-advances
            groups.extend(incomings)
        return True

    def _update_right(self, c_rank: int, blocks: List[OverlapBlock]) -> None:
        keep = []
        for b in blocks:
            b_rank = (
                int(dna.COMP_RANK[c_rank])
                if af_test(b.af, QUERYCOMP_BIT)
                else c_rank
            )
            b.capped.update_right(b_rank, b.right_index(self.fmi, self.rfmi))
            if b.capped.valid():
                keep.append(b)
        blocks[:] = keep


class OverlapBuilder:
    """Find and output overlaps for sequence reads
    (reference OverlapBuilder, src/overlap_builder.cpp:1113-1195)."""

    def __init__(
        self,
        fmi: FMIndex,
        rfmi: FMIndex,
        prefix: str = "default",
        irreducible: bool = True,
        rc: bool = True,
    ):
        self.fmi = fmi
        self.rfmi = rfmi
        self.prefix = prefix
        self.irreducible = irreducible
        self.rc = rc

    def overlap(
        self, seq: str, min_overlap: int, blocks: List[OverlapBlock]
    ) -> OverlapResult:
        result = OverlapResult()
        finder = BlockFinder(self.fmi, self.rfmi, min_overlap)
        rfinder = BlockFinder(self.rfmi, self.fmi, min_overlap)

        suffixfwd: List[OverlapBlock] = []
        suffixrev: List[OverlapBlock] = []
        prefixfwd: List[OverlapBlock] = []
        prefixrev: List[OverlapBlock] = []
        containfwd: List[OverlapBlock] = []
        containrev: List[OverlapBlock] = []

        finder.find(seq, AF_SUFFIX_PREFIX, suffixfwd, containfwd, result)
        if self.rc:
            finder.find(
                dna.reverse_complement(seq), AF_PREFIX_PREFIX, prefixfwd, containfwd, result
            )
        rfinder.find(dna.reverse(seq), AF_PREFIX_SUFFIX, prefixrev, containrev, result)
        if self.rc:
            rfinder.find(
                dna.complement(seq), AF_SUFFIX_SUFFIX, suffixrev, containrev, result
            )

        return self.finish(
            len(seq),
            result,
            suffixfwd,
            suffixrev,
            prefixfwd,
            prefixrev,
            containfwd,
            containrev,
            blocks,
        )

    def prepare_lists(
        self,
        seqlen: int,
        suffixfwd: List[OverlapBlock],
        suffixrev: List[OverlapBlock],
        prefixfwd: List[OverlapBlock],
        prefixrev: List[OverlapBlock],
        containfwd: List[OverlapBlock],
        containrev: List[OverlapBlock],
        blocks: List[OverlapBlock],
    ) -> Tuple[List[OverlapBlock], List[OverlapBlock]]:
        """Stage B: submaximal filtering + containment removal.  Appends the
        containment blocks to `blocks` and returns the joined
        (suffix, prefix) lists ready for irreducible extraction."""
        suffixfwd.extend(b.copy() for b in containfwd)
        prefixfwd.extend(b.copy() for b in containfwd)
        suffixrev.extend(b.copy() for b in containrev)
        prefixrev.extend(b.copy() for b in containrev)

        ffilter = SubMaximalBlockFilter(self.fmi, self.rfmi)
        ffilter.filter(suffixfwd)
        ffilter.filter(prefixfwd)
        rfilter = SubMaximalBlockFilter(self.rfmi, self.fmi)
        rfilter.filter(suffixrev)
        rfilter.filter(prefixrev)

        remove_containment_blocks(suffixfwd, seqlen)
        remove_containment_blocks(prefixfwd, seqlen)
        remove_containment_blocks(suffixrev, seqlen)
        remove_containment_blocks(prefixrev, seqlen)

        blocks.extend(containfwd)
        blocks.extend(containrev)

        suffixfwd.extend(suffixrev)
        prefixfwd.extend(prefixrev)
        return suffixfwd, prefixfwd

    def finish(
        self,
        seqlen: int,
        result: OverlapResult,
        suffixfwd: List[OverlapBlock],
        suffixrev: List[OverlapBlock],
        prefixfwd: List[OverlapBlock],
        prefixrev: List[OverlapBlock],
        containfwd: List[OverlapBlock],
        containrev: List[OverlapBlock],
        blocks: List[OverlapBlock],
    ) -> OverlapResult:
        """Stages B+C: submaximal filtering, containment removal, irreducible
        extraction.  Shared by the host path and the device stage-A path."""
        suffixfwd.extend(b.copy() for b in containfwd)
        prefixfwd.extend(b.copy() for b in containfwd)
        suffixrev.extend(b.copy() for b in containrev)
        prefixrev.extend(b.copy() for b in containrev)

        ffilter = SubMaximalBlockFilter(self.fmi, self.rfmi)
        ffilter.filter(suffixfwd)
        ffilter.filter(prefixfwd)
        rfilter = SubMaximalBlockFilter(self.rfmi, self.fmi)
        rfilter.filter(suffixrev)
        rfilter.filter(prefixrev)

        remove_containment_blocks(suffixfwd, seqlen)
        remove_containment_blocks(prefixfwd, seqlen)
        remove_containment_blocks(suffixrev, seqlen)
        remove_containment_blocks(prefixrev, seqlen)

        blocks.extend(containfwd)
        blocks.extend(containrev)

        if self.irreducible:
            extractor = IrreducibleBlockListExtractor(self.fmi, self.rfmi)
            suffixfwd.extend(suffixrev)
            result.aborted |= not extractor.extract(suffixfwd, blocks)
            prefixfwd.extend(prefixrev)
            result.aborted |= not extractor.extract(prefixfwd, blocks)
        else:
            blocks.extend(suffixfwd)
            blocks.extend(suffixrev)
            blocks.extend(prefixfwd)
            blocks.extend(prefixrev)

        return result

    def duplicate(self, seq: str, blocks: List[OverlapBlock]) -> OverlapResult:
        """rmdup mode: containment-only search with min_overlap = len(seq)
        (src/overlap_builder.cpp:1184-1195)."""
        result = OverlapResult()
        finder = BlockFinder(self.fmi, self.rfmi, len(seq))
        rfinder = BlockFinder(self.rfmi, self.fmi, len(seq))
        finder.find(seq, AF_SUFFIX_PREFIX, None, blocks, result)
        rfinder.find(dna.complement(seq), AF_SUFFIX_SUFFIX, None, blocks, result)
        return result


class HitConverter:
    """Map hit blocks' SA ranges to read names and emit overlaps
    (reference Hit2OverlapConverter, src/overlap_builder.cpp:331-381)."""

    def __init__(
        self,
        sa_perm: np.ndarray,
        rsa_perm: np.ndarray,
        read_names: Sequence[str],
        read_lengths: Sequence[int],
    ):
        self.sa_perm = sa_perm
        self.rsa_perm = rsa_perm
        self.names = read_names
        self.lengths = read_lengths

    def convert(self, hit: Hit) -> Tuple[List[Overlap], int]:
        overlaps: List[Overlap] = []
        num_copies = 0
        qname = self.names[hit.idx]
        qlen = self.lengths[hit.idx]
        for block in hit.blocks:
            assert block.capped.lo <= block.capped.hi
            perm = (
                self.rsa_perm if af_test(block.af, TARGETREV_BIT) else self.sa_perm
            )
            for j in range(block.capped.lo, block.capped.hi + 1):
                num_copies += 1
                tid = int(perm[j])
                tname = self.names[tid]
                if qname == tname:
                    continue
                o = block.overlap(qname, qlen, tname, self.lengths[tid])
                # dedup rule (src/overlap_builder.cpp:359-367)
                if o.id1 < o.id2 or (
                    o.is_containment() and af_test(block.af, QUERYREV_BIT)
                ):
                    continue
                overlaps.append(o)
        return overlaps, num_copies


class BatchHitConverter(HitConverter):
    """Vectorized hits -> ED conversion: explode every block's SA range with
    numpy, map to read ids through the permutations, apply the dedup rule,
    then format the surviving records."""

    def __init__(self, sa_perm, rsa_perm, read_names, read_lengths):
        super().__init__(sa_perm, rsa_perm, read_names, read_lengths)
        self._names_arr = np.array(read_names, dtype=object)
        self._lens_arr = np.asarray(read_lengths, dtype=np.int64)

    def convert_lines(self, hits) -> List[str]:
        """hits: iterable of Hit objects or (idx, (n,10) array) pairs."""
        qidx, lo, hi, af, length = [], [], [], [], []
        for hit in hits:
            if isinstance(hit, tuple):
                hidx, rows = hit
            else:
                hidx = hit.idx
                arr = getattr(hit, "_array", None)
                if arr is not None and getattr(hit, "_blocks", None) is None:
                    rows = arr
                else:
                    rows = np.array(
                        [
                            [
                                b.capped.lo,
                                b.capped.hi,
                                b.capped.rlo,
                                b.capped.rhi,
                                b.raw.lo,
                                b.raw.hi,
                                b.raw.rlo,
                                b.raw.rhi,
                                b.length,
                                b.af,
                            ]
                            for b in hit.blocks
                        ],
                        dtype=np.int64,
                    ).reshape(-1, 10)
            if len(rows):
                qidx.append(np.full(len(rows), hidx, dtype=np.int64))
                lo.append(rows[:, 0])
                hi.append(rows[:, 1])
                length.append(rows[:, 8])
                af.append(rows[:, 9])
        if not qidx:
            return []
        qidx = np.concatenate(qidx)
        lo = np.concatenate(lo).astype(np.int64)
        hi = np.concatenate(hi).astype(np.int64)
        length = np.concatenate(length).astype(np.int64)
        af = np.concatenate(af).astype(np.int64)

        width = hi - lo + 1
        total = int(width.sum())
        if total == 0:
            return []
        rep = np.repeat(np.arange(len(lo)), width)
        offs = np.arange(total) - np.repeat(np.cumsum(width) - width, width)
        j = lo[rep] + offs
        q = qidx[rep]
        a = af[rep]
        olen = length[rep]

        tr = (a >> TARGETREV_BIT) & 1
        tid = np.where(tr == 1, self.rsa_perm[j], self.sa_perm[j])
        qname = self._names_arr[q]
        tname = self._names_arr[tid]
        keep = qname != tname

        qr = ((a >> QUERYREV_BIT) & 1).astype(bool)
        qlen = self._lens_arr[q]
        tlen = self._lens_arr[tid]
        contained = (olen == qlen) | (olen == tlen)
        # dedup rule (src/overlap_builder.cpp:359-367): skip id1 < id2 or
        # (containment and query-reversed)
        keep &= ~(np.less(qname, tname) | (contained & qr))

        idx = np.flatnonzero(keep)
        # fully vectorized coordinate math; only the final text assembly is
        # a Python loop over plain lists (scalar numpy indexing per field
        # was ~4x slower)
        o = olen[idx]
        ql = qlen[idx]
        tl = tlen[idx]
        afk = a[idx]
        qrm = (afk >> QUERYREV_BIT) & 1 == 1
        s1 = np.where(qrm, 0, ql - o)
        e1 = np.where(qrm, o - 1, ql - 1)
        trm = (afk >> TARGETREV_BIT) & 1 == 1
        s2 = np.where(trm, tl - o, 0)
        e2 = np.where(trm, tl - 1, o - 1)
        rc = (afk >> QUERYCOMP_BIT) & 1
        return [
            f"ED\t{qn} {tn} {a1} {b1} {c1} {a2} {b2} {c2} {r} 0"
            for qn, tn, a1, b1, c1, a2, b2, c2, r in zip(
                qname[idx].tolist(), tname[idx].tolist(),
                s1.tolist(), e1.tolist(), ql.tolist(),
                s2.tolist(), e2.tolist(), tl.tolist(), rc.tolist(),
            )
        ]
