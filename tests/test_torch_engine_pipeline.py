"""The port's engine with chunks in flight, on the CPU.

`batch_overlap_hits` and `batch_duplicate_hits` keep LOOKAHEAD chunks
dispatched ahead of the one they collect, and stage B/C runs in
SIGA_NATIVE_WORKERS threads (or in the calling thread with
SIGA_NATIVE_PIPELINE=0), as the JAX package's engine does.  With
CHUNK_READS made small in both packages, a run has more chunks than
LOOKAHEAD; its hits must equal the JAX package's byte for byte and in
order, on one device and over `[cpu] * 3`.  The scanner's halves are held
to the plain outputs: a handle's views do not depend on the order of the
collects, budgets that overflow pack again, and the compaction into a
budget over several lane parts gives the plain rows.  Also here: the
`--version` line of both CLIs, and the port's copy of the host aligner
against the JAX package's and against K5's plain best scores.  All values
are integers and text: equality is exact.
"""
import contextlib
import io
import random

import numpy as np
import pytest
import torch

from siga_tpu import cli as jax_cli
from siga_tpu.align.sw import Aligner as JaxAligner
from siga_tpu.index import sa as jax_sa
from siga_tpu.index.fm import FMIndex as JaxFMIndex
from siga_tpu.io.fastx import DNASeq as JaxDNASeq
from siga_tpu.ops import search as jax_search
from siga_tpu.overlap.builder import OverlapBuilder as JaxOverlapBuilder
from siga_tpu_torch import cli as port_cli
from siga_tpu_torch.align.sw import Aligner
from siga_tpu_torch.index.fm import FMIndex
from siga_tpu_torch.io.fastx import DNASeq
from siga_tpu_torch.ops import fm_device as tfm
from siga_tpu_torch.ops import search as tsearch
from siga_tpu_torch.ops.sw import BatchAligner
from siga_tpu_torch.overlap.builder import OverlapBuilder

from test_torch_scan_slab import _slab_from_plain, plain_scans  # noqa: F401 (a fixture)

N_READS = 720
SMALL_CHUNK = 64  # CHUNK_READS in both packages: 12 chunks of at most 64 reads
MIN_OVERLAP = 40
DEVICES = {"cpu": "cpu", "[cpu] x 3": ["cpu"] * 3}


def _genome_reads(seed, n, lengths, genome_len):
    """n reads of the given lengths from both strands of a random genome."""
    rng = np.random.default_rng(seed)
    genome = rng.integers(0, 4, genome_len)
    comp = str.maketrans("ACGT", "TGCA")
    out = []
    for k in range(n):
        length = int(rng.choice(lengths))
        start = int(rng.integers(0, genome_len - length + 1))
        s = "".join("ACGT"[c] for c in genome[start : start + length])
        out.append(s.translate(comp)[::-1] if k % 2 else s)
    return out


@pytest.fixture(scope="module")
def reads():
    return _genome_reads(21, N_READS, (68, 70, 70, 72), 2500)


@pytest.fixture(scope="module")
def contigs():
    """Contigs of mixed lengths: the engine sorts them by length first."""
    return _genome_reads(22, 27, (50, 60, 64, 150, 300, 600), 2000)


def _index(seqs):
    fwd, _p, rev, _rp, ns = jax_sa.build_index_arrays_pair(seqs, use_device=False)
    return fwd, rev, ns


def _port_builder(index, **kw):
    fwd, rev, ns = index
    return OverlapBuilder(FMIndex(fwd, ns), FMIndex(rev, ns), **kw)


def _jax_builder(index, **kw):
    fwd, rev, ns = index
    return JaxOverlapBuilder(JaxFMIndex(fwd, ns), JaxFMIndex(rev, ns), **kw)


def _lines(hits):
    return [h.serialize() for h in hits]


@contextlib.contextmanager
def _small_chunks(chunk_reads):
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(tsearch, "CHUNK_READS", chunk_reads)
        mp.setattr(jax_search, "CHUNK_READS", chunk_reads)
        yield


@pytest.fixture(scope="module")
def jax_hits(reads, contigs):
    """The JAX package's hits (its 8-device CPU mesh) with CHUNK_READS small:
    overlap -m 40 and rmdup on the reads, overlap -m 20 on the contigs."""
    index, ctg_index = _index(reads), _index(contigs)
    records = [JaxDNASeq(name=f"r{i}", seq=s) for i, s in enumerate(reads)]
    ctg_records = [JaxDNASeq(name=f"c{i}", seq=s) for i, s in enumerate(contigs)]
    with _small_chunks(SMALL_CHUNK):
        overlap = _lines(jax_search.batch_overlap_hits(_jax_builder(index), records, MIN_OVERLAP))
        rmdup = _lines(jax_search.batch_duplicate_hits(_jax_builder(index), records))
    with _small_chunks(3):
        ctg = _lines(jax_search.batch_overlap_hits(_jax_builder(ctg_index), ctg_records, 20))
    return {"index": index, "ctg_index": ctg_index, "overlap": overlap, "rmdup": rmdup,
            "contigs": ctg}


def _engine_env(mp, workers):
    if workers == "pipeline off":
        mp.setenv("SIGA_NATIVE_PIPELINE", "0")
    else:
        mp.setenv("SIGA_NATIVE_WORKERS", str(workers))
        mp.delenv("SIGA_NATIVE_PIPELINE", raising=False)


def _chunks_collected(builder):
    return sum(sc.stats["chunks"] for sc in builder._scanners.values())


@pytest.mark.parametrize("device", sorted(DEVICES))
@pytest.mark.parametrize("workers", [1, 2, 3, "pipeline off"])
def test_overlap_hits_with_chunks_in_flight(reads, jax_hits, workers, device):
    """More chunks than LOOKAHEAD, 1-3 B/C workers or none: the JAX
    package's hits, byte for byte and in order."""
    builder = _port_builder(jax_hits["index"])
    records = [DNASeq(name=f"r{i}", seq=s) for i, s in enumerate(reads)]
    with _small_chunks(SMALL_CHUNK), pytest.MonkeyPatch.context() as mp:
        _engine_env(mp, workers)
        n_chunks = -(-N_READS // tsearch.chunk_size(N_READS))
        got = _lines(tsearch.batch_overlap_hits(builder, records, MIN_OVERLAP, DEVICES[device]))
    assert n_chunks > tsearch.LOOKAHEAD == tfm.CHUNKS_IN_FLIGHT
    assert _chunks_collected(builder) == n_chunks * len(tsearch.dist.device_list(DEVICES[device]))
    assert got == jax_hits["overlap"]


@pytest.mark.parametrize("device", sorted(DEVICES))
def test_duplicate_hits_with_chunks_in_flight(reads, jax_hits, device):
    """rmdup's search over more chunks than LOOKAHEAD: the JAX package's hits."""
    builder = _port_builder(jax_hits["index"])
    records = [DNASeq(name=f"r{i}", seq=s) for i, s in enumerate(reads)]
    with _small_chunks(SMALL_CHUNK):
        got = _lines(tsearch.batch_duplicate_hits(builder, records, DEVICES[device]))
    assert got == jax_hits["rmdup"]


@pytest.mark.parametrize("workers", [1, 2, "pipeline off"])
def test_contig_chunks_with_chunks_in_flight(contigs, jax_hits, workers):
    """Mixed lengths run in length-sorted chunks, nine of them, eight in
    flight at a time; the hits come back in input order."""
    builder = _port_builder(jax_hits["ctg_index"])
    records = [DNASeq(name=f"c{i}", seq=s) for i, s in enumerate(contigs)]
    with _small_chunks(3), pytest.MonkeyPatch.context() as mp:
        _engine_env(mp, workers)
        got = _lines(tsearch.batch_overlap_hits(builder, records, 20, "cpu"))
    assert _chunks_collected(builder) == 9
    assert got == jax_hits["contigs"]


def _scanner(index, route):
    fwd, rev, ns = index
    fms = (tfm.DeviceFM(FMIndex(fwd, ns), "cpu"), tfm.DeviceFM(FMIndex(rev, ns), "cpu"))
    if route == "sharded over [cpu] x 3":
        return tfm.DualScanner(*fms, devices=["cpu"] * 3)
    return tfm.DualScanner(*fms, pair_step=route == "pairs")


def _views_equal(a, b):
    for va, vb in zip(a, b, strict=True):
        for x, y in zip(va, vb, strict=True):
            assert x.dtype == y.dtype and np.array_equal(x, y)


ROUTES = ["pairs", "single step", "sharded over [cpu] x 3"]


@pytest.mark.parametrize("route", ROUTES)
def test_handles_collect_in_any_order(reads, jax_hits, route):
    """Handles dispatched together give the same views collected last to
    first as first to last, and as each chunk alone."""
    sc = _scanner(jax_hits["index"], route)
    chunks = [(reads[k * 40 : (k + 1) * 40], 80, mo) for k, mo in enumerate((40, 30, 65, 40))]
    handles = [sc.dispatch(seqs, len(seqs), maxlen, mo) for seqs, maxlen, mo in chunks]
    backwards = [sc.collect(h) for h in reversed(handles)][::-1]
    for (seqs, maxlen, mo), views in zip(chunks, backwards):
        _views_equal(views, sc.collect(sc.dispatch(seqs, len(seqs), maxlen, mo)))
    assert sc.stats["chunks"] == 2 * len(chunks) and sc.stats["overflows"] == 0
    assert sc.stats["host_waits"] == sc.stats["copies"] == 0  # on the CPU nothing is copied


@pytest.mark.parametrize("route", ROUTES)
def test_overflowing_budgets_pack_again(reads, jax_hits, route):
    """Budgets of one row and one candidate overflow at the first chunk,
    grow, and give the views of large ones; later chunks fit."""
    seqs = reads[:80]
    want = _scanner(jax_hits["index"], route)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(tfm, "ROWS_A_LANE", 0)
        mp.setattr(tfm, "ROW_GRANULE", 1)
        mp.setattr(tfm, "CAND_GRANULE", 1)
        mp.setattr(tfm, "CANDS_A_READ", 0)
        sc = _scanner(jax_hits["index"], route)
        for k in range(2):
            _views_equal(sc.collect(sc.dispatch(seqs, len(seqs), 80, MIN_OVERLAP)),
                         want.collect(want.dispatch(seqs, len(seqs), 80, MIN_OVERLAP)))
            assert sc.stats["overflows"] == 1, k


@pytest.mark.parametrize("parts", [1, 2, 3])
@pytest.mark.parametrize("budget", ["exact", "short", "long"])
def test_card_scan_packs_each_part_into_the_budget(plain_scans, parts, budget):  # noqa: F811
    """`CardScan.pack` over slabs of the plain version's rows, in 1-3 lane
    parts, holds the plain rows and candidates in the budget it is given
    (as many as fit) and the true sizes in its header; `outputs()` gives
    the plain outputs.  The launch is replaced by a copy of the slab."""
    rng = np.random.default_rng(10 + parts)
    for (lim_t, mo), res in plain_scans.items():
        cap = tfm.emit_cap(lim_t, mo)
        slab, rows = _slab_from_plain(rng, res, cap)
        counts, lane_counts, _d, _t, candmask, candT, subwords = res
        L = lane_counts.numel()
        cand_lanes = torch.nonzero(tfm._unpack_bits32(candmask, L)).flatten()
        fall = torch.from_numpy(rng.integers(-99, 99, (5, L)).astype(np.int32))
        fall[:, cand_lanes] = candT
        per = -(-L // parts // 32) * 32
        launched = []

        class Card(tfm.CardScan):
            def _launch(self, l0, l1):
                launched.append((l0, l1))
                self.lane_counts[l0:l1] = lane_counts[l0:l1]
                self.fall[:, l0:l1] = fall[:, l0:l1]
                self.candmask.copy_(candmask)
                self.subwords.copy_(subwords)
                return slab[l0:l1].clone()

        card = Card("scan_pair", None, L, cap, "cpu", per * max(cap, 1) * tfm.SLAB_ROW_BYTES)
        n_rows, n_cand = int(counts[0]), int(counts[1])
        n_parts = len(tfm.lane_parts(L, cap, card.slab_bytes))
        assert n_parts == (parts if cap else 1)
        k_rows = {"exact": n_rows, "short": n_rows // 2, "long": n_rows + 77}[budget]
        k_rows = min(k_rows, L * cap)
        k_cands = {"exact": n_cand, "short": n_cand // 3, "long": L}[budget]
        for attempt in range(2):  # the second packs from a held slab or launches again
            buf = card.pack(k_rows, k_cands).numpy()
            sizes, (lc, got, cm, ct, sw) = tfm.unpack_scan(buf, L, k_rows, k_cands)
            assert sizes == (n_rows, int(lane_counts.max()), n_cand)
            assert np.array_equal(lc, lane_counts.numpy()) and np.array_equal(cm, candmask.numpy())
            assert np.array_equal(sw, subwords.numpy())
            assert np.array_equal(got, rows[:k_rows].numpy()), (lim_t, mo, attempt)
            assert np.array_equal(ct, candT[:, :k_cands].numpy()), (lim_t, mo, attempt)
            assert len(launched) == n_parts * (1 if n_parts == 1 else attempt + 1)
        if budget == "exact":
            assert np.array_equal(buf, tfm.PlainScan(res).pack(k_rows, k_cands).numpy())
        out = Card("scan_pair", None, L, cap, "cpu", card.slab_bytes).outputs()
        for x, y in zip(out, res, strict=True):
            assert torch.equal(x, y), (lim_t, mo)


@pytest.mark.parametrize("flag", ["--version", "-v"])
def test_version_line_matches_the_jax_cli(flag):
    """`main([flag])` prints the same line and returns the same code in
    both packages."""
    said = []
    for main in (jax_cli.main, port_cli.main):
        out = io.StringIO()
        with contextlib.redirect_stdout(out):
            rc = main([flag])
        said.append((out.getvalue(), rc))
    assert said[0] == said[1] == ("siga-tpu version 0.1.0\n", 0)


def _aligner_pairs(n=200, seed=5):
    """Seeded (query, ref) pairs: a ref with the query, mutated, somewhere
    inside, and unrelated pairs."""
    rng = random.Random(seed)
    pairs = []
    for k in range(n):
        q = "".join(rng.choice("ACGT") for _ in range(rng.randint(1, 60)))
        if k % 4 == 3:
            r = "".join(rng.choice("ACGT") for _ in range(rng.randint(1, 80)))
        else:
            m = list(q)
            for _ in range(rng.randint(0, 4)):
                i = rng.randrange(len(m) + 1)
                op = rng.choice("sid")
                if op == "s" and i < len(m):
                    m[i] = rng.choice("ACGT")
                elif op == "i":
                    m.insert(i, rng.choice("ACGT"))
                elif i < len(m) and len(m) > 1:
                    del m[i]
            flank = ["".join(rng.choice("ACGT") for _ in range(rng.randint(0, 20))) for _ in "ab"]
            r = flank[0] + "".join(m) + flank[1]
        pairs.append((q, r))
    return pairs


def test_aligner_copy_matches_the_jax_aligner_and_k5_plain():
    """The port's host aligner gives the JAX package's alignment (scores,
    ends, CIGAR) on 200 seeded pairs, and its scores are K5's plain best
    scores."""
    pairs = _aligner_pairs()
    fields = ("sw_score", "sw_score_next_best", "ref_begin", "ref_end", "query_begin",
              "query_end", "ref_end_next_best", "mismatches", "cigar_string", "cigar")
    scores = []
    for q, r in pairs:
        a, b = Aligner(q).align(r), JaxAligner(q).align(r)
        assert [getattr(a, f) for f in fields] == [getattr(b, f) for f in fields], (q, r)
        scores.append(a.sw_score)
    best, _qend, _rend = BatchAligner(device="cpu").scores([q for q, _ in pairs],
                                                          [r for _, r in pairs])
    assert best.tolist() == scores
    assert len(set(scores)) > 20 and min(scores) >= 0
