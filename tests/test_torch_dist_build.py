"""The port's distributed index build (`siga_tpu_torch/parallel/dist_build.py`)
against the JAX package's mesh build and the host builders.

The same rank texts, from numpy seeds through `tests/test_dist_build.py`'s
read generator, go through JAX's `distributed_sa` / `distributed_bwt_perm`
on the 8-device CPU mesh of `tests/conftest.py`, through
`siga_tpu.index.sa.suffix_array_numpy` with `bwt_from_sa` and
`sai_perm_from_sa`, and through the port over `[cpu] * D`.  Every compared
value is an integer: equality is exact.
"""
import os

import numpy as np
import pytest
import torch

import jax
from jax.sharding import Mesh

from siga_tpu.index import sa as jax_sa
from siga_tpu.index.fm import FMIndex
from siga_tpu.ops import fm_device as jfm
from siga_tpu.parallel import dist_build as jdb
from siga_tpu_torch import dryrun
from siga_tpu_torch.io.bwtio import load_bwt
from siga_tpu_torch.io.sai import load_sai
from siga_tpu_torch.ops import fm_device as tfm
from siga_tpu_torch.parallel import dist_build as tdb

from test_dist_build import _reads
from test_torch_index import GOLDEN_SEQS


def _with_extras(seqs, extras):
    return seqs + [f(seqs) for f in extras]


CASES = {
    # tests/test_dist_build.py:37-73
    "100 bp, one round": lambda: _reads(400, 100, 8000, 1),
    "150 bp, two rounds": lambda: _reads(200, 150, 6000, 2),
    "73 bp, repeats and a duplicate": lambda: _with_extras(
        _reads(150, 73, 4000, 3), [lambda s: "ACGT" * 30, lambda s: "A" * 80, lambda s: s[0]]),
    "100 bp, a duplicate and a contained read": lambda: _with_extras(
        _reads(400, 100, 8000, 4), [lambda s: s[0], lambda s: s[1][5:45]]),
    "150 bp, a duplicate and a contained read": lambda: _with_extras(
        _reads(200, 150, 6000, 5), [lambda s: s[0], lambda s: s[1][5:45]]),
    "40 bp, the seed alone": lambda: _reads(300, 40, 3000, 6),
    # segments of 25 characters at D = 8, shorter than the 80-symbol seed halo
    "the dry run's 8 x 24 bp": dryrun.tiny_reads,
    "60 copies of one read": lambda: _reads(1, 90, 500, 8) * 60,
    "200 bp, h = 128": lambda: _reads(60, 200, 3000, 9),
    # a read that is a prefix of another, and reads of one symbol
    "prefixes and one-symbol reads": lambda: _with_extras(
        _reads(20, 90, 800, 11), [lambda s: s[0][:40], lambda s: s[0] + "ACGT",
                                  lambda s: "A" * 70, lambda s: "A" * 33, lambda s: "T" * 70]),
}


@pytest.fixture(scope="module")
def mesh():
    return Mesh(np.array(jax.devices()), ("data",))


@pytest.fixture(scope="module")
def texts(mesh):
    """{case: (codes, starts, JAX's mesh SA, JAX's mesh (bwt, perm), the
    numpy SA)}, built lazily."""
    cache = {}

    def get(case):
        if case not in cache:
            codes, starts, _ = jax_sa.concat_reads(CASES[case]())
            cache[case] = (codes, starts, jdb.distributed_sa(codes, mesh),
                           jdb.distributed_bwt_perm(codes, mesh),
                           jax_sa.suffix_array_numpy(codes))
        return cache[case]

    return get


def test_rounds_of_the_cases():
    """The cases cover the seed alone, one and two doubling rounds, and
    segments shorter than the seed halo."""
    rounds = {case: jax_sa._sa_rounds_v3(jax_sa._max_span(jax_sa.concat_reads(f())[0]))
              for case, f in CASES.items()}
    assert rounds["40 bp, the seed alone"] == 0 and rounds["100 bp, one round"] == 1
    assert rounds["150 bp, two rounds"] == rounds["200 bp, h = 128"] == 2
    n = jax_sa.concat_reads(dryrun.tiny_reads())[0].size
    assert -(-n // 8) < tdb.SEED_HALO


@pytest.mark.parametrize("D", [1, 2, 4, 8])
@pytest.mark.parametrize("case", list(CASES))
def test_sa_matches_jax_and_host(texts, case, D):
    codes, _starts, jax_sa_mesh, _jbp, want = texts(case)
    got = tdb.distributed_sa(codes, ["cpu"] * D)
    assert got.dtype == np.int64
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, jax_sa_mesh)


@pytest.mark.parametrize("D", [1, 2, 4, 8])
@pytest.mark.parametrize("case", list(CASES))
def test_bwt_perm_matches_jax_and_host(texts, case, D):
    codes, starts, _jsa, (jbwt, jperm), sa = texts(case)
    bwt, perm = tdb.distributed_bwt_perm(codes, ["cpu"] * D)
    assert bwt.dtype == np.uint8 and perm.dtype == np.int64
    np.testing.assert_array_equal(bwt, jax_sa.bwt_from_sa(codes, sa))
    np.testing.assert_array_equal(perm, jax_sa.sai_perm_from_sa(sa, starts))
    np.testing.assert_array_equal(bwt, jbwt)
    np.testing.assert_array_equal(perm, jperm)


@pytest.mark.parametrize("D", [1, 2, 4, 8])
def test_golden_index(D):
    """The golden index (`tests/golden/fixed.*`, five 10 bp reads) from the
    build over [cpu] * D: the BWT and permutation of both directions."""
    golden = os.path.join(os.path.dirname(os.path.abspath(__file__)), "golden")
    for texts, bwt_name, sai_name in ((GOLDEN_SEQS, "fixed.bwt", "fixed.sai"),
                                      ([s[::-1] for s in GOLDEN_SEQS], "fixed.rbwt", "fixed.rsai")):
        bwt, perm, ns = tdb.distributed_index_arrays(texts, ["cpu"] * D)
        want_bwt, want_ns, _ = load_bwt(os.path.join(golden, bwt_name))
        want_perm, _ = load_sai(os.path.join(golden, sai_name))
        assert ns == want_ns == len(GOLDEN_SEQS)
        np.testing.assert_array_equal(bwt, want_bwt)
        np.testing.assert_array_equal(perm, want_perm)


def test_degenerate_texts_match_jax(mesh):
    for n in (0, 1):
        codes = np.zeros(n, dtype=np.uint8)
        got = tdb.distributed_sa(codes, ["cpu"] * 2)
        assert got.dtype == np.int64
        np.testing.assert_array_equal(got, jdb.distributed_sa(codes, mesh))
    bwt, perm = tdb.distributed_bwt_perm(np.zeros(0, dtype=np.uint8), ["cpu"] * 2)
    jbwt, jperm = jdb.distributed_bwt_perm(np.zeros(0, dtype=np.uint8), mesh)
    assert bwt.dtype == jbwt.dtype and perm.dtype == jperm.dtype
    assert bwt.size == perm.size == jbwt.size == jperm.size == 0


def test_refuses_what_jax_asserts(mesh):
    """Both refuse 3 devices, and reads too long for their segments (a
    256-symbol doubling halo in segments of 128)."""
    codes, _s, _l = jax_sa.concat_reads(_reads(40, 100, 2000, 10))
    with pytest.raises(ValueError, match="3 devices: the distributed build takes a power of two"):
        tdb.distributed_sa(codes, ["cpu"] * 3)
    with pytest.raises(AssertionError, match="power of two"):
        jdb.distributed_sa(codes, Mesh(np.array(jax.devices()[:3]), ("data",)))
    codes, _s, _l = jax_sa.concat_reads(["ACGT" * 75, "ACGG" * 75])
    with pytest.raises(ValueError, match="shorter than the doubling halo of 256"):
        tdb.distributed_bwt_perm(codes, ["cpu"] * 8)
    with pytest.raises(AssertionError, match="segment smaller than halo"):
        jdb.distributed_bwt_perm(codes, mesh)
    np.testing.assert_array_equal(tdb.distributed_sa(codes, ["cpu"] * 2),
                                  jax_sa.suffix_array_numpy(codes))


def test_devices_are_checked():
    """The default is every local card, and without one it raises; a mixed
    list raises; nothing falls back to the CPU."""
    codes, _s, _l = jax_sa.concat_reads(["ACGT"])
    if not torch.cuda.is_available():
        for fn in (tdb.distributed_sa, tdb.distributed_bwt_perm):
            with pytest.raises(RuntimeError, match="CUDA is not available"):
                fn(codes)
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            tdb.distributed_index_arrays(["ACGT"])
        with pytest.raises(RuntimeError, match="not available"):
            tdb.distributed_sa(codes, ["cuda:0", "cuda:0"])
    with pytest.raises(ValueError, match="mixes cpu and cuda"):
        tdb.distributed_sa(codes, ["cpu", "cuda:0"])


@pytest.mark.parametrize("D", [2, 4, 8])
def test_no_entry_sorts_more_than_two_segments(monkeypatch, D):
    """Each segment is S = ceil(n / D) characters rounded up to 128, and no
    sort (every pass of every entry's local and bucket sorts, and the
    samples') takes more than 2 S + D rows; each global sort's buckets hold
    every row once."""
    codes, _s, _l = jax_sa.concat_reads(_reads(200, 150, 6000, 2))
    sizes = []
    sort = torch.sort

    def recording(x, *args, **kwargs):
        sizes.append(x.numel())
        return sort(x, *args, **kwargs)

    monkeypatch.setattr(torch, "sort", recording)
    out, stats = tdb.run_distributed(codes, ["cpu"] * D, emit_bwt=False)
    s = stats["segment"]
    assert s == max(-(-(-(-codes.size // D)) // 128) * 128, 128) and s * D >= codes.size
    assert stats["sizes"] == tdb.segment_sizes(codes.size, D) and sum(stats["sizes"]) == codes.size
    assert sizes and max(sizes) <= 2 * s + D
    assert sizes.count(s) >= 3 * D  # the seed's three local passes on every entry
    assert [p["phase"] for p in stats["phases"]] == ["seed", "round 0", "round 1"]
    for p in stats["phases"]:
        assert len(p["buckets"]) == D and sum(p["buckets"]) == s * D
        assert max(p["buckets"]) <= 2 * s and p["moved_bytes"] > 0
    # the sizes of each exchange: a numbering needs no run count (its first
    # slot is known from the sizes, and a run from an earlier bucket takes
    # that bucket's last rank)
    assert stats["host_syncs"] == 3
    np.testing.assert_array_equal(torch.cat(out).numpy(), jax_sa.suffix_array_numpy(codes))


def _head_ranks(rows):
    """Ranks of the rows (tuples ending in sentpos, sorted) by the definition:
    the slot of the first row of its run, a new run where a row differs from
    the one before it or its sentpos is not 64."""
    out = []
    for i, row in enumerate(rows):
        new = i == 0 or row != rows[i - 1] or row[-1] != 64
        out.append(i if new else out[-1])
    return out


@pytest.mark.parametrize("sizes", [[0, 15, 10, 15], [10, 0, 15, 15], [10, 15, 15, 0],
                                   [0, 0, 40, 0]])
def test_number_runs_skips_empty_buckets(sizes):
    """A bucket's first row is compared with the last row of the previous
    non-empty bucket, and a run that starts there keeps its rank, whichever
    buckets are empty; each rank lands in its segment's table at its
    position, and no run count goes to the host."""
    rng = np.random.default_rng(sum(sizes[:2]))
    keys = rng.integers(0, 3, (40, 2))
    sp = np.where(rng.random(40) < 0.2, 10, 64)
    rows = sorted(map(tuple, np.column_stack([keys, sp]).tolist()))
    arr = np.array(rows, dtype=np.int64)
    pos = rng.permutation(40)  # 4 segments of 10
    cuts = np.cumsum([0, *sizes])
    buckets = [[torch.from_numpy(arr[lo:hi, 0].copy()), torch.from_numpy(arr[lo:hi, 1].copy()),
                torch.from_numpy(arr[lo:hi, 2].astype(np.uint8)), torch.from_numpy(pos[lo:hi]),
                None] for lo, hi in zip(cuts[:-1], cuts[1:])]
    tabs = [torch.full((10,), -1, dtype=torch.int32) for _ in range(4)]
    stats = {"host_syncs": 0, "phases": [{"moved_bytes": 0}]}
    diag = [[sizes[b] if s == b else 0 for b in range(4)] for s in range(4)]
    tdb._number([torch.device("cpu")] * 4, buckets, diag, tabs, 10, stats, None)
    assert stats["host_syncs"] == 0
    got = torch.cat(tabs).numpy()[pos]
    assert got.tolist() == _head_ranks(rows)


@pytest.mark.parametrize("pick", [0, -1])
@pytest.mark.parametrize("D", [4, 8])
@pytest.mark.parametrize("case", ["150 bp, two rounds", "60 copies of one read"])
def test_empty_buckets_end_to_end(monkeypatch, texts, case, D, pick):
    """With every splitter set to one of them, the buckets between the first
    and the last are empty in every global sort; the suffix array, BWT and
    permutation stay exact."""
    codes, starts, _jsa, _jbp, want = texts(case)
    splitters = tdb._splitters

    def one_splitter(*args):
        return [None if x is None else x[pick].repeat(x.numel()) for x in splitters(*args)]

    monkeypatch.setattr(tdb, "_splitters", one_splitter)
    _out, stats = tdb.run_distributed(codes, ["cpu"] * D, emit_bwt=False)
    for p in stats["phases"]:
        assert p["buckets"][1:-1] == [0] * (D - 2) and sum(p["buckets"]) == D * stats["segment"]
    np.testing.assert_array_equal(tdb.distributed_sa(codes, ["cpu"] * D), want)
    bwt, perm = tdb.distributed_bwt_perm(codes, ["cpu"] * D)
    np.testing.assert_array_equal(bwt, jax_sa.bwt_from_sa(codes, want))
    np.testing.assert_array_equal(perm, jax_sa.sai_perm_from_sa(want, starts))


@pytest.mark.parametrize("D", [2, 8])
def test_built_index_feeds_sharded_scan(mesh, D):
    """The counterpart of `tests/test_dist_build.py:80`: the forward and
    reverse indexes built over [cpu] * D equal JAX's mesh-built ones and
    feed the index-sharded scan over [cpu] * D, whose views equal the port's
    replicated single-step views and JAX's index-sharded views."""
    seqs = _reads(300, 100, 6000, 7)
    hosts = []
    for texts in (seqs, [s[::-1] for s in seqs]):
        bwt, perm, ns = tdb.distributed_index_arrays(texts, ["cpu"] * D)
        jbwt, jperm, jns = jdb.distributed_index_arrays(texts, mesh)
        np.testing.assert_array_equal(bwt, jbwt)
        np.testing.assert_array_equal(perm, jperm)
        assert ns == jns == len(seqs)
        hosts.append(FMIndex(bwt, ns))
    shard = tfm.DualScanner(*(tfm.DeviceFM(h, "cpu") for h in hosts), devices=["cpu"] * D)
    repl = tfm.DualScanner(*(tfm.DeviceFM(h, "cpu") for h in hosts), pair_step=False)
    jsc = jfm.DualScanner(*(jfm.DeviceFM(h) for h in hosts), mesh, shard_index=True)
    views = [sc.collect(sc.dispatch(list(seqs), 512, 112, 45)) for sc in (shard, repl, jsc)]
    assert sum(len(v[0]) for v in views[0]) > 0
    for other in views[1:]:
        for va, vb in zip(views[0], other, strict=True):
            for x, y in zip(va, vb, strict=True):
                np.testing.assert_array_equal(np.asarray(x), np.asarray(y))
