"""The steps of the port's distributed index build (`siga_tpu_torch/parallel/
dist_build.py`, K8) against numpy references, on the CPU: each wrapper runs
its plain version there (the kernels of `csrc/dist_sort.cu` run on a card
only, where `chip_smoke.py` holds them to these versions bit for bit).

Every input comes from a numpy seed; every compared value is an integer, so
equality is exact.
"""
import numpy as np
import pytest
import torch

from siga_tpu_torch.index import sa as torch_sa
from siga_tpu_torch.parallel import dist_build as tdb

K1, K2, SP, POS, PAY = tdb.K1, tdb.K2, tdb.SP, tdb.POS, tdb.PAY


def _t(x, dtype=torch.int64):
    return torch.from_numpy(np.ascontiguousarray(x)).to(dtype)


def _rows(rng, m, seed_levels: bool, values: int):
    """m rows sorted by their keys (key_a, key_b, sentpos, or one key), ties
    in position order: (keys as numpy columns, positions)."""
    k1 = rng.integers(0, values, m) - values // 2  # below and above 0: signed keys
    cols = [k1]
    if seed_levels:
        cols += [rng.integers(0, values, m), rng.choice([10, 64, 64, 64, 65], m)]
    pos = rng.permutation(m)
    order = np.lexsort([pos] + cols[::-1])
    return [c[order] for c in cols], pos[order]


def _cols(keys, pos, pay=None, seed_levels=True):
    k2 = _t(keys[1]) if seed_levels else None
    sp = _t(keys[2], torch.uint8) if seed_levels else None
    return [_t(keys[0]), k2, sp, _t(pos), None if pay is None else _t(pay)]


@pytest.mark.parametrize("seed_levels", [True, False])
@pytest.mark.parametrize("where", ["on rows", "between rows", "outside"])
def test_bucket_bounds(seed_levels, where):
    """The rows at or below each splitter, by (keys, position + base), with
    splitters equal to rows, between rows and outside every row."""
    rng = np.random.default_rng(7 + seed_levels)
    keys, pos = _rows(rng, 500, seed_levels, 6)
    base = 1000
    rows = list(zip(*keys, pos + base))
    if where == "on rows":
        split = [rows[i] for i in (0, 17, 250, 251, 499)]
    elif where == "between rows":
        split = [(*r[:-1], r[-1] - 1) if i % 2 else (*r[:-1], r[-1] + 1)
                 for i, r in enumerate(rows[3:500:97])]
    else:
        lo, hi = (-10**6,) * len(rows[0]), (10**6,) * len(rows[0])
        split = [lo, lo, hi]
    want = [sum(r <= s for r in rows) for s in split]
    scols = [np.array(c) for c in zip(*split)]
    split_t = [_t(scols[0]), _t(scols[1]) if seed_levels else None,
               _t(scols[2], torch.uint8) if seed_levels else None, _t(scols[-1])]
    got = tdb.bucket_bounds(_cols(keys, pos, seed_levels=seed_levels)[:4], base, split_t)
    assert got.dtype == torch.int64 and got.tolist() == want


def _pieces(rng, sizes, seed_levels, values):
    """Sorted pieces of the given sizes, their positions in disjoint ranges
    (source s from s * 10,000), each with a payload."""
    out = []
    for s, m in enumerate(sizes):
        keys, pos = _rows(rng, m, seed_levels, values)
        out.append((keys, pos, rng.integers(0, 2**40, m), s * 10_000))
    return out


@pytest.mark.parametrize("seed_levels", [True, False])
@pytest.mark.parametrize("case", ["D = 1", "D = 2", "D = 4", "D = 8", "empty pieces",
                                  "all rows equal", "ties across pieces"])
def test_merge_tree_is_the_stable_sort(seed_levels, case):
    """A bucket's pieces merged by the tree of two-way merges give the rows
    of a stable sort of the pieces concatenated in source order: ties keep
    their source's order, whatever the piece sizes."""
    rng = np.random.default_rng(len(case) + 3 * seed_levels)
    sizes, values = {
        "D = 1": ([300], 8), "D = 2": ([300, 257], 8), "D = 4": ([100, 3, 250, 64], 8),
        "D = 8": ([50, 61, 7, 1, 90, 33, 128, 40], 8),
        "empty pieces": ([0, 40, 0, 0, 75, 0, 0, 1], 8),
        "all rows equal": ([60, 60, 60, 60], 1), "ties across pieces": ([80, 80], 2),
    }[case]
    pieces = _pieces(rng, sizes, seed_levels, values)
    if case == "all rows equal" and seed_levels:
        for keys, *_ in pieces:
            keys[2][:] = 64
    cat = [np.concatenate([p[0][i] for p in pieces]) for i in range(len(pieces[0][0]))]
    gpos = np.concatenate([p[1] + p[3] for p in pieces])
    pay = np.concatenate([p[2] for p in pieces])
    order = np.lexsort(cat[::-1])  # stable: ties in source order
    runs = [(_cols(k, p, py, seed_levels), base) for k, p, py, base in pieces]
    keep = (K1, K2, SP, POS, PAY) if seed_levels else (K1, POS, PAY)
    got = tdb._merge_bucket(runs, keep, torch.device("cpu"), None)
    if len(pieces) == 1:  # one piece is the bucket itself: local positions, base 0
        np.testing.assert_array_equal(got[POS].numpy(), pieces[0][1])
    else:
        np.testing.assert_array_equal(got[POS].numpy(), gpos[order])
    np.testing.assert_array_equal(got[PAY].numpy(), pay[order])
    for i, col in enumerate(cat):
        np.testing.assert_array_equal(got[i].numpy().astype(np.int64), col[order])


def test_merge_keeps_only_what_is_asked():
    """The last level writes only the kept columns."""
    rng = np.random.default_rng(5)
    pieces = _pieces(rng, [30, 20, 10, 40], True, 4)
    runs = [(_cols(k, p, py), base) for k, p, py, base in pieces]
    got = tdb._merge_bucket(runs, (PAY,), torch.device("cpu"), None)
    assert [c is None for c in got] == [True, True, True, True, False]
    assert got[PAY].numel() == 100


def _ranks_by_definition(rows):
    """The slot of the first row of each row's run: a new run where a row
    differs from the one before it or, with a sentpos, where that is not 64."""
    out = []
    for i, row in enumerate(rows):
        new = i == 0 or row != rows[i - 1] or (len(row) == 3 and row[2] != 64)
        out.append(i if new else out[-1])
    return out


@pytest.mark.parametrize("seed_levels", [True, False])
@pytest.mark.parametrize("sizes", [[12, 0, 0, 28], [0, 5, 30, 5], [40, 0, 0, 0], [1, 1, 1, 37]])
def test_numbering_runs_across_buckets(seed_levels, sizes):
    """A run of equal rows that spans buckets (empty ones among them) keeps
    the slot of its first row; each rank lands at its text position."""
    rng = np.random.default_rng(sum(sizes) + len(sizes[0:1]) + seed_levels)
    if seed_levels:
        keys = [np.repeat([3, 5], 20), np.zeros(40, np.int64), np.where(rng.random(40) < 0.15,
                                                                        20, 64)]
    else:
        keys = [np.repeat([-4, 7, 7, 9], 10)]
    order = np.lexsort(keys[::-1])
    keys = [k[order] for k in keys]
    rows = list(zip(*keys))
    pos = rng.permutation(40)
    cuts = np.cumsum([0, *sizes])
    buckets = [_cols([k[lo:hi] for k in keys], pos[lo:hi], seed_levels=seed_levels)
               for lo, hi in zip(cuts[:-1], cuts[1:])]
    tabs = [torch.full((10,), -1, dtype=torch.int32) for _ in range(4)]
    stats = {"host_syncs": 0, "phases": [{"moved_bytes": 0}]}
    diag = [[sizes[b] if s == b else 0 for b in range(4)] for s in range(4)]
    tdb._number([torch.device("cpu")] * 4, buckets, diag, tabs, 10, stats, None)
    assert stats["host_syncs"] == 0
    np.testing.assert_array_equal(torch.cat(tabs).numpy()[pos], _ranks_by_definition(rows))


@pytest.mark.parametrize("h", [1, 64, 127, 128])
@pytest.mark.parametrize("D", [2, 4])
def test_round_keys_across_segment_edges(D, h):
    """Each segment's round keys from its rank table with the next segment's
    first h ranks behind it (h up to S): pack64(rank[p], rank[p + h] + 1),
    0 past the text's last segment, as over the whole rank array."""
    s_len = 128
    rng = np.random.default_rng(D * 1000 + h)
    rank = rng.integers(0, 2**31 - 1, D * s_len)
    tabs = [torch.empty(s_len + 128, dtype=torch.int32) for _ in range(D)]
    for k, tab in enumerate(tabs):
        tab[:s_len] = _t(rank[k * s_len : (k + 1) * s_len], torch.int32)
    tabs[-1][s_len:] = -1
    tdb._halo(tabs, s_len, h)
    ahead = np.concatenate([rank[h:] + 1, np.zeros(h, np.int64)])
    want = (rank - 2**31) * 2**32 + ahead
    upos = torch.arange(s_len, dtype=torch.int32)
    got = torch.cat([torch_sa.round_keys(upos, tab, h, s_len + h) for tab in tabs])
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("with_order", [True, False])
def test_levels_gathers_and_payload(with_order):
    """A segment's columns in a sort order, and the BWT payload: the code
    before each position, or (rid << 3) where that is '$' (rid the read that
    starts there: the sentinels before it)."""
    rng = np.random.default_rng(11 + with_order)
    m = 400
    codes = rng.choice([0, 1, 2, 3, 4], m, p=[0.1, 0.225, 0.225, 0.225, 0.225]).astype(np.uint8)
    codes[0] = 0  # the code before the segment is '$'
    idx = rng.permutation(m)
    order = rng.permutation(m) if with_order else None
    o = order[idx] if with_order else idx
    key = rng.integers(-2**62, 2**62, m)
    sentpos = rng.integers(0, 66, m).astype(np.uint8)
    sents = np.flatnonzero(codes[1:] == 0).astype(np.int32)  # local '$' positions
    rid_base = 17
    pos, key_g, sp_g, pay = tdb.levels(_t(idx), None if order is None else _t(order), _t(key),
                                       _t(sentpos, torch.uint8), _t(codes, torch.uint8),
                                       _t(sents, torch.int32), rid_base)
    assert (pos is None) == (not with_order)
    if with_order:
        np.testing.assert_array_equal(pos.numpy(), o)
    np.testing.assert_array_equal(key_g.numpy(), key[o])
    np.testing.assert_array_equal(sp_g.numpy(), sentpos[o])
    rid = rid_base + np.searchsorted(sents, o, side="left")
    np.testing.assert_array_equal(pay.numpy(), np.where(codes[o] != 0, codes[o], rid << 3))


@pytest.mark.parametrize("name", sorted(tdb.STEPS))
def test_each_step_has_its_kernel_count(name):
    """Every K8 step is a counted kernel with a plain version beside its
    wrapper."""
    from siga_tpu_torch import kernels

    wrapper, plain = tdb.STEPS[name]
    assert name in kernels.launches and wrapper is not plain
    assert plain.__name__ == wrapper.__name__ + "_plain"


@pytest.mark.parametrize("D", [2, 4, 8])
@pytest.mark.parametrize("label", ["one round (100 bp)", "two rounds, one tied group (40 x 200 A)",
                                   "identical reads", "60 genome reads of 150 bp"])
def test_dist_cards_check_on_the_cpu(label, D):
    """`probes/dist_cards.py`'s check, over [cpu] * D against K6's route on
    the CPU: the build equals it and every recorded step its plain version."""
    from siga_tpu_torch.probes import dist_cards

    codes = torch_sa.concat_reads(dist_cards.texts(60)[label])[0]
    got = dist_cards.check(codes, ["cpu"] * D, torch.device("cpu"))
    assert got["equal"] and got["steps"] and all(got["steps"].values())
    # one wait a global sort: the seed's and each doubling round's
    assert got["host_syncs"] == torch_sa._sa_rounds_v3(torch_sa._max_span(codes)) + 1


def test_dist_cards_lists_and_refusal():
    """Distinct cards at D = 2 and 4, then every card twice; below two cards
    the probe raises."""
    from siga_tpu_torch.probes import dist_cards

    assert dist_cards.device_lists(2) == [["cuda:0", "cuda:1"], ["cuda:0", "cuda:1"] * 2]
    assert dist_cards.device_lists(4)[1:] == [[f"cuda:{k}" for k in range(4)],
                                              [f"cuda:{k}" for k in range(4)] * 2]
    if not torch.cuda.is_available():
        with pytest.raises(SystemExit, match="two cards"):
            dist_cards.main([])
