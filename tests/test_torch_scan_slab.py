"""The one-pass layout of the K1 scan, on the CPU.

K1 writes each lane's emitted [lo, rlo, size, trel] rows into a slab of its
own and may split a chunk's lanes over several launches;
`fm_device.compact_slab` and `fm_device.scan_in_parts` put the rows back in
the order `scan_pair_plain` returns (lane-major, t ascending).  These tests
hold that layout against the plain version's, with slabs built from the
plain version's rows and with random slabs.  All values are integers:
equality is exact.
"""
import numpy as np
import pytest
import torch

from siga_tpu.index import sa as jax_sa
from siga_tpu.index.fm import FMIndex
from siga_tpu_torch.ops import fm_device as tfm

from test_pair_scan import _reads


def _random_slab(rng, lanes, cap):
    counts = rng.integers(0, cap + 1, lanes)
    counts[rng.random(lanes) < 0.3] = 0  # lanes with no emission
    if lanes:
        counts[rng.integers(0, lanes)] = cap  # a lane at the slab bound
    slab = rng.integers(-(2**31), 2**31 - 1, (lanes, cap, 4)).astype(np.int32)
    return torch.from_numpy(slab), torch.from_numpy(counts.astype(np.int32))


def _expected(slab, counts):
    rows = [slab[l, : int(c)] for l, c in enumerate(counts)]
    return torch.cat(rows) if rows else slab.new_zeros((0, 4))


@pytest.mark.parametrize("seed,lanes,cap", [(0, 1, 1), (1, 37, 5), (2, 256, 17), (3, 1000, 3), (4, 64, 0)])
def test_compact_slab_random(seed, lanes, cap):
    slab, counts = _random_slab(np.random.default_rng(seed), lanes, cap)
    got, values = tfm.compact_slab(slab, counts)
    assert values == [] and got.dtype == torch.int32 and got.shape == (int(counts.sum()), 4)
    assert torch.equal(got, _expected(slab, counts))


def test_compact_slab_reads_extra_values():
    slab, counts = _random_slab(np.random.default_rng(7), 50, 4)
    got, values = tfm.compact_slab(slab, counts, (counts.to(torch.int64).sum(), torch.tensor(-3)))
    assert values == [int(counts.sum()), -3] and torch.equal(got, _expected(slab, counts))


def test_owners_finds_each_row_its_run():
    lengths = torch.tensor([0, 3, 0, 1, 2, 0], dtype=torch.int64)
    k, run = tfm._owners(torch.cumsum(lengths, 0), 6)
    assert k.tolist() == list(range(6)) and run.tolist() == [1, 1, 1, 3, 4, 4]


def test_compact_slab_refuses_an_overflowing_lane():
    slab = torch.zeros((3, 2, 4), dtype=torch.int32)
    with pytest.raises(RuntimeError):
        tfm.compact_slab(slab, torch.tensor([0, 3, 1], dtype=torch.int32))


@pytest.mark.parametrize("lanes,cap,budget", [(100, 7, 10**9), (100, 7, 32 * 7 * 16), (1000, 3, 5000),
                                              (33, 0, 1), (31, 4000, 1)])
def test_lane_parts_cover_lanes_in_mask_words(lanes, cap, budget):
    parts = tfm.lane_parts(lanes, cap, budget)
    assert parts[0][0] == 0 and parts[-1][1] == lanes
    for (a0, a1), (b0, _b1) in zip(parts, parts[1:]):
        assert a1 == b0
    for l0, l1 in parts:
        assert l0 % 32 == 0 and l1 > l0
        # a part's slabs fit the budget unless one mask word of lanes does not
        assert (l1 - l0) * cap * tfm.SLAB_ROW_BYTES <= max(budget, 32 * cap * tfm.SLAB_ROW_BYTES)


@pytest.mark.parametrize("lanes,cap", [(1170, 38619), (60608, 105), (33, 0), (2049, 0), (31, 7)])
def test_lane_parts_one_launch_when_the_slabs_fit(lanes, cap):
    """Slabs that fit take one launch, whatever the lane count or cap."""
    need = lanes * cap * tfm.SLAB_ROW_BYTES
    assert tfm.lane_parts(lanes, cap, need) == [(0, lanes)]
    assert tfm.lane_parts(lanes, cap, 10**12) == [(0, lanes)]


@pytest.mark.parametrize("seed", [5, 6])
def test_scan_in_parts_random(seed):
    """A chunk split over several launches gives the rows of one launch."""
    rng = np.random.default_rng(seed)
    slab, counts = _random_slab(rng, 300, 9)
    filled = torch.full_like(counts, -1)
    calls = []

    def launch(l0, l1):  # what K1 does for lanes [l0, l1)
        calls.append((l0, l1))
        filled[l0:l1] = counts[l0:l1]
        return slab[l0:l1].clone()

    got, (n_filled,) = tfm.scan_in_parts(300, 9, 64 * 9 * tfm.SLAB_ROW_BYTES, launch, filled,
                                         lambda: ((filled >= 0).sum(),))
    assert len(calls) == 5 and torch.equal(filled, counts) and n_filled == 300
    assert torch.equal(got, _expected(slab, counts))


@pytest.fixture(scope="module")
def plain_scans():
    """scan_pair_plain at several minimum overlaps, even and odd lim_t."""
    reads = _reads()
    fwd, _p, rev, _rp, ns = jax_sa.build_index_arrays_pair(reads, use_device=False)
    scanner = tfm.DualScanner(tfm.DeviceFM(FMIndex(fwd, ns), "cpu"), tfm.DeviceFM(FMIndex(rev, ns), "cpu"))
    out = {}
    for maxlen, trim in ((80, 0), (80, 1)):
        seqs = [s[: len(s) - trim] for s in reads]
        la_w, lens = tfm.pack_reads_2bit(seqs, len(seqs), maxlen)
        lim_t = min(maxlen - 1, int(lens.max()) - 1)
        for mo in (1, 20, 45, 70, lim_t + 2):
            args = (
                scanner.plane, scanner.K2, scanner.pred, scanner.length, scanner.nblocks,
                torch.from_numpy(la_w), torch.from_numpy(lens), lim_t, mo,
                scanner.fwd_groups, scanner.rev_groups,
            )
            out[(lim_t, mo)] = tfm.scan_pair_plain(*args)
    return out


def _slab_from_plain(rng, res, cap):
    """The slab K1 writes for the plain version's rows: each lane's rows at
    the head of its slab, garbage behind them."""
    _counts, lane_counts, data3T, trel, *_ = res
    rows = torch.cat([data3T.T, trel[:, None]], dim=1)
    lanes = lane_counts.numel()
    slab = torch.from_numpy(rng.integers(-9999, 9999, (lanes, cap, 4)).astype(np.int32))
    start = 0
    for l, c in enumerate(lane_counts.tolist()):
        slab[l, :c] = rows[start : start + c]
        start += c
    return slab, rows


def test_emit_cap_holds_every_lane(plain_scans):
    lims = set()
    for (lim_t, mo), res in plain_scans.items():
        lims.add(lim_t % 2)
        assert int(res[1].max()) <= tfm.emit_cap(lim_t, mo), (lim_t, mo)
        if mo > lim_t:
            assert tfm.emit_cap(lim_t, mo) == 0 and int(res[0][0]) == 0
    assert lims == {0, 1}  # odd lim_t (a phantom half-step) and even


@pytest.mark.parametrize("parts", [1, 2, 3])
def test_scan_in_parts_gives_the_plain_layout(plain_scans, parts):
    """Slabs of the plain version's rows, scanned in 1, 2 and 3 launches,
    compact to exactly the plain version's rows and lane counts."""
    rng = np.random.default_rng(parts)
    for (lim_t, mo), res in plain_scans.items():
        cap = tfm.emit_cap(lim_t, mo)
        slab, rows = _slab_from_plain(rng, res, cap)
        lanes = slab.shape[0]
        per = -(-lanes // parts // 32) * 32
        budget = per * max(cap, 1) * tfm.SLAB_ROW_BYTES
        assert len(tfm.lane_parts(lanes, cap, budget)) == (parts if cap else 1)
        counts = torch.empty_like(res[1])

        def launch(l0, l1):
            counts[l0:l1] = res[1][l0:l1]
            return slab[l0:l1]

        got, values = tfm.scan_in_parts(lanes, cap, budget, launch, counts)
        assert values == []
        assert torch.equal(counts, res[1]) and torch.equal(got, rows), (lim_t, mo)
