"""The index build past one card: the route of `index -a sais2` over a device
list (`sa.bwt_perm_route`), K8's ranks as unsigned 32-bit words up to 2**32
- 1, K8's own memory check, and the benchmark's four-card entry with its
blocked plain reference, all on the CPU through the plain versions.

K8 on [cpu] * D stands in for the cards; a one-device fit check that refuses
stands in for a text that one card cannot hold; `slot_base` starts the
global slots near 2**31 or ends them at 2**32 - 1, so that the plain
numbering, round keys, bounds and merges see ranks past the int32 range.
Every compared value is an integer: equality is exact.
"""
import os

import numpy as np
import pytest
import torch

from portbench import generate, harness
from portbench.entries import index4
from portbench.reference import suffix_order, suffix_order_blocks
from portbench.tests.conftest import SMALL_READS
from siga_tpu_torch import cli
from siga_tpu_torch.index import sa
from siga_tpu_torch.parallel import dist_build

from test_torch_dist_build import CASES
from test_torch_index import GOLDEN, GOLDEN_SEQS

U32 = 2**32


@pytest.mark.parametrize("case", sorted(CASES))
def test_blocked_reference_is_the_reference(case):
    codes = torch.from_numpy(sa.concat_reads(CASES[case]())[0])
    for cap in (None, 64, 2):
        got = suffix_order_blocks.index_arrays(codes, cap)
        want = suffix_order.index_arrays(codes, cap)
        for g, w in zip(got, want, strict=True):
            assert torch.equal(g, w), (case, cap)


def test_blocked_reference_in_chunks(monkeypatch):
    """Chunks of 100 positions: buckets and sentinels gathered across them."""
    monkeypatch.setattr(suffix_order_blocks, "CHUNK", 100)
    codes = torch.from_numpy(generate.text(generate.reads(SMALL_READS, 5)))
    for g, w in zip(suffix_order_blocks.index_arrays(codes), suffix_order.index_arrays(codes),
                    strict=True):
        assert torch.equal(g, w)


@pytest.mark.parametrize("D", [2, 4, 8])
def test_route_over_cpus_through_the_command_writes_golden(tmp_path, monkeypatch, D):
    """`index --device` over [cpu] * D where one device cannot take the text:
    K8 builds both directions and the files are the golden index's bytes."""
    monkeypatch.setattr(sa, "index_devices", lambda name: [torch.device("cpu")] * D)
    monkeypatch.setattr(sa, "fits_one_device", lambda n, device: False)
    builds = dist_build.build_stats["builds"]
    fa = tmp_path / "fixed.fa"
    fa.write_text("".join(f">s{i}\n{s}\n" for i, s in enumerate(GOLDEN_SEQS)))
    assert cli.main(["index", "--device", "cpu", "-p", str(tmp_path / "fixed"), str(fa)]) == 0
    assert dist_build.build_stats["builds"] == builds + 2
    for name in ("fixed.sai", "fixed.bwt", "fixed.rsai", "fixed.rbwt"):
        with open(tmp_path / name, "rb") as a, open(os.path.join(GOLDEN, name), "rb") as b:
            assert a.read() == b.read(), name


def test_route_picks_k6_where_one_device_takes_the_text(monkeypatch):
    """One device, or a first device with room: K6 (`bwt_perm_device`) on the
    first; else K8 over the most entries that are a power of two."""
    calls = []
    monkeypatch.setattr(sa, "bwt_perm_device", lambda codes, dev: calls.append(("k6", dev)))
    monkeypatch.setattr(dist_build, "distributed_bwt_perm",
                        lambda codes, devs: calls.append(("k8", len(devs))))
    codes = sa.concat_reads(GOLDEN_SEQS)[0]
    sa.bwt_perm_route(codes, ["cpu"] * 3)
    sa.bwt_perm_route(codes, "cpu")
    monkeypatch.setattr(sa, "fits_one_device", lambda n, device: False)
    sa.bwt_perm_route(codes, ["cpu"])
    sa.bwt_perm_route(codes, ["cpu"] * 3)
    sa.bwt_perm_route(codes, ["cpu"] * 4)
    assert calls == [("k6", "cpu"), ("k6", "cpu"), ("k6", "cpu"), ("k8", 2), ("k8", 4)]


def test_the_one_device_check_keeps_k6s_rule():
    assert not sa.fits_one_device(2**31, "cpu") and sa.fits_one_device(2**31 - 1, "cpu")
    with pytest.raises(ValueError, match="the device sort takes below 2\\*\\*31"):
        sa._check_fits(2**31, torch.device("cpu"))
    assert sa.SORT_BYTES_PER_CHAR == 96


@pytest.mark.parametrize("emit_bwt", [True, False])
@pytest.mark.parametrize("D", [2, 4])
@pytest.mark.parametrize("case", ["150 bp, two rounds", "60 copies of one read",
                                  "prefixes and one-symbol reads"])
def test_ranks_past_2_31_keep_the_order(case, D, emit_bwt):
    """Slots from 2**31 + 5, and slots ending at 2**32 - 1: the plain
    numbering stores the ranks as int32 words, the round keys, bounds and
    merges read them unsigned, and the outputs are those from slot 0."""
    codes = sa.concat_reads(CASES[case]())[0]
    want, _stats = dist_build.run_distributed(codes, ["cpu"] * D, emit_bwt)
    s_len = dist_build.segment_length(codes.size, D)
    for base in (2**31 + 5, U32 - D * s_len):
        record = {}
        got, stats = dist_build.run_distributed(codes, ["cpu"] * D, emit_bwt, record, base)
        assert stats["rounds"] >= 1
        for g, w in zip(got, want, strict=True):
            assert torch.equal(g, w), base
        # the numbering's first call writes words past 2**31 - 1
        _name, (cols, prev, off, tabs, seg) = record["dist_number"]
        assert off == base
        tabs = [t.clone() for t in tabs]
        dist_build.number_runs_plain(cols, prev, off, tabs, seg)
        pos = cols[dist_build.POS]
        words = torch.cat([tab[pos[pos // seg == k] - k * seg] for k, tab in enumerate(tabs)])
        assert int((words.to(torch.int64) & (U32 - 1)).min()) >= base


def test_slot_base_past_2_32_is_refused():
    codes = sa.concat_reads(GOLDEN_SEQS)[0]
    with pytest.raises(ValueError, match="pass 2\\*\\*32"):
        dist_build.run_distributed(codes, ["cpu"] * 2, True, None, U32 - 255)


def test_round_keys_read_ranks_unsigned():
    """pack64(rank[p], rank[p + h] + 1) with the int32 words read as
    unsigned: a word of all ones ahead gives 0, as the kernel's wrap does."""
    words = np.array([0, 2**31 - 1, 2**31, U32 - 2, U32 - 1, 7], dtype=np.int64)
    rank = torch.from_numpy(np.where(words >= 2**31, words - U32, words).astype(np.int32))
    upos = torch.arange(5, dtype=torch.int32)
    got = sa.round_keys_plain(upos, rank, 1, 6).numpy()
    ahead = (words[1:] + 1) % U32
    want = (words[:5] - 2**31) * U32 + ahead
    np.testing.assert_array_equal(got, want)
    assert list(np.argsort(got, kind="stable")) == list(np.lexsort((ahead, words[:5])))


def test_k8_bound_refuses_what_does_not_fit():
    """K8's own check: MAX_CHARS, and DIST_BYTES_PER_CHAR a character of the
    segments each card holds; the CPU's memory is not checked."""
    s_len = dist_build.segment_length(2_532_231_600, 4)
    assert s_len == 633_057_920
    need = dist_build.DIST_BYTES_PER_CHAR * s_len
    cards = [torch.device("cuda", k) for k in range(4)]
    dist_build.check_fits(2_532_231_600, cards, s_len, free=lambda d: (need, 80 * 2**30))
    with pytest.raises(RuntimeError, match="needs about"):
        dist_build.check_fits(2_532_231_600, cards, s_len, free=lambda d: (need - 1, 80 * 2**30))
    with pytest.raises(RuntimeError, match=f"{2 * need} bytes on cuda:0"):
        dist_build.check_fits(2_532_231_600, cards[:1] * 2 + cards[1:3], s_len,
                              free=lambda d: (need, 80 * 2**30))
    dist_build.check_fits(dist_build.MAX_CHARS, [torch.device("cpu")] * 4, 2**30)
    with pytest.raises(ValueError, match="at most 4294967294"):
        dist_build.check_fits(U32 - 1, [torch.device("cpu")] * 4, 2**30)
    assert dist_build.segment_length(dist_build.MAX_CHARS, 4) * 4 <= U32


@pytest.mark.parametrize("skew, fits", [(None, True), (1.5, False), (1.05, True)])
def test_exchange_room_follows_the_bucket_sizes(monkeypatch, skew, fits):
    """`check_room` at an exchange of four cards whose segments of S rows
    each took DIST_BYTES_PER_CHAR at `check_fits`, 26 B a row allocated
    since: balanced buckets fit, as does a bucket of 1.05 S; one of 1.5 S
    (the text's skew, which regular sampling allows up to about 2 S)
    refuses before any piece moves."""
    s_len = 633_057_920
    cards = [torch.device("cuda", k) for k in range(4)]
    room = dist_build.DIST_BYTES_PER_CHAR * s_len
    monkeypatch.setattr(dist_build, "_allocated", lambda dev: 0)
    rooms = dist_build.check_fits(4 * s_len, cards, s_len, free=lambda d: (room, 80 * 2**30))
    assert rooms == {dev: (room, 0) for dev in cards}
    monkeypatch.setattr(dist_build, "_allocated", lambda dev: 26 * s_len)
    sizes = [[s_len // 4] * 4 for _ in cards]
    if skew is not None:  # bucket 0 takes more of every segment, bucket 3 less
        more = int(s_len * (skew - 1)) // 4
        sizes = [[s_len // 4 + more, s_len // 4, s_len // 4, s_len // 4 - more] for _ in cards]
    assert all(sum(row) == s_len for row in sizes)
    if fits:
        dist_build.check_room(cards, sizes, 25, rooms)
    else:
        with pytest.raises(RuntimeError, match="an exchange brings .* to cuda:0"):
            dist_build.check_room(cards, sizes, 25, rooms)


def test_build_refuses_at_the_exchange_without_room(monkeypatch):
    """A card whose room is gone by the exchange: the build raises there."""
    cpu = torch.device("cpu")
    monkeypatch.setattr(dist_build, "check_fits", lambda n, devices, s_len: {cpu: (1000, 0)})
    monkeypatch.setattr(dist_build, "_allocated", lambda dev: 0)
    codes = sa.concat_reads(CASES["150 bp, two rounds"]())[0]
    with pytest.raises(RuntimeError, match="an exchange brings"):
        dist_build.run_distributed(codes, [cpu] * 4, True)


@pytest.mark.parametrize("D", [2, 4])
def test_record_holds_k6_steps_and_host_copies_check(D):
    """A K8 build records K6's seed keys, gathers and round keys beside its
    own steps; `chip_smoke.HostRecord` keeps the copies in host memory, and
    `check_held_steps` puts them back and holds each step to its plain
    version."""
    import chip_smoke

    codes = sa.concat_reads(CASES["150 bp, two rounds"]())[0]
    want, _ = dist_build.run_distributed(codes, ["cpu"] * D, True)
    record = chip_smoke.HostRecord()
    got, _ = dist_build.run_distributed(codes, ["cpu"] * D, True, record)
    assert all(torch.equal(g, w) for g, w in zip(got, want, strict=True))
    assert set(record) == {"sa_seed_keys", "sa_gather, key_b", "sa_gather, key_a",
                           "dist_levels, seed", "dist_bounds", "dist_merge", "dist_number",
                           "sa_round_keys", "dist_levels, payload"}
    assert isinstance(record["dist_number"][1][3][0], chip_smoke.Held)
    errs = chip_smoke.check_held_steps(record, "150 bp reads")
    assert errs == {label: (name, 0) for label, (name, _args) in record.items()}


def test_entry_reads_are_the_generators():
    cfg = dict(SMALL_READS)
    want = generate.reads(cfg, 2**33 + 3)
    got = torch.cat(list(index4.read_chunks(cfg, 2**33 + 3, "cpu", chunk=7))).numpy()
    np.testing.assert_array_equal(got, want)
    fwd, rev = index4.texts(cfg, 2**33 + 3, "cpu")
    np.testing.assert_array_equal(fwd, generate.text(want))
    np.testing.assert_array_equal(rev, generate.text(want, reverse=True))


def test_entry_over_cpus_is_correct_and_counts(monkeypatch):
    """The four-card entry over [cpu] * 4 through K8: its check against the
    blocked reference reads 0, its control does not, its counters count the
    window's builds."""
    monkeypatch.setattr(sa, "index_devices", lambda name: [torch.device("cpu")] * 4)
    monkeypatch.setattr(sa, "fits_one_device", lambda n, device: False)
    bench = harness.load_benchmark()
    cell = index4.Cell(SMALL_READS, harness.traffic("index4"), 2**31 + 17, torch.device("cpu"), 1.0)
    cell.devices = [torch.device("cpu")] * 4
    out = cell.unit()
    cell.keep(0, out)
    counts = cell.counters()
    assert counts["builds"] == 2 and counts["host_waits"] >= 0
    cell.release()
    compared, failed = cell.check()
    assert failed == 0 and all(v == 0 for _n, v, _l in compared)
    assert dict((n, v) for n, v, _l in cell.control())["bwt_off"] > 0
    assert "celegans-n2.index4" in [w["name"] for w in bench["workloads"]]
