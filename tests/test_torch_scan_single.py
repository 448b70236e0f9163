"""The single-step stage-A scan (K3's plain version) and its plane against
the JAX package.

Same inputs through `siga_tpu.ops.fm_device` (the XLA single-step scan
`_scan_packed_core` on the CPU, `DualScanner(pair_step=False)`) and the
port's `fm_device.scan_single_plain` (the plain PyTorch version the CUDA kernel
`csrc/scan_single.cu` is held to bit for bit on the card by
`chip_smoke.py`).  Every compared value is an integer: equality is exact.
"""
import gzip
import os

import numpy as np
import pytest
import torch

from siga_tpu import cli as jax_cli
from siga_tpu.index import sa as jax_sa
from siga_tpu.index.fm import FMIndex
from siga_tpu.ops import fm_device as jfm
from siga_tpu_torch import cli as port_cli
from siga_tpu_torch import kernels
from siga_tpu_torch.ops import fm_device as tfm

from chip_smoke import SPLIT_SLAB_BYTES, plane_edge_reads, scan_edge_cases
from test_pair_scan import _reads

EDGE_READS = plane_edge_reads()
SCAN_EDGES = {case[0]: case[1:] for case in scan_edge_cases()}


def _indexes(reads):
    fwd, _p, rev, _rp, ns = jax_sa.build_index_arrays_pair(reads, use_device=False)
    return FMIndex(fwd, ns), FMIndex(rev, ns)


@pytest.fixture(scope="module")
def edge_indexes():
    """{label: (forward FMIndex, reverse FMIndex)}, built lazily."""
    cache = {}

    def get(label):
        if label not in cache:
            cache[label] = _indexes(EDGE_READS[label])
        return cache[label]

    return get


def _mixed_reads(seed=5):
    """Reads of 20-150 bp over one genome, with a duplicate and a contained
    read: the chunk scans to its longest read, the short lanes stop early."""
    rng = np.random.default_rng(seed)
    genome = np.frombuffer(b"ACGT", dtype=np.uint8)[rng.integers(0, 4, 3000)]
    out = []
    for length in rng.integers(20, 151, 90):
        s = int(rng.integers(0, genome.size - length))
        out.append(genome[s : s + length].tobytes().decode())
    return out + [out[0], out[1][3:-3]]


READ_SETS = {"71 bp": _reads, "80 bp (odd lim_t)": lambda: _reads(96, 80, 23), "mixed": _mixed_reads}


@pytest.fixture(scope="module")
def read_sets():
    """{name: (reads, maxlen, JAX DeviceFMs, port DeviceFMs on the CPU)}."""
    cache = {}

    def get(name):
        if name not in cache:
            reads = READ_SETS[name]()
            hosts = _indexes(reads)
            maxlen = -(-max(map(len, reads)) // 16) * 16
            cache[name] = (
                reads, maxlen, tuple(jfm.DeviceFM(h) for h in hosts),
                tuple(tfm.DeviceFM(h, "cpu") for h in hosts),
            )
        return cache[name]

    return get


def _views(scanner, reads, maxlen, mo):
    return scanner.collect(scanner.dispatch(list(reads), len(reads), maxlen, mo))


def _assert_views_equal(a, b):
    for view_a, view_b in zip(a, b, strict=True):
        assert len(view_a) == len(view_b) == 6
        for x, y in zip(view_a, view_b):
            np.testing.assert_array_equal(np.asarray(x), np.asarray(y))


@pytest.mark.parametrize("direction", [0, 1], ids=["forward", "reverse"])
@pytest.mark.parametrize("label", list(EDGE_READS))
def test_plane_matches_jax(edge_indexes, label, direction):
    host = edge_indexes(label)[direction]
    plane = tfm.DeviceFM(host, "cpu").occ_plane
    assert plane.dtype == torch.int32
    assert plane.shape == (host.length // tfm.SAMPLE + 1, tfm.SINGLE_COLS)
    np.testing.assert_array_equal(plane.numpy(), np.asarray(jfm.DeviceFM(host).occ_plane))


@pytest.mark.parametrize("label", list(EDGE_READS))
def test_occ_matches_fm_index(edge_indexes, label):
    """Plain occ in both tables of the stacked plane against
    `FMIndex.occ_all` at every block edge, at i = -1 and at the text's end."""
    hosts = edge_indexes(label)
    n, nblocks = hosts[0].length, hosts[0].length // tfm.SAMPLE + 1
    plane2 = torch.cat([tfm.DeviceFM(h, "cpu").occ_plane for h in hosts])
    edges = np.arange(nblocks)[:, None] * tfm.SAMPLE + np.array([-2, -1, 0, 1, 63, 64])
    i = np.unique(np.clip(np.concatenate([edges.ravel(), [-1, 0, n - 2, n - 1]]), -1, n - 1))
    for d, host in enumerate(hosts):
        got = tfm.occ_single(plane2, nblocks, torch.from_numpy(i),
                             torch.full((i.size,), d * nblocks, dtype=torch.int64))
        np.testing.assert_array_equal(got.T.numpy(), host.occ_all(i))
    assert not tfm.occ_single(plane2, nblocks, torch.tensor([-1]), torch.tensor([0])).any()


@pytest.mark.parametrize(
    "name, mo, groups",
    [
        ("71 bp", 20, "rc"), ("71 bp", 31, "rc"), ("71 bp", 70, "rc"),
        ("71 bp", 81, "rc"), ("71 bp", 31, "no rc"), ("71 bp", 81, "rmdup"),
        ("80 bp (odd lim_t)", 20, "rc"), ("80 bp (odd lim_t)", 70, "no rc"),
        ("mixed", 25, "rc"), ("mixed", 200, "rc"), ("mixed", 151, "rmdup"),
    ],
)
def test_views_match_jax_and_pair_scan(read_sets, name, mo, groups):
    """The single-step views equal the JAX single-step scan's and the port's
    pair scan's, for the overlap groups with and without reverse
    complements, the rmdup groups, -m above every read, and mixed lengths."""
    reads, maxlen, jax_fms, torch_fms = read_sets(name)
    kw = {
        "rc": {},
        "no rc": dict(fwd_groups=(jfm.GROUP_ID,), rev_groups=(jfm.GROUP_REV,)),
        "rmdup": dict(fwd_groups=(jfm.GROUP_ID,), rev_groups=(jfm.GROUP_COMP,)),
    }[groups]
    single = _views(tfm.DualScanner(*torch_fms, pair_step=False, **kw), reads, maxlen, mo)
    _assert_views_equal(
        _views(jfm.DualScanner(*jax_fms, pair_step=False, **kw), reads, maxlen, mo), single
    )
    _assert_views_equal(
        _views(tfm.DualScanner(*torch_fms, pair_step=True, **kw), reads, maxlen, mo), single
    )


@pytest.fixture
def one_thread():
    """One intra-op thread for the plain scans of a case: the suite's workers
    share the host's cores, and the parallel regions of many small tensor
    operations would wait on each other's threads."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.mark.parametrize("case", list(SCAN_EDGES))
def test_edge_cases_match_jax(edge_indexes, one_thread, case):
    """K3's edge cases (`chip_smoke.scan_edge_cases`, where the card holds
    the kernels to these plain versions): the plain single-step views equal
    the JAX single-step scan's (`_scan_packed_core`) on the same index,
    reads, lane bucket, groups and -m.  The case with a slab budget (the
    2,049-lane case again, for the card) must split over several launches."""
    index, reads, n, (fwd, rev), mo, slab = SCAN_EDGES[case]
    maxlen = -(-max(map(len, reads)) // 16) * 16
    if slab is not None:
        lim_t = min(maxlen - 1, max(map(len, reads)) - 1)
        parts = tfm.lane_parts(n * (len(fwd) + len(rev)), tfm.emit_cap(lim_t, mo), slab)
        assert slab == SPLIT_SLAB_BYTES and len(parts) > 1
        return
    hosts = edge_indexes(index)
    want = jfm.DualScanner(*(jfm.DeviceFM(h) for h in hosts), fwd_groups=fwd, rev_groups=rev,
                           pair_step=False)
    got = tfm.DualScanner(*(tfm.DeviceFM(h, "cpu") for h in hosts), fwd, rev, pair_step=False)
    _assert_views_equal(want.collect(want.dispatch(reads, n, maxlen, mo)),
                        got.collect(got.dispatch(reads, n, maxlen, mo)))


def test_env_selects_the_route(read_sets, monkeypatch):
    """SIGA_PAIR_STEP=0 selects the single-step plane and scan, as in the
    JAX package; unset or anything else the pair route."""
    _reads_, _maxlen, _jax_fms, torch_fms = read_sets("71 bp")
    for value, pair in (("0", False), ("1", True), ("", True), (None, True)):
        if value is None:
            monkeypatch.delenv("SIGA_PAIR_STEP", raising=False)
        else:
            monkeypatch.setenv("SIGA_PAIR_STEP", value)
        sc = tfm.DualScanner(*torch_fms)
        assert sc.pair is pair and tfm.pair_step_default() is pair
        assert sc.plane.shape[1] == (tfm.PAIR_COLS if pair else tfm.SINGLE_COLS)


@pytest.mark.parametrize("pair", [True, False], ids=["pairs", "single step"])
def test_a_route_builds_only_its_plane(read_sets, monkeypatch, pair):
    """Each plane is built at its first use, as in the JAX package: a scan
    on the pair route packs no single-step plane, one on the single-step
    route builds no pair plane (no K2 launch on the card)."""
    reads, maxlen, _jax_fms, _torch_fms = read_sets("71 bp")
    built = []
    build_pair, pack_single = tfm.build_pair_plane, tfm.single_step_plane_host
    monkeypatch.setattr(tfm, "build_pair_plane", lambda *a: built.append("pair") or build_pair(*a))
    monkeypatch.setattr(tfm, "single_step_plane_host",
                        lambda *a: built.append("single") or pack_single(*a))
    fms = [tfm.DeviceFM(h, "cpu") for h in _indexes(reads)]
    assert built == []
    _views(tfm.DualScanner(*fms, pair_step=pair), reads, maxlen, 31)
    assert built == ["pair" if pair else "single"] * 2
    other = fms[0].occ_plane if pair else fms[0].plane
    assert other.shape[1] == (tfm.SINGLE_COLS if pair else tfm.PAIR_COLS)
    assert built[-1] == ("single" if pair else "pair")


def test_from_jax_state_takes_the_plane(read_sets):
    reads, maxlen, jax_fms, torch_fms = read_sets("71 bp")
    adopted = []
    for jd in jax_fms:
        plane, K = jd.pair_plane_device()
        a = tfm.DeviceFM.from_jax_state(
            np.asarray(plane), np.asarray(K), jd._host_pred, jd.length, jd.nblocks, "cpu",
            occ_plane=np.asarray(jd.occ_plane),
        )
        adopted.append(a)
    for a, td in zip(adopted, torch_fms):
        assert torch.equal(a.occ_plane, td.occ_plane)
    _assert_views_equal(
        _views(tfm.DualScanner(*adopted, pair_step=False), reads, maxlen, 31),
        _views(tfm.DualScanner(*torch_fms, pair_step=False), reads, maxlen, 31),
    )
    bare = tfm.DeviceFM.from_jax_state(
        np.asarray(plane), np.asarray(K), jd._host_pred, jd.length, jd.nblocks, "cpu")
    with pytest.raises(ValueError, match="no single-step plane"):
        bare.occ_plane
    with pytest.raises(ValueError, match="occ_plane shape"):
        tfm.DeviceFM.from_jax_state(np.asarray(plane), np.asarray(K), jd._host_pred, jd.length,
                                    jd.nblocks, "cpu", occ_plane=np.zeros((1, 16), np.int32))


def _scan_args(read_sets, mo=31):
    reads, maxlen, _jax_fms, torch_fms = read_sets("71 bp")
    sc = tfm.DualScanner(*torch_fms, pair_step=False)
    la_w, lens = tfm.pack_reads_2bit(reads, len(reads), maxlen)
    lim_t = min(maxlen - 1, int(lens.max()) - 1)
    return (sc.plane, sc.pred, sc.length, sc.nblocks, torch.from_numpy(la_w),
            torch.from_numpy(lens), lim_t, mo, sc.fwd_groups, sc.rev_groups)


def test_cpu_route_is_the_plain_version(read_sets, monkeypatch):
    """On CPU tensors the wrapper returns the plain version's outputs, counts
    no launch and never loads the kernels; trel counts from p1."""
    args = _scan_args(read_sets)

    def no_lib():
        raise AssertionError("the CPU route loaded the kernels")

    monkeypatch.setattr(kernels, "lib", no_lib)
    before = dict(kernels.launches)
    got = tfm.scan_single(*args)
    assert kernels.launches == before
    want = tfm.scan_single_plain(*args)
    for x, y in zip(got, want, strict=True):
        assert x.dtype == torch.int32 and torch.equal(x, y)
    counts, lane_counts, _data3T, trel = got[:4]
    assert int(counts[0]) == int(lane_counts.sum()) == trel.numel() > 0
    assert int(trel.min()) == 0 and int(trel.max()) < args[6] - (args[7] - 1)


def test_wrapper_refuses_other_devices():
    meta = torch.empty((2, 16), dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        tfm.scan_single(meta, meta, 1, 1, meta, meta, 1, 1, (0,), (2,))


def test_kernel_is_registered():
    sig = kernels._SIGNATURES["siga_scan_single"]
    assert len(sig) == 24 and sig[:3] == [kernels._P, kernels._I, kernels._I]
    assert sig[3:6] == [kernels._P] * 3 and sig[6:18] == [kernels._I] * 12
    assert "scan_single" in kernels.launches
    assert os.path.exists(os.path.join(kernels.CSRC, "scan_single.cu"))


@pytest.mark.parametrize("route", ["0", "1"], ids=["single step", "pairs"])
def test_overlap_writes_jax_bytes(tmp_path, monkeypatch, route):
    """`overlap` with SIGA_PAIR_STEP=0 (the port's plain single-step scan on
    the CPU) writes the JAX package's `.asqg.gz` content, as the default
    pair route does."""
    rng = np.random.default_rng(17)
    genome = "".join("ACGT"[c] for c in rng.integers(0, 4, 2000))
    comp = str.maketrans("ACGT", "TGCA")
    reads = []
    for k in range(70):
        s = int(rng.integers(0, 2000 - 100))
        read = genome[s : s + int(rng.integers(60, 101))]
        reads.append(read if k % 3 else read[::-1].translate(comp))
    reads += [reads[0], reads[1][5:50]]
    (tmp_path / "reads.fa").write_text("".join(f">r{i}\n{s}\n" for i, s in enumerate(reads)))
    monkeypatch.chdir(tmp_path)
    assert port_cli.main(["index", "--device", "cpu", "-p", "reads", "reads.fa"]) == 0
    monkeypatch.delenv("SIGA_PAIR_STEP", raising=False)
    assert jax_cli.main(["overlap", "-m", "30", "-p", "reads", "reads.fa"]) == 0
    with gzip.open(tmp_path / "reads.asqg.gz") as f:
        want = f.read()
    os.remove(tmp_path / "reads.asqg.gz")
    monkeypatch.setenv("SIGA_PAIR_STEP", route)
    before = dict(kernels.launches)
    assert port_cli.main(["overlap", "--device", "cpu", "-m", "30", "-p", "reads", "reads.fa"]) == 0
    assert kernels.launches == before  # the CPU runs the plain versions
    with gzip.open(tmp_path / "reads.asqg.gz") as f:
        assert f.read() == want
