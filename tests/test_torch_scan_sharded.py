"""The index-sharded single-step scan against the JAX package and the
replicated scan.

Same inputs through `siga_tpu.ops.fm_device` (`occ_all_fused_sharded_T`,
`DualScanner(dfwd, drev, data_mesh(8), shard_index=True)` on the 8-device
CPU mesh) and the port's plain versions (`occ_single_sharded`,
`DualScanner(..., devices=[cpu] * D)`, which runs
`scan_single_sharded_plain`, the version the CUDA kernel behind
`scan_single_sharded` is held to bit for bit on the card by
`chip_smoke.py`).  Every compared value is an integer: equality is exact.
"""
import contextlib
import os
import random

import numpy as np
import pytest
import torch

from siga_tpu.index import sa as jax_sa
from siga_tpu.index.fm import FMIndex
from siga_tpu.ops import fm_device as jfm
from siga_tpu.parallel.dist import data_mesh
from siga_tpu_torch import dryrun, kernels
from siga_tpu_torch.ops import fm_device as tfm
from siga_tpu_torch.probes.kernel_ab import single_scan_args

from chip_smoke import plane_edge_reads, scan_edge_cases
from test_dist_build import _reads as dist_build_reads
from test_pair_scan import _reads as pair_scan_reads

SCAN_EDGES = {case[0]: case[1:] for case in scan_edge_cases()}


def _dist_reads():
    """The reads of `tests/test_dist.py::test_index_sharded_scan_matches_replicated`."""
    rng = random.Random(17)
    genome = "".join(rng.choice("ACGT") for _ in range(700))
    return [genome[i : i + 56] for i in range(0, 560, 9)]


# name: (reads, n, maxlen, min_overlap); n as the JAX tests pad the lane bucket
READ_SETS = {
    "test_dist (-m 25)": lambda: (_dist_reads(), 64, 64, 25),
    "test_dist_build (-m 45)": lambda: (dist_build_reads(300, 100, 6000, 7), 512, 112, 45),
    "tiny, 4 plane rows": lambda: (dryrun.tiny_reads(), 8, 32, 8),
}


@pytest.fixture(scope="module")
def read_sets():
    """{name: (reads, n, maxlen, mo, (fwd, rev) FMIndex, JAX sharded views,
    the port's replicated single-step views)}, built lazily."""
    cache = {}

    def get(name):
        if name not in cache:
            reads, n, maxlen, mo = READ_SETS[name]()
            fwd, _p, rev, _rp, ns = jax_sa.build_index_arrays_pair(reads, use_device=False)
            hosts = (FMIndex(fwd, ns), FMIndex(rev, ns))
            jsc = jfm.DualScanner(*(jfm.DeviceFM(h) for h in hosts), data_mesh(8),
                                  shard_index=True)
            jviews = _np_views(jsc.collect(jsc.dispatch(reads, n, maxlen, mo)))
            rsc = tfm.DualScanner(*(tfm.DeviceFM(h, "cpu") for h in hosts), pair_step=False)
            cache[name] = (reads, n, maxlen, mo, hosts, jviews,
                           rsc.collect(rsc.dispatch(reads, n, maxlen, mo)))
        return cache[name]

    return get


def _np_views(views):
    return tuple(tuple(np.asarray(x) for x in view) for view in views)


def _assert_views_equal(a, b):
    for view_a, view_b in zip(a, b, strict=True):
        assert len(view_a) == len(view_b) == 6
        for x, y in zip(view_a, view_b, strict=True):
            np.testing.assert_array_equal(x, y)


def _stacked(hosts):
    return torch.cat([tfm.DeviceFM(h, "cpu").occ_plane for h in hosts])


@pytest.mark.parametrize("D", [1, 2, 3, 8])
@pytest.mark.parametrize("name", ["71 bp", "tiny"])
def test_occ_sharded_equals_whole_plane(D, name):
    """occ over the row shards equals occ over the whole stacked plane, in
    both tables, at -1, 0, length - 1, every block edge and random
    positions; the tiny index has 4 stacked rows, fewer than D = 8, so
    some shards are empty."""
    reads = pair_scan_reads() if name == "71 bp" else dryrun.tiny_reads()
    fwd, _p, rev, _rp, ns = jax_sa.build_index_arrays_pair(reads, use_device=False)
    hosts = (FMIndex(fwd, ns), FMIndex(rev, ns))
    n, nblocks = hosts[0].length, hosts[0].length // tfm.SAMPLE + 1
    plane2 = _stacked(hosts)
    shards = tfm.shard_plane(plane2, ["cpu"] * D)
    assert sum(s.shape[0] for s in shards) == 2 * nblocks
    rng = np.random.default_rng(D)
    edges = (np.arange(nblocks)[:, None] * tfm.SAMPLE + np.array([-1, 0, 127])).ravel()
    i = np.clip(np.concatenate([[-1, 0, n - 1], edges, rng.integers(-1, n, 200)]), -1, n - 1)
    i_t = torch.from_numpy(i)
    for d, host in enumerate(hosts):
        tabs = torch.full((i.size,), d * nblocks, dtype=torch.int64)
        got = tfm.occ_single_sharded(shards, nblocks, i_t, tabs)
        assert torch.equal(got, tfm.occ_single(plane2, nblocks, i_t, tabs))
        np.testing.assert_array_equal(got.T.numpy(), host.occ_all(i))


def test_occ_matches_jax_sharded_occ():
    """The port's sharded occ against the JAX package's
    `occ_all_fused_sharded_T` under shard_map on the 8-device mesh (its
    plane padded to a multiple of 8 rows; the port's shards unpadded)."""
    import jax
    import jax.numpy as jnp
    from jax.experimental.shard_map import shard_map
    from jax.sharding import NamedSharding, PartitionSpec as P

    reads = pair_scan_reads()
    fwd, _p, rev, _rp, ns = jax_sa.build_index_arrays_pair(reads, use_device=False)
    hosts = (FMIndex(fwd, ns), FMIndex(rev, ns))
    n, nblocks = hosts[0].length, hosts[0].length // tfm.SAMPLE + 1
    plane2 = _stacked(hosts)
    mesh = data_mesh(8)
    pad = (-plane2.shape[0]) % 8
    jplane = jax.device_put(jnp.pad(jnp.asarray(plane2.numpy()), ((0, pad), (0, 0))),
                            NamedSharding(mesh, P("data", None)))
    bps = (plane2.shape[0] + pad) // 8
    i = np.random.default_rng(5).integers(-1, n, 300).astype(np.int32)
    tabs = np.where(np.arange(300) % 2 == 0, 0, nblocks).astype(np.int32)
    fn = shard_map(
        lambda plane, i, tab: jfm.occ_all_fused_sharded_T(plane, n, i, tab, bps, "data"),
        mesh=mesh, in_specs=(P("data", None), P(), P()), out_specs=P(), check_rep=False,
    )
    want = np.asarray(jax.jit(fn)(jplane, jnp.asarray(i), jnp.asarray(tabs)))
    got = tfm.occ_single_sharded(tfm.shard_plane(plane2, ["cpu"] * 8), nblocks,
                                 torch.from_numpy(i.astype(np.int64)),
                                 torch.from_numpy(tabs.astype(np.int64)))
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("D", [2, 3, 8])
@pytest.mark.parametrize("name", list(READ_SETS))
def test_views_match_jax_and_replicated(read_sets, name, D):
    """The index-sharded views over [cpu] * D equal JAX's index-sharded views
    on its 8-device mesh and the port's replicated single-step views."""
    reads, n, maxlen, mo, hosts, jviews, rviews = read_sets(name)
    sc = tfm.DualScanner(*(tfm.DeviceFM(h, "cpu") for h in hosts), devices=["cpu"] * D)
    views = sc.collect(sc.dispatch(reads, n, maxlen, mo))
    _assert_views_equal(views, rviews)
    _assert_views_equal(views, jviews)


@pytest.mark.parametrize("D", [1, 3, 8, 16])
def test_shards_hold_their_rows_only(read_sets, D, monkeypatch):
    """Each shard holds at most ceil(rows / D) rows, on its own device and in
    its own allocation; the forward and reverse DeviceFMs build neither the
    single-step plane on their device nor the pair plane; the route is the
    single-step scan whatever SIGA_PAIR_STEP or pair_step say."""
    _reads, _n, _maxlen, _mo, hosts, _jv, _rv = read_sets("test_dist (-m 25)")
    monkeypatch.setenv("SIGA_PAIR_STEP", "1")
    fms = [tfm.DeviceFM(h, "cpu") for h in hosts]
    sc = tfm.DualScanner(*fms, pair_step=True, devices=["cpu"] * D)
    rows = 2 * fms[0].nblocks
    assert len(sc.shards) == D
    assert [s.shape[0] for s in sc.shards] == [
        max(0, min(tfm.shard_rows(fms[0].nblocks, D), rows - k * tfm.shard_rows(fms[0].nblocks, D)))
        for k in range(D)
    ]
    assert all(s.shape[0] <= -(-rows // D) and s.device == torch.device("cpu") for s in sc.shards)
    ptrs = [s.data_ptr() for s in sc.shards if s.numel()]
    assert len(set(ptrs)) == len(ptrs)
    assert torch.equal(torch.cat(sc.shards), _stacked(hosts))
    assert sc.pair is False and sc.plane is None and sc.K2 is None
    assert all(fm._occ_plane is None and fm._pair is None for fm in fms)


@pytest.fixture(scope="module")
def edge_hosts():
    """{index label of `plane_edge_reads`: (forward, reverse) FMIndex}, built
    lazily."""
    cache, edges = {}, plane_edge_reads()

    def get(label):
        if label not in cache:
            fwd, _p, rev, _rp, ns = jax_sa.build_index_arrays_pair(edges[label], use_device=False)
            cache[label] = (FMIndex(fwd, ns), FMIndex(rev, ns))
        return cache[label]

    return get


@pytest.fixture
def one_thread():
    """One intra-op thread for the plain scans of a case: the suite's workers
    share the host's cores, and the parallel regions of many small tensor
    operations would wait on each other's threads."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.mark.parametrize("case", [c for c, args in SCAN_EDGES.items() if args[-1] is None])
def test_edge_cases_equal_whole_plane(edge_hosts, one_thread, case):
    """K3's edge cases (`chip_smoke.scan_edge_cases`, where the card holds
    the sharded kernel to this plain version at D = 2 and 4; the slab-split
    case is the 2,049-lane one again, for the card): the sharded plain scan
    over 3 row shards gives every output of the plain scan over the whole
    stacked plane."""
    index, reads, n, (fwd, rev), mo, _slab = SCAN_EDGES[case]
    fms = [tfm.DeviceFM(h, "cpu") for h in edge_hosts(index)]
    shards, tail = single_scan_args(fms, (fwd, rev), reads, n, mo, "cpu", devices=["cpu"] * 3)
    whole = tfm.scan_single_plain(torch.cat(shards), *tail)
    for x, y in zip(tfm.scan_single_sharded_plain(shards, *tail), whole, strict=True):
        assert x.dtype == torch.int32 and torch.equal(x, y)


def test_device_lists_are_checked(read_sets):
    _reads, _n, _maxlen, _mo, hosts, _jv, _rv = read_sets("test_dist (-m 25)")
    fms = [tfm.DeviceFM(h, "cpu") for h in hosts]
    with pytest.raises(ValueError, match="mixes cpu and cuda"):
        tfm.DualScanner(*fms, devices=["cpu", "cuda:0"])
    with pytest.raises(ValueError, match="shard table holds 16"):
        tfm.DualScanner(*fms, devices=["cpu"] * 17)


def test_adopted_index_shards_its_adopted_plane(read_sets):
    """A DeviceFM adopted from the JAX package's state without its host index
    is sharded from its adopted single-step plane."""
    reads, n, maxlen, mo, hosts, _jv, rviews = read_sets("test_dist (-m 25)")
    adopted = []
    for h in hosts:
        jd = jfm.DeviceFM(h)
        plane, K = jd.pair_plane_device()
        adopted.append(tfm.DeviceFM.from_jax_state(
            np.asarray(plane), np.asarray(K), jd._host_pred, jd.length, jd.nblocks, "cpu",
            occ_plane=np.asarray(jd.occ_plane)))
    sc = tfm.DualScanner(*adopted, devices=["cpu"] * 3)
    _assert_views_equal(sc.collect(sc.dispatch(reads, n, maxlen, mo)), rviews)


def _scan_args(read_sets, D):
    reads, n, maxlen, mo, hosts, _jv, _rv = read_sets("test_dist (-m 25)")
    sc = tfm.DualScanner(*(tfm.DeviceFM(h, "cpu") for h in hosts), devices=["cpu"] * D)
    la_w, lens = tfm.pack_reads_2bit(reads, n, maxlen)
    lim_t = min(maxlen - 1, int(lens.max()) - 1)
    return (sc.shards, sc.pred, sc.length, sc.nblocks, torch.from_numpy(la_w),
            torch.from_numpy(lens), lim_t, mo, sc.fwd_groups, sc.rev_groups)


@pytest.mark.parametrize("D", [1, 3])
def test_cpu_route_is_the_plain_version(read_sets, monkeypatch, D):
    """On CPU tensors the wrapper returns the plain version's outputs, which
    equal the replicated plain scan's, counts no launch and never loads the
    kernels."""
    args = _scan_args(read_sets, D)

    def no_lib():
        raise AssertionError("the CPU route loaded the kernels")

    monkeypatch.setattr(kernels, "lib", no_lib)
    before = dict(kernels.launches)
    got = tfm.scan_single_sharded(*args)
    assert kernels.launches == before
    whole = tfm.scan_single_plain(torch.cat(args[0]), *args[1:])
    for x, y, z in zip(got, tfm.scan_single_sharded_plain(*args), whole, strict=True):
        assert x.dtype == torch.int32 and torch.equal(x, y) and torch.equal(x, z)


def test_wrapper_refuses_other_devices(read_sets):
    """The card route takes CUDA tensors only: lanes on another device, and
    shards on the CPU (or of the wrong shape or count), are refused."""
    meta = torch.empty((2, 16), dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        tfm.scan_single_sharded([meta], meta, 1, 1, meta, meta, 1, 1, (0,), (2,))
    shards = _scan_args(read_sets, 3)[0]
    nblocks = -(-sum(s.shape[0] for s in shards) // 2)
    with pytest.raises(ValueError, match="shard 0: want a contiguous int32 CUDA tensor"):
        tfm._check_shards(shards, nblocks)
    with pytest.raises(ValueError, match="the shard table holds 1 to 16"):
        tfm._check_shards([], nblocks)
    with pytest.raises(ValueError, match="the shard table holds 1 to 16"):
        tfm._check_shards(shards * 6, nblocks)


class _Shard:
    def __init__(self, index):
        self.device = torch.device("cuda", index)


def test_no_peer_access_raises_before_any_launch(monkeypatch):
    """A shard on a card that the lanes' card cannot read raises, naming the
    pair, before peer access is enabled or the kernels are loaded."""
    asked = []

    def can_access(card, peer):
        asked.append((card, peer))
        return peer != 2

    def no_lib():
        raise AssertionError("the kernels were loaded")

    monkeypatch.setattr(tfm, "_PEER_ACCESS", set())
    monkeypatch.setattr(tfm.torch.cuda, "can_device_access_peer", can_access)
    monkeypatch.setattr(kernels, "lib", no_lib)
    with pytest.raises(ValueError, match=r"shards on cuda:2: cuda:0 cannot read them"):
        tfm._enable_peers(torch.device("cuda", 0), [_Shard(0), _Shard(1), _Shard(2), _Shard(0)])
    assert asked == [(0, 1), (0, 2)]
    tfm._enable_peers(torch.device("cuda", 0), [_Shard(0), _Shard(0)])  # one card: nothing to do
    assert asked == [(0, 1), (0, 2)]


def test_peer_access_is_enabled_once_a_pair(monkeypatch):
    """Each (card, peer) pair is checked and enabled at its first use only,
    under the reading card; later calls over the same shards do neither."""
    asked, enabled = [], []

    class Lib:
        def siga_enable_peer_access(self, peer):
            enabled.append((current[0], peer))
            return 0

    current = [None]

    @contextlib.contextmanager
    def on(card):
        current[0] = card
        yield

    monkeypatch.setattr(tfm, "_PEER_ACCESS", set())
    monkeypatch.setattr(tfm.torch.cuda, "can_device_access_peer",
                        lambda card, peer: asked.append((card, peer)) or True)
    monkeypatch.setattr(tfm.torch.cuda, "device", on)
    monkeypatch.setattr(kernels, "lib", Lib)
    shards = [_Shard(0), _Shard(1), _Shard(2)]
    for _ in range(3):
        tfm._enable_peers(torch.device("cuda", 0), shards)
    assert asked == enabled == [(0, 1), (0, 2)]
    tfm._enable_peers(torch.device("cuda", 1), shards)
    assert asked == enabled == [(0, 1), (0, 2), (1, 0), (1, 2)]


def test_kernel_is_registered():
    """One C entry takes the shard table: one shard launches K3, more the
    sharded kernel."""
    sig = kernels._SIGNATURES["siga_scan_single"]
    assert sig[:3] == [kernels._P, kernels._I, kernels._I] and sig[3:6] == [kernels._P] * 3
    assert sig[6:18] == [kernels._I] * 12 and sig[18:] == [kernels._P] * 6
    assert kernels._SIGNATURES["siga_enable_peer_access"] == [kernels._I]
    assert "scan_single_sharded" in kernels.launches
    with open(os.path.join(kernels.CSRC, "scan_single.cu")) as f:
        source = f.read()
    assert f"kMaxShards = {tfm.MAX_SHARDS};" in source
    assert "scan_single_sharded_kernel<<<" in source and "siga_enable_peer_access(" in source
