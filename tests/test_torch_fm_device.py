"""The port's pair plane and stage-A scan against the JAX package.

Same inputs through `siga_tpu.ops.fm_device` (XLA on the CPU) and
`siga_tpu_torch.ops.fm_device` (the plain PyTorch versions the kernels are
checked against on the GPU).  Every compared value is an integer: equality
is exact.
"""
import numpy as np
import pytest
import torch

from siga_tpu.index import sa as jax_sa
from siga_tpu.index.fm import FMIndex
from siga_tpu.ops import fm_device as jfm
from siga_tpu_torch.ops import fm_device as tfm
from siga_tpu_torch.ops import sw as tsw

from test_pair_scan import _reads


def _indexes(reads):
    fwd, _p, rev, _rp, ns = jax_sa.build_index_arrays_pair(reads, use_device=False)
    return FMIndex(fwd, ns), FMIndex(rev, ns)


@pytest.fixture(scope="module")
def fixture():
    reads = _reads()
    fmi, rfmi = _indexes(reads)
    jax_fms = (jfm.DeviceFM(fmi), jfm.DeviceFM(rfmi))
    torch_fms = (tfm.DeviceFM(fmi, "cpu"), tfm.DeviceFM(rfmi, "cpu"))
    return reads, (fmi, rfmi), jax_fms, torch_fms


def _assert_views_equal(a, b):
    for view_a, view_b in zip(a, b):
        assert len(view_a) == len(view_b) == 6
        for x, y in zip(view_a, view_b):
            np.testing.assert_array_equal(np.asarray(x), np.asarray(y))


def _views(scanner, reads, maxlen, mo):
    return scanner.collect(scanner.dispatch(list(reads), 256, maxlen, mo))


def test_plane_and_K_match_jax(fixture):
    _reads_, hosts, jax_fms, torch_fms = fixture
    for host, jd, td in zip(hosts, jax_fms, torch_fms):
        plane_h, K_h = jd.pair_plane_host()
        plane_d, K_d = jd.pair_plane_device()
        assert td.plane.dtype == torch.int32 and td.K.dtype == torch.int32
        np.testing.assert_array_equal(td.plane.numpy(), np.asarray(plane_d))
        np.testing.assert_array_equal(td.plane.numpy(), plane_h)
        np.testing.assert_array_equal(td.K.numpy(), np.asarray(K_d))
        np.testing.assert_array_equal(td.K.numpy(), K_h)
        plane_n, K_n = tfm.pair_plane_host(host)
        np.testing.assert_array_equal(plane_n, plane_h)
        np.testing.assert_array_equal(K_n, K_h)


def test_from_jax_state_round_trips(fixture):
    reads, _hosts, jax_fms, torch_fms = fixture
    adopted = []
    for jd, td in zip(jax_fms, torch_fms):
        plane, K = jd.pair_plane_device()
        a = tfm.DeviceFM.from_jax_state(
            np.asarray(plane), np.asarray(K), jd._host_pred, jd.length, jd.nblocks, "cpu"
        )
        assert torch.equal(a.plane, td.plane) and torch.equal(a.K, td.K)
        np.testing.assert_array_equal(a.pred, td.pred)
        adopted.append(a)
    _assert_views_equal(
        _views(tfm.DualScanner(*adopted), reads, 80, 31),
        _views(tfm.DualScanner(*torch_fms), reads, 80, 31),
    )


@pytest.mark.parametrize("mo", [20, 31, 70, 81])
def test_scan_views_match_jax(fixture, mo):
    reads, _hosts, jax_fms, torch_fms = fixture
    _assert_views_equal(
        _views(jfm.DualScanner(*jax_fms, pair_step=True), reads, 80, mo),
        _views(tfm.DualScanner(*torch_fms), reads, 80, mo),
    )


@pytest.mark.parametrize("mo", [20, 70])
def test_scan_odd_lim_t_matches_jax(mo):
    """Reads as long as the packed width (80) make lim_t odd, so the masked
    phantom half-step runs (tests/test_pair_scan.py:73-94)."""
    rng = np.random.default_rng(23)
    genome = rng.integers(0, 4, 3000)
    alpha = np.frombuffer(b"ACGT", dtype=np.uint8)
    starts = rng.integers(0, 3000 - 80, 96)
    reads = [alpha[genome[s : s + 80]].tobytes().decode() for s in starts]
    reads += [reads[0], reads[1][3:77]]
    fmi, rfmi = _indexes(reads)
    _assert_views_equal(
        _views(jfm.DualScanner(jfm.DeviceFM(fmi), jfm.DeviceFM(rfmi), pair_step=True),
               reads, 80, mo),
        _views(tfm.DualScanner(tfm.DeviceFM(fmi, "cpu"), tfm.DeviceFM(rfmi, "cpu")),
               reads, 80, mo),
    )


def test_scan_rmdup_groups_match_jax(fixture):
    reads, _hosts, jax_fms, torch_fms = fixture
    groups = dict(fwd_groups=(jfm.GROUP_ID,), rev_groups=(jfm.GROUP_COMP,))
    _assert_views_equal(  # min_overlap > maxlen: finals only
        _views(jfm.DualScanner(*jax_fms, pair_step=True, **groups), reads, 80, 81),
        _views(tfm.DualScanner(*torch_fms, **groups), reads, 80, 81),
    )


def test_wrappers_refuse_other_devices():
    meta = torch.empty((2, 57), dtype=torch.int32, device="meta")
    with pytest.raises(ValueError):
        tfm.scan_pair(meta, meta, meta, 1, 1, meta, meta, 1, 1, (0,), (2,))
    with pytest.raises(ValueError):
        tsw.sw_wavefront(meta, meta, 2, 2, 3, 1)


def test_pack_reads_rejects_bad_input():
    la_w, lens = tfm.pack_reads_2bit(["ACGT", "TTGCA"], 4, 16)
    assert lens.tolist() == [4, 5, 1, 1]
    with pytest.raises(ValueError):
        tfm.pack_reads_2bit(["ACNT"], 1, 16)
    with pytest.raises(ValueError):
        tfm.pack_reads_2bit(["A" * 17], 1, 16)
